"""The port's nine pipeline steps against the JAX package's: the same
seeded inputs (duplicate sources, corrupt JSON, null rows, a many-box row,
identical zero-area boxes, a pair just under the IoU threshold, suspects
above it) through both packages' ``core.processor``, called as the
processing page calls it; every artifact equal byte for byte (xlsx by its
inner parts, whose zip container holds wall-clock timestamps), every return
value and row count equal. Also step 8 on a NaN primary label cell and a
class-order override, and the port's chain against the golden hashes."""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch
from PIL import Image

from deal_yolo_daya_tpu.core import processor as jax_processor
from deal_yolo_daya_tpu.datakit import yolo_dataset as jax_yolo
from deal_yolo_daya_tpu_torch.core import processor
from deal_yolo_daya_tpu_torch.datakit import yolo_dataset
from deal_yolo_daya_tpu_torch.utils import xlsx
from tests.torch_deadline import _deadline, _deadline_module  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tools"))

import synth_annotations_torch as synth  # noqa: E402

import jax_native  # noqa: E402

GOLDEN = Path(__file__).parent / "golden" / "datakit_chain_hashes.json"

# the files each step writes, relative to the run root (globs)
STEP_ARTIFACTS = {
    "merge": ["merged_result.csv"],
    "dedup": ["deduplicate_result.csv"],
    "ref_filter": ["filtered_main.csv"],
    "replace_ptlist": ["processed_replaced_ptlist.csv",
                       "processed_replaced_ptlist_excluded.csv"],
    "iou_filter": ["high_iou_0.98.csv", "other_data.csv"],
    "label_replace": ["other_data_label_replaced.csv", "label_replace_diff.xlsx",
                      "label_replace_unmatched.xlsx"],
    "split": ["split_by_category/*"],
    "yolo": ["yolo_datasets/**/*"],
    "download": ["annotated_images/*", "downloaded_images/*"],
}
STEP_RESULTS = {"merge": ["merge"], "replace_ptlist": ["replace_ptlist"],
                "iou_filter": ["iou_filter"], "label_replace": ["label_replace"],
                "split": ["split", "unclassified_summary"], "yolo": ["yolo"],
                "download": ["download"]}
COUNTS = {"merge": ["merged"], "dedup": ["dedup"], "ref_filter": ["filtered"],
          "replace_ptlist": ["processed", "excluded"], "iou_filter": ["high_iou", "other"],
          "label_replace": ["label_replaced", "replaced_rows"],
          "split": ["categories", "splits"], "yolo": ["yolo_images"], "download": ["drawn"]}


@pytest.fixture(autouse=True, scope="module")
def _jax_native_loaded():
    """The JAX runtime's native scanner loaded in this worker
    (``tests/jax_native.py``), so the JAX side takes its native path."""
    jax_native.loaded()


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The seeded inputs once, then the nine steps of each package into a
    run root of its own."""
    root = tmp_path_factory.mktemp("pipeline")
    fx = synth.pipeline_inputs(root / "inputs", n_images=40, seed=5, sides=(64, 161),
                               n_dup=5, n_corrupt=3, n_null=3, n_ref=4, high_every=8)
    return fx, {name: synth.run_pipeline(P, fx, root / name)
                for name, P in (("jax", jax_processor), ("port", processor))}, root


def _content(path: Path, run_root: Path) -> bytes:
    if path.suffix == ".xlsx":
        return synth.content_hash(path).encode()
    if path.name == "data.yaml":  # it names its own absolute directory
        return path.read_bytes().replace(str(run_root).encode(), b"<run>")
    return path.read_bytes()


def _artifacts(run_root: Path, patterns) -> dict:
    return {str(p.relative_to(run_root)): _content(p, run_root)
            for pattern in patterns for p in sorted(run_root.glob(pattern)) if p.is_file()}


def _plain(value, run_root: Path):
    """A return value as JSON text with the run root's path taken out."""
    return json.dumps(value, default=str, ensure_ascii=False, sort_keys=True).replace(
        str(run_root), "<run>")


@pytest.mark.parametrize("step", list(STEP_ARTIFACTS))
def test_step_equals_jax(step, runs):
    fx, by_pkg, root = runs
    jax_run, port_run = by_pkg["jax"], by_pkg["port"]
    want = _artifacts(root / "jax", STEP_ARTIFACTS[step])
    got = _artifacts(root / "port", STEP_ARTIFACTS[step])
    assert want, f"step {step} wrote nothing"
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name] == want[name], f"{step}: {name} differs"
    for key in STEP_RESULTS.get(step, []):
        assert _plain(port_run["outputs"][key], root / "port") == \
            _plain(jax_run["outputs"][key], root / "jax"), key
    for key in COUNTS[step]:
        assert port_run["counts"][key] == jax_run["counts"][key] == fx["counts"][key], key


def test_label_counts_equal_jax(runs):
    _, by_pkg, root = runs
    stats = {}
    for name, mod in (("jax", jax_yolo), ("port", yolo_dataset)):
        s, flat = mod.summarize_yolo_label_counts(list(by_pkg[name]["datasets"].values()))
        stats[name] = (s, flat.to_csv(index=False).replace(str(root / name), "<run>"))
    assert stats["port"] == stats["jax"]


def _label_cell(objects, width=64, height=48):
    return synth._label_cell(objects, width, height)


def _step8_book(tmp_path: Path, case: str) -> Path:
    src = tmp_path / "srcs"
    src.mkdir()
    paths = []
    for i in range(3):
        p = src / f"im{i}.jpg"
        Image.new("RGB", (64, 48), (120, 30, 200 - 40 * i)).save(p)
        paths.append(str(p))
    cell = _label_cell([("猫", [(4, 4), (32, 24)]), ("狗", [(1, 1), (10, 10)])])
    col = "新_" + synth.LABEL_JSON_COL
    if case == "nan_primary":  # a NaN primary cell claims its row; "" falls back
        rows = [{"source": paths[0], "分类标签": "猫", col: cell, synth.LABEL_JSON_COL: cell},
                {"source": paths[1], "分类标签": "猫", col: np.nan, synth.LABEL_JSON_COL: cell},
                {"source": paths[2], "分类标签": "猫", col: "", synth.LABEL_JSON_COL: cell}]
        sheets = {"train": pd.DataFrame(rows)}
    else:
        rows = [{"source": p, "分类标签": lbl, col: cell, "width": 64, "height": 48}
                for p, lbl in zip(paths, ("猫", "狗", "猫"))]
        sheets = {"train": pd.DataFrame(rows[:2]), "val": pd.DataFrame(rows[2:])}
    book = tmp_path / f"{case}.xlsx"
    xlsx.write_workbook(book, sheets)
    return book


@pytest.mark.parametrize("case,class_order", [("nan_primary", None),
                                              ("class_order", ["狗", "猫"])])
def test_step8_cases_equal_jax(case, class_order, tmp_path):
    book = _step8_book(tmp_path, case)
    results = {}
    for name, mod in (("jax", jax_yolo), ("port", yolo_dataset)):
        out = tmp_path / name
        results[name] = mod.generate_yolo_datasets_from_excels(
            [str(book)], str(out), class_order=class_order)
        results[name] = (_plain(results[name], out),
                         _artifacts(out, ["**/*"]))
    assert results["port"] == results["jax"]
    import yaml

    ds = tmp_path / "port" / case
    yaml_names = yaml.safe_load((ds / "data.yaml").read_text(encoding="utf-8"))["names"]
    if class_order:
        assert yaml_names == class_order
    else:  # the NaN-primary row is skipped, the empty-string one falls back
        assert len(list((ds / "labels" / "train").glob("*.txt"))) == 2


def test_port_chain_reproduces_golden_hashes(tmp_path):
    synth.run_chain(tmp_path, 300)
    assert synth.artifact_hashes(tmp_path) == json.loads(GOLDEN.read_text())


def test_processor_surface_equals_jax():
    """``core.processor`` names the same step functions with the same
    signatures."""
    import inspect

    names = [n for n in dir(jax_processor) if not n.startswith("_")
             and callable(getattr(jax_processor, n))]
    assert names == [n for n in dir(processor) if not n.startswith("_")
                     and callable(getattr(processor, n))]
    for n in names:
        assert inspect.signature(getattr(processor, n)) == \
            inspect.signature(getattr(jax_processor, n)), n

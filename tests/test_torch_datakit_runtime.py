"""The port's native scanner, IoU filter and downloads against the JAX
package's: the library built into ``_build/``, its entry points on the same
columns, the pure-Python fallbacks, ``high_iou_hits``' PyTorch path against
numpy and the JAX ``_hits_batch`` on planted ties and zero-area pairs, a
download from a local HTTP server, and the pipeline without ``requests``."""

from __future__ import annotations

import functools
import http.server
import importlib
import json
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch

from deal_yolo_daya_tpu import runtime as jax_rt
from deal_yolo_daya_tpu.datakit import boxes as jax_boxes
from deal_yolo_daya_tpu.datakit import columnar as jax_columnar
from deal_yolo_daya_tpu.utils import csvio as jax_csvio
from deal_yolo_daya_tpu.utils import xlsx as jax_xlsx
from deal_yolo_daya_tpu_torch import runtime as rt
from deal_yolo_daya_tpu_torch.datakit import boxes
from deal_yolo_daya_tpu_torch.datakit import columnar
from deal_yolo_daya_tpu_torch.datakit import download
from deal_yolo_daya_tpu_torch.utils import csvio
from deal_yolo_daya_tpu_torch.utils import xlsx
from tests.torch_deadline import _deadline, _deadline_module  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tools"))

import jax_native  # noqa: E402
import synth_annotations_torch as synth  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _jax_native_loaded():
    """The JAX runtime's native scanner loaded in this worker
    (``tests/jax_native.py``), so the JAX side takes its native path."""
    jax_native.loaded()


GOLDEN = Path(__file__).parent / "golden" / "datakit_chain_hashes.json"


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two CPU threads for this file's PyTorch ops, restored afterwards: the
    test workers share the machine's cores."""
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def _ann(objs, w=320, h=240):
    return json.dumps({"width": w, "height": h, "objects": [
        {"name": n, "polygon": {"ptList": [{"x": x, "y": y} for x, y in pts]}}
        for n, pts in objs]}, ensure_ascii=False)


CELLS = [
    _ann([("猫", [(1, 2), (30, 40)])]),
    _ann([("a,b", [(5, 5), (10, 2), (7, 30)]), ("c", [(0, 0), (1, 1)])]),
    _ann([("tricky\"}]{[", [(3, 3), (9, 9)])]),
    _ann([("x", [(3, 3)])]),
    _ann([("neg", [(-5.5, -2.25), (10.125, 20.5)]), ("big", [(0.1, 1e16), (1 / 3, 2.5)])]),
    '{"objects": []}', '{"width": 100}', "not json at all {{{", None, "",
    json.dumps({"objects": [{"name": "nopoly"}]}),
    json.dumps({"objects": [{"name": "nullpt",
                             "polygon": {"ptList": [{"x": None, "y": 5}, {"x": 1, "y": 2}]}}]}),
] * 3


def test_native_library_builds_into_build_dir():
    """The scanner is built with g++ into the package's ``_build/``, under a
    name keyed on the source's hash, and loads; not next to the source."""
    lib = rt.get_lib()
    assert lib is not None
    path = rt.library_path()
    assert path.parent == ROOT / "deal_yolo_daya_tpu_torch" / "_build"
    assert path.name.startswith("liblabelscan-") and path.suffix == ".so"
    assert path.exists() and lib._name == str(path)
    assert not (Path(rt.__file__).parent / "liblabelscan.so").exists()


def test_concurrent_builds_leave_one_whole_library(tmp_path, monkeypatch):
    """Builds racing into one directory (the test workers reach the first
    build together) each move a whole file into place, and it loads."""
    import ctypes

    monkeypatch.setattr(rt, "BUILD", tmp_path / "_build")
    target = rt.library_path()
    results = []
    threads = [threading.Thread(target=lambda: results.append(rt._build(target)))
               for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert results == [True, True, True]
    assert [p.name for p in target.parent.iterdir()] == [target.name]
    assert ctypes.CDLL(str(target)).scan_boxes is not None


def _sheet_bytes(mod, tmp_path, name):
    df = pd.DataFrame({"s": ["a", "猫,狗", None, "x" * 40], "f": [1.5, np.nan, -2.0, 1e16],
                       "i": [1, 2, 3, 4], "b": [True, False, True, False]})
    path = tmp_path / f"{name}.xlsx"
    mod.to_excel(df, path)
    return synth.content_hash(path), path


def _entry_point(case, tmp_path):
    """The case's output from the JAX package's runtime and from the port's."""
    if case == "scan_boxes_two_point":
        return [m.scan_boxes_native(CELLS, two_point_only=True, max_boxes=8)
                for m in (jax_rt, rt)]
    if case == "scan_boxes_polygon":
        return [m.scan_boxes_native(CELLS, two_point_only=False, max_boxes=8)
                for m in (jax_rt, rt)]
    if case == "scan_annotations":
        return [m.scan_annotations_native(CELLS) for m in (jax_rt, rt)]
    if case == "rewrite_ptlists":
        return [c.rewrite_ptlists(c.build_table(CELLS)) for c in (jax_columnar, columnar)]
    if case == "splice_items2":
        out = []
        for c in (jax_columnar, columnar):
            table = c.build_table(CELLS)
            objs = np.arange(table.m)
            out.append(c.extract_single_objects(table, objs, np.array(["X"] * table.m, object)))
        return out
    if case == "sheet_xml":
        return [_sheet_bytes(m, tmp_path, n)[0] for m, n in ((jax_xlsx, "j"), (xlsx, "t"))]
    if case == "sheet_parse":
        import zipfile

        _, path = _sheet_bytes(xlsx, tmp_path, "t")
        with zipfile.ZipFile(path) as zf:
            part = zf.read("xl/worksheets/sheet1.xml")
        return [m.sheet_parse_native(part) for m in (jax_rt, rt)]
    if case == "csv_write":
        df = pd.DataFrame({"source": ["a", "b,c", None], "v": [1.25, np.nan, 3.0],
                           "n": [1, 2, 3], "j": [CELLS[0], CELLS[1], "q\"uote"]})
        out = []
        for mod, name in ((jax_csvio, "j.csv"), (csvio, "t.csv")):
            mod.write_csv(df, tmp_path / name)
            out.append((tmp_path / name).read_bytes())
        return out
    if case == "match_predictions":
        rng = np.random.default_rng(11)
        pb = rng.uniform(0, 80, (30, 4)).astype(np.float32)
        pb[:, 2:] += pb[:, :2]
        gb = pb[:10] + rng.normal(0, 3, (10, 4)).astype(np.float32)
        pc, gc = rng.integers(0, 3, 30).astype(np.int32), rng.integers(0, 3, 10).astype(np.int32)
        thr = np.linspace(0.5, 0.95, 10).astype(np.float32)
        return [m.match_predictions_native(pb, pc, gb, gc, thr) for m in (jax_rt, rt)]
    raise AssertionError(case)


def _same(a, b) -> bool:
    if isinstance(a, (tuple, list)):
        return type(a) is type(b) and len(a) == len(b) and all(map(_same, a, b))
    if isinstance(a, np.ndarray):
        return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(
            a.view(np.uint8), b.view(np.uint8))
    return a == b


@pytest.mark.parametrize("case", [
    "scan_boxes_two_point", "scan_boxes_polygon", "scan_annotations", "rewrite_ptlists",
    "splice_items2", "sheet_xml", "sheet_parse", "csv_write", "match_predictions"])
def test_entry_points_equal_jax(case, tmp_path):
    want, got = _entry_point(case, tmp_path)
    assert got is not None, "the port's native library did not load"
    assert _same(want, got)


def test_no_native_gives_the_golden_artifacts(tmp_path, monkeypatch):
    """With ``DYD_NO_NATIVE`` every consumer takes its pure-Python fallback
    and the chain writes the same bytes as the native scanner (the golden
    hashes)."""
    monkeypatch.setattr(rt, "_LIB", None)
    monkeypatch.setenv("DYD_NO_NATIVE", "1")
    assert rt.get_lib() is None
    synth.run_chain(tmp_path, 300)
    assert synth.artifact_hashes(tmp_path) == json.loads(GOLDEN.read_text())


@pytest.mark.parametrize("width,min_boxes,thr", [(2, 2, 0.98), (8, 2, 0.98), (8, 3, 0.98),
                                                 (8, 2, 0.5)])
def test_high_iou_hits_torch_equals_numpy_and_jax(width, min_boxes, thr, monkeypatch):
    """The PyTorch path (on the CPU), numpy and the JAX ``_hits_batch`` (op
    by op: a jitted wide one compiles for minutes) give the same flags on
    planted ties at the f32 threshold, pairs one f32 step either side,
    identical and zero-area pairs, masked copies and one-box rows."""
    import jax
    import jax.numpy as jnp

    b, m, planted = synth.planted_iou_table(1500, width, seed=width + min_boxes, share=0.2)
    ref = boxes._high_iou_hits_numpy(b, m, min_boxes, thr)
    monkeypatch.setattr(boxes, "JAX_MIN_ROWS", 0)
    got = boxes.high_iou_hits(b, m, min_boxes, thr, chunk=256, device="cpu")
    with jax.disable_jit():
        jax_flags = np.asarray(jax_boxes._hits_batch(jnp.asarray(b), jnp.asarray(m), min_boxes,
                                                    jnp.float32(thr)))
    assert got.dtype == bool and got.shape == (1500,)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(jax_flags, ref)
    if thr == 0.98 and min_boxes == 2:
        for kind, rows in planted.items():
            assert (ref[rows] == synth.PLANTED_HIT[kind]).all(), kind


def test_pairwise_iou_matrix_equals_jax():
    """(M, 4) -> (M, M) IoU bit for bit with the JAX function, zero
    intersection and zero union at 0."""
    import jax

    b, m, _ = synth.planted_iou_table(64, 6, seed=3, share=0.5)
    with jax.disable_jit():
        for row in b[:16]:
            want = np.asarray(jax_boxes.pairwise_iou_matrix(row))
            got = boxes.pairwise_iou_matrix(torch.from_numpy(row)).numpy()
            assert got.dtype == np.float32
            np.testing.assert_array_equal(got, want)


def test_high_iou_hits_threshold_and_card(monkeypatch):
    """Below ``JAX_MIN_ROWS`` (read from the JAX package's variable) the
    filter never reaches PyTorch; above it, the card is the default and its
    absence raises unless ``device="cpu"``."""
    b, m, _ = synth.planted_iou_table(40, 4, seed=0, share=0.5)
    monkeypatch.setenv("DYD_IOU_JAX_MIN_ROWS", "41")
    try:
        importlib.reload(boxes)
        assert boxes.JAX_MIN_ROWS == 41
        monkeypatch.setattr(boxes, "_hits_batch", lambda *a: pytest.fail("device path taken"))
        boxes.high_iou_hits(b, m)
    finally:
        monkeypatch.delenv("DYD_IOU_JAX_MIN_ROWS")
        importlib.reload(boxes)
    assert boxes.JAX_MIN_ROWS == 10**9
    assert boxes.high_iou_hits(b[:0], m[:0]).shape == (0,)
    monkeypatch.setattr(boxes, "JAX_MIN_ROWS", 1)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            boxes.high_iou_hits(b, m)
    np.testing.assert_array_equal(boxes.high_iou_hits(b, m, device="cpu"),
                                  boxes._high_iou_hits_numpy(b, m, 2, 0.98))


@pytest.fixture()
def http_root(tmp_path):
    """A directory served over HTTP on 127.0.0.1 for the test's length."""
    root = tmp_path / "served"
    root.mkdir()
    handler = functools.partial(http.server.SimpleHTTPRequestHandler, directory=str(root))
    handler.log_message = lambda *a: None
    server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), handler)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    yield root, f"http://127.0.0.1:{server.server_address[1]}"
    server.shutdown()
    server.server_close()
    thread.join(timeout=30)
    assert not thread.is_alive()


def test_download_from_a_local_server(http_root, tmp_path):
    root, url = http_root
    (root / "pic.png").write_bytes(b"\x89PNG-bytes")
    dest = tmp_path / "got.png"
    assert download.download_image(f"{url}/pic.png", str(dest)) is True
    assert dest.read_bytes() == b"\x89PNG-bytes"
    cache = tmp_path / "cache"
    cache.mkdir()
    cached = download.ensure_image_cached(f"{url}/pic.png?x=1", cache)
    assert cached == cache / "pic.png" and cached.read_bytes() == b"\x89PNG-bytes"
    local = tmp_path / "local.png"
    local.write_bytes(b"L")
    got = download.prefetch_images([f"{url}/pic.png", str(local), f"{url}/missing.png"],
                                   tmp_path / "pre", timeout=5)
    assert got[str(local)] == local
    assert got[f"{url}/pic.png"].read_bytes() == b"\x89PNG-bytes"
    assert got[f"{url}/missing.png"] is None


_NO_REQUESTS = r"""
import sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name == "requests" or name.startswith("requests."):
            raise ImportError(f"blocked: {name}")
sys.meta_path.insert(0, Block())
sys.path.insert(0, sys.argv[1])
from pathlib import Path
from deal_yolo_daya_tpu_torch.core import processor  # noqa: F401
from deal_yolo_daya_tpu_torch.datakit import download
local = Path(sys.argv[2])
assert download.ensure_image_cached(str(local), local.parent) == local
assert download.prefetch_images([str(local)], local.parent / "c") == {str(local): local}
for call in (lambda: download.download_image("http://127.0.0.1:9/x.png", str(local) + ".x"),
             lambda: download.ensure_image_cached("http://127.0.0.1:9/x.png", local.parent)):
    try:
        call()
    except ImportError as e:
        assert "requests" in str(e), e
    else:
        raise SystemExit("a URL source did not raise ImportError")
assert "requests" not in sys.modules
print("ok")
"""


def test_pipeline_imports_without_requests(tmp_path):
    """On a machine without ``requests`` the pipeline imports, local sources
    resolve and a URL source raises ImportError naming the package."""
    local = tmp_path / "a.png"
    local.write_bytes(b"x")
    out = subprocess.run([sys.executable, "-c", _NO_REQUESTS, str(ROOT), str(local)],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")

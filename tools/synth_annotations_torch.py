#!/usr/bin/env python3
"""Synthetic annotation inputs for the PyTorch port's data pipeline, made
with the port alone (it imports no JAX).

    python3 tools/synth_annotations_torch.py [n_rows]

times steps 4-7 on ``n_rows`` synthetic rows (default 50,000) and prints the
wall time of each step.

- ``synth_csv`` writes the N-row annotation CSV of ``tools/bench_datakit.py``
  (the same rows for the same seed);
- ``run_chain`` runs steps 4-7 on it with the label map and rules of
  ``tests/test_perf_budget.py``; ``artifact_hashes`` hashes what the chain
  wrote as ``tests/golden/datakit_chain_hashes.json`` does (xlsx by inner
  parts: the zip container holds wall-clock timestamps);
- ``pipeline_inputs`` writes the nine steps' inputs: two raw CSVs with
  duplicate sources, corrupt-JSON and null rows, a reference CSV, polygons
  on local PNG sources, a label map and a wide rules workbook of two
  categories; it returns the row counts each step must give.
  ``run_pipeline`` calls the nine steps of a ``core.processor`` module in
  order, with the arguments the processing page passes.
"""

from __future__ import annotations

import hashlib
import json
import random
import sys
import time
import zipfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

LABEL_JSON_COL = "结果字段-目标检测标签配置"
LABELS = ["猫", "狗", "狼", "鹰", "鹿", "兔", "car", "truck", "person", "bike"]

# steps 6 and 7 of the golden chain (tests/test_perf_budget.py)
CHAIN_LABEL_MAP = {"猫": "cat", "狗": "dog", "狼": "wolf"}
CHAIN_RULES = {lbl: ("pets" if i % 2 == 0 else "wild")
               for i, lbl in enumerate(LABELS + list(CHAIN_LABEL_MAP.values()))}


def synth_csv(path: Path, n: int, seed: int = 0) -> None:
    """``n`` rows of 1-4 objects (a fifth of them with two labels, a third
    with a third polygon point) on 1920 x 1080, URL sources."""
    import pandas as pd

    rng = random.Random(seed)
    rows = []
    for i in range(n):
        n_obj = rng.randint(1, 4)
        objs = []
        for _ in range(n_obj):
            name = rng.choice(LABELS)
            if rng.random() < 0.2:
                name += "," + rng.choice(LABELS)
            x, y = rng.uniform(0, 500), rng.uniform(0, 500)
            w, h = rng.uniform(10, 200), rng.uniform(10, 200)
            pts = [{"x": round(x, 2), "y": round(y, 2)},
                   {"x": round(x + w, 2), "y": round(y + h, 2)}]
            if rng.random() < 0.3:  # polygon with extra points
                pts.append({"x": round(x + w / 2, 2), "y": round(y + h / 2, 2)})
            objs.append({"name": name, "polygon": {"ptList": pts}})
        cell = json.dumps(
            {"width": 1920, "height": 1080, "objects": objs}, ensure_ascii=False
        )
        rows.append({"source": f"http://host/img_{i}.jpg", LABEL_JSON_COL: cell})
    pd.DataFrame(rows).to_csv(path, index=False, encoding="utf-8-sig")


def chain_fixtures(root: Path):
    """The golden chain's label map and wide rules workbooks."""
    import pandas as pd

    from deal_yolo_daya_tpu_torch.utils import xlsx

    map_x = root / "map.xlsx"
    xlsx.to_excel(pd.DataFrame({"旧": list(CHAIN_LABEL_MAP),
                                "新": list(CHAIN_LABEL_MAP.values())}), map_x)
    rules_x = root / "rules.xlsx"
    xlsx.to_excel(pd.DataFrame({
        cat: [",".join(k for k, v in CHAIN_RULES.items() if v == cat)]
        for cat in ("pets", "wild")}), rules_x)
    return map_x, rules_x


def run_chain(root: Path, n: int, steps=None) -> dict:
    """synth -> step 4 -> 5 -> 6 -> 7 in ``root`` (the port's steps unless
    ``steps`` is another module with their names); each step's seconds,
    synth excluded."""
    if steps is None:
        from deal_yolo_daya_tpu_torch.datakit import steps
    src = root / "raw.csv"
    synth_csv(src, n)
    map_x, rules_x = chain_fixtures(root)
    calls = [
        ("s4", steps.process_csv_replace_ptlist,
         (str(src), str(root / "c4.csv"), str(root / "c4_excluded.csv")), {}),
        ("s5", steps.filter_by_box_count_and_iou,
         (str(root / "c4.csv"), str(root / "c5_hi.csv"), str(root / "c5_other.csv")), {}),
        ("s6", steps.replace_labels_by_mapping,
         (str(root / "c5_other.csv"), str(map_x), str(root / "c6.csv")),
         {"diff_excel_path": str(root / "c6_diff.xlsx"),
          "unmatched_excel_path": str(root / "c6_unmatched.xlsx")}),
        ("s7", steps.split_dataset_by_rules,
         (str(root / "c6.csv"), str(rules_x), str(root / "c7")), {}),
    ]
    seconds = {}
    for name, fn, args, kwargs in calls:
        t0 = time.perf_counter()
        fn(*args, **kwargs)
        seconds[name] = time.perf_counter() - t0
    return seconds


def content_hash(path: Path) -> str:
    """md5 of an artifact's content: the bytes of a CSV, the sorted inner
    parts of an xlsx."""
    h = hashlib.md5()
    if path.suffix == ".xlsx":
        with zipfile.ZipFile(path) as zf:
            for name in sorted(zf.namelist()):
                h.update(name.encode())
                h.update(zf.read(name))
    else:
        h.update(path.read_bytes())
    return h.hexdigest()


def artifact_hashes(root: Path) -> dict:
    """{relative path: content hash} of every CSV and xlsx under ``root``
    but the chain's raw input."""
    return {str(p.relative_to(root)): content_hash(p) for p in sorted(root.rglob("*"))
            if p.is_file() and p.suffix in (".csv", ".xlsx") and p.name != "raw.csv"}


# ------------------------------------------------------------ the nine steps

ANIMALS = ("猫", "狗")          # mapped to cat / dog by step 6
VEHICLES = ("car", "truck")    # left as they are
LABEL_MAP = {"猫": "cat", "狗": "dog"}
RULES = {"animals": "cat,dog", "vehicles": "car,truck"}
UNRULED = "杂项"               # in no category: unclassified at step 7
MAX_DRAWN = 12                 # step 9's max_images


def _label_cell(objects, width, height) -> str:
    return json.dumps({
        "width": width, "height": height,
        "objects": [{"name": name, "polygon": {"ptList": [{"x": x, "y": y} for x, y in pts]}}
                    for name, pts in objects]}, ensure_ascii=False)


def _polygon(rng: random.Random, w: int, h: int):
    """A 3-5 point polygon whose bounding box covers 15-60% of each side."""
    bw, bh = rng.uniform(0.15, 0.6) * w, rng.uniform(0.15, 0.6) * h
    x0, y0 = rng.uniform(0, w - bw), rng.uniform(0, h - bh)
    corners = [(x0, y0), (x0 + bw, y0 + bh)]
    extra = [(x0 + rng.uniform(0, bw), y0 + rng.uniform(0, bh))
             for _ in range(rng.randint(1, 3))]
    return [(round(x, 2), round(y, 2)) for x, y in [corners[0], *extra, corners[1]]]


def pipeline_inputs(root: Path, n_images: int = 256, seed: int = 0,
                    sides=(240, 1081), n_dup: int = 20, n_corrupt: int = 6,
                    n_null: int = 6, n_ref: int = 16, high_every: int = 16) -> dict:
    """The nine steps' inputs under ``root`` (its path must not hold the
    word "images": the YOLO layout maps images/ to labels/ by the first
    occurrence):

    - ``n_images`` PNG sources of ``sides`` px a side, each with one animal
      polygon and, on every other image, a vehicle polygon, drawn in;
      every ``high_every``-th image also holds a copy of its animal box
      shifted by 0.05% (IoU >= 0.98: step 5's suspects); image 1 holds two
      identical zero-area boxes, image 2 a pair at IoU just below 0.98 and
      image 3 seventy small disjoint boxes (more than step 5's packed cap),
      all under a label in no category;
    - ``raw/a.csv`` (the first half of the images, then ``n_null`` rows with
      no label cell) and ``raw/b.csv`` (the second half, then ``n_dup``
      repeats of sources of the first half and ``n_corrupt`` rows of
      corrupt JSON);
    - ``ref.csv``: ``n_ref`` sources of the second half;
    - ``label_map.xlsx`` (猫 -> cat, 狗 -> dog) and ``rules.xlsx`` (wide:
      animals, vehicles).

    Returns the paths and each step's row counts."""
    import pandas as pd
    from PIL import Image, ImageDraw

    from deal_yolo_daya_tpu_torch.utils import xlsx

    assert "images" not in str(root), root
    rng = random.Random(seed)
    src_dir, raw_dir = root / "sources", root / "raw"
    src_dir.mkdir(parents=True, exist_ok=True)
    raw_dir.mkdir(parents=True, exist_ok=True)
    colours = {"猫": (220, 40, 40), "狗": (40, 200, 40), "car": (40, 40, 220),
               "truck": (230, 200, 30), UNRULED: (200, 200, 200)}
    rows, kinds = [], []
    for i in range(n_images):
        w, h = rng.randrange(*sides), rng.randrange(*sides)
        objects = [(rng.choice(ANIMALS), _polygon(rng, w, h))]
        kind = "good"
        if i % 2 == 0:
            objects.append((rng.choice(VEHICLES), _polygon(rng, w, h)))
        if i % high_every == high_every - 1:
            name, pts = objects[0]
            xs, ys = [p[0] for p in pts], [p[1] for p in pts]
            dx, dy = 5e-4 * (max(xs) - min(xs)), 5e-4 * (max(ys) - min(ys))
            objects.append((name, [(round(min(xs) + dx, 2), round(min(ys) + dy, 2)),
                                   (round(max(xs) + dx, 2), round(max(ys) + dy, 2))]))
            kind = "high"
        elif i == 1:
            objects += [(UNRULED, [(5.0, 5.0), (5.0, 5.0)])] * 2
        elif i == 2:  # IoU = 100 * 97.9 / (100 * 100) = 0.979
            objects += [(UNRULED, [(10.0, 10.0), (110.0, 110.0)]),
                        (UNRULED, [(10.0, 10.0), (110.0, 107.9)])]
        elif i == 3:
            objects += [(UNRULED, [(2.0 + 3 * k, 2.0), (4.0 + 3 * k, 4.0)]) for k in range(70)]
        img = Image.new("RGB", (w, h), tuple(rng.randrange(60, 140) for _ in range(3)))
        draw = ImageDraw.Draw(img)
        for name, pts in objects:
            if len(pts) > 2:
                draw.polygon(pts, fill=colours[name])
            else:
                draw.rectangle([pts[0], (max(pts[0][0], pts[1][0]), max(pts[0][1], pts[1][1]))],
                               outline=colours[name])
        path = src_dir / f"src_{i:04d}.png"
        img.save(path, compress_level=1)
        rows.append({"source": str(path), LABEL_JSON_COL: _label_cell(objects, w, h)})
        kinds.append((kind, sum(1 for n, _ in objects if n in VEHICLES)))

    half = n_images // 2
    nulls = [{"source": str(src_dir / f"null_{k}.png"), LABEL_JSON_COL: None}
             for k in range(n_null)]
    corrupt = [{"source": str(src_dir / f"corrupt_{k}.png"),
                LABEL_JSON_COL: '{"width": 10, "objects": [' + "x" * k}
               for k in range(n_corrupt)]
    dups = [dict(rows[k]) for k in rng.sample(range(half), n_dup)]
    pd.DataFrame(rows[:half] + nulls).to_csv(raw_dir / "a.csv", index=False,
                                               encoding="utf-8-sig")
    pd.DataFrame(rows[half:] + dups + corrupt).to_csv(raw_dir / "b.csv", index=False,
                                                        encoding="utf-8-sig")
    # the reference rows: second-half images that are not suspects
    plain = [k for k in range(half, n_images) if kinds[k][0] == "good"]
    ref_idx = set(rng.sample(plain, n_ref))
    pd.DataFrame({"source": [rows[k]["source"] for k in sorted(ref_idx)]}).to_csv(
        root / "ref.csv", index=False, encoding="utf-8-sig")
    label_map = root / "label_map.xlsx"
    xlsx.to_excel(pd.DataFrame({"原标签": list(LABEL_MAP), "新标签": list(LABEL_MAP.values())}),
                  label_map)
    rules = root / "rules.xlsx"
    xlsx.to_excel(pd.DataFrame({cat: [labels] for cat, labels in RULES.items()}), rules)

    kept = [kinds[k] for k in range(n_images) if k not in ref_idx]
    n_high = sum(1 for kind, _ in kept if kind == "high")
    n_clean = len(kept) - n_high  # one animal object each
    categories = {"animals": n_clean,
                  "vehicles": sum(v for kind, v in kept if kind == "good")}
    ratio_sum = 0.8 + 0.1 + 0.1
    splits = {}
    for cat, n in categories.items():
        n_train, n_val = int(n * (0.8 / ratio_sum)), int(n * (0.1 / ratio_sum))
        splits[cat] = {"train": n_train, "val": n_val, "test": n - n_train - n_val}
    merged = n_images + n_null + n_dup + n_corrupt
    dedup = merged - n_dup
    filtered = dedup - n_ref
    return {
        "csv_dir": raw_dir, "ref": root / "ref.csv", "label_map": label_map, "rules": rules,
        "counts": {
            "merged": merged, "dedup": dedup, "filtered": filtered,
            "processed": filtered - n_null, "excluded": n_null,
            "high_iou": n_high, "other": filtered - n_null - n_high,
            "label_replaced": filtered - n_null - n_high,
            "replaced_rows": n_clean, "categories": categories, "splits": splits,
            "yolo_images": splits, "drawn": MAX_DRAWN,
        },
    }


def _rows(path) -> int:
    import pandas as pd

    return len(pd.read_csv(path, encoding="utf-8-sig"))


def run_pipeline(P, fx: dict, root: Path, seed: int = 42) -> dict:
    """The nine steps of processor module ``P`` on ``pipeline_inputs``'
    ``fx``, in order, with the arguments the processing page passes, into
    ``root``; each step's outputs, row counts and seconds."""
    from deal_yolo_daya_tpu_torch.utils import xlsx

    root.mkdir(parents=True, exist_ok=True)
    out, seconds = {}, {}

    def step(name, fn, *args):
        t0 = time.perf_counter()
        result = fn(*args)
        seconds[name] = time.perf_counter() - t0
        return result

    out["merge"] = step("merge", P.merge_all_csv_in_folder, str(fx["csv_dir"]),
                        str(root / "merged_result.csv"), "utf-8-sig", 100000, None)
    step("dedup", P.deduplicate_csv_by_source, str(root / "merged_result.csv"),
         str(root / "deduplicate_result.csv"))
    step("ref_filter", P.remove_duplicates_between_csv, str(root / "deduplicate_result.csv"),
         str(fx["ref"]), str(root / "filtered_main.csv"))
    out["replace_ptlist"] = step(
        "replace_ptlist", P.process_csv_replace_ptlist, str(root / "filtered_main.csv"),
        str(root / "processed_replaced_ptlist.csv"),
        str(root / "processed_replaced_ptlist_excluded.csv"))
    out["iou_filter"] = step(
        "iou_filter", P.filter_by_box_count_and_iou, str(root / "processed_replaced_ptlist.csv"),
        str(root / "high_iou_0.98.csv"), str(root / "other_data.csv"), 2, 0.98)
    out["label_replace"] = step(
        "label_replace", P.replace_labels_by_mapping, str(root / "other_data.csv"),
        str(fx["label_map"]), str(root / "other_data_label_replaced.csv"), None, None, None,
        None, str(root / "label_replace_diff.xlsx"), str(root / "label_replace_unmatched.xlsx"))
    split_dir = root / "split_by_category"
    out["split"] = step(
        "split", P.split_dataset_by_rules, str(root / "other_data_label_replaced.csv"),
        str(fx["rules"]), str(split_dir), "wide", None, None, None, None, 0.8, 0.1, 0.1, seed)
    out["unclassified_summary"] = P.summarize_unclassified(
        str(out["split"]["unclassified"]), str(split_dir))
    yolo_dir = root / "yolo_datasets"
    out["yolo"] = step(
        "yolo", P.generate_yolo_datasets_from_excels, out["split"]["category_files"],
        str(yolo_dir), str(yolo_dir / "image_cache"), "source", "分类标签",
        "新_" + LABEL_JSON_COL, LABEL_JSON_COL, "width", "height", True, seed, None, True)
    out["download"] = step(
        "download", P.download_and_draw_annotations,
        str(root / "other_data_label_replaced.csv"), str(root), None, None, MAX_DRAWN, 15)

    counts = {
        "merged": _rows(root / "merged_result.csv"),
        "dedup": _rows(root / "deduplicate_result.csv"),
        "filtered": _rows(root / "filtered_main.csv"),
        "processed": _rows(root / "processed_replaced_ptlist.csv"),
        "excluded": _rows(root / "processed_replaced_ptlist_excluded.csv"),
        "high_iou": _rows(root / "high_iou_0.98.csv"),
        "other": _rows(root / "other_data.csv"),
        "label_replaced": _rows(root / "other_data_label_replaced.csv"),
        "replaced_rows": out["label_replace"]["summary"]["replaced_rows"],
        "categories": out["split"]["summary"]["category_counts"],
        "splits": {Path(p).stem: {s: len(d) for s, d in
                                  xlsx.read_workbook(p, sheet_name=None).items()}
                   for p in out["split"]["category_files"]},
        "yolo_images": {Path(d).name: {s: sum(1 for _ in (Path(d) / "images" / s).iterdir())
                                       for s in ("train", "val", "test")}
                        for d in out["yolo"]["datasets"]},
        "drawn": out["download"]["success"],
    }
    return {"outputs": out, "counts": counts, "seconds": seconds,
            "datasets": {Path(d).name: Path(d) for d in out["yolo"]["datasets"]}}


def page_train_kwargs(project: str, name: str, **overrides) -> dict:
    """The ``train_kwargs`` the training page (ui/pages/training.py) hands
    ``run_yolo_training_stream`` with every widget at its default, the
    project and run name given, then ``overrides``."""
    kwargs = {
        "epochs": 100, "imgsz": 640, "batch": 16, "workers": 3, "device": "", "amp": True,
        "optimizer": "auto", "seed": 0, "patience": 100, "cos_lr": False, "close_mosaic": 10,
        "save_period": -1, "project": project, "name": name, "exist_ok": False,
        "resume": False, "cache": None, "val": True, "val_period": 1,
        "mosaic": 1.0, "mixup": 0.0, "scale": 0.5, "translate": 0.1, "degrees": 0.0,
        "shear": 0.0, "fliplr": 0.5, "flipud": 0.0, "hsv_h": 0.015, "hsv_s": 0.7,
        "hsv_v": 0.4, "box": 7.5, "cls": 0.5, "dfl": 1.5,
    }
    kwargs.update(overrides)
    return kwargs


# ------------------------------------------------------ the packed IoU table

def _iou_f32(a, b):
    """The IoU of xyxy f32 box pairs, rounded as the filter rounds it (each
    op in f32: intersection, areas, union, one division)."""
    import numpy as np

    iw = np.clip(np.minimum(a[..., 2], b[..., 2]) - np.maximum(a[..., 0], b[..., 0]), 0, None)
    ih = np.clip(np.minimum(a[..., 3], b[..., 3]) - np.maximum(a[..., 1], b[..., 1]), 0, None)
    inter = iw * ih
    union = ((a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
             + (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])) - inter
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.where((inter > 0) & (union != 0), inter / np.where(union != 0, union, 1), 0)


PLANTED = ("identical", "tie", "above", "below", "zero_area", "masked_copy", "one_box")
# the flag each planted kind must get at min_boxes 2
PLANTED_HIT = {"identical": True, "tie": True, "above": True, "below": False,
               "zero_area": False, "masked_copy": False, "one_box": False}


def planted_iou_table(n_rows: int, width: int, seed: int = 0, thr: float = 0.98,
                      share: float = 0.01):
    """A packed (n_rows, width, 4) f32 table and (n_rows, width) mask of
    random boxes (0-width valid boxes a row) with ``share`` of its rows
    planted, in equal numbers, with a pair of boxes of each kind of
    ``PLANTED`` at two random slots, the row's other boxes moved away from
    them:

    - identical: two equal boxes (IoU 1);
    - tie, above, below: IoU, computed in f32, exactly ``thr`` in f32, one
      f32 step above it and one below (found by a search over heights a few
      f32 steps from ``thr`` x 100 on randomly placed boxes);
    - zero_area: two identical boxes of zero width (intersection 0 -> IoU 0);
    - masked_copy: an identical copy of a box in a slot the mask leaves out;
    - one_box: a row of one valid box.

    Returns (boxes, mask, {kind: row indices})."""
    import numpy as np

    assert width >= 2, "a pair needs two slots"
    rng = np.random.default_rng(seed)
    boxes = np.empty((n_rows, width, 4), np.float32)
    xy = rng.uniform(0, 1000, (n_rows, width, 2)).astype(np.float32)
    wh = rng.uniform(1, 300, (n_rows, width, 2)).astype(np.float32)
    boxes[..., :2], boxes[..., 2:] = xy, xy + wh
    counts = rng.integers(0, width + 1, n_rows)
    mask = np.arange(width)[None, :] < counts[:, None]

    thr32 = np.float32(thr)
    want = {"tie": thr32, "above": np.nextafter(thr32, np.float32(2)),
            "below": np.nextafter(thr32, np.float32(0))}
    # candidate pairs: a square of side s and a box of the same base and
    # width with a height a few f32 steps from thr x s, at random places;
    # each kind keeps the pairs that hit it
    n_cand = 1 << 16
    base = rng.uniform(0, 200, (n_cand, 2)).astype(np.float32)
    side = rng.uniform(50, 150, n_cand).astype(np.float32)
    near = (np.float32(thr) * side).astype(np.float32)
    h = near + rng.integers(-8, 9, n_cand).astype(np.float32) * np.spacing(near)
    a = np.stack([base[:, 0], base[:, 1], base[:, 0] + side, base[:, 1] + side], 1)
    b = np.stack([base[:, 0], base[:, 1], base[:, 0] + side, base[:, 1] + h], 1)
    iou = _iou_f32(a, b)
    pairs = {k: (a[iou == v], b[iou == v]) for k, v in want.items()}
    for k, (pa, _) in pairs.items():
        assert len(pa), f"no candidate pair at IoU {k} {want[k]!r}"

    n_kind = max(int(n_rows * share) // len(PLANTED), 1)
    rows = rng.permutation(n_rows)[:n_kind * len(PLANTED)].reshape(len(PLANTED), n_kind)
    planted = {}
    for kind, idx in zip(PLANTED, rows):
        planted[kind] = np.sort(idx)
        n_box = rng.integers(2, width + 1, n_kind)
        if kind == "one_box":
            n_box[:] = 1
        mask[idx] = np.arange(width)[None, :] < n_box[:, None]
        # the row's other boxes far from the pair and from each other
        boxes[idx, :, 0] = 2000 + 400 * np.arange(width, dtype=np.float32)
        boxes[idx, :, 2] = boxes[idx, :, 0] + 100
        if kind == "one_box":
            continue
        slots = np.stack([rng.choice(n, 2, replace=False) for n in n_box])
        s0, s1 = slots[:, 0], slots[:, 1]
        if kind == "masked_copy":  # the copy goes just past the valid boxes
            mask[idx] = np.arange(width)[None, :] < np.maximum(n_box - 1, 1)[:, None]
            s0, s1 = np.zeros(n_kind, int), np.maximum(n_box - 1, 1)
        if kind in ("identical", "masked_copy"):
            boxes[idx, s1] = boxes[idx, s0]
        elif kind == "zero_area":
            boxes[idx, s0, 2] = boxes[idx, s0, 0]
            boxes[idx, s1] = boxes[idx, s0]
        else:
            pa, pb = pairs[kind]
            pick = rng.integers(0, len(pa), n_kind)
            boxes[idx, s0], boxes[idx, s1] = pa[pick], pb[pick]
    return boxes, mask, planted


def main() -> int:
    import tempfile

    n = int(sys.argv[1]) if len(sys.argv) > 1 else 50_000
    with tempfile.TemporaryDirectory(prefix="dk_chain_") as tmp:
        seconds = run_chain(Path(tmp), n)
    print(json.dumps({"rows": n, "seconds": seconds, "total_s": sum(seconds.values())}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""YOLO dataset generation + label-count statistics.

Per-category Excel (train/val/test sheets) -> standard YOLO11 dataset layout
(images/{split}, labels/{split}, data.yaml). Artifact contract matches the
reference (core/processor.py:893-1163): same directory naming/dedup, class
ordering (sorted-unique with user class_order override), resume-by-label-file,
skipped-row audit Excel, 50-row progress cadence, and the generator's
unclamped 6-decimal ``cid cx cy w h`` label lines (core/processor.py:1045-1052
— distinct from the clamped standalone converter in labels.py).

Architecture differs from the reference's single row loop: a vectorized
PLAN phase (one AnnTable scan per sheet resolves per-row skip reasons, the
matching boxes and known image sizes as columns) followed by an IO-only
EXECUTE phase (cache lookup, byte copy, label write). Images for a whole
split are prefetched concurrently before execution.
"""

from __future__ import annotations

import os
from collections import Counter
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

import numpy as np
import pandas as pd
import yaml
from PIL import Image

from ..utils import xlsx
from ..utils.naming import safe_dataset_dir_name, safe_image_stem
from . import columnar
from .download import ensure_image_cached, prefetch_images
from .labels import LABEL_JSON_COL, NEW_LABEL_JSON_COL


def write_label_lines(filtered_boxes, class_id: int, width: float, height: float):
    """YOLO label lines for one image (no clamping, zero-size boxes dropped)."""
    lines = []
    for x1, y1, x2, y2 in filtered_boxes:
        x1, x2 = min(x1, x2), max(x1, x2)
        y1, y2 = min(y1, y2), max(y1, y2)
        bw, bh = x2 - x1, y2 - y1
        if bw <= 0 or bh <= 0:
            continue
        lines.append(
            f"{class_id} {(x1 + x2) / 2 / width:.6f} {(y1 + y2) / 2 / height:.6f} "
            f"{bw / width:.6f} {bh / height:.6f}"
        )
    return lines


@dataclass
class _RowPlan:
    """One sheet row after vectorized planning."""

    source: Optional[str]
    stem: str
    class_id: int            # -1 when the label is missing/unknown
    boxes: np.ndarray        # (k,4) absolute coords of label-matching objects
    width: Optional[float]
    height: Optional[float]
    early_skip: Optional[str]  # plan-time skip reason (source/label)


def _plan_sheet(df_split, source_col, label_col, json_cols, width_col,
                height_col, class_to_id) -> list:
    """Vectorized per-sheet planning: resolve sources, labels, matching boxes
    and known sizes as columns; IO decisions are left to the execute phase."""
    n = len(df_split)
    sources = (
        df_split[source_col] if source_col in df_split.columns
        else pd.Series([None] * n)
    )
    has_source = sources.notna() & (sources.astype(str) != "")
    labels = (
        df_split[label_col].astype(str) if label_col in df_split.columns
        else pd.Series([""] * n)
    )
    class_ids = labels.map(class_to_id).fillna(-1).astype(int).to_numpy()

    # one scan resolves every row's boxes for its own label. Column
    # fallthrough mirrors the reference's `row.get(primary) or
    # row.get(fallback)` (processor.py:918): float('nan') is TRUTHY in
    # Python, so a NaN primary cell CLAIMS its row (and later parse-fails
    # into a skip) rather than falling back to the next column; only an
    # empty string falls through.
    cells = pd.Series([None] * n, dtype=object)
    claimed = np.zeros(n, dtype=bool)
    for col in json_cols:
        if col in df_split.columns:
            vals = df_split[col]
            usable = (vals.notna() & (vals.astype(str) != "")).to_numpy()
            take = ~claimed & usable
            cells[take] = vals[take]
            claimed |= usable | vals.isna().to_numpy()
    table = columnar.build_table(cells)

    names = np.asarray(table.names, dtype=object)
    label_per_obj = labels.to_numpy(dtype=object)[table.obj_row] if table.m else names
    named = np.array([bool(x) for x in names], dtype=bool) if table.m else np.zeros(0, bool)
    match = named & (names == label_per_obj) & table.bbox_ok() if table.m else named
    counts = np.bincount(table.obj_row[match], minlength=n) if table.m else np.zeros(n, int)
    boxes_by_row = np.split(table.box[match], np.cumsum(counts)[:-1]) if table.m else [
        np.zeros((0, 4))
    ] * n

    def _size(col):
        if col not in df_split.columns:
            return [None] * n
        return [None if pd.isna(v) or not v else float(v)
                for v in df_split[col].tolist()]

    widths, heights = _size(width_col), _size(height_col)

    plans = []
    src_np = sources.to_numpy(dtype=object)       # per-row .iloc costs a
    has_np = has_source.to_numpy()                # chunk walk on Arrow cols
    cid_list = class_ids.tolist()
    for i in range(n):
        src = str(src_np[i]) if has_np[i] else None
        early = None
        if src is None:
            early = "缺少source"
        elif cid_list[i] < 0:
            early = "缺少或无效分类标签"
        plans.append(_RowPlan(
            source=src,
            stem=safe_image_stem(src, i) if src else "",
            class_id=cid_list[i],
            boxes=boxes_by_row[i],
            width=widths[i], height=heights[i],
            early_skip=early,
        ))
    return plans


def generate_yolo_datasets_from_excels(
    category_excels: list,
    output_dir: str,
    image_cache_dir: Optional[str] = None,
    source_col: str = "source",
    label_col: str = "分类标签",
    json_col_primary: str = NEW_LABEL_JSON_COL,
    json_col_fallback: str = LABEL_JSON_COL,
    width_col: str = "width",
    height_col: str = "height",
    download_images: bool = True,
    random_seed: int = 42,
    class_order: Optional[list] = None,
    resume: bool = True,
    progress_callback=None,
    prefetch_workers: int = 16,
):
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    cache_dir = Path(image_cache_dir) if image_cache_dir else (output_dir / "image_cache")
    cache_dir.mkdir(parents=True, exist_ok=True)
    json_cols = (json_col_primary, json_col_fallback)

    # ---- inventory phase: load workbooks, dedup directory names ------------
    books = []  # (excel Path, category, dir_name, {split: df})
    used_dir_names: set = set()
    total_rows = 0
    for idx_excel, excel_path in enumerate(category_excels):
        if not excel_path or not Path(excel_path).exists():
            continue
        excel_path = Path(excel_path)
        book = xlsx.read_workbook(excel_path, sheet_name=None)
        sheets = {s: book[s] for s in ("train", "val", "test") if s in book}
        total_rows += sum(len(d) for d in sheets.values())
        base = safe_dataset_dir_name(excel_path.stem, f"category_{idx_excel:03d}")
        dir_name, suffix = base, 1
        while dir_name in used_dir_names:
            dir_name = f"{base}_{suffix}"
            suffix += 1
        used_dir_names.add(dir_name)
        books.append((excel_path, excel_path.stem, dir_name, sheets))

    datasets = []
    dataset_name_map = {}
    skipped = []
    dataset_stats = {}
    counters = Counter(processed=0, copied=0)
    last_info = None

    def tick(category, split, excel_name, idx):
        nonlocal last_info
        last_info = (
            counters["processed"], total_rows, counters["copied"], category,
            split, f"idx_{idx}", "", excel_name, idx,
        )
        if progress_callback and counters["processed"] % 50 == 0:
            progress_callback(*last_info)
        counters["processed"] += 1

    for excel_path, category_name, dir_name, sheets in books:
        dataset_dir = output_dir / dir_name
        dataset_name_map[dir_name] = category_name
        for split in ("train", "val", "test"):
            (dataset_dir / "images" / split).mkdir(parents=True, exist_ok=True)
            (dataset_dir / "labels" / split).mkdir(parents=True, exist_ok=True)

        # class list: sorted unique labels across splits, user order first
        all_labels: list = []
        for d in sheets.values():
            if label_col in d.columns:
                all_labels.extend(str(v) for v in d[label_col].dropna())
        classes = sorted(dict.fromkeys(all_labels))
        if class_order:
            front = [c for c in class_order if c in classes]
            classes = front + [c for c in classes if c not in front]
        class_to_id = {name: i for i, name in enumerate(classes)}

        stats = dataset_stats.setdefault(category_name, {"train": 0, "val": 0, "test": 0})

        for split, df_sheet in sheets.items():
            df_split = df_sheet.sample(frac=1, random_state=random_seed).reset_index(drop=True)

            def skip(reason):
                skipped.append({
                    "category": category_name, "reason": reason, "split": split,
                })

            # ---- plan (vectorized) -----------------------------------------
            plans = _plan_sheet(
                df_split, source_col, label_col, json_cols,
                width_col, height_col, class_to_id,
            )
            if download_images:
                fetched = prefetch_images(
                    [p.source for p in plans if p.source],
                    cache_dir, max_workers=prefetch_workers,
                )
                n_fail = sum(1 for v in fetched.values() if v is None)
                if n_fail:
                    print(
                        f"警告：{category_name}/{split} 预取失败 "
                        f"{n_fail}/{len(fetched)} 张图片"
                    )

            # ---- execute (IO only) ------------------------------------------
            images_dir = dataset_dir / "images" / split
            labels_dir = dataset_dir / "labels" / split
            labels_prefix = str(labels_dir) + os.sep
            for idx, plan in enumerate(plans):
                tick(category_name, split, excel_path.name, idx)
                if plan.early_skip:
                    skip(plan.early_skip)
                    continue

                label_path = Path(labels_prefix + plan.stem + ".txt")
                if resume:
                    try:  # one stat covers exists + non-empty
                        if os.stat(labels_prefix + plan.stem + ".txt").st_size > 0:
                            stats[split] += 1
                            continue
                    except OSError:
                        pass

                if len(plan.boxes) == 0:
                    skip("无匹配标签框")
                    continue

                if download_images:
                    image_path = ensure_image_cached(plan.source, cache_dir)
                elif os.path.exists(plan.source):
                    image_path = Path(plan.source)
                else:
                    image_path = None

                width, height = plan.width, plan.height
                if (not width or not height) and image_path:
                    try:
                        with Image.open(image_path) as img:
                            width, height = img.size
                    except Exception:
                        pass
                if not width or not height:
                    skip("缺少图像尺寸")
                    continue

                if image_path is None:
                    skip("图片下载失败")
                    continue
                out_image = images_dir / f"{plan.stem}{Path(image_path).suffix or '.jpg'}"
                if not out_image.exists():
                    try:
                        out_image.write_bytes(Path(image_path).read_bytes())
                        counters["copied"] += 1
                    except Exception:
                        skip("图片写入失败")
                        continue

                lines = write_label_lines(plan.boxes, plan.class_id, width, height)
                if not lines:
                    skip("标注框无效")
                    continue
                label_path.write_text("\n".join(lines), encoding="utf-8")
                stats[split] += 1

        (dataset_dir / "data.yaml").write_text(
            yaml.dump(
                {
                    "path": str(dataset_dir),
                    "train": "images/train",
                    "val": "images/val",
                    "test": "images/test",
                    "nc": len(classes),
                    "names": classes,
                },
                sort_keys=False,
                allow_unicode=True,
            ),
            encoding="utf-8",
        )
        datasets.append(dataset_dir)

    skipped_path = output_dir / "yolo_skipped.xlsx"
    xlsx.to_excel(
        pd.DataFrame(skipped if skipped else [{"category": "无", "reason": "无", "split": "无"}]),
        skipped_path,
    )

    if progress_callback and last_info is not None:
        # The reference crashes here on undefined locals (core/processor.py:1076-1077);
        # we report the final progress tuple instead.
        progress_callback(*last_info)

    return {
        "datasets": datasets,
        "skipped": skipped_path,
        "stats": dataset_stats,
        "total": total_rows,
        "processed": counters["processed"],
        "downloaded": counters["copied"],
        "dataset_name_map": dataset_name_map,
    }


def _count_labels_in_dir(label_dir: Path, names: list):
    """(per-label image counts, per-label box counts, n label files)."""
    img_counts: Counter = Counter()
    box_counts: Counter = Counter()
    total_images = 0
    if not label_dir.exists():
        return img_counts, box_counts, 0
    for txt_path in label_dir.glob("*.txt"):
        total_images += 1
        try:
            lines = txt_path.read_text(encoding="utf-8", errors="ignore").splitlines()
        except Exception:
            continue
        row_labels = set()
        for line in lines:
            parts = line.split()
            if not parts:
                continue
            try:
                cid = int(float(parts[0]))
            except Exception:
                continue
            label = names[cid] if cid < len(names) else str(cid)
            row_labels.add(label)
            box_counts[label] += 1
        img_counts.update(row_labels)
    return img_counts, box_counts, total_images


def summarize_yolo_label_counts(dataset_dirs):
    """Per split and label: image/box counts and percentages for generated
    datasets; returns (nested stats dict, flat DataFrame)
    (reference: core/processor.py:1089-1163)."""
    stats = {}
    flat_rows = []

    def flat(dataset, split, img_counts, box_counts, denom):
        for label in set(img_counts) | set(box_counts):
            flat_rows.append({
                "数据集": dataset, "split": split, "标签": label,
                "图片数量": img_counts.get(label, 0),
                "标注框数量": box_counts.get(label, 0),
                "占比%": (
                    f"{(img_counts.get(label, 0) / denom * 100):.1f}%"
                    if denom else "0.0%"
                ),
                "split总图片数": denom,
            })

    for dataset_dir in dataset_dirs or []:
        if not dataset_dir:
            continue
        dataset_path = Path(dataset_dir)
        if not dataset_path.exists():
            continue

        names: list = []
        data_yaml = dataset_path / "data.yaml"
        if data_yaml.exists():
            try:
                meta = yaml.safe_load(data_yaml.read_text(encoding="utf-8"))
                names = meta.get("names") or []
            except Exception:
                pass

        split_stats = {}
        all_imgs: Counter = Counter()
        all_boxes: Counter = Counter()
        n_all = 0
        for split in ("train", "val", "test"):
            img_counts, box_counts, n_imgs = _count_labels_in_dir(
                dataset_path / "labels" / split, names
            )
            split_stats[split] = {
                "total_images": n_imgs,
                "label_counts": dict(img_counts),
                "box_counts": dict(box_counts),
            }
            all_imgs.update(img_counts)
            all_boxes.update(box_counts)
            n_all += n_imgs
            flat(dataset_path.name, split, img_counts, box_counts, n_imgs)

        split_stats["all"] = {
            "total_images": n_all,
            "label_counts": dict(all_imgs),
            "box_counts": dict(all_boxes),
        }
        stats[dataset_path.name] = split_stats
        flat(dataset_path.name, "all", all_imgs, all_boxes, n_all)

    return stats, pd.DataFrame(flat_rows)

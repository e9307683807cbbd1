"""Annotated-image visualization (pipeline step 9, "download").

Draws original annotations in red and converted 2-point bboxes in green with
class-name text; rectangles for 2-point lists, polygons otherwise; CJK font
fallback chain (reference: core/processor.py:409-514). Host-side PIL by design
— drawing never belongs on the card. Downloads are warmed concurrently first.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Optional

import pandas as pd
from PIL import Image, ImageDraw, ImageFont

from .download import prefetch_images
from .labels import LABEL_JSON_COL, NEW_LABEL_JSON_COL, parse_data_objects


def _get_font(size: int = 48):
    for name in ("simhei.ttf", "Arial Unicode.ttf"):
        try:
            return ImageFont.truetype(name, size)
        except Exception:
            continue
    return ImageFont.load_default()


def _draw_annotation_boxes(json_str, color, draw, font):
    data, objects, error = parse_data_objects(json_str)
    if error:
        return
    for obj in objects:
        if not isinstance(obj, dict):
            continue
        name = obj.get("name", "未知类别")
        ptlist = obj.get("polygon", {}).get("ptList", [])
        points = [
            (p["x"], p["y"])
            for p in ptlist
            if isinstance(p, dict) and p.get("x") is not None and p.get("y") is not None
        ]
        if len(points) < 2:
            continue
        try:
            if len(points) == 2:
                (x1, y1), (x2, y2) = points
                draw.rectangle([x1, y1, x2, y2], outline=color, width=2)
                anchor = (x1, y1 - 20)
            else:
                draw.polygon(points, outline=color, width=2)
                anchor = (min(p[0] for p in points), min(p[1] for p in points) - 20)
            text_bbox = draw.textbbox(anchor, name, font=font)
            draw.rectangle(text_bbox, fill=(255, 255, 255, 180))
            draw.text(anchor, name, font=font, fill=color)
        except Exception:
            continue


def _workdirs(output_dir, download_dir, result_dir):
    base = Path(output_dir or os.getcwd())
    made = {
        "download": Path(download_dir) if download_dir else base / "downloaded_images",
        "result": Path(result_dir) if result_dir else base / "annotated_images",
    }
    for d in made.values():
        d.mkdir(parents=True, exist_ok=True)
    return made


def _render_row(row, idx, dirs, font, timeout) -> bool:
    """Draw one row's original (red) + converted (green) annotations.

    Cache-key rules match the prefetch (query strings stripped); retries the
    download if the warm-up missed this row. Returns success.
    """
    from .download import ensure_image_cached

    src = str(row["source"])
    local_path = ensure_image_cached(src, dirs["download"], timeout=timeout)
    if local_path is None or not Path(local_path).exists():
        return False
    out_name = src.rsplit("/", 1)[-1] if "/" in src else f"image_{idx}.jpg"
    try:
        with Image.open(local_path) as img:
            draw = ImageDraw.Draw(img)
            _draw_annotation_boxes(row[LABEL_JSON_COL], (255, 0, 0), draw, font)
            _draw_annotation_boxes(row[NEW_LABEL_JSON_COL], (0, 255, 0), draw, font)
            img.save(dirs["result"] / out_name)
        return True
    except Exception:
        return False


def download_and_draw_annotations(
    input_csv_path,
    output_dir: Optional[str] = None,
    download_dir: Optional[str] = None,
    result_dir: Optional[str] = None,
    max_images: Optional[int] = None,
    timeout: int = 15,
):
    dirs = _workdirs(output_dir, download_dir, result_dir)

    try:
        df = pd.read_csv(input_csv_path, encoding="utf-8-sig")
    except Exception as e:
        print(f"读取CSV失败：{e}")
        return
    if not {"source", LABEL_JSON_COL, NEW_LABEL_JSON_COL}.issubset(df.columns):
        print("CSV缺少必要列")
        return

    rows = df if max_images is None else df.head(max_images)

    # Concurrent download warm-up (the reference downloads serially per row).
    prefetch_images(
        [str(s) for s in rows["source"].dropna()], dirs["download"], timeout=timeout
    )

    font = _get_font()
    counts = {True: 0, False: 0}
    for idx, row in df.iterrows():
        if max_images is not None and counts[True] + counts[False] >= max_images:
            break
        counts[_render_row(row, idx, dirs, font, timeout)] += 1

    print(f"可视化完成：成功 {counts[True]} 张，失败 {counts[False]} 张")
    return {"success": counts[True], "fail": counts[False], "result_dir": dirs["result"]}

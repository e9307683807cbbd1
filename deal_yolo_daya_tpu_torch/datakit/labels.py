"""Label/JSON parsing kit.

Annotation rows carry a JSON cell ("结果字段-目标检测标签配置") of the shape
``{"width": W, "height": H, "objects": [{"name": "a,b", "polygon":
{"ptList": [{"x":..,"y":..}, ...]}}, ...]}``. This module parses those cells
and multi-valued label strings.

Behavioral contract mirrors reference core/utils.py:635-724 (split on
``[,，;；|]``, dedup+sort on token replacement, bbox from min/max of polygon
points) — implemented fresh for single-parse columnar use.
"""

from __future__ import annotations

import json
import re
from typing import Dict, List, Optional, Tuple

import pandas as pd

LABEL_JSON_COL = "结果字段-目标检测标签配置"
NEW_LABEL_JSON_COL = "新_结果字段-目标检测标签配置"

SEP_PATTERN = r"[,，;；|]"
_SEP_RE = re.compile(SEP_PATTERN)


def split_label_cell(cell_value) -> List[str]:
    """Split a rules-Excel cell holding one or more labels."""
    if cell_value is None or (isinstance(cell_value, float) and pd.isna(cell_value)):
        return []
    text = str(cell_value).strip()
    if not text:
        return []
    return [t.strip() for t in _SEP_RE.split(text) if t.strip()]


def split_object_labels(raw_name) -> List[str]:
    """Split an object's possibly multi-valued ``name`` into label tokens."""
    if not raw_name:
        return []
    return [t.strip() for t in _SEP_RE.split(str(raw_name)) if t.strip()]


def replace_label_tokens(raw_name, label_map: Dict[str, str]) -> Tuple[str, int, int]:
    """Map each token through label_map; result is dedup+sorted, comma-joined.

    Returns (new_name, replaced_count, token_count).
    """
    if not raw_name:
        return raw_name, 0, 0
    tokens = split_object_labels(raw_name)
    replaced = sum(1 for t in tokens if t in label_map)
    new_tokens = sorted({label_map.get(t, t) for t in tokens})
    return ",".join(new_tokens), replaced, len(tokens)


def parse_data_objects(json_str) -> Tuple[Optional[dict], list, Optional[str]]:
    """Parse an annotation JSON cell -> (data, objects, error)."""
    if json_str is None or not isinstance(json_str, str) or not json_str:
        return None, [], "空数据"
    try:
        data = json.loads(json_str)
    except json.JSONDecodeError:
        return None, [], "JSON解析失败"
    except Exception as e:  # pragma: no cover - defensive
        return None, [], str(e)
    objects = data.get("objects", [])
    if not isinstance(objects, list):
        return data, [], "objects不是列表"
    return data, objects, None


def extract_boxes_with_labels(json_str) -> List[Tuple[str, float, float, float, float]]:
    """All (label, x1, y1, x2, y2) boxes in a cell; polygon points are
    collapsed to their axis-aligned bounding box."""
    boxes: List[Tuple[str, float, float, float, float]] = []
    data, objects, error = parse_data_objects(json_str)
    if error:
        return boxes
    for obj in objects:
        if not isinstance(obj, dict):
            continue
        label = obj.get("name")
        if not label:
            continue
        ptlist = obj.get("polygon", {}).get("ptList", [])
        if not ptlist:
            continue
        xs = [
            p["x"] for p in ptlist
            if isinstance(p, dict) and p.get("x") is not None
        ]
        ys = [
            p["y"] for p in ptlist
            if isinstance(p, dict) and p.get("y") is not None
        ]
        if not xs or not ys:
            continue
        boxes.append((label, min(xs), min(ys), max(xs), max(ys)))
    return boxes


def extract_two_point_boxes(json_str) -> List[Tuple[float, float, float, float]]:
    """Boxes from cells where ptList is exactly 2 points (post poly->bbox step).

    Matches the IoU-filter extraction semantics (reference:
    core/processor.py:341-366): skips malformed points, orders coordinates.
    """
    boxes: List[Tuple[float, float, float, float]] = []
    data, objects, error = parse_data_objects(json_str)
    if error:
        return boxes
    for obj in objects:
        if not isinstance(obj, dict):
            continue
        ptlist = obj.get("polygon", {}).get("ptList", [])
        if len(ptlist) != 2:
            continue
        p1, p2 = ptlist
        if not (
            isinstance(p1, dict) and isinstance(p2, dict)
            and p1.get("x") is not None and p1.get("y") is not None
            and p2.get("x") is not None and p2.get("y") is not None
        ):
            # null/absent coordinates: skip this object, keep the rest
            # (the reference aborts the whole row here — processor.py:364)
            continue
        boxes.append((
            min(p1["x"], p2["x"]),
            min(p1["y"], p2["y"]),
            max(p1["x"], p2["x"]),
            max(p1["y"], p2["y"]),
        ))
    return boxes


def polygon_to_bbox_points(ptlist: list) -> List[dict]:
    """Axis-aligned 2-point bbox of a polygon's valid points."""
    valid = [p for p in ptlist if isinstance(p, dict) and "x" in p and "y" in p]
    if not valid:
        return [{"x": None, "y": None}, {"x": None, "y": None}]
    xs = [p["x"] for p in valid]
    ys = [p["y"] for p in valid]
    return [{"x": min(xs), "y": min(ys)}, {"x": max(xs), "y": max(ys)}]


def json_to_yolo_annotation(
    json_str: str,
    img_width,
    img_height,
    class_mapping: Dict[str, int],
    class_id_counter: int,
) -> Tuple[str, int, Dict[str, int]]:
    """Standalone converter: annotation JSON -> YOLO label lines.

    Coordinates are clamped to [0.001, 0.999] (reference: core/utils.py:98-102;
    note the dataset generator's writer deliberately does NOT clamp —
    see yolo_dataset.write_label_lines).
    """
    yolo_lines: List[str] = []
    current_class_id = class_id_counter
    data, objects, error = parse_data_objects(json_str)
    if error:
        return "", current_class_id, class_mapping
    img_width = img_width or data.get("width", 1)
    img_height = img_height or data.get("height", 1)
    for obj in objects:
        if not isinstance(obj, dict):
            continue
        # tolerant like the reference: a malformed object yields partial
        # output instead of aborting the cell (core/utils.py:106-109)
        try:
            obj_name = obj.get("name", "unknown")
            if obj_name not in class_mapping:
                class_mapping[obj_name] = current_class_id
                current_class_id += 1
            cid = class_mapping[obj_name]
            ptlist = obj.get("polygon", {}).get("ptList", [])
            if len(ptlist) != 2:
                continue
            p1, p2 = ptlist
            x1, y1 = min(p1["x"], p2["x"]), min(p1["y"], p2["y"])
            x2, y2 = max(p1["x"], p2["x"]), max(p1["y"], p2["y"])
            xc = max(0.001, min(0.999, (x1 + x2) / 2 / img_width))
            yc = max(0.001, min(0.999, (y1 + y2) / 2 / img_height))
            w = max(0.001, min(0.999, (x2 - x1) / img_width))
            h = max(0.001, min(0.999, (y2 - y1) / img_height))
            yolo_lines.append(f"{cid} {xc:.6f} {yc:.6f} {w:.6f} {h:.6f}")
        except Exception:
            continue
    return "\n".join(yolo_lines), current_class_id, class_mapping

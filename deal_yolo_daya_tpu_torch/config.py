"""Canonical pipeline step order.

Mirrors the reference step registry (reference: src/deal_yolo_data/config.py:1-11)
so UI stepper and session-state keys stay compatible.
"""

STEP_ORDER = [
    "merge",
    "dedup",
    "ref_filter",
    "replace_ptlist",
    "iou_filter",
    "label_replace",
    "split",
    "yolo",
    "download",
]

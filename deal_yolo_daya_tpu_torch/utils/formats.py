"""Display formatting helpers.

Output contract with the reference (core/utils.py:113-141): "-" for
missing values, "%.2f <unit>" bytes, HH:MM:SS / MM:SS durations,
thousands-separated ints, "%.1f%%" ratios — the strings feed the stat
cards, so the formats are pinned; the code is not.
"""

from __future__ import annotations

import json
import math

import pandas as pd

_BYTE_UNITS = ("B", "KB", "MB", "GB")  # beyond GB everything prints as TB


def format_bytes(value) -> str:
    if value is None:
        return "-"
    size = float(value)
    for unit in _BYTE_UNITS:
        if not size >= 1024:  # NaN compares false -> "nan B", as before
            return f"{size:.2f} {unit}"
        size /= 1024
    return f"{size:.2f} TB"


def format_duration(seconds) -> str:
    if seconds is None or seconds < 0:
        return "-"
    total = int(seconds)
    fields = [total // 3600, total // 60 % 60, total % 60]
    if not fields[0]:  # hours only when nonzero
        del fields[0]
    return ":".join(f"{f:02d}" for f in fields)


def format_int(value) -> str:
    return "-" if value is None else format(value, ",")


def format_ratio(numerator, denominator) -> str:
    if numerator is None or denominator in (None, 0):
        return "-"
    return f"{(numerator / denominator) * 100:.1f}%"


def safe_dataframe(df: pd.DataFrame) -> pd.DataFrame:
    """Coerce object cells to strings so Arrow-based UIs can render any frame."""

    def _coerce(value):
        if value is None:
            return ""
        if isinstance(value, float) and math.isnan(value):
            return ""
        if isinstance(value, (dict, list)):
            return json.dumps(value, ensure_ascii=False)
        if isinstance(value, (bytes, bytearray)):
            try:
                return value.decode("utf-8", errors="ignore")
            except Exception:
                return value.hex()
        return str(value)

    out = df.copy()
    for col in out.columns:
        if out[col].dtype == "object":
            out[col] = out[col].map(_coerce)
    return out

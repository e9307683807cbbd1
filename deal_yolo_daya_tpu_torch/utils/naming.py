"""Filesystem-safe naming helpers (reference: core/utils.py:525-529, 627-633, 712-724)."""

from __future__ import annotations

import re


_UNSAFE_RE = re.compile(r"[^A-Za-z0-9._-]+")


def safe_filename(value: str, default: str = "train") -> str:
    if not value:
        return default
    cleaned = _UNSAFE_RE.sub("_", str(value)).strip("_")
    return cleaned or default


def safe_dataset_dir_name(category_name, default_name: str) -> str:
    if not category_name:
        return default_name
    return safe_filename(str(category_name))


def safe_image_stem(source_url, idx) -> str:
    """Unique, filesystem-safe image stem derived from a URL/path + row index.

    String ops only: the two pathlib constructions here cost ~30 s/1M rows
    in the generator's plan loop (same result: last path segment, last
    extension stripped pathlib-style)."""
    if not source_url:
        return f"img_{idx}"
    try:
        name = str(source_url).rstrip("/").rsplit("/", 1)[-1]
        dot = name.rfind(".")
        stem = name[:dot] if 0 < dot < len(name) - 1 else name
        if "?" in stem:
            stem = stem.split("?")[0]
        return f"{safe_filename(stem)}_{idx}"
    except Exception:
        return f"img_{idx}"

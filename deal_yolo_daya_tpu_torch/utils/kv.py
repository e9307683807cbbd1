"""Typed key=value line parsing for advanced training overrides.

Contract (reference: core/utils.py:531-567; consumed at
ui/pages/training.py:479-483): coercion order JSON -> bool words ->
none/null -> float-or-int -> raw string, '#' comments skipped, and the two
Chinese error strings — all pinned by tests. The implementation splits the
coercion ladder into its own helper.
"""

from __future__ import annotations

import json
from typing import Dict, List, Tuple

_BOOL_WORDS = {"true": True, "false": False}
_NONE_WORDS = frozenset({"none", "null"})


def _coerce(raw: str):
    """One value through the ladder: JSON, bool word, none word, number, raw."""
    try:
        return json.loads(raw)
    except Exception:
        pass
    lowered = raw.lower()
    if lowered in _BOOL_WORDS:
        return _BOOL_WORDS[lowered]
    if lowered in _NONE_WORDS:
        return None
    try:
        return float(raw) if "." in raw else int(raw)
    except Exception:
        return raw


def parse_kv_lines(text: str) -> Tuple[Dict[str, object], List[str]]:
    options: Dict[str, object] = {}
    errors: List[str] = []
    for raw_line in (text or "").splitlines():
        line = raw_line.strip()
        if not line or line[0] == "#":
            continue
        key, sep, raw_value = line.partition("=")
        if not sep:
            errors.append(f"无法解析：{raw_line}")
            continue
        key = key.strip()
        if not key:
            errors.append(f"参数名为空：{raw_line}")
            continue
        options[key] = _coerce(raw_value.strip())
    return options, errors

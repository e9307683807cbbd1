"""Shared Arrow column classifier for the native CSV / xlsx writers.

One implementation of the "can this column ship to C++ as typed buffers,
and as what kind?" decision that utils/csvio.py and utils/xlsx.py previously
each carried a copy of (the copies had already diverged once in guard
coverage — round-3 self-review). Both writers' byte-parity contracts hang
off this classification, so it lives in exactly one place with the union of
both guard sets:

- pa.array construction guarded (both had it)
- int64 cast guarded (csvio had it; xlsx's overflowing-uint64 Arrow columns
  would previously throw past the per-column fallback)
- float columns accepted only at exact float64 (Float32/f16 extension dtypes
  print fewer repr digits than the widened float64 would)
- object columns verified cell-by-cell (``exact``); typed pandas extension
  dtypes are trusted

Callers keep their own numpy-dtype fast paths (they genuinely differ:
to_csv prints float32 narrow, the xlsx formatter widens it) and their own
failure handling (csvio: whole-frame pandas fallback; xlsx: per-column
pre-rendered RAW cells).
"""

from __future__ import annotations

import numpy as np
import pandas as pd

_EMPTY_BLOB = b"\x00"  # stand-in data pointer for all-empty string columns


def _addr_of(b: bytes) -> int:
    import ctypes

    return ctypes.cast(b, ctypes.c_void_p).value or 0


def arrow_col_spec(values, obj=None, trusted: bool = False,
                   allow_numobj: bool = False):
    """Classify one column through Arrow into a native-writer spec.

    ``values``: the pandas Series (ignored for array construction when
    ``obj`` is given). ``obj``: object-ndarray view for cell-by-cell type
    verification (required when ``trusted`` is False). ``allow_numobj``:
    enable the CSV-only 3-state mixed int/float column kind (pandas to_csv
    writes 640, not 640.0, for int cells of an object column — the step-4
    width/height contract).

    Returns ``(spec_dict, keepalive_list)`` or ``None`` when the column
    cannot be expressed exactly (caller falls back its own way).
    """
    import pyarrow as pa

    from ..runtime import XLSX_BOOL, XLSX_F64, XLSX_I64, XLSX_STR

    try:
        arr = pa.array(obj if obj is not None else values, from_pandas=True)
    except Exception:
        return None
    if isinstance(arr, pa.ChunkedArray):
        # Arrow-backed Series (e.g. the hybrid reader's large_string columns)
        # come back CHUNKED; downstream wants a plain Array. Before this was
        # handled, the `.offset` access below raised inside the callers'
        # try/except — every Arrow-backed frame silently fell back to pandas
        # formatting (62 s of the 1M-row s6 profile, round 4).
        arr = arr.chunk(0) if arr.num_chunks == 1 else arr.combine_chunks()

    def exact(py_type) -> bool:
        if trusted:
            return True
        for v in obj:
            if type(v) is py_type or v is None or v is pd.NA:
                continue
            if type(v) is float and v != v:  # NaN null
                continue
            return False
        return True

    def valid_mask():
        if not arr.null_count:
            return None
        return arr.is_valid().to_numpy(zero_copy_only=False).astype(np.uint8)

    t = arr.type
    if pa.types.is_null(t):  # all-None column: every cell empty
        return {"kind": XLSX_F64, "f64": np.full(len(arr), np.nan)}, []
    if (pa.types.is_string(t) or pa.types.is_large_string(t)) and exact(str):
        arr = arr.cast(pa.large_string())
        if arr.offset:  # unexpected for a fresh array; stay exact
            return None
        bufs = arr.buffers()  # [validity, offsets(int64 x n+1), data]
        blob = bufs[2]
        return (
            {
                "kind": XLSX_STR,
                "blob": blob.address if blob is not None else _addr_of(_EMPTY_BLOB),
                "off": bufs[1].address,
                "valid": valid_mask(),
            },
            [arr, bufs],
        )
    if pa.types.is_integer(t) and exact(int):
        valid = valid_mask()
        try:  # uint64 > i64 max overflows the cast
            vals = arr.cast(pa.int64()).fill_null(0).to_numpy(zero_copy_only=False)
        except Exception:
            return None
        return {"kind": XLSX_I64, "i64": vals, "valid": valid}, []
    if pa.types.is_floating(t) and exact(float):
        if t != pa.float64():  # Float32/f16 extension dtypes print fewer
            return None        # repr digits than the widened float64 would
        vals = arr.cast(pa.float64()).to_numpy(zero_copy_only=False)
        return {"kind": XLSX_F64, "f64": vals}, []
    if pa.types.is_boolean(t) and exact(bool):
        valid = valid_mask()
        vals = arr.fill_null(False).to_numpy(zero_copy_only=False).astype(np.int64)
        return {"kind": XLSX_BOOL, "i64": vals, "valid": valid}, []
    if allow_numobj and not trusted and (
        pa.types.is_floating(t) or pa.types.is_integer(t)
    ):
        # mixed int/float object column: a 3-state per-cell tag keeps int-ness
        from ..runtime import CSV_NUMOBJ

        n = len(obj)
        tag = np.zeros(n, np.uint8)
        i64 = np.zeros(n, np.int64)
        f64 = np.zeros(n, np.float64)
        for k, v in enumerate(obj):
            tv = type(v)
            if tv is int:
                if not (-(2 ** 63) <= v < 2 ** 63):
                    return None
                tag[k] = 1
                i64[k] = v
            elif tv is float:
                if v == v:  # NaN stays tag 0 (empty)
                    tag[k] = 2
                    f64[k] = v
            elif v is not None:
                return None
        return {"kind": CSV_NUMOBJ, "i64": i64, "f64": f64, "valid": tag}, []
    return None

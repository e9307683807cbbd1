"""Fast CSV writing with pandas ``to_csv`` byte parity.

``pd.DataFrame.to_csv`` renders every cell through Python-level formatting —
the dominant cost of the CSV-heavy datakit steps at 1M rows (~17 s/write).
``write_csv`` routes frames whose columns are natively expressible
(str / float64 / int64 / bool, plus their nullable-Arrow variants) through
the C++ writer (runtime/labelscan.cpp::csv_write) and falls back to pandas
for anything else — so the output bytes are identical either way:
QUOTE_MINIMAL quoting ({',', '"', '\\n', '\\r'} triggers, quote doubling),
repr() floats, NaN/None -> empty, True/False bools, single-column empty
fields as "" (reference artifact contract: core/processor.py to_csv calls).
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Optional, Sequence, Union

import numpy as np
import pandas as pd

from .colspec import arrow_col_spec

_QUOTE_TRIGGERS = (",", '"', "\n", "\r")


def _quote(field: str) -> str:
    if any(ch in field for ch in _QUOTE_TRIGGERS):
        return '"' + field.replace('"', '""') + '"'
    return field


def _col_spec(values: pd.Series):
    """(spec, keepalive) for one column, or None when pandas must format it
    (float32, datetimes, mixed object cells, huge uints, ...)."""
    from ..runtime import XLSX_BOOL, XLSX_F64, XLSX_I64

    dt = values.dtype
    if isinstance(dt, np.dtype):
        if dt == bool:
            return {"kind": XLSX_BOOL, "i64": values.to_numpy().astype(np.int64)}, []
        if dt.kind == "i":
            return {"kind": XLSX_I64, "i64": values.to_numpy(np.int64)}, []
        if dt.kind == "u":
            v = values.to_numpy()
            if v.size and v.max() > np.iinfo(np.int64).max:
                return None
            return {"kind": XLSX_I64, "i64": v.astype(np.int64)}, []
        if dt == np.float64:
            return {"kind": XLSX_F64, "f64": values.to_numpy(np.float64)}, []
        if dt != object:  # float32/f16 repr differs; datetimes format specially
            return None

    trusted = not (isinstance(dt, np.dtype) and dt == object)
    obj = None if trusted else values.to_numpy(dtype=object)
    return arrow_col_spec(values, obj=obj, trusted=trusted, allow_numobj=True)


def _write_native(df: pd.DataFrame, path: Path, encoding: str) -> bool:
    from ..runtime import csv_write_native, get_lib

    if get_lib() is None:
        return False
    try:
        specs, keep = [], []
        for i in range(df.shape[1]):  # positional: duplicate names stay safe
            r = _col_spec(df.iloc[:, i])
            if r is None:
                return False
            spec, ka = r
            specs.append(spec)
            keep.extend(ka)
        header = (",".join(_quote(str(c)) for c in df.columns) + "\n").encode("utf-8")
        with open(path, "wb") as f:
            if encoding.lower().replace("_", "-") == "utf-8-sig":
                f.write(b"\xef\xbb\xbf")
            ok = csv_write_native(len(df), specs, header, f)
        del keep
        return ok
    except Exception:
        return False


# pandas C-parser default NA tokens (pandas.io.parsers STR_NA_VALUES) — the
# fast reader's heavy string columns must null the same set
_PANDAS_NA = [
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
    "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None",
    "n/a", "nan", "null",
]


def _read_fast(path, encoding: str, heavy) -> Optional[pd.DataFrame]:
    """Hybrid CSV read. One pyarrow.csv pass parses the whole file with its
    own inference. Columns whose values come out integer (or all-NA) convert
    pandas-BIT-equally from that pass; DECLARED heavy columns (the ~700 B
    JSON label cells that dominate read time, contractually string-valued)
    are additionally trusted when pyarrow infers string — numeric-looking
    heavy columns (e.g. a source column of IDs, where pandas would type and
    reformat them) fall back to the pandas read like every other divergence
    candidate, so downstream to_csv bytes never change. None = caller should
    use plain pandas.
    """
    import pyarrow as pa
    import pyarrow.csv as pacsv

    head = pd.read_csv(path, encoding=encoding, nrows=0)
    cols = list(head.columns)
    if len(cols) != len(set(cols)):  # duplicate headers: pandas mangles them
        return None
    heavy_set = set(heavy)
    heavy_present = [c for c in cols if c in heavy_set]
    if not heavy_present:
        return None
    convert = pacsv.ConvertOptions(
        null_values=_PANDAS_NA,
        strings_can_be_null=True,
    )

    with open(path, "rb") as f:
        start = 3 if f.read(3) == b"\xef\xbb\xbf" else 0
        # newline count for the fast-mode sanity check (page-cache speed)
        f.seek(start)
        nl = 0
        while True:
            chunk = f.read(1 << 26)
            if not chunk:
                break
            nl += chunk.count(b"\n")
        # newlines_in_values=True forces a serial parser (6x slower); the
        # fast mode handles in-block quoted newlines but misparses values
        # spanning read blocks — the line-count check below catches any
        # such file and retries in the fully-general mode. Single-column
        # files skip the fast mode outright: a block-spanning split there
        # can slip past BOTH the field-count error and the line count.
        table = None
        if len(cols) > 1:
            f.seek(start)
            try:
                table = pacsv.read_csv(
                    f,
                    read_options=pacsv.ReadOptions(use_threads=True),
                    parse_options=pacsv.ParseOptions(newlines_in_values=False),
                    convert_options=convert,
                )
            except Exception:
                table = None
        if table is None or nl not in (len(table) + 1, len(table)):
            f.seek(start)
            table = pacsv.read_csv(
                f,
                read_options=pacsv.ReadOptions(use_threads=True),
                parse_options=pacsv.ParseOptions(newlines_in_values=True),
                convert_options=convert,
            )
    if list(table.column_names) != cols:
        return None

    def light_series(c) -> Optional[pd.Series]:
        """pandas-BIT-equal conversion, or None when the pandas parser must
        type the column itself. Integers and all-NA columns are exact in
        both parsers; float TEXT is not — pandas' default xstrtod is off by
        an ulp on long mantissas while pyarrow rounds correctly — so float
        columns (and strings/bools/dates) go back through pandas."""
        arr = table[c]
        t = arr.type
        if pa.types.is_null(t):  # all-NA column: pandas gives float64 NaN
            return pd.Series(np.full(len(arr), np.nan))
        if pa.types.is_signed_integer(t):
            if arr.null_count:  # pandas promotes int-with-NA to float64
                return pd.Series(
                    arr.cast(pa.float64()).to_numpy(zero_copy_only=False)
                )
            return pd.Series(arr.cast(pa.int64()).to_numpy(zero_copy_only=False))
        return None

    out = {}
    pandas_cols = []
    for c in cols:
        s = light_series(c)
        if s is None and c in heavy_set:
            t = table[c].type
            if pa.types.is_string(t) or pa.types.is_large_string(t):
                s = pd.Series(
                    table[c].cast(pa.large_string())
                    .to_pandas(types_mapper=pd.ArrowDtype)
                )
        if s is None:
            pandas_cols.append(c)
        else:
            out[c] = s
    if pandas_cols:  # non-numeric light columns: pandas types them exactly
        df_light = pd.read_csv(path, encoding=encoding, usecols=pandas_cols)
        if len(df_light) != len(table):
            return None
        for c in pandas_cols:
            out[c] = df_light[c]
    df = pd.DataFrame(out)
    return df[cols]


def read_csv(
    path: Union[str, Path],
    encoding: str = "utf-8-sig",
    heavy: Sequence[str] = (),
) -> pd.DataFrame:
    """``pd.read_csv(path, encoding=...)`` with the named heavy string
    columns routed through pyarrow.csv (3-5x faster parse at 1M rows, Arrow
    buffers land zero-copy in the native scanner). Any surprise — duplicate
    headers, row-count mismatch, pyarrow errors — falls back to pandas."""
    norm = encoding.lower().replace("_", "-")
    if heavy and norm in ("utf-8", "utf-8-sig"):
        try:
            df = _read_fast(path, encoding, heavy)
            if df is not None:
                return df
        except Exception:
            pass
    return pd.read_csv(path, encoding=encoding)


def write_csv(
    df: pd.DataFrame,
    path: Union[str, Path],
    encoding: str = "utf-8-sig",
    index: bool = False,
) -> Path:
    """``df.to_csv(path, index=index, encoding=encoding)`` — native when the
    frame allows it, pandas otherwise; identical bytes either way."""
    path = Path(path)
    norm = encoding.lower().replace("_", "-")
    native_ok = (
        not index
        and os.linesep == "\n"
        and norm in ("utf-8", "utf-8-sig")
        and _write_native(df, path, encoding)
    )
    if not native_ok:
        df.to_csv(path, index=index, encoding=encoding)
    return path

"""Minimal self-contained xlsx reader/writer (no openpyxl dependency).

The reference pipeline moves label maps, split rules, per-category splits and
audit trails through .xlsx files (reference: core/processor.py:531, 687,
809-812, 816-818, 1074). This environment ships no Excel engine, so we
implement the small subset of OOXML SpreadsheetML the pipeline needs:

- multi-sheet workbooks
- string / number / boolean / empty cells (inline strings on write;
  sharedStrings, inlineStr, n, b, str cell types on read)
- DataFrame round-trip with a header row (pandas read_excel/to_excel style)

xlsx is a zip of XML parts; we emit the minimal part set by hand and parse
with xml.etree. Full unicode (CJK labels) supported.
"""

from __future__ import annotations

import re
import zipfile
import xml.etree.ElementTree as ET
from pathlib import Path
from typing import Dict, List, Optional, Union

import math
import pandas as pd

_NS = "{http://schemas.openxmlformats.org/spreadsheetml/2006/main}"
_REL_NS = "{http://schemas.openxmlformats.org/package/2006/relationships}"

# ---------------------------------------------------------------------------
# Writing
# ---------------------------------------------------------------------------

_CONTENT_TYPES_TMPL = (
    '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
    '<Types xmlns="http://schemas.openxmlformats.org/package/2006/content-types">'
    '<Default Extension="rels" ContentType="application/vnd.openxmlformats-package.relationships+xml"/>'
    '<Default Extension="xml" ContentType="application/xml"/>'
    '<Override PartName="/xl/workbook.xml" ContentType="application/vnd.openxmlformats-officedocument.spreadsheetml.sheet.main+xml"/>'
    "{sheet_overrides}"
    "</Types>"
)

_RELS_ROOT = (
    '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
    '<Relationships xmlns="http://schemas.openxmlformats.org/package/2006/relationships">'
    '<Relationship Id="rId1" Type="http://schemas.openxmlformats.org/officeDocument/2006/relationships/officeDocument" Target="xl/workbook.xml"/>'
    "</Relationships>"
)


def _col_letter(idx: int) -> str:
    """0-based column index -> spreadsheet column letters (0 -> A, 26 -> AA)."""
    letters = ""
    idx += 1
    while idx > 0:
        idx, rem = divmod(idx - 1, 26)
        letters = chr(ord("A") + rem) + letters
    return letters


def _xml_escape(text: str) -> str:
    return (
        text.replace("&", "&amp;")
        .replace("<", "&lt;")
        .replace(">", "&gt;")
        .replace('"', "&quot;")
    )


def _cell_xml(ref: str, value) -> str:
    if value is None:
        return ""
    if isinstance(value, float) and math.isnan(value):
        return ""
    if isinstance(value, bool):
        return f'<c r="{ref}" t="b"><v>{1 if value else 0}</v></c>'
    if isinstance(value, (int, float)):
        if isinstance(value, float) and math.isinf(value):
            value = str(value)
        else:
            return f'<c r="{ref}"><v>{value!r}</v></c>'
    text = _xml_escape(str(value))
    # preserve leading/trailing whitespace
    space = ' xml:space="preserve"' if text != text.strip() else ""
    return f'<c r="{ref}" t="inlineStr"><is><t{space}>{text}</t></is></c>'


_WS = " \t\n\r"


def _sheet_xml(df: pd.DataFrame, header: bool = True, index: bool = False) -> str:
    """Row XML for one sheet. The data loop is the datakit's hottest xlsx
    path (1.4M cells in the 50k-row split bench): columns are pulled out of
    pandas ONCE as object arrays (per-cell Arrow __getitem__ costs more than
    the formatting), and the common cell types are formatted inline —
    _cell_xml stays the fallback for exotic values."""
    rows: List[str] = []
    out_cols: List = []
    if index:
        nlev = df.index.nlevels
        for lev in range(nlev):
            out_cols.append(df.index.get_level_values(lev).to_numpy(dtype=object))
    for c in df.columns:
        out_cols.append(df[c].to_numpy(dtype=object))
    r = 1
    if header:
        head = (list(map(str, df.index.names)) if index else []) + [str(c) for c in df.columns]
        if index and head[: df.index.nlevels] == ["None"]:
            head[0] = ""
        cells = [_cell_xml(f"{_col_letter(c)}1", v) for c, v in enumerate(head)]
        rows.append('<row r="1">' + "".join(cells) + "</row>")
        r = 2
    letters = [_col_letter(c) for c in range(len(out_cols))]
    n = len(df)
    rs = [str(r + i) for i in range(n)]  # shared row-number strings
    # column-major: one comprehension per column (conditional expressions,
    # no per-cell function dispatch); rows assembled by zipping the columns
    col_cells = []
    for L, col in zip(letters, out_cols):
        col_cells.append([
            (
                (
                    f'<c r="{L}{R}" t="inlineStr"><is><t xml:space="preserve">'
                    f'{_xml_escape(v) if ("&" in v or "<" in v or ">" in v or chr(34) in v) else v}</t></is></c>'
                    if v and (v[0] in _WS or v[-1] in _WS)
                    else f'<c r="{L}{R}" t="inlineStr"><is><t>'
                    f'{_xml_escape(v) if ("&" in v or "<" in v or ">" in v or chr(34) in v) else v}</t></is></c>'
                )
                if type(v) is str
                else ""
                if v is None or v != v  # None / NaN
                else f'<c r="{L}{R}"><v>{v!r}</v></c>'
                if type(v) is int or (type(v) is float and not math.isinf(v))
                else _cell_xml(f"{L}{R}", v)
            )
            for R, v in zip(rs, col)
        ])
    if col_cells:
        rows.extend(
            f'<row r="{R}">{"".join(cells)}</row>'
            for R, cells in zip(rs, zip(*col_cells))
        )
    else:  # zero-column frame: keep the empty row tags
        rows.extend(f'<row r="{R}"></row>' for R in rs)
    return (
        '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
        '<worksheet xmlns="http://schemas.openxmlformats.org/spreadsheetml/2006/main">'
        "<sheetData>" + "".join(rows) + "</sheetData></worksheet>"
    )


def _native_col_spec(values, letter: str, row_strs: List[str]):
    """Classify one output column for the native sheet writer.

    Returns (spec_dict, keepalive_list). Exact-parity rules with the Python
    cell formatter decide the kind (shared classifier: utils/colspec.py);
    anything exotic (mixed types, numpy scalars in object cells, timestamps)
    renders per-cell in Python and ships as a pre-rendered RAW column.
    """
    import numpy as np

    from ..runtime import XLSX_BOOL, XLSX_F64, XLSX_I64, XLSX_RAW
    from .colspec import _EMPTY_BLOB, _addr_of, arrow_col_spec

    def raw_spec(cells):
        enc = [
            _cell_xml(f"{letter}{R}", v).encode("utf-8")
            for R, v in zip(row_strs, cells)
        ]
        off = np.zeros(len(enc) + 1, np.int64)
        np.cumsum([len(e) for e in enc], out=off[1:])
        blob = b"".join(enc) or _EMPTY_BLOB
        return (
            {"kind": XLSX_RAW, "blob": _addr_of(blob), "off": off.ctypes.data},
            [blob, off],
        )

    obj = None  # object ndarray view, materialized only when needed
    if isinstance(values, pd.Series):
        dt = values.dtype
        # plain-numpy fast paths (no nulls possible / NaN self-describes).
        # NOTE: these deliberately differ from csvio's — the xlsx cell
        # formatter widens float32 to Python-float repr; to_csv does not.
        if dt == bool:
            return {"kind": XLSX_BOOL, "i64": values.to_numpy().astype(np.int64)}, []
        if isinstance(dt, np.dtype) and dt.kind in "iu":
            v = values.to_numpy()
            if dt.kind == "u" and v.size and v.max() > np.iinfo(np.int64).max:
                return raw_spec(values.to_numpy(dtype=object))  # would wrap
            return {"kind": XLSX_I64, "i64": v.astype(np.int64)}, []
        if isinstance(dt, np.dtype) and dt.kind == "f":
            return {"kind": XLSX_F64, "f64": values.to_numpy(np.float64)}, []
        # a typed (non-object) pandas dtype guarantees cell types; object
        # columns must be verified cell-by-cell for formatter parity
        trusted = not (isinstance(dt, np.dtype) and dt == object)
        if not trusted:
            obj = values.to_numpy(dtype=object)
    else:  # plain object ndarray
        obj = values
        trusted = False

    r = arrow_col_spec(values if isinstance(values, pd.Series) else None,
                       obj=obj, trusted=trusted)
    if r is not None:
        return r
    return raw_spec(obj if obj is not None else values.to_numpy(dtype=object))


def _sheet_part(df: pd.DataFrame, header: bool = True, index: bool = False,
                consume=None):
    """Worksheet XML: native writer when available, Python fallback.

    Without ``consume``: returns the XML bytes. With ``consume``: delivers
    the XML to ``consume(data)`` — the native path hands over a zero-copy
    memoryview of the C buffer (freed after the call) — and returns None.
    Errors from ``consume`` itself propagate (never double-delivered).
    """
    from ..runtime import sheet_xml_native

    buf = None
    try:
        n = len(df)
        first_row = 2 if header else 1
        header_xml = b""
        if header:
            head = (list(map(str, df.index.names)) if index else []) + [
                str(c) for c in df.columns
            ]
            if index and head[: df.index.nlevels] == ["None"]:
                head[0] = ""
            cells = [_cell_xml(f"{_col_letter(c)}1", v) for c, v in enumerate(head)]
            header_xml = ('<row r="1">' + "".join(cells) + "</row>").encode("utf-8")
        series: List = []
        if index:
            for lev in range(df.index.nlevels):
                series.append(pd.Series(df.index.get_level_values(lev)))
        for c in df.columns:
            series.append(df[c])
        row_strs = [str(first_row + i) for i in range(n)]
        specs, keep = [], []
        for ci, s in enumerate(series):
            spec, ka = _native_col_spec(s, _col_letter(ci), row_strs)
            specs.append(spec)
            keep.extend(ka)
        buf = sheet_xml_native(n, specs, header_xml, first_row, raw=True)
        del keep
    except Exception:
        buf = None
    if buf is not None:
        try:
            if consume is not None:
                consume(buf.view())
                return None
            return bytes(buf.view())
        finally:
            buf.free()
    data = _sheet_xml(df, header=header, index=index).encode("utf-8")
    if consume is not None:
        consume(data)
        return None
    return data


def write_workbook(
    path: Union[str, Path],
    sheets: Dict[str, pd.DataFrame],
    index: bool = False,
) -> Path:
    """Write an xlsx workbook: {sheet_name: DataFrame}."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    names = list(sheets.keys()) or ["Sheet1"]
    if not sheets:
        sheets = {"Sheet1": pd.DataFrame()}

    sheet_overrides = "".join(
        f'<Override PartName="/xl/worksheets/sheet{i + 1}.xml" '
        'ContentType="application/vnd.openxmlformats-officedocument.spreadsheetml.worksheet+xml"/>'
        for i in range(len(names))
    )
    workbook_sheets = "".join(
        f'<sheet name="{_xml_escape(str(n)[:31])}" sheetId="{i + 1}" r:id="rId{i + 1}"/>'
        for i, n in enumerate(names)
    )
    workbook_xml = (
        '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
        '<workbook xmlns="http://schemas.openxmlformats.org/spreadsheetml/2006/main" '
        'xmlns:r="http://schemas.openxmlformats.org/officeDocument/2006/relationships">'
        f"<sheets>{workbook_sheets}</sheets></workbook>"
    )
    workbook_rels = (
        '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
        '<Relationships xmlns="http://schemas.openxmlformats.org/package/2006/relationships">'
        + "".join(
            f'<Relationship Id="rId{i + 1}" '
            'Type="http://schemas.openxmlformats.org/officeDocument/2006/relationships/worksheet" '
            f'Target="worksheets/sheet{i + 1}.xml"/>'
            for i in range(len(names))
        )
        + "</Relationships>"
    )

    # compresslevel 1: ~5x faster deflate for ~15% larger files — these are
    # intermediate pipeline artifacts, not archives
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED, compresslevel=1) as zf:
        zf.writestr(
            "[Content_Types].xml",
            _CONTENT_TYPES_TMPL.format(sheet_overrides=sheet_overrides),
        )
        zf.writestr("_rels/.rels", _RELS_ROOT)
        zf.writestr("xl/workbook.xml", workbook_xml)
        zf.writestr("xl/_rels/workbook.xml.rels", workbook_rels)
        for i, name in enumerate(names):
            # consume path: the native XML part streams into the zip as a
            # memoryview of the C buffer — no whole-part bytes copy
            _sheet_part(
                sheets[name], index=index,
                consume=lambda data, a=f"xl/worksheets/sheet{i + 1}.xml":
                    zf.writestr(a, data),
            )
    return path


class ExcelWriter:
    """pandas.ExcelWriter-style context manager backed by write_workbook."""

    def __init__(self, path: Union[str, Path]):
        self.path = Path(path)
        self._sheets: Dict[str, pd.DataFrame] = {}

    def write(self, df: pd.DataFrame, sheet_name: str = "Sheet1", index: bool = False):
        self._sheets[sheet_name] = df.reset_index() if index else df

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            write_workbook(self.path, self._sheets)
        return False


# ---------------------------------------------------------------------------
# Reading
# ---------------------------------------------------------------------------

_CELL_REF_RE = re.compile(r"([A-Z]+)(\d+)")


def _ref_to_col(ref: str) -> int:
    m = _CELL_REF_RE.match(ref)
    if not m:
        return 0
    col = 0
    for ch in m.group(1):
        col = col * 26 + (ord(ch) - ord("A") + 1)
    return col - 1


def _parse_number(text: str):
    try:
        f = float(text)
    except ValueError:
        return text
    if f.is_integer() and "e" not in text.lower() and "." not in text:
        return int(f)
    return f


def _arrow_text_column(r_out, sp, arena, n_rows):
    """pa.large_string Series for one pure-text column: one vectorized byte
    gather out of the arena into Arrow buffers — no per-cell Python strings
    and no Arrow re-encode in the DataFrame constructor."""
    import numpy as np
    import pyarrow as pa

    lens = (sp[:, 1] - sp[:, 0]).astype(np.int64)
    total = int(lens.sum())
    # gather in bounded chunks: the index arrays cost ~25 transient bytes
    # per payload byte, which at GB-scale columns would dwarf the payload
    parts = []
    CHUNK = 200_000
    for lo in range(0, len(sp), CHUNK):
        sl = slice(lo, lo + CHUNK)
        cl = lens[sl]
        ct = int(cl.sum())
        excl = np.zeros(len(cl), np.int64)
        np.cumsum(cl[:-1], out=excl[1:])
        within = np.arange(ct, dtype=np.int64) - np.repeat(excl, cl)
        parts.append(arena[np.repeat(sp[sl, 0], cl) + within])
    data = np.concatenate(parts) if parts else np.zeros(0, np.uint8)
    row_lens = np.zeros(n_rows, np.int64)
    row_lens[r_out] = lens
    offsets = np.zeros(n_rows + 1, np.int64)
    np.cumsum(row_lens, out=offsets[1:])
    present = np.zeros(n_rows, bool)
    present[r_out] = True
    bufs = [
        None if present.all() else pa.py_buffer(
            np.packbits(present, bitorder="little").tobytes()
        ),
        pa.py_buffer(offsets.tobytes()),
        pa.py_buffer(data.tobytes()),
    ]
    arr = pa.Array.from_buffers(
        pa.large_string(), n_rows, bufs,
        null_count=0 if present.all() else int((~present).sum()),
    )
    return pd.Series(arr.to_pandas(types_mapper=pd.ArrowDtype))


def _df_from_native(parsed, shared: List[str]) -> pd.DataFrame:
    """DataFrame assembly for runtime.sheet_parse_native output — identical
    shape/semantics to the ElementTree path below. Pure-text body columns
    build as Arrow arrays directly (byte gather); everything else goes
    through the object grid + pandas inference exactly like the ET path."""
    import numpy as np

    from ..runtime import (
        SHEET_BOOL, SHEET_INT, SHEET_NUM, SHEET_SHARED, SHEET_TEXT,
    )

    rows, cols, kinds, nums, spans, arena, max_row, max_col = parsed
    if max_row < 0:
        return pd.DataFrame()
    n_body = max_row  # body rows (header is row 0)
    n_cols = max_col + 1
    # column purity over BODY cells: pure-text columns take the Arrow path
    arrow_cols = {}
    if n_body > 0 and n_cols > 0 and len(rows):
        body = rows >= 1
        is_text = kinds == SHEET_TEXT
        text_per_col = np.bincount(cols[body & is_text], minlength=n_cols)
        any_per_col = np.bincount(cols[body], minlength=n_cols)
        # DENSE all-text columns only: absent cells would surface as pd.NA
        # (Arrow null) where the ET path yields NaN — consumers like
        # _read_label_map's astype(str) filter treat those differently
        pure = np.flatnonzero(
            (any_per_col == n_body) & (text_per_col == any_per_col)
        )
        for c in pure.tolist():
            sel = body & (cols == c)
            arrow_cols[c] = _arrow_text_column(
                rows[sel] - 1, spans[sel], arena, n_body
            )
        if arrow_cols:  # the grid below only carries the remaining cells
            keep = ~(body & np.isin(cols, pure))
            rows, cols, kinds, nums, spans = (
                rows[keep], cols[keep], kinds[keep], nums[keep], spans[keep],
            )
    grid = np.full((max_row + 1, max(max_col + 1, 0)), None, dtype=object)
    vals = np.empty(len(rows), dtype=object)
    m = kinds == SHEET_NUM
    vals[m] = nums[m].astype(object)
    m = kinds == SHEET_INT
    if m.any():
        iv = nums[m]
        small = np.abs(iv) < 2 ** 53
        out_i = np.empty(len(iv), dtype=object)
        out_i[small] = iv[small].astype(np.int64).astype(object)
        for k in np.flatnonzero(~small).tolist():  # beyond int64: exact int()
            out_i[k] = int(iv[k])
        vals[m] = out_i
    m = kinds == SHEET_BOOL
    if m.any():  # Python bools (np.bool_ would break _cell_xml round-trips)
        vals[m] = np.array([v == 1.0 for v in nums[m].tolist()], dtype=object)
    m = kinds == SHEET_SHARED
    if m.any():
        vals[m] = np.array(
            [shared[int(i)] for i in nums[m].tolist()], dtype=object
        )
    m = kinds == SHEET_TEXT
    if m.any():
        # decode the whole arena ONCE; per-cell strings are slices at CHAR
        # offsets. Text spans tile the arena contiguously in scan order, so
        # per-span char counts (utf-8 lead bytes, one reduceat) cumsum into
        # the char offsets directly — no per-byte offset table.
        sp_m = spans[m]
        if len(arena):
            big = bytes(arena).decode("utf-8")
            # byte offset -> char offset: subtract the continuation bytes
            # before it (vectorized searchsorted over their positions;
            # np.add.reduceat measured 50x slower here)
            cont = np.flatnonzero((arena & 0xC0) == 0x80)
            cs = sp_m[:, 0] - np.searchsorted(cont, sp_m[:, 0])
            ce = sp_m[:, 1] - np.searchsorted(cont, sp_m[:, 1])
        else:
            big = ""
            cs = ce = np.zeros(len(sp_m), np.int64)
        vals[m] = np.array(
            [big[a:b] for a, b in zip(cs.tolist(), ce.tolist())],
            dtype=object,
        )
    if grid.shape[1]:
        grid[rows, cols] = vals
    header = ["" if v is None else str(v) for v in grid[0]]
    df = pd.DataFrame(grid[1:], columns=header)
    df = df.where(df.notna(), other=float("nan"))
    for c, ser in arrow_cols.items():
        df.isetitem(c, ser)
    return df


def _read_sheet_xml(data: bytes, shared: List[str]) -> pd.DataFrame:
    # native scanner first: ElementTree cannot even parse the GB-sized
    # sheet parts the split step emits at 1M rows (expat "out of memory")
    try:
        from ..runtime import sheet_parse_native

        parsed = sheet_parse_native(data)
        if parsed is not None:
            return _df_from_native(parsed, shared)
    except Exception:
        pass
    root = ET.fromstring(data)
    sheet_data = root.find(f"{_NS}sheetData")
    if sheet_data is None:
        return pd.DataFrame()
    rows: Dict[int, Dict[int, object]] = {}
    max_col = -1
    for row_el in sheet_data.findall(f"{_NS}row"):
        r = int(row_el.get("r", len(rows) + 1)) - 1
        cells: Dict[int, object] = {}
        next_col = 0
        for c_el in row_el.findall(f"{_NS}c"):
            ref = c_el.get("r")
            col = _ref_to_col(ref) if ref else next_col
            next_col = col + 1
            ctype = c_el.get("t", "n")
            value = None
            if ctype == "inlineStr":
                is_el = c_el.find(f"{_NS}is")
                if is_el is not None:
                    value = "".join(t.text or "" for t in is_el.iter(f"{_NS}t"))
            else:
                v_el = c_el.find(f"{_NS}v")
                if v_el is not None and v_el.text is not None:
                    if ctype == "s":
                        value = shared[int(v_el.text)]
                    elif ctype == "b":
                        value = v_el.text == "1"
                    elif ctype == "str":
                        value = v_el.text
                    else:
                        value = _parse_number(v_el.text)
            if value is not None:
                cells[col] = value
                max_col = max(max_col, col)
        rows[r] = cells
    if not rows:
        return pd.DataFrame()
    n_rows = max(rows.keys()) + 1
    table = [[rows.get(r, {}).get(c) for c in range(max_col + 1)] for r in range(n_rows)]
    if not table:
        return pd.DataFrame()
    header = ["" if v is None else str(v) for v in table[0]]
    body = table[1:]
    df = pd.DataFrame(body, columns=header)
    # pandas-read_excel-style: coerce empty cells to NaN
    return df.where(df.notna(), other=float("nan"))


def _read_shared_strings(zf: zipfile.ZipFile) -> List[str]:
    try:
        data = zf.read("xl/sharedStrings.xml")
    except KeyError:
        return []
    root = ET.fromstring(data)
    strings = []
    for si in root.findall(f"{_NS}si"):
        strings.append("".join(t.text or "" for t in si.iter(f"{_NS}t")))
    return strings


def _sheet_targets(zf: zipfile.ZipFile) -> Dict[str, str]:
    """sheet name -> zip member path, in workbook order."""
    wb = ET.fromstring(zf.read("xl/workbook.xml"))
    rels = ET.fromstring(zf.read("xl/_rels/workbook.xml.rels"))
    rid_to_target = {
        rel.get("Id"): rel.get("Target") for rel in rels.findall(f"{_REL_NS}Relationship")
    }
    r_attr = "{http://schemas.openxmlformats.org/officeDocument/2006/relationships}id"
    targets: Dict[str, str] = {}
    for sheet in wb.iter(f"{_NS}sheet"):
        target = rid_to_target.get(sheet.get(r_attr), "")
        if target.startswith("/"):
            target = target.lstrip("/")
        elif not target.startswith("xl/"):
            target = "xl/" + target
        targets[sheet.get("name")] = target
    return targets


def sheet_names(path: Union[str, Path]) -> List[str]:
    with zipfile.ZipFile(path) as zf:
        return list(_sheet_targets(zf).keys())


def read_workbook(
    path: Union[str, Path],
    sheet_name: Optional[Union[str, int]] = 0,
) -> Union[pd.DataFrame, Dict[str, pd.DataFrame]]:
    """Read an xlsx file. sheet_name: int | str | None (None -> dict of all)."""
    with zipfile.ZipFile(path) as zf:
        shared = _read_shared_strings(zf)
        targets = _sheet_targets(zf)
        names = list(targets.keys())
        if sheet_name is None:
            return {n: _read_sheet_xml(zf.read(targets[n]), shared) for n in names}
        if isinstance(sheet_name, int):
            name = names[sheet_name]
        else:
            name = sheet_name
        return _read_sheet_xml(zf.read(targets[name]), shared)


class ExcelFile:
    """pandas.ExcelFile-style shim."""

    def __init__(self, path: Union[str, Path]):
        self.path = Path(path)
        self.sheet_names = sheet_names(path)

    def parse(self, sheet_name=0) -> pd.DataFrame:
        return read_workbook(self.path, sheet_name)


# pandas-flavored aliases used across datakit
read_excel = read_workbook


def to_excel(df: pd.DataFrame, path: Union[str, Path], index: bool = False) -> Path:
    return write_workbook(path, {"Sheet1": df}, index=index)

"""Native runtime layer: C++ helpers loaded via ctypes.

``labelscan`` is a multithreaded, escape-aware JSON scanner that extracts
padded box arrays from whole annotation-string columns in one native pass —
replacing the per-row json.loads of the datakit hot loops. Built on demand
with g++ into the package's ``_build/`` directory, under a name keyed on a
hash of the source and the flags (an edited source builds anew); every
consumer has a pure-Python fallback, so the framework works without a
toolchain. ``DYD_NO_NATIVE`` set to anything non-empty takes the fallbacks.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np

_HERE = Path(__file__).parent
_SRC = _HERE / "labelscan.cpp"
BUILD = _HERE.parent / "_build"
_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17", "-pthread"]
_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_BUILD_FAILED = False


def library_path() -> Path:
    """``_build/liblabelscan-<hash>.so``: the hash covers the source and the
    flags."""
    digest = hashlib.sha256(_SRC.read_bytes())
    digest.update(" ".join(_FLAGS).encode())
    return BUILD / f"liblabelscan-{digest.hexdigest()[:16]}.so"


def _build(target: Path) -> bool:
    """Compile into a temporary file and move it into place: processes that
    build at once never load half a file."""
    try:
        BUILD.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD)
        os.close(fd)
    except OSError:
        return False
    try:
        subprocess.run(["g++", *_FLAGS, str(_SRC), "-o", tmp],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, target)
        return True
    except Exception:
        if os.path.exists(tmp):
            os.unlink(tmp)
        return False


def get_lib() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the native library; None if unavailable."""
    global _LIB, _BUILD_FAILED
    if _LIB is not None:
        return _LIB
    if _BUILD_FAILED or os.environ.get("DYD_NO_NATIVE"):
        return None
    with _LOCK:
        if _LIB is not None:
            return _LIB
        target = library_path()
        if not target.exists() and not _build(target):
            _BUILD_FAILED = True
            return None
        try:
            lib = ctypes.CDLL(str(target))
        except OSError:
            _BUILD_FAILED = True
            return None
        lib.scan_boxes.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int64, ctypes.c_int,
            ctypes.c_int,
            np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
            ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ]
        lib.scan_boxes.restype = None
        lib.count_ann.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int64,
            np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
            ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ]
        lib.count_ann.restype = None
        lib.scan_ann.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int64,
            np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
            ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ]
        lib.scan_ann.restype = None
        lib.rewrite_ptlists_rows.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int64,
            np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
            ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ]
        lib.rewrite_ptlists_rows.restype = None
        lib.splice_items2.argtypes = [
            ctypes.POINTER(ctypes.c_char_p),
            np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
            ctypes.c_int64,
            np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
            ctypes.c_char_p,
            np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
            ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ]
        lib.splice_items2.restype = None
        lib.match_predictions.argtypes = [
            np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
            ctypes.c_int64,
            np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
            ctypes.c_int64,
            np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
            ctypes.c_int,
            np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
        ]
        lib.match_predictions.restype = None
        _pp = ctypes.POINTER(ctypes.c_void_p)
        lib.sheet_xml.argtypes = [
            ctypes.c_int64, ctypes.c_int32,
            np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
            _pp, _pp, _pp, _pp, _pp,
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int64),
        ]
        lib.sheet_xml.restype = None
        lib.csv_write.argtypes = [
            ctypes.c_int64, ctypes.c_int32,
            np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
            _pp, _pp, _pp, _pp, _pp,
            ctypes.c_char_p, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int64),
        ]
        lib.csv_write.restype = None
        lib.buf_free.argtypes = [ctypes.c_void_p]
        lib.buf_free.restype = None
        _i64p = ctypes.POINTER(ctypes.c_int64)
        lib.sheet_parse_count.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, _i64p, _i64p, _i64p, _i64p,
        ]
        lib.sheet_parse_count.restype = ctypes.c_int
        lib.sheet_parse_fill.argtypes = [
            ctypes.c_char_p, ctypes.c_int64,
            np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
            _i64p, _i64p,
        ]
        lib.sheet_parse_fill.restype = ctypes.c_int
        _LIB = lib
        return _LIB


class BlobRows:
    """Zero-copy row source: one utf-8 blob + int64 offsets[n+1] (+ optional
    validity bytes) — the buffer layout of an Arrow string column. Acts as a
    sequence of per-row bytes (None for nulls) for the Python fallback
    paths; the native entry points consume the buffers directly, so a pandas
    string column reaches C++ without any per-row Python objects."""

    __slots__ = ("n", "addr", "off", "valid", "_mv", "_keep")

    def __init__(self, n, addr, off, valid, mv, keep):
        self.n = n
        self.addr = addr
        self.off = off          # int64 ndarray view, len n+1
        self.valid = valid      # uint8 ndarray or None (all valid)
        self._mv = mv           # memoryview over the blob
        self._keep = keep

    @classmethod
    def from_arrow(cls, arr):
        """Build from a pyarrow large_binary/large_string Array (offset 0)."""
        bufs = arr.buffers()  # [validity, offsets(int64 x n+1), data]
        n = len(arr)
        off = np.frombuffer(bufs[1], dtype=np.int64, count=n + 1)
        valid = None
        if arr.null_count:
            valid = arr.is_valid().to_numpy(zero_copy_only=False).astype(np.uint8)
        data = bufs[2]
        if data is None:
            empty = b"\x00"
            mv = memoryview(empty)
            addr = ctypes.cast(empty, ctypes.c_void_p).value
            keep = [arr, bufs, empty]
        else:
            mv = memoryview(data)
            addr = data.address
            keep = [arr, bufs]
        return cls(n, addr, off, valid, mv, keep)

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        if self.valid is not None and not self.valid[i]:
            return None
        return bytes(self._mv[int(self.off[i]):int(self.off[i + 1])])

    def __iter__(self):
        off = self.off.tolist()
        if self.valid is None:
            for i in range(self.n):
                yield bytes(self._mv[off[i]:off[i + 1]])
        else:
            va = self.valid
            for i in range(self.n):
                yield bytes(self._mv[off[i]:off[i + 1]]) if va[i] else None

    def row_lengths(self) -> np.ndarray:
        lens = np.diff(self.off)
        if self.valid is not None:
            lens = np.where(self.valid.astype(bool), lens, 0)
        return lens


def _row_src(rows):
    """(char** | None, blob addr, offsets addr, valid addr, keepalive) —
    the trailing (rows, blob, boff, bvalid) arguments of the native entry
    points, from either a BlobRows or a list of bytes/None."""
    if isinstance(rows, BlobRows):
        boff = np.ascontiguousarray(rows.off, np.int64)
        keep = [rows, boff]
        bvalid = None
        if rows.valid is not None:
            bvalid = np.ascontiguousarray(rows.valid, np.uint8)
            keep.append(bvalid)
        return (
            None, ctypes.c_void_p(rows.addr),
            ctypes.c_void_p(boff.ctypes.data),
            ctypes.c_void_p(bvalid.ctypes.data) if bvalid is not None else None,
            keep,
        )
    n = len(rows)
    arr = (ctypes.c_char_p * max(n, 1))(*rows)
    return arr, None, None, None, [arr, rows]


def _row_lengths(rows) -> np.ndarray:
    if isinstance(rows, BlobRows):
        return rows.row_lengths()
    return np.array([len(e) if e else 0 for e in rows], np.int64)


def scan_boxes_native(
    rows: Sequence,
    two_point_only: bool,
    max_boxes: int = 64,
    n_threads: Optional[int] = None,
    pre_encoded: bool = False,
) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]]:
    """Extract (boxes (N,M,4) f32, mask (N,M) bool, counts (N,), wh (N,2))
    from a column of annotation JSON strings (list, or BlobRows for the
    zero-copy Arrow path). None if native lib unavailable.

    two_point_only=True reproduces the IoU-filter extraction (exactly-2-point
    ptLists only); False gives poly->bbox min/max semantics.
    """
    lib = get_lib()
    if lib is None:
        return None
    n = len(rows)
    if isinstance(rows, BlobRows) or pre_encoded:
        encoded = rows
    else:
        encoded = [
            (r.encode("utf-8") if isinstance(r, str) else None) for r in rows
        ]
    arr, blob, boff, bvalid, keep = _row_src(encoded)
    out_boxes = np.zeros((n, max_boxes, 4), np.float32)
    out_mask = np.zeros((n, max_boxes), np.uint8)
    out_counts = np.zeros((n,), np.int32)
    out_wh = np.zeros((n, 2), np.float32)
    if n_threads is None:
        n_threads = min(os.cpu_count() or 1, 16)
    lib.scan_boxes(
        arr, n, int(two_point_only), max_boxes,
        out_boxes, out_mask, out_counts, out_wh, n_threads,
        blob, boff, bvalid,
    )
    del keep
    return out_boxes, out_mask.astype(bool), out_counts, out_wh


def rewrite_ptlists_native(
    encoded: Sequence,
    do_row: np.ndarray,
    obj_offsets: np.ndarray,
    obj_i32: np.ndarray,
    obj_box: np.ndarray,
    n_threads: Optional[int] = None,
) -> Optional[list]:
    """Step-4 applier: per-row rewritten cell text (None where do_row is
    False / the native lib is unavailable). Inputs are scan_annotations_native
    outputs; splice + Python-repr number semantics live in C++
    (labelscan.cpp::rewrite_ptlists_rows)."""
    lib = get_lib()
    if lib is None:
        return None
    n = len(encoded)
    if n == 0:
        return []
    arr, blob, boff, bvalid, keep = _row_src(encoded)
    if isinstance(encoded, BlobRows):
        not_null = (
            encoded.valid.astype(bool) if encoded.valid is not None
            else np.ones(n, bool)
        )
    else:
        not_null = np.array([e is not None for e in encoded], bool)
    do8 = np.ascontiguousarray(np.asarray(do_row, bool) & not_null, np.uint8)
    row_len = _row_lengths(encoded)
    nobj = np.diff(obj_offsets)
    # per-object growth bound: bbox text <=131 B + insert scaffolding <=25 B
    cap_off = np.zeros(n + 1, np.int64)
    np.cumsum(row_len + 160 * nobj + 8, out=cap_off[1:])
    out = np.zeros(max(int(cap_off[-1]), 1), np.uint8)
    out_len = np.full(n, -1, np.int64)
    if n_threads is None:
        n_threads = min(os.cpu_count() or 1, 16)
    lib.rewrite_ptlists_rows(
        arr, n, do8, np.ascontiguousarray(obj_offsets, np.int64),
        np.ascontiguousarray(obj_i32, np.int32).reshape(-1),
        np.ascontiguousarray(obj_box, np.float64).reshape(-1),
        out, cap_off, out_len, n_threads, blob, boff, bvalid,
    )
    del keep
    # decode straight out of the arena: a memoryview slice per row instead of
    # one tobytes() copy of the whole (possibly GB-sized) output buffer
    mv = memoryview(out)
    offs = cap_off.tolist()
    return [
        str(mv[offs[i]:offs[i] + ln], "utf-8") if ln >= 0 else None
        for i, ln in enumerate(out_len.tolist())
    ]


def match_predictions_native(
    pred_boxes: np.ndarray, pred_cls: np.ndarray,
    gt_boxes: np.ndarray, gt_cls: np.ndarray,
    thresholds: np.ndarray,
) -> Optional[np.ndarray]:
    """(n_pred, T) bool TP matrix, bit-identical to the numpy reference in
    train/metrics.py (same pair order + stable-desc tie rule). None when the
    native lib is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    p = np.ascontiguousarray(pred_boxes, np.float32).reshape(-1, 4)
    g = np.ascontiguousarray(gt_boxes, np.float32).reshape(-1, 4)
    pc = np.ascontiguousarray(pred_cls, np.int32).reshape(-1)
    gc = np.ascontiguousarray(gt_cls, np.int32).reshape(-1)
    thr = np.ascontiguousarray(thresholds, np.float32).reshape(-1)
    out = np.zeros((len(p), len(thr)), np.uint8)
    lib.match_predictions(
        p.reshape(-1), pc, len(p), g.reshape(-1), gc, len(g), thr,
        len(thr), out.reshape(-1),
    )
    return out.astype(bool)


def splice_items2_native(
    encoded: Sequence,
    item_row: np.ndarray,
    edit_off: np.ndarray,
    edit_s: np.ndarray,
    edit_e: np.ndarray,
    rep: bytes,
    rep_s: np.ndarray,
    rep_len: np.ndarray,
    n_threads: Optional[int] = None,
) -> Optional[list]:
    """splice_items with explicit per-edit replacement spans (rep_s/rep_len
    into one shared blob): repeated replacement texts are stored once. Same
    return contract as splice_items_native."""
    lib = get_lib()
    if lib is None:
        return None
    n_items = len(item_row)
    if n_items == 0:
        return []
    arr, blob, boff, bvalid, keep = _row_src(encoded)
    item_row = np.ascontiguousarray(item_row, np.int64)
    edit_off = np.ascontiguousarray(edit_off, np.int64)
    edit_s = np.ascontiguousarray(edit_s, np.int64)
    edit_e = np.ascontiguousarray(edit_e, np.int64)
    rep_s = np.ascontiguousarray(rep_s, np.int64)
    rep_len = np.ascontiguousarray(rep_len, np.int64)
    row_len = _row_lengths(encoded)
    rl_cum = np.zeros(len(rep_len) + 1, np.int64)
    np.cumsum(rep_len, out=rl_cum[1:])
    item_rep = rl_cum[edit_off[1:]] - rl_cum[edit_off[:-1]]
    cap = row_len[item_row] + item_rep + 8  # removals only shrink
    cap_off = np.zeros(n_items + 1, np.int64)
    np.cumsum(cap, out=cap_off[1:])
    out = np.zeros(max(int(cap_off[-1]), 1), np.uint8)
    out_len = np.full(n_items, -1, np.int64)
    if n_threads is None:
        n_threads = min(os.cpu_count() or 1, 16)
    lib.splice_items2(
        arr, item_row, n_items, edit_off, edit_s, edit_e, rep, rep_s, rep_len,
        out, cap_off, out_len, n_threads, blob, boff, bvalid,
    )
    del keep
    mv = memoryview(out)
    offs = cap_off.tolist()
    return [
        str(mv[offs[k]:offs[k] + ln], "utf-8") if ln >= 0 else None
        for k, ln in enumerate(out_len.tolist())
    ]


# cell kinds emitted by sheet_parse (labelscan.cpp xlsxr::CK_*)
SHEET_TEXT, SHEET_NUM, SHEET_INT, SHEET_BOOL, SHEET_SHARED = 1, 2, 3, 4, 5


def sheet_parse_native(data: bytes):
    """Two-pass scan of one worksheet XML part (the SpreadsheetML subset
    this package writes). Returns ``(cell_row, cell_col, cell_kind,
    cell_num, str_off, arena_bytes, max_row, max_col)`` or None when the
    native lib is unavailable / the XML uses constructs outside the subset
    (caller falls back to ElementTree)."""
    lib = get_lib()
    if lib is None:
        return None
    n_cells = ctypes.c_int64()
    max_row = ctypes.c_int64()
    max_col = ctypes.c_int64()
    str_bytes = ctypes.c_int64()
    if lib.sheet_parse_count(
        data, len(data), ctypes.byref(n_cells), ctypes.byref(max_row),
        ctypes.byref(max_col), ctypes.byref(str_bytes),
    ) != 0:
        return None
    n = int(n_cells.value)
    cell_row = np.zeros(max(n, 1), np.int64)
    cell_col = np.zeros(max(n, 1), np.int32)
    cell_kind = np.zeros(max(n, 1), np.uint8)
    cell_num = np.zeros(max(n, 1), np.float64)
    str_off = np.zeros(max(n, 1) * 2, np.int64)
    arena = np.zeros(max(int(str_bytes.value), 1), np.uint8)
    n2 = ctypes.c_int64()
    arena_len = ctypes.c_int64()
    if lib.sheet_parse_fill(
        data, len(data), cell_row, cell_col, cell_kind, cell_num, str_off,
        arena, ctypes.byref(n2), ctypes.byref(arena_len),
    ) != 0 or int(n2.value) != n:
        return None
    return (
        cell_row[:n], cell_col[:n], cell_kind[:n], cell_num[:n],
        str_off[: 2 * n].reshape(-1, 2), arena[: int(arena_len.value)],
        int(max_row.value), int(max_col.value),
    )


# column kinds for sheet_xml_native (must match labelscan.cpp::sheet_xml);
# NUMOBJ (mixed int/float object column) is csv_write-only
XLSX_STR, XLSX_F64, XLSX_I64, XLSX_BOOL, XLSX_RAW, CSV_NUMOBJ = 0, 1, 2, 3, 4, 5


def _marshal_col_specs(col_specs: Sequence[dict]):
    """Pack column specs (see sheet_xml_native) into the 5 parallel pointer
    arrays the native writers take. Returns (kinds, ptr arrays..., keepalive).
    """
    ncols = len(col_specs)
    kinds = np.zeros(max(ncols, 1), np.uint8)
    blob_p = (ctypes.c_void_p * max(ncols, 1))()
    off_p = (ctypes.c_void_p * max(ncols, 1))()
    valid_p = (ctypes.c_void_p * max(ncols, 1))()
    f64_p = (ctypes.c_void_p * max(ncols, 1))()
    i64_p = (ctypes.c_void_p * max(ncols, 1))()
    keep = []  # keep ndarray refs alive through the call
    for c, spec in enumerate(col_specs):
        kinds[c] = spec["kind"]
        if spec.get("blob") is not None:
            blob_p[c] = spec["blob"]
            off_p[c] = spec["off"]
        va = spec.get("valid")
        if va is not None:
            va = np.ascontiguousarray(va, np.uint8)
            keep.append(va)
            valid_p[c] = va.ctypes.data
        fa = spec.get("f64")
        if fa is not None:
            fa = np.ascontiguousarray(fa, np.float64)
            keep.append(fa)
            f64_p[c] = fa.ctypes.data
        ia = spec.get("i64")
        if ia is not None:
            ia = np.ascontiguousarray(ia, np.int64)
            keep.append(ia)
            i64_p[c] = ia.ctypes.data
    return kinds, blob_p, off_p, valid_p, f64_p, i64_p, keep


class NativeBuf:
    """Owner of a C-allocated buffer: zero-copy ``view()`` + explicit
    ``free()`` (also freed on GC). Lets big native outputs (worksheet XML
    parts) flow into their sink without the ``ctypes.string_at`` full copy
    — 15.6 s of the 1M-row s6 profile (round 4)."""

    def __init__(self, lib, ptr, length: int):
        self._lib, self._ptr, self._len = lib, ptr, length

    def __len__(self) -> int:
        return self._len

    def view(self) -> memoryview:
        arr = (ctypes.c_char * self._len).from_address(self._ptr.value)
        return memoryview(arr).cast("B")

    def free(self):
        if self._ptr is not None and self._ptr.value:
            self._lib.buf_free(self._ptr)
        self._ptr = None

    def __del__(self):
        try:
            self.free()
        except Exception:
            pass


def sheet_xml_native(
    nrows: int,
    col_specs: Sequence[dict],
    header: bytes,
    first_row: int,
    raw: bool = False,
):
    """Emit a whole worksheet XML part natively (labelscan.cpp::sheet_xml).

    Each col spec is a dict with ``kind`` (XLSX_*) plus, by kind:
    - str/raw: ``blob`` (int address of utf-8 bytes), ``off`` (int address of
      int64 offsets[nrows+1]); the caller keeps the owning buffers alive.
    - f64: ``f64`` float64 ndarray (NaN = empty cell).
    - i64/bool: ``i64`` int64 ndarray.
    Any kind may carry ``valid`` (uint8 ndarray; 0 = empty cell).
    Returns the XML bytes (or, with ``raw=True``, a NativeBuf the caller
    must free), or None when the native lib is unavailable.
    """
    lib = get_lib()
    if lib is None:
        return None
    kinds, blob_p, off_p, valid_p, f64_p, i64_p, keep = _marshal_col_specs(col_specs)
    out_ptr = ctypes.c_void_p()
    out_len = ctypes.c_int64()
    lib.sheet_xml(
        nrows, len(col_specs), kinds, blob_p, off_p, valid_p, f64_p, i64_p,
        header, len(header), first_row,
        ctypes.byref(out_ptr), ctypes.byref(out_len),
    )
    del keep
    if not out_ptr.value or out_len.value < 0:  # allocation failed
        return None
    buf = NativeBuf(lib, out_ptr, out_len.value)
    if raw:
        return buf
    try:
        return bytes(buf.view())
    finally:
        buf.free()


def csv_write_native(
    nrows: int,
    col_specs: Sequence[dict],
    header: bytes,
    sink,
) -> bool:
    """Write the CSV body (labelscan.cpp::csv_write — pandas to_csv parity on
    str/f64/i64/bool columns) into the binary file object ``sink`` without an
    intermediate Python bytes copy. False when the native lib is unavailable.
    """
    lib = get_lib()
    if lib is None:
        return False
    kinds, blob_p, off_p, valid_p, f64_p, i64_p, keep = _marshal_col_specs(col_specs)
    out_ptr = ctypes.c_void_p()
    out_len = ctypes.c_int64()
    lib.csv_write(
        nrows, len(col_specs), kinds, blob_p, off_p, valid_p, f64_p, i64_p,
        header, len(header), ctypes.byref(out_ptr), ctypes.byref(out_len),
    )
    if not out_ptr.value or out_len.value < 0:  # allocation failed
        del keep
        return False
    try:
        if out_len.value:
            buf = (ctypes.c_char * out_len.value).from_address(out_ptr.value)
            sink.write(memoryview(buf))
        return True
    finally:
        lib.buf_free(out_ptr)
        del keep


def scan_annotations_native(
    rows: Sequence, n_threads: Optional[int] = None, pre_encoded: bool = False
):
    """Structural scan of an annotation-JSON string column.

    Returns the raw columnar parse (see datakit.columnar.AnnTable for the
    high-level wrapper) or None when the native library is unavailable:

    ``(encoded, row_i32, row_wh, obj_offsets, obj_i32, obj_box, name_pos,
    arena_bytes)``

    - encoded: per-row utf-8 bytes (None for non-string cells) — byte spans
      in the other arrays index into these.
    - row_i32 (n,6): status, objects_kind, row_flags, objects_s, objects_e, 0.
      status: 0 null, 1 ok, 2 invalid JSON, 3 valid JSON but not an object.
    - row_wh (n,2) f64: width/height (NaN when absent/non-numeric).
    - obj_i32 (m,12): obj_s, obj_e, name_s, name_e, ptlist_s, ptlist_e,
      poly_s, poly_e, npts, flags, name_len, 0.
    - obj_box (m,4) f64: polygon coordinate extents (valid iff flags bit 2).
    - name_pos (m,2) int64: span into arena_bytes (unescaped UTF-8 names).
    """
    lib = get_lib()
    if lib is None:
        return None
    n = len(rows)
    if isinstance(rows, BlobRows) or pre_encoded:
        encoded = rows
    else:
        encoded = [
            (r.encode("utf-8") if isinstance(r, str) else None) for r in rows
        ]
    if n_threads is None:
        n_threads = min(os.cpu_count() or 1, 16)
    arr, blob, boff, bvalid, keep = _row_src(encoded)
    nobj = np.zeros(max(n, 1), np.int32)
    name_bytes = np.zeros(max(n, 1), np.int64)
    lib.count_ann(arr, n, nobj, name_bytes, n_threads, blob, boff, bvalid)
    obj_offsets = np.zeros(n + 1, np.int64)
    name_off = np.zeros(n + 1, np.int64)
    if n:
        np.cumsum(nobj[:n], out=obj_offsets[1:])
        np.cumsum(name_bytes[:n], out=name_off[1:])
    m = int(obj_offsets[-1])
    row_i32 = np.zeros((max(n, 1), 6), np.int32)
    row_wh = np.zeros((max(n, 1), 2), np.float64)
    obj_i32 = np.zeros((max(m, 1), 12), np.int32)
    obj_box = np.zeros((max(m, 1), 4), np.float64)
    name_pos = np.zeros((max(m, 1), 2), np.int64)
    arena = np.zeros(max(int(name_off[-1]), 1), np.uint8)
    lib.scan_ann(
        arr, n, obj_offsets, name_off, row_i32.reshape(-1),
        row_wh.reshape(-1), obj_i32.reshape(-1), obj_box.reshape(-1),
        name_pos.reshape(-1), arena, n_threads, blob, boff, bvalid,
    )
    del keep
    return (
        encoded, row_i32[:n], row_wh[:n], obj_offsets, obj_i32[:m],
        obj_box[:m], name_pos[:m], arena.tobytes(),
    )

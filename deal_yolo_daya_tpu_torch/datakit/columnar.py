"""Columnar annotation table + splice-based JSON rewriting.

The datakit steps operate on whole annotation-JSON string columns. This
module turns such a column into an ``AnnTable`` — flat numpy arrays over all
objects (names, polygon extents, parse status) — in one native pass
(runtime.scan_annotations_native), then *rewrites* cells by splicing
replacement bytes into recorded spans instead of json.loads/json.dumps
round-trips. Steps express their work as vectorized ops over the table plus
small per-changed-cell splices.

Reference behaviors covered (file:line into the reference project):
- poly->bbox rewrite: core/processor.py:252-260, 283 (each object's
  polygon.ptList becomes its 2-point axis-aligned bbox; width/height lifted
  to columns).
- label-token semantics: core/utils.py:635-679 (split on [,，;；|],
  dedup+sort on replacement).
- row explosion for the split step: core/processor.py:741-775 (one
  single-object row per (object, label)).

A pure-Python fallback (no g++) builds the same table without byte spans;
appliers then fall back to per-cell json round-trips with identical
semantics. Rows whose cells need structural changes a splice can't express
(e.g. dropping non-dict ``objects`` entries, which the reference's
re-serialization does implicitly) are routed through the same fallback
rewriter even when the native path is on.
"""

from __future__ import annotations

import json
import math
from dataclasses import dataclass, field
from typing import List, Optional, Sequence

import numpy as np

from ..runtime import scan_annotations_native

# Row status codes (match labelscan.cpp ann::ROW_*)
ROW_NULL = 0
ROW_OK = 1
ROW_INVALID = 2
ROW_NON_OBJECT = 3

# Object flags (match labelscan.cpp ann::F_*)
F_NAME_KIND_MASK = 0x3  # 0 absent, 1 string, 2 null, 3 other
F_BBOX_OK = 1 << 2
F_TWOPT_OK = 1 << 3
F_HAS_POLY = 1 << 4
F_HAS_PTLIST = 1 << 5
F_POLY_EMPTY = 1 << 6
F_OBJ_EMPTY = 1 << 7
F_POLY_IS_OBJ = 1 << 8
F_PTLIST_IS_ARR = 1 << 9

RF_NONDICT_OBJECTS = 1

_SPAN_COLS = dict(
    obj_s=0, obj_e=1, name_s=2, name_e=3, ptlist_s=4, ptlist_e=5,
    poly_s=6, poly_e=7,
)


@dataclass
class AnnTable:
    """Columnar view of an annotation-JSON string column.

    Object arrays are flat over all rows; ``obj_offsets`` (CSR) and
    ``obj_row`` map objects back to rows. ``spans`` holds byte offsets into
    ``raw[obj_row[j]]`` and is only valid when ``native`` is True.
    """

    n: int
    raw: List[Optional[bytes]]          # utf-8 cell bytes (None = non-string)
    status: np.ndarray                  # (n,) uint8
    objects_kind: np.ndarray            # (n,) uint8: 0 absent, 1 list, 2 other
    row_flags: np.ndarray               # (n,) uint8
    wh: np.ndarray                      # (n,2) f64, NaN = absent
    obj_offsets: np.ndarray             # (n+1,) int64
    obj_row: np.ndarray                 # (m,) int64
    names: list                         # (m,) str | None
    name_kind: np.ndarray               # (m,) uint8
    flags: np.ndarray                   # (m,) int32
    box: np.ndarray                     # (m,4) f64 polygon extents
    npts: np.ndarray                    # (m,) int32
    native: bool
    spans: Optional[np.ndarray] = None  # (m,12) int32 (native only)
    objects_span: Optional[np.ndarray] = None  # (n,2) int32 (native only)
    _nondict_rows: set = field(default_factory=set)

    @property
    def m(self) -> int:
        return len(self.names)

    def bbox_ok(self) -> np.ndarray:
        return (self.flags & F_BBOX_OK) != 0

    def twopt_ok(self) -> np.ndarray:
        return (self.flags & F_TWOPT_OK) != 0

    def row_needs_fallback(self, i: int) -> bool:
        """True when cell i's rewrite can't be expressed as a splice."""
        return (not self.native) or bool(self.row_flags[i] & RF_NONDICT_OBJECTS)


def _num(v) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool)


def canon_num(v: float):
    """Integral floats become ints (json text '10', matching int inputs)."""
    if isinstance(v, float) and math.isfinite(v) and v == int(v) and abs(v) < 2**53:
        return int(v)
    return v


def fmt_num(v: float) -> str:
    if math.isnan(v):
        return "NaN"
    if math.isinf(v):
        return "Infinity" if v > 0 else "-Infinity"
    c = canon_num(float(v))
    return str(c) if isinstance(c, int) else repr(c)


def bbox_ptlist_points(box, ok: bool) -> list:
    """2-point bbox as point dicts (nulls when no valid coordinates)."""
    if not ok:
        return [{"x": None, "y": None}, {"x": None, "y": None}]
    x1, y1, x2, y2 = (canon_num(float(v)) for v in box)
    return [{"x": x1, "y": y1}, {"x": x2, "y": y2}]


def bbox_ptlist_text(box, ok: bool) -> bytes:
    if not ok:
        return b'[{"x": null, "y": null}, {"x": null, "y": null}]'
    x1, y1, x2, y2 = (fmt_num(float(v)) for v in box)
    return (
        '[{"x": %s, "y": %s}, {"x": %s, "y": %s}]' % (x1, y1, x2, y2)
    ).encode("utf-8")


def splice(raw: bytes, edits) -> bytes:
    """Apply non-overlapping (start, end, replacement) byte edits in order."""
    parts = []
    pos = 0
    for s, e, rep in sorted(edits):
        parts.append(raw[pos:s])
        parts.append(rep)
        pos = e
    parts.append(raw[pos:])
    return b"".join(parts)


def _py_bbox_and_flags(ptlist):
    """Polygon extents over numeric coordinates (scanner semantics)."""
    if not isinstance(ptlist, list):
        return (0.0, 0.0, 0.0, 0.0), False, 0, False
    xs, ys = [], []
    ncomplete = 0
    for p in ptlist:
        if not isinstance(p, dict):
            continue
        px, py = p.get("x"), p.get("y")
        hx, hy = _num(px), _num(py)
        if hx:
            xs.append(float(px))
        if hy:
            ys.append(float(py))
        if hx and hy:
            ncomplete += 1
    ok = bool(xs and ys)
    box = (min(xs), min(ys), max(xs), max(ys)) if ok else (0.0, 0.0, 0.0, 0.0)
    twopt = len(ptlist) == 2 and ncomplete == 2
    return box, ok, len(ptlist), twopt


def _py_scan(rows: Sequence) -> AnnTable:
    """json.loads-based fallback producing a span-less AnnTable."""
    n = len(rows)
    raw = [r.encode("utf-8") if isinstance(r, str) else None for r in rows]
    status = np.zeros(n, np.uint8)
    kinds = np.zeros(n, np.uint8)
    rflags = np.zeros(n, np.uint8)
    wh = np.full((n, 2), np.nan, np.float64)
    counts = np.zeros(n, np.int64)
    names: list = []
    name_kind: list = []
    oflags: list = []
    boxes: list = []
    npts: list = []
    obj_row: list = []
    for i, r in enumerate(rows):
        if not isinstance(r, str):
            status[i] = ROW_NULL
            continue
        try:
            data = json.loads(r)
        except Exception:
            status[i] = ROW_INVALID
            continue
        if not isinstance(data, dict):
            status[i] = ROW_NON_OBJECT
            continue
        status[i] = ROW_OK
        if _num(data.get("width")):
            wh[i, 0] = float(data["width"])
        if _num(data.get("height")):
            wh[i, 1] = float(data["height"])
        objs = data.get("objects")
        if objs is None and "objects" not in data:
            kinds[i] = 0
            continue
        if not isinstance(objs, list):
            kinds[i] = 2
            continue
        kinds[i] = 1
        cnt = 0
        for obj in objs:
            if not isinstance(obj, dict):
                rflags[i] |= RF_NONDICT_OBJECTS
                continue
            cnt += 1
            obj_row.append(i)
            f = 0
            if "name" in obj:
                v = obj["name"]
                if v is None:
                    f |= 2
                    names.append(None)
                elif isinstance(v, str):
                    f |= 1
                    names.append(v)
                else:
                    f |= 3
                    names.append(str(v))
            else:
                names.append(None)
            name_kind.append(f & 3)
            poly = obj.get("polygon")
            if "polygon" in obj:
                f |= F_HAS_POLY
                if isinstance(poly, dict):
                    f |= F_POLY_IS_OBJ
                    if not poly:
                        f |= F_POLY_EMPTY
                    if "ptList" in poly:
                        f |= F_HAS_PTLIST
            if not obj:
                f |= F_OBJ_EMPTY
            ptlist = (poly or {}).get("ptList") if isinstance(poly, dict) else None
            box, ok, cnt_pts, twopt = _py_bbox_and_flags(ptlist)
            if isinstance(ptlist, list):
                f |= F_PTLIST_IS_ARR
            if ok:
                f |= F_BBOX_OK
            if twopt:
                f |= F_TWOPT_OK
            oflags.append(f)
            boxes.append(box)
            npts.append(cnt_pts)
        counts[i] = cnt
    obj_offsets = np.zeros(n + 1, np.int64)
    np.cumsum(counts, out=obj_offsets[1:])
    return AnnTable(
        n=n, raw=raw, status=status, objects_kind=kinds, row_flags=rflags,
        wh=wh, obj_offsets=obj_offsets,
        obj_row=np.asarray(obj_row, np.int64),
        names=names, name_kind=np.asarray(name_kind, np.uint8),
        flags=np.asarray(oflags, np.int32),
        box=np.asarray(boxes, np.float64).reshape(-1, 4),
        npts=np.asarray(npts, np.int32), native=False,
    )


def encode_cells(cells):
    """Per-cell utf-8 bytes for the native scanners. A pandas string column
    returns a zero-copy BlobRows view of its Arrow buffers (no per-row Python
    objects at all); anything else becomes a list of bytes/None."""
    try:
        import pandas as pd

        if isinstance(cells, pd.Series):
            import pyarrow as pa

            from ..runtime import BlobRows

            arr = pa.array(cells, from_pandas=True)
            if pa.types.is_string(arr.type) or pa.types.is_large_string(arr.type):
                arr = arr.cast(pa.large_binary())
                import os as _os
                if arr.offset == 0 and not _os.environ.get("DYD_NO_BLOB"):
                    return BlobRows.from_arrow(arr)
                return arr.to_pylist()
            cells = cells.tolist()
    except Exception:
        cells = list(cells)
    return [r.encode("utf-8") if isinstance(r, str) else None for r in cells]


def build_table(rows) -> AnnTable:
    """Scan a column of annotation-JSON strings (list or pandas Series) into
    an AnnTable."""
    native = scan_annotations_native(encode_cells(rows), pre_encoded=True)
    if native is None:
        return _py_scan(rows)
    encoded, row_i32, row_wh, obj_offsets, obj_i32, obj_box, name_pos, arena = native
    m = obj_i32.shape[0]
    kinds = (obj_i32[:, 9] & F_NAME_KIND_MASK).astype(np.uint8)
    names: list = [None] * m
    starts, ends = name_pos[:, 0], name_pos[:, 1]
    for j in range(m):
        k = kinds[j]
        if k == 1 or k == 3:
            names[j] = arena[starts[j]:ends[j]].decode("utf-8", "replace")
    # str(value) canonicalization for non-string names kept as raw JSON
    # tokens: true -> "True", ["l"] -> "['l']", 1.5 -> "1.5" — whatever
    # Python str() of the parsed value gives (reference semantics)
    for j in np.flatnonzero(kinds == 3):
        t = names[j]
        if t == "true":
            names[j] = "True"
        elif t == "false":
            names[j] = "False"
        else:
            try:
                names[j] = str(json.loads(t))
            except Exception:
                pass
    n = row_i32.shape[0]
    obj_row = np.repeat(
        np.arange(n, dtype=np.int64), np.diff(obj_offsets).astype(np.int64)
    )
    return AnnTable(
        n=n, raw=encoded,
        status=row_i32[:, 0].astype(np.uint8),
        objects_kind=row_i32[:, 1].astype(np.uint8),
        row_flags=row_i32[:, 2].astype(np.uint8),
        wh=row_wh, obj_offsets=obj_offsets, obj_row=obj_row,
        names=names, name_kind=kinds,
        flags=obj_i32[:, 9], box=obj_box,
        npts=obj_i32[:, 8], native=True,
        spans=obj_i32, objects_span=row_i32[:, 3:5],
    )


# ---------------------------------------------------------------------------
# Appliers
# ---------------------------------------------------------------------------


def _py_rewrite_ptlists_cell(raw_text: str) -> str:
    """Fallback poly->bbox rewrite for one cell (reference semantics:
    non-dict objects dropped, polygon created when absent —
    core/processor.py:252-283)."""
    data = json.loads(raw_text)
    objs = data.get("objects", [])
    updated = []
    if isinstance(objs, list):
        for obj in objs:
            if not isinstance(obj, dict):
                continue
            u = dict(obj)
            poly = u.get("polygon")
            new_poly = dict(poly) if isinstance(poly, dict) else {}
            ptlist = new_poly.get("ptList")
            box, ok, _, _ = _py_bbox_and_flags(ptlist)
            new_poly["ptList"] = bbox_ptlist_points(box, ok)
            u["polygon"] = new_poly
            updated.append(u)
    data["objects"] = updated
    return json.dumps(data, ensure_ascii=False)


def rewrite_ptlists(table: AnnTable) -> list:
    """Step-4 rewrite: every object's polygon.ptList replaced by its 2-point
    bbox. Returns per-row new cell text (None for unparseable cells)."""
    out: list = [None] * table.n
    ok_rows = table.status == ROW_OK

    def needs_fallback(i: int) -> bool:
        # objects-key-absent / non-list cells change shape under the
        # reference's re-serialization (objects becomes []): not splicable.
        return table.row_needs_fallback(i) or table.objects_kind[i] != 1

    # Native path: the whole rewrite (number formatting + byte splicing)
    # runs in labelscan.cpp; only fallback rows drop to json round-trips.
    if table.native:
        from ..runtime import rewrite_ptlists_native

        do_row = (
            ok_rows
            & ((table.row_flags & RF_NONDICT_OBJECTS) == 0)
            & (table.objects_kind == 1)
        )
        nat = rewrite_ptlists_native(
            table.raw, do_row, table.obj_offsets, table.spans, table.box
        )
        if nat is not None:
            for i in np.flatnonzero(ok_rows):
                i = int(i)
                if nat[i] is not None:
                    out[i] = nat[i]
                else:
                    out[i] = _py_rewrite_ptlists_cell(
                        table.raw[i].decode("utf-8")
                    )
            return out
        sp = table.spans
        bbox_ok = table.bbox_ok()
        edits_by_row: dict = {}
        for j in range(table.m):
            i = int(table.obj_row[j])
            if not ok_rows[i] or needs_fallback(i):
                continue
            f = int(table.flags[j])
            text = bbox_ptlist_text(table.box[j], bool(bbox_ok[j]))
            if f & F_HAS_PTLIST:
                edit = (int(sp[j, 4]), int(sp[j, 5]), text)
            elif f & F_POLY_IS_OBJ:
                ins = b'"ptList": ' + text
                if not (f & F_POLY_EMPTY):
                    ins += b", "
                pos = int(sp[j, 6]) + 1
                edit = (pos, pos, ins)
            elif f & F_HAS_POLY:
                edit = (int(sp[j, 6]), int(sp[j, 7]), b'{"ptList": ' + text + b"}")
            else:
                ins = b'"polygon": {"ptList": ' + text + b"}"
                if not (f & F_OBJ_EMPTY):
                    ins += b", "
                pos = int(sp[j, 0]) + 1
                edit = (pos, pos, ins)
            edits_by_row.setdefault(i, []).append(edit)
        for i in np.flatnonzero(ok_rows):
            i = int(i)
            if needs_fallback(i):
                out[i] = _py_rewrite_ptlists_cell(table.raw[i].decode("utf-8"))
            else:
                out[i] = splice(table.raw[i], edits_by_row.get(i, [])).decode("utf-8")
    else:
        for i in np.flatnonzero(ok_rows):
            i = int(i)
            out[i] = _py_rewrite_ptlists_cell(table.raw[i].decode("utf-8"))
    return out


def _py_rename_cell(raw_text: str, renames: dict) -> str:
    """Fallback name rewrite: renames maps dict-object ordinal -> new name."""
    data = json.loads(raw_text)
    objs = data.get("objects")
    ordinal = 0
    if isinstance(objs, list):
        for obj in objs:
            if not isinstance(obj, dict):
                continue
            if ordinal in renames:
                obj["name"] = renames[ordinal]
            ordinal += 1
    return json.dumps(data, ensure_ascii=False)


def _name_edit_arrays(table: AnnTable, j: np.ndarray, labels: np.ndarray,
                      extra: list = ()):
    """Vectorized _name_edit over object indices ``j`` with new names
    ``labels``: returns per-item (edit_s, edit_e, rep_s, rep_len) plus the
    shared replacement blob. Unique labels lay out once (three variants:
    named / insert / insert-into-empty-object); ``extra`` byte pieces prepend
    to the blob for the caller's own edits."""
    import pandas as pd  # hash-based factorize (np.unique would sort 2M strs)

    sp = table.spans
    codes, uniq = pd.factorize(labels)
    named_u = [json.dumps(str(l), ensure_ascii=False).encode("utf-8") for l in uniq]
    pieces = (
        list(extra) + named_u
        + [b'"name": ' + r + b", " for r in named_u]
        + [b'"name": ' + r for r in named_u]
    )
    plen = np.fromiter(map(len, pieces), np.int64, len(pieces))
    poff = np.zeros(len(pieces) + 1, np.int64)
    np.cumsum(plen, out=poff[1:])
    blob = b"".join(pieces)
    U = len(uniq)
    E = len(extra)
    ns = sp[j, 2].astype(np.int64)
    has_name = ns >= 0
    obj_empty = (table.flags[j] & F_OBJ_EMPTY) != 0
    piece_idx = np.where(
        has_name, E + codes,
        np.where(obj_empty, E + 2 * U + codes, E + U + codes),
    )
    e_s = np.where(has_name, ns, sp[j, 0].astype(np.int64) + 1)
    e_e = np.where(has_name, sp[j, 3].astype(np.int64), e_s)
    return e_s, e_e, poff[piece_idx], plen[piece_idx], blob


def apply_renames_at(table: AnnTable, objs, labels):
    """Rewrite object names: ``objs`` (ascending object indices) get
    ``labels``. Returns ``(row_indices, texts)`` for every changed row —
    the vectorized core of apply_renames (no per-object Python loop)."""
    from ..runtime import splice_items2_native

    objs = np.asarray(objs, np.int64)
    if len(objs) == 0:
        return np.zeros(0, np.int64), []
    labels = np.asarray(labels, dtype=object)
    rows = table.obj_row[objs]
    if table.native:
        fb = ((table.row_flags & RF_NONDICT_OBJECTS) != 0)[rows]
    else:
        fb = np.ones(len(objs), bool)
    out_rows: list = []
    out_texts: list = []
    if fb.any():  # rare non-splicable rows: python rewrite per row
        py_rows: dict = {}
        base = table.obj_offsets
        for k in np.flatnonzero(fb).tolist():
            i = int(rows[k])
            py_rows.setdefault(i, {})[int(objs[k] - base[i])] = labels[k]
        for i, renames in py_rows.items():
            out_rows.append(i)
            out_texts.append(
                _py_rename_cell(table.raw[i].decode("utf-8"), renames)
            )
    idx = np.flatnonzero(~fb)
    if not len(idx):
        return np.asarray(out_rows, np.int64), out_texts
    j = objs[idx]
    i_rows = rows[idx]
    e_s, e_e, rep_s, rep_len, blob = _name_edit_arrays(table, j, labels[idx])
    # objs ascending => i_rows nondecreasing: contiguous runs = items
    starts = np.flatnonzero(np.r_[True, i_rows[1:] != i_rows[:-1]])
    item_row = i_rows[starts]
    edit_off = np.append(starts, len(idx)).astype(np.int64)
    texts = splice_items2_native(
        table.raw, item_row, edit_off, e_s, e_e, blob, rep_s, rep_len
    )
    if texts is None:  # no native lib: per-row python splice
        el, sl, rl = edit_off.tolist(), e_s.tolist(), e_e.tolist()
        for k, i in enumerate(item_row.tolist()):
            lo, hi = el[k], el[k + 1]
            reps = [blob[a:a + ln] for a, ln in
                    zip(rep_s[lo:hi].tolist(), rep_len[lo:hi].tolist())]
            out_rows.append(i)
            out_texts.append(
                splice(table.raw[i], list(zip(sl[lo:hi], rl[lo:hi], reps)))
                .decode("utf-8")
            )
        return np.asarray(out_rows, np.int64), out_texts
    if not out_rows:
        return item_row, texts
    return np.concatenate([np.asarray(out_rows, np.int64), item_row]), out_texts + texts


def apply_renames(table: AnnTable, new_names: Sequence) -> list:
    """Rewrite object names; new_names[j] is None to keep. Returns per-row
    text for CHANGED rows only (None = row untouched). Thin adapter over the
    vectorized apply_renames_at."""
    objs = [j for j, nn in enumerate(new_names) if nn is not None]
    labels = np.array([new_names[j] for j in objs], dtype=object)
    rows_idx, texts = apply_renames_at(table, np.asarray(objs, np.int64), labels)
    out: list = [None] * table.n
    for i, t in zip(rows_idx.tolist(), texts):
        out[i] = t
    return out


def _py_extract_cell(raw_text: str, ordinal: int, label: str) -> str:
    data = json.loads(raw_text)
    objs = data.get("objects")
    k = 0
    picked = None
    if isinstance(objs, list):
        for obj in objs:
            if not isinstance(obj, dict):
                continue
            if k == ordinal:
                picked = json.loads(json.dumps(obj))
                break
            k += 1
    if picked is None:
        picked = {}
    picked["name"] = label
    new_data = {k2: v for k2, v in data.items() if k2 != "objects"}
    new_data["objects"] = [picked]
    return json.dumps(new_data, ensure_ascii=False)


def extract_single_objects(table: AnnTable, objs, labels) -> list:
    """Batch step-7 explosion: one output text per (object, label) pair —
    the cell keeps only that object, renamed. Fully vectorized: per-item
    edit spans assemble as (k,3) numpy stacks, unique label reps lay out once
    in a shared blob (splice_items2's explicit rep spans), and the splice
    loop runs in C++. Falls back to per-item extraction without the lib."""
    from ..runtime import splice_items2_native

    objs = np.asarray(objs, np.int64)
    n_items = len(objs)
    if n_items == 0:
        return []
    labels = np.asarray(labels, dtype=object)
    rows = table.obj_row[objs]
    if table.native:
        fb = ((table.row_flags & RF_NONDICT_OBJECTS) != 0)[rows]
    else:
        fb = np.ones(n_items, bool)
    out: list = [None] * n_items
    for k in np.flatnonzero(fb).tolist():  # rare non-splicable rows
        i = int(rows[k])
        out[k] = _py_extract_cell(
            table.raw[i].decode("utf-8"), int(objs[k] - table.obj_offsets[i]),
            str(labels[k]),
        )
    idx = np.flatnonzero(~fb)
    if not len(idx):
        return out
    j = objs[idx]
    i = rows[idx]
    sp = table.spans
    osp = table.objects_span
    e2_s, e2_e, rep2_s, rep2_len, blob = _name_edit_arrays(
        table, j, labels[idx], extra=[b"[", b"]"]
    )
    k = len(idx)
    edit_s = np.empty((k, 3), np.int64)
    edit_e = np.empty((k, 3), np.int64)
    rep_s = np.empty((k, 3), np.int64)
    rep_len = np.empty((k, 3), np.int64)
    edit_s[:, 0] = osp[i, 0]   # "...objects": [ -> "[" + this object
    edit_e[:, 0] = sp[j, 0]
    edit_s[:, 1] = e2_s        # rename (or insert name)
    edit_e[:, 1] = e2_e
    edit_s[:, 2] = sp[j, 1]    # drop the other objects
    edit_e[:, 2] = osp[i, 1]
    rep_s[:, 0] = 0   # "[" is extra piece 0
    rep_len[:, 0] = 1
    rep_s[:, 1] = rep2_s
    rep_len[:, 1] = rep2_len
    rep_s[:, 2] = 1   # "]" is extra piece 1
    rep_len[:, 2] = 1
    texts = splice_items2_native(
        table.raw, i, np.arange(k + 1, dtype=np.int64) * 3,
        edit_s.ravel(), edit_e.ravel(), blob, rep_s.ravel(), rep_len.ravel(),
    )
    if texts is None:
        for kk in idx.tolist():
            out[kk] = extract_single_object(table, int(objs[kk]), str(labels[kk]))
        return out
    if not fb.any():
        return texts
    for pos, kk in enumerate(idx.tolist()):
        out[kk] = texts[pos]
    return out


def extract_single_object(table: AnnTable, j: int, label: str) -> str:
    """Step-7 explosion: cell text containing only object j, renamed to
    ``label`` (reference: core/processor.py:741-775)."""
    i = int(table.obj_row[j])
    if table.row_needs_fallback(i):
        ordinal = int(j - table.obj_offsets[i])
        return _py_extract_cell(table.raw[i].decode("utf-8"), ordinal, label)
    sp = table.spans
    raw = table.raw[i]
    os_, oe = int(table.objects_span[i, 0]), int(table.objects_span[i, 1])
    s, e = int(sp[j, 0]), int(sp[j, 1])
    rep = json.dumps(label, ensure_ascii=False).encode("utf-8")
    ns, ne = int(sp[j, 2]), int(sp[j, 3])
    if ns < 0:
        ins = b'"name": ' + rep
        if not (int(table.flags[j]) & F_OBJ_EMPTY):
            ins += b", "
        obj_bytes = raw[s:s + 1] + ins + raw[s + 1:e]
    else:
        obj_bytes = raw[s:ns] + rep + raw[ne:e]
    return (raw[:os_] + b"[" + obj_bytes + b"]" + raw[oe:]).decode("utf-8")

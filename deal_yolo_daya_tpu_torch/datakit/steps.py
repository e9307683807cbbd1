"""The 9-step annotation pipeline (steps 1-6 + split + unclassified summary).

Signatures, artifact names and console-output style match the reference
(reference: core/processor.py:26-891) so the UI and saved run configs work
unchanged. Internals are columnar: each string column is scanned ONCE into an
AnnTable (native multithreaded scanner, runtime/labelscan.cpp), step logic
runs as vectorized pandas/numpy ops over the flat object table, and JSON
cells are rewritten by byte-splicing recorded spans (datakit/columnar.py) —
no per-row json.loads/json.dumps loops.
"""

from __future__ import annotations

import os
import re
import shutil
from pathlib import Path
from typing import Optional

import numpy as np
import pandas as pd

from ..utils import xlsx
from ..utils.csvio import read_csv, write_csv
from ..utils.naming import safe_filename
from . import boxes as boxops
from . import columnar
from .columnar import ROW_INVALID, ROW_NON_OBJECT, ROW_NULL, ROW_OK
from .labels import (
    LABEL_JSON_COL,
    NEW_LABEL_JSON_COL,
    SEP_PATTERN,
    extract_two_point_boxes,
    split_label_cell,
)

# ---------------------------------------------------------------------------
# Shared IO helpers
# ---------------------------------------------------------------------------


def _require_csv_path(path: str) -> None:
    if not os.path.exists(path):
        raise FileNotFoundError(f"文件不存在：{path}")
    if not str(path).endswith(".csv"):
        raise ValueError(f"文件不是CSV格式：{path}（请传入.csv后缀的文件）")


# columns whose cells dominate read time (JSON labels, URLs): the fast
# reader parses them with pyarrow straight into Arrow buffers
_HEAVY_COLS = ("source", "source_file", LABEL_JSON_COL, NEW_LABEL_JSON_COL)


def _load_csv(path: str, encoding: str = "utf-8-sig") -> pd.DataFrame:
    try:
        return read_csv(path, encoding=encoding, heavy=_HEAVY_COLS)
    except Exception as e:
        raise Exception(f"读取CSV文件失败：{str(e)}") from e


def _save_csv(df: pd.DataFrame, path, encoding: str = "utf-8-sig") -> None:
    try:
        parent = Path(path).parent
        if str(parent):
            parent.mkdir(parents=True, exist_ok=True)
        write_csv(df, path, encoding=encoding)
    except Exception as e:
        raise Exception(f"保存结果失败：{str(e)}") from e


# ---------------------------------------------------------------------------
# Step 1: merge
# ---------------------------------------------------------------------------


def merge_all_csv_in_folder(
    folder_path,
    output_file="merged_csv.csv",
    encoding="utf-8-sig",
    chunk_size: int = 100000,
    progress_callback=None,
):
    """Streaming merge of all *.csv in a folder; adds a ``source_file`` column.

    Progress callback signature (10 args): (file_idx, n_files, file_name,
    total_rows, file_rows, chunk_idx, file_size, file_bytes, total_bytes,
    total_bytes_read) — byte-accurate for UI ETA cards
    (reference: core/processor.py:53-65, 84-96).
    """
    if not os.path.exists(folder_path):
        raise FileNotFoundError(f"文件夹不存在：{folder_path}")

    plan = [(p, p.stat().st_size) for p in sorted(Path(folder_path).glob("*.csv"))]
    if not plan:
        print(f"警告：文件夹 {folder_path} 中未找到CSV文件")
        return None
    print(f"找到 {len(plan)} 个CSV文件，开始合并...")

    total_bytes = sum(size for _, size in plan)
    state = {"rows": 0, "done_bytes": 0, "wrote_header": False}

    def report(file_idx, path, size, file_rows, chunk_idx, file_bytes):
        if progress_callback:
            progress_callback(
                file_idx, len(plan), path.name, state["rows"], file_rows,
                chunk_idx, size, file_bytes, total_bytes,
                state["done_bytes"] + file_bytes,
            )

    output_file = str(output_file)
    Path(output_file).parent.mkdir(parents=True, exist_ok=True)
    # Unlike the reference (which reopens the output in append mode for every
    # chunk — core/processor.py:84-96), stream all chunks into ONE handle.
    with open(output_file, "w", encoding=encoding, newline="") as sink:
        for file_idx, (path, size) in enumerate(plan, start=1):
            report(file_idx, path, size, 0, 0, 0)
            file_rows = 0
            try:
                with open(path, "r", encoding=encoding, errors="ignore") as f:
                    chunks = pd.read_csv(f, parse_dates=False, chunksize=chunk_size)
                    for chunk_idx, df in enumerate(chunks, start=1):
                        df["source_file"] = path.name
                        df.to_csv(sink, index=False, header=not state["wrote_header"])
                        state["wrote_header"] = True
                        file_rows += len(df)
                        state["rows"] += len(df)
                        report(file_idx, path, size, file_rows, chunk_idx, f.tell())
            except Exception as e:
                print(f"读取失败 {path.name}：{str(e)}")
                continue
            print(f"成功读取：{path.name}（{file_rows}行）")
            state["done_bytes"] += size

    if not state["wrote_header"]:
        os.unlink(output_file)
        print("错误：没有可合并的有效CSV数据")
        return None

    print(f"\n合并完成！共 {state['rows']} 行数据")
    print(f"输出文件：{os.path.abspath(output_file)}")
    return state["rows"]


# ---------------------------------------------------------------------------
# Step 2: dedup by source
# ---------------------------------------------------------------------------


def deduplicate_csv_by_source(
    csv_path: str,
    output_file: Optional[str] = "deduplicate_result.csv",
    encoding: str = "utf-8-sig",
    keep: str = "first",
    verbose: bool = True,
) -> pd.DataFrame:
    """Keep one row per unique ``source`` value
    (reference: core/processor.py:111-164)."""
    _require_csv_path(csv_path)
    df = _load_csv(csv_path, encoding)
    if verbose:
        print(f"成功读取CSV文件：{os.path.basename(csv_path)}")
        print(f"读取后原始数据行数：{len(df)}")

    if "source" not in df.columns:
        raise KeyError(
            f"CSV文件中未找到'source'列，请检查列名是否正确（当前列名：{list(df.columns)}）"
        )

    result = df.drop_duplicates(subset=["source"], keep=keep, ignore_index=True)
    if verbose:
        print(f"去重策略：按'source'列保留{keep}条数据")
        print(f"去除重复数据行数：{len(df) - len(result)}")
        print(f"去重后剩余数据行数：{len(result)}")

    if output_file is not None:
        _save_csv(result, output_file, encoding)
        if verbose:
            print(f"去重后的文件已保存至：{os.path.abspath(output_file)}")
    return result


# ---------------------------------------------------------------------------
# Step 3: reference-set filter
# ---------------------------------------------------------------------------


def remove_duplicates_between_csv(
    main_csv: str,
    ref_csv: str,
    output_csv: str = "filtered_main.csv",
    compare_col: str = "source",
    encoding: str = "utf-8-sig",
    verbose: bool = True,
) -> pd.DataFrame:
    """Anti-join: drop main rows whose ``compare_col`` value appears in the
    reference CSV (reference: core/processor.py:166-219)."""
    _require_csv_path(main_csv)
    _require_csv_path(ref_csv)
    df_main = _load_csv(main_csv, encoding)
    df_ref = _load_csv(ref_csv, encoding)
    if verbose:
        print(f"读取主文件：{len(df_main)}行")
        print(f"读取参考文件：{len(df_ref)}行")

    for name, frame in (("主文件", df_main), ("参考文件", df_ref)):
        if compare_col not in frame.columns:
            raise KeyError(f"{name}中未找到列 '{compare_col}'")

    ref_values = df_ref[compare_col].dropna().astype(str).unique()
    mask = ~df_main[compare_col].astype(str).isin(ref_values)
    result = df_main[mask].copy()

    if verbose:
        print(f"去重依据列：{compare_col}")
        print(f"参考文件中唯一值数量：{len(ref_values)}")
        print(f"剔除重复行数：{len(df_main) - len(result)}")
        print(f"保留行数：{len(result)}")

    _save_csv(result, output_csv, encoding)
    if verbose:
        print(f"结果已保存至：{os.path.abspath(output_csv)}")
    return result


def overwrite_reference_with_result(result_csv: str, ref_csv: str):
    if not os.path.exists(result_csv):
        raise FileNotFoundError(f"结果文件不存在：{result_csv}")
    shutil.copy2(result_csv, ref_csv)


# ---------------------------------------------------------------------------
# Step 4: polygon -> bbox (ptList replace)
# ---------------------------------------------------------------------------


def _wh_column(values: np.ndarray):
    """Width/height array -> CSV-friendly column. PER-CELL integral check:
    the reference appends the raw JSON value (int stays int) per row, so one
    fractional width elsewhere in the file must not turn every '640' into
    '640.0'."""
    values = np.asarray(values, np.float64)
    finite = np.isfinite(values)
    integral = finite & (values == np.floor(values))
    col = np.full(len(values), None, dtype=object)
    # .tolist() boxes PYTHON ints/floats (np.int64 would serialize as text
    # in the xlsx writer's isinstance(int) check)
    col[integral] = values[integral].astype(np.int64).tolist()
    frac = finite & ~integral
    col[frac] = values[frac].tolist()
    return pd.Series(col, dtype=object)


def process_csv_replace_ptlist(
    input_csv_path: str,
    output_csv_path: str = "processed_replaced_ptlist.csv",
    excluded_output_file: Optional[str] = "processed_excluded.csv",
):
    """Replace each object's polygon ptList with its 2-point axis-aligned bbox.

    One native scan of the label column yields every polygon's extents plus
    the byte spans of each ptList; the rewrite is a per-cell byte splice
    (columnar.rewrite_ptlists). The reference re-parses each cell twice and
    rebuilds the object tree per row (core/processor.py:283, 294).
    """
    try:
        df = read_csv(input_csv_path, heavy=_HEAVY_COLS)
        print(f"成功读取CSV，共 {len(df)} 行数据")
    except FileNotFoundError:
        print(f"错误：未找到文件 {input_csv_path}")
        return None
    except Exception as e:
        print(f"读取失败：{e}")
        return None

    if LABEL_JSON_COL not in df.columns:
        print(f"错误：CSV缺少列 '{LABEL_JSON_COL}'")
        return None

    keep = df[LABEL_JSON_COL].notna()
    table = columnar.build_table(df[LABEL_JSON_COL])
    rewritten = columnar.rewrite_ptlists(table)

    kept_idx = np.flatnonzero(keep.to_numpy())
    out = pd.DataFrame(index=range(len(kept_idx)))
    # assign string columns as OBJECT Series: sanitizing a python list/object
    # ndarray into the default Arrow-string dtype re-encodes every cell
    # (~0.8 s per 50k-row column, pandas 3 profile round 3); object passes
    # straight through and to_csv costs the same either way
    as_obj = lambda vals: pd.Series(
        np.asarray(vals, dtype=object), dtype=object
    )
    if "source" in df.columns:
        out["source"] = as_obj(df["source"].to_numpy()[kept_idx])
    out[LABEL_JSON_COL] = as_obj(df[LABEL_JSON_COL].to_numpy()[kept_idx])
    out[NEW_LABEL_JSON_COL] = as_obj([rewritten[i] for i in kept_idx])
    out["width"] = _wh_column(table.wh[kept_idx, 0])
    out["height"] = _wh_column(table.wh[kept_idx, 1])

    Path(output_csv_path).parent.mkdir(parents=True, exist_ok=True)
    write_csv(out, output_csv_path)

    excluded_df = df[~keep]
    if excluded_output_file is not None:
        Path(excluded_output_file).parent.mkdir(parents=True, exist_ok=True)
        write_csv(excluded_df, excluded_output_file)

    return {
        "filtered_rows": len(kept_idx),
        "excluded_rows": len(excluded_df),
        "excluded_output": excluded_output_file,
    }


# ---------------------------------------------------------------------------
# Step 5: IoU quality filter (vectorized)
# ---------------------------------------------------------------------------


def filter_by_box_count_and_iou(
    input_csv_path,
    high_iou_csv="high_iou_0.98.csv",
    other_csv="other_data.csv",
    min_boxes: int = 2,
    iou_threshold: float = 0.98,
):
    """Split rows into suspected-duplicate-annotation rows (any box pair with
    IoU >= threshold and >= min_boxes boxes) vs clean rows.

    Replaces the reference's per-row O(n^2) Python loop
    (core/processor.py:368-376) with one packed (rows, M, M) IoU computed
    in chunks, with numpy on the host or PyTorch on the card for huge
    tables (boxes.high_iou_hits).
    """
    try:
        df = read_csv(input_csv_path, heavy=_HEAVY_COLS)
    except Exception as e:
        print(f"读取失败：{e}")
        return

    if NEW_LABEL_JSON_COL not in df.columns:
        print(f"错误：缺少必要列 {NEW_LABEL_JSON_COL}")
        return

    cells = df[NEW_LABEL_JSON_COL]
    rows = None  # materialized lazily for the fallback/saturated paths
    # Cap the packed width: one outlier row with hundreds of boxes would
    # inflate the (rows, M, M) IoU tensors quadratically. Saturated rows
    # (count == cap, i.e. possibly truncated) are re-checked exactly via the
    # per-row Python/numpy path below.
    M_CAP = 64
    native = None
    try:
        from ..runtime import scan_boxes_native

        native = scan_boxes_native(
            columnar.encode_cells(cells), two_point_only=True,
            max_boxes=M_CAP, pre_encoded=True,
        )
    except Exception:
        native = None
    if native is not None:
        packed, mask, counts, _ = native
        saturated = np.flatnonzero(counts >= M_CAP)
    else:
        rows = cells.tolist()
        box_lists = [extract_two_point_boxes(v) for v in rows]
        saturated = np.flatnonzero(np.asarray([len(b) for b in box_lists]) > M_CAP)
        box_lists = [b[:M_CAP] for b in box_lists]
        packed, mask = boxops.pack_boxes(box_lists, max_boxes=M_CAP)
    # trim to the table's ACTUAL max box count: the (rows, M, M) IoU work
    # scales with M^2, and typical annotation data has 1-8 boxes — padding
    # every row to the 64-wide cap cost 50-250x (bench_datakit round 2)
    m_used = int(mask.sum(axis=1).max()) if len(cells) else 0
    m_used = max(m_used, 1)
    packed, mask = packed[:, :m_used], mask[:, :m_used]
    hits = boxops.high_iou_hits(packed, mask, min_boxes=min_boxes, iou_threshold=iou_threshold)
    if len(saturated) and rows is None:
        rows = cells.tolist()
    for i in saturated:
        full = extract_two_point_boxes(rows[int(i)])
        b, m = boxops.pack_boxes([full])
        hits[int(i)] = bool(
            boxops.high_iou_hits(b, m, min_boxes=min_boxes, iou_threshold=iou_threshold)[0]
        )

    Path(high_iou_csv).parent.mkdir(parents=True, exist_ok=True)
    Path(other_csv).parent.mkdir(parents=True, exist_ok=True)

    write_csv(df[hits], high_iou_csv)
    write_csv(df[~hits], other_csv)


# ---------------------------------------------------------------------------
# Step 6: label mapping (columnar)
# ---------------------------------------------------------------------------


def _read_label_map(mapping_excel_path, sheet_name, old_col, new_col) -> dict:
    mapping_df = xlsx.read_workbook(mapping_excel_path, sheet_name if sheet_name else 0)
    if not old_col or not new_col:
        cols = list(mapping_df.columns)
        if len(cols) < 2:
            raise ValueError("标签对照表至少需要两列")
        old_col = old_col or cols[0]
        new_col = new_col or cols[1]
    olds = mapping_df[old_col].astype(str).str.strip()
    news = mapping_df[new_col].astype(str).str.strip()
    valid = (
        (olds != "") & (news != "")
        & (olds.str.lower() != "nan") & (news.str.lower() != "nan")
    )
    return dict(zip(olds[valid], news[valid]))


def _group_join(keys_sorted: np.ndarray, values: np.ndarray, sep: str) -> list:
    """Join `values` per contiguous run of `keys_sorted` (keys must be
    sorted). A plain boundary scan: pandas' groupby with a Python ``join``
    agg slices a Series per group — the dominant cost of step 6 at 150k+
    tiny groups (bench_datakit round 2)."""
    n = len(keys_sorted)
    if n == 0:
        return []
    bounds = np.flatnonzero(keys_sorted[1:] != keys_sorted[:-1]) + 1
    starts = np.concatenate([[0], bounds])
    ends = np.concatenate([bounds, [n]])
    vals = values.tolist()
    return [sep.join(vals[s:e]) for s, e in zip(starts, ends)]


def _token_frame(table: columnar.AnnTable) -> pd.DataFrame:
    """Flat (obj, token) frame over all named objects of a table.

    Names repeat heavily, so each UNIQUE name tokenizes once (split + strip +
    drop-empty, same semantics as the old per-cell ``str.split``/``strip``
    chain) and the flat frame rebuilds with ragged numpy gathers — the
    per-object regex split was ~4 s/column at 1M rows. ``tok`` stays object
    dtype (Arrow string inference re-encodes the whole column)."""
    named = pd.Series(table.names, dtype=object)
    codes, uniq = pd.factorize(named)  # None names -> code -1 (no tokens)
    flat_toks: list = []
    u_off = np.zeros(len(uniq) + 1, np.int64)
    for k, u in enumerate(uniq):
        # truthiness gates tokenization ('' -> no tokens); non-str names
        # yield none (the old .str accessor surfaced them as NaN)
        if u and isinstance(u, str):
            flat_toks.extend(
                t for t in (s.strip() for s in re.split(SEP_PATTERN, u)) if t
            )
        u_off[k + 1] = len(flat_toks)
    flat_u = np.asarray(flat_toks, dtype=object)
    cnt_u = np.diff(u_off)
    safe = np.clip(codes, 0, None)
    counts = np.where(codes >= 0, cnt_u[safe], 0)
    total = int(counts.sum())
    obj_idx = np.repeat(np.arange(len(named), dtype=np.int64), counts)
    excl = np.zeros(len(counts), np.int64)
    np.cumsum(counts[:-1], out=excl[1:])
    within = np.arange(total, dtype=np.int64) - np.repeat(excl, counts)
    tok = flat_u[np.repeat(u_off[safe], counts) + within]
    return pd.DataFrame({"obj": obj_idx, "tok": pd.Series(tok, dtype=object)})


def replace_labels_by_mapping(
    input_csv_path: str,
    mapping_excel_path: str,
    output_csv_path: str,
    sheet_name: Optional[str] = None,
    old_col: Optional[str] = None,
    new_col: Optional[str] = None,
    json_columns: Optional[list] = None,
    diff_excel_path: Optional[str] = None,
    unmatched_excel_path: Optional[str] = None,
    sample_size: int = 30,
):
    """Rename labels via a 2-column Excel map; emits diff Excel, unmatched-label
    histogram Excel and a 10-field summary (reference: core/processor.py:516-652).

    Columnar: one table scan per JSON column; token split / mapping / dedup+
    sort run as vectorized pandas ops over the flat object table; only rows
    whose names actually change are rewritten (span splice).
    """
    df = read_csv(input_csv_path, heavy=_HEAVY_COLS)
    label_map = _read_label_map(mapping_excel_path, sheet_name, old_col, new_col)

    if json_columns is None:
        json_columns = [c for c in (NEW_LABEL_JSON_COL, LABEL_JSON_COL) if c in df.columns]
    present_cols = [c for c in json_columns if c in df.columns]

    totals = {
        "total_objects": 0, "total_labels": 0, "replaced_labels": 0,
        "replaced_objects": 0, "invalid_json_rows": 0, "missing_name_objects": 0,
    }
    unmatched = pd.Series(dtype="int64")
    diff_records: list = []  # (row, col_order, before, after)
    rows_with_replacement = np.zeros(len(df), dtype=bool)
    sources = df["source"] if "source" in df.columns else pd.Series([None] * len(df))

    for col_order, col in enumerate(present_cols):
        cells = df[col]
        table = columnar.build_table(cells)

        non_empty = cells.notna().to_numpy() & (cells.astype(str) != "").to_numpy()
        totals["invalid_json_rows"] += int(
            ((table.status == ROW_INVALID) & non_empty).sum()
        )
        totals["total_objects"] += table.m
        totals["missing_name_objects"] += int(
            ((table.name_kind == 0) | (table.name_kind == 2)).sum()
        )

        tf = _token_frame(table)
        totals["total_labels"] += len(tf)
        if len(tf) == 0 and table.m == 0:
            continue

        if len(tf):
            # map each UNIQUE token once; broadcast by factorize codes
            toks_np = tf["tok"].to_numpy()
            t_codes, t_uniq = pd.factorize(toks_np)
            in_map_u = np.fromiter(
                (u in label_map for u in t_uniq), bool, len(t_uniq)
            )
            in_map = in_map_u[t_codes]
            mapped_u = np.array(
                [label_map.get(u, u) for u in t_uniq], dtype=object
            )
            if (~in_map_u).any():
                um_counts = np.bincount(t_codes[~in_map], minlength=len(t_uniq))
                um_sel = np.flatnonzero(um_counts)
                unmatched = unmatched.add(
                    pd.Series(um_counts[um_sel], index=t_uniq[um_sel]),
                    fill_value=0,
                )
            obj_np = tf["obj"].to_numpy()
            # dedup + sort per object, comma-join (reference: utils.py:664-679)
            nn_objs, nn_joined = _group_concat(obj_np, mapped_u[t_codes], ",")
            new_names = pd.Series(nn_joined, index=nn_objs, dtype=object)
            replaced_per_obj = pd.Series(
                np.bincount(obj_np[in_map], minlength=table.m)
            )
            replaced_per_obj = replaced_per_obj[replaced_per_obj > 0]
        else:
            in_map = np.zeros(0, bool)
            new_names = pd.Series(dtype=object)
            replaced_per_obj = pd.Series(dtype="int64")

        # objects whose raw name is truthy but yields zero tokens still get
        # new_name == "" for diff purposes
        named_objs = np.flatnonzero(
            [(n is not None and n != "") for n in table.names]
        )
        full_new = pd.Series("", index=named_objs, dtype=object)
        full_new.update(new_names)
        raw_names = pd.Series(table.names, dtype=object).iloc[named_objs]

        n_replaced = pd.Series(0, index=named_objs, dtype="int64")
        n_replaced.update(replaced_per_obj)
        do_rename = n_replaced > 0
        totals["replaced_labels"] += int(n_replaced.sum())
        totals["replaced_objects"] += int(do_rename.sum())

        renamed_objs = named_objs[do_rename.to_numpy()]
        rewritten_rows, rewritten_texts = columnar.apply_renames_at(
            table, renamed_objs, full_new.loc[renamed_objs].to_numpy(dtype=object)
        )

        rows_with_replacement[
            np.unique(table.obj_row[renamed_objs])
        ] = True

        # write back through a plain object ndarray: per-cell .iat writes on
        # an Arrow-backed column copy the whole column each time (O(n^2) —
        # 19 s of 33 s at 20k rows, bench_datakit round 2)
        vals = cells.to_numpy(dtype=object, copy=True)
        vals[rewritten_rows] = np.asarray(rewritten_texts, dtype=object)
        # object Series: skip the Arrow-string re-encode of the whole column
        df[col] = pd.Series(vals, dtype=object, index=df.index)

        # diff rows: any object whose display name changed (even reorder-only)
        diff_mask = (raw_names.to_numpy() != full_new.to_numpy())
        if diff_mask.any():
            _ob = lambda a: pd.Series(a, dtype=object)  # skip Arrow re-encode
            dd = pd.DataFrame({
                "obj": named_objs[diff_mask],
                "before": _ob(raw_names.to_numpy()[diff_mask]),
                "after": _ob(full_new.to_numpy()[diff_mask]),
            })
            rows_of = table.obj_row[dd["obj"].to_numpy()]
            order = np.argsort(rows_of, kind="stable")
            rows_sorted = rows_of[order]
            befores = _group_join(
                rows_sorted, dd["before"].to_numpy(dtype=object)[order], "；"
            )
            afters = _group_join(
                rows_sorted, dd["after"].to_numpy(dtype=object)[order], "；"
            )
            diff_records.extend(
                (int(row), col_order, b, a)
                for row, b, a in zip(np.unique(rows_sorted), befores, afters)
            )

    diff_records.sort()
    sources_np = sources.to_numpy(dtype=object)  # per-row .iloc on an Arrow
    if diff_records:                             # column costs a chunk walk
        # columnar assembly: a dict-per-row list costs pandas its
        # list-of-dicts construction path (~8 s at 1M rows, s6 profile)
        d_rows, d_cols, d_before, d_after = map(list, zip(*diff_records))
        _ob = lambda a: pd.Series(a, dtype=object)
        diff_df = pd.DataFrame({
            "source": _ob(sources_np[d_rows]),
            "column": _ob([present_cols[c] for c in d_cols]),
            "before": _ob(d_before),
            "after": _ob(d_after),
        })
    else:  # matches pd.DataFrame([]): zero columns, zero rows
        diff_df = pd.DataFrame()
    sample_diff = [
        {
            "source": sources_np[row], "column": present_cols[c],
            "before": before, "after": after,
        }
        for row, c, before, after in diff_records[:sample_size]
    ]

    output_csv_path = Path(output_csv_path)
    output_csv_path.parent.mkdir(parents=True, exist_ok=True)
    write_csv(df, output_csv_path)

    diff_path = None
    if diff_excel_path:
        diff_path = Path(diff_excel_path)
        xlsx.to_excel(diff_df, diff_path)

    unmatched_path = None
    if unmatched_excel_path:
        unmatched_path = Path(unmatched_excel_path)
        unmatched_df = (
            unmatched.astype("int64")
            .sort_values(ascending=False)
            .rename_axis("标签")
            .reset_index(name="数量")
            if len(unmatched)
            else pd.DataFrame(columns=["标签", "数量"])
        )
        xlsx.to_excel(unmatched_df, unmatched_path)

    summary = {
        "total_rows": len(df),
        "replaced_rows": int(rows_with_replacement.sum()),
        "total_objects": totals["total_objects"],
        "replaced_objects": totals["replaced_objects"],
        "total_labels": totals["total_labels"],
        "replaced_labels": totals["replaced_labels"],
        "invalid_json_rows": totals["invalid_json_rows"],
        "missing_name_objects": totals["missing_name_objects"],
        "mapping_size": len(label_map),
        "unmatched_labels": len(unmatched),
    }
    return {
        "output_csv": output_csv_path,
        "summary": summary,
        "diff": diff_path,
        "unmatched": unmatched_path,
        "sample_diff": sample_diff,
    }


# ---------------------------------------------------------------------------
# Step 7: rule-based category split (columnar row explosion)
# ---------------------------------------------------------------------------


def _read_split_rules(
    rules_excel_path, rule_mode, sheet_name, label_col, category_col
) -> dict:
    rules_df = xlsx.read_workbook(rules_excel_path, sheet_name if sheet_name else 0)
    mapping: dict = {}
    if rule_mode == "wide":
        for col in rules_df.columns:
            category = str(col).strip()
            if not category:
                continue
            for cell in rules_df[col].dropna():
                for label in split_label_cell(cell):
                    mapping[label] = category
    elif rule_mode == "two_column":
        labels = rules_df[label_col].astype(str).str.strip()
        cats = rules_df[category_col].astype(str).str.strip()
        valid = (
            (labels != "") & (cats != "")
            & (labels.str.lower() != "nan") & (cats.str.lower() != "nan")
        )
        mapping.update(zip(labels[valid], cats[valid]))
    return mapping


_ERR_BY_STATUS = {
    ROW_NULL: "空数据",
    ROW_INVALID: "JSON解析失败",
    ROW_NON_OBJECT: "objects不是列表",
}


def _group_concat(rows: np.ndarray, toks: np.ndarray, sep: str):
    """Per-row ``sep``-join of sorted unique tokens.

    Equivalent to ``drop_duplicates().sort_values([row, tok]).groupby(row)
    .agg(sep.join)`` but vectorized: tokens factorize to lexicographic ranks,
    (row, rank) keys dedup/sort as one int64 ``np.unique``, and every joined
    string is a slice of ONE big ``sep.join`` (the per-group Python join was
    the hottest profile line of the 1M-row split bench). Returns
    ``(row_ids int64[G], joined list[str][G])``.
    """
    codes, uniq = pd.factorize(toks)
    if not len(uniq):
        return np.zeros(0, np.int64), []
    order = np.argsort(uniq)  # object argsort = Python str comparisons
    rank = np.empty(len(uniq), np.int64)
    rank[order] = np.arange(len(uniq))
    key = np.asarray(rows, np.int64) * len(uniq) + rank[codes]
    skey = np.unique(key)
    g_row = skey // len(uniq)
    toks_sorted = uniq[order][skey % len(uniq)]
    lens = np.fromiter(map(len, toks_sorted), np.int64, len(toks_sorted))
    starts = np.zeros(len(toks_sorted) + 1, np.int64)
    np.cumsum(lens + len(sep), out=starts[1:])
    big = sep.join(toks_sorted)
    bounds = np.flatnonzero(np.r_[True, g_row[1:] != g_row[:-1], True])
    sl = len(sep)
    st = starts.tolist()
    joined = [
        big[st[a]:st[b] - sl]
        for a, b in zip(bounds[:-1].tolist(), bounds[1:].tolist())
    ]
    return g_row[bounds[:-1]], joined


def split_dataset_by_rules(
    input_csv_path: str,
    rules_excel_path: str,
    output_dir: str,
    rule_mode: str = "wide",
    sheet_name: Optional[str] = None,
    label_col: Optional[str] = None,
    category_col: Optional[str] = None,
    json_columns: Optional[list] = None,
    train_ratio: float = 0.8,
    val_ratio: float = 0.1,
    test_ratio: float = 0.1,
    random_seed: int = 42,
):
    """Explode rows (object x label -> one single-object row), assign categories
    by rules Excel, shuffle deterministically, write 3-sheet train/val/test
    Excel per category plus unclassified/split_counts audits
    (reference: core/processor.py:654-831).

    Columnar: one table scan of the chosen JSON column; token explosion and
    rule lookup are vectorized; exploded rows materialize via df.take plus a
    single-object span splice per exploded row.
    """
    if not os.path.exists(input_csv_path):
        raise FileNotFoundError(f"输入CSV不存在：{input_csv_path}")
    if not os.path.exists(rules_excel_path):
        raise FileNotFoundError(f"规则Excel不存在：{rules_excel_path}")

    ratio_sum = train_ratio + val_ratio + test_ratio
    train_ratio, val_ratio = train_ratio / ratio_sum, val_ratio / ratio_sum

    df = read_csv(input_csv_path, heavy=_HEAVY_COLS)
    # Arrow-string columns -> object up front: this step is take/iloc/assign
    # heavy over 3x-exploded rows, and pandas-3 Arrow strings pay per-cell
    # chunked-take + re-encode costs there (4.1 s of the 50k bench, round 3);
    # object columns ride plain numpy fancy indexing. Numeric dtypes stay.
    for _c in df.columns:
        if pd.api.types.is_string_dtype(df[_c].dtype):
            df[_c] = pd.Series(
                df[_c].to_numpy(dtype=object), dtype=object, index=df.index
            )
    if json_columns is None:
        json_columns = [c for c in (NEW_LABEL_JSON_COL, LABEL_JSON_COL) if c in df.columns]
    present_cols = [c for c in json_columns if c in df.columns]

    rules = _read_split_rules(
        rules_excel_path, rule_mode, sheet_name, label_col, category_col
    )

    # pick the first non-empty JSON cell per row (reference column priority)
    chosen = pd.Series([None] * len(df), dtype=object)
    for col in present_cols:
        vals = df[col]
        usable = vals.apply(lambda v: isinstance(v, str) and bool(v))
        fill = chosen.isna() & usable
        chosen[fill] = vals[fill]

    table = columnar.build_table(chosen)
    n_objs_per_row = np.diff(table.obj_offsets)

    # --- row-level error classification --------------------------------------
    errors = pd.Series([None] * len(df), dtype=object)
    for status, msg in _ERR_BY_STATUS.items():
        errors[np.flatnonzero(table.status == status)] = msg
    ok = table.status == ROW_OK
    errors[ok & (table.objects_kind == 2)] = "objects不是列表"
    empty_objs = ok & (table.objects_kind != 2) & (n_objs_per_row == 0) & (
        (table.row_flags & columnar.RF_NONDICT_OBJECTS) == 0
    )
    errors[empty_objs] = "标注字段objects为空"
    error_rows = errors.notna().to_numpy()

    # --- object/token explosion ----------------------------------------------
    tf = _token_frame(table)
    tf["row"] = table.obj_row[tf["obj"].to_numpy()]
    tf["category"] = tf["tok"].map(rules)

    has_tokens = np.zeros(table.m, dtype=bool)
    if len(tf):
        has_tokens[tf["obj"].unique()] = True
    noname_objs = np.flatnonzero(~has_tokens)
    noname_rows = table.obj_row[noname_objs] if len(noname_objs) else np.array([], np.int64)

    classified = tf[tf["category"].notna()]
    unruled = tf[tf["category"].isna()]

    # per-row raw label combo (sorted unique tokens, "，"-joined)
    combos = np.full(len(df), "", dtype=object)
    if len(tf):
        c_rows, c_joined = _group_concat(
            tf["row"].to_numpy(), tf["tok"].to_numpy(), "，"
        )
        combos[c_rows] = c_joined

    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)

    # --- exploded classified rows --------------------------------------------
    exploded = None
    if len(classified):
        take_idx = classified["row"].to_numpy()
        exploded = df.iloc[take_idx].reset_index(drop=True)
        new_jsons = columnar.extract_single_objects(
            table, classified["obj"].to_numpy(),
            classified["tok"].to_numpy(dtype=object),
        )
        as_obj = lambda vals: pd.Series(
            np.asarray(vals, dtype=object), dtype=object, index=exploded.index
        )
        for col in present_cols:
            exploded[col] = as_obj(new_jsons)
        exploded["分类标签"] = as_obj(classified["tok"].to_numpy())
        exploded["分类类别"] = as_obj(classified["category"].to_numpy())
        exploded["原始标签组合"] = as_obj(combos[take_idx])

    # --- unclassified audit ---------------------------------------------------
    # order key: (row, phase) with phase 0 = row-level error, 1 = per-object/
    # per-token detail, 2 = row-level "nothing classified"
    uncls_parts: list = []
    if error_rows.any():
        idx = np.flatnonzero(error_rows)
        part = df.iloc[idx].copy()
        part["无法分类原因"] = errors.to_numpy()[idx]
        part["_row"] = idx
        part["_phase"] = 0
        uncls_parts.append(part)
    if len(noname_rows):
        part = df.iloc[noname_rows].copy()
        part["无法分类原因"] = "标注框缺少name字段"
        part["_row"] = noname_rows
        part["_phase"] = 1
        uncls_parts.append(part)
    if len(unruled):
        idx = unruled["row"].to_numpy()
        part = df.iloc[idx].copy()
        ur_codes, ur_uniq = pd.factorize(unruled["tok"].to_numpy())
        part["无法分类原因"] = pd.Series(
            np.array([f"标签{t}未在规则中定义" for t in ur_uniq], object)[ur_codes],
            dtype=object, index=part.index,
        )
        part["无法分类标签"] = pd.Series(
            unruled["tok"].to_numpy(dtype=object), dtype=object, index=part.index
        )
        part["_row"] = idx
        part["_phase"] = 1
        uncls_parts.append(part)

    # rows that produced no classified object at all (and weren't error rows)
    classified_rows = np.zeros(len(df), dtype=bool)
    if len(classified):
        classified_rows[classified["row"].unique()] = True
    reasons_by_row = np.full(len(df), "", dtype=object)
    if len(unruled):
        # reason text is a pure function of the token: format per UNIQUE token
        # once, broadcast by factorize codes, then group-concat by reason text
        u_codes, u_uniq = pd.factorize(unruled["tok"].to_numpy())
        u_reasons = np.array(
            [f"标签{t}未在规则中定义" for t in u_uniq], dtype=object
        )[u_codes]
        r_rows, r_joined = _group_concat(
            unruled["row"].to_numpy(), u_reasons, "；"
        )
        reasons_by_row[r_rows] = r_joined
    nothing_rows = np.flatnonzero(~classified_rows & ~error_rows)
    if len(nothing_rows):
        part = df.iloc[nothing_rows].copy()
        fallback_reason = reasons_by_row[nothing_rows]
        part["无法分类原因"] = np.where(
            fallback_reason == "", "标签无法匹配规则", fallback_reason
        )
        part["_row"] = nothing_rows
        part["_phase"] = 2
        uncls_parts.append(part)

    if uncls_parts:
        uncls_df = pd.concat(uncls_parts, ignore_index=True)
        uncls_df = uncls_df.sort_values(["_row", "_phase"], kind="stable")
        uncls_df = uncls_df.drop(columns=["_row", "_phase"]).reset_index(drop=True)
    else:
        uncls_df = pd.DataFrame()

    # --- split_counts audit ----------------------------------------------------
    expand_counts = np.zeros(len(df), dtype=np.int64)
    if len(classified):
        vc = classified["row"].value_counts()
        expand_counts[vc.index.to_numpy()] = vc.to_numpy()
    statuses = np.where(
        error_rows, "否",
        np.where(
            ~classified_rows, "否",
            np.where(reasons_by_row != "", "部分可分类", "是"),
        ),
    )
    _obj = lambda a: pd.Series(np.asarray(a, dtype=object), dtype=object)
    split_counts_df = pd.DataFrame({
        "source": df["source"].reset_index(drop=True)
        if "source" in df.columns else None,
        "原始标签组合": _obj(np.where(error_rows, "", combos)),
        "拆分条数": expand_counts,
        "是否可分类": _obj(statuses),
        "无法分类原因": _obj(np.where(
            error_rows, errors.fillna("").to_numpy(), reasons_by_row
        )),
    })

    # --- per-category shuffle + 3-way split -----------------------------------
    category_files = []
    category_counts: dict = {}
    if exploded is not None:
        for category, cat_df in exploded.groupby("分类类别", sort=False):
            cat_df = cat_df.sample(frac=1, random_state=random_seed).reset_index(drop=True)
            category_counts[str(category)] = len(cat_df)
            n_total = len(cat_df)
            n_train = int(n_total * train_ratio)
            n_val = int(n_total * val_ratio)
            out_path = output_dir / f"{safe_filename(str(category))}.xlsx"
            xlsx.write_workbook(out_path, {
                "train": cat_df.iloc[:n_train],
                "val": cat_df.iloc[n_train:n_train + n_val],
                "test": cat_df.iloc[n_train + n_val:],
            })
            category_files.append(out_path)

    unclassified_path = output_dir / "unclassified.xlsx"
    xlsx.to_excel(uncls_df, unclassified_path)
    split_counts_path = output_dir / "split_counts.xlsx"
    xlsx.to_excel(split_counts_df, split_counts_path)

    return {
        "output_dir": output_dir,
        "category_files": category_files,
        "unclassified": unclassified_path,
        "split_counts": split_counts_path,
        "summary": {
            "categories": len(category_counts),
            "classified": sum(category_counts.values()),
            "unclassified": len(uncls_df),
            "category_counts": category_counts,
        },
    }


# ---------------------------------------------------------------------------
# Unclassified summarizer
# ---------------------------------------------------------------------------


def summarize_unclassified(
    unclassified_excel_path: str,
    output_dir: str,
    json_columns: Optional[list] = None,
):
    """Aggregate unclassified rows by reason/label into a 3-sheet summary Excel
    (reference: core/processor.py:833-891). Vectorized: reason/label columns
    are histogrammed via pandas value_counts instead of a row loop."""
    if not os.path.exists(unclassified_excel_path):
        raise FileNotFoundError(f"无法分类文件不存在：{unclassified_excel_path}")

    df = xlsx.read_workbook(unclassified_excel_path, 0)
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)

    reason_col = "无法分类原因"
    reasons = (
        df[reason_col] if reason_col in df.columns
        else pd.Series(["未知原因"] * len(df))
    ).fillna("未知原因").astype(str)

    reason_counts = reasons.value_counts().rename_axis("原因").reset_index(name="数量")

    # label per row: explicit 无法分类标签 tokens, else the label embedded in a
    # "标签X未在规则中定义" reason, else the "无标签" bucket. Tokenize per
    # UNIQUE cell value (they repeat heavily) and build the flat (label,
    # reason) pairs with one chain + repeat instead of a row loop.
    tl = np.empty(len(df), dtype=object)
    if "无法分类标签" in df.columns:
        codes, uniq = pd.factorize(
            df["无法分类标签"].to_numpy(dtype=object), use_na_sentinel=False
        )
        u_lists: list = []
        for v in uniq:
            s = (
                str(v)
                if v is not None and not (isinstance(v, float) and pd.isna(v))
                else ""
            )
            u_lists.append(
                [t.strip() for t in re.split(SEP_PATTERN, s) if t and t.strip()]
                if s else []
            )
        ua = np.empty(len(u_lists), dtype=object)
        ua[:] = u_lists
        tl[:] = ua[codes]
    else:
        tl[:] = [[]] * len(df)

    from_reason = reasons.str.extract(r"^标签(.+?)(?:未在规则中定义)$", expand=False)
    counts = np.fromiter(map(len, tl), np.int64, len(tl))
    empty_rows = np.flatnonzero(counts == 0)
    if len(empty_rows):
        fb = from_reason.fillna("无标签").to_numpy(dtype=object)
        for i in empty_rows.tolist():
            tl[i] = (fb[i],)
        counts[empty_rows] = 1
    from itertools import chain

    flat = np.empty(int(counts.sum()), dtype=object)
    flat[:] = list(chain.from_iterable(tl))
    pair_df = pd.DataFrame({
        "标签": pd.Series(flat, dtype=object),
        "原因": pd.Series(
            np.repeat(reasons.to_numpy(dtype=object), counts), dtype=object
        ),
    })

    label_summary = (
        pair_df["标签"].value_counts().rename_axis("标签").reset_index(name="数量")
        if len(pair_df) else pd.DataFrame(columns=["标签", "数量"])
    )
    reason_label_summary = (
        pair_df.value_counts().rename_axis(["标签", "原因"]).reset_index(name="数量")
        .sort_values("数量", ascending=False)
        if len(pair_df) else pd.DataFrame(columns=["标签", "原因", "数量"])
    )

    out_path = output_dir / "unclassified_summary.xlsx"
    xlsx.write_workbook(out_path, {
        "reason_summary": reason_counts,
        "label_summary": label_summary,
        "reason_label": reason_label_summary,
    })
    return out_path

"""Processing-pipeline page.

Re-implements the reference page (ui/pages/processing.py:297-667) with the
same session-state keys (step_done/logs/outputs/config/input_ready/
output_root/preview_path), artifact filenames (merged_result.csv,
deduplicate_result.csv, filtered_main.csv, processed_replaced_ptlist.csv,
high_iou_*.csv, other_data.csv, split_by_category/, yolo_datasets/) and step
gating — but the step expanders are driven by one declarative STEP_SPECS
table instead of copy-pasted blocks, and downstream invalidation clears both
step flags and output keys (the reference's output clearing was dead code,
SURVEY known-bugs list).
"""

from __future__ import annotations

import io
import shutil
import zipfile
from contextlib import redirect_stdout
from pathlib import Path

import pandas as pd

from ...config import STEP_ORDER
from ...core.processor import (
    deduplicate_csv_by_source,
    download_and_draw_annotations,
    filter_by_box_count_and_iou,
    generate_yolo_datasets_from_excels,
    merge_all_csv_in_folder,
    overwrite_reference_with_result,
    process_csv_replace_ptlist,
    remove_duplicates_between_csv,
    replace_labels_by_mapping,
    split_dataset_by_rules,
    summarize_unclassified,
    summarize_yolo_label_counts,
)
from ...core.utils import (
    format_int,
    format_ratio,
    get_row_count,
    list_excel_files,
    safe_dataframe,
    save_upload,
    save_uploads,
)
from ..components import (
    STEP_LABELS,
    render_dependency_graph,
    render_file_tiles,
    render_stats_cards,
    render_stepper,
    step_status_chip,
)

# outputs keys invalidated when a step re-runs (everything downstream)
_STEP_OUTPUT_KEYS = {
    "merge": ["merged"],
    "dedup": ["dedup"],
    "ref_filter": ["filtered"],
    "replace_ptlist": ["processed", "processed_excluded"],
    "iou_filter": ["high_iou", "other"],
    "label_replace": ["label_replaced", "label_replace_diff", "label_replace_unmatched"],
    "split": ["split_dir", "category_files", "unclassified", "unclassified_summary", "split_counts"],
    "yolo": ["yolo_dir", "yolo_datasets", "yolo_skipped"],
    "download": ["annotated_dir", "download_dir"],
}


def reset_downstream(from_step: str):
    import streamlit as st

    if from_step not in STEP_ORDER:
        return
    for step in STEP_ORDER[STEP_ORDER.index(from_step) + 1 :]:
        st.session_state.step_done.pop(step, None)
        st.session_state.logs.pop(step, None)
        for key in _STEP_OUTPUT_KEYS.get(step, []):
            st.session_state.outputs.pop(key, None)
    if from_step in ("merge", "dedup"):
        st.session_state.logs.pop("update_ref", None)


def compute_progress(config):
    import streamlit as st

    active = ["merge", "dedup", "replace_ptlist", "iou_filter", "split", "yolo"]
    if config.get("use_reference"):
        active.insert(2, "ref_filter")
    if st.session_state.outputs.get("label_map_path"):
        active.insert(active.index("split"), "label_replace")
    if config.get("run_download"):
        active.append("download")
    done = sum(1 for s in active if st.session_state.step_done.get(s))
    return done, max(len(active), 1)


def collect_counts(outputs):
    keys = [
        "merged", "dedup", "filtered", "processed", "processed_excluded",
        "high_iou", "other", "label_replaced", "unclassified",
        "unclassified_summary", "split_counts",
    ]
    return {k: get_row_count(outputs.get(k)) for k in keys}


def get_summary_metrics(counts):
    total = counts.get("merged")
    processed = counts.get("processed")
    high_iou = counts.get("high_iou")
    other = counts.get("other")
    final_total = (high_iou + other) if (high_iou is not None and other is not None) else None
    return [
        ("最终输出行数", format_int(final_total), "高IoU + 其他"),
        ("最终保留率", format_ratio(final_total, total), "最终输出/合并结果"),
        ("高IoU命中率", format_ratio(high_iou, processed), "高IoU/ptList替换结果"),
    ]


def ensure_empty_reference_csv(path_str, template_csv_path=None):
    if not path_str:
        return False, "参考CSV路径为空"
    path = Path(path_str)
    if path.exists():
        return True, None
    try:
        path.parent.mkdir(parents=True, exist_ok=True)
        columns = ["source"]
        if template_csv_path and Path(template_csv_path).exists():
            try:
                columns = list(
                    pd.read_csv(template_csv_path, nrows=0, encoding="utf-8-sig").columns
                )
            except Exception:
                pass
        pd.DataFrame(columns=columns).to_csv(path, index=False, encoding="utf-8-sig")
        return True, f"已自动创建空参考文件：{path}"
    except Exception as exc:
        return False, f"自动创建参考文件失败：{exc}"


def preview_csv(path, label: str):
    import streamlit as st

    if not path or not Path(path).exists():
        return
    st.write(f"{label}：`{path}`")
    try:
        if str(path).lower().endswith((".xlsx", ".xls")):
            from ...utils import xlsx

            df = xlsx.read_workbook(path, 0).head(200)
        else:
            df = pd.read_csv(path, nrows=200, encoding="utf-8-sig")
        st.dataframe(safe_dataframe(df), use_container_width=True)
    except Exception as exc:
        st.warning(f"预览失败：{exc}")


def run_step(step_key, step_name, func, *args, **kwargs):
    import streamlit as st

    buffer = io.StringIO()
    busy = st.empty()
    busy.markdown(
        f"<div class='busy-indicator'>正在执行：{step_name} "
        "<span class='busy-dots'><span></span><span></span><span></span></span></div>",
        unsafe_allow_html=True,
    )
    with st.spinner(""):
        with redirect_stdout(buffer):
            result = func(*args, **kwargs)
    busy.empty()
    st.session_state.logs[step_key] = buffer.getvalue()
    st.success(f"{step_name} 完成")
    return result


def show_logs(step_key, step_name):
    import streamlit as st

    logs = st.session_state.logs.get(step_key)
    if logs:
        st.text_area(f"{step_name} 日志", logs, height=180)


def build_export_zip(outputs, include_images=False, only_classification=False):
    buffer = io.BytesIO()
    with zipfile.ZipFile(buffer, "w", zipfile.ZIP_DEFLATED) as zf:
        if not only_classification:
            for key in [
                "merged", "dedup", "filtered", "processed", "high_iou", "other",
                "label_replaced", "label_replace_diff", "label_replace_unmatched",
                "unclassified", "unclassified_summary", "split_counts",
            ]:
                path = outputs.get(key)
                if path and Path(path).exists():
                    zf.write(path, arcname=f"csv/{Path(path).name}")
        else:
            for key in ["unclassified", "unclassified_summary", "split_counts"]:
                path = outputs.get(key)
                if path and Path(path).exists():
                    zf.write(path, arcname=f"categories/{Path(path).name}")
        for path in outputs.get("category_files") or []:
            if path and Path(path).exists():
                zf.write(path, arcname=f"categories/{Path(path).name}")
        if include_images:
            for folder, prefix in [
                (outputs.get("download_dir"), "images/downloaded"),
                (outputs.get("annotated_dir"), "images/annotated"),
            ]:
                if folder and Path(folder).exists():
                    for fp in Path(folder).glob("*"):
                        if fp.is_file():
                            zf.write(fp, arcname=f"{prefix}/{fp.name}")
    buffer.seek(0)
    return buffer


def _file_info_from_upload(f):
    size = getattr(f, "size", None)
    if size is None:
        try:
            size = len(f.getbuffer())
        except Exception:
            size = 0
    return {"name": f.name, "size_kb": size / 1024,
            "type": getattr(f, "type", "未知类型") or "未知类型"}


def _file_info_from_path(p: Path):
    try:
        size = p.stat().st_size
    except Exception:
        size = 0
    return {"name": p.name, "size_kb": size / 1024,
            "type": p.suffix.lower().lstrip(".") or "文件"}


def _render_sidebar(root: Path):
    """Config sidebar; returns the raw widget values dict."""
    import streamlit as st

    v = {}
    with st.sidebar:
        st.markdown("<div class='sidebar-title'>配置中心</div>", unsafe_allow_html=True)
        st.caption("输出目录（固定，覆盖旧结果）")
        st.code(str(root))

        v["uploaded_csvs"] = st.file_uploader(
            "上传待处理CSV（支持多文件）", type=["csv"], accept_multiple_files=True
        )
        input_dir = root / "input_csvs"
        existing = sorted(input_dir.glob("*.csv")) if input_dir.exists() else []
        if v["uploaded_csvs"]:
            render_file_tiles("已上传主CSV", [_file_info_from_upload(f) for f in v["uploaded_csvs"]])
        elif existing:
            render_file_tiles("已保存主CSV", [_file_info_from_path(p) for p in existing])
            st.caption("未重新上传，默认使用已保存的主CSV文件。")

        v["use_reference"] = st.checkbox("启用参考CSV去重", value=True)
        v["ref_mode"] = st.radio("参考CSV来源", ["上传参考CSV", "使用已有路径"], horizontal=True)
        v["ref_uploaded"] = None
        v["ref_path"] = None
        v["ref_fallback"] = None
        if v["ref_mode"] == "上传参考CSV":
            v["ref_uploaded"] = st.file_uploader("上传参考CSV", type=["csv"], key="ref_csv")
            if (root / "reference.csv").exists():
                v["ref_fallback"] = root / "reference.csv"
        else:
            v["ref_path"] = st.text_input("参考CSV路径", value=str(Path.cwd() / "reference.csv"))

        st.markdown("---")
        v["merge_chunk_size"] = st.number_input(
            "合并分块行数", min_value=1000, max_value=500000, value=100000, step=1000
        )
        v["keep_outputs"] = st.checkbox("保留旧输出用于跳过", value=True)

        st.markdown("---")
        v["min_boxes"] = st.number_input("最小标注框数量", min_value=1, max_value=50, value=2)
        v["iou_threshold"] = st.number_input("IoU阈值", min_value=0.0, max_value=1.0, value=0.98, step=0.01)
        v["update_reference"] = st.checkbox("覆盖更新reference.csv", value=False)
        v["backup_reference"] = st.checkbox("更新时备份reference.csv", value=True)

        st.markdown("---")
        v["rule_source"] = st.radio("规则来源", ["上传规则Excel", "指定文件夹"], horizontal=True)
        v["rule_upload"] = None
        v["rule_file_path"] = None
        v["rule_fallback"] = None
        if v["rule_source"] == "上传规则Excel":
            v["rule_upload"] = st.file_uploader("上传分类规则Excel", type=["xlsx", "xls"], key="rule_excel")
            if (root / "classification_rules.xlsx").exists():
                v["rule_fallback"] = root / "classification_rules.xlsx"
        else:
            folder = st.text_input("规则文件夹路径", value=str(Path.cwd()))
            excel_files = list_excel_files(folder)
            if excel_files:
                v["rule_file_path"] = st.selectbox(
                    "选择规则文件", options=[str(p) for p in excel_files],
                    format_func=lambda x: Path(x).name,
                )
        v["rule_mode"] = st.radio("解析方式", ["宽表(类别为列)", "两列映射"], horizontal=True)

        v["train_ratio"] = st.number_input("训练集比例", 0.0, 1.0, 0.8, 0.05)
        v["val_ratio"] = st.number_input("验证集比例", 0.0, 1.0, 0.1, 0.05)
        v["test_ratio"] = st.number_input("测试集比例", 0.0, 1.0, 0.1, 0.05)
        v["random_seed"] = st.number_input("拆分随机种子", 0, 9999, 42, 1)

        st.markdown("---")
        v["label_map_upload"] = st.file_uploader(
            "上传新旧标签对照表Excel", type=["xlsx", "xls"], key="label_map_excel"
        )
        v["label_map_fallback"] = (
            root / "label_mapping.xlsx" if (root / "label_mapping.xlsx").exists() else None
        )

        st.markdown("---")
        v["run_download"] = st.checkbox("下载并绘制标注图片", value=False)
        max_images = st.number_input("最多处理图片数（0表示不限）", 0, 100000, 0, 10)
        v["max_images"] = None if max_images == 0 else int(max_images)

        st.markdown("---")
        v["class_order_text"] = st.text_area("YOLO类顺序（每行一个标签）", value="", height=120)
        v["confirm_input"] = st.button("确认输入并保存", use_container_width=True)
    return v


def _confirm_and_stage_inputs(root: Path, v: dict):
    """Persist uploads + write the canonical config dict into session state."""
    import streamlit as st

    if root.exists() and not v["keep_outputs"]:
        try:
            shutil.rmtree(root)
        except Exception:
            pass
    root.mkdir(parents=True, exist_ok=True)
    input_dir = root / "input_csvs"
    if v["uploaded_csvs"]:
        if input_dir.exists():
            shutil.rmtree(input_dir)
        save_uploads(v["uploaded_csvs"], input_dir)
    else:
        input_dir.mkdir(parents=True, exist_ok=True)
    st.session_state.outputs["input_dir"] = input_dir

    ref_path_value = None
    if v["use_reference"]:
        if v["ref_mode"] == "上传参考CSV":
            if v["ref_uploaded"]:
                ref_path_value = root / "reference.csv"
                save_upload(v["ref_uploaded"], ref_path_value)
            else:
                ref_path_value = v["ref_fallback"]
        else:
            ref_path_value = Path(v["ref_path"])
            ensure_empty_reference_csv(str(ref_path_value))
    st.session_state.outputs["ref_path"] = ref_path_value

    rule_path_value = None
    if v["rule_source"] == "上传规则Excel":
        if v["rule_upload"]:
            rule_path_value = root / "classification_rules.xlsx"
            save_upload(v["rule_upload"], rule_path_value)
        else:
            rule_path_value = v["rule_fallback"]
    elif v["rule_file_path"]:
        rule_path_value = Path(v["rule_file_path"])
    st.session_state.outputs["rule_path"] = rule_path_value

    label_map_path_value = None
    if v["label_map_upload"]:
        label_map_path_value = root / "label_mapping.xlsx"
        save_upload(v["label_map_upload"], label_map_path_value)
    else:
        label_map_path_value = v["label_map_fallback"]
    st.session_state.outputs["label_map_path"] = label_map_path_value

    st.session_state.config = {
        "use_reference": v["use_reference"],
        "update_reference": v["update_reference"],
        "backup_reference": v["backup_reference"],
        "merge_chunk_size": int(v["merge_chunk_size"]),
        "keep_outputs": bool(v["keep_outputs"]),
        "min_boxes": int(v["min_boxes"]),
        "iou_threshold": float(v["iou_threshold"]),
        "run_download": v["run_download"],
        "max_images": v["max_images"],
        "ref_mode": v["ref_mode"],
        "rule_mode": v["rule_mode"],
        "rule_sheet": None,
        "rule_label_col": None,
        "rule_category_col": None,
        "label_map_sheet": None,
        "label_map_old_col": None,
        "label_map_new_col": None,
        "train_ratio": float(v["train_ratio"]),
        "val_ratio": float(v["val_ratio"]),
        "test_ratio": float(v["test_ratio"]),
        "random_seed": int(v["random_seed"]),
        "class_order": [
            line.strip() for line in v["class_order_text"].splitlines() if line.strip()
        ],
    }
    st.session_state.input_ready = True
    st.session_state.step_done = {}
    st.session_state.logs = {}


def render_output_preview(outputs):
    import streamlit as st

    preview_items = [
        ("合并结果", outputs.get("merged")),
        ("去重结果", outputs.get("dedup")),
        ("参考去重结果", outputs.get("filtered")),
        ("ptList替换结果", outputs.get("processed")),
        ("ptList未筛选", outputs.get("processed_excluded")),
        ("高IoU结果", outputs.get("high_iou")),
        ("其他数据", outputs.get("other")),
        ("标签替换结果", outputs.get("label_replaced")),
        ("标签替换差异", outputs.get("label_replace_diff")),
        ("标签替换未匹配", outputs.get("label_replace_unmatched")),
        ("无法分类数据", outputs.get("unclassified")),
        ("无法分类汇总", outputs.get("unclassified_summary")),
        ("拆分条数统计", outputs.get("split_counts")),
        ("YOLO跳过清单", outputs.get("yolo_skipped")),
    ]
    available = [(l, p) for l, p in preview_items if p and Path(p).exists()]
    if not available:
        st.info("暂无可预览的输出文件。")
        return
    st.markdown("**输出预览（点击查看）**")
    half = (len(available) + 1) // 2
    cols = st.columns(2)
    for col, chunk in zip(cols, (available[:half], available[half:])):
        with col:
            for label, path in chunk:
                if st.button(f"预览 {label}", key=f"preview_{label}"):
                    st.session_state.preview_path = path
    if st.session_state.get("preview_path"):
        preview_csv(Path(st.session_state.preview_path), "当前预览")


def render_processing_pipeline():
    import streamlit as st

    st.markdown("<div class='hero-title'>YOLO 数据处理流水线</div>", unsafe_allow_html=True)
    st.caption("合并CSV → 按source去重 → 参考去重 → 替换ptList → IoU筛选 → 标签替换 → 图片标注")

    root = Path(st.session_state.output_root)
    st.session_state.setdefault("preview_path", None)

    v = _render_sidebar(root)
    if v["confirm_input"]:
        _confirm_and_stage_inputs(root, v)

    if not st.session_state.input_ready:
        st.info("请在左侧配置区完成输入并点击“确认输入并保存”。")
        return

    config = st.session_state.config
    outputs = st.session_state.outputs
    counts = collect_counts(outputs)

    st.markdown("---")
    st.markdown("**运行概览**")
    left, right = st.columns([2, 1])
    with left:
        st.markdown(
            f"<div class='glow-frame'><div class='glow-inner'>"
            f"<div class='kpi'>运行ID</div>"
            f"<div style='font-size:1.1rem;font-weight:700;'>{st.session_state.run_id}</div>"
            f"<div class='kpi' style='margin-top:8px;'>输出目录</div>"
            f"<div style='font-size:.9rem;'>{root}</div>"
            f"</div></div>",
            unsafe_allow_html=True,
        )
    with right:
        done, total = compute_progress(config)
        st.markdown(
            f"<div class='glow-frame'><div class='glow-inner'>"
            f"<div class='kpi'>流程进度</div>"
            f"<div style='font-size:1.1rem;font-weight:700;'>{done} / {total}</div>"
            f"</div></div>",
            unsafe_allow_html=True,
        )
        st.progress(done / total)

    st.markdown("**步骤进度条**")
    render_stepper(config)
    render_dependency_graph(config)
    st.markdown("**结果指标总览**")
    render_stats_cards(get_summary_metrics(counts))
    render_output_preview(outputs)
    st.markdown("---")

    # ---------------------------------------------------------------- steps
    # Each spec: (num, key, gate_fn, runner, extras_fn). Declarative instead of
    # the reference's duplicated expander blocks.

    def _run_merge():
        merged_csv = root / "merged_result.csv"
        import time as _time

        t0 = _time.time()
        progress_slot = st.empty()

        def cb(file_idx, n_files, name, total_rows, file_rows, chunk_idx,
               file_size, file_bytes, total_bytes, bytes_read):
            with progress_slot.container():
                from ..components import render_merge_eta_card

                render_merge_eta_card(
                    file_idx, n_files, name, total_rows,
                    total_bytes, bytes_read, _time.time() - t0,
                )

        run_step(
            "merge", STEP_LABELS["merge"], merge_all_csv_in_folder,
            str(outputs["input_dir"]), str(merged_csv), "utf-8-sig",
            int(config.get("merge_chunk_size", 100000)), cb,
        )
        progress_slot.empty()
        outputs["merged"] = merged_csv

    def _run_dedup():
        dedup_csv = root / "deduplicate_result.csv"
        run_step("dedup", STEP_LABELS["dedup"], deduplicate_csv_by_source,
                 str(outputs["merged"]), str(dedup_csv))
        outputs["dedup"] = dedup_csv
        if not config.get("use_reference"):
            outputs["filtered"] = dedup_csv
            st.session_state.step_done["ref_filter"] = True

    def _run_ref_filter():
        filtered_csv = root / "filtered_main.csv"
        run_step("ref_filter", STEP_LABELS["ref_filter"], remove_duplicates_between_csv,
                 str(outputs["dedup"]), str(outputs["ref_path"]), str(filtered_csv))
        outputs["filtered"] = filtered_csv
        if config.get("update_reference") and outputs.get("ref_path"):
            ref = Path(outputs["ref_path"])
            if config.get("backup_reference") and ref.exists():
                shutil.copy2(ref, ref.with_suffix(".bak.csv"))
            overwrite_reference_with_result(str(filtered_csv), str(ref))
            st.session_state.logs["update_ref"] = f"reference 已更新：{ref}"

    def _run_replace_ptlist():
        processed_csv = root / "processed_replaced_ptlist.csv"
        excluded_csv = root / "processed_replaced_ptlist_excluded.csv"
        run_step("replace_ptlist", STEP_LABELS["replace_ptlist"], process_csv_replace_ptlist,
                 str(outputs["filtered"]), str(processed_csv), str(excluded_csv))
        outputs["processed"] = processed_csv
        outputs["processed_excluded"] = excluded_csv

    def _run_iou_filter():
        high_iou_csv = root / f"high_iou_{config.get('iou_threshold', 0.98):.2f}.csv"
        other_csv = root / "other_data.csv"
        run_step("iou_filter", STEP_LABELS["iou_filter"], filter_by_box_count_and_iou,
                 str(outputs["processed"]), str(high_iou_csv), str(other_csv),
                 int(config.get("min_boxes", 2)), float(config.get("iou_threshold", 0.98)))
        outputs["high_iou"] = high_iou_csv
        outputs["other"] = other_csv

    def _run_label_replace():
        replaced_csv = root / "other_data_label_replaced.csv"
        diff_xlsx = root / "label_replace_diff.xlsx"
        unmatched_xlsx = root / "label_replace_unmatched.xlsx"
        result = run_step(
            "label_replace", STEP_LABELS["label_replace"], replace_labels_by_mapping,
            str(outputs.get("other")), str(outputs["label_map_path"]), str(replaced_csv),
            config.get("label_map_sheet"), config.get("label_map_old_col"),
            config.get("label_map_new_col"), None, str(diff_xlsx), str(unmatched_xlsx),
        )
        outputs["label_replaced"] = result.get("output_csv", replaced_csv)
        outputs["label_replace_diff"] = result.get("diff")
        outputs["label_replace_unmatched"] = result.get("unmatched")
        if result.get("summary"):
            s = result["summary"]
            render_stats_cards([
                ("替换行数", format_int(s.get("replaced_rows")), "发生替换的行"),
                ("替换标签数", format_int(s.get("replaced_labels")), "被替换标签总数"),
                ("未匹配标签", format_int(s.get("unmatched_labels")), "不在对照表中"),
            ])

    def _split_input():
        if outputs.get("label_map_path") and outputs.get("label_replaced"):
            return outputs.get("label_replaced")
        return outputs.get("other")

    def _run_split():
        split_dir = root / "split_by_category"
        result = run_step(
            "split", STEP_LABELS["split"], split_dataset_by_rules,
            str(_split_input()), str(outputs["rule_path"]), str(split_dir),
            "wide" if config.get("rule_mode") == "宽表(类别为列)" else "two_column",
            config.get("rule_sheet"), config.get("rule_label_col"),
            config.get("rule_category_col"), None,
            float(config.get("train_ratio", 0.8)), float(config.get("val_ratio", 0.1)),
            float(config.get("test_ratio", 0.1)), int(config.get("random_seed", 42)),
        )
        outputs["split_dir"] = split_dir
        outputs["category_files"] = result.get("category_files")
        outputs["unclassified"] = result.get("unclassified")
        outputs["split_counts"] = result.get("split_counts")
        try:
            outputs["unclassified_summary"] = summarize_unclassified(
                str(result.get("unclassified")), str(split_dir)
            )
        except Exception:
            pass

    def _run_yolo():
        yolo_dir = root / "yolo_datasets"
        result = run_step(
            "yolo", STEP_LABELS["yolo"], generate_yolo_datasets_from_excels,
            outputs.get("category_files", []), str(yolo_dir),
            str(yolo_dir / "image_cache"), "source", "分类标签",
            "新_结果字段-目标检测标签配置", "结果字段-目标检测标签配置",
            "width", "height", True, int(config.get("random_seed", 42)),
            config.get("class_order") or None, True,
        )
        outputs["yolo_dir"] = yolo_dir
        outputs["yolo_datasets"] = result.get("datasets")
        outputs["yolo_skipped"] = result.get("skipped")
        stats, flat = summarize_yolo_label_counts(result.get("datasets"))
        if not flat.empty:
            st.dataframe(safe_dataframe(flat), use_container_width=True)

    def _run_download():
        draw_input = outputs.get("label_replaced") or outputs.get("other")
        run_step("download", STEP_LABELS["download"], download_and_draw_annotations,
                 str(draw_input), str(root), None, None, config.get("max_images"), 15)
        outputs["annotated_dir"] = root / "annotated_images"
        outputs["download_dir"] = root / "downloaded_images"

    step_specs = [
        ("Step 1", "merge", lambda: st.session_state.input_ready, _run_merge,
         lambda: (render_stats_cards([("合并行数", format_int(counts.get("merged")), "输出行数")]),
                  preview_csv(outputs.get("merged"), "合并结果"))),
        ("Step 2", "dedup", lambda: st.session_state.step_done.get("merge"), _run_dedup,
         lambda: (render_stats_cards([("去重后行数", format_int(counts.get("dedup")), "去重输出")]),
                  preview_csv(outputs.get("dedup"), "去重结果"))),
        ("Step 3", "ref_filter", lambda: st.session_state.step_done.get("dedup"), _run_ref_filter,
         lambda: (render_stats_cards([("过滤后行数", format_int(counts.get("filtered")), "参考去重输出")]),
                  preview_csv(outputs.get("filtered"), "参考去重结果"))),
        ("Step 4", "replace_ptlist", lambda: st.session_state.step_done.get("ref_filter"), _run_replace_ptlist,
         lambda: preview_csv(outputs.get("processed"), "ptList替换结果")),
        ("Step 5", "iou_filter", lambda: st.session_state.step_done.get("replace_ptlist"), _run_iou_filter,
         lambda: (render_stats_cards([
             ("高IoU行数", format_int(counts.get("high_iou")), "疑似重复标注"),
             ("其他数据行数", format_int(counts.get("other")), "干净数据"),
         ]), preview_csv(outputs.get("high_iou"), "高IoU结果"))),
        ("Step 5.5", "label_replace",
         lambda: st.session_state.step_done.get("iou_filter"), _run_label_replace,
         lambda: preview_csv(outputs.get("label_replaced"), "标签替换结果")),
        ("Step 6", "split",
         lambda: st.session_state.step_done.get(
             "label_replace" if outputs.get("label_map_path") else "iou_filter"
         ),
         _run_split,
         lambda: st.write(f"分类结果目录：{outputs.get('split_dir')}")
         if outputs.get("category_files") else None),
        ("Step 7", "yolo", lambda: st.session_state.step_done.get("split"), _run_yolo,
         lambda: st.write(f"YOLO数据集：{outputs.get('yolo_dir')}")
         if outputs.get("yolo_dir") else None),
        ("Step 8", "download", lambda: st.session_state.step_done.get("yolo"), _run_download,
         lambda: st.write(f"标注图片目录：{outputs.get('annotated_dir')}")
         if outputs.get("annotated_dir") else None),
    ]

    for num, key, gate, runner, extras in step_specs:
        label = STEP_LABELS[key]
        with st.expander(f"{num} {label}", expanded=(key == "merge")):
            if key == "ref_filter" and not config.get("use_reference"):
                st.info("已跳过")
                continue
            if key == "label_replace" and not outputs.get("label_map_path"):
                st.info("未启用")
                continue
            if key == "download" and not config.get("run_download"):
                st.info("已跳过")
                continue
            st.markdown(step_status_chip(key, label), unsafe_allow_html=True)
            if st.button(f"确认并执行 {num}", disabled=not gate(),
                         key=f"run_{key}", use_container_width=True):
                reset_downstream(key)
                runner()
                st.session_state.step_done[key] = True
            if extras:
                extras()
            show_logs(key, label)

    st.markdown("---")
    st.markdown("**结果导出**")
    zip_buffer = build_export_zip(outputs, include_images=config.get("run_download"))
    st.download_button(
        label="下载全部结果 ZIP", data=zip_buffer,
        file_name=f"yolo_pipeline_{st.session_state.run_id}.zip",
        mime="application/zip", use_container_width=True,
    )

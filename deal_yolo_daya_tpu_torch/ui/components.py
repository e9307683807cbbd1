"""Reusable Streamlit widgets (reference: ui/components.py — same component
set: file tiles, ETA card, stat cards, status chips, stepper, dependency
graph, dir tree, confirm dialog, run visualization)."""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

from ..config import STEP_ORDER
from ..utils.formats import format_bytes, format_duration, format_int

STEP_LABELS = {
    "merge": "合并CSV",
    "dedup": "按source去重",
    "ref_filter": "参考CSV去重",
    "replace_ptlist": "替换ptList",
    "iou_filter": "IoU筛选",
    "label_replace": "标签替换",
    "split": "规则分类拆分",
    "yolo": "生成YOLO数据集",
    "download": "下载并绘制标注",
}


def render_file_tiles(title: str, files: List[Dict], columns: int = 4):
    import streamlit as st

    st.markdown(f"**{title}**（{len(files)} 个）")
    cols = st.columns(columns)
    for i, info in enumerate(files):
        with cols[i % columns]:
            st.markdown(
                f"<div class='file-tile'>{info['name']}"
                f"<div class='meta'>{info.get('size_kb', 0):.1f} KB · "
                f"{info.get('type', '文件')}</div></div>",
                unsafe_allow_html=True,
            )


def render_merge_eta_card(
    file_idx, n_files, file_name, total_rows,
    total_bytes, bytes_read, elapsed_s,
):
    """Byte-accurate merge progress: speed + ETA from the 10-arg callback."""
    import streamlit as st

    speed = bytes_read / elapsed_s if elapsed_s > 0 else 0
    remaining = (total_bytes - bytes_read) / speed if speed > 0 else None
    pct = bytes_read / total_bytes if total_bytes else 0
    st.markdown(
        f"<div class='glow-frame'><div class='glow-inner'>"
        f"<div class='kpi'>合并进度 {file_idx}/{n_files} · {file_name}</div>"
        f"<div>已读 {format_bytes(bytes_read)} / {format_bytes(total_bytes)}"
        f" · {format_int(total_rows)} 行 · {format_bytes(speed)}/s"
        f" · 剩余 {format_duration(remaining)}</div>"
        f"</div></div>",
        unsafe_allow_html=True,
    )
    st.progress(min(pct, 1.0))


def render_stats_cards(items: Sequence[Tuple[str, str, str]]):
    import streamlit as st

    cards = "".join(
        f"<div class='stat-card'><div class='kpi'>{label}</div>"
        f"<div class='value'>{value}</div><div class='hint'>{hint}</div></div>"
        for label, value, hint in items
    )
    st.markdown(f"<div class='stat-grid'>{cards}</div>", unsafe_allow_html=True)


def step_status_chip(step_key: str, label: str) -> str:
    import streamlit as st

    done = st.session_state.step_done.get(step_key)
    cls = "done" if done else "todo"
    mark = "✓" if done else "○"
    return f"<span class='status-chip {cls}'>{mark} {label}</span>"


def build_step_model(config: Dict, outputs: Dict) -> List[Dict]:
    """Ordered step descriptors with enabled/optional flags for the stepper."""
    steps = []
    for key in STEP_ORDER:
        enabled = True
        if key == "ref_filter":
            enabled = bool(config.get("use_reference"))
        elif key == "label_replace":
            enabled = bool(outputs.get("label_map_path"))
        elif key == "download":
            enabled = bool(config.get("run_download"))
        steps.append({"key": key, "label": STEP_LABELS[key], "enabled": enabled})
    return steps


def render_stepper(config: Dict):
    import streamlit as st

    steps = build_step_model(config, st.session_state.outputs)
    pills = []
    next_marked = False
    for s in steps:
        if not s["enabled"]:
            pills.append(f"<span class='step-pill skip'>{s['label']}</span>")
            continue
        if st.session_state.step_done.get(s["key"]):
            pills.append(f"<span class='step-pill done'>✓ {s['label']}</span>")
        elif not next_marked:
            pills.append(f"<span class='step-pill next'>▶ {s['label']}</span>")
            next_marked = True
        else:
            pills.append(f"<span class='step-pill'>{s['label']}</span>")
    st.markdown(f"<div class='stepper'>{''.join(pills)}</div>", unsafe_allow_html=True)


def render_dependency_graph(config: Dict):
    """Inline SVG pipeline graph with per-step status coloring."""
    import streamlit as st

    steps = build_step_model(config, st.session_state.outputs)
    w, h, bw, bh = 1200, 90, 118, 36
    gap = (w - len(steps) * bw) / max(len(steps) - 1, 1)
    parts = [f"<svg viewBox='0 0 {w} {h}' xmlns='http://www.w3.org/2000/svg'>"]
    for i, s in enumerate(steps):
        x = i * (bw + gap)
        done = st.session_state.step_done.get(s["key"])
        color = "#22c55e" if done else ("#475569" if not s["enabled"] else "#6366f1")
        parts.append(
            f"<rect x='{x}' y='20' rx='9' width='{bw}' height='{bh}' "
            f"fill='none' stroke='{color}' stroke-width='1.6'/>"
            f"<text x='{x + bw / 2}' y='43' text-anchor='middle' "
            f"font-size='12' fill='{color}'>{s['label']}</text>"
        )
        if i < len(steps) - 1:
            parts.append(
                f"<line x1='{x + bw}' y1='38' x2='{x + bw + gap}' y2='38' "
                f"stroke='#64748b' stroke-width='1.2' marker-end='url(#arr)'/>"
            )
    parts.append(
        "<defs><marker id='arr' viewBox='0 0 10 10' refX='9' refY='5' "
        "markerWidth='6' markerHeight='6' orient='auto'>"
        "<path d='M0,0 L10,5 L0,10 z' fill='#64748b'/></marker></defs></svg>"
    )
    st.markdown("".join(parts), unsafe_allow_html=True)


def render_dir_tree(root: Path, max_depth: int = 3, max_entries: int = 200):
    import streamlit as st

    root = Path(root)
    if not root.exists():
        st.info("目录不存在")
        return
    lines, count = [], 0

    def walk(path: Path, depth: int):
        nonlocal count
        if depth > max_depth or count >= max_entries:
            return
        try:
            children = sorted(path.iterdir(), key=lambda p: (p.is_file(), p.name))
        except Exception:
            return
        for child in children:
            if count >= max_entries:
                return
            indent = "&nbsp;" * 4 * depth
            cls = "dir" if child.is_dir() else ""
            lines.append(f"{indent}<span class='{cls}'>{'📁' if child.is_dir() else '📄'} {child.name}</span>")
            count += 1
            if child.is_dir():
                walk(child, depth + 1)

    walk(root, 0)
    st.markdown(f"<div class='dir-tree'>{'<br/>'.join(lines)}</div>", unsafe_allow_html=True)


def show_confirm_dialog(key: str, message: str) -> bool:
    """Two-step destructive-action confirmation using session state."""
    import streamlit as st

    flag = f"confirm_{key}"
    if st.session_state.get(flag):
        st.warning(message)
        c1, c2 = st.columns(2)
        if c1.button("确认", key=f"{flag}_yes"):
            st.session_state[flag] = False
            return True
        if c2.button("取消", key=f"{flag}_no"):
            st.session_state[flag] = False
        return False
    if st.button("执行", key=f"{flag}_ask"):
        st.session_state[flag] = True
    return False


def render_run_visualization(run_dir: Path):
    """5-tab run viewer: results.csv + charts, confusion matrices, curves,
    val predictions, args.yaml (the §3.5 artifact contract)."""
    import pandas as pd
    import streamlit as st

    run_dir = Path(run_dir)
    tabs = st.tabs(["结果曲线", "混淆矩阵", "PR/F1曲线", "验证集预测", "参数"])

    with tabs[0]:
        results_csv = run_dir / "results.csv"
        if results_csv.exists():
            df = pd.read_csv(results_csv)
            df.columns = [c.strip() for c in df.columns]
            st.dataframe(df, use_container_width=True)
            loss_cols = [c for c in df.columns if "loss" in c]
            map_cols = [c for c in df.columns if "mAP" in c or "precision" in c or "recall" in c]
            if loss_cols:
                st.line_chart(df.set_index("epoch")[loss_cols])
            if map_cols:
                st.line_chart(df.set_index("epoch")[map_cols])
        else:
            st.info("未找到 results.csv")
        if (run_dir / "results.png").exists():
            st.image(str(run_dir / "results.png"))

    with tabs[1]:
        shown = False
        for png in sorted(run_dir.glob("confusion_matrix*.png")):
            st.image(str(png), caption=png.name)
            shown = True
        if not shown:
            st.info("未找到混淆矩阵")

    with tabs[2]:
        shown = False
        for name in ("PR_curve.png", "F1_curve.png", "P_curve.png", "R_curve.png"):
            if (run_dir / name).exists():
                st.image(str(run_dir / name), caption=name)
                shown = True
        if not shown:
            st.info("未找到曲线图")

    with tabs[3]:
        preds = sorted(run_dir.glob("val_batch*_pred.jpg"))
        if preds:
            for p in preds[:4]:
                st.image(str(p), caption=p.name)
        else:
            st.info("未找到验证集预测图")

    with tabs[4]:
        args_yaml = run_dir / "args.yaml"
        if args_yaml.exists():
            st.code(args_yaml.read_text(encoding="utf-8"), language="yaml")
        else:
            st.info("未找到 args.yaml")

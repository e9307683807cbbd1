"""App shell: page config, style injection, session-state init, page router.

Contract with the reference (src/deal_yolo_data/app.py:17-65): the session
keys, their default VALUES (iou 0.98, min_boxes 2, 0.8/0.1/0.1 split,
seed 42, ...), the sidebar labels, and the two page names are all pinned —
tests/test_ui_smoke.py asserts them. The code itself is table-driven: one
defaults table consumed by a loop, one page registry consumed by the router.
"""

from __future__ import annotations

from datetime import datetime
from pathlib import Path

# Pipeline configuration defaults — every value here is part of the UI
# contract (the processing page reads config[...] for its widget initials).
CONFIG_DEFAULTS = dict(
    use_reference=True, update_reference=False, backup_reference=True,
    merge_chunk_size=100_000, keep_outputs=True,
    min_boxes=2, iou_threshold=0.98,
    run_download=False, max_images=None,
    ref_mode="上传参考CSV", rule_mode="宽表(类别为列)",
    train_ratio=0.8, val_ratio=0.1, test_ratio=0.1, random_seed=42,
)

# key -> zero-arg factory producing its default; factories run lazily so a
# rerun never rebuilds (and never re-randomizes) existing state
_SESSION_DEFAULTS = {
    "run_id": lambda: datetime.now().strftime("%Y%m%d_%H%M%S"),
    "step_done": dict,
    "logs": dict,
    "outputs": dict,
    "config": CONFIG_DEFAULTS.copy,
    "input_ready": lambda: False,
}

PAGE_TITLE = "YOLO Data & Training Platform (GPU)"
SIDEBAR_TITLE = "🚀 导航"
PAGE_PICKER_LABEL = "选择功能模块"


def _page_registry():
    from .ui.pages.processing import render_processing_pipeline
    from .ui.pages.training import render_training_platform

    return {
        "数据处理流水线": render_processing_pipeline,
        "YOLO 训练平台": render_training_platform,
    }


def init_session_state():
    import streamlit as st

    for key, make_default in _SESSION_DEFAULTS.items():
        if key not in st.session_state:
            st.session_state[key] = make_default()
    # artifact root depends on run_id, so it initializes after the table
    if "output_root" not in st.session_state:
        st.session_state.output_root = str(
            Path.cwd() / "runs" / st.session_state.run_id
        )


def main():
    import streamlit as st

    from .ui.styles import inject_style

    st.set_page_config(
        page_title=PAGE_TITLE, page_icon="🚀",
        layout="wide", initial_sidebar_state="expanded",
    )
    inject_style()
    init_session_state()

    pages = _page_registry()
    st.sidebar.title(SIDEBAR_TITLE)
    choice = st.sidebar.radio(PAGE_PICKER_LABEL, list(pages))
    render = pages.get(choice)
    if render is not None:
        render()


if __name__ == "__main__":
    main()

"""Training-platform page.

Re-implements the reference page (ui/pages/training.py:187-591) against the
port's Trainer: same template JSON store (runs/train_platform/templates/),
log files (runs/train_platform/logs/), dataset discovery, hyperparameter
surface, thread+queue live-log launch (core.training.run_yolo_training_stream)
and results visualization — with the CUDA panel answered by the port's device
summary and the CUDA_VISIBLE_DEVICES field by a mesh spec.
"""

from __future__ import annotations

import json
import queue
import threading
import time
from datetime import datetime
from pathlib import Path

from ...core.training import (
    LOG_DONE,
    _extract_epoch_info,
    check_train_dependencies,
    collect_run_dirs,
    run_yolo_training,
    run_yolo_training_stream,
)
from ...core.utils import (
    get_cuda_summary,
    get_path_suggestions,
    list_yaml_files,
    parse_kv_lines,
    safe_filename,
    scan_dataset_configs,
    summarize_dataset,
)
from ...utils.fs import collect_image_files
from ..components import render_dir_tree, render_run_visualization

PLATFORM_ROOT = Path("runs/train_platform")
TEMPLATES_DIR = PLATFORM_ROOT / "templates"
LOGS_DIR = PLATFORM_ROOT / "logs"
MAX_LOG_LINES = 800


# ------------------------------------------------- recent / favorite paths

MAX_RECENT_PATHS = 10


def remember_recent_path(path: str):
    """Move `path` to the front of the session's recent-dataset list
    (reference bookkeeping: training.py:46-53)."""
    import streamlit as st

    if not path:
        return
    recent = [p for p in st.session_state.get("train_recent_paths", []) if p != path]
    st.session_state["train_recent_paths"] = [path, *recent][:MAX_RECENT_PATHS]


def favorite_groups() -> dict:
    """Session favorite store: {group_name: [paths]} with a default group
    (reference: training.py:55-85)."""
    import streamlit as st

    return st.session_state.setdefault("train_fav_groups", {"默认": []})


def toggle_favorite_path(path: str, group: str = "默认"):
    import streamlit as st

    groups = favorite_groups()
    bucket = groups.setdefault(group, [])
    if path in bucket:
        bucket.remove(path)
    elif path:
        bucket.append(path)
    st.session_state["train_fav_groups"] = groups


def _render_path_bookmarks(current_path: str) -> str:
    """Recent + favorite dataset-root pickers; returns a path if the user
    picked one, else the input path unchanged."""
    import streamlit as st

    picked = current_path
    recent = st.session_state.get("train_recent_paths", [])
    groups = favorite_groups()
    with st.expander("最近 / 收藏路径", expanded=False):
        if recent:
            r = st.selectbox("最近使用", ["(无)"] + recent, key="train_recent_pick")
            if r != "(无)":
                picked = r
        c1, c2, c3 = st.columns([2, 1, 1])
        with c1:
            group = st.selectbox(
                "收藏分组", list(groups) or ["默认"], key="train_fav_group"
            )
        with c2:
            if st.button("收藏当前路径", use_container_width=True):
                toggle_favorite_path(current_path, group)
        with c3:
            new_group = st.text_input("新建分组", key="train_fav_new_group")
            if st.button("添加分组", use_container_width=True) and new_group:
                groups.setdefault(new_group, [])
                st.session_state["train_fav_groups"] = groups
        favs = groups.get(group, [])
        if favs:
            f = st.selectbox("收藏夹", ["(无)"] + favs, key="train_fav_pick")
            if f != "(无)":
                picked = f
            if st.button("移除所选收藏") and f != "(无)":
                toggle_favorite_path(f, group)
        elif st.button("删除此分组") and group != "默认":
            groups.pop(group, None)
            st.session_state["train_fav_groups"] = groups
    return picked


# ------------------------------------------------------------------ templates

def _list_templates():
    if not TEMPLATES_DIR.exists():
        return []
    return sorted(TEMPLATES_DIR.glob("*.json"))


def _save_template(name: str, payload: dict):
    TEMPLATES_DIR.mkdir(parents=True, exist_ok=True)
    path = TEMPLATES_DIR / f"{safe_filename(name)}.json"
    path.write_text(json.dumps(payload, ensure_ascii=False, indent=2), encoding="utf-8")
    return path


def _load_template(path: Path) -> dict:
    try:
        return json.loads(Path(path).read_text(encoding="utf-8"))
    except Exception:
        return {}


def _render_template_bar():
    import streamlit as st

    with st.expander("训练模板", expanded=False):
        templates = _list_templates()
        c1, c2, c3 = st.columns([2, 1, 1])
        with c1:
            selected = st.selectbox(
                "选择模板", options=["(无)"] + [p.stem for p in templates], key="tpl_select"
            )
        with c2:
            if st.button("加载模板", use_container_width=True) and selected != "(无)":
                tpl = _load_template(TEMPLATES_DIR / f"{selected}.json")
                for k, val in tpl.items():
                    st.session_state[f"train_{k}"] = val
                st.success(f"已加载模板 {selected}")
        with c3:
            if st.button("删除模板", use_container_width=True) and selected != "(无)":
                (TEMPLATES_DIR / f"{selected}.json").unlink(missing_ok=True)
                st.success(f"已删除模板 {selected}")
        name = st.text_input("另存为模板名", key="tpl_name")
        if st.button("保存当前配置为模板") and name:
            payload = {
                k[len("train_"):]: v
                for k, v in st.session_state.items()
                if k.startswith("train_") and isinstance(v, (str, int, float, bool))
            }
            _save_template(name, payload)
            st.success(f"模板已保存：{name}")


# ------------------------------------------------------------------ main page

def render_training_platform():
    import streamlit as st

    st.markdown("<div class='hero-title'>YOLO 训练平台（GPU）</div>", unsafe_allow_html=True)
    st.caption("数据集发现 → 超参配置 → GPU训练 → 实时日志 → 结果可视化")

    missing = check_train_dependencies()
    if missing:
        st.error(f"缺少训练依赖：{', '.join(missing)}")
        return

    _render_template_bar()

    # -------------------------------------------------- dataset discovery
    st.markdown("**数据集**")
    default_root = st.session_state.get("train_dataset_root", str(Path.cwd()))
    dataset_root = st.text_input("数据集根目录", value=default_root, key="train_dataset_root")
    dataset_root = _render_path_bookmarks(dataset_root)
    if Path(dataset_root).is_dir():
        remember_recent_path(dataset_root)
    suggestions = get_path_suggestions(dataset_root)
    if suggestions and len(suggestions) > 1:
        picked = st.selectbox("路径建议", suggestions, key="train_root_suggest")
        if picked != dataset_root:
            dataset_root = picked
    with st.expander("目录浏览", expanded=False):
        render_dir_tree(Path(dataset_root), max_depth=2)

    configs = scan_dataset_configs(dataset_root)
    data_yaml = None
    if configs:
        data_yaml = st.selectbox(
            "发现的数据集配置", [str(p) for p in configs],
            format_func=lambda x: str(Path(x).relative_to(dataset_root))
            if str(x).startswith(str(dataset_root)) else x,
            key="train_data_yaml",
        )
    manual_yaml = st.text_input("或手动输入 data.yaml 路径", key="train_data_yaml_manual")
    if manual_yaml:
        data_yaml = manual_yaml

    if data_yaml:
        info = summarize_dataset(data_yaml)
        if "error" in info:
            st.warning(info["error"])
        else:
            c = st.columns(4)
            c[0].metric("类别数", info.get("nc") or "-")
            c[1].metric("train 图片", info.get("train_images") or 0)
            c[2].metric("val 图片", info.get("val_images") or 0)
            c[3].metric("test 图片", info.get("test_images") or 0)
            with st.expander("样本预览", expanded=False):
                for split in ("train", "val"):
                    files = collect_image_files(Path(info.get(f"{split}_dir", "")), max_images=6)
                    if files:
                        st.caption(split)
                        st.image([str(f) for f in files], width=120)

    # -------------------------------------------------- device panel
    with st.expander("GPU / 设备信息", expanded=False):
        summary = get_cuda_summary()
        if summary.get("available"):
            st.success(f"{summary.get('platform')}: {summary.get('detail')}")
            st.code("\n".join(summary.get("devices", [])))
        else:
            st.warning(summary.get("detail", "无设备"))

    # -------------------------------------------------- hyperparameters
    st.markdown("**训练参数**")
    c1, c2, c3, c4 = st.columns(4)
    model_path = c1.text_input(
        "模型", value="yolo11n", key="train_model",
        help="支持 yolo11 / yolov8 / yolo12 系列 n-x（如 yolo12s、"
             "yolov8m.yaml），或已训练的 best.pt 路径（微调）",
    )
    project = c2.text_input("项目目录", value=str(PLATFORM_ROOT / "runs"), key="train_project")
    run_name = c3.text_input("运行名称", value="train", key="train_name")
    exist_ok = c4.checkbox("覆盖同名运行", value=False, key="train_exist_ok")

    c1, c2, c3, c4 = st.columns(4)
    epochs = c1.number_input("epochs", 1, 10000, 100, key="train_epochs")
    imgsz = c2.number_input("imgsz", 320, 4096, 640, step=32, key="train_imgsz")
    batch = c3.number_input("batch", 1, 1024, 16, key="train_batch")
    workers = c4.number_input("workers(预取深度)", 1, 16, 3, key="train_workers")

    c1, c2, c3, c4 = st.columns(4)
    device = c1.text_input("mesh 设备(如 8 / 4x2 / 空=全部)", value="", key="train_device")
    amp = c2.checkbox("amp (bf16)", value=True, key="train_amp")
    resume = c3.checkbox("resume", value=False, key="train_resume")
    stream_logs = c4.checkbox("实时日志", value=True, key="train_stream")

    c1, c2, c3, c4 = st.columns(4)
    optimizer = c1.selectbox("optimizer", ["auto", "SGD", "AdamW", "Adam"], key="train_optimizer")
    seed = c2.number_input("seed", 0, 9999, 0, key="train_seed")
    patience = c3.number_input("patience", 0, 1000, 100, key="train_patience")
    cos_lr = c4.checkbox("cos_lr", value=False, key="train_cos_lr")

    c1, c2, c3, c4 = st.columns(4)
    close_mosaic = c1.number_input("close_mosaic", 0, 100, 10, key="train_close_mosaic")
    save_period = c2.number_input("save_period(-1关闭)", -1, 100, -1, key="train_save_period")
    cache = c3.selectbox(
        "cache", ["auto", "off", "ram", "device"], key="train_cache",
        help="auto：单设备+device_augment 时数据集常驻 HBM（消除逐步上传，"
             "约 20x epoch 速率）；ram：主机内存缓存解码图",
    )
    do_val = c4.checkbox("val(启用验证)", value=True, key="train_val")
    val_period = c4.number_input(
        "val_period(每N个epoch)", 1, 100, 1, key="train_val_period",
        help="每 N 个 epoch 验证一次（最后一个 epoch 始终验证）；@640 下验证"
             "约占 epoch 墙钟的三分之一，拉大周期可显著提升吞吐",
    )

    with st.expander("数据增强 / 损失增益", expanded=False):
        c1, c2, c3, c4 = st.columns(4)
        mosaic = c1.slider("mosaic", 0.0, 1.0, 1.0, 0.05, key="train_mosaic")
        mixup = c2.slider("mixup", 0.0, 1.0, 0.0, 0.05, key="train_mixup")
        scale_a = c3.slider("scale", 0.0, 0.9, 0.5, 0.05, key="train_scale")
        translate = c4.slider("translate", 0.0, 0.9, 0.1, 0.05, key="train_translate")
        c1, c2, c3, c4 = st.columns(4)
        degrees = c1.slider("degrees", 0.0, 180.0, 0.0, 1.0, key="train_degrees")
        shear = c2.slider("shear", 0.0, 45.0, 0.0, 0.5, key="train_shear")
        fliplr = c3.slider("fliplr", 0.0, 1.0, 0.5, 0.05, key="train_fliplr")
        flipud = c4.slider("flipud", 0.0, 1.0, 0.0, 0.05, key="train_flipud")
        c1, c2, c3 = st.columns(3)
        hsv_h = c1.slider("hsv_h", 0.0, 1.0, 0.015, 0.005, key="train_hsv_h")
        hsv_s = c2.slider("hsv_s", 0.0, 1.0, 0.7, 0.05, key="train_hsv_s")
        hsv_v = c3.slider("hsv_v", 0.0, 1.0, 0.4, 0.05, key="train_hsv_v")
        c1, c2, c3, c4 = st.columns(4)
        box_gain = c1.number_input("box 损失增益", 0.0, 50.0, 7.5, 0.5, key="train_box")
        cls_gain = c2.number_input("cls 损失增益", 0.0, 10.0, 0.5, 0.1, key="train_cls")
        dfl_gain = c3.number_input("dfl 损失增益", 0.0, 10.0, 1.5, 0.1, key="train_dfl")
        dev_aug = c4.selectbox(
            "device_augment", ["auto", "on", "off"], key="train_device_augment",
            help="GPU上执行mosaic/HSV/flip（auto：主机核数<=2时开启）",
        )

    advanced = st.text_area(
        "高级覆盖参数（key=value 每行一个）", key="train_advanced", height=100,
        help="如 lr0=0.01 或 mosaic=0.5；JSON/bool/none/数值自动解析。"
             "仅此处可达的键：async_ckpt、keep_last、max_boxes、"
             "device_augment、donate、profile_steps、cache_budget_gb、"
             "conf、iou、max_det、warmup_epochs、lr0、lrf、momentum、"
             "weight_decay、steps_per_dispatch（每次派发扫描K步）、"
             "remat（大模型大分辨率时以算力换显存）、fold_input_div、"
             "fold_div_barrier（>640 自动开，规避 XLA 编译崩溃）；"
             "batch=-1 时按 HBM 自动选批大小（auto_batch_bytes 可覆盖预算）；"
             "nbs=64 启用 ultralytics 梯度累积节奏；freeze=N 冻结前 N 层；"
             "single_cls、fraction、save_json 同 ultralytics 语义",
    )
    env_text = st.text_input("环境变量（KEY=VALUE，分号分隔）", key="train_env")

    # -------------------------------------------------- launch
    start = st.button("开始训练", type="primary", use_container_width=True)
    if start:
        if not data_yaml or not Path(data_yaml).exists():
            st.error("请先选择有效的 data.yaml")
            return
        overrides, errors = parse_kv_lines(advanced)
        for err in errors:
            st.warning(err)
        train_kwargs = {
            "epochs": int(epochs), "imgsz": int(imgsz), "batch": int(batch),
            "workers": int(workers), "device": device, "amp": bool(amp),
            "optimizer": optimizer, "seed": int(seed), "patience": int(patience),
            "cos_lr": bool(cos_lr), "close_mosaic": int(close_mosaic),
            "save_period": int(save_period), "project": project, "name": run_name,
            "exist_ok": bool(exist_ok), "resume": bool(resume),
            "cache": {"auto": None, "off": False, "ram": True,
                      "device": "device"}[cache],
            "val": bool(do_val),
            "val_period": int(val_period),
            "mosaic": float(mosaic), "mixup": float(mixup),
            "scale": float(scale_a), "translate": float(translate),
            "degrees": float(degrees), "shear": float(shear),
            "fliplr": float(fliplr), "flipud": float(flipud),
            "hsv_h": float(hsv_h), "hsv_s": float(hsv_s), "hsv_v": float(hsv_v),
            "box": float(box_gain), "cls": float(cls_gain), "dfl": float(dfl_gain),
        }
        if dev_aug != "auto":
            train_kwargs["device_augment"] = dev_aug == "on"
        train_kwargs.update(overrides)
        env_vars = {}
        for pair in (env_text or "").split(";"):
            if "=" in pair:
                k, v2 = pair.split("=", 1)
                env_vars[k.strip()] = v2.strip()

        LOGS_DIR.mkdir(parents=True, exist_ok=True)
        log_file = LOGS_DIR / f"{datetime.now().strftime('%Y%m%d_%H%M%S')}_{run_name}.log"

        if stream_logs:
            log_queue: "queue.Queue" = queue.Queue()
            result_holder: dict = {}
            thread = threading.Thread(
                target=run_yolo_training_stream,
                args=(model_path, data_yaml, train_kwargs, env_vars, log_queue, result_holder),
                daemon=True,
            )
            thread.start()
            st.info(f"训练已启动，日志文件：{log_file}")
            log_area = st.empty()
            progress = st.progress(0.0)
            lines: list = []
            with open(log_file, "a", encoding="utf-8") as lf:
                while True:
                    try:
                        item = log_queue.get(timeout=0.2)
                    except queue.Empty:
                        continue
                    if item is LOG_DONE:
                        break
                    lines.append(str(item))
                    lf.write(str(item) + "\n")
                    lf.flush()
                    if len(lines) > MAX_LOG_LINES:
                        lines = lines[-MAX_LOG_LINES:]
                    info = _extract_epoch_info(str(item))
                    if info:
                        progress.progress(min(info[0] / max(info[1], 1), 1.0))
                    log_area.text_area("训练日志", "\n".join(lines), height=320)
            if result_holder.get("error"):
                st.error(f"训练失败：{result_holder['error']}")
            else:
                save_dir = result_holder.get("save_dir")
                st.success(f"训练完成：{save_dir}")
                st.session_state["train_last_run"] = str(save_dir)
        else:
            with st.spinner("训练中（阻塞模式）..."):
                results, log_text, save_dir, error = run_yolo_training(
                    model_path, data_yaml, train_kwargs, env_vars
                )
            log_file.write_text(log_text, encoding="utf-8")
            st.text_area("训练日志", log_text[-20000:], height=320)
            if error:
                st.error(f"训练失败：{error}")
            else:
                st.success(f"训练完成：{save_dir}")
                st.session_state["train_last_run"] = str(save_dir)

    # -------------------------------------------------- results
    st.markdown("---")
    st.markdown("**训练结果可视化**")
    run_dirs = collect_run_dirs(project or str(PLATFORM_ROOT / "runs"))
    if st.session_state.get("train_last_run"):
        last = Path(st.session_state["train_last_run"])
        if last.exists() and last not in run_dirs:
            run_dirs.insert(0, last)
    if run_dirs:
        selected_run = st.selectbox(
            "选择运行", [str(p) for p in run_dirs], key="train_run_select"
        )
        render_run_visualization(Path(selected_run))
    else:
        st.info("暂无已完成的训练运行")

"""Compat facade: the reference's ~40-helper utils surface
(reference: core/utils.py) re-exported from the utils/datakit kit, with the
CUDA probe answered by the port's device summary."""

from ..utils.formats import (  # noqa: F401
    format_bytes,
    format_duration,
    format_int,
    format_ratio,
    safe_dataframe,
)
from ..utils.kv import parse_kv_lines  # noqa: F401
from ..utils.naming import (  # noqa: F401
    safe_filename,
    safe_dataset_dir_name as _safe_dataset_dir_name,
    safe_image_stem as _safe_image_stem,
)
from ..utils.fs import (  # noqa: F401
    collect_dir_paths,
    collect_image_files,
    count_images_in_dir,
    get_csv_columns,
    get_dir_stats,
    get_image_count,
    get_immediate_children_sizes,
    get_path_suggestions,
    get_row_count,
    list_dataset_roots_from_configs,
    list_excel_files,
    list_image_files_for_preview,
    list_immediate_dirs,
    list_subdirectories,
    list_yaml_files,
    load_dataset_yaml,
    scan_dataset_configs,
    search_directories,
    summarize_dataset,
)
from ..datakit.download import download_image, ensure_image_cached as _ensure_image_cached  # noqa: F401
from ..datakit.labels import (  # noqa: F401
    json_to_yolo_annotation,
    split_label_cell as _split_label_cell,
    parse_data_objects as _parse_data_objects,
    split_object_labels as _split_object_labels,
    replace_label_tokens as _replace_label_tokens,
    extract_boxes_with_labels as _extract_boxes_with_labels,
)
from ..parallel.mesh import device_summary as get_device_summary  # noqa: F401

_safe_filename = safe_filename


def get_cuda_summary():
    """Kept under the reference's name; reports the CUDA device inventory
    (reference: core/utils.py:306-315) with the device summary's keys."""
    return get_device_summary()


def check_requirements():
    """Probe the port's required modules."""
    import importlib.util

    missing = []
    for mod in ("torch", "numpy", "pandas", "PIL", "yaml"):
        if importlib.util.find_spec(mod) is None:
            missing.append(mod)
    return missing


def save_upload(uploaded_file, dest_path):
    """Validated save of an uploaded file object (size check, mkdir, post-write
    verification, cleanup on failure — reference: core/utils.py:569-616)."""
    import logging
    from pathlib import Path

    logger = logging.getLogger(__name__)
    dest_path = Path(dest_path)
    if uploaded_file is None:
        logger.error("上传文件为空，无法保存")
        raise ValueError("上传文件不能为空")
    file_size = getattr(uploaded_file, "size", None)
    if file_size == 0:
        raise ValueError(f"上传文件 {uploaded_file.name} 为空")
    try:
        dest_path.parent.mkdir(parents=True, exist_ok=True, mode=0o755)
    except PermissionError as e:
        raise PermissionError(f"无写入权限：{dest_path.parent}") from e
    try:
        with open(dest_path, "wb") as f:
            f.write(uploaded_file.getbuffer())
        saved_size = dest_path.stat().st_size
        if file_size is not None and saved_size != file_size:
            raise RuntimeError(f"文件写入不完整，丢失 {file_size - saved_size} 字节数据")
        return dest_path
    except Exception:
        if dest_path.exists():
            dest_path.unlink()
        raise


def save_uploads(uploaded_files, dest_dir):
    from pathlib import Path

    dest_dir = Path(dest_dir)
    dest_dir.mkdir(parents=True, exist_ok=True)
    return [save_upload(item, dest_dir / item.name) for item in uploaded_files]

"""Filesystem browsing kit for the UI layer (reference: core/utils.py:214-523).

Directory stats, image listing, size ranking, path autocomplete, dir search,
dataset-yaml discovery. Pure host-side helpers, no heavy deps.
"""

from __future__ import annotations

import os
import random
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import yaml

IMAGE_EXTS = {".jpg", ".jpeg", ".png", ".bmp", ".tif", ".tiff", ".webp"}
_YAML_PATTERNS = ["data.yaml", "dataset.yaml", "data.yml", "dataset.yml"]


def list_subdirectories(path_str: str, include_hidden: bool = False, max_items: int = 200) -> List[Path]:
    if not path_str:
        return []
    base = Path(path_str)
    if not base.is_dir():
        return []
    items = [
        p for p in base.iterdir()
        if p.is_dir() and (include_hidden or not p.name.startswith("."))
    ]
    return sorted(items, key=lambda x: x.name.lower())[:max_items]


def list_excel_files(folder_path) -> List[Path]:
    if not folder_path:
        return []
    folder = Path(folder_path)
    if not folder.exists():
        return []
    return sorted(list(folder.glob("*.xlsx")) + list(folder.glob("*.xls")))


def list_yaml_files(path_str: str, max_items: int = 300) -> List[Path]:
    if not path_str:
        return []
    base = Path(path_str)
    if not base.exists():
        return []
    if base.is_file() and base.suffix.lower() in {".yaml", ".yml"}:
        return [base]
    files: List[Path] = []
    for pattern in _YAML_PATTERNS:
        files.extend(base.rglob(pattern))
    return sorted({p.resolve() for p in files if p.is_file()})[:max_items]


scan_dataset_configs = list_yaml_files


def load_dataset_yaml(path_str: str):
    if not path_str:
        return None, "路径为空"
    path = Path(path_str)
    if not path.exists():
        return None, "未找到数据集配置文件"
    try:
        return yaml.safe_load(path.read_text(encoding="utf-8")), None
    except Exception as exc:
        return None, f"读取失败：{exc}"


def count_images_in_dir(dir_path: Optional[Path]):
    if not dir_path or not Path(dir_path).exists():
        return None
    try:
        return sum(
            1 for p in Path(dir_path).iterdir()
            if p.is_file() and p.suffix.lower() in IMAGE_EXTS
        )
    except Exception:
        return None


def _resolve_dataset_root(data: dict, yaml_path: Path) -> Path:
    base_path = yaml_path.parent
    root_value = data.get("path")
    if root_value:
        rv = Path(root_value)
        return rv if rv.is_absolute() else (base_path / rv).resolve()
    return base_path


def summarize_dataset(path_str: str) -> Dict:
    data, err = load_dataset_yaml(path_str)
    if err:
        return {"error": err}
    root_path = _resolve_dataset_root(data, Path(path_str))
    dirs = {s: root_path / str(data.get(s, "")) for s in ("train", "val", "test")}
    return {
        "nc": data.get("nc"),
        "names": data.get("names"),
        "path": str(root_path),
        **{f"{s}_dir": str(d) for s, d in dirs.items()},
        **{f"{s}_images": count_images_in_dir(d) for s, d in dirs.items()},
    }


def list_dataset_roots_from_configs(config_paths) -> List[Path]:
    roots: List[Path] = []
    for path in config_paths:
        try:
            data, err = load_dataset_yaml(str(path))
            if err or not data:
                roots.append(Path(path).parent.resolve())
            else:
                roots.append(_resolve_dataset_root(data, Path(path)))
        except Exception:
            roots.append(Path(path).parent.resolve())
    seen, unique = set(), []
    for item in roots:
        if str(item) not in seen:
            unique.append(item)
            seen.add(str(item))
    return unique


def collect_image_files(dir_path, max_images: int = 24, shuffle: bool = True, recursive: bool = True) -> List[Path]:
    if not dir_path or not Path(dir_path).exists():
        return []
    base = Path(dir_path)
    iterator = base.rglob("*") if recursive else base.iterdir()
    files = [p for p in iterator if p.is_file() and p.suffix.lower() in IMAGE_EXTS]
    if shuffle:
        random.shuffle(files)
    return files[:max_images]


def _scan_entries(dir_path: str):
    """Yield (entry, is_dir) for one directory level via os.scandir.

    Broken symlinks / permission errors degrade to an empty level; type
    probes that fail are skipped, matching the tolerant UI-browser contract
    (behavior parity with the reference browser: core/utils.py:366-403).
    """
    try:
        it = os.scandir(dir_path)
    except OSError:
        return
    with it:
        for entry in it:
            try:
                yield entry, entry.is_dir(follow_symlinks=False)
            except OSError:
                continue


def get_dir_stats(path: Path, recursive: bool = False, max_files: int = 5000, max_depth: int = 6) -> Dict:
    """Aggregate file/dir/byte counts under ``path`` (breadth-first scandir).

    ``recursive=False`` looks one level deep; otherwise levels are visited
    breadth-first down to ``max_depth``, stopping early (``truncated``) once
    the file count exceeds ``max_files``.
    """
    stats = {"files": 0, "dirs": 0, "bytes": 0, "truncated": False}
    root = Path(path)
    if not root.is_dir():
        return stats
    frontier = [str(root)]
    levels_left = 1 if not recursive else max_depth + 1
    while frontier and levels_left > 0:
        levels_left -= 1
        next_frontier: List[str] = []
        for dir_path in frontier:
            for entry, is_dir in _scan_entries(dir_path):
                if is_dir:
                    stats["dirs"] += 1
                    next_frontier.append(entry.path)
                    continue
                if not entry.is_file(follow_symlinks=False):
                    continue
                stats["files"] += 1
                if recursive and stats["files"] > max_files:
                    stats["truncated"] = True
                    return stats
                try:
                    stats["bytes"] += entry.stat().st_size
                except OSError:
                    pass
        frontier = next_frontier
    return stats


def list_image_files_for_preview(path_str: str, recursive: bool, max_files: int) -> List[Dict]:
    base = Path(path_str)
    if not base.is_dir():
        return []
    files: List[Dict] = []

    def _add(p: Path) -> bool:
        try:
            stat = p.stat()
            files.append({"path": str(p), "size": stat.st_size, "mtime": stat.st_mtime})
        except Exception:
            files.append({"path": str(p), "size": 0, "mtime": 0})
        return len(files) >= max_files

    if recursive:
        for root, _, filenames in os.walk(base):
            for name in filenames:
                p = Path(root) / name
                if p.suffix.lower() in IMAGE_EXTS and _add(p):
                    return files
    else:
        for p in base.iterdir():
            if p.is_file() and p.suffix.lower() in IMAGE_EXTS and _add(p):
                break
    return files


def get_immediate_children_sizes(path: Path, max_items: int = 10) -> Tuple[List, List]:
    path = Path(path)
    if not path.is_dir():
        return [], []
    dir_sizes, file_sizes = [], []
    for entry in path.iterdir():
        try:
            if entry.is_dir():
                size = sum(
                    item.stat().st_size for item in entry.iterdir() if item.is_file()
                )
                dir_sizes.append((entry.name, size))
            elif entry.is_file():
                file_sizes.append((entry.name, entry.stat().st_size))
        except Exception:
            (dir_sizes if entry.is_dir() else file_sizes).append((entry.name, 0))
    dir_sizes.sort(key=lambda x: x[1], reverse=True)
    file_sizes.sort(key=lambda x: x[1], reverse=True)
    return dir_sizes[:max_items], file_sizes[:max_items]


def _sorted_subdirs(dir_path: str, include_hidden: bool) -> List[str]:
    names = [
        entry.path for entry, is_dir in _scan_entries(dir_path)
        if is_dir and (include_hidden or not entry.name.startswith("."))
    ]
    names.sort(key=lambda p: os.path.basename(p).lower())
    return names


def collect_dir_paths(root: Path, include_hidden: bool, max_depth: int, max_nodes: int) -> List[str]:
    """Pre-order listing of subdirectory paths, capped by depth and count.

    Iterative: a LIFO stack of (path, depth) seeded with the root's children;
    pushing each node's children in reverse-sorted order yields the same
    name-sorted pre-order a recursive walk would produce.
    """
    paths: List[str] = []
    stack = [(p, 1) for p in reversed(_sorted_subdirs(str(root), include_hidden))]
    while stack and len(paths) < max_nodes:
        dir_path, depth = stack.pop()
        paths.append(dir_path)
        if depth < max_depth:
            stack.extend(
                (p, depth + 1)
                for p in reversed(_sorted_subdirs(dir_path, include_hidden))
            )
    return paths


def list_immediate_dirs(path_str: str, include_hidden: bool = False) -> List[Path]:
    return list_subdirectories(path_str, include_hidden, max_items=10**9)


def get_path_suggestions(current_value: str, include_hidden: bool = False, max_items: int = 50) -> List[str]:
    if not current_value:
        return []
    candidate = Path(os.path.expanduser(current_value))
    parent = candidate if candidate.is_dir() else candidate.parent
    if not parent.exists():
        return []
    suggestions = [str(p) for p in list_immediate_dirs(str(parent), include_hidden)]
    if current_value not in suggestions:
        suggestions.insert(0, current_value)
    return suggestions[:max_items]


def search_directories(root: Path, query: str, include_hidden: bool, max_results: int = 60) -> List[Path]:
    """Case-insensitive substring search over directory names under ``root``.

    Breadth-first scandir traversal (shallow matches surface first), stopping
    at ``max_results``.
    """
    root = Path(root)
    if not root.exists() or not query:
        return []
    needle = query.lower()
    results: List[Path] = []
    frontier = [str(root)]
    while frontier and len(results) < max_results:
        level: List[str] = []
        for dir_path in frontier:
            for entry, is_dir in _scan_entries(dir_path):
                if not is_dir:
                    continue
                if not include_hidden and entry.name.startswith("."):
                    continue
                level.append(entry.path)
                if needle in entry.name.lower():
                    results.append(Path(entry.path))
                    if len(results) >= max_results:
                        return results
        frontier = level
    return results


def get_csv_columns(file_obj_or_path):
    import io
    import pandas as pd

    try:
        if hasattr(file_obj_or_path, "getbuffer"):
            data = io.BytesIO(file_obj_or_path.getbuffer())
            return list(pd.read_csv(data, nrows=1, encoding="utf-8-sig").columns)
        return list(pd.read_csv(file_obj_or_path, nrows=1, encoding="utf-8-sig").columns)
    except Exception:
        return None


def get_row_count(path):
    import pandas as pd
    from . import xlsx

    if not path:
        return None
    p = Path(path)
    if not p.exists():
        return None
    try:
        lower = str(p).lower()
        if lower.endswith((".xlsx", ".xls")):
            return len(xlsx.read_workbook(p, 0))
        if lower.endswith(".csv"):
            with open(p, "r", encoding="utf-8-sig", errors="ignore") as f:
                return max(sum(1 for _ in f) - 1, 0)
        return len(pd.read_csv(p, encoding="utf-8-sig"))
    except Exception:
        return None


def get_image_count(path):
    if not path:
        return None
    p = Path(path)
    if not p.exists():
        return None
    try:
        return len([f for f in p.iterdir() if f.is_file()])
    except Exception:
        return None

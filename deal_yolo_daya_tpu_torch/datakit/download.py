"""Image download & cache.

Idempotent URL->file cache keyed by URL basename, accepting local paths
(reference: core/utils.py:44-55, 726-748) — plus a concurrent prefetch pool:
the reference downloads serially inside the row loop, which is the throughput
ceiling of dataset generation (SURVEY §3.3); here a ThreadPoolExecutor warms
the cache ahead of the row loop.
"""

from __future__ import annotations

import concurrent.futures as cf
import os
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional


def download_image(
    url: str,
    save_path: str,
    timeout: int = 15,
    retries: int = 3,
    backoff: float = 0.5,
) -> bool:
    """Download with up to ``retries`` attempts and exponential backoff.

    The reference performs a single attempt (core/utils.py:44-55); with the
    concurrent prefetcher a transient failure would otherwise silently burn a
    whole split's rows into the skipped audit.
    """
    if Path(save_path).exists():
        return True
    try:
        import requests  # only a URL needs it: local sources never get here
    except ImportError as e:
        raise ImportError(f"downloading {url} needs the 'requests' package") from e
    last_err = None
    for attempt in range(max(1, retries)):
        if attempt:
            time.sleep(backoff * (2 ** (attempt - 1)))
        try:
            response = requests.get(url, stream=True, timeout=timeout)
            response.raise_for_status()
            # temp-file + atomic rename: concurrent downloaders that collide
            # on a basename can never leave a torn/partial file behind
            tmp = f"{save_path}.tmp-{os.getpid()}-{threading.get_ident()}"
            with open(tmp, "wb") as f:
                f.write(response.content)
            os.replace(tmp, save_path)
            return True
        except Exception as e:
            last_err = e
    print(f"\n❌ 图片下载失败 {url}：{last_err}")
    return False


def cache_path_for(source_url: str, cache_dir: Path) -> Optional[Path]:
    """Deterministic cache location for a URL (None for empty sources)."""
    if not source_url:
        return None
    filename = source_url.split("/")[-1]
    if "?" in filename:
        filename = filename.split("?")[0]
    if not filename:
        filename = f"image_{hash(source_url)}.jpg"
    return Path(cache_dir) / filename


def ensure_image_cached(source_url, cache_dir: Path, timeout: int = 15) -> Optional[Path]:
    """Local path if source exists on disk; otherwise download-to-cache."""
    if not source_url:
        return None
    try:
        if Path(str(source_url)).exists():
            return Path(str(source_url))
        cache_path = cache_path_for(str(source_url), cache_dir)
        if cache_path is None:
            return None
        if cache_path.exists() and cache_path.stat().st_size > 0:
            return cache_path
        download_image(str(source_url), str(cache_path), timeout=timeout)
        if cache_path.exists():
            return cache_path
    except ImportError:
        raise  # a URL source on a machine without requests
    except Exception:
        pass
    return None


def prefetch_images(
    sources: Iterable[str],
    cache_dir: Path,
    max_workers: int = 16,
    timeout: int = 15,
) -> Dict[str, Optional[Path]]:
    """Concurrently warm the image cache for many sources.

    Local paths resolve immediately; remote URLs are fetched with up to
    ``max_workers`` parallel connections. Returns {source: local_path_or_None}.
    """
    cache_dir = Path(cache_dir)
    cache_dir.mkdir(parents=True, exist_ok=True)
    unique = [s for s in dict.fromkeys(sources) if s]
    results: Dict[str, Optional[Path]] = {}
    remote = []
    for src in unique:
        p = Path(str(src))
        if p.exists():
            results[src] = p
        else:
            remote.append(src)
    if remote:
        with cf.ThreadPoolExecutor(max_workers=max_workers) as pool:
            futures = {
                pool.submit(ensure_image_cached, src, cache_dir, timeout): src
                for src in remote
            }
            for fut in cf.as_completed(futures):
                src = futures[fut]
                try:
                    results[src] = fut.result()
                except ImportError:
                    raise
                except Exception:
                    results[src] = None
    return results

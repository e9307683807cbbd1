"""Training wrappers with the reference's exact call surface
(reference: core/training.py:49-105) — blocking + streaming (thread/queue log
plumbing, LOG_DONE sentinel, result_holder dict) — but dispatching to the
port's Trainer instead of ``from ultralytics import YOLO``.
"""

from __future__ import annotations

import importlib.util
import io
import os
import queue
import re
from contextlib import redirect_stderr, redirect_stdout
from pathlib import Path

LOG_DONE = object()


class StreamQueueWriter(io.TextIOBase):
    """Text sink that forwards complete lines to a ``queue.Queue``.

    Partial writes accumulate as fragments until a line terminator arrives
    (splitlines-based, so ``\\r`` progress updates also flush as lines).
    """

    def __init__(self, log_queue: "queue.Queue[str]"):
        super().__init__()
        self.log_queue = log_queue
        self._fragments: list = []

    def writable(self) -> bool:
        return True

    def write(self, data) -> int:
        if not data:
            return 0
        text = str(data)
        for piece in text.splitlines(keepends=True):
            self._fragments.append(piece.rstrip("\r\n"))
            if piece != self._fragments[-1]:  # had a terminator
                self._drain()
        return len(text)

    def _drain(self):
        self.log_queue.put("".join(self._fragments))
        self._fragments.clear()

    def flush(self):
        if self._fragments:
            self._drain()

    def close(self):
        # logging handlers may close their stream at interpreter shutdown;
        # stay writable afterwards instead of marking the stream closed
        self.flush()

    def isatty(self) -> bool:
        return False


_EPOCH_RE = re.compile(r"[Ee]poch\s*(\d+)\s*/\s*(\d+)")


def _extract_epoch_info(line: str):
    """(current, total) parsed from an 'Epoch i/N' log line, else None."""
    m = _EPOCH_RE.search(line) if line else None
    return (int(m[1]), int(m[2])) if m else None


def check_train_dependencies():
    """Training stack probe (replaces the reference's ultralytics/torch
    check): modules only. A missing card is not listed: it shows in the
    device panel, and a run asked for the card raises there, so that
    ``device="cpu"`` stays reachable."""
    missing = []
    for mod in ("torch",):
        if importlib.util.find_spec(mod) is None:
            missing.append(mod)
    return missing


def _launch(model_path: str, data_yaml: str, train_kwargs: dict, env_vars: dict):
    if env_vars:
        for key, value in env_vars.items():
            if value:
                os.environ[str(key)] = str(value)
    from ..train.trainer import train_run

    result = train_run(model_path, data_yaml, **(train_kwargs or {}))
    return result, result.get("save_dir")


def run_yolo_training(model_path: str, data_yaml: str, train_kwargs: dict, env_vars: dict):
    """Blocking train; returns (results, captured_log, save_dir, error)."""
    buffer = io.StringIO()
    error = None
    results = None
    save_dir = None
    with redirect_stdout(buffer), redirect_stderr(buffer):
        try:
            results, save_dir = _launch(model_path, data_yaml, train_kwargs, env_vars)
        except Exception as exc:
            error = exc
    return results, buffer.getvalue(), save_dir, error


def run_yolo_training_stream(
    model_path: str,
    data_yaml: str,
    train_kwargs: dict,
    env_vars: dict,
    log_queue: "queue.Queue",
    result_holder: dict,
):
    """Streaming train for a worker thread: stdout/stderr -> line queue,
    results/errors -> shared result_holder, LOG_DONE sentinel at the end."""
    writer = StreamQueueWriter(log_queue)
    with redirect_stdout(writer), redirect_stderr(writer):
        try:
            results, save_dir = _launch(model_path, data_yaml, train_kwargs, env_vars)
            result_holder["save_dir"] = save_dir
            result_holder["results"] = results
        except Exception as exc:
            result_holder["error"] = exc
        finally:
            writer.flush()
            log_queue.put(LOG_DONE)


def collect_run_dirs(root_str: str):
    """Completed run dirs (contain results.csv), newest first."""
    root = Path(root_str) if root_str else None
    if not root or not root.exists():
        return []
    run_dirs = {p.parent.resolve() for p in root.rglob("results.csv")}
    return sorted(run_dirs, key=lambda p: p.stat().st_mtime, reverse=True)

"""Checkpoints written in the background (``TrainConfig.async_ckpt``): the
counterpart of the JAX Trainer's own worker queue (``trainer.py:972-1050``).

``CheckpointWriter.save`` snapshots the state's CUDA tensors on a side
stream: those of a dtype are concatenated on the card and copied, in one
non-blocking copy, into one pinned host buffer a slot (a file name without
its digits: ``last.pt``, ``best.pt``, ``epoch.pt``; made at the slot's
first save and kept, since a pinned allocation or a copy a tensor costs
the caller tens to hundreds of ms over ~2000 tensors). It marks the
snapshot with an event, makes the training stream wait for the copies
(not the host), and queues the write; a background
thread waits for the event, copies each tensor out of the buffer, writes
``<path>.tmp`` with ``torch.save``, ``os.replace``s it into place and runs
the caller's ``after`` (the epoch checkpoints' GC). On the CPU the snapshot
is a copy on the caller's thread. ``flush()`` waits for every queued write
and raises the first error a write met; ``save`` flushes first when its
slot is still being written, and the Trainer flushes before ``train()``
returns and before a resume. ``close()`` flushes and stops the thread.
"""

from __future__ import annotations

import os
import queue
import re
import threading
from pathlib import Path
from typing import Any, Callable, Dict, Optional

import torch

QUEUE_DEPTH = 2  # writes waiting at most (the JAX Trainer's): a third save waits


def snapshot(obj, copy: Callable[[torch.Tensor], torch.Tensor]):
    """A nest of dicts, lists and tuples with ``copy`` applied to each tensor."""
    if isinstance(obj, torch.Tensor):
        return copy(obj)
    if isinstance(obj, dict):
        return {k: snapshot(v, copy) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(snapshot(v, copy) for v in obj)
    return obj


class CheckpointWriter:
    """A bounded queue of checkpoint writes and the thread that does them."""

    def __init__(self):
        self._queue: "queue.Queue" = queue.Queue(maxsize=QUEUE_DEPTH)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._pending: Dict[str, int] = {}
        self._buffers: Dict[str, torch.Tensor] = {}
        self._lock = threading.Lock()

    def save(self, path: Path, state: Dict[str, Any], after: Callable[[], None] = lambda: None):
        """Queue ``state`` (a nest of dicts, lists and tensors, on any device)
        for ``path``; returns once the snapshot is taken (on the card: once
        its copies are queued)."""
        path = Path(path)
        slot = re.sub(r"\d+", "", path.name)
        with self._lock:
            busy = self._pending.get(slot, 0) > 0
        if busy:
            self.flush()
        cuda = [t for t in _tensors(state) if t.is_cuda]
        event = None
        if cuda:
            views = self._views(slot, cuda)
            main = torch.cuda.current_stream(cuda[0].device)
            side = torch.cuda.Stream(cuda[0].device)
            side.wait_stream(main)
            with torch.cuda.stream(side):
                for flat, group in views["groups"]:
                    flat.copy_(torch.cat([t.reshape(-1) for t in group]), non_blocking=True)
                event = torch.cuda.Event()
                event.record(side)
            main.wait_stream(side)  # the next steps write what is being copied
            host = snapshot(state, lambda t: views["of"][id(t)] if t.is_cuda else t.clone())
        else:
            host = snapshot(state, lambda t: t.detach().clone())
        with self._lock:
            self._pending[slot] = self._pending.get(slot, 0) + 1
        if self._thread is None:
            self._thread = threading.Thread(target=self._work, daemon=True,
                                            name="checkpoint-writer")
            self._thread.start()
        self._queue.put((path, slot, host, event, after))

    def _views(self, slot: str, tensors) -> Dict[str, Any]:
        """The pinned buffer of ``slot`` (made again when the sizes change)
        cut into a region a dtype -> {"groups": [(region, its tensors)],
        "of": {id(tensor): its host view}}."""
        groups: Dict[torch.dtype, list] = {}
        for t in tensors:
            groups.setdefault(t.dtype, []).append(t)
        sizes = [-(-sum(t.numel() for t in g) * g[0].element_size() // 64) * 64
                 for g in groups.values()]
        buf = self._buffers.get(slot)
        if buf is None or buf.numel() != sum(sizes):
            buf = self._buffers[slot] = torch.empty(sum(sizes), dtype=torch.uint8,
                                                    pin_memory=True)
        out: Dict[str, Any] = {"groups": [], "of": {}}
        offset = 0
        for (dtype, group), size in zip(groups.items(), sizes):
            n = sum(t.numel() for t in group)
            region = buf[offset:offset + n * group[0].element_size()].view(dtype)
            out["groups"].append((region, group))
            at = 0
            for t in group:
                out["of"][id(t)] = region[at:at + t.numel()].view(t.shape)
                at += t.numel()
            offset += size
        return out

    def _work(self) -> None:
        while True:
            item = self._queue.get()
            try:
                if item is None:
                    return
                path, slot, host, event, after = item
                try:
                    if event is not None:  # out of the pinned buffer, which the next save reuses
                        event.synchronize()
                        host = snapshot(host, lambda t: t.clone())
                    tmp = path.with_suffix(path.suffix + ".tmp")
                    torch.save(host, tmp)
                    os.replace(tmp, path)
                    after()
                except BaseException as exc:  # raised by the next flush()
                    if self._error is None:
                        self._error = exc
                finally:
                    with self._lock:
                        self._pending[slot] -= 1
            finally:
                self._queue.task_done()

    def flush(self) -> None:
        """Wait for every queued write; raise the first error one met."""
        self._queue.join()
        err, self._error = self._error, None
        if err is not None:
            raise err

    def close(self) -> None:
        """Flush, then stop the thread (a later ``save`` starts another)."""
        try:
            self.flush()
        finally:
            if self._thread is not None:
                self._queue.put(None)
                self._thread.join()
                self._thread = None


def _tensors(obj):
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from _tensors(v)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            yield from _tensors(v)

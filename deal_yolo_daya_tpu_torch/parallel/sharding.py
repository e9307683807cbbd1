"""Data parallelism across ranks: the counterpart of
``deal_yolo_daya_tpu/parallel/sharding.py``.

The JAX package shards the batch over the mesh's ``data`` axis, keeps the
parameters replicated and lets XLA insert the collectives, so that its
multi-device step computes the one-device function of the global batch.
Here each rank is a process with one card, and ``DataParallel`` holds the
collectives that step needs, each named for what it carries:

- ``rows``: the rows of a global batch a rank owns (rank r: rows r*B/D ..
  (r+1)*B/D - 1, the layout of ``NamedSharding(mesh, P("data"))``);
- ``gather_rows``: the global raw batch from every rank's rows, one
  ``all_gather`` of their bytes (the on-card augmentation draws partners
  from the whole batch);
- ``all_reduce_``: a SUM in place (the BatchNorm moments, the loss
  normaliser, the flat gradient buffer, the epoch's loss sums);
- ``all_gather``: per-rank pieces stacked (the BatchNorm moments);
- ``broadcast_``: rank 0's tensors to every rank (the state at the start);
- ``decide``: rank 0's Python value to every rank (the run directory, the
  batch of batch=-1, the early-stop decision).

Under NCCL every collective runs on the card and may be captured into a CUDA
graph. Gloo moves CUDA tensors through the host: its ``all_gather`` does not
take CUDA tensors, so under gloo every collective on a CUDA tensor is staged
through a host copy (the two-ranks-on-one-card check of chip_smoke), and a
graph cannot hold it.
"""

from __future__ import annotations

from typing import Any, List, Sequence

import torch
import torch.distributed as dist


class DataParallel:
    """This process's rank of a data-parallel group: ``rank`` of ``world``,
    on ``device``, over ``group`` (the default group when None)."""

    def __init__(self, rank: int, world: int, device: torch.device, group=None):
        self.rank, self.world, self.device, self.group = rank, world, torch.device(device), group
        self.backend = str(dist.get_backend(group))
        # gloo's collectives on CUDA tensors go through host copies
        self.staged = self.backend == "gloo" and self.device.type == "cuda"

    @property
    def capturable(self) -> bool:
        """Whether the collectives can be captured into a CUDA graph."""
        return self.backend == "nccl"

    def rows(self, n: int) -> slice:
        """The rows of a global batch of ``n`` this rank owns."""
        if n % self.world:
            raise ValueError(f"a global batch of {n} does not split over {self.world} ranks")
        b = n // self.world
        return slice(self.rank * b, (self.rank + 1) * b)

    def _host(self, t: torch.Tensor) -> torch.Tensor:
        return t.cpu() if self.staged else t

    def all_reduce_(self, t: torch.Tensor) -> torch.Tensor:
        """SUM over the ranks, in place."""
        buf = self._host(t)
        dist.all_reduce(buf, group=self.group)
        if buf is not t:
            t.copy_(buf)
        return t

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's ``t`` concatenated along dim 0, in rank order."""
        src = self._host(t.contiguous())
        out = torch.empty((self.world * src.shape[0],) + tuple(src.shape[1:]),
                          dtype=src.dtype, device=src.device)
        if self.backend == "nccl":
            dist.all_gather_into_tensor(out, src, group=self.group)
        else:
            dist.all_gather(list(out.chunk(self.world)), src, group=self.group)
        return out.to(t.device) if self.staged else out

    def gather_rows(self, tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Tensors of this rank's b rows (any dtypes) -> the same tensors of
        the world's rows, in rank order: one all_gather of their bytes."""
        b = tensors[0].shape[0]
        parts = [t.contiguous().reshape(b, -1).view(torch.uint8) for t in tensors]
        widths = [p.shape[1] for p in parts]
        both = self.all_gather(torch.cat(parts, 1))
        out, start = [], 0
        for t, w in zip(tensors, widths):
            raw = both[:, start:start + w].contiguous().view(t.dtype)
            out.append(raw.reshape((self.world * b,) + tuple(t.shape[1:])))
            start += w
        return out

    @torch.no_grad()
    def broadcast_(self, tensors: Sequence[torch.Tensor], src: int = 0) -> None:
        """Rank ``src``'s values into every rank's ``tensors``, in place: one
        broadcast a dtype."""
        by_dtype: dict = {}
        for t in tensors:
            by_dtype.setdefault(t.dtype, []).append(t)
        for group in by_dtype.values():
            flat = torch.cat([t.reshape(-1) for t in group])
            buf = self._host(flat)
            dist.broadcast(buf, src, group=self.group)
            if self.rank != src:
                flat.copy_(buf)
                start = 0
                for t in group:
                    t.copy_(flat[start:start + t.numel()].view_as(t))
                    start += t.numel()

    def decide(self, value: Any = None, src: int = 0) -> Any:
        """Rank ``src``'s ``value`` on every rank (a picklable object)."""
        box = [value]
        dist.broadcast_object_list(box, src, group=self.group,
                                   device=self.device if self.backend == "nccl" else None)
        return box[0]


def tp_param_shardings(params: Any, mesh: Any, min_channels: int = 256) -> Any:
    """Tensor parallelism over the mesh's ``model`` axis (the JAX
    ``tp_param_shardings``): not ported yet (ROADMAP.md section 1), so a
    ``model`` axis above 1 raises here, for every caller that takes a mesh;
    with a ``model`` axis of 1 every parameter is replicated (None)."""
    if mesh.shape.get("model", 1) > 1:
        raise NotImplementedError(
            f"a model axis of {mesh.shape['model']} (tensor parallelism) is not ported yet "
            "(ROADMAP.md section 1, 'Tensor parallelism'); use a spec with model axis 1")
    return None

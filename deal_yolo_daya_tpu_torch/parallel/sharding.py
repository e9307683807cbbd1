"""Data and tensor parallelism across ranks: the counterpart of
``deal_yolo_daya_tpu/parallel/sharding.py``.

The JAX package shards the batch over the mesh's ``data`` axis and the wide
conv kernels' output channels over its ``model`` axis
(``tp_param_shardings``), and lets XLA insert the collectives, so that its
multi-device step computes the one-device function of the global batch.
Here each rank is a process with one card, global rank ``d * M + m`` at
place (d, m) of a D x M mesh, and two groups hold the collectives that step
needs, each named for what it carries.

``DataParallel``, the ranks of one model index m (its data group; the whole
world when M is 1):

- ``rows``: the rows of a global batch a rank owns (data index d: rows
  d*B/D .. (d+1)*B/D - 1, the layout of ``NamedSharding(mesh, P("data"))``);
- ``gather_rows``: the global raw batch from every rank's rows, one
  ``all_gather`` of their bytes (the on-card augmentation draws partners
  from the whole batch);
- ``all_reduce_``: a SUM in place (the BatchNorm moments, the loss
  normaliser, the flat gradient buffer, the epoch's loss sums);
- ``all_gather``: per-rank pieces stacked (the BatchNorm moments);
- ``broadcast_``: global rank 0's tensors to every rank of the world (the
  state at the start);
- ``decide``: global rank 0's Python value to every rank of the world (the
  run directory, the batch of batch=-1, the early-stop decision).

``ModelParallel`` (``DataParallel.mp``), the ranks of one data index d (its
model group), under a model axis above 1:

- ``gather_channels``: every rank's output channels of a sharded conv,
  concatenated on dim 1 in model-rank order (``models/blocks.py``);
- ``all_reduce_``: a SUM in place (a sharded conv's input gradient);
- ``all_gather``: per-rank slices stacked on dim 0 (whole weights for
  validation and the checkpoints);
- ``broadcast_``: model rank 0's tensors to its group (the replicated
  gradients, so that the replicas stay bit-identical).

Under NCCL every collective runs on the card and may be captured into a CUDA
graph. Gloo moves CUDA tensors through the host: its ``all_gather`` does not
take CUDA tensors, so under gloo every collective on a CUDA tensor is staged
through a host copy (the ranks sharing one card in chip_smoke), and a graph
cannot hold it. A data group of one rank runs its collectives all the same
(the one-rank NCCL group of chip_smoke's data-parallel phase measures what
they cost), except under a model axis (a 1 x M mesh, ``DataParallel.alone``),
where the step's data-parallel collectives are skipped and each BatchNorm
runs unsynchronised.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn as nn


class _Group:
    """This rank's place ``rank`` of ``world`` in a process group (the
    default group when ``group`` is None) on ``device``."""

    def __init__(self, rank: int, world: int, device: torch.device, group=None):
        self.rank, self.world, self.device, self.group = rank, world, torch.device(device), group
        self.backend = str(dist.get_backend(group))
        # gloo's collectives on CUDA tensors go through host copies
        self.staged = self.backend == "gloo" and self.device.type == "cuda"
        self.alone = False  # a group whose collectives are skipped

    @property
    def capturable(self) -> bool:
        """Whether the collectives can be captured into a CUDA graph."""
        return self.backend == "nccl"

    def _host(self, t: torch.Tensor) -> torch.Tensor:
        return t.cpu() if self.staged else t

    def all_reduce_(self, t: torch.Tensor) -> torch.Tensor:
        """SUM over the group, in place."""
        if self.alone:
            return t
        buf = self._host(t)
        dist.all_reduce(buf, group=self.group)
        if buf is not t:
            t.copy_(buf)
        return t

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's ``t`` concatenated along dim 0, in rank order."""
        if self.alone:
            return t.contiguous()
        src = self._host(t.contiguous())
        out = torch.empty((self.world * src.shape[0],) + tuple(src.shape[1:]),
                          dtype=src.dtype, device=src.device)
        if self.backend == "nccl":
            dist.all_gather_into_tensor(out, src, group=self.group)
        else:
            dist.all_gather(list(out.chunk(self.world)), src, group=self.group)
        return out.to(t.device) if self.staged else out

    def _broadcast(self, tensors: Sequence[torch.Tensor], src: int, mine: bool) -> None:
        """``src``'s (a global rank) values into every rank's ``tensors``, in
        place: one broadcast a dtype; ``mine`` whether this rank is ``src``."""
        by_dtype: dict = {}
        for t in tensors:
            by_dtype.setdefault(t.dtype, []).append(t)
        for group in by_dtype.values():
            flat = torch.cat([t.reshape(-1) for t in group])
            buf = self._host(flat)
            dist.broadcast(buf, src, group=self.group)
            if not mine:
                flat.copy_(buf)
                start = 0
                for t in group:
                    t.copy_(flat[start:start + t.numel()].view_as(t))
                    start += t.numel()


class DataParallel(_Group):
    """This process's rank of a data-parallel group: data index ``rank`` of
    ``world`` (D), on ``device``, over ``group`` (the default group when
    None); ``global_rank`` of ``global_world`` in the whole run, and ``mp``
    its ``ModelParallel`` under a model axis above 1 (else None)."""

    def __init__(self, rank: int, world: int, device: torch.device, group=None,
                 global_rank: Optional[int] = None, global_world: Optional[int] = None,
                 mp: Optional["ModelParallel"] = None):
        super().__init__(rank, world, device, group)
        self.global_rank = rank if global_rank is None else global_rank
        self.global_world = world if global_world is None else global_world
        self.mp = mp
        # the data group of one of a 1 x M mesh: its collectives would only
        # copy (through the host under gloo), so they are skipped
        self.alone = world == 1 and mp is not None

    def rows(self, n: int) -> slice:
        """The rows of a global batch of ``n`` this rank owns."""
        if n % self.world:
            raise ValueError(f"a global batch of {n} does not split over {self.world} ranks")
        b = n // self.world
        return slice(self.rank * b, (self.rank + 1) * b)

    def gather_rows(self, tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Tensors of this rank's b rows (any dtypes) -> the same tensors of
        the world's rows, in rank order: one all_gather of their bytes."""
        if self.alone:
            return list(tensors)
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
        """Global rank ``src``'s values into every rank's ``tensors`` (over
        the whole world), in place: one broadcast a dtype."""
        if self.global_world > 1:
            self.everyone._broadcast(tensors, src, self.global_rank == src)

    @property
    def everyone(self) -> _Group:
        """The whole world of the run (the default group), as a group."""
        return _Group(self.global_rank, self.global_world, self.device)

    def decide(self, value: Any = None, src: int = 0) -> Any:
        """Global rank ``src``'s ``value`` on every rank (a picklable object)."""
        box = [value]
        dist.broadcast_object_list(box, src, device=self.device if self.backend == "nccl"
                                   else None)
        return box[0]


class ModelParallel(_Group):
    """This process's rank of a model group: model index ``rank`` of
    ``world`` (M); ``first`` the global rank of its model index 0."""

    def __init__(self, rank: int, world: int, device: torch.device, group, first: int):
        super().__init__(rank, world, device, group)
        self.first = first

    def own(self, n: int) -> slice:
        """This rank's slice of ``n`` output channels."""
        c = n // self.world
        return slice(self.rank * c, (self.rank + 1) * c)

    def gather_channels(self, t: torch.Tensor) -> torch.Tensor:
        """(B, c, H, W) on every rank -> (B, M*c, H, W), the ranks' channels
        in rank order, in ``t``'s memory format (channels_last stays so):
        one all_gather of the channel-last bytes."""
        cl = t.is_contiguous(memory_format=torch.channels_last) and not t.is_contiguous()
        nhwc = self.all_gather(t.permute(0, 2, 3, 1).unsqueeze(0))  # (M, B, H, W, c)
        b, h, w = t.shape[0], t.shape[2], t.shape[3]
        whole = nhwc.permute(1, 2, 3, 0, 4).reshape(b, h, w, -1).permute(0, 3, 1, 2)
        return whole if cl else whole.contiguous()

    @torch.no_grad()
    def gather_slices(self, tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """This rank's dim-0 slices -> the whole tensors, every rank's slice
        in rank order: one all_gather a dtype."""
        out: List[torch.Tensor] = [None] * len(tensors)
        by_dtype: dict = {}
        for i, t in enumerate(tensors):
            by_dtype.setdefault(t.dtype, []).append(i)
        for idx in by_dtype.values():
            both = self.all_gather(torch.cat([tensors[i].reshape(1, -1) for i in idx], 1))
            start = 0
            for i in idx:
                t = tensors[i]
                out[i] = both[:, start:start + t.numel()].reshape(
                    (self.world * t.shape[0],) + tuple(t.shape[1:]))
                start += t.numel()
        return out

    @torch.no_grad()
    def broadcast_(self, tensors: Sequence[torch.Tensor]) -> None:
        """Model rank 0's values into every rank's ``tensors`` of this group."""
        if self.world > 1:
            self._broadcast(tensors, self.first, self.rank == 0)


def group_ranks(n_data: int, n_model: int) -> Tuple[List[List[int]], List[List[int]]]:
    """The global ranks of a D x M mesh's groups -> (data groups, one a model
    index: the ranks d * M + m of each m; model groups, one a data index: the
    ranks of each d), in the order every rank creates them."""
    data = [[d * n_model + m for d in range(n_data)] for m in range(n_model)]
    model = [[d * n_model + m for m in range(n_model)] for d in range(n_data)]
    return data, model


def _model_axis(mesh: Any) -> int:
    return int(mesh) if isinstance(mesh, int) else int(mesh.shape.get("model", 1))


def tp_param_shardings(model: nn.Module, mesh: Any, min_channels: int = 256) -> Dict[str, int]:
    """Tensor parallelism over the mesh's ``model`` axis (``mesh``, or its
    size M as an int): the JAX ``tp_param_shardings`` rule in PyTorch's OIHW
    layout. A conv weight (``nn.Conv2d``, depthwise ones included) is
    sharded on dim 0, its output channels, when they are at least
    ``min_channels`` and divisible by M; everything else (biases, BatchNorm,
    narrow convs) is replicated. -> {weight name: 0} for the sharded
    weights, in the model's order; empty for a model axis of 1."""
    n_model = _model_axis(mesh)
    if n_model <= 1:
        return {}
    out: Dict[str, int] = {}
    for name, mod in model.named_modules():
        if isinstance(mod, nn.Conv2d):
            o = mod.weight.shape[0]
            if o >= min_channels and o % n_model == 0:
                out[f"{name}.weight" if name else "weight"] = 0
    return out

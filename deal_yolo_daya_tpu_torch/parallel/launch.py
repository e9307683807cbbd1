"""Starting the ranks of a parallel run: one process a card.

``start(mesh, target, args)`` makes this process the first rank of the
mesh that it drives and starts the others of this host with
``torch.multiprocessing`` (spawn), each running ``target(dp, *args)`` with
its ``DataParallel``; they meet at a ``FileStore`` in a fresh temporary
directory (one host) or at the cluster's coordinator (``init_distributed``:
ranks process_id x (local devices) + local rank). The global rank of mesh
place (d, m) is ``d * M + m``, the row-major order of ``mesh.devices`` (the
JAX mesh's); after joining, every rank creates the data groups and then the
model groups of ``sharding.group_ranks`` in the same order, and its
``DataParallel`` carries its data group and, for M > 1, its
``ModelParallel``. A process that ``torchrun`` started joins that group
instead (``current``), with the same layout. A mesh that puts two ranks on
one card takes gloo: NCCL cannot hold two ranks of a group on one card.

The ranks are ``Ranks``: ``close()`` ends this rank's group and waits for
the others; a rank that raised makes ``close()`` raise ``WorkerError`` with
its rank and traceback. This rank joins the group only once every rank it
spawned has reached its own join: a spawned rank that fails or exits before
that ends the start-up at once with its ``WorkerError``, never by the
group's timeout. A rank that died while this one waits in a
collective makes that collective fail (gloo at once, NCCL when the group is
aborted or at its timeout, ``extra["dist_timeout_s"]`` of a Trainer). The
processes are daemons: none outlives this one.

Targets and their arguments must pickle: a spawned rank imports the target's
module afresh, never this process's ``__main__`` state; results travel back
by value (numpy arrays, not tensors).
"""

from __future__ import annotations

import datetime
import os
import queue as queue_mod
import shutil
import tempfile
import threading
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from .mesh import Mesh, cluster
from .sharding import DataParallel, ModelParallel, group_ranks

DEFAULT_TIMEOUT_S = 1800.0
_rank_dp: Optional[DataParallel] = None  # this process's rank, while it is in a group


class WorkerError(RuntimeError):
    """A rank of the run failed; ``rank`` and its ``traceback``."""

    def __init__(self, rank: int, tb: str):
        super().__init__(f"rank {rank} of the parallel run failed:\n{tb}")
        self.rank, self.traceback = rank, tb


def _groups(rank: int, world: int, n_model: int, device: torch.device) -> DataParallel:
    """This rank's ``DataParallel`` once the default group exists, the world
    laid out as a (world / n_model) x n_model mesh: every group of
    ``group_ranks`` is created by every rank, in the same order."""
    global _rank_dp
    if n_model < 1 or world % n_model:
        raise ValueError(f"a model axis of {n_model} does not divide {world} ranks")
    if n_model == 1:
        _rank_dp = DataParallel(rank, world, device)
        return _rank_dp
    d, m = divmod(rank, n_model)
    data_groups, model_groups = group_ranks(world // n_model, n_model)
    made = [dist.new_group(r) for r in data_groups + model_groups]
    mp = ModelParallel(m, n_model, device, made[n_model + d], first=d * n_model)
    _rank_dp = DataParallel(d, world // n_model, device, made[m], global_rank=rank,
                            global_world=world, mp=mp)
    return _rank_dp


def _join_group(rank: int, world: int, device: torch.device, init_method: str,
                backend: str, timeout_s: float, n_model: int = 1,
                joining=None) -> DataParallel:
    """Join the default group, then make this rank's groups; ``joining`` (a
    spawned rank's event) is set once nothing but the group's rendezvous is
    left to fail."""
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(device)
    if joining is not None:
        joining.set()
    kwargs = {}
    if backend == "nccl":
        kwargs["device_id"] = device  # the communicator is made at once, on this card
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=timeout_s), **kwargs)
    return _groups(rank, world, n_model, device)


def _rank_main(rank: int, world: int, device: str, init_method: str, backend: str,
               timeout_s: float, threads: int, target: Callable, args: tuple, results,
               joining, n_model: int = 1) -> None:
    """A spawned rank: join the group, run ``target(dp, *args)``, report."""
    global _rank_dp
    torch.set_num_threads(threads)
    try:
        dp = _join_group(rank, world, torch.device(device), init_method, backend, timeout_s,
                         n_model, joining)
        results.put((rank, True, target(dp, *args)))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise SystemExit(1)
    finally:
        _rank_dp = None
        if dist.is_initialized():
            dist.destroy_process_group()


def current(n_model: int = 1) -> Optional[DataParallel]:
    """The rank of this process when it is already in a group: a rank that
    ``start`` spawned, or one of a ``torchrun`` (``RANK``/``WORLD_SIZE``,
    joined here over ``env://``, on card ``LOCAL_RANK``, its groups made for
    a model axis of ``n_model``). None otherwise."""
    if not dist.is_initialized():
        if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
            return None
        local = int(os.environ.get("LOCAL_RANK", 0))
        device = torch.device("cuda", local) if torch.cuda.is_available() and \
            not os.environ.get("DYD_CPU_DEVICES") else torch.device("cpu")
        if device.type == "cuda":
            torch.cuda.set_device(device)
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                                init_method="env://")
        return _groups(dist.get_rank(), dist.get_world_size(), n_model, device)
    if _rank_dp is not None:
        return _rank_dp
    device = torch.device("cuda", torch.cuda.current_device()) \
        if dist.get_backend() == "nccl" else torch.device("cpu")
    return _groups(dist.get_rank(), dist.get_world_size(), n_model, device)


class Ranks:
    """The ranks of one run, seen from the process that started them: ``dp``
    is this process's rank; ``close()`` ends the run (see the module
    docstring) and returns each spawned rank's result by rank."""

    def __init__(self, world: int, mine: Tuple[int, torch.device],
                 others: Sequence[Tuple[int, torch.device]], init_method: str,
                 backend: str, target: Callable, args: tuple = (),
                 timeout_s: float = DEFAULT_TIMEOUT_S, n_model: int = 1):
        ctx = torch.multiprocessing.get_context("spawn")
        self.results = ctx.Queue()
        self._saved_threads = torch.get_num_threads()
        cpu_ranks = sum(1 for _, d in [mine, *others] if d.type == "cpu")
        threads = max(1, self._saved_threads // max(cpu_ranks, 1))
        self.procs, joining = {}, {}
        for rank, device in others:
            joining[rank] = ctx.Event()
            p = ctx.Process(target=_rank_main, daemon=True, args=(
                rank, world, str(device), init_method, backend, timeout_s, threads, target,
                tuple(args), self.results, joining[rank], n_model))
            p.start()
            self.procs[rank] = p
        self.timeout_s, self.backend = timeout_s, backend
        self.reports: dict = {}
        self._closed = False
        if mine[1].type == "cpu":
            torch.set_num_threads(threads)
        self._watch = threading.Thread(target=self._watchdog, daemon=True)
        self._watch.start()
        try:
            self._await_joining(joining, time.time() + timeout_s)
            self.dp = _join_group(mine[0], world, mine[1], init_method, backend, timeout_s,
                                  n_model)
        except BaseException:
            self.close(failed=True)
            raise

    def _await_joining(self, joining: dict, deadline: float) -> None:
        """Wait, a second at a time, until every spawned rank has reached its
        join. A spawned rank that exits first (a failing one has put its
        report on the queue) or a wait past ``deadline`` raises
        ``WorkerError``, which ``close(failed=True)`` replaces by the rank's
        own report."""
        while True:
            for rank, p in self.procs.items():
                if p.exitcode is not None:
                    raise WorkerError(rank, f"exited with code {p.exitcode} before joining")
            waiting = [r for r, e in joining.items() if not e.is_set()]
            if not waiting:
                return
            if time.time() > deadline:
                raise WorkerError(waiting[0], f"did not join within {self.timeout_s} s")
            joining[waiting[0]].wait(1.0)

    def _watchdog(self) -> None:
        """Abort this rank's group when a spawned rank dies, so that a
        collective waiting for it fails instead of waiting out the timeout."""
        while not self._closed:
            for p in self.procs.values():
                if p.exitcode not in (None, 0):
                    abort = getattr(dist.distributed_c10d, "_abort_process_group", None)
                    if abort is not None and dist.is_initialized() and self.backend == "nccl":
                        try:
                            abort()
                        except Exception:
                            pass
                    return
            time.sleep(0.5)

    def _collect(self, deadline: float) -> None:
        while len(self.reports) < len(self.procs) and time.time() < deadline:
            try:
                rank, ok, payload = self.results.get(timeout=0.5)
                self.reports[rank] = (ok, payload)
            except queue_mod.Empty:
                for rank, p in self.procs.items():
                    if rank not in self.reports and p.exitcode is not None:
                        try:  # a report may still be in the pipe
                            r, ok, payload = self.results.get(timeout=2.0)
                            self.reports[r] = (ok, payload)
                        except queue_mod.Empty:
                            self.reports[rank] = (False, f"exited with code {p.exitcode} "
                                                         "without a report")

    def close(self, failed: bool = False) -> List[Any]:
        """End the run: leave the group, collect every spawned rank's report
        and wait for its exit; returns the spawned ranks' results in rank
        order. Raises ``WorkerError`` for the first rank that failed or did
        not report. With ``failed`` (this rank raised) only a report that
        came before this rank left the group is raised: a rank's error after
        that is this rank's leaving, and the caller raises its own."""
        if self._closed:
            return [self.reports[r][1] for r in sorted(self.reports)]
        self._closed = True
        global _rank_dp
        if failed:  # a rank that failed first has reported by now
            self._collect(time.time() + 3.0)
            first = dict(self.reports)
        if dist.is_initialized():
            dist.destroy_process_group()
        _rank_dp = None
        torch.set_num_threads(self._saved_threads)
        if not failed:  # the others finish their own part
            self._collect(time.time() + self.timeout_s)
        for p in self.procs.values():
            p.join(timeout=10.0 if not failed else 5.0)
            if p.is_alive():
                p.terminate()
                p.join(timeout=5.0)
        reports = first if failed else self.reports
        for rank in sorted(self.procs):
            ok, payload = reports.get(rank, (failed, "no report within the timeout"))
            if not ok:
                raise WorkerError(rank, payload)
        return [self.reports[r][1] for r in sorted(self.reports)]




def rank_devices(mesh: Mesh) -> List[Tuple[int, torch.device]]:
    """This process's (global rank, device) pairs on the mesh: rank
    ``d * M + m`` at place (d, m)."""
    flat = list(mesh.devices.reshape(-1))
    mine = set(id(d) for d in mesh.local_devices())
    return [(r, d.torch_device) for r, d in enumerate(flat) if id(d) in mine]


def default_backend(devices: Sequence[torch.device]) -> str:
    """NCCL on distinct cards; gloo on the CPU and where ranks share a card."""
    devices = [torch.device(d) for d in devices]
    cards = [d for d in devices if d.type == "cuda"]
    return "nccl" if cards and len(set(cards)) == len(devices) else "gloo"


def start(mesh: Mesh, target: Callable, args: tuple = (), backend: Optional[str] = None,
          timeout_s: float = DEFAULT_TIMEOUT_S) -> Ranks:
    """Start this host's ranks of ``mesh`` (see the module docstring): this
    process is the first, the others run ``target(dp, *args)``. ``backend``
    is ``default_backend``'s unless given."""
    local = rank_devices(mesh)
    if not local:
        raise ValueError(f"{mesh} has no device of this process")
    world, n_model = mesh.size, mesh.shape["model"]
    backend = backend or default_backend([d for _, d in local])
    cl = cluster()
    if cl is not None:
        return Ranks(world, local[0], local[1:], f"tcp://{cl.coordinator}", backend, target,
                     args, timeout_s, n_model)
    return start_local(world, [d for _, d in local], target, args, backend, timeout_s, n_model)


def start_local(world: int, devices: Sequence[torch.device], target: Optional[Callable] = None,
                args: tuple = (), backend: Optional[str] = None,
                timeout_s: float = DEFAULT_TIMEOUT_S, n_model: int = 1) -> Ranks:
    """``world`` ranks on this host, rank r on ``devices[r]`` (a card may
    carry several gloo ranks), laid out as a (world / n_model) x n_model
    mesh, meeting at a FileStore in a fresh temporary directory, removed
    when the run closes; ``target`` is what the spawned ranks run (none for
    a group of one)."""
    devices = [torch.device(d) for d in devices]
    backend = backend or default_backend(devices)
    tmp = tempfile.mkdtemp(prefix="dyd_ranks_")
    try:
        ranks = Ranks(world, (0, devices[0]), list(enumerate(devices))[1:],
                      f"file://{os.path.join(tmp, 'store')}", backend, target, args, timeout_s,
                      n_model)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    close = ranks.close

    def close_and_clean(failed: bool = False):
        try:
            return close(failed)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)

    ranks.close = close_and_clean
    return ranks


def run(target: Callable, world: int, devices: Sequence, args: tuple = (),
        backend: Optional[str] = None, timeout_s: float = DEFAULT_TIMEOUT_S,
        n_model: int = 1) -> List[Any]:
    """``target(dp, *args)`` on ``world`` local ranks of a (world / n_model)
    x n_model mesh, this process being rank 0 -> every rank's result in
    rank order."""
    ranks = start_local(world, devices, target, args, backend, timeout_s, n_model)
    try:
        mine = target(ranks.dp, *args)
    except BaseException:
        ranks.close(failed=True)  # a worker's own error, if any, comes first
        raise
    return [mine] + ranks.close()

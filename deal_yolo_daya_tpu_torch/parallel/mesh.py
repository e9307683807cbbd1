"""The device mesh and the cluster: the counterpart of
``deal_yolo_daya_tpu/parallel/mesh.py``.

The JAX package lays its devices out as a ``jax.sharding.Mesh`` with a
``data`` axis (batch sharding, the gradient all-reduce inserted by XLA) and
a ``model`` axis (tensor parallelism). Here a ``Mesh`` is the same (data,
model) array of devices, and a device is a CUDA card of one process. The
Trainer runs one rank a card of the ``data`` axis (``parallel/launch.py``);
a ``model`` axis above 1 is not ported yet (ROADMAP.md section 1).

The device grammar is ``mesh_from_spec``'s, as in the JAX package, with two
of the port's own spellings: ``"cpu"`` (one CPU rank) and ``"0"`` (the
first card; the JAX ``"0"`` builds an empty mesh, a fault of the reference).

The visible devices are the CUDA cards of every process of the cluster
(``init_distributed``), or, where ``DYD_CPU_DEVICES=N`` is set, N CPU
devices of this process: the counterpart of ``jax_num_cpu_devices``, the
substrate the tests run several ranks on. A spec never falls back to the
CPU: asking for more cards than there are raises.
"""

from __future__ import annotations

import os
from typing import Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch


class Device(NamedTuple):
    """One device of the cluster: ``id`` is its place in the global list,
    ``process_index`` the process (host) that drives it, ``local_index`` its
    index there (the CUDA ordinal)."""
    platform: str       # "gpu" or "cpu"
    id: int
    process_index: int
    local_index: int
    kind: str

    @property
    def torch_device(self) -> torch.device:
        return torch.device("cuda", self.local_index) if self.platform == "gpu" \
            else torch.device("cpu")

    def __str__(self) -> str:
        where = f"cuda:{self.local_index}" if self.platform == "gpu" else "cpu"
        return f"{where}@process{self.process_index}"


class Cluster(NamedTuple):
    """Where the processes of a run meet (``init_distributed``): one
    process a host, each driving its local cards."""
    coordinator: str    # host:port of the store
    num_processes: int
    process_id: int


_cluster: Optional[Cluster] = None


def cluster() -> Optional[Cluster]:
    """The cluster ``init_distributed`` joined, or None (one host)."""
    return _cluster


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> bool:
    """Multi-host bring-up, as the JAX ``init_distributed``: the arguments
    fall back to ``DYD_COORDINATOR`` / ``DYD_NUM_PROCESSES`` /
    ``DYD_PROCESS_ID``, one process a host. Returns False, at no cost, when
    neither arguments nor environment are set; idempotent per process.

    After it, the visible devices are every host's cards, and the ranks of a
    run are process_id x (local cards) + local rank: each host process
    starts one rank per local card when a run begins (``parallel/launch.py``),
    and all of them meet at the coordinator's store. A process that
    ``torchrun`` started (``RANK``/``WORLD_SIZE`` in its environment) needs
    none of this: ``launch`` joins that group, the counterpart of
    ``jax.distributed``'s own discovery on pods."""
    global _cluster
    if _cluster is not None:
        return True
    coordinator_address = coordinator_address or os.environ.get("DYD_COORDINATOR")
    env_np = os.environ.get("DYD_NUM_PROCESSES")
    env_pid = os.environ.get("DYD_PROCESS_ID")
    num_processes = num_processes if num_processes is not None else (
        int(env_np) if env_np else None)
    process_id = process_id if process_id is not None else (int(env_pid) if env_pid else None)
    if coordinator_address is None and num_processes is None:
        return False
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError("init_distributed needs the coordinator address, the number of "
                         "processes and this process's id (DYD_COORDINATOR, "
                         "DYD_NUM_PROCESSES, DYD_PROCESS_ID)")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process id {process_id} outside 0..{num_processes - 1}")
    _cluster = Cluster(str(coordinator_address), int(num_processes), int(process_id))
    return True


def local_devices() -> List[Device]:
    """This process's devices: its CUDA cards, or ``DYD_CPU_DEVICES`` CPU
    devices where that is set."""
    pid = _cluster.process_id if _cluster else 0
    n_cpu = os.environ.get("DYD_CPU_DEVICES")
    if n_cpu:
        return [Device("cpu", 0, pid, i, "cpu") for i in range(int(n_cpu))]
    if not torch.cuda.is_available():
        return []
    return [Device("gpu", 0, pid, i, torch.cuda.get_device_name(i))
            for i in range(torch.cuda.device_count())]


def visible_devices() -> List[Device]:
    """Every process's devices, process-major: the JAX ``jax.devices()``.
    Every host is taken to hold as many devices as this one."""
    local = local_devices()
    n_proc = _cluster.num_processes if _cluster else 1
    return [d._replace(id=p * len(local) + d.local_index, process_index=p)
            for p in range(n_proc) for d in local]


def device_summary() -> Dict:
    """The JAX ``device_summary``'s keys over the visible devices."""
    try:
        devs = visible_devices()
    except Exception as exc:  # pragma: no cover
        return {"available": False, "detail": f"CUDA devices unavailable: {exc}"}
    if not devs:
        return {"available": False, "detail": "no device available"}
    kinds: Dict[str, int] = {}
    for d in devs:
        kinds[d.kind] = kinds.get(d.kind, 0) + 1
    return {"available": True, "platform": devs[0].platform,
            "detail": ", ".join(f"{n} x {k}" for k, n in kinds.items()),
            "devices": [str(d) for d in devs], "count": len(devs)}


class Mesh:
    """A (data, model) array of devices, as ``jax.sharding.Mesh`` with axis
    names ("data", "model"): ``shape`` is {"data": n, "model": m},
    ``devices`` the numpy array of ``Device``."""

    axis_names = ("data", "model")

    def __init__(self, devices: np.ndarray):
        self.devices = devices

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def local_devices(self, process_index: Optional[int] = None) -> List[Device]:
        """The mesh's devices that process ``process_index`` (this one by
        default) drives, in mesh order."""
        if process_index is None:
            process_index = _cluster.process_id if _cluster else 0
        return [d for d in self.devices.reshape(-1) if d.process_index == process_index]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={[str(d) for d in self.devices.reshape(-1)]})"


def _as_array(devs: Sequence, n_rows: int, n_cols: int) -> np.ndarray:
    arr = np.empty(len(devs), dtype=object)
    for i, d in enumerate(devs):  # element by element: a Device is a tuple
        arr[i] = d
    return arr.reshape(n_rows, n_cols)


def create_mesh(n_data: Optional[int] = None, n_model: int = 1,
                devices: Optional[Sequence] = None) -> Mesh:
    """Mesh with axes (data, model); all devices on the data axis by
    default; an explicit size smaller than the host takes the first
    devices."""
    devs = list(devices) if devices is not None else visible_devices()
    total = len(devs)
    if n_data is None:
        n_data = total // n_model
    need = n_data * n_model
    if need > total:
        raise ValueError(f"mesh {n_data}x{n_model} needs {need} devices, only {total} available")
    return Mesh(_as_array(devs[:need], n_data, n_model))


def create_hybrid_mesh(n_dcn: int, n_data: int, n_model: int = 1,
                       devices: Optional[Sequence] = None) -> Mesh:
    """Multi-host mesh: an outer data factor of ``n_dcn`` hosts, ``n_data``
    x ``n_model`` on each; both data factors fold into one ``data`` axis,
    host-major, so each host's ranks are neighbours on it."""
    devs = list(devices) if devices is not None else visible_devices()
    total = n_dcn * n_data * n_model
    if total != len(devs):
        raise ValueError(f"mesh {n_dcn}x{n_data}x{n_model}@dcn does not match "
                         f"{len(devs)} devices")
    devs = sorted(devs, key=lambda d: (getattr(d, "process_index", 0), getattr(d, "id", 0)))
    return Mesh(_as_array(devs, n_dcn * n_data, n_model))


def mesh_from_spec(spec: Optional[str] = None, devices: Optional[Sequence] = None) -> Mesh:
    """Parse a mesh spec string over ``devices`` (the visible ones by
    default); None or "" -> all devices on the data axis.

    - ``"8"``          data=8
    - ``"4x2"``        data=4, model=2
    - ``"2x4@dcn"``    2 hosts x 4 data per host (data axis = 8)
    - ``"2x4x2@dcn"``  2 hosts x (4 data x 2 model) per host
    - ``"0"``          the first card (the JAX package builds an empty mesh)
    - ``"cpu"``        one CPU device, whatever is visible
    """
    if not spec:
        return create_mesh(devices=devices)
    text = str(spec).lower().replace(" ", "")
    if text == "cpu":
        return Mesh(_as_array([Device("cpu", 0, 0, 0, "cpu")], 1, 1))
    if text == "0":
        return create_mesh(1, devices=devices)
    hybrid = text.endswith("@dcn")
    if hybrid:
        text = text[: -len("@dcn")]
    parts = [int(p) for p in text.split("x")]
    if hybrid:
        if len(parts) in (2, 3):
            return create_hybrid_mesh(*parts, devices=devices)
        raise ValueError(f"bad @dcn mesh spec: {spec!r}")
    if len(parts) == 1:
        return create_mesh(parts[0], devices=devices)
    return create_mesh(parts[0], parts[1], devices=devices)

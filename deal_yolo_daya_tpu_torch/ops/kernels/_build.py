"""Build the CUDA sources under ``csrc/`` into shared libraries and load them.

Each ``csrc/<name>.cu`` is compiled on its own by ``nvcc`` into
``_build/lib<name>-<hash>.so`` (a plain C interface, loaded with ``ctypes``),
at first use. The hash covers the source, the shared headers
(``csrc/*.cuh``) and the flags, so an edited source builds anew and an
unchanged one is reused. Nothing here runs at import: the
CPU tests import every module on a machine with no ``nvcc``.

``count_launch`` and ``GraphLaunches`` keep each kernel module's launch
counter true under CUDA graphs: a wrapper called while its stream captures
a graph launches nothing then, and the graph's launches are added at each
replay.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

PACKAGE = Path(__file__).resolve().parents[2]
CSRC = PACKAGE / "csrc"
BUILD = PACKAGE / "_build"

ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
COMMON = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# per-source flags: the NMS IoU must round exactly as PyTorch's elementwise ops
EXTRA: Dict[str, List[str]] = {
    "area_attention": [],
    "area_attention_bwd": [],
    "int8_conv": [],
    "nms_suppress": ["-fmad=false"],
    "score_reduce": [],
}

_LIBS: Dict[str, ctypes.CDLL] = {}
_FUNCS: Dict[Tuple[str, str], ctypes._CFuncPtr] = {}
# the counts of the GraphLaunches capturing on each stream (by its handle):
# autograd runs a captured backward on its own thread, on the same stream
_capturing: Dict[int, Dict[Tuple[str, str], int]] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _flags(name: str) -> List[str]:
    return ARCH + COMMON + EXTRA[name]


def library_path(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(_flags(name)).encode())
    return BUILD / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(names: Sequence[str] = tuple(EXTRA)) -> Dict[str, str]:
    """Compile every named source that has no library yet, all ``nvcc``
    processes at once. Returns each compiled source's compiler output (the
    ``-Xptxas -v`` lines: registers, shared memory, spills); raises with the
    compiler's output if any build fails."""
    BUILD.mkdir(parents=True, exist_ok=True)
    nvcc = None
    procs = {}
    for name in names:
        target = library_path(name)
        if target.exists():
            continue
        nvcc = nvcc or nvcc_path()
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD)
        os.close(fd)
        cmd = [nvcc, *_flags(name), "-o", tmp, str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, target)
    logs: Dict[str, str] = {}
    failed = []
    for name, (proc, tmp, target) in procs.items():
        out, _ = proc.communicate()
        logs[name] = out
        if proc.returncode == 0:
            os.replace(tmp, target)  # atomic: a concurrent process never loads half a file
        else:
            os.unlink(tmp)
            failed.append(f"{name}:\n{out}")
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _LIBS[name] = lib
    return lib


def function(name: str, symbol: str, argtypes: Sequence) -> ctypes._CFuncPtr:
    """The C function ``symbol`` of ``csrc/<name>.cu`` returning an int
    error code, its argument types set once, when it is first asked for."""
    fn = _FUNCS.get((name, symbol))
    if fn is None:
        fn = getattr(load(name), symbol)
        fn.argtypes, fn.restype = list(argtypes), ctypes.c_int
        _FUNCS[(name, symbol)] = fn
    return fn


def check(err: int, what: str) -> None:
    """Raise when a C entry point returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def count_launch(module: str, counter: str = "launches") -> None:
    """Add one to the launch counter ``<module>.<counter>`` for a launch of
    its kernel. A launch made while the current stream captures a CUDA
    graph runs nothing yet: it goes to the ``GraphLaunches`` capturing on
    that stream, which adds it at each replay; a capture outside one
    raises."""
    import torch

    if torch.cuda.is_current_stream_capturing():
        counts = _capturing.get(torch.cuda.current_stream().cuda_stream)
        if counts is None:
            raise RuntimeError(f"{module}: a kernel captured into a CUDA graph outside "
                               "GraphLaunches.capture(); its replays would go uncounted")
        counts[(module, counter)] = counts.get((module, counter), 0) + 1
        return
    mod = sys.modules[module]
    setattr(mod, counter, getattr(mod, counter) + 1)


class GraphLaunches:
    """The kernel launches one CUDA graph holds: ``capture()``, entered
    inside ``torch.cuda.graph``'s context (on the capture stream), records
    them; ``replayed()`` after each replay adds them to the kernels'
    counters."""

    def __init__(self):
        self.counts: Dict[Tuple[str, str], int] = {}

    @contextlib.contextmanager
    def capture(self):
        import torch

        stream = torch.cuda.current_stream().cuda_stream
        _capturing[stream] = self.counts
        try:
            yield self
        finally:
            del _capturing[stream]

    def replayed(self) -> None:
        for (module, counter), n in self.counts.items():
            mod = sys.modules[module]
            setattr(mod, counter, getattr(mod, counter) + n)

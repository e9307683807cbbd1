"""Tests of the benchmark's harness. CPU tests run anywhere; tests marked
``card`` need a CUDA card and skip without one (decided in the ``card``
fixture, never at import). On the card: ``python3 -m pytest
benchmark/tests -m card``."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs on the card")
    return torch.device("cuda")


TINY_TRAIN = {"imgsz": 64, "batch": 4, "max_boxes": 16,
              "data": {"images": 16, "aspect": [0.5, 2.0], "boxes": [1, 8], "boxes_mean": 3.0,
                       "box_side": [0.1, 0.8], "classes": 80},
              "max_steps_per_s": 400, "trace_seconds": 1}
TINY_POOL = {"imgsz": 64, "pool": {"images": 8, "long_side": [40, 120], "aspect": [0.5, 2.0]},
             "check_requests": 6, "trace_seconds": 1, "warm_seconds": 0.3, "rate": 60,
             "batch": 4, "max_batch": 4, "sender_threads": 2, "warm_calls": 1}


def tiny(name: str):
    """Overrides that shrink a cell to a CPU test's size."""
    return dict(TINY_TRAIN) if ".train." in name else dict(TINY_POOL)


@pytest.fixture
def cpu_threads():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)

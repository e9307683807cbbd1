"""``tests/torch_deadline.py`` in a child pytest: a test that sleeps past
its deadline (LIMIT cut to 3 s in the child), in its call or in the set-up
of a module's autouse fixture, ends its xdist worker with every thread's
stack printed, and the run goes on to the next test; and every port test
module takes the deadline."""

import os
import subprocess
import sys
import time
from pathlib import Path

import pytest

from tests.torch_deadline import _deadline, _deadline_module  # noqa: F401

REPO = Path(__file__).resolve().parents[1]

SLEEPER = """
import time
from pathlib import Path

import pytest

from tests import torch_deadline
from tests.torch_deadline import _deadline, _deadline_module  # noqa: F401

torch_deadline.LIMIT = 3.0


@pytest.fixture(scope="module", autouse=True)
def _module_setup():
    once = Path(__file__).with_suffix(".slept")  # the replacement worker does not sleep
    if not once.exists():
        once.touch()
        time.sleep({setup_s})


def test_sleeps():
    time.sleep({call_s})


def test_after_it():
    pass
"""


@pytest.mark.parametrize("where, setup_s, call_s", [("test_sleeps", 0, 120),
                                                    ("_module_setup", 120, 0)])
def test_a_test_past_its_deadline_ends_its_worker_alone(tmp_path, where, setup_s, call_s):
    (tmp_path / "test_sleeper.py").write_text(SLEEPER.format(setup_s=setup_s, call_s=call_s))
    t0 = time.time()
    out = subprocess.run([sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
                          "-p", "xdist", "-n", "1", "test_sleeper.py"],
                         cwd=tmp_path, env={**os.environ, "PYTHONPATH": str(REPO)},
                         capture_output=True, text=True, timeout=60)
    took = time.time() - t0
    log = out.stdout + out.stderr
    assert took < 60 and out.returncode == 1, log
    assert "Timeout (0:00:03)!" in log, log
    assert f"in {where}" in log, log  # the sleeping frame
    assert "crashed while running 'test_sleeper.py::test_sleeps'" in log, log
    assert "1 failed, 1 passed" in log, log


def test_every_port_test_module_takes_the_deadline():
    """Every tests/test_torch_*.py but ``test_torch_import.py`` (a test of
    the JAX package's checkpoint reader, from before the port)."""
    missing = [p.name for p in sorted((REPO / "tests").glob("test_torch_*.py"))
               if p.name != "test_torch_import.py"
               and "from tests.torch_deadline import" not in p.read_text()]
    assert missing == []

"""A deadline on each test of a port test module: past ``LIMIT`` seconds
the worker prints every thread's stack to its own stderr and exits, so that
a test stuck waiting on another process, thread, server or child costs one
failed test (xdist names it as the test its worker crashed in) and not the
whole run.

A module takes it by importing both fixtures:

    from tests.torch_deadline import _deadline, _deadline_module  # noqa: F401

``_deadline_module`` arms the timer before the module's other fixtures (a
module's autouse fixtures of one scope set up in the order of their names,
and ``_d`` sorts first), so that the first test's budget covers their
set-up; ``_deadline`` arms it afresh at the end of each test for the next
test's set-up, call and teardown; the module's end cancels it.

LIMIT: the slowest test of these modules, set-up included (junit time),
took at most 143.5 s in three runs of ROADMAP.md's tier-1 command (6
workers on 8 CPU cores; ``test_torch_port_train.py::
test_train_step_assignment_matches_jax``), and 320.0 s while a second copy
of that command loaded the machine; LIMIT is over twice the first and under
the 1470 s limit of the whole run by enough for the run to go on.
"""

from __future__ import annotations

import faulthandler
import sys

import pytest
from _pytest.faulthandler import fault_handler_stderr_fd_key

LIMIT = 480.0


def _arm(config) -> None:
    # the worker's own stderr, as pytest's faulthandler plugin keeps it: the
    # test's captured stream dies with the worker
    out = config.stash.get(fault_handler_stderr_fd_key, sys.__stderr__.fileno())
    faulthandler.dump_traceback_later(LIMIT, exit=True, file=out)


@pytest.fixture(scope="module", autouse=True)
def _deadline_module(pytestconfig):
    _arm(pytestconfig)
    yield
    faulthandler.cancel_dump_traceback_later()


@pytest.fixture(autouse=True)
def _deadline(pytestconfig):
    yield
    _arm(pytestconfig)

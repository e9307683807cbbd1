"""A whole run on the CPU at a tiny size, the harness's look for a card
skipped, with the timed path broken underneath: ``correct`` comes out
false for each fault the cell can have. The sound run beside it reads
every number that its fault breaks under that number's limit."""

import pytest

from benchmark import run as R
from benchmark.lib import faults
from benchmark.tests.conftest import tiny

CASES = [
    ("yolo11n.train.b32", "frozen_state", "change"),
    ("yolo11n.train.b32", "half_batch", "fg"),
    ("yolo11n.train.b32", "weight_lr_column", "change"),
    ("yolo11n.train.b32", "ema_skips_conv_weights", "change"),
    ("yolo12n.train.b32", "frozen_state", "change"),
    ("yolo11n.serve.open", "half_batch", "missed"),
    ("yolo11n.serve.open", "altered_answer", "missed"),
    ("yolo11n.predict.b32", "half_batch", "missed"),
    ("yolo11n.predict.b32", "altered_answer", "missed"),
]


def _run(name, fault=None, seed=23):
    ov = tiny(name)
    if ".serve." in name:
        # full device batches, so that half of one can go missing, and
        # enough of them judged to meet one
        ov.update(rate=400, check_requests=64)
    if fault is None:
        return R.execute(name, seed, 1.0, False, device="cpu", overrides=ov)
    with faults.FAULTS[fault]():
        return R.execute(name, seed, 1.0, False, device="cpu", overrides=ov)


@pytest.mark.parametrize("name,fault,number", CASES, ids=lambda x: str(x))
def test_fault_makes_the_run_incorrect(name, fault, number, cpu_threads):
    bad = _run(name, fault)
    assert not bad.correct
    assert bad.readings[number] > bad.limit(number)
    good = _run(name)
    assert good.readings[number] <= good.limit(number)


@pytest.mark.card
@pytest.mark.parametrize("name", [c["name"] for c in R.load_json(R.ROOT / "BENCHMARK.json")
                                  ["workloads"]])
def test_control_is_incorrect_on_the_card(name, card):
    """The reference in fp8 in the program's place, at the cell's size,
    on three seeds: each run comes out not correct."""
    for seed in (7001, 7002, 7003):
        ctx = R.execute(name, seed, 1.0, False, control="fp8")
        assert not ctx.correct, ctx.readings

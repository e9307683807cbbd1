"""The FLOP, byte, roofline, MFU and idle-union arithmetic on hand-made
inputs."""

import pytest

from benchmark.lib import arith
from benchmark import run as R


def test_conv_flops():
    # 3x3 conv 16 -> 32 on an 8x8 output: 2 * 32 * 64 * 16 * 9
    assert arith.conv_flops(16, 32, 3, 1, 8, 8) == 2 * 32 * 64 * 16 * 9
    assert arith.conv_flops(16, 16, 3, 16, 8, 8) == 2 * 16 * 64 * 1 * 9  # depthwise


@pytest.mark.parametrize("name", ["yolo11n", "yolo12n"])
def test_model_flops_kept_with_config(name):
    cfg = R.load_json(R.HERE / "configs" / f"{name}.json")
    c = arith.model_costs(cfg, 640)
    assert c["forward_flops"] == pytest.approx(cfg["forward_gflops_640"] * 1e9, rel=1e-9)
    # convs alone are ultralytics' published 6.5 GFLOPs at 640, to its rounding
    assert round(c["conv_flops"] / 1e9, 1) == 6.5


def test_attention_calls():
    c11 = arith.model_costs(R.load_json(R.HERE / "configs" / "yolo11n.json"), 640)
    assert c11["attention_calls"] == [(1, 400, 2, 32, 64)]
    c12 = arith.model_costs(R.load_json(R.HERE / "configs" / "yolo12n.json"), 640)
    assert c12["attention_calls"] == [(4, 400, 2, 32, 32)] * 4 + [(1, 400, 4, 32, 32)] * 4


def test_attention_bounds_match_the_kernel_table():
    # (32, 400, 256): 13.1 MB moved -> 0.0039 ms at 3.35 TB/s (PERF.md kernel table)
    flops, nbytes = arith.attention_fwd_cost(32, 400, 2, 32, 64)
    assert nbytes == 32 * 400 * (256 + 256) * 2
    assert flops == 2.0 * 32 * 2 * 400 * 400 * 96
    assert arith.bound_s(flops, nbytes, arith.PEAKS["bf16_flops"]) * 1e3 == \
        pytest.approx(0.0039, abs=5e-5)
    flops, nbytes = arith.attention_bwd_cost(32, 400, 2, 32, 64)
    assert arith.bound_s(flops, nbytes, arith.PEAKS["bf16_flops"]) * 1e3 == \
        pytest.approx(0.0059, abs=5e-5)


def test_nms_bound_matches_the_kernel_table():
    flops, nbytes = arith.nms_cost(32, 1000)
    assert flops == 32 * 1000 * 999 / 2 * 14
    assert arith.bound_s(flops, nbytes, arith.PEAKS["f32_flops"]) * 1e3 == \
        pytest.approx(0.0033, abs=5e-5)


def test_roofline_and_mfu():
    assert arith.roofline_pct(1.0, 4.0) == 25.0
    assert arith.roofline_pct(0.0, 4.0) is None
    assert arith.roofline_pct(1.0, 0.0) is None
    assert arith.mfu_pct(989e9, 1000, 1.0) == pytest.approx(100.0)
    assert arith.mfu_pct(1.0, 0, 1.0) is None


def test_union_and_gaps():
    iv = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (3.5, 3.6), (9.0, 12.0)]
    assert arith.union_length(iv, 0.0, 10.0) == pytest.approx(2.0 + 1.0 + 1.0)
    assert arith.union_length(iv, 1.5, 3.5) == pytest.approx(0.5 + 0.5)
    assert arith.gaps(iv, 0.0, 10.0) == [(2.0, 3.0), (4.0, 9.0)]
    assert arith.gaps([], 0.0, 1.0) == [(0.0, 1.0)]

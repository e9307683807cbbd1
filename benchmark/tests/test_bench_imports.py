"""Nothing the benchmark imports has jax, jaxlib, flax or the JAX package
(``deal_yolo_daya_tpu``) as its whole top-level name."""

import subprocess
import sys

from benchmark import run as R

PROBE = r"""
import sys
sys.path.insert(0, {root!r})
from pathlib import Path
from benchmark import run as R, calibrate
from benchmark.lib import arith, compare, detections, faults, readers, trace, traffic
from benchmark.reference import detect, model, train
for p in sorted((R.HERE / "drivers").glob("*.py")) + sorted((R.HERE / "metrics").glob("*.py")):
    R.load_module(p, "probe_" + p.stem.replace(".", "_"))
# what the drivers import from the program
import deal_yolo_daya_tpu_torch.api, deal_yolo_daya_tpu_torch.serve
import deal_yolo_daya_tpu_torch.train.trainer, deal_yolo_daya_tpu_torch.train.step_graph
import deal_yolo_daya_tpu_torch.train.device_augment
print("forbidden=" + ",".join(R.forbidden_loaded()))
"""


def test_forbidden_names_are_whole_top_level_names():
    mods = {"deal_yolo_daya_tpu_torch": 1, "deal_yolo_daya_tpu_torch.api": 1, "jaxtyping": 1,
            "numpy": 1}
    assert R.forbidden_loaded(mods) == []
    assert R.forbidden_loaded({**mods, "jax.numpy": 1}) == ["jax"]
    assert R.forbidden_loaded({**mods, "deal_yolo_daya_tpu.ops": 1}) == ["deal_yolo_daya_tpu"]
    assert R.forbidden_loaded({"flax": 1, "jaxlib": 1}) == ["flax", "jaxlib"]


def test_the_benchmark_and_the_program_load_no_jax():
    out = subprocess.run([sys.executable, "-c", PROBE.format(root=str(R.ROOT))],
                         capture_output=True, text=True, cwd=R.ROOT, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "forbidden="

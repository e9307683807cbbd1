"""The port's device grammar, sampler and bring-up against the JAX package's
``parallel/mesh.py`` and ``Trainer._sharded_epoch_indices``, on the CPU:
mesh shapes and refusals, the per-rank shard indices, ``init_distributed``
with and without ``DYD_*``, ``device_summary`` and ``dryrun_multichip``."""

import json
import os
import socket
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest

from deal_yolo_daya_tpu.parallel import mesh as jax_mesh
from deal_yolo_daya_tpu.train.trainer import Trainer as JaxTrainer
from deal_yolo_daya_tpu_torch.parallel import mesh as port_mesh
from deal_yolo_daya_tpu_torch.parallel.dryrun import dryrun_multichip
from deal_yolo_daya_tpu_torch.train.data import DataLoader, YoloDataset
from deal_yolo_daya_tpu_torch.train.trainer import TrainConfig, Trainer
from tests.test_data import make_dataset

REPO = Path(__file__).resolve().parents[1]
EIGHT = [port_mesh.Device("cpu", i, 0, i, "cpu") for i in range(8)]


@pytest.mark.parametrize("spec", ["", "1", "2", "8", "4x2", "2x4@dcn", "2x2x2@dcn", "1x8",
                                  "8x1"])
def test_mesh_shapes_match_jax(spec):
    """The (data, model) shape of each spec over 8 devices (JAX: conftest's
    8 CPU devices; the port: a list of 8)."""
    import jax

    assert len(jax.devices()) == 8
    want = jax_mesh.mesh_from_spec(spec or None)
    got = port_mesh.mesh_from_spec(spec or None, devices=EIGHT)
    assert got.shape == dict(want.shape)
    assert got.size == want.devices.size
    # an explicit size takes the first devices, data-major
    assert [d.id for d in got.devices.reshape(-1)] == [d.id for d in want.devices.reshape(-1)]


@pytest.mark.parametrize("spec", ["16", "3x4", "3x4@dcn", "2x2@dcn", "2x2x3@dcn", "1x2x2x2@dcn"])
def test_mesh_refusals_match_jax(spec):
    """Too many devices, or a @dcn spec that does not cover them: a
    ValueError on both, with the same text."""
    with pytest.raises(ValueError) as want:
        jax_mesh.mesh_from_spec(spec)
    with pytest.raises(ValueError) as got:
        port_mesh.mesh_from_spec(spec, devices=EIGHT)
    assert str(got.value) == str(want.value)


def test_port_spellings():
    """"0" is the first device (the JAX package's "0" is an empty mesh) and
    "cpu" one CPU device whatever is visible."""
    assert jax_mesh.mesh_from_spec("0").devices.size == 0
    first = port_mesh.mesh_from_spec("0", devices=EIGHT)
    assert first.shape == {"data": 1, "model": 1} and first.devices[0, 0].id == 0
    cpu = port_mesh.mesh_from_spec("cpu", devices=[])
    assert cpu.size == 1 and str(cpu.devices[0, 0].torch_device) == "cpu"


def test_visible_devices_and_summary(monkeypatch):
    """DYD_CPU_DEVICES=N is N CPU devices; device_summary has the JAX keys."""
    monkeypatch.setenv("DYD_CPU_DEVICES", "3")
    got = port_mesh.device_summary()
    want = jax_mesh.device_summary()
    assert set(got) == set(want)
    assert got["available"] and got["count"] == 3 and got["platform"] == "cpu"
    assert port_mesh.mesh_from_spec("").shape == {"data": 3, "model": 1}
    monkeypatch.delenv("DYD_CPU_DEVICES")
    if not port_mesh.visible_devices():  # no card here: nothing is visible
        assert port_mesh.device_summary()["available"] is False
        with pytest.raises(ValueError, match="needs 2 devices, only 0 available"):
            port_mesh.mesh_from_spec("2")


def test_trainer_device_specs(tmp_path, monkeypatch):
    """"1" is one device (it raised before); "2" over one device raises the
    JAX ValueError; a model axis raises NotImplementedError naming the
    roadmap; "cpu" stays the CPU."""
    data_yaml = make_dataset(tmp_path, n_train=4, n_val=2, imgsz=64, nc=2)
    cfg = dict(model="yolo11n", data=str(data_yaml), epochs=1, imgsz=64, batch=4, amp=False,
               project=str(tmp_path / "runs"), max_boxes=8, workers=1)
    monkeypatch.setenv("DYD_CPU_DEVICES", "1")
    one = Trainer(TrainConfig(device="1", name="one", **cfg))
    assert one.n_data == 1 and one.dp is None and one.device.type == "cpu"
    assert one.cfg.cache == "device"  # the JAX default on one device
    with pytest.raises(ValueError, match="mesh 2x1 needs 2 devices, only 1 available"):
        Trainer(TrainConfig(device="2", name="two", **cfg))
    monkeypatch.setenv("DYD_CPU_DEVICES", "8")
    with pytest.raises(NotImplementedError, match="ROADMAP.md section 1"):
        Trainer(TrainConfig(device="4x2", name="tp", **cfg))
    monkeypatch.delenv("DYD_CPU_DEVICES")
    assert Trainer(TrainConfig(device="cpu", name="cpu", **cfg)).device.type == "cpu"
    assert not (tmp_path / "runs" / "two").exists()


@pytest.mark.parametrize("n_data", [2, 3])
def test_sharded_epoch_indices_match_jax(tmp_path, n_data):
    """Each rank's local indices, three epochs, against the JAX method on a
    stub Trainer: equal exactly."""
    data_yaml = make_dataset(tmp_path, n_train=11, n_val=2, imgsz=32, nc=2)
    batch = 2 * n_data
    loader = DataLoader(YoloDataset.from_yaml(str(data_yaml), "train"), batch, 32, seed=3)
    stub = types.SimpleNamespace(cfg=types.SimpleNamespace(seed=3, batch=batch),
                                 train_loader=loader,
                                 mesh=types.SimpleNamespace(shape={"data": n_data}))
    for epoch in range(3):
        want = list(JaxTrainer._sharded_epoch_indices(stub, epoch))
        got = list(loader.sharded_epoch_indices(epoch, n_data))
        assert len(got) == len(want) == len(loader) > 0
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
            for r in range(n_data):  # a rank's rows stay inside its shard
                assert g[r * 2:(r + 1) * 2].max() < -(-11 // n_data)


def test_init_distributed_no_env(monkeypatch):
    for k in ("DYD_COORDINATOR", "DYD_NUM_PROCESSES", "DYD_PROCESS_ID"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setattr(port_mesh, "_cluster", None)
    assert port_mesh.init_distributed() is False
    assert port_mesh.cluster() is None


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


HOST = """
import json
from deal_yolo_daya_tpu_torch.parallel.mesh import init_distributed, mesh_from_spec
from deal_yolo_daya_tpu_torch.parallel.dryrun import dryrun_multichip
assert init_distributed()
mesh = mesh_from_spec("")
rec = dryrun_multichip(2)
print("RESULT", json.dumps({"shape": mesh.shape, "rank": rec["ranks"][0]["rank"],
                            "sums": rec["ranks"][0]["param_sums"], "loss": rec["loss"]}))
"""


def test_init_distributed_two_hosts():
    """Two "hosts" of one CPU rank each meet through DYD_*: the mesh spans
    both, and one data-parallel step over them leaves equal parameters."""
    port = _free_port()
    procs = []
    for pid in range(2):
        env = {**os.environ, "DYD_COORDINATOR": f"127.0.0.1:{port}", "DYD_NUM_PROCESSES": "2",
               "DYD_PROCESS_ID": str(pid), "DYD_CPU_DEVICES": "1", "OMP_NUM_THREADS": "2",
               "PYTHONPATH": str(REPO)}
        procs.append(subprocess.Popen([sys.executable, "-c", HOST], env=env, cwd=str(REPO),
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True))
    results = []
    for p in procs:
        out, _ = p.communicate(timeout=240)
        assert p.returncode == 0, out
        line = [ln for ln in out.splitlines() if ln.startswith("RESULT ")][-1]
        results.append(json.loads(line[len("RESULT "):]))
    assert [r["rank"] for r in results] == [0, 1]
    for r in results:
        assert r["shape"] == {"data": 2, "model": 1}
        assert len(set(r["sums"])) == 1 and len(r["sums"]) == 2
        assert np.isfinite(list(r["loss"].values())).all()
    assert results[0]["loss"] == results[1]["loss"]


def test_dryrun_multichip_two_ranks():
    rec = dryrun_multichip(2)
    assert [r["rank"] for r in rec["ranks"]] == [0, 1]
    assert all(r["backend"] == "gloo" for r in rec["ranks"])
    assert rec["ranks"][0]["param_sums"] == rec["ranks"][1]["param_sums"]
    assert rec["loss"]["cls_loss"] > 0

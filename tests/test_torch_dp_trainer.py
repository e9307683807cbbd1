"""The port's data-parallel Trainer on the CPU: one epoch with
``device="2"`` over two CPU ranks (``DYD_CPU_DEVICES=2``, gloo) against the
JAX Trainer with ``device="2"`` on two of conftest's CPU devices, from the
same weights on tests/test_torch_port_trainer.py's dataset and config
(2 steps of B = 4, 2 rows a rank, on-card augmentation, streamed: the JAX
default on several devices), with that file's tolerances; then the run
directory and checkpoints of rank 0 alone, and a rank that fails."""

import os
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from deal_yolo_daya_tpu_torch.models import state_dict_from_jax
from deal_yolo_daya_tpu_torch.parallel.launch import WorkerError
from deal_yolo_daya_tpu_torch.train.data import DataLoader, YoloDataset
from deal_yolo_daya_tpu_torch.train.trainer import TrainConfig, Trainer, load_checkpoint
from tests.test_torch_port_trainer import (CSV_ATOL, DELTA_RTOL, LOSS_RTOL, METRIC_ATOL, NC,
                                           _config, _rows, _start_weights, _write_dataset)
from tests.torch_deadline import LIMIT, _deadline, _deadline_module  # noqa: F401


@pytest.fixture(autouse=True, scope="module")
def two_threads():
    """Two CPU threads in this process, one a rank while two ranks run: the
    tier-1 run shares the cores among six workers, and spinning OpenMP
    threads of several processes starve one another."""
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


@pytest.fixture
def two_cpu_devices(monkeypatch):
    """Two visible CPU devices; the spawned ranks inherit the variable."""
    monkeypatch.setenv("DYD_CPU_DEVICES", "2")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import jax
    import jax.numpy as jnp
    from flax.linen import normalization

    from deal_yolo_daya_tpu.models.registry import make_detector
    from deal_yolo_daya_tpu.train.trainer import TrainConfig as JaxTrainConfig
    from deal_yolo_daya_tpu.train.trainer import Trainer as JaxTrainer

    tmp = tmp_path_factory.mktemp("dp_trainer")
    data_yaml = _write_dataset(tmp / "ds")
    model = make_detector("yolo11", "n", NC, dtype=jnp.float32)
    start = _start_weights(jax.jit(lambda k: model.init(
        k, jnp.zeros((1, 128, 128, 3)), train=False))(jax.random.PRNGKey(0)))
    jt = JaxTrainer(_config(JaxTrainConfig, data_yaml, tmp / "jax", "run", device="2"),
                    init_variables=start)
    assert jt.mesh.shape["data"] == 2 and jt.cfg.cache is False and len(jt.train_loader) == 2

    compute_stats = normalization._compute_stats

    def two_pass_stats(*args, **kwargs):
        kwargs["use_fast_variance"] = False
        return compute_stats(*args, **kwargs)

    normalization._compute_stats = two_pass_stats  # while the programs are traced
    try:
        jres = jt.train()
    finally:
        normalization._compute_stats = compute_stats

    saves = []
    save = Trainer.save_checkpoint
    saved_env = os.environ.get("DYD_CPU_DEVICES")
    os.environ["DYD_CPU_DEVICES"] = "2"
    Trainer.save_checkpoint = lambda self, tag, *a: (saves.append((self.rank, tag)),
                                                     save(self, tag, *a))[1]
    try:
        pt = Trainer(_config(TrainConfig, data_yaml, tmp / "port", "run", device="2",
                             extra={"dist_timeout_s": LIMIT / 2}),
                     init_state_dict=state_dict_from_jax(start))
        pres = pt.train()
    finally:
        Trainer.save_checkpoint = save
        if saved_env is None:
            del os.environ["DYD_CPU_DEVICES"]
        else:
            os.environ["DYD_CPU_DEVICES"] = saved_env
    return {"jax": {"rows": _rows(jres["save_dir"]), "metrics": jres["metrics"],
                    "ema": state_dict_from_jax({"params": jax.device_get(jt.state.ema_params)}),
                    "initial": state_dict_from_jax(start)},
            "port": pt, "port_result": pres, "saves": saves, "tmp": tmp, "data_yaml": data_yaml}


def test_two_ranks_results_csv_matches_jax(runs):
    (want,), (got,) = runs["jax"]["rows"], _rows(runs["port_result"]["save_dir"])
    assert list(got) == list(want)
    for col in want:
        if col in ("epoch", "time"):
            continue
        assert float(got[col]) == pytest.approx(float(want[col]), rel=LOSS_RTOL, abs=CSV_ATOL), col
    assert float(got["train/box_loss"]) > 0 and float(got["val/cls_loss"]) > 0


def test_two_ranks_metrics_match_jax(runs):
    want, got = runs["jax"]["metrics"], runs["port_result"]["metrics"]
    for k in ("precision", "recall", "map50", "map"):
        assert got[k] == pytest.approx(want[k], abs=METRIC_ATOL), k
    assert got["recall"] > 0
    np.testing.assert_allclose(got["per_class_ap"], want["per_class_ap"], atol=METRIC_ATOL)


def test_two_ranks_ema_matches_jax(runs):
    """The EMA's move from the start weights, per tensor (rank 0's)."""
    init, want = runs["jax"]["initial"], runs["jax"]["ema"]
    got = runs["port"].state.ema_state_dict()
    eps = 4 * np.finfo(np.float32).eps
    for name, g in got.items():
        w = (want[name] - init[name]).numpy()
        d = (g - init[name]).numpy()
        floor = eps * float(np.abs(init[name].numpy()).max()) + 1e-9
        assert np.abs(d - w).max() <= DELTA_RTOL * np.abs(w).max() + floor, name


def test_two_ranks_one_run_dir_and_checkpoints(runs):
    """Rank 0 alone made the run directory and wrote last and best, once
    each; the Trainer it returns is back on one device."""
    port = runs["port"]
    assert port.n_data == 2 and port.rank == 0 and port.cfg.batch == 4
    assert sorted(p.name for p in (runs["tmp"] / "port").iterdir()) == ["run"]
    weights = Path(runs["port_result"]["save_dir"]) / "weights"
    assert sorted(p.name for p in weights.iterdir()) == ["best.pt", "last.pt"]
    assert sorted(runs["saves"]) == [(0, "best"), (0, "last")]
    ckpt = load_checkpoint(weights / "last.pt")
    assert ckpt["updates"] == 2
    for k, v in port.state.state()["model"].items():
        assert torch.equal(ckpt["model"][k], v), k
    assert port.state.dp is None and port._ranks is None


def test_rank_failure_reaches_the_caller(tmp_path, two_cpu_devices):
    """An image that only rank 1 reads is corrupt: rank 1 raises, and the
    caller's train() raises WorkerError with rank 1's traceback, well inside
    the group's timeout."""
    data_yaml = _write_dataset(tmp_path / "ds")
    cfg = _config(TrainConfig, data_yaml, tmp_path / "runs", "fail", device="2",
                  extra={"dist_timeout_s": 60.0})
    ds = YoloDataset.from_yaml(str(data_yaml), "train")
    first = next(iter(DataLoader(ds, cfg.batch, cfg.imgsz, seed=cfg.seed).epoch_indices(0)))
    bad = ds.images[int(first[3])]  # rank 1's second row of the first batch, in no other
    Path(bad).write_bytes(b"not an image")
    trainer = Trainer(cfg)
    t0 = time.time()
    with pytest.raises(WorkerError, match="rank 1") as err:
        trainer.train()
    assert time.time() - t0 < 50
    assert err.value.rank == 1 and bad.name in err.value.traceback


def test_two_ranks_device_cache_program_matches_eager(tmp_path, two_cpu_devices):
    """cache="device" on two ranks: each rank holds its shard of the train
    set and takes its rows of the JAX sharded sampler's batches; the step
    program (K = 2, run eagerly on the CPU: the gather, the ranks' raw rows
    gathered, the augmentation of this rank's rows, the step) writes the
    same results.csv as the per-step loop (K = 1)."""
    data_yaml = _write_dataset(tmp_path / "ds")
    rows = {}
    for k in (1, 2):
        cfg = _config(TrainConfig, data_yaml, tmp_path / "runs", f"k{k}", device="2",
                      cache="device", steps_per_dispatch=k, mosaic=1.0, val=False,
                      extra={"dist_timeout_s": LIMIT / 2})
        trainer = Trainer(cfg)
        result = trainer.train()
        assert trainer._dev_cache is not None and len(trainer._dev_cache[0]) == 4
        rows[k] = [{c: v for c, v in r.items() if c != "time"} for r in _rows(result["save_dir"])]
    assert rows[1] == rows[2]
    assert float(rows[1][0]["train/cls_loss"]) > 0

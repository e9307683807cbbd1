"""The port's Trainer alone on the CPU: gradient accumulation (nbs), its
cadence, its batch-mean scaling and a window cut to the run's length (as
the JAX Trainer does). A yolo11n at 64 px, f32, on tests/test_data.py's
dataset (``tests/test_torch_port_trainer.py::_small``)."""

import pytest
import torch

from tests.test_data import make_dataset
from tests.test_torch_port_trainer import _small
from tests.torch_deadline import _deadline, _deadline_module  # noqa: F401


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two CPU threads for this file's PyTorch ops, restored afterwards: the
    test workers share the machine's cores."""
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def _raw_step_batch(trainer):
    batch = next(trainer._epoch_batches(0))
    return trainer.augment(batch, 0)


def test_nbs_cadence_accumulates_and_scales_weight_decay(tmp_path):
    """nbs 64 at batch 8: accumulate 8, weight decay wd * 8 * 8 / 64; the
    parameters and the EMA move only on the 8th micro-batch; 8 micro-batch
    steps are one update (tests/test_trainer_paths.py's case)."""
    data_yaml = make_dataset(tmp_path, n_train=64, n_val=4, imgsz=64, nc=2)
    t = _small(tmp_path, "nbs", data_yaml, batch=8, nbs=64, loss_batch_scale=True)
    assert t.accumulate == 8
    assert t.opt_cfg.weight_decay == pytest.approx(t.cfg.weight_decay)
    assert t.opt_cfg.steps_per_epoch == 1  # 8 batches, in optimizer steps
    aug = _raw_step_batch(t)
    stem = t.state.model.get_parameter("0.conv.weight")
    p0, e0 = stem.detach().clone(), t.state.ema[0].clone()
    t.state.step(*aug)
    assert torch.equal(stem, p0) and torch.equal(t.state.ema[0], e0)
    for _ in range(7):
        t.state.step(*aug)
    assert not torch.equal(stem, p0) and not torch.equal(t.state.ema[0], e0)
    assert t.state.updates == 8 and t.state.optimizer.updates == 1


def test_nbs_mean_of_a_window_equals_one_step(tmp_path):
    """Under the batch-mean loss the window's summed gradient is divided by
    k: two micro-steps on one batch give exactly the update of one step
    (no warmup, so that both first updates take lr0 and the full momentum)."""
    data_yaml = make_dataset(tmp_path, n_train=8, n_val=4, imgsz=64, nc=2)
    a = _small(tmp_path, "acc", data_yaml, nbs=8, warmup_epochs=0)
    b = _small(tmp_path, "one", data_yaml, warmup_epochs=0)
    assert (a.accumulate, b.accumulate) == (2, 1)
    aug = _raw_step_batch(b)
    a.state.step(*aug)
    a.state.step(*aug)
    b.state.step(*aug)
    for (name, pa), pb in zip(a.state.model.named_parameters(), b.state.model.parameters()):
        torch.testing.assert_close(pa, pb, rtol=0, atol=0, msg=name)


def test_nbs_window_longer_than_the_run_is_cut_and_scales_weight_decay(tmp_path):
    """nbs 64 at batch 4 asks for 16 micro-batches, the run has 2: the
    window is cut to 2 and weight decay scaled by 4 * 2 / 64, as the JAX
    Trainer does (trainer.py:392-402)."""
    t = _small(tmp_path, "cut", nbs=64)
    assert t.accumulate == 2
    assert t.opt_cfg.weight_decay == pytest.approx(t.cfg.weight_decay * 4 * 2 / 64)
    assert t.state.optimizer.k == 2

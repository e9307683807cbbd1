"""Tensor parallelism's choice of sharded convs against the JAX package's
``tp_param_shardings``, on the CPU.

The JAX rule shards an HWIO kernel on its last (output-channel) dim when
that is at least ``min_channels`` and divisible by the ``model`` axis; the
port's picks the same convs in OIHW by dim 0, depthwise ones included (JAX's
(3, 3, 1, C) depthwise kernel has its outputs last too). The JAX side runs on
``jax.eval_shape`` trees (nothing compiled) and on conftest's 8 CPU devices;
its picks reach the port's names through the weight bridge
(``state_dict_from_jax``). Exact equality of the name sets is the bar."""

import functools

import numpy as np
import pytest
import torch
import torch.nn as nn

from deal_yolo_daya_tpu_torch.models import state_dict_from_jax
from deal_yolo_daya_tpu_torch.models.registry import make_detector
from deal_yolo_daya_tpu_torch.parallel.sharding import tp_param_shardings
from tests.torch_deadline import _deadline, _deadline_module  # noqa: F401

IMGSZ, NC = 64, 80
MODELS = [("yolo11", "n"), ("yolo11", "x"), ("yolo12", "n"), ("yolov8", "n")]
# (sharded convs, of which depthwise, all convs) at min_channels 256, M = 2
COUNTS_256 = {("yolo11", "n"): (11, 1, 87), ("yolo11", "x"): (56, 8, 173),
              ("yolo12", "n"): (13, 1, 119)}


@functools.lru_cache(maxsize=None)
def _jax_shapes(family, scale):
    import jax
    import jax.numpy as jnp

    from deal_yolo_daya_tpu.models.registry import make_detector as jax_make_detector

    model = jax_make_detector(family, scale, NC)
    return jax.eval_shape(lambda k: model.init(k, jnp.zeros((1, IMGSZ, IMGSZ, 3)), train=False),
                          jax.random.PRNGKey(0))["params"]


def _jax_picks(family, scale, n_model, min_channels):
    """The port names of the kernels JAX's rule shards on a (8/M) x M mesh."""
    import jax
    from jax.sharding import PartitionSpec as P

    from deal_yolo_daya_tpu.parallel.mesh import create_mesh
    from deal_yolo_daya_tpu.parallel.sharding import tp_param_shardings as jax_tp

    params = _jax_shapes(family, scale)
    specs = jax_tp(params, create_mesh(8 // n_model, n_model), min_channels=min_channels)
    # a one-element leaf a parameter (4-D for kernels, so the bridge's HWIO
    # -> OIHW transpose applies), 1.0 where the spec is sharded
    flags = jax.tree_util.tree_map(
        lambda leaf, sh: np.full((1,) * len(leaf.shape), float(sh.spec != P()), np.float32),
        params, specs)
    for sh in jax.tree_util.tree_leaves(specs):
        assert sh.spec in (P(), P(None, None, None, "model"))
    return {n for n, v in state_dict_from_jax({"params": flags}).items() if v.item()}


@functools.lru_cache(maxsize=None)
def _port_model(family, scale):
    with torch.device("meta"):
        return make_detector(family, scale, NC)


@pytest.mark.parametrize("family,scale", MODELS)
@pytest.mark.parametrize("min_channels", [64, 128, 256])
@pytest.mark.parametrize("n_model", [2, 4])
def test_picks_match_jax(family, scale, min_channels, n_model):
    model = _port_model(family, scale)
    got = tp_param_shardings(model, n_model, min_channels)
    assert set(got.values()) <= {0}
    assert set(got) == _jax_picks(family, scale, n_model, min_channels)
    for name in got:  # every pick is a conv weight of enough, divisible outputs
        o = model.get_parameter(name).shape[0]
        assert o >= min_channels and o % n_model == 0, name
    assert list(got) == [n for n, _ in model.named_parameters() if n in got]  # model order


@pytest.mark.parametrize("family,scale", sorted(COUNTS_256))
def test_counts_at_256_channels(family, scale):
    """yolo11n: 11 of 87 convs (the depthwise 23.cv3.2.0.0 among them);
    yolo11x: 56 of 173 (8 depthwise, the PSA ``attn.pe`` convs among them);
    yolo12n: 13 of 119 (1 depthwise)."""
    model = _port_model(family, scale)
    mesh = type("MeshShape", (), {"shape": {"data": 4, "model": 2}})()
    got = tp_param_shardings(model, mesh)
    convs = {f"{n}.weight": m for n, m in model.named_modules() if isinstance(m, nn.Conv2d)}
    depthwise = [n for n in got if convs[n].groups > 1]
    assert (len(got), len(depthwise), len(convs)) == COUNTS_256[(family, scale)]
    assert all(convs[n].groups == convs[n].out_channels == convs[n].in_channels
               for n in depthwise)
    if (family, scale) == ("yolo11", "n"):
        assert depthwise == ["23.cv3.2.0.0.conv.weight"]
    if (family, scale) == ("yolo11", "x"):
        assert {"10.m.0.attn.pe.conv.weight", "10.m.1.attn.pe.conv.weight"} <= set(depthwise)


def test_model_axis_one_replicates_everything():
    model = _port_model("yolo11", "x")
    for mesh in (1, type("MeshShape", (), {"shape": {"data": 8, "model": 1}})()):
        assert tp_param_shardings(model, mesh, min_channels=1) == {}


def test_sharding_spec_selection_oihw():
    """JAX ``test_parallel.py::test_tp_sharding_spec_selection`` in OIHW: a
    wide (3x3, 128 -> 256) conv is sharded on its output channels over a
    4 x 2 mesh, a narrow one and a BatchNorm scale are not; a model axis of
    1 replicates everything."""
    from deal_yolo_daya_tpu_torch.parallel.mesh import Device, create_mesh

    eight = [Device("cpu", i, 0, i, "cpu") for i in range(8)]
    params = nn.Module()
    params.wide = nn.Conv2d(128, 256, 3, bias=False)
    params.narrow = nn.Conv2d(16, 32, 3, bias=False)
    params.bn = nn.BatchNorm2d(256)
    assert tp_param_shardings(params, create_mesh(4, 2, devices=eight),
                              min_channels=256) == {"wide.weight": 0}
    assert tp_param_shardings(params, create_mesh(8, 1, devices=eight), min_channels=256) == {}

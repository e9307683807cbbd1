"""Read trained ultralytics YOLO11/YOLOv8/YOLOv12/YOLOv10 checkpoints (.pt)
without ultralytics installed, and load them into the port's detectors.

The port's copy of ``deal_yolo_daya_tpu/models/torch_import.py``. A user of
the reference owns ultralytics ``best.pt`` files (its trainer is
ultralytics); this module reads them:

- ``read_torch_checkpoint(path)`` unpickles the .pt through a stub
  unpickler (ultralytics classes that cannot be imported become inert
  stand-ins; tensors load through torch's own storage path) and flattens
  the module tree into a ``{key: float32 tensor}`` state dict, with the
  class ``names`` and ``train_args`` in ``meta``;
- ``import_state_dict(sd, model, strict)`` lays it onto a detector's state
  dict. The port's detectors already carry the ultralytics
  ``DetectionModel`` keys (``models/weights.py``), so no name translation
  is needed: keys lose their wrapper prefixes, a fused checkpoint (conv
  bias, no bn) becomes conv + identity BN, BN bookkeeping and the DFL conv
  are skipped, and every tensor is shape-checked. Two YOLOv10 names
  differ: ultralytics' PSA is ``10.attn.*``/``10.ffn.*`` where the port's
  ``C2PSA`` at n = 1 holds ``10.m.0.attn.*``/``10.m.0.ffn.*`` (the same
  arithmetic), and a fused RepVGGDW (its 3x3 merged into the 7x7 and
  deleted) gets a zero 3x3 with identity BN, the same function. ``strict=False`` is the
  intersect load of fine-tuning: a tensor of another shape (the class head
  under another nc) keeps the target's value and is reported;
- ``export_state_dict(model)`` is the inverse: the ultralytics-named f32
  numpy dict.
"""

from __future__ import annotations

import io
import pickle
import re
import types
from typing import Any, Dict, List, Mapping, Tuple, Union

import numpy as np
import torch
import torch.nn as nn

from .registry import FAMILIES, infer_arch

# ultralytics keys with no counterpart here (reported as skipped, not
# unused): BN bookkeeping, the constant-arange DFL conv (the DFL expectation
# is computed arithmetically, ops/decode.py), the Detect grid buffers
_SKIP_PATTERNS = [
    re.compile(r"\.num_batches_tracked$"),
    re.compile(r"^2[123]\.dfl\."),
    re.compile(r"^2[123]\.(stride|strides|anchors|shape)$"),
]


def _to_tensor(v) -> torch.Tensor:
    """A tensor, parameter or array (fp16/bf16 included) as a float32 tensor
    on the host."""
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().to(torch.float32)
    return torch.from_numpy(np.array(v, dtype=np.float32))


def normalize_keys(sd: Mapping[str, Any]) -> Tuple[Dict[str, torch.Tensor], List[str]]:
    """Strip wrapper prefixes ("model.", "model.model.") so that the first
    segment is the numeric module index; drop keys with no index. Returns
    (sd, dropped)."""
    out: Dict[str, torch.Tensor] = {}
    dropped: List[str] = []
    for key, val in sd.items():
        segs = key.split(".")
        idx = next((i for i, s in enumerate(segs) if s.isdigit()), None)
        if idx is None:
            dropped.append(key)
            continue
        out[".".join(segs[idx:])] = _to_tensor(val)
    return out, dropped


def _synthesize_fused_bn(sd: Dict[str, torch.Tensor]) -> List[str]:
    """A fused ultralytics checkpoint has ``X.conv.bias`` and no ``X.bn.*``:
    re-express it as conv + identity BN carrying the bias (eps 1e-3, so that
    folding it again changes no bit). Returns the rewritten module names."""
    fused = []
    for key in list(sd):
        m = re.fullmatch(r"(.+)\.conv\.bias", key)
        if not m:
            continue
        base = m.group(1)
        if f"{base}.bn.weight" in sd or f"{base}.conv.weight" not in sd:
            continue
        c = sd[key].shape[0]
        sd[f"{base}.bn.weight"] = torch.ones(c)
        sd[f"{base}.bn.bias"] = sd.pop(key)
        sd[f"{base}.bn.running_mean"] = torch.zeros(c)
        sd[f"{base}.bn.running_var"] = torch.full((c,), 1.0 - 1e-3)
        fused.append(base)
    return fused


# YOLOv10's PSA (ultralytics ``PSA``) -> the port's C2PSA at n = 1
_V10_PSA = re.compile(r"^10\.(attn|ffn)\.")


def v10_keys(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A normalized YOLOv10 state dict with ultralytics' PSA keys
    (``10.attn.*``, ``10.ffn.*``) renamed to the port's (``10.m.0.attn.*``,
    ``10.m.0.ffn.*``); any other state dict as it is."""
    if "23.one2one_cv2.0.2.bias" not in sd:
        return sd
    return {_V10_PSA.sub(r"10.m.0.\1.", k): v for k, v in sd.items()}


def _zero_fused_repvggdw(sd: Dict[str, torch.Tensor], target: Mapping[str, torch.Tensor]
                         ) -> List[str]:
    """Where the target has a RepVGGDW's 3x3 (``X.conv1.*``) and a fused
    checkpoint only its 7x7 (``X.conv.*``), add the 3x3 as zeros with an
    identity BN (eps 1e-3): the block's function is unchanged. Returns the
    blocks so completed."""
    done = []
    for key in target:
        m = re.fullmatch(r"(.+)\.conv1\.conv\.weight", key)
        if m is None or key in sd or f"{m.group(1)}.conv.conv.weight" not in sd:
            continue
        base, c = f"{m.group(1)}.conv1", target[key].shape[0]
        sd[key] = torch.zeros(tuple(target[key].shape))
        sd[f"{base}.bn.weight"] = torch.ones(c)
        sd[f"{base}.bn.bias"] = torch.zeros(c)
        sd[f"{base}.bn.running_mean"] = torch.zeros(c)
        sd[f"{base}.bn.running_var"] = torch.full((c,), 1.0 - 1e-3)
        done.append(m.group(1))
    return done


def import_state_dict(sd: Mapping[str, Any], model: Union[nn.Module, Mapping[str, torch.Tensor]],
                      strict: bool = True) -> Tuple[Dict[str, torch.Tensor], Dict[str, Any]]:
    """Lay an ultralytics state dict onto ``model``'s (a detector or its
    state dict) -> (new state dict, report).

    The report has ``missing`` (expected but absent), ``unused`` (present
    but unmatched), ``skipped`` (known non-parameters), ``fused`` (conv-bias
    rewrites), ``dropped`` (keys without a module index), ``shape_mismatch``
    and ``imported`` (the count taken). ``strict`` raises ValueError on a
    missing key or a shape mismatch; otherwise those keep the target's
    values."""
    target = model.state_dict() if isinstance(model, nn.Module) else model
    sd, dropped = normalize_keys(dict(sd))
    sd = v10_keys(sd)
    fused = _synthesize_fused_bn(sd)
    fused += [f"{b} (RepVGGDW)" for b in _zero_fused_repvggdw(sd, target)]
    skipped = [k for k in sd if any(p.search(k) for p in _SKIP_PATTERNS)]
    new = {k: v.detach().clone() for k, v in target.items()}
    used, missing, shape_mismatch = set(skipped), [], []
    for key, want in target.items():
        if key not in sd:
            missing.append(key)
            continue
        arr = sd[key]
        used.add(key)
        if tuple(arr.shape) != tuple(want.shape):
            if strict:
                raise ValueError(f"shape mismatch for {key}: checkpoint {tuple(arr.shape)} "
                                 f"vs model {tuple(want.shape)}")
            shape_mismatch.append(key)  # the intersect load keeps the target's
            continue
        new[key] = arr.to(want.dtype)
    report = {
        "missing": missing, "unused": sorted(set(sd) - used), "skipped": sorted(skipped),
        "fused": fused, "dropped": dropped, "shape_mismatch": shape_mismatch,
        "imported": len(target) - len(missing) - len(shape_mismatch),
    }
    if strict and missing:
        raise ValueError(f"checkpoint is missing {len(missing)} expected keys "
                         f"(wrong scale/nc?): {missing[:8]}...")
    return new, report


def export_state_dict(model: nn.Module) -> Dict[str, np.ndarray]:
    """``model``'s state dict as ultralytics-named float32 numpy arrays
    (keys without the "model." prefix, as the JAX package exports them)."""
    return {k: v.detach().cpu().to(torch.float32).numpy() for k, v in model.state_dict().items()}


def detect_nc(sd: Mapping[str, Any]) -> int:
    """The class count of an ultralytics detection state dict, from its
    Detect head's class bias (after ``registry.infer_arch`` has found the
    family)."""
    sd, _ = normalize_keys(dict(sd))
    family, _ = infer_arch(sd)
    return int(sd[f"{FAMILIES[family].DETECT}.cv3.0.2.bias"].shape[0])


# --------------------------------------------------------------------------
# .pt reading without ultralytics installed


def _stub_pickle_module():
    """A pickle module whose Unpickler puts inert stand-in classes in place
    of anything it cannot import (the ultralytics model and trainer classes
    inside a .pt). ``torch.load`` drives it, so tensors still load through
    torch's storage machinery; only the Python objects around them are
    stubbed."""
    cache: Dict[Tuple[str, str], type] = {}

    def make_stub(module: str, name: str) -> type:
        key = (module, name)
        if key not in cache:

            def _init(self, *a, **k):
                pass

            def _setstate(self, state):
                if isinstance(state, dict):
                    self.__dict__.update(state)
                elif isinstance(state, tuple):
                    for part in state:
                        if isinstance(part, dict):
                            self.__dict__.update(part)

            cache[key] = type(name.rsplit(".", 1)[-1], (), {
                "__module__": module, "__init__": _init, "__setstate__": _setstate,
                "_stub_origin": f"{module}.{name}",
            })
        return cache[key]

    class StubUnpickler(pickle.Unpickler):
        def find_class(self, module, name):
            try:
                return super().find_class(module, name)
            except (ImportError, AttributeError):
                return make_stub(module, name)

    mod = types.ModuleType("deal_yolo_daya_tpu_torch_stub_pickle")
    mod.Unpickler = StubUnpickler
    mod.load = lambda f, **kw: StubUnpickler(f, **kw).load()
    mod.loads = lambda b, **kw: StubUnpickler(io.BytesIO(b), **kw).load()
    return mod


def _module_state(obj, prefix: str = "", out: Dict[str, Any] = None) -> Dict[str, Any]:
    """Flatten a (possibly stubbed) module tree into a state dict by walking
    ``_parameters``/``_buffers``/``_modules``: real modules and stand-ins
    alike carry them in ``__dict__``."""
    if out is None:
        out = {}
    d = getattr(obj, "__dict__", None) or {}
    for k, v in {**(d.get("_parameters") or {}), **(d.get("_buffers") or {})}.items():
        if v is not None:
            out[prefix + k] = v
    for k, child in (d.get("_modules") or {}).items():
        if child is not None:
            _module_state(child, f"{prefix}{k}.", out)
    return out


def _looks_like_state_dict(obj) -> bool:
    return (isinstance(obj, dict) and bool(obj) and all(isinstance(k, str) for k in obj)
            and any(isinstance(v, (torch.Tensor, np.ndarray)) for v in obj.values()))


def read_torch_checkpoint(path) -> Tuple[Dict[str, torch.Tensor], Dict[str, Any]]:
    """An ultralytics (or plain torch) .pt -> (state dict of f32 tensors,
    meta). The weights come from ``ema``, else ``model``, else the object
    itself (a ModelEMA wrapper is unwrapped to its ``.ema`` module); keys
    keep their prefixes (``import_state_dict`` strips them). ``meta`` holds
    ``names`` (class id -> name) and ``train_args`` where the checkpoint has
    them. Raises ValueError when no weights are found."""
    obj = torch.load(str(path), map_location="cpu", weights_only=False,
                     pickle_module=_stub_pickle_module())
    meta: Dict[str, Any] = {}
    model = obj
    if isinstance(obj, dict) and not _looks_like_state_dict(obj):
        model = obj.get("ema") or obj.get("model") or obj
        meta["train_args"] = obj.get("train_args")
    inner = getattr(model, "__dict__", {}).get("ema")  # ModelEMA: the module is .ema
    if inner is not None and getattr(inner, "__dict__", {}).get("_modules"):
        model = inner
    if _looks_like_state_dict(model):
        sd = dict(model)
    else:
        sd = _module_state(model)
        names = getattr(model, "__dict__", {}).get("names")
        if isinstance(names, dict):
            meta["names"] = {int(k): str(v) for k, v in names.items()}
        elif isinstance(names, (list, tuple)):
            meta["names"] = {i: str(v) for i, v in enumerate(names)}
    if not sd:
        raise ValueError(f"{path}: could not locate module weights in checkpoint")
    return {k: _to_tensor(v) for k, v in sd.items()}, meta

"""High-level model API: ``YOLO("yolo11n").predict(...)`` and ``.train(...)``.

Counterpart of the predict and train paths of ``deal_yolo_daya_tpu/api.py``:
the model handle for every family and scale of the registry (yolo11,
yolov8, yolo12; n to x), the BN-folded inference model with the 1/255 folded
into the stem, host letterbox, batched device forward, decode, NMS, and
``Detections`` in original-image pixels; ``train`` runs the port's Trainer
and adopts its EMA weights; ``val`` validates the handle's weights with it;
``YOLO("<run>/weights/best.pt")`` loads a checkpoint that Trainer wrote, of
the family it records (yolo11 when it records none, as checkpoints written
before the registry), and ``YOLO("<ultralytics>.pt")`` or
``YOLO.from_ultralytics`` an ultralytics checkpoint (read without
ultralytics, ``models/torch_import.py``); ``load`` puts a Trainer checkpoint
into a handle; ``quantize_int8`` switches predict, the Engine and
``val(int8=True)`` to the w8a8 model (``models/quant.py``, the s8 conv
kernel); ``export``/``from_export`` write and load a serving bundle, int8
included (``serve.Engine`` serves a handle); ``export_stablehlo``/
``load_stablehlo`` write and load the whole inference program as one
``torch.export`` artifact. ``predict`` also takes video files and http(s)
URLs, streams (``stream=True``) and saves annotated outputs (``save=True``).
The model runs on the card unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from .device import resolve_device
from .models.quant import quantize_int8 as quantize_qtree, quantized_model
from .models.registry import build_detector, infer_arch, make_detector, parse_model_spec
from .models.torch_import import detect_nc, import_state_dict, read_torch_checkpoint
from .models.yolo11 import folded_state_dict, fuse_conv_bn
from .ops.decode import decode_predictions
from .ops.letterbox import letterbox_numpy, load_image
from .ops.nms import batched_nms

IMAGE_SUFFIXES = {".jpg", ".jpeg", ".png", ".bmp", ".webp"}
# video containers predict() plays through cv2
VIDEO_SUFFIXES = frozenset({".mp4", ".avi", ".mov", ".mkv", ".m4v", ".webm", ".wmv", ".mpg",
                            ".mpeg"})
URL_PREFIXES = ("http://", "https://")


def list_sources(source) -> list:
    """An image path, a directory of images, an (H, W, 3) array or a list of
    those -> the list of sources."""
    if isinstance(source, (str, Path)):
        p = Path(source)
        return sorted(q for q in p.iterdir()
                      if q.suffix.lower() in IMAGE_SUFFIXES) if p.is_dir() else [p]
    if isinstance(source, np.ndarray):
        return [source]
    return list(source)


@torch.no_grad()
def infer_fused(net, batch: torch.Tensor, dtype: torch.dtype, conf: float, iou: float,
                max_det: int, agnostic: bool = False):
    """``YOLO.infer`` through a given BN-folded model (``YOLO._fused_model``):
    (B, S, S, 3) uint8 letterboxed batch -> (boxes, scores, classes, n_det)
    padded to max_det, on the batch's device."""
    x = batch.permute(0, 3, 1, 2).to(dtype)  # NCHW view, channels_last strides
    box, cls = net(x)
    boxes, scores = decode_predictions(box, cls, tuple(batch.shape[1:3]))
    return batched_nms(boxes, scores, conf_thres=conf, iou_thres=iou,
                       pre_topk=1000, max_det=max_det, class_agnostic=agnostic)


class ServeProgram(torch.nn.Module):
    """The inference program ``export_stablehlo`` writes, the JAX ``serve``:
    (B, S, S, 3) uint8 letterboxed images, conf and iou (0-dim f32 tensors)
    -> (boxes (B, max_det, 4) f32, scores (B, max_det) f32, classes
    (B, max_det) i32, num_det (B,) i32). The images become bf16 / 255 as in
    JAX (not the stem fold of ``_fused_model``), then ``net`` (a
    ``fuse_conv_bn`` model) runs in ``dtype``, then decode and
    ``batched_nms(pre_topk=1000)`` with the runtime thresholds."""

    def __init__(self, net: torch.nn.Module, imgsz: int, dtype: torch.dtype, max_det: int):
        super().__init__()
        self.net, self.imgsz, self.compute_dtype, self.max_det = net, imgsz, dtype, max_det

    def forward(self, images: torch.Tensor, conf: torch.Tensor, iou: torch.Tensor):
        x = images.permute(0, 3, 1, 2).to(torch.bfloat16) / 255  # NCHW, channels_last strides
        box, cls = self.net(x.to(self.compute_dtype))
        boxes, scores = decode_predictions(box, cls, (self.imgsz, self.imgsz))
        return batched_nms(boxes, scores, conf_thres=conf, iou_thres=iou, pre_topk=1000,
                           max_det=self.max_det)


class LoadedProgram:
    """What ``load_stablehlo`` returns beside the meta: the exported program
    on one device (``module``, a ``torch.fx.GraphModule`` taking tensors
    there, which a CUDA graph can capture), called as (images, conf, iou)
    with arrays, tensors or floats, which it puts on that device first."""

    def __init__(self, module: torch.nn.Module, device: torch.device):
        self.module, self.device = module, device

    def __call__(self, images, conf, iou):
        images = torch.as_tensor(images, device=self.device)
        conf, iou = (torch.as_tensor(t, dtype=torch.float32, device=self.device)
                     for t in (conf, iou))
        return self.module(images, conf, iou)


def label_font(size: int = 48):
    """The label font of the JAX package's ``datakit.visualize._get_font``:
    simhei.ttf, then Arial Unicode.ttf (both draw Chinese class names), else
    PIL's default font."""
    from PIL import ImageFont

    for name in ("simhei.ttf", "Arial Unicode.ttf"):
        try:
            return ImageFont.truetype(name, size)
        except Exception:
            continue
    return ImageFont.load_default()


class Detections:
    """Per-image prediction result: xyxy boxes in original-image pixels."""

    def __init__(self, path, image, boxes, scores, classes, names):
        self.path = path
        self.image = image            # RGB uint8 original image
        self.boxes = boxes            # (n, 4) xyxy
        self.scores = scores          # (n,)
        self.classes = classes        # (n,) int
        self.names = names
        self.save_path = None         # set by predict(save=True)

    def __len__(self):
        return len(self.boxes)

    def to_records(self) -> List[Dict[str, Any]]:
        """One dict per detection: name / class / confidence / box{x1,y1,x2,y2}."""
        out = []
        for (x1, y1, x2, y2), s, c in zip(self.boxes, self.scores, self.classes):
            c = int(c)
            out.append({
                "name": (self.names[c] if 0 <= c < len(self.names) else str(c)),
                "class": c,
                "confidence": round(float(s), 5),
                "box": {"x1": round(float(x1), 2), "y1": round(float(y1), 2),
                        "x2": round(float(x2), 2), "y2": round(float(y2), 2)},
            })
        return out

    def to_json(self, **dumps_kwargs) -> str:
        return json.dumps(self.to_records(), ensure_ascii=False, **dumps_kwargs)

    def to_df(self):
        import pandas as pd

        return pd.DataFrame(self.to_records())

    def plot(self) -> np.ndarray:
        """Annotated copy of the image (boxes and class/confidence labels in
        ``label_font(14)``, CJK-capable where such a font is installed)."""
        from PIL import Image, ImageDraw

        img = Image.fromarray(self.image)
        draw = ImageDraw.Draw(img)
        font = label_font(size=14)
        for (x1, y1, x2, y2), s, c in zip(self.boxes, self.scores, self.classes):
            c = int(c)
            name = self.names[c] if 0 <= c < len(self.names) else str(c)
            draw.rectangle([x1, y1, x2, y2], outline=(255, 64, 64), width=2)
            draw.text((x1 + 2, max(y1 - 12, 0)), f"{name} {s:.2f}", fill=(255, 255, 0),
                      font=font)
        return np.asarray(img)

    def save(self, path):
        from PIL import Image

        Image.fromarray(self.plot()).save(path)
        return path


class YOLO:
    """Detector handle for any family and scale of the registry.

    >>> model = YOLO("yolo11n")                       # on the card, bf16
    >>> model = YOLO("yolo12n")                       # or "yolov8s", "yolo11x.yaml", ...
    >>> results = model.predict(["img.jpg"])
    >>> model.train(data="data.yaml", epochs=10)      # then predicts with the EMA weights
    >>> model = YOLO("runs/train/train/weights/best.pt")
    >>> model = YOLO("ultralytics_best.pt")           # or YOLO.from_ultralytics(path)
    >>> model.quantize_int8("calib_images/")          # predict and serve in w8a8
    >>> model = YOLO("yolo11n", device="cpu", dtype=torch.float32)
    """

    def __init__(self, model: str = "yolo11n", nc: int = 80, imgsz: int = 640,
                 device=None, dtype: Optional[torch.dtype] = None, seed: int = 0):
        self.model_spec = str(model)
        self.nc = nc
        self.imgsz = imgsz
        self.seed = seed
        self.device = resolve_device(device)
        self.dtype = dtype or (torch.bfloat16 if self.device.type == "cuda" else torch.float32)
        self.names: List[str] = [str(i) for i in range(nc)]
        self._model = None
        self._fused_cache = None
        self._quant = None  # the int8 qtree after quantize_int8 (models/quant.py)
        self._weights_loaded = False  # True after a checkpoint or train(): train() fine-tunes
        self.trainer = None
        self.import_report = None
        if self.model_spec.endswith(".pt"):
            from .train.trainer import ForeignCheckpoint, load_checkpoint

            if not Path(self.model_spec).exists():
                raise FileNotFoundError(f"model weights not found: {self.model_spec}")
            try:
                ckpt = load_checkpoint(self.model_spec)
            except ForeignCheckpoint:  # an ultralytics .pt
                self._import_ultralytics(*read_torch_checkpoint(self.model_spec))
            else:
                self._adopt_checkpoint(ckpt)
        else:
            self.family, self.scale = parse_model_spec(self.model_spec)

    def _set_model(self, model) -> None:
        """Adopt loaded f32 weights: the fused and int8 models go with the old."""
        self._model = model.to(self.device).eval()
        self._fused_cache = None
        self._quant = None
        self._weights_loaded = True

    def _adopt_checkpoint(self, ckpt: Dict[str, Any], imgsz: bool = True) -> None:
        """Adopt a checkpoint of the port's Trainer: its architecture, nc,
        names, imgsz (unless ``imgsz`` is False), and the EMA weights with the
        live BN statistics."""
        from .train.trainer import checkpoint_family, inference_state_dict

        self.family, self.scale = checkpoint_family(ckpt), ckpt["scale"]
        self.nc, self.names = int(ckpt["nc"]), list(ckpt["names"])
        if imgsz:
            self.imgsz = int(ckpt["imgsz"])
        model = make_detector(self.family, self.scale, self.nc)
        model.load_state_dict(inference_state_dict(ckpt), strict=True)
        self._set_model(model)

    def _import_ultralytics(self, sd: Dict[str, Any], meta: Dict[str, Any]) -> None:
        """Adopt an ultralytics state dict: family, scale and nc from its
        weights, imported strictly (``import_report``), its class names."""
        family, scale = infer_arch(sd)
        self.family, self.scale, self.nc = family, scale, detect_nc(sd)
        model = make_detector(family, scale, self.nc)
        state_dict, self.import_report = import_state_dict(sd, model)
        model.load_state_dict(state_dict, strict=True)
        self._set_model(model)
        names = meta.get("names")
        self.names = [names.get(i, str(i)) for i in range(self.nc)] if names \
            else [str(i) for i in range(self.nc)]

    @classmethod
    def from_ultralytics(cls, ckpt, imgsz: int = 640, device=None,
                         dtype: Optional[torch.dtype] = None) -> "YOLO":
        """A handle from a trained ultralytics YOLO11/YOLOv8/YOLOv12
        checkpoint: ``ckpt`` is a .pt path (read without ultralytics
        installed) or a loaded state dict. Family, scale and nc come from the
        weights, class names from the checkpoint where it has them; the
        import's report is ``import_report``. On the card unless
        ``device="cpu"``; ``dtype`` as ``YOLO``'s."""
        sd, meta = read_torch_checkpoint(ckpt) if isinstance(ckpt, (str, Path)) \
            else (dict(ckpt), {})
        family, scale = infer_arch(sd)
        handle = cls(f"{family}{scale}", imgsz=imgsz, device=device, dtype=dtype)
        handle._import_ultralytics(sd, meta)
        return handle

    def load(self, ckpt_path) -> "YOLO":
        """Load a checkpoint of the port's Trainer into this handle: the
        architecture, nc and names from the checkpoint (the JAX ``load``
        takes them from the tree), the handle's imgsz kept. An ultralytics
        .pt raises ValueError (``from_ultralytics`` reads those)."""
        from .train.trainer import ForeignCheckpoint, load_checkpoint

        if not Path(ckpt_path).exists():
            raise FileNotFoundError(f"model weights not found: {ckpt_path}")
        try:
            ckpt = load_checkpoint(ckpt_path)
        except ForeignCheckpoint as err:
            raise ValueError(f"{err}; an ultralytics .pt loads with "
                             "YOLO.from_ultralytics") from None
        self._adopt_checkpoint(ckpt, imgsz=False)
        return self

    def _ensure_built(self):
        """The f32 model with random weights from ``seed``, built once."""
        if self._model is None:
            self._model = build_detector(f"{self.family}{self.scale}", nc=self.nc,
                                         seed=self.seed, device=self.device)
        return self._model

    def _fused_model(self):
        """The inference model in ``dtype``, channels_last, taking raw 0..255
        images, cached per model object and qtree: BN-folded with the 1/255
        folded into the stem, or after ``quantize_int8`` the int8 model
        (``models/quant.py::quantized_model``, which divides first)."""
        model = self._ensure_built()
        cur = self._fused_cache
        if cur is not None and cur[0] is model and cur[1] is self._quant:
            return cur[2]
        if self._quant is None:
            fused = fuse_conv_bn(model, input_scale=1.0 / 255.0)
            fused = fused.to(dtype=self.dtype, memory_format=torch.channels_last).eval()
        else:
            fused = quantized_model(fuse_conv_bn(model), self._quant, self.dtype, self.device)
        self._fused_cache = (model, self._quant, fused)
        return fused

    def quantize_int8(self, calib_source, max_images: int = 64,
                      batch_size: int = 16) -> "YOLO":
        """Switch predict, the Engine and ``val(int8=True)`` to the
        post-training int8 (w8a8) model. ``calib_source`` takes predict's
        source forms; up to ``max_images`` of them, letterboxed, calibrate the
        per-conv activation ranges in batches of ``batch_size`` (as the JAX
        ``quantize_int8``: f32 / 255 on the host, then the working dtype).
        Weights quantize per output channel over the BN-folded kernels;
        depthwise and detect-head logit convs stay full precision. A later
        checkpoint load or train() drops the quantization."""
        sources = list_sources(calib_source)[:max_images]
        if not sources:
            raise ValueError("quantize_int8 needs at least one calibration image")
        fused = fuse_conv_bn(self._ensure_built())
        calib = quantized_model(fused, {}, self.dtype, self.device).net  # no conv quantized

        def batches():
            for start in range(0, len(sources), batch_size):
                canvases = [letterbox_numpy(src if isinstance(src, np.ndarray)
                                            else load_image(src), self.imgsz)[0]
                            for src in sources[start:start + batch_size]]
                x = torch.from_numpy(np.stack(canvases).astype(np.float32) / 255.0)
                yield x.to(self.device).permute(0, 3, 1, 2).to(self.dtype)

        self._quant = quantize_qtree(fused, batches(), calib_model=calib)
        self._fused_cache = None
        return self

    def train(self, data: str, **kwargs) -> Dict[str, Any]:
        """Train on a YOLO-layout ``data.yaml`` with the port's Trainer
        (``TrainConfig`` fields by name, other keys into ``cfg.extra``),
        from the loaded weights when there are any (a checkpoint or an
        earlier train()), else from the seed's random init. Afterwards the
        handle predicts with the trained EMA weights, nc, names and imgsz.
        ``device`` takes the JAX mesh grammar (``"4"``: four cards, data
        parallel, this process rank 0); the default is every card, or the
        CPU for a CPU handle."""
        from .train.trainer import Trainer, inference_state_dict, make_config

        kwargs.setdefault("device", "cpu" if self.device.type == "cpu" else "")
        cfg = make_config(self.model_spec, data, **kwargs)
        init = self._model.state_dict() if self._weights_loaded else None
        self.trainer = Trainer(cfg, init_state_dict=init)
        result = self.trainer.train()
        self.nc, self.names, self.imgsz = self.trainer.nc, list(self.trainer.names), cfg.imgsz
        self.family, self.scale = self.trainer.family, self.trainer.scale
        model = make_detector(self.family, self.scale, self.nc)
        model.load_state_dict(inference_state_dict(self.trainer.state.state()), strict=True)
        self._set_model(model)  # a further train() continues from these
        self.save_dir = result["save_dir"]
        return result

    def export(self, out_dir) -> Path:
        """Write a serving bundle: ``variables.pt``, the BN-folded weights
        under the detector's state-dict keys as the JAX ``fuse_conv_bn``
        stores a fold (``models.yolo11.folded_state_dict``; no 1/255 input
        fold), written by ``torch.save``; after ``quantize_int8`` also
        ``quant.pt``, the qtree (module name -> w_int8, w_scale, a_scale);
        and ``meta.json`` with the JAX bundle's keys (family, scale, nc,
        names, imgsz, fused, int8). Load it with ``YOLO.from_export``."""
        model = self._ensure_built()
        out_dir = Path(out_dir).resolve()
        out_dir.mkdir(parents=True, exist_ok=True)
        torch.save({k: v.cpu() for k, v in folded_state_dict(model).items()},
                   out_dir / "variables.pt")
        if self._quant is not None:
            torch.save(self._quant, out_dir / "quant.pt")
        (out_dir / "meta.json").write_text(json.dumps({
            "family": self.family, "scale": self.scale, "nc": self.nc,
            "names": list(self.names), "imgsz": self.imgsz, "fused": True,
            "int8": self._quant is not None,
        }, ensure_ascii=False))
        return out_dir

    @classmethod
    def from_export(cls, bundle_dir, device=None) -> "YOLO":
        """Load a serving bundle written by ``export()``: the plain detector
        of its family, scale and nc, loaded strictly with the folded weights
        (``_fused_model()`` folds them again to the same bits), on the card
        unless ``device="cpu"``; an int8 bundle's qtree (``quant.pt``) comes
        back with it, so the handle predicts in w8a8. The JAX package's
        bundles hold orbax checkpoints, which need jax to read: this package
        reads only its own."""
        bundle_dir = Path(bundle_dir).resolve()
        meta = json.loads((bundle_dir / "meta.json").read_text())
        family = meta.get("family", "yolo11")  # pre-registry bundles: yolo11
        handle = cls(f"{family}{meta['scale']}", nc=meta["nc"], imgsz=meta["imgsz"],
                     device=device)
        if not (bundle_dir / "variables.pt").exists():
            raise NotImplementedError(
                f"{bundle_dir}: no variables.pt; a bundle of the JAX package (an orbax "
                "checkpoint) needs jax to read, which this package does not import")
        handle.names = list(meta["names"])
        model = make_detector(family, meta["scale"], handle.nc)
        model.load_state_dict(torch.load(bundle_dir / "variables.pt", map_location="cpu",
                                         weights_only=True), strict=True)
        handle._set_model(model)
        if meta.get("int8"):  # the variables are already BN-folded: folding again is exact
            handle._quant = torch.load(bundle_dir / "quant.pt", map_location="cpu",
                                       weights_only=True)
        return handle

    def export_stablehlo(self, out_dir, batch_size: Optional[int] = None, max_det: int = 300,
                         use_pallas: bool = False) -> Path:
        """Write the whole inference program (``ServeProgram``: a uint8 NHWC
        letterboxed batch -> NMS'd detections padded to ``max_det``) as one
        artifact: a ``torch.export`` program saved by ``torch.export.save``
        to ``model.pt2`` (not StableHLO: the name is the JAX package's), the
        BN-folded weights inside, beside ``meta.json`` with the JAX keys.
        conf and iou stay runtime inputs, so a server sweeps thresholds
        without a new export. ``batch_size=None`` exports a symbolic batch
        dimension: one artifact serves every batch size.

        The default (``use_pallas=False``) is portable: traced on the CPU, it
        holds only aten ops (the plain attention and the ``while_loop``
        suppression), runs on the CPU or the card, and a process with torch
        alone loads it (``torch.export.load``). ``use_pallas=True`` traces on
        the card and holds the hand-written kernels as the custom ops
        ``dyd::area_attention_fwd`` and ``dyd::nms_suppress``: it runs only
        on a card, in a process that has registered them
        (``ops.kernels.register_ops``, which ``load_stablehlo`` calls), and
        needs a concrete ``batch_size``. The program computes in the
        handle's dtype."""
        from torch.export import Dim, export

        if use_pallas and not torch.cuda.is_available():
            raise ValueError(
                "use_pallas=True requires exporting from a process with a CUDA card (none "
                "is available); the portable default (use_pallas=False) works everywhere")
        if use_pallas and batch_size is None:
            raise ValueError(
                "use_pallas=True requires a concrete batch_size (the NMS kernel's launch "
                "geometry is chosen for a concrete batch)")
        device = torch.device("cpu")
        if use_pallas:
            device = self.device if self.device.type == "cuda" \
                else torch.device("cuda", torch.cuda.current_device())
        # contiguous weights (the images' permute gives the convs channels_last
        # activations): torch.export.save stores each weight whole
        net = fuse_conv_bn(self._ensure_built()).to(device=device, dtype=self.dtype)
        program = ServeProgram(net.eval().requires_grad_(False), self.imgsz, self.dtype, max_det)
        rows = 2 if batch_size is None else batch_size  # a symbolic batch traces from 2
        args = (torch.zeros((rows, self.imgsz, self.imgsz, 3), dtype=torch.uint8, device=device),
                torch.zeros((), dtype=torch.float32, device=device),
                torch.zeros((), dtype=torch.float32, device=device))
        dynamic = None if batch_size is not None else ({0: Dim("b", min=1)}, None, None)
        with torch.no_grad():
            exported = export(program, args, dynamic_shapes=dynamic)
        platforms = ["cuda"] if use_pallas else ["cpu", "cuda"]
        out_dir = Path(out_dir).resolve()
        out_dir.mkdir(parents=True, exist_ok=True)
        torch.export.save(exported, str(out_dir / "model.pt2"))
        (out_dir / "meta.json").write_text(json.dumps({
            "family": self.family, "scale": self.scale, "nc": self.nc,
            "names": list(self.names), "imgsz": self.imgsz, "batch_size": batch_size,
            "max_det": max_det, "outputs": ["boxes", "scores", "classes", "num_det"],
            "inputs": ["images_u8_nhwc", "conf", "iou"], "platforms": platforms,
        }, ensure_ascii=False))
        return out_dir

    @staticmethod
    def load_stablehlo(bundle_dir, device=None):
        """Load an ``export_stablehlo`` artifact -> (``LoadedProgram``, meta).
        The callable maps (images_u8, conf, iou) -> (boxes, scores, classes,
        num_det) on ``device``: the card unless ``device="cpu"``. A kernels
        artifact (platforms ["cuda"]) registers the port's custom ops first
        (``ops.kernels``, no model class) and runs only on a card; the
        portable one runs anywhere (``torch.export.load`` and
        ``torch.export.passes.move_to_device_pass`` alone load it too)."""
        from torch.export.passes import move_to_device_pass

        bundle_dir = Path(bundle_dir).resolve()
        meta = json.loads((bundle_dir / "meta.json").read_text())
        device = resolve_device(device)
        if device.type not in meta["platforms"]:
            raise ValueError(f"{bundle_dir}: the artifact runs on {meta['platforms']}, "
                             f"not on {device.type}")
        if "cpu" not in meta["platforms"]:  # the kernels are custom ops in the program
            from .ops.kernels import register_ops

            register_ops()
        exported = move_to_device_pass(torch.export.load(str(bundle_dir / "model.pt2")), device)
        return LoadedProgram(exported.module(), device), meta

    def val(self, data: str, int8: bool = False, **kwargs) -> Dict[str, float]:
        """Validate the handle's weights on a YOLO-layout ``data.yaml`` with
        the port's Trainer (``TrainConfig`` fields by name): its live model
        and EMA both take the weights, and ``Trainer.validate``'s metrics
        come back; nothing is trained and no plot is written. ``int8`` scores
        the int8 model of ``quantize_int8`` through the same validation (the
        JAX ``eval_apply``)."""
        from .train.trainer import Trainer, make_config

        eval_apply = None
        if int8:
            if self._quant is None:
                raise ValueError("call quantize_int8() before val(int8=True)")
            net, dtype = self._fused_model(), self.dtype
            eval_apply = lambda images: net(images.permute(0, 3, 1, 2).to(dtype))  # noqa: E731
        # one device: validation is one rank's (rank 0's in a data-parallel run)
        kwargs.setdefault("device", "cpu" if self.device.type == "cpu" else "0")
        cfg = make_config(f"{self.family}{self.scale}", data, **kwargs)
        cfg.val = True
        trainer = Trainer(cfg, init_state_dict=self._ensure_built().state_dict(),
                          eval_apply=eval_apply)
        metrics, _ = trainer.validate()
        return metrics

    def infer(self, batch: torch.Tensor, conf: float = 0.25, iou: float = 0.7,
              max_det: int = 300, agnostic: bool = False):
        """(B, S, S, 3) uint8 letterboxed batch on the model's device ->
        (boxes, scores, classes, n_det) padded to max_det, on the device."""
        return infer_fused(self._fused_model(), batch, self.dtype, conf, iou, max_det, agnostic)

    @staticmethod
    def _fetch_url_source(url: str) -> Path:
        """Download an http(s) predict source into the URL cache
        (``<tmp>/dyd_predict_cache``, datakit's retrying downloader); a
        repeat call on the same URL reuses the cached file. Raises
        FileNotFoundError when it is unreachable."""
        import tempfile

        from .datakit.download import ensure_image_cached

        cache = Path(tempfile.gettempdir()) / "dyd_predict_cache"
        cache.mkdir(parents=True, exist_ok=True)
        local = ensure_image_cached(url, cache)
        if local is None:
            raise FileNotFoundError(f"无法下载输入源：{url}")
        return local

    def predict(
        self,
        source: Union[str, Path, np.ndarray, Sequence],
        conf: float = 0.25,
        iou: float = 0.7,
        max_det: int = 300,
        batch_size: int = 64,  # short batches are padded to this size
        classes: Optional[Sequence[int]] = None,  # keep only these class ids
        agnostic_nms: bool = False,
        stream: bool = False,  # yield Detections lazily
        save: bool = False,    # write annotated outputs
        save_dir: Union[str, Path, None] = None,  # default runs/predict
    ):
        """Detect over an image path, a directory of images, an (H, W, 3)
        RGB uint8 array, a ``(label, array)`` pair, an http(s) URL
        (downloaded to a cache first, so a URL ending .mp4 plays as video),
        a video file (decoded frame by frame with cv2, batched through the
        same device path), or a list of those (videos only alone; a
        directory gives its images). ``stream=True`` returns a generator
        instead of a list: sources and frames load a batch at a time.
        ``save=True`` writes annotated images, or for a video one annotated
        ``<stem>_pred.mp4`` at the source fps, under ``save_dir`` (default
        ``runs/predict``, then ``predict2``, ... when it exists), and sets
        each ``Detections.save_path``; a streamed video's file is complete
        when the generator is exhausted or closed."""
        imgsz = self.imgsz
        is_video = False
        if isinstance(source, (str, Path)) and str(source).startswith(URL_PREFIXES):
            source = self._fetch_url_source(str(source))
        if isinstance(source, (str, Path)) and Path(source).suffix.lower() in VIDEO_SUFFIXES:
            if not Path(source).is_file():
                raise FileNotFoundError(f"视频文件不存在：{source}")
            is_video, sources = True, [Path(source)]
        elif isinstance(source, (str, Path, np.ndarray)):
            sources = list_sources(source)
        else:
            sources = [self._fetch_url_source(s)
                       if isinstance(s, (str, Path)) and str(s).startswith(URL_PREFIXES) else s
                       for s in source]

        def prepare(chunk):
            """Host stage: decode and letterbox one chunk of path, array or
            (label, array) items into a batch padded to batch_size, in
            pinned memory when it goes to the card."""
            batch = torch.empty((batch_size, imgsz, imgsz, 3), dtype=torch.uint8,
                                pin_memory=self.device.type == "cuda")
            batch[len(chunk):] = 0
            metas = []
            for i, src in enumerate(chunk):
                if isinstance(src, tuple):
                    label, img = src
                elif isinstance(src, np.ndarray):
                    label, img = None, src
                else:
                    label, img = str(src), load_image(src)
                canvas, r, (px, py) = letterbox_numpy(img, imgsz)
                batch[i] = torch.from_numpy(canvas)
                metas.append((label, img, r, (px, py)))
            return batch, metas

        def finish(handles, metas):
            """Pull one batch's results and map boxes to original pixels."""
            ob, osc, ocl, nd = (t.cpu().numpy() for t in handles)
            out = []
            for i, (label, img, r, (px, py)) in enumerate(metas):
                n = int(nd[i])
                boxes, bsc, bcl = ob[i, :n].copy(), osc[i, :n], ocl[i, :n]
                if classes is not None and n:
                    keep = np.isin(bcl, np.asarray(list(classes)))
                    boxes, bsc, bcl = boxes[keep], bsc[keep], bcl[keep]
                    n = len(boxes)
                if n:
                    boxes -= [px, py, px, py]
                    boxes /= r
                    h, w = img.shape[:2]
                    boxes[:, [0, 2]] = boxes[:, [0, 2]].clip(0, w)
                    boxes[:, [1, 3]] = boxes[:, [1, 3]].clip(0, h)
                out.append(Detections(label, img, boxes, bsc, bcl, self.names))
            return out

        def pipelined(chunks):
            """CUDA launches are asynchronous: batch N runs on the card while
            the host decodes and letterboxes batch N+1; N's results are
            pulled after that."""
            pending = None
            for chunk in chunks:
                batch, metas = prepare(chunk)
                handles = self.infer(batch.to(self.device, non_blocking=True), conf, iou,
                                     max_det, agnostic_nms)
                if pending is not None:
                    yield from finish(*pending)
                pending = (handles, metas)
            if pending is not None:
                yield from finish(*pending)

        out_dir = None
        if save:
            if save_dir is not None:
                out_dir = Path(save_dir)
            else:  # runs/predict, runs/predict2, ...: a later call never overwrites
                out_dir, k = Path("runs") / "predict", 2
                while out_dir.exists():
                    out_dir = Path("runs") / f"predict{k}"
                    k += 1
            out_dir.mkdir(parents=True, exist_ok=True)

        if is_video:
            gen = self._predict_video(sources[0], pipelined, batch_size, out_dir)
        else:
            def images():
                chunks = (sources[s:s + batch_size] for s in range(0, len(sources), batch_size))
                used = set()
                for j, det in enumerate(pipelined(chunks)):
                    if out_dir is not None:
                        name = Path(det.path).name if det.path else f"image{j}.jpg"
                        # sources sharing a basename (or an array's fallback name
                        # shadowing a file's) must not overwrite each other
                        stem, suffix = Path(name).stem, Path(name).suffix
                        final, n = name, 1
                        while final in used:
                            final = f"{stem}_{n}{suffix}"
                            n += 1
                        used.add(final)
                        det.save_path = det.save(out_dir / final)
                    yield det

            gen = images()
        return gen if stream else list(gen)

    @staticmethod
    def _predict_video(path, pipelined, batch_size, out_dir):
        """Detections of a video's frames: cv2 decodes them (BGR -> RGB,
        labels ``<path>#frame<i>``) a chunk of ``batch_size`` at a time, as
        ``pipelined`` asks, so chunk N+1 decodes while the card runs chunk
        N; with ``out_dir`` the annotated frames go to ``<stem>_pred.mp4``
        (mp4v, the source fps)."""
        try:
            import cv2
        except ImportError:
            raise RuntimeError("视频推理需要 opencv-python (cv2)") from None
        cap = cv2.VideoCapture(str(path))
        if not cap.isOpened():
            raise RuntimeError(f"无法打开视频：{path}")
        writer = save_path = None
        if out_dir is not None:
            fps = cap.get(cv2.CAP_PROP_FPS) or 0.0
            w = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH))
            h = int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
            save_path = Path(out_dir) / f"{Path(path).stem}_pred.mp4"
            writer = cv2.VideoWriter(str(save_path), cv2.VideoWriter_fourcc(*"mp4v"),
                                     fps if fps > 0 else 30.0, (w, h))
            if not writer.isOpened():
                cap.release()
                raise RuntimeError(f"无法创建视频输出 (mp4v codec): {save_path}")

        def frame_chunks():
            frames, idx, done = [], 0, False
            while not done:
                ok, bgr = cap.read()
                if ok:
                    frames.append((f"{path}#frame{idx}", cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB)))
                    idx += 1
                else:
                    done = True
                if frames and (len(frames) == batch_size or done):
                    yield frames
                    frames = []

        try:
            for det in pipelined(frame_chunks()):
                if writer is not None:
                    writer.write(cv2.cvtColor(det.plot(), cv2.COLOR_RGB2BGR))
                    det.save_path = save_path
                yield det
        finally:
            cap.release()
            if writer is not None:
                writer.release()

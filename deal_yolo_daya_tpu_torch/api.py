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
included (``serve.Engine`` serves a handle). The model runs on the card
unless the caller passes ``device="cpu"``.
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

    def predict(
        self,
        source: Union[str, Path, np.ndarray, Sequence],
        conf: float = 0.25,
        iou: float = 0.7,
        max_det: int = 300,
        batch_size: int = 64,  # short batches are padded to this size
        classes: Optional[Sequence[int]] = None,  # keep only these class ids
        agnostic_nms: bool = False,
    ) -> List[Detections]:
        """Detect over an image path, a directory of images, an (H, W, 3)
        RGB uint8 array, or a list of those."""
        imgsz = self.imgsz
        sources = list_sources(source)

        def prepare(chunk):
            """Host stage: decode and letterbox one chunk into a batch padded
            to batch_size, in pinned memory when it goes to the card."""
            batch = torch.empty((batch_size, imgsz, imgsz, 3), dtype=torch.uint8,
                                pin_memory=self.device.type == "cuda")
            batch[len(chunk):] = 0
            metas = []
            for i, src in enumerate(chunk):
                if isinstance(src, np.ndarray):
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

        results: List[Detections] = []
        pending = None
        # CUDA launches are asynchronous: batch N runs on the card while the
        # host letterboxes batch N+1; N's results are pulled after that
        for s in range(0, len(sources), batch_size):
            batch, metas = prepare(sources[s:s + batch_size])
            handles = self.infer(batch.to(self.device, non_blocking=True), conf, iou,
                                 max_det, agnostic_nms)
            if pending is not None:
                results.extend(finish(*pending))
            pending = (handles, metas)
        if pending is not None:
            results.extend(finish(*pending))
        return results

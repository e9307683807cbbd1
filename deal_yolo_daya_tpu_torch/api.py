"""High-level model API: ``YOLO("yolo11n").predict(...)`` and ``.train(...)``.

Counterpart of the predict and train paths of ``deal_yolo_daya_tpu/api.py``:
the model handle for every family and scale of the registry (yolo11,
yolov8, yolo12; n to x), the BN-folded inference model with the 1/255 folded
into the stem, host letterbox, batched device forward, decode, NMS, and
``Detections`` in original-image pixels; ``train`` runs the port's Trainer
and adopts its EMA weights; ``val`` validates the handle's weights with it;
``YOLO("<run>/weights/best.pt")`` loads a checkpoint that Trainer wrote, of
the family it records (yolo11 when it records none, as checkpoints written
before the registry); ``export``/``from_export`` write and load a serving
bundle (``serve.Engine`` serves a handle). The model runs on the card
unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from .device import resolve_device
from .models.registry import build_detector, make_detector, parse_model_spec
from .models.yolo11 import folded_state_dict, fuse_conv_bn
from .ops.decode import decode_predictions
from .ops.letterbox import letterbox_numpy, load_image
from .ops.nms import batched_nms

IMAGE_SUFFIXES = {".jpg", ".jpeg", ".png", ".bmp", ".webp"}
INT8_NOT_PORTED = ("int8 serving (quantize_int8) is not ported yet: it needs an int8 "
                   "convolution (ROADMAP.md section 1, 'The rest of api.py')")


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
        """Annotated copy of the image (boxes and class/confidence labels)."""
        from PIL import Image, ImageDraw

        img = Image.fromarray(self.image)
        draw = ImageDraw.Draw(img)
        for (x1, y1, x2, y2), s, c in zip(self.boxes, self.scores, self.classes):
            c = int(c)
            name = self.names[c] if 0 <= c < len(self.names) else str(c)
            draw.rectangle([x1, y1, x2, y2], outline=(255, 64, 64), width=2)
            draw.text((x1 + 2, max(y1 - 12, 0)), f"{name} {s:.2f}", fill=(255, 255, 0))
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
        self._weights_loaded = False  # True after a checkpoint or train(): train() fine-tunes
        self.trainer = None
        if self.model_spec.endswith(".pt"):
            self._load_checkpoint(self.model_spec)
        else:
            self.family, self.scale = parse_model_spec(self.model_spec)

    def _load_checkpoint(self, path) -> None:
        """Adopt a checkpoint of the port's Trainer: its architecture, nc,
        names, imgsz, and the EMA weights with the live BN statistics."""
        from .train.trainer import checkpoint_family, inference_state_dict, load_checkpoint

        if not Path(path).exists():
            raise FileNotFoundError(f"model weights not found: {path}")
        ckpt = load_checkpoint(path)
        self.family, self.scale = checkpoint_family(ckpt), ckpt["scale"]
        self.nc, self.imgsz = int(ckpt["nc"]), int(ckpt["imgsz"])
        self.names = list(ckpt["names"])
        model = make_detector(self.family, self.scale, self.nc)
        model.load_state_dict(inference_state_dict(ckpt), strict=True)
        self._model = model.to(self.device).eval()
        self._fused_cache = None
        self._weights_loaded = True

    def _ensure_built(self):
        """The f32 model with random weights from ``seed``, built once."""
        if self._model is None:
            self._model = build_detector(f"{self.family}{self.scale}", nc=self.nc,
                                         seed=self.seed, device=self.device)
        return self._model

    def _fused_model(self):
        """BN-folded inference model in ``dtype`` with the 1/255 input
        normalisation folded into the stem, cached per model object: it
        takes raw 0..255 images."""
        model = self._ensure_built()
        cur = self._fused_cache
        if cur is not None and cur[0] is model:
            return cur[1]
        fused = fuse_conv_bn(model, input_scale=1.0 / 255.0)
        fused = fused.to(dtype=self.dtype, memory_format=torch.channels_last).eval()
        self._fused_cache = (model, fused)
        return fused

    def train(self, data: str, **kwargs) -> Dict[str, Any]:
        """Train on a YOLO-layout ``data.yaml`` with the port's Trainer
        (``TrainConfig`` fields by name, other keys into ``cfg.extra``),
        from the loaded weights when there are any (a checkpoint or an
        earlier train()), else from the seed's random init. Afterwards the
        handle predicts with the trained EMA weights, nc, names and imgsz."""
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
        self._model = model.to(self.device).eval()
        self._fused_cache = None
        self.save_dir = result["save_dir"]
        self._weights_loaded = True  # a further train() continues from these
        return result

    def export(self, out_dir) -> Path:
        """Write a serving bundle: ``variables.pt``, the BN-folded weights
        under the detector's state-dict keys as the JAX ``fuse_conv_bn``
        stores a fold (``models.yolo11.folded_state_dict``; no 1/255 input
        fold), written by ``torch.save``, and ``meta.json`` with the JAX
        bundle's keys (family, scale, nc, names, imgsz, fused, int8). Load
        it with ``YOLO.from_export``."""
        model = self._ensure_built()
        out_dir = Path(out_dir).resolve()
        out_dir.mkdir(parents=True, exist_ok=True)
        torch.save({k: v.cpu() for k, v in folded_state_dict(model).items()},
                   out_dir / "variables.pt")
        (out_dir / "meta.json").write_text(json.dumps({
            "family": self.family, "scale": self.scale, "nc": self.nc,
            "names": list(self.names), "imgsz": self.imgsz, "fused": True, "int8": False,
        }, ensure_ascii=False))
        return out_dir

    @classmethod
    def from_export(cls, bundle_dir, device=None) -> "YOLO":
        """Load a serving bundle written by ``export()``: the plain detector
        of its family, scale and nc, loaded strictly with the folded weights
        (``_fused_model()`` folds them again to the same bits), on the card
        unless ``device="cpu"``. The JAX package's bundles hold orbax
        checkpoints, which need jax to read: this package reads only its
        own. An int8 bundle raises NotImplementedError."""
        bundle_dir = Path(bundle_dir).resolve()
        meta = json.loads((bundle_dir / "meta.json").read_text())
        if meta.get("int8"):
            raise NotImplementedError(f"{bundle_dir}: {INT8_NOT_PORTED}")
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
        handle._model = model.to(handle.device).eval()
        handle._fused_cache = None
        handle._weights_loaded = True
        return handle

    def val(self, data: str, int8: bool = False, **kwargs) -> Dict[str, float]:
        """Validate the handle's weights on a YOLO-layout ``data.yaml`` with
        the port's Trainer (``TrainConfig`` fields by name): its live model
        and EMA both take the weights, and ``Trainer.validate``'s metrics
        come back; nothing is trained and no plot is written."""
        from .train.trainer import Trainer, make_config

        if int8:
            raise NotImplementedError(INT8_NOT_PORTED)
        kwargs.setdefault("device", "cpu" if self.device.type == "cpu" else "")
        cfg = make_config(f"{self.family}{self.scale}", data, **kwargs)
        cfg.val = True
        trainer = Trainer(cfg, init_state_dict=self._ensure_built().state_dict())
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
        if isinstance(source, (str, Path)):
            p = Path(source)
            sources = sorted(q for q in p.iterdir()
                             if q.suffix.lower() in IMAGE_SUFFIXES) if p.is_dir() else [p]
        elif isinstance(source, np.ndarray):
            sources = [source]
        else:
            sources = list(source)

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

"""High-level model API: ``YOLO("yolo11n").predict(...)``.

Counterpart of the predict path of ``deal_yolo_daya_tpu/api.py``: the model
handle, the BN-folded inference model with the 1/255 folded into the stem,
host letterbox, batched device forward, decode, NMS, and ``Detections`` in
original-image pixels. The model runs on the card unless the caller passes
``device="cpu"``.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from .device import resolve_device
from .models.yolo11 import build_yolo11, fuse_conv_bn
from .ops.decode import decode_predictions
from .ops.letterbox import letterbox_numpy, load_image
from .ops.nms import batched_nms

IMAGE_SUFFIXES = {".jpg", ".jpeg", ".png", ".bmp", ".webp"}


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


def parse_model_spec(model: str) -> str:
    """'yolo11n' | 'yolo11s.yaml' | 'n' -> the yolo11 scale letter."""
    stem = Path(str(model)).stem.lower()
    if stem in ("n", "s"):
        return stem
    if stem.startswith(("yolo11", "yolov11")) and stem[-1] in "ns":
        return stem[-1]
    raise ValueError(f"unsupported model spec {model!r}: yolo11n or yolo11s")


class YOLO:
    """YOLO11 model handle.

    >>> model = YOLO("yolo11n")                       # on the card, bf16
    >>> results = model.predict(["img.jpg"])
    >>> model = YOLO("yolo11n", device="cpu", dtype=torch.float32)
    """

    def __init__(self, model: str = "yolo11n", nc: int = 80, imgsz: int = 640,
                 device=None, dtype: Optional[torch.dtype] = None, seed: int = 0):
        self.model_spec = str(model)
        self.scale = parse_model_spec(self.model_spec)
        self.nc = nc
        self.imgsz = imgsz
        self.seed = seed
        self.device = resolve_device(device)
        self.dtype = dtype or (torch.bfloat16 if self.device.type == "cuda" else torch.float32)
        self.names: List[str] = [str(i) for i in range(nc)]
        self._model = None
        self._fused_cache = None

    def _ensure_built(self):
        """The f32 model with random weights from ``seed``, built once."""
        if self._model is None:
            self._model = build_yolo11(self.scale, nc=self.nc, seed=self.seed,
                                       device=self.device)
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

    @torch.no_grad()
    def infer(self, batch: torch.Tensor, conf: float = 0.25, iou: float = 0.7,
              max_det: int = 300, agnostic: bool = False):
        """(B, S, S, 3) uint8 letterboxed batch on the model's device ->
        (boxes, scores, classes, n_det) padded to max_det, on the device."""
        x = batch.permute(0, 3, 1, 2).to(self.dtype)  # NCHW view, channels_last strides
        box, cls = self._fused_model()(x)
        boxes, scores = decode_predictions(box, cls, (self.imgsz, self.imgsz))
        return batched_nms(boxes, scores, conf_thres=conf, iou_thres=iou,
                           pre_topk=1000, max_det=max_det, class_agnostic=agnostic)

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

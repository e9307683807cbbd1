"""Input pipeline: the YOLO-layout dataset reader, the batch loader and a
background prefetcher.

Counterpart of ``deal_yolo_daya_tpu/train/data.py``. It reads the dataset
layout datakit writes (``images/{split}``, ``labels/{split}/*.txt`` with
normalised ``cls cx cy w h`` rows, ``data.yaml``). Batches have fixed shapes:
u8 images (B, S, S, 3) and labels padded to ``max_boxes`` with a validity
mask. The order and the per-epoch seeding are the JAX package's, so both
packages draw the same batches:

- ``epoch_indices``/``epoch_raw``/``raw_chunks`` feed the on-card
  augmentation (``train/device_augment.py``): one keep-ratio resize a sample
  on the host, top-left in an (S, S) canvas;
- ``epoch`` is the host-augmented pass (``train/augment.py``: mosaic,
  affine, mixup, HSV and flips, in numpy, in worker threads, one
  ``default_rng((seed, epoch, slot))`` a sample as in the JAX package) or,
  without ``augment``, the letterboxed pass validation reads, with each
  image's (path, original (h, w), scale, pad).

Images are resized with PyTorch's uint8 bilinear (``ops/letterbox.py``)
where the JAX package uses cv2's, so a resized pixel may differ by a level;
a source already at ``imgsz`` is not resized by either.
"""

from __future__ import annotations

import concurrent.futures as cf
import queue
import threading
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import yaml

from ..ops.letterbox import letterbox_numpy, load_image
from .augment import (AugmentConfig, flips, hsv_jitter, mixup, mosaic4, random_affine,
                      resize_keep_ratio)

MAX_BOXES = 128
IMAGE_EXTS = {".jpg", ".jpeg", ".png", ".bmp", ".webp", ".tif", ".tiff"}


@dataclass
class YoloDataset:
    """Index over one split of a YOLO-layout dataset."""

    root: Path
    split: str
    names: List[str]
    images: List[Path] = field(default_factory=list)
    labels: List[np.ndarray] = field(default_factory=list)  # (N, 5) cls, cx, cy, w, h

    @classmethod
    def from_yaml(cls, data_yaml: str, split: str = "train") -> "YoloDataset":
        data_yaml = Path(data_yaml)
        data = yaml.safe_load(data_yaml.read_text(encoding="utf-8"))
        root_value = data.get("path")
        root = Path(root_value) if root_value else data_yaml.parent
        if not root.is_absolute():
            root = (data_yaml.parent / root).resolve()
        names = data.get("names") or []
        if isinstance(names, dict):
            names = [names[k] for k in sorted(names)]
        img_dir = root / (data.get(split) or f"images/{split}")

        ds = cls(root=root, split=split, names=list(names))
        if not img_dir.exists():
            return ds
        for img_path in sorted(img_dir.iterdir()):
            if img_path.suffix.lower() not in IMAGE_EXTS:
                continue
            label_path = (Path(str(img_path.parent).replace("images", "labels", 1))
                          / f"{img_path.stem}.txt")
            rows = []
            if label_path.exists():
                for line in label_path.read_text(encoding="utf-8").splitlines():
                    parts = line.split()
                    if len(parts) >= 5:
                        rows.append([float(v) for v in parts[:5]])
            ds.images.append(img_path)
            ds.labels.append(np.asarray(rows, np.float32).reshape(-1, 5)
                             if rows else np.zeros((0, 5), np.float32))
        return ds

    def __len__(self) -> int:
        return len(self.images)

    @property
    def nc(self) -> int:
        return len(self.names)

    def enable_cache(self):
        """Keep decoded images in host RAM (the ``cache=True`` option)."""
        self._cache: Dict[int, np.ndarray] = {}

    def image(self, idx: int) -> np.ndarray:
        cache = getattr(self, "_cache", None)
        if cache is None:
            return load_image(self.images[idx])
        img = cache.get(idx)
        if img is None:
            img = cache[idx] = load_image(self.images[idx])
        return img

    def boxes_xyxy(self, idx: int, w: int, h: int) -> Tuple[np.ndarray, np.ndarray]:
        """Denormalised xyxy pixel boxes and class ids of image ``idx``."""
        lab = self.labels[idx]
        if len(lab) == 0:
            return np.zeros((0, 4), np.float32), np.zeros((0,), np.int64)
        cls = lab[:, 0].astype(np.int64)
        cx, cy, bw, bh = lab[:, 1] * w, lab[:, 2] * h, lab[:, 3] * w, lab[:, 4] * h
        boxes = np.stack([cx - bw / 2, cy - bh / 2, cx + bw / 2, cy + bh / 2], 1)
        return boxes.astype(np.float32), cls


@dataclass
class RawBatch:
    """A batch for the on-card augmentation: images keep-ratio resized into
    a fixed (S, S) canvas, top-left anchored."""

    images: np.ndarray        # (B, S, S, 3) uint8 RGB, fill 114
    hw: np.ndarray            # (B, 2) float32 content (h, w) inside the canvas
    gt_boxes: np.ndarray      # (B, M, 4) xyxy in canvas pixels
    gt_classes: np.ndarray    # (B, M) int32
    gt_mask: np.ndarray       # (B, M) bool


@dataclass
class Batch:
    images: np.ndarray        # (B, S, S, 3) uint8 RGB
    gt_boxes: np.ndarray      # (B, M, 4) xyxy pixels in the letterboxed frame
    gt_classes: np.ndarray    # (B, M) int32
    gt_mask: np.ndarray       # (B, M) bool
    meta: Optional[list] = None  # per image (path, orig (h, w), scale, (pad_x, pad_y))


def _pad_labels(boxes: np.ndarray, classes: np.ndarray, max_boxes: int):
    m = min(len(boxes), max_boxes)
    out_b = np.zeros((max_boxes, 4), np.float32)
    out_c = np.zeros((max_boxes,), np.int32)
    out_m = np.zeros((max_boxes,), bool)
    if m:
        out_b[:m] = boxes[:m]
        out_c[:m] = classes[:m]
        out_m[:m] = True
    return out_b, out_c, out_m


class DataLoader:
    """Batch iterator with the JAX package's deterministic order: the epoch's
    permutation comes from ``default_rng(seed + 1000 * epoch)`` (no shuffle:
    dataset order), the short final batch wraps to full size. With
    ``augment``, ``epoch`` applies the host augmentation of ``aug_config``
    (mosaic with probability ``mosaic`` until ``mosaic_off``, the close_mosaic
    hook, turns it off; else the letterboxed image through the affine)."""

    def __init__(self, dataset: YoloDataset, batch_size: int, imgsz: int = 640,
                 augment: bool = True, aug_config: Optional[AugmentConfig] = None,
                 seed: int = 0, max_boxes: int = MAX_BOXES,
                 shuffle: Optional[bool] = None, drop_last: Optional[bool] = None,
                 keep_meta: bool = False):
        self.ds = dataset
        self.batch_size = batch_size
        self.imgsz = imgsz
        self.augment = augment
        self.cfg = aug_config or AugmentConfig()
        self.seed = seed
        self.max_boxes = max_boxes
        self.shuffle = augment if shuffle is None else shuffle
        self.drop_last = augment if drop_last is None else drop_last
        self.keep_meta = keep_meta
        self.mosaic_off = False  # the close_mosaic hook

    def __len__(self) -> int:
        n = len(self.ds)
        if self.drop_last:
            return max(n // self.batch_size, 1) if n else 0
        return (n + self.batch_size - 1) // self.batch_size

    def epoch_indices(self, epoch_idx: int = 0) -> Iterator[np.ndarray]:
        """The dataset indices of each batch of the epoch, the short final
        batch wrapped to full size."""
        n = len(self.ds)
        if n == 0:
            return
        rng = np.random.default_rng(self.seed + 1000 * epoch_idx)
        order = rng.permutation(n) if self.shuffle else np.arange(n)
        for b in range(len(self)):
            idxs = order[b * self.batch_size:(b + 1) * self.batch_size]
            if len(idxs) == 0:
                break
            while len(idxs) < self.batch_size:
                idxs = np.concatenate([idxs, order[:self.batch_size - len(idxs)]])
            yield idxs

    def sharded_epoch_indices(self, epoch_idx: int, n_data: int) -> Iterator[np.ndarray]:
        """The epoch's batches over a train set split by rows into
        ``n_data`` shards, as the JAX Trainer's ``_sharded_epoch_indices``:
        shard d (rows d * ceil(n / n_data) on) draws its rows from its own
        permutation, ``default_rng(seed + 1000 * epoch + 7919 * d)``, and
        each (B,) batch lays the shards' B / n_data indices side by side,
        each LOCAL to its shard (rank d takes ``batch[rows(B)]``)."""
        n = len(self.ds)
        shard_n = -(-n // n_data)
        per_dev = self.batch_size // n_data
        orders = [np.random.default_rng(self.seed + 1000 * epoch_idx + 7919 * d)
                  .permutation(min(shard_n, n - d * shard_n)) for d in range(n_data)]
        for b in range(len(self)):
            yield np.concatenate([
                orders[d][np.arange(b * per_dev, (b + 1) * per_dev) % len(orders[d])]
                for d in range(n_data)])

    def _mosaic_sample(self, idx: int, rng: np.random.Generator):
        others = rng.integers(0, len(self.ds), 3)
        imgs, bxs, cls = [], [], []
        for j in [idx, *others.tolist()]:
            img = self.ds.image(j)
            h, w = img.shape[:2]
            b, c = self.ds.boxes_xyxy(j, w, h)
            imgs.append(img)
            bxs.append(b)
            cls.append(c)
        return mosaic4(imgs, bxs, cls, self.imgsz, rng, self.cfg)

    def _load_one(self, idx: int, rng: np.random.Generator):
        """One sample, augmented or letterboxed: (image, boxes, classes,
        meta; meta is None when augmented)."""
        if self.augment and not self.mosaic_off and rng.random() < self.cfg.mosaic:
            img, boxes, classes = self._mosaic_sample(idx, rng)
            if self.cfg.mixup > 0 and rng.random() < self.cfg.mixup:
                j = int(rng.integers(0, len(self.ds)))
                img, boxes, classes = mixup(img, boxes, classes,
                                            *self._mosaic_sample(j, rng), rng)
            meta = None
        else:
            img = self.ds.image(idx)
            h, w = img.shape[:2]
            boxes, classes = self.ds.boxes_xyxy(idx, w, h)
            img, r, (px, py) = letterbox_numpy(img, self.imgsz)
            if len(boxes):
                boxes = boxes * r + [px, py, px, py]
            meta = (str(self.ds.images[idx]), (h, w), r, (px, py))
            if self.augment:
                img, boxes, classes = random_affine(img, boxes, classes, rng, self.cfg,
                                                    self.imgsz)
                meta = None
        if self.augment:
            img = hsv_jitter(img, rng, self.cfg)
            img, boxes = flips(img, boxes, rng, self.cfg)
        return img, boxes, classes, meta

    def epoch(self, epoch_idx: int = 0, n_workers: int = 8,
              rows: Optional[slice] = None) -> Iterator[Batch]:
        """The epoch's batches: host-augmented with ``augment`` (a
        ``default_rng((seed, epoch, slot))`` a sample), else letterboxed.
        The samples of a batch are built in worker threads. ``rows``: only
        those rows of each batch (a data-parallel rank's), the same samples
        as the whole batch's rows."""
        def build_one(args):
            slot, i = args
            rng = np.random.default_rng((self.seed, epoch_idx, int(slot)) if self.augment
                                        else (self.seed, int(i)))
            img, boxes, classes, meta = self._load_one(int(i), rng)
            return (np.ascontiguousarray(img, dtype=np.uint8),
                    *_pad_labels(boxes, classes, self.max_boxes), meta)

        with cf.ThreadPoolExecutor(max_workers=n_workers) as pool:
            for b, idxs in enumerate(self.epoch_indices(epoch_idx)):
                slots = [(b * self.batch_size + j, i) for j, i in enumerate(idxs)]
                slots = slots[rows] if rows is not None else slots
                images, gtb, gtc, gtm, metas = zip(*pool.map(build_one, slots))
                yield Batch(images=np.stack(images), gt_boxes=np.stack(gtb),
                            gt_classes=np.stack(gtc), gt_mask=np.stack(gtm),
                            meta=list(metas) if self.keep_meta else None)

    def load_raw(self, i):
        """Decode and keep-ratio resize one sample onto an imgsz canvas:
        (u8 canvas, f32 (h, w), padded boxes, classes, mask)."""
        s = self.imgsz
        img = self.ds.image(int(i))
        h0, w0 = img.shape[:2]
        img, r = resize_keep_ratio(img, s)
        h, w = img.shape[:2]
        buf = np.full((s, s, 3), 114, np.uint8)
        buf[:h, :w] = img
        boxes, classes = self.ds.boxes_xyxy(int(i), w0, h0)
        if len(boxes):
            boxes = boxes * r
        pb, pc, pm = _pad_labels(boxes, classes, self.max_boxes)
        return buf, np.float32((h, w)), pb, pc, pm

    def raw_chunks(self, chunk_size: int = 256, n_workers: int = 8,
                   first: int = 0, stop: Optional[int] = None):
        """The dataset's samples ``first`` .. ``stop`` - 1 (all by default) in
        order, in stacked chunks: the feed of the trainer's device cache (a
        data-parallel rank's shard of it)."""
        stop = len(self.ds) if stop is None else stop
        with cf.ThreadPoolExecutor(max_workers=n_workers) as pool:
            for start in range(first, stop, chunk_size):
                rows = list(pool.map(self.load_raw, range(start, min(start + chunk_size, stop))))
                yield tuple(np.stack(col) for col in zip(*rows))

    def epoch_raw(self, epoch_idx: int = 0, n_workers: int = 8,
                  rows: Optional[slice] = None) -> Iterator[RawBatch]:
        """Decode-and-resize epoch for the on-card augmentation; ``rows``:
        only those rows of each batch (a data-parallel rank's)."""
        with cf.ThreadPoolExecutor(max_workers=n_workers) as pool:
            for idxs in self.epoch_indices(epoch_idx):
                idxs = idxs[rows] if rows is not None else idxs
                images, hw, gtb, gtc, gtm = zip(*pool.map(self.load_raw, idxs))
                yield RawBatch(images=np.stack(images), hw=np.stack(hw),
                               gt_boxes=np.stack(gtb), gt_classes=np.stack(gtc),
                               gt_mask=np.stack(gtm))


class Prefetcher:
    """Runs an iterator in a background thread, ``depth`` items ahead.

    ``transfer`` (optional) runs on each item inside the thread: pass the
    copy to the card, so that it overlaps the consumer. An exception in the
    thread is raised in the consumer."""

    def __init__(self, loader_iter, depth: int = 3, transfer=None):
        self._queue: "queue.Queue" = queue.Queue(maxsize=depth)
        self._done = object()
        self._err: Optional[BaseException] = None

        def _worker():
            try:
                for item in loader_iter:
                    self._queue.put(item if transfer is None else transfer(item))
            except BaseException as e:  # raised again in the consumer
                self._err = e
            finally:
                self._queue.put(self._done)

        self._thread = threading.Thread(target=_worker, daemon=True)
        self._thread.start()

    def __iter__(self):
        while True:
            item = self._queue.get()
            if item is self._done:
                if self._err is not None:
                    raise self._err
                return
            yield item

"""Production serving: a concurrent micro-batching inference engine and a
stdlib HTTP frontend, on the card.

Counterpart of ``deal_yolo_daya_tpu/serve.py``. Requests from any number of
client threads are letterboxed on the callers' threads and coalesced into
device batches, each padded up to a power-of-two bucket (1, 2, 4, ...,
max_batch).

Design (CUDA-first):

- One CUDA graph a bucket, the counterpart of the JAX package's one
  compiled executable a bucket. The work of ``YOLO.infer`` (the BN-folded
  forward, or after ``quantize_int8`` the int8 model with its s8 conv
  kernels, as the JAX Engine's int8 branch; decode, ``batched_nms``) is
  captured once per bucket from a
  static (b, S, S, 3) uint8 input buffer into static outputs, in the
  bucket's own memory pool (buckets replay in any order, which a shared
  pool does not allow). Every served batch on the card is one replay: the
  area-attention and NMS kernels run inside it with no Python launch. There
  is no eager path on the card: a capture that fails raises from
  ``warmup()`` or fails its batch's futures and counts them in ``errors``.
  On the CPU, which only a caller asking for it gets, a bucket's program is
  the eager ``YOLO.infer``.
- conf and iou are engine-wide, as in the JAX package (per-request values
  would splinter batches and are refused), so each graph bakes them in.
- A ring of ``max_in_flight + 1`` slots, each a pinned host staging buffer
  for the canvases, pinned buffers for the four outputs and a CUDA event.
  The dispatcher fills a free slot, copies it into the bucket's static
  input, replays the graph and copies the static outputs into the slot, all
  on one serving stream (so no later replay can overwrite the outputs
  first), records the event and hands the batch on. The completion thread
  waits on the event, maps the boxes back to original pixels, resolves the
  futures, and only then frees the slot. Host pre- and post-processing
  overlap the device's work.
- Capture and replay take one lock: ``warmup()`` after ``start()`` never
  captures while the dispatcher replays.

Usage::

    eng = Engine(YOLO("yolo11n"))            # or YOLO.from_export(dir)
    eng.warmup()                             # capture every bucket's graph
    with eng:
        fut = eng.submit(rgb_u8_array)       # returns concurrent Future
        dets = fut.result()                  # api.Detections
    print(eng.stats())

    serve_http(eng, port=8000)               # stdlib HTTP frontend:
    # POST /predict  (image bytes)  -> JSON detections
    # GET  /healthz, /stats
"""

from __future__ import annotations

import contextlib
import io
import json
import queue
import struct
import threading
import time
import zlib
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .api import Detections, infer_fused
from .ops import png
from .ops.kernels._build import GraphLaunches
from .ops.letterbox import letterbox_numpy

# eager runs of a bucket's program on a side stream before its capture
# (PyTorch's rule for graphs); they also make the lazy work happen outside
# the capture: the nvcc builds, the BN fold, cuDNN's algorithm choice and
# the card's cluster counts for NMS
WARMUP_RUNS = 3


@dataclass
class _Request:
    image: np.ndarray               # original RGB uint8 (H, W, 3)
    canvas: np.ndarray              # letterboxed (imgsz, imgsz, 3)
    ratio: float
    pad: Tuple[int, int]
    future: Future
    t_submit: float


@dataclass
class ServeStats:
    """Rolling serving metrics (thread-safe snapshots via Engine.stats)."""

    requests: int = 0
    completed: int = 0
    errors: int = 0
    batches: int = 0
    padded_slots: int = 0
    batch_sizes: List[int] = field(default_factory=list)
    latencies_ms: List[float] = field(default_factory=list)

    def snapshot(self) -> Dict[str, float]:
        lat = sorted(self.latencies_ms[-2048:])
        n = len(lat)
        out = {
            "requests": self.requests,
            "completed": self.completed,
            "errors": self.errors,
            "batches": self.batches,
            "avg_batch": (sum(self.batch_sizes[-2048:]) /
                          max(len(self.batch_sizes[-2048:]), 1)),
            "pad_fraction": (self.padded_slots /
                             max(self.padded_slots + self.completed, 1)),
        }
        if n:
            out["p50_ms"] = lat[n // 2]
            out["p95_ms"] = lat[min(n - 1, int(n * 0.95))]
        return out


class BucketProgram:
    """One bucket's serving program: a static (bucket, S, S, 3) uint8
    ``images`` buffer on ``device``, the static ``outputs`` of ``infer`` on
    it (boxes, scores, classes, n_det), and ``replay()``.

    On the card the program is captured here as a CUDA graph, after
    ``WARMUP_RUNS`` eager runs on a side stream, with a memory pool of its
    own (``pool_bytes``: what the capture reserved); ``capture_s`` is the
    wall of both. The graph reads the weights ``infer`` holds by address,
    so they must outlive it (the Engine keeps them). Each replay adds the
    graph's kernel launches to the kernels' counters (``launches``). On
    the CPU ``replay()`` runs ``infer`` eagerly, once here."""

    def __init__(self, infer: Callable[[torch.Tensor], tuple], bucket: int, imgsz: int,
                 device: torch.device):
        self.bucket = bucket
        self.images = torch.zeros((bucket, imgsz, imgsz, 3), dtype=torch.uint8, device=device)
        self._run = lambda: infer(self.images)
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.launches = GraphLaunches()
        self.pool_bytes = 0
        t0 = time.perf_counter()
        if device.type == "cuda":
            self._capture(device)
        else:
            self.replay()
        self.capture_s = time.perf_counter() - t0

    def _capture(self, device: torch.device) -> None:
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            for _ in range(WARMUP_RUNS):
                self._run()
        torch.cuda.current_stream(device).wait_stream(side)
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(device)
        graph = torch.cuda.CUDAGraph()
        # thread_local: the completion thread may wait on an event meanwhile
        with torch.cuda.graph(graph, capture_error_mode="thread_local"), \
                self.launches.capture():
            self.outputs = self._run()
        self.pool_bytes = torch.cuda.memory_reserved(device) - reserved
        self.graph = graph

    def replay(self) -> None:
        """Run the program on ``images`` into ``outputs`` (on the current
        stream, asynchronously, on the card)."""
        if self.graph is None:
            self.outputs = self._run()
        else:
            self.graph.replay()
            self.launches.replayed()


class _Slot:
    """A pinned host staging buffer for max_batch canvases, pinned buffers
    for the four outputs and an event (on the card; plain host tensors and
    no event on the CPU)."""

    def __init__(self, max_batch: int, imgsz: int, max_det: int, device: torch.device):
        pin = device.type == "cuda"
        self.canvases = torch.zeros((max_batch, imgsz, imgsz, 3), dtype=torch.uint8,
                                    pin_memory=pin)
        self.outputs = tuple(torch.zeros(shape, dtype=dt, pin_memory=pin) for shape, dt in (
            ((max_batch, max_det, 4), torch.float32), ((max_batch, max_det), torch.float32),
            ((max_batch, max_det), torch.int32), ((max_batch,), torch.int32)))
        self.event = torch.cuda.Event() if pin else None


class Engine:
    """Micro-batching inference engine over an ``api.YOLO`` handle.

    Parameters
    ----------
    model:        a built (or buildable) api.YOLO; its imgsz, weights,
                  device and dtype define the serving program.
    max_batch:    largest device batch (power of two recommended).
    max_wait_ms:  how long the oldest queued request may wait for the batch
                  to fill before dispatching a partial batch.
    max_in_flight: device batches allowed pending before the dispatcher
                  blocks (2 = classic double buffering).
    conf, iou:    engine-wide thresholds (per-request values are refused).

    The Engine serves the BN-folded weights the handle holds when the
    Engine is made, and keeps them alive for its graphs, which read them by
    address: a later ``train()`` or checkpoint load of the handle does not
    reach it (as the JAX Engine binds its variables once). Make a new
    Engine to serve new weights.
    """

    def __init__(self, model, max_batch: int = 32, max_wait_ms: float = 5.0,
                 max_in_flight: int = 2, conf: float = 0.25, iou: float = 0.7,
                 max_det: int = 300):
        model._ensure_built()
        self.model = model
        # pinned: the graphs read these weights by address
        self._net, self._dtype = model._fused_model(), model.dtype
        self.device = model.device
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.imgsz = int(model.imgsz)
        self.max_batch = max(1, int(max_batch))
        self.max_wait_s = max_wait_ms / 1e3
        self.max_in_flight = max(1, int(max_in_flight))
        self.conf, self.iou, self.max_det = conf, iou, max_det
        self._queue: "queue.Queue[_Request]" = queue.Queue()
        self._pending: "queue.Queue" = queue.Queue()
        self._free: "queue.Queue[_Slot]" = queue.Queue()
        self._slots: List[_Slot] = []
        self._stats = ServeStats()
        self._lock = threading.Lock()
        self._device_lock = threading.Lock()  # capture and replay
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        self._programs: Dict[int, BucketProgram] = {}
        self._stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None

    # ------------------------------------------------------------ programs

    def _bucket(self, n: int) -> int:
        b = 1
        while b < n:
            b <<= 1
        return min(b, self.max_batch)

    def buckets(self) -> List[int]:
        """Every bucket size: the powers of two below max_batch, and max_batch."""
        out, b = [], 1
        while b < self.max_batch:
            out.append(b)
            b <<= 1
        return out + [self.max_batch]

    def program(self, bucket: int) -> BucketProgram:
        """The bucket's program, captured (or, on the CPU, run once) on first use."""
        with self._device_lock:
            prog = self._programs.get(bucket)
            if prog is None:
                prog = BucketProgram(self._infer, bucket, self.imgsz, self.device)
                self._programs[bucket] = prog
            return prog

    def _infer(self, images: torch.Tensor):
        return infer_fused(self._net, images, self._dtype, self.conf, self.iou, self.max_det)

    def warmup(self, buckets: Optional[Sequence[int]] = None) -> "Engine":
        """Capture every bucket's graph (or the given sizes) not captured yet,
        before taking traffic; idempotent, before or after ``start()``. A
        failed capture raises here."""
        for n in self.buckets() if buckets is None else buckets:
            self.program(int(n))
        return self

    def _stream_ctx(self):
        return contextlib.nullcontext() if self._stream is None else torch.cuda.stream(self._stream)

    # ------------------------------------------------------------------ API

    def start(self):
        if self._threads:
            return self
        self._stop.clear()
        if not self._slots:
            self._slots = [_Slot(self.max_batch, self.imgsz, self.max_det, self.device)
                           for _ in range(self.max_in_flight + 1)]
            for slot in self._slots:
                self._free.put(slot)
        for name, fn in (("dyd-serve-dispatch", self._dispatch_loop),
                         ("dyd-serve-complete", self._complete_loop)):
            t = threading.Thread(target=fn, name=name, daemon=True)
            t.start()
            self._threads.append(t)
        return self

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.shutdown()

    def shutdown(self, timeout: float = 30.0):
        self._stop.set()
        for t in self._threads:
            t.join(timeout=timeout)
        # under the lock, so a submit() racing the guard either lands its
        # request before this drain (and gets failed here) or sees the
        # cleared thread list and raises — never an unwatched queue entry
        with self._lock:
            self._threads.clear()
            while True:
                try:
                    req = self._queue.get_nowait()
                except queue.Empty:
                    break
                req.future.set_exception(RuntimeError("engine shut down"))

    def submit(self, image: np.ndarray, conf: Optional[float] = None,
               iou: Optional[float] = None) -> Future:
        """Enqueue one RGB uint8 (H, W, 3) image; resolves to Detections.

        Letterboxing happens on the caller's thread (it scales across client
        threads; the single dispatcher stays on the device). Per-request
        conf/iou would splinter batches, so they are engine-level here."""
        if conf is not None or iou is not None:
            raise ValueError(
                "per-request conf/iou not supported; configure the Engine "
                "(thresholds are engine-wide, baked into each bucket's graph)"
            )
        if image.ndim != 3 or image.shape[-1] != 3:
            raise ValueError(f"expected (H, W, 3) RGB image, got {image.shape}")
        canvas, r, pad = letterbox_numpy(image, self.imgsz)
        fut: Future = Future()
        req = _Request(image, canvas, r, pad, fut, time.perf_counter())
        with self._lock:
            if self._stop.is_set() and not self._threads:
                # post-shutdown submits would otherwise queue forever with
                # no dispatcher left to fail them; guard+put share the lock
                # with shutdown's drain, so no request can slip between
                raise RuntimeError("engine is shut down")
            self._stats.requests += 1
            self._queue.put(req)
        return fut

    def stats(self) -> Dict[str, float]:
        with self._lock:
            return self._stats.snapshot()

    # ------------------------------------------------------------ internals

    def _fail(self, batch: List[_Request], err: BaseException) -> None:
        with self._lock:
            self._stats.errors += len(batch)
        for r in batch:
            if not r.future.done():
                r.future.set_exception(err)

    def _launch(self, batch: List[_Request], bucket: int, slot: _Slot) -> None:
        """Stage the canvases, replay the bucket's program and copy its
        outputs into the slot; on the card all of it is queued on the
        serving stream and the slot's event marks its end."""
        canvases = slot.canvases.numpy()
        for i, r in enumerate(batch):
            canvases[i] = r.canvas
        canvases[len(batch):bucket] = 0
        prog = self.program(bucket)
        with self._device_lock, self._stream_ctx():
            prog.images.copy_(slot.canvases[:bucket], non_blocking=True)
            prog.replay()
            for dst, src in zip(slot.outputs, prog.outputs):
                dst[:bucket].copy_(src, non_blocking=True)
            if slot.event is not None:
                slot.event.record()

    def _dispatch_loop(self):
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        while not self._stop.is_set():
            try:
                first = self._queue.get(timeout=0.05)
            except queue.Empty:
                continue
            batch = [first]
            # under backpressure the queue already holds a backlog — take it
            # without consulting the deadline (load must GROW batches, not
            # shrink them to singles because the oldest request aged out)
            while len(batch) < self.max_batch:
                try:
                    batch.append(self._queue.get_nowait())
                except queue.Empty:
                    break
            deadline = first.t_submit + self.max_wait_s
            while len(batch) < self.max_batch:
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    break
                try:
                    batch.append(self._queue.get(timeout=remaining))
                except queue.Empty:
                    break
            bucket = self._bucket(len(batch))
            slot = self._free.get()  # blocks while every slot is in flight
            try:
                self._launch(batch, bucket, slot)
            except Exception as e:  # a failed capture or launch fails this batch
                self._fail(batch, e)
                self._free.put(slot)
                continue
            with self._lock:
                self._stats.batches += 1
                self._stats.batch_sizes.append(len(batch))
                self._stats.padded_slots += bucket - len(batch)
            self._pending.put((batch, slot))
        # drain marker for the completion worker
        self._pending.put(None)

    def _complete_loop(self):
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        while True:
            item = self._pending.get()
            if item is None:
                break
            batch, slot = item
            try:
                if slot.event is not None:
                    slot.event.synchronize()
            except Exception as e:  # device failure: fail the whole batch
                self._fail(batch, e)
                self._free.put(slot)
                continue
            ob, osc, ocl, nd = (t.numpy() for t in slot.outputs)
            t_done = time.perf_counter()
            for i, r in enumerate(batch):
                n = int(nd[i])
                boxes = ob[i, :n].copy()
                if n:
                    px, py = r.pad
                    boxes -= [px, py, px, py]
                    boxes /= r.ratio
                    h, w = r.image.shape[:2]
                    boxes[:, [0, 2]] = boxes[:, [0, 2]].clip(0, w)
                    boxes[:, [1, 3]] = boxes[:, [1, 3]].clip(0, h)
                det = Detections(
                    path=None, image=r.image, boxes=boxes,
                    scores=osc[i, :n].copy(), classes=ocl[i, :n].copy(),
                    names=self.model.names,
                )
                if not r.future.cancelled():
                    r.future.set_result(det)
                with self._lock:
                    self._stats.completed += 1
                    self._stats.latencies_ms.append((t_done - r.t_submit) * 1e3)
            self._free.put(slot)  # the slot's buffers are read: refill it


# ---------------------------------------------------------------------- HTTP


class UndecodableImage(ValueError):
    """The request body is no image that an installed decoder can read."""


def decode_image(raw: bytes) -> np.ndarray:
    """Image bytes -> RGB uint8 (H, W, 3): cv2 where installed, else PIL,
    else PNG through the port's own reader (``ops/png.py``). Raises
    ``UndecodableImage``, naming the decoders tried or missing, for
    anything else."""
    if not raw:
        raise UndecodableImage("the request body is empty")
    tried = []
    try:
        import cv2
    except ImportError:
        tried.append("cv2 is not installed")
    else:
        try:
            img = cv2.imdecode(np.frombuffer(raw, np.uint8), cv2.IMREAD_COLOR)
        except cv2.error:
            img = None
        if img is not None:
            return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
        tried.append("cv2 cannot decode it")
    try:
        from PIL import Image
    except ImportError:
        tried.append("PIL is not installed")
    else:
        try:
            with Image.open(io.BytesIO(raw)) as im:
                return np.asarray(im.convert("RGB"))
        except (OSError, ValueError) as e:  # UnidentifiedImageError is an OSError
            tried.append(f"PIL cannot decode it ({e})")
    if raw[:8] == png.SIGNATURE:
        try:
            return png.decode_png(raw)
        except (ValueError, struct.error, zlib.error) as e:  # a broken or unsupported PNG
            tried.append(f"the PNG reader cannot decode it ({e})")
    else:
        tried.append("it is not a PNG, the one format read without cv2 or PIL")
    raise UndecodableImage("cannot decode the request body as an image: " + "; ".join(tried))


def serve_http(engine: Engine, host: str = "127.0.0.1", port: int = 8000,
               block: bool = True):
    """Minimal stdlib HTTP frontend over an Engine.

    POST /predict (body = image bytes) -> JSON
      {"boxes": [[x1,y1,x2,y2],...], "scores": [...], "classes": [...],
       "names": [...], "num": N}
    A body that no installed decoder reads answers 415 with a message
    naming the decoders (``decode_image``). GET /healthz -> {"ok": true};
    GET /stats -> ServeStats snapshot.

    Returns the ThreadingHTTPServer (caller owns shutdown when block=False).
    """
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    engine.start()

    class Handler(BaseHTTPRequestHandler):
        def _json(self, code: int, payload: dict):
            body = json.dumps(payload, ensure_ascii=False).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json; charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path.startswith("/healthz"):
                self._json(200, {"ok": True})
            elif self.path.startswith("/stats"):
                self._json(200, engine.stats())
            else:
                self._json(404, {"error": "unknown path"})

        def do_POST(self):
            if not self.path.startswith("/predict"):
                self._json(404, {"error": "unknown path"})
                return
            try:
                length = int(self.headers.get("Content-Length", "0"))
                img = decode_image(self.rfile.read(length))
                det = engine.submit(img).result(timeout=120)
                self._json(200, {
                    "boxes": np.asarray(det.boxes, np.float64).round(2).tolist(),
                    "scores": np.asarray(det.scores, np.float64).round(4).tolist(),
                    "classes": np.asarray(det.classes, np.int64).tolist(),
                    "names": [
                        det.names[int(c)] if 0 <= int(c) < len(det.names)
                        else str(int(c))
                        for c in det.classes
                    ],
                    "num": len(det),
                })
            except UndecodableImage as e:
                self._json(415, {"error": str(e)})
            except Exception as e:  # surface the failure to the client
                self._json(500, {"error": str(e)})

        def log_message(self, *args):  # quiet access log
            pass

    server = ThreadingHTTPServer((host, port), Handler)
    if block:
        try:
            server.serve_forever()
        finally:
            server.server_close()
            engine.shutdown()
    return server

"""Driver ``train_v10``: the ``train`` driver's protocol for a YOLOv10, whose
training differs in kind: two heads, the one-to-many trained with
task-aligned assignment at top-k 10, the one-to-one at top-k 1 on
detached features, the loss their sum.

The same steps as ``drivers/train.py``: set-up makes the weights (the
YOLOv10 reference's, ``reference/yolov10.py::make_weights``) and the device
cache from the seed, builds the program's ``TrainState`` and
``StepProgram`` once and drives their first ``check_steps`` steps one call
each (the eager warm-up steps, then the step graph's capture and first
replay), reads each step's loss and both heads' foreground counts, and for
the first step and the replayed last one each BatchNorm's batch variance,
each leaf's gradient and change; one warm dispatch; the window; then, with
the program freed, the reference follows the checked steps on the same
rows and seeds: from the set-up weights, and the last step from the
program's copied state.

Set-up raises unless the program builds a YOLOv10 for the configuration
(a program without the family would build another detector by its name).

The reference runs on the card in float32 without TF32. Its activations at
b32 and 640 px do not fit beside nothing but itself, so it recomputes each
top-level block in the backward (``torch.utils.checkpoint``); each
BatchNorm's running statistics are those of the forward, moved once.

Compared (``ctx.check``): ``fg`` and ``fg.o2o``, every step's one-to-many
and one-to-one foreground count; ``bn``, the batch variances of the layers
upstream of the PSA block (indices below 10); ``grad`` and ``change``, the
largest group median as ``drivers/train.py`` takes it, with each optimizer
group split into the one-to-one head's leaves and the rest; each with its
``.start`` form for the first step where ``drivers/train.py`` has one.
"""

from __future__ import annotations

import collections
import gc
import importlib.util
import statistics
import sys
import time
from pathlib import Path

from benchmark.lib import compare, trace as T, traffic
from benchmark.reference import train as rtrain, yolov10 as ref

HERE = Path(__file__).resolve().parent


def _base():
    """``drivers/train.py``, whose helpers this driver shares."""
    spec = importlib.util.spec_from_file_location("benchmark_driver_train_base",
                                                  HERE / "train.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


B = _base()
# the PSA block: ultralytics' (and the reference's) 10.attn.* / 10.ffn.* are
# the program's C2PSA at n = 1, 10.m.0.attn.* / 10.m.0.ffn.*
_REF_PSA, _PROG_PSA = ("10.attn.", "10.ffn."), ("10.m.0.attn.", "10.m.0.ffn.")
O2O = ("23.one2one_cv2.", "23.one2one_cv3.")  # the one-to-one head's leaves


def to_program(key: str) -> str:
    for a, b in zip(_REF_PSA, _PROG_PSA):
        if key.startswith(a):
            return b + key[len(a):]
    return key


def to_reference(key: str) -> str:
    for a, b in zip(_PROG_PSA, _REF_PSA):
        if key.startswith(a):
            return b + key[len(a):]
    return key


def _ref_names(d):
    return {to_reference(k): v for k, v in d.items()}


def _ref_readings(readings):
    """A step's readings (``drivers/train.py::_readings``) under the
    reference's names; a change of an EMA leaf is ``ema.<leaf>``."""
    out = {part: _ref_names(d) for part, d in readings.items() if part != "change"}
    out["change"] = {"ema." + to_reference(n[4:]) if n.startswith("ema.") else to_reference(n): v
                     for n, v in readings["change"].items()}
    return out


def _ref_snapshot(snap):
    return {part: _ref_names(d) for part, d in snap.items()}


def _checkpointed(mod, *inputs):
    from torch.utils.checkpoint import checkpoint

    return checkpoint(mod, *inputs, use_reentrant=False)


def reference_steps(ctx, sd, cache, idx, seeds, precision: str, start=None):
    """The reference's checked steps from the set-up weights ``sd``, each on
    its step's rows and seed -> (readings, the state before the last step),
    as ``drivers/train.py::reference_steps``; readings add each step's
    one-to-one foreground count (``fg_o2o``)."""
    import torch

    wl, cfg = ctx.wl, ctx.cfg
    dev = torch.device(ctx.device)
    ref.set_precision(precision)
    model = ref.Detector(cfg).to(dev)
    model.load_state_dict(sd)
    model.train()
    named = list(model.named_parameters())
    params = dict(named)
    sgd = rtrain.SGD(named, wl["optimizer"], wl["data"]["images"] // wl["batch"])
    augp = rtrain.AugParams(**wl["augment"])
    out = {"loss": [], "fg": [], "fg_o2o": [], "dims": {k: p.dim() for k, p in named}}
    before = B._snapshot(sd, {k: torch.zeros_like(p) for k, p in named}, params)
    buffers = [b for n, b in model.named_buffers() if n.endswith(("running_mean", "running_var"))]
    exact = ref.f32_exact()
    exact.__enter__()
    try:
        for i in range(len(seeds)):
            last = i == len(seeds) - 1
            if last:
                own = before = B._snapshot(model.state_dict(), sgd.buf, sgd.ema)
                if start is not None:
                    before = {part: {k: v.to(dev) for k, v in d.items()}
                              for part, d in start.items()}
                    with torch.no_grad():
                        model.load_state_dict(before["model"])
                    sgd.buf = {k: v.clone() for k, v in before["buf"].items()}
                    sgd.ema = {k: v.clone() for k, v in before["ema"].items()}
            d = rtrain.draws(wl["batch"], seeds[i], augp, dev)
            rows = torch.as_tensor(idx[i], device=dev)
            imgs, boxes, cls, mask = rtrain.augment(*(t[rows] for t in cache), d, wl["imgsz"],
                                                    augp, wl["max_boxes"])
            for _, p in named:
                p.grad = None
            outputs = model(imgs.permute(0, 3, 1, 2).float() / 255.0, call=_checkpointed)
            loss, (fg, fg_o2o) = ref.dual_loss(outputs, cls, boxes, mask, wl["imgsz"],
                                               cfg["nc"], tuple(wl["loss_gains"]))
            moved = [b.clone() for b in buffers]  # the forward's statistics, moved once
            loss.backward()
            with torch.no_grad():
                for b, m in zip(buffers, moved):
                    b.copy_(m)
            del outputs, moved
            out["fg"].append(float(fg))
            out["fg_o2o"].append(float(fg_o2o))
            out["loss"].append(float(loss.detach()))
            grad = B._norms({k: p.grad for k, p in named})
            sgd.step()
            if i == 0 or last:
                with torch.no_grad():
                    out["last" if last else "start"] = B._readings(
                        model.state_dict(), params, sgd.ema, grad, before)
    finally:
        exact.__exit__(None, None, None)
        ref.set_precision("f32")
    return out, own


def _require_yolov10(cfg) -> None:
    """Raise unless the program builds a YOLOv10 for ``cfg`` (by the
    registry, before anything is made on the card)."""
    from deal_yolo_daya_tpu_torch.models import registry

    family = registry.parse_model_spec(cfg["model"])[0]
    built = registry.FAMILIES.get(family)
    if family != cfg["family"] or getattr(built, "FAMILY", None) != cfg["family"]:
        raise RuntimeError(f"the program builds {family!r} for {cfg['model']!r}, not "
                           f"{cfg['family']!r}: it has no {cfg['family']} family")


def run(ctx) -> None:
    import torch

    _require_yolov10(ctx.cfg)

    from deal_yolo_daya_tpu_torch.ops.kernels import area_attention as aa
    from deal_yolo_daya_tpu_torch.ops.kernels import phase_stamp as ps
    from deal_yolo_daya_tpu_torch.train.device_augment import DeviceAugConfig
    from deal_yolo_daya_tpu_torch.train.step_graph import StepProgram, auto_steps_per_dispatch
    from deal_yolo_daya_tpu_torch.train.trainer import TrainConfig, TrainState

    def launches():  # the attention, (36, 72) and loss-mark launches so far
        return {"attention_launches": aa.launches, "attention_bwd_launches": aa.bwd_launches,
                "attention_k36_launches": aa.k36_launches,
                "attention_k36_bwd_launches": aa.k36_bwd_launches,
                "loss_mark_launches": ps.mark_launches}

    wl, cfg = ctx.wl, ctx.cfg
    dev = torch.device(ctx.device)
    cuda = dev.type == "cuda"
    batch, imgsz, n_img = wl["batch"], wl["imgsz"], wl["data"]["images"]
    hp = wl["optimizer"]
    per_epoch = n_img // batch
    k = auto_steps_per_dispatch(None, per_epoch)
    n_check = wl["check_steps"]
    n_sched = n_check + k * (2 + int(ctx.seconds * wl["max_steps_per_s"] / k))
    idx, seeds = traffic.train_schedule(ctx.seed, n_img, batch, n_sched)

    stamp = B._Stamps(ctx)
    sd = ref.make_weights(cfg, ctx.seed, dev, wl["weights"]["gain"])
    cache = traffic.device_cache(ctx.seed, wl["data"], imgsz, wl["max_boxes"], dev)
    stamp("weights and device cache")
    ctx.counters.update(steps_per_dispatch=k, batch=batch)
    if ctx.control:
        _control(ctx, sd, cache, idx[:n_check], seeds[:n_check])
        return

    tc = TrainConfig(model=cfg["model"], imgsz=imgsz, batch=batch, amp=cfg["dtype"] == "bfloat16",
                     epochs=hp["epochs"], lr0=hp["lr0"], lrf=hp["lrf"], momentum=hp["momentum"],
                     weight_decay=hp["weight_decay"], warmup_epochs=hp["warmup_epochs"],
                     optimizer=hp["name"], max_boxes=wl["max_boxes"],
                     box=wl["loss_gains"][0], cls=wl["loss_gains"][1], dfl=wl["loss_gains"][2])
    state = TrainState(tc, cfg["nc"], per_epoch, device=dev,
                       state_dict={to_program(k_): v for k_, v in sd.items()})
    if getattr(state.model, "FAMILY", None) != cfg["family"]:
        raise RuntimeError(f"the program built a {getattr(state.model, 'FAMILY', '?')} for "
                           f"{cfg['model']!r}")
    prog = StepProgram(state, cache, DeviceAugConfig(**wl["augment"]), imgsz, wl["max_boxes"],
                       batch)
    stamp("state and step program")
    rule = rtrain.SGD([], hp, per_epoch)
    names = {id(p): n for n, p in state.model.named_parameters()}
    bufs = {names[id(p)]: buf for g in state.optimizer.inner.groups
            for p, buf in zip(g.params, g.state["momentum_buffer"])}
    params = dict(state.model.named_parameters())
    prog_sd = {to_program(k_): v for k_, v in sd.items()}
    before = B._snapshot(prog_sd, {n: torch.zeros_like(b) for n, b in bufs.items()}, prog_sd)
    got = {"loss": [], "fg": [], "fg_o2o": []}
    start = None
    acc = state.loss_acc
    for i in range(n_check):
        last = i == n_check - 1
        if last:
            start = before = B._snapshot(state.model.state_dict(), bufs, state.ema_state_dict())
            graphs = len(prog.graphs)
        fg0, fg1 = float(acc["num_fg"]), float(acc["num_fg_o2o"])
        got["loss"].append(float(prog.run(idx[i:i + 1], seeds[i:i + 1])))
        got["fg"].append(float(acc["num_fg"]) - fg0)
        got["fg_o2o"].append(float(acc["num_fg_o2o"]) - fg1)
        if last and cuda and not (graphs == 0 and len(prog.graphs) == 1):
            raise RuntimeError("the last checked step is not the step graph's first replay: "
                               "check_steps must be the program's eager warm-up steps + 1")
        if i == 0 or last:
            with torch.no_grad():
                mom = rule.momentum(i)
                grad = B._norms({n: b - mom * before["buf"][n]
                                 - rule.decay(n, b.dim()) * before["model"][n]
                                 for n, b in bufs.items()})
                got["last" if last else "start"] = _ref_readings(B._readings(
                    state.model.state_dict(), params, state.ema_state_dict(), grad, before))
    start = _ref_snapshot(B._to_host(start))
    del before
    stamp(f"{n_check} checked steps")
    pos = n_check
    prog.run(idx[pos:pos + k], seeds[pos:pos + k])
    pos += k
    if cuda:
        torch.cuda.synchronize(dev)
    stamp("a warm dispatch")
    gc.collect()
    gc.freeze()
    ctx.e2e["setup_s"] = time.perf_counter() - ctx.t_start

    window = min(ctx.seconds, wl["trace_seconds"]) if ctx.trace else ctx.seconds
    prof = T.start() if ctx.trace else None
    steps = 0
    pending = collections.deque()
    launches0 = launches()
    with T.record("window"):
        t0 = time.perf_counter()
        while True:
            if pos + k > len(seeds):
                raise RuntimeError("the schedule ran out: raise max_steps_per_s")
            with T.record("run"):
                prog.run(idx[pos:pos + k], seeds[pos:pos + k])
            pos += k
            steps += k
            if cuda:
                ev = torch.cuda.Event()
                ev.record()
                pending.append(ev)
                if len(pending) > 2:
                    with T.record("wait"):
                        pending.popleft().synchronize()
            if time.perf_counter() - t0 >= window:
                break
        if cuda:
            torch.cuda.synchronize(dev)
        t1 = time.perf_counter()
    if prof is not None:
        prof.stop()
        ctx.tr = T.Trace(prof)
        ctx.breakdown = {"device_ops": ctx.tr.top_ops(), "idle_gaps": ctx.tr.idle_gaps()}
    ctx.e2e["train_img_s"] = steps * batch / (t1 - t0)
    ctx.counters.update(window_steps=steps, window_images=steps * batch, window_s=t1 - t0,
                        **{name: n - launches0[name] for name, n in launches().items()})
    print(f"train_v10: window of {steps} steps, launches "
          f"{ {name: ctx.counters[name] for name in launches0} }", file=sys.stderr)
    ctx.attempted = steps
    ctx.failed = 0
    if cuda:
        ctx.memory_peak_bytes = torch.cuda.max_memory_allocated(dev)
    del prog, state, pending, acc, params, bufs
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    r, _ = reference_steps(ctx, sd, cache, idx[:n_check], seeds[:n_check], "f32", start)
    _judge(ctx, got, r)


def _judge(ctx, prog, ref_) -> None:
    """``drivers/train.py::_judge``'s numbers, with the one-to-one head's
    foreground counts (``fg.o2o``) and the batch variances upstream of the
    PSA block."""
    print(f"train_v10: losses {prog['loss']} reference {ref_['loss']}; loss gap "
          f"{compare.loss_gap(prog['loss'], ref_['loss'])!r}; foreground anchors {prog['fg']} "
          f"reference {ref_['fg']}; one-to-one {prog['fg_o2o']} reference {ref_['fg_o2o']}",
          file=sys.stderr)
    ctx.check("fg", compare.fg_gap(prog["fg"], ref_["fg"]))
    ctx.check("fg.o2o", compare.fg_gap(prog["fg_o2o"], ref_["fg_o2o"]))
    att = ref.first_attention()
    for step, tag in (("start", ".start"), ("last", "")):
        p, r = prog[step], ref_[step]
        leaves = compare.kept_leaves(r["grad"])
        bn = compare.var_gaps(p["var"], r["var"])
        upstream = [g for g, k_ in bn if int(k_.split(".")[0]) < att]
        print(f"train_v10: {step} step: batch variance gaps, worst layers {bn[:3]}; median of "
              f"all {statistics.median(g for g, _ in bn):.6g}; {len(leaves)} leaves kept of "
              f"{len(r['grad'])}", file=sys.stderr)
        for what in ("grad", "change"):
            names = leaves + [f"ema.{k_}" for k_ in leaves] if what == "change" else leaves
            worst = compare.leaf_gaps(p[what], r[what], names)[:4]
            print(f"train_v10: {step} step: worst {what} leaves " + "; ".join(
                f"{k_} {g:.4g} (program {p[what][k_]:.6g}, reference {r[what][k_]:.6g})"
                for g, k_ in worst), file=sys.stderr)
        ctx.check("bn" + tag, statistics.median(upstream))
        if step == "start":
            moved = [k_ for k_ in leaves if k_.endswith("bias")]
            ctx.check("grad.start", compare.median_gap(p["grad"], r["grad"], leaves))
            ctx.check("change.start", compare.median_gap(p["change"], r["change"],
                                                         moved + [f"ema.{k_}" for k_ in moved]))
        else:
            # the optimizer's groups, each split into the one-to-one head's
            # leaves and the rest: a fault confined to either moves its median
            groups = collections.defaultdict(list)
            for k_ in leaves:
                head = "o2o" if k_.startswith(O2O) else "rest"
                groups[f"{rtrain.SGD.group(k_, ref_['dims'][k_])}.{head}"].append(k_)
            ctx.check("grad", compare.group_gap(p["grad"], r["grad"], groups))
            ctx.check("change", compare.group_gap(
                p["change"], r["change"],
                {**groups, **{f"ema.{g}": [f"ema.{k_}" for k_ in v] for g, v in groups.items()}}))
    ctx.counters.update(losses=prog["loss"], ref_losses=ref_["loss"])


def _control(ctx, sd, cache, idx, seeds) -> None:
    """The reference in fp8 in the program's place."""
    low, start = reference_steps(ctx, sd, cache, idx, seeds, "fp8")
    _judge(ctx, low, reference_steps(ctx, sd, cache, idx, seeds, "f32", B._to_host(start))[0])

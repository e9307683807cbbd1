"""Driver ``train``: the Trainer's device-cache path, ``StepProgram.run``
over one ``TrainState``, K steps a dispatch as the Trainer resolves K.

Set-up makes the weights and the device cache from the seed, builds the
state and the step program once, and drives them through their first
``check_steps`` steps one call each: the program's eager warm-up steps,
then the step graph's capture and first replay, the step the window
repeats. It reads each step's loss and foreground count, and for the
first step and the replayed last one each BatchNorm's batch variance,
each leaf's gradient as the optimizer took it (from its momentum buffer)
and each leaf's and its EMA's change; before the last step it copies the
program's state. Then one more whole dispatch, so that nothing is built in
the window. The window runs whole dispatches for ``--seconds`` and ends in
a synchronise: ``train_img_s`` is every image stepped over the window.
After it the program is freed and the reference follows the checked steps
on the same rows and seeds: from the set-up weights, and the last step
from the program's copied state, which alone keeps the replay's step
comparable (the steps before it drift apart chaotically).
"""

from __future__ import annotations

import collections
import gc
import statistics
import sys
import time

from benchmark.lib import compare, trace as T, traffic
from benchmark.reference import model as ref, train as rtrain


def _norms(tensors):
    return {k: float(v.float().norm()) for k, v in tensors.items()}


def _snapshot(model_sd, buf, ema):
    """A side's state before a step: the model's parameters and BatchNorm
    buffers, the momentum buffers and the EMA, copied."""
    copy = lambda d: {k: v.detach().clone() for k, v in d.items()}  # noqa: E731
    return {"model": copy(model_sd), "buf": copy(buf), "ema": copy(ema)}


def _to_host(snapshot):
    return {part: {k: v.cpu() for k, v in d.items()} for part, d in snapshot.items()}


def _readings(new_sd, params, ema, grad, before):
    """One step's readings, each from the state before it (``before``, a
    ``_snapshot``): each BatchNorm's batch variance, each leaf's gradient
    norm (``grad``) and each leaf's change and its EMA's ("ema.") as norms."""
    return {"var": _batch_var(new_sd, before["model"]), "grad": grad,
            "change": _changes(params, ema, before)}


def _changes(params, ema, before):
    """Each leaf's change over the step, and its EMA's ("ema."), as norms."""
    out = _norms({k: p - before["model"][k] for k, p in params.items()})
    out.update(_norms({f"ema.{k}": e - before["ema"][k] for k, e in ema.items()}))
    return out


def _batch_var(new_sd, old_sd):
    """Each BatchNorm's biased batch variance in a step, recovered from its
    running variance before and after it (moved 3% of the way)."""
    m = ref.BN_MOMENTUM
    return {k: ((v.float() - m * old_sd[k].float()) / (1 - m)).cpu()
            for k, v in new_sd.items() if k.endswith("running_var")}


def reference_steps(ctx, sd, cache, idx, seeds, precision: str, start=None):
    """The reference's checked steps from the set-up weights ``sd``, each
    on its step's rows and seed -> (readings, the state before the last
    step). Readings: each step's loss and foreground count, and the first
    (``start``) and the last (``last``) step's ``_readings``. The last step
    starts from ``start`` where it is given (the judged side's state before
    its last step: the reference follows the program one step from there),
    else from the reference's own state."""
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
    out = {"loss": [], "fg": [], "dims": {k: p.dim() for k, p in named}}
    before = _snapshot(sd, {k: torch.zeros_like(p) for k, p in named}, params)
    exact = ref.f32_exact()
    exact.__enter__()
    try:
        for i in range(len(seeds)):
            last = i == len(seeds) - 1
            if last:
                own = before = _snapshot(model.state_dict(), sgd.buf, sgd.ema)
                if start is not None:
                    before = {part: {k: v.to(dev) for k, v in d.items()}
                              for part, d in start.items()}
                    with torch.no_grad():
                        model.load_state_dict(before["model"])
                    sgd.buf = {k: v.clone() for k, v in before["buf"].items()}
                    sgd.ema = {k: v.clone() for k, v in before["ema"].items()}
            d = rtrain.draws(wl["batch"], seeds[i], augp, dev)
            rows = torch.as_tensor(idx[i], device=dev)
            imgs, boxes, cls, mask = rtrain.augment(*(t[rows] for t in cache), d, wl["imgsz"], augp,
                                                    wl["max_boxes"])
            for _, p in named:
                p.grad = None
            box, logits = model(imgs.permute(0, 3, 1, 2).float() / 255.0)
            loss, n_fg = rtrain.detection_loss(box, logits, cls, boxes, mask, wl["imgsz"],
                                               cfg["nc"], tuple(wl["loss_gains"]))
            loss.backward()
            out["fg"].append(n_fg)
            out["loss"].append(float(loss.detach()))
            grad = _norms({k: p.grad for k, p in named})
            sgd.step()
            if i == 0 or last:
                with torch.no_grad():
                    out["last" if last else "start"] = _readings(
                        model.state_dict(), params, sgd.ema, grad, before)
    finally:
        exact.__exit__(None, None, None)
        ref.set_precision("f32")
    return out, own


def run(ctx) -> None:
    import torch

    from deal_yolo_daya_tpu_torch.train.device_augment import DeviceAugConfig
    from deal_yolo_daya_tpu_torch.train.step_graph import StepProgram, auto_steps_per_dispatch
    from deal_yolo_daya_tpu_torch.train.trainer import TrainConfig, TrainState

    wl, cfg = ctx.wl, ctx.cfg
    dev = torch.device(ctx.device)
    cuda = dev.type == "cuda"
    batch, imgsz, n_img = wl["batch"], wl["imgsz"], wl["data"]["images"]
    hp = wl["optimizer"]
    per_epoch = n_img // batch
    k = auto_steps_per_dispatch(None, per_epoch)
    n_check = wl["check_steps"]
    # rows for the checked steps, one warm dispatch and a window of up to
    # max_steps_per_s steps a second
    n_sched = n_check + k * (2 + int(ctx.seconds * wl["max_steps_per_s"] / k))
    idx, seeds = traffic.train_schedule(ctx.seed, n_img, batch, n_sched)

    stamp = _Stamps(ctx)
    sd = ref.make_weights(cfg, ctx.seed, dev, wl["imgsz"], wl["weights"])
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
    state = TrainState(tc, cfg["nc"], per_epoch, device=dev, state_dict=sd)
    prog = StepProgram(state, cache, DeviceAugConfig(**wl["augment"]), imgsz, wl["max_boxes"],
                       batch)
    stamp("state and step program")
    rule = rtrain.SGD([], hp, per_epoch)
    names = {id(p): n for n, p in state.model.named_parameters()}
    bufs = {names[id(p)]: buf for g in state.optimizer.inner.groups
            for p, buf in zip(g.params, g.state["momentum_buffer"])}
    params = dict(state.model.named_parameters())
    before = _snapshot(sd, {n: torch.zeros_like(b) for n, b in bufs.items()}, sd)
    got = {"loss": [], "fg": []}
    start = None
    for i in range(n_check):
        last = i == n_check - 1
        if last:  # the state the reference follows the program's last step from
            start = before = _snapshot(state.model.state_dict(), bufs, state.ema_state_dict())
            graphs = len(prog.graphs)
        fg0 = float(state.loss_acc["num_fg"])
        got["loss"].append(float(prog.run(idx[i:i + 1], seeds[i:i + 1])))
        got["fg"].append(float(state.loss_acc["num_fg"]) - fg0)
        if last and cuda and not (graphs == 0 and len(prog.graphs) == 1):
            raise RuntimeError("the last checked step is not the step graph's first replay: "
                               "check_steps must be the program's eager warm-up steps + 1")
        if i == 0 or last:
            with torch.no_grad():
                mom = rule.momentum(i)
                # the optimizer's gradient from its momentum buffer, less
                # the decay that the configuration states
                grad = _norms({n: b - mom * before["buf"][n]
                               - rule.decay(n, b.dim()) * before["model"][n]
                               for n, b in bufs.items()})
                got["last" if last else "start"] = _readings(
                    state.model.state_dict(), params, state.ema_state_dict(), grad, before)
    start = _to_host(start)
    del before
    stamp(f"{n_check} checked steps")
    pos = n_check
    prog.run(idx[pos:pos + k], seeds[pos:pos + k])
    pos += k
    if cuda:
        torch.cuda.synchronize(dev)
    stamp("a warm dispatch")
    gc.collect()
    gc.freeze()  # set-up's objects stay out of the window's collections
    ctx.e2e["setup_s"] = time.perf_counter() - ctx.t_start

    window = min(ctx.seconds, wl["trace_seconds"]) if ctx.trace else ctx.seconds
    prof = T.start() if ctx.trace else None
    steps = 0
    pending = collections.deque()
    with T.record("window"):
        t0 = time.perf_counter()
        while True:
            if pos + k > len(seeds):
                raise RuntimeError("the schedule ran out: raise max_steps_per_s")
            with T.record("run"):
                prog.run(idx[pos:pos + k], seeds[pos:pos + k])
            pos += k
            steps += k
            if cuda:  # at most two dispatches queued ahead of the card
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
    ctx.counters.update(window_steps=steps, window_images=steps * batch, window_s=t1 - t0)
    ctx.attempted = steps
    ctx.failed = 0
    if cuda:
        ctx.memory_peak_bytes = torch.cuda.max_memory_allocated(dev)
    del prog, state, pending
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    r, _ = reference_steps(ctx, sd, cache, idx[:n_check], seeds[:n_check], "f32", start)
    _judge(ctx, got, r)


class _Stamps:
    """Set-up's phases on standard error, each with its seconds."""

    def __init__(self, ctx):
        self.t = time.perf_counter()
        print(f"setup: process start to driver {self.t - ctx.t_start:.3f} s", file=sys.stderr)

    def __call__(self, what: str) -> None:
        t = time.perf_counter()
        print(f"setup: {what} {t - self.t:.3f} s", file=sys.stderr)
        self.t = t


def _judge(ctx, prog, ref_) -> None:
    """The compared numbers: every step's foreground count; the first
    step's (``.start``, from the set-up weights) and the last step's (the
    step graph's first replay, the reference from the program's state
    before it) batch variances upstream of the first attention block,
    gradients and changes."""
    print(f"train: losses {prog['loss']} reference {ref_['loss']}; loss gap "
          f"{compare.loss_gap(prog['loss'], ref_['loss'])!r}; foreground anchors {prog['fg']} "
          f"reference {ref_['fg']}", file=sys.stderr)
    ctx.check("fg", compare.fg_gap(prog["fg"], ref_["fg"]))
    att = ref.first_attention(ctx.cfg)
    for step, tag in (("start", ".start"), ("last", "")):
        p, r = prog[step], ref_[step]
        leaves = compare.kept_leaves(r["grad"])
        bn = compare.var_gaps(p["var"], r["var"])
        upstream = [g for g, k in bn if int(k.split(".")[0]) < att]
        print(f"train: {step} step: batch variance gaps, worst layers {bn[:3]}; median of all "
              f"{statistics.median(g for g, _ in bn):.6g}; {len(leaves)} leaves kept of "
              f"{len(r['grad'])}", file=sys.stderr)
        for what in ("grad", "change"):
            names = leaves + [f"ema.{k}" for k in leaves] if what == "change" else leaves
            worst = compare.leaf_gaps(p[what], r[what], names)[:4]
            print(f"train: {step} step: worst {what} leaves " + "; ".join(
                f"{k} {g:.4g} (program {p[what][k]:.6g}, reference {r[what][k]:.6g})"
                for g, k in worst), file=sys.stderr)
        ctx.check("bn" + tag, statistics.median(upstream))
        if step == "start":
            # step 1 moves the bias group alone: warmup starts it at lr 0.1
            # and the others at 0
            moved = [k for k in leaves if k.endswith("bias")]
            ctx.check("grad.start", compare.median_gap(p["grad"], r["grad"], leaves))
            ctx.check("change.start", compare.median_gap(p["change"], r["change"],
                                                         moved + [f"ema.{k}" for k in moved]))
        else:
            groups = collections.defaultdict(list)
            for k in leaves:
                groups[rtrain.SGD.group(k, ref_["dims"][k])].append(k)
            ctx.check("grad", compare.group_gap(p["grad"], r["grad"], groups))
            ctx.check("change", compare.group_gap(
                p["change"], r["change"],
                {**groups, **{f"ema.{g}": [f"ema.{k}" for k in v] for g, v in groups.items()}}))
    ctx.counters.update(losses=prog["loss"], ref_losses=ref_["loss"])


def _control(ctx, sd, cache, idx, seeds) -> None:
    """The reference in fp8 in the program's place."""
    low, start = reference_steps(ctx, sd, cache, idx, seeds, "fp8")
    _judge(ctx, low, reference_steps(ctx, sd, cache, idx, seeds, "f32", _to_host(start))[0])

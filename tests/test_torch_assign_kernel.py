"""The task-aligned assigner's kernels (``csrc/tal_assign.cu``) on the CPU:
their decomposition, their route and their wrapper's checks. The kernels run
only on the card (chip_smoke phase 44 holds them to
``task_aligned_assign_plain`` there, on this module's cases at the train
cells' shapes among others); here a plain restatement of what they compute
-- each GT's candidate rectangles, its top-k with the zero-metric rule, the
packed-key resolution of anchors several GTs claim, the per-GT
normalisation -- is held to ``task_aligned_assign`` on all four outputs."""

import numpy as np
import pytest
import torch

from deal_yolo_daya_tpu_torch.ops.boxes import anchor_grid, bbox_ciou, make_anchors
from deal_yolo_daya_tpu_torch.ops.kernels import tal_assign as tal_kernel
from deal_yolo_daya_tpu_torch.train import loss as port_loss
from tests.torch_deadline import _deadline, _deadline_module  # noqa: F401

F32 = np.float32
CASES = ("random", "corner", "zero_metric", "duplicates", "nested", "padded", "huge",
         "zero_width", "non_square")


def _few_positives(scores, pd_bboxes, anchor_xy, i, box, label, count, g):
    """``count`` random candidates of ``box`` in image i, past the first
    rows, get score 0.9 for ``label`` and the box itself as their
    prediction."""
    inside = port_loss.select_candidates_in_gts(anchor_xy, box[None, None])[0, 0]
    inside[:anchor_xy.shape[0] // 16] = False
    cand = inside.nonzero()[:, 0]
    pick = cand[torch.randperm(len(cand), generator=g)[:count]]
    scores[i, pick, label] = 0.9
    pd_bboxes[i, pick] = box


def case_inputs(case: str, b: int = 2, n: int = 37, imgsz: int = 128, nc: int = 8,
                seed: int = 0):
    """One case's assigner inputs, made on the CPU from the seed:
    (pd_scores (B, A, nc) f32 probabilities, pd_bboxes (B, A, 4), anchor_xy
    (A, 2), gt_labels (B, N) int32, gt_bboxes (B, N, 4), mask_gt (B, N),
    grid). Predictions are boxes of 1-6 strides a side about each anchor;
    1 to n GT boxes an image of 3-80% of its sides, labels below nc - 1,
    then the case's own boxes (at least 4 slots)."""
    g = torch.Generator().manual_seed(seed)

    def u(*shape):
        return torch.rand(shape, generator=g)

    h, w = (imgsz, imgsz * 3 // 2) if case == "non_square" else (imgsz, imgsz)
    grid = anchor_grid((h, w))
    points, strides = make_anchors((h, w))
    anchor_xy = points * strides
    a = anchor_xy.shape[0]
    centre = anchor_xy[None] + (u(b, a, 2) - 0.5) * strides[None]
    half = strides[None] * (0.5 + 2.5 * u(b, a, 2))
    pd_bboxes = torch.cat([centre - half, centre + half], -1)
    pd_scores = u(b, a, nc) ** 2
    size = torch.tensor([w, h], dtype=torch.float32)
    count = torch.randint(1, n + 1, (b,), generator=g)
    mask = torch.arange(n)[None] < count[:, None]
    side = (0.03 + 0.77 * u(b, n, 2)) * size
    xy = u(b, n, 2) * (size - side)
    boxes = torch.cat([xy, xy + side], -1)
    labels = torch.randint(0, nc - 1, (b, n), generator=g, dtype=torch.int32)
    special = nc - 1  # the class whose scores the corner and zero-metric cases set
    for i in range(b):
        if case in ("corner", "zero_metric"):
            # P < k positive candidates: the last argmax picks go to the
            # lowest anchors of metric 0, at the corner candidates of the GT
            for j in range(min(n, 3)):
                s = (0.12 + 0.4 * u(2)) * size
                lo = torch.zeros(2) if case == "corner" else (0.3 + 0.2 * u(2)) * size
                boxes[i, j] = torch.cat([lo, torch.minimum(lo + s, size)])
                labels[i, j] = special
                mask[i, j] = True
            pd_scores[i, :, special] = 0.0
            for j in range(min(n, 3)):
                _few_positives(pd_scores, pd_bboxes, anchor_xy, i, boxes[i, j], special, j, g)
            if case == "corner":
                # a positive at anchor 1 of a wide GT: the zero picks skip it
                boxes[i, 1] = torch.tensor([0.0, 0.0, 0.75 * w, 0.3 * h])
                pd_scores[i, 1, special] = 0.9
                pd_bboxes[i, 1] = boxes[i, 1]
        elif case == "duplicates":
            mask[i, :min(n, 8)] = True
            boxes[i, 1::2] = boxes[i, 0::2][:n // 2]
            labels[i, 1::4] = labels[i, 0::4][:len(labels[i, 1::4])]
        elif case == "nested":
            mask[i, :min(n, 8)] = True
            big = torch.cat([0.1 * size, 0.9 * size])
            boxes[i, 0] = big
            for j in range(1, min(n, 5)):
                lo = big[:2] + u(2) * 0.5 * (big[2:] - big[:2])
                boxes[i, j] = torch.cat([lo, lo + (0.1 + 0.3 * u(2)) * (big[2:] - big[:2])])
            for j in range(5, min(n, 8)):
                lo = big[:2] + 0.6 * (big[2:] - big[:2]) * u(2)
                boxes[i, j] = torch.cat([lo, lo + 0.5 * size])
        elif case == "padded":
            mask[i] = u(n) < 0.6
            mask[i, 0] = True
            boxes[i, ~mask[i]] = (u(int((~mask[i]).sum()), 4) - 0.5) * 4 * size.repeat(2)
            labels[i, ~mask[i]] = torch.randint(-5, nc + 5, (int((~mask[i]).sum()),),
                                                generator=g, dtype=torch.int32)
            labels[i, 0], labels[i, min(1, n - 1)] = -2, nc + 3
        elif case == "huge":
            mask[i, :min(n, 4)] = True
            boxes[i, 0] = torch.tensor([-0.3 * w, -0.2 * h, 1.4 * w, 1.3 * h])
            boxes[i, 1] = torch.tensor([-w, -h, 2.0 * w, 2.0 * h])
        elif case == "zero_width":
            mask[i, :min(n, 4)] = True
            boxes[i, 0, 2] = boxes[i, 0, 0]
            boxes[i, 1, 3] = boxes[i, 1, 1]
            boxes[i, 2, 2] = boxes[i, 2, 0] + 1e-3
            boxes[i, 3] = torch.tensor([3.9, 10.0, 4.1, 60.0])  # one column of anchors
    boxes = boxes * mask[..., None] if case != "padded" else boxes
    return pd_scores, pd_bboxes, anchor_xy, labels, boxes, mask, grid


def _axis_range(x1, x2, stride: int, cells: int):
    """The kernel's range of anchor cells along one axis (``axis_range``):
    each end clamped to [-1, cells] in f32 (NaN to -1), floored, widened by
    one, clipped to the grid."""
    def floor_at(x):
        q = F32(F32(x) / F32(stride)) - F32(0.5)
        q = F32(-1.0) if np.isnan(q) else min(max(q, F32(-1.0)), F32(cells))
        return int(np.floor(q))
    return max(floor_at(x1) - 1, 0), min(floor_at(x2) + 1, cells - 1)


def rect_candidates(anchor_xy: np.ndarray, box: np.ndarray, grid):
    """The GT's candidate anchors as the kernel finds them: each level's
    rectangle of cells, then the strict-inside test in f32."""
    x1, y1, x2, y2 = box
    eps = F32(1e-9)
    out, offset = [], 0
    for stride, rows, cols in grid:
        c0, c1 = _axis_range(x1, x2, stride, cols)
        r0, r1 = _axis_range(y1, y2, stride, rows)
        for r in range(r0, r1 + 1):
            for c in range(c0, c1 + 1):
                k = offset + r * cols + c
                ax, ay = anchor_xy[k]
                if ax - x1 > eps and ay - y1 > eps and x2 - ax > eps and y2 - ay > eps:
                    out.append(k)
        offset += rows * cols
    return out


def restated(pd_scores, pd_bboxes, anchor_xy, gt_labels, gt_bboxes, mask_gt, nc, topk, grid,
             alpha=0.5, beta=6.0, eps=1e-9):
    """What the kernels compute, written plainly. The metric and overlap of
    a (GT, anchor) pair are the plain version's elementwise values, read
    only at the GT's candidates (``rect_candidates``); per GT: the top-k
    positives by (metric, then the lower anchor), and where P < k of them,
    the zero-metric candidates a with a - #(positives below a) < k - P; the
    GT kept iff its best metric passes eps; each survivor's key the max of
    (overlap bits << 16 | 0xFFFF - n); per anchor its winner's normalised
    score."""
    bf16 = torch.bfloat16
    b, n, _ = gt_bboxes.shape
    a = pd_bboxes.shape[1]
    labels = gt_labels.long().clamp(0, nc - 1)
    overlaps = bbox_ciou(gt_bboxes.to(bf16)[:, :, None], pd_bboxes.to(bf16)[:, None]).clamp(min=0)
    score = torch.gather(pd_scores.to(bf16), 2, labels[:, None, :].expand(b, a, n)).transpose(1, 2)
    metric = score ** alpha * overlaps ** beta
    m_bits = metric.view(torch.int16).numpy().astype(np.int64) & 0xFFFF
    o_bits = overlaps.view(torch.int16).numpy().astype(np.int64) & 0xFFFF
    anchors, boxes = anchor_xy.numpy(), gt_bboxes.numpy()
    keys = np.zeros((b, a), np.int64)
    kept = {}
    for i in range(b):
        for j in range(n):
            if not mask_gt[i, j]:
                continue
            cands = rect_candidates(anchors, boxes[i, j], grid)
            positives = sorted((k for k in cands if m_bits[i, j, k] > 0),
                               key=lambda k: (-m_bits[i, j, k], k))
            picked = positives[:topk]
            if not picked or not float(metric[i, j, picked[0]]) > eps:
                continue
            zeros = topk - len(picked)
            kept[i, j] = picked + [k for k in cands if k < topk and m_bits[i, j, k] == 0
                                   and k - sum(p < k for p in picked) < zeros]
            for k in kept[i, j]:
                ob = 0 if o_bits[i, j, k] == 0x8000 else o_bits[i, j, k]
                keys[i, k] = max(keys[i, k], (ob << 16) | (0xFFFF - j))
    target_bboxes = gt_bboxes[:, :1].expand(b, a, 4).clone()
    target_scores = torch.zeros((b, a, nc))
    fg = torch.zeros((b, a), dtype=torch.bool)
    target_gt = torch.zeros((b, a), dtype=torch.int64)
    for i, k in zip(*np.nonzero(keys)):
        tag = keys[i, k] & 0xFFFF
        j = 0xFFFF - tag
        won = [e for e in kept[i, j] if keys[i, e] & 0xFFFF == tag]
        pos_align = metric[i, j, won].amax()
        pos_overlap = overlaps[i, j, won].amax()
        target_scores[i, k, labels[i, j]] = (metric[i, j, k] * pos_overlap
                                             / (pos_align + eps)).float()
        fg[i, k], target_gt[i, k] = True, j
        target_bboxes[i, k] = gt_bboxes[i, j]
    return target_bboxes, target_scores, fg, target_gt


def _same(got, want):
    return all(g.shape == w.shape and g.dtype == w.dtype and torch.equal(
        g.contiguous().view(torch.uint8), w.contiguous().view(torch.uint8))
        for g, w in zip(got, want))


@pytest.mark.parametrize("topk", [10, 1])
@pytest.mark.parametrize("case,n", [(c, 37) for c in CASES] + [("random", 4), ("random", 128)],
                         ids=lambda v: str(v))
def test_restated_decomposition_equals_assigner(case, n, topk):
    """The kernels' decomposition gives ``task_aligned_assign``'s four
    outputs bit for bit, and the cases reach what they are for."""
    args = case_inputs(case, n=n, seed=topk)
    *inputs, grid = args
    got = restated(*inputs, 8, topk, grid)
    want = port_loss.task_aligned_assign(*inputs, nc=8, topk=topk)
    assert _same(got, want)
    fg = want[2]
    assert fg.any()
    if case == "corner" and topk == 10:
        # zero-metric candidates among the first row's anchors are assigned
        assert bool((fg[:, :topk] & (want[1][:, :topk].amax(-1) == 0)).any())


@pytest.mark.parametrize("case", CASES)
def test_rectangles_hold_every_candidate(case):
    """Each GT's rectangles hold exactly the anchors of
    ``select_candidates_in_gts``, padded slots included."""
    _, _, anchor_xy, _, gt_bboxes, _, grid = case_inputs(case, n=37, seed=3)
    dense = port_loss.select_candidates_in_gts(anchor_xy, gt_bboxes)
    for i in range(gt_bboxes.shape[0]):
        for j in range(gt_bboxes.shape[1]):
            want = dense[i, j].nonzero()[:, 0].tolist()
            assert rect_candidates(anchor_xy.numpy(), gt_bboxes[i, j].numpy(), grid) == want


def test_route_cpu_plain_cuda_kernel(monkeypatch):
    """CPU tensors take the plain version and never the kernels; a CUDA
    device routes to the kernels."""
    assert port_loss.assign_route("cpu") == "plain"
    assert port_loss.assign_route(torch.device("cuda", 0)) == "kernel"
    assert port_loss.assign_route("cuda") == "kernel"

    def refuse(*_):
        raise AssertionError("the kernel launched for CPU tensors")

    monkeypatch.setattr(tal_kernel, "launch", refuse)
    *inputs, grid = case_inputs("random")
    got = port_loss.task_aligned_assign(*inputs, nc=8, topk=10, grid=grid)
    assert _same(got, port_loss.task_aligned_assign_plain(*inputs, nc=8, topk=10))


def _kernel_args(b=2, n=5, a=21, nc=8):
    """Arguments ``launch`` takes, of the shapes it reads (on the CPU)."""
    return dict(scores=torch.zeros((b, a, nc), dtype=torch.bfloat16),
                pd_bboxes=torch.zeros((b, a, 4)), anchor_xy=torch.zeros((a, 2)),
                labels=torch.zeros((b, n), dtype=torch.int64), gt_bboxes=torch.zeros((b, n, 4)),
                mask_gt=torch.zeros((b, n), dtype=torch.bool), topk=10,
                grid=[(8, 4, 4), (16, 2, 2), (32, 1, 1)])


def _bad(what):
    kw = _kernel_args()
    if what == "scores_dtype":
        kw["scores"] = kw["scores"].float()
    elif what == "pd_dtype":
        kw["pd_bboxes"] = kw["pd_bboxes"].half()
    elif what == "labels_dtype":
        kw["labels"] = kw["labels"].int()
    elif what == "mask_dtype":
        kw["mask_gt"] = kw["mask_gt"].float()
    elif what == "shape":
        kw["gt_bboxes"] = torch.zeros((2, 6, 4))
    elif what == "noncontiguous":
        kw["pd_bboxes"] = torch.zeros((2, 4, 21)).transpose(1, 2)
    elif what == "device":
        kw["anchor_xy"] = kw["anchor_xy"].to("meta")
    elif what == "topk_17":
        kw["topk"] = 17
    elif what == "topk_0":
        kw["topk"] = 0
    elif what == "n_65536":
        n = tal_kernel.MAX_GT + 1
        kw.update(labels=torch.zeros((2, n), dtype=torch.int64), gt_bboxes=torch.zeros((2, n, 4)),
                  mask_gt=torch.zeros((2, n), dtype=torch.bool))
    elif what == "grid":
        kw["grid"] = [(8, 4, 4), (16, 2, 2)]
    return kw


@pytest.mark.parametrize("what", ["scores_dtype", "pd_dtype", "labels_dtype", "mask_dtype",
                                  "shape", "noncontiguous", "device", "topk_17", "topk_0",
                                  "n_65536", "grid"])
def test_wrapper_refuses(what):
    """``check_args`` raises on a dtype, shape, contiguity, device, top-k, GT
    count or anchor grid the kernels do not take."""
    with pytest.raises(ValueError):
        tal_kernel.check_args(**_bad(what))


def test_wrapper_refuses_cpu_and_exponents():
    """``launch`` takes only CUDA tensors; ``pow_mode`` follows PyTorch's
    special cases and refuses exponents <= 0."""
    kw = _kernel_args()
    tal_kernel.check_args(**kw)
    with pytest.raises(ValueError, match="no kernel for device cpu"):
        tal_kernel.launch(*(kw[k] for k in ("scores", "pd_bboxes", "anchor_xy", "labels",
                                            "gt_bboxes", "mask_gt")), 8, 10, 0.5, 6.0, 1e-9,
                          kw["grid"])
    assert tal_kernel.pow_mode(0.5) == (0, 0.5)
    assert tal_kernel.pow_mode(1.0) == (1, 1.0)
    assert tal_kernel.pow_mode(2.0) == (2, 2.0)
    assert tal_kernel.pow_mode(6.0) == (4, 6.0)
    assert tal_kernel.pow_mode(0.3) == (4, float(torch.tensor(0.3, dtype=torch.bfloat16)))
    for e in (0.0, -0.5, float("nan")):
        with pytest.raises(ValueError):
            tal_kernel.pow_mode(e)


def test_detection_loss_passes_the_anchor_grid(monkeypatch):
    """``detection_loss`` hands the assigner its anchors' grid, which the
    kernels need: the levels of ``make_anchors`` at the loss's imgsz."""
    seen = {}
    plain = port_loss.task_aligned_assign

    def spy(*args, grid=None, **kw):
        seen["grid"] = grid
        return plain(*args, grid=grid, **kw)

    monkeypatch.setattr(port_loss, "task_aligned_assign", spy)
    g = torch.Generator().manual_seed(0)
    imgsz = (64, 96)
    box = [torch.randn((2, 64, h // s, w // s), generator=g)
           for s, h, w in ((8, *imgsz), (16, *imgsz), (32, *imgsz))]
    cls = [torch.randn((2, 8, h // s, w // s), generator=g)
           for s, h, w in ((8, *imgsz), (16, *imgsz), (32, *imgsz))]
    gt = torch.tensor([[[4.0, 4.0, 40.0, 30.0]], [[10.0, 8.0, 90.0, 60.0]]])
    port_loss.detection_loss(box, cls, torch.zeros((2, 1), dtype=torch.int32), gt,
                             torch.ones((2, 1), dtype=torch.bool), imgsz,
                             port_loss.LossConfig(nc=8))
    assert seen["grid"] == anchor_grid(imgsz) == [(8, 8, 12), (16, 4, 6), (32, 2, 3)]

// The task-aligned assigner of the detection loss for Hopper (sm_90a), bound
// to Python through ctypes.
//
// Replaces no TPU kernel: the JAX package's assigner
// (deal_yolo_daya_tpu/train/loss.py::task_aligned_assign) is jnp that XLA
// fuses on the TPU. It was added because the port's PyTorch version of the
// same function (train/loss.py::task_aligned_assign_plain) works densely over
// (B, N, A) = (32, 128, 8400) at b32/640, 34.4 M entries, though an image
// holds some 7 real GT boxes in its 128 slots: the bf16 CIoU, the align
// metric, a (B, N, A, 4) f32 candidate test, k argmax rounds, a (B, A, N)
// one-hot and the normalising maxima: 12.3 ms of the 14.1 ms loss phase of
// a b32/640 train step on an H100, in every model.
//
// What bounds it: bytes, about 97 MB at b32/640 (0.029 ms at 3.35 TB/s):
// the (B, A, 80) f32 target scores (86 MB), the target boxes, indices and
// mask written once, the predicted boxes read once; the GT boxes, one class
// score per candidate anchor and the anchors are small. The work depends on
// the data: each real GT's own candidate anchors, not (N, A) per image.
//
// Two kernels, after a memset of the (B, A) key buffer:
//
//   1. tal_candidates_kernel, one block of GT_THREADS per (b, n), returning
//      at once for a padded slot:
//      - each level's rectangle of anchor indices that can hold the GT's
//        candidates, widened by one cell, and in it the exact strict-inside
//        test of select_candidates_in_gts (each side's distance > 1e-9 in
//        f32, anchors read from the caller's tensor);
//      - at each candidate the bf16 CIoU and the align metric, in the plain
//        version's dtypes and op order (below), and the thread's own top-K_MAX
//        of the keys (metric bits, 0xFFFFFFFF - anchor, overlap bits) of the
//        anchors whose metric is above 0: a larger metric first, ties to the
//        lower anchor, as successive argmaxes pick them;
//      - top-k rounds of a block maximum over the threads' heads;
//      - the dense version gives every non-candidate a metric of 0, so for a
//        GT with P < k positive candidates its last k - P argmax picks go to
//        the lowest-index anchors that are not positive, candidates or not,
//        and a zero-metric candidate a survives iff a - #(positives below a)
//        < k - P, which needs a < k: the block keeps its zero-metric
//        candidates below K_MAX in a bit mask. The GT keeps its picks iff its
//        best metric passes eps (gt_has_candidate);
//      - its survivors (at most k) to a (B, N, K_MAX) scratch with their
//        metric and overlap, and atomicMax of (overlap bits << 16 | 0xFFFF -
//        n) into each survivor's key: the overlaps are clamped at 0, so bit
//        order is value order once -0.0 is folded to +0.0, and the largest
//        key is argmax over the claiming GTs, ties to the lowest n (N <=
//        65535, so a claimed key is never 0).
//   2. tal_outputs_kernel, one thread per anchor of a ROW_THREADS-row tile:
//      the key gives fg and the winning GT n (0 where none, as argmax of an
//      all-zero column gives); the thread walks n's survivors, keeps those
//      whose key names n (each anchor has one winner, so no race), takes the
//      normalisation's maxima pos_align and pos_overlap over them and its own
//      score bf16(bf16(metric * pos_overlap) / bf16(pos_align + eps)); it
//      writes fg, the index, the GT's f32 box. Then the block writes the
//      tile's rows of the f32 target scores, contiguous, 16-byte stores where
//      nc is a multiple of 4.
//
// At b32/640 on an H100 the call takes 0.090 ms, 3.1 x the bound: the
// outputs kernel 0.034 ms (near the bytes' bound), the candidates kernel
// 0.040 ms, most of its 4096 blocks returning at once; the plain version
// takes 12.3 ms.
//
// Arithmetic: each bf16 op of bbox_ciou and the metric rounds to bf16 where
// PyTorch's CUDA kernel writes a bf16 tensor (bf() below), the aspect term
// stays in f32, and this file is built with -fmad=false so no product is
// contracted into a sum. A Python scalar reaches PyTorch's kernels as an f32
// (1e-7, 1 + 1e-7, 4 / pi^2, eps). x ** 0.5 is PyTorch's sqrt, x ** 2 its
// x * x; other exponents powf of the exponent rounded to bf16 (pow_mode in
// the wrapper). Divisions are IEEE divisions (nvcc's default -prec-div).
//
// The launch allocates nothing. The C entry returns cudaGetLastError() so the
// Python wrapper can raise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using u64 = unsigned long long;

constexpr int K_MAX = 16;          // the largest top-k
constexpr int MAX_LEVELS = 8;
constexpr int GT_THREADS = 256;    // a GT's block
constexpr int ROW_THREADS = 256;   // anchors an output block
constexpr float CANDIDATE_EPS = 1e-9f;  // select_candidates_in_gts' eps
constexpr float IOU_EPS = 1e-7f;        // bbox_ciou's eps
// 4 / math.pi ** 2 and 1 + eps as Python computes them, then rounded to f32
constexpr float ASPECT = static_cast<float>(4.0 / (3.141592653589793 * 3.141592653589793));
constexpr float ONE_EPS = static_cast<float>(1.0 + 1e-7);

struct Level {
  int stride, rows, cols, offset;
};

struct Grid {
  Level level[MAX_LEVELS];
  int count;
};

struct Args {
  const __nv_bfloat16* scores;  // (B, A, nc) class probabilities, bf16
  const float* pd;              // (B, A, 4) predicted xyxy pixels
  const float* anchors;         // (A, 2) anchor centres in pixels
  const long long* labels;      // (B, N)
  const float* gt;              // (B, N, 4) xyxy pixels
  const unsigned char* mask;    // (B, N) real GT slots
  int b, n, a, nc, topk;
  int alpha_mode, beta_mode;    // pow_mode of the wrapper
  float alpha, beta, eps;
  unsigned* keys;               // (B, A) zeroed: overlap bits << 16 | 0xFFFF - n
  int* sel_anchor;              // (B, N, K_MAX) each GT's survivors
  unsigned* sel_value;          // (B, N, K_MAX) metric bits << 16 | overlap bits
  int* sel_count;               // (B, N)
  float* target_bboxes;         // (B, A, 4)
  float* target_scores;         // (B, A, nc)
  unsigned char* fg;            // (B, A)
  long long* target_gt;         // (B, A)
};

// a float rounded to bf16, as PyTorch writes a bf16 tensor
__device__ __forceinline__ float bf(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }

__device__ __forceinline__ uint32_t bits_of(float bf_value) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(bf_value));
}

__device__ __forceinline__ float value_of(uint32_t bits) {
  return __bfloat162float(__ushort_as_bfloat16(static_cast<unsigned short>(bits)));
}

// clamp(min=0): NaN stays NaN
__device__ __forceinline__ float clamp0(float x) { return isnan(x) ? x : fmaxf(x, 0.f); }

// x ** e on a bf16 value x as PyTorch's CUDA pow computes it, before the
// rounding to bf16
__device__ __forceinline__ float power(float x, int mode, float e) {
  switch (mode) {
    case 0: return sqrtf(x);
    case 1: return x;
    case 2: return x * x;
    case 3: return bf(x * x) * x;
    default: return powf(x, e);
  }
}

// bbox_ciou(box1 = the GT, box2 = the prediction) on bf16 values
__device__ float ciou_bf16(const float g[4], const float q[4]) {
  const float iw = clamp0(bf(fminf(g[2], q[2]) - fmaxf(g[0], q[0])));
  const float ih = clamp0(bf(fminf(g[3], q[3]) - fmaxf(g[1], q[1])));
  const float inter = bf(iw * ih);
  const float w1 = bf(g[2] - g[0]), h1 = bf(g[3] - g[1]);
  const float w2 = bf(q[2] - q[0]), h2 = bf(q[3] - q[1]);
  const float area1 = bf(w1 * h1), area2 = bf(w2 * h2);
  const float iou = bf(inter / bf(bf(bf(area1 + area2) - inter) + IOU_EPS));
  const float cw = bf(fmaxf(g[2], q[2]) - fminf(g[0], q[0]));
  const float ch = bf(fmaxf(g[3], q[3]) - fminf(g[1], q[1]));
  const float c2 = bf(bf(bf(cw * cw) + bf(ch * ch)) + IOU_EPS);
  const float dx = bf(bf(bf(q[0] + q[2]) * 0.5f) - bf(bf(g[0] + g[2]) * 0.5f));
  const float dy = bf(bf(bf(q[1] + q[3]) * 0.5f) - bf(bf(g[1] + g[3]) * 0.5f));
  const float rho2 = bf(bf(dx * dx) + bf(dy * dy));
  // the aspect term in f32
  const float t = atanf(w2 / (h2 + IOU_EPS)) - atanf(w1 / (h1 + IOU_EPS));
  const float v = ASPECT * (t * t);
  const float alpha = v / fmaxf((v - iou) + ONE_EPS, IOU_EPS);
  return bf(iou - bf(bf(rho2 / c2) + bf(alpha * v)));
}

// anchor index range [lo, hi] along one axis of a level that can hold the
// centres strictly inside (x1, x2), widened by one cell; empty if hi < lo
__device__ __forceinline__ void axis_range(float x1, float x2, int stride, int cells, int& lo,
                                           int& hi) {
  const float s = static_cast<float>(stride), top = static_cast<float>(cells);
  // clamped before the int conversion (fmaxf takes -1 for a NaN)
  lo = max(static_cast<int>(floorf(fminf(fmaxf(x1 / s - 0.5f, -1.f), top))) - 1, 0);
  hi = min(static_cast<int>(floorf(fminf(fmaxf(x2 / s - 0.5f, -1.f), top))) + 1, cells - 1);
}

__device__ __forceinline__ u64 block_max(u64 v, u64 (*slots)[GT_THREADS / 32],
                                              int round) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = max(v, __shfl_xor_sync(0xffffffffu, v, off));
  // two sets of slots: a round's writes never meet the last round's reads
  u64* slot = slots[round & 1];
  if ((threadIdx.x & 31) == 0) slot[threadIdx.x >> 5] = v;
  __syncthreads();
  u64 best = 0;
#pragma unroll
  for (int w = 0; w < GT_THREADS / 32; ++w) best = max(best, slot[w]);
  return best;
}

__device__ __forceinline__ int key_anchor(u64 key) {
  return static_cast<int>(0xFFFFFFFFu - static_cast<uint32_t>(key >> 16));
}

__global__ void __launch_bounds__(GT_THREADS) tal_candidates_kernel(Args p, Grid grid) {
  const int n = blockIdx.x, b = blockIdx.y;
  const int gtn = b * p.n + n;
  if (!p.mask[gtn]) {
    if (threadIdx.x == 0) p.sel_count[gtn] = 0;
    return;
  }
  __shared__ uint32_t zero_mask;               // zero-metric candidates below K_MAX
  __shared__ uint32_t zero_overlap[K_MAX];
  __shared__ u64 slots[2][GT_THREADS / 32];
  __shared__ u64 picked[K_MAX];
  if (threadIdx.x == 0) zero_mask = 0;
  __syncthreads();

  const float4 box = reinterpret_cast<const float4*>(p.gt)[gtn];
  const float g[4] = {bf(box.x), bf(box.y), bf(box.z), bf(box.w)};
  const long long label = min(max(p.labels[gtn], 0LL), static_cast<long long>(p.nc - 1));
  const float4* pd = reinterpret_cast<const float4*>(p.pd) + static_cast<size_t>(b) * p.a;
  const __nv_bfloat16* scores = p.scores + static_cast<size_t>(b) * p.a * p.nc + label;

  u64 top[K_MAX];  // this thread's best keys, descending; 0 is empty
#pragma unroll
  for (int i = 0; i < K_MAX; ++i) top[i] = 0;

  for (int l = 0; l < grid.count; ++l) {
    const Level lv = grid.level[l];
    int x0, x1, y0, y1;
    axis_range(box.x, box.z, lv.stride, lv.cols, x0, x1);
    axis_range(box.y, box.w, lv.stride, lv.rows, y0, y1);
    const int w = x1 - x0 + 1, h = y1 - y0 + 1;
    const int cells = (w > 0 && h > 0) ? w * h : 0;
    for (int j = threadIdx.x; j < cells; j += GT_THREADS) {
      const int row = y0 + j / w, col = x0 + j % w;
      const int a = lv.offset + row * lv.cols + col;
      const float ax = __ldg(p.anchors + 2 * a), ay = __ldg(p.anchors + 2 * a + 1);
      // min(lt, rb) > eps, false where any side is NaN as amin makes it
      if (!(ax - box.x > CANDIDATE_EPS && ay - box.y > CANDIDATE_EPS &&
            box.z - ax > CANDIDATE_EPS && box.w - ay > CANDIDATE_EPS))
        continue;
      const float4 pb = __ldg(pd + a);
      const float q[4] = {bf(pb.x), bf(pb.y), bf(pb.z), bf(pb.w)};
      const float overlap = clamp0(ciou_bf16(g, q));
      const float score = __bfloat162float(scores[static_cast<size_t>(a) * p.nc]);
      const float metric = bf(bf(power(score, p.alpha_mode, p.alpha)) *
                              bf(power(overlap, p.beta_mode, p.beta)));
      const uint32_t mbits = bits_of(metric), obits = bits_of(overlap);
      if (mbits == 0) {
        if (a < K_MAX) {
          atomicOr(&zero_mask, 1u << a);
          zero_overlap[a] = obits;
        }
        continue;
      }
      u64 key = (static_cast<u64>(mbits) << 48) |
                     (static_cast<u64>(0xFFFFFFFFu - static_cast<uint32_t>(a)) << 16) | obits;
      if (key > top[K_MAX - 1]) {
#pragma unroll
        for (int i = 0; i < K_MAX; ++i) {
          if (key > top[i]) {
            const u64 t = top[i];
            top[i] = key;
            key = t;
          }
        }
      }
    }
  }
  __syncthreads();

  // top-k rounds: the block's best head, popped by the thread that holds it
  int found = 0;
  for (int r = 0; r < p.topk; ++r) {
    const u64 best = block_max(top[0], slots, r);
    if (best == 0) break;  // no positive metric left (uniform across the block)
    if (top[0] == best) {
#pragma unroll
      for (int i = 0; i < K_MAX - 1; ++i) top[i] = top[i + 1];
      top[K_MAX - 1] = 0;
    }
    if (threadIdx.x == 0) picked[r] = best;
    found = r + 1;
  }
  if (threadIdx.x != 0) return;

  int count = 0;
  int* sel_anchor = p.sel_anchor + static_cast<size_t>(gtn) * K_MAX;
  unsigned* sel_value = p.sel_value + static_cast<size_t>(gtn) * K_MAX;
  auto keep = [&](int a, uint32_t mbits, uint32_t obits) {
    sel_anchor[count] = a;
    sel_value[count] = (mbits << 16) | obits;
    ++count;
    const uint32_t folded = obits == 0x8000u ? 0u : obits;  // -0.0 claims as +0.0
    atomicMax(p.keys + static_cast<size_t>(b) * p.a + a, (folded << 16) | (0xFFFFu - n));
  };
  if (found > 0 && value_of(static_cast<uint32_t>(picked[0] >> 48)) > p.eps) {
    for (int i = 0; i < found; ++i)
      keep(key_anchor(picked[i]), static_cast<uint32_t>(picked[i] >> 48),
           static_cast<uint32_t>(picked[i] & 0xFFFFu));
    // the last topk - found argmax picks: the lowest anchors with a metric of 0
    const int zeros = p.topk - found;
    for (int a = 0; a < p.topk && zeros > 0; ++a) {
      if (!((zero_mask >> a) & 1u)) continue;
      int below = 0;
      for (int i = 0; i < found; ++i) below += key_anchor(picked[i]) < a;
      if (a - below < zeros) keep(a, 0u, zero_overlap[a]);
    }
  }
  p.sel_count[gtn] = count;
}

__global__ void __launch_bounds__(ROW_THREADS) tal_outputs_kernel(Args p) {
  __shared__ int row_label[ROW_THREADS];  // -1: background
  __shared__ float row_score[ROW_THREADS];
  const long long rows = static_cast<long long>(p.b) * p.a;
  const long long r0 = static_cast<long long>(blockIdx.x) * ROW_THREADS;
  const long long r = r0 + threadIdx.x;
  if (r < rows) {
    const int b = static_cast<int>(r / p.a), a = static_cast<int>(r % p.a);
    const unsigned key = p.keys[r];
    int n = 0, label = -1;
    float score = 0.f;
    if (key != 0) {
      const unsigned tag = key & 0xFFFFu;
      n = static_cast<int>(0xFFFFu - tag);
      const int gtn = b * p.n + n;
      const int count = p.sel_count[gtn];
      const int* sel_anchor = p.sel_anchor + static_cast<size_t>(gtn) * K_MAX;
      const unsigned* sel_value = p.sel_value + static_cast<size_t>(gtn) * K_MAX;
      const unsigned* keys = p.keys + static_cast<size_t>(b) * p.a;
      // pos_align, pos_overlap: maxima over the anchors n won, and 0
      float pos_align = 0.f, pos_overlap = 0.f, own = 0.f;
      for (int j = 0; j < count; ++j) {
        const int e = sel_anchor[j];
        if ((keys[e] & 0xFFFFu) != tag) continue;
        const float metric = value_of(sel_value[j] >> 16);
        pos_align = fmaxf(pos_align, metric);
        pos_overlap = fmaxf(pos_overlap, value_of(sel_value[j] & 0xFFFFu));
        if (e == a) own = metric;
      }
      score = bf(bf(own * pos_overlap) / bf(pos_align + p.eps));
      label = static_cast<int>(min(max(p.labels[gtn], 0LL), static_cast<long long>(p.nc - 1)));
    }
    p.fg[r] = key != 0;
    p.target_gt[r] = n;
    reinterpret_cast<float4*>(p.target_bboxes)[r] =
        reinterpret_cast<const float4*>(p.gt)[static_cast<size_t>(b) * p.n + n];
    row_label[threadIdx.x] = label;
    row_score[threadIdx.x] = score;
  }
  __syncthreads();

  // the tile's rows of the target scores, back to back in memory
  const int tile = static_cast<int>(min(static_cast<long long>(ROW_THREADS), rows - r0));
  float* out = p.target_scores + r0 * p.nc;
  const int total = tile * p.nc;
  if ((p.nc & 3) == 0) {
    for (int v = threadIdx.x; v < total / 4; v += ROW_THREADS) {
      const int e = 4 * v, row = e / p.nc;
      const int d = row_label[row] - (e - row * p.nc);
      const float s = row_score[row];
      const float4 q = make_float4(d == 0 ? s : 0.f, d == 1 ? s : 0.f, d == 2 ? s : 0.f,
                                   d == 3 ? s : 0.f);
      reinterpret_cast<float4*>(out)[v] = q;
    }
  } else {
    for (int e = threadIdx.x; e < total; e += ROW_THREADS) {
      const int row = e / p.nc;
      out[e] = row_label[row] == e - row * p.nc ? row_score[row] : 0.f;
    }
  }
}

}  // namespace

// levels: (stride, rows, cols) of each anchor level, in the anchors' order
extern "C" int tal_assign(const void* scores, const void* pd, const void* anchors,
                          const void* labels, const void* gt, const void* mask, int b, int n,
                          int a, int nc, int topk, int alpha_mode, float alpha, int beta_mode,
                          float beta, float eps, const int* levels, int n_levels, void* keys,
                          void* sel_anchor, void* sel_value, void* sel_count,
                          void* target_bboxes, void* target_scores, void* fg, void* target_gt,
                          void* stream) {
  if (n_levels < 1 || n_levels > MAX_LEVELS || topk < 1 || topk > K_MAX || n > 0xFFFF)
    return static_cast<int>(cudaErrorInvalidValue);
  Args p;
  p.scores = static_cast<const __nv_bfloat16*>(scores);
  p.pd = static_cast<const float*>(pd);
  p.anchors = static_cast<const float*>(anchors);
  p.labels = static_cast<const long long*>(labels);
  p.gt = static_cast<const float*>(gt);
  p.mask = static_cast<const unsigned char*>(mask);
  p.b = b;
  p.n = n;
  p.a = a;
  p.nc = nc;
  p.topk = topk;
  p.alpha_mode = alpha_mode;
  p.beta_mode = beta_mode;
  p.alpha = alpha;
  p.beta = beta;
  p.eps = eps;
  p.keys = static_cast<unsigned*>(keys);
  p.sel_anchor = static_cast<int*>(sel_anchor);
  p.sel_value = static_cast<unsigned*>(sel_value);
  p.sel_count = static_cast<int*>(sel_count);
  p.target_bboxes = static_cast<float*>(target_bboxes);
  p.target_scores = static_cast<float*>(target_scores);
  p.fg = static_cast<unsigned char*>(fg);
  p.target_gt = static_cast<long long*>(target_gt);
  Grid grid;
  grid.count = n_levels;
  int offset = 0;
  for (int l = 0; l < n_levels; ++l) {
    grid.level[l] = {levels[3 * l], levels[3 * l + 1], levels[3 * l + 2], offset};
    offset += levels[3 * l + 1] * levels[3 * l + 2];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(keys, 0, sizeof(unsigned) * static_cast<size_t>(b) * a, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n > 0) {
    tal_candidates_kernel<<<dim3(n, b), GT_THREADS, 0, s>>>(p, grid);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long rows = static_cast<long long>(b) * a;
  tal_outputs_kernel<<<static_cast<unsigned>((rows + ROW_THREADS - 1) / ROW_THREADS),
                       ROW_THREADS, 0, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

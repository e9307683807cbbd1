// Per-anchor class-score reduction for Hopper (sm_90a), bound to Python through ctypes.
//
// Replaces the TPU kernel deal_yolo_daya_tpu/ops/pallas/score_reduce.py::_kernel.
// Given (B, A, nc) class logits in bf16 or f32, it writes for every anchor
//
//     score = sigmoid(max_c logits) in f32, class = the first c reaching the max
//
// as (B, A) f32 and (B, A) int32. Sigmoid is monotone, so this is the
// max/argmax of the sigmoid scores up to f32 ties (a larger logit whose
// sigmoid rounds to the same f32 wins here; the first of the tied sigmoids
// wins there). The max is taken in f32 on the exact f32 value of each input;
// the score is 1 / (1 + expf(-max)), the formula and libdevice expf of
// torch.sigmoid's CUDA kernel, so it can equal the plain version bit for bit.
// A NaN counts as larger than every number (torch.argmax's rule), ties go to
// the lower class.
//
// What bounds it: bytes. At (32, 8400, 80) bf16 it reads 43.0 MB and writes
// 2.15 MB, about 1 operation a byte. The TPU kernel padded the classes to 128,
// made an f32 copy of each block and selected the argmax arithmetically
// (Mosaic had no bf16 compare and no usable argmax); none of that is needed
// here. The input is read in place by its strides, never copied:
//
// - class stride 1 (the (B, A, nc) rows that decode concatenates): one warp a
//   row. The lanes read 32 consecutive classes at a time, so each warp load is
//   one contiguous run of the row, and reduce (value, class) by shuffles;
// - any other strides (a per-level NCHW view, anchors contiguous): one thread
//   an anchor, looping over the classes; neighbouring threads read
//   neighbouring anchors of the same class, so the loads coalesce when the
//   anchor stride is 1.
//
// The launch allocates nothing. The C entry returns cudaGetLastError() so the
// Python wrapper can raise.

#include <climits>
#include <cmath>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// Does value v at class i replace the best so far (bv at class bi)?
__device__ __forceinline__ bool beats(float v, int i, float bv, int bi) {
  const bool vn = v != v, bn = bv != bv;
  if (vn || bn) return vn && (!bn || i < bi);
  return v > bv || (v == bv && i < bi);
}

__device__ __forceinline__ float sigmoid(float m) { return 1.0f / (1.0f + expf(-m)); }

template <typename T>
__global__ void __launch_bounds__(THREADS)
rows_kernel(const T* __restrict__ x, long long rows, long long a, int nc, long long sb,
            long long sa, float* __restrict__ score, int* __restrict__ cls) {
  const int lane = threadIdx.x % 32;
  const long long warps = (long long)gridDim.x * (THREADS / 32);
  for (long long r = (long long)blockIdx.x * (THREADS / 32) + threadIdx.x / 32; r < rows;
       r += warps) {
    const T* row = x + (r / a) * sb + (r % a) * sa;
    float best = -INFINITY;
    int arg = INT_MAX;
    for (int c = lane; c < nc; c += 32) {
      const float v = to_f32(row[c]);
      if (beats(v, c, best, arg)) best = v, arg = c;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(FULL, best, off);
      const int oi = __shfl_xor_sync(FULL, arg, off);
      if (beats(ov, oi, best, arg)) best = ov, arg = oi;
    }
    if (lane == 0) {
      score[r] = sigmoid(best);
      cls[r] = arg;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
anchors_kernel(const T* __restrict__ x, long long rows, long long a, int nc, long long sb,
               long long sa, long long sc, float* __restrict__ score, int* __restrict__ cls) {
  const long long stride = (long long)gridDim.x * THREADS;
  for (long long r = (long long)blockIdx.x * THREADS + threadIdx.x; r < rows; r += stride) {
    const T* p = x + (r / a) * sb + (r % a) * sa;
    float best = -INFINITY;
    int arg = INT_MAX;
    for (int c = 0; c < nc; ++c) {
      const float v = to_f32(p[c * sc]);
      if (beats(v, c, best, arg)) best = v, arg = c;
    }
    score[r] = sigmoid(best);
    cls[r] = arg;
  }
}

template <typename T>
int launch(const void* x, long long b, long long a, int nc, long long sb, long long sa,
           long long sc, float* score, int* cls, cudaStream_t s) {
  const long long rows = b * a;
  const T* in = static_cast<const T*>(x);
  if (sc == 1) {
    const long long blocks = (rows + THREADS / 32 - 1) / (THREADS / 32);
    rows_kernel<T><<<(unsigned)(blocks < 1048576 ? blocks : 1048576), THREADS, 0, s>>>(
        in, rows, a, nc, sb, sa, score, cls);
  } else {
    const long long blocks = (rows + THREADS - 1) / THREADS;
    anchors_kernel<T><<<(unsigned)(blocks < 1048576 ? blocks : 1048576), THREADS, 0, s>>>(
        in, rows, a, nc, sb, sa, sc, score, cls);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (B, A, nc) bf16 (is_bf16 = 1) or f32 with element strides (sb, sa, sc);
// score (B, A) f32 and cls (B, A) int32, contiguous. Returns 0 on a good
// launch, else the CUDA error code.
extern "C" int score_reduce(const void* x, int is_bf16, long long b, long long a, int nc,
                            long long sb, long long sa, long long sc, void* score, void* cls,
                            void* stream) {
  if (b <= 0 || a <= 0 || nc <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* out_s = static_cast<float*>(score);
  int* out_c = static_cast<int*>(cls);
  return is_bf16 ? launch<__nv_bfloat16>(x, b, a, nc, sb, sa, sc, out_s, out_c, s)
                 : launch<float>(x, b, a, nc, sb, sa, sc, out_s, out_c, s);
}

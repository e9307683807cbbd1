// Exact greedy NMS suppression for Hopper (sm_90a), bound to Python through ctypes.
//
// Replaces the TPU kernel deal_yolo_daya_tpu/ops/pallas/nms_suppress.py::_kernel.
// Given K score-sorted, class-offset candidate boxes per image and their
// validity, it returns the greedy keep mask
//
//     keep_i = valid_i and not any(j < i: keep_j and IoU(j, i) > thr)
//
// with IoU = inter / (area_j + area_i - inter + 1e-7) in f32, j the earlier box.
// The mask must equal the plain PyTorch version bit for bit, so every IoU
// step is one correctly rounded operation (__fsub_rn, __fmul_rn, __fadd_rn,
// __fdiv_rn are never contracted into FMAs, and the file is built with
// -fmad=false as well), in the same order as the elementwise PyTorch ops.
//
// What bounds it: the inputs are tiny (K=1000 boxes are 16 KB an image), so
// the bound is the ~K^2/2 IoU evaluations, f32 work on the CUDA cores, and
// after them a scan that is sequential by nature. The TPU kernel solved the
// recurrence by Jacobi iteration, a (1,K)x(K,K) MXU matvec per step. Here two
// kernels, launched back to back on the caller's stream:
//
// 1. nms_mask_kernel, grid (B, ceil(K/ROWS)): each block stages the boxes it
//    needs in shared memory and writes ROWS rows of the K x ceil(K/32)
//    suppression bitmask to a scratch buffer, one warp ballot per 32-bit
//    word, upper triangle only. Spreading the rows over blocks fills all 132
//    SMs at B=32. A pair whose intersection is 0 cannot pass a threshold
//    >= 0, so it skips the division (the result is the same bit).
// 2. nms_scan_kernel, grid B: the block loads its image's bitmask into shared
//    memory (128 KB at K=1000), then one warp walks it 32 candidates at a
//    time. Within a word the greedy decisions are a chain of register
//    operations on shuffled row bits; each kept row then ORs its bitmask row
//    into the removed-bitmask, one word per lane. The walk gives the same
//    fixed point as the Jacobi iteration: the exact sequential greedy result.
//
// The launches allocate nothing; the wrapper allocates the scratch bitmask.
// The C entry returns cudaGetLastError() so the Python wrapper can raise.

#include <cuda_runtime.h>

namespace {

constexpr int MASK_THREADS = 256;
constexpr int MASK_WARPS = MASK_THREADS / 32;
constexpr int ROWS = 32;         // bitmask rows per block of the mask kernel
constexpr int SCAN_THREADS = 1024;
constexpr int MAX_WORDS = 64;    // removed-bitmask words a lane can hold: K <= 2048
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float box_area(float4 b) {
  return __fmul_rn(__fsub_rn(b.z, b.x), __fsub_rn(b.w, b.y));
}

__global__ void __launch_bounds__(MASK_THREADS)
nms_mask_kernel(const float4* __restrict__ boxes, const unsigned char* __restrict__ valid,
                float thr, int k, unsigned* __restrict__ mask) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int words = (k + 31) / 32;
  const int r0 = blockIdx.y * ROWS;
  const int r1 = min(k, r0 + ROWS);
  const int span = k - r0;                                  // boxes r0 .. k-1
  float4* bx = reinterpret_cast<float4*>(smem);             // (span,)
  float* area = reinterpret_cast<float*>(bx + span);        // (span,)
  unsigned char* ok = reinterpret_cast<unsigned char*>(area + span);  // (span,)

  const size_t img = blockIdx.x;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  for (int t = threadIdx.x; t < span; t += MASK_THREADS) {
    const float4 b = boxes[img * k + r0 + t];
    bx[t] = b;
    area[t] = box_area(b);
    ok[t] = valid[img * k + r0 + t];
  }
  __syncthreads();

  // mask[i][w] bit t: box c = 32w+t, c > i, is valid and IoU(i, c) > thr.
  // One warp a row; words left of the diagonal are 0 (and so are the rows of
  // invalid boxes, which the scan never reads).
  for (int i = r0 + warp; i < r1; i += MASK_WARPS) {
    unsigned* row = mask + (img * k + i) * words;
    const int first = ok[i - r0] ? i / 32 : words;
    for (int w = lane; w < first; w += 32) row[w] = 0u;
    const float4 a = bx[i - r0];
    const float area_a = area[i - r0];
    for (int w = first; w < words; ++w) {
      const int c = 32 * w + lane;
      bool hit = false;
      if (c > i && c < k && ok[c - r0]) {
        const float4 o = bx[c - r0];
        const float iw = fmaxf(__fsub_rn(fminf(a.z, o.z), fmaxf(a.x, o.x)), 0.f);
        const float ih = fmaxf(__fsub_rn(fminf(a.w, o.w), fmaxf(a.y, o.y)), 0.f);
        const float inter = __fmul_rn(iw, ih);
        if (inter != 0.f || thr < 0.f) {  // else IoU is +-0 (or NaN): never > thr >= 0
          const float denom =
              __fadd_rn(__fsub_rn(__fadd_rn(area_a, area[c - r0]), inter), 1e-7f);
          hit = __fdiv_rn(inter, denom) > thr;
        }
      }
      const unsigned bits = __ballot_sync(FULL, hit);
      if (lane == 0) row[w] = bits;
    }
  }
}

__global__ void __launch_bounds__(SCAN_THREADS)
nms_scan_kernel(const unsigned* __restrict__ mask, const unsigned char* __restrict__ valid,
                int k, unsigned char* __restrict__ keep) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int words = (k + 31) / 32;
  unsigned* bits = reinterpret_cast<unsigned*>(smem);                            // (k, words)
  unsigned char* ok = reinterpret_cast<unsigned char*>(bits + (size_t)k * words);  // (k,)

  const size_t img = blockIdx.x;
  for (int e = threadIdx.x; e < k * words; e += SCAN_THREADS)
    bits[e] = mask[img * k * words + e];
  for (int i = threadIdx.x; i < k; i += SCAN_THREADS) ok[i] = valid[img * k + i];
  __syncthreads();
  if (threadIdx.x >= 32) return;

  const int lane = threadIdx.x;
  unsigned removed0 = 0, removed1 = 0;  // removed words lane and lane + 32
  for (int w = 0; w < words; ++w) {
    unsigned rem = __shfl_sync(FULL, w < 32 ? removed0 : removed1, w % 32);
    const int row = 32 * w + lane;
    const bool live = row < k;
    const unsigned own = live ? bits[(size_t)row * words + w] : 0u;  // row's bits in word w
    const unsigned okw = __ballot_sync(FULL, live && ok[row]);
    unsigned kept = 0;
#pragma unroll
    for (int t = 0; t < 32; ++t) {  // greedy within the word, the same in every lane
      const unsigned m = __shfl_sync(FULL, own, t);
      if (((okw & ~rem) >> t) & 1u) {
        kept |= 1u << t;
        rem |= m;
      }
    }
    if (live) keep[img * k + row] = (kept >> lane) & 1u;
    for (unsigned todo = kept; todo; todo &= todo - 1) {  // kept rows remove later boxes
      const unsigned* r = bits + (size_t)(32 * w + __ffs(todo) - 1) * words;
      if (lane < words) removed0 |= r[lane];
      if (lane + 32 < words) removed1 |= r[lane + 32];
    }
  }
}

long long mask_smem_bytes(int k) { return (long long)k * (16 + 4 + 1); }

long long scan_smem_bytes(int k) {
  return (long long)k * ((k + 31) / 32) * 4 + k;
}

}  // namespace

// Scratch the wrapper allocates: the (B, K, ceil(K/32)) u32 bitmask.
extern "C" long long nms_suppress_scratch_words(int b, int k) {
  return (long long)b * k * ((k + 31) / 32);
}

// Shared memory the larger of the two kernels needs for K candidates; the
// wrapper checks it against the card's per-block limit before launching.
extern "C" long long nms_suppress_smem_bytes(int k) {
  const long long a = mask_smem_bytes(k), s = scan_smem_bytes(k);
  return a > s ? a : s;
}

// boxes (B, K, 4) f32, valid (B, K) bool, scratch (B, K, ceil(K/32)) u32,
// keep (B, K) bool. Returns 0 on good launches, else the CUDA error code.
extern "C" int nms_suppress(const void* boxes, const void* valid, void* scratch, void* keep,
                            int b, int k, float thr, void* stream) {
  if (k > 32 * MAX_WORDS) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long mask_smem = mask_smem_bytes(k), scan_smem = scan_smem_bytes(k);
  cudaError_t err = cudaFuncSetAttribute(nms_mask_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(mask_smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(nms_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(scan_smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(b, (k + ROWS - 1) / ROWS);
  nms_mask_kernel<<<grid, MASK_THREADS, static_cast<size_t>(mask_smem), s>>>(
      static_cast<const float4*>(boxes), static_cast<const unsigned char*>(valid), thr, k,
      static_cast<unsigned*>(scratch));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  nms_scan_kernel<<<b, SCAN_THREADS, static_cast<size_t>(scan_smem), s>>>(
      static_cast<const unsigned*>(scratch), static_cast<const unsigned char*>(valid), k,
      static_cast<unsigned char*>(keep));
  return static_cast<int>(cudaGetLastError());
}

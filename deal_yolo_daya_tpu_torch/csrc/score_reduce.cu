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
// here. The input is read in place by its strides, never copied, by one of
// three mappings that the wrapper picks from the layout
// (ops/kernels/score_reduce.py::reduce_mapping):
//
// - BULK_ROWS, rows contiguous across the whole (B, A) range, a whole number
//   of 16-byte vectors each, from a 16-byte boundary (the (B, A, 80) logits
//   that decode concatenates): a persistent grid of blocks, each bringing
//   256-row tiles by 1-D bulk copy (cp.async.bulk, TMA) into a
//   double-buffered mbarrier ring, so a tile is in flight while the one
//   before is reduced; a thread reduces a row from shared memory, loading
//   its 16-byte vectors (10 for 80 bf16 classes, 20 for f32) before it
//   compares them. One thread a row with its 16-byte loads straight from
//   device memory came second (0.0187-0.0192 against 0.0162-0.0169 ms at
//   (32, 8400, 80) bf16 on an H100; PERF.md);
// - WARP_ROWS, class stride 1 otherwise (odd widths, a view that starts off a
//   16-byte boundary, rows with gaps): one warp a row; the lanes read 32
//   consecutive classes at a time and reduce (value, class) by shuffles;
// - ANCHORS, any other strides (a per-level NCHW view, anchors contiguous):
//   one thread an anchor, looping over the classes; neighbouring threads read
//   neighbouring anchors of the same class, so the loads coalesce when the
//   anchor stride is 1.
//
// The launch allocates nothing. The C entry returns cudaGetLastError() so the
// Python wrapper can raise.

#include <climits>
#include <cmath>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

constexpr int THREADS = 256;
constexpr unsigned FULL = 0xffffffffu;
enum Mapping { ANCHORS = 0, WARP_ROWS = 1, BULK_ROWS = 2 };
constexpr int BULK_TILE = THREADS;  // rows a bulk tile

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// Does value v at class i replace the best so far (bv at class bi)?
__device__ __forceinline__ bool beats(float v, int i, float bv, int bi) {
  const bool vn = v != v, bn = bv != bv;
  if (vn || bn) return vn && (!bn || i < bi);
  return v > bv || (v == bv && i < bi);
}

__device__ __forceinline__ float sigmoid(float m) { return 1.0f / (1.0f + expf(-m)); }

// beats() for a scan in increasing class order from (-inf, class 0): a later
// class never wins a tie, a NaN wins unless a NaN came first
__device__ __forceinline__ void take(float v, int c, float& best, int& arg) {
  if (v > best || (v != v && best == best)) best = v, arg = c;
}

// The values of a 16-byte vector, in class order, as exact f32: 4 f32 or 8 bf16.
__device__ __forceinline__ void unpack(const uint4& q, float (&v)[4]) {
  v[0] = __uint_as_float(q.x), v[1] = __uint_as_float(q.y);
  v[2] = __uint_as_float(q.z), v[3] = __uint_as_float(q.w);
}

__device__ __forceinline__ void unpack(const uint4& q, float (&v)[8]) {
  const unsigned w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // the lower address holds the lower class
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// Reduce a row of nvec 16-byte vectors at `row`, CH loads issued before any
// is reduced.
template <typename T, int CH>
__device__ __forceinline__ void reduce_row(const uint4* row, int nvec, float& best, int& arg) {
  constexpr int PER = 16 / sizeof(T);
  for (int v0 = 0; v0 < nvec; v0 += CH) {
    uint4 buf[CH];
#pragma unroll
    for (int j = 0; j < CH; ++j)
      if (v0 + j < nvec) buf[j] = row[v0 + j];
#pragma unroll
    for (int j = 0; j < CH; ++j) {
      if (v0 + j < nvec) {
        float v[PER];
        unpack(buf[j], v);
#pragma unroll
        for (int e = 0; e < PER; ++e) take(v[e], (v0 + j) * PER + e, best, arg);
      }
    }
  }
}

// 16-byte vectors a thread loads before it reduces: a row of 80 classes
template <typename T>
__host__ __device__ constexpr int chunk() { return 80 * static_cast<int>(sizeof(T)) / 16; }

// Rows contiguous from x: tiles of BULK_TILE rows by cp.async.bulk into two
// shared-memory stages, one thread a row.
template <typename T>
__global__ void __launch_bounds__(THREADS)
bulk_rows_kernel(const T* __restrict__ x, long long rows, int nc, float* __restrict__ score,
                 int* __restrict__ cls) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int row_bytes = nc * static_cast<int>(sizeof(T));
  const int stage_bytes = BULK_TILE * row_bytes;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + 2 * stage_bytes);
  const long long tiles = (rows + BULK_TILE - 1) / BULK_TILE;
  auto issue = [&](long long tile, int stage) {  // one thread
    const long long r0 = tile * BULK_TILE;
    const long long n = rows - r0 < BULK_TILE ? rows - r0 : BULK_TILE;
    const uint32_t bytes = static_cast<uint32_t>(n * row_bytes);
    const uint32_t bar = hopper::smem_u32(&bars[stage]);
    hopper::mbar_expect_tx(bar, bytes);
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
        ::"r"(hopper::smem_u32(smem + stage * stage_bytes)),
        "l"(reinterpret_cast<uint64_t>(x + r0 * nc)), "r"(bytes), "r"(bar)
        : "memory");
  };
  if (threadIdx.x == 0) {
    hopper::mbar_init(hopper::smem_u32(&bars[0]), 1);
    hopper::mbar_init(hopper::smem_u32(&bars[1]), 1);
    hopper::mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int s = 0; s < 2; ++s) {
      const long long start = blockIdx.x + (long long)s * gridDim.x;
      if (start < tiles) issue(start, s);
    }
  }
  int i = 0;
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++i) {
    const int stage = i & 1;
    hopper::mbar_wait(hopper::smem_u32(&bars[stage]), (i >> 1) & 1);
    const long long r = tile * BULK_TILE + threadIdx.x;
    if (r < rows) {
      const unsigned char* base = smem + stage * stage_bytes + threadIdx.x * row_bytes;
      float best = -INFINITY;
      int arg = 0;
      reduce_row<T, chunk<T>()>(reinterpret_cast<const uint4*>(base), row_bytes / 16, best, arg);
      score[r] = sigmoid(best);
      cls[r] = arg;
    }
    __syncthreads();  // every thread is done with this stage
    const long long next = tile + 2LL * gridDim.x;
    if (threadIdx.x == 0 && next < tiles) issue(next, stage);
  }
}

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

long long bulk_smem_bytes(int nc, int esize) { return 2LL * BULK_TILE * nc * esize + 16; }

int sm_count() {
  static const int n = [] {
    int dev = 0, v = 132;
    if (cudaGetDevice(&dev) == cudaSuccess)
      cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev);
    return v;
  }();
  return n;
}

unsigned grid(long long blocks, int per_sm) {
  const long long cap = (long long)sm_count() * per_sm;
  return static_cast<unsigned>(blocks < cap ? (blocks < 1 ? 1 : blocks) : cap);
}

template <typename T>
int launch(const void* x, long long b, long long a, int nc, long long sb, long long sa,
           long long sc, int mapping, float* score, int* cls, cudaStream_t s) {
  const long long rows = b * a;
  const T* in = static_cast<const T*>(x);
  const int esize = static_cast<int>(sizeof(T));
  if (mapping == BULK_ROWS) {
    const long long smem = bulk_smem_bytes(nc, esize);
    if (sc != 1 || (a > 1 && sa != nc) || (b > 1 && sb != a * nc) || (nc * esize) % 16 != 0 ||
        reinterpret_cast<uintptr_t>(x) % 16 != 0 || smem > 232448)
      return static_cast<int>(cudaErrorInvalidValue);
    static const cudaError_t attr = cudaFuncSetAttribute(
        bulk_rows_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, 232448);
    if (attr != cudaSuccess) return static_cast<int>(attr);
    const int per_sm = static_cast<int>(232448 / smem);
    bulk_rows_kernel<T><<<grid((rows + BULK_TILE - 1) / BULK_TILE, per_sm), THREADS,
                          static_cast<size_t>(smem), s>>>(in, rows, nc, score, cls);
  } else if (mapping == WARP_ROWS) {
    if (sc != 1) return static_cast<int>(cudaErrorInvalidValue);
    const long long blocks = (rows + THREADS / 32 - 1) / (THREADS / 32);
    rows_kernel<T><<<(unsigned)(blocks < 1048576 ? blocks : 1048576), THREADS, 0, s>>>(
        in, rows, a, nc, sb, sa, score, cls);
  } else if (mapping == ANCHORS) {
    const long long blocks = (rows + THREADS - 1) / THREADS;
    anchors_kernel<T><<<(unsigned)(blocks < 1048576 ? blocks : 1048576), THREADS, 0, s>>>(
        in, rows, a, nc, sb, sa, sc, score, cls);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (B, A, nc) bf16 (is_bf16 = 1) or f32 with element strides (sb, sa, sc);
// score (B, A) f32 and cls (B, A) int32, contiguous; mapping one of Mapping
// (the wrapper's choice; refused where the layout does not allow it).
// Returns 0 on a good launch, else the CUDA error code.
extern "C" int score_reduce(const void* x, int is_bf16, long long b, long long a, int nc,
                            long long sb, long long sa, long long sc, int mapping, void* score,
                            void* cls, void* stream) {
  if (b <= 0 || a <= 0 || nc <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* out_s = static_cast<float*>(score);
  int* out_c = static_cast<int*>(cls);
  return is_bf16 ? launch<__nv_bfloat16>(x, b, a, nc, sb, sa, sc, mapping, out_s, out_c, s)
                 : launch<float>(x, b, a, nc, sb, sa, sc, mapping, out_s, out_c, s);
}

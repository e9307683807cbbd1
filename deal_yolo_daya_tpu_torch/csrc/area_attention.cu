// Area-attention forward for Hopper (sm_90a), bound to Python through ctypes.
//
// Replaces the TPU kernel deal_yolo_daya_tpu/ops/pallas/area_attention.py::_kernel.
// For each (batch x area) chunk and head: out = softmax(q k^T * key_dim^-1/2) v,
// with f32 scores, P rounded to bf16 before P.V, and an f32 accumulator, plus
// the contiguous per-head-concat copy of v that the positional-encoding conv
// reads.
//
// Layout: qkv (BA, n, heads*(2*KD+HD)), per head interleaved q|k|v columns;
// out and v are (BA, n, heads*HD).
//
// What bounds it: at the yolo11n shape (BA=32, n=400, 2 heads, KD=32, HD=64,
// bf16) the function moves 13 MB (3.9 us of HBM time) and does 2.1 GFLOP
// (2.1 us of bf16 tensor time), so the card's bound is the bytes. The TPU
// kernel kept a chunk's whole (n, n) score tile in VMEM; on Hopper 400x400
// f32 is 640 KB against 227 KB of shared memory a block, so the kernel
// streams key/value tiles with an online softmax (flash-attention style) and
// the scores never reach device memory. With ~9 us of work spread over 132
// SMs, what bounds it in practice is latency: each block's chain of copies,
// products and softmax steps.
//
// - bf16 (the predict and train paths): attention_bf16_kernel. One
//   warpgroup (128 threads) a block owns 64 query rows of one (chunk, head).
//   Key/value rows stream in tiles of 80 (n = 400 is 5 tiles; 80 is a legal
//   wgmma N) through a ring of 3 stages in shared memory: thread 0 copies Q
//   and the first three K|V tiles by TMA at the start, each stage completing
//   on its own mbarrier, and refills a stage as soon as the warpgroup is done
//   with it, so two tiles are in flight while the third is computed on. The
//   TMA maps are 3-D (chunk, row, column): rows past n inside a chunk come in
//   as zeros, and key columns >= n are masked to -inf before the row max.
//   S = Q K^T is two wgmma m64n80k16 from shared memory (64-byte swizzled
//   rows); the online softmax runs on the accumulator in registers (a row
//   lives in the 4 lanes of a quad: two shuffles for its max; the sum stays
//   per lane until the end); P is rounded to bf16 in registers and is the
//   register A operand of O += P V, five wgmma m64n64k16 with V's tile as the
//   MN-major B operand (128-byte swizzled rows); O stays in registers. The
//   epilogue scales O by 1/l, rounds to bf16 and writes 16 bytes a lane
//   through a per-warp bf16 staging tile, and copies the v rows of its own
//   query rows. No score, P or O tile goes through shared memory.
//   Occupancy: 51 KB of shared memory and at most 128 registers a thread
//   (ptxas: 105) give 4 blocks an SM, so the 32 x 2 x 7 = 448 blocks of the
//   main shape run in one wave (528 slots). 64-row query tiles leave 48 of
//   the last tile's rows idle at n = 400. The exponentials are one MUFU
//   ex2.approx.ftz each (a ~6% gain over exp2f).
// - f32 (the reference precision): attention_f32_kernel runs the dot products
//   on the f32 CUDA cores, exact in f32; each query row is owned by TPR
//   neighbouring lanes that split the columns and combine q.k partial sums
//   with two warp shuffles.
//
// - (key_dim, head_dim) = (32, 32), yolo12's AAttn: the same kernels built
//   for HD = 32. V's tile rows are 64 bytes, so its TMA map takes the 64-byte
//   swizzle and P.V reads it as an MN-major Tile<64> operand (the layout the
//   backward's dQ += dS K already reads K with); P.V is five wgmma
//   m64n32k16, O is 16 registers a thread, and the epilogue and the v
//   passthrough move 64-byte rows. A head's q|k|v columns are 96 apart, so
//   every operand still starts 16-byte aligned. Shared memory: 36 KB a block.
//
// Measured (profiler device time at the main shape, tools/time_attention_kernels.py
// and chip_smoke.py, NVIDIA H100 80GB HBM3 at a 700 W power limit):
// 0.0106-0.0108 ms, 2.7x the 0.0039 ms bound, against 0.0941 ms for the
// earlier WMMA design whose tiles went through shared memory, and
// 0.0151-0.0158 ms for scaled_dot_product_attention.
// The launches allocate nothing and run on the caller's stream; the C entry
// returns cudaGetLastError() (or the error of a refused TMA map) so the
// Python wrapper can raise.

#include "hopper.cuh"

namespace {

using namespace hopper;

// ---------------------------------------------------- bf16, wgmma and TMA

constexpr int QT = 64;          // query rows a block (one warpgroup)
constexpr int KT = 80;          // key rows a streamed tile
constexpr int STAGES = 3;       // K|V tiles in the ring
constexpr int W_THREADS = 128;  // one warpgroup

// Dynamic shared memory from its first 1024-byte boundary: the V stages,
// the K stages, the Q tile, then the barriers (Q's, one a stage). Every tile
// starts on a 1024-byte boundary.
template <int KD, int HD>
struct FwdSmem {
  static constexpr int K_BYTES = KT * KD * 2, V_BYTES = KT * HD * 2, Q_BYTES = QT * KD * 2;
  static constexpr int V_OFF = 0, K_OFF = STAGES * V_BYTES, Q_OFF = K_OFF + STAGES * K_BYTES;
  static constexpr int BAR_OFF = Q_OFF + Q_BYTES;
  static constexpr size_t bytes = BAR_OFF + 8 * (STAGES + 1) + 1024;
  static_assert(K_BYTES % 1024 == 0 && V_BYTES % 1024 == 0 && Q_BYTES % 1024 == 0,
                "tiles on 1024-byte boundaries");
  static_assert(staging_bytes<HD / 8>() <= STAGES * V_BYTES, "the epilogue stages in the V ring");
};

struct FwdMaps {
  CUtensorMap q, k, v;  // qkv boxes: QT x KD, KT x KD, KT x HD
};

template <int KD, int HD>
__global__ void __launch_bounds__(W_THREADS, 4)
attention_bf16_kernel(const __grid_constant__ FwdMaps maps, const bf16* __restrict__ qkv,
                      bf16* __restrict__ out, bf16* __restrict__ vout, int n, int heads,
                      float scale) {
  static_assert(KD == 32 && (HD == 64 || HD == 32), "wgmma shapes instantiated here");
  using L = FwdSmem<KD, HD>;
  using QK = Tile<KD * 2>;
  using V = Tile<HD * 2>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  const uint32_t base = smem_u32(smem), bar_q = base + L::BAR_OFF;

  const int chunk = blockIdx.z, head = blockIdx.y, q0 = blockIdx.x * QT;
  const int stride = 2 * KD + HD, total = heads * stride, dim = heads * HD;
  const int col = head * stride, tiles = (n + KT - 1) / KT;
  auto bar = [&](int s) { return bar_q + 8 * (s + 1); };
  auto load = [&](int tile) {  // thread 0: K|V rows of `tile` into its stage
    const int s = tile % STAGES;
    mbar_expect_tx(bar(s), L::K_BYTES + L::V_BYTES);
    tma_load(base + L::K_OFF + s * L::K_BYTES, &maps.k, bar(s), col + KD, tile * KT, chunk);
    tma_load(base + L::V_OFF + s * L::V_BYTES, &maps.v, bar(s), col + 2 * KD, tile * KT, chunk);
  };
  if (threadIdx.x == 0) {
    for (int i = 0; i <= STAGES; ++i) mbar_init(bar_q + 8 * i, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect_tx(bar_q, L::Q_BYTES);
    tma_load(base + L::Q_OFF, &maps.q, bar_q, col, q0, chunk);
    for (int t = 0; t < min(STAGES, tiles); ++t) load(t);
  }

  const float c = scale * LOG2E;  // scores in log2 units
  float o[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
  // per row (r0, r1): running max in log2 units, this lane's part of the sum
  float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F, l0 = 0.f, l1 = 0.f;
  const uint64_t q_desc = QK::desc(base + L::Q_OFF);
  mbar_wait(bar_q, 0);

  for (int t = 0; t < tiles; ++t) {
    const int s = t % STAGES;
    mbar_wait(bar(s), (t / STAGES) & 1);
    float sc[KT / 2];  // S = Q K^T, 64 x 80
    const uint64_t k_desc = QK::desc(base + L::K_OFF + s * L::K_BYTES);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KD / 16; ++kk)
      wgmma_ss(sc, q_desc + kk * QK::K_STEP, k_desc + kk * QK::K_STEP, kk);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);
    if ((t + 1) * KT > n) mask_columns<KT / 8>(sc, t * KT, n);

    float x0 = -CUDART_INF_F, x1 = -CUDART_INF_F;
#pragma unroll
    for (int j = 0; j < KT / 8; ++j) {
      x0 = fmaxf(x0, fmaxf(sc[4 * j], sc[4 * j + 1]));
      x1 = fmaxf(x1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
    }
    const float n0 = fmaxf(m0, quad_max(x0) * c), n1 = fmaxf(m1, quad_max(x1) * c);  // finite
    const float corr0 = exp2_ftz(m0 - n0), corr1 = exp2_ftz(m1 - n1);  // 0 on the first tile
    m0 = n0;
    m1 = n1;
    float p0 = 0.f, p1 = 0.f;
#pragma unroll
    for (int j = 0; j < KT / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        sc[4 * j + e] = exp2_ftz(fmaf(sc[4 * j + e], c, -n0));  // 0 where masked
        sc[4 * j + 2 + e] = exp2_ftz(fmaf(sc[4 * j + 2 + e], c, -n1));
        p0 += sc[4 * j + e];
        p1 += sc[4 * j + 2 + e];
      }
    l0 = l0 * corr0 + p0;
    l1 = l1 * corr1 + p1;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      o[4 * j] *= corr0;
      o[4 * j + 1] *= corr0;
      o[4 * j + 2] *= corr1;
      o[4 * j + 3] *= corr1;
    }
    uint32_t pa[KT / 16][4];  // P in bf16 for P.V, as the TPU kernel casts it
    to_operand<KT / 16>(sc, pa);
    const uint64_t v_desc = V::desc(base + L::V_OFF + s * L::V_BYTES);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk) wgmma_rs_tb(o, pa[kk], v_desc + kk * V::MN_STEP);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
    __syncthreads();  // the warpgroup is done with stage s
    if (threadIdx.x == 0 && t + STAGES < tiles) load(t + STAGES);
  }

  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  store_rows<HD / 8>(o, 1.f / l0, 1.f / l1, nullptr, 0, smem + L::V_OFF,
                     out + (size_t)chunk * n * dim + (size_t)head * HD, dim, q0, n);
  constexpr int VECS = HD / 8;  // the v passthrough of this block's rows, 16 bytes a lane
  for (int e = threadIdx.x; e < QT * VECS; e += W_THREADS) {
    const int row = q0 + e / VECS, cc = (e % VECS) * 8;
    if (row < n)
      *reinterpret_cast<uint4*>(vout + ((size_t)chunk * n + row) * dim + (size_t)head * HD + cc) =
          *reinterpret_cast<const uint4*>(qkv + ((size_t)chunk * n + row) * total + col + 2 * KD +
                                          cc);
  }
}

// ------------------------------------------------------ f32, CUDA cores

constexpr int BQ = 32;              // query rows per block
constexpr int TPR = 4;              // lanes per query row
constexpr int BK = 32;              // key rows per shared-memory tile
constexpr int F_THREADS = BQ * TPR; // 128

template <int KD, int HD>
__global__ void __launch_bounds__(F_THREADS)
attention_f32_kernel(const float* __restrict__ qkv, float* __restrict__ out,
                     float* __restrict__ vout, int n, int heads, float scale) {
  static_assert(KD % TPR == 0 && HD % TPR == 0, "head widths must split over TPR lanes");
  constexpr int QD = KD / TPR;      // q/k columns per lane
  constexpr int VD = HD / TPR;      // v/out columns per lane
  constexpr int KV = KD + HD;       // k|v columns of one row, contiguous in qkv
  __shared__ __align__(16) float ks[BK][KD];
  __shared__ __align__(16) float vs[BK][HD];

  const int chunk = blockIdx.z;
  const int head = blockIdx.y;
  const int row = blockIdx.x * BQ + threadIdx.x / TPR;
  const int sub = threadIdx.x % TPR;
  const int stride = 2 * KD + HD;
  const int total = heads * stride;
  const int dim = heads * HD;
  const bool live = row < n;
  const float* base = qkv + (size_t)chunk * n * total + (size_t)head * stride;

  float q[QD];
#pragma unroll
  for (int d = 0; d < QD; ++d) q[d] = live ? base[(size_t)row * total + sub * QD + d] : 0.f;

  float acc[VD];
#pragma unroll
  for (int d = 0; d < VD; ++d) acc[d] = 0.f;
  float m = -CUDART_INF_F;  // running row max of the scaled scores
  float l = 0.f;            // running softmax denominator

  for (int k0 = 0; k0 < n; k0 += BK) {
    const int kn = min(BK, n - k0);
    __syncthreads();  // the previous tile has been read by every lane
    for (int e = threadIdx.x; e < BK * KV; e += F_THREADS) {
      const int r = e / KV, c = e % KV;
      // rows past the ragged edge are zero-filled, so p = 0 multiplies zeros
      const float val = r < kn ? base[(size_t)(k0 + r) * total + KD + c] : 0.f;
      if (c < KD) ks[r][c] = val; else vs[r][c - KD] = val;
    }
    __syncthreads();

    float s[BK];
    float tile_max = -CUDART_INF_F;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      float part = 0.f;
#pragma unroll
      for (int d = 0; d < QD; ++d) part += q[d] * ks[j][sub * QD + d];
      part += __shfl_xor_sync(FULL, part, 1);
      part += __shfl_xor_sync(FULL, part, 2);
      s[j] = j < kn ? part * scale : -CUDART_INF_F;
      tile_max = fmaxf(tile_max, s[j]);
    }
    const float m_new = fmaxf(m, tile_max);   // finite: kn >= 1
    const float corr = expf(m - m_new);       // exp(-inf) = 0 on the first tile
    l *= corr;
#pragma unroll
    for (int d = 0; d < VD; ++d) acc[d] *= corr;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      const float p = expf(s[j] - m_new);     // 0 past the ragged edge
      l += p;
#pragma unroll
      for (int d = 0; d < VD; ++d) acc[d] += p * vs[j][sub * VD + d];
    }
    m = m_new;
  }

  if (live) {
    const size_t orow = ((size_t)chunk * n + row) * dim + (size_t)head * HD + sub * VD;
    const float inv = 1.f / l;
    const float* vin = base + (size_t)row * total + 2 * KD + sub * VD;
#pragma unroll
    for (int d = 0; d < VD; ++d) {
      out[orow + d] = acc[d] * inv;
      vout[orow + d] = vin[d];
    }
  }
}

template <int KD, int HD>
int launch(int is_bf16, const void* qkv, void* out, void* v, int ba, int n, int heads,
           float scale, cudaStream_t stream) {
  if (is_bf16) {
    using L = FwdSmem<KD, HD>;
    // once a process: the kernel's shared memory is above the 48 KB default
    static const cudaError_t attr = cudaFuncSetAttribute(
        attention_bf16_kernel<KD, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(L::bytes));
    if (attr != cudaSuccess) return static_cast<int>(attr);
    const int total = heads * (2 * KD + HD);
    FwdMaps maps;
    if (!make_map(&maps.q, qkv, ba, n, total, KD, QT) ||
        !make_map(&maps.k, qkv, ba, n, total, KD, KT) ||
        !make_map(&maps.v, qkv, ba, n, total, HD, KT))
      return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid((n + QT - 1) / QT, heads, ba);
    attention_bf16_kernel<KD, HD><<<grid, W_THREADS, L::bytes, stream>>>(
        maps, static_cast<const bf16*>(qkv), static_cast<bf16*>(out), static_cast<bf16*>(v), n,
        heads, scale);
  } else {
    const dim3 grid((n + BQ - 1) / BQ, heads, ba);
    attention_f32_kernel<KD, HD><<<grid, F_THREADS, 0, stream>>>(
        static_cast<const float*>(qkv), static_cast<float*>(out), static_cast<float*>(v), n,
        heads, scale);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns 0 on a good launch, else the CUDA error code (cudaErrorInvalidValue
// for a pair not built here). (key_dim, head_dim) = (32, 64) is yolo11's
// PSAAttention at every scale (C2PSA heads are 64 channels wide, attn_ratio
// 0.5); (32, 32) is yolo12's AAttn at every scale (heads of 32 channels).
extern "C" int area_attention_fwd(const void* qkv, void* out, void* v, int ba, int n, int heads,
                                  int key_dim, int head_dim, float scale, int is_bf16,
                                  void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (key_dim == 32 && head_dim == 64)
    return launch<32, 64>(is_bf16, qkv, out, v, ba, n, heads, scale, s);
  if (key_dim == 32 && head_dim == 32)
    return launch<32, 32>(is_bf16, qkv, out, v, ba, n, heads, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

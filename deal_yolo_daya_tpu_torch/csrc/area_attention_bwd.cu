// Area-attention backward for Hopper (sm_90a), bound to Python through ctypes.
//
// Replaces the TPU kernel deal_yolo_daya_tpu/ops/pallas/area_attention.py::_bwd_kernel.
// For each (batch x area) chunk and head, with P = softmax(q k^T * scale)
// recomputed from qkv in f32:
//   dV = P^T dO + dvo          (P cast to the input dtype first)
//   dP = dO V^T
//   dS = P * (dP - D) * scale  with D = rowsum(dP * P), cast to the input dtype
//   dQ = dS K,  dK = dS^T Q    (f32 accumulators)
// written as d_qkv with the interleaved q|k|v columns of qkv.
//
// Layout: qkv and d_qkv (BA, n, heads*(2*KD+HD)); d_out (dO) and d_v (dvo)
// (BA, n, heads*HD); stats (3, BA, heads, n) f32 scratch for each query
// row's softmax max m, denominator l and D (in bf16, m is in log2 units).
//
// What bounds it: at the yolo11n train shape (BA=32, n=400, 2 heads, KD=32,
// HD=64, bf16) the function moves 19.7 MB (5.9 us of HBM time) and its five
// products are 4.6 GFLOP (4.7 us of bf16 tensor time), so the card's bound
// is the bytes. The TPU kernel kept a chunk's (n, n) f32 tiles in VMEM; on
// Hopper 400x400 f32 is 640 KB against 227 KB of shared memory a block, so
// this streams tiles in two passes and never writes an (n, n) tensor:
//   pass (a), one block per (chunk, head, 64 query rows): streams the K|V
//     tiles twice. The first sweep keeps m, l and D with online rescaling (D
//     is the TPU kernel's exact term rowsum(dP * P), not rowsum(dO * O)); the
//     second forms dS and accumulates dQ. It writes dq and (m, l, D).
//   pass (b), one block per (chunk, head, 64 key rows): streams Q|dO tiles,
//     with every query row's (m, 1/l, D) in shared memory, recomputes P^T
//     and dS^T, and accumulates dV = P^T dO and dK = dS^T Q. It writes dk
//     and dv + dvo.
// So S and dP are each computed three times: D needs every key of a row
// before the first dS, and one writer an output element (no f32 atomics for
// dQ) keeps the result deterministic.
//
// - bf16 (the amp train path): one warpgroup (128 threads) a block owns 64
//   rows. The streamed tiles are 80 rows (n = 400 is 5 tiles), copied by
//   thread 0 through TMA into a ring of 2 stages with one mbarrier each and
//   refilled as soon as the warpgroup is done with a stage; the block's own
//   64 rows of the narrow (KD) and wide (HD) operand come in by TMA once.
//   The 3-D maps (chunk, row, column) zero-fill rows past n. S and dP (or
//   S^T and dP^T) are wgmma m64nNk16 accumulators in registers, products of
//   two K-major shared tiles (64- and 128-byte swizzled rows); P and dS are
//   formed there and rounded to bf16 in registers, as the TPU kernel rounds
//   them, as the register A operand of dQ += dS K (wgmma m64n32k16), dV +=
//   P^T dO (m64n64k16) and dK += dS^T Q (m64n32k16), with the streamed tile
//   as the MN-major B operand. Pass (b) takes each query tile in two parts,
//   48 and 32 columns, so that its accumulators fit in 128 registers. The
//   epilogue adds dvo to dV in f32, rounds to bf16 and writes 16 bytes a
//   lane through a per-warp bf16 staging tile. Nothing is staged through
//   shared memory in f32.
//   Occupancy: at most 128 registers a thread and 44 KB (pass a) or 49 KB
//   (pass b, with the statistics of n = 400 rows) of shared memory give 4
//   blocks an SM, so each pass's 32 x 2 x 7 = 448 blocks run in one wave
//   (528 slots). With 3 stages and pass (b) in one part (168 registers) both
//   passes fit 3 blocks an SM and took a second wave: 0.0541 ms against
//   0.0397 ms for the two passes (NVIDIA H100 80GB HBM3, 700 W).
// - f32 (the reference precision): the dot products run on the f32 CUDA
//   cores; each row is owned by TPR neighbouring lanes that split its
//   columns and combine partial sums with two warp shuffles.
//
// - (key_dim, head_dim) = (32, 32), yolo12's AAttn: the same two passes built
//   for HD = 32. The wide tiles (V, dO) shrink to 64-byte rows, as wide as
//   the narrow ones (WIDE = NARROW = 5120 bytes), so both take the 64-byte
//   swizzle; dP = dO V^T reduces over 32 columns, dV is an m64n32k16
//   accumulator of 16 registers, and the epilogue writes 64-byte dq|dk|dv
//   rows. The stats layout is unchanged.
//
// Measured (profiler device time at the main shape, tools/time_attention_kernels.py
// and chip_smoke.py, NVIDIA H100 80GB HBM3 at a 700 W power limit):
// 0.0359-0.0365 ms (pass a 0.0171-0.0175, pass b 0.0188-0.0190), ~6x the
// 0.0059 ms bound, against 0.2456 ms for the earlier WMMA design and
// 0.0343-0.0353 ms for scaled_dot_product_attention's backward (cuDNN: it
// takes D = rowsum(dO * O) and converts an f32 dQ to bf16 apart, so it
// computes S, dP and the exponentials once). What holds this one back is
// the recomputation: three exponentials a score element, 34.4 M at this
// shape, are 8-9 us of the SFU at 16 a clock an SM, and the products with
// their 448 padded rows ~10 us of tensor time at the card's peak; each
// block runs them as one dependent chain, with only 4 blocks an SM to
// hide it.
// The launches allocate nothing and run on the caller's stream; the C entry
// returns cudaGetLastError() (or the error of a refused TMA map) so the
// Python wrapper can raise.

#include "hopper.cuh"

namespace {

using namespace hopper;

// ---------------------------------------------------- bf16, wgmma and TMA

constexpr int QT = 64;          // rows a block owns (one warpgroup)
constexpr int KT = 80;          // rows of a streamed tile
constexpr int STAGES = 2;       // streamed tiles in the ring
constexpr int W_THREADS = 128;  // one warpgroup
// shared memory a block may use: the bound on pass (b)'s per-row statistics
constexpr int SMEM_MAX = 227 * 1024;

// Dynamic shared memory of both passes, from its first 1024-byte boundary:
// the ring's wide (HD) and narrow (KD) tiles, the block's own narrow and
// wide rows, the barriers (the own rows', one a stage), then pass (b)'s
// per-query-row statistics (m, 1/l, D). Every tile starts on a 1024-byte
// boundary.
template <int KD, int HD>
struct BwdSmem {
  static constexpr int WIDE = KT * HD * 2, NARROW = KT * KD * 2;
  static constexpr int OWN_N = QT * KD * 2, OWN_W = QT * HD * 2;
  static constexpr int W_OFF = 0, N_OFF = STAGES * WIDE, ON_OFF = N_OFF + STAGES * NARROW;
  static constexpr int OW_OFF = ON_OFF + OWN_N, BAR_OFF = OW_OFF + OWN_W;
  static constexpr int STATS_OFF = BAR_OFF + 8 * (STAGES + 1);
  static_assert(WIDE % 1024 == 0 && NARROW % 1024 == 0 && OWN_N % 1024 == 0 &&
                    OWN_W % 1024 == 0, "tiles on 1024-byte boundaries");
  static_assert(staging_bytes<HD / 8>() <= STAGES * WIDE, "the epilogue stages in the ring");
  static size_t bytes(int stat_rows) { return STATS_OFF + 12 * (size_t)stat_rows + 1024; }
};

// TMA maps of one pass: the block's own rows (QT rows) and the streamed
// tiles (KT rows) of the narrow and the wide operand.
struct BwdMaps {
  CUtensorMap own_n, own_w, tile_n, tile_w;
};

// The ring of one pass: thread 0 issues, every thread waits.
template <int KD, int HD>
struct Ring {
  using L = BwdSmem<KD, HD>;
  const BwdMaps* maps;
  uint32_t base;
  int chunk, col_n, col_w, tiles;

  __device__ __forceinline__ uint32_t bar(int s) const { return base + L::BAR_OFF + 8 * (s + 1); }
  __device__ __forceinline__ uint32_t own_bar() const { return base + L::BAR_OFF; }
  // load i brings tile i % tiles into stage i % STAGES
  __device__ __forceinline__ void load(int i) const {
    const int s = i % STAGES, tile = i % tiles;
    mbar_expect_tx(bar(s), L::NARROW + L::WIDE);
    tma_load(base + L::N_OFF + s * L::NARROW, &maps->tile_n, bar(s), col_n, tile * KT, chunk);
    tma_load(base + L::W_OFF + s * L::WIDE, &maps->tile_w, bar(s), col_w, tile * KT, chunk);
  }
  // thread 0, after the barriers are initialised: the own rows and the
  // first STAGES of `loads` loads
  __device__ __forceinline__ void start(int own_n_col, int own_w_col, int row0, int loads) const {
    mbar_expect_tx(own_bar(), L::OWN_N + L::OWN_W);
    tma_load(base + L::ON_OFF, &maps->own_n, own_bar(), own_n_col, row0, chunk);
    tma_load(base + L::OW_OFF, &maps->own_w, own_bar(), own_w_col, row0, chunk);
    for (int i = 0; i < min(STAGES, loads); ++i) load(i);
  }
  __device__ __forceinline__ void wait(int i) const { mbar_wait(bar(i % STAGES), (i / STAGES) & 1); }
  // every thread, when the warpgroup is done with load i's stage
  __device__ __forceinline__ void release(int i, int loads) const {
    __syncthreads();
    if (threadIdx.x == 0 && i + STAGES < loads) load(i + STAGES);
  }
};

__device__ __forceinline__ void init_barriers(uint32_t first) {
  if (threadIdx.x == 0) {
    for (int i = 0; i <= STAGES; ++i) mbar_init(first + 8 * i, 1);
    mbar_fence_init();
  }
  __syncthreads();
}

// Issue acc_a (64 x NW) = A_a . B_a^T over KD, then acc_b (64 x NW) =
// A_b . B_b^T over HD, as two groups: the block's own narrow and wide rows
// against NW rows of the streamed narrow and wide tiles at (shared
// addresses) b_n and b_w. wgmma_wait<1>() then finds acc_a done while acc_b
// (the longer product) still runs.
template <int KD, int HD, int NW>
__device__ __forceinline__ void two_products(float (&acc_a)[NW / 2], float (&acc_b)[NW / 2],
                                             uint32_t base, uint32_t b_n, uint32_t b_w) {
  using L = BwdSmem<KD, HD>;
  using N = Tile<KD * 2>;
  using W = Tile<HD * 2>;
  const uint64_t an = N::desc(base + L::ON_OFF), bn = N::desc(b_n);
  const uint64_t aw = W::desc(base + L::OW_OFF), bw = W::desc(b_w);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < KD / 16; ++kk)
    wgmma_ss(acc_a, an + kk * N::K_STEP, bn + kk * N::K_STEP, kk);
  wgmma_commit();
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
    wgmma_ss(acc_b, aw + kk * W::K_STEP, bw + kk * W::K_STEP, kk);
  wgmma_commit();
}

// acc (64 x 32) += A (64 x 80, registers) . B (80 x 32, an MN-major narrow tile)
template <int KD>
__device__ __forceinline__ void narrow_product(float (&acc)[KD / 2], const uint32_t (&a)[KT / 16][4],
                                               uint64_t b) {
#pragma unroll
  for (int kk = 0; kk < KT / 16; ++kk)
    wgmma_rs_tb(acc, a[kk], b + kk * Tile<KD * 2>::MN_STEP);
}

// Pass (a): one block per (chunk, head, QT query rows).
template <int KD, int HD>
__global__ void __launch_bounds__(W_THREADS, 4)
bwd_query_rows_bf16(const __grid_constant__ BwdMaps maps, bf16* __restrict__ dqkv,
                    float* __restrict__ stats, int ba, int n, int heads, float scale) {
  static_assert(KD == 32 && (HD == 64 || HD == 32), "wgmma shapes instantiated here");
  using L = BwdSmem<KD, HD>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  const uint32_t base = smem_u32(smem);
  const int chunk = blockIdx.z, head = blockIdx.y, q0 = blockIdx.x * QT;
  const int stride = 2 * KD + HD, total = heads * stride;
  const int col = head * stride, tiles = (n + KT - 1) / KT, loads = 2 * tiles;
  const Ring<KD, HD> ring{&maps, base, chunk, col + KD, col + 2 * KD, tiles};
  init_barriers(ring.own_bar());
  if (threadIdx.x == 0) ring.start(col, head * HD, q0, loads);  // own rows: Q and dO

  const float c = scale * LOG2E;  // scores in log2 units
  float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F, l0 = 0.f, l1 = 0.f, d0 = 0.f, d1 = 0.f;
  mbar_wait(ring.own_bar(), 0);

  // sweep 1: m, l and D, online (this lane's parts of l and D, rescaled as
  // the row max grows)
  for (int i = 0; i < tiles; ++i) {
    ring.wait(i);
    const int s = i % STAGES;
    float sc[KT / 2], dp[KT / 2];
    two_products<KD, HD, KT>(sc, dp, base, base + L::N_OFF + s * L::NARROW,
                             base + L::W_OFF + s * L::WIDE);  // S = Q K^T, dP = dO V^T
    wgmma_wait<1>();
    fence_regs(sc);
    if ((i + 1) * KT > n) mask_columns<KT / 8>(sc, i * KT, n);
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
    float p0 = 0.f, p1 = 0.f, s0 = 0.f, s1 = 0.f;
#pragma unroll
    for (int j = 0; j < KT / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        sc[4 * j + e] = exp2_ftz(fmaf(sc[4 * j + e], c, -n0));  // 0 where masked
        sc[4 * j + 2 + e] = exp2_ftz(fmaf(sc[4 * j + 2 + e], c, -n1));
        p0 += sc[4 * j + e];
        p1 += sc[4 * j + 2 + e];
      }
    wgmma_wait<0>();
    fence_regs(dp);
#pragma unroll
    for (int j = 0; j < KT / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s0 += sc[4 * j + e] * dp[4 * j + e];
        s1 += sc[4 * j + 2 + e] * dp[4 * j + 2 + e];
      }
    l0 = l0 * corr0 + p0;
    l1 = l1 * corr1 + p1;
    d0 = d0 * corr0 + s0;
    d1 = d1 * corr1 + s1;
    ring.release(i, loads);
  }
  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  const float D0 = quad_sum(d0) / l0, D1 = quad_sum(d1) / l1;
  const float f0 = scale / l0, f1 = scale / l1;
  const int lane = threadIdx.x % 32, row0 = q0 + threadIdx.x / 32 * 16 + lane / 4;
  if (lane % 4 == 0) {
    const size_t at = ((size_t)chunk * heads + head) * n + row0, plane = (size_t)ba * heads * n;
    if (row0 < n) {
      stats[at] = m0;
      stats[plane + at] = l0;
      stats[2 * plane + at] = D0;
    }
    if (row0 + 8 < n) {
      stats[at + 8] = m1;
      stats[plane + at + 8] = l1;
      stats[2 * plane + at + 8] = D1;
    }
  }

  // sweep 2: dS, then dQ += dS K
  float dq[KD / 2];
#pragma unroll
  for (int i = 0; i < KD / 2; ++i) dq[i] = 0.f;
  for (int i = tiles; i < loads; ++i) {
    const int s = i % STAGES, k0 = (i - tiles) * KT;
    ring.wait(i);
    float sc[KT / 2], dp[KT / 2];
    two_products<KD, HD, KT>(sc, dp, base, base + L::N_OFF + s * L::NARROW,
                             base + L::W_OFF + s * L::WIDE);
    wgmma_wait<1>();
    fence_regs(sc);
    if (k0 + KT > n) mask_columns<KT / 8>(sc, k0, n);
#pragma unroll
    for (int j = 0; j < KT / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        sc[4 * j + e] = exp2_ftz(fmaf(sc[4 * j + e], c, -m0)) * f0;  // P * scale
        sc[4 * j + 2 + e] = exp2_ftz(fmaf(sc[4 * j + 2 + e], c, -m1)) * f1;
      }
    wgmma_wait<0>();
    fence_regs(dp);
#pragma unroll
    for (int j = 0; j < KT / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        sc[4 * j + e] *= dp[4 * j + e] - D0;
        sc[4 * j + 2 + e] *= dp[4 * j + 2 + e] - D1;
      }
    uint32_t da[KT / 16][4];  // dS in bf16, as the TPU kernel
    to_operand<KT / 16>(sc, da);
    wgmma_fence();
    narrow_product<KD>(dq, da, Tile<KD * 2>::desc(base + L::N_OFF + s * L::NARROW));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dq);
    ring.release(i, loads);
  }
  store_rows<KD / 8>(dq, 1.f, 1.f, nullptr, 0, smem + L::W_OFF,
                     dqkv + (size_t)chunk * n * total + col, total, q0, n);
}

// Pass (b), columns C0..C0+NW-1 of stage s's query tile (query rows
// q0 + C0..): S^T and dP^T; P^T, rounded to bf16, for dV += P^T dO, whose
// product runs while dS^T is formed; then dK += dS^T Q. A tile is done in
// two such parts (48 + 32 columns) so that a thread holds at most 128
// registers and 4 blocks fit on an SM.
template <int KD, int HD, int C0, int NW>
__device__ __forceinline__ void key_rows_part(float (&dk)[KD / 2], float (&dv)[HD / 2],
                                              uint32_t base, int s, int q0, const float* ms,
                                              const float* ils, const float* ds, float c,
                                              float scale) {
  using L = BwdSmem<KD, HD>;
  using N = Tile<KD * 2>;
  using W = Tile<HD * 2>;
  const uint32_t q_tile = base + L::N_OFF + s * L::NARROW + C0 * KD * 2;
  const uint32_t do_tile = base + L::W_OFF + s * L::WIDE + C0 * HD * 2;
  float st[NW / 2], dpt[NW / 2];
  two_products<KD, HD, NW>(st, dpt, base, q_tile, do_tile);  // S^T = K Q^T, dP^T = V dO^T
  wgmma_wait<1>();
  fence_regs(st);
  const int t = threadIdx.x % 4;
#pragma unroll
  for (int j = 0; j < NW / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int q = q0 + C0 + 8 * j + 2 * t + e;  // the query row of this column
      const float mq = ms[q], il = ils[q];
      st[4 * j + e] = exp2_ftz(fmaf(st[4 * j + e], c, -mq)) * il;
      st[4 * j + 2 + e] = exp2_ftz(fmaf(st[4 * j + 2 + e], c, -mq)) * il;
    }
  uint32_t pa[NW / 16][4], da[NW / 16][4];  // P^T and dS^T in bf16, as the TPU kernel
  to_operand<NW / 16>(st, pa);
  const uint64_t do_mn = W::desc(do_tile), q_mn = N::desc(q_tile);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < NW / 16; ++kk) wgmma_rs_tb(dv, pa[kk], do_mn + kk * W::MN_STEP);
  wgmma_commit();
  wgmma_wait<1>();  // dP^T is done; dV's product may still run
  fence_regs(dpt);
#pragma unroll
  for (int j = 0; j < NW / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float dq = ds[q0 + C0 + 8 * j + 2 * t + e];
      dpt[4 * j + e] = st[4 * j + e] * (dpt[4 * j + e] - dq) * scale;
      dpt[4 * j + 2 + e] = st[4 * j + 2 + e] * (dpt[4 * j + 2 + e] - dq) * scale;
    }
  to_operand<NW / 16>(dpt, da);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < NW / 16; ++kk) wgmma_rs_tb(dk, da[kk], q_mn + kk * N::MN_STEP);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(dv);
  fence_regs(dk);
}

// Pass (b): one block per (chunk, head, QT key rows).
template <int KD, int HD>
__global__ void __launch_bounds__(W_THREADS, 4)
bwd_key_rows_bf16(const __grid_constant__ BwdMaps maps, const bf16* __restrict__ dvo,
                  bf16* __restrict__ dqkv, const float* __restrict__ stats, int ba, int n,
                  int heads, float scale) {
  static_assert(KD == 32 && (HD == 64 || HD == 32) && KT == 48 + 32,
                "wgmma shapes instantiated here");
  using L = BwdSmem<KD, HD>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  const uint32_t base = smem_u32(smem);
  const int chunk = blockIdx.z, head = blockIdx.y, k0 = blockIdx.x * QT;
  const int stride = 2 * KD + HD, total = heads * stride, dim = heads * HD;
  const int col = head * stride, tiles = (n + KT - 1) / KT;
  const Ring<KD, HD> ring{&maps, base, chunk, col, head * HD, tiles};  // tiles: Q and dO
  init_barriers(ring.own_bar());
  if (threadIdx.x == 0) ring.start(col + KD, col + 2 * KD, k0, tiles);  // own rows: K and V

  // every query row's (m, 1/l, D); rows past n get m = +inf, so P = 0 there
  float* ms = reinterpret_cast<float*>(smem + L::STATS_OFF);
  float* ils = ms + tiles * KT;
  float* ds = ils + tiles * KT;
  const size_t srow = ((size_t)chunk * heads + head) * n, plane = (size_t)ba * heads * n;
  for (int q = threadIdx.x; q < tiles * KT; q += W_THREADS) {
    const bool live = q < n;
    ms[q] = live ? stats[srow + q] : CUDART_INF_F;
    ils[q] = live ? 1.f / stats[plane + srow + q] : 0.f;
    ds[q] = live ? stats[2 * plane + srow + q] : 0.f;
  }
  __syncthreads();

  const float c = scale * LOG2E;
  float dk[KD / 2], dv[HD / 2];
#pragma unroll
  for (int i = 0; i < KD / 2; ++i) dk[i] = 0.f;
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) dv[i] = 0.f;
  mbar_wait(ring.own_bar(), 0);

  for (int i = 0; i < tiles; ++i) {
    ring.wait(i);
    key_rows_part<KD, HD, 0, 48>(dk, dv, base, i % STAGES, i * KT, ms, ils, ds, c, scale);
    key_rows_part<KD, HD, 48, 32>(dk, dv, base, i % STAGES, i * KT, ms, ils, ds, c, scale);
    ring.release(i, tiles);
  }
  bf16* out = dqkv + (size_t)chunk * n * total + col;
  store_rows<KD / 8>(dk, 1.f, 1.f, nullptr, 0, smem + L::W_OFF, out + KD, total, k0, n);
  store_rows<HD / 8>(dv, 1.f, 1.f, dvo + (size_t)chunk * n * dim + (size_t)head * HD, dim,
                     smem + L::W_OFF, out + 2 * KD, total, k0, n);
}

// ------------------------------------------------------ f32, CUDA cores

constexpr int BR = 32;               // rows a block owns
constexpr int TPR = 4;               // lanes per row
constexpr int BT = 32;               // rows of each streamed tile
constexpr int F_THREADS = BR * TPR;  // 128

// sum over the TPR lanes that own a row
__device__ __forceinline__ float row_sum(float part) {
  part += __shfl_xor_sync(FULL, part, 1);
  return part + __shfl_xor_sync(FULL, part, 2);
}

// Pass (a), f32: one block per (chunk, head, BR query rows).
template <int KD, int HD>
__global__ void __launch_bounds__(F_THREADS)
bwd_query_rows_f32(const float* __restrict__ qkv, const float* __restrict__ dout,
                   float* __restrict__ dqkv, float* __restrict__ stats, int ba, int n,
                   int heads, float scale) {
  static_assert(KD % TPR == 0 && HD % TPR == 0, "head widths must split over TPR lanes");
  constexpr int QD = KD / TPR, VD = HD / TPR, KV = KD + HD;
  __shared__ __align__(16) float ks[BT][KD];
  __shared__ __align__(16) float vs[BT][HD];

  const int chunk = blockIdx.z, head = blockIdx.y;
  const int row = blockIdx.x * BR + threadIdx.x / TPR, sub = threadIdx.x % TPR;
  const int stride = 2 * KD + HD, total = heads * stride, dim = heads * HD;
  const bool live = row < n;
  const float* base = qkv + (size_t)chunk * n * total + (size_t)head * stride;

  float q[QD], o[VD], dq[QD];
#pragma unroll
  for (int d = 0; d < QD; ++d) {
    q[d] = live ? base[(size_t)row * total + sub * QD + d] : 0.f;
    dq[d] = 0.f;
  }
#pragma unroll
  for (int d = 0; d < VD; ++d)
    o[d] = live ? dout[((size_t)chunk * n + row) * dim + (size_t)head * HD + sub * VD + d] : 0.f;

  float m = -CUDART_INF_F, l = 0.f, dn = 0.f, d_row = 0.f, inv_l = 0.f;
  for (int sweep = 0; sweep < 2; ++sweep) {
    if (sweep == 1) {
      d_row = dn / l;
      inv_l = 1.f / l;
    }
    for (int k0 = 0; k0 < n; k0 += BT) {
      const int kn = min(BT, n - k0);
      __syncthreads();  // the previous tile has been read by every lane
      for (int e = threadIdx.x; e < BT * KV; e += F_THREADS) {
        const int r = e / KV, c = e % KV;
        const float val = r < kn ? base[(size_t)(k0 + r) * total + KD + c] : 0.f;
        if (c < KD) ks[r][c] = val; else vs[r][c - KD] = val;
      }
      __syncthreads();
      for (int j = 0; j < kn; ++j) {  // kn is the same for the whole block
        float sp = 0.f, dpp = 0.f;
#pragma unroll
        for (int d = 0; d < QD; ++d) sp += q[d] * ks[j][sub * QD + d];
#pragma unroll
        for (int d = 0; d < VD; ++d) dpp += o[d] * vs[j][sub * VD + d];
        const float s = row_sum(sp) * scale, dp = row_sum(dpp);
        if (sweep == 0) {
          const float m_new = fmaxf(m, s);
          const float corr = expf(m - m_new);  // 0 on the first key
          const float p = expf(s - m_new);
          l = l * corr + p;
          dn = dn * corr + p * dp;
          m = m_new;
        } else {
          const float p = expf(s - m) * inv_l;
          const float ds = p * (dp - d_row) * scale;
#pragma unroll
          for (int d = 0; d < QD; ++d) dq[d] += ds * ks[j][sub * QD + d];
        }
      }
    }
  }
  if (live) {
    float* out = dqkv + ((size_t)chunk * n + row) * total + (size_t)head * stride + sub * QD;
#pragma unroll
    for (int d = 0; d < QD; ++d) out[d] = dq[d];
    if (sub == 0) {
      const size_t at = ((size_t)chunk * heads + head) * n + row, plane = (size_t)ba * heads * n;
      stats[at] = m;
      stats[plane + at] = l;
      stats[2 * plane + at] = d_row;
    }
  }
}

// Pass (b), f32: one block per (chunk, head, BR key rows).
template <int KD, int HD>
__global__ void __launch_bounds__(F_THREADS)
bwd_key_rows_f32(const float* __restrict__ qkv, const float* __restrict__ dout,
                 const float* __restrict__ dvo, float* __restrict__ dqkv,
                 const float* __restrict__ stats, int ba, int n, int heads, float scale) {
  constexpr int QD = KD / TPR, VD = HD / TPR;
  __shared__ __align__(16) float qs[BT][KD];
  __shared__ __align__(16) float dos[BT][HD];
  __shared__ float ms[BT], ls[BT], dsum[BT];

  const int chunk = blockIdx.z, head = blockIdx.y;
  const int key = blockIdx.x * BR + threadIdx.x / TPR, sub = threadIdx.x % TPR;
  const int stride = 2 * KD + HD, total = heads * stride, dim = heads * HD;
  const bool live = key < n;
  const float* base = qkv + (size_t)chunk * n * total + (size_t)head * stride;
  const float* dbase = dout + (size_t)chunk * n * dim + (size_t)head * HD;
  const size_t srow = ((size_t)chunk * heads + head) * n, plane = (size_t)ba * heads * n;

  float k[QD], v[VD], dk[QD], dv[VD];
#pragma unroll
  for (int d = 0; d < QD; ++d) {
    k[d] = live ? base[(size_t)key * total + KD + sub * QD + d] : 0.f;
    dk[d] = 0.f;
  }
#pragma unroll
  for (int d = 0; d < VD; ++d) {
    v[d] = live ? base[(size_t)key * total + 2 * KD + sub * VD + d] : 0.f;
    dv[d] = 0.f;
  }

  for (int q0 = 0; q0 < n; q0 += BT) {
    const int qn = min(BT, n - q0);
    __syncthreads();
    for (int e = threadIdx.x; e < BT * KD; e += F_THREADS) {
      const int r = e / KD, c = e % KD;
      qs[r][c] = r < qn ? base[(size_t)(q0 + r) * total + c] : 0.f;
    }
    for (int e = threadIdx.x; e < BT * HD; e += F_THREADS) {
      const int r = e / HD, c = e % HD;
      dos[r][c] = r < qn ? dbase[(size_t)(q0 + r) * dim + c] : 0.f;
    }
    if (threadIdx.x < qn) {
      ms[threadIdx.x] = stats[srow + q0 + threadIdx.x];
      ls[threadIdx.x] = stats[plane + srow + q0 + threadIdx.x];
      dsum[threadIdx.x] = stats[2 * plane + srow + q0 + threadIdx.x];
    }
    __syncthreads();
    for (int i = 0; i < qn; ++i) {  // qn is the same for the whole block
      float sp = 0.f, dpp = 0.f;
#pragma unroll
      for (int d = 0; d < QD; ++d) sp += k[d] * qs[i][sub * QD + d];
#pragma unroll
      for (int d = 0; d < VD; ++d) dpp += v[d] * dos[i][sub * VD + d];
      const float s = row_sum(sp) * scale, dp = row_sum(dpp);
      const float p = expf(s - ms[i]) / ls[i];
      const float ds = p * (dp - dsum[i]) * scale;
#pragma unroll
      for (int d = 0; d < VD; ++d) dv[d] += p * dos[i][sub * VD + d];
#pragma unroll
      for (int d = 0; d < QD; ++d) dk[d] += ds * qs[i][sub * QD + d];
    }
  }
  if (live) {
    float* out = dqkv + ((size_t)chunk * n + key) * total + (size_t)head * stride;
    const float* extra = dvo + ((size_t)chunk * n + key) * dim + (size_t)head * HD + sub * VD;
#pragma unroll
    for (int d = 0; d < QD; ++d) out[KD + sub * QD + d] = dk[d];
#pragma unroll
    for (int d = 0; d < VD; ++d) out[2 * KD + sub * VD + d] = dv[d] + extra[d];
  }
}

template <int KD, int HD>
int launch(int is_bf16, const void* qkv, const void* dout, const void* dvo, void* dqkv,
           float* stats, int ba, int n, int heads, float scale, cudaStream_t stream) {
  const dim3 grid((n + (is_bf16 ? QT : BR) - 1) / (is_bf16 ? QT : BR), heads, ba);
  if (is_bf16) {
    using L = BwdSmem<KD, HD>;
    const int stat_rows = (n + KT - 1) / KT * KT;
    const size_t smem_a = L::bytes(0), smem_b = L::bytes(stat_rows);
    if (smem_b > SMEM_MAX) return static_cast<int>(cudaErrorInvalidValue);
    // once a process: both passes may use up to SMEM_MAX bytes
    static const cudaError_t attr = [] {
      const cudaError_t a = cudaFuncSetAttribute(
          bwd_query_rows_bf16<KD, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
      return a != cudaSuccess ? a
                              : cudaFuncSetAttribute(bwd_key_rows_bf16<KD, HD>,
                                                     cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                     SMEM_MAX);
    }();
    if (attr != cudaSuccess) return static_cast<int>(attr);
    const int total = heads * (2 * KD + HD), dim = heads * HD;
    BwdMaps a, b;  // pass (a): own Q and dO, tiles K and V; pass (b): own K and V, tiles Q and dO
    if (!make_map(&a.own_n, qkv, ba, n, total, KD, QT) ||
        !make_map(&a.own_w, dout, ba, n, dim, HD, QT) ||
        !make_map(&a.tile_n, qkv, ba, n, total, KD, KT) ||
        !make_map(&a.tile_w, qkv, ba, n, total, HD, KT) ||
        !make_map(&b.own_w, qkv, ba, n, total, HD, QT) ||
        !make_map(&b.tile_w, dout, ba, n, dim, HD, KT))
      return static_cast<int>(cudaErrorInvalidValue);
    b.own_n = a.own_n;
    b.tile_n = a.tile_n;
    bwd_query_rows_bf16<KD, HD><<<grid, W_THREADS, smem_a, stream>>>(
        a, static_cast<bf16*>(dqkv), stats, ba, n, heads, scale);
    bwd_key_rows_bf16<KD, HD><<<grid, W_THREADS, smem_b, stream>>>(
        b, static_cast<const bf16*>(dvo), static_cast<bf16*>(dqkv), stats, ba, n, heads, scale);
  } else {
    bwd_query_rows_f32<KD, HD><<<grid, F_THREADS, 0, stream>>>(
        static_cast<const float*>(qkv), static_cast<const float*>(dout),
        static_cast<float*>(dqkv), stats, ba, n, heads, scale);
    bwd_key_rows_f32<KD, HD><<<grid, F_THREADS, 0, stream>>>(
        static_cast<const float*>(qkv), static_cast<const float*>(dout),
        static_cast<const float*>(dvo), static_cast<float*>(dqkv), stats, ba, n, heads, scale);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns 0 on good launches, else the CUDA error code (cudaErrorInvalidValue
// for a pair not built here). (key_dim, head_dim) = (32, 64) is yolo11's
// PSAAttention at every scale, (32, 32) yolo12's AAttn.
extern "C" int area_attention_bwd(const void* qkv, const void* d_out, const void* d_v,
                                  void* d_qkv, void* stats, int ba, int n, int heads,
                                  int key_dim, int head_dim, float scale, int is_bf16,
                                  void* stream) {
  float* st = static_cast<float*>(stats);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (key_dim == 32 && head_dim == 64)
    return launch<32, 64>(is_bf16, qkv, d_out, d_v, d_qkv, st, ba, n, heads, scale, s);
  if (key_dim == 32 && head_dim == 32)
    return launch<32, 32>(is_bf16, qkv, d_out, d_v, d_qkv, st, ba, n, heads, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

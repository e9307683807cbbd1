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
// row's softmax max m, denominator l and D.
//
// What bounds it: at the yolo11n train shape (BA=32, n=400, 2 heads, KD=32,
// HD=64, bf16) the function moves 19.7 MB (6 us of HBM time) and its five
// products are 4.6 GFLOP (5 us of bf16 tensor time), so the card's bound is
// the bytes. The TPU kernel kept a chunk's (n, n) f32 tiles in VMEM; on
// Hopper 400x400 f32 is 640 KB against 227 KB of shared memory per block,
// so this streams tiles through shared memory in two passes and never
// writes an (n, n) tensor:
//   pass (a), one block per (chunk, head, 64 query rows): streams K|V tiles
//     twice. The first sweep keeps m, l and D with online rescaling (D is
//     the TPU kernel's exact term rowsum(dP * P), not rowsum(dO * O)); the
//     second forms dS and accumulates dQ. It writes dq and (m, l, D).
//   pass (b), one block per (chunk, head, 64 key rows): streams Q|dO tiles
//     with their rows' (m, l, D), recomputes P and dS, and accumulates
//     dV = P^T dO and dK = dS^T Q. It writes dk and dv + dvo.
// No atomics: every output element has one writer, so the result is
// deterministic.
//
// - bf16 (the amp train path): four warps a block, each owning 16 rows. The
//   products run on the tensor cores through WMMA 16x16x16 bf16 tiles with
//   f32 accumulators; P and dS are rounded to bf16 before their products,
//   as the TPU kernel rounds them. Scores and dP go through shared memory in
//   f32 where two lanes a row do the softmax arithmetic.
// - f32 (the reference precision): the dot products run on the f32 CUDA
//   cores; each row is owned by TPR neighbouring lanes that split its
//   columns and combine partial sums with two warp shuffles.
//
// wgmma and TMA come later. The launches allocate nothing and run on the
// caller's stream; the C entry returns cudaGetLastError() so the Python
// wrapper can raise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <mma.h>

namespace {

using namespace nvcuda;

constexpr unsigned FULL = 0xffffffffu;

// ---------------------------------------------------------------- bf16, WMMA

constexpr int TR = 64;           // rows a block owns (16 per warp)
constexpr int TC = 64;           // rows of each streamed tile
constexpr int W_THREADS = 128;   // 4 warps
constexpr int T = 16;            // WMMA tile edge
constexpr int SC = TC / 2;       // columns per lane in the softmax arithmetic (two lanes a row)
// Shared-memory rows are padded by 16 bytes, so the 8 rows a WMMA load or
// store touches at once fall in 8 different bank groups.
constexpr int PAD16 = 8;         // bf16 elements
constexpr int PAD32 = 4;         // f32 elements

using bf16 = __nv_bfloat16;

// Copy `rows` rows of `cols` bf16 (a multiple of 8) from a row-major global
// source with row stride `ld` into shared memory with row stride cols +
// PAD16; rows past `valid` are zeros.
template <int ROWS_, int COLS>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, size_t ld, int valid) {
  constexpr int VECS = COLS / 8;
  for (int e = threadIdx.x; e < ROWS_ * VECS; e += W_THREADS) {
    const int r = e / VECS, c = (e % VECS) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r < valid) val = *reinterpret_cast<const uint4*>(src + (size_t)r * ld + c);
    *reinterpret_cast<uint4*>(dst + r * (COLS + PAD16) + c) = val;
  }
}

// Dynamic shared memory of both bf16 passes (row strides padded): f32 first,
// per warp two 16 x TC tiles (scores and dP, or their transposes) and 3 x TC
// row statistics; then bf16: the block's own 64 rows of the narrow (KD) and
// wide (HD) operand, one streamed tile of each, and per warp two 16 x TC
// tiles (P and dS, rounded to bf16).
template <int KD, int HD>
struct Smem {
  static constexpr int LS = TC + PAD32;                         // f32 row stride
  static constexpr int LN = KD + PAD16, LW = HD + PAD16, LP = TC + PAD16;
  static constexpr int SS = 4 * T * LS, RS = 3 * TC;
  static constexpr int NS = TR * LN, WS = TR * LW, PS = 4 * T * LP;
  static constexpr size_t bytes =
      (2 * SS + RS) * sizeof(float) + (2 * NS + 2 * WS + 2 * PS) * sizeof(bf16);
};

// One warp's 16 x TC tile (transposes of) A.B^T for A = 16 rows in
// fragments (KSTEPS of 16 columns) and B = TC rows of a shared tile with
// row stride ldb; stored as f32 with row stride LS.
template <int KSTEPS, int LS>
__device__ __forceinline__ void rows_times_tile_t(
    float* dst, const wmma::fragment<wmma::matrix_a, T, T, T, bf16, wmma::row_major>* a,
    const bf16* tile, int ldb) {
#pragma unroll
  for (int nt = 0; nt < TC / T; ++nt) {
    wmma::fragment<wmma::accumulator, T, T, T, float> acc;
    wmma::fill_fragment(acc, 0.f);
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      wmma::fragment<wmma::matrix_b, T, T, T, bf16, wmma::col_major> b;
      wmma::load_matrix_sync(b, tile + nt * T * ldb + kk * T, ldb);
      wmma::mma_sync(acc, a[kk], b, acc);
    }
    wmma::store_matrix_sync(dst + nt * T, acc, LS, wmma::mem_row_major);
  }
}

// acc[nt] += A (16 x TC bf16 in shared memory, stride lda) . B (TC x NT*16
// rows of a shared tile, stride ldb)
template <int NT>
__device__ __forceinline__ void accumulate_product(
    wmma::fragment<wmma::accumulator, T, T, T, float>* acc, const bf16* a, int lda,
    const bf16* b, int ldb) {
#pragma unroll
  for (int kk = 0; kk < TC / T; ++kk) {
    wmma::fragment<wmma::matrix_a, T, T, T, bf16, wmma::row_major> fa;
    wmma::load_matrix_sync(fa, a + kk * T, lda);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      wmma::fragment<wmma::matrix_b, T, T, T, bf16, wmma::row_major> fb;
      wmma::load_matrix_sync(fb, b + kk * T * ldb + nt * T, ldb);
      wmma::mma_sync(acc[nt], fa, fb, acc[nt]);
    }
  }
}

// Write one warp's 16 x COLS f32 accumulators as bf16 rows of `dst` (row
// stride ld), adding `extra` (bf16, row stride ld_extra) when given. `stage`
// is the warp's 16 x LS f32 scratch.
template <int COLS, int LS>
__device__ __forceinline__ void write_rows(
    bf16* dst, size_t ld, const bf16* extra, size_t ld_extra,
    wmma::fragment<wmma::accumulator, T, T, T, float>* acc, float* stage, int row0, int n,
    int lane) {
#pragma unroll
  for (int nt = 0; nt < COLS / T; ++nt)
    wmma::store_matrix_sync(stage + nt * T, acc[nt], LS, wmma::mem_row_major);
  __syncwarp();
  for (int e = lane; e < T * COLS; e += 32) {
    const int r = e / COLS, c = e % COLS, row = row0 + r;
    if (row < n) {
      float val = stage[r * LS + c];
      if (extra) val += __bfloat162float(extra[(size_t)row * ld_extra + c]);
      dst[(size_t)row * ld + c] = __float2bfloat16(val);
    }
  }
  __syncwarp();
}

// Pass (a): one block per (chunk, head, TR query rows).
template <int KD, int HD>
__global__ void __launch_bounds__(W_THREADS)
bwd_query_rows_bf16(const bf16* __restrict__ qkv, const bf16* __restrict__ dout,
                    bf16* __restrict__ dqkv, float* __restrict__ stats, int ba, int n,
                    int heads, float scale) {
  using L = Smem<KD, HD>;
  extern __shared__ __align__(128) unsigned char smem[];
  float* ss = reinterpret_cast<float*>(smem);
  float* dps = ss + L::SS;
  bf16* qs = reinterpret_cast<bf16*>(dps + L::SS + L::RS);
  bf16* dos = qs + L::NS;
  bf16* ks = dos + L::WS;
  bf16* vs = ks + L::NS;
  bf16* dss = vs + L::WS;

  const int chunk = blockIdx.z, head = blockIdx.y, q0 = blockIdx.x * TR;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int stride = 2 * KD + HD, total = heads * stride, dim = heads * HD;
  const bf16* base = qkv + (size_t)chunk * n * total + (size_t)head * stride;
  const bf16* dbase = dout + (size_t)chunk * n * dim + (size_t)head * HD;
  float* s_w = ss + warp * T * L::LS;
  float* dp_w = dps + warp * T * L::LS;
  bf16* ds_w = dss + warp * T * L::LP;

  load_tile<TR, KD>(qs, base + (size_t)q0 * total, total, n - q0);
  load_tile<TR, HD>(dos, dbase + (size_t)q0 * dim, dim, n - q0);
  __syncthreads();
  wmma::fragment<wmma::matrix_a, T, T, T, bf16, wmma::row_major> qa[KD / T], doa[HD / T];
#pragma unroll
  for (int kk = 0; kk < KD / T; ++kk)
    wmma::load_matrix_sync(qa[kk], qs + warp * T * L::LN + kk * T, L::LN);
#pragma unroll
  for (int kk = 0; kk < HD / T; ++kk)
    wmma::load_matrix_sync(doa[kk], dos + warp * T * L::LW + kk * T, L::LW);

  // two lanes a row; columns are visited in an order rotated by lane so
  // that the 32 lanes hit 32 different banks
  const int r = lane / 2, half = lane % 2;
  float m = -CUDART_INF_F, l = 0.f, dn = 0.f;

  // sweep 1: m, l and D (online, rescaled as the max grows)
  for (int k0 = 0; k0 < n; k0 += TC) {
    const int kn = min(TC, n - k0);
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile<TC, KD>(ks, base + (size_t)k0 * total + KD, total, kn);
    load_tile<TC, HD>(vs, base + (size_t)k0 * total + 2 * KD, total, kn);
    __syncthreads();
    rows_times_tile_t<KD / T, L::LS>(s_w, qa, ks, L::LN);   // S  = Q K^T
    rows_times_tile_t<HD / T, L::LS>(dp_w, doa, vs, L::LW); // dP = dO V^T
    __syncwarp();
    float tmax = -CUDART_INF_F;
#pragma unroll
    for (int c = 0; c < SC; ++c) {
      const int col = half * SC + ((c + lane) & (SC - 1));
      tmax = fmaxf(tmax, col < kn ? s_w[r * L::LS + col] * scale : -CUDART_INF_F);
    }
    tmax = fmaxf(tmax, __shfl_xor_sync(FULL, tmax, 1));
    const float m_new = fmaxf(m, tmax);     // finite: kn >= 1
    const float corr = __expf(m - m_new);   // 0 on the first tile
    float psum = 0.f, dsum = 0.f;
#pragma unroll
    for (int c = 0; c < SC; ++c) {
      const int col = half * SC + ((c + lane) & (SC - 1));
      if (col < kn) {
        const float p = __expf(s_w[r * L::LS + col] * scale - m_new);
        psum += p;
        dsum += p * dp_w[r * L::LS + col];
      }
    }
    psum += __shfl_xor_sync(FULL, psum, 1);
    dsum += __shfl_xor_sync(FULL, dsum, 1);
    l = l * corr + psum;
    dn = dn * corr + dsum;
    m = m_new;
  }
  const float d_row = dn / l;
  const int row = q0 + warp * T + r;
  if (half == 0 && row < n) {
    const size_t at = ((size_t)chunk * heads + head) * n + row, plane = (size_t)ba * heads * n;
    stats[at] = m;
    stats[plane + at] = l;
    stats[2 * plane + at] = d_row;
  }

  // sweep 2: dS, then dQ += dS K
  wmma::fragment<wmma::accumulator, T, T, T, float> dq[KD / T];
#pragma unroll
  for (int nt = 0; nt < KD / T; ++nt) wmma::fill_fragment(dq[nt], 0.f);
  const float inv_l = 1.f / l;
  for (int k0 = 0; k0 < n; k0 += TC) {
    const int kn = min(TC, n - k0);
    __syncthreads();
    load_tile<TC, KD>(ks, base + (size_t)k0 * total + KD, total, kn);
    load_tile<TC, HD>(vs, base + (size_t)k0 * total + 2 * KD, total, kn);
    __syncthreads();
    rows_times_tile_t<KD / T, L::LS>(s_w, qa, ks, L::LN);
    rows_times_tile_t<HD / T, L::LS>(dp_w, doa, vs, L::LW);
    __syncwarp();
#pragma unroll
    for (int c = 0; c < SC; ++c) {
      const int col = half * SC + ((c + lane) & (SC - 1));
      float ds = 0.f;
      if (col < kn) {
        const float p = __expf(s_w[r * L::LS + col] * scale - m) * inv_l;
        ds = p * (dp_w[r * L::LS + col] - d_row) * scale;
      }
      ds_w[r * L::LP + col] = __float2bfloat16(ds);  // dS in bf16, as the TPU kernel
    }
    __syncwarp();
    accumulate_product<KD / T>(dq, ds_w, L::LP, ks, L::LN);
  }
  write_rows<KD, L::LS>(dqkv + (size_t)chunk * n * total + (size_t)head * stride, total,
                        nullptr, 0, dq, s_w, q0 + warp * T, n, lane);
}

// Pass (b): one block per (chunk, head, TR key rows).
template <int KD, int HD>
__global__ void __launch_bounds__(W_THREADS)
bwd_key_rows_bf16(const bf16* __restrict__ qkv, const bf16* __restrict__ dout,
                  const bf16* __restrict__ dvo, bf16* __restrict__ dqkv,
                  const float* __restrict__ stats, int ba, int n, int heads, float scale) {
  using L = Smem<KD, HD>;
  extern __shared__ __align__(128) unsigned char smem[];
  float* sts = reinterpret_cast<float*>(smem);
  float* dpts = sts + L::SS;
  float* ms = dpts + L::SS;
  float* ls = ms + TC;
  float* dsum = ls + TC;
  bf16* ks = reinterpret_cast<bf16*>(ms + L::RS);
  bf16* vs = ks + L::NS;
  bf16* qs = vs + L::WS;
  bf16* dos = qs + L::NS;
  bf16* pts = dos + L::WS;
  bf16* dsts = pts + L::PS;

  const int chunk = blockIdx.z, head = blockIdx.y, k0 = blockIdx.x * TR;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int stride = 2 * KD + HD, total = heads * stride, dim = heads * HD;
  const bf16* base = qkv + (size_t)chunk * n * total + (size_t)head * stride;
  const bf16* dbase = dout + (size_t)chunk * n * dim + (size_t)head * HD;
  const size_t srow = ((size_t)chunk * heads + head) * n, plane = (size_t)ba * heads * n;
  float* st_w = sts + warp * T * L::LS;    // S^T  for this warp's 16 key rows
  float* dpt_w = dpts + warp * T * L::LS;  // dP^T
  bf16* pt_w = pts + warp * T * L::LP;
  bf16* dst_w = dsts + warp * T * L::LP;

  load_tile<TR, KD>(ks, base + (size_t)k0 * total + KD, total, n - k0);
  load_tile<TR, HD>(vs, base + (size_t)k0 * total + 2 * KD, total, n - k0);
  __syncthreads();
  wmma::fragment<wmma::matrix_a, T, T, T, bf16, wmma::row_major> ka[KD / T], va[HD / T];
#pragma unroll
  for (int kk = 0; kk < KD / T; ++kk)
    wmma::load_matrix_sync(ka[kk], ks + warp * T * L::LN + kk * T, L::LN);
#pragma unroll
  for (int kk = 0; kk < HD / T; ++kk)
    wmma::load_matrix_sync(va[kk], vs + warp * T * L::LW + kk * T, L::LW);
  wmma::fragment<wmma::accumulator, T, T, T, float> dk[KD / T], dv[HD / T];
#pragma unroll
  for (int nt = 0; nt < KD / T; ++nt) wmma::fill_fragment(dk[nt], 0.f);
#pragma unroll
  for (int nt = 0; nt < HD / T; ++nt) wmma::fill_fragment(dv[nt], 0.f);

  const int r = lane / 2, half = lane % 2;
  for (int q0 = 0; q0 < n; q0 += TC) {
    const int qn = min(TC, n - q0);
    __syncthreads();  // every warp is done with the previous Q/dO tile
    load_tile<TC, KD>(qs, base + (size_t)q0 * total, total, qn);
    load_tile<TC, HD>(dos, dbase + (size_t)q0 * dim, dim, qn);
    for (int i = threadIdx.x; i < TC; i += W_THREADS) {
      const bool live = i < qn;
      ms[i] = live ? stats[srow + q0 + i] : 0.f;
      ls[i] = live ? stats[plane + srow + q0 + i] : 1.f;
      dsum[i] = live ? stats[2 * plane + srow + q0 + i] : 0.f;
    }
    __syncthreads();
    rows_times_tile_t<KD / T, L::LS>(st_w, ka, qs, L::LN);   // S^T  = K Q^T
    rows_times_tile_t<HD / T, L::LS>(dpt_w, va, dos, L::LW); // dP^T = V dO^T
    __syncwarp();
#pragma unroll
    for (int c = 0; c < SC; ++c) {
      const int col = half * SC + ((c + lane) & (SC - 1));  // a query row of the tile
      float p = 0.f, ds = 0.f;
      if (col < qn) {
        p = __expf(st_w[r * L::LS + col] * scale - ms[col]) / ls[col];
        ds = p * (dpt_w[r * L::LS + col] - dsum[col]) * scale;
      }
      pt_w[r * L::LP + col] = __float2bfloat16(p);    // P in bf16 for dV, as the TPU kernel
      dst_w[r * L::LP + col] = __float2bfloat16(ds);  // dS in bf16
    }
    __syncwarp();
    accumulate_product<HD / T>(dv, pt_w, L::LP, dos, L::LW);  // dV += P^T dO
    accumulate_product<KD / T>(dk, dst_w, L::LP, qs, L::LN);  // dK += dS^T Q
  }
  bf16* out = dqkv + (size_t)chunk * n * total + (size_t)head * stride;
  write_rows<KD, L::LS>(out + KD, total, nullptr, 0, dk, st_w, k0 + warp * T, n, lane);
  write_rows<HD, L::LS>(out + 2 * KD, total, dvo + (size_t)chunk * n * dim + (size_t)head * HD,
                        dim, dv, dpt_w, k0 + warp * T, n, lane);
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
void launch(int is_bf16, const void* qkv, const void* dout, const void* dvo, void* dqkv,
            float* stats, int ba, int n, int heads, float scale, cudaStream_t stream) {
  if (is_bf16) {
    const dim3 grid((n + TR - 1) / TR, heads, ba);
    constexpr size_t smem = Smem<KD, HD>::bytes;
    cudaFuncSetAttribute(bwd_query_rows_bf16<KD, HD>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    cudaFuncSetAttribute(bwd_key_rows_bf16<KD, HD>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    bwd_query_rows_bf16<KD, HD><<<grid, W_THREADS, smem, stream>>>(
        static_cast<const bf16*>(qkv), static_cast<const bf16*>(dout),
        static_cast<bf16*>(dqkv), stats, ba, n, heads, scale);
    bwd_key_rows_bf16<KD, HD><<<grid, W_THREADS, smem, stream>>>(
        static_cast<const bf16*>(qkv), static_cast<const bf16*>(dout),
        static_cast<const bf16*>(dvo), static_cast<bf16*>(dqkv), stats, ba, n, heads, scale);
  } else {
    const dim3 grid((n + BR - 1) / BR, heads, ba);
    bwd_query_rows_f32<KD, HD><<<grid, F_THREADS, 0, stream>>>(
        static_cast<const float*>(qkv), static_cast<const float*>(dout),
        static_cast<float*>(dqkv), stats, ba, n, heads, scale);
    bwd_key_rows_f32<KD, HD><<<grid, F_THREADS, 0, stream>>>(
        static_cast<const float*>(qkv), static_cast<const float*>(dout),
        static_cast<const float*>(dvo), static_cast<float*>(dqkv), stats, ba, n, heads, scale);
  }
}

}  // namespace

// Returns 0 on good launches, else the CUDA error code. key_dim 32 and
// head_dim 64 are yolo11's PSAAttention at every scale.
extern "C" int area_attention_bwd(const void* qkv, const void* d_out, const void* d_v,
                                  void* d_qkv, void* stats, int ba, int n, int heads,
                                  int key_dim, int head_dim, float scale, int is_bf16,
                                  void* stream) {
  if (key_dim != 32 || head_dim != 64) return static_cast<int>(cudaErrorInvalidValue);
  launch<32, 64>(is_bf16, qkv, d_out, d_v, d_qkv, static_cast<float*>(stats), ba, n, heads,
                 scale, static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

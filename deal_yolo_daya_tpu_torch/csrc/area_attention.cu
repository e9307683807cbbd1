// Area-attention forward for Hopper (sm_90a), bound to Python through ctypes.
//
// Replaces the TPU kernel deal_yolo_daya_tpu/ops/pallas/area_attention.py::_kernel.
// For each (batch x area) chunk and head: out = softmax(q k^T * key_dim^-1/2) v,
// with f32 scores and an f32 accumulator, plus the contiguous per-head-concat
// copy of v that the positional-encoding conv reads.
//
// Layout: qkv (BA, n, heads*(2*KD+HD)), per head interleaved q|k|v columns;
// out and v are (BA, n, heads*HD).
//
// What bounds it: at the yolo11n shape (BA=32, n=400, 2 heads, KD=32, HD=64)
// the function moves ~13 MB (a few microseconds of HBM time) and does ~2
// GFLOP, so the card's bound is the bytes. The TPU kernel kept a chunk's whole
// (n, n) score tile in VMEM; on Hopper 400x400 f32 is 640 KB against 227 KB
// of shared memory per block, so both kernels here stream key/value tiles
// through shared memory with an online softmax (flash-attention style): the
// (n, n) scores never reach device memory, and rows past the ragged edge
// (n = 400 is not a multiple of the tile) are zero-filled and masked.
//
// - bf16 (the predict path): attention_bf16_kernel. One block of 4 warps owns
//   64 query rows of one (chunk, head); each warp owns 16 rows. Q.K^T and P.V
//   run on the tensor cores through WMMA 16x16x16 bf16 tiles with f32
//   accumulators. Each warp stores its 16 x 64 score tile to shared memory,
//   two lanes per row run the online softmax on it in f32 and write P back
//   as bf16 (as the TPU kernel casts P to the input dtype before P.V), the
//   warp's f32 output rows in shared memory are rescaled, and P.V is
//   accumulated onto them by the tensor cores.
// - f32 (the reference precision): attention_f32_kernel runs the dot products
//   on the f32 CUDA cores, exact in f32; each query row is owned by TPR
//   neighbouring lanes that split the columns and combine q.k partial sums
//   with two warp shuffles.
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

constexpr int WQ = 64;             // query rows per block (16 per warp)
constexpr int WK = 64;             // key rows per shared-memory tile
constexpr int W_THREADS = 128;     // 4 warps
constexpr int T = 16;              // WMMA tile edge
// Shared-memory rows are padded by 16 bytes, so the 8 rows a WMMA load or
// store touches at once fall in 8 different bank groups.
constexpr int PAD16 = 8;           // bf16 elements
constexpr int PAD32 = 4;           // f32 elements

// Copy `rows` rows of `cols` bf16 (a multiple of 8) from a row-major global
// source with row stride `ld` into shared memory with row stride cols +
// PAD16; rows past `valid` are zeros.
template <int ROWS_, int COLS>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          size_t ld, int valid) {
  constexpr int VECS = COLS / 8;
  for (int e = threadIdx.x; e < ROWS_ * VECS; e += W_THREADS) {
    const int r = e / VECS, c = (e % VECS) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r < valid) val = *reinterpret_cast<const uint4*>(src + (size_t)r * ld + c);
    *reinterpret_cast<uint4*>(dst + r * (COLS + PAD16) + c) = val;
  }
}

// Dynamic shared memory of the bf16 kernel (row strides padded), f32 arrays
// first: per warp a 16 x WK score tile, a 16 x HD output accumulator and
// 2 x 16 row factors; then bf16: one K and one V tile, per warp a 16 x WK P
// tile. The block's Q tile is staged in the P tiles' space before the first
// P is written.
template <int KD, int HD>
struct Bf16Smem {
  static constexpr int LS = WK + PAD32, LO = HD + PAD32;       // f32 row strides
  static constexpr int LQ = KD + PAD16, LV = HD + PAD16, LP = WK + PAD16;
  static constexpr int SS = 4 * T * LS, OS = 4 * T * LO, RS = 4 * 2 * T;
  static constexpr int KS = WK * LQ, VS = WK * LV, PS = 4 * T * LP;
  static_assert(WQ * LQ <= PS, "the Q tile fits in the P tiles");
  static constexpr size_t bytes =
      (SS + OS + RS) * sizeof(float) + (KS + VS + PS) * sizeof(__nv_bfloat16);
};

template <int KD, int HD>
__global__ void __launch_bounds__(W_THREADS)
attention_bf16_kernel(const __nv_bfloat16* __restrict__ qkv, __nv_bfloat16* __restrict__ out,
                      __nv_bfloat16* __restrict__ vout, int n, int heads, float scale) {
  static_assert(KD % T == 0 && HD % T == 0 && WK == 64, "WMMA tiles, 32 score columns a lane");
  using L = Bf16Smem<KD, HD>;
  constexpr int SC = WK / 2;        // score columns per lane (two lanes a row)
  extern __shared__ __align__(128) unsigned char smem[];
  float* ss = reinterpret_cast<float*>(smem);
  float* os = ss + L::SS;
  float* rs = os + L::OS;
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(rs + L::RS);
  __nv_bfloat16* vs = ks + L::KS;
  __nv_bfloat16* ps = vs + L::VS;
  __nv_bfloat16* qs = ps;  // until the loop's first barrier

  const int chunk = blockIdx.z, head = blockIdx.y, q0 = blockIdx.x * WQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int stride = 2 * KD + HD, total = heads * stride, dim = heads * HD;
  const __nv_bfloat16* base = qkv + (size_t)chunk * n * total + (size_t)head * stride;
  float* s_w = ss + warp * T * L::LS;          // this warp's scores
  float* o_w = os + warp * T * L::LO;          // this warp's unnormalised output rows
  float* corr_w = rs + warp * 2 * T;           // per row: rescale of this tile
  float* l_w = corr_w + T;                     // per row: softmax denominator
  __nv_bfloat16* p_w = ps + warp * T * L::LP;  // this warp's P tile

  load_tile<WQ, KD>(qs, base + (size_t)q0 * total, total, n - q0);
  for (int e = lane; e < T * HD; e += 32) o_w[(e / HD) * L::LO + e % HD] = 0.f;
  __syncthreads();
  wmma::fragment<wmma::matrix_a, T, T, T, __nv_bfloat16, wmma::row_major> qa[KD / T];
#pragma unroll
  for (int kk = 0; kk < KD / T; ++kk)
    wmma::load_matrix_sync(qa[kk], qs + warp * T * L::LQ + kk * T, L::LQ);

  // the online softmax runs two lanes a row; columns are visited in an order
  // rotated by lane so that the 32 lanes hit 32 different banks
  const int r = lane / 2, half = lane % 2;
  float m = -CUDART_INF_F, l = 0.f;

  for (int k0 = 0; k0 < n; k0 += WK) {
    const int kn = min(WK, n - k0);
    __syncthreads();  // every warp is done with the previous K/V tile (and with qs)
    load_tile<WK, KD>(ks, base + (size_t)k0 * total + KD, total, kn);
    load_tile<WK, HD>(vs, base + (size_t)k0 * total + 2 * KD, total, kn);
    __syncthreads();

    // S = Q K^T for this warp's 16 rows: (16 x KD) x (KD x WK)
#pragma unroll
    for (int nt = 0; nt < WK / T; ++nt) {
      wmma::fragment<wmma::accumulator, T, T, T, float> acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int kk = 0; kk < KD / T; ++kk) {
        wmma::fragment<wmma::matrix_b, T, T, T, __nv_bfloat16, wmma::col_major> kb;
        wmma::load_matrix_sync(kb, ks + nt * T * L::LQ + kk * T, L::LQ);
        wmma::mma_sync(acc, qa[kk], kb, acc);
      }
      wmma::store_matrix_sync(s_w + nt * T, acc, L::LS, wmma::mem_row_major);
    }
    __syncwarp();

    float tmax = -CUDART_INF_F;
#pragma unroll
    for (int c = 0; c < SC; ++c) {
      const int col = half * SC + ((c + lane) & (SC - 1));
      tmax = fmaxf(tmax, col < kn ? s_w[r * L::LS + col] * scale : -CUDART_INF_F);
    }
    tmax = fmaxf(tmax, __shfl_xor_sync(FULL, tmax, 1));
    const float m_new = fmaxf(m, tmax);      // finite: kn >= 1
    const float corr = __expf(m - m_new);    // 0 on the first tile
    float psum = 0.f;
#pragma unroll
    for (int c = 0; c < SC; ++c) {
      const int col = half * SC + ((c + lane) & (SC - 1));
      const float p = col < kn ? __expf(s_w[r * L::LS + col] * scale - m_new) : 0.f;
      psum += p;
      p_w[r * L::LP + col] = __float2bfloat16(p);  // P in bf16 for P.V, as the TPU kernel
    }
    psum += __shfl_xor_sync(FULL, psum, 1);
    l = l * corr + psum;
    m = m_new;
    if (half == 0) corr_w[r] = corr;
    __syncwarp();
    for (int e = lane; e < T * HD; e += 32) o_w[(e / HD) * L::LO + e % HD] *= corr_w[e / HD];
    __syncwarp();

    // O += P V for this warp's 16 rows: (16 x WK) x (WK x HD)
#pragma unroll
    for (int nt = 0; nt < HD / T; ++nt) {
      wmma::fragment<wmma::accumulator, T, T, T, float> acc;
      wmma::load_matrix_sync(acc, o_w + nt * T, L::LO, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < WK / T; ++kk) {
        wmma::fragment<wmma::matrix_a, T, T, T, __nv_bfloat16, wmma::row_major> pa;
        wmma::fragment<wmma::matrix_b, T, T, T, __nv_bfloat16, wmma::row_major> vb;
        wmma::load_matrix_sync(pa, p_w + kk * T, L::LP);
        wmma::load_matrix_sync(vb, vs + kk * T * L::LV + nt * T, L::LV);
        wmma::mma_sync(acc, pa, vb, acc);
      }
      wmma::store_matrix_sync(o_w + nt * T, acc, L::LO, wmma::mem_row_major);
    }
    __syncwarp();
  }

  if (half == 0) l_w[r] = l;
  __syncwarp();
  const int row0 = q0 + warp * T;
  for (int e = lane; e < T * HD; e += 32) {
    const int row = row0 + e / HD;
    if (row < n)
      out[((size_t)chunk * n + row) * dim + (size_t)head * HD + e % HD] =
          __float2bfloat16(o_w[(e / HD) * L::LO + e % HD] / l_w[e / HD]);
  }
  constexpr int VECS = HD / 8;  // the v passthrough, 16 bytes a lane
  for (int e = lane; e < T * VECS; e += 32) {
    const int row = row0 + e / VECS, c = (e % VECS) * 8;
    if (row < n)
      *reinterpret_cast<uint4*>(vout + ((size_t)chunk * n + row) * dim + (size_t)head * HD + c) =
          *reinterpret_cast<const uint4*>(base + (size_t)row * total + 2 * KD + c);
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
void launch(int is_bf16, const void* qkv, void* out, void* v, int ba, int n, int heads,
            float scale, cudaStream_t stream) {
  if (is_bf16) {
    const dim3 grid((n + WQ - 1) / WQ, heads, ba);
    constexpr size_t smem = Bf16Smem<KD, HD>::bytes;
    cudaFuncSetAttribute(attention_bf16_kernel<KD, HD>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    attention_bf16_kernel<KD, HD><<<grid, W_THREADS, smem, stream>>>(
        static_cast<const __nv_bfloat16*>(qkv), static_cast<__nv_bfloat16*>(out),
        static_cast<__nv_bfloat16*>(v), n, heads, scale);
  } else {
    const dim3 grid((n + BQ - 1) / BQ, heads, ba);
    attention_f32_kernel<KD, HD><<<grid, F_THREADS, 0, stream>>>(
        static_cast<const float*>(qkv), static_cast<float*>(out), static_cast<float*>(v), n,
        heads, scale);
  }
}

}  // namespace

// Returns 0 on a good launch, else the CUDA error code. key_dim 32 and
// head_dim 64 are yolo11's PSAAttention at every scale (C2PSA heads are 64
// channels wide, attn_ratio 0.5).
extern "C" int area_attention_fwd(const void* qkv, void* out, void* v, int ba, int n, int heads,
                                  int key_dim, int head_dim, float scale, int is_bf16,
                                  void* stream) {
  if (key_dim != 32 || head_dim != 64) return static_cast<int>(cudaErrorInvalidValue);
  launch<32, 64>(is_bf16, qkv, out, v, ba, n, heads, scale, static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

// w8a8 convolution for Hopper (sm_90a), bound to Python through ctypes.
//
// The counterpart of deal_yolo_daya_tpu/models/quant.py::_int8_conv_call, which
// the JAX package hands to XLA as an int8 lax.conv_general_dilated (there is no
// pallas_call behind it). For an NHWC activation x (bf16 or f32), int8 weights
// w (Cout rows of K = kh*kw*Cin values in (ky, kx, ci) order, OHWI, each row
// zero-padded to Kp, a multiple of 32) and per-output-channel f32 scales it
// computes
//
//     xq  = clamp(rint(x * inv_a), -127, 127)             (int8, half to even)
//     acc = conv(xq, w), stride s, padding kh/2, groups 1  (s32, exact)
//     y   = T(float(acc) * scale[co])                      (NHWC, x's type)
//
// with inv_a = 1 / a_scale and scale = w_scale * a_scale computed once on the
// host in f32. The product x * inv_a is one rounded f32 multiply (never a
// division) and the rounding is __float2int_rn, as jnp.round and torch.round
// round. The s32 sums are exact in any order, so acc and y equal the plain
// version (ops/kernels/int8_conv.py::int8_conv_plain) bit for bit. The folded
// BN bias and the SiLU stay outside, as the JAX BatchNorm adds the bias after
// the conv.
//
// Mapping: an implicit GEMM, M = B*Ho*Wo output pixels, N = Cout, K = Kp. A
// block of 128 threads (4 warps) computes a 128 x 64 output tile; warp w takes
// rows 32w..32w+31 and all 64 columns as 2 x 8 tiles of
// mma.sync.m16n8k32.row.col.s32.s8.s8.s32, with the 64 s32 accumulators in
// registers. Each 32-deep step, thread r gathers row r of the A tile: its 32
// activations (im2col on the fly, zeros outside the image and past K), by
// 16-byte loads of 8 channels when Cin % 8 == 0 and the base is 16-byte
// aligned, else one value at a time (the stem's Cin 3); quantizes them in
// registers; and stores 32 bytes to shared memory. The B tile is 64 rows of 32
// weight bytes, one 16-byte load a thread. Rows are 48 bytes apart in shared
// memory, so the fragment loads (4 bytes a thread, rows g = lane / 4 apart)
// and the 16-byte stores hit 32 distinct banks. The next step's loads are
// issued before this step's products.
//
// What bounds it on an H100: at yolo11n's shapes (b32, 640) each conv moves
// its bf16 input once and writes its bf16 output (~25-105 MB), for 0.2-8
// GOP: bytes, at 3.35 TB/s, by a wide margin over the 1,979 TOP/s of the int8
// tensor cores. This simple design rereads each activation kh*kw times
// (from L2), quantizes it again each time, and uses mma.sync instead of
// wgmma; wgmma's s8 path, TMA, a quantized activation kept in int8 by the
// producer and the bias and SiLU fused into the epilogue are later work.
//
// The launch allocates nothing. The C entry returns cudaGetLastError() so the
// Python wrapper can raise.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 128;       // output pixels a block
constexpr int BN = 64;        // output channels a block
constexpr int BK = 32;        // K a step (one mma deep)
constexpr int THREADS = 128;  // 4 warps
constexpr int ROW = 48;       // shared-memory bytes between tile rows (32 + 16 pad)

struct Params {
  const void* x;        // (B, H, W, C) NHWC, T
  const int8_t* w;      // (N, Kp) int8
  const float* scale;   // (N,) f32
  void* y;              // (M, N) T
  int32_t* acc;         // (M, N) s32, or null
  long long m;          // B * Ho * Wo
  int h, w_in, c, ho, wo, n, kh, kw, stride, pad, k, kp;
  float inv_a;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ int quantize(float v, float inv_a) {
  const int q = __float2int_rn(__fmul_rn(v, inv_a));
  return max(-127, min(127, q));
}

__device__ __forceinline__ uint32_t pack4(int a, int b, int c, int d) {
  return (static_cast<uint32_t>(a) & 0xffu) | ((static_cast<uint32_t>(b) & 0xffu) << 8) |
         ((static_cast<uint32_t>(c) & 0xffu) << 16) | (static_cast<uint32_t>(d) << 24);
}

// 8 consecutive values from a 16-byte aligned address (a bf16 is the high
// half of its f32)
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* v) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t words[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(words[i] << 16);
    v[2 * i + 1] = __uint_as_float(words[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void load8(const float* p, float* v) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void mma_s8(int32_t* d, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The quantized A row of thread `row` for K step k0: 32 int8 as 8 words.
template <typename T, bool VEC>
__device__ __forceinline__ void fetch_a(const Params& p, const T* xb, bool row_ok, int iy0,
                                        int ix0, int k0, uint32_t* qa) {
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    float v[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = 0.0f;
    if (VEC) {  // 8 channels of one tap (Cin % 8 == 0, so K % 8 == 0)
      const int k = k0 + 8 * g;
      if (row_ok && k < p.k) {
        const int tap = k / p.c;
        const int ci = k - tap * p.c;
        const int ky = tap / p.kw;
        const int iy = iy0 + ky, ix = ix0 + tap - ky * p.kw;
        if (iy >= 0 && iy < p.h && ix >= 0 && ix < p.w_in)
          load8(xb + (static_cast<long long>(iy) * p.w_in + ix) * p.c + ci, v);
      }
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int k = k0 + 8 * g + i;
        if (row_ok && k < p.k) {
          const int tap = k / p.c;
          const int ci = k - tap * p.c;
          const int ky = tap / p.kw;
          const int iy = iy0 + ky, ix = ix0 + tap - ky * p.kw;
          if (iy >= 0 && iy < p.h && ix >= 0 && ix < p.w_in)
            v[i] = to_f32(xb[(static_cast<long long>(iy) * p.w_in + ix) * p.c + ci]);
        }
      }
    }
    qa[2 * g] = pack4(quantize(v[0], p.inv_a), quantize(v[1], p.inv_a),
                      quantize(v[2], p.inv_a), quantize(v[3], p.inv_a));
    qa[2 * g + 1] = pack4(quantize(v[4], p.inv_a), quantize(v[5], p.inv_a),
                          quantize(v[6], p.inv_a), quantize(v[7], p.inv_a));
  }
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(THREADS) int8_conv_kernel(const Params p) {
  __shared__ __align__(16) uint8_t sa[BM * ROW];
  __shared__ __align__(16) uint8_t sb[BN * ROW];

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const long long m0 = static_cast<long long>(blockIdx.x) * BM;
  const int n0 = blockIdx.y * BN;

  // this thread's A row: output pixel m0 + tid
  const long long m = m0 + tid;
  const bool row_ok = m < p.m;
  const long long mm = row_ok ? m : 0;
  const int ox = static_cast<int>(mm % p.wo);
  const int oy = static_cast<int>((mm / p.wo) % p.ho);
  const long long b = mm / (static_cast<long long>(p.wo) * p.ho);
  const T* xb = static_cast<const T*>(p.x) + b * p.h * p.w_in * p.c;
  const int iy0 = oy * p.stride - p.pad, ix0 = ox * p.stride - p.pad;

  // this thread's 16 bytes of the B tile: weight row n0 + tid / 2, half tid % 2
  const int bn = tid >> 1, bhalf = tid & 1;
  const bool brow_ok = n0 + bn < p.n;
  const int8_t* wrow = p.w + static_cast<long long>(brow_ok ? n0 + bn : 0) * p.kp + bhalf * 16;

  int32_t acc[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

  // column tiles of this block that hold output channels (warp-uniform)
  const int n_tiles = min(8, (p.n - n0 + 7) / 8);

  uint32_t qa[8];
  uint4 qb;
  fetch_a<T, VEC>(p, xb, row_ok, iy0, ix0, 0, qa);
  qb = brow_ok ? *reinterpret_cast<const uint4*>(wrow) : make_uint4(0, 0, 0, 0);

  const int steps = p.kp / BK;
  for (int s = 0; s < steps; ++s) {
    uint4* arow = reinterpret_cast<uint4*>(sa + tid * ROW);
    arow[0] = make_uint4(qa[0], qa[1], qa[2], qa[3]);
    arow[1] = make_uint4(qa[4], qa[5], qa[6], qa[7]);
    *reinterpret_cast<uint4*>(sb + bn * ROW + bhalf * 16) = qb;
    __syncthreads();
    if (s + 1 < steps) {  // the next step's loads, in flight under this step's products
      fetch_a<T, VEC>(p, xb, row_ok, iy0, ix0, (s + 1) * BK, qa);
      qb = brow_ok ? *reinterpret_cast<const uint4*>(wrow + (s + 1) * BK)
                   : make_uint4(0, 0, 0, 0);
    }
    uint32_t af[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const uint8_t* r0 = sa + (warp * 32 + i * 16 + g) * ROW + t * 4;
      af[i][0] = *reinterpret_cast<const uint32_t*>(r0);
      af[i][1] = *reinterpret_cast<const uint32_t*>(r0 + 8 * ROW);
      af[i][2] = *reinterpret_cast<const uint32_t*>(r0 + 16);
      af[i][3] = *reinterpret_cast<const uint32_t*>(r0 + 8 * ROW + 16);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (j < n_tiles) {
        const uint8_t* c0 = sb + (j * 8 + g) * ROW + t * 4;
        const uint32_t bf[2] = {*reinterpret_cast<const uint32_t*>(c0),
                                *reinterpret_cast<const uint32_t*>(c0 + 16)};
        mma_s8(acc[0][j], af[0], bf);
        mma_s8(acc[1][j], af[1], bf);
      }
    }
    __syncthreads();
  }

  // epilogue: acc (row g or g + 8, columns 2t and 2t + 1 of each tile)
  T* y = static_cast<T*>(p.y);
  const bool pairs = (p.n & 1) == 0;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const long long row = m0 + warp * 32 + i * 16 + g + half * 8;
      if (row >= p.m) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = n0 + j * 8 + 2 * t;
        if (col >= p.n) continue;
        const int32_t a0 = acc[i][j][2 * half], a1 = acc[i][j][2 * half + 1];
        const long long off = row * p.n + col;
        const float v0 = __fmul_rn(__int2float_rn(a0), p.scale[col]);
        if (pairs) {  // col + 1 < n, and off is even
          store_pair(y + off, v0, __fmul_rn(__int2float_rn(a1), p.scale[col + 1]));
          if (p.acc) *reinterpret_cast<int2*>(p.acc + off) = make_int2(a0, a1);
        } else {
          store_out(y + off, v0);
          if (p.acc) p.acc[off] = a0;
          if (col + 1 < p.n) {
            store_out(y + off + 1, __fmul_rn(__int2float_rn(a1), p.scale[col + 1]));
            if (p.acc) p.acc[off + 1] = a1;
          }
        }
      }
    }
  }
}

template <typename T>
int launch(const Params& p, bool vec, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((p.m + BM - 1) / BM), (p.n + BN - 1) / BN);
  if (vec)
    int8_conv_kernel<T, true><<<grid, THREADS, 0, stream>>>(p);
  else
    int8_conv_kernel<T, false><<<grid, THREADS, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: (b, h, w, c) NHWC, bf16 (is_bf16) or f32; w: (n, kp) int8; scale: (n,) f32;
// y: (b, ho, wo, n) in x's type; acc: (b, ho, wo, n) s32 or null.
extern "C" int int8_conv(const void* x, int is_bf16, int b, int h, int w_in, int c,
                         const void* w, int n, int kh, int kw, int stride, int kp, float inv_a,
                         const void* scale, void* y, void* acc, int ho, int wo, void* stream) {
  const int k = kh * kw * c;
  if (b <= 0 || h <= 0 || w_in <= 0 || c <= 0 || n <= 0 || kh <= 0 || kw <= 0 || stride <= 0 ||
      kp % BK != 0 || kp < k || ho <= 0 || wo <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long m = static_cast<long long>(b) * ho * wo;
  if ((m + BM - 1) / BM > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  Params p{x, static_cast<const int8_t*>(w), static_cast<const float*>(scale), y,
           static_cast<int32_t*>(acc), m, h, w_in, c, ho, wo, n, kh, kw, stride, kh / 2, k, kp,
           inv_a};
  const bool vec = c % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<__nv_bfloat16>(p, vec, s) : launch<float>(p, vec, s);
}

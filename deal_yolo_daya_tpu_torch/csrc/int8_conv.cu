// w8a8 ConvBN for Hopper (sm_90a), bound to Python through ctypes: the s8
// convolution of a BN-folded ConvBN with its bias and SiLU in the epilogue.
//
// The counterpart of deal_yolo_daya_tpu/models/quant.py::_int8_conv_call
// (:64), which the JAX package hands to XLA as an int8
// lax.conv_general_dilated (there is no pallas_call behind it), followed by
// the ConvBN's folded bias and SiLU. For an NHWC activation x (bf16 or f32;
// T = its type), int8 weights w (Cout rows of K = kh*kw*Cin values in
// (ky, kx, ci) order, OHWI, each row zero-padded to Kp, a multiple of 32),
// per-output-channel f32 scales and a T bias it computes
//
//     xq  = clamp(rint(f32(x) * inv_a), -127, 127)        int8, half to even
//     acc = conv(xq, w), stride s, padding kh/2, groups 1  s32, exact
//     y   = T(f32(acc) * scale[co])
//     z   = T(f32(y) + f32(bias[co]))
//     out = act ? T(z / (1 + expf(-z))) : z               f32 arithmetic, IEEE division
//
// with inv_a = 1 / a_scale and scale = w_scale * a_scale computed once on the
// host in f32. Every step rounds where the plain version (int8_conv_bn_plain:
// int8_conv_plain, `+ bias`, F.silu) rounds: one f32 multiply (never a
// division) and __float2int_rn for the quantizer, __fmul_rn / __fadd_rn /
// __fdiv_rn and the accurate expf in the epilogue (never __expf, no fast
// math). The s32 sums are exact in any order, so acc equals the plain
// version bit for bit, and on the card so does out.
//
// What bounds it on an H100: at yolo11n's shapes (b32, 640) a conv moves its
// bf16 input once and writes its bf16 output (13-184 MB), for 0.2-15 GOP:
// bytes, at 3.35 TB/s, by a wide margin over the 1,979 TOP/s of the int8
// tensor cores. So the design reads each activation from HBM once, keeps
// the reads in flight while the block computes, and leaves nothing to a
// later pass. The design before this one (mma.sync m16n8k32, one 64-column
// tile a block, each thread gathering its A row) reread every activation
// kh*kw times from L2, quantized it again each time and once more for every
// 64-wide column tile, and left the bias and SiLU to two more passes over
// the output. Here (s8_conv_wgmma_kernel, Cin % 16 == 0):
//
// - Each block keeps one N tile NT of the weights resident in shared memory
//   (NT the whole Cout: the smallest of 16, 32, 64, 128, 256 that holds it,
//   halved where Kp x NT does not fit beside the tiles), loaded once by
//   cp.async, with its scale and bias; it is persistent over the M tiles.
//   So each output pixel's activations are loaded and quantized once a conv
//   (and a halo pixel once a tile), not once per 64 channels.
// - An M tile is 8 x 8 outputs of one image (64 consecutive pixels for 1x1
//   stride 1). Its halo, (7s + k)^2 input pixels, comes by TMA (route
//   "tma"): one box of cb channels x (7s + k) columns x (7s + k) rows of the
//   NHWC input per cb channels (cb the largest of 256, 128, 64, 32, 16 that
//   divides Cin), dense rows, no element strides: stride 2 is a box twice as
//   wide, and its phases are split when the halo is quantized. TMA's
//   out-of-bounds zero fill is the padding (rint(0 * inv_a) = 0) and the
//   ragged edge. Thread 0 keeps the next tiles' halos in flight in a ring of
//   2 stages (1 where a second stage would cost the SM a block, or does not
//   fit: 9 of yolo11n's 74 convs), each on its own mbarrier, and refills a
//   stage as soon as its halo is quantized, so the loads run under the
//   products and epilogues. The tensor map is encoded on the host (kept in
//   a small cache by base, shape and box, since eager calls meet the same
//   buffers again) and passed as a __grid_constant__ parameter, so a
//   captured CUDA graph keeps it: right because a graph's buffers keep their
//   addresses.
// - All threads quantize the stage's halo once (one f32 multiply, rint,
//   clamp) into an A tile of 16-channel int8 planes; within a plane a halo
//   pixel (hy, hx) sits at ((hy * s + hx % s) * whs + hx / s) * 16, the
//   columns split by phase, so that for every tap the 8 outputs of a tile
//   row are 8 consecutive 16-byte rows: a K-major core matrix of wgmma
//   without swizzle. A per-block item table holds each item's place in the
//   stage and in the A tile, so the quantizer does no index arithmetic. Two
//   A tiles alternate: the next tile's halo is quantized while this tile's
//   products run. A channel slice of a wider NHWC tensor (the split of a
//   C2f/C3k2) is read in place through its pixel stride.
// - Each 32-deep K step is one wgmma.mma_async.m64nNk32.s32.s8.s8 from
//   shared memory, N = NT / w where w warpgroups split the N tile (4 for NT
//   >= 64, NT / 16 below: more warps to quantize and for the epilogue, at
//   64 registers a thread where N <= 32), the s32 accumulator in
//   registers. A step's two 16-byte K columns (tap, 16
//   channels) are addressed by a per-block table: the A descriptor starts
//   at the lower of the two columns with LBO their distance (SBO one output
//   row), B's columns stored in the same order, so any Cin % 16 == 0 (48 or
//   80 with a 3x3 kernel too) and any stride take the same product; the
//   steps run back to back under one commit.
// - The epilogue applies scale, bias and SiLU (act is an argument: 3 of
//   yolo11n's 74 quantized ConvBNs have none) to the accumulator in
//   registers and writes pairs of channels (4 bytes in bf16) of each row;
//   8-column groups past Cout are skipped.
// - Route "direct", the same kernel for inputs TMA cannot take (a base or
//   pixel stride off 16 bytes, a ring that does not fit beside the weights:
//   5 of yolo11n's convs): each thread loads its halo items itself (16-byte
//   loads, 2 items in flight, or element loads) and quantizes them in
//   registers. At yolo11n's shapes the TMA route is 1.5% faster over the
//   convs both take (PERF.md, section 6): the kernel is bound by the
//   epilogue's instructions, not by how the halo arrives.
// - The exact SiLU (expf, IEEE division) is about a sixth of the time.
// - The wrapper (ops/kernels/int8_conv.py::plan) picks the route and lays
//   out shared memory; the launch only checks that plan against the device.
// - The stem (Cin 3) and other Cin that are no multiple of 16 (TMA needs
//   16-byte rows), and convs whose tiles do not fit in shared memory, take
//   s8_conv_narrow_kernel: the earlier mma.sync design (quantize on load)
//   with the same fused epilogue; the stem's 3 channels and 3x3 taps are
//   compile-time there, with a 16-column tile.
//
// Launches run on the caller's stream and allocate nothing; each C entry
// returns cudaGetLastError() (or cudaErrorInvalidValue for a shape it
// refuses) so that the Python wrapper can raise.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <initializer_list>
#include <mutex>

#include "hopper.cuh"

namespace {

using namespace hopper;

// ------------------------------------------------------------ shared helpers

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
// v rounded to T, as f32
__device__ __forceinline__ float as_t(float v, const float*) { return v; }
__device__ __forceinline__ float as_t(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(v));
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

// The epilogue of one accumulator: y, z and out as the plain version rounds
// them (T's rounding after each step).
template <typename T>
__device__ __forceinline__ float epilogue(int32_t a, float scale, float bias, int act) {
  const T* tag = nullptr;
  const float y = as_t(__fmul_rn(__int2float_rn(a), scale), tag);
  const float z = as_t(__fadd_rn(y, bias), tag);
  return act ? as_t(__fdiv_rn(z, __fadd_rn(1.0f, expf(-z))), tag) : z;
}

// Where the output goes: (M, n) rows of T, and the s32 sums when acc is set.
struct Out {
  const float* scale;  // (n,) f32
  const void* bias;    // (n,) T
  void* y;             // (M, n) T
  int32_t* acc;        // (M, n) s32, or null
  int n, act;
};

// Output row `row`, channels col and col + 1 (col even; col < n): their
// epilogue values v0, v1 and s32 sums a0, a1.
template <typename T>
__device__ __forceinline__ void write_pair(const Out& o, long long row, int col, float v0, float v1,
                                           int32_t a0, int32_t a1) {
  T* y = static_cast<T*>(o.y);
  const long long off = row * o.n + col;
  if ((o.n & 1) == 0) {  // col + 1 < n, and off is even
    store_pair(y + off, v0, v1);
    if (o.acc) *reinterpret_cast<int2*>(o.acc + off) = make_int2(a0, a1);
  } else {
    store_out(y + off, v0);
    if (o.acc) o.acc[off] = a0;
    if (col + 1 < o.n) {
      store_out(y + off + 1, v1);
      if (o.acc) o.acc[off + 1] = a1;
    }
  }
}

// ------------------------------------------------------ wgmma s8

// The products: D(64 x N) (+)= A(64 x 32) . B(32 x N), s8 x s8 -> s32, A and B
// K-major in shared memory, one overload a width N (N/2 registers a thread);
// D is overwritten where `accumulate` is 0.
// D(64 x 16) += A(64 x 32) . B(32 x 16), s8 x s8 -> s32
__device__ __forceinline__ void wgmma_s8(int32_t (&d)[8], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7])
      : "l"(a), "l"(b), "r"(accumulate));
}

// D(64 x 32) += A(64 x 32) . B(32 x 32), s8 x s8 -> s32
__device__ __forceinline__ void wgmma_s8(int32_t (&d)[16], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
      : "l"(a), "l"(b), "r"(accumulate));
}

// D(64 x 64) += A(64 x 32) . B(32 x 64), s8 x s8 -> s32
__device__ __forceinline__ void wgmma_s8(int32_t (&d)[32], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// ------------------------------------------------------ the wgmma conv

constexpr int BM = 64;          // output pixels a tile: one m64 row tile
constexpr int WG = 128;         // threads of a warpgroup

// Warpgroups a block: up to four split the N tile, 16 columns or more
// each, so that more warps quantize the halo and run the epilogue on the
// same shared memory (the kernel waits on latency, not on issue, with few
// warps an SM).
__host__ __device__ constexpr int wgs_of(int nt) { return nt >= 64 ? 4 : nt / 16; }
// Blocks an SM must hold at once: 1024 threads (64 registers a thread) for
// bf16 where a warpgroup's accumulator is 16 or 32 columns, else one (f32
// runs only in checks, and needs more registers for the same tile).
template <typename T>
__host__ __device__ constexpr int min_blocks_of(int nt) {
  return sizeof(T) == 2 && nt / wgs_of(nt) <= 32 ? 1024 / (WG * wgs_of(nt)) : 1;
}

// How the halo reaches the block: TMA boxes into the ring, or each thread's
// 16-byte loads (or element loads, for a base or pixel stride off 16 bytes).
enum Load { BY_TMA = 0, BY_16B = 1, BY_ELEMENT = 2 };

// The wrapper's shared-memory plan (ops/kernels/int8_conv.py::Plan), in
// this order.
enum PlanField {
  P_NT,      // the N tile: output channels a block
  P_STAGES,  // TMA ring stages (0: no TMA)
  P_CB,      // channels a TMA box
  P_HH,      // halo rows
  P_WH,      // halo columns
  P_WHS,     // halo columns a phase (of the stride)
  P_PLANE,   // bytes of one 16-channel plane of the A tile
  P_BOX,     // bytes between the boxes of a stage
  P_STAGE,   // bytes between stages
  P_A,       // offset of the first of two A tiles
  P_ASTEP,   // bytes from the first A tile to the second
  P_B, P_TAB, P_SC, P_QT, P_BAR,  // offsets: B, step table, scale|bias, item table, barriers
  P_BYTES,   // dynamic shared memory a block (128 of it for alignment)
  P_LEN
};

struct WParams {
  Out out;
  const void* x;        // (B, H, W, C) NHWC, T, pixels ldc elements apart
  const int8_t* w;      // (Cout, Kp) int8
  long long m, m_tiles; // B * Ho * Wo; M tiles
  int n_tiles, h, w_in, c, ldc, ho, wo, tiles_x, tiles_y, k, stride, pad, kdim, kp, one;
  int plan[P_LEN];
  float inv_a;
};

// The byte offset in the A tile of K column kc (16 bytes of K: tap, 16
// channels) for output pixel 0 of the tile.
__device__ __forceinline__ uint32_t a_column(const WParams& p, int kc) {
  const int kk = 16 * kc, tap = kk / p.c, c16 = (kk - tap * p.c) / 16;
  if (p.one) return c16 * p.plan[P_PLANE];
  const int ky = tap / p.k, kx = tap - ky * p.k;
  return c16 * p.plan[P_PLANE] +
         ((ky * p.stride + kx % p.stride) * p.plan[P_WHS] + kx / p.stride) * 16;
}

// The A tile's byte offset of 16 channels (plane c16) of halo pixel px. A
// halo pixel (hy, hx) sits at ((hy * s + hx % s) * whs + hx / s) * 16 in its
// plane, the columns split by phase, so that for every tap the 8 outputs of
// a tile row are 8 consecutive 16-byte rows: a K-major core matrix.
__device__ __forceinline__ uint32_t a_offset(const WParams& p, int px, int c16) {
  if (p.one) return c16 * p.plan[P_PLANE] + px * 16;
  const int hy = px / p.plan[P_WH], hx = px - hy * p.plan[P_WH];
  return c16 * p.plan[P_PLANE] +
         ((hy * p.stride + hx % p.stride) * p.plan[P_WHS] + hx / p.stride) * 16;
}

// 16 activations of one pixel, as f32, from 16-byte aligned memory
template <typename T>
__device__ __forceinline__ void load16(const T* src, float* v) {
  load8(src, v);
  load8(src + 8, v + 8);
}

__device__ __forceinline__ uint4 quantize16(const float* v, float inv_a) {
  uint32_t q[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    q[i] = pack4(quantize(v[4 * i], inv_a), quantize(v[4 * i + 1], inv_a),
                 quantize(v[4 * i + 2], inv_a), quantize(v[4 * i + 3], inv_a));
  return make_uint4(q[0], q[1], q[2], q[3]);
}

// An output tile: 64 consecutive pixels from m0 (one: 1x1 stride 1) or the
// 8 x 8 outputs from (oy0, ox0) of image img, whose halo starts at input
// (iy0, ix0).
struct Tile {
  long long m0;
  int img, oy0, ox0, iy0, ix0;
};

__device__ __forceinline__ Tile tile_at(const WParams& p, long long mt) {
  Tile t{0, 0, 0, 0, 0, 0};
  if (p.one) {
    t.m0 = mt * BM;
  } else {
    t.ox0 = static_cast<int>(mt % p.tiles_x) * 8;
    mt /= p.tiles_x;
    t.oy0 = static_cast<int>(mt % p.tiles_y) * 8;
    t.img = static_cast<int>(mt / p.tiles_y);
    t.iy0 = t.oy0 * p.stride - p.pad;
    t.ix0 = t.ox0 * p.stride - p.pad;
  }
  return t;
}

// One thread: the TMA boxes of tile t's halo into ring stage `stage`, onto
// its barrier: one box of cb channels x the halo's columns x its rows (64
// pixels for 1x1 stride 1) per cb channels. The halo outside the image
// (negative coordinates included) comes in as zeros: the padding, since
// rint(0 * inv_a) = 0. A box's bytes count in full, zeros included.
template <typename T>
__device__ __forceinline__ void issue_halo(const WParams& p, const CUtensorMap* map,
                                           uint32_t ring, uint32_t bars, const Tile& t,
                                           int stage) {
  const int cb = p.plan[P_CB], boxes = p.c / cb;
  const uint32_t bar = bars + 8 * stage;
  const uint32_t dst = ring + stage * p.plan[P_STAGE];
  mbar_expect_tx(bar, boxes * p.plan[P_HH] * p.plan[P_WH] * cb * static_cast<int>(sizeof(T)));
  for (int i = 0; i < boxes; ++i) {
    if (p.one)
      tma_load_2d(dst + i * p.plan[P_BOX], map, bar, i * cb, static_cast<int>(t.m0));
    else
      tma_load_4d(dst + i * p.plan[P_BOX], map, bar, i * cb, t.ix0, t.iy0, t.img);
  }
}

// The halo of one ring stage (boxes of [rows][columns][cb] T) quantized
// into an A tile: item e (16 channels of one halo pixel) comes from 16-byte
// unit qt[e] & 0xffff of the stage and goes to unit qt[e] >> 16 of the A
// tile (the table, made once a block, holds the index arithmetic).
template <typename T, int TH>
__device__ __forceinline__ void quantize_stage(const WParams& p, const unsigned char* stage,
                                               const uint32_t* qt, unsigned char* a_tile,
                                               int items) {
#pragma unroll 4
  for (int e = threadIdx.x; e < items; e += TH) {
    const uint32_t t = qt[e];
    float v[16];
    load16(reinterpret_cast<const T*>(stage + (t & 0xffffu) * 16), v);
    *reinterpret_cast<uint4*>(a_tile + (t >> 16) * 16) = quantize16(v, p.inv_a);
  }
}

// Halo items a thread loads before it quantizes them on the BY_16B and
// BY_ELEMENT routes: one item is 16 channels of one halo pixel (32 bytes in
// bf16, 64 in f32); within 64 registers, 2 in flight by 16-byte loads, 1 by
// element loads.
template <int LOAD>
constexpr int HELD = LOAD == BY_16B ? 2 : 1;

// The same from global memory by the threads' own loads: items e0, e0 +
// TH, ... (PF of them) of tile t's halo, zeros outside the image, then
// quantized into the A tile.
template <typename T, int PF, int TH, bool VEC>
__device__ __forceinline__ void load_quantize(const WParams& p, const Tile& t, int e0, int items,
                                              unsigned char* a_tile) {
  const T* x = static_cast<const T*>(p.x);
  const int planes = p.c / 16;
  uint4 raw[PF][sizeof(T)];
#pragma unroll
  for (int u = 0; u < PF; ++u) {
    const int e = e0 + u * TH;
    const int px = e / planes, c16 = e - px * planes;
    bool ok = e < items;
    long long src;
    if (p.one) {
      ok = ok && t.m0 + px < p.m;
      src = (t.m0 + px) * p.ldc;
    } else {
      const int hy = px / p.plan[P_WH], hx = px - hy * p.plan[P_WH];
      const int iy = t.iy0 + hy, ix = t.ix0 + hx;
      ok = ok && iy >= 0 && iy < p.h && ix >= 0 && ix < p.w_in;
      src = ((static_cast<long long>(t.img) * p.h + iy) * p.w_in + ix) * p.ldc;
    }
    const T* from = x + src + c16 * 16;
    if (VEC) {
#pragma unroll
      for (int i = 0; i < static_cast<int>(sizeof(T)); ++i)
        raw[u][i] = ok ? reinterpret_cast<const uint4*>(from)[i] : make_uint4(0, 0, 0, 0);
    } else {
      T vals[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) vals[i] = ok ? from[i] : T(0.0f);
      memcpy(&raw[u][0], vals, sizeof(vals));
    }
  }
#pragma unroll
  for (int u = 0; u < PF; ++u) {
    const int e = e0 + u * TH;
    if (e >= items) break;
    const int px = e / planes, c16 = e - px * planes;
    float v[16];
    load16(reinterpret_cast<const T*>(&raw[u][0]), v);
    *reinterpret_cast<uint4*>(a_tile + a_offset(p, px, c16)) = quantize16(v, p.inv_a);
  }
}

// Persistent: block b keeps N tile b % n_tiles (its weights, scale and bias
// resident in shared memory, loaded once) and takes M tiles b / n_tiles,
// + gridDim.x / n_tiles, ... Two A tiles alternate: while the products of
// tile j run (asynchronous wgmma, one commit), the block quantizes the halo
// of tile j + 1 into the other A tile; then the epilogue of tile j. BY_TMA:
// thread 0 keeps the halos of the next `stages` tiles in flight by TMA, a
// ring of bf16 (or f32) stages with one mbarrier each, and refills a stage
// as soon as its halo is quantized.
template <typename T, int NT, int LOAD>
__global__ void __launch_bounds__(WG * wgs_of(NT), min_blocks_of<T>(NT))
    s8_conv_wgmma_kernel(const __grid_constant__ CUtensorMap map, const WParams p) {
  constexpr int WGS = wgs_of(NT), TH = WG * WGS;
  constexpr int NW = NT / WGS;  // a warpgroup's columns
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((128u - (smem_u32(smem_raw) & 127u)) & 127u);
  const uint32_t ring = smem_u32(smem), b_base = ring + p.plan[P_B];
  const uint32_t bars = ring + p.plan[P_BAR];
  uint2* tab = reinterpret_cast<uint2*>(smem + p.plan[P_TAB]);  // a step: A start, LBO | swap << 31
  float* sc = reinterpret_cast<float*>(smem + p.plan[P_SC]);     // scale[NT], then bias[NT]
  uint32_t* qt = reinterpret_cast<uint32_t*>(smem + p.plan[P_QT]);  // BY_TMA: the item table
  const int tid = threadIdx.x;
  const int steps = p.kp / 32, stages = p.plan[P_STAGES];
  const int n0 = static_cast<int>(blockIdx.x % p.n_tiles) * NT;
  const int planes = p.c / 16;
  const int items = (p.one ? BM : p.plan[P_HH] * p.plan[P_WH]) * planes;
  // this block's M tiles: first, first + m_step, ... (count of them)
  const long long m_step = gridDim.x / p.n_tiles, first = blockIdx.x / p.n_tiles;
  const int count = first < p.m_tiles ? static_cast<int>((p.m_tiles - 1 - first) / m_step + 1) : 0;

  if (LOAD == BY_TMA && tid == 0) {
    for (int s = 0; s < stages; ++s) mbar_init(bars + 8 * s, 1);
    mbar_fence_init();
  }
  // once a block: the step table (a step's two A columns in ascending
  // address order, LBO their distance; a K column past K has zero weights
  // and reads the other column's neighbour), scale and bias, the item
  // table, then B: its K columns in the order the step table gives
  for (int j = tid; j < steps; j += TH) {
    const uint32_t a0 = a_column(p, 2 * j);
    const uint32_t a1 = 32 * j + 16 < p.kdim ? a_column(p, 2 * j + 1) : a0 + 16;
    tab[j] = a1 >= a0 ? make_uint2(a0, a1 - a0) : make_uint2(a1, (a0 - a1) | 0x80000000u);
  }
  const T* bias = static_cast<const T*>(p.out.bias);
  for (int i = tid; i < NT; i += TH) {
    const bool ok = n0 + i < p.out.n;
    sc[i] = ok ? p.out.scale[n0 + i] : 0.0f;
    sc[NT + i] = ok ? to_f32(bias[n0 + i]) : 0.0f;
  }
  if (LOAD == BY_TMA) {
    const int per_box = p.plan[P_CB] / 16;
    for (int e = tid; e < items; e += TH) {
      const int px = e / planes, c16 = e - px * planes;
      const int box = c16 / per_box, within = c16 - box * per_box;
      const uint32_t src =
          box * p.plan[P_BOX] + (px * p.plan[P_CB] + within * 16) * static_cast<int>(sizeof(T));
      qt[e] = (src >> 4) | ((a_offset(p, px, c16) >> 4) << 16);
    }
  }
  __syncthreads();
  if (LOAD == BY_TMA && tid == 0)
    for (int j = 0; j < stages && j < count; ++j)
      issue_halo<T>(p, &map, ring, bars, tile_at(p, first + j * m_step), j);
  for (int e = tid; e < steps * 2 * NT; e += TH) {
    const int col = e / NT, n = e - col * NT, j = col / 2;
    const int pos = 2 * j + ((col & 1) ^ static_cast<int>(tab[j].y >> 31));
    const bool ok = n0 + n < p.out.n;
    cp_async16(b_base + (pos * NT + n) * 16,
               p.w + static_cast<long long>(ok ? n0 + n : 0) * p.kp + col * 16, ok ? 16 : 0);
  }
  cp_async_wait_all();

  // tile j's halo quantized into A tile j % 2; for TMA, its stage then refilled
  // with the halo of tile j + stages (after the barrier that follows)
  auto quantize = [&](int j) {
    unsigned char* a_tile = smem + p.plan[P_A] + (j & 1) * p.plan[P_ASTEP];
    if (LOAD == BY_TMA) {
      const int s = j % stages;
      mbar_wait(bars + 8 * s, (j / stages) & 1);
      quantize_stage<T, TH>(p, smem + s * p.plan[P_STAGE], qt, a_tile, items);
    } else {
      const Tile t = tile_at(p, first + j * m_step);
      for (int e0 = tid; e0 < items; e0 += HELD<LOAD> * TH)
        load_quantize<T, HELD<LOAD>, TH, LOAD == BY_16B>(p, t, e0, items, a_tile);
    }
    fence_proxy_async();
  };
  auto refill = [&](int j) {
    if (LOAD == BY_TMA && tid == 0 && j + stages < count)
      issue_halo<T>(p, &map, ring, bars, tile_at(p, first + (j + stages) * m_step), j % stages);
  };

  const uint32_t sbo = p.one ? 128 : p.stride * p.stride * p.plan[P_WHS] * 16;
  // warpgroup wg takes columns wg * NW .. of the N tile
  const int wg = tid / WG, warp = (tid >> 5) & 3, lane = tid & 31, g8 = lane >> 2, t4 = lane & 3;
  if (count > 0) {
    quantize(0);
    __syncthreads();
    refill(0);
  }
  for (int j = 0; j < count; ++j) {
    const Tile cur = tile_at(p, first + j * m_step);
    const uint32_t a_base = ring + p.plan[P_A] + (j & 1) * p.plan[P_ASTEP];
    int32_t acc[NW / 2];
    wgmma_fence();
    for (int i = 0; i < steps; ++i) {
      const uint2 t = tab[i];
      wgmma_s8(acc, desc_plain(a_base + t.x, t.y & 0x7fffffffu, sbo),
               desc_plain(b_base + (i * 2 * NT + wg * NW) * 16, NT * 16, 128), i > 0);
    }
    wgmma_commit();
    if (j + 1 < count) quantize(j + 1);  // under the products
    wgmma_wait<0>();
    fence_regs(acc);
    __syncthreads();  // A tile j + 1 is whole, A tile j free again
    if (j + 1 < count) refill(j + 1);

    // the epilogue: accumulator rows r0 = 16 warp + g8 and r0 + 8, columns
    // 8i + 2 t4, +1 (their scales and biases as pairs)
    long long rows[2];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = 16 * warp + g8 + 8 * half;
      if (p.one) {
        rows[half] = cur.m0 + r < p.m ? cur.m0 + r : -1;
      } else {
        const int oy = cur.oy0 + r / 8, ox = cur.ox0 + r % 8;
        rows[half] = oy < p.ho && ox < p.wo
                         ? (static_cast<long long>(cur.img) * p.ho + oy) * p.wo + ox : -1;
      }
    }
#pragma unroll
    for (int i = 0; i < NW / 8; ++i) {
      const int c = wg * NW + 8 * i + 2 * t4;
      if (n0 + c >= p.out.n) continue;
      const float2 s2 = *reinterpret_cast<const float2*>(sc + c);
      const float2 b2 = *reinterpret_cast<const float2*>(sc + NT + c);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        if (rows[half] < 0) continue;
        const int32_t a0 = acc[4 * i + 2 * half], a1 = acc[4 * i + 2 * half + 1];
        write_pair<T>(p.out, rows[half], n0 + c, epilogue<T>(a0, s2.x, b2.x, p.out.act),
                      epilogue<T>(a1, s2.y, b2.y, p.out.act), a0, a1);
      }
    }
  }
}

// ------------------------------------ the narrow path: mma.sync, quantize on load

constexpr int NBM = 128;       // output pixels a block
constexpr int NBN = 64;        // output channels a block
constexpr int NBK = 32;        // K a step (one mma deep)
constexpr int N_THREADS = 128;  // 4 warps
constexpr int ROW = 48;        // shared-memory bytes between tile rows (32 + 16 pad)

struct NParams {
  Out out;
  const void* x;    // (B, H, W, C) NHWC, T, pixels ldc elements apart
  const int8_t* w;  // (N, Kp) int8
  long long m;      // B * Ho * Wo
  int h, w_in, c, ldc, ho, wo, kh, kw, stride, pad, k, kp;
  float inv_a;
};

__device__ __forceinline__ void mma_s8(int32_t* d, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The quantized A row of thread `row` for K step k0: 32 int8 as 8 words.
// STEM: Cin 3 and a 3x3 kernel as constants, so that the tap and channel of
// each K index are known at compile time (no integer division).
template <typename T, bool VEC, bool STEM>
__device__ __forceinline__ void fetch_a(const NParams& p, const T* xb, bool row_ok, int iy0,
                                        int ix0, int k0, uint32_t* qa) {
  const int c = STEM ? 3 : p.c, kw = STEM ? 3 : p.kw, kdim = STEM ? 27 : p.k;
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    float v[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = 0.0f;
    if (VEC) {  // 8 channels of one tap (Cin % 8 == 0, so K % 8 == 0)
      const int k = k0 + 8 * g;
      if (row_ok && k < kdim) {
        const int tap = k / c;
        const int ci = k - tap * c;
        const int ky = tap / kw;
        const int iy = iy0 + ky, ix = ix0 + tap - ky * kw;
        if (iy >= 0 && iy < p.h && ix >= 0 && ix < p.w_in)
          load8(xb + (static_cast<long long>(iy) * p.w_in + ix) * p.ldc + ci, v);
      }
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int k = k0 + 8 * g + i;
        if (row_ok && k < kdim) {
          const int tap = k / c;
          const int ci = k - tap * c;
          const int ky = tap / kw;
          const int iy = iy0 + ky, ix = ix0 + tap - ky * kw;
          if (iy >= 0 && iy < p.h && ix >= 0 && ix < p.w_in)
            v[i] = to_f32(xb[(static_cast<long long>(iy) * p.w_in + ix) * p.ldc + ci]);
        }
      }
    }
    qa[2 * g] = pack4(quantize(v[0], p.inv_a), quantize(v[1], p.inv_a),
                      quantize(v[2], p.inv_a), quantize(v[3], p.inv_a));
    qa[2 * g + 1] = pack4(quantize(v[4], p.inv_a), quantize(v[5], p.inv_a),
                          quantize(v[6], p.inv_a), quantize(v[7], p.inv_a));
  }
}

// A block computes a 128 x 64 output tile (128 x 16 for the stem); warp w
// takes rows 32w..32w+31 and all columns as 2 x 8 (2 x 2) tiles of
// mma.sync m16n8k32. Each 32-deep
// step, thread r gathers row r of the A tile (im2col on the fly, zeros
// outside the image and past K), quantizes it in registers and stores 32
// bytes to shared memory (rows 48 bytes apart: conflict-free); the B tile
// is 64 rows of 32 weight bytes. The next step's loads are issued before
// this step's products.
template <typename T, bool VEC, bool STEM>
__global__ void __launch_bounds__(N_THREADS) s8_conv_narrow_kernel(const NParams p) {
  constexpr int NJ = STEM ? 2 : 8;  // 8-column tiles a block: the stem's Cout is 16
  __shared__ __align__(16) uint8_t sa[NBM * ROW];
  __shared__ __align__(16) uint8_t sb[NBN * ROW];

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const long long m0 = static_cast<long long>(blockIdx.x) * NBM;
  const int n0 = blockIdx.y * NJ * 8;
  const int n = p.out.n;

  // this thread's A row: output pixel m0 + tid
  const long long m = m0 + tid;
  const bool row_ok = m < p.m;
  const long long mm = row_ok ? m : 0;
  const int ox = static_cast<int>(mm % p.wo);
  const int oy = static_cast<int>((mm / p.wo) % p.ho);
  const long long b = mm / (static_cast<long long>(p.wo) * p.ho);
  const T* xb = static_cast<const T*>(p.x) + b * p.h * p.w_in * p.ldc;
  const int iy0 = oy * p.stride - p.pad, ix0 = ox * p.stride - p.pad;

  // this thread's 16 bytes of the B tile: weight row n0 + tid / 2, half tid % 2
  const int bn = tid >> 1, bhalf = tid & 1;
  const bool brow_ok = n0 + bn < n;
  const int8_t* wrow = p.w + static_cast<long long>(brow_ok ? n0 + bn : 0) * p.kp + bhalf * 16;

  int32_t acc[2][NJ][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

  // column tiles of this block that hold output channels (warp-uniform)
  const int n_tiles = min(NJ, (n - n0 + 7) / 8);

  uint32_t qa[8];
  uint4 qb;
  fetch_a<T, VEC, STEM>(p, xb, row_ok, iy0, ix0, 0, qa);
  qb = brow_ok ? *reinterpret_cast<const uint4*>(wrow) : make_uint4(0, 0, 0, 0);

  const int steps = p.kp / NBK;
  for (int s = 0; s < steps; ++s) {
    uint4* arow = reinterpret_cast<uint4*>(sa + tid * ROW);
    arow[0] = make_uint4(qa[0], qa[1], qa[2], qa[3]);
    arow[1] = make_uint4(qa[4], qa[5], qa[6], qa[7]);
    *reinterpret_cast<uint4*>(sb + bn * ROW + bhalf * 16) = qb;
    __syncthreads();
    if (s + 1 < steps) {  // the next step's loads, in flight under this step's products
      fetch_a<T, VEC, STEM>(p, xb, row_ok, iy0, ix0, (s + 1) * NBK, qa);
      qb = brow_ok ? *reinterpret_cast<const uint4*>(wrow + (s + 1) * NBK)
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
    for (int j = 0; j < NJ; ++j) {
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
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const long long row = m0 + warp * 32 + i * 16 + g + half * 8;
      if (row >= p.m) continue;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int col = n0 + j * 8 + 2 * t;
        if (col >= n) continue;
        const int32_t a0 = acc[i][j][2 * half], a1 = acc[i][j][2 * half + 1];
        const T* bias = static_cast<const T*>(p.out.bias);
        const float v0 = epilogue<T>(a0, p.out.scale[col], to_f32(bias[col]), p.out.act);
        const float v1 = col + 1 < n ? epilogue<T>(a1, p.out.scale[col + 1], to_f32(bias[col + 1]),
                                                   p.out.act)
                                     : 0.0f;
        write_pair<T>(p.out, row, col, v0, v1, a0, a1);
      }
    }
}

// ------------------------------------------------------------------- host

int align_up(int v, int a) { return (v + a - 1) / a * a; }

// The plan's regions lie in order inside its bytes, each as large as the
// kernel uses it, the TMA boxes on 128-byte boundaries; its geometry is the
// tile's (8 x 8 outputs, or 64 pixels for 1x1 stride 1); within the
// device's shared memory. The wrapper makes the plan; this only guards the
// launch against one that would write past its shared memory.
bool plan_ok(const int* pl, int c, int k, int stride, int kp, int esize, int smem_optin) {
  const bool one = k == 1 && stride == 1;
  const int nt = pl[P_NT], stages = pl[P_STAGES], cb = pl[P_CB];
  const int hh = one ? 1 : 7 * stride + k, wh = one ? BM : 7 * stride + k;
  const int whs = one ? BM : (wh + stride - 1) / stride;
  if (nt != 16 && nt != 32 && nt != 64 && nt != 128 && nt != 256) return false;
  if (pl[P_HH] != hh || pl[P_WH] != wh || pl[P_WHS] != whs ||
      pl[P_PLANE] < (one ? BM : hh * stride * whs) * 16 || pl[P_PLANE] % 16 != 0)
    return false;
  if (stages < 0 || stages > 8) return false;
  if (stages > 0 && (cb % 16 != 0 || cb > 256 || c % cb != 0 || pl[P_BOX] % 128 != 0 ||
                     pl[P_BOX] < hh * wh * cb * esize || pl[P_STAGE] % 128 != 0 ||
                     pl[P_STAGE] < c / cb * pl[P_BOX]))
    return false;
  const int items = (one ? BM : hh * wh) * (c / 16);
  return pl[P_A] >= stages * pl[P_STAGE] && pl[P_A] % 128 == 0 &&
         pl[P_ASTEP] >= c / 16 * pl[P_PLANE] && pl[P_ASTEP] % 128 == 0 &&
         pl[P_ASTEP] / 16 < 65536 && pl[P_STAGE] / 16 < 65536 &&
         pl[P_B] >= pl[P_A] + 2 * pl[P_ASTEP] && pl[P_B] % 128 == 0 &&
         pl[P_TAB] >= pl[P_B] + kp * nt && pl[P_TAB] % 8 == 0 &&
         pl[P_SC] >= pl[P_TAB] + kp / 32 * 8 && pl[P_SC] % 16 == 0 &&
         pl[P_QT] >= pl[P_SC] + 8 * nt && pl[P_QT] % 4 == 0 &&
         pl[P_BAR] >= pl[P_QT] + (stages > 0 ? 4 * items : 0) && pl[P_BAR] % 8 == 0 &&
         pl[P_BYTES] >= pl[P_BAR] + 8 * stages + 128 && pl[P_BYTES] <= smem_optin;
}

// The halo's tensor map for input x: one box of cb channels x its columns
// x its rows of one image (a 4-D map over (c, w, h, b)), or cb channels x
// 64 pixels (a 2-D map over (c, b * h * w)) for 1x1 stride 1. Kept by
// (base, shape, box) in a small cache, since eager calls meet the same
// buffers batch after batch (the caching allocator hands them out again)
// and an encoding costs more host time than the rest of a launch.
bool halo_map(CUtensorMap* map, const void* x, int is_bf16, int b, int h, int w, int c, int ldc,
              bool one, const int* plan) {
  struct Key {
    uintptr_t x;
    int v[9];
  };
  constexpr int SLOTS = 64;
  static std::mutex mu;
  static Key keys[SLOTS];
  static CUtensorMap maps[SLOTS];
  static int used = 0, next = 0;
  Key key;
  memset(&key, 0, sizeof(key));
  key.x = reinterpret_cast<uintptr_t>(x);
  const int v[9] = {is_bf16, b, h, w, c, ldc, one, plan[P_CB], plan[P_WH] * 1024 + plan[P_HH]};
  memcpy(key.v, v, sizeof(v));
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < used; ++i)
    if (memcmp(&keys[i], &key, sizeof(key)) == 0) {
      *map = maps[i];
      return true;
    }
  const CUtensorMapDataType type =
      is_bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  const cuuint64_t pix = static_cast<cuuint64_t>(ldc) * (is_bf16 ? 2 : 4);
  const cuuint32_t cb = plan[P_CB];
  bool ok;
  if (one) {
    const cuuint64_t dims[2] = {static_cast<cuuint64_t>(c), static_cast<cuuint64_t>(b) * h * w};
    const cuuint64_t strides[1] = {pix};
    const cuuint32_t box[2] = {cb, static_cast<cuuint32_t>(BM)};
    ok = make_map_plain(map, type, 2, x, dims, strides, box);
  } else {
    const cuuint64_t dims[4] = {static_cast<cuuint64_t>(c), static_cast<cuuint64_t>(w),
                                static_cast<cuuint64_t>(h), static_cast<cuuint64_t>(b)};
    const cuuint64_t strides[3] = {pix, pix * w, pix * w * h};
    const cuuint32_t box[4] = {cb, static_cast<cuuint32_t>(plan[P_WH]),
                               static_cast<cuuint32_t>(plan[P_HH]), 1};
    ok = make_map_plain(map, type, 4, x, dims, strides, box);
  }
  if (!ok) return false;
  keys[next] = key;
  maps[next] = *map;
  next = (next + 1) % SLOTS;
  used = used < SLOTS ? used + 1 : SLOTS;
  return true;
}

template <typename T, int NT, int LOAD>
int launch_wgmma(const CUtensorMap& map, const WParams& p, cudaStream_t stream) {
  constexpr int threads = WG * wgs_of(NT);
  const int bytes = p.plan[P_BYTES];
  int dev = 0, sms = 0, sm_smem = 0, optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sm_smem, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev) !=
          cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess)
    return static_cast<int>(cudaGetLastError());
  // once a process: the largest dynamic shared memory, and the registers
  static const cudaFuncAttributes attr = [optin] {
    cudaFuncAttributes a{};
    if (cudaFuncSetAttribute(s8_conv_wgmma_kernel<T, NT, LOAD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, optin) != cudaSuccess ||
        cudaFuncGetAttributes(&a, s8_conv_wgmma_kernel<T, NT, LOAD>) != cudaSuccess)
      a.numRegs = 0;
    return a;
  }();
  if (attr.numRegs <= 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  // the persistent grid: the blocks the card holds at once (by shared
  // memory, 1 KB of it reserved a block, registers and threads), a multiple
  // of the N tiles, at most one an M tile
  const int per_sm = std::max(1, std::min({sm_smem / (bytes + 1024),
                                           65536 / (align_up(attr.numRegs, 8) * threads),
                                           2048 / threads}));
  const long long m_blocks = std::max(
      1LL, std::min<long long>(p.m_tiles, static_cast<long long>(sms) * per_sm / p.n_tiles));
  s8_conv_wgmma_kernel<T, NT, LOAD>
      <<<static_cast<unsigned>(m_blocks * p.n_tiles), threads, bytes, stream>>>(map, p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int LOAD>
int launch_wgmma(const CUtensorMap& map, const WParams& p, cudaStream_t stream) {
  switch (p.plan[P_NT]) {
    case 16: return launch_wgmma<T, 16, LOAD>(map, p, stream);
    case 32: return launch_wgmma<T, 32, LOAD>(map, p, stream);
    case 64: return launch_wgmma<T, 64, LOAD>(map, p, stream);
    case 128: return launch_wgmma<T, 128, LOAD>(map, p, stream);
    default: return launch_wgmma<T, 256, LOAD>(map, p, stream);
  }
}

template <typename T>
int launch_wgmma(const CUtensorMap& map, const WParams& p, int load, cudaStream_t stream) {
  switch (load) {
    case BY_TMA: return launch_wgmma<T, BY_TMA>(map, p, stream);
    case BY_16B: return launch_wgmma<T, BY_16B>(map, p, stream);
    default: return launch_wgmma<T, BY_ELEMENT>(map, p, stream);
  }
}

}  // namespace

// x: (b, h, w, c) NHWC with pixels ldc elements apart (c % 16 == 0), bf16
// (is_bf16) or f32; wt: (n, kp) int8, 16-byte aligned; scale: (n,) f32;
// bias: (n,) in x's type; y: (b, ho, wo, n) in x's type; acc: (b, ho, wo, n)
// s32 or null; plan: the wrapper's P_LEN ints (PlanField). With stages > 0
// the halo comes by TMA: x's base and pixel stride must then be multiples
// of 16 bytes. The tensor map is passed by value in the launch's parameters
// (a captured graph keeps it, and a graph's buffers keep their addresses).
extern "C" int s8_conv_wgmma(const void* x, int is_bf16, int b, int h, int w, int c, int ldc,
                             const void* wt, int n, int k, int stride, int kp, float inv_a,
                             const void* scale, const void* bias, int act, void* y, void* acc,
                             int ho, int wo, const int* plan, void* stream) {
  const int esize = is_bf16 ? 2 : 4;
  int dev = 0, optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess)
    return static_cast<int>(cudaGetLastError());
  if (b <= 0 || h <= 0 || w <= 0 || c <= 0 || c % 16 != 0 || ldc < c || n <= 0 || k <= 0 ||
      stride <= 0 || kp % 32 != 0 || kp < k * k * c || kp - k * k * c >= 32 || ho <= 0 ||
      wo <= 0 || reinterpret_cast<uintptr_t>(wt) % 16 != 0 || plan == nullptr ||
      !plan_ok(plan, c, k, stride, kp, esize, optin))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0 && (ldc * esize) % 16 == 0;
  const bool tma = plan[P_STAGES] > 0;
  if (tma && !aligned) return static_cast<int>(cudaErrorInvalidValue);
  const int kdim = k * k * c;
  const long long m = static_cast<long long>(b) * ho * wo;
  const bool one = k == 1 && stride == 1;
  const int tiles_x = (wo + 7) / 8, tiles_y = (ho + 7) / 8;
  const long long m_tiles =
      one ? (m + BM - 1) / BM : static_cast<long long>(b) * tiles_x * tiles_y;
  WParams p{Out{static_cast<const float*>(scale), bias, y, static_cast<int32_t*>(acc), n, act},
            x, static_cast<const int8_t*>(wt), m, m_tiles, (n + plan[P_NT] - 1) / plan[P_NT], h,
            w, c, ldc, ho, wo, tiles_x, tiles_y, k, stride, k / 2, kdim, kp, one, {}, inv_a};
  memcpy(p.plan, plan, sizeof(p.plan));
  CUtensorMap map;
  memset(&map, 0, sizeof(map));
  if (tma && !halo_map(&map, x, is_bf16, b, h, w, c, ldc, one, plan))
    return static_cast<int>(cudaErrorInvalidValue);
  const int load = tma ? BY_TMA : (aligned ? BY_16B : BY_ELEMENT);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_wgmma<__nv_bfloat16>(map, p, load, s)
                 : launch_wgmma<float>(map, p, load, s);
}

// x: (b, h, w, c) NHWC with pixels ldc elements apart, bf16 (is_bf16) or
// f32; w: (n, kp) int8; scale: (n,) f32; bias: (n,) in x's type; y:
// (b, ho, wo, n) in x's type; acc: (b, ho, wo, n) s32 or null.
extern "C" int s8_conv_narrow(const void* x, int is_bf16, int b, int h, int w_in, int c, int ldc,
                              const void* w, int n, int kh, int kw, int stride, int kp,
                              float inv_a, const void* scale, const void* bias, int act, void* y,
                              void* acc, int ho, int wo, void* stream) {
  const int k = kh * kw * c;
  if (b <= 0 || h <= 0 || w_in <= 0 || c <= 0 || ldc < c || n <= 0 || kh <= 0 || kw <= 0 ||
      stride <= 0 || kp % NBK != 0 || kp < k || ho <= 0 || wo <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long m = static_cast<long long>(b) * ho * wo;
  if ((m + NBM - 1) / NBM > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const NParams p{Out{static_cast<const float*>(scale), bias, y, static_cast<int32_t*>(acc), n,
                      act},
                  x, static_cast<const int8_t*>(w), m, h, w_in, c, ldc, ho, wo, kh, kw, stride,
                  kh / 2, k, kp, inv_a};
  const bool vec = c % 8 == 0 && ldc % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const bool stem = c == 3 && kh == 3 && kw == 3;
  const int bn = stem ? 16 : NBN;
  const dim3 grid(static_cast<unsigned>((m + NBM - 1) / NBM), (n + bn - 1) / bn);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    if (vec) s8_conv_narrow_kernel<__nv_bfloat16, true, false><<<grid, N_THREADS, 0, s>>>(p);
    else if (stem) s8_conv_narrow_kernel<__nv_bfloat16, false, true><<<grid, N_THREADS, 0, s>>>(p);
    else s8_conv_narrow_kernel<__nv_bfloat16, false, false><<<grid, N_THREADS, 0, s>>>(p);
  } else {
    if (vec) s8_conv_narrow_kernel<float, true, false><<<grid, N_THREADS, 0, s>>>(p);
    else if (stem) s8_conv_narrow_kernel<float, false, true><<<grid, N_THREADS, 0, s>>>(p);
    else s8_conv_narrow_kernel<float, false, false><<<grid, N_THREADS, 0, s>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}

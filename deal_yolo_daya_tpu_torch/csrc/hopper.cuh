// Building blocks of the Hopper (sm_90a) kernels: TMA tile copies into
// shared memory with mbarrier completion, cp.async and the proxy fence,
// wgmma matrix descriptors and products, the quad reductions of wgmma's
// accumulator layout, and the epilogue that writes a warpgroup's
// accumulator rows as bf16.
//
// wgmma's f32 accumulator for a 64 x N tile: warp w of the warpgroup holds
// rows 16w..16w+15; lane = 4g + t holds rows r0 = 16w + g and r1 = r0 + 8,
// and for each block j of 8 columns acc[4j], acc[4j+1] at (r0, 8j+2t+{0,1})
// and acc[4j+2], acc[4j+3] at (r1, 8j+2t+{0,1}). A row's values sit with the
// 4 lanes of a quad, so a row reduction is two __shfl_xor_sync. The same
// registers, two 8-column blocks at a time and rounded to bf16 pairs, are
// the A operand of the next product (register A of m64nNk16).
//
// Shared-memory tiles are rows of 64 or 128 bytes, written by TMA with the
// 64- or 128-byte swizzle and read by wgmma through a descriptor of the same
// swizzle: K-major when the reduction runs along a row (Q.K^T), MN-major
// when it runs down the rows (P.V).

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace hopper {

using bf16 = __nv_bfloat16;
constexpr unsigned FULL = 0xffffffffu;
constexpr float LOG2E = 1.4426950408889634f;

// ------------------------------------------------------------- host: TMA maps

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled, looked up once through the runtime
// (no link against libcuda); null if the driver has none.
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// A map over a row-major (chunks, rows, cols) bf16 array whose boxes are
// box_rows x box_cols of one chunk, swizzled for rows of box_cols * 2 bytes
// (64 or 128). Rows past `rows` in a chunk come in as zeros. False if the
// driver refuses it.
inline bool make_map(CUtensorMap* map, const void* data, int chunks, int rows, int cols,
                     int box_cols, int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows, (cuuint64_t)chunks};
  const cuuint64_t strides[2] = {(cuuint64_t)cols * 2, (cuuint64_t)rows * cols * 2};
  const cuuint32_t box[3] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUtensorMapSwizzle swizzle =
      box_cols * 2 == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(data), dims, strides,
            box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A map over a `rank`-dimensional array (innermost dimension first; strides
// in bytes for dimensions 1.., each a multiple of 16) whose boxes are `box`,
// unswizzled: a box lands in shared memory as a dense array, innermost
// dimension fastest. Box elements outside the array (negative coordinates
// included) come in as zeros. False if the driver refuses it.
inline bool make_map_plain(CUtensorMap* map, CUtensorMapDataType type, int rank,
                           const void* data, const cuuint64_t* dims, const cuuint64_t* strides,
                           const cuuint32_t* box) {
  const EncodeTiled fn = encode_tiled();
  const cuuint32_t unit[5] = {1, 1, 1, 1, 1};
  return fn != nullptr &&
         fn(map, type, static_cast<cuuint32_t>(rank), const_cast<void*>(data), dims, strides, box,
            unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// ------------------------------------------------ device: barriers and TMA

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The dynamic shared memory from its first 1024-byte boundary: the 128-byte
// swizzle repeats every 1024 bytes, and TMA and wgmma both apply it to the
// address bits.
__device__ __forceinline__ unsigned char* align1024(unsigned char* raw) {
  return raw + ((1024u - (smem_u32(raw) & 1023u)) & 1023u);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Wait until the barrier's phase of this parity has completed. A copy that
// never lands traps (the launch fails) instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (uint32_t spins = 0; !mbar_try_wait(bar, parity); ++spins)
    if (spins == (1u << 24)) __trap();
}

// One thread: copy the box at (column c0, row c1, chunk c2) into shared
// memory at dst; its bytes complete a transaction on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0,
                                         int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// The same for a 2-D map at (c0, c1) and a 4-D map at (c0, c1, c2, c3).
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// 16 bytes global -> shared, asynchronous; zeros where src_bytes is 0.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// 8 bytes global -> shared, asynchronous (an 8-byte aligned source); zeros
// where src_bytes is 0.
__device__ __forceinline__ void cp_async8(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}

// Close this thread's group of cp.async copies; wait until at most N of its
// groups are still in flight.
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The byte offset of 16-byte chunk `chunk` of row `row` in a tile of
// ROW_BYTES-byte rows laid out as TMA writes it with the 128- or 64-byte
// swizzle (the tile starts on a 1024-byte boundary): the chunk index XOR
// the row's position in its 1024-byte (128-byte rows) or 512-byte (64-byte
// rows) repeat.
template <int ROW_BYTES>
__device__ __forceinline__ uint32_t swizzled(int row, int chunk) {
  static_assert(ROW_BYTES == 64 || ROW_BYTES == 128, "64- or 128-byte rows");
  return ROW_BYTES == 128 ? row * 128 + ((chunk ^ (row & 7)) << 4)
                          : row * 64 + ((chunk ^ ((row >> 1) & 3)) << 4);
}


// Make this thread's shared-memory writes of the generic proxy (stores,
// cp.async) visible to the async proxy (wgmma, TMA).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ------------------------------------------------------------------ wgmma

// Descriptor of a tile of rows of ROW_BYTES (64 or 128) bytes, swizzled to
// match: 8 rows make one swizzle atom of 8 * ROW_BYTES bytes.
template <int ROW_BYTES>
struct Tile {
  static_assert(ROW_BYTES == 64 || ROW_BYTES == 128, "64- or 128-byte rows");
  static constexpr uint64_t LAYOUT = ROW_BYTES == 128 ? 1 : 2;  // 128B or 64B swizzle
  static constexpr uint32_t ATOM = 8 * ROW_BYTES;

  // The descriptor of the tile at shared address addr, 8-row groups ATOM
  // bytes apart. With these swizzles it is the same whether the product
  // reads the tile K-major (the reduction runs along the rows, Q.K^T) or
  // MN-major (down the rows, P.V; one row is the whole N): the product's
  // transpose flag says which.
  __device__ __forceinline__ static uint64_t desc(uint32_t addr) {
    return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(16 >> 4) << 16) |
           (static_cast<uint64_t>(ATOM >> 4) << 32) | (LAYOUT << 62);
  }
  // descriptor units of a k-step of 16: +32 bytes along a K-major row, two
  // atoms (16 rows) down an MN-major tile
  static constexpr uint64_t K_STEP = 2;
  static constexpr uint64_t MN_STEP = (2 * ATOM) >> 4;
};

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N committed groups of products are still running.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// The products: wgmma_ss (A and B in shared memory, both K-major) and
// wgmma_rs_tb (A in registers, B in shared memory MN-major), one overload a
// width N, picked by the accumulator's N/2 registers a thread.

// A K-major tile in shared memory without swizzle: 8-row core matrices of
// 16-byte rows (128 contiguous bytes), `lbo` bytes between the two 16-byte
// K columns of a 32-byte K step, `sbo` bytes between 8-row groups.
__device__ __forceinline__ uint64_t desc_plain(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32);
}

// Keep the compiler from touching accumulators (f32 or s32) across an
// asynchronous product: reads after wgmma_wait() depend on this.
__device__ __forceinline__ void fence_reg(float& v) { asm volatile("" : "+f"(v)::"memory"); }
__device__ __forceinline__ void fence_reg(int32_t& v) { asm volatile("" : "+r"(v)::"memory"); }
template <typename V, int N>
__device__ __forceinline__ void fence_regs(V (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) fence_reg(d[i]);
}

// D(64 x 80) (+)= A(64 x 16) . B(16 x 80): A and B in shared memory, both K-major
__device__ __forceinline__ void wgmma_ss(float (&d)[40], uint64_t a, uint64_t b,
                                                   int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %42, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39}, %40, %41, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "l"(a), "l"(b), "r"(accumulate));
}

// D(64 x 48) (+)= A(64 x 16) . B(16 x 48): A and B in shared memory, both K-major
__device__ __forceinline__ void wgmma_ss(float (&d)[24], uint64_t a, uint64_t b,
                                                   int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23}, %24, %25, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "l"(a), "l"(b), "r"(accumulate));
}

// D(64 x 32) (+)= A(64 x 16) . B(16 x 32): A and B in shared memory, both K-major
__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t a, uint64_t b,
                                                   int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(accumulate));
}

// D(64 x 64) += A(64 x 16) . B(16 x 64): A in registers, B in shared memory, MN-major
__device__ __forceinline__ void wgmma_rs_tb(float (&d)[32], const uint32_t (&a)[4],
                                                      uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// D(64 x 32) += A(64 x 16) . B(16 x 32): A in registers, B in shared memory, MN-major
__device__ __forceinline__ void wgmma_rs_tb(float (&d)[16], const uint32_t (&a)[4],
                                                      uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// ------------------------------------------------- accumulator arithmetic

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(FULL, x, 1));
  return fmaxf(x, __shfl_xor_sync(FULL, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(FULL, x, 1);
  return x + __shfl_xor_sync(FULL, x, 2);
}

// 2^x in one MUFU instruction; results below 2^-126 flush to 0 (a
// probability that small moves no sum here), 2^-inf = 0.
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// A 64 x 16*KS f32 accumulator as the bf16 A operand of KS k-steps.
template <int KS>
__device__ __forceinline__ void to_operand(const float (&acc)[8 * KS], uint32_t (&a)[KS][4]) {
#pragma unroll
  for (int k = 0; k < KS; ++k) {
    a[k][0] = pack_bf16(acc[8 * k], acc[8 * k + 1]);
    a[k][1] = pack_bf16(acc[8 * k + 2], acc[8 * k + 3]);
    a[k][2] = pack_bf16(acc[8 * k + 4], acc[8 * k + 5]);
    a[k][3] = pack_bf16(acc[8 * k + 6], acc[8 * k + 7]);
  }
}

// Set to -inf the accumulator columns whose index col0 + column is >= n.
template <int NB>
__device__ __forceinline__ void mask_columns(float (&acc)[4 * NB], int col0, int n) {
  const int t = threadIdx.x % 4;
#pragma unroll
  for (int j = 0; j < NB; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e)
      if (col0 + 8 * j + 2 * t + e >= n) acc[4 * j + e] = acc[4 * j + 2 + e] = -CUDART_INF_F;
}

// Bytes of the per-warp staging that store_rows needs for NB column blocks.
template <int NB>
constexpr int staging_bytes() {
  return 4 * 16 * (16 * NB + 16);
}

// Write the warpgroup's 64 x 8*NB f32 accumulator as bf16 rows row0.. of
// dst (row stride ld elements): row r0 times f0, r1 times f1, plus `extra`
// (bf16, row stride ld_extra) in f32 when given. Each warp rounds its 16
// rows to bf16 into its part of `stage` (rows padded by 16 bytes, so the 32
// lanes hit 32 banks) and copies them out 16 bytes a lane; rows >= n are
// not written. Warp-local: no block barrier.
template <int NB>
__device__ __forceinline__ void store_rows(const float (&acc)[4 * NB], float f0, float f1,
                                           const bf16* extra, size_t ld_extra,
                                           unsigned char* stage, bf16* dst, size_t ld, int row0,
                                           int n) {
  constexpr int RB = 16 * NB + 16;
  const int warp = threadIdx.x / 32 % 4, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  unsigned char* st = stage + warp * 16 * RB;
  const int wrow = row0 + warp * 16;
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    const int col = 8 * j + 2 * t;
    float a0 = acc[4 * j] * f0, a1 = acc[4 * j + 1] * f0;
    float b0 = acc[4 * j + 2] * f1, b1 = acc[4 * j + 3] * f1;
    if (extra != nullptr) {
      if (wrow + g < n) {
        const float2 e = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(extra + (size_t)(wrow + g) * ld_extra + col));
        a0 += e.x;
        a1 += e.y;
      }
      if (wrow + g + 8 < n) {
        const float2 e = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
            extra + (size_t)(wrow + g + 8) * ld_extra + col));
        b0 += e.x;
        b1 += e.y;
      }
    }
    *reinterpret_cast<uint32_t*>(st + g * RB + col * 2) = pack_bf16(a0, a1);
    *reinterpret_cast<uint32_t*>(st + (g + 8) * RB + col * 2) = pack_bf16(b0, b1);
  }
  __syncwarp();
  for (int i = lane; i < 16 * NB; i += 32) {
    const int r = i / NB, c = i % NB;
    if (wrow + r < n)
      *reinterpret_cast<uint4*>(dst + (size_t)(wrow + r) * ld + c * 8) =
          *reinterpret_cast<const uint4*>(st + r * RB + c * 16);
  }
  __syncwarp();
}

// ------------------------------------------- (key_dim, head_dim) = (36, 72)
//
// YOLOv10m's PSA heads. A head's q|k|v row is 144 bf16 (288 bytes): q at 0,
// k 72 bytes in (8-byte aligned only, so no TMA box and no 16-byte copy
// takes it), v 144 bytes in. 36 is not a multiple of wgmma's k-step of 16,
// and a 72-wide row is wider than a swizzle span. So the kernels of this
// pair copy their operands with cp.async into tiles of the layouts the
// (32, 64) and (32, 32) builds read:
// - a narrow operand (q or k, 36 columns) into a tile of 128-byte rows
//   (128-byte swizzle) whose columns 36..63 are zero: Q.K^T reduces over
//   three k-steps (48 columns, the last 12 zeros on both sides), and a
//   product that takes the tile MN-major is N = 64 wide, its columns past
//   35 zero;
// - a wide operand (v, dO: 72 columns) into a tile of its columns 0..63
//   (128-byte rows) and a tile of columns 64..71 in 64-byte rows (64-byte
//   swizzle) whose columns past 7 are zero: a reduction over it is four
//   k-steps of the first and one of the second, a product that takes it
//   MN-major is N = 64 on the first plus N = 32 on the second (8 useful).
namespace k36 {

constexpr int KD = 36, HD = 72, STRIDE = 2 * KD + HD;
constexpr int NARROW_PIECES = KD / 4;  // 8-byte pieces of a narrow row
constexpr int WIDE_CHUNKS = HD / 8;    // 16-byte chunks of a wide row

// Rows row0 .. row0 + rows - 1 of a narrow operand (row r at src + r * ld,
// 8-byte aligned) into the tile at shared address `tile`; rows >= n come
// in as zeros. Every thread of the block takes a share (128 threads).
__device__ __forceinline__ void load_narrow(uint32_t tile, const bf16* src, size_t ld, int row0,
                                            int rows, int n) {
  for (int e = threadIdx.x; e < rows * NARROW_PIECES; e += 128) {
    const int r = e / NARROW_PIECES, p = e % NARROW_PIECES, row = row0 + r;
    const bool live = row < n;
    cp_async8(tile + swizzled<128>(r, p >> 1) + (p & 1) * 8,
              src + (live ? (size_t)row * ld + 4 * p : 0), live ? 8 : 0);
  }
}

// The same for a wide operand (16-byte aligned rows) into its two tiles.
__device__ __forceinline__ void load_wide(uint32_t lo, uint32_t hi, const bf16* src, size_t ld,
                                          int row0, int rows, int n) {
  for (int e = threadIdx.x; e < rows * WIDE_CHUNKS; e += 128) {
    const int r = e / WIDE_CHUNKS, c = e % WIDE_CHUNKS, row = row0 + r;
    const bool live = row < n;
    cp_async16(c < 8 ? lo + swizzled<128>(r, c) : hi + swizzled<64>(r, 0),
               src + (live ? (size_t)row * ld + 8 * c : 0), live ? 16 : 0);
  }
}

// Zero the columns that no copy writes: a narrow tile's 36..63 (bytes
// 72..127), a wide high tile's 8..31 (bytes 16..63). Plain stores: the
// caller fences them to the async proxy before the first product.
__device__ __forceinline__ void zero_narrow_pad(unsigned char* tile, int rows) {
  for (int e = threadIdx.x; e < rows * 4; e += 128) {
    const int r = e / 4, c = 4 + e % 4;  // chunk 4's upper half, chunks 5-7
    unsigned char* at = tile + swizzled<128>(r, c);
    if (c == 4)
      *reinterpret_cast<uint2*>(at + 8) = make_uint2(0, 0);
    else
      *reinterpret_cast<uint4*>(at) = make_uint4(0, 0, 0, 0);
  }
}

__device__ __forceinline__ void zero_wide_pad(unsigned char* hi, int rows) {
  for (int e = threadIdx.x; e < rows * 3; e += 128) {
    const int r = e / 3, c = 1 + e % 3;
    *reinterpret_cast<uint4*>(hi + swizzled<64>(r, c)) = make_uint4(0, 0, 0, 0);
  }
}

// Write columns 8j + 2t + {0, 1} of rows g and g + 8 (this lane's part of
// accumulator block j: a0, a1 and b0, b1) as bf16 into a warp's staging
// rows of rb bytes, at column col0 + 8j, with `extra` (bf16 rows ld_extra
// apart, from the warp's first row; rows >= live not read) added in f32.
__device__ __forceinline__ void stage_pair(unsigned char* st, int rb, int col, float a0, float a1,
                                           float b0, float b1, const bf16* extra, size_t ld_extra,
                                           int live) {
  const int g = threadIdx.x % 32 / 4;
  if (extra != nullptr) {
    if (g < live) {
      const float2 e = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(extra + (size_t)g * ld_extra + col));
      a0 += e.x;
      a1 += e.y;
    }
    if (g + 8 < live) {
      const float2 e = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(extra + (size_t)(g + 8) * ld_extra + col));
      b0 += e.x;
      b1 += e.y;
    }
  }
  *reinterpret_cast<uint32_t*>(st + g * rb + col * 2) = pack_bf16(a0, a1);
  *reinterpret_cast<uint32_t*>(st + (g + 8) * rb + col * 2) = pack_bf16(b0, b1);
}

// Stage accumulator blocks 0 .. NB-1 of a 64 x 8*NB accumulator (row r0
// times f0, r1 times f1) at columns col0 .. of the warp's staging rows.
template <int NB>
__device__ __forceinline__ void stage_acc(unsigned char* st, int rb, int col0,
                                          const float (&acc)[4 * NB], int blocks, float f0,
                                          float f1, const bf16* extra, size_t ld_extra,
                                          int live) {
  const int t = threadIdx.x % 4;
#pragma unroll
  for (int j = 0; j < NB; ++j)
    if (j < blocks)
      stage_pair(st, rb, col0 + 8 * j + 2 * t, acc[4 * j] * f0, acc[4 * j + 1] * f0,
                 acc[4 * j + 2] * f1, acc[4 * j + 3] * f1, extra, ld_extra, live);
}

// Copy the warp's 16 staged rows, `bytes` bytes each (a multiple of 8), to
// dst (row stride ld elements, 8-byte aligned), rows below `live` only.
__device__ __forceinline__ void copy_staged(const unsigned char* st, int rb, bf16* dst, size_t ld,
                                            int bytes, int live) {
  const int lane = threadIdx.x % 32, per_row = bytes / 8;
  for (int i = lane; i < 16 * per_row; i += 32) {
    const int r = i / per_row, c = i % per_row;
    if (r < live)
      *reinterpret_cast<uint2*>(reinterpret_cast<unsigned char*>(dst + (size_t)r * ld) + 8 * c) =
          *reinterpret_cast<const uint2*>(st + r * rb + 8 * c);
  }
}

}  // namespace k36

}  // namespace hopper

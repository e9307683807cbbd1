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
// that decides a bit is computed with correctly rounded operations
// (__fsub_rn, __fmul_rn, __fadd_rn, __fdiv_rn are never contracted into
// FMAs, and the file is built with -fmad=false as well), in the same order
// as the elementwise PyTorch ops.
//
// What bounds it: the inputs are tiny (K=1000 boxes are 16 KB an image), so
// the bound is the ~K^2/2 pair tests, f32 work on the CUDA cores, and a walk
// over the K x ceil(K/32) suppression bitmask that is sequential by nature.
// The TPU kernel solved the recurrence by Jacobi iteration, a (1,K)x(K,K) MXU
// matvec per step. Here it is one launch with no global scratch: a
// thread-block cluster of C CTAs an image, C the largest cluster of which the
// card runs all B at once (the wrapper's nms_geometry).
//
// 1. Mask units. The upper triangle of the bitmask is cut into units of 32
//    rows x one 32-bit word, dealt round robin in row-major order to the
//    cluster's computing warps, so each warp gets the same share of long and
//    short rows. A computing CTA stages each box once, as a center and a
//    reach per axis. In a unit lane r tests row r against the 32 column
//    boxes (broadcast from shared memory) by a necessary condition: IoU >
//    thr needs |dc| < (1 - thr)(h_a + h_b) on both axes (IoU <= iw /
//    max(w_a, w_b) <= iw / mean(w_a, w_b)), with slack for rounding; four
//    adds and two compares a pair, the bit set in the lane's own register.
//    Only the candidates that pass are divided: the warp deals them out 32
//    at a time, each lane computing the exact IoU from the boxes in device
//    memory (L1). A pair that fails the test has an exact IoU <= thr, so its
//    bit is 0 either way. Lane r then stores row r's word, whole, straight
//    into rank 0's shared memory (st.async over distributed shared memory),
//    column-major (word w of row i at w*K + i, so the lanes' stores and the
//    walk's loads touch consecutive words). Each store completes its 4 bytes
//    on its row tile's mbarrier there, which rank 0 armed with the tile's
//    byte count: no fence, no counter, no second launch.
// 2. The walk, warp 0 of rank 0, overlapped with the mask units and alone on
//    its scheduler (rank 0's warps 4, 8, .. take no units). Word w needs row
//    tiles 0..w, which come first in the deal; the warp waits on tile w's
//    mbarrier. The removals in word w are column w of the kept earlier rows:
//    each lane ORs its own rows' words (it keeps which of them were kept in
//    two 32-bit registers, read 8 words at a time), one __reduce_or_sync
//    across the lanes. Then the word's greedy chain resolves by Jacobi
//    iteration in registers (kept = avail & ~OR of the kept rows' words, one
//    __reduce_or_sync a step, to the fixed point: the chain's depth plus one
//    steps, at most 32).
//
// Shared memory: rank 0 holds the row tiles' mbarriers (512 bytes), the
// bitmask and the validity, 512 + 4*K*ceil(K/32) + K bytes (227,648 at
// K=1344, the largest K under the card's 232,448 a block). When the staged
// boxes and the warps' words fit beside that, rank 0's other warps compute
// units as well (first = 0); otherwise only its peers do (first = 1). The
// wrapper's geometry function (ops/kernels/nms_suppress.py::nms_geometry)
// picks C, first and the bytes.
//
// Beyond K = 1344 rank 0's shared memory cannot hold the bitmask, and the
// wrapper picks the global-memory mapping (nms_suppress_global): two
// launches, simple and not tuned. nms_mask_global deals the same units to
// the warps of `blocks` CTAs an image, each warp staging its 32 column boxes
// in shared memory and computing the same candidates and exact IoUs, and
// writes each row's word into the image's K x ceil(K/32) bitmask in device
// memory (column-major as above; 2 MB an image at K = 4096), which the
// wrapper allocates. nms_walk_global, one warp an image, then walks it from
// device memory (L2) word by word as above, its kept words in shared memory.
// The mask is the same, bit for bit.
//
// The IoU threshold is an f32 in device memory, as the TPU kernel reads it
// from SMEM (thr_ref[0, 0]): a program may hold it as a runtime input, and
// a CUDA graph replays at whatever value that tensor holds. Each thread
// loads it once at its start (one broadcast load a warp); the pretest's
// reach and the exact test both use the loaded value.
//
// The launches allocate nothing. The C entries return cudaGetLastError()
// (or the refusal's code) so the Python wrapper can raise.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 1024;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_WORDS = 64;                 // header slots: K <= 2048
constexpr int HEAD_BYTES = 8 * MAX_WORDS;     // the row tiles' mbarriers
constexpr int SCRATCH_BYTES = WARPS * 32 * 4; // a warp's 32 candidate / hit words
constexpr int PAD = 32;                       // staged boxes past K: a row tile reads no bounds
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float box_area(float4 b) {
  return __fmul_rn(__fsub_rn(b.z, b.x), __fsub_rn(b.w, b.y));
}

// IoU(a, o) > thr, for the earlier box a, in the plain version's op order
__device__ __forceinline__ bool over(float4 a, float4 o, float thr) {
  const float iw = fmaxf(__fsub_rn(fminf(a.z, o.z), fmaxf(a.x, o.x)), 0.f);
  const float ih = fmaxf(__fsub_rn(fminf(a.w, o.w), fmaxf(a.y, o.y)), 0.f);
  const float inter = __fmul_rn(iw, ih);
  const float denom = __fadd_rn(__fsub_rn(__fadd_rn(box_area(a), box_area(o)), inter), 1e-7f);
  return __fdiv_rn(inter, denom) > thr;
}

// A box as (center x, center y, reach x, reach y): two boxes can have
// IoU > thr only where |center difference| < sum of reaches on both axes.
// The reach is (1 - thr) times the half width, plus slack of 1e-5 relative
// to the coordinates (far above the few ulps the centers, half widths and
// the test itself round by). A box with a non-finite coordinate reaches
// everywhere, so its pairs always go to the exact test.
__device__ __forceinline__ float4 reach_box(float4 b, float scale) {
  if (!(isfinite(b.x) && isfinite(b.y) && isfinite(b.z) && isfinite(b.w)))
    return make_float4(0.f, 0.f, INFINITY, INFINITY);
  const float cx = 0.5f * b.x + 0.5f * b.z, hx = 0.5f * b.z - 0.5f * b.x;
  const float cy = 0.5f * b.y + 0.5f * b.w, hy = 0.5f * b.w - 0.5f * b.y;
  return make_float4(cx, cy, scale * hx + 1e-5f * (fabsf(cx) + fabsf(hx)) + 1e-30f,
                     scale * hy + 1e-5f * (fabsf(cy) + fabsf(hy)) + 1e-30f);
}

// The position of the (n+1)-th set bit of x (n < popc(x)): the largest q
// with at most n set bits below it.
__device__ __forceinline__ int nth_bit(unsigned x, unsigned n) {
  int q = 0;
#pragma unroll
  for (int s = 16; s > 0; s >>= 1)
    if (static_cast<unsigned>(__popc(x & ((1u << (q + s)) - 1u))) <= n) q += s;
  return q;
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// The address of this CTA's shared-memory byte `addr` in CTA `rank` of the cluster.
__device__ __forceinline__ unsigned cluster_addr(unsigned addr, unsigned rank) {
  unsigned out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

// Store v at a cluster address; its 4 bytes complete a transaction on the
// mbarrier at cluster address bar (both in the same CTA).
__device__ __forceinline__ void store_async(unsigned addr, unsigned v, unsigned bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.u32 [%0], %1, [%2];"
               ::"r"(addr), "r"(v), "r"(bar) : "memory");
}

// Wait until the mbarrier's phase 0 has completed: every byte of its row tile
// has landed. A tile that never completes traps (the launch fails) instead
// of hanging the card.
__device__ __forceinline__ void wait_tile(unsigned bar) {
  for (unsigned spins = 0;; ++spins) {
    unsigned done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar) : "memory");
    if (done) return;
    if (spins == (1u << 24)) __trap();
  }
}

__host__ __device__ inline long long walker_bytes(int k) {
  return HEAD_BYTES + 4LL * k * ((k + 31) / 32) + k;
}

__host__ __device__ inline long long box_offset(int k) {  // rank 0's boxes when first == 0
  return (walker_bytes(k) + 15) / 16 * 16;
}

long long required_bytes(int k, int first) {
  const long long boxes = 16LL * (k + PAD) + SCRATCH_BYTES;  // staged boxes, warps' words
  if (first == 0) return box_offset(k) + boxes;
  return walker_bytes(k) > boxes + k ? walker_bytes(k) : boxes + k;
}

__global__ void __launch_bounds__(THREADS, 1)
nms_kernel(const float4* __restrict__ boxes, const unsigned char* __restrict__ valid,
           unsigned char* __restrict__ keep, int k, const float* __restrict__ thr_at,
           int first, long long* __restrict__ stamps) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int csize = static_cast<int>(cluster.num_blocks());
  const size_t img = blockIdx.x / csize;
  const int words = (k + 31) / 32;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const long long t0 = clock64();
  const float thr = __ldg(thr_at);

  // this CTA's layout (byte offsets); see the header note
  const bool stages = rank >= first;
  long long ok_off = HEAD_BYTES + 4LL * k * words, box_off = 0;
  if (first == 0) box_off = box_offset(k);
  else if (rank > 0) ok_off = 16LL * (k + PAD) + SCRATCH_BYTES;
  unsigned char* ok = smem + ok_off;
  float4* reach = reinterpret_cast<float4*>(smem + box_off);
  unsigned* hits = reinterpret_cast<unsigned*>(reach + k + PAD) + 32 * warp;
  // tile + 8 * rt: row tile rt's mbarrier, complete when the tile's words,
  // 4 * rows * (words - rt) bytes, have all arrived
  const unsigned tile = smem_u32(smem);

  const float4* img_boxes = boxes + img * k;
  const float scale = fmaxf(1.f - thr, 0.f) + 1e-5f;
  for (int t = threadIdx.x; t < k + PAD; t += THREADS) {
    if (t < k) ok[t] = valid[img * k + t];
    if (stages) reach[t] = t < k ? reach_box(img_boxes[t], scale) : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  if (stages) hits[lane] = 0u;
  if (rank == 0) {
    for (int rt = threadIdx.x; rt < words; rt += THREADS) {
      const unsigned bar = tile + 8 * rt;
      const unsigned bytes = 4u * min(32, k - 32 * rt) * (words - rt);
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar) : "memory");
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
                   "r"(bytes) : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  cluster.sync();  // every CTA of the cluster runs and has staged its inputs

  // 1. mask units: unit u = (row tile rt, word w >= rt), row-major over the
  // upper triangle, dealt round robin to the computing warps: every warp of
  // the peers and, when rank 0 stages boxes, its warps off the walker's
  // scheduler (warp % 4 picks an SM's scheduler): the walk is a chain of
  // short dependent steps, and it runs at full speed only alone there
  const int own_warps = first ? 0 : WARPS - WARPS / 4;  // rank 0's computing warps
  const int slot = rank == 0 ? (warp % 4 ? warp - warp / 4 - 1 : -1)
                             : own_warps + (rank - 1) * WARPS + warp;
  if (rank >= first && slot >= 0) {
    const unsigned bits = cluster_addr(smem_u32(smem + HEAD_BYTES), 0);
    const unsigned tiles = cluster_addr(tile, 0);
    const int units = words * (words + 1) / 2;
    const int stride = own_warps + (csize - 1) * WARPS;
    int rt = 0, rest = slot;  // u = offset(rt) + rest
    for (int u = rest; u < units; u += stride, rest += stride) {
      while (rest >= words - rt) {  // row tile rt holds words - rt units
        rest -= words - rt;
        ++rt;
      }
      const int w = rt + rest;
      const int r0 = 32 * rt;
      const int i = r0 + lane;  // this lane's row
      // (a) candidates by the necessary test, lane r testing row r against
      // the 32 column boxes (broadcast), masked to valid rows and columns
      // and, on the diagonal, to the columns after the row. With thr < 0
      // every pair is one.
      unsigned cand = FULL;
      if (thr >= 0.f) {
        const float4 a = reach[i];
        cand = 0u;
#pragma unroll
        for (int c = 0; c < 32; ++c) {
          const float4 o = reach[32 * w + c];
          if (fabsf(a.x - o.x) < a.z + o.z && fabsf(a.y - o.y) < a.w + o.w) cand |= 1u << c;
        }
      }
      const unsigned cols = __ballot_sync(FULL, 32 * w + lane < k && ok[32 * w + lane]);
      cand &= (i < k && ok[i]) ? cols : 0u;
      if (w == rt) cand &= ~((2u << lane) - 1u);
      // (b) the exact test, for the candidates only, 32 at a time: candidate
      // n is bit n - before(r) of row r's word, where before(r) counts the
      // candidates of the rows above r
      const unsigned count = __popc(cand);
      unsigned upto = count;  // inclusive prefix sum over the rows
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const unsigned v = __shfl_up_sync(FULL, upto, d);
        if (lane >= d) upto += v;
      }
      const unsigned total = __shfl_sync(FULL, upto, 31);
      for (unsigned base = 0; base < total; base += 32) {
        const unsigned n = base + lane;
        int r = 0;  // the rows whose prefix sum is <= n
#pragma unroll
        for (int s = 16; s > 0; s >>= 1)
          if (__shfl_sync(FULL, upto, r + s - 1) <= n) r += s;
        const unsigned row_word = __shfl_sync(FULL, cand, r);
        const unsigned before = __shfl_sync(FULL, upto - count, r);
        if (n < total) {
          const int col = nth_bit(row_word, n - before);
          if (over(__ldg(img_boxes + r0 + r), __ldg(img_boxes + 32 * w + col), thr))
            atomicOr(&hits[r], 1u << col);
        }
      }
      __syncwarp();
      if (i < k) store_async(bits + 4u * (w * k + i), hits[lane], tiles + 8 * rt);
      __syncwarp();
      hits[lane] = 0u;  // for the next unit's exact tests
      __syncwarp();
    }
  }
  if (rank != 0 || warp != 0) return;

  // 2. the walk, by warp 0 of rank 0, word by word as the row tiles arrive.
  // Bit v of lane t's mine_lo (v < 32) or mine_hi (v - 32): row 32v + t was kept.
  const unsigned* bits = reinterpret_cast<const unsigned*>(smem + HEAD_BYTES);
  unsigned mine_lo = 0u, mine_hi = 0u;
  long long waited = 0, mask_done = 0;
  for (int w = 0; w < words; ++w) {
    const long long t = clock64();
    wait_tile(tile + 8 * w);  // row tiles 0..w are in: tile w came last
    mask_done = clock64();
    waited += mask_done - t;
    const int row = 32 * w + lane;
    // the removals in word w: column w of every kept earlier row, ORed by
    // each lane over its rows, then across the lanes
    unsigned acc = 0u;
    for (int v0 = 0; v0 < w; v0 += 8) {
      const unsigned chunk = (v0 < 32 ? mine_lo : mine_hi) >> (v0 & 31);
      const unsigned* col = bits + static_cast<size_t>(w) * k + 32 * v0 + lane;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (v0 + j < w && ((chunk >> j) & 1u)) acc |= col[32 * j];
    }
    const unsigned own = row < k ? bits[static_cast<size_t>(w) * k + row] : 0u;
    const unsigned avail =
        __ballot_sync(FULL, row < k && ok[row]) & ~__reduce_or_sync(FULL, acc);
    // greedy within the word: Jacobi to the fixed point, which is unique
    // (row t's bit depends only on rows < t) and reached once the chain of
    // suppressions is resolved, at most 32 steps
    unsigned kept = avail;
    for (int step = 0; step < 32; ++step) {
      const unsigned next = avail & ~__reduce_or_sync(FULL, ((kept >> lane) & 1u) ? own : 0u);
      if (next == kept) break;
      kept = next;
    }
    if (row < k) keep[img * k + row] = (kept >> lane) & 1u;
    if (w < 32) mine_lo |= ((kept >> lane) & 1u) << w;
    else mine_hi |= ((kept >> lane) & 1u) << (w - 32);
  }
  if (stamps != nullptr && threadIdx.x == 0) {  // SM clocks of rank 0, for the phase split
    stamps[3 * img] = mask_done - t0;      // to the last row tile's arrival
    stamps[3 * img + 1] = clock64() - t0;  // the whole kernel
    stamps[3 * img + 2] = waited;          // of it, the walker waiting for row tiles
  }
}

// ------------------------------------------- K > 1344: bitmask in device memory

constexpr int G_THREADS = 256;
constexpr int G_WARPS = G_THREADS / 32;

// The bitmask of image blockIdx.y: the upper triangle's units dealt round
// robin to the warps of the image's gridDim.x CTAs, as in nms_kernel's
// phase 1; row i's word w at bits[img][w * k + i].
__global__ void __launch_bounds__(G_THREADS)
nms_mask_global(const float4* __restrict__ boxes, const unsigned char* __restrict__ valid,
                unsigned* __restrict__ bits, int k, const float* __restrict__ thr_at) {
  __shared__ float4 cols_s[G_WARPS][32];
  __shared__ unsigned hits_s[G_WARPS][32];
  const size_t img = blockIdx.y;
  const int words = (k + 31) / 32;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const float4* img_boxes = boxes + img * k;
  const unsigned char* ok = valid + img * k;
  unsigned* out = bits + img * words * static_cast<size_t>(k);
  float4* cols = cols_s[warp];
  unsigned* hits = hits_s[warp];
  const float thr = __ldg(thr_at);
  const float scale = fmaxf(1.f - thr, 0.f) + 1e-5f;
  hits[lane] = 0u;
  const long long units = static_cast<long long>(words) * (words + 1) / 2;
  const int stride = gridDim.x * G_WARPS;
  int rt = 0;
  long long rest = static_cast<long long>(blockIdx.x) * G_WARPS + warp;  // u = offset(rt) + rest
  for (long long u = rest; u < units; u += stride, rest += stride) {
    while (rest >= words - rt) {  // row tile rt holds words - rt units
      rest -= words - rt;
      ++rt;
    }
    const int w = rt + static_cast<int>(rest);
    const int r0 = 32 * rt;
    const int i = r0 + lane;  // this lane's row
    const int c = 32 * w + lane;  // this lane's column box
    // (a) candidates by the necessary test against the warp's 32 column boxes
    unsigned cand = FULL;
    if (thr >= 0.f) {
      const float4 a = i < k ? reach_box(img_boxes[i], scale) : make_float4(0.f, 0.f, 0.f, 0.f);
      __syncwarp();  // the previous unit is done with cols
      cols[lane] = c < k ? reach_box(img_boxes[c], scale) : make_float4(0.f, 0.f, 0.f, 0.f);
      __syncwarp();
      cand = 0u;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const float4 o = cols[j];
        if (fabsf(a.x - o.x) < a.z + o.z && fabsf(a.y - o.y) < a.w + o.w) cand |= 1u << j;
      }
    }
    const unsigned col_ok = __ballot_sync(FULL, c < k && ok[c]);
    cand &= (i < k && ok[i]) ? col_ok : 0u;
    if (w == rt) cand &= ~((2u << lane) - 1u);
    // (b) the exact test for the candidates, 32 at a time, as in nms_kernel
    const unsigned count = __popc(cand);
    unsigned upto = count;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const unsigned v = __shfl_up_sync(FULL, upto, d);
      if (lane >= d) upto += v;
    }
    const unsigned total = __shfl_sync(FULL, upto, 31);
    for (unsigned base = 0; base < total; base += 32) {
      const unsigned n = base + lane;
      int r = 0;
#pragma unroll
      for (int s = 16; s > 0; s >>= 1)
        if (__shfl_sync(FULL, upto, r + s - 1) <= n) r += s;
      const unsigned row_word = __shfl_sync(FULL, cand, r);
      const unsigned before = __shfl_sync(FULL, upto - count, r);
      if (n < total) {
        const int col = nth_bit(row_word, n - before);
        if (over(__ldg(img_boxes + r0 + r), __ldg(img_boxes + 32 * w + col), thr))
          atomicOr(&hits[r], 1u << col);
      }
    }
    __syncwarp();
    if (i < k) out[static_cast<size_t>(w) * k + i] = hits[lane];
    __syncwarp();
    hits[lane] = 0u;
    __syncwarp();
  }
}

// The walk of nms_kernel's phase 2 over image blockIdx.x's bitmask in
// device memory, by one warp; kept[v] (shared) holds which rows of word v
// were kept.
__global__ void __launch_bounds__(32)
nms_walk_global(const unsigned* __restrict__ bits, const unsigned char* __restrict__ valid,
                unsigned char* __restrict__ keep, int k) {
  extern __shared__ unsigned kept_words[];
  const size_t img = blockIdx.x;
  const int words = (k + 31) / 32;
  const int lane = threadIdx.x;
  const unsigned* mask = bits + img * words * static_cast<size_t>(k);
  for (int w = 0; w < words; ++w) {
    const unsigned* col = mask + static_cast<size_t>(w) * k + lane;  // word w of rows lane + 32v
    unsigned acc = 0u;
#pragma unroll 8
    for (int v = 0; v < w; ++v)
      if ((kept_words[v] >> lane) & 1u) acc |= col[32 * v];
    const int row = 32 * w + lane;
    const unsigned own = row < k ? col[32 * w] : 0u;
    const unsigned avail =
        __ballot_sync(FULL, row < k && valid[img * k + row]) & ~__reduce_or_sync(FULL, acc);
    unsigned kept = avail;
    for (int step = 0; step < 32; ++step) {
      const unsigned next = avail & ~__reduce_or_sync(FULL, ((kept >> lane) & 1u) ? own : 0u);
      if (next == kept) break;
      kept = next;
    }
    if (row < k) keep[img * k + row] = (kept >> lane) & 1u;
    if (lane == 0) kept_words[w] = kept;
    __syncwarp();
  }
}

// Once a process: allow the kernel the card's opt-in shared memory a block.
cudaError_t set_smem_attribute() {
  static const cudaError_t err = [] {
    int dev = 0, optin = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(nms_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    return e;
  }();
  return err;
}

void make_config(cudaLaunchConfig_t& cfg, cudaLaunchAttribute* attr, int clusters, int cluster,
                 int smem, cudaStream_t s) {
  cfg = cudaLaunchConfig_t{};
  cfg.gridDim = dim3(static_cast<unsigned>(clusters * cluster));
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = s;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(cluster);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
}

}  // namespace

// boxes (B, K, 4) f32, valid (B, K) bool, keep (B, K) bool, thr one f32 in
// device memory (the IoU threshold); the geometry
// (cluster size, first computing rank, dynamic shared memory bytes) from the
// wrapper; stamps (B, 3) int64 SM clocks or null. Returns 0 on a good launch,
// else the CUDA error code.
extern "C" int nms_suppress(const void* boxes, const void* valid, void* keep, int b, int k,
                            const void* thr, int cluster, int first, int smem, void* stamps,
                            void* stream) {
  if (thr == nullptr || b < 1 || k < 1 || k > 32 * MAX_WORDS || cluster < 1 || cluster > 8 ||
      (first != 0 && first != 1) || cluster <= first || smem < required_bytes(k, first))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = set_smem_attribute();
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  make_config(cfg, attr, b, cluster, smem, static_cast<cudaStream_t>(stream));
  err = cudaLaunchKernelEx(&cfg, nms_kernel, static_cast<const float4*>(boxes),
                           static_cast<const unsigned char*>(valid),
                           static_cast<unsigned char*>(keep), k, static_cast<const float*>(thr),
                           first,
                           static_cast<long long*>(stamps));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The global-memory mapping for any K: boxes (B, K, 4) f32, valid and keep
// (B, K) bool, thr one f32 in device memory, bits (B, ceil(K/32) * K) u32
// scratch from the wrapper, `blocks`
// mask CTAs an image, `smem` the walk's 4 * ceil(K/32) bytes. Returns 0 on
// good launches, else the CUDA error code.
extern "C" int nms_suppress_global(const void* boxes, const void* valid, void* keep, void* bits,
                                   int b, int k, const void* thr, int blocks, int smem,
                                   void* stream) {
  if (thr == nullptr || b < 1 || b > 65535 || k < 1 || blocks < 1 || smem < 4 * ((k + 31) / 32))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (smem > 48 * 1024) {
    // once a process would pin the first K's size: set it for each larger walk
    const cudaError_t e = cudaFuncSetAttribute(
        nms_walk_global, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  nms_mask_global<<<dim3(static_cast<unsigned>(blocks), static_cast<unsigned>(b)), G_THREADS, 0,
                    s>>>(static_cast<const float4*>(boxes),
                         static_cast<const unsigned char*>(valid), static_cast<unsigned*>(bits), k,
                         static_cast<const float*>(thr));
  nms_walk_global<<<b, 32, smem, s>>>(static_cast<const unsigned*>(bits),
                                      static_cast<const unsigned char*>(valid),
                                      static_cast<unsigned char*>(keep), k);
  return static_cast<int>(cudaGetLastError());
}

// How many clusters of this geometry the card holds at once
// (cudaOccupancyMaxActiveClusters), into *out. Returns the CUDA error code.
extern "C" int nms_suppress_max_active_clusters(int cluster, int smem, int* out) {
  cudaError_t err = set_smem_attribute();
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  make_config(cfg, attr, 1, cluster, smem, nullptr);
  return static_cast<int>(cudaOccupancyMaxActiveClusters(out, nms_kernel, &cfg));
}

// Train-mode BatchNorm with its optional SiLU for Hopper (sm_90a), bound to
// Python through ctypes.
//
// Replaces no TPU kernel: the JAX package's BatchNorm is flax's, which XLA
// fuses on the TPU. It was added because PyTorch's own train-mode BatchNorm
// on a channels_last input runs four kernels (collect_statistics,
// transform_input, backward_reduce, backward_elemt), the SiLU after it two
// more passes, and the flax running statistics six small launches: in a
// b32/640 train step on an H100 that was 29-36% of the step, 2.6-3.2 x the
// bound of the fused work.
//
// What bounds it: bytes. With S the bytes of one BatchNorm's output, the
// forward reads x twice and writes z (3S), the backward reads dz and x twice
// and writes dx (5S). The SiLU's input is not stored: the backward computes
// it again from x and the statistics. Small tensors are bound by latency
// instead: a launch, a round of loads, and the reduction's tail, each a few
// microseconds.
//
// The input is channels_last, so it is a row-major (M = N*H*W, C) matrix
// whose rows may be strided (ld >= C, as a channel slice of a larger
// tensor). Every kernel maps threads the same way: a block covers a tile of
// TCX * V channels (V channels a thread, one 16-byte load: 8 bf16 or 4 f32;
// V = 1 for a C the vector does not divide; TCX a power of two, its lanes
// past C idle) and RY rows at once, and walks its row block's rows RY
// apart, U loads in flight a thread. The grid is (channel tiles, row
// blocks), sized by the wrapper (ops/kernels/batch_norm_act.py::plan) from
// M and C.
//
//   forward
//   1. dyd_bn_stats: each thread sums, in f32, its channels' values and
//      squares shifted by the block's first row (one shift for the block,
//      so its threads add, by warp shuffles and then across the warps, in a
//      fixed order), and the block writes one Welford partial (mean, M2) a
//      channel. The partials merge in one level, or two where the tile has
//      more than 64 row blocks, each in a fixed order: the last block of
//      each group of at most 64 row blocks to finish (a ticket from a
//      counter in this library's device memory, reset by that block) merges
//      the group's partials, and the last group of the tile merges the
//      groups'. A merge shifts every partial by the first one's mean, so
//      Chan's formula is plain sums of count * offset and M2 + count *
//      offset^2. The last merge writes the mean and 1/sqrt(biased var +
//      eps) and, with `update`, moves the running mean and running variance
//      toward the batch mean and the biased variance (flax: running = keep
//      * running + take * batch).
//   2. dyd_bn_apply: z = silu((x - mean) * (invstd * w) + b), or without
//      the activation, in the input's dtype, rounded once.
//   backward
//   3. dyd_bn_bwd_reduce: from dz and x, with y = x_hat * w + b and
//      g = dz * silu'(y) (g = dz without the activation), the sums of g and
//      g * x_hat per channel, merged as in 1 (plain sums, a fixed order);
//      the last merge writes d_bias = sum g and d_weight = sum g * x_hat.
//   4. dyd_bn_bwd_elemt: dx = w * invstd * (g - sum g / M - x_hat * sum
//      g x_hat / M), in the input's dtype.
// Each level of a merge costs a fence, an atomic and a round of loads,
// about 3 us on an H100: on small tensors that tail is most of a reduction
// kernel's time.
//
// No float atomics: a graph replay and an eager call give the same bits.
// The ticket counters make one kernel of each kind at a time on a device a
// rule (one stream), as the port's train step runs them.
//
// Arithmetic in f32: sigmoid as 1 / (1 + exp(-y)) with the fast exp and
// division (a few f32 ulps; the output is bf16 on the train path), the
// statistics with IEEE division and square root. Built with nvcc's default
// contraction, as PyTorch's own elementwise kernels are.
//
// The launches allocate nothing: the wrapper gives the partials' scratch. The
// C entries return cudaGetLastError() so the Python wrapper can raise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;       // a block's threads
constexpr int MAX_TILE = 64;       // channels a tile holds at most
constexpr int MAX_TILES = 4096;
constexpr int MAX_GROUPS = 65536;  // tiles * groups
constexpr int MAX_MERGE = 64;      // partials a merge takes at most
constexpr int U = 4;               // row loads in flight a thread
constexpr unsigned FULL = 0xffffffffu;

__device__ unsigned int stats_group_tickets[MAX_GROUPS];
__device__ unsigned int stats_tile_tickets[MAX_TILES];
__device__ unsigned int reduce_group_tickets[MAX_GROUPS];
__device__ unsigned int reduce_tile_tickets[MAX_TILES];

struct Geo {
  int m;      // rows, N * H * W
  int c;      // channels
  int ld_x;   // row stride of x (elements)
  int ld_dz;  // row stride of dz (elements), backward
  int tcx;    // threads across a tile's channels
  int ry;     // rows a block takes at once
  int rows;   // rows of a row block
  int group;  // row blocks a first-level merge takes
};

// V elements of one row: one 16-byte load (V > 1) or one element.
template <typename T, int V>
struct Io;

template <>
struct Io<__nv_bfloat16, 8> {
  using Raw = uint4;
  __device__ static Raw load(const __nv_bfloat16* p) { return *reinterpret_cast<const uint4*>(p); }
  __device__ static void unpack(const Raw& r, float (&v)[8]) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
  __device__ static void store(__nv_bfloat16* p, const float (&v)[8]) {
    uint4 r;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = r;
  }
};

template <>
struct Io<float, 4> {
  using Raw = float4;
  __device__ static Raw load(const float* p) { return *reinterpret_cast<const float4*>(p); }
  __device__ static void unpack(const Raw& r, float (&v)[4]) {
    v[0] = r.x;
    v[1] = r.y;
    v[2] = r.z;
    v[3] = r.w;
  }
  __device__ static void store(float* p, const float (&v)[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <>
struct Io<__nv_bfloat16, 1> {
  using Raw = __nv_bfloat16;
  __device__ static Raw load(const __nv_bfloat16* p) { return *p; }
  __device__ static void unpack(const Raw& r, float (&v)[1]) { v[0] = __bfloat162float(r); }
  __device__ static void store(__nv_bfloat16* p, const float (&v)[1]) {
    *p = __float2bfloat16_rn(v[0]);
  }
};

template <>
struct Io<float, 1> {
  using Raw = float;
  __device__ static Raw load(const float* p) { return *p; }
  __device__ static void unpack(const Raw& r, float (&v)[1]) { v[0] = r; }
  __device__ static void store(float* p, const float (&v)[1]) { *p = v[0]; }
};

// silu(y) = y / (1 + exp(-y)); -0 where exp(-y) overflows
__device__ __forceinline__ float silu(float y) { return __fdividef(y, 1.0f + __expf(-y)); }

// g = dz * silu'(y), silu'(y) = s * (1 + y * (1 - s)), s = sigmoid(y)
__device__ __forceinline__ float silu_grad(float dz, float y) {
  const float s = __fdividef(1.0f, 1.0f + __expf(-y));
  return dz * (s * (1.0f + y * (1.0f - s)));
}

// The thread's place: its channels' first index (c0) and whether it has
// any (the last tile's lanes past C have none), its row in the block (ty),
// and its row block's rows [r0, r1).
struct Place {
  int c0, ty, r0, r1;
  bool on;
};

template <int V>
__device__ __forceinline__ Place place(const Geo& g) {
  Place p;
  const int tx = threadIdx.x % g.tcx;
  p.ty = threadIdx.x / g.tcx;
  p.c0 = (blockIdx.x * g.tcx + tx) * V;
  p.on = p.c0 < g.c;
  p.r0 = blockIdx.y * g.rows;
  p.r1 = min(g.m, p.r0 + g.rows);
  return p;
}

// the largest power of two not above n (n >= 1)
__device__ __forceinline__ int floor_pow2(int n) { return 1 << (31 - __clz(n)); }

// the rows of row blocks [first, first + count)
__device__ __forceinline__ float span_rows(const Geo& g, int first, int count) {
  return static_cast<float>(min(g.m, (first + count) * g.rows) - first * g.rows);
}

__device__ __forceinline__ int groups(const Geo& g) {
  return (static_cast<int>(gridDim.y) + g.group - 1) / g.group;
}

// Sum the block's threads' V values a and b over ty, in a fixed order:
// down each warp's rows by shuffles (tcx is a power of two up to 32, so a
// warp holds whole rows), then over the warps through shared memory s (2 *
// 8 * MAX_TILE floats). Thread ty == 0 of each tx ends with the totals.
template <int V>
__device__ __forceinline__ void rows_sum(const Geo& g, int ty, float (&a)[V], float (&b)[V],
                                         float* s) {
  for (int off = 16; off >= g.tcx; off >>= 1) {
#pragma unroll
    for (int v = 0; v < V; ++v) {
      a[v] += __shfl_down_sync(FULL, a[v], off);
      b[v] += __shfl_down_sync(FULL, b[v], off);
    }
  }
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32, warps = blockDim.x / 32;
  if (lane < g.tcx) {
#pragma unroll
    for (int v = 0; v < V; ++v) {
      s[(warp * g.tcx + lane) * V + v] = a[v];
      s[((warps + warp) * g.tcx + lane) * V + v] = b[v];
    }
  }
  __syncthreads();
  if (ty == 0) {  // warp 0's lanes below tcx
    for (int w = 1; w < warps; ++w) {
#pragma unroll
      for (int v = 0; v < V; ++v) {
        a[v] += s[(w * g.tcx + lane) * V + v];
        b[v] += s[((warps + w) * g.tcx + lane) * V + v];
      }
    }
  }
}

// A ticket from counter `at` of `n` arrivals, after the threads that
// `wrote` partials fenced them: true in the block that takes the last one,
// which resets the counter and may then read what the others wrote.
__device__ __forceinline__ bool last_of(unsigned int* at, unsigned int n, bool wrote) {
  __shared__ int last;
  if (wrote) __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    last = atomicAdd(at, 1u) == n - 1;
    if (last) *at = 0;
  }
  __syncthreads();
  if (last) __threadfence();
  return last;
}

// The tile's channels [cb, cb + width) and, for this thread of a merging
// block, its channel slot (w < width when it has one) and its place p among
// the `per` threads that share a channel.
struct Merge {
  int cb, width, per, w, p;
  __device__ bool holds() const { return p == 0 && w < width; }
};

template <int V>
__device__ __forceinline__ Merge merge_place(const Geo& g) {
  Merge q;
  q.cb = blockIdx.x * g.tcx * V;
  q.width = min(g.c - q.cb, g.tcx * V);
  q.per = floor_pow2(max(1, static_cast<int>(blockDim.x) / q.width));
  q.w = threadIdx.x / q.per;
  q.p = threadIdx.x % q.per;
  return q;
}

// Merge the partials [first, first + count) (count <= MAX_MERGE) of the
// planes a and b (channel stride c) for the tile's channels; the threads
// that hold() a channel end with the result in ra, rb. WELFORD: (mean, M2)
// partials of rows(i) rows each, `total` in all -> the merged (mean, M2),
// shifted by the first partial's mean; else sums. s holds 2 * blockDim.x
// floats.
template <bool WELFORD, typename Rows>
__device__ __forceinline__ void merge(const Merge& q, const float* a, const float* b, int c,
                                      int first, int count, float total, Rows rows, float* s,
                                      float& ra, float& rb) {
  constexpr int J = MAX_MERGE / 4;  // per >= 4: each thread's partials, loaded at once
  const int ch = q.cb + q.w;
  float s1 = 0.0f, s2 = 0.0f, shift = 0.0f;
  if (q.w < q.width) {
    float va[J], vb[J];
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int i = q.p + j * q.per;
      if (i < count) {
        const size_t at = static_cast<size_t>(first + i) * c + ch;
        va[j] = __ldcg(a + at);
        vb[j] = __ldcg(b + at);
      }
    }
    if (WELFORD) shift = __ldcg(a + static_cast<size_t>(first) * c + ch);
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int i = q.p + j * q.per;
      if (i < count) {
        if (WELFORD) {
          const float n = rows(first + i);
          const float d = va[j] - shift;
          s1 += n * d;
          s2 += vb[j] + n * d * d;
        } else {
          s1 += va[j];
          s2 += vb[j];
        }
      }
    }
  }
  const int t = threadIdx.x;
  s[t] = s1;
  s[blockDim.x + t] = s2;
  __syncthreads();
  for (int k = q.per / 2; k > 0; k >>= 1) {
    if (q.p < k && q.w < q.width) {
      s1 += s[t + k];
      s2 += s[blockDim.x + t + k];
      s[t] = s1;
      s[blockDim.x + t] = s2;
    }
    __syncthreads();
  }
  if (WELFORD) {
    const float off = s1 / total;
    ra = shift + off;
    rb = s2 - s1 * off;
  } else {
    ra = s1;
    rb = s2;
  }
}

// The merge of the block partials part[0 : gy*c] (a) and part[gy*c :
// 2*gy*c] (b) that the threads which `wrote` them wrote: in one level, or in
// two with the groups' partials after the blocks'. True in the one block of
// the tile that ends with the tile's result, which its threads that hold()
// a channel have in ra, rb.
template <bool WELFORD>
__device__ __forceinline__ bool merge_tile(const Geo& g, const Merge& q, float* part, bool wrote,
                                           unsigned int* group_tickets,
                                           unsigned int* tile_tickets, float* s, float& ra,
                                           float& rb) {
  const int gy = gridDim.y, c = g.c, group = g.group, ng = groups(g), grp = blockIdx.y / group;
  const int first = grp * group, count = min(group, gy - first);
  if (!last_of(group_tickets + blockIdx.x * ng + grp, count, wrote)) return false;
  const size_t plane = static_cast<size_t>(gy) * c;
  auto block_rows = [&g](int i) { return span_rows(g, i, 1); };
  merge<WELFORD>(q, part, part + plane, c, first, count, span_rows(g, first, count), block_rows,
                 s, ra, rb);
  if (ng == 1) return true;
  float* ga = part + 2 * plane;
  float* gb = ga + static_cast<size_t>(ng) * c;
  if (q.holds()) {
    ga[static_cast<size_t>(grp) * c + q.cb + q.w] = ra;
    gb[static_cast<size_t>(grp) * c + q.cb + q.w] = rb;
  }
  if (!last_of(tile_tickets + blockIdx.x, ng, q.holds())) return false;
  auto group_rows = [&g, gy, group](int i) {
    return span_rows(g, i * group, min(group, gy - i * group));
  };
  merge<WELFORD>(q, ga, gb, c, 0, ng, static_cast<float>(g.m), group_rows, s, ra, rb);
  return true;
}

// The statistics from a channel's merged (mean, M2), and the running update.
__device__ __forceinline__ void finish_stats(const Geo& g, int ch, float mean, float m2,
                                             float* mean_out, float* invstd_out, float* run_mean,
                                             float* run_var, int update, float eps, float keep,
                                             float take) {
  const float var = fmaxf(m2 / static_cast<float>(g.m), 0.0f);
  mean_out[ch] = mean;
  invstd_out[ch] = 1.0f / sqrtf(var + eps);
  if (update) {
    run_mean[ch] = run_mean[ch] * keep + take * mean;
    run_var[ch] = run_var[ch] * keep + take * var;
  }
}

// A thread's channels' constants for the backward: x_hat = (x - mu) * is,
// y = x_hat * w + b.
template <int V>
struct Consts {
  float mu[V], is[V], w[V], b[V];
};

template <int V>
__device__ __forceinline__ void load_consts(Consts<V>& k, int c0, const float* mean,
                                            const float* invstd, const float* w, const float* b) {
#pragma unroll
  for (int v = 0; v < V; ++v) {
    k.mu[v] = mean[c0 + v];
    k.is[v] = invstd[c0 + v];
    k.w[v] = w[c0 + v];
    k.b[v] = b[c0 + v];
  }
}

}  // namespace

// 1. per-channel statistics; the tile's last merge writes mean and invstd
// and moves the running statistics.
template <typename T, int V>
__global__ void __launch_bounds__(THREADS) dyd_bn_stats(
    const T* __restrict__ x, Geo g, float* __restrict__ part, float* __restrict__ mean_out,
    float* __restrict__ invstd_out, float* __restrict__ run_mean, float* __restrict__ run_var,
    int update, float eps, float keep, float take) {
  using I = Io<T, V>;
  __shared__ float sm[2 * 8 * MAX_TILE];
  const Place at = place<V>(g);
  float k[V], s1[V], s2[V];
#pragma unroll
  for (int v = 0; v < V; ++v) k[v] = s1[v] = s2[v] = 0.0f;
  if (at.on) {
    I::unpack(I::load(x + static_cast<size_t>(at.r0) * g.ld_x + at.c0), k);  // the shift
    for (int r = at.r0 + at.ty; r < at.r1; r += U * g.ry) {
      typename I::Raw raw[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int rr = r + u * g.ry;
        if (rr < at.r1) raw[u] = I::load(x + static_cast<size_t>(rr) * g.ld_x + at.c0);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (r + u * g.ry < at.r1) {
          float xv[V];
          I::unpack(raw[u], xv);
#pragma unroll
          for (int v = 0; v < V; ++v) {
            const float d = xv[v] - k[v];
            s1[v] += d;
            s2[v] += d * d;
          }
        }
      }
    }
  }
  rows_sum<V>(g, at.ty, s1, s2, sm);
  const bool wrote = at.ty == 0 && at.on;
  if (wrote) {
    const size_t plane = static_cast<size_t>(gridDim.y) * g.c;
    const float n = static_cast<float>(at.r1 - at.r0);
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const float off = s1[v] / n;
      part[static_cast<size_t>(blockIdx.y) * g.c + at.c0 + v] = k[v] + off;
      part[plane + static_cast<size_t>(blockIdx.y) * g.c + at.c0 + v] = s2[v] - s1[v] * off;
    }
  }
  const Merge q = merge_place<V>(g);
  float mean, m2;
  if (merge_tile<true>(g, q, part, wrote, stats_group_tickets, stats_tile_tickets, sm, mean, m2) &&
      q.holds())
    finish_stats(g, q.cb + q.w, mean, m2, mean_out, invstd_out, run_mean, run_var, update, eps,
                 keep, take);
}

// 2. z = act((x - mean) * (invstd * w) + b) in T
template <typename T, int V, bool ACT>
__global__ void __launch_bounds__(THREADS) dyd_bn_apply(
    const T* __restrict__ x, T* __restrict__ z, Geo g, const float* __restrict__ mean,
    const float* __restrict__ invstd, const float* __restrict__ w, const float* __restrict__ b) {
  using I = Io<T, V>;
  const Place at = place<V>(g);
  if (!at.on) return;
  float mu[V], sc[V], sh[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    mu[v] = mean[at.c0 + v];
    sc[v] = invstd[at.c0 + v] * w[at.c0 + v];
    sh[v] = b[at.c0 + v];
  }
  for (int r = at.r0 + at.ty; r < at.r1; r += U * g.ry) {
    typename I::Raw raw[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int rr = r + u * g.ry;
      if (rr < at.r1) raw[u] = I::load(x + static_cast<size_t>(rr) * g.ld_x + at.c0);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int rr = r + u * g.ry;
      if (rr < at.r1) {
        float v_[V];
        I::unpack(raw[u], v_);
#pragma unroll
        for (int v = 0; v < V; ++v) {
          const float y = (v_[v] - mu[v]) * sc[v] + sh[v];
          v_[v] = ACT ? silu(y) : y;
        }
        I::store(z + static_cast<size_t>(rr) * g.c + at.c0, v_);
      }
    }
  }
}

// 3. sum g and sum g * x_hat per channel; the tile's last merge writes d_bias
// and d_weight.
template <typename T, int V, bool ACT>
__global__ void __launch_bounds__(THREADS) dyd_bn_bwd_reduce(
    const T* __restrict__ dz, const T* __restrict__ x, Geo g, const float* __restrict__ mean,
    const float* __restrict__ invstd, const float* __restrict__ w, const float* __restrict__ b,
    float* __restrict__ part, float* __restrict__ d_w, float* __restrict__ d_b) {
  using I = Io<T, V>;
  __shared__ float sm[2 * 8 * MAX_TILE];
  const Place at = place<V>(g);
  float sg[V], sgx[V];
#pragma unroll
  for (int v = 0; v < V; ++v) sg[v] = sgx[v] = 0.0f;
  if (at.on) {
    Consts<V> k;
    load_consts<V>(k, at.c0, mean, invstd, w, b);
    for (int r = at.r0 + at.ty; r < at.r1; r += U * g.ry) {
      typename I::Raw rdz[U], rx[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int rr = r + u * g.ry;
        if (rr < at.r1) {
          rdz[u] = I::load(dz + static_cast<size_t>(rr) * g.ld_dz + at.c0);
          rx[u] = I::load(x + static_cast<size_t>(rr) * g.ld_x + at.c0);
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (r + u * g.ry < at.r1) {
          float dv[V], xv[V];
          I::unpack(rdz[u], dv);
          I::unpack(rx[u], xv);
#pragma unroll
          for (int v = 0; v < V; ++v) {
            const float xh = (xv[v] - k.mu[v]) * k.is[v];
            const float gg = ACT ? silu_grad(dv[v], xh * k.w[v] + k.b[v]) : dv[v];
            sg[v] += gg;
            sgx[v] += gg * xh;
          }
        }
      }
    }
  }
  rows_sum<V>(g, at.ty, sg, sgx, sm);
  const bool wrote = at.ty == 0 && at.on;
  if (wrote) {
    const size_t plane = static_cast<size_t>(gridDim.y) * g.c;
#pragma unroll
    for (int v = 0; v < V; ++v) {
      part[static_cast<size_t>(blockIdx.y) * g.c + at.c0 + v] = sg[v];
      part[plane + static_cast<size_t>(blockIdx.y) * g.c + at.c0 + v] = sgx[v];
    }
  }
  const Merge q = merge_place<V>(g);
  float sum_g, sum_gx;
  if (merge_tile<false>(g, q, part, wrote, reduce_group_tickets, reduce_tile_tickets, sm, sum_g,
                        sum_gx) &&
      q.holds()) {
    d_b[q.cb + q.w] = sum_g;
    d_w[q.cb + q.w] = sum_gx;
  }
}

// 4. dx = w * invstd * (g - sum g / M - x_hat * sum g x_hat / M) in T
template <typename T, int V, bool ACT>
__global__ void __launch_bounds__(THREADS) dyd_bn_bwd_elemt(
    const T* __restrict__ dz, const T* __restrict__ x, T* __restrict__ dx, Geo g,
    const float* __restrict__ mean, const float* __restrict__ invstd, const float* __restrict__ w,
    const float* __restrict__ b, const float* __restrict__ d_w, const float* __restrict__ d_b) {
  using I = Io<T, V>;
  const Place at = place<V>(g);
  if (!at.on) return;
  Consts<V> k;
  load_consts<V>(k, at.c0, mean, invstd, w, b);
  float scale[V], mg[V], mgx[V];
  const float total = static_cast<float>(g.m);
#pragma unroll
  for (int v = 0; v < V; ++v) {
    scale[v] = k.w[v] * k.is[v];
    mg[v] = d_b[at.c0 + v] / total;
    mgx[v] = d_w[at.c0 + v] / total;
  }
  for (int r = at.r0 + at.ty; r < at.r1; r += U * g.ry) {
    typename I::Raw rdz[U], rx[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int rr = r + u * g.ry;
      if (rr < at.r1) {
        rdz[u] = I::load(dz + static_cast<size_t>(rr) * g.ld_dz + at.c0);
        rx[u] = I::load(x + static_cast<size_t>(rr) * g.ld_x + at.c0);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int rr = r + u * g.ry;
      if (rr < at.r1) {
        float dv[V], xv[V];
        I::unpack(rdz[u], dv);
        I::unpack(rx[u], xv);
#pragma unroll
        for (int v = 0; v < V; ++v) {
          const float xh = (xv[v] - k.mu[v]) * k.is[v];
          const float gg = ACT ? silu_grad(dv[v], xh * k.w[v] + k.b[v]) : dv[v];
          dv[v] = scale[v] * (gg - mg[v] - xh * mgx[v]);
        }
        I::store(dx + static_cast<size_t>(rr) * g.c + at.c0, dv);
      }
    }
  }
}

namespace {

Geo make_geo(int m, int c, int ld_x, int ld_dz, int tcx, int ry, int rows, int group) {
  Geo g;
  g.m = m;
  g.c = c;
  g.ld_x = ld_x;
  g.ld_dz = ld_dz;
  g.tcx = tcx;
  g.ry = ry;
  g.rows = rows;
  g.group = group;
  return g;
}

template <typename T, int V>
int forward_as(const void* x, void* z, void* mean, void* invstd, void* run_mean, void* run_var,
               void* part, const void* w, const void* b, int act, int update, const Geo& g,
               int tiles, int gy, float eps, float keep, float take, cudaStream_t s) {
  const dim3 grid(tiles, gy), block(g.tcx * g.ry);
  const T* xp = static_cast<const T*>(x);
  float* mp = static_cast<float*>(mean);
  float* ip = static_cast<float*>(invstd);
  dyd_bn_stats<T, V><<<grid, block, 0, s>>>(xp, g, static_cast<float*>(part), mp, ip,
                                            static_cast<float*>(run_mean),
                                            static_cast<float*>(run_var), update, eps, keep, take);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const float* wp = static_cast<const float*>(w);
  const float* bp = static_cast<const float*>(b);
  T* zp = static_cast<T*>(z);
  if (act)
    dyd_bn_apply<T, V, true><<<grid, block, 0, s>>>(xp, zp, g, mp, ip, wp, bp);
  else
    dyd_bn_apply<T, V, false><<<grid, block, 0, s>>>(xp, zp, g, mp, ip, wp, bp);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int V, bool ACT>
int backward_as(const void* dz, const void* x, void* dx, const void* mean, const void* invstd,
                const void* w, const void* b, void* part, void* d_w, void* d_b, const Geo& g,
                int tiles, int gy, cudaStream_t s) {
  const dim3 grid(tiles, gy), block(g.tcx * g.ry);
  const T* dzp = static_cast<const T*>(dz);
  const T* xp = static_cast<const T*>(x);
  const float* mp = static_cast<const float*>(mean);
  const float* ip = static_cast<const float*>(invstd);
  const float* wp = static_cast<const float*>(w);
  const float* bp = static_cast<const float*>(b);
  float* dwp = static_cast<float*>(d_w);
  float* dbp = static_cast<float*>(d_b);
  dyd_bn_bwd_reduce<T, V, ACT><<<grid, block, 0, s>>>(dzp, xp, g, mp, ip, wp, bp,
                                                      static_cast<float*>(part), dwp, dbp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dyd_bn_bwd_elemt<T, V, ACT><<<grid, block, 0, s>>>(dzp, xp, static_cast<T*>(dx), g, mp, ip,
                                                     wp, bp, dwp, dbp);
  return static_cast<int>(cudaGetLastError());
}

// tcx a power of two up to 32, THREADS threads, tiles of at most MAX_TILE
// channels, groups of at most MAX_MERGE row blocks and at most MAX_MERGE
// groups
bool bad_geometry(int m, int c, int vec, int tcx, int ry, int rows, int tiles, int gy,
                  int group) {
  const int ng = group < 1 ? 0 : (gy + group - 1) / group;
  return m < 1 || c < 1 || tcx < 1 || tcx > 32 || (tcx & (tcx - 1)) || tcx * ry != THREADS ||
         tcx * vec > MAX_TILE || rows < 1 || tiles < 1 || tiles > MAX_TILES || gy < 1 ||
         gy > 65535 || group < 1 || group > MAX_MERGE || ng > MAX_MERGE ||
         static_cast<long long>(tiles) * ng > MAX_GROUPS;
}

}  // namespace

// bf16: 1 for bfloat16, 0 for float32; vec: the channels a thread loads at
// once (8 for bf16 or 4 for f32 with 16-byte loads, 1 otherwise).
extern "C" int dyd_bn_forward(const void* x, void* z, void* mean, void* invstd, void* run_mean,
                              void* run_var, void* part, const void* w, const void* b, int bf16,
                              int vec, int act, int update, int m, int c, int ld_x, int tcx,
                              int ry, int rows, int tiles, int gy, int group, float eps,
                              float keep, float take, void* stream) {
  if (bad_geometry(m, c, vec, tcx, ry, rows, tiles, gy, group))
    return static_cast<int>(cudaErrorInvalidValue);
  const Geo g = make_geo(m, c, ld_x, c, tcx, ry, rows, group);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DYD_BN_FWD(T, V)                                                                      \
  return forward_as<T, V>(x, z, mean, invstd, run_mean, run_var, part, w, b, act, update, g,  \
                          tiles, gy, eps, keep, take, s)
  if (bf16 && vec == 8) DYD_BN_FWD(__nv_bfloat16, 8);
  if (bf16 && vec == 1) DYD_BN_FWD(__nv_bfloat16, 1);
  if (!bf16 && vec == 4) DYD_BN_FWD(float, 4);
  if (!bf16 && vec == 1) DYD_BN_FWD(float, 1);
#undef DYD_BN_FWD
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int dyd_bn_backward(const void* dz, const void* x, void* dx, const void* mean,
                               const void* invstd, const void* w, const void* b, void* part,
                               void* d_w, void* d_b, int bf16, int vec, int act, int m, int c,
                               int ld_dz, int ld_x, int tcx, int ry, int rows, int tiles, int gy,
                               int group, void* stream) {
  if (bad_geometry(m, c, vec, tcx, ry, rows, tiles, gy, group))
    return static_cast<int>(cudaErrorInvalidValue);
  const Geo g = make_geo(m, c, ld_x, ld_dz, tcx, ry, rows, group);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DYD_BN_BWD(T, V)                                                                      \
  return act ? backward_as<T, V, true>(dz, x, dx, mean, invstd, w, b, part, d_w, d_b, g,      \
                                       tiles, gy, s)                                          \
             : backward_as<T, V, false>(dz, x, dx, mean, invstd, w, b, part, d_w, d_b, g,     \
                                        tiles, gy, s)
  if (bf16 && vec == 8) DYD_BN_BWD(__nv_bfloat16, 8);
  if (bf16 && vec == 1) DYD_BN_BWD(__nv_bfloat16, 1);
  if (!bf16 && vec == 4) DYD_BN_BWD(float, 4);
  if (!bf16 && vec == 1) DYD_BN_BWD(float, 1);
#undef DYD_BN_BWD
  return static_cast<int>(cudaErrorInvalidValue);
}

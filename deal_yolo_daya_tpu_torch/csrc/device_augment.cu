// The on-card augmentation's pixel path for Hopper (sm_90a), bound to Python
// through ctypes.
//
// Replaces no TPU kernel: the JAX package's augmentation
// (deal_yolo_daya_tpu/train/device_augment.py) is jnp that XLA fuses on the
// TPU. It was added because the port's PyTorch version of the same function
// (train/device_augment.py::pixels_plain, its separable route) builds every
// intermediate in device memory: the mosaic samples all four quadrant
// sources of every output pixel as two (B, 4, S, S, 3) f32 tensors made by
// gathers and masks three away, and the HSV jitter is some forty f32
// elementwise passes over (B, S, S, 3). That took a third of the b32/640
// train step (19.8 ms) for a function that reads about 39 MB of u8 sources
// and writes 39 MB of u8 images.
//
// What bounds it: bytes, about 79 MB at b32/640 (the sources read once, the
// u8 output written once: 0.024 ms at 3.35 TB/s), against some 150-300 f32
// operations a pixel (the bilinear taps, mixup, the HSV round trip with its
// three divisions). One pass over the output does all of it, and no
// per-pixel intermediate reaches device memory:
//
//   for each output pixel (i, y, x) of sample i, made from made sample i
//   (and, with mixup, its partner):
//     1. the affine's source point on the 2S mosaic canvas is separable:
//        cy1 = i11 (y - ty) + S for the row, cx1 = i00 (x - tx) + S for the
//        column; the quadrant is q = 2 (cy1 >= yc) + (cx1 >= xc) under the
//        mosaic gate, else 0. Only that quadrant's source is sampled: the
//        PyTorch version's masked sum over the four has one term that is not
//        0, so the one pick gives the same value;
//     2. bilinear, rows first, in f32 with each product and sum rounded as
//        PyTorch's separate elementwise kernels round them (this file is
//        built with -fmad=false, so nothing is contracted into an FMA):
//        t0 = (1-fy) p[y0,x0] + fy p[y1,x0], t1 the same at x1,
//        v = (1-fx) t0 + fx t1; neighbour indices clipped to the source,
//        weights from the unclipped floor;
//     3. FILL (114) where the point lies outside the source's content;
//     4. mixup: lam v + (1 - lam) v_j, v_j the partner's pixel computed the
//        same way by the same thread (skipped where lam is 1, which gives
//        v exactly);
//     5. HSV gains in the op order of rgb_to_hsv -> gains -> hsv_to_rgb ->
//        clamp. A division by a constant is a multiply by its f32 reciprocal,
//        as PyTorch's CUDA division by a Python scalar computes it; the
//        remainder is fmodf with PyTorch's sign rule;
//     6. the flips choose the address the pixel is written to, the BGR swap
//        the channel order;
//     7. clamp to [0, 255] and truncate to u8.
//
// Shape: one block of THREADS threads an output row of one sample (grid S x
// n). The block's row values (cy1, the quadrant row, the two quadrants' y
// taps and row pointers, their validity) are computed once a thread for its
// whole row; each thread then walks the row's columns THREADS apart, so a
// warp reads neighbouring source bytes and writes 96 contiguous output bytes.
// The taps go through the read-only cache; nothing is staged in shared
// memory. At b32/640 that is 20,480 blocks of 128 threads. It takes 0.16 ms
// at b32/640 on an H100, 7 x the bound in bytes. Where the rest goes is not
// profiled; the guess is the f32 arithmetic and the taps' loads, since
// taking divisions out of the HSV round trip cut it from 0.21 ms: the hue
// takes only the two channel ratios its sector uses, and the remainders
// skip fmodf where the dividend is already below the divisor.
//
// The per-sample numbers (origins, the affine's inverse, the quadrant
// centre, the gains, flips and mixup weights) are computed by the caller in
// PyTorch, where the box path needs them too, so the kernel reads the very
// f32 values the PyTorch version uses.
//
// The launch allocates nothing. The C entry returns cudaGetLastError() so the
// Python wrapper can raise.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;
constexpr float FILL = 114.f;
// PyTorch's CUDA division of a tensor by a Python scalar multiplies by the
// scalar's f32 reciprocal (rounded once, on the host)
constexpr float INV6 = 1.f / 6.f;
constexpr float INV180 = 1.f / 180.f;
constexpr float INV255 = 1.f / 255.f;

struct Args {
  const unsigned char* images;  // (B, S, S, 3) u8 sources
  const float* hw;              // (B, 2) content (h, w)
  const long long* idx4;        // (m, 4) each made sample's four sources
  const float* origin_x;        // (m, 4) each source's origin on the canvas
  const float* origin_y;
  const float* i00;             // (m,) the affine's inverse, diagonal
  const float* i11;
  const float* tx;              // (m,) the affine's translation
  const float* ty;
  const float* xc;              // (m,) the mosaic centre on the canvas
  const float* yc;
  const unsigned char* mosaic;  // (m,) the mosaic gate
  const long long* partner;     // (n,) the mixup partner's made sample, or null
  const float* lam;             // (n,) its weight (1: no mixup)
  const float* gains;           // (n, 3) HSV gains
  const unsigned char* lr;      // (n,) flips, and the BGR swap (or null)
  const unsigned char* ud;
  const unsigned char* bgr;
  unsigned char* out;           // (n, S, S, 3) u8
  int s;
};

// One quadrant's source for one output row: its two tap rows, the row
// weight, where the row lies in the source's content, and the quadrant's
// column origin and right limit.
struct Quadrant {
  const unsigned char* r0;
  const unsigned char* r1;
  float fy, ox, lim_x;
  bool vy;
};

// One made sample for one output row: the quadrants left and right of the
// mosaic centre in the row's half of the canvas.
struct RowSource {
  Quadrant left, right;
  float i00, tx, xc;
  bool mosaic;
};

__device__ __forceinline__ int clip(int v, int hi) { return min(max(v, 0), hi); }

__device__ __forceinline__ Quadrant quadrant(const Args& a, long long m, int q, float cy1) {
  const long long src = __ldg(a.idx4 + 4 * m + q);
  const float hs = __ldg(a.hw + 2 * src), ws = __ldg(a.hw + 2 * src + 1);
  const float sy = cy1 - __ldg(a.origin_y + 4 * m + q);
  Quadrant out;
  out.ox = __ldg(a.origin_x + 4 * m + q);
  out.lim_x = ws - 0.5f;
  out.vy = sy >= -0.5f && sy <= hs - 0.5f;
  const float y0 = floorf(sy);
  out.fy = sy - y0;
  int iy0 = 0, iy1 = 0;
  if (out.vy) {  // sy in [-0.5, S - 0.5]: the floor fits an int
    const int i = static_cast<int>(y0);
    iy0 = clip(i, a.s - 1);
    iy1 = clip(i + 1, a.s - 1);
  }
  const unsigned char* base = a.images + static_cast<size_t>(src) * a.s * a.s * 3;
  out.r0 = base + static_cast<size_t>(iy0) * a.s * 3;
  out.r1 = base + static_cast<size_t>(iy1) * a.s * 3;
  return out;
}

__device__ __forceinline__ RowSource row_source(const Args& a, long long m, int y) {
  RowSource r;
  r.i00 = __ldg(a.i00 + m);
  r.tx = __ldg(a.tx + m);
  r.xc = __ldg(a.xc + m);
  r.mosaic = __ldg(a.mosaic + m) != 0;
  const float cy1 = __ldg(a.i11 + m) * (static_cast<float>(y) - __ldg(a.ty + m))
                    + static_cast<float>(a.s);
  const int q = (r.mosaic && cy1 >= __ldg(a.yc + m)) ? 2 : 0;  // the bottom half's
  r.left = quadrant(a, m, q, cy1);
  r.right = quadrant(a, m, q + 1, cy1);
  return r;
}

// The mosaic's pixel at column x of the row: bilinear from the one quadrant
// the point falls in, or FILL outside its content.
__device__ __forceinline__ void sample(const RowSource& r, int x, int s, float v[3]) {
  const float cx1 = r.i00 * (static_cast<float>(x) - r.tx) + static_cast<float>(s);
  const Quadrant qd = (r.mosaic && cx1 >= r.xc) ? r.right : r.left;
  const float sx = cx1 - qd.ox;
  if (!(qd.vy && sx >= -0.5f && sx <= qd.lim_x)) {
    v[0] = v[1] = v[2] = FILL;
    return;
  }
  const float x0 = floorf(sx);
  const float fx = sx - x0;
  const int i = static_cast<int>(x0);
  const int c0 = 3 * clip(i, s - 1), c1 = 3 * clip(i + 1, s - 1);
  const float wy = 1.f - qd.fy, wx = 1.f - fx;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float t0 = wy * static_cast<float>(__ldg(qd.r0 + c0 + c))
                     + qd.fy * static_cast<float>(__ldg(qd.r1 + c0 + c));
    const float t1 = wy * static_cast<float>(__ldg(qd.r0 + c1 + c))
                     + qd.fy * static_cast<float>(__ldg(qd.r1 + c1 + c));
    v[c] = wx * t0 + fx * t1;
  }
}

// torch.remainder on floats: fmod, moved into the divisor's sign. fmod(a, b)
// is a itself where |a| < |b|, the common case here, without fmodf's loop
__device__ __forceinline__ float remainder(float a, float b) {
  float m = fabsf(a) < fabsf(b) ? a : fmodf(a, b);
  if (m != 0.f && ((b < 0.f) != (m < 0.f))) m += b;
  return m;
}

__device__ __forceinline__ float clamp255(float v) { return fminf(fmaxf(v, 0.f), 255.f); }

// hsv_jitter: rgb_to_hsv, the gains, hsv_to_rgb, the clamp; in place
__device__ __forceinline__ void hsv_jitter(float c[3], float gh, float gs, float gv) {
  const float r = c[0], g = c[1], b = c[2];
  const float maxc = fmaxf(fmaxf(r, g), b);
  const float minc = fminf(fminf(r, g), b);
  const float delta = maxc - minc;
  // the hue's two channel ratios (rc, gc, bc = (maxc - channel) / delta) that
  // its sector uses, and none where delta is 0 and the hue is 0
  float h = 0.f;
  if (delta != 0.f) {
    if (maxc == r)
      h = (maxc - b) / delta - (maxc - g) / delta;
    else if (maxc == g)
      h = (2.f + (maxc - r) / delta) - (maxc - b) / delta;
    else
      h = (4.f + (maxc - g) / delta) - (maxc - r) / delta;
  }
  h = remainder(h * INV6, 1.f) * 180.f;
  float sat = (maxc == 0.f ? 0.f : delta / maxc) * 255.f;

  h = remainder(h * gh, 180.f);
  sat = clamp255(sat * gs);
  const float v = clamp255(maxc * gv);

  const float hh = (h * INV180) * 6.f;
  const float ss = sat * INV255;
  const float fi = floorf(hh);
  const float f = hh - fi;
  const float p = v * (1.f - ss);
  const float q = v * (1.f - ss * f);
  const float t = v * (1.f - ss * (1.f - f));
  int sector = static_cast<int>(fi) % 6;
  if (sector < 0) sector += 6;
  float o0, o1, o2;
  switch (sector) {
    case 0: o0 = v; o1 = t; o2 = p; break;
    case 1: o0 = q; o1 = v; o2 = p; break;
    case 2: o0 = p; o1 = v; o2 = t; break;
    case 3: o0 = p; o1 = q; o2 = v; break;
    case 4: o0 = t; o1 = p; o2 = v; break;
    default: o0 = v; o1 = p; o2 = q; break;
  }
  c[0] = clamp255(o0);
  c[1] = clamp255(o1);
  c[2] = clamp255(o2);
}

// at most 64 registers a thread, so that 8 blocks share an SM (72 without:
// 4% slower on an H100)
__global__ void __launch_bounds__(THREADS, 8) augment_pixels_kernel(const Args a) {
  const int y = blockIdx.x;
  const long long i = blockIdx.y;
  const int s = a.s;
  const RowSource own = row_source(a, i, y);
  float lam = 1.f;
  long long j = 0;
  if (a.partner != nullptr) {
    lam = __ldg(a.lam + i);
    j = __ldg(a.partner + i);
  }
  const bool mix = lam != 1.f;  // lam 1: lam v + 0 v_j is v exactly
  RowSource other;
  if (mix) other = row_source(a, j, y);
  const float gh = __ldg(a.gains + 3 * i), gs = __ldg(a.gains + 3 * i + 1),
              gv = __ldg(a.gains + 3 * i + 2);
  const bool lr = __ldg(a.lr + i) != 0, ud = __ldg(a.ud + i) != 0;
  const bool bgr = a.bgr != nullptr && __ldg(a.bgr + i) != 0;
  const int y_out = ud ? s - 1 - y : y;
  unsigned char* row_out = a.out + (static_cast<size_t>(i) * s + y_out) * s * 3;

  for (int x = threadIdx.x; x < s; x += THREADS) {
    float v[3];
    sample(own, x, s, v);
    if (mix) {
      float vj[3];
      sample(other, x, s, vj);
      const float rest = 1.f - lam;
#pragma unroll
      for (int c = 0; c < 3; ++c) v[c] = lam * v[c] + rest * vj[c];
    }
    hsv_jitter(v, gh, gs, gv);
    unsigned char* o = row_out + 3 * (lr ? s - 1 - x : x);
#pragma unroll
    for (int c = 0; c < 3; ++c)  // clamp, then truncate as .to(torch.uint8)
      o[bgr ? 2 - c : c] = static_cast<unsigned char>(clamp255(v[c]));
  }
}

}  // namespace

// Augment the pixels of n samples (see the header) on `stream`: the pointers
// as in Args, `partner` and `lam` both null without mixup, `bgr` null
// without the swap. Returns 0 on a good launch, else the CUDA error code.
extern "C" int device_augment(const void* images, const void* hw, const void* idx4,
                              const void* origin_x, const void* origin_y, const void* i00,
                              const void* i11, const void* tx, const void* ty, const void* xc,
                              const void* yc, const void* mosaic, const void* partner,
                              const void* lam, const void* gains, const void* lr,
                              const void* ud, const void* bgr, void* out, int n, int s,
                              void* stream) {
  if (n < 0 || s < 1 || n > 65535 || (partner == nullptr) != (lam == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  Args a;
  a.images = static_cast<const unsigned char*>(images);
  a.hw = static_cast<const float*>(hw);
  a.idx4 = static_cast<const long long*>(idx4);
  a.origin_x = static_cast<const float*>(origin_x);
  a.origin_y = static_cast<const float*>(origin_y);
  a.i00 = static_cast<const float*>(i00);
  a.i11 = static_cast<const float*>(i11);
  a.tx = static_cast<const float*>(tx);
  a.ty = static_cast<const float*>(ty);
  a.xc = static_cast<const float*>(xc);
  a.yc = static_cast<const float*>(yc);
  a.mosaic = static_cast<const unsigned char*>(mosaic);
  a.partner = static_cast<const long long*>(partner);
  a.lam = static_cast<const float*>(lam);
  a.gains = static_cast<const float*>(gains);
  a.lr = static_cast<const unsigned char*>(lr);
  a.ud = static_cast<const unsigned char*>(ud);
  a.bgr = static_cast<const unsigned char*>(bgr);
  a.out = static_cast<unsigned char*>(out);
  a.s = s;
  augment_pixels_kernel<<<dim3(s, n), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

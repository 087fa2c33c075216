// Shadow ray-march kernels: per pixel, the minimum over a set of offsets t of
// the 3D distance from the pixel->light ray to the bilinearly sampled depth
// point on the pixel->border segment. One templated kernel, three forms, and
// the backward of K2 (march_grad_kernel, below them: the training march K4 is
// K2 forward and march_grad backward):
//
//  K1 (kMin)     the min over the t grid. Replaces the inference form of
//                geomconsistentfr_tpu/ops/shadows_pallas.py `_march_kernel`,
//                reached through `ray_march_min_distance_pallas`.
//  K2 (kArgmin)  K1 plus the int32 index of the first winning sample (strict
//                `<` on norm^2; 0 for a culled pixel, and for a pixel whose
//                every sample is vetoed). Replaces `_march_kernel` with
//                want_tstar, reached through `ray_march_min_distance_pallas(
//                ..., return_argmin_t=True)`: the draft tier's low-resolution
//                march, and the forward of the training autograd.
//  K3 (kRefine)  the draft tier's boundary refine: the min over a few offsets
//                around a per-pixel centre, t = clip(centre + off, t_lo, t_hi),
//                from the 1e6 sentinel. The centre is read from a full-
//                resolution t_map, or straight from K2's output: ts[idx] at the
//                pixel's low-resolution texel (upsample_tstar_nn without the
//                map). Replaces `_march_kernel` with refine_t_range, reached
//                through `refine_min_distance_pallas`.
//
// Semantics are those of the plain versions in
// geomconsistentfr_torch/ops/shadows.py, which are written op for op in the
// order this kernel evaluates. The form is a template argument, so each
// instantiation compiles only its own carry and K1's loop holds nothing of
// K2's or K3's.
//
// What bounds it on an H100. Per live pixel-sample the function needs about
// 60 float32 operations (coordinates, floor/ceil, four depth taps, bilinear
// weights, the cross product and its norm; the bilinear veto about 20 more)
// against a few bytes: at batch 64 x 256^2 x 160 samples the arithmetic is
// tens of GFLOP (~0.26-0.35 ms at 67 TFLOP/s after the cull) while depth,
// mask and output are 50 MB (~15 us at 3.35 TB/s), so the stated bound is
// the f32 operations. That rate counts a fused multiply-add as two; the
// reference's rounding lets this loop fuse only the two coordinate products,
// so its float work alone is ~55 (one-hot) or ~78 (bilinear) instructions a
// sample, one per lane and clock, twice the stated bound. What bounds the
// kernel is instruction issue: 80-95 instructions a sample in the compiled
// loop (chip_smoke.py's build phase counts them), one warp instruction per
// clock per scheduler, at 80-86% of that rate on an H100 (PERF.md). The first
// version's loop held 181 instructions with both vetoes' branches, 18 of them
// on the conversion unit (clamped float taps cast to int, F2I; floorf, ceilf
// and rintf, FRND), 64-bit address arithmetic per tap, and the fast tier's
// veto deriving four taps of its own. Taking the conversions out alone, with
// 64-bit addresses left, made strict slower; the instructions were the cost.
// The TPU kernel turned the gathers into one-hot matmuls because a TPU has
// no vector gather; a GPU has one, so each tap is a plain load through the
// read-only path (__ldg), and an image's padded depth and mask (520 KiB)
// stay in L1/L2. No wgmma or TMA: there is no matrix product once the
// gathers are loads, and the taps a block reads are data-dependent (each ray
// crosses the whole image), so a TMA copy of a fixed tile has nothing to
// feed; nor does the image fit a block's shared memory.
//
// Design. One thread per pixel; a block is 8 rows x 32 columns, the cull's
// 8-row unit (8 x 16 measured the same, 8 x 64 slower); the loop unrolled 4
// times, K1 and K2 held to 64 registers (4 blocks an SM) and K3 to 5 blocks
// (unrolling 1 or 2 times, or 40 registers, measured slower). Per-pixel
// constants (endpoint, BC, denominator, K3's centre) are computed once in
// registers; the t table (K1, K2) or the window offsets (K3) are staged in
// shared memory. Per sample (sample_n2):
//  * No conversion-unit instruction. floor(x) is the bit pattern of
//    __fadd_rd(x, 1.5 * 2^23) less 0x4B400000 (for |x| < 2^22 the sum lies on
//    a grid of step 1, so rounding toward -inf lands on floor(x) + 1.5 * 2^23
//    exactly), and its float is the sum less the constant; ceil is the same
//    with __fadd_ru, rintf (half to even) with __fadd_rn. The quad's address
//    is one multiply-add of those bit patterns (the bias folded into a
//    per-pixel constant) and one wide add, on the integer pipe.
//  * One tap quad. Depth and mask arrive interleaved, so one 8-byte load
//    per corner gives both, and padded with a replicated first row and
//    column, (B, H + 1, W + 1, 2) float32 (stage_kernel). The quad is rows
//    (floor(yt), floor(yt) + 1) x columns (floor(xt), floor(xt) + 1), the
//    pad standing for the reference's clamp of a floor of -1 to 0: its
//    clamped floor/ceil taps, except where xt (yt) is an integer, where ceil
//    = floor and both of that axis' weights are exactly 0, so the other tap
//    adds +-0 wherever depth is finite. The weights still use ceil (wx0 =
//    x1 - xt). The one-hot veto's tap,
//    (W/2 - rint(sy), rint(sx) + W/2), is always a corner of the quad:
//    dx = rint(sx) + W/2 - floor(xt) with xt = sx + W/2 - 1e-4 (to within
//    float32 rounding, far under 1/2 for |xt| < 2048), |rint(sx) - sx| <= 1/2
//    and xt - 1 < floor(xt) <= xt give -1/2 + 1e-4 <= dx < 3/2 + 1e-4, and dx
//    is an integer, so 0 or 1; dy likewise. t in [0, 1] keeps the tap inside
//    the image. So the tap is selected from the quad with no load of its own
//    (tests/test_torch_march_design.py holds the rule to the plain taps on
//    hypothesis-drawn rays, and asserts the selection never leaves the quad).
//    The bilinear veto's taps are the
//    quad's wherever xt, yt >= 0; in [-1e-4, 0) its second column (row) is 1
//    where the quad's is 0, and that tap's weight is exactly 0. So strict
//    reads 4 taps a sample instead of 5, fast 4 instead of 8.
//  * The range. For t in [0, 1] the sample lies on the segment between the
//    pixel and the clamped endpoint, so xt lies in [-1e-4, W - 1) for W up
//    to 2048 (the wrapper checks both): the quad's only index outside the
//    image is -1, which the pad holds, and floor(xt) + 1 <= W - 1. The
//    kernel clamps every t into [0, 1] as it stages it, so no input reads
//    out of bounds; the wrapper refuses tables outside [0, 1], so the clamp
//    changes none.
//  * The cull is in the kernel: each block reads the mask of its cull units
//    (8 rows x col_chunk, or the whole row group for the row cull), and a
//    thread whose unit holds no face writes the all-vetoed sentinel and skips
//    the loop. A block inside one unit (chunks of 32, 64 and the row) decides
//    with one __syncthreads_or; one that meets several keeps a shared flag
//    per unit.
// The loop carries the min of the raw cross-product norm^2 (1e30 for a
// vetoed sample); sqrt(n2 + 1e-4) / denom is monotone in n2, so the result
// equals the min of per-sample distances exactly, and is taken once at the
// end. K2 carries the sample index beside it; the wrapper maps the index to t
// through the same float32 table (shadows_pallas.py:1152-1154).
//
// Rounding choices:
//  * The veto's rounding is banker's (round half to even), as in the
//    reference and torch.round: __fadd_rn onto the integer grid, as rintf
//    rounds, never half away from zero (roundf). The march hits exact halves
//    systematically (integer pixel-to-border spans stepped by t_step 0.005).
//  * Built with -fmad=false and without --use_fast_math, so the compiler
//    contracts nothing and every product and sum rounds on its own, as
//    PyTorch's eager ops in the plain versions round them. Division and sqrt
//    stay IEEE (-prec-div / -prec-sqrt defaults).
//  * One exception, written out: the sample coordinates xx + t * diff are an
//    explicit __fmaf_rn. They alone decide the veto's rounding and the depth
//    taps' floor/ceil, and the march hits exact halves there (t = 0.1 on an
//    integer span gives sx = -0.5 unfused, -0.50000006 fused). The JAX
//    package's compiled CPU march and refine (XLA) fuse them; with the
//    unfused form the port flipped whole samples against it, and the fused
//    form holds it to JAX within float32 rounding. Against the reference's
//    stored outputs both forms score the same (tests/test_torch_render.py).
//  * K3's centre: centre + off rounds first, then the clamp, as
//    jnp.clip(t_map + off, t_lo, t_hi) does (JAX shadows.py:702).
//  * The depth lookup uses the reference's floor/ceil taps with clamped
//    indices (the padded quad); the distance keeps the *unclipped* shifted
//    coordinates.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlockRows = 8;  // the cull's row unit: a block's rows are one cull group
constexpr int kBlockCols = 32;
constexpr int kThreads = kBlockRows * kBlockCols;
constexpr int kUnroll = 4;      // the sample loop's unroll
constexpr float kEps = 1e-4f;
constexpr float kOffFace = 1.0e6f;
constexpr float kOffFaceN2 = 1.0e30f;
constexpr float kRound = 12582912.0f;   // 1.5 * 2^23: x + kRound lies on a grid of step 1
constexpr int kRoundBits = 0x4B400000;  // its bit pattern

enum Form : int { kMin = 0, kArgmin = 1, kRefine = 2 };

struct MarchParams {
  int batch, height, width, n_ts;
  int bilinear;                 // 0: one-hot veto, 1: bilinear veto
  int cull;                     // 1: skip pixels whose 8-row x col_chunk unit holds no face
  int col_chunk;                // cull unit width in pixels
  int gate_on;
  int centre_scale, centre_n;   // K3's index form: the draft scale, the table's length
  int chunk_shift, scale_shift; // log2 of col_chunk and centre_scale, -1 if not a power of two
  float lo_x, hi_x, lo_y, hi_y, gate_bias;
  float t_lo, t_hi;             // K3: the full t grid's first and last offsets
};

__device__ __forceinline__ float clampf(float v, float lo, float hi) {
  return fminf(fmaxf(v, lo), hi);
}

// a / d for a >= 0: a shift where d is a power of two (shift >= 0).
__device__ __forceinline__ int div_by(int a, int d, int shift) {
  return shift >= 0 ? a >> shift : a / d;
}

// Per-pixel constants of the march.
struct Pixel {
  float xx, yy, diff_x, diff_y, bc_x, bc_y, bc_z, d0, half_w, half_h;
  int half_w_i;
  unsigned quad_bias, dy_bias;  // see sample_n2
};

// The cross-product norm^2 of one sample at offset t, or 1e30 where the veto
// rejects it: _Scene.sample_n2 of ops/shadows.py, for t in [0, 1].
// img is the image's padded plane: (H + 1) x (W + 1) float2, wp = W + 1.
template <bool kBilinear>
__device__ __forceinline__ float sample_n2(const float2* __restrict__ img, unsigned wp,
                                           float wm1, float hm1, const Pixel& q,
                                           float t) {
  const float sx = __fmaf_rn(t, q.diff_x, q.xx);
  const float sy = __fmaf_rn(t, q.diff_y, q.yy);
  const float xt = (sx + q.half_w) - kEps;
  const float yt = (q.half_h - sy) - kEps;

  // floor and ceil on the float32 pipe, the quad's indices on the integer pipe.
  const float bx0 = __fadd_rd(xt, kRound), by0 = __fadd_rd(yt, kRound);
  const float x0 = bx0 - kRound, y0 = by0 - kRound;
  const float x1 = __fadd_ru(xt, kRound) - kRound;
  const float y1 = __fadd_ru(yt, kRound) - kRound;
  // The quad's first corner, padded (floor(yt) + 1, floor(xt) + 1), straight
  // from the biased sums' bits: by * wp + bx + quad_bias (mod 2^32).
  const unsigned bxi = __float_as_uint(bx0), byi = __float_as_uint(by0);
  const float2* __restrict__ p0 = img + (byi * wp + bxi + q.quad_bias);
  const float2* __restrict__ p1 = p0 + wp;
  const float2 q00 = __ldg(p0), q01 = __ldg(p0 + 1);
  const float2 q10 = __ldg(p1), q11 = __ldg(p1 + 1);

  bool face;
  if constexpr (!kBilinear) {
    // The mask at (H/2 - rint(sy), rint(sx) + W/2), a corner of the quad: its
    // offsets from the quad's first corner, dx = vx - floor(xt) and
    // dy = vy - floor(yt), are 0 or 1 (the header says why), so it is selected
    // from the quad with no load of its own.
    const unsigned rxi = __float_as_uint(__fadd_rn(sx, kRound));
    const unsigned ryi = __float_as_uint(__fadd_rn(sy, kRound));
    const unsigned dx = rxi - bxi + q.half_w_i, dy = q.dy_bias - ryi - byi;
    face = (dy ? (dx ? q11.y : q10.y) : (dx ? q01.y : q00.y)) != 0.0f;
  } else {
    // The bilinear face indicator at the clipped position, thresholded at 0.5.
    // floor(clip(xt)) is max(floor(xt), 0) on [-1e-4, W - 1); the 0/1
    // indicator times a weight >= 0 is a select.
    const float xtc = clampf(xt, 0.0f, wm1), ytc = clampf(yt, 0.0f, hm1);
    const float vx0 = fmaxf(x0, 0.0f), vy0 = fmaxf(y0, 0.0f);
    const float ux0 = 1.0f - (xtc - vx0), ux1 = 1.0f - ((vx0 + 1.0f) - xtc);
    const float uy0 = 1.0f - (ytc - vy0), uy1 = 1.0f - ((vy0 + 1.0f) - ytc);
    const float vtop = (q00.y != 0.0f ? ux0 : 0.0f) + (q01.y != 0.0f ? ux1 : 0.0f);
    const float vbot = (q10.y != 0.0f ? ux0 : 0.0f) + (q11.y != 0.0f ? ux1 : 0.0f);
    face = (vtop * uy0 + vbot * uy1) > 0.5f;
  }

  const float wx0 = x1 - xt, wx1 = xt - x0;
  const float iu = q00.x * wx0 + q01.x * wx1;
  const float il = q10.x * wx0 + q11.x * wx1;
  const float d_interp = iu * (y1 - yt) + il * (yt - y0);

  const float ba_x = (xt - q.half_w) - q.xx;
  const float ba_y = (q.half_h - yt) - q.yy;
  const float ba_z = d_interp - q.d0;
  const float cx = ba_y * q.bc_z - ba_z * q.bc_y;
  const float cy = ba_z * q.bc_x - ba_x * q.bc_z;
  const float cz = ba_x * q.bc_y - ba_y * q.bc_x;
  const float n2 = cx * cx + cy * cy + cz * cz;
  return face ? n2 : kOffFaceN2;
}

// The min (K1, K3) or first argmin (K2) of sample_n2 over the staged table.
template <int kForm, bool kBilinear>
__device__ __forceinline__ void march_samples(const float2* __restrict__ img, unsigned wp,
                                              float wm1, float hm1, const Pixel& q,
                                              const float* s_ts, int n, float t_centre,
                                              float t_lo, float t_hi, float& best,
                                              int& best_s) {
#pragma unroll (kUnroll)
  for (int s = 0; s < n; ++s) {
    float t = s_ts[s];
    if constexpr (kForm == kRefine) t = clampf(t_centre + t, t_lo, t_hi);
    const float v = sample_n2<kBilinear>(img, wp, wm1, hm1, q, t);
    if constexpr (kForm == kArgmin) {
      if (v < best) {
        best = v;
        best_s = s;
      }
    } else {
      best = fminf(best, v);
    }
  }
}

// dm: depth and mask interleaved and padded, (B, H + 1, W + 1, 2), as
// stage_kernel writes them; mask: the (B, H, W) mask, which the cull reads
// (4 bytes a pixel, not dm's 8). ts: the t table (K1, K2) or
// the window offsets (K3). K3's centre: t_map (B, H, W), or, where centre_idx
// is given, centre_ts[centre_idx[b, row / s, col / s]] (K2's winners and the
// table they index). idx: K2's winning sample indices. Unused pointers may be
// null.
// K1 and K2 hold 4 blocks an SM (64 registers); K3, whose 8-sample loop gains
// less from registers than from blocks, 5.
template <int kForm>
__global__ void __launch_bounds__(kThreads, kForm == kRefine ? 5 : 4)
march_kernel(const float2* __restrict__ dm, const float* __restrict__ mask,
             const float* __restrict__ light,
             const float* __restrict__ ts, const float* __restrict__ t_map,
             const int32_t* __restrict__ centre_idx, const float* __restrict__ centre_ts,
             float* __restrict__ out, int32_t* __restrict__ idx, MarchParams p) {
  extern __shared__ float s_ts[];
  __shared__ int s_live[kBlockCols];
  const int tid = threadIdx.y * kBlockCols + threadIdx.x;
  const int h = p.height, w = p.width;
  const int b = blockIdx.z;
  const int row = blockIdx.y * kBlockRows + threadIdx.y;
  const int col0 = blockIdx.x * kBlockCols;
  const int col = col0 + threadIdx.x;
  const bool inb = row < h && col < w;
  const unsigned wp = w + 1;
  const size_t o = (size_t)b * h * w + (size_t)row * w + col;
  const float2* __restrict__ img = dm + (size_t)b * (h + 1) * wp;

  const float lx = light[3 * b + 0];
  const float ly = light[3 * b + 1];
  const float lz = light[3 * b + 2];
  const bool gate = p.gate_on && lx >= p.lo_x && lx <= p.hi_x &&
                    ly >= p.lo_y && ly <= p.hi_y;
  const float bias = gate ? p.gate_bias : 0.0f;
  const float sentinel = p.gate_on ? kOffFace + bias : kOffFace;

  // The cull: flag each cull unit (8 rows x chunk) that meets the block from
  // its mask. A block inside one unit, as at the tiers' chunks of 32 and 64
  // and the row cull, decides with one barrier; one that spans several
  // (chunks under the block's width) keeps a flag per unit. any_live is the
  // block's: with none, it writes the sentinel and skips the rest.
  bool live = inb, any_live = true;
  if (p.cull) {
    const int chunk = p.col_chunk, shift = p.chunk_shift;
    const int u_first = div_by(col0, chunk, shift);
    const int n_units = div_by(min(col0 + kBlockCols, w) - 1, chunk, shift) + 1 - u_first;
    const float* __restrict__ unit = mask + ((size_t)b * h + min(row, h - 1)) * w + (size_t)u_first * chunk;
    if (n_units == 1) {
      bool face = false;
      for (int c = threadIdx.x; c < chunk; c += kBlockCols) face |= unit[c] != 0.0f;
      any_live = __syncthreads_or(face);
      live = inb && any_live;
    } else {
      if (tid < kBlockCols) s_live[tid] = 0;
      __syncthreads();
      for (int u = 0; u < n_units; ++u, unit += chunk) {
        for (int c = threadIdx.x; c < chunk; c += kBlockCols) {
          if (unit[c] != 0.0f) s_live[u] = 1;
        }
      }
      __syncthreads();
      live = inb && s_live[div_by(col, chunk, shift) - u_first] != 0;
      any_live = __syncthreads_or(live);
    }
  }

  if (!any_live) {
    if (inb) {
      out[o] = sentinel;
      if constexpr (kForm == kArgmin) idx[o] = 0;
    }
    return;
  }
  for (int i = tid; i < p.n_ts; i += kThreads) {
    s_ts[i] = kForm == kRefine ? ts[i] : clampf(ts[i], 0.0f, 1.0f);
  }
  __syncthreads();
  if (!live) {
    if (inb) {
      out[o] = sentinel;
      if constexpr (kForm == kArgmin) idx[o] = 0;
    }
    return;
  }

  Pixel q;
  q.half_w = 0.5f * (float)w;
  q.half_h = 0.5f * (float)h;
  q.half_w_i = w / 2;
  // (floor(yt) + 1) * wp + floor(xt) + 1 = by * wp + bx + quad_bias, and
  // vy - floor(yt) = H/2 - (ry - K) - (by - K) = dy_bias - ry - by, where
  // bx, by, ry are the biased sums' bits and K their bias; mod 2^32.
  q.quad_bias = (1u - (unsigned)kRoundBits) * (wp + 1u);
  q.dy_bias = (unsigned)(h / 2) + 2u * (unsigned)kRoundBits;
  const float left = -q.half_w, right = (float)w - q.half_w - 1.0f;
  const float bottom = 1.0f - q.half_h, top = q.half_h;
  q.xx = (float)col - q.half_w;
  q.yy = q.half_h - (float)row;

  // Border endpoint: branchless 9-case analysis of the reference (:363-442).
  const float slope = (ly - q.yy) / ((lx - q.xx) + kEps);
  const float icpt = ly - slope * lx;
  const bool zx_neg = lx < left, zx_pos = lx > right;
  const bool zx_mid = !(zx_neg || zx_pos);
  const bool zy_neg = ly < bottom, zy_pos = ly > top;
  const bool zy_mid = !(zy_neg || zy_pos);
  const float xv = zx_neg ? left : right;
  const float ey_v = slope * xv + icpt;
  const float yh = zy_neg ? bottom : top;
  const float ex_h = (yh - icpt) / (slope + kEps);
  const bool inter = ex_h >= left && ex_h <= right;
  const float ex_c = inter ? ex_h : xv;
  const float ey_c = inter ? yh : ey_v;
  const bool inside = zx_mid && zy_mid;
  float ex = inside ? lx : (zy_mid ? xv : (zx_mid ? ex_h : ex_c));
  float ey = inside ? ly : (zy_mid ? ey_v : (zx_mid ? yh : ey_c));
  ex = clampf(ex, left, right);
  ey = clampf(ey, bottom, top);

  q.diff_x = ex - q.xx;
  q.diff_y = ey - q.yy;
  q.d0 = img[(size_t)(row + 1) * wp + col + 1].x;
  q.bc_x = lx - q.xx;
  q.bc_y = ly - q.yy;
  q.bc_z = lz - q.d0;
  const float denom = sqrtf(q.bc_x * q.bc_x + q.bc_y * q.bc_y + q.bc_z * q.bc_z + kEps);

  // K3 starts from the sentinel, as the plain refine does; K1 and K2 from inf
  // (an all-vetoed pixel then still records sample 0 as its winner).
  float best = kForm == kRefine ? kOffFaceN2 : INFINITY;
  int best_s = 0;
  float t_centre = 0.0f;
  if constexpr (kForm == kRefine) {
    if (centre_idx != nullptr) {
      const int s = p.centre_scale, shift = p.scale_shift, lw = div_by(w, s, shift);
      const int k = centre_idx[((size_t)b * div_by(h, s, shift) + div_by(row, s, shift)) * lw +
                               div_by(col, s, shift)];
      t_centre = centre_ts[min(max(k, 0), p.centre_n - 1)];
    } else {
      t_centre = t_map[o];
    }
  }
  const float t_lo = fmaxf(p.t_lo, 0.0f), t_hi = fminf(p.t_hi, 1.0f);
  const float wm1 = (float)(w - 1), hm1 = (float)(h - 1);
  if (p.bilinear) {
    march_samples<kForm, true>(img, wp, wm1, hm1, q, s_ts, p.n_ts, t_centre, t_lo, t_hi, best, best_s);
  } else {
    march_samples<kForm, false>(img, wp, wm1, hm1, q, s_ts, p.n_ts, t_centre, t_lo, t_hi, best, best_s);
  }

  float min_d = sqrtf(best + kEps) / denom;
  if constexpr (kForm == kRefine) min_d = fminf(min_d, kOffFace);
  if (best >= kOffFaceN2) min_d = kOffFace;
  out[o] = p.gate_on ? min_d + bias : min_d;
  if constexpr (kForm == kArgmin) idx[o] = best_s;
}

// The kernels' input staging: depth and mask interleaved, with a replicated
// first row and column, (B, H, W) x 2 -> (B, H + 1, W + 1, 2): padded
// (y, x) holds (depth, mask) at (max(y - 1, 0), max(x - 1, 0)). The pad is
// the reference's clamp of a floor of -1 (xt or yt in [-1e-4, 0)) to 0, so
// the quad needs no clamp. One thread per padded element.
__global__ void __launch_bounds__(256)
stage_kernel(const float* __restrict__ depth, const float* __restrict__ mask,
             float2* __restrict__ out, int h, int w) {
  const int px = blockIdx.x * blockDim.x + threadIdx.x;
  const int py = blockIdx.y, b = blockIdx.z;
  if (px > w) return;
  const size_t src = ((size_t)b * h + max(py - 1, 0)) * w + max(px - 1, 0);
  out[((size_t)b * (h + 1) + py) * (w + 1) + px] = make_float2(depth[src], mask[src]);
}

// ---------------------------------------------------------------------------
// K4's backward (march_grad): the VJP of the march at each pixel's winning
// sample. Replaces the backward of geomconsistentfr_tpu/ops/shadows_pallas.py
// `ray_march_min_distance_pallas_vjp` (`_vjp_bwd`, :776-808), whose forward is
// K2. The gradient of a min over samples is the gradient of its winner, so
// each thread re-evaluates one sample, at t* = ts[idx] (K2's int32 index into
// the same float32 table the forward read), and differentiates
//   dist = sqrt(|BA x BC|^2 + 1e-4) / sqrt(|BC|^2 + 1e-4)
// by hand: into the four bilinear depth taps and the pixel's own depth d0
// (through BA_z, BC_z and the denominator), and into the light point through
// BC and through the sample position, which moves with the border endpoint
// (ex, ey). The endpoint's 2x2 Jacobian d(ex, ey)/d(lx, ly) follows the
// branch that march_kernel's branchless selection takes and is zero where
// the clamp binds (torch.clamp passes the gradient at the bounds themselves,
// as the plain version does). Semantics are those of
// geomconsistentfr_torch/ops/shadows.py `march_vjp`, torch.autograd.grad of
// the plain sample evaluator.
//
// The sample's coordinates, its veto and its taps are those of march_kernel's
// sample_n2 (the same __fmaf_rn; rintf, floorf and ceilf give the integers
// its rounding adds give, and the clamped floor/ceil taps the same values as
// its quad), so the backward vetoes the samples the forward vetoed. A vetoed
// sample (a constant 1e6), a culled pixel (a constant sentinel) and a zero
// cotangent give no gradient: those threads skip the work. Each other thread atomicAdds its five depth
// contributions into d_depth (taps of neighbouring pixels overlap), and the
// block reduces its light gradient with warp shuffles, then across its eight
// warps in shared memory, into three atomics per block: a block is one image's
// 8 x 32 tile. Atomics make the float32 sums' order, and so their last bits,
// vary from run to run.
//
// What bounds it on an H100: per pixel about 60 float32 operations for the
// sample (as K1's) and about 110 for the endpoint Jacobian and the chain rule,
// against reading depth (five taps), mask, idx and the cotangent and writing
// d_depth: ~20 bytes a pixel. At the training shape (batch 3, 256^2) that is
// ~35 MFLOP (~0.5 us at 67 TFLOP/s) against ~4 MB (~1.2 us at 3.35 TB/s), both
// far below a launch's own few microseconds.

// march_grad runs once per pixel, not per sample, so it keeps the first
// version's per-tap helpers: clamped floorf/ceilf taps read from separate
// depth and mask arrays, rintf and float->int casts.
__device__ __forceinline__ float tap(const float* __restrict__ img, float iy,
                                     float ix, int h, int w) {
  const int y = (int)clampf(iy, 0.0f, (float)(h - 1));
  const int x = (int)clampf(ix, 0.0f, (float)(w - 1));
  return __ldg(img + y * w + x);
}

__device__ __forceinline__ float on_face(const float* __restrict__ m, float iy,
                                         float ix, int h, int w) {
  return tap(m, iy, ix, h, w) != 0.0f ? 1.0f : 0.0f;
}

// A block is one image's 8 x 32 tile: each row is one warp (the light
// gradient's reduction below relies on it).
constexpr int kGradRows = 8, kGradCols = 32;

struct GradParams {
  int batch, height, width;
  int bilinear;                 // 0: one-hot veto, 1: bilinear veto
  int live_cols;                // cull blocks per 8-row group; 0 = no cull
  int col_chunk;                // cull block width in pixels
};

__device__ __forceinline__ int tap_index(float iy, float ix, int h, int w) {
  const int y = (int)clampf(iy, 0.0f, (float)(h - 1));
  const int x = (int)clampf(ix, 0.0f, (float)(w - 1));
  return y * w + x;
}

// One pixel's gradient: adds its depth contributions to dgrad and returns its
// light gradient in (gl_x, gl_y, gl_z). Returns early where there is none.
__device__ __forceinline__ void pixel_grad(
    const float* __restrict__ dimg, const float* __restrict__ mimg,
    float* __restrict__ dgrad, float lx, float ly, float lz, float t, float g,
    int row, int col, int h, int w, bool bilinear, float& gl_x, float& gl_y,
    float& gl_z) {
  const float half_w = 0.5f * (float)w, half_h = 0.5f * (float)h;
  const float left = -half_w, right = (float)w - half_w - 1.0f;
  const float bottom = 1.0f - half_h, top = half_h;
  const float xx = (float)col - half_w;
  const float yy = half_h - (float)row;

  // Border endpoint, as in march_kernel.
  const float den = (lx - xx) + kEps;
  const float slope = (ly - yy) / den;
  const float icpt = ly - slope * lx;
  const bool zx_neg = lx < left, zx_pos = lx > right;
  const bool zx_mid = !(zx_neg || zx_pos);
  const bool zy_neg = ly < bottom, zy_pos = ly > top;
  const bool zy_mid = !(zy_neg || zy_pos);
  const float xv = zx_neg ? left : right;
  const float ey_v = slope * xv + icpt;
  const float yh = zy_neg ? bottom : top;
  const float se = slope + kEps;
  const float ex_h = (yh - icpt) / se;
  const bool inter = ex_h >= left && ex_h <= right;
  const float ex_c = inter ? ex_h : xv;
  const float ey_c = inter ? yh : ey_v;
  const bool inside = zx_mid && zy_mid;
  const float ex_raw = inside ? lx : (zy_mid ? xv : (zx_mid ? ex_h : ex_c));
  const float ey_raw = inside ? ly : (zy_mid ? ey_v : (zx_mid ? yh : ey_c));
  const float ex = clampf(ex_raw, left, right);
  const float ey = clampf(ey_raw, bottom, top);

  // The sample at t*, as in march_kernel.
  const float diff_x = ex - xx, diff_y = ey - yy;
  const float sx = __fmaf_rn(t, diff_x, xx);
  const float sy = __fmaf_rn(t, diff_y, yy);
  const float xt = (sx + half_w) - kEps;
  const float yt = (half_h - sy) - kEps;
  bool face;
  if (!bilinear) {
    face = on_face(mimg, half_h - rintf(sy), rintf(sx) + half_w, h, w) != 0.0f;
  } else {
    const float xtc = clampf(xt, 0.0f, (float)(w - 1));
    const float ytc = clampf(yt, 0.0f, (float)(h - 1));
    const float vx0 = floorf(xtc), vy0 = floorf(ytc);
    const float ux0 = 1.0f - (xtc - vx0), ux1 = 1.0f - ((vx0 + 1.0f) - xtc);
    const float uy0 = 1.0f - (ytc - vy0), uy1 = 1.0f - ((vy0 + 1.0f) - ytc);
    const float vtop = on_face(mimg, vy0, vx0, h, w) * ux0 +
                       on_face(mimg, vy0, vx0 + 1.0f, h, w) * ux1;
    const float vbot = on_face(mimg, vy0 + 1.0f, vx0, h, w) * ux0 +
                       on_face(mimg, vy0 + 1.0f, vx0 + 1.0f, h, w) * ux1;
    face = (vtop * uy0 + vbot * uy1) > 0.5f;
  }
  if (!face) return;

  const float x0 = floorf(xt), x1 = ceilf(xt);
  const float y0 = floorf(yt), y1 = ceilf(yt);
  const float wx0 = x1 - xt, wx1 = xt - x0;
  const float wy0 = y1 - yt, wy1 = yt - y0;
  const int i_ul = tap_index(y0, x0, h, w), i_ur = tap_index(y0, x1, h, w);
  const int i_ll = tap_index(y1, x0, h, w), i_lr = tap_index(y1, x1, h, w);
  const float d_ul = __ldg(dimg + i_ul), d_ur = __ldg(dimg + i_ur);
  const float d_ll = __ldg(dimg + i_ll), d_lr = __ldg(dimg + i_lr);
  const float iu = d_ul * wx0 + d_ur * wx1;
  const float il = d_ll * wx0 + d_lr * wx1;
  const float d_interp = iu * wy0 + il * wy1;

  const int i_px = row * w + col;
  const float d0 = __ldg(dimg + i_px);
  const float bc_x = lx - xx, bc_y = ly - yy, bc_z = lz - d0;
  const float denom = sqrtf(bc_x * bc_x + bc_y * bc_y + bc_z * bc_z + kEps);
  const float ba_x = (xt - half_w) - xx;
  const float ba_y = (half_h - yt) - yy;
  const float ba_z = d_interp - d0;
  const float cx = ba_y * bc_z - ba_z * bc_y;
  const float cy = ba_z * bc_x - ba_x * bc_z;
  const float cz = ba_x * bc_y - ba_y * bc_x;
  const float num = sqrtf(cx * cx + cy * cy + cz * cz + kEps);

  // dist = num / denom.
  const float g_num = g / denom;
  const float g_den = -(g * num) / (denom * denom);
  const float g_n2 = 0.5f * g_num / num;
  const float gcx = 2.0f * cx * g_n2, gcy = 2.0f * cy * g_n2, gcz = 2.0f * cz * g_n2;
  const float g_bax = gcz * bc_y - gcy * bc_z;
  const float g_bay = gcx * bc_z - gcz * bc_x;
  const float g_baz = gcy * bc_x - gcx * bc_y;
  const float g_dn = g_den / denom;
  const float g_bcx = (gcy * ba_z - gcz * ba_y) + g_dn * bc_x;
  const float g_bcy = (gcz * ba_x - gcx * ba_z) + g_dn * bc_y;
  const float g_bcz = (gcx * ba_y - gcy * ba_x) + g_dn * bc_z;

  // Depth: the four taps through d_interp, and d0 through BA_z and BC_z.
  const float g_u = g_baz * wy0, g_l = g_baz * wy1;
  atomicAdd(dgrad + i_ul, g_u * wx0);
  atomicAdd(dgrad + i_ur, g_u * wx1);
  atomicAdd(dgrad + i_ll, g_l * wx0);
  atomicAdd(dgrad + i_lr, g_l * wx1);
  atomicAdd(dgrad + i_px, -g_baz - g_bcz);

  // The sample position: BA_x, BA_y and the bilinear weights move with it.
  const float g_xt = g_bax + g_baz * ((d_ur - d_ul) * wy0 + (d_lr - d_ll) * wy1);
  const float g_yt = -g_bay + g_baz * (il - iu);
  const float g_ex = t * g_xt;     // sx = xx + t * (ex - xx); xt = sx + ...
  const float g_ey = -(t * g_yt);  // yt = half_h - sy - ...

  // d(ex, ey)/d(lx, ly) along the branch taken; zero where the clamp binds.
  const float ds_lx = -slope / den, ds_ly = 1.0f / den;
  const float di_lx = -(ds_lx * lx) - slope, di_ly = 1.0f - ds_ly * lx;
  float jxx = 0.0f, jxy = 0.0f, jyx = 0.0f, jyy = 0.0f;
  if (inside) {
    jxx = 1.0f;
    jyy = 1.0f;
  } else {
    if (!zy_mid && (zx_mid || inter)) {  // ex = ex_h
      jxx = -(di_lx + ex_h * ds_lx) / se;
      jxy = -(di_ly + ex_h * ds_ly) / se;
    }
    if (zy_mid || (!zx_mid && !inter)) {  // ey = ey_v
      jyx = ds_lx * xv + di_lx;
      jyy = ds_ly * xv + di_ly;
    }
  }
  if (!(ex_raw >= left && ex_raw <= right)) jxx = jxy = 0.0f;
  if (!(ey_raw >= bottom && ey_raw <= top)) jyx = jyy = 0.0f;

  gl_x = g_bcx + (g_ex * jxx + g_ey * jyx);
  gl_y = g_bcy + (g_ex * jxy + g_ey * jyy);
  gl_z = g_bcz;
}

// idx: K2's winning sample per pixel; ts: the table it indexes; g: the
// cotangent of the march's output. d_depth and d_light arrive zeroed.
__global__ void __launch_bounds__(kGradRows * kGradCols)
march_grad_kernel(const float* __restrict__ depth, const float* __restrict__ mask,
                  const float* __restrict__ light, const float* __restrict__ ts,
                  const int32_t* __restrict__ idx, const uint8_t* __restrict__ live,
                  const float* __restrict__ g, float* __restrict__ d_depth,
                  float* __restrict__ d_light, GradParams p) {
  const int h = p.height, w = p.width;
  const int b = blockIdx.z;
  const int row = blockIdx.y * kGradRows + threadIdx.y;
  const int col = blockIdx.x * kGradCols + threadIdx.x;
  const size_t plane = (size_t)h * w;
  float gl_x = 0.0f, gl_y = 0.0f, gl_z = 0.0f;

  if (row < h && col < w) {
    const size_t o = (size_t)b * plane + (size_t)row * w + col;
    const float gv = g[o];
    bool on = gv != 0.0f;
    if (on && p.live_cols > 0) {
      const int grp = row / 8, c = col / p.col_chunk;
      on = live[((size_t)b * (h / 8) + grp) * p.live_cols + c] != 0;
    }
    if (on) {
      pixel_grad(depth + (size_t)b * plane, mask + (size_t)b * plane,
                 d_depth + (size_t)b * plane, light[3 * b + 0], light[3 * b + 1],
                 light[3 * b + 2], ts[idx[o]], gv, row, col, h, w, p.bilinear != 0,
                 gl_x, gl_y, gl_z);
    }
  }

  // Block sum of the light gradient: each row of the block is one warp.
  for (int off = 16; off > 0; off >>= 1) {
    gl_x += __shfl_down_sync(0xffffffffu, gl_x, off);
    gl_y += __shfl_down_sync(0xffffffffu, gl_y, off);
    gl_z += __shfl_down_sync(0xffffffffu, gl_z, off);
  }
  __shared__ float s_sum[3][kGradRows];
  if (threadIdx.x == 0) {
    s_sum[0][threadIdx.y] = gl_x;
    s_sum[1][threadIdx.y] = gl_y;
    s_sum[2][threadIdx.y] = gl_z;
  }
  __syncthreads();
  if (threadIdx.y == 0 && threadIdx.x < 3) {
    float s = 0.0f;
    for (int i = 0; i < kGradRows; ++i) s += s_sum[threadIdx.x][i];
    if (s != 0.0f) atomicAdd(d_light + 3 * b + threadIdx.x, s);
  }
}

}  // namespace

static int log2_or_minus1(int v) {
  for (int k = 0; k < 31; ++k) {
    if (v == 1 << k) return k;
  }
  return -1;
}

// Plain C entry point (bound with ctypes): `form` is K1 (0), K2 (1) or K3 (2).
// Stages depth and mask into `staged` ((B, H + 1, W + 1, 2) float32 scratch,
// stage_kernel), then launches the march, both on `stream`, and returns
// cudaGetLastError() so that the caller can raise on a refused launch.
extern "C" int gcfr_march_launch(
    int form, const float* depth, const float* mask, float* staged,
    const float* light, const float* ts,
    const float* t_map, const int32_t* centre_idx, const float* centre_ts,
    float* out, int32_t* idx, int batch, int height, int width, int n_ts,
    int bilinear, int cull, int col_chunk, int gate_on, int centre_scale,
    int centre_n, float lo_x, float hi_x, float lo_y, float hi_y,
    float gate_bias, float t_lo, float t_hi, void* stream) {
  MarchParams p{batch, height, width, n_ts, bilinear, cull, col_chunk, gate_on,
                centre_scale, centre_n, log2_or_minus1(col_chunk),
                log2_or_minus1(centre_scale), lo_x, hi_x, lo_y, hi_y, gate_bias,
                t_lo, t_hi};
  dim3 block(kBlockCols, kBlockRows);
  dim3 grid((width + kBlockCols - 1) / kBlockCols,
            (height + kBlockRows - 1) / kBlockRows, batch);
  const size_t smem = (size_t)n_ts * sizeof(float);
  cudaStream_t st = (cudaStream_t)stream;
  float2* dm2 = reinterpret_cast<float2*>(staged);
  stage_kernel<<<dim3((width + 256) / 256, height + 1, batch), 256, 0, st>>>(depth, mask, dm2, height, width);
  switch (form) {
    case kMin:
      march_kernel<kMin><<<grid, block, smem, st>>>(dm2, mask, light, ts, t_map, centre_idx, centre_ts, out, idx, p);
      break;
    case kArgmin:
      march_kernel<kArgmin><<<grid, block, smem, st>>>(dm2, mask, light, ts, t_map, centre_idx, centre_ts, out, idx, p);
      break;
    case kRefine:
      march_kernel<kRefine><<<grid, block, smem, st>>>(dm2, mask, light, ts, t_map, centre_idx, centre_ts, out, idx, p);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// Plain C entry point of K4's backward (march_grad); d_depth (B, H, W) and
// d_light (B, 3) must be zeroed by the caller. Returns cudaGetLastError().
extern "C" int gcfr_march_grad_launch(
    const float* depth, const float* mask, const float* light, const float* ts,
    const int32_t* idx, const uint8_t* live, const float* g, float* d_depth,
    float* d_light, int batch, int height, int width, int bilinear,
    int live_cols, int col_chunk, void* stream) {
  GradParams p{batch, height, width, bilinear, live_cols, col_chunk};
  dim3 block(kGradCols, kGradRows);
  dim3 grid((width + kGradCols - 1) / kGradCols,
            (height + kGradRows - 1) / kGradRows, batch);
  march_grad_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      depth, mask, light, ts, idx, live, g, d_depth, d_light, p);
  return (int)cudaGetLastError();
}

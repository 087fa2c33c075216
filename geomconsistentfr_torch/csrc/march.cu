// Shadow ray-march kernels: per pixel, the minimum over a set of offsets t of
// the 3D distance from the pixel->light ray to the bilinearly sampled depth
// point on the pixel->border segment. One templated kernel, three forms, fed
// by one staging kernel (stage_kernel, below them, which at the draft tier
// also pools), the unpack of K2's packed keys (unpack_key_kernel, after the
// march: the sample-sharded march K5 and its serving form combine them), and
// the backward of K2 (march_grad_kernel, last: the training march K4 is K2
// forward and march_grad backward, K5 K2's key form on a rank's slice of the
// t grid, one MIN over the ranks, the unpack, then march_grad):
//
//  K1 (kMin)     the min over the t grid. Replaces the inference form of
//                geomconsistentfr_tpu/ops/shadows_pallas.py `_march_kernel`,
//                reached through `ray_march_min_distance_pallas`.
//  K2 (kArgmin)  K1 plus the int32 index of the first winning sample (strict
//                `<` on norm^2; 0 for a culled pixel, and for a pixel whose
//                every sample is vetoed). Replaces `_march_kernel` with
//                want_tstar, reached through `ray_march_min_distance_pallas(
//                ..., return_argmin_t=True)`: the draft tier's low-resolution
//                march, and the forward of the training autograd. Given a
//                key pointer, it writes one packed 64-bit (distance, t) word a
//                pixel in place of both (pack_key, below): the sample-sharded
//                marches (K5 and the sample-parallel serving march) reduce
//                those words with one MIN over their ranks and unpack them
//                with unpack_key_kernel.
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
// Design. One thread per pixel (K2 at training: 2 threads, below); a block is
// 8 rows x 32 threads, the cull's 8-row unit (8 x 16 measured the same, 8 x
// 64 slower); the loop unrolled 4
// times, K1 and K2 held to 64 registers (4 blocks an SM) and K3 to 5 blocks
// (unrolling 1 or 2 times, or 40 registers, measured slower). Per-pixel
// constants (endpoint, BC, denominator, K3's centre) are computed once in
// registers; the t table (K1, K2) or the window offsets (K3) are staged in
// shared memory. K2 marches small grids (the draft tier's 64 x 64^2 pixels,
// training's 3 x 256^2: 1.45 waves of blocks on the card, the second at
// half occupancy), so where a pixel has 128 samples or more it runs on two
// neighbouring threads of a warp, lane l over samples l, l + 2, ...
// (interleaved, so the lanes' taps stay a step apart, in the same cache
// lines; contiguous slices measured slower), and the lanes combine their
// first winners with shuffles on (norm^2, index): exact, so K2 keeps the
// strict-< first winner. Per sample (sample_taps, sample_n2):
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
//    reads 4 taps a sample instead of 5, fast 4 instead of 8. The 'hat' veto
//    takes the one-hot veto's row, dy as above, and along it the bilinear
//    veto's two columns with their hat weights ux0, ux1; 'hat_y' the one-hot
//    veto's column, dx, and the two rows with uy0, uy1. Each of their taps
//    is a corner of the quad for the two reasons above, the [-1e-4, 0) band
//    included: there the clipped floor is 0 where the quad's is -1, the
//    quad's first column (row) is the pad, which holds column (row) 0, under
//    the weight 1 of the clipped tap 0, and its second the image's column
//    (row) 0 under the weight 0 of the clipped tap 1. So neither loads a tap
//    of its own either.
//  * The range. For t in [0, 1] the sample lies on the segment between the
//    pixel and the clamped endpoint, so xt lies in [-1e-4, W - 1) for W up
//    to 2048: the quad's only index outside the image is -1, which the pad
//    holds, and floor(xt) + 1 <= W - 1. From W - 1 = 2048 on (H likewise),
//    W - 1 - 1e-4 rounds to W - 1 in float32, so the quad's second column
//    would be W, one past the padded plane; and for t outside [0, 1] the
//    sample leaves the segment, where the reference clamps every tap to the
//    image (the plain _gather) and clips the veto's rounded index. So the
//    kernels have a second form, kClamp, that loads each tap at its own
//    clamped index, as the plain version gathers it, and selects nothing
//    from a quad. The wrapper launches it where the table (or the refine's
//    t range, or march_grad's t) leaves [0, 1] or H or W exceeds 2048; the
//    preset tables at the preset sizes never take it. The quad form clamps
//    every t into [0, 1] as it stages it, so no input reads out of bounds
//    whatever it is given; where the wrapper picks it, the clamp changes
//    none.
//  * Tails. H and W need only be even, as RenderConfig asks: the grid
//    rounds both up, every store and the cull's reads are guarded by the
//    pixel's bounds, and a last row group of fewer than 8 rows is a cull
//    unit of its own (the JAX package pads it with rows off the face).
//  * The cull is in the kernel. K2 and the draft path's K3 read one byte per
//    cull unit (8 rows x col_chunk, or the whole row group for the row
//    cull) that stage_kernel wrote; K1 and K3 around a t_map read the
//    unit's mask themselves: a block inside one unit (chunks of 32, 64 and
//    the row) decides with one __syncthreads_or, one that meets several
//    keeps a shared flag per unit. A thread whose unit holds no face writes
//    the all-vetoed sentinel and skips the loop.
// The loop carries the min of the raw cross-product norm^2 (1e30 for a
// vetoed sample); sqrt(n2 + 1e-4) / denom is monotone in n2, so the result
// equals the min of per-sample distances exactly, and is taken once at the
// end. K2 carries the sample index beside it; the wrapper maps the index to t
// through the same float32 table (shadows_pallas.py:1152-1154), or the
// kernel packs the winner's t itself (its key form).
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

// K2's threads a pixel: kSplitLanes where the table has at least kSplitFrom
// samples, else 1. Two lanes fill the tail of a grid whose last wave is
// part empty (at one thread a pixel, (3, 256^2) is 768 blocks, 1.45 waves
// of 528), but each lane repeats the pixel's prologue. Two lanes against
// one on an H100 (PERF.md §6): -9% at (3, 256^2, 160 samples, training),
// -1%, within the spread, at (3, 256^2, 80: K5's slice), +4% at (64, 64^2,
// 80: the draft tier, 1.94 waves). So the split pays by the samples a lane
// shares out, not by the tail alone. Lane l marches samples l, l + lanes,
// ... of the table and the lanes combine their (norm^2, index) pairs with
// warp shuffles.
constexpr int kSplitLanes = 2, kSplitFrom = 128;
static_assert(kSplitLanes == 1 || kSplitLanes == 2 || kSplitLanes == 4 || kSplitLanes == 8,
              "K2's lanes per pixel: a power of two that divides a warp's 32 columns");

enum Form : int { kMin = 0, kArgmin = 1, kRefine = 2 };
// The mask veto (ops/shadows.py VETOES, in this order).
enum Veto : int { kOnehot = 0, kBilinear = 1, kHat = 2, kHatY = 3 };

struct MarchParams {
  int batch, height, width, n_ts;
  int veto;                     // enum Veto (the kOnehot instantiations run kBilinear too)
  int cull;                     // 1: skip pixels whose 8-row x col_chunk unit holds no face
  int col_chunk;                // cull unit width in pixels
  int gate_on;
  int centre_scale, centre_n;   // K3's index form: the draft scale, the table's length
  int chunk_shift, scale_shift; // log2 of col_chunk and centre_scale, -1 if not a power of two
  float lo_x, hi_x, lo_y, hi_y, gate_bias;
  float t_lo, t_hi;             // K3: the full t grid's first and last offsets
  int row_groups;               // ceil(H / 8): the cull units' rows
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
  unsigned quad_bias, dy_bias;  // see sample_taps
};

// The border endpoint and what march_grad differentiates it through:
// branchless 9-case analysis of the reference (:363-442).
struct Endpoint {
  float den, slope, icpt, se, xv, ex_h, ex_raw, ey_raw, ex, ey;
  bool zx_mid, zy_mid, inter, inside;
};

__device__ __forceinline__ Endpoint border_endpoint(float lx, float ly, float xx, float yy, float left,
                                                    float right, float bottom, float top) {
  Endpoint e;
  e.den = (lx - xx) + kEps;
  e.slope = (ly - yy) / e.den;
  e.icpt = ly - e.slope * lx;
  const bool zx_neg = lx < left, zx_pos = lx > right;
  e.zx_mid = !(zx_neg || zx_pos);
  const bool zy_neg = ly < bottom, zy_pos = ly > top;
  e.zy_mid = !(zy_neg || zy_pos);
  e.xv = zx_neg ? left : right;
  const float ey_v = e.slope * e.xv + e.icpt;
  const float yh = zy_neg ? bottom : top;
  e.se = e.slope + kEps;
  e.ex_h = (yh - e.icpt) / e.se;
  e.inter = e.ex_h >= left && e.ex_h <= right;
  const float ex_c = e.inter ? e.ex_h : e.xv;
  const float ey_c = e.inter ? yh : ey_v;
  e.inside = e.zx_mid && e.zy_mid;
  e.ex_raw = e.inside ? lx : (e.zy_mid ? e.xv : (e.zx_mid ? e.ex_h : ex_c));
  e.ey_raw = e.inside ? ly : (e.zy_mid ? ey_v : (e.zx_mid ? yh : ey_c));
  e.ex = clampf(e.ex_raw, left, right);
  e.ey = clampf(e.ey_raw, bottom, top);
  return e;
}

// The pixel's constants from its image's padded plane and the light point;
// returns the denominator sqrt(|BC|^2 + 1e-4). Shared by the march and
// march_grad, so both march from the same endpoint.
__device__ __forceinline__ float init_pixel(Pixel& q, Endpoint& e, const float2* __restrict__ img, int row,
                                            int col, int h, int w, float lx, float ly, float lz) {
  const unsigned wp = w + 1;
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
  e = border_endpoint(lx, ly, q.xx, q.yy, left, right, bottom, top);
  q.diff_x = e.ex - q.xx;
  q.diff_y = e.ey - q.yy;
  q.d0 = img[(size_t)(row + 1) * wp + col + 1].x;
  q.bc_x = lx - q.xx;
  q.bc_y = ly - q.yy;
  q.bc_z = lz - q.d0;
  return sqrtf(q.bc_x * q.bc_x + q.bc_y * q.bc_y + q.bc_z * q.bc_z + kEps);
}

// One sample's position, its tap quad and its veto: everything of a sample
// that the march and march_grad share.
struct Taps {
  float xt, yt, x0, y0, x1, y1;  // shifted coordinates, their floors and ceils
  unsigned bxi, byi, cxi, cyi;   // the floor (b) and ceil (c) rounding adds' bits (the quad form)
  int ix0, ix1, iy0, iy1;        // the clamped floor and ceil taps (the clamped form)
  float2 q00, q01, q10, q11;     // (depth, mask) at rows floor(yt) + (0, 1), columns floor(xt) + (0, 1)
  bool face;                     // the veto passes
};

// The face indicator's threshold under the hat weights u0, u1 of two taps
// whose (depth, mask) are a, b: the 0/1 indicator times a weight >= 0 is a
// select. A tie (u0 = u1 = 0.5) passes only with both taps on the face.
__device__ __forceinline__ bool hat_face(float2 a, float2 b, float u0, float u1) {
  return ((a.y != 0.0f ? u0 : 0.0f) + (b.y != 0.0f ? u1 : 0.0f)) > 0.5f;
}

// The clamped form of sample_taps (kClamp, the header's range): each tap at
// its own index clamped to the image, loaded on its own, as the plain
// _Scene.sample_n2 gathers it; floor, ceil and rint on the conversion unit.
template <int kVeto>
__device__ __forceinline__ void clamped_taps(Taps& s, const float2* __restrict__ img, unsigned wp, float wm1,
                                             float hm1, const Pixel& q, float sx, float sy) {
  const int wl = (int)wm1, hl = (int)hm1;
  const auto at = [&](int iy, int ix) { return __ldg(img + (size_t)(iy + 1) * wp + (ix + 1)); };
  s.x0 = floorf(s.xt);
  s.x1 = ceilf(s.xt);
  s.y0 = floorf(s.yt);
  s.y1 = ceilf(s.yt);
  s.ix0 = (int)clampf(s.x0, 0.0f, wm1);
  s.ix1 = (int)clampf(s.x1, 0.0f, wm1);
  s.iy0 = (int)clampf(s.y0, 0.0f, hm1);
  s.iy1 = (int)clampf(s.y1, 0.0f, hm1);
  s.q00 = at(s.iy0, s.ix0);
  s.q01 = at(s.iy0, s.ix1);
  s.q10 = at(s.iy1, s.ix0);
  s.q11 = at(s.iy1, s.ix1);
  // The banker's-rounded column and row, clipped.
  const int vx = (int)clampf(rintf(sx) + q.half_w, 0.0f, wm1);
  const int vy = (int)clampf(q.half_h - rintf(sy), 0.0f, hm1);
  if constexpr (kVeto == kOnehot) {
    s.face = at(vy, vx).y != 0.0f;
  } else {
    const float xtc = clampf(s.xt, 0.0f, wm1), ytc = clampf(s.yt, 0.0f, hm1);
    const float fx0 = floorf(xtc), fy0 = floorf(ytc);
    const int cx0 = (int)fx0, cy0 = (int)fy0, cx1 = min(cx0 + 1, wl), cy1 = min(cy0 + 1, hl);
    const float ux0 = 1.0f - (xtc - fx0), ux1 = 1.0f - ((fx0 + 1.0f) - xtc);
    const float uy0 = 1.0f - (ytc - fy0), uy1 = 1.0f - ((fy0 + 1.0f) - ytc);
    if constexpr (kVeto == kHat) {
      s.face = hat_face(at(vy, cx0), at(vy, cx1), ux0, ux1);
    } else if constexpr (kVeto == kHatY) {
      s.face = hat_face(at(cy0, vx), at(cy1, vx), uy0, uy1);
    } else {
      const float2 m00 = at(cy0, cx0), m01 = at(cy0, cx1), m10 = at(cy1, cx0), m11 = at(cy1, cx1);
      const float vtop = (m00.y != 0.0f ? ux0 : 0.0f) + (m01.y != 0.0f ? ux1 : 0.0f);
      const float vbot = (m10.y != 0.0f ? ux0 : 0.0f) + (m11.y != 0.0f ? ux1 : 0.0f);
      s.face = (vtop * uy0 + vbot * uy1) > 0.5f;
    }
  }
}

// img is the image's padded plane: (H + 1) x (W + 1) float2, wp = W + 1.
template <int kVeto, bool kClamp>
__device__ __forceinline__ Taps sample_taps(const float2* __restrict__ img, unsigned wp, float wm1, float hm1,
                                            const Pixel& q, float t) {
  Taps s;
  const float sx = __fmaf_rn(t, q.diff_x, q.xx);
  const float sy = __fmaf_rn(t, q.diff_y, q.yy);
  s.xt = (sx + q.half_w) - kEps;
  s.yt = (q.half_h - sy) - kEps;
  if constexpr (kClamp) {
    clamped_taps<kVeto>(s, img, wp, wm1, hm1, q, sx, sy);
    return s;
  }

  // floor and ceil on the float32 pipe, the quad's indices on the integer pipe.
  const float bx0 = __fadd_rd(s.xt, kRound), by0 = __fadd_rd(s.yt, kRound);
  const float bx1 = __fadd_ru(s.xt, kRound), by1 = __fadd_ru(s.yt, kRound);
  s.x0 = bx0 - kRound;
  s.y0 = by0 - kRound;
  s.x1 = bx1 - kRound;
  s.y1 = by1 - kRound;
  s.bxi = __float_as_uint(bx0);
  s.byi = __float_as_uint(by0);
  s.cxi = __float_as_uint(bx1);
  s.cyi = __float_as_uint(by1);
  // The quad's first corner, padded (floor(yt) + 1, floor(xt) + 1), straight
  // from the biased sums' bits: by * wp + bx + quad_bias (mod 2^32).
  const float2* __restrict__ p0 = img + (s.byi * wp + s.bxi + q.quad_bias);
  const float2* __restrict__ p1 = p0 + wp;
  s.q00 = __ldg(p0);
  s.q01 = __ldg(p0 + 1);
  s.q10 = __ldg(p1);
  s.q11 = __ldg(p1 + 1);

  // The one-hot veto's tap (H/2 - rint(sy), rint(sx) + W/2), a corner of
  // the quad: its offsets from the quad's first corner, dx = vx - floor(xt)
  // and dy = vy - floor(yt), are 0 or 1 (the header says why). 'hat' reads
  // its row, 'hat_y' its column.
  unsigned dx = 0, dy = 0;
  if constexpr (kVeto != kBilinear) {
    const unsigned rxi = __float_as_uint(__fadd_rn(sx, kRound));
    const unsigned ryi = __float_as_uint(__fadd_rn(sy, kRound));
    dx = rxi - s.bxi + q.half_w_i;
    dy = q.dy_bias - ryi - s.byi;
  }
  if constexpr (kVeto == kOnehot) {
    // Selected from the quad with no load of its own.
    s.face = (dy ? (dx ? s.q11.y : s.q10.y) : (dx ? s.q01.y : s.q00.y)) != 0.0f;
  } else {
    // The hat weights of the clipped position's two taps on each axis.
    // floor(clip(xt)) is max(floor(xt), 0) on [-1e-4, W - 1); the 0/1
    // indicator times a weight >= 0 is a select.
    const float xtc = clampf(s.xt, 0.0f, wm1), ytc = clampf(s.yt, 0.0f, hm1);
    const float vx0 = fmaxf(s.x0, 0.0f), vy0 = fmaxf(s.y0, 0.0f);
    const float ux0 = 1.0f - (xtc - vx0), ux1 = 1.0f - ((vx0 + 1.0f) - xtc);
    const float uy0 = 1.0f - (ytc - vy0), uy1 = 1.0f - ((vy0 + 1.0f) - ytc);
    if constexpr (kVeto == kHat) {  // the rounded row's two columns
      s.face = dy ? hat_face(s.q10, s.q11, ux0, ux1) : hat_face(s.q00, s.q01, ux0, ux1);
    } else if constexpr (kVeto == kHatY) {  // the rounded column's two rows
      s.face = dx ? hat_face(s.q01, s.q11, uy0, uy1) : hat_face(s.q00, s.q10, uy0, uy1);
    } else {
      // The bilinear face indicator at the clipped position, thresholded at 0.5.
      const float vtop = (s.q00.y != 0.0f ? ux0 : 0.0f) + (s.q01.y != 0.0f ? ux1 : 0.0f);
      const float vbot = (s.q10.y != 0.0f ? ux0 : 0.0f) + (s.q11.y != 0.0f ? ux1 : 0.0f);
      s.face = (vtop * uy0 + vbot * uy1) > 0.5f;
    }
  }
  return s;
}

// The cross-product norm^2 of one sample at offset t, or 1e30 where the veto
// rejects it: _Scene.sample_n2 of ops/shadows.py.
template <int kVeto, bool kClamp>
__device__ __forceinline__ float sample_n2(const float2* __restrict__ img, unsigned wp,
                                           float wm1, float hm1, const Pixel& q,
                                           float t) {
  const Taps s = sample_taps<kVeto, kClamp>(img, wp, wm1, hm1, q, t);
  const float wx0 = s.x1 - s.xt, wx1 = s.xt - s.x0;
  const float iu = s.q00.x * wx0 + s.q01.x * wx1;
  const float il = s.q10.x * wx0 + s.q11.x * wx1;
  const float d_interp = iu * (s.y1 - s.yt) + il * (s.yt - s.y0);

  const float ba_x = (s.xt - q.half_w) - q.xx;
  const float ba_y = (q.half_h - s.yt) - q.yy;
  const float ba_z = d_interp - q.d0;
  const float cx = ba_y * q.bc_z - ba_z * q.bc_y;
  const float cy = ba_z * q.bc_x - ba_x * q.bc_z;
  const float cz = ba_x * q.bc_y - ba_y * q.bc_x;
  const float n2 = cx * cx + cy * cy + cz * cz;
  return s.face ? n2 : kOffFaceN2;
}

// K2's key form: one 64-bit word whose signed order is the lexicographic
// order of (distance, t). The high word is the distance exactly as `out`
// would hold it (bias included), as an order-preserving int32: its float
// bits, -0 taken as +0, and where negative (a negative shadow_bias can make
// min_d + bias < 0) its 31 low bits flipped, so a more negative float maps
// to a smaller int. The low word is the winning t's the same way, -0 taken as
// +0, its sign bit then flipped, so that it orders as an unsigned word (a
// table may hold t < 0). So the signed int64 MIN of a pixel's keys over the ranks is the global
// minimum distance and, among the ranks that reach it, the smallest t: the
// JAX package's two pmins (shadows_pallas.py:851-855). ops/shadows.py
// pack_march_key is its plain version, unpack_march_key unpack_key_kernel's.
__device__ __forceinline__ long long pack_key(float d, float t) {
  int hi = d == 0.0f ? 0 : __float_as_int(d);
  hi = hi < 0 ? hi ^ 0x7fffffff : hi;
  int lo = t == 0.0f ? 0 : __float_as_int(t);
  lo = lo < 0 ? lo ^ 0x7fffffff : lo;
  return (long long)(((unsigned long long)(unsigned)hi << 32) | ((unsigned)lo ^ 0x80000000u));
}

// The min (K1, K3) or first argmin (K2) of sample_n2 over samples begin,
// begin + kStep, ... < n of the staged table.
template <int kForm, int kVeto, bool kClamp, int kStep>
__device__ __forceinline__ void march_samples(const float2* __restrict__ img, unsigned wp,
                                              float wm1, float hm1, const Pixel& q,
                                              const float* s_ts, int begin, int n, float t_centre,
                                              float t_lo, float t_hi, float& best,
                                              int& best_s) {
#pragma unroll (kUnroll)
  for (int s = begin; s < n; s += kStep) {
    float t = s_ts[s];
    if constexpr (kForm == kRefine) t = clampf(t_centre + t, t_lo, t_hi);
    const float v = sample_n2<kVeto, kClamp>(img, wp, wm1, hm1, q, t);
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
// stage_kernel writes them. The cull reads `flags` (one byte per 8-row x
// col_chunk unit, stage_kernel's) where given, else each unit's (B, H, W)
// `mask` (4 bytes a pixel, not dm's 8). ts: the t table (K1, K2) or
// the window offsets (K3). K3's centre: t_map (B, H, W), or, where centre_idx
// is given, centre_ts[centre_idx[b, row / s, col / s]] (K2's winners and the
// table they index). idx: K2's winning sample indices. key: K2's key form,
// one pack_key(distance, ts[winner]) word a pixel, written in place of out
// and idx (both then unused). Unused pointers may be null.
// K1 and K2 hold 4 blocks an SM (64 registers); K3, whose 8-sample loop gains
// less from registers than from blocks, 5. With kLanes threads a pixel (K2
// only) a block is 8 rows x 32 / kLanes columns. Each instantiation holds one
// form of the taps (kClamp: the header's range) and one veto, except that the
// one-hot instantiation also holds the bilinear veto's loop and picks it from
// p.veto: the presets' two vetoes in one function keep their loops' code.
// Compiled alone, the one-hot loop took 305 instructions against 301 and K1
// strict ran 1% slower on an H100 (PERF.md §6).
template <int kForm, int kLanes, int kVeto, bool kClamp>
__global__ void __launch_bounds__(kThreads, kForm == kRefine ? 5 : 4)
march_kernel(const float2* __restrict__ dm, const float* __restrict__ mask,
             const uint8_t* __restrict__ flags, const float* __restrict__ light,
             const float* __restrict__ ts, const float* __restrict__ t_map,
             const int32_t* __restrict__ centre_idx, const float* __restrict__ centre_ts,
             float* __restrict__ out, int32_t* __restrict__ idx, long long* __restrict__ key,
             MarchParams p) {
  static_assert(kLanes == 1 || kForm == kArgmin, "only K2 splits a pixel's samples");
  constexpr int kCols = kBlockCols / kLanes;  // pixel columns a block covers
  extern __shared__ float s_ts[];
  __shared__ int s_live[kBlockCols];
  const int tid = threadIdx.y * kBlockCols + threadIdx.x;
  const int lane = threadIdx.x % kLanes;  // the pixel's lanes are neighbours in a warp
  const int h = p.height, w = p.width;
  const int b = blockIdx.z;
  const int row = blockIdx.y * kBlockRows + threadIdx.y;
  const int col0 = blockIdx.x * kCols;
  const int col = col0 + threadIdx.x / kLanes;
  const bool inb = row < h && col < w;
  const bool writer = inb && lane == 0;
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
  // One pixel's result: its distance and (K2) its winning sample.
  const auto emit = [&](float d, int s) {
    if constexpr (kForm == kArgmin) {
      if (key != nullptr) {
        key[o] = pack_key(d, ts[s]);
        return;
      }
      idx[o] = s;
    }
    out[o] = d;
  };

  // The cull. With flags, each thread reads its unit's byte. Without, the
  // block flags each cull unit (8 rows x chunk) that meets it from the mask:
  // a block inside one unit, as at the tiers' chunks of 32 and 64 and the
  // row cull, decides with one barrier; one that spans several (chunks under
  // the block's width) keeps a flag per unit. any_live is the block's: with
  // none, it writes the sentinel and skips the rest.
  bool live = inb, any_live = true;
  if (p.cull) {
    const int chunk = p.col_chunk, shift = p.chunk_shift;
    if (flags != nullptr) {
      live = inb && flags[((size_t)b * p.row_groups + blockIdx.y) * div_by(w, chunk, shift) +
                          div_by(col, chunk, shift)] != 0;
      any_live = __syncthreads_or(live);
    } else {
      const int u_first = div_by(col0, chunk, shift);
      const int n_units = div_by(min(col0 + kCols, w) - 1, chunk, shift) + 1 - u_first;
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
  }

  if (!any_live) {
    if (writer) emit(sentinel, 0);
    return;
  }
  for (int i = tid; i < p.n_ts; i += kThreads) {
    s_ts[i] = kForm == kRefine || kClamp ? ts[i] : clampf(ts[i], 0.0f, 1.0f);
  }
  __syncthreads();
  if (!live) {
    if (writer) emit(sentinel, 0);
    return;
  }

  Pixel q;
  Endpoint e;
  const float denom = init_pixel(q, e, img, row, col, h, w, lx, ly, lz);

  // K3 starts from the sentinel, as the plain refine does; K1 and K2 from inf
  // (an all-vetoed pixel then still records sample 0 as its winner).
  float best = kForm == kRefine ? kOffFaceN2 : INFINITY;
  const int begin = lane;  // this lane's first sample; it takes every kLanes-th
  int best_s = begin;
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
  const float t_lo = kClamp ? p.t_lo : fmaxf(p.t_lo, 0.0f), t_hi = kClamp ? p.t_hi : fminf(p.t_hi, 1.0f);
  const float wm1 = (float)(w - 1), hm1 = (float)(h - 1);
  if (kVeto == kOnehot && p.veto == kBilinear) {
    march_samples<kForm, kBilinear, kClamp, kLanes>(img, wp, wm1, hm1, q, s_ts, begin, p.n_ts, t_centre, t_lo, t_hi,
                                                    best, best_s);
  } else {
    march_samples<kForm, kVeto, kClamp, kLanes>(img, wp, wm1, hm1, q, s_ts, begin, p.n_ts, t_centre, t_lo, t_hi,
                                                best, best_s);
  }
  if constexpr (kLanes > 1) {
    // The lanes' first winners: the smaller norm^2, on a tie the smaller
    // index, which is the whole table's first winner (each lane's is the
    // first of its samples by strict <). Exact, so K2 stays bit-equal.
    const unsigned group = ((1u << kLanes) - 1u) << (threadIdx.x & ~(kLanes - 1));
#pragma unroll
    for (int off = kLanes / 2; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(group, best, off);
      const int oi = __shfl_xor_sync(group, best_s, off);
      if (ov < best || (ov == best && oi < best_s)) {
        best = ov;
        best_s = oi;
      }
    }
  }
  if (!writer) return;

  float min_d = sqrtf(best + kEps) / denom;
  if constexpr (kForm == kRefine) min_d = fminf(min_d, kOffFace);
  if (best >= kOffFaceN2) min_d = kOffFace;
  emit(p.gate_on ? min_d + bias : min_d, best_s);
}

// The sample-sharded march's unpack: the MIN-reduced pack_key words back to
// (B, H, W) float32 distances (bit-equal to K2's `out` on the full grid) and
// winning offsets t*. With the MIN over the ranks (a collective, outside any
// kernel) it replaces the JAX package's pmin combine of distances and t
// (shadows_pallas.py:851-855), which is no Pallas kernel. One thread a
// pixel; 16 bytes a pixel and no arithmetic, so bytes bound it: at
// training's (3, 256^2) 3.1 MB, ~1 us at 3.35 TB/s, about a launch's own
// time (PERF.md).
__global__ void __launch_bounds__(kThreads)
unpack_key_kernel(const long long* __restrict__ key, float* __restrict__ out, float* __restrict__ t_star,
                  long long n) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const unsigned long long k = (unsigned long long)key[i];
  int hi = (int)(unsigned)(k >> 32);
  hi = hi < 0 ? hi ^ 0x7fffffff : hi;
  int lo = (int)((unsigned)k ^ 0x80000000u);
  lo = lo < 0 ? lo ^ 0x7fffffff : lo;
  out[i] = __int_as_float(hi);
  t_star[i] = __int_as_float(lo);
}

// The kernels' input staging, once per march (the draft tier's one pass for
// K2 and K3 both). One block per image and band of 8 rows of the march's
// grid, the grid at 1/s of (H, W) (s = 1 outside the draft tier), so a band
// holds whole cull units at both resolutions. It reads depth and mask once
// and writes:
//  * quad: the march's input, (B, H/s + 1, W/s + 1, 2) float2, padded
//    (y, x) holding (depth, mask) at (max(y - 1, 0), max(x - 1, 0)): the pad
//    is the reference's clamp of a floor of -1 (xt or yt in [-1e-4, 0)) to
//    0, so the quad needs no clamp. At s > 1 it holds the pooled inputs of
//    ops/shadows.scale_march_inputs: depth the mean of the block's on-face
//    pixels (the plain mean where none is), divided by s; mask 1 where at
//    least half the block is on face. Each block's sums run row by row, left
//    to right, from the first pixel, as the plain version adds them; so the
//    pooled quad is bit-equal to it. The mask is written 0/1 (nonzero is
//    face) at every s;
//  * full (s > 1, may be null): the same padding of the full-resolution
//    inputs, K3's input;
//  * flags, full_flags (may be null): one byte per cull unit, 8 rows x
//    chunk of the march's grid, 8 rows x full_chunk at full resolution: the
//    unit holds face. K2 and K3 read one byte in place of the unit's mask;
//  * light_out (s > 1, may be null): the light point scaled for the pooled
//    grid, (lx / s - off, ly / s + off, lz / s), off = (s - 1) / (2s).
// A block is 32 x 8 threads: threadIdx.y is the band's row, threadIdx.x
// strides its columns, so no thread divides an index; the last band may
// hold fewer than 8 rows of the march's grid (and so of whole cull units); each block row of s
// pixels arrives in one vector load (float4 at the draft tier's s = 4). The
// full-resolution quad is a second pass over the band with consecutive
// threads on consecutive pixels, so its stores coalesce (written from the
// pooling loop, each store instruction of a warp touched 32 sectors).
// It replaces no Pallas kernel: the JAX package pools with XLA ops
// (ops/shadows.py scale_march_inputs) and its kernel pads in VMEM. What
// bounds it is bytes: at the draft shape (64 x 256^2) it reads 34 MB and
// writes 36 MB, 0.021 ms at 3.35 TB/s; it takes about 0.05 ms, one wave of
// 512 blocks (PERF.md).
struct StageParams {
  int height, width, scale, chunk, full_chunk;
  int chunk_shift, full_shift;  // log2 of the chunks, -1 if not a power of two
  int low_groups, full_groups;  // ceil(H / s / 8), ceil(H / 8): the cull units' rows at each resolution
};

// s floats from a 4s-byte-aligned address: one vector load.
template <int S>
struct Row {
  float v[S];
  __device__ __forceinline__ explicit Row(const float* __restrict__ p) {
    if constexpr (S == 4) {
      const float4 q = __ldg(reinterpret_cast<const float4*>(p));
      v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
    } else if constexpr (S == 2) {
      const float2 q = __ldg(reinterpret_cast<const float2*>(p));
      v[0] = q.x, v[1] = q.y;
    } else {
      v[0] = __ldg(p);
    }
  }
};

// The band's pixels of the march's grid at scale S; s_flag as stage_kernel's.
template <int S>
__device__ __forceinline__ void stage_band(const float* __restrict__ dimg, const float* __restrict__ mimg,
                                           float2* __restrict__ qimg, int* s_flag, int n_low,
                                           const StageParams& p) {
  const int w = p.width, ws = w / S;
  const int band = blockIdx.x, r = band * kBlockRows + threadIdx.y;
  constexpr float ss = (float)(S * S);
  if (r >= p.height / S) return;  // the last band's rows past the grid's
  for (int c = threadIdx.x; c < ws; c += kBlockCols) {
    float cnt = 0.0f, fsum = 0.0f, tot = 0.0f;
#pragma unroll
    for (int i = 0; i < S; ++i) {
      const int y = r * S + i;
      const Row<S> d(dimg + (size_t)y * w + c * S), m(mimg + (size_t)y * w + c * S);
#pragma unroll
      for (int j = 0; j < S; ++j) {
        const float on = m.v[j] != 0.0f ? 1.0f : 0.0f;
        const float fd = d.v[j] * on;
        if (i == 0 && j == 0) {
          cnt = on;
          fsum = fd;
          tot = d.v[j];
        } else {
          cnt = cnt + on;
          fsum = fsum + fd;
          tot = tot + d.v[j];
        }
      }
    }
    const float face_mean = fsum / fmaxf(cnt, 1.0f);
    const float2 v = make_float2((cnt > 0.0f ? face_mean : tot / ss) / (float)S, cnt >= 0.5f * ss ? 1.0f : 0.0f);
    qimg[(size_t)(r + 1) * (ws + 1) + c + 1] = v;
    if (r == 0) qimg[c + 1] = v;
    if (c == 0) qimg[(size_t)(r + 1) * (ws + 1)] = v;
    if (r == 0 && c == 0) qimg[0] = v;
    if (n_low != 0 && v.y != 0.0f) s_flag[div_by(c, p.chunk, p.chunk_shift)] = 1;
  }
}

// The band's 8s full-resolution rows: the padded quad (fimg, may be null)
// and the full-resolution cull flags (s_full, when full_per_row != 0).
__device__ __forceinline__ void stage_full(const float* __restrict__ dimg, const float* __restrict__ mimg,
                                           float2* __restrict__ fimg, int* s_full, int full_per_row,
                                           const StageParams& p) {
  const int w = p.width, rows = kBlockRows * p.scale, y0 = blockIdx.x * rows;
  for (int ry = threadIdx.y; ry < rows && y0 + ry < p.height; ry += kBlockRows) {
    const int y = y0 + ry;
    for (int x = threadIdx.x; x < w; x += kBlockCols) {
      const float d = __ldg(dimg + (size_t)y * w + x);
      const float on = __ldg(mimg + (size_t)y * w + x) != 0.0f ? 1.0f : 0.0f;
      if (fimg != nullptr) {
        const float2 v = make_float2(d, on);
        fimg[(size_t)(y + 1) * (w + 1) + x + 1] = v;
        if (y == 0) fimg[x + 1] = v;
        if (x == 0) fimg[(size_t)(y + 1) * (w + 1)] = v;
        if (y == 0 && x == 0) fimg[0] = v;
      }
      if (full_per_row != 0 && on != 0.0f) {  // the unit's row group within the band
        s_full[(ry >> 3) * full_per_row + div_by(x, p.full_chunk, p.full_shift)] = 1;
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
stage_kernel(const float* __restrict__ depth, const float* __restrict__ mask,
             const float* __restrict__ light, float2* __restrict__ quad, float2* __restrict__ full,
             uint8_t* __restrict__ flags, uint8_t* __restrict__ full_flags,
             float* __restrict__ light_out, StageParams p) {
  extern __shared__ int s_flag[];  // the band's units: the march grid's, then full resolution's
  const int s = p.scale, h = p.height, w = p.width, hs = h / s, ws = w / s;
  const int band = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.y * kBlockCols + threadIdx.x;
  const int n_low = flags != nullptr ? ws / p.chunk : 0;
  const int full_per_row = full_flags != nullptr ? w / p.full_chunk : 0;
  const int n_full = s * full_per_row;
  for (int i = tid; i < n_low + n_full; i += kThreads) s_flag[i] = 0;
  if (light_out != nullptr && band == 0 && tid < 3) {
    const float off = (s - 1.0f) / (2.0f * s);  // exact at the config's scales 2 and 4
    const float v = light[3 * b + tid] / (float)s;
    light_out[3 * b + tid] = tid == 0 ? v - off : (tid == 1 ? v + off : v);
  }
  __syncthreads();

  const float* __restrict__ dimg = depth + (size_t)b * h * w;
  const float* __restrict__ mimg = mask + (size_t)b * h * w;
  float2* __restrict__ qimg = quad + (size_t)b * (hs + 1) * (ws + 1);
  float2* __restrict__ fimg = full != nullptr ? full + (size_t)b * (h + 1) * (w + 1) : nullptr;
  switch (s) {  // the config's scales
    case 1:
      stage_band<1>(dimg, mimg, qimg, s_flag, n_low, p);
      break;
    case 2:
      stage_band<2>(dimg, mimg, qimg, s_flag, n_low, p);
      break;
    case 4:
      stage_band<4>(dimg, mimg, qimg, s_flag, n_low, p);
      break;
  }
  if (fimg != nullptr || full_per_row != 0) stage_full(dimg, mimg, fimg, s_flag + n_low, full_per_row, p);
  __syncthreads();
  for (int i = tid; i < n_low; i += kThreads) {
    flags[((size_t)b * p.low_groups + band) * n_low + i] = (uint8_t)s_flag[i];
  }
  for (int i = tid; i < n_full; i += kThreads) {
    const int g = i / full_per_row, u = i - g * full_per_row;
    if (band * s + g < p.full_groups) {  // the last band's row groups past the image's
      full_flags[((size_t)b * p.full_groups + band * s + g) * full_per_row + u] = (uint8_t)s_flag[n_low + i];
    }
  }
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
// branch that border_endpoint's selection takes and is zero where the clamp
// binds (torch.clamp passes the gradient at the bounds themselves, as the
// plain version does). Semantics are those of
// geomconsistentfr_torch/ops/shadows.py `march_vjp`, torch.autograd.grad of
// the plain sample evaluator.
//
// It reads the forward's own input: the padded, interleaved quad K2's
// staging wrote (RayMarchMinDistance keeps it), and its cull flags. The
// sample's endpoint, coordinates, tap quad and veto come from the march's
// own code (init_pixel, sample_taps). Its veto is the one-hot veto whatever
// veto the forward marched under, as the JAX package's backward evaluates the
// winner (shadows_pallas.py:786-799: `sample_distance_at_matmul`, whose veto
// is the banker's-rounded one-hot, shadows.py:257-259). Where the forward's
// table, and so t*, leaves [0, 1] or H or W exceeds 2048, it takes the
// clamped taps (kClamp, the header's range). One difference is the reference's: where xt
// (yt) is an integer, its ceil tap is its floor tap. The forward's weights
// of the quad's second column (row) are then exactly 0, so it adds +-0, but
// the position term below differentiates the weights, and there the
// reference's (d_ur - d_ul) is 0; so the backward takes the floor tap as the
// ceil tap on such an axis. The taps' (H, W) addresses for the atomics come
// from the rounding adds' bits, on the integer pipe.
//
// A vetoed sample (a constant 1e6), a culled pixel (a constant sentinel) and
// a zero cotangent give no gradient: those threads skip the work. Each other
// thread atomicAdds its five depth contributions into d_depth (taps of
// neighbouring pixels overlap), and the block reduces its light gradient
// with warp shuffles, then across its eight warps in shared memory, into
// three atomics per block: a block is one image's 8 x 32 tile. Atomics make
// the float32 sums' order, and so their last bits, vary from run to run.
//
// What bounds it on an H100: per pixel about 60 float32 operations for the
// sample (as K1's) and about 110 for the endpoint Jacobian and the chain rule,
// against reading the quad's taps, idx and the cotangent and writing d_depth:
// ~20 bytes a pixel. At the training shape (batch 3, 256^2) that is ~35
// MFLOP (~0.5 us at 67 TFLOP/s) against ~4 MB (~1.2 us at 3.35 TB/s), both
// below a launch's own few microseconds: at batch 3 its 1.45 waves of one
// thread's dependent chain (index, table, taps, ~200 float32 operations
// with 5 divisions and 2 square roots, the atomics, the block's reduction)
// set its time.

// A block is one image's 8 x 32 tile: each row is one warp (the light
// gradient's reduction below relies on it). At 64 registers the card holds
// 528 blocks, so training's 768 (batch 3, 256^2) run in 1.45 waves; capped at
// 40 registers for one wave, it spilled and measured slower (PERF.md §6).
constexpr int kGradRows = 8, kGradCols = 32;

struct GradParams {
  int batch, height, width;
  int row_groups;               // ceil(H / 8): the cull units' rows
  int col_chunk, chunk_shift;   // the cull unit's width (flags given) and its log2, or -1
};

// One pixel's gradient: adds its depth contributions to dgrad and returns its
// light gradient in (gl_x, gl_y, gl_z). Returns early where there is none.
template <bool kClamp>
__device__ __forceinline__ void pixel_grad(
    const float2* __restrict__ img, float* __restrict__ dgrad, float lx, float ly, float lz, float t,
    float g, int row, int col, int h, int w, float& gl_x, float& gl_y, float& gl_z) {
  Pixel q;
  Endpoint e;
  const float denom = init_pixel(q, e, img, row, col, h, w, lx, ly, lz);
  const Taps s = sample_taps<kOnehot, kClamp>(img, w + 1, (float)(w - 1), (float)(h - 1), q, t);
  if (!s.face) return;

  // The reference's taps: on an integer axis the ceil tap is the floor tap.
  const bool xint = s.x1 == s.x0, yint = s.y1 == s.y0;
  const float d_ul = s.q00.x, d_ur = xint ? s.q00.x : s.q01.x;
  const float d_ll = yint ? s.q00.x : s.q10.x;
  const float d_lr = xint ? d_ll : (yint ? s.q01.x : s.q11.x);
  const float wx0 = s.x1 - s.xt, wx1 = s.xt - s.x0;
  const float wy0 = s.y1 - s.yt, wy1 = s.yt - s.y0;
  const float iu = d_ul * wx0 + d_ur * wx1;
  const float il = d_ll * wx0 + d_lr * wx1;
  const float d_interp = iu * wy0 + il * wy1;
  // Their (H, W) addresses: in the quad form the floor clamped to 0 (it is
  // >= -1) and the ceil in range; the clamped form's own.
  int ix0 = s.ix0, ix1 = s.ix1, iy0 = s.iy0, iy1 = s.iy1;
  if constexpr (!kClamp) {
    ix0 = max((int)(s.bxi - (unsigned)kRoundBits), 0);
    ix1 = (int)(s.cxi - (unsigned)kRoundBits);
    iy0 = max((int)(s.byi - (unsigned)kRoundBits), 0);
    iy1 = (int)(s.cyi - (unsigned)kRoundBits);
  }

  const float ba_x = (s.xt - q.half_w) - q.xx;
  const float ba_y = (q.half_h - s.yt) - q.yy;
  const float ba_z = d_interp - q.d0;
  const float bc_x = q.bc_x, bc_y = q.bc_y, bc_z = q.bc_z;
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
  atomicAdd(dgrad + iy0 * w + ix0, g_u * wx0);
  atomicAdd(dgrad + iy0 * w + ix1, g_u * wx1);
  atomicAdd(dgrad + iy1 * w + ix0, g_l * wx0);
  atomicAdd(dgrad + iy1 * w + ix1, g_l * wx1);
  atomicAdd(dgrad + row * w + col, -g_baz - g_bcz);

  // The sample position: BA_x, BA_y and the bilinear weights move with it.
  const float g_xt = g_bax + g_baz * ((d_ur - d_ul) * wy0 + (d_lr - d_ll) * wy1);
  const float g_yt = -g_bay + g_baz * (il - iu);
  const float g_ex = t * g_xt;     // sx = xx + t * (ex - xx); xt = sx + ...
  const float g_ey = -(t * g_yt);  // yt = half_h - sy - ...

  // d(ex, ey)/d(lx, ly) along the branch taken; zero where the clamp binds.
  // With den = lx - xx + eps and se = slope + eps, the exact derivatives of
  // the endpoint's arithmetic are
  //   d ex_h / d ly = -(ex_h - xx + eps) / (den se),  d ey_v / d ly = (xv - xx + eps) / den,
  // and d/d lx = -slope d/d ly for each; ex_h - xx + eps is
  // ((yh - yy) - eps (xx - eps)) / se. No term cancels. The chain rule's own
  // form, -(d icpt + ex_h d slope) / se, subtracts two terms of order
  // |slope lx| where the light stands over the pixel's column (|lx - xx| <
  // 1, |slope| large), and there loses most of a light term's digits
  // (PERF.md §6).
  const float left = -q.half_w, right = (float)w - q.half_w - 1.0f;
  const float bottom = 1.0f - q.half_h, top = q.half_h;
  float jxx = 0.0f, jxy = 0.0f, jyx = 0.0f, jyy = 0.0f;
  if (e.inside) {
    jxx = 1.0f;
    jyy = 1.0f;
  } else {
    if (!e.zy_mid && (e.zx_mid || e.inter)) {  // ex = ex_h
      const float yh = ly < bottom ? bottom : top;
      jxy = -(((yh - q.yy) - kEps * (q.xx - kEps)) / e.se) / (e.den * e.se);
      jxx = -e.slope * jxy;
    }
    if (e.zy_mid || (!e.zx_mid && !e.inter)) {  // ey = ey_v
      jyy = ((e.xv - q.xx) + kEps) / e.den;
      jyx = -e.slope * jyy;
    }
  }
  if (!(e.ex_raw >= left && e.ex_raw <= right)) jxx = jxy = 0.0f;
  if (!(e.ey_raw >= bottom && e.ey_raw <= top)) jyx = jyy = 0.0f;

  gl_x = g_bcx + (g_ex * jxx + g_ey * jyx);
  gl_y = g_bcy + (g_ex * jxy + g_ey * jyy);
  gl_z = g_bcz;
}

// dm: the forward's staged quad; flags: its cull flags, or null without the
// cull; idx: K2's winning sample per pixel and ts the table it indexes, or,
// where t_map is given, each pixel's winning t itself (K5's backward, from
// unpack_key_kernel: the same float as ts[idx]); g: the cotangent of the
// march's output. d_depth and d_light arrive zeroed.
template <bool kClamp>
__global__ void __launch_bounds__(kGradRows * kGradCols)
march_grad_kernel(const float2* __restrict__ dm, const uint8_t* __restrict__ flags,
                  const float* __restrict__ light, const float* __restrict__ ts,
                  const int32_t* __restrict__ idx, const float* __restrict__ t_map, const float* __restrict__ g,
                  float* __restrict__ d_depth, float* __restrict__ d_light, GradParams p) {
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
    if (on && flags != nullptr) {
      const int chunk = p.col_chunk, shift = p.chunk_shift;
      on = flags[((size_t)b * p.row_groups + row / kGradRows) * div_by(w, chunk, shift) +
                 div_by(col, chunk, shift)] != 0;
    }
    if (on) {
      const float2* __restrict__ img = dm + (size_t)b * (h + 1) * (w + 1);
      const float t = t_map != nullptr ? t_map[o] : ts[idx[o]];
      float* __restrict__ dgrad = d_depth + (size_t)b * plane;
      const float lx = light[3 * b + 0], ly = light[3 * b + 1], lz = light[3 * b + 2];
      pixel_grad<kClamp>(img, dgrad, lx, ly, lz, t, gv, row, col, h, w, gl_x, gl_y, gl_z);
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

// Plain C entry points (bound with ctypes). Each launches on `stream` and
// returns cudaGetLastError() so that the caller can raise on a refused launch.

static int ceil_div(int a, int b) { return (a + b - 1) / b; }

// The staging (stage_kernel): `quad` (B, H/s + 1, W/s + 1, 2) float32, and
// where not null `full` (B, H + 1, W + 1, 2), `flags` (B, ceil(H/s/8),
// W/s/chunk), `full_flags` (B, ceil(H/8), W/full_chunk) uint8 and
// `light_out` (B, 3). s is 1, 2 or 4 and divides H and W.
extern "C" int gcfr_stage_launch(
    const float* depth, const float* mask, const float* light, float* quad, float* full,
    uint8_t* flags, uint8_t* full_flags, float* light_out, int batch, int height, int width,
    int scale, int chunk, int full_chunk, void* stream) {
  if (scale != 1 && scale != 2 && scale != 4) return (int)cudaErrorInvalidValue;
  const int bands = ceil_div(height / scale, kBlockRows);
  StageParams p{height, width, scale, chunk, full_chunk, log2_or_minus1(chunk), log2_or_minus1(full_chunk),
                bands, ceil_div(height, kBlockRows)};
  const int n_units = (flags != nullptr ? width / scale / chunk : 0) +
                      (full_flags != nullptr ? scale * (width / full_chunk) : 0);
  stage_kernel<<<dim3(bands, batch), dim3(kBlockCols, kBlockRows), (size_t)n_units * sizeof(int),
                 (cudaStream_t)stream>>>(depth, mask, light, reinterpret_cast<float2*>(quad),
                                         reinterpret_cast<float2*>(full), flags, full_flags, light_out, p);
  return (int)cudaGetLastError();
}

// One march launch's arguments, for the dispatch over the instantiations.
struct MarchLaunch {
  dim3 grid, block;
  size_t smem;
  cudaStream_t stream;
  const float2* dm;
  const float* mask;
  const uint8_t* flags;
  const float *light, *ts, *t_map;
  const int32_t* centre_idx;
  const float* centre_ts;
  float* out;
  int32_t* idx;
  long long* key;
  MarchParams p;
};

template <int kForm, int kLanes, int kVeto>
static void launch_march(const MarchLaunch& a, bool clamp) {
  if (clamp) {
    march_kernel<kForm, kLanes, kVeto, true><<<a.grid, a.block, a.smem, a.stream>>>(
        a.dm, a.mask, a.flags, a.light, a.ts, a.t_map, a.centre_idx, a.centre_ts, a.out, a.idx, a.key, a.p);
  } else {
    march_kernel<kForm, kLanes, kVeto, false><<<a.grid, a.block, a.smem, a.stream>>>(
        a.dm, a.mask, a.flags, a.light, a.ts, a.t_map, a.centre_idx, a.centre_ts, a.out, a.idx, a.key, a.p);
  }
}

template <int kForm, int kLanes>
static int launch_veto(const MarchLaunch& a, int veto, bool clamp) {
  switch (veto) {
    case kOnehot:
    case kBilinear:
      launch_march<kForm, kLanes, kOnehot>(a, clamp);
      return 0;
    case kHat:
      launch_march<kForm, kLanes, kHat>(a, clamp);
      return 0;
    case kHatY:
      launch_march<kForm, kLanes, kHatY>(a, clamp);
      return 0;
  }
  return (int)cudaErrorInvalidValue;
}

// The march: `form` is K1 (0), K2 (1) or K3 (2); `veto` enum Veto; `clamp`
// the clamped taps (the header's range); `staged` the quad stage_kernel
// wrote; `flags` its cull flags, or null for the in-kernel scan of `mask`;
// `key` (K2 only, may be null) its key form, in place of out and idx.
extern "C" int gcfr_march_launch(
    int form, const float* staged, const float* mask, const uint8_t* flags,
    const float* light, const float* ts,
    const float* t_map, const int32_t* centre_idx, const float* centre_ts,
    float* out, int32_t* idx, long long* key, int batch, int height, int width, int n_ts,
    int veto, int clamp, int cull, int col_chunk, int gate_on, int centre_scale,
    int centre_n, float lo_x, float hi_x, float lo_y, float hi_y,
    float gate_bias, float t_lo, float t_hi, void* stream) {
  MarchParams p{batch, height, width, n_ts, veto, cull, col_chunk, gate_on,
                centre_scale, centre_n, log2_or_minus1(col_chunk),
                log2_or_minus1(centre_scale), lo_x, hi_x, lo_y, hi_y, gate_bias,
                t_lo, t_hi, ceil_div(height, kBlockRows)};
  if (key != nullptr && (form != kArgmin || n_ts < 1)) return (int)cudaErrorInvalidValue;
  const bool split = form == kArgmin && n_ts >= kSplitFrom;
  const MarchLaunch a{dim3(ceil_div(width * (split ? kSplitLanes : 1), kBlockCols), ceil_div(height, kBlockRows), batch),
                      dim3(kBlockCols, kBlockRows), (size_t)n_ts * sizeof(float), (cudaStream_t)stream,
                      reinterpret_cast<const float2*>(staged), mask, flags, light, ts, t_map, centre_idx, centre_ts,
                      out, idx, key, p};
  int err;
  switch (form) {
    case kMin:
      err = launch_veto<kMin, 1>(a, veto, clamp != 0);
      break;
    case kArgmin:
      err = split ? launch_veto<kArgmin, kSplitLanes>(a, veto, clamp != 0) : launch_veto<kArgmin, 1>(a, veto, clamp != 0);
      break;
    case kRefine:
      err = launch_veto<kRefine, 1>(a, veto, clamp != 0);
      break;
    default:
      err = (int)cudaErrorInvalidValue;
  }
  return err != 0 ? err : (int)cudaGetLastError();
}

// The unpack (unpack_key_kernel) of n reduced keys into out and t_star.
extern "C" int gcfr_unpack_key_launch(const long long* key, float* out, float* t_star, long long n, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  unpack_key_kernel<<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0, (cudaStream_t)stream>>>(key, out,
                                                                                                    t_star, n);
  return (int)cudaGetLastError();
}

// K4's backward (march_grad) on the forward's staged quad and flags (null
// without the cull), at ts[idx], or at t_map where it is not null (then idx
// and ts may be null); `clamp` the clamped taps (the header's range);
// d_depth (B, H, W) and d_light (B, 3) must be zeroed by the caller.
extern "C" int gcfr_march_grad_launch(
    const float* staged, const uint8_t* flags, const float* light, const float* ts,
    const int32_t* idx, const float* t_map, const float* g, float* d_depth, float* d_light, int batch, int height,
    int width, int clamp, int col_chunk, void* stream) {
  GradParams p{batch, height, width, ceil_div(height, kGradRows), col_chunk, log2_or_minus1(col_chunk)};
  dim3 block(kGradCols, kGradRows);
  dim3 grid(ceil_div(width, kGradCols), ceil_div(height, kGradRows), batch);
  const float2* dm = reinterpret_cast<const float2*>(staged);
  if (clamp) {
    march_grad_kernel<true><<<grid, block, 0, (cudaStream_t)stream>>>(dm, flags, light, ts, idx, t_map, g, d_depth,
                                                                      d_light, p);
  } else {
    march_grad_kernel<false><<<grid, block, 0, (cudaStream_t)stream>>>(dm, flags, light, ts, idx, t_map, g, d_depth,
                                                                       d_light, p);
  }
  return (int)cudaGetLastError();
}

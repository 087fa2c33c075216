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
//                around a per-pixel centre, t = clip(t_map + off, t_lo, t_hi),
//                from the 1e6 sentinel. Replaces `_march_kernel` with
//                refine_t_range, reached through `refine_min_distance_pallas`.
//
// Semantics are those of the plain versions in
// geomconsistentfr_torch/ops/shadows.py, which are written op for op in the
// order this kernel evaluates. The form is a template argument, so each
// instantiation compiles only its own carry and K1's loop holds nothing of
// K2's or K3's.
//
// What bounds it on an H100. Per live pixel-sample the loop does about 60
// float32 operations outside the tensor cores (coordinates, floor/ceil, four
// depth taps, bilinear weights, the cross product and its norm; the bilinear
// veto adds about 30; K2's argmin adds a compare and a select, K3's centre
// an add and a clamp) against 4 to 8 cached loads. The inputs are tiny next
// to that work: at batch 64 x 256^2 x 160 samples with every pixel live the
// arithmetic is ~40 GFLOP (~0.6 ms at 67 TFLOP/s; the cull drops the pixels
// of face-free blocks) while depth, mask and output are 50 MB (~15 us at
// 3.35 TB/s). So K1 is bound by f32 operations. K2 at the draft tier's 64^2 x
// 80 samples and K3 at 256^2 x 8 offsets do 1-2 GFLOP each; K3 also reads
// t_map, and moves ~67 MB, so it sits near both bounds and near a launch's
// own cost. The TPU kernel turned the gathers into one-hot matmuls because a
// TPU has no vector gather; a GPU has one, so here each tap is a plain load
// through the read-only path (__ldg), and a 256^2 f32 depth map (256 KiB)
// stays in L1/L2 -- a batch of 64 is 16 MiB and fits the 50 MB L2. No wgmma
// or TMA yet: there is no matrix product left once the gathers are loads,
// and the tiles a block reads are data-dependent (each ray crosses the whole
// image), so a TMA copy of a fixed tile has nothing to feed. Shared-memory
// staging of the depth map does not fit (256 KiB > 227 KB per block).
//
// Design. One thread per pixel; a block is 8 rows x 32 columns, which is one
// cull block at the tiers' shadow_col_chunk of 32 (a 64-column cull block,
// the draft tier's, spans two). Per-pixel constants (endpoint, BC,
// denominator) are computed once in registers; the t table (K1, K2) or the
// window offsets (K3) are staged in shared memory, and K3 reads its pixel's
// t_map centre once. Blocks whose cull unit holds no face (a flag the
// wrapper computes once per call) write the all-vetoed sentinel and skip the
// loop. The loop carries the min of the raw cross-product norm^2 (1e30 for
// a vetoed sample); sqrt(n2 + 1e-4) / denom is monotone in n2, so the result
// equals the min of per-sample distances exactly, and is taken once at the
// end. K2 carries the sample index beside it; the wrapper maps the index to
// t through the same float32 table (shadows_pallas.py:1152-1154).
//
// Rounding choices:
//  * The veto's rounding is banker's (round half to even), as in the
//    reference and torch.round: rintf, never roundf (half away from zero).
//    The march hits exact halves systematically (integer pixel-to-border
//    spans stepped by t_step 0.005).
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
//  * K3's centre: t_map + off rounds first, then the clamp, as
//    jnp.clip(t_map + off, t_lo, t_hi) does (JAX shadows.py:702).
//  * The depth lookup uses the reference's floor/ceil taps with clamped
//    indices; the distance keeps the *unclipped* shifted coordinates.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlockRows = 8;
constexpr int kBlockCols = 32;
constexpr float kEps = 1e-4f;
constexpr float kOffFace = 1.0e6f;
constexpr float kOffFaceN2 = 1.0e30f;

enum Form : int { kMin = 0, kArgmin = 1, kRefine = 2 };

struct MarchParams {
  int batch, height, width, n_ts;
  int bilinear;                 // 0: one-hot veto, 1: bilinear veto
  int live_cols;                // cull blocks per 8-row group; 0 = no cull
  int col_chunk;                // cull block width in pixels
  int gate_on;
  float lo_x, hi_x, lo_y, hi_y, gate_bias;
  float t_lo, t_hi;             // K3: the full t grid's first and last offsets
};

__device__ __forceinline__ float clampf(float v, float lo, float hi) {
  return fminf(fmaxf(v, lo), hi);
}

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

// ts: the t table (K1, K2) or the window offsets (K3); t_map: K3's per-pixel
// centres; idx: K2's winning sample indices. Unused pointers may be null.
template <int kForm>
__global__ void __launch_bounds__(kBlockRows * kBlockCols)
march_kernel(const float* __restrict__ depth, const float* __restrict__ mask,
             const float* __restrict__ light, const float* __restrict__ ts,
             const float* __restrict__ t_map, const uint8_t* __restrict__ live,
             float* __restrict__ out, int32_t* __restrict__ idx,
             MarchParams p) {
  extern __shared__ float s_ts[];
  const int tid = threadIdx.y * kBlockCols + threadIdx.x;
  for (int i = tid; i < p.n_ts; i += kBlockRows * kBlockCols) s_ts[i] = ts[i];
  __syncthreads();

  const int h = p.height, w = p.width;
  const int b = blockIdx.z;
  const int row = blockIdx.y * kBlockRows + threadIdx.y;
  const int col = blockIdx.x * kBlockCols + threadIdx.x;
  if (row >= h || col >= w) return;

  const float lx = light[3 * b + 0];
  const float ly = light[3 * b + 1];
  const float lz = light[3 * b + 2];
  const bool gate = p.gate_on && lx >= p.lo_x && lx <= p.hi_x &&
                    ly >= p.lo_y && ly <= p.hi_y;
  const float bias = gate ? p.gate_bias : 0.0f;
  const size_t plane = (size_t)h * w;
  const size_t o = (size_t)b * plane + (size_t)row * w + col;

  if (p.live_cols > 0) {
    const int g = row / 8, c = col / p.col_chunk;
    if (!live[((size_t)b * (h / 8) + g) * p.live_cols + c]) {
      out[o] = p.gate_on ? kOffFace + bias : kOffFace;
      if constexpr (kForm == kArgmin) idx[o] = 0;
      return;
    }
  }

  const float* __restrict__ dimg = depth + (size_t)b * plane;
  const float* __restrict__ mimg = mask + (size_t)b * plane;
  const float half_w = 0.5f * (float)w, half_h = 0.5f * (float)h;
  const float left = -half_w, right = (float)w - half_w - 1.0f;
  const float bottom = 1.0f - half_h, top = half_h;

  const float xx = (float)col - half_w;
  const float yy = half_h - (float)row;

  // Border endpoint: branchless 9-case analysis of the reference (:363-442).
  const float slope = (ly - yy) / ((lx - xx) + kEps);
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

  const float diff_x = ex - xx, diff_y = ey - yy;
  const float d0 = dimg[row * w + col];
  const float bc_x = lx - xx, bc_y = ly - yy, bc_z = lz - d0;
  const float denom = sqrtf(bc_x * bc_x + bc_y * bc_y + bc_z * bc_z + kEps);

  // K3 starts from the sentinel, as the plain refine does; K1 and K2 from inf
  // (an all-vetoed pixel then still records sample 0 as its winner).
  float best = kForm == kRefine ? kOffFaceN2 : INFINITY;
  int best_s = 0;
  float t_centre = 0.0f;
  if constexpr (kForm == kRefine) t_centre = t_map[o];
  for (int s = 0; s < p.n_ts; ++s) {
    float t = s_ts[s];
    if constexpr (kForm == kRefine) t = clampf(t_centre + t, p.t_lo, p.t_hi);
    const float sx = __fmaf_rn(t, diff_x, xx);
    const float sy = __fmaf_rn(t, diff_y, yy);
    const float xt = (sx + half_w) - kEps;
    const float yt = (half_h - sy) - kEps;

    bool face;
    if (!p.bilinear) {
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

    const float x0 = floorf(xt), x1 = ceilf(xt);
    const float y0 = floorf(yt), y1 = ceilf(yt);
    const float wx0 = x1 - xt, wx1 = xt - x0;
    const float iu = tap(dimg, y0, x0, h, w) * wx0 + tap(dimg, y0, x1, h, w) * wx1;
    const float il = tap(dimg, y1, x0, h, w) * wx0 + tap(dimg, y1, x1, h, w) * wx1;
    const float d_interp = iu * (y1 - yt) + il * (yt - y0);

    const float ba_x = (xt - half_w) - xx;
    const float ba_y = (half_h - yt) - yy;
    const float ba_z = d_interp - d0;
    const float cx = ba_y * bc_z - ba_z * bc_y;
    const float cy = ba_z * bc_x - ba_x * bc_z;
    const float cz = ba_x * bc_y - ba_y * bc_x;
    const float n2 = cx * cx + cy * cy + cz * cz;
    if constexpr (kForm == kArgmin) {
      const float v = face ? n2 : kOffFaceN2;
      if (v < best) {
        best = v;
        best_s = s;
      }
    } else {
      best = fminf(best, face ? n2 : kOffFaceN2);
    }
  }

  float min_d = sqrtf(best + kEps) / denom;
  if constexpr (kForm == kRefine) min_d = fminf(min_d, kOffFace);
  if (best >= kOffFaceN2) min_d = kOffFace;
  out[o] = p.gate_on ? min_d + bias : min_d;
  if constexpr (kForm == kArgmin) idx[o] = best_s;
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
// The sample's coordinates, its veto and its taps are computed exactly as in
// march_kernel (the same __fmaf_rn, rintf and floor/ceil), so the backward
// vetoes the samples the forward vetoed. A vetoed sample (a constant 1e6), a
// culled pixel (a constant sentinel) and a zero cotangent give no gradient:
// those threads skip the work. Each other thread atomicAdds its five depth
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
__global__ void __launch_bounds__(kBlockRows * kBlockCols)
march_grad_kernel(const float* __restrict__ depth, const float* __restrict__ mask,
                  const float* __restrict__ light, const float* __restrict__ ts,
                  const int32_t* __restrict__ idx, const uint8_t* __restrict__ live,
                  const float* __restrict__ g, float* __restrict__ d_depth,
                  float* __restrict__ d_light, GradParams p) {
  const int h = p.height, w = p.width;
  const int b = blockIdx.z;
  const int row = blockIdx.y * kBlockRows + threadIdx.y;
  const int col = blockIdx.x * kBlockCols + threadIdx.x;
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
  __shared__ float s_sum[3][kBlockRows];
  if (threadIdx.x == 0) {
    s_sum[0][threadIdx.y] = gl_x;
    s_sum[1][threadIdx.y] = gl_y;
    s_sum[2][threadIdx.y] = gl_z;
  }
  __syncthreads();
  if (threadIdx.y == 0 && threadIdx.x < 3) {
    float s = 0.0f;
    for (int i = 0; i < kBlockRows; ++i) s += s_sum[threadIdx.x][i];
    if (s != 0.0f) atomicAdd(d_light + 3 * b + threadIdx.x, s);
  }
}

}  // namespace

// Plain C entry point (bound with ctypes): `form` is K1 (0), K2 (1) or K3 (2).
// Launches on `stream` and returns cudaGetLastError() so that the caller can
// raise on a refused launch.
extern "C" int gcfr_march_launch(
    int form, const float* depth, const float* mask, const float* light,
    const float* ts, const float* t_map, const uint8_t* live, float* out,
    int32_t* idx, int batch, int height, int width, int n_ts, int bilinear,
    int live_cols, int col_chunk, int gate_on, float lo_x, float hi_x,
    float lo_y, float hi_y, float gate_bias, float t_lo, float t_hi,
    void* stream) {
  MarchParams p{batch, height, width, n_ts, bilinear, live_cols, col_chunk,
                gate_on, lo_x, hi_x, lo_y, hi_y, gate_bias, t_lo, t_hi};
  dim3 block(kBlockCols, kBlockRows);
  dim3 grid((width + kBlockCols - 1) / kBlockCols,
            (height + kBlockRows - 1) / kBlockRows, batch);
  const size_t smem = (size_t)n_ts * sizeof(float);
  cudaStream_t st = (cudaStream_t)stream;
  switch (form) {
    case kMin:
      march_kernel<kMin><<<grid, block, smem, st>>>(depth, mask, light, ts, t_map, live, out, idx, p);
      break;
    case kArgmin:
      march_kernel<kArgmin><<<grid, block, smem, st>>>(depth, mask, light, ts, t_map, live, out, idx, p);
      break;
    case kRefine:
      march_kernel<kRefine><<<grid, block, smem, st>>>(depth, mask, light, ts, t_map, live, out, idx, p);
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
  dim3 block(kBlockCols, kBlockRows);
  dim3 grid((width + kBlockCols - 1) / kBlockCols,
            (height + kBlockRows - 1) / kBlockRows, batch);
  march_grad_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      depth, mask, light, ts, idx, live, g, d_depth, d_light, p);
  return (int)cudaGetLastError();
}

// Shadow ray-march (kernel K1): per pixel, the minimum over the t grid of the
// 3D distance from the pixel->light ray to the bilinearly sampled depth point
// on the pixel->border segment.
//
// Replaces: geomconsistentfr_tpu/ops/shadows_pallas.py `_march_kernel`
// (inference form: no argmin, no refine window), reached through
// `ray_march_min_distance_pallas`. Semantics are those of the plain march in
// geomconsistentfr_torch/ops/shadows.py, which is written op for op in the
// order this kernel evaluates.
//
// What bounds it on an H100. Per live pixel-sample the loop does about 60
// float32 operations outside the tensor cores (coordinates, floor/ceil, four
// depth taps, bilinear weights, the cross product and its norm; the bilinear
// veto adds about 20) against 4 to 8 cached loads. The inputs are tiny next
// to that work: at batch 64 x 256^2 x 160 samples with every pixel live the
// arithmetic is ~40 GFLOP (~0.6 ms at 67 TFLOP/s; the cull drops the pixels
// of face-free blocks) while depth, mask and output are 50 MB (~15 us at
// 3.35 TB/s). So the bound is f32 operations. The TPU kernel turned the
// gathers into one-hot matmuls because a TPU has no vector gather; a GPU
// has one, so here each tap is a plain load through the read-only path
// (__ldg), and a 256^2 f32 depth map (256 KiB) stays in L1/L2 -- a batch of
// 64 is 16 MiB and fits the 50 MB L2. No wgmma or TMA yet: there is no
// matrix product left once the gathers are loads, and the tiles a block
// reads are data-dependent (each ray crosses the whole image), so a TMA copy
// of a fixed tile has nothing to feed. Shared-memory staging of the depth
// map does not fit (256 KiB > 227 KB per block).
//
// Design. One thread per pixel; a block is 8 rows x 32 columns, which is one
// cull block at the tiers' shadow_col_chunk of 32. Per-pixel constants
// (endpoint, BC, denominator) are computed once in registers; the t grid is
// staged in shared memory. Blocks whose cull unit holds no face (a flag the
// wrapper computes once per call) write the all-vetoed sentinel and skip the
// loop. The loop carries the min of the raw cross-product norm^2 (1e30 for a
// vetoed sample); sqrt(n2 + 1e-4) / denom is monotone in n2, so the result
// equals the min of per-sample distances exactly, and is taken once at the end.
//
// Rounding choices:
//  * The veto's rounding is banker's (round half to even), as in the
//    reference and torch.round: rintf, never roundf (half away from zero).
//    The march hits exact halves systematically (integer pixel-to-border
//    spans stepped by t_step 0.005).
//  * Built with -fmad=false and without --use_fast_math, so the compiler
//    contracts nothing and every product and sum rounds on its own, as
//    PyTorch's eager ops in the plain march round them. Division and sqrt
//    stay IEEE (-prec-div / -prec-sqrt defaults).
//  * One exception, written out: the sample coordinates xx + t * diff are an
//    explicit __fmaf_rn. They alone decide the veto's rounding and the depth
//    taps' floor/ceil, and the march hits exact halves there (t = 0.1 on an
//    integer span gives sx = -0.5 unfused, -0.50000006 fused). The JAX
//    package's CPU march (XLA) fuses them; with the unfused form the port
//    flipped whole samples against it, and the fused form holds it to JAX
//    within float32 rounding. Against the reference's stored outputs both
//    forms score the same (tests/test_torch_render.py).
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

struct MarchParams {
  int batch, height, width, n_ts;
  int bilinear;                 // 0: one-hot veto, 1: bilinear veto
  int live_cols;                // cull blocks per 8-row group; 0 = no cull
  int col_chunk;                // cull block width in pixels
  int gate_on;
  float lo_x, hi_x, lo_y, hi_y, gate_bias;
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

__global__ void __launch_bounds__(kBlockRows * kBlockCols)
march_kernel(const float* __restrict__ depth, const float* __restrict__ mask,
             const float* __restrict__ light, const float* __restrict__ ts,
             const uint8_t* __restrict__ live, float* __restrict__ out,
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

  float best = INFINITY;
  for (int s = 0; s < p.n_ts; ++s) {
    const float t = s_ts[s];
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
    best = fminf(best, face ? n2 : kOffFaceN2);
  }

  float min_d = sqrtf(best + kEps) / denom;
  if (best >= kOffFaceN2) min_d = kOffFace;
  out[o] = p.gate_on ? min_d + bias : min_d;
}

}  // namespace

// Plain C entry point (bound with ctypes). Launches on `stream` and returns
// cudaGetLastError() so that the caller can raise on a refused launch.
extern "C" int gcfr_march_launch(
    const float* depth, const float* mask, const float* light, const float* ts,
    const uint8_t* live, float* out, int batch, int height, int width,
    int n_ts, int bilinear, int live_cols, int col_chunk, int gate_on,
    float lo_x, float hi_x, float lo_y, float hi_y, float gate_bias,
    void* stream) {
  MarchParams p{batch, height, width, n_ts, bilinear, live_cols, col_chunk,
                gate_on, lo_x, hi_x, lo_y, hi_y, gate_bias};
  dim3 block(kBlockCols, kBlockRows);
  dim3 grid((width + kBlockCols - 1) / kBlockCols,
            (height + kBlockRows - 1) / kBlockRows, batch);
  const size_t smem = (size_t)n_ts * sizeof(float);
  march_kernel<<<grid, block, smem, (cudaStream_t)stream>>>(
      depth, mask, light, ts, live, out, p);
  return (int)cudaGetLastError();
}

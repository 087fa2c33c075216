// The uint8 visual pack of Relighter.forward_visuals: from the render
// outputs and the masks, per pixel, the 12 bytes of
// infer.VISUAL_PACK_LAYOUT,
//
//   rendered * m (3), shadow_mask_weights * m, albedo * m (3),
//   (d - dmin) / max(dmax - dmin, 1e-12) * m, final_shading * m,
//   (normals + 1) / 2 * m (3),
//
// each value q written as floor(clamp(q * 255, 0, 255)), where d = -depth
// and dmin, dmax are its minimum and maximum over the pixel's image.
//
// Replaces no TPU kernel: the JAX package leaves the pack to XLA, which fuses
// it. The port's eager composition (infer.pack_visuals, still its plain
// version off the card) made six masked float32 pieces, concatenated them
// into a float32 (B, H, W, 12) tensor and passed over that four more times
// (* 255, clamp, floor, the cast): at batch 64 and 256^2, 2.5 ms a call.
//
// Semantics are the eager composition's: each float operation is one
// correctly rounded operation in the eager order (the __f*_rn intrinsics,
// and the build's -fmad=false), so for finite inputs every byte is the eager
// pack's. Min and max are exact in any order.
//
// What bounds it on an H100: bytes. A pixel reads 13 floats (52 B), its
// depth once more for the range, and writes 12 B: at batch 64 and 256^2,
// about 0.09 ms at 3.35 TB/s. Two kernels a launch:
//  * range_kernel: a grid of (splits, images) blocks, each the minimum and
//    maximum of -depth over its stretch of one image's pixels, written to
//    the caller's scratch (no atomics, no initialisation);
//  * pack_kernel: a grid of (pixel blocks, images), one pixel a thread,
//    neighbouring threads on neighbouring pixels. A block first combines its
//    image's splits (one warp, shuffles), then each thread reads its pixel's
//    13 floats by the element strides it is given (render() leaves every map
//    contiguous; a permuted NCHW map, a strided or an expanded view is read
//    as it is: no copy is made) and writes its 12 bytes as three 32-bit
//    stores, so a warp writes 384 contiguous bytes.
// Indices within an image are 32-bit, offsets 64-bit; the launcher splits
// the batch so that no grid exceeds 65535 images.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kSplits = 32;        // the most range blocks an image; its scratch holds 2 * kSplits floats
constexpr int kPerSplit = 4096;    // pixels a range block takes at least, where the image has them
constexpr int kMaps = 7;

// A float32 (B, H, W) or (B, H, W, C) tensor by its element strides.
struct Map {
  const float* p;
  long long b, h, w, c;
};

struct Params {
  Map rendered, albedo, normals, weights, depth, shading, mask;
  float* scratch;   // (B, 2 * kSplits): each split's (min, max) of -depth
  uint32_t* out;    // (B, H, W, 12) uint8, as three words a pixel
  int width, hw, splits, chunk;
};

__device__ __forceinline__ const float* pixel(const Map& m, int img, int i, int j) {
  return m.p + img * m.b + i * m.h + j * m.w;
}

// floor(clamp(x * 255, 0, 255)), the byte.
__device__ __forceinline__ uint32_t unit(float x) {
  const float q = fminf(fmaxf(__fmul_rn(x, 255.0f), 0.0f), 255.0f);
  return (uint32_t)floorf(q);
}

__global__ void __launch_bounds__(kThreads) range_kernel(Params p) {
  const int img = blockIdx.y, s = blockIdx.x;
  const int start = s * p.chunk, stop = min(p.hw, start + p.chunk);
  float lo = INFINITY, hi = -INFINITY;
  for (int q = start + threadIdx.x; q < stop; q += kThreads) {
    const int i = q / p.width;
    const float d = -__ldg(pixel(p.depth, img, i, q - i * p.width));
    lo = fminf(lo, d);
    hi = fmaxf(hi, d);
  }
#pragma unroll
  for (int k = 16; k > 0; k >>= 1) {
    lo = fminf(lo, __shfl_xor_sync(0xffffffffu, lo, k));
    hi = fmaxf(hi, __shfl_xor_sync(0xffffffffu, hi, k));
  }
  __shared__ float part[2][kThreads / 32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) part[0][warp] = lo, part[1][warp] = hi;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int k = 1; k < kThreads / 32; ++k) lo = fminf(lo, part[0][k]), hi = fmaxf(hi, part[1][k]);
    float* out = p.scratch + ((size_t)img * kSplits + s) * 2;
    out[0] = lo;
    out[1] = hi;
  }
}

__global__ void __launch_bounds__(kThreads) pack_kernel(Params p) {
  const int img = blockIdx.y;
  __shared__ float range[2];  // dmin, and max(dmax - dmin, 1e-12)
  if (threadIdx.x < 32) {
    const int s = threadIdx.x;
    const float* part = p.scratch + ((size_t)img * kSplits + s) * 2;
    float lo = s < p.splits ? part[0] : INFINITY, hi = s < p.splits ? part[1] : -INFINITY;
#pragma unroll
    for (int k = 16; k > 0; k >>= 1) {
      lo = fminf(lo, __shfl_xor_sync(0xffffffffu, lo, k));
      hi = fmaxf(hi, __shfl_xor_sync(0xffffffffu, hi, k));
    }
    if (s == 0) range[0] = lo, range[1] = fmaxf(__fsub_rn(hi, lo), 1e-12f);
  }
  __syncthreads();
  const int q = blockIdx.x * kThreads + threadIdx.x;
  if (q >= p.hw) return;
  const int i = q / p.width, j = q - i * p.width;
  const float m = __ldg(pixel(p.mask, img, i, j));
  const float* r = pixel(p.rendered, img, i, j);
  const float* a = pixel(p.albedo, img, i, j);
  const float* n = pixel(p.normals, img, i, j);
  const float d = -__ldg(pixel(p.depth, img, i, j));
  uint32_t rv[3], av[3], nv[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    rv[c] = unit(__fmul_rn(__ldg(r + c * p.rendered.c), m));
    av[c] = unit(__fmul_rn(__ldg(a + c * p.albedo.c), m));
    nv[c] = unit(__fmul_rn(__fdiv_rn(__fadd_rn(__ldg(n + c * p.normals.c), 1.0f), 2.0f), m));
  }
  const uint32_t shadow = unit(__fmul_rn(__ldg(pixel(p.weights, img, i, j)), m));
  const uint32_t depth = unit(__fmul_rn(__fdiv_rn(__fsub_rn(d, range[0]), range[1]), m));
  const uint32_t shading = unit(__fmul_rn(__ldg(pixel(p.shading, img, i, j)), m));
  uint32_t* o = p.out + ((size_t)img * p.hw + q) * 3;
  o[0] = rv[0] | rv[1] << 8 | rv[2] << 16 | shadow << 24;
  o[1] = av[0] | av[1] << 8 | av[2] << 16 | depth << 24;
  o[2] = shading | nv[0] << 8 | nv[1] << 16 | nv[2] << 24;
}

}  // namespace

// The pack of a batch of `batch` images of height x width: the seven maps
// (rendered, albedo, normals (B, H, W, 3); weights, depth, shading, mask
// (B, H, W)), float32, read by their element strides, four for each
// (B, H, W, 3) map (batch, row, column, channel) and three for each other,
// in that order (`strides`, 24 values); `scratch` holds 2 * 32 floats an
// image; `out` the contiguous (B, H, W, 12) uint8 pack, 4-byte aligned.
// Returns the first launch's error (cudaGetLastError), cudaErrorInvalidValue
// for arguments it does not take.
extern "C" int gcfr_pack_launch(const float* rendered, const float* albedo, const float* normals,
                                const float* weights, const float* depth, const float* shading, const float* mask,
                                const long long* strides, float* scratch, unsigned char* out, int batch, int height,
                                int width, void* stream) {
  if (batch < 0 || height <= 0 || width <= 0 || (long long)height * width > 0x7fffffffLL - kThreads)
    return (int)cudaErrorInvalidValue;
  if (batch == 0) return (int)cudaSuccess;
  const float* ptrs[kMaps] = {rendered, albedo, normals, weights, depth, shading, mask};
  for (const float* q : ptrs)
    if (q == nullptr) return (int)cudaErrorInvalidValue;
  if (strides == nullptr || scratch == nullptr || out == nullptr || (reinterpret_cast<uintptr_t>(out) & 3))
    return (int)cudaErrorInvalidValue;
  Map maps[kMaps];
  for (int k = 0, s = 0; k < kMaps; ++k) {
    const bool channels = k < 3;
    maps[k] = Map{ptrs[k], strides[s], strides[s + 1], strides[s + 2], channels ? strides[s + 3] : 0};
    s += channels ? 4 : 3;
  }
  const int hw = height * width;
  const int splits = (hw + kPerSplit - 1) / kPerSplit < kSplits ? (hw + kPerSplit - 1) / kPerSplit : kSplits;
  const int chunk = (hw + splits - 1) / splits;
  for (int b0 = 0; b0 < batch; b0 += 65535) {  // gridDim.y <= 65535
    const int nb = batch - b0 < 65535 ? batch - b0 : 65535;
    Map at[kMaps];
    for (int k = 0; k < kMaps; ++k) at[k] = maps[k], at[k].p += b0 * maps[k].b;
    const Params p{at[0], at[1], at[2], at[3], at[4], at[5], at[6], scratch + (size_t)b0 * 2 * kSplits,
                   reinterpret_cast<uint32_t*>(out) + (size_t)b0 * hw * 3, width, hw, splits, chunk};
    range_kernel<<<dim3(splits, nb), kThreads, 0, (cudaStream_t)stream>>>(p);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    pack_kernel<<<dim3((hw + kThreads - 1) / kThreads, nb), kThreads, 0, (cudaStream_t)stream>>>(p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

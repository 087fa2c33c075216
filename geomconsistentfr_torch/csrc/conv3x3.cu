// A direct float32 3x3 convolution, stride 1, padding 1, 16 input and 16
// output channels, on channels-last maps, with the eval-mode epilogue of
// csrc/epilogue.cu computed on the sums before the one store:
//
//   z = act(A(conv(x, W)) + r),  A(u) = ((u + b) - mean) * inv * gamma + beta
//
// per channel, r absent, a plain tensor of z's shape, or A'(v) of a second
// convolution's output (a projection shortcut, with its own BatchNorm), act
// LeakyReLU(slope) or the identity. Two forms, as in epilogue.cu:
//
//  bn_act  writes z, (B, H, W, 16);
//  join    writes the nearest x2 upsample of z, plus a skip tensor of the
//          upsampled shape where one is given.
//
// Replaces no TPU kernel: the JAX package leaves its convolutions to XLA.
// The port ran these layers (RelightNet's 16-channel 3x3 convolutions and
// stride-1 transposed convolutions, the latter as convolutions with the
// flipped, transposed weights) through cuDNN under deterministic algorithms,
// which at 256^2 fall back to a generic engine at a ninth of the card's
// float32 rate, and then one more pass of epilogue.cu over device memory.
//
// What bounds it on an H100: operations. A batch-64 map of 256^2 x 16 is
// 2 * 64 * 256^2 * 16 * 16 * 9 = 19.33 GFLOP, 0.29 ms at 67 TFLOP/s, against
// 268 MB in and 268 MB out (0.16 ms at 3.35 TB/s); a join from 128^2 writes
// four times its input and reads the skip, and is bound by bytes. The design:
//  * a block of 64 threads takes an output tile of 8 rows by 32 columns of
//    one image; it stages the tile's input with a one-pixel halo (zeros
//    outside the image) in shared memory, 20 floats a pixel (16 channels and
//    4 of padding, so that a warp's 16-byte reads of 32 neighbouring pixels
//    hit no bank twice), and the 2304 weights as [tap][ci][co], which every
//    thread of the block reads at the same address (a broadcast);
//  * a thread holds 4 output pixels of one column (4 consecutive rows) x 16
//    output channels: 64 accumulators. For each column tap kx and quad of
//    input channels it reads the 6 input pixels its 4 rows' windows need
//    once and reuses them across the 3 row taps; each input value meets 16
//    broadcast weights in 16 explicit FMAs (__fmaf_rn: the build's
//    -fmad=false would otherwise split a*b + c into FMUL and FADD);
//  * each output is its 144 products summed in float32 FMAs from 0, in the
//    order (kx, quad of 4 input channels, ky, channel within the quad), the
//    same in every block and launch: no TF32, no Winograd or FFT, no split of
//    the sum across threads or blocks, no atomics. Two launches, and two
//    processes, give the same bits;
//  * the epilogue is epilogue.cu's, operation for operation (__f*_rn in its
//    order), on the accumulators; the join writes the four upsampled copies
//    from the one value.
// One tile for every shape: 16 rows or 4 rows a block were no faster at the
// shapes RelightNet runs at batch 1, 8 and 64 (PERF.md's kernel table).

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kC = 16;                      // channels in and out
constexpr int kTileW = 32;                  // output columns a block: one per lane
constexpr int kWarps = 2;
constexpr int kThreads = 32 * kWarps;
constexpr int kRowsPerThread = 4;           // output rows a thread, in one column
constexpr int kRows = kRowsPerThread * kWarps;  // output rows a block
constexpr int kPix = kC + 4;                // floats a staged pixel
constexpr int kInW = kTileW + 2;            // staged input columns, the halo included
constexpr int kInRows = kRows + 2;
constexpr int kTaps = 9;
constexpr int kInFloats = kInRows * kInW * kPix;
constexpr int kSmemFloats = kInFloats + kTaps * kC * kC + 2 * 5 * kC;
static_assert(kSmemFloats * sizeof(float) <= 48 * 1024, "dynamic shared memory without an opt-in");

struct Params {
  const float* x;      // (B, H, W, 16) input
  const float* taps;   // (9, 16, 16) weights: [ky * 3 + kx][ci][co]
  const float* vec;    // (5, 16): bias, mean, inv, gamma, beta
  const float* r;      // residual (B, H, W, 16): null, a plain tensor, or the second convolution's output
  const float* r_vec;  // its (5, 16) vectors where r is a second affine's input, else null
  const float* skip;   // join: (B, 2H, 2W, 16), added after the upsample; null for none
  float* out;          // (B, H, W, 16), or (B, 2H, 2W, 16) for the join
  int h, w;
  int has_bias, r_has_bias, act, join;
  float slope;
};

__device__ __forceinline__ float lane_of(const float4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

// A(x) on one pixel's 16 channels, vectors vec (5, 16) in shared memory, in
// epilogue.cu's order: ((x + b) - mean) * inv * gamma + beta.
__device__ __forceinline__ void affine(float (&x)[kC], const float* vec, int has_bias) {
#pragma unroll
  for (int co = 0; co < kC; ++co) {
    float y = has_bias ? __fadd_rn(x[co], vec[co]) : x[co];
    y = __fsub_rn(y, vec[kC + co]);
    y = __fmul_rn(y, vec[2 * kC + co]);
    y = __fmul_rn(y, vec[3 * kC + co]);
    x[co] = __fadd_rn(y, vec[4 * kC + co]);
  }
}

__device__ __forceinline__ void load16(float (&v)[kC], const float* p) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p) + q);
    v[4 * q] = t.x, v[4 * q + 1] = t.y, v[4 * q + 2] = t.z, v[4 * q + 3] = t.w;
  }
}

__device__ __forceinline__ void store16(float* p, const float (&v)[kC]) {
#pragma unroll
  for (int q = 0; q < 4; ++q)
    reinterpret_cast<float4*>(p)[q] = make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
}

__global__ void __launch_bounds__(kThreads, 6) conv3x3_kernel(Params p) {
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);  // [kInRows][kInW][kPix]
  float* ws = xs + kInFloats;                   // [tap][ci][co]
  float* vs = ws + kTaps * kC * kC;             // vec, then r_vec: [2][5][16]

  const int tid = threadIdx.x;
  const int n = blockIdx.z;
  const int row0 = blockIdx.y * kRows, col0 = blockIdx.x * kTileW;

  for (int i = tid; i < kTaps * kC * kC / 4; i += kThreads)
    reinterpret_cast<float4*>(ws)[i] = __ldg(reinterpret_cast<const float4*>(p.taps) + i);
  for (int i = tid; i < 5 * kC; i += kThreads) {
    vs[i] = __ldg(p.vec + i);
    vs[5 * kC + i] = p.r_vec != nullptr ? __ldg(p.r_vec + i) : 0.0f;
  }
  const float* xn = p.x + (size_t)n * p.h * p.w * kC;
  for (int i = tid; i < kInRows * kInW * 4; i += kThreads) {
    const int q = i & 3, pix = i >> 2;
    const int gy = row0 - 1 + pix / kInW, gx = col0 - 1 + pix % kInW;
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (gy >= 0 && gy < p.h && gx >= 0 && gx < p.w)
      v = __ldg(reinterpret_cast<const float4*>(xn + ((size_t)gy * p.w + gx) * kC) + q);
    *reinterpret_cast<float4*>(xs + pix * kPix + 4 * q) = v;
  }
  __syncthreads();

  const int lane = tid & 31, warp = tid >> 5;
  float acc[kRowsPerThread][kC];
#pragma unroll
  for (int k = 0; k < kRowsPerThread; ++k)
#pragma unroll
    for (int co = 0; co < kC; ++co) acc[k][co] = 0.0f;

  // The thread's input window: staged rows warp * 4 + (0 .. 5), columns lane + (0 .. 2).
  const float* xt = xs + (warp * kRowsPerThread * kInW + lane) * kPix;
#pragma unroll 1
  for (int kx = 0; kx < 3; ++kx) {
#pragma unroll 1
    for (int q = 0; q < 4; ++q) {
      float4 in[kRowsPerThread + 2];
#pragma unroll
      for (int r = 0; r < kRowsPerThread + 2; ++r)
        in[r] = *reinterpret_cast<const float4*>(xt + (r * kInW + kx) * kPix + 4 * q);
      // Weights of tap (ky, kx), input channel 4q + c: ws[((ky * 3 + kx) * 16 + 4q + c) * 16 + co].
      const float* wq = ws + (kx * kC + 4 * q) * kC;
#pragma unroll
      for (int ky = 0; ky < 3; ++ky) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float4* wc = reinterpret_cast<const float4*>(wq + (ky * 3 * kC + c) * kC);
          float wv[kC];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float4 t = wc[j];
            wv[4 * j] = t.x, wv[4 * j + 1] = t.y, wv[4 * j + 2] = t.z, wv[4 * j + 3] = t.w;
          }
#pragma unroll
          for (int k = 0; k < kRowsPerThread; ++k) {
            const float xv = lane_of(in[k + ky], c);
#pragma unroll
            for (int co = 0; co < kC; ++co) acc[k][co] = __fmaf_rn(xv, wv[co], acc[k][co]);
          }
        }
      }
    }
  }

  // The epilogue on the thread's 4 pixels, one at a time.
  const int col = col0 + lane;
  if (col >= p.w) return;
  const size_t h2 = 2 * (size_t)p.h, w2 = 2 * (size_t)p.w;
#pragma unroll
  for (int k = 0; k < kRowsPerThread; ++k) {
    const int row = row0 + warp * kRowsPerThread + k;
    if (row >= p.h) break;
    const size_t e = (((size_t)n * p.h + row) * p.w + col) * kC;
    float z[kC], r[kC];
    if (p.r != nullptr) load16(r, p.r + e);
#pragma unroll
    for (int co = 0; co < kC; ++co) z[co] = acc[k][co];
    affine(z, vs, p.has_bias);
    if (p.r != nullptr) {
      if (p.r_vec != nullptr) affine(r, vs + 5 * kC, p.r_has_bias);
#pragma unroll
      for (int co = 0; co < kC; ++co) z[co] = __fadd_rn(r[co], z[co]);
    }
    if (p.act) {
#pragma unroll
      for (int co = 0; co < kC; ++co) z[co] = z[co] >= 0.0f ? z[co] : __fmul_rn(p.slope, z[co]);
    }
    if (!p.join) {
      store16(p.out + e, z);
      continue;
    }
#pragma unroll
    for (int d = 0; d < 4; ++d) {
      const size_t o = (((size_t)n * h2 + 2 * row + (d >> 1)) * w2 + 2 * col + (d & 1)) * kC;
      float y[kC];
      if (p.skip != nullptr) {
        load16(y, p.skip + o);
#pragma unroll
        for (int co = 0; co < kC; ++co) y[co] = __fadd_rn(z[co], y[co]);
      } else {
#pragma unroll
        for (int co = 0; co < kC; ++co) y[co] = z[co];
      }
      store16(p.out + o, y);
    }
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

// One convolution and its epilogue over a (B, H, W, 16) input x, weights
// `taps` as (9, 16, 16) [ky * 3 + kx][ci][co] (the convolution's, not a
// transposed convolution's), vectors vec (5, 16). `r` null: no residual;
// `r_vec` null: r is added as it is, else A'(r) with r_vec's vectors. `join`:
// out and skip are (B, 2H, 2W, 16). `act`: LeakyReLU with `slope`, else the
// identity. Every pointer 16-byte aligned. Returns the first launch's error
// (cudaGetLastError), cudaErrorInvalidValue for what it does not take.
extern "C" int gcfr_conv3x3_launch(const float* x, const float* taps, const float* vec, int has_bias,
                                   const float* r, const float* r_vec, int r_has_bias, const float* skip, float* out,
                                   int batch, int height, int width, int join, int act, float slope, void* stream) {
  if (batch < 0 || height <= 0 || width <= 0 || (height + kRows - 1) / kRows > 65535)
    return (int)cudaErrorInvalidValue;
  if (x == nullptr || taps == nullptr || vec == nullptr || out == nullptr) return (int)cudaErrorInvalidValue;
  const void* ptrs[] = {x, taps, vec, r, r_vec, skip, out};
  for (const void* q : ptrs)
    if (!aligned16(q)) return (int)cudaErrorInvalidValue;
  const int smem = kSmemFloats * (int)sizeof(float);
  const size_t per = (size_t)height * width * kC, out_per = join ? 4 * per : per;
  for (int b0 = 0; b0 < batch; b0 += 65535) {  // gridDim.z <= 65535
    const int nb = batch - b0 < 65535 ? batch - b0 : 65535;
    const size_t off = (size_t)b0 * per, out_off = (size_t)b0 * out_per;
    const Params p{x + off, taps, vec, r == nullptr ? nullptr : r + off, r_vec,
                   skip == nullptr ? nullptr : skip + out_off, out + out_off, height, width, has_bias,
                   r_has_bias, act, join, slope};
    const dim3 grid((width + kTileW - 1) / kTileW, (height + kRows - 1) / kRows, nb);
    conv3x3_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(p);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

// The eval-mode epilogue of RelightNet's convolutions: per element,
//
//   z = act(A(u) + r),  A(u) = ((u + b) - mean) * inv * gamma + beta
//
// per channel, where u is a convolution's output without its bias, r is
// absent, a plain tensor of u's shape, or A'(v) of a second convolution's
// output (a projection shortcut, with its own BatchNorm), and act is
// LeakyReLU(slope) or the identity. Two forms:
//
//  bn_act  writes z, the shape of u: every conv -> (+bias) -> BatchNorm ->
//          (+ residual) -> LeakyReLU of models/relightnet.py.
//  join    writes the nearest x2 upsample of z, plus a skip tensor of the
//          upsampled shape where one is given: a decoder stage's end,
//          up2(lrelu(sc + A(y2))) [+ s_out].
//
// Replaces no TPU kernel: the JAX package leaves these elementwise chains to
// XLA, which fuses them; the port's eager PyTorch composition ran each one as
// ~11 passes over the activation (bias, four BatchNorm passes, LeakyReLU's
// compare, multiply and select, the adds), each through device memory.
//
// Semantics are those of the eager composition in
// geomconsistentfr_torch/models/layers.py (BatchNorm.forward in eval mode,
// leaky_relu, upsample2_nearest) and of the plain version in
// geomconsistentfr_torch/ops/epilogue_cuda.py: each float operation is one
// correctly rounded operation in the eager order (the __f*_rn intrinsics,
// and the build's -fmad=false), so every output is bit-equal to it. The
// per-channel vectors come from the wrapper as torch computed them
// (inv = rsqrt(var + eps) included); nothing is folded.
//
// What bounds it on an H100: bytes. An element needs 5 float operations an
// affine and reads 4 bytes an operand, so a launch moves its operands once
// in and its output once out, at 3.35 TB/s (a batch-64 map of 256^2 x 16 in
// float32 is 268 MB). The design keeps it one pass: a thread takes four
// consecutive elements in 16-byte loads and stores where the layout keeps
// them in one channel (NCHW, H*W % 4 == 0) or in four consecutive channels
// of one pixel (channels-last, C % 4 == 0); the per-channel vectors (a few
// KB) are read through the read-only path and stay in L1. The join computes
// z once per source element and writes its four upsampled copies. Elsewhere
// a thread takes one element. Indices are 32-bit: the launcher splits the
// batch so that no launch addresses 2^31 elements.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

struct Params {
  const float* u;      // the convolution's output without its bias
  const float* vec;    // (5, C): bias, mean, inv, gamma, beta
  const float* r;      // residual: null, a plain tensor, or the second convolution's output
  const float* r_vec;  // its (5, C) vectors where r is a second affine's input, else null
  const float* skip;   // join: added after the upsample; null for none
  float* out;
  unsigned n;          // elements of u in this launch
  unsigned c, w, hw;
  int has_bias, r_has_bias, act;
  float slope;
};

template <int V>
struct Lanes {
  float v[V];
};

// V floats from p: 16-byte loads and stores where V is a multiple of 4 (p
// then 16-byte aligned), else one float at a time.
template <int V>
__device__ __forceinline__ Lanes<V> load(const float* p) {
  Lanes<V> x;
  if constexpr (V % 4 == 0) {
#pragma unroll
    for (int k = 0; k < V; k += 4) {
      const float4 t = __ldg(reinterpret_cast<const float4*>(p + k));
      x.v[k] = t.x, x.v[k + 1] = t.y, x.v[k + 2] = t.z, x.v[k + 3] = t.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) x.v[k] = __ldg(p + k);
  }
  return x;
}

template <int V>
__device__ __forceinline__ void store(float* p, const Lanes<V>& x) {
  if constexpr (V % 4 == 0) {
#pragma unroll
    for (int k = 0; k < V; k += 4)
      *reinterpret_cast<float4*>(p + k) = make_float4(x.v[k], x.v[k + 1], x.v[k + 2], x.v[k + 3]);
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) p[k] = x.v[k];
  }
}

template <int V>
__device__ __forceinline__ void add_to(Lanes<V>& y, const Lanes<V>& s) {
#pragma unroll
  for (int k = 0; k < V; ++k) y.v[k] = __fadd_rn(y.v[k], s.v[k]);
}

// One row of the (5, C) vectors for the V lanes from channel c0: four
// consecutive channels (channels-last) or one channel for all lanes.
template <bool CL, int V>
__device__ __forceinline__ Lanes<V> channel_row(const float* row, unsigned c0) {
  if constexpr (CL && V == 4) {
    return load<4>(row + c0);
  } else {
    Lanes<V> x;
    const float t = __ldg(row + c0);
#pragma unroll
    for (int k = 0; k < V; ++k) x.v[k] = t;
    return x;
  }
}

// A(x) in the eager order: ((x + b) - mean) * inv * gamma + beta.
template <bool CL, int V>
__device__ __forceinline__ Lanes<V> affine(Lanes<V> x, const float* vec, int has_bias, unsigned c, unsigned c0) {
  if (has_bias) {
    const Lanes<V> b = channel_row<CL, V>(vec, c0);
#pragma unroll
    for (int k = 0; k < V; ++k) x.v[k] = __fadd_rn(x.v[k], b.v[k]);
  }
  const Lanes<V> mean = channel_row<CL, V>(vec + c, c0);
  const Lanes<V> inv = channel_row<CL, V>(vec + 2 * c, c0);
  const Lanes<V> gamma = channel_row<CL, V>(vec + 3 * c, c0);
  const Lanes<V> beta = channel_row<CL, V>(vec + 4 * c, c0);
#pragma unroll
  for (int k = 0; k < V; ++k) {
    float y = __fsub_rn(x.v[k], mean.v[k]);
    y = __fmul_rn(y, inv.v[k]);
    y = __fmul_rn(y, gamma.v[k]);
    x.v[k] = __fadd_rn(y, beta.v[k]);
  }
  return x;
}

// z = act(A(u) + r) for the V elements from e, whose channel is c0 (and the
// next V - 1 channels, channels-last with V = 4).
template <bool CL, int V>
__device__ __forceinline__ Lanes<V> epilogue(const Params& p, unsigned e, unsigned c0) {
  Lanes<V> z = affine<CL, V>(load<V>(p.u + e), p.vec, p.has_bias, p.c, c0);
  if (p.r != nullptr) {
    Lanes<V> r = load<V>(p.r + e);
    if (p.r_vec != nullptr) r = affine<CL, V>(r, p.r_vec, p.r_has_bias, p.c, c0);
#pragma unroll
    for (int k = 0; k < V; ++k) z.v[k] = __fadd_rn(r.v[k], z.v[k]);
  }
  if (p.act) {
#pragma unroll
    for (int k = 0; k < V; ++k) z.v[k] = z.v[k] >= 0.0f ? z.v[k] : __fmul_rn(p.slope, z.v[k]);
  }
  return z;
}

template <bool CL>
__device__ __forceinline__ unsigned channel_of(const Params& p, unsigned e) {
  return CL ? e % p.c : (e / p.hw) % p.c;
}

template <bool CL, int V>
__global__ void __launch_bounds__(kThreads) bn_act_kernel(Params p) {
  const unsigned e = (blockIdx.x * kThreads + threadIdx.x) * V;
  if (e >= p.n) return;
  store<V>(p.out + e, epilogue<CL, V>(p, e, channel_of<CL>(p, e)));
}

// The join: z at source element e goes to the 2x2 block of the upsampled
// (2H, 2W) map, plus the skip there. p.n, c, h, w are the source's.
template <bool CL, int V>
__global__ void __launch_bounds__(kThreads) join_kernel(Params p) {
  const unsigned e = (blockIdx.x * kThreads + threadIdx.x) * V;
  if (e >= p.n) return;
  const Lanes<V> z = epilogue<CL, V>(p, e, channel_of<CL>(p, e));
  const unsigned w2 = 2 * p.w;
  if constexpr (CL) {
    // e = ((n * H + i) * W + j) * C + c; output row (n, 2i + di) is 2 * (n * H + i) + di.
    const unsigned c0 = e % p.c, q = e / p.c, j = q % p.w, row = 2 * (q / p.w);
#pragma unroll
    for (int d = 0; d < 4; ++d) {
      const unsigned o = ((row + (d >> 1)) * w2 + 2 * j + (d & 1)) * p.c + c0;
      Lanes<V> y = z;
      if (p.skip != nullptr) add_to(y, load<V>(p.skip + o));
      store<V>(p.out + o, y);
    }
  } else {
    // e = ((n * C + c) * H + i) * W + j, the V lanes j .. j + V - 1 of one row; each
    // lane is written twice side by side, on output rows 2 * (e / W) and the next.
    const unsigned j = e % p.w, row = 2 * (e / p.w);
    Lanes<2 * V> y0;
#pragma unroll
    for (int k = 0; k < 2 * V; ++k) y0.v[k] = z.v[k >> 1];
#pragma unroll
    for (int di = 0; di < 2; ++di) {
      const unsigned o = (row + di) * w2 + 2 * j;
      Lanes<2 * V> y = y0;
      if (p.skip != nullptr) add_to(y, load<2 * V>(p.skip + o));
      store<2 * V>(p.out + o, y);
    }
  }
}

template <bool CL, int V>
cudaError_t launch(const Params& p, int join, cudaStream_t stream) {
  const unsigned blocks = (p.n / V + kThreads - 1) / kThreads;
  if (blocks == 0) return cudaSuccess;
  if (join) {
    join_kernel<CL, V><<<blocks, kThreads, 0, stream>>>(p);
  } else {
    bn_act_kernel<CL, V><<<blocks, kThreads, 0, stream>>>(p);
  }
  return cudaGetLastError();
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

// One epilogue over a (B, C, H, W) map u, in NCHW or channels-last memory
// order (`channels_last`; r, v and skip in the same order, out allocated in
// it by the caller). `r` null: no residual; `r_vec` null: r is added as it
// is, else A'(r) with r_vec's vectors. `join`: out and skip are (B, C, 2H,
// 2W). `act`: LeakyReLU with `slope`, else the identity. Returns the first
// launch's error (cudaGetLastError), cudaErrorInvalidValue for shapes it
// does not take.
extern "C" int gcfr_epilogue_launch(const float* u, const float* vec, int has_bias, const float* r,
                                    const float* r_vec, int r_has_bias, const float* skip, float* out, int batch,
                                    int channels, int height, int width, int channels_last, int join, int act,
                                    float slope, void* stream) {
  if (batch < 0 || channels <= 0 || height <= 0 || width <= 0) return (int)cudaErrorInvalidValue;
  if (batch == 0) return (int)cudaSuccess;
  const long long per = (long long)channels * height * width;  // elements of one image of u
  const long long out_per = join ? 4 * per : per;
  const long long limit = 0x7fffffffLL;
  if (out_per > limit) return (int)cudaErrorInvalidValue;
  const int chunk = (int)(limit / out_per < batch ? limit / out_per : batch);  // images a launch
  const bool cl = channels_last != 0;
  const bool vec4 = (cl ? channels % 4 == 0 : (join ? width % 4 == 0 : (height * width) % 4 == 0)) &&
                    aligned16(u) && aligned16(out) && (r == nullptr || aligned16(r)) &&
                    (skip == nullptr || aligned16(skip)) && aligned16(vec) && (r_vec == nullptr || aligned16(r_vec));
  for (int b0 = 0; b0 < batch; b0 += chunk) {
    const int nb = batch - b0 < chunk ? batch - b0 : chunk;
    const long long off = (long long)b0 * per, out_off = (long long)b0 * out_per;
    const Params p{u + off, vec, r == nullptr ? nullptr : r + off, r_vec, skip == nullptr ? nullptr : skip + out_off,
                   out + out_off, (unsigned)(nb * per), (unsigned)channels, (unsigned)width,
                   (unsigned)(height * width), has_bias, r_has_bias, act, slope};
    cudaError_t err;
    if (cl) {
      err = vec4 ? launch<true, 4>(p, join, (cudaStream_t)stream) : launch<true, 1>(p, join, (cudaStream_t)stream);
    } else {
      err = vec4 ? launch<false, 4>(p, join, (cudaStream_t)stream) : launch<false, 1>(p, join, (cudaStream_t)stream);
    }
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

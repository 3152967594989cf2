// The ResNet trunk's frozen-BN epilogue for Hopper (sm_90a): the affine of a
// frozen batch norm, the residual (itself through a frozen batch norm, or
// not) and the ReLU in one pass over a channels_last map. Every one of the
// trunk's sites ends in the ReLU.
//
// Replaces no Pallas kernel: the JAX package leaves egtr_tpu/models/
// backbone.py's FrozenBatchNorm, its ReLU and the bottleneck's residual add
// to XLA, which fuses them on the TPU. PyTorch runs them as separate
// kernels: five on the parameter vectors (var + eps, the -0.5 power,
// weight * it, mean * scale, bias - that), a multiply and an add over the
// whole map, then the residual add and the ReLU, each a pass of its own. The
// port's inference forward (grad mode off) takes this kernel instead at each
// of the trunk's sites (models/backbone.py:frozen_bn_act); the autograd path
// keeps PyTorch's expression.
//
// What it computes, per element of channel c of an [N, H, W, C]
// (channels_last) map x, with r the residual map of the same shape:
//
//   out = relu( bn(x) [+ bn_r(r) | + r] )
//   bn(x) = round(round(x * s[c]) + b[c])
//   s = weight * (running_var + 1e-5) ** -0.5,  b = bias - running_mean * s
//
// each operation rounded on its own as PyTorch's kernels round it: the
// parameters in float32 (__fadd_rn, rsqrtf as PyTorch's pow(v, -0.5), which
// runs its rsqrt kernel, __fmul_rn, __fsub_rn: never contracted to an FMA);
// s and b then rounded to the map's type; each of x * s, + b and + r computed
// in float32 and rounded to the map's type (PyTorch's opmath for bfloat16);
// the ReLU as PyTorch's clamp_min(v, 0) (NaN kept, else fmaxf). So in
// float32 and bfloat16 alike the output is PyTorch's, bit for bit.
//
// Bound: bytes. A site reads x (and r) and writes out once: an element of
// float32 is 8 or 12 bytes against some ten float32 operations, far below
// the card's 20 operations a byte. The design streams: one 16-byte vector
// (four float32 or eight bfloat16 channels of one pixel) a load,
// FBN_UNROLL vectors of x (and of r) in flight a thread before any is used,
// neighbouring lanes on neighbouring vectors, no shared memory. The
// parameters are read per vector from L1 (at most 2048 channels, 32 KB for a
// site), and s and b are worked out again for each vector: some twenty
// float32 operations a channel, under the bytes' time. out may be x itself
// (each thread reads its vectors before it writes them).
//
// The launch is worked out in Python (msda_cuda.frozen_bn_geometry) and
// re-checked here (geometry_ok): vector v = (block * FBN_UNROLL + k) *
// FBN_THREADS + thread, elements [v * vec, v * vec + vec), channels
// (v % (C / vec)) * vec onwards.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define FBN_THREADS 256
#define FBN_UNROLL 4
#define FBN_VEC_BYTES 16

namespace {

struct Geom {
  int vec, unroll, threads, blocks;
};

// modes of the residual
enum { NO_RESIDUAL = 0, IDENTITY = 1, RESIDUAL_BN = 2 };

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// a float32 result rounded to T and read back as float32
template <typename T>
__device__ __forceinline__ float rounded(float v);
template <>
__device__ __forceinline__ float rounded<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ float rounded<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <typename T>
__device__ __forceinline__ T store_as(float v);
template <>
__device__ __forceinline__ float store_as<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 store_as<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);  // exact: v is already a bfloat16 value
}

struct Params {
  const float *weight, *bias, *mean, *var;
};

// channel c's scale and shift, computed and rounded as PyTorch's expression
// computes them, then rounded to T
template <typename T>
__device__ __forceinline__ void scale_shift(const Params& p, int c, float& s,
                                            float& b) {
  const float sf = __fmul_rn(__ldg(p.weight + c),
                             rsqrtf(__fadd_rn(__ldg(p.var + c), 1e-5f)));
  const float bf = __fsub_rn(__ldg(p.bias + c),
                             __fmul_rn(__ldg(p.mean + c), sf));
  s = rounded<T>(sf);
  b = rounded<T>(bf);
}

template <typename T>
__device__ __forceinline__ float affine(float x, float s, float b) {
  return rounded<T>(__fadd_rn(rounded<T>(__fmul_rn(x, s)), b));
}

template <typename T, int VEC, int MODE>
__global__ void __launch_bounds__(FBN_THREADS)
frozen_bn_kernel(const T* x, Params p, const T* __restrict__ r, Params pr,
                 T* out, int n_vec, int c_vec) {
  using V = Pack<T, VEC>;
  const int first = blockIdx.x * (FBN_UNROLL * FBN_THREADS) + threadIdx.x;
  V xv[FBN_UNROLL], rv[FBN_UNROLL];
#pragma unroll
  for (int k = 0; k < FBN_UNROLL; ++k) {
    const int v = first + k * FBN_THREADS;
    if (v < n_vec) {
      xv[k] = reinterpret_cast<const V*>(x)[v];
      if (MODE != NO_RESIDUAL) rv[k] = reinterpret_cast<const V*>(r)[v];
    }
  }
#pragma unroll
  for (int k = 0; k < FBN_UNROLL; ++k) {
    const int v = first + k * FBN_THREADS;
    if (v >= n_vec) continue;
    const int c0 = (v % c_vec) * VEC;
    V o;
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      float s, b;
      scale_shift<T>(p, c0 + j, s, b);
      float y = affine<T>(to_float(xv[k].v[j]), s, b);
      if (MODE != NO_RESIDUAL) {
        float res = to_float(rv[k].v[j]);
        if (MODE == RESIDUAL_BN) {
          float sr, br;
          scale_shift<T>(pr, c0 + j, sr, br);
          res = affine<T>(res, sr, br);
        }
        y = rounded<T>(__fadd_rn(y, res));
      }
      if (!isnan(y)) y = fmaxf(y, 0.0f);
      o.v[j] = store_as<T>(y);
    }
    reinterpret_cast<V*>(out)[v] = o;
  }
}

bool geometry_ok(const Geom& g, long numel, int C, int element_size) {
  if (g.threads != FBN_THREADS || g.unroll != FBN_UNROLL) return false;
  if (g.vec * element_size != FBN_VEC_BYTES || C % g.vec != 0) return false;
  const long n_vec = numel / g.vec;
  const long per_block = (long)FBN_THREADS * FBN_UNROLL;
  // every vector in some block, no block without one
  return n_vec >= 1 && g.blocks >= 1 && (long)g.blocks * per_block >= n_vec &&
         (long)(g.blocks - 1) * per_block < n_vec;
}

template <typename T, int VEC, int MODE>
int launch_t(const Geom& g, const void* x, Params p, const void* r, Params pr,
             void* out, int n_vec, int c_vec, cudaStream_t s) {
  frozen_bn_kernel<T, VEC, MODE><<<g.blocks, FBN_THREADS, 0, s>>>(
      (const T*)x, p, (const T*)r, pr, (T*)out, n_vec, c_vec);
  return (int)cudaGetLastError();
}

template <typename T, int VEC>
int launch_v(const Geom& g, int mode, const void* x, Params p, const void* r,
             Params pr, void* out, int n_vec, int c_vec, cudaStream_t s) {
  switch (mode) {
    case NO_RESIDUAL:
      return launch_t<T, VEC, NO_RESIDUAL>(g, x, p, r, pr, out, n_vec, c_vec,
                                           s);
    case IDENTITY:
      return launch_t<T, VEC, IDENTITY>(g, x, p, r, pr, out, n_vec, c_vec, s);
    case RESIDUAL_BN:
      return launch_t<T, VEC, RESIDUAL_BN>(g, x, p, r, pr, out, n_vec, c_vec,
                                           s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// x, out: [numel / C, C] (an [N, H, W, C] map); r: the same, or null
// (mode 0); the four parameter vectors [C] float32 of x's norm and, in mode
// 2, of r's; bf16: the maps' type (0 float32, 1 bfloat16); mode: 0 none,
// 1 r added, 2 r through its own norm added; geometry: the four ints of
// struct Geom, in its order.
extern "C" int frozen_bn(const void* x, const void* weight, const void* bias,
                         const void* mean, const void* var, const void* r,
                         const void* r_weight, const void* r_bias,
                         const void* r_mean, const void* r_var, void* out,
                         long numel, int C, int bf16, int mode,
                         const int* geometry, void* stream) {
  const Geom g{geometry[0], geometry[1], geometry[2], geometry[3]};
  const int element_size = bf16 ? 2 : 4;
  if (C < 1 || numel % C != 0 || numel >= (1L << 31) || mode < 0 ||
      mode > 2 || (mode != 0 && r == nullptr) ||
      !geometry_ok(g, numel, C, element_size))
    return (int)cudaErrorInvalidValue;
  const Params p{(const float*)weight, (const float*)bias,
                 (const float*)mean, (const float*)var};
  const Params pr{(const float*)r_weight, (const float*)r_bias,
                  (const float*)r_mean, (const float*)r_var};
  const int n_vec = (int)(numel / g.vec), c_vec = C / g.vec;
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    return launch_v<__nv_bfloat16, 8>(g, mode, x, p, r, pr, out, n_vec, c_vec,
                                      s);
  return launch_v<float, 4>(g, mode, x, p, r, pr, out, n_vec, c_vec, s);
}

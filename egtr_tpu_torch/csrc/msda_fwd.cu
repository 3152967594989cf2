// Exact multi-scale deformable attention forward for Hopper (sm_90a).
//
// Replaces egtr_tpu/ops/msda_pallas.py:_fwd_kernel / _fwd_body (the Pallas
// TPU kernel K1, launched once per level by _level_pallas_fwd). The TPU
// kernel builds dense separable "hat" vectors and contracts them on the MXU
// because the TPU has no fast gather; this card has one, so the kernel reads
// the two-by-two bilinear corners directly.
//
// Design: one warp per (batch, query, head), lanes over the head dim D (for
// D = 32 one channel per lane; larger D loops in chunks of 32). For each
// (level, point) every lane reads the same location and attention weight
// (a broadcast load), takes the floor corners, skips the corners outside the
// map (zero padding) and reads each corner's D contiguous values from
// value [B, S, H, D]: at bf16 one coalesced 64-byte load per corner. The sum
// is kept in float32 and written once, with no atomics, so the result is
// deterministic.
//
// Bound: memory. Each (query, head) reads L*P*4 corner rows of D values and
// does ~10 flops per value, far below the card's operations-per-byte ratio.
// The value tensor of one call (6.5 MB at the 608x1008 bucket in bf16) stays
// in the 50 MB L2, so the corner reads are L2 gather traffic; device memory
// sees the sampling locations, attention weights and output once.
//
// Rounding matches the JAX kernel: in bf16 the bilinear weights of the
// contracted axis (x, or y on levels where the JAX kernel flips its
// orientation) are rounded to bf16 before they multiply the values
// (msda_pallas.py:136); the other axis's weight times the attention weight
// stays float32. The pixel coordinate loc*size - 0.5 is rounded twice, as in
// JAX, not fused into one multiply-add.
//
// A call may sum a subset of the levels (a windowed call sums its exact
// levels here and its banded ones in msda_fwd_win.cu): the level table names
// each level's index into the location and weight tensors. With out_f32 the
// float32 sum is written as it is, for the caller to add to the other parts
// before the one cast to the value dtype.
//
// C interface for ctypes: msda_fwd(...) launches on the given stream and
// returns cudaGetLastError() as an int (0 = launched).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define MSDA_MAX_LEVELS 8

struct Levels {
  int h[MSDA_MAX_LEVELS];
  int w[MSDA_MAX_LEVELS];
  int start[MSDA_MAX_LEVELS];
  int round_y[MSDA_MAX_LEVELS];  // 1: round the y weights (JAX orient "y")
  int lid[MSDA_MAX_LEVELS];      // index into the L axis of loc and aw
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// A bilinear weight as the JAX kernel feeds it to stage 1: rounded to T.
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_float(from_float<T>(v));
}

__device__ __forceinline__ float hat(float t) {
  return fmaxf(0.0f, 1.0f - fabsf(t));
}

// n: levels in the table; L: levels of loc and aw
template <typename T, typename OutT>
__global__ void __launch_bounds__(256)
msda_fwd_kernel(const T* __restrict__ value, const float* __restrict__ loc,
                const T* __restrict__ aw, OutT* __restrict__ out, Levels lv,
                int n, int L, int Q, int S, int H, int D, int P,
                long n_warps) {
  const long warp = ((long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= n_warps) return;
  // warp = (b * Q + q) * H + h: neighbouring warps share a query, so their
  // location, weight and output rows are contiguous
  const int head = (int)(warp % H);
  const long b = warp / H / Q;
  const float* locp = loc + warp * (long)(L * P * 2);
  const T* awp = aw + warp * (long)(L * P);
  const long row = (long)H * D;  // stride between tokens in value
  const T* vb = value + b * (long)S * row + (long)head * D;
  OutT* outp = out + warp * (long)D;

  for (int d0 = 0; d0 < D; d0 += 32) {
    const int d = d0 + lane;
    const bool active = d < D;
    float acc = 0.0f;
    for (int l = 0; l < n; ++l) {
      const int hl = lv.h[l], wl = lv.w[l];
      const float fh = (float)hl, fw = (float)wl;
      const T* vl = vb + (long)lv.start[l] * row + d;
      const bool flip = lv.round_y[l] != 0;
      for (int p = 0; p < P; ++p) {
        const int i = lv.lid[l] * P + p;
        const float ix = __fsub_rn(__fmul_rn(locp[2 * i], fw), 0.5f);
        const float iy = __fsub_rn(__fmul_rn(locp[2 * i + 1], fh), 0.5f);
        const float a = to_float(awp[i]);
        const float fx0 = floorf(ix), fy0 = floorf(iy);
        const float fx1 = fx0 + 1.0f, fy1 = fy0 + 1.0f;
        float wx0 = hat(ix - fx0), wx1 = hat(ix - fx1);
        float wy0 = hat(iy - fy0), wy1 = hat(iy - fy1);
        if (flip) {
          wy0 = round_to<T>(wy0);
          wy1 = round_to<T>(wy1);
        } else {
          wx0 = round_to<T>(wx0);
          wx1 = round_to<T>(wx1);
        }
        // zero padding: a corner outside the map reads nothing
        const bool okx0 = fx0 >= 0.0f && fx0 <= fw - 1.0f;
        const bool okx1 = fx1 >= 0.0f && fx1 <= fw - 1.0f;
        const bool oky0 = fy0 >= 0.0f && fy0 <= fh - 1.0f;
        const bool oky1 = fy1 >= 0.0f && fy1 <= fh - 1.0f;
        if (!((okx0 || okx1) && (oky0 || oky1)) || !active) continue;
        const int x0 = (int)fx0, y0 = (int)fy0;
        float v00 = 0.0f, v01 = 0.0f, v10 = 0.0f, v11 = 0.0f;
        if (oky0) {
          const T* r = vl + (long)y0 * wl * row;
          if (okx0) v00 = to_float(r[(long)x0 * row]);
          if (okx1) v01 = to_float(r[(long)(x0 + 1) * row]);
        }
        if (oky1) {
          const T* r = vl + (long)(y0 + 1) * wl * row;
          if (okx0) v10 = to_float(r[(long)x0 * row]);
          if (okx1) v11 = to_float(r[(long)(x0 + 1) * row]);
        }
        float t0, t1, c0, c1;
        if (flip) {  // contract y, then weight each column by hat_x * aw
          t0 = wy0 * v00 + wy1 * v10;
          t1 = wy0 * v01 + wy1 * v11;
          c0 = __fmul_rn(wx0, a);
          c1 = __fmul_rn(wx1, a);
        } else {  // contract x, then weight each row by hat_y * aw
          t0 = wx0 * v00 + wx1 * v01;
          t1 = wx0 * v10 + wx1 * v11;
          c0 = __fmul_rn(wy0, a);
          c1 = __fmul_rn(wy1, a);
        }
        acc += t0 * c0 + t1 * c1;
      }
    }
    if (active) outp[d] = from_float<OutT>(acc);
  }
}

extern "C" int msda_fwd(const void* value, const void* loc, const void* aw,
                        void* out, const int* levels, int n, int L, int B,
                        int S, int Q, int H, int D, int P, int is_bf16,
                        int out_f32, void* stream) {
  if (n < 1 || n > MSDA_MAX_LEVELS) return (int)cudaErrorInvalidValue;
  Levels lv;
  for (int l = 0; l < n; ++l) {
    lv.h[l] = levels[5 * l];
    lv.w[l] = levels[5 * l + 1];
    lv.start[l] = levels[5 * l + 2];
    lv.round_y[l] = levels[5 * l + 3];
    lv.lid[l] = levels[5 * l + 4];
    if (lv.lid[l] < 0 || lv.lid[l] >= L) return (int)cudaErrorInvalidValue;
  }
  const long n_warps = (long)B * Q * H;
  if (n_warps == 0) return (int)cudaSuccess;
  const int threads = 256;
  const unsigned blocks = (unsigned)((n_warps * 32 + threads - 1) / threads);
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16 && out_f32) {
    msda_fwd_kernel<__nv_bfloat16, float><<<blocks, threads, 0, s>>>(
        (const __nv_bfloat16*)value, (const float*)loc,
        (const __nv_bfloat16*)aw, (float*)out, lv, n, L, Q, S, H, D, P,
        n_warps);
  } else if (is_bf16) {
    msda_fwd_kernel<__nv_bfloat16, __nv_bfloat16><<<blocks, threads, 0, s>>>(
        (const __nv_bfloat16*)value, (const float*)loc,
        (const __nv_bfloat16*)aw, (__nv_bfloat16*)out, lv, n, L, Q, S, H, D,
        P, n_warps);
  } else {
    msda_fwd_kernel<float, float><<<blocks, threads, 0, s>>>(
        (const float*)value, (const float*)loc, (const float*)aw,
        (float*)out, lv, n, L, Q, S, H, D, P, n_warps);
  }
  return (int)cudaGetLastError();
}

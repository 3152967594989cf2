// Multi-scale deformable attention forward with an int8 stage 1, for Hopper
// (sm_90a).
//
// Replaces the int8 branch of egtr_tpu/ops/msda_pallas.py:_fwd_body (the
// Pallas TPU kernel K4, reached through msda_pallas_q and, on the exact
// levels of a windowed call, msda_pallas_win_q). There the values are
// quantized to int8 per (batch, head, level), the contracted axis's dense hat
// vector to 7 bits, and stage 1 is an int8 matrix product with an int32
// accumulator. Here the hat has two nonzeros, so stage 1 is two integer
// multiply-adds per channel on the corners the kernel reads directly:
//
//   t_j   = vq[y_j, x_0] * round(127 * hat_x0) + vq[y_j, x_1] * round(127 * hat_x1)
//   out  += float(t_0) * (hat_y0 * a) + float(t_1) * (hat_y1 * a)
//   a     = aw * scale,   scale = max|v| / (127 * 127) per (batch, head, level)
//
// (x and y swap on a level where the JAX kernel contracts y: round_y.) The
// integer stage is bit-identical to the TPU kernel's; the float32 fold
// differs from it in the order of summation only. __float2int_rn rounds half
// to even, as jnp.round does. The quantization itself (max, scale, round to
// int8) is tensor code outside the kernel, as it is outside the Pallas body
// in the JAX package (msda.quantize_levels).
//
// Design: as msda_fwd.cu. One warp per (batch, query, head), lanes over the
// head dim D (one int8 channel per lane at D = 32: a 32-byte row per corner),
// every lane reading the same location and weight; float32 accumulation, one
// float32 store per channel, no atomics, deterministic. The output is always
// float32 [B, Q, H, D]: the caller adds the parts of a windowed call and
// casts once.
//
// Bound: memory. The int8 values halve the bytes of the bf16 call's value
// tensor; the locations (float32) dominate either way. Packing four channels
// per lane (__dp4a) and staging are left for a later change.
//
// C interface for ctypes: msda_fwd_q(...) launches on the given stream and
// returns cudaGetLastError() as an int (0 = launched).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define MSDA_MAX_LEVELS 8

struct Levels {
  int h[MSDA_MAX_LEVELS];
  int w[MSDA_MAX_LEVELS];
  int start[MSDA_MAX_LEVELS];
  int round_y[MSDA_MAX_LEVELS];  // 1: quantize the y hats (JAX orient "y")
  int lid[MSDA_MAX_LEVELS];      // index into the L axis of loc, aw, scale
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ float hat(float t) {
  return fmaxf(0.0f, 1.0f - fabsf(t));
}

// round(127 * hat), half to even
__device__ __forceinline__ int quant_hat(float v) {
  return __float2int_rn(__fmul_rn(v, 127.0f));
}

// n: levels in the table; L: levels of loc, aw and scale. A: dtype of aw.
template <typename A>
__global__ void __launch_bounds__(256)
msda_fwd_q_kernel(const int8_t* __restrict__ vq,
                  const float* __restrict__ scale,
                  const float* __restrict__ loc, const A* __restrict__ aw,
                  float* __restrict__ out, Levels lv, int n, int L, int Q,
                  int S, int H, int D, int P, long n_warps) {
  const long warp = ((long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= n_warps) return;
  // warp = (b * Q + q) * H + h
  const int head = (int)(warp % H);
  const long b = warp / H / Q;
  const float* locp = loc + warp * (long)(L * P * 2);
  const A* awp = aw + warp * (long)(L * P);
  const float* scalep = scale + (b * H + head) * (long)L;
  const long row = (long)H * D;  // stride between tokens in vq
  const int8_t* vb = vq + b * (long)S * row + (long)head * D;
  float* outp = out + warp * (long)D;

  for (int d0 = 0; d0 < D; d0 += 32) {
    const int d = d0 + lane;
    const bool active = d < D;
    float acc = 0.0f;
    for (int l = 0; l < n; ++l) {
      const int hl = lv.h[l], wl = lv.w[l];
      const float fh = (float)hl, fw = (float)wl;
      const int8_t* vl = vb + (long)lv.start[l] * row + d;
      const bool flip = lv.round_y[l] != 0;
      const float sc = scalep[lv.lid[l]];
      for (int p = 0; p < P; ++p) {
        const int i = lv.lid[l] * P + p;
        const float ix = __fsub_rn(__fmul_rn(locp[2 * i], fw), 0.5f);
        const float iy = __fsub_rn(__fmul_rn(locp[2 * i + 1], fh), 0.5f);
        const float a = __fmul_rn(to_float(awp[i]), sc);
        const float fx0 = floorf(ix), fy0 = floorf(iy);
        const float fx1 = fx0 + 1.0f, fy1 = fy0 + 1.0f;
        const float wx0 = hat(ix - fx0), wx1 = hat(ix - fx1);
        const float wy0 = hat(iy - fy0), wy1 = hat(iy - fy1);
        // zero padding: a corner outside the map reads nothing
        const bool okx0 = fx0 >= 0.0f && fx0 <= fw - 1.0f;
        const bool okx1 = fx1 >= 0.0f && fx1 <= fw - 1.0f;
        const bool oky0 = fy0 >= 0.0f && fy0 <= fh - 1.0f;
        const bool oky1 = fy1 >= 0.0f && fy1 <= fh - 1.0f;
        if (!((okx0 || okx1) && (oky0 || oky1)) || !active) continue;
        const int x0 = (int)fx0, y0 = (int)fy0;
        int v00 = 0, v01 = 0, v10 = 0, v11 = 0;
        if (oky0) {
          const int8_t* r = vl + (long)y0 * wl * row;
          if (okx0) v00 = r[(long)x0 * row];
          if (okx1) v01 = r[(long)(x0 + 1) * row];
        }
        if (oky1) {
          const int8_t* r = vl + (long)(y0 + 1) * wl * row;
          if (okx0) v10 = r[(long)x0 * row];
          if (okx1) v11 = r[(long)(x0 + 1) * row];
        }
        int t0, t1;
        float c0, c1;
        if (flip) {  // contract y in integers, weight columns by hat_x * a
          const int q0 = quant_hat(wy0), q1 = quant_hat(wy1);
          t0 = q0 * v00 + q1 * v10;
          t1 = q0 * v01 + q1 * v11;
          c0 = __fmul_rn(wx0, a);
          c1 = __fmul_rn(wx1, a);
        } else {  // contract x in integers, weight rows by hat_y * a
          const int q0 = quant_hat(wx0), q1 = quant_hat(wx1);
          t0 = q0 * v00 + q1 * v01;
          t1 = q0 * v10 + q1 * v11;
          c0 = __fmul_rn(wy0, a);
          c1 = __fmul_rn(wy1, a);
        }
        acc += (float)t0 * c0 + (float)t1 * c1;
      }
    }
    if (active) outp[d] = acc;
  }
}

extern "C" int msda_fwd_q(const void* vq, const void* scale, const void* loc,
                          const void* aw, void* out, const int* levels, int n,
                          int L, int B, int S, int Q, int H, int D, int P,
                          int aw_bf16, void* stream) {
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
  if (aw_bf16) {
    msda_fwd_q_kernel<__nv_bfloat16><<<blocks, threads, 0, s>>>(
        (const int8_t*)vq, (const float*)scale, (const float*)loc,
        (const __nv_bfloat16*)aw, (float*)out, lv, n, L, Q, S, H, D, P,
        n_warps);
  } else {
    msda_fwd_q_kernel<float><<<blocks, threads, 0, s>>>(
        (const int8_t*)vq, (const float*)scale, (const float*)loc,
        (const float*)aw, (float*)out, lv, n, L, Q, S, H, D, P, n_warps);
  }
  return (int)cudaGetLastError();
}

// Multi-scale deformable attention forward with all sampling points of a
// level in one stage, for Hopper (sm_90a).
//
// Replaces egtr_tpu/ops/msda_pallas.py:_fwd_kernel_bp / _fwd_body_bp (the
// Pallas TPU kernel K11, launched by _level_pallas_fwd when
// EGTR_MSDA_BATCH_P=1, in a float and an int8 form). It computes exactly the
// function of K1 (msda_fwd.cu) and, in its int8 form, of K4 (msda_fwd_q.cu).
// What differs on the TPU is the order of the work: the rows of all P points
// of a query tile are packed side by side, stage 1 is one matrix product over
// all of them, and the point axis is folded together with y at the end
// (acc.sum(axis=(0, 2))).
//
// On this card the same idea is to put the points side by side across the
// lanes of a warp. K1 gives a warp one (batch, query, head) and walks its
// L*P samples one after another, each a broadcast load of the location and
// then four dependent corner gathers. Here the warp is the same, but its 32
// lanes split over (point, channel group): with LPP = 32 / P lanes per point,
// lane l takes point l / LPP and the channel group l % LPP, four consecutive
// channels read with one vector load per corner (16 bytes of float32, 8 of
// bfloat16, 4 of int8). For P = 4 and D = 32 that is 8 lanes per point, one
// group each, and the 16 corner loads of the four points of a level are in
// flight at once. A wider head dim loops over chunks of LPP groups; a
// narrower one leaves lanes idle.
//
// Fold: each lane sums its point over all levels in float32; the points are
// folded once at the end with __shfl_xor_sync over the lane offsets LPP,
// 2*LPP, ..., 16, always in that order, so the result is deterministic and
// needs no atomics. It differs from K1's sequential sum in the order of
// summation only.
//
// Rounding is K1's: in bfloat16 the contracted axis's hats (x, or y on a
// level where the JAX kernel flips its orientation: round_y) are rounded to
// bfloat16 before they multiply the values; the other axis's hat times the
// attention weight stays float32 (__fmul_rn); the pixel coordinate
// loc * size - 0.5 is rounded twice, not fused. The int8 form is K4's: int8
// corners times round(127 * hat) (half to even) summed in integers, then
// weighted in float32 by the other hat times aw * scale, where scale is the
// per (batch, head, level) value scale / 127^2 that the caller made.
//
// Bound: memory, as K1 (the same bytes and operations; the value tensor of a
// call stays in the 50 MB L2, so the corner reads are L2 gather traffic).
//
// A call may sum a subset of the levels (the exact levels of a windowed
// call): the level table names each level's index into the location and
// weight tensors, as in msda_fwd.cu. With out_f32 the float32 sum is written
// as it is; the int8 form always writes float32.
//
// Requirements, checked by the wrapper (msda_cuda.msda_fwd_bp): P divides 32,
// D is a multiple of 4, and the value pointer is aligned for a four-channel
// vector load.
//
// C interface for ctypes: msda_fwd_bp(...) and msda_fwd_bp_q(...) launch on
// the given stream and return cudaGetLastError() as an int (0 = launched).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define MSDA_MAX_LEVELS 8

struct Levels {
  int h[MSDA_MAX_LEVELS];
  int w[MSDA_MAX_LEVELS];
  int start[MSDA_MAX_LEVELS];
  int round_y[MSDA_MAX_LEVELS];  // 1: the y hats are the contracted ones
  int lid[MSDA_MAX_LEVELS];      // index into the L axis of loc, aw, scale
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

__device__ __forceinline__ float hat(float t) {
  return fmaxf(0.0f, 1.0f - fabsf(t));
}

// Four consecutive channels of one corner, as float32.
__device__ __forceinline__ void load4(const float* p, float v[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float v[4]) {
  const uint2 q = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.y));
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}
__device__ __forceinline__ void load4(const int8_t* p, float v[4]) {
  const char4 q = *reinterpret_cast<const char4*>(p);
  v[0] = (float)q.x; v[1] = (float)q.y; v[2] = (float)q.z; v[3] = (float)q.w;
}

// The contracted axis's hat as stage 1 takes it: as it is in float32,
// rounded to bfloat16, or as round(127 * hat) (half to even) for int8
// values. An int8 corner times a quantized hat, and the sum of two such
// products, are integers below 2 * 127 * 127: float32 holds them exactly, so
// the float arithmetic below is the integer stage 1 of K4.
__device__ __forceinline__ float stage1_hat(float v, float) { return v; }
__device__ __forceinline__ float stage1_hat(float v, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
__device__ __forceinline__ float stage1_hat(float v, int8_t) {
  return (float)__float2int_rn(__fmul_rn(v, 127.0f));
}

// V: value type (float, bfloat16, int8); A: attention weight type; OutT:
// output type. scale is null unless V is int8. n: levels in the table; L:
// levels of loc, aw and scale. LPP = 32 / P lanes per point.
template <typename V, typename A, typename OutT>
__global__ void __launch_bounds__(256)
msda_fwd_bp_kernel(const V* __restrict__ value,
                   const float* __restrict__ scale,
                   const float* __restrict__ loc, const A* __restrict__ aw,
                   OutT* __restrict__ out, Levels lv, int n, int L, int Q,
                   int S, int H, int D, int P, int LPP, long n_warps) {
  const long warp = ((long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= n_warps) return;  // a whole warp leaves together
  // warp = (b * Q + q) * H + h, as in msda_fwd.cu
  const int head = (int)(warp % H);
  const long b = warp / H / Q;
  const int p = lane / LPP;     // this lane's sampling point
  const int sub = lane % LPP;   // its channel group within the chunk
  const int G = D / 4;          // channel groups of four
  const float* locp = loc + warp * (long)(L * P * 2);
  const A* awp = aw + warp * (long)(L * P);
  const long row = (long)H * D;  // stride between tokens in value
  const V* vb = value + b * (long)S * row + (long)head * D;
  OutT* outp = out + warp * (long)D;
  const V kind = V();

  for (int g0 = 0; g0 < G; g0 += LPP) {
    const int g = g0 + sub;
    const bool active = g < G;
    const int d = 4 * g;
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int l = 0; l < n && active; ++l) {
      const int hl = lv.h[l], wl = lv.w[l];
      const float fh = (float)hl, fw = (float)wl;
      const bool flip = lv.round_y[l] != 0;
      const int i = lv.lid[l] * P + p;
      const float ix = __fsub_rn(__fmul_rn(locp[2 * i], fw), 0.5f);
      const float iy = __fsub_rn(__fmul_rn(locp[2 * i + 1], fh), 0.5f);
      float a = to_float(awp[i]);
      if (scale != nullptr) {
        a = __fmul_rn(a, scale[(b * H + head) * (long)L + lv.lid[l]]);
      }
      const float fx0 = floorf(ix), fy0 = floorf(iy);
      const float fx1 = fx0 + 1.0f, fy1 = fy0 + 1.0f;
      float wx0 = hat(ix - fx0), wx1 = hat(ix - fx1);
      float wy0 = hat(iy - fy0), wy1 = hat(iy - fy1);
      if (flip) {
        wy0 = stage1_hat(wy0, kind);
        wy1 = stage1_hat(wy1, kind);
      } else {
        wx0 = stage1_hat(wx0, kind);
        wx1 = stage1_hat(wx1, kind);
      }
      // zero padding: a corner outside the map reads nothing
      const bool okx0 = fx0 >= 0.0f && fx0 <= fw - 1.0f;
      const bool okx1 = fx1 >= 0.0f && fx1 <= fw - 1.0f;
      const bool oky0 = fy0 >= 0.0f && fy0 <= fh - 1.0f;
      const bool oky1 = fy1 >= 0.0f && fy1 <= fh - 1.0f;
      if (!((okx0 || okx1) && (oky0 || oky1))) continue;
      const int x0 = (int)fx0, y0 = (int)fy0;
      const V* vl = vb + (long)lv.start[l] * row + d;
      float v00[4] = {0.0f, 0.0f, 0.0f, 0.0f}, v01[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      float v10[4] = {0.0f, 0.0f, 0.0f, 0.0f}, v11[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (oky0) {
        const V* r = vl + (long)y0 * wl * row;
        if (okx0) load4(r + (long)x0 * row, v00);
        if (okx1) load4(r + (long)(x0 + 1) * row, v01);
      }
      if (oky1) {
        const V* r = vl + (long)(y0 + 1) * wl * row;
        if (okx0) load4(r + (long)x0 * row, v10);
        if (okx1) load4(r + (long)(x0 + 1) * row, v11);
      }
      float c0, c1;
      if (flip) {  // contract y, then weight each column by hat_x * aw
        c0 = __fmul_rn(wx0, a);
        c1 = __fmul_rn(wx1, a);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float t0 = wy0 * v00[c] + wy1 * v10[c];
          const float t1 = wy0 * v01[c] + wy1 * v11[c];
          acc[c] += t0 * c0 + t1 * c1;
        }
      } else {  // contract x, then weight each row by hat_y * aw
        c0 = __fmul_rn(wy0, a);
        c1 = __fmul_rn(wy1, a);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float t0 = wx0 * v00[c] + wx1 * v01[c];
          const float t1 = wx0 * v10[c] + wx1 * v11[c];
          acc[c] += t0 * c0 + t1 * c1;
        }
      }
    }
    // fold the points: lanes l and l ^ off hold the same channel group of
    // two points; every lane takes part, the fixed order keeps it
    // deterministic
    for (int off = LPP; off < 32; off <<= 1) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        acc[c] += __shfl_xor_sync(0xffffffffu, acc[c], off);
      }
    }
    if (p == 0 && active) {
#pragma unroll
      for (int c = 0; c < 4; ++c) outp[d + c] = from_float<OutT>(acc[c]);
    }
  }
}

static int read_levels(const int* levels, int n, int L, Levels* lv) {
  if (n < 1 || n > MSDA_MAX_LEVELS) return 0;
  for (int l = 0; l < n; ++l) {
    lv->h[l] = levels[5 * l];
    lv->w[l] = levels[5 * l + 1];
    lv->start[l] = levels[5 * l + 2];
    lv->round_y[l] = levels[5 * l + 3];
    lv->lid[l] = levels[5 * l + 4];
    if (lv->lid[l] < 0 || lv->lid[l] >= L) return 0;
  }
  return 1;
}

static int launch_shape(int P, int D, long n_warps, unsigned* blocks) {
  if (P < 1 || P > 32 || 32 % P != 0 || D < 4 || D % 4 != 0) return 0;
  const int threads = 256;
  *blocks = (unsigned)((n_warps * 32 + threads - 1) / threads);
  return 1;
}

extern "C" int msda_fwd_bp(const void* value, const void* loc, const void* aw,
                           void* out, const int* levels, int n, int L, int B,
                           int S, int Q, int H, int D, int P, int is_bf16,
                           int out_f32, void* stream) {
  Levels lv;
  unsigned blocks = 0;
  const long n_warps = (long)B * Q * H;
  if (!read_levels(levels, n, L, &lv) || !launch_shape(P, D, n_warps, &blocks))
    return (int)cudaErrorInvalidValue;
  if (n_warps == 0) return (int)cudaSuccess;
  const int LPP = 32 / P;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16 && out_f32) {
    msda_fwd_bp_kernel<__nv_bfloat16, __nv_bfloat16, float>
        <<<blocks, 256, 0, s>>>((const __nv_bfloat16*)value, nullptr,
                                (const float*)loc, (const __nv_bfloat16*)aw,
                                (float*)out, lv, n, L, Q, S, H, D, P, LPP,
                                n_warps);
  } else if (is_bf16) {
    msda_fwd_bp_kernel<__nv_bfloat16, __nv_bfloat16, __nv_bfloat16>
        <<<blocks, 256, 0, s>>>((const __nv_bfloat16*)value, nullptr,
                                (const float*)loc, (const __nv_bfloat16*)aw,
                                (__nv_bfloat16*)out, lv, n, L, Q, S, H, D, P,
                                LPP, n_warps);
  } else {
    msda_fwd_bp_kernel<float, float, float><<<blocks, 256, 0, s>>>(
        (const float*)value, nullptr, (const float*)loc, (const float*)aw,
        (float*)out, lv, n, L, Q, S, H, D, P, LPP, n_warps);
  }
  return (int)cudaGetLastError();
}

extern "C" int msda_fwd_bp_q(const void* vq, const void* scale,
                             const void* loc, const void* aw, void* out,
                             const int* levels, int n, int L, int B, int S,
                             int Q, int H, int D, int P, int aw_bf16,
                             void* stream) {
  Levels lv;
  unsigned blocks = 0;
  const long n_warps = (long)B * Q * H;
  if (!read_levels(levels, n, L, &lv) || !launch_shape(P, D, n_warps, &blocks)
      || scale == nullptr)
    return (int)cudaErrorInvalidValue;
  if (n_warps == 0) return (int)cudaSuccess;
  const int LPP = 32 / P;
  cudaStream_t s = (cudaStream_t)stream;
  if (aw_bf16) {
    msda_fwd_bp_kernel<int8_t, __nv_bfloat16, float><<<blocks, 256, 0, s>>>(
        (const int8_t*)vq, (const float*)scale, (const float*)loc,
        (const __nv_bfloat16*)aw, (float*)out, lv, n, L, Q, S, H, D, P, LPP,
        n_warps);
  } else {
    msda_fwd_bp_kernel<int8_t, float, float><<<blocks, 256, 0, s>>>(
        (const int8_t*)vq, (const float*)scale, (const float*)loc,
        (const float*)aw, (float*)out, lv, n, L, Q, S, H, D, P, LPP, n_warps);
  }
  return (int)cudaGetLastError();
}

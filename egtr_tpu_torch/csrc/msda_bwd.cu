// Exact multi-scale deformable attention backward for Hopper (sm_90a).
//
// Two kernels replace the two Pallas TPU kernels that
// egtr_tpu/ops/msda_pallas.py:_level_pallas_bwd launches once per level:
//
//   msda_bwd_rows   replaces _bwd_rows_kernel / _bwd_rows_body (K2): the
//                   gradients of the sampling locations and the attention
//                   weights;
//   msda_bwd_value  replaces _bwd_dvtt_kernel / _bwd_dvtt_body (K3): the
//                   gradient of the values.
//
// The TPU kernels build dense separable "hat" vectors and contract them on
// the MXU, and K3 carries its sum over query tiles in one output block
// because the TPU grid runs in order. This card gathers fast and runs its
// blocks in no order, so both kernels read (or add to) the two-by-two
// bilinear corners directly, one launch covers all levels, and K3's sum over
// queries is a float32 atomicAdd into a buffer the wrapper zeroes.
//
// Both take a table of the levels to differentiate (the exact levels of a
// windowed call, whose banded levels msda_bwd_win.cu takes; all levels
// otherwise). The rows kernel writes only those levels' entries of dloc and
// daw, so the wrapper zeroes the outputs when the table is a subset.
//
// Design (both): one warp per (batch, query, head), lanes over the head dim
// D (one channel per lane for D = 32, chunks of 32 above). Every lane reads
// the same location and weight (a broadcast load) and its own channel of the
// output gradient g and of each corner row: at bf16 one coalesced 64-byte
// access per corner.
//
//   rows:  per (level, point) the three sums over the corners and channels
//          are reduced across the warp with shuffles; lane 0 writes them. No
//          atomics: deterministic.
//   value: per (level, point) each lane adds its channel of the four corner
//          contributions with atomicAdd (red.global.add.f32, 32 neighbouring
//          floats per corner). The order of the additions changes from run to
//          run, so the last bits of the result do too.
//
// Bound: memory. rows reads 4 corner rows per sample and does ~25 flops per
// value read; value makes 4 atomic row updates per sample. The value tensor
// and its float32 gradient (11.4 MB and 22.9 MB per image at the 800x1344
// bucket in bf16) fit the 50 MB L2 one image at a time, so most of the
// traffic is L2 gathers and L2 atomics; device memory sees the inputs once
// and the gradient buffer twice (zeroing, final cast).
//
// What matches the JAX kernels (cdt = the value dtype, all sums float32):
//   dT_j   = cdt(hat_y_j * aw * g)      rounded per (corner row, channel)
//   dix    = sum_i hat'(ix - x_i) * sum_{j,d} V_ji * dT_j
//   T_j    = sum_i V_ji * cdt(hat_x_i)
//   daw    = sum_{j,d} hat_y_j * T_j * g
//   diy    = sum_{j,d} aw * hat'(iy - y_j) * T_j * g
//   dV_ji += dT_j * cdt(hat_x_i)
// The backward always rounds the x hats, also on levels where the forward
// rounds the y hats: the JAX backward never flips its orientation
// (msda_pallas.py:957-962, 1101-1103). hat'(t) = -sign(t) for |t| < 1, else
// 0, and 0 at t = 0 (msda_pallas.py:472, 482). A corner outside the map
// contributes nothing. dloc is chained through ix = x*w - 0.5 (:1120).
//
// C interface for ctypes: each function launches on the given stream and
// returns cudaGetLastError() as an int (0 = launched).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define MSDA_MAX_LEVELS 8

// the levels differentiated, and each one's index into the L axis
struct Levels {
  int n;
  int h[MSDA_MAX_LEVELS];
  int w[MSDA_MAX_LEVELS];
  int start[MSDA_MAX_LEVELS];
  int lid[MSDA_MAX_LEVELS];
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

// A float32 product as the JAX kernels feed it to the MXU: rounded to T.
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_float(from_float<T>(v));
}

__device__ __forceinline__ float hat(float t) {
  return fmaxf(0.0f, 1.0f - fabsf(t));
}

// d hat / dt: -sign(t) inside the support, 0 outside and at the kink t = 0
__device__ __forceinline__ float hat_grad(float t) {
  if (!(fabsf(t) < 1.0f) || t == 0.0f) return 0.0f;
  return t > 0.0f ? -1.0f : 1.0f;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// One sample's geometry, the same for every lane of the warp.
struct Sample {
  float zx0, zx1, zy0, zy1;  // ix - x0, ix - x1, iy - y0, iy - y1
  int x0, y0;
  bool okx0, okx1, oky0, oky1;
  bool any;  // some corner lies in the map
};

__device__ __forceinline__ Sample make_sample(float lx, float ly, int hl,
                                              int wl) {
  Sample s;
  const float fh = (float)hl, fw = (float)wl;
  // loc*size - 0.5 is rounded twice, as in JAX, not fused
  const float ix = __fsub_rn(__fmul_rn(lx, fw), 0.5f);
  const float iy = __fsub_rn(__fmul_rn(ly, fh), 0.5f);
  const float fx0 = floorf(ix), fy0 = floorf(iy);
  const float fx1 = fx0 + 1.0f, fy1 = fy0 + 1.0f;
  s.zx0 = ix - fx0;
  s.zx1 = ix - fx1;
  s.zy0 = iy - fy0;
  s.zy1 = iy - fy1;
  s.okx0 = fx0 >= 0.0f && fx0 <= fw - 1.0f;
  s.okx1 = fx1 >= 0.0f && fx1 <= fw - 1.0f;
  s.oky0 = fy0 >= 0.0f && fy0 <= fh - 1.0f;
  s.oky1 = fy1 >= 0.0f && fy1 <= fh - 1.0f;
  s.any = (s.okx0 || s.okx1) && (s.oky0 || s.oky1);
  // only read where the corner is in the map, so the cast cannot overflow
  s.x0 = s.any ? (int)fx0 : 0;
  s.y0 = s.any ? (int)fy0 : 0;
  return s;
}

template <typename T>
__global__ void __launch_bounds__(256)
msda_bwd_rows_kernel(const T* __restrict__ value,
                     const float* __restrict__ loc, const T* __restrict__ aw,
                     const T* __restrict__ g, float* __restrict__ dloc,
                     T* __restrict__ daw, Levels lv, int L, int Q, int S,
                     int H, int D, int P, long n_warps) {
  const long warp = ((long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= n_warps) return;  // whole warps leave together
  // warp = (b * Q + q) * H + head
  const int head = (int)(warp % H);
  const long b = warp / H / Q;
  const float* locp = loc + warp * (long)(L * P * 2);
  const T* awp = aw + warp * (long)(L * P);
  const T* gp = g + warp * (long)D;
  float* dlocp = dloc + warp * (long)(L * P * 2);
  T* dawp = daw + warp * (long)(L * P);
  const long row = (long)H * D;  // stride between tokens in value
  const T* vb = value + b * (long)S * row + (long)head * D;

  for (int k = 0; k < lv.n; ++k) {
    const int hl = lv.h[k], wl = lv.w[k];
    const T* vl = vb + (long)lv.start[k] * row;
    for (int p = 0; p < P; ++p) {
      const int i = lv.lid[k] * P + p;
      const Sample s = make_sample(locp[2 * i], locp[2 * i + 1], hl, wl);
      const float a = to_float(awp[i]);
      float s_dix = 0.0f, s_diy = 0.0f, s_daw = 0.0f;
      if (s.any) {  // the same for the whole warp
        const float hx0 = round_to<T>(hat(s.zx0));
        const float hx1 = round_to<T>(hat(s.zx1));
        const float hy0 = hat(s.zy0), hy1 = hat(s.zy1);
        const float ghx0 = hat_grad(s.zx0), ghx1 = hat_grad(s.zx1);
        const float ghy0 = hat_grad(s.zy0), ghy1 = hat_grad(s.zy1);
        const float c0 = __fmul_rn(hy0, a), c1 = __fmul_rn(hy1, a);
        const float e0 = __fmul_rn(a, ghy0), e1 = __fmul_rn(a, ghy1);
        for (int d = lane; d < D; d += 32) {
          const float gd = to_float(gp[d]);
          float v00 = 0.0f, v01 = 0.0f, v10 = 0.0f, v11 = 0.0f;
          if (s.oky0) {
            const T* r = vl + (long)s.y0 * wl * row + d;
            if (s.okx0) v00 = to_float(r[(long)s.x0 * row]);
            if (s.okx1) v01 = to_float(r[(long)(s.x0 + 1) * row]);
          }
          if (s.oky1) {
            const T* r = vl + (long)(s.y0 + 1) * wl * row + d;
            if (s.okx0) v10 = to_float(r[(long)s.x0 * row]);
            if (s.okx1) v11 = to_float(r[(long)(s.x0 + 1) * row]);
          }
          const float dT0 = round_to<T>(__fmul_rn(c0, gd));
          const float dT1 = round_to<T>(__fmul_rn(c1, gd));
          s_dix += (v00 * dT0 + v10 * dT1) * ghx0
                 + (v01 * dT0 + v11 * dT1) * ghx1;
          const float Tg0 = (v00 * hx0 + v01 * hx1) * gd;
          const float Tg1 = (v10 * hx0 + v11 * hx1) * gd;
          s_daw += hy0 * Tg0 + hy1 * Tg1;
          s_diy += e0 * Tg0 + e1 * Tg1;
        }
        s_dix = warp_sum(s_dix);
        s_diy = warp_sum(s_diy);
        s_daw = warp_sum(s_daw);
      }
      if (lane == 0) {
        dlocp[2 * i] = __fmul_rn(s_dix, (float)wl);
        dlocp[2 * i + 1] = __fmul_rn(s_diy, (float)hl);
        dawp[i] = from_float<T>(s_daw);
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(256)
msda_bwd_value_kernel(const float* __restrict__ loc, const T* __restrict__ aw,
                      const T* __restrict__ g, float* __restrict__ dvalue,
                      Levels lv, int L, int Q, int S, int H, int D, int P,
                      long n_warps) {
  const long warp = ((long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= n_warps) return;
  const int head = (int)(warp % H);
  const long b = warp / H / Q;
  const float* locp = loc + warp * (long)(L * P * 2);
  const T* awp = aw + warp * (long)(L * P);
  const T* gp = g + warp * (long)D;
  const long row = (long)H * D;
  float* db = dvalue + b * (long)S * row + (long)head * D;

  for (int k = 0; k < lv.n; ++k) {
    const int hl = lv.h[k], wl = lv.w[k];
    float* dl = db + (long)lv.start[k] * row;
    for (int p = 0; p < P; ++p) {
      const int i = lv.lid[k] * P + p;
      const Sample s = make_sample(locp[2 * i], locp[2 * i + 1], hl, wl);
      if (!s.any) continue;
      const float a = to_float(awp[i]);
      const float hx0 = round_to<T>(hat(s.zx0));
      const float hx1 = round_to<T>(hat(s.zx1));
      const float c0 = __fmul_rn(hat(s.zy0), a);
      const float c1 = __fmul_rn(hat(s.zy1), a);
      // a zero weight adds nothing: skip the atomics of that corner
      const bool do00 = s.oky0 && s.okx0 && c0 != 0.0f && hx0 != 0.0f;
      const bool do01 = s.oky0 && s.okx1 && c0 != 0.0f && hx1 != 0.0f;
      const bool do10 = s.oky1 && s.okx0 && c1 != 0.0f && hx0 != 0.0f;
      const bool do11 = s.oky1 && s.okx1 && c1 != 0.0f && hx1 != 0.0f;
      for (int d = lane; d < D; d += 32) {
        const float gd = to_float(gp[d]);
        const float dT0 = round_to<T>(__fmul_rn(c0, gd));
        const float dT1 = round_to<T>(__fmul_rn(c1, gd));
        float* r0 = dl + (long)s.y0 * wl * row + d;
        float* r1 = dl + (long)(s.y0 + 1) * wl * row + d;
        if (do00) atomicAdd(r0 + (long)s.x0 * row, dT0 * hx0);
        if (do01) atomicAdd(r0 + (long)(s.x0 + 1) * row, dT0 * hx1);
        if (do10) atomicAdd(r1 + (long)s.x0 * row, dT1 * hx0);
        if (do11) atomicAdd(r1 + (long)(s.x0 + 1) * row, dT1 * hx1);
      }
    }
  }
}

static bool read_levels(const int* levels, int n_levels, int L, Levels* lv) {
  if (L < 1 || L > MSDA_MAX_LEVELS || n_levels < 1 || n_levels > L)
    return false;
  lv->n = n_levels;
  for (int k = 0; k < n_levels; ++k) {
    // rows of (h, w, start token, unused, level index), as the forward's
    lv->h[k] = levels[5 * k];
    lv->w[k] = levels[5 * k + 1];
    lv->start[k] = levels[5 * k + 2];
    lv->lid[k] = levels[5 * k + 4];
    if (lv->lid[k] < 0 || lv->lid[k] >= L) return false;
  }
  return true;
}

extern "C" int msda_bwd_rows(const void* value, const void* loc,
                             const void* aw, const void* g, void* dloc,
                             void* daw, const int* levels, int n_levels,
                             int L, int B, int S, int Q, int H, int D, int P,
                             int is_bf16, void* stream) {
  Levels lv;
  if (!read_levels(levels, n_levels, L, &lv))
    return (int)cudaErrorInvalidValue;
  const long n_warps = (long)B * Q * H;
  if (n_warps == 0) return (int)cudaSuccess;
  const int threads = 256;
  const long blocks = (n_warps * 32 + threads - 1) / threads;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16) {
    msda_bwd_rows_kernel<__nv_bfloat16><<<(unsigned)blocks, threads, 0, s>>>(
        (const __nv_bfloat16*)value, (const float*)loc,
        (const __nv_bfloat16*)aw, (const __nv_bfloat16*)g, (float*)dloc,
        (__nv_bfloat16*)daw, lv, L, Q, S, H, D, P, n_warps);
  } else {
    msda_bwd_rows_kernel<float><<<(unsigned)blocks, threads, 0, s>>>(
        (const float*)value, (const float*)loc, (const float*)aw,
        (const float*)g, (float*)dloc, (float*)daw, lv, L, Q, S, H, D, P,
        n_warps);
  }
  return (int)cudaGetLastError();
}

// dvalue: float32 [B, S, H, D], zeroed by the caller.
extern "C" int msda_bwd_value(const void* loc, const void* aw, const void* g,
                              void* dvalue, const int* levels, int n_levels,
                              int L, int B, int S, int Q, int H, int D, int P,
                              int is_bf16, void* stream) {
  Levels lv;
  if (!read_levels(levels, n_levels, L, &lv))
    return (int)cudaErrorInvalidValue;
  const long n_warps = (long)B * Q * H;
  if (n_warps == 0) return (int)cudaSuccess;
  const int threads = 256;
  const long blocks = (n_warps * 32 + threads - 1) / threads;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16) {
    msda_bwd_value_kernel<__nv_bfloat16><<<(unsigned)blocks, threads, 0, s>>>(
        (const float*)loc, (const __nv_bfloat16*)aw, (const __nv_bfloat16*)g,
        (float*)dvalue, lv, L, Q, S, H, D, P, n_warps);
  } else {
    msda_bwd_value_kernel<float><<<(unsigned)blocks, threads, 0, s>>>(
        (const float*)loc, (const float*)aw, (const float*)g, (float*)dvalue,
        lv, L, Q, S, H, D, P, n_warps);
  }
  return (int)cudaGetLastError();
}

// Multi-scale deformable attention forward with all sampling points of a
// level in one stage, float32 form, for Hopper (sm_90a).
//
// Replaces the float32 form of egtr_tpu/ops/msda_pallas.py:_fwd_kernel_bp /
// _fwd_body_bp (the Pallas TPU kernel K11, launched by _level_pallas_fwd
// when EGTR_MSDA_BATCH_P=1). K11's other forms run the kernels that compute
// the same function (msda_cuda.BP_ROUTES): bfloat16 values K1's
// (msda_fwd.cu), int8 values K4's (msda_fwd_q.cu). At float32 this kernel
// measured 0.83-0.86x K1's time at the encoder calls on the H100, with the
// same bits at P = 4, D = 32 (PERF.md): K1 at float32 with this
// kernel's occupancy and loads in flight (one pass's loads at a time, 59
// registers, four blocks an SM) still took 1.14-1.15x its time.
//
// What the TPU kernel does differently is the order of the work: the rows
// of all P points of a query tile are packed side by side, stage 1 is one
// matrix product over all of them, and the point axis is folded together
// with y at the end (acc.sum(axis=(0, 2))). On this card the same idea is to
// put the points side by side across the lanes of a warp. A warp takes one
// (batch, query, head) row, and its 32 lanes split over (point, channel
// group): with LPP = 32 / P lanes per point, lane l takes point l / LPP and
// the channel group l % LPP, four consecutive channels read with one 16-byte
// load per corner. For P = 4 and D = 32 that is 8 lanes per point, one group
// each, and the four points of a level are in flight at once; the warp walks
// the levels one after another, the level the same on every lane. A wider
// head dim loops over chunks of LPP groups; a narrower one leaves lanes idle.
//
// Fold: each lane sums its point over all levels in float32; the points are
// folded once at the end with __shfl_xor_sync over the lane offsets LPP,
// 2*LPP, ..., 16, always in that order, so the result is deterministic and
// needs no atomics. Float32 stage 1 rounds no hat: one axis's hats contract
// the corners (x, or y where the level table's flag says so; the wrapper's
// float32 table never sets it), and the other axis's hat times the attention
// weight weights the result (__fmul_rn); the pixel coordinate loc * size -
// 0.5 is rounded twice, not fused, as in the JAX kernel. A corner outside the
// map reads nothing. The flag's branch stays although float32 calls never
// take it: without it (and with one 16-byte store) the kernel compiled to a
// 128-byte stack frame, the level table in local memory, and took 1.29-1.44x
// this kernel's time on the H100 (PERF.md).
//
// Bound: memory, as K1 (the same bytes and operations; the value tensor of a
// call stays in the 50 MB L2, so the corner reads are L2 gather traffic).
//
// A call may sum a subset of the levels (the exact levels of a windowed
// call): the level table names each level's index into the location and
// weight tensors, as in msda_fwd.cu.
//
// Requirements, checked by the wrapper (msda_cuda.check_inputs_bp) and again
// here: P divides 32, D is a multiple of 4, and the value pointer is aligned
// for a 16-byte load.
//
// C interface for ctypes: msda_fwd_bp(...) launches on the given stream and
// returns cudaGetLastError() as an int (0 = launched).

#include <cuda_runtime.h>
#include <stdint.h>

#define MSDA_MAX_LEVELS 8

struct Levels {
  int h[MSDA_MAX_LEVELS];
  int w[MSDA_MAX_LEVELS];
  int start[MSDA_MAX_LEVELS];
  int round_y[MSDA_MAX_LEVELS];  // 1: contract y first (the table's flag)
  int lid[MSDA_MAX_LEVELS];      // index into the L axis of loc and aw
};

__device__ __forceinline__ float hat(float t) {
  return fmaxf(0.0f, 1.0f - fabsf(t));
}

// Four consecutive channels of one corner.
__device__ __forceinline__ void load4(const float* p, float v[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}

// n: levels in the table; L: levels of loc and aw. LPP = 32 / P lanes per
// point.
__global__ void __launch_bounds__(256)
msda_fwd_bp_kernel(const float* __restrict__ value,
                   const float* __restrict__ loc, const float* __restrict__ aw,
                   float* __restrict__ out, Levels lv, int n, int L, int Q,
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
  const float* awp = aw + warp * (long)(L * P);
  const long row = (long)H * D;  // stride between tokens in value
  const float* vb = value + b * (long)S * row + (long)head * D;
  float* outp = out + warp * (long)D;

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
      const float a = awp[i];
      const float fx0 = floorf(ix), fy0 = floorf(iy);
      const float fx1 = fx0 + 1.0f, fy1 = fy0 + 1.0f;
      const float wx0 = hat(ix - fx0), wx1 = hat(ix - fx1);
      const float wy0 = hat(iy - fy0), wy1 = hat(iy - fy1);
      // zero padding: a corner outside the map reads nothing
      const bool okx0 = fx0 >= 0.0f && fx0 <= fw - 1.0f;
      const bool okx1 = fx1 >= 0.0f && fx1 <= fw - 1.0f;
      const bool oky0 = fy0 >= 0.0f && fy0 <= fh - 1.0f;
      const bool oky1 = fy1 >= 0.0f && fy1 <= fh - 1.0f;
      if (!((okx0 || okx1) && (oky0 || oky1))) continue;
      const int x0 = (int)fx0, y0 = (int)fy0;
      const float* vl = vb + (long)lv.start[l] * row + d;
      float v00[4] = {0.0f, 0.0f, 0.0f, 0.0f}, v01[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      float v10[4] = {0.0f, 0.0f, 0.0f, 0.0f}, v11[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (oky0) {
        const float* r = vl + (long)y0 * wl * row;
        if (okx0) load4(r + (long)x0 * row, v00);
        if (okx1) load4(r + (long)(x0 + 1) * row, v01);
      }
      if (oky1) {
        const float* r = vl + (long)(y0 + 1) * wl * row;
        if (okx0) load4(r + (long)x0 * row, v10);
        if (okx1) load4(r + (long)(x0 + 1) * row, v11);
      }
      float c0, c1;
      if (flip) {
        c0 = __fmul_rn(wx0, a);
        c1 = __fmul_rn(wx1, a);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float t0 = wy0 * v00[c] + wy1 * v10[c];
          const float t1 = wy0 * v01[c] + wy1 * v11[c];
          acc[c] += t0 * c0 + t1 * c1;
        }
      } else {
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
      for (int c = 0; c < 4; ++c) outp[d + c] = acc[c];
    }
  }
}

// levels: five ints a level (h, w, start token, contract y, index into the
// L axis), as msda_cuda.level_table makes them
extern "C" int msda_fwd_bp(const void* value, const void* loc, const void* aw,
                           void* out, const int* levels, int n, int L, int B,
                           int S, int Q, int H, int D, int P, void* stream) {
  if (n < 1 || n > MSDA_MAX_LEVELS || P < 1 || P > 32 || 32 % P != 0 ||
      D < 4 || D % 4 != 0 || ((uintptr_t)value & 15u) != 0)
    return (int)cudaErrorInvalidValue;
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
  msda_fwd_bp_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)value, (const float*)loc, (const float*)aw, (float*)out,
      lv, n, L, Q, S, H, D, P, 32 / P, n_warps);
  return (int)cudaGetLastError();
}

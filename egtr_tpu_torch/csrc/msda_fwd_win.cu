// Banded (windowed) multi-scale deformable attention forward for one level,
// for Hopper (sm_90a).
//
// Replaces two Pallas TPU kernels of egtr_tpu/ops/msda_pallas.py:
//   msda_fwd_win     K5  _fwd_kernel_win -> _fwd_body_hb: one band per query
//                        tile, bidx [B, H, T];
//   msda_fwd_win_pp  K6  _fwd_kernel_win_pp: one band per (sampling point,
//                        query tile), bidx [B, H, P, T];
// each in a float form (float32 / bfloat16 values) and an int8 form (the int8
// branch of those bodies: int8 values, 7-bit x hats, integer stage 1).
//
// On the TPU a band (win rows of the level, starting at bidx * win/2) is two
// half-band blocks that the index maps select, and stage 1 streams only
// win * D rows through the matrix unit instead of h * D. This card gathers:
// the kernel reads the two-by-two corners directly at row
// bidx * win/2 + y_local. It keeps the TPU kernel's reach, so both compute
// the same function: the hats are taken on the band-local coordinate, a
// corner with y_local outside [0, win) is dropped even where its absolute
// row exists, and rows at or beyond h (the last band's overhang) are zero.
//
// Inputs are the rows msda_window.window_rows makes, [B, H, P, Q_pad] float32
// with the query minor: ix, the band-local iy, and aw_eff (zero for samples
// outside the image and for the padding of each query segment; in the int8
// form it carries the value scale / 127^2). Every query segment is padded to
// a multiple of the tile TQ on its own, so the kernel maps a query q to its
// padded row through the segment table and never launches the padding.
//
// Design: one warp per (batch, head, query), the query fastest so that
// neighbouring warps read neighbouring rows; lanes over the head dim D; every
// lane reads the same row entries (broadcast loads). float32 accumulation, a
// float32 output [B, Q, H, D] that holds this level's part of the sum (the
// caller adds the levels and casts once), no atomics, deterministic.
//
// Bound: memory (the rows, 12 bytes per sample, dominate; the level's values
// are read once). A direct-corner kernel gains nothing from the band itself;
// staging a band in shared memory is left for a later change.
//
// C interface for ctypes: each function launches on the given stream and
// returns cudaGetLastError() as an int (0 = launched).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define MSDA_MAX_SEGMENTS 8

struct Segments {
  int n;
  int q0[MSDA_MAX_SEGMENTS];   // first query of the segment
  int qp0[MSDA_MAX_SEGMENTS];  // its first row in the padded layout
};

struct Geometry {
  int Q, Qp, H, D, P;
  int h, w, win, TQ, T;
  long batch_stride;  // elements between two batches of the level's values
};

__device__ __forceinline__ float hat(float t) {
  return fmaxf(0.0f, 1.0f - fabsf(t));
}

// The x hat as stage 1 takes it, and a corner value, per value type: float32
// as they are, bfloat16 with the hat rounded to bfloat16, int8 with the hat
// as round(127 * hat) (half to even). The sums are exact in float32 for int8
// (at most 2 * 127 * 127), so one float path serves all three.
__device__ __forceinline__ float stage1_hat(float v, const float*) {
  return v;
}
__device__ __forceinline__ float stage1_hat(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
__device__ __forceinline__ float stage1_hat(float v, const int8_t*) {
  return (float)__float2int_rn(__fmul_rn(v, 127.0f));
}
__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ float load(const int8_t* p) { return (float)*p; }

template <typename T, bool PER_POINT>
__global__ void __launch_bounds__(256)
msda_fwd_win_kernel(const T* __restrict__ value, const int* __restrict__ bidx,
                    const float* __restrict__ ix,
                    const float* __restrict__ iy_band,
                    const float* __restrict__ aw_eff,
                    float* __restrict__ out,
                    const __grid_constant__ Segments sg,
                    const __grid_constant__ Geometry g, long n_warps) {
  const long warp = ((long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= n_warps) return;
  // warp = (b * H + head) * Q + q
  const int q = (int)(warp % g.Q);
  const long bh = warp / g.Q;
  const int head = (int)(bh % g.H);
  const long b = bh / g.H;
  int s = 0;
  while (s + 1 < sg.n && q >= sg.q0[s + 1]) ++s;
  const int qp = sg.qp0[s] + (q - sg.q0[s]);
  const int tile = qp / g.TQ;
  const long rows = bh * g.P * (long)g.Qp + qp;  // p = 0
  const int* bp = bidx + (PER_POINT ? bh * g.P * (long)g.T : bh * (long)g.T)
                  + tile;
  const long row = (long)g.H * g.D;  // stride between tokens in value
  const T* vb = value + b * g.batch_stride + (long)head * g.D;
  float* outp = out + ((b * g.Q + q) * (long)g.H + head) * g.D;
  const float fw = (float)g.w;
  const int half = g.win / 2;

  for (int d0 = 0; d0 < g.D; d0 += 32) {
    const int d = d0 + lane;
    const bool active = d < g.D;
    float acc = 0.0f;
    for (int p = 0; p < g.P; ++p) {
      const long r = rows + p * (long)g.Qp;
      const float a = aw_eff[r];
      if (a == 0.0f || !active) continue;  // padding, or outside the image
      const float x = ix[r], y = iy_band[r];
      const int row0 = (PER_POINT ? bp[p * (long)g.T] : bp[0]) * half;
      const float fx0 = floorf(x), fy0 = floorf(y);
      const float fx1 = fx0 + 1.0f, fy1 = fy0 + 1.0f;
      const float wx0 = stage1_hat(hat(x - fx0), vb);
      const float wx1 = stage1_hat(hat(x - fx1), vb);
      const float wy0 = hat(y - fy0), wy1 = hat(y - fy1);
      const bool okx0 = fx0 >= 0.0f && fx0 <= fw - 1.0f;
      const bool okx1 = fx1 >= 0.0f && fx1 <= fw - 1.0f;
      // inside the band, and not past the level's last row
      const float ylim = fminf((float)(g.win - 1), (float)(g.h - 1 - row0));
      const bool oky0 = fy0 >= 0.0f && fy0 <= ylim;
      const bool oky1 = fy1 >= 0.0f && fy1 <= ylim;
      if (!((okx0 || okx1) && (oky0 || oky1))) continue;
      const int x0 = (int)fx0, y0 = (int)fy0;
      const T* vl = vb + d;
      float v00 = 0.0f, v01 = 0.0f, v10 = 0.0f, v11 = 0.0f;
      if (oky0) {
        const T* rp = vl + (long)(row0 + y0) * g.w * row;
        if (okx0) v00 = load(rp + (long)x0 * row);
        if (okx1) v01 = load(rp + (long)(x0 + 1) * row);
      }
      if (oky1) {
        const T* rp = vl + (long)(row0 + y0 + 1) * g.w * row;
        if (okx0) v10 = load(rp + (long)x0 * row);
        if (okx1) v11 = load(rp + (long)(x0 + 1) * row);
      }
      const float t0 = wx0 * v00 + wx1 * v01;
      const float t1 = wx0 * v10 + wx1 * v11;
      acc += t0 * __fmul_rn(wy0, a) + t1 * __fmul_rn(wy1, a);
    }
    if (active) outp[d] = acc;
  }
}

template <bool PER_POINT>
static int launch(const void* value, const void* bidx, const void* ix,
                  const void* iy_band, const void* aw_eff, void* out,
                  const int* segments, int n_segments, int B, int Q, int Qp,
                  int H, int D, int P, int h, int w, int win, int TQ,
                  long batch_stride, int vtype, void* stream) {
  if (n_segments < 1 || n_segments > MSDA_MAX_SEGMENTS || TQ < 1 ||
      Qp % TQ != 0 || win < 2 || win % 2 != 0)
    return (int)cudaErrorInvalidValue;
  Segments sg;
  sg.n = n_segments;
  for (int s = 0; s < n_segments; ++s) {
    sg.q0[s] = segments[2 * s];
    sg.qp0[s] = segments[2 * s + 1];
  }
  Geometry g = {Q, Qp, H, D, P, h, w, win, TQ, Qp / TQ, batch_stride};
  const long n_warps = (long)B * H * Q;
  if (n_warps == 0) return (int)cudaSuccess;
  const int threads = 256;
  const unsigned blocks = (unsigned)((n_warps * 32 + threads - 1) / threads);
  cudaStream_t s = (cudaStream_t)stream;
  const int* bi = (const int*)bidx;
  const float* fx = (const float*)ix;
  const float* fy = (const float*)iy_band;
  const float* fa = (const float*)aw_eff;
  float* o = (float*)out;
  if (vtype == 0) {
    msda_fwd_win_kernel<float, PER_POINT><<<blocks, threads, 0, s>>>(
        (const float*)value, bi, fx, fy, fa, o, sg, g, n_warps);
  } else if (vtype == 1) {
    msda_fwd_win_kernel<__nv_bfloat16, PER_POINT><<<blocks, threads, 0, s>>>(
        (const __nv_bfloat16*)value, bi, fx, fy, fa, o, sg, g, n_warps);
  } else if (vtype == 2) {
    msda_fwd_win_kernel<int8_t, PER_POINT><<<blocks, threads, 0, s>>>(
        (const int8_t*)value, bi, fx, fy, fa, o, sg, g, n_warps);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// vtype: 0 float32, 1 bfloat16, 2 int8 values
extern "C" int msda_fwd_win(const void* value, const void* bidx,
                            const void* ix, const void* iy_band,
                            const void* aw_eff, void* out,
                            const int* segments, int n_segments, int B, int Q,
                            int Qp, int H, int D, int P, int h, int w,
                            int win, int TQ, long batch_stride, int vtype,
                            void* stream) {
  return launch<false>(value, bidx, ix, iy_band, aw_eff, out, segments,
                       n_segments, B, Q, Qp, H, D, P, h, w, win, TQ,
                       batch_stride, vtype, stream);
}

extern "C" int msda_fwd_win_pp(const void* value, const void* bidx,
                               const void* ix, const void* iy_band,
                               const void* aw_eff, void* out,
                               const int* segments, int n_segments, int B,
                               int Q, int Qp, int H, int D, int P, int h,
                               int w, int win, int TQ, long batch_stride,
                               int vtype, void* stream) {
  return launch<true>(value, bidx, ix, iy_band, aw_eff, out, segments,
                      n_segments, B, Q, Qp, H, D, P, h, w, win, TQ,
                      batch_stride, vtype, stream);
}

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
// the kernels read the two-by-two corners directly at row
// bidx * win/2 + y_local. They keep the TPU kernel's reach (band_sample in
// msda_band.cuh), so both compute the same function: the hats are taken on
// the band-local coordinate, a corner with y_local outside [0, win) is
// dropped even where its absolute row exists, and rows at or beyond h (the
// last band's overhang) are zero.
//
// Inputs are the rows msda_window.window_rows makes, [B, H, P, Q_pad] float32
// with the query minor: ix, the band-local iy, and aw_eff (zero for samples
// outside the image and for the padding of each query segment; in the int8
// form it carries the value scale / 127^2). Every query segment is padded to
// a multiple of the tile TQ on its own, so the kernels map a query q to its
// padded row through the segment table and never visit the padding. The
// output is float32 [B, Q, H, D], this level's part of the sum (the caller
// adds the levels and casts once).
//
// Arithmetic, per sample and channel, as the TPU kernels round it:
//   t_j  = hx0 * V_j0 + hx1 * V_j1        stage 1, x hats as stage 1 takes
//                                          them: float32 as they are,
//                                          bfloat16 rounded to bfloat16,
//                                          int8 round(127 * hat) (half to
//                                          even; exact in float32)
//   out += t0 * fmul_rn(hy0, aw) + t1 * fmul_rn(hy1, aw)
//
// K6 (msda_fwd_win_pp), redesigned for this card. What bounded the layout
// it replaces (one warp per (batch, head, query), one band lookup a point):
// a warp walked its P = 4 samples in turn with lanes over D, so a sample's
// four corner loads were 2- (bfloat16) or 1-byte (int8) loads one sample at
// a time, each lane read the same row entries and searched the segment
// table itself, and every point waited on the last: 0.333 ms at the served
// encoder call's three banded levels (bfloat16, H100), 18x off its bound.
// Here msda_cuda.win_geometry (form "fwd") lays a warp's lanes over (query,
// point, channel group), K1's layout (msda_fwd.cu) through K8's lane map
// (msda_bwd_win.cu): a warp takes (batch, head) and `queries` neighbouring
// queries, a lane reads VEC
// channels of a corner with one 16-byte load where D and the value pointer
// allow it (bfloat16 8 channels, 4 lanes a sample, 2 queries x 4 points a
// pass; int8 16 channels, 2 lanes a sample; float32 4, 8 lanes), two passes'
// loads go out together, each lane maps its own query through the segment
// table (a warp's queries may straddle a segment boundary; a query past Q
// does nothing). A query's P points lie in neighbouring slots of one pass
// (fold = 1): their float32 contributions are folded over those slots with
// __shfl_xor_sync in a fixed order (two rounds for P = 4) and the point-0
// lanes store the query's channels as float32 vectors. Where P does not
// divide the samples a pass holds (fold = 0: P not a power of two, or D
// wide enough that a sample takes the whole warp), a slot takes a whole
// query and the lane walks its points in turn. Every rounding above is
// kept; the sum over a query's points is taken pairwise instead of in turn,
// which moves float32 bits within chip_smoke.TOL. No atomics:
// deterministic, bit-equal run to run. Measured on the H100 in turns with
// the layout it replaces (device time in a CUDA graph, the three banded
// levels): bfloat16 0.105 ms (0.32x), int8 0.104 (0.32x), float32 0.158
// (0.50x); bfloat16 at batch 4 0.388 (0.25x).
//
// K5 (msda_fwd_win) runs K6's kernel (msda_fwd_win_kernel). The JAX package
// computes both with the same per-point sum (_fwd_body_hb and
// _fwd_kernel_win_pp), and under one band per tile every point of a tile
// takes the same band, so K5 is K6 with a band table whose point stride is
// zero: the kernel reads the band of (b * H + head, point, tile) at
// bidx[bh * bh_stride + p * p_stride + tile], with strides P * T and T for
// K6's [B, H, P, T] table, T and 0 for K5's [B, H, T] (band_entry in
// msda_band.cuh, the form a template flag). K5 takes K6's launch and is
// bit-equal to K6 given its tile bands broadcast over the points. The
// layout it replaces (the one K6's redesign replaced, with one band lookup
// a query) ran 17x off its bound: 0.298 ms at the served encoder call's
// three banded levels (bfloat16, H100).
//
// Bound: memory. The rows (12 bytes a sample, 16 with the band index) and
// the output dominate the bytes that must move; the corner rows are mostly
// L2 hits (a band of level 0 at bfloat16 is 64 KB a head). At the served
// encoder call K6 now runs ~6x off that bound; its 1.22 M samples read 313
// MB of corner rows from L2 (bfloat16) at ~3 TB/s.
//
// C interface for ctypes: each function launches on the given stream and
// returns cudaGetLastError() as an int (0 = launched).

#include "msda_band.cuh"

// The x hat as stage 1 takes it, per value type: float32 as it is, bfloat16
// rounded to bfloat16, int8 as round(127 * hat) (half to even). The sums
// are exact in float32 for int8 (at most 2 * 127 * 127), so one float path
// serves all three.
template <typename T>
__device__ __forceinline__ float stage1_hat(float v) {
  if constexpr (sizeof(T) == 4) {
    return v;
  } else if constexpr (sizeof(T) == 2) {
    return __bfloat162float(__float2bfloat16_rn(v));
  } else {
    return (float)__float2int_rn(__fmul_rn(v, 127.0f));
  }
}

// One sample of a pass: its stage-1 x hats, its y hats times the weight,
// its (y0, x0) corner's channels and its four corners' loads.
template <typename T, int VEC>
struct FwdSample {
  Sample s;
  float wx0, wx1, c0, c1;
  bool on;       // a corner within reach and a nonzero weight
  const T* r0;   // the (absolute row y0, x0) corner at channel 0
  Raw<T, VEC> v00, v01, v10, v11;

  template <bool PER_POINT>
  __device__ __forceinline__ void locate(const T* vb, const int* bidx,
                                         const float* ix, const float* iy,
                                         const float* aw, long bh, int p,
                                         int qp, const Geometry& g,
                                         long rs) {
    const long r = (bh * g.P + p) * (long)g.Qp + qp;
    const float a = aw[r];
    on = false;
    if (a == 0.0f) return;  // padding, or outside the image
    const int row0 = bidx[band_entry<PER_POINT>(g, bh, p, qp / g.TQ)] *
                     (g.win / 2);
    s = band_sample(ix[r], iy[r], row0, g);
    if (!s.any) return;
    on = true;
    wx0 = stage1_hat<T>(hat(s.zx0));
    wx1 = stage1_hat<T>(hat(s.zx1));
    c0 = __fmul_rn(hat(s.zy0), a);
    c1 = __fmul_rn(hat(s.zy1), a);
    r0 = vb + ((long)(row0 + s.y0) * g.w + s.x0) * rs;
  }

  __device__ __forceinline__ void load(int d, const Geometry& g, long rs) {
    v00.zero(); v01.zero(); v10.zero(); v11.zero();
    if (!on) return;
    const T* p0 = r0 + d;
    const T* p1 = p0 + (long)g.w * rs;
    if (s.oky0) {
      if (s.okx0) v00.load(p0);
      if (s.okx1) v01.load(p0 + rs);
    }
    if (s.oky1) {
      if (s.okx0) v10.load(p1);
      if (s.okx1) v11.load(p1 + rs);
    }
  }

  __device__ __forceinline__ void add(float* acc) const {
    if (!on) return;
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const float t0 = wx0 * v00.get(j) + wx1 * v01.get(j);
      const float t1 = wx0 * v10.get(j) + wx1 * v11.get(j);
      acc[j] += t0 * c0 + t1 * c1;
    }
  }
};

// N float32 channels stored with 16-byte vector stores where N allows.
template <int N>
__device__ __forceinline__ void store_vec(float* p, const float* v) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int k = 0; k < N; k += 4)
      *reinterpret_cast<float4*>(p + k) =
          make_float4(v[k], v[k + 1], v[k + 2], v[k + 3]);
  } else if constexpr (N == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    p[0] = v[0];
  }
}

// K5 (PER_POINT false) and K6. The band of (b * H + head, point p, tile)
// is band_entry's: K6's [B, H, P, T] table, or K5's [B, H, T], whose every
// point takes its tile's band. Three blocks an SM (80 registers
// a thread; the int8 and bfloat16 forms at 16 and 8 channels spill a
// little): on the H100 at the served encoder call that measured 0.81x
// (f32), 0.88x (bf16), 1.00x (int8) and, bf16 at B=4, 0.81x the time of two
// blocks an SM; four blocks were slower.
template <typename T, int VEC, bool FOLD, bool PER_POINT>
__global__ void __launch_bounds__(256, 3)
msda_fwd_win_kernel(const T* __restrict__ value, const int* __restrict__ bidx,
                    const float* __restrict__ ix,
                    const float* __restrict__ iy_band,
                    const float* __restrict__ aw_eff,
                    float* __restrict__ out,
                    const __grid_constant__ Segments sg,
                    const __grid_constant__ Geometry g, WGeom gm,
                    long n_warps) {
  const long warp = ((long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= n_warps) return;  // whole warps leave together
  // warp = (b * H + head) * ceil(Q / queries) + query group
  const long per_bh = (g.Q + gm.queries - 1) / gm.queries;
  const long bh = warp / per_bh;
  const int q0 = (int)(warp - bh * per_bh) * gm.queries;
  const int head = (int)(bh % g.H);
  const long b = bh / g.H;
  const int lps = 1 << gm.lps_log2;
  const int spp = 32 >> gm.lps_log2;
  const int slot = lane >> gm.lps_log2;  // sample slot in a pass
  const int sub = lane & (lps - 1);      // channel group within a chunk
  const long rs = (long)g.H * g.D;       // stride between tokens in value
  const T* vb = value + b * g.batch_stride + (long)head * g.D;
  float* ob = out + (b * g.Q * (long)g.H + head) * g.D;

  for (int ps = 0; ps < gm.passes; ps += MSDA_UNROLL) {
    // the lane's query (and with FOLD its point) in each unrolled pass
    int q[MSDA_UNROLL], p[MSDA_UNROLL], qp[MSDA_UNROLL];
    bool live[MSDA_UNROLL];
#pragma unroll
    for (int u = 0; u < MSDA_UNROLL; ++u) {
      const int k = (ps + u) * spp + slot;
      const int qi = FOLD ? k / g.P : k;
      p[u] = FOLD ? k - qi * g.P : 0;
      q[u] = q0 + qi;
      live[u] = ps + u < gm.passes && qi < gm.queries && q[u] < g.Q;
      qp[u] = live[u] ? padded_row(q[u], sg) : 0;
    }
    for (int c = 0; c < gm.chunks; ++c) {
      const int grp = c * lps + sub;
      const bool on = grp < gm.groups;
      const int d = grp * VEC;
      float acc[MSDA_UNROLL][VEC];
#pragma unroll
      for (int u = 0; u < MSDA_UNROLL; ++u)
#pragma unroll
        for (int j = 0; j < VEC; ++j) acc[u][j] = 0.0f;
      // FOLD: the lane's one sample a pass; else its query's points in turn
      for (int pt = 0; pt < (FOLD ? 1 : g.P); ++pt) {
        FwdSample<T, VEC> t[MSDA_UNROLL];
        // every load of the passes first
#pragma unroll
        for (int u = 0; u < MSDA_UNROLL; ++u) {
          t[u].on = false;
          if (live[u] && on)
            t[u].template locate<PER_POINT>(vb, bidx, ix, iy_band, aw_eff,
                                            bh, FOLD ? p[u] : pt, qp[u], g,
                                            rs);
          t[u].load(d, g, rs);
        }
#pragma unroll
        for (int u = 0; u < MSDA_UNROLL; ++u) t[u].add(acc[u]);
      }
      if (FOLD) {
        // a query's points over their neighbouring slots, in a fixed order
        for (int off = lps; off < lps * g.P; off <<= 1) {
#pragma unroll
          for (int u = 0; u < MSDA_UNROLL; ++u)
#pragma unroll
            for (int j = 0; j < VEC; ++j)
              acc[u][j] += __shfl_xor_sync(MSDA_FULL_MASK, acc[u][j], off);
        }
      }
#pragma unroll
      for (int u = 0; u < MSDA_UNROLL; ++u) {
        if (live[u] && on && p[u] == 0)
          store_vec<VEC>(ob + (long)q[u] * rs + d, acc[u]);
      }
    }
  }
}

template <typename T, int VEC, bool PER_POINT>
static void launch_vec(const WGeom& gm, const void* value, const int* bi,
                       const float* fx, const float* fy, const float* fa,
                       float* o, const Segments& sg, const Geometry& g,
                       long n_warps, cudaStream_t s) {
  if (gm.fold)
    msda_fwd_win_kernel<T, VEC, true, PER_POINT>
        <<<gm.blocks, gm.threads, 0, s>>>((const T*)value, bi, fx, fy, fa, o,
                                          sg, g, gm, n_warps);
  else
    msda_fwd_win_kernel<T, VEC, false, PER_POINT>
        <<<gm.blocks, gm.threads, 0, s>>>((const T*)value, bi, fx, fy, fa, o,
                                          sg, g, gm, n_warps);
}

// K5 and K6: msda_fwd_win_kernel in the tile or the point form.
// vtype: 0 float32, 1 bfloat16, 2 int8 values; geometry: the nine ints of
// struct WGeom (msda_band.cuh), in its order.
static int launch(const void* value, const void* bidx, const void* ix,
                  const void* iy_band, const void* aw_eff, void* out,
                  const int* segments, int n_segments, int B, int Q, int Qp,
                  int H, int D, int P, int h, int w, int win, int TQ,
                  long batch_stride, int vtype, const int* geometry,
                  int per_point, void* stream) {
  Segments sg;
  Geometry g;
  const int rc = read_band_geometry(segments, n_segments, Q, Qp, H, D, P, h,
                                    w, win, TQ, batch_stride, &sg, &g);
  if (rc != (int)cudaSuccess) return rc;
  if ((long)B * H * Q == 0) return (int)cudaSuccess;
  if (vtype < 0 || vtype > 2) return (int)cudaErrorInvalidValue;
  const WGeom gm = read_win_geometry(geometry);
  const int elem_bytes = vtype == 0 ? 4 : (vtype == 1 ? 2 : 1);
  if (!win_geometry_ok(gm, (long)B * H, Q, D, P, elem_bytes, WIN_FWD))
    return (int)cudaErrorInvalidValue;
  const long n_warps = (long)B * H * ((Q + gm.queries - 1) / gm.queries);
  cudaStream_t s = (cudaStream_t)stream;
  const int* bi = (const int*)bidx;
  const float *fx = (const float*)ix, *fy = (const float*)iy_band;
  const float* fa = (const float*)aw_eff;
  float* o = (float*)out;
#define MSDA_FWD(T, VEC)                                                    \
  if (per_point)                                                            \
    launch_vec<T, VEC, true>(gm, value, bi, fx, fy, fa, o, sg, g, n_warps,  \
                             s);                                            \
  else                                                                      \
    launch_vec<T, VEC, false>(gm, value, bi, fx, fy, fa, o, sg, g, n_warps, \
                              s)
  if (vtype == 0) {
    switch (gm.vec) {
      case 4: MSDA_FWD(float, 4); break;
      case 2: MSDA_FWD(float, 2); break;
      case 1: MSDA_FWD(float, 1); break;
      default: return (int)cudaErrorInvalidValue;
    }
  } else if (vtype == 1) {
    switch (gm.vec) {
      case 8: MSDA_FWD(__nv_bfloat16, 8); break;
      case 4: MSDA_FWD(__nv_bfloat16, 4); break;
      case 2: MSDA_FWD(__nv_bfloat16, 2); break;
      case 1: MSDA_FWD(__nv_bfloat16, 1); break;
      default: return (int)cudaErrorInvalidValue;
    }
  } else {
    switch (gm.vec) {
      case 16: MSDA_FWD(int8_t, 16); break;
      case 8: MSDA_FWD(int8_t, 8); break;
      case 4: MSDA_FWD(int8_t, 4); break;
      case 2: MSDA_FWD(int8_t, 2); break;
      case 1: MSDA_FWD(int8_t, 1); break;
      default: return (int)cudaErrorInvalidValue;
    }
  }
#undef MSDA_FWD
  return (int)cudaGetLastError();
}

// K5: bidx [B, H, T]. out: float32 [B, Q, H, D]; vtype: 0 float32,
// 1 bfloat16, 2 int8 values; geometry: the nine ints of struct WGeom.
extern "C" int msda_fwd_win(const void* value, const void* bidx,
                            const void* ix, const void* iy_band,
                            const void* aw_eff, void* out,
                            const int* segments, int n_segments, int B, int Q,
                            int Qp, int H, int D, int P, int h, int w,
                            int win, int TQ, long batch_stride, int vtype,
                            const int* geometry, void* stream) {
  return launch(value, bidx, ix, iy_band, aw_eff, out, segments, n_segments,
                B, Q, Qp, H, D, P, h, w, win, TQ, batch_stride, vtype,
                geometry, 0, stream);
}

// K6: bidx [B, H, P, T]; the rest as msda_fwd_win.
extern "C" int msda_fwd_win_pp(const void* value, const void* bidx,
                               const void* ix, const void* iy_band,
                               const void* aw_eff, void* out,
                               const int* segments, int n_segments, int B,
                               int Q, int Qp, int H, int D, int P, int h,
                               int w, int win, int TQ, long batch_stride,
                               int vtype, const int* geometry, void* stream) {
  return launch(value, bidx, ix, iy_band, aw_eff, out, segments, n_segments,
                B, Q, Qp, H, D, P, h, w, win, TQ, batch_stride, vtype,
                geometry, 1, stream);
}

// Banded (windowed) multi-scale deformable attention backward for one level,
// for Hopper (sm_90a).
//
// Replaces the four Pallas TPU kernels of egtr_tpu/ops/msda_pallas.py that
// _msda_win_bwd runs on a level taller than the window:
//   msda_bwd_win_rows      K7   _bwd_rows_kernel_win (body _bwd_rows_body_hb):
//                               row gradients dix, diy, daw, one band per
//                               query tile, bidx [B, H, T];
//   msda_bwd_win_rows_pp   K8   _bwd_rows_kernel_win_pp: the same, one band
//                               per (sampling point, query tile),
//                               bidx [B, H, P, T];
//   msda_bwd_win_value     K9   _bwd_dvtt_kernel_win: the value gradient,
//                               one band per tile;
//   msda_bwd_win_value_pp  K10  _bwd_dvtt_kernel_win_pp: the same, one band
//                               per (point, tile).
//
// On the TPU a band is two half-band blocks that the index maps select; the
// value kernels visit the tiles (or (point, tile) pairs) in band-sorted
// order so that one band's block accumulates over consecutive grid steps,
// then the caller zeroes the bands no tile used and overlap-adds the bands
// into the level's gradient. This card gathers and scatters: the kernels read
// (or add to) the two-by-two corners directly at the absolute row
// bidx * win/2 + y_local, which replaces the band-sorted order, the
// first/used masks and the overlap-add. They keep the forward's reach
// (msda_fwd_win.cu), so they compute the TPU kernels' function: the hats are
// taken on the band-local coordinate, a corner whose y_local lies outside
// [0, win) contributes nothing even where its absolute row exists, nor does
// one at or beyond row h (the last band's overhang).
//
// Inputs are the rows msda_window.window_rows makes, [B, H, P, Q_pad]
// float32 with the query minor: ix, the band-local iy and aw_eff (zero
// outside the image and on the padding), and the op's output gradient g
// [B, Q, H, D] in the value dtype. Each query segment is padded to a
// multiple of the tile TQ on its own; the kernels map a query q to its padded
// row through the segment table and never visit the padding, whose output
// rows the wrapper zeroes. Outputs are unmasked: the caller masks diy where
// the clamp was active and daw outside the image.
//
// Arithmetic (cdt = the value dtype, all sums float32), as msda_bwd.cu:
//   dT_j   = cdt(hat_y_j * aw * g)      rounded per (corner row, channel)
//   dix    = sum_i hat'(ix - x_i) * sum_{j,d} V_ji * dT_j
//   T_j    = sum_i V_ji * cdt(hat_x_i)
//   daw    = sum_{j,d} hat_y_j * T_j * g
//   diy    = sum_{j,d} aw * hat'(iy - y_j) * T_j * g
//   dV_ji += dT_j * cdt(hat_x_i)
// hat'(t) = -sign(t) for |t| < 1, else 0, and 0 at t = 0.
//
// Design of K7, K9 and K10: one warp per (batch, head, query), the query
// fastest so that neighbouring warps read neighbouring rows; lanes over the
// head dim D.
//   rows (K7): per point the three sums are reduced across the warp with
//          shuffles and lane 0 writes them. No atomics: deterministic.
//   value (K9, K10): per point each lane adds its channel of the four corner
//          contributions with a float32 atomicAdd into the level's zeroed
//          float32 gradient [B, h*w, H, D]. The order of the additions
//          changes from run to run, so the last bits of the sums do too.
//
// Design of K8 (msda_bwd_win_rows_pp), msda_bwd.cu's K2 layout carried
// over: in K7's layout a warp walked its P = 4 samples in turn with lanes
// over D, so a sample's four corner loads were 64-byte (bf16) rows one at a
// time and each sample cost three full-warp reductions (60 shuffles a warp
// for four samples), plus the segment search and band lookup per warp; it
// ran 29x off its bound. Here a warp takes (batch, head) and `queries`
// neighbouring queries (4 at bf16, 2 at float32 with D = 32), and its lanes
// split over (query, point, channel group) as msda_cuda.win_rows_geometry
// says: a lane reads VEC channels of a corner with one vector load (16
// bytes where D and the value and g pointers allow it), two passes' loads
// (every sample of the warp at bf16, D = 32) go out together, each lane
// maps its own query to its padded row through the segment table (a warp's
// queries may straddle a segment boundary; a query past Q does nothing), and
// a sample's three sums are folded over its own lanes only with
// __shfl_xor_sync in a fixed order (2 rounds at bf16, D = 32), then stored
// by three of them. No atomics: deterministic, bit-equal run to run. The
// reach rules above are kept as they are: band_sample decides them on the
// band-local row before the row is made absolute.
//
// Bound: memory. The rows (16 bytes per sample with g's share) and the
// corner rows (4 per sample, mostly L2 hits) dominate; the value kernels
// make 4 atomic row updates per sample into a gradient that fits the 50 MB
// L2 one image at a time. The band itself gains a gather nothing; staging a
// band in shared memory is left for a later change.
//
// C interface for ctypes: each function launches on the given stream and
// returns cudaGetLastError() as an int (0 = launched).

#include "msda_geom.cuh"

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

// A float32 product as the JAX kernels feed it to the MXU: rounded to T.
__device__ __forceinline__ float round_to(float v, const float*) { return v; }
__device__ __forceinline__ float round_to(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(v));
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

// Where a warp's query lives: its batch, head, padded row and the first
// entry of its band indices.
struct Query {
  long b, bh;
  int q, head, qp;
  long rows;     // index of (b, head, p = 0, qp) in the rows
  const int* bp;  // bidx of (b, head[, p = 0], tile)
};

template <bool PER_POINT>
__device__ __forceinline__ Query locate(long warp, const int* bidx,
                                        const Segments& sg,
                                        const Geometry& g) {
  Query qu;
  // warp = (b * H + head) * Q + q
  qu.q = (int)(warp % g.Q);
  qu.bh = warp / g.Q;
  qu.head = (int)(qu.bh % g.H);
  qu.b = qu.bh / g.H;
  int s = 0;
  while (s + 1 < sg.n && qu.q >= sg.q0[s + 1]) ++s;
  qu.qp = sg.qp0[s] + (qu.q - sg.q0[s]);
  qu.rows = qu.bh * g.P * (long)g.Qp + qu.qp;
  qu.bp = bidx + (PER_POINT ? qu.bh * g.P * (long)g.T : qu.bh * (long)g.T)
          + qu.qp / g.TQ;
  return qu;
}

// One sample's band-local geometry, the same for every lane of the warp.
struct Sample {
  float zx0, zx1, zy0, zy1;  // ix - x0, ix - x1, iy - y0, iy - y1
  int x0, y0;                // y0 band-local
  bool okx0, okx1, oky0, oky1;
  bool any;                  // some corner is within reach
};

__device__ __forceinline__ Sample band_sample(float x, float y, int row0,
                                              const Geometry& g) {
  Sample s;
  const float fx0 = floorf(x), fy0 = floorf(y);
  const float fx1 = fx0 + 1.0f, fy1 = fy0 + 1.0f;
  s.zx0 = x - fx0;
  s.zx1 = x - fx1;
  s.zy0 = y - fy0;
  s.zy1 = y - fy1;
  const float fw = (float)g.w;
  s.okx0 = fx0 >= 0.0f && fx0 <= fw - 1.0f;
  s.okx1 = fx1 >= 0.0f && fx1 <= fw - 1.0f;
  // inside the band, and not past the level's last row
  const float ylim = fminf((float)(g.win - 1), (float)(g.h - 1 - row0));
  s.oky0 = fy0 >= 0.0f && fy0 <= ylim;
  s.oky1 = fy1 >= 0.0f && fy1 <= ylim;
  s.any = (s.okx0 || s.okx1) && (s.oky0 || s.oky1);
  // only used where a corner is within reach, so the cast cannot overflow
  s.x0 = s.any ? (int)fx0 : 0;
  s.y0 = s.any ? (int)fy0 : 0;
  return s;
}

template <typename T>
__global__ void __launch_bounds__(256)
msda_bwd_win_rows_kernel(const T* __restrict__ value,
                         const int* __restrict__ bidx,
                         const float* __restrict__ ix,
                         const float* __restrict__ iy_band,
                         const float* __restrict__ aw_eff,
                         const T* __restrict__ grad,
                         float* __restrict__ dix, float* __restrict__ diy,
                         float* __restrict__ daw,
                         const __grid_constant__ Segments sg,
                         const __grid_constant__ Geometry g, long n_warps) {
  const long warp = ((long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= n_warps) return;  // whole warps leave together
  const Query qu = locate<false>(warp, bidx, sg, g);
  const long row = (long)g.H * g.D;  // stride between tokens in value
  const T* vb = value + qu.b * g.batch_stride + (long)qu.head * g.D;
  const T* gp = grad + ((qu.b * g.Q + qu.q) * (long)g.H + qu.head) * g.D;
  const int half = g.win / 2;

  for (int p = 0; p < g.P; ++p) {
    const long r = qu.rows + p * (long)g.Qp;
    const float a = aw_eff[r];
    const int row0 = qu.bp[0] * half;
    const Sample s = band_sample(ix[r], iy_band[r], row0, g);
    float s_dix = 0.0f, s_diy = 0.0f, s_daw = 0.0f;
    if (s.any) {  // the same for the whole warp
      const float hx0 = round_to(hat(s.zx0), vb);
      const float hx1 = round_to(hat(s.zx1), vb);
      const float hy0 = hat(s.zy0), hy1 = hat(s.zy1);
      const float ghx0 = hat_grad(s.zx0), ghx1 = hat_grad(s.zx1);
      const float ghy0 = hat_grad(s.zy0), ghy1 = hat_grad(s.zy1);
      const float c0 = __fmul_rn(hy0, a), c1 = __fmul_rn(hy1, a);
      const float e0 = __fmul_rn(a, ghy0), e1 = __fmul_rn(a, ghy1);
      const T* r0 = vb + (long)(row0 + s.y0) * g.w * row;
      const T* r1 = r0 + (long)g.w * row;
      for (int d = lane; d < g.D; d += 32) {
        const float gd = to_float(gp[d]);
        float v00 = 0.0f, v01 = 0.0f, v10 = 0.0f, v11 = 0.0f;
        if (s.oky0) {
          if (s.okx0) v00 = to_float(r0[(long)s.x0 * row + d]);
          if (s.okx1) v01 = to_float(r0[(long)(s.x0 + 1) * row + d]);
        }
        if (s.oky1) {
          if (s.okx0) v10 = to_float(r1[(long)s.x0 * row + d]);
          if (s.okx1) v11 = to_float(r1[(long)(s.x0 + 1) * row + d]);
        }
        const float dT0 = round_to(__fmul_rn(c0, gd), vb);
        const float dT1 = round_to(__fmul_rn(c1, gd), vb);
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
      dix[r] = s_dix;
      diy[r] = s_diy;
      daw[r] = s_daw;
    }
  }
}

// K8's launch, the eight ints of msda_cuda.WinRowsGeometry in its order.
struct WGeom {
  int vec;       // channels per lane load
  int lps_log2;  // log2 of the lanes per sample
  int groups;    // D / vec channel groups
  int chunks;    // ceil(groups / lanes per sample)
  int queries;   // neighbouring queries a warp takes
  int passes;    // ceil(queries * P / samples per pass)
  int threads;
  int blocks;
};

static inline WGeom read_win_geometry(const int* g) {
  return WGeom{g[0], g[1], g[2], g[3], g[4], g[5], g[6], g[7]};
}

// The geometry against the shapes (n_warps = B*H*ceil(Q / queries)):
// anything the kernel's index math does not cover exactly once is refused.
static bool win_geometry_ok(const WGeom& g, long BH, int Q, int D, int P,
                            int is_bf16) {
  if (g.lps_log2 < 0 || g.lps_log2 > 5) return false;
  const int lps = 1 << g.lps_log2;
  if (g.vec < 1 || g.vec * (is_bf16 ? 2 : 4) > 16 || (g.vec & (g.vec - 1)))
    return false;
  if (g.groups * g.vec != D || g.chunks * lps < g.groups ||
      (g.chunks - 1) * lps >= g.groups)
    return false;
  if (g.queries < 1 || g.passes < 0 ||
      (long)g.passes * (32 / lps) < (long)g.queries * P)
    return false;
  if (g.threads < 32 || g.threads > 256 || g.threads % 32) return false;
  const long n_warps = BH * ((Q + g.queries - 1) / g.queries);
  const long per_block = g.threads / 32;
  return g.blocks >= 1 && (long)g.blocks * per_block >= n_warps &&
         (long)(g.blocks - 1) * per_block < n_warps;
}

// One sample of a pass: where its row lives, its band-local geometry, its
// query's output gradient and its four corners' values.
template <typename T, int VEC>
struct BandSample {
  Sample s;
  long r;        // its entry in the rows [B, H, P, Q_pad]
  const T* gp;   // its query's g
  float a;
  bool valid;    // the lane's sample exists
  Raw<T, VEC> g, v00, v01, v10, v11;
};

// Three blocks an SM (80 registers a thread, some spilled): on the H100
// that measured 0.93x the time of two blocks an SM in float32, the same in
// bf16.
template <typename T, int VEC>
__global__ void __launch_bounds__(256, 3)
msda_bwd_win_rows_pp_kernel(const T* __restrict__ value,
                            const int* __restrict__ bidx,
                            const float* __restrict__ ix,
                            const float* __restrict__ iy_band,
                            const float* __restrict__ aw_eff,
                            const T* __restrict__ grad,
                            float* __restrict__ dix, float* __restrict__ diy,
                            float* __restrict__ daw,
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
  const int ns = gm.queries * g.P;       // the warp's samples, query-major
  const long rs = (long)g.H * g.D;       // stride between tokens in value
  const T* vb = value + b * g.batch_stride + (long)head * g.D;
  const int half = g.win / 2;

  for (int ps = 0; ps < gm.passes; ps += MSDA_UNROLL) {
    BandSample<T, VEC> sm[MSDA_UNROLL];
#pragma unroll
    for (int u = 0; u < MSDA_UNROLL; ++u) {
      BandSample<T, VEC>& t = sm[u];
      const int k = (ps + u) * spp + slot;
      const int qi = k / g.P, p = k - qi * g.P;
      const int q = q0 + qi;
      t.valid = k < ns && q < g.Q;
      t.s.any = false;
      t.a = 0.0f;
      t.r = 0;
      t.gp = grad;
      if (!t.valid) continue;
      // the query's padded row: its segment, each padded to tiles of TQ
      int seg = 0;
      while (seg + 1 < sg.n && q >= sg.q0[seg + 1]) ++seg;
      const int qp = sg.qp0[seg] + (q - sg.q0[seg]);
      t.r = (bh * g.P + p) * (long)g.Qp + qp;
      t.a = aw_eff[t.r];
      const int row0 = bidx[(bh * g.P + p) * (long)g.T + qp / g.TQ] * half;
      t.s = band_sample(ix[t.r], iy_band[t.r], row0, g);
      t.s.y0 += row0;  // absolute from here on; the reach is decided
      t.gp = grad + ((b * g.Q + q) * (long)g.H + head) * g.D;
    }
    float sums[MSDA_UNROLL][3];
#pragma unroll
    for (int u = 0; u < MSDA_UNROLL; ++u)
      sums[u][0] = sums[u][1] = sums[u][2] = 0.0f;

    for (int c = 0; c < gm.chunks; ++c) {
      const int grp = c * lps + sub;
      const bool on = grp < gm.groups;
      const int d = grp * VEC;
      // every load of the passes first
#pragma unroll
      for (int u = 0; u < MSDA_UNROLL; ++u) {
        BandSample<T, VEC>& t = sm[u];
        t.g.zero(); t.v00.zero(); t.v01.zero(); t.v10.zero(); t.v11.zero();
        if (!(on && t.valid)) continue;
        t.g.load(t.gp + d);
        if (!t.s.any) continue;
        const T* r0 = vb + ((long)t.s.y0 * g.w + t.s.x0) * rs + d;
        const T* r1 = r0 + (long)g.w * rs;
        if (t.s.oky0) {
          if (t.s.okx0) t.v00.load(r0);
          if (t.s.okx1) t.v01.load(r0 + rs);
        }
        if (t.s.oky1) {
          if (t.s.okx0) t.v10.load(r1);
          if (t.s.okx1) t.v11.load(r1 + rs);
        }
      }
#pragma unroll
      for (int u = 0; u < MSDA_UNROLL; ++u) {
        const BandSample<T, VEC>& t = sm[u];
        if (!(on && t.valid && t.s.any)) continue;
        const Sample& s = t.s;
        const float hx0 = round_to<T>(hat(s.zx0));
        const float hx1 = round_to<T>(hat(s.zx1));
        const float hy0 = hat(s.zy0), hy1 = hat(s.zy1);
        const float ghx0 = hat_grad(s.zx0), ghx1 = hat_grad(s.zx1);
        const float ghy0 = hat_grad(s.zy0), ghy1 = hat_grad(s.zy1);
        const float c0 = __fmul_rn(hy0, t.a), c1 = __fmul_rn(hy1, t.a);
        const float e0 = __fmul_rn(t.a, ghy0), e1 = __fmul_rn(t.a, ghy1);
        float s_dix = sums[u][0], s_diy = sums[u][1], s_daw = sums[u][2];
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const float gd = t.g.get(j);
          const float v00 = t.v00.get(j), v01 = t.v01.get(j);
          const float v10 = t.v10.get(j), v11 = t.v11.get(j);
          const float dT0 = round_to<T>(__fmul_rn(c0, gd));
          const float dT1 = round_to<T>(__fmul_rn(c1, gd));
          s_dix += (v00 * dT0 + v10 * dT1) * ghx0
                 + (v01 * dT0 + v11 * dT1) * ghx1;
          const float Tg0 = (v00 * hx0 + v01 * hx1) * gd;
          const float Tg1 = (v10 * hx0 + v11 * hx1) * gd;
          s_daw += hy0 * Tg0 + hy1 * Tg1;
          s_diy += e0 * Tg0 + e1 * Tg1;
        }
        sums[u][0] = s_dix;
        sums[u][1] = s_diy;
        sums[u][2] = s_daw;
      }
    }
    // fold each sample's sums over its own lanes, in a fixed order
    for (int off = 1; off < lps; off <<= 1) {
#pragma unroll
      for (int u = 0; u < MSDA_UNROLL; ++u) {
#pragma unroll
        for (int m = 0; m < 3; ++m)
          sums[u][m] += __shfl_xor_sync(MSDA_FULL_MASK, sums[u][m], off);
      }
    }
    // the sample's lanes share its three stores: sub 0 dix, 1 diy, 2 daw
    const int lane_y = lps > 1 ? 1 : 0, lane_a = lps > 2 ? 2 : lps - 1;
#pragma unroll
    for (int u = 0; u < MSDA_UNROLL; ++u) {
      const BandSample<T, VEC>& t = sm[u];
      if (!t.valid) continue;
      if (sub == 0) dix[t.r] = sums[u][0];
      if (sub == lane_y) diy[t.r] = sums[u][1];
      if (sub == lane_a) daw[t.r] = sums[u][2];
    }
  }
}

template <typename T, bool PER_POINT>
__global__ void __launch_bounds__(256)
msda_bwd_win_value_kernel(const int* __restrict__ bidx,
                          const float* __restrict__ ix,
                          const float* __restrict__ iy_band,
                          const float* __restrict__ aw_eff,
                          const T* __restrict__ grad,
                          float* __restrict__ dvalue,
                          const __grid_constant__ Segments sg,
                          const __grid_constant__ Geometry g, long n_warps) {
  const long warp = ((long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= n_warps) return;
  const Query qu = locate<PER_POINT>(warp, bidx, sg, g);
  const long row = (long)g.H * g.D;
  float* db = dvalue + qu.b * (long)g.h * g.w * row + (long)qu.head * g.D;
  const T* gp = grad + ((qu.b * g.Q + qu.q) * (long)g.H + qu.head) * g.D;
  const int half = g.win / 2;

  for (int p = 0; p < g.P; ++p) {
    const long r = qu.rows + p * (long)g.Qp;
    const float a = aw_eff[r];
    if (a == 0.0f) continue;  // dT = 0: outside the image, or no weight
    const int row0 = (PER_POINT ? qu.bp[p * (long)g.T] : qu.bp[0]) * half;
    const Sample s = band_sample(ix[r], iy_band[r], row0, g);
    if (!s.any) continue;
    const float hx0 = round_to(hat(s.zx0), gp);
    const float hx1 = round_to(hat(s.zx1), gp);
    const float c0 = __fmul_rn(hat(s.zy0), a);
    const float c1 = __fmul_rn(hat(s.zy1), a);
    // a zero weight adds nothing: skip the atomics of that corner
    const bool do00 = s.oky0 && s.okx0 && c0 != 0.0f && hx0 != 0.0f;
    const bool do01 = s.oky0 && s.okx1 && c0 != 0.0f && hx1 != 0.0f;
    const bool do10 = s.oky1 && s.okx0 && c1 != 0.0f && hx0 != 0.0f;
    const bool do11 = s.oky1 && s.okx1 && c1 != 0.0f && hx1 != 0.0f;
    float* r0 = db + (long)(row0 + s.y0) * g.w * row;
    float* r1 = r0 + (long)g.w * row;
    for (int d = lane; d < g.D; d += 32) {
      const float gd = to_float(gp[d]);
      const float dT0 = round_to(__fmul_rn(c0, gd), gp);
      const float dT1 = round_to(__fmul_rn(c1, gd), gp);
      if (do00) atomicAdd(r0 + (long)s.x0 * row + d, dT0 * hx0);
      if (do01) atomicAdd(r0 + (long)(s.x0 + 1) * row + d, dT0 * hx1);
      if (do10) atomicAdd(r1 + (long)s.x0 * row + d, dT1 * hx0);
      if (do11) atomicAdd(r1 + (long)(s.x0 + 1) * row + d, dT1 * hx1);
    }
  }
}

static int read_geometry(const int* segments, int n_segments, int Q, int Qp,
                         int H, int D, int P, int h, int w, int win, int TQ,
                         long batch_stride, Segments* sg, Geometry* g) {
  if (n_segments < 1 || n_segments > MSDA_MAX_SEGMENTS || TQ < 1 ||
      Qp % TQ != 0 || win < 2 || win % 2 != 0 || h <= win)
    return (int)cudaErrorInvalidValue;
  sg->n = n_segments;
  for (int s = 0; s < n_segments; ++s) {
    sg->q0[s] = segments[2 * s];
    sg->qp0[s] = segments[2 * s + 1];
  }
  *g = Geometry{Q, Qp, H, D, P, h, w, win, TQ, Qp / TQ, batch_stride};
  return (int)cudaSuccess;
}

static unsigned blocks_for(long n_warps, int threads) {
  return (unsigned)((n_warps * 32 + threads - 1) / threads);
}

static int launch_rows(const void* value, const void* bidx, const void* ix,
                       const void* iy_band, const void* aw_eff,
                       const void* grad, void* dix, void* diy, void* daw,
                       const int* segments, int n_segments, int B, int Q,
                       int Qp, int H, int D, int P, int h, int w, int win,
                       int TQ, long batch_stride, int is_bf16, void* stream) {
  Segments sg;
  Geometry g;
  const int rc = read_geometry(segments, n_segments, Q, Qp, H, D, P, h, w,
                               win, TQ, batch_stride, &sg, &g);
  if (rc != (int)cudaSuccess) return rc;
  const long n_warps = (long)B * H * Q;
  if (n_warps == 0) return (int)cudaSuccess;
  const int threads = 256;
  cudaStream_t s = (cudaStream_t)stream;
  const int* bi = (const int*)bidx;
  const float *fx = (const float*)ix, *fy = (const float*)iy_band;
  const float* fa = (const float*)aw_eff;
  float *ox = (float*)dix, *oy = (float*)diy, *oa = (float*)daw;
  if (is_bf16) {
    msda_bwd_win_rows_kernel<__nv_bfloat16>
        <<<blocks_for(n_warps, threads), threads, 0, s>>>(
            (const __nv_bfloat16*)value, bi, fx, fy, fa,
            (const __nv_bfloat16*)grad, ox, oy, oa, sg, g, n_warps);
  } else {
    msda_bwd_win_rows_kernel<float>
        <<<blocks_for(n_warps, threads), threads, 0, s>>>(
            (const float*)value, bi, fx, fy, fa, (const float*)grad, ox, oy,
            oa, sg, g, n_warps);
  }
  return (int)cudaGetLastError();
}

template <bool PER_POINT>
static int launch_value(const void* bidx, const void* ix, const void* iy_band,
                        const void* aw_eff, const void* grad, void* dvalue,
                        const int* segments, int n_segments, int B, int Q,
                        int Qp, int H, int D, int P, int h, int w, int win,
                        int TQ, int is_bf16, void* stream) {
  Segments sg;
  Geometry g;
  const int rc = read_geometry(segments, n_segments, Q, Qp, H, D, P, h, w,
                               win, TQ, 0, &sg, &g);
  if (rc != (int)cudaSuccess) return rc;
  const long n_warps = (long)B * H * Q;
  if (n_warps == 0) return (int)cudaSuccess;
  const int threads = 256;
  cudaStream_t s = (cudaStream_t)stream;
  const int* bi = (const int*)bidx;
  const float *fx = (const float*)ix, *fy = (const float*)iy_band;
  const float* fa = (const float*)aw_eff;
  if (is_bf16) {
    msda_bwd_win_value_kernel<__nv_bfloat16, PER_POINT>
        <<<blocks_for(n_warps, threads), threads, 0, s>>>(
            bi, fx, fy, fa, (const __nv_bfloat16*)grad, (float*)dvalue, sg,
            g, n_warps);
  } else {
    msda_bwd_win_value_kernel<float, PER_POINT>
        <<<blocks_for(n_warps, threads), threads, 0, s>>>(
            bi, fx, fy, fa, (const float*)grad, (float*)dvalue, sg, g,
            n_warps);
  }
  return (int)cudaGetLastError();
}

// dix, diy, daw: float32 [B, H, P, Q_pad]; the padding rows are not written.
extern "C" int msda_bwd_win_rows(const void* value, const void* bidx,
                                 const void* ix, const void* iy_band,
                                 const void* aw_eff, const void* grad,
                                 void* dix, void* diy, void* daw,
                                 const int* segments, int n_segments, int B,
                                 int Q, int Qp, int H, int D, int P, int h,
                                 int w, int win, int TQ, long batch_stride,
                                 int is_bf16, void* stream) {
  return launch_rows(value, bidx, ix, iy_band, aw_eff, grad, dix, diy,
                            daw, segments, n_segments, B, Q, Qp, H, D, P, h,
                            w, win, TQ, batch_stride, is_bf16, stream);
}

// geometry: the eight ints of struct WGeom, in its order.
extern "C" int msda_bwd_win_rows_pp(const void* value, const void* bidx,
                                    const void* ix, const void* iy_band,
                                    const void* aw_eff, const void* grad,
                                    void* dix, void* diy, void* daw,
                                    const int* segments, int n_segments,
                                    int B, int Q, int Qp, int H, int D, int P,
                                    int h, int w, int win, int TQ,
                                    long batch_stride, int is_bf16,
                                    const int* geometry, void* stream) {
  Segments sg;
  Geometry g;
  const int rc = read_geometry(segments, n_segments, Q, Qp, H, D, P, h, w,
                               win, TQ, batch_stride, &sg, &g);
  if (rc != (int)cudaSuccess) return rc;
  if ((long)B * H * Q == 0) return (int)cudaSuccess;
  const WGeom gm = read_win_geometry(geometry);
  if (!win_geometry_ok(gm, (long)B * H, Q, D, P, is_bf16))
    return (int)cudaErrorInvalidValue;
  const long n_warps = (long)B * H * ((Q + gm.queries - 1) / gm.queries);
  cudaStream_t s = (cudaStream_t)stream;
  const int* bi = (const int*)bidx;
  const float *fx = (const float*)ix, *fy = (const float*)iy_band;
  const float* fa = (const float*)aw_eff;
  float *ox = (float*)dix, *oy = (float*)diy, *oa = (float*)daw;
#define MSDA_K8(T, VEC)                                                     \
  msda_bwd_win_rows_pp_kernel<T, VEC><<<gm.blocks, gm.threads, 0, s>>>(     \
      (const T*)value, bi, fx, fy, fa, (const T*)grad, ox, oy, oa, sg, g, gm, \
      n_warps)
  if (is_bf16) {
    switch (gm.vec) {
      case 8: MSDA_K8(__nv_bfloat16, 8); break;
      case 4: MSDA_K8(__nv_bfloat16, 4); break;
      case 2: MSDA_K8(__nv_bfloat16, 2); break;
      case 1: MSDA_K8(__nv_bfloat16, 1); break;
      default: return (int)cudaErrorInvalidValue;
    }
  } else {
    switch (gm.vec) {
      case 4: MSDA_K8(float, 4); break;
      case 2: MSDA_K8(float, 2); break;
      case 1: MSDA_K8(float, 1); break;
      default: return (int)cudaErrorInvalidValue;
    }
  }
#undef MSDA_K8
  return (int)cudaGetLastError();
}

// dvalue: float32 [B, h*w, H, D], zeroed by the caller.
extern "C" int msda_bwd_win_value(const void* bidx, const void* ix,
                                  const void* iy_band, const void* aw_eff,
                                  const void* grad, void* dvalue,
                                  const int* segments, int n_segments, int B,
                                  int Q, int Qp, int H, int D, int P, int h,
                                  int w, int win, int TQ, int is_bf16,
                                  void* stream) {
  return launch_value<false>(bidx, ix, iy_band, aw_eff, grad, dvalue,
                             segments, n_segments, B, Q, Qp, H, D, P, h, w,
                             win, TQ, is_bf16, stream);
}

extern "C" int msda_bwd_win_value_pp(const void* bidx, const void* ix,
                                     const void* iy_band, const void* aw_eff,
                                     const void* grad, void* dvalue,
                                     const int* segments, int n_segments,
                                     int B, int Q, int Qp, int H, int D,
                                     int P, int h, int w, int win, int TQ,
                                     int is_bf16, void* stream) {
  return launch_value<true>(bidx, ix, iy_band, aw_eff, grad, dvalue,
                            segments, n_segments, B, Q, Qp, H, D, P, h, w,
                            win, TQ, is_bf16, stream);
}

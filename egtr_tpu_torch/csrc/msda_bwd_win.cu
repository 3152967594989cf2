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
// (band_sample in msda_band.cuh), so they compute the TPU kernels' function:
// the hats are
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
// K7 runs K8's kernel (msda_bwd_win_rows_kernel). The JAX package computes the
// two with one body (_bwd_rows_body_hb), and under one band per tile every
// point of a tile takes the same band, so K7 is K8 with a band table whose
// point stride is zero: the kernel reads the band of (b * H + head, point,
// tile) at bidx[bh * bh_stride + p * p_stride + tile], with strides P * T and
// T for K8's [B, H, P, T] table, T and 0 for K7's [B, H, T] (band_entry in
// msda_band.cuh, the form a template flag). K7 takes K8's launch
// (msda_cuda.win_geometry, form "rows") and is bit-equal to K8 given its tile
// bands broadcast over the points. The layout it replaces (one warp per
// (batch, head, query), lanes over D, the points walked in turn, three
// full-warp shuffle reductions a sample) ran 28x off its bound. Measured on
// the H100 at the adaptation's three banded levels (608x1008, window 16, batch
// 4, raster locations), device time in turns with that layout: bf16 0.647
// against 1.934 ms (0.33x), f32 0.990 against 1.876 (0.53x).
//
// Design of K8 (msda_bwd_win_rows_pp), msda_bwd.cu's K2 layout carried
// over: in the old layout a warp walked its P = 4 samples in turn with lanes
// over D, so a sample's four corner loads were 64-byte (bf16) rows one at a
// time and each sample cost three full-warp reductions (60 shuffles a warp
// for four samples), plus the segment search and band lookup per warp; it
// ran 29x off its bound. Here a warp takes (batch, head) and `queries`
// neighbouring queries (4 at bf16, 2 at float32 with D = 32), and its lanes
// split over (query, point, channel group) as msda_cuda.win_geometry
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
// Design of K10 (msda_bwd_win_value_pp), redesigned for this card. What
// bounded the layout it replaces (one warp per (batch, head, query), the query
// fastest, lanes over D, per point each lane adding its channel of the four
// corner contributions with a scalar float32 atomicAdd, one band lookup a
// point), measured on the H100 at the adaptation's three banded levels
// (608x1008, window 16, batch 4, raster locations; bf16 / f32): 1.665 / 2.03
// ms; with each sample's adds sent to distinct rows 1.863 / 1.822; with no
// adds 0.940 / 0.911. Same-address contention on the clamped edge rows did not
// bound it (neighbouring samples share L2 sectors), but the serial per-lane
// walk (0.94 ms: the geometry and segment search worked out by all 32 lanes,
// the points in turn) and 32 scalar reductions a sample's corner. Here K8's
// lane map (msda_cuda.win_geometry, form "value") with at most four float32
// channels a lane and 32 / P queries a warp: lane l works out the band-local
// geometry of the warp's sample l once (its query's padded row through the
// segment table, its band row, the corners' add flags, the rounded x hats, the
// y hats times the weight, the pixel of its (absolute row y0, x0) corner) and
// the lanes that add the sample's channels take it with six __shfl_sync a pass
// (msda_bwd.cu's K3 hand-out); a lane adds a corner's four channels with one
// 16-byte vector reduction (red.global.add.v4.f32). The kernel adds into the
// caller's float32 slice of the layer's gradient, whose batch stride it takes,
// so the level's own zeroed buffer and its copy into the layer's gradient are
// gone. No warp-combined add: the measurement above shows no contention to
// save. It now takes 0.44x (bf16) and 0.37x (f32) of the old time; without its
// reductions it takes 0.23 of its 0.73 ms, so the L2's vector reductions bound
// it (at most 156 M 16-byte reductions over the three levels, some 310 G a
// second). Not kept (measured slower or within noise): two passes' shuffles
// and g loads together; a warp's samples point-major. The order of the
// additions changes from run to run, so the last bits of the float32 sums do
// too.
//
// K9 (msda_bwd_win_value) runs K10's kernel (msda_bwd_win_value_kernel), as
// K7 runs K8's: the JAX package's two value kernels (_bwd_dvtt_kernel_win,
// _bwd_dvtt_kernel_win_pp) add the same dT * hat_x products into the band,
// and under one band per tile every point takes its tile's band, so K9 is
// K10 with the band table's point stride zero. It takes K10's launch, adds
// into the caller's float32 slice of the layer's gradient as K10 does (the
// level's own zeroed buffer and its add into the layer's gradient are
// gone), and gives K10's sums given its tile bands broadcast over the
// points, up to the order of the float32 additions. The layout it replaces
// (the one K10's redesign replaced, with one band lookup a query) ran 29x
// off its bound: 1.611 ms at the adaptation's three banded levels (bf16,
// batch 4, with its zeroed buffer).
//
// Bound: memory. The rows (16 bytes per sample with g's share) and the
// corner rows (4 per sample, mostly L2 hits) dominate; the value kernels
// make 4 atomic row updates per sample into a gradient that fits the 50 MB
// L2 one image at a time. The band itself gains a gather nothing. A
// shared-memory copy of a band does not fit (a band of level 0 at D = 32 is
// 258 KB a head) or would take under one add a pixel from a block's
// queries, and shared float atomics are compare-and-swap loops on sm_90.
//
// C interface for ctypes: each function launches on the given stream and
// returns cudaGetLastError() as an int (0 = launched).

#include "msda_band.cuh"

// d hat / dt: -sign(t) inside the support, 0 outside and at the kink t = 0
__device__ __forceinline__ float hat_grad(float t) {
  if (!(fabsf(t) < 1.0f) || t == 0.0f) return 0.0f;
  return t > 0.0f ? -1.0f : 1.0f;
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

// K7 (PER_POINT false) and K8. The band of (b * H + head, point p, tile)
// is band_entry's: K8's [B, H, P, T] table, or K7's [B, H, T], whose every
// point takes its tile's band. Three blocks an SM (80 registers a thread,
// some spilled): on the H100 that measured 0.93x the time of two blocks an
// SM in float32, the same in bf16.
template <typename T, int VEC, bool PER_POINT>
__global__ void __launch_bounds__(256, 3)
msda_bwd_win_rows_kernel(const T* __restrict__ value,
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
      const int qp = padded_row(q, sg);
      t.r = (bh * g.P + p) * (long)g.Qp + qp;
      t.a = aw_eff[t.r];
      const int row0 =
          bidx[band_entry<PER_POINT>(g, bh, p, qp / g.TQ)] * half;
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

// K9 (PER_POINT false) and K10, the band of (b * H + head, point, tile) found
// as in K7 and K8: a warp takes (batch, head) and `queries` neighbouring
// queries (32 / P of them), one sample a lane for the hand-out. Lane l works
// out the band-local geometry of the warp's sample base + l once: the corners'
// add flags, the rounded x hats, the y hats times the weight, and the pixel of
// its (absolute row y0, x0) corner; the lanes that add the sample's channels
// take these from it with six __shfl_sync a pass. A lane adds VEC float32
// channels a corner with one vector reduction.
template <typename T, int VEC, bool PER_POINT>
__global__ void __launch_bounds__(256)
msda_bwd_win_value_kernel(const int* __restrict__ bidx,
                          const float* __restrict__ ix,
                          const float* __restrict__ iy_band,
                          const float* __restrict__ aw_eff,
                          const T* __restrict__ grad,
                          float* __restrict__ dvalue,
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
  const long rs = (long)g.H * g.D;       // stride between tokens
  float* db = dvalue + b * g.batch_stride + (long)head * g.D;
  const T* gb = grad + (b * g.Q * (long)g.H + head) * g.D;
  const int half = g.win / 2;

  for (int base = 0; base < ns; base += 32) {
    // lane l's sample base + l: its geometry, worked out once
    int px = 0, info = 0;  // info: the corners' add flags
    float hx0 = 0.0f, hx1 = 0.0f, c0 = 0.0f, c1 = 0.0f;
    {
      const int k = base + lane;
      const int qi = k / g.P, p = k - qi * g.P;
      const int q = q0 + qi;
      if (k < ns && q < g.Q) {
        const int qp = padded_row(q, sg);
        const long r = (bh * g.P + p) * (long)g.Qp + qp;
        const float a = aw_eff[r];
        if (a != 0.0f) {  // dT = 0: outside the image, or no weight
          const int row0 =
              bidx[band_entry<PER_POINT>(g, bh, p, qp / g.TQ)] * half;
          const Sample s = band_sample(ix[r], iy_band[r], row0, g);
          if (s.any) {
            hx0 = round_to<T>(hat(s.zx0));
            hx1 = round_to<T>(hat(s.zx1));
            c0 = __fmul_rn(hat(s.zy0), a);
            c1 = __fmul_rn(hat(s.zy1), a);
            // a zero weight adds nothing: skip that corner's adds
            info = (s.oky0 && s.okx0 && c0 != 0.0f && hx0 != 0.0f)
                 | (s.oky0 && s.okx1 && c0 != 0.0f && hx1 != 0.0f) << 1
                 | (s.oky1 && s.okx0 && c1 != 0.0f && hx0 != 0.0f) << 2
                 | (s.oky1 && s.okx1 && c1 != 0.0f && hx1 != 0.0f) << 3;
            px = (row0 + s.y0) * g.w + s.x0;
          }
        }
      }
    }
    const int np = min(lps, gm.passes - base / spp);
    for (int pp = 0; pp < np; ++pp) {
      const int src = pp * spp + slot;
      const int o = __shfl_sync(MSDA_FULL_MASK, px, src);
      const int f = __shfl_sync(MSDA_FULL_MASK, info, src);
      const float h0 = __shfl_sync(MSDA_FULL_MASK, hx0, src);
      const float h1 = __shfl_sync(MSDA_FULL_MASK, hx1, src);
      const float a0 = __shfl_sync(MSDA_FULL_MASK, c0, src);
      const float a1 = __shfl_sync(MSDA_FULL_MASK, c1, src);
      if (!f) continue;
      // the sample's query: flags are set only where it is real
      const T* gp = gb + (long)(q0 + (base + src) / g.P) * rs;
      float* r0 = db + (long)o * rs;
      float* r1 = r0 + (long)g.w * rs;
      for (int c = 0; c < gm.chunks; ++c) {
        const int grp = c * lps + sub;
        if (grp >= gm.groups) break;
        const int d = grp * VEC;
        Raw<T, VEC> gr;
        gr.load(gp + d);
        float dT0[VEC], dT1[VEC], add[VEC];
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const float gd = gr.get(j);
          dT0[j] = round_to<T>(__fmul_rn(a0, gd));
          dT1[j] = round_to<T>(__fmul_rn(a1, gd));
        }
        if (f & 1) {
#pragma unroll
          for (int j = 0; j < VEC; ++j) add[j] = dT0[j] * h0;
          red_add<VEC>(r0 + d, add);
        }
        if (f & 2) {
#pragma unroll
          for (int j = 0; j < VEC; ++j) add[j] = dT0[j] * h1;
          red_add<VEC>(r0 + rs + d, add);
        }
        if (f & 4) {
#pragma unroll
          for (int j = 0; j < VEC; ++j) add[j] = dT1[j] * h0;
          red_add<VEC>(r1 + d, add);
        }
        if (f & 8) {
#pragma unroll
          for (int j = 0; j < VEC; ++j) add[j] = dT1[j] * h1;
          red_add<VEC>(r1 + rs + d, add);
        }
      }
    }
  }
}

// K7 and K8: msda_bwd_win_rows_kernel in the tile or the point form.
// geometry: the nine ints of struct WGeom (msda_band.cuh), in its order.
static int launch_rows(const void* value, const void* bidx, const void* ix,
                       const void* iy_band, const void* aw_eff,
                       const void* grad, void* dix, void* diy, void* daw,
                       const int* segments, int n_segments, int B, int Q,
                       int Qp, int H, int D, int P, int h, int w, int win,
                       int TQ, long batch_stride, int is_bf16,
                       const int* geometry, int per_point, void* stream) {
  Segments sg;
  Geometry g;
  const int rc = read_band_geometry(segments, n_segments, Q, Qp, H, D, P, h,
                                    w, win, TQ, batch_stride, &sg, &g);
  if (rc != (int)cudaSuccess) return rc;
  if ((long)B * H * Q == 0) return (int)cudaSuccess;
  const WGeom gm = read_win_geometry(geometry);
  if (!win_geometry_ok(gm, (long)B * H, Q, D, P, is_bf16 ? 2 : 4, WIN_ROWS))
    return (int)cudaErrorInvalidValue;
  const long n_warps = (long)B * H * ((Q + gm.queries - 1) / gm.queries);
  cudaStream_t s = (cudaStream_t)stream;
  const int* bi = (const int*)bidx;
  const float *fx = (const float*)ix, *fy = (const float*)iy_band;
  const float* fa = (const float*)aw_eff;
  float *ox = (float*)dix, *oy = (float*)diy, *oa = (float*)daw;
#define MSDA_ROWS_FORM(T, VEC, PER_POINT)                                   \
  msda_bwd_win_rows_kernel<T, VEC, PER_POINT>                               \
      <<<gm.blocks, gm.threads, 0, s>>>((const T*)value, bi, fx, fy, fa,    \
                                        (const T*)grad, ox, oy, oa, sg, g,  \
                                        gm, n_warps)
#define MSDA_ROWS(T, VEC)                                                   \
  if (per_point)                                                            \
    MSDA_ROWS_FORM(T, VEC, true);                                           \
  else                                                                      \
    MSDA_ROWS_FORM(T, VEC, false)
  if (is_bf16) {
    switch (gm.vec) {
      case 8: MSDA_ROWS(__nv_bfloat16, 8); break;
      case 4: MSDA_ROWS(__nv_bfloat16, 4); break;
      case 2: MSDA_ROWS(__nv_bfloat16, 2); break;
      case 1: MSDA_ROWS(__nv_bfloat16, 1); break;
      default: return (int)cudaErrorInvalidValue;
    }
  } else {
    switch (gm.vec) {
      case 4: MSDA_ROWS(float, 4); break;
      case 2: MSDA_ROWS(float, 2); break;
      case 1: MSDA_ROWS(float, 1); break;
      default: return (int)cudaErrorInvalidValue;
    }
  }
#undef MSDA_ROWS
#undef MSDA_ROWS_FORM
  return (int)cudaGetLastError();
}

// dix, diy, daw: float32 [B, H, P, Q_pad]; the padding rows are not written.
// K7: bidx [B, H, T]. geometry: the nine ints of struct WGeom.
extern "C" int msda_bwd_win_rows(const void* value, const void* bidx,
                                 const void* ix, const void* iy_band,
                                 const void* aw_eff, const void* grad,
                                 void* dix, void* diy, void* daw,
                                 const int* segments, int n_segments, int B,
                                 int Q, int Qp, int H, int D, int P, int h,
                                 int w, int win, int TQ, long batch_stride,
                                 int is_bf16, const int* geometry,
                                 void* stream) {
  return launch_rows(value, bidx, ix, iy_band, aw_eff, grad, dix, diy, daw,
                     segments, n_segments, B, Q, Qp, H, D, P, h, w, win, TQ,
                     batch_stride, is_bf16, geometry, 0, stream);
}

// K8: bidx [B, H, P, T]; the rest as msda_bwd_win_rows.
extern "C" int msda_bwd_win_rows_pp(const void* value, const void* bidx,
                                    const void* ix, const void* iy_band,
                                    const void* aw_eff, const void* grad,
                                    void* dix, void* diy, void* daw,
                                    const int* segments, int n_segments,
                                    int B, int Q, int Qp, int H, int D, int P,
                                    int h, int w, int win, int TQ,
                                    long batch_stride, int is_bf16,
                                    const int* geometry, void* stream) {
  return launch_rows(value, bidx, ix, iy_band, aw_eff, grad, dix, diy, daw,
                     segments, n_segments, B, Q, Qp, H, D, P, h, w, win, TQ,
                     batch_stride, is_bf16, geometry, 1, stream);
}

// K9 and K10: msda_bwd_win_value_kernel in the tile or the point form.
// dvalue: float32 [B, h*w, H, D] with `out_batch_stride` elements between
// two batches (the level's slice of a layer's [B, S, H, D] gradient, or a
// buffer of its own); the kernel adds into it. geometry: the nine ints of
// struct WGeom (msda_band.cuh), in its order.
static int launch_value(const void* bidx, const void* ix,
                        const void* iy_band, const void* aw_eff,
                        const void* grad, void* dvalue, const int* segments,
                        int n_segments, int B, int Q, int Qp, int H, int D,
                        int P, int h, int w, int win, int TQ,
                        long out_batch_stride, int is_bf16,
                        const int* geometry, int per_point, void* stream) {
  Segments sg;
  Geometry g;
  const int rc = read_band_geometry(segments, n_segments, Q, Qp, H, D, P, h,
                                    w, win, TQ, out_batch_stride, &sg, &g);
  if (rc != (int)cudaSuccess) return rc;
  if ((long)B * H * Q == 0) return (int)cudaSuccess;
  const WGeom gm = read_win_geometry(geometry);
  // float32 adds of at most four channels a lane; the batches' slices
  // aligned to them and apart
  if (!win_geometry_ok(gm, (long)B * H, Q, D, P, 4, WIN_VALUE) ||
      out_batch_stride % gm.vec != 0 ||
      (B > 1 && out_batch_stride < (long)h * w * H * D))
    return (int)cudaErrorInvalidValue;
  const long n_warps = (long)B * H * ((Q + gm.queries - 1) / gm.queries);
  cudaStream_t s = (cudaStream_t)stream;
  const int* bi = (const int*)bidx;
  const float *fx = (const float*)ix, *fy = (const float*)iy_band;
  const float* fa = (const float*)aw_eff;
  float* dv = (float*)dvalue;
#define MSDA_VALUE_FORM(T, VEC, PER_POINT)                                  \
  msda_bwd_win_value_kernel<T, VEC, PER_POINT>                              \
      <<<gm.blocks, gm.threads, 0, s>>>(bi, fx, fy, fa, (const T*)grad, dv, \
                                        sg, g, gm, n_warps)
#define MSDA_VALUE(T, VEC)                                                  \
  if (per_point)                                                            \
    MSDA_VALUE_FORM(T, VEC, true);                                          \
  else                                                                      \
    MSDA_VALUE_FORM(T, VEC, false)
  if (is_bf16) {
    switch (gm.vec) {
      case 4: MSDA_VALUE(__nv_bfloat16, 4); break;
      case 2: MSDA_VALUE(__nv_bfloat16, 2); break;
      case 1: MSDA_VALUE(__nv_bfloat16, 1); break;
      default: return (int)cudaErrorInvalidValue;
    }
  } else {
    switch (gm.vec) {
      case 4: MSDA_VALUE(float, 4); break;
      case 2: MSDA_VALUE(float, 2); break;
      case 1: MSDA_VALUE(float, 1); break;
      default: return (int)cudaErrorInvalidValue;
    }
  }
#undef MSDA_VALUE
#undef MSDA_VALUE_FORM
  return (int)cudaGetLastError();
}

// K9: bidx [B, H, T]; the rest as launch_value.
extern "C" int msda_bwd_win_value(const void* bidx, const void* ix,
                                  const void* iy_band, const void* aw_eff,
                                  const void* grad, void* dvalue,
                                  const int* segments, int n_segments, int B,
                                  int Q, int Qp, int H, int D, int P, int h,
                                  int w, int win, int TQ,
                                  long out_batch_stride, int is_bf16,
                                  const int* geometry, void* stream) {
  return launch_value(bidx, ix, iy_band, aw_eff, grad, dvalue, segments,
                      n_segments, B, Q, Qp, H, D, P, h, w, win, TQ,
                      out_batch_stride, is_bf16, geometry, 0, stream);
}

// K10: bidx [B, H, P, T]; the rest as launch_value.
extern "C" int msda_bwd_win_value_pp(const void* bidx, const void* ix,
                                     const void* iy_band, const void* aw_eff,
                                     const void* grad, void* dvalue,
                                     const int* segments, int n_segments,
                                     int B, int Q, int Qp, int H, int D,
                                     int P, int h, int w, int win, int TQ,
                                     long out_batch_stride, int is_bf16,
                                     const int* geometry, void* stream) {
  return launch_value(bidx, ix, iy_band, aw_eff, grad, dvalue, segments,
                      n_segments, B, Q, Qp, H, D, P, h, w, win, TQ,
                      out_batch_stride, is_bf16, geometry, 1, stream);
}

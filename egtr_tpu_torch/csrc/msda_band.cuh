// What the banded kernels of msda_fwd_win.cu (K5, K6) and msda_bwd_win.cu
// (K7-K10) share: the query segment table, the level's geometry, the band
// table's strides, a sample's band-local corners and reach, and the launch
// of their lanes over (query, point, channel group) as
// msda_cuda.win_geometry says, with its check.

#pragma once

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
  // elements between two batches of the level's values (the value kernels:
  // of the level's gradient)
  long batch_stride;
};

static inline int read_band_geometry(const int* segments, int n_segments,
                                     int Q, int Qp, int H, int D, int P,
                                     int h, int w, int win, int TQ,
                                     long batch_stride, Segments* sg,
                                     Geometry* g) {
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

// Where a banded kernel finds the band of (b * H + head, point p, query
// tile): bidx[bh * bh_stride + p * p_stride + tile], with strides P * T and
// T for the point forms' [B, H, P, T] table (K6, K8, K10), T and 0 for the
// tile forms' [B, H, T] (K5, K7, K9), whose every point takes its tile's
// band. The form is a template flag of each kernel: strides read at run
// time cost K6 registers (more spills) and 4-9% of its time on the H100.
template <bool PER_POINT>
__device__ __forceinline__ long band_entry(const Geometry& g, long bh, int p,
                                           int tile) {
  return (PER_POINT ? bh * g.P + p : bh) * (long)g.T + tile;
}

// A query's row in the padded layout: its segment, each padded to tiles of
// TQ on its own.
__device__ __forceinline__ int padded_row(int q, const Segments& sg) {
  int s = 0;
  while (s + 1 < sg.n && q >= sg.q0[s + 1]) ++s;
  return sg.qp0[s] + (q - sg.q0[s]);
}

// One sample's band-local geometry.
struct Sample {
  float zx0, zx1, zy0, zy1;  // ix - x0, ix - x1, iy - y0, iy - y1
  int x0, y0;                // y0 band-local
  bool okx0, okx1, oky0, oky1;
  bool any;                  // some corner is within reach
};

// The reach of the TPU kernels: the hats are taken on the band-local
// coordinate, a corner whose band-local row lies outside [0, win) is
// dropped even where its absolute row exists, and so is one at or beyond
// row h (the last band's overhang).
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

// The launch of every banded kernel (K5-K10), the nine ints of
// msda_cuda.WinGeometry in its order. Warp n takes (batch, head) n /
// ceil(Q / queries) and the `queries` neighbouring queries from (n %
// ceil(Q / queries)) * queries on; lane l takes sample slot l >> lps_log2
// and channel group l & (lps - 1) (plus chunk * lps); in pass t its sample
// is t * (32 >> lps_log2) + slot, the warp's samples query-major (query
// k / P, point k % P). The forward with fold = 0 takes one query a slot
// instead, whose P points the lane walks.
struct WGeom {
  int vec;       // channels per lane load (K9, K10: float32 channels per
                 // add)
  int lps_log2;  // log2 of the lanes per sample
  int groups;    // D / vec channel groups
  int chunks;    // ceil(groups / lanes per sample)
  int queries;   // neighbouring queries a warp takes
  int passes;    // passes over the warp's samples
  int fold;      // K5, K6: 1 a query's P points lie in neighbouring slots
                 // of a pass and are folded with shuffles; 0 for K7-K10
  int threads;
  int blocks;
};

enum WinForm { WIN_ROWS = 0, WIN_FWD = 1, WIN_VALUE = 2 };

static inline WGeom read_win_geometry(const int* g) {
  return WGeom{g[0], g[1], g[2], g[3], g[4], g[5], g[6], g[7], g[8]};
}

// The geometry against the shapes (n_warps = B*H*ceil(Q / queries)), with
// `elem_bytes` the bytes of a channel as a lane loads it (K9, K10: 4, their
// float32 adds): anything the kernel's index math does not cover exactly
// once is refused.
static inline bool win_geometry_ok(const WGeom& g, long BH, int Q, int D,
                                   int P, int elem_bytes, WinForm form) {
  if (g.lps_log2 < 0 || g.lps_log2 > 5 || P < 1) return false;
  const int lps = 1 << g.lps_log2;
  const int spp = 32 / lps;
  if (g.vec < 1 || g.vec * elem_bytes > 16 || (g.vec & (g.vec - 1)))
    return false;
  if (g.groups * g.vec != D || g.chunks * lps < g.groups ||
      (g.chunks - 1) * lps >= g.groups)
    return false;
  if (g.fold != 0 && (form != WIN_FWD || g.fold != 1 || spp % P != 0))
    return false;
  const long samples = (long)g.queries * (form == WIN_FWD && !g.fold ? 1 : P);
  if (g.queries < 1 || g.passes < 0 || (long)g.passes * spp < samples)
    return false;
  if (g.threads < 32 || g.threads > 256 || g.threads % 32) return false;
  const long n_warps = BH * ((Q + g.queries - 1) / g.queries);
  const long per_block = g.threads / 32;
  return g.blocks >= 1 && (long)g.blocks * per_block >= n_warps &&
         (long)(g.blocks - 1) * per_block < n_warps;
}

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
// queries is float32 atomics into a buffer the wrapper zeroes.
//
// Both take a table of the levels to differentiate (the exact levels of a
// windowed call, whose banded levels msda_bwd_win.cu takes; all levels
// otherwise). The rows kernel writes only those levels' entries of dloc and
// daw, so the wrapper zeroes the outputs when the table is a subset.
//
// What bounds them on this card: the corner gathers (rows) and the corner
// adds (value). rows reads 4 corner rows per sample and does ~28 flops per
// value read; value makes 4 row adds per sample. The value tensor and its
// float32 gradient (11.4 MB and 22.9 MB per image at the 800x1344 bucket in
// bf16) fit the 50 MB L2 one image at a time, so most of the traffic is L2
// gathers (731 MB at the training encoder call) and L2 reductions (1.46 GB);
// device memory sees the inputs once and the gradient buffer twice (zeroing,
// final cast).
//
// rows, layout: msda_fwd.cu's lanes. A warp's 32 lanes split over (sample,
// channel group): a lane reads VEC consecutive channels of a corner with one
// vector load (16 bytes where D and the alignment of the value and
// output-gradient pointers allow it; narrower otherwise, chosen by the
// wrapper), LPS lanes cover a sample and two passes of 32 / LPS samples are
// unrolled, so at bf16 with D = 32 all 16 samples' corner loads are in
// flight together. One warp takes one row, and each lane reads its own
// sample's location and weight: msda_fwd.cu's walk over rows with the next
// row's entries handed out by shuffles raised this kernel's registers (128
// to 148-184 a thread) and measured slower. The lane's channels of the
// output gradient g are loaded once per row and kept in registers. A
// sample's three sums (dix, diy, daw) are folded over only that sample's
// LPS lanes with __shfl_xor_sync (2 rounds at bf16, D = 32, in a fixed
// order), and the sample's lanes then write its two dloc floats and its daw
// value, one each: the warp's stores of a pass are contiguous. No atomics:
// deterministic.
//
// value, what bounded the layout it replaces (one warp per row, lanes over
// D, every lane walking all 16 samples' geometry in turn, 64 scalar
// atomics a lane): measured on the H100 at the bf16 training encoder call,
// 0.567 ms; with its adds sent to distinct rows, uncontended, 0.570 ms;
// with no adds at all 0.351 ms. So neither contention nor the reduction
// bytes bound it first, but the serial walk: each warp's 16 dependent
// location loads and geometries, one sample after another.
//
// value, layout: K2's lanes, K1's hand-out. A block takes one (batch, head)
// and every query_chunks-th query from its chunk on, one warp a query in
// turn, as msda_cuda.value_geometry says. Lane l loads sample l's location
// and weight (one coalesced load each) and works out its geometry once: the
// corners' add flags, the rounded x hats, the y hats times the weight, and
// the offset of its (y0, x0) corner (its token, or its row in the block's
// shared copy). The lanes that add the sample's channels take these from
// it with six __shfl_sync a pass; where each of a sample's lanes worked
// them out itself, as K2 does, it measured 1.18x slower (bf16 training
// encoder call). A warp's lanes split over (sample, channel group) with at
// most four channels a lane, so that a lane's add is one 16-byte float32
// vector reduction (red.global.add.v4.f32, sm_90) and a sample's lanes
// cover whole 32-byte sectors of its corner row (eight bf16 channels a lane
// halved the sectors' use and measured 1.4x slower). The zero-weight and
// out-of-map skips stay. The coarsest level (13x21 at 800x1344: a quarter
// of all adds on 273 pixels a head, ~1,300 a pixel) is summed in a float32
// copy in the block's shared memory (D + 1 floats a pixel, so that a pass's
// samples spread over the banks) and added into the gradient once at the
// end with coalesced vector reductions; the others go straight to global
// memory. sm_90 has no shared float atomic add (atomicAdd compiles to a
// compare-and-swap loop, ATOMS.CAST.SPIN), so a copy pays only where many
// adds meet and the rest still go to L2: at the bf16 training encoder call
// keeping no level measured 1.30x the time of keeping the coarsest, the two
// coarsest (175 KB, one block an SM) 1.17x; in the exact train step K3 took
// 1.21x its time with no level kept, and in the adaptation step, whose
// encoder call takes one level, keeping that level took 1.13x the time of
// keeping none, so a call keeps at least one level in global memory. The
// float32 sums meet in no fixed order, so the last bits of the result
// change from run to run.
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

#include "msda_geom.cuh"

// the levels differentiated, and each one's index into the L axis
struct Levels {
  int n;
  int h[MSDA_MAX_LEVELS];
  int w[MSDA_MAX_LEVELS];
  int start[MSDA_MAX_LEVELS];
  int lid[MSDA_MAX_LEVELS];
};

// d hat / dt: -sign(t) inside the support, 0 outside and at the kink t = 0
__device__ __forceinline__ float hat_grad(float t) {
  if (!(fabsf(t) < 1.0f) || t == 0.0f) return 0.0f;
  return t > 0.0f ? -1.0f : 1.0f;
}

// One sample's geometry.
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

// One sample of a pass: its geometry, weights, and four corners' values.
template <typename T, int VEC>
struct RowSample {
  Sample s;
  int i;  // index into the row's L*P entries
  int hl, wl, start;
  float a;
  bool valid;  // the lane's sample exists
  Raw<T, VEC> v00, v01, v10, v11;
};

// Two blocks an SM: without the bound ptxas gives the bf16 form with 8
// channels a lane 180 registers a thread, one block an SM, and it runs 1.5x
// slower than at 128.
template <typename T, int VEC>
__global__ void __launch_bounds__(256, 2)
msda_bwd_rows_kernel(const T* __restrict__ value,
                     const float* __restrict__ loc, const T* __restrict__ aw,
                     const T* __restrict__ g, float* __restrict__ dloc,
                     T* __restrict__ daw, Levels lv, int L, int Q, int S,
                     int H, int D, int P, Geom gm, long n_rows) {
  __shared__ int tab[4 * MSDA_MAX_LEVELS];  // h, w, start, lid
  if (threadIdx.x < lv.n) {
    const int l = threadIdx.x;
    tab[4 * l] = lv.h[l];
    tab[4 * l + 1] = lv.w[l];
    tab[4 * l + 2] = lv.start[l];
    tab[4 * l + 3] = lv.lid[l];
  }
  __syncthreads();

  // one warp per row (the geometry's rows_per_warp is 1)
  const long row = (long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= n_rows) return;  // whole warps leave together
  // row = (b * Q + q) * H + head
  const int head = (int)(row % H);
  const long b = row / H / Q;
  const int lps = 1 << gm.lps_log2;
  const int spp = 32 >> gm.lps_log2;
  const int slot = lane >> gm.lps_log2;  // sample slot in a pass
  const int sub = lane & (lps - 1);      // channel group within a chunk
  const int ns = lv.n * P;
  const float* locp = loc + row * (long)(L * P * 2);
  const T* awp = aw + row * (long)(L * P);
  const T* gp = g + row * (long)D;
  float* dlocp = dloc + row * (long)(L * P * 2);
  T* dawp = daw + row * (long)(L * P);
  const long rs = (long)H * D;  // stride between tokens in value
  const T* vb = value + b * (long)S * rs + (long)head * D;

  // the lane's channels of g, for all samples (one chunk; more reload them)
  Raw<T, VEC> gr;
  gr.zero();
  if (gm.chunks == 1 && sub < gm.groups) gr.load(gp + sub * VEC);

  for (int ps = 0; ps < gm.passes; ps += MSDA_UNROLL) {
    RowSample<T, VEC> sm[MSDA_UNROLL];
#pragma unroll
    for (int u = 0; u < MSDA_UNROLL; ++u) {
      RowSample<T, VEC>& q = sm[u];
      const int s = (ps + u) * spp + slot;
      q.valid = s < ns;
      q.s.any = false;
      q.i = 0;
      q.hl = q.wl = q.start = 0;
      q.a = 0.0f;
      if (!q.valid) continue;
      const int k = s / P, p = s - k * P;
      const int* t = tab + 4 * k;
      q.hl = t[0];
      q.wl = t[1];
      q.start = t[2];
      q.i = t[3] * P + p;
      q.s = make_sample(locp[2 * q.i], locp[2 * q.i + 1], q.hl, q.wl);
      q.a = to_float(awp[q.i]);
    }
    float sums[MSDA_UNROLL][3];
#pragma unroll
    for (int u = 0; u < MSDA_UNROLL; ++u)
      sums[u][0] = sums[u][1] = sums[u][2] = 0.0f;

    for (int c = 0; c < gm.chunks; ++c) {
      const int grp = c * lps + sub;
      const bool on = grp < gm.groups;
      const int d = grp * VEC;
      if (gm.chunks > 1) {
        gr.zero();
        if (on) gr.load(gp + d);
      }
      // every corner load of the passes first
#pragma unroll
      for (int u = 0; u < MSDA_UNROLL; ++u) {
        RowSample<T, VEC>& q = sm[u];
        q.v00.zero(); q.v01.zero(); q.v10.zero(); q.v11.zero();
        if (!(on && q.valid && q.s.any)) continue;
        const T* vl = vb + (long)q.start * rs + d;
        if (q.s.oky0) {
          const T* r = vl + (long)q.s.y0 * q.wl * rs;
          if (q.s.okx0) q.v00.load(r + (long)q.s.x0 * rs);
          if (q.s.okx1) q.v01.load(r + (long)(q.s.x0 + 1) * rs);
        }
        if (q.s.oky1) {
          const T* r = vl + (long)(q.s.y0 + 1) * q.wl * rs;
          if (q.s.okx0) q.v10.load(r + (long)q.s.x0 * rs);
          if (q.s.okx1) q.v11.load(r + (long)(q.s.x0 + 1) * rs);
        }
      }
#pragma unroll
      for (int u = 0; u < MSDA_UNROLL; ++u) {
        const RowSample<T, VEC>& q = sm[u];
        if (!(on && q.valid && q.s.any)) continue;
        const float hx0 = round_to<T>(hat(q.s.zx0));
        const float hx1 = round_to<T>(hat(q.s.zx1));
        const float hy0 = hat(q.s.zy0), hy1 = hat(q.s.zy1);
        const float ghx0 = hat_grad(q.s.zx0), ghx1 = hat_grad(q.s.zx1);
        const float ghy0 = hat_grad(q.s.zy0), ghy1 = hat_grad(q.s.zy1);
        const float c0 = __fmul_rn(hy0, q.a), c1 = __fmul_rn(hy1, q.a);
        const float e0 = __fmul_rn(q.a, ghy0), e1 = __fmul_rn(q.a, ghy1);
        float s_dix = sums[u][0], s_diy = sums[u][1], s_daw = sums[u][2];
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const float gd = gr.get(j);
          const float v00 = q.v00.get(j), v01 = q.v01.get(j);
          const float v10 = q.v10.get(j), v11 = q.v11.get(j);
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
    // fold each sample's sums over its own lanes, in a fixed order; every
    // lane of the sample ends with the same sums
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
      const RowSample<T, VEC>& q = sm[u];
      if (!q.valid) continue;
      if (sub == 0) dlocp[2 * q.i] = __fmul_rn(sums[u][0], (float)q.wl);
      if (sub == lane_y)
        dlocp[2 * q.i + 1] = __fmul_rn(sums[u][1], (float)q.hl);
      if (sub == lane_a) dawp[q.i] = from_float<T>(sums[u][2]);
    }
  }
}

// K3's launch, the ten ints of msda_cuda.ValueGeometry in its order.
struct VGeom {
  int vec;           // channels per lane (g load, global reduction), <= 4
  int lps_log2;      // log2 of the lanes per sample
  int groups;        // D / vec channel groups
  int chunks;        // ceil(groups / lanes per sample)
  int passes;        // ceil(n * P / samples per pass)
  int private_mask;  // bit k: the table's level k is summed in shared memory
  int query_chunks;  // blocks per (batch, head)
  int threads;
  int blocks;
  int smem_bytes;    // the private levels, (D + 1) floats a pixel
};

static inline VGeom read_value_geometry(const int* g) {
  return VGeom{g[0], g[1], g[2], g[3], g[4], g[5], g[6], g[7], g[8], g[9]};
}

#define MSDA_MAX_DYNAMIC_SMEM 232448  // 227 KB a block (sm_90)

// The geometry against the shapes: anything the kernel's index math does not
// cover exactly once, or shared memory that does not hold the private levels
// as the kernel lays them out, is refused.
static bool value_geometry_ok(const VGeom& g, const Levels& lv, long B,
                              long Q, long H, int D, int P, int is_bf16) {
  if (g.lps_log2 < 0 || g.lps_log2 > 5) return false;
  const int lps = 1 << g.lps_log2;
  // at most four channels a lane: its reductions cover 16 bytes of float32
  if (g.vec < 1 || g.vec > 4 || (g.vec & (g.vec - 1))) return false;
  if (g.groups * g.vec != D || g.chunks * lps < g.groups ||
      (g.chunks - 1) * lps >= g.groups)
    return false;
  if (g.passes < 0 || (long)g.passes * (32 / lps) < (long)lv.n * P)
    return false;
  if (g.threads < 32 || g.threads > 1024 || g.threads % 32) return false;
  if (g.query_chunks < 1 || g.query_chunks > (Q > 1 ? Q : 1) ||
      (long)g.blocks != B * H * g.query_chunks)
    return false;
  if (g.private_mask < 0 || (g.private_mask >> lv.n) != 0) return false;
  long floats = 0;
  for (int k = 0; k < lv.n; ++k)
    if ((g.private_mask >> k) & 1) floats += (long)lv.h[k] * lv.w[k] * (D + 1);
  return g.smem_bytes == floats * 4 && g.smem_bytes <= MSDA_MAX_DYNAMIC_SMEM;
}

// 1024 threads, one block an SM where the private levels need more than half
// of its shared memory; 64 registers a thread.
template <typename T, int VEC>
__global__ void __launch_bounds__(1024, 1)
msda_bwd_value_kernel(const float* __restrict__ loc, const T* __restrict__ aw,
                      const T* __restrict__ g, float* __restrict__ dvalue,
                      Levels lv, int L, int Q, int S, int H, int D, int P,
                      VGeom gm) {
  extern __shared__ float priv[];  // the private levels, D + 1 floats a pixel
  // per level: h, w, start, lid, offset of its private copy (-1: global)
  __shared__ int tab[5 * MSDA_MAX_LEVELS];
  if (threadIdx.x == 0) {
    int off = 0;
    for (int k = 0; k < lv.n; ++k) {
      const bool mine = (gm.private_mask >> k) & 1;
      tab[5 * k] = lv.h[k];
      tab[5 * k + 1] = lv.w[k];
      tab[5 * k + 2] = lv.start[k];
      tab[5 * k + 3] = lv.lid[k];
      tab[5 * k + 4] = mine ? off : -1;
      if (mine) off += lv.h[k] * lv.w[k] * (D + 1);
    }
  }
  const int n_priv = gm.smem_bytes / 4;
  for (int i = threadIdx.x; i < n_priv; i += blockDim.x) priv[i] = 0.0f;
  __syncthreads();

  // block = (b * H + head) * query_chunks + chunk; the chunk's queries are
  // chunk, chunk + query_chunks, ..., one warp each in turn
  const int bh = blockIdx.x / gm.query_chunks;
  const int chunk = blockIdx.x - bh * gm.query_chunks;
  const int head = bh % H;
  const long b = bh / H;
  const int warps = blockDim.x >> 5;
  const int lane = threadIdx.x & 31;
  const int lps = 1 << gm.lps_log2;
  const int spp = 32 >> gm.lps_log2;
  const int slot = lane >> gm.lps_log2;  // sample slot in a pass
  const int sub = lane & (lps - 1);      // channel group within a chunk
  const int ns = lv.n * P;
  const int ps_px = D + 1;               // private floats a pixel
  const long rs = (long)H * D;           // stride between tokens
  const int rs32 = H * D;
  float* db = dvalue + b * (long)S * rs + (long)head * D;
  // lane l works out sample l of a row's first 32 (more: base + l): its
  // level-table entry and its index into the row's L*P entries, the same
  // for every row
  const int k_lane = lane < ns ? lane / P : 0;
  const int i_lane = tab[5 * k_lane + 3] * P + (lane - k_lane * P);

  for (long q = chunk + (long)(threadIdx.x >> 5) * gm.query_chunks; q < Q;
       q += (long)warps * gm.query_chunks) {
    const long row = (b * Q + q) * H + head;
    const float* locp = loc + row * (long)(L * P * 2);
    const T* awp = aw + row * (long)(L * P);
    const T* gp = g + row * (long)D;
    // a row's loads go out together: the lane's channels of g (one chunk;
    // more reload them) and one sample's location and weight a lane
    Raw<T, VEC> gr;
    gr.zero();
    if (gm.chunks == 1 && sub < gm.groups) gr.load(gp + sub * VEC);
    for (int base = 0; base < ns; base += 32) {
      // lane l's sample base + l: its geometry, worked out once, and then
      // handed out by shuffles to the lanes that add its channels
      const int sl = base + lane;
      int off = 0, info = 0;  // info: the corners' add flags, 16 private,
                              // the level's width from bit 8 on
      float hx0 = 0.0f, hx1 = 0.0f, c0 = 0.0f, c1 = 0.0f;
      if (sl < ns) {
        const int k = base == 0 ? k_lane : sl / P;
        const int i = base == 0 ? i_lane : tab[5 * k + 3] * P + (sl - k * P);
        const float a = to_float(awp[i]);
        const int* t = tab + 5 * k;
        const Sample s = make_sample(locp[2 * i], locp[2 * i + 1], t[0], t[1]);
        if (s.any && a != 0.0f) {
          hx0 = round_to<T>(hat(s.zx0));
          hx1 = round_to<T>(hat(s.zx1));
          c0 = __fmul_rn(hat(s.zy0), a);
          c1 = __fmul_rn(hat(s.zy1), a);
          // a zero weight adds nothing: skip that corner's adds
          info = (s.oky0 && s.okx0 && c0 != 0.0f && hx0 != 0.0f)
               | (s.oky0 && s.okx1 && c0 != 0.0f && hx1 != 0.0f) << 1
               | (s.oky1 && s.okx0 && c1 != 0.0f && hx0 != 0.0f) << 2
               | (s.oky1 && s.okx1 && c1 != 0.0f && hx1 != 0.0f) << 3;
          const int px = s.y0 * t[1] + s.x0;  // corner (y0, x0) in the level
          if (t[4] >= 0) {  // float index of its row in the block's copy
            off = t[4] + px * ps_px;
            info |= 16;
          } else {          // its token in the image
            off = t[2] + px;
          }
          info |= t[1] << 8;
        }
      }
      const int np = min(lps, gm.passes - base / spp);
      for (int pp = 0; pp < np; ++pp) {
        const int src = pp * spp + slot;
        const int o = __shfl_sync(MSDA_FULL_MASK, off, src);
        const int f = __shfl_sync(MSDA_FULL_MASK, info, src);
        const float h0 = __shfl_sync(MSDA_FULL_MASK, hx0, src);
        const float h1 = __shfl_sync(MSDA_FULL_MASK, hx1, src);
        const float a0 = __shfl_sync(MSDA_FULL_MASK, c0, src);
        const float a1 = __shfl_sync(MSDA_FULL_MASK, c1, src);
        if (!(f & 15)) continue;
        const bool do00 = f & 1, do01 = f & 2, do10 = f & 4, do11 = f & 8;
        const int wl = f >> 8;
        for (int c = 0; c < gm.chunks; ++c) {
          const int grp = c * lps + sub;
          if (grp >= gm.groups) break;
          const int d = grp * VEC;
          if (gm.chunks > 1) gr.load(gp + d);
          float dT0[VEC], dT1[VEC];
#pragma unroll
          for (int j = 0; j < VEC; ++j) {
            const float gd = gr.get(j);
            dT0[j] = round_to<T>(__fmul_rn(a0, gd));
            dT1[j] = round_to<T>(__fmul_rn(a1, gd));
          }
          if (f & 16) {  // the block's copy: shared-memory atomics
            float* r0 = priv + o + d;
            float* r1 = r0 + wl * ps_px;
#pragma unroll
            for (int j = 0; j < VEC; ++j) {
              if (do00) atomicAdd(r0 + j, dT0[j] * h0);
              if (do01) atomicAdd(r0 + ps_px + j, dT0[j] * h1);
              if (do10) atomicAdd(r1 + j, dT1[j] * h0);
              if (do11) atomicAdd(r1 + ps_px + j, dT1[j] * h1);
            }
          } else {  // global memory: vector reductions
            // 32-bit offsets within the image (the wrapper refuses 2**31
            // elements)
            float* r0 = db + (o * rs32 + d);
            float* r1 = r0 + wl * rs32;
            float add[VEC];
            if (do00) {
#pragma unroll
              for (int j = 0; j < VEC; ++j) add[j] = dT0[j] * h0;
              red_add<VEC>(r0, add);
            }
            if (do01) {
#pragma unroll
              for (int j = 0; j < VEC; ++j) add[j] = dT0[j] * h1;
              red_add<VEC>(r0 + rs32, add);
            }
            if (do10) {
#pragma unroll
              for (int j = 0; j < VEC; ++j) add[j] = dT1[j] * h0;
              red_add<VEC>(r1, add);
            }
            if (do11) {
#pragma unroll
              for (int j = 0; j < VEC; ++j) add[j] = dT1[j] * h1;
              red_add<VEC>(r1 + rs32, add);
            }
          }
        }
      }
    }
  }
  if (n_priv == 0) return;
  __syncthreads();
  // the block's copies into the gradient, once: coalesced vector reductions
  // of the pixels' D channels, a zero vector skipped
  const int fv = D % 4 == 0 ? 4 : (D % 2 == 0 ? 2 : 1);
  const int per_px = D / fv;
  for (int k = 0; k < lv.n; ++k) {
    const int* t = tab + 5 * k;
    if (t[4] < 0) continue;
    const float* src = priv + t[4];
    float* dst = db + (long)t[2] * rs;
    const int n = t[0] * t[1] * per_px;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const int px = i / per_px;
      const int c = (i - px * per_px) * fv;
      float v[4];
      bool any = false;
      for (int j = 0; j < fv; ++j) {
        v[j] = src[px * ps_px + c + j];
        any |= v[j] != 0.0f;
      }
      if (!any) continue;
      float* p = dst + (long)px * rs + c;
      if (fv == 4) red_add<4>(p, v);
      else if (fv == 2) red_add<2>(p, v);
      else red_add<1>(p, v);
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

template <typename T, int VEC>
static void launch_rows(const Geom& g, cudaStream_t s, const void* value,
                        const void* loc, const void* aw, const void* gr,
                        void* dloc, void* daw, const Levels& lv, int L, int Q,
                        int S, int H, int D, int P, long rows) {
  msda_bwd_rows_kernel<T, VEC><<<g.blocks, g.threads, 0, s>>>(
      (const T*)value, (const float*)loc, (const T*)aw, (const T*)gr,
      (float*)dloc, (T*)daw, lv, L, Q, S, H, D, P, g, rows);
}

template <typename T>
static int launch_rows_vec(const Geom& g, cudaStream_t s, const void* value,
                           const void* loc, const void* aw, const void* gr,
                           void* dloc, void* daw, const Levels& lv, int L,
                           int Q, int S, int H, int D, int P, long rows) {
  switch (g.vec) {
    case 8:
      if constexpr (sizeof(T) == 2) {
        launch_rows<T, 8>(g, s, value, loc, aw, gr, dloc, daw, lv, L, Q, S, H,
                          D, P, rows);
        return 0;
      }
      return 1;
    case 4:
      launch_rows<T, 4>(g, s, value, loc, aw, gr, dloc, daw, lv, L, Q, S, H,
                        D, P, rows);
      return 0;
    case 2:
      launch_rows<T, 2>(g, s, value, loc, aw, gr, dloc, daw, lv, L, Q, S, H,
                        D, P, rows);
      return 0;
    case 1:
      launch_rows<T, 1>(g, s, value, loc, aw, gr, dloc, daw, lv, L, Q, S, H,
                        D, P, rows);
      return 0;
  }
  return 1;
}

// geometry: the nine ints of struct Geom, in its order
extern "C" int msda_bwd_rows(const void* value, const void* loc,
                             const void* aw, const void* g, void* dloc,
                             void* daw, const int* levels, int n_levels,
                             int L, int B, int S, int Q, int H, int D, int P,
                             int is_bf16, const int* geometry, void* stream) {
  Levels lv;
  if (!read_levels(levels, n_levels, L, &lv))
    return (int)cudaErrorInvalidValue;
  const long rows = (long)B * Q * H;
  if (rows == 0) return (int)cudaSuccess;
  const Geom gm = read_geometry(geometry);
  // one row a warp, each lane reading its own sample's location and weight
  if (!geometry_ok(gm, rows, D, n_levels * P, L * P, is_bf16) ||
      gm.rows_per_warp != 1 || gm.handout != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int bad =
      is_bf16 ? launch_rows_vec<__nv_bfloat16>(gm, s, value, loc, aw, g, dloc,
                                               daw, lv, L, Q, S, H, D, P, rows)
              : launch_rows_vec<float>(gm, s, value, loc, aw, g, dloc, daw, lv,
                                       L, Q, S, H, D, P, rows);
  if (bad) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

template <typename T, int VEC>
static int launch_value(const VGeom& g, cudaStream_t s, const void* loc,
                        const void* aw, const void* gr, void* dvalue,
                        const Levels& lv, int L, int Q, int S, int H, int D,
                        int P) {
  auto kernel = msda_bwd_value_kernel<T, VEC>;
  // shared memory above 48 KB needs the kernel's consent first
  const cudaError_t rc = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, g.smem_bytes);
  if (rc != cudaSuccess) return (int)rc;
  kernel<<<g.blocks, g.threads, g.smem_bytes, s>>>(
      (const float*)loc, (const T*)aw, (const T*)gr, (float*)dvalue, lv, L,
      Q, S, H, D, P, g);
  return 0;
}

template <typename T>
static int launch_value_vec(const VGeom& g, cudaStream_t s, const void* loc,
                            const void* aw, const void* gr, void* dvalue,
                            const Levels& lv, int L, int Q, int S, int H,
                            int D, int P) {
  switch (g.vec) {
    case 4:
      return launch_value<T, 4>(g, s, loc, aw, gr, dvalue, lv, L, Q, S, H, D,
                                P);
    case 2:
      return launch_value<T, 2>(g, s, loc, aw, gr, dvalue, lv, L, Q, S, H, D,
                                P);
    case 1:
      return launch_value<T, 1>(g, s, loc, aw, gr, dvalue, lv, L, Q, S, H, D,
                                P);
  }
  return (int)cudaErrorInvalidValue;
}

// dvalue: float32 [B, S, H, D], zeroed by the caller. geometry: the ten ints
// of struct VGeom, in its order.
extern "C" int msda_bwd_value(const void* loc, const void* aw, const void* g,
                              void* dvalue, const int* levels, int n_levels,
                              int L, int B, int S, int Q, int H, int D, int P,
                              int is_bf16, const int* geometry, void* stream) {
  Levels lv;
  if (!read_levels(levels, n_levels, L, &lv))
    return (int)cudaErrorInvalidValue;
  if ((long)B * Q * H == 0) return (int)cudaSuccess;
  const VGeom gm = read_value_geometry(geometry);
  if (!value_geometry_ok(gm, lv, B, Q, H, D, P, is_bf16))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int rc =
      is_bf16 ? launch_value_vec<__nv_bfloat16>(gm, s, loc, aw, g, dvalue, lv,
                                                L, Q, S, H, D, P)
              : launch_value_vec<float>(gm, s, loc, aw, g, dvalue, lv, L, Q,
                                        S, H, D, P);
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}

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
// integer stage is bit-identical to the TPU kernel's: the products and their
// sum (at most 2 * 127 * 127) are exact in float32, so the kernel forms them
// with float multiply-adds. __float2int_rn rounds half to even, as jnp.round
// does. The pixel coordinate loc * size - 0.5 is rounded twice, as in JAX. A
// corner outside the map reads nothing (zero padding). The float32 fold
// differs from the TPU kernel's in the order of summation only. The
// quantization itself (max, scale, round to int8) is tensor code outside the
// kernel, as it is outside the Pallas body in the JAX package
// (msda.quantize_levels). The output is always float32 [B, Q, H, D]: the
// caller adds the parts of a windowed call and casts once.
//
// What bounds it on this card: the corner gathers and the walk to them. A
// (batch, query, head) row sums n * P samples of four corner rows of D int8
// channels; the values of a call (1.6 MB at the 608x1008 bucket) stay in
// L2, device memory sees the locations, weights and output once. The served
// encoder call sums one level (n * P = 4 samples a row). The layout this
// one replaced (one warp a row, lanes over D, one int8 channel a lane at
// D = 32, every lane working out every sample's geometry, the samples
// walked one after another) spent 64% of its 0.080 ms at the served
// encoder call on the walk alone: without its corner loads it took 0.052
// ms (H100).
//
// Layout, K1's (msda_fwd.cu) carried over to rows this short. A warp's 32
// lanes split over (sample slot, channel group) as msda_cuda.q_geometry
// says: a lane reads VEC int8 channels of a corner with one vector load (16
// bytes where D and the pointer allow it), LPS lanes (a power of two) cover
// a sample's D channels and SPP = 32 / LPS slots make a pass. A row takes
// ROW_SLOTS of a pass's slots (its samples over two passes, a power of two),
// so a warp sums SPP / ROW_SLOTS neighbouring rows at once: at D = 32 the
// served encoder call's 4-sample rows take 2 slots, and a warp sums 8 rows
// (a query's 8 heads) in two passes; the decoder call's 16-sample rows take
// 8 slots, 2 rows a warp, all 16 samples of a row in flight at once. A head
// dim wider than 32 groups loops over chunks of groups.
//
// Geometry, worked out once a sample. The passes go in groups of LPS (32
// samples: one a lane): lane l works out sample slot l % SPP of pass
// l / SPP of the group (its row's location and weight read once, its level
// from a shared table, the pixel coordinates, the corners' flags, the
// quantized hats of the contracted axis and the other axis's hats times
// aw * scale) and the lanes that read the sample's channels take it with
// five __shfl_sync: its corner token, the level's width, the flags and
// quantized hats in one int, and the two float weights. Two passes' corner
// loads go out before the first multiply-add.
//
// Fold, in a fixed order: each lane sums its samples in float32; a row's
// slots are folded with __shfl_xor_sync over the lane offsets LPS,
// 2 * LPS, ..., always in that order; the lanes of the row's first slot
// write its channels. One warp sums a whole row in an order that depends on
// the geometry alone: no atomics, the output is bit-equal from run to run.
//
// Index math in 32 bits (rows, a sample's entries, a corner's token): the
// wrapper refuses tensors of 2**31 elements, so it cannot overflow, and the
// 64-bit divisions for a row's batch and head cost about 8% at the served
// and all-level encoder calls. 80 registers a thread, three blocks an SM.
// Measured on the H100 (device time in turns with the old layout): the
// served encoder call 0.023 against 0.080 ms (0.29x), the int8 encoder call
// over all levels 0.086 against 0.301 (0.29x), the decoder call 0.0046
// against 0.0121 (0.38x); without its corner loads the served call takes
// 0.012 ms. Not kept: 8-byte loads (1.3x at the served call); a warp that
// walks 2 or 4 groups of rows with the next group's locations loaded ahead
// (0.93x over all levels, 1.5-3x at the decoder call); the compiler's own
// register count (103, two blocks an SM: 1.15x at the served call) and 64
// registers (spills: 1.12x there and at the decoder call at batch 2).
//
// C interface for ctypes: msda_fwd_q(...) launches on the given stream with
// the geometry that msda_cuda.q_geometry computed, checks it against the
// shapes, and returns cudaGetLastError() as an int (0 = launched).

#include "msda_geom.cuh"

struct Levels {
  int h[MSDA_MAX_LEVELS];
  int w[MSDA_MAX_LEVELS];
  int start[MSDA_MAX_LEVELS];
  int round_y[MSDA_MAX_LEVELS];  // 1: quantize the y hats (JAX orient "y")
  int lid[MSDA_MAX_LEVELS];      // index into the L axis of loc, aw, scale
};

// The launch geometry, the eight ints of msda_cuda.QGeometry in its order.
struct QGeom {
  int vec;         // int8 channels per lane load
  int lps_log2;    // log2 of the lanes per sample
  int groups;      // D / vec channel groups
  int chunks;      // ceil(groups / lanes per sample)
  int slots_log2;  // log2 of the slots a row takes in a pass
  int passes;      // ceil(n * P / slots a row)
  int threads;
  int blocks;
};

// The geometry against the shapes (rows = B*Q*H, ns = n*P samples a row):
// anything the kernel's index math does not cover exactly once is refused.
static inline bool q_geometry_ok(const QGeom& g, long rows, int D, int ns) {
  if (g.lps_log2 < 0 || g.lps_log2 > 5) return false;
  const int lps = 1 << g.lps_log2;
  if (g.vec < 1 || g.vec > 16 || (g.vec & (g.vec - 1))) return false;
  if (g.groups * g.vec != D || g.chunks * lps < g.groups ||
      (g.chunks - 1) * lps >= g.groups)
    return false;
  if (g.slots_log2 < 0 || g.slots_log2 > 5 - g.lps_log2) return false;
  if (g.passes < 0 || (long)g.passes << g.slots_log2 < ns) return false;
  if (g.threads < 32 || g.threads > 256 || g.threads % 32) return false;
  const long rows_per_warp = (32 >> g.lps_log2) >> g.slots_log2;
  const long per_block = (long)(g.threads / 32) * rows_per_warp;
  return g.blocks >= 1 && (long)g.blocks * per_block >= rows &&
         (long)(g.blocks - 1) * per_block < rows;
}

// round(127 * hat), half to even
__device__ __forceinline__ int quant_hat(float v) {
  return __float2int_rn(__fmul_rn(v, 127.0f));
}

// What a lane works out for one sample and hands to the sample's lanes:
// the token of its first corner in the level's contracted order (A0; A1 is
// one step along the contracted axis, B0 one along the other), the level's
// width, the corners' flags (bit 0 A0, 1 A1, 2 B0, 3 B1), the flip (bit 4)
// and the two quantized hats (bits 5-11, 12-18), and the other axis's hats
// times aw * scale.
struct QSample {
  int token, w, info;
  float c0, c1;
};

// Sample j of row ``row`` = (b * Q + q) * H + head, whose (b * H + head)
// is ``bh``. Every index fits 32 bits: the wrapper refuses location
// tensors of 2**31 elements.
template <typename A>
__device__ __forceinline__ QSample work_out(
    const int* tab, const float* __restrict__ loc, const A* __restrict__ aw,
    const float* __restrict__ scale, int row, int bh, int j, int L, int P) {
  QSample q{0, 0, 0, 0.0f, 0.0f};
  const int k = j / P, p = j - k * P;
  const int* t = tab + 5 * k;
  const int hl = t[0], wl = t[1], lid = t[4];
  const int i = (row * L + lid) * P + p;
  const float lx = loc[2 * i], ly = loc[2 * i + 1];
  const float a = __fmul_rn(to_float(aw[i]), scale[bh * L + lid]);
  const float fh = (float)hl, fw = (float)wl;
  const float ix = __fsub_rn(__fmul_rn(lx, fw), 0.5f);
  const float iy = __fsub_rn(__fmul_rn(ly, fh), 0.5f);
  const float fx0 = floorf(ix), fy0 = floorf(iy);
  const float fx1 = fx0 + 1.0f, fy1 = fy0 + 1.0f;
  const float wx0 = hat(ix - fx0), wx1 = hat(ix - fx1);
  const float wy0 = hat(iy - fy0), wy1 = hat(iy - fy1);
  // zero padding: a corner outside the map reads nothing
  const bool okx0 = fx0 >= 0.0f && fx0 <= fw - 1.0f;
  const bool okx1 = fx1 >= 0.0f && fx1 <= fw - 1.0f;
  const bool oky0 = fy0 >= 0.0f && fy0 <= fh - 1.0f;
  const bool oky1 = fy1 >= 0.0f && fy1 <= fh - 1.0f;
  if (!((okx0 || okx1) && (oky0 || oky1))) return q;
  const bool flip = t[3] != 0;
  int q0, q1, flags;
  if (flip) {  // contract y in integers, weight columns by hat_x * a
    q0 = quant_hat(wy0);
    q1 = quant_hat(wy1);
    q.c0 = __fmul_rn(wx0, a);
    q.c1 = __fmul_rn(wx1, a);
    flags = (okx0 && oky0) | (okx0 && oky1) << 1 | (okx1 && oky0) << 2 |
            (okx1 && oky1) << 3;
  } else {  // contract x in integers, weight rows by hat_y * a
    q0 = quant_hat(wx0);
    q1 = quant_hat(wx1);
    q.c0 = __fmul_rn(wy0, a);
    q.c1 = __fmul_rn(wy1, a);
    flags = (okx0 && oky0) | (okx1 && oky0) << 1 | (okx0 && oky1) << 2 |
            (okx1 && oky1) << 3;
  }
  // a corner within reach: the casts cannot overflow
  q.token = t[2] + (int)fy0 * wl + (int)fx0;
  q.w = wl;
  q.info = flags | (int)flip << 4 | q0 << 5 | q1 << 12;
  return q;
}

// One pass's sample as a lane reads it: its weights and its four corners.
template <int VEC>
struct QCorners {
  float q0, q1, c0, c1;
  bool any;
  Raw<int8_t, VEC> a0, a1, b0, b1;
};

// Write VEC float32 channels to p, in stores of up to 16 bytes.
template <int VEC>
__device__ __forceinline__ void store_f32(float* p, const float* v) {
  if constexpr (VEC % 4 == 0) {
#pragma unroll
    for (int k = 0; k < VEC; k += 4)
      *reinterpret_cast<float4*>(p + k) =
          make_float4(v[k], v[k + 1], v[k + 2], v[k + 3]);
  } else if constexpr (VEC == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    p[0] = v[0];
  }
}

// n: levels in the table; L: levels of loc, aw and scale. A: dtype of aw.
// Three blocks an SM (80 registers a thread, no spill at 16 channels a
// lane): on the H100 that measured 0.86x the time of the compiler's own
// choice (103 registers, two blocks an SM) at the served encoder call.
template <typename A, int VEC>
__global__ void __launch_bounds__(256, 3)
msda_fwd_q_kernel(const int8_t* __restrict__ vq,
                  const float* __restrict__ scale,
                  const float* __restrict__ loc, const A* __restrict__ aw,
                  float* __restrict__ out, Levels lv, int n, int L, int Q,
                  int S, int H, int D, int P, QGeom gm, long n_rows) {
  __shared__ int tab[5 * MSDA_MAX_LEVELS];  // h, w, start, round_y, lid
  if (threadIdx.x < n) {
    const int l = threadIdx.x;
    tab[5 * l] = lv.h[l];
    tab[5 * l + 1] = lv.w[l];
    tab[5 * l + 2] = lv.start[l];
    tab[5 * l + 3] = lv.round_y[l];
    tab[5 * l + 4] = lv.lid[l];
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int lps = 1 << gm.lps_log2;
  const int spp = 32 >> gm.lps_log2;
  const int slots = 1 << gm.slots_log2;
  const int rpw = spp >> gm.slots_log2;  // rows a warp sums
  const long first_l =
      (((long)blockIdx.x * blockDim.x + threadIdx.x) >> 5) * rpw;
  if (first_l >= n_rows) return;  // whole warps leave together
  // rows, and with them every index below, fit 32 bits
  const int first = (int)first_l, rows = (int)n_rows;
  const int ns = n * P;
  const int slot = lane >> gm.lps_log2;  // sample slot in a pass
  const int sub = lane & (lps - 1);      // channel group within a chunk
  const int row = first + (slot >> gm.slots_log2);  // the row this lane sums
  const bool row_on = row < rows;
  const int rs = H * D;  // stride between tokens in vq
  const int8_t* vb = vq + (long)(row / H / Q) * S * rs + (row % H) * D;
  // the sample lane l works out: slot l % spp of pass l / spp of a group
  const int mine_slot = lane & (spp - 1);
  const int mine_row = first + (mine_slot >> gm.slots_log2);
  const int mine_bh = mine_row / H / Q * H + mine_row % H;
  const int mine_j = ((lane >> (5 - gm.lps_log2)) << gm.slots_log2) +
                     (mine_slot & (slots - 1));

  for (int c = 0; c < gm.chunks; ++c) {
    const int grp = c * lps + sub;
    const bool on = row_on && grp < gm.groups;
    const int d = grp * VEC;
    float acc[VEC];
#pragma unroll
    for (int jj = 0; jj < VEC; ++jj) acc[jj] = 0.0f;

    for (int t0 = 0; t0 < gm.passes; t0 += lps) {
      QSample mine{0, 0, 0, 0.0f, 0.0f};
      {
        const int j = (t0 << gm.slots_log2) + mine_j;
        if (mine_row < rows && j < ns)
          mine = work_out(tab, loc, aw, scale, mine_row, mine_bh, j, L, P);
      }
      const int np = min(lps, gm.passes - t0);
      for (int u = 0; u < np; u += MSDA_UNROLL) {
        QCorners<VEC> sm[MSDA_UNROLL];
        // every corner load of the passes first
#pragma unroll
        for (int uu = 0; uu < MSDA_UNROLL; ++uu) {
          QCorners<VEC>& q = sm[uu];
          q.a0.zero(); q.a1.zero(); q.b0.zero(); q.b1.zero();
          q.any = false;
          q.q0 = q.q1 = q.c0 = q.c1 = 0.0f;
          if (u + uu >= np) continue;  // the same for the whole warp
          const int src = (u + uu) * spp + slot;
          const int token = __shfl_sync(MSDA_FULL_MASK, mine.token, src);
          const int w = __shfl_sync(MSDA_FULL_MASK, mine.w, src);
          const int info = __shfl_sync(MSDA_FULL_MASK, mine.info, src);
          q.c0 = __shfl_sync(MSDA_FULL_MASK, mine.c0, src);
          q.c1 = __shfl_sync(MSDA_FULL_MASK, mine.c1, src);
          q.any = on && (info & 15) != 0;
          if (!q.any) continue;
          q.q0 = (float)((info >> 5) & 127);
          q.q1 = (float)((info >> 12) & 127);
          const bool flip = (info >> 4) & 1;
          const int sa = (flip ? w : 1) * rs, sb = (flip ? 1 : w) * rs;
          const int8_t* p0 = vb + token * rs + d;
          if (info & 1) q.a0.load(p0);
          if (info & 2) q.a1.load(p0 + sa);
          if (info & 4) q.b0.load(p0 + sb);
          if (info & 8) q.b1.load(p0 + sa + sb);
        }
#pragma unroll
        for (int uu = 0; uu < MSDA_UNROLL; ++uu) {
          const QCorners<VEC>& q = sm[uu];
          if (!q.any) continue;
#pragma unroll
          for (int jj = 0; jj < VEC; ++jj) {
            // the integer stage, exact in float32
            const float t0s = fmaf(q.q0, q.a0.get(jj), q.q1 * q.a1.get(jj));
            const float t1s = fmaf(q.q0, q.b0.get(jj), q.q1 * q.b1.get(jj));
            acc[jj] += t0s * q.c0 + t1s * q.c1;
          }
        }
      }
    }
    // fold the row's slots: lanes l and l ^ off hold the same channel group
    // of two slots of one row; every lane takes part, in the same order
    // every time
    for (int off = lps; off < (lps << gm.slots_log2); off <<= 1) {
#pragma unroll
      for (int jj = 0; jj < VEC; ++jj)
        acc[jj] += __shfl_xor_sync(MSDA_FULL_MASK, acc[jj], off);
    }
    if (on && (slot & (slots - 1)) == 0)
      store_f32<VEC>(out + (long)row * D + d, acc);
  }
}

template <typename A>
static int launch(const QGeom& g, cudaStream_t s, const void* vq,
                  const void* scale, const void* loc, const void* aw,
                  void* out, const Levels& lv, int n, int L, int Q, int S,
                  int H, int D, int P, long rows) {
#define MSDA_Q(VEC)                                                         \
  msda_fwd_q_kernel<A, VEC><<<g.blocks, g.threads, 0, s>>>(                 \
      (const int8_t*)vq, (const float*)scale, (const float*)loc,            \
      (const A*)aw, (float*)out, lv, n, L, Q, S, H, D, P, g, rows)
  switch (g.vec) {
    case 16: MSDA_Q(16); return 0;
    case 8: MSDA_Q(8); return 0;
    case 4: MSDA_Q(4); return 0;
    case 2: MSDA_Q(2); return 0;
    case 1: MSDA_Q(1); return 0;
  }
#undef MSDA_Q
  return 1;
}

// geometry: the eight ints of struct QGeom, in its order
extern "C" int msda_fwd_q(const void* vq, const void* scale, const void* loc,
                          const void* aw, void* out, const int* levels, int n,
                          int L, int B, int S, int Q, int H, int D, int P,
                          int aw_bf16, const int* geometry, void* stream) {
  if (n < 1 || n > MSDA_MAX_LEVELS || L > MSDA_MAX_LEVELS)
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
  const long rows = (long)B * Q * H;
  if (rows == 0) return (int)cudaSuccess;
  const QGeom g{geometry[0], geometry[1], geometry[2], geometry[3],
                geometry[4], geometry[5], geometry[6], geometry[7]};
  if (!q_geometry_ok(g, rows, D, n * P)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int bad =
      aw_bf16 ? launch<__nv_bfloat16>(g, s, vq, scale, loc, aw, out, lv, n, L,
                                      Q, S, H, D, P, rows)
              : launch<float>(g, s, vq, scale, loc, aw, out, lv, n, L, Q, S,
                              H, D, P, rows);
  if (bad) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

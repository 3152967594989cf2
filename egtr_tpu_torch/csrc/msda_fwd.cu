// Exact multi-scale deformable attention forward for Hopper (sm_90a).
//
// Replaces egtr_tpu/ops/msda_pallas.py:_fwd_kernel / _fwd_body (the Pallas
// TPU kernel K1, launched once per level by _level_pallas_fwd). The TPU
// kernel builds dense separable "hat" vectors and contracts them on the MXU
// because the TPU has no fast gather; this card has one, so the kernel reads
// the two-by-two bilinear corners directly.
//
// What bounds it on this card: the corner gathers. Each (batch, query, head)
// row reads n*P samples x 4 corners x D channels and does ~10 flops per value
// read, far below the card's operations-per-byte ratio, so the tensor cores
// have nothing to do. The value tensor of one call (6.5 MB at the 608x1008
// bucket in bf16) stays in the 50 MB L2, so the corner reads are L2 gather
// traffic (417 MB at the serving encoder call); device memory sees the
// locations, weights and output once. A warp that walks its samples one
// after another, each a broadcast load of the location and then four
// dependent gathers, keeps few loads in flight and is latency-bound.
//
// Layout. A warp's 32 lanes split over (sample, channel group): a lane reads
// VEC consecutive channels of a corner with one vector load (16 bytes where
// D and the value pointer's alignment allow it: 8 bf16 or 4 float32
// channels; narrower loads otherwise, chosen by the wrapper), LPS lanes
// (a power of two) cover a sample's D channels and SPP = 32 / LPS samples go
// in one pass. Two passes are unrolled: at bf16 with D = 32 a pass holds 8
// samples (4 lanes each), and all 16 samples' 4 x 2 corner loads are issued
// before the first multiply-add. A head dim wider than 32 groups loops over
// chunks of groups.
//
// Locations and weights. A warp walks gm.rows_per_warp rows of its block's
// range one after another (two on the encoder calls, one on small calls:
// msda_cuda.rows_per_warp_for). Where a row's L*P*2 location floats fit one
// per lane (the model's 16 samples: 32 floats), lane k reads float k and
// weight k with one coalesced load each, and a lane takes its sample's (x,
// y, a) from their holders with __shfl_sync; the next row's are loaded
// before the current row's corner loads, so their latency hides behind
// them. A longer row reads each sample's entries from memory.
//
// Fold, in a fixed order: each lane sums its samples in float32; the warp's
// sample slots are folded with __shfl_xor_sync over the lane offsets LPS,
// 2*LPS, ..., 16, always in that order; the lanes of slot 0 write their
// channels (one coalesced 64-byte store at bf16, D = 32). One warp sums a
// whole row, so the order does not depend on the launch (a split of a row's
// samples over 2 or 4 warps, added through shared memory, measured slower
// at the decoder calls and was taken out). No atomics: the output is
// bit-equal from run to run.
//
// Rounding matches the JAX kernel: in bf16 the bilinear weights of the
// contracted axis (x, or y on levels where the JAX kernel flips its
// orientation) are rounded to bf16 before they multiply the values
// (msda_pallas.py:136); the other axis's weight times the attention weight
// stays float32 (__fmul_rn). The pixel coordinate loc*size - 0.5 is rounded
// twice, as in JAX, not fused into one multiply-add. A corner outside the map
// reads nothing (zero padding).
//
// A call may sum a subset of the levels (a windowed call sums its exact
// levels here and its banded ones in msda_fwd_win.cu): the level table names
// each level's index into the location and weight tensors. With out_f32 the
// float32 sum is written as it is, for the caller to add to the other parts
// before the one cast to the value dtype.
//
// C interface for ctypes: msda_fwd(...) launches on the given stream with the
// geometry that msda_cuda.launch_geometry computed, checks it against the
// shapes, and returns cudaGetLastError() as an int (0 = launched).

#include "msda_geom.cuh"

struct Levels {
  int h[MSDA_MAX_LEVELS];
  int w[MSDA_MAX_LEVELS];
  int start[MSDA_MAX_LEVELS];
  int round_y[MSDA_MAX_LEVELS];  // 1: round the y weights (JAX orient "y")
  int lid[MSDA_MAX_LEVELS];      // index into the L axis of loc and aw
};

// Write VEC floats as OutT to p, in stores of up to 16 bytes.
template <typename OutT, int VEC>
__device__ __forceinline__ void store_vec(OutT* p, const float* v) {
  constexpr int BYTES = (int)sizeof(OutT) * VEC;
  constexpr int WORDS = BYTES >= 4 ? BYTES / 4 : 1;
  uint32_t w[WORDS];
  if constexpr (sizeof(OutT) == 4) {
#pragma unroll
    for (int j = 0; j < VEC; ++j) w[j] = __float_as_uint(v[j]);
  } else {
#pragma unroll
    for (int k = 0; k < WORDS; ++k) w[k] = 0u;
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const uint32_t b = __bfloat16_as_ushort(__float2bfloat16_rn(v[j]));
      w[j >> 1] |= b << (16 * (j & 1));
    }
  }
  if constexpr (BYTES >= 16) {
#pragma unroll
    for (int k = 0; k < WORDS; k += 4) {
      reinterpret_cast<uint4*>(p)[k / 4] =
          make_uint4(w[k], w[k + 1], w[k + 2], w[k + 3]);
    }
  } else if constexpr (BYTES == 8) {
    *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
  } else if constexpr (BYTES == 4) {
    *reinterpret_cast<uint32_t*>(p) = w[0];
  } else {
    *reinterpret_cast<unsigned short*>(p) = (unsigned short)w[0];
  }
}

// One sample's weights and corner predicates, and its four corners' values.
template <typename T, int VEC>
struct Sample {
  float ca0, ca1;  // contracted axis's hats (rounded to T)
  float c0, c1;    // the other axis's hats times aw
  bool flip, any;
  Raw<T, VEC> v00, v01, v10, v11;
};

// n: levels in the table; L: levels of loc and aw
template <typename T, typename OutT, int VEC, bool HANDOUT>
__global__ void __launch_bounds__(256)
msda_fwd_kernel(const T* __restrict__ value, const float* __restrict__ loc,
                const T* __restrict__ aw, OutT* __restrict__ out, Levels lv,
                int n, int L, int Q, int S, int H, int D, int P, Geom gm,
                long n_rows) {
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

  const int wpb = blockDim.x >> 5, wib = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int lps = 1 << gm.lps_log2;
  const int spp = 32 >> gm.lps_log2;
  const int slot = lane >> gm.lps_log2;  // sample slot in a pass
  const int sub = lane & (lps - 1);      // channel group within a chunk
  const int ns = n * P, lp = L * P;
  const long rs = (long)H * D;  // stride between tokens in value
  // warp wib of a block walks rows first + j * wpb, j < rows_per_warp: the
  // block covers wpb * rows_per_warp consecutive rows
  const long first = (long)blockIdx.x * wpb * gm.rows_per_warp + wib;
  if (first >= n_rows) return;  // whole warps leave together
  RowIn<T, HANDOUT> next;
  next.load(loc, aw, first, lp, lane);

  for (int j = 0; j < gm.rows_per_warp; ++j) {
    const long row = first + (long)j * wpb;
    if (row >= n_rows) break;  // the same for every lane of the warp
    const RowIn<T, HANDOUT> in = next;
    // the next row's locations and weights load while this one computes
    if (j + 1 < gm.rows_per_warp && row + wpb < n_rows)
      next.load(loc, aw, row + wpb, lp, lane);
    // row = (b * Q + q) * H + head
    const int head = (int)(row % H);
    const long b = row / H / Q;
    const T* vb = value + b * (long)S * rs + (long)head * D;
    OutT* outp = out + row * (long)D;

    for (int c = 0; c < gm.chunks; ++c) {
      const int grp = c * lps + sub;
      const bool on = grp < gm.groups;
      const int d = grp * VEC;
      float acc[VEC];
#pragma unroll
      for (int jj = 0; jj < VEC; ++jj) acc[jj] = 0.0f;

      for (int ps = 0; ps < gm.passes; ps += MSDA_UNROLL) {
        Sample<T, VEC> sm[MSDA_UNROLL];
        // every location, weight and corner load of the passes first
#pragma unroll
        for (int u = 0; u < MSDA_UNROLL; ++u) {
          Sample<T, VEC>& q = sm[u];
          q.v00.zero(); q.v01.zero(); q.v10.zero(); q.v11.zero();
          q.any = false;
          q.flip = false;
          q.ca0 = q.ca1 = q.c0 = q.c1 = 0.0f;
          const int s = (ps + u) * spp + slot;
          const bool valid = on && s < ns;
          const int k = valid ? s / P : 0, p = valid ? s - k * P : 0;
          const int* t = tab + 5 * k;
          float lx, ly, a;
          in.get(t[4] * P + p, lx, ly, a);  // every lane, valid or not
          if (!valid) continue;
          const int hl = t[0], wl = t[1];
          const float fh = (float)hl, fw = (float)wl;
          const float ix = __fsub_rn(__fmul_rn(lx, fw), 0.5f);
          const float iy = __fsub_rn(__fmul_rn(ly, fh), 0.5f);
          const float fx0 = floorf(ix), fy0 = floorf(iy);
          const float fx1 = fx0 + 1.0f, fy1 = fy0 + 1.0f;
          const float wx0 = hat(ix - fx0), wx1 = hat(ix - fx1);
          const float wy0 = hat(iy - fy0), wy1 = hat(iy - fy1);
          q.flip = t[3] != 0;
          if (q.flip) {  // contract y, then weight each column by hat_x * aw
            q.ca0 = round_to<T>(wy0);
            q.ca1 = round_to<T>(wy1);
            q.c0 = __fmul_rn(wx0, a);
            q.c1 = __fmul_rn(wx1, a);
          } else {  // contract x, then weight each row by hat_y * aw
            q.ca0 = round_to<T>(wx0);
            q.ca1 = round_to<T>(wx1);
            q.c0 = __fmul_rn(wy0, a);
            q.c1 = __fmul_rn(wy1, a);
          }
          // zero padding: a corner outside the map reads nothing
          const bool okx0 = fx0 >= 0.0f && fx0 <= fw - 1.0f;
          const bool okx1 = fx1 >= 0.0f && fx1 <= fw - 1.0f;
          const bool oky0 = fy0 >= 0.0f && fy0 <= fh - 1.0f;
          const bool oky1 = fy1 >= 0.0f && fy1 <= fh - 1.0f;
          q.any = (okx0 || okx1) && (oky0 || oky1);
          if (!q.any) continue;
          const int x0 = (int)fx0, y0 = (int)fy0;
          const T* vl = vb + (long)t[2] * rs + d;
          if (oky0) {
            const T* rr = vl + (long)y0 * wl * rs;
            if (okx0) q.v00.load(rr + (long)x0 * rs);
            if (okx1) q.v01.load(rr + (long)(x0 + 1) * rs);
          }
          if (oky1) {
            const T* rr = vl + (long)(y0 + 1) * wl * rs;
            if (okx0) q.v10.load(rr + (long)x0 * rs);
            if (okx1) q.v11.load(rr + (long)(x0 + 1) * rs);
          }
        }
#pragma unroll
        for (int u = 0; u < MSDA_UNROLL; ++u) {
          const Sample<T, VEC>& q = sm[u];
          if (!q.any) continue;
#pragma unroll
          for (int jj = 0; jj < VEC; ++jj) {
            float t0, t1;
            if (q.flip) {
              t0 = q.ca0 * q.v00.get(jj) + q.ca1 * q.v10.get(jj);
              t1 = q.ca0 * q.v01.get(jj) + q.ca1 * q.v11.get(jj);
            } else {
              t0 = q.ca0 * q.v00.get(jj) + q.ca1 * q.v01.get(jj);
              t1 = q.ca0 * q.v10.get(jj) + q.ca1 * q.v11.get(jj);
            }
            acc[jj] += t0 * q.c0 + t1 * q.c1;
          }
        }
      }
      // fold the sample slots: lanes l and l ^ off hold the same channel
      // group of two slots; every lane takes part, in the same order every
      // time
      for (int off = lps; off < 32; off <<= 1) {
#pragma unroll
        for (int jj = 0; jj < VEC; ++jj)
          acc[jj] += __shfl_xor_sync(MSDA_FULL_MASK, acc[jj], off);
      }
      if (on && slot == 0) store_vec<OutT, VEC>(outp + d, acc);
    }
  }
}

template <typename T, typename OutT, int VEC>
static void launch(const Geom& g, cudaStream_t s, const void* value,
                   const void* loc, const void* aw, void* out,
                   const Levels& lv, int n, int L, int Q, int S, int H, int D,
                   int P, long rows) {
  if (g.handout) {
    msda_fwd_kernel<T, OutT, VEC, true><<<g.blocks, g.threads, 0, s>>>(
        (const T*)value, (const float*)loc, (const T*)aw, (OutT*)out, lv, n,
        L, Q, S, H, D, P, g, rows);
  } else {
    msda_fwd_kernel<T, OutT, VEC, false><<<g.blocks, g.threads, 0, s>>>(
        (const T*)value, (const float*)loc, (const T*)aw, (OutT*)out, lv, n,
        L, Q, S, H, D, P, g, rows);
  }
}

template <typename T, typename OutT>
static int launch_vec(const Geom& g, cudaStream_t s, const void* value,
                      const void* loc, const void* aw, void* out,
                      const Levels& lv, int n, int L, int Q, int S, int H,
                      int D, int P, long rows) {
  switch (g.vec) {
    case 8:
      if constexpr (sizeof(T) == 2) {
        launch<T, OutT, 8>(g, s, value, loc, aw, out, lv, n, L, Q, S, H, D, P,
                           rows);
        return 0;
      }
      return 1;
    case 4:
      launch<T, OutT, 4>(g, s, value, loc, aw, out, lv, n, L, Q, S, H, D, P,
                         rows);
      return 0;
    case 2:
      launch<T, OutT, 2>(g, s, value, loc, aw, out, lv, n, L, Q, S, H, D, P,
                         rows);
      return 0;
    case 1:
      launch<T, OutT, 1>(g, s, value, loc, aw, out, lv, n, L, Q, S, H, D, P,
                         rows);
      return 0;
  }
  return 1;
}

// geometry: the nine ints of struct Geom, in its order
extern "C" int msda_fwd(const void* value, const void* loc, const void* aw,
                        void* out, const int* levels, int n, int L, int B,
                        int S, int Q, int H, int D, int P, int is_bf16,
                        int out_f32, const int* geometry, void* stream) {
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
  const Geom g = read_geometry(geometry);
  if (!geometry_ok(g, rows, D, n * P, L * P, is_bf16))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  int bad;
  if (is_bf16 && out_f32) {
    bad = launch_vec<__nv_bfloat16, float>(g, s, value, loc, aw, out, lv, n,
                                           L, Q, S, H, D, P, rows);
  } else if (is_bf16) {
    bad = launch_vec<__nv_bfloat16, __nv_bfloat16>(g, s, value, loc, aw, out,
                                                   lv, n, L, Q, S, H, D, P,
                                                   rows);
  } else {
    bad = launch_vec<float, float>(g, s, value, loc, aw, out, lv, n, L, Q, S,
                                   H, D, P, rows);
  }
  if (bad) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// What the MSDA kernels msda_fwd (msda_fwd.cu), msda_bwd_rows and
// msda_bwd_value (msda_bwd.cu) and the banded kernels (msda_fwd_win.cu,
// msda_bwd_win.cu, through msda_band.cuh) share: the launch geometry that
// msda_cuda.launch_geometry computes for the first two and its check, the
// vector load of a channel group (float32, bfloat16 or int8), the float32
// vector reduction, the hand-out of a row's locations and weights, and the
// scalar helpers of the JAX kernels' rounding. The build keys each library
// by the headers' contents too, so an edit here rebuilds them all.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define MSDA_MAX_LEVELS 8
#define MSDA_UNROLL 2  // passes whose loads are issued together

// The launch geometry, the nine ints of msda_cuda.Geometry in its order.
struct Geom {
  int vec;            // channels per lane load
  int lps_log2;       // log2 of the lanes per sample
  int groups;         // D / vec channel groups
  int chunks;         // ceil(groups / lanes per sample)
  int passes;         // ceil(n * P / samples per pass)
  int handout;        // 1: a row's L*P*2 locations go one per lane
  int rows_per_warp;  // rows a warp walks, one after another
  int threads;
  int blocks;
};

static inline Geom read_geometry(const int* g) {
  return Geom{g[0], g[1], g[2], g[3], g[4], g[5], g[6], g[7], g[8]};
}

// The geometry against the shapes (rows = B*Q*H, ns = n*P samples summed, lp
// = L*P entries of a row in loc and aw): anything the kernels' index math
// does not cover exactly once is refused.
static inline bool geometry_ok(const Geom& g, long rows, int D, int ns,
                               int lp, int is_bf16) {
  if (g.lps_log2 < 0 || g.lps_log2 > 5) return false;
  const int lps = 1 << g.lps_log2;
  const int spp = 32 / lps;
  if (g.vec < 1 || g.vec * (is_bf16 ? 2 : 4) > 16 || (g.vec & (g.vec - 1)))
    return false;
  if (g.groups * g.vec != D || g.chunks * lps < g.groups ||
      (g.chunks - 1) * lps >= g.groups)
    return false;
  if (g.passes < 0 || (long)g.passes * spp < ns) return false;
  if ((g.handout != 0 && g.handout != 1) || (g.handout && 2 * lp > 32))
    return false;
  if (g.rows_per_warp < 1 || g.threads < 32 || g.threads > 256 ||
      g.threads % 32)
    return false;
  const long per_block = (long)(g.threads / 32) * g.rows_per_warp;
  return g.blocks >= 1 && (long)g.blocks * per_block >= rows &&
         (long)(g.blocks - 1) * per_block < rows;
}

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

// A float32 weight or product as the JAX kernels feed it to the MXU:
// rounded to T.
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_float(from_float<T>(v));
}

__device__ __forceinline__ float hat(float t) {
  return fmaxf(0.0f, 1.0f - fabsf(t));
}

// VEC values of T as raw 32-bit words, loaded with one vector load.
template <typename T, int VEC>
struct Raw {
  static constexpr int BYTES = (int)sizeof(T) * VEC;
  static constexpr int WORDS = BYTES >= 4 ? BYTES / 4 : 1;
  uint32_t w[WORDS];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int k = 0; k < WORDS; ++k) w[k] = 0u;
  }
  __device__ __forceinline__ void load(const T* p) {
    if constexpr (BYTES == 16) {
      const uint4 q = *reinterpret_cast<const uint4*>(p);
      w[0] = q.x; w[1] = q.y; w[2] = q.z; w[3] = q.w;
    } else if constexpr (BYTES == 8) {
      const uint2 q = *reinterpret_cast<const uint2*>(p);
      w[0] = q.x; w[1] = q.y;
    } else if constexpr (BYTES == 4) {
      w[0] = *reinterpret_cast<const uint32_t*>(p);
    } else if constexpr (BYTES == 2) {
      w[0] = *reinterpret_cast<const unsigned short*>(p);
    } else {
      w[0] = *reinterpret_cast<const unsigned char*>(p);
    }
  }
  // channel j as float32 (a bf16 is the high half of a float32; an int8
  // exactly)
  __device__ __forceinline__ float get(int j) const {
    if constexpr (sizeof(T) == 4) {
      return __uint_as_float(w[j]);
    } else if constexpr (sizeof(T) == 1) {
      return (float)(int8_t)((w[j >> 2] >> (8 * (j & 3))) & 0xffu);
    } else {
      return __uint_as_float(((w[j >> 1] >> (16 * (j & 1))) & 0xffffu) << 16);
    }
  }
};

#define MSDA_FULL_MASK 0xffffffffu

// N floats added to global memory: 16-byte vector reductions (sm_90,
// red.global.add.v4.f32) where N allows, else 8-byte or scalar ones. p is
// aligned to the vector.
template <int N>
__device__ __forceinline__ void red_add(float* p, const float* v) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int k = 0; k < N; k += 4)
      atomicAdd(reinterpret_cast<float4*>(p + k),
                make_float4(v[k], v[k + 1], v[k + 2], v[k + 3]));
  } else if constexpr (N == 2) {
    atomicAdd(reinterpret_cast<float2*>(p), make_float2(v[0], v[1]));
  } else {
    atomicAdd(p, v[0]);
  }
}

// A row's sampling locations and attention weights as the lanes take them.
// With HANDOUT (a row of at most 16 entries), lane k holds location float k
// and weight k, read with one coalesced load each, and a lane takes its
// sample's (x, y, a) from their holders with __shfl_sync: msda_fwd loads
// the next row's while the current one computes. Without, each lane reads
// its own sample's entries.
template <typename T, bool HANDOUT>
struct RowIn;

template <typename T>
struct RowIn<T, true> {
  float l, a;
  __device__ __forceinline__ void load(const float* loc, const T* aw,
                                       long row, int lp, int lane) {
    l = lane < 2 * lp ? loc[row * 2 * lp + lane] : 0.0f;
    a = lane < lp ? to_float(aw[row * lp + lane]) : 0.0f;
  }
  // every lane of the warp takes part
  __device__ __forceinline__ void get(int i, float& x, float& y,
                                      float& w) const {
    x = __shfl_sync(MSDA_FULL_MASK, l, 2 * i);
    y = __shfl_sync(MSDA_FULL_MASK, l, 2 * i + 1);
    w = __shfl_sync(MSDA_FULL_MASK, a, i);
  }
};

template <typename T>
struct RowIn<T, false> {
  const float* l;
  const T* a;
  __device__ __forceinline__ void load(const float* loc, const T* aw,
                                       long row, int lp, int) {
    l = loc + row * 2 * lp;
    a = aw + row * lp;
  }
  __device__ __forceinline__ void get(int i, float& x, float& y,
                                      float& w) const {
    x = l[2 * i];
    y = l[2 * i + 1];
    w = to_float(a[i]);
  }
};

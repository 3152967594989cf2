// Batched linear sum assignment (the Hungarian matcher's solver) for Hopper
// (sm_90a).
//
// Replaces egtr_tpu/ops/matcher.py:_lsa_single / hungarian_match: the JAX
// package's Jonker-Volgenant shortest-augmenting-path solver, vmapped over
// the batch and run inside the compiled step, so that the assignment never
// leaves the device. It is not a Pallas kernel there (XLA compiles the
// while loops), but it is device code on the training path all the same;
// on this card a CUDA graph cannot hold a host round trip, so the solver is
// a kernel.
//
// What it computes: per image b of cost [B, Q, G] float32 (rows = queries,
// columns = gt slots), the first nb = num_boxes[b] gt slots are solved in
// turn as rows of the transposed problem [G, Q] (JAX's costT), each by one
// shortest augmenting path with dual potentials u [G] and v [Q]. Outputs, as
// the JAX function returns them: query_index [B, G] (-1 on pad slots),
// matching_cost [B, G] = costT[b, g, max(query_index, 0)], gt_index [B, Q]
// (the inverse map of the solved slots, -1 elsewhere).
//
// Design, simple first: one block per image, the query columns strided over
// its threads (thread t takes columns t, t + T, ..., CPT of them, T = Q
// rounded up to a warp, at most 1024; the two-stage proposal matching has
// Q = S, some 22,000 columns, and CPT up to 32). A column's shortest-path
// cost, its potential v and its done flag live in its thread's registers;
// the row potentials u, col4row and the visited rows in shared memory, the
// path and row4col (the caller's gt_index) in global memory, since the walk
// back along the path and the next row of the search read other columns'
// entries. Each step of a search relaxes every column against the current
// row, then takes a block-wide argmin over (masked cost, column) that
// returns the FIRST column on ties, as jnp.argmin does; the found column's
// row4col names the next row, or ends the search. The dual updates follow
// rectangular_lsap's, written from the column side: a visited row k other
// than the current one is assigned, to the column j with row4col[j] == k,
// so j's thread updates u[k] with its own shortest-path cost. One thread
// walks the augmenting path back.
//
// Arithmetic: the same float32 operations in JAX's order,
// ((min_val + cost) - u[i]) - v[j], v[j] - (min_val - spc[j]) and
// (u[k] + min_val) - spc[j], each rounded on its own (__fadd_rn /
// __fsub_rn, which the compiler never contracts), so the kernel, its plain
// version (ops/matcher.py:lsap_plain) and the JAX solver agree bit for bit.
//
// Bound: neither bytes nor operations. The work is a chain of nb searches,
// each of a few steps, each step a block-wide reduction with two
// __syncthreads; one image reads its Q * G * 4 bytes of cost (77 KB at Q
// 300, G 64) from L1/L2 over and over. The sequence of steps, not the
// card's rates, sets the time: a later kernel may solve several images a
// block or keep the cost column in shared memory.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#define LSAP_MAX_THREADS 1024
#define LSAP_MAX_G 1024

namespace {

__device__ __forceinline__ bool better(float a, int ia, float b, int ib) {
  // a strictly smaller value, or the same value at a smaller column
  return a < b || (a == b && ia < ib);
}

__device__ __forceinline__ void warp_argmin(float& m, int& idx) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float om = __shfl_down_sync(0xffffffffu, m, off);
    const int oi = __shfl_down_sync(0xffffffffu, idx, off);
    if (better(om, oi, m, idx)) {
      m = om;
      idx = oi;
    }
  }
}

template <int CPT>
__global__ void __launch_bounds__(LSAP_MAX_THREADS)
lsap_kernel(const float* __restrict__ cost, const int* __restrict__ num_boxes,
            int Q, int G, int* __restrict__ path_g,
            int64_t* __restrict__ query_index,
            float* __restrict__ matching_cost,
            int64_t* __restrict__ gt_index) {
  __shared__ float u_s[LSAP_MAX_G];
  __shared__ int col4row_s[LSAP_MAX_G];
  __shared__ unsigned char visited_s[LSAP_MAX_G];
  __shared__ float red_val[32];
  __shared__ int red_idx[32];
  __shared__ float min_s;
  __shared__ int q_s;

  const int b = blockIdx.x;
  const int t = threadIdx.x;
  const int T = blockDim.x;
  const int lane = t & 31, warp = t >> 5;
  const int n_warps = (T + 31) >> 5;
  const float* C = cost + (size_t)b * Q * G;  // C[q * G + g]
  int* path = path_g + (size_t)b * Q;
  int64_t* row4col = gt_index + (size_t)b * Q;
  int nb = num_boxes[b];
  nb = nb < 0 ? 0 : (nb > G ? G : nb);

  for (int k = t; k < G; k += T) {
    u_s[k] = 0.f;
    col4row_s[k] = -1;
  }
  float v[CPT];
#pragma unroll
  for (int c = 0; c < CPT; ++c) {
    v[c] = 0.f;
    const int j = t + c * T;
    if (j < Q) row4col[j] = -1;
  }
  __syncthreads();

  for (int cur = 0; cur < nb; ++cur) {
    float spc[CPT];
    unsigned done = 0u;  // bit c: column t + c * T is done
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      spc[c] = CUDART_INF_F;
      const int j = t + c * T;
      if (j < Q) path[j] = -1;
    }
    for (int k = t; k < G; k += T) visited_s[k] = 0;
    int i = cur;
    float min_val = 0.f;
    int sink = -1;
    __syncthreads();
    while (true) {
      if (t == 0) visited_s[i] = 1;
      const float u_i = u_s[i];
      // relax this thread's columns; their first minimum, done ones aside
      // (a column not done always remains: a search ends after at most
      // cur + 1 <= G <= Q steps)
      float m = CUDART_INF_F;
      int idx = 0x7fffffff;
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const int j = t + c * T;
        if (j < Q && !((done >> c) & 1u)) {
          const float r = __fsub_rn(
              __fsub_rn(__fadd_rn(min_val, C[(size_t)j * G + i]), u_i), v[c]);
          if (r < spc[c]) {
            spc[c] = r;
            path[j] = i;
          }
          if (better(spc[c], j, m, idx)) {
            m = spc[c];
            idx = j;
          }
        }
      }
      warp_argmin(m, idx);
      if (lane == 0) {
        red_val[warp] = m;
        red_idx[warp] = idx;
      }
      __syncthreads();
      if (warp == 0) {
        m = lane < n_warps ? red_val[lane] : CUDART_INF_F;
        idx = lane < n_warps ? red_idx[lane] : 0x7fffffff;
        warp_argmin(m, idx);
        if (lane == 0) {
          min_s = m;
          q_s = idx;
        }
      }
      __syncthreads();
      const int q = q_s;
      min_val = min_s;
      if (q % T == t) done |= 1u << (q / T);
      const int nxt = (int)row4col[q];
      if (nxt < 0) {
        sink = q;
        break;
      }
      i = nxt;
    }
    // dual updates (rectangular_lsap's), before the path changes row4col
    if (t == 0) u_s[cur] = __fadd_rn(u_s[cur], min_val);
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int j = t + c * T;
      if (j < Q) {
        const int k = (int)row4col[j];
        if (k >= 0 && k != cur && visited_s[k])
          u_s[k] = __fsub_rn(__fadd_rn(u_s[k], min_val), spc[c]);
        if ((done >> c) & 1u) v[c] = __fsub_rn(v[c], __fsub_rn(min_val, spc[c]));
      }
    }
    __syncthreads();
    // augment along the alternating path from the sink back to cur
    if (t == 0) {
      int jj = sink;
      int ii = -1;
      while (ii != cur) {
        ii = path[jj];
        row4col[jj] = ii;
        const int jn = col4row_s[ii];
        col4row_s[ii] = jj;
        jj = jn;
      }
    }
    __syncthreads();
  }

  // every assigned row is a solved slot (< nb), so row4col, written in
  // place in gt_index, is already the inverse map of the real slots
  for (int k = t; k < G; k += T) {
    const int c = col4row_s[k];
    query_index[(size_t)b * G + k] = c;
    matching_cost[(size_t)b * G + k] = C[(size_t)(c < 0 ? 0 : c) * G + k];
  }
}

}  // namespace

// cost [B, Q, G] float32, num_boxes [B] int32, path [B, Q] int32 scratch,
// outputs query_index [B, G] int64, matching_cost [B, G] float32, gt_index
// [B, Q] int64; all contiguous. threads: Q rounded up to a warp, at most
// 1024; cpt: columns a thread, 1-32, a power of two, threads * cpt >= Q
// (msda_cuda.lsap_geometry). Returns a CUDA error code (0 on success);
// launches on ``stream`` and does not synchronise.
extern "C" int lsap(const void* cost, const void* num_boxes, void* path,
                    void* query_index, void* matching_cost, void* gt_index,
                    int B, int Q, int G, int threads, int cpt, void* stream) {
  if (B < 1 || Q < 1 || G < 0 || G > Q || G > LSAP_MAX_G || threads < 32 ||
      threads > LSAP_MAX_THREADS || threads % 32 != 0 ||
      (long)threads * cpt < Q)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(B), block(threads);
  cudaStream_t s = (cudaStream_t)stream;
  const float* c = (const float*)cost;
  const int* n = (const int*)num_boxes;
  int* p = (int*)path;
  int64_t* qi = (int64_t*)query_index;
  float* mc = (float*)matching_cost;
  int64_t* gi = (int64_t*)gt_index;
  switch (cpt) {
    case 1: lsap_kernel<1><<<grid, block, 0, s>>>(c, n, Q, G, p, qi, mc, gi); break;
    case 2: lsap_kernel<2><<<grid, block, 0, s>>>(c, n, Q, G, p, qi, mc, gi); break;
    case 4: lsap_kernel<4><<<grid, block, 0, s>>>(c, n, Q, G, p, qi, mc, gi); break;
    case 8: lsap_kernel<8><<<grid, block, 0, s>>>(c, n, Q, G, p, qi, mc, gi); break;
    case 16: lsap_kernel<16><<<grid, block, 0, s>>>(c, n, Q, G, p, qi, mc, gi); break;
    case 32: lsap_kernel<32><<<grid, block, 0, s>>>(c, n, Q, G, p, qi, mc, gi); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

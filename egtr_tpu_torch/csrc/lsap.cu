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
// The time is a chain of dependent search steps (nb searches of a few steps
// each; ties make them long), so the design cuts the latency of one step.
// A step relaxes every query column against the current row and takes the
// first minimum of the columns not yet done. Two routes
// (msda_cuda.lsap_geometry picks one):
//
// - "warp" (the cost of an image fits in shared memory: Q 200 and 300 at
//   G 64): one block an image stages the rows it solves, transposed as
//   costT [G, Q], into shared memory once (every thread, cp.async); then
//   one warp searches, lane l taking columns l, l + 32, ...: a step reads a
//   contiguous row, relaxes its columns without a branch (spc, v, path and
//   the done flags in registers) and reduces without a block barrier (two
//   redux.sync instructions).
// - "cluster" (Q = S, the two-stage proposal matching: some 22,000
//   columns): a thread-block cluster an image, up to 16 blocks, each taking
//   a contiguous slice of the columns and holding as many of its costT rows
//   in shared memory as fit (the others are read from the cost in global
//   memory). Each warp puts its first minimum into a slot of its block's
//   shared memory; after one cluster barrier every warp reads all slots
//   through distributed shared memory and takes the same minimum. row4col
//   lives with the block that owns the column; the row state (u, col4row,
//   ...) is kept alike in every block, which all walk the augmenting path.
//
// The first minimum: a value's order key (its float bits made monotone,
// -0 read as +0) and the column in one 64-bit key, the smallest key being
// the smallest value and, on ties, the first column, as jnp.argmin gives.
// When a step reaches row k through column q (q is done from then on), it
// records what the search's end needs of q: spc[q], for k's dual update
// (reach[k]), and path[q], for the walk (from[k]). So the walk never reads
// a column's path, and no block reads another's spc or path.
//
// Arithmetic: the same float32 operations in JAX's order,
// ((min_val + cost) - u[i]) - v[j], v[j] - (min_val - spc[j]) and
// (u[k] + min_val) - spc[j], each rounded on its own (__fadd_rn /
// __fsub_rn, which the compiler never contracts), so the kernel, its plain
// version (ops/matcher.py:lsap_plain) and the JAX solver agree bit for bit.
//
// Bound: neither bytes nor operations. One image reads its Q * G * 4 bytes
// once; the sequence of steps, each a chain of dependent loads, adds and
// reductions (and a cluster barrier), sets the time.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace cg = cooperative_groups;

#define LSAP_MAX_G 1024
#define LSAP_STAGE_THREADS 256    // warp route: the threads that stage
#define LSAP_CLUSTER_THREADS 256  // cluster route: a block's threads
#define LSAP_CLUSTER_WARPS (LSAP_CLUSTER_THREADS / 32)
#define LSAP_MAX_CLUSTER 16
#define LSAP_MAX_SMEM (227 * 1024)
#define LSAP_NONE 0xffffffffu
#define LSAP_FULL 0xffffffffu

namespace {

// a warp's first minimum: its order key, column, value, and two rows as
// 16-bit halves (G <= 1024): the one that holds the column (row4col, -1 if
// free) and the one the column was last relaxed from (its path)
struct __align__(16) Cand {
  unsigned key;
  unsigned col;
  float val;
  unsigned rows;  // (nxt & 0xffff) | (path << 16)
};

__device__ __forceinline__ unsigned pack_rows(int nxt, int path) {
  return ((unsigned)nxt & 0xffffu) | ((unsigned)path << 16);
}

__device__ __forceinline__ unsigned order_key(float x) {
  const unsigned b = __float_as_uint(__fadd_rn(x, 0.0f));  // -0 -> +0
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ unsigned long long pack(unsigned key,
                                                   unsigned col) {
  return ((unsigned long long)key << 32) | col;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// costT rows [0, rows) of columns [j0, j0 + w) of one image's cost [Q, G]
// into cs [rows][pitch]: a warp a column, its lanes over the rows (reads
// of a cost row, writes to banks g * pitch + jl, distinct for an odd
// pitch)
__device__ __forceinline__ void stage(float* cs, int pitch,
                                      const float* __restrict__ C, int G,
                                      int j0, int w, int rows) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  for (int jl = warp; jl < w; jl += warps)
    for (int g = lane; g < rows; g += 32)
      cp_async4(cs + (size_t)g * pitch + jl, C + (size_t)(j0 + jl) * G + g);
}

// the warp's first minimum of its lanes' keys: (key, column); the lane
// that holds it is the one whose ``best`` equals the result
__device__ __forceinline__ unsigned long long warp_first_min(
    unsigned long long best) {
  const unsigned hi = (unsigned)(best >> 32);
  const unsigned top = __reduce_min_sync(LSAP_FULL, hi);
  const unsigned col =
      __reduce_min_sync(LSAP_FULL, hi == top ? (unsigned)best : LSAP_NONE);
  return pack(top, col);
}

// One step's relaxation of a thread's CPT columns (column c at row[c *
// stride]; ``live`` bit c: the column exists and is not done), without a
// branch, so that the columns' chains of dependent adds overlap: the row's
// entries are loaded first, then relaxed, spc and path kept in registers.
// Returns the thread's first minimum as (order key, c, spc, path) in key,
// c_best, val and pth; columns later in c lose ties, so the first column
// wins.
template <int CPT>
__device__ __forceinline__ void relax(const float* row, int stride,
                                      unsigned live, float min_val, float u_i,
                                      const float (&v)[CPT], float (&spc)[CPT],
                                      int (&path)[CPT], int i, unsigned& key,
                                      int& c_best, float& val, int& pth) {
  float x[CPT];
#pragma unroll
  for (int c = 0; c < CPT; ++c)
    x[c] = ((live >> c) & 1u) ? row[c * stride] : 0.f;
  unsigned k[CPT];
  int at[CPT], p[CPT];
  float m[CPT];
#pragma unroll
  for (int c = 0; c < CPT; ++c) {
    const float r = __fsub_rn(__fsub_rn(__fadd_rn(min_val, x[c]), u_i), v[c]);
    const bool on = (live >> c) & 1u;
    const bool upd = on && r < spc[c];
    spc[c] = upd ? r : spc[c];
    path[c] = upd ? i : path[c];
    k[c] = on ? order_key(spc[c]) : LSAP_NONE;
    at[c] = c;
    m[c] = spc[c];
    p[c] = path[c];
  }
  // a tree over c; on equal keys the lower c stays
#pragma unroll
  for (int d = 1; d < CPT; d *= 2) {
#pragma unroll
    for (int c = 0; c + d < CPT; c += 2 * d) {
      const bool right = k[c + d] < k[c];
      k[c] = right ? k[c + d] : k[c];
      at[c] = right ? at[c + d] : at[c];
      m[c] = right ? m[c + d] : m[c];
      p[c] = right ? p[c + d] : p[c];
    }
  }
  key = k[0];
  c_best = at[0];
  val = m[0];
  pth = p[0];
}

// The augmenting path from the sink column back to row cur: column j's
// path row ii takes j, and the path goes on from the column ii held,
// whose path row is from[ii] (recorded when ii was reached). row4col
// (indexed by column - j0, or nullptr where another block owns the column,
// up to j0 + w) gets the new rows. A row -1 (a column never relaxed) can
// only come from costs that are not finite: the walk stops there rather
// than leave the arrays.
__device__ __forceinline__ void augment(int* row4col, int* col4row,
                                        const int* from, int j, int ii,
                                        int cur, int j0 = 0,
                                        int w = 0x7fffffff) {
  while (ii >= 0) {
    const int jn = col4row[ii];
    const int fn = from[ii];
    if (j >= j0 && j - j0 < w) row4col[j - j0] = ii;
    col4row[ii] = j;
    if (ii == cur) break;
    j = jn;
    ii = fn;
  }
}

// the shared-memory layout of the warp route
struct WarpSmem {
  float* cs;            // [G][pitch] costT rows
  int* row4col;         // [Q]
  float* u;             // [G]
  float* reach;         // [G]
  int* col4row;         // [G]
  int* visited;         // [G]: the search (cur + 1) that visited it
  int* from;            // [G]: a reached row's column's path (see walk)
};

template <int CPT>
__global__ void __launch_bounds__(LSAP_STAGE_THREADS)
lsap_warp_kernel(const float* __restrict__ cost,
                 const int* __restrict__ num_boxes, int Q, int G, int pitch,
                 int64_t* __restrict__ query_index,
                 float* __restrict__ matching_cost,
                 int64_t* __restrict__ gt_index) {
  extern __shared__ __align__(16) unsigned char smem[];
  WarpSmem s;
  s.cs = (float*)smem;
  s.row4col = (int*)(s.cs + (size_t)G * pitch);
  s.u = (float*)(s.row4col + Q);
  s.reach = s.u + G;
  s.col4row = (int*)(s.reach + G);
  s.visited = s.col4row + G;
  s.from = s.visited + G;

  const int b = blockIdx.x;
  const int t = threadIdx.x;
  const float* C = cost + (size_t)b * Q * G;
  int nb = num_boxes[b];
  nb = nb < 0 ? 0 : (nb > G ? G : nb);

  // only the solved rows (< nb) are ever read
  stage(s.cs, pitch, C, G, 0, Q, nb);
  for (int k = t; k < Q; k += blockDim.x) s.row4col[k] = -1;
  for (int k = t; k < G; k += blockDim.x) {
    s.u[k] = 0.f;
    s.col4row[k] = -1;
    s.visited[k] = 0;
  }
  cp_async_wait_all();
  __syncthreads();
  if (t >= 32) return;  // one warp searches

  const int lane = t;
  float v[CPT];
#pragma unroll
  for (int c = 0; c < CPT; ++c) v[c] = 0.f;

  unsigned in_q = 0u;  // bit c: column lane + 32 c exists
#pragma unroll
  for (int c = 0; c < CPT; ++c)
    if (lane + 32 * c < Q) in_q |= 1u << c;

  for (int cur = 0; cur < nb; ++cur) {
    float spc[CPT];
    int path[CPT];  // the row each column was last relaxed from
    unsigned done = 0u;  // bit c: column lane + 32 c is done
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      spc[c] = CUDART_INF_F;
      path[c] = -1;
    }
    if (lane == 0) s.visited[cur] = cur + 1;
    int i = cur;
    float min_val = 0.f;
    int sink, sink_from;
    while (true) {
      unsigned key;
      int c_best, pth;
      float val;
      relax<CPT>(s.cs + (size_t)i * pitch + lane, 32, in_q & ~done, min_val,
                 s.u[i], v, spc, path, i, key, c_best, val, pth);
      // a column not done always remains: a search ends after at most
      // cur + 1 <= G <= Q steps
      const int q = (int)(unsigned)warp_first_min(
          pack(key, (unsigned)(lane + 32 * c_best)));
      min_val = __shfl_sync(LSAP_FULL, val, q & 31);
      const int q_from = __shfl_sync(LSAP_FULL, pth, q & 31);
      if ((q & 31) == lane) done |= 1u << (q >> 5);
      const int nxt = s.row4col[q];
      if (nxt < 0) {
        sink = q;
        sink_from = q_from;
        break;
      }
      if (lane == 0) {
        // q is done from now on: its spc and path are final
        s.visited[nxt] = cur + 1;
        s.reach[nxt] = min_val;
        s.from[nxt] = q_from;
      }
      i = nxt;
    }
    __syncwarp();
    // dual updates (rectangular_lsap's), before the path changes row4col
    for (int k = lane; k < G; k += 32) {
      const bool seen = s.visited[k] == cur + 1;
      const float u_k = s.u[k], at_k = s.reach[k];
      if (k == cur)
        s.u[k] = __fadd_rn(u_k, min_val);
      else if (seen)
        s.u[k] = __fsub_rn(__fadd_rn(u_k, min_val), at_k);
    }
#pragma unroll
    for (int c = 0; c < CPT; ++c)
      if ((done >> c) & 1u) v[c] = __fsub_rn(v[c], __fsub_rn(min_val, spc[c]));
    // augment along the alternating path from the sink back to cur
    if (lane == 0) augment(s.row4col, s.col4row, s.from, sink, sink_from, cur);
    __syncwarp();
  }

  // every assigned row is a solved slot (< nb), so row4col is already the
  // inverse map of the real slots
  for (int k = lane; k < G; k += 32) {
    const int c = s.col4row[k];
    query_index[(size_t)b * G + k] = c;
    matching_cost[(size_t)b * G + k] = C[(size_t)(c < 0 ? 0 : c) * G + k];
  }
  for (int j = lane; j < Q; j += 32) gt_index[(size_t)b * Q + j] = s.row4col[j];
}

template <int CPT>
__global__ void __launch_bounds__(LSAP_CLUSTER_THREADS)
lsap_cluster_kernel(const float* __restrict__ cost,
                    const int* __restrict__ num_boxes, int Q, int G, int W,
                    int pitch, int rows_max,
                    int64_t* __restrict__ query_index,
                    float* __restrict__ matching_cost,
                    int64_t* __restrict__ gt_index) {
  extern __shared__ __align__(16) unsigned char smem[];
  Cand* cand = (Cand*)smem;  // [2][LSAP_CLUSTER_WARPS], by step parity
  float* cs = (float*)(cand + 2 * LSAP_CLUSTER_WARPS);  // [rows_max][pitch]
  int* row4col = (int*)(cs + (size_t)rows_max * pitch);  // [W]
  float* u = (float*)(row4col + W);                      // [G]
  float* reach = u + G;                                  // [G]
  int* col4row = (int*)(reach + G);                      // [G]
  int* visited = col4row + G;  // [G]: the search (cur + 1) that visited it
  int* from = visited + G;     // [G]: a reached row's column's path

  cg::cluster_group cluster = cg::this_cluster();
  const int n_blocks = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.x / n_blocks;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int j0 = rank * W;  // this block's columns: [j0, j0 + w)
  const int w = Q - j0 < W ? (Q - j0 > 0 ? Q - j0 : 0) : W;
  const float* C = cost + (size_t)b * Q * G;
  int nb = num_boxes[b];
  nb = nb < 0 ? 0 : (nb > G ? G : nb);
  const int rows = nb < rows_max ? nb : rows_max;

  stage(cs, pitch, C, G, j0, w, rows);
  for (int k = t; k < W; k += LSAP_CLUSTER_THREADS) row4col[k] = -1;
  for (int k = t; k < G; k += LSAP_CLUSTER_THREADS) {
    u[k] = 0.f;
    col4row[k] = -1;
    visited[k] = 0;
  }
  // the slots this lane reads in the exchange: slot lane + 32 r of the
  // cluster's (block k / warps, warp k % warps), mapped once
  constexpr int kSlotReads =
      LSAP_MAX_CLUSTER * LSAP_CLUSTER_WARPS / 32;
  const int n_slots = n_blocks * LSAP_CLUSTER_WARPS;
  const Cand* slot_of[kSlotReads];
#pragma unroll
  for (int r = 0; r < kSlotReads; ++r) {
    const int k = lane + 32 * r;
    slot_of[r] = k < n_slots
                     ? cluster.map_shared_rank(cand + k % LSAP_CLUSTER_WARPS,
                                               k / LSAP_CLUSTER_WARPS)
                     : nullptr;
  }
  unsigned in_w = 0u;  // bit c: local column t + c * threads exists
#pragma unroll
  for (int c = 0; c < CPT; ++c)
    if (t + c * LSAP_CLUSTER_THREADS < w) in_w |= 1u << c;
  cp_async_wait_all();
  // every block of the cluster runs (its shared memory may be read) and
  // has staged its slice
  cluster.sync();

  float v[CPT];
#pragma unroll
  for (int c = 0; c < CPT; ++c) v[c] = 0.f;
  unsigned step = 0;  // the candidate slots alternate by step

  for (int cur = 0; cur < nb; ++cur) {
    float spc[CPT];
    int path_r[CPT];  // the row each column was last relaxed from
    unsigned done = 0u;  // bit c: local column t + c * threads is done
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      spc[c] = CUDART_INF_F;
      path_r[c] = -1;
    }
    if (t == 0) visited[cur] = cur + 1;
    int i = cur;
    float min_val = 0.f;
    int sink, sink_from;
    while (true) {
      unsigned key;
      int c_best, pth;
      float val;
      // a staged row from shared memory, else the cost in global memory
      const bool staged = i < rows;
      relax<CPT>(staged ? cs + (size_t)i * pitch + t
                        : C + (size_t)(j0 + t) * G + i,
                 staged ? LSAP_CLUSTER_THREADS : LSAP_CLUSTER_THREADS * G,
                 in_w & ~done, min_val, u[i], v, spc, path_r, i, key, c_best,
                 val, pth);
      // the warp's first minimum into its slot, by the lane that holds it
      const int jl = t + c_best * LSAP_CLUSTER_THREADS;
      const unsigned long long mine = pack(key, (unsigned)(j0 + jl));
      const unsigned long long wmin = warp_first_min(mine);
      const int parity = (step & 1) * LSAP_CLUSTER_WARPS;
      Cand* slot = cand + parity + warp;
      if ((unsigned)(wmin >> 32) == LSAP_NONE) {
        if (lane == 0) *slot = Cand{LSAP_NONE, LSAP_NONE, CUDART_INF_F, LSAP_NONE};
      } else if (mine == wmin) {
        *slot = Cand{key, (unsigned)(j0 + jl), val,
                     pack_rows(row4col[jl], pth)};
      }
      cluster.sync();
      // every warp: the first minimum of all the cluster's slots, the
      // lane's reads issued together
      int4 raw[kSlotReads];
#pragma unroll
      for (int r = 0; r < kSlotReads; ++r)
        raw[r] = slot_of[r] ? *reinterpret_cast<const int4*>(
                                  slot_of[r] + parity)
                            : make_int4(-1, -1, 0, -1);
      unsigned long long cbest = ~0ull;
      float cval = CUDART_INF_F;
      unsigned crows = 0xffffffffu;
#pragma unroll
      for (int r = 0; r < kSlotReads; ++r) {
        const unsigned long long k =
            pack((unsigned)raw[r].x, (unsigned)raw[r].y);
        if (k < cbest) {
          cbest = k;
          cval = __int_as_float(raw[r].z);
          crows = (unsigned)raw[r].w;
        }
      }
      ++step;
      const unsigned long long m = warp_first_min(cbest);
      const int src_lane = __ffs(__ballot_sync(LSAP_FULL, cbest == m)) - 1;
      min_val = __shfl_sync(LSAP_FULL, cval, src_lane);
      const unsigned rows2 = __shfl_sync(LSAP_FULL, crows, src_lane);
      const int nxt = (int)(short)(rows2 & 0xffffu);
      const int q_from = (int)(short)(rows2 >> 16);
      const int q = (int)(unsigned)m;
      const int ql = q - j0;
      if (ql >= 0 && ql < w && ql % LSAP_CLUSTER_THREADS == t)
        done |= 1u << (ql / LSAP_CLUSTER_THREADS);
      if (nxt < 0) {
        sink = q;
        sink_from = q_from;
        break;
      }
      if (t == 0) {
        // q is done from now on: its spc and path are final
        visited[nxt] = cur + 1;
        reach[nxt] = min_val;
        from[nxt] = q_from;
      }
      i = nxt;
    }
    __syncthreads();
    // dual updates (rectangular_lsap's), alike in every block
    for (int k = t; k < G; k += LSAP_CLUSTER_THREADS) {
      const bool seen = visited[k] == cur + 1;
      const float u_k = u[k], at_k = reach[k];
      if (k == cur)
        u[k] = __fadd_rn(u_k, min_val);
      else if (seen)
        u[k] = __fsub_rn(__fadd_rn(u_k, min_val), at_k);
    }
#pragma unroll
    for (int c = 0; c < CPT; ++c)
      if ((done >> c) & 1u) v[c] = __fsub_rn(v[c], __fsub_rn(min_val, spc[c]));
    // every block walks the augmenting path: its col4row, and row4col of
    // its own columns
    if (t == 0) augment(row4col, col4row, from, sink, sink_from, cur, j0, w);
    __syncthreads();
  }

  if (rank == 0) {
    for (int k = t; k < G; k += LSAP_CLUSTER_THREADS) {
      const int c = col4row[k];
      query_index[(size_t)b * G + k] = c;
      matching_cost[(size_t)b * G + k] = C[(size_t)(c < 0 ? 0 : c) * G + k];
    }
  }
  for (int jl = t; jl < w; jl += LSAP_CLUSTER_THREADS)
    gt_index[(size_t)b * Q + j0 + jl] = row4col[jl];
  // no block leaves while another may still read its shared memory
  cluster.sync();
}

// the launch geometry msda_cuda.LsapGeometry passes, field by field
struct Geom {
  int route;     // 0 warp, 1 cluster
  int cluster;   // blocks an image
  int threads;   // a block's
  int cpt;       // columns a thread
  int width;     // columns a block (W)
  int pitch;     // floats between staged rows
  int rows;      // costT rows a block holds in shared memory
  int smem;      // dynamic shared-memory bytes
};

// the shared-memory bytes of a route's layout, as the kernels lay it out
long smem_bytes(const Geom& g, int Q, int G) {
  if (g.route == 0)
    return 4L * G * g.pitch + 4L * Q + 20L * G;
  return (long)sizeof(Cand) * 2 * LSAP_CLUSTER_WARPS +
         4L * g.rows * g.pitch + 4L * g.width + 20L * G;
}

// the geometry covers the work once and fits the card
bool geometry_ok(const Geom& g, int Q, int G) {
  if (g.smem < smem_bytes(g, Q, G) || g.smem > LSAP_MAX_SMEM || g.cpt < 1 ||
      g.cpt > 32)
    return false;
  if (g.route == 0)
    return g.cluster == 1 && g.threads == LSAP_STAGE_THREADS &&
           32L * g.cpt >= Q && g.width == Q && g.rows == G &&
           (g.pitch & 1) && g.pitch >= Q;
  if (g.route == 1)
    return g.cluster >= 1 && g.cluster <= LSAP_MAX_CLUSTER &&
           g.threads == LSAP_CLUSTER_THREADS &&
           (long)g.threads * g.cpt >= g.width &&
           (long)g.width * g.cluster >= Q &&
           (long)g.width * (g.cluster - 1) < Q && g.rows >= 0 &&
           g.rows <= G && g.pitch >= g.width;
  return false;
}

template <int CPT>
cudaError_t launch_warp(const Geom& g, int B, const float* c, const int* n,
                        int Q, int G, int64_t* qi, float* mc, int64_t* gi,
                        cudaStream_t s) {
  auto kernel = lsap_warp_kernel<CPT>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, g.smem);
  if (e != cudaSuccess) return e;
  kernel<<<B, g.threads, g.smem, s>>>(c, n, Q, G, g.pitch, qi, mc, gi);
  return cudaGetLastError();
}

template <int CPT>
cudaError_t launch_cluster(const Geom& g, int B, const float* c,
                           const int* n, int Q, int G, int64_t* qi,
                           float* mc, int64_t* gi, cudaStream_t s) {
  auto kernel = lsap_cluster_kernel<CPT>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, g.smem);
  if (e == cudaSuccess && g.cluster > 8)
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * g.cluster);
  cfg.blockDim = dim3(g.threads);
  cfg.dynamicSmemBytes = g.smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = g.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, c, n, Q, G, g.width, g.pitch, g.rows,
                         qi, mc, gi);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace

#define LSAP_WARP_CASE(N) \
  case N: return (int)launch_warp<N>(g, B, c, n, Q, G, qi, mc, gi, s);
#define LSAP_CLUSTER_CASE(N) \
  case N: return (int)launch_cluster<N>(g, B, c, n, Q, G, qi, mc, gi, s);

// cost [B, Q, G] float32, num_boxes [B] int32, outputs query_index [B, G]
// int64, matching_cost [B, G] float32, gt_index [B, Q] int64; all
// contiguous. geom: the eight ints of msda_cuda.LsapGeometry (route,
// cluster, threads, cpt, width, pitch, rows, smem). Returns a CUDA error
// code (0 on success); launches on ``stream`` and does not synchronise.
extern "C" int lsap(const void* cost, const void* num_boxes,
                    void* query_index, void* matching_cost, void* gt_index,
                    int B, int Q, int G, const int* geom, void* stream) {
  const Geom g{geom[0], geom[1], geom[2], geom[3],
               geom[4], geom[5], geom[6], geom[7]};
  if (B < 1 || Q < 1 || G < 0 || G > Q || G > LSAP_MAX_G ||
      !geometry_ok(g, Q, G))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const float* c = (const float*)cost;
  const int* n = (const int*)num_boxes;
  int64_t* qi = (int64_t*)query_index;
  float* mc = (float*)matching_cost;
  int64_t* gi = (int64_t*)gt_index;
  if (g.route == 0) {
    switch (g.cpt) {
      LSAP_WARP_CASE(1) LSAP_WARP_CASE(2) LSAP_WARP_CASE(3)
      LSAP_WARP_CASE(4) LSAP_WARP_CASE(5) LSAP_WARP_CASE(6)
      LSAP_WARP_CASE(7) LSAP_WARP_CASE(8) LSAP_WARP_CASE(10)
      LSAP_WARP_CASE(12) LSAP_WARP_CASE(16) LSAP_WARP_CASE(20)
      LSAP_WARP_CASE(24) LSAP_WARP_CASE(28) LSAP_WARP_CASE(32)
      default: return (int)cudaErrorInvalidValue;
    }
  }
  switch (g.cpt) {
    LSAP_CLUSTER_CASE(1) LSAP_CLUSTER_CASE(2) LSAP_CLUSTER_CASE(3)
    LSAP_CLUSTER_CASE(4) LSAP_CLUSTER_CASE(6) LSAP_CLUSTER_CASE(8)
    LSAP_CLUSTER_CASE(12) LSAP_CLUSTER_CASE(16)
    default: return (int)cudaErrorInvalidValue;
  }
}

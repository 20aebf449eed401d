// The fused LargeVis edge step for Hopper (sm_90a).
//
// Replaces the Pallas kernel repro/kernels/largevis_step.py::
// fused_edge_step (_kernel, _forces, _kernel_tiled): one SGD update of the
// (N, s) embedding over a batch of B sampled edges with M negatives each.
// Every gather happens before any update (the Pallas grid (2, tiles) runs
// all of phase 0 before phase 1), and updates to the same row accumulate
// in the canonical per-edge order [i_e, j_e, negs_e,0..M-1].
//   Bound: memory and launch latency.  A step reads B*(2+M) rows of y and
//   writes as many rows back: at B = 4096, M = 5, s = 2 about 0.6 MB, a
//   fraction of a microsecond of the card's bandwidth, so the step costs
//   what one launch and its dependent passes over the batch cost.
//   Design: one cooperative launch (edge_step_kernel), no sort.
//   * Phase 0, one thread per edge: gather y[i], y[j], y[negs], compute
//     the Eqn-6 forces (largevis_forces.cuh: the JAX oracle's op order,
//     every operation rounded on its own, the M negative forces summed
//     left to right, clipped), stage the U = B*(2+M) rows -lr*g with
//     their destination rows, and link every update u into its row's
//     list: next[u] = atomicExch(&head[dst[u]], u).  The links come in
//     any order; the set on each list does not.  Updates to rows below
//     n_frozen are -0.0, a bitwise no-op, and are not linked at all.
//   * A grid-wide sync (the cooperative launch keeps every block
//     resident; the grid is capped at what the card holds at once).
//   * Phase 1, one thread per update: the update whose exchange returned
//     -1 owns its row.  The owner walks the list; up to SHORT updates it
//     sorts them by u in registers (an insertion network with fixed
//     indices), adds them to y[row] in ascending u, which is stream
//     order, with __fadd_rn, and resets head[row] = -1, so the array is
//     clean for the next step without a memset.  A longer list (a hub
//     row: the fit's real batches have some every step; a
//     duplicate-dense batch, about 450 updates a row at N = 64) is only
//     registered, and a second grid-wide sync follows.
//   * Phase 2, one block per registered row: the block scans the
//     destination stream once in ascending u (8 entries a thread a tile,
//     placed by a block-wide scan of the hit counts), gathers the row's
//     updates in shared memory in that order, and warp 0 adds them.
//     That is U / 2048 tiles a long row, in parallel over the rows,
//     bounded whatever the list's length, and never O(c^2) in one
//     thread; walking a long list would be c dependent loads.  No
//     atomics touch y, so the result is bitwise the plain version's on
//     the CPU.
//   The launcher keeps head (N, -1), next, the staged rows and their
//   destinations across calls (kernels/largevis_step.py): no allocation
//   and no host-device sync a call, so the step can be captured in a
//   CUDA graph.  The lr is a kernel argument or read from the device (a
//   per-edge vector, or one scalar with stride 0), which a captured step
//   needs: a replay would repeat the argument frozen at capture.
//
// scatter_link_launch is the same launch without the forces: the split
// route's ordered scatter y[idx] += upd (replacing the JAX split path's
// y.at[idx].add(upd)) at step sizes.  For streams too long for a scan of
// U a hub row (the negative sampler's in-degree sum, U = N*K),
// the launcher keeps the stable sort of the destinations and
// edge_accumulate_kernel: one thread per row segment of the sorted
// stream, adding the row's updates in stream order.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "largevis_forces.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int BLOCK = 256;
constexpr int SHORT = 8;      // longest list one thread orders itself
constexpr unsigned FULL = 0xffffffffu;

struct StepArgs {
  float* y;
  const int* ei;
  const int* ej;
  const int* negs;
  const float* mask;
  const float* lr_vec;  // lr_vec[e * lr_stride] when set, else lr
  int lr_stride;        // 1: per edge; 0: one device scalar
  float lr;
  int B, M;
  float c2a, a, c2g, eps, clip;
  int n_frozen;
  float* upd;         // (U, S) staged rows
  int* dst;           // (U,) their destination rows
  int* next;          // (U,) list links
  int* head;          // (N,) list heads, -1 between calls
  int* n_long;        // (1,) rows with a long list this call
  int* long_rows;     // (U,) those rows
  int U;
};

template <int S>
__device__ inline void stage_edge(const StepArgs& p, int e) {
  const int i = p.ei[e], j = p.ej[e];
  float yi[S], yj[S], gi[S], gj[S];
#pragma unroll
  for (int k = 0; k < S; ++k) {
    yi[k] = p.y[(size_t)i * S + k];
    yj[k] = p.y[(size_t)j * S + k];
  }
  const float nlr =
      -(p.lr_vec != nullptr ? p.lr_vec[(size_t)e * p.lr_stride] : p.lr);
  const int M = p.M;
  const int base = e * (2 + M);
  const int* en = p.negs + (size_t)e * M;
  largevis::edge_forces<S>(
      yi, yj, M, [&](int m) { return p.y + (size_t)en[m] * S; },
      p.mask + (size_t)e * M, p.c2a, p.a, p.c2g, p.eps, p.clip, gi, gj,
      [&](int m, const float* g) {
        const int n = en[m], u = base + 2 + m;
#pragma unroll
        for (int k = 0; k < S; ++k)
          p.upd[(size_t)u * S + k] = __fmul_rn(nlr, g[k]);
        p.dst[u] = n;
      });
#pragma unroll
  for (int k = 0; k < S; ++k) {
    p.upd[(size_t)base * S + k] = __fmul_rn(nlr, gi[k]);
    p.upd[(size_t)(base + 1) * S + k] = __fmul_rn(nlr, gj[k]);
  }
  p.dst[base] = i;
  p.dst[base + 1] = j;
  // link after the rows are staged; phase 1 reads them after the grid sync
  for (int t = 0; t < 2 + M; ++t) {
    const int u = base + t;
    const int row = t == 0 ? i : t == 1 ? j : en[t - 2];
    if (row >= p.n_frozen) p.next[u] = atomicExch(&p.head[row], u);
  }
}

// A long list: the block finds row r's updates in ascending u by one
// ordered scan of the destination stream (each thread tests E
// consecutive entries a tile; a block-wide exclusive scan of the hit
// counts places them), gathers them in shared memory and warp 0 adds
// them in that order.  Every thread of the block calls it.
constexpr int E = 8;
constexpr int LIST = BLOCK * E;

template <int S>
__device__ void block_accumulate(const StepArgs& p, int r, int* list,
                                 int* warp_hits) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float acc[S];
#pragma unroll
  for (int k = 0; k < S; ++k) acc[k] = p.y[(size_t)r * S + k];
  auto add_list = [&](int n) {         // warp 0: acc += upd[list[0..n)]
    for (int j0 = 0; j0 < n; j0 += 32) {
      const int j = j0 + lane;
      float v[S];
#pragma unroll
      for (int k = 0; k < S; ++k)
        v[k] = j < n ? p.upd[(size_t)list[j] * S + k] : 0.0f;
      const int m = min(32, n - j0);
      for (int l = 0; l < m; ++l) {
#pragma unroll
        for (int k = 0; k < S; ++k)
          acc[k] = __fadd_rn(acc[k], __shfl_sync(FULL, v[k], l));
      }
    }
  };
  int base = 0;
  for (int t0 = 0; t0 < p.U; t0 += LIST) {
    const int u0 = t0 + tid * E;
    unsigned hit = 0;
#pragma unroll
    for (int e = 0; e < E; ++e)
      if (u0 + e < p.U && p.dst[u0 + e] == r) hit |= 1u << e;
    const int c = __popc(hit);
    int incl = c;                      // inclusive scan within the warp
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(FULL, incl, o);
      if (lane >= o) incl += v;
    }
    if (lane == 31) warp_hits[warp] = incl;
    __syncthreads();
    int before = 0, total = 0;
    for (int w = 0; w < BLOCK / 32; ++w) {
      before += w < warp ? warp_hits[w] : 0;
      total += warp_hits[w];
    }
    if (base + total > LIST) {         // flush what is gathered, in order
      if (warp == 0) add_list(base);
      base = 0;
    }
    __syncthreads();
    int at = base + before + incl - c;
    for (int e = 0; e < E; ++e)
      if (hit >> e & 1u) list[at++] = u0 + e;
    base += total;
    __syncthreads();
  }
  if (warp == 0) {
    add_list(base);
    if (lane == 0) {
#pragma unroll
      for (int k = 0; k < S; ++k) p.y[(size_t)r * S + k] = acc[k];
      p.head[r] = -1;
    }
  }
  __syncthreads();                     // list and warp_hits are reused
}

template <int S>
__device__ inline void accumulate(const StepArgs& p) {
  const int n_threads = gridDim.x * blockDim.x;
  for (int u = blockIdx.x * blockDim.x + threadIdx.x; u < p.U;
       u += n_threads) {
    const int row = p.dst[u];
    if (row < p.n_frozen || p.next[u] != -1) continue;  // not the owner
    int ids[SHORT];
#pragma unroll
    for (int t = 0; t < SHORT; ++t) ids[t] = INT_MAX;
    int c = 0;
    bool is_long = false;
    for (int v = p.head[row]; v != -1; v = p.next[v]) {
      if (c == SHORT) {
        is_long = true;
        break;
      }
      int x = v;                                       // insert, ascending
#pragma unroll
      for (int t = 0; t < SHORT; ++t) {
        const int lo = min(ids[t], x);
        x = max(ids[t], x);
        ids[t] = lo;
      }
      ++c;
    }
    if (is_long) {                     // left to phase 2
      p.long_rows[atomicAdd(p.n_long, 1)] = row;
      continue;
    }
    float acc[S];
#pragma unroll
    for (int k = 0; k < S; ++k) acc[k] = p.y[(size_t)row * S + k];
#pragma unroll
    for (int t = 0; t < SHORT; ++t) {
      if (t < c) {
#pragma unroll
        for (int k = 0; k < S; ++k)
          acc[k] = __fadd_rn(acc[k], p.upd[(size_t)ids[t] * S + k]);
      }
    }
#pragma unroll
    for (int k = 0; k < S; ++k) p.y[(size_t)row * S + k] = acc[k];
    p.head[row] = -1;
  }
}

// FORCES: the fused edge step.  Otherwise the ordered scatter of a given
// stream (upd, dst), with n_frozen = 0.
template <int S, bool FORCES>
__global__ void __launch_bounds__(BLOCK) edge_step_kernel(StepArgs p) {
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  const int n_threads = gridDim.x * blockDim.x;
  if (tid == 0) *p.n_long = 0;
  if (FORCES) {
    for (int e = tid; e < p.B; e += n_threads) stage_edge<S>(p, e);
  } else {
    for (int u = tid; u < p.U; u += n_threads)
      p.next[u] = atomicExch(&p.head[p.dst[u]], u);
  }
  cg::grid_group grid = cg::this_grid();
  grid.sync();
  accumulate<S>(p);
  grid.sync();
  __shared__ int list[LIST];
  __shared__ int warp_hits[BLOCK / 32];
  const int n_long = *(volatile int*)p.n_long;
  for (int l = blockIdx.x; l < n_long; l += gridDim.x)
    block_accumulate<S>(p, p.long_rows[l], list, warp_hits);
}

template <int S>
__global__ void edge_accumulate_kernel(float* __restrict__ y,
                                       const float* __restrict__ upd,
                                       const int* __restrict__ dst_sorted,
                                       const int64_t* __restrict__ perm,
                                       int U) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= U) return;
  const int row = dst_sorted[p];
  if (p > 0 && dst_sorted[p - 1] == row) return;   // not a segment head
  float acc[S];
#pragma unroll
  for (int k = 0; k < S; ++k) acc[k] = y[(size_t)row * S + k];
  for (int q = p; q < U && dst_sorted[q] == row; ++q) {
    const int64_t src = perm[q];
#pragma unroll
    for (int k = 0; k < S; ++k) acc[k] = __fadd_rn(acc[k], upd[src * S + k]);
  }
#pragma unroll
  for (int k = 0; k < S; ++k) y[(size_t)row * S + k] = acc[k];
}

// Blocks of one instance that the card holds at once, per device: the
// cooperative launch's cap, queried once.
constexpr int MAX_DEVICES = 64;

template <int S, bool FORCES>
cudaError_t launch_step(StepArgs p, int work, cudaStream_t st) {
  static int resident[MAX_DEVICES] = {0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (resident[dev] == 0) {
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, edge_step_kernel<S, FORCES>, BLOCK, 0);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
    resident[dev] = per_sm * sms;
  }
  const int want = (work + BLOCK - 1) / BLOCK;
  const int grid = want < resident[dev] ? want : resident[dev];
  void* args[] = {&p};
  return cudaLaunchCooperativeKernel((const void*)edge_step_kernel<S, FORCES>,
                                     dim3(grid), dim3(BLOCK), args, 0, st);
}

template <bool FORCES>
int launch_by_s(int s, const StepArgs& p, int work, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  switch (s) {
    case 1: err = launch_step<1, FORCES>(p, work, st); break;
    case 2: err = launch_step<2, FORCES>(p, work, st); break;
    case 3: err = launch_step<3, FORCES>(p, work, st); break;
    case 4: err = launch_step<4, FORCES>(p, work, st); break;
    default: return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

extern "C" int edge_step_launch(float* y, int s, const int* i, const int* j,
                                const int* negs, const float* mask,
                                const float* lr_vec, int lr_stride,
                                float lr, int B, int M,
                                float c2a, float a, float c2g, float eps,
                                float clip, int n_frozen, float* upd,
                                int* dst, int* next, int* head, int* n_long,
                                int* long_rows, void* stream) {
  if (B == 0) return cudaSuccess;
  const long long U = (long long)B * (2 + M);
  if (U > INT_MAX) return cudaErrorInvalidValue;
  StepArgs p{y,      i,         j,    negs, mask, lr_vec, lr_stride,
             lr,     B,         M,    c2a,  a,    c2g,    eps,
             clip,   n_frozen,  upd,  dst,  next, head,   n_long,
             long_rows, (int)U};
  return launch_by_s<true>(s, p, (int)U, stream);
}

extern "C" int scatter_link_launch(float* y, int s, const float* upd,
                                   const int* dst, int* next, int* head,
                                   int* n_long, int* long_rows, int U,
                                   void* stream) {
  if (U == 0) return cudaSuccess;
  StepArgs p{y, nullptr, nullptr, nullptr, nullptr, nullptr, 0, 0.0f, 0, 0,
             0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0, const_cast<float*>(upd),
             const_cast<int*>(dst), next, head, n_long, long_rows, U};
  return launch_by_s<false>(s, p, U, stream);
}

extern "C" int edge_accumulate_launch(float* y, int s, const float* upd,
                                      const int* dst_sorted,
                                      const int64_t* perm, int U,
                                      void* stream) {
  if (U == 0) return cudaSuccess;
  const dim3 grid((U + BLOCK - 1) / BLOCK);
  cudaStream_t st = (cudaStream_t)stream;
#define LAUNCH(S)                                                        \
  edge_accumulate_kernel<S><<<grid, BLOCK, 0, st>>>(y, upd, dst_sorted,  \
                                                    perm, U)
  switch (s) {
    case 1: LAUNCH(1); break;
    case 2: LAUNCH(2); break;
    case 3: LAUNCH(3); break;
    case 4: LAUNCH(4); break;
    default: return cudaErrorInvalidValue;
  }
#undef LAUNCH
  return cudaGetLastError();
}

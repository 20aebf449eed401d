// The LargeVis edge forces for Hopper (sm_90a): the split layout path's
// force stage, in two entries.
//
// Replaces the Pallas kernel repro/kernels/largevis_grad.py::
// largevis_grads (_kernel) and its tile-padding entry
// largevis_grads_chunked.  The arithmetic of both entries is
// largevis_forces.cuh, the same functions the fused edge step runs, so the
// split and fused routes compute bitwise the same forces.  The Pallas
// kernel's edge tiles and the chunked entry's zero padding up to a whole
// tile have no counterpart: the grid covers any B, the last block masks
// its tail.
//
// largevis_grads_launch, the gathered form (the JAX contract): for B
// edges with M negatives each, given the gathered coordinates yi, yj
// (B, s) and yneg (B, M, s) and the mask (B, M) of valid negatives, write
// the clipped Eqn-6 forces gi, gj (B, s) and gneg (B, M, s).  One thread
// per edge.
//
// grads_stream_launch, the indexed form, which the split route runs: it
// reads y (N, s) in place through the sampler's int32 indices i, j (B,)
// and negs (B, M) and writes the update stream that the ordered scatter
// takes: idx (B*(2+M),) int32 and upd (B*(2+M), s) = g * -lr in the
// canonical per-edge order [i_e, j_e, negs_e,0..M-1], rows below n_frozen
// -0.0.  It replaces the split step's index conversions, three gathers,
// the force launch, two concatenations and the lr multiply: the step is
// this launch and the scatter.
//   Bound: memory and launch latency.  The call reads the B*(2+M)
//   indices, the rows of y they name and the mask, and writes B*(2+M)
//   indices and update rows: at B = 4096, M = 5, s = 2 under 1 MB, a
//   fraction of a microsecond of the card's bandwidth, so the call costs
//   what its launch and two dependent loads cost.
//   Design: one thread per update row, so that the card fills (at B =
//   4096, M = 5: 28,672 threads in 114 blocks, where a thread per edge
//   gives 16 blocks of 256 or 64 of 64) and every thread does one force
//   (one or s divides, where a thread per edge walks its M negatives in
//   turn).  A block holds E = 256 / (2+M) whole edges; thread t is row
//   r = t % (2+M) of edge t / (2+M), and writes stream entry
//   blockIdx * E * (2+M) + t, so the stores are coalesced.  Each thread
//   loads i_e and its other endpoint (j_e for rows 0 and 1, its negative
//   for rows 2..), then both rows of y.  Row 0 and row 1 compute the pull;
//   a negative's thread its push, which it stages in shared memory; after
//   one barrier row 0 sums its edge's M pushes left to right from there
//   (add_push, the order of the fused step and the plain version).
#include <cuda_runtime.h>
#include <limits.h>

#include "largevis_forces.cuh"

namespace {

template <int S>
__global__ void largevis_grads_kernel(
    const float* __restrict__ yi, const float* __restrict__ yj,
    const float* __restrict__ yneg, const float* __restrict__ mask, int B,
    int M, float c2a, float a, float c2g, float eps, float clip,
    float* __restrict__ gi, float* __restrict__ gj,
    float* __restrict__ gneg) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= B) return;
  float vi[S], vj[S], oi[S], oj[S];
#pragma unroll
  for (int k = 0; k < S; ++k) {
    vi[k] = yi[(size_t)e * S + k];
    vj[k] = yj[(size_t)e * S + k];
  }
  const float* yn = yneg + (size_t)e * M * S;
  float* gn = gneg + (size_t)e * M * S;
  largevis::edge_forces<S>(
      vi, vj, M, [&](int m) { return yn + (size_t)m * S; },
      mask + (size_t)e * M, c2a, a, c2g, eps, clip, oi, oj,
      [&](int m, const float* g) {
#pragma unroll
        for (int k = 0; k < S; ++k) gn[(size_t)m * S + k] = g[k];
      });
#pragma unroll
  for (int k = 0; k < S; ++k) {
    gi[(size_t)e * S + k] = oi[k];
    gj[(size_t)e * S + k] = oj[k];
  }
}

constexpr int BLOCK = 256;

struct StreamArgs {
  const float* y;
  const int* ei;
  const int* ej;
  const int* negs;
  const float* mask;
  const float* lr_vec;  // lr_vec[e * lr_stride] when set, else lr
  int lr_stride;        // 1: per edge; 0: one device scalar
  float lr;
  int B, M, E;          // E: edges a block
  float c2a, a, c2g, eps, clip;
  int n_frozen;
  int* idx;             // (B*(2+M),) destination rows
  float* upd;           // (B*(2+M), S) updates
};

template <int S>
__global__ void __launch_bounds__(BLOCK)
grads_stream_kernel(const StreamArgs p) {
  __shared__ float push_sh[BLOCK * S];
  const int G = 2 + p.M;
  const int t = threadIdx.x;
  const int r = t % G;
  const long long e = (long long)blockIdx.x * p.E + t / G;
  const bool live = t < p.E * G && e < p.B;
  float gpos[S], out[S];
  int row = 0;
  if (live) {
    const int i = p.ei[e];
    const int other = r < 2 ? p.ej[e] : p.negs[e * p.M + r - 2];
    float yi[S], yo[S];
#pragma unroll
    for (int k = 0; k < S; ++k) {
      yi[k] = p.y[(size_t)i * S + k];
      yo[k] = p.y[(size_t)other * S + k];
    }
    row = r == 0 ? i : other;
    if (r < 2) {
      largevis::pull_force<S>(yi, yo, p.c2a, p.a, gpos);
    } else {
      float g[S];
      largevis::push_force<S>(yi, yo, p.mask[e * p.M + r - 2], p.c2g, p.a,
                              p.eps, g);
#pragma unroll
      for (int k = 0; k < S; ++k) {
        push_sh[t * S + k] = g[k];
        out[k] = largevis::clipf(-g[k], p.clip);
      }
    }
  }
  __syncthreads();
  if (!live) return;
  if (r < 2) {
    float push[S], gi[S], gj[S];
#pragma unroll
    for (int k = 0; k < S; ++k) push[k] = 0.0f;
    if (r == 0)
      for (int m = 0; m < p.M; ++m)
        largevis::add_push<S>(push, &push_sh[(t + 2 + m) * S], m);
    largevis::endpoint_forces<S>(gpos, push, p.clip, gi, gj);
#pragma unroll
    for (int k = 0; k < S; ++k) out[k] = r == 0 ? gi[k] : gj[k];
  }
  const float nlr =
      -(p.lr_vec != nullptr ? p.lr_vec[e * p.lr_stride] : p.lr);
  const bool frozen = row < p.n_frozen;
  const size_t u = (size_t)e * G + r;
  p.idx[u] = row;
#pragma unroll
  for (int k = 0; k < S; ++k)
    p.upd[u * S + k] = frozen ? -0.0f : __fmul_rn(nlr, out[k]);
}

}  // namespace

extern "C" int largevis_grads_launch(const float* yi, const float* yj,
                                     const float* yneg, const float* mask,
                                     int B, int M, int s, float c2a, float a,
                                     float c2g, float eps, float clip,
                                     float* gi, float* gj, float* gneg,
                                     void* stream) {
  if (B == 0) return cudaSuccess;
  const dim3 grid((B + BLOCK - 1) / BLOCK);
  cudaStream_t st = (cudaStream_t)stream;
#define LAUNCH(S)                                                        \
  largevis_grads_kernel<S><<<grid, BLOCK, 0, st>>>(                      \
      yi, yj, yneg, mask, B, M, c2a, a, c2g, eps, clip, gi, gj, gneg)
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

extern "C" int grads_stream_launch(const float* y, int s, const int* i,
                                   const int* j, const int* negs,
                                   const float* mask, const float* lr_vec,
                                   int lr_stride, float lr, int B, int M,
                                   float c2a, float a, float c2g, float eps,
                                   float clip, int n_frozen, int* idx,
                                   float* upd, void* stream) {
  if (M < 0 || 2 + M > BLOCK) return cudaErrorInvalidValue;
  if ((long long)B * (2 + M) > INT_MAX) return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  const int E = BLOCK / (2 + M);
  const StreamArgs p{y,   i,   j,   negs, mask, lr_vec,   lr_stride, lr,
                     B,   M,   E,   c2a,  a,    c2g,      eps,       clip,
                     n_frozen, idx, upd};
  const dim3 grid((B + E - 1) / E);
  cudaStream_t st = (cudaStream_t)stream;
  switch (s) {
    case 1: grads_stream_kernel<1><<<grid, BLOCK, 0, st>>>(p); break;
    case 2: grads_stream_kernel<2><<<grid, BLOCK, 0, st>>>(p); break;
    case 3: grads_stream_kernel<3><<<grid, BLOCK, 0, st>>>(p); break;
    case 4: grads_stream_kernel<4><<<grid, BLOCK, 0, st>>>(p); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

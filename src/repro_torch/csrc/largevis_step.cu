// The fused LargeVis edge step for Hopper (sm_90a).
//
// Replaces the Pallas kernel repro/kernels/largevis_step.py::
// fused_edge_step (_kernel, _forces, _kernel_tiled): one SGD update of the
// (N, s) embedding over a batch of B sampled edges with M negatives each.
// Every gather happens before any update (the Pallas grid (2, tiles) runs
// all of phase 0 before phase 1), and updates to the same row accumulate
// in the canonical per-edge order [i_e, j_e, negs_e,0..M-1].
//   Bound: memory and launch latency.  A step reads B*(2+M) rows of y and
//   writes as many update rows: at B = 4096, M = 5, s = 2 about 0.5 MB,
//   a fraction of a microsecond of the card's bandwidth, so the step
//   costs what its launches cost.
//   Design: two kernels, and a stable sort between them.
//   * edge_forces_kernel (phase 0), one thread per edge: gather y[i],
//     y[j], y[negs], compute the Eqn-6 forces (largevis_forces.cuh: the
//     JAX oracle's op order, every operation rounded on its own, the M
//     negative forces summed left to right, clipped), and stage the
//     -lr*g rows with their destination rows (rows below n_frozen get
//     -0.0, a bitwise no-op).
//   * The wrapper stable-sorts the destinations (torch.sort on an int
//     key: it orders the updates, it computes none of them).
//   * edge_accumulate_kernel (phase 1), one thread per row segment of
//     the sorted stream: add the row's updates one after another, in
//     stream order.  No atomics, so the result is bitwise the plain
//     version's on the CPU.  The sort and this kernel alone are also the
//     split path's ordered scatter (scatter_add_ordered), which replaces
//     the JAX split path's y.at[idx].add(upd).
#include <cuda_runtime.h>
#include <stdint.h>

#include "largevis_forces.cuh"

namespace {

template <int S>
__global__ void edge_forces_kernel(
    const float* __restrict__ y, const int* __restrict__ ei,
    const int* __restrict__ ej, const int* __restrict__ negs,
    const float* __restrict__ mask, const float* __restrict__ lr_vec,
    float lr, int B, int M, float c2a, float a, float c2g, float eps,
    float clip, int n_frozen, float* __restrict__ upd,
    int* __restrict__ dst) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= B) return;
  const int i = ei[e], j = ej[e];
  float yi[S], yj[S], gi[S], gj[S];
#pragma unroll
  for (int k = 0; k < S; ++k) {
    yi[k] = y[(size_t)i * S + k];
    yj[k] = y[(size_t)j * S + k];
  }
  const float nlr = -(lr_vec != nullptr ? lr_vec[e] : lr);
  const size_t base = (size_t)e * (2 + M);
  const int* en = negs + (size_t)e * M;
  largevis::edge_forces<S>(
      yi, yj, M, [&](int m) { return y + (size_t)en[m] * S; },
      mask + (size_t)e * M, c2a, a, c2g, eps, clip, gi, gj,
      [&](int m, const float* g) {
        const int n = en[m];
        const bool live = n >= n_frozen;
#pragma unroll
        for (int k = 0; k < S; ++k)
          upd[(base + 2 + m) * S + k] = live ? __fmul_rn(nlr, g[k]) : -0.0f;
        dst[base + 2 + m] = n;
      });
  const bool live_i = i >= n_frozen, live_j = j >= n_frozen;
#pragma unroll
  for (int k = 0; k < S; ++k) {
    upd[base * S + k] = live_i ? __fmul_rn(nlr, gi[k]) : -0.0f;
    upd[(base + 1) * S + k] = live_j ? __fmul_rn(nlr, gj[k]) : -0.0f;
  }
  dst[base] = i;
  dst[base + 1] = j;
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

constexpr int BLOCK = 256;

}  // namespace

extern "C" int edge_forces_launch(const float* y, int s, const int* i,
                                  const int* j, const int* negs,
                                  const float* mask, const float* lr_vec,
                                  float lr, int B, int M, float c2a, float a,
                                  float c2g, float eps, float clip,
                                  int n_frozen, float* upd, int* dst,
                                  void* stream) {
  if (B == 0) return cudaSuccess;
  const dim3 grid((B + BLOCK - 1) / BLOCK);
  cudaStream_t st = (cudaStream_t)stream;
#define LAUNCH(S)                                                        \
  edge_forces_kernel<S><<<grid, BLOCK, 0, st>>>(                         \
      y, i, j, negs, mask, lr_vec, lr, B, M, c2a, a, c2g, eps, clip,     \
      n_frozen, upd, dst)
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

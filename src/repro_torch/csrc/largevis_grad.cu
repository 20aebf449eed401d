// The LargeVis edge forces for Hopper (sm_90a), without gather or scatter.
//
// Replaces the Pallas kernel repro/kernels/largevis_grad.py::
// largevis_grads (_kernel) and its tile-padding entry
// largevis_grads_chunked: for B edges with M negatives each, given the
// gathered coordinates yi, yj (B, s) and yneg (B, M, s) and the mask
// (B, M) of valid negatives, write the clipped Eqn-6 forces gi, gj (B, s)
// and gneg (B, M, s).  It is the force stage of the split layout path
// (gather -> forces -> ordered scatter), which runs for layout_step
// "split" and for the frozen-corpus transform on that route.
//   Bound: memory and launch latency.  The call reads
//   4*B*(2s + M*s + M) bytes and writes 4*B*(2s + M*s): at B = 4096,
//   M = 5, s = 2 about 0.5 MB, a fraction of a microsecond of the card's
//   bandwidth, so the call costs what its launch costs.
//   Design: one thread per edge.  The arithmetic is largevis_forces.cuh,
//   the same function the fused edge step runs, so the split and fused
//   routes compute bitwise the same forces.  The Pallas kernel's edge
//   tiles and the chunked entry's zero padding up to a whole tile have no
//   counterpart: the grid covers any B, the last block masks its tail.
#include <cuda_runtime.h>

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

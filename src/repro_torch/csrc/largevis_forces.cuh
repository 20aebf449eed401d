// The Eqn-6 forces of one sampled edge, shared by the fused edge step
// (largevis_step.cu) and the split path's force kernels (largevis_grad.cu:
// the gathered form and the indexed update stream), so the three cannot
// drift apart.
//
// The op order is the JAX oracle's (repro/kernels/ref.py::
// largevis_grads_ref), every multiply, add and divide rounded on its own
// (__fmul_rn, __fadd_rn, __fdiv_rn: nothing contracts into an FMA):
//   pull   gpos  = (2a / (1 + a*d2)) * d,               d = yi - yj
//   push   g_m   = ((-2 gamma * din) / ((eps + dn2) * (1 + a*dn2))) * mask_m
//   gi = clip(gpos + sum_m g_m),  gj = clip(-gpos),  gneg_m = clip(-g_m)
// with squared norms summed left to right in coordinate order and the M
// pushes summed left to right.
#pragma once

#include <cuda_runtime.h>

namespace largevis {

__device__ inline float clipf(float x, float c) {
  return fminf(fmaxf(x, -c), c);
}

template <int S>
__device__ inline float sqnorm(const float* v) {
  float acc = __fmul_rn(v[0], v[0]);
#pragma unroll
  for (int k = 1; k < S; ++k) acc = __fadd_rn(acc, __fmul_rn(v[k], v[k]));
  return acc;
}

// The pull of the edge (yi, yj): gpos[S], unclipped.  c2a = 2a.
template <int S>
__device__ inline void pull_force(const float* yi, const float* yj,
                                  float c2a, float a, float* gpos) {
  float dij[S];
#pragma unroll
  for (int k = 0; k < S; ++k) dij[k] = __fsub_rn(yi[k], yj[k]);
  const float d2 = sqnorm<S>(dij);
  const float gp = __fdiv_rn(c2a, __fadd_rn(1.0f, __fmul_rn(a, d2)));
#pragma unroll
  for (int k = 0; k < S; ++k) gpos[k] = __fmul_rn(gp, dij[k]);
}

// The push g[S] of one negative yn on yi, masked by mk, unclipped.
// c2g = -2 gamma.
template <int S>
__device__ inline void push_force(const float* yi, const float* yn,
                                  float mk, float c2g, float a, float eps,
                                  float* g) {
  float din[S];
#pragma unroll
  for (int k = 0; k < S; ++k) din[k] = __fsub_rn(yi[k], yn[k]);
  const float dn2 = sqnorm<S>(din);
  const float den = __fmul_rn(__fadd_rn(eps, dn2),
                              __fadd_rn(1.0f, __fmul_rn(a, dn2)));
#pragma unroll
  for (int k = 0; k < S; ++k)
    g[k] = __fmul_rn(__fdiv_rn(__fmul_rn(c2g, din[k]), den), mk);
}

// push += g_m, left to right from m = 0 (push starts at g_0, not at 0 + g_0).
template <int S>
__device__ inline void add_push(float* push, const float* g, int m) {
#pragma unroll
  for (int k = 0; k < S; ++k)
    push[k] = m == 0 ? g[k] : __fadd_rn(push[k], g[k]);
}

// The clipped forces on yi and yj from the pull and the summed pushes
// (push[] = 0 when M = 0).
template <int S>
__device__ inline void endpoint_forces(const float* gpos, const float* push,
                                       float clip, float* gi, float* gj) {
#pragma unroll
  for (int k = 0; k < S; ++k) {
    gi[k] = clipf(__fadd_rn(gpos[k], push[k]), clip);
    gj[k] = clipf(-gpos[k], clip);
  }
}

// Forces of one edge with M negatives, one thread.  neg_row(m) returns a
// pointer to the S coordinates of negative m; on_neg(m, g) receives that
// negative's clipped force g[S] as soon as it is known.  Writes the
// clipped forces on yi and yj to gi[S] and gj[S].
template <int S, typename NegRow, typename OnNeg>
__device__ inline void edge_forces(const float* yi, const float* yj, int M,
                                   NegRow neg_row, const float* mask,
                                   float c2a, float a, float c2g, float eps,
                                   float clip, float* gi, float* gj,
                                   OnNeg on_neg) {
  float gpos[S], push[S];
  pull_force<S>(yi, yj, c2a, a, gpos);
#pragma unroll
  for (int k = 0; k < S; ++k) push[k] = 0.0f;
  for (int m = 0; m < M; ++m) {
    float g[S], gneg[S];
    push_force<S>(yi, neg_row(m), mask[m], c2g, a, eps, g);
    add_push<S>(push, g, m);
#pragma unroll
    for (int k = 0; k < S; ++k) gneg[k] = clipf(-g[k], clip);
    on_neg(m, gneg);
  }
  endpoint_forces<S>(gpos, push, clip, gi, gj);
}

}  // namespace largevis

// The Eqn-6 forces of one sampled edge, shared by the fused edge step
// (largevis_step.cu) and the split path's force kernel (largevis_grad.cu),
// so the two cannot drift apart.
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

// Forces of one edge with M negatives.  neg_row(m) returns a pointer to
// the S coordinates of negative m; on_neg(m, g) receives that negative's
// clipped force g[S] as soon as it is known.  c2a = 2a, c2g = -2 gamma.
// Writes the clipped forces on yi and yj to gi[S] and gj[S].
template <int S, typename NegRow, typename OnNeg>
__device__ inline void edge_forces(const float* yi, const float* yj, int M,
                                   NegRow neg_row, const float* mask,
                                   float c2a, float a, float c2g, float eps,
                                   float clip, float* gi, float* gj,
                                   OnNeg on_neg) {
  float dij[S], gpos[S], push[S];
#pragma unroll
  for (int k = 0; k < S; ++k) dij[k] = __fsub_rn(yi[k], yj[k]);
  const float d2 = sqnorm<S>(dij);
  const float gp = __fdiv_rn(c2a, __fadd_rn(1.0f, __fmul_rn(a, d2)));
#pragma unroll
  for (int k = 0; k < S; ++k) {
    gpos[k] = __fmul_rn(gp, dij[k]);
    push[k] = 0.0f;
  }
  for (int m = 0; m < M; ++m) {
    const float* yn = neg_row(m);
    const float mk = mask[m];
    float din[S], gneg[S];
#pragma unroll
    for (int k = 0; k < S; ++k) din[k] = __fsub_rn(yi[k], yn[k]);
    const float dn2 = sqnorm<S>(din);
    const float den = __fmul_rn(__fadd_rn(eps, dn2),
                                __fadd_rn(1.0f, __fmul_rn(a, dn2)));
#pragma unroll
    for (int k = 0; k < S; ++k) {
      const float g = __fmul_rn(__fdiv_rn(__fmul_rn(c2g, din[k]), den), mk);
      push[k] = m == 0 ? g : __fadd_rn(push[k], g);
      gneg[k] = clipf(-g, clip);
    }
    on_neg(m, gneg);
  }
#pragma unroll
  for (int k = 0; k < S; ++k) {
    gi[k] = clipf(__fadd_rn(gpos[k], push[k]), clip);
    gj[k] = clipf(-gpos[k], clip);
  }
}

}  // namespace largevis

// Backward flash attention for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package's Pallas flash kernel
// (repro/kernels/flash_attention.py) has no VJP of its own, and training
// reaches attention through models/attention.py's _mha_chunked_core, a
// jax.custom_vjp whose backward, _mha_bwd_rule, recomputes the scores a
// block pair at a time from the forward's log-sum-exp.  This file is that
// backward.  For q (B, S, H, D), k and v (B, T, H, D) with the heads
// broadcast, the forward's out and lse (B, H, S) f32 and the incoming dout:
//
//   delta = rowsum(dout * out)                          (f32)
//   s     = (q k^T) * scale, masked keys -> p = 0
//   p     = exp(s - lse)
//   ds    = p * (dout v^T - delta) * scale
//   dv    = p^T dout,  dk = ds^T q,  dq = ds k
//
// with the forward's masks: top-left causal (kpos <= qpos), and a window W
// > 0 keeps qpos - W < kpos.  A masked (or padded) pair gets p = 0 by a
// select, never by exp of a large negative number, so no NaN can come of
// it.  Under bf16 inputs p and ds are rounded to bf16 before the products
// that take them, where the JAX rule rounds them (p for dv, ds for dq and
// dk); q.k^T and dout.v^T are exact bf16 products summed in f32, and dq,
// dk, dv accumulate in f32 and are rounded once to bf16 at the end.  f32
// inputs take f32 FMAs throughout.
//
// Three kernels, no atomics, so that two calls give the same bits:
//  * delta: one warp a (b, s, h) row, written (B, H, S);
//  * dk/dv: one block a (key tile, b * H + h).  K and V of the tile stay in
//    shared memory; the block walks the query tiles that the mask lets see
//    the tile (causal: from the tile's first key on; a window: up to its
//    last key + W - 1), recomputes s and dout v^T for the pair of tiles,
//    forms p and ds in shared memory, and accumulates dv += p^T dout and
//    dk += ds^T q in registers;
//  * dq: one block a (query tile, b * H + h), walking the key tiles its rows
//    may see and accumulating dq += ds k.
// s and dout v^T are computed by both the dk/dv and the dq kernel: 7 tile
// products a pair where one fused pass needs 5 (a later redesign, with a
// deterministic dq reduction, would save the two).
//
// Products: bf16 tiles go to the tensor cores through WMMA (16 x 16 x 16,
// bf16 in, f32 accumulators; mma.sync underneath), with the operands in
// shared memory and the transposed ones (p^T, ds^T, k^T) read as
// column-major fragments; an accumulator fragment of dk, dv or dq stays in
// one warp's registers across the whole walk and is staged through shared
// memory once at the end.  f32 tiles use a 16 x 16 thread grid of FMAs, a
// thread owning rows ty + 16 i and columns tx + 16 j of a product.
//
// Tiles: 64 query rows by 64 keys (bf16: 32 keys at D = 256, which keeps a
// warp's dk and dv fragments at 64 registers; f32: 32 by 32 at D = 256),
// 256 threads a block.  Shared memory (k, v, q, dout tiles, the f32 score
// tiles, bf16 p and ds): bf16 88.5 KB at D = 64, two blocks an SM, and
// 127.5 KB at D = 256; so the launcher opts into more than 48 KB, and
// checks cudaGetLastError after every launch: a launch refused for its
// shared memory never runs.
//
// Bound: the bf16 tensor-core rate.  The work the backward must do is 5
// products of 2 D flops a pair under the mask: at (2, 4096, 16, 64)
// causal, 5 * 2 * 64 * 268,500,992 pairs = 171.8 GFLOP, 0.1738 ms at 989
// TFLOP/s (reading q, k, v, out, dout and writing dq, dk, dv, 8 x 16.8 MB,
// takes 0.040 ms at 3.35 TB/s).  This first kernel does 7 products and
// keeps p and ds in shared memory; chip_smoke.py times it against the
// bound and SDPA's backward.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>
#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;

constexpr int NT = 256;            // threads a block: 8 warps, 16 x 16 grid
constexpr int WARPS = NT / 32;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

constexpr int align128(int bytes) { return (bytes + 127) / 128 * 128; }

// the tiles at element type T and head dim D
template <typename T, int D>
struct Cfg {
  static constexpr bool BF16 = std::is_same<T, bf16>::value;
  static constexpr int BQ = (!BF16 && D == 256) ? 32 : 64;   // query rows
  static constexpr int BK = D == 256 ? 32 : 64;              // keys
  // row pitches, in elements: bf16 rows stay 16-byte aligned for WMMA and
  // the vector loads; f32 rows are odd, so a column read hits 16 banks
  static constexpr int LD = BF16 ? D + 8 : D + 1;     // q, k, v, dout tiles
  static constexpr int LS = BF16 ? BK + 4 : BK + 1;   // f32 score tiles
  static constexpr int LP = BK + 8;                   // bf16 p and ds tiles
  static constexpr int LO = D + 4;                    // f32 output staging
  // shared memory: k, v (BK rows), q, dout (BQ rows), s and dp (f32),
  // bf16 p and ds, then lse and delta of the query rows
  static constexpr int K_OFF = 0;
  static constexpr int V_OFF = K_OFF + align128(BK * LD * (int)sizeof(T));
  static constexpr int Q_OFF = V_OFF + align128(BK * LD * (int)sizeof(T));
  static constexpr int DO_OFF = Q_OFF + align128(BQ * LD * (int)sizeof(T));
  static constexpr int S_OFF = DO_OFF + align128(BQ * LD * (int)sizeof(T));
  static constexpr int DP_OFF = S_OFF + align128(BQ * LS * 4);
  static constexpr int PB_OFF = DP_OFF + align128(BQ * LS * 4);
  static constexpr int DSB_OFF = PB_OFF + (BF16 ? align128(BQ * LP * 2) : 0);
  static constexpr int LSE_OFF = DSB_OFF + (BF16 ? align128(BQ * LP * 2) : 0);
  static constexpr int DELTA_OFF = LSE_OFF + align128(BQ * 4);
  static constexpr int SMEM = DELTA_OFF + align128(BQ * 4);
  // the bf16 accumulators are staged at the base once the walk is done
  static_assert(!BF16 || (BQ > BK ? BQ : BK) * LO * 4 <= SMEM, "staging");
  static_assert(SMEM <= 232448, "shared memory");
  static_assert(D % 16 == 0 && BQ % 16 == 0 && BK % 16 == 0, "tiles");
};

// ---------------------------------------------------------------------------
// Tile products in shared memory: C (M x N) = or += opA(A) (M x K) opB(B)
// (K x N), where opA(A)[m][k] = A[k * lda + m] when TA, else A[m * lda + k],
// and opB(B)[k][n] = B[n * ldb + k] when TB, else B[k * ldb + n]
// ---------------------------------------------------------------------------

template <bool T_>
using Layout =
    typename std::conditional<T_, wmma::col_major, wmma::row_major>::type;
using Acc = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

template <int M, int N>
__host__ __device__ constexpr int frags_per_warp() {
  return ((M / 16) * (N / 16) + WARPS - 1) / WARPS;
}

// one 16 x 16 output fragment at (m0, n0): c += the K-long product
template <int K, bool TA, bool TB>
__device__ __forceinline__ void wmma_frag(Acc& c, const bf16* A, int lda,
                                          const bf16* B, int ldb, int m0,
                                          int n0) {
#pragma unroll 4
  for (int k0 = 0; k0 < K; k0 += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, Layout<TA>> a;
    wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, Layout<TB>> b;
    wmma::load_matrix_sync(a, A + (TA ? k0 * lda + m0 : m0 * lda + k0), lda);
    wmma::load_matrix_sync(b, B + (TB ? n0 * ldb + k0 : k0 * ldb + n0), ldb);
    wmma::mma_sync(c, a, b, c);
  }
}

// C = opA(A) opB(B) into shared memory (f32, pitch ldc)
template <int M, int N, int K, bool TA, bool TB>
__device__ __forceinline__ void mm_smem(float* C, int ldc, const bf16* A,
                                        int lda, const bf16* B, int ldb) {
  for (int f = threadIdx.x / 32; f < (M / 16) * (N / 16); f += WARPS) {
    const int m0 = f / (N / 16) * 16, n0 = f % (N / 16) * 16;
    Acc c;
    wmma::fill_fragment(c, 0.f);
    wmma_frag<K, TA, TB>(c, A, lda, B, ldb, m0, n0);
    wmma::store_matrix_sync(C + m0 * ldc + n0, c, ldc, wmma::mem_row_major);
  }
}

// c += opA(A) opB(B), the warp's fragments f = warp + WARPS i in registers
template <int M, int N, int K, bool TA, bool TB, int F>
__device__ __forceinline__ void mm_acc(Acc (&c)[F], const bf16* A, int lda,
                                       const bf16* B, int ldb) {
#pragma unroll
  for (int i = 0; i < F; ++i) {
    const int f = threadIdx.x / 32 + WARPS * i;
    if (f < (M / 16) * (N / 16))
      wmma_frag<K, TA, TB>(c[i], A, lda, B, ldb, f / (N / 16) * 16,
                           f % (N / 16) * 16);
  }
}

// the f32 route: thread (ty, tx) owns rows ty + 16 i, columns tx + 16 j
template <int M, int N, int K, bool TA, bool TB>
__device__ __forceinline__ void fma_prod(float (&acc)[M / 16][N / 16],
                                         const float* A, int lda,
                                         const float* B, int ldb) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float a[M / 16], b[N / 16];
#pragma unroll
    for (int i = 0; i < M / 16; ++i)
      a[i] = TA ? A[k * lda + ty + 16 * i] : A[(ty + 16 * i) * lda + k];
#pragma unroll
    for (int j = 0; j < N / 16; ++j)
      b[j] = TB ? B[(tx + 16 * j) * ldb + k] : B[k * ldb + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < M / 16; ++i)
#pragma unroll
      for (int j = 0; j < N / 16; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

template <int M, int N, int K, bool TA, bool TB>
__device__ __forceinline__ void mm_smem(float* C, int ldc, const float* A,
                                        int lda, const float* B, int ldb) {
  float acc[M / 16][N / 16];
#pragma unroll
  for (int i = 0; i < M / 16; ++i)
#pragma unroll
    for (int j = 0; j < N / 16; ++j) acc[i][j] = 0.f;
  fma_prod<M, N, K, TA, TB>(acc, A, lda, B, ldb);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < M / 16; ++i)
#pragma unroll
    for (int j = 0; j < N / 16; ++j)
      C[(ty + 16 * i) * ldc + tx + 16 * j] = acc[i][j];
}

// the accumulator of an (M x N) output: WMMA fragments or FMA registers
template <typename T, int M, int N>
struct Accum {
  Acc c[frags_per_warp<M, N>()];
  __device__ void zero() {
#pragma unroll
    for (auto& f : c) wmma::fill_fragment(f, 0.f);
  }
  template <int K, bool TA, bool TB>
  __device__ void add(const bf16* A, int lda, const bf16* B, int ldb) {
    mm_acc<M, N, K, TA, TB>(c, A, lda, B, ldb);
  }
  // rows [row0, row0 + M) of (b, row, h, :) in dst, rows < n_rows; the
  // fragments go through `stage` (M x (N + 4) f32 at the smem base)
  __device__ void store(T* dst, float* stage, int row0, int n_rows, int H,
                        int h, int b) {
    constexpr int LO = N + 4;
#pragma unroll
    for (int i = 0; i < frags_per_warp<M, N>(); ++i) {
      const int f = threadIdx.x / 32 + WARPS * i;
      if (f < (M / 16) * (N / 16))
        wmma::store_matrix_sync(stage + f / (N / 16) * 16 * LO +
                                    f % (N / 16) * 16,
                                c[i], LO, wmma::mem_row_major);
    }
    __syncthreads();
    for (int e = threadIdx.x; e < M * N / 2; e += NT) {
      const int r = e / (N / 2), col = e % (N / 2) * 2, row = row0 + r;
      if (row < n_rows)
        *reinterpret_cast<__nv_bfloat162*>(
            dst + (((size_t)b * n_rows + row) * H + h) * N + col) =
            __floats2bfloat162_rn(stage[r * LO + col], stage[r * LO + col + 1]);
    }
    __syncthreads();
  }
};

template <int M, int N>
struct Accum<float, M, N> {
  float c[M / 16][N / 16];
  __device__ void zero() {
#pragma unroll
    for (int i = 0; i < M / 16; ++i)
#pragma unroll
      for (int j = 0; j < N / 16; ++j) c[i][j] = 0.f;
  }
  template <int K, bool TA, bool TB>
  __device__ void add(const float* A, int lda, const float* B, int ldb) {
    fma_prod<M, N, K, TA, TB>(c, A, lda, B, ldb);
  }
  __device__ void store(float* dst, float*, int row0, int n_rows, int H,
                        int h, int b) {
    const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
    for (int i = 0; i < M / 16; ++i) {
      const int row = row0 + ty + 16 * i;
      if (row >= n_rows) continue;
      float* o = dst + (((size_t)b * n_rows + row) * H + h) * N;
#pragma unroll
      for (int j = 0; j < N / 16; ++j) o[tx + 16 * j] = c[i][j];
    }
  }
};

// rows [row0, row0 + ROWS) of head h of a (B, n_rows, H, D) tensor into a
// tile of pitch LD, zeros past n_rows; 16 bytes a load
template <typename T, int D, int ROWS, int LD>
__device__ __forceinline__ void load_tile(T* dst, const T* src, int row0,
                                          int n_rows, int H, int h, int b) {
  constexpr int VEC = 16 / sizeof(T);
  for (int e = threadIdx.x; e < ROWS * D / VEC; e += NT) {
    const int r = e / (D / VEC), c = e % (D / VEC) * VEC, row = row0 + r;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (row < n_rows)
      val = *reinterpret_cast<const uint4*>(
          src + (((size_t)b * n_rows + row) * H + h) * D + c);
    if constexpr (sizeof(T) == 2) {
      *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
    } else {
      const float* f = reinterpret_cast<const float*>(&val);
#pragma unroll
      for (int i = 0; i < 4; ++i) dst[r * LD + c + i] = f[i];
    }
  }
}

// lse and delta of query rows [q0, q0 + BQ) of (b, h); 0 past S
template <int BQ>
__device__ __forceinline__ void load_rows(float* lse_s, float* delta_s,
                                          const float* lse,
                                          const float* delta, int q0, int S,
                                          size_t bh) {
  for (int r = threadIdx.x; r < BQ; r += NT) {
    const bool in = q0 + r < S;
    lse_s[r] = in ? lse[bh * S + q0 + r] : 0.f;
    delta_s[r] = in ? delta[bh * S + q0 + r] : 0.f;
  }
}

// p and ds of a (query tile, key tile) pair from s and dp in shared memory:
// f32 in place of s and dp, and bf16 copies for the bf16 products
template <typename T, int D>
__device__ __forceinline__ void p_and_ds(uint8_t* smem, int q0, int k0,
                                         int S, int Tk, float scale,
                                         int causal, int window) {
  using C = Cfg<T, D>;
  float* s_t = reinterpret_cast<float*>(smem + C::S_OFF);
  float* dp_t = reinterpret_cast<float*>(smem + C::DP_OFF);
  const float* lse_s = reinterpret_cast<const float*>(smem + C::LSE_OFF);
  const float* delta_s = reinterpret_cast<const float*>(smem + C::DELTA_OFF);
  for (int e = threadIdx.x; e < C::BQ * C::BK; e += NT) {
    const int r = e / C::BK, c = e % C::BK;
    const int qp = q0 + r, kp = k0 + c;
    const bool ok = qp < S && kp < Tk && (!causal || kp <= qp) &&
                    (window == 0 || kp > qp - window);
    float p = 0.f, ds = 0.f;
    if (ok) {
      p = expf(s_t[r * C::LS + c] * scale - lse_s[r]);
      ds = p * (dp_t[r * C::LS + c] - delta_s[r]) * scale;
    }
    if constexpr (C::BF16) {
      reinterpret_cast<bf16*>(smem + C::PB_OFF)[r * C::LP + c] =
          __float2bfloat16_rn(p);
      reinterpret_cast<bf16*>(smem + C::DSB_OFF)[r * C::LP + c] =
          __float2bfloat16_rn(ds);
    } else {
      s_t[r * C::LS + c] = p;
      dp_t[r * C::LS + c] = ds;
    }
  }
}

// the operand tiles of p and ds: the bf16 copies, or f32 in place
template <typename T, int D>
__device__ __forceinline__ const T* p_tile(uint8_t* smem) {
  using C = Cfg<T, D>;
  return reinterpret_cast<const T*>(smem + (C::BF16 ? C::PB_OFF : C::S_OFF));
}
template <typename T, int D>
__device__ __forceinline__ const T* ds_tile(uint8_t* smem) {
  using C = Cfg<T, D>;
  return reinterpret_cast<const T*>(smem +
                                    (C::BF16 ? C::DSB_OFF : C::DP_OFF));
}
template <typename T, int D>
__host__ __device__ constexpr int p_pitch() {
  return Cfg<T, D>::BF16 ? Cfg<T, D>::LP : Cfg<T, D>::LS;
}

// s = q k^T and dp = dout v^T of the tiles in shared memory
template <typename T, int D>
__device__ __forceinline__ void scores(uint8_t* smem) {
  using C = Cfg<T, D>;
  const T* k_t = reinterpret_cast<const T*>(smem + C::K_OFF);
  const T* v_t = reinterpret_cast<const T*>(smem + C::V_OFF);
  const T* q_t = reinterpret_cast<const T*>(smem + C::Q_OFF);
  const T* do_t = reinterpret_cast<const T*>(smem + C::DO_OFF);
  mm_smem<C::BQ, C::BK, D, false, true>(
      reinterpret_cast<float*>(smem + C::S_OFF), C::LS, q_t, C::LD, k_t,
      C::LD);
  mm_smem<C::BQ, C::BK, D, false, true>(
      reinterpret_cast<float*>(smem + C::DP_OFF), C::LS, do_t, C::LD, v_t,
      C::LD);
}

// ---------------------------------------------------------------------------
// The kernels
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(NT) delta_kernel(const T* __restrict__ out,
                                                   const T* __restrict__ dout,
                                                   float* __restrict__ delta,
                                                   long long rows, int S,
                                                   int H, int D) {
  const long long row = (long long)blockIdx.x * WARPS + threadIdx.x / 32;
  if (row >= rows) return;                 // rows = B * S * H, (b, s, h)
  const int lane = threadIdx.x % 32;
  const T* o = out + row * D;
  const T* g = dout + row * D;
  float sum = 0.f;
  for (int d = lane; d < D; d += 32) sum += to_f(g[d]) * to_f(o[d]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    sum += __shfl_xor_sync(~0u, sum, off);
  if (lane == 0) {
    const int h = (int)(row % H), s = (int)(row / H % S);
    const long long b = row / ((long long)H * S);
    delta[(b * H + h) * S + s] = sum;
  }
}

// grid (key tiles, B * H)
template <typename T, int D>
__global__ void __launch_bounds__(NT) dkdv_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    T* __restrict__ dk, T* __restrict__ dv, int S, int Tk, int H,
    float scale, int causal, int window) {
  using C = Cfg<T, D>;
  extern __shared__ __align__(128) uint8_t smem[];
  T* k_t = reinterpret_cast<T*>(smem + C::K_OFF);
  T* v_t = reinterpret_cast<T*>(smem + C::V_OFF);
  T* q_t = reinterpret_cast<T*>(smem + C::Q_OFF);
  T* do_t = reinterpret_cast<T*>(smem + C::DO_OFF);
  float* lse_s = reinterpret_cast<float*>(smem + C::LSE_OFF);
  float* delta_s = reinterpret_cast<float*>(smem + C::DELTA_OFF);
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int k0 = blockIdx.x * C::BK;
  const int nq = (S + C::BQ - 1) / C::BQ;
  // the query tiles that see a key of this tile: causal from the tile's
  // first key on; a window up to its last key + W - 1
  const int i_lo = causal ? k0 / C::BQ : 0;
  int i_hi = nq;
  if (window > 0)
    i_hi = min(nq, (min(k0 + C::BK, Tk) - 1 + window - 1) / C::BQ + 1);

  load_tile<T, D, C::BK, C::LD>(k_t, k, k0, Tk, H, h, b);
  load_tile<T, D, C::BK, C::LD>(v_t, v, k0, Tk, H, h, b);
  Accum<T, C::BK, D> acc_dk, acc_dv;
  acc_dk.zero();
  acc_dv.zero();
  for (int i = i_lo; i < i_hi; ++i) {
    const int q0 = i * C::BQ;
    __syncthreads();             // the last pair's products are done
    load_tile<T, D, C::BQ, C::LD>(q_t, q, q0, S, H, h, b);
    load_tile<T, D, C::BQ, C::LD>(do_t, dout, q0, S, H, h, b);
    load_rows<C::BQ>(lse_s, delta_s, lse, delta, q0, S, (size_t)bh);
    __syncthreads();
    scores<T, D>(smem);
    __syncthreads();
    p_and_ds<T, D>(smem, q0, k0, S, Tk, scale, causal, window);
    __syncthreads();
    // dv += p^T dout, dk += ds^T q
    acc_dv.template add<C::BQ, true, false>(p_tile<T, D>(smem), p_pitch<T, D>(),
                                            do_t, C::LD);
    acc_dk.template add<C::BQ, true, false>(ds_tile<T, D>(smem),
                                            p_pitch<T, D>(), q_t, C::LD);
  }
  __syncthreads();
  float* stage = reinterpret_cast<float*>(smem);
  acc_dv.store(dv, stage, k0, Tk, H, h, b);
  acc_dk.store(dk, stage, k0, Tk, H, h, b);
}

// grid (query tiles, B * H)
template <typename T, int D>
__global__ void __launch_bounds__(NT) dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    T* __restrict__ dq, int S, int Tk, int H, float scale, int causal,
    int window) {
  using C = Cfg<T, D>;
  extern __shared__ __align__(128) uint8_t smem[];
  T* k_t = reinterpret_cast<T*>(smem + C::K_OFF);
  T* v_t = reinterpret_cast<T*>(smem + C::V_OFF);
  T* q_t = reinterpret_cast<T*>(smem + C::Q_OFF);
  T* do_t = reinterpret_cast<T*>(smem + C::DO_OFF);
  float* lse_s = reinterpret_cast<float*>(smem + C::LSE_OFF);
  float* delta_s = reinterpret_cast<float*>(smem + C::DELTA_OFF);
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * C::BQ;
  const int nk = (Tk + C::BK - 1) / C::BK;
  // the key tiles its rows may see: causal up to the last row's key; a
  // window from the first row's first key in it on
  const int j_lo = window > 0 ? max(0, q0 - window + 1) / C::BK : 0;
  const int j_hi =
      causal ? min(nk, (min(q0 + C::BQ, S) - 1) / C::BK + 1) : nk;

  load_tile<T, D, C::BQ, C::LD>(q_t, q, q0, S, H, h, b);
  load_tile<T, D, C::BQ, C::LD>(do_t, dout, q0, S, H, h, b);
  load_rows<C::BQ>(lse_s, delta_s, lse, delta, q0, S, (size_t)bh);
  Accum<T, C::BQ, D> acc_dq;
  acc_dq.zero();
  for (int j = j_lo; j < j_hi; ++j) {
    const int k0 = j * C::BK;
    __syncthreads();
    load_tile<T, D, C::BK, C::LD>(k_t, k, k0, Tk, H, h, b);
    load_tile<T, D, C::BK, C::LD>(v_t, v, k0, Tk, H, h, b);
    __syncthreads();
    scores<T, D>(smem);
    __syncthreads();
    p_and_ds<T, D>(smem, q0, k0, S, Tk, scale, causal, window);
    __syncthreads();
    // dq += ds k
    acc_dq.template add<C::BK, false, false>(ds_tile<T, D>(smem),
                                             p_pitch<T, D>(), k_t, C::LD);
  }
  __syncthreads();
  acc_dq.store(dq, reinterpret_cast<float*>(smem), q0, S, H, h, b);
}

template <typename T, int D>
cudaError_t launch(const T* q, const T* k, const T* v, const T* out,
                   const T* dout, const float* lse, float* delta, T* dq,
                   T* dk, T* dv, int B, int S, int Tk, int H, float scale,
                   int causal, int window, cudaStream_t st) {
  using C = Cfg<T, D>;
  const long long rows = (long long)B * S * H;
  delta_kernel<T><<<(unsigned)((rows + WARPS - 1) / WARPS), NT, 0, st>>>(
      out, dout, delta, rows, S, H, D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  auto kv = dkdv_kernel<T, D>;
  auto kq = dq_kernel<T, D>;
  err = cudaFuncSetAttribute(kv, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             C::SMEM);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kq, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             C::SMEM);
  if (err != cudaSuccess) return err;
  kv<<<dim3((Tk + C::BK - 1) / C::BK, B * H), NT, C::SMEM, st>>>(
      q, k, v, dout, lse, delta, dk, dv, S, Tk, H, scale, causal, window);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  kq<<<dim3((S + C::BQ - 1) / C::BQ, B * H), NT, C::SMEM, st>>>(
      q, k, v, dout, lse, delta, dq, S, Tk, H, scale, causal, window);
  return cudaGetLastError();
}

}  // namespace

// q, out, dout, dq (B, S, H, D); k, v, dk, dv (B, T, H, D); all contiguous,
// 16-byte aligned and of one type (bf16 when is_bf16, else f32); lse and
// delta (B, H, S) f32, delta scratch written here.  D is 16, 32, 64, 128
// or 256; B * H at most 65535 (grid.y); window >= 0, and > 0 only with
// causal and S <= T.  The launcher checks all of it.  Returns the first
// CUDA error of the three launches, or 0.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, const float* lse, float* delta, void* dq, void* dk,
    void* dv, int B, int S, int T, int H, int D, int is_bf16, int causal,
    int window, float scale, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
#define LAUNCH_T(T_, D_)                                                  \
  return launch<T_, D_>((const T_*)q, (const T_*)k, (const T_*)v,         \
                        (const T_*)out, (const T_*)dout, lse, delta,      \
                        (T_*)dq, (T_*)dk, (T_*)dv, B, S, T, H, scale,     \
                        causal, window, st)
#define LAUNCH(D_)          \
  if (is_bf16) {            \
    LAUNCH_T(bf16, D_);     \
  } else {                  \
    LAUNCH_T(float, D_);    \
  }
  switch (D) {
    case 16: LAUNCH(16);
    case 32: LAUNCH(32);
    case 64: LAUNCH(64);
    case 128: LAUNCH(128);
    case 256: LAUNCH(256);
    default: return cudaErrorInvalidValue;
  }
#undef LAUNCH
#undef LAUNCH_T
}

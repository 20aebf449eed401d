// KNN kernels for Hopper (sm_90a): streaming distance -> top-k, and the
// blocked pairwise squared-distance matrix.
//
// topk_sqdist replaces the Pallas kernel repro/kernels/knn_topk.py::
// topk_sqdist (_topk_kernel, merge _select_topk).  For each row of a it
// folds column tiles of b into a running top-k of the similarity
// s = ((2 a.b - |a|^2) - |b|^2), masking padding (id < 0), self pairs,
// bucket-code mismatches and (with dedup) ids already in the state, and
// writes (ids, max(-s, 0)) in ascending distance.  A leading group
// dimension G runs independent problems in one launch: the forest's
// window blocks of one tree are one launch.
//   Bound: memory.  At the forest's shapes (M = 64 rows against N = 192
//   candidates, d = 100, k = 150) a group moves its a and b blocks and
//   reads and writes a (64, 150) state of ids and distances: at the
//   card's peaks the bytes take about twice the time of its 2*M*N*d
//   flops in f32.  The merge of each candidate into a 150-long sorted
//   list is what the simple design spends its time on.
//   Design: one block of 8 warps owns (group, 32 rows); blocks are one
//   linear index over (group, row tile), so G * ceil(M / 32) may reach
//   2^31 - 1.  The running state (sims and ids, k <= 256) of its rows
//   lives in shared memory, sorted descending.  For each chunk of up to
//   64 columns the block stages a and b in 32-wide feature slices, every
//   thread accumulates 8 dot products with fp32 FMAs in feature order
//   (no tensor cores, no TF32; cuBLAS's f32 GEMM sums in the same order,
//   so these products are bitwise the plain version's).  From the same
//   staged slices three warps sum the row norms |b|^2 of the chunk's
//   columns and, in the first chunk, |a|^2 of the block's rows, left to
//   right in feature order with every product and sum rounded on its own
//   (ref.sq_norms's order).  The block then masks the similarities, and
//   each warp inserts its rows' surviving
//   candidates one by one: position by ballot over the list, shift by
//   one.  Insertion with a strict '>' puts a candidate after every equal
//   entry already present, so ties keep the earliest position, as
//   lax.top_k does.  With dedup the state's ids are snapshotted at each
//   column-tile boundary of width bn, the JAX oracle's semantics; only
//   candidates that beat the snapshot's k-th similarity are compared
//   with it.
//
// pairwise_sqdist replaces repro/kernels/knn_topk.py::pairwise_sqdist.
//   Bound: at d = 100 (graph recall) its 2d flops per entry at the
//   card's f32 rate; at d = 2 (the layout metric) the (M, N) f32 matrix
//   it writes.
//   Design: 64x64 output tiles (one linear block index), 16-wide feature
//   slices in shared memory, 4x4 outputs per thread with fp32 FMAs in
//   feature order; two warps sum the tile's row norms from the same
//   slices in ref.sq_norms's order: out = max((|a|^2 + |b|^2) - 2 a.b, 0).
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr float INVALID_SIM = -3.0e38f;
constexpr int BM = 32;        // rows per block
constexpr int BNK = 64;       // columns per compute chunk
constexpr int DK = 32;        // feature slice staged in shared memory
constexpr int THREADS = 256;  // 8 warps
constexpr int ROWS_PER_WARP = BM / (THREADS / 32);
constexpr int MAX_K = 256;

__host__ __device__ inline size_t topk_smem_bytes(int k, int dedup) {
  size_t words = (size_t)BM * k * 2            // state sims + ids
               + (dedup ? (size_t)BM * k : 0)  // snapshot ids
               + BM                            // snapshot k-th sim
               + (size_t)BM * BNK              // masked tile sims
               + (size_t)BM * (DK + 1)         // a slice
               + (size_t)BNK * (DK + 1)        // b slice
               + BM + BNK                      // norms
               + BM + BNK;                     // ids
  return words * 4;
}

__global__ void __launch_bounds__(THREADS)
topk_kernel(const float* __restrict__ a, const float* __restrict__ b,
            const int* __restrict__ a_ids, const int* __restrict__ b_ids,
            const int* __restrict__ codes_a, const int* __restrict__ codes_b,
            int T, const int* __restrict__ init_ids,
            const float* __restrict__ init_dists, int* __restrict__ out_ids,
            float* __restrict__ out_dists, int M, int N, int d, int k,
            int bn, int dedup) {
  extern __shared__ float smem[];
  float* st_s = smem;                                        // [BM][k]
  int* st_i = reinterpret_cast<int*>(st_s + BM * k);         // [BM][k]
  int* snap_i = st_i + BM * k;                               // [BM][k]
  float* snap_kth = reinterpret_cast<float*>(snap_i + (dedup ? BM * k : 0));
  float* tile = snap_kth + BM;                               // [BM][BNK]
  float* a_sh = tile + BM * BNK;                             // [BM][DK+1]
  float* b_sh = a_sh + BM * (DK + 1);                        // [BNK][DK+1]
  float* an_sh = b_sh + BNK * (DK + 1);
  float* bn_sh = an_sh + BM;
  int* aid_sh = reinterpret_cast<int*>(bn_sh + BNK);
  int* bid_sh = aid_sh + BM;

  const int row_tiles = (M + BM - 1) / BM;
  const int g = blockIdx.x / row_tiles;
  const int r0 = (blockIdx.x - g * row_tiles) * BM;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float* ag = a + (size_t)g * M * d;
  const float* bg = b + (size_t)g * N * d;

  // ---- running state and row ids -------------------------------------
  for (int idx = tid; idx < BM * k; idx += THREADS) {
    const int r = idx / k, t = idx - r * k, row = r0 + r;
    int id = -1;
    float s = INVALID_SIM;
    if (init_ids != nullptr && row < M) {
      const size_t o = ((size_t)g * M + row) * k + t;
      id = init_ids[o];
      s = fmaxf(-init_dists[o], INVALID_SIM);
    }
    st_s[idx] = s;
    st_i[idx] = id;
  }
  if (tid < BM) {
    const int row = r0 + tid;
    aid_sh[tid] = row < M ? a_ids[(size_t)g * M + row] : -1;
  }
  __syncthreads();
  if (init_ids != nullptr && tid < BM) {
    // stable insertion sort, descending: the seed need not be sorted
    float* ss = st_s + tid * k;
    int* si = st_i + tid * k;
    for (int t = 1; t < k; ++t) {
      const float v = ss[t];
      const int vi = si[t];
      int u = t - 1;
      while (u >= 0 && ss[u] < v) {
        ss[u + 1] = ss[u];
        si[u + 1] = si[u];
        --u;
      }
      ss[u + 1] = v;
      si[u + 1] = vi;
    }
  }
  __syncthreads();

  // thread -> (row r, columns c0 + cc + 8u) of the dot-product tile
  const int r = tid >> 3;
  const int cc = tid & 7;
  for (int c0 = 0; c0 < N; ) {
    int cw = min(BNK, N - c0);
    if (dedup) {
      cw = min(cw, bn - c0 % bn);            // never straddle a dedup tile
      if (c0 % bn == 0) {
        for (int idx = tid; idx < BM * k; idx += THREADS)
          snap_i[idx] = st_i[idx];
        if (tid < BM) snap_kth[tid] = st_s[tid * k + k - 1];
      }
    }
    if (tid < cw) bid_sh[tid] = b_ids[(size_t)g * N + c0 + tid];

    // threads [0, BNK) sum |b|^2 of column tid, threads [BNK, BNK + BM)
    // |a|^2 of row tid - BNK (first chunk only), in feature order
    const bool norm_b = tid < BNK;
    const bool norm_a = c0 == 0 && tid >= BNK && tid < BNK + BM;
    const float* norm_src = norm_b ? b_sh + tid * (DK + 1)
                                   : a_sh + (tid - BNK) * (DK + 1);
    float nrm = 0.0f;
    float acc[BNK / 8];
#pragma unroll
    for (int u = 0; u < BNK / 8; ++u) acc[u] = 0.0f;
    for (int q0 = 0; q0 < d; q0 += DK) {
      const int dk = min(DK, d - q0);
      for (int idx = tid; idx < BM * DK; idx += THREADS) {
        const int rr = idx / DK, q = idx - rr * DK, row = r0 + rr;
        a_sh[rr * (DK + 1) + q] =
            (row < M && q < dk) ? ag[(size_t)row * d + q0 + q] : 0.0f;
      }
      for (int idx = tid; idx < BNK * DK; idx += THREADS) {
        const int c = idx / DK, q = idx - c * DK;
        b_sh[c * (DK + 1) + q] =
            (c < cw && q < dk) ? bg[(size_t)(c0 + c) * d + q0 + q] : 0.0f;
      }
      __syncthreads();
      if (norm_b || norm_a) {
        for (int q = 0; q < dk; ++q)
          nrm = __fadd_rn(nrm, __fmul_rn(norm_src[q], norm_src[q]));
      }
      for (int q = 0; q < dk; ++q) {
        const float av = a_sh[r * (DK + 1) + q];
#pragma unroll
        for (int u = 0; u < BNK / 8; ++u)
          acc[u] = fmaf(av, b_sh[(cc + 8 * u) * (DK + 1) + q], acc[u]);
      }
      __syncthreads();
    }
    if (norm_b) bn_sh[tid] = nrm;
    if (norm_a) an_sh[tid - BNK] = nrm;
    __syncthreads();

    // ---- similarity + masks (the state is not touched yet) ------------
    const int row = r0 + r;
#pragma unroll
    for (int u = 0; u < BNK / 8; ++u) {
      const int c = cc + 8 * u;
      if (c >= cw) continue;
      float s = __fsub_rn(__fsub_rn(2.0f * acc[u], an_sh[r]), bn_sh[c]);
      const int bid = bid_sh[c];
      bool bad = row >= M || bid < 0 || bid == aid_sh[r];
      if (!bad && codes_a != nullptr) {
        bool match = false;
        const int* ca = codes_a + ((size_t)g * M + row) * T;
        const int* cb = codes_b + ((size_t)g * N + c0 + c) * T;
        for (int t = 0; t < T; ++t) match |= ca[t] == cb[t];
        bad = !match;
      }
      if (!bad && dedup && s > snap_kth[r]) {
        const int* si = snap_i + r * k;
        for (int t = 0; t < k; ++t) {
          if (si[t] == bid) {
            bad = true;
            break;
          }
        }
      }
      tile[r * BNK + c] = bad ? INVALID_SIM : s;
    }
    __syncthreads();

    // ---- merge: each warp inserts its rows' candidates in column order
    for (int rr = 0; rr < ROWS_PER_WARP; ++rr) {
      const int wr = warp * ROWS_PER_WARP + rr;
      if (r0 + wr >= M) break;
      float* ss = st_s + wr * k;
      int* si = st_i + wr * k;
      for (int c = 0; c < cw; ++c) {
        const float v = tile[wr * BNK + c];
        if (!(v > ss[k - 1])) continue;
        int pos = 0;                         // entries >= v stay in front
        for (int t0 = 0; t0 < k; t0 += 32) {
          const int t = t0 + lane;
          pos += __popc(__ballot_sync(0xffffffffu, t < k && ss[t] >= v));
        }
        for (int t0 = ((k - 2) >> 5) << 5; t0 >= 0 && t0 + 31 >= pos;
             t0 -= 32) {
          const int t = t0 + lane;
          const bool mv = t >= pos && t < k - 1;
          float sv = 0.0f;
          int iv = 0;
          if (mv) {
            sv = ss[t];
            iv = si[t];
          }
          __syncwarp();
          if (mv) {
            ss[t + 1] = sv;
            si[t + 1] = iv;
          }
          __syncwarp();
        }
        if (lane == 0) {
          ss[pos] = v;
          si[pos] = bid_sh[c];
        }
        __syncwarp();
      }
    }
    __syncthreads();
    c0 += cw;
  }

  for (int idx = tid; idx < BM * k; idx += THREADS) {
    const int rr = idx / k, t = idx - rr * k, row2 = r0 + rr;
    if (row2 < M) {
      const size_t o = ((size_t)g * M + row2) * k + t;
      out_ids[o] = st_i[idx];
      out_dists[o] = fmaxf(-st_s[idx], 0.0f);
    }
  }
}

constexpr int PT = 64;   // pairwise output tile
constexpr int PK = 16;   // feature slice

__global__ void __launch_bounds__(256)
pairwise_kernel(const float* __restrict__ a, const float* __restrict__ b,
                float* __restrict__ out, int M, int N, int d) {
  __shared__ float as[PT][PK + 1];
  __shared__ float bs[PT][PK + 1];
  __shared__ float an_sh[PT], bn_sh[PT];
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int n_tiles = (N + PT - 1) / PT;
  const int m0 = (blockIdx.x / n_tiles) * PT;
  const int n0 = (blockIdx.x % n_tiles) * PT;
  // threads [0, PT) sum |a|^2 of tile row tid, [PT, 2 PT) |b|^2 of tile
  // column tid - PT, in feature order
  const float* norm_src = tid < PT ? as[tid] : bs[(tid - PT) & (PT - 1)];
  float nrm = 0.0f;
  float acc[4][4] = {};
  for (int q0 = 0; q0 < d; q0 += PK) {
    const int dk = min(PK, d - q0);
    for (int idx = tid; idx < PT * PK; idx += 256) {
      const int rr = idx / PK, q = idx - rr * PK;
      as[rr][q] = (m0 + rr < M && q < dk)
                      ? a[(size_t)(m0 + rr) * d + q0 + q] : 0.0f;
      bs[rr][q] = (n0 + rr < N && q < dk)
                      ? b[(size_t)(n0 + rr) * d + q0 + q] : 0.0f;
    }
    __syncthreads();
    if (tid < 2 * PT) {
      for (int q = 0; q < dk; ++q)
        nrm = __fadd_rn(nrm, __fmul_rn(norm_src[q], norm_src[q]));
    }
    for (int q = 0; q < dk; ++q) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        av[i] = as[ty * 4 + i][q];
        bv[i] = bs[tx + 16 * i][q];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
  if (tid < PT) an_sh[tid] = nrm;
  else if (tid < 2 * PT) bn_sh[tid - PT] = nrm;
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty * 4 + i;
    if (row >= M) continue;
    const float na = an_sh[ty * 4 + i];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx + 16 * j;
      if (col < N)
        out[(size_t)row * N + col] = fmaxf(
            __fsub_rn(__fadd_rn(na, bn_sh[tx + 16 * j]), 2.0f * acc[i][j]),
            0.0f);
    }
  }
}

}  // namespace

extern "C" int topk_sqdist_launch(
    const float* a, const float* b, const int* a_ids, const int* b_ids,
    const int* codes_a, const int* codes_b, int T, const int* init_ids,
    const float* init_dists, int* out_ids, float* out_dists, int G, int M,
    int N, int d, int k, int bn, int dedup, void* stream) {
  if (k < 1 || k > MAX_K || bn < 1) return cudaErrorInvalidValue;
  if (G == 0 || M == 0) return cudaSuccess;
  const long long blocks = (long long)G * ((M + BM - 1) / BM);
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  const size_t smem = topk_smem_bytes(k, dedup);
  cudaError_t err = cudaFuncSetAttribute(
      topk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  topk_kernel<<<(unsigned)blocks, THREADS, smem, (cudaStream_t)stream>>>(
      a, b, a_ids, b_ids, codes_a, codes_b, T, init_ids,
      init_dists, out_ids, out_dists, M, N, d, k, bn, dedup);
  return cudaGetLastError();
}

extern "C" int topk_sqdist_max_k() { return MAX_K; }

extern "C" int pairwise_sqdist_launch(const float* a, const float* b,
                                      float* out, int M, int N, int d,
                                      void* stream) {
  if (M == 0 || N == 0) return cudaSuccess;
  const long long blocks =
      (long long)((M + PT - 1) / PT) * ((N + PT - 1) / PT);
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  pairwise_kernel<<<(unsigned)blocks, 256, 0, (cudaStream_t)stream>>>(
      a, b, out, M, N, d);
  return cudaGetLastError();
}

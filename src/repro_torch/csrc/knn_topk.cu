// KNN kernels for Hopper (sm_90a): streaming distance -> top-k, and the
// blocked pairwise squared-distance matrix.
//
// topk_sqdist replaces the Pallas kernel repro/kernels/knn_topk.py::
// topk_sqdist (_topk_kernel, merge _select_topk).  For each row of a it
// folds the columns of b into a running top-k of the similarity
// s = ((2 a.b - |a|^2) - |b|^2), masking padding (id < 0), self pairs,
// bucket-code mismatches and (with dedup) ids already in the state, and
// writes (ids, max(-s, 0)) in ascending distance.  A leading group
// dimension G runs independent problems in one launch (the forest's
// window blocks of one tree).  a and b are read in place: either (G, M, d)
// and (G, N, d) blocks, or a base matrix and (G, M) / (G, N) int32 row
// indices, -1 reading a zero row (the window fold passes x and the
// sorted order, and never gathers its 3x larger candidate blocks).
//   Bound: at the forest's shapes (G = 1563 groups of 64 rows against 192
//   candidates, d = 100, k = 150) the bytes: x read once and a (64, 150)
//   state of ids and distances read and written a group; at the queries'
//   (10,000 rows against 100,000, d = 100) the 2*M*N*d f32 operations.
//   Design: one block of 4 warps owns (group, 32 rows); blocks are one
//   linear index over (group, row tile), at most 2^31 - 1.
//   * Products.  The block walks one stream of (chunk of up to 64
//     columns, 16-wide feature slice) steps.  cp.async copies each slice
//     of a and b into shared memory, 16 bytes at a time when d % 4 == 0
//     (else 4), zero-filled past the edges and for index -1, XOR-swizzled
//     so that eight consecutive rows read at one offset hit eight bank
//     groups; three stages keep two slices in flight across chunk
//     boundaries, with one barrier a slice.  Every thread keeps a 4 x 4
//     register tile of outputs (rows ty + 8i, columns tx + 16j) and
//     reads its a and b values as float4s of four features.  Each output
//     is one fp32 FMA chain in feature order from 0 (no tensor cores, no
//     TF32): cuBLAS's f32 GEMM sums in the same order at these shapes,
//     so these products are bitwise the plain version's.  From the same
//     slices two warps sum |b|^2 of the chunk's columns and, in the first
//     chunk, |a|^2 of the rows, left to right in feature order with every
//     product and sum rounded on its own (ref.sq_norms's order).
//   * Threshold filter.  A candidate survives only if s beats its row's
//     current k-th similarity; the masks are tested only for survivors.
//     Once the state is full almost every candidate fails: about
//     k ln(N / k) of the queries' 100,000 columns pass.
//   * Batched merge.  A chunk's survivors are counted first; a row whose
//     buffer (CAP (s, column) keys in shared memory) would overflow is
//     merged before they are appended, and every buffer is merged at
//     each dedup tile's end and at the end.  The row's warp drops what
//     no longer beats the k-th similarity and (with dedup) the ids of
//     the snapshot, sorts the rest bitonically in registers by (s desc,
//     column asc), and merges it with the sorted state along the merge
//     path: every entry finds its output rank by binary search in the
//     other list, the state first among ties, and ranks below k are
//     written.  That is lax.top_k's earliest-position order over
//     concat(state, columns), one merge per batch of up to CAP instead
//     of one insertion per candidate.  With dedup the state's ids are
//     snapshotted at each column-tile boundary of width bn (the JAX
//     oracle's semantics).
//   * Memory.  The running state (sims, descending, and ids) lives in
//     the output arrays: only merges touch it, each taking up to CAP
//     survivors, so it takes no shared memory; the sims become distances
//     at the end.  Shared memory holds the buffers, the slices
//     and (with dedup) the snapshot: 38 KB a block at k = 150 without
//     dedup, 57 KB with it.  ptxas reports no spills at four blocks an
//     SM (118-124 registers).
//   The masks run in one loop over a chunk's survivors: unrolled over the
//   16 outputs (with the bucket-code loop) they spread the chunk's path
//   over so much code that the instruction fetch set the pace.  Where
//   the time still goes (PERF.md): the queries' 313 row tiles give about
//   2.4 blocks an SM, and each block's pass over 100,000 columns is
//   bound by its own instruction latencies (one block alone takes 16 ms
//   of the grid's 21).  Measured no faster: a third or fourth block an
//   SM, 32-wide slices, two or four stages, larger buffers, and cutting
//   each row tile's columns into ranges merged by a second kernel (each
//   range fills its own state, so the merges grow more than the
//   products shrink).
//   Similarities compare in IEEE total order (-0.0 below +0.0), as XLA
//   sorts them and as ref.topk_sqdist_ref does: a seeded distance of 0 is
//   a state entry at -0.0, which ranks below a candidate at +0.0.
//   ids and distances stay bitwise the plain version's (the same products
//   and norms, and an exact selection), whatever the buffer's size.
//
// pairwise_sqdist replaces repro/kernels/knn_topk.py::pairwise_sqdist.
//   Bound: at d = 100 (graph recall) its 2d flops per entry at the
//   card's f32 rate; at d = 2 (the layout metric) the (M, N) f32 matrix
//   it writes.
//   Design: Hopper's SIMT path, no tensor cores and no TF32 (a TF32
//   product rounds otherwise, and the metrics rank by a stable sort,
//   where ties decide).  128 x 128 output tiles, one linear block index
//   with the row tiles varying fastest (the blocks resident at once
//   share a few b tiles, so b comes from DRAM about once); 256 threads,
//   each owning 8 x 8 outputs (rows ty + 16i, columns 4tx + 64h + c), so
//   a thread reads its 8 a-values and 8 b-values of four features as
//   eight float4s each: 16 products for every shared load.  cp.async
//   stages 32-wide feature slices of a and b in three stages (two in
//   flight while one is consumed, one barrier a slice), 16 bytes at a
//   time when d % 4 == 0 (else 4), zero-filled past the edges, in rows
//   of 16-byte chunks XOR-swizzled by row / 4, so that the eight rows a
//   quarter-warp reads at one chunk, and the eight chunks of a row it
//   writes, hit eight distinct bank groups.  (Feature-major tiles would
//   also give float4 reads, but a 16-byte copy of a row-major source
//   lands four features of one row side by side.)  Each output is one
//   fp32 FMA chain in feature order from 0; every thread also sums one
//   row norm from the same slices, in ref.sq_norms's order; the epilogue
//   is max((|a|^2 + |b|^2) - 2 a.b, 0), each operation rounded on its
//   own, written four columns a store (streaming).  So the outputs do
//   not depend on the tiling, and equal the plain version's wherever
//   cuBLAS sums in feature order.
//   Where the time goes (PERF.md): at d = 100 the products themselves,
//   at under half the f32 rate; without its shared loads the kernel is
//   barely faster, and cuBLAS's f32 product of the same shapes alone takes
//   most of its time.  The writes overlap the products already.
//   Measured no faster: 8 x 4 warps, one block an SM (with the next
//   chunk's operands loaded during the current one's products), two
//   stages, a chunk loop not unrolled, bulk-copy (TMA) stores, a
//   persistent grid with staggered blocks, norms from a prepass kernel.
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr float INVALID_SIM = -3.0e38f;
constexpr int BM = 32;          // rows per block
constexpr int BNK = 64;         // columns per chunk
constexpr int DK = 16;          // feature slice
constexpr int THREADS = 128;    // 4 warps; a warp merges 8 rows
constexpr int WARPS = THREADS / 32;
constexpr int ROWS_PER_WARP = BM / WARPS;
constexpr int CAP = BNK + 8;    // buffered candidates a row
constexpr int NST = 3;          // slice stages in flight
constexpr int MAX_K = 256;
constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned long long NO_KEY = ~0ull;

__host__ __device__ inline int pad4(int k) { return (k + 3) & ~3; }

__host__ __device__ inline size_t topk_smem_bytes(int k, int dedup) {
  return (size_t)BM * CAP * 8                  // buffer keys
         + (size_t)BM * 8                      // row offsets of a
         + (size_t)NST * DK * (BM + BNK) * 4   // slices of a and b
         + (dedup ? (size_t)BM * pad4(k) * 4 : 0)  // snapshot ids
         + (size_t)(BM + BNK + BM) * 4         // norms, k-th sims
         + (size_t)3 * BM * 4;                 // row ids, buffer counts
}

// An f32's rank in IEEE total order (-0.0 below +0.0), the order XLA
// sorts in: a seeded distance of 0 is a state entry at -0.0, which
// lax.top_k ranks below a candidate at +0.0.  Every comparison of
// similarities goes through it.
__device__ inline unsigned ord_of(float s) {
  const unsigned u = __float_as_uint(s);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// (s desc, column asc) as one ascending 64-bit key.
__device__ inline unsigned long long make_key(float s, int pos) {
  return ((unsigned long long)(~ord_of(s)) << 32) | (unsigned)pos;
}

__device__ inline unsigned key_ord(unsigned long long key) {
  return ~(unsigned)(key >> 32);
}

__device__ inline float key_sim(unsigned long long key) {
  unsigned u = ~(unsigned)(key >> 32);
  u = (u & 0x80000000u) ? (u & 0x7fffffffu) : ~u;
  return __uint_as_float(u);
}

__device__ inline int key_pos(unsigned long long key) {
  return (int)(unsigned)(key & 0xffffffffu);
}

__device__ inline void cp_async4(void* smem, const float* src, bool ok) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 4 : 0));
}

__device__ inline void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N_PENDING>
__device__ inline void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N_PENDING));
}

// Bitonic sort of P = 32 * T keys held striped (element t * 32 + lane),
// ascending.
template <int T>
__device__ inline void warp_sort(unsigned long long (&key)[4], int lane) {
  constexpr int P = 32 * T;
#pragma unroll
  for (int size = 2; size <= P; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      if (stride >= 32) {
        const int ts = stride >> 5;
#pragma unroll
        for (int t = 0; t < T; ++t) {
          if (t & ts) continue;
          const bool asc = ((t * 32 + lane) & size) == 0;
          const unsigned long long lo = key[t], hi = key[t | ts];
          const bool swap = asc ? lo > hi : lo < hi;
          key[t] = swap ? hi : lo;
          key[t | ts] = swap ? lo : hi;
        }
      } else {
#pragma unroll
        for (int t = 0; t < T; ++t) {
          const unsigned long long other =
              __shfl_xor_sync(FULL, key[t], stride);
          const bool asc = ((t * 32 + lane) & size) == 0;
          const bool lower = (lane & stride) == 0;
          const unsigned long long mn = key[t] < other ? key[t] : other;
          const unsigned long long mx = key[t] < other ? other : key[t];
          key[t] = (asc == lower) ? mn : mx;
        }
      }
    }
  }
}

struct TopkArgs {
  const float* a;
  const int* a_idx;
  const float* b;
  const int* b_idx;
  const int* a_ids;
  const int* b_ids;
  const int* codes_a;
  const int* codes_b;
  int T;
  const int* init_ids;
  const float* init_dists;
  int* out_ids;
  float* out_dists;
  int M, N, d, k, bn, dedup;
};

// Merge row r's buffer into its state; one warp, every lane.
__device__ void merge_row(const TopkArgs& p, int g, int r, float* ss,
                          int* si, const int* snap, unsigned long long* bk,
                          int* cnt, float* thr, int lane) {
  const int n = cnt[r];
  const int k = p.k;
  const unsigned kth = ord_of(ss[k - 1]);
  unsigned long long key[4];
  int nv = 0;
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const int j = t * 32 + lane;
    key[t] = NO_KEY;
    bool keep = false;
    if (j < n) {
      key[t] = bk[j];
      keep = key_ord(key[t]) > kth;
    }
    if (p.dedup && __any_sync(FULL, keep)) {
      const int id = keep ? (p.b_ids ? p.b_ids[(size_t)g * p.N +
                                               key_pos(key[t])]
                                     : key_pos(key[t]))
                          : -2;
      const int4* sn = reinterpret_cast<const int4*>(snap);
      bool dup = false;
      for (int x = 0; x < pad4(k) / 4; ++x) {
        const int4 v = sn[x];
        dup |= (v.x == id) | (v.y == id) | (v.z == id) | (v.w == id);
      }
      keep &= !dup;
    }
    if (!keep) key[t] = NO_KEY;
    nv += __popc(__ballot_sync(FULL, keep));
  }
  cnt[r] = 0;            // every lane read n above; nobody appends now
  if (nv == 0) return;
  if (n <= 32) warp_sort<1>(key, lane);
  else if (n <= 64) warp_sort<2>(key, lane);
  else warp_sort<4>(key, lane);
  __syncwarp();
#pragma unroll
  for (int t = 0; t < 4; ++t)
    if (t * 32 + lane < nv) bk[t * 32 + lane] = key[t];
  __syncwarp();

  // ranks along the merge path, the state first among ties
  float s_st[MAX_K / 32];
  int i_st[MAX_K / 32], r_st[MAX_K / 32];
#pragma unroll
  for (int t = 0; t < MAX_K / 32; ++t) {
    const int i = t * 32 + lane;
    r_st[t] = k;
    if (i < k) {
      s_st[t] = ss[i];
      i_st[t] = si[i];
      const unsigned o = ord_of(s_st[t]);
      int lo = 0, hi = nv;          // first buffer entry with s <= s_st
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (key_ord(bk[mid]) > o) lo = mid + 1;
        else hi = mid;
      }
      r_st[t] = i + lo;
    }
  }
  float s_bf[4];
  int i_bf[4], r_bf[4];
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const int j = t * 32 + lane;
    r_bf[t] = k;
    if (j < nv) {
      s_bf[t] = key_sim(key[t]);
      const int pos = key_pos(key[t]);
      i_bf[t] = p.b_ids ? p.b_ids[(size_t)g * p.N + pos] : pos;
      const unsigned o = key_ord(key[t]);
      int lo = 0, hi = k;           // first state entry with s < s_bf
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (ord_of(ss[mid]) >= o) lo = mid + 1;
        else hi = mid;
      }
      r_bf[t] = j + lo;
    }
  }
  __syncwarp();
#pragma unroll
  for (int t = 0; t < MAX_K / 32; ++t) {
    if (r_st[t] < k) {
      ss[r_st[t]] = s_st[t];
      si[r_st[t]] = i_st[t];
    }
  }
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    if (r_bf[t] < k) {
      ss[r_bf[t]] = s_bf[t];
      si[r_bf[t]] = i_bf[t];
    }
  }
  __syncwarp();
  if (lane == 0) thr[r] = ss[k - 1];
  __syncwarp();
}

// 16-byte chunk c4 (of 4) of row `row` in a slice, XOR-swizzled so that
// eight consecutive rows read at one chunk hit eight distinct bank groups.
__device__ inline int swz(int row, int c4) {
  return row * DK + ((c4 ^ ((row >> 1) & 3)) << 2);
}

__device__ inline void cp_async16(void* smem, const float* src, bool ok) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 16 : 0));
}

// VEC: d % 4 == 0 and 16-byte aligned bases, so a slice moves in 16-byte
// copies; otherwise in 4-byte copies of single features.
template <bool VEC>
__global__ void __launch_bounds__(THREADS, 4)
topk_kernel(const TopkArgs p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int M = p.M, N = p.N, d = p.d, k = p.k;
  const int kp = pad4(k);
  unsigned long long* bufk = reinterpret_cast<unsigned long long*>(smem_raw);
  long long* arow = reinterpret_cast<long long*>(bufk + BM * CAP);
  float* as = reinterpret_cast<float*>(arow + BM);       // [NST][BM][DK]
  float* bs = as + NST * BM * DK;                        // [NST][BNK][DK]
  int* snap = reinterpret_cast<int*>(bs + NST * BNK * DK);  // [BM][kp]
  float* an_sh = reinterpret_cast<float*>(snap + (p.dedup ? BM * kp : 0));
  float* bn_sh = an_sh + BM;
  float* thr = bn_sh + BNK;
  int* aid_sh = reinterpret_cast<int*>(thr + BM);
  int* cnt = aid_sh + BM;
  int* pend = cnt + BM;

  const int row_tiles = (M + BM - 1) / BM;
  const int g = blockIdx.x / row_tiles;
  const int r0 = (blockIdx.x - g * row_tiles) * BM;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int rows = min(BM, M - r0);
  // The running state (sims, descending, and ids) of the block's rows
  // lives in the outputs themselves: only merges touch it, so it need
  // not take shared memory.  The sims become distances at the end.
  float* st_s = p.out_dists + ((size_t)g * M + r0) * k;
  int* st_i = p.out_ids + ((size_t)g * M + r0) * k;

  // ---- running state, row ids and row offsets -------------------------
  for (int idx = tid; idx < rows * k; idx += THREADS) {
    int id = -1;
    float s = INVALID_SIM;
    if (p.init_ids != nullptr) {
      const size_t o = ((size_t)g * M + r0) * k + idx;
      id = p.init_ids[o];
      s = fmaxf(-p.init_dists[o], INVALID_SIM);
    }
    st_s[idx] = s;
    st_i[idx] = id;
  }
  if (tid < BM) {
    const int row = r0 + tid;
    const size_t o = (size_t)g * M + row;
    aid_sh[tid] = (row < M && p.a_ids != nullptr) ? p.a_ids[o] : -1;
    long long off = -1;
    if (row < M) {
      if (p.a_idx == nullptr) off = (long long)o * d;
      else if (p.a_idx[o] >= 0) off = (long long)p.a_idx[o] * d;
    }
    arow[tid] = off;
    cnt[tid] = 0;
    pend[tid] = 0;
  }
  __syncthreads();
  if (p.init_ids != nullptr && tid < rows) {
    // stable insertion sort, descending: the seed need not be sorted
    float* ss = st_s + tid * k;
    int* si = st_i + tid * k;
    for (int t = 1; t < k; ++t) {
      const float v = ss[t];
      const int vi = si[t];
      int u = t - 1;
      while (u >= 0 && ord_of(ss[u]) < ord_of(v)) {
        ss[u + 1] = ss[u];
        si[u + 1] = si[u];
        --u;
      }
      ss[u + 1] = v;
      si[u + 1] = vi;
    }
  }
  __syncthreads();
  if (tid < rows) thr[tid] = st_s[tid * k + k - 1];

  // ---- the slice stream: (chunk, feature slice) in order, NST - 1 ahead
  auto width = [&](int c0) {
    int w = min(BNK, N - c0);
    if (p.dedup) w = min(w, p.bn - c0 % p.bn);  // never straddle a tile
    return w;
  };
  auto b_off = [&](int col) -> long long {     // element offset, -1 pad
    const size_t o = (size_t)g * N + col;
    if (p.b_idx == nullptr) return (long long)o * d;
    const int bi = p.b_idx[o];
    return bi >= 0 ? (long long)bi * d : -1;
  };
  // VEC: each thread copies the same 16-byte chunk of the same rows in
  // every slice of a chunk, so their offsets are worked out once: the a
  // rows' for the block, the b rows' when the cursor enters a chunk.
  constexpr int C4 = DK / 4;           // 16-byte chunks of a slice row
  constexpr int AU = BM * C4 / THREADS, BU = BNK * C4 / THREADS;
  long long a_off[AU], b_off_c[BU];
#pragma unroll
  for (int u = 0; u < AU; ++u) a_off[u] = arow[(tid + u * THREADS) / C4];
  int ic0 = 0, icw = N > 0 ? width(0) : 0, iq0 = 0, stage_w = 0;
  auto issue_next = [&]() {
    if (ic0 < N) {
      float* as_s = as + stage_w * BM * DK;
      float* bs_s = bs + stage_w * BNK * DK;
      if (VEC) {
        const int c4 = tid % C4;
#pragma unroll
        for (int u = 0; u < AU; ++u) {
          const int row = (tid + u * THREADS) / C4;
          const bool ok = a_off[u] >= 0 && iq0 + 4 * c4 < d;
          cp_async16(&as_s[swz(row, c4)],
                     ok ? p.a + a_off[u] + iq0 + 4 * c4 : p.a, ok);
        }
#pragma unroll
        for (int u = 0; u < BU; ++u) {
          const int row = (tid + u * THREADS) / C4;
          if (iq0 == 0) b_off_c[u] = row < icw ? b_off(ic0 + row) : -1;
          const bool ok = b_off_c[u] >= 0 && iq0 + 4 * c4 < d;
          cp_async16(&bs_s[swz(row, c4)],
                     ok ? p.b + b_off_c[u] + iq0 + 4 * c4 : p.b, ok);
        }
      } else {
#pragma unroll
        for (int u = 0; u < BM * DK / THREADS; ++u) {
          const int idx = tid + u * THREADS, row = idx / DK, q = idx % DK;
          const long long off = arow[row];
          const bool ok = off >= 0 && iq0 + q < d;
          cp_async4(&as_s[swz(row, q >> 2) + (q & 3)],
                    ok ? p.a + off + iq0 + q : p.a, ok);
        }
#pragma unroll
        for (int u = 0; u < BNK * DK / THREADS; ++u) {
          const int idx = tid + u * THREADS, row = idx / DK, q = idx % DK;
          const long long off = row < icw ? b_off(ic0 + row) : -1;
          const bool ok = off >= 0 && iq0 + q < d;
          cp_async4(&bs_s[swz(row, q >> 2) + (q & 3)],
                    ok ? p.b + off + iq0 + q : p.b, ok);
        }
      }
      iq0 += DK;
      if (iq0 >= d) {
        iq0 = 0;
        ic0 += icw;
        icw = ic0 < N ? width(ic0) : 0;
      }
    }
    cp_async_commit();                 // empty groups keep the count even
    stage_w = stage_w + 1 == NST ? 0 : stage_w + 1;
  };
#pragma unroll
  for (int t = 0; t < NST - 1; ++t) issue_next();

  // thread -> rows ty + 8i, columns tx + 16j of a chunk (i, j < 4)
  const int tx = tid & 15, ty = tid >> 4;
  const bool norm_b = tid < BNK;
  const bool norm_a_thread = tid >= BNK && tid < BNK + BM;
  int stage_r = 0;

  for (int c0 = 0; c0 < N;) {
    const int cw = width(c0);
    const bool tile_end = c0 + cw == N || (c0 + cw) % p.bn == 0;
    if (p.dedup && c0 % p.bn == 0) {
      for (int idx = tid; idx < BM * kp; idx += THREADS) {
        const int r = idx / kp, t = idx - r * kp;
        snap[idx] = t < k && r < rows ? st_i[r * k + t] : -2;
      }
    }
    const bool norm_a = norm_a_thread && c0 == 0;
    const int nrow = norm_b ? tid : tid - BNK;
    float nrm = 0.0f;
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

    for (int q0 = 0; q0 < d; q0 += DK) {
      cp_async_wait<NST - 2>();        // this slice has landed
      __syncthreads();                 // for every thread; the oldest stage
      issue_next();                    // is free again: refill it
      const int dk = min(DK, d - q0);
      const float* as_s = as + stage_r * BM * DK;
      const float* bs_s = bs + stage_r * BNK * DK;
      if (norm_b || norm_a) {
        const float* src = norm_b ? bs_s : as_s;
#pragma unroll
        for (int c4 = 0; c4 < DK / 4; ++c4) {
          if (4 * c4 < dk) {
            const float4 v =
                *reinterpret_cast<const float4*>(&src[swz(nrow, c4)]);
            const float vv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
            for (int qq = 0; qq < 4; ++qq)
              if (VEC || 4 * c4 + qq < dk)
                nrm = __fadd_rn(nrm, __fmul_rn(vv[qq], vv[qq]));
          }
        }
      }
#pragma unroll
      for (int c4 = 0; c4 < DK / 4; ++c4) {
        if (4 * c4 < dk) {
          float av[4][4], bv[4][4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float4 v = *reinterpret_cast<const float4*>(
                &as_s[swz(ty + 8 * i, c4)]);
            av[i][0] = v.x; av[i][1] = v.y; av[i][2] = v.z; av[i][3] = v.w;
          }
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float4 v = *reinterpret_cast<const float4*>(
                &bs_s[swz(tx + 16 * j, c4)]);
            bv[j][0] = v.x; bv[j][1] = v.y; bv[j][2] = v.z; bv[j][3] = v.w;
          }
#pragma unroll
          for (int qq = 0; qq < 4; ++qq) {
            if (VEC || 4 * c4 + qq < dk) {
#pragma unroll
              for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j)
                  acc[i][j] = fmaf(av[i][qq], bv[j][qq], acc[i][j]);
            }
          }
        }
      }
      stage_r = stage_r + 1 == NST ? 0 : stage_r + 1;
    }
    if (norm_b) bn_sh[tid] = nrm;
    if (norm_a) an_sh[tid - BNK] = nrm;
    __syncthreads();

    // ---- threshold filter, then the masks for the few survivors --------
    unsigned pass = 0;                 // bit 4i + j: output (i, j) survives
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 8 * i;
      if (r0 + r >= M) continue;
      const unsigned kth = ord_of(thr[r]);
      const float an = an_sh[r];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const float s = __fsub_rn(__fsub_rn(2.0f * acc[i][j], an), bn_sh[c]);
        acc[i][j] = s;
        if (c < cw && ord_of(s) > kth) pass |= 1u << (4 * i + j);
      }
    }
    // one copy of the mask code, looped over the survivors (unrolled over
    // all 16 outputs it would spread the loop's code past the instruction
    // cache)
#pragma unroll 1
    for (unsigned m = pass; m != 0; m &= m - 1) {
      const int bit = __ffs(m) - 1;
      const int r = ty + 8 * (bit >> 2), row = r0 + r;
      const int pos = c0 + tx + 16 * (bit & 3);
      const int id = p.b_ids ? p.b_ids[(size_t)g * N + pos] : pos;
      bool bad = id < 0 || id == aid_sh[r];
      if (!bad && p.codes_a != nullptr) {
        bool match = false;
        const int* ca = p.codes_a + ((size_t)g * M + row) * p.T;
        const int* cb = p.codes_b + ((size_t)g * N + pos) * p.T;
        for (int t = 0; t < p.T; ++t) match |= ca[t] == cb[t];
        bad = !match;
      }
      if (bad) pass &= ~(1u << bit);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int n_pass = __popc(pass >> (4 * i) & 0xFu);
      if (n_pass) atomicAdd(&pend[ty + 8 * i], n_pass);
    }
    __syncthreads();

    // ---- merge the rows whose buffers would overflow -------------------
    for (int rr = 0; rr < ROWS_PER_WARP; ++rr) {
      const int r = warp * ROWS_PER_WARP + rr;
      if (r0 + r < M && cnt[r] + pend[r] > CAP)
        merge_row(p, g, r, st_s + r * k, st_i + r * k, snap + r * kp,
                  bufk + r * CAP, cnt, thr, lane);
    }
    __syncthreads();

    // ---- append the survivors that still beat the k-th similarity ------
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 8 * i;
      const unsigned kth = ord_of(thr[r]);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if ((pass >> (4 * i + j) & 1u) && ord_of(acc[i][j]) > kth) {
          const int slot = atomicAdd(&cnt[r], 1);
          bufk[r * CAP + slot] = make_key(acc[i][j], c0 + tx + 16 * j);
        }
      }
    }
    if (tid < BM) pend[tid] = 0;
    __syncthreads();

    // ---- at a dedup tile's end and at the end, merge every buffer -------
    if (c0 + cw == N || (p.dedup && tile_end)) {
      for (int rr = 0; rr < ROWS_PER_WARP; ++rr) {
        const int r = warp * ROWS_PER_WARP + rr;
        if (r0 + r < M && cnt[r] > 0)
          merge_row(p, g, r, st_s + r * k, st_i + r * k, snap + r * kp,
                    bufk + r * CAP, cnt, thr, lane);
      }
      __syncthreads();
    }
    c0 += cw;
  }
  cp_async_wait<0>();
  for (int idx = tid; idx < rows * k; idx += THREADS)
    st_s[idx] = fmaxf(-st_s[idx], 0.0f);
}

// ---- pairwise_sqdist -------------------------------------------------
constexpr int PT = 128;         // output tile: PT rows of a x PT rows of b
constexpr int PK = 32;          // feature slice
constexpr int PST = 3;          // slice stages in flight
constexpr int PTHREADS = 256;   // 16 x 16; each owns 8 x 8 outputs
constexpr int PC4 = PK / 4;     // 16-byte chunks of a slice row

constexpr size_t pairwise_smem_bytes() {
  return (size_t)PST * 2 * PT * PK * 4 + 2 * PT * 4;
}

// 16-byte chunk c4 (of 8) of row `row` in a slice, XOR-swizzled by row / 4:
// the eight rows 4t + c (t = 0..7) that a quarter-warp reads at one chunk
// hit eight distinct bank groups, and so do the eight chunks of one row
// that a quarter-warp's cp.async writes.
__device__ inline int pswz(int row, int c4) {
  return row * PK + ((c4 ^ ((row >> 2) & 7)) << 2);
}

// VEC: d % 4 == 0 and 16-byte aligned bases, so a slice moves in 16-byte
// copies; otherwise in 4-byte copies of single features.
template <bool VEC>
__global__ void __launch_bounds__(PTHREADS, 2)
pairwise_kernel(const float* __restrict__ a, const float* __restrict__ b,
                float* __restrict__ out, int M, int N, int d, int vec_out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* as = reinterpret_cast<float*>(smem_raw);     // [PST][PT][PK]
  float* bs = as + PST * PT * PK;                      // [PST][PT][PK]
  float* an_sh = bs + PST * PT * PK;                   // [PT]
  float* bn_sh = an_sh + PT;                           // [PT]
  const int tid = threadIdx.x;
  // row tiles vary fastest: the blocks resident at once share few b tiles
  const int m_tiles = (M + PT - 1) / PT;
  const int m0 = (blockIdx.x % m_tiles) * PT;
  const int n0 = (blockIdx.x / m_tiles) * PT;
  const int n_slices = (d + PK - 1) / PK;
  const int m_lim = M - m0, n_lim = N - n0;

  // VEC copies: thread -> chunk cc4 of rows cr0 + R u (u < PT / R); the
  // swizzle is the same for all of them
  constexpr int R = PTHREADS / PC4;
  const int cc4 = tid % PC4, cr0 = tid / PC4;
  const float* a_thr = a + ((size_t)m0 + cr0) * d + 4 * cc4;
  const float* b_thr = b + ((size_t)n0 + cr0) * d + 4 * cc4;
  const int c_dst = pswz(cr0, cc4);
  int slice_w = 0, stage_w = 0;
  auto issue_next = [&]() {
    if (slice_w < n_slices) {
      const int q0 = slice_w * PK;
      const int dk = min(PK, d - q0);
      float* as_s = as + stage_w * PT * PK;
      float* bs_s = bs + stage_w * PT * PK;
      if (VEC) {
        const bool live = 4 * cc4 < dk;
#pragma unroll
        for (int u = 0; u < PT / R; ++u) {
          const int row = cr0 + R * u;
          const bool ok_a = live && row < m_lim, ok_b = live && row < n_lim;
          const size_t off = (size_t)R * u * d + q0;
          cp_async16(&as_s[c_dst + R * u * PK], ok_a ? a_thr + off : a,
                     ok_a);
          cp_async16(&bs_s[c_dst + R * u * PK], ok_b ? b_thr + off : b,
                     ok_b);
        }
      } else {
        for (int idx = tid; idx < PT * dk; idx += PTHREADS) {
          const int row = idx / dk, q = idx - row * dk;
          const int o = pswz(row, q >> 2) + (q & 3);
          const bool ok_a = row < m_lim, ok_b = row < n_lim;
          cp_async4(&as_s[o], ok_a ? a + ((size_t)m0 + row) * d + q0 + q : a,
                    ok_a);
          cp_async4(&bs_s[o], ok_b ? b + ((size_t)n0 + row) * d + q0 + q : b,
                    ok_b);
        }
      }
      ++slice_w;
    }
    cp_async_commit();                 // empty groups keep the count even
    stage_w = stage_w + 1 == PST ? 0 : stage_w + 1;
  };
#pragma unroll
  for (int t = 0; t < PST - 1; ++t) issue_next();

  // thread -> rows ty + 16 i (i < 8) and columns 4 tx + 64 h + c
  // (h < 2, c < 4) of the tile; every thread also sums one row norm
  // (threads 0..127 of a's rows, 128..255 of b's), its rows spread so
  // that a quarter-warp reads eight bank groups
  const int tx = tid & 15, ty = tid >> 4;
  const int nrow = ((tid & 7) << 2) | ((tid >> 3) & 3) | (tid & 0x60);
  const bool norm_of_b = tid >= PT;
  float nrm = 0.0f;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  int stage_r = 0;
  for (int sl = 0; sl < n_slices; ++sl) {
    cp_async_wait<PST - 2>();          // this slice has landed
    __syncthreads();                   // for every thread; the oldest stage
    issue_next();                      // is free again: refill it
    const int dk = min(PK, d - sl * PK);
    const float* as_s = as + stage_r * PT * PK;
    const float* bs_s = bs + stage_r * PT * PK;
    {
      const float* src = norm_of_b ? bs_s : as_s;
#pragma unroll
      for (int c4 = 0; c4 < PC4; ++c4) {
        if (4 * c4 < dk) {
          const float4 v =
              *reinterpret_cast<const float4*>(&src[pswz(nrow, c4)]);
          const float vv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int qq = 0; qq < 4; ++qq)
            if (VEC || 4 * c4 + qq < dk)
              nrm = __fadd_rn(nrm, __fmul_rn(vv[qq], vv[qq]));
        }
      }
    }
#pragma unroll
    for (int c4 = 0; c4 < PC4; ++c4) {
      if (4 * c4 < dk) {
        float4 av[8];
#pragma unroll
        for (int i = 0; i < 8; ++i)
          av[i] = *reinterpret_cast<const float4*>(
              &as_s[pswz(ty + 16 * i, c4)]);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float4 bv = *reinterpret_cast<const float4*>(
              &bs_s[pswz(4 * tx + 64 * (j >> 2) + (j & 3), c4)]);
          const float bq[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
          for (int qq = 0; qq < 4; ++qq) {
            if (VEC || 4 * c4 + qq < dk) {
#pragma unroll
              for (int i = 0; i < 8; ++i) {
                const float aq = qq == 0 ? av[i].x : qq == 1 ? av[i].y
                               : qq == 2 ? av[i].z : av[i].w;
                acc[i][j] = fmaf(aq, bq[qq], acc[i][j]);
              }
            }
          }
        }
      }
    }
    stage_r = stage_r + 1 == PST ? 0 : stage_r + 1;
  }
  cp_async_wait<0>();
  (norm_of_b ? bn_sh : an_sh)[nrow] = nrm;
  __syncthreads();

  // epilogue: out = max((|a|^2 + |b|^2) - 2 a.b, 0), four columns a store
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = ty + 16 * i, row = m0 + r;
    if (row >= M) continue;
    const float na = an_sh[r];
    float* orow = out + (size_t)row * N;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = 4 * tx + 64 * h, col = n0 + c;
      float v[4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        v[q] = fmaxf(__fsub_rn(__fadd_rn(na, bn_sh[c + q]),
                               2.0f * acc[i][4 * h + q]),
                     0.0f);
      if (vec_out && col + 3 < N) {
        __stcs(reinterpret_cast<float4*>(orow + col),
               make_float4(v[0], v[1], v[2], v[3]));
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (col + q < N) __stcs(orow + col + q, v[q]);
      }
    }
  }
}

}  // namespace


extern "C" int topk_sqdist_launch(
    const float* a, const int* a_idx, const float* b, const int* b_idx,
    const int* a_ids, const int* b_ids, const int* codes_a,
    const int* codes_b, int T, const int* init_ids, const float* init_dists,
    int* out_ids, float* out_dists, int G, int M, int N, int d, int k, int bn,
    int dedup, void* stream) {
  if (k < 1 || k > MAX_K || bn < 1) return cudaErrorInvalidValue;
  if (G == 0 || M == 0) return cudaSuccess;
  const long long blocks = (long long)G * ((M + BM - 1) / BM);
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  const size_t smem = topk_smem_bytes(k, dedup);
  const bool vec = d % 4 == 0 && (uintptr_t)a % 16 == 0 &&
                   (uintptr_t)b % 16 == 0;
  auto kernel = vec ? topk_kernel<true> : topk_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const TopkArgs p{a,        a_idx,    b,          b_idx,   a_ids,
                   b_ids,    codes_a,  codes_b,    T,       init_ids,
                   init_dists, out_ids, out_dists, M,       N,
                   d,        k,        bn,         dedup};
  kernel<<<(unsigned)blocks, THREADS, smem, (cudaStream_t)stream>>>(p);
  return cudaGetLastError();
}

extern "C" int pairwise_sqdist_launch(const float* a, const float* b,
                                      float* out, int M, int N, int d,
                                      void* stream) {
  if (M == 0 || N == 0) return cudaSuccess;
  const long long blocks =
      (long long)((M + PT - 1) / PT) * ((N + PT - 1) / PT);
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  const bool vec = d % 4 == 0 && (uintptr_t)a % 16 == 0 &&
                   (uintptr_t)b % 16 == 0;
  const int vec_out = N % 4 == 0 && (uintptr_t)out % 16 == 0;
  auto kernel = vec ? pairwise_kernel<true> : pairwise_kernel<false>;
  const size_t smem = pairwise_smem_bytes();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)blocks, PTHREADS, smem, (cudaStream_t)stream>>>(
      a, b, out, M, N, d, vec_out);
  return cudaGetLastError();
}

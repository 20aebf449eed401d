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
// dk, dv accumulate in f32 and are rounded once to bf16 at the end.
//
// Bound: the bf16 tensor-core rate.  The work the backward must do is 5
// products of 2 D flops a pair under the mask: at (2, 4096, 16, 64)
// causal, 5 * 2 * 64 * 268,500,992 pairs = 171.8 GFLOP, 0.1738 ms at 989
// TFLOP/s (reading q, k, v, out, dout and writing dq, dk, dv, 8 x 16.8 MB,
// takes 0.040 ms at 3.35 TB/s); chip_smoke.py's flash_bwd_bound.
//
// bf16 inputs (every D) take one pass on wgmma fed by TMA (namespace wg):
//  * A block owns a tile of BK keys of one (b, h): K and V stay in shared
//    memory, dK and dV in registers.  It walks the query tiles (64 rows)
//    that the mask lets see the tile, from the last one down: causal from
//    the tile holding its first key on, a window up to its last key + W -
//    1.  For each it computes S^T = K Q^T and dP^T = V dO^T on wgmma with
//    f32 accumulators: the transposed products, so that P^T and dS^T come
//    out with keys as rows, in the layout of the A operand of dV += P^T dO
//    and dK += dS^T Q.  5 products a tile pair: S^T, dP^T, dV, dK and dQ.
//    Exponents are base 2 with log2(e) scale folded in, p = 2^(s c - lse
//    log2 e) by ex2.approx; lse log2(e) and delta of the tile's 64 rows
//    (columns of S^T) come into shared memory with it, from rows the delta
//    kernel writes padded to the tiles (a tile's 256 bytes are then one
//    aligned bulk copy; a TMA box at an unaligned row start faulted).
//  * D <= 64: BK = 128, each of two consumer warpgroups owns 64 keys and
//    all D columns of their dK and dV.  P^T and dS^T are rounded to bf16
//    in registers and feed the dV and dK products as register A operands;
//    only dS^T goes to shared memory (bf16, keys as rows, 128-byte
//    swizzle), as the A operand of dQ = dS K read in the transpose layout.
//  * D = 128 and 256: the dK and dV of 128 keys would not fit in
//    registers (at D = 256, 256 f32 a thread for 64 keys), so BK = 64 and
//    the warpgroups split the columns of dK and dV (D / 2 each: 64 or 128
//    f32 a thread for each of the two).  Each computes S^T and dP^T for 32
//    of the tile's 64 queries and writes its P^T and dS^T (bf16) to shared
//    memory, from where both read them as the A operands of their dV and
//    dK columns.
//  * Loads overlap the math.  A producer warpgroup (one thread of it
//    issuing) loads K and V once a key tile, and Q, dO, lse and delta a
//    query tile by TMA (bulk copies for lse and delta) into a ring of NS
//    stages, with full and empty mbarriers; Q, dO and V are swizzled slabs of min(D, 64) columns, K
//    slabs of its dQ chunk's width (below).  The producer gives its
//    registers to the two consumer warpgroups by setmaxnreg (24 and 240).
//  * dQ in a fixed order, without atomics on the data.  A block's dQ
//    partial of a query tile, dS K over its BK keys, is computed in chunks
//    of KC = clamp(D / 2, 16, 64) columns (one K slab each, the chunks
//    dealt to the two warpgroups in turn) and added into one f32
//    accumulator of (B, H, ceil(S / 64) * 64, D) (each tile's 64 x D in
//    the registers' order, so every add is 16-byte loads and stores by
//    neighbouring threads).  The key tiles that see query tile i are a
//    range [j_lo(i), j_hi(i)), and a counter a (b, h, query tile) admits
//    them in ascending order: key tile j waits until the counter reads j
//    - j_lo(i); j_lo(i) writes the accumulator, each later one reads it,
//    adds its partial (acc + partial, in f32) and writes it back, and
//    j_hi(i) - 1 adds and stores the sum, rounded to bf16, into dq.  So no
//    zeroing pass, no conversion pass, and two calls give the same bits.
//    A tile's stores are published by a barrier of the consumers and one
//    thread's release add on the counter (gpu scope, cumulative over the
//    barrier); the next adder's thread 0 acquires it and a barrier passes
//    it on.  At D = 128 a tile's add waits for the next tile's iteration:
//    its loads fly during that tile's S^T and dP^T products and p and ds.
//    The counters (and the work counter below) are zeroed on the stream by
//    the delta kernel.
//  * Deadlock-free without relying on the order in which blocks start: a
//    persistent grid (at most the blocks that fit on the card at once)
//    takes (key tile j, b * H + h) items from an atomic work counter in
//    the order j * B * H + b * H + h, so every item a block waits on was
//    handed out earlier, to a block that is running.  Ascending j is the
//    longest walks first under the causal mask, and since every block
//    walks its query tiles from the last one down, key tile j - 1 (handed
//    out earlier, at most as far to walk before tile i) reaches each query
//    tile before key tile j does: the counter rarely holds a block back
//    (dropping the wait saved at most 5% on the card).  Head-major order,
//    every key tile of a head at once, queues them all on each query
//    tile's counter: 2.3x slower at (2, 4096, 16, 64).
//  * Shared memory: 84 KB at D = 64, 117 KB at 128, 215 KB at 256 (NS =
//    2), opted into by cudaFuncSetAttribute; every launch is checked by
//    cudaGetLastError, and a launch refused never runs.  ptxas: 168
//    registers at entry and no spill at any D; at D = 16 its one dQ chunk
//    leaves warpgroup 1 without a dQ product, and ptxas serialises the
//    wgmmas there (C7520).
//
// Measured (NVIDIA H100 80GB HBM3, 700.00 W; chip_smoke.py's
// check_flash_bwd, by CUDA events; the first WMMA kernels in brackets):
// qwen's (2, 4096, 16, 64) causal 0.971 ms (4.09), 5.6x the bound, the
// wgmma pass 0.919 and the delta kernel 0.043 ms of device time, SDPA's
// backward 0.52; whisper's (1, 4096, 6, 64) 0.238 (1.07); mixtral's (1,
// 8192, 32, 128) W 4096 9.86 (22.9); gemma3's (1, 8192, 16, 256) causal
// 14.61 (28.3), W 1024 3.56 (7.0).  At hd 128 and 256 the dQ accumulator
// (134 MB there; 33.5 MB at qwen's shape) outgrows the 50 MB L2, and its
// read-add-write per tile pair takes most of the time: with its stores
// cut the pass took 5.95 ms at mixtral's and 8.93 ms at gemma3's shape
// (tools/flash_bwd_variants.py).
//
// f32 inputs keep the first kernels (namespace fma): f32 FMAs on a 16 x 16
// thread grid, one block a (key tile, b * H + h) for dk and dv and one a
// (query tile, b * H + h) for dq, both recomputing s and dout v^T, no
// atomics.
#include <climits>
#include <cstdint>

#include "sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int NT_DELTA = 256;         // delta kernel: one warp a row
constexpr float LOG2E = 1.4426950408889634f;
constexpr int align128(int bytes) { return (bytes + 127) / 128 * 128; }

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

// delta = rowsum(dout * out) at delta[(b H + h) pitch + s] (f32: pitch =
// S); with lse2, also lse2[(b H + h) pitch + s] = lse[b, h, s] log2(e)
// (bf16: rows padded to the 64-row tiles, so that a tile's 256 bytes load
// as one aligned bulk copy); zeroes counters[0, n_counters)
template <typename T>
__global__ void __launch_bounds__(NT_DELTA) delta_kernel(
    const T* __restrict__ out, const T* __restrict__ dout,
    const float* __restrict__ lse, float* __restrict__ delta,
    float* __restrict__ lse2, long long rows, int S, int H, int D,
    int pitch, int* __restrict__ counters, int n_counters) {
  for (long long i = (long long)blockIdx.x * NT_DELTA + threadIdx.x;
       i < n_counters; i += (long long)gridDim.x * NT_DELTA)
    counters[i] = 0;
  const long long row =
      (long long)blockIdx.x * (NT_DELTA / 32) + threadIdx.x / 32;
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
    const long long bh = row / ((long long)H * S) * H + h;
    delta[bh * pitch + s] = sum;
    if (lse2 != nullptr)
      lse2[bh * pitch + s] = lse[bh * S + s] * LOG2E;
  }
}

template <typename T>
cudaError_t launch_delta(const T* out, const T* dout, const float* lse,
                         float* delta, float* lse2, int B, int S, int H,
                         int D, int pitch, int* counters, int n_counters,
                         cudaStream_t st) {
  const long long rows = (long long)B * S * H;
  const long long blocks = (rows + NT_DELTA / 32 - 1) / (NT_DELTA / 32);
  delta_kernel<T><<<(unsigned)blocks, NT_DELTA, 0, st>>>(
      out, dout, lse, delta, lse2, rows, S, H, D, pitch, counters,
      n_counters);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16: one pass on wgmma fed by TMA
// ---------------------------------------------------------------------------
namespace wg {

using namespace sm90;

constexpr int BQ = 64;                 // query rows of a tile
constexpr int NS = 2;                  // Q/dO stages in the ring
constexpr int CONSUMERS = 256;         // two consumer warpgroups
constexpr int NT = CONSUMERS + 128;    // and a producer warpgroup
constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 240;
constexpr int BAR_ITEM = 1, BAR_CONSUMERS = 2;   // named barriers

constexpr int align1024(int bytes) { return (bytes + 1023) / 1024 * 1024; }

template <int D>
struct Bwd {
  // D <= 64: P^T and dS^T feed dV and dK from registers, a warpgroup
  // owning 64 keys; above, the warpgroups split dK's and dV's columns
  static constexpr bool RS = D <= 64;
  static constexpr int BK = RS ? 128 : 64;         // keys of a block
  static constexpr int QSW = D < 64 ? D : 64;      // slab of Q, dO, V
  static constexpr int KC = D / 2 < 16 ? 16 : D / 2 > 64 ? 64 : D / 2;
  static constexpr int CHUNKS = D / KC;            // dQ chunks = K slabs
  static constexpr int NCH = (CHUNKS + 1) / 2;     // a warpgroup's, at most
  // a tile's dQ add deferred into the next tile's iteration: 6% faster at
  // D = 128 (mixtral's shape, tools/flash_bwd_variants.py); kept off at
  // D <= 64, and at D = 256 the prefetched accumulator does not fit in
  // the registers
  static constexpr bool DEFER = D == 128;
  static constexpr int QSLAB = BQ * QSW * 2, QBYTES = BQ * D * 2;
  static constexpr int VSLAB = BK * QSW * 2, KSLAB = BK * KC * 2;
  static constexpr int KVBYTES = BK * D * 2;
  static constexpr int ROWS = BQ * 4;              // lse or delta of a tile
  static constexpr int PBYTES = BK * BQ * 2;       // P^T or dS^T, bf16
  // a warpgroup's S^T / dP^T columns (queries), and dK / dV columns
  static constexpr int SQ = RS ? BQ : BQ / 2;
  static constexpr int DN = RS ? D : D / 2;
  // shared memory from the 1024-aligned base
  static constexpr int K_OFF = 0;
  static constexpr int V_OFF = K_OFF + KVBYTES;
  static constexpr int Q_OFF = V_OFF + KVBYTES;            // NS stages
  static constexpr int DO_OFF = Q_OFF + NS * QBYTES;       // NS stages
  static constexpr int LSE_OFF = DO_OFF + NS * QBYTES;     // NS stages
  static constexpr int DELTA_OFF = LSE_OFF + NS * ROWS;    // NS stages
  static constexpr int DS_OFF = align1024(DELTA_OFF + NS * ROWS);
  static constexpr int P_OFF = DS_OFF + PBYTES;            // RS: unused
  static constexpr int BAR_OFF = P_OFF + (RS ? 0 : PBYTES);
  static constexpr int ITEM_OFF = BAR_OFF + 8 * (1 + 2 * NS);
  static constexpr int SMEM = 1024 + ITEM_OFF + 8;
  static_assert(SMEM <= 232448, "shared memory");
  static_assert(D % 16 == 0 && D <= 256 && CHUNKS * KC == D, "head dim");
  static_assert(KVBYTES % 1024 == 0 && QBYTES % 1024 == 0 &&
                    KSLAB % 1024 == 0 && QSLAB % 1024 == 0,
                "swizzle alignment");
};

__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("barrier.sync %0, %1;" ::"r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}
__device__ __forceinline__ void red_release_add(int* p, int v) {
  asm volatile("red.release.gpu.global.add.s32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
}
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// the query tiles [lo, hi) that key tile j walks, and the key tiles
// [lo, hi) that add into query tile i: i is in walk(j) iff j in adders(i)
struct Range {
  int lo, hi;
};
// a query tile's dQ partial on its way into the accumulator: its counter,
// first row, place among the adders and whether it is the last
struct Pending {
  int cidx, q0, rank;
  bool last;
};
template <int BK>
__device__ __forceinline__ Range walk(int j, int nq, int Tk, int causal,
                                      int window) {
  const int k0 = j * BK, kend = min(k0 + BK, Tk);
  return {causal ? k0 / BQ : 0,
          window > 0 ? min(nq, (kend - 1 + window - 1) / BQ + 1) : nq};
}
template <int BK>
__device__ __forceinline__ Range adders(int i, int nk, int causal,
                                        int window) {
  const int q0 = i * BQ;
  return {window > 0 ? max(0, q0 - window + 1) / BK : 0,
          causal ? min(nk, ((i + 1) * BQ - 1) / BK + 1) : nk};
}

template <int D>
__global__ void __launch_bounds__(NT, 1) flash_bwd_wgmma(
    const __grid_constant__ CUtensorMap tq,
    const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv,
    const __grid_constant__ CUtensorMap tdo,
    const float* __restrict__ lse2, const float* __restrict__ delta,
    bf16* __restrict__ dq, bf16* __restrict__ dk, bf16* __restrict__ dv,
    float* __restrict__ dq_acc, int* __restrict__ counters, int S, int Tk,
    int H, int BH, int nq, int nk, float scale, float scale_log2,
    int causal, int window) {
  using C = Bwd<D>;
  constexpr int BK = C::BK, QSW = C::QSW, KC = C::KC;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* gbase = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t base = smem_u32(gbase);
  const uint32_t kv_full = base + C::BAR_OFF;
  auto full = [&](int s) { return base + C::BAR_OFF + 8 * (1 + s); };
  auto empty = [&](int s) { return base + C::BAR_OFF + 8 * (1 + NS + s); };
  volatile int* item_s = reinterpret_cast<volatile int*>(gbase + C::ITEM_OFF);
  int* work = counters + (size_t)BH * nq;
  const int n_items = nk * BH;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < NS; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  if (threadIdx.x == CONSUMERS) item_s[0] = atomicAdd(work, 1);
  __syncthreads();

  // one if / else for the two roles, so that ptxas can place setmaxnreg
  if (threadIdx.x >= CONSUMERS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(PRODUCER_REGS));
    int use = 0;                               // ring stages used so far
    for (int n = 0;; ++n) {
      const int item = item_s[n & 1];
      if (item >= n_items) break;
      if (threadIdx.x == CONSUMERS) {
        const int j = item / BH, bh = item % BH, b = bh / H, h = bh % H;
        const Range w = walk<BK>(j, nq, Tk, causal, window);
        mbar_expect_tx(kv_full, 2 * C::KVBYTES);
        tma_tile<D, KC>(base + C::K_OFF, &tk, kv_full, C::KSLAB, h, j * BK,
                        b);
        tma_tile<D, QSW>(base + C::V_OFF, &tv, kv_full, C::VSLAB, h,
                         j * BK, b);
        for (int i = w.hi - 1; i >= w.lo; --i, ++use) {
          const int s = use % NS;
          if (use >= NS) mbar_wait(empty(s), ((use / NS) - 1) & 1);
          mbar_expect_tx(full(s), 2 * C::QBYTES + 2 * C::ROWS);
          tma_tile<D, QSW>(base + C::Q_OFF + s * C::QBYTES, &tq, full(s),
                           C::QSLAB, h, i * BQ, b);
          tma_tile<D, QSW>(base + C::DO_OFF + s * C::QBYTES, &tdo, full(s),
                           C::QSLAB, h, i * BQ, b);
          const size_t r = (size_t)bh * nq * BQ + i * BQ;
          bulk_load(base + C::LSE_OFF + s * C::ROWS, lse2 + r, C::ROWS,
                    full(s));
          bulk_load(base + C::DELTA_OFF + s * C::ROWS, delta + r, C::ROWS,
                    full(s));
        }
        item_s[(n + 1) & 1] = atomicAdd(work, 1);
      }
      __syncwarp();
      named_sync(BAR_ITEM, NT);                // the item is done
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(CONSUMER_REGS));
    // warpgroup w; a thread holds rows 16 warp + g and + 8 of a 64-row
    // product, columns 8 j + 2 t and + 1
    const int w = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4;
    const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
    const int tid = threadIdx.x % 128;
    const int row = 16 * warp + g;
    int use = 0;
    for (int n = 0;; ++n) {
      const int item = item_s[n & 1];
      if (item >= n_items) break;
      const int j = item / BH, bh = item % BH, b = bh / H, h = bh % H;
      const int k0 = j * BK;
      const Range wk = walk<BK>(j, nq, Tk, causal, window);
      // the warpgroup's keys (rows of S^T): its 64 (D <= 64) or all 64
      const int kw = k0 + (C::RS ? 64 * w : 0);
      float dk_acc[C::DN / 2], dv_acc[C::DN / 2];
#pragma unroll
      for (int e = 0; e < C::DN / 2; ++e) dk_acc[e] = dv_acc[e] = 0.f;
      mbar_wait(kv_full, n & 1);

      // dQ partials of a query tile wait for their turn, then go into the
      // accumulator; with DEFER a tile's add is deferred into the next
      // tile's iteration (its loads in flight during the next S^T / dP^T
      // products and p, ds)
      float dqc[C::NCH][KC / 2], old[C::DEFER ? C::NCH : 1][KC / 2];
      Pending prev{0, 0, 0, false};
      bool have = false;
      auto turn = [&](const Pending& pd) {
        if (threadIdx.x == 0 && pd.rank > 0)
          while (ld_acquire(counters + pd.cidx) < pd.rank) {
          }
        __syncwarp();
        named_sync(BAR_CONSUMERS, CONSUMERS);
      };
      auto load_acc = [&](const Pending& pd) {
        if constexpr (C::DEFER) {
          if (pd.rank == 0) return;
          const float* acc = dq_acc + (size_t)pd.cidx * (BQ * D);
#pragma unroll
          for (int ci = 0; ci < C::NCH; ++ci) {
            const int c = w + 2 * ci;
            if (C::CHUNKS % 2 && c >= C::CHUNKS) continue;
            const float4* a = reinterpret_cast<const float4*>(
                acc + c * (64 * KC) + tid * (KC / 2));
#pragma unroll
            for (int v = 0; v < KC / 8; ++v) {
              const float4 o = __ldcg(a + v);
              old[ci][4 * v] = o.x;
              old[ci][4 * v + 1] = o.y;
              old[ci][4 * v + 2] = o.z;
              old[ci][4 * v + 3] = o.w;
            }
          }
        }
      };
      // write, read-add-write, or add and round into dq (acc + partial)
      auto add_acc = [&](const Pending& pd) {
        float* acc = dq_acc + (size_t)pd.cidx * (BQ * D);
#pragma unroll
        for (int ci = 0; ci < C::NCH; ++ci) {
          const int c = w + 2 * ci;
          if (C::CHUNKS % 2 && c >= C::CHUNKS) continue;
          float* d = dqc[ci];
          float4* a =
              reinterpret_cast<float4*>(acc + c * (64 * KC) + tid * (KC / 2));
          if (pd.rank > 0) {
#pragma unroll
            for (int v = 0; v < KC / 8; ++v) {
              // deferred: loaded by load_acc; else one float4 at a time
              float4 o;
              if constexpr (C::DEFER) {
                o = make_float4(old[ci][4 * v], old[ci][4 * v + 1],
                                old[ci][4 * v + 2], old[ci][4 * v + 3]);
              } else {
                o = __ldcg(a + v);
              }
              d[4 * v] = o.x + d[4 * v];
              d[4 * v + 1] = o.y + d[4 * v + 1];
              d[4 * v + 2] = o.z + d[4 * v + 2];
              d[4 * v + 3] = o.w + d[4 * v + 3];
            }
          }
          if (!pd.last) {
#pragma unroll
            for (int v = 0; v < KC / 8; ++v)
              __stcg(a + v, make_float4(d[4 * v], d[4 * v + 1], d[4 * v + 2],
                                        d[4 * v + 3]));
          } else {
#pragma unroll
            for (int x = 0; x < 2; ++x) {
              const int qp = pd.q0 + row + 8 * x;
              if (qp >= S) continue;
              bf16* dst =
                  dq + (((size_t)b * S + qp) * H + h) * D + c * KC + 2 * t;
#pragma unroll
              for (int jj = 0; jj < KC / 8; ++jj)
                *reinterpret_cast<uint32_t*>(dst + 8 * jj) =
                    pack_bf16(d[4 * jj + 2 * x], d[4 * jj + 2 * x + 1]);
            }
          }
        }
      };
      // every consumer's stores are ordered before thread 0's release by
      // the barrier; the release (gpu scope) is cumulative over them
      auto release = [&](const Pending& pd) {
        named_sync(BAR_CONSUMERS, CONSUMERS);
        if (threadIdx.x == 0 && !pd.last)
          red_release_add(counters + pd.cidx, 1);
      };

      for (int i = wk.hi - 1; i >= wk.lo; --i, ++use) {
        const int s = use % NS, q0 = i * BQ;
        const uint32_t q_st = base + C::Q_OFF + s * C::QBYTES;
        const uint32_t do_st = base + C::DO_OFF + s * C::QBYTES;
        const float* lse_s =
            reinterpret_cast<const float*>(gbase + C::LSE_OFF + s * C::ROWS);
        const float* dl_s = reinterpret_cast<const float*>(
            gbase + C::DELTA_OFF + s * C::ROWS);
        // the warpgroup's queries (columns of S^T): all 64, or its 32
        const int qc = C::RS ? 0 : 32 * w;
        const Range ad = adders<BK>(i, nk, causal, window);
        const Pending cur{bh * nq + i, q0, j - ad.lo, j == ad.hi - 1};
        mbar_wait(full(s), (use / NS) & 1);

        // S^T = K Q^T, dP^T = V dO^T: M = 64 keys, N = SQ queries, K = D
        float st[C::SQ / 2], dpt[C::SQ / 2];
        {
          const uint64_t da_k =
              make_desc<KC>(base + C::K_OFF + (kw - k0) * KC * 2);
          const uint64_t da_v =
              make_desc<QSW>(base + C::V_OFF + (kw - k0) * QSW * 2);
          const uint64_t db_q = make_desc<QSW>(q_st + qc * QSW * 2);
          const uint64_t db_do = make_desc<QSW>(do_st + qc * QSW * 2);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk) {   // 16 columns = 32 bytes
            constexpr int KS = KC / 16, QS = QSW / 16;   // steps a slab
            const int ko = (kk / KS) * (C::KSLAB >> 4) + 2 * (kk % KS);
            const int qo = (kk / QS) * (C::QSLAB >> 4) + 2 * (kk % QS);
            const int vo = (kk / QS) * (C::VSLAB >> 4) + 2 * (kk % QS);
            wgmma_ss<C::SQ>(st, da_k + ko, db_q + qo, kk > 0);
            wgmma_ss<C::SQ>(dpt, da_v + vo, db_do + qo, kk > 0);
          }
          wgmma_commit();
        }
        if (C::DEFER && have) {                // the last tile's turn
          turn(prev);
          load_acc(prev);
        }
        wgmma_wait();
        fence_regs(st);
        fence_regs(dpt);

        // p and ds, rounded to bf16 in pairs: pa[2 j + x] holds the
        // thread's row row + 8 x, columns 8 j + 2 t and + 1, which is the
        // A fragment of a k16 step at pa[4 kk]
        uint32_t pa[C::SQ / 4], dsa[C::SQ / 4];
        {
          const bool edge =
              q0 + BQ > S || kw + 64 > Tk || (causal && kw + 63 > q0 + qc) ||
              (window > 0 && kw <= q0 + qc + C::SQ - 1 - window);
#pragma unroll
          for (int jj = 0; jj < C::SQ / 8; ++jj) {
            const int col = qc + 8 * jj + 2 * t;
            const float l0 = lse_s[col], l1 = lse_s[col + 1];   // x log2 e
            const float d0 = dl_s[col], d1 = dl_s[col + 1];
#pragma unroll
            for (int x = 0; x < 2; ++x) {
              const int e = 4 * jj + 2 * x;
              float p0 = ex2(fmaf(st[e], scale_log2, -l0));
              float p1 = ex2(fmaf(st[e + 1], scale_log2, -l1));
              float s0 = p0 * (dpt[e] - d0) * scale;
              float s1 = p1 * (dpt[e + 1] - d1) * scale;
              if (edge) {
                const int kp = kw + row + 8 * x, qp = q0 + col;
                const bool kin = kp < Tk;
                const bool ok0 = kin && qp < S && (!causal || kp <= qp) &&
                                 (window == 0 || kp > qp - window);
                const bool ok1 = kin && qp + 1 < S &&
                                 (!causal || kp <= qp + 1) &&
                                 (window == 0 || kp > qp + 1 - window);
                p0 = ok0 ? p0 : 0.f;
                s0 = ok0 ? s0 : 0.f;
                p1 = ok1 ? p1 : 0.f;
                s1 = ok1 ? s1 : 0.f;
              }
              pa[2 * jj + x] = pack_bf16(p0, p1);
              dsa[2 * jj + x] = pack_bf16(s0, s1);
            }
          }
        }

        if constexpr (C::RS) {
          // dV += P^T dO, dK += dS^T Q: M = 64 keys, N = D, K = 64
          // queries; B N-major (D <= 64: one slab)
          const uint64_t db_do = make_desc<QSW>(do_st);
          const uint64_t db_q = make_desc<QSW>(q_st);
          fence_regs(pa);
          fence_regs(dsa);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < BQ / 16; ++kk) {
            wgmma_rs<D>(dv_acc, pa + 4 * kk, db_do + 2 * QSW * kk);
            wgmma_rs<D>(dk_acc, dsa + 4 * kk, db_q + 2 * QSW * kk);
          }
          wgmma_commit();
        }
        if (C::DEFER && have) add_acc(prev);   // dqc is still the last tile's
        // dS^T (and, D > 64, P^T) into shared memory: keys as rows, the
        // 64 queries of a row in 128 swizzled bytes.  Every dQ product that
        // read the buffer is done: each warpgroup waited for its own before
        // the last barrier
#pragma unroll
        for (int jj = 0; jj < C::SQ / 8; ++jj)
#pragma unroll
          for (int x = 0; x < 2; ++x) {
            const uint32_t off =
                swz128(kw - k0 + row + 8 * x, qc + 8 * jj + 2 * t);
            *reinterpret_cast<uint32_t*>(gbase + C::DS_OFF + off) =
                dsa[2 * jj + x];
            if constexpr (!C::RS)
              *reinterpret_cast<uint32_t*>(gbase + C::P_OFF + off) =
                  pa[2 * jj + x];
          }
        fence_async_smem();
        if constexpr (C::DEFER) {
          named_sync(BAR_CONSUMERS, CONSUMERS);  // dS^T, P^T whole
        } else {
          turn(cur);                             // ... and this tile's turn
        }

        wgmma_fence();
        if constexpr (!C::RS) {
          // dV += P^T dO, dK += dS^T Q on the warpgroup's D / 2 columns:
          // A K-major from shared memory, B N-major (one or two slabs)
          constexpr int LBO = C::DN > QSW ? C::QSLAB : 16;
          const int slab = w * (C::DN / QSW);
          const uint64_t da_p = make_desc<64>(base + C::P_OFF);
          const uint64_t da_ds = make_desc<64>(base + C::DS_OFF);
          const uint64_t db_do = make_desc<QSW>(do_st + slab * C::QSLAB, LBO);
          const uint64_t db_q = make_desc<QSW>(q_st + slab * C::QSLAB, LBO);
#pragma unroll
          for (int kk = 0; kk < BQ / 16; ++kk) {
            wgmma_ss<C::DN, 0, 1>(dv_acc, da_p + 2 * kk,
                                  db_do + 2 * QSW * kk, 1);
            wgmma_ss<C::DN, 0, 1>(dk_acc, da_ds + 2 * kk,
                                  db_q + 2 * QSW * kk, 1);
          }
        }
        // dQ partial = dS K, chunk by chunk: M = 64 queries, N = KC, K =
        // BK keys; A = dS^T read in the transpose layout, B = K slab c
        // N-major
#pragma unroll
        for (int ci = 0; ci < C::NCH; ++ci) {
          const int c = w + 2 * ci;
          // an even count of chunks deals both warpgroups NCH: no branch
          // around the wgmma (a divergent one serialises them, C7520)
          if (C::CHUNKS % 2 == 0 || c < C::CHUNKS) {
#pragma unroll
            for (int kk = 0; kk < BK / 16; ++kk)
              wgmma_ss<KC, 1, 1>(
                  dqc[ci], make_desc<64>(base + C::DS_OFF + kk * 16 * 128),
                  make_desc<KC>(base + C::K_OFF + c * C::KSLAB +
                                kk * 16 * KC * 2),
                  kk > 0);
          }
        }
        wgmma_commit();
        wgmma_wait();
        fence_regs(dv_acc);
        fence_regs(dk_acc);
        if constexpr (C::RS) {                 // read by the RS products
          fence_regs(pa);
          fence_regs(dsa);
        }
#pragma unroll
        for (int ci = 0; ci < C::NCH; ++ci) fence_regs(dqc[ci]);
        mbar_arrive(empty(s));                 // Q, dO, lse, delta read

        if constexpr (C::DEFER) {
          if (have) release(prev);
          prev = cur;
          have = true;
        } else {
          add_acc(cur);
          release(cur);                        // also frees dS^T, P^T
        }
      }
      if (C::DEFER && have) {                  // the walk's last tile
        turn(prev);
        load_acc(prev);
        add_acc(prev);
        release(prev);
      }

      // dK and dV of the warpgroup's keys and columns, rounded once
      const int col0 = C::RS ? 0 : w * C::DN;
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        const int kp = kw + row + 8 * x;
        if (kp >= Tk) continue;
        const size_t o = (((size_t)b * Tk + kp) * H + h) * D + col0 + 2 * t;
#pragma unroll
        for (int jj = 0; jj < C::DN / 8; ++jj) {
          *reinterpret_cast<uint32_t*>(dk + o + 8 * jj) =
              pack_bf16(dk_acc[4 * jj + 2 * x], dk_acc[4 * jj + 2 * x + 1]);
          *reinterpret_cast<uint32_t*>(dv + o + 8 * jj) =
              pack_bf16(dv_acc[4 * jj + 2 * x], dv_acc[4 * jj + 2 * x + 1]);
        }
      }
      named_sync(BAR_ITEM, NT);                // the item is done
    }
  }
}

template <int D>
cudaError_t launch(const bf16* q, const bf16* k, const bf16* v,
                   const bf16* out, const bf16* dout, const float* lse,
                   float* rows, bf16* dq, bf16* dk, bf16* dv, float* dq_acc,
                   int* counters, int B, int S, int Tk, int H, float scale,
                   int causal, int window, cudaStream_t st) {
  using C = Bwd<D>;
  const int BH = B * H;
  const int nq = (S + BQ - 1) / BQ, nk = (Tk + C::BK - 1) / C::BK;
  if ((long long)BH * nq + 1 > INT_MAX || (long long)BH * nk > INT_MAX ||
      (long long)BH * S > INT_MAX)
    return cudaErrorInvalidValue;
  // a window of S or more masks nothing more than the causal mask does
  window = window < S ? window : S;
  const int n_counters = BH * nq + 1;
  // rows: lse log2(e), then delta, each (B, H, nq * 64)
  float* lse2 = rows;
  float* delta = rows + (size_t)BH * nq * BQ;
  cudaError_t err = launch_delta<bf16>(out, dout, lse, delta, lse2, B, S, H,
                                       D, nq * BQ, counters, n_counters, st);
  if (err != cudaSuccess) return err;
  CUtensorMap mq, mk, mv, mdo;
  if (!make_map(&mq, q, B, S, H, D, C::QSW, BQ) ||
      !make_map(&mdo, dout, B, S, H, D, C::QSW, BQ) ||
      !make_map(&mk, k, B, Tk, H, D, C::KC, C::BK) ||
      !make_map(&mv, v, B, Tk, H, D, C::QSW, C::BK))
    return cudaErrorInvalidValue;
  auto kern = flash_bwd_wgmma<D>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             C::SMEM);
  if (err != cudaSuccess) return err;
  // the consumers' setmaxnreg.inc waits for the registers the producers
  // free: refuse an entry count that would leave it waiting forever
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kern);
  if (err != cudaSuccess) return err;
  if ((attr.numRegs - PRODUCER_REGS) * 128 <
      (CONSUMER_REGS - attr.numRegs) * CONSUMERS)
    return cudaErrorInvalidConfiguration;
  // the persistent grid: at most the blocks resident at once
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kern, NT, C::SMEM)) != cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long fit = (long long)sms * per_sm, items = (long long)BH * nk;
  const int blocks = (int)(items < fit ? items : fit);
  kern<<<blocks, NT, C::SMEM, st>>>(mq, mk, mv, mdo, lse2, delta, dq, dk,
                                    dv, dq_acc, counters, S, Tk, H, BH, nq,
                                    nk, scale, scale * LOG2E, causal, window);
  return cudaGetLastError();
}

}  // namespace wg

// ---------------------------------------------------------------------------
// f32: the first kernels, FMAs outside the tensor cores
// ---------------------------------------------------------------------------
namespace fma {

constexpr int NT = 256;            // threads a block: 8 warps, 16 x 16 grid

// the tiles at head dim D
template <int D>
struct Cfg {
  static constexpr int BQ = D == 256 ? 32 : 64;   // query rows
  static constexpr int BK = D == 256 ? 32 : 64;   // keys
  // row pitches, in elements: odd, so a column read hits 16 banks
  static constexpr int LD = D + 1;                // q, k, v, dout tiles
  static constexpr int LS = BK + 1;               // score tiles
  // shared memory: k, v (BK rows), q, dout (BQ rows), s and dp, then lse
  // and delta of the query rows
  static constexpr int K_OFF = 0;
  static constexpr int V_OFF = K_OFF + align128(BK * LD * 4);
  static constexpr int Q_OFF = V_OFF + align128(BK * LD * 4);
  static constexpr int DO_OFF = Q_OFF + align128(BQ * LD * 4);
  static constexpr int S_OFF = DO_OFF + align128(BQ * LD * 4);
  static constexpr int DP_OFF = S_OFF + align128(BQ * LS * 4);
  static constexpr int LSE_OFF = DP_OFF + align128(BQ * LS * 4);
  static constexpr int DELTA_OFF = LSE_OFF + align128(BQ * 4);
  static constexpr int SMEM = DELTA_OFF + align128(BQ * 4);
  static_assert(SMEM <= 232448, "shared memory");
  static_assert(D % 16 == 0 && BQ % 16 == 0 && BK % 16 == 0, "tiles");
};

// c += opA(A) (M x K) opB(B) (K x N), where opA(A)[m][k] = A[k * lda + m]
// when TA, else A[m * lda + k], and opB(B)[k][n] = B[n * ldb + k] when TB,
// else B[k * ldb + n]; thread (ty, tx) owns rows ty + 16 i, columns tx +
// 16 j
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

// C = opA(A) opB(B) into shared memory (pitch ldc)
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

// the accumulator of an (M x N) output in FMA registers
template <int M, int N>
struct Accum {
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
  // rows [row0, row0 + M) of (b, row, h, :) in dst, rows < n_rows
  __device__ void store(float* dst, int row0, int n_rows, int H, int h,
                        int b) {
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
template <int D, int ROWS, int LD>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          int row0, int n_rows, int H, int h,
                                          int b) {
  for (int e = threadIdx.x; e < ROWS * D / 4; e += NT) {
    const int r = e / (D / 4), c = e % (D / 4) * 4, row = row0 + r;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row < n_rows)
      val = *reinterpret_cast<const float4*>(
          src + (((size_t)b * n_rows + row) * H + h) * D + c);
    dst[r * LD + c] = val.x;
    dst[r * LD + c + 1] = val.y;
    dst[r * LD + c + 2] = val.z;
    dst[r * LD + c + 3] = val.w;
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

// p and ds of a (query tile, key tile) pair in place of s and dp
template <int D>
__device__ __forceinline__ void p_and_ds(uint8_t* smem, int q0, int k0,
                                         int S, int Tk, float scale,
                                         int causal, int window) {
  using C = Cfg<D>;
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
    s_t[r * C::LS + c] = p;
    dp_t[r * C::LS + c] = ds;
  }
}

// s = q k^T and dp = dout v^T of the tiles in shared memory
template <int D>
__device__ __forceinline__ void scores(uint8_t* smem) {
  using C = Cfg<D>;
  const float* k_t = reinterpret_cast<const float*>(smem + C::K_OFF);
  const float* v_t = reinterpret_cast<const float*>(smem + C::V_OFF);
  const float* q_t = reinterpret_cast<const float*>(smem + C::Q_OFF);
  const float* do_t = reinterpret_cast<const float*>(smem + C::DO_OFF);
  mm_smem<C::BQ, C::BK, D, false, true>(
      reinterpret_cast<float*>(smem + C::S_OFF), C::LS, q_t, C::LD, k_t,
      C::LD);
  mm_smem<C::BQ, C::BK, D, false, true>(
      reinterpret_cast<float*>(smem + C::DP_OFF), C::LS, do_t, C::LD, v_t,
      C::LD);
}

// grid (key tiles, B * H)
template <int D>
__global__ void __launch_bounds__(NT) dkdv_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ dk, float* __restrict__ dv, int S, int Tk, int H,
    float scale, int causal, int window) {
  using C = Cfg<D>;
  extern __shared__ __align__(128) uint8_t smem[];
  float* k_t = reinterpret_cast<float*>(smem + C::K_OFF);
  float* v_t = reinterpret_cast<float*>(smem + C::V_OFF);
  float* q_t = reinterpret_cast<float*>(smem + C::Q_OFF);
  float* do_t = reinterpret_cast<float*>(smem + C::DO_OFF);
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

  load_tile<D, C::BK, C::LD>(k_t, k, k0, Tk, H, h, b);
  load_tile<D, C::BK, C::LD>(v_t, v, k0, Tk, H, h, b);
  Accum<C::BK, D> acc_dk, acc_dv;
  acc_dk.zero();
  acc_dv.zero();
  for (int i = i_lo; i < i_hi; ++i) {
    const int q0 = i * C::BQ;
    __syncthreads();             // the last pair's products are done
    load_tile<D, C::BQ, C::LD>(q_t, q, q0, S, H, h, b);
    load_tile<D, C::BQ, C::LD>(do_t, dout, q0, S, H, h, b);
    load_rows<C::BQ>(lse_s, delta_s, lse, delta, q0, S, (size_t)bh);
    __syncthreads();
    scores<D>(smem);
    __syncthreads();
    p_and_ds<D>(smem, q0, k0, S, Tk, scale, causal, window);
    __syncthreads();
    // dv += p^T dout, dk += ds^T q
    acc_dv.template add<C::BQ, true, false>(
        reinterpret_cast<const float*>(smem + C::S_OFF), C::LS, do_t, C::LD);
    acc_dk.template add<C::BQ, true, false>(
        reinterpret_cast<const float*>(smem + C::DP_OFF), C::LS, q_t, C::LD);
  }
  acc_dv.store(dv, k0, Tk, H, h, b);
  acc_dk.store(dk, k0, Tk, H, h, b);
}

// grid (query tiles, B * H)
template <int D>
__global__ void __launch_bounds__(NT) dq_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ dq, int S, int Tk, int H, float scale, int causal,
    int window) {
  using C = Cfg<D>;
  extern __shared__ __align__(128) uint8_t smem[];
  float* k_t = reinterpret_cast<float*>(smem + C::K_OFF);
  float* v_t = reinterpret_cast<float*>(smem + C::V_OFF);
  float* q_t = reinterpret_cast<float*>(smem + C::Q_OFF);
  float* do_t = reinterpret_cast<float*>(smem + C::DO_OFF);
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

  load_tile<D, C::BQ, C::LD>(q_t, q, q0, S, H, h, b);
  load_tile<D, C::BQ, C::LD>(do_t, dout, q0, S, H, h, b);
  load_rows<C::BQ>(lse_s, delta_s, lse, delta, q0, S, (size_t)bh);
  Accum<C::BQ, D> acc_dq;
  acc_dq.zero();
  for (int j = j_lo; j < j_hi; ++j) {
    const int k0 = j * C::BK;
    __syncthreads();
    load_tile<D, C::BK, C::LD>(k_t, k, k0, Tk, H, h, b);
    load_tile<D, C::BK, C::LD>(v_t, v, k0, Tk, H, h, b);
    __syncthreads();
    scores<D>(smem);
    __syncthreads();
    p_and_ds<D>(smem, q0, k0, S, Tk, scale, causal, window);
    __syncthreads();
    // dq += ds k
    acc_dq.template add<C::BK, false, false>(
        reinterpret_cast<const float*>(smem + C::DP_OFF), C::LS, k_t, C::LD);
  }
  acc_dq.store(dq, q0, S, H, h, b);
}

template <int D>
cudaError_t launch(const float* q, const float* k, const float* v,
                   const float* out, const float* dout, const float* lse,
                   float* delta, float* dq, float* dk, float* dv, int B,
                   int S, int Tk, int H, float scale, int causal, int window,
                   cudaStream_t st) {
  using C = Cfg<D>;
  cudaError_t err = launch_delta<float>(out, dout, lse, delta, nullptr, B, S,
                                        H, D, S, nullptr, 0, st);
  if (err != cudaSuccess) return err;
  auto kv = dkdv_kernel<D>;
  auto kq = dq_kernel<D>;
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

}  // namespace fma
}  // namespace

// q, out, dout, dq (B, S, H, D); k, v, dk, dv (B, T, H, D); all contiguous,
// 16-byte aligned and of one type (bf16 when is_bf16, else f32); lse (B, H,
// S) f32.  Scratch, all written here: delta, f32 (B, H, S), and under bf16
// 2 x (B, H, S64) f32 (lse log2(e) and delta, rows padded to S64 = ceil(S
// / 64) * 64); under bf16 also dq_acc, f32 (B, H, S64, D), and counters,
// B * H * S64 / 64 + 1 ints (f32: null).  D is 16, 32, 64,
// 128 or 256; B * H at most 65535 (f32: grid.y; bf16: B * H * S within
// INT_MAX); window >= 0, and > 0 only with causal and S <= T.  The
// launcher checks all of it.  Returns the first CUDA error of the
// launches, or 0.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, const float* lse, float* delta, void* dq, void* dk,
    void* dv, float* dq_acc, int* counters, int B, int S, int T, int H,
    int D, int is_bf16, int causal, int window, float scale, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
#define LAUNCH(D_)                                                          \
  if (is_bf16)                                                              \
    return wg::launch<D_>((const bf16*)q, (const bf16*)k, (const bf16*)v,   \
                          (const bf16*)out, (const bf16*)dout, lse, delta,  \
                          (bf16*)dq, (bf16*)dk, (bf16*)dv, dq_acc,          \
                          counters, B, S, T, H, scale, causal, window, st); \
  return fma::launch<D_>((const float*)q, (const float*)k, (const float*)v, \
                         (const float*)out, (const float*)dout, lse, delta, \
                         (float*)dq, (float*)dk, (float*)dv, B, S, T, H,    \
                         scale, causal, window, st)
  switch (D) {
    case 16: LAUNCH(16);
    case 32: LAUNCH(32);
    case 64: LAUNCH(64);
    case 128: LAUNCH(128);
    case 256: LAUNCH(256);
    default: return cudaErrorInvalidValue;
  }
#undef LAUNCH
}

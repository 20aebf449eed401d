// Forward flash attention for Hopper (sm_90a).
//
// Replaces the Pallas kernel repro/kernels/flash_attention.py::
// flash_attention (_kernel): out = softmax(q k^T * scale + mask) v for q
// (B, S, H, D) and k, v (B, T, H, D) with the heads already broadcast,
// scale = 1/sqrt(D), D in {16, 32, 64, 128, 256}.  The causal mask is
// top-left, kpos <= qpos with both counted from 0, as the Pallas kernel's
// iota masks are.  A window W > 0 (causal only) also drops the keys at or
// before qpos - W: key kpos is kept iff qpos - W < kpos <= qpos, the mask
// of the JAX package's chunked attention (models/attention.py _mask_bias)
// on its sliding-window layers, which the Pallas kernel lacks.  The
// scores, the running max and denominator and P.V are f32, as in the
// Pallas _step, which upcasts q, k and v; the output is rounded once to
// the input type.
// A masked score is NEG_INF = -1e30 and the denominator is floored at
// 1e-30, as there.  On the LM serving path this is the prefill attention
// of prompts longer than 2048 tokens (models/attention.py mha_chunked); in
// training it is the forward of attention.FlashAttention, and then also
// writes each row's log-sum-exp, lse = m scale + log(l) in (B, H, S) f32,
// the backward kernel's input (csrc/flash_attention_bwd.cu).
//
// Bound: the bf16 tensor-core rate.  At (1, 4096, 16, 64) causal the call
// does 4*B*H*D*S(S+1)/2 = 34.4 GFLOP on 16.8 MB of q, k, v and out:
// 0.0348 ms at 989 TFLOP/s, 0.005 ms at 3.35 TB/s.
// Measured there (NVIDIA H100 80GB HBM3, 700 W power limit): the bf16
// kernel below takes 0.126 ms of device time a launch inside the
// 4096-token prefill (chip_smoke.py: 3.03 ms for its 24 launches), 3.6x
// the bound, and about 0.12 ms a launch back to back alone
// (tools/flash_timing.py); 0.1277 ms by CUDA events over back-to-back
// calls; against 1.7707 ms for the first, f32 FMA kernel on bf16 inputs
// and 0.1097 ms for PyTorch's scaled_dot_product_attention.
//
// bf16 inputs (every D) take the wgmma kernel below.  Its design, against
// the four limits of the first (f32 FMA) kernel:
//  * Products on the tensor cores.  A block owns 128 query rows of one
//    (b, h): two consumer warpgroups of 64 rows and one producer warp.
//    S = Q K^T is wgmma m64nBKk16 on bf16 with both operands in shared
//    memory and f32 accumulators; bf16 x bf16 products are exact in f32,
//    so the scores differ from the plain version's only by the order of
//    the f32 sum.
//  * No conversion pass, and loads that overlap the math.  TMA reads q,
//    k and v in place through 4-D tensor maps over (D, H, S, B) (row
//    pitch H*D*2 bytes), swizzled to the row's bytes (128 B at D = 64,
//    64 B at 32, 32 B at 16), which is the layout wgmma reads.  A swizzled
//    box is at most 128 bytes wide, so at D = 128 and 256 a tile loads as
//    2 or 4 column slabs of 64 (one TMA box each, each slab its rows of
//    128 B): the Q.K^T steps walk the slabs along K, and the P.V
//    descriptor steps from slab to slab by its leading byte offset (the
//    slab's bytes; V is N-major there).  The Q
//    tile is loaded once; K and V tiles go through a ring of NS stages
//    with full/empty mbarriers, so the producer loads tile i+1 while the
//    consumers work on tile i, with no __syncthreads in the loop.  TMA
//    fills rows past S and T with zeros: the ragged tails need no code
//    but the mask on the last key tile, and rows at s >= S are not
//    stored.
//  * P stays in registers.  The accumulator fragment of S is, register
//    for register, the A fragment of the next wgmma, so P never touches
//    shared memory (the first kernel's P tile took 67 KB a block).  P.V
//    is held at f32 accuracy on bf16 tensor cores: P = hi + lo with hi =
//    bf16(P), lo = bf16(P - hi), and two wgmma m64nDk16 against the same
//    V tile, read from shared memory in the 16-bit transpose layout (V is
//    keys x D, i.e. K x N with N contiguous).  V is exact in bf16 and P
//    is carried to about 2^-17 relative, where a single bf16 P would
//    round it to 2^-9 and break the plain version's agreement.
//  * Longest blocks first.  Under the causal mask block L takes q tile
//    nq - 1 - L / (B*H), so the grid ends on the short tiles instead of
//    the long ones.  Key tiles wholly in the future of a block's rows, or
//    wholly before its window, are not loaded; a warpgroup passes over a
//    loaded tile that is wholly outside its own 64 rows' keys; the mask is
//    applied only on the diagonal tile, the window's edge tiles and the
//    ragged last tile.
//  * Registers.  A consumer thread holds O (64 x D f32 over 128 threads:
//    D / 2 registers), the scores of a key tile (BK / 2) and P's hi and lo
//    (BK / 4 each).  Key tiles are 128 rows at D <= 64 and 64 rows at D =
//    128 and 256, which keeps D = 256 at 128 + 32 + 32 registers of
//    fragments; its P.V is two m64n128 products, one a half of O.  ptxas
//    gives 288 threads 168 registers each, so at D = 256 the producer is
//    a whole warpgroup that hands its registers to the consumers by
//    setmaxnreg (24 and 240 a thread); with one producer warp it spilled
//    572 bytes a thread (ptxas -v).
//  The online softmax works in registers on the accumulator fragment, in
//  base 2 on the raw scores (exp2(s c - m c), c = scale log2 e, by
//  ex2.approx.ftz): each row's max is reduced across the four threads of
//  a quad with shuffles; each thread keeps its own partial row sum,
//  reduced once at the end.  A masked score is -1e30 and contributes
//  exp(-1e30 - m) = 0 once the row has a finite max; a row whose keys so
//  far were all masked (a window's first tiles) takes its max as 0 for
//  the exponent, so its masked scores give 0 too, not exp(0).  Every row
//  keeps its own key, so it ends with a finite max.
//
// f32 inputs keep the first kernel (namespace fma below): f32 FMAs, one
// block of 256 threads per (64 query rows, one (b, h)), the probabilities
// through shared memory (214,528 bytes at D = 256, which the launch opts
// into).  It serves the f32 models' chunked prefill (the decode-vs-prefill
// checks).
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cudaTypedefs.h>

#include <climits>
#include <cstdint>

namespace {
// ---------------------------------------------------------------------------
// f32: the first kernel, FMAs outside the tensor cores
// ---------------------------------------------------------------------------
namespace fma {

constexpr int BQ = 64;        // query rows of a block
constexpr int BK = 64;        // key rows of a tile
constexpr int NT = 256;       // threads: 16 row groups x 16 columns
constexpr int P_PAD = 4;      // row pitch of the P tile: BK + 4 words
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float group_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(~0u, x, o));
  return x;
}
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(~0u, x, o);
  return x;
}

template <int D>
constexpr int smem_floats() {
  return BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * (BK + P_PAD);
}

template <int D>
__global__ void __launch_bounds__(NT) flash_attention_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ out,
    float* __restrict__ lse, int S, int Tk, int H, float scale, int causal,
    int window) {
  constexpr int DJ = D / 16;                   // output columns a thread
  extern __shared__ float smem[];
  float* Qs = smem;                            // BQ x (D + 1)
  float* Ks = Qs + BQ * (D + 1);               // BK x (D + 1)
  float* Vs = Ks + BK * (D + 1);               // BK x D
  float* Ps = Vs + BK * D;                     // BQ x (BK + P_PAD)

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int q0 = blockIdx.x * BQ;
  const size_t pitch = (size_t)H * D;          // between rows of one head
  const float* qh = q + ((size_t)b * S * H + h) * D;
  const float* kh = k + ((size_t)b * Tk * H + h) * D;
  const float* vh = v + ((size_t)b * Tk * H + h) * D;

  for (int e = tid; e < BQ * D; e += NT) {
    const int r = e / D, c = e % D, s = q0 + r;
    Qs[r * (D + 1) + c] = s < S ? qh[(size_t)s * pitch + c] : 0.f;
  }

  float m[4], l[4], acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }

  // keys after the block's last query row, or before its first row's
  // window, are masked for all its rows
  const int kv_end = causal ? min(Tk, q0 + BQ) : Tk;
  const int kv_begin = window > 0 ? max(0, q0 - window + 1) / BK * BK : 0;
  for (int k0 = kv_begin; k0 < kv_end; k0 += BK) {
    __syncthreads();             // the previous tile's P.V is done with Vs, Ps
    for (int e = tid; e < BK * D; e += NT) {
      const int r = e / D, c = e % D, t = k0 + r;
      const bool in = t < Tk;
      Ks[r * (D + 1) + c] = in ? kh[(size_t)t * pitch + c] : 0.f;
      Vs[r * D + c] = in ? vh[(size_t)t * pitch + c] : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float a[4], kk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Qs[(ty * 4 + i) * (D + 1) + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kk[j] = Ks[(tx + 16 * j) * (D + 1) + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], kk[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty * 4 + i;
      bool valid[4];
      float mt = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx + 16 * j;
        valid[j] = kp < Tk && (!causal || kp <= qp) &&
                   (window == 0 || kp > qp - window);
        s[i][j] = valid[j] ? s[i][j] * scale : NEG_INF;
        mt = fmaxf(mt, s[i][j]);
      }
      const float m_new = fmaxf(m[i], group_max(mt));
      const float corr = expf(m[i] - m_new);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = valid[j] ? expf(s[i][j] - m_new) : 0.f;
        Ps[(ty * 4 + i) * (BK + P_PAD) + tx + 16 * j] = p;
        ps += p;
      }
      l[i] = l[i] * corr + group_sum(ps);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= corr;
    }
    __syncthreads();

#pragma unroll 8
    for (int c = 0; c < BK; ++c) {
      float p[4], vv[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ps[(ty * 4 + i) * (BK + P_PAD) + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) vv[j] = Vs[c * D + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(p[i], vv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = q0 + ty * 4 + i;
    if (s >= S) continue;
    const float den = fmaxf(l[i], 1e-30f);
    float* o = out + ((size_t)b * S + s) * pitch + (size_t)h * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j) o[tx + 16 * j] = acc[i][j] / den;
    // m and l are the row's own across the 16 threads of its group
    if (lse != nullptr && tx == 0)
      lse[((size_t)b * H + h) * S + s] = m[i] + logf(den);
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   float* lse, int B, int S, int Tk, int H, float scale,
                   int causal, int window, cudaStream_t st) {
  // above 48 KB from D = 64 on: opted into here, and a launch it does not
  // cover is refused (cudaGetLastError below), never run
  const int bytes = smem_floats<D>() * (int)sizeof(float);
  auto kern = flash_attention_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + BQ - 1) / BQ, B * H);
  kern<<<grid, NT, bytes, st>>>((const float*)q, (const float*)k,
                                (const float*)v, (float*)out, lse, S, Tk,
                                H, scale, causal, window);
  return cudaGetLastError();
}

}  // namespace fma

// ---------------------------------------------------------------------------
// bf16: wgmma on tiles fed by TMA
// ---------------------------------------------------------------------------
namespace wg {

constexpr int BQ = 128;           // query rows of a block: two warpgroups
constexpr int NS = 2;             // K/V stages in the ring
constexpr int CONSUMERS = 256;    // 2 consumer warpgroups
constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 240;   // see Tiles::NT
constexpr float NEG_INF = -1e30f;

// The tiles at head dim D.  A tile of rows of D bf16 is held as SLABS
// column slabs of SW columns, each slab its rows of SW * 2 bytes in a row,
// swizzled to those bytes (one TMA box; a swizzled box is at most 128 B).
template <int D>
struct Tiles {
  static constexpr int SW = D < 64 ? D : 64;       // columns of a slab
  static constexpr int SLABS = D / SW;
  static constexpr int BK = D <= 64 ? 128 : 64;    // key rows of a tile
  static constexpr int QSLAB = BQ * SW * 2;        // bytes of a Q slab
  static constexpr int KVSLAB = BK * SW * 2;       // bytes of a K or V slab
  static constexpr int QBYTES = SLABS * QSLAB;
  static constexpr int KVBYTES = SLABS * KVSLAB;
  // wgmma's swizzle mode: 1 for 128 B, 2 for 64 B, 3 for 32 B
  static constexpr uint64_t MODE = SW == 64 ? 1 : SW == 32 ? 2 : 3;
  // threads: the consumers and one producer warp; at D = 256 a whole
  // producer warpgroup, so that setmaxnreg can move registers to the
  // consumers: 384 threads enter with 168 registers each (65,536 / 384),
  // the producers drop to PRODUCER_REGS and the consumers rise to
  // CONSUMER_REGS, (168 - 24) * 128 = (240 - 168) * 256
  static constexpr bool SPLIT_REGS = D == 256;
  static constexpr int NT = SPLIT_REGS ? CONSUMERS + 128 : CONSUMERS + 32;
  static_assert(D % 16 == 0 && D <= 256 && SLABS * SW == D, "head dim");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// one box of a 4-D tensor map at coordinates (col, h, row, b)
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int col, int h,
                                         int row, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(h),
      "r"(row), "r"(b)
      : "memory");
}

// a tile of `rows` rows, slab by slab (the slabs contiguous, `slab` bytes
// apart)
template <int D>
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int slab, int h,
                                         int row, int b) {
#pragma unroll
  for (int c = 0; c < Tiles<D>::SLABS; ++c)
    tma_load(dst + c * slab, map, bar, c * Tiles<D>::SW, h, row, b);
}

// wgmma shared-memory descriptor of a slab of rows as TMA wrote it: start
// address, leading byte offset, stride byte offset between 8-row groups
// (8 rows of a slab), all in 16-byte units, and the swizzle mode.  The
// leading offset is unused by the K-major operands (a k16 step lies within
// one swizzle row); for the N-major V it is the step from one 64-column
// slab to the next (unused at D <= 64, one slab)
template <int D>
__device__ __forceinline__ uint64_t make_desc(uint32_t addr,
                                              uint32_t lbo = 16) {
  constexpr uint64_t sbo = 8 * Tiles<D>::SW * 2;
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((sbo >> 4) << 32) | (Tiles<D>::MODE << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
// keep the compiler from moving accumulator reads or writes across the
// asynchronous wgmma's issue and wait
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// 2^x; 0 for the masked scores' -1.8e29 and for results below 2^-126
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// D += A B for A (64 x 16) and B (16 x N), both K-major in shared memory
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da,
                                         uint64_t db, int scale_d);
// D += A B for A (64 x 16) in registers and B (16 x N) N-major in shared
// memory (the transpose layout); d is the N / 2 accumulators from d[0]
template <int N>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a,
                                         uint64_t db);

template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_ss<128>(float (&d)[64], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<16>(float* d, const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<32>(float* d, const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float* d, const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float* d, const uint32_t* a,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo_col, float hi_col) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo_col, hi_col);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int D>
constexpr int smem_bytes() {
  // 1024 bytes of slack to align the tiles to the 128-byte swizzle's
  // 1024-byte period, the tiles, then the barriers
  return 1024 + Tiles<D>::QBYTES + 2 * NS * Tiles<D>::KVBYTES +
         (1 + 2 * NS) * 8;
}

// grid: one block per (q tile, b, h), longest first under the causal mask
template <int D>
__global__ void __launch_bounds__(Tiles<D>::NT, 1) flash_attention_wgmma(
    const __grid_constant__ CUtensorMap tq,
    const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ out,
    float* __restrict__ lse, int S, int Tk, int H, int BH, int nq,
    float scale, float scale_log2, int causal, int window) {
  using Tl = Tiles<D>;
  constexpr int BK = Tl::BK, SW = Tl::SW;
  constexpr int KVBYTES = Tl::KVBYTES, KVSLAB = Tl::KVSLAB;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t q_s = base;
  const uint32_t k_s = q_s + Tl::QBYTES;              // NS stages
  const uint32_t v_s = k_s + NS * KVBYTES;            // NS stages
  const uint32_t bars = v_s + NS * KVBYTES;
  const uint32_t q_full = bars;
  auto full = [&](int s) { return bars + 8 * (1 + s); };
  auto empty = [&](int s) { return bars + 8 * (1 + NS + s); };

  const int bh = blockIdx.x % BH;
  const int qt = causal ? nq - 1 - (int)(blockIdx.x / BH)
                        : (int)(blockIdx.x / BH);
  const int b = bh / H, h = bh % H;
  const int q0 = qt * BQ;
  // key tiles after the block's last query row, or wholly before its first
  // row's window, are masked for all its rows
  const int kv_end = causal ? min(Tk, q0 + BQ) : Tk;
  const int t_first = window > 0 ? max(0, q0 - window + 1) / BK : 0;
  const int n_tiles = (kv_end + BK - 1) / BK - t_first;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < NS; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // one if / else for the two roles, so that ptxas can place setmaxnreg
  if (threadIdx.x >= CONSUMERS) {
    if constexpr (Tl::SPLIT_REGS)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(
          PRODUCER_REGS));
    // producer warp: one thread keeps the ring full
    if (threadIdx.x == CONSUMERS) {
      mbar_expect_tx(q_full, Tl::QBYTES);
      tma_tile<D>(q_s, &tq, q_full, Tl::QSLAB, h, q0, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % NS, k0 = (t_first + i) * BK;
        if (i >= NS) mbar_wait(empty(s), ((i / NS) - 1) & 1);
        mbar_expect_tx(full(s), 2 * KVBYTES);
        tma_tile<D>(k_s + s * KVBYTES, &tk, full(s), KVSLAB, h, k0, b);
        tma_tile<D>(v_s + s * KVBYTES, &tv, full(s), KVSLAB, h, k0, b);
      }
    }
  } else {
    if constexpr (Tl::SPLIT_REGS)
      asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(
          CONSUMER_REGS));
    // consumer warpgroup w owns rows q0 + 64 w .. + 63; a thread holds rows
    // r and r + 8 of its warp's 16, columns 8 j + 2 t and 8 j + 2 t + 1
    const int w = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4;
    const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
    const int row0 = q0 + 64 * w;                 // the warpgroup's first row
    const int r = row0 + 16 * warp + g;

    float o[D / 2], m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    // the warpgroup's 64 rows in each Q slab
    const uint64_t dq = make_desc<D>(q_s + 64 * w * SW * 2);

    mbar_wait(q_full, 0);
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % NS, k0 = (t_first + i) * BK;
      mbar_wait(full(s), (i / NS) & 1);
      // a tile wholly in the future of the warpgroup's rows, or wholly before
      // its first row's window, changes none of them
      if ((causal && k0 > row0 + 63) ||
          (window > 0 && k0 + BK - 1 <= row0 - window)) {
        mbar_arrive(empty(s));
        continue;
      }
      float sc[BK / 2];
      const uint64_t dk = make_desc<D>(k_s + s * KVBYTES);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {    // 16 columns = 32 bytes a step
        constexpr int STEPS = SW / 16;         // k16 steps in a slab
        const int off = (kk / STEPS) * (Tl::QSLAB >> 4) + 2 * (kk % STEPS);
        const int koff = (kk / STEPS) * (KVSLAB >> 4) + 2 * (kk % STEPS);
        wgmma_ss<BK>(sc, dq + off, dk + koff, kk > 0);
      }
      wgmma_commit();
      wgmma_wait();
      fence_regs(sc);

      if (k0 + BK > Tk || (causal && k0 + BK - 1 > row0) ||
          (window > 0 && k0 < row0 + 64 - window)) {
#pragma unroll
        for (int j = 0; j < BK / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kp = k0 + 8 * j + 2 * t + (e & 1);
            const int qp = r + 8 * (e >> 1);
            if (kp >= Tk || (causal && kp > qp) ||
                (window > 0 && kp <= qp - window))
              sc[4 * j + e] = NEG_INF;
          }
      }

      float corr[2], mneg[2];
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        float mx = m[x];
#pragma unroll
        for (int j = 0; j < BK / 8; ++j)
          mx = fmaxf(mx, fmaxf(sc[4 * j + 2 * x], sc[4 * j + 2 * x + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(~0u, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(~0u, mx, 2));
        corr[x] = ex2((m[x] - mx) * scale_log2);
        m[x] = mx;
        // a row with every key so far masked: exponent base 0, so its masked
        // scores give ex2(-1.4e30 c) = 0 and not ex2(0) = 1
        mneg[x] = mx == NEG_INF ? 0.f : -mx * scale_log2;
      }
      uint32_t hi[BK / 4], lo[BK / 4];
      float ps[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < BK / 4; ++j) {
        const int x = j & 1;                     // row r (even j) or r + 8
        const float p0 = ex2(fmaf(sc[2 * j], scale_log2, mneg[x]));
        const float p1 = ex2(fmaf(sc[2 * j + 1], scale_log2, mneg[x]));
        ps[x] += p0 + p1;
        hi[j] = pack_bf16(p0, p1);
        const float2 hf =
            __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&hi[j]));
        lo[j] = pack_bf16(p0 - hf.x, p1 - hf.y);
      }
#pragma unroll
      for (int x = 0; x < 2; ++x) l[x] = l[x] * corr[x] + ps[x];
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[4 * j + e] *= corr[e >> 1];

      // o += hi V + lo V; a 16-key step of V is 16 rows of each slab.  At
      // D = 256 each half of O (128 columns, two slabs) is its own product.
      constexpr int N = D < 128 ? D : 128;
      const uint64_t dv =
          make_desc<D>(v_s + s * KVBYTES, Tl::SLABS > 1 ? KVSLAB : 16);
      fence_regs(o);
      wgmma_fence();
#pragma unroll
      for (int half = 0; half < D / N; ++half) {
        const uint64_t dvh = dv + half * ((N / SW) * KVSLAB >> 4);
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
          wgmma_rs<N>(o + half * (N / 2), hi + 4 * kk, dvh + 2 * SW * kk);
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
          wgmma_rs<N>(o + half * (N / 2), lo + 4 * kk, dvh + 2 * SW * kk);
      }
      wgmma_commit();
      wgmma_wait();
      fence_regs(o);
      mbar_arrive(empty(s));
    }

#pragma unroll
    for (int x = 0; x < 2; ++x) {
      float den = l[x];
      den += __shfl_xor_sync(~0u, den, 1);
      den += __shfl_xor_sync(~0u, den, 2);
      den = fmaxf(den, 1e-30f);
      const int row = r + 8 * x;
      if (row >= S) continue;
      // m is the row's raw max, reduced across the quad at every tile
      if (lse != nullptr && t == 0)
        lse[((size_t)b * H + h) * S + row] = m[x] * scale + logf(den);
      __nv_bfloat16* dst = out + (((size_t)b * S + row) * H + h) * D + 2 * t;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) = __floats2bfloat162_rn(
            o[4 * j + 2 * x] / den, o[4 * j + 2 * x + 1] / den);
    }
  }
}

// a 4-D map over (D, H, L, B) of a contiguous (B, L, H, D) bf16 tensor,
// boxes of `rows` rows of one head and one slab's columns, swizzled to the
// slab's bytes
template <int D>
bool make_map(CUtensorMap* map, const void* ptr, int B, int L, int H,
              int rows) {
  static PFN_cuTensorMapEncodeTiled_v12000 encode = nullptr;
  if (encode == nullptr) {
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled",
                                reinterpret_cast<void**>(&encode),
                                cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      return false;
  }
  constexpr int SW = Tiles<D>::SW;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)L,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)H * D * 2,
                                 (cuuint64_t)L * H * D * 2};
  const cuuint32_t box[4] = {(cuuint32_t)SW, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swz = SW == 64   ? CU_TENSOR_MAP_SWIZZLE_128B
                                 : SW == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                            : CU_TENSOR_MAP_SWIZZLE_32B;
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swz,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   float* lse, int B, int S, int Tk, int H, float scale,
                   int causal, int window, cudaStream_t st) {
  CUtensorMap mq, mk, mv;
  constexpr int BK = Tiles<D>::BK;
  if (!make_map<D>(&mq, q, B, S, H, BQ) || !make_map<D>(&mk, k, B, Tk, H, BK)
      || !make_map<D>(&mv, v, B, Tk, H, BK))
    return cudaErrorInvalidValue;
  const int nq = (S + BQ - 1) / BQ;
  const long long blocks = (long long)nq * B * H;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  const int bytes = smem_bytes<D>();
  auto kern = flash_attention_wgmma<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  if constexpr (Tiles<D>::SPLIT_REGS) {
    // the consumers' setmaxnreg.inc waits for the registers the producers
    // free: refuse an entry count that would leave it waiting forever
    cudaFuncAttributes attr;
    err = cudaFuncGetAttributes(&attr, kern);
    if (err != cudaSuccess) return err;
    if ((attr.numRegs - PRODUCER_REGS) * 128 <
        (CONSUMER_REGS - attr.numRegs) * CONSUMERS)
      return cudaErrorInvalidConfiguration;
  }
  kern<<<(unsigned)blocks, Tiles<D>::NT, bytes, st>>>(
      mq, mk, mv, (__nv_bfloat16*)out, lse, S, Tk, H, B * H, nq, scale,
      scale * 1.4426950408889634f, causal, window);
  return cudaGetLastError();
}

}  // namespace wg
}  // namespace

// q (B, S, H, D), k and v (B, T, H, D), out (B, S, H, D), all contiguous
// and of one type: bf16 when is_bf16, else f32.  lse, when not null, is
// (B, H, S) f32 and takes each row's log-sum-exp of its scaled scores,
// m + log(l) (the backward's input, models/attention.py's _chunk_fwd);
// the serving path passes null and writes nothing there.  D is 16, 32, 64, 128 or
// 256; window >= 0, and > 0 only with causal and S <= T (every row keeps
// its own key).  bf16: 16-byte aligned pointers, ceil(S / 128) * B * H at
// most INT_MAX blocks; f32: B * H at most 65535 (grid.y).  The launcher
// checks all of it.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, float* lse,
                                      int B, int S, int T, int H, int D,
                                      int is_bf16, int causal, int window,
                                      float scale, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
#define LAUNCH(D_)                                                         \
  return is_bf16 ? wg::launch<D_>(q, k, v, out, lse, B, S, T, H, scale,    \
                                  causal, window, st)                      \
                 : fma::launch<D_>(q, k, v, out, lse, B, S, T, H, scale,   \
                                   causal, window, st)
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

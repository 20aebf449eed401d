// Forward flash attention for Hopper (sm_90a).
//
// Replaces the Pallas kernel repro/kernels/flash_attention.py::
// flash_attention (_kernel): out = softmax(q k^T * scale + mask) v for q
// (B, S, H, D) and k, v (B, T, H, D) with the heads already broadcast,
// scale = 1/sqrt(D).  The causal mask is top-left, kpos <= qpos with both
// counted from 0, as the Pallas kernel's iota masks are.  Inputs are bf16
// or f32; the scores, the running max and denominator and P.V are f32, as
// in the Pallas _step, which upcasts q, k and v; the output is cast to the
// input type.  A masked score is NEG_INF = -1e30 and the denominator is
// floored at 1e-30, as there.  On the LM serving path this is the prefill
// attention of prompts longer than 2048 tokens (models/attention.py
// mha_chunked).
//   Bound: in bf16 the tensor-core rate.  At (1, 4096, 16, 64) causal the
//   call does 4*B*H*S*T*D/2 = 34.4 GFLOP on 16.8 MB of q, k, v and out:
//   0.035 ms at 989 TFLOP/s, 0.005 ms at 3.35 TB/s.  This first kernel
//   does its products with f32 FMAs outside the tensor cores (peak 67
//   TFLOP/s, 0.51 ms for that call), so it cannot come near the bound;
//   wgmma on bf16 tiles fed by TMA is the redesign.
//   Design: one block of 256 threads per (64 query rows, one (b, h)).  The
//   query tile stays in shared memory as f32; the block walks the key
//   tiles of 64 rows from the first, skipping those wholly in the future
//   of its last query row.  Each thread holds a 4 x 4 patch of the score
//   tile (rows 4*ty.., columns tx + 16*j, which keeps the shared-memory
//   reads free of bank conflicts) and a 4 x D/16 patch of the output
//   accumulator; the sixteen threads of a row group reduce the row's max
//   and sum with warp shuffles and keep identical copies of m and l.  The
//   probabilities go through shared memory to the P.V product.  Ragged S
//   and T tails are masked: padded key columns get probability 0, padded
//   query rows are computed on zeros and never stored.  Every row sees
//   key 0 in the first tile (top-left mask), so its max is finite from
//   then on and a masked score contributes exp(-1e30 - m) = 0, as in the
//   Pallas kernel.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;        // query rows of a block
constexpr int BK = 64;        // key rows of a tile
constexpr int NT = 256;       // threads: 16 row groups x 16 columns
constexpr int P_PAD = 4;      // row pitch of the P tile: BK + 4 words
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

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

template <typename T, int D>
__global__ void __launch_bounds__(NT) flash_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ out, int S, int Tk, int H,
    float scale, int causal) {
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
  const T* qh = q + ((size_t)b * S * H + h) * D;
  const T* kh = k + ((size_t)b * Tk * H + h) * D;
  const T* vh = v + ((size_t)b * Tk * H + h) * D;

  for (int e = tid; e < BQ * D; e += NT) {
    const int r = e / D, c = e % D, s = q0 + r;
    Qs[r * (D + 1) + c] = s < S ? to_f32(qh[(size_t)s * pitch + c]) : 0.f;
  }

  float m[4], l[4], acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }

  // keys after the block's last query row are masked for all its rows
  const int kv_end = causal ? min(Tk, q0 + BQ) : Tk;
  for (int k0 = 0; k0 < kv_end; k0 += BK) {
    __syncthreads();             // the previous tile's P.V is done with Vs, Ps
    for (int e = tid; e < BK * D; e += NT) {
      const int r = e / D, c = e % D, t = k0 + r;
      const bool in = t < Tk;
      Ks[r * (D + 1) + c] = in ? to_f32(kh[(size_t)t * pitch + c]) : 0.f;
      Vs[r * D + c] = in ? to_f32(vh[(size_t)t * pitch + c]) : 0.f;
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
        valid[j] = kp < Tk && (!causal || kp <= qp);
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
    T* o = out + ((size_t)b * S + s) * pitch + (size_t)h * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j) store(o + tx + 16 * j, acc[i][j] / den);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int B, int S, int Tk, int H, float scale, int causal,
                   cudaStream_t st) {
  const int bytes = smem_floats<D>() * (int)sizeof(float);
  auto kern = flash_attention_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + BQ - 1) / BQ, B * H);
  kern<<<grid, NT, bytes, st>>>((const T*)q, (const T*)k, (const T*)v,
                                (T*)out, S, Tk, H, scale, causal);
  return cudaGetLastError();
}

}  // namespace

// q (B, S, H, D), k and v (B, T, H, D), out (B, S, H, D), all contiguous
// and of one type: bf16 when is_bf16, else f32.  D is 16, 32 or 64;
// B * H at most 65535 (grid.y).  The launcher checks all of it.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int B, int S,
                                      int T, int H, int D, int is_bf16,
                                      int causal, float scale,
                                      void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
#define LAUNCH(D_)                                                        \
  return is_bf16 ? launch<__nv_bfloat16, D_>(q, k, v, out, B, S, T, H,    \
                                             scale, causal, st)           \
                 : launch<float, D_>(q, k, v, out, B, S, T, H, scale,     \
                                     causal, st)
  switch (D) {
    case 16: LAUNCH(16);
    case 32: LAUNCH(32);
    case 64: LAUNCH(64);
    default: return cudaErrorInvalidValue;
  }
#undef LAUNCH
}

// Prefill attention for Hopper (sm_90a): causal or full, fp32 inside.
//
// Replaces: src/repro/kernels/flash_attention.py, flash_attention
// (_flash_kernel). Same contract: q (BH, S, hd), k/v (BH, Sk, hd) with KV
// heads already repeated; online softmax with fp32 m, l and accumulator;
// causal mask top-left aligned (qpos >= kpos); key tiles wholly above the
// diagonal skipped, the diagonal tile and key padding masked to -1e30;
// l clamped to 1e-30.
//
// Bound on the card: operations at long prompts. Causal work is about
// 2*BH*S^2*hd FLOPs (QK^T and PV over the lower triangle) against
// 4*BH*S*hd*elt bytes, about S/4 FLOP per byte in bf16: above the card's
// ~295 from S ~ 1200, so shorter prompts are bounded by their bytes. In
// practice this first version is bounded by neither: its fp32 FMAs run
// on CUDA cores (67 TFLOP/s), far below the bf16 tensor-core rate.
//
// Design: one 128-thread block per (64-row query tile, bh). It sweeps
// 64-key tiles staged in shared memory as fp32, so HBM traffic stays
// O(S) per row and no S x S score matrix exists. Each thread owns a 4 x 8
// micro-tile of the score tile (rows rg + 16i, keys cg + 8j) and the same
// 4 rows of the output (columns cg + 8j), so a row's max and sum reduce
// over the 8 lanes that share it with three shuffles. Tiles above the
// diagonal are never loaded. mma/wgmma with TMA-fed tiles is the step
// that moves it toward its bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;         // query rows per block
constexpr int BK = 64;         // keys per tile
constexpr int NT = 128;        // 16 row groups x 8 column groups
constexpr int LP = BK + 1;     // padded row of the probability tile
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <int HD>
constexpr size_t smem_bytes() {
  // Q and K tiles padded to HD + 1 (conflict-free column reads), V, P.
  return sizeof(float) * (BQ * (HD + 1) + BK * (HD + 1) + BK * HD + BQ * LP);
}

template <typename T, int HD>
__global__ void __launch_bounds__(NT)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o, int S, int Sk,
             int causal, float scale) {
  constexpr int LD = HD + 1;
  constexpr int DJ = HD / 8;   // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + BQ * LD;
  float* Vs = Ks + BK * LD;
  float* Ps = Vs + BK * HD;

  const int q0 = blockIdx.x * BQ;
  const size_t bh = blockIdx.y;
  const int tid = threadIdx.x;
  const int rg = tid >> 3;
  const int cg = tid & 7;
  const T* qb = q + bh * S * HD;
  const T* kb = k + bh * Sk * HD;
  const T* vb = v + bh * Sk * HD;

  for (int e = tid; e < BQ * HD; e += NT) {
    const int r = e / HD, d = e % HD;
    Qs[r * LD + d] = q0 + r < S ? to_f32(qb[(size_t)(q0 + r) * HD + d]) : 0.f;
  }

  float m[4], l[4], acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }

  int n_kt = (Sk + BK - 1) / BK;
  if (causal) n_kt = min(n_kt, (q0 + BQ - 1) / BK + 1);

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // Q written; previous tile's K, V and P consumed
    for (int e = tid; e < BK * HD; e += NT) {
      const int r = e / HD, d = e % HD;
      const bool ok = k0 + r < Sk;
      const size_t off = (size_t)(k0 + r) * HD + d;
      Ks[r * LD + d] = ok ? to_f32(kb[off]) : 0.f;
      Vs[r * HD + d] = ok ? to_f32(vb[off]) : 0.f;
    }
    __syncthreads();

    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float qv[4], kv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(rg + 16 * i) * LD + d];
#pragma unroll
      for (int j = 0; j < 8; ++j) kv[j] = Ks[(cg + 8 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + rg + 16 * i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int kpos = k0 + cg + 8 * j;
        const bool ok = kpos < Sk && (!causal || qpos >= kpos);
        s[i][j] = ok ? s[i][j] * scale : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p = expf(s[i][j] - m_new);
        Ps[(rg + 16 * i) * LP + cg + 8 * j] = p;
        rs += p;
      }
      rs += __shfl_xor_sync(0xffffffffu, rs, 1);
      rs += __shfl_xor_sync(0xffffffffu, rs, 2);
      rs += __shfl_xor_sync(0xffffffffu, rs, 4);
      l[i] = fmaf(l[i], alpha, rs);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(rg + 16 * i) * LP + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const float vv = Vs[c * HD + cg + 8 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + rg + 16 * i;
    if (row >= S) continue;
    const float li = fmaxf(l[i], 1e-30f);
    T* orow = o + (bh * S + row) * HD;
#pragma unroll
    for (int j = 0; j < DJ; ++j) store(orow + cg + 8 * j, acc[i][j] / li);
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int BH, int S, int Sk, int causal, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD>();
  // above 48 KB a block may use dynamic shared memory only after opting in
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((S + BQ - 1) / BQ, BH);
  flash_kernel<T, HD><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, Sk, causal,
      1.0f / sqrtf((float)HD));
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(const void* q, const void* k, const void* v, void* o,
                        int BH, int S, int Sk, int hd, int causal,
                        cudaStream_t stream) {
  switch (hd) {
    case 16: return launch<T, 16>(q, k, v, o, BH, S, Sk, causal, stream);
    case 32: return launch<T, 32>(q, k, v, o, BH, S, Sk, causal, stream);
    case 64: return launch<T, 64>(q, k, v, o, BH, S, Sk, causal, stream);
    case 128: return launch<T, 128>(q, k, v, o, BH, S, Sk, causal, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 float32, 1 bfloat16. Returns the launch's cudaError_t.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, int BH, int S,
                                   int Sk, int hd, int causal, int dtype,
                                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_hd<float>(q, k, v, o, BH, S, Sk, hd, causal, st);
  if (dtype == 1)
    return dispatch_hd<__nv_bfloat16>(q, k, v, o, BH, S, Sk, hd, causal, st);
  return cudaErrorInvalidValue;
}

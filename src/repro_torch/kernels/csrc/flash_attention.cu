// Prefill attention for Hopper (sm_90a): causal or full.
//
// Replaces: src/repro/kernels/flash_attention.py, flash_attention
// (_flash_kernel). Same contract: q (BH, S, hd), k/v (BH, Sk, hd) with KV
// heads already repeated; online softmax with fp32 m, l and accumulator;
// causal mask top-left aligned (qpos >= kpos); key tiles wholly above the
// diagonal never loaded, the diagonal tile and key padding masked to
// -1e30; l clamped to 1e-30; hd in {16, 32, 64, 128}.
//
// Bound on the card: causal work is about 2*BH*S^2*hd FLOPs (QK^T and PV
// over the lower triangle) against 4*BH*S*hd*2 bytes in bf16, about S/4
// FLOP per byte: bound by bytes below S ~ 1200, by the bf16 tensor cores
// above. At the served prompts (S <= 512) the kernel is short (tens of
// microseconds) and reaches neither bound: each block's chain of tiles,
// each a load, a barrier and a dependent run of mma.sync and softmax, sets
// its time: variants with more blocks per SM (32-key tiles) or half the
// K/V re-reads (128-row query tiles) did not beat this one at S <= 512.
//
// bf16 design (the served path), FA2-style on mma.sync.m16n8k16:
// - mma.sync, not wgmma: a warp owns its 16 query rows end to end, so the
//   online softmax needs no exchange between warps, and P goes from the
//   accumulators of QK^T straight into the A operand of PV.
// - One 128-thread block per (bh, 64-row query tile); each warp owns 16
//   query rows. The grid runs bh fastest and query tiles from the last,
//   so the heaviest causal tiles of every head launch first.
// - K and V tiles (64 keys) stay bf16 in shared memory, rows padded by 16
//   bytes so every ldmatrix (.trans for V) is free of bank conflicts, and
//   double-buffered by cp.async: tile j+1 loads while tile j multiplies.
//   Shared memory is 5 tiles, 87 KB at hd 128: two blocks per SM.
// - S = Q K^T runs on bf16 tensor cores with fp32 accumulation; bf16
//   products are exact in fp32, as in the Pallas kernel's fp32 upcast.
//   Q's fragments are re-read from shared memory at each tile, which keeps
//   the kernel at 96-176 registers.
// - The online softmax runs in registers on fp32 S, in base 2 with the
//   scale folded into one FMA per score; only a tile that holds key
//   padding or crosses the warp's diagonal computes the mask. A row's max
//   and sum reduce over the 4 lanes that share it. P is rounded to bf16
//   in registers and is the A operand of PV, with no trip through shared
//   memory. That rounding is the one the Pallas body (fp32 P) does not
//   do: it moves each weight by at most 2^-9 relative, inside the bf16
//   tolerance of 5e-2. l sums the fp32 P, as the Pallas body does.
//
// fp32 design (kept from the first version: exact fp32 products on CUDA
// cores, no TF32): one 128-thread block per (64-row query tile, bh),
// 64-key tiles staged as fp32 in shared memory; each thread owns a 4 x 8
// micro-tile of the score tile and the same 4 rows of the output.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;         // query rows per block
constexpr int BK = 64;         // keys per tile
constexpr int NT = 128;        // threads per block
constexpr float NEG_INF = -1e30f;

// ------------------------------------------------------------------ fp32
namespace f32 {

constexpr int LP = BK + 1;     // padded row of the probability tile

template <int HD>
constexpr size_t smem_bytes() {
  // Q and K tiles padded to HD + 1 (conflict-free column reads), V, P.
  return sizeof(float) * (BQ * (HD + 1) + BK * (HD + 1) + BK * HD + BQ * LP);
}

// 16 row groups x 8 column groups of threads.
template <int HD>
__global__ void __launch_bounds__(NT)
flash_kernel(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, float* __restrict__ o, int S,
             int Sk, int causal, float scale) {
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
  const float* qb = q + bh * S * HD;
  const float* kb = k + bh * Sk * HD;
  const float* vb = v + bh * Sk * HD;

  for (int e = tid; e < BQ * HD; e += NT) {
    const int r = e / HD, d = e % HD;
    Qs[r * LD + d] = q0 + r < S ? qb[(size_t)(q0 + r) * HD + d] : 0.f;
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
      Ks[r * LD + d] = ok ? kb[off] : 0.f;
      Vs[r * HD + d] = ok ? vb[off] : 0.f;
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
    float* orow = o + (bh * S + row) * HD;
#pragma unroll
    for (int j = 0; j < DJ; ++j) orow[cg + 8 * j] = acc[i][j] / li;
  }
}

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int BH, int S, int Sk, int causal, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD>();
  // above 48 KB a block may use dynamic shared memory only after opting in
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((S + BQ - 1) / BQ, BH);
  flash_kernel<HD><<<grid, NT, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), S, Sk, causal,
      1.0f / sqrtf((float)HD));
  return cudaGetLastError();
}

}  // namespace f32

// ---------------------------------------------------- bf16 tensor cores
namespace tc {

using bf16 = __nv_bfloat16;

template <int HD>
__host__ __device__ constexpr int ld() { return HD + 8; }  // padded row, elements

template <int HD>
constexpr int smem_bytes() {  // Q, two K and two V tiles
  return (BQ + 4 * BK) * ld<HD>() * (int)sizeof(bf16);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16 bytes global -> shared; bytes past src_bytes are zero-filled.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
// d += a . b on one m16n8k16 tile, bf16 operands, fp32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&p);
}

// rows r0..r0+n-1 of a (rows, HD) matrix into a padded shared tile; rows
// at or past `limit` zero-filled.
template <int HD>
__device__ __forceinline__ void load_tile(bf16* dst,
                                          const bf16* __restrict__ src,
                                          int r0, int n, int limit) {
  constexpr int CH = HD / 8;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < n * CH; i += NT) {
    const int r = i / CH, c = (i % CH) * 8;
    const bool ok = r0 + r < limit;
    cp_async16(dst + r * ld<HD>() + c,
               ok ? src + (size_t)(r0 + r) * HD + c : src, ok ? 16 : 0);
  }
}

template <int HD>
__global__ void __launch_bounds__(NT, 2)
flash_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, bf16* __restrict__ o, int S,
                int Sk, int causal, float scale_log2) {
  constexpr int LD = ld<HD>();
  constexpr int KS = HD / 16;  // k steps of QK^T
  constexpr int DN = HD / 8;   // 8-column tiles of the output
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ks = Qs + BQ * LD;     // two buffers
  bf16* Vs = Ks + 2 * BK * LD; // two buffers

  // bh fastest, query tiles from the last: the causal grid launches its
  // heaviest tiles first across all heads (longest first)
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const size_t bh = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int lq = lane >> 3, lr = lane & 7;  // ldmatrix: quarter, row
  const int w0 = q0 + 16 * warp;            // the warp's first query row
  const bf16* qb = q + bh * S * HD;
  const bf16* kb = k + bh * Sk * HD;
  const bf16* vb = v + bh * Sk * HD;

  int n_kt = (Sk + BK - 1) / BK;
  if (causal) n_kt = min(n_kt, (q0 + BQ - 1) / BK + 1);

  load_tile<HD>(Qs, qb, q0, BQ, S);
  load_tile<HD>(Ks, kb, 0, BK, Sk);
  load_tile<HD>(Vs, vb, 0, BK, Sk);
  cp_async_commit();

  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float acc[DN][4];
#pragma unroll
  for (int dn = 0; dn < DN; ++dn)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[dn][r] = 0.f;

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    if (kt + 1 < n_kt) {
      const int nb = (kt + 1) & 1;
      load_tile<HD>(Ks + nb * BK * LD, kb, k0 + BK, BK, Sk);
      load_tile<HD>(Vs + nb * BK * LD, vb, k0 + BK, BK, Sk);
    }
    cp_async_commit();
    cp_async_wait<1>();  // Q and tile kt landed
    __syncthreads();
    const bf16* ks_ = Ks + (kt & 1) * BK * LD;
    const bf16* vs_ = Vs + (kt & 1) * BK * LD;

    // S = Q K^T: 16 rows x 64 keys per warp. A = Q: quarters (rows lo/hi)
    // x (k lo/hi) of each 16x16 tile; K's (key, hd) rows are the columns
    // of B.
    float s[8][4];
#pragma unroll
    for (int nj = 0; nj < 8; ++nj)
#pragma unroll
      for (int r = 0; r < 4; ++r) s[nj][r] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t a[4];
      ldsm_x4(a, Qs + (16 * warp + lr + ((lq & 1) << 3)) * LD + 16 * ks +
                     ((lq >> 1) << 3));
#pragma unroll
      for (int nj = 0; nj < 8; nj += 2) {
        uint32_t b[4];
        ldsm_x4(b, ks_ + (8 * (nj + (lq >> 1)) + lr) * LD + 16 * ks +
                       ((lq & 1) << 3));
        mma_bf16(s[nj], a, b[0], b[1]);
        mma_bf16(s[nj + 1], a, b[2], b[3]);
      }
    }

    // s[nj][2h + v] is (row w0 + g + 8h, key k0 + 8 nj + 2t + v). Only a
    // tile that holds key padding or crosses this warp's causal diagonal
    // is masked; the scale folds into exp2's argument, and m is kept in
    // scaled base-2 units.
    const bool masked = k0 + BK > Sk || (causal && k0 + BK - 1 > w0);
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int nj = 0; nj < 8; ++nj)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int v = 0; v < 2; ++v) {
          float& x = s[nj][2 * h + v];
          if (masked) {
            const int qpos = w0 + g + 8 * h;
            const int kpos = k0 + 8 * nj + 2 * t + v;
            if (kpos >= Sk || (causal && qpos < kpos)) x = NEG_INF;
          }
          mx[h] = fmaxf(mx[h], x);
        }
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m[h], mx[h] * scale_log2);
      alpha[h] = exp2f(m[h] - m_new);
      m[h] = m_new;
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int nj = 0; nj < 8; ++nj)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int v = 0; v < 2; ++v) {
          float& x = s[nj][2 * h + v];
          x = exp2f(fmaf(x, scale_log2, -m[h]));
          rs[h] += x;
        }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      rs[h] += __shfl_xor_sync(0xffffffffu, rs[h], 1);
      rs[h] += __shfl_xor_sync(0xffffffffu, rs[h], 2);
      l[h] = fmaf(l[h], alpha[h], rs[h]);
    }
#pragma unroll
    for (int dn = 0; dn < DN; ++dn) {
      acc[dn][0] *= alpha[0];
      acc[dn][1] *= alpha[0];
      acc[dn][2] *= alpha[1];
      acc[dn][3] *= alpha[1];
    }

    // O += P V: P's accumulator layout is the A fragment of 16 keys; V's
    // (key, hd) rows, transposed by ldmatrix, are B.
#pragma unroll
    for (int kc = 0; kc < BK / 16; ++kc) {
      const uint32_t a[4] = {pack_bf16(s[2 * kc][0], s[2 * kc][1]),
                             pack_bf16(s[2 * kc][2], s[2 * kc][3]),
                             pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]),
                             pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3])};
#pragma unroll
      for (int dn = 0; dn < DN; dn += 2) {
        uint32_t b[4];
        ldsm_x4_trans(b, vs_ + (16 * kc + lr + ((lq & 1) << 3)) * LD +
                             8 * (dn + (lq >> 1)));
        mma_bf16(acc[dn], a, b[0], b[1]);
        mma_bf16(acc[dn + 1], a, b[2], b[3]);
      }
    }
    __syncthreads();  // this buffer is refilled two tiles on
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = w0 + g + 8 * h;
    if (row >= S) continue;
    const float li = fmaxf(l[h], 1e-30f);
    bf16* orow = o + (bh * S + row) * HD;
#pragma unroll
    for (int dn = 0; dn < DN; ++dn)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * dn + 2 * t) =
          __floats2bfloat162_rn(acc[dn][2 * h] / li, acc[dn][2 * h + 1] / li);
  }
}

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int BH, int S, int Sk, int causal, cudaStream_t stream) {
  constexpr int smem = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_tc_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  dim3 grid(BH, (S + BQ - 1) / BQ);
  // log2(e) / sqrt(hd): the softmax runs in base 2
  flash_tc_kernel<HD><<<grid, NT, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), S, Sk, causal,
      1.4426950408889634f / sqrtf((float)HD));
  return cudaGetLastError();
}

}  // namespace tc

template <bool BF16>
cudaError_t dispatch_hd(const void* q, const void* k, const void* v, void* o,
                        int BH, int S, int Sk, int hd, int causal,
                        cudaStream_t st) {
#define FLASH_CASE(HD)                                                  \
  case HD:                                                              \
    return BF16 ? tc::launch<HD>(q, k, v, o, BH, S, Sk, causal, st)     \
                : f32::launch<HD>(q, k, v, o, BH, S, Sk, causal, st);
  switch (hd) {
    FLASH_CASE(16)
    FLASH_CASE(32)
    FLASH_CASE(64)
    FLASH_CASE(128)
    default: return cudaErrorInvalidValue;
  }
#undef FLASH_CASE
}

}  // namespace

// dtype: 0 float32, 1 bfloat16. Returns the launch's cudaError_t.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, int BH, int S,
                                   int Sk, int hd, int causal, int dtype,
                                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_hd<false>(q, k, v, o, BH, S, Sk, hd, causal, st);
  if (dtype == 1)
    return dispatch_hd<true>(q, k, v, o, BH, S, Sk, hd, causal, st);
  return cudaErrorInvalidValue;
}

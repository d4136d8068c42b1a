// One-token GQA decode attention for Hopper (sm_90a), over a contiguous
// KV cache or through a page table. fp32 inside.
//
// Replaces: src/repro/kernels/decode_attention.py, decode_attention
// (_decode_kernel), and src/repro/kernels/paged_decode_attention.py,
// paged_decode_attention (_paged_decode_kernel). Same contract: q (B, H,
// hd) grouped per KV head (query head h reads KV head h / G, KV is never
// repeated); per-row lengths mask; rows with length 0 give exact zeros;
// the paged form reads K/V through page_table[b, pos / ps] at pos % ps,
// with no gathered copy of the cache.
//
// Bound on the card: bytes. Each step must read the live KV once,
// 2 * sum(len) * KVH * hd * elt bytes, against 4 * sum(len) * H * hd
// FLOPs: far below the ~295 FLOP/byte where bf16 compute would bind.
//
// Design: at engine batch sizes a grid of (B, KVH) blocks cannot fill 132
// SMs, so the sweep is split along the sequence. Pass 1 runs one block per
// (split, kv head, row): it loads the query group once, streams its
// split's positions in shared-memory tiles, and writes an fp32 partial
// (m, l, acc) per query head. Pass 2 merges a row's splits in fixed index
// order. Both forms share the split body, templated on an address functor
// (contiguous (b, pos), or the page table); only the address differs, so
// with page_size == block_s the paged output equals the contiguous output
// bit for bit. Splits at or beyond a row's length do no work, and a row of
// length 0 merges no split and writes 0 / 1e-30 = 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int NT = 128;        // threads of a split block: 4 warps
constexpr int MAXG = 8;        // query heads per KV head (H / KVH)
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// Element offset of (row b, position pos, KV head 0) in a cache.
struct ContiguousAddr {
  int S, row;                  // row = KVH * hd
  __device__ size_t operator()(int b, int pos) const {
    return ((size_t)b * S + pos) * row;
  }
};

struct PagedAddr {
  const int* table;            // (B, n_pt) physical page ids
  int n_pt, ps, row;
  __device__ size_t operator()(int b, int pos) const {
    const int page = table[(size_t)b * n_pt + pos / ps];
    return ((size_t)page * ps + pos % ps) * row;
  }
};

__device__ __forceinline__ int clamp_len(const int* lengths, int b, int cap) {
  const int len = lengths[b];
  return len < 0 ? 0 : (len > cap ? cap : len);
}

// Partial of (row b, kv head h, split s): m[G], l[G], acc[G][HD], fp32.
template <class F>
__device__ __forceinline__ F* partial(F* part, int b, int h, int s, int KVH,
                                      int n_split, int G, int HD) {
  return part + (((size_t)b * KVH + h) * n_split + s) * G * (HD + 2);
}

template <typename T, int HD, class Addr>
__global__ void __launch_bounds__(NT)
split_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const int* __restrict__ lengths,
             Addr addr, float* __restrict__ part, int H, int KVH, int cap,
             int split, int n_split, float scale) {
  constexpr int TILE = HD >= 128 ? 32 : 64;     // keeps smem under 48 KB
  constexpr int NACC = (MAXG * HD + NT - 1) / NT;
  __shared__ float qs[MAXG][HD];
  __shared__ float ks[TILE][HD + 1];
  __shared__ float vs[TILE][HD];
  __shared__ float ps[MAXG][TILE];
  __shared__ float alpha_s[MAXG];
  __shared__ size_t rowoff[TILE];

  const int s_idx = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int G = H / KVH;
  const int len = clamp_len(lengths, b, cap);
  const int start = s_idx * split;
  if (start >= len) return;          // the merge reads only splits < len
  const int end = min(start + split, len);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  for (int e = tid; e < G * HD; e += NT)
    qs[e / HD][e % HD] = to_f32(q[((size_t)b * H + h * G) * HD + e]);

  float acc[NACC];
#pragma unroll
  for (int j = 0; j < NACC; ++j) acc[j] = 0.f;
  float m_r[MAXG / 4], l_r[MAXG / 4];  // warp w keeps rows w and w + 4
#pragma unroll
  for (int r = 0; r < MAXG / 4; ++r) {
    m_r[r] = NEG_INF;
    l_r[r] = 0.f;
  }

  for (int t0 = start; t0 < end; t0 += TILE) {
    const int n = min(TILE, end - t0);
    __syncthreads();  // q staged; previous tile consumed
    if (tid < n) rowoff[tid] = addr(b, t0 + tid) + (size_t)h * HD;
    __syncthreads();
    for (int e = tid; e < n * HD; e += NT) {
      const int i = e / HD, d = e % HD;
      ks[i][d] = to_f32(k[rowoff[i] + d]);
      vs[i][d] = to_f32(v[rowoff[i] + d]);
    }
    __syncthreads();
    for (int e = tid; e < G * n; e += NT) {
      const int g = e / n, i = e % n;
      float dot = 0.f;
#pragma unroll 8
      for (int d = 0; d < HD; ++d) dot = fmaf(qs[g][d], ks[i][d], dot);
      ps[g][i] = dot * scale;
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < MAXG / 4; ++r) {
      const int g = warp + 4 * r;
      if (g >= G) continue;
      float mx = NEG_INF;
      for (int i = lane; i < n; i += 32) mx = fmaxf(mx, ps[g][i]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m_r[r], mx);
      const float alpha = expf(m_r[r] - m_new);
      float sum = 0.f;
      for (int i = lane; i < n; i += 32) {
        const float p = expf(ps[g][i] - m_new);
        ps[g][i] = p;
        sum += p;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      l_r[r] = fmaf(l_r[r], alpha, sum);
      m_r[r] = m_new;
      if (lane == 0) alpha_s[g] = alpha;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < NACC; ++j) {
      const int e = tid + j * NT;
      if (e >= G * HD) break;
      const int g = e / HD, d = e % HD;
      float a = acc[j] * alpha_s[g];
      for (int i = 0; i < n; ++i) a = fmaf(ps[g][i], vs[i][d], a);
      acc[j] = a;
    }
  }

  float* out = partial(part, b, h, s_idx, KVH, n_split, G, HD);
#pragma unroll
  for (int r = 0; r < MAXG / 4; ++r) {
    const int g = warp + 4 * r;
    if (g < G && lane == 0) {
      out[g] = m_r[r];
      out[G + g] = l_r[r];
    }
  }
#pragma unroll
  for (int j = 0; j < NACC; ++j) {
    const int e = tid + j * NT;
    if (e < G * HD) out[2 * G + e] = acc[j];
  }
}

// One block per (query head, row), one thread per output column.
template <typename T, int HD>
__global__ void __launch_bounds__(HD)
merge_kernel(const float* __restrict__ part, const int* __restrict__ lengths,
             T* __restrict__ o, int H, int KVH, int cap, int split,
             int n_split) {
  const int hq = blockIdx.x, b = blockIdx.y, d = threadIdx.x;
  const int G = H / KVH, h = hq / G, g = hq % G;
  const int len = clamp_len(lengths, b, cap);
  const int ns = (len + split - 1) / split;
  float m = NEG_INF;
  for (int s = 0; s < ns; ++s)
    m = fmaxf(m, partial(part, b, h, s, KVH, n_split, G, HD)[g]);
  float l = 0.f, acc = 0.f;
  for (int s = 0; s < ns; ++s) {
    const float* p = partial(part, b, h, s, KVH, n_split, G, HD);
    const float w = expf(p[g] - m);
    l = fmaf(p[G + g], w, l);
    acc = fmaf(p[2 * G + g * HD + d], w, acc);
  }
  store(o + ((size_t)b * H + hq) * HD + d, acc / fmaxf(l, 1e-30f));
}

template <typename T, int HD, class Addr>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* lengths, Addr addr, void* o, float* part,
                   int B, int H, int KVH, int cap, int split,
                   cudaStream_t stream) {
  const int n_split = (cap + split - 1) / split;
  split_kernel<T, HD, Addr><<<dim3(n_split, KVH, B), NT, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lengths, addr, part, H, KVH, cap, split,
      n_split, 1.0f / sqrtf((float)HD));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  merge_kernel<T, HD><<<dim3(H, B), HD, 0, stream>>>(
      part, lengths, static_cast<T*>(o), H, KVH, cap, split, n_split);
  return cudaGetLastError();
}

template <class Addr>
cudaError_t dispatch(const void* q, const void* k, const void* v,
                     const int* lengths, Addr addr, void* o, void* part,
                     int B, int H, int KVH, int hd, int cap, int split,
                     int dtype, cudaStream_t st) {
  float* p = static_cast<float*>(part);
#define DECODE_CASE(T, HD)                                                   \
  return launch<T, HD, Addr>(q, k, v, lengths, addr, o, p, B, H, KVH, cap,  \
                             split, st)
  if (dtype == 0) {
    switch (hd) {
      case 16: DECODE_CASE(float, 16);
      case 32: DECODE_CASE(float, 32);
      case 64: DECODE_CASE(float, 64);
      case 128: DECODE_CASE(float, 128);
    }
  } else if (dtype == 1) {
    switch (hd) {
      case 16: DECODE_CASE(__nv_bfloat16, 16);
      case 32: DECODE_CASE(__nv_bfloat16, 32);
      case 64: DECODE_CASE(__nv_bfloat16, 64);
      case 128: DECODE_CASE(__nv_bfloat16, 128);
    }
  }
#undef DECODE_CASE
  return cudaErrorInvalidValue;
}

}  // namespace

// part: fp32 scratch of B * KVH * ceil(S / block_s) * G * (hd + 2) floats.
// dtype: 0 float32, 1 bfloat16. Returns the launches' cudaError_t.
extern "C" int decode_attention_fwd(const void* q, const void* k_cache,
                                    const void* v_cache, const int* lengths,
                                    void* o, void* part, int B, int H,
                                    int KVH, int hd, int S, int block_s,
                                    int dtype, void* stream) {
  ContiguousAddr addr{S, KVH * hd};
  return dispatch(q, k_cache, v_cache, lengths, addr, o, part, B, H, KVH, hd,
                  S, block_s, dtype, static_cast<cudaStream_t>(stream));
}

// One split per page: part holds B * KVH * n_pt * G * (hd + 2) floats.
extern "C" int paged_decode_attention_fwd(
    const void* q, const void* k_pages, const void* v_pages,
    const int* page_table, const int* lengths, void* o, void* part, int B,
    int H, int KVH, int hd, int page_size, int n_pt, int dtype,
    void* stream) {
  PagedAddr addr{page_table, n_pt, page_size, KVH * hd};
  return dispatch(q, k_pages, v_pages, lengths, addr, o, part, B, H, KVH, hd,
                  n_pt * page_size, page_size, dtype,
                  static_cast<cudaStream_t>(stream));
}

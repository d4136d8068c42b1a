// One-token GQA decode attention for Hopper (sm_90a), over a contiguous
// KV cache or through a page table. fp32 inside.
//
// Replaces: src/repro/kernels/decode_attention.py, decode_attention
// (_decode_kernel), and src/repro/kernels/paged_decode_attention.py,
// paged_decode_attention (_paged_decode_kernel). Same contract: q (B, H,
// hd) grouped per KV head (query head h reads KV head h / G, G <= 8, KV is
// never repeated); hd 16/32/64/128, fp32 or bf16; per-row lengths clamped
// to [0, cap]; rows with length 0 give exact zeros; the paged form reads
// K/V through page_table[b, pos / ps] at pos % ps, with no gathered copy
// of the cache.
//
// Bound on the card: bytes. Each step must read the live KV once,
// 2 * sum(len) * KVH * hd * elt bytes, against 4 * sum(len) * H * hd
// FLOPs: far below the ~295 FLOP/byte where bf16 compute would bind. So
// the design is about keeping enough bytes in flight, with one launch.
//
// Design: one 128-thread block per (split, kv head, row), splits of
// `split` positions along the sequence (at engine batch sizes a grid of
// (B, KVH) blocks cannot fill 132 SMs). Both forms share the split body,
// templated on an address functor that places a split's first position
// (contiguous (b, start), or one page-table read per split); the
// contiguous form splits at block_s exactly as the paged form splits at
// pages, so with page_size == block_s the paged output equals the
// contiguous output bit for bit.
// - Loads: each K or V row is read as 16-byte vectors, LPR = hd * elt / 16
//   neighbouring lanes to a row (8 lanes at hd 64 in bf16), converted to
//   fp32 in registers; no shared-memory staging. A lane group (a "slot")
//   issues U = 2 rows of K and V before it uses any, so four 16-byte loads
//   per lane are in flight: with more, the registers they take leave fewer
//   blocks on an SM, and 4 or 8 rows measured slower at G 1 and G 7.
// - Work per thread: each lane holds its hd / LPR columns of all G query
//   vectors of the KV head (pre-scaled by log2(e) / sqrt(hd)), so a K row
//   is loaded once and dotted with every query; the dot finishes with
//   xor-shuffles across the row's lanes. Each slot keeps its own online
//   softmax (m, l, acc) in registers, in base 2.
// - Combine: slots of a warp merge by xor-shuffles, warps through shared
//   memory in warp order: one cross-warp step per split.
// - Merge, in the same launch: a row of one split writes its output
//   directly. With more splits, each block writes an fp32 partial (m, l,
//   acc), fences, and takes a ticket from the (row, KV head) counter; the
//   last block to arrive merges the row's splits in split-index order and
//   resets the counter to 0 for the next launch. Which block is last does
//   not change a bit of the result.
// - Splits at or beyond a row's length return at once; a row of length 0
//   has its output zeroed by split 0.
// Every position, slot, warp and split is combined in a fixed order, so
// the same inputs give the same bits on every run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NW = 4;          // warps of a split block
constexpr int NT = 32 * NW;
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// 16 bytes of a row: one vector load when `vec`, else element by element.
__device__ __forceinline__ uint4 load16(const float* p, bool vec) {
  if (vec) return __ldg(reinterpret_cast<const uint4*>(p));
  return make_uint4(__float_as_uint(p[0]), __float_as_uint(p[1]),
                    __float_as_uint(p[2]), __float_as_uint(p[3]));
}
__device__ __forceinline__ uint4 load16(const __nv_bfloat16* p, bool vec) {
  if (vec) return __ldg(reinterpret_cast<const uint4*>(p));
  const unsigned short* s = reinterpret_cast<const unsigned short*>(p);
  return make_uint4(s[0] | (uint32_t)s[1] << 16, s[2] | (uint32_t)s[3] << 16,
                    s[4] | (uint32_t)s[5] << 16, s[6] | (uint32_t)s[7] << 16);
}

// The 16 bytes as fp32: 4 floats, or 8 bf16 widened exactly.
__device__ __forceinline__ void widen(const uint4& r, float (&f)[4]) {
  f[0] = __uint_as_float(r.x);
  f[1] = __uint_as_float(r.y);
  f[2] = __uint_as_float(r.z);
  f[3] = __uint_as_float(r.w);
}
__device__ __forceinline__ void widen(const uint4& r, float (&f)[8]) {
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// Element offset of (row b, position `start`, KV head 0) in a cache, for
// the first position of a split; the split's positions follow it every
// `row` = KVH * hd elements in both layouts.
struct ContiguousAddr {
  int S, row;
  __device__ size_t operator()(int b, int start) const {
    return ((size_t)b * S + start) * row;
  }
};

struct PagedAddr {             // a split is one page: start % ps == 0
  const int* table;            // (B, n_pt) physical page ids
  int n_pt, ps, row;
  __device__ size_t operator()(int b, int start) const {
    return (size_t)table[(size_t)b * n_pt + start / ps] * ps * row;
  }
};

__device__ __forceinline__ int clamp_len(const int* lengths, int b, int cap) {
  const int len = lengths[b];
  return len < 0 ? 0 : (len > cap ? cap : len);
}

// Merge (m, l) pair b into a, both in base 2; returns a's and b's weights.
__device__ __forceinline__ float2 rescale(float& m, float mb) {
  const float mn = fmaxf(m, mb);
  const float2 w = make_float2(exp2f(m - mn), exp2f(mb - mn));
  m = mn;
  return w;
}

// GB: G rounded up to 1, 2, 4 or 8 (the query vectors a lane holds).
template <typename T, int HD, int GB, class Addr>
__global__ void __launch_bounds__(NT)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const int* __restrict__ lengths,
              Addr addr, T* __restrict__ o, float* __restrict__ part,
              unsigned* __restrict__ count, int H, int KVH, int cap,
              int split, int n_split, float qscale, int vec) {
  constexpr int VE = 16 / sizeof(T);     // elements in 16 bytes
  constexpr int LPR = HD / VE;           // lanes per K/V row
  constexpr int RPW = 32 / LPR;          // rows a warp loads at once
  constexpr int NSLOT = NW * RPW;        // row slots of the block
  constexpr int U = 2;                   // rows in flight per slot
  __shared__ float red[NW][GB][HD + 2];  // per warp: acc[HD], m, l
  __shared__ int is_last;

  const int s_idx = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int G = H / KVH;
  const int len = clamp_len(lengths, b, cap);
  const int start = s_idx * split;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  T* ob = o + ((size_t)b * H + (size_t)h * G) * HD;
  if (start >= len) {              // no work; a row of length 0 is zero
    if (s_idx == 0)
      for (int e = tid; e < G * HD; e += NT) store(ob + e, 0.f);
    return;
  }
  const int end = min(start + split, len);
  const int ns = (len + split - 1) / split;
  const int slot = warp * RPW + lane / LPR;
  const int c0 = (lane % LPR) * VE;      // this lane's first column

  float qv[GB][VE];
#pragma unroll
  for (int g = 0; g < GB; ++g) {
    if (g < G) {
      widen(load16(q + ((size_t)b * H + h * G + g) * HD + c0, vec), qv[g]);
#pragma unroll
      for (int c = 0; c < VE; ++c) qv[g][c] *= qscale;
    } else {
#pragma unroll
      for (int c = 0; c < VE; ++c) qv[g][c] = 0.f;
    }
  }
  float m[GB], l[GB], acc[GB][VE];
#pragma unroll
  for (int g = 0; g < GB; ++g) {
    m[g] = NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int c = 0; c < VE; ++c) acc[g][c] = 0.f;
  }

  const T* kb = k + addr(b, start) + (size_t)h * HD + c0;
  const T* vb = v + (kb - k);
  // warp-uniform trip count: the shuffles need every lane
  for (int base = start; base < end; base += U * NSLOT) {
    uint4 kr[U], vr[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int pos = base + u * NSLOT + slot;
      if (pos < end) {
        const size_t off = (size_t)(pos - start) * addr.row;
        kr[u] = load16(kb + off, vec);
        vr[u] = load16(vb + off, vec);
      } else {
        kr[u] = vr[u] = make_uint4(0, 0, 0, 0);
      }
    }
    float s[U][GB];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float kf[VE];
      widen(kr[u], kf);
#pragma unroll
      for (int g = 0; g < GB; ++g) {
        float d = 0.f;
#pragma unroll
        for (int c = 0; c < VE; ++c) d = fmaf(qv[g][c], kf[c], d);
#pragma unroll
        for (int o2 = LPR / 2; o2 > 0; o2 >>= 1)
          d += __shfl_xor_sync(0xffffffffu, d, o2);
        s[u][g] = base + u * NSLOT + slot < end ? d : NEG_INF;
      }
    }
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      float mx = s[0][g];
#pragma unroll
      for (int u = 1; u < U; ++u) mx = fmaxf(mx, s[u][g]);
      const float alpha = rescale(m[g], mx).x;
      float p[U], sum = 0.f;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        p[u] = base + u * NSLOT + slot < end ? exp2f(s[u][g] - m[g]) : 0.f;
        sum += p[u];
      }
      l[g] = fmaf(l[g], alpha, sum);
#pragma unroll
      for (int c = 0; c < VE; ++c) acc[g][c] *= alpha;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float vf[VE];
        widen(vr[u], vf);
#pragma unroll
        for (int c = 0; c < VE; ++c) acc[g][c] = fmaf(p[u], vf[c], acc[g][c]);
      }
    }
  }

  // slots of a warp: xor-shuffle butterfly over the slot bits of the lane
#pragma unroll
  for (int o2 = LPR; o2 < 32; o2 <<= 1) {
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[g], o2);
      const float lo = __shfl_xor_sync(0xffffffffu, l[g], o2);
      const float2 w = rescale(m[g], mo);
      l[g] = l[g] * w.x + lo * w.y;
#pragma unroll
      for (int c = 0; c < VE; ++c) {
        const float ao = __shfl_xor_sync(0xffffffffu, acc[g][c], o2);
        acc[g][c] = acc[g][c] * w.x + ao * w.y;
      }
    }
  }
  if (lane < LPR) {
#pragma unroll
    for (int g = 0; g < GB; ++g) {
#pragma unroll
      for (int c = 0; c < VE; ++c) red[warp][g][c0 + c] = acc[g][c];
      if (lane == 0) {
        red[warp][g][HD] = m[g];
        red[warp][g][HD + 1] = l[g];
      }
    }
  }
  __syncthreads();

  // warps in order: this split's (m, l, acc) per query head
  float* pp = part + (((size_t)b * KVH + h) * n_split + s_idx) * G * (HD + 2);
  for (int e = tid; e < G * HD; e += NT) {
    const int g = e / HD, c = e % HD;
    float mm = red[0][g][HD], ll = red[0][g][HD + 1], aa = red[0][g][c];
#pragma unroll
    for (int w = 1; w < NW; ++w) {
      const float2 wt = rescale(mm, red[w][g][HD]);
      ll = ll * wt.x + red[w][g][HD + 1] * wt.y;
      aa = aa * wt.x + red[w][g][c] * wt.y;
    }
    if (ns == 1) {
      store(ob + e, aa / fmaxf(ll, 1e-30f));
    } else {
      pp[2 * G + e] = aa;
      if (c == 0) {
        pp[g] = mm;
        pp[G + g] = ll;
      }
    }
  }
  if (ns == 1) return;

  // the last split block of this (row, KV head) merges the partials
  __threadfence();
  __syncthreads();
  unsigned* cnt = count + (size_t)b * KVH + h;
  if (tid == 0) is_last = atomicAdd(cnt, 1u) == (unsigned)(ns - 1);
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  const float* p0 = part + ((size_t)b * KVH + h) * n_split * G * (HD + 2);
  for (int e = tid; e < G * HD; e += NT) {
    const int g = e / HD;
    float mm = NEG_INF, ll = 0.f, aa = 0.f;
    for (int si = 0; si < ns; ++si) {
      const float* ps = p0 + (size_t)si * G * (HD + 2);
      const float2 wt = rescale(mm, __ldcg(ps + g));
      ll = ll * wt.x + __ldcg(ps + G + g) * wt.y;
      aa = aa * wt.x + __ldcg(ps + 2 * G + e) * wt.y;
    }
    store(ob + e, aa / fmaxf(ll, 1e-30f));
  }
  if (tid == 0) *cnt = 0u;         // ready for the next launch
}

template <typename T, int HD, int GB, class Addr>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* lengths, Addr addr, void* o, float* part,
                   unsigned* count, int B, int H, int KVH, int cap, int split,
                   int vec, cudaStream_t stream) {
  const int n_split = (cap + split - 1) / split;
  decode_kernel<T, HD, GB, Addr><<<dim3(n_split, KVH, B), NT, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lengths, addr, static_cast<T*>(o), part,
      count, H, KVH, cap, split, n_split, LOG2E / sqrtf((float)HD), vec);
  return cudaGetLastError();
}

template <typename T, int HD, class Addr>
cudaError_t dispatch_g(const void* q, const void* k, const void* v,
                       const int* lengths, Addr addr, void* o, float* part,
                       unsigned* count, int B, int H, int KVH, int cap,
                       int split, int vec, cudaStream_t st) {
  const int G = H / KVH;
#define DECODE_G(GB)                                                       \
  if (G <= GB)                                                             \
  return launch<T, HD, GB, Addr>(q, k, v, lengths, addr, o, part, count, B, \
                                 H, KVH, cap, split, vec, st)
  DECODE_G(1);
  DECODE_G(2);
  DECODE_G(4);
  DECODE_G(8);
#undef DECODE_G
  return cudaErrorInvalidValue;
}

template <class Addr>
cudaError_t dispatch(const void* q, const void* k, const void* v,
                     const int* lengths, Addr addr, void* o, void* part,
                     void* count, int B, int H, int KVH, int hd, int cap,
                     int split, int dtype, cudaStream_t st) {
  if (KVH < 1 || H % KVH || H / KVH > 8 || split < 1)
    return cudaErrorInvalidValue;
  float* p = static_cast<float*>(part);
  unsigned* c = static_cast<unsigned*>(count);
  const int vec = ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v) % 16 == 0;
#define DECODE_CASE(T, HD)                                                  \
  return dispatch_g<T, HD, Addr>(q, k, v, lengths, addr, o, p, c, B, H, KVH, \
                                 cap, split, vec, st)
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

// part: fp32 scratch of B * KVH * ceil(S / block_s) * G * (hd + 2) floats;
// count: B * KVH uint32 counters, zero before the launch and zero after it
// (the merging block resets its own). dtype: 0 float32, 1 bfloat16.
// Returns the launch's cudaError_t.
extern "C" int decode_attention_fwd(const void* q, const void* k_cache,
                                    const void* v_cache, const int* lengths,
                                    void* o, void* part, void* count, int B,
                                    int H, int KVH, int hd, int S,
                                    int block_s, int dtype, void* stream) {
  ContiguousAddr addr{S, KVH * hd};
  return dispatch(q, k_cache, v_cache, lengths, addr, o, part, count, B, H,
                  KVH, hd, S, block_s, dtype,
                  static_cast<cudaStream_t>(stream));
}

// One split per page: part holds B * KVH * n_pt * G * (hd + 2) floats.
extern "C" int paged_decode_attention_fwd(
    const void* q, const void* k_pages, const void* v_pages,
    const int* page_table, const int* lengths, void* o, void* part,
    void* count, int B, int H, int KVH, int hd, int page_size, int n_pt,
    int dtype, void* stream) {
  PagedAddr addr{page_table, n_pt, page_size, KVH * hd};
  return dispatch(q, k_pages, v_pages, lengths, addr, o, part, count, B, H,
                  KVH, hd, n_pt * page_size, page_size, dtype,
                  static_cast<cudaStream_t>(stream));
}

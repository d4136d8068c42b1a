// Grouped expert GEMM for Hopper (sm_90a): out[e] = x[e] @ w[e] for every
// expert e, fp32 accumulation, output in x's dtype.
//
// Replaces: src/repro/kernels/moe_gmm.py, moe_gmm (_gmm_kernel). Same
// contract: x (E, C, d) capacity-dispatched tokens, w (E, d, f) expert
// weights, out (E, C, f). Unlike the Pallas kernel's block specs, no dim
// has to be a tile multiple: every edge is zero-filled or masked (C is 1
// at a decode step, and the tests use ragged d and f).
//
// counts (E,) int32, or null for "every row filled": expert e's filled
// slots are the prefix 0..counts[e]-1 of its C rows (models/moe.py's
// dispatch numbers them in order). Output rows at or past the count are
// exact zero, whatever x holds there. The function is the Pallas
// kernel's: the model zeroes those rows of x, so their product is zero.
//
// Bound on the card: bytes. A call must read the weights of every expert
// it multiplies, once, against 2 * C FLOP per weight element: at most 30
// FLOP per byte on the served paths, far below the ~295 where the bf16
// tensor cores would bind. At a decode step (arctic: 8 rows, top-2, so at
// most 16 of 128 experts hold a row) only the non-empty experts' weights
// need to move: 1.1 of the 8.9 GB. On the card this design reaches about
// 80-90 % of that bound at every C of arctic's path (PERF.md), a few
// points below torch.bmm's dense stream: what is left is the cp.async
// copy path itself. A deeper ring, wider f tiles and a ring kept full
// across work items did not move it; TMA bulk copies are the next step.
//
// bf16 design (every C, the served path):
// - The roles swap: out^T[f, C] = w^T[f, d] . x^T[d, C], so f is the
//   16-row M side of mma.sync.m16n8k16 and C, padded to 8, 16 or 32, the
//   N side: a decode step pads one row to eight, not to 64.
// - mma.sync, not wgmma: at 30 FLOP per byte the product needs ~100
//   TFLOP/s to keep pace with HBM, well inside mma.sync's rate, and a
//   warp-level fragment lets each tile mask its own ragged edge.
//   ldmatrix.trans reads w^T straight from w's (d, f) rows.
// - Weight tiles (64 d x 128 f, 16 KB) and the x tile beside them stream
//   through a 4-stage cp.async ring of 16-byte copies; with 2-3 blocks
//   per SM that keeps ~100-150 KB in flight per SM. x streams with the
//   weights because a whole 32 x 7168 x tile (458 KB) would not fit in
//   shared memory. Padded shared rows make every ldmatrix free of bank
//   conflicts.
// - A persistent grid (SMs x resident blocks) walks the work items
//   (expert, C tile, d range, f tile), f tile fastest. An item whose
//   expert has no filled row in its C tile reads no weight and costs a
//   few instructions (with one d range it writes its zero tile).
// - When C is small, each product splits over d (the caller's `splits`;
//   kernels/moe_gmm.py picks it by C from measured times): at a decode
//   step only ~16 experts are live, too few items to fill the card. Each
//   range writes fp32 partials; a second pass sums them in range order
//   (no float atomics, so runs repeat bit for bit) and writes the zeros
//   of the empty rows.
// - Shapes whose d or f is not a multiple of 8 (tests only) take the same
//   kernel with element-wise loads (`vec` 0).
//
// fp32 design (kept from the first version: exact fp32 products on CUDA
// cores, no TF32): one 128-thread block per (256-column f tile, C tile,
// expert); thread t owns columns f0 + 2t, f0 + 2t + 1, so a warp's weight
// load is one coalesced 256-byte row segment; x staged in shared memory as
// fp32, 256 d at a time; the C tile is 1-32 rows.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// Filled rows of expert e: counts[e] clamped to [0, C], or C without counts.
__device__ __forceinline__ int filled(const int* counts, int e, int C) {
  return counts ? min(max(__ldg(counts + e), 0), C) : C;
}

// ------------------------------------------------------------------ fp32
namespace f32 {

constexpr int NT = 128;       // threads per block
constexpr int BF = 2 * NT;    // output columns per block (two per thread)
constexpr int BD = 256;       // d of x staged per pass
constexpr int U = 8;          // weight rows in flight per thread

// Columns j and j + 1 of one weight row; zero past f. ``vec``: f is even,
// so j (always even) and the row start are aligned for one paired load.
__device__ __forceinline__ float2 load_pair(const float* row, int j, int f,
                                            bool vec) {
  if (vec && j < f) return *reinterpret_cast<const float2*>(row + j);
  return make_float2(j < f ? row[j] : 0.f, j + 1 < f ? row[j + 1] : 0.f);
}

template <int BC>
__global__ void __launch_bounds__(NT)
gmm_kernel(const float* __restrict__ x, const float* __restrict__ w,
           const int* __restrict__ counts, float* __restrict__ out, int C,
           int d, int f) {
  __shared__ __align__(16) float xs[BC * BD];
  const int e = blockIdx.z;
  const int c0 = blockIdx.y * BC;
  const int j = blockIdx.x * BF + 2 * threadIdx.x;
  const int rows = min(BC, C - c0);
  const int live = min(rows, max(0, filled(counts, e, C) - c0));
  const bool vec = (f & 1) == 0;
  float* oe = out + ((size_t)e * C + c0) * f;
  if (live == 0) {  // no filled row: zeros, and no weight read
    for (int r = 0; r < rows; ++r) {
      if (j < f) oe[(size_t)r * f + j] = 0.f;
      if (j + 1 < f) oe[(size_t)r * f + j + 1] = 0.f;
    }
    return;
  }
  const float* xe = x + ((size_t)e * C + c0) * d;
  const float* we = w + (size_t)e * d * f;

  float acc[BC][2];
#pragma unroll
  for (int r = 0; r < BC; ++r) acc[r][0] = acc[r][1] = 0.f;

  for (int d0 = 0; d0 < d; d0 += BD) {
    const int nd = min(BD, d - d0);
    __syncthreads();  // the previous chunk's xs consumed
    for (int i = threadIdx.x; i < BC * BD; i += NT) {
      const int r = i / BD, k = i % BD;
      xs[i] = r < live && k < nd ? xe[(size_t)r * d + d0 + k] : 0.f;
    }
    __syncthreads();
    const float* wr = we + (size_t)d0 * f;
    int k = 0;
    for (; k + U <= nd; k += U) {
      float2 wv[U];
#pragma unroll
      for (int u = 0; u < U; ++u)
        wv[u] = load_pair(wr + (size_t)(k + u) * f, j, f, vec);
#pragma unroll
      for (int r = 0; r < BC; ++r) {
        const float4 a = *reinterpret_cast<const float4*>(&xs[r * BD + k]);
        const float4 b =
            *reinterpret_cast<const float4*>(&xs[r * BD + k + 4]);
        const float xv[U] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
        for (int u = 0; u < U; ++u) {
          acc[r][0] = fmaf(xv[u], wv[u].x, acc[r][0]);
          acc[r][1] = fmaf(xv[u], wv[u].y, acc[r][1]);
        }
      }
    }
    for (; k < nd; ++k) {  // ragged d
      const float2 wv = load_pair(wr + (size_t)k * f, j, f, vec);
#pragma unroll
      for (int r = 0; r < BC; ++r) {
        acc[r][0] = fmaf(xs[r * BD + k], wv.x, acc[r][0]);
        acc[r][1] = fmaf(xs[r * BD + k], wv.y, acc[r][1]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < BC; ++r) {
    if (r >= rows) break;
    float* orow = oe + (size_t)r * f;
    if (j < f) orow[j] = r < live ? acc[r][0] : 0.f;
    if (j + 1 < f) orow[j + 1] = r < live ? acc[r][1] : 0.f;
  }
}

template <int BC>
cudaError_t launch(const void* x, const void* w, const int* counts, void* out,
                   int E, int C, int d, int f, cudaStream_t stream) {
  const int c_tiles = (C + BC - 1) / BC;
  if (c_tiles > 65535 || E > 65535) return cudaErrorInvalidConfiguration;
  dim3 grid((f + BF - 1) / BF, c_tiles, E);
  gmm_kernel<BC><<<grid, NT, 0, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w), counts,
      static_cast<float*>(out), C, d, f);
  return cudaGetLastError();
}

// The C tile: 1, 2, 4, 8, 16 or 32 rows (several tiles past 32).
cudaError_t dispatch_c(const void* x, const void* w, const int* counts,
                       void* out, int E, int C, int d, int f, int c_tile,
                       cudaStream_t stream) {
  switch (c_tile) {
    case 1: return launch<1>(x, w, counts, out, E, C, d, f, stream);
    case 2: return launch<2>(x, w, counts, out, E, C, d, f, stream);
    case 4: return launch<4>(x, w, counts, out, E, C, d, f, stream);
    case 8: return launch<8>(x, w, counts, out, E, C, d, f, stream);
    case 16: return launch<16>(x, w, counts, out, E, C, d, f, stream);
    case 32: return launch<32>(x, w, counts, out, E, C, d, f, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace f32

// ---------------------------------------------------- bf16 tensor cores
namespace tc {

using bf16 = __nv_bfloat16;

constexpr int NT = 128;          // 4 warps, each 32 f rows of out^T
constexpr int BM = 128;          // f columns per work item
constexpr int BK = 64;           // d per pipeline stage
constexpr int STAGES = 4;
constexpr int LDW = BM + 8;      // padded shared row of a weight tile
constexpr int LDX = BK + 8;      // padded shared row of an x tile

template <int BN>
constexpr int smem_bytes() {
  return STAGES * (BK * LDW + BN * LDX) * (int)sizeof(bf16);
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

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
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

// One stage: weight rows k0..k0+BK-1 (cols f0..f0+BM-1) and the same d of
// the item's `live` x rows; everything past d's range, f or `live` zero.
template <int BN, bool VEC>
__device__ __forceinline__ void load_stage(bf16* ws, bf16* xs,
                                           const bf16* __restrict__ we,
                                           const bf16* __restrict__ xe,
                                           int k0, int k_end, int f0, int f,
                                           int d, int live) {
  if (VEC) {
    for (int i = threadIdx.x; i < BK * BM / 8; i += NT) {
      const int r = i / (BM / 8), c = (i % (BM / 8)) * 8;
      const int k = k0 + r, j = f0 + c;
      const bool ok = k < k_end && j < f;
      cp_async16(ws + r * LDW + c, ok ? we + (size_t)k * f + j : we,
                 ok ? 16 : 0);
    }
    for (int i = threadIdx.x; i < BN * BK / 8; i += NT) {
      const int r = i / (BK / 8), c = (i % (BK / 8)) * 8;
      const int k = k0 + c;
      const bool ok = r < live && k < k_end;
      cp_async16(xs + r * LDX + c, ok ? xe + (size_t)r * d + k : xe,
                 ok ? 16 : 0);
    }
  } else {
    const bf16 zero = __float2bfloat16(0.f);
    for (int i = threadIdx.x; i < BK * BM; i += NT) {
      const int r = i / BM, c = i % BM;
      const int k = k0 + r, j = f0 + c;
      ws[r * LDW + c] = k < k_end && j < f ? we[(size_t)k * f + j] : zero;
    }
    for (int i = threadIdx.x; i < BN * BK; i += NT) {
      const int r = i / BK, c = i % BK;
      const int k = k0 + c;
      xs[r * LDX + c] = r < live && k < k_end ? xe[(size_t)r * d + k] : zero;
    }
  }
}

// Work item (e, C tile, d range s, f tile ft), ft fastest. x and w are
// read only for items whose C tile holds a filled row. splits == 1 writes
// out (zeros past the count); splits > 1 writes the filled rows' fp32
// partials, part[s][e][c][j], for gmm_reduce.
template <int BN, bool VEC>
__global__ void __launch_bounds__(NT)
gmm_tc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
              const int* __restrict__ counts, float* __restrict__ part,
              bf16* __restrict__ out, int E, int C, int d, int f,
              int splits) {
  constexpr int NTILE = BN / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ws = reinterpret_cast<bf16*>(smem_raw);
  bf16* Xs = Ws + STAGES * BK * LDW;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int CT = (C + BN - 1) / BN, FT = (f + BM - 1) / BM;
  const int n_kt = (d + BK - 1) / BK;
  const int n_items = E * CT * splits * FT;  // < 2^31, checked at launch

  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
    const int ft = item % FT;
    int rest = item / FT;
    const int s = rest % splits;
    rest /= splits;
    const int ct = rest % CT;
    const int e = rest / CT;
    const int c0 = ct * BN, f0 = ft * BM;
    const int rows = min(BN, C - c0);
    const int live = min(rows, max(0, filled(counts, e, C) - c0));
    if (live == 0) {
      if (splits == 1) {
        bf16* oe = out + ((size_t)e * C + c0) * f;
        const bf16 zero = __float2bfloat16(0.f);
        for (int i = threadIdx.x; i < rows * BM; i += NT) {
          const int j = f0 + i % BM;
          if (j < f) oe[(size_t)(i / BM) * f + j] = zero;
        }
      }
      continue;  // uniform over the block: no barrier is skipped by a part
    }
    const int kt0 = (int)((long long)s * n_kt / splits);
    const int kt1 = (int)((long long)(s + 1) * n_kt / splits);
    const int nk = kt1 - kt0;
    const int k_end = min(kt1 * BK, d);
    const bf16* we = w + (size_t)e * d * f;
    const bf16* xe = x + ((size_t)e * C + c0) * d;

    float acc[2][NTILE][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < NTILE; ++ni)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[mi][ni][r] = 0.f;

#pragma unroll
    for (int st = 0; st < STAGES - 1; ++st) {
      if (st < nk)
        load_stage<BN, VEC>(Ws + st * BK * LDW, Xs + st * BN * LDX, we, xe,
                            (kt0 + st) * BK, k_end, f0, f, d, live);
      cp_async_commit();
    }
    for (int kt = 0; kt < nk; ++kt) {
      cp_async_wait<STAGES - 2>();  // stage kt landed
      __syncthreads();              // ... for all threads; kt - 1 consumed
      const int nxt = kt + STAGES - 1;
      if (nxt < nk) {
        const int slot = nxt % STAGES;
        load_stage<BN, VEC>(Ws + slot * BK * LDW, Xs + slot * BN * LDX, we,
                            xe, (kt0 + nxt) * BK, k_end, f0, f, d, live);
      }
      cp_async_commit();
      const bf16* ws = Ws + (kt % STAGES) * BK * LDW;
      const bf16* xs = Xs + (kt % STAGES) * BN * LDX;
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        // A = w^T (f x d): the four 8x8 quarters (k lo/hi x m lo/hi) of
        // each 16x16 tile, transposed out of w's (d, f) rows.
        uint32_t a[2][4];
        const int q = lane >> 3, r = lane & 7;
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
          ldsm_x4_trans(a[mi], ws + (kk + r + ((q >> 1) << 3)) * LDW +
                                   32 * warp + 16 * mi + ((q & 1) << 3));
        // B = x^T (d x C): x's (C, d) rows are B's columns.
#pragma unroll
        for (int ni = 0; ni < NTILE; ++ni) {
          uint32_t b[2];
          ldsm_x2(b, xs + (8 * ni + r) * LDX + kk + ((q & 1) << 3));
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) mma_bf16(acc[mi][ni], a[mi], b[0], b[1]);
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();  // every slot consumed before the next item's loads

    // acc[mi][ni][2h + v] is out^T[m][n]: m = 32 warp + 16 mi + g + 8 h,
    // n = 8 ni + 2 t + v.
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < NTILE; ++ni)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int v = 0; v < 2; ++v) {
            const int j = f0 + 32 * warp + 16 * mi + g + 8 * h;
            const int n = 8 * ni + 2 * t + v;
            if (j >= f || n >= rows) continue;
            const size_t row = (size_t)e * C + c0 + n;
            const float val = acc[mi][ni][2 * h + v];
            if (splits == 1)
              out[row * f + j] = __float2bfloat16(n < live ? val : 0.f);
            else if (n < live)
              part[((size_t)s * E * C + row) * f + j] = val;
          }
  }
}

// out = the sum of the splits' partials in range order (filled rows), or
// zero (rows at or past the count, whose partials were never written).
__global__ void gmm_reduce_kernel(const float* __restrict__ part,
                                  const int* __restrict__ counts,
                                  bf16* __restrict__ out, int C, int f,
                                  int splits, size_t n) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    const size_t row = i / f;
    const int e = (int)(row / C), c = (int)(row % C);
    float v = 0.f;
    if (c < filled(counts, e, C))
      for (int s = 0; s < splits; ++s) v += part[(size_t)s * n + i];
    out[i] = __float2bfloat16(v);
  }
}

// Device facts read once per process (the port drives one card): a call
// on the served path costs one launch, not four runtime queries.
int sm_count() {
  static const int sms = [] {
    int dev = 0, n = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    return n > 0 ? n : 1;
  }();
  return sms;
}

struct Occupancy {
  cudaError_t err;
  int per_sm;  // resident blocks per SM
};

// Raise the dynamic shared-memory limit of one instance and read its
// occupancy, once: the attribute holds for the life of the context.
template <int BN, bool VEC>
const Occupancy& occupancy() {
  static const Occupancy occ = [] {
    constexpr int smem = smem_bytes<BN>();
    Occupancy o{cudaFuncSetAttribute(gmm_tc_kernel<BN, VEC>,
                                     cudaFuncAttributeMaxDynamicSharedMemorySize,
                                     smem),
                0};
    if (o.err == cudaSuccess)
      o.err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &o.per_sm, gmm_tc_kernel<BN, VEC>, NT, smem);
    return o;
  }();
  return occ;
}

template <int BN, bool VEC>
cudaError_t launch(const void* x, const void* w, const int* counts,
                   float* part, void* out, int E, int C, int d, int f,
                   int splits, cudaStream_t stream) {
  constexpr int smem = smem_bytes<BN>();
  const Occupancy& occ = occupancy<BN, VEC>();
  if (occ.err != cudaSuccess) return occ.err;
  const long long items = (long long)E * ((C + BN - 1) / BN) * splits *
                          ((f + BM - 1) / BM);
  if (items >= (1LL << 31)) return cudaErrorInvalidConfiguration;
  const long long resident = (long long)sm_count() * occ.per_sm;
  const long long grid = items < resident ? items : resident;
  gmm_tc_kernel<BN, VEC><<<(unsigned)grid, NT, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w), counts, part,
      static_cast<bf16*>(out), E, C, d, f, splits);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const size_t n = (size_t)E * C * f;
  const size_t blocks = (n + 255) / 256;
  const unsigned rgrid = (unsigned)(blocks < (size_t)sm_count() * 8
                                        ? blocks : (size_t)sm_count() * 8);
  gmm_reduce_kernel<<<rgrid, 256, 0, stream>>>(
      part, counts, static_cast<bf16*>(out), C, f, splits, n);
  return cudaGetLastError();
}

// The N tile: C padded to 8, 16 or 32 rows (several tiles past 32).
template <bool VEC>
cudaError_t dispatch_c(const void* x, const void* w, const int* counts,
                       float* part, void* out, int E, int C, int d, int f,
                       int c_tile, int splits, cudaStream_t stream) {
  switch (c_tile) {
    case 8:
      return launch<8, VEC>(x, w, counts, part, out, E, C, d, f, splits,
                            stream);
    case 16:
      return launch<16, VEC>(x, w, counts, part, out, E, C, d, f, splits,
                             stream);
    case 32:
      return launch<32, VEC>(x, w, counts, part, out, E, C, d, f, splits,
                             stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace tc

}  // namespace

// dtype: 0 float32, 1 bfloat16. counts: (E,) int32 or null. The caller
// picks the instance (kernels/moe_gmm.py, plan): c_tile, the rows of C per
// tile; vec, 16-byte loads (bf16: d and f multiples of 8, x and w 16-byte
// aligned); splits, d ranges of the bf16 kernel, with part a (splits, E,
// C, f) fp32 scratch when splits > 1 (fp32 takes splits == 1). Returns
// the launch's cudaError_t.
extern "C" int moe_gmm_fwd(const void* x, const void* w, const void* counts,
                           void* part, void* out, int E, int C, int d, int f,
                           int c_tile, int vec, int splits, int dtype,
                           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* cnt = static_cast<const int*>(counts);
  float* p = static_cast<float*>(part);
  if (splits < 1 || (splits > 1 && !p)) return cudaErrorInvalidValue;
  if (dtype == 0) {
    if (splits != 1 || vec) return cudaErrorInvalidValue;
    return f32::dispatch_c(x, w, cnt, out, E, C, d, f, c_tile, st);
  }
  if (dtype == 1) {
    if (vec)
      return tc::dispatch_c<true>(x, w, cnt, p, out, E, C, d, f, c_tile,
                                  splits, st);
    return tc::dispatch_c<false>(x, w, cnt, p, out, E, C, d, f, c_tile,
                                 splits, st);
  }
  return cudaErrorInvalidValue;
}

// Grouped expert GEMM for Hopper (sm_90a): out[e] = x[e] @ w[e] for every
// expert e, fp32 accumulation, output in x's dtype.
//
// Replaces: src/repro/kernels/moe_gmm.py, moe_gmm (_gmm_kernel). Same
// contract: x (E, C, d) capacity-dispatched tokens, w (E, d, f) expert
// weights, out (E, C, f). Unlike the Pallas kernel's block specs, no dim
// has to be a tile multiple: every edge is bounds-checked (C is 1 at a
// decode step, and the tests use ragged d and f).
//
// Bound on the card: bytes. A call must read all E * d * f weights once,
// whatever C is (arctic: 128 x 7168 x 4864 x 2 B = 8.9 GB, 2.7 ms at
// 3.35 TB/s), against 2 * E * C * d * f FLOPs: C FLOP per weight byte in
// bf16, far below the ~295 where the tensor cores would bind. With its
// fp32 FMAs on CUDA cores this first version turns bound by operations
// from C of about 16 (the prefill groups) and stays bound by bytes below.
//
// Design: one 128-thread block per (256-column f tile, C tile, expert).
// Thread t owns output columns f0 + 2t and f0 + 2t + 1, so a warp's weight
// load is 64 consecutive columns of one row of w (128 bytes in bf16): the
// weight stream coalesces, and each weight is read from device memory once
// per C tile. The block's C rows of x are staged in shared memory as fp32,
// 256 d at a time, and read as broadcast float4s; eight weight rows are in
// flight per thread. The C tile is sized to C (1, 2, 4, 8, 16 or 32 rows,
// chosen at launch), so a decode step (C = 1) spends no FMAs on empty rows
// and a prefill group (C <= 32) reads the weights once. mma.sync / wgmma
// on bf16 tiles is the step that lifts the prefill case off the CUDA
// cores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int NT = 128;       // threads per block
constexpr int BF = 2 * NT;    // output columns per block (two per thread)
constexpr int BD = 256;       // d of x staged per pass
constexpr int U = 8;          // weight rows in flight per thread

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// Columns j and j + 1 of one weight row; zero past f. ``vec``: f is even,
// so j (always even) and the row start are aligned for one paired load.
__device__ __forceinline__ float2 load_pair(const float* row, int j, int f,
                                            bool vec) {
  if (vec && j < f) return *reinterpret_cast<const float2*>(row + j);
  return make_float2(j < f ? row[j] : 0.f, j + 1 < f ? row[j + 1] : 0.f);
}
__device__ __forceinline__ float2 load_pair(const __nv_bfloat16* row, int j,
                                            int f, bool vec) {
  if (vec && j < f)
    return __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(row + j));
  return make_float2(j < f ? __bfloat162float(row[j]) : 0.f,
                     j + 1 < f ? __bfloat162float(row[j + 1]) : 0.f);
}

template <typename T, int BC>
__global__ void __launch_bounds__(NT)
gmm_kernel(const T* __restrict__ x, const T* __restrict__ w,
           T* __restrict__ out, int C, int d, int f) {
  __shared__ __align__(16) float xs[BC * BD];
  const int e = blockIdx.z;
  const int c0 = blockIdx.y * BC;
  const int j = blockIdx.x * BF + 2 * threadIdx.x;
  const int rows = min(BC, C - c0);
  const bool vec = (f & 1) == 0;
  const T* xe = x + ((size_t)e * C + c0) * d;
  const T* we = w + (size_t)e * d * f;

  float acc[BC][2];
#pragma unroll
  for (int r = 0; r < BC; ++r) acc[r][0] = acc[r][1] = 0.f;

  for (int d0 = 0; d0 < d; d0 += BD) {
    const int nd = min(BD, d - d0);
    __syncthreads();  // the previous chunk's xs consumed
    for (int i = threadIdx.x; i < BC * BD; i += NT) {
      const int r = i / BD, k = i % BD;
      xs[i] = r < rows && k < nd ? to_f32(xe[(size_t)r * d + d0 + k]) : 0.f;
    }
    __syncthreads();
    const T* wr = we + (size_t)d0 * f;
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
    T* orow = out + ((size_t)e * C + c0 + r) * f;
    if (j < f) store(orow + j, acc[r][0]);
    if (j + 1 < f) store(orow + j + 1, acc[r][1]);
  }
}

template <typename T, int BC>
cudaError_t launch(const void* x, const void* w, void* out, int E, int C,
                   int d, int f, cudaStream_t stream) {
  const int c_tiles = (C + BC - 1) / BC;
  if (c_tiles > 65535 || E > 65535) return cudaErrorInvalidConfiguration;
  dim3 grid((f + BF - 1) / BF, c_tiles, E);
  gmm_kernel<T, BC><<<grid, NT, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<T*>(out), C, d, f);
  return cudaGetLastError();
}

// The C tile: the smallest of 1, 2, 4, 8, 16, 32 rows that holds C, else
// 32 rows and several C tiles.
template <typename T>
cudaError_t dispatch_c(const void* x, const void* w, void* out, int E, int C,
                       int d, int f, cudaStream_t stream) {
  if (C <= 1) return launch<T, 1>(x, w, out, E, C, d, f, stream);
  if (C <= 2) return launch<T, 2>(x, w, out, E, C, d, f, stream);
  if (C <= 4) return launch<T, 4>(x, w, out, E, C, d, f, stream);
  if (C <= 8) return launch<T, 8>(x, w, out, E, C, d, f, stream);
  if (C <= 16) return launch<T, 16>(x, w, out, E, C, d, f, stream);
  return launch<T, 32>(x, w, out, E, C, d, f, stream);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16. Returns the launch's cudaError_t.
extern "C" int moe_gmm_fwd(const void* x, const void* w, void* out, int E,
                           int C, int d, int f, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_c<float>(x, w, out, E, C, d, f, st);
  if (dtype == 1)
    return dispatch_c<__nv_bfloat16>(x, w, out, E, C, d, f, st);
  return cudaErrorInvalidValue;
}

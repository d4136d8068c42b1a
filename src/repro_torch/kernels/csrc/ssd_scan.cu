// Mamba2 SSD (state-space duality) chunked scan for Hopper (sm_90a): the
// forward pass of one Mamba2 layer's prefill from a zero state, fp32
// throughout.
//
// Replaces: src/repro/kernels/ssd_scan.py, ssd_scan (_ssd_kernel). Same
// contract: x (B, S, nh, hp), dt (B, S, nh) f32, A (nh,) f32, B/C (B, S,
// ng, ds) with head h reading group h / (nh / ng); S a multiple of the
// chunk Q. Inside a chunk, with cs the prefix sum of dt * A,
//   y_i = sum_{j <= i} (C_i . B_j) exp(cs_i - cs_j) dt_j x_j
//         + exp(cs_i) C_i . state
//   state <- exp(cs_Q) state + sum_j exp(cs_Q - cs_j) dt_j x_j (x) B_j.
// Returns y (B, S, nh, hp) fp32 and the final state (B, nh, hp, ds) fp32.
//
// Bound on the card: operations at the serving shapes. Per chunk and head
// the dual form does Q (Q + 1) / 2 (ds + hp) + 2 Q hp ds FMAs (mamba2: Q
// 256, hp 64, ds 128: 10.5 M), against about Q hp (2 + 4) bytes of bf16 x
// in and fp32 y out (B and C are shared by the heads of a group): ~200
// FLOP per byte. The C . B scores (Q (Q + 1) / 2 ds, 4.2 M) have operands
// in x's dtype, which bf16 tensor cores multiply exactly into fp32 at 989
// TFLOP/s; the rest has an fp32 operand (dt, a score or the state) and
// binds at the card's 67 TFLOP/s of fp32 FMAs.
//
// Design: the Pallas kernel carries the (hp, ds) state in VMEM across a
// sequential ("arbitrary") chunk grid axis. Hopper blocks run in no order,
// so here one 256-thread block owns one (b, head) and sweeps the chunks in
// a loop, with the fp32 state kept in shared memory (32 KB at 64 x 128).
// A whole Q x Q fp32 score tile (256 KB at Q 256) does not fit the 227 KB
// a block may use, so the intra-chunk term is tiled: 64-row query tiles,
// each with the chunk's 64-row key tiles at or below it (tiles above the
// diagonal are never touched, and exp(cs_i - cs_j) is evaluated only where
// j <= i: above it the exponent is positive and may overflow). Each thread
// owns a 4 x 4 block of a score tile, 4 x hp/16 outputs and hp/16 x ds/16
// state entries, reading shared-memory tiles padded to a conflict-free
// stride. The prefix sum is taken in order by one thread. Products are
// fp32 FMAs on CUDA cores; mma.sync / wgmma tiles for the Q x Q products
// are the step that moves it toward its bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;       // 16 x 16 threads
constexpr int TQ = 64;        // rows of a query or key tile
constexpr int MAXQ = 256;     // longest chunk

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <int HP, int DS>
struct Layout {               // shared-memory offsets, in floats
  static constexpr int LD = DS + 1;                 // padded B/C/state row
  static constexpr int LS = TQ + 1;                 // padded score row
  static constexpr int C_ = 0;                      // C tile   TQ x LD
  static constexpr int B_ = C_ + TQ * LD;           // B tile   TQ x LD
  static constexpr int X_ = B_ + TQ * LD;           // x*dt     TQ x HP
  static constexpr int S_ = X_ + TQ * HP;           // scores   TQ x LS
  static constexpr int ST = S_ + TQ * LS;           // state    HP x LD
  static constexpr int CS = ST + HP * LD;           // cs       MAXQ
  static constexpr int DT = CS + MAXQ;              // dt       MAXQ
  static constexpr int TOTAL = DT + MAXQ;
  static constexpr size_t BYTES = sizeof(float) * TOTAL;
};

template <typename T, int HP, int DS>
__global__ void __launch_bounds__(NT)
ssd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
           const float* __restrict__ A, const T* __restrict__ Bg,
           const T* __restrict__ Cg, float* __restrict__ y,
           float* __restrict__ state_out, int S, int nh, int ng, int Q) {
  using L = Layout<HP, DS>;
  constexpr int LD = L::LD, LS = L::LS;
  constexpr int PJ = HP / 16;   // output columns / state rows per thread
  constexpr int SJ = DS / 16;   // state columns per thread
  extern __shared__ float sm[];
  float* Cs = sm + L::C_;
  float* Bs = sm + L::B_;
  float* Xs = sm + L::X_;
  float* Ss = sm + L::S_;
  float* St = sm + L::ST;
  float* cs = sm + L::CS;
  float* dts = sm + L::DT;

  const int h = blockIdx.x;
  const size_t b = blockIdx.y;
  const int g = h / (nh / ng);
  const float a = A[h];
  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const int ntq = (Q + TQ - 1) / TQ;

  // Stage rows [t0 + r0, t0 + r0 + TQ) of B (or C) into a TQ x LD tile,
  // zero past the chunk.
  auto stage_bc = [&](float* dst, const T* src, int t0, int r0) {
    for (int e = tid; e < TQ * DS; e += NT) {
      const int r = e / DS, s = e % DS;
      dst[r * LD + s] =
          r0 + r < Q
              ? to_f32(src[(((b * S) + t0 + r0 + r) * ng + g) * DS + s])
              : 0.f;
    }
  };
  // Stage dt_j x_j (times exp(cs_Q - cs_j) when ``decay``) for key rows
  // [r0, r0 + TQ) of the chunk, zero past it.
  auto stage_x = [&](int t0, int r0, bool decay) {
    const float cl = cs[Q - 1];
    for (int e = tid; e < TQ * HP; e += NT) {
      const int r = e / HP, p = e % HP;
      const int j = r0 + r;
      float v = 0.f;
      if (j < Q) {
        v = to_f32(x[(((b * S) + t0 + j) * nh + h) * HP + p]) * dts[j];
        if (decay) v *= expf(cl - cs[j]);
      }
      Xs[r * HP + p] = v;
    }
  };

  for (int e = tid; e < HP * LD; e += NT) St[e] = 0.f;

  for (int t0 = 0; t0 < S; t0 += Q) {
    __syncthreads();  // the previous chunk's cs, dts and state settled
    for (int i = tid; i < Q; i += NT) dts[i] = dt[(b * S + t0 + i) * nh + h];
    __syncthreads();
    if (tid == 0) {   // inclusive prefix sum of dt * A, in order
      float run = 0.f;
      for (int i = 0; i < Q; ++i) {
        run += dts[i] * a;
        cs[i] = run;
      }
    }
    __syncthreads();

    // ---- y, one 64-row query tile at a time
    for (int qi = 0; qi < ntq; ++qi) {
      const int i0 = qi * TQ;
      __syncthreads();  // the previous tile's Cs consumed
      stage_bc(Cs, Cg, t0, i0);
      __syncthreads();

      // inter-chunk term: exp(cs_i) C_i . state[p]
      float acc[4][PJ];
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < PJ; ++v) acc[u][v] = 0.f;
#pragma unroll 4
      for (int s = 0; s < DS; ++s) {
        float cv[4], sv[PJ];
#pragma unroll
        for (int u = 0; u < 4; ++u) cv[u] = Cs[(ty + 16 * u) * LD + s];
#pragma unroll
        for (int v = 0; v < PJ; ++v) sv[v] = St[(tx + 16 * v) * LD + s];
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int v = 0; v < PJ; ++v) acc[u][v] = fmaf(cv[u], sv[v], acc[u][v]);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = i0 + ty + 16 * u;
        const float ei = i < Q ? expf(cs[i]) : 0.f;
#pragma unroll
        for (int v = 0; v < PJ; ++v) acc[u][v] *= ei;
      }

      // intra-chunk term over the key tiles at or below the diagonal
      for (int kj = 0; kj <= qi; ++kj) {
        const int j0 = kj * TQ;
        __syncthreads();  // the previous key tile's Bs, Xs, Ss consumed
        stage_bc(Bs, Bg, t0, j0);
        stage_x(t0, j0, false);
        __syncthreads();
        float sc[4][4];
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int v = 0; v < 4; ++v) sc[u][v] = 0.f;
#pragma unroll 4
        for (int s = 0; s < DS; ++s) {
          float cv[4], bv[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) cv[u] = Cs[(ty + 16 * u) * LD + s];
#pragma unroll
          for (int v = 0; v < 4; ++v) bv[v] = Bs[(tx + 16 * v) * LD + s];
#pragma unroll
          for (int u = 0; u < 4; ++u)
#pragma unroll
            for (int v = 0; v < 4; ++v) sc[u][v] = fmaf(cv[u], bv[v], sc[u][v]);
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int i = i0 + ty + 16 * u;
#pragma unroll
          for (int v = 0; v < 4; ++v) {
            const int j = j0 + tx + 16 * v;
            Ss[(ty + 16 * u) * LS + tx + 16 * v] =
                j <= i && i < Q ? sc[u][v] * expf(cs[i] - cs[j]) : 0.f;
          }
        }
        __syncthreads();
#pragma unroll 4
        for (int jr = 0; jr < TQ; ++jr) {
          float pv[4], xv[PJ];
#pragma unroll
          for (int u = 0; u < 4; ++u) pv[u] = Ss[(ty + 16 * u) * LS + jr];
#pragma unroll
          for (int v = 0; v < PJ; ++v) xv[v] = Xs[jr * HP + tx + 16 * v];
#pragma unroll
          for (int u = 0; u < 4; ++u)
#pragma unroll
            for (int v = 0; v < PJ; ++v) acc[u][v] = fmaf(pv[u], xv[v], acc[u][v]);
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = i0 + ty + 16 * u;
        if (i >= Q) continue;
        float* yrow = y + (((b * S) + t0 + i) * nh + h) * HP;
#pragma unroll
        for (int v = 0; v < PJ; ++v) yrow[tx + 16 * v] = acc[u][v];
      }
    }

    // ---- state update: exp(cs_Q) state + sum_j (decayed dt_j x_j) (x) B_j
    float sacc[PJ][SJ];
#pragma unroll
    for (int u = 0; u < PJ; ++u)
#pragma unroll
      for (int v = 0; v < SJ; ++v) sacc[u][v] = 0.f;
    for (int kj = 0; kj < ntq; ++kj) {
      const int j0 = kj * TQ;
      __syncthreads();  // Bs, Xs of the last tile consumed
      stage_bc(Bs, Bg, t0, j0);
      stage_x(t0, j0, true);
      __syncthreads();
#pragma unroll 4
      for (int jr = 0; jr < TQ; ++jr) {
        float xv[PJ], bv[SJ];
#pragma unroll
        for (int u = 0; u < PJ; ++u) xv[u] = Xs[jr * HP + ty + 16 * u];
#pragma unroll
        for (int v = 0; v < SJ; ++v) bv[v] = Bs[jr * LD + tx + 16 * v];
#pragma unroll
        for (int u = 0; u < PJ; ++u)
#pragma unroll
          for (int v = 0; v < SJ; ++v) sacc[u][v] = fmaf(xv[u], bv[v], sacc[u][v]);
      }
    }
    __syncthreads();  // every read of the old state done
    const float dl = expf(cs[Q - 1]);
#pragma unroll
    for (int u = 0; u < PJ; ++u)
#pragma unroll
      for (int v = 0; v < SJ; ++v) {
        float* p = St + (ty + 16 * u) * LD + tx + 16 * v;
        *p = *p * dl + sacc[u][v];
      }
  }
  __syncthreads();
  float* so = state_out + (b * nh + h) * HP * DS;
  for (int e = tid; e < HP * DS; e += NT)
    so[e] = St[(e / DS) * LD + e % DS];
}

template <typename T, int HP, int DS>
cudaError_t launch(const void* x, const void* dt, const void* A,
                   const void* Bg, const void* Cg, void* y, void* state,
                   int B, int S, int nh, int ng, int Q, cudaStream_t stream) {
  constexpr size_t smem = Layout<HP, DS>::BYTES;
  // above 48 KB a block may use dynamic shared memory only after opting in
  cudaError_t err = cudaFuncSetAttribute(
      ssd_kernel<T, HP, DS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  if (B > 65535) return cudaErrorInvalidConfiguration;
  dim3 grid(nh, B);
  ssd_kernel<T, HP, DS><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const T*>(Bg),
      static_cast<const T*>(Cg), static_cast<float*>(y),
      static_cast<float*>(state), S, nh, ng, Q);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* x, const void* dt, const void* A,
                     const void* Bg, const void* Cg, void* y, void* state,
                     int B, int S, int nh, int hp, int ng, int ds, int Q,
                     cudaStream_t st) {
  if (hp == 16 && ds == 16)
    return launch<T, 16, 16>(x, dt, A, Bg, Cg, y, state, B, S, nh, ng, Q, st);
  if (hp == 16 && ds == 128)
    return launch<T, 16, 128>(x, dt, A, Bg, Cg, y, state, B, S, nh, ng, Q, st);
  if (hp == 64 && ds == 16)
    return launch<T, 64, 16>(x, dt, A, Bg, Cg, y, state, B, S, nh, ng, Q, st);
  if (hp == 64 && ds == 128)
    return launch<T, 64, 128>(x, dt, A, Bg, Cg, y, state, B, S, nh, ng, Q, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype (of x, B and C): 0 float32, 1 bfloat16. Returns the launch's
// cudaError_t.
extern "C" int ssd_scan_fwd(const void* x, const void* dt, const void* A,
                            const void* Bg, const void* Cg, void* y,
                            void* state, int B, int S, int nh, int hp, int ng,
                            int ds, int chunk, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (chunk < 1 || chunk > MAXQ || S % chunk || ng < 1 || nh % ng)
    return cudaErrorInvalidValue;
  if (dtype == 0)
    return dispatch<float>(x, dt, A, Bg, Cg, y, state, B, S, nh, hp, ng, ds,
                           chunk, st);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(x, dt, A, Bg, Cg, y, state, B, S, nh, hp,
                                   ng, ds, chunk, st);
  return cudaErrorInvalidValue;
}

// Mamba2 SSD (state-space duality) chunked scan for Hopper (sm_90a): the
// forward pass of one Mamba2 layer's prefill from a zero state.
//
// Replaces: src/repro/kernels/ssd_scan.py, ssd_scan (_ssd_kernel). Same
// contract: x (B, S, nh, hp), dt (B, S, nh) f32, A (nh,) f32, B/C (B, S,
// ng, ds) with head h reading group h / (nh / ng); S a multiple of the
// chunk Q <= 256; hp 16/64, ds 16/128. Inside a chunk, with cs the prefix
// sum of dt * A,
//   y_i = sum_{j <= i} (C_i . B_j) exp(cs_i - cs_j) dt_j x_j
//         + exp(cs_i) C_i . state
//   state <- exp(cs_Q) state + sum_j exp(cs_Q - cs_j) dt_j x_j (x) B_j.
// Returns y (B, S, nh, hp) fp32 and the final state (B, nh, hp, ds) fp32.
// exp(cs_i - cs_j) is evaluated only where j <= i: above the diagonal the
// exponent is positive and may overflow.
//
// Bound on the card: bytes at the serving shapes. Per chunk and head the
// dual form does Q (Q + 1) / 2 (ds + hp) + 2 Q hp ds FMAs (mamba2: Q 256,
// hp 64, ds 128: 10.5 M), against about Q hp (2 + 4) bytes of bf16 x in
// and fp32 y out. The C . B scores (Q (Q + 1) / 2 ds of those FMAs) are
// the same for every head of a group, and the rest runs on TF32 tensor
// cores in the bf16 kernel: at mamba2's 3 x 512 prefill group, 45 MB take
// 13.5 us at 3.35 TB/s against 9.8 us of TF32 products at 495 TFLOP/s and
// 0.05 us of bf16 scores counted once per group (chip_smoke.py's
// ssd_bound).
//
// The Pallas kernel carries the (hp, ds) state in VMEM across a sequential
// ("arbitrary") chunk grid axis. Hopper blocks run in no order, so here a
// block sweeps the chunks of its (b, head) in a loop, with the fp32 state
// in shared memory. Rows p of the state are independent (y[:, p] and
// state[p, :] read only x[:, p]), so the bf16 grid also splits hp.
//
// bf16 design (the served path): one 128-thread block per (hp tile, head,
// b), HPT = 16, 32 or 64 columns of hp (ssd_scan.py's hp_tile picks), four
// warps each owning 16 rows of a 64-row query tile. Shared memory holds a
// 64-row C tile and two buffers of 64-row key tiles of B and x, all bf16
// and filled by 16-byte cp.async (the next key tile loads while this one
// multiplies), and the HPT x ds state in fp32: 106 KB at HPT 64, ds 128,
// two blocks to an SM. Per chunk:
// - cs by a block scan (warp shuffles, then warp totals), in base 2 (dt A
//   log2(e) summed, every exp an exp2); exp(cs_i) and exp(cs_Q - cs_j) dt_j
//   once per position.
// - C . B^T scores on bf16 tensor cores (mma.sync.m16n8k16, ldmatrix as in
//   flash_attention.cu), only for key tiles at or below the query tile and
//   n-tiles at or below the warp's diagonal: bf16 products are exact in
//   fp32. Every block of a group recomputes them (3.2 GFLOP at 3 x 512,
//   about 3 us at the bf16 rate) rather than reading them from a pre-pass,
//   which would add a launch to a host-bound prefill and a Q x Q fp32 tile
//   read per block; the pre-pass was not built or timed.
// - P = scores * exp(cs_i - cs_j) * dt_j in fp32 registers, masked j <= i.
// - The three products with an fp32 operand run on TF32 tensor cores
//   (mma.sync.m16n8k8), fp32 accumulation. Rounded to TF32 (10-bit
//   mantissa, round to nearest): P (in y += P x), the state (in y +=
//   exp(cs_i) C state^T) and exp(cs_Q - cs_j) dt_j x_j (in the state
//   update). x, B and C are bf16, so exact in TF32. Each rounding moves a
//   term by at most 2^-11 relative, far inside the bf16 tolerance (8e-2).
//   P goes from the score accumulators straight into the A operand of the
//   x product: the k index of that product is permuted (key 2t to slot t,
//   key 2t + 1 to slot t + 4) and x's rows are read in the same order.
// - The state update uses each key tile while it is resident for its own
//   query tile (the diagonal step), so it loads nothing of its own.
// fp32 design (x, B, C in fp32; kept from the first version: exact fp32
// FMAs on CUDA cores, no TF32): one 256-thread block per (b, head), 64-row
// query and key tiles, each thread a 4 x 4 block of a score tile, 4 x
// hp/16 outputs and hp/16 x ds/16 state entries; its prefix sum is the
// same block scan.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TQ = 64;        // rows of a query or key tile
constexpr int MAXQ = 256;     // longest chunk

// Inclusive prefix sum of v[0, MAXQ) in place (entries past the chunk
// zero), by NT threads: each sums MAXQ / NT neighbours, the warps scan by
// shuffles, then add the totals of the warps before them. `tot` holds NT /
// 32 floats of shared memory.
template <int NT>
__device__ __forceinline__ void block_scan(float* v, float* tot) {
  constexpr int IT = MAXQ / NT;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float x[IT], run = 0.f;
#pragma unroll
  for (int i = 0; i < IT; ++i) {
    run += v[tid * IT + i];
    x[i] = run;
  }
  float incl = run;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float y = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) tot[warp] = incl;
  __syncthreads();
  float off = incl - run;
  for (int w = 0; w < warp; ++w) off += tot[w];
#pragma unroll
  for (int i = 0; i < IT; ++i) v[tid * IT + i] = x[i] + off;
  __syncthreads();
}

// ------------------------------------------------------------------ fp32
namespace f32 {

constexpr int NT = 256;       // 16 x 16 threads

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
  static constexpr int TOT = DT + MAXQ;             // scan     NT / 32
  static constexpr int TOTAL = TOT + NT / 32;
  static constexpr size_t BYTES = sizeof(float) * TOTAL;
};

template <int HP, int DS>
__global__ void __launch_bounds__(NT)
ssd_kernel(const float* __restrict__ x, const float* __restrict__ dt,
           const float* __restrict__ A, const float* __restrict__ Bg,
           const float* __restrict__ Cg, float* __restrict__ y,
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
  auto stage_bc = [&](float* dst, const float* src, int t0, int r0) {
    for (int e = tid; e < TQ * DS; e += NT) {
      const int r = e / DS, s = e % DS;
      dst[r * LD + s] =
          r0 + r < Q ? src[(((b * S) + t0 + r0 + r) * ng + g) * DS + s] : 0.f;
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
        v = x[(((b * S) + t0 + j) * nh + h) * HP + p] * dts[j];
        if (decay) v *= expf(cl - cs[j]);
      }
      Xs[r * HP + p] = v;
    }
  };

  for (int e = tid; e < HP * LD; e += NT) St[e] = 0.f;

  for (int t0 = 0; t0 < S; t0 += Q) {
    __syncthreads();  // the previous chunk's cs, dts and state settled
    for (int i = tid; i < MAXQ; i += NT) {
      const float d = i < Q ? dt[(b * S + t0 + i) * nh + h] : 0.f;
      dts[i] = d;
      cs[i] = d * a;
    }
    __syncthreads();
    block_scan<NT>(cs, sm + L::TOT);   // inclusive prefix sum of dt * A

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

template <int HP, int DS>
cudaError_t launch(const void* x, const void* dt, const void* A,
                   const void* Bg, const void* Cg, void* y, void* state,
                   int B, int S, int nh, int ng, int Q, cudaStream_t stream) {
  constexpr size_t smem = Layout<HP, DS>::BYTES;
  // above 48 KB a block may use dynamic shared memory only after opting in
  cudaError_t err = cudaFuncSetAttribute(
      ssd_kernel<HP, DS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  ssd_kernel<HP, DS><<<dim3(nh, B), NT, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const float*>(Bg),
      static_cast<const float*>(Cg), static_cast<float*>(y),
      static_cast<float*>(state), S, nh, ng, Q);
  return cudaGetLastError();
}

}  // namespace f32

// ---------------------------------------------------- bf16 tensor cores
namespace tc {

using bf16 = __nv_bfloat16;
constexpr int NT = 128;       // 4 warps, 16 query rows each

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
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
// d += a . b on one m16n8k8 tile, TF32 operands, fp32 accumulators.
__device__ __forceinline__ void mma_tf32(float (&d)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// fp32 -> TF32, round to nearest (ties away), as the tensor core reads it.
__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}
// a bf16 is exact in TF32: its bits, widened
__device__ __forceinline__ uint32_t tf32(bf16 x) {
  return (uint32_t)__bfloat16_as_ushort(x) << 16;
}

template <int HPT, int DS>
struct Layout {               // shared-memory offsets, in bytes
  static constexpr int LDB = DS + 8;      // bf16 row of B/C: 16 B padding
  static constexpr int LDX = HPT + 8;     // bf16 row of x: 16 B padding
  static constexpr int LDS = DS + 4;      // fp32 row of the state
  static constexpr int C_ = 0;                          // C  TQ x LDB
  static constexpr int B_ = C_ + TQ * LDB * 2;          // B  2 x TQ x LDB
  static constexpr int X_ = B_ + 2 * TQ * LDB * 2;      // x  2 x TQ x LDX
  static constexpr int ST = X_ + 2 * TQ * LDX * 2;      // state HPT x LDS
  static constexpr int CS = ST + HPT * LDS * 4;         // cs        MAXQ
  static constexpr int DT = CS + MAXQ * 4;              // dt        MAXQ
  static constexpr int EC = DT + MAXQ * 4;              // exp(cs)   MAXQ
  static constexpr int WD = EC + MAXQ * 4;  // exp(cs_Q - cs_j) dt_j MAXQ
  static constexpr int TOT = WD + MAXQ * 4;             // scan NT / 32
  static constexpr int BYTES = TOT + NT / 32 * 4;
};

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

// rows [r0, r0 + TQ) of a chunk of a (rows, stride) bf16 matrix, W
// elements a row, into a TQ x LD tile, zero past the chunk's Q rows: by
// cp.async when the source is 16-byte aligned (completing at the next
// wait), else element by element.
template <int W, int LD>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src,
                                          size_t stride, int r0, int Q,
                                          bool vec) {
  constexpr int CH = W / 8;   // 16-byte pieces of a row
  for (int e = threadIdx.x; e < TQ * CH; e += NT) {
    const int r = e / CH, c = (e % CH) * 8;
    const bool ok = r0 + r < Q;
    const bf16* p = src + (size_t)(ok ? r0 + r : 0) * stride + c;
    if (vec) {
      cp_async16(dst + r * LD + c, p, ok ? 16 : 0);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i)
        dst[r * LD + c + i] = ok ? p[i] : __float2bfloat16(0.f);
    }
  }
}

template <int HPT, int DS>
__global__ void __launch_bounds__(NT)
ssd_tc_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
              const float* __restrict__ A, const bf16* __restrict__ Bg,
              const bf16* __restrict__ Cg, float* __restrict__ y,
              float* __restrict__ state_out, int S, int nh, int hp, int ng,
              int Q, int vec) {
  using L = Layout<HPT, DS>;
  constexpr int LDB = L::LDB, LDX = L::LDX, LDS = L::LDS;
  constexpr int PN = HPT / 8;         // 8-column tiles of y
  constexpr int KS = DS / 16;         // k steps of the scores
  constexpr int MT = HPT / 16;        // 16-row tiles of the state
  constexpr int NTL = DS / 8;         // 8-column tiles of the state
  constexpr int SN = (NTL + 3) / 4;   // state column tiles per warp
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Cs = reinterpret_cast<bf16*>(smem_raw + L::C_);
  bf16* Bs0 = reinterpret_cast<bf16*>(smem_raw + L::B_);  // two buffers
  bf16* Xs0 = reinterpret_cast<bf16*>(smem_raw + L::X_);  // two buffers
  float* St = reinterpret_cast<float*>(smem_raw + L::ST);
  float* cs = reinterpret_cast<float*>(smem_raw + L::CS);
  float* dts = reinterpret_cast<float*>(smem_raw + L::DT);
  float* ecs = reinterpret_cast<float*>(smem_raw + L::EC);
  float* wd = reinterpret_cast<float*>(smem_raw + L::WD);

  const int p0 = blockIdx.x * HPT;
  const int h = blockIdx.y;
  const size_t b = blockIdx.z;
  const int grp = h / (nh / ng);
  const float a2 = A[h] * 1.4426950408889634f;  // cs in base 2
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int lq = lane >> 3, lr = lane & 7;  // ldmatrix: quarter, row
  const int ntq = (Q + TQ - 1) / TQ;
  const size_t bc_stride = (size_t)ng * DS;  // between positions of B/C
  const size_t x_stride = (size_t)nh * hp;

  for (int e = tid; e < HPT * LDS; e += NT) St[e] = 0.f;

  for (int t0 = 0; t0 < S; t0 += Q) {
    const bf16* Cc = Cg + ((b * S + t0) * ng + grp) * DS;
    const bf16* Bc = Bg + ((b * S + t0) * ng + grp) * DS;
    const bf16* Xc = x + ((b * S + t0) * nh + h) * hp + p0;
    __syncthreads();  // the previous chunk's cs, wd and state settled
    for (int i = tid; i < MAXQ; i += NT) {
      const float d = i < Q ? dt[(b * S + t0 + i) * nh + h] : 0.f;
      dts[i] = d;
      cs[i] = d * a2;
    }
    __syncthreads();
    block_scan<NT>(cs, reinterpret_cast<float*>(smem_raw + L::TOT));
    const float cl = cs[Q - 1];
    for (int i = tid; i < MAXQ; i += NT) {
      ecs[i] = i < Q ? exp2f(cs[i]) : 0.f;
      wd[i] = i < Q ? exp2f(cl - cs[i]) * dts[i] : 0.f;
    }
    // (made visible by the barrier before the first C tile is read)

    // key tiles (B and x) run through two buffers: the next step's tile
    // loads while this one multiplies
    int buf = 0;
    load_rows<DS, LDB>(Bs0, Bc, bc_stride, 0, Q, vec);
    load_rows<HPT, LDX>(Xs0, Xc, x_stride, 0, Q, vec);
    cp_async_commit();

    float sacc[MT][SN][4];   // this chunk's state increment
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int r = 0; r < SN; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) sacc[mt][r][c] = 0.f;

    for (int qi = 0; qi < ntq; ++qi) {
      const int i0 = qi * TQ;
      const int w0 = i0 + 16 * warp;  // the warp's first query row
      // Cs and the other key buffer are free: the last step ended on a
      // barrier
      load_rows<DS, LDB>(Cs, Cc, bc_stride, i0, Q, vec);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();

      // inter-chunk term: exp(cs_i) C_i . state[p], TF32 (state rounded)
      float yacc[PN][4];
#pragma unroll
      for (int n = 0; n < PN; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) yacc[n][c] = 0.f;
      const bf16* crow = Cs + (16 * warp + g) * LDB;
#pragma unroll 4
      for (int k0 = 0; k0 < DS; k0 += 8) {
        const uint32_t af[4] = {
            tf32(crow[k0 + t]), tf32(crow[8 * LDB + k0 + t]),
            tf32(crow[k0 + t + 4]), tf32(crow[8 * LDB + k0 + t + 4])};
#pragma unroll
        for (int n = 0; n < PN; ++n) {
          const float* srow = St + (8 * n + g) * LDS + k0 + t;
          mma_tf32(yacc[n], af, tf32(srow[0]), tf32(srow[4]));
        }
      }
      const float e_lo = ecs[w0 + g], e_hi = ecs[w0 + g + 8];
#pragma unroll
      for (int n = 0; n < PN; ++n) {
        yacc[n][0] *= e_lo;
        yacc[n][1] *= e_lo;
        yacc[n][2] *= e_hi;
        yacc[n][3] *= e_hi;
      }

      // intra-chunk term over the key tiles at or below the diagonal
      for (int kj = 0; kj <= qi; ++kj) {
        const int j0 = kj * TQ;
        if (kj < qi || qi + 1 < ntq) {  // the next step's key tile
          const int jn = kj < qi ? j0 + TQ : 0;
          load_rows<DS, LDB>(Bs0 + (buf ^ 1) * TQ * LDB, Bc, bc_stride, jn,
                             Q, vec);
          load_rows<HPT, LDX>(Xs0 + (buf ^ 1) * TQ * LDX, Xc, x_stride, jn,
                              Q, vec);
        }
        cp_async_commit();
        cp_async_wait<1>();  // this step's tile landed
        __syncthreads();
        const bf16* Bs = Bs0 + buf * TQ * LDB;
        const bf16* Xs = Xs0 + buf * TQ * LDX;
        // 8-key column tiles of this warp at or below its last row
        const int nmax = kj < qi ? 8 : min(8, 2 * warp + 2);

        // scores: 16 rows x 64 keys per warp, bf16 products exact in fp32
        float s[8][4];
#pragma unroll
        for (int nj = 0; nj < 8; ++nj)
#pragma unroll
          for (int c = 0; c < 4; ++c) s[nj][c] = 0.f;
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          uint32_t af[4];
          ldsm_x4(af, Cs + (16 * warp + lr + ((lq & 1) << 3)) * LDB +
                          16 * ks + ((lq >> 1) << 3));
#pragma unroll
          for (int nj = 0; nj < 8; nj += 2) {
            if (nj >= nmax) break;
            uint32_t bf[4];
            ldsm_x4(bf, Bs + (8 * (nj + (lq >> 1)) + lr) * LDB + 16 * ks +
                            ((lq & 1) << 3));
            mma_bf16(s[nj], af, bf[0], bf[1]);
            mma_bf16(s[nj + 1], af, bf[2], bf[3]);
          }
        }

        // P = scores * exp(cs_i - cs_j) * dt_j where j <= i < Q, else 0.
        // s[nj][2 hh + v] is (row w0 + g + 8 hh, key j0 + 8 nj + 2 t + v).
#pragma unroll
        for (int nj = 0; nj < 8; ++nj) {
          if (nj >= nmax) break;
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int i = w0 + g + 8 * hh;
            const float ci = cs[i];
#pragma unroll
            for (int v = 0; v < 2; ++v) {
              const int j = j0 + 8 * nj + 2 * t + v;
              float& sv = s[nj][2 * hh + v];
              sv = j <= i && i < Q ? sv * exp2f(ci - cs[j]) * dts[j] : 0.f;
            }
          }
        }

        // y += P x, TF32 (P rounded): k slot t is key 2t, slot t + 4 key
        // 2t + 1, so the score accumulators are the A operand as they lie
#pragma unroll
        for (int kc = 0; kc < 8; ++kc) {
          if (kc >= nmax) break;
          const uint32_t af[4] = {tf32(s[kc][0]), tf32(s[kc][2]),
                                  tf32(s[kc][1]), tf32(s[kc][3])};
          const bf16* xr = Xs + (8 * kc + 2 * t) * LDX + g;
#pragma unroll
          for (int n = 0; n < PN; ++n)
            mma_tf32(yacc[n], af, tf32(xr[8 * n]), tf32(xr[LDX + 8 * n]));
        }

        if (kj == qi) {
          // state += (exp(cs_Q - cs_j) dt_j x_j)^T B_j over this key
          // tile, TF32 (the decayed x rounded): M = hp rows, N = ds, K = j
#pragma unroll 2
          for (int kk = 0; kk < TQ; kk += 8) {
            const float wlo = wd[j0 + kk + t], whi = wd[j0 + kk + t + 4];
            const bf16* xlo = Xs + (kk + t) * LDX;
            const bf16* xhi = xlo + 4 * LDX;
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
              const int pr = 16 * mt + g;
              const uint32_t af[4] = {
                  tf32(__bfloat162float(xlo[pr]) * wlo),
                  tf32(__bfloat162float(xlo[pr + 8]) * wlo),
                  tf32(__bfloat162float(xhi[pr]) * whi),
                  tf32(__bfloat162float(xhi[pr + 8]) * whi)};
#pragma unroll
              for (int r = 0; r < SN; ++r) {
                const int nt = warp + 4 * r;
                if (nt >= NTL) break;
                const bf16* bcol = Bs + (kk + t) * LDB + 8 * nt + g;
                mma_tf32(sacc[mt][r], af, tf32(bcol[0]),
                         tf32(bcol[4 * LDB]));
              }
            }
          }
        }
        __syncthreads();  // this buffer and Cs consumed before a refill
        buf ^= 1;
      }

      // y rows of this warp, fp32
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int i = w0 + g + 8 * hh;
        if (i >= Q) continue;
        float* yrow = y + ((b * S + t0 + i) * nh + h) * hp + p0;
#pragma unroll
        for (int n = 0; n < PN; ++n)
          *reinterpret_cast<float2*>(yrow + 8 * n + 2 * t) =
              make_float2(yacc[n][2 * hh], yacc[n][2 * hh + 1]);
      }
    }

    __syncthreads();  // every read of the old state done
    const float dl = exp2f(cl);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int r = 0; r < SN; ++r) {
        const int nt = warp + 4 * r;
        if (nt >= NTL) break;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          float* p = St + (16 * mt + g + 8 * hh) * LDS + 8 * nt + 2 * t;
          p[0] = p[0] * dl + sacc[mt][r][2 * hh];
          p[1] = p[1] * dl + sacc[mt][r][2 * hh + 1];
        }
      }
  }
  __syncthreads();
  float* so = state_out + ((b * nh + h) * hp + p0) * DS;
  for (int e = tid; e < HPT * DS; e += NT)
    so[e] = St[(e / DS) * LDS + e % DS];
}

// above 48 KB a block may use dynamic shared memory only after opting in
template <int HPT, int DS>
cudaError_t opt_in() {
  return cudaFuncSetAttribute(ssd_tc_kernel<HPT, DS>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              Layout<HPT, DS>::BYTES);
}

// blocks of one instance an SM holds at once
template <int HPT, int DS>
cudaError_t occupancy(int* blocks) {
  cudaError_t err = opt_in<HPT, DS>();
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, ssd_tc_kernel<HPT, DS>, NT, Layout<HPT, DS>::BYTES);
}

template <int HPT, int DS>
cudaError_t launch(const void* x, const void* dt, const void* A,
                   const void* Bg, const void* Cg, void* y, void* state,
                   int B, int S, int nh, int hp, int ng, int Q,
                   cudaStream_t stream) {
  constexpr int smem = Layout<HPT, DS>::BYTES;
  cudaError_t err = opt_in<HPT, DS>();
  if (err != cudaSuccess) return err;
  const int vec = ((uintptr_t)x | (uintptr_t)Bg | (uintptr_t)Cg) % 16 == 0;
  ssd_tc_kernel<HPT, DS><<<dim3(hp / HPT, nh, B), NT, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const bf16*>(Bg),
      static_cast<const bf16*>(Cg), static_cast<float*>(y),
      static_cast<float*>(state), S, nh, hp, ng, Q, vec);
  return cudaGetLastError();
}

}  // namespace tc

cudaError_t dispatch_f32(const void* x, const void* dt, const void* A,
                         const void* Bg, const void* Cg, void* y, void* state,
                         int B, int S, int nh, int hp, int ng, int ds, int Q,
                         cudaStream_t st) {
#define SSD_F32(HP, DS)                                                      \
  if (hp == HP && ds == DS)                                                  \
  return f32::launch<HP, DS>(x, dt, A, Bg, Cg, y, state, B, S, nh, ng, Q, st)
  SSD_F32(16, 16);
  SSD_F32(16, 128);
  SSD_F32(64, 16);
  SSD_F32(64, 128);
#undef SSD_F32
  return cudaErrorInvalidValue;
}

cudaError_t dispatch_tc(const void* x, const void* dt, const void* A,
                        const void* Bg, const void* Cg, void* y, void* state,
                        int B, int S, int nh, int hp, int ng, int ds, int Q,
                        int hp_tile, cudaStream_t st) {
#define SSD_TC(HPT, DS)                                                      \
  if (hp_tile == HPT && ds == DS)                                            \
  return tc::launch<HPT, DS>(x, dt, A, Bg, Cg, y, state, B, S, nh, hp, ng,  \
                             Q, st)
  if (hp % hp_tile) return cudaErrorInvalidValue;
  SSD_TC(16, 16);
  SSD_TC(16, 128);
  SSD_TC(32, 16);
  SSD_TC(32, 128);
  SSD_TC(64, 16);
  SSD_TC(64, 128);
#undef SSD_TC
  return cudaErrorInvalidValue;
}

}  // namespace

// Blocks of the bf16 instance (hp_tile, ds) one SM holds at once, into
// *blocks. Returns the query's cudaError_t.
extern "C" int ssd_scan_occupancy(int hp_tile, int ds, int* blocks) {
#define SSD_OCC(HPT, DS) \
  if (hp_tile == HPT && ds == DS) return tc::occupancy<HPT, DS>(blocks)
  SSD_OCC(16, 16);
  SSD_OCC(16, 128);
  SSD_OCC(32, 16);
  SSD_OCC(32, 128);
  SSD_OCC(64, 16);
  SSD_OCC(64, 128);
#undef SSD_OCC
  return cudaErrorInvalidValue;
}

// dtype (of x, B and C): 0 float32, 1 bfloat16. hp_tile: columns of hp a
// bf16 block owns (16, 32 or 64, dividing hp; the fp32 kernel takes all
// of hp and ignores it). Returns the launch's cudaError_t.
extern "C" int ssd_scan_fwd(const void* x, const void* dt, const void* A,
                            const void* Bg, const void* Cg, void* y,
                            void* state, int B, int S, int nh, int hp, int ng,
                            int ds, int chunk, int hp_tile, int dtype,
                            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (chunk < 1 || chunk > MAXQ || S % chunk || ng < 1 || nh % ng ||
      B > 65535 || nh > 65535)
    return cudaErrorInvalidValue;
  if (hp != 16 && hp != 64) return cudaErrorInvalidValue;
  if (dtype == 0)
    return dispatch_f32(x, dt, A, Bg, Cg, y, state, B, S, nh, hp, ng, ds,
                        chunk, st);
  if (dtype == 1)
    return dispatch_tc(x, dt, A, Bg, Cg, y, state, B, S, nh, hp, ng, ds,
                       chunk, hp_tile, st);
  return cudaErrorInvalidValue;
}

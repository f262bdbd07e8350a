// Chunked Mamba2 state-space-duality (SSD) scan for Hopper (sm_90a), bound
// through a plain C interface.
//
// Replaces the TPU kernel src/repro/kernels/mamba2_ssd/kernel.py
// (`ssd_call` / `ssd_kernel`), single B/C group.  Per chunk of Q steps:
//   y[q]  = sum_{t<=q} (C_q . B_t) exp(cs_q - cs_t) dt_t x_t     (intra)
//         + exp(cs_q) C_q . h_prev                              (inter)
//   h     = exp(cs_last) h_prev + sum_t exp(cs_last - cs_t) dt_t B_t x_t
// with cs the inclusive f32 prefix sum of dt·A inside the chunk.  Returns
// y in x's dtype and the final state h (B, H, P, N) in f32.
//
// What bounds it: operations.  Per chunk and head it does about
// Q²·(N + P)/2 + 2·Q·P·N multiply-adds on Q·(P + 2N + 1) input elements;
// at Q = 256 that is over a hundred flops a byte.
//
// Design: the TPU walks the chunk axis in order and carries h in VMEM.
// Hopper blocks run in no order, so the carry is taken out of the chunk
// walk and the scan runs as three device kernels behind one entry point:
// 1. Chunk states, grid (chunk, head, batch): cs (written to f32 scratch
//    (B, H, S)), the chunk's own state s_c = sum_t w_t x_t ⊗ B_t with
//    w_t = exp(cs_last - cs_t) dt_t (scratch (B, nc, H, P, N)) and
//    exp(cs_last) (scratch (B, nc, H)).
// 2. State passing, one thread per (batch, head, p, n): h_c =
//    exp(cs_last,c-1) h_c-1 + s_c-1 over the chunks in order, in place: each
//    chunk's slot ends up holding its carry-in; the last sum is the final
//    state.
// 3. Chunk outputs: the intra and inter terms above from the carry-in.
// Every chunk is independent in passes 1 and 3, so a batch-1 prefill of
// nc chunks gives nc x H blocks where one block per head walked them all.
//
// bf16 inputs take the tensor cores (mma.sync m16n8k16, f32 accumulators,
// operands from shared memory by ldmatrix):
// - Pass 1, 4 warps: s_c = (w·x)ᵀ·B over 64-step tiles.  w_t is formed
//   once a step; x comes 16 bytes a thread while B's tile is in flight by
//   cp.async.  The weighted x is split into bf16 hi + lo (two products), so
//   the state keeps about 16 bits of its operands and holds the
//   final-state bar of 1e-3.
// - Pass 3, 4 warps, one block per (64-step query tile, chunk; head pair,
//   batch), tiles walked longest-first: C·Bᵀ for a (query tile, source
//   tile) is formed once and shared by the block's two heads.  Its decay
//   exp(cs_q - cs_t)·dt_t is formed only for t <= q (the mask inside the
//   exponent) on the diagonal tile, and below it as exp(cs_q - cs_r) x
//   exp(cs_r - cs_t)·dt_t with r the source tile's last step (both factors
//   at most 1: 2 + 64 exponentials a tile and head, not 4096); the product
//   is split bf16 hi + lo as the A operand of the product with x,
//   straight from the accumulator registers (one bf16 rounding of it moves
//   y past the bf16 bar where terms cancel).  The inter term C·h_prevᵀ
//   reads the f32 carry-in from global memory, split bf16 hi + lo.  B and
//   x source tiles are double-buffered by cp.async: the next tile's copy is
//   in flight while this one is computed.
// f32 inputs take the same three passes with CUDA-core products in f32
// (256 threads, each holding 4 x 4 entries of a 64 x 64 product tile), for
// the f32 bars.
//
// A ragged last chunk reads zeros past S (decay 1, no input), so the final
// state equals the unpadded one; y past S is not written.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;  // query steps and source steps per tile
constexpr int kMaxSharedBytes = 232448;
constexpr int kF32Threads = 256;
constexpr int kTcThreads = 128;
constexpr int kHeads = 2;  // heads a pass-3 tensor-core block shares C·Bᵀ among

using bf16 = __nv_bfloat16;


struct Params {
  const void* x;    // (B, S, H, P)
  const float* dt;  // (B, S, H)
  const float* A;   // (H,)
  const void* Bm;   // (B, S, N)
  const void* Cm;   // (B, S, N)
  void* y;          // (B, S, H, P)
  float* h;         // (B, H, P, N)
  float* cs;        // (B, H, S) scratch: prefix sum of dt·A inside each chunk
  float* states;    // (B, nc, H, P, N) scratch: own state, then carry-in
  float* decay;     // (B, nc, H) scratch: exp(cs at the chunk's last step)
  int S, H, Q, nc;
};

// ------------------------------------------------------------ helpers
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x2_trans(uint32_t& r0, uint32_t& r1, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(smem_addr(p)));
}

// d += a·b, m16n8k16, bf16 operands, f32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// a pair of f32 values as bf16 hi and lo pairs: hi + lo carries ~16 bits
__device__ __forceinline__ void split_bf16(float2 u, uint32_t& hi, uint32_t& lo) {
  const bf16 hx = __float2bfloat16(u.x), hy = __float2bfloat16(u.y);
  __nv_bfloat162 h2;
  h2.x = hx;
  h2.y = hy;
  hi = *reinterpret_cast<uint32_t*>(&h2);
  lo = pack_bf16(u.x - __bfloat162float(hx), u.y - __bfloat162float(hy));
}

// Chunk c of head hh: dt into dts[0, len) and the inclusive prefix sum of
// dt·A into css[0, len), also written to the cs scratch.  Every thread
// loads dt (a strided column: all loads in flight at once), then warp 0
// scans, 32 steps at a time; every thread of the block calls it.
__device__ void chunk_scan(const Params& p, long long b, int c, int hh, float* dts, float* css) {
  const int c0 = c * p.Q, len = min(p.Q, p.S - c0);
  for (int t = threadIdx.x; t < len; t += blockDim.x) dts[t] = p.dt[(b * p.S + c0 + t) * p.H + hh];
  __syncthreads();
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    const float a = p.A[hh];
    float carry = 0.f;
    for (int t0 = 0; t0 < len; t0 += 32) {
      const int t = t0 + lane;
      float run = t < len ? dts[t] * a : 0.f;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float u = __shfl_up_sync(0xffffffffu, run, off);
        if (lane >= off) run += u;
      }
      run += carry;
      if (t < len) {
        css[t] = run;
        p.cs[(b * p.H + hh) * p.S + c0 + t] = run;
      }
      carry = __shfl_sync(0xffffffffu, run, 31);
    }
  }
  __syncthreads();
}

// ------------------------------------------- pass 1: chunk states, f32
template <int P, int N>
__global__ void __launch_bounds__(kF32Threads) ssd_states_f32(Params p) {
  constexpr int ns = N + 1;
  constexpr int PI = P / 16, NJ = N / 16;  // state rows / columns a thread holds
  extern __shared__ float smem[];
  float* dts = smem;
  float* css = dts + p.Q;
  float* Bt = css + p.Q;
  float* Xt = Bt + kTile * ns;

  const int c = blockIdx.x, hh = blockIdx.y;
  const long long b = blockIdx.z;
  const int tid = threadIdx.x, tr = tid >> 4, tc = tid & 15;
  const float* x = static_cast<const float*>(p.x);
  const float* Bm = static_cast<const float*>(p.Bm);
  chunk_scan(p, b, c, hh, dts, css);
  const int c0 = c * p.Q, len = min(p.Q, p.S - c0);
  const float cs_last = css[len - 1];
  for (int t = tid; t < len; t += kF32Threads) dts[t] *= expf(cs_last - css[t]);  // w_t
  __syncthreads();

  float h[PI][NJ];
#pragma unroll
  for (int i = 0; i < PI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) h[i][j] = 0.f;
  for (int t0 = 0; t0 < len; t0 += kTile) {
    __syncthreads();  // the last tile's readers are done with Bt, Xt
    for (int e = tid; e < kTile * N; e += kF32Threads) {
      const int j = e / N, n = e % N, t = t0 + j;
      Bt[j * ns + n] = t < len ? Bm[(b * p.S + c0 + t) * N + n] : 0.f;
    }
    for (int e = tid; e < kTile * P; e += kF32Threads) {
      const int j = e / P, pp = e % P, t = t0 + j;
      Xt[e] = t < len ? x[((b * p.S + c0 + t) * p.H + hh) * P + pp] * dts[t] : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int t = 0; t < kTile; ++t) {
      float xv[PI], bv[NJ];
#pragma unroll
      for (int i = 0; i < PI; ++i) xv[i] = Xt[t * P + tr + 16 * i];
#pragma unroll
      for (int j = 0; j < NJ; ++j) bv[j] = Bt[t * ns + tc + 16 * j];
#pragma unroll
      for (int i = 0; i < PI; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) h[i][j] = fmaf(xv[i], bv[j], h[i][j]);
    }
  }
  float* st = p.states + ((b * p.nc + c) * p.H + hh) * (long long)(P * N);
#pragma unroll
  for (int i = 0; i < PI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) st[(tr + 16 * i) * N + tc + 16 * j] = h[i][j];
  if (tid == 0) p.decay[(b * p.nc + c) * p.H + hh] = expf(cs_last);
}

// ------------------------------------- pass 1: chunk states, tensor cores
template <int P, int N>
__global__ void __launch_bounds__(kTcThreads) ssd_states_tc(Params p) {
  constexpr int XL = P + 8, BL = N + 8;   // shared row strides (bf16), 16-byte padded
  constexpr int RG = P / 16;              // 16-row groups of the state
  constexpr int CG = 4 / RG;              // column groups: RG x CG = 4 warps
  constexpr int NW = N / CG;              // state columns a warp holds
  constexpr int NT = NW / 8;              // its 8-column tiles
  static_assert(RG * CG == 4 && NW % 8 == 0, "warp tiling");
  extern __shared__ __align__(16) float smem[];
  const int qs = (p.Q + 3) & ~3;  // float arrays padded to 16 bytes
  float* dts = smem;
  float* css = dts + qs;
  bf16* Xh = reinterpret_cast<bf16*>(css + qs);  // (w·x) hi, [t][p]
  bf16* Xl = Xh + kTile * XL;                                  // (w·x) lo
  bf16* Bs = Xl + kTile * XL;                                  // B, [t][n]

  const int c = blockIdx.x, hh = blockIdx.y;
  const long long b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const bf16* x = static_cast<const bf16*>(p.x);
  const bf16* Bm = static_cast<const bf16*>(p.Bm);
  chunk_scan(p, b, c, hh, dts, css);
  const int c0 = c * p.Q, len = min(p.Q, p.S - c0);
  const float cs_last = css[len - 1];
  for (int t = tid; t < len; t += kTcThreads) dts[t] *= expf(cs_last - css[t]);  // w_t
  __syncthreads();
  const int pr = (warp % RG) * 16, n0 = (warp / RG) * NW;

  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[n][k] = 0.f;
  for (int t0 = 0; t0 < len; t0 += kTile) {
    for (int e = tid; e < kTile * (N / 8); e += kTcThreads) {
      const int j = e / (N / 8), cc = e % (N / 8), t = t0 + j;
      cp_async16(Bs + j * BL + cc * 8, Bm + (b * p.S + c0 + min(t, len - 1)) * N + cc * 8, t < len);
    }
    cp_async_commit();
#pragma unroll 2
    for (int e = tid; e < kTile * (P / 8); e += kTcThreads) {  // 8 values of x a thread
      const int j = e / (P / 8), cc = e % (P / 8), t = t0 + j;
      uint4 raw = make_uint4(0, 0, 0, 0);
      if (t < len) raw = *reinterpret_cast<const uint4*>(x + ((b * p.S + c0 + t) * p.H + hh) * P + cc * 8);
      const float w = t < len ? dts[t] : 0.f;
      const __nv_bfloat162* xv = reinterpret_cast<const __nv_bfloat162*>(&raw);
      uint4 hi4, lo4;
      uint32_t* hp = reinterpret_cast<uint32_t*>(&hi4);
      uint32_t* lp = reinterpret_cast<uint32_t*>(&lo4);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float2 f = __bfloat1622float2(xv[k]);
        split_bf16(make_float2(f.x * w, f.y * w), hp[k], lp[k]);
      }
      *reinterpret_cast<uint4*>(Xh + j * XL + cc * 8) = hi4;
      *reinterpret_cast<uint4*>(Xl + j * XL + cc * 8) = lo4;
    }
    cp_async_wait<0>();
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {  // steps kk·16 .. kk·16 + 15
      // A = (w·x)ᵀ: rows p, depth t; stored [t][p], so ldmatrix.trans
      const int ar = kk * 16 + (lane & 7) + ((lane >> 4) << 3);
      const int ac = pr + (((lane >> 3) & 1) << 3);
      uint32_t ah[4], al[4];
      ldsm_x4_trans(ah, Xh + ar * XL + ac);
      ldsm_x4_trans(al, Xl + ar * XL + ac);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        uint32_t b0, b1;  // B stored [t][n]: ldmatrix.trans
        ldsm_x2_trans(b0, b1, Bs + (kk * 16 + (lane & 7) + (((lane >> 3) & 1) << 3)) * BL + n0 + n * 8);
        mma_bf16(acc[n], ah, b0, b1);
        mma_bf16(acc[n], al, b0, b1);
      }
    }
    __syncthreads();  // the tile's readers are done before the next is written
  }
  float* st = p.states + ((b * p.nc + c) * p.H + hh) * (long long)(P * N);
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int col = n0 + n * 8 + 2 * t4;
    *reinterpret_cast<float2*>(st + (pr + g) * N + col) = make_float2(acc[n][0], acc[n][1]);
    *reinterpret_cast<float2*>(st + (pr + g + 8) * N + col) = make_float2(acc[n][2], acc[n][3]);
  }
  if (tid == 0) p.decay[(b * p.nc + c) * p.H + hh] = expf(cs_last);
}

// --------------------------------------------------- pass 2: state passing
__global__ void __launch_bounds__(256) ssd_pass_states(Params p, int B, int PN) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)B * p.H * PN) return;
  const long long b = i / ((long long)p.H * PN);
  const int hh = (int)(i / PN % p.H), e = (int)(i % PN);
  float run = 0.f;
  for (int c0 = 0; c0 < p.nc; c0 += 8) {  // 8 chunks' loads in flight at once
    float own[8], dec[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      if (c0 + k < p.nc) {
        own[k] = p.states[((b * p.nc + c0 + k) * p.H + hh) * PN + e];
        dec[k] = p.decay[(b * p.nc + c0 + k) * p.H + hh];
      }
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      if (c0 + k < p.nc) {
        p.states[((b * p.nc + c0 + k) * p.H + hh) * PN + e] = run;  // carry-in of the chunk
        run = dec[k] * run + own[k];
      }
    }
  }
  p.h[(b * p.H + hh) * PN + e] = run;
}

// ------------------------------------------ pass 3: chunk outputs, f32
template <int P, int N>
__global__ void __launch_bounds__(kF32Threads) ssd_outputs_f32(Params p) {
  constexpr int ns = N + 1, ms = kTile + 1;
  constexpr int PI = P / 16;
  extern __shared__ float smem[];
  float* Hs = smem;
  float* Cq = Hs + P * ns;
  float* Bt = Cq + kTile * ns;
  float* Xt = Bt + kTile * ns;
  float* Ms = Xt + kTile * P;
  float* dts = Ms + kTile * ms;
  float* cs = dts + p.Q;

  const int c = blockIdx.x, hh = blockIdx.y;
  const long long b = blockIdx.z;
  const int tid = threadIdx.x, tr = tid >> 4, tc = tid & 15;
  const float* x = static_cast<const float*>(p.x);
  const float* Bm = static_cast<const float*>(p.Bm);
  const float* Cm = static_cast<const float*>(p.Cm);
  float* y = static_cast<float*>(p.y);
  const int c0 = c * p.Q, len = min(p.Q, p.S - c0), S = p.S;

  const float* hin = p.states + ((b * p.nc + c) * p.H + hh) * (long long)(P * N);
  for (int e = tid; e < P * N; e += kF32Threads) Hs[(e / N) * ns + e % N] = hin[e];
  for (int t = tid; t < len; t += kF32Threads) {
    dts[t] = p.dt[(b * S + c0 + t) * p.H + hh];
    cs[t] = p.cs[(b * p.H + hh) * S + c0 + t];
  }
  __syncthreads();

  // one tile of query steps at a time; this thread holds
  // y[q0 + tr + 16i][tc + 16j] in registers
  for (int q0 = 0; q0 < len; q0 += kTile) {
    for (int e = tid; e < kTile * N; e += kF32Threads) {
      const int r = e / N, n = e % N;
      Cq[r * ns + n] = q0 + r < len ? Cm[(b * S + c0 + q0 + r) * N + n] : 0.f;
    }
    __syncthreads();
    // inter-chunk term: exp(cs_q) C_q . h_prev
    float yv[4][PI];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < PI; ++j) yv[i][j] = 0.f;
#pragma unroll 4
    for (int n = 0; n < N; ++n) {
      float cv[4], hv[PI];
#pragma unroll
      for (int i = 0; i < 4; ++i) cv[i] = Cq[(tr + 16 * i) * ns + n];
#pragma unroll
      for (int j = 0; j < PI; ++j) hv[j] = Hs[(tc + 16 * j) * ns + n];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < PI; ++j) yv[i][j] = fmaf(cv[i], hv[j], yv[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qq = q0 + tr + 16 * i;
      const float decay = qq < len ? expf(cs[qq]) : 0.f;
#pragma unroll
      for (int j = 0; j < PI; ++j) yv[i][j] *= decay;
    }
    // intra-chunk term over the source tiles up to this query tile's end
    const int q_end = min(q0 + kTile, len);
    for (int t0 = 0; t0 < q_end; t0 += kTile) {
      __syncthreads();  // the last tile's readers are done with Bt, Xt, Ms
      for (int e = tid; e < kTile * N; e += kF32Threads) {
        const int j = e / N, n = e % N, t = t0 + j;
        Bt[j * ns + n] = t < len ? Bm[(b * S + c0 + t) * N + n] : 0.f;
      }
      for (int e = tid; e < kTile * P; e += kF32Threads) {
        const int j = e / P, pp = e % P, t = t0 + j;
        Xt[e] = t < len ? x[((b * S + c0 + t) * p.H + hh) * P + pp] : 0.f;
      }
      __syncthreads();
      float mv[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mv[i][j] = 0.f;
#pragma unroll 4
      for (int n = 0; n < N; ++n) {
        float cv[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) cv[i] = Cq[(tr + 16 * i) * ns + n];
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = Bt[(tc + 16 * j) * ns + n];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) mv[i][j] = fmaf(cv[i], bv[j], mv[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int qq = q0 + tr + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int t = t0 + tc + 16 * j;
          Ms[(tr + 16 * i) * ms + tc + 16 * j] =
              (t <= qq && qq < len) ? mv[i][j] * expf(cs[qq] - cs[t]) * dts[t] : 0.f;
        }
      }
      __syncthreads();
#pragma unroll 4
      for (int t = 0; t < kTile; ++t) {
        float mv2[4], xv[PI];
#pragma unroll
        for (int i = 0; i < 4; ++i) mv2[i] = Ms[(tr + 16 * i) * ms + t];
#pragma unroll
        for (int j = 0; j < PI; ++j) xv[j] = Xt[t * P + tc + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < PI; ++j) yv[i][j] = fmaf(mv2[i], xv[j], yv[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qq = q0 + tr + 16 * i;
      if (qq >= len) continue;
      float* out = y + ((b * S + c0 + qq) * p.H + hh) * P;
#pragma unroll
      for (int j = 0; j < PI; ++j) out[tc + 16 * j] = yv[i][j];
    }
    __syncthreads();  // Cq is read no more for this tile
  }
}

// ---------------------------------- pass 3: chunk outputs, tensor cores
template <int P, int N>
__global__ void __launch_bounds__(kTcThreads) ssd_outputs_tc(Params p) {
  constexpr int CL = N + 8, XL = P + 8;  // shared row strides (bf16), 16-byte padded
  constexpr int KN = N / 16;             // k-steps over the state
  constexpr int NT = P / 8;              // 8-column tiles of y
  extern __shared__ __align__(16) float smem[];
  const int qs = (p.Q + 3) & ~3;   // per-head stride, padded to 16 bytes
  float* css = smem;               // [head][t], the chunk's cs
  float* dts = css + kHeads * qs;  // [head][t]
  float* ctf = dts + kHeads * qs;  // [head][64]: a source tile's column decay factors
  bf16* Cs = reinterpret_cast<bf16*>(ctf + kHeads * kTile);  // C, [q][n]
  bf16* Bs = Cs + kTile * CL;       // B, [buffer][t][n]
  bf16* Xs = Bs + 2 * kTile * CL;   // x, [buffer][head][t][p]

  const int nqt = (p.Q + kTile - 1) / kTile;
  const int c = blockIdx.x % p.nc, q0 = (nqt - 1 - blockIdx.x / p.nc) * kTile;  // longest first
  const int h0 = blockIdx.y * kHeads;
  const long long b = blockIdx.z;
  const int c0 = c * p.Q, len = min(p.Q, p.S - c0), S = p.S;
  if (q0 >= len) return;  // past a ragged last chunk: the whole block
  const int nh = min(kHeads, p.H - h0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const bf16* x = static_cast<const bf16*>(p.x);
  const bf16* Bm = static_cast<const bf16*>(p.Bm);
  const bf16* Cm = static_cast<const bf16*>(p.Cm);
  bf16* y = static_cast<bf16*>(p.y);

  const int q_end = min(q0 + kTile, len);  // the query tile is [q0, q_end)
  for (int e = tid; e < nh * q_end; e += kTcThreads) {
    const int hi = e / q_end, t = e % q_end;
    css[hi * qs + t] = p.cs[(b * p.H + h0 + hi) * S + c0 + t];
    dts[hi * qs + t] = p.dt[(b * S + c0 + t) * p.H + h0 + hi];
  }
  for (int e = tid; e < kTile * (N / 8); e += kTcThreads) {
    const int r = e / (N / 8), cc = e % (N / 8), t = q0 + r;
    cp_async16(Cs + r * CL + cc * 8, Cm + (b * S + c0 + min(t, len - 1)) * N + cc * 8, t < len);
  }
  cp_async_commit();
  // source steps [t0, t0 + 64) of B and of x (the block's heads) into
  // buffer `buf`, zeros past the chunk
  auto load_sources = [&](int t0, int buf) {
    bf16* bd = Bs + buf * kTile * CL;
    bf16* xd = Xs + buf * kHeads * kTile * XL;
    for (int e = tid; e < kTile * (N / 8); e += kTcThreads) {
      const int j = e / (N / 8), cc = e % (N / 8), t = t0 + j;
      cp_async16(bd + j * CL + cc * 8, Bm + (b * S + c0 + min(t, len - 1)) * N + cc * 8, t < len);
    }
    for (int e = tid; e < nh * kTile * (P / 8); e += kTcThreads) {
      const int hi = e / (kTile * (P / 8)), r = e % (kTile * (P / 8));
      const int j = r / (P / 8), cc = r % (P / 8), t = t0 + j;
      cp_async16(xd + (hi * kTile + j) * XL + cc * 8,
                 x + ((b * S + c0 + min(t, len - 1)) * p.H + h0 + hi) * P + cc * 8, t < len);
    }
  };
  load_sources(0, 0);  // in flight during the inter-chunk term
  cp_async_commit();
  cp_async_wait<1>();  // the C tile
  __syncthreads();

  int qrow[2];  // chunk step of this thread's two accumulator rows; -1 past the chunk
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int q = q0 + warp * 16 + g + 8 * i;
    qrow[i] = q < len ? q : -1;
  }
  const bf16* a_row = Cs + (warp * 16 + (lane & 15)) * CL + ((lane >> 4) << 3);

  float acc[kHeads][NT][4];
#pragma unroll
  for (int hi = 0; hi < kHeads; ++hi)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[hi][n][k] = 0.f;

  // inter-chunk term: exp(cs_q) C_q · h_prevᵀ, the f32 carry-in split hi + lo
  if (c > 0) {
#pragma unroll
    for (int hi = 0; hi < kHeads; ++hi) {
      if (hi >= nh) continue;
      const float* hp = p.states + ((b * p.nc + c) * p.H + h0 + hi) * (long long)(P * N);
#pragma unroll
      for (int kk = 0; kk < KN; ++kk) {
        uint32_t a[4];
        ldsm_x4(a, a_row + kk * 16);
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          // B[k = state n][col = p] = h[p][n]: each lane's pair is contiguous
          const float* hr = hp + (n * 8 + g) * N + kk * 16 + 2 * t4;
          uint32_t b0h, b0l, b1h, b1l;
          split_bf16(*reinterpret_cast<const float2*>(hr), b0h, b0l);
          split_bf16(*reinterpret_cast<const float2*>(hr + 8), b1h, b1l);
          mma_bf16(acc[hi][n], a, b0h, b1h);
          mma_bf16(acc[hi][n], a, b0l, b1l);
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float e = qrow[i] >= 0 ? expf(css[hi * qs + qrow[i]]) : 0.f;
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          acc[hi][n][2 * i] *= e;
          acc[hi][n][2 * i + 1] *= e;
        }
      }
    }
  }

  // intra-chunk term over the source tiles up to this query tile, double
  // buffered: the next tile's copy is in flight while this one is computed
  const int nsrc = q0 / kTile + 1;
  for (int si = 0; si < nsrc; ++si) {
    const int t0 = si * kTile;
    const bf16* Bt = Bs + (si & 1) * kTile * CL;
    const bf16* Xt = Xs + (si & 1) * kHeads * kTile * XL;
    if (si + 1 < nsrc) {
      load_sources(t0 + kTile, (si + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    if (t0 < q0) {
      // a source tile wholly before the query tile: exp(cs_q - cs_t) =
      // exp(cs_q - cs_r)·exp(cs_r - cs_t) with r its last step, both
      // factors at most 1; the column factors (with dt_t) once a tile
      for (int e = tid; e < nh * kTile; e += kTcThreads) {
        const int hi = e / kTile, j = e % kTile;
        const float* cq = css + hi * qs;
        ctf[e] = __expf(cq[t0 + kTile - 1] - cq[t0 + j]) * dts[hi * qs + t0 + j];
      }
    }
    __syncthreads();

    // C·Bᵀ for this warp's 16 query rows and the tile's 64 source steps
    float sc[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) sc[j][k] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KN; ++kk) {
      uint32_t a[4];
      ldsm_x4(a, a_row + kk * 16);
#pragma unroll
      for (int nn = 0; nn < 4; ++nn) {
        uint32_t bb[4];
        ldsm_x4(bb, Bt + (nn * 16 + (lane & 7) + ((lane >> 4) << 3)) * CL + kk * 16 +
                        (((lane >> 3) & 1) << 3));
        mma_bf16(sc[2 * nn], a, bb[0], bb[1]);
        mma_bf16(sc[2 * nn + 1], a, bb[2], bb[3]);
      }
    }

#pragma unroll
    for (int hi = 0; hi < kHeads; ++hi) {
      if (hi >= nh) continue;
      const float* cq = css + hi * qs;
      const float* dq = dts + hi * qs;
      // W = C·Bᵀ ⊙ exp(cs_q - cs_t)·dt_t for t <= q, as bf16 hi + lo A
      // fragments: one bf16 rounding of W alone moves y by more than the
      // bf16 bar where its terms cancel
      uint32_t wh[4][4], wl[4][4];
      if (t0 < q0) {  // below the diagonal: row factor x column factor
        const float cr = cq[t0 + kTile - 1];
        float rq[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) rq[i] = qrow[i] >= 0 ? __expf(cq[qrow[i]] - cr) : 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float2 ct = *reinterpret_cast<const float2*>(ctf + hi * kTile + 8 * j + 2 * t4);
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const float2 v = make_float2(sc[j][2 * i] * rq[i] * ct.x, sc[j][2 * i + 1] * rq[i] * ct.y);
            split_bf16(v, wh[j >> 1][(j & 1) * 2 + i], wl[j >> 1][(j & 1) * 2 + i]);
          }
        }
      } else {  // the diagonal tile: the decay formed only for t <= q
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            float2 v;
            const int t = t0 + 8 * j + 2 * t4, q = qrow[i];
            v.x = (q >= 0 && t <= q) ? sc[j][2 * i] * __expf(cq[q] - cq[t]) * dq[t] : 0.f;
            v.y = (q >= 0 && t + 1 <= q) ? sc[j][2 * i + 1] * __expf(cq[q] - cq[t + 1]) * dq[t + 1] : 0.f;
            split_bf16(v, wh[j >> 1][(j & 1) * 2 + i], wl[j >> 1][(j & 1) * 2 + i]);
          }
        }
      }
      const bf16* xs = Xt + hi * kTile * XL;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int nn = 0; nn < NT / 2; ++nn) {
          uint32_t bx[4];  // x stored [t][p]: ldmatrix.trans
          ldsm_x4_trans(bx, xs + (kk * 16 + (lane & 7) + (((lane >> 3) & 1) << 3)) * XL + nn * 16 +
                                ((lane >> 4) << 3));
          mma_bf16(acc[hi][2 * nn], wh[kk], bx[0], bx[1]);
          mma_bf16(acc[hi][2 * nn + 1], wh[kk], bx[2], bx[3]);
          mma_bf16(acc[hi][2 * nn], wl[kk], bx[0], bx[1]);
          mma_bf16(acc[hi][2 * nn + 1], wl[kk], bx[2], bx[3]);
        }
      }
    }
    __syncthreads();  // the tile's readers are done before its buffer is refilled
  }

#pragma unroll
  for (int hi = 0; hi < kHeads; ++hi) {
    if (hi >= nh) continue;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (qrow[i] < 0) continue;
      bf16* out = y + ((b * S + c0 + qrow[i]) * p.H + h0 + hi) * P;
#pragma unroll
      for (int n = 0; n < NT; ++n)
        *reinterpret_cast<uint32_t*>(out + n * 8 + 2 * t4) =
            pack_bf16(acc[hi][n][2 * i], acc[hi][n][2 * i + 1]);
    }
  }
}

// ----------------------------------------------------------- launches
template <typename K>
int set_shared(K kernel, size_t bytes) {
  if (bytes > (size_t)kMaxSharedBytes) return (int)cudaErrorInvalidValue;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

inline int pass_states(const Params& p, int B, int PN, cudaStream_t s) {
  const long long n = (long long)B * p.H * PN;
  ssd_pass_states<<<(unsigned)((n + 255) / 256), 256, 0, s>>>(p, B, PN);
  return (int)cudaGetLastError();
}

template <int P, int N>
int launch_f32(const Params& p, int B, cudaStream_t s) {
  const size_t b1 = sizeof(float) * (2 * p.Q + kTile * (N + 1) + kTile * P);
  const size_t b3 = sizeof(float) * (P * (N + 1) + 2 * kTile * (N + 1) + kTile * P +
                                     kTile * (kTile + 1) + 2 * p.Q);
  int err;
  if ((err = set_shared(ssd_states_f32<P, N>, b1))) return err;
  if ((err = set_shared(ssd_outputs_f32<P, N>, b3))) return err;
  const dim3 grid(p.nc, p.H, B);
  ssd_states_f32<P, N><<<grid, kF32Threads, b1, s>>>(p);
  if ((err = (int)cudaGetLastError())) return err;
  if ((err = pass_states(p, B, P * N, s))) return err;
  ssd_outputs_f32<P, N><<<grid, kF32Threads, b3, s>>>(p);
  return (int)cudaGetLastError();
}

template <int P, int N>
int launch_tc(const Params& p, int B, cudaStream_t s) {
  const int qpad = (p.Q + 3) & ~3;
  const size_t b1 = sizeof(float) * 2 * qpad + sizeof(bf16) * kTile * (2 * (P + 8) + (N + 8));
  const size_t b3 = sizeof(float) * kHeads * (2 * qpad + kTile) +
                    sizeof(bf16) * kTile * (3 * (N + 8) + 2 * kHeads * (P + 8));
  int err;
  if ((err = set_shared(ssd_states_tc<P, N>, b1))) return err;
  if ((err = set_shared(ssd_outputs_tc<P, N>, b3))) return err;
  ssd_states_tc<P, N><<<dim3(p.nc, p.H, B), kTcThreads, b1, s>>>(p);
  if ((err = (int)cudaGetLastError())) return err;
  if ((err = pass_states(p, B, P * N, s))) return err;
  const int nqt = (p.Q + kTile - 1) / kTile;
  ssd_outputs_tc<P, N><<<dim3(nqt * p.nc, (p.H + kHeads - 1) / kHeads, B), kTcThreads, b3, s>>>(p);
  return (int)cudaGetLastError();
}

template <bool TC>
int launch_dims(const Params& p, int P, int N, int B, cudaStream_t s) {
  if (P == 64 && N == 64) return TC ? launch_tc<64, 64>(p, B, s) : launch_f32<64, 64>(p, B, s);
  if (P == 64 && N == 128) return TC ? launch_tc<64, 128>(p, B, s) : launch_f32<64, 128>(p, B, s);
  if (P == 32 && N == 16) return TC ? launch_tc<32, 16>(p, B, s) : launch_f32<32, 16>(p, B, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32 (CUDA cores), 1 = bfloat16 (tensor cores); x, B, C and
// y share it; dt, A, h and the scratch are f32.  (P, N) must be one of the
// built pairs: (64, 64) zamba2-1.2b, (64, 128) mamba2-780m, (32, 16) their
// reduced configs.  Scratch: cs (B, H, S), states (B, nc, H, P, N), decay
// (B, nc, H) with nc = ceil(S / Q).  bf16 pointers 16-byte aligned.
extern "C" int mamba2_ssd(const void* x, const float* dt, const float* A, const void* Bm,
                          const void* Cm, void* y, float* h, float* cs, float* states,
                          float* decay, int B, int S, int H, int P, int N, int Q, int dtype,
                          void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || Q <= 0 || Q > S) return (int)cudaErrorInvalidValue;
  Params p{x, dt, A, Bm, Cm, y, h, cs, states, decay, S, H, Q, (S + Q - 1) / Q};
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case 0: return launch_dims<false>(p, P, N, B, s);
    case 1: return launch_dims<true>(p, P, N, B, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* mamba2_ssd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

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
// at Q = 256 that is over a hundred flops a byte.  This first kernel runs
// them on CUDA cores in f32.
//
// Design (simple first):
// - The TPU walks the chunk axis in order and carries h in VMEM.  Hopper
//   blocks run in no order, so one block per (head, batch) loops over the
//   chunks itself and keeps h (P, N) in f32 for the whole sequence: in
//   registers, spread over the block, with a shared copy per chunk for the
//   carry-in term.  Prefill is batch-1, so zamba2's 64 heads give 64 blocks
//   on 132 SMs; the chunk-parallel two-pass design is the later redesign.
// - The (Q, Q, heads) decay tensor the TPU kernel builds (and even the
//   (Q, Q) scores at Q = 256) does not fit a block.  The chunk is walked in
//   64 x 64 tiles of (query step, source step); M[q, t] is formed on the fly
//   and only for t <= q, so the decay exp(cs_q - cs_t) never sees a
//   positive exponent ("mask inside the exponent").
// - Register tiles: each of the 256 threads holds 4 x 4 entries of a
//   64 x 64 product tile (M, y, or a slice of h), so each step of a product
//   reads 8 words of shared memory for 16 multiply-adds.
// - A ragged last chunk reads zeros past S (dt = 0: decay 1, no input), so
//   the final state equals the unpadded one; y past S is not written.
// - Shared rows are padded by one word so the lanes of a warp hit distinct
//   banks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;  // query steps and source steps per tile
constexpr int kMaxSharedBytes = 232448;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

struct Params {
  const void* x;    // (B, S, H, P)
  const float* dt;  // (B, S, H)
  const float* A;   // (H,)
  const void* Bm;   // (B, S, N)
  const void* Cm;   // (B, S, N)
  void* y;          // (B, S, H, P)
  float* h;         // (B, H, P, N)
  int S, H, Q;
};

__host__ __device__ constexpr int shared_floats(int P, int N, int Q) {
  return P * (N + 1)               // state (carry-in copy)
         + kTile * (N + 1)         // C rows of a query tile
         + kTile * (N + 1)         // B rows of a source tile
         + kTile * P               // x rows of a source tile (f32)
         + kTile * (kTile + 1)     // M tile
         + 2 * Q;                  // dt and cumsum of dt·A over the chunk
}

template <typename T, int P, int N>
__global__ void __launch_bounds__(kThreads) ssd_fwd(Params p) {
  constexpr int ns = N + 1, ms = kTile + 1;
  constexpr int PI = P / 16, NJ = N / 16;  // state rows / columns a thread holds
  extern __shared__ float smem[];
  float* Hs = smem;
  float* Cq = Hs + P * ns;
  float* Bt = Cq + kTile * ns;
  float* Xt = Bt + kTile * ns;
  float* Ms = Xt + kTile * P;
  float* dts = Ms + kTile * ms;
  const int Q = p.Q, S = p.S;
  float* cs = dts + Q;

  const int hh = blockIdx.x;
  const long long b = blockIdx.y;
  const int tid = threadIdx.x;
  const int tr = tid >> 4, tc = tid & 15;
  const T* x = static_cast<const T*>(p.x);
  const T* Bm = static_cast<const T*>(p.Bm);
  const T* Cm = static_cast<const T*>(p.Cm);
  T* y = static_cast<T*>(p.y);
  const float a = p.A[hh];

  // this thread's slice of the state: h[tr + 16i][tc + 16j]
  float h[PI][NJ];
#pragma unroll
  for (int i = 0; i < PI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) h[i][j] = 0.f;

  // source rows [t0, t0 + kTile) of the chunk at c0 into Bt, and into Xt,
  // scaled by dt_t exp(cs_last - cs_t) when `weighted`; rows past the chunk
  // or past S are zeros
  auto load_sources = [&](int c0, int t0, bool weighted, float cs_last) {
    for (int e = tid; e < kTile * N; e += kThreads) {
      const int j = e / N, n = e % N;
      const int t = t0 + j;
      const long long s = c0 + t;
      Bt[j * ns + n] = (t < Q && s < S) ? to_f32(Bm[(b * S + s) * N + n]) : 0.f;
    }
    for (int e = tid; e < kTile * P; e += kThreads) {
      const int j = e / P, pp = e % P;
      const int t = t0 + j;
      const long long s = c0 + t;
      float xv = 0.f;
      if (t < Q && s < S) {
        xv = to_f32(x[((b * S + s) * p.H + hh) * P + pp]);
        if (weighted) xv *= dts[t] * expf(cs_last - cs[t]);
      }
      Xt[e] = xv;
    }
  };

  const int nchunks = (S + Q - 1) / Q;
  for (int c = 0; c < nchunks; ++c) {
    const int c0 = c * Q;
    __syncthreads();  // the last chunk is done with dts, cs, Hs, Bt, Xt
#pragma unroll
    for (int i = 0; i < PI; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) Hs[(tr + 16 * i) * ns + tc + 16 * j] = h[i][j];
    for (int t = tid; t < Q; t += kThreads) {
      const long long s = c0 + t;
      dts[t] = s < S ? p.dt[(b * S + s) * p.H + hh] : 0.f;
    }
    __syncthreads();
    if (tid == 0) {  // inclusive prefix sum of dt·A, in step order
      float run = 0.f;
      for (int t = 0; t < Q; ++t) {
        run += dts[t] * a;
        cs[t] = run;
      }
    }
    __syncthreads();

    // ---- outputs, one tile of query steps at a time; this thread holds
    // y[q0 + tr + 16i][tc + 16j] in registers
    for (int q0 = 0; q0 < Q; q0 += kTile) {
      for (int e = tid; e < kTile * N; e += kThreads) {
        const int r = e / N, n = e % N;
        const long long s = c0 + q0 + r;
        Cq[r * ns + n] = (q0 + r < Q && s < S) ? to_f32(Cm[(b * S + s) * N + n]) : 0.f;
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
        const float decay = qq < Q ? expf(cs[qq]) : 0.f;
#pragma unroll
        for (int j = 0; j < PI; ++j) yv[i][j] *= decay;
      }
      // intra-chunk term over the source tiles up to this query tile's end
      const int q_end = min(q0 + kTile, Q);
      for (int t0 = 0; t0 < q_end; t0 += kTile) {
        __syncthreads();  // the last tile's readers are done with Bt, Xt, Ms
        load_sources(c0, t0, false, 0.f);
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
            const float m = (t <= qq && qq < Q) ? mv[i][j] * expf(cs[qq] - cs[t]) * dts[t] : 0.f;
            Ms[(tr + 16 * i) * ms + tc + 16 * j] = m;
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
        const int r = tr + 16 * i;
        const long long s = c0 + q0 + r;
        if (q0 + r >= Q || s >= S) continue;
        T* out = y + ((b * S + s) * p.H + hh) * P;
#pragma unroll
        for (int j = 0; j < PI; ++j) out[tc + 16 * j] = from_f32<T>(yv[i][j]);
      }
      __syncthreads();  // Cq is read no more for this tile
    }

    // ---- state: h = exp(cs_last) h + sum_t exp(cs_last - cs_t) dt_t B_t x_t
    const float cs_last = cs[Q - 1];
    const float decay = expf(cs_last);
#pragma unroll
    for (int i = 0; i < PI; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) h[i][j] *= decay;
    for (int t0 = 0; t0 < Q; t0 += kTile) {
      __syncthreads();
      load_sources(c0, t0, true, cs_last);
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
  }
  float* hout = p.h + (b * p.H + hh) * (long long)(P * N);
#pragma unroll
  for (int i = 0; i < PI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) hout[(tr + 16 * i) * N + tc + 16 * j] = h[i][j];
}

template <typename T, int P, int N>
int launch(const Params& p, int B, cudaStream_t stream) {
  const size_t bytes = sizeof(float) * (size_t)shared_floats(P, N, p.Q);
  if (bytes > (size_t)kMaxSharedBytes) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      ssd_fwd<T, P, N>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(p.H, B);
  ssd_fwd<T, P, N><<<grid, kThreads, bytes, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dims(const Params& p, int P, int N, int B, cudaStream_t s) {
  if (P == 64 && N == 64) return launch<T, 64, 64>(p, B, s);
  if (P == 64 && N == 128) return launch<T, 64, 128>(p, B, s);
  if (P == 32 && N == 16) return launch<T, 32, 16>(p, B, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, B, C and y share it; dt, A and h are
// f32).  (P, N) must be one of the built pairs: (64, 64) zamba2-1.2b,
// (64, 128) mamba2-780m, (32, 16) their reduced configs.
extern "C" int mamba2_ssd(const void* x, const float* dt, const float* A, const void* Bm,
                          const void* Cm, void* y, float* h, int B, int S, int H, int P, int N,
                          int Q, int dtype, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || Q <= 0) return (int)cudaErrorInvalidValue;
  Params p{x, dt, A, Bm, Cm, y, h, S, H, Q};
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case 0: return launch_dims<float>(p, P, N, B, s);
    case 1: return launch_dims<__nv_bfloat16>(p, P, N, B, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* mamba2_ssd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

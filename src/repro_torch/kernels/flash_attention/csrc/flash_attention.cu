// Blocked online-softmax (flash) attention for Hopper (sm_90a), bound
// through a plain C interface.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py
// (`flash_attention_call` / `flash_attention_kernel`): causal and
// sliding-window attention with grouped-query heads, fp32 running
// (max, denominator, numerator), rows with no reachable key guarded
// (l == 0 -> divisor 1), output in q's dtype.
//
// What bounds it: operations.  Prefill attention does 4·S²·hd/2 flops a head
// (causal) on 4·S·hd input and output bytes a head, hundreds of flops a byte,
// far above the card's balance point, so the products belong on the tensor
// cores.
//
// Routes, chosen by dtype:
//
// bf16 -> `flash_attention_wgmma`: both products on the tensor cores by
// wgmma, K/V by TMA, warp-specialised.
// - One block per (query tile, KV head, batch): one or two consumer
//   warpgroups of 64 query rows and one producer warp.  The tile holds the
//   G = H / KV query heads of its KV head at rows pos·G + g (64 / G or
//   128 / G positions; the wrapper takes 128 rows at G >= 4), so each K/V
//   tile is loaded once for all G heads: the TPU kernel's GQA fold.  G = 5,
//   6 or 12 leave a few rows unused.  Query tiles are walked longest-first.
// - TMA tensor maps describe the model layout directly: (hd, H, S, B) with
//   a box of (64, G, positions, 1) for Q, (hd, KV, S, B) with (64, 1, 64, 1)
//   for K and V, one box per 64-column block of a row (a 128-byte swizzle
//   row), zero fill past S and past hd (hd 16 and 32, hd 96's second
//   block).  The producer thread loads Q once, then keeps the reachable
//   64-key K/V tiles (to the causal end, from the window's start; no other
//   tile is loaded) in a 2-stage ring, each stage a full/empty mbarrier
//   pair.  (3 and 4 stages measured no faster on the H100.)
// - S = Q·Kᵀ: wgmma m64n64k16, Q and K from shared memory through 128-byte
//   swizzle descriptors (K stored (key, d) is K-major already); a 16-column
//   step moves the start address 32 bytes inside the swizzle atom.
// - O += P·V: wgmma m64n(hd)k16 with A = P from registers (the f32
//   accumulator layout is the A fragment layout; rounded to bf16 in place)
//   and B = V as stored, (key, d), through an MN-major descriptor with the
//   transpose bit: nothing is transposed in memory.  hd 192 holds 96 f32
//   accumulators a thread.
// - Softmax in registers, in the log2 domain (ex2.approx of
//   scale·log2e·s).  The row max reduces over the 4 lanes that share an
//   accumulator row; the row sum is kept per lane and reduced once at the
//   end.  Masks are exact (causal, window, kpos < S) and applied only on
//   tiles that cross an edge; a masked score never contributes
//   (probability 0), so any S is taken.
// - cuTensorMapEncodeTiled is reached through cudaGetDriverEntryPoint (no
//   -lcuda); the maps are __grid_constant__ parameters.
// - What limits it now: inside a warpgroup Q·Kᵀ, the softmax and P·V run
//   one after the other, each product waited for; only other warpgroups on
//   the SM overlap them.
// - Called for autograd it also writes each row's log-sum-exp of the scaled
//   scores, (B, H, S) in f32: one store in the epilogue, which holds the
//   row max and sum already.  The output's arithmetic is unchanged.
//
// The backward (bf16 only; the TPU kernel has none, so it replaces nothing:
// it lets training take the kernel).  Like the forward it is bound by
// operations, 5 products against the forward's 2, so every product runs on
// the tensor cores by wgmma with the operands by TMA, in FA2 form, and no
// S x S tensor reaches device memory:
// - `flash_attention_bwd_delta`: Δ = rowsum(dO ∘ O) in f32, a warp a row.
// - `flash_attention_bwd_dkdv`: one block per (64-key tile, KV head,
//   batch), one consumer warpgroup and one producer warp.  K and V are
//   loaded once; the producer walks only the query tiles that reach the
//   keys (causal, window), each tile the G query heads of the KV head
//   folded as in the forward, Q and dO by TMA and the rows' lse and Δ by
//   the producer's lanes, in a 2-stage ring.  Per tile, with the keys as
//   the rows: Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ (both operands from shared
//   memory), Pᵀ = exp2(Sᵀ·scale·log2e − lse·log2e), dSᵀ = Pᵀ ∘ (dPᵀ − Δ),
//   then dV += Pᵀ·dO and dK += dSᵀ·Q with Pᵀ and dSᵀ as bf16 register A
//   fragments and dO and Q as stored (MN-major, as V in the forward).  dK
//   and dV stay in f32 registers for the whole walk: no atomics, and the G
//   heads of a KV head are summed in f32 before the one bf16 store.
// - `flash_attention_bwd_dq`: the forward's grid and ring (one block per
//   query tile, K/V tiles streamed), with Q and dO loaded once: S = Q·Kᵀ
//   and dP = dO·Vᵀ again, dS as above, dQ += dS·K (K as stored).  Two
//   kernels recompute S and dP (7 products, not 5) but every gradient is
//   written once by one block: deterministic, no f32 scratch, no atomics.
// - Masks are exact (causal, window, kpos < S, rows past the sequence and
//   the head fold's unused rows) and applied only on tiles that cross an
//   edge; a masked pair gets P = dS = 0 by a select, never by arithmetic on
//   a masked score.  The fold's unused rows of Q and dO are zeroed once, so
//   a garbage row never enters dK or dV.
// - hd 128 and 192 hold dK and dV at 64 and 96 f32 registers a thread
//   each; at hd 192 the compiler spills (the report `-Xptxas=-v` prints).
//
// f32 -> `flash_attention_fwd`, products on CUDA cores in f32.  The
// reference's f32 bar (2e-5) takes neither bf16 nor TF32 products, and
// only the f32 consistency runs use f32:
// - One block of 256 threads per (64-row query tile, KV head, batch), the
//   same GQA fold; inputs widened to f32 in shared memory (rows padded by
//   one word); each thread holds 4 rows x 4 keys of the 64 x 64 scores and
//   the same 4 rows x HD/16 columns of the numerator; the 16 threads that
//   share rows reduce the row max and sum with shuffles.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 64;      // query rows a block holds (padded)
constexpr int kKeyBlock = 64;  // keys per tile
constexpr float kNegInf = -1e30f;
constexpr int kMaxSharedBytes = 232448;  // 227 KB, the most a block may use

__device__ __forceinline__ float to_f32(float x) { return x; }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }

struct Params {
  const void* q;  // (B, S, H, hd)
  const void* k;  // (B, S, KV, hd)
  const void* v;  // (B, S, KV, hd)
  void* o;        // (B, S, H, hd)
  int S, H, KV, G, qb;
  int causal, window;
  float scale;
  float* lse;     // (B, H, S) or null: the rows' log-sum-exp (bf16 route)
};

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__host__ __device__ constexpr int shared_floats(int hd) {
  return kRows * (hd + 1)               // Q tile, padded rows
         + kKeyBlock * (hd + 1)         // K tile, padded rows
         + kKeyBlock * hd               // V tile
         + kRows * (kKeyBlock + 1);     // probabilities, padded rows
}

__device__ __forceinline__ bool attend(int qpos, int kpos, int S, int causal, int window) {
  bool ok = kpos < S;
  if (causal) ok = ok && kpos <= qpos;
  if (window > 0) ok = ok && kpos > qpos - window;
  return ok;
}

// max / sum over the 16 lanes that share a row group (xor offsets < 16 stay
// inside a half warp)
__device__ __forceinline__ float group_max(float x) {
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float group_sum(float x) {
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) flash_attention_fwd(Params p) {
  constexpr int qs = HD + 1, ks = HD + 1, ps = kKeyBlock + 1;
  constexpr int DD = HD / 16;  // numerator columns a thread holds
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + kRows * qs;
  float* Vs = Ks + kKeyBlock * ks;
  float* Ps = Vs + kKeyBlock * HD;

  const int G = p.G, rows = G * p.qb;
  const int q0 = blockIdx.x * p.qb;
  const int kvh = blockIdx.y;
  const long long b = blockIdx.z;
  const int tid = threadIdx.x;
  const int tr = tid >> 4, tc = tid & 15;  // this thread: rows tr + 16i, keys tc + 16j
  const T* q = static_cast<const T*>(p.q);
  const T* k = static_cast<const T*>(p.k);
  const T* v = static_cast<const T*>(p.v);
  T* o = static_cast<T*>(p.o);

  // block row r is query position q0 + r / G of head kvh·G + r % G; rows
  // past `rows` or past S are zeros and never written
  for (int e = tid; e < kRows * HD; e += kThreads) {
    const int r = e / HD, d = e % HD;
    const int s = q0 + r / G, h = kvh * G + r % G;
    Qs[r * qs + d] = (r < rows && s < p.S) ? to_f32(q[((b * p.S + s) * p.H + h) * HD + d]) : 0.f;
  }

  int qpos[4];
  float m[4], l[4], acc[4][DD];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = tr + 16 * i;
    qpos[i] = r < rows ? q0 + r / G : -1;  // -1: a padding row attends nothing
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int dd = 0; dd < DD; ++dd) acc[i][dd] = 0.f;
  }

  // reachable keys: [k_begin, k_end)
  const int q_last = min(q0 + p.qb, p.S) - 1;
  int k_begin = p.window > 0 ? max(0, q0 - p.window + 1) : 0;
  k_begin = k_begin / kKeyBlock * kKeyBlock;
  const int k_end = p.causal ? q_last + 1 : p.S;

  for (int kt = k_begin; kt < k_end; kt += kKeyBlock) {
    __syncthreads();  // the last tile's readers are done with Ks, Vs and Ps
    for (int e = tid; e < kKeyBlock * HD; e += kThreads) {
      const int j = e / HD, d = e % HD;
      const int kpos = kt + j;
      float kv = 0.f, vv = 0.f;
      if (kpos < p.S) {
        const long long off = ((b * p.S + kpos) * p.KV + kvh) * HD + d;
        kv = to_f32(k[off]);
        vv = to_f32(v[off]);
      }
      Ks[j * ks + d] = kv;
      Vs[j * HD + d] = vv;
    }
    __syncthreads();

    // scores of rows tr + 16i against keys tc + 16j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(tr + 16 * i) * qs + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tc + 16 * j) * ks + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    // online softmax; the 16 threads of a row group hold identical (m, l)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      bool ok[4];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        ok[j] = qpos[i] >= 0 && attend(qpos[i], kt + tc + 16 * j, p.S, p.causal, p.window);
        s[i][j] = ok[j] ? s[i][j] * p.scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], group_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float pv = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        Ps[(tr + 16 * i) * ps + tc + 16 * j] = pv;
        sum += pv;
      }
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + group_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int dd = 0; dd < DD; ++dd) acc[i][dd] *= corr;
    }
    __syncthreads();

    // numerator: acc += P·V over the tile's keys
#pragma unroll 4
    for (int j = 0; j < kKeyBlock; ++j) {
      float pv[4], vv[DD];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(tr + 16 * i) * ps + j];
#pragma unroll
      for (int dd = 0; dd < DD; ++dd) vv[dd] = Vs[j * HD + tc + 16 * dd];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int dd = 0; dd < DD; ++dd) acc[i][dd] = fmaf(pv[i], vv[dd], acc[i][dd]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = tr + 16 * i;
    const int s = q0 + r / G, h = kvh * G + r % G;
    if (r >= rows || s >= p.S) continue;
    const float inv = 1.f / (l[i] == 0.f ? 1.f : l[i]);  // no reachable key: output 0
    T* out = o + ((b * p.S + s) * p.H + h) * HD;
#pragma unroll
    for (int dd = 0; dd < DD; ++dd) out[tc + 16 * dd] = from_f32<T>(acc[i][dd] * inv);
  }
}


// ------------------------------------------------ bf16, tensor cores
using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// two floats as a bf16 pair, the first in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// d (+)= A·Bᵀ, m64n64k16: A and B from shared memory, K-major
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate)
      : "memory");
}

// d += A·B, m64n16k16: A from registers, B from shared memory stored
// (k, n) with n contiguous (MN-major, the transpose bit set)
__device__ __forceinline__ void wgmma_rs_n16(float (&d)[8], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1)
      : "memory");
}

// d += A·B, m64n32k16: A from registers, B from shared memory stored
// (k, n) with n contiguous (MN-major, the transpose bit set)
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1)
      : "memory");
}

// d += A·B, m64n64k16: A from registers, B from shared memory stored
// (k, n) with n contiguous (MN-major, the transpose bit set)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1)
      : "memory");
}

// d += A·B, m64n96k16: A from registers, B from shared memory stored
// (k, n) with n contiguous (MN-major, the transpose bit set)
__device__ __forceinline__ void wgmma_rs_n96(float (&d)[48], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, {%48, %49, %50, %51}, %52, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1)
      : "memory");
}

// d += A·B, m64n128k16: A from registers, B from shared memory stored
// (k, n) with n contiguous (MN-major, the transpose bit set)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1)
      : "memory");
}

// d += A·B, m64n192k16: A from registers, B from shared memory stored
// (k, n) with n contiguous (MN-major, the transpose bit set)
__device__ __forceinline__ void wgmma_rs_n192(float (&d)[96], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, {%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1)
      : "memory");
}

// ------------------------------------------------- wgmma + TMA
constexpr int kWgStages = 2;        // K/V ring depth
constexpr int kSwizzleBlock = 8192; // one 64-row x 64-column bf16 block, 128-byte swizzled

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets (16-byte units), layout 1 in bits 62-63
__device__ __forceinline__ uint64_t sw128_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// pins the registers an asynchronous wgmma wrote: no use of them moves
// above this point (placed right after the wait)
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count));
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// a 4-d TMA tile load into shared memory, completion counted on `bar`
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                            int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// WG consumer warpgroups of 64 query rows each (warps 0 .. 4·WG - 1), and
// one producer warp (warp 4·WG)
template <int HD, int WG>
struct WgShape {
  static constexpr int NB = (HD + 63) / 64;  // 64-column blocks of a row
  static constexpr int threads = 128 * WG + 32;
  static constexpr int bytes = 1024 /* alignment slack */ +
                               (NB * WG + 2 * kWgStages * NB) * kSwizzleBlock +
                               (2 * kWgStages + 1) * 8 /* barriers */;
};

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <int HD> __device__ __forceinline__ void wgmma_pv(float (&d)[HD / 2], const uint32_t (&a)[4], uint64_t db);
template <> __device__ __forceinline__ void wgmma_pv<16>(float (&d)[8], const uint32_t (&a)[4], uint64_t db) { wgmma_rs_n16(d, a, db); }
template <> __device__ __forceinline__ void wgmma_pv<32>(float (&d)[16], const uint32_t (&a)[4], uint64_t db) { wgmma_rs_n32(d, a, db); }
template <> __device__ __forceinline__ void wgmma_pv<64>(float (&d)[32], const uint32_t (&a)[4], uint64_t db) { wgmma_rs_n64(d, a, db); }
template <> __device__ __forceinline__ void wgmma_pv<96>(float (&d)[48], const uint32_t (&a)[4], uint64_t db) { wgmma_rs_n96(d, a, db); }
template <> __device__ __forceinline__ void wgmma_pv<128>(float (&d)[64], const uint32_t (&a)[4], uint64_t db) { wgmma_rs_n128(d, a, db); }
template <> __device__ __forceinline__ void wgmma_pv<192>(float (&d)[96], const uint32_t (&a)[4], uint64_t db) { wgmma_rs_n192(d, a, db); }

template <int HD, int WG>
__global__ void __launch_bounds__(WgShape<HD, WG>::threads)
    flash_attention_wgmma(Params p, const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv) {
  constexpr int NB = WgShape<HD, WG>::NB;
  constexpr int QBLOCK = WG * kSwizzleBlock;  // one 64-column block of all the query rows
  constexpr int KS = HD / 16;  // k-steps of Q·Kᵀ
  extern __shared__ unsigned char smem_raw[];
  // 128-byte swizzled blocks need 1024-byte aligned bases
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* Qs = base;                                  // [NB][64·WG rows][128 B]
  unsigned char* Ks = Qs + NB * QBLOCK;                      // [stage][NB][64 keys][128 B]
  unsigned char* Vs = Ks + kWgStages * NB * kSwizzleBlock;   // [stage][NB][64 keys][128 B]
  uint64_t* full = reinterpret_cast<uint64_t*>(Vs + kWgStages * NB * kSwizzleBlock);
  uint64_t* empty = full + kWgStages;
  uint64_t* qbar = empty + kWgStages;

  const int G = p.G, rows = G * p.qb;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * p.qb;  // longest first
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  const int q_last = min(q0 + p.qb, p.S) - 1;
  int k_begin = p.window > 0 ? max(0, q0 - p.window + 1) : 0;
  k_begin = k_begin / kKeyBlock * kKeyBlock;
  const int k_end = p.causal ? q_last + 1 : p.S;
  const int ntiles = (k_end - k_begin + kKeyBlock - 1) / kKeyBlock;

  if (tid == 0) {
    for (int s = 0; s < kWgStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 128 * WG);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4 * WG) {  // ---- producer: one thread keeps the TMA loads in flight
    if (lane == 0) {
      mbar_expect_tx(qbar, NB * 128 * rows);
      for (int j = 0; j < NB; ++j) tma_load_4d(Qs + j * QBLOCK, &tq, qbar, 64 * j, kvh * G, q0, b);
      for (int it = 0; it < ntiles; ++it) {
        const int s = it % kWgStages;
        if (it >= kWgStages) mbar_wait(&empty[s], (it / kWgStages - 1) & 1);
        mbar_expect_tx(&full[s], 2 * NB * kSwizzleBlock);
        const int kt = k_begin + it * kKeyBlock;
        for (int j = 0; j < NB; ++j) {
          tma_load_4d(Ks + (s * NB + j) * kSwizzleBlock, &tk, &full[s], 64 * j, kvh, kt, b);
          tma_load_4d(Vs + (s * NB + j) * kSwizzleBlock, &tv, &full[s], 64 * j, kvh, kt, b);
        }
      }
    }
    return;
  }

  // ---- consumer warpgroups: 16 query rows a warp
  const int g = lane >> 2, t4 = lane & 3;
  const unsigned char* Qw = Qs + (warp >> 2) * kSwizzleBlock;  // this warpgroup's 64 rows
  int qpos[2];  // -1: a padding row, attends nothing
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = warp * 16 + g + 8 * i;
    qpos[i] = (r < rows && q0 + r / G < p.S) ? q0 + r / G : -1;
  }
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[HD / 2];
#pragma unroll
  for (int n = 0; n < HD / 2; ++n) acc[n] = 0.f;
  const float sl2 = p.scale * kLog2e;

  mbar_wait(qbar, 0);
  for (int it = 0; it < ntiles; ++it) {
    const int st = it % kWgStages;
    mbar_wait(&full[st], (it / kWgStages) & 1);
    const unsigned char* kd = Ks + st * NB * kSwizzleBlock;
    const unsigned char* vd = Vs + st * NB * kSwizzleBlock;
    const int kt = k_begin + it * kKeyBlock;

    // S = Q·Kᵀ: both K-major in 128-byte swizzled blocks; a 16-column step
    // moves the start address 32 bytes inside the swizzle atom
    float s[32];
#pragma unroll
    for (int n = 0; n < 32; ++n) s[n] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const int col = (kk & 3) * 32;
      wgmma_ss_n64(s, sw128_desc(Qw + (kk >> 2) * QBLOCK + col, 16, 1024),
                   sw128_desc(kd + (kk >> 2) * kSwizzleBlock + col, 16, 1024), kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);

    // online softmax; accumulator n-tile j holds s[4j .. 4j + 3]: rows g
    // (s[4j], s[4j + 1]) and g + 8 (s[4j + 2], s[4j + 3]), keys 8j + 2·t4 + {0, 1}
    const bool edge = kt + kKeyBlock > p.S || (p.causal && kt + kKeyBlock - 1 > q0) ||
                      (p.window > 0 && kt <= q_last - p.window);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float& x = s[4 * j + 2 * i + c];
          const bool ok =
              !edge || (qpos[i] >= 0 && attend(qpos[i], kt + 8 * j + 2 * t4 + c, p.S, p.causal, p.window));
          x = ok ? x * sl2 : kNegInf;
          mx = fmaxf(mx, x);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[i], mx);
      const float corr = fast_exp2(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float& x = s[4 * j + 2 * i + c];
          x = x == kNegInf ? 0.f : fast_exp2(x - m_new);
          sum += x;
        }
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int n = 0; n < HD / 8; ++n) {
        acc[4 * n + 2 * i] *= corr;
        acc[4 * n + 2 * i + 1] *= corr;
      }
    }

    // O += P·V: P as register A fragments (the accumulator layout is the A
    // layout), V MN-major: 16 keys a step = 2048 bytes, 64-column blocks
    // kSwizzleBlock apart
    uint32_t a[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      a[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
      a[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
      a[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
      a[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_pv<HD>(acc, a[kk], sw128_desc(vd + kk * 2048, kSwizzleBlock, 1024));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    mbar_arrive(&empty[st]);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float li = l[i];
    li += __shfl_xor_sync(0xffffffffu, li, 1);
    li += __shfl_xor_sync(0xffffffffu, li, 2);
    if (qpos[i] < 0) continue;
    const int r = warp * 16 + g + 8 * i;
    const int h = kvh * G + r % G;
    const float inv = 1.f / (li == 0.f ? 1.f : li);  // no reachable key: output 0
    bf16* out = static_cast<bf16*>(p.o) + (((long long)b * p.S + qpos[i]) * p.H + h) * HD;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
      *reinterpret_cast<uint32_t*>(out + n * 8 + 2 * t4) =
          pack_bf16(acc[4 * n + 2 * i] * inv, acc[4 * n + 2 * i + 1] * inv);
    // m is in the log2 domain of the scaled scores: lse = (m + log2 l)·ln 2
    if (p.lse != nullptr && t4 == 0)
      p.lse[((long long)b * p.H + h) * p.S + qpos[i]] =
          li == 0.f ? __int_as_float(0x7f800000) : (m[i] + log2f(li)) * kLn2;
  }
}

// ------------------------------------------------------------ backward
struct BwdParams {
  const void* q;     // (B, S, H, hd) bf16
  const void* k;     // (B, S, KV, hd)
  const void* v;     // (B, S, KV, hd)
  const void* o;     // (B, S, H, hd), the forward's output
  const void* dout;  // (B, S, H, hd)
  const float* lse;  // (B, H, S), the forward's
  float* delta;      // (B, H, S), written by the pre-pass
  void* dq;          // (B, S, H, hd)
  void* dk;          // (B, S, KV, hd)
  void* dv;          // (B, S, KV, hd)
  int S, H, KV, G, qb;
  int causal, window;
  float scale;
};

// one 64-row query tile (G heads x qb positions) per step of either kernel;
// one consumer warpgroup and one producer warp
constexpr int kBwdThreads = 160;

template <int HD>
struct BwdShape {
  static constexpr int NB = (HD + 63) / 64;
  // K, V, then the ring of (Q, dO) tiles, then the ring's lse and Δ rows
  static constexpr int dkdv_bytes = 1024 + (2 * NB + 2 * kWgStages * NB) * kSwizzleBlock +
                                    kWgStages * 2 * kRows * 4 + (2 * kWgStages + 1) * 8;
  // Q, dO, then the ring of (K, V) tiles
  static constexpr int dq_bytes = 1024 + (2 * NB + 2 * kWgStages * NB) * kSwizzleBlock +
                                  (2 * kWgStages + 1) * 8;
};

__device__ __forceinline__ bool attend_row(int qpos, int kpos, int S, int causal, int window) {
  return qpos >= 0 && qpos < S && attend(qpos, kpos, S, causal, window);
}

// Δ = rowsum(dO ∘ O) in f32, one warp a (b, s, h) row; written (B, H, S)
__global__ void __launch_bounds__(256) flash_attention_bwd_delta(BwdParams p, int hd, long long nrows) {
  const long long row = (long long)blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= nrows) return;
  const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(static_cast<const bf16*>(p.o) + row * hd);
  const __nv_bfloat162* d2 =
      reinterpret_cast<const __nv_bfloat162*>(static_cast<const bf16*>(p.dout) + row * hd);
  float acc = 0.f;
  for (int e = lane; e < hd / 2; e += 32) {
    const float2 a = __bfloat1622float2(o2[e]), d = __bfloat1622float2(d2[e]);
    acc = fmaf(a.x, d.x, acc);
    acc = fmaf(a.y, d.y, acc);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    const int h = (int)(row % p.H);
    const long long bs = row / p.H;
    p.delta[((bs / p.S) * p.H + h) * p.S + bs % p.S] = acc;
  }
}

// S = A·Bᵀ over the head width, both operands K-major 64-row tiles of NB
// 128-byte swizzled blocks (as Q·Kᵀ in the forward)
template <int HD>
__device__ __forceinline__ void wgmma_rows(float (&d)[32], const unsigned char* a, const unsigned char* b) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const int col = (kk & 3) * 32;
    wgmma_ss_n64(d, sw128_desc(a + (kk >> 2) * kSwizzleBlock + col, 16, 1024),
                 sw128_desc(b + (kk >> 2) * kSwizzleBlock + col, 16, 1024), kk > 0);
  }
}

// a 64 x 64 f32 accumulator as bf16 register A fragments of a product
// whose k is the accumulator's columns (its layout is the A layout)
__device__ __forceinline__ void a_fragments(uint32_t (&f)[4][4], const float (&a)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    f[kk][0] = pack_bf16(a[8 * kk], a[8 * kk + 1]);
    f[kk][1] = pack_bf16(a[8 * kk + 2], a[8 * kk + 3]);
    f[kk][2] = pack_bf16(a[8 * kk + 4], a[8 * kk + 5]);
    f[kk][3] = pack_bf16(a[8 * kk + 6], a[8 * kk + 7]);
  }
}

// d += A·B, A as register fragments (k = 64), B a 64-row tile as stored,
// (k, n) with n contiguous (MN-major, as V in the forward's P·V)
template <int HD>
__device__ __forceinline__ void wgmma_frag_b(float (&d)[HD / 2], const uint32_t (&f)[4][4], const unsigned char* b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_pv<HD>(d, f[kk], sw128_desc(b + kk * 2048, kSwizzleBlock, 1024));
}

template <int HD>
__global__ void __launch_bounds__(kBwdThreads)
    flash_attention_bwd_dkdv(BwdParams p, const __grid_constant__ CUtensorMap tq,
                             const __grid_constant__ CUtensorMap tdo, const __grid_constant__ CUtensorMap tk,
                             const __grid_constant__ CUtensorMap tv) {
  constexpr int NB = BwdShape<HD>::NB;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* Ks = base;                                   // [NB][64 keys][128 B]
  unsigned char* Vs = Ks + NB * kSwizzleBlock;                // [NB][64 keys][128 B]
  unsigned char* Qs = Vs + NB * kSwizzleBlock;                // [stage][NB][64 rows][128 B]
  unsigned char* dOs = Qs + kWgStages * NB * kSwizzleBlock;   // [stage][NB][64 rows][128 B]
  float* rowv = reinterpret_cast<float*>(dOs + kWgStages * NB * kSwizzleBlock);  // [stage][lse·log2e, Δ][64]
  uint64_t* full = reinterpret_cast<uint64_t*>(rowv + kWgStages * 2 * kRows);
  uint64_t* empty = full + kWgStages;
  uint64_t* kvbar = empty + kWgStages;

  const int G = p.G, qb = p.qb, rows = G * qb;
  const int kt = blockIdx.x * kKeyBlock;  // longest walk first
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  // the query tiles that reach keys [kt, kmax]: q >= kt (causal), q < kmax + window
  const int kmax = min(kt + kKeyBlock, p.S) - 1;
  const int q_lo = p.causal ? kt : 0;
  const int q_hi = p.window > 0 ? min(p.S, kmax + p.window) : p.S;
  const int t_begin = q_lo / qb;
  const int ntiles = max(0, (q_hi + qb - 1) / qb - t_begin);

  // the fold's unused rows (G·qb < 64), which no TMA box writes: zeros
  if (rows < kRows) {
    const int pad = (kRows - rows) * 32;  // words a block
    uint32_t* w = reinterpret_cast<uint32_t*>(Qs);
    for (int e = tid; e < 2 * kWgStages * NB * pad; e += kBwdThreads)
      w[(e / pad) * (kSwizzleBlock / 4) + rows * 32 + e % pad] = 0u;
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  if (tid == 0) {
    for (int s = 0; s < kWgStages; ++s) {
      mbar_init(&full[s], 32);  // every producer lane arrives (its lse and Δ stores)
      mbar_init(&empty[s], 128);
    }
    mbar_init(kvbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4) {  // ---- producer warp
    if (lane == 0) {
      mbar_expect_tx(kvbar, 2 * NB * kSwizzleBlock);
      for (int j = 0; j < NB; ++j) {
        tma_load_4d(Ks + j * kSwizzleBlock, &tk, kvbar, 64 * j, kvh, kt, b);
        tma_load_4d(Vs + j * kSwizzleBlock, &tv, kvbar, 64 * j, kvh, kt, b);
      }
    }
    for (int it = 0; it < ntiles; ++it) {
      const int s = it % kWgStages;
      if (it >= kWgStages) mbar_wait(&empty[s], (it / kWgStages - 1) & 1);
      const int q0 = (t_begin + it) * qb;
      for (int r = lane; r < kRows; r += 32) {
        const int pos = q0 + r / G;
        const bool ok = r < rows && pos < p.S;
        const long long at = ((long long)b * p.H + kvh * G + r % G) * p.S + pos;
        rowv[s * 2 * kRows + r] = ok ? p.lse[at] * kLog2e : 0.f;
        rowv[s * 2 * kRows + kRows + r] = ok ? p.delta[at] : 0.f;
      }
      if (lane == 0) {
        mbar_expect_tx(&full[s], 2 * NB * 128 * rows);
        for (int j = 0; j < NB; ++j) {
          tma_load_4d(Qs + (s * NB + j) * kSwizzleBlock, &tq, &full[s], 64 * j, kvh * G, q0, b);
          tma_load_4d(dOs + (s * NB + j) * kSwizzleBlock, &tdo, &full[s], 64 * j, kvh * G, q0, b);
        }
      } else {
        mbar_arrive(&full[s]);
      }
    }
    return;
  }

  // ---- the consumer warpgroup: keys kt + warp·16 + g (+ 8) are its rows
  const int g = lane >> 2, t4 = lane & 3;
  const int krow = kt + warp * 16 + g;
  float dk[HD / 2], dv[HD / 2];
#pragma unroll
  for (int n = 0; n < HD / 2; ++n) dk[n] = dv[n] = 0.f;
  const float sl2 = p.scale * kLog2e;
  const bool ragged = rows < kRows || kt + kKeyBlock > p.S;

  mbar_wait(kvbar, 0);
  for (int it = 0; it < ntiles; ++it) {
    const int st = it % kWgStages;
    mbar_wait(&full[st], (it / kWgStages) & 1);
    const unsigned char* qd = Qs + st * NB * kSwizzleBlock;
    const unsigned char* dod = dOs + st * NB * kSwizzleBlock;
    const float* lse2 = rowv + st * 2 * kRows;
    const float* dl = lse2 + kRows;
    const int q0 = (t_begin + it) * qb;

    // Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ, issued together
    float s[32], dp[32];
#pragma unroll
    for (int n = 0; n < 32; ++n) s[n] = dp[n] = 0.f;
    wgmma_fence();
    wgmma_rows<HD>(s, Ks, qd);
    wgmma_rows<HD>(dp, Vs, dod);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);
    fence_regs(dp);

    // accumulator n-tile j: keys krow (s[4j], s[4j + 1]) and krow + 8
    // (s[4j + 2], s[4j + 3]), query rows 8j + 2·t4 + {0, 1}
    const int q_last = q0 + qb - 1;
    const bool edge = ragged || q_last >= p.S || (p.causal && q0 < kt + kKeyBlock - 1) ||
                      (p.window > 0 && q_last - p.window >= kt);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int r = 8 * j + 2 * t4 + c;
        const float l2 = lse2[r], d = dl[r];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int e = 4 * j + 2 * i + c;
          const bool ok = !edge || (r < rows && attend_row(q0 + r / G, krow + 8 * i, p.S, p.causal, p.window));
          const float pr = ok ? fast_exp2(s[e] * sl2 - l2) : 0.f;
          dp[e] = ok ? pr * (dp[e] - d) : 0.f;
          s[e] = pr;
        }
      }

    // dV += Pᵀ·dO and dK += dSᵀ·Q (the query rows are the products' k);
    // both fragment sets packed before either product is issued
    uint32_t pf[4][4], df[4][4];
    a_fragments(pf, s);
    a_fragments(df, dp);
    wgmma_fence();
    wgmma_frag_b<HD>(dv, pf, dod);
    wgmma_frag_b<HD>(dk, df, qd);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(dv);
    fence_regs(dk);
    mbar_arrive(&empty[st]);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = krow + 8 * i;
    if (key >= p.S) continue;
    const long long at = (((long long)b * p.S + key) * p.KV + kvh) * HD;
    bf16* dko = static_cast<bf16*>(p.dk) + at;
    bf16* dvo = static_cast<bf16*>(p.dv) + at;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      *reinterpret_cast<uint32_t*>(dko + n * 8 + 2 * t4) =
          pack_bf16(dk[4 * n + 2 * i] * p.scale, dk[4 * n + 2 * i + 1] * p.scale);
      *reinterpret_cast<uint32_t*>(dvo + n * 8 + 2 * t4) = pack_bf16(dv[4 * n + 2 * i], dv[4 * n + 2 * i + 1]);
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(kBwdThreads)
    flash_attention_bwd_dq(BwdParams p, const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tdo, const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv) {
  constexpr int NB = BwdShape<HD>::NB;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* Qs = base;                                  // [NB][64 rows][128 B]
  unsigned char* dOs = Qs + NB * kSwizzleBlock;              // [NB][64 rows][128 B]
  unsigned char* Ks = dOs + NB * kSwizzleBlock;              // [stage][NB][64 keys][128 B]
  unsigned char* Vs = Ks + kWgStages * NB * kSwizzleBlock;   // [stage][NB][64 keys][128 B]
  uint64_t* full = reinterpret_cast<uint64_t*>(Vs + kWgStages * NB * kSwizzleBlock);
  uint64_t* empty = full + kWgStages;
  uint64_t* qbar = empty + kWgStages;

  const int G = p.G, rows = G * p.qb;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * p.qb;  // longest first
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  const int q_last = min(q0 + p.qb, p.S) - 1;
  int k_begin = p.window > 0 ? max(0, q0 - p.window + 1) : 0;
  k_begin = k_begin / kKeyBlock * kKeyBlock;
  const int k_end = p.causal ? q_last + 1 : p.S;
  const int ntiles = (k_end - k_begin + kKeyBlock - 1) / kKeyBlock;

  if (tid == 0) {
    for (int s = 0; s < kWgStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 128);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4) {  // ---- producer: Q and dO once, then the reachable K/V tiles
    if (lane == 0) {
      mbar_expect_tx(qbar, 2 * NB * 128 * rows);
      for (int j = 0; j < NB; ++j) {
        tma_load_4d(Qs + j * kSwizzleBlock, &tq, qbar, 64 * j, kvh * G, q0, b);
        tma_load_4d(dOs + j * kSwizzleBlock, &tdo, qbar, 64 * j, kvh * G, q0, b);
      }
      for (int it = 0; it < ntiles; ++it) {
        const int s = it % kWgStages;
        if (it >= kWgStages) mbar_wait(&empty[s], (it / kWgStages - 1) & 1);
        mbar_expect_tx(&full[s], 2 * NB * kSwizzleBlock);
        const int kt = k_begin + it * kKeyBlock;
        for (int j = 0; j < NB; ++j) {
          tma_load_4d(Ks + (s * NB + j) * kSwizzleBlock, &tk, &full[s], 64 * j, kvh, kt, b);
          tma_load_4d(Vs + (s * NB + j) * kSwizzleBlock, &tv, &full[s], 64 * j, kvh, kt, b);
        }
      }
    }
    return;
  }

  // ---- the consumer warpgroup: query rows warp·16 + g (+ 8) of the tile
  const int g = lane >> 2, t4 = lane & 3;
  int qpos[2];  // -1: a row past the sequence or the fold; never written
  float l2[2], dl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = warp * 16 + g + 8 * i;
    qpos[i] = (r < rows && q0 + r / G < p.S) ? q0 + r / G : -1;
    const long long at = ((long long)b * p.H + kvh * G + r % G) * p.S + qpos[i];
    l2[i] = qpos[i] >= 0 ? p.lse[at] * kLog2e : 0.f;
    dl[i] = qpos[i] >= 0 ? p.delta[at] : 0.f;
  }
  float dq[HD / 2];
#pragma unroll
  for (int n = 0; n < HD / 2; ++n) dq[n] = 0.f;
  const float sl2 = p.scale * kLog2e;

  mbar_wait(qbar, 0);
  for (int it = 0; it < ntiles; ++it) {
    const int st = it % kWgStages;
    mbar_wait(&full[st], (it / kWgStages) & 1);
    const unsigned char* kd = Ks + st * NB * kSwizzleBlock;
    const unsigned char* vd = Vs + st * NB * kSwizzleBlock;
    const int kt = k_begin + it * kKeyBlock;

    // S = Q·Kᵀ and dP = dO·Vᵀ, issued together
    float s[32], dp[32];
#pragma unroll
    for (int n = 0; n < 32; ++n) s[n] = dp[n] = 0.f;
    wgmma_fence();
    wgmma_rows<HD>(s, Qs, kd);
    wgmma_rows<HD>(dp, dOs, vd);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);
    fence_regs(dp);

    // as in the forward: rows g (+ 8), keys 8j + 2·t4 + {0, 1}
    const bool edge = kt + kKeyBlock > p.S || (p.causal && kt + kKeyBlock - 1 > q0) ||
                      (p.window > 0 && kt <= q_last - p.window);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int e = 4 * j + 2 * i + c;
          const bool ok = !edge || attend_row(qpos[i], kt + 8 * j + 2 * t4 + c, p.S, p.causal, p.window);
          const float pr = ok ? fast_exp2(s[e] * sl2 - l2[i]) : 0.f;
          dp[e] = ok ? pr * (dp[e] - dl[i]) : 0.f;
        }

    // dQ += dS·K (the keys are the product's k; K as stored)
    uint32_t df[4][4];
    a_fragments(df, dp);
    wgmma_fence();
    wgmma_frag_b<HD>(dq, df, kd);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(dq);
    mbar_arrive(&empty[st]);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (qpos[i] < 0) continue;
    const int h = kvh * G + (warp * 16 + g + 8 * i) % G;
    bf16* out = static_cast<bf16*>(p.dq) + (((long long)b * p.S + qpos[i]) * p.H + h) * HD;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
      *reinterpret_cast<uint32_t*>(out + n * 8 + 2 * t4) =
          pack_bf16(dq[4 * n + 2 * i] * p.scale, dq[4 * n + 2 * i + 1] * p.scale);
  }
}

// cuTensorMapEncodeTiled, a driver-API call, through the runtime's entry
// point query: the library needs no -lcuda
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult status;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &status) ==
            cudaSuccess &&
        status == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// the model layout (B, S, heads, hd) as a 4-d map (hd, heads, S, B); boxes
// of 64 columns (one 128-byte swizzle row), zero fill past every edge
bool make_map(CUtensorMap* map, const void* ptr, int B, int S, int heads, int hd, int box_heads,
              int box_rows) {
  EncodeTiled fn = encode_tiled();
  if (!fn) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)heads, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)hd * 2, (cuuint64_t)heads * hd * 2,
                                 (cuuint64_t)S * heads * hd * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)box_heads, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD, int WG>
int launch_wgmma(const Params& p, int B, cudaStream_t stream) {
  using Shape = WgShape<HD, WG>;
  static_assert(Shape::bytes <= kMaxSharedBytes, "shared memory");
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, p.q, B, p.S, p.H, HD, p.G, p.qb) || !make_map(&tk, p.k, B, p.S, p.KV, HD, 1, 64) ||
      !make_map(&tv, p.v, B, p.S, p.KV, HD, 1, 64))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(flash_attention_wgmma<HD, WG>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, Shape::bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.S + p.qb - 1) / p.qb, p.KV, B);
  flash_attention_wgmma<HD, WG><<<grid, Shape::threads, Shape::bytes, stream>>>(p, tq, tk, tv);
  return (int)cudaGetLastError();
}

// one consumer warpgroup for a tile of up to 64 query rows, two up to 128
template <int HD>
int launch_wgmma(const Params& p, int B, cudaStream_t stream) {
  return p.G * p.qb > kRows ? launch_wgmma<HD, 2>(p, B, stream) : launch_wgmma<HD, 1>(p, B, stream);
}

// the pre-pass, then dK/dV (a block a key tile) and dQ (a block a query tile)
template <int HD>
int launch_bwd(const BwdParams& p, int B, cudaStream_t stream) {
  using Shape = BwdShape<HD>;
  static_assert(Shape::dkdv_bytes <= kMaxSharedBytes && Shape::dq_bytes <= kMaxSharedBytes, "shared memory");
  const long long nrows = (long long)B * p.S * p.H;
  flash_attention_bwd_delta<<<(unsigned)((nrows + 7) / 8), 256, 0, stream>>>(p, HD, nrows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  CUtensorMap tq, tdo, tk, tv;
  if (!make_map(&tq, p.q, B, p.S, p.H, HD, p.G, p.qb) || !make_map(&tdo, p.dout, B, p.S, p.H, HD, p.G, p.qb) ||
      !make_map(&tk, p.k, B, p.S, p.KV, HD, 1, 64) || !make_map(&tv, p.v, B, p.S, p.KV, HD, 1, 64))
    return (int)cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(flash_attention_bwd_dkdv<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             Shape::dkdv_bytes);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(flash_attention_bwd_dq<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             Shape::dq_bytes);
  if (err != cudaSuccess) return (int)err;
  flash_attention_bwd_dkdv<HD><<<dim3((p.S + kKeyBlock - 1) / kKeyBlock, p.KV, B), kBwdThreads,
                                 Shape::dkdv_bytes, stream>>>(p, tq, tdo, tk, tv);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_attention_bwd_dq<HD><<<dim3((p.S + p.qb - 1) / p.qb, p.KV, B), kBwdThreads, Shape::dq_bytes, stream>>>(
      p, tq, tdo, tk, tv);
  return (int)cudaGetLastError();
}

// ----------------------------------------------------------- launches
template <int HD>
int launch_f32(const Params& p, int B, cudaStream_t stream) {
  constexpr size_t bytes = sizeof(float) * (size_t)shared_floats(HD);
  static_assert(bytes <= (size_t)kMaxSharedBytes, "shared memory");
  cudaError_t err = cudaFuncSetAttribute(flash_attention_fwd<float, HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.S + p.qb - 1) / p.qb, p.KV, B);
  flash_attention_fwd<float, HD><<<grid, kThreads, bytes, stream>>>(p);
  return (int)cudaGetLastError();
}

// The library is built once per head width (-DFA_HEAD_DIM=<hd>, the
// build's variants) and holds that width's kernels alone: nvcc then
// compiles a sixth of the templates.
#ifndef FA_HEAD_DIM
#error "build with -DFA_HEAD_DIM=<head width>: one library a width"
#endif
template <int HD>
constexpr bool built() {
  return HD == FA_HEAD_DIM;
}

// bf16: the wgmma + TMA kernel; f32: the CUDA-core kernel
template <bool TC, int HD>
int launch_width(const Params& p, int B, cudaStream_t s) {
  if constexpr (built<HD>()) return TC ? launch_wgmma<HD>(p, B, s) : launch_f32<HD>(p, B, s);
  return (int)cudaErrorInvalidValue;
}

template <int HD>
int launch_bwd_width(const BwdParams& p, int B, cudaStream_t s) {
  if constexpr (built<HD>()) return launch_bwd<HD>(p, B, s);
  return (int)cudaErrorInvalidValue;
}

template <bool TC>
int launch_hd(const Params& p, int hd, int B, cudaStream_t s) {
  switch (hd) {
    case 16: return launch_width<TC, 16>(p, B, s);
    case 32: return launch_width<TC, 32>(p, B, s);
    case 64: return launch_width<TC, 64>(p, B, s);
    case 96: return launch_width<TC, 96>(p, B, s);
    case 128: return launch_width<TC, 128>(p, B, s);
    case 192: return launch_width<TC, 192>(p, B, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32 (CUDA cores), 1 = bfloat16 (tensor cores); q, k, v and
// the output share it.  hd must be the library's FA_HEAD_DIM (16, 32, 64,
// 96, 128 or 192), G·qb at most 64 rows (128 for bf16); bf16 pointers
// 16-byte aligned.  lse: null, or (B, H, S) f32 for the rows' log-sum-exp
// (bf16 only).
extern "C" int flash_attention(const void* q, const void* k, const void* v, void* o, float* lse,
                               int B, int S, int H, int KV, int hd, int qb, int causal, int window,
                               float scale, int dtype, void* stream) {
  // tiles of up to 128 query rows on the wgmma kernel (bf16), 64 on the f32 one
  const int max_rows = dtype == 1 ? 2 * kRows : kRows;
  if (B <= 0 || S <= 0 || KV <= 0 || H % KV != 0 || qb <= 0 || (H / KV) * qb > max_rows ||
      (lse != nullptr && dtype != 1))
    return (int)cudaErrorInvalidValue;
  Params p{q, k, v, o, S, H, KV, H / KV, qb, causal, window, scale, lse};
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case 0: return launch_hd<false>(p, hd, B, s);
    case 1: return launch_hd<true>(p, hd, B, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The backward, bf16 only: dq (B, S, H, hd), dk and dv (B, S, KV, hd) from
// the forward's inputs, output o and lse, and the output's gradient dout;
// delta is (B, H, S) f32 scratch.  qb·(H / KV) at most 64 rows; pointers
// 16-byte aligned.
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                                   const float* lse, const void* dout, float* delta, void* dq, void* dk,
                                   void* dv, int B, int S, int H, int KV, int hd, int qb, int causal,
                                   int window, float scale, void* stream) {
  if (B <= 0 || S <= 0 || KV <= 0 || H % KV != 0 || qb <= 0 || (H / KV) * qb > kRows)
    return (int)cudaErrorInvalidValue;
  BwdParams p{q, k, v, o, dout, lse, delta, dq, dk, dv, S, H, KV, H / KV, qb, causal, window, scale};
  cudaStream_t s = (cudaStream_t)stream;
  switch (hd) {
    case 16: return launch_bwd_width<16>(p, B, s);
    case 32: return launch_bwd_width<32>(p, B, s);
    case 64: return launch_bwd_width<64>(p, B, s);
    case 96: return launch_bwd_width<96>(p, B, s);
    case 128: return launch_bwd_width<128>(p, B, s);
    case 192: return launch_bwd_width<192>(p, B, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

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
// far above the card's balance point; this first kernel runs its products on
// CUDA cores in f32, so it sits well below the tensor-core peak it is held to.
//
// Design (simple first):
// - One block per (query block, KV head, batch).  The block holds the
//   G·QB query rows of its KV head (G = H / KV query heads per KV head,
//   QB = max(1, 64 / G) positions; at most 64 rows), so each K/V tile is
//   loaded into shared memory once for all G heads: the TPU kernel's GQA
//   fold.
// - The KV loop runs inside the block, over the reachable tiles only: up to
//   the causal end, and from the window's start when window > 0.  Tiles past
//   either end are never loaded (the TPU kernel skipped their compute with
//   pl.when but still streamed them).  The running state the TPU carried
//   across grid steps in VMEM scratch lives in registers for the whole loop,
//   in f32.
// - Register tiles: of the 64 x 64 scores of a tile, each of the 256
//   threads holds 4 rows x 4 keys; of the 64 x HD numerator, the same 4 rows
//   x HD/16 columns.  Each product step then reads 8 words of shared memory
//   for 16 multiply-adds.  The 16 threads that share rows reduce the row max
//   and sum with shuffles and keep identical copies of (m, l).
// - Masks are exact: a masked score is -1e30, not -inf; its probability is
//   set to 0, so a row fully masked in one tile adds nothing; kpos < S masks
//   the ragged tail, so no padding is needed and any S is taken.
// - Inputs (bf16 or f32) are widened to f32 in shared memory; Q and K rows
//   and the probability rows are padded by one word, so the lanes of a warp
//   hit distinct banks.
// wgmma tiles, TMA loads and warp specialisation come in a later redesign.

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
  const void* q;  // (B, S, H, hd)
  const void* k;  // (B, S, KV, hd)
  const void* v;  // (B, S, KV, hd)
  void* o;        // (B, S, H, hd)
  int S, H, KV, G, qb;
  int causal, window;
  float scale;
};

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

template <typename T, int HD>
int launch(const Params& p, int B, cudaStream_t stream) {
  constexpr size_t bytes = sizeof(float) * (size_t)shared_floats(HD);
  static_assert(bytes <= (size_t)kMaxSharedBytes, "shared memory");
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_fwd<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.S + p.qb - 1) / p.qb, p.KV, B);
  flash_attention_fwd<T, HD><<<grid, kThreads, bytes, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_hd(const Params& p, int hd, int B, cudaStream_t stream) {
  switch (hd) {
    case 16: return launch<T, 16>(p, B, stream);
    case 32: return launch<T, 32>(p, B, stream);
    case 64: return launch<T, 64>(p, B, stream);
    case 128: return launch<T, 128>(p, B, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and the output share it).
// hd must be 16, 32, 64 or 128, and G·qb at most 64 rows.
extern "C" int flash_attention(const void* q, const void* k, const void* v, void* o, int B,
                               int S, int H, int KV, int hd, int qb, int causal, int window,
                               float scale, int dtype, void* stream) {
  if (B <= 0 || S <= 0 || KV <= 0 || H % KV != 0 || qb <= 0 || (H / KV) * qb > kRows)
    return (int)cudaErrorInvalidValue;
  Params p{q, k, v, o, S, H, KV, H / KV, qb, causal, window, scale};
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case 0: return launch_hd<float>(p, hd, B, s);
    case 1: return launch_hd<__nv_bfloat16>(p, hd, B, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

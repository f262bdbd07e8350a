// Fragment UNION for Hopper (sm_90a), bound through a plain C interface.
//
// Replaces the TPU kernel src/repro/kernels/fragment_gather/kernel.py
// (`fragment_gather_call` / `_gather_kernel`), which copies one source row
// tile per output row tile, one launch per column.  Here one launch copies
// every run of every column of one UNION, from all providers, straight into
// the preallocated output columns: its input is a table of byte ranges
// (src address, dst address, bytes), which the host builds from the runs'
// bounds (no per-row index exists) and cuts where the destination crosses a
// multiple of kChunk bytes, so every entry moves at most kChunk bytes and
// the grid balances.  The row-tile API is the same table with consecutive
// tiles merged into runs.
//
// What bounds it: device-memory bytes.  It does no arithmetic; it reads
// every gathered byte once and writes it once, so its floor on the card is
// 2 * output bytes / memory bandwidth (plus the table, 24 bytes an entry).
//
// Design:
// - Bytes, not elements: one kernel serves every dtype, bitwise by
//   construction.
// - Persistent blocks, one of kThreads a SM, walk the table with a stride.
//   An entry's first bytes up to the destination's next 16-byte boundary
//   (the head) and its last < 16 bytes (the tail) go byte by byte.
// - Where source and destination share their residue mod 16, the aligned
//   body is a plain 16-byte load/store loop, kUnroll words in flight a
//   thread.  A TMA bulk copy through shared memory (one thread issuing
//   cp.async.bulk in and out of an mbarrier-tracked ring) was built and
//   measured against it on the H100 and was slower at the main path's
//   shapes (PERF.md, Findings): the copy is bound by device memory either
//   way, and the ring's shared memory cuts the blocks a SM can hold, which
//   the funnel-shifted bodies below need.
// - Where the residues differ (common: a destination offset is the sum of
//   the runs' lengths before it), no aligned word pairs up.  Every thread
//   then loads the two aligned 16-byte source words that cover one aligned
//   16-byte destination word and funnel-shifts them into it
//   (__funnelshift_r), kUnroll words in flight a thread.  The residue is
//   not 0, so both words hold a byte of the run: no load leaves the
//   aligned 16-byte blocks the source touches.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 32 * 1024;  // bytes an entry moves at most
constexpr int kThreads = 1024;
constexpr int kUnroll = 4;

struct Chunk {
  long long src, dst, nbytes;  // device addresses, length in bytes
};

// `words` aligned 16-byte words from `src` to `dst`, both 16-byte aligned
__device__ void copy_aligned(const uint8_t* src, uint8_t* dst, long long words) {
  const uint4* s = reinterpret_cast<const uint4*>(src);
  uint4* d = reinterpret_cast<uint4*>(dst);
  for (long long w0 = threadIdx.x; w0 < words; w0 += (long long)kUnroll * blockDim.x) {
    uint4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long w = w0 + (long long)u * blockDim.x;
      if (w < words) v[u] = s[w];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long w = w0 + (long long)u * blockDim.x;
      if (w < words) d[w] = v[u];
    }
  }
}

// bytes [4Q + b, 4Q + b + 16) of the 32 bytes lo:hi, b = shift / 8
template <int Q>
__device__ __forceinline__ uint4 shifted(const uint4& lo, const uint4& hi, unsigned shift) {
  const uint32_t a[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
  return make_uint4(__funnelshift_r(a[Q], a[Q + 1], shift), __funnelshift_r(a[Q + 1], a[Q + 2], shift),
                    __funnelshift_r(a[Q + 2], a[Q + 3], shift),
                    __funnelshift_r(a[Q + 3], a[Q + 4], shift));
}

// `words` aligned 16-byte words to `dst` from `src`, which lies 4Q + b
// bytes past a 16-byte boundary (4Q + b != 0)
template <int Q>
__device__ void copy_shifted(const uint8_t* src, uint8_t* dst, long long words) {
  const uint4* s = reinterpret_cast<const uint4*>(reinterpret_cast<uintptr_t>(src) & ~uintptr_t(15));
  const unsigned shift = 8u * static_cast<unsigned>(reinterpret_cast<uintptr_t>(src) & 3);
  uint4* d = reinterpret_cast<uint4*>(dst);
  for (long long w0 = threadIdx.x; w0 < words; w0 += (long long)kUnroll * blockDim.x) {
    uint4 lo[kUnroll], hi[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long w = w0 + (long long)u * blockDim.x;
      if (w < words) {
        lo[u] = s[w];
        hi[u] = s[w + 1];
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long w = w0 + (long long)u * blockDim.x;
      if (w < words) d[w] = shifted<Q>(lo[u], hi[u], shift);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    fragment_union_kernel(const Chunk* __restrict__ table, int n_chunks) {
  for (int i = blockIdx.x; i < n_chunks; i += gridDim.x) {
    const Chunk c = table[i];
    const uint8_t* src = reinterpret_cast<const uint8_t*>(c.src);
    uint8_t* dst = reinterpret_cast<uint8_t*>(c.dst);
    const int n = static_cast<int>(c.nbytes);  // <= kChunk
    const int head = min(static_cast<int>((16 - (c.dst & 15)) & 15), n);
    const int body = (n - head) & ~15;
    const int tail = n - head - body;
    const int t = threadIdx.x;
    if (t < head) dst[t] = src[t];
    if (t >= 32 && t - 32 < tail) dst[head + body + t - 32] = src[head + body + t - 32];
    if (body == 0) continue;
    const uint8_t* from = src + head;
    uint8_t* to = dst + head;  // 16-byte aligned
    const int residue = static_cast<int>(reinterpret_cast<uintptr_t>(from) & 15);
    switch (residue >> 2) {
      case 0:
        if (residue == 0) copy_aligned(from, to, body / 16);
        else copy_shifted<0>(from, to, body / 16);
        break;
      case 1: copy_shifted<1>(from, to, body / 16); break;
      case 2: copy_shifted<2>(from, to, body / 16); break;
      default: copy_shifted<3>(from, to, body / 16); break;
    }
  }
}

}  // namespace

extern "C" int fragment_union(const void* table, int n_chunks, void* stream) {
  if (n_chunks <= 0) return 0;
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  const int blocks = n_chunks < sms ? n_chunks : sms;
  fragment_union_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(static_cast<const Chunk*>(table),
                                                                        n_chunks);
  return (int)cudaGetLastError();
}

extern "C" int fragment_union_chunk_bytes() { return kChunk; }

extern "C" const char* fragment_gather_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

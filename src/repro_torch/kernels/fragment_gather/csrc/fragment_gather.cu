// Fragment row-gather for Hopper (sm_90a), bound through a plain C interface.
//
// Replaces the TPU kernel src/repro/kernels/fragment_gather/kernel.py
// (`fragment_gather_call` / `_gather_kernel`): output row tile i is source
// row tile block_idx[i], `rb` rows per tile, so out[r, :] = src[idx[r], :].
// rb == 1 is the row-granular mode.
//
// What bounds it: device-memory bytes.  The gather does no arithmetic; it
// reads every gathered byte once and writes it once, so its floor on the
// card is 2 * output bytes / memory bandwidth.
//
// Design (simple first):
// - Rows are raw bytes (C * itemsize), so one kernel serves every dtype and
//   the copy is bitwise by construction.
// - A tile of rb consecutive rows is one contiguous byte range in the source
//   and in the output, so the output is a flat array of words.  The word is
//   the widest of 16/8/4/2/1 bytes that divides both base pointers and the
//   tile's byte length (the wrapper picks it); 16-byte words give vectorised
//   loads and stores.
// - One thread moves one word per grid-stride step; neighbouring threads
//   touch neighbouring addresses inside a tile.  Each thread finds its tile
//   by division and loads that tile's index itself (the TPU kernel
//   scalar-prefetched the indices instead).
// - The grid-stride bound masks the ragged edge; no column padding exists
//   (the TPU kernel padded columns to 128 lanes).
// The one-launch-per-UNION run table with TMA bulk copies comes later.

#include <cuda_runtime.h>
#include <stdint.h>

template <typename Word>
__global__ void gather_words(const Word* __restrict__ src, Word* __restrict__ out,
                             const int32_t* __restrict__ block_idx,
                             long long n_words, long long words_per_tile) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x; t < n_words;
       t += stride) {
    const long long tile = t / words_per_tile;
    const long long within = t - tile * words_per_tile;
    out[t] = src[(long long)block_idx[tile] * words_per_tile + within];
  }
}

template <typename Word>
static int launch(const void* src, void* out, const int32_t* block_idx,
                  long long n_words, long long words_per_tile, cudaStream_t stream) {
  const int threads = 256;
  long long blocks = (n_words + threads - 1) / threads;
  if (blocks > 65535) blocks = 65535;  // grid-stride loop covers the rest
  if (blocks < 1) blocks = 1;
  gather_words<Word><<<(unsigned)blocks, threads, 0, stream>>>(
      (const Word*)src, (Word*)out, block_idx, n_words, words_per_tile);
  return (int)cudaGetLastError();
}

extern "C" int fragment_gather(const void* src, void* out, const int32_t* block_idx,
                               long long n_words, long long words_per_tile,
                               int word_bytes, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (word_bytes) {
    case 16: return launch<uint4>(src, out, block_idx, n_words, words_per_tile, s);
    case 8: return launch<unsigned long long>(src, out, block_idx, n_words, words_per_tile, s);
    case 4: return launch<unsigned int>(src, out, block_idx, n_words, words_per_tile, s);
    case 2: return launch<unsigned short>(src, out, block_idx, n_words, words_per_tile, s);
    case 1: return launch<unsigned char>(src, out, block_idx, n_words, words_per_tile, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* fragment_gather_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

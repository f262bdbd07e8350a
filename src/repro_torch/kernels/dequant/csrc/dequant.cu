// Per-column int8 dequantize for Hopper (sm_90a), bound through a plain C
// interface.
//
// Replaces the TPU kernel src/repro/kernels/dequant/kernel.py
// (`dequant_call` / `_dequant_kernel`): out[r, c] = f32(x[r, c]) * scale[c],
// rounded once to the output dtype (bf16, round to nearest even, or f32).
// x is (R, C) int8 in row-major order, scale (C,) f32.
//
// What bounds it: device-memory bytes.  Each value costs one multiply and
// moves 1 byte in and 2 (bf16) or 4 (f32) bytes out, far below the card's
// balance point, so its floor is (R·C·(1 + out size) + 4·C) / bandwidth.
//
// Design (simple first):
// - A streaming pass over the flat index: each thread loads 16 int8 values
//   with one 16-byte load and writes them with two (bf16) or four (f32)
//   16-byte stores, in a grid-stride loop.  The TPU kernel cut (256, 512)
//   tiles and padded to them; here the flat layout needs no tiles and no
//   padding.
// - The column of a value is its flat index modulo C, computed once for a
//   vector and then stepped with a wrap, so C may be narrower than a vector
//   (an 8-column page) or not divide it.
// - Scales sit in shared memory when C fits 48 KB (12,288 columns), staged
//   once per block; wider rows read them through the read-only path.
// - The product is one IEEE f32 multiply, and bf16 is formed by
//   __float2bfloat16_rn, so the result is bitwise the plain version's.
// - A scalar loop covers the ragged tail (n mod 16 values) and the whole
//   array when x or out is not 16-byte aligned (a view with a storage
//   offset).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 16;                     // int8 values per 16-byte load
constexpr int kMaxSharedScales = 48 * 1024 / 4;  // f32 scales a block stages

__device__ __forceinline__ void store_vec(float* out, const float* v) {
  float4* o = reinterpret_cast<float4*>(out);
#pragma unroll
  for (int i = 0; i < kVec / 4; ++i) {
    o[i] = make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
  }
}

__device__ __forceinline__ void store_vec(__nv_bfloat16* out, const float* v) {
  uint32_t words[kVec / 2];
#pragma unroll
  for (int i = 0; i < kVec / 2; ++i) {
    const uint32_t lo = __bfloat16_as_ushort(__float2bfloat16_rn(v[2 * i]));
    const uint32_t hi = __bfloat16_as_ushort(__float2bfloat16_rn(v[2 * i + 1]));
    words[i] = lo | (hi << 16);  // little-endian: element 2i at the lower address
  }
  uint4* o = reinterpret_cast<uint4*>(out);
  o[0] = make_uint4(words[0], words[1], words[2], words[3]);
  o[1] = make_uint4(words[4], words[5], words[6], words[7]);
}

__device__ __forceinline__ void store_one(float* out, float v) { *out = v; }
__device__ __forceinline__ void store_one(__nv_bfloat16* out, float v) {
  *out = __float2bfloat16_rn(v);
}

template <typename OutT, bool kSharedScale>
__global__ void __launch_bounds__(kThreads)
dequant_kernel(const int8_t* __restrict__ x, const float* __restrict__ scale,
               OutT* __restrict__ out, long long n, int C, long long n_vec) {
  extern __shared__ float s_scale[];
  if (kSharedScale) {
    for (int c = threadIdx.x; c < C; c += blockDim.x) s_scale[c] = scale[c];
    __syncthreads();
  }
  auto col_scale = [&](int c) -> float {
    return kSharedScale ? s_scale[c] : __ldg(scale + c);
  };
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  for (long long t = tid; t < n_vec; t += stride) {
    const long long base = t * kVec;
    const int4 raw = __ldg(reinterpret_cast<const int4*>(x) + t);
    const int8_t* q = reinterpret_cast<const int8_t*>(&raw);
    int c = (int)(base % C);
    float v[kVec];
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      v[j] = (float)q[j] * col_scale(c);
      if (++c == C) c = 0;
    }
    store_vec(out + base, v);
  }
  // the ragged tail, or everything when the pointers are not aligned
  for (long long i = n_vec * kVec + tid; i < n; i += stride) {
    store_one(out + i, (float)x[i] * col_scale((int)(i % C)));
  }
}

int multiprocessors() {
  static int cached[64] = {0};
  int device = 0;
  cudaGetDevice(&device);
  if (device < 0 || device >= 64) device = 0;
  if (cached[device] == 0) {
    int sms = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    cached[device] = sms > 0 ? sms : 1;
  }
  return cached[device];
}

template <typename OutT>
int launch(const void* x, const float* scale, void* out, long long rows, int cols,
           cudaStream_t stream) {
  const long long n = rows * cols;
  const bool aligned = ((uintptr_t)x % 16 == 0) && ((uintptr_t)out % 16 == 0);
  const long long n_vec = aligned ? n / kVec : 0;
  const long long work = n_vec + (n - n_vec * kVec);  // threads' worth of steps
  long long blocks = (work + kThreads - 1) / kThreads;
  const long long cap = 8LL * multiprocessors();  // 8 blocks of 256 fill an SM's 2048 threads
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  const int8_t* xs = (const int8_t*)x;
  OutT* o = (OutT*)out;
  if (cols <= kMaxSharedScales) {
    dequant_kernel<OutT, true><<<(unsigned)blocks, kThreads, cols * sizeof(float), stream>>>(
        xs, scale, o, n, cols, n_vec);
  } else {
    dequant_kernel<OutT, false><<<(unsigned)blocks, kThreads, 0, stream>>>(
        xs, scale, o, n, cols, n_vec);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// out_dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t (0 = launched).
extern "C" int dequant(const void* x, const void* scale, void* out, long long rows,
                       int cols, int out_dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const float* sc = (const float*)scale;
  if (out_dtype == 1) return launch<__nv_bfloat16>(x, sc, out, rows, cols, s);
  return launch<float>(x, sc, out, rows, cols, s);
}

extern "C" const char* dequant_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

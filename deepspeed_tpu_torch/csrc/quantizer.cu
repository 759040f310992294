// Flat symmetric int8 block quantisation and dequantisation, written by hand
// for Hopper (sm_90a).
//
// Replaces: deepspeed_tpu/ops/pallas/quantizer.py
//   _quant_kernel            -> quant_kernel<T, false>  (ds_quantize_int8)
//   _quant_kernel_stochastic -> quant_kernel<T, true>   (ds_quantize_int8_stochastic)
//   _dequant_kernel          -> dequant_kernel<T>       (ds_dequantize_int8)
// They compute what those kernels compute on the flat input cut into blocks
// of `block` elements (the last one zero-padded to a whole block, without
// padding anything in memory): per block the fp32 absmax, scale = 1 for an
// all-zero block else absmax / 127 (IEEE division), and per element
// q = clip(rint(x / scale), -127, 127) (round half to even, IEEE division),
// or with stochastic rounding q = clip(floor(x / scale + u), -127, 127) with
// u = (bits >> 8) * 2^-24 from the counter-based hash uniform_bits(seed,
// flat index) that ops/quant.py:_uniform_bits writes out in torch.
// Dequantisation is (float)q * scale, rounded once to the output type.
// No fast-math: the codes must equal the plain version's bit for bit.
//
// What bounds them on an H100: bytes. Quantisation reads 2 or 4 bytes and
// writes 1 byte (plus 4 per block) per element for a handful of flops;
// dequantisation reads 1 and writes 2 or 4. Both stream with 16-byte
// vector accesses where the data is aligned.
//
// Design. The TPU kernels take 64 whole blocks of a [nb, block] view per grid
// step into VMEM. Here one CUDA block of 256 threads owns one quantisation
// block: pass 1 reads it with 16-byte loads and reduces |x| to the absmax
// (warp shuffles, then one float per warp in shared memory); pass 2 reads
// it again (from L1/L2: a 2048-element block is 4 or 8 KB) and stores the
// codes. A block of 2048 bf16 values is one 16-byte load per thread.
// Dequantisation is elementwise: one thread per 16 codes (one 16-byte load),
// one scale for the 16 where they share a block.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// murmur3's 32-bit finaliser
__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

// 32 random bits for flat element `idx` under `key` = fmix32(seed)
__device__ __forceinline__ uint32_t uniform_bits(uint32_t key, int64_t idx) {
  const uint64_t u = static_cast<uint64_t>(idx);
  return fmix32(fmix32(static_cast<uint32_t>(u) ^ key) ^ static_cast<uint32_t>(u >> 32));
}

template <bool kStochastic>
__device__ __forceinline__ int8_t quant_one(float x, float scale, uint32_t key, int64_t idx) {
  const float s = x / scale;
  float r;
  if constexpr (kStochastic) {
    const float u = static_cast<float>(uniform_bits(key, idx) >> 8) * (1.0f / 16777216.0f);
    r = floorf(s + u);
  } else {
    r = rintf(s);
  }
  return static_cast<int8_t>(fminf(fmaxf(r, -127.f), 127.f));
}

// Block-wide max of a non-negative value; every thread gets the result.
__device__ __forceinline__ float block_max(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < kThreads / 32 ? red[lane] : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
    if (lane == 0) red[0] = v;
  }
  __syncthreads();
  return red[0];
}

// One CUDA block per quantisation block. `vec`: x and the block starts are
// 16-byte aligned, so whole vectors of kVec elements are loaded at once.
template <typename T, bool kStochastic>
__global__ void __launch_bounds__(kThreads)
quant_kernel(const T* __restrict__ x, int64_t n, int block, int8_t* __restrict__ vals,
             float* __restrict__ scales, uint32_t key, bool vec) {
  constexpr int kVec = 16 / sizeof(T);
  __shared__ float red[kThreads / 32];
  const int64_t start = static_cast<int64_t>(blockIdx.x) * block;
  const int len = static_cast<int>(min(static_cast<int64_t>(block), n - start));  // live elements
  const T* xb = x + start;
  const int tid = threadIdx.x;

  // ---- pass 1: absmax (the zero-padded tail does not change it)
  float amax = 0.f;
  if (vec) {
    for (int i = tid * kVec; i < len; i += kThreads * kVec) {
      if (i + kVec <= len) {
        const uint4 raw = *reinterpret_cast<const uint4*>(xb + i);
        const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
        for (int e = 0; e < kVec; ++e) amax = fmaxf(amax, fabsf(to_float(v[e])));
      } else {
        for (int e = i; e < len; ++e) amax = fmaxf(amax, fabsf(to_float(xb[e])));
      }
    }
  } else {
    for (int i = tid; i < len; i += kThreads) amax = fmaxf(amax, fabsf(to_float(xb[i])));
  }
  amax = block_max(amax, red);
  const float scale = amax == 0.f ? 1.f : amax / 127.f;
  if (tid == 0) scales[blockIdx.x] = scale;

  // ---- pass 2: codes
  int8_t* vb = vals + start;
  if (vec) {
    for (int i = tid * kVec; i < len; i += kThreads * kVec) {
      if (i + kVec <= len) {
        const uint4 raw = *reinterpret_cast<const uint4*>(xb + i);
        const T* v = reinterpret_cast<const T*>(&raw);
        alignas(8) int8_t q[kVec];
#pragma unroll
        for (int e = 0; e < kVec; ++e)
          q[e] = quant_one<kStochastic>(to_float(v[e]), scale, key, start + i + e);
        if constexpr (kVec == 8) {
          *reinterpret_cast<uint2*>(vb + i) = *reinterpret_cast<const uint2*>(q);
        } else {
          *reinterpret_cast<uint32_t*>(vb + i) = *reinterpret_cast<const uint32_t*>(q);
        }
      } else {
        for (int e = i; e < len; ++e)
          vb[e] = quant_one<kStochastic>(to_float(xb[e]), scale, key, start + e);
      }
    }
  } else {
    for (int i = tid; i < len; i += kThreads)
      vb[i] = quant_one<kStochastic>(to_float(xb[i]), scale, key, start + i);
  }
}

// One thread per 16 codes. `vec`: values are 16-byte aligned.
template <typename T>
__global__ void __launch_bounds__(kThreads)
dequant_kernel(const int8_t* __restrict__ vals, const float* __restrict__ scales, int64_t n,
               int block, T* __restrict__ out, bool vec) {
  const int64_t i0 = (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) * 16;
  if (i0 >= n) return;
  if (vec && i0 + 16 <= n) {
    const int64_t b0 = i0 / block, b1 = (i0 + 15) / block;
    const uint4 raw = *reinterpret_cast<const uint4*>(vals + i0);
    const int8_t* q = reinterpret_cast<const int8_t*>(&raw);
    alignas(16) T o[16];
    if (b0 == b1) {
      const float s = scales[b0];
#pragma unroll
      for (int e = 0; e < 16; ++e) o[e] = from_float<T>(static_cast<float>(q[e]) * s);
    } else {
#pragma unroll
      for (int e = 0; e < 16; ++e)
        o[e] = from_float<T>(static_cast<float>(q[e]) * scales[(i0 + e) / block]);
    }
    uint4* dst = reinterpret_cast<uint4*>(out + i0);
    const uint4* src = reinterpret_cast<const uint4*>(o);
#pragma unroll
    for (int w = 0; w < static_cast<int>(16 * sizeof(T) / 16); ++w) dst[w] = src[w];
  } else {
    for (int64_t i = i0; i < min(i0 + 16, n); ++i)
      out[i] = from_float<T>(static_cast<float>(vals[i]) * scales[i / block]);
  }
}

template <typename T>
int launch_quant(const void* x, int64_t n, int block, void* vals, void* scales,
                 bool stochastic, uint32_t key, cudaStream_t stream) {
  const int64_t nb = (n + block - 1) / block;
  if (nb > 2147483647LL) return cudaErrorInvalidValue;
  const bool vec = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   (static_cast<int64_t>(block) * sizeof(T)) % 16 == 0;
  const dim3 grid(static_cast<unsigned>(nb));
  if (stochastic) {
    quant_kernel<T, true><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(x), n, block, static_cast<int8_t*>(vals),
        static_cast<float*>(scales), key, vec);
  } else {
    quant_kernel<T, false><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(x), n, block, static_cast<int8_t*>(vals),
        static_cast<float*>(scales), key, vec);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dequant(const void* vals, const void* scales, int64_t n, int block, void* out,
                   cudaStream_t stream) {
  const int64_t threads = (n + 15) / 16;
  const int64_t blocks = (threads + kThreads - 1) / kThreads;
  if (blocks > 2147483647LL) return cudaErrorInvalidValue;
  const bool vec = reinterpret_cast<uintptr_t>(vals) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  dequant_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const int8_t*>(vals), static_cast<const float*>(scales), n, block,
      static_cast<T*>(out), vec);
  return static_cast<int>(cudaGetLastError());
}

int quantize(const void* x, int64_t n, int block, int dtype, void* vals, void* scales,
             bool stochastic, uint32_t key, void* stream) {
  if (n <= 0 || block <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return launch_quant<__nv_bfloat16>(x, n, block, vals, scales, stochastic, key, s);
  if (dtype == 0) return launch_quant<float>(x, n, block, vals, scales, stochastic, key, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype codes: 0 = fp32, 1 = bf16. x [n] (flat, contiguous) -> vals [n] int8,
// scales [ceil(n / block)] fp32. Each returns cudaGetLastError() after its launch.
extern "C" int ds_quantize_int8(const void* x, int64_t n, int block, int dtype, void* vals,
                                void* scales, void* stream) {
  return quantize(x, n, block, dtype, vals, scales, false, 0u, stream);
}

// key = fmix32(seed), computed by the caller (ops/quant.py:_seed_key)
extern "C" int ds_quantize_int8_stochastic(const void* x, int64_t n, int block, int dtype,
                                           void* vals, void* scales, uint32_t key,
                                           void* stream) {
  return quantize(x, n, block, dtype, vals, scales, true, key, stream);
}

// vals [n] int8, scales [ceil(n / block)] fp32 -> out [n] of out_dtype
extern "C" int ds_dequantize_int8(const void* vals, const void* scales, int64_t n, int block,
                                  int out_dtype, void* out, void* stream) {
  if (n <= 0 || block <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_dtype == 1) return launch_dequant<__nv_bfloat16>(vals, scales, n, block, out, s);
  if (out_dtype == 0) return launch_dequant<float>(vals, scales, n, block, out, s);
  return cudaErrorInvalidValue;
}

// LayerNorm forward, written by hand for Hopper (sm_90a).
//
// Replaces: deepspeed_tpu/ops/pallas/norms.py:_ln_fwd_kernel (pallas_call in
// _ln_fwd). Same math: the mean, then the variance as the mean of
// (x - mean)^2 (two passes, both in fp32: a one-pass E[x^2] - mean^2 or
// Welford update drifts on rows whose channels share a large offset), then
// (x - mean) * 1/sqrt(var + eps) * scale + bias in fp32, rounded once to x's
// dtype.
//
// What bounds it on an H100: bytes. Each row is read once and written once
// (2 * R * D * itemsize, plus the D-element scale and bias) against ~8 flops
// per element, far below the card's ~295 flops/byte ridge, so the floor is
// the 3.35 TB/s of device memory. At decode shapes ([8, 4096] bf16) the
// launch itself dominates.
//
// Design: one block of 256 threads per row, as csrc/rms_norm.cu. The row is
// read from device memory once, with 16-byte vector loads (8 bf16 or 4 fp32,
// neighbouring threads on neighbouring addresses) over its 16-byte aligned
// body and scalar loads over the head before it and the tail after it (any D:
// 4097, or a row that starts off a 16-byte boundary). Each thread keeps its
// values as fp32 in shared memory, thread-major (its c-th value at
// c * 256 + thread), so the variance pass and the output pass read them
// back without bank conflicts and without touching device memory. Sums are
// reduced with warp shuffles, then across the 8 warps through shared memory.
// The output is written 16 bytes a thread over the body. A row too wide for
// the shared-memory cache (more than kMaxCacheBytes) re-reads x for the two
// later passes instead, from L2. The kernel allocates nothing and launches
// on the caller's stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kDefaultSmem = 48 * 1024;  // dynamic shared memory without opting in
constexpr int kMaxCacheBytes = 160 * 1024;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as XLA's convert
}

// Sum over the block; every thread gets the total. The closing barrier lets
// the next call reuse `partial`.
__device__ __forceinline__ float block_sum(float v, float* partial) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) partial[warp] = v;
  __syncthreads();
  v = lane < (kThreads >> 5) ? partial[lane] : 0.f;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  __syncthreads();
  return v;
}

// The row's split: `head` scalar elements up to the first 16-byte boundary,
// `nvec` 16-byte vectors, then the scalar tail up to `dim`. Without vector
// access (`vec` false) the whole row is head.
template <typename T>
struct RowSplit {
  int64_t head, nvec, body_end;
  __device__ RowSplit(const T* xr, int64_t dim, bool vec) {
    constexpr int kVec = 16 / sizeof(T);
    const int mis = static_cast<int>((reinterpret_cast<uintptr_t>(xr) % 16) / sizeof(T));
    head = vec ? (mis ? kVec - mis : 0) : dim;
    if (head > dim) head = dim;
    nvec = (dim - head) / kVec;
    body_end = head + nvec * kVec;
  }
};

template <typename T, typename S, bool kCached>
__global__ void __launch_bounds__(kThreads)
layer_norm_kernel(const T* __restrict__ x, const S* __restrict__ scale,
                  const S* __restrict__ bias, T* __restrict__ out, int64_t dim, float eps,
                  bool vec) {
  extern __shared__ float cache[];  // kCached: this thread's c-th value at c * kThreads + tid
  __shared__ float partial[kThreads / 32];
  constexpr int kVec = 16 / sizeof(T);
  const int tid = threadIdx.x;
  const T* xr = x + static_cast<int64_t>(blockIdx.x) * dim;
  T* orow = out + static_cast<int64_t>(blockIdx.x) * dim;
  const RowSplit<T> split(xr, dim, vec);

  // pass 1: read the row once, sum it, keep it
  float sum = 0.f;
  int c = 0;
  auto keep = [&](float v) {
    sum += v;
    if (kCached) cache[(c++) * kThreads + tid] = v;
  };
  for (int64_t k = tid; k < split.head; k += kThreads) keep(to_float(xr[k]));
  for (int64_t i = tid; i < split.nvec; i += kThreads) {
    const uint4 raw = reinterpret_cast<const uint4*>(xr + split.head)[i];
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int j = 0; j < kVec; ++j) keep(to_float(e[j]));
  }
  for (int64_t k = split.body_end + tid; k < dim; k += kThreads) keep(to_float(xr[k]));
  const float mean = block_sum(sum, partial) / static_cast<float>(dim);

  // The value of element k, the thread's c-th: from the cache, or x again.
  auto value = [&](int64_t k, int ci) {
    return kCached ? cache[ci * kThreads + tid] : to_float(xr[k]);
  };

  // pass 2: the variance, mean of (x - mean)^2
  float ss = 0.f;
  c = 0;
  auto dev2 = [&](int64_t k) {
    const float d = value(k, c++) - mean;
    ss = fmaf(d, d, ss);
  };
  for (int64_t k = tid; k < split.head; k += kThreads) dev2(k);
  for (int64_t i = tid; i < split.nvec; i += kThreads) {
#pragma unroll
    for (int j = 0; j < kVec; ++j) dev2(split.head + i * kVec + j);
  }
  for (int64_t k = split.body_end + tid; k < dim; k += kThreads) dev2(k);
  const float var = block_sum(ss, partial) / static_cast<float>(dim);
  const float inv = 1.0f / sqrtf(var + eps);

  // pass 3: y = (x - mean) * inv * scale + bias, rounded once
  c = 0;
  auto y = [&](int64_t k) {
    const float n = (value(k, c++) - mean) * inv;
    return from_float<T>(n * to_float(scale[k]) + to_float(bias[k]));
  };
  for (int64_t k = tid; k < split.head; k += kThreads) orow[k] = y(k);
  for (int64_t i = tid; i < split.nvec; i += kThreads) {
    uint4 res;
    T* r = reinterpret_cast<T*>(&res);
#pragma unroll
    for (int j = 0; j < kVec; ++j) r[j] = y(split.head + i * kVec + j);
    reinterpret_cast<uint4*>(orow + split.head)[i] = res;
  }
  for (int64_t k = split.body_end + tid; k < dim; k += kThreads) orow[k] = y(k);
}

template <typename T, typename S>
cudaError_t launch(const void* x, const void* scale, const void* bias, void* out, int64_t rows,
                   int64_t dim, float eps, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  // vector access needs x and out rows on the same offset from a 16-byte
  // boundary (then every row's body is aligned in both)
  const bool vec = (reinterpret_cast<uintptr_t>(x) - reinterpret_cast<uintptr_t>(out)) % 16 == 0;
  // values a thread keeps: at most one head and one tail element besides
  // its vectors
  const int64_t per_thread = (dim + int64_t(kThreads) * kVec - 1) / (int64_t(kThreads) * kVec) * kVec + 2;
  const int64_t cache_bytes = per_thread * kThreads * static_cast<int64_t>(sizeof(float));
  const dim3 grid(static_cast<unsigned>(rows));
  if (cache_bytes <= kMaxCacheBytes) {
    auto kernel = layer_norm_kernel<T, S, true>;
    if (cache_bytes > kDefaultSmem) {
      const cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxCacheBytes);
      if (err != cudaSuccess) return err;
    }
    kernel<<<grid, kThreads, static_cast<size_t>(cache_bytes), stream>>>(
        static_cast<const T*>(x), static_cast<const S*>(scale), static_cast<const S*>(bias),
        static_cast<T*>(out), dim, eps, vec);
  } else {
    layer_norm_kernel<T, S, false><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const S*>(scale), static_cast<const S*>(bias),
        static_cast<T*>(out), dim, eps, vec);
  }
  return cudaGetLastError();
}

}  // namespace

// dtype codes: 0 = fp32, 1 = bf16; scale and bias share param_dtype. Returns
// cudaGetLastError() after the launch.
extern "C" int ds_layer_norm(const void* x, const void* scale, const void* bias, void* out,
                             int64_t rows, int64_t dim, float eps, int x_dtype, int param_dtype,
                             void* stream) {
  if (rows <= 0 || rows >= (int64_t(1) << 31) || dim <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (x_dtype == 1 && param_dtype == 1)
    err = launch<__nv_bfloat16, __nv_bfloat16>(x, scale, bias, out, rows, dim, eps, s);
  else if (x_dtype == 1 && param_dtype == 0)
    err = launch<__nv_bfloat16, float>(x, scale, bias, out, rows, dim, eps, s);
  else if (x_dtype == 0 && param_dtype == 1)
    err = launch<float, __nv_bfloat16>(x, scale, bias, out, rows, dim, eps, s);
  else if (x_dtype == 0 && param_dtype == 0)
    err = launch<float, float>(x, scale, bias, out, rows, dim, eps, s);
  else
    return cudaErrorInvalidValue;
  return static_cast<int>(err);
}

// RMSNorm forward, written by hand for Hopper (sm_90a).
//
// Replaces: deepspeed_tpu/ops/pallas/norms.py:_rms_fwd_kernel (pallas_call in
// _rms_fwd). Same math: mean of squares in fp32, y = x * 1/sqrt(var + eps),
// the scale multiplied in fp32, the result rounded once to x's dtype.
//
// What bounds it on an H100: bytes. Each row is read once and written once
// (2 * R * D * itemsize, plus the D-element scale) against ~2 flops per
// element, far below the card's ~295 flops/byte ridge, so the floor is the
// 3.35 TB/s of device memory. At decode shapes ([8, 4096] bf16, 64 KB in all)
// the launch itself dominates; that is accepted for now (a fused
// residual-add + norm, or a CUDA graph of the decode step, is the later fix).
//
// Design: one block per row, 256 threads. The row is read with 16-byte
// vector loads (8 bf16 or 4 fp32 per load, neighbouring threads on
// neighbouring addresses), squares are summed in fp32 in registers, reduced
// with warp shuffles and then across the 8 warps through shared memory. The
// second pass re-reads the row (an 8 KB bf16 row is still in L1) and writes
// the scaled result, again 16 bytes per thread. Rows whose width is not a
// multiple of the vector take a scalar path. The kernel allocates nothing and
// launches on the caller's stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as XLA's convert
}

// Sum over the block; every thread gets the total.
__device__ __forceinline__ float block_sum(float v, float* partial) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) partial[warp] = v;
  __syncthreads();
  v = lane < (blockDim.x >> 5) ? partial[lane] : 0.f;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T, typename S>
__global__ void __launch_bounds__(kThreads)
rms_norm_kernel(const T* __restrict__ x, const S* __restrict__ scale, T* __restrict__ out,
                int64_t dim, float eps, bool vectorized) {
  __shared__ float partial[kThreads / 32];
  constexpr int kVec = 16 / sizeof(T);  // elements per 16-byte load
  const T* xr = x + blockIdx.x * dim;
  T* orow = out + blockIdx.x * dim;

  float ss = 0.f;
  if (vectorized) {
    const int64_t nvec = dim / kVec;
    for (int64_t i = threadIdx.x; i < nvec; i += kThreads) {
      const uint4 raw = reinterpret_cast<const uint4*>(xr)[i];
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        const float f = to_float(e[j]);
        ss = fmaf(f, f, ss);
      }
    }
  } else {
    for (int64_t i = threadIdx.x; i < dim; i += kThreads) {
      const float f = to_float(xr[i]);
      ss = fmaf(f, f, ss);
    }
  }
  ss = block_sum(ss, partial);
  const float inv = 1.0f / sqrtf(ss / static_cast<float>(dim) + eps);

  if (vectorized) {
    const int64_t nvec = dim / kVec;
    for (int64_t i = threadIdx.x; i < nvec; i += kThreads) {
      const uint4 raw = reinterpret_cast<const uint4*>(xr)[i];
      const T* e = reinterpret_cast<const T*>(&raw);
      uint4 res;
      T* r = reinterpret_cast<T*>(&res);
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        const float y = to_float(e[j]) * inv;
        r[j] = from_float<T>(y * to_float(scale[i * kVec + j]));
      }
      reinterpret_cast<uint4*>(orow)[i] = res;
    }
  } else {
    for (int64_t i = threadIdx.x; i < dim; i += kThreads) {
      const float y = to_float(xr[i]) * inv;
      orow[i] = from_float<T>(y * to_float(scale[i]));
    }
  }
}

template <typename T, typename S>
void launch(const void* x, const void* scale, void* out, int64_t rows, int64_t dim, float eps,
            cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const bool vectorized = dim % kVec == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                          reinterpret_cast<uintptr_t>(out) % 16 == 0;
  rms_norm_kernel<T, S><<<static_cast<unsigned>(rows), kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const S*>(scale), static_cast<T*>(out), dim, eps,
      vectorized);
}

}  // namespace

// dtype codes: 0 = fp32, 1 = bf16. Returns cudaGetLastError() after the launch.
extern "C" int ds_rms_norm(const void* x, const void* scale, void* out, int64_t rows,
                           int64_t dim, float eps, int x_dtype, int scale_dtype, void* stream) {
  if (rows <= 0 || rows >= (int64_t(1) << 31) || dim <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == 1 && scale_dtype == 1)
    launch<__nv_bfloat16, __nv_bfloat16>(x, scale, out, rows, dim, eps, s);
  else if (x_dtype == 1 && scale_dtype == 0)
    launch<__nv_bfloat16, float>(x, scale, out, rows, dim, eps, s);
  else if (x_dtype == 0 && scale_dtype == 1)
    launch<float, __nv_bfloat16>(x, scale, out, rows, dim, eps, s);
  else if (x_dtype == 0 && scale_dtype == 0)
    launch<float, float>(x, scale, out, rows, dim, eps, s);
  else
    return cudaErrorInvalidValue;
  return static_cast<int>(cudaGetLastError());
}

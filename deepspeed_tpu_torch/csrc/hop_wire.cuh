// The block wire shared by the hop kernels (ring_hop.cu, fused_gemm.cu).
//
// A wire element is a 1-byte code with one fp32 scale per block of qb
// elements: int8 (code 1, qmax 127, rint half to even and a clip to +-127)
// or float8_e4m3fn (code 2, qmax 448, an RN cast with saturation). The scale
// is absmax / qmax by IEEE division (1 for an all-zero block) and a code is
// value / scale by IEEE division; decode is code * scale with __fmul_rn. So
// codes, scales and decoded values equal the plain block math of
// deepspeed_tpu_torch/ops/quant.py bit for bit.

#pragma once

#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace hop_wire {

template <int kCode> struct WireCode;
template <> struct WireCode<1> {  // int8
  static constexpr float kQmax = 127.f;
  __device__ static float decode(const void* q, int64_t i) {
    return static_cast<float>(static_cast<const int8_t*>(q)[i]);
  }
  __device__ static void encode(void* q, int64_t i, float v) {
    static_cast<int8_t*>(q)[i] = static_cast<int8_t>(fminf(fmaxf(rintf(v), -127.f), 127.f));
  }
};
template <> struct WireCode<2> {  // float8_e4m3fn
  static constexpr float kQmax = 448.f;
  __device__ static float decode(const void* q, int64_t i) {
    __nv_fp8_e4m3 f;
    f.__x = static_cast<const __nv_fp8_storage_t*>(q)[i];
    return static_cast<float>(f);
  }
  __device__ static void encode(void* q, int64_t i, float v) {
    static_cast<__nv_fp8_storage_t*>(q)[i] = __nv_fp8_e4m3(v).__x;
  }
};

// The block's scale from its absmax.
template <int kCode>
__device__ __forceinline__ float block_scale(float amax) {
  return amax == 0.f ? 1.f : amax / WireCode<kCode>::kQmax;
}

// The largest |value| over a warp's lanes.
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// The current device's SM count, queried once per device.
inline int sm_count() {
  constexpr int kMaxDevices = 64;
  static int sms[kMaxDevices] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices) return 132;
  if (sms[dev] == 0 &&
      cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    sms[dev] = 132;
  return sms[dev];
}

}  // namespace hop_wire

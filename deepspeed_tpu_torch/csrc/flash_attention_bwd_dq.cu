// ds_flash_bwd_dq: dq of causal GQA flash attention, written by hand for
// Hopper (sm_90a). Replaces _bwd_dq_kernel of
// deepspeed_tpu/ops/pallas/flash_attention.py, with and without ALiBi. Bound
// by operations (three products per key tile); design notes in
// flash_attention.cuh.

#include "flash_attention.cuh"

using namespace ds_flash;

namespace {

// ---------------------------------------------------------------- dq
template <typename T, int HD, bool kAlibi>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const int* __restrict__ keep, const float* __restrict__ slopes,
                    const T* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    T* __restrict__ dq, int S, int H, int kvH, float scale) {
  using L = QTileSmem<T, HD, true>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  T* q_s = sm + L::kQ;
  T* do_s = sm + L::kDo;
  T* k_s = sm + L::kK;
  T* v_s = sm + L::kV;
  T* ds_s = sm + L::kP;
  int* keep_s = reinterpret_cast<int*>(sm + L::kEnd);

  const int q0 = blockIdx.x * kRows, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / kvH);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int64_t q_stride = static_cast<int64_t>(H) * HD, kv_stride = static_cast<int64_t>(kvH) * HD;
  const int64_t q_off = static_cast<int64_t>(b) * S * q_stride + static_cast<int64_t>(h) * HD;
  const T* kb = k + static_cast<int64_t>(b) * S * kv_stride + static_cast<int64_t>(kvh) * HD;
  const T* vb = v + static_cast<int64_t>(b) * S * kv_stride + static_cast<int64_t>(kvh) * HD;
  const int* keep_b = keep == nullptr ? nullptr : keep + static_cast<int64_t>(b) * S;

  load_rows<T, kRows, HD>(q_s, L::kLd, q + q_off, q_stride, q0, S);
  load_rows<T, kRows, HD>(do_s, L::kLd, dout + q_off, q_stride, q0, S);
  const int row[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int64_t idx = (static_cast<int64_t>(b) * H + h) * S + row[i];
    const float x = row[i] < S ? lse[idx] : 0.f;
    lse_r[i] = x == kNegInf ? 0.f : x;
    delta_r[i] = row[i] < S ? delta[idx] : 0.f;
  }
  const T* qw = q_s + warp * 16 * L::kLd;
  const T* dow = do_s + warp * 16 * L::kLd;
  T* dsw = ds_s + warp * 16 * L::kLdK;
  float acc[HD / 8][4] = {};
  const float slope = kAlibi ? slopes[h] : 0.f;

  const int n_tiles = (min(q0 + kRows, S) - 1) / kKeys + 1;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kKeys;
    __syncthreads();
    load_rows<T, kKeys, HD>(k_s, L::kLd, kb, kv_stride, k0, S);
    load_rows<T, kKeys, HD>(v_s, L::kLd, vb, kv_stride, k0, S);
    load_keep(keep_s, kKeys, keep_b, k0, S);
    __syncthreads();

    float p[kKeys / 8][4] = {};
    warp_gemm<kKeys, HD, false>(p, qw, L::kLd, k_s, L::kLd);
    if constexpr (kAlibi) {  // every tile, before the mask
      const int base[2] = {k0 + 2 * t - row[0], k0 + 2 * t - row[1]};
      add_alibi<kKeys, 1>(p, slope, base);
    }
    const bool masked = keep_b != nullptr || k0 + kKeys - 1 > q0 || k0 + kKeys > S;
#pragma unroll
    for (int n = 0; n < kKeys / 8; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = n * 8 + 2 * t + (c & 1);
        const bool ok = !masked || (keep_s[col] && k0 + col <= row[c >> 1]);
        p[n][c] = exp2f((ok ? p[n][c] : kNegInf) - lse_r[c >> 1]);
      }
    float dp[kKeys / 8][4] = {};
    warp_gemm<kKeys, HD, false>(dp, dow, L::kLd, v_s, L::kLd);
#pragma unroll
    for (int n = 0; n < kKeys / 8; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) dp[n][c] = p[n][c] * (dp[n][c] - delta_r[c >> 1]);
    warp_gemm_frag<HD, kKeys>(acc, dp, dsw, L::kLdK, k_s, L::kLd);  // dS in k's dtype
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (row[i] >= S) continue;
    T* dst = dq + (static_cast<int64_t>(b) * S + row[i]) * q_stride + static_cast<int64_t>(h) * HD;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
      store_pair(dst + n * 8 + 2 * t, acc[n][2 * i] * scale, acc[n][2 * i + 1] * scale);
  }
}

template <typename T, int HD>
int launch_dq(const void* q, const void* k, const void* v, const void* keep, const void* slopes,
              const void* dout, const void* lse, const void* delta, void* dq, int B, int S,
              int H, int kvH, float scale, cudaStream_t stream) {
  constexpr size_t kBytes = QTileSmem<T, HD, true>::kBytes;
  const auto kernel =
      slopes != nullptr ? flash_bwd_dq_kernel<T, HD, true> : flash_bwd_dq_kernel<T, HD, false>;
  const cudaError_t err = set_smem(kernel, kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + kRows - 1) / kRows, H, B);
  kernel<<<grid, kThreads, kBytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(keep), static_cast<const float*>(slopes),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dq), S, H, kvH, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// See flash_attention.cuh for the dtype codes and layouts.
extern "C" int ds_flash_bwd_dq(const void* q, const void* k, const void* v, const void* keep,
                               const void* slopes, const void* dout, const void* lse,
                               const void* delta, void* dq, int B, int S, int H, int kvH, int hd,
                               float scale, int dtype, void* stream) {
  if (bad_shape(B, S, H, kvH)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DS_CALL(T, HD) \
  launch_dq<T, HD>(q, k, v, keep, slopes, dout, lse, delta, dq, B, S, H, kvH, scale, s)
  DS_FLASH_DISPATCH(DS_CALL);
#undef DS_CALL
}

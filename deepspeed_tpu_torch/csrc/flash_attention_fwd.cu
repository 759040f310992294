// ds_flash_fwd: causal GQA flash-attention forward, written by hand for
// Hopper (sm_90a). Replaces _fwd_kernel of
// deepspeed_tpu/ops/pallas/flash_attention.py, with and without ALiBi (the
// kAlibi form adds _alibi_add's bias in its relative form). What bounds it (operations,
// ~1400 flops per byte at the Llama-3.2-1B training shape) and the design
// (64-row query tiles, 4 warps, mma.sync bf16 with fp32 accumulation, a key
// loop that stops at the diagonal) are in flash_attention.cuh.

#include "flash_attention.cuh"

using namespace ds_flash;

namespace {

// ---------------------------------------------------------------- forward
template <typename T, int HD, bool kAlibi>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const int* __restrict__ keep, const float* __restrict__ slopes,
                 T* __restrict__ out, float* __restrict__ lse, int S, int H, int kvH) {
  using L = QTileSmem<T, HD, false>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  T* q_s = sm + L::kQ;
  T* k_s = sm + L::kK;
  T* v_s = sm + L::kV;
  T* p_s = sm + L::kP;
  int* keep_s = reinterpret_cast<int*>(sm + L::kEnd);

  const int q0 = blockIdx.x * kRows, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / kvH);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int64_t q_stride = static_cast<int64_t>(H) * HD, kv_stride = static_cast<int64_t>(kvH) * HD;
  const T* qb = q + static_cast<int64_t>(b) * S * q_stride + static_cast<int64_t>(h) * HD;
  const T* kb = k + static_cast<int64_t>(b) * S * kv_stride + static_cast<int64_t>(kvh) * HD;
  const T* vb = v + static_cast<int64_t>(b) * S * kv_stride + static_cast<int64_t>(kvh) * HD;
  const int* keep_b = keep == nullptr ? nullptr : keep + static_cast<int64_t>(b) * S;

  load_rows<T, kRows, HD>(q_s, L::kLd, qb, q_stride, q0, S);
  const T* qw = q_s + warp * 16 * L::kLd;
  T* pw = p_s + warp * 16 * L::kLdK;
  const int row[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  float o[HD / 8][4] = {};
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  const float slope = kAlibi ? slopes[h] : 0.f;

  const int n_tiles = (min(q0 + kRows, S) - 1) / kKeys + 1;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kKeys;
    __syncthreads();  // the previous step's K, V reads are done
    load_rows<T, kKeys, HD>(k_s, L::kLd, kb, kv_stride, k0, S);
    load_rows<T, kKeys, HD>(v_s, L::kLd, vb, kv_stride, k0, S);
    load_keep(keep_s, kKeys, keep_b, k0, S);
    __syncthreads();

    float s[kKeys / 8][4] = {};
    warp_gemm<kKeys, HD, false>(s, qw, L::kLd, k_s, L::kLd);
    if constexpr (kAlibi) {  // every tile, before the mask
      const int base[2] = {k0 + 2 * t - row[0], k0 + 2 * t - row[1]};
      add_alibi<kKeys, 1>(s, slope, base);
    }
    if (keep_b != nullptr || k0 + kKeys - 1 > q0 || k0 + kKeys > S) {
#pragma unroll
      for (int n = 0; n < kKeys / 8; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int col = n * 8 + 2 * t + (c & 1);
          if (!(keep_s[col] && k0 + col <= row[c >> 1])) s[n][c] = kNegInf;
        }
    }
    // online softmax, base 2: rows g (c = 0, 1) and g + 8 (c = 2, 3); the 4
    // lanes of a group share a row
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = kNegInf;
#pragma unroll
      for (int n = 0; n < kKeys / 8; ++n) mx = fmaxf(mx, fmaxf(s[n][2 * i], s[n][2 * i + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_cur = fmaxf(m[i], mx);
      const float m_safe = m_cur == kNegInf ? 0.f : m_cur;
      const float alpha = m[i] == kNegInf ? 0.f : exp2f(m[i] - m_safe);
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < kKeys / 8; ++n) {
        s[n][2 * i] = exp2f(s[n][2 * i] - m_safe);
        s[n][2 * i + 1] = exp2f(s[n][2 * i + 1] - m_safe);
        sum += s[n][2 * i] + s[n][2 * i + 1];
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l[i] = alpha * l[i] + sum;
      m[i] = m_cur;
#pragma unroll
      for (int n = 0; n < HD / 8; ++n) {
        o[n][2 * i] *= alpha;
        o[n][2 * i + 1] *= alpha;
      }
    }
    warp_gemm_frag<HD, kKeys>(o, s, pw, L::kLdK, v_s, L::kLd);  // P in V's dtype
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (row[i] >= S) continue;
    const float l_safe = l[i] == 0.f ? 1.f : l[i];
    T* dst = out + (static_cast<int64_t>(b) * S + row[i]) * q_stride + static_cast<int64_t>(h) * HD;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
      store_pair(dst + n * 8 + 2 * t, o[n][2 * i] / l_safe, o[n][2 * i + 1] / l_safe);
    if (t == 0)
      lse[(static_cast<int64_t>(b) * H + h) * S + row[i]] =
          l[i] == 0.f ? kNegInf : m[i] + log2f(l_safe);
  }
}

template <typename T, int HD>
int launch_fwd(const void* q, const void* k, const void* v, const void* keep, const void* slopes,
               void* out, void* lse, int B, int S, int H, int kvH, cudaStream_t stream) {
  constexpr size_t kBytes = QTileSmem<T, HD, false>::kBytes;
  const auto kernel =
      slopes != nullptr ? flash_fwd_kernel<T, HD, true> : flash_fwd_kernel<T, HD, false>;
  const cudaError_t err = set_smem(kernel, kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + kRows - 1) / kRows, H, B);
  kernel<<<grid, kThreads, kBytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(keep), static_cast<const float*>(slopes), static_cast<T*>(out),
      static_cast<float*>(lse), S, H, kvH);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// See flash_attention.cuh for the dtype codes and layouts.
extern "C" int ds_flash_fwd(const void* q, const void* k, const void* v, const void* keep,
                            const void* slopes, void* out, void* lse, int B, int S, int H,
                            int kvH, int hd, int dtype, void* stream) {
  if (bad_shape(B, S, H, kvH)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DS_CALL(T, HD) launch_fwd<T, HD>(q, k, v, keep, slopes, out, lse, B, S, H, kvH, s)
  DS_FLASH_DISPATCH(DS_CALL);
#undef DS_CALL
}

// ds_flash_bwd_dkv: dk and dv of causal GQA flash attention, summed over
// the query heads of each kv head, written by hand for Hopper (sm_90a).
// Replaces _bwd_dkv_kernel of deepspeed_tpu/ops/pallas/flash_attention.py,
// with and without ALiBi. Here a warp's rows are keys and its columns
// queries, so the bias is slope * (key - query) in that orientation, and the
// slope is the query head's (h = kvh * G + gi of the loop over the group),
// not the kv head's. Bound by operations (four products per query tile); design notes in
// flash_attention.cuh.

#include "flash_attention.cuh"

using namespace ds_flash;

namespace {

// ---------------------------------------------------------------- dk, dv
template <typename T, int HD, int BQ>
struct KvSmem {
  static constexpr int kLd = HD + kPad;   // rows of hd
  static constexpr int kLdQ = BQ + kPad;  // rows of queries
  static constexpr int kK = 0;
  static constexpr int kV = kK + kRows * kLd;
  static constexpr int kQ = kV + kRows * kLd;
  static constexpr int kDo = kQ + BQ * kLd;
  static constexpr int kP = kDo + BQ * kLd;  // P^T then dS^T: [kRows][kLdQ]
  static constexpr int kEnd = kP + kRows * kLdQ;
  static constexpr size_t kBytes = kEnd * sizeof(T) + (2 * BQ + kRows) * sizeof(float);
};

template <typename T, int HD, int BQ, bool kAlibi>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const int* __restrict__ keep, const float* __restrict__ slopes,
                     const T* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     T* __restrict__ dk, T* __restrict__ dv, int S, int H, int kvH,
                     float dk_scale) {
  using L = KvSmem<T, HD, BQ>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  T* k_s = sm + L::kK;
  T* v_s = sm + L::kV;
  T* q_s = sm + L::kQ;
  T* do_s = sm + L::kDo;
  T* p_s = sm + L::kP;
  float* lse_s = reinterpret_cast<float*>(sm + L::kEnd);
  float* delta_s = lse_s + BQ;
  int* keep_s = reinterpret_cast<int*>(delta_s + BQ);

  const int k0 = blockIdx.x * kRows, kvh = blockIdx.y, b = blockIdx.z;
  const int G = H / kvH;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int64_t q_stride = static_cast<int64_t>(H) * HD, kv_stride = static_cast<int64_t>(kvH) * HD;
  const int64_t kv_off = static_cast<int64_t>(b) * S * kv_stride + static_cast<int64_t>(kvh) * HD;
  const int* keep_b = keep == nullptr ? nullptr : keep + static_cast<int64_t>(b) * S;

  load_rows<T, kRows, HD>(k_s, L::kLd, k + kv_off, kv_stride, k0, S);
  load_rows<T, kRows, HD>(v_s, L::kLd, v + kv_off, kv_stride, k0, S);
  load_keep(keep_s, kRows, keep_b, k0, S);
  const int key[2] = {k0 + warp * 16 + g, k0 + warp * 16 + g + 8};
  const T* kw = k_s + warp * 16 * L::kLd;
  const T* vw = v_s + warp * 16 * L::kLd;
  T* pw = p_s + warp * 16 * L::kLdQ;
  float dk_acc[HD / 8][4] = {}, dv_acc[HD / 8][4] = {};

  const int first_tile = k0 / BQ, n_tiles = (S + BQ - 1) / BQ;
  for (int gi = 0; gi < G; ++gi) {
    const int h = kvh * G + gi;
    const int64_t q_off = static_cast<int64_t>(b) * S * q_stride + static_cast<int64_t>(h) * HD;
    const float* lse_h = lse + (static_cast<int64_t>(b) * H + h) * S;
    const float* delta_h = delta + (static_cast<int64_t>(b) * H + h) * S;
    const float slope = kAlibi ? slopes[h] : 0.f;
    for (int qt = first_tile; qt < n_tiles; ++qt) {
      const int q0 = qt * BQ;
      __syncthreads();
      load_rows<T, BQ, HD>(q_s, L::kLd, q + q_off, q_stride, q0, S);
      load_rows<T, BQ, HD>(do_s, L::kLd, dout + q_off, q_stride, q0, S);
      for (int j = threadIdx.x; j < BQ; j += kThreads) {
        const float x = q0 + j < S ? lse_h[q0 + j] : 0.f;
        lse_s[j] = x == kNegInf ? 0.f : x;
        delta_s[j] = q0 + j < S ? delta_h[q0 + j] : 0.f;
      }
      __syncthreads();

      // P^T = exp2(K Q^T - lse), one warp's 16 keys x BQ queries
      float p[BQ / 8][4] = {};
      warp_gemm<BQ, HD, false>(p, kw, L::kLd, q_s, L::kLd);
      if constexpr (kAlibi) {  // every tile, before the mask; columns are queries
        const int base[2] = {key[0] - q0 - 2 * t, key[1] - q0 - 2 * t};
        add_alibi<BQ, -1>(p, slope, base);
      }
      const bool masked = keep_b != nullptr || q0 < k0 + kRows - 1 || q0 + BQ > S;
#pragma unroll
      for (int n = 0; n < BQ / 8; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int col = n * 8 + 2 * t + (c & 1);
          const int kr = c >> 1;
          const bool ok = !masked || (keep_s[key[kr] - k0] && key[kr] <= q0 + col && q0 + col < S);
          p[n][c] = exp2f((ok ? p[n][c] : kNegInf) - lse_s[col]);
        }
      // dP^T = V dO^T
      float ds[BQ / 8][4] = {};
      warp_gemm<BQ, HD, false>(ds, vw, L::kLd, do_s, L::kLd);
      // P^T, then dS^T, pass through shared memory here: keeping them in
      // registers, as fwd and dq do, measured slower for this kernel
      warp_gemm_frag<HD, BQ, true>(dv_acc, p, pw, L::kLdQ, do_s, L::kLd);  // P^T in dO's dtype
#pragma unroll
      for (int n = 0; n < BQ / 8; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int col = n * 8 + 2 * t + (c & 1);
          ds[n][c] = p[n][c] * (ds[n][c] - delta_s[col]);
        }
      warp_gemm_frag<HD, BQ, true>(dk_acc, ds, pw, L::kLdQ, q_s, L::kLd);  // dS^T in q's dtype
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (key[i] >= S) continue;
    const int64_t off = kv_off + static_cast<int64_t>(key[i]) * kv_stride;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      store_pair(dk + off + n * 8 + 2 * t, dk_acc[n][2 * i] * dk_scale,
                 dk_acc[n][2 * i + 1] * dk_scale);
      store_pair(dv + off + n * 8 + 2 * t, dv_acc[n][2 * i], dv_acc[n][2 * i + 1]);
    }
  }
}

template <typename T, int HD>
int launch_dkv(const void* q, const void* k, const void* v, const void* keep, const void* slopes,
               const void* dout, const void* lse, const void* delta, void* dk, void* dv, int B,
               int S, int H, int kvH, float dk_scale, cudaStream_t stream) {
  // a smaller query tile at hd 128 keeps dk and dv (2 x 64 fp32 per thread)
  // and the two score fragments within the register file
  constexpr int BQ = HD == 128 ? 32 : 64;
  constexpr size_t kBytes = KvSmem<T, HD, BQ>::kBytes;
  const auto kernel = slopes != nullptr ? flash_bwd_dkv_kernel<T, HD, BQ, true>
                                         : flash_bwd_dkv_kernel<T, HD, BQ, false>;
  const cudaError_t err = set_smem(kernel, kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + kRows - 1) / kRows, kvH, B);
  kernel<<<grid, kThreads, kBytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(keep), static_cast<const float*>(slopes),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dk), static_cast<T*>(dv), S, H, kvH,
      dk_scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// See flash_attention.cuh for the dtype codes and layouts.
extern "C" int ds_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* keep,
                                const void* slopes, const void* dout, const void* lse,
                                const void* delta, void* dk, void* dv, int B, int S, int H,
                                int kvH, int hd, float dk_scale, int dtype, void* stream) {
  if (bad_shape(B, S, H, kvH)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DS_CALL(T, HD) \
  launch_dkv<T, HD>(q, k, v, keep, slopes, dout, lse, delta, dk, dv, B, S, H, kvH, dk_scale, s)
  DS_FLASH_DISPATCH(DS_CALL);
#undef DS_CALL
}

// ds_sparse_bwd_dq: dq of tile-skipping block-sparse attention, written by
// hand for Hopper (sm_90a). Replaces _sparse_dq_kernel of
// deepspeed_tpu/ops/pallas/sparse_attention.py. It walks the forward's lists
// (per query block, its live key tiles), recomputes p from the saved lse and
// sums dS K in fp32; bound by bytes, design notes in sparse_attention.cuh.

#include "sparse_attention.cuh"

using namespace ds_flash;
using namespace ds_sparse;

namespace {

template <typename T, int HD, int BLK>
__global__ void __launch_bounds__(threads<BLK>(), min_blocks<T, HD, BLK>())
sparse_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const T* __restrict__ dout, const float* __restrict__ lse,
                 const float* __restrict__ delta, const int* __restrict__ cols,
                 const int* __restrict__ ncols, float* __restrict__ dq, int H, int Hkv, int S,
                 int A, int causal) {
  constexpr int NT = threads<BLK>();
  using L = QBlockSmem<T, HD, BLK, true>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  T* q_s = sm + L::kQ;
  T* do_s = sm + L::kDo;
  T* k_s = sm + L::kK;
  T* v_s = sm + L::kV;
  T* ds_s = sm + L::kP;

  const int qi = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int n = S / BLK;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int64_t bh = static_cast<int64_t>(b) * H + h;
  const int qstride = H * HD, kvstride = Hkv * HD;  // row strides
  // kv head h / (H / Hkv) as an offset from the k and v parameters, which
  // stay in the constant bank: two fewer pointers held in registers
  const int64_t kv0 = head_rows<HD>(k, b, S, Hkv, h / (H / Hkv)) - k;
  const int64_t list = static_cast<int64_t>(h) * n + qi;
  const int* cl = cols + list * A;
  const int nc = ncols[list];

  load_tile<T, BLK, HD, NT>(q_s, L::kLd, head_rows<HD>(q, b, S, H, h), qstride, qi * BLK);
  load_tile<T, BLK, HD, NT>(do_s, L::kLd, head_rows<HD>(dout, b, S, H, h), qstride, qi * BLK);
  const int row[2] = {warp * 16 + g, warp * 16 + g + 8};  // within the query block
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int64_t idx = bh * S + qi * BLK + row[i];
    lse_r[i] = lse[idx] == kNegInf ? 0.f : lse[idx];
    delta_r[i] = delta[idx];
  }
  const T* qw = q_s + warp * 16 * L::kLd;
  const T* dow = do_s + warp * 16 * L::kLd;
  T* dsw = ds_s + warp * 16 * L::kLdP;
  float acc[HD / 8][4] = {};

  for (int j = 0; j < nc; ++j) {
    const int kj = cl[j];
    if (causal && kj > qi) continue;  // uniform over the block
    __syncthreads();
    const int64_t kv = kv0 + static_cast<int64_t>(kj) * BLK * kvstride;
    load_tile<T, BLK, HD, NT>(k_s, L::kLd, k + kv, kvstride, 0);
    load_tile<T, BLK, HD, NT>(v_s, L::kLd, v + kv, kvstride, 0);
    __syncthreads();

    float p[BLK / 8][4] = {};
    warp_gemm<BLK, HD, false>(p, qw, L::kLd, k_s, L::kLd);
    const bool diag = causal && kj == qi;
#pragma unroll
    for (int nn = 0; nn < BLK / 8; ++nn)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const bool ok = !diag || nn * 8 + 2 * t + (c & 1) <= row[c >> 1];
        p[nn][c] = expf((ok ? p[nn][c] : kNegInf) - lse_r[c >> 1]);
      }
    float dp[BLK / 8][4] = {};
    warp_gemm<BLK, HD, false>(dp, dow, L::kLd, v_s, L::kLd);
#pragma unroll
    for (int nn = 0; nn < BLK / 8; ++nn)
#pragma unroll
      for (int c = 0; c < 4; ++c) dp[nn][c] = p[nn][c] * (dp[nn][c] - delta_r[c >> 1]);
    warp_gemm_frag<HD, BLK>(acc, dp, dsw, L::kLdP, k_s, L::kLd);  // dS in K's dtype
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float* dst = head_rows<HD>(dq, b, S, H, h) + static_cast<int64_t>(qi * BLK + row[i]) * qstride;
#pragma unroll
    for (int nn = 0; nn < HD / 8; ++nn)
      store_pair(dst + nn * 8 + 2 * t, acc[nn][2 * i], acc[nn][2 * i + 1]);
  }
}

template <typename T, int HD, int BLK>
int launch_dq(const void* q, const void* k, const void* v, const void* dout, const void* lse,
              const void* delta, const void* cols, const void* ncols, void* dq, int B, int H,
              int Hkv, int S, int A, int causal, cudaStream_t stream) {
  constexpr size_t kBytes = QBlockSmem<T, HD, BLK, true>::kBytes;
  const cudaError_t err = set_smem(sparse_dq_kernel<T, HD, BLK>, kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(S / BLK, H, B);
  sparse_dq_kernel<T, HD, BLK><<<grid, threads<BLK>(), kBytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<const int*>(cols),
      static_cast<const int*>(ncols), static_cast<float*>(dq), H, Hkv, S, A, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// See sparse_attention.cuh for the layouts and the dtype codes.
extern "C" int ds_sparse_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                                const void* lse, const void* delta, const void* cols,
                                const void* ncols, void* dq, int B, int H, int Hkv, int S,
                                int hd, int block, int A, int causal, int dtype, void* stream) {
  if (ds_sparse::bad_shape(B, H, Hkv, S, block, A)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DS_CALL(T, HD, BLK) \
  launch_dq<T, HD, BLK>(q, k, v, dout, lse, delta, cols, ncols, dq, B, H, Hkv, S, A, causal, s)
  DS_SPARSE_DISPATCH(DS_CALL);
#undef DS_CALL
}

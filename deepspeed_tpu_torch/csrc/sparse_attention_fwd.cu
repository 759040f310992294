// ds_sparse_fwd: tile-skipping block-sparse attention forward, written by
// hand for Hopper (sm_90a). Replaces _sparse_fwd_kernel of
// deepspeed_tpu/ops/pallas/sparse_attention.py. What bounds it (bytes) and
// the design (one thread block per query block, a warp per 16 rows, a loop
// over the block row's live key tiles with an online softmax in base e) are
// in sparse_attention.cuh.

#include "sparse_attention.cuh"

using namespace ds_flash;
using namespace ds_sparse;

namespace {

template <typename T, int HD, int BLK>
__global__ void __launch_bounds__(threads<BLK>(), min_blocks<T, HD, BLK>())
sparse_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                  const int* __restrict__ cols, const int* __restrict__ ncols,
                  T* __restrict__ out, float* __restrict__ lse, int H, int Hkv, int S, int A,
                  int causal) {
  constexpr int NT = threads<BLK>();
  using L = QBlockSmem<T, HD, BLK, false>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  T* q_s = sm + L::kQ;
  T* k_s = sm + L::kK;
  T* v_s = sm + L::kV;
  T* p_s = sm + L::kP;

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
  const T* qw = q_s + warp * 16 * L::kLd;
  T* pw = p_s + warp * 16 * L::kLdP;
  const int row[2] = {warp * 16 + g, warp * 16 + g + 8};  // within the query block
  float o[HD / 8][4] = {};
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  for (int j = 0; j < nc; ++j) {
    const int kj = cl[j];
    if (causal && kj > qi) continue;  // uniform over the block
    __syncthreads();  // the previous tile's K, V reads are done
    const int64_t kv = kv0 + static_cast<int64_t>(kj) * BLK * kvstride;
    load_tile<T, BLK, HD, NT>(k_s, L::kLd, k + kv, kvstride, 0);
    load_tile<T, BLK, HD, NT>(v_s, L::kLd, v + kv, kvstride, 0);
    __syncthreads();

    float s[BLK / 8][4] = {};
    warp_gemm<BLK, HD, false>(s, qw, L::kLd, k_s, L::kLd);
    if (causal && kj == qi) {  // the diagonal tile: col <= row
#pragma unroll
      for (int nn = 0; nn < BLK / 8; ++nn)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (nn * 8 + 2 * t + (c & 1) > row[c >> 1]) s[nn][c] = kNegInf;
    }
    // online softmax, base e: rows g (c = 0, 1) and g + 8 (c = 2, 3); the 4
    // lanes of a group share a row
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = kNegInf;
#pragma unroll
      for (int nn = 0; nn < BLK / 8; ++nn) mx = fmaxf(mx, fmaxf(s[nn][2 * i], s[nn][2 * i + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_cur = fmaxf(m[i], mx);
      const float m_safe = m_cur == kNegInf ? 0.f : m_cur;
      const float alpha = m[i] == kNegInf ? 0.f : expf(m[i] - m_safe);
      float sum = 0.f;
#pragma unroll
      for (int nn = 0; nn < BLK / 8; ++nn) {
        s[nn][2 * i] = expf(s[nn][2 * i] - m_safe);
        s[nn][2 * i + 1] = expf(s[nn][2 * i + 1] - m_safe);
        sum += s[nn][2 * i] + s[nn][2 * i + 1];
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l[i] = alpha * l[i] + sum;
      m[i] = m_cur;
#pragma unroll
      for (int nn = 0; nn < HD / 8; ++nn) {
        o[nn][2 * i] *= alpha;
        o[nn][2 * i + 1] *= alpha;
      }
    }
    warp_gemm_frag<HD, BLK>(o, s, pw, L::kLdP, v_s, L::kLd);  // P in V's dtype
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = qi * BLK + row[i];
    const float l_safe = l[i] == 0.f ? 1.f : l[i];
    T* dst = head_rows<HD>(out, b, S, H, h) + static_cast<int64_t>(r) * qstride;
#pragma unroll
    for (int nn = 0; nn < HD / 8; ++nn)
      store_pair(dst + nn * 8 + 2 * t, o[nn][2 * i] / l_safe, o[nn][2 * i + 1] / l_safe);
    if (t == 0) lse[bh * S + r] = l[i] == 0.f ? kNegInf : m[i] + logf(l_safe);
  }
}

template <typename T, int HD, int BLK>
int launch_fwd(const void* q, const void* k, const void* v, const void* cols, const void* ncols,
               void* out, void* lse, int B, int H, int Hkv, int S, int A, int causal,
               cudaStream_t stream) {
  constexpr size_t kBytes = QBlockSmem<T, HD, BLK, false>::kBytes;
  const cudaError_t err = set_smem(sparse_fwd_kernel<T, HD, BLK>, kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(S / BLK, H, B);
  sparse_fwd_kernel<T, HD, BLK><<<grid, threads<BLK>(), kBytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(cols), static_cast<const int*>(ncols), static_cast<T*>(out),
      static_cast<float*>(lse), H, Hkv, S, A, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// See sparse_attention.cuh for the layouts and the dtype codes.
extern "C" int ds_sparse_fwd(const void* q, const void* k, const void* v, const void* cols,
                             const void* ncols, void* out, void* lse, int B, int H, int Hkv,
                             int S, int hd, int block, int A, int causal, int dtype,
                             void* stream) {
  if (ds_sparse::bad_shape(B, H, Hkv, S, block, A)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DS_CALL(T, HD, BLK) \
  launch_fwd<T, HD, BLK>(q, k, v, cols, ncols, out, lse, B, H, Hkv, S, A, causal, s)
  DS_SPARSE_DISPATCH(DS_CALL);
#undef DS_CALL
}

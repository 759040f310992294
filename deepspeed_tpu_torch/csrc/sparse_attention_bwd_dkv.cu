// ds_sparse_bwd_dkv: dk and dv of tile-skipping block-sparse attention,
// written by hand for Hopper (sm_90a). Replaces _sparse_dkv_kernel of
// deepspeed_tpu/ops/pallas/sparse_attention.py. One thread block owns a key
// block and walks the transposed lists (its live query tiles), dealt to
// groups of warps whose sums are added in a fixed order, so its dk and dv
// are summed in one place, deterministically, without atomics; bound by
// bytes, design notes in sparse_attention.cuh.

#include "sparse_attention.cuh"

using namespace ds_flash;
using namespace ds_sparse;

namespace {

constexpr int kDkvThreads = 128;

// kGroups groups of kWarps warps: a group's warps own the block's keys, 16
// each; the groups share out the key block's list
template <int BLK>
struct DkvSplit {
  static constexpr int kWarps = BLK / 16;
  static constexpr int kGroups = kDkvThreads / (32 * kWarps);
};

template <typename T, int HD, int BLK, int BQ>
struct KBlockSmem {
  static constexpr int kGroups = DkvSplit<BLK>::kGroups;
  static constexpr int kLd = HD + kPad;   // rows of D
  static constexpr int kLdQ = BQ + kPad;  // rows of queries
  static constexpr int kK = 0;
  static constexpr int kV = kK + BLK * kLd;
  // per group: Q and dO tiles, then (fp32 only) P^T / dS^T on their way to
  // the next product
  static constexpr int kQ = kV + BLK * kLd;
  static constexpr int kDo = kQ + BQ * kLd;
  static constexpr int kP = kDo + BQ * kLd;
  static constexpr int kGroup = kP + (sizeof(T) == 4 ? BLK * kLdQ : 0) - kQ;
  static constexpr int kEnd = kQ + kGroups * kGroup;
  // fp32 after kEnd: per group lse and delta [BQ] each
  static constexpr size_t kLoopBytes = kEnd * sizeof(T) + 2 * BQ * kGroups * sizeof(float);
  // after the loop the same memory holds the partial dk (then dv) of groups
  // 1.. [kGroups - 1][BLK][HD] fp32
  static constexpr size_t kRedBytes = (kGroups - 1) * BLK * HD * sizeof(float);
  static constexpr size_t kBytes = kLoopBytes > kRedBytes ? kLoopBytes : kRedBytes;
};

// Group 0's sums plus those of groups 1.. (in group order) through `red`:
// every thread of the block calls it; a thread holds keys r0 and r0 + 8 of
// the block in the m16n8k16 C layout.
template <int kGroups, int BLK, int HD>
__device__ __forceinline__ void add_groups(float (&acc)[HD / 8][4], float* red, int group,
                                           int r0, int t) {
  __syncthreads();  // the loop's (or the previous call's) reads of `red` are done
  if (group > 0) {
    float* mine = red + (group - 1) * BLK * HD;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int nn = 0; nn < HD / 8; ++nn)
        store_pair(mine + (r0 + 8 * i) * HD + nn * 8 + 2 * t, acc[nn][2 * i], acc[nn][2 * i + 1]);
  }
  __syncthreads();
  if (group > 0) return;
  for (int s = 0; s < kGroups - 1; ++s)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int nn = 0; nn < HD / 8; ++nn)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          acc[nn][2 * i + e] += red[s * BLK * HD + (r0 + 8 * i) * HD + nn * 8 + 2 * t + e];
}

// barrier of one group's threads: its warp alone, or named barrier 1 + group
template <int kWarps>
__device__ __forceinline__ void group_sync(int group) {
  if (kWarps == 1)
    __syncwarp();
  else
    asm volatile("bar.sync %0, %1;\n" ::"r"(group + 1), "r"(kWarps * 32) : "memory");
}

// BQ: queries per step; a query tile of 64 rows at D 128 is taken in two
// halves, so that dk and dv (2 x 64 fp32 per thread) and the two score
// fragments stay within the register file. In bf16 at D 64 and block 16,
// four blocks share an SM (at most 128 registers a thread): 13-15 % faster
// than one at the BigBird training shape on an H100; other shapes spill with it.
template <typename T, int HD, int BLK, int BQ>
__global__ void __launch_bounds__(kDkvThreads, sizeof(T) == 2 && HD == 64 && BLK == 16 ? 4 : 1)
sparse_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                  const T* __restrict__ dout, const float* __restrict__ lse,
                  const float* __restrict__ delta, const int* __restrict__ rows,
                  const int* __restrict__ nrows, float* __restrict__ dk, float* __restrict__ dv,
                  int H, int Hkv, int S, int Ar, int causal) {
  using L = KBlockSmem<T, HD, BLK, BQ>;
  constexpr int kWarps = DkvSplit<BLK>::kWarps, kGroups = DkvSplit<BLK>::kGroups;
  constexpr int kGroupThreads = 32 * kWarps;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  T* k_s = sm + L::kK;
  T* v_s = sm + L::kV;

  // (batch, head) along x: the first wave holds key block 0 of every head,
  // so a long list (a global block) starts at once instead of last
  const int ki = blockIdx.y, h = blockIdx.x % H, b = blockIdx.x / H;
  const int n = S / BLK;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int group = warp / kWarps, wg = warp % kWarps;  // wg: the warp's 16 keys
  const int tid = threadIdx.x - group * kGroupThreads;   // within the group
  T* q_s = sm + L::kQ + group * L::kGroup;
  T* do_s = q_s + (L::kDo - L::kQ);
  T* p_s = q_s + (L::kP - L::kQ);
  float* lse_s = reinterpret_cast<float*>(sm + L::kEnd) + group * 2 * BQ;
  float* delta_s = lse_s + BQ;

  const int64_t bh = static_cast<int64_t>(b) * H + h;
  const int qstride = H * HD, kvstride = Hkv * HD;  // row strides
  const T* qb = head_rows<HD>(q, b, S, H, h);
  const T* dob = head_rows<HD>(dout, b, S, H, h);
  const float* lse_h = lse + bh * S;
  const float* delta_h = delta + bh * S;
  const int64_t list = static_cast<int64_t>(h) * n + ki;
  const int* rl = rows + list * Ar;
  const int nr = nrows[list];

  load_tile<T, BLK, HD, kDkvThreads>(k_s, L::kLd, head_rows<HD>(k, b, S, Hkv, h / (H / Hkv)),
                                     kvstride, ki * BLK);
  load_tile<T, BLK, HD, kDkvThreads>(v_s, L::kLd, head_rows<HD>(v, b, S, Hkv, h / (H / Hkv)),
                                     kvstride, ki * BLK);
  __syncthreads();
  const int key[2] = {ki * BLK + wg * 16 + g, ki * BLK + wg * 16 + g + 8};
  const T* kw = k_s + wg * 16 * L::kLd;
  const T* vw = v_s + wg * 16 * L::kLd;
  T* pw = p_s + wg * 16 * L::kLdQ;
  float dk_acc[HD / 8][4] = {}, dv_acc[HD / 8][4] = {};

  for (int j = group; j < nr; j += kGroups) {
    const int qt = rl[j];
    if (causal && qt < ki) continue;  // uniform over the group
    const bool diag = causal && qt == ki;
    for (int c0 = 0; c0 < BLK; c0 += BQ) {
      const int q0 = qt * BLK + c0;
      group_sync<kWarps>(group);  // the previous step's Q, dO, lse, delta reads are done
      load_tile<T, BQ, HD, kGroupThreads>(q_s, L::kLd, qb, qstride, q0, tid);
      load_tile<T, BQ, HD, kGroupThreads>(do_s, L::kLd, dob, qstride, q0, tid);
      for (int i = tid; i < BQ; i += kGroupThreads) {
        const float x = lse_h[q0 + i];
        lse_s[i] = x == kNegInf ? 0.f : x;
        delta_s[i] = delta_h[q0 + i];
      }
      group_sync<kWarps>(group);

      // P^T = exp(K Q^T - lse), one warp's 16 keys x BQ queries
      float p[BQ / 8][4] = {};
      warp_gemm<BQ, HD, false>(p, kw, L::kLd, q_s, L::kLd);
#pragma unroll
      for (int nn = 0; nn < BQ / 8; ++nn)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int col = nn * 8 + 2 * t + (c & 1);
          const bool ok = !diag || key[c >> 1] <= q0 + col;
          p[nn][c] = expf((ok ? p[nn][c] : kNegInf) - lse_s[col]);
        }
      // dP^T = V dO^T
      float ds[BQ / 8][4] = {};
      warp_gemm<BQ, HD, false>(ds, vw, L::kLd, do_s, L::kLd);
      warp_gemm_frag<HD, BQ>(dv_acc, p, pw, L::kLdQ, do_s, L::kLd);  // P^T in dO's dtype
#pragma unroll
      for (int nn = 0; nn < BQ / 8; ++nn)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int col = nn * 8 + 2 * t + (c & 1);
          ds[nn][c] = p[nn][c] * (ds[nn][c] - delta_s[col]);
        }
      warp_gemm_frag<HD, BQ>(dk_acc, ds, pw, L::kLdQ, q_s, L::kLd);  // dS^T in q's dtype
    }
  }

  // groups 1.. hand their sums to group 0, which adds them in group order,
  // through the shared memory the loop used
  if (kGroups > 1) {
    float* red = reinterpret_cast<float*>(smem_raw);
    const int r0 = wg * 16 + g;
    add_groups<kGroups, BLK, HD>(dk_acc, red, group, r0, t);
    add_groups<kGroups, BLK, HD>(dv_acc, red, group, r0, t);
    if (group > 0) return;
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int64_t off = (static_cast<int64_t>(b) * S + key[i]) * qstride + h * HD;
#pragma unroll
    for (int nn = 0; nn < HD / 8; ++nn) {
      store_pair(dk + off + nn * 8 + 2 * t, dk_acc[nn][2 * i], dk_acc[nn][2 * i + 1]);
      store_pair(dv + off + nn * 8 + 2 * t, dv_acc[nn][2 * i], dv_acc[nn][2 * i + 1]);
    }
  }
}

template <typename T, int HD, int BLK>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout, const void* lse,
               const void* delta, const void* rows, const void* nrows, void* dk, void* dv,
               int B, int H, int Hkv, int S, int Ar, int causal, cudaStream_t stream) {
  constexpr int BQ = (HD == 128 && BLK == 64) ? 32 : BLK;
  constexpr size_t kBytes = KBlockSmem<T, HD, BLK, BQ>::kBytes;
  const cudaError_t err = set_smem(sparse_dkv_kernel<T, HD, BLK, BQ>, kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B * H, S / BLK);
  sparse_dkv_kernel<T, HD, BLK, BQ><<<grid, kDkvThreads, kBytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<const int*>(rows),
      static_cast<const int*>(nrows), static_cast<float*>(dk), static_cast<float*>(dv), H, Hkv,
      S, Ar, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// See sparse_attention.cuh for the layouts and the dtype codes.
extern "C" int ds_sparse_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                                 const void* lse, const void* delta, const void* rows,
                                 const void* nrows, void* dk, void* dv, int B, int H, int Hkv,
                                 int S, int hd, int block, int Ar, int causal, int dtype,
                                 void* stream) {
  if (ds_sparse::bad_shape(B, H, Hkv, S, block, Ar)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DS_CALL(T, HD, BLK) \
  launch_dkv<T, HD, BLK>(q, k, v, dout, lse, delta, rows, nrows, dk, dv, B, H, Hkv, S, Ar, \
                         causal, s)
  DS_SPARSE_DISPATCH(DS_CALL);
#undef DS_CALL
}

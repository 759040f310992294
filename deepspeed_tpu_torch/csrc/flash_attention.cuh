// Causal GQA flash attention for Hopper (sm_90a), written by hand: what the
// kernels share. Each has its own source, so that the nvcc builds run in
// parallel:
//   flash_attention_fwd.cu, flash_attention_bwd.cu (form W of the backward),
//   flash_attention_bwd_dq.cu, flash_attention_bwd_dkv.cu
//
// Replaces: deepspeed_tpu/ops/pallas/flash_attention.py
//   ds_flash_fwd     <- _fwd_kernel     (pallas_call in _flash_fwd)
//   ds_flash_bwd_dq  <- _bwd_dq_kernel  (first pallas_call in _flash_bwd)
//   ds_flash_bwd_dkv <- _bwd_dkv_kernel (second pallas_call in _flash_bwd)
//   ds_flash_bwd     <- both backward kernels, in one kernel (form W)
// each with and without ALiBi (_alibi_add, called from _sub_score, which the
// three Pallas kernels share). Same math: q arrives pre-scaled by
// hd^-0.5 * log2(e) (in q's dtype, by the caller), the softmax runs in base
// 2, the running max m, sum l
// and accumulators are fp32; masked scores are finfo(float32).min; a row with
// no visible key gets output 0 and lse = finfo(float32).min; kv head = h / G;
// key j is visible to query i iff j <= i and keep[j] != 0 (keep is optional);
// dS is cast to the operand dtype before its products, as P is; the dq sum is
// multiplied by `scale` (hd^-0.5) and dk by `dk_scale` (ln 2) in fp32 before
// the one cast to the output dtype.
//
// ALiBi (Bloom): with a non-null `slopes` (fp32 [H], already times log2(e),
// as the JAX wrapper folds it) query head h's score of key j for query i
// gets slope[h] * (j - i), on every tile and before the mask, so a masked
// score is still exactly finfo(float32).min. JAX adds slope[h] * j: the same
// softmax (slope[h] * i is one constant per query row), but at S 2048 the
// absolute form reaches ~2,000, where an fp32 ulp (2.4e-4) is larger than
// the check's tolerance, while j - i is 0 on the diagonal and small where
// the weight is. The product and the sum are rounded separately (__fmul_rn,
// __fadd_rn), as the plain version's two tensor ops round them. lse is then
// the JAX kernel's less slope[h] * i; the backward kernels take that lse and
// add the same bias, so the gradients are JAX's. The form is a template flag
// (kAlibi), so the kernels without ALiBi carry no slope register or branch.
//
// What bounds it on an H100: operations. At the Llama-3.2-1B training shape
// (B 4, S 2048, H 32, kvH 8, hd 64) the forward does 4*B*H*S^2*hd/2 = 68.7
// GFLOP on 50 MB of inputs and outputs, ~1400 flops per byte, far above the
// card's ~295 flops/byte ridge; dq does 3 such products and dkv 4. So the
// products run on the tensor cores from the start: mma.sync.m16n8k16 with
// bf16 operands and fp32 accumulation (FlashAttention-2 shape).
//
// Design. The TPU kernels walk key blocks along a sequential grid axis and
// carry (m, l, acc) in VMEM scratch; blocks here run in no order, so that axis
// is a loop inside each block:
//   fwd, dq: grid (64-row query tile, query head, batch), 4 warps, a warp owns
//            16 query rows; the block loops over 64-key tiles up to the one
//            that crosses its diagonal (nothing above it is loaded).
//   dkv:     grid (64-key tile, kv head, batch); a warp owns 16 keys; the
//            block loops over the G query heads of its kv head and over the
//            query tiles from its diagonal down, and writes dk/dv summed over
//            the group (no atomics, no per-query-head fp32 buffers; JAX writes
//            fp32 dk/dv per query head and sums over G afterwards: the same
//            sum in another order).
// Tiles are staged once in shared memory (16-byte loads, rows padded by 8
// elements so the 8 rows an ldmatrix reads fall in distinct banks) and read
// with ldmatrix; an operand a product needs with the other index contiguous
// (V for P.V, K for dS.K, Q and dO for the dkv products) is read transposed
// by ldmatrix.trans from the same tile. In fwd and dq, P and dS stay in
// registers: the C fragment of one product, rounded to bf16, is the A
// fragment of the next; dkv passes them through shared memory, which
// measured faster there. Only a tile that crosses the diagonal, holds the
// ragged tail of S, or meets a keep-mask pays for masking. S is any length:
// rows and keys past S are loaded as zeros and masked, nothing is padded in
// device memory. fp32 inputs take the same code with the products done by
// FMAs in the same fragment layout, P and dS passing through shared memory
// (a check path, not a fast one). bf16 inputs take form W of each direction
// (wgmma fed by TMA, warp-specialised): flash_attention_fwd.cu for the
// forward, flash_attention_bwd.cu for dq, dk and dv in one kernel. The
// kernels described here stay as the "mma" forms, timed beside them.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace ds_flash {

constexpr int kThreads = 128;  // 4 warps x 16 rows
constexpr int kRows = 64;      // a block's own rows: queries (fwd, dq) or keys (dkv)
constexpr int kKeys = 64;      // keys per step of the fwd / dq loop
constexpr int kPad = 8;        // shared-memory row padding, elements
constexpr float kNegInf = -FLT_MAX;  // finfo(float32).min, the JAX kernels' mask value

// two adjacent outputs (8-byte / 4-byte aligned) rounded to T
__device__ __forceinline__ void store_pair(float* dst, float a, float b) {
  *reinterpret_cast<float2*>(dst) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* dst, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8x8 bf16 matrices from shared memory into the registers of a warp:
// lane l names row l % 8 of matrix l / 8; lane 4 g + t receives row g,
// columns 2t and 2t+1 of each matrix (with kTrans: of each matrix transposed).
template <bool kTrans>
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const __nv_bfloat16* p) {
  if (kTrans)
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_addr(p)));
  else
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_addr(p)));
}

// acc[0..3] += A (16x16) * B (16x8) in the m16n8k16 fragment layout: lane
// 4 g + t holds C rows g (acc[0], acc[1]) and g + 8 (acc[2], acc[3]), columns
// 2t and 2t+1.
__device__ __forceinline__ void mma16816(float* acc, const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(acc[0]), "+f"(acc[1]), "+f"(acc[2]), "+f"(acc[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc (16 x N) += A (16 x K) * B (K x N) for one warp, A[r][k] = a[r * lda + k].
// B is a tile of shared memory read in place: B[k][n] = b[n * ldb + k] when its
// columns are the tile's rows (K in Q.K^T), b[k * ldb + n] with kRowB when its
// rows are (V in P.V). bf16: ldmatrix loads each 16-deep slice of A once and
// B two 8-column tiles at a time, transposed by the hardware for kRowB.
template <int N, int K, bool kRowB>
__device__ __forceinline__ void warp_gemm(float (&acc)[N / 8][4], const __nv_bfloat16* a,
                                          int lda, const __nv_bfloat16* b, int ldb) {
  static_assert(N % 16 == 0 && K % 16 == 0, "warp_gemm: tiles of 16");
  const int lane = threadIdx.x & 31, m = lane >> 3, r = lane & 7;
#pragma unroll
  for (int kk = 0; kk < K; kk += 16) {
    uint32_t af[4];  // matrices: rows 0-7 / 8-15 x k 0-7, then x k 8-15
    ldsm_x4<false>(af, a + (r + 8 * (m & 1)) * lda + kk + 8 * (m >> 1));
#pragma unroll
    for (int n = 0; n < N / 8; n += 2) {
      uint32_t bf[4];  // matrices: n-tile n x k 0-7 / 8-15, then n-tile n + 1
      if (kRowB)
        ldsm_x4<true>(bf, b + (kk + r + 8 * (m & 1)) * ldb + n * 8 + 8 * (m >> 1));
      else
        ldsm_x4<false>(bf, b + (n * 8 + r + 8 * (m >> 1)) * ldb + kk + 8 * (m & 1));
      mma16816(acc[n], af, bf[0], bf[1]);
      mma16816(acc[n + 1], af, bf[2], bf[3]);
    }
  }
}

// fp32: the same product by FMAs in the same C layout, each output summed in
// order of k (a check path, not a fast one).
template <int N, int K, bool kRowB>
__device__ __forceinline__ void warp_gemm(float (&acc)[N / 8][4], const float* a, int lda,
                                          const float* b, int ldb) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll 4
  for (int kk = 0; kk < K; ++kk) {
    const float x0 = a[g * lda + kk], x1 = a[(g + 8) * lda + kk];
#pragma unroll
    for (int n = 0; n < N / 8; ++n) {
      const int c = n * 8 + 2 * t;
      const float y0 = kRowB ? b[kk * ldb + c] : b[c * ldb + kk];
      const float y1 = kRowB ? b[kk * ldb + c + 1] : b[(c + 1) * ldb + kk];
      acc[n][0] = fmaf(x0, y0, acc[n][0]);
      acc[n][1] = fmaf(x0, y1, acc[n][1]);
      acc[n][2] = fmaf(x1, y0, acc[n][2]);
      acc[n][3] = fmaf(x1, y1, acc[n][3]);
    }
  }
}

// s += slope * d, the relative ALiBi bias of this warp's C-fragment tile: for
// entry (n, c), d = base[c >> 1] + kSign * (n * 8 + (c & 1)) is the key's
// position less the query's (base holds the caller's offsets of the lane's two
// rows; kSign is +1 where columns are keys, -1 where they are queries). d is
// formed in fp32 from two converted bases and compile-time constants, exact
// for |d| < 2^24, so the loop has no int-to-float conversion (a quarter-rate
// instruction on Hopper). Both roundings of slope * d + s are explicit, so
// nvcc cannot contract them into an FMA.
template <int N, int kSign>
__device__ __forceinline__ void add_alibi(float (&s)[N / 8][4], float slope,
                                          const int (&base)[2]) {
  const float fb[2] = {static_cast<float>(base[0]), static_cast<float>(base[1])};
#pragma unroll
  for (int n = 0; n < N / 8; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float d = __fadd_rn(fb[c >> 1], static_cast<float>(kSign * (n * 8 + (c & 1))));
      s[n][c] = __fadd_rn(s[n][c], __fmul_rn(slope, d));
    }
}

// 2^x by the SFU's approximation, results below 2^-126 flushed to 0 (a
// softmax weight that small moves no output; exp2f's handling of them costs
// several instructions a score, and at hd 64 the softmax's instructions are
// as scarce as the tensor cores' time). Form W's forward and backward.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// A wgmma accumulator (64 x N, this thread's C-fragment entries) rounded to
// bf16 as the A operand of a product from registers: columns [16 j, 16 j +
// 16), packed in pairs, are the A fragment of k-step j (P, dS in form W).
template <int N>
__device__ __forceinline__ void pack_frag(uint32_t (&p)[N / 16][4], const float (&sc)[N / 8][4]) {
#pragma unroll
  for (int j = 0; j < N / 16; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 v2 = __floats2bfloat162_rn(sc[2 * j + (i >> 1)][2 * (i & 1)],
                                                      sc[2 * j + (i >> 1)][2 * (i & 1) + 1]);
      p[j][i] = *reinterpret_cast<const uint32_t*>(&v2);
    }
}

// Rows [r0, r0 + R) of a strided [S, HD] source into dst[R][ld]; rows past S
// are zeros.
template <typename T, int R, int HD>
__device__ __forceinline__ void load_rows(T* dst, int ld, const T* src, int64_t stride, int r0,
                                          int S) {
  constexpr int kVec = 16 / sizeof(T), kPerRow = HD / kVec;
  for (int i = threadIdx.x; i < R * kPerRow; i += kThreads) {
    const int r = i / kPerRow, c = (i % kPerRow) * kVec;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < S) val = *reinterpret_cast<const uint4*>(src + (r0 + r) * stride + c);
    *reinterpret_cast<uint4*>(dst + r * ld + c) = val;
  }
}

// keep_s[j] = 1 iff key c0 + j exists (< S) and its keep-mask entry is set
__device__ __forceinline__ void load_keep(int* keep_s, int n, const int* keep_b, int c0, int S) {
  for (int j = threadIdx.x; j < n; j += kThreads) {
    const int c = c0 + j;
    keep_s[j] = c < S && (keep_b == nullptr || keep_b[c] != 0);
  }
}

// C, this warp's C-fragment tile, rounded to T into its 16 rows of
// `scratch` (ld lds) to become the A operand of a product.
template <int K, typename T>
__device__ __forceinline__ void stage_frag(T* scratch, int lds, const float (&c)[K / 8][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int n = 0; n < K / 8; ++n) {
    store_pair(scratch + g * lds + n * 8 + 2 * t, c[n][0], c[n][1]);
    store_pair(scratch + (g + 8) * lds + n * 8 + 2 * t, c[n][2], c[n][3]);
  }
  __syncwarp();
}

// acc (16 x N) += C (16 x K) * B (K x N), B[k][n] = b[k * ldb + n], where C is
// this warp's C-fragment tile of an earlier product (P or dS), rounded to T
// first as the JAX kernels round it. bf16: the C fragments of n-tiles 2j and
// 2j + 1 are, packed in pairs, the A fragment of the 16-deep step j, so C
// never leaves the registers; with kStage it goes through `scratch` instead.
template <int N, int K, bool kStage = false>
__device__ __forceinline__ void warp_gemm_frag(float (&acc)[N / 8][4],
                                               const float (&c)[K / 8][4], __nv_bfloat16* scratch,
                                               int lds, const __nv_bfloat16* b, int ldb) {
  static_assert(N % 16 == 0 && K % 16 == 0, "warp_gemm_frag: tiles of 16");
  if (kStage) {
    stage_frag<K>(scratch, lds, c);
    warp_gemm<N, K, true>(acc, scratch, lds, b, ldb);
    __syncwarp();
    return;
  }
  const int lane = threadIdx.x & 31, m = lane >> 3, r = lane & 7;
#pragma unroll
  for (int kk = 0; kk < K; kk += 16) {
    const int j = kk / 8;
    uint32_t af[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 v = __floats2bfloat162_rn(c[j + (i >> 1)][2 * (i & 1)],
                                                     c[j + (i >> 1)][2 * (i & 1) + 1]);
      af[i] = *reinterpret_cast<const uint32_t*>(&v);
    }
#pragma unroll
    for (int n = 0; n < N / 8; n += 2) {
      uint32_t bf[4];
      ldsm_x4<true>(bf, b + (kk + r + 8 * (m & 1)) * ldb + n * 8 + 8 * (m >> 1));
      mma16816(acc[n], af, bf[0], bf[1]);
      mma16816(acc[n + 1], af, bf[2], bf[3]);
    }
  }
}

// fp32: C always goes through `scratch`.
template <int N, int K, bool kStage = false>
__device__ __forceinline__ void warp_gemm_frag(float (&acc)[N / 8][4],
                                               const float (&c)[K / 8][4], float* scratch, int lds,
                                               const float* b, int ldb) {
  stage_frag<K>(scratch, lds, c);
  warp_gemm<N, K, true>(acc, scratch, lds, b, ldb);
  __syncwarp();
}

template <typename T, int HD, bool kBwd>
struct QTileSmem {  // fwd and dq: shared-memory layout, in elements of T
  static constexpr int kLd = HD + kPad;      // rows of hd
  static constexpr int kLdK = kKeys + kPad;  // rows of keys
  static constexpr int kQ = 0;
  static constexpr int kDo = kQ + kRows * kLd;                   // dq only
  static constexpr int kK = kDo + (kBwd ? kRows * kLd : 0);
  static constexpr int kV = kK + kKeys * kLd;
  // P (fwd) or dS (dq) on their way to the next product, fp32 only: [kRows][kLdK]
  static constexpr int kP = kV + kKeys * kLd;
  static constexpr int kEnd = kP + (sizeof(T) == 4 ? kRows * kLdK : 0);
  static constexpr size_t kBytes = kEnd * sizeof(T) + kKeys * sizeof(int);
};

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

inline bool bad_shape(int B, int S, int H, int kvH) {
  return B <= 0 || S <= 0 || kvH <= 0 || H % kvH != 0 || B > 65535 || H > 65535 ||
         kvH > 65535;
}

}  // namespace ds_flash

// dtype codes: 0 = fp32, 1 = bf16; hd must be 64 or 128; keep is an int32
// [B, S] key keep-mask or NULL; slopes is fp32 [H] (ALiBi slopes times
// log2(e)) or NULL; q/k/v/dout [B, S, heads, hd] contiguous;
// lse/delta fp32 [B, H, S]. Each returns cudaGetLastError() after its launch.
#define DS_FLASH_DISPATCH(CALL)                                  \
  do {                                                           \
    if (dtype == 1 && hd == 64) return CALL(__nv_bfloat16, 64);  \
    if (dtype == 1 && hd == 128) return CALL(__nv_bfloat16, 128); \
    if (dtype == 0 && hd == 64) return CALL(float, 64);          \
    if (dtype == 0 && hd == 128) return CALL(float, 128);        \
    return cudaErrorInvalidValue;                                \
  } while (0)

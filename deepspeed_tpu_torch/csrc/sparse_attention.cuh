// Tile-skipping block-sparse attention for Hopper (sm_90a), written by hand:
// what the three kernels share. Each kernel has its own source, so that the
// three nvcc builds run in parallel:
//   sparse_attention_fwd.cu, sparse_attention_bwd_dq.cu, sparse_attention_bwd_dkv.cu
//
// Replaces: deepspeed_tpu/ops/pallas/sparse_attention.py
//   ds_sparse_fwd     <- _sparse_fwd_kernel (pallas_call in _sparse_fwd)
//   ds_sparse_bwd_dq  <- _sparse_dq_kernel  (first pallas_call in _sparse_bwd)
//   ds_sparse_bwd_dkv <- _sparse_dkv_kernel (second pallas_call in _sparse_bwd)
// Same math, read in the model's layout: q, dout and out are [B, S, H, D], k
// and v [B, S, Hkv, D] (S a multiple of the block; query head h reads kv head
// h / (H / Hkv), so GQA needs no copy of k and v), lse and delta [B, H, S]
// fp32; q pre-scaled by D^-0.5 in q's dtype by the caller; scores, the running max m
// and sum l, lse and the accumulators are fp32 and base e; masked scores are
// finfo(float32).min; a row with no live tile gets output 0 and lse =
// finfo(float32).min, and its p is 0 in the backward. P (in V's / dO's dtype)
// and dS (in K's / Q's dtype) are rounded before their products as the TPU
// kernels round them. dq, dk, dv are written in fp32 [B, S, H, D] (dq
// without the D^-0.5 of the pre-scaled q; the caller applies it). dk and dv
// are per query head: the caller sums each group of H / Hkv heads. A thread
// block per kv head would own a global key block's list for all its query
// heads (4 x 256 entries for Llama-3.2-1B at S 4096), 4x the longest thread
// block of the grid, which already sets dkv's time.
//
// The layout arrives as lists: cols [H, n, A] / ncols [H, n] (per query
// block, its live key blocks; fwd and dq) and rows [H, n, Ar] / nrows [H, n]
// (per key block, its live query blocks; dkv). Entry j of a list is live iff
// j < ncols and, with causal, the key block is not after the query block; the
// elementwise col <= row mask applies on the diagonal tile only. Entries past
// ncols (padding) are never read.
//
// What bounds it on an H100: bytes. At the Llama-3.2-1B BigBird training
// shape (B 2, S 4096, 32 heads, D 64, block 16: ~5 live 16x16 tiles per block
// row) the forward does 4 * 16 * 16 * 64 flops per live tile, ~5 GFLOP in
// all, on 134 MB of q, k, v and out: ~36 flops per byte, far below the card's
// ~295 flops/byte ridge. So the design keeps the TPU kernels' one-pass shape
// (each q, dO block read once per thread block, each live K/V tile once per
// visit) and the products stay on the tensor cores only because they are
// there: mma.sync.m16n8k16 bf16 with fp32 accumulation, the warp-level
// helpers of flash_attention.cuh (ldmatrix from padded shared-memory tiles,
// P and dS kept in registers as the next product's A fragment).
//
// Design. The TPU grids walk the list axis sequentially with (m, l, acc) in
// VMEM scratch; blocks here run in no order, so that axis is a loop inside
// each thread block:
//   fwd, dq: grid (query block, head, batch); block/16 warps, a warp owns 16
//            query rows; the loop visits the block row's live key tiles.
//   dkv:     grid (batch x head, key block), 4 warps; the key block's live
//            query tiles (the transposed lists) are dealt round-robin to
//            64/block groups of block/16 warps (a warp owns 16 keys), and the
//            groups' fp32 sums are added in group order in shared memory at
//            the end: each key block's dk and dv are summed by one thread
//            block, deterministically, without atomics. The split matters for
//            global blocks: BigBird's key block 0 is live for every query
//            block (256 at S 4096, block 16), all others for about 5.
// fp32 inputs take the same code with the products done by FMAs (a check
// path, not a fast one). No wgmma/TMA, no cp.async pipelining yet.

#pragma once

#include "flash_attention.cuh"

namespace ds_sparse {

// threads of a block of `block` rows: one warp per 16 rows
template <int BLK>
__host__ __device__ constexpr int threads() {
  return 2 * BLK;
}

// fwd and dq in bf16 at D 64 and block 16 (the training path's shape): 24
// resident thread blocks per SM, i.e. at most 85 registers a thread. Measured
// on an H100 at the BigBird training shape: 4-7 % faster than no bound, 17-30 %
// faster than 32 blocks (at most 64 registers). At other shapes the bound
// spilled registers, so there is none.
template <typename T, int HD, int BLK>
__host__ __device__ constexpr int min_blocks() {
  return sizeof(T) == 2 && HD == 64 && BLK == 16 ? 24 : 1;
}

// Rows [r0, r0 + R) of an [S, HD] matrix whose rows lie `stride` elements
// apart (one head of [B, S, heads, HD]) into dst[R][ld], by NT threads (this
// one is number `tid` of them), 16 bytes a load.
template <typename T, int R, int HD, int NT>
__device__ __forceinline__ void load_tile(T* dst, int ld, const T* src, int stride, int r0,
                                          int tid = threadIdx.x) {
  constexpr int kVec = 16 / sizeof(T), kPerRow = HD / kVec;
  for (int i = tid; i < R * kPerRow; i += NT) {
    const int r = i / kPerRow, c = (i % kPerRow) * kVec;
    *reinterpret_cast<uint4*>(dst + r * ld + c) =
        *reinterpret_cast<const uint4*>(src + static_cast<int64_t>(r0 + r) * stride + c);
  }
}

// (batch b, head h) of a [B, S, heads, HD] tensor: its row 0, rows `heads *
// HD` apart
template <int HD, typename T>
__device__ __forceinline__ T* head_rows(T* base, int b, int S, int heads, int h) {
  return base + (static_cast<int64_t>(b) * S * heads + h) * HD;
}

// fwd and dq: shared-memory layout, in elements of T
template <typename T, int HD, int BLK, bool kBwd>
struct QBlockSmem {
  static constexpr int kLd = HD + ds_flash::kPad;    // rows of D
  static constexpr int kLdP = BLK + ds_flash::kPad;  // rows of keys
  static constexpr int kQ = 0;
  static constexpr int kDo = kQ + BLK * kLd;  // dq only
  static constexpr int kK = kDo + (kBwd ? BLK * kLd : 0);
  static constexpr int kV = kK + BLK * kLd;
  // P (fwd) or dS (dq) on their way to the next product, fp32 only
  static constexpr int kP = kV + BLK * kLd;
  static constexpr int kEnd = kP + (sizeof(T) == 4 ? BLK * kLdP : 0);
  static constexpr size_t kBytes = kEnd * sizeof(T);
};

inline bool bad_shape(int B, int H, int Hkv, int S, int block, int A) {
  return B <= 0 || H <= 0 || Hkv <= 0 || H % Hkv != 0 || S <= 0 || A <= 0 || block <= 0 ||
         S % block != 0 || B > 65535 || H > 65535 || S / block > 65535;
}

}  // namespace ds_sparse

// dtype codes: 0 = fp32, 1 = bf16; hd 64 or 128; block 16, 32 or 64. Each
// entry returns cudaGetLastError() after its launch, or cudaErrorInvalidValue
// for a shape it does not take.
#define DS_SPARSE_DISPATCH_TYPES(CALL, BLK)                    \
  do {                                                         \
    if (dtype == 1 && hd == 64) return CALL(__nv_bfloat16, 64, BLK); \
    if (dtype == 1 && hd == 128) return CALL(__nv_bfloat16, 128, BLK); \
    if (dtype == 0 && hd == 64) return CALL(float, 64, BLK);   \
    if (dtype == 0 && hd == 128) return CALL(float, 128, BLK); \
  } while (0)

#define DS_SPARSE_DISPATCH(CALL)                              \
  do {                                                        \
    if (block == 16) DS_SPARSE_DISPATCH_TYPES(CALL, 16);      \
    if (block == 32) DS_SPARSE_DISPATCH_TYPES(CALL, 32);      \
    if (block == 64) DS_SPARSE_DISPATCH_TYPES(CALL, 64);      \
    return cudaErrorInvalidValue;                             \
  } while (0)

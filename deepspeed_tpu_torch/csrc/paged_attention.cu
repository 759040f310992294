// Paged GQA attention over a block-table KV pool, written by hand for Hopper
// (sm_90a).
//
// Replaces: deepspeed_tpu/ops/pallas/paged_attention.py:_decode_kernel
// (pallas_call in flash_decode_paged), in each of its forms: the bf16/fp32
// pool (ds_paged_attention), the quantised int8/e4m3 pool with one fp32 scale
// per (slot, kv head) (ds_paged_attention_quant, the kernel's quantized=True
// form), and either of them with ALiBi (alibi=True, a non-null slopes
// pointer). It computes what that kernel computes: the new
// queries q [N, C, H, hd] of each row attend to the row's pages of one
// layer's pool [S_flat, kvH, hd] through block_tables [N, P]; query head h
// reads kv head h / G; key j is visible to a query at position p iff j <= p;
// q is pre-scaled by hd^-0.5 in q's dtype; the online softmax (m, l, acc) is
// kept in fp32 and the output is acc / l, with l == 0 giving 0. A quantised
// pool is dequantised right after each page is loaded: float(code) * its
// slot's scale, rounded to q's dtype (JAX's .astype(q_ref.dtype)), so the
// full-precision pool never exists anywhere. A block reads the pages of its
// row up to the largest position among its query rows, and never past the
// row's live length ceil((max_pos + 1) / bs), max_pos the position at
// new_lens - 1: block-table entries past that are never read. Every output
// row is computed, the rows at c >= new_lens[n] included (from their
// positions, as the JAX kernel does).
//
// ALiBi (Bloom): query head h's scores get slope[h] times the key's
// position, added before the causal mask and the running max (which must
// see it: at position 1000 head 0's slope 2^-0.25 moves a score by ~840).
// The kernel adds slope[h] * (j - p), p the query's position: the same
// softmax as the JAX kernel's slope[h] * j, since slope[h] * p is one
// constant per query row, but exact where the weight is. slope * j reaches
// 1,720 at position 2047, where one fp32 ulp is 1.2e-4, six times the fp32
// check's tolerance on an output element; slope * (j - p) is small for the
// keys near the query that carry the softmax's weight. The product and the sum
// are rounded separately (__fmul_rn, __fadd_rn), as the plain version's two
// tensor ops round them. A template flag keeps the forms without ALiBi free
// of it (a run-time branch on slopes == nullptr made the quantised decode
// form spill and run ~27 % slower on an H100 80GB HBM3 at 700 W; PERF.md).
//
// The TPU kernel walks page chunks along a sequential grid axis ("arbitrary")
// and carries (m, l, acc) in VMEM from one step to the next. Blocks on this
// card run in parallel and in no order, so three forms take that axis apart
// in their own ways. The wrapper (ops/paged_attention.py paged_form) picks
// one from shapes alone, never from a device tensor:
//
// - Form "split" (decode: C == 1; every
//   dtype and pool, ALiBi or not, any bs). What bounds it: bytes. At Llama
//   decode every live page is read once (hd * 2 values * itemsize per token
//   and kv head) for 4 * G * hd flops, ~8 flops a byte in bf16, and the
//   whole call moves ~13 MB (~4 us at 3.35 TB/s); the cost is latency: the
//   grid (row tile, kv head, row) of form S gives 64 blocks on 132 SMs and
//   the 1000-token row walks its 63 pages one 64-key step at a time. So it
//   is flash-decoding:
//   * Grid (split, kv head x row group, row). The page range [0, P) is cut
//     into fixed spans of `span` pages, from shapes alone (split_plan: about
//     2 blocks an SM and spans of at most 16 pages on the tensor-core path
//     below, 4 and 8 on the FMA path, so that a long row spreads over
//     several blocks whatever the pairs). A block reads its rows'
//     positions, the row's new_lens, its
//     span's block-table entries (into shared memory: no chunk's copies wait
//     on a lookup) and its q rows in one round trip; splits past the row's
//     last live span then leave at once, without a partial or a ticket, and
//     a row with one live span (a short row) writes its output directly. A
//     row group is up to kRows (1, 4 or 16) (c, g) query rows of one kv head:
//     all of them at decode, so every warp works on every live row (at G = 1
//     the one row: no warp idles in P V).
//   * Inside a block no barrier a step: each of 4 warps owns the 8-token
//     chunks w, w + 4, ... of the span with its own (m, l, acc), and keeps 3
//     chunks in flight in its own cp.async ring (token rows gathered through
//     the block table, zero-filled past the span's live end; a quantised
//     pool's codes and scales travel raw, a half or a quarter of the bytes,
//     and are dequantised in registers). A bf16 pool with at most 4 rows
//     (bf16 decode up to G = 4) multiplies on the tensor cores: mma.sync
//     m16n8k16 for S = Q K^T (the rows padded to 16, Q's fragments held in
//     registers, K's rows the B operand by ldmatrix) and m16n8k8 for O += P
//     V (P's fragment the scores' own, rounded to bf16; V by ldmatrix.trans);
//     the softmax reduces over a quad. Other pools and more rows take FMAs:
//     lane (key j, part h) takes a quarter of hd and two shuffles add the
//     parts; the softmax reduces over the chunk's 8 lanes; P goes through a
//     per-warp scratch row and P V gives each lane hd / 32 columns of every
//     row. The warps merge in shared memory (in warp order) at the end. A
//     warp's chunk is a chain of dependent shared-memory loads, shuffles and
//     products, so the chunk is small enough for 3-4 blocks (12-16 warps) an
//     SM to hide each other's waits.
//   * Across blocks, one launch in a fixed order: each live split writes its
//     fp32 partial (m, l, acc) to a workspace; after a __threadfence one
//     thread takes a ticket (atomicAdd on an int32 counter of the (row, kv
//     head, row group)); the block that draws the last ticket merges the
//     partials in split order 0, 1, 2, ... and resets the counter to 0 for
//     the next launch. The output is bit-equal from run to run, and no
//     combine kernel and no memset run (the wrapper zeroes the counters
//     once, per device and stream). With one split the block writes the
//     output directly.
// - Form W ("wgmma", prefill: bf16 q at C > 1, hd 64 or 128,
//   bs % 8 == 0 and bs <= 128; every pool, ALiBi or not). What bounds it:
//   operations at a long prefill (the [5, 512, 32, 128] chunk is 5.1 GFLOP
//   of products on 15 MB of live pages). Built from form W of the flash
//   forward (flash_attention_fwd.cu):
//   * A producer warp reads the tile's page ids from the block table and
//     issues one TMA load a page (a 3-D map over the layer's pool (hd, kvH,
//     S_flat), box {64, 1, bs}, 128-byte swizzle: two boxes a page at hd
//     128) into a ring of 128-key K/V tiles; pages past the tile's largest
//     position are never requested (their box is asked at row S_flat, past
//     the pool, which TMA fills with zeros without reading).
//   * Two consumer warpgroups of 64 (c, g) rows (the GQA group packed) run
//     S = Q K^T and O += P V with wgmma, the next tile's Q K^T issued with
//     this tile's P V. Q is read as whole 16-byte chunks of rows, scaled and
//     rounded in bf16, into the (still free) output staging boxes and taken
//     from there as the A fragments by ldmatrix. The causal mask is applied
//     per element from each row's own position (positions need not lie on a
//     diagonal); a tile that every row of the thread sees whole skips it.
//     ALiBi is added to the S fragments.
//   * A quantised pool: TMA brings the codes (a box of bs x hd bytes) into a
//     ring of their own; three more producer warps read the scales, write
//     bf16(code * scale) into the swizzled tile wgmma reads, and order it
//     for the async proxy (fence.proxy.async) before they mark it full:
//     wgmma cannot multiply bf16 Q by int8 or e4m3 codes.
//   * The pool maps are cached by (pointer, shape, dtype, bs): the engine
//     calls the kernel with one pool slice a layer. Grid (row tile, kv head
//     x split, row); where the tiles give fewer blocks than SMs the keys are
//     split as in form "split", with the same workspace, tickets and merge.
// - Form S ("simt", the first form: fp32 q at C > 1, a bs that
//   TMA cannot take, and by name): below.
//
// Form S. Grid (query tile, kv head, row n); 256 threads per block.
//   tile  = up to TQ (c, g) query rows of the row's GQA group, TQ = 64, or
//           16 where C * G <= 16.
//   64 keys at a time (four 16-token pages) are loaded with 16-byte vector
//   loads (8 bf16, 4 fp32 or 16 one-byte codes each; a quantised pool's
//   scales with them), one step ahead into registers, and stored to shared
//   memory as fp32 at the top of the step (dequantised first), then
//     scores  S = Q K^T  (each thread: one key, TQ / 4 query rows),
//     softmax one warp per query row (shuffle max/sum), probabilities back
//             into shared memory, per-row rescale factors alpha,
//     output  acc = alpha * acc + P V (each thread: 4 head dims x TQ / 8
//             rows, kept in registers across the whole key loop).
//   Shared memory at hd 128, TQ 64: Q 32 KB, K 33 KB (rows padded by 4
//   floats so the per-key float4 reads are free of bank conflicts), V 32 KB,
//   S 16 KB, set through cudaFuncAttributeMaxDynamicSharedMemorySize.
//   Plain FMA loops, no tensor cores.

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <mutex>
#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTileK = 64;   // keys per inner step
// (c, g) query rows per block: 64 for prefill chunks, 16 when a row has at
// most 16 (decode), so a decode block does not issue 64 rows' worth of
// predicated-off work
constexpr int kTileQLarge = 64;
constexpr int kTileQSmall = 16;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_float(int8_t v) { return static_cast<float>(v); }
__device__ __forceinline__ float to_float(__nv_fp8_e4m3 v) { return static_cast<float>(v); }
template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}
// round an fp32 value to T and back (the JAX kernel scales q in q's dtype)
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_float(from_float<T>(v));
}

// 16 bytes (kVec elements of T) into kVec floats.
template <typename T>
__device__ __forceinline__ void unpack(const uint4& raw, float* dst) {
  constexpr int kVec = 16 / sizeof(T);
  const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int e = 0; e < kVec; ++e) dst[e] = to_float(v[e]);
}

// 16 bytes of pool values (KV) into floats: a bf16/fp32 pool as stored
// (KV == T); a quantised pool's codes times their slot's scale, rounded to
// the compute dtype T.
template <typename T, typename KV>
__device__ __forceinline__ void unpack_kv(const uint4& raw, float scale, float* dst) {
  constexpr int kVec = 16 / sizeof(KV);
  unpack<KV>(raw, dst);
  if constexpr (!std::is_same<KV, T>::value) {
#pragma unroll
    for (int e = 0; e < kVec; ++e) dst[e] = round_to<T>(dst[e] * scale);
  }
}

// Load 16 bytes (kVec elements of T) at src into kVec floats at dst.
template <typename T>
__device__ __forceinline__ void load_vec(const T* __restrict__ src, float* dst, bool valid) {
  constexpr int kVec = 16 / sizeof(T);
  if (!valid) {
#pragma unroll
    for (int e = 0; e < kVec; ++e) dst[e] = 0.f;
    return;
  }
  unpack<T>(*reinterpret_cast<const uint4*>(src), dst);
}

template <int HD, int kTileQ>
struct Smem {
  static constexpr int kKStride = HD + 4;  // padded K rows
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kTileQ * HD;
  static constexpr int kV = kK + kTileK * kKStride;
  static constexpr int kS = kV + kTileK * HD;
  static constexpr int kM = kS + kTileQ * kTileK;
  static constexpr int kL = kM + kTileQ;
  static constexpr int kAlpha = kL + kTileQ;
  static constexpr int kPos = kAlpha + kTileQ;  // int
  static constexpr int kSlope = kPos + kTileQ;  // ALiBi slope of each row
  static constexpr int kMisc = kSlope + kTileQ;  // int: pages
  static constexpr int kFloats = kMisc + 4;
  static constexpr size_t kBytes = kFloats * sizeof(float);
};

// T: q and output type (fp32 | bf16). KV: pool type, T itself or a
// quantised int8_t / __nv_fp8_e4m3 with k_scale / v_scale [S_flat, kvH] fp32
// (nullptr when KV == T). kAlibi: slopes [H] fp32 (nullptr without).
template <typename T, typename KV, int HD, int kTileQ, bool kAlibi>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const T* __restrict__ q, const KV* __restrict__ k_pool,
                       const KV* __restrict__ v_pool, const float* __restrict__ k_scale,
                       const float* __restrict__ v_scale, const float* __restrict__ slopes,
                       const int* __restrict__ block_tables,
                       const int* __restrict__ q_positions, const int* __restrict__ new_lens,
                       T* __restrict__ out, int C, int H, int kvH, int P, int bs,
                       float q_scale) {
  constexpr bool kQuant = !std::is_same<KV, T>::value;
  using L = Smem<HD, kTileQ>;
  extern __shared__ float smem[];
  float* q_s = smem + L::kQ;
  float* k_s = smem + L::kK;
  float* v_s = smem + L::kV;
  float* s_s = smem + L::kS;
  float* m_s = smem + L::kM;
  float* l_s = smem + L::kL;
  float* alpha_s = smem + L::kAlpha;
  int* pos_s = reinterpret_cast<int*>(smem + L::kPos);
  float* slope_s = smem + L::kSlope;
  int* misc_s = reinterpret_cast<int*>(smem + L::kMisc);

  constexpr int kVec = 16 / sizeof(T);   // q elements per 16-byte load
  constexpr int kVecPerRow = HD / kVec;  // 16-byte loads per q row
  constexpr int kVecKV = 16 / sizeof(KV);      // pool elements per 16-byte load
  constexpr int kVecPerRowKV = HD / kVecKV;    // 16-byte loads per pool row
  const int tile = blockIdx.x, kh = blockIdx.y, n = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int G = H / kvH;
  const int Cg = C * G;
  const int row0 = tile * kTileQ;
  const int n_rows = min(kTileQ, Cg - row0);

  // ---- query tile: row r of the tile is (c, g) = divmod(row0 + r, G)
  for (int idx = tid; idx < kTileQ * kVecPerRow; idx += kThreads) {
    const int r = idx / kVecPerRow, vi = idx % kVecPerRow;
    const bool valid = r < n_rows;
    const int rg = row0 + r;
    const int c = valid ? rg / G : 0, g = valid ? rg % G : 0;
    const T* src = q + ((static_cast<int64_t>(n) * C + c) * H + kh * G + g) * HD + vi * kVec;
    float buf[kVec];
    load_vec<T>(src, buf, valid);
#pragma unroll
    for (int e = 0; e < kVec; ++e) q_s[r * HD + vi * kVec + e] = round_to<T>(buf[e] * q_scale);
  }
  for (int r = tid; r < kTileQ; r += kThreads) {
    pos_s[r] = r < n_rows ? q_positions[static_cast<int64_t>(n) * C + (row0 + r) / G] : -1;
    m_s[r] = -INFINITY;
    l_s[r] = 0.f;
    // row (c, g) of kv head kh is query head kh * G + g
    if constexpr (kAlibi) slope_s[r] = r < n_rows ? slopes[kh * G + (row0 + r) % G] : 0.f;
  }
  __syncthreads();

  // ---- live pages of this tile
  if (tid == 0) {
    const int* qpos_n = q_positions + static_cast<int64_t>(n) * C;
    const int row_max = qpos_n[min(max(new_lens[n] - 1, 0), C - 1)];
    int tile_max = -1;
    for (int r = 0; r < n_rows; ++r) tile_max = max(tile_max, pos_s[r]);
    const int row_pages = row_max < 0 ? 0 : (row_max + bs) / bs;
    const int tile_pages = tile_max < 0 ? 0 : (tile_max + bs) / bs;
    misc_s[0] = min(min(row_pages, tile_pages), P);
  }
  __syncthreads();
  const int n_tok = misc_s[0] * bs;
  const int* bt = block_tables + static_cast<int64_t>(n) * P;

  // per-thread output accumulators: head dims [d4*4, d4*4+4) of rows
  // r = rgrp + kRowGroups * i
  constexpr int kD4 = HD / 4;                   // float4 columns per row
  constexpr int kRowGroups = kThreads / kD4;    // 8 for hd 128, 16 for hd 64
  constexpr int kRowsPerThread = kTileQ / kRowGroups;
  const int d4 = tid % kD4, rgrp = tid / kD4;
  float acc[kRowsPerThread][4];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;

  // K and V of one 64-key step: kLoads 16-byte loads of each per thread
  // (with a quantised pool, the scale of each load's token beside it),
  // issued together into registers one step ahead (the next step's loads
  // are in flight while this step computes), stored to shared memory as fp32
  // at the top of the step that uses them. Page lookups are per token.
  constexpr int kLoads = kTileK * kVecPerRowKV / kThreads;
  static_assert(kTileK * kVecPerRowKV % kThreads == 0, "a step's loads split evenly");
  uint4 k_reg[kLoads], v_reg[kLoads];
  float ks_reg[kLoads], vs_reg[kLoads];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int it = 0; it < kLoads; ++it) {
      const int idx = tid + it * kThreads;
      const int t = k0 + idx / kVecPerRowKV, vi = idx % kVecPerRowKV;
      if (t < n_tok) {
        const int64_t slot = static_cast<int64_t>(bt[t / bs]) * bs + t % bs;
        const int64_t off = (slot * kvH + kh) * HD + vi * kVecKV;
        k_reg[it] = *reinterpret_cast<const uint4*>(k_pool + off);
        v_reg[it] = *reinterpret_cast<const uint4*>(v_pool + off);
        if constexpr (kQuant) {
          ks_reg[it] = k_scale[slot * kvH + kh];
          vs_reg[it] = v_scale[slot * kvH + kh];
        }
      } else {
        // zero bits: 0.0 in bf16, fp32, int8 and e4m3
        k_reg[it] = make_uint4(0u, 0u, 0u, 0u);
        v_reg[it] = make_uint4(0u, 0u, 0u, 0u);
        ks_reg[it] = vs_reg[it] = 0.f;
      }
    }
  };
  if (n_tok > 0) fetch(0);

  for (int k0 = 0; k0 < n_tok; k0 += kTileK) {
#pragma unroll
    for (int it = 0; it < kLoads; ++it) {
      const int idx = tid + it * kThreads;
      const int j = idx / kVecPerRowKV, vi = idx % kVecPerRowKV;
      float kb[kVecKV], vb[kVecKV];
      unpack_kv<T, KV>(k_reg[it], ks_reg[it], kb);
      unpack_kv<T, KV>(v_reg[it], vs_reg[it], vb);
#pragma unroll
      for (int e = 0; e < kVecKV; e += 4) {
        *reinterpret_cast<float4*>(k_s + j * L::kKStride + vi * kVecKV + e) =
            make_float4(kb[e], kb[e + 1], kb[e + 2], kb[e + 3]);
        *reinterpret_cast<float4*>(v_s + j * HD + vi * kVecKV + e) =
            make_float4(vb[e], vb[e + 1], vb[e + 2], vb[e + 3]);
      }
    }
    __syncthreads();
    if (k0 + kTileK < n_tok) fetch(k0 + kTileK);

    // ---- scores: thread owns key j and rows r = sg + 4 * i
    {
      const int j = tid % kTileK, sg = tid / kTileK;
      constexpr int kSG = kThreads / kTileK;         // 4
      constexpr int kSRows = kTileQ / kSG;           // 16
      float s[kSRows];
#pragma unroll
      for (int i = 0; i < kSRows; ++i) s[i] = 0.f;
      const float4* krow = reinterpret_cast<const float4*>(k_s + j * L::kKStride);
#pragma unroll 8
      for (int d = 0; d < HD / 4; ++d) {
        const float4 kv = krow[d];
#pragma unroll
        for (int i = 0; i < kSRows; ++i) {
          if (sg + kSG * i < n_rows) {
            const float4 qv = reinterpret_cast<const float4*>(q_s + (sg + kSG * i) * HD)[d];
            s[i] = fmaf(qv.x, kv.x, s[i]);
            s[i] = fmaf(qv.y, kv.y, s[i]);
            s[i] = fmaf(qv.z, kv.z, s[i]);
            s[i] = fmaf(qv.w, kv.w, s[i]);
          }
        }
      }
      const int t = k0 + j;
#pragma unroll
      for (int i = 0; i < kSRows; ++i) {
        const int r = sg + kSG * i;
        if (r < n_rows) {
          const bool visible = t < n_tok && t <= pos_s[r];
          float sc = s[i];
          if constexpr (kAlibi)
            sc = __fadd_rn(sc, __fmul_rn(slope_s[r], static_cast<float>(t - pos_s[r])));
          s_s[r * kTileK + j] = visible ? sc : -INFINITY;
        }
      }
    }
    __syncthreads();

    // ---- online softmax: one warp per row
    for (int r = warp; r < n_rows; r += kThreads / 32) {
      const float s0 = s_s[r * kTileK + lane], s1 = s_s[r * kTileK + lane + 32];
      float mx = fmaxf(s0, s1);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_prev = m_s[r];
      const float m_cur = fmaxf(m_prev, mx);
      const float m_safe = m_cur == -INFINITY ? 0.f : m_cur;
      const float p0 = expf(s0 - m_safe), p1 = expf(s1 - m_safe);
      float sum = p0 + p1;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      s_s[r * kTileK + lane] = p0;
      s_s[r * kTileK + lane + 32] = p1;
      if (lane == 0) {
        const float alpha = m_prev == -INFINITY ? 0.f : expf(m_prev - m_safe);
        l_s[r] = alpha * l_s[r] + sum;
        m_s[r] = m_cur;
        alpha_s[r] = alpha;
      }
    }
    __syncthreads();

    // ---- acc = alpha * acc + P V
    const int kmax = min(kTileK, n_tok - k0);
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const int r = rgrp + kRowGroups * i;
      if (r < n_rows) {
        const float a = alpha_s[r];
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][e] *= a;
      }
    }
#pragma unroll 8
    for (int j = 0; j < kmax; ++j) {
      const float4 vv = reinterpret_cast<const float4*>(v_s + j * HD)[d4];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) {
        const int r = rgrp + kRowGroups * i;
        if (r < n_rows) {
          const float p = s_s[r * kTileK + j];
          acc[i][0] = fmaf(p, vv.x, acc[i][0]);
          acc[i][1] = fmaf(p, vv.y, acc[i][1]);
          acc[i][2] = fmaf(p, vv.z, acc[i][2]);
          acc[i][3] = fmaf(p, vv.w, acc[i][3]);
        }
      }
    }
    __syncthreads();  // K, V and S are overwritten by the next step
  }

  // ---- out = acc / l (l == 0: nothing visible -> 0)
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int r = rgrp + kRowGroups * i;
    if (r < n_rows) {
      const float l = l_s[r];
      const float inv = 1.0f / (l == 0.f ? 1.f : l);
      const int rg = row0 + r, c = rg / G, g = rg % G;
      T* dst = out + ((static_cast<int64_t>(n) * C + c) * H + kh * G + g) * HD + d4 * 4;
#pragma unroll
      for (int e = 0; e < 4; ++e) dst[e] = from_float<T>(acc[i][e] * inv);
    }
  }
}


// ---------------------------------------------------------------- shared by forms "split" and W

struct Args {
  const void *q, *k_pool, *v_pool, *k_scale, *v_scale, *slopes, *block_tables, *q_positions,
      *new_lens;
  void* out;
  int N, C, H, kvH, P, bs;
  float q_scale;
  cudaStream_t stream;
  // forms "split" and W: the key split, the fp32 workspace of the splits'
  // partials and the ticket counters (both null with one split), the pool's rows
  int splits, span, S_flat;
  float* ws;
  int* tickets;
};

// The splits' partials of one (row, kv head, row group or tile) unit, in the
// workspace: split s at unit + s * cap * (HD + 2) holds acc [cap][HD], then m
// [cap], then l [cap] (fp32; acc not yet divided by l). The block that drew
// the unit's last ticket merges them in split order, so that the output is
// the same bits in every run: M = max m_s, L = sum l_s e^(m_s - M), acc =
// sum acc_s e^(m_s - M), out = acc / L (0 where L == 0). A split whose m is
// -inf saw no key of the row and weighs 0 (every split merged wrote every
// row's acc, 0 there).
template <typename T, int HD>
__device__ void merge_splits(const float* unit, int splits, int cap, int row0, int n_rows, int n,
                             int kh, int C, int H, int G, T* out, int tid, int nthreads) {
  const int stride = cap * (HD + 2);
  for (int idx = tid; idx < n_rows * HD; idx += nthreads) {
    const int r = idx / HD, d = idx % HD;
    float M = -INFINITY;
    for (int s = 0; s < splits; ++s) M = fmaxf(M, __ldcg(unit + s * stride + cap * HD + r));
    const float m_safe = M == -INFINITY ? 0.f : M;
    float L = 0.f, acc = 0.f;
#pragma unroll 4
    for (int s = 0; s < splits; ++s) {
      const float* part = unit + s * stride;
      const float m = __ldcg(part + cap * HD + r);
      const float w = m == -INFINITY ? 0.f : expf(m - m_safe);
      L += __ldcg(part + cap * HD + cap + r) * w;
      acc += __ldcg(part + r * HD + d) * w;
    }
    const int rr = row0 + r, c = rr / G, g = rr % G;
    out[((static_cast<int64_t>(n) * C + c) * H + kh * G + g) * HD + d] =
        from_float<T>(acc * (1.0f / (L == 0.f ? 1.f : L)));
  }
}

// e^x as 2^(x log2 e) by the SFU's approximation, results below 2^-126
// flushed to 0 (a softmax weight that small moves no output)
constexpr float kLog2e = 1.4426950408889634f;
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(hopper::smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(hopper::smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// E consecutive pool values at p (E * sizeof(KV) bytes, that many aligned) as floats
template <typename KV, int E>
__device__ __forceinline__ void load_elems(const unsigned char* p, float* dst) {
  constexpr int kBytes = E * static_cast<int>(sizeof(KV));
  using Raw = typename std::conditional<
      kBytes == 16, uint4,
      typename std::conditional<kBytes == 8, uint2,
                                typename std::conditional<kBytes == 4, uint32_t,
                                                          unsigned short>::type>::type>::type;
  static_assert(sizeof(Raw) == kBytes, "load_elems: 2, 4, 8 or 16 bytes");
  const Raw raw = *reinterpret_cast<const Raw*>(p);
  const KV* v = reinterpret_cast<const KV*>(&raw);
#pragma unroll
  for (int e = 0; e < E; ++e) dst[e] = to_float(v[e]);
}

// Four 8x8 bf16 matrices from shared memory (lane l names row l % 8 of
// matrix l / 8) into a warp's registers: lane 4 g + t receives row g, columns
// 2t and 2t + 1 of each (with kTrans: of each matrix transposed).
template <bool kTrans>
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  if constexpr (kTrans)
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(hopper::smem_addr(p)));
  else
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(hopper::smem_addr(p)));
}

// acc (16 x 8) += A (16 x 16) B (16 x 8), bf16 in, fp32 accumulated; lane 4 g
// + t holds acc rows g (acc[0], acc[1]) and g + 8 (acc[2], acc[3]), columns
// 2t and 2t + 1
__device__ __forceinline__ void mma16816(float (&acc)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(acc[0]), "+f"(acc[1]), "+f"(acc[2]), "+f"(acc[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc (16 x 8) += A (16 x 8) B (8 x 8): A's fragment is the layout of an
// m16n8 accumulator's (rows g and g + 8, columns 2t and 2t + 1)
__device__ __forceinline__ void mma1688(float (&acc)[4], const uint32_t (&a)[2], uint32_t b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+f"(acc[0]), "+f"(acc[1]), "+f"(acc[2]), "+f"(acc[3])
      : "r"(a[0]), "r"(a[1]), "r"(b));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// ---------------------------------------------------------------- form "split"
namespace form_split {

constexpr int kWarps = 4;
constexpr int kThreadsS = 32 * kWarps;
constexpr int kChunk = 8;   // tokens a warp step
constexpr int kParts = 32 / kChunk;  // lanes a token: each takes HD / kParts of its dot product
constexpr int kStages = 3;  // chunks in flight a warp
constexpr int kMaxSpan = 256;  // pages a split, at most (the C entry checks it)

template <typename KV, int HD, int kRows>
struct Smem {  // byte offsets
  static constexpr int kRowBytes = HD * static_cast<int>(sizeof(KV));  // one token's K (or V)
  // K and V rows padded: a quarter warp's 16-byte reads (ldmatrix's 8 rows) hit 8 bank groups
  static constexpr int kKLd = kRowBytes + 16;
  static constexpr int kStage = 2 * kChunk * kKLd + 2 * kChunk * 4;  // K, V, scales
  static constexpr int kRing = kWarps * kStages * kStage;
  static constexpr int kMerge = kWarps * kRows * (HD + 2) * 4;  // the warps' m, l, acc (after the loop)
  static constexpr int kQ = 0;                                   // float [kRows][HD]
  static constexpr int kP = kQ + kRows * HD * 4;                 // float [kWarps][kRows][kChunk]
  static constexpr int kRingOff = kP + kWarps * kRows * kChunk * 4;
  static constexpr int kPos = kRingOff + (kRing > kMerge ? kRing : kMerge);  // int [kRows]
  static constexpr int kSlope = kPos + kRows * 4;                            // float [kRows]
  static constexpr int kMisc = kSlope + kRows * 4;                           // int [4]
  static constexpr int kBt = kMisc + 16;  // int [kMaxSpan]: the span's block-table entries
  static constexpr int kBytes = kBt + kMaxSpan * 4;
  static_assert(kStage % 16 == 0 && kBytes <= 232448, "form split: shared memory");
};

// T: q and output type; KV: pool type (T, or int8 / e4m3 codes with fp32
// scales); kRows: (c, g) rows a block (1, 4 or 16).
template <typename T, typename KV, int HD, int kRows, bool kAlibi>
__global__ void __launch_bounds__(kThreadsS)
paged_split_kernel(const Args a) {
  constexpr bool kQuant = !std::is_same<KV, T>::value;
  // a bf16 pool with at most 4 rows: the products on the tensor cores
  // (mma.sync, the rows padded to 16); else FMAs on the CUDA cores
  constexpr bool kTC = std::is_same<T, __nv_bfloat16>::value && !kQuant && kRows <= 4;
  constexpr int kE = HD / 32;  // output columns a lane
  constexpr int kVecKV = 16 / static_cast<int>(sizeof(KV));
  using L = Smem<KV, HD, kRows>;
  static_assert(kChunk * (L::kRowBytes / 16) % 32 == 0, "a chunk's loads split evenly over a warp");
  static_assert(!kTC || kChunk == 8, "the tensor-core form takes 8-key chunks (mma n = 8)");
  extern __shared__ __align__(16) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem + L::kQ);
  int* pos_s = reinterpret_cast<int*>(smem + L::kPos);
  float* slope_s = reinterpret_cast<float*>(smem + L::kSlope);
  int* misc_s = reinterpret_cast<int*>(smem + L::kMisc);

  const int row_groups = gridDim.y / a.kvH;
  const int split = blockIdx.x, kh = blockIdx.y / row_groups, rg = blockIdx.y % row_groups;
  const int n = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int G = a.H / a.kvH, row0 = rg * kRows, n_rows = min(kRows, a.C * G - row0);
  const int unit = (n * a.kvH + kh) * row_groups + rg;
  const T* q = static_cast<const T*>(a.q);
  T* out = static_cast<T*>(a.out);

  // One round trip to memory before the pages: the rows' positions and
  // slopes, the row's new_lens, the span's block-table entries and the q rows
  // are all read at once (the q rows and entries of a split that turns out
  // empty are read for nothing; the pool is not).
  const int* qpos = static_cast<const int*>(a.q_positions) + static_cast<int64_t>(n) * a.C;
  const int p0 = split * a.span;
  int* bt_s = reinterpret_cast<int*>(smem + L::kBt);
  {
    const int* bt_n = static_cast<const int*>(a.block_tables) + static_cast<int64_t>(n) * a.P;
    for (int i = tid; i < min(a.span, a.P - p0); i += kThreadsS) bt_s[i] = bt_n[p0 + i];
  }
  for (int r = tid; r < kRows; r += kThreadsS) {
    const bool valid = r < n_rows;
    const int rr = row0 + r;
    pos_s[r] = valid ? qpos[rr / G] : -1;  // a row past C * G sees nothing and is never stored
    if constexpr (kAlibi) slope_s[r] = valid ? static_cast<const float*>(a.slopes)[kh * G + rr % G] : 0.f;
  }
  if (tid == kThreadsS - 1) misc_s[2] = static_cast<const int*>(a.new_lens)[n];
  // q rows, scaled and rounded in T, as fp32
  for (int idx = tid; idx < kRows * HD; idx += kThreadsS) {
    const int r = idx / HD, d = idx % HD;
    float v = 0.f;
    if (r < n_rows) {
      const int rr = row0 + r;
      v = round_to<T>(
          to_float(q[((static_cast<int64_t>(n) * a.C + rr / G) * a.H + kh * G + rr % G) * HD + d]) *
          a.q_scale);
    }
    q_s[idx] = v;
  }
  __syncthreads();
  if (tid == 0) {
    // the row's live length: the position at new_lens - 1, from the rows'
    // own positions where it is one of them (always at decode)
    int block_max = -1;
    for (int r = 0; r < n_rows; ++r) block_max = max(block_max, pos_s[r]);
    const int c_last = min(max(misc_s[2] - 1, 0), a.C - 1);
    const int r_last = c_last * G - row0;
    const int row_max = r_last >= 0 && r_last < n_rows ? pos_s[r_last] : qpos[c_last];
    const int row_pages = row_max < 0 ? 0 : (row_max + a.bs) / a.bs;
    const int block_pages = block_max < 0 ? 0 : (block_max + a.bs) / a.bs;
    misc_s[0] = min(min(row_pages, block_pages), a.P);
  }
  __syncthreads();
  // Split s takes the fixed span of pages [s * span, (s + 1) * span), cut at
  // the live pages. Splits past the last live one leave at once (no partial,
  // no ticket); a unit with one live split (or none: split 0 writes zeros)
  // writes its output directly.
  const int n_pages = misc_s[0];
  const int live = (n_pages + a.span - 1) / a.span;
  if (split >= max(live, 1)) return;
  const int p1 = min(p0 + a.span, n_pages);
  const int t_lo = p0 * a.bs, t_hi = p1 * a.bs;
  const int stride = kRows * (HD + 2);
  float* part = live > 1 ? a.ws + (static_cast<int64_t>(unit) * a.splits + split) * stride : nullptr;

  if (t_lo < t_hi) {
    const int n_chunks = (t_hi - t_lo + kChunk - 1) / kChunk;
    const int my_chunks = warp < n_chunks ? (n_chunks - warp + kWarps - 1) / kWarps : 0;
    unsigned char* ring = smem + L::kRingOff + warp * kStages * L::kStage;
    const unsigned char* kp = static_cast<const unsigned char*>(a.k_pool);
    const unsigned char* vp = static_cast<const unsigned char*>(a.v_pool);
    // chunk i of this warp (tokens t0 .. t0 + 15 of the span) into its ring
    // stage: lane j < 16 looks up token j's slot, every lane copies 16-byte
    // pieces of the token rows; tokens past t_hi are zero-filled, unread
    const auto issue = [&](int i) {
      unsigned char* st = ring + (i % kStages) * L::kStage;
      const int t0 = t_lo + (warp + kWarps * i) * kChunk;
      int slot = -1;
      if (lane < kChunk && t0 + lane < t_hi) {
        const int t = t0 + lane;
        slot = bt_s[t / a.bs - p0] * a.bs + t % a.bs;
      }
      constexpr int kVecRow = L::kRowBytes / 16;
#pragma unroll
      for (int v = lane; v < kChunk * kVecRow; v += 32) {
        const int tok = v / kVecRow, piece = v % kVecRow;
        const int s = __shfl_sync(0xffffffffu, slot, tok);
        const int64_t off = (static_cast<int64_t>(max(s, 0)) * a.kvH + kh) * L::kRowBytes + piece * 16;
        const int bytes = s >= 0 ? 16 : 0;
        cp_async16(st + tok * L::kKLd + piece * 16, kp + off, bytes);
        cp_async16(st + (kChunk + tok) * L::kKLd + piece * 16, vp + off, bytes);
      }
      if constexpr (kQuant) {
        if (lane < kChunk) {
          float* sc = reinterpret_cast<float*>(st + 2 * kChunk * L::kKLd);
          const int64_t so = static_cast<int64_t>(max(slot, 0)) * a.kvH + kh;
          cp_async4(sc + lane, static_cast<const float*>(a.k_scale) + so, slot >= 0 ? 4 : 0);
          cp_async4(sc + kChunk + lane, static_cast<const float*>(a.v_scale) + so, slot >= 0 ? 4 : 0);
        }
      }
    };

    // Every one of the kRows rows runs, those past n_rows too (q 0,
    // position -1: all masked, p 0): a branch on n_rows in these loops kept
    // the compiler from batching their shared-memory loads
    float m[kRows], l[kRows], acc[kRows][kE];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      m[r] = -INFINITY;
      l[r] = 0.f;
#pragma unroll
      for (int e = 0; e < kE; ++e) acc[r][e] = 0.f;
    }
    float* p_w = reinterpret_cast<float*>(smem + L::kP) + warp * kRows * kChunk;
    const int j = lane % kChunk, hh = lane / kChunk;
    // the tensor-core form's state: rows gq and gq + 8 of the 16 (those
    // past kRows are zero), key columns 2 tq and 2 tq + 1 of a chunk
    const int gq = lane >> 2, tq = lane & 3;
    float m2[2] = {-INFINITY, -INFINITY}, l2[2] = {0.f, 0.f}, o[HD / 8][4];
    uint32_t qf[HD / 16][4];
    if constexpr (kTC) {
#pragma unroll
      for (int nt = 0; nt < HD / 8; ++nt)
#pragma unroll
        for (int c = 0; c < 4; ++c) o[nt][c] = 0.f;
      // Q's A fragments: rows gq, gq + 8 and columns 2 tq, 2 tq + 8 of each
      // 16-column k-step (the values q_s holds are bf16 already)
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
#pragma unroll
        for (int i4 = 0; i4 < 4; ++i4) {
          const int r = gq + 8 * (i4 & 1), col = 16 * kk + 8 * (i4 >> 1) + 2 * tq;
          qf[kk][i4] = r < kRows ? pack_bf16(q_s[r * HD + col], q_s[r * HD + col + 1]) : 0u;
        }
    }

#pragma unroll
    for (int i = 0; i < kStages - 1; ++i) {
      if (i < my_chunks) issue(i);
      cp_async_commit();
    }
    for (int i = 0; i < my_chunks; ++i) {
      if (i + kStages - 1 < my_chunks) issue(i + kStages - 1);
      cp_async_commit();
      cp_async_wait<kStages - 1>();
      __syncwarp();
      const unsigned char* st = ring + (i % kStages) * L::kStage;
      const float* scl = reinterpret_cast<const float*>(st + 2 * kChunk * L::kKLd);
      const int t0 = t_lo + (warp + kWarps * i) * kChunk;

      if constexpr (kTC) {
        // S (16 rows x 8 keys) = Q K^T: the chunk's K rows (hd contiguous) are
        // the B operand, two k-steps an ldmatrix
        float sf[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int kk = 0; kk < HD / 16; kk += 2) {
          uint32_t b[4];
          ldsm_x4<false>(b, st + (lane & 7) * L::kKLd + (16 * kk + 8 * (lane >> 3)) * 2);
          mma16816(sf, qf[kk], b[0], b[1]);
          mma16816(sf, qf[kk + 1], b[2], b[3]);
        }
        // the online softmax: entry c is row gq + 8 (c >> 1) at key t0 + 2 tq +
        // (c & 1); the 4 lanes of a quad share a row. l2 holds this lane's
        // share of the row's sum (the quad's are added at the end)
        uint32_t pf[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int r = gq + 8 * i;
          const int pr = r < kRows ? pos_s[r] : -1;
          float v[2];
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int key = t0 + 2 * tq + c;
            float x = sf[2 * i + c];
            if constexpr (kAlibi)
              x = __fadd_rn(x, __fmul_rn(r < kRows ? slope_s[r] : 0.f, static_cast<float>(key - pr)));
            v[c] = key < t_hi && key <= pr ? x : -INFINITY;
          }
          float mx = fmaxf(v[0], v[1]);
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
          const float m_new = fmaxf(m2[i], mx);
          const float m_safe = m_new == -INFINITY ? 0.f : m_new;
          const float alpha = m2[i] == -INFINITY ? 0.f : ex2((m2[i] - m_safe) * kLog2e);
          const float p0 = ex2(fmaf(v[0], kLog2e, -m_safe * kLog2e));
          const float p1 = ex2(fmaf(v[1], kLog2e, -m_safe * kLog2e));
          l2[i] = alpha * l2[i] + (p0 + p1);
          m2[i] = m_new;
#pragma unroll
          for (int nt = 0; nt < HD / 8; ++nt) {
            o[nt][2 * i] *= alpha;
            o[nt][2 * i + 1] *= alpha;
          }
          pf[i] = pack_bf16(p0, p1);  // P in bf16, as the plain version rounds it
        }
        // O (16 x hd) += P (16 x 8 keys) V (8 keys x hd): P's fragment is the
        // scores' own, V's rows read transposed, four 8-column tiles an ldmatrix
#pragma unroll
        for (int nt4 = 0; nt4 < HD / 32; ++nt4) {
          uint32_t b[4];
          ldsm_x4<true>(b, st + (kChunk + (lane & 7)) * L::kKLd + (32 * nt4 + 8 * (lane >> 3)) * 2);
#pragma unroll
          for (int mi = 0; mi < 4; ++mi) mma1688(o[4 * nt4 + mi], pf, b[mi]);
        }
      } else {
        // scores of key t0 + j over part hh of hd, in order of d
        float s[kRows];
  #pragma unroll
        for (int r = 0; r < kRows; ++r) s[r] = 0.f;
        const float ksc = kQuant ? scl[j] : 1.f;
        const unsigned char* krow = st + j * L::kKLd + hh * (L::kRowBytes / kParts);
  #pragma unroll
        for (int u = 0; u < HD / kParts / kVecKV; ++u) {
          float kf[kVecKV];
          unpack_kv<T, KV>(*reinterpret_cast<const uint4*>(krow + u * 16), ksc, kf);
  #pragma unroll
          for (int r = 0; r < kRows; ++r) {
            const float* qr = q_s + r * HD + hh * (HD / kParts) + u * kVecKV;
  #pragma unroll
            for (int e = 0; e < kVecKV; e += 4) {
              const float4 qv = *reinterpret_cast<const float4*>(qr + e);
              s[r] = fmaf(qv.x, kf[e], s[r]);
              s[r] = fmaf(qv.y, kf[e + 1], s[r]);
              s[r] = fmaf(qv.z, kf[e + 2], s[r]);
              s[r] = fmaf(qv.w, kf[e + 3], s[r]);
            }
          }
        }
        // the online softmax of each row over the chunk's kChunk keys (lanes
        // j, j + kChunk, ... hold key j's score, the same bits in each)
        const int t = t0 + j;
  #pragma unroll
        for (int r = 0; r < kRows; ++r) {
          // the parts' sums, pairwise: every lane of key j ends with the same bits
          float sc = s[r] + __shfl_xor_sync(0xffffffffu, s[r], kChunk);
          sc += __shfl_xor_sync(0xffffffffu, sc, 2 * kChunk);
          if constexpr (kAlibi)
            sc = __fadd_rn(sc, __fmul_rn(slope_s[r], static_cast<float>(t - pos_s[r])));
          if (!(t < t_hi && t <= pos_s[r])) sc = -INFINITY;
          float mx = sc;
  #pragma unroll
          for (int o = kChunk / 2; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
          const float m_new = fmaxf(m[r], mx);
          const float m_safe = m_new == -INFINITY ? 0.f : m_new;
          const float alpha = m[r] == -INFINITY ? 0.f : ex2((m[r] - m_safe) * kLog2e);
          const float p = ex2(fmaf(sc, kLog2e, -m_safe * kLog2e));
          float sum = p;
  #pragma unroll
          for (int o = kChunk / 2; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
          l[r] = alpha * l[r] + sum;
          m[r] = m_new;
  #pragma unroll
          for (int e = 0; e < kE; ++e) acc[r][e] *= alpha;
          if (hh == 0) p_w[r * kChunk + j] = p;
        }
        __syncwarp();
        // acc += P V: columns [lane * kE, lane * kE + kE) of every row, over
        // all the chunk's keys (past t_hi p is 0 and V's rows zero-filled: they add 0)
        const unsigned char* vcol = st + kChunk * L::kKLd + lane * kE * static_cast<int>(sizeof(KV));
  #pragma unroll
        for (int jj = 0; jj < kChunk; ++jj) {
          float vf[kE];
          load_elems<KV, kE>(vcol + jj * L::kKLd, vf);
          if constexpr (kQuant) {
            const float vsc = scl[kChunk + jj];
  #pragma unroll
            for (int e = 0; e < kE; ++e) vf[e] = round_to<T>(vf[e] * vsc);
          }
  #pragma unroll
          for (int r = 0; r < kRows; ++r) {
            const float p = p_w[r * kChunk + jj];
  #pragma unroll
            for (int e = 0; e < kE; ++e) acc[r][e] = fmaf(p, vf[e], acc[r][e]);
          }
        }

      }
      __syncwarp();
    }
    cp_async_wait<0>();
    __syncthreads();  // every ring is drained: the warps' partials go where the rings were

    float* mw = reinterpret_cast<float*>(smem + L::kRingOff);  // [kWarps][kRows]
    float* lw = mw + kWarps * kRows;                            // [kWarps][kRows]
    float* aw = lw + kWarps * kRows;                            // [kWarps][kRows][HD]
    if constexpr (kTC) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        l2[i] += __shfl_xor_sync(0xffffffffu, l2[i], 1);
        l2[i] += __shfl_xor_sync(0xffffffffu, l2[i], 2);
        const int r = gq + 8 * i;
        if (r < n_rows) {
          if (tq == 0) {
            mw[warp * kRows + r] = m2[i];
            lw[warp * kRows + r] = l2[i];
          }
#pragma unroll
          for (int nt = 0; nt < HD / 8; ++nt)
            *reinterpret_cast<float2*>(aw + (warp * kRows + r) * HD + 8 * nt + 2 * tq) =
                make_float2(o[nt][2 * i], o[nt][2 * i + 1]);
        }
      }
    } else {
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (r < n_rows) {
          if (lane == 0) {
            mw[warp * kRows + r] = m[r];
            lw[warp * kRows + r] = l[r];
          }
#pragma unroll
          for (int e = 0; e < kE; ++e) aw[(warp * kRows + r) * HD + lane * kE + e] = acc[r][e];
        }
      }
    }
    __syncthreads();
    // the warps merged in order: the block's (m, l, acc), the output itself
    // with one split
    for (int idx = tid; idx < n_rows * HD; idx += kThreadsS) {
      const int r = idx / HD, d = idx % HD;
      float M = -INFINITY;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) M = fmaxf(M, mw[w * kRows + r]);
      const float m_safe = M == -INFINITY ? 0.f : M;
      float Lsum = 0.f, A = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float mm = mw[w * kRows + r];
        if (mm == -INFINITY) continue;
        const float wt = expf(mm - m_safe);
        Lsum += lw[w * kRows + r] * wt;
        A += aw[(w * kRows + r) * HD + d] * wt;
      }
      if (part == nullptr) {
        const int rr = row0 + r;
        out[((static_cast<int64_t>(n) * a.C + rr / G) * a.H + kh * G + rr % G) * HD + d] =
            from_float<T>(A * (1.0f / (Lsum == 0.f ? 1.f : Lsum)));
      } else {
        part[r * HD + d] = A;
        if (d == 0) {
          part[kRows * HD + r] = M;
          part[kRows * HD + kRows + r] = Lsum;
        }
      }
    }
  } else {
    // no live page: the rows' outputs are 0
    for (int idx = tid; idx < n_rows * HD; idx += kThreadsS) {
      const int r = idx / HD, rr = row0 + r;
      out[((static_cast<int64_t>(n) * a.C + rr / G) * a.H + kh * G + rr % G) * HD + idx % HD] =
          from_float<T>(0.f);
    }
  }

  if (part != nullptr) {
    __threadfence();
    __syncthreads();
    if (tid == 0) misc_s[1] = atomicAdd(a.tickets + unit, 1) == live - 1;
    __syncthreads();
    if (misc_s[1]) {  // the last of the unit's live splits to arrive merges them all
      __threadfence();
      merge_splits<T, HD>(a.ws + static_cast<int64_t>(unit) * a.splits * stride, live, kRows,
                          row0, n_rows, n, kh, a.C, a.H, G, out, tid, kThreadsS);
      if (tid == 0) a.tickets[unit] = 0;
    }
  }
}

// (c, g) rows a block: 1 (G = 1 decode), 4 (GQA decode up to G = 4), else 16
// (several row groups past 16); ops/paged_attention.py split_rows mirrors it
inline int rows_of(int R) { return R == 1 ? 1 : R <= 4 ? 4 : 16; }

template <typename T, typename KV, int HD, int kRows, bool kAlibi>
int launch_rows(const Args& a) {
  constexpr int kBytes = Smem<KV, HD, kRows>::kBytes;
  static bool smem_set[hopper::kMaxDevices];
  const auto kernel = paged_split_kernel<T, KV, HD, kRows, kAlibi>;
  cudaError_t err = hopper::allow_smem(reinterpret_cast<const void*>(kernel), kBytes, smem_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  // The whole of the SM's unified memory as shared memory, so that as many
  // blocks (~57 KB each at bf16, hd 128) stay on an SM as it holds: left to
  // itself CUDA may carve out room for fewer
  static bool carved[hopper::kMaxDevices];
  int dev = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess && dev >= 0 && dev < hopper::kMaxDevices && !carved[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    carved[dev] = err == cudaSuccess;
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const int groups = (a.C * (a.H / a.kvH) + kRows - 1) / kRows;
  if (static_cast<int64_t>(a.kvH) * groups > 65535) return cudaErrorInvalidValue;
  kernel<<<dim3(a.splits, a.kvH * groups, a.N), kThreadsS, kBytes, a.stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename KV, int HD, bool kAlibi>
int launch_alibi(const Args& a) {
  const int rows = rows_of(a.C * (a.H / a.kvH));
  if (rows == 1) return launch_rows<T, KV, HD, 1, kAlibi>(a);
  if (rows == 4) return launch_rows<T, KV, HD, 4, kAlibi>(a);
  return launch_rows<T, KV, HD, 16, kAlibi>(a);
}

template <typename T, typename KV, int HD>
int launch(const Args& a) {
  return a.slopes != nullptr ? launch_alibi<T, KV, HD, true>(a) : launch_alibi<T, KV, HD, false>(a);
}

}  // namespace form_split

// ---------------------------------------------------------------- form W
namespace form_w {

typedef __nv_bfloat16 bf16;

constexpr int kBN = 128;         // keys a tile, at most (whole pages: 128 / bs of them)
constexpr int kBox = kBN * 128;  // 16 KB: 128 key rows x 64 bf16 columns, one 128-byte swizzled box
constexpr int kWG = 2;           // consumer warpgroups
constexpr int kBM = 64 * kWG;    // (c, g) rows a block
constexpr int kThreadsW = 128 * (kWG + 1);  // the consumers, then the producer's warpgroup
constexpr int kConverters = 96;  // the producer warpgroup's warps 1-3 (a quantised pool)
template <int HD, bool kQuant>
struct Smem {  // byte offsets from the 1024-aligned base
  static constexpr int kBoxes = HD / 64;
  // bf16 K/V tiles in flight: ~3 tiles of loads at hd 128, 4 at hd 64 (a
  // quantised pool has a ring of codes beside them, as deep)
  static constexpr int kStages = kQuant ? (HD == 64 ? 3 : 2) : (HD == 64 ? 4 : 3);
  static constexpr int kStage = 2 * kBoxes * kBox;        // K's boxes, then V's
  static constexpr int kCodeStages = kQuant ? kStages : 0;
  static constexpr int kCodeStage = 2 * kBN * HD;         // K's codes [kBN][HD], then V's
  static constexpr int kOutBox = 64 * 128;                // 64 rows x 64 bf16 columns
  static constexpr int kKV = 0;
  static constexpr int kCodes = kKV + kStages * kStage;
  static constexpr int kOut = kCodes + kCodeStages * kCodeStage;  // [kWG][kBoxes] boxes: the output staged
  static constexpr int kScales = kOut + kWG * kBoxes * kOutBox;   // float [2][kBN] (quantised)
  static constexpr int kRed = kScales + (kQuant ? 2 * kBN * 4 : 0);  // int [kWG][4]
  static constexpr int kFlag = kRed + kWG * 4 * 4;                   // int [4]
  static constexpr int kBars = kFlag + 16;
  static constexpr int kBytes = kBars + (2 * kStages + 2 * kCodeStages) * 8 + 1024;
  static_assert(kBytes <= 232448, "form W: shared memory");
};

using hopper::bar_arrive;
using hopper::bar_sync;

// S (64 x 128) = Q K^T over hd, Q's A fragments in registers, K from the
// swizzled tile (K-major, 8-row groups 1024 bytes apart)
template <int HD>
__device__ __forceinline__ void issue_qk(float (&s)[kBN / 8][4], const uint32_t (&qf)[HD / 16][4],
                                         unsigned k_addr) {
  hopper::wgmma_m64n128k16_rs<false>(s, qf[0], hopper::wgmma_desc(k_addr, 16, 1024));
#pragma unroll
  for (int kk = 1; kk < HD / 16; ++kk)
    hopper::wgmma_m64n128k16_rs<true>(
        s, qf[kk], hopper::wgmma_desc(k_addr + (kk / 4) * kBox + (kk % 4) * 32, 16, 1024));
}

// O (64 x hd) += P V: k-step kk takes P's columns [16 kk, 16 kk + 16) from
// registers and V's rows [16 kk, 16 kk + 16), MN-major (the transpose bit)
template <int HD>
__device__ __forceinline__ void issue_pv(float (&o)[HD / 8][4], const uint32_t (&p)[kBN / 16][4],
                                         unsigned v_addr) {
#pragma unroll
  for (int kk = 0; kk < kBN / 16; ++kk) {
    const uint64_t desc = hopper::wgmma_desc(v_addr + kk * 2048, kBox, 1024);
    if constexpr (HD == 64)
      hopper::wgmma_m64n64k16_rs_t(o, p[kk], desc, 1);
    else
      hopper::wgmma_m64n128k16_rs_t(o, p[kk], desc, 1);
  }
}

// One key tile's scores in place: ALiBi, the mask (key key0 + col is
// visible to row i iff col < n_keys, it is below t_hi and at or below
// pos[i]; skipped where the thread's rows see the whole tile), then the
// online softmax: sc becomes e^(s - m_new), m the rows' new max, l this
// thread's share of the rows' sums, alpha the factor of their earlier output.
template <bool kAlibi>
__device__ __forceinline__ void softmax_tile(float (&sc)[kBN / 8][4], float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], int key0, int n_keys, int t_hi,
                                             const int (&pos)[2], const float (&slope)[2], int t) {
  if constexpr (kAlibi) {
    const float fb[2] = {static_cast<float>(key0 + 2 * t - pos[0]),
                         static_cast<float>(key0 + 2 * t - pos[1])};
#pragma unroll
    for (int nn = 0; nn < kBN / 8; ++nn)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float d = __fadd_rn(fb[c >> 1], static_cast<float>(nn * 8 + (c & 1)));
        sc[nn][c] = __fadd_rn(sc[nn][c], __fmul_rn(slope[c >> 1], d));
      }
  }
  const bool whole = n_keys == kBN && key0 + kBN <= t_hi && key0 + kBN - 1 <= min(pos[0], pos[1]);
  if (!whole) {
#pragma unroll
    for (int nn = 0; nn < kBN / 8; ++nn)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = nn * 8 + 2 * t + (c & 1), key = key0 + col;
        if (!(col < n_keys && key < t_hi && key <= pos[c >> 1])) sc[nn][c] = -INFINITY;
      }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float mx = -INFINITY;
#pragma unroll
    for (int nn = 0; nn < kBN / 8; ++nn) mx = fmaxf(mx, fmaxf(sc[nn][2 * i], sc[nn][2 * i + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_cur = fmaxf(m[i], mx);
    const float m_safe = m_cur == -INFINITY ? 0.f : m_cur;
    alpha[i] = m[i] == -INFINITY ? 0.f : ex2((m[i] - m_safe) * kLog2e);
    const float mb = m_safe * kLog2e;
    float sum = 0.f;
#pragma unroll
    for (int nn = 0; nn < kBN / 8; ++nn) {
      sc[nn][2 * i] = ex2(fmaf(sc[nn][2 * i], kLog2e, -mb));
      sc[nn][2 * i + 1] = ex2(fmaf(sc[nn][2 * i + 1], kLog2e, -mb));
      sum += sc[nn][2 * i] + sc[nn][2 * i + 1];
    }
    l[i] = alpha[i] * l[i] + sum;
    m[i] = m_cur;
  }
}

// P (the softmax's C fragments) rounded to bf16 as the A fragments of P V
__device__ __forceinline__ void pack_p(uint32_t (&p)[kBN / 16][4], const float (&sc)[kBN / 8][4]) {
#pragma unroll
  for (int j = 0; j < kBN / 16; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 v2 = __floats2bfloat162_rn(sc[2 * j + (i >> 1)][2 * (i & 1)],
                                                      sc[2 * j + (i >> 1)][2 * (i & 1) + 1]);
      p[j][i] = *reinterpret_cast<const uint32_t*>(&v2);
    }
}

// KV: bf16 (the pool as stored) or int8_t / __nv_fp8_e4m3 codes with fp32 scales
template <typename KV, int HD, bool kAlibi>
__global__ void __launch_bounds__(kThreadsW, 1)
paged_wgmma_kernel(const __grid_constant__ CUtensorMap k_map,
                   const __grid_constant__ CUtensorMap v_map, const Args a) {
  constexpr bool kQuant = !std::is_same<KV, bf16>::value;
  using L = Smem<HD, kQuant>;
  constexpr int kBoxes = L::kBoxes, kStages = L::kStages;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = hopper::align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* empty = full + kStages;
  uint64_t* cfull = empty + kStages;   // the codes' ring (quantised)
  uint64_t* cempty = cfull + L::kCodeStages;
  int* red = reinterpret_cast<int*>(smem + L::kRed);
  int* flag = reinterpret_cast<int*>(smem + L::kFlag);

  const int tiles = gridDim.x;
  const int tile = tiles - 1 - static_cast<int>(blockIdx.x);  // the last (longest) tiles first
  const int kh = blockIdx.y / a.splits, split = blockIdx.y % a.splits, n = blockIdx.z;
  const int tid = threadIdx.x;
  const int G = a.H / a.kvH, R = a.C * G;
  const int unit = (n * a.kvH + kh) * tiles + tile;
  const int ppt = kBN / a.bs, n_keys = ppt * a.bs;  // pages and keys a tile
  const int* qpos = static_cast<const int*>(a.q_positions) + static_cast<int64_t>(n) * a.C;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&full[s], kQuant ? kConverters : 32);
      hopper::mbar_init(&empty[s], kWG);  // one arrival per consumer warpgroup
    }
    for (int s = 0; s < L::kCodeStages; ++s) {
      hopper::mbar_init(&cfull[s], 32);  // the producer warp's lanes (one with the copies' bytes)
      hopper::mbar_init(&cempty[s], kConverters);
    }
    hopper::mbar_init_fence();
    flag[0] = -1;
  }
  if (n_keys < kBN) {  // rows past a tile's whole pages stay zero: TMA never writes them
    for (int i = tid; i < kStages * 2 * kBoxes * (kBN - n_keys) * 8; i += kThreadsW) {
      const int chunk = i % 8, row = n_keys + (i / 8) % (kBN - n_keys), box = i / 8 / (kBN - n_keys);
      *reinterpret_cast<uint4*>(smem + L::kKV + box * kBox + row * 128 + chunk * 16) =
          make_uint4(0u, 0u, 0u, 0u);
    }
    hopper::fence_proxy_async();
  }
  __syncthreads();
  // In one round trip to memory: the block's rows' largest position, the
  // row's new_lens and, in the producer warp's lanes, the first tile's page
  // ids; then the position at new_lens - 1 gives the live pages.
  const int wgi = tid / 128;
  const int p0 = split * a.span;
  const int* bt = static_cast<const int*>(a.block_tables) + static_cast<int64_t>(n) * a.P;
  int first_page = -1;
  if (tid >= 128 * kWG && tid < 128 * kWG + 32 && (tid & 31) < ppt && p0 + (tid & 31) < a.P)
    first_page = bt[p0 + (tid & 31)];
  {
    const int r_lo = tile * kBM, r_hi = min(r_lo + kBM, R);
    for (int c = r_lo / G + tid; c <= (r_hi - 1) / G; c += kThreadsW) atomicMax(&flag[0], qpos[c]);
    if (tid == kThreadsW - 1) flag[2] = static_cast<const int*>(a.new_lens)[n];
  }
  __syncthreads();
  if (tid == 0) {
    const int row_max = qpos[min(max(flag[2] - 1, 0), a.C - 1)];
    const int row_pages = row_max < 0 ? 0 : (row_max + a.bs) / a.bs;
    const int block_pages = flag[0] < 0 ? 0 : (flag[0] + a.bs) / a.bs;
    flag[3] = min(min(row_pages, block_pages), a.P);
  }
  __syncthreads();
  const int n_pages = flag[3];
  const int p1 = min(p0 + a.span, n_pages);
  const int t_lo = p0 * a.bs, t_hi = p1 * a.bs;
  const int n_tiles = t_hi > t_lo ? (t_hi - t_lo + n_keys - 1) / n_keys : 0;

  if (wgi == kWG) {
    // the block starts with 168 registers a thread (384 threads): what this
    // warpgroup gives up is what the consumers take, 128 x 112 = 256 x 56
    asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n");
    const int pw = (tid - 128 * kWG) >> 5, lane = tid & 31;
    if (pw == 0) {
      // the producer: one TMA load a page (K's, then V's), page ids read by
      // the lanes and passed to lane 0
      if (lane == 0) {
        hopper::prefetch_map(&k_map);
        hopper::prefetch_map(&v_map);
      }
      int s = 0, phase = 0;
      for (int kt = 0; kt < n_tiles; ++kt) {
        const int page = p0 + kt * ppt + lane;
        int row = a.S_flat;  // past the pool: the box is zero-filled, nothing read
        if (lane < ppt && page < p1) row = (kt == 0 ? first_page : bt[page]) * a.bs;
        uint64_t* bar = kQuant ? &cfull[s] : &full[s];
        hopper::mbar_wait(kQuant ? &cempty[s] : &empty[s], phase ^ 1);
        unsigned char* dst = smem + (kQuant ? L::kCodes + s * L::kCodeStage : L::kKV + s * L::kStage);
        if (lane == 0)
          hopper::mbar_expect_tx(bar, kQuant ? 2 * n_keys * HD : 2 * kBoxes * n_keys * 128);
        for (int jp = 0; jp < ppt; ++jp) {
          const int rj = __shfl_sync(0xffffffffu, row, jp);
          if (lane == 0) {
            if constexpr (kQuant) {
              hopper::tma_load_3d(dst + jp * a.bs * HD, &k_map, bar, 0, kh, rj);
              hopper::tma_load_3d(dst + kBN * HD + jp * a.bs * HD, &v_map, bar, 0, kh, rj);
            } else {
              for (int c = 0; c < kBoxes; ++c)
                hopper::tma_load_3d(dst + c * kBox + jp * a.bs * 128, &k_map, bar, c * 64, kh, rj);
              for (int c = 0; c < kBoxes; ++c)
                hopper::tma_load_3d(dst + (kBoxes + c) * kBox + jp * a.bs * 128, &v_map, bar,
                                    c * 64, kh, rj);
            }
          }
        }
        if (lane != 0) hopper::mbar_arrive(bar);
        if (++s == kStages) {
          s = 0;
          phase ^= 1;
        }
      }
    } else if constexpr (kQuant) {
      // the converters: a tile's scales, then bf16(code * scale) into the
      // swizzled K/V tile (16-byte chunk c of row r at chunk c ^ (r % 8)),
      // ordered for the async proxy before the tile is marked full
      const int ct = tid - 128 * kWG - 32;
      float* ks_s = reinterpret_cast<float*>(smem + L::kScales);
      float* vs_s = ks_s + kBN;
      const float* k_scale = static_cast<const float*>(a.k_scale);
      const float* v_scale = static_cast<const float*>(a.v_scale);
      constexpr int kChunks = HD / 16;  // 16-code chunks a row
      int s = 0, phase = 0;
      for (int kt = 0; kt < n_tiles; ++kt) {
        const int key0 = t_lo + kt * n_keys;
        bar_sync(6, kConverters);  // the last tile's scales are read
        for (int r = ct; r < n_keys; r += kConverters) {
          const int t = key0 + r;
          float ksc = 0.f, vsc = 0.f;
          if (t < t_hi) {
            const int64_t so = (static_cast<int64_t>(bt[t / a.bs]) * a.bs + t % a.bs) * a.kvH + kh;
            ksc = k_scale[so];
            vsc = v_scale[so];
          }
          ks_s[r] = ksc;
          vs_s[r] = vsc;
        }
        bar_sync(6, kConverters);
        hopper::mbar_wait(&cfull[s], phase);
        hopper::mbar_wait(&empty[s], phase ^ 1);
        const unsigned char* codes = smem + L::kCodes + s * L::kCodeStage;
        unsigned char* st = smem + L::kKV + s * L::kStage;
        for (int idx = ct; idx < 2 * n_keys * kChunks; idx += kConverters) {
          const int which = idx / (n_keys * kChunks), rem = idx % (n_keys * kChunks);
          const int r = rem / kChunks, ch = rem % kChunks;
          const uint4 raw = *reinterpret_cast<const uint4*>(codes + which * kBN * HD + r * HD + ch * 16);
          const float sc = (which ? vs_s : ks_s)[r];
          const KV* cv = reinterpret_cast<const KV*>(&raw);
          uint32_t packed[8];
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const __nv_bfloat162 v2 = __halves2bfloat162(__float2bfloat16(to_float(cv[2 * e]) * sc),
                                                         __float2bfloat16(to_float(cv[2 * e + 1]) * sc));
            packed[e] = *reinterpret_cast<const uint32_t*>(&v2);
          }
          const int col = ch * 16, k8 = (col % 64) / 8;
          unsigned char* rowp = st + (which * kBoxes + col / 64) * kBox + r * 128;
          *reinterpret_cast<uint4*>(rowp + ((k8 ^ (r & 7)) << 4)) =
              make_uint4(packed[0], packed[1], packed[2], packed[3]);
          *reinterpret_cast<uint4*>(rowp + (((k8 + 1) ^ (r & 7)) << 4)) =
              make_uint4(packed[4], packed[5], packed[6], packed[7]);
        }
        hopper::fence_proxy_async();
        hopper::mbar_arrive(&full[s]);
        hopper::mbar_arrive(&cempty[s]);
        if (++s == kStages) {
          s = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // ---- the consumers: 2 x 128 x 224 + 128 x 56 registers, the block's 384 x 168
  asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n");
  const int warp = (tid & 127) >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int rw = tile * kBM + wgi * 64;  // the warpgroup's first (c, g) row
  const int row[2] = {rw + 16 * warp + g, rw + 16 * warp + g + 8};
  int pos[2];
  float slope[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const bool valid = row[i] < R;
    pos[i] = valid ? qpos[row[i] / G] : -1;  // a row past C * G sees nothing and is never stored
    slope[i] = kAlibi && valid ? static_cast<const float*>(a.slopes)[kh * G + row[i] % G] : 0.f;
  }
  // Q: the warpgroup's 64 rows, read as whole 16-byte chunks of rows (all
  // of a thread's loads issued before any is used: one round trip), scaled
  // and rounded in bf16 into its output staging boxes (free until the
  // epilogue; swizzled: 16-byte chunk c of row r at chunk c ^ (r % 8)), then
  // taken as the A fragments by ldmatrix. Loaded a 4-byte pair at a time
  // behind a row check, the same reads took most of a block's time.
  unsigned char* staged = smem + L::kOut + wgi * kBoxes * L::kOutBox;
  {
    const bf16* q = static_cast<const bf16*>(a.q);
    constexpr int kChunksQ = 64 * HD / 8 / 128;  // 16-byte chunks a thread
    uint4 raw[kChunksQ];
#pragma unroll
    for (int u = 0; u < kChunksQ; ++u) {
      const int idx = (tid & 127) + 128 * u, r = idx / (HD / 8), c16 = idx % (HD / 8);
      const int grow = rw + r;
      raw[u] = grow < R ? *reinterpret_cast<const uint4*>(
                              q + ((static_cast<int64_t>(n) * a.C + grow / G) * a.H + kh * G + grow % G) *
                                      HD + c16 * 8)
                        : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < kChunksQ; ++u) {
      const int idx = (tid & 127) + 128 * u, r = idx / (HD / 8), c16 = idx % (HD / 8);
      __nv_bfloat162* x = reinterpret_cast<__nv_bfloat162*>(&raw[u]);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        x[e] = __floats2bfloat162_rn(__bfloat162float(x[e].x) * a.q_scale,
                                     __bfloat162float(x[e].y) * a.q_scale);
      *reinterpret_cast<uint4*>(staged + (c16 / 8) * L::kOutBox + r * 128 + (((c16 % 8) ^ (r & 7)) << 4)) =
          raw[u];
    }
  }
  // the tiles this warpgroup's rows see: up to its largest position
  int mx = max(pos[0], pos[1]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) mx = max(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  if (lane == 0) red[wgi * 4 + warp] = mx;
  bar_sync(1 + wgi, 128);
  // Q's A fragments: ldmatrix lanes 0-15 name rows 0-15 of the warp's 16 at
  // k 0-7 of the k-step, lanes 16-31 the same rows at k 8-15
  uint32_t qf[HD / 16][4];
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const int r = 16 * warp + (lane & 15), chunk = 2 * (kk % 4) + (lane >> 4);
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(qf[kk][0]), "=r"(qf[kk][1]), "=r"(qf[kk][2]), "=r"(qf[kk][3])
                 : "r"(hopper::smem_addr(staged + (kk / 4) * L::kOutBox + r * 128 +
                                         ((chunk ^ (r & 7)) << 4))));
  }
  const int wg_max = max(max(red[wgi * 4], red[wgi * 4 + 1]), max(red[wgi * 4 + 2], red[wgi * 4 + 3]));
  const int my_tiles =
      wg_max < t_lo ? 0 : min(n_tiles, (min(wg_max + 1, t_hi) - t_lo + n_keys - 1) / n_keys);

  float o[HD / 8][4], sc[kBN / 8][4];
  uint32_t p[kBN / 16][4];
#pragma unroll
  for (int nn = 0; nn < HD / 8; ++nn)
#pragma unroll
    for (int c = 0; c < 4; ++c) o[nn][c] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, alpha[2];
  const unsigned kv_addr = hopper::smem_addr(smem + L::kKV);
  int s = 0, phase = 0;
  if (my_tiles > 0) {
    // tile 0's Q K^T alone; then each step issues tile kt's Q K^T and tile
    // kt - 1's P V together, the softmax of kt running while P V is in flight
    hopper::mbar_wait(&full[0], 0);
    hopper::wgmma_fence();
    issue_qk<HD>(sc, qf, kv_addr);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_operand(sc);
    softmax_tile<kAlibi>(sc, m, l, alpha, t_lo, n_keys, t_hi, pos, slope, t);
    pack_p(p, sc);
    int s_prev = 0;
    s = 1 % kStages;
    phase = kStages == 1 ? 1 : 0;
    for (int kt = 1; kt < my_tiles; ++kt) {
      hopper::mbar_wait(&full[s], phase);
      hopper::fence_operand(o);
      hopper::fence_operand(p);
      hopper::wgmma_fence();
      issue_qk<HD>(sc, qf, kv_addr + s * L::kStage);
      hopper::wgmma_commit();
      issue_pv<HD>(o, p, kv_addr + s_prev * L::kStage + kBoxes * kBox);
      hopper::wgmma_commit();
      hopper::wgmma_wait<1>();  // Q K^T has landed; P V may still run
      hopper::fence_operand(sc);
      softmax_tile<kAlibi>(sc, m, l, alpha, t_lo + kt * n_keys, n_keys, t_hi, pos, slope, t);
      hopper::wgmma_wait<0>();
      hopper::fence_operand(o);
      hopper::fence_operand(p);
      if ((tid & 127) == 0) hopper::mbar_arrive(&empty[s_prev]);  // tile kt - 1 is done
#pragma unroll
      for (int nn = 0; nn < HD / 8; ++nn) {
        o[nn][0] *= alpha[0];
        o[nn][1] *= alpha[0];
        o[nn][2] *= alpha[1];
        o[nn][3] *= alpha[1];
      }
      pack_p(p, sc);
      s_prev = s;
      if (++s == kStages) {
        s = 0;
        phase ^= 1;
      }
    }
    hopper::fence_operand(o);
    hopper::fence_operand(p);
    hopper::wgmma_fence();
    issue_pv<HD>(o, p, kv_addr + s_prev * L::kStage + kBoxes * kBox);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_operand(o);
    if ((tid & 127) == 0) hopper::mbar_arrive(&empty[s_prev]);
  }
  // the block's tiles past this warpgroup's: released unread, each once it has landed
  for (int kt = my_tiles; kt < n_tiles; ++kt) {
    hopper::mbar_wait(&full[s], phase);
    if ((tid & 127) == 0) hopper::mbar_arrive(&empty[s]);
    if (++s == kStages) {
      s = 0;
      phase ^= 1;
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }

  bf16* out = static_cast<bf16*>(a.out);
  if (a.splits == 1) {
    // O / l rounded to bf16 into this warpgroup's staging boxes (swizzled:
    // 16-byte chunk c of row r at chunk c ^ (r % 8)), then out as whole
    // 16-byte chunks of the rows
    unsigned char* staged = smem + L::kOut + wgi * kBoxes * L::kOutBox;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float inv = __frcp_rn(l[i] == 0.f ? 1.f : l[i]);
      const int r = 16 * warp + g + 8 * i;
#pragma unroll
      for (int nn = 0; nn < HD / 8; ++nn)
        *reinterpret_cast<__nv_bfloat162*>(staged + (nn / 8) * L::kOutBox + r * 128 +
                                            (((nn % 8) ^ (r & 7)) << 4) + t * 4) =
            __floats2bfloat162_rn(o[nn][2 * i] * inv, o[nn][2 * i + 1] * inv);
    }
    bar_sync(1 + wgi, 128);
    for (int i = tid & 127; i < 64 * HD / 8; i += 128) {
      const int r = i / (HD / 8), nn = i % (HD / 8), grow = rw + r;
      if (grow < R)
        *reinterpret_cast<uint4*>(
            out + ((static_cast<int64_t>(n) * a.C + grow / G) * a.H + kh * G + grow % G) * HD + nn * 8) =
            *reinterpret_cast<const uint4*>(staged + (nn / 8) * L::kOutBox + r * 128 +
                                            (((nn % 8) ^ (r & 7)) << 4));
    }
    return;
  }
  // several splits: this split's partial, then the unit's last block merges
  const int stride = kBM * (HD + 2);
  float* part = a.ws + (static_cast<int64_t>(unit) * a.splits + split) * stride;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (row[i] >= R) continue;
    const int r = wgi * 64 + 16 * warp + g + 8 * i;
#pragma unroll
    for (int nn = 0; nn < HD / 8; ++nn)
      *reinterpret_cast<float2*>(part + r * HD + nn * 8 + 2 * t) = make_float2(o[nn][2 * i], o[nn][2 * i + 1]);
    if (t == 0) {
      part[kBM * HD + r] = m[i];
      part[kBM * HD + kBM + r] = l[i];
    }
  }
  __threadfence();
  bar_sync(5, 128 * kWG);
  if (tid == 0) flag[1] = atomicAdd(a.tickets + unit, 1) == a.splits - 1;
  bar_sync(5, 128 * kWG);
  if (flag[1]) {
    __threadfence();
    merge_splits<bf16, HD>(a.ws + static_cast<int64_t>(unit) * a.splits * stride, a.splits, kBM,
                           tile * kBM, min(kBM, R - tile * kBM), n, kh, a.C, a.H, G, out, tid,
                           128 * kWG);
    if (tid == 0) a.tickets[unit] = 0;
  }
}

// Tensor maps of the layers' pools, cached by (base, rows, kv heads, hd, bs,
// codes): one encode per pool slice, reused by every later call on it. A map
// holds only the address and the shape, so an entry for a freed pool is
// right for any later pool of the same key.
struct MapEntry {
  const void* base;
  long long rows;
  int kvH, hd, bs, codes;
  CUtensorMap map;
};
constexpr int kMapCache = 256;
MapEntry g_maps[kMapCache];
int g_map_count = 0, g_map_next = 0;
std::mutex g_map_mutex;

// The pool [rows, kvH, hd] as (hd, kvH, rows): bf16 boxes {64, 1, bs} under
// the 128-byte swizzle, or one-byte codes in boxes {hd, 1, bs} unswizzled.
bool pool_map(const void* base, long long rows, int kvH, int hd, int bs, int codes,
              CUtensorMap* map) {
  std::lock_guard<std::mutex> lock(g_map_mutex);
  for (int i = 0; i < g_map_count; ++i) {
    const MapEntry& e = g_maps[i];
    if (e.base == base && e.rows == rows && e.kvH == kvH && e.hd == hd && e.bs == bs &&
        e.codes == codes) {
      *map = e.map;
      return true;
    }
  }
  const hopper::EncodeTiled fn = hopper::encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t es = codes ? 1 : 2;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(hd), static_cast<cuuint64_t>(kvH),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[2] = {hd * es, static_cast<cuuint64_t>(kvH) * hd * es};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(codes ? hd : 64), 1, static_cast<cuuint32_t>(bs)};
  const cuuint32_t unit[3] = {1, 1, 1};
  MapEntry e{base, rows, kvH, hd, bs, codes, {}};
  if (fn(&e.map, codes ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
         const_cast<void*>(base), dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
         codes ? CU_TENSOR_MAP_SWIZZLE_NONE : CU_TENSOR_MAP_SWIZZLE_128B,
         CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return false;
  g_maps[g_map_next] = e;
  g_map_next = (g_map_next + 1) % kMapCache;
  if (g_map_count < kMapCache) ++g_map_count;
  *map = e.map;
  return true;
}

template <typename KV, int HD, bool kAlibi>
int launch_alibi(const Args& a) {
  using L = Smem<HD, !std::is_same<KV, bf16>::value>;
  const int tiles = (a.C * (a.H / a.kvH) + kBM - 1) / kBM;
  if (tiles > 65535 || static_cast<int64_t>(a.kvH) * a.splits > 65535) return cudaErrorInvalidValue;
  const int codes = std::is_same<KV, bf16>::value ? 0 : 1;
  CUtensorMap km, vm;
  if (!pool_map(a.k_pool, a.S_flat, a.kvH, HD, a.bs, codes, &km) ||
      !pool_map(a.v_pool, a.S_flat, a.kvH, HD, a.bs, codes, &vm))
    return cudaErrorInvalidValue;
  static bool smem_set[hopper::kMaxDevices];
  const auto kernel = paged_wgmma_kernel<KV, HD, kAlibi>;
  const cudaError_t err = hopper::allow_smem(reinterpret_cast<const void*>(kernel), L::kBytes, smem_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(tiles, a.kvH * a.splits, a.N), kThreadsW, L::kBytes, a.stream>>>(km, vm, a);
  return static_cast<int>(cudaGetLastError());
}

template <typename KV, int HD>
int launch(const Args& a) {
  return a.slopes != nullptr ? launch_alibi<KV, HD, true>(a) : launch_alibi<KV, HD, false>(a);
}

}  // namespace form_w

// ---------------------------------------------------------------- form S launch

template <typename T, typename KV, int HD, int kTileQ, bool kAlibi>
int launch_tile(const Args& a) {
  constexpr size_t kBytes = Smem<HD, kTileQ>::kBytes;
  static bool smem_set[hopper::kMaxDevices];
  const auto kernel = paged_attention_kernel<T, KV, HD, kTileQ, kAlibi>;
  const cudaError_t err =
      hopper::allow_smem(reinterpret_cast<const void*>(kernel), static_cast<int>(kBytes), smem_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int G = a.H / a.kvH;
  const int tiles = (a.C * G + kTileQ - 1) / kTileQ;
  if (tiles > 65535) return cudaErrorInvalidValue;
  const dim3 grid(tiles, a.kvH, a.N);
  kernel<<<grid, kThreads, kBytes, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const KV*>(a.k_pool),
      static_cast<const KV*>(a.v_pool), static_cast<const float*>(a.k_scale),
      static_cast<const float*>(a.v_scale), static_cast<const float*>(a.slopes),
      static_cast<const int*>(a.block_tables),
      static_cast<const int*>(a.q_positions), static_cast<const int*>(a.new_lens),
      static_cast<T*>(a.out), a.C, a.H, a.kvH, a.P, a.bs, a.q_scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename KV, int HD, bool kAlibi>
int launch_simt_alibi(const Args& a) {
  if (a.C * (a.H / a.kvH) <= kTileQSmall) return launch_tile<T, KV, HD, kTileQSmall, kAlibi>(a);
  return launch_tile<T, KV, HD, kTileQLarge, kAlibi>(a);
}

// form codes, shared with ops/paged_attention.py PAGED_FORMS
enum Form { kSimt = 0, kSplit = 1, kWgmma = 2 };

template <typename T, typename KV, int HD>
int launch_form(const Args& a, int form) {
  if (form == kSplit) return form_split::launch<T, KV, HD>(a);
  if (form == kWgmma) {
    if constexpr (std::is_same<T, __nv_bfloat16>::value) {
      if (a.bs % 8 != 0 || a.bs > 128) return cudaErrorInvalidValue;
      return form_w::launch<KV, HD>(a);
    }
    return cudaErrorInvalidValue;
  }
  return a.slopes != nullptr ? launch_simt_alibi<T, KV, HD, true>(a)
                             : launch_simt_alibi<T, KV, HD, false>(a);
}

// kv: 0 = the pool is of q's type, 1 = int8 codes, 2 = e4m3 codes
template <typename T>
int launch_kv(const Args& a, int hd, int kv, int form) {
  if (kv == 0 && hd == 128) return launch_form<T, T, 128>(a, form);
  if (kv == 0 && hd == 64) return launch_form<T, T, 64>(a, form);
  if (kv == 1 && hd == 128) return launch_form<T, int8_t, 128>(a, form);
  if (kv == 1 && hd == 64) return launch_form<T, int8_t, 64>(a, form);
  if (kv == 2 && hd == 128) return launch_form<T, __nv_fp8_e4m3, 128>(a, form);
  if (kv == 2 && hd == 64) return launch_form<T, __nv_fp8_e4m3, 64>(a, form);
  return cudaErrorInvalidValue;
}

int dispatch(const Args& a, int hd, int dtype, int kv, int form) {
  if (a.N <= 0 || a.C <= 0 || a.kvH <= 0 || a.H % a.kvH != 0 || a.P <= 0 || a.bs <= 0 ||
      a.N > 65535 || a.kvH > 65535 || a.S_flat <= 0)
    return cudaErrorInvalidValue;
  if ((kv != 0) != (a.k_scale != nullptr && a.v_scale != nullptr)) return cudaErrorInvalidValue;
  if (form != kSimt && form != kSplit && form != kWgmma) return cudaErrorInvalidValue;
  if (form == kSimt) {
    if (a.splits != 1) return cudaErrorInvalidValue;
  } else if (form == kSplit && a.span > form_split::kMaxSpan) {
    return cudaErrorInvalidValue;
  } else if (a.splits < 1 || a.span < 1 || static_cast<int64_t>(a.splits) * a.span < a.P ||
             a.splits > 65535 ||
             (a.splits > 1 && (a.ws == nullptr || a.tickets == nullptr))) {
    return cudaErrorInvalidValue;
  }
  if (dtype == 1) return launch_kv<__nv_bfloat16>(a, hd, kv, form);
  if (dtype == 0) return launch_kv<float>(a, hd, kv, form);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype codes: 0 = fp32, 1 = bf16; hd must be 64 or 128; new_lens [N] int32
// (0 for a pad row); slopes: ALiBi slopes [H] fp32, or NULL for none. form:
// 0 form S, 1 form "split", 2 form W (bf16, bs % 8 == 0, bs <= 128). splits
// and span: the key split of forms "split" and W, fixed spans of span pages
// (splits x span >= P; form "split": span <= 256); form S takes splits 1.
// With splits > 1,
// ws is an fp32 workspace of N x kvH x
// (row groups | row tiles) x splits x (rows x (hd + 2)) floats and tickets
// an int32 counter per (row, kv head, row group | row tile), all 0, which
// the kernel leaves at 0. S_flat: the pool's rows. Returns
// cudaErrorInvalidValue for what the form does not take, else
// cudaGetLastError() after the launch.
extern "C" int ds_paged_attention(const void* q, const void* k_pool, const void* v_pool,
                                  const void* slopes, const void* block_tables,
                                  const void* q_positions, const void* new_lens, void* out, int N,
                                  int C, int H, int kvH, int hd, int P, int bs, float q_scale,
                                  int dtype, int form, int splits, int span, void* ws,
                                  void* tickets, int S_flat, void* stream) {
  const Args a{q, k_pool, v_pool, nullptr, nullptr, slopes, block_tables, q_positions, new_lens,
               out, N, C, H, kvH, P, bs, q_scale, static_cast<cudaStream_t>(stream),
               splits, span, S_flat, static_cast<float*>(ws), static_cast<int*>(tickets)};
  return dispatch(a, hd, dtype, 0, form);
}

// The quantised pool: k_pool / v_pool [S_flat, kvH, hd] of int8 (kv = 1) or
// e4m3 (kv = 2) codes, k_scale / v_scale [S_flat, kvH] fp32; q and out of
// dtype; the rest as above.
extern "C" int ds_paged_attention_quant(const void* q, const void* k_pool, const void* v_pool,
                                        const void* k_scale, const void* v_scale,
                                        const void* slopes, const void* block_tables,
                                        const void* q_positions, const void* new_lens, void* out,
                                        int N, int C, int H, int kvH, int hd, int P, int bs,
                                        float q_scale, int dtype, int kv, int form, int splits,
                                        int span, void* ws, void* tickets, int S_flat,
                                        void* stream) {
  if (kv != 1 && kv != 2) return cudaErrorInvalidValue;
  const Args a{q, k_pool, v_pool, k_scale, v_scale, slopes, block_tables, q_positions, new_lens,
               out, N, C, H, kvH, P, bs, q_scale, static_cast<cudaStream_t>(stream),
               splits, span, S_flat, static_cast<float*>(ws), static_cast<int*>(tickets)};
  return dispatch(a, hd, dtype, kv, form);
}

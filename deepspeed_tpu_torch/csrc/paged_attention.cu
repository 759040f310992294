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
// full-precision pool never exists anywhere.
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
// tensor ops round them. The slopes of a block's query rows are loaded into
// shared memory once; a template flag keeps the form without ALiBi as it was
// (a run-time branch on slopes == nullptr instead made the quantised decode
// form spill and run ~27 % slower on an H100 80GB HBM3 at 700 W; PERF.md).
//
// What bounds it on an H100: at decode (C = 1) bytes. Every live KV page is
// read once (hd * 2 values * itemsize per token and kv head) for 4 * G * hd
// flops, ~8 flops per byte in bf16 (hd + 4 bytes per token and kv head for
// a quantised pool: about half). A prefill chunk reuses each page for C*G
// query rows and is bound by operations instead; this first version does
// them with fp32 FMAs, not tensor cores.
//
// Design. The TPU kernel walks page chunks along a sequential grid axis and
// carries (m, l, acc) in VMEM scratch from one step to the next. Blocks on
// this card run in no order, so that axis becomes a loop inside the block:
//   grid  = (query tile, kv head, row n); 256 threads per block.
//   tile  = up to TQ (c, g) query rows of the row's GQA group, TQ = 64, or
//           16 where C * G <= 16: for decode that is the G = 4 heads of one
//           kv head (Llama) or the one head of a kv head (G = 1, Bloom's
//           MHA: one live row of the 16); a 512-token prefill chunk is
//           512 * G rows, cut into 8 * G tiles (the TPU kept them all in
//           VMEM).
//   Each block reads its row's block-table entries itself (no scalar
//   prefetch) and streams exactly the live pages, up to the largest position
//   in its tile and never past the row's live length ceil((max_pos+1)/bs)
//   with max_pos the position at new_lens-1. Entries past that are never
//   read. 64 keys at a time (four 16-token pages) are loaded with 16-byte
//   vector loads (8 bf16, 4 fp32 or 16 one-byte codes each; a quantised
//   pool's scales with them), one step ahead into registers, and stored to
//   shared memory as fp32 at the top of the step (dequantised first), then
//     scores  S = Q K^T  (each thread: one key, TQ / 4 query rows),
//     softmax one warp per query row (shuffle max/sum), probabilities back
//             into shared memory, per-row rescale factors alpha,
//     output  acc = alpha * acc + P V (each thread: 4 head dims x TQ / 8
//             rows, kept in registers across the whole key loop).
//   Shared memory at hd 128, TQ 64: Q 32 KB, K 33 KB (rows padded by 4
//   floats so the per-key float4 reads are free of bank conflicts), V 32 KB,
//   S 16 KB, set through cudaFuncAttributeMaxDynamicSharedMemorySize.
// Plain FMA loops, no wgmma/TMA, no split of a long row across blocks:
// right and simple first.

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

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

struct Args {
  const void *q, *k_pool, *v_pool, *k_scale, *v_scale, *slopes, *block_tables, *q_positions,
      *new_lens;
  void* out;
  int N, C, H, kvH, P, bs;
  float q_scale;
  cudaStream_t stream;
};

template <typename T, typename KV, int HD, int kTileQ, bool kAlibi>
int launch_tile(const Args& a) {
  constexpr size_t kBytes = Smem<HD, kTileQ>::kBytes;
  static bool configured = false;  // once per instantiation and process
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        paged_attention_kernel<T, KV, HD, kTileQ, kAlibi>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(kBytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const int G = a.H / a.kvH;
  const int tiles = (a.C * G + kTileQ - 1) / kTileQ;
  const dim3 grid(tiles, a.kvH, a.N);
  paged_attention_kernel<T, KV, HD, kTileQ, kAlibi><<<grid, kThreads, kBytes, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const KV*>(a.k_pool),
      static_cast<const KV*>(a.v_pool), static_cast<const float*>(a.k_scale),
      static_cast<const float*>(a.v_scale), static_cast<const float*>(a.slopes),
      static_cast<const int*>(a.block_tables),
      static_cast<const int*>(a.q_positions), static_cast<const int*>(a.new_lens),
      static_cast<T*>(a.out), a.C, a.H, a.kvH, a.P, a.bs, a.q_scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename KV, int HD, bool kAlibi>
int launch_alibi(const Args& a) {
  if (a.C * (a.H / a.kvH) <= kTileQSmall) return launch_tile<T, KV, HD, kTileQSmall, kAlibi>(a);
  return launch_tile<T, KV, HD, kTileQLarge, kAlibi>(a);
}

template <typename T, typename KV, int HD>
int launch(const Args& a) {
  return a.slopes != nullptr ? launch_alibi<T, KV, HD, true>(a) : launch_alibi<T, KV, HD, false>(a);
}

// kv: 0 = the pool is of q's type, 1 = int8 codes, 2 = e4m3 codes
template <typename T>
int launch_kv(const Args& a, int hd, int kv) {
  if (kv == 0 && hd == 128) return launch<T, T, 128>(a);
  if (kv == 0 && hd == 64) return launch<T, T, 64>(a);
  if (kv == 1 && hd == 128) return launch<T, int8_t, 128>(a);
  if (kv == 1 && hd == 64) return launch<T, int8_t, 64>(a);
  if (kv == 2 && hd == 128) return launch<T, __nv_fp8_e4m3, 128>(a);
  if (kv == 2 && hd == 64) return launch<T, __nv_fp8_e4m3, 64>(a);
  return cudaErrorInvalidValue;
}

int dispatch(const Args& a, int hd, int dtype, int kv) {
  if (a.N <= 0 || a.C <= 0 || a.kvH <= 0 || a.H % a.kvH != 0 || a.P <= 0 || a.bs <= 0 ||
      a.N > 65535 || a.kvH > 65535)
    return cudaErrorInvalidValue;
  if ((kv != 0) != (a.k_scale != nullptr && a.v_scale != nullptr)) return cudaErrorInvalidValue;
  if (dtype == 1) return launch_kv<__nv_bfloat16>(a, hd, kv);
  if (dtype == 0) return launch_kv<float>(a, hd, kv);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype codes: 0 = fp32, 1 = bf16; hd must be 64 or 128; new_lens [N] int32
// (0 for a pad row); slopes: ALiBi slopes [H] fp32, or NULL for none.
// Returns cudaGetLastError() after the launch.
extern "C" int ds_paged_attention(const void* q, const void* k_pool, const void* v_pool,
                                  const void* slopes, const void* block_tables,
                                  const void* q_positions, const void* new_lens, void* out, int N,
                                  int C, int H, int kvH, int hd, int P, int bs, float q_scale,
                                  int dtype, void* stream) {
  const Args a{q, k_pool, v_pool, nullptr, nullptr, slopes, block_tables, q_positions, new_lens,
               out, N, C, H, kvH, P, bs, q_scale, static_cast<cudaStream_t>(stream)};
  return dispatch(a, hd, dtype, 0);
}

// The quantised pool: k_pool / v_pool [S_flat, kvH, hd] of int8 (kv = 1) or
// e4m3 (kv = 2) codes, k_scale / v_scale [S_flat, kvH] fp32; q and out of
// dtype; slopes as above. Returns cudaGetLastError() after the launch.
extern "C" int ds_paged_attention_quant(const void* q, const void* k_pool, const void* v_pool,
                                        const void* k_scale, const void* v_scale,
                                        const void* slopes, const void* block_tables,
                                        const void* q_positions, const void* new_lens, void* out,
                                        int N, int C, int H, int kvH, int hd, int P, int bs,
                                        float q_scale, int dtype, int kv, void* stream) {
  if (kv != 1 && kv != 2) return cudaErrorInvalidValue;
  const Args a{q, k_pool, v_pool, k_scale, v_scale, slopes, block_tables, q_positions, new_lens,
               out, N, C, H, kvH, P, bs, q_scale, static_cast<cudaStream_t>(stream)};
  return dispatch(a, hd, dtype, kv);
}

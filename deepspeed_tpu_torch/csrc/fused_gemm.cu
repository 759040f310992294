// The fused GEMM-collective hop kernels, written by hand for Hopper (sm_90a).
//
// Replaces: deepspeed_tpu/collectives/fused_gemm.py
//   _ag_hop_kernel (:198) -> form T hop_tf32_kernel<kAccum | kBlock> and
//                            form S ag_hop_kernel<kTransB, kCode> (ds_ag_hop)
//   _rs_hop_kernel (:257) -> form T hop_tf32_kernel<kRs> and
//                            form S rs_hop_kernel<kCode>           (ds_rs_hop)
//
// One launch is one ring hop of one rank, on the rank's stream. It computes
// the hop's product in its own body and moves the hop's wire in the same
// launch. The wire stays in the sending rank's memory and this (receiving)
// launch pulls it: on two cards a peer read over NVLink, on one card an HBM
// read. Ordering between ranks is CUDA events the host records
// (collectives/fused_gemm.py): the wire read here was written by the
// upstream rank's previous launch, so no kernel waits on another launch.
//
// Row 14 (all_gather_matmul) receives the next shard: the upstream's exact
// fp32 shard copied, or its codes decoded (code * scale) into `recv` and,
// before the last hop, re-encoded into this rank's own wire slot (the TPU
// kernel sends the decoded shard it holds). It contracts the held shard
// [Ks, N] (fp32, as it is):
//   accumulate: out[M, N] = out + x[:, col : col + Ks] @ held
//   out_block:  out[:, col : col + Ks] = g[M, N] @ held^T
// The two halves touch different buffers, so they need no order.
//
// Row 15 (matmul_reduce_scatter): part[Mb, N] = rprev + x[row0 : row0 + Mb]
// @ w, rprev the upstream's wire decoded (0 without one). An exact wire:
// `part` is this rank's own fp32 slot. A block wire: `part` is a staging
// buffer, and its codes go into the own slot. The encode of a block needs
// every tile that wrote into it, so the tiles are split into groups that
// hold whole blocks: where qb divides N (blocks lie within rows), one tile
// row by lcm(qb, 128) columns, a single tile when qb divides 128; else a band
// of whole tile rows (band_rows, a multiple of both 128 and the rows a block
// spans). A group of more than one tile counts its arrivals in an atomic
// counter (zeroed by the wrapper for each launch) and its last tile encodes
// the group: the threadfence-and-count pattern, no tile waits. Both forms
// use 128 x 128 output tiles (collectives/fused_gemm.py:_TILE).
//
// The block wire is hop_wire.cuh's: blocks of qb contiguous elements of the
// row-major shard or partial (qb = gcd(B, block_size), B one TPU chunk), IEEE
// divisions, rint, __fmul_rn decodes and __fadd_rn sums, so codes and scales
// equal the plain version's (and JAX's block math) bit for bit.
//
// Two forms of the product, picked by the wrapper (fused_form) from shapes,
// strides and alignment alone:
//
// - Form T ("wgmma"): fp32 kept to fp32's accuracy on the tensor cores by
//   three TF32 passes. What bounds it on an H100: operations, 3 x 2 M N K at
//   495 TFLOP/s of TF32 (row 14 at phase 6c's 34.4 GFLOP: 0.208 ms, against
//   0.513 ms for fp32 on the CUDA cores). Each operand element a is split
//   into big = cvt.rna.tf32(a) and small = cvt.rna.tf32(a - big) (where a is
//   not finite, small carries it and big is +-1: split_tf32); the sum of
//   small*big + big*small, then big*big, into one
//   fp32 accumulator keeps ~22 bits of every product (the dropped small*small
//   is 2^-22 of it), against 11 for one pass. The tensor cores' fp32
//   accumulation truncates, so each stage's products are summed in a wgmma
//   accumulator from zero and added into the tile's sum in registers with
//   round-to-nearest adds. Integer-valued payloads stay exact (small = 0,
//   sums below 2^24).
//   TF32 wgmma reads only K-major operands from shared memory. The weight
//   (held, w) is N-major in two of the three products, so the product is
//   computed transposed, out^T = W^T X^T: the weight is the register operand
//   A, whose fragments each consumer thread loads from the raw TMA tile in
//   whatever order it likes (no transpose pass, no shared-memory copy) and
//   splits in registers; the activation (x or g, always K-major) is the
//   shared-memory operand B, split in place (big over the raw tile, small
//   beside it) by a converter warpgroup that runs ahead on the ring, so the
//   split overlaps the tensor cores' work and the two consumer warpgroups
//   never wait for each other. An output tile is 128
//   weight columns (two consumer warpgroups of 64, wgmma M) by 128
//   activation rows (wgmma N), K taken 32 (128 bytes, the swizzle's row) a
//   stage through a 4-stage ring that one producer thread keeps full with
//   TMA (the activation as one 128 x 32 box, the weight as four 32 x 32
//   boxes, or one 128 x 32 box where it is K-major: out_block's held).
//   Maps are over whole tensors: x from column 0 to col + Ks (k past the
//   shard zero-filled), x's rows to row0 + Mb. A box whose start was off 16
//   bytes never completed on an H100 (the launch hung until mbar_wait's
//   trap), so the gather's boxes start at col rounded down to 4 floats: the weight's k origin moves back as far (rows before 0 are
//   zero-filled) and the converter zeroes the activation's columns before
//   col, so the neighbouring shard's values never reach the product. The
//   grid is persistent, one block an SM walking tiles m-fastest; the producer
//   runs on into the next tile's stages while the consumers store the last
//   one (their loads issued together, the out tile prefetched into L2 at the
//   tile's start). The helper warpgroup's other three warps take row 14's
//   receive, or row 15's encode of every tile but a block's last (the
//   consumers encode that one themselves, nothing being left to overlap).
//   The weight's fragment order is chosen so that the loads meet no bank
//   conflict and the epilogue stores whole 32-byte sectors (float2 pairs of
//   adjacent columns where the weight is N-major). What holds it back:
//   shared-memory traffic (the wgmma operand reads alone are half of its
//   bandwidth at the TF32 rate, the split and the TMA writes most of the
//   rest), each warpgroup's wait for its stage before the round-to-nearest
//   sum, and, at row 14's K = 512, each tile's epilogue.
// - Form S ("simt"): fp32 FMA on the CUDA cores (not TF32), 128 x 128 output
//   tiles of 256 threads, 8 x 8 outputs a thread, K in steps of 8 through two
//   shared-memory buffers (the next step's global loads in flight while this
//   one computes), row 14's receive on leading CTAs. What bounds it: 2 M N K
//   at 67 TFLOP/s. It takes what TMA cannot describe: a row stride that is
//   not a multiple of 4 floats, a base off 16 bytes, K == 0.

#include <mutex>

#include "hop_wire.cuh"
#include "hopper.cuh"

namespace {

using hop_wire::WireCode;

constexpr int kBM = 128;  // collectives/fused_gemm.py:_TILE
constexpr int kBN = 128;
constexpr int kBK = 8;
constexpr int kTM = 8;
constexpr int kTN = 8;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

struct __align__(16) Smem {
  float a[2][kBK][kBM];  // A tile, k-major
  float b[2][kBK][kBN];  // B tile, k-major
};

// One thread's share of the next K step: 4 values of A and 4 of B.
template <bool kTransB>
__device__ __forceinline__ void load_step(const float* A, int64_t lda, const float* B, int64_t ldb,
                                          int M, int N, int K, int m0, int n0, int k0, bool vec_a,
                                          bool vec_b, float ra[4], float rb[4]) {
  const int t = threadIdx.x;
  {  // A[row][k]: rows m0 + t / 2, k0 + (t % 2) * 4 + 0..3
    const int row = m0 + (t >> 1), kk = k0 + (t & 1) * 4;
    const float* src = A + static_cast<int64_t>(row) * lda + kk;
    if (row < M && vec_a && kk + 3 < K) {
      const float4 v = *reinterpret_cast<const float4*>(src);
      ra[0] = v.x, ra[1] = v.y, ra[2] = v.z, ra[3] = v.w;
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) ra[i] = (row < M && kk + i < K) ? src[i] : 0.f;
    }
  }
  if (!kTransB) {  // B[k][n], n contiguous: k0 + t / 32, n0 + (t % 32) * 4 + 0..3
    const int kr = k0 + (t >> 5), nn = n0 + (t & 31) * 4;
    const float* src = B + static_cast<int64_t>(kr) * ldb + nn;
    if (kr < K && vec_b && nn + 3 < N) {
      const float4 v = *reinterpret_cast<const float4*>(src);
      rb[0] = v.x, rb[1] = v.y, rb[2] = v.z, rb[3] = v.w;
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) rb[i] = (kr < K && nn + i < N) ? src[i] : 0.f;
    }
  } else {  // element (k, n) at B[n][k], k contiguous: n0 + t / 2, k0 + (t % 2) * 4 + 0..3
    const int nr = n0 + (t >> 1), kk = k0 + (t & 1) * 4;
    const float* src = B + static_cast<int64_t>(nr) * ldb + kk;
    if (nr < N && vec_b && kk + 3 < K) {
      const float4 v = *reinterpret_cast<const float4*>(src);
      rb[0] = v.x, rb[1] = v.y, rb[2] = v.z, rb[3] = v.w;
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) rb[i] = (nr < N && kk + i < K) ? src[i] : 0.f;
    }
  }
}

template <bool kTransB>
__device__ __forceinline__ void store_step(Smem& s, int buf, const float ra[4], const float rb[4]) {
  const int t = threadIdx.x;
#pragma unroll
  for (int i = 0; i < 4; ++i) s.a[buf][(t & 1) * 4 + i][t >> 1] = ra[i];
  if (!kTransB) {
#pragma unroll
    for (int i = 0; i < 4; ++i) s.b[buf][t >> 5][(t & 31) * 4 + i] = rb[i];
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) s.b[buf][(t & 1) * 4 + i][t >> 1] = rb[i];
  }
}

// acc[i][j] = sum_k A[m0 + ty*8 + i][k] * B(k, n0 + tx*8 + j), fp32 FMAs in
// k order; B(k, n) = B[k][n], or B[n][k] with kTransB.
template <bool kTransB>
__device__ __forceinline__ void gemm_tile(Smem& s, const float* A, int64_t lda, const float* B,
                                          int64_t ldb, int M, int N, int K, int m0, int n0,
                                          bool vec_a, bool vec_b, float acc[kTM][kTN]) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;
  const int steps = (K + kBK - 1) / kBK;
  if (steps == 0) return;
  float ra[4], rb[4];
  load_step<kTransB>(A, lda, B, ldb, M, N, K, m0, n0, 0, vec_a, vec_b, ra, rb);
  store_step<kTransB>(s, 0, ra, rb);
  __syncthreads();
  for (int st = 0; st < steps; ++st) {
    const int buf = st & 1;
    const bool more = st + 1 < steps;
    if (more) load_step<kTransB>(A, lda, B, ldb, M, N, K, m0, n0, (st + 1) * kBK, vec_a, vec_b, ra, rb);
#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&s.a[buf][k][ty * kTM]);
      const float4 a1 = *reinterpret_cast<const float4*>(&s.a[buf][k][ty * kTM + 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&s.b[buf][k][tx * kTN]);
      const float4 b1 = *reinterpret_cast<const float4*>(&s.b[buf][k][tx * kTN + 4]);
      const float a[kTM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[kTN] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (more) store_step<kTransB>(s, buf ^ 1, ra, rb);
    __syncthreads();
  }
}

struct AgArgs {
  const float* A;  // x + col (accumulate) or g (out_block)
  int64_t lda;
  const float* B;  // held [Ks, N]
  int64_t ldb;
  float* C;  // out (accumulate) or out + col (out_block)
  int64_t ldc;
  int M, out_cols, K;  // the product's shape: [M, out_cols] over K
  int vec_a, vec_b;
  int wire_ctas;
  int64_t numel;  // Ks * N
  const void* up_w;  // upstream wire: fp32 shard, or codes
  const float* up_s;  // its scales (block wires)
  float* recv;
  void* own_q;  // own wire slot (block wires before the last hop) or null
  float* own_s;
  int qb;
};

// The receive, shared out over `nw` warps of the launch (this is warp `wid`).
template <int kCode>
__device__ void receive_codes(const AgArgs& a, int64_t wid, int64_t nw) {
  using W = WireCode<kCode>;
  const int lane = threadIdx.x & 31;
  const int64_t nblocks = a.numel / a.qb;
  for (int64_t blk = wid; blk < nblocks; blk += nw) {
    const int64_t base = blk * a.qb;
    const float s = a.up_s[blk];
    float amax = 0.f;
    for (int e = lane; e < a.qb; e += 32) {
      const float v = __fmul_rn(W::decode(a.up_w, base + e), s);
      a.recv[base + e] = v;
      amax = fmaxf(amax, fabsf(v));
    }
    if (a.own_q == nullptr) continue;
    amax = hop_wire::warp_max(amax);
    const float scale = hop_wire::block_scale<kCode>(amax);
    if (lane == 0) a.own_s[blk] = scale;
    for (int e = lane; e < a.qb; e += 32) W::encode(a.own_q, base + e, a.recv[base + e] / scale);
  }
}

template <int kCode>
__device__ void receive_shard(const AgArgs& a, int64_t wid, int64_t nw) {
  if constexpr (kCode == 0) {  // the exact fp32 shard, four 16-byte loads in flight a lane
    const float* src = static_cast<const float*>(a.up_w);
    const int lane = threadIdx.x & 31;
    const bool vec = ((reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(a.recv)) & 15) == 0;
    const int64_t body = vec ? a.numel / 4 : 0;
    const float4* s4 = reinterpret_cast<const float4*>(src);
    float4* d4 = reinterpret_cast<float4*>(a.recv);
    const int64_t step = nw * 32;
    int64_t i = wid * 32 + lane;
    for (; i + 3 * step < body; i += 4 * step) {
      float4 v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) v[u] = s4[i + u * step];
#pragma unroll
      for (int u = 0; u < 4; ++u) d4[i + u * step] = v[u];
    }
    for (; i < body; i += step) d4[i] = s4[i];
    for (int64_t j = body * 4 + wid * 32 + lane; j < a.numel; j += step) a.recv[j] = src[j];
  } else {
    receive_codes<kCode>(a, wid, nw);
  }
}

template <bool kTransB, int kCode>
__global__ void __launch_bounds__(kThreads) ag_hop_kernel(AgArgs a) {
  __shared__ Smem smem;
  if (static_cast<int>(blockIdx.x) < a.wire_ctas) {
    receive_shard<kCode>(a, static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5),
                         static_cast<int64_t>(a.wire_ctas) * kWarps);
    return;
  }
  const int tile = blockIdx.x - a.wire_ctas;
  const int tiles_n = (a.out_cols + kBN - 1) / kBN;
  const int m0 = (tile / tiles_n) * kBM, n0 = (tile % tiles_n) * kBN;
  float acc[kTM][kTN];
  gemm_tile<kTransB>(smem, a.A, a.lda, a.B, a.ldb, a.M, a.out_cols, a.K, m0, n0, a.vec_a, a.vec_b,
                     acc);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int m = m0 + ty * kTM + i;
    if (m >= a.M) break;
    float* row = a.C + static_cast<int64_t>(m) * a.ldc;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int n = n0 + tx * kTN + j;
      if (n < a.out_cols) row[n] = kTransB ? acc[i][j] : __fadd_rn(row[n], acc[i][j]);
    }
  }
}

struct RsArgs {
  const float* A;  // x rows row0 .. row0 + Mb
  const float* B;  // w [K, N]
  int Mb, N, K;
  int vec_a, vec_b;
  const void* up_w;  // upstream wire: fp32 partial, or codes; null at the first hop
  const float* up_s;
  float* part;  // [Mb, N]
  void* own_q;  // own wire slot (block wires) or null
  float* own_s;
  int* counters;  // one a group
  int band_rows;  // the rows of a group
  int group_tiles;  // the tile columns of a group
  int qb;
  int narrow;  // Mb * N < 2^32: element and block indices divide in 32 bits
};

// a / b for a >= 0, b > 0; kNarrow: both below 2^32, a 32-bit division. A
// 64-bit division is a call, and a call in a loop makes each of the loop's
// loads wait out its latency before the next is issued, so the choice is
// made once per launch (RsArgs::narrow), outside the loops.
template <bool kNarrow>
__device__ __forceinline__ int64_t quot(int64_t a, int64_t b) {
  if constexpr (kNarrow) return static_cast<uint32_t>(a) / static_cast<uint32_t>(b);
  else return a / b;
}

// The group of tiles (holding whole blocks) that the tile at (m0, n0) belongs to.
struct Group {
  int r0, r1, c0, c1, tiles, index;
};

__device__ __forceinline__ Group group_of(const RsArgs& a, int m0, int n0) {
  Group g;
  const int band = m0 / a.band_rows, col = n0 / (a.group_tiles * kBN);
  g.r0 = band * a.band_rows;
  g.r1 = min(g.r0 + a.band_rows, a.Mb);
  g.c0 = col * a.group_tiles * kBN;
  g.c1 = min(g.c0 + a.group_tiles * kBN, a.N);
  g.tiles = ((g.r1 - g.r0 + kBM - 1) / kBM) * ((g.c1 - g.c0 + kBN - 1) / kBN);
  g.index = band * ((a.N + a.group_tiles * kBN - 1) / (a.group_tiles * kBN)) + col;
  return g;
}

// After a tile's part is written and fenced: the tiles of its group count
// their arrival (a one-tile group needs no count); true (the same in every
// thread) where this tile is the group's last. The 256 threads 0..255 of the
// block take part; kNamed: they meet at named barrier 2 (form T, whose other
// warps are busy elsewhere), else at __syncthreads.
template <bool kNamed>
__device__ bool group_ready(const RsArgs& a, int m0, int n0) {
  __shared__ int last;
  const auto sync = [] {
    if constexpr (kNamed) hopper::bar_sync(2, 256);
    else __syncthreads();
  };
  const Group g = group_of(a, m0, n0);
  sync();  // the tile's own writes, seen by the whole CTA
  if (g.tiles == 1) return true;
  if (threadIdx.x == 0) last = atomicAdd(&a.counters[g.index], 1) == g.tiles - 1;
  sync();
  if (!last) return false;
  __threadfence();
  return true;
}

// The group's blocks into the own wire slot, shared out over `nw` warps
// (this is warp `w`); part is read through L2 (other blocks wrote it).
template <int kCode, bool kNarrow>
__device__ void encode_blocks(const RsArgs& a, int m0, int n0, int w, int nw) {
  using W = WireCode<kCode>;
  const Group g = group_of(a, m0, n0);
  const int lane = threadIdx.x & 31;
  // full rows: one flat run of whole blocks; else whole blocks in each row
  const bool full = g.c0 == 0 && g.c1 == a.N;
  const int64_t per_row = (g.c1 - g.c0) / a.qb;
  const int64_t nblk = full ? quot<kNarrow>(static_cast<int64_t>(g.r1 - g.r0) * a.N, a.qb)
                            : static_cast<int64_t>(g.r1 - g.r0) * per_row;
  const auto base_of = [&](int64_t j) {
    if (full) return static_cast<int64_t>(g.r0) * a.N + j * a.qb;
    const int64_t row = quot<kNarrow>(j, per_row);
    return (g.r0 + row) * a.N + g.c0 + (j - row * per_row) * a.qb;
  };
  int64_t j = w;
  if (a.qb <= 64) {  // a lane's (at most) two values of four blocks in flight at once
    for (; j < nblk; j += 4 * nw) {
      float v[4][2];
      int64_t base[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int64_t jj = j + u * nw;
        base[u] = jj < nblk ? base_of(jj) : 0;
#pragma unroll
        for (int i = 0; i < 2; ++i)
          v[u][i] = jj < nblk && lane + 32 * i < a.qb ? __ldcg(a.part + base[u] + lane + 32 * i) : 0.f;
      }
      // the four blocks' reductions interleaved, no branch between them
      float amax[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) amax[u] = fmaxf(fabsf(v[u][0]), fabsf(v[u][1]));
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
#pragma unroll
        for (int u = 0; u < 4; ++u) amax[u] = fmaxf(amax[u], __shfl_xor_sync(0xffffffffu, amax[u], o));
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const bool live = j + u * nw < nblk;
        const float scale = hop_wire::block_scale<kCode>(amax[u]);
        if (live && lane == 0) a.own_s[quot<kNarrow>(base[u], a.qb)] = scale;
#pragma unroll
        for (int i = 0; i < 2; ++i)
          if (live && lane + 32 * i < a.qb) W::encode(a.own_q, base[u] + lane + 32 * i, v[u][i] / scale);
      }
    }
    return;
  }
  for (; j < nblk; j += nw) {
    const int64_t base = base_of(j);
    float amax = 0.f;
    for (int e = lane; e < a.qb; e += 32) amax = fmaxf(amax, fabsf(__ldcg(a.part + base + e)));
    amax = hop_wire::warp_max(amax);
    const float scale = hop_wire::block_scale<kCode>(amax);
    if (lane == 0) a.own_s[quot<kNarrow>(base, a.qb)] = scale;
    for (int e = lane; e < a.qb; e += 32) W::encode(a.own_q, base + e, __ldcg(a.part + base + e) / scale);
  }
}

// encode_blocks with the wire's code and the launch's index width.
__device__ __forceinline__ void encode_group(const RsArgs& a, int code, int m0, int n0, int w,
                                             int nw) {
  if (code == 1) {
    if (a.narrow) encode_blocks<1, true>(a, m0, n0, w, nw);
    else encode_blocks<1, false>(a, m0, n0, w, nw);
  } else {
    if (a.narrow) encode_blocks<2, true>(a, m0, n0, w, nw);
    else encode_blocks<2, false>(a, m0, n0, w, nw);
  }
}

template <int kCode>
__global__ void __launch_bounds__(kThreads) rs_hop_kernel(RsArgs a) {
  __shared__ Smem smem;
  const int tiles_n = (a.N + kBN - 1) / kBN;
  const int m0 = (blockIdx.x / tiles_n) * kBM, n0 = (blockIdx.x % tiles_n) * kBN;
  float acc[kTM][kTN];
  gemm_tile<false>(smem, a.A, a.K, a.B, a.N, a.Mb, a.N, a.K, m0, n0, a.vec_a, a.vec_b, acc);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int m = m0 + ty * kTM + i;
    if (m >= a.Mb) break;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int n = n0 + tx * kTN + j;
      if (n >= a.N) continue;
      const int64_t e = static_cast<int64_t>(m) * a.N + n;
      float rprev = 0.f;
      if (a.up_w != nullptr) {
        if constexpr (kCode == 0) {
          rprev = static_cast<const float*>(a.up_w)[e];
        } else {
          rprev = __fmul_rn(WireCode<kCode>::decode(a.up_w, e), a.up_s[e / a.qb]);
        }
      }
      a.part[e] = __fadd_rn(rprev, acc[i][j]);
    }
  }
  if constexpr (kCode != 0) {
    if (a.own_q != nullptr) {
      __threadfence();
      if (group_ready<false>(a, m0, n0)) encode_group(a, kCode, m0, n0, threadIdx.x >> 5, kWarps);
    }
  }
}

// ---------------------------------------------------------------- form T

constexpr int kOpAccum = 0, kOpBlock = 1, kOpRs = 2;  // row 14 accumulate, out_block; row 15
constexpr int TN = 128;  // weight columns of an output tile (wgmma M: two warpgroups of 64)
constexpr int TM = 128;  // activation rows of an output tile (wgmma N)
constexpr int TK = 32;   // k a stage: 128 bytes of fp32, one swizzled row
constexpr int kTStages = 4;
constexpr int kTThreads = 512;  // consumer warpgroups 0 and 1, the converter's, the helper's
constexpr int kRecvWarps = 3;   // the helper warpgroup's warps 1-3: row 14's receive or
                                // row 15's encode
constexpr int kTile = TM * TK * 4;                 // 16 KB: one operand tile of a stage
constexpr int kTStage = 3 * kTile;                 // activation big (in place), its small, the weight
// the ring, its full / conv / empty barriers, the encode's two message
// slots (barriers and ints) and the 1024-byte alignment of the swizzled tiles
constexpr int kTSmem = kTStages * kTStage + 3 * kTStages * 8 + 64 + 1024;
static_assert(TM == kBM && TN == kBN, "row 15's encode groups assume one tile shape");

struct TArgs {
  int Mo, No, K;     // the output's rows (activation side), columns (weight side), contraction
  int act_row0, act_col0;  // the activation box's origin in its map (row 15: row0; row 14:
                           // col rounded down to 4 floats, TMA's 16-byte boxes)
  int act_skip;            // col - act_col0: the first block's leading columns, zeroed; the
                           // weight's k origin moves back as many rows (zero-filled)
  float* C;          // out, out + col (out_block) or part
  int64_t ldc;
  int code;          // the wire: 0 fp32, 1 int8, 2 e4m3
  AgArgs ag;         // row 14's receive (numel, up_w, up_s, recv, own_q, own_s, qb)
  RsArgs rs;         // row 15's rprev and encode
};

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// a = big + small to ~2^-22 of a, both TF32. Where a is not finite (an inf
// or NaN operand), small carries it and big is +-1 (a's sign): a product
// a * b is taken as small_a * big_b + big_a * small_b + big_a * big_b, so
// the non-finite value meets the other operand's big (+-1 where that too is
// not finite), never a small part that is 0 where a value is exact in TF32.
// Each term is then what fp32 gives: +-inf, NaN for inf * 0 and NaN inputs,
// and a finite value beside them (inf * inf appears twice, with one sign).
// small = cvt(a - big) carries it (inf - 1 is inf); the test is on a, not on
// cvt(a), so that it runs beside the cvt (tools/fused_gemm_ab.py timed the
// choices). A finite a that rounds to inf (|a| >= 2^128 (1 - 2^-12)) gives
// big inf and small -inf, so NaN where fp32 has its own product.
__device__ __forceinline__ void split_tf32(float a, uint32_t& big, uint32_t& small) {
  const uint32_t hi = to_tf32(a);
  big = isfinite(a) ? hi : __float_as_uint(copysignf(1.f, a));
  small = to_tf32(__fsub_rn(a, __uint_as_float(big)));
}

// d[64 x 128] (+)= A[64 x 8] * B[8 x 128] in TF32, A from registers (each
// warp's 16 rows in the m16n8k8 tf32 A-fragment layout: rows lane/4 and +8,
// k lane%4 and +4), B from shared memory, K-major; scale_d 0 drops d's old value.
__device__ __forceinline__ void wgmma_tf32_m64n128k8(float (&d)[16][4], const uint32_t* a,
                                                     uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// The weight column of A row p (and p + 8 at the next column) within a
// warp's 16 columns of an N-major tile: a warp takes 16 of a 32-column box
// (h = 0: columns 0-7 and 16-23, h = 1: 8-15 and 24-31), so that a float2
// of each lane (k = lane % 4, p = lane / 4) meets no bank conflict under the
// 128-byte swizzle and the epilogue's float2 pairs fill 32-byte sectors.
__device__ __forceinline__ int nmajor_col(int h, int p) {
  return 8 * h + ((p & 1) << 1) + ((p & 2) << 3) + ((p & 4) ? 4 : 0);
}

// One stage of the converter warpgroup: the activation tile split in
// place (big over the raw values, small beside them), the columns before
// the gather's col (the first block's `skip`) zeroed first.
__device__ __forceinline__ void tf32_convert(unsigned char* st, int skip) {
  const int t = threadIdx.x & 127;
  float4* big = reinterpret_cast<float4*>(st);
  float4* small = reinterpret_cast<float4*>(st + kTile);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int f = t + 128 * i;  // row f / 8, 16-byte chunk (f % 8) ^ (row % 8)
    float4 v = big[f];
    if (skip > 0 && ((f & 7) ^ ((f >> 3) & 7)) == 0) {
      v.x = 0.f;
      if (skip > 1) v.y = 0.f;
      if (skip > 2) v.z = 0.f;
    }
    uint32_t b[4], sm[4];
    split_tf32(v.x, b[0], sm[0]);
    split_tf32(v.y, b[1], sm[1]);
    split_tf32(v.z, b[2], sm[2]);
    split_tf32(v.w, b[3], sm[3]);
    big[f] = make_float4(__uint_as_float(b[0]), __uint_as_float(b[1]), __uint_as_float(b[2]),
                         __uint_as_float(b[3]));
    small[f] = make_float4(__uint_as_float(sm[0]), __uint_as_float(sm[1]), __uint_as_float(sm[2]),
                           __uint_as_float(sm[3]));
  }
}

// One stage of a consumer warpgroup: once the stage's tiles have landed and
// the activation is split, load and split its A fragments from the weight
// tile, issue the 4 k-steps x 3 passes into `acc` from zero, wait for them,
// release the stage and add `acc` into the tile's sum with round-to-nearest
// adds. The tensor cores' fp32 accumulation truncates: with one accumulator
// over all of K the error grew linearly with K and passed fused_gemm_close's
// bound at long K (on an H100; tools/fused_gemm_accuracy.py sweeps K), so a
// wgmma accumulator takes one stage's 96 products at most. The other
// consumer warpgroup's wgmmas keep the tensor cores busy while this one
// waits, adds and loads.
template <int kOp>
__device__ __forceinline__ void tf32_stage(unsigned char* smem, uint64_t* full, uint64_t* conv,
                                           uint64_t* empty, int& s, int& phase,
                                           uint32_t (&frag)[4][8], float (&acc)[16][4],
                                           float (&sum)[16][4], int wg) {
  const int t = threadIdx.x & 127, warp = t >> 5, lane = t & 31;
  hopper::mbar_wait(&full[s], phase);  // the weight tile, read here
  unsigned char* st = smem + s * kTStage;
  {  // A fragments: frag[kk][0..3] big, [4..7] small of rows p, p + 8 and k, k + 4
    const unsigned char* wt = st + 2 * kTile;
    const int kq = lane & 3, p = lane >> 2;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      float v[4];
      if constexpr (kOp == kOpBlock) {  // K-major [128 n][32 k]: rows 64 wg + 16 warp + p (+ 8)
        const int n = 64 * wg + 16 * warp + p;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = n + (i & 1) * 8, k = 8 * kk + kq + (i >> 1) * 4;
          v[i] = *reinterpret_cast<const float*>(wt + r * 128 + (((k >> 2) ^ (r & 7)) << 4) +
                                                  (k & 3) * 4);
        }
      } else {  // N-major: boxes of [32 k][32 n]; rows p and p + 8 are columns n and n + 1
        const unsigned char* box = wt + (2 * wg + (warp >> 1)) * 4096;
        const int n = nmajor_col(warp & 1, p);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int k = 8 * kk + kq + 4 * i;
          const float2 pr = *reinterpret_cast<const float2*>(
              box + k * 128 + (((n >> 2) ^ (k & 7)) << 4) + (n & 3) * 4);
          v[2 * i] = pr.x;
          v[2 * i + 1] = pr.y;
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) split_tf32(v[i], frag[kk][i], frag[kk][4 + i]);
    }
  }
  hopper::mbar_wait(&conv[s], phase);  // the activation, split by the converter warpgroup
  hopper::fence_operand(acc);
  hopper::fence_operand(frag);
  hopper::wgmma_fence();
  const unsigned big = hopper::smem_addr(st), small = big + kTile;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    // B: K-major, 8-row groups 1024 B apart, k advances 32 B (8 fp32) in the swizzled row
    const uint64_t db = hopper::wgmma_desc(big + kk * 32, 16, 1024);
    const uint64_t ds = hopper::wgmma_desc(small + kk * 32, 16, 1024);
    wgmma_tf32_m64n128k8(acc, &frag[kk][4], db, kk == 0 ? 0 : 1);  // small * big
    wgmma_tf32_m64n128k8(acc, &frag[kk][0], ds, 1);                 // big * small
    wgmma_tf32_m64n128k8(acc, &frag[kk][0], db, 1);                 // big * big
  }
  hopper::wgmma_commit();
  hopper::wgmma_wait<0>();
  hopper::fence_operand(acc);
  hopper::fence_operand(frag);
  if (t == 0) hopper::mbar_arrive(&empty[s]);
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) sum[j][e] = __fadd_rn(sum[j][e], acc[j][e]);
  if (++s == kTStages) {
    s = 0;
    phase ^= 1;
  }
}


// The tile's outputs from the accumulator: element (j, e) of a warp is
// weight column row(e) and activation row m0 + 8 j + 2 (lane % 4) + (e & 1).
// kCode: row 15's upstream wire (0 fp32, 1 int8, 2 e4m3), a template
// argument so that each wire's epilogue keeps few registers live.
template <int kOp, int kCode, bool kNarrow = true>
__device__ __forceinline__ void tf32_epilogue(const TArgs& a, const float (&acc)[16][4], int m0,
                                              int n0, int wg) {
  const int t = threadIdx.x & 127, warp = t >> 5, lane = t & 31;
  const int kq = lane & 3, p = lane >> 2;
  if constexpr (kOp == kOpBlock) {  // out[m][col + n] = acc, rows p and p + 8 are columns n, n + 8
    const int n = n0 + 64 * wg + 16 * warp + p;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = m0 + 8 * j + 2 * kq + (e & 1), c = n + (e >> 1) * 8;
        if (m < a.Mo && c < a.No) a.C[static_cast<int64_t>(m) * a.ldc + c] = acc[j][e];
      }
    }
  } else {  // rows p and p + 8 are columns n and n + 1: float2 pairs
    const int n = n0 + 32 * (2 * wg + (warp >> 1)) + nmajor_col(warp & 1, p);
    if (n >= a.No) return;  // No % 4 == 0 and n is even: n + 1 < No too
    // in two halves, every load of a half first (a store between them could
    // alias, so the compiler would wait out each load's latency in turn),
    // then its sums and stores
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float2 base[8][2];
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = m0 + 8 * (8 * half + jj) + 2 * kq + h;
          const int64_t e = static_cast<int64_t>(m) * a.ldc + n;
          base[jj][h] = make_float2(0.f, 0.f);
          if (m >= a.Mo) continue;
          if constexpr (kOp == kOpAccum) {
            base[jj][h] = *reinterpret_cast<const float2*>(a.C + e);
          } else if (a.rs.up_w != nullptr) {
            if constexpr (kCode == 0) {
              base[jj][h] = *reinterpret_cast<const float2*>(static_cast<const float*>(a.rs.up_w) + e);
            } else {
              base[jj][h] = make_float2(
                  __fmul_rn(WireCode<kCode>::decode(a.rs.up_w, e),
                            a.rs.up_s[quot<kNarrow>(e, a.rs.qb)]),
                  __fmul_rn(WireCode<kCode>::decode(a.rs.up_w, e + 1),
                            a.rs.up_s[quot<kNarrow>(e + 1, a.rs.qb)]));
            }
          }
        }
      }
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int j = 8 * half + jj, m = m0 + 8 * j + 2 * kq + h;
          if (m >= a.Mo) continue;
          *reinterpret_cast<float2*>(a.C + static_cast<int64_t>(m) * a.ldc + n) = make_float2(
              __fadd_rn(base[jj][h].x, acc[j][h]), __fadd_rn(base[jj][h].y, acc[j][2 + h]));
        }
      }
    }
  }
}

// Asks L2 for the tile's lines that the epilogue reads (out, or an exact
// upstream partial), so that they arrive while the tile's products run:
// 128 rows of 512 bytes, two 128-byte lines a consumer thread.
template <int kOp>
__device__ __forceinline__ void tf32_prefetch(const TArgs& a, int m0, int n0) {
  const float* src = kOp == kOpAccum ? a.C
                                     : (kOp == kOpRs && a.code == 0 ? static_cast<const float*>(a.rs.up_w)
                                                                    : nullptr);
  if (src == nullptr) return;
  const int row = m0 + (threadIdx.x >> 1);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int col = n0 + ((threadIdx.x & 1) * 2 + i) * 32;
    if (row < a.Mo && col < a.No)
      asm volatile("prefetch.global.L2 [%0];\n" ::"l"(src + static_cast<int64_t>(row) * a.ldc + col));
  }
}

template <int kOp>
__global__ void __launch_bounds__(kTThreads, 1)
hop_tf32_kernel(const __grid_constant__ CUtensorMap act_map, const __grid_constant__ CUtensorMap w_map,
                TArgs a) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = hopper::align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kTStages * kTStage);
  uint64_t* conv = full + kTStages;  // the stage's activation is split
  uint64_t* empty = conv + kTStages;
  // row 15's encode, handed from the consumers to the helper warps a tile
  // at a time through two message slots: the tile, or -1 (no group to encode)
  uint64_t* enc_full = empty + kTStages;
  uint64_t* enc_empty = enc_full + 2;
  volatile int* enc_msg = reinterpret_cast<volatile int*>(enc_empty + 2);
  const int tiles_m = (a.Mo + TM - 1) / TM;
  const int tiles = tiles_m * ((a.No + TN - 1) / TN);
  const int kblocks = (a.K + a.act_skip + TK - 1) / TK;
  const bool encode = kOp == kOpRs && a.rs.own_q != nullptr;
  if (threadIdx.x == 0) {
    for (int i = 0; i < kTStages; ++i) {
      hopper::mbar_init(&full[i], 1);
      hopper::mbar_init(&conv[i], 4);   // one arrival per converter warp
      hopper::mbar_init(&empty[i], 2);  // one arrival per consumer warpgroup
    }
    for (int i = 0; i < 2; ++i) {
      hopper::mbar_init(&enc_full[i], 1);
      hopper::mbar_init(&enc_empty[i], kRecvWarps);
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();
  const int wg = threadIdx.x / 128;
  // registers: 2 x 128 x 208 + 128 x 56 + 128 x 40 = 512 x 128, the launch's
  // (an increase waits for what the decreases free)
  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n");
    int s = 0, phase = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      for (int kb = 0; kb < kblocks; ++kb) {
        hopper::mbar_wait(&full[s], phase);
        tf32_convert(smem + s * kTStage, kb == 0 ? a.act_skip : 0);
        hopper::fence_proxy_async();  // the split tile, written here, is read by wgmma
        __syncwarp();
        if ((threadIdx.x & 31) == 0) hopper::mbar_arrive(&conv[s]);
        if (++s == kTStages) {
          s = 0;
          phase ^= 1;
        }
      }
    }
  } else if (wg == 3) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    const int warp = (threadIdx.x >> 5) & 3;
    if (warp == 0) {
      if ((threadIdx.x & 31) != 0) return;
      hopper::prefetch_map(&act_map);
      hopper::prefetch_map(&w_map);
      int s = 0, phase = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = (tile % tiles_m) * TM, n0 = (tile / tiles_m) * TN;
        // N-major weight boxes wholly past No are not loaded: the A rows they
        // would feed are never stored
        const int boxes = kOp == kOpBlock ? 1 : min(4, (a.No - n0 + 31) / 32);
        const unsigned bytes = kTile + boxes * (kOp == kOpBlock ? kTile : 4096);
        for (int kb = 0; kb < kblocks; ++kb) {
          hopper::mbar_wait(&empty[s], phase ^ 1);
          hopper::mbar_expect_tx(&full[s], bytes);
          unsigned char* st = smem + s * kTStage;
          const int k0 = kb * TK;
          hopper::tma_load_2d(st, &act_map, &full[s], a.act_col0 + k0, a.act_row0 + m0);
          if constexpr (kOp == kOpBlock) {
            hopper::tma_load_2d(st + 2 * kTile, &w_map, &full[s], k0, n0);
          } else {
            for (int c = 0; c < boxes; ++c)
              hopper::tma_load_2d(st + 2 * kTile + c * 4096, &w_map, &full[s], n0 + 32 * c,
                                  k0 - a.act_skip);
          }
          if (++s == kTStages) {
            s = 0;
            phase ^= 1;
          }
        }
      }
    } else if constexpr (kOp != kOpRs) {
      const int64_t wid = static_cast<int64_t>(blockIdx.x) * kRecvWarps + warp - 1;
      const int64_t nw = static_cast<int64_t>(gridDim.x) * kRecvWarps;
      if (a.code == 0) receive_shard<0>(a.ag, wid, nw);
      else if (a.code == 1) receive_shard<1>(a.ag, wid, nw);
      else receive_shard<2>(a.ag, wid, nw);
    } else if (encode) {  // the groups the consumers hand over, while they go on
      int q = 0, qphase = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        hopper::mbar_wait(&enc_full[q], qphase);
        const int msg = enc_msg[q];
        __syncwarp();
        if ((threadIdx.x & 31) == 0) hopper::mbar_arrive(&enc_empty[q]);
        if (msg >= 0) {
          const int m0 = (msg % tiles_m) * TM, n0 = (msg / tiles_m) * TN;
          encode_group(a.rs, a.code, m0, n0, warp - 1, kRecvWarps);
        }
        q ^= 1;
        qphase ^= q == 0;
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 208;\n");
    float acc[16][4], sum[16][4];
    uint32_t frag[4][8];
    int s = 0, phase = 0, q = 0, qphase = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int m0 = (tile % tiles_m) * TM, n0 = (tile / tiles_m) * TN;
      tf32_prefetch<kOp>(a, m0, n0);
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sum[j][e] = 0.f;
      for (int kb = 0; kb < kblocks; ++kb)
        tf32_stage<kOp>(smem, full, conv, empty, s, phase, frag, acc, sum, wg);
      if constexpr (kOp != kOpRs) tf32_epilogue<kOp, 0>(a, sum, m0, n0, wg);
      else if (a.code == 0) tf32_epilogue<kOp, 0>(a, sum, m0, n0, wg);
      else if (a.code == 1 && a.rs.narrow) tf32_epilogue<kOp, 1, true>(a, sum, m0, n0, wg);
      else if (a.code == 1) tf32_epilogue<kOp, 1, false>(a, sum, m0, n0, wg);
      else if (a.rs.narrow) tf32_epilogue<kOp, 2, true>(a, sum, m0, n0, wg);
      else tf32_epilogue<kOp, 2, false>(a, sum, m0, n0, wg);
      if (encode) {
        __threadfence();
        const bool ready = group_ready<true>(a.rs, m0, n0);
        // the block's last tile has nothing left to overlap: the consumers'
        // 8 warps encode it; earlier ones go to the helper warps
        const bool mine = ready && tile + static_cast<int>(gridDim.x) >= tiles;
        if (threadIdx.x == 0) {
          hopper::mbar_wait(&enc_empty[q], qphase ^ 1);
          enc_msg[q] = ready && !mine ? tile : -1;
          hopper::mbar_arrive(&enc_full[q]);
        }
        q ^= 1;
        qphase ^= q == 0;
        if (mine) encode_group(a.rs, a.code, m0, n0, threadIdx.x >> 5, 8);
      }
    }
  }
}

bool aligned16(const void* p, int64_t ld) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0 && ld % 4 == 0;
}

int64_t gcd64(int64_t a, int64_t b) {
  while (b) {
    const int64_t t = a % b;
    a = b;
    b = t;
  }
  return a;
}

// Tensor maps by (pointer, dims, row stride, box), so that a hop's maps are
// encoded once: the wire slots alternate by hop parity and each rank's x and
// weight come back every step.
struct MapKey {
  const void* p;
  uint64_t d0, d1, stride;
  uint32_t b0, b1;
  bool operator==(const MapKey& o) const {
    return p == o.p && d0 == o.d0 && d1 == o.d1 && stride == o.stride && b0 == o.b0 && b1 == o.b1;
  }
};
constexpr int kMapCache = 64;

bool fp32_map(CUtensorMap* out, const void* base, uint64_t d0, uint64_t d1, uint64_t stride_bytes,
              uint32_t b0, uint32_t b1) {
  static std::mutex mu;
  static MapKey keys[kMapCache];
  static CUtensorMap maps[kMapCache];
  static int used = 0, next = 0;
  const MapKey key{base, d0, d1, stride_bytes, b0, b1};
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < used; ++i)
    if (keys[i] == key) {
      *out = maps[i];
      return true;
    }
  const hopper::EncodeTiled fn = hopper::encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {d0, d1};
  const cuuint64_t strides[1] = {stride_bytes};
  const cuuint32_t box[2] = {b0, b1};
  if (!hopper::encode(fn, out, base, 2, dims, strides, box, CU_TENSOR_MAP_DATA_TYPE_FLOAT32))
    return false;
  keys[next] = key;
  maps[next] = *out;
  next = (next + 1) % kMapCache;
  if (used < kMapCache) ++used;
  return true;
}

bool tf32_smem_set[3][hopper::kMaxDevices];

// Form T's launch: the grid is persistent (at most one block an SM, and at
// least `min_blocks` for row 14's receive).
template <int kOp>
int launch_tf32(const CUtensorMap& act, const CUtensorMap& w, const TArgs& a, int64_t min_blocks,
                cudaStream_t s) {
  const cudaError_t err = hopper::allow_smem(reinterpret_cast<const void*>(hop_tf32_kernel<kOp>),
                                             kTSmem, tf32_smem_set[kOp]);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t tiles =
      static_cast<int64_t>((a.Mo + TM - 1) / TM) * ((a.No + TN - 1) / TN);
  const int64_t sms = hop_wire::sm_count();
  const int64_t want = tiles > min_blocks ? tiles : min_blocks;
  const unsigned grid = static_cast<unsigned>(want < sms ? (want < 1 ? 1 : want) : sms);
  hop_tf32_kernel<kOp><<<grid, kTThreads, kTSmem, s>>>(act, w, a);
  return static_cast<int>(cudaGetLastError());
}

template <bool kTransB>
int launch_ag(const AgArgs& a, unsigned grid, int code, cudaStream_t s) {
  if (code == 0) ag_hop_kernel<kTransB, 0><<<grid, kThreads, 0, s>>>(a);
  else if (code == 1) ag_hop_kernel<kTransB, 1><<<grid, kThreads, 0, s>>>(a);
  else if (code == 2) ag_hop_kernel<kTransB, 2><<<grid, kThreads, 0, s>>>(a);
  else return cudaErrorInvalidValue;
  return static_cast<int>(cudaGetLastError());
}

bool aligned8(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 7) == 0; }

}  // namespace

// One all_gather_matmul hop of one rank. x: fp32 rows of stride ldx (the
// accumulate form's x [M, n*Ks], contracted at columns col .. col + Ks; the
// out_block form's g [M, N]); held [Ks, N]; out: y [M, N] (accumulate), or
// y [M, >= col + Ks] of row stride ldo whose block at column col is written.
// up_w / up_s: the upstream wire (code 0: an fp32 shard [Ks, N], up_s NULL;
// 1 int8 / 2 e4m3: codes [Ks * N] and scales [Ks * N / qb]); recv [Ks, N]
// gets it decoded; own_q / own_s (or NULL) its codes. form: 0 S (SIMT), 1 T
// (TF32 x 3 on wgmma: x and held 16-byte aligned, ldx and N multiples of 4,
// M > 0; accumulate: out 8-byte aligned and ldo even). Returns
// cudaErrorInvalidValue for what the form does not take, else
// cudaGetLastError().
extern "C" int ds_ag_hop(const void* x, int64_t ldx, int64_t col, const void* held, void* out,
                         int64_t ldo, int M, int N, int Ks, int out_block, const void* up_w,
                         const void* up_s, void* recv, void* own_q, void* own_s, int64_t qb,
                         int code, int form, void* stream) {
  if (M < 0 || N <= 0 || Ks <= 0 || up_w == nullptr || recv == nullptr || code < 0 || code > 2)
    return cudaErrorInvalidValue;
  const int64_t numel = static_cast<int64_t>(Ks) * N;
  if (code != 0 && (qb <= 0 || qb > 2147483647LL || numel % qb || up_s == nullptr))
    return cudaErrorInvalidValue;
  AgArgs a{};
  const float* xf = static_cast<const float*>(x);
  a.A = out_block ? xf : xf + col;
  a.lda = ldx;
  a.B = static_cast<const float*>(held);
  a.ldb = N;
  a.C = out_block ? static_cast<float*>(out) + col : static_cast<float*>(out);
  a.ldc = ldo;
  a.M = M;
  a.out_cols = out_block ? Ks : N;
  a.K = out_block ? N : Ks;
  a.vec_a = aligned16(a.A, a.lda);
  a.vec_b = aligned16(a.B, a.ldb);
  a.numel = numel;
  a.up_w = up_w;
  a.up_s = static_cast<const float*>(up_s);
  a.recv = static_cast<float*>(recv);
  a.own_q = code != 0 ? own_q : nullptr;
  a.own_s = static_cast<float*>(own_s);
  a.qb = code != 0 ? static_cast<int>(qb) : 1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int sms = hop_wire::sm_count();
  // warps of receive work: four 16-byte chunks a lane, or a block a warp
  const int64_t wire_warps = code == 0 ? (numel + 16LL * 32 - 1) / (16LL * 32) : numel / qb;
  if (form == 1) {
    if (M <= 0 || !aligned16(x, ldx) || !aligned16(held, N) ||
        (!out_block && (!aligned8(out) || ldo % 2)))
      return cudaErrorInvalidValue;
    TArgs t{};
    t.Mo = M;
    t.No = a.out_cols;
    t.K = a.K;
    t.act_row0 = 0;
    t.act_skip = out_block ? 0 : static_cast<int>(col & 3);
    t.act_col0 = out_block ? 0 : static_cast<int>(col - t.act_skip);
    t.C = a.C;
    t.ldc = ldo;
    t.code = code;
    t.ag = a;
    CUtensorMap act, w;
    // x from column 0 to the shard's end (k past it zero-filled), g whole;
    // held as [Ks][N]: 32 x 32 boxes (N-major) or 32 k x 128 rows (out_block)
    const uint64_t act_cols = out_block ? static_cast<uint64_t>(N) : static_cast<uint64_t>(col + Ks);
    if (!fp32_map(&act, x, act_cols, static_cast<uint64_t>(M), static_cast<uint64_t>(ldx) * 4, TK,
                  TM) ||
        !fp32_map(&w, held, static_cast<uint64_t>(N), static_cast<uint64_t>(Ks),
                  static_cast<uint64_t>(N) * 4, 32, out_block ? TN : 32))
      return cudaErrorInvalidValue;
    const int64_t min_blocks = (wire_warps + 4 * kRecvWarps - 1) / (4 * kRecvWarps);
    return out_block ? launch_tf32<kOpBlock>(act, w, t, min_blocks, s)
                     : launch_tf32<kOpAccum>(act, w, t, min_blocks, s);
  }
  if (form != 0) return cudaErrorInvalidValue;
  const int64_t wire_work = (wire_warps + kWarps - 1) / kWarps;
  a.wire_ctas = static_cast<int>(wire_work < 1 ? 1 : (wire_work < 4LL * sms ? wire_work : 4LL * sms));
  const int64_t tiles = static_cast<int64_t>((M + kBM - 1) / kBM) * ((a.out_cols + kBN - 1) / kBN);
  const int64_t grid = a.wire_ctas + tiles;
  if (grid > 2147483647LL) return cudaErrorInvalidValue;
  return out_block ? launch_ag<true>(a, static_cast<unsigned>(grid), code, s)
                   : launch_ag<false>(a, static_cast<unsigned>(grid), code, s);
}

// One matmul_reduce_scatter hop of one rank: part [Mb, N] = rprev + x[row0 :
// row0 + Mb] @ w, x [*, K] and w [K, N] contiguous fp32. up_w / up_s: the
// upstream wire (NULL at the first hop; code 0: an fp32 partial [Mb, N];
// 1 int8 / 2 e4m3: codes and scales). own_q / own_s with code 1 or 2: part's
// codes; counters: ceil(Mb / 128) * ceil(N / 128) zeroed ints.
// form: 0 S (SIMT), 1 T (TF32 x 3 on wgmma: x and w 16-byte aligned, K and N
// multiples of 4, K > 0, part and an fp32 up_w 8-byte aligned). Returns
// cudaErrorInvalidValue for what the form does not take, else
// cudaGetLastError().
extern "C" int ds_rs_hop(const void* x, int64_t row0, const void* w, int Mb, int K, int N,
                         const void* up_w, const void* up_s, void* part, void* own_q, void* own_s,
                         void* counters, int64_t qb, int code, int form, void* stream) {
  if (Mb <= 0 || N <= 0 || K < 0 || part == nullptr || code < 0 || code > 2)
    return cudaErrorInvalidValue;
  const int64_t numel = static_cast<int64_t>(Mb) * N;
  const bool encode = code != 0 && own_q != nullptr;
  if (code != 0 && (qb <= 0 || qb > 2147483647LL || numel % qb)) return cudaErrorInvalidValue;
  if (encode && (own_s == nullptr || counters == nullptr)) return cudaErrorInvalidValue;
  if (code != 0 && up_w != nullptr && up_s == nullptr) return cudaErrorInvalidValue;
  RsArgs a{};
  a.A = static_cast<const float*>(x) + row0 * K;
  a.B = static_cast<const float*>(w);
  a.Mb = Mb;
  a.N = N;
  a.K = K;
  a.vec_a = aligned16(a.A, K);
  a.vec_b = aligned16(a.B, N);
  a.up_w = up_w;
  a.up_s = static_cast<const float*>(up_s);
  a.part = static_cast<float*>(part);
  a.own_q = encode ? own_q : nullptr;
  a.own_s = static_cast<float*>(own_s);
  a.counters = static_cast<int*>(counters);
  a.qb = code != 0 ? static_cast<int>(qb) : 1;
  a.narrow = numel <= 0xFFFFFFFFLL;
  // the encode's groups of tiles, each holding whole blocks
  const int tiles_n = (N + kBN - 1) / kBN;
  if (N % a.qb == 0) {  // blocks within rows: one tile row by lcm(qb, kBN) columns
    const int64_t cols = a.qb / gcd64(a.qb, kBN) * kBN;
    a.band_rows = kBM;
    a.group_tiles = static_cast<int>(cols / kBN < tiles_n ? cols / kBN : tiles_n);
  } else {  // the least multiple of kBM whose rows hold whole blocks (all rows
            // when that passes Mb: Mb * N is whole blocks too), the full width
    const int64_t all_rows = static_cast<int64_t>((Mb + kBM - 1) / kBM) * kBM;
    const int64_t band_rows = kBM * (a.qb / gcd64(a.qb, static_cast<int64_t>(kBM) * N));
    a.band_rows = static_cast<int>(band_rows < all_rows ? band_rows : all_rows);
    a.group_tiles = tiles_n;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (form == 1) {
    if (K <= 0 || !aligned16(x, K) || !aligned16(w, N) || !aligned8(part) ||
        (code == 0 && up_w != nullptr && !aligned8(up_w)))
      return cudaErrorInvalidValue;
    TArgs t{};
    t.Mo = Mb;
    t.No = N;
    t.K = K;
    t.act_row0 = static_cast<int>(row0);
    t.act_col0 = 0;
    t.act_skip = 0;
    t.C = a.part;
    t.ldc = N;
    t.code = code;
    t.rs = a;
    CUtensorMap act, wm;
    // x's rows up to the block's end (rows past it zero-filled); w as 32 x 32 boxes
    if (!fp32_map(&act, x, static_cast<uint64_t>(K), static_cast<uint64_t>(row0 + Mb),
                  static_cast<uint64_t>(K) * 4, TK, TM) ||
        !fp32_map(&wm, w, static_cast<uint64_t>(N), static_cast<uint64_t>(K),
                  static_cast<uint64_t>(N) * 4, 32, 32))
      return cudaErrorInvalidValue;
    return launch_tf32<kOpRs>(act, wm, t, 1, s);
  }
  if (form != 0) return cudaErrorInvalidValue;
  const int64_t grid = static_cast<int64_t>((Mb + kBM - 1) / kBM) * ((N + kBN - 1) / kBN);
  if (grid > 2147483647LL) return cudaErrorInvalidValue;
  const auto g = static_cast<unsigned>(grid);
  if (code == 0) rs_hop_kernel<0><<<g, kThreads, 0, s>>>(a);
  else if (code == 1) rs_hop_kernel<1><<<g, kThreads, 0, s>>>(a);
  else rs_hop_kernel<2><<<g, kThreads, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

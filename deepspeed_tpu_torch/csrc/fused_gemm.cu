// The fused GEMM-collective hop kernels, written by hand for Hopper (sm_90a).
//
// Replaces: deepspeed_tpu/collectives/fused_gemm.py
//   _ag_hop_kernel (:198) -> ag_hop_kernel<kTransB, kCode> (ds_ag_hop)
//   _rs_hop_kernel (:257) -> rs_hop_kernel<kCode>          (ds_rs_hop)
//
// One launch is one ring hop of one rank, on the rank's stream. It computes
// the hop's product in its own body and moves the hop's wire in the same
// launch. The wire stays in the sending rank's memory and this (receiving)
// launch pulls it: on two cards a peer read over NVLink, on one card an HBM
// read. Ordering between ranks is CUDA events the host records
// (collectives/fused_gemm.py): the wire read here was written by the
// upstream rank's previous launch, so no kernel waits on another launch.
//
// ag_hop_kernel (all_gather_matmul): CTAs [0, wire_ctas) receive the next
// shard: the upstream's exact fp32 shard copied, or its codes decoded
// (code * scale) into `recv` and, before the last hop, re-encoded into this
// rank's own wire slot (the TPU kernel sends the decoded shard it holds).
// The other CTAs contract the held shard [Ks, N] (fp32, as it is):
//   accumulate: out[M, N] = out + x[:, col : col + Ks] @ held
//   out_block:  out[:, col : col + Ks] = g[M, N] @ held^T       (kTransB)
// The two halves touch different buffers, so they need no order.
//
// rs_hop_kernel (matmul_reduce_scatter): part[Mb, N] = rprev + x[row0 :
// row0 + Mb] @ w, rprev the upstream's wire decoded (0 without one). An
// exact wire: `part` is this rank's own fp32 slot. A block wire: `part` is a
// staging buffer, and its codes go into the own slot. The encode of a block
// needs every tile that wrote into it, so the tiles are split into groups
// that hold whole blocks: where qb divides N (blocks lie within rows), one
// tile row by lcm(qb, kBN) columns, a single tile when qb divides kBN; else a
// band of whole tile rows (band_rows, a multiple of both kBM and the rows a
// block spans). A group of more than one tile counts its arrivals in an
// atomic counter and its last tile encodes the group: the
// threadfence-and-count pattern, no tile waits.
//
// The block wire is hop_wire.cuh's: blocks of qb contiguous elements of the
// row-major shard or partial (qb = gcd(B, block_size), B one TPU chunk), IEEE
// divisions, rint, __fmul_rn decodes and __fadd_rn sums, so codes and scales
// equal the plain version's (and JAX's block math) bit for bit.
//
// The product: fp32 FMA on the CUDA cores (not TF32), 128 x 128 output tiles
// of 256 threads, 8 x 8 outputs a thread, K in steps of 8 through two
// shared-memory buffers (the next step's global loads in flight while this
// one computes). What bounds it on an H100: operations, 2 M N K at 67
// TFLOP/s of fp32.

#include "hop_wire.cuh"

namespace {

using hop_wire::WireCode;

constexpr int kBM = 128;  // collectives/fused_gemm.py:_TILE_ROWS
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

template <int kCode>
__device__ void receive_codes(const AgArgs& a) {
  using W = WireCode<kCode>;
  const int lane = threadIdx.x & 31;
  const int64_t nblocks = a.numel / a.qb;
  const int64_t stride = static_cast<int64_t>(a.wire_ctas) * kWarps;
  for (int64_t blk = static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5); blk < nblocks;
       blk += stride) {
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
__device__ void receive_shard(const AgArgs& a) {
  if constexpr (kCode == 0) {  // the exact fp32 shard
    const float* src = static_cast<const float*>(a.up_w);
    const int64_t stride = static_cast<int64_t>(a.wire_ctas) * kThreads;
    const int64_t tid = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
    const bool vec = ((reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(a.recv)) & 15) == 0;
    const int64_t body = vec ? a.numel / 4 : 0;
    for (int64_t i = tid; i < body; i += stride)
      reinterpret_cast<float4*>(a.recv)[i] = reinterpret_cast<const float4*>(src)[i];
    for (int64_t i = body * 4 + tid; i < a.numel; i += stride) a.recv[i] = src[i];
  } else {
    receive_codes<kCode>(a);
  }
}

template <bool kTransB, int kCode>
__global__ void __launch_bounds__(kThreads) ag_hop_kernel(AgArgs a) {
  __shared__ Smem smem;
  if (static_cast<int>(blockIdx.x) < a.wire_ctas) {
    receive_shard<kCode>(a);
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
};

template <int kCode>
__device__ void encode_group(const RsArgs& a, int m0, int n0);

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
    if (a.own_q != nullptr) encode_group<kCode>(a, m0, n0);
  }
}

// After a tile's part is written: the tiles of its group count their
// arrival (a one-tile group needs no count) and the last one encodes the
// group's blocks into the own wire slot.
template <int kCode>
__device__ void encode_group(const RsArgs& a, int m0, int n0) {
  using W = WireCode<kCode>;
  __shared__ int last;
  const int band = m0 / a.band_rows, group = n0 / (a.group_tiles * kBN);
  const int r0 = band * a.band_rows, r1 = min(r0 + a.band_rows, a.Mb);
  const int c0 = group * a.group_tiles * kBN, c1 = min(c0 + a.group_tiles * kBN, a.N);
  const int tiles = ((r1 - r0 + kBM - 1) / kBM) * ((c1 - c0 + kBN - 1) / kBN);
  if (tiles > 1) {
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) {
      const int groups_n = (a.N + a.group_tiles * kBN - 1) / (a.group_tiles * kBN);
      last = atomicAdd(&a.counters[band * groups_n + group], 1) == tiles - 1;
    }
    __syncthreads();
    if (!last) return;
    __threadfence();
  } else {
    __syncthreads();  // the tile's own writes, seen by the whole CTA
  }
  const int lane = threadIdx.x & 31;
  // full rows: one flat run of whole blocks; else whole blocks in each row
  const bool full = c0 == 0 && c1 == a.N;
  const int64_t per_row = (c1 - c0) / a.qb;
  const int64_t nblk = full ? static_cast<int64_t>(r1 - r0) * a.N / a.qb
                            : static_cast<int64_t>(r1 - r0) * per_row;
  for (int64_t j = threadIdx.x >> 5; j < nblk; j += kWarps) {
    const int64_t base = full ? static_cast<int64_t>(r0) * a.N + j * a.qb
                              : (r0 + j / per_row) * a.N + c0 + (j % per_row) * a.qb;
    const int64_t blk = base / a.qb;
    float amax = 0.f;
    for (int e = lane; e < a.qb; e += 32) amax = fmaxf(amax, fabsf(__ldcg(a.part + base + e)));
    amax = hop_wire::warp_max(amax);
    const float scale = hop_wire::block_scale<kCode>(amax);
    if (lane == 0) a.own_s[blk] = scale;
    for (int e = lane; e < a.qb; e += 32) W::encode(a.own_q, base + e, __ldcg(a.part + base + e) / scale);
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

template <bool kTransB>
int launch_ag(const AgArgs& a, unsigned grid, int code, cudaStream_t s) {
  if (code == 0) ag_hop_kernel<kTransB, 0><<<grid, kThreads, 0, s>>>(a);
  else if (code == 1) ag_hop_kernel<kTransB, 1><<<grid, kThreads, 0, s>>>(a);
  else if (code == 2) ag_hop_kernel<kTransB, 2><<<grid, kThreads, 0, s>>>(a);
  else return cudaErrorInvalidValue;
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One all_gather_matmul hop of one rank. x: fp32 rows of stride ldx (the
// accumulate form's x [M, n*Ks], contracted at columns col .. col + Ks; the
// out_block form's g [M, N]); held [Ks, N]; out: y [M, N] (accumulate), or
// y [M, >= col + Ks] of row stride ldo whose block at column col is written.
// up_w / up_s: the upstream wire (code 0: an fp32 shard [Ks, N], up_s NULL;
// 1 int8 / 2 e4m3: codes [Ks * N] and scales [Ks * N / qb]); recv [Ks, N]
// gets it decoded; own_q / own_s (or NULL) its codes. Returns cudaGetLastError().
extern "C" int ds_ag_hop(const void* x, int64_t ldx, int64_t col, const void* held, void* out,
                         int64_t ldo, int M, int N, int Ks, int out_block, const void* up_w,
                         const void* up_s, void* recv, void* own_q, void* own_s, int64_t qb,
                         int code, void* stream) {
  if (M < 0 || N <= 0 || Ks <= 0 || up_w == nullptr || recv == nullptr) return cudaErrorInvalidValue;
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
  const int sms = hop_wire::sm_count();
  const int64_t wire_work = code == 0 ? (numel + 4LL * kThreads - 1) / (4LL * kThreads)
                                      : (numel / qb + kWarps - 1) / kWarps;
  a.wire_ctas = static_cast<int>(wire_work < 1 ? 1 : (wire_work < 4LL * sms ? wire_work : 4LL * sms));
  const int64_t tiles = static_cast<int64_t>((M + kBM - 1) / kBM) * ((a.out_cols + kBN - 1) / kBN);
  const int64_t grid = a.wire_ctas + tiles;
  if (grid > 2147483647LL) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return out_block ? launch_ag<true>(a, static_cast<unsigned>(grid), code, s)
                   : launch_ag<false>(a, static_cast<unsigned>(grid), code, s);
}

// One matmul_reduce_scatter hop of one rank: part [Mb, N] = rprev + x[row0 :
// row0 + Mb] @ w, x [*, K] and w [K, N] contiguous fp32. up_w / up_s: the
// upstream wire (NULL at the first hop; code 0: an fp32 partial [Mb, N];
// 1 int8 / 2 e4m3: codes and scales). own_q / own_s with code 1 or 2: part's
// codes; counters: ceil(Mb / 128) * ceil(N / 128) zeroed ints. Returns
// cudaGetLastError().
extern "C" int ds_rs_hop(const void* x, int64_t row0, const void* w, int Mb, int K, int N,
                         const void* up_w, const void* up_s, void* part, void* own_q, void* own_s,
                         void* counters, int64_t qb, int code, void* stream) {
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
  const int64_t grid = static_cast<int64_t>((Mb + kBM - 1) / kBM) * ((N + kBN - 1) / kBN);
  if (grid > 2147483647LL) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto g = static_cast<unsigned>(grid);
  if (code == 0) rs_hop_kernel<0><<<g, kThreads, 0, s>>>(a);
  else if (code == 1) rs_hop_kernel<1><<<g, kThreads, 0, s>>>(a);
  else rs_hop_kernel<2><<<g, kThreads, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

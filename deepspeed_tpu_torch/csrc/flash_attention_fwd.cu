// ds_flash_fwd: causal GQA flash-attention forward, written by hand for
// Hopper (sm_90a). Replaces _fwd_kernel of
// deepspeed_tpu/ops/pallas/flash_attention.py:216 (launched by _flash_fwd,
// :299), with and without ALiBi (the kAlibi form adds _alibi_add's bias,
// :158, in its relative form). The function (pre-scaled q, base-2 softmax,
// masks, sentinels, ALiBi) is set out in flash_attention.cuh. Three forms of
// it; the wrapper (ops/flash_attention.py flash_fwd_form) runs form W for
// bf16 and the SIMT form for fp32:
//
// - Form W ("wgmma", every bf16 input). What bounds it: operations. At the
//   Llama-3.2-1B training shape (B 4, S 2048, H 32, kvH 8, hd 64) the two
//   products are 68.8 GFLOP (0.0695 ms at 989 TFLOP/s) on 50 MB (0.015 ms at
//   3.35 TB/s). At hd 64 a second floor sits at the same height: every
//   score costs 4 hd = 256 tensor flops (1/16 of an SM's 4096 bf16 flops a
//   clock) and one exp2 on the SFU (16 a clock an SM: also 1/16 of a
//   clock), so the 268 M causal scores need ~0.069 ms of SFU time; run one
//   after the other, the two halves cap the kernel near 50 % of the tensor
//   rate. The design, against each limit:
//   * Only wgmma reaches the full tensor rate. S = Q K^T is
//     wgmma.m64n128k16, K from shared memory (K-major, hd contiguous) and Q
//     from registers with two consumer warpgroups (loaded once a block by
//     ldmatrix) or from shared memory with three. O += P V takes P from
//     registers (the fp32 accumulator of S, columns [16 j, 16 j + 16),
//     rounded to bf16 and packed in pairs, is the A fragment of k-step j)
//     and V from shared memory, MN-major (the transpose bit), so P never
//     touches shared memory.
//   * Loads run ahead of the products: one producer warp issues TMA copies
//     (4-D maps (hd, heads, S, B), boxes of 64 columns, 128-byte swizzle;
//     rows outside [0, S) zero-fill inside their own batch, so the ragged
//     tail needs no padding; hd 128 is two boxes a tile) into a ring of K/V
//     stages (4 at hd 64, 3 at hd 128: a 2-stage ring leaves the copies'
//     latency exposed) guarded by full/empty mbarriers, and writes the key
//     tile's keep-mask slice beside it; setmaxnreg moves registers from the
//     producer warpgroup to the consumers.
//   * 128-key steps and a 128-row query tile (two consumer warpgroups of 64
//     rows) or, at hd 64, 192 rows (three): each K/V tile staged from L2
//     serves more rows than the 64 x 64 form's did.
//   * The softmax overlaps the products: the consumer warpgroups take turns
//     at the tensor cores (named barriers: one issues its products while the
//     others run their exp2s; kPingPong), and within a warpgroup the next
//     tile's Q K^T and this tile's P V are issued together, the softmax of
//     the one running while the other is in flight (the k_splits hoist of
//     the JAX kernel; kOverlap). The exp2s take the SFU's flush-to-zero form
//     (one instruction a score). The schedule is a set of bits, fixed at
//     compile time to default_schedule(hd), the fastest of the eight when
//     each was timed on the card (PERF.md); a re-timing edits that function.
//   * Query tiles are cut from the end of S and the heaviest (the last)
//     start first; the partial tile, if any, is the first and cheapest. A
//     warpgroup skips the key tiles that lie wholly above its rows.
//   The output goes out through this warpgroup's rows of the Q tile as
//   whole 16-byte chunks of rows. A phase not completed in 10 s traps
//   (hopper.cuh mbar_wait), so a lost copy fails the launch instead of
//   holding the card.
// - "mma" (bf16, the first form, kept to be timed beside form W): 64-row
//   query tiles, 4 warps, mma.sync bf16 with fp32 accumulation, K and V
//   staged through registers; flash_attention.cuh describes it.
// - "simt" (fp32): the same code with the products done by FMAs (a check
//   path, not a fast one).

#include "flash_attention.cuh"
#include "hopper.cuh"

using namespace ds_flash;

namespace {

// ---------------------------------------------------------------- forward
template <typename T, int HD, bool kAlibi>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const int* __restrict__ keep, const float* __restrict__ slopes,
                 T* __restrict__ out, float* __restrict__ lse, int S, int H, int kvH) {
  using L = QTileSmem<T, HD, false>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  T* q_s = sm + L::kQ;
  T* k_s = sm + L::kK;
  T* v_s = sm + L::kV;
  T* p_s = sm + L::kP;
  int* keep_s = reinterpret_cast<int*>(sm + L::kEnd);

  const int q0 = blockIdx.x * kRows, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / kvH);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int64_t q_stride = static_cast<int64_t>(H) * HD, kv_stride = static_cast<int64_t>(kvH) * HD;
  const T* qb = q + static_cast<int64_t>(b) * S * q_stride + static_cast<int64_t>(h) * HD;
  const T* kb = k + static_cast<int64_t>(b) * S * kv_stride + static_cast<int64_t>(kvh) * HD;
  const T* vb = v + static_cast<int64_t>(b) * S * kv_stride + static_cast<int64_t>(kvh) * HD;
  const int* keep_b = keep == nullptr ? nullptr : keep + static_cast<int64_t>(b) * S;

  load_rows<T, kRows, HD>(q_s, L::kLd, qb, q_stride, q0, S);
  const T* qw = q_s + warp * 16 * L::kLd;
  T* pw = p_s + warp * 16 * L::kLdK;
  const int row[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  float o[HD / 8][4] = {};
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  const float slope = kAlibi ? slopes[h] : 0.f;

  const int n_tiles = (min(q0 + kRows, S) - 1) / kKeys + 1;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kKeys;
    __syncthreads();  // the previous step's K, V reads are done
    load_rows<T, kKeys, HD>(k_s, L::kLd, kb, kv_stride, k0, S);
    load_rows<T, kKeys, HD>(v_s, L::kLd, vb, kv_stride, k0, S);
    load_keep(keep_s, kKeys, keep_b, k0, S);
    __syncthreads();

    float s[kKeys / 8][4] = {};
    warp_gemm<kKeys, HD, false>(s, qw, L::kLd, k_s, L::kLd);
    if constexpr (kAlibi) {  // every tile, before the mask
      const int base[2] = {k0 + 2 * t - row[0], k0 + 2 * t - row[1]};
      add_alibi<kKeys, 1>(s, slope, base);
    }
    if (keep_b != nullptr || k0 + kKeys - 1 > q0 || k0 + kKeys > S) {
#pragma unroll
      for (int n = 0; n < kKeys / 8; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int col = n * 8 + 2 * t + (c & 1);
          if (!(keep_s[col] && k0 + col <= row[c >> 1])) s[n][c] = kNegInf;
        }
    }
    // online softmax, base 2: rows g (c = 0, 1) and g + 8 (c = 2, 3); the 4
    // lanes of a group share a row
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = kNegInf;
#pragma unroll
      for (int n = 0; n < kKeys / 8; ++n) mx = fmaxf(mx, fmaxf(s[n][2 * i], s[n][2 * i + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_cur = fmaxf(m[i], mx);
      const float m_safe = m_cur == kNegInf ? 0.f : m_cur;
      const float alpha = m[i] == kNegInf ? 0.f : exp2f(m[i] - m_safe);
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < kKeys / 8; ++n) {
        s[n][2 * i] = exp2f(s[n][2 * i] - m_safe);
        s[n][2 * i + 1] = exp2f(s[n][2 * i + 1] - m_safe);
        sum += s[n][2 * i] + s[n][2 * i + 1];
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l[i] = alpha * l[i] + sum;
      m[i] = m_cur;
#pragma unroll
      for (int n = 0; n < HD / 8; ++n) {
        o[n][2 * i] *= alpha;
        o[n][2 * i + 1] *= alpha;
      }
    }
    warp_gemm_frag<HD, kKeys>(o, s, pw, L::kLdK, v_s, L::kLd);  // P in V's dtype
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (row[i] >= S) continue;
    const float l_safe = l[i] == 0.f ? 1.f : l[i];
    T* dst = out + (static_cast<int64_t>(b) * S + row[i]) * q_stride + static_cast<int64_t>(h) * HD;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
      store_pair(dst + n * 8 + 2 * t, o[n][2 * i] / l_safe, o[n][2 * i + 1] / l_safe);
    if (t == 0)
      lse[(static_cast<int64_t>(b) * H + h) * S + row[i]] =
          l[i] == 0.f ? kNegInf : m[i] + log2f(l_safe);
  }
}

template <typename T, int HD>
int launch_fwd(const void* q, const void* k, const void* v, const void* keep, const void* slopes,
               void* out, void* lse, int B, int S, int H, int kvH, cudaStream_t stream) {
  constexpr size_t kBytes = QTileSmem<T, HD, false>::kBytes;
  const auto kernel =
      slopes != nullptr ? flash_fwd_kernel<T, HD, true> : flash_fwd_kernel<T, HD, false>;
  const cudaError_t err = set_smem(kernel, kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + kRows - 1) / kRows, H, B);
  kernel<<<grid, kThreads, kBytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(keep), static_cast<const float*>(slopes), static_cast<T*>(out),
      static_cast<float*>(lse), S, H, kvH);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------- form W: wgmma + TMA
namespace form_w {

typedef __nv_bfloat16 bf16;

constexpr int kBN = 128;         // keys a step
constexpr int kBox = kBN * 128;  // 16 KB: 128 rows x 64 bf16 columns, one 128-byte swizzled box

// Schedule bits. kPingPong: the consumer warpgroups take turns at the tensor
// cores; kOverlap: a warpgroup's softmax runs while its P V is in flight;
// kThreeGroups (hd 64 only): three consumer warpgroups, a 192-row query tile,
// so that each K/V tile staged from L2 serves 1.5x the rows.
constexpr int kPingPong = 1, kOverlap = 2, kThreeGroups = 4;
// The one schedule built for each head dim, the fastest at the training
// shapes when all eight were timed (PERF.md): at hd 64 three warpgroups
// taking turns, the softmax hidden behind the other two's products; at hd
// 128 two, with the overlap too. The other bits stay so that a later
// timing can change this function alone.
constexpr int default_schedule(int hd) {
  return hd == 64 ? kThreeGroups | kPingPong : kPingPong | kOverlap;
}

template <int HD, int kWG>
struct Smem {  // byte offsets from the 1024-aligned base
  static constexpr int kBM = 64 * kWG;                    // query rows a block
  static constexpr int kThreads = 128 * (kWG + 1);        // the consumers, then the producer's
  static constexpr int kBoxes = HD / 64;                  // 64-column boxes a row
  static constexpr int kQBox = kBM * 128;                 // one box of Q
  static constexpr int kStages = HD == 64 ? 4 : 3;        // K/V ring: ~3 tiles of loads in flight
  static constexpr int kQ = 0;                            // Q: kBoxes boxes of kBM rows
  static constexpr int kKV = kQ + kBoxes * kQBox;         // stage s: K's boxes, then V's
  static constexpr int kStage = 2 * kBoxes * kBox;
  static constexpr int kKeep = kKV + kStages * kStage;     // int [kStages][kBN]
  static constexpr int kBars = kKeep + kStages * kBN * 4;  // full[kStages], empty[kStages], q_full
  static constexpr int kBytes = kBars + (2 * kStages + 1) * 8 + 1024;
  static_assert(kBytes <= 232448, "form W: shared memory");
};

using hopper::bar_arrive;
using hopper::bar_sync;

// S (64 x 128, this warpgroup's rows) = Q K^T over hd: k-step kk reads
// columns [16 kk, 16 kk + 16), 32 bytes into the swizzled rows of box kk / 4
// (Q's boxes kQBox apart, K's kBox). Both operands are K-major with 8-row
// groups 1024 bytes apart.
template <int HD, int kQBox>
__device__ __forceinline__ void issue_qk(float (&s)[kBN / 8][4], unsigned q_addr, unsigned k_addr) {
  hopper::wgmma_m64n128k16_ss<false>(s, hopper::wgmma_desc(q_addr, 16, 1024),
                                     hopper::wgmma_desc(k_addr, 16, 1024));
#pragma unroll
  for (int kk = 1; kk < HD / 16; ++kk) {
    const unsigned col = (kk % 4) * 32;
    hopper::wgmma_m64n128k16_ss<true>(
        s, hopper::wgmma_desc(q_addr + (kk / 4) * kQBox + col, 16, 1024),
        hopper::wgmma_desc(k_addr + (kk / 4) * kBox + col, 16, 1024));
  }
}

// The same product with Q in registers (two consumer warpgroups have the
// registers: 16 a thread at hd 64, 32 at hd 128): qf[kk] is Q's A fragment
// of k-step kk, so Q is read from shared memory once a block instead of once
// a key tile.
template <int HD>
__device__ __forceinline__ void issue_qk_rs(float (&s)[kBN / 8][4], const uint32_t (&qf)[HD / 16][4],
                                            unsigned k_addr) {
  hopper::wgmma_m64n128k16_rs<false>(s, qf[0], hopper::wgmma_desc(k_addr, 16, 1024));
#pragma unroll
  for (int kk = 1; kk < HD / 16; ++kk)
    hopper::wgmma_m64n128k16_rs<true>(
        s, qf[kk], hopper::wgmma_desc(k_addr + (kk / 4) * kBox + (kk % 4) * 32, 16, 1024));
}

// O (64 x hd) += P V: k-step kk takes P's columns [16 kk, 16 kk + 16) from
// registers and V's rows [16 kk, 16 kk + 16) (2 KB further into each box);
// V is MN-major, its 64-column boxes kBox apart (leading), 8-row groups
// 1024 bytes apart (stride).
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

// One key tile's scores, in place: the ALiBi bias (every tile, before the
// mask), the mask where the tile needs one (keep_s: the tile's keep-mask
// slice; key k0 + col is visible to row r iff it is kept and k0 + col <= r),
// then the online softmax in base 2: sc becomes exp2(s - m_new), m the rows'
// new max, l this thread's share of the rows' sums, alpha the factor the
// rows' earlier output takes. The 4 lanes of a quad share a row.
template <bool kAlibi>
__device__ __forceinline__ void softmax_tile(float (&sc)[kBN / 8][4], float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], const int* keep_s, bool mask,
                                             int k0, const int (&row)[2], int t, float slope) {
  if constexpr (kAlibi) {
    const int base[2] = {k0 + 2 * t - row[0], k0 + 2 * t - row[1]};
    add_alibi<kBN, 1>(sc, slope, base);
  }
  if (mask) {
#pragma unroll
    for (int n = 0; n < kBN / 8; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = n * 8 + 2 * t + (c & 1);
        if (!(keep_s[col] && k0 + col <= row[c >> 1])) sc[n][c] = kNegInf;
      }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float mx = kNegInf;
#pragma unroll
    for (int n = 0; n < kBN / 8; ++n) mx = fmaxf(mx, fmaxf(sc[n][2 * i], sc[n][2 * i + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_cur = fmaxf(m[i], mx);
    const float m_safe = m_cur == kNegInf ? 0.f : m_cur;
    alpha[i] = m[i] == kNegInf ? 0.f : ex2(m[i] - m_safe);
    float sum = 0.f;
#pragma unroll
    for (int n = 0; n < kBN / 8; ++n) {
      sc[n][2 * i] = ex2(sc[n][2 * i] - m_safe);
      sc[n][2 * i + 1] = ex2(sc[n][2 * i + 1] - m_safe);
      sum += sc[n][2 * i] + sc[n][2 * i + 1];
    }
    l[i] = alpha[i] * l[i] + sum;
    m[i] = m_cur;
  }
}

template <int HD, bool kAlibi, int kSched>
__global__ void __launch_bounds__(Smem<HD, (kSched & kThreeGroups) ? 3 : 2>::kThreads, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                       const __grid_constant__ CUtensorMap k_map,
                       const __grid_constant__ CUtensorMap v_map, const int* __restrict__ keep,
                       const float* __restrict__ slopes, bf16* __restrict__ out,
                       float* __restrict__ lse, int S, int H, int kvH) {
  constexpr int kWG = (kSched & kThreeGroups) ? 3 : 2;  // consumer warpgroups
  using L = Smem<HD, kWG>;
  constexpr int kBoxes = L::kBoxes, kStages = L::kStages, kBM = L::kBM;
  constexpr bool kPP = (kSched & kPingPong) != 0, kOv = (kSched & kOverlap) != 0;
  static_assert(HD == 64 || kWG == 2, "form W: three consumer warpgroups at hd 64 only");
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = hopper::align1024(smem_raw);
  int* keep_s = reinterpret_cast<int*>(smem + L::kKeep);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* empty = full + kStages;
  uint64_t* q_full = empty + kStages;

  const int h = blockIdx.x, b = blockIdx.y;
  // Query tiles are cut from the end of S and taken from the last (the
  // longest key loop) to the first, so the heaviest blocks start first; the
  // partial tile, if any, is the first (rows below 0 are zero-filled and
  // never stored), the cheapest one.
  const int q0 = S - (static_cast<int>(blockIdx.z) + 1) * kBM;
  const int kvh = h / (H / kvH);
  // key tiles up to the block's last row; the last one or two cross the diagonal
  const int n_tiles = (q0 + kBM - 1) / kBN + 1;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&full[s], 32);  // the producer warp's lanes (one with the copies' bytes)
      hopper::mbar_init(&empty[s], kWG);  // one arrival per consumer warpgroup
    }
    hopper::mbar_init(q_full, 1);
    hopper::mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == kWG) {
    if constexpr (kWG == 2)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    else
      asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x >= 128 * kWG + 32) return;  // one warp loads
    const int lane = threadIdx.x & 31;
    const int* keep_b = keep == nullptr ? nullptr : keep + static_cast<int64_t>(b) * S;
    if (lane == 0) {
      hopper::prefetch_map(&q_map);
      hopper::prefetch_map(&k_map);
      hopper::prefetch_map(&v_map);
      hopper::mbar_expect_tx(q_full, kBoxes * L::kQBox);
      for (int c = 0; c < kBoxes; ++c)
        hopper::tma_load_4d(smem + L::kQ + c * L::kQBox, &q_map, q_full, c * 64, h, q0, b);
    }
    int s = 0, phase = 0;
    for (int kt = 0; kt < n_tiles; ++kt) {
      hopper::mbar_wait(&empty[s], phase ^ 1);
      const int k0 = kt * kBN;
      // the tile's keep-mask slice: 1 iff the key exists and is kept
      int* ks = keep_s + s * kBN;
#pragma unroll
      for (int e = 0; e < kBN / 32; ++e) {
        const int j = lane + 32 * e, c = k0 + j;
        ks[j] = c < S && (keep_b == nullptr || keep_b[c] != 0);
      }
      if (lane == 0) {
        hopper::mbar_expect_tx(&full[s], 2 * kBoxes * kBox);
        unsigned char* st = smem + L::kKV + s * L::kStage;
        for (int c = 0; c < kBoxes; ++c)
          hopper::tma_load_4d(st + c * kBox, &k_map, &full[s], c * 64, kvh, k0, b);
        for (int c = 0; c < kBoxes; ++c)
          hopper::tma_load_4d(st + (kBoxes + c) * kBox, &v_map, &full[s], c * 64, kvh, k0, b);
      } else {
        hopper::mbar_arrive(&full[s]);
      }
      if (++s == kStages) {
        s = 0;
        phase ^= 1;
      }
    }
    return;
  }

  // 2 x 128 x 232 + 128 x 40 or 3 x 128 x 160 + 128 x 24 registers: within the SM's 65,536
  if constexpr (kWG == 2)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  else
    asm volatile("setmaxnreg.inc.sync.aligned.u32 160;\n");
  const int warp = (threadIdx.x & 127) >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r_lo = q0 + 64 * wg;  // the warpgroup's first row
  // accumulator rows of this thread: 16 warp + g and + 8; columns 8 n + 2 t + {0, 1}
  const int row[2] = {r_lo + 16 * warp + g, r_lo + 16 * warp + g + 8};
  const float slope = kAlibi ? slopes[h] : 0.f;
  const unsigned q_addr = hopper::smem_addr(smem + L::kQ) + wg * 64 * 128;

  float o[HD / 8][4], sc[kBN / 8][4];
  uint32_t p[kBN / 16][4];  // P of the previous tile, bf16 pairs: the A fragments of P V
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) o[n][c] = 0.f;
  // m: the rows' running max; l: this thread's share of the rows' sums
  // (the 4 lanes of a row add theirs at the end)
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  if (kPP && wg == kWG - 1) bar_arrive(1, 256);  // warpgroup 0 takes the first turn
  hopper::mbar_wait(q_full, 0);
  // Q in registers with two consumer warpgroups; three have none to spare
  constexpr bool kQRegs = kWG == 2;
  uint32_t qf[kQRegs ? HD / 16 : 1][4];
  if constexpr (kQRegs) {
    // ldmatrix: lanes 0-15 name rows 0-15 of the warp's 16 at k 0-7, lanes
    // 16-31 the same rows at k 8-15 (16-byte chunk c of row r sits at c ^ (r % 8))
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const int r = 16 * warp + (lane & 15), chunk = 2 * (kk % 4) + (lane >> 4);
      ldsm_x4<false>(qf[kk], reinterpret_cast<const bf16*>(smem + L::kQ + (kk / 4) * L::kQBox +
                                                           wg * 64 * 128 + r * 128 +
                                                           ((chunk ^ (r & 7)) << 4)));
    }
  }
  const unsigned kv_addr = hopper::smem_addr(smem + L::kKV);
  const bool masked_all = keep != nullptr;  // else only the diagonal tiles and S's tail
  // The key tiles warpgroup w's rows see (at least one): fewer for the lower
  // warpgroups where a tile lies wholly above their rows' diagonal.
  const auto tiles_of = [&](int w) {
    const int last = q0 + 64 * w + 63;
    return last < 0 ? 1 : last / kBN + 1;
  };
  const int my_tiles = tiles_of(wg);
  // Tile 0: Q K^T alone. Then each turn r issues tile r's Q K^T and tile
  // r - 1's P V together; the softmax of tile r runs while P V is in flight
  // (kOv). Turn my_tiles is the last tile's P V alone. Under kPP each turn
  // at the tensor cores is this warpgroup's alone: warpgroup w waits on
  // named barrier 1 + w, and turns go round in rounds r: warpgroups 0, 1,
  // ... in order, each while r <= its tile count (which grows with w). The
  // last warpgroup gave warpgroup 0 the first turn and gives none after its
  // last; in a round where it is alone it neither hands the turn to itself
  // nor waits for it. So every barrier balances and no warpgroup arrives at
  // its own; a wrong count here hangs the launch (bar.sync does not trap),
  // so tests/test_torch_flash_attention.py models these lines on the CPU
  // (-k turn_order) and a change to them changes the model too.
  const auto take_turn = [&](int r) {
    if (kPP && !(wg == kWG - 1 && r >= 1 && tiles_of(kWG - 2) < r)) bar_sync(1 + wg, 256);
  };
  const auto hand_over = [&](int r) {
    if (!kPP) return;
    if (wg < kWG - 1) {
      bar_arrive(2 + wg, 256);
    } else if (r < my_tiles) {
      int next = 0;
      while (tiles_of(next) <= r) ++next;
      if (next != wg) bar_arrive(1 + next, 256);
    }
  };
  float alpha[2];
  hopper::mbar_wait(&full[0], 0);
  take_turn(0);
  hopper::wgmma_fence();
  if constexpr (kQRegs)
    issue_qk_rs<HD>(sc, qf, kv_addr);
  else
    issue_qk<HD, L::kQBox>(sc, q_addr, kv_addr);
  hopper::wgmma_commit();
  hand_over(0);
  hopper::wgmma_wait<0>();
  hopper::fence_operand(sc);
  softmax_tile<kAlibi>(sc, m, l, alpha, keep_s, masked_all || kBN - 1 > r_lo || kBN > S, 0, row, t,
                       slope);
  pack_frag<kBN>(p, sc);
  int s_prev = 0, s = 1 % kStages, phase = kStages == 1 ? 1 : 0;
  for (int kt = 1; kt < my_tiles; ++kt) {
    const int k0 = kt * kBN;
    hopper::mbar_wait(&full[s], phase);
    take_turn(kt);
    hopper::fence_operand(o);
    hopper::fence_operand(p);
    hopper::wgmma_fence();
    if constexpr (kQRegs)
      issue_qk_rs<HD>(sc, qf, kv_addr + s * L::kStage);
    else
      issue_qk<HD, L::kQBox>(sc, q_addr, kv_addr + s * L::kStage);
    hopper::wgmma_commit();
    issue_pv<HD>(o, p, kv_addr + s_prev * L::kStage + kBoxes * kBox);
    hopper::wgmma_commit();
    hand_over(kt);
    if (kOv)
      hopper::wgmma_wait<1>();  // Q K^T has landed; P V may still run
    else
      hopper::wgmma_wait<0>();
    hopper::fence_operand(sc);
    softmax_tile<kAlibi>(sc, m, l, alpha, keep_s + s * kBN,
                         masked_all || k0 + kBN - 1 > r_lo || k0 + kBN > S, k0, row, t,
                         slope);
    hopper::wgmma_wait<0>();
    hopper::fence_operand(o);
    hopper::fence_operand(p);
    if ((threadIdx.x & 127) == 0) hopper::mbar_arrive(&empty[s_prev]);  // tile kt - 1 is done
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }
    pack_frag<kBN>(p, sc);
    s_prev = s;
    if (++s == kStages) {
      s = 0;
      phase ^= 1;
    }
  }
  take_turn(my_tiles);
  hopper::fence_operand(o);
  hopper::fence_operand(p);
  hopper::wgmma_fence();
  issue_pv<HD>(o, p, kv_addr + s_prev * L::kStage + kBoxes * kBox);
  hopper::wgmma_commit();
  hand_over(my_tiles);
  hopper::wgmma_wait<0>();
  hopper::fence_operand(o);

  // O / l rounded to bf16 into this warpgroup's rows of the Q tile (swizzled
  // as TMA wrote Q: 16-byte chunk c of row r at chunk c ^ (r % 8)), then out
  // as whole 16-byte chunks of rows. Only this warpgroup read those rows, and
  // its products are done.
  unsigned char* staged = smem + L::kQ + wg * 64 * 128;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const float l_safe = l[i] == 0.f ? 1.f : l[i];
    const float inv = __frcp_rn(l_safe);  // within an fp32 ulp of dividing; the output is bf16
    const int r = 16 * warp + g + 8 * i;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(staged + (n / 8) * L::kQBox + r * 128 +
                                          (((n % 8) ^ (r & 7)) << 4) + t * 4) =
          __floats2bfloat162_rn(o[n][2 * i] * inv, o[n][2 * i + 1] * inv);
    if (t == 0 && row[i] >= 0)
      lse[(static_cast<int64_t>(b) * H + h) * S + row[i]] =
          l[i] == 0.f ? kNegInf : m[i] + log2f(l_safe);
  }
  bar_sync(1 + kWG + wg, 128);
  for (int i = threadIdx.x & 127; i < 64 * HD / 8; i += 128) {
    const int r = i / (HD / 8), n = i % (HD / 8), grow = r_lo + r;
    if (grow >= 0)
      *reinterpret_cast<uint4*>(out + ((static_cast<int64_t>(b) * S + grow) * H + h) * HD + n * 8) =
          *reinterpret_cast<const uint4*>(staged + (n / 8) * L::kQBox + r * 128 +
                                          (((n % 8) ^ (r & 7)) << 4));
  }
  // the block's tiles past this warpgroup's: released unread, each once it has landed
  for (int kt = my_tiles; kt < n_tiles; ++kt) {
    hopper::mbar_wait(&full[s], phase);
    if ((threadIdx.x & 127) == 0) hopper::mbar_arrive(&empty[s]);
    if (++s == kStages) {
      s = 0;
      phase ^= 1;
    }
  }
}

template <int HD, bool kAlibi, int kSched>
int launch(const void* q, const void* k, const void* v, const void* keep, const void* slopes,
           void* out, void* lse, int B, int S, int H, int kvH, cudaStream_t stream) {
  using L = Smem<HD, (kSched & kThreeGroups) ? 3 : 2>;
  const int q_tiles = (S + L::kBM - 1) / L::kBM;
  if (q_tiles > 65535) return cudaErrorInvalidValue;
  const hopper::EncodeTiled fn = hopper::encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  CUtensorMap qm, km, vm;
  if (!hopper::encode_bshd(fn, &qm, q, B, S, H, HD, L::kBM) ||
      !hopper::encode_bshd(fn, &km, k, B, S, kvH, HD, kBN) ||
      !hopper::encode_bshd(fn, &vm, v, B, S, kvH, HD, kBN))
    return cudaErrorInvalidValue;
  static bool smem_set[hopper::kMaxDevices];
  const auto kernel = flash_fwd_wgmma_kernel<HD, kAlibi, kSched>;
  const cudaError_t err =
      hopper::allow_smem(reinterpret_cast<const void*>(kernel), L::kBytes, smem_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(H, B, q_tiles), L::kThreads, L::kBytes, stream>>>(
      qm, km, vm, static_cast<const int*>(keep), static_cast<const float*>(slopes),
      static_cast<bf16*>(out), static_cast<float*>(lse), S, H, kvH);
  return static_cast<int>(cudaGetLastError());
}

// Form W: bf16 q, k, v (every pointer 16-byte aligned, as the wrapper
// checks), under default_schedule(hd).
int run(const void* q, const void* k, const void* v, const void* keep, const void* slopes,
        void* out, void* lse, int B, int S, int H, int kvH, int hd, cudaStream_t stream) {
  constexpr int k64 = default_schedule(64), k128 = default_schedule(128);
  const bool alibi = slopes != nullptr;
  if (hd == 64)
    return alibi ? launch<64, true, k64>(q, k, v, keep, slopes, out, lse, B, S, H, kvH, stream)
                 : launch<64, false, k64>(q, k, v, keep, slopes, out, lse, B, S, H, kvH, stream);
  if (hd == 128)
    return alibi ? launch<128, true, k128>(q, k, v, keep, slopes, out, lse, B, S, H, kvH, stream)
                 : launch<128, false, k128>(q, k, v, keep, slopes, out, lse, B, S, H, kvH, stream);
  return cudaErrorInvalidValue;
}

}  // namespace form_w

// form codes, shared with ops/flash_attention.py FWD_FORMS
enum Form { kSimt = 0, kMma = 1, kWgmma = 2 };

}  // namespace

// See flash_attention.cuh for the dtype codes and layouts. form: 0 SIMT
// (fp32), 1 mma.sync (bf16), 2 form W (bf16; every pointer 16-byte
// aligned). Returns cudaErrorInvalidValue for what the form does not take,
// else cudaGetLastError() after the launch.
extern "C" int ds_flash_fwd(const void* q, const void* k, const void* v, const void* keep,
                            const void* slopes, void* out, void* lse, int B, int S, int H,
                            int kvH, int hd, int dtype, int form, void* stream) {
  if (bad_shape(B, S, H, kvH)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (form == kWgmma && dtype == 1)
    return form_w::run(q, k, v, keep, slopes, out, lse, B, S, H, kvH, hd, s);
  if (!((form == kSimt && dtype == 0) || (form == kMma && dtype == 1)))
    return cudaErrorInvalidValue;
#define DS_CALL(T, HD) launch_fwd<T, HD>(q, k, v, keep, slopes, out, lse, B, S, H, kvH, s)
  DS_FLASH_DISPATCH(DS_CALL);
#undef DS_CALL
}

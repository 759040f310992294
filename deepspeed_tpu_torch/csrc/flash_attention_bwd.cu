// ds_flash_bwd: form W of the causal GQA flash-attention backward, written by
// hand for Hopper (sm_90a): dq, dk and dv from one kernel. Replaces both
// backward kernels of deepspeed_tpu/ops/pallas/flash_attention.py,
// _bwd_dq_kernel (:364) and _bwd_dkv_kernel (:432), with and without ALiBi
// (the kAlibi form adds _alibi_add's bias, :158, in its relative form). The
// function (pre-scaled q, base-2 softmax, masks, sentinels, ALiBi, dS cast to
// the operand dtype, dq times hd^-0.5 and dk times ln 2 in fp32) is set out in
// flash_attention.cuh; the pair ds_flash_bwd_dq + ds_flash_bwd_dkv computes
// the same and stays as the "mma" (bf16) and "simt" (fp32) forms. bf16 only.
//
// What bounds it: operations. At the Llama-3.2-1B training shape (B 4, S
// 2048, H 32, kvH 8, hd 64) its five products over the causal pairs are
// 171.9 GFLOP (0.1738 ms at 989 TFLOP/s) on ~92 MB of inputs and outputs
// (0.03 ms at 3.35 TB/s; the fp32 dq accumulator adds ~1 GB of reduce-adds,
// most of it in L2). The exp2 of each of the 268 M causal scores costs the
// SFU about 0.069 ms, and at hd 64 shared memory feeds the products at close
// to its 128 bytes a clock.
//
// The TPU kernels are two sequential grids, each with its accumulator in
// VMEM, so the dq one recomputes the scores and dP that the dkv one computes
// (seven products). Hopper adds shared memory into device memory without a
// read-modify-write by the threads (cp.reduce.async.bulk .add.f32), so one
// kernel owns a key tile and computes all five products once:
//   * Grid (kv head, batch, key tile), one block a 128-key tile, the tiles
//     near the start of S (which see the most query tiles) launched first.
//     The block walks the query tiles from the end of S back to its diagonal
//     (128 rows at hd 64, 64 at hd 128) and, within each, the G query heads
//     of its kv head. It keeps dK and dV in registers and writes them once,
//     summed over the group, with no atomics, so dk and dv are deterministic.
//   * One producer warp loads K and V once by TMA and keeps a 2-stage ring of
//     (Q, dO) tiles full (4-D maps (hd, heads, S, B), 64-column boxes,
//     128-byte swizzle; rows outside [0, S) zero-fill within their batch
//     entry), writing each step's lse (sentinel read as 0) and delta slices
//     beside it (0 past S). setmaxnreg moves registers to the consumers.
//   * Two consumer warpgroups each own 64 of the keys (rows) and work alone
//     on them:
//       1. S^T  = K Q^T      wgmma SS, K-major K and Q
//       2. dP^T = V dO^T     wgmma SS, K-major V and dO
//       (P^T = exp2(S^T - lse), masked; dS^T = P^T (dP^T - delta))
//       3. dV  += P^T dO     wgmma RS: P^T from the accumulator, dO MN-major
//       4. dK  += dS^T Q     wgmma RS: dS^T from the accumulator, Q MN-major
//       5. dQ_w = dS_w K_w   wgmma SS over the warpgroup's own 64 keys: its
//          dS^T rows written to its own shared memory (64-query boxes,
//          128-byte swizzle, read MN-major), K MN-major; at hd 64 taken
//          transposed (dQ_w^T = K_w^T dS_w^T) so that it is one m64n128
//          product at both head dims.
//     Splitting product 5 by key leaves no operand shared between the
//     warpgroups, so they need not meet each step; they take turns at the
//     tensor cores instead (named barriers 1 and 2: a warpgroup issues
//     products 1-2, or 3-5, then hands the turn over), so that one's
//     elementwise work (mask, exp2, dS, the casts, the stores) runs while
//     the other's products do. (A first build shared dS^T between the two
//     warpgroups for a 128-key product 5 and met before it each step: the
//     meeting kept them in step, and the elementwise work of both left the
//     tensor cores idle.)
//   * Each warpgroup's dQ partial (kBQ x hd fp32) goes to shared memory in
//     the accumulator's own order (thread-interleaved float4s, no bank
//     conflicts) and is added into the fp32 scratch dq_acc by a bulk
//     reduce-add; at hd 64 the two partials are first summed by halves (both
//     warpgroups meet on named barrier 5 a step), halving the reduce-add
//     traffic. dq_acc
//     [B, H, S_pad, hd] (S_pad: S rounded up to 128) keeps each tile in that
//     order. The reduce-adds land in any order, so
//     dq's fp32 sums vary from run to run in their last bits. A second
//     kernel reads dq_acc once, un-permutes it, scales by hd^-0.5 and writes
//     dq in the input dtype, rows staged in shared memory for whole-row
//     stores.
//   * No divergent branch runs while a wgmma is in flight (a wgmma pipeline
//     that crosses one is serialised, ptxas C7514/C7520); the score products'
//     first k-step takes its accumulator as an output only, product 5's
//     accumulator comes in zeroed.
// A phase not completed in 10 s traps (hopper.cuh mbar_wait), so a lost copy
// fails the launch instead of holding the card; a named-barrier miscount
// would hang instead, so the turn order has a CPU model in
// tests/test_torch_flash_attention.py (-k bwd_turn_order).

#include "flash_attention.cuh"
#include "hopper.cuh"

using namespace ds_flash;

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kBK = 128;               // keys a block: two consumer warpgroups of 64
constexpr int kKBox = kBK * 128;       // 16 KB: a 64-column box of a K or V tile
constexpr int kStages = 2;             // the (Q, dO) ring
constexpr int kBlockThreads = 384;     // two consumer warpgroups, then the producer's
constexpr int kTileFloats = 128 * 64;  // a query tile of dq: kBQ x hd fp32, 32 KB
constexpr int kPadRows = 128;          // dq_acc's rows a (b, h): S rounded up to this

inline __host__ __device__ int padded_rows(int S) { return (S + kPadRows - 1) / kPadRows * kPadRows; }

template <int HD>
struct Smem {  // byte offsets from the 1024-aligned base
  static constexpr int kBQ = HD == 64 ? 128 : 64;        // query rows a step
  static constexpr int kBoxes = HD / 64;                 // 64-column boxes a row
  static constexpr int kQBox = kBQ * 128;                // one box of a Q or dO tile
  static constexpr int kK = 0;
  static constexpr int kV = kK + kBoxes * kKBox;
  static constexpr int kRing = kV + kBoxes * kKBox;      // stage s: Q's boxes, then dO's
  static constexpr int kStage = 2 * kBoxes * kQBox;
  // a warpgroup's dS^T: 64-query boxes of its 64 key rows (8 KB a box)
  static constexpr int kDSBuf = kBQ / 64 * 8192;
  static constexpr int kDS = kRing + kStages * kStage;   // a buffer a consumer warpgroup
  static constexpr int kDQ = kDS + 2 * kDSBuf;           // a staged dQ tile a consumer warpgroup
  static constexpr int kRows = kDQ + 2 * kTileFloats * 4;  // float [kStages][lse, delta][kBQ]
  static constexpr int kBars = kRows + kStages * 2 * kBQ * 4;  // full, empty, kv_full
  static constexpr int kBytes = kBars + (2 * kStages + 1) * 8 + 1024;
  static_assert(kBQ * HD == kTileFloats, "form W backward: a query tile of dq");
  static_assert(kBytes <= 232448, "form W backward: shared memory");
};

// acc (this warpgroup's 64 rows of a K or V tile) x (a Q or dO tile)^T over
// hd: S^T or dP^T, 64 keys x kBQ queries. Both operands K-major (hd
// contiguous), 8-row groups 1024 bytes apart; k-step kk reads columns [16 kk,
// 16 kk + 16), 32 bytes into the swizzled rows of box kk / 4.
template <int HD>
__device__ __forceinline__ void issue_scores(float (&d)[Smem<HD>::kBQ / 8][4], unsigned a_addr,
                                             unsigned b_addr) {
  constexpr int kQBox = Smem<HD>::kQBox;
  const auto desc = [](unsigned addr) { return hopper::wgmma_desc(addr, 16, 1024); };
  if constexpr (HD == 64) {
    hopper::wgmma_m64n128k16_ss<false>(d, desc(a_addr), desc(b_addr));
#pragma unroll
    for (int kk = 1; kk < 4; ++kk)
      hopper::wgmma_m64n128k16_ss<true>(d, desc(a_addr + kk * 32), desc(b_addr + kk * 32));
  } else {
    hopper::wgmma_m64n64k16_ss<false, 0>(d, desc(a_addr), desc(b_addr));
#pragma unroll
    for (int kk = 1; kk < HD / 16; ++kk) {
      const unsigned col = (kk % 4) * 32;
      hopper::wgmma_m64n64k16_ss<true, 0>(d, desc(a_addr + (kk / 4) * kKBox + col),
                                          desc(b_addr + (kk / 4) * kQBox + col));
    }
  }
}

// acc (64 keys x hd) += A (64 keys x kBQ queries, from registers: P^T or
// dS^T) x (a dO or Q tile, kBQ x hd, MN-major): k-step kk reads the tile's
// rows [16 kk, 16 kk + 16), 2 KB further into each box; boxes kQBox apart.
template <int HD>
__device__ __forceinline__ void issue_grad(float (&d)[HD / 8][4],
                                           const uint32_t (&a)[Smem<HD>::kBQ / 16][4],
                                           unsigned b_addr) {
#pragma unroll
  for (int kk = 0; kk < Smem<HD>::kBQ / 16; ++kk) {
    const uint64_t desc = hopper::wgmma_desc(b_addr + kk * 2048, Smem<HD>::kQBox, 1024);
    if constexpr (HD == 64)
      hopper::wgmma_m64n64k16_rs_t(d, a[kk], desc, 1);
    else
      hopper::wgmma_m64n128k16_rs_t(d, a[kk], desc, 1);
  }
}

// Product 5 over this warpgroup's 64 keys, one m64n128 accumulator at both
// head dims: at hd 128, dQ_w (64 queries x 128) = dS_w (64 queries x 64
// keys) K_w (64 keys x 128); at hd 64 it is taken transposed, dQ_w^T (64 x
// 128 queries) = K_w^T (64 x 64 keys) dS_w^T (64 keys x 128 queries): a
// build with two 64-query accumulators (m64n64 each) ran the whole kernel
// much slower. Operands: the warpgroup's dS^T (64-query boxes of its 64
// key rows, 8 KB a box) and its 64 rows of the K tile, both MN-major (key
// rows 128 bytes apart, 8-row groups 1024); k-step kk reads keys [16 kk, 16
// kk + 16).
template <int HD>
__device__ __forceinline__ void issue_dq(float (&d)[16][4], unsigned ds_addr, unsigned k_addr) {
  const auto ds = [&](int kk) { return hopper::wgmma_desc(ds_addr + kk * 2048, 8192, 1024); };
  const auto kw = [&](int kk) { return hopper::wgmma_desc(k_addr + kk * 2048, kKBox, 1024); };
  if constexpr (HD == 64) {
    hopper::wgmma_m64n128k16_ss<false, 1>(d, kw(0), ds(0));
#pragma unroll
    for (int kk = 1; kk < 4; ++kk) hopper::wgmma_m64n128k16_ss<true, 1>(d, kw(kk), ds(kk));
  } else {
    hopper::wgmma_m64n128k16_ss<false, 1>(d, ds(0), kw(0));
#pragma unroll
    for (int kk = 1; kk < 4; ++kk) hopper::wgmma_m64n128k16_ss<true, 1>(d, ds(kk), kw(kk));
  }
}

template <int HD, bool kAlibi>
__global__ void __launch_bounds__(kBlockThreads, 1)
flash_bwd_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                       const __grid_constant__ CUtensorMap k_map,
                       const __grid_constant__ CUtensorMap v_map,
                       const __grid_constant__ CUtensorMap do_map, const int* __restrict__ keep,
                       const float* __restrict__ slopes, const float* __restrict__ lse,
                       const float* __restrict__ delta, float* __restrict__ dq_acc,
                       bf16* __restrict__ dk, bf16* __restrict__ dv, int S, int H, int kvH,
                       float dk_scale) {
  using L = Smem<HD>;
  constexpr int kBQ = L::kBQ, kBoxes = L::kBoxes;
  constexpr bool kPairSum = HD == 64;  // the two dQ partials summed before they leave
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = hopper::align1024(smem_raw);
  float* rows_s = reinterpret_cast<float*>(smem + L::kRows);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* empty = full + kStages;
  uint64_t* kv_full = empty + kStages;

  const int kvh = blockIdx.x, b = blockIdx.y;
  const int k0 = blockIdx.z * kBK;  // key tile 0, which sees every query tile, first
  const int G = H / kvH;
  // (query tile, query head) steps: the tiles from the end of S back to the
  // diagonal, the G heads within a tile. Every block starts at the end of S
  // and they advance at about one rate, so the blocks resident together add
  // into a few query tiles of dq_acc (which at 67 MB, the Llama-3.2-1B
  // shape, does not fit the 50 MB L2) and read a few tiles of Q and dO. (It
  // times the same as the heads outermost there: tools/flash_bwd_variants.py,
  // heads_outer.)
  const int last_qt = (S + kBQ - 1) / kBQ - 1;
  const int n_steps = G * (last_qt - k0 / kBQ + 1);
  const auto step_tile = [&](int step, int& h, int& q0) {
    h = kvh * G + step % G;
    q0 = (last_qt - step / G) * kBQ;
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&full[s], 32);  // the producer warp's lanes (one with the copies' bytes)
      hopper::mbar_init(&empty[s], 2);  // one arrival per consumer warpgroup
    }
    hopper::mbar_init(kv_full, 1);
    hopper::mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x >= 256 + 32) return;  // one warp loads
    const int lane = threadIdx.x & 31;
    if (lane == 0) {
      hopper::prefetch_map(&q_map);
      hopper::prefetch_map(&k_map);
      hopper::prefetch_map(&v_map);
      hopper::prefetch_map(&do_map);
      hopper::mbar_expect_tx(kv_full, 2 * kBoxes * kKBox);
      for (int c = 0; c < kBoxes; ++c) {
        hopper::tma_load_4d(smem + L::kK + c * kKBox, &k_map, kv_full, c * 64, kvh, k0, b);
        hopper::tma_load_4d(smem + L::kV + c * kKBox, &v_map, kv_full, c * 64, kvh, k0, b);
      }
    }
    int s = 0, phase = 0;
    for (int step = 0; step < n_steps; ++step) {
      int h, q0;
      step_tile(step, h, q0);
      hopper::mbar_wait(&empty[s], phase ^ 1);
      // the step's lse (the no-key sentinel read as 0) and delta; 0 past S
      float* rs = rows_s + s * 2 * kBQ;
      const int64_t row0 = (static_cast<int64_t>(b) * H + h) * S;
#pragma unroll
      for (int e = 0; e < kBQ / 32; ++e) {
        const int j = lane + 32 * e, r = q0 + j;
        const float x = r < S ? lse[row0 + r] : 0.f;
        rs[j] = x == kNegInf ? 0.f : x;
        rs[kBQ + j] = r < S ? delta[row0 + r] : 0.f;
      }
      if (lane == 0) {
        hopper::mbar_expect_tx(&full[s], 2 * kBoxes * L::kQBox);
        unsigned char* st = smem + L::kRing + s * L::kStage;
        for (int c = 0; c < kBoxes; ++c) {
          hopper::tma_load_4d(st + c * L::kQBox, &q_map, &full[s], c * 64, h, q0, b);
          hopper::tma_load_4d(st + (kBoxes + c) * L::kQBox, &do_map, &full[s], c * 64, h, q0, b);
        }
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

  // 2 x 128 x 232 + 128 x 40 registers: within the SM's 65,536
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int k_lo = k0 + 64 * wg;  // the warpgroup's first key
  // accumulator rows of this thread: keys 16 warp + g and + 8; columns 8 n + 2 t + {0, 1}
  const int key[2] = {k_lo + 16 * warp + g, k_lo + 16 * warp + g + 8};
  bool kept[2];  // the key exists and the keep-mask keeps it
#pragma unroll
  for (int i = 0; i < 2; ++i)
    kept[i] = key[i] < S && (keep == nullptr || keep[static_cast<int64_t>(b) * S + key[i]] != 0);
  const int pad_rows = padded_rows(S);

  // this warpgroup's rows of the K and V tiles (8 KB into each 64-column box)
  const unsigned k_addr = hopper::smem_addr(smem + L::kK) + wg * 8192;
  const unsigned v_addr = hopper::smem_addr(smem + L::kV) + wg * 8192;
  const unsigned ring = hopper::smem_addr(smem + L::kRing);
  unsigned char* ds = smem + L::kDS + wg * L::kDSBuf;  // this warpgroup's dS^T
  const unsigned ds_addr = hopper::smem_addr(ds);
  float4* staged = reinterpret_cast<float4*>(smem + L::kDQ + wg * kTileFloats * 4);

  float dka[HD / 8][4], dva[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) dka[n][c] = dva[n][c] = 0.f;

  // Turns at the tensor cores: warpgroup w waits (bar.sync) on named barrier
  // 1 + w and the other hands it the turn (bar.arrive); two turns a step
  // (products 1-2, then 3-5). Warpgroup 1 gives warpgroup 0 the first turn
  // and none after its own last, so every barrier balances; a wrong count
  // here hangs the launch (bar.sync does not trap), so
  // tests/test_torch_flash_attention.py models these lines on the CPU (-k
  // bwd_turn_order) and a change to them changes the model too.
  if (wg == 1) hopper::bar_arrive(1, 256);  // warpgroup 0 takes the first turn
  const auto take_turn = [&]() { hopper::bar_sync(1 + wg, 256); };
  const auto hand_over = [&](bool last) {
    if (!(wg == 1 && last)) hopper::bar_arrive(2 - wg, 256);
  };

  hopper::mbar_wait(kv_full, 0);
  int s = 0, phase = 0;
  for (int step = 0; step < n_steps; ++step) {
    int h, q0;
    step_tile(step, h, q0);
    const unsigned q_addr = ring + s * L::kStage, do_addr = q_addr + kBoxes * L::kQBox;
    const float* rs = rows_s + s * 2 * kBQ;
    float sc[kBQ / 8][4], dp[kBQ / 8][4];
    hopper::mbar_wait(&full[s], phase);
    take_turn();
    hopper::wgmma_fence();
    issue_scores<HD>(sc, k_addr, q_addr);
    hopper::wgmma_commit();
    issue_scores<HD>(dp, v_addr, do_addr);
    hopper::wgmma_commit();
    hand_over(false);

    // P^T = exp2(S^T - lse) while dP^T is in flight: the ALiBi bias (every
    // tile, before the mask; rows are keys, so slope * (key - query) with the
    // query head's slope), then the mask where the tile needs one (key <=
    // query, the key kept, the query < S)
    hopper::wgmma_wait<1>();
    hopper::fence_operand(sc);
    if constexpr (kAlibi) {
      const int base[2] = {key[0] - q0 - 2 * t, key[1] - q0 - 2 * t};
      add_alibi<kBQ, -1>(sc, slopes[h], base);
    }
#pragma unroll
    for (int n = 0; n < kBQ / 8; ++n) {
      const float2 l2 = *reinterpret_cast<const float2*>(rs + 8 * n + 2 * t);
#pragma unroll
      for (int c = 0; c < 4; ++c) sc[n][c] = ex2(sc[n][c] - ((c & 1) ? l2.y : l2.x));
    }
    if (keep != nullptr || q0 < k_lo + 63 || q0 + kBQ > S) {  // a pass of its own: most tiles skip it
#pragma unroll
      for (int n = 0; n < kBQ / 8; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int q = q0 + 8 * n + 2 * t + (c & 1);
          if (!(kept[c >> 1] && key[c >> 1] <= q && q < S)) sc[n][c] = 0.f;
        }
    }
    // dS^T = P^T (dP^T - delta)
    hopper::wgmma_wait<0>();
    hopper::fence_operand(dp);
#pragma unroll
    for (int n = 0; n < kBQ / 8; ++n) {
      const float2 d2 = *reinterpret_cast<const float2*>(rs + kBQ + 8 * n + 2 * t);
#pragma unroll
      for (int c = 0; c < 4; ++c) dp[n][c] = sc[n][c] * (dp[n][c] - ((c & 1) ? d2.y : d2.x));
    }
    uint32_t pf[kBQ / 16][4], dsf[kBQ / 16][4];  // P^T, dS^T in bf16: A fragments
    pack_frag<kBQ>(pf, sc);
    pack_frag<kBQ>(dsf, dp);
    // dS^T for product 5: entry (key row r of this warpgroup, query c) in
    // 64-query box c / 64, row r 128 bytes, 16-byte chunk (c % 64) / 8 at
    // chunk ^ (r % 8) (the 128-byte swizzle); dsf[j][i] holds row
    // 16 warp + g + 8 (i & 1), queries 16 j + 8 (i >> 1) + 2 t and + 1. The
    // buffer's last reader, this warpgroup's product 5 of the last step, is done.
#pragma unroll
    for (int j = 0; j < kBQ / 16; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = 16 * warp + g + 8 * (i & 1), c = 16 * j + 8 * (i >> 1);
        *reinterpret_cast<uint32_t*>(ds + (c / 64) * 8192 + r * 128 +
                                     ((((c % 64) / 8) ^ (r & 7)) << 4) + 4 * t) = dsf[j][i];
      }
    hopper::fence_proxy_async();
    if (tid == 0) hopper::bulk_wait_read<0>();  // the last step's dQ partial has left `staged`
    hopper::bar_sync(3 + wg, 128);  // the warpgroup's dS^T rows are written and `staged` is free

    // products 3-4 are waited for before product 5 is issued: P^T and dS^T
    // are then retired before product 5's 64 accumulator registers are taken
    // (at hd 128 dK and dV hold 128); issued behind 3-4 in flight, product 5
    // is much slower at hd 64 (tools/flash_bwd_variants.py, p5_in_flight)
    float dqa[16][4];
    take_turn();
    hopper::fence_operand(dka);
    hopper::fence_operand(dva);
    hopper::wgmma_fence();
    issue_grad<HD>(dva, pf, do_addr);
    issue_grad<HD>(dka, dsf, q_addr);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_operand(pf);
    hopper::fence_operand(dsf);
    hopper::wgmma_fence();
    issue_dq<HD>(dqa, ds_addr, k_addr);
    hopper::wgmma_commit();
    hand_over(step + 1 == n_steps);
    hopper::wgmma_wait<0>();
    hopper::fence_operand(dka);
    hopper::fence_operand(dva);
    hopper::fence_operand(dqa);
    if (tid == 0) hopper::mbar_arrive(&empty[s]);  // this step's Q and dO are read

    // The dQ partial in the accumulator's order (float4 n of thread tid at n
    // * 128 + tid), then added into dq_acc by a bulk reduce-add. At hd 64 the
    // two warpgroups' partials are summed first: both meet on named barrier
    // 5, warpgroup w adds the two for n in [8 w, 8 w + 8) into its own buffer
    // and one thread reduce-adds that 16 KB, half the traffic of a whole
    // partial a warpgroup; at hd 128 the meeting costs more than the traffic
    // saves, so each warpgroup adds its own (tools/flash_bwd_variants.py:
    // own_reduce_hd64, pair_sum_hd128). A buffer is written again after its
    // owner's next turn, which comes after the other warpgroup has read it.
#pragma unroll
    for (int n = 0; n < 16; ++n)
      staged[n * 128 + tid] = make_float4(dqa[n][0], dqa[n][1], dqa[n][2], dqa[n][3]);
    if constexpr (kPairSum) {
      hopper::bar_sync(5, 256);
      const float4* other =
          reinterpret_cast<const float4*>(smem + L::kDQ + (1 - wg) * kTileFloats * 4);
#pragma unroll
      for (int n = 8 * wg; n < 8 * wg + 8; ++n) {
        const float4 a = staged[n * 128 + tid], o = other[n * 128 + tid];
        staged[n * 128 + tid] = make_float4(a.x + o.x, a.y + o.y, a.z + o.z, a.w + o.w);
      }
    }
    hopper::fence_proxy_async();
    hopper::bar_sync(3 + wg, 128);
    if (tid == 0) {
      float* dst = dq_acc + ((static_cast<int64_t>(b) * H + h) * pad_rows + q0) * HD;
      if constexpr (kPairSum)
        hopper::bulk_reduce_add_f32(dst + wg * kTileFloats / 2, staged + wg * 1024, kTileFloats * 2);
      else
        hopper::bulk_reduce_add_f32(dst, staged, kTileFloats * 4);
      hopper::bulk_commit();
    }
    if (++s == kStages) {
      s = 0;
      phase ^= 1;
    }
  }
  if (tid == 0) hopper::bulk_wait<0>();  // the last add has read `staged`

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (key[i] >= S) continue;
    bf16* dkr = dk + ((static_cast<int64_t>(b) * S + key[i]) * kvH + kvh) * HD;
    bf16* dvr = dv + ((static_cast<int64_t>(b) * S + key[i]) * kvH + kvh) * HD;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      store_pair(dkr + 8 * n + 2 * t, dka[n][2 * i] * dk_scale, dka[n][2 * i + 1] * dk_scale);
      store_pair(dvr + 8 * n + 2 * t, dva[n][2 * i], dva[n][2 * i + 1]);
    }
  }
}

// dq = dq_acc * scale in bf16, [B, S, H, hd]: one block a query tile of one
// head. Float4 f of a tile is entries 4 (f / 128) .. + 3 of thread f % 128's
// m64n128 accumulator (rows 16 (thread / 32) + (thread % 32) / 4 and + 8,
// columns 8 (f / 128) + 2 (thread % 4) and + 1), as the main kernel staged
// it: rows are queries and columns hd at hd 128, the other way round at hd
// 64. The rows pass through shared memory so that each goes out whole, 16
// bytes a thread.
template <int HD>
__global__ void __launch_bounds__(256)
flash_bwd_dq_out_kernel(const float* __restrict__ dq_acc, bf16* __restrict__ dq, int S, int H,
                        float scale) {
  constexpr int kBQ = Smem<HD>::kBQ, kLd = HD + 8;  // rows padded: no bank conflicts
  __shared__ __align__(16) bf16 rows[kBQ * kLd];
  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const float4* src = reinterpret_cast<const float4*>(
      dq_acc + ((static_cast<int64_t>(b) * H + h) * padded_rows(S) + q0) * HD);
  for (int f = threadIdx.x; f < kTileFloats / 4; f += 256) {
    const int thr = f & 127;
    const int r = 16 * (thr >> 5) + ((thr & 31) >> 2), c = 8 * (f >> 7) + 2 * (thr & 3);
    const float4 x = src[f];
    if constexpr (HD == 128) {  // (query r, hd c)
      store_pair(rows + r * kLd + c, x.x * scale, x.y * scale);
      store_pair(rows + (r + 8) * kLd + c, x.z * scale, x.w * scale);
    } else {  // (hd r, query c)
      rows[c * kLd + r] = __float2bfloat16_rn(x.x * scale);
      rows[(c + 1) * kLd + r] = __float2bfloat16_rn(x.y * scale);
      rows[c * kLd + r + 8] = __float2bfloat16_rn(x.z * scale);
      rows[(c + 1) * kLd + r + 8] = __float2bfloat16_rn(x.w * scale);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kBQ * HD / 8; i += 256) {
    const int r = i / (HD / 8), c = (i % (HD / 8)) * 8;
    if (q0 + r < S)
      *reinterpret_cast<uint4*>(dq + ((static_cast<int64_t>(b) * S + q0 + r) * H + h) * HD + c) =
          *reinterpret_cast<const uint4*>(rows + r * kLd + c);
  }
}

template <int HD, bool kAlibi>
int launch(const void* q, const void* k, const void* v, const void* keep, const void* slopes,
           const void* dout, const void* lse, const void* delta, void* dq_acc, void* dq, void* dk,
           void* dv, int B, int S, int H, int kvH, float scale, float dk_scale,
           cudaStream_t stream) {
  using L = Smem<HD>;
  const int k_tiles = (S + kBK - 1) / kBK;
  if (k_tiles > 65535) return cudaErrorInvalidValue;
  const hopper::EncodeTiled fn = hopper::encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  CUtensorMap qm, km, vm, dom;
  if (!hopper::encode_bshd(fn, &qm, q, B, S, H, HD, L::kBQ) ||
      !hopper::encode_bshd(fn, &dom, dout, B, S, H, HD, L::kBQ) ||
      !hopper::encode_bshd(fn, &km, k, B, S, kvH, HD, kBK) ||
      !hopper::encode_bshd(fn, &vm, v, B, S, kvH, HD, kBK))
    return cudaErrorInvalidValue;
  static bool smem_set[hopper::kMaxDevices];
  const auto kernel = flash_bwd_wgmma_kernel<HD, kAlibi>;
  cudaError_t err = hopper::allow_smem(reinterpret_cast<const void*>(kernel), L::kBytes, smem_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaMemsetAsync(dq_acc, 0,
                        static_cast<size_t>(B) * H * padded_rows(S) * HD * sizeof(float), stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(kvH, B, k_tiles), kBlockThreads, L::kBytes, stream>>>(
      qm, km, vm, dom, static_cast<const int*>(keep), static_cast<const float*>(slopes),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dq_acc), static_cast<bf16*>(dk), static_cast<bf16*>(dv), S, H, kvH,
      dk_scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dq_out_kernel<HD><<<dim3((S + L::kBQ - 1) / L::kBQ, H, B), 256, 0, stream>>>(
      static_cast<const float*>(dq_acc), static_cast<bf16*>(dq), S, H, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Form W of the backward: bf16 q, k, v, dout [B, S, heads, hd] (every pointer
// 16-byte aligned), fp32 lse and delta [B, H, S], keep int32 [B, S] or NULL,
// slopes fp32 [H] (times log2(e)) or NULL; dq_acc fp32 scratch of B * H *
// S_pad * hd floats (S_pad: S rounded up to 128), zeroed here. Writes dq
// (times `scale`), dk (times `dk_scale`, summed over each kv head's query
// heads) and dv in bf16: the memset, the main kernel, then the dq conversion,
// on `stream`. Returns cudaErrorInvalidValue for what it does not take, else
// the first error of the three.
extern "C" int ds_flash_bwd(const void* q, const void* k, const void* v, const void* keep,
                            const void* slopes, const void* dout, const void* lse,
                            const void* delta, void* dq_acc, void* dq, void* dk, void* dv, int B,
                            int S, int H, int kvH, int hd, float scale, float dk_scale, int dtype,
                            void* stream) {
  if (bad_shape(B, S, H, kvH) || dtype != 1) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool alibi = slopes != nullptr;
#define DS_CALL(HD, A)                                                                          \
  launch<HD, A>(q, k, v, keep, slopes, dout, lse, delta, dq_acc, dq, dk, dv, B, S, H, kvH, scale, \
                dk_scale, st)
  if (hd == 64) return alibi ? DS_CALL(64, true) : DS_CALL(64, false);
  if (hd == 128) return alibi ? DS_CALL(128, true) : DS_CALL(128, false);
#undef DS_CALL
  return cudaErrorInvalidValue;
}

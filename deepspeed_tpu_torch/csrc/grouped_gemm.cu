// Grouped matmul of expert-contiguous rows, written by hand for Hopper (sm_90a).
//
// Replaces: JAX's megablox `gmm` Pallas kernel, reached through
// deepspeed_tpu/inference/model.py:234 _gmm_padded (from :253 _grouped_matmul,
// called by :266 _moe_ragged). Same function: out[rows of g] = lhs[rows of g]
// @ rhs[g], the rows of lhs [m, K] laid out group after group by
// group_sizes [E] (int32, on the device), rhs [E, K, N], products summed in
// fp32 and the result rounded once to lhs's dtype. Rows past the sum of the
// sizes are written 0 (lax.ragged_dot's rule); a negative size counts as 0.
//
// Four forms, one function. The wrapper (ops/grouped_matmul.py) picks one on
// the host from (dtype, m, K, N, alignment), never from the group sizes:
//
// - Form P ("wgmma", bf16 prefill). What bounds it: operations. Mixtral's up
//   projection at 8192 routed rows x 4096 x 14336 is 0.96 TFLOP (~0.97 ms at
//   989 TFLOP/s) against ~1.24 GB (~0.37 ms). Only wgmma reaches Hopper's full
//   tensor rate, so: 128 x 256 output tiles, k-steps of 64 (one 128-byte
//   swizzle row); two consumer warpgroups of 64 rows each issue
//   wgmma.m64n256k16 from shared memory with fp32 accumulators in registers;
//   one producer thread keeps a 4-stage ring full with TMA (A through a 2-D
//   map of lhs, box 128 x 64; B through a 3-D map (N, K, E) of rhs, boxes
//   64 x 64, so that a k-box past K is zero-filled instead of reading the next
//   expert's rows), guarded by full/empty mbarriers; setmaxnreg moves
//   registers from the producer to the consumers. B is N-contiguous, so its
//   wgmma descriptor is MN-major (the transpose bit). Blocks walk m-tiles
//   16 at a time per n-tile column so that the blocks in flight share lhs rows
//   and weight columns in L2. The outputs are staged through the free ring
//   and stored as whole 16-byte chunks of rows, not as the accumulator
//   layout's scattered 4-byte pairs. What holds it back now: L2 to
//   shared-memory traffic (48 KB a k-step per tile, no multicast) and one
//   tile per block (the epilogue and the ring's fill are not overlapped).
// - Form D ("stream", bf16 decode). What bounds it: bytes. At 32 routed rows
//   the 940 MB of expert weights are the whole cost (~0.28 ms at 3.35 TB/s),
//   and a 128-row tile of tokens would be ~97 % zeros. So the operands swap:
//   out_g^T [N, rows] = W_g^T [N, K] . lhs_g^T [K, rows]. The weight's columns
//   take mma.sync's 16-row side (ldmatrix.trans of the swizzled [k][n] tile)
//   and a chunk of at most 16 token rows its 8-column side (two m16n8k16, the
//   second skipped for chunks of <= 8 rows). An item is (group, 16-row chunk,
//   128 columns): the group's K x 128 weight slab streams through a 6-stage
//   TMA ring (16 KB of weight and the chunk's 2 KB of lhs a stage); four
//   consumer warps take 32 columns each, one producer thread issues the
//   copies. Two blocks an SM (192 KB of weight in flight) walk the items
//   persistently: the items are counted from the sizes on the device, so
//   every block gets real work and no wave ends half empty, and the ring
//   runs on from one item to the next. No shared memory is written for
//   absent tokens. Past ~64 routed rows a group's rows span more chunks,
//   each streaming the slab again (from L2 at best), and form P is faster.
// - "mma" (the mma.sync form), bf16 shapes the TMA forms do not take (K or N not a
//   multiple of 8, a pointer off 16 bytes): 128 x 128 tiles, 8 warps of
//   64 x 32, k-steps of 32 through a 3-deep cp.async ring, ldmatrix and
//   mma.sync m16n8k16. Loads are masked at group and matrix edges; chunks that
//   are not whole or not 16-byte aligned are copied element by element.
// - "simt", fp32: FMA on 64 x 64 tiles (4 x 4 outputs a thread), k-steps of
//   16, no tensor core, so the products are exact fp32 products.
//
// Shared by all: one launch covers every group. Each group is cut into its
// own m-tiles (its last one partial), so a tile never spans two groups'
// weights; a grid of ceil(m / BM) + E m-tiles bounds them (form D: a
// persistent grid), and each block walks the sizes on the device to find its
// (group, row range). The sizes are never read back to the host, so a
// projection costs no host sync. The TMA forms load a tile's full box: rows
// past the group's end are the next group's, multiplied and never stored
// (the epilogue masks rows and columns), rows past m are zero-filled. No TMA
// store: a box would overwrite the next group's rows, so outputs go out with
// masked stores. The kernels allocate nothing and launch on the caller's
// stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "hop_wire.cuh"  // sm_count
#include "hopper.cuh"    // mbarrier, TMA, wgmma, the tensor-map encoder

using namespace hopper;

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;
// bf16 tiles
constexpr int BM = 128, BN = 128, BK = 32, kStages = 3;
constexpr int LDA = BK + 8;  // 80-byte rows: 8 ldmatrix rows hit 8 distinct bank groups
constexpr int LDB = BN + 8;  // 272-byte rows: the same
constexpr int kAStage = BM * LDA, kBStage = BK * LDB;  // elements per stage
constexpr int kSmemBf16 = kStages * (kAStage + kBStage) * static_cast<int>(sizeof(bf16));
// fp32 tiles
constexpr int FBM = 64, FBN = 64, FBK = 16;

struct Tile {
  int group;  // 0..E-1; E for the rows past the sizes' sum; -1 past the last tile
  int row0, row1;
};

// The m-tile t of the grouped problem: the groups end to end in rows, each
// cut into tiles of bm rows (its last one partial), then the rows past the
// sizes' sum as one more group.
__device__ __forceinline__ int group_end(const int* __restrict__ group_sizes, int E, int m, int g,
                                         int start) {
  if (g == E) return m;
  return static_cast<int>(min(static_cast<long long>(m),
                              start + static_cast<long long>(max(group_sizes[g], 0))));
}

__device__ Tile find_tile(const int* __restrict__ group_sizes, int E, int m, int bm, int t) {
  int start = 0, tiles = 0;
  for (int g = 0; g <= E; ++g) {
    const int end = group_end(group_sizes, E, m, g, start);
    const int n = (end - start + bm - 1) / bm;
    if (t < tiles + n) {
      const int row0 = start + (t - tiles) * bm;
      return {g, row0, min(row0 + bm, end)};
    }
    tiles += n;
    start = end;
  }
  return {-1, 0, 0};
}

// The number of m-tiles find_tile enumerates.
__device__ int count_tiles(const int* __restrict__ group_sizes, int E, int m, int bm) {
  int start = 0, tiles = 0;
  for (int g = 0; g <= E; ++g) {
    const int end = group_end(group_sizes, E, m, g, start);
    tiles += (end - start + bm - 1) / bm;
    start = end;
  }
  return tiles;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// d += a (16 x 16, row-major fragments) * b (16 x 8, column fragments), fp32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d[64 x 256] += A[64 x 16] (K-major) * B[16 x 256] (MN-major: the transpose bit)
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127},"
      " %128, %129, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

// Stage the A tile: rows [row0, row1) of lhs, columns [k0, k0 + BK).
__device__ __forceinline__ void load_a(bf16* As, const bf16* __restrict__ lhs, int row0, int row1,
                                       int K, int k0, bool vec) {
  for (int c = threadIdx.x; c < BM * BK / 8; c += kThreads) {
    const int r = c / (BK / 8), kc = (c % (BK / 8)) * 8;
    bf16* dst = As + r * LDA + kc;
    const int row = row0 + r, k = k0 + kc;
    const bf16* src = lhs + static_cast<size_t>(row) * K + k;
    if (row >= row1 || k >= K) {
      *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
    } else if (vec && k + 8 <= K) {
      cp_async16(dst, src);
    } else {
      for (int e = 0; e < 8; ++e) dst[e] = k + e < K ? src[e] : __float2bfloat16(0.f);
    }
  }
}

// Stage the B tile: rows [k0, k0 + BK) of one group's [K, N] matrix, columns [n0, n0 + BN).
__device__ __forceinline__ void load_b(bf16* Bs, const bf16* __restrict__ w, int K, int N, int k0,
                                       int n0, bool vec) {
  for (int c = threadIdx.x; c < BK * BN / 8; c += kThreads) {
    const int r = c / (BN / 8), nc = (c % (BN / 8)) * 8;
    bf16* dst = Bs + r * LDB + nc;
    const int k = k0 + r, n = n0 + nc;
    const bf16* src = w + static_cast<size_t>(k) * N + n;
    if (k >= K || n >= N) {
      *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
    } else if (vec && n + 8 <= N) {
      cp_async16(dst, src);
    } else {
      for (int e = 0; e < 8; ++e) dst[e] = n + e < N ? src[e] : __float2bfloat16(0.f);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
gmm_bf16_kernel(const bf16* __restrict__ lhs, const bf16* __restrict__ rhs,
                const int* __restrict__ group_sizes, bf16* __restrict__ out, int m, int K, int N,
                int E, bool vec_a, bool vec_b) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* As = reinterpret_cast<bf16*>(smem);
  bf16* Bs = As + kStages * kAStage;
  const Tile tile = find_tile(group_sizes, E, m, BM, blockIdx.x);
  if (tile.group < 0) return;
  const int n0 = blockIdx.y * BN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;  // the warp's 64 x 32 sub-tile

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  // the tail group (rows past the sizes' sum) skips the loop: its outputs are 0
  const int ktiles = tile.group < E ? (K + BK - 1) / BK : 0;
  const bf16* w = rhs + static_cast<size_t>(tile.group < E ? tile.group : 0) * K * N;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < ktiles) {
      load_a(As + s * kAStage, lhs, tile.row0, tile.row1, K, s * BK, vec_a);
      load_b(Bs + s * kBStage, w, K, N, s * BK, n0, vec_b);
    }
    cp_async_commit();
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage kt has landed, and every warp is done with stage kt - 1
    const int nk = kt + kStages - 1;
    if (nk < ktiles) {
      load_a(As + (nk % kStages) * kAStage, lhs, tile.row0, tile.row1, K, nk * BK, vec_a);
      load_b(Bs + (nk % kStages) * kBStage, w, K, N, nk * BK, n0, vec_b);
    }
    cp_async_commit();
    const bf16* a_s = As + (kt % kStages) * kAStage;
    const bf16* b_s = Bs + (kt % kStages) * kBStage;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      unsigned a[4][4], b[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
        ldmatrix_x4(a[mi], a_s + (wm + mi * 16 + (lane & 15)) * LDA + kk + (lane >> 4) * 8);
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) {
        unsigned r[4];  // k 0-7 / 8-15 of n-tiles 2nj and 2nj + 1
        ldmatrix_x4_trans(r, b_s + (kk + (lane & 15)) * LDB + wn + nj * 16 + (lane >> 4) * 8);
        b[2 * nj][0] = r[0];
        b[2 * nj][1] = r[1];
        b[2 * nj + 1][0] = r[2];
        b[2 * nj + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_bf16(acc[mi][ni], a[mi], b[ni][0], b[ni][1]);
    }
  }
  cp_async_wait<0>();

  // accumulator (mi, ni): rows lane/4 and lane/4 + 8, columns 2 (lane % 4) + {0, 1}
  const bool pairs = (N & 1) == 0;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int col = n0 + wn + ni * 8 + (lane & 3) * 2;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = tile.row0 + wm + mi * 16 + (lane >> 2) + half * 8;
        if (row >= tile.row1 || col >= N) continue;
        bf16* o = out + static_cast<size_t>(row) * N + col;
        const float v0 = acc[mi][ni][2 * half], v1 = acc[mi][ni][2 * half + 1];
        if (pairs && col + 1 < N) {
          *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(v0, v1);
        } else {
          o[0] = __float2bfloat16(v0);
          if (col + 1 < N) o[1] = __float2bfloat16(v1);
        }
      }
    }
}

__global__ void __launch_bounds__(kThreads)
gmm_f32_kernel(const float* __restrict__ lhs, const float* __restrict__ rhs,
               const int* __restrict__ group_sizes, float* __restrict__ out, int m, int K, int N,
               int E) {
  __shared__ float As[FBK][FBM + 4];  // transposed: As[k][row]
  __shared__ float Bs[FBK][FBN + 4];
  const Tile tile = find_tile(group_sizes, E, m, FBM, blockIdx.x);
  if (tile.group < 0) return;
  const int n0 = blockIdx.y * FBN;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  if (tile.group < E) {
    const float* w = rhs + static_cast<size_t>(tile.group) * K * N;
    for (int k0 = 0; k0 < K; k0 += FBK) {
      for (int i = threadIdx.x; i < FBM * FBK; i += kThreads) {
        const int r = i / FBK, k = i % FBK, row = tile.row0 + r;
        As[k][r] = row < tile.row1 && k0 + k < K ? lhs[static_cast<size_t>(row) * K + k0 + k] : 0.f;
      }
      for (int i = threadIdx.x; i < FBK * FBN; i += kThreads) {
        const int k = i / FBN, n = i % FBN;
        Bs[k][n] = k0 + k < K && n0 + n < N ? w[static_cast<size_t>(k0 + k) * N + n0 + n] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < FBK; ++k) {
        float a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = As[k][ty * 4 + i];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = Bs[k][tx * 4 + j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = tile.row0 + ty * 4 + i;
    if (row >= tile.row1) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx * 4 + j;
      if (col < N) out[static_cast<size_t>(row) * N + col] = acc[i][j];
    }
  }
}

// ---------------------------------------------------------------- form P: wgmma + TMA

constexpr int kPThreads = 384;  // consumer warpgroups 0 and 1, then the producer's
constexpr int PBM = 128, PBN = 256, PBK = 64, kPStages = 4, kPGroupM = 16;
constexpr int kPAHalf = 64 * PBK * 2;           // 8 KB: one consumer's 64 rows of A
constexpr int kPABytes = 2 * kPAHalf;           // 16 KB
constexpr int kPBBox = PBK * 64 * 2;            // 8 KB: one 64-column box of B
constexpr int kPStage = kPABytes + 4 * kPBBox;  // 48 KB
constexpr int kPSmem = kPStages * kPStage + 2 * kPStages * 8 + 1024;
constexpr int kPOutStride = PBN * 2 + 16;  // staged output rows of 528 B: a warp's writes hit 32 banks
static_assert(2 * 64 * kPOutStride <= kPStages * kPStage, "the staged outputs fit the ring");

__global__ void __launch_bounds__(kPThreads, 1)
gmm_wgmma_kernel(const __grid_constant__ CUtensorMap a_map, const __grid_constant__ CUtensorMap b_map,
                 const int* __restrict__ group_sizes, bf16* __restrict__ out, int m, int K, int N,
                 int E, int mtiles, int ntiles) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kPStages * kPStage);
  uint64_t* empty = full + kPStages;

  // block -> (m-tile, n-tile): kPGroupM m-tiles down each n-tile column at a time
  const int span = kPGroupM * ntiles;
  const int first = static_cast<int>(blockIdx.x) / span * kPGroupM;
  const int gm = min(mtiles - first, kPGroupM);
  const int local = static_cast<int>(blockIdx.x) % span;
  const Tile tile = find_tile(group_sizes, E, m, PBM, first + local % gm);
  if (tile.group < 0) return;
  const int n0 = local / gm * PBN;
  // the tail group (rows past the sizes' sum) loads nothing: its outputs are 0
  const int ktiles = tile.group < E ? (K + PBK - 1) / PBK : 0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kPStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);  // one arrival per consumer warpgroup
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 256 && ktiles > 0) {
      prefetch_map(&a_map);
      prefetch_map(&b_map);
      // boxes wholly past N are not loaded; their columns are never stored
      const int boxes = min(4, (N - n0 + 63) / 64);
      const unsigned bytes = kPABytes + boxes * kPBBox;
      int s = 0, phase = 0;
      for (int kt = 0; kt < ktiles; ++kt) {
        mbar_wait(&empty[s], phase ^ 1);
        mbar_expect_tx(&full[s], bytes);
        unsigned char* st = smem + s * kPStage;
        tma_load_2d(st, &a_map, &full[s], kt * PBK, tile.row0);
        for (int c = 0; c < boxes; ++c)
          tma_load_3d(st + kPABytes + c * kPBBox, &b_map, &full[s], n0 + c * 64, kt * PBK,
                      tile.group);
        if (++s == kPStages) {
          s = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    float acc[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.f;
    // a warpgroup whose 64 rows all lie past the tile's end only keeps the ring turning
    const bool active = tile.row0 + 64 * wg < tile.row1;
    int s = 0, phase = 0;
    for (int kt = 0; kt < ktiles; ++kt) {
      mbar_wait(&full[s], phase);
      if (active) {
        const unsigned a = smem_addr(smem + s * kPStage + wg * kPAHalf);
        const unsigned b = smem_addr(smem + s * kPStage + kPABytes);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < PBK / 16; ++kk)
          // A: K-major, 8-row groups 1024 B apart, k advances 32 B within the
          // swizzled row; B: MN-major, 64-column boxes 8 KB apart (leading),
          // 8-row k groups 1024 B apart (stride), k advances 16 rows = 2 KB
          wgmma_m64n256k16(acc, wgmma_desc(a + kk * 32, 16, 1024),
                           wgmma_desc(b + kk * 2048, kPBBox, 1024));
        wgmma_commit();
        wgmma_wait<0>();
      }
      if (threadIdx.x % 128 == 0) mbar_arrive(&empty[s]);
      if (++s == kPStages) {
        s = 0;
        phase ^= 1;
      }
    }
    // Accumulator pair j holds rows warp*16 + lane/4 (and + 8), columns 8 j +
    // 2 (lane % 4). The outputs go through shared memory, so that global
    // stores are whole 16-byte chunks of rows; once both warpgroups are past
    // their last stage, the ring is free.
    const int lane = threadIdx.x & 31, warp = (threadIdx.x & 127) >> 5;
    asm volatile("bar.sync 1, 256;\n" ::: "memory");
    unsigned char* staged = smem + wg * 64 * kPOutStride;
    const int r = warp * 16 + (lane >> 2);
#pragma unroll
    for (int j = 0; j < PBN / 8; ++j) {
      const int c = (j * 8 + (lane & 3) * 2) * 2;
      *reinterpret_cast<__nv_bfloat162*>(staged + r * kPOutStride + c) =
          __floats2bfloat162_rn(acc[4 * j], acc[4 * j + 1]);
      *reinterpret_cast<__nv_bfloat162*>(staged + (r + 8) * kPOutStride + c) =
          __floats2bfloat162_rn(acc[4 * j + 2], acc[4 * j + 3]);
    }
    asm volatile("bar.sync %0, 128;\n" ::"r"(2 + wg) : "memory");
    for (int i = threadIdx.x & 127; i < 64 * PBN / 8; i += 128) {
      const int rr = i / (PBN / 8), c = i % (PBN / 8) * 8;
      const int row = tile.row0 + wg * 64 + rr, col = n0 + c;
      if (row < tile.row1 && col < N)  // N % 8 == 0: a chunk is wholly in or out
        *reinterpret_cast<uint4*>(out + static_cast<size_t>(row) * N + col) =
            *reinterpret_cast<const uint4*>(staged + rr * kPOutStride + c * 2);
    }
  }
}

// ---------------------------------------------------------------- form D: swapped operands, weight streaming

constexpr int kDThreads = 160;  // consumer warps 0-3, then the producer warp
constexpr int DBM = 16, DBN = 128, DBK = 64, kDStages = 6, kDBlocksPerSM = 2;
constexpr int kDBoxes = DBN / 64;             // 64-column weight boxes a stage
constexpr int kDFrags = DBN / 64;             // 16-column A fragments a consumer warp
constexpr int kDWBox = DBK * 64 * 2;          // 8 KB: [64 k][64 n], swizzled rows of 128 B
constexpr int kDWBytes = kDBoxes * kDWBox;
constexpr int kDXBytes = DBM * DBK * 2;       // 2 KB of lhs: [16 rows][64 k]
constexpr int kDStage = kDWBytes + kDXBytes;  // a multiple of 1024
constexpr int kDSmem = kDStages * kDStage + 2 * kDStages * 8 + 1024;

// Persistent: each block walks the items (16-row chunk, DBN columns) from
// blockIdx.x in steps of gridDim.x. The items are counted on the device from
// the sizes (chunks of one column tile next to each other, so that a group's
// second chunk finds the slab in L2), so every block gets its share of real
// work; the ring runs on across items, so the producer loads the next item's
// slab while the consumers store the last one's outputs.
__global__ void __launch_bounds__(kDThreads, kDBlocksPerSM)
gmm_stream_kernel(const __grid_constant__ CUtensorMap x_map, const __grid_constant__ CUtensorMap w_map,
                  const int* __restrict__ group_sizes, bf16* __restrict__ out, int m, int K, int N,
                  int E, int ntiles) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kDStages * kDStage);
  uint64_t* empty = full + kDStages;
  const int ktiles_all = (K + DBK - 1) / DBK;
  const int mtiles = count_tiles(group_sizes, E, m, DBM), items = mtiles * ntiles;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kDStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4);  // one arrival per consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int s = 0, phase = 0;
  if (warp == 4) {
    if (lane != 0) return;
    prefetch_map(&x_map);
    prefetch_map(&w_map);
    for (int item = blockIdx.x; item < items; item += gridDim.x) {
      const Tile tile = find_tile(group_sizes, E, m, DBM, item % mtiles);
      if (tile.group == E) continue;  // rows past the sum: nothing to load
      const int n0 = item / mtiles * DBN;
      for (int kt = 0; kt < ktiles_all; ++kt) {
        mbar_wait(&empty[s], phase ^ 1);
        // boxes wholly past N are not loaded; their columns are never stored
        const int boxes = min(kDBoxes, (N - n0 + 63) / 64);
        mbar_expect_tx(&full[s], boxes * kDWBox + kDXBytes);
        unsigned char* st = smem + s * kDStage;
        for (int c = 0; c < boxes; ++c)
          tma_load_3d(st + c * kDWBox, &w_map, &full[s], n0 + c * 64, kt * DBK, tile.group);
        tma_load_2d(st + kDWBytes, &x_map, &full[s], kt * DBK, tile.row0);
        if (++s == kDStages) {
          s = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }
  // ldmatrix lanes: the 8 k rows (or token rows) of matrix lane / 8
  const int lk = (lane & 7) + ((lane >> 4) << 3), lc = (lane >> 3) & 1;
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const Tile tile = find_tile(group_sizes, E, m, DBM, item % mtiles);
    const int n0 = item / mtiles * DBN;
    const int ktiles = tile.group < E ? ktiles_all : 0;  // rows past the sum are written 0
    float acc[kDFrags][2][4];
#pragma unroll
    for (int f = 0; f < kDFrags; ++f)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[f][i][e] = 0.f;
    const bool two = tile.row1 - tile.row0 > 8;  // the chunk's rows 8-15 hold some of the group's
    for (int kt = 0; kt < ktiles; ++kt) {
      mbar_wait(&full[s], phase);
      const unsigned char* st = smem + s * kDStage;
#pragma unroll
      for (int kk = 0; kk < DBK / 16; ++kk) {
        // B = lhs^T [16 k x 8 rows] twice: token rows 0-7 in b[0..1], 8-15 in b[2..3]
        unsigned b[4];
        const int kc = kk * 2 + lc;
        ldmatrix_x4(b, st + kDWBytes + lk * 128 + ((kc ^ (lk & 7)) << 4));
        const int k = kk * 16 + lk;
#pragma unroll
        for (int f = 0; f < kDFrags; ++f) {
          // A = W^T [16 n x 16 k]: the stored [k][n] rows through ldmatrix.trans;
          // 16-byte chunk c of row r sits at chunk c ^ (r % 8) (128-byte swizzle)
          const int cb = (warp * kDFrags + f) * 16;  // the fragment's first column in the tile
          const int nc = (cb & 63) / 8 + lc;
          unsigned a[4];
          ldmatrix_x4_trans(a, st + (cb >> 6) * kDWBox + k * 128 + ((nc ^ (k & 7)) << 4));
          mma_bf16(acc[f][0], a, b[0], b[1]);
          if (two) mma_bf16(acc[f][1], a, b[2], b[3]);
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
      if (++s == kDStages) {
        s = 0;
        phase ^= 1;
      }
    }
    // accumulator (f, rb, half, e): weight column (warp kDFrags + f) 16 + lane/4 + 8 half,
    // token row 8 rb + 2 (lane % 4) + e
#pragma unroll
    for (int f = 0; f < kDFrags; ++f)
#pragma unroll
      for (int rb = 0; rb < 2; ++rb)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int col = n0 + (warp * kDFrags + f) * 16 + (lane >> 2) + half * 8;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int row = tile.row0 + rb * 8 + (lane & 3) * 2 + e;
            if (row < tile.row1 && col < N)
              out[static_cast<size_t>(row) * N + col] = __float2bfloat16(acc[f][rb][2 * half + e]);
          }
        }
  }
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

bool bf16_smem_set[kMaxDevices], wgmma_smem_set[kMaxDevices], stream_smem_set[kMaxDevices];

// form codes, shared with ops/grouped_matmul.py
enum Form { kSimt = 0, kMma = 1, kWgmma = 2, kStream = 3 };

}  // namespace

// dtype codes: 0 = fp32, 1 = bf16 (lhs, rhs and out alike); form: 0 SIMT
// (fp32), 1 mma.sync (bf16), 2 form P, 3 form D (bf16; K and N multiples of
// 8, K > 0, every pointer 16-byte aligned). Returns cudaErrorInvalidValue for
// a shape or dtype the form does not take, else cudaGetLastError() after the
// launch.
extern "C" int ds_grouped_matmul(const void* lhs, const void* rhs, const void* group_sizes,
                                 void* out, int m, int K, int N, int E, int dtype, int form,
                                 void* stream) {
  if (m <= 0 || K < 0 || N <= 0 || E <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* gs = static_cast<const int*>(group_sizes);
  if (form == kMma && dtype == 1) {
    const dim3 grid((m + BM - 1) / BM + E, (N + BN - 1) / BN);
    if (grid.y > 65535) return cudaErrorInvalidValue;
    const cudaError_t err =
        allow_smem(reinterpret_cast<const void*>(gmm_bf16_kernel), kSmemBf16, bf16_smem_set);
    if (err != cudaSuccess) return static_cast<int>(err);
    gmm_bf16_kernel<<<grid, kThreads, kSmemBf16, s>>>(
        static_cast<const bf16*>(lhs), static_cast<const bf16*>(rhs), gs, static_cast<bf16*>(out),
        m, K, N, E, K % 8 == 0 && aligned16(lhs), N % 8 == 0 && aligned16(rhs));
  } else if (form == kSimt && dtype == 0) {
    const dim3 grid((m + FBM - 1) / FBM + E, (N + FBN - 1) / FBN);
    if (grid.y > 65535) return cudaErrorInvalidValue;
    gmm_f32_kernel<<<grid, kThreads, 0, s>>>(static_cast<const float*>(lhs),
                                             static_cast<const float*>(rhs), gs,
                                             static_cast<float*>(out), m, K, N, E);
  } else if ((form == kWgmma || form == kStream) && dtype == 1) {
    if (K == 0 || K % 8 || N % 8 || !aligned16(lhs) || !aligned16(rhs) || !aligned16(out))
      return cudaErrorInvalidValue;
    const EncodeTiled fn = encode_tiled();
    if (fn == nullptr) return cudaErrorNotSupported;
    const bool p = form == kWgmma;
    // lhs [m, K] as (K, m), one box = one tile's rows x 64 k; rhs [E, K, N] as
    // (N, K, E), one box = 64 k x 64 columns of one expert
    const cuuint64_t a_dims[2] = {static_cast<cuuint64_t>(K), static_cast<cuuint64_t>(m)};
    const cuuint64_t a_strides[1] = {static_cast<cuuint64_t>(K) * 2};
    const cuuint32_t a_box[2] = {64, static_cast<cuuint32_t>(p ? PBM : DBM)};
    const cuuint64_t b_dims[3] = {static_cast<cuuint64_t>(N), static_cast<cuuint64_t>(K),
                                  static_cast<cuuint64_t>(E)};
    const cuuint64_t b_strides[2] = {static_cast<cuuint64_t>(N) * 2,
                                     static_cast<cuuint64_t>(K) * N * 2};
    const cuuint32_t b_box[3] = {64, 64, 1};
    CUtensorMap a_map, b_map;
    if (!encode(fn, &a_map, lhs, 2, a_dims, a_strides, a_box) ||
        !encode(fn, &b_map, rhs, 3, b_dims, b_strides, b_box))
      return cudaErrorInvalidValue;
    if (p) {
      const int mtiles = (m + PBM - 1) / PBM + E, ntiles = (N + PBN - 1) / PBN;
      const cudaError_t err =
          allow_smem(reinterpret_cast<const void*>(gmm_wgmma_kernel), kPSmem, wgmma_smem_set);
      if (err != cudaSuccess) return static_cast<int>(err);
      gmm_wgmma_kernel<<<mtiles * ntiles, kPThreads, kPSmem, s>>>(
          a_map, b_map, gs, static_cast<bf16*>(out), m, K, N, E, mtiles, ntiles);
    } else {
      // a bound on the items: the kernel counts them from the sizes
      const int ntiles = (N + DBN - 1) / DBN;
      const long long items = static_cast<long long>((m + DBM - 1) / DBM + E) * ntiles;
      const cudaError_t err =
          allow_smem(reinterpret_cast<const void*>(gmm_stream_kernel), kDSmem, stream_smem_set);
      if (err != cudaSuccess) return static_cast<int>(err);
      if (items >= (1ll << 31)) return cudaErrorInvalidValue;
      const long long slots = static_cast<long long>(hop_wire::sm_count()) * kDBlocksPerSM;
      const int grid = static_cast<int>(std::min(items, slots));
      gmm_stream_kernel<<<grid, kDThreads, kDSmem, s>>>(a_map, b_map, gs, static_cast<bf16*>(out),
                                                        m, K, N, E, ntiles);
    }
  } else {
    return cudaErrorInvalidValue;
  }
  return static_cast<int>(cudaGetLastError());
}

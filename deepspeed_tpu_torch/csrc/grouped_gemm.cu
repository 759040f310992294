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
// What bounds it on an H100: at a prefill (Mixtral's up projection, 8192
// routed rows x 4096 x 14336) the 0.96 TFLOP over 989 TFLOP/s (~0.97 ms)
// outweighs its ~1.24 GB of bytes (~0.37 ms): operations. At a decode (32
// routed rows) the 940 MB of expert weights are the whole cost: bytes
// (~0.28 ms at 3.35 TB/s).
//
// Design (simple and right first; wgmma and TMA are later work):
// - One launch covers every group. The grid's x dimension is a bound on the
//   m-tiles, ceil(m / BM) + E (each group boundary adds at most one partial
//   tile), times the n-tiles in y. Each block walks the group sizes on the
//   device to find its (group, row range); blocks past the last tile exit.
//   The sizes are never read back to the host, so a projection costs no
//   host sync.
// - bf16: 128 x 128 output tiles, 8 warps of 64 x 32, k-steps of 32 staged
//   through a 3-deep ring of shared-memory tiles with cp.async (16-byte
//   copies; rows are padded by 8 elements so that ldmatrix reads are free of
//   bank conflicts), fragments by ldmatrix (.trans for the [K, N] weights)
//   and tensor cores by warp-level mma.sync m16n8k16 with fp32 accumulators.
// - Loads are masked at group and matrix edges: rows of another group, k
//   past K and n past N are filled with 0, so a block never reads another
//   group's rows or a matrix past its end. Chunks that are not whole or not
//   16-byte aligned (K or N not a multiple of 8) are copied element by
//   element.
// - fp32: SIMT FMA on 64 x 64 tiles (4 x 4 outputs a thread), k-steps of 16.
//   No tensor core is used, so the products are exact fp32 products.
// The kernel allocates nothing and launches on the caller's stream.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
__device__ Tile find_tile(const int* __restrict__ group_sizes, int E, int m, int bm, int t) {
  int start = 0, tiles = 0;
  for (int g = 0; g <= E; ++g) {
    int end = m;
    if (g < E) end = static_cast<int>(min(static_cast<long long>(m),
                                          start + static_cast<long long>(max(group_sizes[g], 0))));
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

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4], const bf16* p) {
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

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// dtype codes: 0 = fp32, 1 = bf16 (lhs, rhs and out alike). Returns
// cudaGetLastError() after the launch.
extern "C" int ds_grouped_matmul(const void* lhs, const void* rhs, const void* group_sizes,
                                 void* out, int m, int K, int N, int E, int dtype, void* stream) {
  if (m <= 0 || K < 0 || N <= 0 || E <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* gs = static_cast<const int*>(group_sizes);
  if (dtype == 1) {
    const dim3 grid((m + BM - 1) / BM + E, (N + BN - 1) / BN);
    if (grid.y > 65535) return cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(
        gmm_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBf16);
    if (err != cudaSuccess) return static_cast<int>(err);
    gmm_bf16_kernel<<<grid, kThreads, kSmemBf16, s>>>(
        static_cast<const bf16*>(lhs), static_cast<const bf16*>(rhs), gs, static_cast<bf16*>(out),
        m, K, N, E, K % 8 == 0 && aligned16(lhs), N % 8 == 0 && aligned16(rhs));
  } else if (dtype == 0) {
    const dim3 grid((m + FBM - 1) / FBM + E, (N + FBN - 1) / FBN);
    if (grid.y > 65535) return cudaErrorInvalidValue;
    gmm_f32_kernel<<<grid, kThreads, 0, s>>>(static_cast<const float*>(lhs),
                                             static_cast<const float*>(rhs), gs,
                                             static_cast<float*>(out), m, K, N, E);
  } else {
    return cudaErrorInvalidValue;
  }
  return static_cast<int>(cudaGetLastError());
}

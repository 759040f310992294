// The hop kernels of the ring collectives, written by hand for Hopper (sm_90a).
//
// Replaces: deepspeed_tpu/collectives/pallas_backend.py
//   _permute_leaves_kernel (:237) -> permute_leaves_kernel  (ds_permute_leaves)
//   _fused_hop_kernel      (:321) -> fused_hop_kernel<kCode> (ds_fused_hop)
//
// permute_leaves_kernel copies up to kMaxLeaves buffers (a wire's values and
// scales) from the sending rank's memory into the receiving rank's, in one
// launch on the receiver's stream: the receiver pulls, so on two cards it is
// a peer read over NVLink and on one card an HBM read. It is what the TPU
// kernel's make_async_remote_copy of every leaf does. 16-byte vectors over
// the body where source and destination are 16-byte aligned, bytes for the
// tail (and for a misaligned leaf); a grid-stride loop over the leaves.
//
// fused_hop_kernel is the EQuARX hop of the ring reduce-scatter (and, with
// accumulate = 0, of the all-to-all): per quantisation block of qb elements,
//   part A (up_q given): d = (float)code * scale of the upstream rank's wire
//          slot; tgt = tgt + d (accumulate) or tgt = d;
//   part B (own_q given): scale = absmax(enc_src block) / qmax (1 for an
//          all-zero block); codes of enc_src / scale into the rank's own slot.
// enc_src may be tgt: B then requantises the sum A just wrote (the row a rank
// sends at hop k is the row it accumulated at hop k-1). int8: qmax = 127,
// rint (half to even) and a clip to +-127; e4m3: qmax = 448 and an RN cast
// with saturation. Divisions are IEEE and the multiply and add are the _rn
// intrinsics (never contracted into an FMA), so the codes and sums equal the
// plain version's (ops/quant.py block math) bit for bit. On the TPU one
// kernel per hop also moved the wire in double-buffered VMEM chunks with
// remote DMAs and credits; here the wire stays in the sender's memory and the
// ordering between ranks is CUDA events on the host (pallas_backend.py), so
// no kernel waits on another launch.
//
// What bounds them on an H100: bytes. The copy moves every byte once in and
// once out. The fused hop reads 1 byte of code, the fp32 accumulator row and
// 4 bytes of scale per block, and writes the row and 1 byte of code: about
// 10 bytes an element for a handful of flops.
//
// Design: one warp per quantisation block (eight a CUDA block), lanes
// striding the block, a warp-shuffle absmax; part B re-reads the elements
// each lane wrote in part A (its own writes), so nothing is staged in shared
// memory and any qb works (1 up to the row length).

#include "hop_wire.cuh"

namespace {

using hop_wire::WireCode;

constexpr int kMaxLeaves = 8;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

struct LeafTable {
  const uint8_t* src[kMaxLeaves];
  uint8_t* dst[kMaxLeaves];
  int64_t bytes[kMaxLeaves];
  int vec[kMaxLeaves];
  int k;
};

__global__ void __launch_bounds__(kThreads) permute_leaves_kernel(LeafTable t) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  for (int l = 0; l < t.k; ++l) {
    const uint8_t* s = t.src[l];
    uint8_t* d = t.dst[l];
    const int64_t n = t.bytes[l];
    const int64_t body = t.vec[l] ? n / 16 : 0;
    const uint4* s4 = reinterpret_cast<const uint4*>(s);
    uint4* d4 = reinterpret_cast<uint4*>(d);
    for (int64_t i = tid; i < body; i += stride) d4[i] = s4[i];
    for (int64_t i = body * 16 + tid; i < n; i += stride) d[i] = s[i];
  }
}

template <int kCode>
__global__ void __launch_bounds__(kThreads)
fused_hop_kernel(const void* __restrict__ up_q, const float* __restrict__ up_s, float* tgt,
                 int accumulate, const float* enc_src, void* __restrict__ own_q,
                 float* __restrict__ own_s, int64_t nblocks, int qb) {
  using W = WireCode<kCode>;
  const int lane = threadIdx.x & 31;
  const int64_t blk = static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (blk >= nblocks) return;
  const int64_t base = blk * qb;
  if (up_q != nullptr) {
    const float s = up_s[blk];
    for (int e = lane; e < qb; e += 32) {
      const float d = __fmul_rn(W::decode(up_q, base + e), s);
      tgt[base + e] = accumulate ? __fadd_rn(tgt[base + e], d) : d;
    }
  }
  if (own_q != nullptr) {
    float amax = 0.f;
    for (int e = lane; e < qb; e += 32) amax = fmaxf(amax, fabsf(enc_src[base + e]));
    amax = hop_wire::warp_max(amax);
    const float scale = hop_wire::block_scale<kCode>(amax);
    if (lane == 0) own_s[blk] = scale;
    for (int e = lane; e < qb; e += 32) W::encode(own_q, base + e, enc_src[base + e] / scale);
  }
}

int grid_for(int64_t work) {
  const int sms = hop_wire::sm_count();
  const int64_t want = (work + kThreads - 1) / kThreads;
  return static_cast<int>(want < 1 ? 1 : (want < 8LL * sms ? want : 8LL * sms));
}

}  // namespace

// srcs[k], dsts[k], bytes[k]: host arrays of k <= 8 leaves. Copies each leaf's
// bytes from src to dst on `stream`. Returns cudaGetLastError() after the launch.
extern "C" int ds_permute_leaves(const void* const* srcs, void* const* dsts,
                                 const int64_t* bytes, int k, void* stream) {
  if (k < 1 || k > kMaxLeaves) return cudaErrorInvalidValue;
  LeafTable t{};
  t.k = k;
  int64_t work = 0;
  for (int l = 0; l < k; ++l) {
    t.src[l] = static_cast<const uint8_t*>(srcs[l]);
    t.dst[l] = static_cast<uint8_t*>(dsts[l]);
    t.bytes[l] = bytes[l];
    t.vec[l] = (reinterpret_cast<uintptr_t>(srcs[l]) | reinterpret_cast<uintptr_t>(dsts[l])) % 16 == 0;
    const int64_t units = t.vec[l] ? bytes[l] / 16 + bytes[l] % 16 : bytes[l];
    work = units > work ? units : work;
  }
  permute_leaves_kernel<<<grid_for(work), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(t);
  return static_cast<int>(cudaGetLastError());
}

// One fused hop over a row of n elements (n a multiple of qb). up_q/up_s (the
// upstream rank's wire slot) with tgt, and own_q/own_s (this rank's slot) with
// enc_src, are each optional (NULL). code: 1 int8, 2 float8_e4m3fn.
extern "C" int ds_fused_hop(const void* up_q, const void* up_s, void* tgt, int accumulate,
                            const void* enc_src, void* own_q, void* own_s, int64_t n, int qb,
                            int code, void* stream) {
  if (n <= 0 || qb <= 0 || n % qb) return cudaErrorInvalidValue;
  const int64_t nblocks = n / qb;
  const int64_t grid = (nblocks + kWarps - 1) / kWarps;
  if (grid > 2147483647LL) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto g = static_cast<unsigned>(grid);
  if (code == 1) {
    fused_hop_kernel<1><<<g, kThreads, 0, s>>>(up_q, static_cast<const float*>(up_s),
                                               static_cast<float*>(tgt), accumulate,
                                               static_cast<const float*>(enc_src), own_q,
                                               static_cast<float*>(own_s), nblocks, qb);
  } else if (code == 2) {
    fused_hop_kernel<2><<<g, kThreads, 0, s>>>(up_q, static_cast<const float*>(up_s),
                                               static_cast<float*>(tgt), accumulate,
                                               static_cast<const float*>(enc_src), own_q,
                                               static_cast<float*>(own_s), nblocks, qb);
  } else {
    return cudaErrorInvalidValue;
  }
  return static_cast<int>(cudaGetLastError());
}

// Lets `device` read `peer`'s memory (ranks of one group on two cards).
extern "C" int ds_enable_peer_access(int device, int peer) {
  int prev = 0;
  cudaGetDevice(&prev);
  cudaSetDevice(device);
  cudaError_t err = cudaDeviceEnablePeerAccess(peer, 0);
  if (err == cudaErrorPeerAccessAlreadyEnabled) {
    cudaGetLastError();
    err = cudaSuccess;
  }
  cudaSetDevice(prev);
  return static_cast<int>(err);
}

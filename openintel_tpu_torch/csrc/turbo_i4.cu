// Kernels E1 and E2: int8 queries x nibble-packed int4 corpus, the top-1
// (E1, SLOTS = 1) or top-2 (E2, SLOTS = 2) keys per (query, super, lane).
//
// Replace openintel_tpu/ops/pallas/dense_topk.py:_turbo_kernel_i4 (E1) and
// _turbo_kernel_i4_top2 (E2), launched by dense_topk_fast_i4 (slots 1, 2;
// the `--kernel int4` dense arm runs E2). Same cells, bit for bit.
//
// Layout: the corpus is (N_pad / 2, D) bytes, N_pad a multiple of 16,384;
// byte row r holds doc 2r in its low nibble and doc 2r + 1 in its high
// nibble, each a signed int4 (the row-major pack_corpus_t_i4). A super is
// 8,192 byte rows: 64 byte sub-tiles t of 128 lanes. Byte row
// s * 8192 + 128 t + l carries two candidates of cell (s, l), with
//
//   pos = 2 t + parity,  key = dot * 128 + FLAG128 + pos,
//
// for doc s * 16384 + 2 (128 t + l) + parity. |dot| <= 127 * 8 * D, so the
// key stays in (0, 2^31) for D below 8,000. A cell's 128 keys are distinct,
// so its top-1 and top-2 are unique and the walk order is free.
//
// Design: kernel A's int8 tensor-core path (mma.sync m16n8k32 and the
// streaming loop of turbo_common.cuh) over the packed rows. Each 16 bytes a
// thread loads are unpacked in registers into two B fragments, the
// sign-extended low nibbles (even docs) and high nibbles (odd docs), which
// share the queries' A fragments. A block of 4 warps per (32-query tile, 32
// lanes, super) shares the staged queries; each thread folds its 8 cells'
// keys (streaming max, or top-2 by the reference's max/min fold) in
// registers over the super's 64 sub-tiles.
//
// What bounds it on an H100: at the main path's shapes (B=256, N=1.25M,
// D=384) the packed corpus is 0.24 GB, reread from L2 by each of the 8
// query tiles (1.9 GB); the unpack adds ~8 integer ops per 4 bytes, and
// each warp waits on its own loads. As for kernel A, sharing doc tiles
// among query tiles and wgmma with TMA loads are left for later.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "turbo_common.cuh"

namespace {

using namespace oi;

constexpr int kWarps = 4;  // doc-lane slices per block, sharing the queries
constexpr int kThreads = 32 * kWarps;
constexpr int kSubTiles = kSuper / 2;  // byte sub-tiles per super

struct Acc {
  int32_t lo[2][4];  // even docs (low nibbles)
  int32_t hi[2][4];  // odd docs (high nibbles)
};

// Four packed bytes -> four int8 (as a word) of their low or high nibbles,
// sign-extended: a nibble n with bit 3 set becomes n | 0xF0.
__device__ __forceinline__ int32_t nibbles(int32_t w, int shift) {
  const uint32_t x = (static_cast<uint32_t>(w) >> shift) & 0x0F0F0F0Fu;
  return static_cast<int32_t>(x | ((x & 0x08080808u) * 0x1Eu));
}

template <int KP, int NP, int SLOTS>
__global__ void __launch_bounds__(kThreads)
turbo_i4_kernel(const int8_t* __restrict__ q,       // (b_pad, dim) int8
                const int8_t* __restrict__ corpus,  // (n_super * 8192, dim)
                int32_t* __restrict__ out,  // (b_pad, SLOTS * n_super * 128)
                int dim, int n_super) {
  extern __shared__ __align__(16) int8_t q_s[];
  const int warp = threadIdx.x >> 5;
  const int gq = (threadIdx.x & 31) >> 2;
  const int tq = threadIdx.x & 3;
  const int q0 = blockIdx.x * kQueryTile;
  const int slice = blockIdx.y * kWarps + warp;
  const int s = blockIdx.z;

  stage_queries(q_s, q + (size_t)q0 * dim, dim, threadIdx.x, kThreads);
  __syncthreads();

  const int8_t* docs =
      corpus + ((size_t)s * kSubTiles * kLanes + kSlice * slice + gq) * dim +
      16 * tq;
  int32_t a1[8], a2[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) a1[i] = a2[i] = INT_MIN;
  auto dot = [](Acc& acc, const QFrag& a, int4 b) {
    const int4 lo = make_int4(nibbles(b.x, 0), nibbles(b.y, 0),
                              nibbles(b.z, 0), nibbles(b.w, 0));
    const int4 hi = make_int4(nibbles(b.x, 4), nibbles(b.y, 4),
                              nibbles(b.z, 4), nibbles(b.w, 4));
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const int4 r0 = a.r[mi][0], r8 = a.r[mi][1];
      mma_s8(acc.lo[mi], r0.x, r8.x, r0.y, r8.y, lo.x, lo.y);
      mma_s8(acc.lo[mi], r0.z, r8.z, r0.w, r8.w, lo.z, lo.w);
      mma_s8(acc.hi[mi], r0.x, r8.x, r0.y, r8.y, hi.x, hi.y);
      mma_s8(acc.hi[mi], r0.z, r8.z, r0.w, r8.w, hi.z, hi.w);
    }
  };
  auto done = [&](int t, const Acc& acc) {
    const int32_t base = kFlag128 + 2 * t;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      fold_key<SLOTS>(a1[i], a2[i], acc.lo[i >> 2][i & 3] * 128 + base);
      fold_key<SLOTS>(a1[i], a2[i], acc.hi[i >> 2][i & 3] * 128 + base + 1);
    }
  };
  stream_docs<KP, NP, Acc>(docs, (size_t)kLanes * dim, 0, kSubTiles, dim,
                           q_s, gq, tq, dot, done);

  const size_t half = (size_t)n_super * 128;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = q0 + 16 * (i >> 2) + gq + 8 * ((i & 3) >> 1);
    const size_t o = row * SLOTS * half + s * 128 + kSlice * slice + 2 * tq +
                     (i & 1);
    out[o] = a1[i];
    if (SLOTS == 2) out[o + half] = a2[i];
  }
}

template <int SLOTS>
int launch_i4(const void* q, const void* corpus, void* out, int b_pad,
              int dim, int n_super, cudaStream_t stream) {
  const int smem = kQueryTile * row_stride(dim);
  const dim3 grid(b_pad / kQueryTile, kLanes / (kSlice * kWarps), n_super);
  return with_passes(dim, [&](auto kp, auto np) {
    auto kernel =
        turbo_i4_kernel<decltype(kp)::value, decltype(np)::value, SLOTS>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<grid, kThreads, smem, stream>>>(
        static_cast<const int8_t*>(q), static_cast<const int8_t*>(corpus),
        static_cast<int32_t*>(out), dim, n_super);
    return (int)cudaGetLastError();
  });
}

}  // namespace

extern "C" int oi_turbo_i4(const void* q, const void* corpus, void* out,
                           int slots, int b_pad, int dim, int n_super,
                           void* stream) {
  if (dim % 16 || dim >= 8000 || b_pad % kQueryTile ||
      kQueryTile * row_stride(dim) > kSmemMax || (slots != 1 && slots != 2))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return slots == 1 ? launch_i4<1>(q, corpus, out, b_pad, dim, n_super, st)
                    : launch_i4<2>(q, corpus, out, b_pad, dim, n_super, st);
}

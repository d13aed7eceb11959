// Kernels C1 and C2: int8 candidate cells, the top-1 (C1, SLOTS = 1) or
// top-2 (C2, SLOTS = 2) keys per (query, super, lane).
//
// Replace openintel_tpu/ops/pallas/dense_topk.py:_turbo_kernel_i8 (C1) and
// _turbo_kernel_i8_top2 (C2), launched by dense_topk_fast_i8 (slots 1, 2)
// and, for C2, by the candidate-pass measurement tools. Same cells, bit for
// bit. Cell (b, s, l), for the 128 docs s * 16384 + 128 pos + l:
//
//   key = dot(q_b, doc) * 128 + FLAG128 + pos
//
// A cell's 128 keys carry distinct pos, so its top-1 and top-2 are unique:
// the walk order over a super and the reference's block_c do not change
// them, and the cells are independent. Zero-padded docs give real keys
// (dot 0); only the decode drops them. The reference's C2 starts slot 2 at
// a sentinel 0 and this kernel at INT_MIN; every cell folds 128 real keys,
// so both end at the same top-2. The key is formed in unsigned arithmetic:
// it wraps as the reference's int32 does (|dot| <= 127^2 D keeps it in
// (0, 2^31) for D <= 512, and for unit-norm rows at any D).
//
// Output: (b_pad, SLOTS * n_super * 128) int32; column s * 128 + l of slot
// j's half holds the cell's j-th key. All supers' slot-1 keys come first,
// then all their slot-2 keys, the reference's concat(p1, p2).
//
// Design: kernel E's grid and loop (turbo_common.cuh) on kernel A's row-major
// (N_pad, D) int8 corpus, without E's unpack. A block of 4 warps per
// (32-query tile, 32 lanes, super) shares the staged queries; each warp owns
// 8 lanes and walks the super's 128 sub-blocks, its dots on the int8 tensor
// cores (mma.sync m16n8k32, s8 x s8 -> s32), each thread folding its 8
// cells' keys in registers.
//
// What bounds it on an H100: at B=256, N=1.25M, D=384 the corpus stream, 0.48
// GB from device memory (0.15 ms at 3.35 TB/s; the 0.25 TOP of int8 products
// take 0.125 ms at the tensor cores' peak), reread from L2 by each of the 8
// query tiles. As for kernels A, D and E, sharing doc tiles among query tiles
// and wgmma with TMA loads are left for later.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "turbo_common.cuh"

namespace {

using namespace oi;

constexpr int kWarps = 4;  // doc-lane slices per block, sharing the queries
constexpr int kThreads = 32 * kWarps;

struct Acc {
  int32_t c[2][4];
};

template <int KP, int NP, int SLOTS>
__global__ void __launch_bounds__(kThreads)
turbo_i8_kernel(const int8_t* __restrict__ q,       // (b_pad, dim) int8
                const int8_t* __restrict__ corpus,  // (n_super * 16384, dim)
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
      corpus + ((size_t)s * kSuper * kLanes + kSlice * slice + gq) * dim +
      16 * tq;
  int32_t a1[8], a2[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) a1[i] = a2[i] = INT_MIN;
  auto dot = [](Acc& acc, const QFrag& a, int4 b) {
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const int4 r0 = a.r[mi][0], r8 = a.r[mi][1];
      mma_s8(acc.c[mi], r0.x, r8.x, r0.y, r8.y, b.x, b.y);
      mma_s8(acc.c[mi], r0.z, r8.z, r0.w, r8.w, b.z, b.w);
    }
  };
  auto done = [&](int pos, const Acc& acc) {
    const uint32_t base = static_cast<uint32_t>(kFlag128 + pos);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const uint32_t key =
          static_cast<uint32_t>(acc.c[i >> 2][i & 3]) * 128u + base;
      fold_key<SLOTS>(a1[i], a2[i], static_cast<int32_t>(key));
    }
  };
  stream_docs<KP, NP, Acc>(docs, (size_t)kLanes * dim, 0, kSuper, dim, q_s,
                           gq, tq, dot, done);

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
int launch_i8(const void* q, const void* corpus, void* out, int b_pad,
              int dim, int n_super, cudaStream_t stream) {
  const int smem = kQueryTile * row_stride(dim);
  const dim3 grid(b_pad / kQueryTile, kLanes / (kSlice * kWarps), n_super);
  return with_passes(dim, [&](auto kp, auto np) {
    auto kernel =
        turbo_i8_kernel<decltype(kp)::value, decltype(np)::value, SLOTS>;
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

extern "C" int oi_turbo_i8(const void* q, const void* corpus, void* out,
                           int slots, int b_pad, int dim, int n_super,
                           void* stream) {
  if (dim % 16 || b_pad % kQueryTile || n_super < 1 ||
      kQueryTile * row_stride(dim) > kSmemMax || (slots != 1 && slots != 2))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return slots == 1 ? launch_i8<1>(q, corpus, out, b_pad, dim, n_super, st)
                    : launch_i8<2>(q, corpus, out, b_pad, dim, n_super, st);
}

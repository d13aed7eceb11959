// Kernel S: the int8 dot-only stream probe, per-lane sums of every dot.
//
// Replaces _dot_only_kernel of scripts/bench_kernel_decomp.py (launched by
// its dot_only), which measures the stream floor of the int8 candidate
// kernels: the same corpus and tensor-core products as kernels A and C, with
// one add per dot in place of the key pack and fold. Output (b_pad, 128)
// int32: column l holds the sum of dot(q_b, doc) over every doc of the padded
// corpus with id % 128 == l, wrapped mod 2^32 as the reference's int32 adds
// wrap.
//
// Design: kernel C's grid and loop (turbo_common.cuh, mma.sync m16n8k32 on
// the row-major (N_pad, D) int8 corpus): a block of 4 warps per (32-query
// tile, 32 lanes, super), each thread summing its 8 cells over the super's
// 128 sub-blocks. Blocks cover disjoint supers and combine with atomicAdd on
// unsigned int: unsigned adds are exact mod 2^32 in any order, so the result
// is bit-identical to a sum in int64 wrapped to int32 (signed overflow would
// be undefined in C++). The entry zeroes the output on the stream first.
//
// What bounds it on an H100: the corpus stream, as for kernels A and C (0.48
// GB from device memory at B=256, N=1.25M, D=384: 0.145 ms at 3.35 TB/s),
// reread from L2 by each of the 8 query tiles. Its time against kernel A's
// is what the fold costs A.

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

template <int KP, int NP>
__global__ void __launch_bounds__(kThreads)
dot_only_kernel(const int8_t* __restrict__ q,       // (b_pad, dim) int8
                const int8_t* __restrict__ corpus,  // (n_super * 16384, dim)
                unsigned int* __restrict__ out,     // (b_pad, 128), zeroed
                int dim) {
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
  uint32_t sum[8] = {};
  auto dot = [](Acc& acc, const QFrag& a, int4 b) {
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const int4 r0 = a.r[mi][0], r8 = a.r[mi][1];
      mma_s8(acc.c[mi], r0.x, r8.x, r0.y, r8.y, b.x, b.y);
      mma_s8(acc.c[mi], r0.z, r8.z, r0.w, r8.w, b.z, b.w);
    }
  };
  auto done = [&](int, const Acc& acc) {
#pragma unroll
    for (int i = 0; i < 8; ++i)
      sum[i] += static_cast<uint32_t>(acc.c[i >> 2][i & 3]);
  };
  stream_docs<KP, NP, Acc>(docs, (size_t)kLanes * dim, 0, kSuper, dim, q_s,
                           gq, tq, dot, done);

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = q0 + 16 * (i >> 2) + gq + 8 * ((i & 3) >> 1);
    atomicAdd(out + row * 128 + kSlice * slice + 2 * tq + (i & 1), sum[i]);
  }
}

}  // namespace

extern "C" int oi_dot_only(const void* q, const void* corpus, void* out,
                           int b_pad, int dim, int n_super, void* stream) {
  const int smem = kQueryTile * row_stride(dim);
  if (dim % 16 || b_pad % kQueryTile || n_super < 1 || smem > kSmemMax)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      cudaMemsetAsync(out, 0, (size_t)b_pad * 128 * sizeof(int32_t), st);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(b_pad / kQueryTile, kLanes / (kSlice * kWarps), n_super);
  return with_passes(dim, [&](auto kp, auto np) {
    auto kernel = dot_only_kernel<decltype(kp)::value, decltype(np)::value>;
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    kernel<<<grid, kThreads, smem, st>>>(
        static_cast<const int8_t*>(q), static_cast<const int8_t*>(corpus),
        static_cast<unsigned int*>(out), dim);
    return (int)cudaGetLastError();
  });
}

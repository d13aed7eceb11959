// Kernel D: f32/bf16 candidate cells, the top-1 key per (query, super, lane).
//
// Replaces openintel_tpu/ops/pallas/dense_topk.py:_turbo_kernel_f32
// (launched by dense_topk_fast, the `--kernel fast` dense arm). Cell
// (b, s, l), for the 128 docs s * 16384 + pos * 128 + l, pos in [0, 128):
//
//   key = (bits_i32(dot(q_b, doc) + 2.0f) & ~127) | pos,  cell = max over pos
//
// The low 7 mantissa bits carry pos; the max is a signed int32 max on the
// bits, not a float compare. A cell's 128 keys carry distinct pos, so its
// max is unique and the walk order over a super is free: cells are
// independent, and the grid is too.
//
// Two kernels, one grid: a block of 4 warps per (32-query tile, 32 doc
// lanes, super) shares the staged queries; each warp owns 8 lanes and walks
// the super's 128 sub-blocks, each thread keeping its 8 cells' running max
// in registers (the cell layout of turbo_common.cuh).
// - bf16: the products run on the tensor cores (mma.sync m16n8k16, f32
//   accumulate) with turbo_common.cuh's streaming loop. bf16 products are
//   exact in f32; the sums run in the tensor cores' order.
// - f32: true float32 FMA (the reference's Precision.HIGHEST; no TF32),
//   one fmaf chain per cell in ascending k.
// Where a sum is exact in any order (dyadic operands) the cells equal the
// plain twin's bit for bit; elsewhere a cell may move by one score quantum.
//
// What bounds it on an H100: at the main path's shapes (B=256, N=1.25M,
// D=384 bf16, 0.25 TFLOP) the corpus stream: 0.97 GB from device memory
// (0.29 ms at 3.35 TB/s), reread from L2 by each of the 8 query tiles.
// It runs at ~5.7x that floor (1.65 ms on an H100 80GB HBM3 at 700 W):
// the L2 rereads or each warp's wait on its own loads bound it (not yet
// measured apart), not device memory. The bf16 dots on the tensor cores
// are far from their bound; the f32 FMA path (tests only, not a main path)
// is bound by its FMA rate and its uncoalesced row reads. Sharing a doc
// tile among query tiles and wgmma with TMA loads are left for later.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "turbo_common.cuh"

namespace {

using namespace oi;

constexpr int kWarps = 4;  // doc-lane slices per block, sharing the queries
constexpr int kThreads = 32 * kWarps;

struct Acc {
  float c[2][4];
};

__device__ __forceinline__ int32_t fast_key(float dot, int pos) {
  return (__float_as_int(__fadd_rn(dot, 2.0f)) & ~127) | pos;
}

__device__ __forceinline__ void write_cells(int32_t* out, const int32_t* best,
                                            int q0, int s, int slice, int gq,
                                            int tq, int n_super) {
  const size_t width = (size_t)n_super * 128;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = q0 + 16 * (i >> 2) + gq + 8 * ((i & 3) >> 1);
    const int col = s * 128 + kSlice * slice + 2 * tq + (i & 1);
    out[row * width + col] = best[i];
  }
}

template <int KP, int NP>
__global__ void __launch_bounds__(kThreads)
turbo_bf16_kernel(const int8_t* __restrict__ q,       // (b_pad, dim) bf16
                  const int8_t* __restrict__ corpus,  // (n_super * 16384, dim)
                  int32_t* __restrict__ out,          // (b_pad, n_super * 128)
                  int row_bytes, int n_super) {
  extern __shared__ __align__(16) int8_t q_s[];
  const int warp = threadIdx.x >> 5;
  const int gq = (threadIdx.x & 31) >> 2;
  const int tq = threadIdx.x & 3;
  const int q0 = blockIdx.x * kQueryTile;
  const int slice = blockIdx.y * kWarps + warp;
  const int s = blockIdx.z;

  stage_queries(q_s, q + (size_t)q0 * row_bytes, row_bytes, threadIdx.x,
                kThreads);
  __syncthreads();

  const int8_t* docs = corpus +
                       ((size_t)s * kSuper * kLanes + kSlice * slice + gq) *
                           row_bytes +
                       16 * tq;
  int32_t best[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) best[i] = INT_MIN;
  auto dot = [](Acc& acc, const QFrag& a, int4 b) {
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const int4 r0 = a.r[mi][0], r8 = a.r[mi][1];
      mma_bf16(acc.c[mi], r0.x, r8.x, r0.y, r8.y, b.x, b.y);
      mma_bf16(acc.c[mi], r0.z, r8.z, r0.w, r8.w, b.z, b.w);
    }
  };
  auto done = [&](int pos, const Acc& acc) {
#pragma unroll
    for (int i = 0; i < 8; ++i)
      best[i] = max(best[i], fast_key(acc.c[i >> 2][i & 3], pos));
  };
  stream_docs<KP, NP, Acc>(docs, (size_t)kLanes * row_bytes, 0, kSuper,
                           row_bytes, q_s, gq, tq, dot, done);
  write_cells(out, best, q0, s, slice, gq, tq, n_super);
}

__global__ void __launch_bounds__(kThreads)
turbo_f32_kernel(const float* __restrict__ q,       // (b_pad, dim)
                 const float* __restrict__ corpus,  // (n_super * 16384, dim)
                 int32_t* __restrict__ out,         // (b_pad, n_super * 128)
                 int dim, int n_super) {
  extern __shared__ __align__(16) int8_t smem[];
  const int warp = threadIdx.x >> 5;
  const int gq = (threadIdx.x & 31) >> 2;
  const int tq = threadIdx.x & 3;
  const int q0 = blockIdx.x * kQueryTile;
  const int slice = blockIdx.y * kWarps + warp;
  const int s = blockIdx.z;

  stage_queries(smem, reinterpret_cast<const int8_t*>(q + (size_t)q0 * dim),
                4 * dim, threadIdx.x, kThreads);
  __syncthreads();
  const float* q_s = reinterpret_cast<const float*>(smem);
  const int stride = row_stride(4 * dim) / 4;

  // this thread's docs: lanes 2 tq and 2 tq + 1 of its slice
  const float* docs =
      corpus + ((size_t)s * kSuper * kLanes + kSlice * slice + 2 * tq) * dim;
  int32_t best[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) best[i] = INT_MIN;
  for (int pos = 0; pos < kSuper; ++pos) {
    const float* d0 = docs + (size_t)pos * kLanes * dim;
    float acc[8] = {};
    for (int k = 0; k < dim; k += 4) {
      const float4 x[2] = {*reinterpret_cast<const float4*>(d0 + k),
                           *reinterpret_cast<const float4*>(d0 + dim + k)};
#pragma unroll
      for (int m = 0; m < 4; ++m) {  // query 16 (m / 2) + gq + 8 (m % 2)
        const float4 qv = *reinterpret_cast<const float4*>(
            q_s + (16 * (m >> 1) + gq + 8 * (m & 1)) * stride + k);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          float& a = acc[2 * m + j];
          a = fmaf(qv.x, x[j].x, a);
          a = fmaf(qv.y, x[j].y, a);
          a = fmaf(qv.z, x[j].z, a);
          a = fmaf(qv.w, x[j].w, a);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) best[i] = max(best[i], fast_key(acc[i], pos));
  }
  write_cells(out, best, q0, s, slice, gq, tq, n_super);
}

}  // namespace

extern "C" int oi_turbo_f32(const void* q, const void* corpus, void* out,
                            int is_bf16, int b_pad, int dim, int n_super,
                            void* stream) {
  const int row_bytes = dim * (is_bf16 ? 2 : 4);
  const int smem = kQueryTile * row_stride(row_bytes);
  if (row_bytes % 16 || b_pad % kQueryTile || smem > kSmemMax)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(b_pad / kQueryTile, kLanes / (kSlice * kWarps), n_super);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!is_bf16) {
    cudaError_t err = cudaFuncSetAttribute(
        turbo_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    turbo_f32_kernel<<<grid, kThreads, smem, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(corpus),
        static_cast<int32_t*>(out), dim, n_super);
    return (int)cudaGetLastError();
  }
  return with_passes(row_bytes, [&](auto kp, auto np) {
    auto kernel = turbo_bf16_kernel<decltype(kp)::value, decltype(np)::value>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<grid, kThreads, smem, st>>>(
        static_cast<const int8_t*>(q), static_cast<const int8_t*>(corpus),
        static_cast<int32_t*>(out), row_bytes, n_super);
    return (int)cudaGetLastError();
  });
}

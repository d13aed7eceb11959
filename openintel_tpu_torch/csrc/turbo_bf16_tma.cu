// Kernel D on Hopper's stream: bf16 candidate cells, the top-1 key per
// (query, super, lane), through TMA and wgmma (tma_stream.cuh).
//
// Replaces openintel_tpu/ops/pallas/dense_topk.py:_turbo_kernel_f32 for
// bf16 rows (dense_topk_fast, the `--kernel fast` dense arm, through
// fast_cells). Cell (b, s, l), for the 128 docs s * 16384 + pos * 128 + l:
//
//   key = (bits_i32(dot(q_b, doc) + 2.0f) & ~127) | pos,  cell = max over pos
//
// (signed int32 max on the bits). The mma.sync kernel (turbo_f32.cu,
// bf16 branch) stays as the A/B control, reached only through
// fast_cells_v1; f32 rows keep turbo_f32.cu's true-f32 FMA kernel.
//
// What bounds it on an H100 at the main path's shapes (B=256, N=1.25M,
// D=384): device memory, 0.98 GB in 0.29 ms at 3.35 TB/s, with the bf16
// tensor-core time (0.25 ms) close behind. The mma.sync kernel lost to the
// stream (each of 8 query tiles reread the corpus from L2; each warp
// waited on its own loads into mma.sync fragments). Here a doc tile is
// loaded by TMA once per 256 queries (a 2-block cluster, multicast) into a
// ring of 24 KB stages, and two consumer warpgroups run wgmma m64n64k16
// on it with the queries in registers while the producer keeps the next
// stages in flight; each consumer thread keeps its 32 cells' running max
// in registers and writes them once per unit. Measured with
// tools/stream_ablation.py (H100 80GB HBM3, 700 W): the stream alone takes
// 0.34 ms (2.9 TB/s), the products add nothing, the max fold 0.08 ms.
//
// A cell's 128 keys carry distinct pos, so its max is order-free: the host
// may split a super's sub-blocks into parts run by different blocks (for an
// even spread over the SMs); parts then meet by atomicMax on cells first
// set to INT_MIN. The sums run in the tensor cores' order: bit-identical to
// the twin where every partial sum is exact (dyadic operands), within one
// score step (2**-15) elsewhere.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "tma_stream.cuh"

namespace {

using namespace oi_tma;

template <int QREGS>
__global__ void __launch_bounds__(kThreads, 1)
turbo_bf16_tma_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tc,
                      int32_t* __restrict__ out,  // (b_pad, n_super * 128)
                      const Geometry g) {
  int32_t best[32];
  const size_t width = (size_t)g.n_super * kLanes;
  stream_tiles<QREGS, MmaBf16>(
      g, &tq, &tc,
      [&] {
#pragma unroll
        for (int i = 0; i < 32; ++i) best[i] = INT_MIN;
      },
      [&](float (&acc)[32], const Cell&, int, int, int pos) {
#pragma unroll
        for (int i = 0; i < 32; ++i)
          best[i] = max(best[i],
                        (__float_as_int(__fadd_rn(acc[i], 2.0f)) & ~127) | pos);
      },
      [&](const Cell& c, int s, int half, int) {
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int row = c.row + 8 * ((i >> 1) & 1);
          if (row >= g.b_pad) continue;
          const int col = s * kLanes + half * kDocRows + c.col + 8 * (i >> 2) + (i & 1);
          int32_t* p = out + (size_t)row * width + col;
          if (g.parts == 1)
            *p = best[i];
          else
            atomicMax(p, best[i]);
        }
      });
}

}  // namespace

extern "C" int oi_turbo_bf16_tma(const void* q, const void* corpus, void* out,
                                 int b_pad, int dim, int n_super,
                                 void* stream) {
  const int row_bytes = 2 * dim;
  if (row_bytes % 16 || b_pad <= 0 || b_pad % 32 || n_super <= 0)
    return (int)cudaErrorInvalidValue;
  const Geometry g = plan(row_bytes, 2, b_pad, n_super, kMaxParts, kMaxQRegBoxes);
  CUtensorMap tq, tc;
  if (!encode_rows(&tq, q, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, b_pad,
                   row_bytes, kQueryRows) ||
      !encode_rows(&tc, corpus, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                   (uint64_t)n_super * kSuper * kLanes, row_bytes,
                   kDocRows / g.cluster))
    return (int)cudaErrorNotSupported;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (g.parts > 1) {
    const int err =
        fill(static_cast<int32_t*>(out), (size_t)b_pad * n_super * kLanes, INT_MIN, st);
    if (err) return err;
  }
  return with_qregs<kMaxQRegBoxes>(g, [&](auto qregs) {
    return launch_stream(turbo_bf16_tma_kernel<decltype(qregs)::value>, g, st,
                         tq, tc, static_cast<int32_t*>(out), g);
  });
}

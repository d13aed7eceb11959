// Kernel S on Hopper's stream: the int8 dot-only probe, per-lane sums of
// every dot, through TMA and wgmma (stream_tiles of tma_stream.cuh).
//
// Replaces _dot_only_kernel of scripts/bench_kernel_decomp.py (launched by
// its dot_only), which measures the stream floor of the int8 candidate
// kernels: the same corpus and tensor-core products as kernels A and C,
// with one add per dot in place of the key pack and fold. Output (b_pad,
// 128) int32: column l holds the sum of dot(q_b, doc) over every doc of the
// padded (N_pad, D) int8 corpus with id % 128 == l, wrapped mod 2^32 as
// the reference's int32 adds wrap. The mma.sync kernel of dot_only.cu
// stays as the A/B control behind dot_only_cells_v1.
//
// What bounds it on an H100 at the measurement path's shapes (B=256,
// N=1.25M, D=384): device memory, 0.48 GB read in 0.145 ms at 3.35 TB/s,
// with the 0.25 TOP of int8 products (0.125 ms at the tensor cores' peak)
// close behind. The mma.sync kernel ran at 18 % of that: each of 8 query
// tiles reread the corpus from L2. Here the corpus is kernel A's, on A's
// stream: 64-doc tiles by TMA into a shared-memory ring, 128 queries a
// block in two consumer warpgroups, the queries in registers up to D=384
// (from shared memory, or streamed with each doc box, for wider rows),
// blocks paired in 2-block clusters that multicast each tile at an even
// number of query tiles (unless the caller asks for unpaired blocks).
//
// S needs no fold. A work unit (super, lane half, part) covers lanes
// 64 half .. 64 half + 63 in every tile, so each accumulator set meets the
// same 64 lanes throughout the unit: wgmma adds each tile into its set in
// place (consume's ACCUM), and the fold callback only adds a set's sums
// into the zeroed output, with unsigned atomicAdd, when its run ends.
// Unsigned adds are exact mod 2^32 in any order, so the result is
// bit-identical to a sum in int64 wrapped to int32. The blocks of a query
// tile are trimmed to a multiple of 2 parts when that costs no round of
// units: block c's units c, c + ctas_per_qt, ... then share their lane half
// and part (their supers lie `stride` apart), and the runs go on across
// them, so each block adds into the output once, at its end. Each set goes
// out on its own: 32 sums held beside the accumulators took the registers
// the queries' fragments need. On an H100 at B=256 (PERF.md) a flush per
// unit with the sums held ran at 0.243 ms, one per block 0.224, one per
// block with no sums held 0.188, against 0.18 for the stream alone; the
// blocks' sums stored apart and added by a second kernel took 0.196.
//
// A run is short enough that no set's int32 sum can overflow (|dot| <=
// 16384 D), so the result does not depend on whether the tensor cores'
// s32 adds wrap or saturate; the entry's run_cap lets a measurement
// lengthen the runs past that to find out which they do.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "tma_stream.cuh"

namespace {

using namespace oi_tma;

// Query boxes in registers (D <= 384), as kernels C, beside acc0 and acc1.
constexpr int kMaxQRegBoxesS = 3;
constexpr int kMaxPartsS = 16;

template <int QREGS>
__global__ void __launch_bounds__(kThreads, 1)
dot_only_tma_kernel(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tc,
                    unsigned int* __restrict__ out,  // (b_pad, 128), zeroed
                    const Geometry g, int run, int stride) {
  auto begin = [] {};
  auto fold = [&](int32_t (&acc)[32], const Cell& c, int s, int half, int pos) {
    const int at = pos & (run - 1);
    if (at < run - 2 || (stride && s + stride < g.n_super)) return;  // runs go on
    // value i: row c.row + 8 ((i >> 1) & 1), lane 64 half + c.col +
    // 8 (i >> 2) + (i & 1): one base and constant offsets, so the adds take
    // no address registers while the next products run
    unsigned int* base = out + (size_t)c.row * kLanes + half * kDocRows + c.col;
    const bool rows[2] = {c.row < g.b_pad, c.row + 8 < g.b_pad};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      if (!rows[(i >> 1) & 1]) continue;
      atomicAdd(base + 8 * kLanes * ((i >> 1) & 1) + 8 * (i >> 2) + (i & 1),
                static_cast<uint32_t>(acc[i]));
    }
  };
  auto finish = [](const Cell&, int, int, int) {};
  stream_tiles<QREGS, MmaS8, 1, false, true>(g, &tq, &tc, begin, fold, finish,
                                             run, stride > 0);
}

}  // namespace

// Kernel S into out (b_pad, 128) int32, zeroed here on the stream first.
// paired: 2-block clusters at an even number of query tiles (else each
// block loads whole tiles). run_cap in 1 .. 128 (measurement only): supers
// split into at most 128 / run_cap parts, runs of at most run_cap
// sub-blocks (rounded down to a power of two, at least 2) even where the
// int32 sums may overflow; 0: the longest run that cannot.
extern "C" int oi_dot_only_tma(const void* q, const void* corpus, void* out,
                               int b_pad, int dim, int n_super, int paired,
                               int run_cap, void* stream) {
  if (dim <= 0 || dim % 16 || b_pad <= 0 || b_pad % 32 || n_super <= 0 ||
      run_cap < 0 || run_cap > kSuper)
    return (int)cudaErrorInvalidValue;
  const int max_parts = run_cap ? (kSuper / run_cap > 1 ? kSuper / run_cap : 1)
                                : kMaxPartsS;
  Geometry g = plan(dim, 1, b_pad, n_super, max_parts, kMaxQRegBoxesS, 0,
                    paired != 0);
  int run = kSuper / g.parts;  // a power of two, >= 8 (the fold masks by it)
  if (run_cap > 0) {
    while (run > 2 && run > run_cap) run /= 2;
  } else {
    while (run > 2 && (long long)(run / 2) * dim * 16384 > INT_MAX) run /= 2;
  }
  // runs across a block's units (dense_topk.dot_only_plan mirrors this)
  int stride = 0;
  const int units = n_super * 2 * g.parts, step = 2 * g.parts;
  const int trimmed = g.ctas_per_qt / step * step;
  if (!run_cap && run == kSuper / g.parts && trimmed > 0) {
    const int rounds = (units + trimmed - 1) / trimmed;
    if (rounds == (units + g.ctas_per_qt - 1) / g.ctas_per_qt &&
        (long long)rounds * (run / 2) * dim * 16384 <= INT_MAX) {
      g.ctas_per_qt = trimmed;
      stride = trimmed / step;
    }
  }
  CUtensorMap tq, tc;
  if (!encode_rows(&tq, q, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, b_pad, dim,
                   kQueryRows) ||
      !encode_rows(&tc, corpus, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1,
                   (uint64_t)n_super * kSuper * kLanes, dim,
                   kDocRows / g.cluster))
    return (int)cudaErrorNotSupported;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      cudaMemsetAsync(out, 0, (size_t)b_pad * kLanes * sizeof(int32_t), st);
  if (err != cudaSuccess) return (int)err;
  unsigned int* o = static_cast<unsigned int*>(out);
  return with_qregs<kMaxQRegBoxesS>(g, [&](auto qregs) {
    return launch_stream(dot_only_tma_kernel<decltype(qregs)::value>, g, st, tq,
                         tc, o, g, run, stride);
  });
}

// Kernels C1 and C2 on Hopper's stream: int8 candidate cells, the top-1
// (C1, SLOTS = 1) or top-2 (C2, SLOTS = 2) keys per (query, super, lane),
// through TMA and wgmma (stream_tiles of tma_stream.cuh).
//
// Replaces openintel_tpu/ops/pallas/dense_topk.py:_turbo_kernel_i8 (C1) and
// _turbo_kernel_i8_top2 (C2), launched by dense_topk_fast_i8 (slots 1, 2)
// through i8_turbo_cells, and by the candidate-pass measurement tools. The
// mma.sync kernel of turbo_i8.cu stays as the A/B control behind
// i8_turbo_cells_v1. Same cells, bit for bit: cell (b, s, l), for the 128
// docs s * 16384 + 128 pos + l of the row-major (N_pad, D) int8 corpus,
//
//   key = dot(q_b, doc) * 128 + FLAG128 + pos   (int32, wrapping)
//
// A cell's 128 keys carry distinct pos, so its top-1 and top-2 are unique:
// neither the walk order nor a split of the super changes them. Output:
// (b_pad, SLOTS * n_super * 128) int32, column s * 128 + l of slot j's half
// the cell's j-th key; all supers' slot-1 keys first, then their slot-2
// keys, the reference's concat(p1, p2).
//
// What bounds it on an H100 at the measurement path's shapes (B=256,
// N=1.25M, D=384): device memory, 0.49-0.50 GB read and written in
// 0.148 ms (C1) and 0.151 ms (C2) at 3.35 TB/s, with the 0.25 TOP of int8
// products (0.125 ms at the tensor cores' peak) close behind. The mma.sync
// kernel ran at 18-19 % of that: each of 8 query tiles reread the corpus
// from L2 and each warp waited on its own loads. Here the corpus is kernel
// A's, on A's stream: 64-doc tiles by TMA into a shared-memory ring, the
// products on wgmma with the queries in registers (from shared memory, or
// streamed with each doc box, for rows too wide), and each consumer
// thread folds its 32 cells' keys (a running max, or kernel A's per-key
// top-2) after the next sub-block's products are issued. C1 pairs the
// blocks of query tiles 2k and 2k + 1 in a cluster, as kernel A does, so
// a tile is loaded once per 256 queries. C2 does not: its consumers, not
// the stream, set its pace (tools/stream_ablation.py with the loads
// compiled out: the fold does not overlap the products in the same warps,
// and at B=256 products plus fold outlast the stream), and unpaired blocks
// measured 3 % faster on an H100 (PERF.md). Parts of a super (for an even
// spread over the SMs) meet as kernels E's do: C1's by atomicMax on cells
// first set to INT_MIN, C2's through per-part buffers merged by merge_top2
// (tma_stream.cuh) in the same call.
//
// Measurement builds only (tools/stream_ablation.py), -DOI_C_FOLD=: 1
// keeps two wgmma groups in flight over three accumulator sets; 2 folds
// two sub-blocks at a time (three sets), the best key of four by one
// three-input max (Hopper's DPX __vimax3_s32); 3 runs C2's slot 2 on the
// float pipe (exact up to D = 505 only). 0, the library the port loads, is
// the single-sub-block integer fold under one group in flight.
// -DOI_C_QSMEM=1 keeps the queries in shared memory (below); -DOI_C_PAIRED=1
// runs C2 in clusters as C1.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "tma_stream.cuh"

#ifndef OI_C_FOLD
#define OI_C_FOLD 0
#endif
#ifndef OI_C_PAIRED  // measurement builds: C2 in 2-block clusters too
#define OI_C_PAIRED 0
#endif

namespace {

using namespace oi_tma;

// (bias 32768 + the reference's normal-float flag 2^23) << 7
constexpr int32_t kFlag128 = (32768 + (1 << 23)) * 128;
// Query boxes in registers (D <= 384): beside acc0, acc1, a1 and a2 more
// would spill (kernel A, the same state, spilled at 4). A measurement
// build, -DOI_C_QSMEM=1, reads them from shared memory at every width
// (wgmma's ss form).
#ifndef OI_C_QSMEM
#define OI_C_QSMEM 0
#endif
constexpr int kMaxQRegBoxesC = OI_C_QSMEM ? 0 : 3;
constexpr int kFlight = OI_C_FOLD == 1 ? 2 : 1;  // wgmma groups left running

__device__ __forceinline__ int32_t cell_key(int32_t acc, uint32_t bias) {
  return static_cast<int32_t>(static_cast<uint32_t>(acc) * 128u + bias);
}

template <int QREGS, int SLOTS>
__global__ void __launch_bounds__(kThreads, 1)
turbo_i8_tma_kernel(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tc,
                    int32_t* __restrict__ out,  // (b_pad, SLOTS * n_super * 128)
                    int32_t* __restrict__ parts_out,  // C2: parts 1 .. parts - 1
                    const Geometry g) {
  int32_t a1[32], a2[32];
  const size_t half_w = (size_t)g.n_super * kLanes;  // one slot's columns
  auto begin = [&] {
#pragma unroll
    for (int i = 0; i < 32; ++i) a1[i] = a2[i] = INT_MIN;
  };
  auto fold = [&](int32_t (&acc)[32], const Cell&, int, int, int pos) {
    const uint32_t bias = static_cast<uint32_t>(kFlag128 + pos);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int32_t key = cell_key(acc[i], bias);
#if OI_C_FOLD == 3
      // slot 2 on the float pipe: up to D = 505 every key is a positive
      // normal float (the reference's flag), ordered as its int32 bits;
      // INT_MIN is -0.0, below them all
      if (SLOTS == 2)
        a2[i] = __float_as_int(fmaxf(__int_as_float(a2[i]),
                                     fminf(__int_as_float(a1[i]), __int_as_float(key))));
#else
      if (SLOTS == 2) a2[i] = max(a2[i], min(a1[i], key));
#endif
      a1[i] = max(a1[i], key);
    }
  };
  auto finish = [&](const Cell& c, int s, int half, int part) {
    int32_t* buf = SLOTS == 1 || part == 0
                       ? out
                       : parts_out + (size_t)(part - 1) * g.b_pad * 2 * half_w;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int row = c.row + 8 * ((i >> 1) & 1);
      if (row >= g.b_pad) continue;
      const int col = s * kLanes + half * kDocRows + c.col + 8 * (i >> 2) + (i & 1);
      int32_t* p = buf + (size_t)row * SLOTS * half_w + col;
      if (SLOTS == 2) {
        p[0] = a1[i];
        p[half_w] = a2[i];
      } else if (g.parts == 1) {
        *p = a1[i];
      } else {
        atomicMax(p, a1[i]);
      }
    }
  };
#if OI_C_FOLD == 2
  // sub-blocks pos and pos + 1: a1 takes the best of three, a2 the second
  // of {a1, a2, x, y} = max(a2, min(x, y), min(a1, max(x, y)))
  auto fold_pair = [&](int32_t (&ax)[32], int32_t (&ay)[32], const Cell&, int,
                       int, int pos) {
    const uint32_t bias = static_cast<uint32_t>(kFlag128 + pos);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int32_t x = cell_key(ax[i], bias), y = cell_key(ay[i], bias + 1u);
      if (SLOTS == 2) a2[i] = __vimax3_s32(a2[i], min(x, y), min(a1[i], max(x, y)));
      a1[i] = __vimax3_s32(a1[i], x, y);
    }
  };
  stream_tiles<QREGS, MmaS8, 1, true>(g, &tq, &tc, begin, fold_pair, finish);
#else
  stream_tiles<QREGS, MmaS8, kFlight>(g, &tq, &tc, begin, fold, finish);
#endif
}

template <int SLOTS>
int launch_i8(const CUtensorMap& tq, const CUtensorMap& tc, int32_t* out,
              int32_t* parts_out, const Geometry& g, cudaStream_t st) {
  return with_qregs<kMaxQRegBoxesC>(g, [&](auto qregs) {
    return launch_stream(turbo_i8_tma_kernel<decltype(qregs)::value, SLOTS>, g,
                         st, tq, tc, out, parts_out, g);
  });
}

}  // namespace

// Kernel C1 (slots 1) or C2 (slots 2) into out (b_pad, slots * n_super *
// 128). Supers split into at most max_parts parts; C2 with more than one
// part needs parts_out, scratch of (max_parts - 1) * b_pad * 2 * n_super *
// 128 int32.
extern "C" int oi_turbo_i8_tma(const void* q, const void* corpus, void* out,
                               void* parts_out, int slots, int b_pad, int dim,
                               int n_super, int max_parts, void* stream) {
  if (dim <= 0 || dim % 16 || b_pad <= 0 || b_pad % 32 || n_super <= 0 ||
      (slots != 1 && slots != 2) || max_parts < 1)
    return (int)cudaErrorInvalidValue;
  const Geometry g = plan(dim, 1, b_pad, n_super, max_parts, kMaxQRegBoxesC, 0,
                          slots == 1 || OI_C_PAIRED);
  if (slots == 2 && g.parts > 1 && !parts_out) return (int)cudaErrorInvalidValue;
  CUtensorMap tq, tc;
  if (!encode_rows(&tq, q, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, b_pad, dim,
                   kQueryRows) ||
      !encode_rows(&tc, corpus, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1,
                   (uint64_t)n_super * kSuper * kLanes, dim,
                   kDocRows / g.cluster))
    return (int)cudaErrorNotSupported;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  int32_t* o = static_cast<int32_t*>(out);
  int32_t* po = static_cast<int32_t*>(parts_out);
  const int half_w = n_super * kLanes;
  if (slots == 1) {
    if (g.parts > 1) {
      const int err = fill(o, (size_t)b_pad * half_w, INT_MIN, st);
      if (err) return err;
    }
    return launch_i8<1>(tq, tc, o, po, g, st);
  }
  const int err = launch_i8<2>(tq, tc, o, po, g, st);
  if (err || g.parts == 1) return err;
  return merge_top2(o, po, b_pad, half_w, g.parts, st);
}

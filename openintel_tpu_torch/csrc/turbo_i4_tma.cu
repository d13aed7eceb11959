// Kernels E1 and E2 on Hopper's stream: int8 queries x nibble-packed int4
// corpus, the top-1 (E1, SLOTS = 1) or top-2 (E2, SLOTS = 2) keys per
// (query, super, lane), through TMA, an unpack in shared memory and wgmma
// (stream_packed_tiles of tma_stream.cuh).
//
// Replaces openintel_tpu/ops/pallas/dense_topk.py:_turbo_kernel_i4 (E1) and
// _turbo_kernel_i4_top2 (E2), launched by dense_topk_fast_i4 (slots 1, 2;
// the `kernel="int4"` dense arm runs E2) through i4_cells. The mma.sync
// kernel of turbo_i4.cu stays as the A/B control behind i4_cells_v1. Same
// cells, bit for bit:
//
//   key = dot * 128 + FLAG128 + pos,  pos = 2 t + parity,
//
// for doc s * 16384 + 2 (128 t + l) + parity, byte row s * 8192 + 128 t + l
// of the (N_pad / 2, D) packed corpus (low nibble: parity 0). |dot| <=
// 127 * 8 * D, so the key stays in (0, 2^31) for D below 8,000. A cell's
// 128 keys are distinct, so its top-1 and top-2 are unique and order-free.
//
// What bounds it on an H100 at the main path's shapes (B=256, N=1.25M,
// D=384): the int8 products, 0.25 TOP in 0.125 ms at the tensor cores'
// peak; the packed corpus is 0.24 GB (0.073 ms of device memory). The
// mma.sync kernel lost to its loop (each of 8 query tiles reread the
// corpus from L2, each warp waited on its own loads and unpacked the
// nibbles for its own 32 queries). Here a packed tile is loaded by TMA once
// per 256 queries (a 2-block cluster, multicast), unpacked once per block
// by the producer warpgroup's idle warps into int8 tiles that wgmma reads
// as its B operand (sm_90 has no s4 input; each nibble n becomes 16 n,
// two or one integer ops a word, and the fold takes the dot * 128 of the
// key as acc * 8, exact), while the consumers hold the
// queries in registers and fold each sub-block's keys (a running max, or
// kernel A's per-key top-2) under the next one's products. Measured with
// tools/stream_ablation.py (H100 80GB HBM3, 700 W, B=256): E2 0.318 ms, of
// which the TMA ring alone is 0.120 and the products and unpack without
// the fold 0.182; the fold adds 0.136 and the unpack 0.066 (E2 without it
// 0.252); E1 0.270 (ring 0.104, no fold 0.168, no unpack 0.182). So what
// bounds E now is its fold, as for kernel A, then the unpack, which at
// B=256 each block of a cluster does for the same tile.
//
// Parts of a super (for an even spread over the SMs) meet as kernel D's
// do for E1: atomicMax on cells first set to INT_MIN. E2's top-2 cannot:
// each part writes its (top-1, top-2) to its own buffer (part 0: the
// output), and a second kernel in the same call merges them by the
// reference's combine, a2 = max(min(a1, b1), max(a2, b2)), exact for
// distinct keys and so order-free (merge_top2 of tma_stream.cuh, which
// kernel C2 shares; merge_part_cells_plain is its twin).

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "tma_stream.cuh"

namespace {

using namespace oi_tma;

// (bias 32768 + the reference's normal-float flag 2^23) << 7
constexpr int32_t kFlag128 = (32768 + (1 << 23)) * 128;
// Query boxes in registers: a tile's boxes must fit one unpacked stage
// (boxes_per_stage(q) = q only up to 3), and beside acc0, acc1, a1 and a2
// more would spill (kernel A, the same state, spilled at 4).
constexpr int kMaxQRegBoxesE = 3;

template <int QREGS, int SLOTS>
__global__ void __launch_bounds__(kThreads, 1)
turbo_i4_tma_kernel(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tc,
                    int32_t* __restrict__ out,  // (b_pad, SLOTS * n_super * 128)
                    int32_t* __restrict__ parts_out,  // E2: parts 1 .. parts - 1
                    const Geometry g, int p_stages) {
  int32_t a1[32], a2[32];
  const size_t half_w = (size_t)g.n_super * kLanes;  // one slot's columns
  stream_packed_tiles<QREGS, MmaS8>(
      g, p_stages, &tq, &tc,
      [&] {
#pragma unroll
        for (int i = 0; i < 32; ++i) a1[i] = a2[i] = INT_MIN;
      },
      [&](int32_t (&acc)[32], const Cell&, int, int, int pos) {
        const uint32_t bias = static_cast<uint32_t>(kFlag128 + pos);
#pragma unroll
        for (int i = 0; i < 32; ++i) {  // acc = 16 dot: dot * 128 = acc * 8
          const int32_t key =
              static_cast<int32_t>(static_cast<uint32_t>(acc[i]) * 8u + bias);
          if (SLOTS == 2) a2[i] = max(a2[i], min(a1[i], key));
          a1[i] = max(a1[i], key);
        }
      },
      [&](const Cell& c, int s, int half, int part) {
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
      });
}

template <int SLOTS>
int launch_i4(const CUtensorMap& tq, const CUtensorMap& tc, int32_t* out,
              int32_t* parts_out, const Geometry& g, int p_stages,
              cudaStream_t st) {
  const int smem = packed_smem_bytes(g, p_stages);
  return with_qregs<kMaxQRegBoxesE>(g, [&](auto qregs) {
    return launch_stream_smem(
        turbo_i4_tma_kernel<decltype(qregs)::value, SLOTS>, g, smem, st, tq,
        tc, out, parts_out, g, p_stages);
  });
}

}  // namespace

// Kernel E1 (slots 1) or E2 (slots 2) into out (b_pad, slots * n_super *
// 128). Supers split into at most max_parts parts; E2 with more than one
// part needs parts_out, scratch of (max_parts - 1) * b_pad * 2 * n_super *
// 128 int32.
extern "C" int oi_turbo_i4_tma(const void* q, const void* corpus, void* out,
                               void* parts_out, int slots, int b_pad, int dim,
                               int n_super, int max_parts, void* stream) {
  if (dim <= 0 || dim % 16 || dim >= 8000 || b_pad <= 0 || b_pad % 32 ||
      n_super <= 0 || (slots != 1 && slots != 2) || max_parts < 1)
    return (int)cudaErrorInvalidValue;
  int p_stages = 0;
  const Geometry g =
      plan_packed(dim, b_pad, n_super, max_parts, kMaxQRegBoxesE, &p_stages);
  if (slots == 2 && g.parts > 1 && !parts_out) return (int)cudaErrorInvalidValue;
  CUtensorMap tq, tc;
  if (!encode_rows(&tq, q, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, b_pad, dim,
                   kQueryRows) ||
      !encode_rows(&tc, corpus, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1,
                   (uint64_t)n_super * (kSuper / 2) * kLanes, dim,
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
    return launch_i4<1>(tq, tc, o, po, g, p_stages, st);
  }
  const int err = launch_i4<2>(tq, tc, o, po, g, p_stages, st);
  if (err || g.parts == 1) return err;
  return merge_top2(o, po, b_pad, half_w, g.parts, st);
}

// Kernel A on Hopper's stream: int8 candidate cells, top-2 keys per (query,
// lane, group), in two stages: TMA + wgmma per-step top-2s, then the
// ordered group fold.
//
// Replaces openintel_tpu/ops/pallas/dense_topk.py:_turbo_kernel_i8_top2g
// (dense_topk_fast_i8_grouped, the default dense arm at 100k docs and more,
// through i8_top2g_cells). Same cells as the mma.sync kernel (i8_top2g.cu, kept
// as the A/B control behind i8_top2g_cells_v1), bit for bit:
//
//   key = dot(q, doc) * 128 + FLAG128 + pos   (int32, wrapping)
//
// with pos the doc's sub-block within its super. Per step of `sub`
// sub-blocks a (query, lane) takes the exact top-2 of its keys (distinct,
// so order-free); the steps of a group of `group` supers then fold in
// ascending order by the reference's merge. That merge is not associative
// (three steps sharing one slot-1 key end with other super labels under a
// tree merge), so a group is never split into partial states.
//
// Stage 1, i8_steps_tma_kernel: the stream of tma_stream.cuh (128 queries
// per block, 64-doc tiles by TMA, wgmma m64n64k32 s8 -> s32), each thread
// keeping acc, a1, a2 for its 32 cells; at each step's end it writes the
// step's (a1, a2) to `steps` (n_steps, b_pad, 128, 2) int32. Units hold
// whole steps, so no step is split. Stage 2, i8_fold_kernel: one thread per
// (query, group, lane) reads its group's steps in order and folds them
// with the reference's merge (coalesced over lanes).
//
// What bounds it on an H100 at the main path's shapes (B=256, N=1.25M,
// D=384, group 10, sub 64): the floor is device memory, 0.48 GB in 0.146
// ms, with the int8 tensor-core time (0.125 ms) close behind; the steps
// add 40 MB written and read. The mma.sync kernel lost to the stream (8 query
// tiles rereading the corpus from L2, each warp waiting on its own loads)
// and to its grid (one warp per 8 lanes and group, each folding its
// group's supers in order). Here a doc tile is loaded once per 256 queries
// into a ring by TMA, the products run on wgmma with the queries in
// registers, and the order-dependent fold moves to stage 2, whose
// parallelism no longer depends on the groups. Measured with
// tools/stream_ablation.py (H100 80GB HBM3, 700 W): the stream alone,
// products and fold compiled out, takes 0.19 ms (2.5 TB/s); the products
// add nothing; the per-sub-block top-2 fold adds 0.13 ms at B=256 (0.04
// at B=128), so the fold in the consumer warps is what bounds it now.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "tma_stream.cuh"

namespace {

using namespace oi_tma;

// (bias 32768 + the reference's normal-float flag 2^23) << 7
constexpr int32_t kFlag128 = (32768 + (1 << 23)) * 128;
constexpr int kMaxQRegBoxesA = 3;  // query boxes in registers (D <= 384)

template <int QREGS>
__global__ void __launch_bounds__(kThreads, 1)
i8_steps_tma_kernel(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tc,
                    int32_t* __restrict__ steps,  // (n_steps, b_pad, 128, 2)
                    const Geometry g, int sub) {
  int32_t a1[32], a2[32];
  const int sps = kSuper / sub;  // steps per super
  const int last = sub - 1;      // sub is a power of two: pos & last is
  const int shift = __ffs(sub) - 1;  // pos % sub, pos >> shift is pos / sub
  stream_tiles<QREGS, MmaS8>(
      g, &tq, &tc,
      [] {},
      [&](int32_t (&acc)[32], const Cell& c, int s, int half, int pos) {
        if ((pos & last) == 0) {
#pragma unroll
          for (int i = 0; i < 32; ++i) a1[i] = a2[i] = INT_MIN;
        }
        const uint32_t bias = static_cast<uint32_t>(kFlag128 + pos);
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int32_t key =
              static_cast<int32_t>(static_cast<uint32_t>(acc[i]) * 128u + bias);
          a2[i] = max(a2[i], min(a1[i], key));
          a1[i] = max(a1[i], key);
        }
        if ((pos & last) != last) return;
        const size_t step = (size_t)s * sps + (pos >> shift);
#pragma unroll
        for (int i = 0; i < 32; i += 2) {
          const int row = c.row + 8 * ((i >> 1) & 1);
          if (row >= g.b_pad) continue;
          const int lane = half * kDocRows + c.col + 8 * (i >> 2);  // even
          // one sub-block per step: slot 2 is the reference's sentinel 0
          const int4 v = make_int4(a1[i], sub == 1 ? 0 : a2[i], a1[i + 1],
                                   sub == 1 ? 0 : a2[i + 1]);
          *reinterpret_cast<int4*>(
              steps + ((step * g.b_pad + row) * kLanes + lane) * 2) = v;
        }
      },
      [](const Cell&, int, int, int) {});
}

// Group g's state of (query row, lane): its steps folded in ascending order
// by the reference's merge (ties keep the incumbent in slot 1).
__global__ void i8_fold_kernel(const int2* __restrict__ steps,
                               int32_t* __restrict__ out_k1,
                               int32_t* __restrict__ out_k2,
                               int32_t* __restrict__ out_s1,
                               int32_t* __restrict__ out_s2, int b_pad,
                               int n_super, int group, int sps, int ng) {
  const size_t idx = blockIdx.x * (size_t)blockDim.x + threadIdx.x;
  if (idx >= (size_t)b_pad * ng * kLanes) return;
  const int lane = idx % kLanes;
  const int gi = (idx / kLanes) % ng;
  const int row = idx / ((size_t)kLanes * ng);
  const int lo = gi * group;
  const int hi = min(lo + group, n_super);
  const size_t stride = (size_t)b_pad * kLanes;  // int2s per step
  const int2* p = steps + (size_t)row * kLanes + lane;
  int2 a = p[(size_t)lo * sps * stride];
  int32_t g1 = a.x, g2 = a.y, gs1 = lo, gs2 = lo;
  for (int t = lo * sps + 1; t < hi * sps; ++t) {
    a = p[(size_t)t * stride];
    const int cur = t / sps;
    const bool upd1 = a.x > g1;
    const int32_t m = min(g1, a.x);  // displaced slot-1 loser
    const int32_t sup_m = upd1 ? gs1 : cur;
    const int32_t c2 = max(g2, a.y);
    const int32_t sup_c2 = a.y > g2 ? cur : gs2;
    g1 = max(g1, a.x);
    gs1 = upd1 ? cur : gs1;
    g2 = max(m, c2);
    gs2 = m >= c2 ? sup_m : sup_c2;
  }
  out_k1[idx] = g1;
  out_k2[idx] = g2;
  out_s1[idx] = gs1;
  out_s2[idx] = gs2;
}

int launch_fold(const void* steps, void* k1, void* k2, void* s1, void* s2,
                int b_pad, int n_super, int group, int sub,
                cudaStream_t stream) {
  const int ng = (n_super + group - 1) / group;
  const size_t n = (size_t)b_pad * ng * kLanes;
  i8_fold_kernel<<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
      static_cast<const int2*>(steps), static_cast<int32_t*>(k1),
      static_cast<int32_t*>(k2), static_cast<int32_t*>(s1),
      static_cast<int32_t*>(s2), b_pad, n_super, group, kSuper / sub, ng);
  return (int)cudaGetLastError();
}

bool bad_shape(int b_pad, int n_super, int group, int sub) {
  return b_pad <= 0 || b_pad % 32 || n_super <= 0 || group < 1 || sub < 1 ||
         kSuper % sub;
}

}  // namespace

// Both stages; `steps` is scratch of n_super * (128 / sub) * b_pad * 256
// int32.
extern "C" int oi_i8_top2g_tma(const void* q, const void* corpus, void* k1,
                               void* k2, void* s1, void* s2, void* steps,
                               int b_pad, int dim, int n_super, int group,
                               int sub, void* stream) {
  if (dim % 16 || bad_shape(b_pad, n_super, group, sub))
    return (int)cudaErrorInvalidValue;
  // parts of a super hold whole steps: at most 128 / sub of them; beside
  // acc, a1 and a2 per cell, queries of more than 3 boxes would spill
  const Geometry g = plan(dim, 1, b_pad, n_super, kSuper / sub, kMaxQRegBoxesA);
  CUtensorMap tq, tc;
  if (!encode_rows(&tq, q, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, b_pad, dim,
                   kQueryRows) ||
      !encode_rows(&tc, corpus, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1,
                   (uint64_t)n_super * kSuper * kLanes, dim,
                   kDocRows / g.cluster))
    return (int)cudaErrorNotSupported;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int err = with_qregs<kMaxQRegBoxesA>(g, [&](auto qregs) {
    return launch_stream(i8_steps_tma_kernel<decltype(qregs)::value>, g, st,
                         tq, tc, static_cast<int32_t*>(steps), g, sub);
  });
  if (err) return err;
  return launch_fold(steps, k1, k2, s1, s2, b_pad, n_super, group, sub, st);
}

// Stage 2 alone, on steps a call of oi_i8_top2g_tma left (for timing).
extern "C" int oi_i8_fold(const void* steps, void* k1, void* k2, void* s1,
                          void* s2, int b_pad, int n_super, int group,
                          int sub, void* stream) {
  if (bad_shape(b_pad, n_super, group, sub)) return (int)cudaErrorInvalidValue;
  return launch_fold(steps, k1, k2, s1, s2, b_pad, n_super, group, sub,
                     static_cast<cudaStream_t>(stream));
}

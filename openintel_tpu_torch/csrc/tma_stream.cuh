// The Hopper corpus stream of kernels A (i8_top2g_tma.cu), B on bf16 rows
// (fused_topk_v2.cu), C1/C2 (turbo_i8_tma.cu), D on bf16 rows
// (turbo_bf16_tma.cu), E1/E2 (turbo_i4_tma.cu) and S (dot_only_tma.cu):
// TMA loads into a ring of shared-memory tiles, consumed by wgmma.
//
// A block holds 128 queries (two consumer warpgroups of 64) and walks work
// units of (super, lane half, part of the super's 128 sub-blocks). A doc
// tile is 64 rows: lanes 64 h .. 64 h + 63 of one 128-doc sub-block, so a
// tile's products are one wgmma n64 per k step, and each consumer thread
// holds 32 cells (its accumulator fragment). With an even number of query
// tiles (B = 256: two) the blocks of query tiles 2k and 2k + 1 form a
// cluster (unless the kernel plans without pairs, as C2) that walks the
// same units: each block loads half of every doc tile's rows and
// multicasts it to both, so a doc tile is read from device memory once per
// 256 queries. The grid is persistent: ctas_per_qt blocks
// per query tile, each taking units c, c + ctas_per_qt, ...; the host
// splits supers into parts so the units divide evenly over the blocks.
//
// Roles (no block barrier after the set-up; setmaxnreg moves registers
// from the producer warpgroup, 40 a thread, to the consumers, 232):
// - one producer thread (warp 8) keeps TMA loads in flight: per ring stage
//   (up to 3 of a tile's 128-byte K boxes) cp.async.bulk.tensor loads
//   completing on the stage's `full` mbarrier, after a wait on its
//   `empty` mbarrier, which in a cluster counts the releases of both
//   blocks (the peer's loads land in this block's stage too); at the end
//   it waits for every stage's last release, so no peer still reads its
//   loads or arrives on its barriers when the block exits;
// - warps 0-7 (two warpgroups) wait on `full`, issue the stage's wgmma k
//   steps and commit them as one group, then wait until only that group
//   is pending (wait_group 1) and release the stage before it (one
//   `empty` arrival per warp). Two accumulator sets take alternate
//   sub-blocks: the kernel's fold of sub-block p - 1 runs while sub-block
//   p's first group is on the tensor cores;
// - for a nibble-packed corpus (kernels E), warps 9-11 unpack each loaded
//   box into two int8 tiles of a second ring, which the consumers read
//   (stream_packed_tiles, below; its warpgroups split the registers 56 and
//   224, so the unpacking loop does not spill).
// Queries stay in shared memory for the whole kernel (one TMA load per
// box) when they fit beside a ring of 4 stages; rows of up to 6 boxes
// (768 bytes) are then moved once into registers as wgmma A fragments, so
// the tensor cores read only the doc tile from shared memory (half the
// shared-memory traffic of two shared operands, which at n64 matched the
// tensor cores' own time). Wider rows stream each box's 128 query rows
// with the doc box instead.
//
// Layout: both operands row-major (rows, row_bytes), K-major for wgmma,
// loaded in boxes of (rows x 128 bytes) with the 128-byte swizzle; bytes
// past row_bytes are zero-filled by TMA, so they add 0 to every dot.

#pragma once

#include <cstdint>
#include <cuda.h>  // CUtensorMap and the types of cuTensorMapEncodeTiled
#include <type_traits>
#include <cuda_runtime.h>

// Measurement builds only (tools/stream_ablation.py): 1 drops the kernels'
// fold callbacks, 2 the wgmma products too, leaving the stream alone (and
// the unpack of kernels E); 3 drops kernels E's unpack alone, so wgmma
// reads its tiles as the unpacked ring last held them; 4 drops all three,
// leaving E's rings and barriers; 5 drops the doc loads (the producer
// arrives on each stage's barrier without loading, and the consumers run
// on what the ring holds), so the consumers alone set the pace; 6 drops
// the loads and the fold; 7 the loads and the products, leaving the fold
// alone; 8 the products alone, leaving the stream and the fold. The
// library the port loads is built without it (0).
#ifndef OI_STREAM_ABLATE
#define OI_STREAM_ABLATE 0
#endif
// Measurement builds only: 1 runs every kernel without clusters, so each
// block loads whole doc tiles itself, also at an even number of query
// tiles (the multicast and the paired release of stages gone).
#ifndef OI_STREAM_NO_CLUSTER
#define OI_STREAM_NO_CLUSTER 0
#endif

namespace oi_tma {

constexpr bool kFoldOn = OI_STREAM_ABLATE != 1 && OI_STREAM_ABLATE != 2 &&
                         OI_STREAM_ABLATE != 4 && OI_STREAM_ABLATE != 6;
constexpr bool kProductsOn = OI_STREAM_ABLATE != 2 && OI_STREAM_ABLATE != 4 &&
                             OI_STREAM_ABLATE != 7 && OI_STREAM_ABLATE != 8;
constexpr bool kUnpackOn = OI_STREAM_ABLATE != 3 && OI_STREAM_ABLATE != 4;
constexpr bool kLoadsOn =
    OI_STREAM_ABLATE != 5 && OI_STREAM_ABLATE != 6 && OI_STREAM_ABLATE != 7;

constexpr int kBoxBytes = 128;   // K bytes per TMA box: one swizzled row
constexpr int kQueryRows = 128;  // queries per block (two warpgroups of 64)
constexpr int kDocRows = 64;     // docs per tile: half a sub-block (wgmma n)
constexpr int kLanes = 128;      // docs per sub-block (= lanes)
constexpr int kSuper = 128;      // sub-blocks per 16,384-doc super
constexpr int kConsumerWarps = 8;
constexpr int kThreads = 32 * (kConsumerWarps + 4);  // + the producer warpgroup
constexpr int kQBox = kQueryRows * kBoxBytes;        // 16 KB
constexpr int kDBox = kDocRows * kBoxBytes;          // 8 KB
constexpr int kMaxStages = 16;
constexpr int kMinResidentStages = 4;
constexpr int kSmemMax = 232448;  // dynamic shared memory one block may use
constexpr int kBarBytes = 8 * (2 * kMaxStages + 1);
constexpr int kMaxParts = 16;  // parts per super, at most (8 sub-blocks each)

// What the host decides per launch; the kernel reads it.
struct Geometry {
  int row_bytes;     // bytes per query and doc row (a multiple of 16)
  int box_cols;      // elements per 128-byte box (the maps' column step)
  int n_box;         // 128-byte K boxes per row
  int b_pad;         // query rows; rows past it are neither read nor stored
  int n_super;
  int n_qt;          // 128-query tiles
  int cluster;       // blocks per cluster: 2 pairs query tiles 2k, 2k + 1
  int ctas_per_qt;   // blocks per 128-query tile
  int parts;         // parts per super (units = n_super * 2 * parts)
  int stages;        // ring stages
  int kb;            // doc boxes per stage (1 when queries stream)
  int qregs;         // boxes of queries held in registers (0: none)
  int qstream;       // 1: queries stream with each doc box
};

// Doc boxes per ring stage for a kernel holding qregs boxes of queries in
// registers: a whole sub-block's boxes up to 3, else half of them; one
// box when the queries are read from shared memory.
__host__ __device__ constexpr int boxes_per_stage(int qregs) {
  return qregs <= 0 ? 1 : qregs <= 3 ? qregs : (qregs + 1) / 2;
}

// ---------------------------------------------------------------------------
// Device: mbarriers, TMA, wgmma
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile(
      "{\n.reg .b64 state;\nmbarrier.arrive.shared::cta.b64 state, [%0];\n}\n" ::"r"(
          smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ uint32_t mbar_try_wait(uint32_t addr,
                                                  uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(addr), "r"(parity)
      : "memory");
  return done;
}

// Wait until the phase of the given parity has completed. A wait of more
// than ~2^34 cycles (seconds) can only be a broken pipeline: trap, so the
// launch fails with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  if (mbar_try_wait(addr, parity)) return;
  const long long start = clock64();
  while (!mbar_try_wait(addr, parity)) {
    if (clock64() - start > (1ll << 34)) __trap();
  }
}

// Arrive on the barrier at the same shared-memory offset in block `rank`
// of the cluster (this block's own included).
__device__ __forceinline__ void mbar_arrive_cluster(uint64_t* bar,
                                                    uint32_t rank) {
  asm volatile(
      "{\n.reg .b32 remote;\nmapa.shared::cluster.u32 remote, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [remote];\n}\n" ::"r"(
          smem_u32(bar)),
      "r"(rank)
      : "memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// Every thread of every block of the cluster (a block barrier too).
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// One box into the same shared-memory offset of every block in `mask`,
// completing bytes on each one's barrier at `bar`'s offset.
__device__ __forceinline__ void tma_load_multicast(void* dst,
                                                   const CUtensorMap* map,
                                                   uint64_t* bar, int c0,
                                                   int c1, uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes.multicast::cluster [%0], [%1, {%4, %5}], [%2], %3;\n" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "h"(mask),
      "r"(c0), "r"(c1)
      : "memory");
}

// One box of a 2-D tensor map (c0: element column, c1: row) into shared
// memory, completing `bytes` of the barrier's transaction count.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

// wgmma descriptor of a K-major operand in 128-byte swizzled rows, 8-row
// groups 1024 bytes apart; p is 1024-aligned plus the k offset in the row.
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  const uint64_t addr = smem_u32(p);
  return ((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>  // wait until at most N committed groups are pending
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving accumulator reads or writes across a wgmma
// fence or wait.
__device__ __forceinline__ void fence_regs(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
__device__ __forceinline__ void fence_regs(int32_t (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

#define OI_WGMMA_D32(c)                                                        \
  c(d[0]), c(d[1]), c(d[2]), c(d[3]), c(d[4]), c(d[5]), c(d[6]), c(d[7]),      \
      c(d[8]), c(d[9]), c(d[10]), c(d[11]), c(d[12]), c(d[13]), c(d[14]),      \
      c(d[15]), c(d[16]), c(d[17]), c(d[18]), c(d[19]), c(d[20]), c(d[21]),    \
      c(d[22]), c(d[23]), c(d[24]), c(d[25]), c(d[26]), c(d[27]), c(d[28]),    \
      c(d[29]), c(d[30]), c(d[31])
#define OI_WGMMA_REGS                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "    \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "     \
  "%30, %31}"
#define OI_F(x) "+f"(x)
#define OI_R(x) "+r"(x)

// The products of one k step (32 bytes of K): d (64 x 64) += a (64 rows)
// b^T (64 rows), both K-major. ss: a from shared memory (descriptor); rs: a
// from registers, this thread's fragment (rows gq, gq + 8 of its warp's 16;
// bytes 4 tq .. 4 tq + 3 and 16 + 4 tq .. of the step, as mma.sync's A).
struct MmaBf16 {  // bf16 x bf16 -> f32, m64n64k16
  using Acc = float[32];
  static __device__ __forceinline__ void ss(float (&d)[32], uint64_t a,
                                            uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " OI_WGMMA_REGS
        ", %32, %33, p, 1, 1, 0, 0;\n}\n"
        : OI_WGMMA_D32(OI_F)
        : "l"(a), "l"(b), "r"(scale_d));
  }
  static __device__ __forceinline__ void rs(float (&d)[32],
                                            const uint32_t (&a)[4], uint64_t b,
                                            int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " OI_WGMMA_REGS
        ", {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
        : OI_WGMMA_D32(OI_F)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

struct MmaS8 {  // s8 x s8 -> s32, m64n64k32
  using Acc = int32_t[32];
  static __device__ __forceinline__ void ss(int32_t (&d)[32], uint64_t a,
                                            uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 " OI_WGMMA_REGS
        ", %32, %33, p;\n}\n"
        : OI_WGMMA_D32(OI_R)
        : "l"(a), "l"(b), "r"(scale_d));
  }
  static __device__ __forceinline__ void rs(int32_t (&d)[32],
                                            const uint32_t (&a)[4], uint64_t b,
                                            int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 " OI_WGMMA_REGS
        ", {%32, %33, %34, %35}, %36, p;\n}\n"
        : OI_WGMMA_D32(OI_R)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

#undef OI_WGMMA_D32
#undef OI_WGMMA_REGS
#undef OI_F
#undef OI_R

// A consumer thread's cells: accumulator value i is query row
// `row + 8 * ((i >> 1) & 1)` and tile column `col + 8 * (i >> 2) + (i & 1)`
// (the wgmma m64nNk accumulator layout).
struct Cell {
  int row;  // query row of values 0, 1 (absolute)
  int col;  // tile column (doc lane - 64 h) of value 0
};

// A ring of stages in shared memory: full[i] completes when stage i holds
// its tiles, empty[i] when every reader has released it.
struct Ring {
  uint8_t* base;
  int stage_bytes;
  int stages;
  uint64_t* full;
  uint64_t* empty;
};

__device__ __forceinline__ void next_stage(uint32_t& stage, uint32_t& phase,
                                           int stages) {
  if (++stage == static_cast<uint32_t>(stages)) {
    stage = 0;
    phase ^= 1;
  }
}

// A consumer thread's first cell (warpgroup warp / 4 owns query rows
// 64 wg .. 64 wg + 63 of query tile qt).
__device__ __forceinline__ Cell consumer_cell(int qt, int warp, int lane) {
  return Cell{qt * kQueryRows + (warp >> 2) * 64 + 16 * (warp & 3) + (lane >> 2),
              2 * (lane & 3)};
}

// The producer thread. It loads the queries once (unless they stream),
// then walks the block's units: per tile (`tiles` per super: 128 sub-blocks
// of docs, or 64 byte sub-tiles of a packed corpus) its doc boxes in ring
// stages of up to g.kb boxes, with the query box when queries stream. In a
// cluster it loads this block's half of each box's rows into both blocks.
// At the end it waits until every stage is released by the readers of
// every block of the cluster: then no peer still reads what this block
// loaded, nor arrives on its barriers, and the block may exit.
__device__ __forceinline__ void produce(const Geometry& g, const CUtensorMap* tq,
                                        const CUtensorMap* tc, uint8_t* q_s,
                                        uint64_t* qbar, const Ring& r, int tiles,
                                        int qt, int cta, uint32_t rank) {
  const int q_row = qt * kQueryRows;
  if (!g.qstream) {
    mbar_expect_tx(qbar, g.n_box * kQBox);
    for (int b = 0; b < g.n_box; ++b)
      tma_load(q_s + b * kQBox, tq, qbar, b * g.box_cols, q_row);
  }
  const int units = g.n_super * 2 * g.parts;
  const int per_part = tiles / g.parts;
  uint32_t stage = 0, phase = 0;
  for (int u = cta; u < units; u += g.ctas_per_qt) {
    const int part = u % g.parts;
    const int half = (u / g.parts) & 1;
    const int s = u / (2 * g.parts);
    for (int t = part * per_part; t < (part + 1) * per_part; ++t) {
      const int row0 = (s * tiles + t) * kLanes + half * kDocRows;
      for (int b0 = 0; b0 < g.n_box; b0 += g.kb) {
        const int nb = g.n_box - b0 < g.kb ? g.n_box - b0 : g.kb;
        mbar_wait(&r.empty[stage], phase ^ 1);
        uint8_t* dst = r.base + stage * r.stage_bytes;
        if constexpr (!kLoadsOn) {
          mbar_arrive(&r.full[stage]);
        } else {
          mbar_expect_tx(&r.full[stage], nb * (kDBox + (g.qstream ? kQBox : 0)));
          for (int bb = 0; bb < nb; ++bb) {
            const int col = (b0 + bb) * g.box_cols;
            if (g.cluster > 1)  // this block's half of the rows, to both
              tma_load_multicast(dst + bb * kDBox + rank * (kDBox / 2), tc,
                                 &r.full[stage], col, row0 + rank * (kDocRows / 2),
                                 0x3);
            else
              tma_load(dst + bb * kDBox, tc, &r.full[stage], col, row0);
          }
          if (g.qstream)  // kb is 1
            tma_load(dst + kDBox, tq, &r.full[stage], b0 * g.box_cols, q_row);
        }
        next_stage(stage, phase, r.stages);
      }
    }
  }
  for (int i = 0; i < r.stages; ++i) {
    mbar_wait(&r.empty[stage], phase ^ 1);
    next_stage(stage, phase, r.stages);
  }
}

// The consumers (warps 0-7). Per unit: begin(); per sub-block pos
// (ascending) the dots into an accumulator, then fold(acc, cell, s, half,
// pos); at the unit's end finish(cell, s, half, part). The callbacks run
// only in warpgroups that hold real query rows. Each stage of `r` holds
// one sub-block's doc tile, or part of it; a warp releases a stage by one
// arrival on its `empty` barrier in each of `release_blocks` blocks of the
// cluster. Two accumulator sets take alternate sub-blocks, and each
// stage's wgmma group is left running while the next is issued (wait_group
// 1): the fold of sub-block p - 1 runs while sub-block p's first stage is
// on the tensor cores, and a stage is released once its group is done.
// QREGS > 0: the queries' A fragments of all QREGS (= n_box) boxes sit in
// registers (loaded once from the resident tiles), so the tensor cores
// read only the doc tile from shared memory; 0: both operands from shared
// memory.
// Measurement variants (kernel C's -DOI_C_FOLD, tools/stream_ablation.py)
// take three accumulator sets: FLIGHT = 2 leaves two groups running at
// each wait (wait_group 2), so the fold of sub-block p - 2 runs under the
// products of p - 1 and p; PAIRS (FLIGHT 1) folds sub-blocks two at a
// time, fold(acc_p, acc_p+1, cell, s, half, p), under the next products.
// The defaults (two sets, FLIGHT 1, single folds) are the shipped loop.
// ACCUM (kernel S, FLIGHT 1): a set is not cleared at each sub-block but
// accumulates in place over runs of acc_run sub-blocks of a part (acc_run
// a power of two >= 2, dividing the part): sub-block pos is issued with
// scale_d = 1 unless pos starts its set's run (pos % acc_run < 2), and
// fold sees the sums so far, whole at the run's last two sub-blocks. With
// acc_cross (acc_run the whole part) the runs go on across the block's
// units: only its first unit starts them.
template <int QREGS, typename Mma, int FLIGHT = 1, bool PAIRS = false,
          bool ACCUM = false, typename Begin, typename Fold, typename Finish>
__device__ __forceinline__ void consume(const Geometry& g, const uint8_t* q_s,
                                        uint64_t* qbar, const Ring& r,
                                        int release_blocks, int qt, int cta,
                                        Begin begin, Fold fold, Finish finish,
                                        int acc_run = 0, bool acc_cross = false) {
  using Acc = typename Mma::Acc;
  constexpr int KB = boxes_per_stage(QREGS);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int wg = warp >> 2;
  const bool live = qt * kQueryRows + wg * 64 < g.b_pad;
  const int units = g.n_super * 2 * g.parts;
  const int per_part = kSuper / g.parts;
  const Cell cell = consumer_cell(qt, warp, lane);
  Acc acc0, acc1;
  uint32_t qa[QREGS > 0 ? 4 * QREGS : 1][4];  // [box * 4 + k step][a0..a3]
  if (!g.qstream) mbar_wait(qbar, 0);
  if constexpr (QREGS > 0) {
    const int r0 = wg * 64 + 16 * (warp & 3) + (lane >> 2);
#pragma unroll
    for (int i = 0; i < 4 * QREGS; ++i) {
      const uint8_t* box = q_s + (i >> 2) * kQBox;
#pragma unroll
      for (int j = 0; j < 4; ++j) {  // a0..a3: rows r0, r0 + 8; bytes +0, +16
        const int row = r0 + 8 * (j & 1);
        const int byte = 32 * (i & 3) + 4 * (lane & 3) + 16 * (j >> 1);
        qa[i][j] = *reinterpret_cast<const uint32_t*>(
            box + row * kBoxBytes + ((((byte >> 4) ^ (row & 7)) << 4) | (byte & 15)));
      }
    }
  }
  uint32_t stage = 0, phase = 0;
  int held = -1;  // the stage whose wgmma group may still be running
  bool fresh = true;  // ACCUM: this unit starts its sets' runs
  auto release = [&](int st) {
    __syncwarp();
    if (lane == 0) {
      if (release_blocks > 1) {
        for (int b = 0; b < release_blocks; ++b) mbar_arrive_cluster(&r.empty[st], b);
      } else {
        mbar_arrive(&r.empty[st]);
      }
    }
  };
  // sub-block pos into cur; after its first stage is issued, fold prev
  // (sub-block pos - 1) when fold_prev
  auto run = [&](Acc& cur, Acc& prev, int pos, bool fold_prev, int s,
                 int half) {
    bool keep = false;  // ACCUM: add to the set's sums instead of clearing
    if constexpr (ACCUM) keep = (pos & (acc_run - 1)) >= 2 || !fresh;
#pragma unroll
    for (int b0 = 0; b0 < (QREGS > 0 ? QREGS : g.n_box); b0 += KB) {
      mbar_wait(&r.full[stage], phase);
      // every k step, also in a warpgroup of padding rows and past the
      // row's end (zero-filled): the compiler serialises a wgmma under a
      // branch
      const uint8_t* dtile = r.base + stage * r.stage_bytes;
      fence_regs(cur);
      wgmma_fence();
      if constexpr (!kProductsOn) {
      } else if constexpr (QREGS > 0) {
#pragma unroll
        for (int bb = 0; bb < KB; ++bb) {
          if (b0 + bb >= QREGS) break;  // compile-time
#pragma unroll
          for (int kk = 0; kk < kBoxBytes / 32; ++kk)
            Mma::rs(cur, qa[4 * (b0 + bb) + kk],
                    sw128_desc(dtile + bb * kDBox + kk * 32),
                    b0 + bb > 0 || kk > 0 || keep);
        }
      } else {  // one box per stage
        const uint8_t* qtile =
            (g.qstream ? dtile + kDBox : q_s + b0 * kQBox) + wg * (kQBox / 2);
#pragma unroll
        for (int kk = 0; kk < kBoxBytes / 32; ++kk)
          Mma::ss(cur, sw128_desc(qtile + kk * 32),
                  sw128_desc(dtile + kk * 32), b0 > 0 || kk > 0 || keep);
      }
      wgmma_commit();
      wgmma_wait<1>();  // every group but this stage's is done
      if (held >= 0) release(held);
      held = static_cast<int>(stage);
      next_stage(stage, phase, r.stages);
      if constexpr (!PAIRS) {  // (pair folds take the loop below)
        if (b0 == 0 && fold_prev) {
          fence_regs(prev);
          if (live && kFoldOn) fold(prev, cell, s, half, pos - 1);
        }
      }
    }
  };
  if constexpr (FLIGHT == 1 && !PAIRS) {
    for (int u = cta; u < units; u += g.ctas_per_qt) {
      const int part = u % g.parts;
      const int half = (u / g.parts) & 1;
      const int s = u / (2 * g.parts);
      const int first = part * per_part;  // per_part is even
      if (live) begin();
      if constexpr (ACCUM) fresh = !acc_cross || u == cta;
      for (int pos = first; pos < first + per_part; pos += 2) {
        run(acc0, acc1, pos, pos > first, s, half);
        run(acc1, acc0, pos + 1, true, s, half);
      }
      wgmma_wait<0>();
      release(held);
      held = -1;
      fence_regs(acc1);
      if (live && kFoldOn) {
        fold(acc1, cell, s, half, first + per_part - 1);
        finish(cell, s, half, part);
      }
    }
  } else {
    static_assert(FLIGHT == 2 || FLIGHT == 1, "one or two groups in flight");
    static_assert(!ACCUM, "sets accumulate in place in the two-set loop only");
    Acc acc2;
    int held_q[FLIGHT];  // stages whose groups may still run, oldest first
#pragma unroll
    for (int i = 0; i < FLIGHT; ++i) held_q[i] = -1;
    // sub-block pos into cur (m1, m2: the sets of pos - 1 and pos - 2);
    // after its first stage is issued, fold what is done
    auto run3 = [&](Acc& cur, Acc& m1, Acc& m2, int pos, int first, int s,
                    int half) {
#pragma unroll
      for (int b0 = 0; b0 < (QREGS > 0 ? QREGS : g.n_box); b0 += KB) {
        mbar_wait(&r.full[stage], phase);
        const uint8_t* dtile = r.base + stage * r.stage_bytes;
        fence_regs(cur);
        wgmma_fence();
        if constexpr (!kProductsOn) {
        } else if constexpr (QREGS > 0) {
#pragma unroll
          for (int bb = 0; bb < KB; ++bb) {
            if (b0 + bb >= QREGS) break;  // compile-time
#pragma unroll
            for (int kk = 0; kk < kBoxBytes / 32; ++kk)
              Mma::rs(cur, qa[4 * (b0 + bb) + kk],
                      sw128_desc(dtile + bb * kDBox + kk * 32), b0 + bb > 0 || kk > 0);
          }
        } else {
          const uint8_t* qtile =
              (g.qstream ? dtile + kDBox : q_s + b0 * kQBox) + wg * (kQBox / 2);
#pragma unroll
          for (int kk = 0; kk < kBoxBytes / 32; ++kk)
            Mma::ss(cur, sw128_desc(qtile + kk * 32),
                    sw128_desc(dtile + kk * 32), b0 > 0 || kk > 0);
        }
        wgmma_commit();
        wgmma_wait<FLIGHT>();  // every group but the last FLIGHT is done
        if (held_q[0] >= 0) release(held_q[0]);
#pragma unroll
        for (int i = 0; i + 1 < FLIGHT; ++i) held_q[i] = held_q[i + 1];
        held_q[FLIGHT - 1] = static_cast<int>(stage);
        next_stage(stage, phase, r.stages);
        if (b0 != 0 || pos - first < 2) continue;
        if constexpr (PAIRS) {  // pos - 2 and pos - 1 are done
          if ((pos - first) & 1) continue;
          fence_regs(m2);
          fence_regs(m1);
          if (live && kFoldOn) fold(m2, m1, cell, s, half, pos - 2);
        } else {  // pos - 2 is done
          fence_regs(m2);
          if (live && kFoldOn) fold(m2, cell, s, half, pos - 2);
        }
      }
    };
    for (int u = cta; u < units; u += g.ctas_per_qt) {
      const int part = u % g.parts;
      const int half = (u / g.parts) & 1;
      const int s = u / (2 * g.parts);
      const int first = part * per_part;  // per_part is even, >= 8
      const int end = first + per_part;
      if (live) begin();
      for (int pos = first; pos < end; pos += 3) {  // sets 0, 1, 2 in turn
        run3(acc0, acc2, acc1, pos, first, s, half);
        if (pos + 1 < end) run3(acc1, acc0, acc2, pos + 1, first, s, half);
        if (pos + 2 < end) run3(acc2, acc1, acc0, pos + 2, first, s, half);
      }
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < FLIGHT; ++i) {
        if (held_q[i] >= 0) release(held_q[i]);
        held_q[i] = -1;
      }
      // the last two sub-blocks, end - 2 (in m2) and end - 1 (in m1)
      auto tail = [&](Acc& m2, Acc& m1) {
        fence_regs(m2);
        fence_regs(m1);
        if (!(live && kFoldOn)) return;
        if constexpr (PAIRS) {
          fold(m2, m1, cell, s, half, end - 2);
        } else {
          fold(m2, cell, s, half, end - 2);
          fold(m1, cell, s, half, end - 1);
        }
        finish(cell, s, half, part);
      };
      const int last = (per_part - 1) % 3;  // the set of end - 1
      if (last == 0) tail(acc2, acc0);
      else if (last == 1) tail(acc0, acc1);
      else tail(acc1, acc2);
    }
  }
}

// The stream over a row-major corpus (kernels A, C, D and S): the producer
// thread loads doc tiles into one ring, which the consumers read (FLIGHT,
// PAIRS: consume's measurement variants; ACCUM, acc_run, acc_cross: kernel
// S's sums in place).
template <int QREGS, typename Mma, int FLIGHT = 1, bool PAIRS = false,
          bool ACCUM = false, typename Begin, typename Fold, typename Finish>
__device__ __forceinline__ void stream_tiles(const Geometry& g,
                                             const CUtensorMap* tq,
                                             const CUtensorMap* tc,
                                             Begin begin, Fold fold,
                                             Finish finish, int acc_run = 0,
                                             bool acc_cross = false) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int stage_bytes = g.kb * kDBox + (g.qstream ? kQBox : 0);
  uint8_t* q_s = base;  // resident queries: n_box boxes of 128 rows
  uint8_t* ring = base + (g.qstream ? 0 : g.n_box * kQBox);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + g.stages * stage_bytes);
  uint64_t* empty = full + g.stages;
  uint64_t* qbar = empty + g.stages;
  const Ring r{ring, stage_bytes, g.stages, full, empty};

  const int warp = threadIdx.x >> 5;
  const int qt = blockIdx.x % g.n_qt;  // a cluster's blocks: neighbouring qt
  const int cta = blockIdx.x / g.n_qt;
  const uint32_t rank = g.cluster > 1 ? cluster_rank() : 0;

  if (threadIdx.x == 0) {
    for (int i = 0; i < g.stages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], kConsumerWarps * g.cluster);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_sync();  // the peer's loads and arrivals may reach our barriers

  if (warp >= kConsumerWarps) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (warp == kConsumerWarps && (threadIdx.x & 31) == 0)
      produce(g, tq, tc, q_s, qbar, r, kSuper, qt, cta, rank);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    consume<QREGS, Mma, FLIGHT, PAIRS, ACCUM>(g, q_s, qbar, r, g.cluster, qt,
                                              cta, begin, fold, finish, acc_run,
                                              acc_cross);
  }
}

// ---------------------------------------------------------------------------
// The packed stream (kernels E1/E2): a nibble-packed corpus
// ---------------------------------------------------------------------------
//
// The corpus is (n_super * 8192, row_bytes) bytes: byte row s * 8192 +
// 128 t + l holds lane l of sub-block 2 t in its low nibble and of 2 t + 1
// in its high nibble, each a signed int4. The producer loads packed boxes
// (64 rows of byte sub-tile t, lanes 64 h .. 64 h + 63) into a packed
// ring. wgmma has no s4 input on sm_90, so warps 9-11, idle in the stream
// above, unpack each box once per block into two int8 tiles of an
// unpacked ring: the low nibbles (sub-block 2 t) and the high ones
// (2 t + 1), each nibble n as the int8 16 n. The consumers then run on
// those tiles as on doc tiles. The 128-byte swizzle moves whole 16-byte
// chunks by row, and each unpacked tile has the packed box's (row, byte)
// geometry, so the unpacked byte at any offset of a tile comes from the
// packed byte at the same offset: the unpack is a flat pass with no
// address arithmetic.

constexpr int kUnpackWarps = 3;  // warps 9-11 of the producer warpgroup
constexpr int kUnpackThreads = 32 * kUnpackWarps;
constexpr int kMaxUnpacked = 4;  // unpacked ring stages
constexpr int kPackedBarBytes = 8 * (2 * kMaxStages + 2 * kMaxUnpacked + 1);

// Sixteen times the signed nibbles of four packed bytes, as four int8: the
// low nibbles moved to the top of their bytes (shift 4), or the high ones
// left there (shift 0), the low bits cleared. 16 n lies in [-128, 112]
// for n in [-8, 7], so the products hold 16 x each dot, exactly: the
// kernels fold dot * 128 as acc * 8. Two or one integer ops a word.
__device__ __forceinline__ uint32_t nibbles16(uint32_t w, int shift) {
  return (w << shift) & 0xF0F0F0F0u;
}

__device__ __forceinline__ uint4 lds128(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr));
  return v;
}

__device__ __forceinline__ void sts128(uint32_t addr, uint4 v) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
               "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

// Packed stage: g.kb packed boxes, then the query box when queries stream.
__host__ __device__ inline int packed_stage_bytes(const Geometry& g) {
  return g.kb * kDBox + (g.qstream ? kQBox : 0);
}
// Unpacked stage. With queries in registers (qregs > 0, one packed stage
// per tile): one tile, its low and high halves in consecutive stages.
// Else (g.kb = 1) one box of both tiles, then the query box when queries
// stream.
__host__ __device__ inline int unpacked_stage_bytes(const Geometry& g) {
  return g.qregs > 0 ? g.kb * kDBox : 2 * kDBox + (g.qstream ? kQBox : 0);
}

// The unpacking warps. Per packed stage: wait until its boxes have landed
// and the unpacked stage(s) are free; turn each 16 bytes of packed rows
// into 16 bytes of low nibbles and 16 of high ones (nibbles16), four
// chunks in flight a thread; make each thread's stores visible to wgmma's
// async proxy and hand the tiles over (one arrival per warp, after
// __syncwarp); then release the packed stage in every block of the
// cluster (the multicast landed in both). SPLIT (qregs > 0): the low and
// the high tile go to two consecutive stages, which the consumers read in
// turn; else one stage holds one box of both, and the query box when
// queries stream.
template <bool SPLIT>
__device__ __forceinline__ void unpack(const Geometry& g, const Ring& p,
                                       const Ring& u, int cta) {
  constexpr int kStep = 16 * kUnpackThreads;  // bytes a pass of the warps
  const int tid = threadIdx.x - 32 * (kConsumerWarps + 1);
  const int units = g.n_super * 2 * g.parts;
  const int groups = (g.n_box + g.kb - 1) / g.kb;  // packed stages per tile
  const int per_unit = kSuper / 2 / g.parts * groups;
  const uint32_t p0 = smem_u32(p.base), u0 = smem_u32(u.base);
  uint32_t ps = 0, pph = 0, us = 0, uph = 0;
  for (int unit = cta; unit < units; unit += g.ctas_per_qt) {
    for (int i = 0; i < per_unit; ++i) {
      const int b0 = i % groups * g.kb;
      const int nb = g.n_box - b0 < g.kb ? g.n_box - b0 : g.kb;
      mbar_wait(&p.full[ps], pph);
      mbar_wait(&u.empty[us], uph ^ 1);
      if (SPLIT) mbar_wait(&u.empty[us + 1], uph ^ 1);
      const uint32_t src = p0 + ps * p.stage_bytes;
      const uint32_t lo = u0 + us * u.stage_bytes;
      const uint32_t hi = lo + (SPLIT ? u.stage_bytes : kDBox);
      if constexpr (kUnpackOn) {
        const int n = nb * kDBox;
        for (int c0 = 16 * tid; c0 < n; c0 += 4 * kStep) {
          uint4 w[4];
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (c0 + j * kStep < n) w[j] = lds128(src + c0 + j * kStep);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int c = c0 + j * kStep;
            if (c >= n) break;
            sts128(lo + c, make_uint4(nibbles16(w[j].x, 4), nibbles16(w[j].y, 4),
                                      nibbles16(w[j].z, 4), nibbles16(w[j].w, 4)));
            sts128(hi + c, make_uint4(nibbles16(w[j].x, 0), nibbles16(w[j].y, 0),
                                      nibbles16(w[j].z, 0), nibbles16(w[j].w, 0)));
          }
        }
        if (!SPLIT && g.qstream)  // the query box, after the two tiles
          for (int c = 16 * tid; c < kQBox; c += kStep)
            sts128(lo + 2 * kDBox + c, lds128(src + kDBox + c));
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncwarp();
      if ((threadIdx.x & 31) == 0) {
        mbar_arrive(&u.full[us]);
        if (SPLIT) mbar_arrive(&u.full[us + 1]);
        if (g.cluster > 1) {
          for (int b = 0; b < g.cluster; ++b) mbar_arrive_cluster(&p.empty[ps], b);
        } else {
          mbar_arrive(&p.empty[ps]);
        }
      }
      next_stage(ps, pph, p.stages);
      if (SPLIT) next_stage(us, uph, u.stages);  // u.stages is even
      next_stage(us, uph, u.stages);
    }
  }
}

// The consumers when the queries are read from shared memory (QREGS = 0):
// each unpacked stage holds one box of byte sub-tile t's two tiles (and
// the query box when queries stream). Both accumulators take the box's
// products, and sub-blocks 2 t and 2 t + 1 fold after the tile's last
// box, with no fold under the products: the path of rows too wide for
// query registers.
template <typename Mma, typename Begin, typename Fold, typename Finish>
__device__ __forceinline__ void consume_pairs(const Geometry& g,
                                              const uint8_t* q_s,
                                              uint64_t* qbar, const Ring& r,
                                              int qt, int cta, Begin begin,
                                              Fold fold, Finish finish) {
  using Acc = typename Mma::Acc;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int wg = warp >> 2;
  const bool live = qt * kQueryRows + wg * 64 < g.b_pad;
  const int units = g.n_super * 2 * g.parts;
  const int per_part = kSuper / 2 / g.parts;  // byte sub-tiles per unit
  const Cell cell = consumer_cell(qt, warp, lane);
  Acc acc0, acc1;
  if (!g.qstream) mbar_wait(qbar, 0);
  uint32_t stage = 0, phase = 0;
  int held = -1;  // the stage whose wgmma group may still be running
  auto release = [&](int st) {
    __syncwarp();
    if (lane == 0) mbar_arrive(&r.empty[st]);
  };
  for (int u = cta; u < units; u += g.ctas_per_qt) {
    const int part = u % g.parts;
    const int half = (u / g.parts) & 1;
    const int s = u / (2 * g.parts);
    if (live) begin();
    for (int t = part * per_part; t < (part + 1) * per_part; ++t) {
      for (int b = 0; b < g.n_box; ++b) {
        mbar_wait(&r.full[stage], phase);
        const uint8_t* tiles = r.base + stage * r.stage_bytes;
        const uint8_t* qtile =
            (g.qstream ? tiles + 2 * kDBox : q_s + b * kQBox) + wg * (kQBox / 2);
        fence_regs(acc0);
        fence_regs(acc1);
        wgmma_fence();
        if constexpr (kProductsOn) {
#pragma unroll
          for (int kk = 0; kk < kBoxBytes / 32; ++kk)
            Mma::ss(acc0, sw128_desc(qtile + kk * 32), sw128_desc(tiles + kk * 32),
                    b > 0 || kk > 0);
#pragma unroll
          for (int kk = 0; kk < kBoxBytes / 32; ++kk)
            Mma::ss(acc1, sw128_desc(qtile + kk * 32),
                    sw128_desc(tiles + kDBox + kk * 32), b > 0 || kk > 0);
        }
        wgmma_commit();
        wgmma_wait<1>();
        if (held >= 0) release(held);
        held = static_cast<int>(stage);
        next_stage(stage, phase, r.stages);
      }
      wgmma_wait<0>();
      release(held);
      held = -1;
      fence_regs(acc0);
      fence_regs(acc1);
      if (live && kFoldOn) {
        fold(acc0, cell, s, half, 2 * t);
        fold(acc1, cell, s, half, 2 * t + 1);
      }
    }
    if (live && kFoldOn) finish(cell, s, half, part);
  }
}

// The packed stream: the producer thread fills the packed ring (p_stages
// stages), warps 9-11 unpack it into the unpacked ring (g.stages stages),
// and the consumers read that, with QREGS > 0 (at most 3, so a tile is one
// stage) by `consume`, else by `consume_pairs`. Same callbacks and units as
// stream_tiles; pos = 2 t + parity.
template <int QREGS, typename Mma, typename Begin, typename Fold,
          typename Finish>
__device__ __forceinline__ void stream_packed_tiles(const Geometry& g,
                                                    int p_stages,
                                                    const CUtensorMap* tq,
                                                    const CUtensorMap* tc,
                                                    Begin begin, Fold fold,
                                                    Finish finish) {
  static_assert(boxes_per_stage(QREGS) == (QREGS > 0 ? QREGS : 1),
                "a tile of the packed stream is one unpacked stage");
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* q_s = base;  // resident queries: n_box boxes of 128 rows
  uint8_t* packed = base + (g.qstream ? 0 : g.n_box * kQBox);
  uint8_t* unpacked = packed + p_stages * packed_stage_bytes(g);
  uint64_t* bars =
      reinterpret_cast<uint64_t*>(unpacked + g.stages * unpacked_stage_bytes(g));
  const Ring p{packed, packed_stage_bytes(g), p_stages, bars, bars + p_stages};
  const Ring u{unpacked, unpacked_stage_bytes(g), g.stages, bars + 2 * p_stages,
               bars + 2 * p_stages + g.stages};
  uint64_t* qbar = bars + 2 * (p_stages + g.stages);

  const int warp = threadIdx.x >> 5;
  const int qt = blockIdx.x % g.n_qt;
  const int cta = blockIdx.x / g.n_qt;
  const uint32_t rank = g.cluster > 1 ? cluster_rank() : 0;

  if (threadIdx.x == 0) {
    for (int i = 0; i < p_stages; ++i) {
      mbar_init(&p.full[i], 1);
      mbar_init(&p.empty[i], kUnpackWarps * g.cluster);
    }
    for (int i = 0; i < g.stages; ++i) {
      mbar_init(&u.full[i], kUnpackWarps);
      mbar_init(&u.empty[i], kConsumerWarps);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_sync();

  // 56 registers for the unpacking loop (40 spilled it), 224 for the
  // consumers: the 168 a thread of the launch, moved between warpgroups
  if (warp >= kConsumerWarps) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n" ::: "memory");
    if (warp == kConsumerWarps) {
      if ((threadIdx.x & 31) == 0)
        produce(g, tq, tc, q_s, qbar, p, kSuper / 2, qt, cta, rank);
    } else {
      unpack<(QREGS > 0)>(g, p, u, cta);
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n" ::: "memory");
    if constexpr (QREGS > 0)
      consume<QREGS, Mma>(g, q_s, qbar, u, 1, qt, cta, begin, fold, finish);
    else
      consume_pairs<Mma>(g, q_s, qbar, u, qt, cta, begin, fold, finish);
  }
}

// The largest QREGS a kernel is built for: queries of up to 6 boxes (768
// bytes a row) ride in registers, 96 of them a thread. A kernel with more
// state per cell than kernel D's passes a smaller limit to plan().
constexpr int kMaxQRegBoxes = 6;

// Call f(integral_constant<int, QREGS>) with the geometry's qregs, built
// for 0 .. MaxQ only (plan() never picks more than the kernel's limit).
template <int MaxQ, typename F>
int with_qregs(const Geometry& g, F&& f) {
  using std::integral_constant;
#define OI_QREGS(N)                                          \
  case N:                                                     \
    if constexpr (MaxQ >= N) return f(integral_constant<int, N>{}); \
    break
  switch (g.qregs) {
    OI_QREGS(1);
    OI_QREGS(2);
    OI_QREGS(3);
    OI_QREGS(4);
    OI_QREGS(5);
    OI_QREGS(6);
  }
#undef OI_QREGS
  return f(integral_constant<int, 0>{});
}

// ---------------------------------------------------------------------------
// Host: tensor maps and the launch geometry
// ---------------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from libcuda, looked up through the runtime (the
// library is not linked against libcuda); null where it is missing.
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      return static_cast<EncodeTiled>(nullptr);
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// A row-major (rows, row_bytes) tensor in boxes of (box_rows x 128 bytes),
// 128-byte swizzle, zero fill past the row and past the last row.
inline bool encode_rows(CUtensorMap* map, const void* ptr,
                        CUtensorMapDataType type, int elem_bytes,
                        uint64_t rows, int row_bytes, int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (!fn) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(row_bytes / elem_bytes),
                              rows};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(row_bytes)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(kBoxBytes / elem_bytes),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem_strides[2] = {1, 1};
  return fn(map, type, 2, const_cast<void*>(ptr), dims, strides, box,
            elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

inline int smem_bytes(const Geometry& g) {
  const int stage = g.kb * kDBox + (g.qstream ? kQBox : 0);
  return 1024 + (g.qstream ? 0 : g.n_box * kQBox) + g.stages * stage + kBarBytes;
}

// The shared fields of both plans, and the split of supers into parts: the
// fewest (dividing max_parts, a power of two) that spread the units over
// the blocks at >= 90 % (else the most even split found). pair = false: no
// clusters, each block loads whole doc tiles itself (kernel C2, whose
// consumers, not the stream, set its pace).
inline Geometry plan_grid(int row_bytes, int elem_bytes, int b_pad,
                          int n_super, int max_parts, bool pair = true) {
  Geometry g{};
  g.row_bytes = row_bytes;
  g.box_cols = kBoxBytes / elem_bytes;
  g.n_box = (row_bytes + kBoxBytes - 1) / kBoxBytes;
  g.b_pad = b_pad;
  g.n_super = n_super;
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int n_qt = (b_pad + kQueryRows - 1) / kQueryRows;
  g.n_qt = n_qt;
  // a doc tile loaded once per 256 queries
  g.cluster = pair && n_qt % 2 == 0 && !OI_STREAM_NO_CLUSTER ? 2 : 1;
  const int per_qt = sms / n_qt > 1 ? sms / n_qt : 1;
  double best = -1.0;
  for (int parts = 1; parts <= max_parts && parts <= kMaxParts; parts *= 2) {
    const int units = n_super * 2 * parts;
    const int ctas = units < per_qt ? units : per_qt;
    const int rounds = (units + ctas - 1) / ctas;
    const double eff = static_cast<double>(units) / (rounds * per_qt);
    if (eff > best + 1e-9) {
      best = eff;
      g.parts = parts;
      g.ctas_per_qt = ctas;
    }
    if (eff >= 0.9) break;
  }
  return g;
}

// The geometry for b_pad queries of row_bytes over n_super supers; a kernel
// that keeps `reserve` bytes of its own after the stream's (smem_bytes(g)
// - 1024 past the aligned base) leaves them out of the ring (pair: as
// plan_grid's).
inline Geometry plan(int row_bytes, int elem_bytes, int b_pad, int n_super,
                     int max_parts, int max_qreg_boxes, int reserve = 0,
                     bool pair = true) {
  Geometry g = plan_grid(row_bytes, elem_bytes, b_pad, n_super, max_parts, pair);
  g.qstream = 1024 + g.n_box * kQBox + kMinResidentStages * kDBox + kBarBytes +
                  reserve > kSmemMax;
  g.qregs = g.qstream || g.n_box > max_qreg_boxes ? 0 : g.n_box;
  g.kb = boxes_per_stage(g.qregs);
  const int stage = g.kb * kDBox + (g.qstream ? kQBox : 0);
  const int room = kSmemMax - 1024 - kBarBytes - reserve -
                   (g.qstream ? 0 : g.n_box * kQBox);
  g.stages = room / stage < kMaxStages ? room / stage : kMaxStages;
  return g;
}

// The packed stream's geometry (int8 queries, a packed corpus of row_bytes
// per byte row): queries resident unless they leave no room for two stages
// of each ring, in registers up to max_qreg_boxes (at most 3) boxes;
// g.stages unpacked stages (4 split ones, else 2) and the rest of the
// budget for the packed ring, returned in *p_stages.
inline Geometry plan_packed(int row_bytes, int b_pad, int n_super,
                            int max_parts, int max_qreg_boxes, int* p_stages) {
  Geometry g = plan_grid(row_bytes, 1, b_pad, n_super, max_parts);
  g.qstream = 1024 + kPackedBarBytes + g.n_box * kQBox + 2 * kDBox +
                  2 * (2 * kDBox) > kSmemMax;
  g.qregs = g.qstream || g.n_box > max_qreg_boxes ? 0 : g.n_box;
  g.kb = boxes_per_stage(g.qregs);
  g.stages = g.qregs > 0 ? kMaxUnpacked : 2;
  const int room = kSmemMax - 1024 - kPackedBarBytes -
                   (g.qstream ? 0 : g.n_box * kQBox) -
                   g.stages * unpacked_stage_bytes(g);
  const int fit = room / packed_stage_bytes(g);
  *p_stages = fit < kMaxStages ? fit : kMaxStages;
  return g;
}

inline int packed_smem_bytes(const Geometry& g, int p_stages) {
  return 1024 + (g.qstream ? 0 : g.n_box * kQBox) +
         p_stages * packed_stage_bytes(g) + g.stages * unpacked_stage_bytes(g) +
         kPackedBarBytes;
}

// Launch a stream kernel with `smem` bytes of dynamic shared memory:
// n_qt * ctas_per_qt blocks, in clusters of g.cluster (neighbouring query
// tiles).
template <typename... Args>
int launch_stream_smem(void (*kernel)(Args...), const Geometry& g, int smem,
                       cudaStream_t stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(g.n_qt * g.ctas_per_qt);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = g.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

template <typename... Args>
int launch_stream(void (*kernel)(Args...), const Geometry& g,
                  cudaStream_t stream, Args... args) {
  return launch_stream_smem(kernel, g, smem_bytes(g), stream, args...);
}

// Where the parts of a super meet for a top-2 kernel (E2, C2): cell (row,
// col) of `out` (b_pad, 2 * half_w) and of each of the parts - 1 buffers
// of `parts_out` (the same layout) hold top-2s of disjoint key sets; out
// gets their top-2 by the reference's combine, a2 = max(min(a1, b1),
// max(a2, b2)), exact for distinct keys and so order-free
// (merge_part_cells_plain is its twin). A template, like fill below.
template <typename T>
__global__ void merge_top2_kernel(T* __restrict__ out,
                                  const T* __restrict__ parts_out, int b_pad,
                                  int half_w, int parts) {
  const size_t idx = blockIdx.x * (size_t)blockDim.x + threadIdx.x;
  if (idx >= (size_t)b_pad * half_w) return;
  const size_t o = idx / half_w * 2 * half_w + idx % half_w;
  const size_t stride = (size_t)b_pad * 2 * half_w;  // per buffer
  T a1 = out[o], a2 = out[o + half_w];
  for (int p = 0; p + 1 < parts; ++p) {
    const T b1 = parts_out[p * stride + o];
    const T b2 = parts_out[p * stride + o + half_w];
    a2 = max(min(a1, b1), max(a2, b2));
    a1 = max(a1, b1);
  }
  out[o] = a1;
  out[o + half_w] = a2;
}

template <typename T>
int merge_top2(T* out, const T* parts_out, int b_pad, int half_w, int parts,
               cudaStream_t stream) {
  const size_t n = (size_t)b_pad * half_w;
  merge_top2_kernel<T><<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
      out, parts_out, b_pad, half_w, parts);
  return (int)cudaGetLastError();
}

template <typename T>
__global__ void fill_kernel(T* __restrict__ out, size_t n, T v) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x)
    out[i] = v;
}

// out[0 .. n) = v on the stream (cells that parts of a super meet in by
// atomicMax start at INT_MIN). A template, so that only the sources that
// call it carry the kernel.
template <typename T>
int fill(T* out, size_t n, T v, cudaStream_t stream) {
  const size_t blocks = (n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096;
  fill_kernel<T><<<(unsigned)blocks, 256, 0, stream>>>(out, n, v);
  return (int)cudaGetLastError();
}

}  // namespace oi_tma

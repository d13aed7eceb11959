// Kernel B, v2: exact fused cosine top-k for Hopper, the score matrix never
// stored in device memory.
//
// Replaces openintel_tpu/ops/pallas/dense_topk.py:_kernel (launched by
// dense_topk_pallas, the dense arm of every corpus under 100k docs): per
// query, the k best docs by (score desc, doc id asc) of float32 sums of
// products. The first version (fused_topk.cu) stays as the A/B control,
// reached only through fused_topk_v1.
//
// Layout: row-major (b, dim) queries and (n_docs, dim) docs, f32 or bf16,
// dim a multiple of 16 (the wrapper zero-pads the feature axis; zero columns
// add exactly 0 to every sum). Slots never filled come out as (0.0, -1),
// the padding contract.
//
// One call launches a memset, a partial kernel and one or more merges. The
// partial kernel is one of two:
// - the ring kernel, which the port serves (below): one block per (query
//   tile, corpus split). A query
//   tile is 64 rows (16 warps, one block a SM), or 16 rows (8 warps, two a
//   SM) at a batch of 16 or fewer, so the text path's 15 queries do not pay
//   for 64 rows, and at k > 32, whose lists do not fit 64 rows' shared
//   memory. The block walks its split in doc tiles of 128; each tile's
//   query and doc rows stream through a 3-stage cp.async ring in 128-byte K
//   slices, so any dim fits: nothing holds a whole row. Products:
//     f32:  register tiles, each thread 4 x 4 (or 2 x 4) cells, one fmaf
//           chain per cell in ascending k (true float32, no TF32); per 4 k
//           a thread makes TM + 4 16-byte shared loads for 16 TM FMAs.
//     bf16: mma.sync m16n8k16 with f32 accumulators.
//   A bf16 x bf16 product is exact in f32 on either kernel; only the
//   summation order differs from the twin's.
//   The tile's scores go to shared memory; then each warp selects for its
//   rows (4 a warp): a candidate must rank before the row's threshold (the
//   k-th (score, id) of the row's list) and score no lower than the best
//   k-th any split of the same query has published (atomicMax on an
//   order-preserving key). Each warp first tests and ballots all its rows'
//   scores (independent loads), then appends the passing ones, as 64-bit
//   (score, id) keys, to the rows' buffers in shared memory by prefix
//   count. When a buffer would overflow, and at the end of the split, the
//   row's list and buffer are sorted (bitonic, in registers through
//   shuffles: one descending sort of the keys is (score desc, id asc)) and
//   the first k kept. At k <= 32 (64 rows) or k <= 224 (16) the list lives
//   beside its buffer in shared memory; beyond, in the split's slot of the
//   output scratch in device memory.
// - the merge kernel, one warp per (group of up to 32 splits, query): lane
//   p holds the head of list p, and the warp emits the best head k times.
//   Over 32 splits it runs in passes (32 lists to one, then the rest), so
//   the split count is not capped: a batch of 15 over 20k docs runs 157
//   splits, more than the 132 SMs. Splits hold disjoint doc ids, so the
//   (score desc, id asc) order of the merged list is exact; the last pass
//   writes empty slots as (0.0, -1).
// - the stream kernel, for bf16 rows at k <= 32 on request (the wrapper's
//   route="stream"; fused_topk_v2_tma, below): the TMA + wgmma stream of
//   tma_stream.cuh, 128 queries a block, a 2-block cluster multicasting
//   each doc tile to two query tiles (read from device memory once per 256
//   queries), the selection in the stream's fold callback on the wgmma
//   accumulators. Its stream and products take a fraction of the ring's
//   staging, but its selection holds the wgmma warps and it measured slower
//   than the ring, so the ring is served (PERF.md).
//
// What bounds it on an H100 (B=256, N=98,304, D=384): the f32 products on
// the FMA pipes (19.3 GFLOP: 0.29 ms at 67 TFLOP/s); bf16 rows by device
// memory (75 MB once: 0.023 ms). Each doc tile is read once per 64-query
// tile (4 times at B=256, the 4 query tiles of a split adjacent in launch
// order, so 3 of them find it in L2), against v1's once per 8 queries.
// Measured (tools/stream_ablation.py, PERF.md): on the ring, the selection
// costs as much as the bf16 staging and products together, because 33
// splits a query start with empty lists at once and each must sort its
// first candidates.

#include <climits>
#include <cmath>
#include <cstdint>
#include <type_traits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

// Measurement builds only (tools/stream_ablation.py): OI_STREAM_ABLATE (see
// tma_stream.cuh) 1 (and 3) drops the selection, 2 (and 4) the products
// too, leaving the staging ring or the stream alone. The library the port
// loads is built without it (0).
#include "tma_stream.cuh"


namespace {

// Threads of a block: 16 warps at 64 query rows (4 rows a warp in the
// selection), 8 at 16.
template <int QT>
__host__ __device__ constexpr int block_threads() {
  return QT == 64 ? 512 : 256;
}
constexpr int kSliceBytes = 128;            // K bytes per staged slice
constexpr int kPitch = kSliceBytes + 16;    // bytes per staged row (conflict-free)
constexpr int kChunks = kSliceBytes / 16;   // 16-byte cp.async chunks per row
constexpr int kStages = 3;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory; src_bytes 0 zero-fills them.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// (v, id) ranks strictly before (ov, oid): a higher score, or an equal
// score and a lower doc id. Empty slots are (-inf, -1) and real scores are
// finite, so every real candidate ranks before an empty slot.
__device__ __forceinline__ bool before(float v, int id, float ov, int oid) {
  return v > ov || (v == ov && id < oid);
}

// The score tile: (QT, NT + 4) floats.
template <int NT>
__host__ __device__ constexpr int score_pitch() {
  return NT + 4;
}

// f32 products: thread (ty, tx) owns query rows ty * TM + i and doc rows
// tx + TX * j (j < 4) of the tile: per 4 k, TM + 4 16-byte shared loads for
// 16 TM FMAs (a warp's lanes share ty, so its query loads are broadcasts,
// and 8 consecutive lanes read 8 consecutive doc rows, conflict-free).
template <int QT, int NT>
struct F32Tile {
  static constexpr int kThreads = block_threads<QT>();
  static constexpr int TN = 4;
  static constexpr int TX = NT / TN;
  static constexpr int TY = kThreads / TX;
  static constexpr int TM = QT / TY;
  static_assert(TX * TY == kThreads && TM * TY == QT && TX == 32, "tile shape");
  float acc[TM][TN];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  }

  __device__ __forceinline__ void run(const uint8_t* qs8, const uint8_t* ds8,
                                      int tid) {
    constexpr int P = kPitch / 4;
    const float* qs = reinterpret_cast<const float*>(qs8);
    const float* ds = reinterpret_cast<const float*>(ds8);
    const int tx = tid % TX, ty = tid / TX;
#pragma unroll
    for (int kk = 0; kk < kSliceBytes / 4; kk += 4) {
      float4 a[TM], d[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i)
        a[i] = *reinterpret_cast<const float4*>(qs + (ty * TM + i) * P + kk);
#pragma unroll
      for (int j = 0; j < TN; ++j)
        d[j] = *reinterpret_cast<const float4*>(ds + (tx + TX * j) * P + kk);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          float s = acc[i][j];
          s = fmaf(a[i].x, d[j].x, s);
          s = fmaf(a[i].y, d[j].y, s);
          s = fmaf(a[i].z, d[j].z, s);
          acc[i][j] = fmaf(a[i].w, d[j].w, s);
        }
    }
  }

  __device__ __forceinline__ void store(float* S, int tid) const {
    constexpr int SP = score_pitch<NT>();
    const int tx = tid % TX, ty = tid / TX;
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) S[(ty * TM + i) * SP + tx + TX * j] = acc[i][j];
  }
};

__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2, uint32_t a3,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// bf16 products: warp (wm, wn) owns query rows 16 wm .. 16 wm + 15 and doc
// rows 8 NI wn .. of the tile, NI n8 tiles; A and B fragments are 32-bit
// shared loads of K-contiguous rows (the mma's row x col layout).
template <int QT, int NT>
struct Bf16Tile {
  static constexpr int kWarps = block_threads<QT>() / 32;
  static constexpr int WM = QT / 16;
  static constexpr int WN = kWarps / WM;
  static constexpr int NI = NT / (8 * WN);
  static_assert(WM * WN == kWarps && NI * 8 * WN == NT, "tile shape");
  float c[NI][4];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int n = 0; n < NI; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) c[n][i] = 0.f;
  }

  __device__ __forceinline__ void run(const uint8_t* qs8, const uint8_t* ds8,
                                      int tid) {
    constexpr int P = kPitch / 4;  // 32-bit words per staged row
    const uint32_t* qw = reinterpret_cast<const uint32_t*>(qs8);
    const uint32_t* dw = reinterpret_cast<const uint32_t*>(ds8);
    const int warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, tq = lane & 3;
    const int r0 = (warp / WN) * 16, c0 = (warp % WN) * 8 * NI;
#pragma unroll
    for (int ks = 0; ks < kSliceBytes / 32; ++ks) {  // k16 steps
      const int w = ks * 8 + tq;
      const uint32_t a0 = qw[(r0 + g) * P + w], a1 = qw[(r0 + g + 8) * P + w];
      const uint32_t a2 = qw[(r0 + g) * P + w + 4],
                     a3 = qw[(r0 + g + 8) * P + w + 4];
#pragma unroll
      for (int n = 0; n < NI; ++n) {
        const int row = c0 + n * 8 + g;
        mma_bf16(c[n], a0, a1, a2, a3, dw[row * P + w], dw[row * P + w + 4]);
      }
    }
  }

  __device__ __forceinline__ void store(float* S, int tid) const {
    constexpr int SP = score_pitch<NT>();
    const int warp = tid >> 5, lane = tid & 31;
    const int row = (warp / WN) * 16 + (lane >> 2);
    const int c0 = (warp % WN) * 8 * NI + 2 * (lane & 3);
#pragma unroll
    for (int n = 0; n < NI; ++n) {
      const int col = c0 + n * 8;
      S[row * SP + col] = c[n][0];
      S[row * SP + col + 1] = c[n][1];
      S[(row + 8) * SP + col] = c[n][2];
      S[(row + 8) * SP + col + 1] = c[n][3];
    }
  }
};

// A score as an unsigned key in the same order (0 is below every score):
// the per-query threshold the splits share through atomicMax.
__device__ __forceinline__ unsigned order_key(float x) {
  const unsigned u = __float_as_uint(x);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}
__device__ __forceinline__ float key_score(unsigned key) {
  return __uint_as_float((key & 0x80000000u) ? (key & 0x7fffffffu) : ~key);
}

// A candidate as one 64-bit key: the larger key ranks first, so (score
// desc, id asc) is a descending sort of the keys; 0 is an empty slot,
// below every candidate.
using Key = unsigned long long;
__device__ __forceinline__ Key pack(float v, int id) {
  return (static_cast<Key>(order_key(v)) << 32) | static_cast<unsigned>(~id);
}
__device__ __forceinline__ void unpack(Key key, float& v, int& id) {
  v = key ? key_score(static_cast<unsigned>(key >> 32)) : -INFINITY;
  id = key ? static_cast<int>(~static_cast<unsigned>(key)) : -1;
}

// A warp's bitonic sort of 32 E keys (shared memory) into descending order,
// through registers: key e in lane e % 32, slot e / 32; strides of 32 and
// more compare slots of one lane, the others a shuffle.
template <int E>
__device__ __forceinline__ void sort_keys_regs(Key* w, int lane) {
  Key x[E];
#pragma unroll
  for (int s = 0; s < E; ++s) x[s] = w[lane + 32 * s];
#pragma unroll
  for (int size = 2; size <= 32 * E; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      if (stride >= 32) {
#pragma unroll
        for (int s = 0; s < E; ++s) {
          const int ps = s ^ (stride >> 5);
          if (ps < s) continue;  // each pair once, from its lower slot
          const bool best_first = ((lane + 32 * s) & size) == 0;
          const Key hi = x[s] > x[ps] ? x[s] : x[ps];
          const Key lo = x[s] > x[ps] ? x[ps] : x[s];
          x[s] = best_first ? hi : lo;
          x[ps] = best_first ? lo : hi;
        }
      } else {
        const bool lower = (lane & stride) == 0;
#pragma unroll
        for (int s = 0; s < E; ++s) {
          const Key p = __shfl_xor_sync(kFull, x[s], stride);
          const bool best_first = ((lane + 32 * s) & size) == 0;
          const bool keep_max = lower == best_first;
          x[s] = keep_max ? (p > x[s] ? p : x[s]) : (p < x[s] ? p : x[s]);
        }
      }
    }
  }
#pragma unroll
  for (int s = 0; s < E; ++s) w[lane + 32 * s] = x[s];
}

// The same in shared memory, for n > 256 keys.
__device__ void sort_keys_smem(Key* w, int n, int lane) {
  for (int size = 2; size <= n; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = lane; i < n / 2; i += 32) {
        const int lo = 2 * i - (i & (stride - 1));
        const Key a = w[lo], b = w[lo + stride];
        if (((lo & size) == 0) == (b > a)) {
          w[lo] = b;
          w[lo + stride] = a;
        }
      }
      __syncwarp();
    }
  }
}

// One row's compaction, by its warp: the row's list and its c buffered
// candidates sorted, the first k kept. Lists in shared memory: `slots` is
// the row's sort_len keys, the list in [0, k), the buffer from k. Else
// `slots` is the buffer, the list (f entries) is in device memory at
// (lv, li), and `ws` the warp's workspace. Returns the k-th key, or 0 while
// the list holds fewer than k. One copy per kernel, not inlined: it runs a
// few times per row and split.
__device__ __noinline__ Key compact_row(Key* slots, Key* ws, float* lv,
                                        int32_t* li, int k, int c, int f,
                                        int sort_len, int list_in_smem,
                                        int lane) {
  __syncwarp();
  Key* w = slots;
  if (list_in_smem) {  // empty the buffer's unused tail
    for (int i = k + c + lane; i < sort_len; i += 32) slots[i] = 0;
  } else {
    w = ws;
    for (int i = lane; i < sort_len; i += 32)
      w[i] = i < f ? pack(lv[i], li[i]) : i < f + c ? slots[i - f] : 0;
  }
  __syncwarp();
  if (sort_len == 64)
    sort_keys_regs<2>(w, lane);
  else if (sort_len == 128)
    sort_keys_regs<4>(w, lane);
  else if (sort_len == 256)
    sort_keys_regs<8>(w, lane);
  else
    sort_keys_smem(w, sort_len, lane);
  __syncwarp();
  const int nf = min(k, f + c);
  if (!list_in_smem)
    for (int i = lane; i < nf; i += 32) unpack(w[i], lv[i], li[i]);
  const Key kth = nf == k ? w[k - 1] : 0;
  __syncwarp();
  return kth;
}

// Shared-memory bytes of the partial kernel for one configuration: the
// ring, the score tile, per row `row_len` keys, and with lists in device
// memory a sort workspace per warp.
__host__ __device__ constexpr int partial_smem(int qt, int nt, int row_len,
                                               int sort_len, int list_in_smem) {
  return kStages * (qt + nt) * kPitch + qt * (nt + 4) * 4 + 8 * qt * row_len +
         (list_in_smem ? 0 : 8 * (qt == 64 ? 512 : 256) / 32 * sort_len) +
         4 * qt * 4;
}

template <typename T, int QT, int NT>
__global__ void __launch_bounds__(block_threads<QT>(), QT == 64 ? 1 : 2)
fused_topk_v2_partial(const T* __restrict__ q,     // (b, dim)
                      const T* __restrict__ docs,  // (n_docs, dim)
                      float* __restrict__ part_vals,  // (n_split, b, k)
                      int32_t* __restrict__ part_ids,
                      unsigned* __restrict__ shared_thr,  // (b,) order keys, 0 first
                      int b, int n_docs, int dim, int k, int split_len,
                      int cap, int sort_len, int list_in_smem) {
  using Tile = std::conditional_t<std::is_same<T, float>::value,
                                  F32Tile<QT, NT>, Bf16Tile<QT, NT>>;
  constexpr int SP = score_pitch<NT>();
  constexpr int kStageBytes = (QT + NT) * kPitch;
  constexpr int kThreads = block_threads<QT>();
  constexpr int kWarps = kThreads / 32;
  extern __shared__ __align__(16) uint8_t smem[];
  // Per row, `row_len` keys: with lists in shared memory (small k) the
  // row's list in [0, k) and its buffer in [k, sort_len); else the buffer
  // alone (cap keys), the list in the split's slot of part_*.
  const int row_len = list_in_smem ? sort_len : cap;
  const int boff = list_in_smem ? k : 0;  // the buffer's first slot
  Key* row_k = reinterpret_cast<Key*>(smem + kStages * kStageBytes);
  Key* ws = row_k + QT * row_len;  // (4, sort_len), lists in device memory
  float* S = reinterpret_cast<float*>(ws + (list_in_smem ? 0 : kWarps * sort_len));
  float* thr_v = S + QT * SP;
  int* thr_i = reinterpret_cast<int*>(thr_v + QT);
  int* cnt = thr_i + QT;     // candidates buffered
  int* filled = cnt + QT;    // entries of the row's list

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q0 = blockIdx.x * QT;
  const int split = blockIdx.y;
  const int d_begin = split * split_len;
  const int d_end = min(d_begin + split_len, n_docs);
  const int row_bytes = dim * static_cast<int>(sizeof(T));
  const int n_slices = (row_bytes + kSliceBytes - 1) / kSliceBytes;
  const int steps = (d_end - d_begin + NT - 1) / NT * n_slices;
  const char* qb = reinterpret_cast<const char*>(q);
  const char* db = reinterpret_cast<const char*>(docs);

  for (int r = tid; r < QT; r += kThreads) {
    thr_v[r] = -INFINITY;
    thr_i[r] = -1;
    cnt[r] = 0;
    filled[r] = 0;
  }
  for (int i = tid; i < QT * row_len; i += kThreads) row_k[i] = 0;  // empty lists

  // Stage step `step` (doc tile step / n_slices, K slice step % n_slices):
  // the tile's query and doc rows, rows and bytes past the ends zero-filled.
  // Every thread commits a group per call, empty or not.
  auto issue = [&](int step) {
    if (step < steps) {
      const int tile = step / n_slices, col = (step % n_slices) * kSliceBytes;
      uint8_t* dst = smem + (step % kStages) * kStageBytes;
      for (int c = tid; c < (QT + NT) * kChunks; c += kThreads) {
        const int r = c / kChunks, cb = col + (c % kChunks) * 16;
        const bool is_q = r < QT;
        const int row = is_q ? q0 + r : d_begin + tile * NT + (r - QT);
        const bool ok = (is_q ? row < b : row < d_end) && cb < row_bytes;
        const char* src = ok ? (is_q ? qb : db) + (size_t)row * row_bytes + cb : db;
        cp_async16(dst + r * kPitch + (c % kChunks) * 16, src, ok ? 16 : 0);
      }
    }
    cp_async_commit();
  };

  // Compact row r (c buffered); set its threshold once the list is full and
  // publish the k-th score to the query's other splits.
  auto compact = [&](int r, int c, float& tv, int& ti) {
    const size_t lrow = ((size_t)split * b + q0 + r) * k;
    const int f = filled[r];
    const Key kth = compact_row(row_k + r * row_len, ws + warp * sort_len,
                                part_vals + lrow, part_ids + lrow, k, c, f,
                                sort_len, list_in_smem, lane);
    if (kth) unpack(kth, tv, ti);
    if (lane == 0) {
      filled[r] = min(k, f + c);
      thr_v[r] = tv;
      thr_i[r] = ti;
      if (kth) atomicMax(shared_thr + q0 + r, static_cast<unsigned>(kth >> 32));
    }
  };

  // The selection over a stored score tile: warp w takes rows w + 8 i. A
  // candidate must rank before the row's own k-th and score no lower than
  // the best k-th any split of the query has published. First every row's
  // chunks of 32 scores are tested and balloted, all loads independent;
  // then the rows with candidates append them (and compact on overflow).
  auto select_tile = [&](int tile) {
    constexpr int RPW = QT / kWarps;  // rows per warp
    constexpr int CH = NT / 32;       // chunks per row
    const int base = d_begin + tile * NT;
    const int my_row = warp + kWarps * lane;  // lane i < RPW: row warp + kWarps i
    const bool my_live = lane < RPW && q0 + my_row < b;
    const unsigned my_key = my_live ? shared_thr[q0 + my_row] : 0u;
    const float my_tv = my_live ? thr_v[my_row] : INFINITY;
    const int my_ti = my_live ? thr_i[my_row] : -1;
    unsigned masks[RPW][CH];
    bool any = false;
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const int r = warp + kWarps * i;
      const unsigned key = __shfl_sync(kFull, my_key, i);
      const float g = key ? key_score(key) : -INFINITY;
      const float tv = __shfl_sync(kFull, my_tv, i);
      const int ti = __shfl_sync(kFull, my_ti, i);
#pragma unroll
      for (int j = 0; j < CH; ++j) {
        const int id = base + 32 * j + lane;
        const float v = S[r * SP + 32 * j + lane];
        masks[i][j] = __ballot_sync(kFull, id < d_end && v >= g && before(v, id, tv, ti));
        any |= masks[i][j] != 0;
      }
    }
    if (!any) return;  // warp-uniform: ballots are
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      unsigned row_any = 0;
#pragma unroll
      for (int j = 0; j < CH; ++j) row_any |= masks[i][j];
      if (!row_any) continue;
      const int r = warp + kWarps * i;
      float tv = thr_v[r];
      int ti = thr_i[r];
      int c = cnt[r];
#pragma unroll
      for (int j = 0; j < CH; ++j) {
        unsigned m = masks[i][j];
        if (!m) continue;
        const int id = base + 32 * j + lane;
        const float v = S[r * SP + 32 * j + lane];
        // the threshold may have risen since the ballot (a compaction)
        bool pass = ((m >> lane) & 1u) && before(v, id, tv, ti);
        m = __ballot_sync(kFull, pass);
        if (c + __popc(m) > cap) {
          compact(r, c, tv, ti);
          c = 0;
          pass = pass && before(v, id, tv, ti);
          m = __ballot_sync(kFull, pass);
        }
        if (pass)
          row_k[r * row_len + boff + c + __popc(m & ((1u << lane) - 1u))] = pack(v, id);
        c += __popc(m);
      }
      __syncwarp();
      if (lane == 0) cnt[r] = c;
      __syncwarp();
    }
  };

  Tile tile_acc;
  for (int s = 0; s < kStages - 1; ++s) issue(s);
  for (int step = 0; step < steps; ++step) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage `step` landed; stage step - 1 is consumed
    issue(step + kStages - 1);
    const int slice = step % n_slices;
    if (slice == 0) tile_acc.zero();
    const uint8_t* st = smem + (step % kStages) * kStageBytes;
    if (OI_STREAM_ABLATE != 2 && OI_STREAM_ABLATE != 4)
      tile_acc.run(st, st + QT * kPitch, tid);
    if (slice == n_slices - 1) {
      tile_acc.store(S, tid);
      __syncthreads();
      if (OI_STREAM_ABLATE == 0) select_tile(step / n_slices);
      // the next tile's store comes after at least one more block barrier
    }
  }
  cp_async_wait<0>();
  for (int r = warp; r < QT; r += kWarps) {
    if (q0 + r >= b) break;
    const int c = cnt[r];
    float tv = thr_v[r];
    int ti = thr_i[r];
    if (c > 0) compact(r, c, tv, ti);
    const size_t lrow = ((size_t)split * b + q0 + r) * k;
    if (list_in_smem) {  // the list with its empty slots
      for (int i = lane; i < k; i += 32)
        unpack(row_k[r * row_len + i], part_vals[lrow + i], part_ids[lrow + i]);
      continue;
    }
    for (int i = filled[r] + lane; i < k; i += 32) {
      part_vals[lrow + i] = -INFINITY;
      part_ids[lrow + i] = -1;
    }
  }
}

// Lists (n_lists, b, k) -> (ceil(n_lists / 32), b, k): one warp per (group
// of 32 lists, query row); lane p holds the head of list 32 g + p and the
// next entry, and the warp emits the best head k times. Empty slots come
// out as (empty_v, -1): -inf between passes, 0.0 (the padding contract) in
// the last.
__global__ void fused_topk_v2_merge(const float* __restrict__ in_v,
                                    const int32_t* __restrict__ in_i,
                                    float* __restrict__ out_v,
                                    int32_t* __restrict__ out_i, int b, int k,
                                    int n_lists, float empty_v) {
  const int w = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  const int n_groups = (n_lists + 31) / 32;
  if (w >= n_groups * b) return;  // whole warps exit together
  const int g = w / b, row = w % b;
  const int list = g * 32 + lane;
  const bool has = list < n_lists;
  const size_t off = ((size_t)(has ? list : 0) * b + row) * k;
  const size_t dst = ((size_t)g * b + row) * k;
  auto at = [&](int h, float& v, int& id) {
    v = -INFINITY;
    id = INT_MAX;  // exhausted
    if (has && h < k) {
      const int x = in_i[off + h];
      if (x >= 0) {
        v = in_v[off + h];
        id = x;
      }
    }
  };
  float cv, nv;
  int ci, ni;
  at(0, cv, ci);
  at(1, nv, ni);
  int head = 0;
  for (int t = 0; t < k; ++t) {
    float bv = cv;
    int bid = ci, bl = lane;
#pragma unroll
    for (int o = 16; o; o >>= 1) {
      const float ov = __shfl_xor_sync(kFull, bv, o);
      const int oid = __shfl_xor_sync(kFull, bid, o);
      const int ol = __shfl_xor_sync(kFull, bl, o);
      if (before(ov, oid, bv, bid)) {
        bv = ov;
        bid = oid;
        bl = ol;
      }
    }
    if (bid == INT_MAX) {  // every list exhausted (warp-uniform)
      for (int j = t + lane; j < k; j += 32) {
        out_v[dst + j] = empty_v;
        out_i[dst + j] = -1;
      }
      return;
    }
    if (lane == 0) {
      out_v[dst + t] = bv;
      out_i[dst + t] = bid;
    }
    if (lane == bl) {
      cv = nv;
      ci = ni;
      ++head;
      at(head + 1, nv, ni);
    }
  }
}

template <typename T, int QT, int NT>
int launch_partial(const void* q, const void* docs, float* part_vals,
                   int32_t* part_ids, unsigned* shared_thr, int b, int n_docs,
                   int dim, int k, int n_split, int split_len, int cap,
                   int sort_len, int list_in_smem, cudaStream_t stream) {
  const int smem = partial_smem(QT, NT, list_in_smem ? sort_len : cap, sort_len,
                                list_in_smem);
  auto kernel = fused_topk_v2_partial<T, QT, NT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaMemsetAsync(shared_thr, 0, sizeof(unsigned) * b, stream);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((b + QT - 1) / QT, n_split);
  kernel<<<grid, block_threads<QT>(), smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(docs), part_vals,
      part_ids, shared_thr, b, n_docs, dim, k, split_len, cap, sort_len,
      list_in_smem);
  return (int)cudaGetLastError();
}

int launch_merge(const float* in_v, const int32_t* in_i, float* out_v,
                 int32_t* out_i, int b, int k, int n_lists, float empty_v,
                 cudaStream_t stream) {
  const long long warps = (long long)((n_lists + 31) / 32) * b;
  const int per_block = 8;
  fused_topk_v2_merge<<<(unsigned)((warps + per_block - 1) / per_block),
                        per_block * 32, 0, stream>>>(in_v, in_i, out_v, out_i,
                                                     b, k, n_lists, empty_v);
  return (int)cudaGetLastError();
}

// The merge passes of n_lists lists (n_lists, b, k) at (pv, pi): 32 lists
// to one a pass, part -> tmp -> part ... -> out; tmp holds
// ceil(n_lists / 32) lists (unused at 32 lists or fewer).
int merge_lists(float* pv, int32_t* pi, float* tmp_v, int32_t* tmp_i,
                float* out_v, int32_t* out_i, int b, int k, int n_lists,
                cudaStream_t s) {
  float* src_v = pv;
  int32_t* src_i = pi;
  float* bufs_v[2] = {tmp_v, pv};
  int32_t* bufs_i[2] = {tmp_i, pi};
  int lists = n_lists, pass = 0;
  while (lists > 32) {
    float* dv = bufs_v[pass & 1];
    int32_t* di = bufs_i[pass & 1];
    const int err = launch_merge(src_v, src_i, dv, di, b, k, lists, -INFINITY, s);
    if (err) return err;
    src_v = dv;
    src_i = di;
    lists = (lists + 31) / 32;
    ++pass;
  }
  return launch_merge(src_v, src_i, out_v, out_i, b, k, lists, 0.f, s);
}

// ---------------------------------------------------------------------------
// bf16 rows at k <= 32: the selection on the TMA + wgmma stream
// ---------------------------------------------------------------------------
//
// The stream (tma_stream.cuh, queries resident in shared memory or streamed
// with each doc box, both operands of wgmma from shared memory) hands the
// fold callback each 64-doc tile's accumulators: a consumer thread holds 16
// scores of each of two query rows (local rows r0 and r0 + 8), and the four
// lanes of a quad (equal lane >> 2) hold a row's 64. Per (row, 32 columns of
// the tile) the quad tests its 32 scores against the row's threshold and the
// query's shared one, counts the passing ones by a prefix over the quad and
// appends them to the row's buffer. A buffer that would overflow is first
// compacted: the row's list and buffer share its kStreamSortLen shared
// slots (the buffer at least 32, so after a compaction the 32 always fit),
// sorted by the warp (OI_B_COMPACT, below). wgmma is warpgroup-wide, so
// while a warp sorts, its warpgroup's products wait: on an H100 at B=256,
// N=98,304, D=384 (tools/stream_ablation.py) the stream and products take
// 0.08-0.09 ms, the selection's tests 0.05 more and its appends and
// compactions 0.38 more, whichever compaction is built. A block's lists gather every unit it
// walks; after the stream each consumer warp compacts what is left in its
// 16 rows and writes one list per (block, query row), met by the merge
// passes (ctas_per_qt lists a query). Docs past n_docs (TMA zero-fills
// their rows: the corpus is not padded in N) never pass.

// Measurement builds only (tools/stream_ablation.py): OI_B_SELECT 1 keeps
// the selection's tests and counts but appends and compacts nothing; 2
// neither reads nor publishes the shared threshold. The library the port
// loads is built without it (0).
#ifndef OI_B_SELECT
#define OI_B_SELECT 0
#endif
// How a warp compacts its rows (measurement builds pick the others): 0, as
// built, one row after another, the whole warp sorting its 64 slots (2
// keys a lane) in rolled loops, so the sort's code is small; 2 the same
// sort unrolled; 1 all eight quads at once, each sorting its own row (16
// keys a lane, which spills).
#ifndef OI_B_COMPACT
#define OI_B_COMPACT 0
#endif

constexpr int kStreamSortLen = 64;  // a row's shared slots: list (k) + buffer
constexpr int kStreamMaxK = kStreamSortLen - 32;
constexpr int kStreamSelBytes = oi_tma::kQueryRows * kStreamSortLen * 8;

// sort_keys_regs<2> in rolled loops: the same network, a fraction of the
// code (the stream kernel inlines a sort at each place a row may compact).
__device__ __forceinline__ void sort_keys_warp64(Key (&x)[2], int lane) {
#pragma unroll 1
  for (int size = 2; size <= 64; size <<= 1) {
#pragma unroll 1
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      if (stride == 32) {  // slots 0 and 1 of one lane (size is 64)
        const Key hi = x[0] > x[1] ? x[0] : x[1];
        const Key lo = x[0] > x[1] ? x[1] : x[0];
        x[0] = hi;
        x[1] = lo;
      } else {
        const bool lower = (lane & stride) == 0;
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          const Key p = __shfl_xor_sync(kFull, x[s], stride);
          const bool best_first = ((lane + 32 * s) & size) == 0;
          const bool keep_max = lower == best_first;
          x[s] = keep_max ? (p > x[s] ? p : x[s]) : (p < x[s] ? p : x[s]);
        }
      }
    }
  }
}

// A quad's bitonic sort of 4 E keys into descending order, in registers:
// key e in lane e % 4 of the quad (q = lane & 3), slot e / 4; strides of 4
// and more compare slots of one lane, 1 and 2 a shuffle within the quad.
// Every lane of the warp takes part (each quad sorts its own keys).
template <int E>
__device__ __forceinline__ void sort_keys_quad(Key (&x)[E], int q) {
#pragma unroll
  for (int size = 2; size <= 4 * E; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      if (stride >= 4) {
#pragma unroll
        for (int s = 0; s < E; ++s) {
          const int ps = s ^ (stride >> 2);
          if (ps < s) continue;  // each pair once, from its lower slot
          const bool best_first = ((q + 4 * s) & size) == 0;
          const Key hi = x[s] > x[ps] ? x[s] : x[ps];
          const Key lo = x[s] > x[ps] ? x[ps] : x[s];
          x[s] = best_first ? hi : lo;
          x[ps] = best_first ? lo : hi;
        }
      } else {
        const bool lower = (q & stride) == 0;
#pragma unroll
        for (int s = 0; s < E; ++s) {
          const Key p = __shfl_xor_sync(kFull, x[s], stride);
          const bool best_first = ((q + 4 * s) & size) == 0;
          const bool keep_max = lower == best_first;
          x[s] = keep_max ? (p > x[s] ? p : x[s]) : (p < x[s] ? p : x[s]);
        }
      }
    }
  }
}

// Inclusive prefix sum of n over the four lanes of each quad.
__device__ __forceinline__ int quad_scan(int n, int lane) {
  int x = __shfl_up_sync(kFull, n, 1, 4);
  if (lane & 3) n += x;
  x = __shfl_up_sync(kFull, n, 2, 4);
  if ((lane & 3) >= 2) n += x;
  return n;
}

__global__ void __launch_bounds__(oi_tma::kThreads, 1)
fused_topk_v2_tma(const __grid_constant__ CUtensorMap tq,
                  const __grid_constant__ CUtensorMap tc,
                  float* __restrict__ part_vals,      // (ctas_per_qt, b, k)
                  int32_t* __restrict__ part_ids,
                  unsigned* __restrict__ shared_thr,  // (b,) order keys, 0 first
                  int b, int n_docs, int k,
                  int sel_off,  // the lists' offset past the aligned base
                  const oi_tma::Geometry g) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  Key* sel = reinterpret_cast<Key*>(base + sel_off);
  // empty lists; the stream's first cluster barrier orders these stores
  // before any fold
  for (int i = threadIdx.x; i < oi_tma::kQueryRows * kStreamSortLen;
       i += oi_tma::kThreads)
    sel[i] = 0;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q0 = (blockIdx.x % g.n_qt) * oi_tma::kQueryRows;
  const int cta = blockIdx.x / g.n_qt;
  const int cap = kStreamSortLen - k;
  const int r0 = (warp >> 2) * 64 + 16 * (warp & 3) + (lane >> 2);
  // per row j of the thread (local row r0 + 8 j), quad-uniform: threshold,
  // buffered candidates, entries of the list; and the shared threshold's
  // key, loaded one fold ahead (thresholds only rise, so an older one is
  // still a bound)
  float tv[2] = {-INFINITY, -INFINITY};
  int ti[2] = {-1, -1}, cnt[2] = {0, 0}, filled[2] = {0, 0};
  unsigned gkey[2] = {0u, 0u};

  // Every quad of the warp compacts its row j at once (a sort of its
  // kStreamSortLen slots in registers: the list, the cntj buffered keys,
  // empty slots past them; the first k kept), then publishes the k-th score
  // of a full list.
  auto compact_rows = [&](int j, float& tvj, int& tij, int& cntj, int& filledj) {
    Key* slots = sel + (r0 + 8 * j) * kStreamSortLen;
    const int q = lane & 3;
    Key x[kStreamSortLen / 4];
    __syncwarp();
#pragma unroll
    for (int s = 0; s < kStreamSortLen / 4; ++s) {
      const int e = q + 4 * s;
      x[s] = e < k + cntj ? slots[e] : 0;
    }
    sort_keys_quad(x, q);
#pragma unroll
    for (int s = 0; s < kStreamSortLen / 4; ++s) slots[q + 4 * s] = x[s];
    __syncwarp();
    const bool full = filledj + cntj >= k;
    const Key kth = full ? slots[k - 1] : 0;
    filledj = min(k, filledj + cntj);
    cntj = 0;
    if (kth) unpack(kth, tvj, tij);
    if (q == 0 && kth && q0 + r0 + 8 * j < b && OI_B_SELECT != 2)
      atomicMax(shared_thr + q0 + r0 + 8 * j, static_cast<unsigned>(kth >> 32));
  };

  // The warp compacts row j of each quad whose lane 0 is flagged in
  // `quads`, one row after another (2 keys a lane), and publishes the k-th
  // score of each full list.
  auto compact_quads = [&](unsigned quads, int j, float& tvj, int& tij,
                           int& cntj, int& filledj) {
    while (quads) {
      const int src = __ffs(quads) - 1;
      quads &= quads - 1;
      const int r = __shfl_sync(kFull, r0, src) + 8 * j;
      const int c = __shfl_sync(kFull, cntj, src);
      const int f = __shfl_sync(kFull, filledj, src);
      Key* slots = sel + r * kStreamSortLen;
      __syncwarp();
      Key x[2];
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const int e = lane + 32 * s;
        x[s] = e < k + c ? slots[e] : 0;
      }
      if (OI_B_COMPACT != 2) sort_keys_warp64(x, lane);
#pragma unroll
      for (int s = 0; s < 2; ++s) slots[lane + 32 * s] = x[s];
      if (OI_B_COMPACT == 2) sort_keys_regs<2>(slots, lane);  // lane's own slots
      __syncwarp();
      const Key kth = f + c >= k ? slots[k - 1] : 0;
      if ((lane & ~3) == src) {
        filledj = min(k, f + c);
        cntj = 0;
        if (kth) unpack(kth, tvj, tij);
      }
      if (lane == src && kth && q0 + r < b && OI_B_SELECT != 2)
        atomicMax(shared_thr + q0 + r, static_cast<unsigned>(kth >> 32));
    }
  };

  auto fold = [&](float (&acc)[32], const oi_tma::Cell& cell, int s, int half,
                  int pos) {
    // value 4 c4 + 2 j + e: row j, tile column cell.col + 8 c4 + e
    const int doc0 = (s * oi_tma::kSuper + pos) * oi_tma::kLanes +
                     half * oi_tma::kDocRows + cell.col;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const bool row_ok = cell.row + 8 * j < b;
      const float gv = gkey[j] ? key_score(gkey[j]) : -INFINITY;
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // tile columns 32 h .. 32 h + 31
        auto test = [&] {
          unsigned m = 0;
#pragma unroll
          for (int t = 0; t < 8; ++t) {
            const int c4 = 4 * h + (t >> 1), e = t & 1;
            const int id = doc0 + 8 * c4 + e;
            const float v = acc[4 * c4 + 2 * j + e];
            m |= static_cast<unsigned>(row_ok && id < n_docs && v >= gv &&
                                       before(v, id, tv[j], ti[j]))
                 << t;
          }
          return m;
        };
        unsigned m = test();
        int n = __popc(m);
        int incl = quad_scan(n, lane);
        int total = __shfl_sync(kFull, incl, 3, 4);
        if (OI_B_SELECT == 1) {
          cnt[j] += total;
          continue;
        }
        // a buffer would overflow: compact first
        const bool need = cnt[j] + total > cap;
        const unsigned quads = __ballot_sync(kFull, need && (lane & 3) == 0);
        if (quads) {  // warp-uniform
          if (OI_B_COMPACT == 1)  // every row j of the warp
            compact_rows(j, tv[j], ti[j], cnt[j], filled[j]);
          else
            compact_quads(quads, j, tv[j], ti[j], cnt[j], filled[j]);
          m = test();
          n = __popc(m);
          incl = quad_scan(n, lane);
          total = __shfl_sync(kFull, incl, 3, 4);
        }
        Key* dst = sel + (r0 + 8 * j) * kStreamSortLen + k + cnt[j] + incl - n;
#pragma unroll
        for (int t = 0; t < 8; ++t) {
          if (!((m >> t) & 1u)) continue;
          const int c4 = 4 * h + (t >> 1), e = t & 1;
          *dst++ = pack(acc[4 * c4 + 2 * j + e], doc0 + 8 * c4 + e);
        }
        cnt[j] += total;
      }
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)  // for the next fold: its wait is hidden
      gkey[j] = cell.row + 8 * j < b && OI_B_SELECT != 2
                    ? __ldcg(shared_thr + cell.row + 8 * j)
                    : 0u;
  };

  oi_tma::stream_tiles<0, oi_tma::MmaBf16>(
      g, &tq, &tc, [] {}, fold, [](const oi_tma::Cell&, int, int, int) {});

  // the consumer warps of live warpgroups: what is left in each buffer, then
  // the warp's 16 lists (empty slots (-inf, -1))
  if (warp >= oi_tma::kConsumerWarps || q0 + (warp >> 2) * 64 >= g.b_pad) return;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const unsigned left = __ballot_sync(kFull, (lane & 3) == 0 && cnt[j] > 0);
    if (left == 0) continue;
    if (OI_B_COMPACT == 1)
      compact_rows(j, tv[j], ti[j], cnt[j], filled[j]);
    else
      compact_quads(left, j, tv[j], ti[j], cnt[j], filled[j]);
  }
  __syncwarp();
  for (int i = 0; i < 16; ++i) {
    const int r = (warp >> 2) * 64 + 16 * (warp & 3) + i;
    if (q0 + r >= b) break;
    const size_t lrow = ((size_t)cta * b + q0 + r) * k;
    for (int e = lane; e < k; e += 32)
      unpack(sel[r * kStreamSortLen + e], part_vals[lrow + e], part_ids[lrow + e]);
  }
}

}  // namespace

// bf16 rows at k <= 32 (fused_topk_v2_tma): shared_thr (b,), part_* (n_lists,
// b, k) and tmp_* (ceil(n_lists / 32), b, k) scratch, out_* (b, k) with
// empty slots (0.0, -1). n_lists is the stream's blocks per query tile
// (plan_grid), which the host computes as well: a mismatch is refused.
extern "C" int oi_fused_topk_v2_tma(const void* q, const void* docs,
                                    void* shared_thr, void* part_vals,
                                    void* part_ids, void* tmp_vals,
                                    void* tmp_ids, void* out_vals,
                                    void* out_ids, int b, int n_docs, int dim,
                                    int k, int n_lists, void* stream) {
  using namespace oi_tma;
  const int row_bytes = 2 * dim;
  if (b <= 0 || n_docs <= 0 || dim <= 0 || dim % 16 || k <= 0 || k > kStreamMaxK)
    return (int)cudaErrorInvalidValue;
  const int n_super = (int)(((long long)n_docs + kSuper * kLanes - 1) / (kSuper * kLanes));
  const Geometry g = plan(row_bytes, 2, b, n_super, kMaxParts, 0, kStreamSelBytes);
  if (g.ctas_per_qt != n_lists) return (int)cudaErrorInvalidValue;
  CUtensorMap tq, tc;
  if (!encode_rows(&tq, q, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, b, row_bytes,
                   kQueryRows) ||
      !encode_rows(&tc, docs, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, n_docs,
                   row_bytes, kDocRows / g.cluster))
    return (int)cudaErrorNotSupported;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned* thr = static_cast<unsigned*>(shared_thr);
  float* pv = static_cast<float*>(part_vals);
  int32_t* pi = static_cast<int32_t*>(part_ids);
  cudaError_t e = cudaMemsetAsync(thr, 0, sizeof(unsigned) * b, s);
  if (e != cudaSuccess) return (int)e;
  // the lists follow the stream's rings and barriers
  const int sel_off = smem_bytes(g) - 1024;
  const int err = launch_stream_smem(fused_topk_v2_tma, g,
                                     smem_bytes(g) + kStreamSelBytes, s, tq, tc,
                                     pv, pi, thr, b, n_docs, k, sel_off, g);
  if (err) return err;
  return merge_lists(pv, pi, static_cast<float*>(tmp_vals),
                     static_cast<int32_t*>(tmp_ids), static_cast<float*>(out_vals),
                     static_cast<int32_t*>(out_ids), b, k, n_lists, s);
}

// shared_thr: (b,) scratch; part_*: (n_split, b, k) scratch; tmp_*: (ceil(n_split / 32), b, k)
// scratch (unused at 32 splits or fewer); out_*: (b, k), empty slots (0.0,
// -1). list_in_smem: each row's list and buffer in sort_len shared slots
// (cap = sort_len - k); else cap buffer slots and the list in part_*.
extern "C" int oi_fused_topk_v2(const void* q, const void* docs, int is_bf16,
                                void* shared_thr, void* part_vals,
                                void* part_ids, void* tmp_vals, void* tmp_ids,
                                void* out_vals,
                                void* out_ids, int b, int n_docs, int dim,
                                int k, int qt, int n_split, int split_len,
                                int cap, int sort_len, int list_in_smem,
                                void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (b <= 0 || n_docs <= 0 || dim <= 0 || dim % 16 || k <= 0 || cap < 32 ||
      sort_len < k + cap || (sort_len & (sort_len - 1)) || n_split <= 0 ||
      (list_in_smem && cap != sort_len - k) ||
      (long long)n_split * split_len < n_docs ||
      (long long)(n_split - 1) * split_len >= n_docs ||
      split_len % 128 || (qt != 16 && qt != 64))
    return (int)cudaErrorInvalidValue;
  float* pv = static_cast<float*>(part_vals);
  int32_t* pi = static_cast<int32_t*>(part_ids);
  unsigned* thr = static_cast<unsigned*>(shared_thr);
  int err;
  if (is_bf16)
    err = qt == 16 ? launch_partial<__nv_bfloat16, 16, 128>(
                         q, docs, pv, pi, thr, b, n_docs, dim, k, n_split,
                         split_len, cap, sort_len, list_in_smem, s)
                   : launch_partial<__nv_bfloat16, 64, 128>(
                         q, docs, pv, pi, thr, b, n_docs, dim, k, n_split,
                         split_len, cap, sort_len, list_in_smem, s);
  else
    err = qt == 16 ? launch_partial<float, 16, 128>(q, docs, pv, pi, thr, b, n_docs,
                                                    dim, k, n_split, split_len,
                                                    cap, sort_len, list_in_smem, s)
                   : launch_partial<float, 64, 128>(q, docs, pv, pi, thr, b, n_docs,
                                                   dim, k, n_split, split_len,
                                                   cap, sort_len, list_in_smem, s);
  if (err) return err;
  return merge_lists(pv, pi, static_cast<float*>(tmp_vals),
                     static_cast<int32_t*>(tmp_ids), static_cast<float*>(out_vals),
                     static_cast<int32_t*>(out_ids), b, k, n_split, s);
}

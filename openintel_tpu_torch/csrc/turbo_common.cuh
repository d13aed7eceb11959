// Shared pieces of the candidate-cell kernels C1/C2 (turbo_i8.cu), D
// (turbo_f32.cu) and E1/E2 (turbo_i4.cu), and of kernel S (dot_only.cu).
// Kernel A (i8_top2g.cu) walks its corpus the same way with
// its own copy of this loop: on stream_docs it ran 3 % slower at the main
// path's shapes, timed alternately against its own loop on an H100
// (PERF.md), so it keeps its own.
//
// Both stream a row-major corpus in 128-row sub-blocks against a tile of
// 32 queries staged in shared memory. A warp owns 8 doc lanes (one
// mma.sync n tile): its thread (gq = lane / 4, tq = lane % 4) loads 16
// bytes of doc row gq per 64-byte k chunk straight from device memory into
// B fragments, one step ahead of the products, and reads the matching 16
// bytes of query rows gq and gq + 8 of both 16-query m tiles from shared
// memory. A and B take the same permutation of k inside a chunk (bytes
// 0..7 of each thread's 16 feed one k step, bytes 8..15 the next), so a
// dot is unchanged for integer operands, and for floats only its order of
// summation moves. Each thread then holds 8 cells, its C fragments:
// cell i = 4 mi + c is query 16 mi + gq + 8 (c >> 1), doc lane 2 tq + (c & 1).

#pragma once

#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

namespace oi {

constexpr int kQueryTile = 32;    // queries per block (two m tiles)
constexpr int kLanes = 128;       // docs per sub-block (= lanes)
constexpr int kSlice = 8;         // doc lanes per warp (one n tile)
constexpr int kSuper = 128;       // sub-blocks per 16,384-doc super
constexpr int kMaxPass = 8;       // 64-byte k chunks per pass, at most
constexpr int kSmemMax = 232448;  // dynamic shared memory one block may use
// (bias 32768 + the reference's normal-float flag 2^23) << 7
constexpr int32_t kFlag128 = (32768 + (1 << 23)) * 128;

// Bytes per staged query row: whole 64-byte k chunks (the tail stays zero),
// made = 64 (mod 128) so the 16-byte loads of two neighbouring rows fall on
// disjoint shared-memory banks.
__host__ __device__ inline int row_stride(int row_bytes) {
  const int d64 = (row_bytes + 63) / 64 * 64;
  return d64 % 128 == 64 ? d64 : d64 + 64;
}

// Copy kQueryTile rows of row_bytes (a multiple of 16) into q_s, zero-filled
// to the stride; threads tid, tid + n_threads, ... of the block share it.
__device__ inline void stage_queries(int8_t* q_s, const int8_t* q,
                                     int row_bytes, int tid, int n_threads) {
  const int stride = row_stride(row_bytes);
  const int vec = stride / 16;
  for (int v = tid; v < kQueryTile * vec; v += n_threads) {
    const int r = v / vec;
    const int c = 16 * (v - r * vec);
    *reinterpret_cast<int4*>(q_s + r * stride + c) =
        c < row_bytes
            ? *reinterpret_cast<const int4*>(q + (size_t)r * row_bytes + c)
            : make_int4(0, 0, 0, 0);
  }
}

// c += a (16 x 32, row-major) x b (32 x 8, column-major), int8 -> int32.
__device__ __forceinline__ void mma_s8(int32_t (&c)[4], int32_t a0,
                                       int32_t a1, int32_t a2, int32_t a3,
                                       int32_t b0, int32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// c += a (16 x 16, row-major) x b (16 x 8, column-major), bf16 -> f32.
__device__ __forceinline__ void mma_bf16(float (&c)[4], int32_t a0,
                                         int32_t a1, int32_t a2, int32_t a3,
                                         int32_t b0, int32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// The A fragments of one 16-byte k slice: rows gq, gq + 8 of m tiles 0, 1.
struct QFrag {
  int4 r[2][2];  // [m tile][row gq, row gq + 8]
};

// Stream sub-blocks [sb_begin, sb_end) of this thread's doc row (`docs`
// points at its row in sub-block 0, plus 16 tq bytes) through the products:
// per sub-block, Acc acc{}; then dot(acc, a, b) for each 16-byte slice of
// the k chunks, with a the queries' fragments and b the 16 doc bytes; then
// done(sb, acc). Rows of D beyond kMaxPass chunks run in passes of KP
// chunks (NP passes, or from row_bytes when NP is 0).
template <int KP, int NP, typename Acc, typename Dot, typename Done>
__device__ __forceinline__ void stream_docs(const int8_t* docs,
                                            size_t sb_bytes, int sb_begin,
                                            int sb_end, int row_bytes,
                                            const int8_t* q_s, int gq,
                                            int tq, Dot dot, Done done) {
  const int stride = row_stride(row_bytes);
  const int n_pass = NP ? NP : ((row_bytes + 63) / 64 + KP - 1) / KP;
  int4 next[KP];  // B fragments of the next (sub-block, pass) step
  auto load = [&](int sb, int pass) {
#pragma unroll
    for (int s = 0; s < KP; ++s) {
      const int off = 64 * (pass * KP + s);
      next[s] = off + 16 * tq < row_bytes
                    ? *reinterpret_cast<const int4*>(docs + sb * sb_bytes + off)
                    : make_int4(0, 0, 0, 0);
    }
  };
  load(sb_begin, 0);
  for (int sb = sb_begin; sb < sb_end; ++sb) {
    Acc acc{};
    for (int pass = 0; pass < n_pass; ++pass) {
      int4 b[KP];
#pragma unroll
      for (int s = 0; s < KP; ++s) b[s] = next[s];
      if (pass + 1 < n_pass) {
        load(sb, pass + 1);
      } else if (sb + 1 < sb_end) {
        load(sb + 1, 0);
      }
#pragma unroll
      for (int s = 0; s < KP; ++s) {
        const int chunk = 64 * (pass * KP + s);
        // warp-uniform: a chunk wholly past the row (only when passes
        // overshoot; one pass has exactly ceil(row_bytes / 64) chunks)
        if (NP == 0 && chunk >= row_bytes) continue;
        const int off = chunk + 16 * tq;  // zero-filled past the row in q_s
        QFrag a;
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          a.r[mi][0] = *reinterpret_cast<const int4*>(
              q_s + (16 * mi + gq) * stride + off);
          a.r[mi][1] = *reinterpret_cast<const int4*>(
              q_s + (16 * mi + gq + 8) * stride + off);
        }
        dot(acc, a, b[s]);
      }
    }
    done(sb, acc);
  }
}

// Call f(KP, NP) (as std::integral_constant) for the fewest passes of at
// most kMaxPass chunks over a row of row_bytes, split evenly. One pass
// (row_bytes <= 512) is compiled apart: a runtime pass loop costs ~1.5x.
template <typename F>
int with_passes(int row_bytes, F&& f) {
  using std::integral_constant;
  const int n_chunks = (row_bytes + 63) / 64;
  const int n_pass = (n_chunks + kMaxPass - 1) / kMaxPass;
  const int kp = (n_chunks + n_pass - 1) / n_pass;
#define OI_PASS(KP, NP) \
  return f(integral_constant<int, KP>{}, integral_constant<int, NP>{})
  if (n_pass == 1) {
    switch (kp) {
      case 1: OI_PASS(1, 1);
      case 2: OI_PASS(2, 1);
      case 3: OI_PASS(3, 1);
      case 4: OI_PASS(4, 1);
      case 5: OI_PASS(5, 1);
      case 6: OI_PASS(6, 1);
      case 7: OI_PASS(7, 1);
      case 8: OI_PASS(8, 1);
    }
  } else {  // n_chunks > 8: kp >= 5
    switch (kp) {
      case 5: OI_PASS(5, 0);
      case 6: OI_PASS(6, 0);
      case 7: OI_PASS(7, 0);
      case 8: OI_PASS(8, 0);
    }
  }
#undef OI_PASS
  return (int)cudaErrorInvalidValue;
}

// Signed max of a key into a top-1 or top-2 state. Keys of one cell are
// distinct, so the state ends as the cell's exact top-1 or top-2.
template <int SLOTS>
__device__ __forceinline__ void fold_key(int32_t& a1, int32_t& a2,
                                         int32_t key) {
  if (SLOTS == 2) a2 = max(a2, min(a1, key));
  a1 = max(a1, key);
}

}  // namespace oi

// Kernel A: int8 candidate cells, top-2 keys per (query, lane, group).
//
// Replaces openintel_tpu/ops/pallas/dense_topk.py:_turbo_kernel_i8_top2g
// (launched by dense_topk_fast_i8_grouped). Same cells, bit for bit:
//
//   key = dot(q, doc) * 128 + FLAG128 + pos
//
// with dot the int32 product of int8 rows and pos the doc's 128-doc
// sub-block within its 16,384-doc super. For each (query, lane = id % 128,
// group of `group` consecutive supers) the kernel keeps the top-2 keys and
// the absolute super index of each. Within one step of `sub` sub-blocks
// the exact top-2 is taken (keys of a step are distinct); steps fold into
// the group state in ascending order with the reference's merge, whose
// tie rules (a strict > for slot 1, >= between the two slot-2 contenders)
// make the super labels depend on the step width, so the step width is a
// parameter (block_c / 128).
//
// Layout: the corpus is row-major (N_pad, D) int8 with N_pad a multiple of
// 16,384; queries are (B_pad, D) int8 with B_pad a multiple of 32; D is a
// multiple of 16. A cell's fold reads only its own lane's docs, so the
// work splits by lane: one warp (one block) per (32-query tile, 8 doc
// lanes, group) walks the group's sub-blocks in ascending order with no
// block barrier. Its dots run on the int8 tensor cores (mma.sync
// m16n8k32, two 16-query m tiles x one 8-doc n tile); each thread holds 8
// cells (its C fragments) for the whole group. The queries sit in shared
// memory; the 8 doc rows of a sub-block go straight from device memory to
// B fragments, one 16-byte load per 64-byte k chunk and thread, and the
// next step's loads are issued before the current step's products. A and B
// take the same permutation of k inside a chunk, so the dot is unchanged.
// D beyond 512 bytes runs in passes of at most 8 chunks.
//
// What bounds it on an H100: the corpus stream from L2. At 1.25M x 384 one
// batch reads 0.48 GB from device memory, and each of the B_pad/32 query
// tiles rereads it (3.8 GB from L2 at B=256); each warp also waits on its
// own loads, with only ~8 warps per SM at B=256. Left for later: sharing a
// doc tile among query tiles in shared memory (fewer L2 reads), deeper
// prefetch, and wgmma with TMA loads.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kQueryTile = 32;  // queries per block (two m tiles)
constexpr int kLanes = 128;     // docs per sub-block (= lanes)
constexpr int kSlice = 8;       // doc lanes per block (one n tile)
constexpr int kSuper = 128;     // sub-blocks per super
constexpr int kMaxPass = 8;     // 64-byte k chunks per pass, at most
constexpr int kSmemMax = 232448;  // dynamic shared memory one block may use
// (bias 32768 + the reference's normal-float flag 2^23) << 7
constexpr int32_t kFlag128 = (32768 + (1 << 23)) * 128;

// Bytes per staged query row: D rounded up to whole 64-byte k chunks (the
// tail stays zero), then made = 64 (mod 128) so the 16-byte fragment loads
// of two neighbouring rows fall on disjoint shared-memory banks.
__host__ __device__ inline int row_stride(int dim) {
  const int d64 = (dim + 63) / 64 * 64;
  return d64 % 128 == 64 ? d64 : d64 + 64;
}

// c += a (16 x 32, row-major) x b (32 x 8, column-major), int8 -> int32.
// r0, r8: this thread's words of A rows gq and gq + 8 (k 4 tq.., 16 + 4 tq..)
__device__ __forceinline__ void mma_s8(int32_t (&c)[4], int32_t r0_lo,
                                       int32_t r8_lo, int32_t r0_hi,
                                       int32_t r8_hi, int32_t b0, int32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(r0_lo), "r"(r8_lo), "r"(r0_hi), "r"(r8_hi), "r"(b0), "r"(b1));
}

template <int KP, int NP>  // k chunks per pass; passes (0: from D)
__global__ void __launch_bounds__(32)
i8_top2g_kernel(const int8_t* __restrict__ q,       // (b_pad, dim)
                const int8_t* __restrict__ corpus,  // (n_super * 16384, dim)
                int32_t* __restrict__ out_k1,       // (b_pad, ng * 128) each
                int32_t* __restrict__ out_k2,
                int32_t* __restrict__ out_s1,
                int32_t* __restrict__ out_s2,
                int dim, int n_super, int group, int sub, int ng) {
  extern __shared__ __align__(16) int8_t q_s[];  // kQueryTile rows
  const int stride = row_stride(dim);
  const int n_pass = NP ? NP : ((dim + 63) / 64 + KP - 1) / KP;
  const int lane = threadIdx.x;
  const int gq = lane >> 2;  // mma groupID
  const int tq = lane & 3;   // mma threadID_in_group
  const int q0 = blockIdx.x * kQueryTile;
  const int slice = blockIdx.y;  // doc lanes 8 slice .. 8 slice + 7
  const int g = blockIdx.z;

  for (int i = lane; i < kQueryTile * stride / 16; i += 32)
    reinterpret_cast<int4*>(q_s)[i] = make_int4(0, 0, 0, 0);
  __syncwarp();
  const int vec = dim / 16;
  for (int v = lane; v < kQueryTile * vec; v += 32) {
    const int r = v / vec;
    const int c = v - r * vec;
    *reinterpret_cast<int4*>(q_s + r * stride + 16 * c) =
        *reinterpret_cast<const int4*>(q + (size_t)(q0 + r) * dim + 16 * c);
  }
  __syncwarp();

  const int sb_begin = g * group * kSuper;
  const int sb_end = min((g + 1) * group, n_super) * kSuper;
  // this thread's doc row (B fragment column gq) within each sub-block
  const int8_t* docs = corpus + (size_t)(kSlice * slice + gq) * dim + 16 * tq;
  const size_t sb_bytes = (size_t)kLanes * dim;

  int4 next[KP];  // B fragments of the next (sub-block, pass) step
  auto load = [&](int sb, int pass) {
#pragma unroll
    for (int s = 0; s < KP; ++s) {
      const int off = 64 * (pass * KP + s);
      next[s] = off + 16 * tq < dim
                    ? *reinterpret_cast<const int4*>(docs + sb * sb_bytes + off)
                    : make_int4(0, 0, 0, 0);
    }
  };

  // cell i = 4 mi + c: query 16 mi + gq + 8 (c >> 1), lane 2 tq + (c & 1)
  int32_t a1[8], a2[8];                    // top-2 of the current step
  int32_t g1[8], g2[8], gs1[8], gs2[8];    // group state
  load(sb_begin, 0);
  for (int sb = sb_begin; sb < sb_end; ++sb) {
    int32_t acc[2][4] = {};
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
        // warp-uniform: a chunk wholly past D (only when passes overshoot;
        // one pass has exactly ceil(D / 64) chunks)
        if (NP == 0 && chunk >= dim) continue;
        const int off = chunk + 16 * tq;  // zero-filled past D in q_s
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          const int4 r0 =
              *reinterpret_cast<const int4*>(q_s + (16 * mi + gq) * stride + off);
          const int4 r8 = *reinterpret_cast<const int4*>(
              q_s + (16 * mi + gq + 8) * stride + off);
          // k-step one takes bytes 0..7 of each thread's 16, k-step two 8..15
          mma_s8(acc[mi], r0.x, r8.x, r0.y, r8.y, b[s].x, b[s].y);
          mma_s8(acc[mi], r0.z, r8.z, r0.w, r8.w, b[s].z, b[s].w);
        }
      }
    }

    const int pos = sb % kSuper;  // sub-block within its super
    const int cur = sb / kSuper;  // absolute super index
    const bool step_first = (pos % sub) == 0;
    const bool step_last = (pos % sub) == sub - 1;
    const bool group_first_step = (sb - sb_begin) < sub;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int32_t key = acc[i >> 2][i & 3] * 128 + (kFlag128 + pos);
      if (step_first) {
        a1[i] = key;
        a2[i] = 0;  // sentinel: below every real key
      } else {
        a2[i] = max(a2[i], min(a1[i], key));
        a1[i] = max(a1[i], key);
      }
      if (step_last) {
        if (group_first_step) {
          g1[i] = a1[i];
          g2[i] = a2[i];
          gs1[i] = cur;
          gs2[i] = cur;
        } else {
          // the reference's merge: ties keep the incumbent in slot 1
          const bool upd1 = a1[i] > g1[i];
          const int32_t m = min(g1[i], a1[i]);  // displaced slot-1 loser
          const int32_t sup_m = upd1 ? gs1[i] : cur;
          const int32_t c2 = max(g2[i], a2[i]);
          const int32_t sup_c2 = a2[i] > g2[i] ? cur : gs2[i];
          g1[i] = max(g1[i], a1[i]);
          gs1[i] = upd1 ? cur : gs1[i];
          g2[i] = max(m, c2);
          gs2[i] = m >= c2 ? sup_m : sup_c2;
        }
      }
    }
  }

  const int width = ng * 128;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = q0 + 16 * (i >> 2) + gq + 8 * ((i & 3) >> 1);
    const int col = g * 128 + kSlice * slice + 2 * tq + (i & 1);
    const size_t o = (size_t)row * width + col;
    out_k1[o] = g1[i];
    out_k2[o] = g2[i];
    out_s1[o] = gs1[i];
    out_s2[o] = gs2[i];
  }
}

template <int KP, int NP>
int launch(const void* q, const void* corpus, void* k1, void* k2, void* s1,
           void* s2, int b_pad, int dim, int n_super, int group, int sub,
           cudaStream_t stream) {
  const int smem = kQueryTile * row_stride(dim);
  cudaError_t err = cudaFuncSetAttribute(
      i8_top2g_kernel<KP, NP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  const int ng = (n_super + group - 1) / group;
  const dim3 grid(b_pad / kQueryTile, kLanes / kSlice, ng);
  i8_top2g_kernel<KP, NP><<<grid, 32, smem, stream>>>(
      static_cast<const int8_t*>(q), static_cast<const int8_t*>(corpus),
      static_cast<int32_t*>(k1), static_cast<int32_t*>(k2),
      static_cast<int32_t*>(s1), static_cast<int32_t*>(s2), dim, n_super,
      group, sub, ng);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int oi_i8_top2g(const void* q, const void* corpus, void* k1,
                           void* k2, void* s1, void* s2, int b_pad, int dim,
                           int n_super, int group, int sub, void* stream) {
  if (dim % 16 || b_pad % kQueryTile ||
      kQueryTile * row_stride(dim) > kSmemMax)
    return (int)cudaErrorInvalidValue;
  // the fewest passes of at most kMaxPass chunks, split evenly; one pass
  // (D <= 512) is compiled apart, since a runtime pass loop costs ~1.5x
  const int n_chunks = (dim + 63) / 64;
  const int n_pass = (n_chunks + kMaxPass - 1) / kMaxPass;
  const int kp = (n_chunks + n_pass - 1) / n_pass;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define OI_LAUNCH(KP, NP)                                                  \
  return launch<KP, NP>(q, corpus, k1, k2, s1, s2, b_pad, dim, n_super,    \
                        group, sub, s)
  if (n_pass == 1) {
    switch (kp) {
      case 1: OI_LAUNCH(1, 1);
      case 2: OI_LAUNCH(2, 1);
      case 3: OI_LAUNCH(3, 1);
      case 4: OI_LAUNCH(4, 1);
      case 5: OI_LAUNCH(5, 1);
      case 6: OI_LAUNCH(6, 1);
      case 7: OI_LAUNCH(7, 1);
      case 8: OI_LAUNCH(8, 1);
    }
  } else {  // n_chunks > 8: kp >= 5
    switch (kp) {
      case 5: OI_LAUNCH(5, 0);
      case 6: OI_LAUNCH(6, 0);
      case 7: OI_LAUNCH(7, 0);
      case 8: OI_LAUNCH(8, 0);
    }
  }
#undef OI_LAUNCH
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* oi_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

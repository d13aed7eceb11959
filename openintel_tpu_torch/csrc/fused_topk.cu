// Kernel B: exact fused cosine top-k, the score matrix never stored.
//
// Replaces openintel_tpu/ops/pallas/dense_topk.py:_kernel (launched by
// dense_topk_pallas): per query, the k best docs by (score desc, doc id
// asc) of float32 products. bf16 operands widen exactly to float32 (with
// the intrinsic) and every product accumulates in float32 with fmaf.
//
// Two kernels. The partial kernel gives one block each 8-query tile x
// corpus split: warp w owns query w of the tile and a sorted top-k list in
// shared memory; for each chunk of 32 docs (staged in shared memory as
// float32) lane l scores doc l, the lanes whose score beats the list's
// k-th entry are inserted one at a time in ascending doc order (warp-wide
// rank count, shift, store). The merge kernel gives one warp each query:
// lane p holds the head of split p's list and the warp emits the best head
// k times. Slots never filled hold (-inf, -1); the wrapper masks them to
// the (0.0, -1) padding contract.
//
// What bounds it on an H100: at the corpus sizes it serves (< 100k docs,
// 154 MB of float32 rows at 100k x 384) each 8-query tile rereads its
// split, so the corpus crosses L2 B/8 times; the products run on the
// FMA pipes, one lane per doc, 2 shared-memory loads per FMA. The list
// insertion is serial per candidate but rare once the list is warm.
// Left for later: tensor-core products (tf32 is not exact enough; a 3xbf16
// split or wgmma in f32 emulation), larger query tiles, and a threshold
// shared across splits.

#include <cmath>
#include <cstdint>
#include <climits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kQueriesPerBlock = 8;  // one warp each
constexpr int kChunk = 32;           // docs scored per pass, one per lane
constexpr int kThreads = kQueriesPerBlock * 32;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// (v, id) ranks strictly before (ov, oid): a higher score, or an equal
// score and a lower doc id. Empty slots are (-inf, -1) and real scores are
// finite, so no real candidate ranks after an empty slot.
__device__ __forceinline__ bool before(float v, int id, float ov, int oid) {
  return v > ov || (v == ov && id < oid);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
fused_topk_partial(const T* __restrict__ q,     // (b, dim)
                   const T* __restrict__ docs,  // (n_docs, dim)
                   float* __restrict__ part_vals,  // (n_split, b, k)
                   int32_t* __restrict__ part_ids,
                   int b, int n_docs, int dim, int k, int split_len) {
  extern __shared__ float smem[];
  const int dstride = dim + 1;  // odd stride: conflict-free per-lane rows
  float* q_s = smem;                                 // 8 * dim
  float* d_s = q_s + kQueriesPerBlock * dim;         // kChunk * dstride
  float* l_v = d_s + kChunk * dstride;               // 8 * k
  int32_t* l_i = reinterpret_cast<int32_t*>(l_v + kQueriesPerBlock * k);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int q0 = blockIdx.x * kQueriesPerBlock;
  const int split = blockIdx.y;
  const int d_begin = split * split_len;
  const int d_end = min(d_begin + split_len, n_docs);

  for (int i = tid; i < kQueriesPerBlock * dim; i += kThreads) {
    const int r = i / dim;
    q_s[i] = q0 + r < b ? to_float(q[(size_t)q0 * dim + i]) : 0.f;
  }
  for (int i = tid; i < kQueriesPerBlock * k; i += kThreads) {
    l_v[i] = -INFINITY;
    l_i[i] = -1;
  }
  float* lv = l_v + warp * k;
  int32_t* li = l_i + warp * k;
  const bool live = q0 + warp < b;
  const float* qr = q_s + warp * dim;

  for (int base = d_begin; base < d_end; base += kChunk) {
    __syncthreads();  // the previous chunk is consumed (and lists seeded)
    const int n_here = min(kChunk, d_end - base);
    for (int i = tid; i < kChunk * dim; i += kThreads) {
      const int r = i / dim;
      d_s[r * dstride + (i - r * dim)] =
          r < n_here ? to_float(docs[(size_t)base * dim + i]) : 0.f;
    }
    __syncthreads();
    if (!live) continue;

    const float* dr = d_s + lane * dstride;
    float s = 0.f;
    for (int c = 0; c < dim; ++c) s = fmaf(qr[c], dr[c], s);
    const int id = base + lane;
    unsigned cand =
        __ballot_sync(kFull, lane < n_here && before(s, id, lv[k - 1], li[k - 1]));
    while (cand) {  // warp-uniform: ascending doc id
      const int src = __ffs(cand) - 1;
      cand &= cand - 1;
      const float v = __shfl_sync(kFull, s, src);
      const int vid = __shfl_sync(kFull, id, src);
      if (!before(v, vid, lv[k - 1], li[k - 1])) continue;
      int rank = 0;  // entries that rank before the candidate
      for (int j = lane; j < k; j += 32) rank += before(lv[j], li[j], v, vid);
#pragma unroll
      for (int o = 16; o; o >>= 1) rank += __shfl_xor_sync(kFull, rank, o);
      // shift [rank, k-2] one slot down, 32 entries a pass from the top
      for (int top = k - 2; top >= rank; top -= 32) {
        const int j = top - lane;
        float tv = 0.f;
        int ti = 0;
        if (j >= rank) {
          tv = lv[j];
          ti = li[j];
        }
        __syncwarp();
        if (j >= rank) {
          lv[j + 1] = tv;
          li[j + 1] = ti;
        }
        __syncwarp();
      }
      if (lane == 0) {
        lv[rank] = v;
        li[rank] = vid;
      }
      __syncwarp();
    }
  }

  if (live) {
    const size_t row = ((size_t)split * b + q0 + warp) * k;
    for (int j = lane; j < k; j += 32) {
      part_vals[row + j] = lv[j];
      part_ids[row + j] = li[j];
    }
  }
}

__global__ void fused_topk_merge(const float* __restrict__ part_vals,
                                 const int32_t* __restrict__ part_ids,
                                 float* __restrict__ out_vals,
                                 int32_t* __restrict__ out_ids, int b, int k,
                                 int n_split) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= b) return;  // whole warps exit together
  const bool has = lane < n_split;
  const size_t off = ((size_t)(has ? lane : 0) * b + row) * k;
  int head = 0;
  for (int t = 0; t < k; ++t) {
    float v = -INFINITY;
    int id = INT_MAX;  // exhausted
    if (has && head < k && part_ids[off + head] >= 0) {
      v = part_vals[off + head];
      id = part_ids[off + head];
    }
    float bv = v;
    int bid = id;
    int bl = lane;
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
    const bool found = bid != INT_MAX;  // splits hold disjoint doc ids
    if (lane == 0) {
      out_vals[(size_t)row * k + t] = found ? bv : -INFINITY;
      out_ids[(size_t)row * k + t] = found ? bid : -1;
    }
    if (found && lane == bl) ++head;
  }
}

template <typename T>
int launch_fused(const void* q, const void* docs, void* part_vals,
                 void* part_ids, void* out_vals, void* out_ids, int b,
                 int n_docs, int dim, int k, int n_split, int split_len,
                 cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (kQueriesPerBlock * dim + kChunk * (dim + 1)) +
      (sizeof(float) + sizeof(int32_t)) * kQueriesPerBlock * k;
  cudaError_t err = cudaFuncSetAttribute(
      fused_topk_partial<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((b + kQueriesPerBlock - 1) / kQueriesPerBlock, n_split);
  fused_topk_partial<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(docs),
      static_cast<float*>(part_vals), static_cast<int32_t*>(part_ids), b,
      n_docs, dim, k, split_len);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int warps_per_block = 8;
  fused_topk_merge<<<(b + warps_per_block - 1) / warps_per_block,
                     warps_per_block * 32, 0, stream>>>(
      static_cast<const float*>(part_vals),
      static_cast<const int32_t*>(part_ids), static_cast<float*>(out_vals),
      static_cast<int32_t*>(out_ids), b, k, n_split);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int oi_fused_topk(const void* q, const void* docs, int is_bf16,
                             void* part_vals, void* part_ids, void* out_vals,
                             void* out_ids, int b, int n_docs, int dim, int k,
                             int n_split, int split_len, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_fused<__nv_bfloat16>(q, docs, part_vals, part_ids,
                                       out_vals, out_ids, b, n_docs, dim, k,
                                       n_split, split_len, s);
  return launch_fused<float>(q, docs, part_vals, part_ids, out_vals,
                             out_ids, b, n_docs, dim, k, n_split, split_len,
                             s);
}

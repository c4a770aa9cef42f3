// Batched cosine top-k over a record slab, f32 or blockwise int8.
//
// Replaces the TPU kernel topk_similarity_2d of the JAX package's
// kernels/topk_similarity.py. That kernel carries a running top-k in its
// output refs across a sequential grid; a GPU grid runs its blocks in
// parallel, so the running merge becomes two passes with nothing carried
// across blocks:
//
//   pass 1, grid (chunks, Q): one CTA of 256 threads scores one chunk of
//     256 records against one query. The query sits in shared memory; the
//     records are staged 32 dimensions at a time, transposed, into a
//     shared tile (row pitch 257: conflict-free on both the write and the
//     read). Thread r accumulates record r's dot product over d = 0..D-1
//     in that fixed order, every product and sum explicitly rounded
//     (__fmul_rn / __fadd_rn). int8 records are dequantized in the tile
//     with their block scale (q * s, rounded) first. Positions >= n score
//     -inf. The CTA then writes its chunk-local top-k, sorted by (score
//     desc, index asc): k rounds of a block-wide argmax with a min-index
//     tie-break, each round taking the best candidate strictly after the
//     previous pick in that total order.
//   pass 2, grid Q: the same selection over the chunks' k-lists. Every
//     global top-k member is in its chunk's top-k, and the order is a
//     total order on (score, index), so the merge is exact.
//
// The plain PyTorch version in kernels/topk_similarity.py accumulates the
// same products in the same order and selects with a stable sort, so
// scores and indices agree bit for bit.
//
// Bound: at the planner's shapes (Q = 20 queries, D = 256, a slab of a few
// thousand records) the work is a few MFLOP and a few MB: bytes-bound on
// paper, launch-bound in practice.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <limits.h>

namespace {

constexpr int CHUNK = 256;  // records per CTA == threads per CTA
constexpr int DT = 32;      // dimensions per staged tile
constexpr int PITCH = CHUNK + 1;

__device__ __forceinline__ bool better(float s1, int i1, float s2, int i2) {
  return s1 > s2 || (s1 == s2 && i1 < i2);
}

// (s, i) comes strictly after (ls, li) in the (score desc, index asc) order
__device__ __forceinline__ bool after(float s, int i, float ls, int li) {
  return s < ls || (s == ls && i > li);
}

// Block-wide best (score desc, index asc); every thread gets the result.
// red_s/red_i hold 33 entries.
__device__ void block_best(float& s, int& i, float* red_s, int* red_i) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float s2 = __shfl_down_sync(0xffffffffu, s, off);
    const int i2 = __shfl_down_sync(0xffffffffu, i, off);
    if (better(s2, i2, s, i)) {
      s = s2;
      i = i2;
    }
  }
  if (lane == 0) {
    red_s[warp] = s;
    red_i[warp] = i;
  }
  __syncthreads();
  if (warp == 0) {
    const int nw = blockDim.x >> 5;
    s = lane < nw ? red_s[lane] : -INFINITY;
    i = lane < nw ? red_i[lane] : INT_MAX;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float s2 = __shfl_down_sync(0xffffffffu, s, off);
      const int i2 = __shfl_down_sync(0xffffffffu, i, off);
      if (better(s2, i2, s, i)) {
        s = s2;
        i = i2;
      }
    }
    if (lane == 0) {
      red_s[32] = s;
      red_i[32] = i;
    }
  }
  __syncthreads();
  s = red_s[32];
  i = red_i[32];
  __syncthreads();
}

template <bool INT8>
__global__ void __launch_bounds__(CHUNK) topk_chunk_kernel(
    const float* __restrict__ qm, int D, const void* __restrict__ recs,
    const float* __restrict__ scales, int nb, int qblock, long long n, int k,
    int n_chunks, float* __restrict__ part_s, int* __restrict__ part_i) {
  extern __shared__ float smem[];
  float* qs = smem;      // (D,)
  float* tile = qs + D;  // (DT, PITCH)
  __shared__ float red_s[33];
  __shared__ int red_i[33];

  const int c = blockIdx.x, qi = blockIdx.y, tid = threadIdx.x;
  const long long r0 = (long long)c * CHUNK;
  for (int d = tid; d < D; d += CHUNK) qs[d] = qm[(long long)qi * D + d];

  float acc = 0.0f;
  for (int d0 = 0; d0 < D; d0 += DT) {
    const int dn = min(DT, D - d0);
    __syncthreads();  // the query is in place; the previous tile is consumed
    for (int e = tid; e < CHUNK * DT; e += CHUNK) {
      const int r = e / DT, dd = e % DT;
      float v = 0.0f;
      if (dd < dn) {
        const long long off = (r0 + r) * D + d0 + dd;
        if (INT8) {
          const float s = scales[(r0 + r) * nb + (d0 + dd) / qblock];
          v = __fmul_rn((float)reinterpret_cast<const int8_t*>(recs)[off], s);
        } else {
          v = reinterpret_cast<const float*>(recs)[off];
        }
      }
      tile[dd * PITCH + r] = v;
    }
    __syncthreads();
    for (int dd = 0; dd < dn; ++dd)
      acc = __fadd_rn(acc, __fmul_rn(qs[d0 + dd], tile[dd * PITCH + tid]));
  }

  const long long pos = r0 + tid;
  const float my_s = pos < n ? acc : -INFINITY;
  const int my_i = (int)pos;
  float ls = INFINITY;
  int li = -1;
  const long long base = ((long long)qi * n_chunks + c) * k;
  for (int j = 0; j < k; ++j) {
    float s = -INFINITY;
    int i = INT_MAX;
    if (after(my_s, my_i, ls, li)) {
      s = my_s;
      i = my_i;
    }
    block_best(s, i, red_s, red_i);
    if (tid == 0) {
      part_s[base + j] = s;
      part_i[base + j] = i;
    }
    ls = s;
    li = i;
  }
}

__global__ void __launch_bounds__(CHUNK) topk_merge_kernel(
    const float* __restrict__ part_s, const int* __restrict__ part_i, int n_cand, int k,
    float* __restrict__ out_s, int* __restrict__ out_i) {
  __shared__ float red_s[33];
  __shared__ int red_i[33];
  const int qi = blockIdx.x, tid = threadIdx.x;
  const long long base = (long long)qi * n_cand;
  float ls = INFINITY;
  int li = -1;
  for (int j = 0; j < k; ++j) {
    float s = -INFINITY;
    int i = INT_MAX;
    for (int e = tid; e < n_cand; e += CHUNK) {
      const float cs = part_s[base + e];
      const int ci = part_i[base + e];
      if (after(cs, ci, ls, li) && better(cs, ci, s, i)) {
        s = cs;
        i = ci;
      }
    }
    block_best(s, i, red_s, red_i);
    if (tid == 0) {
      out_s[(long long)qi * k + j] = s;
      out_i[(long long)qi * k + j] = i;
    }
    ls = s;
    li = i;
  }
}

}  // namespace

// qm (Q, D) f32; recs (Np, D) f32, or int8 with scales (Np, nb) f32 and
// qblock = D / nb; Np % 256 == 0; 1 <= k <= 256. part_s/part_i are
// (Q, Np / 256, k) scratch; out_s/out_i (Q, k). Returns cudaGetLastError().
extern "C" int topk_cosine_launch(const float* qm, int Q, int D, const void* recs,
                                  int is_int8, const float* scales, int nb, long long Np,
                                  long long n, int k, float* part_s, int* part_i,
                                  float* out_s, int* out_i, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int n_chunks = (int)(Np / CHUNK);
  const size_t smem = (size_t)(D + DT * PITCH) * sizeof(float);
  const dim3 grid(n_chunks, Q);
  cudaError_t err = cudaSuccess;
  if (is_int8) {
    if (smem > 48 * 1024)
      err = cudaFuncSetAttribute(topk_chunk_kernel<true>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    topk_chunk_kernel<true><<<grid, CHUNK, smem, s>>>(qm, D, recs, scales, nb, D / nb, n, k,
                                                      n_chunks, part_s, part_i);
  } else {
    if (smem > 48 * 1024)
      err = cudaFuncSetAttribute(topk_chunk_kernel<false>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    topk_chunk_kernel<false><<<grid, CHUNK, smem, s>>>(qm, D, recs, scales, 1, 1, n, k,
                                                       n_chunks, part_s, part_i);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  topk_merge_kernel<<<Q, CHUNK, 0, s>>>(part_s, part_i, n_chunks * k, k, out_s, out_i);
  return (int)cudaGetLastError();
}

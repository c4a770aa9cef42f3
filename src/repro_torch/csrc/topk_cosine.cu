// Batched cosine top-k over a record slab, f32 or blockwise int8.
//
// Replaces the TPU kernel topk_similarity_2d of the JAX package's
// kernels/topk_similarity.py. That kernel carries a running top-k in its
// output refs across a sequential grid; here one launch does the whole
// selection, with nothing carried across launches:
//
//   Scores. A CTA of 256 threads scores a chunk of 256 records against one
//     query. The query sits in shared memory; the records are staged 64
//     dimensions at a time (32 for int8), transposed, into a shared tile
//     (row pitch 257: conflict-free on both the write and the read), the
//     next tile's loads in registers while this one is consumed (at D = 256
//     an f32 chunk takes 4 such round trips). Thread r accumulates record
//     r's dot product over d = 0..D-1 in that fixed order, every product
//     and sum explicitly rounded (__fmul_rn / __fadd_rn). int8 records are
//     dequantized with their block scale (q * s, rounded) first. Rows past
//     the live count n are not loaded, and score -inf.
//   Keys. (score, index) becomes one 64-bit key: the score's
//     order-preserving bits in the high word (-0.0 as +0.0, so the two tie
//     as in a stable sort), ~index in the low word. Descending key order is
//     then exactly the tie contract: score descending, equal scores by
//     ascending index. kernels/topk_similarity.py's sort_key states the same
//     encoding in Python (as a signed int64: this key minus 2^63), and the
//     CPU tests hold it against a stable sort. A score is never -0.0 (the
//     sum starts at +0.0, and +0.0 + -0.0 is +0.0), so decoding a key gives
//     back the score bit for bit.
//   Selection by sorting. The CTA sorts its 256 keys with a bitonic network,
//     one key a thread: strides under 32 exchange by __shfl_xor_sync with no
//     barrier, strides 32-128 through a double-buffered shared array (one
//     __syncthreads a step, 6 of the 36 steps). A CTA that scores more than
//     one chunk sorts each later chunk ascending and keeps the 256 best of
//     the two lists: max(best[i], new[i]) is bitonic and holds them, and a
//     bitonic merge (8 steps) sorts it.
//   Chunks of one query. The slab's chunks of one query are shared by the
//     CTAs of one thread block cluster (at most 8; each takes every 8th
//     chunk). After a cluster barrier, rank 0 merges the other ranks' sorted
//     lists out of their shared memory (distributed shared memory), in rank
//     order, and writes the k best. The key order is total, so the merge is
//     exact; no float atomics, no global scratch, and no ticket to reset.
//     Chunks wholly past both n and k are not read (their -inf entries rank
//     after every entry before them). The planner's slab (~40 live records
//     of 1,024) is one such chunk: a cluster of one, which writes its k
//     directly.
//
// The plain PyTorch version in kernels/topk_similarity.py accumulates the
// same products in the same order and selects with a stable sort, so
// scores and indices agree bit for bit.
//
// Bound: at the planner's shapes (Q = 20 queries, D = 256, ~40 live records
// of a 1,024-record slab, k = 32) the bytes are a few tens of KB and the
// operations a few hundred thousand: the kernel is bound by latency (the
// serial dot products, the load round trips and the sort's steps), so the
// design cuts serial steps: one launch, 36 sort steps in place of 2k
// block-wide argmax rounds.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

typedef unsigned long long u64;

constexpr int CHUNK = 256;  // records per CTA == threads per CTA
constexpr int PITCH = CHUNK + 1;
// dimensions per staged tile: 64 f32 (half the tiles' round trips), 32
// int8 (whose value and scale both wait in registers)
template <bool INT8> struct Tile { static constexpr int DT = INT8 ? 32 : 64; };
constexpr int ROWS = CHUNK / 32;  // rows a thread loads per tile, every ROWS-th
constexpr int MAX_CLUSTER = 8;    // the portable cluster size

__device__ __forceinline__ u64 make_key(float s, unsigned idx) {
  unsigned u = __float_as_uint(s == 0.0f ? 0.0f : s);  // -0.0 ties +0.0
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ((u64)u << 32) | (u64)(~idx);
}

__device__ __forceinline__ float key_score(u64 key) {
  const unsigned u = (unsigned)(key >> 32);
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7fffffffu) : ~u);
}

__device__ __forceinline__ int key_index(u64 key) { return (int)~(unsigned)key; }

// the key of thread threadIdx.x ^ stride
__device__ __forceinline__ u64 partner(u64 key, int stride, u64* buf, int& par) {
  if (stride < 32) return __shfl_xor_sync(0xffffffffu, key, stride);
  // double buffer: a half is written again only two exchanges later, past
  // the barrier of the exchange in between, so one barrier a step suffices
  u64* b = buf + par * CHUNK;
  par ^= 1;
  b[threadIdx.x] = key;
  __syncthreads();
  return b[threadIdx.x ^ stride];
}

__device__ __forceinline__ u64 keep(u64 key, u64 other, bool keep_max) {
  return keep_max ? (key > other ? key : other) : (key < other ? key : other);
}

// bitonic sort of the CTA's 256 keys, one a thread, descending or ascending
template <bool DESC>
__device__ __forceinline__ u64 sort256(u64 key, u64* buf, int& par) {
  const int t = threadIdx.x;
#pragma unroll
  for (int size = 2; size <= CHUNK; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      const u64 other = partner(key, stride, buf, par);
      const bool lower = (t & stride) == 0, up = (t & size) == 0;
      key = keep(key, other, (lower == up) == DESC);
    }
  }
  return key;
}

// a bitonic sequence of 256 keys, sorted descending
__device__ __forceinline__ u64 merge256(u64 key, u64* buf, int& par) {
  const int t = threadIdx.x;
#pragma unroll
  for (int stride = CHUNK >> 1; stride > 0; stride >>= 1) {
    const u64 other = partner(key, stride, buf, par);
    key = keep(key, other, (t & stride) == 0);
  }
  return key;
}

// thread (rw, lane) loads dimensions d0 + lane + 32 j of rows rw + ROWS * i
// of the chunk (element i + 32 j) into registers: the f32 value in a, or the
// int8 value in b and its block scale in a (rows past the live count load
// nothing)
template <bool INT8, int DT = Tile<INT8>::DT>
__device__ __forceinline__ void load_tile(float (&a)[DT], int (&b)[DT], int d0, int D,
                                          const void* __restrict__ recs,
                                          const float* __restrict__ scales, int nb, int qblock,
                                          long long live, long long r0) {
  const int lane = threadIdx.x & 31, rw = threadIdx.x >> 5;
#pragma unroll
  for (int e = 0; e < DT; ++e) {
    const int r = rw + ROWS * (e % 32), d = d0 + lane + 32 * (e / 32);
    a[e] = 0.0f;
    b[e] = 0;
    if (r < live && d < D) {
      const long long off = (r0 + r) * D + d;
      if constexpr (INT8) {
        b[e] = reinterpret_cast<const int8_t*>(recs)[off];
        a[e] = scales[(r0 + r) * nb + d / qblock];
      } else {
        a[e] = reinterpret_cast<const float*>(recs)[off];
      }
    }
  }
}

// thread r's score of record r0 + r (-inf past the live count)
template <bool INT8>
__device__ __forceinline__ float score_chunk(const float* qs, float* tile, int D,
                                           const void* __restrict__ recs,
                                           const float* __restrict__ scales, int nb,
                                           int qblock, long long n, long long r0) {
  constexpr int DT = Tile<INT8>::DT;
  const int tid = threadIdx.x, lane = tid & 31, rw = tid >> 5;
  const long long live = n - r0;  // > 0 here
  float a[DT];
  int b[DT];
  load_tile<INT8>(a, b, 0, D, recs, scales, nb, qblock, live, r0);
  float acc = 0.0f;
  for (int d0 = 0; d0 < D; d0 += DT) {
    const int dn = min(DT, D - d0);
    __syncthreads();  // the query is in place; the previous tile is consumed
#pragma unroll
    for (int e = 0; e < DT; ++e)
      tile[(lane + 32 * (e / 32)) * PITCH + rw + ROWS * (e % 32)] =
          INT8 ? __fmul_rn((float)b[e], a[e]) : a[e];
    __syncthreads();
    // the next tile's loads, in flight while this one is consumed
    if (d0 + DT < D) load_tile<INT8>(a, b, d0 + DT, D, recs, scales, nb, qblock, live, r0);
    if (dn == DT) {
      // unrolled, so the shared loads and products run ahead of the chain
      // of sums (at 8 warps an SM nothing else hides their latency)
#pragma unroll
      for (int dd = 0; dd < DT; ++dd)
        acc = __fadd_rn(acc, __fmul_rn(qs[d0 + dd], tile[dd * PITCH + tid]));
    } else {
      for (int dd = 0; dd < dn; ++dd)
        acc = __fadd_rn(acc, __fmul_rn(qs[d0 + dd], tile[dd * PITCH + tid]));
    }
  }
  return tid < live ? acc : -INFINITY;
}

template <bool INT8>
__global__ void __launch_bounds__(CHUNK) topk_kernel(
    const float* __restrict__ qm, int D, const void* __restrict__ recs,
    const float* __restrict__ scales, int nb, int qblock, long long n, int k, int n_chunks,
    float* __restrict__ out_s, int* __restrict__ out_i) {
  extern __shared__ float smem[];
  float* qs = smem;      // (D,)
  float* tile = qs + D;  // (Tile<INT8>::DT, PITCH)
  __shared__ u64 buf[2 * CHUNK];
  __shared__ u64 best[CHUNK];

  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks();  // the cluster spans the grid's x
  const int rank = (int)cluster.block_rank();
  const int qi = blockIdx.y, tid = threadIdx.x;
  for (int d = tid; d < D; d += CHUNK) qs[d] = qm[(long long)qi * D + d];

  int par = 0;
  u64 run = 0;
  for (int c = rank; c < n_chunks; c += cs) {
    const long long r0 = (long long)c * CHUNK;
    // a chunk past the live count scores -inf without loading anything
    const float s = r0 < n ? score_chunk<INT8>(qs, tile, D, recs, scales, nb, qblock, n, r0)
                           : -INFINITY;
    const u64 key = make_key(s, (unsigned)(r0 + tid));
    if (c == rank)
      run = sort256<true>(key, buf, par);
    else
      run = merge256(keep(run, sort256<false>(key, buf, par), true), buf, par);
  }
  if (cs > 1) {
    best[tid] = run;
    cluster.sync();
    if (rank == 0) {
      for (int r = 1; r < cs; ++r) {
        const u64* other = cluster.map_shared_rank(best, r);
        run = merge256(keep(run, other[CHUNK - 1 - tid], true), buf, par);
      }
    }
    cluster.sync();  // every list stays in place until rank 0 has read it
  }
  if (rank == 0 && tid < k) {
    out_s[(long long)qi * k + tid] = key_score(run);
    out_i[(long long)qi * k + tid] = key_index(run);
  }
}

template <bool INT8>
cudaError_t launch(cudaLaunchConfig_t* cfg, const float* qm, int D, const void* recs,
                   const float* scales, int nb, int qblock, long long n, int k, int n_chunks,
                   float* out_s, int* out_i) {
  cfg->dynamicSmemBytes = (size_t)(D + Tile<INT8>::DT * PITCH) * sizeof(float);
  // past 48 KB the kernel needs a larger dynamic shared memory limit, set
  // once for each device and size
  static int set_bytes[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (cfg->dynamicSmemBytes > 48 * 1024 &&
      (dev >= 64 || set_bytes[dev] < (int)cfg->dynamicSmemBytes)) {
    err = cudaFuncSetAttribute(topk_kernel<INT8>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)cfg->dynamicSmemBytes);
    if (err != cudaSuccess) return err;
    if (dev < 64) set_bytes[dev] = (int)cfg->dynamicSmemBytes;
  }
  return cudaLaunchKernelEx(cfg, topk_kernel<INT8>, qm, D, recs, scales, nb, qblock, n, k,
                            n_chunks, out_s, out_i);
}

}  // namespace

// qm (Q, D) f32; recs (Np, D) f32, or int8 with scales (Np, nb) f32 and
// qblock = D / nb; Np % 256 == 0; 1 <= k <= 256. out_s/out_i (Q, k). One
// launch: grid (min(chunks, 8), Q), one cluster of that many CTAs a query,
// over the chunks that hold a position under max(n, k). Returns the
// launch's error, or cudaGetLastError().
extern "C" int topk_cosine_launch(const float* qm, int Q, int D, const void* recs,
                                  int is_int8, const float* scales, int nb, long long Np,
                                  long long n, int k, float* out_s, int* out_i, void* stream) {
  // chunks past both n and k hold only -inf entries that rank after every
  // entry of the chunks before them: they are not read
  const long long used = (n > k ? n : k) + CHUNK - 1;
  const int n_chunks = (int)(used / CHUNK < Np / CHUNK ? used / CHUNK : Np / CHUNK);
  const int cs = n_chunks < MAX_CLUSTER ? n_chunks : MAX_CLUSTER;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cs, Q);
  cfg.blockDim = dim3(CHUNK);
  cfg.stream = reinterpret_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err =
      is_int8 ? launch<true>(&cfg, qm, D, recs, scales, nb, D / nb, n, k, n_chunks, out_s, out_i)
              : launch<false>(&cfg, qm, D, recs, scales, 1, 1, n, k, n_chunks, out_s, out_i);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

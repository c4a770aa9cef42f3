// In-pass stochastic quantize -> dequantize -> weighted superpose of f32
// client rows, plus the sum of squares of the aggregate.
//
// Replaces the TPU kernel ota_fused_2d (_fused_kernel) of the JAX package's
// kernels/ota_fused.py. Per output column m, with k = 0..K-1 in order:
//
//   u   = sr_dither(seed, k0 + k, m)           (murmur3 finalizer, uint32)
//   sc  = x[k, m] / s_k
//   fl  = floor(sc)
//   q   = clamp(fl + (u < sc - fl), -qmax_k, qmax_k)
//   dq  = qmax_k > 0 ? q * s_k : x[k, m]       (qmax_k == 0: f32 passthrough)
//   acc = acc + dq * w_k                       (acc starts at acc_in, or 0)
//
// and sumsq = sum_m acc[m]^2.
//
// One launch takes at most MAX_K rows (their s_k, qmax_k and w_k sit in
// shared memory). A larger cohort runs as passes over consecutive chunks of
// rows: k0 is the global index of a chunk's first row (the dither follows
// the global row), and each pass starts from the previous pass's acc
// (acc_in) and continues the same per-column sum in k order, so the chunked
// passes give the one-pass acc bit for bit. Only the last pass asks for
// sumsq (partials and sumsq non-null).
//
// Design. Every column is independent: each thread owns a run of 4
// consecutive columns (one 16-byte float4 load of every row), loops k in
// ascending order, and keeps s_k, qmax_k and w_k in shared memory. Every
// float op is explicitly rounded (__fdiv_rn, __fadd_rn, __fsub_rn,
// __fmul_rn: IEEE division, no FMA contraction) in the order the plain
// PyTorch version in kernels/ota_fused.py uses, so acc equals it bit for
// bit. The dither is pure uint32 arithmetic with wraparound; its top 24
// bits times 2^-24 are exact in f32.
//
// The TPU kernel carries sumsq across its sequential grid. Blocks here run
// in parallel in no order, so the sum is taken in two passes with no float
// atomics, in one fixed order: each block reduces its threads' partial
// sums (each thread its 4 columns in order, then warp shuffles, then the
// warps in index order) into partials[block]; a second, single-block
// launch sums the partials (thread t takes t, t + 256, ... in order, then
// the same shuffle and warp-order reduction). The result is the same bit
// for bit from one launch to the next.
//
// Bound: memory. One pass reads 4 K M bytes of rows (and 4 M of acc_in)
// and writes 4 M bytes of aggregate; the dither (about 10 integer ops),
// the division and the rest (about 11 more ops) per element stay below
// that at 67 TFLOP/s.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int RUN = 4;        // columns per thread
constexpr int THREADS = 256;  // threads per block
constexpr int MAX_K = 4000;   // 3 * 4 * MAX_K bytes of dynamic shared memory (< 48 KB)
constexpr uint32_t GOLDEN = 0x9E3779B9u;

__device__ __forceinline__ float sr_dither(uint32_t row_key, uint32_t pos) {
  uint32_t h = pos ^ row_key;
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return (float)(h >> 8) * (1.0f / 16777216.0f);
}

__device__ __forceinline__ float quantize_one(float x, float s, float qmax, float u) {
  const float sc = __fdiv_rn(x, s);
  const float fl = floorf(sc);
  float q = __fadd_rn(fl, (u < __fsub_rn(sc, fl)) ? 1.0f : 0.0f);
  q = fminf(fmaxf(q, -qmax), qmax);
  return qmax > 0.0f ? __fmul_rn(q, s) : x;
}

// the sum over a block of one float per thread, in a fixed order
__device__ __forceinline__ float block_sum(float v, float* warp_sums) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = __fadd_rn(v, __shfl_down_sync(0xFFFFFFFFu, v, off));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  float total = 0.0f;
  if (threadIdx.x == 0) {
    for (int i = 0; i < THREADS / 32; ++i) total = __fadd_rn(total, warp_sums[i]);
  }
  return total;
}

__global__ void __launch_bounds__(THREADS) quantize_superpose_kernel(
    const float* __restrict__ x, int K, long long M, int k0, const float* __restrict__ scale,
    const float* __restrict__ qmax, const float* __restrict__ w, uint32_t seed,
    const float* __restrict__ acc_in, float* __restrict__ out, float* __restrict__ partials,
    int aligned) {
  extern __shared__ float params[];  // s[K], qmax[K], w[K]
  __shared__ float warp_sums[THREADS / 32];
  float* s_s = params;
  float* s_q = params + K;
  float* s_w = params + 2 * K;
  for (int k = threadIdx.x; k < K; k += THREADS) {
    s_s[k] = scale[k];
    s_q[k] = qmax[k];
    s_w[k] = w[k];
  }
  __syncthreads();

  const long long t = (long long)blockIdx.x * THREADS + threadIdx.x;
  const long long m0 = t * RUN;
  const int n = m0 >= M ? 0 : ((M - m0) < RUN ? (int)(M - m0) : RUN);
  const bool full = aligned && n == RUN;

  float acc[RUN];
#pragma unroll
  for (int j = 0; j < RUN; ++j) acc[j] = 0.0f;

  if (n > 0) {
    if (acc_in != nullptr) {
      if (full) {
        const float4 a4 = *reinterpret_cast<const float4*>(acc_in + m0);
        acc[0] = a4.x;
        acc[1] = a4.y;
        acc[2] = a4.z;
        acc[3] = a4.w;
      } else {
#pragma unroll
        for (int j = 0; j < RUN; ++j)
          if (j < n) acc[j] = acc_in[m0 + j];
      }
    }
    for (int k = 0; k < K; ++k) {
      const float* row = x + (long long)k * M;
      const float s = s_s[k], qm = s_q[k], wk = s_w[k];
      const uint32_t row_key = seed + GOLDEN * (uint32_t)(k0 + k);
      float v[RUN];
      if (full) {
        const float4 x4 = *reinterpret_cast<const float4*>(row + m0);
        v[0] = x4.x;
        v[1] = x4.y;
        v[2] = x4.z;
        v[3] = x4.w;
      } else {
#pragma unroll
        for (int j = 0; j < RUN; ++j) v[j] = j < n ? row[m0 + j] : 0.0f;
      }
#pragma unroll
      for (int j = 0; j < RUN; ++j) {
        const float u = sr_dither(row_key, (uint32_t)(m0 + j));
        acc[j] = __fadd_rn(acc[j], __fmul_rn(quantize_one(v[j], s, qm, u), wk));
      }
    }
    if (full) {
      *reinterpret_cast<float4*>(out + m0) = make_float4(acc[0], acc[1], acc[2], acc[3]);
    } else {
#pragma unroll
      for (int j = 0; j < RUN; ++j)
        if (j < n) out[m0 + j] = acc[j];
    }
  }

  if (partials == nullptr) return;  // not the last pass: no sumsq (uniform per launch)
  // columns past M hold acc = 0 and add nothing
  float sq = 0.0f;
#pragma unroll
  for (int j = 0; j < RUN; ++j) sq = __fadd_rn(sq, __fmul_rn(acc[j], acc[j]));
  const float total = block_sum(sq, warp_sums);
  if (threadIdx.x == 0) partials[blockIdx.x] = total;
}

__global__ void __launch_bounds__(THREADS) sum_partials_kernel(
    const float* __restrict__ partials, int n, float* __restrict__ sumsq) {
  __shared__ float warp_sums[THREADS / 32];
  float v = 0.0f;
  for (int i = threadIdx.x; i < n; i += THREADS) v = __fadd_rn(v, partials[i]);
  const float total = block_sum(v, warp_sums);
  if (threadIdx.x == 0) sumsq[0] = total;
}

}  // namespace

// x: (K, M) f32 rows, rows k0 .. k0 + K - 1 of the cohort; scale, qmax, w:
// (K,) f32; seed: the uint32 dither seed. acc_in: (M,) f32 the previous
// pass's aggregate, or null to start at 0. out: (M,) f32. partials:
// (n_blocks,) f32 scratch with n_blocks = ceil(ceil(M / 4) / 256) and
// sumsq: one f32, both non-null to reduce the sum of squares of out, both
// null to skip it. aligned != 0 promises 16-byte aligned x, acc_in, out and
// M % 4 == 0. One or two launches on ``stream``; returns cudaGetLastError()
// after them.
extern "C" int ota_quantize_superpose_launch(const float* x, int K, long long M, int k0,
                                             const float* scale, const float* qmax,
                                             const float* w, unsigned int seed,
                                             const float* acc_in, float* out, float* partials,
                                             long long n_blocks, float* sumsq, int aligned,
                                             void* stream) {
  const long long threads = (M + RUN - 1) / RUN;
  const long long blocks = (threads + THREADS - 1) / THREADS;
  if (K < 1 || K > MAX_K || k0 < 0 || M < 1 || blocks > 0x7FFFFFFFLL ||
      (partials == nullptr) != (sumsq == nullptr) || (partials != nullptr && blocks != n_blocks))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const size_t smem = (size_t)3 * K * sizeof(float);
  quantize_superpose_kernel<<<(unsigned)blocks, THREADS, smem, s>>>(
      x, K, M, k0, scale, qmax, w, (uint32_t)seed, acc_in, out, partials, aligned);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || sumsq == nullptr) return (int)err;
  sum_partials_kernel<<<1, THREADS, 0, s>>>(partials, (int)blocks, sumsq);
  return (int)cudaGetLastError();
}

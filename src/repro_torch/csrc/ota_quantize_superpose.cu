// In-pass stochastic quantize -> dequantize -> weighted superpose of f32
// client rows, plus the sum of squares of the aggregate.
//
// Replaces the TPU kernel ota_fused_2d (_fused_kernel) of the JAX package's
// kernels/ota_fused.py (src/repro/kernels/ota_fused.py:379). Per output
// column m, with k = 0..K-1 in order:
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
// One launch takes at most MAX_K rows. A larger cohort runs as passes over
// consecutive chunks of rows: k0 is the global index of a chunk's first row
// (the dither follows the global row), and each pass starts from the
// previous pass's acc (acc_in) and continues the same per-column sum in k
// order, so the chunked passes give the one-pass acc bit for bit. Only the
// last pass asks for sumsq (partials, done and sumsq non-null).
//
// Every float op is explicitly rounded (__fdiv_rn, __fadd_rn, __fsub_rn,
// __fmul_rn: IEEE division, no FMA contraction) in the order the plain
// PyTorch version in kernels/ota_fused.py uses, so acc equals it bit for
// bit. The dither is uint32 arithmetic with wraparound.
//
// What bounds it on the H100, both counted (chip_smoke.qs_bounds). Bytes:
// one pass reads 4 K M bytes of rows and writes 4 M (2.50 ms at K = 8,000,
// M = 262,144, at 3.35 TB/s). Operations: a quantized element needs 10
// integer ops (the dither), one int-to-float conversion and 11 f32 ops
// (the quantizer and the weighted add), a passthrough element (qmax == 0)
// 2 f32 ops; each takes one of the 128 issue slots an SM has a clock, so
// that case needs about 1.2 ms of issue, under the bytes. The built loop
// issues more than one instruction for some of them (the IEEE division
// about 10, for the parity contract), which brings it nearer the bytes.
//
// Design. Every column is independent and its sum runs in k order, so the
// only parallelism is the columns. Two kernels, which the caller chooses
// from M (kernels/ota_fused.py):
//   - wide_kernel (M >= 2^20; the flat path, K = 20 at M = 4.1 million):
//     the grid fills the card many times over, so residency hides the
//     loads' latency, and registers set it. Each thread owns 4 consecutive
//     columns (one 16-byte load a row), one row at a time, with s, qmax
//     and w of every row of the launch in shared memory: 32 registers, 8
//     blocks an SM at K = 20.
//   - narrow_kernel (M < 2^20; K = 8,000 at M = 262,144): the wide layout
//     has 256 blocks there, about 16 warps an SM with one load in flight
//     each (5.8 ms at K = 8,000). Each thread owns 2 consecutive columns
//     (8-byte loads), so the grid has twice the warps, and the rows go in
//     groups of U = 4 whose next group's loads are issued (into a second
//     register buffer, ping-pong) before this group's arithmetic: up to 8
//     loads in flight a thread. s, qmax, w and the dither's row key sit in
//     shared memory for a chunk of CHUNK rows at a time (4 KB, one 16-byte
//     read a row); a row with qmax == 0 (a 32-bit passthrough row) skips
//     the dither and the quantizer by a branch that is uniform across the
//     block; a block whose columns are all whole and aligned (every block
//     but the last, when the rows are aligned) runs a loop of vector loads
//     with row pointers stepped by M, the last block the same loop with
//     element loads.
// Measured and not taken (PERF.md section 6): building the dither's float
// and the floor from bits (exact, but more instructions than the
// conversions they replace, 4% slower); 8 rows a group and 1 column a
// thread in the narrow layout; the narrow layout, or the wide one with
// chunked parameters, loads in flight or launch bounds, at large M (3-23%
// slower there); the sum of the partials in the main launch (its last
// block found by an atomic ticket: 16 more registers in the wide layout,
// 4-8% slower there, no faster in the narrow one).
//
// The sum of squares is taken without float atomics in one fixed order:
// each block reduces its threads' partial sums (each thread its columns in
// order, then warp shuffles, then the warps in index order) into
// partials[block]; a second, single-block launch sums the partials in
// index order (thread t takes t, t + 256, ... in order, SUM_LOADS loads in
// flight, then the same shuffle and warp-order reduction). The result is
// the same bit for bit from one launch to the next.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;  // threads per block
constexpr int MAX_K = 4000;   // rows per launch (wide: 12 MAX_K bytes of shared memory, < 48 KB)
constexpr int WIDE_RUN = 4;   // columns a thread, wide layout
constexpr int RUN = 2;        // columns a thread, narrow layout
constexpr int U = 4;          // rows a group of loads, narrow layout
constexpr int CHUNK = 256;    // narrow: rows whose parameters sit in shared memory (a multiple of 2 U)
constexpr int SUM_LOADS = 16; // partials a thread of the sum launch loads at once
constexpr uint32_t GOLDEN = 0x9E3779B9u;

// murmur3's finalizer of pos ^ row_key; its top 24 bits times 2^-24 are
// exact in f32
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

// the sum over a block of one float per thread, in a fixed order (valid in
// thread 0)
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

__global__ void __launch_bounds__(THREADS) wide_kernel(
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

  const long long m0 = ((long long)blockIdx.x * THREADS + threadIdx.x) * WIDE_RUN;
  const int n = m0 >= M ? 0 : ((M - m0) < WIDE_RUN ? (int)(M - m0) : WIDE_RUN);
  const bool full = aligned && n == WIDE_RUN;

  float acc[WIDE_RUN];
#pragma unroll
  for (int j = 0; j < WIDE_RUN; ++j) acc[j] = 0.0f;

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
        for (int j = 0; j < WIDE_RUN; ++j)
          if (j < n) acc[j] = acc_in[m0 + j];
      }
    }
    for (int k = 0; k < K; ++k) {
      const float* row = x + (long long)k * M;
      const float s = s_s[k], qm = s_q[k], wk = s_w[k];
      const uint32_t row_key = seed + GOLDEN * (uint32_t)(k0 + k);
      float v[WIDE_RUN];
      if (full) {
        const float4 x4 = *reinterpret_cast<const float4*>(row + m0);
        v[0] = x4.x;
        v[1] = x4.y;
        v[2] = x4.z;
        v[3] = x4.w;
      } else {
#pragma unroll
        for (int j = 0; j < WIDE_RUN; ++j) v[j] = j < n ? row[m0 + j] : 0.0f;
      }
#pragma unroll
      for (int j = 0; j < WIDE_RUN; ++j) {
        const float u = sr_dither(row_key, (uint32_t)(m0 + j));
        acc[j] = __fadd_rn(acc[j], __fmul_rn(quantize_one(v[j], s, qm, u), wk));
      }
    }
    if (full) {
      *reinterpret_cast<float4*>(out + m0) = make_float4(acc[0], acc[1], acc[2], acc[3]);
    } else {
#pragma unroll
      for (int j = 0; j < WIDE_RUN; ++j)
        if (j < n) out[m0 + j] = acc[j];
    }
  }

  if (partials == nullptr) return;  // not the last pass: no sumsq (uniform per launch)
  // columns past M hold acc = 0 and add nothing
  float sq = 0.0f;
#pragma unroll
  for (int j = 0; j < WIDE_RUN; ++j) sq = __fadd_rn(sq, __fmul_rn(acc[j], acc[j]));
  const float total = block_sum(sq, warp_sums);
  if (threadIdx.x == 0) partials[blockIdx.x] = total;
}

struct Run {
  float v[RUN];
};

// a thread's RUN columns of one row: one vector load (FULL), or element
// loads at a ragged or unaligned edge (zeros past the row's end)
template <bool FULL>
__device__ __forceinline__ Run load_run(const float* p, int n) {
  Run r;
  if (FULL) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    r.v[0] = t.x;
    r.v[1] = t.y;
  } else {
#pragma unroll
    for (int j = 0; j < RUN; ++j) r.v[j] = j < n ? p[j] : 0.0f;
  }
  return r;
}

// fold one row (its parameters prm = {s, qmax, w, row key}) into the
// thread's running sums
__device__ __forceinline__ void fold_row(float (&acc)[RUN], const Run& x,
                                         const uint32_t (&pos)[RUN], const float4 prm) {
  const float s = prm.x, qm = prm.y, wk = prm.z;
  if (qm > 0.0f) {  // the row's grid: uniform across the block
    const uint32_t row_key = __float_as_uint(prm.w);
#pragma unroll
    for (int j = 0; j < RUN; ++j)
      acc[j] = __fadd_rn(acc[j], __fmul_rn(quantize_one(x.v[j], s, qm, sr_dither(row_key, pos[j])),
                                           wk));
  } else {
#pragma unroll
    for (int j = 0; j < RUN; ++j) acc[j] = __fadd_rn(acc[j], __fmul_rn(x.v[j], wk));
  }
}

// rows 0 .. K - 1 into acc, in groups of U rows with the next group's loads
// in flight (ping-pong), their parameters a chunk of CHUNK rows at a time
// in prm. FULL (uniform across the block): every thread's RUN columns are
// whole and aligned.
template <bool FULL>
__device__ __forceinline__ void walk_rows(float (&acc)[RUN], const uint32_t (&pos)[RUN],
                                          const float* col, int n, long long M, int K, int k0,
                                          const float* __restrict__ scale,
                                          const float* __restrict__ qmax,
                                          const float* __restrict__ w, uint32_t seed,
                                          float4* prm) {
  // rows g .. g + cnt - 1 (cnt <= U, uniform) into buf
  auto load = [&](Run (&buf)[U], int g, int cnt) {
    const float* p = col + (long long)g * M;
#pragma unroll
    for (int r = 0; r < U; ++r) {
      if (r < cnt) buf[r] = load_run<FULL>(p, n);
      p += M;
    }
  };
  // the same rows, their parameters at prm[i ...]
  auto fold = [&](const Run (&buf)[U], int i, int cnt) {
#pragma unroll
    for (int r = 0; r < U; ++r)
      if (r < cnt) fold_row(acc, buf[r], pos, prm[i + r]);
  };

  Run buf_a[U], buf_b[U];
  load(buf_a, 0, min(U, K));
  int g = 0;  // the first row of the group in buf_a
  for (int c0 = 0; c0 < K; c0 += CHUNK) {
    const int c1 = min(c0 + CHUNK, K);
    __syncthreads();  // the last chunk's parameters are no longer read
    for (int i = threadIdx.x; i < c1 - c0; i += THREADS)
      prm[i] = make_float4(scale[c0 + i], qmax[c0 + i], w[c0 + i],
                           __uint_as_float(seed + GOLDEN * (uint32_t)(k0 + c0 + i)));
    __syncthreads();
    // pairs of groups; CHUNK is a multiple of 2 U, so no pair straddles
    // two chunks
#pragma unroll 1
    for (; g < c1; g += 2 * U) {
      const int gb = g + U;
      if (gb < K) load(buf_b, gb, min(U, K - gb));
      fold(buf_a, g - c0, min(U, K - g));
      if (gb >= K) break;
      if (gb + U < K) load(buf_a, gb + U, min(U, K - gb - U));
      fold(buf_b, gb - c0, min(U, K - gb));
    }
  }
}

__global__ void __launch_bounds__(THREADS) narrow_kernel(
    const float* __restrict__ x, int K, long long M, int k0, const float* __restrict__ scale,
    const float* __restrict__ qmax, const float* __restrict__ w, uint32_t seed,
    const float* __restrict__ acc_in, float* __restrict__ out, float* __restrict__ partials,
    int aligned) {
  static_assert(CHUNK % (2 * U) == 0, "no pair of groups straddles two chunks");
  __shared__ float4 prm[CHUNK];  // {s, qmax, w, row key} of rows c0 .. c0 + CHUNK - 1
  __shared__ float warp_sums[THREADS / 32];

  const long long m0 = ((long long)blockIdx.x * THREADS + threadIdx.x) * RUN;
  const int n = m0 >= M ? 0 : ((M - m0) < RUN ? (int)(M - m0) : RUN);
  const bool full = aligned && n == RUN;
  const bool block_full = aligned && ((long long)blockIdx.x + 1) * THREADS * RUN <= M;
  const long long base = n > 0 ? m0 : 0;  // threads past M load nothing
  uint32_t pos[RUN];
#pragma unroll
  for (int j = 0; j < RUN; ++j) pos[j] = (uint32_t)(m0 + j);

  float acc[RUN];
#pragma unroll
  for (int j = 0; j < RUN; ++j) acc[j] = 0.0f;
  if (acc_in != nullptr) {
    const Run a = full ? load_run<true>(acc_in + base, n) : load_run<false>(acc_in + base, n);
#pragma unroll
    for (int j = 0; j < RUN; ++j) acc[j] = a.v[j];
  }
  if (block_full)
    walk_rows<true>(acc, pos, x + base, n, M, K, k0, scale, qmax, w, seed, prm);
  else
    walk_rows<false>(acc, pos, x + base, n, M, K, k0, scale, qmax, w, seed, prm);

#pragma unroll
  for (int j = 0; j < RUN; ++j)
    if (j < n) out[m0 + j] = acc[j];

  if (partials == nullptr) return;  // not the last pass: no sumsq (uniform per launch)
  float sq = 0.0f;
#pragma unroll
  for (int j = 0; j < RUN; ++j)
    if (j < n) sq = __fadd_rn(sq, __fmul_rn(acc[j], acc[j]));
  const float total = block_sum(sq, warp_sums);
  if (threadIdx.x == 0) partials[blockIdx.x] = total;
}

__global__ void __launch_bounds__(THREADS) sum_partials_kernel(
    const float* __restrict__ partials, unsigned n, float* __restrict__ sumsq) {
  __shared__ float warp_sums[THREADS / 32];
  // thread t adds partials t, t + THREADS, ... in order; SUM_LOADS of them
  // are loaded at once (a zero past the end adds nothing to a sum of
  // squares)
  float v = 0.0f;
  for (unsigned i0 = threadIdx.x; i0 < n; i0 += SUM_LOADS * THREADS) {
    float p[SUM_LOADS];
#pragma unroll
    for (int u = 0; u < SUM_LOADS; ++u) {
      const unsigned i = i0 + u * THREADS;
      p[u] = i < n ? partials[i] : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < SUM_LOADS; ++u) v = __fadd_rn(v, p[u]);
  }
  const float total = block_sum(v, warp_sums);
  if (threadIdx.x == 0) sumsq[0] = total;
}

}  // namespace

// x: (K, M) f32 rows, rows k0 .. k0 + K - 1 of the cohort; scale, qmax, w:
// (K,) f32; seed: the uint32 dither seed. acc_in: (M,) f32 the previous
// pass's aggregate, or null to start at 0. out: (M,) f32. partials:
// (n_blocks,) f32 scratch with n_blocks = ceil(ceil(M / run) / 256), run 4
// with wide != 0 and 2 without, and sumsq: one f32, both non-null to
// reduce the sum of squares of out, both null to skip it. aligned != 0
// promises 16-byte aligned x, acc_in, out and M % 4 == 0. wide != 0 takes
// the wide kernel (the caller's choice by M). One or two launches on
// ``stream``; returns cudaGetLastError() after them.
extern "C" int ota_quantize_superpose_launch(const float* x, int K, long long M, int k0,
                                             const float* scale, const float* qmax,
                                             const float* w, unsigned int seed,
                                             const float* acc_in, float* out, float* partials,
                                             long long n_blocks, float* sumsq, int aligned,
                                             int wide, void* stream) {
  const int run = wide ? WIDE_RUN : RUN;
  const long long blocks = ((M + run - 1) / run + THREADS - 1) / THREADS;
  if (K < 1 || K > MAX_K || k0 < 0 || M < 1 || blocks > 0x7FFFFFFFLL ||
      (partials == nullptr) != (sumsq == nullptr) || (partials != nullptr && blocks != n_blocks))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (wide)
    wide_kernel<<<(unsigned)blocks, THREADS, (size_t)3 * K * sizeof(float), s>>>(
        x, K, M, k0, scale, qmax, w, (uint32_t)seed, acc_in, out, partials, aligned);
  else
    narrow_kernel<<<(unsigned)blocks, THREADS, 0, s>>>(
        x, K, M, k0, scale, qmax, w, (uint32_t)seed, acc_in, out, partials, aligned);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || sumsq == nullptr) return (int)err;
  sum_partials_kernel<<<1, THREADS, 0, s>>>(partials, (unsigned)blocks, sumsq);
  return (int)cudaGetLastError();
}

// Blocks of the narrow (wide == 0) or wide kernel an SM holds at once at K
// rows a launch (what registers and shared memory allow), or -1 on error.
extern "C" int ota_quantize_superpose_blocks_per_sm(int wide, int K) {
  int blocks = 0;
  const cudaError_t err =
      wide ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, wide_kernel, THREADS,
                                                           (size_t)3 * K * sizeof(float))
           : cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, narrow_kernel, THREADS, 0);
  return err == cudaSuccess ? blocks : -1;
}

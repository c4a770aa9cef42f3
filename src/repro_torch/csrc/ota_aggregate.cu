// Weighted superposition of K f32 client rows plus scaled receiver noise:
//
//   y[m] = sum_k w_k * x[k, m] + std * noise[m]
//
// Replaces the TPU kernel ota_aggregate_2d (_ota_kernel) of the JAX
// package's kernels/ota_aggregate.py (reached through ops.ota_aggregate).
// That kernel keeps the K rows of a 2,048-column block in VMEM and reduces
// them with jnp.sum, in an order XLA chooses. Here every column is
// independent: each thread owns 4 consecutive columns (one 16-byte load of
// every row, neighbouring threads on neighbouring addresses), runs k =
// 0..K-1 in order and adds the noise last:
//
//   acc = 0;  acc = acc + x[k, m] * w_k  (k = 0..K-1);  y = acc + std * noise[m]
//
// each op rounded on its own (__fmul_rn, __fadd_rn: no FMA contraction), so
// the plain PyTorch version in kernels/ota_aggregate.py, which does the same
// ops in the same order, agrees bit for bit. A ragged M or unaligned rows
// take the same arithmetic element by element.
//
// Bound: memory. One call reads 4 K M bytes of rows and 4 M of noise and
// writes 4 M; 2 K + 2 float ops per column are far below the f32 rate.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int RUN = 4;        // columns per thread
constexpr int THREADS = 256;  // threads per block

__global__ void __launch_bounds__(THREADS)
    ota_aggregate_kernel(const float* __restrict__ x, int K, long long M,
                         const float* __restrict__ w, const float* __restrict__ noise,
                         const float* __restrict__ std_p, float std_value, float* __restrict__ out,
                         int aligned) {
  const long long m0 = ((long long)blockIdx.x * THREADS + threadIdx.x) * RUN;
  if (m0 >= M) return;
  const int n = (M - m0) < RUN ? (int)(M - m0) : RUN;
  const bool full = aligned && n == RUN;

  float acc[RUN];
#pragma unroll
  for (int j = 0; j < RUN; ++j) acc[j] = 0.0f;
  for (int k = 0; k < K; ++k) {
    const float* row = x + (long long)k * M + m0;
    const float wk = __ldg(w + k);
    float v[RUN];
    if (full) {
      const float4 x4 = *reinterpret_cast<const float4*>(row);
      v[0] = x4.x;
      v[1] = x4.y;
      v[2] = x4.z;
      v[3] = x4.w;
    } else {
#pragma unroll
      for (int j = 0; j < RUN; ++j) v[j] = j < n ? row[j] : 0.0f;
    }
#pragma unroll
    for (int j = 0; j < RUN; ++j) acc[j] = __fadd_rn(acc[j], __fmul_rn(v[j], wk));
  }
  const float sd = std_p != nullptr ? std_p[0] : std_value;
  if (full) {
    const float4 z = *reinterpret_cast<const float4*>(noise + m0);
    *reinterpret_cast<float4*>(out + m0) =
        make_float4(__fadd_rn(acc[0], __fmul_rn(sd, z.x)), __fadd_rn(acc[1], __fmul_rn(sd, z.y)),
                    __fadd_rn(acc[2], __fmul_rn(sd, z.z)), __fadd_rn(acc[3], __fmul_rn(sd, z.w)));
  } else {
#pragma unroll
    for (int j = 0; j < RUN; ++j)
      if (j < n) out[m0 + j] = __fadd_rn(acc[j], __fmul_rn(sd, noise[m0 + j]));
  }
}

}  // namespace

// x: (K, M) f32 rows; w: (K,) f32; noise: (M,) f32; std_p: one f32 on the
// device, or null to take std_value. out: (M,) f32. aligned != 0 promises
// 16-byte aligned x, noise, out and M % 4 == 0. One launch on ``stream``;
// returns cudaGetLastError().
extern "C" int ota_aggregate_launch(const float* x, int K, long long M, const float* w,
                                    const float* noise, const float* std_p, float std_value,
                                    float* out, int aligned, void* stream) {
  const long long threads = (M + RUN - 1) / RUN;
  const long long blocks = (threads + THREADS - 1) / THREADS;
  if (K < 1 || M < 1 || blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  ota_aggregate_kernel<<<(unsigned)blocks, THREADS, 0, s>>>(x, K, M, w, noise, std_p,
                                                            std_value, out, aligned);
  return (int)cudaGetLastError();
}

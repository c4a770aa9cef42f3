// Packed OTA superpose / fold: y[m] = acc[m] + sum_k c_k * (s_k[m / qblock] * q_k[m]).
//
// Replaces the TPU kernels ota_packed_2d (superpose, acc absent) and
// ota_fold_2d (fold, acc present) of the JAX package's kernels/ota_fused.py.
// One kernel, templated on the wire symbol type: int8, int16, int32, f32
// passthrough, or row-major int4 nibbles (low nibble = even index,
// sign-extended). Scales are one per row (nb == 1) or blockwise, one per
// qblock symbols (block index clipped to nb - 1). c_k = w_k, or w_k * g_k
// when a gains column is given, formed before the symbol math.
//
// Design. Every output column is independent, so no state crosses blocks:
// each thread owns a run of consecutive symbols, 16 bytes of every row
// (16 int8, 8 int16, 4 int32/f32, 32 int4 symbols), and loops k = 0..K-1 in
// ascending order. A warp's 16-byte loads of one row are contiguous. The
// thread masks the ragged edge itself, so rows need no padding. Every
// product and sum is an explicitly rounded f32 op (__fmul_rn / __fadd_rn:
// no FMA contraction), in the order (q * s) * c, then part + that, starting
// from part = 0. The plain PyTorch version in kernels/ota_fused.py does the
// same ops in the same order, so the two agree bit for bit, and
// fold(zeros, b) == superpose(b).
//
// Bound: memory. One call reads K * M * (symbol bytes) + K * nb * 4 bytes
// of rows and scales, writes 4 M bytes, and reads 4 M more for a fold; at
// 3.35 TB/s that is the least time the card can take.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Kind { KIND_INT8 = 0, KIND_INT16 = 1, KIND_INT32 = 2, KIND_F32 = 3, KIND_INT4 = 4 };

template <int KIND> struct Run;
template <> struct Run<KIND_INT8> { static constexpr int R = 16; };
template <> struct Run<KIND_INT16> { static constexpr int R = 8; };
template <> struct Run<KIND_INT32> { static constexpr int R = 4; };
template <> struct Run<KIND_F32> { static constexpr int R = 4; };
template <> struct Run<KIND_INT4> { static constexpr int R = 32; };

union Vec16 {
  uint4 u;
  int8_t i8[16];
  uint8_t u8[16];
  int16_t i16[8];
  int32_t i32[4];
  float f32[4];
};

__device__ __forceinline__ float nibble(uint8_t b, int hi) {
  int v = hi ? (b >> 4) : (b & 0x0F);
  return (float)(v >= 8 ? v - 16 : v);
}

// symbol m of one row, as f32 (the scalar path at the ragged edge)
template <int KIND>
__device__ __forceinline__ float load_one(const uint8_t* row, long long m) {
  if (KIND == KIND_INT8) return (float)reinterpret_cast<const int8_t*>(row)[m];
  if (KIND == KIND_INT16) return (float)reinterpret_cast<const int16_t*>(row)[m];
  if (KIND == KIND_INT32) return (float)reinterpret_cast<const int32_t*>(row)[m];
  if (KIND == KIND_F32) return reinterpret_cast<const float*>(row)[m];
  return nibble(row[m >> 1], (int)(m & 1));
}

// the thread's R symbols from one aligned 16-byte load
template <int KIND>
__device__ __forceinline__ void load_run(const uint8_t* p, float* v) {
  Vec16 x;
  x.u = *reinterpret_cast<const uint4*>(p);
#pragma unroll
  for (int j = 0; j < Run<KIND>::R; ++j) {
    if (KIND == KIND_INT8) v[j] = (float)x.i8[j];
    if (KIND == KIND_INT16) v[j] = (float)x.i16[j];
    if (KIND == KIND_INT32) v[j] = (float)x.i32[j];
    if (KIND == KIND_F32) v[j] = x.f32[j];
    if (KIND == KIND_INT4) v[j] = nibble(x.u8[j >> 1], j & 1);
  }
}

template <int KIND>
__global__ void __launch_bounds__(256) ota_superpose_kernel(
    const uint8_t* __restrict__ q, int K, long long M, long long row_bytes,
    const float* __restrict__ scale, long long nb, long long qblock,
    const float* __restrict__ w, const float* __restrict__ gains,
    const float* __restrict__ acc, float* __restrict__ out, int aligned) {
  constexpr int R = Run<KIND>::R;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long m0 = t * R;
  if (m0 >= M) return;
  const int n = (M - m0) < R ? (int)(M - m0) : R;
  const bool full = aligned && n == R;
  // byte offset of the run inside a row: 16 * t for every kind
  const long long byte0 = t * 16;
  const bool blockwise = qblock > 0 && nb > 1;
  long long b0 = 0, b1 = 0;
  if (blockwise) {
    b0 = min(m0 / qblock, nb - 1);
    b1 = min((m0 + n - 1) / qblock, nb - 1);
  }

  float part[R];
#pragma unroll
  for (int j = 0; j < R; ++j) part[j] = 0.0f;

  for (int k = 0; k < K; ++k) {
    float c = w[k];
    if (gains != nullptr) c = __fmul_rn(c, gains[k]);
    const uint8_t* row = q + (long long)k * row_bytes;
    const float* srow = scale + (long long)k * nb;
    float v[R];
    if (full) {
      load_run<KIND>(row + byte0, v);
    } else {
#pragma unroll
      for (int j = 0; j < R; ++j) v[j] = j < n ? load_one<KIND>(row, m0 + j) : 0.0f;
    }
    if (b0 == b1) {
      const float s = srow[b0];
#pragma unroll
      for (int j = 0; j < R; ++j)
        part[j] = __fadd_rn(part[j], __fmul_rn(__fmul_rn(v[j], s), c));
    } else {
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const long long b = min((m0 + j) / qblock, nb - 1);
        part[j] = __fadd_rn(part[j], __fmul_rn(__fmul_rn(v[j], srow[b]), c));
      }
    }
  }

  if (full) {
#pragma unroll
    for (int j = 0; j < R; j += 4) {
      float4 o = make_float4(part[j], part[j + 1], part[j + 2], part[j + 3]);
      if (acc != nullptr) {
        const float4 a = *reinterpret_cast<const float4*>(acc + m0 + j);
        o.x = __fadd_rn(a.x, o.x);
        o.y = __fadd_rn(a.y, o.y);
        o.z = __fadd_rn(a.z, o.z);
        o.w = __fadd_rn(a.w, o.w);
      }
      *reinterpret_cast<float4*>(out + m0 + j) = o;
    }
  } else {
    // unrolled with a guard (not a loop to n): part[] stays in registers
#pragma unroll
    for (int j = 0; j < R; ++j)
      if (j < n) out[m0 + j] = acc != nullptr ? __fadd_rn(acc[m0 + j], part[j]) : part[j];
  }
}

template <int KIND>
void launch(const void* q, int K, long long M, long long row_bytes, const float* scale,
            long long nb, long long qblock, const float* w, const float* gains,
            const float* acc, float* out, int aligned, cudaStream_t stream) {
  const long long threads = (M + Run<KIND>::R - 1) / Run<KIND>::R;
  const unsigned blocks = (unsigned)((threads + 255) / 256);
  ota_superpose_kernel<KIND><<<blocks, 256, 0, stream>>>(
      reinterpret_cast<const uint8_t*>(q), K, M, row_bytes, scale, nb, qblock, w,
      gains, acc, out, aligned);
}

}  // namespace

// kind: 0 int8, 1 int16, 2 int32, 3 f32, 4 int4 (M = 2 * bytes per row).
// gains and acc may be null. aligned != 0 promises 16-byte aligned rows
// (q and row_bytes), out and acc. Returns cudaGetLastError() after the launch.
extern "C" int ota_superpose_launch(const void* q, int kind, int K, long long M,
                                    long long row_bytes, const float* scale, long long nb,
                                    long long qblock, const float* w, const float* gains,
                                    const float* acc, float* out, int aligned,
                                    void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  switch (kind) {
    case KIND_INT8:
      launch<KIND_INT8>(q, K, M, row_bytes, scale, nb, qblock, w, gains, acc, out, aligned, s);
      break;
    case KIND_INT16:
      launch<KIND_INT16>(q, K, M, row_bytes, scale, nb, qblock, w, gains, acc, out, aligned, s);
      break;
    case KIND_INT32:
      launch<KIND_INT32>(q, K, M, row_bytes, scale, nb, qblock, w, gains, acc, out, aligned, s);
      break;
    case KIND_F32:
      launch<KIND_F32>(q, K, M, row_bytes, scale, nb, qblock, w, gains, acc, out, aligned, s);
      break;
    case KIND_INT4:
      launch<KIND_INT4>(q, K, M, row_bytes, scale, nb, qblock, w, gains, acc, out, aligned, s);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

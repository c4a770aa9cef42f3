// Per-tensor fake-quantization with a given scale: round-to-nearest-even or
// stochastic rounding against a given noise array.
//
// Replaces the TPU kernel fake_quant_2d (_fq_kernel, _fq_stoch_kernel) of
// the JAX package's kernels/quantize.py (reached through ops.fake_quant).
// Per element, all in f32 and each op correctly rounded:
//
//   scaled = x / s                                (IEEE division, __fdiv_rn)
//   q      = rint(scaled)                         (half to even, as jnp.round)
//        or floor(scaled) + (u < scaled - floor(scaled))   (stochastic)
//   q      = clip(q, -qmax, qmax)
//   out    = q * s, rounded to x's dtype          (__fmul_rn, then RNE)
//
// The plain PyTorch version in kernels/quantize.py does the same ops, so the
// two agree bit for bit.
//
// Design. The TPU kernel streams (256, 128) tiles through VMEM, a layout
// the wrapper pads the tensor to. Here the tensor is one flat contiguous
// run of n elements of any length: each thread takes 16 bytes at a time (4
// f32 or 8 bf16 values, and the matching f32 noise) in a grid-stride loop,
// and the last, partial vector goes element by element. No padding, no
// copy. The scale is read once per thread from device memory.
//
// Bound: memory. One call reads n x.dtype values (and n f32 noise values
// when stochastic) and writes n values; about 8 float ops per element are
// far below the f32 rate.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr long long MAX_BLOCKS = 1 << 20;

__device__ __forceinline__ float load_f(const float* p, long long i) { return p[i]; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p, long long i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void from_f(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

template <bool STOCH>
__device__ __forceinline__ float fq_one(float x, float s, float qmax, float u) {
  const float scaled = __fdiv_rn(x, s);
  float q;
  if (STOCH) {
    const float fl = floorf(scaled);
    q = __fadd_rn(fl, (u < __fsub_rn(scaled, fl)) ? 1.0f : 0.0f);
  } else {
    q = rintf(scaled);
  }
  q = q < -qmax ? -qmax : (q > qmax ? qmax : q);  // a NaN stays NaN, as in jnp.clip
  return __fmul_rn(q, s);
}

template <typename T, bool STOCH>
__global__ void __launch_bounds__(THREADS)
    fake_quant_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                      const float* __restrict__ noise, T* __restrict__ out, long long n,
                      float qmax, int aligned) {
  constexpr int VEC = 16 / sizeof(T);
  const float s = scale[0];
  const long long stride = (long long)gridDim.x * THREADS * VEC;
  for (long long i0 = ((long long)blockIdx.x * THREADS + threadIdx.x) * VEC; i0 < n;
       i0 += stride) {
    if (aligned && i0 + VEC <= n) {
      const uint4 raw = *reinterpret_cast<const uint4*>(x + i0);
      const T* v = reinterpret_cast<const T*>(&raw);
      float u[VEC];
      if (STOCH) {
#pragma unroll
        for (int j = 0; j < VEC / 4; ++j) {
          const float4 nz = *reinterpret_cast<const float4*>(noise + i0 + 4 * j);
          u[4 * j] = nz.x;
          u[4 * j + 1] = nz.y;
          u[4 * j + 2] = nz.z;
          u[4 * j + 3] = nz.w;
        }
      }
      uint4 res;
      T* r = reinterpret_cast<T*>(&res);
#pragma unroll
      for (int j = 0; j < VEC; ++j)
        from_f(r + j, fq_one<STOCH>(to_f(v[j]), s, qmax, STOCH ? u[j] : 0.0f));
      *reinterpret_cast<uint4*>(out + i0) = res;
    } else {
      for (int j = 0; j < VEC && i0 + j < n; ++j) {
        const float u = STOCH ? noise[i0 + j] : 0.0f;
        from_f(out + i0 + j, fq_one<STOCH>(load_f(x, i0 + j), s, qmax, u));
      }
    }
  }
}

template <typename T>
int launch(const void* x, long long n, const float* scale, const float* noise, float qmax,
           void* out, int aligned, cudaStream_t st) {
  constexpr int VEC = 16 / sizeof(T);
  long long blocks = (n + (long long)THREADS * VEC - 1) / ((long long)THREADS * VEC);
  if (blocks > MAX_BLOCKS) blocks = MAX_BLOCKS;
  const T* xt = static_cast<const T*>(x);
  T* ot = static_cast<T*>(out);
  if (noise != nullptr) {
    fake_quant_kernel<T, true><<<(unsigned)blocks, THREADS, 0, st>>>(xt, scale, noise, ot, n,
                                                                     qmax, aligned);
  } else {
    fake_quant_kernel<T, false><<<(unsigned)blocks, THREADS, 0, st>>>(xt, scale, nullptr, ot, n,
                                                                      qmax, aligned);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// x, out: n contiguous values of one dtype (is_bf16: 1 = bfloat16, 0 =
// float32); scale: one f32 on the device; noise: n f32 uniforms in [0, 1)
// for stochastic rounding, or null for round-to-nearest-even; qmax: the
// clip bound 2**(bits-1) - 1. aligned != 0 promises 16-byte aligned x, out
// and noise. One launch on ``stream``; returns cudaGetLastError().
extern "C" int fake_quant_launch(const void* x, int is_bf16, long long n, const float* scale,
                                 const float* noise, float qmax, void* out, int aligned,
                                 void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) return launch<__nv_bfloat16>(x, n, scale, noise, qmax, out, aligned, st);
  return launch<float>(x, n, scale, noise, qmax, out, aligned, st);
}

// Weight-only int8 matrix product with the per-output-channel scale applied
// in the epilogue:
//
//   out[m, n] = (sum_k x[m, k] * q[k, n]) * scale[n]      (f32 accumulate)
//
// Replaces the TPU kernel qmatmul (_qmm_kernel) of the JAX package's
// kernels/qmatmul.py (reached through ops.qmatmul and ops.qmatmul_int4).
// That kernel walks an (m, n, k) grid with k innermost and sequential,
// carrying the f32 accumulator in VMEM scratch from one k step to the next,
// and upcasts each int8 weight tile to f32 before the MXU product. A GPU
// grid runs its blocks in parallel, so here one block owns one (m, n) tile
// and loops over its k range itself, with the accumulator in registers.
//
// bf16 x: mma.sync.m16n8k16 (bf16 in, f32 accumulate). Each int8 weight is
// converted to bf16 on its way into shared memory; that is exact (|q| <=
// 127), and a bf16 x bf16 product is exact in f32, so only the summation
// order differs from the reference's f32 dot. Block tile BM x 128 x 32,
// 4 warps side by side along n (32 columns each), BM = 64 (4 m16 tiles a
// warp) or 16 for M <= 16 (one m16 tile: a decode step).
//
// f32 x: scalar fmaf on tiles of BM x 64 x 16, 256 threads each holding
// (BM / 16) x 4 outputs, BM = 64 or 16. No TF32: that would cut x to 10
// mantissa bits, which the reference's f32 dot does not.
//
// Both: the next k tile is loaded from device memory into registers while
// the current one is multiplied out of shared memory (two shared buffers,
// one barrier a tile). Rows past M, columns past N and k past K are
// zero-filled on load and never stored, so ragged shapes need no padding
// and no copy: 16-byte loads where the row is aligned and whole, element
// loads at the edges.
//
// Split k. At a decode step's M (a few rows) the (m, n) tiles are too few to
// fill 132 SMs with the loads in flight that the weight read needs (the
// 12,288-deep w_down has 32 tiles of 128 columns). The wrapper then splits
// k into `splits` ranges of k_chunk (a multiple of 32): block z of the grid
// writes its unscaled partial sums to ws[z] and a second launch adds the
// partials in z order and applies the scale. No atomics: the result is the
// same from one launch to the next.
//
// Bound: at a decode step (M = 4, Qwen3-8B's 4,096 x 12,288 w_gate) the
// 50.3 MB int8 weight read (0.015 ms at 3.35 TB/s); at prefill (M = 8,192)
// the 8.25e14 flops (0.83 ms at 989 TFLOP/s on the tensor cores). This
// first design uses mma.sync from register-staged tiles (not wgmma and
// TMA), so it sits well below the operation bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ------------------------------------------------------------------ bf16

constexpr int BN16 = 128;  // columns per block
constexpr int BK16 = 32;   // k per tile
constexpr int T16 = 128;   // threads per block (4 warps)

__device__ __forceinline__ void ldsm_x4(uint32_t& r0, uint32_t& r1, uint32_t& r2, uint32_t& r3,
                                        const __nv_bfloat16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(a)
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t& r0, uint32_t& r1, uint32_t& r2, uint32_t& r3,
                                          const __nv_bfloat16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(a)
               : "memory");
}

// c += a (16x16, row) . b (16x8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma16816(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

// 8 bf16 of x's row `row`, columns [c, c + 8); zero outside rows < M, c < kend
__device__ __forceinline__ uint4 load_x8(const __nv_bfloat16* x, int M, int K, int row, int c,
                                         int kend, bool vec) {
  uint4 r = make_uint4(0u, 0u, 0u, 0u);
  if (row >= M) return r;
  const __nv_bfloat16* p = x + (long long)row * K + c;
  if (vec && c + 8 <= kend) return *reinterpret_cast<const uint4*>(p);
  __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&r);
#pragma unroll
  for (int j = 0; j < 8; ++j)
    if (c + j < kend) e[j] = p[j];
  return r;
}

// 16 int8 of w's row k, columns [c, c + 16); zero outside k < kend, c < N
__device__ __forceinline__ uint4 load_w16(const int8_t* w, int N, int k, int c, int kend,
                                          bool vec) {
  uint4 r = make_uint4(0u, 0u, 0u, 0u);
  if (k >= kend) return r;
  const int8_t* p = w + (long long)k * N + c;
  if (vec && c + 16 <= N) return *reinterpret_cast<const uint4*>(p);
  int8_t* e = reinterpret_cast<int8_t*>(&r);
#pragma unroll
  for (int j = 0; j < 16; ++j)
    if (c + j < N) e[j] = p[j];
  return r;
}

template <int MT>
__global__ void __launch_bounds__(T16)
    qmm_bf16(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ w,
             const float* __restrict__ scale, float* __restrict__ out, float* __restrict__ ws,
             int M, int N, int K, int k_chunk, int vec_x, int vec_w) {
  constexpr int BM = 16 * MT;
  constexpr int PA = BK16 + 8;  // bf16 per shared row of x (conflict-free ldmatrix)
  constexpr int PB = BN16 + 8;  // bf16 per shared row of w
  constexpr int A_CHUNKS = BM * BK16 / 8;
  constexpr int A_PER = (A_CHUNKS + T16 - 1) / T16;
  constexpr int B_PER = BK16 * BN16 / 16 / T16;
  __shared__ __align__(16) __nv_bfloat16 As[2][BM * PA];
  __shared__ __align__(16) __nv_bfloat16 Bs[2][BK16 * PB];

  const int n0 = blockIdx.x * BN16, m0 = blockIdx.y * BM;
  const int kbeg = blockIdx.z * k_chunk;
  const int kend = min(K, kbeg + k_chunk);
  const int n_kt = (kend - kbeg + BK16 - 1) / BK16;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;

  uint4 ra[A_PER], rb[B_PER];
  auto gload = [&](int k0) {
#pragma unroll
    for (int i = 0; i < A_PER; ++i) {
      const int c = threadIdx.x + i * T16;
      if (c < A_CHUNKS) ra[i] = load_x8(x, M, K, m0 + c / 4, k0 + (c % 4) * 8, kend, vec_x);
    }
#pragma unroll
    for (int i = 0; i < B_PER; ++i) {
      const int c = threadIdx.x + i * T16;
      rb[i] = load_w16(w, N, k0 + c / 8, n0 + (c % 8) * 16, kend, vec_w);
    }
  };
  auto sstore = [&](int buf) {
#pragma unroll
    for (int i = 0; i < A_PER; ++i) {
      const int c = threadIdx.x + i * T16;
      if (c < A_CHUNKS) *reinterpret_cast<uint4*>(&As[buf][(c / 4) * PA + (c % 4) * 8]) = ra[i];
    }
#pragma unroll
    for (int i = 0; i < B_PER; ++i) {
      const int c = threadIdx.x + i * T16;
      const int8_t* e = reinterpret_cast<const int8_t*>(&rb[i]);
      uint32_t o[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) o[j] = pack_bf16((float)e[2 * j], (float)e[2 * j + 1]);
      __nv_bfloat16* dst = &Bs[buf][(c / 8) * PB + (c % 8) * 16];
      *reinterpret_cast<uint4*>(dst) = make_uint4(o[0], o[1], o[2], o[3]);
      *reinterpret_cast<uint4*>(dst + 8) = make_uint4(o[4], o[5], o[6], o[7]);
    }
  };

  float acc[MT][4][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  // ldmatrix row addresses (lane -> row of one of the four 8x8 matrices)
  const int a_off = ((lane & 7) + ((lane >> 3) & 1) * 8) * PA + (lane >> 4) * 8;
  const int b_off = ((lane & 7) + ((lane >> 3) & 1) * 8) * PB + warp * 32 + (lane >> 4) * 8;

  gload(kbeg);
  sstore(0);
  __syncthreads();
  for (int kt = 0; kt < n_kt; ++kt) {
    const int cur = kt & 1;
    const bool more = kt + 1 < n_kt;
    if (more) gload(kbeg + (kt + 1) * BK16);
#pragma unroll
    for (int kk = 0; kk < BK16 / 16; ++kk) {
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        ldsm_x4(a[mt][0], a[mt][1], a[mt][2], a[mt][3], &As[cur][a_off + mt * 16 * PA + kk * 16]);
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t b0, b1, b2, b3;
        ldsm_x4_t(b0, b1, b2, b3, &Bs[cur][b_off + kk * 16 * PB + np * 16]);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma16816(acc[mt][2 * np], a[mt], b0, b1);
          mma16816(acc[mt][2 * np + 1], a[mt], b2, b3);
        }
      }
    }
    if (more) sstore(cur ^ 1);
    __syncthreads();
  }

  const long long mn = (long long)M * N;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = m0 + mt * 16 + g + half * 8;
      if (row >= M) continue;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = n0 + warp * 32 + nt * 8 + 2 * t + e;
          if (col >= N) continue;
          const float v = acc[mt][nt][2 * half + e];
          const long long i = (long long)row * N + col;
          if (gridDim.z > 1) {
            ws[blockIdx.z * mn + i] = v;
          } else {
            out[i] = __fmul_rn(v, scale[col]);
          }
        }
      }
    }
  }
}

// ------------------------------------------------------------------- f32

constexpr int BN32 = 64;  // columns per block
constexpr int BK32 = 16;  // k per tile
constexpr int T32 = 256;  // threads per block: 16 row groups x 16 column quads

// 4 floats of x's row `row`, columns [c, c + 4); zero outside rows < M, c < kend
__device__ __forceinline__ float4 load_x4(const float* x, int M, int K, int row, int c, int kend,
                                          bool vec) {
  float4 r = make_float4(0.f, 0.f, 0.f, 0.f);
  if (row >= M) return r;
  const float* p = x + (long long)row * K + c;
  if (vec && c + 4 <= kend) return *reinterpret_cast<const float4*>(p);
  if (c < kend) r.x = p[0];
  if (c + 1 < kend) r.y = p[1];
  if (c + 2 < kend) r.z = p[2];
  if (c + 3 < kend) r.w = p[3];
  return r;
}

template <int TM>
__global__ void __launch_bounds__(T32)
    qmm_f32(const float* __restrict__ x, const int8_t* __restrict__ w,
            const float* __restrict__ scale, float* __restrict__ out, float* __restrict__ ws, int M,
            int N, int K, int k_chunk, int vec_x, int vec_w) {
  constexpr int BM = 16 * TM;
  constexpr int PA = BM + 4;    // floats per shared row of x^T (k-major)
  constexpr int PB = BN32 + 4;  // floats per shared row of w
  constexpr int A_CHUNKS = BM * BK32 / 4;
  constexpr int A_PER = (A_CHUNKS + T32 - 1) / T32;
  constexpr int B_CHUNKS = BK32 * BN32 / 16;
  __shared__ __align__(16) float As[2][BK32 * PA];
  __shared__ __align__(16) float Bs[2][BK32 * PB];

  const int n0 = blockIdx.x * BN32, m0 = blockIdx.y * BM;
  const int kbeg = blockIdx.z * k_chunk;
  const int kend = min(K, kbeg + k_chunk);
  const int n_kt = (kend - kbeg + BK32 - 1) / BK32;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;

  float4 ra[A_PER];
  uint4 rb;
  auto gload = [&](int k0) {
#pragma unroll
    for (int i = 0; i < A_PER; ++i) {
      const int c = threadIdx.x + i * T32;
      if (c < A_CHUNKS) ra[i] = load_x4(x, M, K, m0 + c / 4, k0 + (c % 4) * 4, kend, vec_x);
    }
    if (threadIdx.x < B_CHUNKS) {
      const int c = threadIdx.x;
      rb = load_w16(w, N, k0 + c / 4, n0 + (c % 4) * 16, kend, vec_w);
    }
  };
  auto sstore = [&](int buf) {
#pragma unroll
    for (int i = 0; i < A_PER; ++i) {
      const int c = threadIdx.x + i * T32;
      if (c < A_CHUNKS) {
        const int r = c / 4, k = (c % 4) * 4;
        As[buf][(k + 0) * PA + r] = ra[i].x;
        As[buf][(k + 1) * PA + r] = ra[i].y;
        As[buf][(k + 2) * PA + r] = ra[i].z;
        As[buf][(k + 3) * PA + r] = ra[i].w;
      }
    }
    if (threadIdx.x < B_CHUNKS) {
      const int c = threadIdx.x;
      const int8_t* e = reinterpret_cast<const int8_t*>(&rb);
      float* dst = &Bs[buf][(c / 4) * PB + (c % 4) * 16];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        *reinterpret_cast<float4*>(dst + 4 * j) = make_float4(
            (float)e[4 * j], (float)e[4 * j + 1], (float)e[4 * j + 2], (float)e[4 * j + 3]);
    }
  };

  float acc[TM][4];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  gload(kbeg);
  sstore(0);
  __syncthreads();
  for (int kt = 0; kt < n_kt; ++kt) {
    const int cur = kt & 1;
    const bool more = kt + 1 < n_kt;
    if (more) gload(kbeg + (kt + 1) * BK32);
#pragma unroll
    for (int kk = 0; kk < BK32; ++kk) {
      const float4 b = *reinterpret_cast<const float4*>(&Bs[cur][kk * PB + tx * 4]);
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float a = As[cur][kk * PA + ty + 16 * i];
        acc[i][0] = fmaf(a, b.x, acc[i][0]);
        acc[i][1] = fmaf(a, b.y, acc[i][1]);
        acc[i][2] = fmaf(a, b.z, acc[i][2]);
        acc[i][3] = fmaf(a, b.w, acc[i][3]);
      }
    }
    if (more) sstore(cur ^ 1);
    __syncthreads();
  }

  const long long mn = (long long)M * N;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = m0 + ty + 16 * i;
    if (row >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx * 4 + j;
      if (col >= N) continue;
      const long long idx = (long long)row * N + col;
      if (gridDim.z > 1) {
        ws[blockIdx.z * mn + idx] = acc[i][j];
      } else {
        out[idx] = __fmul_rn(acc[i][j], scale[col]);
      }
    }
  }
}

// ------------------------------------------------------------- split k

// out[i] = (ws[0][i] + ws[1][i] + ... in z order) * scale[i % N]
__global__ void __launch_bounds__(256)
    splitk_reduce(const float* __restrict__ ws, int splits, long long mn, int N,
                  const float* __restrict__ scale, float* __restrict__ out) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < mn; i += stride) {
    float s = ws[i];
    for (int z = 1; z < splits; ++z) s = __fadd_rn(s, ws[z * mn + i]);
    out[i] = __fmul_rn(s, scale[i % N]);
  }
}

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

}  // namespace

// x: (M, K) row-major, bfloat16 (is_bf16 = 1) or float32; w: (K, N) int8
// row-major; scale: (N,) f32; out: (M, N) f32. k is cut into `splits`
// ranges of k_chunk (a multiple of 32; splits == ceil(K / k_chunk)); with
// splits > 1, ws holds splits * M * N f32 of scratch and a second launch
// reduces it. Launches on ``stream``; returns cudaGetLastError().
extern "C" int qmatmul_launch(const void* x, int is_bf16, const int8_t* w, const float* scale,
                              float* out, float* ws, int M, int N, int K, int splits,
                              int k_chunk, void* stream) {
  if (M < 1 || N < 1 || K < 1 || splits < 1 || k_chunk < 1 || k_chunk % 32 != 0 ||
      (long long)(splits - 1) * k_chunk >= K || (long long)splits * k_chunk < K ||
      (splits > 1 && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool small = M <= 16;
  const int bm = small ? 16 : 64;
  const long long m_tiles = (M + bm - 1) / bm;
  if (m_tiles > 65535 || splits > 65535) return (int)cudaErrorInvalidValue;
  const int vec_w = aligned16(w) && N % 16 == 0;
  if (is_bf16) {
    const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
    const int vec_x = aligned16(x) && K % 8 == 0;
    const dim3 grid((N + BN16 - 1) / BN16, (unsigned)m_tiles, splits);
    if (small) {
      qmm_bf16<1><<<grid, T16, 0, st>>>(xb, w, scale, out, ws, M, N, K, k_chunk, vec_x, vec_w);
    } else {
      qmm_bf16<4><<<grid, T16, 0, st>>>(xb, w, scale, out, ws, M, N, K, k_chunk, vec_x, vec_w);
    }
  } else {
    const float* xf = static_cast<const float*>(x);
    const int vec_x = aligned16(x) && K % 4 == 0;
    const dim3 grid((N + BN32 - 1) / BN32, (unsigned)m_tiles, splits);
    if (small) {
      qmm_f32<1><<<grid, T32, 0, st>>>(xf, w, scale, out, ws, M, N, K, k_chunk, vec_x, vec_w);
    } else {
      qmm_f32<4><<<grid, T32, 0, st>>>(xf, w, scale, out, ws, M, N, K, k_chunk, vec_x, vec_w);
    }
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  const long long mn = (long long)M * N;
  long long blocks = (mn + 255) / 256;
  if (blocks > 8192) blocks = 8192;
  splitk_reduce<<<(unsigned)blocks, 256, 0, st>>>(ws, splits, mn, N, scale, out);
  return (int)cudaGetLastError();
}

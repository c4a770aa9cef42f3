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
// Three kernels, one per route, fixed by dtype, shape and alignment alone
// (design(), mirrored by kernels/qmatmul.kernel_design): never a fallback.
//
// qmm_hopper (bf16 x, M > 16, K % 8 == 0, N % 16 == 0, x and w 16-byte
// aligned: what TMA takes), the prefill route. 384 threads; a CTA owns 256
// rows x 128 columns of out and steps k by 64. Warpgroup 0 is the producer:
// one thread issues TMA loads (rank-2 maps over (K, M) bf16 and (N, K)
// int8, encoded per launch through libcuda's entry point; both 128-byte
// swizzled, zeros past every edge) into a four-stage x ring (256 rows x 128
// B) and a four-stage int8 ring (64 k rows x 128 B), and the whole
// warpgroup converts each int8 tile into a three-stage bf16 B ring: two
// 64-n blocks of 64 k rows x 128 B, 16-byte chunk c of row k at c ^ (k & 7)
// (the pattern TMA writes, so wgmma reads it as the V tile of
// flash_attention.cu). The conversion is exact (|q| <= 128 has at most 8
// significant bits): q + 128 as the low byte of the f32 2**23, minus
// 2**23 + 128, truncated to its top half. The B tile is written by
// st.shared, the generic proxy, and read by wgmma, the async proxy, so each
// producer thread runs fence.proxy.async.shared::cta between its writes and
// its arrival on the stage's full barrier; without it wgmma may read stale
// bytes now and then. Warpgroups 1 and 2 are the consumers: each owns 128
// rows as two m64 tiles and runs wgmma.m64n128k16 with A (x) K-major and B
// MN-major (the transpose flag) from shared memory, 64 f32 accumulators a
// thread per m64 tile; they wait on the x and B full barriers and release
// both stages on the B empty barrier. No CTA-wide barrier in the k loop, no
// atomics, no split k: one launch gives the same bits as the next. The tile
// order walks 8 m tiles at a time across the n tiles, so the CTAs in flight
// share a few x row blocks and w column blocks in L2.
//
// qmm_bf16 (other bf16 x): mma.sync.m16n8k16 (bf16 in, f32 accumulate).
// Each int8 weight is converted to bf16 on its way into shared memory; that
// is exact, and a bf16 x bf16 product is exact in f32, so only the summation
// order differs from the reference's f32 dot. Block tile BM x 128 x 32, 4
// warps side by side along n (32 columns each), BM = 64 (4 m16 tiles a
// warp) or 16 for M <= 16 (one m16 tile: a decode step).
//
// qmm_f32 (f32 x): scalar fmaf on tiles of BM x 64 x 16, 256 threads each
// holding (BM / 16) x 4 outputs, BM = 64 or 16. No TF32: that would cut x
// to 10 mantissa bits, which the reference's f32 dot does not.
//
// qmm_bf16 and qmm_f32: the next k tile is loaded from device memory into
// registers while the current one is multiplied out of shared memory (two
// shared buffers, one barrier a tile). Rows past M, columns past N and k
// past K are zero-filled on load and never stored, so ragged shapes need no
// padding and no copy: 16-byte loads where the row is aligned and whole,
// element loads at the edges.
//
// Split k (qmm_bf16 and qmm_f32). At a decode step's M (a few rows) the
// (m, n) tiles are too few to fill 132 SMs with the loads in flight that
// the weight read needs (the 12,288-deep w_down has 32 tiles of 128
// columns). The wrapper then splits k into `splits` ranges of k_chunk (a
// multiple of 32): block z of the grid writes its unscaled partial sums to
// ws[z] and a second launch adds the partials in z order and applies the
// scale. No atomics: the result is the same from one launch to the next.
//
// Bound: at a decode step (M = 4, Qwen3-8B's 4,096 x 12,288 w_gate) the
// 50.3 MB int8 weight read (0.015 ms at 3.35 TB/s); at prefill (M = 8,192)
// the 8.25e11 flops (2 x 8,192 x 4,096 x 12,288; 0.834 ms at 989 TFLOP/s
// on the tensor cores), which qmm_hopper is built for. Per 256 x 128 x 64
// step it moves 160 KB through shared memory (the TMA writes, the
// conversion's reads and writes, and wgmma's operand reads, B once per m64
// tile) for 2.1 M multiply-adds: at 128 bytes a clock, shared memory alone
// would hold it to about 80% of the tensor cores' rate by that count.

#include <cuda.h>
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

// ------------------------------------------------- bf16 on Hopper (prefill)

constexpr int HT = 128;        // n columns of a CTA tile; rows of a consumer warpgroup
constexpr int BMH = 256;       // m rows of a CTA tile: two consumers of two m64 tiles each
constexpr int BKH = 64;        // k step: one 128-byte swizzle atom of bf16 x
constexpr int XST = 4;         // stages of the x and int8 w rings
constexpr int BST = 3;         // stages of the bf16 B ring
constexpr int GROUP_M = 8;     // m tiles walked together in the tile order (L2 reuse)
constexpr int THREADS_H = 384;  // warpgroup 0 loads and converts, warpgroups 1 and 2 multiply
constexpr uint32_t X_BYTES = BMH * BKH * 2;   // 32 KB: 256 rows x 128 B
constexpr uint32_t W8_BYTES = BKH * HT;       // 8 KB: 64 k rows x 128 B
constexpr uint32_t B_BYTES = BKH * HT * 2;    // 16 KB: two 64-n blocks of 64 k rows x 128 B
constexpr uint32_t B_BLOCK = BKH * 128;       // one 64-n block of the B tile
constexpr uint32_t STG_OFF = XST * X_BYTES;
constexpr uint32_t BS_OFF = STG_OFF + XST * W8_BYTES;
constexpr uint32_t BAR_OFF = BS_OFF + BST * B_BYTES;  // 2 (XST + BST) mbarriers
constexpr size_t SMEM_H = BAR_OFF + 16 * (XST + BST) + 1024;

// wgmma shared-memory matrix descriptor, 128-byte swizzle: start address,
// leading and stride byte offsets in 16-byte units, layout type 1 (SW128)
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// pins a register's reads and writes to this side of an async wgmma
__device__ __forceinline__ void reg_fence(float& r) { asm volatile("" : "+f"(r)::"memory"); }

// generic-proxy accesses of shared memory (ld.shared, st.shared) ordered
// before the async-proxy ones (wgmma, TMA) that read or overwrite them next
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

#define WG_F4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define WG_F16(i) WG_F4(i), WG_F4(i + 4), WG_F4(i + 8), WG_F4(i + 12)
#define WG_D64                                                                              \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "   \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "   \
  "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "   \
  "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"

// d (64 x 128, f32) += A (64 x 16) . B (16 x 128); A bf16 from shared memory
// K-major, B bf16 from shared memory MN-major (n contiguous: the transpose flag)
__device__ __forceinline__ void wgmma_ss_n128_tb(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" WG_D64 "}, %64, %65, p, 1, 1, "
      "0, 1;\n}\n"
      : WG_F16(0), WG_F16(16), WG_F16(32), WG_F16(48)
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// spins until the phase of the given parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred P1;\nLAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@!P1 bra LAB_WAIT;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// one box of a rank-2 map at (c0 inner, c1 outer) into shared memory at dst,
// completing on bar; what lies past the tensor's edges arrives as zeros
__device__ __forceinline__ void tma_load2(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, "
      "{%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

__device__ __forceinline__ uint4 ld_shared16(uint32_t a) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(a)
               : "memory");
  return v;
}
__device__ __forceinline__ void st_shared16(uint32_t a, uint32_t v0, uint32_t v1, uint32_t v2,
                                            uint32_t v3) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(a), "r"(v0), "r"(v1), "r"(v2),
               "r"(v3)
               : "memory");
}

// four int8 (one word, element 0 in the low byte) -> four bf16 (two words,
// element 0 in the low half), exactly: the byte q + 128 under the f32
// exponent of 2**23 reads 2**23 + 128 + q, and subtracting 2**23 + 128
// leaves q, whose f32 bits end in 16 zeros (|q| <= 128 has at most 8
// significant bits), so the top half is q in bf16
__device__ __forceinline__ void i8x4_to_bf16(uint32_t w, uint32_t& lo, uint32_t& hi) {
  const uint32_t u = w ^ 0x80808080u;
  const float f0 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650)) - 8388736.f;
  const float f1 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7651)) - 8388736.f;
  const float f2 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7652)) - 8388736.f;
  const float f3 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7653)) - 8388736.f;
  lo = __byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632);
  hi = __byte_perm(__float_as_uint(f2), __float_as_uint(f3), 0x7632);
}

// The int8 tile (64 k rows of 128 B, 16-byte chunk j of row k at j ^ (k & 7))
// into the bf16 B tile (two 64-n blocks of 64 k rows x 128 B, chunk c of row
// k at c ^ (k & 7)), by the 128 threads of the producer warpgroup. Eight
// neighbouring threads take the same chunk of eight rows, so neither the
// reads nor the writes meet in a bank.
__device__ __forceinline__ void convert_w(uint32_t stg, uint32_t bs, int tid) {
#pragma unroll
  for (int it = 0; it < BKH * 8 / 128; ++it) {
    const int i = tid + it * 128;
    const int j = (i >> 3) & 7;
    const int k = (i & 7) | ((i >> 6) << 3);
    const int sw = k & 7;
    const uint4 v = ld_shared16(stg + k * 128 + ((j ^ sw) << 4));
    uint32_t o[8];
    i8x4_to_bf16(v.x, o[0], o[1]);
    i8x4_to_bf16(v.y, o[2], o[3]);
    i8x4_to_bf16(v.z, o[4], o[5]);
    i8x4_to_bf16(v.w, o[6], o[7]);
    const uint32_t row = bs + (j >> 2) * B_BLOCK + k * 128;
    const int c0 = (j & 3) * 2;
    st_shared16(row + ((c0 ^ sw) << 4), o[0], o[1], o[2], o[3]);
    st_shared16(row + (((c0 + 1) ^ sw) << 4), o[4], o[5], o[6], o[7]);
  }
}

// x tile kt (one box of 64 k x 256 rows) into its stage of the x ring
__device__ __forceinline__ void load_x(uint32_t xs, uint32_t x_full, const CUtensorMap* tmx,
                                       int kt, int m0) {
  const int s = kt % XST;
  mbar_expect_tx(x_full + 8 * s, X_BYTES);
  tma_load2(xs + s * X_BYTES, tmx, kt * BKH, m0, x_full + 8 * s);
}

// int8 w tile kt (one box of 128 n x 64 k) into its stage of the int8 ring
__device__ __forceinline__ void load_w(uint32_t stg, uint32_t w_full, const CUtensorMap* tmw,
                                       int kt, int n0) {
  const int s = kt % XST;
  mbar_expect_tx(w_full + 8 * s, W8_BYTES);
  tma_load2(stg + s * W8_BYTES, tmw, n0, kt * BKH, w_full + 8 * s);
}

// out = acc * scale from a consumer warpgroup's accumulator (the m16n8 C
// layout per warp: element 4 j + 2 r + e at row g + 8 r, column 8 j + 2 t + e)
__device__ __forceinline__ void store_tile(const float (&acc)[64], const float* __restrict__ scale,
                                           float* __restrict__ out, int M, int N, int row0,
                                           int col0) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= M) continue;
    float* o = out + (long long)row * N;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = col0 + 8 * j;
      if (col >= N) continue;  // N % 16 == 0: col + 1 < N too
      *reinterpret_cast<float2*>(o + col) =
          make_float2(__fmul_rn(acc[4 * j + 2 * r], scale[col]),
                      __fmul_rn(acc[4 * j + 2 * r + 1], scale[col + 1]));
    }
  }
}

__global__ void __launch_bounds__(THREADS_H, 1)
    qmm_hopper(const __grid_constant__ CUtensorMap tmx, const __grid_constant__ CUtensorMap tmw,
               const float* __restrict__ scale, float* __restrict__ out, int M, int N, int K) {
  constexpr int LX = XST - BST;  // x loads run LX tiles ahead of the conversion
  constexpr int LW = XST - 1;    // int8 w loads LW tiles ahead
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t base =
      (static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw)) + 1023u) & ~1023u;
  const uint32_t XS = base, STG = base + STG_OFF, BS = base + BS_OFF;
  // mbarriers: x full x XST, int8 w full x XST, B full x BST, B empty x BST
  const uint32_t x_full = base + BAR_OFF, w_full = x_full + 8 * XST;
  const uint32_t b_full = w_full + 8 * XST, b_empty = b_full + 8 * BST;
  // this CTA's tile: GROUP_M m tiles at a time, n tiles across each group,
  // so the CTAs in flight share a few x row blocks and w column blocks in L2
  const int tm = (M + BMH - 1) / BMH, tn = (N + HT - 1) / HT;
  const int first = ((int)blockIdx.x / (GROUP_M * tn)) * GROUP_M;
  const int r = (int)blockIdx.x % (GROUP_M * tn), gm = min(tm - first, GROUP_M);
  const int m0 = (first + r % gm) * BMH, n0 = (r / gm) * HT;
  const int n_kt = (K + BKH - 1) / BKH;
  const int wg = threadIdx.x >> 7;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < XST; ++s) {
      mbar_init(x_full + 8 * s, 1);
      mbar_init(w_full + 8 * s, 1);
    }
#pragma unroll
    for (int s = 0; s < BST; ++s) {
      mbar_init(b_full + 8 * s, 128);  // every producer thread, after its proxy fence
      mbar_init(b_empty + 8 * s, 8);   // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // producer: thread 0 keeps the TMA loads ahead (x LX tiles, int8 w LW
    // tiles ahead of the conversion); the warpgroup converts each w tile
    const int tid = threadIdx.x;
    if (tid == 0) {
      for (int t = 0; t < LX && t < n_kt; ++t) load_x(XS, x_full, &tmx, t, m0);
      for (int t = 0; t < LW && t < n_kt; ++t) load_w(STG, w_full, &tmw, t, n0);
    }
    for (int kt = 0; kt < n_kt; ++kt) {
      const int bs = kt % BST;
      // the consumers have released tile kt - BST: its B stage is free, and
      // so is the x stage of tile kt + LX (that of tile kt + LX - XST)
      if (kt >= BST) mbar_wait(b_empty + 8 * bs, ((kt / BST) & 1) ^ 1);
      if (tid == 0) {
        if (kt + LX < n_kt) load_x(XS, x_full, &tmx, kt + LX, m0);
        // its int8 stage held tile kt - 1, converted in the last iteration
        if (kt + LW < n_kt) load_w(STG, w_full, &tmw, kt + LW, n0);
      }
      mbar_wait(w_full + 8 * (kt % XST), (kt / XST) & 1);
      convert_w(STG + (kt % XST) * W8_BYTES, BS + bs * B_BYTES, tid);
      // the B tile was written by st.shared (the generic proxy) and is read
      // by wgmma (the async proxy): fence before releasing it, or wgmma may
      // read stale bytes; the fence also orders this thread's reads of the
      // int8 stage before the TMA write that refills it
      fence_proxy_async();
      mbar_arrive(b_full + 8 * bs);
      asm volatile("bar.sync 1, 128;\n" ::: "memory");  // the int8 stage is read out
    }
  } else {
    // consumers: warpgroup cw owns rows cw 128 .. + 127 of the tile, as two
    // m64 tiles, each a 64 x 128 f32 accumulator
    const int cw = wg - 1, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    float acc[2][64];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[mt][i] = 0.f;
    for (int kt = 0; kt < n_kt; ++kt) {
      const uint32_t xs = XS + (kt % XST) * X_BYTES, bs = BS + (kt % BST) * B_BYTES;
      mbar_wait(x_full + 8 * (kt % XST), (kt / XST) & 1);
      mbar_wait(b_full + 8 * (kt % BST), (kt / BST) & 1);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int i = 0; i < 64; ++i) reg_fence(acc[mt][i]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BKH / 16; ++kk) {
        // B: k rows kk 16 .. + 15, MN-major (leading byte offset: the next 64
        // n; stride: 8 k rows); A: K-major, 32 bytes a k16 step in the atom
        const uint64_t db = sw128_desc(bs + kk * (16 * 128), B_BLOCK, 1024);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const uint64_t da =
              sw128_desc(xs + (cw * 2 + mt) * (64 * 128) + kk * 32, 16, 1024);
          wgmma_ss_n128_tb(acc[mt], da, db);
        }
      }
      wgmma_commit();
      wgmma_wait0();
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int i = 0; i < 64; ++i) reg_fence(acc[mt][i]);
      __syncwarp();
      if (lane == 0) mbar_arrive(b_empty + 8 * (kt % BST));
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
      store_tile(acc[mt], scale, out, M, N, m0 + (cw * 2 + mt) * 64 + warp * 16 + (lane >> 2),
                 n0 + 2 * (lane & 3));
  }
}

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

// cuTensorMapEncodeTiled, looked up in libcuda at run time (the build links
// only the runtime)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult res;
#if CUDART_VERSION >= 12050
    const cudaError_t e =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &res);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                                  cudaEnableDefault, &res);
#endif
    if (e == cudaSuccess && res == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// rank-2 map of a row-major (outer, inner) tensor of row_bytes a row, boxes
// of (box_inner, box_outer), 128-byte swizzle, zeros past every edge
int make_map(CUtensorMap* map, CUtensorMapDataType dt, const void* t, uint64_t inner,
             uint64_t outer, uint64_t row_bytes, uint32_t box_inner, uint32_t box_outer) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorInitializationError;
  const cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)outer};
  const cuuint64_t strides[1] = {(cuuint64_t)row_bytes};
  const cuuint32_t box[2] = {box_inner, box_outer};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = fn(map, dt, 2, const_cast<void*>(t), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

int launch_hopper(const void* x, const int8_t* w, const float* scale, float* out, int M, int N,
                  int K, cudaStream_t st) {
  const long long tiles = (long long)((M + BMH - 1) / BMH) * ((N + HT - 1) / HT);
  if (tiles > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  CUtensorMap tmx, tmw;
  int rc = make_map(&tmx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, K, M, (uint64_t)K * 2, BKH, BMH);
  if (rc == 0) rc = make_map(&tmw, CU_TENSOR_MAP_DATA_TYPE_UINT8, w, N, K, (uint64_t)N, HT, BKH);
  if (rc != 0) return rc;
  cudaError_t e = cudaFuncSetAttribute(qmm_hopper, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)SMEM_H);
  if (e != cudaSuccess) return (int)e;
  qmm_hopper<<<(unsigned)tiles, THREADS_H, SMEM_H, st>>>(tmx, tmw, scale, out, M, N, K);
  return (int)cudaGetLastError();
}

constexpr int SMALL_M = 16;  // M at or below this: a decode step (16-row tiles, split k)

// The kernel a call runs, fixed by dtype, shape and alignment alone:
// 2 qmm_hopper (bf16 x, M > 16, rows of x and w whole 16-byte multiples, both
// bases 16-byte aligned: what TMA takes), 1 qmm_bf16 (other bf16), 0 qmm_f32.
// kernels/qmatmul.kernel_design is the same table.
int design(int is_bf16, int M, int N, int K, const void* x, const void* w) {
  if (!is_bf16) return 0;
  return (M > SMALL_M && K % 8 == 0 && N % 16 == 0 && aligned16(x) && aligned16(w)) ? 2 : 1;
}

}  // namespace

// x: (M, K) row-major, bfloat16 (is_bf16 = 1) or float32; w: (K, N) int8
// row-major; scale: (N,) f32; out: (M, N) f32. k is cut into `splits`
// ranges of k_chunk (a multiple of 32; splits == ceil(K / k_chunk)); with
// splits > 1, ws holds splits * M * N f32 of scratch and a second launch
// reduces it. The Hopper route (design() == 2) takes splits == 1 only.
// Launches on ``stream``; returns cudaGetLastError().
extern "C" int qmatmul_launch(const void* x, int is_bf16, const int8_t* w, const float* scale,
                              float* out, float* ws, int M, int N, int K, int splits,
                              int k_chunk, void* stream) {
  if (M < 1 || N < 1 || K < 1 || splits < 1 || k_chunk < 1 || k_chunk % 32 != 0 ||
      (long long)(splits - 1) * k_chunk >= K || (long long)splits * k_chunk < K ||
      (splits > 1 && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (design(is_bf16, M, N, K, x, w) == 2) {
    if (splits != 1) return (int)cudaErrorInvalidValue;
    return launch_hopper(x, w, scale, out, M, N, K, st);
  }
  const bool small = M <= SMALL_M;
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

// design() above, for the wrapper to hold its table against
extern "C" int qmatmul_design(int is_bf16, int M, int N, int K, const void* x, const void* w) {
  return design(is_bf16, M, N, K, x, w);
}


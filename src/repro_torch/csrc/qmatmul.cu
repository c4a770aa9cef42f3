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
// Routes, fixed by dtype, M and alignment alone (design(), mirrored by
// kernels/qmatmul.kernel_design): never a fallback. "w TMA-loadable" means
// N % 16 == 0 and a 16-byte-aligned w (TMA's row stride and base rules).
//
//   qmm_decode   M <= 16, w TMA-loadable, bf16 or f32 x (any alignment)
//   qmm_hopper   M > 16, w TMA-loadable: bf16 x that TMA loads too (K % 8
//                == 0, 16-byte-aligned base), and f32 x through its three
//                bf16 planes (split_planes, one launch before it)
//   qmm_bf16     other bf16 x (w not TMA-loadable, or M > 16 with an x
//                TMA cannot load)
//   qmm_f32      other f32 x (w not TMA-loadable)
//
// f32 x on the tensor cores, exactly. An int8 weight (|q| <= 128) is exact
// in bf16, and an f32 x is the sum of three bf16 parts, x = hi + mid + lo:
// hi is x's top 16 bits (truncation: exact, never overflows), r = x - hi is
// exact, mid is r's top 16 bits and lo = r - mid, which has at most 8
// significant bits and is exact in bf16. Each part times q is exact in f32,
// so the three products summed in f32 (lo, mid, hi: small first) differ
// from the reference's f32 dot only in summation order, as the bf16 routes'
// products do. A non-finite x takes hi = x (a NaN kept a NaN) and mid = lo
// = 0, so an inf does not turn into inf - inf. Below about 2**-110 the lo
// plane goes subnormal in bf16 and x's bits under 2**-133 are dropped; at
// 2**-100 nothing is lost. No TF32 anywhere: that would cut x to 10
// mantissa bits, which the reference's f32 dot does not.
//
// qmm_decode (a decode step: the weight read, K N int8 bytes, is the whole
// cost). It computes out^T (N x M) = w^T . x^T, so N fills wgmma's 64-row
// side and M (padded to NP = 8 or 16) is the narrow one. 384 threads, two
// CTAs an SM; a CTA owns 128 columns of out and one k range, in a
// four-stage ring. Warp 0 keeps TMA loads of (N, K) int8 boxes (128 n x 64
// k, 128-byte swizzle) in flight, each as soon as its stage is free; warps
// 1-3 load x's 64-k slices with plain loads two tiles ahead (so x needs no
// alignment), split f32 into its three planes, and store them swizzled as
// K-major B operands of NP rows (rows past M zeroed once, never written).
// Warpgroups 1 and 2 take two k16 steps each of every tile: each thread
// reads its int8 bytes with 32-bit loads, byte-transposes and converts
// them in registers (qmm_hopper's conversion) into wgmma's A fragments, and
// runs wgmma.m64nNPk16 with A from registers, per step and 64-n block one
// product per plane into one accumulator. So that one load of a w row
// serves a thread's four rows, a thread's rows are four adjacent n (rows g
// and g + 8 of both 64-n blocks), and inside each k16 step the A
// fragment's k columns 2t, 2t + 1, 2t + 8, 2t + 9 are taken to be w's k
// rows 4t .. 4t + 3; x is stored in the same k order. No bf16 tile, no
// conversion warpgroup: the first form of this kernel (a bf16 tile in
// shared memory read as an MN-major A, kept in
// scripts/qmatmul_decode_forms.cu) read 7-9% slower at bf16. k is split
// across the CTAs of a thread-block cluster (S = 1, 2, 4 or 8, one k_chunk
// each): after a cluster barrier each CTA sums its slice of the 128 x M
// tile from every rank's shared memory (distributed shared memory) in rank
// order, applies the scale and stores. One launch, no scratch, no atomics:
// two launches give the same bits. The wrapper picks S as the fewest
// splits that give every SM a CTA.
//
// qmm_hopper<P> (the prefill route; P = 1 for bf16 x, 3 for f32 x's
// planes). 384 threads; a CTA owns BM rows x 128 columns of out and steps
// k by 64. Warpgroup 0 is the producer: one thread issues TMA loads
// (rank-2 maps over (rows, K) bf16 and (N, K) int8, encoded per launch
// through libcuda's entry point; both 128-byte swizzled, zeros past every
// edge) into an x ring (P boxes of BM rows x 128 B a stage) and an int8
// ring (64 k rows x 128 B), and the whole warpgroup converts each int8
// tile into a bf16 B ring: two 64-n blocks of 64 k rows x 128 B, 16-byte
// chunk c of row k at c ^ (k & 7) (the pattern TMA writes, so wgmma reads
// it as the V tile of flash_attention.cu). The conversion is exact (|q| <=
// 128 has at most 8 significant bits): q + 128 as the low byte of the f32
// 2**23, minus 2**23 + 128, truncated to its top half. The B tile is
// written by st.shared, the generic proxy, and read by wgmma, the async
// proxy, so each producer thread runs fence.proxy.async.shared::cta
// between its writes and its arrival on the stage's full barrier; without
// it wgmma may read stale bytes now and then. Warpgroups 1 and 2 are the
// consumers: each owns BM / 2 rows as m64 tiles and runs wgmma.m64n128k16
// with A (x) K-major and B MN-major (the transpose flag) from shared
// memory; they wait on the x and B full barriers and release both stages
// on the B empty barrier. P = 1: BM 256, four x stages, three B stages.
// P = 3: one converted B tile feeds three products, one per plane, into
// one accumulator; the three planes make a stage three times as large, so
// BM is 128 with three x stages and two B stages (200 KB of shared
// memory). The planes are one (3 M, K) bf16 tensor of 16-byte row pitch
// (split_planes writes it from x, 16 MB read and 24 MB written at M =
// 1,000 and K = 4,096); plane p's box starts at row p M + m0, and where it
// runs past M into the next plane those rows feed only rows of out that
// are not stored. No CTA-wide barrier in the k
// loop, no atomics, no split k. The tile order walks 8 m tiles at a time
// across the n tiles, so the CTAs in flight share a few x row blocks and w
// column blocks in L2.
//
// qmm_bf16 (mma.sync.m16n8k16, bf16 in, f32 accumulate; block tile BM x
// 128 x 32, 4 warps side by side along n, BM = 64 or 16 at M <= 16) and
// qmm_f32 (scalar fmaf on BM x 64 x 16 tiles, 256 threads, BM = 64 or 16):
// the routes of shapes TMA cannot load. The next k tile is loaded from
// device memory into registers while the current one is multiplied out of
// shared memory (two shared buffers, one barrier a tile). Rows past M,
// columns past N and k past K are zero-filled on load and never stored:
// 16-byte loads where the row is aligned and whole, element loads at the
// edges. At M <= 16 the wrapper splits k into `splits` ranges of k_chunk
// (a multiple of 32): block z writes its unscaled partial sums to ws[z] and
// splitk_reduce adds them in z order and applies the scale.
//
// Bound: at a decode step (M = 4, Qwen3-8B's 4,096 x 12,288 w_gate) the
// 50.3 MB int8 weight read (0.015 ms at 3.35 TB/s); at prefill (M = 8,192)
// the 8.25e11 flops (2 x 8,192 x 4,096 x 12,288; 0.834 ms at 989 TFLOP/s
// on the tensor cores), which qmm_hopper is built for; f32 x at f32
// accuracy is three such bf16 products. Per 256 x 128 x 64 step (P = 1)
// qmm_hopper moves 160 KB through shared memory (the TMA writes, the
// conversion's reads and writes, and wgmma's operand reads, B once per m64
// tile) for 2.1 M multiply-adds: at 128 bytes a clock, shared memory alone
// would hold it to about 80% of the tensor cores' rate by that count.

#include <cooperative_groups.h>
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
constexpr int BKH = 64;        // k step: one 128-byte swizzle atom of bf16 x
constexpr int GROUP_M = 8;     // m tiles walked together in the tile order (L2 reuse)
constexpr int THREADS_H = 384;  // warpgroup 0 loads and converts, warpgroups 1 and 2 multiply
constexpr uint32_t W8_BYTES = BKH * HT;       // 8 KB: 64 k rows x 128 B
constexpr uint32_t B_BYTES = BKH * HT * 2;    // 16 KB: two 64-n blocks of 64 k rows x 128 B
constexpr uint32_t B_BLOCK = BKH * 128;       // one 64-n block of the B tile

// qmm_hopper's tiles and rings by x's planes: P = 1 (bf16 x) 256 rows, four
// x stages of 32 KB and three B stages; P = 3 (f32 x's planes) 128 rows,
// three x stages of 48 KB and two B stages
template <int P>
struct HopperTile {
  static constexpr int BM = P == 1 ? 256 : 128;   // m rows of a CTA tile
  static constexpr int MT = BM / 128;             // m64 tiles of a consumer warpgroup
  static constexpr int XST = P == 1 ? 4 : 3;      // stages of the x and int8 w rings
  static constexpr int BST = P == 1 ? 3 : 2;      // stages of the bf16 B ring
  static constexpr uint32_t PLANE = BM * BKH * 2;  // one plane's box: BM rows x 128 B
  static constexpr uint32_t X_BYTES = P * PLANE;
  static constexpr uint32_t STG_OFF = XST * X_BYTES;
  static constexpr uint32_t BS_OFF = STG_OFF + XST * W8_BYTES;
  static constexpr uint32_t BAR_OFF = BS_OFF + BST * B_BYTES;  // 2 (XST + BST) mbarriers
  static constexpr size_t SMEM = BAR_OFF + 16 * (XST + BST) + 1024;
};

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

// x tile kt (P boxes of 64 k x BM rows, plane p's at row p M + m0) into
// its stage of the x ring
template <int P>
__device__ __forceinline__ void load_x(uint32_t xs, uint32_t x_full, const CUtensorMap* tmx,
                                       int kt, int m0, int M) {
  using T = HopperTile<P>;
  const int s = kt % T::XST;
  mbar_expect_tx(x_full + 8 * s, T::X_BYTES);
#pragma unroll
  for (int p = 0; p < P; ++p)
    tma_load2(xs + s * T::X_BYTES + p * T::PLANE, tmx, kt * BKH, p * M + m0, x_full + 8 * s);
}

// int8 w tile kt (one box of 128 n x 64 k) into stage s of the int8 ring
__device__ __forceinline__ void load_w(uint32_t stg, uint32_t w_full, const CUtensorMap* tmw,
                                       int kt, int s, int n0) {
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

template <int P>
__global__ void __launch_bounds__(THREADS_H, 1)
    qmm_hopper(const __grid_constant__ CUtensorMap tmx, const __grid_constant__ CUtensorMap tmw,
               const float* __restrict__ scale, float* __restrict__ out, int M, int N, int K) {
  using T = HopperTile<P>;
  constexpr int XST = T::XST, BST = T::BST, MT = T::MT;
  constexpr int LX = XST - BST;  // x loads run LX tiles ahead of the conversion
  constexpr int LW = XST - 1;    // int8 w loads LW tiles ahead
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t base =
      (static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw)) + 1023u) & ~1023u;
  const uint32_t XS = base, STG = base + T::STG_OFF, BS = base + T::BS_OFF;
  // mbarriers: x full x XST, int8 w full x XST, B full x BST, B empty x BST
  const uint32_t x_full = base + T::BAR_OFF, w_full = x_full + 8 * XST;
  const uint32_t b_full = w_full + 8 * XST, b_empty = b_full + 8 * BST;
  // this CTA's tile: GROUP_M m tiles at a time, n tiles across each group,
  // so the CTAs in flight share a few x row blocks and w column blocks in L2
  const int tm = (M + T::BM - 1) / T::BM, tn = (N + HT - 1) / HT;
  const int first = ((int)blockIdx.x / (GROUP_M * tn)) * GROUP_M;
  const int r = (int)blockIdx.x % (GROUP_M * tn), gm = min(tm - first, GROUP_M);
  const int m0 = (first + r % gm) * T::BM, n0 = (r / gm) * HT;
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
      for (int t = 0; t < LX && t < n_kt; ++t) load_x<P>(XS, x_full, &tmx, t, m0, M);
      for (int t = 0; t < LW && t < n_kt; ++t) load_w(STG, w_full, &tmw, t, t % XST, n0);
    }
    for (int kt = 0; kt < n_kt; ++kt) {
      const int bs = kt % BST;
      // the consumers have released tile kt - BST: its B stage is free, and
      // so is the x stage of tile kt + LX (that of tile kt + LX - XST)
      if (kt >= BST) mbar_wait(b_empty + 8 * bs, ((kt / BST) & 1) ^ 1);
      if (tid == 0) {
        if (kt + LX < n_kt) load_x<P>(XS, x_full, &tmx, kt + LX, m0, M);
        // its int8 stage held tile kt - 1, converted in the last iteration
        if (kt + LW < n_kt) load_w(STG, w_full, &tmw, kt + LW, (kt + LW) % XST, n0);
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
    // consumers: warpgroup cw owns rows cw BM / 2 .. + BM / 2 - 1 of the
    // tile, as MT m64 tiles, each a 64 x 128 f32 accumulator
    const int cw = wg - 1, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    float acc[MT][64];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[mt][i] = 0.f;
    for (int kt = 0; kt < n_kt; ++kt) {
      const uint32_t xs = XS + (kt % XST) * T::X_BYTES, bs = BS + (kt % BST) * B_BYTES;
      mbar_wait(x_full + 8 * (kt % XST), (kt / XST) & 1);
      mbar_wait(b_full + 8 * (kt % BST), (kt / BST) & 1);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int i = 0; i < 64; ++i) reg_fence(acc[mt][i]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BKH / 16; ++kk) {
        // B: k rows kk 16 .. + 15, MN-major (leading byte offset: the next 64
        // n; stride: 8 k rows); A: K-major, 32 bytes a k16 step in the atom;
        // with three planes lo, mid, hi in turn (small first)
        const uint64_t db = sw128_desc(bs + kk * (16 * 128), B_BLOCK, 1024);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int p = P - 1; p >= 0; --p) {
            const uint64_t da = sw128_desc(
                xs + p * T::PLANE + (cw * MT + mt) * (64 * 128) + kk * 32, 16, 1024);
            wgmma_ss_n128_tb(acc[mt], da, db);
          }
      }
      wgmma_commit();
      wgmma_wait0();
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int i = 0; i < 64; ++i) reg_fence(acc[mt][i]);
      __syncwarp();
      if (lane == 0) mbar_arrive(b_empty + 8 * (kt % BST));
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
      store_tile(acc[mt], scale, out, M, N, m0 + (cw * MT + mt) * 64 + warp * 16 + (lane >> 2),
                 n0 + 2 * (lane & 3));
  }
}

// ------------------------------------------ f32 x as three bf16 planes

// v = hi + mid + lo exactly (each a bf16, as its bits): hi and mid are
// truncations to 16 bits, lo the rest (at most 8 significant bits); a
// non-finite v is hi alone (a NaN kept a NaN by its quiet bit)
__device__ __forceinline__ void split3(float v, uint32_t& hi, uint32_t& mid, uint32_t& lo) {
  const uint32_t b = __float_as_uint(v);
  if ((b & 0x7F800000u) == 0x7F800000u) {
    hi = (b >> 16) | ((b & 0x007FFFFFu) ? 0x0040u : 0u);
    mid = lo = 0u;
    return;
  }
  const float r = __fsub_rn(v, __uint_as_float(b & 0xFFFF0000u));
  const uint32_t rb = __float_as_uint(r);
  hi = b >> 16;
  mid = rb >> 16;
  lo = __float_as_uint(__fsub_rn(r, __uint_as_float(rb & 0xFFFF0000u))) >> 16;
}

// four f32 -> two words of each plane (element 0 in the low half)
__device__ __forceinline__ void split3x4(float4 v, uint32_t (&o)[3][2]) {
  uint32_t h[4], m[4], l[4];
  split3(v.x, h[0], m[0], l[0]);
  split3(v.y, h[1], m[1], l[1]);
  split3(v.z, h[2], m[2], l[2]);
  split3(v.w, h[3], m[3], l[3]);
  o[0][0] = h[0] | (h[1] << 16);
  o[0][1] = h[2] | (h[3] << 16);
  o[1][0] = m[0] | (m[1] << 16);
  o[1][1] = m[2] | (m[3] << 16);
  o[2][0] = l[0] | (l[1] << 16);
  o[2][1] = l[2] | (l[3] << 16);
}

// x (M, K) f32 -> planes (3 M, Kp) bf16, plane p's row m at row p M + m
// (Kp = K rounded up to 8, so a row is a whole 16-byte multiple; the
// padding holds zeros); a thread takes 8 k of one row
__global__ void __launch_bounds__(256)
    split_planes(const float* __restrict__ x, uint16_t* __restrict__ planes, int M, int K,
                 int Kp, int vec_x) {
  const int cpr = Kp / 8;
  const long long total = (long long)M * cpr;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < total; i += stride) {
    const int m = (int)(i / cpr), c = (int)(i % cpr) * 8;
    uint32_t a[3][2], b[3][2];
    split3x4(load_x4(x, M, K, m, c, K, vec_x), a);
    split3x4(load_x4(x, M, K, m, c + 4, K, vec_x), b);
#pragma unroll
    for (int p = 0; p < 3; ++p)
      *reinterpret_cast<uint4*>(planes + ((long long)p * M + m) * Kp + c) =
          make_uint4(a[p][0], a[p][1], b[p][0], b[p][1]);
  }
}

// --------------------------------------------- decode (M <= 16) on Hopper

constexpr int MAX_CLUSTER = 8;  // the portable cluster size

// a decode CTA's shared memory: DST stages, each an int8 w tile and P x
// planes of NP rows x 128 B; the 128 x NP partial
template <int NP, int P>
struct DecodeTile {
  static constexpr int DST = 4;              // stages of the ring
  static constexpr uint32_t XT = NP * 128;   // one plane's x tile
  static constexpr uint32_t X_OFF = DST * W8_BYTES;
  static constexpr uint32_t RED_OFF = X_OFF + DST * P * XT;
  static constexpr uint32_t BAR_OFF = RED_OFF + NP * HT * 4;  // 3 DST mbarriers
  static constexpr size_t SMEM = BAR_OFF + 8 * 3 * DST + 1024;
};

// d (64 x NP, f32) += A (64 x 16, bf16 from registers: the m16n8k16 A
// layout in each warp's 16 rows) . B (16 x NP, bf16 from shared memory,
// K-major)
template <int NP>
__device__ __forceinline__ void wgmma_rs(float (&d)[NP / 2], const uint32_t (&a)[4], uint64_t db);

template <>
__device__ __forceinline__ void wgmma_rs<8>(float (&d)[4], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "%8, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<16>(float (&d)[8], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t ld_shared4(uint32_t a) {
  uint32_t v;
  asm volatile("ld.shared.u32 %0, [%1];\n" : "=r"(v) : "r"(a) : "memory");
  return v;
}

// The decode route's k order inside a k16 step. Thread t of a quad holds
// the A fragment's k columns 2t, 2t + 1, 2t + 8, 2t + 9; they are taken to
// be w's k rows 4t .. 4t + 3 of the step, so that one 32-bit load of a w
// row serves them. B (x) follows: of the step's eight physical bf16 pairs
// (2i, 2i + 1), chunk 0 (logical k 0..7) holds pairs 0, 2, 4, 6 and chunk
// 1 (logical 8..15) pairs 1, 3, 5, 7.
__device__ __forceinline__ void st_shared4(uint32_t a, uint32_t v) {
  asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(a), "r"(v) : "memory");
}

// 4 bf16 of x's row `row`, columns [c, c + 4); zero past K
__device__ __forceinline__ uint2 load_x4h(const __nv_bfloat16* x, int K, int row, int c,
                                          bool vec) {
  uint2 r = make_uint2(0u, 0u);
  const __nv_bfloat16* p = x + (long long)row * K + c;
  if (vec && c + 4 <= K) return *reinterpret_cast<const uint2*>(p);
  __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&r);
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (c + j < K) e[j] = p[j];
  return r;
}

// four rows of w (k 4t .. 4t + 3), each a word of four int8 n values
// (n0, n0 + 1, n0 + 2, n0 + 3) -> the A fragments of the two 64-n blocks:
// row g of block j is n0 + 2 j, row g + 8 is n0 + 2 j + 1
__device__ __forceinline__ void a_frags(uint32_t w0, uint32_t w1, uint32_t w2, uint32_t w3,
                                        uint32_t (&a0)[4], uint32_t (&a1)[4]) {
  // byte-transpose: r_c holds n0 + c at k 4t .. 4t + 3
  const uint32_t lo01 = __byte_perm(w0, w1, 0x5140), lo23 = __byte_perm(w2, w3, 0x5140);
  const uint32_t hi01 = __byte_perm(w0, w1, 0x7362), hi23 = __byte_perm(w2, w3, 0x7362);
  const uint32_t r0 = __byte_perm(lo01, lo23, 0x5410), r1 = __byte_perm(lo01, lo23, 0x7632);
  const uint32_t r2 = __byte_perm(hi01, hi23, 0x5410), r3 = __byte_perm(hi01, hi23, 0x7632);
  // fragment registers: (row g, k 2t..), (row g + 8, k 2t..), (row g, k
  // 2t + 8..), (row g + 8, k 2t + 8..), each two bf16
  i8x4_to_bf16(r0, a0[0], a0[2]);
  i8x4_to_bf16(r1, a0[1], a0[3]);
  i8x4_to_bf16(r2, a1[0], a1[2]);
  i8x4_to_bf16(r3, a1[1], a1[3]);
}

// 384 threads: warpgroup 0 loads (warp 0 TMA for w, warps 1-3 plain loads
// for x), warpgroups 1 and 2 convert w in registers and multiply, c taking
// k16 steps 2 c and 2 c + 1 of each tile
template <int NP, int P>
__global__ void __launch_bounds__(384, 2)
    qmm_decode(const __grid_constant__ CUtensorMap tmw, const void* __restrict__ xv,
               const float* __restrict__ scale, float* __restrict__ out, int M, int N, int K,
               int k_chunk, int vec_x) {
  namespace cg = cooperative_groups;
  using T = DecodeTile<NP, P>;
  constexpr int DST = T::DST;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t WS = base, XS = base + T::X_OFF;
  float* red = reinterpret_cast<float*>(smem_raw + (base - raw) + T::RED_OFF);
  // mbarriers: w full (TMA), x full (the loaders), empty (the consumers)
  const uint32_t w_full = base + T::BAR_OFF, x_full = w_full + 8 * DST;
  const uint32_t empty = x_full + 8 * DST;
  cg::cluster_group cluster = cg::this_cluster();
  const int S = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int n0 = (int)(blockIdx.x / S) * HT;
  const int kt0 = rank * (k_chunk / BKH);
  const int n_kt = max(0, min(k_chunk / BKH, (K + BKH - 1) / BKH - kt0));
  const int tid = threadIdx.x;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < DST; ++s) {
      mbar_init(w_full + 8 * s, 1);
      mbar_init(x_full + 8 * s, 96);  // every x thread, after its proxy fence
      mbar_init(empty + 8 * s, 8);     // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid < 32) {
    // warp 0: the int8 tiles' TMA loads, each as soon as its stage is free
    for (int i = 0; i < n_kt; ++i) {
      const int s = i % DST;
      // the consumers have released tile i - DST: this stage is free
      if (i >= DST) mbar_wait(empty + 8 * s, ((i / DST) & 1) ^ 1);
      if (tid == 0) load_w(WS, w_full, &tmw, kt0 + i, s, n0);
    }
  } else if (tid < 128) {
    // warps 1-3: x. A slot e = 16 m + 4 q + u is 4 k of row m at 16 q + 4 u:
    // physical pairs 2 u and 2 u + 1 of k16 step q, which go to word u of
    // the step's chunks 0 and 1 (the decode k order above). Each
    // thread's slots are loaded two tiles ahead into registers (an L2
    // round trip), split into planes for f32, and stored; the planes' rows
    // past M stay zero (written once here, never again)
    const int xt = tid - 32;
    for (uint32_t o = xt * 16; o < DST * P * T::XT; o += 96 * 16) st_shared16(XS + o, 0u, 0u, 0u, 0u);
    constexpr int SLOTS = 3;  // 16 rows x 16 slots over 96 threads
    struct XRegs {
      uint4 v[SLOTS];
    };
    auto load_xr = [&](int i, XRegs& r) {
#pragma unroll
      for (int j = 0; j < SLOTS; ++j) {
        const int e = xt + 96 * j, m = e >> 4, k = (kt0 + i) * BKH + 4 * (e & 15);
        r.v[j] = make_uint4(0u, 0u, 0u, 0u);
        if (i >= n_kt || m >= M) continue;
        if (P == 1) {
          const uint2 b = load_x4h(static_cast<const __nv_bfloat16*>(xv), K, m, k, vec_x);
          r.v[j].x = b.x;
          r.v[j].y = b.y;
        } else {
          const float4 f = load_x4(static_cast<const float*>(xv), M, K, m, k, K, vec_x);
          r.v[j] = make_uint4(__float_as_uint(f.x), __float_as_uint(f.y), __float_as_uint(f.z),
                              __float_as_uint(f.w));
        }
      }
    };
    auto step = [&](int i, XRegs& r) {
      const int s = i % DST;
      if (i >= DST) mbar_wait(empty + 8 * s, ((i / DST) & 1) ^ 1);
#pragma unroll
      for (int j = 0; j < SLOTS; ++j) {
        const int e = xt + 96 * j, m = e >> 4, q = (e >> 2) & 3, u = e & 3, sw = m & 7;
        if (m >= M) continue;
        const uint32_t at0 = XS + s * P * T::XT + m * 128 + (((2 * q) ^ sw) << 4) + 4 * u;
        const uint32_t at1 = XS + s * P * T::XT + m * 128 + (((2 * q + 1) ^ sw) << 4) + 4 * u;
        if (P == 1) {
          st_shared4(at0, r.v[j].x);
          st_shared4(at1, r.v[j].y);
        } else {
          uint32_t o[3][2];
          split3x4(make_float4(__uint_as_float(r.v[j].x), __uint_as_float(r.v[j].y),
                               __uint_as_float(r.v[j].z), __uint_as_float(r.v[j].w)),
                   o);
#pragma unroll
          for (int p = 0; p < P; ++p) {
            st_shared4(at0 + p * T::XT, o[p][0]);
            st_shared4(at1 + p * T::XT, o[p][1]);
          }
        }
      }
      // generic-proxy writes read by wgmma (the async proxy): fence first
      fence_proxy_async();
      mbar_arrive(x_full + 8 * s);
      load_xr(i + 2, r);
    };
    XRegs xa, xb;
    load_xr(0, xa);
    load_xr(1, xb);
    for (int i = 0; i < n_kt; i += 2) {
      step(i, xa);
      if (i + 1 < n_kt) step(i + 1, xb);
    }
  } else {
    // consumers: warpgroup c (1 or 2) converts and multiplies k16 steps
    // 2 c - 2 and 2 c - 1 of every tile. A thread's rows are n0 + 4 (8 w +
    // g) + {0, 1, 2, 3}: rows g and g + 8 of both 64-row blocks j, so one
    // 32-bit load of a w row gives all four
    const int c = (tid >> 7) - 1, warp = (tid >> 5) & 3, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const uint32_t nb = 32 * warp + 4 * g;  // the thread's byte in a 128-n row
    float acc[2][2][NP / 2];  // k16 step h, block j
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < NP / 2; ++e) acc[h][j][e] = 0.f;
    for (int i = 0; i < n_kt; ++i) {
      const int s = i % DST;
      const uint32_t ws = WS + s * W8_BYTES, xs = XS + s * P * T::XT;
      mbar_wait(w_full + 8 * s, (i / DST) & 1);
      uint32_t a[2][2][4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t wr[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int k = (2 * c + h) * 16 + 4 * t + r;
          wr[r] = ld_shared4(ws + k * 128 + ((((nb >> 4) ^ (k & 7))) << 4) + (nb & 15));
        }
        a_frags(wr[0], wr[1], wr[2], wr[3], a[h][0], a[h][1]);
      }
      mbar_wait(x_full + 8 * s, (i / DST) & 1);
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < NP / 2; ++e) reg_fence(acc[h][j][e]);
      wgmma_fence();
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int p = P - 1; p >= 0; --p)  // the planes lo, mid, hi (small first)
            wgmma_rs<NP>(acc[h][j], a[h][j],
                         sw128_desc(xs + p * T::XT + (2 * c + h) * 32, 16, 1024));
      wgmma_commit();
      wgmma_wait0();  // the A registers are rewritten next tile
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < NP / 2; ++e) reg_fence(acc[h][j][e]);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * s);
    }
    // the partial into red[m HT + n], k16 steps summed in order: warpgroup
    // 1 writes steps 0 + 1, then warpgroup 2 adds steps 2 + 3 (the m64nNP C
    // layout per warp: element 4 b + 2 r + e at row 16 warp + g + 8 r, i.e.
    // n = 4 (8 warp + g) + 2 j + r, column m = 8 b + 2 t + e)
    if (c == 1) asm volatile("bar.sync 2, 256;\n" ::: "memory");
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int b = 0; b < NP / 8; ++b)
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int q = 4 * b + 2 * r + e;
            float* o = red + (8 * b + 2 * t + e) * HT + nb + 2 * j + r;
            const float v = __fadd_rn(acc[0][j][q], acc[1][j][q]);
            *o = c == 0 ? v : __fadd_rn(*o, v);
          }
    if (c == 0) asm volatile("bar.sync 2, 256;\n" ::: "memory");
  }
  // every rank's partial is in place: rank `rank` sums columns rank HT / S
  // .. + HT / S - 1 over the ranks in rank order, scales and stores them
  cluster.sync();
  const int cols = HT / S, c0 = rank * cols;
  for (int e = tid; e < M * cols; e += 384) {
    const int m = e / cols, n = c0 + e % cols;
    if (n0 + n >= N) continue;
    float s = *cluster.map_shared_rank(red + m * HT + n, 0);
    for (int q = 1; q < S; ++q) s = __fadd_rn(s, *cluster.map_shared_rank(red + m * HT + n, q));
    out[(long long)m * N + n0 + n] = __fmul_rn(s, scale[n0 + n]);
  }
  cluster.sync();  // every partial stays in place until its readers are done
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

// x_rows x K bf16 at x_pitch bytes a row: bf16 x (M rows), or f32 x's
// three planes (3 M rows)
template <int P>
int launch_hopper(const void* x, int x_rows, uint64_t x_pitch, const int8_t* w,
                  const float* scale, float* out, int M, int N, int K, cudaStream_t st) {
  using T = HopperTile<P>;
  const long long tiles = (long long)((M + T::BM - 1) / T::BM) * ((N + HT - 1) / HT);
  if (tiles > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  CUtensorMap tmx, tmw;
  int rc = make_map(&tmx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, K, x_rows, x_pitch, BKH, T::BM);
  if (rc == 0) rc = make_map(&tmw, CU_TENSOR_MAP_DATA_TYPE_UINT8, w, N, K, (uint64_t)N, HT, BKH);
  if (rc != 0) return rc;
  cudaError_t e = cudaFuncSetAttribute(qmm_hopper<P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)T::SMEM);
  if (e != cudaSuccess) return (int)e;
  qmm_hopper<P><<<(unsigned)tiles, THREADS_H, T::SMEM, st>>>(tmx, tmw, scale, out, M, N, K);
  return (int)cudaGetLastError();
}

// one launch: grid (N / 128 tiles x S), one cluster of S CTAs a tile, rank
// r taking k_chunk / 64 k tiles from r k_chunk
template <int NP, int P>
int launch_decode(const void* x, const int8_t* w, const float* scale, float* out, int M, int N,
                  int K, int splits, int k_chunk, int vec_x, cudaStream_t st) {
  using T = DecodeTile<NP, P>;
  CUtensorMap tmw;
  const int rc = make_map(&tmw, CU_TENSOR_MAP_DATA_TYPE_UINT8, w, N, K, (uint64_t)N, HT, BKH);
  if (rc != 0) return rc;
  // past 48 KB the kernel needs a larger dynamic shared memory limit, set
  // once for each device
  static bool set[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= 64 || !set[dev]) {
    e = cudaFuncSetAttribute(qmm_decode<NP, P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)T::SMEM);
    if (e != cudaSuccess) return (int)e;
    if (dev < 64) set[dev] = true;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(((N + HT - 1) / HT) * splits));
  cfg.blockDim = dim3(384);
  cfg.dynamicSmemBytes = T::SMEM;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, qmm_decode<NP, P>, tmw, x, scale, out, M, N, K, k_chunk, vec_x);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <int NP, int P>
int decode_clusters(int splits) {
  using T = DecodeTile<NP, P>;
  if (cudaFuncSetAttribute(qmm_decode<NP, P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)T::SMEM) != cudaSuccess)
    return -1;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)splits * 132);
  cfg.blockDim = dim3(384);
  cfg.dynamicSmemBytes = T::SMEM;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = -1;
  return cudaOccupancyMaxActiveClusters(&n, qmm_decode<NP, P>, &cfg) == cudaSuccess ? n : -1;
}

constexpr int SMALL_M = 16;  // M at or below this: a decode step

// The kernel a call runs, fixed by dtype, shape and alignment alone:
// 3 qmm_decode (M <= 16, w TMA-loadable: N % 16 == 0, 16-byte-aligned
// base), 2 qmm_hopper (bf16 x, M > 16, w and x TMA-loadable: K % 8 == 0,
// 16-byte-aligned base), 4 qmm_hopper on f32 x's planes (f32 x, M > 16, w
// TMA-loadable), 1 qmm_bf16 (other bf16), 0 qmm_f32 (other f32).
// kernels/qmatmul.kernel_design is the same table.
int design(int is_bf16, int M, int N, int K, const void* x, const void* w) {
  const bool w_tma = N % 16 == 0 && aligned16(w);
  if (!w_tma) return is_bf16 ? 1 : 0;
  if (M <= SMALL_M) return 3;
  if (!is_bf16) return 4;
  return (K % 8 == 0 && aligned16(x)) ? 2 : 1;
}

}  // namespace

// x: (M, K) row-major, bfloat16 (is_bf16 = 1) or float32; w: (K, N) int8
// row-major; scale: (N,) f32; out: (M, N) f32. k is cut into `splits`
// ranges of k_chunk (splits == ceil(K / k_chunk)). By design():
//   qmm_decode: splits is the cluster size (1, 2, 4 or 8), k_chunk a
//     multiple of 64; no scratch.
//   qmm_hopper: splits == 1; on f32 x, ws holds 3 M Kp bf16 (Kp = K
//     rounded up to 8) for the planes, written by a launch before it.
//   qmm_bf16 / qmm_f32: k_chunk a multiple of 32; with splits > 1, ws holds
//     splits M N f32 of partials and a second launch reduces them.
// Launches on ``stream``; returns cudaGetLastError().
extern "C" int qmatmul_launch(const void* x, int is_bf16, const int8_t* w, const float* scale,
                              float* out, void* ws, int M, int N, int K, int splits,
                              int k_chunk, void* stream) {
  if (M < 1 || N < 1 || K < 1 || splits < 1 || k_chunk < 1 ||
      (long long)(splits - 1) * k_chunk >= K || (long long)splits * k_chunk < K)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int d = design(is_bf16, M, N, K, x, w);
  if (d == 2 || d == 4) {
    if (splits != 1) return (int)cudaErrorInvalidValue;
    if (d == 2)
      return launch_hopper<1>(x, M, (uint64_t)K * 2, w, scale, out, M, N, K, st);
    if (ws == nullptr || !aligned16(ws) || 3LL * M > 0x7FFFFFFFLL)
      return (int)cudaErrorInvalidValue;
    const int Kp = (K + 7) / 8 * 8;
    const long long chunks = (long long)M * (Kp / 8);
    long long blocks = (chunks + 255) / 256;
    if (blocks > 8192) blocks = 8192;
    split_planes<<<(unsigned)blocks, 256, 0, st>>>(static_cast<const float*>(x),
                                                   static_cast<uint16_t*>(ws), M, K, Kp,
                                                   aligned16(x) && K % 4 == 0);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    return launch_hopper<3>(ws, 3 * M, (uint64_t)Kp * 2, w, scale, out, M, N, K, st);
  }
  if (d == 3) {
    if (splits > MAX_CLUSTER || (splits & (splits - 1)) != 0 || k_chunk % BKH != 0)
      return (int)cudaErrorInvalidValue;
    const int np = M <= 8 ? 8 : 16;
    if (is_bf16) {
      const int vec_x = aligned16(x) && K % 8 == 0;
      return np == 8 ? launch_decode<8, 1>(x, w, scale, out, M, N, K, splits, k_chunk, vec_x, st)
                     : launch_decode<16, 1>(x, w, scale, out, M, N, K, splits, k_chunk, vec_x, st);
    }
    const int vec_x = aligned16(x) && K % 4 == 0;
    return np == 8 ? launch_decode<8, 3>(x, w, scale, out, M, N, K, splits, k_chunk, vec_x, st)
                   : launch_decode<16, 3>(x, w, scale, out, M, N, K, splits, k_chunk, vec_x, st);
  }
  if (k_chunk % 32 != 0 || (splits > 1 && ws == nullptr)) return (int)cudaErrorInvalidValue;
  float* wsf = static_cast<float*>(ws);
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
      qmm_bf16<1><<<grid, T16, 0, st>>>(xb, w, scale, out, wsf, M, N, K, k_chunk, vec_x, vec_w);
    } else {
      qmm_bf16<4><<<grid, T16, 0, st>>>(xb, w, scale, out, wsf, M, N, K, k_chunk, vec_x, vec_w);
    }
  } else {
    const float* xf = static_cast<const float*>(x);
    const int vec_x = aligned16(x) && K % 4 == 0;
    const dim3 grid((N + BN32 - 1) / BN32, (unsigned)m_tiles, splits);
    if (small) {
      qmm_f32<1><<<grid, T32, 0, st>>>(xf, w, scale, out, wsf, M, N, K, k_chunk, vec_x, vec_w);
    } else {
      qmm_f32<4><<<grid, T32, 0, st>>>(xf, w, scale, out, wsf, M, N, K, k_chunk, vec_x, vec_w);
    }
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  const long long mn = (long long)M * N;
  long long blocks = (mn + 255) / 256;
  if (blocks > 8192) blocks = 8192;
  splitk_reduce<<<(unsigned)blocks, 256, 0, st>>>(wsf, splits, mn, N, scale, out);
  return (int)cudaGetLastError();
}

// design() above, for the wrapper to hold its table against
extern "C" int qmatmul_design(int is_bf16, int M, int N, int K, const void* x, const void* w) {
  return design(is_bf16, M, N, K, x, w);
}

// clusters of `splits` decode CTAs (NP = 8 or 16 rows, bf16 or f32 x) the
// device holds at once (cudaOccupancyMaxActiveClusters), or -1 on an error
extern "C" int qmatmul_decode_clusters(int is_bf16, int np, int splits) {
  if (is_bf16) return np == 8 ? decode_clusters<8, 1>(splits) : decode_clusters<16, 1>(splits);
  return np == 8 ? decode_clusters<8, 3>(splits) : decode_clusters<16, 3>(splits);
}

// Flash attention forward, causal (top-left) or not, Sq != Sk allowed: bf16
// through mma.sync tensor-core tiles, f32 through scalar f32 FMAs.
//
// Replaces the TPU kernel flash_attention (src/repro/kernels/
// flash_attention.py:87, reached through ops.flash_mha). That kernel walks a
// (batch*heads, q tile, k tile) grid with the k axis innermost and
// sequential, carrying the running max m, the denominator l and the output
// accumulator in VMEM scratch from one grid step to the next. A GPU grid
// runs its blocks in parallel, so here one CTA owns one (batch*head, query
// tile) and loops over the key tiles itself, with m, l and the accumulator
// in registers:
//
//   s    = (q . k) in f32 * scale;  masked -> -1e30, where masked is
//          key >= Sk, or (causal) key > row (top-left: both from 0)
//   m'   = max(m, rowmax s);  p = exp(s - m');  corr = exp(m - m')
//   l'   = l * corr + rowsum p
//   acc' = acc * corr + round_to_v_dtype(p) . v        (f32 accumulate)
//   out  = acc / max(l, 1e-30) in q's dtype
//
// Key tiles are 128 keys, the TPU kernel's BK, so every query row sees the
// same sequence of running maxima as the TPU kernel and the plain version
// in kernels/flash_attention.py; the three differ only by summation order
// inside a tile. A CTA's last key tile is (Sk - 1) / 128 without the causal
// mask, and min(the CTA's last row, Sk - 1) / 128 with it: a later tile is
// entirely above every row's diagonal, gives p = exp(-1e30 - m) = 0 and
// corr = 1 exactly, so skipping it changes no bit. With the causal mask and
// Sq > Sk, rows at or past Sk see every key.
//
// Layout: q and o are the model's (B, Sq, H, D), k and v (B, Sk, KV, D).
// Query head h reads KV head h / (H / KV): the GQA repeat is an index, not a
// copy. Rows at or past Sq and keys at or past Sk are zero-filled on load;
// such rows are never stored and such keys are masked, so the ragged edges
// need no padding. D is one of 32, 64, 80, 96, 112, 128 (a multiple of 16:
// the m16n8k16 k-step and ldmatrix); the wrapper zero-pads other widths.
//
// bf16: 4 warps, 64 query rows per CTA (16 per warp). Q, one K tile and one
// V tile sit in shared memory (row pitch D + 8: conflict-free ldmatrix at
// every D above), filled by cp.async; the next K tile loads while the
// softmax and PV of the current one run, the next V tile while the next
// QK^T runs. S = Q K^T and O += P V are mma.sync.m16n8k16 (bf16 in, f32
// accumulate); P goes from the S accumulators to A fragments in registers,
// rounded to bf16 on the way (the reference's p.astype(v.dtype)). Per
// thread: 64 f32 scores and D / 2 f32 output accumulators.
//
// f32: 128 threads, 32 query rows per CTA, 4 threads per row; each thread
// scores 32 of the tile's 128 keys with scalar fmaf (no TF32), the row's p
// goes through shared memory, and each thread accumulates D / 4 output
// columns of its row.
//
// Bound: at the serving shapes (Qwen3-8B prefill, B = 4, S = 2048, H = 32,
// KV = 8, D = 128) the causal work is 4 D S (S + 1) / 2 flops per head,
// 1.375e11 in all, 0.139 ms at 989 TFLOP/s, against 168 MB of q, k, v and
// o (0.050 ms at 3.35 TB/s): bound by the tensor cores' operations, as is
// every case the repository's configs give. This design uses mma.sync (not
// wgmma) and exact expf, so it sits well below that bound; wgmma and TMA
// are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int BK = 128;  // keys per tile

// ------------------------------------------------------------------ bf16

constexpr int BQ16 = 64;
constexpr int THREADS16 = 128;

template <int D>
struct Tile16 {
  static constexpr int PITCH = D + 8;  // bf16 per shared row
  static constexpr size_t BYTES = (size_t)(BQ16 + 2 * BK) * PITCH * sizeof(__nv_bfloat16);
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

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
__device__ __forceinline__ void mma16816(float* c, uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

// R rows of D bf16 from rows r0.. of a (row stride `stride`) into shared
// memory; rows >= S are zero-filled.
template <int D, int R>
__device__ __forceinline__ void load_tile16(__nv_bfloat16* sm, const __nv_bfloat16* g,
                                            long long stride, int r0, int S) {
  constexpr int CPR = D / 8;  // 16-byte chunks per row
  constexpr int PITCH = Tile16<D>::PITCH;
#pragma unroll
  for (int c = threadIdx.x; c < R * CPR; c += THREADS16) {
    const int r = c / CPR, col = (c % CPR) * 8;
    const int row = r0 + r;
    const bool ok = row < S;
    const __nv_bfloat16* src = ok ? g + (long long)row * stride + col : g;
    cp_async16(sm + r * PITCH + col, src, ok ? 16 : 0);
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS16)
    flash_fwd_bf16(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o, int Sq,
                   int Sk, int H, int KV, int causal, float scale) {
  constexpr int PITCH = Tile16<D>::PITCH;
  constexpr int NS = BK / 8;  // score n-tiles per warp row block
  constexpr int NO = D / 8;   // output n-tiles
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + BQ16 * PITCH;
  __nv_bfloat16* Vs = Ks + BK * PITCH;

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int kvh = h / (H / KV);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ16;  // longest rows first
  const long long qstride = (long long)H * D, kstride = (long long)KV * D;
  const __nv_bfloat16* qg = q + ((long long)b * Sq * H + h) * D;
  const __nv_bfloat16* kg = k + ((long long)b * Sk * KV + kvh) * D;
  const __nv_bfloat16* vg = v + ((long long)b * Sk * KV + kvh) * D;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = q0 + warp * 16 + g;  // this thread's rows: row0, row0 + 8
  const int last_row = min(q0 + BQ16, Sq) - 1;
  const int n_kt = (causal ? min(last_row, Sk - 1) : Sk - 1) / BK + 1;

  load_tile16<D, BQ16>(Qs, qg, qstride, q0, Sq);
  load_tile16<D, BK>(Ks, kg, kstride, 0, Sk);
  cp_async_commit();
  load_tile16<D, BK>(Vs, vg, kstride, 0, Sk);
  cp_async_commit();

  // ldmatrix row addresses (lane -> row of one of the four 8x8 matrices)
  const __nv_bfloat16* q_ld =
      Qs + (warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * PITCH + (lane >> 4) * 8;
  const __nv_bfloat16* k_ld = Ks + ((lane & 7) + (lane >> 4) * 8) * PITCH + ((lane >> 3) & 1) * 8;
  const __nv_bfloat16* v_ld = Vs + ((lane & 7) + ((lane >> 3) & 1) * 8) * PITCH + (lane >> 4) * 8;

  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) {
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[n][c] = 0.f;
  }
  float m_run[2] = {NEG_INF, NEG_INF};
  float l_run[2] = {0.f, 0.f};

  for (int kt = 0; kt < n_kt; ++kt) {
    cp_async_wait<1>();  // Q and this K tile have landed
    __syncthreads();

    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int c = 0; c < 4; ++c) s[n][c] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a0, a1, a2, a3;
      ldsm_x4(a0, a1, a2, a3, q_ld + kk * 16);
#pragma unroll
      for (int np = 0; np < BK / 16; ++np) {
        uint32_t b0, b1, b2, b3;
        ldsm_x4(b0, b1, b2, b3, k_ld + np * 16 * PITCH + kk * 16);
        mma16816(s[2 * np], a0, a1, a2, a3, b0, b1);
        mma16816(s[2 * np + 1], a0, a1, a2, a3, b2, b3);
      }
    }
    __syncthreads();  // every warp is done with this K tile
    const bool more = kt + 1 < n_kt;
    if (more) {
      load_tile16<D, BK>(Ks, kg, kstride, (kt + 1) * BK, Sk);
      cp_async_commit();
    }

    // scale, mask, online softmax
    const int key0 = kt * BK;
    float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int key = key0 + n * 8 + 2 * t + (c & 1);
        const int row = row0 + (c >> 1) * 8;
        const float x = s[n][c] * scale;
        s[n][c] = (key < Sk && (!causal || key <= row)) ? x : NEG_INF;
        mx[c >> 1] = fmaxf(mx[c >> 1], s[n][c]);
      }
    }
    float rs[2] = {0.f, 0.f}, corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      corr[r] = expf(m_run[r] - mx[r]);
    }
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[n][c] = expf(s[n][c] - mx[c >> 1]);
        rs[c >> 1] += s[n][c];
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
      l_run[r] = l_run[r] * corr[r] + rs[r];
      m_run[r] = mx[r];
    }
#pragma unroll
    for (int n = 0; n < NO; ++n) {
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[n][c] *= corr[c >> 1];
    }

    if (more) {
      cp_async_wait<1>();  // this V tile has landed (the next K may be in flight)
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t a0 = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      const uint32_t a1 = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      const uint32_t a2 = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      const uint32_t a3 = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t b0, b1, b2, b3;
        ldsm_x4_t(b0, b1, b2, b3, v_ld + kk * 16 * PITCH + dp * 16);
        mma16816(acc[2 * dp], a0, a1, a2, a3, b0, b1);
        mma16816(acc[2 * dp + 1], a0, a1, a2, a3, b2, b3);
      }
    }
    __syncthreads();  // every warp is done with this V tile
    if (more) {
      load_tile16<D, BK>(Vs, vg, kstride, (kt + 1) * BK, Sk);
      cp_async_commit();
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + r * 8;
    if (row < Sq) {
      const float den = fmaxf(l_run[r], 1e-30f);
      __nv_bfloat16* og = o + (((long long)b * Sq + row) * H + h) * D + 2 * t;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        *reinterpret_cast<uint32_t*>(og + n * 8) =
            pack_bf16(acc[n][2 * r] / den, acc[n][2 * r + 1] / den);
      }
    }
  }
}

// ------------------------------------------------------------------- f32

constexpr int BQ32 = 32;
constexpr int THREADS32 = 128;

template <int D>
struct Tile32 {
  static constexpr int PITCH = D + 4;    // floats per shared row of q/k/v
  static constexpr int PPITCH = BK + 4;  // floats per shared row of p
  static constexpr size_t BYTES =
      ((size_t)(BQ32 + 2 * BK) * PITCH + (size_t)BQ32 * PPITCH) * sizeof(float);
};

template <int D, int R>
__device__ __forceinline__ void load_tile32(float* sm, const float* g, long long stride, int r0,
                                            int S) {
  constexpr int CPR = D / 4;
  constexpr int PITCH = Tile32<D>::PITCH;
#pragma unroll 4
  for (int c = threadIdx.x; c < R * CPR; c += THREADS32) {
    const int r = c / CPR, col = (c % CPR) * 4;
    const int row = r0 + r;
    const float4 val = row < S ? *reinterpret_cast<const float4*>(g + (long long)row * stride + col)
                               : make_float4(0.f, 0.f, 0.f, 0.f);
    *reinterpret_cast<float4*>(sm + r * PITCH + col) = val;
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS32)
    flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ o, int Sq, int Sk, int H,
                  int KV, int causal, float scale) {
  constexpr int PITCH = Tile32<D>::PITCH;
  constexpr int PPITCH = Tile32<D>::PPITCH;
  constexpr int NK = BK / 4;   // keys per thread per tile
  constexpr int NA = D / 16;   // float4 output groups per thread
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);
  float* Ks = Qs + BQ32 * PITCH;
  float* Vs = Ks + BK * PITCH;
  float* Ps = Vs + BK * PITCH;

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int kvh = h / (H / KV);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ32;
  const long long qstride = (long long)H * D, kstride = (long long)KV * D;
  const float* qg = q + ((long long)b * Sq * H + h) * D;
  const float* kg = k + ((long long)b * Sk * KV + kvh) * D;
  const float* vg = v + ((long long)b * Sk * KV + kvh) * D;

  const int r = threadIdx.x >> 2, qq = threadIdx.x & 3;
  const int row = q0 + r;
  const int last_row = min(q0 + BQ32, Sq) - 1;
  const int n_kt = (causal ? min(last_row, Sk - 1) : Sk - 1) / BK + 1;

  load_tile32<D, BQ32>(Qs, qg, qstride, q0, Sq);
  float acc[NA][4];
#pragma unroll
  for (int i = 0; i < NA; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
  }
  float m_run = NEG_INF, l_run = 0.f;

  for (int kt = 0; kt < n_kt; ++kt) {
    __syncthreads();  // the previous tile's K, V are no longer read
    load_tile32<D, BK>(Ks, kg, kstride, kt * BK, Sk);
    load_tile32<D, BK>(Vs, vg, kstride, kt * BK, Sk);
    __syncthreads();

    float s[NK];
#pragma unroll
    for (int j = 0; j < NK; ++j) s[j] = 0.f;
#pragma unroll 2
    for (int d = 0; d < D; d += 4) {
      const float4 qv = *reinterpret_cast<const float4*>(Qs + r * PITCH + d);
#pragma unroll
      for (int j = 0; j < NK; ++j) {
        const float4 kv = *reinterpret_cast<const float4*>(Ks + (j * 4 + qq) * PITCH + d);
        s[j] = fmaf(qv.x, kv.x, s[j]);
        s[j] = fmaf(qv.y, kv.y, s[j]);
        s[j] = fmaf(qv.z, kv.z, s[j]);
        s[j] = fmaf(qv.w, kv.w, s[j]);
      }
    }
    const int key0 = kt * BK;
    float mx = m_run;
#pragma unroll
    for (int j = 0; j < NK; ++j) {
      const int key = key0 + j * 4 + qq;
      const float x = s[j] * scale;
      s[j] = (key < Sk && (!causal || key <= row)) ? x : NEG_INF;
      mx = fmaxf(mx, s[j]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float corr = expf(m_run - mx);
    float rs = 0.f;
#pragma unroll
    for (int j = 0; j < NK; ++j) {
      const float p = expf(s[j] - mx);
      rs += p;
      Ps[r * PPITCH + j * 4 + qq] = p;
    }
    rs += __shfl_xor_sync(0xffffffffu, rs, 1);
    rs += __shfl_xor_sync(0xffffffffu, rs, 2);
    l_run = l_run * corr + rs;
    m_run = mx;
#pragma unroll
    for (int i = 0; i < NA; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][e] *= corr;
    }
    __syncwarp();  // a row's p is written and read by the same four lanes
#pragma unroll 4
    for (int key = 0; key < BK; ++key) {
      const float p = Ps[r * PPITCH + key];
#pragma unroll
      for (int i = 0; i < NA; ++i) {
        const float4 vv = *reinterpret_cast<const float4*>(Vs + key * PITCH + qq * 4 + 16 * i);
        acc[i][0] = fmaf(p, vv.x, acc[i][0]);
        acc[i][1] = fmaf(p, vv.y, acc[i][1]);
        acc[i][2] = fmaf(p, vv.z, acc[i][2]);
        acc[i][3] = fmaf(p, vv.w, acc[i][3]);
      }
    }
  }

  if (row < Sq) {
    const float den = fmaxf(l_run, 1e-30f);
    float* og = o + (((long long)b * Sq + row) * H + h) * D + qq * 4;
#pragma unroll
    for (int i = 0; i < NA; ++i) {
      *reinterpret_cast<float4*>(og + 16 * i) =
          make_float4(acc[i][0] / den, acc[i][1] / den, acc[i][2] / den, acc[i][3] / den);
    }
  }
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, void* o, int B, int Sq, int Sk,
                int H, int KV, int causal, float scale, cudaStream_t st) {
  const size_t smem = Tile16<D>::BYTES;
  cudaError_t e = cudaFuncSetAttribute(flash_fwd_bf16<D>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(B * H, (Sq + BQ16 - 1) / BQ16);
  flash_fwd_bf16<D><<<grid, THREADS16, smem, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), Sq, Sk, H, KV,
      causal, scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* o, int B, int Sq, int Sk,
               int H, int KV, int causal, float scale, cudaStream_t st) {
  const size_t smem = Tile32<D>::BYTES;
  cudaError_t e = cudaFuncSetAttribute(flash_fwd_f32<D>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(B * H, (Sq + BQ32 - 1) / BQ32);
  flash_fwd_f32<D><<<grid, THREADS32, smem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), Sq, Sk, H, KV, causal, scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int B, int Sq, int Sk, int H,
           int KV, int is_bf16, int causal, float scale, cudaStream_t st) {
  return is_bf16 ? launch_bf16<D>(q, k, v, o, B, Sq, Sk, H, KV, causal, scale, st)
                 : launch_f32<D>(q, k, v, o, B, Sq, Sk, H, KV, causal, scale, st);
}

}  // namespace

// q, o: (B, Sq, H, D); k, v: (B, Sk, KV, D); all contiguous, 16-byte aligned.
// is_bf16: 1 = bfloat16, 0 = float32. causal: 1 = top-left causal mask.
// scale: the true head width's D**-0.5 rounded to f32 (the wrapper may have
// zero-padded D up to an instantiated width).
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* o,
                                      int B, int Sq, int Sk, int H, int KV, int D, int is_bf16,
                                      int causal, float scale, void* stream) {
  if (B < 1 || Sq < 1 || Sk < 1 || H < 1 || KV < 1 || H % KV != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return launch<32>(q, k, v, o, B, Sq, Sk, H, KV, is_bf16, causal, scale, st);
    case 64: return launch<64>(q, k, v, o, B, Sq, Sk, H, KV, is_bf16, causal, scale, st);
    case 80: return launch<80>(q, k, v, o, B, Sq, Sk, H, KV, is_bf16, causal, scale, st);
    case 96: return launch<96>(q, k, v, o, B, Sq, Sk, H, KV, is_bf16, causal, scale, st);
    case 112: return launch<112>(q, k, v, o, B, Sq, Sk, H, KV, is_bf16, causal, scale, st);
    case 128: return launch<128>(q, k, v, o, B, Sq, Sk, H, KV, is_bf16, causal, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

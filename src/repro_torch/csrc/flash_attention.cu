// Flash attention forward, causal (top-left) or not, Sq != Sk allowed, in
// two kernels, both fed by TMA at every width: bf16 (flash_fwd_hopper, both
// products on wgmma) and f32 (flash_fwd_f32_hopper, both products on the
// CUDA cores in the plain version's order).
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
// in kernels/flash_attention.py; they differ only by summation order
// inside a tile. A CTA's last key tile is (Sk - 1) / 128 without the causal
// mask, and min(the CTA's last row, Sk - 1) / 128 with it: a later tile is
// entirely above every row's diagonal, gives p = exp(-1e30 - m) = 0 and
// corr = 1 exactly, so skipping it changes no bit (a row of the CTA whose
// own diagonal ends earlier sees such tiles too, masked per element, to the
// same effect). With the causal mask and Sq > Sk, rows at or past Sk see
// every key.
//
// Layout: q and o are the model's (B, Sq, H, D), k and v (B, Sk, KV, D).
// Query head h reads KV head h / (H / KV): the GQA repeat is an index, not a
// copy. Rows at or past Sq and keys at or past Sk are zero-filled on load;
// such rows are never stored and such keys are masked, so the ragged edges
// need no padding. D is one of 32, 64, 80, 96, 112, 128; the wrapper
// zero-pads other widths. Which kernel runs is fixed by (dtype, D) alone
// (design(), mirrored by kernels/flash_attention.kernel_design): a route,
// never a fallback.
//
// flash_fwd_hopper (bf16, every D): 384 threads, 128 query rows per CTA.
// Warpgroup 0 is the producer (setmaxnreg down to 24): one thread issues
// TMA loads, Q once and K / V tiles into a two-stage ring with a full and
// an empty mbarrier per stage. Warpgroups 1 and 2 are consumers (setmaxnreg
// up to 240) of 64 rows each (wgmma's M); they run independently, so one's
// softmax overlaps the other's products. The tensor maps are rank 4, (D,
// heads, S, B) over the (B, S, heads, D) strides at the true D, encoded
// per launch through libcuda's entry point (the build links only the
// runtime): rows past S are zero-filled per batch, never read from the next
// batch. Tiles land in the 128-byte swizzled layout: ceil(D / 64) column
// blocks of rows x 128 bytes, 16-byte chunk c of row r at c ^ (r & 7),
// bases 1,024-byte aligned. Where D is not a multiple of 64 (32, 80, 96,
// 112) the last block is part-filled: its boxes are still 64 columns wide,
// TMA writes zeros past D, and the barriers expect the whole boxes' bytes,
// as they do for rows past S; no padding copy is made. Shared memory is 160
// KB at D 80 to 128, 80 KB at D 32 and 64. S = Q K^T is D / 16 k16 steps of
// wgmma.m64n128k16 with both operands K-major from shared memory (SW128
// descriptors; the start address moves 32 bytes a step inside a block, a
// whole block after four), so only real columns enter it; its accumulator
// is the m16n8 C layout per warp, so the softmax works on it in place. p is
// rounded to bf16 into the m16n8k16 A layout in registers and O += P V is
// wgmma.m64n{D}k16 at the true width with A from registers and V from
// shared memory, MN-major (keys x D with D contiguous: transposed B,
// leading byte offset = one column block, stride byte offset = 8 rows); at
// D 80 and 112 it reads the part-filled block's first 16 or 48 columns.
// Per consumer thread: 64 f32 scores, 32 packed p, D / 2 f32 output
// accumulators. Register fences keep the compiler from touching
// accumulators between an async wgmma and its wait. The softmax runs in
// base 2: scores scaled by scale * log2 e, p = exp2f(x - m), corr =
// exp2f(m - m') (the f32 kernel uses expf); the element and share limits
// hold unchanged.
//
// flash_fwd_f32_hopper (f32, every D): the shape of flash_fwd_hopper (384
// threads, 128 query rows, a TMA producer warpgroup, two consumer
// warpgroups of 64 rows), with both products on the CUDA cores. That is not
// a choice of speed. The f32 rule holds the kernel to 2 ulps + 1e-6 of the
// plain version, and the plain version's own f32 rounding is of that size
// (its scores carry a few ulps that the softmax turns into ~1e-6 where a few
// keys dominate a row, and its P V sums a tile's keys in order): at
// Qwen3-8B's serving shape in f32 the exact result is 1.55e-6 beyond the
// rule (scripts/flash_tolerance_probe.py), and a tensor-core P V (p and v as
// three exact bf16 planes on wgmma, no TF32) put elements of the whisper
// card test beyond it (PERF.md). So each score is one fmaf chain over
// d in order, and each output's P V one fmaf chain over the tile's keys in
// order from zero, then acc = acc * corr + pv with the plain version's two
// roundings. Q, K and V arrive in f32 by TMA (128-byte swizzled blocks of 32
// columns) through a ring of 32 KB stages (a key tile's K in parts of 64
// columns, then its V), three at D 80-128 and four at D 32 and 64. The two
// threads g and g ^ 1 of a quad's t share four rows: for S = Q K^T each
// takes half the keys, so a float4 of K feeds 16 fmaf (with two rows a
// thread it fed 8 and left the loop bound by shared memory's bandwidth),
// the eight lanes of a shared-memory phase reading eight distinct chunks;
// for P V each takes a quarter of the columns, with p through P, a 64 KB
// shared tile the warp writes and reads back (so the key loop stays a loop:
// a register holding p cannot be indexed by it). The softmax is the plain
// version's in f32: s * scale, expf(s - m'), expf(m - m'), each row's
// maximum and sum over the eight lanes holding it. Per consumer thread: 64
// scores, D / 2 output and D / 2 block accumulators.
//
// Bound: at the serving shapes (Qwen3-8B prefill, B = 4, S = 2048, H = 32,
// KV = 8, D = 128) the causal work is 4 D S (S + 1) / 2 flops per head,
// 1.375e11 in all, 0.139 ms at 989 TFLOP/s, against 168 MB of q, k, v and
// o (0.050 ms at 3.35 TB/s): bound by the tensor cores' operations, as is
// every case the repository's configs give. flash_fwd_hopper puts both
// products on wgmma fed by TMA; within a consumer warpgroup the products
// and the softmax still run one after another (no overlap of one tile's
// softmax with the next tile's QK^T), which is what keeps it from that
// bound. In f32 the bound is the same work at f32 accuracy on the tensor
// cores, six exact bf16 plane products a product (row 6's basis for f32):
// 0.834 ms at 989 TFLOP/s. flash_fwd_f32_hopper's design cannot reach it:
// on the f32 CUDA cores, which the rule needs (above), the work takes at
// least 2.05 ms at 67 TFLOP/s, 41% of the bound; on an H100 80GB HBM3 at
// 700 W the kernel read 23% of the bound at this shape and 18% at
// StableLM-1.6B's (PERF.md). Its Q K^T loop moves 1.25 bytes of shared
// memory an fmaf (20 float4 loads for 256 fmaf) and its P V loop about as
// much, where the SM feeds 1.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int BK = 128;  // keys per tile

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

// ------------------------------------------------------------ bf16 on Hopper

constexpr int BQH = 128;  // query rows per CTA: two consumer warpgroups of 64 (wgmma's M)

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
__device__ __forceinline__ void reg_fence(uint32_t& r) { asm volatile("" : "+r"(r)::"memory"); }

// the accumulator operands of a wgmma: WG_F<n>(i) binds d[i] .. d[i + n - 1],
// WG_D<n> names the first n operands %0 .. %(n - 1)
#define WG_F4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define WG_F8(i) WG_F4(i), WG_F4(i + 4)
#define WG_F16(i) WG_F8(i), WG_F8(i + 8)
#define WG_D16 "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
#define WG_D32 \
  WG_D16 ", %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
#define WG_D40 WG_D32 ", %32, %33, %34, %35, %36, %37, %38, %39"
#define WG_D48 WG_D40 ", %40, %41, %42, %43, %44, %45, %46, %47"
#define WG_D56 WG_D48 ", %48, %49, %50, %51, %52, %53, %54, %55"
#define WG_D64 WG_D56 ", %56, %57, %58, %59, %60, %61, %62, %63"

// d (64 x 128, f32) = (scale_d ? d : 0) + A (64 x 16) . B (128 x 16)^T; A and
// B bf16 from shared memory, both K-major
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db,
                                              int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" WG_D64 "}, %64, %65, p, 1, 1, "
      "0, 0;\n}\n"
      : WG_F16(0), WG_F16(16), WG_F16(32), WG_F16(48)
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x N, f32) += A (64 x 16, bf16 pairs in registers, the mma.sync A
// layout) . B (16 x N, bf16 in shared memory, N contiguous: MN-major), one
// overload per head width N, chosen by the accumulator's length N / 2: the
// accumulators are the operands WG_D<N / 2> (bound by the WG_F lists given
// last), then A's four registers and B's descriptor (AB), then scale-d (SC)
#define WGMMA_RS(N, DL, AB, SC, ...)                                                       \
  __device__ __forceinline__ void wgmma_rs(float(&d)[N / 2], uint32_t a0, uint32_t a1,     \
                                           uint32_t a2, uint32_t a3, uint64_t db) {        \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, " SC ", 0;\n"                            \
                 "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32.bf16.bf16 {" DL "}, " AB     \
                 ", p, 1, 1, 1;\n}\n"                                                      \
                 : __VA_ARGS__                                                             \
                 : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));                   \
  }
WGMMA_RS(32, WG_D16, "{%16, %17, %18, %19}, %20", "%21", WG_F16(0))
WGMMA_RS(64, WG_D32, "{%32, %33, %34, %35}, %36", "%37", WG_F16(0), WG_F16(16))
WGMMA_RS(80, WG_D40, "{%40, %41, %42, %43}, %44", "%45", WG_F16(0), WG_F16(16), WG_F8(32))
WGMMA_RS(96, WG_D48, "{%48, %49, %50, %51}, %52", "%53", WG_F16(0), WG_F16(16), WG_F16(32))
WGMMA_RS(112, WG_D56, "{%56, %57, %58, %59}, %60", "%61", WG_F16(0), WG_F16(16), WG_F16(32),
         WG_F8(48))
WGMMA_RS(128, WG_D64, "{%64, %65, %66, %67}, %68", "%69", WG_F16(0), WG_F16(16), WG_F16(32),
         WG_F16(48))

constexpr int THREADS_H = 384;  // warpgroup 0 loads, warpgroups 1 and 2 compute

// Shared tiles in 128-byte swizzled column blocks of 64 bf16 values, the
// last part-filled where D is not a multiple of 64 (TMA writes zeros past
// D there). The byte counts are whole boxes, fills included: what TMA's
// complete_tx reports.
template <int D>
struct TileH {
  static constexpr int NB = (D + 63) / 64;  // column blocks
  static constexpr uint32_t Q_BYTES = BQH * NB * 128;
  static constexpr uint32_t KV_BYTES = BK * NB * 128;
  static constexpr uint32_t K_OFF = Q_BYTES;
  static constexpr uint32_t V_OFF = K_OFF + 2 * KV_BYTES;
  static constexpr uint32_t BAR_OFF = V_OFF + 2 * KV_BYTES;  // 9 mbarriers
  static constexpr size_t BYTES = BAR_OFF + 128 + 1024;
};

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

// one box (64 of D, 1 head, 128 rows, 1 batch) of a rank-4 map over
// (D, heads, S, B) into shared memory at dst, 128-byte swizzled; rows past S
// (per batch) arrive as zeros
__device__ __forceinline__ void tma_load4(uint32_t dst, const CUtensorMap* map, int d0, int head,
                                          int row, int b, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, "
      "{%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(d0), "r"(head), "r"(row), "r"(b), "r"(bar)
      : "memory");
}

template <int D>
__global__ void __launch_bounds__(THREADS_H, 1)
    flash_fwd_hopper(const __grid_constant__ CUtensorMap tmq,
                     const __grid_constant__ CUtensorMap tmk,
                     const __grid_constant__ CUtensorMap tmv, __nv_bfloat16* __restrict__ o,
                     int Sq, int Sk, int H, int KV, int causal, float scale) {
  static_assert(D % 16 == 0 && D >= 32 && D <= 128, "k16 steps, wgmma N of D");
  using T = TileH<D>;
  constexpr int NS = BK / 8;
  constexpr int NO = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t base =
      (static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw)) + 1023u) & ~1023u;
  const uint32_t Qs = base, Ks = base + T::K_OFF, Vs = base + T::V_OFF;
  // mbarriers: Q full, K full x 2, V full x 2, K empty x 2, V empty x 2
  const uint32_t q_full = base + T::BAR_OFF;
  const uint32_t k_full = q_full + 8, v_full = q_full + 24;
  const uint32_t k_empty = q_full + 40, v_empty = q_full + 56;

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int kvh = h / (H / KV);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQH;  // longest rows first
  const int last_row = min(q0 + BQH, Sq) - 1;
  const int n_kt = (causal ? min(last_row, Sk - 1) : Sk - 1) / BK + 1;
  const int wg = threadIdx.x >> 7;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(k_empty + 8 * s, 8);  // one arrival per consumer warp
      mbar_init(v_empty + 8 * s, 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // producer: one thread keeps the two-stage K and V ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, T::Q_BYTES);
#pragma unroll
      for (int db = 0; db < T::NB; ++db)
        tma_load4(Qs + db * (BQH * 128), &tmq, db * 64, h, q0, b, q_full);
      for (int kt = 0; kt < n_kt; ++kt) {
        const int s = kt & 1;
        const uint32_t ph = (kt >> 1) & 1;
        if (kt >= 2) mbar_wait(k_empty + 8 * s, ph ^ 1);
        mbar_expect_tx(k_full + 8 * s, T::KV_BYTES);
#pragma unroll
        for (int db = 0; db < T::NB; ++db)
          tma_load4(Ks + s * T::KV_BYTES + db * (BK * 128), &tmk, db * 64, kvh, kt * BK, b,
                    k_full + 8 * s);
        if (kt >= 2) mbar_wait(v_empty + 8 * s, ph ^ 1);
        mbar_expect_tx(v_full + 8 * s, T::KV_BYTES);
#pragma unroll
        for (int db = 0; db < T::NB; ++db)
          tma_load4(Vs + s * T::KV_BYTES + db * (BK * 128), &tmv, db * 64, kvh, kt * BK, b,
                    v_full + 8 * s);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int cw = wg - 1, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    const int row0 = q0 + cw * 64 + warp * 16 + g;  // this thread's rows: row0, row0 + 8
    // scores in base 2: exp(x - m) = exp2(x log2 e - m log2 e), so m and the
    // masked -1e30 live in the same units
    const float scale2 = scale * 1.4426950408889634f;

    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    float m_run[2] = {NEG_INF, NEG_INF};
    float l_run[2] = {0.f, 0.f};
    mbar_wait(q_full, 0);

    for (int kt = 0; kt < n_kt; ++kt) {
      const int st = kt & 1;
      const uint32_t ph = (kt >> 1) & 1;
      const uint32_t kb = Ks + st * T::KV_BYTES, vb = Vs + st * T::KV_BYTES;
      mbar_wait(k_full + 8 * st, ph);

      float s[BK / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint64_t da = sw128_desc(Qs + (kk >> 2) * (BQH * 128) + cw * (64 * 128) +
                                           (kk & 3) * 32, 16, 1024);
        const uint64_t db = sw128_desc(kb + (kk >> 2) * (BK * 128) + (kk & 3) * 32, 16, 1024);
        wgmma_ss_n128(s, da, db, kk);
      }
      wgmma_commit();
      wgmma_wait0();
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) reg_fence(s[i]);
      __syncwarp();
      if (lane == 0) mbar_arrive(k_empty + 8 * st);

      const int key0 = kt * BK;
      float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
      for (int n = 0; n < NS; ++n) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int key = key0 + n * 8 + 2 * t + (c & 1);
          const int row = row0 + (c >> 1) * 8;
          const float x = s[4 * n + c] * scale2;
          s[4 * n + c] = (key < Sk && (!causal || key <= row)) ? x : NEG_INF;
          mx[c >> 1] = fmaxf(mx[c >> 1], s[4 * n + c]);
        }
      }
      float rs[2] = {0.f, 0.f}, corr[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        corr[r] = exp2f(m_run[r] - mx[r]);
      }
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        s[i] = exp2f(s[i] - mx[(i >> 1) & 1]);
        rs[(i >> 1) & 1] += s[i];
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
        rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
        l_run[r] = l_run[r] * corr[r] + rs[r];
        m_run[r] = mx[r];
      }
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] *= corr[(i >> 1) & 1];

      uint32_t pa[BK / 4];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        pa[4 * kk + 0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
        pa[4 * kk + 1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
        pa[4 * kk + 2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
        pa[4 * kk + 3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
      }
      mbar_wait(v_full + 8 * st, ph);
#pragma unroll
      for (int i = 0; i < BK / 4; ++i) reg_fence(pa[i]);
#pragma unroll
      for (int i = 0; i < D / 2; ++i) reg_fence(acc[i]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint64_t db = sw128_desc(vb + kk * (16 * 128), BK * 128, 1024);
        wgmma_rs(acc, pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2], pa[4 * kk + 3], db);
      }
      wgmma_commit();
      wgmma_wait0();
#pragma unroll
      for (int i = 0; i < BK / 4; ++i) reg_fence(pa[i]);
#pragma unroll
      for (int i = 0; i < D / 2; ++i) reg_fence(acc[i]);
      __syncwarp();
      if (lane == 0) mbar_arrive(v_empty + 8 * st);
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
              pack_bf16(acc[4 * n + 2 * r] / den, acc[4 * n + 2 * r + 1] / den);
        }
      }
    }
  }
}

// ----------------------------------------------------------- f32 on Hopper

// Shared memory of flash_fwd_f32_hopper, in column blocks of 128 rows x 32
// f32 (BLK, 16 KB; TMA's 128-byte swizzle: 16-byte chunk c of row r at c ^
// (r & 7)): Q's QB blocks; P, the tile's p (128 rows x 128 keys, 16-byte
// chunk c of row r at c ^ (r & 7)); then a ring of NST stages of two blocks
// each, holding a key tile's K in KP parts of 64 columns, then its V
// likewise; then the mbarriers: Q full, full x NST, empty x NST. 224 KB at
// D 64 and 112-128, 208 KB at D 32, 80 and 96.
template <int D>
struct TileF {
  static constexpr uint32_t BLK = BK * 128;
  static constexpr int QB = (D + 31) / 32;
  static constexpr int KP = (QB + 1) / 2;
  static constexpr int NPART = 2 * KP;  // ring stages a key tile takes
  static constexpr uint32_t STAGE = 2 * BLK;
  static constexpr int NST = D <= 64 ? 4 : 3;
  static constexpr uint32_t P_OFF = QB * BLK;
  static constexpr uint32_t RING_OFF = P_OFF + BQH * BK * 4;
  static constexpr uint32_t BAR_OFF = RING_OFF + NST * STAGE;
  static constexpr size_t BYTES = BAR_OFF + 8 * (1 + 2 * NST) + 1024;
};

template <int D>
__global__ void __launch_bounds__(THREADS_H, 1)
    flash_fwd_f32_hopper(const __grid_constant__ CUtensorMap tmq,
                         const __grid_constant__ CUtensorMap tmk,
                         const __grid_constant__ CUtensorMap tmv, float* __restrict__ o, int Sq,
                         int Sk, int H, int KV, int causal, float scale) {
  static_assert(D % 16 == 0 && D >= 32 && D <= 128, "float4 steps, whole 16-column groups");
  using T = TileF<D>;
  constexpr int NST = T::NST, KP = T::KP, NPART = T::NPART, QB = T::QB;
  constexpr uint32_t BLK = T::BLK;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t Qs = base, Rs = base + T::RING_OFF;
  const uint32_t q_full = base + T::BAR_OFF, full = q_full + 8, empty = full + 8 * NST;
  const unsigned char* const sm = smem_raw + (base - raw);  // the same bytes, for plain loads

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int kvh = h / (H / KV);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQH;  // longest rows first
  const int last_row = min(q0 + BQH, Sq) - 1;
  const int n_kt = (causal ? min(last_row, Sk - 1) : Sk - 1) / BK + 1;
  const int wg = threadIdx.x >> 7;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
#pragma unroll
    for (int s = 0; s < NST; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 8);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // producer: one thread loads Q, then streams each key tile's K and V
    // parts through the ring
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, QB * BLK);
#pragma unroll
      for (int cb = 0; cb < QB; ++cb) tma_load4(Qs + cb * BLK, &tmq, cb * 32, h, q0, b, q_full);
      for (int c = 0; c < NPART * n_kt; ++c) {
        const int s = c % NST, u = c / NST, kt = c / NPART, j = c % NPART;
        if (u > 0) mbar_wait(empty + 8 * s, (u & 1) ^ 1);
        const int part = j % KP, nblk = min(2, QB - 2 * part);
        mbar_expect_tx(full + 8 * s, nblk * BLK);
        for (int x = 0; x < nblk; ++x)
          tma_load4(Rs + s * T::STAGE + x * BLK, j < KP ? &tmk : &tmv, (2 * part + x) * 32, kvh,
                    kt * BK, b, full + 8 * s);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int cw = wg - 1, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    // The two threads g and g ^ 1 of a t share four rows of the warp's 16
    // (rp, rp + 1, rp + 8, rp + 9); thread kh = g & 1 scores the keys 64 kh
    // + 8 m + 2 t + e (m < 8, e < 2; e taken in the order e ^ kh, so the
    // eight lanes of each shared-memory phase read eight distinct 16-byte
    // chunks) and sums the output columns 32 j + 4 c8 + (0..3), c8 = lane &
    // 7, of the four rows
    const int rb = cw * 64 + warp * 16;  // the warp's rows in the CTA
    const int kh = g & 1, rp = g & ~1, c8 = lane & 7;

    float acc[16 * QB];  // acc[(r QB + j) 4 + i]: row r, column 32 j + 4 c8 + i
#pragma unroll
    for (int i = 0; i < 16 * QB; ++i) acc[i] = 0.f;
    float m_run[4], l_run[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) m_run[r] = NEG_INF, l_run[r] = 0.f;
    mbar_wait(q_full, 0);

    for (int kt = 0; kt < n_kt; ++kt) {
      const int c0 = NPART * kt;
      // S = Q K^T: each score one fmaf chain over d in order (the plain
      // version's f32 rounding); each float4 of K feeds 16 fmaf
      float a[64];  // a[(r 8 + m) 2 + e]: row r of the four, key 64 kh + 8 m + 2 t + (e ^ kh)
#pragma unroll
      for (int i = 0; i < 64; ++i) a[i] = 0.f;
#pragma unroll
      for (int j = 0; j < KP; ++j) {
        const int st = (c0 + j) % NST;
        mbar_wait(full + 8 * st, ((c0 + j) / NST) & 1);
        const unsigned char* const kb = sm + T::RING_OFF + st * T::STAGE;
        constexpr int W = 64;
#pragma unroll 2
        for (int dd = 0; dd < (D - 64 * j < W ? D - 64 * j : W); dd += 4) {
          const int d = 64 * j + dd, ch = (d & 31) >> 2;
          const unsigned char* const qb = sm + (d >> 5) * BLK + (rb + rp) * 128;
          float4 qv[4];
#pragma unroll
          for (int r = 0; r < 4; ++r)  // rows rp, rp + 1, rp + 8, rp + 9
            qv[r] = *reinterpret_cast<const float4*>(qb + ((r & 1) + 8 * (r >> 1)) * 128 +
                                                     ((ch ^ (rp + (r & 1))) << 4));
          const unsigned char* const kd = kb + ((d >> 5) & 1) * BLK;
#pragma unroll
          for (int m = 0; m < 8; ++m) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int kl = 2 * t + (e ^ kh);  // the key's low three bits
              const float4 kv = *reinterpret_cast<const float4*>(
                  kd + (64 * kh + 8 * m + kl) * 128 + ((ch ^ kl) << 4));
#pragma unroll
              for (int r = 0; r < 4; ++r) {
                float& x = a[(r * 8 + m) * 2 + e];
                x = fmaf(qv[r].x, kv.x, x);
                x = fmaf(qv[r].y, kv.y, x);
                x = fmaf(qv[r].z, kv.z, x);
                x = fmaf(qv[r].w, kv.w, x);
              }
            }
          }
        }
      }
      __syncwarp();
      if (lane == 0) {
#pragma unroll
        for (int j = 0; j < KP; ++j) mbar_arrive(empty + 8 * ((c0 + j) % NST));
      }

      // the plain version's softmax: s * scale, p = expf(s - m'), corr =
      // expf(m - m'), l' = l corr + rowsum p; a row's 128 keys lie in the
      // eight lanes of its t's and its pair
      const int key0 = kt * BK;
      float mx[4], rs[4] = {0.f, 0.f, 0.f, 0.f}, corr[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        mx[r] = m_run[r];
        const int row = q0 + rb + rp + (r & 1) + 8 * (r >> 1);
#pragma unroll
        for (int m = 0; m < 8; ++m) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int key = key0 + 64 * kh + 8 * m + 2 * t + (e ^ kh);
            float& x = a[(r * 8 + m) * 2 + e];
            x = (key < Sk && (!causal || key <= row)) ? x * scale : NEG_INF;
            mx[r] = fmaxf(mx[r], x);
          }
        }
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 4));
        corr[r] = expf(m_run[r] - mx[r]);
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          float& x = a[r * 16 + i];
          x = expf(x - mx[r]);
          rs[r] += x;
        }
        rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
        rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
        rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 4);
        l_run[r] = __fadd_rn(__fmul_rn(l_run[r], corr[r]), rs[r]);
        m_run[r] = mx[r];
      }

      // p to P (the warp's own 16 rows), then P V as the plain version sums
      // it: pv = one fmaf chain over the tile's keys in order from zero, then
      // acc * corr + pv
      unsigned char* const pw = const_cast<unsigned char*>(sm) + T::P_OFF;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int R = rb + rp + (r & 1) + 8 * (r >> 1);
#pragma unroll
        for (int m = 0; m < 8; ++m) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int key = 64 * kh + 8 * m + 2 * t + (e ^ kh);
            *reinterpret_cast<float*>(pw + R * (BK * 4) + (((key >> 2) ^ (R & 7)) << 4) +
                                      (key & 3) * 4) = a[(r * 8 + m) * 2 + e];
          }
        }
      }
      __syncwarp();
      const unsigned char* vb[KP];
#pragma unroll
      for (int j = 0; j < KP; ++j) {
        const int st = (c0 + KP + j) % NST;
        mbar_wait(full + 8 * st, ((c0 + KP + j) / NST) & 1);
        vb[j] = sm + T::RING_OFF + st * T::STAGE;
      }
      float pv[16 * QB];
#pragma unroll
      for (int i = 0; i < 16 * QB; ++i) pv[i] = 0.f;
#pragma unroll 2
      for (int k4 = 0; k4 < BK; k4 += 4) {
        float4 p4[4];  // p of the four rows at keys k4 .. k4 + 3
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int R = rb + rp + (r & 1) + 8 * (r >> 1);
          p4[r] = *reinterpret_cast<const float4*>(pw + R * (BK * 4) +
                                                   (((k4 >> 2) ^ (R & 7)) << 4));
        }
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const int key = k4 + kk;
#pragma unroll
          for (int j = 0; j < QB; ++j) {
            const float4 v4 = *reinterpret_cast<const float4*>(
                vb[j >> 1] + (j & 1) * BLK + key * 128 + ((c8 ^ (key & 7)) << 4));
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              const float pk = kk == 0 ? p4[r].x : kk == 1 ? p4[r].y : kk == 2 ? p4[r].z : p4[r].w;
              float* y = pv + (r * QB + j) * 4;
              y[0] = fmaf(pk, v4.x, y[0]);
              y[1] = fmaf(pk, v4.y, y[1]);
              y[2] = fmaf(pk, v4.z, y[2]);
              y[3] = fmaf(pk, v4.w, y[3]);
            }
          }
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
#pragma unroll
        for (int i = 0; i < 4 * QB; ++i)
          acc[r * 4 * QB + i] = __fadd_rn(__fmul_rn(acc[r * 4 * QB + i], corr[r]),
                                          pv[r * 4 * QB + i]);
      }
      __syncwarp();
      if (lane == 0) {
#pragma unroll
        for (int j = 0; j < KP; ++j) mbar_arrive(empty + 8 * ((c0 + KP + j) % NST));
      }
    }

#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = q0 + rb + rp + (r & 1) + 8 * (r >> 1);
      if (row < Sq) {
        const float den = fmaxf(l_run[r], 1e-30f);
        float* og = o + (((long long)b * Sq + row) * H + h) * D;
#pragma unroll
        for (int j = 0; j < QB; ++j) {
          const int col = 32 * j + 4 * c8;
          const float* y = acc + (r * QB + j) * 4;
          if (col < D)
            *reinterpret_cast<float4*>(og + col) =
                make_float4(y[0] / den, y[1] / den, y[2] / den, y[3] / den);
        }
      }
    }
  }
}

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

// rank-4 map of a (B, S, heads, D) bf16 (elem 2) or f32 (elem 4) tensor as
// (D, heads, S, B), boxes of 128 bytes of D (64 or 32 values) x 1 x 128 rows
// x 1, 128-byte swizzle, zeros past every edge: rows past S and, where D is
// not a multiple of the box, the last box's columns past D
int make_map(CUtensorMap* map, const void* t, int D, int heads, int S, int B, int elem = 2) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorInitializationError;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * elem, (cuuint64_t)heads * D * elem,
                                 (cuuint64_t)S * heads * D * elem};
  const cuuint32_t box[4] = {128u / elem, 1, (cuuint32_t)BK, 1};
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, elem == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                       : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                        4, const_cast<void*>(t), dims, strides, box, ones,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int D>
int launch_hopper(const void* q, const void* k, const void* v, void* o, int B, int Sq, int Sk,
                  int H, int KV, int causal, float scale, cudaStream_t st) {
  CUtensorMap tmq, tmk, tmv;
  int rc = make_map(&tmq, q, D, H, Sq, B);
  if (rc == 0) rc = make_map(&tmk, k, D, KV, Sk, B);
  if (rc == 0) rc = make_map(&tmv, v, D, KV, Sk, B);
  if (rc != 0) return rc;
  const size_t smem = TileH<D>::BYTES;
  cudaError_t e = cudaFuncSetAttribute(flash_fwd_hopper<D>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(B * H, (Sq + BQH - 1) / BQH);
  flash_fwd_hopper<D><<<grid, THREADS_H, smem, st>>>(
      tmq, tmk, tmv, static_cast<__nv_bfloat16*>(o), Sq, Sk, H, KV, causal, scale);
  return (int)cudaGetLastError();
}

// flash_fwd_f32_hopper over f32 maps of q, k and v
template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* o, int B, int Sq, int Sk,
               int H, int KV, int causal, float scale, cudaStream_t st) {
  CUtensorMap tmq, tmk, tmv;
  int rc = make_map(&tmq, q, D, H, Sq, B, 4);
  if (rc == 0) rc = make_map(&tmk, k, D, KV, Sk, B, 4);
  if (rc == 0) rc = make_map(&tmv, v, D, KV, Sk, B, 4);
  if (rc != 0) return rc;
  const size_t smem = TileF<D>::BYTES;
  cudaError_t e = cudaFuncSetAttribute(flash_fwd_f32_hopper<D>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(B * H, (Sq + BQH - 1) / BQH);
  flash_fwd_f32_hopper<D><<<grid, THREADS_H, smem, st>>>(tmq, tmk, tmv, static_cast<float*>(o),
                                                         Sq, Sk, H, KV, causal, scale);
  return (int)cudaGetLastError();
}

// The kernel a (dtype, D) runs, fixed by the two alone: 1 flash_fwd_hopper
// (bf16), 0 flash_fwd_f32_hopper (float32); -1 for a D with no instantiation.
// kernels/flash_attention.kernel_design is the same table.
int design(int D, int is_bf16) {
  if (D != 32 && D != 64 && D != 80 && D != 96 && D != 112 && D != 128) return -1;
  return is_bf16 ? 1 : 0;
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int B, int Sq, int Sk, int H,
           int KV, int is_bf16, int causal, float scale, cudaStream_t st) {
  if (!is_bf16) return launch_f32<D>(q, k, v, o, B, Sq, Sk, H, KV, causal, scale, st);
  return launch_hopper<D>(q, k, v, o, B, Sq, Sk, H, KV, causal, scale, st);
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

// design(D, is_bf16) above, for the wrapper to hold its table against
extern "C" int flash_attention_design(int D, int is_bf16) { return design(D, is_bf16); }

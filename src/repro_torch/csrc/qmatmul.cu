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
//   qmm_decode<NP, P, 0>  M <= 16, w TMA-loadable, bf16 or f32 x (any
//                         alignment)
//   qmm_hopper<P, 0>      M > 16, w TMA-loadable: bf16 x (P = 1) and f32 x
//                         through its three bf16 planes (P = 3)
//   qmm_decode<NP, P, 1>, qmm_hopper<P, 1>   the same where TMA cannot load
//                         w as tiles: its producers fetch w's rows themselves
//                         and realign them (LDW, below)
//
// x reaches qmm_hopper by TMA. f32 x always goes through split_planes<3>
// (one launch before it, into scratch); bf16 x that TMA cannot load (K % 8
// != 0 or a base off 16-byte alignment) through split_planes<1>, which
// copies it to rows of 16-byte pitch.
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
// w where TMA cannot load it as (N, K) tiles (LDW = 1: N % 16 != 0 or w
// off 16-byte alignment, so row k, which starts at w + k N, has an
// alignment of its own). Only the producers change: they fill the same
// 128-byte swizzled stages as TMA would (the int8 stage of qmm_decode; the
// bf16 B tile of qmm_hopper, which then has no int8 ring), so the
// consumers and each output's summation order are the TMA routes'. Rows 16
// apart are 16 N bytes apart, a 16-byte multiple: seen from floor16(w), w
// is a tensor of "super-rows" of 16 rows with a legal TMA stride, and one
// box (144 B x 4 super-rows, no swizzle, its inner coordinate a 16-byte
// multiple) fetches four rows of one residue k % 16, each from the aligned
// block that holds its byte n0. A 64 x 128 tile is 16 such boxes into a
// staging slot (LST = 4 slots, one mbarrier each); row 15 of a super-row
// runs d0 = w % 16 bytes past the view's row, so residue 15 comes from the
// same view 16 bytes on. Where a tile's rows are not all in whole
// super-rows (the last tile, K % 16 != 0) each row is one 1-D bulk copy of
// its aligned blocks. The boxes need N >= 16 (w_map says why); a narrower
// w stages every row by a bulk copy. No load leaves the 16-byte blocks that
// hold w (the maps start at floor16(w) and end in w's last block), and such
// a block lies in a page that holds w. The bulk copies read the blocks that
// hold w's first and last bytes byte by byte (edge_block); fault safety
// does not need that, but the build without it read 2.5-8% slower on every
// _ldw route (PERF.md, PR 37), so it stays. Once a slot has landed, each
// producer lane takes 16-byte chunks of its warp's 16 rows (two
// conflict-free 16-byte shared loads), funnel-shifts them by the row's byte
// offset, zeroes n >= N and rows k >= K, and stores the chunk (qmm_hopper
// converts it to bf16 first); then the warpgroup refills the slot LST tiles
// ahead. Measured at Qwen3-8B's
// w_gate (PERF.md, PR 37): plain 32-bit loads, in registers or by
// cp.async, read 3.6x the TMA decode route; 16-byte cp.async and one bulk
// copy a row 2.1-2.3x; the boxes 1.9x (the producer's realignment and
// tile issue then take the time the consumers wait; the clock64 trace
// is in PERF.md).
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

// ------------------------------------------------------------ x loads

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

// ------------------------------------------------- bf16 on Hopper (prefill)

constexpr int HT = 128;        // n columns of a CTA tile; rows of a consumer warpgroup
constexpr int BKH = 64;        // k step: one 128-byte swizzle atom of bf16 x
constexpr int GROUP_M = 8;     // m tiles walked together in the tile order (L2 reuse)
constexpr int THREADS_H = 384;  // warpgroup 0 loads and converts, warpgroups 1 and 2 multiply
constexpr uint32_t W8_BYTES = BKH * HT;       // 8 KB: 64 k rows x 128 B
constexpr uint32_t B_BYTES = BKH * HT * 2;    // 16 KB: two 64-n blocks of 64 k rows x 128 B
constexpr uint32_t B_BLOCK = BKH * 128;       // one 64-n block of the B tile
// The staging ring of the producers that load w themselves (LDW): LST
// slots of a 64 k x 128 n tile's rows as loaded, each row the (at most
// nine) aligned 16-byte blocks that cover its 128 bytes, 144 bytes a row;
// each slot completes on its own mbarrier.
constexpr int LST = 4;
constexpr int ROW_BLOCKS = 9;
constexpr uint32_t ROW_PITCH = 16 * ROW_BLOCKS;
constexpr uint32_t BOX_BYTES = 4 * ROW_PITCH;  // a box of the super-row map: 4 rows of 144 B
constexpr uint32_t BOX_PITCH = 640;            // a box's place in a slot (128-byte aligned)
constexpr uint32_t STAGE_BYTES = 16 * BOX_PITCH;

// qmm_hopper's tiles and rings by x's planes: P = 1 (bf16 x) 256 rows, four
// x stages of 32 KB and three B stages; P = 3 (f32 x's planes) 128 rows,
// three x stages of 48 KB and two B stages; then the int8 ring where TMA
// loads w (LDW = 0), or the staging ring where the producers do (LDW = 1)
template <int P, int LDW>
struct HopperTile {
  static constexpr int BM = P == 1 ? 256 : 128;   // m rows of a CTA tile
  static constexpr int MT = BM / 128;             // m64 tiles of a consumer warpgroup
  static constexpr int XST = P == 1 ? 4 : 3;      // stages of the x and int8 w rings
  static constexpr int BST = P == 1 ? 3 : 2;      // stages of the bf16 B ring
  static constexpr uint32_t PLANE = BM * BKH * 2;  // one plane's box: BM rows x 128 B
  static constexpr uint32_t X_BYTES = P * PLANE;
  static constexpr uint32_t STG_OFF = XST * X_BYTES;
  static constexpr uint32_t BS_OFF = STG_OFF + (LDW ? LST * STAGE_BYTES : XST * W8_BYTES);
  static constexpr uint32_t BAR_OFF = BS_OFF + BST * B_BYTES;  // 2 (XST + BST) + LST mbarriers
  static constexpr size_t SMEM = BAR_OFF + 16 * (XST + BST) + 8 * LST + 1024;
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
  using T = HopperTile<P, 0>;  // the x ring is the same with either w route
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

// ------------------------------------------- w by plain loads (LDW = 1)

// one 1-D bulk copy (no tensor map) of `bytes` (a 16-byte multiple) from
// src (16-byte aligned) to shared memory at dst, completing on bar
__device__ __forceinline__ void bulk_load(uint32_t dst, uintptr_t src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ uint32_t ld_shared4(uint32_t a) {
  uint32_t v;
  asm volatile("ld.shared.u32 %0, [%1];\n" : "=r"(v) : "r"(a) : "memory");
  return v;
}
__device__ __forceinline__ void st_shared4(uint32_t a, uint32_t v) {
  asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(a), "r"(v) : "memory");
}

// the aligned 16-byte block at src into shared memory at dst, byte by
// byte, its bytes outside w's [lo, hi) zero
__device__ __forceinline__ void edge_block(uint32_t dst, uintptr_t src, uintptr_t lo,
                                           uintptr_t hi) {
  uint32_t v[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int b = 0; b < 16; ++b)
    if (src + b >= lo && src + b < hi)
      v[b >> 2] |= (uint32_t)__ldg(reinterpret_cast<const unsigned char*>(src + b))
                   << (8 * (b & 3));
  st_shared16(dst, v[0], v[1], v[2], v[3]);
}

// Row r of a w tile (w's row k0 + r, bytes [n0, n0 + 128)) into shared
// memory at `row`: the aligned 16-byte blocks from floor16(row start) that
// hold its bytes below N, by one bulk copy completing on bar (an arrival
// with its bytes expected); the block that holds w's first byte, or its
// last, is copied byte by byte (edge_block). Every producer thread arrives
// on bar once a tile, with or without a row; rows k >= K are not copied
// (realign_rows zeroes them).
__device__ __forceinline__ void stage_row(uint32_t row, uint32_t bar, const int8_t* w, int N,
                                          int K, int k0, int n0, int r) {
  if (r >= 0 && k0 + r < K) {
    const uintptr_t lo = reinterpret_cast<uintptr_t>(w), hi = lo + (uintptr_t)K * N;
    const uintptr_t a = lo + (uintptr_t)(k0 + r) * N + n0, a0 = a & ~(uintptr_t)15;
    const uintptr_t end = (a + min(HT, N - n0) + 15) & ~(uintptr_t)15;  // past the last block
    int j0 = 0, j1 = (int)((end - a0) >> 4);
    if (a0 < lo) {
      edge_block(row, a0, lo, hi);
      j0 = 1;
    }
    if (end > hi && j1 > j0) {
      edge_block(row + 16 * (j1 - 1), end - 16, lo, hi);
      --j1;
    }
    if (j1 > j0) {
      const uint32_t bytes = 16u * (j1 - j0);
      mbar_expect_tx(bar, bytes);  // the arrival, with the copy's bytes
      bulk_load(row + 16 * j0, a0 + 16 * j0, bytes, bar);
      return;
    }
  }
  mbar_arrive(bar);
}

// Tile k0 of w into staging slot `stg`, completing on bar, by the 128
// producer threads (lane `lane` of warp q). Where its 64 rows lie in whole
// super-rows (`boxed`): rows of residue r0 = k % 16 by 16 boxes (rows r0,
// r0 + 16, r0 + 32, r0 + 48, each from the aligned 16-byte block that
// holds its byte n0, at stg + r0 BOX_PITCH, 144 bytes a row), issued by
// lanes 0-3 of each warp: r0 < 15 from the super-row map tmw, r0 = 15 from
// tmw15 (the same view 16 bytes on, which holds row 15 whole) where its
// super-rows lie in it (`boxed15`), else row 16 q + 15 by stage_row at stg
// + 15 BOX_PITCH + q ROW_PITCH, by lane 4 of warp q. Not boxed: row 16 q
// + i by stage_row at stg + r ROW_PITCH, by lane i < 16 of warp q.
__device__ __forceinline__ void stage_tile(uint32_t stg, uint32_t bar, const CUtensorMap* tmw,
                                           const CUtensorMap* tmw15, const int8_t* w, int N,
                                           int K, int k0, int n0, bool boxed, bool boxed15,
                                           int q, int lane) {
  const int r0 = 4 * q + lane, d0 = (int)(reinterpret_cast<uintptr_t>(w) & 15);
  if (!boxed) {
    const int r = lane < 16 ? 16 * q + lane : -1;
    stage_row(stg + r * ROW_PITCH, bar, w, N, K, k0, n0, r);
  } else if (lane < 4 && r0 < 15) {
    mbar_expect_tx(bar, BOX_BYTES);  // the arrival, with the box's bytes
    tma_load2(stg + r0 * BOX_PITCH, tmw, (d0 + r0 * N + n0) & ~15, k0 / 16, bar);
  } else if (lane == 3 && boxed15) {  // r0 == 15
    mbar_expect_tx(bar, BOX_BYTES);
    tma_load2(stg + 15 * BOX_PITCH, tmw15, (d0 + 15 * N + n0 - 16) & ~15, k0 / 16, bar);
  } else if (lane == 4 && !boxed15) {
    stage_row(stg + 15 * BOX_PITCH + q * ROW_PITCH, bar, w, N, K, k0, n0, 16 * q + 15);
  } else {
    mbar_arrive(bar);
  }
}

// ROWS staged rows from r0 of a tile staged by stage_tile, by one warp,
// 16 bytes at a time: lane l takes chunk c = l % 8 (int8 n0 + 16 c .. + 15)
// of rows r0 + l / 8 + 4 j, j < ROWS / 4, and hands each to put(r, c,
// words) (element 0 in the low byte); zero at n >= N and in rows k >= K.
// Each staged row starts with the aligned block that holds its byte n0, so
// it is shifted by its offset in that block.
template <int ROWS, class Put>
__device__ __forceinline__ void realign_rows(uint32_t stg, const int8_t* w, int N, int K, int k0,
                                             int n0, int r0, int lane, bool boxed, Put put) {
  const int c = lane & 7, left = min(HT, N - n0) - 16 * c;  // bytes of the chunk below N
  const bool edge = N - n0 < HT || k0 + BKH > K;  // a tile with bytes to zero
#pragma unroll 2
  for (int j = 0; j < ROWS / 4; ++j) {
    const int r = r0 + (lane >> 3) + 4 * j, k = k0 + r;
    // the row's offset in its first block (mod 16, so 32 bits will do):
    // whole words d, then bytes
    const uint32_t off =
        ((uint32_t)reinterpret_cast<uintptr_t>(w) + (uint32_t)k * (uint32_t)N + n0) & 15;
    const uint32_t row =
        boxed ? stg + (r & 15) * BOX_PITCH + (r >> 4) * ROW_PITCH : stg + r * ROW_PITCH;
    // blocks c and c + 1 of the row: eight lanes read one row's 128 bytes,
    // so neither load meets another lane's in a bank
    const uint4 b0 = ld_shared16(row + 16 * c), b1 = ld_shared16(row + 16 * c + 16);
    const uint32_t v[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
    const uint32_t d = off >> 2, sh = 8 * (off & 3);
    uint32_t x[5], o[4];
#pragma unroll
    for (int u = 0; u < 5; ++u)  // word u + d, by selects (no indexed registers)
      x[u] = d == 0 ? v[u] : d == 1 ? v[u + 1] : d == 2 ? v[u + 2] : v[u + 3];
#pragma unroll
    for (int u = 0; u < 4; ++u) o[u] = __funnelshift_r(x[u], x[u + 1], sh);
    if (edge) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int b = left - 4 * u;  // bytes of word u below N
        if (k >= K || b <= 0) o[u] = 0u;
        else if (b < 4) o[u] &= (1u << (8 * b)) - 1u;
      }
    }
    put(r, c, o);
  }
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
      const int col = col0 + 8 * j;  // even
      if (col >= N) continue;
      const float v0 = __fmul_rn(acc[4 * j + 2 * r], scale[col]);
      if (col + 1 >= N) {
        o[col] = v0;
      } else if (N & 1) {  // an odd N: rows of out alternate 8-byte alignment
        o[col] = v0;
        o[col + 1] = __fmul_rn(acc[4 * j + 2 * r + 1], scale[col + 1]);
      } else {
        *reinterpret_cast<float2*>(o + col) =
            make_float2(v0, __fmul_rn(acc[4 * j + 2 * r + 1], scale[col + 1]));
      }
    }
  }
}

template <int P, int LDW>
__global__ void __launch_bounds__(THREADS_H, 1)
    qmm_hopper(const __grid_constant__ CUtensorMap tmx, const __grid_constant__ CUtensorMap tmw,
               const __grid_constant__ CUtensorMap tmw15, const int8_t* __restrict__ w,
               const float* __restrict__ scale, float* __restrict__ out, int M, int N, int K,
               int super_rows, int super_rows15) {
  using T = HopperTile<P, LDW>;
  constexpr int XST = T::XST, BST = T::BST, MT = T::MT;
  constexpr int LX = XST - BST;  // x loads run LX tiles ahead of the conversion
  constexpr int LW = XST - 1;    // int8 w loads LW tiles ahead
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t base =
      (static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw)) + 1023u) & ~1023u;
  const uint32_t XS = base, STG = base + T::STG_OFF, BS = base + T::BS_OFF;
  // mbarriers: x full x XST, int8 w full x XST, B full x BST, B empty x
  // BST, staging slot full x LST
  const uint32_t x_full = base + T::BAR_OFF, w_full = x_full + 8 * XST;
  const uint32_t b_full = w_full + 8 * XST, b_empty = b_full + 8 * BST;
  const uint32_t s_full = b_empty + 8 * BST;
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
#pragma unroll
    for (int s = 0; s < LST; ++s)
      if (LDW) mbar_init(s_full + 8 * s, 128);  // every producer thread, a row or none
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    if constexpr (LDW) {
      // producer, w where TMA cannot load it as tiles: thread 0 keeps x's
      // TMA loads LX tiles ahead; the warpgroup stages each w tile LST tiles
      // ahead (stage_tile), and warp q realigns and converts rows 16 q ..
      // 16 q + 15 into the B tile
      const int tid = threadIdx.x, q = tid >> 5, lane = tid & 31;
      auto boxed = [&](int kt) { return (kt + 1) * BKH <= 16 * super_rows; };
      auto stage = [&](int kt) {
        if (kt < n_kt)
          stage_tile(STG + (kt % LST) * STAGE_BYTES, s_full + 8 * (kt % LST), &tmw, &tmw15, w, N,
                     K, kt * BKH, n0, boxed(kt), (kt + 1) * BKH <= 16 * super_rows15, q, lane);
      };
      if (tid == 0)
        for (int t = 0; t < LX && t < n_kt; ++t) load_x<P>(XS, x_full, &tmx, t, m0, M);
      for (int t = 0; t < LST; ++t) stage(t);
      for (int kt = 0; kt < n_kt; ++kt) {
        const int bs = kt % BST, sl = kt % LST;
        if (kt >= BST) mbar_wait(b_empty + 8 * bs, ((kt / BST) & 1) ^ 1);
        if (tid == 0 && kt + LX < n_kt) load_x<P>(XS, x_full, &tmx, kt + LX, m0, M);
        mbar_wait(s_full + 8 * sl, (kt / LST) & 1);
        // chunk c of row kr as 16 bf16: chunks 2 (c % 4) and + 1 of 64-n
        // block c / 4 (block 1 stores its upper half first, so the two
        // blocks' stores meet in no bank)
        const uint32_t b = BS + bs * B_BYTES;
        realign_rows<16>(STG + sl * STAGE_BYTES, w, N, K, kt * BKH, n0, 16 * q, lane, boxed(kt),
                         [&](int kr, int c, const uint32_t (&o)[4]) {
                           uint4 h0, h1;  // n 16 c .. + 7 and + 8 .. + 15
                           i8x4_to_bf16(o[0], h0.x, h0.y);
                           i8x4_to_bf16(o[1], h0.z, h0.w);
                           i8x4_to_bf16(o[2], h1.x, h1.y);
                           i8x4_to_bf16(o[3], h1.z, h1.w);
                           const uint32_t row = b + (c >> 2) * B_BLOCK + kr * 128;
                           const int c0 = (c & 3) * 2, sw = kr & 7, up = c >> 2;
                           const uint4 f = up ? h1 : h0, g = up ? h0 : h1;
                           st_shared16(row + (((c0 + up) ^ sw) << 4), f.x, f.y, f.z, f.w);
                           st_shared16(row + (((c0 + 1 - up) ^ sw) << 4), g.x, g.y, g.z, g.w);
                         });
        // the slot is read out by every producer thread (the values are
        // stored: no proxy fence before the copies that refill it)
        asm volatile("bar.sync 1, 128;\n" ::: "memory");
        stage(kt + LST);
        fence_proxy_async();  // the B tile (st.shared) is read by wgmma
        mbar_arrive(b_full + 8 * bs);
      }
    } else {
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

// x (M, K) -> P bf16 planes (P M, Kp), plane p's row m at row p M + m (Kp
// = K rounded up to 8, so a row is a whole 16-byte multiple; the padding
// holds zeros): f32 x (P = 3) split into hi, mid, lo; bf16 x (P = 1)
// copied as it is, for an x TMA cannot load (K % 8 != 0 or a base off
// 16-byte alignment). A thread takes 8 k of one row.
template <int P>
__global__ void __launch_bounds__(256)
    split_planes(const void* __restrict__ x, uint16_t* __restrict__ planes, int M, int K, int Kp,
                 int vec_x) {
  const int cpr = Kp / 8;
  const long long total = (long long)M * cpr;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < total; i += stride) {
    const int m = (int)(i / cpr), c = (int)(i % cpr) * 8;
    if constexpr (P == 1) {
      *reinterpret_cast<uint4*>(planes + (long long)m * Kp + c) =
          load_x8(static_cast<const __nv_bfloat16*>(x), M, K, m, c, K, vec_x);
    } else {
      const float* xf = static_cast<const float*>(x);
      uint32_t a[3][2], b[3][2];
      split3x4(load_x4(xf, M, K, m, c, K, vec_x), a);
      split3x4(load_x4(xf, M, K, m, c + 4, K, vec_x), b);
#pragma unroll
      for (int p = 0; p < 3; ++p)
        *reinterpret_cast<uint4*>(planes + ((long long)p * M + m) * Kp + c) =
            make_uint4(a[p][0], a[p][1], b[p][0], b[p][1]);
    }
  }
}

// --------------------------------------------- decode (M <= 16) on Hopper

constexpr int MAX_CLUSTER = 8;  // the portable cluster size

// a decode CTA's shared memory: DST stages, each an int8 w tile and P x
// planes of NP rows x 128 B; the 128 x NP partial; with LDW the staging
// ring
template <int NP, int P, int LDW>
struct DecodeTile {
  static constexpr int DST = 4;              // stages of the ring
  static constexpr uint32_t XT = NP * 128;   // one plane's x tile
  static constexpr uint32_t X_OFF = DST * W8_BYTES;
  static constexpr uint32_t RED_OFF = X_OFF + DST * P * XT;
  static constexpr uint32_t STG_OFF = RED_OFF + NP * HT * 4;
  static constexpr uint32_t BAR_OFF = STG_OFF + (LDW ? LST * STAGE_BYTES : 0);
  static constexpr size_t SMEM = BAR_OFF + 8 * (3 * DST + LST) + 1024;  // the mbarriers
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

// The decode route's k order inside a k16 step. Thread t of a quad holds
// the A fragment's k columns 2t, 2t + 1, 2t + 8, 2t + 9; they are taken to
// be w's k rows 4t .. 4t + 3 of the step, so that one 32-bit load of a w
// row serves them. B (x) follows: of the step's eight physical bf16 pairs
// (2i, 2i + 1), chunk 0 (logical k 0..7) holds pairs 0, 2, 4, 6 and chunk
// 1 (logical 8..15) pairs 1, 3, 5, 7.

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
// for x; with LDW every warp plain loads of both), warpgroups 1 and 2
// convert w in registers and multiply, c taking k16 steps 2 c and 2 c + 1
// of each tile
template <int NP, int P, int LDW>
__global__ void __launch_bounds__(384, 2)
    qmm_decode(const __grid_constant__ CUtensorMap tmw, const __grid_constant__ CUtensorMap tmw15,
               const int8_t* __restrict__ w,
               const void* __restrict__ xv, const float* __restrict__ scale,
               float* __restrict__ out, int M, int N, int K, int k_chunk, int vec_x,
               int super_rows, int super_rows15) {
  namespace cg = cooperative_groups;
  using T = DecodeTile<NP, P, LDW>;
  constexpr int DST = T::DST;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t WS = base, XS = base + T::X_OFF, STG = base + T::STG_OFF;
  float* red = reinterpret_cast<float*>(smem_raw + (base - raw) + T::RED_OFF);
  // mbarriers: w full (TMA, or the w loaders), x full (the x loaders),
  // empty (the consumers), with LDW staging slot full
  const uint32_t w_full = base + T::BAR_OFF, x_full = w_full + 8 * DST;
  const uint32_t empty = x_full + 8 * DST, s_full = empty + 8 * DST;
  cg::cluster_group cluster = cg::this_cluster();
  const int S = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int n0 = (int)(blockIdx.x / S) * HT;
  const int kt0 = rank * (k_chunk / BKH);
  const int n_kt = max(0, min(k_chunk / BKH, (K + BKH - 1) / BKH - kt0));
  const int tid = threadIdx.x;
  constexpr int XTHREADS = LDW ? 128 : 96;  // the x loaders: warps 1-3, or all of warpgroup 0

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < DST; ++s) {
      mbar_init(w_full + 8 * s, LDW ? 128 : 1);
      mbar_init(x_full + 8 * s, XTHREADS);  // every x thread, after its proxy fence
      mbar_init(empty + 8 * s, 8);          // one arrival per consumer warp
    }
#pragma unroll
    for (int s = 0; s < LST; ++s)
      if (LDW) mbar_init(s_full + 8 * s, 128);  // every producer thread, a row or none
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (!LDW && tid < 32) {
    // warp 0: the int8 tiles' TMA loads, each as soon as its stage is free
    for (int i = 0; i < n_kt; ++i) {
      const int s = i % DST;
      // the consumers have released tile i - DST: this stage is free
      if (i >= DST) mbar_wait(empty + 8 * s, ((i / DST) & 1) ^ 1);
      if (tid == 0) load_w(WS, w_full, &tmw, kt0 + i, s, n0);
    }
  } else if (tid < 128) {
    // x by warps 1-3 (all four warps with LDW). A slot e = 16 m + 4 qs + u
    // is 4 k of row m at 16 qs + 4 u: physical pairs 2 u and 2 u + 1 of k16
    // step qs, which go to word u of the step's chunks 0 and 1 (the decode
    // k order above). Each thread's slots are loaded two tiles ahead into
    // registers (an L2 round trip), split into planes for f32, and stored;
    // the planes' rows past M stay zero (written once here, never again).
    // With LDW, lane i < 16 of warp q also stages row 16 q + i of each w
    // tile LST tiles ahead (stage_row), and warp q realigns those 16 rows
    // into the int8 stage as TMA would store them.
    const int xt = LDW ? tid : tid - 32, q = tid >> 5, lane = tid & 31;
    for (uint32_t o = xt * 16; o < DST * P * T::XT; o += XTHREADS * 16)
      st_shared16(XS + o, 0u, 0u, 0u, 0u);
    constexpr int SLOTS = (16 * 16 + XTHREADS - 1) / XTHREADS;  // 16 rows x 16 slots
    struct XRegs {
      uint4 v[SLOTS];
    };
    auto boxed = [&](int i) { return (kt0 + i + 1) * BKH <= 16 * super_rows; };
    auto stage = [&](int i) {
      if (i < n_kt)
        stage_tile(STG + (i % LST) * STAGE_BYTES, s_full + 8 * (i % LST), &tmw, &tmw15, w, N, K,
                   (kt0 + i) * BKH, n0, boxed(i), (kt0 + i + 1) * BKH <= 16 * super_rows15, q,
                   lane);
    };
    auto load_xr = [&](int i, XRegs& r) {
#pragma unroll
      for (int j = 0; j < SLOTS; ++j) {
        const int e = xt + XTHREADS * j, m = e >> 4, k = (kt0 + i) * BKH + 4 * (e & 15);
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
        const int e = xt + XTHREADS * j, m = e >> 4, qs = (e >> 2) & 3, u = e & 3, sw = m & 7;
        if (m >= M) continue;
        const uint32_t at0 = XS + s * P * T::XT + m * 128 + (((2 * qs) ^ sw) << 4) + 4 * u;
        const uint32_t at1 = XS + s * P * T::XT + m * 128 + (((2 * qs + 1) ^ sw) << 4) + 4 * u;
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
      if constexpr (LDW) {
        // after x, which is at hand: the consumers convert w first, then
        // wait for x
        const int sl = i % LST;
        mbar_wait(s_full + 8 * sl, (i / LST) & 1);
        // chunk c of row kr swizzled as TMA stores it: at c ^ (kr & 7)
        realign_rows<16>(STG + sl * STAGE_BYTES, w, N, K, (kt0 + i) * BKH, n0, 16 * q, lane,
                         boxed(i), [&](int kr, int c, const uint32_t (&o)[4]) {
                           st_shared16(WS + s * W8_BYTES + kr * 128 + ((c ^ (kr & 7)) << 4),
                                       o[0], o[1], o[2], o[3]);
                         });
        // the slot is read out by every producer thread (the values are
        // stored: no proxy fence before the copies that refill it)
        asm volatile("bar.sync 1, 128;\n" ::: "memory");
        stage(i + LST);
        mbar_arrive(w_full + 8 * s);
      }
    };
    XRegs xa, xb;
    if constexpr (LDW)
      for (int t = 0; t < LST; ++t) stage(t);
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
             uint64_t outer, uint64_t row_bytes, uint32_t box_inner, uint32_t box_outer,
             CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_128B) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorInitializationError;
  const cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)outer};
  const cuuint64_t strides[1] = {(cuuint64_t)row_bytes};
  const cuuint32_t box[2] = {box_inner, box_outer};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = fn(map, dt, 2, const_cast<void*>(t), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// w's map: where TMA loads w (LDW = 0), its (N, K) tiles; else its
// super-row view (the LDW producers' boxes; rows k = 16 t + r0 as (16 N
// bytes, t) from floor16(w) = w - d0, a row stride of 16 N, a 16-byte
// multiple; boxes of 144 B x 4 super-rows, no swizzle, zeros past every
// edge), super_rows = K / 16 of them, or none (0) where N < 16 or K < 16.
// Row r0 of a super-row ends at byte d0 + (r0 + 1) N of it, so rows r0 < 15
// lie whole in its 16 N bytes only where d0 <= N: N >= 16 makes that so
// for every d0 (with N < 16 the boxes would zero-fill a row's last d0 - N
// bytes, so those shapes stage every row by stage_row instead).
//
// map15 is the same view from floor16(w) + 16, which holds each super-row's
// row 15 whole (rows k = 16 t + 15 from byte d0 + 15 N - 16); its last
// super-row would end 16 - d0 bytes past w where K % 16 == 0, so it holds
// (K - 1) / 16 of them (super_rows15)
int w_map(CUtensorMap* map, CUtensorMap* map15, const int8_t* w, int N, int K, int ldw,
          int* super_rows, int* super_rows15) {
  *super_rows = *super_rows15 = 0;
  if (!ldw) return make_map(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, w, N, K, (uint64_t)N, HT, BKH);
  if (K < 16 || N < 16) return 0;
  const uintptr_t d0 = reinterpret_cast<uintptr_t>(w) & 15;
  *super_rows = K / 16;
  int rc = make_map(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, w - d0, 16ULL * N, K / 16, 16ULL * N,
                    ROW_PITCH, 4, CU_TENSOR_MAP_SWIZZLE_NONE);
  if (rc != 0 || (K - 1) / 16 < 1) return rc;
  *super_rows15 = (K - 1) / 16;
  return make_map(map15, CU_TENSOR_MAP_DATA_TYPE_UINT8, w - d0 + 16, 16ULL * N, (K - 1) / 16,
                  16ULL * N, ROW_PITCH, 4, CU_TENSOR_MAP_SWIZZLE_NONE);
}

// x_rows x K bf16 at x_pitch bytes a row: bf16 x (M rows), or the planes
// of split_planes (P M rows)
template <int P, int LDW>
int launch_hopper(const void* x, int x_rows, uint64_t x_pitch, const int8_t* w,
                  const float* scale, float* out, int M, int N, int K, cudaStream_t st) {
  using T = HopperTile<P, LDW>;
  const long long tiles = (long long)((M + T::BM - 1) / T::BM) * ((N + HT - 1) / HT);
  if (tiles > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  CUtensorMap tmx, tmw = {}, tmw15 = {};
  int super_rows = 0, super_rows15 = 0;
  int rc = make_map(&tmx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, K, x_rows, x_pitch, BKH, T::BM);
  if (rc == 0) rc = w_map(&tmw, &tmw15, w, N, K, LDW, &super_rows, &super_rows15);
  if (rc != 0) return rc;
  cudaError_t e = cudaFuncSetAttribute(qmm_hopper<P, LDW>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)T::SMEM);
  if (e != cudaSuccess) return (int)e;
  qmm_hopper<P, LDW><<<(unsigned)tiles, THREADS_H, T::SMEM, st>>>(
      tmx, tmw, tmw15, w, scale, out, M, N, K, super_rows, super_rows15);
  return (int)cudaGetLastError();
}

// one launch: grid (N / 128 tiles x S), one cluster of S CTAs a tile, rank
// r taking k_chunk / 64 k tiles from r k_chunk
template <int NP, int P, int LDW>
int launch_decode(const void* x, const int8_t* w, const float* scale, float* out, int M, int N,
                  int K, int splits, int k_chunk, int vec_x, cudaStream_t st) {
  using T = DecodeTile<NP, P, LDW>;
  CUtensorMap tmw = {}, tmw15 = {};
  int super_rows = 0, super_rows15 = 0;
  const int rc = w_map(&tmw, &tmw15, w, N, K, LDW, &super_rows, &super_rows15);
  if (rc != 0) return rc;
  // past 48 KB the kernel needs a larger dynamic shared memory limit, set
  // once for each device
  static bool set[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= 64 || !set[dev]) {
    e = cudaFuncSetAttribute(qmm_decode<NP, P, LDW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
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
  e = cudaLaunchKernelEx(&cfg, qmm_decode<NP, P, LDW>, tmw, tmw15, w, x, scale, out, M, N, K,
                         k_chunk, vec_x, super_rows, super_rows15);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <int P, int LDW>
int launch_decode_np(const void* x, const int8_t* w, const float* scale, float* out, int M, int N,
                     int K, int splits, int k_chunk, int vec_x, cudaStream_t st) {
  return M <= 8 ? launch_decode<8, P, LDW>(x, w, scale, out, M, N, K, splits, k_chunk, vec_x, st)
                : launch_decode<16, P, LDW>(x, w, scale, out, M, N, K, splits, k_chunk, vec_x, st);
}

template <int NP, int P, int LDW>
int decode_clusters(int splits) {
  using T = DecodeTile<NP, P, LDW>;
  if (cudaFuncSetAttribute(qmm_decode<NP, P, LDW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
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
  return cudaOccupancyMaxActiveClusters(&n, qmm_decode<NP, P, LDW>, &cfg) == cudaSuccess ? n : -1;
}

constexpr int SMALL_M = 16;  // M at or below this: a decode step

// The kernel a call runs, fixed by dtype, shape and alignment alone:
// 0 qmm_decode (M <= SMALL_M), 1 qmm_hopper on bf16 x, 2 qmm_hopper on f32
// x's planes, where TMA can load w (N % 16 == 0, a 16-byte-aligned base);
// 3, 4, 5 the same with w by plain loads (LDW) where it cannot.
// kernels/qmatmul.kernel_design is the same table.
int design(int is_bf16, int M, int N, const void* w) {
  const int ldw = (N % 16 == 0 && aligned16(w)) ? 0 : 3;
  if (M <= SMALL_M) return ldw;
  return ldw + (is_bf16 ? 1 : 2);
}

// qmm_hopper after split_planes<P> into ws (f32 x's three planes, or bf16
// x repitched to 16-byte rows), or on bf16 x itself where TMA can load it
template <int LDW>
int launch_prefill(const void* x, int is_bf16, const int8_t* w, const float* scale, float* out,
                   void* ws, int M, int N, int K, cudaStream_t st) {
  if (is_bf16 && K % 8 == 0 && aligned16(x))
    return launch_hopper<1, LDW>(x, M, (uint64_t)K * 2, w, scale, out, M, N, K, st);
  const int P = is_bf16 ? 1 : 3;
  if (ws == nullptr || !aligned16(ws) || (long long)P * M > 0x7FFFFFFFLL)
    return (int)cudaErrorInvalidValue;
  const int Kp = (K + 7) / 8 * 8;
  const long long chunks = (long long)M * (Kp / 8);
  long long blocks = (chunks + 255) / 256;
  if (blocks > 8192) blocks = 8192;
  uint16_t* planes = static_cast<uint16_t*>(ws);
  if (is_bf16)  // never TMA-loadable here: element loads
    split_planes<1><<<(unsigned)blocks, 256, 0, st>>>(x, planes, M, K, Kp, 0);
  else
    split_planes<3><<<(unsigned)blocks, 256, 0, st>>>(x, planes, M, K, Kp,
                                                      aligned16(x) && K % 4 == 0);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return is_bf16 ? launch_hopper<1, LDW>(ws, M, (uint64_t)Kp * 2, w, scale, out, M, N, K, st)
                 : launch_hopper<3, LDW>(ws, 3 * M, (uint64_t)Kp * 2, w, scale, out, M, N, K, st);
}

}  // namespace

// x: (M, K) row-major, bfloat16 (is_bf16 = 1) or float32; w: (K, N) int8
// row-major; scale: (N,) f32; out: (M, N) f32. k is cut into `splits`
// ranges of k_chunk (splits == ceil(K / k_chunk)). By design():
//   qmm_decode: splits is the cluster size (1, 2, 4 or 8), k_chunk a
//     multiple of 64; no scratch.
//   qmm_hopper: splits == 1; ws holds P M Kp bf16 (Kp = K rounded up to 8)
//     for split_planes<P>, which runs first: f32 x (P = 3), and bf16 x with
//     K % 8 != 0 or a base off 16-byte alignment (P = 1); else unused.
// Launches on ``stream``; returns cudaGetLastError().
extern "C" int qmatmul_launch(const void* x, int is_bf16, const int8_t* w, const float* scale,
                              float* out, void* ws, int M, int N, int K, int splits,
                              int k_chunk, void* stream) {
  if (M < 1 || N < 1 || K < 1 || splits < 1 || k_chunk < 1 ||
      (long long)(splits - 1) * k_chunk >= K || (long long)splits * k_chunk < K)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int d = design(is_bf16, M, N, w);
  const bool ldw = d >= 3;
  if (d % 3 != 0) {
    if (splits != 1) return (int)cudaErrorInvalidValue;
    return ldw ? launch_prefill<1>(x, is_bf16, w, scale, out, ws, M, N, K, st)
               : launch_prefill<0>(x, is_bf16, w, scale, out, ws, M, N, K, st);
  }
  if (splits > MAX_CLUSTER || (splits & (splits - 1)) != 0 || k_chunk % BKH != 0)
    return (int)cudaErrorInvalidValue;
  const int vec_x = aligned16(x) && K % (is_bf16 ? 8 : 4) == 0;
  if (is_bf16)
    return ldw ? launch_decode_np<1, 1>(x, w, scale, out, M, N, K, splits, k_chunk, vec_x, st)
               : launch_decode_np<1, 0>(x, w, scale, out, M, N, K, splits, k_chunk, vec_x, st);
  return ldw ? launch_decode_np<3, 1>(x, w, scale, out, M, N, K, splits, k_chunk, vec_x, st)
             : launch_decode_np<3, 0>(x, w, scale, out, M, N, K, splits, k_chunk, vec_x, st);
}

// design() above, for the wrapper to hold its table against
extern "C" int qmatmul_design(int is_bf16, int M, int N, const void* w) {
  return design(is_bf16, M, N, w);
}

// clusters of `splits` decode CTAs (NP = 8 or 16 rows, bf16 or f32 x, w
// by TMA (ldw 0) or by the LDW producers (ldw 1)) the device holds at once
// (cudaOccupancyMaxActiveClusters), or -1 on an error. The wrapper's split
// (kernels/qmatmul.cluster_split) reads no occupancy: this is for checks.
extern "C" int qmatmul_decode_clusters(int is_bf16, int np, int ldw, int splits) {
  using F = int (*)(int);
  static const F f[2][2][2] = {  // [ldw][is_bf16][np == 16]
      {{decode_clusters<8, 3, 0>, decode_clusters<16, 3, 0>},
       {decode_clusters<8, 1, 0>, decode_clusters<16, 1, 0>}},
      {{decode_clusters<8, 3, 1>, decode_clusters<16, 3, 1>},
       {decode_clusters<8, 1, 1>, decode_clusters<16, 1, 1>}}};
  return f[ldw != 0][is_bf16 != 0][np == 16](splits);
}

// The decode route's other form, for scripts/qmatmul_decode_forms.py: the
// shipped csrc/qmatmul.cu compiled together with qmm_decode_ss, which
// converts each int8 tile into a swizzled bf16 tile in shared memory (one
// warpgroup converts, one multiplies) and reads it as wgmma's MN-major A
// operand (the transpose flag). The shipped qmm_decode converts in
// registers instead (A from registers). form_launch(0, ...) runs the
// shipped kernel, form_launch(1, ...) this one, at a given cluster size.
#include "../src/repro_torch/csrc/qmatmul.cu"

namespace {
__device__ __forceinline__ void wgmma_wait1() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}
__device__ __forceinline__ void st_shared8(uint32_t a, uint32_t v0, uint32_t v1) {
  asm volatile("st.shared.v2.u32 [%0], {%1, %2};\n" ::"r"(a), "r"(v0), "r"(v1) : "memory");
}
// convert_w by NT threads (NT divides 512), every load issued before the
// first conversion
template <int NT>
__device__ __forceinline__ void convert_w_by(uint32_t stg, uint32_t bs, int tid) {
  constexpr int IT = BKH * 8 / NT;
  uint4 v[IT];
#pragma unroll
  for (int it = 0; it < IT; ++it) {
    const int i = tid + it * NT, j = (i >> 3) & 7, k = (i & 7) | ((i >> 6) << 3);
    v[it] = ld_shared16(stg + k * 128 + ((j ^ (k & 7)) << 4));
  }
#pragma unroll
  for (int it = 0; it < IT; ++it) {
    const int i = tid + it * NT, j = (i >> 3) & 7, k = (i & 7) | ((i >> 6) << 3);
    const int sw = k & 7;
    uint32_t o[8];
    i8x4_to_bf16(v[it].x, o[0], o[1]);
    i8x4_to_bf16(v[it].y, o[2], o[3]);
    i8x4_to_bf16(v[it].z, o[4], o[5]);
    i8x4_to_bf16(v[it].w, o[6], o[7]);
    const uint32_t row = bs + (j >> 2) * B_BLOCK + k * 128;
    const int c0 = (j & 3) * 2;
    st_shared16(row + ((c0 ^ sw) << 4), o[0], o[1], o[2], o[3]);
    st_shared16(row + (((c0 + 1) ^ sw) << 4), o[4], o[5], o[6], o[7]);
  }
}


template <int NP, int P, int XSD, int BSD>
struct DecodeTileSS {
  static constexpr uint32_t XT = NP * 128;
  static constexpr uint32_t STAGE = B_BYTES + P * XT;
  static constexpr uint32_t BS_OFF = XSD * W8_BYTES;
  static constexpr uint32_t RED_OFF = BS_OFF + BSD * STAGE;
  static constexpr uint32_t BAR_OFF = RED_OFF + NP * HT * 4;
  static constexpr size_t SMEM = BAR_OFF + 8 * (XSD + 2 * BSD) + 1024;
};
template <int NP>
__device__ __forceinline__ void wgmma_dec(float (&d)[NP / 2], uint64_t da, uint64_t db);
template <>
__device__ __forceinline__ void wgmma_dec<8>(float (&d)[4], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {%0, %1, %2, %3}, %4, %5, p, 1, 1, "
      "1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(da), "l"(db), "r"(1));
}
// PW producer warpgroups load and convert, the last warpgroup multiplies
template <int NP, int P, int XSD, int BSD, int PW>
__global__ void __launch_bounds__(128 * (PW + 1), 2)
    qmm_decode_ss(const __grid_constant__ CUtensorMap tmw, const void* __restrict__ xv,
               const float* __restrict__ scale, float* __restrict__ out, int M, int N, int K,
               int k_chunk, int vec_x) {
  namespace cg = cooperative_groups;
  using T = DecodeTileSS<NP, P, XSD, BSD>;
  constexpr int LW = XSD - 1;  // int8 w loads LW tiles ahead of the conversion
  constexpr int NT = 128 * PW;  // producer threads
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t STG = base, BS = base + T::BS_OFF;
  float* red = reinterpret_cast<float*>(smem_raw + (base - raw) + T::RED_OFF);
  // mbarriers: int8 w full x XSD, bf16 stage full x BSD, empty x BSD
  const uint32_t w_full = base + T::BAR_OFF, b_full = w_full + 8 * XSD;
  const uint32_t b_empty = b_full + 8 * BSD;
  cg::cluster_group cluster = cg::this_cluster();
  const int S = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int n0 = (int)(blockIdx.x / S) * HT;
  const int kt0 = rank * (k_chunk / BKH);
  const int n_kt = max(0, min(k_chunk / BKH, (K + BKH - 1) / BKH - kt0));
  const int tid = threadIdx.x;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < XSD; ++s) mbar_init(w_full + 8 * s, 1);
#pragma unroll
    for (int s = 0; s < BSD; ++s) {
      mbar_init(b_full + 8 * s, NT);  // every producer thread, after its proxy fence
      mbar_init(b_empty + 8 * s, 4);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid < NT) {
    // producer: the x planes' rows past M stay zero (only rows under M are
    // written below); thread 0 keeps the int8 loads LW tiles ahead
    for (uint32_t o = tid * 16; o < P * T::XT; o += NT * 16)
#pragma unroll
      for (int s = 0; s < BSD; ++s) st_shared16(BS + s * T::STAGE + B_BYTES + o, 0u, 0u, 0u, 0u);
    if (tid == 0)
      for (int t = 0; t < LW && t < n_kt; ++t) load_w(STG, w_full, &tmw, kt0 + t, t, n0);
    // x's 64-k slices, loaded into registers two tiles ahead (their L2
    // round trip would otherwise stall each tile): row m, 8 bf16 at 16-byte
    // chunk c (tid = 8 m + c), or 4 f32 at c4 4 (j = 16 m + c4)
    struct XRegs {
      uint4 b;
      float4 f[256 / NT];
    };
    auto load_xr = [&](int i, XRegs& r) {
      const int k0 = (kt0 + i) * BKH;
      r.b = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
      for (int it = 0; it < 256 / NT; ++it) r.f[it] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (i >= n_kt) return;
      if (P == 1) {
        const int m = tid >> 3, c = tid & 7;
        if (m < M)
          r.b = load_x8(static_cast<const __nv_bfloat16*>(xv), M, K, m, k0 + c * 8, K, vec_x);
      } else {
#pragma unroll
        for (int it = 0; it < 256 / NT; ++it) {
          const int j = tid + it * NT, m = j >> 4, c4 = j & 15;
          if (m < M)
            r.f[it] = load_x4(static_cast<const float*>(xv), M, K, m, k0 + c4 * 4, K, vec_x);
        }
      }
    };
    // tile i with its x slice in r, which then takes tile i + 2's
    auto step = [&](int i, XRegs& r) {
      const int bs = i % BSD;
      const uint32_t st = BS + bs * T::STAGE;
      // the consumer has released tile i - BSD: this bf16 stage is free
      if (i >= BSD) mbar_wait(b_empty + 8 * bs, ((i / BSD) & 1) ^ 1);
      // its int8 stage held tile i - 1, converted in the last step
      if (tid == 0 && i + LW < n_kt) load_w(STG, w_full, &tmw, kt0 + i + LW, (i + LW) % XSD, n0);
      mbar_wait(w_full + 8 * (i % XSD), (i / XSD) & 1);
      convert_w_by<NT>(STG + (i % XSD) * W8_BYTES, st, tid);
      // x^T's rows: row m of each plane, 16-byte chunk c at c ^ (m & 7)
      if (P == 1) {
        const int m = tid >> 3, c = tid & 7;
        if (m < M)
          st_shared16(st + B_BYTES + m * 128 + ((c ^ (m & 7)) << 4), r.b.x, r.b.y, r.b.z, r.b.w);
      } else {
#pragma unroll
        for (int it = 0; it < 256 / NT; ++it) {
          const int j = tid + it * NT, m = j >> 4, c4 = j & 15;
          if (m < M) {
            uint32_t o[3][2];
            split3x4(r.f[it], o);
            const uint32_t at = m * 128 + ((((c4 >> 1) ^ (m & 7))) << 4) + (c4 & 1) * 8;
#pragma unroll
            for (int p = 0; p < P; ++p) st_shared8(st + B_BYTES + p * T::XT + at, o[p][0], o[p][1]);
          }
        }
      }
      load_xr(i + 2, r);
      // generic-proxy writes read by wgmma (the async proxy): fence first
      fence_proxy_async();
      mbar_arrive(b_full + 8 * bs);
      asm volatile("bar.sync 1, %0;\n" ::"n"(NT) : "memory");  // the int8 stage is read out
    };
    XRegs xa, xb;
    load_xr(0, xa);
    load_xr(1, xb);
    for (int i = 0; i < n_kt; i += 2) {
      step(i, xa);
      if (i + 1 < n_kt) step(i + 1, xb);
    }
  } else {
    // consumer: out^T's 128 x NP tile as two m64 tiles (64-n blocks j),
    // one accumulator for each k16 step of a tile, so that a tile's eight
    // products do not wait on each other; one tile's group stays in flight
    // while the next is issued, and its stage is released a tile later
    const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    float acc[BKH / 16][2][NP / 2];
#pragma unroll
    for (int kk = 0; kk < BKH / 16; ++kk)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < NP / 2; ++e) acc[kk][j][e] = 0.f;
    for (int i = 0; i < n_kt; ++i) {
      const uint32_t st = BS + (i % BSD) * T::STAGE;
      mbar_wait(b_full + 8 * (i % BSD), (i / BSD) & 1);
#pragma unroll
      for (int kk = 0; kk < BKH / 16; ++kk)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < NP / 2; ++e) reg_fence(acc[kk][j][e]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BKH / 16; ++kk)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          // A: block j's k rows kk 16 .. + 15, MN-major (stride: 8 k rows);
          // B: plane p, K-major, 32 bytes a k16 step in the atom; the planes
          // lo, mid, hi in turn (small first)
          const uint64_t da = sw128_desc(st + j * B_BLOCK + kk * (16 * 128), B_BLOCK, 1024);
#pragma unroll
          for (int p = P - 1; p >= 0; --p)
            wgmma_dec<NP>(acc[kk][j], da,
                          sw128_desc(st + B_BYTES + p * T::XT + kk * 32, 16, 1024));
        }
      wgmma_commit();
      wgmma_wait1();  // tile i - 1's products are done: its stage is free
#pragma unroll
      for (int kk = 0; kk < BKH / 16; ++kk)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < NP / 2; ++e) reg_fence(acc[kk][j][e]);
      __syncwarp();
      if (lane == 0 && i > 0) mbar_arrive(b_empty + 8 * ((i - 1) % BSD));
    }
    wgmma_wait0();
#pragma unroll
    for (int kk = 0; kk < BKH / 16; ++kk)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < NP / 2; ++e) reg_fence(acc[kk][j][e]);
    // the partial, its k16 steps summed in order, into red[m HT + n] (the
    // m64nNP C layout per warp: element 4 c + 2 r + e at row 16 warp + g +
    // 8 r, column 8 c + 2 t + e)
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int c = 0; c < NP / 8; ++c)
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int q = 4 * c + 2 * r + e;
            red[(8 * c + 2 * t + e) * HT + 64 * j + 16 * warp + g + 8 * r] =
                __fadd_rn(__fadd_rn(__fadd_rn(acc[0][j][q], acc[1][j][q]), acc[2][j][q]),
                          acc[3][j][q]);
          }
  }
  // every rank's partial is in place: rank `rank` sums columns rank HT / S
  // .. + HT / S - 1 over the ranks in rank order, scales and stores them
  cluster.sync();
  const int cols = HT / S, c0 = rank * cols;
  for (int e = threadIdx.x; e < M * cols; e += NT + 128) {
    const int m = e / cols, n = c0 + e % cols;
    if (n0 + n >= N) continue;
    float s = *cluster.map_shared_rank(red + m * HT + n, 0);
    for (int q = 1; q < S; ++q) s = __fadd_rn(s, *cluster.map_shared_rank(red + m * HT + n, q));
    out[(long long)m * N + n0 + n] = __fmul_rn(s, scale[n0 + n]);
  }
  cluster.sync();  // every partial stays in place until its readers are done
}

template <int P>
int launch_ss(const void* x, const int8_t* w, const float* scale, float* out, int M, int N, int K,
              int splits, int k_chunk, int vec_x, cudaStream_t st) {
  using T = DecodeTileSS<8, P, 4, 3>;
  CUtensorMap tmw;
  const int rc = make_map(&tmw, CU_TENSOR_MAP_DATA_TYPE_UINT8, w, N, K, (uint64_t)N, HT, BKH);
  if (rc != 0) return rc;
  cudaFuncSetAttribute(qmm_decode_ss<8, P, 4, 3, 1>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)T::SMEM);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits; attr[0].val.clusterDim.y = 1; attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(((N + HT - 1) / HT) * splits));
  cfg.blockDim = dim3(256);
  cfg.dynamicSmemBytes = T::SMEM; cfg.stream = st; cfg.attrs = attr; cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, qmm_decode_ss<8, P, 4, 3, 1>, tmw, x, scale, out, M, N, K, k_chunk, vec_x);
}
}  // namespace

// form 0: the shipped register-A kernel, 1: the shared-memory-A kernel; M <= 8
extern "C" int form_launch(int form, int is_bf16, const void* x, const int8_t* w,
                           const float* scale, float* out, int M, int N, int K, int splits,
                           int k_chunk, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int vec_x = is_bf16 ? aligned16(x) && K % 8 == 0 : aligned16(x) && K % 4 == 0;
  if (form == 0)
    return is_bf16 ? launch_decode<8, 1, 0>(x, w, scale, out, M, N, K, splits, k_chunk, vec_x, st)
                   : launch_decode<8, 3, 0>(x, w, scale, out, M, N, K, splits, k_chunk, vec_x, st);
  return is_bf16 ? launch_ss<1>(x, w, scale, out, M, N, K, splits, k_chunk, vec_x, st)
                 : launch_ss<3>(x, w, scale, out, M, N, K, splits, k_chunk, vec_x, st);
}

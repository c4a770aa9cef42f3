// Packed OTA superpose / fold: y[m] = acc[m] + sum_k c_k * (s_k[m / qblock] * q_k[m]).
//
// Replaces the TPU kernels ota_packed_2d (superpose, acc absent) and
// ota_fold_2d (fold, acc present) of the JAX package's kernels/ota_fused.py.
// One kernel, templated on the wire symbol type (int8, int16, int32, f32
// passthrough, or row-major int4 nibbles: low nibble = even index,
// sign-extended) and on whether acc is read. Scales are one per row
// (nb == 1) or blockwise, one per qblock symbols (block index clipped to
// nb - 1). c_k = w_k, or w_k * g_k when a gains column is given, formed
// before the symbol math.
//
// Arithmetic. Every output column is independent, so no state crosses
// blocks. A lane owns a run of R consecutive symbols, 16 bytes of every row
// (16 int8, 8 int16, 4 int32/f32, 32 int4 symbols), and loops k = 0..K-1
// in ascending order. Every product and sum is an explicitly rounded f32 op
// (__fmul_rn / __fadd_rn: no FMA contraction), in the order (q * s) * c,
// then part + that, starting from part = 0, and last acc + part. The plain
// PyTorch version in kernels/ota_fused.py does the same ops in the same
// order, so the two agree bit for bit, and fold(zeros, b) == superpose(b).
//
// Bound: memory. One call reads K * M * (symbol bytes) + K * nb * 4 bytes
// of rows and scales, writes 4 M bytes, and reads 4 M more for a fold. On
// the barrier round's first group (2 int4 rows) the f32 output is 80% of the
// bytes, so the design is about the stores and about keeping loads in
// flight:
//
//   - Segments. A warp owns a segment of 32 runs (32 * R symbols: 1,024 at
//     int4); its 16-byte row loads are contiguous (512 bytes a warp).
//   - Coalesced stores. The warp stages its 32 * R results in shared memory
//     and writes them back as float4s with consecutive lanes on consecutive
//     addresses: every warp store instruction writes 512 consecutive bytes
//     (a lane's own 128 bytes at int4 would touch 32 lines an instruction).
//     The staging is swizzled (float4 chunk c of lane L sits at chunk
//     c ^ ((L / (8 / C)) % C) of the lane's C chunks), so neither the writes
//     nor the reads of a quarter-warp meet a bank twice. A fold reads acc in
//     the same coalesced order, issued before the segment's row loop.
//   - Loads in flight. The grid holds as many blocks as fit on the card at
//     once and walks the segments grid-stride. Row k + 1's load (with its
//     scale) is issued before row k is consumed, and the next segment's
//     first row load before this segment's stores.
//   - The ragged edge (M % (32 R) != 0) and unaligned rows or outputs take
//     scalar loads and guarded scalar stores in the same staging.

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

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

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

// symbol m of one row, as f32 (the scalar path)
template <int KIND>
__device__ __forceinline__ float load_one(const uint8_t* row, long long m) {
  if (KIND == KIND_INT8) return (float)reinterpret_cast<const int8_t*>(row)[m];
  if (KIND == KIND_INT16) return (float)reinterpret_cast<const int16_t*>(row)[m];
  if (KIND == KIND_INT32) return (float)reinterpret_cast<const int32_t*>(row)[m];
  if (KIND == KIND_F32) return reinterpret_cast<const float*>(row)[m];
  return nibble(row[m >> 1], (int)(m & 1));
}

// symbol j of a run held in one 16-byte register group
template <int KIND>
__device__ __forceinline__ float symbol(const Vec16& x, int j) {
  if (KIND == KIND_INT8) return (float)x.i8[j];
  if (KIND == KIND_INT16) return (float)x.i16[j];
  if (KIND == KIND_INT32) return (float)x.i32[j];
  if (KIND == KIND_F32) return x.f32[j];
  return nibble(x.u8[j >> 1], j & 1);
}

// part[j] += (v_j * s) * c, each op rounded
template <int KIND>
__device__ __forceinline__ void accumulate(float* part, const Vec16& x, float s, float c) {
#pragma unroll
  for (int j = 0; j < Run<KIND>::R; ++j)
    part[j] = __fadd_rn(part[j], __fmul_rn(__fmul_rn(symbol<KIND>(x, j), s), c));
}

// the staged position (in float4 chunks) of chunk c of lane L's C chunks
template <int C>
__device__ __forceinline__ int staged(int L, int c) {
  return L * C + (c ^ ((L / (8 / C)) % C));
}

template <int KIND, bool FOLD>
__global__ void __launch_bounds__(THREADS) ota_superpose_kernel(
    const uint8_t* __restrict__ q, int K, long long M, long long row_bytes,
    const float* __restrict__ scale, long long nb, long long qblock,
    const float* __restrict__ w, const float* __restrict__ gains,
    const float* __restrict__ acc, float* __restrict__ out, int aligned, long long n_seg) {
  constexpr int R = Run<KIND>::R;
  constexpr int C = R / 4;  // float4 chunks a lane
  constexpr long long SEG = 32LL * R;
  __shared__ float4 stage_all[WARPS * 32 * C];
  const int lane = threadIdx.x & 31;
  float4* stage = stage_all + (threadIdx.x >> 5) * 32 * C;
  const long long stride = (long long)gridDim.x * WARPS;
  const bool blockwise = qblock > 0 && nb > 1;

  long long seg = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  Vec16 pre;  // the next segment's row-0 load, issued before this one's stores
  float pre_s = 0.0f;
  bool have_pre = false;
  for (; seg < n_seg; seg += stride) {
    const long long m0 = seg * SEG + (long long)lane * R;  // this lane's run
    const long long byte0 = (seg * 32 + lane) * 16;       // its byte offset in a row
    const bool full = aligned && (seg + 1) * SEG <= M;
    const long long nseg = seg + stride;
    const bool next_full = aligned && nseg < n_seg && (nseg + 1) * SEG <= M;
    const int n = full ? R : (M - m0 <= 0 ? 0 : (M - m0 < R ? (int)(M - m0) : R));
    long long b0 = 0, b1 = 0;
    if (blockwise && n > 0) {
      b0 = min(m0 / qblock, nb - 1);
      b1 = min((m0 + n - 1) / qblock, nb - 1);
    }
    // acc in the store order, in flight under the row loop
    float4 a[FOLD ? C : 1];
    if (FOLD && full) {
#pragma unroll
      for (int j = 0; j < C; ++j)
        a[j] = *reinterpret_cast<const float4*>(acc + seg * SEG + 4LL * (32 * j + lane));
    }

    float part[R];
#pragma unroll
    for (int j = 0; j < R; ++j) part[j] = 0.0f;

    if (full && b0 == b1) {
      Vec16 cur;
      float cur_s;
      if (have_pre) {
        cur = pre;
        cur_s = pre_s;
      } else {
        cur.u = *reinterpret_cast<const uint4*>(q + byte0);
        cur_s = scale[b0];
      }
      for (int k = 0; k < K; ++k) {
        float c = w[k];
        if (gains != nullptr) c = __fmul_rn(c, gains[k]);
        Vec16 nxt;
        float nxt_s = 0.0f;
        if (k + 1 < K) {
          nxt.u = *reinterpret_cast<const uint4*>(q + (long long)(k + 1) * row_bytes + byte0);
          nxt_s = scale[(long long)(k + 1) * nb + b0];
        } else if (next_full) {
          // the next segment's first row (its scale block may differ)
          const long long nm0 = nseg * SEG + (long long)lane * R;
          pre.u = *reinterpret_cast<const uint4*>(q + (nseg * 32 + lane) * 16);
          pre_s = scale[blockwise ? min(nm0 / qblock, nb - 1) : 0];
        }
        accumulate<KIND>(part, cur, cur_s, c);
        cur = nxt;
        cur_s = nxt_s;
      }
      // (a next run that straddles two scale blocks takes the path below,
      // which reloads its rows and leaves pre unused)
      have_pre = next_full;
    } else {
      have_pre = false;
      for (int k = 0; k < K; ++k) {
        float c = w[k];
        if (gains != nullptr) c = __fmul_rn(c, gains[k]);
        const uint8_t* row = q + (long long)k * row_bytes;
        const float* srow = scale + (long long)k * nb;
        float v[R];
        if (full) {
          Vec16 x;
          x.u = *reinterpret_cast<const uint4*>(row + byte0);
#pragma unroll
          for (int j = 0; j < R; ++j) v[j] = symbol<KIND>(x, j);
        } else {
#pragma unroll
          for (int j = 0; j < R; ++j) v[j] = j < n ? load_one<KIND>(row, m0 + j) : 0.0f;
        }
#pragma unroll
        for (int j = 0; j < R; ++j) {
          const float s = b0 == b1 ? srow[b0] : srow[min((m0 + j) / qblock, nb - 1)];
          part[j] = __fadd_rn(part[j], __fmul_rn(__fmul_rn(v[j], s), c));
        }
      }
    }

    // stage the warp's results, then write them back coalesced
    if (C > 1) {
#pragma unroll
      for (int j = 0; j < C; ++j)
        stage[staged<C>(lane, j)] =
            make_float4(part[4 * j], part[4 * j + 1], part[4 * j + 2], part[4 * j + 3]);
      __syncwarp();
    }
#pragma unroll
    for (int j = 0; j < C; ++j) {
      const int g = 32 * j + lane;  // float4 chunk of the segment this lane writes
      float4 o = C > 1 ? stage[staged<C>(g / C, g % C)]
                       : make_float4(part[0], part[1], part[2], part[3]);
      const long long m = seg * SEG + 4LL * g;
      if (full) {
        if (FOLD) {
          o.x = __fadd_rn(a[j].x, o.x);
          o.y = __fadd_rn(a[j].y, o.y);
          o.z = __fadd_rn(a[j].z, o.z);
          o.w = __fadd_rn(a[j].w, o.w);
        }
        *reinterpret_cast<float4*>(out + m) = o;
      } else {
        const float ov[4] = {o.x, o.y, o.z, o.w};
#pragma unroll
        for (int t = 0; t < 4; ++t)
          if (m + t < M) out[m + t] = FOLD ? __fadd_rn(acc[m + t], ov[t]) : ov[t];
      }
    }
    if (C > 1) __syncwarp();  // the staging is read before the next segment writes it
  }
}

// blocks an SM of one instantiation, read once
template <int KIND, bool FOLD>
int blocks_per_sm() {
  static int cached = 0;
  if (cached == 0) {
    int b = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&b, ota_superpose_kernel<KIND, FOLD>,
                                                      THREADS, 0) != cudaSuccess || b < 1)
      b = 1;
    cached = b;
  }
  return cached;
}

template <int KIND, bool FOLD>
void launch(const void* q, int K, long long M, long long row_bytes, const float* scale,
            long long nb, long long qblock, const float* w, const float* gains,
            const float* acc, float* out, int aligned, int sms, cudaStream_t stream) {
  const long long n_seg = (M + 32LL * Run<KIND>::R - 1) / (32LL * Run<KIND>::R);
  const long long want = (n_seg + WARPS - 1) / WARPS;
  const long long fit = (long long)sms * blocks_per_sm<KIND, FOLD>();
  const unsigned blocks = (unsigned)(want < fit ? want : fit);
  ota_superpose_kernel<KIND, FOLD><<<blocks, THREADS, 0, stream>>>(
      reinterpret_cast<const uint8_t*>(q), K, M, row_bytes, scale, nb, qblock, w, gains, acc,
      out, aligned, n_seg);
}

template <int KIND>
void launch_kind(const void* q, int K, long long M, long long row_bytes, const float* scale,
                 long long nb, long long qblock, const float* w, const float* gains,
                 const float* acc, float* out, int aligned, int sms, cudaStream_t stream) {
  if (acc != nullptr)
    launch<KIND, true>(q, K, M, row_bytes, scale, nb, qblock, w, gains, acc, out, aligned, sms,
                       stream);
  else
    launch<KIND, false>(q, K, M, row_bytes, scale, nb, qblock, w, gains, acc, out, aligned, sms,
                        stream);
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
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  switch (kind) {
    case KIND_INT8:
      launch_kind<KIND_INT8>(q, K, M, row_bytes, scale, nb, qblock, w, gains, acc, out, aligned,
                             sms, s);
      break;
    case KIND_INT16:
      launch_kind<KIND_INT16>(q, K, M, row_bytes, scale, nb, qblock, w, gains, acc, out, aligned,
                              sms, s);
      break;
    case KIND_INT32:
      launch_kind<KIND_INT32>(q, K, M, row_bytes, scale, nb, qblock, w, gains, acc, out, aligned,
                              sms, s);
      break;
    case KIND_F32:
      launch_kind<KIND_F32>(q, K, M, row_bytes, scale, nb, qblock, w, gains, acc, out, aligned,
                            sms, s);
      break;
    case KIND_INT4:
      launch_kind<KIND_INT4>(q, K, M, row_bytes, scale, nb, qblock, w, gains, acc, out, aligned,
                             sms, s);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// Stride-1 SAME 3x3x3 convolution in bf16 with Cin = 1 or 2, channels-last,
// for Hopper (sm_90a): the model's input conv, [x_t, low_res] -> the
// model's channels (Cin = 2), and the Seg encoder's input conv (Cin = 1),
// on wgmma with the 27 taps folded into K.
//
// Replaces the TPU kernel ddpm3d_tpu/ops/conv3d_mxu.py:_conv_kernel at Cin =
// 1 and 2 (the conv3d_mxu calls of those first layers). Same function as
// csrc/conv3d_sm90.cu: zero padding, bf16 products summed in f32, the f32
// bias, one rounding to bf16.
//
// Bound on the H100: bytes, and almost all of them stored. Per voxel the
// conv reads 2 * Cin bytes and writes 2 * Cout (256 at Cout = 128); its
// 54 * Cin * Cout FLOP are ~0.5 FLOP per byte or less. The torso kernel
// cannot take it (TMA needs 16-byte strides; a voxel is 2 or 4 bytes), and
// padding Cin to a chunk per tap would run 27 x 32 or more K for 27 * Cin
// useful. So:
//  1. K = tap * Cin + ci: 54 of one 64-wide chunk at Cin = 2, 27 of one
//     32-wide chunk at Cin = 1 (the rest zeros). The weight, packed
//     [Cout][32 * Cin] bf16 (ops/conv3d.py:pack_weight_narrow), is one [128][64]
//     tile (16 KB; at Cin = 1 its k >= 32 are zero and never read) per
//     column tile, loaded once per block into shared memory with the
//     128-byte swizzle, read by wgmma as B.
//  2. A from registers, gathered straight from device memory: a wgmma A
//     fragment register holds k = 2j, 2j + 1 of a row. At Cin = 2 that is
//     tap j of that voxel, one aligned 4-byte word; at Cin = 1 it is taps
//     2j and 2j + 1, two voxels apart in memory, so two 2-byte loads packed
//     into one word (low half tap 2j). Each thread loads its 2 rows x 8
//     registers per 64-row slice, zero outside the volume (the SAME
//     padding); neighbouring rows share them through L1.
//  3. 2 * Cin wgmma.mma_async m64n128k16 (RS) per 64-row slice (four at
//     Cin = 2, two at Cin = 1), one warpgroup per block, several blocks per
//     SM, each walking slices of the flattened voxels (grid-stride), so one
//     block's loads overlap another's stores.
//  4. Epilogue: + f32 bias (the block's 128 values kept in shared memory
//     from the start, so no device-memory load waits in the epilogue), one
//     bf16 rounding, each warp stages its 16 rows
//     x 256 bytes in shared memory (16-byte piece j at j ^ (row & 7)) and
//     writes them in 16-byte pieces, two whole rows per warp instruction.

#include <cuda_bf16.h>

#include "sm90_common.cuh"

namespace {

constexpr int kBN = 128;                // output channels per tile (N)
constexpr int kK = 64;                  // K of the staged weight tile
constexpr int kTaps = 27;
constexpr int kThreads = 128;           // one warpgroup
constexpr int kRows = 64;               // rows per slice (one m64 tile)
constexpr int kWBytes = kBN * kK * 2;   // the weight tile, 16 KB
constexpr int kStageRow = kBN * 2;      // staged output row, 256 bytes
constexpr int kSmem = 1024 + kWBytes + kRows * kStageRow + kBN * 4;

struct Shape {
  int D, H, W, Cout;
  int64_t M;   // voxels, B * D * H * W
  int slices;  // ceil(M / kRows)
};

__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define ACC8(o)                                                      \
  "+f"(d[o + 0]), "+f"(d[o + 1]), "+f"(d[o + 2]), "+f"(d[o + 3]),    \
      "+f"(d[o + 4]), "+f"(d[o + 5]), "+f"(d[o + 6]), "+f"(d[o + 7])

// d[64] += A (64x16 bf16, registers) * B (16x128 bf16, smem descriptor)
__device__ __forceinline__ void wgmma_m64n128k16_rs(float (&d)[64],
                                                    const unsigned (&a)[4],
                                                    uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n"
      "}\n"
      : ACC8(0), ACC8(8), ACC8(16), ACC8(24), ACC8(32), ACC8(40), ACC8(48),
        ACC8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}
#undef ACC8

// A row's voxel and which of its 3 depth / row / column neighbours exist.
struct RowAt {
  int64_t m;    // flat voxel (batch included); -1 past the end
  unsigned ok;  // bit kd*9 + kh*3 + kw: tap inside the volume
};

__device__ __forceinline__ RowAt row_at(const Shape& s, int64_t m) {
  RowAt r{-1, 0u};
  if (m >= s.M) return r;
  r.m = m;
  const int w = static_cast<int>(m % s.W);
  const int h = static_cast<int>((m / s.W) % s.H);
  const int d = static_cast<int>((m / (static_cast<int64_t>(s.W) * s.H)) % s.D);
  // per axis, bit k set when offset k - 1 stays inside
  const unsigned vd = 2u | (d > 0 ? 1u : 0u) | (d + 1 < s.D ? 4u : 0u);
  const unsigned vh = 2u | (h > 0 ? 1u : 0u) | (h + 1 < s.H ? 4u : 0u);
  const unsigned vw = 2u | (w > 0 ? 1u : 0u) | (w + 1 < s.W ? 4u : 0u);
#pragma unroll
  for (int t = 0; t < kTaps; ++t)
    if ((vd >> (t / 9)) & (vh >> ((t / 3) % 3)) & (vw >> (t % 3)) & 1u)
      r.ok |= 1u << t;
  return r;
}

// Offset of tap t from the row's voxel, in voxels.
__device__ __forceinline__ int64_t tap_offset(const Shape& s, int t) {
  return (static_cast<int64_t>(t / 9 - 1) * s.H + ((t / 3) % 3 - 1)) * s.W +
         (t % 3 - 1);
}

// Cin = 2: tap t of row r as one word, channels 0 and 1 of the voxel.
__device__ __forceinline__ unsigned tap_word(const Shape& s,
                                             const uint32_t* __restrict__ x,
                                             const RowAt& r, int t) {
  if (t >= kTaps || !((r.ok >> t) & 1u)) return 0u;
  return __ldg(x + r.m + tap_offset(s, t));
}

// Cin = 1: tap t of row r, the voxel's one bf16 value (its bits).
__device__ __forceinline__ unsigned tap_half(const Shape& s,
                                             const uint16_t* __restrict__ x,
                                             const RowAt& r, int t) {
  if (t >= kTaps || !((r.ok >> t) & 1u)) return 0u;
  return __ldg(x + r.m + tap_offset(s, t));
}

// Cin = 1: k = t, t + 1 of row r as one word (t even: low half k = t).
__device__ __forceinline__ unsigned tap_pair(const Shape& s,
                                             const uint16_t* __restrict__ x,
                                             const RowAt& r, int t) {
  return tap_half(s, x, r, t) | (tap_half(s, x, r, t + 1) << 16);
}

template <int kCin>
__global__ void __launch_bounds__(kThreads)
    conv3d_narrow_kernel(const void* __restrict__ xv,
                         const __nv_bfloat16* __restrict__ w,
                         const float* __restrict__ bias,
                         __nv_bfloat16* __restrict__ y, const Shape s) {
  constexpr int kKC = 32 * kCin;  // the packed weight's row: K, padded
  extern __shared__ unsigned char smem_raw[];
  const uint32_t wt = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const uint32_t stage = wt + kWBytes + warp * 16 * kStageRow;
  const uint32_t btab = wt + kWBytes + kRows * kStageRow;  // bias, f32
  const int n0 = blockIdx.y * kBN;
  {
    const int n = n0 + threadIdx.x;  // kThreads == kBN
    const float b = bias != nullptr && n < s.Cout ? bias[n] : 0.f;
    asm volatile("st.shared.f32 [%0], %1;\n" ::"r"(btab + 4 * threadIdx.x),
                 "f"(b)
                 : "memory");
  }

  // the weight tile: row n (column n0 + n) at n * 128, piece j at j ^ (n &
  // 7); pieces past the packed row (Cin = 1: j >= 4) are zero
  for (int i = threadIdx.x; i < kBN * 8; i += kThreads) {
    const int n = i >> 3, j = i & 7;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (n0 + n < s.Cout && j < kKC / 8)
      v = __ldg(reinterpret_cast<const uint4*>(w + (n0 + n) * kKC) + j);
    asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(
                     wt + n * 128 + ((j ^ (n & 7)) << 4)),
                 "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
                 : "memory");
  }
  // generic-proxy writes, read by wgmma through the async proxy
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  const uint64_t db = desc_sw128(wt);

  const int g = lane >> 2, tq = lane & 3;
  float acc[64];
  for (int sl = blockIdx.x; sl < s.slices; sl += gridDim.x) {
    const int64_t m0 = static_cast<int64_t>(sl) * kRows + warp * 16;
    const RowAt r0 = row_at(s, m0 + g), r1 = row_at(s, m0 + g + 8);
    // fragment ks: a0 / a1 = k 16ks + 2tq, +1 of rows g / g + 8, a2 / a3
    // the k 8 further. Cin = 2: k = 2 * tap + ci, one word per tap; Cin =
    // 1: k = tap, two taps per word
    unsigned a[kKC / 16][4];
#pragma unroll
    for (int ks = 0; ks < kKC / 16; ++ks) {
      if constexpr (kCin == 2) {
        const uint32_t* x = static_cast<const uint32_t*>(xv);
        const int t = 8 * ks + tq;
        a[ks][0] = tap_word(s, x, r0, t);
        a[ks][1] = tap_word(s, x, r1, t);
        a[ks][2] = tap_word(s, x, r0, t + 4);
        a[ks][3] = tap_word(s, x, r1, t + 4);
      } else {
        const uint16_t* x = static_cast<const uint16_t*>(xv);
        const int t = 16 * ks + 2 * tq;
        a[ks][0] = tap_pair(s, x, r0, t);
        a[ks][1] = tap_pair(s, x, r1, t);
        a[ks][2] = tap_pair(s, x, r0, t + 8);
        a[ks][3] = tap_pair(s, x, r1, t + 8);
      }
    }
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kKC / 16; ++ks)
      wgmma_m64n128k16_rs(acc, a[ks], db + 2 * ks);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(acc);

    // + bias (f32), one bf16 rounding, into this warp's 16 staged rows
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      float b0, b1;
      asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n"
                   : "=f"(b0), "=f"(b1)
                   : "r"(btab + 4 * (j * 8 + tq * 2))
                   : "memory");
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = g + 8 * h;
        const __nv_bfloat162 v = __floats2bfloat162_rn(
            acc[4 * j + 2 * h] + b0, acc[4 * j + 2 * h + 1] + b1);
        asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(
                         stage + r * kStageRow + ((j ^ (r & 7)) << 4) +
                         tq * 4),
                     "r"(*reinterpret_cast<const uint32_t*>(&v))
                     : "memory");
      }
    }
    __syncwarp();
    const int piece = lane & 15;
    const int col = n0 + piece * 8;
    const bool whole = col + 8 <= s.Cout && (s.Cout & 7) == 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = 2 * i + (lane >> 4);
      const int64_t m = m0 + r;
      if (m >= s.M || col >= s.Cout) continue;
      uint4 v;
      asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
                   : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
                   : "r"(stage + r * kStageRow + ((piece ^ (r & 7)) << 4))
                   : "memory");
      __nv_bfloat16* p = y + m * s.Cout + col;
      if (whole) {
        *reinterpret_cast<uint4*>(p) = v;
      } else {
        const uint32_t w4[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int k = 0; k < 8; ++k)
          if (col + k < s.Cout)
            p[k] = __ushort_as_bfloat16(
                static_cast<unsigned short>(w4[k / 2] >> (16 * (k & 1))));
      }
    }
    __syncwarp();  // the stage is read before the next slice refills it
  }
}

}  // namespace

extern "C" {

// x [B, D, H, W, Cin] bf16 with Cin = 1 (2-byte aligned) or 2 (4-byte
// aligned), w packed [Cout][32 * Cin] bf16 (16-byte aligned), bias f32
// [Cout] or NULL, y [B, D, H, W, Cout] bf16. Returns a cudaError_t.
int conv3d_narrow_launch(const void* x, const void* w, const float* bias,
                         void* y, int B, int D, int H, int W, int Cin,
                         int Cout, void* stream_ptr) {
  if (B <= 0 || D <= 0 || H <= 0 || W <= 0 || Cout <= 0 ||
      (Cin != 1 && Cin != 2) ||
      reinterpret_cast<uintptr_t>(x) % (2 * Cin) != 0 ||
      reinterpret_cast<uintptr_t>(w) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Shape s;
  s.D = D; s.H = H; s.W = W; s.Cout = Cout;
  s.M = static_cast<int64_t>(B) * D * H * W;
  const int64_t slices = (s.M + kRows - 1) / kRows;
  if (slices > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  s.slices = static_cast<int>(slices);
  auto kernel = Cin == 2 ? conv3d_narrow_kernel<2> : conv3d_narrow_kernel<1>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int sms = sm_count(&err);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t fill = static_cast<int64_t>(sms) * (per_sm > 0 ? per_sm : 1);
  const dim3 grid(static_cast<unsigned>(s.slices < fill ? s.slices : fill),
                  (Cout + kBN - 1) / kBN);
  kernel<<<grid, kThreads, kSmem, static_cast<cudaStream_t>(stream_ptr)>>>(
      x, static_cast<const __nv_bfloat16*>(w), bias,
      static_cast<__nv_bfloat16*>(y), s);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

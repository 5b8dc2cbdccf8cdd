// Stride-1 SAME 3x3x3 convolution in bf16 with Cin not a multiple of 8,
// channels-last, for Hopper (sm_90a), on wgmma with the 27 taps folded into
// K: the model's input conv, [x_t, low_res] -> the model's channels (Cin =
// 2), the Seg encoder's input conv (Cin = 1), in the 6-channel Seg models (a
// 3-channel conditioner) the main branch's (Cin = 4) and the encoder's
// (Cin = 3) input convs, and every other such Cin (from 9, on the gather
// instance; no model runs them).
//
// The JAX package computes these convs with XLA (ddpm3d_tpu/ops/conv3d.py:
// conv3d_decomposed): its Pallas conv, ops/conv3d_mxu.py:_conv_kernel,
// takes only Cin and Cout that are multiples of 128 (conv3d_mxu.py:72).
// The port runs them on this hand-written kernel as it runs every conv.
// Same function as csrc/conv3d_sm90.cu: zero padding, bf16 products summed
// in f32, the f32 bias, one rounding to bf16.
//
// Bound on the H100: bytes, and almost all of them stored. Per voxel the
// conv reads 2 * Cin bytes and writes 2 * Cout (256 at Cout = 128); its
// 54 * Cin * Cout FLOP are 53 FLOP per byte at Cin = 2 and 179 at Cin = 7
// (Cout = 128), under the ~295 the card's bf16 rate needs. The torso kernel
// cannot take it (TMA needs 16-byte strides; a voxel is 2 to 14 bytes),
// and padding Cin to a chunk per tap would run 27 x 16 or more K for 27 *
// Cin useful (the mma.sync kernel this one replaced did: 75-80 % of its K
// were zeros at Cin = 3 and 4, 81 % at Cin = 12). So:
//  1. K = tap * Cin + ci, padded with zeros to Kpad, a multiple of 16: 32
//     at Cin = 1, 64 at Cin = 2, then 96, 112, 144, 176 and 192 for Cin =
//     3 to 7. The weight, packed [Cout][Kpad] bf16
//     (ops/conv3d.py:pack_weight_narrow), is staged as [128][64] tiles (16
//     KB each, one per 64 of K, at most 48 KB) per column tile, loaded once
//     per block into shared memory with the 128-byte swizzle, read by wgmma
//     as B (k >= Kpad of the last tile are zero and never read).
//  2. A from registers, gathered straight from device memory: a wgmma A
//     fragment register holds k = 2j, 2j + 1 of a row. At Cin = 2 that is
//     tap j of that voxel, one aligned 4-byte word; at Cin = 1 it is taps
//     2j and 2j + 1, two voxels apart in memory, so two 2-byte loads packed
//     into one word (low half tap 2j). At Cin = 3 to 7 a table in shared
//     memory, built once per block, gives each k its offset from the row's
//     voxel (in elements) and its tap (27 for the padding k). At even Cin
//     (4, 6) k = 2j and 2j + 1 are two channels of one tap, one aligned
//     4-byte load; at odd Cin (3, 5, 7) the voxel is not word-aligned and a
//     tap's last channel pairs with the next tap's first, so two 2-byte
//     loads. Padding each tap to an even width instead (Cin = 3 -> 4, K =
//     108 -> 112) would not save a load at odd Cin (a voxel of 3 channels
//     starts at an odd element every other voxel, so the pair is still not
//     a word) and would add wgmma K (at Cin = 5: 176 -> 192), so K stays
//     folded. Each thread loads its 2 rows x Kpad / 8 registers per 64-row
//     slice, zero outside the volume (the SAME padding); neighbouring rows
//     share them through L1.
//  3. Kpad / 16 wgmma.mma_async m64n128k16 (RS) per 64-row slice (2 at Cin
//     = 1 up to 12 at Cin = 7), one warpgroup per block, several blocks per
//     SM, each walking slices of the flattened voxels (grid-stride), so one
//     block's loads overlap another's stores.
//  4. Epilogue: + f32 bias (the block's 128 values kept in shared memory
//     from the start, so no device-memory load waits in the epilogue), one
//     bf16 rounding, each warp stages its 16 rows
//     x 256 bytes in shared memory (16-byte piece j at j ^ (row & 7)) and
//     writes them in 16-byte pieces, two whole rows per warp instruction.
//  5. From Cin = 9 the bound turns to operations (at Cin = 12: 0.074 ms at
//     [1,96^3,12]->128), Kpad / 8 registers of A a row no longer fit beside
//     the 64 accumulators, and the weight (64 KB at Cin = 9, 880 KB at Cin
//     = 130) leaves no room for several blocks an SM. So the gather
//     instance, for any Cin: A is gathered a chunk at a time (64 k, four
//     k-steps), chunk c + 1 into a second register buffer while chunk c's
//     wgmma run; the weight streams in 64-k tiles through a 4-slot
//     cp.async ring, each chunk's 64 k-table entries computed into the
//     slot beside its tile (the whole table would grow with Cin); three
//     warpgroups take one 192-row slice together, so each tile serves 192
//     voxels, one barrier a chunk.

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

// The gather instance: warpgroups per block, the k-steps of A gathered at
// a time (one 64-k weight tile), the ring of weight tiles and k tables
constexpr int kWG = 3;
constexpr int kSteps = kK / 16;  // k-steps per chunk
constexpr int kRing = 4;

// The instance for Cin: its K padded to a multiple of 16, its weight tiles
// and its dynamic shared memory (alignment slack, weight tiles, staged
// output rows, bias and, at Cin >= 3, the k table of 8 bytes a k)
template <int kCin>
struct Narrow {
  static constexpr int kKpad = (kTaps * kCin + 15) / 16 * 16;
  static constexpr int kTiles = (kKpad + kK - 1) / kK;
  static constexpr int kTable = kCin >= 3 ? kKpad * 8 : 0;
  static constexpr int kSmem =
      1024 + kTiles * kWBytes + kRows * kStageRow + kBN * 4 + kTable;
};

// The gather instance's dynamic shared memory: alignment slack, the ring's
// weight tiles, staged output rows, bias and the ring's k tables (64
// entries of 8 bytes each)
constexpr int kGatherSmem = 1024 + kRing * kWBytes +
                            kWG * kRows * kStageRow + kBN * 4 +
                            kRing * kK * 8;

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

// The coordinates by 32-bit division while the voxels fit (64-bit division
// is a long software sequence, paid twice a slice per thread), and the 27
// tap bits as the AND of three masks: the taps of depth offset kd are bits
// 9 kd .. 9 kd + 8 (kD << 9 kd), of row offset kh bits 3 kh + 9 i (kH <<
// 3 kh), of column offset kw bits kw + 3 i (kW << kw).
__device__ __forceinline__ RowAt row_at(const Shape& s, int64_t m) {
  RowAt r{-1, 0u};
  if (m >= s.M) return r;
  r.m = m;
  int w, h, d;
  if (s.M <= 0xffffffffll) {
    const uint32_t mm = static_cast<uint32_t>(m);
    const uint32_t q = mm / static_cast<uint32_t>(s.W);
    w = static_cast<int>(mm - q * s.W);
    const uint32_t q2 = q / static_cast<uint32_t>(s.H);
    h = static_cast<int>(q - q2 * s.H);
    d = static_cast<int>(q2 % static_cast<uint32_t>(s.D));
  } else {
    w = static_cast<int>(m % s.W);
    h = static_cast<int>((m / s.W) % s.H);
    d = static_cast<int>((m / (static_cast<int64_t>(s.W) * s.H)) % s.D);
  }
  constexpr unsigned kD = 0x1ffu, kH = 0x1c0e07u, kW = 0x1249249u;
  const unsigned md =
      (d > 0 ? kD : 0u) | kD << 9 | (d + 1 < s.D ? kD << 18 : 0u);
  const unsigned mh =
      (h > 0 ? kH : 0u) | kH << 3 | (h + 1 < s.H ? kH << 6 : 0u);
  const unsigned mw =
      (w > 0 ? kW : 0u) | kW << 1 | (w + 1 < s.W ? kW << 2 : 0u);
  r.ok = md & mh & mw;
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

// Cin >= 3: the element at offset `off` from row r's voxel (its bf16 bits)
// if tap `tap` of the row lies inside the volume (tap 27, a padding k,
// never does), else 0.
template <int kCin>
__device__ __forceinline__ unsigned k_half(const uint16_t* __restrict__ x,
                                           const RowAt& r, int off, int tap) {
  if (!((r.ok >> tap) & 1u)) return 0u;
  return __ldg(x + r.m * kCin + off);
}

// Cin >= 3, even: k and k + 1 (channels ci, ci + 1 of one tap, ci even) of
// row r as one aligned word.
template <int kCin>
__device__ __forceinline__ unsigned k_word(const uint32_t* __restrict__ x,
                                           const RowAt& r, int off, int tap) {
  if (!((r.ok >> tap) & 1u)) return 0u;
  return __ldg(x + ((r.m * kCin + off) >> 1));
}

// The weight tiles of one column tile, packed [Cout][kpad] bf16 in device
// memory: tile tt holds k = 64 tt .. 64 tt + 63, row n (column n0 + n) at
// n * 128, piece j at j ^ (n & 7); pieces past the packed row (Cin = 1: j
// >= 4 of the one tile) and rows past Cout are zero
__device__ __forceinline__ void load_weight_tiles(
    uint32_t wt, const __nv_bfloat16* __restrict__ w, const Shape& s, int n0,
    int kpad, int tiles, int tid, int nthreads) {
  for (int i = tid; i < tiles * kBN * 8; i += nthreads) {
    const int tt = i / (kBN * 8), n = (i >> 3) % kBN, j = i & 7;
    const int k = tt * kK + j * 8;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (n0 + n < s.Cout && k < kpad)
      v = __ldg(reinterpret_cast<const uint4*>(
          w + static_cast<int64_t>(n0 + n) * kpad + k));
    asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(
                     wt + tt * kWBytes + n * 128 + ((j ^ (n & 7)) << 4)),
                 "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
                 : "memory");
  }
}

// The k table's entry for k = Cin * tap + ci at `at`: (offset of (tap, ci)
// from a row's first element, in elements; tap); a padding k (0, 27)
__device__ __forceinline__ void put_k_entry(uint32_t at, const Shape& s,
                                            int cin, int k) {
  int off = 0, tap = kTaps;
  if (k < kTaps * cin) {
    tap = k / cin;
    off = static_cast<int>(tap_offset(s, tap)) * cin + (k - tap * cin);
  }
  asm volatile("st.shared.v2.s32 [%0], {%1, %2};\n" ::"r"(at), "r"(off),
               "r"(tap)
               : "memory");
}

// + bias (f32), one bf16 rounding, this warp's 16 rows (from m0) staged at
// `stage` (16-byte piece j of row r at j ^ (r & 7)) and stored in 16-byte
// pieces, two whole rows per warp instruction
__device__ __forceinline__ void store_rows(const float (&acc)[64],
                                           uint32_t stage, uint32_t btab,
                                           __nv_bfloat16* __restrict__ y,
                                           const Shape& s, int64_t m0, int n0,
                                           int lane) {
  const int g = lane >> 2, tq = lane & 3;
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

template <int kCin>
__global__ void __launch_bounds__(kThreads)
    conv3d_narrow_kernel(const void* __restrict__ xv,
                         const __nv_bfloat16* __restrict__ w,
                         const float* __restrict__ bias,
                         __nv_bfloat16* __restrict__ y, const Shape s) {
  using N = Narrow<kCin>;
  constexpr int kKC = N::kKpad;  // the packed weight's row: K, padded
  extern __shared__ unsigned char smem_raw[];
  const uint32_t wt = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const uint32_t rows = wt + N::kTiles * kWBytes;  // the staged output
  const uint32_t stage = rows + warp * 16 * kStageRow;
  const uint32_t btab = rows + kRows * kStageRow;  // bias, f32
  const uint32_t ktab = btab + kBN * 4;  // Cin >= 3: (offset, tap) per k
  const int n0 = blockIdx.y * kBN;
  {
    const int n = n0 + threadIdx.x;  // kThreads == kBN
    const float b = bias != nullptr && n < s.Cout ? bias[n] : 0.f;
    asm volatile("st.shared.f32 [%0], %1;\n" ::"r"(btab + 4 * threadIdx.x),
                 "f"(b)
                 : "memory");
  }

  load_weight_tiles(wt, w, s, n0, kKC, N::kTiles, threadIdx.x, kThreads);
  if constexpr (kCin >= 3)
    for (int k = threadIdx.x; k < kKC; k += kThreads)
      put_k_entry(ktab + 8 * k, s, kCin, k);
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
    // 1: k = tap, two taps per word; Cin >= 3: k = Cin * tap + ci by the
    // table, one word (even Cin) or two halves (odd Cin) per register
    unsigned a[kKC / 16][4];
#pragma unroll
    for (int ks = 0; ks < kKC / 16; ++ks) {
      if constexpr (kCin >= 3 && kCin % 2 == 0) {
        const uint32_t* x = static_cast<const uint32_t*>(xv);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          int off, tap;
          asm volatile("ld.shared.v2.s32 {%0, %1}, [%2];\n"
                       : "=r"(off), "=r"(tap)
                       : "r"(ktab + 8 * (16 * ks + 2 * tq + 8 * h)));
          a[ks][2 * h] = k_word<kCin>(x, r0, off, tap);
          a[ks][2 * h + 1] = k_word<kCin>(x, r1, off, tap);
        }
      } else if constexpr (kCin >= 3) {
        const uint16_t* x = static_cast<const uint16_t*>(xv);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          int off0, tap0, off1, tap1;  // k and k + 1
          asm volatile("ld.shared.v4.s32 {%0, %1, %2, %3}, [%4];\n"
                       : "=r"(off0), "=r"(tap0), "=r"(off1), "=r"(tap1)
                       : "r"(ktab + 8 * (16 * ks + 2 * tq + 8 * h)));
          a[ks][2 * h] = k_half<kCin>(x, r0, off0, tap0) |
                         (k_half<kCin>(x, r0, off1, tap1) << 16);
          a[ks][2 * h + 1] = k_half<kCin>(x, r1, off0, tap0) |
                             (k_half<kCin>(x, r1, off1, tap1) << 16);
        }
      } else if constexpr (kCin == 2) {
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
    for (int ks = 0; ks < kKC / 16; ++ks)  // tile ks / 4, 32 bytes a step
      wgmma_m64n128k16_rs(acc, a[ks],
                          db + (kWBytes >> 4) * (ks >> 2) + 2 * (ks & 3));
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(acc);

    store_rows(acc, stage, btab, y, s, m0, n0, lane);
  }
}

// ------------------------------------------------- the gather instance --
// A row's first element (voxel * Cin; never read past the end) and its tap
// bits.
struct RowE {
  int64_t e;
  unsigned ok;
};

__device__ __forceinline__ RowE row_e(const Shape& s, int64_t m, int cin) {
  const RowAt r = row_at(s, m);
  return RowE{r.m * cin, r.ok};
}

// The element at offset `off` from row r's first (its bf16 bits) if tap
// `tap` of the row lies inside the volume, else 0.
__device__ __forceinline__ unsigned half_at(const uint16_t* __restrict__ x,
                                            const RowE& r, int off, int tap) {
  if (!((r.ok >> tap) & 1u)) return 0u;
  return __ldg(x + r.e + off);
}

// Even Cin: elements off, off + 1 (channels ci, ci + 1 of one tap, ci
// even) as one aligned word.
__device__ __forceinline__ unsigned word_at(const uint32_t* __restrict__ x,
                                            const RowE& r, int off, int tap) {
  if (!((r.ok >> tap) & 1u)) return 0u;
  return __ldg(x + ((r.e + off) >> 1));
}

// The kSteps A fragments of a chunk for rows r0 / r1, by the chunk's k
// table at `tab` (its first k): one word a register at even Cin, two
// halves at odd Cin (a k pair may straddle two taps).
template <bool kOdd>
__device__ __forceinline__ void gather_chunk(unsigned (&a)[kSteps][4],
                                             const void* __restrict__ xv,
                                             const RowE& r0, const RowE& r1,
                                             uint32_t tab, int tq) {
#pragma unroll
  for (int ks = 0; ks < kSteps; ++ks) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint32_t at = tab + 8 * (16 * ks + 2 * tq + 8 * h);
      if constexpr (kOdd) {
        const uint16_t* x = static_cast<const uint16_t*>(xv);
        int off0, tap0, off1, tap1;  // k and k + 1
        asm volatile("ld.shared.v4.s32 {%0, %1, %2, %3}, [%4];\n"
                     : "=r"(off0), "=r"(tap0), "=r"(off1), "=r"(tap1)
                     : "r"(at));
        a[ks][2 * h] =
            half_at(x, r0, off0, tap0) | (half_at(x, r0, off1, tap1) << 16);
        a[ks][2 * h + 1] =
            half_at(x, r1, off0, tap0) | (half_at(x, r1, off1, tap1) << 16);
      } else {
        const uint32_t* x = static_cast<const uint32_t*>(xv);
        int off, tap;
        asm volatile("ld.shared.v2.s32 {%0, %1}, [%2];\n"
                     : "=r"(off), "=r"(tap)
                     : "r"(at));
        a[ks][2 * h] = word_at(x, r0, off, tap);
        a[ks][2 * h + 1] = word_at(x, r1, off, tap);
      }
    }
  }
}

// acc += the chunk's kSteps k-steps of the [128][64] weight tile at `desc`
// (32 bytes a step): A from registers.
__device__ __forceinline__ void mma_chunk(float (&acc)[64],
                                          const unsigned (&a)[kSteps][4],
                                          uint64_t desc) {
#pragma unroll
  for (int ks = 0; ks < kSteps; ++ks)
    wgmma_m64n128k16_rs(acc, a[ks], desc + 2 * ks);
}

__device__ __forceinline__ void cp_async16_or_zero(uint32_t dst,
                                                   const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Any Cin (the route sends Cin >= 9 that is not a multiple of 8): the
// weight streamed. A block's kWG warpgroups take 64 rows each of one
// 192-row slice together, so that each weight tile serves 192 voxels; the
// tiles and each chunk's 64-entry k table (computed per chunk: the whole
// table would grow with Cin) go through a ring of kRing slots by cp.async
// from all threads, one barrier a chunk. Chunk q of the block (its slice
// q / chunks, k from 64 (q % chunks)) lives in slot q % kRing; the loads of
// chunk q + kRing - 1 are issued at chunk q, after the barrier that shows
// every warpgroup done with chunk q - 1's slot. s.slices counts 192-row
// slices here.
template <bool kOdd>
__global__ void __launch_bounds__(kWG * kThreads, 1)
    conv3d_gather_kernel(const void* __restrict__ xv,
                         const __nv_bfloat16* __restrict__ w,
                         const float* __restrict__ bias,
                         __nv_bfloat16* __restrict__ y, const Shape s,
                         const int cin, const int kpad) {
  constexpr int kNT = kWG * kThreads;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t ring = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const uint32_t rows = ring + kRing * kWBytes;  // the staged output
  const uint32_t btab = rows + kWG * kRows * kStageRow;
  const uint32_t ktab = btab + kBN * 4;  // kRing slots of kK entries
  const int n0 = blockIdx.y * kBN;
  if (tid < kBN) {
    const int n = n0 + tid;
    const float b = bias != nullptr && n < s.Cout ? bias[n] : 0.f;
    asm volatile("st.shared.f32 [%0], %1;\n" ::"r"(btab + 4 * tid), "f"(b)
                 : "memory");
  }
  const int chunks = (kpad + kK - 1) / kK;
  const int64_t total =
      static_cast<int64_t>((s.slices - blockIdx.x + gridDim.x - 1) /
                           gridDim.x) * chunks;
  int64_t iq = 0;  // the next chunk to issue, its k chunk ic
  int ic = 0;
  auto issue = [&]() {
    if (iq < total) {
      const int slot = static_cast<int>(iq % kRing);
      const uint32_t dst = ring + slot * kWBytes;
      for (int i = tid; i < kBN * 8; i += kNT) {
        const int n = i >> 3, j = i & 7, k = ic * kK + j * 8;
        const bool ok = n0 + n < s.Cout && k < kpad;
        cp_async16_or_zero(dst + n * 128 + ((j ^ (n & 7)) << 4),
                           ok ? w + static_cast<int64_t>(n0 + n) * kpad + k
                              : w,
                           ok);
      }
      if (tid < kK) put_k_entry(ktab + 8 * (slot * kK + tid), s, cin,
                                ic * kK + tid);
      ++iq;
      ic = ic + 1 == chunks ? 0 : ic + 1;
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  for (int i = 0; i < kRing - 1; ++i) issue();
  __syncthreads();  // chunk 0's k table, the bias
  const int g = lane >> 2, tq = lane & 3, wg = tid >> 7;
  const uint32_t stage = rows + warp * 16 * kStageRow;

  float acc[64];
  unsigned a0[kSteps][4], a1[kSteps][4];
  int64_t q = 0;  // the chunk in flight
  for (int sl = blockIdx.x; sl < s.slices; sl += gridDim.x) {
    const int64_t m0 = static_cast<int64_t>(sl) * (kWG * kRows) +
                       wg * kRows + (warp & 3) * 16;
    const RowE r0 = row_e(s, m0 + g, cin), r1 = row_e(s, m0 + g + 8, cin);
    auto step = [&](unsigned (&cur)[kSteps][4], unsigned (&next)[kSteps][4],
                    int c) {
      cp_async_wait_group<kRing - 2>();  // this thread's copies of chunk q
      // generic-proxy writes, read by wgmma through the async proxy
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncthreads();
      issue();
      const uint32_t slot = static_cast<uint32_t>(q % kRing);
      wgmma_fence();
      mma_chunk(acc, cur, desc_sw128(ring + slot * kWBytes));
      wgmma_commit();
      if (c + 1 < chunks) {  // its k table arrived two barriers ago
        const uint32_t next_slot = static_cast<uint32_t>((q + 1) % kRing);
        gather_chunk<kOdd>(next, xv, r0, r1, ktab + 8 * kK * next_slot, tq);
      }
      wgmma_wait<0>();
      fence_acc(acc);
      ++q;
    };
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    fence_acc(acc);
    gather_chunk<kOdd>(a0, xv, r0, r1,
                       ktab + 8 * kK * static_cast<uint32_t>(q % kRing), tq);
    for (int c = 0; c < chunks; c += 2) {
      step(a0, a1, c);
      if (c + 1 < chunks) step(a1, a0, c + 1);
    }
    store_rows(acc, stage, btab, y, s, m0, n0, lane);
  }
  cp_async_wait_group<0>();
}

}  // namespace

namespace {

// A grid of at most `fill` blocks a column tile for `work` slices, after
// raising the kernel's dynamic shared memory to `smem`; false with `err`
// set if the kernel cannot run.
template <typename K>
bool plan_grid(K kernel, int threads, int smem, int64_t work, dim3* grid,
               int Cout, cudaError_t* err) {
  *err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (*err != cudaSuccess) return false;
  int per_sm = 0;
  *err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                       threads, smem);
  if (*err != cudaSuccess) return false;
  const int sms = sm_count(err);
  if (*err != cudaSuccess) return false;
  const int64_t fill = static_cast<int64_t>(sms) * (per_sm > 0 ? per_sm : 1);
  *grid = dim3(static_cast<unsigned>(work < fill ? work : fill),
               (Cout + kBN - 1) / kBN);
  return true;
}

// The launch's shape with slices of `rows` voxels, or false.
bool make_shape(Shape* s, int B, int D, int H, int W, int Cin, int Cout,
                int rows) {
  if (B <= 0 || D <= 0 || H <= 0 || W <= 0 || Cout <= 0 || Cin < 1)
    return false;
  // the k table's offsets are ints: (H W + W + 1) Cin must fit
  if ((static_cast<int64_t>(H) * W + W + 1) * Cin > 0x7fffffff ||
      static_cast<int64_t>(kTaps) * Cin + 2 * kK > 0x7fffffff)
    return false;
  s->D = D; s->H = H; s->W = W; s->Cout = Cout;
  s->M = static_cast<int64_t>(B) * D * H * W;
  const int64_t slices = (s->M + rows - 1) / rows;
  if (slices > 0x7fffffff) return false;
  s->slices = static_cast<int>(slices);
  return true;
}

}  // namespace

extern "C" {

// x [B, D, H, W, Cin] bf16 with Cin = 1 to 7 (4-byte aligned at even Cin,
// 2-byte at odd), w packed [Cout][Kpad] bf16 (16-byte aligned), bias f32
// [Cout] or NULL, y [B, D, H, W, Cout] bf16. Returns a cudaError_t.
int conv3d_narrow_launch(const void* x, const void* w, const float* bias,
                         void* y, int B, int D, int H, int W, int Cin,
                         int Cout, void* stream_ptr) {
  Shape s;
  if (Cin > 7 || reinterpret_cast<uintptr_t>(x) % (Cin % 2 ? 2 : 4) != 0 ||
      reinterpret_cast<uintptr_t>(w) % 16 != 0 ||
      !make_shape(&s, B, D, H, W, Cin, Cout, kRows))
    return static_cast<int>(cudaErrorInvalidValue);
  void (*kernel)(const void*, const __nv_bfloat16*, const float*,
                 __nv_bfloat16*, const Shape) = nullptr;
  int smem = 0;
  switch (Cin) {
#define NARROW_CASE(c)                                  \
  case c:                                               \
    kernel = conv3d_narrow_kernel<c>;                   \
    smem = Narrow<c>::kSmem;                            \
    break;
    NARROW_CASE(1) NARROW_CASE(2) NARROW_CASE(3) NARROW_CASE(4)
    NARROW_CASE(5) NARROW_CASE(6) NARROW_CASE(7)
#undef NARROW_CASE
  }
  cudaError_t err;
  dim3 grid;
  if (!plan_grid(kernel, kThreads, smem, s.slices, &grid, Cout, &err))
    return static_cast<int>(err);
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream_ptr)>>>(
      x, static_cast<const __nv_bfloat16*>(w), bias,
      static_cast<__nv_bfloat16*>(y), s);
  return static_cast<int>(cudaGetLastError());
}

// The gather instance: any Cin >= 1, the same operands and layout as
// conv3d_narrow_launch (w packed [Cout][Kpad], Kpad = 27 Cin padded to a
// multiple of 16). Returns a cudaError_t.
int conv3d_gather_launch(const void* x, const void* w, const float* bias,
                         void* y, int B, int D, int H, int W, int Cin,
                         int Cout, void* stream_ptr) {
  Shape s;
  if (Cin < 1 || reinterpret_cast<uintptr_t>(x) % (Cin % 2 ? 2 : 4) != 0 ||
      reinterpret_cast<uintptr_t>(w) % 16 != 0 ||
      !make_shape(&s, B, D, H, W, Cin, Cout, kWG * kRows))
    return static_cast<int>(cudaErrorInvalidValue);
  const int kpad = (kTaps * Cin + 15) / 16 * 16;
  auto kernel = Cin % 2 ? conv3d_gather_kernel<true>
                        : conv3d_gather_kernel<false>;
  cudaError_t err;
  dim3 grid;
  if (!plan_grid(kernel, kWG * kThreads, kGatherSmem, s.slices, &grid, Cout,
                 &err))
    return static_cast<int>(err);
  kernel<<<grid, kWG * kThreads, kGatherSmem,
           static_cast<cudaStream_t>(stream_ptr)>>>(
      x, static_cast<const __nv_bfloat16*>(w), bias,
      static_cast<__nv_bfloat16*>(y), s, Cin, kpad);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

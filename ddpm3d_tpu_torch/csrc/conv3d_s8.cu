// int8 (W8A8) stride-1 SAME 3x3x3 convolution, channels-last (NDHWC), with
// the dequantize epilogue, for Hopper (sm_90a): wgmma s8 fed by TMA.
//
// Replaces the TPU kernel ddpm3d_tpu/ops/conv3d_s8.py:_conv_kernel /
// _conv_kernel_im2col (reached through conv3d_s8), and serves every 3x3x3
// quantized conv site of the JAX package's int8 path (ops/quant.py:
// conv3d_folded_int8, upsample_conv_folded_int8). The 1x1x1 sites, which
// JAX leaves to XLA, run csrc/conv1x1_s8.cu (a streaming s8 GEMM over rows,
// its weights resident in shared memory); this launch refuses taps = 1.
// Same function:
//
//   acc[b,v,n] = sum_{taps,ci} xq[b, v + tap - pad, ci] * wq[tap, n, ci]
//                                                       s8 x s8 -> s32, exact
//   y[b,v,n]   = float(acc) * (sx[b] * sw[n]) + bias[n]   f32, no FMA
//
// rounded once to the output dtype (bf16 or f32). xq and wq are int8;
// zero padding is int8 0 (symmetric quantization has no zero point, so
// padding x and padding q(x) agree). |acc| <= 127^2 * 27 * 1024 ~ 4.5e8 <
// 2^31 at every shape of the model. The multiply and the add are rounded
// separately (__fmul_rn / __fadd_rn, not contracted; chip_smoke.py checks
// the SASS for FFMA), which is the JAX package's default lowering
// (quant.py:638-642): the kernel equals its plain version bit for bit.
//
// The phase route (upsample = 1) computes conv(nearest_up2_HW(x)) for the
// up-sampling sites: the four 2x2 phase kernels of ops/phase_up.py are
// stacked along the GEMM columns (n = p * Cout + c, p = 2a + b), each inside
// a zero 3x3 HW window (phase a = 0 reads rows {-1, 0}, a = 1 rows {0, +1}),
// so one launch on the low-resolution input computes all four phases with
// one activation scale, and the epilogue stores column n of voxel (d, h, w)
// to (d, 2h + a, 2w + b, c) of the upsampled output. There the bias is
// added after the rounding to the output dtype (y + bias in that dtype), as
// the JAX package's Conv3DFolded does at its up sites (ops/conv3d.py:319).
//
// Bound on the H100: operations at the 3x3x3 sites, 54 * Cin * Cout int8
// operations per output voxel against (Cin + 2 * Cout) bytes moved (bf16
// out): ~2200 op/byte at Cin = Cout = 128, above the card's ~590 int8
// op/byte ridge.
//
// Design: csrc/conv3d_sm90.cu (the bf16 K3) carried over byte for byte. A
// Cin chunk of 128 int8 channels is one 128-byte swizzle row, the halo pitch
// and weight-stage row of the bf16 kernel's 64-channel chunk:
//  1. wgmma.mma_async m64n128k32 s8 x s8 -> s32, A from registers (RS):
//     each warp gathers its 16 rows with ldmatrix from the swizzled halo (an
//     int8 16x32 fragment has the byte layout of a bf16 16x16 one), so one
//     staged halo serves every tap for any tile shape. Both operands are
//     K-major, as .s8 requires. Four k32 steps per (chunk, tap).
//  2. Weights ([taps][N][Cin], ops/conv3d_s8.py:pack_weight_s8) by TMA into
//     a ring of kStages = 4 stages of [128 cols][128 ch] (16 KB), 128-byte
//     swizzled, read as B through a shared-memory descriptor; full/empty
//     mbarrier pairs.
//  3. The halo by one cp.async.bulk.tensor.5d per (tile, chunk), map (C, W,
//     H, D, B), box (128, TW+2p, TH+2p, TD+2p, 1) at (c0, w0-p, h0-p, d0-p,
//     b), p = 1 at every launch (Shape::pad). TMA zero-fills outside the
//     tensor: the SAME padding and the ragged last Cin chunk. A ring of as
//     many halo stages (2 to 4) as shared memory holds, across chunks and
//     tiles: the model's tiles get 2 (each chunk's halo lands under the
//     previous chunk's taps).
//  4. Tiles of 256 (two consumer warpgroups x two m64 tiles) or 128 rows,
//     warp specialisation (producer setmaxnreg 40, consumers 232) and the
//     persistent grid, as in the bf16 kernel (ops/conv3d_s8.py:s8_tile).
//     f32 output (f32 models only: the int8 sites of a bf16 model write
//     bf16) takes 128-row tiles: with 256 rows its four-pass epilogue left
//     ptxas too few registers, and it serialized the wgmma.
//  5. Taps by mask: a 128-column tile of the phase route that lies inside
//     one phase (every up site of the model: Cout % 128 == 0) runs only that
//     phase's 12 taps (3 depth x its 2 rows x its 2 columns); the producer
//     loads only their weight stages. A tile that straddles phases runs the
//     union of their taps. (-DCONV3D_S8_ALL_TAPS builds the 27-tap version
//     for a study: the dropped taps' weights are zeros, so it gives the same
//     bits.)
//  6. Epilogue: dequantize in the order above, one rounding, staged in the
//     last chunk's halo stage in passes of 128 bytes a row (two for bf16,
//     four for f32),
//     in TMA's box order and 128-byte swizzle, and stored by one TMA tensor
//     store per pass (cp.async.bulk.tensor, which clips the volume's and
//     Cout's edges): the consumer threads spend no instructions on output
//     addresses. The phase route stores each pass through the map of its
//     phase: y seen from output voxel (0, a, b) with doubled H and W
//     strides. Where a pass would straddle phases or rows are not 16-byte
//     strided (odd widths, never the model's), the threads store 16-byte
//     pieces themselves, scattering each to its phase
//     (-DCONV3D_S8_THREAD_STORES builds that path everywhere, for a study).
//  7. The launch refuses a build whose register count would make setmaxnreg
//     wait (every instance must have the launch bound's 168), and every
//     mbarrier wait traps after ~8 s instead of hanging the card.

#include <cuda_bf16.h>

#include "sm90_common.cuh"

namespace {

constexpr int kBN = 128;                  // GEMM columns per tile (N)
constexpr int kBK = 128;                  // Cin chunk: one 128-byte row
constexpr int kRowBytes = kBK;            // bytes per voxel per chunk
constexpr int kStages = 4;                // weight ring
constexpr int kConsumers = 2;             // consumer warpgroups
constexpr int kThreads = 128 * (1 + kConsumers);
constexpr int kMaxRows = 128 * kConsumers;  // output voxels per tile
constexpr int kMaxHalo = 640;             // (TD+2)(TH+2)(TW+2), at most
constexpr int kMaxHaloStages = 4;         // the halo ring, 2 to 4 stages
constexpr int kStageRow = 128;            // epilogue bytes per staged row
constexpr int kWBytes = kBN * kRowBytes;  // one weight stage, 16 KB
constexpr int kLaunchRegs = 168;          // 65536 / 384, as ptxas allots
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;        // 128*40 + 256*232 = 384*168
static_assert(128 * kProducerRegs + 128 * kConsumers * kConsumerRegs <=
                  kThreads * kLaunchRegs,
              "setmaxnreg must not ask for more registers than launch gave");

struct Shape {
  int B, D, H, W, Cin;
  int N;      // GEMM columns: Cout, or 4 * Cout for the phase route
  int Cout;   // channels of y
  // the halo, 1 at every launch (the 1x1x1 conv, pad 0, is
  // csrc/conv1x1_s8.cu's). The kernel keeps it a parameter, and tap_mask
  // its test: with pad folded to the constant 1, ptxas scheduled the main
  // loop 3-6 % slower on an H100 (chip_smoke.py --parent-s8)
  int pad;
  int up;     // 1: the stacked phases of conv(nearest_up2_HW(x))
  int TD, TH, TW;
  int nD, nH, nW;
  int tiles;       // spatial tiles, B * nD * nH * nW
  int total;       // tiles * column tiles
  int chunks;      // Cin chunks of kBK
  int halo_tx;     // bytes one halo load writes
  int halo_bytes;  // one halo stage, rounded up to 1024
  int hstages;     // halo stages in the ring
  int tma_out;     // 1: the epilogue stores each pass by TMA
};

// The output's tensor maps: y, or on the phase route y at each phase p.
struct OutMaps {
  CUtensorMap m[4];
};

struct TileId {
  int b, d0, h0, w0, n0;
};

__device__ __forceinline__ TileId decode_tile(const Shape& s, int q) {
  TileId t;
  t.n0 = (q / s.tiles) * kBN;
  int i = q % s.tiles;
  const int tw = i % s.nW; i /= s.nW;
  const int th = i % s.nH; i /= s.nH;
  const int td = i % s.nD;
  t.b = i / s.nD;
  t.d0 = td * s.TD;
  t.h0 = th * s.TH;
  t.w0 = tw * s.TW;
  return t;
}

// The taps (bit kd*9 + kh*3 + kw) that the column tile at n0 runs. Phase
// p = 2a + b keeps kernel rows a..a+1 and columns b..b+1 of every depth
// tap: bits {0, 1, 3, 4} of a 3x3 plane (27) shifted to (a, b), repeated
// at depth offsets 0, 9, 18 (x 262657 = 1 + 2^9 + 2^18).
__device__ __forceinline__ uint32_t tap_mask(const Shape& s, int n0) {
  if (!s.pad) return 1u;  // never taken (Shape::pad)
#ifndef CONV3D_S8_ALL_TAPS
  if (s.up) {
    const int last = min(n0 + kBN, s.N) - 1;
    uint32_t m = 0;
    for (int p = n0 / s.Cout; p <= last / s.Cout; ++p)
      m |= (27u << (3 * (p >> 1) + (p & 1))) * 262657u;
    return m;
  }
#endif
  return (1u << 27) - 1;
}

// ------------------------------------------------------------ PTX shims --

__device__ __forceinline__ void fence_acc(int (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

#define ACC8(o)                                                      \
  "+r"(d[o + 0]), "+r"(d[o + 1]), "+r"(d[o + 2]), "+r"(d[o + 3]),    \
      "+r"(d[o + 4]), "+r"(d[o + 5]), "+r"(d[o + 6]), "+r"(d[o + 7])

// d[64] += A (64x32 s8, registers) * B (32x128 s8, smem descriptor), s32
__device__ __forceinline__ void wgmma_m64n128k32_s8(int (&d)[64],
                                                    const unsigned (&a)[4],
                                                    uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p;\n"
      "}\n"
      : ACC8(0), ACC8(8), ACC8(16), ACC8(24), ACC8(32), ACC8(40), ACC8(48),
        ACC8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}
#undef ACC8

// ------------------------------------------------------------ epilogue --

__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_float(float v) { return v; }
template <typename OutT>
__device__ __forceinline__ OutT from_float(float v);
template <>
__device__ __forceinline__ __nv_bfloat16 from_float(float v) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ float from_float(float v) {
  return v;
}

// One element: dequantize (and the bias where it goes before the rounding),
// round once to OutT; the phase route adds its bias to the rounded value
// and rounds again, as y + bias in OutT.
template <typename OutT>
__device__ __forceinline__ OutT dequant(int acc, float scale, bool has_bias,
                                        float bias, bool bias_late) {
  const float v = __fmul_rn(__int2float_rn(acc), scale);
  if (!has_bias) return from_float<OutT>(v);
  if (!bias_late) return from_float<OutT>(__fadd_rn(v, bias));
  return from_float<OutT>(__fadd_rn(to_float(from_float<OutT>(v)), bias));
}

// Two adjacent columns into the staged row (16-byte piece `piece`, byte
// `within` of it).
__device__ __forceinline__ void stage_pair(uint32_t addr, __nv_bfloat16 v0,
                                           __nv_bfloat16 v1) {
  const __nv_bfloat162 v = __halves2bfloat162(v0, v1);
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr),
               "r"(*reinterpret_cast<const uint32_t*>(&v))
               : "memory");
}
__device__ __forceinline__ void stage_pair(uint32_t addr, float v0,
                                           float v1) {
  asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n" ::"r"(addr), "f"(v0),
               "f"(v1)
               : "memory");
}

// Element k of a 16-byte piece of OutT values.
__device__ __forceinline__ __nv_bfloat16 piece_elem(const uint32_t (&w)[4],
                                                    int k, __nv_bfloat16*) {
  return __ushort_as_bfloat16(
      static_cast<unsigned short>(w[k / 2] >> (16 * (k & 1))));
}
__device__ __forceinline__ float piece_elem(const uint32_t (&w)[4], int k,
                                            float*) {
  return __uint_as_float(w[k]);
}

// Where column n of low-resolution voxel (b, d, h, w) goes in y.
template <typename OutT>
__device__ __forceinline__ OutT* out_ptr(const Shape& s, OutT* y, int b,
                                         int d, int h, int w, int n) {
  int c = n, oh = h, ow = w, oH = s.H, oW = s.W;
  if (s.up) {
    const int p = n / s.Cout;
    c = n - p * s.Cout;
    oh = 2 * h + (p >> 1);
    ow = 2 * w + (p & 1);
    oH *= 2;
    oW *= 2;
  }
  return y + (((static_cast<int64_t>(b) * s.D + d) * oH + oh) * oW + ow) *
                 s.Cout + c;
}

// ---------------------------------------------------------------- kernel --

// Shared memory: hstages halo stages, kStages weight stages (all
// 1024-aligned), the barriers, then the row table (output row r of a tile
// at (dz, hy, wx) as dz | hy << 8 | wx << 16).
struct Smem {
  uint32_t halo, w, bars, rowtab;
  int halo_bytes;
  __device__ __forceinline__ uint32_t halo_at(int i) const {
    return halo + i * halo_bytes;
  }
  __device__ __forceinline__ uint32_t w_at(int i) const {
    return w + i * kWBytes;
  }
  __device__ __forceinline__ uint32_t hfull(int i) const { return bars + 8 * i; }
  __device__ __forceinline__ uint32_t hempty(int i) const {
    return bars + 8 * (kMaxHaloStages + i);
  }
  __device__ __forceinline__ uint32_t wfull(int i) const {
    return bars + 8 * (2 * kMaxHaloStages + i);
  }
  __device__ __forceinline__ uint32_t wempty(int i) const {
    return bars + 8 * (2 * kMaxHaloStages + kStages + i);
  }
};
constexpr int kBars = 2 * kMaxHaloStages + 2 * kStages;

__device__ __forceinline__ Smem carve(const Shape& s, unsigned char* raw) {
  Smem m;
  m.halo_bytes = s.halo_bytes;
  m.halo = (smem_addr(raw) + 1023u) & ~1023u;
  m.w = m.halo + s.hstages * s.halo_bytes;
  m.bars = m.w + kStages * kWBytes;
  m.rowtab = m.bars + 8 * kBars;
  return m;
}

// The producer's halo load of the block's job n, (tile blockIdx.x + (n /
// chunks) * gridDim.x, chunk n % chunks), into stage n % hstages; nothing
// past the last tile.
__device__ __forceinline__ void load_halo(const Shape& s, const Smem& m,
                                          const CUtensorMap* tm_x, int n) {
  const int q = blockIdx.x + (n / s.chunks) * gridDim.x;
  if (q >= s.total) return;
  const int c = n % s.chunks;
  const int st = n % s.hstages;
  mbar_wait(m.hempty(st), ((n / s.hstages) & 1) ^ 1);
  const TileId t = decode_tile(s, q);
  mbar_expect_tx(m.hfull(st), s.halo_tx);
  tma_load_5d(m.halo_at(st), tm_x, m.hfull(st), c * kBK, t.w0 - s.pad,
              t.h0 - s.pad, t.d0 - s.pad, t.b);
}

// Halo-relative voxel of output row r at tap 0 (idle rows read voxel 0:
// valid shared memory, never stored).
__device__ __forceinline__ int row_base(const Shape& s, int r) {
  if (r >= s.TD * s.TH * s.TW) return 0;
  const int dz = r / (s.TH * s.TW);
  const int hy = (r / s.TW) % s.TH;
  const int wx = r % s.TW;
  return (dz * (s.TH + 2 * s.pad) + hy) * (s.TW + 2 * s.pad) + wx;
}

// kMT m64 tiles per consumer warpgroup: 2 gives 256-row tiles, 1 gives
// 128-row tiles (small volumes, where 256-row tiles leave SMs idle).
template <int kMT, typename OutT>
__global__ void __launch_bounds__(kThreads, 1)
    conv3d_s8_kernel(const __grid_constant__ CUtensorMap tm_x,
                     const __grid_constant__ CUtensorMap tm_w,
                     const __grid_constant__ OutMaps tm_y,
                     const float* __restrict__ sx,
                     const float* __restrict__ sw,
                     const float* __restrict__ bias, OutT* __restrict__ y,
                     const Shape s) {
  extern __shared__ unsigned char smem_raw[];
  const Smem m = carve(s, smem_raw);
  const int wg = threadIdx.x >> 7;
  const int lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int i = 0; i < s.hstages; ++i) {
      mbar_init(m.hfull(i), 1);
      mbar_init(m.hempty(i), 4 * kConsumers);  // one arrive per warp
    }
    for (int i = 0; i < kStages; ++i) {
      mbar_init(m.wfull(i), 1);
      mbar_init(m.wempty(i), 4 * kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ---------------------------------------------------- producer --
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x != 0) return;
    prefetch_tensormap(&tm_x);
    prefetch_tensormap(&tm_w);
    int job = 0, nw = 0;
    for (int n = 0; n + 1 < s.hstages; ++n) load_halo(s, m, &tm_x, n);
    for (int q = blockIdx.x; q < s.total; q += gridDim.x) {
      const TileId t = decode_tile(s, q);
      const uint32_t mask = tap_mask(s, t.n0);
      // job + hstages - 1 goes into the stage of job - 1, once the
      // consumers release it (after its last ldmatrix, or for a tile's
      // last chunk after its epilogue): issued after this job's weights
      // for tap index halo_tap, so that the weights run ahead of the math
      const int halo_tap = min(__popc(mask) - 1, 2 * kStages);
      for (int c = 0; c < s.chunks; ++c, ++job) {
        int i = 0;
        for (uint32_t mm = mask; mm != 0; mm &= mm - 1, ++i) {
          const int tap = __ffs(mm) - 1;
          const int st = nw % kStages;
          mbar_wait(m.wempty(st), ((nw / kStages) & 1) ^ 1);
          mbar_expect_tx(m.wfull(st), kWBytes);
          tma_load_3d(m.w_at(st), &tm_w, m.wfull(st), c * kBK, t.n0, tap);
          ++nw;
          if (i == halo_tap) load_halo(s, m, &tm_x, job + s.hstages - 1);
        }
      }
    }
    return;
  }

  // ------------------------------------------------------ consumers --
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int cwg = wg - 1;
  const int wq = (threadIdx.x >> 5) & 3;
  const int hi = lane >> 4;  // ldmatrix: lanes 16-31 give bytes 16..31
  {  // the row table, one row per consumer thread; the epilogue's first
     // barrier publishes it
    const int r = threadIdx.x - 128;
    if (r < s.TD * s.TH * s.TW) {
      const uint32_t code = (r / (s.TH * s.TW)) |
                            (((r / s.TW) % s.TH) << 8) | ((r % s.TW) << 16);
      asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(m.rowtab + 4 * r),
                   "r"(code)
                   : "memory");
    }
  }
  int rb[kMT];
#pragma unroll
  for (int mi = 0; mi < kMT; ++mi)
    rb[mi] = row_base(s, (cwg * kMT + mi) * 64 + wq * 16 + (lane & 15));

  int acc[kMT][64];
  unsigned a[2][kMT][4];  // [buffer][m-tile][fragment]
  int nh = 0, nw = 0;
  int pending = -1;  // weight stage whose wgmma may still be in flight

  // registers are at the launch bound's 168 here (128 accumulators): the
  // tile is decoded after its main loop, and the halo pitches come from
  // the kernel's parameters, or ptxas serializes the wgmma
  for (int q = blockIdx.x; q < s.total; q += gridDim.x) {
#pragma unroll
    for (int mi = 0; mi < kMT; ++mi) {
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[mi][i] = 0;
      fence_acc(acc[mi]);
    }
    const uint32_t mask = tap_mask(s, (q / s.tiles) * kBN);
    for (int c = 0; c < s.chunks; ++c) {
      const int hs = nh % s.hstages;
      mbar_wait(m.hfull(hs), (nh / s.hstages) & 1);
      for (uint32_t mm = mask; mm != 0;) {
        const int tap = __ffs(mm) - 1;
        mm &= mm - 1;
        const int ws = nw % kStages;
        mbar_wait(m.wfull(ws), (nw / kStages) & 1);
        const int kd = tap / 9, kh = (tap / 3) % 3, kw = tap % 3;
        const int toff =
            (kd * (s.TH + 2 * s.pad) + kh) * (s.TW + 2 * s.pad) + kw;
        uint32_t row[kMT];
        int key[kMT];
#pragma unroll
        for (int mi = 0; mi < kMT; ++mi) {
          const int v = rb[mi] + toff;
          row[mi] = m.halo_at(hs) + v * kRowBytes;
          key[mi] = v & 7;
        }
        const uint64_t db = desc_sw128(m.w_at(ws));
#pragma unroll
        for (int ks = 0; ks < kBK / 32; ++ks) {
          // the group that last read buffer ks & 1 (two groups back) is done
          wgmma_wait<1>();
          if (ks == 1 && pending >= 0) {
            // the previous tap's last group is done: free its weights
            if (lane == 0) mbar_arrive(m.wempty(pending));
            pending = -1;
          }
#pragma unroll
          for (int mi = 0; mi < kMT; ++mi)
            ldmatrix_x4(a[ks & 1][mi],
                        row[mi] + (((2 * ks + hi) ^ key[mi]) << 4));
          wgmma_fence();
#pragma unroll
          for (int mi = 0; mi < kMT; ++mi)
            wgmma_m64n128k32_s8(acc[mi], a[ks & 1][mi], db + 2 * ks);
          wgmma_commit();
        }
        pending = ws;
        if (mm == 0 && c + 1 < s.chunks) {
          // the chunk's last ldmatrix is done (a tile's last chunk keeps
          // its stage: the epilogue stages the output tile in it)
          __syncwarp();
          if (lane == 0) mbar_arrive(m.hempty(hs));
        }
        ++nw;
      }
      ++nh;
    }
    wgmma_wait<0>();
#pragma unroll
    for (int mi = 0; mi < kMT; ++mi) fence_acc(acc[mi]);
    if (lane == 0) mbar_arrive(m.wempty(pending));
    pending = -1;

    // epilogue: dequantize, round, stage the rows in the last chunk's halo
    // stage (free once both warpgroups are past their last ldmatrix), 128
    // bytes per row with 16-byte piece j at j ^ (row & 7) (TMA's 128-byte
    // swizzle, rows in the box's order); then one thread stores the pass
    // by TMA, or each warpgroup writes its rows in 16-byte pieces, a warp
    // covering four whole staged rows. bf16 takes two passes of 64
    // columns, f32 four of 32.
    constexpr int kPasses = kBN * sizeof(OutT) / kStageRow;
    constexpr int kJ = kBN / 8 / kPasses;      // 8-column groups per pass
    constexpr int kPiece = 16 / sizeof(OutT);  // columns per 16-byte piece
    const TileId t = decode_tile(s, q);
    const int g = lane >> 2, tq = lane & 3;
    const int rows = s.TD * s.TH * s.TW;
    // pass k stages into region k % regions of the stage (1024-aligned, as
    // the swizzle is): a 3x3x3 halo stage holds two, so a TMA-stored bf16
    // tile needs no wait between its passes
    const int region_bytes = (rows * kStageRow + 1023) & ~1023;
    const int regions = min(kPasses, s.halo_bytes / region_bytes);
    const float sxb = sx[t.b];
    const bool has_bias = bias != nullptr;
    const int c0 = s.up ? t.n0 % s.Cout : 0;  // channel of column n0
    named_barrier(1, 128 * kConsumers);
#pragma unroll
    for (int pass = 0; pass < kPasses; ++pass) {
      const uint32_t stage =
          m.halo_at((nh - 1) % s.hstages) + (pass % regions) * region_bytes;
      if (pass >= regions && s.tma_out) {  // the region's box has been read
        if (threadIdx.x == 128) bulk_wait_read();
        named_barrier(1, 128 * kConsumers);
      } else if (pass > 0 && !s.tma_out) {
        named_barrier(2 + cwg, 128);  // the last pass is stored
      }
#pragma unroll
      for (int jj = 0; jj < kJ; ++jj) {
        const int j = pass * kJ + jj;
        const int col = t.n0 + j * 8 + tq * 2;
        float sc[2], bi[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = col + e;
          int c = n;  // n's channel: n mod Cout on the phase route
          if (s.up) {
            c = c0 + j * 8 + tq * 2 + e;
            while (c >= s.Cout) c -= s.Cout;
          }
          sc[e] = n < s.N ? __fmul_rn(sxb, sw[n]) : 0.f;
          bi[e] = has_bias && n < s.N ? bias[c] : 0.f;
        }
        const int piece = (jj * 8 + tq * 2) / kPiece;
        const int within = (tq * 2 % kPiece) * static_cast<int>(sizeof(OutT));
#pragma unroll
        for (int mi = 0; mi < kMT; ++mi) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = (cwg * kMT + mi) * 64 + wq * 16 + g + 8 * h;
            if (r >= rows) continue;  // only the tile's rows fit the stage
            const OutT v0 = dequant<OutT>(acc[mi][4 * j + 2 * h], sc[0],
                                          has_bias, bi[0], s.up != 0);
            const OutT v1 = dequant<OutT>(acc[mi][4 * j + 2 * h + 1], sc[1],
                                          has_bias, bi[1], s.up != 0);
            stage_pair(stage + r * kStageRow + ((piece ^ (r & 7)) << 4) +
                           within,
                       v0, v1);
          }
        }
      }
      if (s.tma_out) {
        // every thread's staged rows, visible to the async proxy
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        named_barrier(1, 128 * kConsumers);  // the tile's rows are staged
        const int nc = t.n0 + pass * (kBN / kPasses);
        if (threadIdx.x == 128 && nc < s.N) {
          const int p = s.up ? nc / s.Cout : 0;
          tma_store_5d(&tm_y.m[p], stage, nc - p * s.Cout, t.w0, t.h0, t.d0,
                       t.b);
          bulk_commit();
        }
        continue;
      }
      named_barrier(2 + cwg, 128);  // this warpgroup's rows are staged
      const int piece = lane & 7;
      const int n = t.n0 + pass * (kBN / kPasses) + piece * kPiece;
#pragma unroll
      for (int i = 0; i < 4 * kMT; ++i) {
        const int r = cwg * kMT * 64 + i * 16 + wq * 4 + (lane >> 3);
        if (r >= rows || n >= s.N) continue;
        uint32_t code;
        asm volatile("ld.shared.u32 %0, [%1];\n"
                     : "=r"(code)
                     : "r"(m.rowtab + 4 * r)
                     : "memory");
        const int d = t.d0 + (code & 255);
        const int hh = t.h0 + ((code >> 8) & 255);
        const int ww = t.w0 + (code >> 16);
        if (d >= s.D || hh >= s.H || ww >= s.W) continue;
        uint32_t v[4];
        asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
                     : "=r"(v[0]), "=r"(v[1]), "=r"(v[2]), "=r"(v[3])
                     : "r"(stage + r * kStageRow + ((piece ^ (r & 7)) << 4))
                     : "memory");
        // the whole piece in range, in one phase, at a 16-byte address
        const int c = s.up ? n % s.Cout : n;
        if (n + kPiece <= s.N && c + kPiece <= s.Cout &&
            s.Cout % kPiece == 0) {
          *reinterpret_cast<uint4*>(out_ptr(s, y, t.b, d, hh, ww, n)) =
              make_uint4(v[0], v[1], v[2], v[3]);
        } else {
#pragma unroll
          for (int k = 0; k < kPiece; ++k)
            if (n + k < s.N)
              *out_ptr(s, y, t.b, d, hh, ww, n + k) =
                  piece_elem(v, k, static_cast<OutT*>(nullptr));
        }
      }
    }
    // order this thread's generic accesses to the stage before the TMA
    // that refills it, then release it (the storing thread once its last
    // box has been read)
    if (s.tma_out && threadIdx.x == 128) bulk_wait_read();
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncwarp();
    if (lane == 0) mbar_arrive(m.hempty((nh - 1) % s.hstages));
  }
  // no wait for the stores' completion here: the release above waited for
  // their reads, and a wait on the bulk group after the tile loop makes
  // ptxas serialize the wgmma
}

// ---------------------------------------------------------------- host --

// One launch of the (kMT, OutT) instance. setmaxnreg hands registers
// between the warpgroups of a block: launch must have given every thread
// kLaunchRegs, or the consumers' request would wait for registers that
// never come.
template <int kMT, typename OutT>
cudaError_t launch(const CUtensorMap& tm_x, const CUtensorMap& tm_w,
                   const OutMaps& tm_y, const float* sx, const float* sw,
                   const float* bias, void* y, const Shape& s, size_t smem,
                   int grid, cudaStream_t stream) {
  static int regs = -1;
  if (regs < 0) {
    cudaFuncAttributes attr;
    const cudaError_t err =
        cudaFuncGetAttributes(&attr, conv3d_s8_kernel<kMT, OutT>);
    if (err != cudaSuccess) return err;
    regs = attr.numRegs;
  }
  if (regs != kLaunchRegs) return cudaErrorInvalidConfiguration;
  const cudaError_t err = cudaFuncSetAttribute(
      conv3d_s8_kernel<kMT, OutT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  conv3d_s8_kernel<kMT, OutT><<<grid, kThreads, smem, stream>>>(
      tm_x, tm_w, tm_y, sx, sw, bias, static_cast<OutT*>(y), s);
  return cudaGetLastError();
}

// The maps of y [B, D, oH, oW, Cout] (oH = 2H, oW = 2W on the phase route)
// over the low-resolution grid, one pass's box (128 bytes of channels x
// the tile) each: y itself, or for phase p = 2a + b the view starting at
// output voxel (0, a, b) with doubled H and W strides. False where a pass
// could straddle phases or rows are not 16-byte strided: the threads store.
bool encode_out_maps(OutMaps* maps, void* y, const Shape& s, int esize) {
  const int cols = 128 / esize;  // a pass: 128 bytes of each row
  const cuuint64_t row = static_cast<cuuint64_t>(s.Cout) * esize;
  if (row % 16 != 0 || reinterpret_cast<uintptr_t>(y) % 16 != 0 ||
      (s.up && s.Cout % cols != 0))
    return false;
  const cuuint64_t k = s.up ? 2 : 1;
  const cuuint64_t oW = k * s.W, oH = k * s.H;
  const cuuint64_t dims[5] = {static_cast<cuuint64_t>(s.Cout),
                              static_cast<cuuint64_t>(s.W),
                              static_cast<cuuint64_t>(s.H),
                              static_cast<cuuint64_t>(s.D),
                              static_cast<cuuint64_t>(s.B)};
  const cuuint64_t strides[4] = {k * row, k * oW * row, oH * oW * row,
                                 s.D * oH * oW * row};
  const cuuint32_t box[5] = {static_cast<cuuint32_t>(cols),
                             static_cast<cuuint32_t>(s.TW),
                             static_cast<cuuint32_t>(s.TH),
                             static_cast<cuuint32_t>(s.TD), 1};
  const CUtensorMapDataType type = esize == 2
                                       ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                       : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  for (int p = 0; p < 4; ++p) {
    const int a = s.up ? p >> 1 : 0, b = s.up ? p & 1 : 0;
    const char* base = static_cast<const char*>(y) + (a * oW + b) * row;
    if (!encode_map(&maps->m[p], type, base, 5, dims, strides, box))
      return false;
  }
  return true;
}

}  // namespace

extern "C" {

// xq [B, D, H, W, Cin] int8; w packed [taps][N][Cin] int8 (taps must be
// 27: the 1x1x1 conv is csrc/conv1x1_s8.cu's); sx [B] and sw [N] f32; bias
// [Cout] f32 or NULL (on the phase route: the bias already rounded to the
// output dtype). upsample = 1: N = 4 * Cout stacked phases, y is
// [B, D, 2H, 2W, Cout]; else N = Cout and y is [B, D, H, W, Cout]. Output
// tile TD x TH x TW (ops/conv3d_s8.py:s8_tile; at most 128 rows for f32
// output). xq and w 16-byte aligned,
// Cin a multiple of 16 (TMA's 16-byte strides). out_dtype: 0 = float32,
// 1 = bfloat16. Returns a cudaError_t.
int conv3d_s8_launch(const void* x, const void* w, const float* sx,
                     const float* sw, const float* bias, void* y, int B, int D,
                     int H, int W, int Cin, int N, int taps, int upsample,
                     int TD, int TH, int TW, int out_dtype, void* stream_ptr) {
  const int pad = 1;
  if (B <= 0 || D <= 0 || H <= 0 || W <= 0 || Cin <= 0 || N <= 0 ||
      Cin % 16 != 0 || taps != 27 || (upsample && N % 4) ||
      (out_dtype != 0 && out_dtype != 1) || TD <= 0 || TH <= 0 || TW <= 0 ||
      TD > 254 || TH > 254 || TW > 254 || TD * TH * TW > kMaxRows ||
      (TD + 2 * pad) * (TH + 2 * pad) * (TW + 2 * pad) > kMaxHalo ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(w) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool big = TD * TH * TW > kMaxRows / 2;  // the kMT = 2 instance
  if (big && out_dtype == 0)  // f32 output takes 128-row tiles
    return static_cast<int>(cudaErrorInvalidValue);
  Shape s;
  s.B = B; s.D = D; s.H = H; s.W = W; s.Cin = Cin;
  s.N = N; s.Cout = upsample ? N / 4 : N;
  s.pad = pad; s.up = upsample ? 1 : 0;
  s.TD = TD; s.TH = TH; s.TW = TW;
  s.nD = (D + TD - 1) / TD;
  s.nH = (H + TH - 1) / TH;
  s.nW = (W + TW - 1) / TW;
  const int64_t tiles = static_cast<int64_t>(B) * s.nD * s.nH * s.nW;
  const int64_t total = tiles * ((N + kBN - 1) / kBN);
  if (total > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  s.tiles = static_cast<int>(tiles);
  s.total = static_cast<int>(total);
  s.chunks = (Cin + kBK - 1) / kBK;
  const int hd = TD + 2 * pad, hh = TH + 2 * pad, hw = TW + 2 * pad;
  s.halo_tx = hd * hh * hw * kRowBytes;  // >= rows * kStageRow
  s.halo_bytes = (s.halo_tx + 1023) / 1024 * 1024;
  const int fixed = 1024 + kStages * kWBytes + 8 * kBars + 4 * kMaxRows;
  s.hstages = (kSmemLimit - fixed) / s.halo_bytes;
  if (s.hstages > kMaxHaloStages) s.hstages = kMaxHaloStages;
  if (s.hstages < 2) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem =
      fixed + static_cast<size_t>(s.hstages) * s.halo_bytes;

  CUtensorMap tm_x, tm_w;
  const cuuint64_t xd[5] = {static_cast<cuuint64_t>(Cin),
                            static_cast<cuuint64_t>(W),
                            static_cast<cuuint64_t>(H),
                            static_cast<cuuint64_t>(D),
                            static_cast<cuuint64_t>(B)};
  const cuuint64_t xs[4] = {xd[0], xd[0] * xd[1], xd[0] * xd[1] * xd[2],
                            xd[0] * xd[1] * xd[2] * xd[3]};
  const cuuint32_t xb[5] = {kBK, static_cast<cuuint32_t>(hw),
                            static_cast<cuuint32_t>(hh),
                            static_cast<cuuint32_t>(hd), 1};
  const cuuint64_t wd[3] = {static_cast<cuuint64_t>(Cin),
                            static_cast<cuuint64_t>(N),
                            static_cast<cuuint64_t>(taps)};
  const cuuint64_t ws[2] = {wd[0], wd[0] * wd[1]};
  const cuuint32_t wb[3] = {kBK, kBN, 1};
  if (!encode_map(&tm_x, CU_TENSOR_MAP_DATA_TYPE_UINT8, x, 5, xd, xs, xb) ||
      !encode_map(&tm_w, CU_TENSOR_MAP_DATA_TYPE_UINT8, w, 3, wd, ws, wb))
    return static_cast<int>(cudaErrorInvalidValue);

  OutMaps tm_y;
  s.tma_out = encode_out_maps(&tm_y, y, s, out_dtype == 1 ? 2 : 4) ? 1 : 0;
#ifdef CONV3D_S8_THREAD_STORES  // a study build: the threads store always
  s.tma_out = 0;
#endif

  cudaError_t err;
  const int sms = sm_count(&err);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = s.total < sms ? s.total : sms;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (out_dtype == 0)
    err = launch<1, float>(tm_x, tm_w, tm_y, sx, sw, bias, y, s, smem, grid,
                           stream);
  else if (big)
    err = launch<2, __nv_bfloat16>(tm_x, tm_w, tm_y, sx, sw, bias, y, s,
                                   smem, grid, stream);
  else
    err = launch<1, __nv_bfloat16>(tm_x, tm_w, tm_y, sx, sw, bias, y, s,
                                   smem, grid, stream);
  return static_cast<int>(err);
}

}  // extern "C"

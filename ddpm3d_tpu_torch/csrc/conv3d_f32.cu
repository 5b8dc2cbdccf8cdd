// Stride-1 SAME 3x3x3 convolution in f32, channels-last (NDHWC), on the CUDA
// cores of Hopper (sm_90a): the torso convs of f32 models, their dx (the
// same conv on dy with the flipped, in/out-swapped weight) and the fused
// ResBlock conv in f32.
//
// Replaces the TPU kernels ddpm3d_tpu/ops/conv3d_mxu.py:_conv_kernel
// (reached through conv3d_mxu, and for dx through _conv3d_mxu_bwd) and
// ddpm3d_tpu/ops/conv3d_fused.py:_fused_kernel (reached through
// conv3d_fused) for f32 models. Same functions:
//
//   y[b,d,h,w,co] = bias[co] + sum_{kd,kh,kw,ci} xn[b,d+kd-1,h+kh-1,w+kw-1,ci]
//                                               * w[kd,kh,kw,ci,co]
//   xn = silu?(x * g[b,ci] + b[b,ci])  (fused, in-volume voxels only) or x
//   y += skip                          (fused, optional)
//   stats[b] = (sum y, sum y^2)        (fused, optional) [B, 2, Cout]
//
// f32 products and sums (FFMA: no TF32, no split-TF32), the bias in f32,
// zero padding. The f32 head conv (Cout <= 8) and the f32 convs with Cin = 2
// run csrc/conv3d_head.cu.
//
// Bound on the H100: operations. 54 * Cin * Cout FLOP per voxel against
// 4 * (Cin + Cout) bytes: ~110 FLOP per byte at Cin = Cout = 128, above the
// ~20 FLOP per byte at which 67 TFLOP/s of f32 FFMA meets 3.35 TB/s. So the
// inner loop must issue little but FFMA, and read little shared memory per
// FFMA. What the design does:
//  * Implicit GEMM, M = output voxels, N = Cout, K = 27 * Cin. A block (256
//    threads, two per SM) owns a tile of 16 (d, h) lines x 8 voxels along W
//    (TD x TH x 8, TD * TH = 16, picked per volume on the host) and 128
//    output channels. Each thread owns one line's 8 voxels x 8 channels: 64
//    accumulators. A warp covers 8 lines x 32 channels, so per k it reads
//    80 halo floats and 96 weight floats for its 1536 FFMA.
//  * The haloed input tile (TD+2)(TH+2)(8+2) of one 8-channel Cin chunk is
//    staged once by 16-byte cp.async (zero-filled outside the volume: the
//    SAME padding, and past Cin), two units ahead of its use, and all 27
//    taps are read from it. At the chunk's first unit the block transposes
//    it to channel-major rows (a line's 10 voxels of one channel are then
//    5 aligned 8-byte loads, and the 8 lines of a warp fall in 8 distinct
//    banks), applying the fused prologue on the way.
//  * The taps are grouped by (kd, kh): one unit of work is a tap row, the
//    three taps along W. Its weights, 3 x 8 x 128 floats, packed on the
//    host as [27][Cin][Cout] (ops/conv3d.py:pack_weight_f32) so that a
//    tap's tile is [k][n] with n contiguous, stream by 16-byte cp.async
//    into a ring of kStages units, two units ahead: one wait and one
//    barrier per unit, no synchronous load and no transpose in the loop.
//  * Per k of a unit a thread loads its line's 10 halo voxels (8 + 2 for
//    kw) once and serves the three taps from them; per tap two 16-byte
//    loads of B: 11 shared loads for 192 FFMA.
//  * The plain conv adds the bias and stores from its registers. The
//    fused instance keeps its registers for a loop that loads the next
//    k's A and first B under the current k's FFMA, and runs its epilogue
//    through shared memory: the accumulators to a [row][132] tile, then
//    whole rows per warp: + bias, + skip, the store, and the stats summed
//    over the thread's rows, then across warps in a fixed order; each
//    block writes one partial per (tile, column) and two launches of an
//    ordered sum finish them. No atomics: the stats repeat exactly, and the
//    tiles depend on the volume's shape alone, so they do not depend on
//    the batch.
//
// Study builds (conv3d_sm90_study.py --f32): -DCONV3D_F32_NO_MATH drops the
// FFMA loop (staging, transposes and epilogue only), -DCONV3D_F32_NO_STAGE
// drops the staging and the transposes (the math on whatever shared memory
// holds).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBN = 128;           // output channels per tile
constexpr int kBK = 8;             // Cin chunk
constexpr int kTW = 8;             // tile voxels along W: a thread's rows
constexpr int kHW = kTW + 2;       // halo voxels along W
constexpr int kLines = 16;         // (d, h) lines per tile: TD * TH
constexpr int kStages = 3;         // weight ring, in tap-row units
constexpr int kUnit = 3 * kBK * kBN;  // floats of one unit's weights
constexpr int kMaxHalo = 540;      // (TD+2)(TH+2)(TW+2) at most: 18 x 3 x 10
// transposed halo: channel k's row of voxels, kHP floats apart (548 = 4
// mod 32 banks, so the transpose's two 4-channel halves do not collide)
constexpr int kHP = 548;
constexpr int kOP = 132;           // the fused epilogue tile's row pitch
constexpr int kRowUnits = 9;       // tap rows (kd, kh) per chunk
constexpr int kStatsGroup = 64;    // tiles per first-level stats sum
// one 16-byte piece of a unit's weights per thread and tap: [kw][k][n]
static_assert(kThreads == kBK * (kBN / 4), "weight pieces per thread");

struct Shape {
  int B, D, H, W, Cin, Cout;
  int TD, TH;
  int nD, nH, nW;
  int chunks;
};

struct Tile {
  int b, d0, h0, w0;
  int HH, halo;
};

// The fused conv's extra operands (all NULL for the plain conv).
struct Fused {
  const float* g;      // [B, Cin] prologue gain, or NULL: no prologue
  const float* b;      // [B, Cin] prologue shift
  const float* skip;   // [B, D, H, W, Cout], or NULL
  float* part;         // [tiles][2][Cout] per-tile (sum y, sum y^2), or NULL
  int silu;            // SiLU after the prologue's affine
};

__device__ __forceinline__ Tile decode_tile(const Shape& s) {
  Tile t;
  int i = blockIdx.x;
  const int tw = i % s.nW; i /= s.nW;
  const int th = i % s.nH; i /= s.nH;
  const int td = i % s.nD;
  t.b = i / s.nD;
  t.d0 = td * s.TD;
  t.h0 = th * s.TH;
  t.w0 = tw * kTW;
  t.HH = s.TH + 2;
  t.halo = (s.TD + 2) * t.HH * kHW;
  return t;
}

// The voxel of the volume behind halo voxel v ((d * H + h) * W + w), or -1
// in the zero padding.
__device__ __forceinline__ int halo_voxel(const Shape& s, const Tile& t,
                                          int v) {
  const int hx = v % kHW;
  const int q = v / kHW;
  const int hy = q % t.HH;
  const int hz = q / t.HH;
  const int d = t.d0 + hz - 1, h = t.h0 + hy - 1, w = t.w0 + hx - 1;
  if (d < 0 || d >= s.D || h < 0 || h >= s.H || w < 0 || w >= s.W) return -1;
  return (d * s.H + h) * s.W + w;
}

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem,
                                           bool pred) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = pred ? 16 : 0;  // src-size 0 zero-fills the 16 bytes
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(a),
               "l"(gmem), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// One chunk's halo as staged, [voxel][kBK] floats, from the block's table
// of halo voxels (hvox). kVec: Cin % 4 == 0 and x 16-byte aligned (16-byte
// pieces of 4 channels, asynchronous); else scalar.
template <bool kVec>
__device__ __forceinline__ void stage_halo(const Shape& s, const Tile& t,
                                           const float* __restrict__ xb,
                                           const int* hvox, float* raw,
                                           int ci0) {
  if (kVec) {
    const int part = threadIdx.x % (kBK / 4);  // kThreads is even
    const int ci = ci0 + part * 4;
    for (int v = threadIdx.x / (kBK / 4); v < t.halo;
         v += kThreads / (kBK / 4)) {
      const int vox = hvox[v];
      const bool ok = vox >= 0 && ci < s.Cin;
      cp_async16(raw + v * kBK + part * 4,
                 ok ? xb + static_cast<int64_t>(vox) * s.Cin + ci : xb, ok);
    }
  } else {
    for (int i = threadIdx.x; i < t.halo * kBK; i += kThreads) {
      const int v = i / kBK, ci = ci0 + i % kBK;
      const int vox = hvox[v];
      raw[i] = (vox >= 0 && ci < s.Cin)
                   ? xb[static_cast<int64_t>(vox) * s.Cin + ci] : 0.f;
    }
  }
}

// One unit's weights: taps 3r .. 3r + 2 (kd = r / 3, kh = r % 3, kw = 0..2)
// of chunk ci0, as [kw][k][n] floats. w is packed [27][Cin][Cout]. kVec:
// Cout % 4 == 0 and w 16-byte aligned: each thread copies the same piece
// (k = tid / 32, columns 4 (tid % 32) ..) of the three taps.
template <bool kVec>
__device__ __forceinline__ void stage_weights(const Shape& s,
                                              const float* __restrict__ w,
                                              float* sw, int r, int ci0,
                                              int n0) {
  if (kVec) {
    const int k = threadIdx.x / (kBN / 4), piece = threadIdx.x % (kBN / 4);
    const int ci = ci0 + k, co = n0 + piece * 4;
    const bool ok = ci < s.Cin && co < s.Cout;
    const int64_t tap_stride = static_cast<int64_t>(s.Cin) * s.Cout;
    const float* src = w + (3 * r * tap_stride + static_cast<int64_t>(ci) *
                                                     s.Cout + co);
#pragma unroll
    for (int kw = 0; kw < 3; ++kw)
      cp_async16(sw + (kw * kBK + k) * kBN + piece * 4,
                 ok ? src + kw * tap_stride : w, ok);
  } else {
    for (int i = threadIdx.x; i < kUnit; i += kThreads) {
      const int n = i % kBN, row = i / kBN;
      const int tap = 3 * r + row / kBK, ci = ci0 + row % kBK;
      const int co = n0 + n;
      sw[i] = (ci < s.Cin && co < s.Cout)
                  ? w[(static_cast<int64_t>(tap) * s.Cin + ci) * s.Cout + co]
                  : 0.f;
    }
  }
}

// h * sigmoid(h); the reciprocal rounded to nearest, as 1.f / x
__device__ __forceinline__ float silu_f32(float h) {
  return h * __frcp_rn(1.f + expf(-h));
}

// The staged chunk [voxel][kBK] into the transposed halo [kBK][kHP] that
// the loop reads. Fused with a prologue (f.g set): silu?(x * g + b) on the
// way, rounded twice (a multiply and an add, no FMA, as the plain version),
// for in-volume voxels; the padding and ragged Cin were zero-filled and
// stay 0 (silu(0 * g + b) is not 0). Each thread moves one 4-channel half.
template <bool kFused>
__device__ __forceinline__ void transpose_chunk(const Shape& s,
                                                const Tile& t,
                                                const Fused& f,
                                                const int* hvox,
                                                const float* raw, float* ht,
                                                int ci0) {
  const int part = threadIdx.x % (kBK / 4);
  float g[4], b[4];
  bool pro = false;
  if constexpr (kFused) {
    pro = f.g != nullptr;
    if (pro) {
      const int64_t row = static_cast<int64_t>(t.b) * s.Cin;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int ci = ci0 + part * 4 + i;
        g[i] = ci < s.Cin ? f.g[row + ci] : 0.f;
        b[i] = ci < s.Cin ? f.b[row + ci] : 0.f;
      }
    }
  }
  for (int v = threadIdx.x / (kBK / 4); v < t.halo;
       v += kThreads / (kBK / 4)) {
    const float4 q = *reinterpret_cast<const float4*>(raw + v * kBK +
                                                      part * 4);
    float e[4] = {q.x, q.y, q.z, q.w};
    if (kFused && pro && hvox[v] >= 0) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (ci0 + part * 4 + i >= s.Cin) continue;
        const float h = __fadd_rn(__fmul_rn(e[i], g[i]), b[i]);
        e[i] = f.silu ? silu_f32(h) : h;
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) ht[(part * 4 + i) * kHP + v] = e[i];
  }
}

// Stage unit u (chunk u / 9, tap row u % 9): its weights, and at tap row 0
// its chunk's halo.
template <bool kVec>
__device__ __forceinline__ void stage_unit(const Shape& s, const Tile& t,
                                           const float* __restrict__ xb,
                                           const float* __restrict__ w,
                                           const int* hvox, float* raw,
                                           float* ring, int u, int n0) {
#ifndef CONV3D_F32_NO_STAGE
  const int c = u / kRowUnits, r = u % kRowUnits;
  if (r == 0) stage_halo<kVec>(s, t, xb, hvox, raw, c * kBK);
  stage_weights<kVec>(s, w, ring + (u % kStages) * kUnit, r, c * kBK, n0);
#endif
}

// acc[i][0..3] / [4..7] += a * b0 / b1 for the thread's 8 rows
__device__ __forceinline__ void ffma_row(float (&acc)[8][8], const float* a,
                                         const float4& b0, const float4& b1) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float av = a[i];
    acc[i][0] = fmaf(av, b0.x, acc[i][0]);
    acc[i][1] = fmaf(av, b0.y, acc[i][1]);
    acc[i][2] = fmaf(av, b0.z, acc[i][2]);
    acc[i][3] = fmaf(av, b0.w, acc[i][3]);
    acc[i][4] = fmaf(av, b1.x, acc[i][4]);
    acc[i][5] = fmaf(av, b1.y, acc[i][5]);
    acc[i][6] = fmaf(av, b1.z, acc[i][6]);
    acc[i][7] = fmaf(av, b1.w, acc[i][7]);
  }
}

// The line's 10 halo voxels of channel k (8-byte aligned: lines start at
// multiples of 10 voxels, kHP is even).
__device__ __forceinline__ void load_a(float (&a)[kHW], const float* hb,
                                       int k) {
#pragma unroll
  for (int j = 0; j < kHW; j += 2) {
    const float2 v2 = *reinterpret_cast<const float2*>(hb + k * kHP + j);
    a[j] = v2.x;
    a[j + 1] = v2.y;
  }
}

// One unit's FFMA: for each k, the line's A once, then the three taps.
// hb: the line's first halo voxel in this tap row; wb: the unit's weights
// at this thread's first column.
__device__ __forceinline__ void unit_math(float (&acc)[8][8],
                                          const float* hb, const float* wb) {
#pragma unroll 1
  for (int k = 0; k < kBK; ++k) {
    float a[kHW];
    load_a(a, hb, k);
#pragma unroll
    for (int kw = 0; kw < 3; ++kw) {
      const float* wr = wb + (kw * kBK + k) * kBN;
      ffma_row(acc, a + kw, *reinterpret_cast<const float4*>(wr),
               *reinterpret_cast<const float4*>(wr + 16));
    }
  }
}

// The same sums, with k + 1's A and kw = 0 B loaded under k's FFMA (the
// fused instance: its extra code leaves ptxas less room to schedule the
// plain loop's loads early).
__device__ __forceinline__ void unit_math_pipelined(float (&acc)[8][8],
                                                    const float* hb,
                                                    const float* wb) {
  float a[2][kHW];
  float4 bq[2][2];
  load_a(a[0], hb, 0);
  bq[0][0] = *reinterpret_cast<const float4*>(wb);
  bq[0][1] = *reinterpret_cast<const float4*>(wb + 16);
#pragma unroll 1
  for (int k0 = 0; k0 < kBK; k0 += 2) {
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      const int k = k0 + kk, cur = kk, nxt = kk ^ 1;
      if (k + 1 < kBK) {
        load_a(a[nxt], hb, k + 1);
        bq[nxt][0] = *reinterpret_cast<const float4*>(wb + (k + 1) * kBN);
        bq[nxt][1] = *reinterpret_cast<const float4*>(wb + (k + 1) * kBN + 16);
      }
      ffma_row(acc, a[cur], bq[cur][0], bq[cur][1]);
#pragma unroll
      for (int kw = 1; kw < 3; ++kw) {
        const float* wr = wb + (kw * kBK + k) * kBN;
        ffma_row(acc, a[cur] + kw, *reinterpret_cast<const float4*>(wr),
                 *reinterpret_cast<const float4*>(wr + 16));
      }
    }
  }
}

// the kernel's dynamic shared memory: the staged and the transposed halo,
// the weight ring and the halo's voxel table; fused, also the stats sums
constexpr size_t kSmemPlain =
    (kMaxHalo * kBK + kBK * kHP + kStages * kUnit + kMaxHalo) * sizeof(float);
constexpr size_t kSmemFused = kSmemPlain + kWarps * 2 * kBN * sizeof(float);
// the fused epilogue's [128 rows][kOP] tile fits over the halo and the ring
static_assert(kTW * kLines * kOP <=
                  kMaxHalo * kBK + kBK * kHP + kStages * kUnit,
              "epilogue tile");

template <bool kVec, bool kFused>
__global__ void __launch_bounds__(kThreads, 2)
    conv3d_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                      const float* __restrict__ bias, float* __restrict__ y,
                      Shape s, Fused f) {
  extern __shared__ __align__(16) float smem[];
  float* raw = smem;                               // [kMaxHalo][kBK]
  float* ht = raw + kMaxHalo * kBK;                // [kBK][kHP]
  float* ring = ht + kBK * kHP;                    // [kStages][kUnit]
  int* hvox = reinterpret_cast<int*>(ring + kStages * kUnit);  // [kMaxHalo]
  float* red = ring + kStages * kUnit + kMaxHalo;  // fused: [warp][2][kBN]
  const Tile t = decode_tile(s);
  const float* xb =
      x + static_cast<int64_t>(t.b) * s.D * s.H * s.W * s.Cin;
  const int n0 = blockIdx.y * kBN;
  // warp tile: 8 lines x 32 columns. Lane: line lane / 4 of the warp's
  // 8, columns 4 (lane % 4) + {0..3, 16..19} of its 32
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int line = (warp >> 2) * 8 + (lane >> 2);
  const int cbase = (warp & 3) * 32 + (lane & 3) * 4;
  const int dz = line / s.TH, hy = line % s.TH;

  for (int v = threadIdx.x; v < t.halo; v += kThreads)
    hvox[v] = halo_voxel(s, t, v);
  __syncthreads();

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  const int units = s.chunks * kRowUnits;
#pragma unroll
  for (int u = 0; u < kStages - 1; ++u) {
    if (u < units) stage_unit<kVec>(s, t, xb, w, hvox, raw, ring, u, n0);
    cp_async_commit();
  }
  for (int u = 0; u < units; ++u) {
    cp_async_wait<kStages - 2>();  // this thread's copies of unit u
    __syncthreads();  // everyone's copies; unit u - 1 is read by all
    if (u + kStages - 1 < units)
      stage_unit<kVec>(s, t, xb, w, hvox, raw, ring, u + kStages - 1, n0);
    cp_async_commit();  // (possibly empty: one group per iteration)
    const int c = u / kRowUnits, r = u % kRowUnits;
    if (r == 0) {  // the chunk has landed; unit u - 1 read the last one
#ifndef CONV3D_F32_NO_STAGE
      transpose_chunk<kFused>(s, t, f, hvox, raw, ht, c * kBK);
#endif
      __syncthreads();
    }
#ifndef CONV3D_F32_NO_MATH
    const float* hb = ht + ((dz + r / 3) * t.HH + hy + r % 3) * kHW;
    const float* wb = ring + (u % kStages) * kUnit + cbase;
    if constexpr (kFused)
      unit_math_pipelined(acc, hb, wb);
    else
      unit_math(acc, hb, wb);
#endif
  }
  cp_async_wait<0>();

  if constexpr (!kFused) {
    // + bias (f32), masked stores from the registers (this loop order
    // keeps the accumulators where the FFMA loop wants them: a version
    // that walks the columns first runs the loop measurably slower)
    int col[2];
    float bv[8];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      col[h] = n0 + cbase + h * 16;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        bv[4 * h + j] = (bias != nullptr && col[h] + j < s.Cout)
                            ? bias[col[h] + j] : 0.f;
    }
    const int d = t.d0 + dz, hh = t.h0 + hy;
    if (d < s.D && hh < s.H) {
      const int64_t vox0 =
          ((static_cast<int64_t>(t.b) * s.D + d) * s.H + hh) * s.W + t.w0;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        if (t.w0 + i >= s.W) continue;
        const int64_t base = (vox0 + i) * s.Cout;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (col[h] >= s.Cout) continue;
          float v[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) v[j] = acc[i][4 * h + j] + bv[4 * h + j];
          if (kVec) {
            *reinterpret_cast<float4*>(y + base + col[h]) =
                make_float4(v[0], v[1], v[2], v[3]);
          } else {
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              if (col[h] + j >= s.Cout) continue;
              y[base + col[h] + j] = v[j];
            }
          }
        }
      }
    }
  } else {
    // through shared memory: the accumulators to a [row][kOP] tile (row
    // i * 16 + line: a warp's 8 lines 132 floats apart, in 8 distinct
    // banks), then each warp takes whole rows (512 contiguous bytes)
    __syncthreads();  // the staging buffers are free
    float* ot = smem;
#pragma unroll
    for (int i = 0; i < kTW; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float4*>(ot + (i * kLines + line) * kOP + cbase +
                                   16 * h) =
            make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2],
                        acc[i][4 * h + 3]);
    __syncthreads();
    const int q = lane, col = n0 + 4 * q;  // this thread's 4 columns
    float bv[4], s1[4] = {}, s2[4] = {};
#pragma unroll
    for (int j = 0; j < 4; ++j)
      bv[j] = (bias != nullptr && col + j < s.Cout) ? bias[col + j] : 0.f;
    for (int r = warp; r < kTW * kLines; r += kWarps) {
      const int ln = r % kLines, i = r / kLines;
      const int d = t.d0 + ln / s.TH, hh = t.h0 + ln % s.TH, ww = t.w0 + i;
      if (d >= s.D || hh >= s.H || ww >= s.W || col >= s.Cout) continue;
      const int64_t base =
          (((static_cast<int64_t>(t.b) * s.D + d) * s.H + hh) * s.W + ww) *
              s.Cout + col;
      const float4 a4 =
          *reinterpret_cast<const float4*>(ot + r * kOP + 4 * q);
      float v[4] = {a4.x + bv[0], a4.y + bv[1], a4.z + bv[2], a4.w + bv[3]};
      if (kVec) {  // Cout % 4 == 0: the 4 columns are all in
        if (f.skip != nullptr) {
          const float4 sk = *reinterpret_cast<const float4*>(f.skip + base);
          v[0] += sk.x; v[1] += sk.y; v[2] += sk.z; v[3] += sk.w;
        }
        *reinterpret_cast<float4*>(y + base) =
            make_float4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (col + j >= s.Cout) continue;
          if (f.skip != nullptr) v[j] += f.skip[base + j];
          y[base + j] = v[j];
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s1[j] += v[j];
        s2[j] += v[j] * v[j];
      }
    }
    if (f.part != nullptr) {
      // each warp's column sums (its rows, in order), then the 8 warps in
      // shared memory, in a fixed order
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        red[(warp * 2) * kBN + 4 * q + j] = s1[j];
        red[(warp * 2 + 1) * kBN + 4 * q + j] = s2[j];
      }
      __syncthreads();
      for (int i = threadIdx.x; i < 2 * kBN; i += kThreads) {
        const int qq = i / kBN, c = i % kBN;
        if (n0 + c >= s.Cout) continue;
        float sum = 0.f;
        for (int wp = 0; wp < kWarps; ++wp)
          sum += red[(wp * 2 + qq) * kBN + c];
        f.part[(static_cast<int64_t>(blockIdx.x) * 2 + qq) * s.Cout + n0 +
               c] = sum;
      }
    }
  }
}

// out[b][grp][c] = sum of in[b][r][c] over the rows r of group grp (group
// rows each, the last one ragged), in row order: the deterministic finish
// of the fused conv's per-tile stats. grid (ceil(cols/256), groups, B).
__global__ void __launch_bounds__(kThreads)
    stats_sum_kernel(const float* __restrict__ in, float* __restrict__ out,
                     int rows, int group, int cols) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= cols) return;
  const int grp = blockIdx.y, groups = gridDim.y, b = blockIdx.z;
  const int r0 = grp * group, r1 = min(rows, r0 + group);
  const float* src = in + static_cast<int64_t>(b) * rows * cols + c;
  float sum = 0.f;
  for (int r = r0; r < r1; ++r) sum += src[static_cast<int64_t>(r) * cols];
  out[(static_cast<int64_t>(b) * groups + grp) * cols + c] = sum;
}

// The shape of a launch, or false if the kernel does not take it.
bool make_shape(Shape* s, int B, int D, int H, int W, int Cin, int Cout,
                int TD, int TH) {
  if (B <= 0 || D <= 0 || H <= 0 || W <= 0 || Cin <= 0 || Cout <= 0 ||
      TD <= 0 || TH <= 0 || TD * TH != kLines ||
      (TD + 2) * (TH + 2) * kHW > kMaxHalo)
    return false;
  *s = Shape{B, D, H, W, Cin, Cout, TD, TH,
             (D + TD - 1) / TD, (H + TH - 1) / TH, (W + kTW - 1) / kTW,
             (Cin + kBK - 1) / kBK};
  return static_cast<int64_t>(B) * s->nD * s->nH * s->nW <= 0x7fffffff &&
         (Cout + kBN - 1) / kBN <= 65535 &&
         static_cast<int64_t>(D) * H * W <= 0x7fffffff;
}

template <bool kFused>
cudaError_t launch_conv(const float* x, const float* w, const float* bias,
                        float* y, const Fused& f, const Shape& s,
                        cudaStream_t stream) {
  const bool vec = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(w) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(y) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(f.skip) % 16 == 0 &&
                   s.Cin % 4 == 0 && s.Cout % 4 == 0;
  auto kernel = vec ? conv3d_f32_kernel<true, kFused>
                    : conv3d_f32_kernel<false, kFused>;
  const size_t smem = kFused ? kSmemFused : kSmemPlain;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(s.B * s.nD * s.nH * s.nW),
                  (s.Cout + kBN - 1) / kBN);
  kernel<<<grid, kThreads, smem, stream>>>(x, w, bias, y, s, f);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x [B, D, H, W, Cin] f32, w packed [27][Cin][Cout] f32, bias f32 [Cout]
// or NULL, y [B, D, H, W, Cout] f32; the tile is TD x TH x 8 with TD * TH
// = 16 (ops/conv3d.py:pick_tile_f32). Returns a cudaError_t.
int conv3d_f32_launch(const void* x, const void* w, const float* bias,
                      void* y, int B, int D, int H, int W, int Cin, int Cout,
                      int TD, int TH, void* stream_ptr) {
  Shape s;
  if (!make_shape(&s, B, D, H, W, Cin, Cout, TD, TH))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_conv<false>(
      static_cast<const float*>(x), static_cast<const float*>(w), bias,
      static_cast<float*>(y), Fused{}, s,
      static_cast<cudaStream_t>(stream_ptr)));
}

// The fused conv in f32: as conv3d_f32_launch, with g and gb the [B, Cin]
// prologue (both NULL for none), skip [B, D, H, W, Cout] or NULL. With
// stats, part holds B*T*2*Cout floats and part2 B*ceil(T/64)*2*Cout floats
// of scratch (T = tiles per volume) and stats receives [B, 2, Cout]; all
// three NULL for no stats. Returns a cudaError_t.
int conv3d_f32_fused_launch(const void* x, const void* w, const float* bias,
                            const float* g, const float* gb, int silu,
                            const void* skip, void* y, float* part,
                            float* part2, float* stats, int B, int D, int H,
                            int W, int Cin, int Cout, int TD, int TH,
                            void* stream_ptr) {
  Shape s;
  const bool want_stats = part != nullptr;
  if (!make_shape(&s, B, D, H, W, Cin, Cout, TD, TH) ||
      (g == nullptr) != (gb == nullptr) ||
      (part2 == nullptr) != !want_stats || (stats == nullptr) != !want_stats ||
      reinterpret_cast<uintptr_t>(skip) % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const Fused f{g, gb, static_cast<const float*>(skip), part, silu};
  cudaError_t err = launch_conv<true>(
      static_cast<const float*>(x), static_cast<const float*>(w), bias,
      static_cast<float*>(y), f, s, stream);
  if (err != cudaSuccess || !want_stats) return static_cast<int>(err);
  const int T = s.nD * s.nH * s.nW, cols = 2 * Cout;
  const int groups = (T + kStatsGroup - 1) / kStatsGroup;
  const unsigned cblocks = (cols + kThreads - 1) / kThreads;
  stats_sum_kernel<<<dim3(cblocks, groups, B), kThreads, 0, stream>>>(
      part, part2, T, kStatsGroup, cols);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  stats_sum_kernel<<<dim3(cblocks, 1, B), kThreads, 0, stream>>>(
      part2, stats, groups, groups, cols);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

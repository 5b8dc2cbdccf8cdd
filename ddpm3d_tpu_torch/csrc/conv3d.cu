// Stride-1 SAME 3x3x3 convolution, channels-last (NDHWC activations), for
// Hopper (sm_90a).
//
// Replaces the TPU kernel ddpm3d_tpu/ops/conv3d_mxu.py:_conv_kernel (reached
// through conv3d_mxu). Same function:
//
//   y[b,d,h,w,co] = bias[co] + sum_{kd,kh,kw,ci} x[b,d+kd-1,h+kh-1,w+kw-1,ci]
//                                               * w[kd,kh,kw,ci,co]
//
// with zero padding, f32 accumulation and the result stored in x's dtype.
//
// Bound on the H100: operations. At the model's shapes the conv does
// 54*Cin*Cout FLOP per voxel and moves (Cin+Cout)*2 bytes per voxel, i.e.
// ~3500 FLOP/byte at Cin=Cout=128 against the card's ~295 FLOP/byte ridge.
//
// Design (implicit GEMM, M = output voxels, N = Cout, K = 27*Cin):
//  * A block owns an output tile of TD x TH x TW voxels (<= 128 rows, the
//    shape is picked per volume on the host so that ragged W = 6 or 12
//    planes still fill the rows) and 128 (bf16) or 64 (f32) output
//    channels.
//  * Per Cin chunk the block stages the HALOED input tile
//    (TD+2)(TH+2)(TW+2) x chunk in shared memory once, then runs all 27
//    taps out of it: every input element is read from device memory about
//    (halo / tile) ~ 3x instead of 27x. Volume edges and ragged Cin are
//    zero-filled while staging (cp.async with src-size 0), so no padded copy
//    of x is ever made.
//  * The weight tile of one tap, [Cout-tile][Cin-chunk], is double-buffered
//    with cp.async under the previous tap's math.
//  * bf16: 8 warps, warp tile 64x32, mma.sync m16n8k16 bf16 -> f32 with
//    operands fed by ldmatrix. Row addresses of ldmatrix are free per lane,
//    which is what lets one staged halo tile serve all 27 shifted taps.
//  * f32: the same staging with FFMA on CUDA cores (the torso convs of f32
//    models; full f32 precision, no TF32). The f32 head conv (Cout <= 8) and
//    the f32 convs with Cin = 2 run csrc/conv3d_head.cu.
//  * Bias is added in f32 in the epilogue; rows outside the volume or the
//    tile and columns past Cout are masked there.
// wgmma/TMA and a persistent schedule are later work.
//
// The fused ResBlock conv in f32 (conv3d_fused_launch) replaces the TPU
// kernel ddpm3d_tpu/ops/conv3d_fused.py:_fused_kernel (reached through
// conv3d_fused) for f32 models (the f32 model checks); the bf16 fused conv
// is the fused instance of csrc/conv3d_sm90.cu. It is the f32 kernel
// template with kFused = true; the kFused = false instances are the plain
// conv above, unchanged:
//
//   xn = silu?(x * g[b,ci] + b[b,ci])   f32, in-volume voxels only
//                                       (padding stays 0)
//   y  = conv(xn) + bias (+ skip)       f32
//   stats[b] = (sum y, sum y^2)         of y, [B, 2, Cout]
//
// Bound on the H100: operations, as the plain conv (54*Cin*Cout FLOP per
// output voxel; the prologue adds ~4 FLOP per staged input element and the
// epilogue one skip read per output element). What the design does:
//  * The prologue runs on the staged halo chunk in shared memory, at tap 0
//    once the chunk has landed (tap 1's weights are already in flight): it
//    rewrites the chunk in place (each thread owns one channel, so g and b
//    sit in registers per chunk; which halo voxels lie in the volume is
//    worked out once per block), and a barrier orders those writes before
//    the first read. The normalized activation never goes to device
//    memory. The affine is a multiply and an add, not an FMA, as in the
//    plain version.
//  * Skip and stats live in the epilogue: stats are summed over the
//    thread's rows, then across a warp's row groups by shuffles, then
//    across warps in shared memory, and each block writes one partial per
//    (tile, column). Two launches of a small ordered sum (kStatsGroup
//    tiles, then the groups) finish them. No atomics, and the order
//    depends only on the volume's shape: the stats repeat exactly and do
//    not depend on the batch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRows = 128;   // output voxels per block
constexpr int kMaxHalo = 640;   // staged (TD+2)(TH+2)(TW+2) voxels, at most
constexpr int kTaps = 27;

struct Shape {
  int B, D, H, W, Cin, Cout;
  int TD, TH, TW;
  int nD, nH, nW;
};

struct Tile {
  int b, d0, h0, w0;
  int HH, HW, halo, rows;
};

// The fused conv's extra operands (all NULL for the plain conv).
struct Fused {
  const float* g;      // [B, Cin] prologue gain, or NULL: no prologue
  const float* b;      // [B, Cin] prologue shift
  const void* skip;    // [B, D, H, W, Cout] in x's dtype, or NULL
  float* part;         // [tiles][2][Cout] per-tile (sum y, sum y^2), or NULL
  int silu;            // SiLU after the prologue's affine
};

constexpr int kStatsGroup = 64;  // tiles per first-level stats sum

__device__ __forceinline__ Tile decode_tile(const Shape& s) {
  Tile t;
  int i = blockIdx.x;
  const int tw = i % s.nW; i /= s.nW;
  const int th = i % s.nH; i /= s.nH;
  const int td = i % s.nD;
  t.b = i / s.nD;
  t.d0 = td * s.TD;
  t.h0 = th * s.TH;
  t.w0 = tw * s.TW;
  t.HH = s.TH + 2;
  t.HW = s.TW + 2;
  t.halo = (s.TD + 2) * t.HH * t.HW;
  t.rows = s.TD * s.TH * s.TW;
  return t;
}

// Halo-relative voxel index of output row r of the tile (tap offset 0).
__device__ __forceinline__ int row_base(const Shape& s, const Tile& t, int r) {
  if (r >= t.rows) return 0;  // idle row: reads valid smem, never stored
  const int dz = r / (s.TH * s.TW);
  const int hy = (r / s.TW) % s.TH;
  const int wx = r % s.TW;
  return (dz * t.HH + hy) * t.HW + wx;
}

// Global voxel (b,d,h,w) of output row r, or -1 outside the tile/volume.
__device__ __forceinline__ int64_t row_voxel(const Shape& s, const Tile& t,
                                             int r) {
  if (r >= t.rows) return -1;
  const int d = t.d0 + r / (s.TH * s.TW);
  const int h = t.h0 + (r / s.TW) % s.TH;
  const int w = t.w0 + r % s.TW;
  if (d >= s.D || h >= s.H || w >= s.W) return -1;
  return ((static_cast<int64_t>(t.b) * s.D + d) * s.H + h) * s.W + w;
}

// Global voxel behind halo voxel v, or -1 in the zero padding.
__device__ __forceinline__ int64_t halo_voxel(const Shape& s, const Tile& t,
                                              int v) {
  const int hx = v % t.HW;
  const int q = v / t.HW;
  const int hy = q % t.HH;
  const int hz = q / t.HH;
  const int d = t.d0 + hz - 1, h = t.h0 + hy - 1, w = t.w0 + hx - 1;
  if (d < 0 || d >= s.D || h < 0 || h >= s.H || w < 0 || w >= s.W) return -1;
  return ((static_cast<int64_t>(t.b) * s.D + d) * s.H + h) * s.W + w;
}

__device__ __forceinline__ float silu_f32(float h) {
  return h * (1.f / (1.f + expf(-h)));
}

// x * g + b rounded twice (no FMA), then the optional SiLU
__device__ __forceinline__ float prologue_f32_op(float x, float g, float b,
                                                 int silu) {
  const float h = __fadd_rn(__fmul_rn(x, g), b);
  return silu ? silu_f32(h) : h;
}

// inside[v] = 1 where halo voxel v lies in the volume (fused prologue only;
// the chunk loop's first barrier publishes it)
__device__ __forceinline__ void mark_inside(const Shape& s, const Tile& t,
                                            unsigned char* inside) {
  for (int v = threadIdx.x; v < t.halo; v += kThreads)
    inside[v] = halo_voxel(s, t, v) >= 0;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = pred ? 16 : 0;  // src-size 0 zero-fills the 16 bytes
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// ----------------------------------------------------------------- bf16 --

constexpr int kBN = 128;          // output channels per block
constexpr int kBK = 32;           // Cin chunk
constexpr int kLds = kBK + 8;     // smem row pitch (bf16): ldmatrix conflict-free

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <bool kVec>
__device__ __forceinline__ void stage_halo_bf16(
    const Shape& s, const Tile& t, const __nv_bfloat16* __restrict__ x,
    __nv_bfloat16* sA, int ci0) {
  if (kVec) {  // Cin % 8 == 0: 16-byte pieces of 8 channels
    for (int i = threadIdx.x; i < t.halo * (kBK / 8); i += kThreads) {
      const int v = i / (kBK / 8), part = i % (kBK / 8);
      const int ci = ci0 + part * 8;
      const int64_t vox = halo_voxel(s, t, v);
      const bool ok = vox >= 0 && ci < s.Cin;
      const __nv_bfloat16* src = ok ? x + vox * s.Cin + ci : x;
      cp_async16(sA + v * kLds + part * 8, src, ok);
    }
  } else {  // narrow Cin (the 2-channel input conv)
    for (int i = threadIdx.x; i < t.halo * kBK; i += kThreads) {
      const int v = i / kBK, k = i % kBK;
      const int ci = ci0 + k;
      const int64_t vox = halo_voxel(s, t, v);
      sA[v * kLds + k] = (vox >= 0 && ci < s.Cin)
                             ? x[vox * s.Cin + ci]
                             : __float2bfloat16_rn(0.f);
    }
  }
}

// Weights are packed [27][Cout][Cin] so that one tap's tile is [n][k].
template <bool kVec>
__device__ __forceinline__ void stage_weights_bf16(
    const Shape& s, const __nv_bfloat16* __restrict__ w, __nv_bfloat16* sB,
    int tap, int n0, int ci0) {
  if (kVec) {
    for (int i = threadIdx.x; i < kBN * (kBK / 8); i += kThreads) {
      const int n = i / (kBK / 8), part = i % (kBK / 8);
      const int co = n0 + n, ci = ci0 + part * 8;
      const bool ok = co < s.Cout && ci < s.Cin;
      const __nv_bfloat16* src =
          ok ? w + (static_cast<int64_t>(tap) * s.Cout + co) * s.Cin + ci : w;
      cp_async16(sB + n * kLds + part * 8, src, ok);
    }
  } else {
    for (int i = threadIdx.x; i < kBN * kBK; i += kThreads) {
      const int n = i / kBK, k = i % kBK;
      const int co = n0 + n, ci = ci0 + k;
      sB[n * kLds + k] =
          (co < s.Cout && ci < s.Cin)
              ? w[(static_cast<int64_t>(tap) * s.Cout + co) * s.Cin + ci]
              : __float2bfloat16_rn(0.f);
    }
  }
}

// the fused kernel's extra shared memory past the weight buffers: the stats
// reduction (red floats), then the halo's inside mask
constexpr size_t fused_smem(int red_floats) {
  return red_floats * sizeof(float) + kMaxHalo;
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads, 2)
    conv3d_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                       const __nv_bfloat16* __restrict__ w,
                       const float* __restrict__ bias,
                       __nv_bfloat16* __restrict__ y, Shape s) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Tile t = decode_tile(s);
  __nv_bfloat16* sA = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sB0 = sA + t.halo * kLds;
  __nv_bfloat16* sB[2] = {sB0, sB0 + kBN * kLds};

  const int n0 = blockIdx.y * kBN;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp & 1, wn = warp >> 1;  // 2 x 4 warps, 64 x 32 each

  // ldmatrix row addresses: A rows are gathered voxels of the halo tile
  int a_base[4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
    a_base[mi] = row_base(s, t, wm * 64 + mi * 16 + (lane & 15));
  const int a_k = (lane >> 4) * 8;
  int b_row[2];
#pragma unroll
  for (int p = 0; p < 2; ++p)
    b_row[p] = wn * 32 + p * 16 + (lane & 7) + ((lane >> 4) << 3);
  const int b_k = ((lane >> 3) & 1) * 8;

  float acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int nj = 0; nj < 4; ++nj)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][nj][e] = 0.f;

  for (int ci0 = 0; ci0 < s.Cin; ci0 += kBK) {
    __syncthreads();  // previous chunk's reads of sA / sB are done
    stage_halo_bf16<kVec>(s, t, x, sA, ci0);
    stage_weights_bf16<kVec>(s, w, sB[0], 0, n0, ci0);
    cp_async_commit();
    for (int tap = 0; tap < kTaps; ++tap) {
      if (tap + 1 < kTaps) {
        stage_weights_bf16<kVec>(s, w, sB[(tap + 1) & 1], tap + 1, n0, ci0);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const int kd = tap / 9, kh = (tap / 3) % 3, kw = tap % 3;
      const int toff = (kd * t.HH + kh) * t.HW + kw;
      const __nv_bfloat16* tB = sB[tap & 1];
#pragma unroll
      for (int ks = 0; ks < kBK; ks += 16) {
        unsigned af[4][4];
#pragma unroll
        for (int mi = 0; mi < 4; ++mi)
          ldmatrix_x4(af[mi], sA + (a_base[mi] + toff) * kLds + ks + a_k);
        unsigned bfr[2][4];
#pragma unroll
        for (int p = 0; p < 2; ++p)
          ldmatrix_x4(bfr[p], tB + b_row[p] * kLds + ks + b_k);
#pragma unroll
        for (int mi = 0; mi < 4; ++mi)
#pragma unroll
          for (int nj = 0; nj < 4; ++nj)
            mma_bf16(acc[mi][nj], af[mi], bfr[nj >> 1][(nj & 1) * 2],
                     bfr[nj >> 1][(nj & 1) * 2 + 1]);
      }
      __syncthreads();  // this tap's weight buffer is refilled two taps on
    }
  }

  // epilogue: + bias (f32), round to bf16, masked store
  const int g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = wm * 64 + mi * 16 + g + half * 8;
      const int64_t vox = row_voxel(s, t, r);
      if (vox < 0) continue;
      __nv_bfloat16* yr = y + vox * s.Cout;
#pragma unroll
      for (int nj = 0; nj < 4; ++nj) {
        const int col = n0 + wn * 32 + nj * 8 + tq * 2;
        if (col >= s.Cout) continue;
        float v0 = acc[mi][nj][half * 2];
        float v1 = acc[mi][nj][half * 2 + 1];
        if (bias != nullptr) {
          v0 += bias[col];
          if (col + 1 < s.Cout) v1 += bias[col + 1];
        }
        if (col + 1 < s.Cout && (s.Cout & 1) == 0) {
          *reinterpret_cast<__nv_bfloat162*>(yr + col) =
              __floats2bfloat162_rn(v0, v1);
        } else {
          yr[col] = __float2bfloat16_rn(v0);
          if (col + 1 < s.Cout) yr[col + 1] = __float2bfloat16_rn(v1);
        }
      }
    }
  }
}

// ------------------------------------------------------------------ f32 --

constexpr int kBKf = 16;
constexpr int kLdaF = kBKf + 4;  // 80-byte rows keep 16-byte cp.async aligned

template <bool kVec>
__device__ __forceinline__ void stage_halo_f32(const Shape& s, const Tile& t,
                                               const float* __restrict__ x,
                                               float* sA, int ci0) {
  if (kVec) {  // Cin % 4 == 0
    for (int i = threadIdx.x; i < t.halo * (kBKf / 4); i += kThreads) {
      const int v = i / (kBKf / 4), part = i % (kBKf / 4);
      const int ci = ci0 + part * 4;
      const int64_t vox = halo_voxel(s, t, v);
      const bool ok = vox >= 0 && ci < s.Cin;
      const float* src = ok ? x + vox * s.Cin + ci : x;
      cp_async16(sA + v * kLdaF + part * 4, src, ok);
    }
  } else {
    for (int i = threadIdx.x; i < t.halo * kBKf; i += kThreads) {
      const int v = i / kBKf, k = i % kBKf;
      const int ci = ci0 + k;
      const int64_t vox = halo_voxel(s, t, v);
      sA[v * kLdaF + k] = (vox >= 0 && ci < s.Cin) ? x[vox * s.Cin + ci] : 0.f;
    }
  }
}

// f32 weight tile is stored [k][n] (n contiguous) for the FFMA inner loop.
template <int BN>
__device__ __forceinline__ void stage_weights_f32(const Shape& s,
                                                  const float* __restrict__ w,
                                                  float* sB, int tap, int n0,
                                                  int ci0) {
  constexpr int kLdb = BN + 4;
  for (int i = threadIdx.x; i < BN * kBKf; i += kThreads) {
    const int n = i / kBKf, k = i % kBKf;
    const int co = n0 + n, ci = ci0 + k;
    sB[k * kLdb + n] =
        (co < s.Cout && ci < s.Cin)
            ? w[(static_cast<int64_t>(tap) * s.Cout + co) * s.Cin + ci]
            : 0.f;
  }
}

// The fused prologue on the staged f32 chunk, in place: silu?(x * g + b)
// for in-volume voxels; the padding and ragged Cin were zero-filled while
// staging and stay 0 (conv after normalize: silu(0 * g + b) is not 0). Each thread owns one channel of the chunk.
__device__ __forceinline__ void prologue_f32(const Shape& s, const Tile& t,
                                             const Fused& f,
                                             const unsigned char* inside,
                                             float* sA, int ci0) {
  const int k = threadIdx.x % kBKf;
  const int ci = ci0 + k;
  if (ci >= s.Cin) return;  // ragged Cin stays 0
  const int64_t row = static_cast<int64_t>(t.b) * s.Cin;
  const float gk = f.g[row + ci], bk = f.b[row + ci];
  for (int v = threadIdx.x / kBKf; v < t.halo; v += kThreads / kBKf)
    if (inside[v])
      sA[v * kLdaF + k] = prologue_f32_op(sA[v * kLdaF + k], gk, bk, f.silu);
}

// the f32 kernel's stats reduction is [warp][2][BN] floats
constexpr int kWarps = kThreads / 32;

// BN output channels per block; each thread owns TM rows x TN columns.
template <int BN, int TN, int TM, bool kVec, bool kFused>
__global__ void __launch_bounds__(kThreads, 2)
    conv3d_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                      const float* __restrict__ bias, float* __restrict__ y,
                      Shape s, Fused f) {
  constexpr int kCG = BN / TN;
  constexpr int kRG = kThreads / kCG;
  static_assert(kRG * TM == kMaxRows, "tile rows");
  constexpr int kLdb = BN + 4;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Tile t = decode_tile(s);
  float* sA = reinterpret_cast<float*>(smem_raw);
  float* sB[2] = {sA + t.halo * kLdaF, sA + t.halo * kLdaF + kBKf * kLdb};

  const int n0 = blockIdx.y * BN;
  const int cg = threadIdx.x % kCG, rg = threadIdx.x / kCG;
  int a_base[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) a_base[i] = row_base(s, t, rg + i * kRG);

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  // fused: [red floats][inside bytes] past the weight buffers
  float* red = sB[0] + 2 * kBKf * kLdb;
  unsigned char* inside = reinterpret_cast<unsigned char*>(red + kWarps * 2 * BN);
  if constexpr (kFused) {
    if (f.g != nullptr) mark_inside(s, t, inside);
  }

  for (int ci0 = 0; ci0 < s.Cin; ci0 += kBKf) {
    __syncthreads();
    stage_halo_f32<kVec>(s, t, x, sA, ci0);
    stage_weights_f32<BN>(s, w, sB[0], 0, n0, ci0);
    cp_async_commit();
    for (int tap = 0; tap < kTaps; ++tap) {
      if (tap + 1 < kTaps) {
        stage_weights_f32<BN>(s, w, sB[(tap + 1) & 1], tap + 1, n0, ci0);
      }
      cp_async_wait<0>();
      __syncthreads();
      if constexpr (kFused) {
        if (tap == 0 && f.g != nullptr) {  // the chunk has landed
          prologue_f32(s, t, f, inside, sA, ci0);
          __syncthreads();  // normalized before any thread reads it
        }
      }
      const int kd = tap / 9, kh = (tap / 3) % 3, kw = tap % 3;
      const int toff = (kd * t.HH + kh) * t.HW + kw;
      const float* tB = sB[tap & 1] + cg * TN;
#pragma unroll
      for (int k = 0; k < kBKf; ++k) {
        float a[TM], bv[TN];
#pragma unroll
        for (int i = 0; i < TM; ++i) a[i] = sA[(a_base[i] + toff) * kLdaF + k];
#pragma unroll
        for (int j = 0; j < TN; ++j) bv[j] = tB[k * kLdb + j];
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

  float s1[TN] = {}, s2[TN] = {};
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int64_t vox = row_voxel(s, t, rg + i * kRG);
    if (vox < 0) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int col = n0 + cg * TN + j;
      if constexpr (kFused) {
        if (col >= s.Cout) continue;
        float v = acc[i][j] + (bias ? bias[col] : 0.f);
        if (f.skip != nullptr)
          v += static_cast<const float*>(f.skip)[vox * s.Cout + col];
        s1[j] += v;
        s2[j] += v * v;
        y[vox * s.Cout + col] = v;
      } else {
        if (col < s.Cout)
          y[vox * s.Cout + col] = acc[i][j] + (bias ? bias[col] : 0.f);
      }
    }
  }
  if constexpr (kFused) {
    if (f.part != nullptr) {
      // reduce over the row groups of a warp (lanes kCG apart), then over
      // the warps in shared memory, in a fixed order
#pragma unroll
      for (int j = 0; j < TN; ++j)
#pragma unroll
        for (int off = kCG; off < 32; off <<= 1) {
          s1[j] += __shfl_xor_sync(0xffffffffu, s1[j], off);
          s2[j] += __shfl_xor_sync(0xffffffffu, s2[j], off);
        }
      const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
      if (lane < kCG) {
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          red[(warp * 2) * BN + cg * TN + j] = s1[j];
          red[(warp * 2 + 1) * BN + cg * TN + j] = s2[j];
        }
      }
      __syncthreads();
      for (int i = threadIdx.x; i < 2 * BN; i += kThreads) {
        const int q = i / BN, c = i % BN;
        if (n0 + c >= s.Cout) continue;
        float sum = 0.f;
        for (int wp = 0; wp < kWarps; ++wp) sum += red[(wp * 2 + q) * BN + c];
        f.part[(static_cast<int64_t>(blockIdx.x) * 2 + q) * s.Cout + n0 + c] =
            sum;
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

// Launch the conv (kFused = false: the plain conv, f all NULL) on a
// validated shape. Returns a cudaError_t.
template <bool kFused>
cudaError_t launch_conv(const void* x, const void* w, const float* bias,
                        void* y, const Fused& f, const Shape& s, int dtype,
                        cudaStream_t stream) {
  const int halo = (s.TD + 2) * (s.TH + 2) * (s.TW + 2);
  const int64_t tiles = static_cast<int64_t>(s.B) * s.nD * s.nH * s.nW;
  const bool aligned = (reinterpret_cast<uintptr_t>(x) % 16 == 0) &&
                       (reinterpret_cast<uintptr_t>(w) % 16 == 0);
  cudaError_t err;
  if (dtype == 1 && !kFused) {  // (the bf16 fused conv: csrc/conv3d_sm90.cu)
    const dim3 grid(static_cast<unsigned>(tiles), (s.Cout + kBN - 1) / kBN);
    const size_t smem = (static_cast<size_t>(halo) + 2 * kBN) * kLds *
                        sizeof(__nv_bfloat16);
    const bool vec = aligned && s.Cin % 8 == 0;
    auto kernel = vec ? conv3d_bf16_kernel<true> : conv3d_bf16_kernel<false>;
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    kernel<<<grid, kThreads, smem, stream>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(w), bias,
        static_cast<__nv_bfloat16*>(y), s);
  } else if (dtype == 0) {
    const bool vec = aligned && s.Cin % 4 == 0;
    constexpr int BN = 64;
    const dim3 grid(static_cast<unsigned>(tiles), (s.Cout + BN - 1) / BN);
    const size_t smem = (static_cast<size_t>(halo) * kLdaF +
                         2 * kBKf * (BN + 4)) * sizeof(float) +
                        (kFused ? fused_smem(kWarps * 2 * BN) : 0);
    auto kernel = vec ? conv3d_f32_kernel<BN, 4, 8, true, kFused>
                      : conv3d_f32_kernel<BN, 4, 8, false, kFused>;
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    kernel<<<grid, kThreads, smem, stream>>>(
        static_cast<const float*>(x), static_cast<const float*>(w), bias,
        static_cast<float*>(y), s, f);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// The shape of a launch, or false if the kernels do not take it.
bool make_shape(Shape* s, int B, int D, int H, int W, int Cin, int Cout,
                int TD, int TH, int TW) {
  if (B <= 0 || D <= 0 || H <= 0 || W <= 0 || Cin <= 0 || Cout <= 0 ||
      TD <= 0 || TH <= 0 || TW <= 0 || TD * TH * TW > kMaxRows ||
      (TD + 2) * (TH + 2) * (TW + 2) > kMaxHalo)
    return false;
  *s = Shape{B, D, H, W, Cin, Cout, TD, TH, TW,
             (D + TD - 1) / TD, (H + TH - 1) / TH, (W + TW - 1) / TW};
  return static_cast<int64_t>(B) * s->nD * s->nH * s->nW <= 0x7fffffff;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x, w and y share it; bias is f32 or
// NULL). w is packed [27][Cout][Cin]. Returns a cudaError_t.
int conv3d_ndhwc_launch(const void* x, const void* w, const float* bias,
                        void* y, int B, int D, int H, int W, int Cin, int Cout,
                        int TD, int TH, int TW, int dtype, void* stream_ptr) {
  Shape s;
  if (!make_shape(&s, B, D, H, W, Cin, Cout, TD, TH, TW))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_conv<false>(
      x, w, bias, y, Fused{}, s, dtype, static_cast<cudaStream_t>(stream_ptr)));
}

// The fused conv in f32 (dtype must be 0; the bf16 fused conv is
// conv3d_sm90_fused_launch in csrc/conv3d_sm90.cu). x, w, skip and y are
// f32; bias is f32 or NULL; g and gb are the [B, Cin] f32 prologue (both
// NULL for none); skip is [B, D, H, W, Cout] or NULL. With stats,
// part holds B*T*2*Cout floats and part2 B*ceil(T/64)*2*Cout floats of
// scratch (T = tiles per volume) and stats receives [B, 2, Cout] f32; all
// three NULL for no stats. Returns a cudaError_t.
int conv3d_fused_launch(const void* x, const void* w, const float* bias,
                        const float* g, const float* gb, int silu,
                        const void* skip, void* y, float* part, float* part2,
                        float* stats, int B, int D, int H, int W, int Cin,
                        int Cout, int TD, int TH, int TW, int dtype,
                        void* stream_ptr) {
  Shape s;
  const bool want_stats = part != nullptr;
  if (!make_shape(&s, B, D, H, W, Cin, Cout, TD, TH, TW) ||
      (g == nullptr) != (gb == nullptr) ||
      (part2 == nullptr) != !want_stats || (stats == nullptr) != !want_stats ||
      reinterpret_cast<uintptr_t>(skip) % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const Fused f{g, gb, skip, part, silu};
  cudaError_t err = launch_conv<true>(x, w, bias, y, f, s, dtype, stream);
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

// int8 (W8A8) stride-1 SAME 3x3x3 and 1x1x1 convolution, channels-last
// (NDHWC), with the dequantize epilogue, for Hopper (sm_90a).
//
// Replaces the TPU kernel ddpm3d_tpu/ops/conv3d_s8.py:_conv_kernel /
// _conv_kernel_im2col (reached through conv3d_s8), and serves every quantized
// conv site of the JAX package's int8 path (ops/quant.py:
// conv3d_folded_int8, upsample_conv_folded_int8). Same function:
//
//   acc[b,v,n] = sum_{taps,ci} xq[b, v + tap - pad, ci] * wq[tap, n, ci]
//                                                       s8 x s8 -> s32, exact
//   y[b,v,n]   = float(acc) * (sx[b] * sw[n]) + bias[n]   f32, no FMA
//
// rounded once to the output dtype (bf16 or f32). xq and wq are int8;
// zero padding is int8 0 (symmetric quantization has no zero point, so
// padding x and padding q(x) agree). |acc| <= 127^2 * 27 * 1024 ~ 4.5e8 <
// 2^31 at every shape of the model. The multiply and the add are rounded
// separately (__fmul_rn / __fadd_rn, not contracted), which is the JAX
// package's default lowering (quant.py:638-642): the kernel equals its
// plain version bit for bit.
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
// Bound on the H100: operations. 54 * Cin * Cout int8 operations per
// output voxel against (Cin + 2 * Cout) bytes moved (bf16 out): ~2200
// op/byte at Cin = Cout = 128, above the card's ~590 int8 op/byte ridge.
// The 1x1 sites (27x fewer operations) sit near the ridge.
//
// Design: a new source, the int8 sibling of csrc/conv3d.cu's bf16 template
// (its halo staging, cp.async double buffering and host-side tile choice,
// ops/conv3d.py:pick_tile, carry over), kept apart so that the K3/K4
// instances compile exactly as before and the two sources build in
// parallel:
//  * Implicit GEMM, M = output voxels (a TD x TH x TW tile, <= 128 rows),
//    N = 128 columns per block, K = taps x Cin.
//  * Per Cin chunk of 64 channels the block stages the haloed input tile
//    (TD+2)(TH+2)(TW+2) x 64 bytes in shared memory once and runs every tap
//    out of it (1x1: no halo); edges and ragged Cin zero-fill while staging
//    (cp.async src-size 0), so no padded copy of x exists.
//  * One tap's weight tile [128 columns][64 channels] is double-buffered
//    with cp.async under the previous tap's math.
//  * 8 warps, warp tile 64 x 32, mma.sync m16n8k32 s8 -> s32, operands by
//    ldmatrix: an int8 16x32 A (or 32x8 B) fragment has the byte layout of
//    a bf16 16x16 (16x8) one, so the bf16 kernel's ldmatrix addressing
//    carries over with K in bytes. The 80-byte smem pitch keeps ldmatrix
//    free of bank conflicts.
//  * The phase route runs the zero taps too: 27/12 of the phase MACs.
// wgmma/TMA, a tap mask for the phases and a persistent schedule are later
// work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRows = 128;   // output voxels per block
constexpr int kMaxHalo = 640;   // staged halo voxels, at most
constexpr int kBN = 128;        // GEMM columns per block
constexpr int kBK = 64;         // Cin chunk (channels = bytes)
constexpr int kLds = kBK + 16;  // smem row pitch in bytes

struct Shape {
  int B, D, H, W, Cin;
  int N;      // GEMM columns: Cout, or 4 * Cout for the phase route
  int Cout;   // channels of y
  int TD, TH, TW;
  int nD, nH, nW;
  int up;     // 1: the stacked phases of conv(nearest_up2_HW(x))
};

struct Tile {
  int b, d0, h0, w0;
  int HH, HW, halo, rows;
};

template <int kPad>
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
  t.HH = s.TH + 2 * kPad;
  t.HW = s.TW + 2 * kPad;
  t.halo = (s.TD + 2 * kPad) * t.HH * t.HW;
  t.rows = s.TD * s.TH * s.TW;
  return t;
}

// Halo-relative voxel of output row r (tap offset 0).
__device__ __forceinline__ int row_base(const Shape& s, const Tile& t, int r) {
  if (r >= t.rows) return 0;  // idle row: reads valid smem, never stored
  const int dz = r / (s.TH * s.TW);
  const int hy = (r / s.TW) % s.TH;
  const int wx = r % s.TW;
  return (dz * t.HH + hy) * t.HW + wx;
}

// Global voxel behind halo voxel v, or -1 in the zero padding.
template <int kPad>
__device__ __forceinline__ int64_t halo_voxel(const Shape& s, const Tile& t,
                                              int v) {
  const int hx = v % t.HW;
  const int q = v / t.HW;
  const int hy = q % t.HH;
  const int hz = q / t.HH;
  const int d = t.d0 + hz - kPad, h = t.h0 + hy - kPad, w = t.w0 + hx - kPad;
  if (d < 0 || d >= s.D || h < 0 || h >= s.H || w < 0 || w >= s.W) return -1;
  return ((static_cast<int64_t>(t.b) * s.D + d) * s.H + h) * s.W + w;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  const unsigned sa = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = pred ? 16 : 0;  // src-size 0 zero-fills the 16 bytes
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(sa),
               "l"(gmem), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  const unsigned sa = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(sa));
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const unsigned (&a)[4],
                                       unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <bool kVec, int kPad>
__device__ __forceinline__ void stage_halo(const Shape& s, const Tile& t,
                                           const int8_t* __restrict__ x,
                                           int8_t* sA, int ci0) {
  if (kVec) {  // Cin % 16 == 0: 16-byte pieces of 16 channels
    for (int i = threadIdx.x; i < t.halo * (kBK / 16); i += kThreads) {
      const int v = i / (kBK / 16), part = i % (kBK / 16);
      const int ci = ci0 + part * 16;
      const int64_t vox = halo_voxel<kPad>(s, t, v);
      const bool ok = vox >= 0 && ci < s.Cin;
      const int8_t* src = ok ? x + vox * s.Cin + ci : x;
      cp_async16(sA + v * kLds + part * 16, src, ok);
    }
  } else {  // any Cin, one byte at a time
    for (int i = threadIdx.x; i < t.halo * kBK; i += kThreads) {
      const int v = i / kBK, k = i % kBK;
      const int ci = ci0 + k;
      const int64_t vox = halo_voxel<kPad>(s, t, v);
      sA[v * kLds + k] = (vox >= 0 && ci < s.Cin) ? x[vox * s.Cin + ci] : 0;
    }
  }
}

// Weights are packed [taps][N][Cin] so that one tap's tile is [n][k].
template <bool kVec>
__device__ __forceinline__ void stage_weights(const Shape& s,
                                              const int8_t* __restrict__ w,
                                              int8_t* sB, int tap, int n0,
                                              int ci0) {
  if (kVec) {
    for (int i = threadIdx.x; i < kBN * (kBK / 16); i += kThreads) {
      const int n = i / (kBK / 16), part = i % (kBK / 16);
      const int co = n0 + n, ci = ci0 + part * 16;
      const bool ok = co < s.N && ci < s.Cin;
      const int8_t* src =
          ok ? w + (static_cast<int64_t>(tap) * s.N + co) * s.Cin + ci : w;
      cp_async16(sB + n * kLds + part * 16, src, ok);
    }
  } else {
    for (int i = threadIdx.x; i < kBN * kBK; i += kThreads) {
      const int n = i / kBK, k = i % kBK;
      const int co = n0 + n, ci = ci0 + k;
      sB[n * kLds + k] =
          (co < s.N && ci < s.Cin)
              ? w[(static_cast<int64_t>(tap) * s.N + co) * s.Cin + ci]
              : 0;
    }
  }
}

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

// The epilogue of one element: dequantize (and the bias where it goes
// before the rounding), round once to OutT; the phase route adds its bias
// to the rounded value and rounds again, as y + bias in OutT.
template <typename OutT>
__device__ __forceinline__ OutT dequant(int acc, float scale,
                                        const float* __restrict__ bias, int c,
                                        bool bias_late) {
  float v = __fmul_rn(__int2float_rn(acc), scale);
  if (bias == nullptr) return from_float<OutT>(v);
  if (!bias_late) return from_float<OutT>(__fadd_rn(v, bias[c]));
  return from_float<OutT>(__fadd_rn(to_float(from_float<OutT>(v)), bias[c]));
}

template <typename OutT>
__device__ __forceinline__ void store_pair(OutT* p, OutT v0, OutT v1);
template <>
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, __nv_bfloat16 v0,
                                           __nv_bfloat16 v1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __halves2bfloat162(v0, v1);
}
template <>
__device__ __forceinline__ void store_pair(float* p, float v0, float v1) {
  *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
}

template <bool kVec, int kPad, typename OutT>
__global__ void __launch_bounds__(kThreads, 2)
    conv3d_s8_kernel(const int8_t* __restrict__ x,
                     const int8_t* __restrict__ w,
                     const float* __restrict__ sx,
                     const float* __restrict__ sw,
                     const float* __restrict__ bias, OutT* __restrict__ y,
                     Shape s) {
  constexpr int kTaps = kPad ? 27 : 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Tile t = decode_tile<kPad>(s);
  int8_t* sA = reinterpret_cast<int8_t*>(smem_raw);
  int8_t* sB0 = sA + t.halo * kLds;
  int8_t* sB[2] = {sB0, sB0 + kBN * kLds};

  const int n0 = blockIdx.y * kBN;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp & 1, wn = warp >> 1;  // 2 x 4 warps, 64 x 32 each

  // ldmatrix row addresses: A rows are gathered voxels of the halo tile
  int a_base[4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
    a_base[mi] = row_base(s, t, wm * 64 + mi * 16 + (lane & 15));
  const int a_k = (lane >> 4) * 16;  // bytes
  int b_row[2];
#pragma unroll
  for (int p = 0; p < 2; ++p)
    b_row[p] = wn * 32 + p * 16 + (lane & 7) + ((lane >> 4) << 3);
  const int b_k = ((lane >> 3) & 1) * 16;  // bytes

  int acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int nj = 0; nj < 4; ++nj)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][nj][e] = 0;

  for (int ci0 = 0; ci0 < s.Cin; ci0 += kBK) {
    __syncthreads();  // previous chunk's reads of sA / sB are done
    stage_halo<kVec, kPad>(s, t, x, sA, ci0);
    stage_weights<kVec>(s, w, sB[0], 0, n0, ci0);
    cp_async_commit();
    for (int tap = 0; tap < kTaps; ++tap) {
      if (tap + 1 < kTaps) {
        stage_weights<kVec>(s, w, sB[(tap + 1) & 1], tap + 1, n0, ci0);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const int kd = tap / 9, kh = (tap / 3) % 3, kw = tap % 3;
      const int toff = (kd * t.HH + kh) * t.HW + kw;  // 0 for the 1x1 conv
      const int8_t* tB = sB[tap & 1];
#pragma unroll
      for (int ks = 0; ks < kBK; ks += 32) {
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
            mma_s8(acc[mi][nj], af[mi], bfr[nj >> 1][(nj & 1) * 2],
                   bfr[nj >> 1][(nj & 1) * 2 + 1]);
      }
      __syncthreads();  // this tap's weight buffer is refilled two taps on
    }
  }

  // epilogue: dequantize, bias, one rounding, masked store (the phase route
  // scatters each column to its phase of the upsampled output)
  const int g = lane >> 2, tq = lane & 3;
  const float sxb = sx[t.b];
  const int oH = s.up ? 2 * s.H : s.H, oW = s.up ? 2 * s.W : s.W;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = wm * 64 + mi * 16 + g + half * 8;
      if (r >= t.rows) continue;
      const int d = t.d0 + r / (s.TH * s.TW);
      const int h = t.h0 + (r / s.TW) % s.TH;
      const int wx = t.w0 + r % s.TW;
      if (d >= s.D || h >= s.H || wx >= s.W) continue;
#pragma unroll
      for (int nj = 0; nj < 4; ++nj) {
        const int col = n0 + wn * 32 + nj * 8 + tq * 2;
        if (col >= s.N) continue;
        OutT v[2];
        int64_t idx[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = col + e;
          if (n >= s.N) break;
          int c = n, a = 0, bb = 0;
          if (s.up) {
            const int p = n / s.Cout;
            c = n - p * s.Cout;
            a = p >> 1;
            bb = p & 1;
          }
          idx[e] = (((static_cast<int64_t>(t.b) * s.D + d) * oH +
                     (s.up ? 2 * h + a : h)) * oW +
                    (s.up ? 2 * wx + bb : wx)) * s.Cout + c;
          v[e] = dequant<OutT>(acc[mi][nj][half * 2 + e],
                               __fmul_rn(sxb, sw[n]), bias, c, s.up != 0);
        }
        if (col + 1 < s.N && idx[1] == idx[0] + 1 && (idx[0] & 1) == 0) {
          store_pair(y + idx[0], v[0], v[1]);
        } else {
          y[idx[0]] = v[0];
          if (col + 1 < s.N) y[idx[1]] = v[1];
        }
      }
    }
  }
}

template <int kPad, typename OutT>
cudaError_t launch_typed(const int8_t* x, const int8_t* w, const float* sx,
                         const float* sw, const float* bias, OutT* y,
                         const Shape& s, bool vec, cudaStream_t stream) {
  const int halo =
      (s.TD + 2 * kPad) * (s.TH + 2 * kPad) * (s.TW + 2 * kPad);
  const int64_t tiles = static_cast<int64_t>(s.B) * s.nD * s.nH * s.nW;
  const dim3 grid(static_cast<unsigned>(tiles), (s.N + kBN - 1) / kBN);
  const size_t smem = (static_cast<size_t>(halo) + 2 * kBN) * kLds;
  auto kernel = vec ? conv3d_s8_kernel<true, kPad, OutT>
                    : conv3d_s8_kernel<false, kPad, OutT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, stream>>>(x, w, sx, sw, bias, y, s);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// xq [B, D, H, W, Cin] int8; w packed [taps][N][Cin] int8 (taps 27: the
// 3x3x3 conv, 1: the 1x1x1 conv); sx [B] and sw [N] f32; bias [Cout] f32 or
// NULL (on the phase route: the bias already rounded to the output dtype).
// upsample = 1 (taps 27 only): N = 4 * Cout stacked phases, y is
// [B, D, 2H, 2W, Cout]; else N = Cout and y is [B, D, H, W, Cout].
// out_dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t.
int conv3d_s8_launch(const void* x, const void* w, const float* sx,
                     const float* sw, const float* bias, void* y, int B, int D,
                     int H, int W, int Cin, int N, int taps, int upsample,
                     int TD, int TH, int TW, int out_dtype, void* stream_ptr) {
  if (B <= 0 || D <= 0 || H <= 0 || W <= 0 || Cin <= 0 || N <= 0 ||
      TD <= 0 || TH <= 0 || TW <= 0 || TD * TH * TW > kMaxRows ||
      (TD + 2) * (TH + 2) * (TW + 2) > kMaxHalo ||
      (taps != 27 && taps != 1) || (upsample && (taps != 27 || N % 4)) ||
      (out_dtype != 0 && out_dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  Shape s{B, D, H, W, Cin, N, upsample ? N / 4 : N, TD, TH, TW,
          (D + TD - 1) / TD, (H + TH - 1) / TH, (W + TW - 1) / TW,
          upsample ? 1 : 0};
  if (static_cast<int64_t>(B) * s.nD * s.nH * s.nW > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  const int8_t* xq = static_cast<const int8_t*>(x);
  const int8_t* wq = static_cast<const int8_t*>(w);
  const bool vec = Cin % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(w) % 16 == 0;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  cudaError_t err;
  if (out_dtype == 1) {
    __nv_bfloat16* yb = static_cast<__nv_bfloat16*>(y);
    err = taps == 27
              ? launch_typed<1>(xq, wq, sx, sw, bias, yb, s, vec, stream)
              : launch_typed<0>(xq, wq, sx, sw, bias, yb, s, vec, stream);
  } else {
    float* yf = static_cast<float*>(y);
    err = taps == 27
              ? launch_typed<1>(xq, wq, sx, sw, bias, yf, s, vec, stream)
              : launch_typed<0>(xq, wq, sx, sw, bias, yf, s, vec, stream);
  }
  return static_cast<int>(err);
}

}  // extern "C"

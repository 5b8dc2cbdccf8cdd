// Stride-1 SAME 3x3x3 convolution in bf16, channels-last (NDHWC
// activations), for Hopper (sm_90a): the bf16 convs that no other kernel
// takes, Cin above 8 and not a multiple of 8 (rows that are not 16-byte
// strided, so TMA cannot stage them). No model of the port or of the JAX
// package runs such a conv: every bf16 Cin of 1 to 7 runs
// csrc/conv3d_narrow.cu, every multiple of 8 csrc/conv3d_sm90.cu.
//
// Replaces the TPU kernel ddpm3d_tpu/ops/conv3d_mxu.py:_conv_kernel (reached
// through conv3d_mxu) at those shapes. Same function:
//
//   y[b,d,h,w,co] = bias[co] + sum_{kd,kh,kw,ci} x[b,d+kd-1,h+kh-1,w+kw-1,ci]
//                                               * w[kd,kh,kw,ci,co]
//
// with zero padding, f32 accumulation and the result stored in bf16.
//
// Bound on the H100: operations at wide Cin (54*Cin*Cout FLOP per voxel
// against (Cin+Cout)*2 bytes), bytes at narrow Cin.
//
// Design (implicit GEMM, M = output voxels, N = Cout, K = 27*Cin):
//  * A block owns an output tile of TD x TH x TW voxels (<= 128 rows, the
//    shape is picked per volume on the host so that ragged W = 6 or 12
//    planes still fill the rows) and 128 output channels.
//  * Per Cin chunk the block stages the HALOED input tile
//    (TD+2)(TH+2)(TW+2) x chunk in shared memory once, then runs all 27
//    taps out of it: every input element is read from device memory about
//    (halo / tile) ~ 3x instead of 27x. Volume edges and ragged Cin are
//    zero-filled while staging (cp.async with src-size 0), so no padded copy
//    of x is ever made.
//  * The weight tile of one tap, [Cout-tile][Cin-chunk], is double-buffered
//    with cp.async under the previous tap's math.
//  * 8 warps, warp tile 64x32, mma.sync m16n8k16 bf16 -> f32 with operands
//    fed by ldmatrix. Row addresses of ldmatrix are free per lane, which is
//    what lets one staged halo tile serve all 27 shifted taps.
//  * Bias is added in f32 in the epilogue; rows outside the volume or the
//    tile and columns past Cout are masked there.
// The bf16 torso convs run csrc/conv3d_sm90.cu, the Cin = 1 to 7 input
// convs csrc/conv3d_narrow.cu, the f32 convs csrc/conv3d_f32.cu and
// csrc/conv3d_head.cu.

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
  } else {  // Cin not a multiple of 8: one element at a time
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

// The shape of a launch, or false if the kernel does not take it.
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

// x, w and y bf16 (dtype must be 1, the bfloat16 code; the f32 convs run
// csrc/conv3d_f32.cu), bias f32 or NULL. w is packed [27][Cout][Cin].
// Returns a cudaError_t.
int conv3d_ndhwc_launch(const void* x, const void* w, const float* bias,
                        void* y, int B, int D, int H, int W, int Cin, int Cout,
                        int TD, int TH, int TW, int dtype, void* stream_ptr) {
  Shape s;
  if (dtype != 1 || !make_shape(&s, B, D, H, W, Cin, Cout, TD, TH, TW))
    return static_cast<int>(cudaErrorInvalidValue);
  const int halo = (TD + 2) * (TH + 2) * (TW + 2);
  const int64_t tiles = static_cast<int64_t>(B) * s.nD * s.nH * s.nW;
  const bool vec = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(w) % 16 == 0 && Cin % 8 == 0;
  const dim3 grid(static_cast<unsigned>(tiles), (Cout + kBN - 1) / kBN);
  const size_t smem =
      (static_cast<size_t>(halo) + 2 * kBN) * kLds * sizeof(__nv_bfloat16);
  auto kernel = vec ? conv3d_bf16_kernel<true> : conv3d_bf16_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream_ptr)>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(w), bias,
      static_cast<__nv_bfloat16*>(y), s);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

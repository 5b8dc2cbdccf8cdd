// Stride-1 SAME 3x3x3 convolution in full f32 (FFMA, no TF32), channels-
// last, for Hopper (sm_90a), at the two narrow shapes of the model's f32
// convs:
//
//  * conv3d_head_kernel: Cout <= 8, the model's head conv [.., 128] -> 2;
//  * conv3d_f32_narrow_kernel: Cin = 2, the head's dx (dy [.., 2] -> 128)
//    and the input conv of an f32 model.
//
// Replaces the TPU kernel ddpm3d_tpu/ops/conv3d_mxu.py:_conv_kernel at these
// shapes (in the JAX package the f32 head and its gradient go through XLA,
// ops/conv3d_mxu.py:_xla_conv3d and its autodiff, since the Pallas kernel
// wants Cin and Cout multiples of 128). Same function:
//   y[b,d,h,w,co] = bias[co] + sum_{kd,kh,kw,ci} x[b,d+kd-1,h+kh-1,w+kw-1,ci]
//                                               * w[kd,kh,kw,ci,co]
// with zero padding, products and sums in f32, the f32 bias.
//
// Bound on the H100: operations, closely followed by bytes. At 96^3 both
// directions do 2 * 27 * 128 * 2 FLOP per voxel (12.2 GFLOP, 0.18 ms at the
// 67 TFLOP/s of f32 FFMA) and move 520 bytes per voxel (0.14 ms at 3.35
// TB/s): the forward reads them, the dx writes them. A GEMM tiling with N =
// 2 or K = 54 wastes most of its FFMAs on zero columns or zero channels, and
// restaging a halo per 128-row tile reads x 3-5 times over. So:
//
// conv3d_head_kernel (K = 27 * Cin into N = Cout <= 8):
//  1. The whole weight sits in shared memory for the block's life, packed
//     [Cin chunk][channel group of 4][tap][ci of 4][Cout padded to COP]
//     (ops/conv3d.py:pack_weight_head gives [Cin/4][27][4][Cout]; the block
//     pads it): one 16-byte broadcast load gives 4 / COP taps' worth of
//     (ci, co) pairs, and every lane of a warp reads the same address.
//  2. A block owns a 32 x TW window of (H, W) and walks a segment of D. It
//     stages one input plane at a time, (32+2) x (TW+2) voxels x a 16-channel
//     chunk (64 bytes of each voxel: a whole DRAM burst; 8-channel chunks
//     measured slower), double-buffered by 16-byte cp.async under the math
//     of the previous chunk (kHeadStages; a 3- or 4-chunk ring measured no
//     faster); the zero fill of cp.async is the H/W padding,
//     planes outside the volume are skipped (the D padding). Segments are
//     sized on the host (ops/conv3d.py:head_plan) so that the blocks fill
//     the card twice over in one wave.
//  3. Each input plane feeds three output planes (kd = 0, 1, 2), so each
//     thread keeps rolling accumulators for those three. When the last
//     chunk of plane p is done, output plane p - 1 (walking up; p + 1
//     walking down) is complete and is stored with the bias. No plane is
//     loaded twice by a block; contributions to output planes outside the
//     segment are skipped. Even segments walk up and odd ones down, so both
//     blocks that read the plane pair at a segment boundary read it at the
//     same end of their walk, while it sits in L2.
//  4. Register blocking: thread = one output row h (its lane) x R
//     consecutive outputs along W x COP channels. For each (4-channel group,
//     kh) it loads R + 2 float4 inputs and 9 * COP broadcast float4 weights
//     and does 3 * 3 * 4 * R * COP FFMAs (288 per 24 loads at COP = 2, R =
//     4; R = 8, a 32-wide window, measured slower). Halo rows are padded to
//     an odd number of 16-byte units, so the 8 lanes (8 rows) of a 128-bit
//     load wavefront hit 8 distinct bank groups.
//
// conv3d_f32_narrow_kernel (K = 54 into N = Cout):
//  1. The taps fold into K (k = 2 * tap + ci, ops/conv3d.py:
//     pack_weight_f32_narrow gives [Cout][54]): one [54][128] f32 weight
//     tile (27.6 KB) in shared memory per block, loaded once; the block (4
//     warps, three per SM) is persistent over 64-row tiles of the flattened
//     voxels.
//  2. A: each row's 27 neighbours are 8-byte (2-channel) voxels gathered
//     from device memory (x is 7 MB at 96^3 and stays in L2), zero outside
//     the volume, into a [54][64] tile in shared memory; two threads per
//     row, 7 loads in flight each.
//  3. Thread tile 8 rows x 8 columns (64 accumulators), fed per k by two
//     float4 A loads and two float4 weight loads: 64 FFMA per 4 loads.
//  4. The output is the byte cost (512 bytes per voxel at Cout = 128): each
//     thread stores 16-byte pieces straight from its registers, a warp
//     writing two whole 256-byte half-rows per instruction; written once.
//
// Both kernels sum each output in a fixed order that depends only on the
// volume's shape: a repeat gives the same bits, and a volume's result does
// not depend on the batch.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90_common.cuh"

namespace {

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem,
                                           bool pred) {
  const unsigned s = smem_addr(smem);
  const int n = pred ? 16 : 0;  // src-size 0 zero-fills the 16 bytes
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>  // at most N groups still in flight
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float lane_of(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// ----------------------------------------------------------------- head --

constexpr int kHeadThreads = 128;  // 4 warps: one W strip each
constexpr int kHeadTH = 32;        // window rows: one per lane
constexpr int kHeadCK = 16;        // Cin chunk of a staged plane
constexpr int kHeadStages = 2;     // staged chunks in the ring
constexpr int kHeadBlocks = 2;     // blocks per SM (__launch_bounds__)
constexpr int kHeadGroups = kHeadCK / 4;

template <int COP>
struct HeadCfg {
  static constexpr int R = COP <= 2 ? 4 : 8 / COP;  // outputs along W
  static constexpr int TW = (kHeadThreads / 32) * R;
  static constexpr int HW = TW + 2;                  // halo columns
  // floats per halo row: 4 (TW + 2) + 1 16-byte units, an odd number
  static constexpr int kPitch = HW * kHeadCK + 4;
  static constexpr int kBuf = (kHeadTH + 2) * kPitch;  // one plane buffer
  static constexpr int kChunkW = kHeadGroups * 27 * 4 * COP;  // weights
};

struct HeadShape {
  int D, H, W, Cin, Cout;
  int nC;            // Cin chunks
  int nH, nW, nseg;  // windows and D segments per volume
};

template <int COP>
__device__ __forceinline__ void stage_plane(const HeadShape& s,
                                            const float* __restrict__ x,
                                            float* buf, int b, int p, int c,
                                            int h0, int w0) {
  using C = HeadCfg<COP>;
  const int ci0 = c * kHeadCK;
  for (int i = threadIdx.x; i < (kHeadTH + 2) * C::HW * kHeadGroups;
       i += kHeadThreads) {
    const int part = i % kHeadGroups, v = i / kHeadGroups;
    const int col = v % C::HW, row = v / C::HW;
    const int h = h0 - 1 + row, w = w0 - 1 + col, ci = ci0 + part * 4;
    const bool ok = h >= 0 && h < s.H && w >= 0 && w < s.W && ci < s.Cin;
    const float* src =
        ok ? x + (((static_cast<int64_t>(b) * s.D + p) * s.H + h) * s.W + w) *
                         s.Cin + ci
           : x;
    cp_async16(buf + row * C::kPitch + col * kHeadCK + part * 4, src, ok);
  }
}

// One staged chunk into the accumulators of the slots in `on` (bit sl:
// slot sl's output plane lies in the segment). kdo[sl]: the weight offset
// of slot sl's kd.
template <int COP>
__device__ __forceinline__ void head_chunk(
    const float* buf, const float* wc, int lane, int wr, const int (&kdo)[3],
    unsigned on, float (&acc)[3][HeadCfg<COP>::R][COP]) {
  using C = HeadCfg<COP>;
  constexpr int R = C::R;
#pragma unroll
  for (int g = 0; g < kHeadGroups; ++g) {
#pragma unroll
    for (int kh = 0; kh < 3; ++kh) {
      const float* row = buf + (lane + kh) * C::kPitch + wr * kHeadCK + g * 4;
      float4 xin[R + 2];
#pragma unroll
      for (int j = 0; j < R + 2; ++j)
        xin[j] = *reinterpret_cast<const float4*>(row + j * kHeadCK);
      const float* wg = wc + (g * 27 + kh * 3) * 4 * COP;
#pragma unroll
      for (int sl = 0; sl < 3; ++sl) {
        if (!((on >> sl) & 1u)) continue;
#pragma unroll
        for (int kw = 0; kw < 3; ++kw) {
          const float4* wp =
              reinterpret_cast<const float4*>(wg + kdo[sl] + kw * 4 * COP);
          float wv[4 * COP];
#pragma unroll
          for (int q = 0; q < COP; ++q) {
            const float4 t = wp[q];
            wv[4 * q] = t.x;
            wv[4 * q + 1] = t.y;
            wv[4 * q + 2] = t.z;
            wv[4 * q + 3] = t.w;
          }
#pragma unroll
          for (int ci = 0; ci < 4; ++ci)
#pragma unroll
            for (int r = 0; r < R; ++r) {
              const float a = lane_of(xin[r + kw], ci);
#pragma unroll
              for (int co = 0; co < COP; ++co)
                acc[sl][r][co] = fmaf(a, wv[ci * COP + co], acc[sl][r][co]);
            }
        }
      }
    }
  }
}

template <int COP>
__global__ void __launch_bounds__(kHeadThreads, kHeadBlocks)
    conv3d_head_kernel(const float* __restrict__ x,
                       const float* __restrict__ w,
                       const float* __restrict__ bias, float* __restrict__ y,
                       const HeadShape s) {
  using C = HeadCfg<COP>;
  constexpr int R = C::R;
  extern __shared__ __align__(16) float smem[];
  float* sw = smem;
  float* ring = smem + s.nC * C::kChunkW;  // kHeadStages plane buffers

  // the weight, padded: [chunk][group][tap][ci][COP] from [Cin/4][27][4][Cout]
  for (int i = threadIdx.x; i < s.nC * C::kChunkW; i += kHeadThreads) {
    const int co = i % COP;
    int t = i / COP;
    const int ci = t % 4;
    t /= 4;
    const int tap = t % 27, grp = t / 27;  // grp: 4-channel group of Cin
    sw[i] = (grp * 4 + ci < s.Cin && co < s.Cout)
                ? w[((grp * 27 + tap) * 4 + ci) * s.Cout + co]
                : 0.f;
  }

  int q = blockIdx.x;
  const int iw = q % s.nW;
  q /= s.nW;
  const int ih = q % s.nH;
  q /= s.nH;
  const int seg = q % s.nseg, b = q / s.nseg;
  const int d0 = seg * s.D / s.nseg, d1 = (seg + 1) * s.D / s.nseg;
  const bool up = (seg & 1) == 0;
  const int h0 = ih * kHeadTH, w0 = iw * C::TW;
  const int lane = threadIdx.x & 31, wr = (threadIdx.x >> 5) * R;
  // slot sl holds output plane p - 1 + sl walking up, p + 1 - sl walking
  // down: kd = 2 - sl up, sl down
  int kdo[3];
#pragma unroll
  for (int sl = 0; sl < 3; ++sl) kdo[sl] = (up ? 2 - sl : sl) * 9 * 4 * COP;
  float bv[COP];
#pragma unroll
  for (int co = 0; co < COP; ++co)
    bv[co] = bias != nullptr && co < s.Cout ? bias[co] : 0.f;

  // staged items: the planes inside the volume, each in nC chunks
  const int lo = max(d0 - 1, 0), hi = min(d1, s.D - 1);
  const int items = (hi - lo + 1) * s.nC;
  auto plane_of = [&](int k) { return up ? lo + k / s.nC : hi - k / s.nC; };
#pragma unroll
  for (int i = 0; i < kHeadStages - 1; ++i) {
    if (i < items)
      stage_plane<COP>(s, x, ring + i * C::kBuf, b, plane_of(i), i % s.nC, h0,
                       w0);
    cp_async_commit();
  }

  float acc[3][R][COP];
#pragma unroll
  for (int sl = 0; sl < 3; ++sl)
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int co = 0; co < COP; ++co) acc[sl][r][co] = 0.f;

  const int h = h0 + lane;
  int k = 0;
  for (int st = 0; st < d1 - d0 + 2; ++st) {
    const int p = up ? d0 - 1 + st : d1 - st;
    if (p >= 0 && p < s.D) {
      unsigned on = 0;
#pragma unroll
      for (int sl = 0; sl < 3; ++sl) {
        const int out = up ? p - 1 + sl : p + 1 - sl;
        if (out >= d0 && out < d1) on |= 1u << sl;
      }
      for (int c = 0; c < s.nC; ++c, ++k) {
        cp_async_wait<kHeadStages - 2>();
        __syncthreads();  // item k landed; item k - 1's buffer is free
        const int nx = k + kHeadStages - 1;
        if (nx < items)
          stage_plane<COP>(s, x, ring + (nx % kHeadStages) * C::kBuf, b,
                           plane_of(nx), nx % s.nC, h0, w0);
        cp_async_commit();
        head_chunk<COP>(ring + (k % kHeadStages) * C::kBuf,
                        sw + c * C::kChunkW, lane, wr, kdo, on, acc);
      }
    }
    // slot 0's plane is complete
    const int out = up ? p - 1 : p + 1;
    if (out >= d0 && out < d1 && h < s.H) {
      float* yr = y + ((static_cast<int64_t>(b) * s.D + out) * s.H + h) *
                          s.W * s.Cout;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int wx = w0 + wr + r;
        if (wx >= s.W) continue;
#pragma unroll
        for (int co = 0; co < COP; ++co)
          if (co < s.Cout) yr[wx * s.Cout + co] = acc[0][r][co] + bv[co];
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int co = 0; co < COP; ++co) {
        acc[0][r][co] = acc[1][r][co];
        acc[1][r][co] = acc[2][r][co];
        acc[2][r][co] = 0.f;
      }
  }
}

template <int COP>
cudaError_t launch_head(const float* x, const float* w, const float* bias,
                        float* y, int B, const HeadShape& s0,
                        cudaStream_t stream) {
  using C = HeadCfg<COP>;
  HeadShape s = s0;
  s.nW = (s.W + C::TW - 1) / C::TW;
  const size_t smem =
      (static_cast<size_t>(s.nC) * C::kChunkW + kHeadStages * C::kBuf) *
      sizeof(float);
  if (smem > static_cast<size_t>(kSmemLimit)) return cudaErrorInvalidValue;
  const int64_t blocks = static_cast<int64_t>(B) * s.nseg * s.nH * s.nW;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      conv3d_head_kernel<COP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  conv3d_head_kernel<COP><<<static_cast<unsigned>(blocks), kHeadThreads, smem,
                            stream>>>(x, w, bias, y, s);
  return cudaGetLastError();
}

// --------------------------------------------------------------- narrow --

constexpr int kNThreads = 128;
constexpr int kNBlocks = 3;  // blocks per SM (__launch_bounds__)
constexpr int kNRows = kNThreads / 2;  // rows (voxels) per tile
constexpr int kNBatch = 7;   // gathered taps in flight per thread
constexpr int kNBN = 128;    // output channels per block
constexpr int kNK = 54;      // 27 taps x 2 channels
constexpr int kNTaps = 27;
constexpr int kNSmem = kNK * (kNBN + kNRows) * 4;  // weight and A tiles

struct NarrowShape {
  int D, H, W, Cout;
  int64_t M;  // voxels, B * D * H * W
  int tiles;  // ceil(M / kNRows)
};

__global__ void __launch_bounds__(kNThreads, kNBlocks)
    conv3d_f32_narrow_kernel(const float2* __restrict__ x,
                             const float* __restrict__ w,
                             const float* __restrict__ bias,
                             float* __restrict__ y, const NarrowShape s) {
  extern __shared__ __align__(16) float smem[];
  float* sW = smem;              // [k][n], n contiguous
  float* sA = smem + kNK * kNBN;  // [k][row], row contiguous
  const int n0 = blockIdx.y * kNBN;
  for (int i = threadIdx.x; i < kNK * kNBN; i += kNThreads) {
    const int k = i / kNBN, n = i % kNBN;
    sW[i] = n0 + n < s.Cout ? w[static_cast<int64_t>(n0 + n) * kNK + k] : 0.f;
  }
  // thread tile: rows 8 rg .. 8 rg + 7, columns 4 cg .. + 3 and 64 + 4 cg ..
  const int cg = threadIdx.x & 15, rg = threadIdx.x >> 4;
  float bv[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = n0 + (j < 4 ? 4 * cg + j : 64 + 4 * cg + j - 4);
    bv[j] = bias != nullptr && col < s.Cout ? bias[col] : 0.f;
  }
  static_assert(kNThreads == 2 * kNRows && kNRows == 8 * (kNThreads / 16),
                "two threads gather each row; 16 x 8 columns per row group");
  const int grow = threadIdx.x % kNRows, half = threadIdx.x / kNRows;
  const int64_t plane = static_cast<int64_t>(s.H) * s.W;
  const bool vec = (s.Cout & 3) == 0;

  for (int tile = blockIdx.x; tile < s.tiles; tile += gridDim.x) {
    __syncthreads();  // the previous tile's A is read (and sW is written)
    // gather row grow's taps half, half + 2, ... as (ci 0, ci 1) pairs
    const int64_t m = static_cast<int64_t>(tile) * kNRows + grow;
    unsigned vd = 0, vh = 0, vw = 0;  // bit k: offset k - 1 stays inside
    if (m < s.M) {
      const int wx = static_cast<int>(m % s.W);
      const int hy = static_cast<int>((m / s.W) % s.H);
      const int dz = static_cast<int>((m / plane) % s.D);
      vd = 2u | (dz > 0 ? 1u : 0u) | (dz + 1 < s.D ? 4u : 0u);
      vh = 2u | (hy > 0 ? 1u : 0u) | (hy + 1 < s.H ? 4u : 0u);
      vw = 2u | (wx > 0 ? 1u : 0u) | (wx + 1 < s.W ? 4u : 0u);
    }
    // the thread's 14 taps in two batches of 7 loads in flight
#pragma unroll
    for (int j0 = 0; j0 < 14; j0 += kNBatch) {
      float2 v[kNBatch];
#pragma unroll
      for (int j = 0; j < kNBatch; ++j) {
        const int t = half + 2 * (j0 + j);
        const int kd = t / 9, kh = (t / 3) % 3, kw = t % 3;
        v[j] = make_float2(0.f, 0.f);
        if (t < kNTaps && ((vd >> kd) & (vh >> kh) & (vw >> kw) & 1u))
          v[j] = __ldg(x + m + (kd - 1) * plane + (kh - 1) * s.W + (kw - 1));
      }
#pragma unroll
      for (int j = 0; j < kNBatch; ++j) {
        const int t = half + 2 * (j0 + j);
        if (t < kNTaps) {
          sA[(2 * t) * kNRows + grow] = v[j].x;
          sA[(2 * t + 1) * kNRows + grow] = v[j].y;
        }
      }
    }
    __syncthreads();

    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
#pragma unroll 6
    for (int k = 0; k < kNK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(sA + k * kNRows + 8 * rg);
      const float4 a1 =
          *reinterpret_cast<const float4*>(sA + k * kNRows + 8 * rg + 4);
      const float4 b0 = *reinterpret_cast<const float4*>(sW + k * kNBN + 4 * cg);
      const float4 b1 =
          *reinterpret_cast<const float4*>(sW + k * kNBN + 64 + 4 * cg);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bb[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], bb[j], acc[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int64_t mr = static_cast<int64_t>(tile) * kNRows + 8 * rg + i;
      if (mr >= s.M) continue;
      float* yr = y + mr * s.Cout;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int col = n0 + 64 * hf + 4 * cg;
        const float4 v = make_float4(
            acc[i][4 * hf] + bv[4 * hf], acc[i][4 * hf + 1] + bv[4 * hf + 1],
            acc[i][4 * hf + 2] + bv[4 * hf + 2],
            acc[i][4 * hf + 3] + bv[4 * hf + 3]);
        if (vec && col + 4 <= s.Cout) {
          *reinterpret_cast<float4*>(yr + col) = v;
        } else {
          const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (col + j < s.Cout) yr[col + j] = e[j];
        }
      }
    }
  }
}

}  // namespace

extern "C" {

// x [B, D, H, W, Cin] f32 (16-byte aligned, Cin % 4 == 0), w packed
// [Cin/4][27][4][Cout] f32, bias f32 [Cout] or NULL, y [B, D, H, W, Cout]
// f32 with 1 <= Cout <= 8. nseg: D segments per volume (1..D), each walked
// by one block per (H, W) window. Returns a cudaError_t.
int conv3d_head_launch(const void* x, const void* w, const float* bias,
                       void* y, int B, int D, int H, int W, int Cin, int Cout,
                       int nseg, void* stream_ptr) {
  if (B <= 0 || D <= 0 || H <= 0 || W <= 0 || Cin <= 0 || Cin % 4 != 0 ||
      Cout < 1 || Cout > 8 || nseg < 1 || nseg > D ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(w) % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  HeadShape s;
  s.D = D; s.H = H; s.W = W; s.Cin = Cin; s.Cout = Cout;
  s.nC = (Cin + kHeadCK - 1) / kHeadCK;
  s.nH = (H + kHeadTH - 1) / kHeadTH;
  s.nW = 0;  // set per instance (TW)
  s.nseg = nseg;
  const float* xf = static_cast<const float*>(x);
  const float* wf = static_cast<const float*>(w);
  float* yf = static_cast<float*>(y);
  cudaStream_t st = static_cast<cudaStream_t>(stream_ptr);
  cudaError_t err;
  if (Cout <= 1)
    err = launch_head<1>(xf, wf, bias, yf, B, s, st);
  else if (Cout <= 2)
    err = launch_head<2>(xf, wf, bias, yf, B, s, st);
  else if (Cout <= 4)
    err = launch_head<4>(xf, wf, bias, yf, B, s, st);
  else
    err = launch_head<8>(xf, wf, bias, yf, B, s, st);
  return static_cast<int>(err);
}

// x [B, D, H, W, 2] f32 (8-byte aligned), w packed [Cout][54] f32 (k = 2 *
// tap + ci), bias f32 [Cout] or NULL, y [B, D, H, W, Cout] f32 (16-byte
// aligned). Returns a cudaError_t.
int conv3d_f32_narrow_launch(const void* x, const void* w, const float* bias,
                             void* y, int B, int D, int H, int W, int Cout,
                             void* stream_ptr) {
  if (B <= 0 || D <= 0 || H <= 0 || W <= 0 || Cout <= 0 ||
      reinterpret_cast<uintptr_t>(x) % 8 != 0 ||
      reinterpret_cast<uintptr_t>(w) % 4 != 0 ||
      reinterpret_cast<uintptr_t>(y) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  NarrowShape s;
  s.D = D; s.H = H; s.W = W; s.Cout = Cout;
  s.M = static_cast<int64_t>(B) * D * H * W;
  const int64_t tiles = (s.M + kNRows - 1) / kNRows;
  if (tiles > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  s.tiles = static_cast<int>(tiles);
  cudaError_t err = cudaFuncSetAttribute(
      conv3d_f32_narrow_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kNSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, conv3d_f32_narrow_kernel, kNThreads, kNSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int sms = sm_count(&err);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t fill = static_cast<int64_t>(sms) * (per_sm > 0 ? per_sm : 1);
  const dim3 grid(static_cast<unsigned>(s.tiles < fill ? s.tiles : fill),
                  (Cout + kNBN - 1) / kNBN);
  conv3d_f32_narrow_kernel<<<grid, kNThreads, kNSmem,
                             static_cast<cudaStream_t>(stream_ptr)>>>(
      static_cast<const float2*>(x), static_cast<const float*>(w), bias,
      static_cast<float*>(y), s);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

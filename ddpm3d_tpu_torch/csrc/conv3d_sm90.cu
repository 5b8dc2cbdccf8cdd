// Stride-1 SAME 3x3x3 convolution in bf16, channels-last (NDHWC
// activations), for Hopper (sm_90a): wgmma fed by TMA.
//
// Replaces the TPU kernel ddpm3d_tpu/ops/conv3d_mxu.py:_conv_kernel, both
// where conv3d_mxu calls it (the forward) and where _conv3d_mxu_bwd calls it
// on dy with the flipped, in/out-swapped weight (the dx). Same function:
//
//   y[b,d,h,w,co] = bias[co] + sum_{kd,kh,kw,ci} x[b,d+kd-1,h+kh-1,w+kw-1,ci]
//                                               * w[kd,kh,kw,ci,co]
//
// zero padding, bf16 products summed in f32, bias added in f32, rounded once
// to bf16. Weights come packed [27][Cout][Cin] (ops/conv3d.py:pack_weight,
// the layout the fused conv shares). Takes bf16 with Cin % 8 == 0 (TMA needs
// 16-byte global strides); f32 and narrow Cin stay on csrc/conv3d.cu.
//
// Bound on the H100: operations. The conv does 54*Cin*Cout FLOP per voxel
// and moves (Cin+Cout)*2 bytes per voxel, ~3500 FLOP/byte at 128 -> 128
// against the card's ~295 FLOP/byte ridge. The previous kernel (mma.sync,
// csrc/conv3d.cu) reached ~24 % of the bf16 peak; what this design does:
//
//  1. wgmma.mma_async m64n128k16 bf16 -> f32 (the only way to the full
//     tensor-core rate), A from registers ("RS"). Each warp gathers its 16
//     rows of A with ldmatrix, one row address per lane, so one staged halo
//     serves all 27 shifted taps for any tile shape (ragged W = 12 and W = 6
//     planes still fill the rows). A warp's 16-row slice of wgmma's A has
//     mma.sync m16n8k16's A fragment layout (PTX ISA, "Register fragments,
//     wgmma .m64nNk16"), which ldmatrix.x4 yields. The smem-descriptor form
//     of A would need every 8-row core matrix to be 8 consecutive halo
//     voxels at one stride, which holds only for TW = 8 tiles.
//     N = 128 always: a 256-row tile at N = 256 would need 256 f32
//     accumulators per thread. The weight bytes fetched per output row
//     depend on the rows per tile, not on N (below).
//  2. Weights by TMA into a ring of kStages = 4 stages of [128 rows][64 ch],
//     128-byte swizzled, read by wgmma as B through a shared-memory matrix
//     descriptor (K-major, SBO 1024). The map is 3-D (Cin, Cout, 27), box
//     (64, 128, 1): columns past Cout and channels past Cin come in as 0.
//     Full/empty mbarrier pairs replace the old kernel's two __syncthreads
//     per tap. The K chunk is 64 channels: one 128-byte swizzle row.
//  3. The halo by TMA: one cp.async.bulk.tensor.5d per (tile, Cin chunk),
//     map (C, W, H, D, B), box (64, TW+2, TH+2, TD+2, 1) at (c0, w0-1, h0-1,
//     d0-1, b). TMA zero-fills what falls outside the tensor, negative
//     coordinates included: that is the SAME padding and ragged Cin, so no
//     per-voxel index math or predicate is left. The halo is double-buffered:
//     chunk c+1 (of this tile or the next) lands under chunk c's 27 taps.
//     With the 128-byte swizzle, 16-byte piece j of halo voxel v sits at
//     v*128 + ((j ^ (v & 7)) * 16); ldmatrix addresses apply it, and
//     consecutive voxels fall in distinct banks. Buffers are 1024-aligned.
//  4. 256 output rows per tile (two consumer warpgroups of 128 rows, e.g.
//     TD x TH x TW = 8 x 4 x 8 with a 600-voxel halo, 76.8 KB per stage).
//     L2 -> SM weight bytes per conv = (voxels / rows per tile) * 27 * Cin *
//     Cout * 2: at [1,96^3,128] -> 128 the old 128-row blocks moved 6.1 GB,
//     these tiles 3.06 GB (the halo adds 0.53 GB). Where 256-row tiles
//     would leave most SMs idle (the 96 x 6^2 level: 14 tiles per column
//     tile) the host picks a tile of at most 128 rows, which runs the kMT =
//     1 instance (one m64 tile per warpgroup; ops/conv3d.py:sm90_tile).
//  5. Warp specialisation: warpgroup 0 is the producer (setmaxnreg down to
//     40; one thread issues every TMA), warpgroups 1 and 2 the consumers
//     (setmaxnreg up to 232): ldmatrix, wgmma with fence / commit_group /
//     wait_group (two A buffers, one wgmma group in flight while the next
//     is gathered), and the epilogue (f32 bias, one bf16 rounding; the
//     output tile is staged in the last chunk's halo stage and written in
//     16-byte pieces, two whole rows per warp, masked to the volume, the
//     tile and Cout: on an H100 11 % faster at 96^3 than 4-byte stores from
//     the fragments). The grid is persistent (one block per SM walking the
//     tiles), so a tile's epilogue overlaps the next tile's loads.
//  6. Host side in C: the tensor maps are encoded per launch with
//     cuTensorMapEncodeTiled, reached through the runtime's driver entry
//     point (the library links only the CUDA runtime), and passed as
//     __grid_constant__ CUtensorMap. A map that cannot be encoded, or a
//     shape the kernel does not take, is an error returned to the caller.
//     ptxas allots the consumers 168 registers whatever setmaxnreg asks at
//     run time (a 40-byte spill showed it), so the consumers are written to
//     fit 168: two A buffers, and an epilogue that loads the bias per
//     column pair.

#include <cuda_bf16.h>

#include "sm90_common.cuh"

namespace {

constexpr int kBN = 128;                  // output channels per tile (N)
constexpr int kBK = 64;                   // Cin chunk: one 128-byte row
constexpr int kRowBytes = kBK * 2;        // bytes per voxel per chunk
constexpr int kStages = 4;                // weight ring
constexpr int kConsumers = 2;             // consumer warpgroups
constexpr int kThreads = 128 * (1 + kConsumers);
constexpr int kMaxRows = 128 * kConsumers;  // output voxels per tile
constexpr int kMaxHalo = 640;             // (TD+2)(TH+2)(TW+2), at most
constexpr int kTaps = 27;
constexpr int kWBytes = kBN * kRowBytes;  // one weight stage, 16 KB
constexpr int kLaunchRegs = 168;          // 65536 / 384, as ptxas allots
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;        // 128*40 + 256*232 = 384*168
static_assert(128 * kProducerRegs + 128 * kConsumers * kConsumerRegs <=
                  kThreads * kLaunchRegs,
              "setmaxnreg must not ask for more registers than launch gave");
struct Shape {
  int B, D, H, W, Cin, Cout;
  int TD, TH, TW;
  int nD, nH, nW;
  int tiles;       // spatial tiles, B * nD * nH * nW
  int total;       // tiles * column tiles
  int chunks;      // Cin chunks of kBK
  int halo_tx;     // bytes one halo load writes
  int halo_bytes;  // one halo stage, rounded up to 1024
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

// ------------------------------------------------------------ PTX shims --

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma boundary (they are registers, not memory).
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

// ------------------------------------------------------------- kernel --

// Shared-memory addresses: two halo stages, kStages weight stages (all
// 1024-aligned), the barriers, then the row table: output row r of a tile
// at (dz, hy, wx) as dz | hy << 8 | wx << 16, so that the epilogue needs no
// integer division. Stage i is base + i * stride, so a stage picked at run
// time needs no indexed array (no local memory).
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
    return bars + 8 * (2 + i);
  }
  __device__ __forceinline__ uint32_t wfull(int i) const {
    return bars + 8 * (4 + i);
  }
  __device__ __forceinline__ uint32_t wempty(int i) const {
    return bars + 8 * (4 + kStages + i);
  }
};

__device__ __forceinline__ Smem carve(const Shape& s, unsigned char* raw) {
  Smem m;
  m.halo_bytes = s.halo_bytes;
  m.halo = (smem_addr(raw) + 1023u) & ~1023u;
  m.w = m.halo + 2 * s.halo_bytes;
  m.bars = m.w + kStages * kWBytes;
  m.rowtab = m.bars + 8 * (4 + 2 * kStages);
  return m;
}

// The producer's halo load number n (per block): (tile q, chunk c).
__device__ __forceinline__ void load_halo(const Shape& s, const Smem& m,
                                          const CUtensorMap* tm_x, int n,
                                          int q, int c) {
  const int st = n & 1;
  mbar_wait(m.hempty(st), ((n >> 1) & 1) ^ 1);
  const TileId t = decode_tile(s, q);
  mbar_expect_tx(m.hfull(st), s.halo_tx);
  tma_load_5d(m.halo_at(st), tm_x, m.hfull(st), c * kBK, t.w0 - 1, t.h0 - 1,
              t.d0 - 1, t.b);
}

// Halo-relative voxel of output row r at tap offset 0 (idle rows read
// voxel 0: valid shared memory, never stored).
__device__ __forceinline__ int row_base(const Shape& s, int r) {
  if (r >= s.TD * s.TH * s.TW) return 0;
  const int dz = r / (s.TH * s.TW);
  const int hy = (r / s.TW) % s.TH;
  const int wx = r % s.TW;
  return (dz * (s.TH + 2) + hy) * (s.TW + 2) + wx;
}

// kMT m64 tiles per consumer warpgroup: 2 gives 256-row tiles, 1 gives
// 128-row tiles (small volumes, where 256-row tiles leave SMs idle).
template <int kMT>
__global__ void __launch_bounds__(kThreads, 1)
    conv3d_sm90_kernel(const __grid_constant__ CUtensorMap tm_x,
                       const __grid_constant__ CUtensorMap tm_w,
                       const float* __restrict__ bias,
                       __nv_bfloat16* __restrict__ y, const Shape s) {
  extern __shared__ unsigned char smem_raw[];
  const Smem m = carve(s, smem_raw);
  const int wg = threadIdx.x >> 7;
  const int lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
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
    int nh = 0, nw = 0;
    if (static_cast<int>(blockIdx.x) < s.total)
      load_halo(s, m, &tm_x, nh++, blockIdx.x, 0);
    for (int q = blockIdx.x; q < s.total; q += gridDim.x) {
      const TileId t = decode_tile(s, q);
      for (int c = 0; c < s.chunks; ++c) {
        // the next (tile, chunk) job, whose halo goes in under this one
        int nq = q, nc = c + 1;
        if (nc == s.chunks) {
          nc = 0;
          nq += gridDim.x;
        }
        for (int tap = 0; tap < kTaps; ++tap) {
          // the previous chunk's halo stage is free by now: its last taps'
          // weights were released, and a tile's last chunk releases its
          // stage after the epilogue, before this chunk's tap kStages
          if (tap == 2 * kStages && nq < s.total)
            load_halo(s, m, &tm_x, nh++, nq, nc);
          const int st = nw % kStages;
          mbar_wait(m.wempty(st), ((nw / kStages) & 1) ^ 1);
          mbar_expect_tx(m.wfull(st), kWBytes);
          tma_load_3d(m.w_at(st), &tm_w, m.wfull(st), c * kBK, t.n0, tap);
          ++nw;
        }
      }
    }
    return;
  }

  // ------------------------------------------------------ consumers --
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int cwg = wg - 1;
  const int wq = (threadIdx.x >> 5) & 3;
  const int hi = lane >> 4;  // ldmatrix: lanes 16-31 give k 8..15
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

  float acc[kMT][64];
  unsigned a[2][kMT][4];  // [buffer][m-tile][fragment]
  int nh = 0, nw = 0;
  int pending = -1;  // weight stage whose wgmma may still be in flight
  const int HH = s.TH + 2, HW = s.TW + 2;

  for (int q = blockIdx.x; q < s.total; q += gridDim.x) {
#pragma unroll
    for (int mi = 0; mi < kMT; ++mi) {
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[mi][i] = 0.f;
      fence_acc(acc[mi]);
    }
    for (int c = 0; c < s.chunks; ++c) {
      const int hs = nh & 1;
      mbar_wait(m.hfull(hs), (nh >> 1) & 1);
      for (int tap = 0; tap < kTaps; ++tap) {
        const int ws = nw % kStages;
        mbar_wait(m.wfull(ws), (nw / kStages) & 1);
        const int kd = tap / 9, kh = (tap / 3) % 3, kw = tap % 3;
        const int toff = (kd * HH + kh) * HW + kw;
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
        for (int ks = 0; ks < kBK / 16; ++ks) {
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
            wgmma_m64n128k16_rs(acc[mi], a[ks & 1][mi], db + 2 * ks);
          wgmma_commit();
        }
        pending = ws;
        if (tap == kTaps - 1 && c + 1 < s.chunks) {
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

    // epilogue: + bias (f32), round once to bf16, into the last chunk's
    // halo stage (free once both warpgroups are past their last ldmatrix;
    // 2 * rows * 128 bytes <= halo * 128 bytes for every tile), 256 bytes
    // per output row with 16-byte piece j at j ^ (row & 7) (conflict-free
    // for the fragment layout); then each warpgroup writes its rows to
    // device memory in 16-byte pieces, a warp covering two whole rows.
    const uint32_t stage = m.halo_at((nh - 1) & 1);
    const TileId t = decode_tile(s, q);
    const int g = lane >> 2, tq = lane & 3;
    const int rows = s.TD * s.TH * s.TW;
    named_barrier(1, 128 * kConsumers);
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      const int col = t.n0 + j * 8 + tq * 2;
      const float b0 = bias != nullptr && col < s.Cout ? bias[col] : 0.f;
      const float b1 = bias != nullptr && col + 1 < s.Cout ? bias[col + 1] : 0.f;
#pragma unroll
      for (int mi = 0; mi < kMT; ++mi) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = (cwg * kMT + mi) * 64 + wq * 16 + g + 8 * h;
          if (r >= rows) continue;  // only the tile's rows fit the stage
          const __nv_bfloat162 v = __floats2bfloat162_rn(
              acc[mi][4 * j + 2 * h] + b0, acc[mi][4 * j + 2 * h + 1] + b1);
          const uint32_t addr = stage + r * 2 * kBN +
                                ((j ^ (r & 7)) << 4) + tq * 4;
          asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr),
                       "r"(*reinterpret_cast<const uint32_t*>(&v))
                       : "memory");
        }
      }
    }
    named_barrier(2 + cwg, 128);  // this warpgroup's rows are staged
    const int piece = lane & 15;  // 16-byte piece of the row: 8 columns
    const int col = t.n0 + piece * 8;
    // all 8 columns in range, and 16-byte aligned rows in device memory
    const bool whole = col + 8 <= s.Cout && (s.Cout & 7) == 0;
#pragma unroll
    for (int i = 0; i < 8 * kMT; ++i) {
      const int r = cwg * kMT * 64 + i * 8 + wq * 2 + (lane >> 4);
      if (r >= rows || col >= s.Cout) continue;
      uint32_t code;
      asm volatile("ld.shared.u32 %0, [%1];\n"
                   : "=r"(code)
                   : "r"(m.rowtab + 4 * r)
                   : "memory");
      const int d = t.d0 + (code & 255);
      const int hh = t.h0 + ((code >> 8) & 255);
      const int ww = t.w0 + (code >> 16);
      if (d >= s.D || hh >= s.H || ww >= s.W) continue;
      uint4 v;
      asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
                   : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
                   : "r"(stage + r * 2 * kBN + ((piece ^ (r & 7)) << 4))
                   : "memory");
      __nv_bfloat16* p =
          y + (((static_cast<int64_t>(t.b) * s.D + d) * s.H + hh) * s.W + ww) *
                  s.Cout + col;
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
    // order this thread's generic accesses to the stage before the TMA
    // that refills it, then release it
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncwarp();
    if (lane == 0) mbar_arrive(m.hempty((nh - 1) & 1));
  }
}

// ---------------------------------------------------------------- host --

// One launch of the kMT instance. setmaxnreg hands registers between the
// warpgroups of a block: launch must have given every thread kLaunchRegs,
// or the consumers' request would wait for registers that never come.
template <int kMT>
cudaError_t launch(const CUtensorMap& tm_x, const CUtensorMap& tm_w,
                   const float* bias, void* y, const Shape& s, size_t smem,
                   int grid, cudaStream_t stream) {
  static int regs = -1;
  if (regs < 0) {
    cudaFuncAttributes attr;
    const cudaError_t err =
        cudaFuncGetAttributes(&attr, conv3d_sm90_kernel<kMT>);
    if (err != cudaSuccess) return err;
    regs = attr.numRegs;
  }
  if (regs != kLaunchRegs) return cudaErrorInvalidConfiguration;
  const cudaError_t err = cudaFuncSetAttribute(
      conv3d_sm90_kernel<kMT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  conv3d_sm90_kernel<kMT><<<grid, kThreads, smem, stream>>>(
      tm_x, tm_w, bias, static_cast<__nv_bfloat16*>(y), s);
  return cudaGetLastError();
}

size_t smem_bytes(const Shape& s) {
  return 1024 + 2 * static_cast<size_t>(s.halo_bytes) +
         static_cast<size_t>(kStages) * kWBytes + 8 * (4 + 2 * kStages) +
         4 * kMaxRows;
}

}  // namespace

extern "C" {

// x [B, D, H, W, Cin] and y [B, D, H, W, Cout] bf16, w packed
// [27][Cout][Cin] bf16, bias f32 [Cout] or NULL; output tile TD x TH x TW
// (ops/conv3d.py:pick_tile_sm90). x and w must be 16-byte aligned and Cin a
// multiple of 8. Returns a cudaError_t.
int conv3d_sm90_launch(const void* x, const void* w, const float* bias,
                       void* y, int B, int D, int H, int W, int Cin, int Cout,
                       int TD, int TH, int TW, void* stream_ptr) {
  if (B <= 0 || D <= 0 || H <= 0 || W <= 0 || Cin <= 0 || Cout <= 0 ||
      Cin % 8 != 0 || TD <= 0 || TH <= 0 || TW <= 0 || TD > 255 ||
      TH > 255 || TW > 255 ||
      TD * TH * TW > kMaxRows || (TD + 2) * (TH + 2) * (TW + 2) > kMaxHalo ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(w) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Shape s;
  s.B = B; s.D = D; s.H = H; s.W = W; s.Cin = Cin; s.Cout = Cout;
  s.TD = TD; s.TH = TH; s.TW = TW;
  s.nD = (D + TD - 1) / TD;
  s.nH = (H + TH - 1) / TH;
  s.nW = (W + TW - 1) / TW;
  const int64_t tiles = static_cast<int64_t>(B) * s.nD * s.nH * s.nW;
  const int64_t total = tiles * ((Cout + kBN - 1) / kBN);
  if (total > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  s.tiles = static_cast<int>(tiles);
  s.total = static_cast<int>(total);
  s.chunks = (Cin + kBK - 1) / kBK;
  s.halo_tx = (TD + 2) * (TH + 2) * (TW + 2) * kRowBytes;
  s.halo_bytes = (s.halo_tx + 1023) / 1024 * 1024;
  const size_t smem = smem_bytes(s);
  if (smem > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);

  CUtensorMap tm_x, tm_w;
  const cuuint64_t xd[5] = {static_cast<cuuint64_t>(Cin),
                            static_cast<cuuint64_t>(W),
                            static_cast<cuuint64_t>(H),
                            static_cast<cuuint64_t>(D),
                            static_cast<cuuint64_t>(B)};
  const cuuint64_t xs[4] = {xd[0] * 2, xd[0] * xd[1] * 2,
                            xd[0] * xd[1] * xd[2] * 2,
                            xd[0] * xd[1] * xd[2] * xd[3] * 2};
  const cuuint32_t xb[5] = {kBK, static_cast<cuuint32_t>(TW + 2),
                            static_cast<cuuint32_t>(TH + 2),
                            static_cast<cuuint32_t>(TD + 2), 1};
  const cuuint64_t wd[3] = {static_cast<cuuint64_t>(Cin),
                            static_cast<cuuint64_t>(Cout), kTaps};
  const cuuint64_t ws[2] = {wd[0] * 2, wd[0] * wd[1] * 2};
  const cuuint32_t wb[3] = {kBK, kBN, 1};
  if (!encode_map(&tm_x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, 5, xd, xs, xb) ||
      !encode_map(&tm_w, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, w, 3, wd, ws, wb))
    return static_cast<int>(cudaErrorInvalidValue);

  cudaError_t err;
  const int sms = sm_count(&err);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = s.total < sms ? s.total : sms;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  err = TD * TH * TW <= kMaxRows / 2
            ? launch<1>(tm_x, tm_w, bias, y, s, smem, grid, stream)
            : launch<2>(tm_x, tm_w, bias, y, s, smem, grid, stream);
  return static_cast<int>(err);
}

}  // extern "C"

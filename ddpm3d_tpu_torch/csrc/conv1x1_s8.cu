// int8 (W8A8) 1x1x1 convolution, channels-last (NDHWC), with the dequantize
// epilogue, for Hopper (sm_90a): a streaming s8 GEMM, wgmma fed by TMA.
//
// Replaces no TPU kernel: the JAX package computes its 1x1x1 int8 sites
// with XLA (ddpm3d_tpu/ops/conv3d_s8.py:85, conv3d_s8_applicable refuses
// 1x1x1 kernels: "a plain matmul, XLA is optimal"; ops/quant.py:
// conv3d_folded_int8's concat / native lowering). It serves every 1x1x1
// int8 site of the port (the ResBlock skips, the Seg models' conv_down and
// fuse sites, midcat's middle skip) through ops/conv3d_s8.py:
// conv3d_s8_kernel. A torch._int_mm and a dequantize pass would write and
// read back int32 (about 3x the bytes of this kernel's bf16 output), so
// the product and the epilogue are one kernel. Same function as
// conv3d_s8_plain with k = 1:
//
//   acc[r, n] = sum_c xq[r, c] * wq[n, c]                 s8 x s8 -> s32
//   y[r, n]   = float(acc) * (sx[b(r)] * sw[n]) + bias[n]  f32, no FMA
//
// over the M = B * D * H * W rows of x, b(r) = r / (D * H * W), rounded
// once to bf16 or f32. The sums are exact (|acc| <= 127^2 * Cin < 2^31 up
// to Cin ~ 1.3e5), the multiply and the add are rounded separately
// (__fmul_rn / __fadd_rn; chip_smoke.py checks the SASS for FFMA): the
// kernel equals its plain version bit for bit.
//
// Bound on the H100: bytes. A row costs 2 * Cin * N operations against
// Cin + N * 2 bytes (bf16 out): 128 op/byte at Cin 256 -> 128, far below
// the card's ~590 int8 op/byte ridge. So the design keeps the loads and
// the stores streaming and does nothing else:
//  1. Rows, not boxes. x is one 2-D tensor map [M, Cin], y one [M, N]. A
//     tile is 128 consecutive rows (kRows): no 3-D tile, no halo, no ragged
//     boxes at the volume's edges, only TMA's clip of the last rows (zero
//     fill on load, clipped on store). A tile may straddle two samples:
//     the epilogue reads sx per row.
//  2. Weights resident. Block b owns the 128-column tile b % nt of N and
//     walks the row tiles b / nt, + bpc, ... (persistent: nt * bpc <= SMs
//     blocks). It loads its tile's [128 cols][Cin] s8 slab into shared
//     memory once (chunks of 128 channels, 16 KB each). The slab stays
//     resident where it fits beside kMinStages A stages and the output
//     buffers: Cin <= 768 (a 96 KB slab). At Cin 1024 (128 KB) it does not,
//     and each stage carries its chunk's weights beside its rows
//     (streamed, 32 KB stages); the host plans which (conv1x1_s8_launch).
//  3. A ring of 4 to 8 A stages (as many as shared memory holds) of [128
//     rows][128 ch], 128-byte swizzled, fed by one producer thread (TMA
//     2-D loads, full/empty mbarriers). TMA zero-fills channels past Cin
//     (a ragged last chunk) and rows past M.
//  4. Two consumer warpgroups, 64 rows each, run wgmma m64n128k32 s8 in SS
//     form: A and B both from shared-memory descriptors (there is no halo
//     to shift, so nothing for ldmatrix to gather). One wgmma group stays
//     in flight; a stage is released when the group that read it is done.
//  5. The epilogue does not stall the loads: it dequantizes in the order
//     above and stages each warpgroup's rows in a ring of its own (four
//     8 KB pass buffers: 64 rows x 128 bytes, TMA's box, 128-byte swizzle;
//     bf16 takes two passes a tile, so two tiles' stores stay in flight,
//     f32 four), never in an A stage. The warpgroup's first thread stores
//     the passes by TMA tensor stores, one bulk group per tile, and waits
//     only when a buffer comes round again, while the producer keeps
//     loading the next tiles. Where y's rows are not 16-byte strided (N *
//     sizeof(out) % 16 != 0, never the model's) the threads store each
//     element from the fragments. Both warpgroups run their tile's wgmma
//     together and then their epilogues, so the epilogue's issue time adds
//     to the tile's: the thread's 32 column scales and biases are loaded
//     once, not per tile, and the bf16 rounding is packed two columns at a
//     time.
//  6. Guards, as K5's: the launch refuses a build whose register count would
//     make setmaxnreg wait (it must be the launch bound's 168), and every
//     mbarrier wait traps after ~8 s instead of hanging the card.

#include <cuda_bf16.h>

#include "sm90_common.cuh"

namespace {

constexpr int kRows = 128;                 // rows per tile
constexpr int kBN = 128;                   // columns per tile
constexpr int kBK = 128;                   // channels per chunk: 128 bytes
constexpr int kChunkBytes = kRows * kBK;   // an A chunk (= a weight chunk)
constexpr int kConsumers = 2;              // consumer warpgroups, 64 rows each
constexpr int kThreads = 128 * (1 + kConsumers);
constexpr int kMinStages = 4;
constexpr int kMaxStages = 8;
constexpr int kOutBufs = 4;                // pass buffers per warpgroup
constexpr int kPassBytes = 64 * 128;       // 64 rows x 128 bytes
constexpr int kOutBytes = kConsumers * kOutBufs * kPassBytes;
constexpr int kBars = 2 * kMaxStages + 1;  // full, empty, slab
constexpr int kLaunchRegs = 168;           // 65536 / 384, as ptxas allots
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;         // 128*40 + 256*232 = 384*168
static_assert(128 * kProducerRegs + 128 * kConsumers * kConsumerRegs <=
                  kThreads * kLaunchRegs,
              "setmaxnreg must not ask for more registers than launch gave");

struct Shape {
  int M;       // rows, B * V
  int V;       // rows per sample (D * H * W)
  int B, Cin, N;
  int chunks;  // Cin chunks of kBK
  int nt;      // column tiles
  int mt;      // row tiles
  int bpc;     // blocks per column tile (the row-tile stride)
  int stages;  // A stages in the ring
  int resident;     // 1: the weight slab is loaded once
  int stage_bytes;  // kChunkBytes, or 2 * kChunkBytes when streamed
  int ring_off, out_off, bar_off;  // from the 1024-aligned base
  int tma_out;      // 1: the epilogue stores by TMA
};

// ------------------------------------------------------------ PTX shims --

__device__ __forceinline__ void fence_acc(int (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

#define ACC8(o)                                                      \
  "+r"(d[o + 0]), "+r"(d[o + 1]), "+r"(d[o + 2]), "+r"(d[o + 3]),    \
      "+r"(d[o + 4]), "+r"(d[o + 5]), "+r"(d[o + 6]), "+r"(d[o + 7])

// d[64] (+)= A (64x32 s8, smem descriptor) * B (32x128 s8, smem
// descriptor), s32; accumulate = 0 overwrites d
__device__ __forceinline__ void wgmma_m64n128k32_s8_ss(int (&d)[64],
                                                       uint64_t desc_a,
                                                       uint64_t desc_b,
                                                       int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n"
      "}\n"
      : ACC8(0), ACC8(8), ACC8(16), ACC8(24), ACC8(32), ACC8(40), ACC8(48),
        ACC8(56)
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}
#undef ACC8

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* m,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(m)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_store_2d(const CUtensorMap* m,
                                             uint32_t src, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group"
      " [%0, {%2, %3}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(m)),
      "r"(src), "r"(c0), "r"(c1)
      : "memory");
}

// At most N of this thread's bulk groups have not yet read their source.
template <int N>
__device__ __forceinline__ void bulk_wait_read_n() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

// ------------------------------------------------------------ epilogue --

// One element: dequantize and add the bias, in f32 (rounded once to the
// output dtype where it is staged or stored).
__device__ __forceinline__ float dequant(int acc, float scale, bool has_bias,
                                         float bias) {
  const float v = __fmul_rn(__int2float_rn(acc), scale);
  return has_bias ? __fadd_rn(v, bias) : v;
}

// Two adjacent columns, rounded to OutT, into a staged row.
template <typename OutT>
__device__ __forceinline__ void stage_pair(uint32_t addr, float v0, float v1);
template <>
__device__ __forceinline__ void stage_pair<__nv_bfloat16>(uint32_t addr,
                                                         float v0, float v1) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(v0, v1);
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr),
               "r"(*reinterpret_cast<const uint32_t*>(&v))
               : "memory");
}
template <>
__device__ __forceinline__ void stage_pair<float>(uint32_t addr, float v0,
                                                 float v1) {
  asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n" ::"r"(addr), "f"(v0),
               "f"(v1)
               : "memory");
}

__device__ __forceinline__ void store_elem(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void store_elem(float* p, float v) { *p = v; }

// The thread's part of one warpgroup's 64 rows (rows wq * 16 + g + 8 h,
// columns j * 8 + 2 tq + e of the column tile; the wgmma accumulator
// layout) staged for the TMA stores: kPasses buffers of 64 rows x 128
// bytes, 16-byte piece k of row r at k ^ (r & 7) (TMA's 128-byte swizzle).
template <typename OutT>
__device__ __forceinline__ void stage_tile(const int (&acc)[64],
                                           const float (&swr)[16][2],
                                           const float (&bir)[16][2],
                                           const float (&sxr)[2],
                                           bool has_bias, uint32_t buf,
                                           int wq, int g, int tq) {
  constexpr int kPasses = kBN * static_cast<int>(sizeof(OutT)) / 128;
  constexpr int kJ = kBN / 8 / kPasses;  // 8-column groups a pass
  constexpr int kPiece = 16 / static_cast<int>(sizeof(OutT));
#pragma unroll
  for (int pass = 0; pass < kPasses; ++pass) {
#pragma unroll
    for (int jj = 0; jj < kJ; ++jj) {
      const int j = pass * kJ + jj;
      // 16-byte piece and byte within it of columns (2 tq, 2 tq + 1)
      const int piece = (jj * 8 + tq * 2) / kPiece;
      const int within = (tq * 2 % kPiece) * static_cast<int>(sizeof(OutT));
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int rr = wq * 16 + g + 8 * h;  // row in the box
        const float v0 = dequant(acc[4 * j + 2 * h],
                                 __fmul_rn(sxr[h], swr[j][0]), has_bias,
                                 bir[j][0]);
        const float v1 = dequant(acc[4 * j + 2 * h + 1],
                                 __fmul_rn(sxr[h], swr[j][1]), has_bias,
                                 bir[j][1]);
        stage_pair<OutT>(buf + pass * kPassBytes + rr * 128 +
                             ((piece ^ (rr & 7)) << 4) + within,
                         v0, v1);
      }
    }
  }
}

// The same elements stored by the thread itself (y's rows are not 16-byte
// strided, so no TMA map): rows from row0, columns from n0, within M x N.
template <typename OutT>
__device__ __forceinline__ void store_tile(const int (&acc)[64],
                                           const float (&swr)[16][2],
                                           const float (&bir)[16][2],
                                           const float (&sxr)[2],
                                           bool has_bias, OutT* y, int row0,
                                           int n0, int M, int N, int wq,
                                           int g, int tq) {
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int n = n0 + j * 8 + tq * 2 + e;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = row0 + wq * 16 + g + 8 * h;
        if (n >= N || r >= M) continue;
        store_elem(y + static_cast<int64_t>(r) * N + n,
                   dequant(acc[4 * j + 2 * h + e],
                           __fmul_rn(sxr[h], swr[j][e]), has_bias,
                           bir[j][e]));
      }
    }
  }
}

// ---------------------------------------------------------------- kernel --

template <typename OutT>
__global__ void __launch_bounds__(kThreads, 1)
    conv1x1_s8_kernel(const __grid_constant__ CUtensorMap tm_x,
                      const __grid_constant__ CUtensorMap tm_w,
                      const __grid_constant__ CUtensorMap tm_y,
                      const float* __restrict__ sx,
                      const float* __restrict__ sw,
                      const float* __restrict__ bias, OutT* __restrict__ y,
                      const Shape s) {
  extern __shared__ unsigned char smem_raw[];
  // shared memory: [slab][ring of stages][out buffers][barriers]
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t ring = base + s.ring_off;
  const uint32_t outb = base + s.out_off;
  const uint32_t bars = base + s.bar_off;
  const uint32_t slab_bar = bars + 8 * 2 * kMaxStages;
  const int wg = threadIdx.x >> 7;
  const int lane = threadIdx.x & 31;
  const int n0 = (blockIdx.x % s.nt) * kBN;
  const int rt0 = blockIdx.x / s.nt;

  if (threadIdx.x == 0) {
    for (int i = 0; i < s.stages; ++i) {
      mbar_init(bars + 8 * i, 1);                              // full
      mbar_init(bars + 8 * (kMaxStages + i), 4 * kConsumers);  // empty
    }
    mbar_init(slab_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ---------------------------------------------------- producer --
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x != 0) return;
    prefetch_tensormap(&tm_x);
    prefetch_tensormap(&tm_w);
    if (s.resident) {
      mbar_expect_tx(slab_bar, s.chunks * kChunkBytes);
      for (int c = 0; c < s.chunks; ++c)
        tma_load_2d(base + c * kChunkBytes, &tm_w, slab_bar, c * kBK, n0);
    }
    int it = 0;
    for (int rt = rt0; rt < s.mt; rt += s.bpc) {
      for (int c = 0; c < s.chunks; ++c, ++it) {
        const int st = it % s.stages;
        const uint32_t full = bars + 8 * st;
        mbar_wait(bars + 8 * (kMaxStages + st), ((it / s.stages) & 1) ^ 1);
        const uint32_t a = ring + st * s.stage_bytes;
        mbar_expect_tx(full, s.stage_bytes);
        tma_load_2d(a, &tm_x, full, c * kBK, rt * kRows);
        if (!s.resident)
          tma_load_2d(a + kChunkBytes, &tm_w, full, c * kBK, n0);
      }
    }
    return;
  }

  // ------------------------------------------------------ consumers --
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int cwg = wg - 1;
  const int wq = (threadIdx.x >> 5) & 3;
  const int g = lane >> 2, tq = lane & 3;
  const bool leader = (threadIdx.x & 127) == 0;  // stores the warpgroup's
  const uint32_t my_out = outb + cwg * kOutBufs * kPassBytes;
  const bool has_bias = bias != nullptr;
  // the scale and bias of the thread's 32 columns (j * 8 + 2 tq + e) of
  // the block's column tile, loaded once
  float swr[16][2], bir[16][2];
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int n = n0 + j * 8 + tq * 2 + e;
      swr[j][e] = n < s.N ? sw[n] : 0.f;
      bir[j][e] = has_bias && n < s.N ? bias[n] : 0.f;
    }
  }
  if (s.resident) mbar_wait(slab_bar, 0);

  constexpr int kPasses = kBN * static_cast<int>(sizeof(OutT)) / 128;
  constexpr int kInFlight = kOutBufs / kPasses;  // tiles whose stores fly
  static_assert(kInFlight >= 1, "a tile's passes must fit the buffers");

  int acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0;  // each tile's first wgmma overwrites
  int it = 0, tile = 0;
  for (int rt = rt0; rt < s.mt; rt += s.bpc, ++tile) {
    int pending = -1;  // stage whose wgmma group may still be in flight
    for (int c = 0; c < s.chunks; ++c, ++it) {
      const int st = it % s.stages;
      mbar_wait(bars + 8 * st, (it / s.stages) & 1);
      const uint32_t a = ring + st * s.stage_bytes;
      const uint64_t da = desc_sw128(a + cwg * 64 * kBK);
      const uint64_t db = desc_sw128(
          s.resident ? base + c * kChunkBytes : a + kChunkBytes);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < kBK / 32; ++ks)
        wgmma_m64n128k32_s8_ss(acc, da + 2 * ks, db + 2 * ks, c | ks);
      wgmma_commit();
      wgmma_wait<1>();  // the previous chunk's group is done
      if (pending >= 0 && lane == 0)
        mbar_arrive(bars + 8 * (kMaxStages + pending));
      pending = st;
    }
    wgmma_wait<0>();
    fence_acc(acc);
    if (lane == 0) mbar_arrive(bars + 8 * (kMaxStages + pending));

    // epilogue: the thread's rows (h = 0, 1) of the warpgroup's 64, each
    // with its sample's scale
    const int row0 = rt * kRows + cwg * 64;
    float sxr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = min(row0 + wq * 16 + g + 8 * h, s.M - 1);
      sxr[h] = sx[r / s.V];
    }
    if (!s.tma_out) {
      store_tile<OutT>(acc, swr, bir, sxr, has_bias, y, row0, n0, s.M, s.N,
                       wq, g, tq);
      continue;
    }
    // this tile's kPasses buffers were last used kInFlight tiles ago: their
    // stores must have read them
    const uint32_t buf = my_out + (tile % kInFlight) * kPasses * kPassBytes;
    if (leader) bulk_wait_read_n<kInFlight - 1>();
    named_barrier(1 + cwg, 128);
    stage_tile<OutT>(acc, swr, bir, sxr, has_bias, buf, wq, g, tq);
    // every thread's staged rows, visible to the async proxy
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    named_barrier(1 + cwg, 128);
    if (leader) {
      if (row0 < s.M) {
#pragma unroll
        for (int pass = 0; pass < kPasses; ++pass) {
          const int nc = n0 + pass * (kBN / kPasses);
          if (nc < s.N) tma_store_2d(&tm_y, buf + pass * kPassBytes, nc, row0);
        }
      }
      bulk_commit();
      // the block's last tile: its buffers must outlive their stores' reads
      if (rt + s.bpc >= s.mt) bulk_wait_read_n<0>();
    }
  }
}

// ---------------------------------------------------------------- host --

// One launch of the OutT instance. setmaxnreg hands registers between the
// warpgroups of a block: launch must have given every thread kLaunchRegs,
// or the consumers' request would wait for registers that never come.
template <typename OutT>
cudaError_t launch(const CUtensorMap& tm_x, const CUtensorMap& tm_w,
                   const CUtensorMap& tm_y, const float* sx, const float* sw,
                   const float* bias, void* y, const Shape& s, size_t smem,
                   int grid, cudaStream_t stream) {
  static int regs = -1;
  if (regs < 0) {
    cudaFuncAttributes attr;
    const cudaError_t err =
        cudaFuncGetAttributes(&attr, conv1x1_s8_kernel<OutT>);
    if (err != cudaSuccess) return err;
    regs = attr.numRegs;
  }
  if (regs != kLaunchRegs) return cudaErrorInvalidConfiguration;
  const cudaError_t err = cudaFuncSetAttribute(
      conv1x1_s8_kernel<OutT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  conv1x1_s8_kernel<OutT><<<grid, kThreads, smem, stream>>>(
      tm_x, tm_w, tm_y, sx, sw, bias, static_cast<OutT*>(y), s);
  return cudaGetLastError();
}

// A 2-D map of a row-major [rows, cols] matrix, box [box_rows, box_cols].
bool encode_2d(CUtensorMap* map, CUtensorMapDataType type, const void* ptr,
               int64_t rows, int64_t cols, int esize, int box_cols,
               int box_rows) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * esize};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows)};
  return encode_map(map, type, ptr, 2, dims, strides, box);
}

}  // namespace

extern "C" {

// xq [B * V, Cin] int8 (x [B, D, H, W, Cin], V = D * H * W); w packed
// [1][N][Cin] int8 (ops/conv3d_s8.py:pack_weight_s8 of an (N, Cin, 1, 1, 1)
// weight); sx [B] and sw [N] f32; bias [N] f32 or NULL; y [B * V, N].
// xq and w 16-byte aligned, Cin a multiple of 16 (TMA's 16-byte strides).
// out_dtype: 0 = float32, 1 = bfloat16. The plan (stages, resident or
// streamed slab, grid) is ops/conv3d_s8.py:conv1x1_plan's. Returns a
// cudaError_t.
int conv1x1_s8_launch(const void* x, const void* w, const float* sx,
                      const float* sw, const float* bias, void* y, int B,
                      int V, int Cin, int N, int out_dtype,
                      void* stream_ptr) {
  const int64_t M = static_cast<int64_t>(B) * V;
  if (B <= 0 || V <= 0 || Cin <= 0 || N <= 0 || Cin % 16 != 0 ||
      M > 0x7fffffff - kRows || (out_dtype != 0 && out_dtype != 1) ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(w) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Shape s;
  s.M = static_cast<int>(M);
  s.V = V; s.B = B; s.Cin = Cin; s.N = N;
  s.chunks = (Cin + kBK - 1) / kBK;
  s.nt = (N + kBN - 1) / kBN;
  s.mt = (s.M + kRows - 1) / kRows;
  // the slab stays resident where kMinStages A stages fit beside it
  const int64_t fixed = 1024 + kOutBytes + 8 * kBars;
  const int64_t slab = static_cast<int64_t>(s.chunks) * kChunkBytes;
  const int64_t resident_stages = (kSmemLimit - fixed - slab) / kChunkBytes;
  if (resident_stages >= kMinStages) {
    s.resident = 1;
    s.stages = static_cast<int>(resident_stages < kMaxStages
                                    ? resident_stages : kMaxStages);
    s.stage_bytes = kChunkBytes;
    s.ring_off = static_cast<int>(slab);
  } else {
    s.resident = 0;
    const int64_t st = (kSmemLimit - fixed) / (2 * kChunkBytes);
    s.stages = static_cast<int>(st < kMaxStages ? st : kMaxStages);
    s.stage_bytes = 2 * kChunkBytes;
    s.ring_off = 0;
  }
  s.out_off = s.ring_off + s.stages * s.stage_bytes;
  s.bar_off = s.out_off + kOutBytes;
  const size_t smem = 1024 + s.bar_off + 8 * kBars;

  cudaError_t err;
  const int sms = sm_count(&err);
  if (err != cudaSuccess) return static_cast<int>(err);
  int bpc = sms / s.nt;
  if (bpc > s.mt) bpc = s.mt;
  if (bpc < 1) bpc = 1;
  s.bpc = bpc;
  const int grid = s.nt * bpc;

  const int esize = out_dtype == 1 ? 2 : 4;
  CUtensorMap tm_x, tm_w, tm_y;
  if (!encode_2d(&tm_x, CU_TENSOR_MAP_DATA_TYPE_UINT8, x, M, Cin, 1, kBK,
                 kRows) ||
      !encode_2d(&tm_w, CU_TENSOR_MAP_DATA_TYPE_UINT8, w, N, Cin, 1, kBK,
                 kBN))
    return static_cast<int>(cudaErrorInvalidValue);
  // the store box: 128 bytes of columns (a pass) x one warpgroup's 64 rows
  s.tma_out = (static_cast<int64_t>(N) * esize % 16 == 0 &&
               reinterpret_cast<uintptr_t>(y) % 16 == 0 &&
               encode_2d(&tm_y,
                         out_dtype == 1 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                        : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                         y, M, N, esize, 128 / esize, 64))
                  ? 1 : 0;
  if (!s.tma_out) tm_y = tm_x;  // unused

  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (out_dtype == 0)
    err = launch<float>(tm_x, tm_w, tm_y, sx, sw, bias, y, s, smem, grid,
                        stream);
  else
    err = launch<__nv_bfloat16>(tm_x, tm_w, tm_y, sx, sw, bias, y, s, smem,
                                grid, stream);
  return static_cast<int>(err);
}

}  // extern "C"

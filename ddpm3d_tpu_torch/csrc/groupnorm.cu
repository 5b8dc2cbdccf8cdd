// GroupNorm statistics and the fused normalize+FiLM+SiLU pass, channels-last
// [B, N, C] activations, for Hopper (sm_90a).
//
// Replaces the two TPU kernels of ddpm3d_tpu/ops/groupnorm.py
// (_pallas_gn_silu_one, reached through fused_group_norm_silu):
//   * gn_stats  <- _stats_kernel: per-(batch, channel) sum(x) and sum(x^2)
//                  in f32 over the N rows.
//   * gn_apply  <- _apply_kernel: y = silu?(x * g[b,c] + b[b,c]) in f32, cast
//                  back to x's dtype. (g, b) is the per-channel affine that
//                  folds GroupNorm, its scale/bias and the FiLM scale/shift.
// The fold of the sums into (g, b) (XLA's in JAX: nn.py:fold_gn_affine) is
// gn_fold_row, run by the block of gn_stats that finishes a batch row's
// last column slice (a second ticket per row), or by gn_fold_kernel for
// sums K1 did not make (a spatial group's all-reduced sums, the fused
// conv's stats).
//
// Bound on the H100: bytes. Both passes do a few FLOP per element, far below
// the ~295 FLOP/byte ridge, so the least time is the tensor's bytes over
// 3.35 TB/s (stats: read x once; apply: read x, write y).
//
// Design: 16-byte vector loads along C (8 bf16 or 4 f32 channels per
// thread). The stats pass is one launch: blocks split N into row ranges
// (a number that depends only on N, ops/groupnorm.py:rows_per_split) and C
// into slices of 16 vectors; each thread keeps kUnroll loads in flight,
// each block writes its partial sums, and the last block of each (batch,
// slice) to finish, found by a ticket on an integer counter, adds the
// partials in split order. No float atomics: the result is the same from
// run to run and does not depend on how many volumes share the batch.
//
// The fold follows ops/groupnorm.py:gn_moments / gn_affine as PyTorch runs
// them on the card, operation for operation in f32, so (g, b) equal theirs
// bit for bit: a group's sums in the order of ATen's reduction over a short
// contiguous dimension (reduce_group), the division by the group's size as
// a product with its reciprocal (ATen's division by a host scalar), each
// product and sum rounded on its own (no contraction into an FMA), and
// rsqrtf.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <typename T>
struct Vec;

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int kN = 8;
  __device__ static void load(const __nv_bfloat16* p, float (&v)[kN]) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < kN / 2; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
  __device__ static void store(__nv_bfloat16* p, const float (&v)[kN]) {
    uint4 raw;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < kN / 2; ++i)
      h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = raw;
  }
};

template <>
struct Vec<float> {
  static constexpr int kN = 4;
  __device__ static void load(const float* p, float (&v)[kN]) {
    const float4 f = *reinterpret_cast<const float4*>(p);
    v[0] = f.x;
    v[1] = f.y;
    v[2] = f.z;
    v[3] = f.w;
  }
  __device__ static void store(float* p, const float (&v)[kN]) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

constexpr int kLanes = 16;  // 16-byte vectors of a column slice
#ifndef GN_STATS_UNROLL  // a study build may set another depth
#define GN_STATS_UNROLL 4
#endif
constexpr int kUnroll = GN_STATS_UNROLL;  // row loads in flight per thread

constexpr int kMaxGroups = 1024;  // the fold keeps 2 floats a group in shared
// shared memory of the stats kernel's reduction and of the fold (floats): the
// fold stages a row's [2][C] sums there when 2 * C + 2 * groups fit
constexpr int kSmem = kThreads * 16;

// What the fold reads and writes besides the sums; gamma == nullptr: no
// fold. film_scale / film_shift (each may be null) are [B, C] f32 rows
// film_stride floats apart with unit channel stride (a chunk of the
// embedding's [B, 2C] output as it is); g, b, mean, rstd are [B, C] f32
// (mean and rstd may be null).
struct Fold {
  const float* gamma;
  const float* beta;
  const float* film_scale;
  const float* film_shift;
  int film_stride;
  int groups;
  float n;    // elements a group sums over: voxels x channels of a group
  float eps;
  float* g;
  float* b;
  float* mean;
  float* rstd;
};

// sum p[0], p[1], ..., p[cg - 1] (and p[C + 0 ...]) as ATen's reduction
// does on the card when the reduced dimension is the innermost, contiguous
// and short (Reduce.cuh: block width bw = min(largest power of 2 <= cg, 32)
// lanes; lane x adds elements x, x + bw, ... into 4 accumulators by
// position, adds those in order, then lane x adds lane x + o's sum for o =
// bw / 2, bw / 4, ..., 1). A warp per group; lane 0 gets the sums. p is in
// shared memory (kShared) or in global memory written by this launch.
template <bool kShared>
__device__ __forceinline__ void reduce_group(const float* p, int C, int cg,
                                             int lane, float& s1, float& s2) {
  auto ld = [](const float* q) { return kShared ? *q : __ldcg(q); };
  int bw = 1;
  while (bw * 2 <= cg && bw < 32) bw *= 2;
  float a[4] = {0.f, 0.f, 0.f, 0.f}, q[4] = {0.f, 0.f, 0.f, 0.f};
  if (lane < bw) {
    int i = lane;
    for (; i + 3 * bw < cg; i += 4 * bw) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        a[u] = __fadd_rn(a[u], ld(p + i + u * bw));
        q[u] = __fadd_rn(q[u], ld(p + C + i + u * bw));
      }
    }
#pragma unroll
    for (int u = 0; u < 3; ++u, i += bw)
      if (i < cg) {
        a[u] = __fadd_rn(a[u], ld(p + i));
        q[u] = __fadd_rn(q[u], ld(p + C + i));
      }
  }
  s1 = __fadd_rn(__fadd_rn(__fadd_rn(a[0], a[1]), a[2]), a[3]);
  s2 = __fadd_rn(__fadd_rn(__fadd_rn(q[0], q[1]), q[2]), q[3]);
  for (int o = bw / 2; o > 0; o >>= 1) {
    const float t1 = __shfl_down_sync(0xffffffffu, s1, o);
    const float t2 = __shfl_down_sync(0xffffffffu, s2, o);
    s1 = __fadd_rn(s1, t1);
    s2 = __fadd_rn(s2, t2);
  }
}

// Per group k (warps in turn): mean and rstd into sm[k], sm[G + k].
template <bool kShared>
__device__ __forceinline__ void fold_groups(const float* st, int C,
                                            const Fold& f, float* sm) {
  const int G = f.groups, cg = C / G, lane = threadIdx.x % 32;
  const float inv_n = __frcp_rn(f.n);
  for (int k = threadIdx.x / 32; k < G; k += blockDim.x / 32) {
    float s1, s2;
    reduce_group<kShared>(st + k * cg, C, cg, lane, s1, s2);
    if (lane == 0) {
      const float mean = __fmul_rn(s1, inv_n);
      float var = __fsub_rn(__fmul_rn(s2, inv_n), __fmul_rn(mean, mean));
      var = var < 0.f ? 0.f : var;  // NaN stays NaN, as torch.clamp
      sm[k] = mean;
      sm[G + k] = rsqrtf(__fadd_rn(var, f.eps));
    }
  }
}

// The fold of batch row b, by the whole block (blockDim.x a multiple of
// 32): st holds the row's sums [2][C], written by this launch or before
// it; sm kSmem floats of shared memory. Per group: mean = s1 * (1 / n),
// var = max(s2 * (1 / n) - mean^2, 0), rstd = rsqrt(var + eps); per
// channel: g = gamma * rstd, b = beta - mean * g, then g *= 1 +
// film_scale, b *= 1 + film_scale, b += film_shift (gn_moments,
// gn_affine). Each thread's first channel's parameters are loaded before
// the groups are summed, and the row's sums staged in shared memory in
// one pass where they fit, so the fold waits on memory about twice.
__device__ void gn_fold_row(const float* st, int C, int b, const Fold& f,
                            float* sm) {
  const int G = f.groups, cg = C / G;
  const int64_t row = static_cast<int64_t>(b) * C;
  const int64_t film = static_cast<int64_t>(b) * f.film_stride;
  const int c0 = threadIdx.x;
  float gamma0 = 0.f, beta0 = 0.f, fs0 = 0.f, fh0 = 0.f;
  if (c0 < C) {
    gamma0 = f.gamma[c0];
    beta0 = f.beta[c0];
    if (f.film_scale != nullptr) fs0 = f.film_scale[film + c0];
    if (f.film_shift != nullptr) fh0 = f.film_shift[film + c0];
  }
  if (2 * C + 2 * G <= kSmem) {
    float* rows = sm + 2 * G;
    for (int i = threadIdx.x; i < 2 * C; i += blockDim.x)
      rows[i] = __ldcg(st + i);
    __syncthreads();
    fold_groups<true>(rows, C, f, sm);
  } else {
    fold_groups<false>(st, C, f, sm);
  }
  __syncthreads();
  for (int c = c0; c < C; c += blockDim.x) {
    const float mean = sm[c / cg], rstd = sm[G + c / cg];
    const bool first = c == c0;
    float g = __fmul_rn(first ? gamma0 : f.gamma[c], rstd);
    float bb = __fsub_rn(first ? beta0 : f.beta[c], __fmul_rn(mean, g));
    if (f.film_scale != nullptr) {
      const float fs = __fadd_rn(
          1.f, first ? fs0 : f.film_scale[film + c]);
      g = __fmul_rn(g, fs);
      bb = __fmul_rn(bb, fs);
    }
    if (f.film_shift != nullptr)
      bb = __fadd_rn(bb, first ? fh0 : f.film_shift[film + c]);
    f.g[row + c] = g;
    f.b[row + c] = bb;
    if (f.mean != nullptr) {
      f.mean[row + c] = mean;
      f.rstd[row + c] = rstd;
    }
  }
}

// Per-(batch, channel) sum x and sum x^2 over the N rows, in one launch.
// grid (S, CS, B): block (split, cs, b) sums rows [split * rows_per_split,
// ...) of column slice cs (kLanes vectors, 16 * V channels) of batch b into
// part[b][cs][split][2][W] (W = the slice's channels), then takes a ticket
// on ticket[b][cs]; the block that takes the last ticket adds the S
// partials of the slice in split order and writes stats[b][0..1][c], and
// resets the counter to 0 for the next launch. The ticket decides which
// block adds, never the order. With a fold (fold.gamma set) each slice's
// finisher then takes a ticket on ticket[B * CS + b]; the one that takes
// the row's last (a group may straddle two slices) folds the row's sums
// into (g, b), and resets that counter too.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    gn_stats_kernel(const T* __restrict__ x, float* __restrict__ part,
                    unsigned* __restrict__ ticket, float* __restrict__ stats,
                    int N, int C, int rows_per_split, const Fold fold) {
  constexpr int V = Vec<T>::kN;
  constexpr int kCW = kLanes * V;            // channels per slice, at most
  static_assert(kThreads * 2 * V <= kSmem, "the reduction's shared memory");
  __shared__ float red[kSmem];
  __shared__ bool last;
  const int split = blockIdx.x, S = gridDim.x;
  const int cs = blockIdx.y, CS = gridDim.y, b = blockIdx.z;
  const int c0 = cs * kCW;
  const int VL = min(kLanes, (C - c0) / V);  // vectors in this slice
  const int W = VL * V;
  const int rph = kThreads / VL;             // rows walked in parallel
  const int lane = threadIdx.x % VL, rp = threadIdx.x / VL;
  const int r0 = split * rows_per_split;
  const int r1 = min(N, r0 + rows_per_split);
  const T* xb = x + static_cast<int64_t>(b) * N * C + c0 + lane * V;
  float* pbase = part + (static_cast<int64_t>(b) * CS + cs) * S * 2 * kCW;

  float s[V], q[V];
#pragma unroll
  for (int e = 0; e < V; ++e) s[e] = q[e] = 0.f;
  if (rp < rph) {
    int r = r0 + rp;
    // kUnroll independent 16-byte loads in flight, summed in row order
    for (; r + (kUnroll - 1) * rph < r1; r += kUnroll * rph) {
      float xv[kUnroll][V];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        Vec<T>::load(xb + static_cast<int64_t>(r + u * rph) * C, xv[u]);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
#pragma unroll
        for (int e = 0; e < V; ++e) {
          s[e] += xv[u][e];
          q[e] = fmaf(xv[u][e], xv[u][e], q[e]);
        }
    }
    for (; r < r1; r += rph) {
      float xv[V];
      Vec<T>::load(xb + static_cast<int64_t>(r) * C, xv);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        s[e] += xv[e];
        q[e] = fmaf(xv[e], xv[e], q[e]);
      }
    }
  }
#pragma unroll
  for (int e = 0; e < V; ++e) {
    red[(threadIdx.x * 2) * V + e] = s[e];
    red[(threadIdx.x * 2 + 1) * V + e] = q[e];
  }
  __syncthreads();
  if (rp == 0) {
    for (int p = 1; p < rph; ++p) {  // fixed order
      const int o = (p * VL + lane) * 2 * V;
#pragma unroll
      for (int e = 0; e < V; ++e) {
        s[e] += red[o + e];
        q[e] += red[o + V + e];
      }
    }
    float* out = pbase + static_cast<int64_t>(split) * 2 * W + lane * V;
#pragma unroll
    for (int e = 0; e < V; ++e) {
      out[e] = s[e];
      out[W + e] = q[e];
    }
  }
  // publish this block's partial, then take a ticket
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned t = atomicAdd(ticket + b * CS + cs, 1u);
    last = t == static_cast<unsigned>(S - 1);
    if (last) ticket[b * CS + cs] = 0;  // no other block of this launch
  }                                     // touches it again
  __syncthreads();
  if (!last) return;
  __threadfence();

  // the finish: 2 * W columns as float4 items; row lane l adds splits l,
  // l + RL, ... in order, then the RL lanes are added in order
  const int items = 2 * W / 4;
  const int RL = kThreads / items;
  const int it = threadIdx.x % items, rl = threadIdx.x / items;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  if (rl < RL) {
    const float4* src = reinterpret_cast<const float4*>(pbase) + it;
    int sp = rl;
    for (; sp + (kUnroll - 1) * RL < S; sp += kUnroll * RL) {
      float4 v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        v[u] = __ldcg(src + static_cast<int64_t>(sp + u * RL) * items);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        acc.x += v[u].x; acc.y += v[u].y; acc.z += v[u].z; acc.w += v[u].w;
      }
    }
    for (; sp < S; sp += RL) {
      const float4 v = __ldcg(src + static_cast<int64_t>(sp) * items);
      acc.x += v.x; acc.y += v.y; acc.z += v.z; acc.w += v.w;
    }
  }
  float4* red4 = reinterpret_cast<float4*>(red);
  red4[threadIdx.x] = acc;
  __syncthreads();
  if (rl == 0) {
    for (int l = 1; l < RL; ++l) {  // fixed order
      const float4 v = red4[l * items + it];
      acc.x += v.x; acc.y += v.y; acc.z += v.z; acc.w += v.w;
    }
    const int k = it * 4;  // column of [2][W]
    const int qq = k / W, c = c0 + k % W;
    float* dst = stats + (static_cast<int64_t>(b) * 2 + qq) * C + c;
    dst[0] = acc.x; dst[1] = acc.y; dst[2] = acc.z; dst[3] = acc.w;
  }
  if (fold.gamma == nullptr) return;

  // the row's last slice to finish folds the row (with one slice, this one)
  if (CS > 1) {
    __shared__ bool last_row;
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) {
      unsigned* row_ticket = ticket + gridDim.z * CS + b;
      const unsigned t = atomicAdd(row_ticket, 1u);
      last_row = t == static_cast<unsigned>(CS - 1);
      if (last_row) *row_ticket = 0;
    }
    __syncthreads();
    if (!last_row) return;
    __threadfence();
  } else {
    __syncthreads();
  }
  gn_fold_row(stats + static_cast<int64_t>(b) * 2 * C, C, b, fold, red);
}

// The fold alone, for sums K1 did not make: grid (B), block b folds row b
// of stats [B, 2, C].
__global__ void __launch_bounds__(kThreads)
    gn_fold_kernel(const float* __restrict__ stats, int C, const Fold fold) {
  __shared__ float sm[kSmem];
  gn_fold_row(stats + static_cast<int64_t>(blockIdx.x) * 2 * C, C,
              blockIdx.x, fold, sm);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    gn_apply_kernel(const T* __restrict__ x, const float* __restrict__ g,
                    const float* __restrict__ bb, T* __restrict__ y,
                    int64_t n_vec, int64_t NC, int C, int silu) {
  constexpr int V = Vec<T>::kN;
  for (int64_t i = blockIdx.x * static_cast<int64_t>(kThreads) + threadIdx.x;
       i < n_vec; i += static_cast<int64_t>(gridDim.x) * kThreads) {
    const int64_t elem = i * V;
    const int64_t b = elem / NC;
    const int c = static_cast<int>(elem % C);
    const float* gb = g + b * C + c;
    const float* bbb = bb + b * C + c;
    float v[V];
    Vec<T>::load(x + elem, v);
#pragma unroll
    for (int e = 0; e < V; ++e) {
      float h = v[e] * gb[e] + bbb[e];
      if (silu) h = h * (1.f / (1.f + expf(-h)));
      v[e] = h;
    }
    Vec<T>::store(y + elem, v);
  }
}

// the fold's arguments, checked; gamma == nullptr: no fold
int make_fold(const float* gamma, const float* beta, const float* film_scale,
              const float* film_shift, int film_stride, int groups, float n,
              float eps, float* g, float* b, float* mean, float* rstd, int C,
              Fold* f) {
  *f = Fold{gamma, beta, film_scale, film_shift, film_stride, groups, n, eps,
            g, b, mean, rstd};
  if (gamma == nullptr) return 0;
  if (beta == nullptr || g == nullptr || b == nullptr || groups <= 0 ||
      groups > kMaxGroups || C % groups != 0 || !(n > 0.f) ||
      ((mean == nullptr) != (rstd == nullptr)) ||
      ((film_scale != nullptr || film_shift != nullptr) && film_stride < C))
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

}  // namespace

extern "C" {

// x [B, N, C] (dtype 0 = float32, 1 = bfloat16), C a multiple of the vector
// width, 16-byte aligned. part holds B * CS * S * 2 * 16 * V floats of
// scratch (S = ceil(N / rows_per_split), CS = ceil(C / (16 * V)), V = 8
// for bf16 and 4 for f32), ticket B * CS unsigned counters that are 0, and
// B more with a fold (the kernel leaves them 0; launches that share them
// must be ordered); stats receives [B, 2, C] f32. With gamma set the same
// launch also folds the sums into the GroupNorm's affine: gamma, beta [C]
// f32; film_scale / film_shift [B, C] f32 rows film_stride floats apart,
// or null; `groups` groups of n = N * C / groups elements each; g, b
// receive [B, C] f32, and mean, rstd (both or neither) the per-channel
// group mean and rstd. One launch.
int gn_stats_launch(const void* x, float* part, unsigned* ticket,
                    float* stats, int B, int N, int C, int rows_per_split,
                    int dtype, const float* gamma, const float* beta,
                    const float* film_scale, const float* film_shift,
                    int film_stride, int groups, float n, float eps, float* g,
                    float* b, float* mean, float* rstd, void* stream_ptr) {
  const int V = dtype == 1 ? 8 : 4;
  if (B <= 0 || N <= 0 || C <= 0 || C % V != 0 || rows_per_split <= 0 ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(part) % 16 != 0 ||
      (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  Fold fold;
  const int err = make_fold(gamma, beta, film_scale, film_shift, film_stride,
                            groups, n, eps, g, b, mean, rstd, C, &fold);
  if (err != 0) return err;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int S = (N + rows_per_split - 1) / rows_per_split;
  const int CS = (C + kLanes * V - 1) / (kLanes * V);
  if (CS > 65535 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(S, CS, B);
  if (dtype == 1)
    gn_stats_kernel<__nv_bfloat16><<<grid, kThreads, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(x), part, ticket, stats, N, C,
        rows_per_split, fold);
  else
    gn_stats_kernel<float><<<grid, kThreads, 0, stream>>>(
        static_cast<const float*>(x), part, ticket, stats, N, C,
        rows_per_split, fold);
  return static_cast<int>(cudaGetLastError());
}

// The fold of gn_stats_launch alone, on sums [B, 2, C] f32 made elsewhere
// (the same arguments; gamma must be set). One launch of B blocks.
int gn_fold_launch(const float* stats, int B, int C, const float* gamma,
                   const float* beta, const float* film_scale,
                   const float* film_shift, int film_stride, int groups,
                   float n, float eps, float* g, float* b, float* mean,
                   float* rstd, void* stream_ptr) {
  if (B <= 0 || B > 65535 || C <= 0 || stats == nullptr || gamma == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  Fold fold;
  const int err = make_fold(gamma, beta, film_scale, film_shift, film_stride,
                            groups, n, eps, g, b, mean, rstd, C, &fold);
  if (err != 0) return err;
  gn_fold_kernel<<<B, kThreads, 0, static_cast<cudaStream_t>(stream_ptr)>>>(
      stats, C, fold);
  return static_cast<int>(cudaGetLastError());
}

// y = silu?(x * g[b, c] + b[b, c]); g and b are [B, C] f32.
int gn_apply_launch(const void* x, const float* g, const float* b, void* y,
                    int B, int N, int C, int silu, int dtype,
                    void* stream_ptr) {
  const int V = dtype == 1 ? 8 : 4;
  if (B <= 0 || N <= 0 || C <= 0 || C % V != 0 ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(y) % 16 != 0 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int64_t NC = static_cast<int64_t>(N) * C;
  const int64_t n_vec = B * NC / V;
  int64_t blocks = (n_vec + kThreads - 1) / kThreads;
  if (blocks > 132 * 16) blocks = 132 * 16;  // grid-stride beyond ~16/SM
  if (dtype == 1)
    gn_apply_kernel<__nv_bfloat16><<<static_cast<unsigned>(blocks), kThreads,
                                     0, stream>>>(
        static_cast<const __nv_bfloat16*>(x), g, b,
        static_cast<__nv_bfloat16*>(y), n_vec, NC, C, silu);
  else
    gn_apply_kernel<float><<<static_cast<unsigned>(blocks), kThreads, 0,
                             stream>>>(static_cast<const float*>(x), g, b,
                                       static_cast<float*>(y), n_vec, NC, C,
                                       silu);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

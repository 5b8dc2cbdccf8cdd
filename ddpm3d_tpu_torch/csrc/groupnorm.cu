// GroupNorm statistics and the fused normalize+FiLM+SiLU pass, channels-last
// [B, N, C] activations, for Hopper (sm_90a).
//
// Replaces the two TPU kernels of ddpm3d_tpu/ops/groupnorm.py
// (_pallas_gn_silu_one, reached through fused_group_norm_silu):
//   * gn_stats  <- _stats_kernel: per-(batch, channel) sum(x) and sum(x^2)
//                  in f32 over the N rows.
//   * gn_apply  <- _apply_kernel: y = silu?(x * g[b,c] + b[b,c]) in f32, cast
//                  back to x's dtype. (g, b) is the per-channel affine that
//                  folds GroupNorm, its scale/bias and the FiLM scale/shift;
//                  the fold itself is a [B, C]-sized step in the wrapper.
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

// Per-(batch, channel) sum x and sum x^2 over the N rows, in one launch.
// grid (S, CS, B): block (split, cs, b) sums rows [split * rows_per_split,
// ...) of column slice cs (kLanes vectors, 16 * V channels) of batch b into
// part[b][cs][split][2][W] (W = the slice's channels), then takes a ticket
// on ticket[b][cs]; the block that takes the last ticket adds the S
// partials of the slice in split order and writes stats[b][0..1][c], and
// resets the counter to 0 for the next launch. The ticket decides which
// block adds, never the order.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    gn_stats_kernel(const T* __restrict__ x, float* __restrict__ part,
                    unsigned* __restrict__ ticket, float* __restrict__ stats,
                    int N, int C, int rows_per_split) {
  constexpr int V = Vec<T>::kN;
  constexpr int kCW = kLanes * V;            // channels per slice, at most
  __shared__ float red[kThreads * 2 * V];
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

}  // namespace

extern "C" {

// x [B, N, C] (dtype 0 = float32, 1 = bfloat16), C a multiple of the vector
// width, 16-byte aligned. part holds B * CS * S * 2 * 16 * V floats of
// scratch (S = ceil(N / rows_per_split), CS = ceil(C / (16 * V)), V = 8
// for bf16 and 4 for f32), ticket B * CS unsigned counters that are 0 (the
// kernel leaves them 0; launches that share them must be ordered); stats
// receives [B, 2, C] f32. One launch.
int gn_stats_launch(const void* x, float* part, unsigned* ticket,
                    float* stats, int B, int N, int C, int rows_per_split,
                    int dtype, void* stream_ptr) {
  const int V = dtype == 1 ? 8 : 4;
  if (B <= 0 || N <= 0 || C <= 0 || C % V != 0 || rows_per_split <= 0 ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(part) % 16 != 0 ||
      (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int S = (N + rows_per_split - 1) / rows_per_split;
  const int CS = (C + kLanes * V - 1) / (kLanes * V);
  if (CS > 65535 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(S, CS, B);
  if (dtype == 1)
    gn_stats_kernel<__nv_bfloat16><<<grid, kThreads, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(x), part, ticket, stats, N, C,
        rows_per_split);
  else
    gn_stats_kernel<float><<<grid, kThreads, 0, stream>>>(
        static_cast<const float*>(x), part, ticket, stats, N, C,
        rows_per_split);
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

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
// thread); the stats pass splits N into a number of row ranges that depends
// only on N, each block writes its partial sums, and a second small kernel
// adds the partials of each (batch, channel) in a fixed order. No atomics:
// the result is the same from run to run and does not depend on how many
// volumes share the batch.

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

// grid (S, B): block (split, b) sums rows [split*rows, (split+1)*rows) of
// batch b into part[b][split][0..1][C].
template <typename T>
__global__ void __launch_bounds__(kThreads)
    gn_partial_kernel(const T* __restrict__ x, float* __restrict__ part,
                      int N, int C, int rows_per_split) {
  constexpr int V = Vec<T>::kN;
  __shared__ float red[kThreads * 2 * V];
  const int split = blockIdx.x, b = blockIdx.y, S = gridDim.x;
  const int r0 = split * rows_per_split;
  const int r1 = min(N, r0 + rows_per_split);
  const int VL = C / V;                      // vectors per row
  const int lanes = VL < kThreads ? VL : kThreads;
  const int rph = kThreads / lanes;          // rows walked in parallel
  const int lane = threadIdx.x % lanes, rp = threadIdx.x / lanes;
  const T* xb = x + static_cast<int64_t>(b) * N * C;
  float* out = part + (static_cast<int64_t>(b) * S + split) * 2 * C;

  for (int vb = 0; vb < VL; vb += lanes) {
    const int v = vb + lane;
    float s[V], q[V];
#pragma unroll
    for (int e = 0; e < V; ++e) s[e] = q[e] = 0.f;
    if (rp < rph && v < VL) {
      for (int r = r0 + rp; r < r1; r += rph) {
        float xv[V];
        Vec<T>::load(xb + static_cast<int64_t>(r) * C + v * V, xv);
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
    if (rp == 0 && v < VL) {
      for (int p = 1; p < rph; ++p) {  // fixed order
        const int o = (p * lanes + lane) * 2 * V;
#pragma unroll
        for (int e = 0; e < V; ++e) {
          s[e] += red[o + e];
          q[e] += red[o + V + e];
        }
      }
#pragma unroll
      for (int e = 0; e < V; ++e) {
        out[v * V + e] = s[e];
        out[C + v * V + e] = q[e];
      }
    }
    __syncthreads();
  }
}

// grid (ceil(C/256), B): stats[b][0..1][c] = sum over splits, in order.
__global__ void __launch_bounds__(kThreads)
    gn_finish_kernel(const float* __restrict__ part, float* __restrict__ stats,
                     int C, int S) {
  const int c = blockIdx.x * kThreads + threadIdx.x, b = blockIdx.y;
  if (c >= C) return;
  const float* pb = part + static_cast<int64_t>(b) * S * 2 * C;
  float s = 0.f, q = 0.f;
  for (int i = 0; i < S; ++i) {
    s += pb[static_cast<int64_t>(i) * 2 * C + c];
    q += pb[static_cast<int64_t>(i) * 2 * C + C + c];
  }
  stats[(static_cast<int64_t>(b) * 2) * C + c] = s;
  stats[(static_cast<int64_t>(b) * 2 + 1) * C + c] = q;
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
// width, 16-byte aligned. part holds B*S*2*C floats of scratch with
// S = ceil(N / rows_per_split); stats receives [B, 2, C] f32.
int gn_stats_launch(const void* x, float* part, float* stats, int B, int N,
                    int C, int rows_per_split, int dtype, void* stream_ptr) {
  const int V = dtype == 1 ? 8 : 4;
  if (B <= 0 || N <= 0 || C <= 0 || C % V != 0 || rows_per_split <= 0 ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int S = (N + rows_per_split - 1) / rows_per_split;
  const dim3 grid(S, B);
  if (dtype == 1)
    gn_partial_kernel<__nv_bfloat16><<<grid, kThreads, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(x), part, N, C, rows_per_split);
  else
    gn_partial_kernel<float><<<grid, kThreads, 0, stream>>>(
        static_cast<const float*>(x), part, N, C, rows_per_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  gn_finish_kernel<<<dim3((C + kThreads - 1) / kThreads, B), kThreads, 0,
                     stream>>>(part, stats, C, S);
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

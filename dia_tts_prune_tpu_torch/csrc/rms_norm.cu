// RMSNorm in one launch with a fixed sum order, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package computes it with XLA
// (dia_tts_prune_tpu/ops/modules.py::rms_norm).  Same function:
//   y = (x32 * rsqrt(mean(x32^2) + eps) * scale32).to(x.dtype)
// with x fp32 or bf16 [rows, D], scale fp32, bf16 or fp16 [D].  It exists
// because the port must give a decode row the same bits whatever the other
// rows of the call are: a CUDA reduction of ATen picks its launch shape, and
// with it the order a row's mean of squares sums in, by the number of rows.
//
// What bounds it on the H100: bytes (each element read twice, the second
// time from L1/L2, written once), and at a decode step's 2-80 rows of 2048
// the launch itself.  The design keeps it to one launch:
// * one block a row, THREADS(D) threads (the launch shape depends on D only);
// * thread i sums x[i], x[i + T], x[i + 2T], ... in that order in fp32 (fused
//   multiply-adds), a fixed shuffle tree (offsets 16, 8, 4, 2, 1 toward lane
//   0) adds a warp's 32 sums, and thread 0 adds the warps' sums in warp
//   order; the mean divides by D once, and the factor is 1 / sqrt of it
//   (both correctly rounded: rsqrtf may be 2 ulp off);
// * every thread then writes its elements as (x * factor) * scale, rounded
//   once to x's dtype.
// A row's bits depend on its own values, the scale and D only.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_THREADS = 1024;
constexpr int PER_THREAD = 8;  // elements a thread sums, at least (D / THREADS rounded up)

__host__ __device__ constexpr int threads_for(int D) {
  const int t = ((D + PER_THREAD - 1) / PER_THREAD + 31) / 32 * 32;
  return t < 32 ? 32 : t > MAX_THREADS ? MAX_THREADS : t;
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(__half v) { return __half2float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// grid (rows), THREADS(D) threads
template <typename T, typename S>
__global__ void __launch_bounds__(MAX_THREADS)
rms_norm_kernel(const T* __restrict__ x, const S* __restrict__ scale, T* __restrict__ out, int D,
                float eps) {
  __shared__ float warp_sum[MAX_THREADS / 32];
  __shared__ float factor;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, T_ = blockDim.x;
  const T* xr = x + (size_t)blockIdx.x * D;
  T* yr = out + (size_t)blockIdx.x * D;
  float acc = 0.f;
  for (int i = tid; i < D; i += T_) {
    const float v = to_f(xr[i]);
    acc = fmaf(v, v, acc);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, off);
  if (lane == 0) warp_sum[warp] = acc;
  __syncthreads();
  if (tid == 0) {
    float total = warp_sum[0];
    for (int w = 1; w < T_ / 32; ++w) total += warp_sum[w];  // warp order
    factor = 1.f / sqrtf(total / (float)D + eps);  // each step correctly rounded
  }
  __syncthreads();
  const float f = factor;
  for (int i = tid; i < D; i += T_) yr[i] = from_f<T>(to_f(xr[i]) * f * to_f(scale[i]));
}

template <typename T, typename S>
cudaError_t launch(const void* x, const void* scale, void* out, int rows, int D, float eps,
                   cudaStream_t stream) {
  rms_norm_kernel<T, S><<<rows, threads_for(D), 0, stream>>>(
      static_cast<const T*>(x), static_cast<const S*>(scale), static_cast<T*>(out), D, eps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_scale(const void* x, const void* scale, void* out, int rows, int D,
                           float eps, int s_dtype, cudaStream_t s) {
  switch (s_dtype) {
    case 0: return launch<T, float>(x, scale, out, rows, D, eps, s);
    case 1: return launch<T, __nv_bfloat16>(x, scale, out, rows, D, eps, s);
    case 2: return launch<T, __half>(x, scale, out, rows, D, eps, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// x [rows, D] (x_dtype 0 = float32, 1 = bfloat16), scale [D] (s_dtype 0 =
// float32, 1 = bfloat16, 2 = float16), out [rows, D] of x's dtype; all
// contiguous.  One launch; returns its cudaError_t.
extern "C" int rms_norm_fwd(const void* x, const void* scale, void* out, int rows, int D,
                            float eps, int x_dtype, int s_dtype, void* stream) {
  if (rows <= 0 || D <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0) return dispatch_scale<float>(x, scale, out, rows, D, eps, s_dtype, s);
  if (x_dtype == 1) return dispatch_scale<__nv_bfloat16>(x, scale, out, rows, D, eps, s_dtype, s);
  return cudaErrorInvalidValue;
}

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
// What bounds it on the H100: bytes (each element read once, written once),
// and at a decode step's 2-80 rows of 2048 the latency of one launch and of
// one row's loads.  Two routes, one launch each; the route depends on D only:
// * bf16 x with D % 8 == 0 and D <= 8192 (the model's 2048 and 1024): a row
//   is ROW_WARPS(D) warps (one up to D = 2048), a block of NORM_THREADS holds
//   several rows.  Lane l of warp w loads its units of 16 bytes (8 values),
//   unit (j * ROW_WARPS + w) * 32 + l for j < LANE_UNITS, all at once, and
//   keeps them in registers (64 values at D = 2048); it sums their squares in
//   fp32 in that order (fused multiply-adds), a fixed XOR shuffle tree
//   (offsets 16, 8, 4, 2, 1) gives every lane the warp's sum, and a row of
//   several warps adds them in warp order through shared memory.  No
//   shared-memory round trip at one warp a row.
// * fp32 x, and bf16 of other widths (the parity fixtures, odd test widths):
//   one block a row, THREADS(D) threads; thread i sums x[i], x[i + T], ... in
//   that order in fp32 (fused multiply-adds), a fixed shuffle tree (offsets
//   16, 8, 4, 2, 1 toward lane 0) adds a warp's 32 sums, and thread 0 adds
//   the warps' sums in warp order.
// Either way the mean divides by D once, and the factor is 1 / sqrt of it
// (both correctly rounded: rsqrtf may be 2 ulp off); each element is written
// as (x * factor) * scale, rounded once to x's dtype.  A row's bits depend on
// its own values, the scale and D only.
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

// ---------------------------------------------------------------------------
// fp32 x, and bf16 of other widths: one block a row
// ---------------------------------------------------------------------------
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

// ---------------------------------------------------------------------------
// bf16, D % 8 == 0, D <= 8192: warps a row, the row in registers
// ---------------------------------------------------------------------------
constexpr int NORM_THREADS = 128;  // a block's threads: 4 warps
constexpr int LANE_UNITS = 8;      // 16-byte units a lane holds, at most: 64 values
constexpr int MAX_ROW_WARPS = NORM_THREADS / 32;

// warps of a row for width D: 1 up to 2048, 2 up to 4096, 4 up to 8192
__host__ __device__ constexpr int row_warps(int D) { return D <= 2048 ? 1 : D <= 4096 ? 2 : 4; }

// value i (0..7) of a 16-byte unit of bf16 (exact: a bf16 is the high half of its fp32)
__device__ __forceinline__ float bf16_at(const uint4& v, int i) {
  const uint32_t w = i < 2 ? v.x : i < 4 ? v.y : i < 6 ? v.z : v.w;
  return __uint_as_float(i & 1 ? w & 0xffff0000u : w << 16);
}

// a scale's unit of 8 values, loaded at once and read as floats
template <typename S> struct ScaleUnit;
template <> struct ScaleUnit<float> {
  float4 a, b;
  __device__ __forceinline__ void load(const float* s, int u) {
    a = __ldg(reinterpret_cast<const float4*>(s) + 2 * u);
    b = __ldg(reinterpret_cast<const float4*>(s) + 2 * u + 1);
  }
  __device__ __forceinline__ float at(int i) const {
    const float4& h = i < 4 ? a : b;
    const int j = i & 3;
    return j == 0 ? h.x : j == 1 ? h.y : j == 2 ? h.z : h.w;
  }
};
template <> struct ScaleUnit<__nv_bfloat16> {
  uint4 v;
  __device__ __forceinline__ void load(const __nv_bfloat16* s, int u) {
    v = __ldg(reinterpret_cast<const uint4*>(s) + u);
  }
  __device__ __forceinline__ float at(int i) const { return bf16_at(v, i); }
};
template <> struct ScaleUnit<__half> {
  uint4 v;
  __device__ __forceinline__ void load(const __half* s, int u) {
    v = __ldg(reinterpret_cast<const uint4*>(s) + u);
  }
  __device__ __forceinline__ float at(int i) const {
    const uint32_t w = i < 2 ? v.x : i < 4 ? v.y : i < 6 ? v.z : v.w;
    return __half2float(__ushort_as_half((unsigned short)(i & 1 ? w >> 16 : w & 0xffffu)));
  }
};

// grid (ceil(rows / rows a block)), NORM_THREADS threads; x, scale and out
// 16-byte aligned
template <typename S>
__global__ void __launch_bounds__(NORM_THREADS)
rms_norm_rows_kernel(const __nv_bfloat16* __restrict__ x, const S* __restrict__ scale,
                     __nv_bfloat16* __restrict__ out, int rows, int D, float eps) {
  __shared__ float warp_sum[MAX_ROW_WARPS];
  const int rw = row_warps(D), warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * (MAX_ROW_WARPS / rw) + warp / rw, wr = warp % rw;
  const int units = D / 8;
  const bool live = row < rows;
  const uint4* xr = reinterpret_cast<const uint4*>(x + (size_t)(live ? row : 0) * D);
  uint4 v[LANE_UNITS];
  ScaleUnit<S> sc[LANE_UNITS];
#pragma unroll
  for (int j = 0; j < LANE_UNITS; ++j) {  // every load in flight at once, the scale's too
    const int u = (j * rw + wr) * 32 + lane;
    const bool in = live && u < units;
    v[j] = in ? __ldg(xr + u) : make_uint4(0u, 0u, 0u, 0u);
    if (in) sc[j].load(scale, u);
  }
  float acc = 0.f;  // units in order, values in order (zero units add exact zeros)
#pragma unroll
  for (int j = 0; j < LANE_UNITS; ++j)
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float f = bf16_at(v[j], i);
      acc = fmaf(f, f, acc);
    }
  // every lane ends with the same sum: each step adds two equal trees, a + b == b + a
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  float total = acc;
  if (rw > 1) {  // the row's warps in warp order
    if (lane == 0) warp_sum[warp] = acc;
    __syncthreads();
    const int first = warp - wr;
    total = warp_sum[first];
    for (int i = 1; i < rw; ++i) total += warp_sum[first + i];
  }
  const float f = 1.f / sqrtf(total / (float)D + eps);  // each step correctly rounded
  if (!live) return;
  uint4* yr = reinterpret_cast<uint4*>(out + (size_t)row * D);
#pragma unroll
  for (int j = 0; j < LANE_UNITS; ++j) {
    const int u = (j * rw + wr) * 32 + lane;
    if (u >= units) break;
    uint32_t y[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float lo = bf16_at(v[j], 2 * i) * f * sc[j].at(2 * i);
      const float hi = bf16_at(v[j], 2 * i + 1) * f * sc[j].at(2 * i + 1);
      y[i] = (uint32_t)__bfloat16_as_ushort(__float2bfloat16(lo)) |
             (uint32_t)__bfloat16_as_ushort(__float2bfloat16(hi)) << 16;
    }
    yr[u] = make_uint4(y[0], y[1], y[2], y[3]);
  }
}

template <typename S>
cudaError_t launch_rows(const void* x, const void* scale, void* out, int rows, int D, float eps,
                        cudaStream_t stream) {
  const int per_block = MAX_ROW_WARPS / row_warps(D);
  rms_norm_rows_kernel<S><<<(rows + per_block - 1) / per_block, NORM_THREADS, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const S*>(scale),
      static_cast<__nv_bfloat16*>(out), rows, D, eps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_scale(const void* x, const void* scale, void* out, int rows, int D,
                           float eps, int s_dtype, cudaStream_t s) {
  const bool rows_route = sizeof(T) == 2 && D % 8 == 0 && D <= 8192 &&
                          ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(scale) |
                            reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  switch (s_dtype) {
    case 0:
      return rows_route ? launch_rows<float>(x, scale, out, rows, D, eps, s)
                        : launch<T, float>(x, scale, out, rows, D, eps, s);
    case 1:
      return rows_route ? launch_rows<__nv_bfloat16>(x, scale, out, rows, D, eps, s)
                        : launch<T, __nv_bfloat16>(x, scale, out, rows, D, eps, s);
    case 2:
      return rows_route ? launch_rows<__half>(x, scale, out, rows, D, eps, s)
                        : launch<T, __half>(x, scale, out, rows, D, eps, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// x [rows, D] (x_dtype 0 = float32, 1 = bfloat16), scale [D] (s_dtype 0 =
// float32, 1 = bfloat16, 2 = float16), out [rows, D] of x's dtype; all
// contiguous.  bf16 x takes the warps-a-row route where D % 8 == 0, D <= 8192
// and x, scale and out are 16-byte aligned.  One launch; returns its
// cudaError_t.
extern "C" int rms_norm_fwd(const void* x, const void* scale, void* out, int rows, int D,
                            float eps, int x_dtype, int s_dtype, void* stream) {
  if (rows <= 0 || D <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0) return dispatch_scale<float>(x, scale, out, rows, D, eps, s_dtype, s);
  if (x_dtype == 1) return dispatch_scale<__nv_bfloat16>(x, scale, out, rows, D, eps, s_dtype, s);
  return cudaErrorInvalidValue;
}

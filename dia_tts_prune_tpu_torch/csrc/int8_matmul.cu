// Int8-weight matmul for the decode path, for Hopper (sm_90a).
//
// Replaces: dia_tts_prune_tpu/ops/kernels/int8_matmul.py — the Pallas kernel
// `_kernel` (:26, pallas_call :53).  Same function:
//   y[B, N] = (x[B, K] @ w_q[K, N]) * scale[N]
// with x in fp32 or bf16, w_q int8, fp32 accumulation, scales applied once to
// the fp32 sum and one rounding to x's dtype.  Activations stay unquantized.
//
// What bounds it on the H100: bytes.  With B <= 64 rows (2 in the decode step)
// every weight byte is used for 2*B operations, far below the ridge point, so
// the time is K*N weight bytes over the memory rate.  The TPU kernel tiles N
// only and holds a whole [K, 512] block in VMEM; here that would give a
// 2048 x 512 weight four blocks on 132 SMs.  So the weight is cut both ways:
// a block owns a strip of 32*VEC columns and a slice of K rows, each warp
// walks its rows of the slice with one VEC-byte load per lane (a warp reads
// 32*VEC consecutive bytes of a row), x's slice sits in shared memory, and
// the accumulators stay in registers.  A lane starts the loads of DEPTH rows
// before it uses the first: with one load in flight per warp the walk costs a
// memory latency per row, whatever the bytes.  (16-byte loads were measured
// too and were no faster than 4-byte ones at any of the model's shapes, so
// there is one vector width and a byte-wise form for an N or an address that
// 4 does not divide.)  Slices cannot add into one output
// without atomics, whose order would change the result from run to run, so
// each writes an fp32 partial and a second small kernel sums the partials in
// slice order, applies the scales and rounds.  With one slice the first
// kernel writes the output itself.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int NWARPS = 4;
constexpr int LANES = 32;
constexpr int KS_MAX = 1024;  // rows of x a block holds in shared memory
constexpr int DEPTH = 8;      // rows whose loads a lane has in flight

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ void widen4(uint32_t word, float* w) {
#pragma unroll
  for (int i = 0; i < 4; ++i) w[i] = (float)(int8_t)(word >> (8 * i));
}

// VEC int8 weights as loaded from p (aligned to VEC bytes), and as floats
template <int VEC> struct Raw;
template <> struct Raw<4> {
  uint32_t v;
  __device__ __forceinline__ void load(const int8_t* p) {
    v = __ldg(reinterpret_cast<const uint32_t*>(p));
  }
  __device__ __forceinline__ void widen(float* w) const { widen4(v, w); }
};
template <> struct Raw<1> {
  int8_t v;
  __device__ __forceinline__ void load(const int8_t* p) { v = __ldg(p); }
  __device__ __forceinline__ void widen(float* w) const { w[0] = (float)v; }
};

// grid (column strips, K slices, row tiles); N % VEC == 0, so a lane's VEC
// columns lie wholly inside the weight or wholly outside
template <typename T, int VEC, int ROWS>
__global__ void __launch_bounds__(NWARPS * LANES)
int8_matmul_kernel(const T* __restrict__ x, const int8_t* __restrict__ w,
                   const float* __restrict__ scale, T* __restrict__ out,
                   float* __restrict__ part, int B, int K, int N, int slice) {
  __shared__ float x_s[ROWS][KS_MAX];
  __shared__ float red[NWARPS - 1][ROWS][VEC][LANES];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int col = (blockIdx.x * LANES + lane) * VEC;
  const int k0 = blockIdx.y * slice;
  const int k1 = min(K, k0 + slice);
  const int len = max(k1 - k0, 0);
  const int b0 = blockIdx.z * ROWS;

  for (int i = tid; i < ROWS * len; i += NWARPS * LANES) {
    const int r = i / len, k = i % len;
    x_s[r][k] = b0 + r < B ? to_f(x[(size_t)(b0 + r) * K + k0 + k]) : 0.f;
  }
  __syncthreads();

  float acc[ROWS][VEC];
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[r][j] = 0.f;

  if (col < N) {
    const int8_t* wp = w + (size_t)k0 * N + col;
    for (int k = warp; k < len; k += NWARPS * DEPTH) {
      Raw<VEC> raw[DEPTH];
#pragma unroll
      for (int u = 0; u < DEPTH; ++u)  // the warp's rows k, k + NWARPS, ...: all loads first
        if (k + u * NWARPS < len) raw[u].load(wp + (size_t)(k + u * NWARPS) * N);
#pragma unroll
      for (int u = 0; u < DEPTH; ++u) {
        const int kk = k + u * NWARPS;
        if (kk >= len) break;
        float wf[VEC];
        raw[u].widen(wf);
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          const float xv = x_s[r][kk];
#pragma unroll
          for (int j = 0; j < VEC; ++j) acc[r][j] = fmaf(xv, wf[j], acc[r][j]);
        }
      }
    }
  }

  // the block's warps hold sums over interleaved rows: add them in warp order
  if (warp > 0) {
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
#pragma unroll
      for (int j = 0; j < VEC; ++j) red[warp - 1][r][j][lane] = acc[r][j];
  }
  __syncthreads();
  if (warp != 0 || col >= N) return;
  const bool direct = gridDim.y == 1;
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    if (b0 + r >= B) break;
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      float v = acc[r][j];
#pragma unroll
      for (int wi = 0; wi < NWARPS - 1; ++wi) v += red[wi][r][j][lane];
      const size_t o = (size_t)(b0 + r) * N + col + j;
      if (direct)
        out[o] = from_f<T>(v * scale[col + j]);
      else
        part[(size_t)blockIdx.y * B * N + o] = v;
    }
  }
}

// out[b, n] = round(sum over slices of part[s, b, n], times scale[n])
template <typename T>
__global__ void int8_matmul_finish(const float* __restrict__ part,
                                   const float* __restrict__ scale, T* __restrict__ out,
                                   int BN, int N, int n_split) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= BN) return;
  float v = 0.f;
  for (int s = 0; s < n_split; ++s) v += part[(size_t)s * BN + i];
  out[i] = from_f<T>(v * scale[i % N]);
}

template <typename T, int VEC, int ROWS>
cudaError_t launch(const void* x, const void* w, const void* scale, void* out, float* part,
                   int B, int K, int N, int n_split, cudaStream_t stream) {
  const int slice = (K + n_split - 1) / n_split;
  const dim3 grid((N + LANES * VEC - 1) / (LANES * VEC), n_split, (B + ROWS - 1) / ROWS);
  int8_matmul_kernel<T, VEC, ROWS><<<grid, NWARPS * LANES, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const int8_t*>(w), static_cast<const float*>(scale),
      static_cast<T*>(out), part, B, K, N, slice);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_split == 1) return err;
  const int BN = B * N;
  int8_matmul_finish<T><<<(BN + 255) / 256, 256, 0, stream>>>(
      part, static_cast<const float*>(scale), static_cast<T*>(out), BN, N, n_split);
  return cudaGetLastError();
}

template <typename T, int VEC>
cudaError_t dispatch_rows(const void* x, const void* w, const void* scale, void* out,
                          float* part, int B, int K, int N, int n_split, cudaStream_t stream) {
  if (B <= 2) return launch<T, VEC, 2>(x, w, scale, out, part, B, K, N, n_split, stream);
  return launch<T, VEC, 4>(x, w, scale, out, part, B, K, N, n_split, stream);
}

template <typename T>
cudaError_t dispatch_vec(int vec, const void* x, const void* w, const void* scale, void* out,
                         float* part, int B, int K, int N, int n_split, cudaStream_t stream) {
  switch (vec) {
    case 4: return dispatch_rows<T, 4>(x, w, scale, out, part, B, K, N, n_split, stream);
    case 1: return dispatch_rows<T, 1>(x, w, scale, out, part, B, K, N, n_split, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// x [B,K] (dtype 0 = float32, 1 = bfloat16), w int8 [K,N], scale fp32 [N], out
// [B,N] in x's dtype, part fp32 scratch of n_split*B*N floats (unused when
// n_split == 1).  All contiguous.  vec in {4, 1} must divide N and w's
// address; ceil(K / n_split) must not exceed 1024.  Returns the launches'
// cudaError_t.
extern "C" int int8_matmul_fwd(const void* x, const void* w, const void* scale, void* out,
                               void* part, int B, int K, int N, int vec, int n_split, int dtype,
                               void* stream) {
  if (B <= 0 || K <= 0 || N <= 0 || n_split <= 0 || vec <= 0 || N % vec != 0 ||
      reinterpret_cast<uintptr_t>(w) % vec != 0 || (K + n_split - 1) / n_split > KS_MAX)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(part);
  if (dtype == 0) return dispatch_vec<float>(vec, x, w, scale, out, p, B, K, N, n_split, s);
  if (dtype == 1)
    return dispatch_vec<__nv_bfloat16>(vec, x, w, scale, out, p, B, K, N, n_split, s);
  return cudaErrorInvalidValue;
}

// Block-sparse matmul for pruned weights, for Hopper (sm_90a).
//
// Replaces: dia_tts_prune_tpu/ops/kernels/sparse_matmul.py — the Pallas kernel
// `block_sparse_matmul` (:89, pallas_call :121).  Same function:
//   y[m, n] = sum over the listed K-blocks b of n's N-tile j
//             of x[m, b*block_k : (b+1)*block_k] @ w[b*block_k : ..., n]
// with the weight stored dense and zero-filled ([K, N], x's dtype: fp32 or
// bf16), indices[j, s] the K-block of slot s of tile j (s < counts[j]; slots
// past the count are never read), fp32 accumulation and one rounding to x's
// dtype.  A tile with no listed block gives exact zeros.
//
// What bounds it on the H100: bytes.  The decode step multiplies 2 rows by
// each weight, far below the ridge point, so the time is the listed blocks'
// bytes (density * K * N * 2 in bf16) over the memory rate; reading only those
// blocks is the point of the kernel, as skipping their DMAs is the point of
// the TPU one.  The design is int8_matmul.cu's: a block owns a strip of
// 32*VEC columns inside one N-tile and a slice of that tile's listed rows
// (its "virtual" rows: slot s, row r in the block -> weight row
// indices[j, s]*block_k + r), loads its own counts[j] and indices (there is
// no scalar prefetch), maps the slice's rows to weight rows and gathers the
// matching x values into shared memory, and walks only those rows, DEPTH
// rows of loads in flight per lane.  Each weight load serves the ROWS rows of
// a row tile, accumulated in fp32 registers.  Slices write fp32 partials that
// a second small kernel sums in slice order (no atomics: the output is the
// same from run to run).  The split into slices depends on K, N and the plan,
// never on the row count, and each row's sums run in the same order whatever
// rows ride with it, so a row's result does not depend on M.  Rows beyond
// one tile are further row tiles (grid.z), each re-reading the weight: the
// prompt prefill and the cross K/V projection (M in the hundreds) are slow
// here on FMAs; tensor-core tiles are later work.  A ragged last K block and a
// ragged last N tile are bounds checks: rows past K map to no row and read
// nothing, columns past N are idle lanes.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int NWARPS = 4;
constexpr int LANES = 32;
constexpr int KS_MAX = 1024;  // virtual rows a block holds in shared memory
constexpr int DEPTH = 8;      // rows whose loads a lane has in flight

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
// a bf16 is the high half of the fp32 with the same value
__device__ __forceinline__ float bf16_bits(uint32_t b) { return __uint_as_float(b << 16); }

// VEC weights of type T as loaded from p (aligned to their size), and as floats
template <typename T, int VEC> struct Raw;
template <> struct Raw<float, 1> {
  float v;
  __device__ __forceinline__ void load(const float* p) { v = __ldg(p); }
  __device__ __forceinline__ void zero() { v = 0.f; }
  __device__ __forceinline__ void widen(float* w) const { w[0] = v; }
};
template <> struct Raw<__nv_bfloat16, 2> {
  uint32_t v;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    v = __ldg(reinterpret_cast<const unsigned int*>(p));
  }
  __device__ __forceinline__ void zero() { v = 0u; }
  __device__ __forceinline__ void widen(float* w) const {
    w[0] = bf16_bits(v & 0xffffu);
    w[1] = bf16_bits(v >> 16);
  }
};
template <> struct Raw<__nv_bfloat16, 1> {
  unsigned short v;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    v = __ldg(reinterpret_cast<const unsigned short*>(p));
  }
  __device__ __forceinline__ void zero() { v = 0; }
  __device__ __forceinline__ void widen(float* w) const { w[0] = bf16_bits(v); }
};

// grid (N-tiles x strips per tile, slices, row tiles).  N and block_n are
// multiples of VEC, so a lane's VEC columns lie wholly inside its tile or
// wholly outside.
template <typename T, int VEC, int ROWS>
__global__ void __launch_bounds__(NWARPS * LANES)
block_sparse_matmul_kernel(const T* __restrict__ x, const T* __restrict__ w,
                           const int* __restrict__ indices, const int* __restrict__ counts,
                           T* __restrict__ out, float* __restrict__ part, int M, int K, int N,
                           int block_k, int block_n, int max_blocks, int strips, int slice) {
  __shared__ float x_s[ROWS][KS_MAX];
  __shared__ int row_s[KS_MAX];  // weight row of each virtual row of the slice, or -1
  __shared__ float red[NWARPS - 1][ROWS][VEC][LANES];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int tile = blockIdx.x / strips;
  const int tile_end = min(N, (tile + 1) * block_n);
  const int col = tile * block_n + ((blockIdx.x % strips) * LANES + lane) * VEC;
  const int v0 = blockIdx.y * slice;
  const int len = max(min(counts[tile] * block_k, v0 + slice) - v0, 0);
  const int b0 = blockIdx.z * ROWS;
  const int* ids = indices + (size_t)tile * max_blocks;

  for (int i = tid; i < len; i += NWARPS * LANES) {
    const int v = v0 + i;
    const int k = ids[v / block_k] * block_k + v % block_k;
    row_s[i] = k < K ? k : -1;
  }
  __syncthreads();
  for (int i = tid; i < ROWS * len; i += NWARPS * LANES) {
    const int r = i / len, kk = i % len;
    const int k = row_s[kk];
    x_s[r][kk] = b0 + r < M && k >= 0 ? to_f(x[(size_t)(b0 + r) * K + k]) : 0.f;
  }
  __syncthreads();

  float acc[ROWS][VEC];
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[r][j] = 0.f;

  if (col < tile_end) {
    const T* wp = w + col;
    for (int k = warp; k < len; k += NWARPS * DEPTH) {
      Raw<T, VEC> raw[DEPTH];
#pragma unroll
      for (int u = 0; u < DEPTH; ++u) {  // the warp's rows k, k + NWARPS, ...: all loads first
        const int kk = k + u * NWARPS;
        const int kr = kk < len ? row_s[kk] : -1;
        if (kr >= 0)
          raw[u].load(wp + (size_t)kr * N);
        else
          raw[u].zero();
      }
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
  if (warp != 0 || col >= tile_end) return;
  const bool direct = gridDim.y == 1;
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    if (b0 + r >= M) break;
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      float v = acc[r][j];
#pragma unroll
      for (int wi = 0; wi < NWARPS - 1; ++wi) v += red[wi][r][j][lane];
      const size_t o = (size_t)(b0 + r) * N + col + j;
      if (direct)
        out[o] = from_f<T>(v);
      else
        part[(size_t)blockIdx.y * M * N + o] = v;
    }
  }
}

// out[m, n] = round(sum over slices of part[s, m, n])
template <typename T>
__global__ void block_sparse_matmul_finish(const float* __restrict__ part, T* __restrict__ out,
                                           size_t MN, int n_split) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= MN) return;
  float v = 0.f;
  for (int s = 0; s < n_split; ++s) v += part[(size_t)s * MN + i];
  out[i] = from_f<T>(v);
}

template <typename T, int VEC, int ROWS>
cudaError_t launch(const void* x, const void* w, const int* indices, const int* counts, void* out,
                   float* part, int M, int K, int N, int block_k, int block_n, int max_blocks,
                   int n_split, cudaStream_t stream) {
  const int strips = (block_n + LANES * VEC - 1) / (LANES * VEC);
  const int n_tiles = (N + block_n - 1) / block_n;
  const int slice = (max_blocks * block_k + n_split - 1) / n_split;
  const dim3 grid(n_tiles * strips, n_split, (M + ROWS - 1) / ROWS);
  block_sparse_matmul_kernel<T, VEC, ROWS><<<grid, NWARPS * LANES, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), indices, counts, static_cast<T*>(out),
      part, M, K, N, block_k, block_n, max_blocks, strips, slice);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_split == 1) return err;
  const size_t MN = (size_t)M * N;
  block_sparse_matmul_finish<T><<<(unsigned)((MN + 255) / 256), 256, 0, stream>>>(
      part, static_cast<T*>(out), MN, n_split);
  return cudaGetLastError();
}

template <typename T, int VEC>
cudaError_t dispatch_rows(const void* x, const void* w, const int* indices, const int* counts,
                          void* out, float* part, int M, int K, int N, int block_k, int block_n,
                          int max_blocks, int n_split, cudaStream_t s) {
  if (M <= 2)
    return launch<T, VEC, 2>(x, w, indices, counts, out, part, M, K, N, block_k, block_n,
                             max_blocks, n_split, s);
  return launch<T, VEC, 8>(x, w, indices, counts, out, part, M, K, N, block_k, block_n,
                           max_blocks, n_split, s);
}

}  // namespace

// x [M,K] and w [K,N] in one dtype (0 = float32, 1 = bfloat16), indices int32
// [ceil(N/block_n), max_blocks], counts int32 [ceil(N/block_n)], out [M,N] in
// that dtype, part fp32 scratch of n_split*M*N floats (unused when n_split ==
// 1).  All contiguous.  vec: columns a lane loads at once, 1 for float32, 2 or
// 1 for bfloat16; it must divide N and block_n, and vec * element size must
// divide w's address.  ceil(max_blocks * block_k / n_split) must not exceed
// 1024.  Returns the launches' cudaError_t.
extern "C" int block_sparse_matmul_fwd(const void* x, const void* w, const void* indices,
                                       const void* counts, void* out, void* part, int M, int K,
                                       int N, int block_k, int block_n, int max_blocks, int vec,
                                       int n_split, int dtype, void* stream) {
  const int esize = dtype == 0 ? 4 : 2;
  if (M <= 0 || K <= 0 || N <= 0 || block_k <= 0 || block_n <= 0 || max_blocks <= 0 ||
      n_split <= 0 || vec <= 0 || N % vec != 0 || block_n % vec != 0 ||
      reinterpret_cast<uintptr_t>(w) % (vec * esize) != 0 ||
      ((long long)max_blocks * block_k + n_split - 1) / n_split > KS_MAX)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* ix = static_cast<const int*>(indices);
  const int* cn = static_cast<const int*>(counts);
  float* p = static_cast<float*>(part);
  if (dtype == 0 && vec == 1)
    return dispatch_rows<float, 1>(x, w, ix, cn, out, p, M, K, N, block_k, block_n, max_blocks,
                                   n_split, s);
  if (dtype == 1 && vec == 2)
    return dispatch_rows<__nv_bfloat16, 2>(x, w, ix, cn, out, p, M, K, N, block_k, block_n,
                                           max_blocks, n_split, s);
  if (dtype == 1 && vec == 1)
    return dispatch_rows<__nv_bfloat16, 1>(x, w, ix, cn, out, p, M, K, N, block_k, block_n,
                                           max_blocks, n_split, s);
  return cudaErrorInvalidValue;
}

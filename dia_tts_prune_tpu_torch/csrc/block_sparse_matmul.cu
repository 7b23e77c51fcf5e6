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
// Both routes walk a tile's "virtual" rows: slot s, row r -> weight row
// indices[j, s]*block_k + r; v < counts[j]*block_k.  A block loads its own
// counts[j] and indices (there is no scalar prefetch) and reads only listed
// blocks.  A ragged last K block and a ragged last N tile are bounds checks:
// rows past K map to no row and read nothing, columns past the tile are
// zero-filled and never written.  The virtual rows of a tile are cut into
// slices whose bounds depend on K, N, the blocks and the plan, never on the
// row count; each slice's sum is an fp32 partial, and the partials are added
// in slice order (0 + p0 + p1 + ...).  No atomics: the output is the same from
// run to run, and a row's result does not depend on which rows ride with it.
//
// What bounds it on the H100: bytes at decode (2 rows against each weight, far
// below the ridge point: the listed blocks' bytes, density * K * N * 2 in
// bf16, over the memory rate), operations near the ridge at prefill and cross
// K/V sizes (hundreds of rows).
//
// bf16: tensor cores (bsm_mma_kernel).  A block owns an output tile of BMR
// rows by an SN-column strip inside one N-tile (16 x 64 with 4 warps up to 16
// rows, 64 x 64 up to 64 rows, 128 x 128 with 8 warps beyond) and walks its
// virtual rows KC at a time through a cp.async ring of STAGES stages: the
// listed weight rows ([k][n], row-major) and the matching x columns, gathered
// by the same row map; rows past M and virtual rows past the slice are
// zero-filled by cp.async with source size 0.  x enters as A fragments
// through ldmatrix, the weight as B fragments through ldmatrix.trans, and
// mma.sync m16n8k16 sums each 16-row step in fp32 (bf16 products are exact).
// Every element's sum is the same chain whatever the tile shape: per slice, a
// fresh accumulator over the slice's 16-row steps in order.  How slices map to
// blocks depends on M: at small M each slice is a block of its own, writing
// its partial, and a finish pass adds them in slice order (or the one slice
// writes the output); at large M, where the row tiles alone fill the card, a
// block runs every slice of its tile itself, adding each slice's accumulator
// to a running total in slice order — the finish pass's bits without partials
// in device memory.  The plan (tile shape, slices to blocks, load width) is
// the wrapper's (ops/kernels/sparse_matmul.py::mma_plan).  Copies move units of
// 8 values (16 bytes, or two 8-byte halves where a row of a weight whose N is
// not a multiple of 8 starts 8 bytes off) where N, K, both block sides and the
// pointers allow it, else single elements (odd shapes only).
//
// fp32: CUDA cores (block_sparse_matmul_kernel), true fp32 (no TF32): the
// int8_matmul.cu skeleton.  A block owns a strip of 32 columns inside one
// N-tile and a slice of that tile's virtual rows, maps them to weight rows and
// gathers the matching x values into shared memory, and walks only those
// rows, DEPTH rows of loads in flight per lane; each weight load serves ROWS
// rows of a row tile (grid.z), accumulated in fp32 registers.
#include <algorithm>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "mma_tiles.cuh"

namespace {

constexpr int NWARPS = 4;
constexpr int LANES = 32;
constexpr int KS_MAX = 1024;  // virtual rows a block holds in shared memory (fp32 route)
constexpr int DEPTH = 8;      // rows whose loads a lane has in flight (fp32 route)
constexpr int SLICE_ALIGN = 64;  // bf16 slices start at multiples of 64 virtual rows

// grid (N-tiles x strips per tile, slices, row tiles).
template <int ROWS>
__global__ void __launch_bounds__(NWARPS * LANES)
block_sparse_matmul_kernel(const float* __restrict__ x, const float* __restrict__ w,
                           const int* __restrict__ indices, const int* __restrict__ counts,
                           float* __restrict__ out, float* __restrict__ part, int M, int K, int N,
                           int block_k, int block_n, int max_blocks, int strips, int slice) {
  __shared__ float x_s[ROWS][KS_MAX];
  __shared__ int row_s[KS_MAX];  // weight row of each virtual row of the slice, or -1
  __shared__ float red[NWARPS - 1][ROWS][LANES];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int tile = blockIdx.x / strips;
  const int tile_end = min(N, (tile + 1) * block_n);
  const int col = tile * block_n + (blockIdx.x % strips) * LANES + lane;
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
    x_s[r][kk] = b0 + r < M && k >= 0 ? x[(size_t)(b0 + r) * K + k] : 0.f;
  }
  __syncthreads();

  float acc[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) acc[r] = 0.f;

  if (col < tile_end) {
    const float* wp = w + col;
    for (int k = warp; k < len; k += NWARPS * DEPTH) {
      float raw[DEPTH];
#pragma unroll
      for (int u = 0; u < DEPTH; ++u) {  // the warp's rows k, k + NWARPS, ...: all loads first
        const int kk = k + u * NWARPS;
        const int kr = kk < len ? row_s[kk] : -1;
        raw[u] = kr >= 0 ? __ldg(wp + (size_t)kr * N) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < DEPTH; ++u) {
        const int kk = k + u * NWARPS;
        if (kk >= len) break;
#pragma unroll
        for (int r = 0; r < ROWS; ++r) acc[r] = fmaf(x_s[r][kk], raw[u], acc[r]);
      }
    }
  }

  // the block's warps hold sums over interleaved rows: add them in warp order
  if (warp > 0) {
#pragma unroll
    for (int r = 0; r < ROWS; ++r) red[warp - 1][r][lane] = acc[r];
  }
  __syncthreads();
  if (warp != 0 || col >= tile_end) return;
  const bool direct = gridDim.y == 1;
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    if (b0 + r >= M) break;
    float v = acc[r];
#pragma unroll
    for (int wi = 0; wi < NWARPS - 1; ++wi) v += red[wi][r][lane];
    const size_t o = (size_t)(b0 + r) * N + col;
    if (direct)
      out[o] = v;
    else
      part[(size_t)blockIdx.y * M * N + o] = v;
  }
}

__device__ __forceinline__ float to_out(float v, float*) { return v; }
__device__ __forceinline__ __nv_bfloat16 to_out(float v, __nv_bfloat16*) {
  return __float2bfloat16(v);
}

// out[m, n] = round(sum over slices of part[s, m, n]), in slice order
template <typename T>
__global__ void block_sparse_matmul_finish(const float* __restrict__ part, T* __restrict__ out,
                                           size_t MN, int n_split) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= MN) return;
  float v = 0.f;
  for (int s = 0; s < n_split; ++s) v += part[(size_t)s * MN + i];
  out[i] = to_out(v, out);
}

template <typename T>
cudaError_t finish(const float* part, void* out, int M, int N, int n_split, cudaStream_t stream) {
  const size_t MN = (size_t)M * N;
  block_sparse_matmul_finish<T><<<(unsigned)((MN + 255) / 256), 256, 0, stream>>>(
      part, static_cast<T*>(out), MN, n_split);
  return cudaGetLastError();
}

template <int ROWS>
cudaError_t launch_fp32(const float* x, const float* w, const int* indices, const int* counts,
                        float* out, float* part, int M, int K, int N, int block_k, int block_n,
                        int max_blocks, int n_split, cudaStream_t stream) {
  const int strips = (block_n + LANES - 1) / LANES;
  const int n_tiles = (N + block_n - 1) / block_n;
  const int slice = (max_blocks * block_k + n_split - 1) / n_split;
  const dim3 grid(n_tiles * strips, n_split, (M + ROWS - 1) / ROWS);
  block_sparse_matmul_kernel<ROWS><<<grid, NWARPS * LANES, 0, stream>>>(
      x, w, indices, counts, out, part, M, K, N, block_k, block_n, max_blocks, strips, slice);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_split == 1) return err;
  return finish<float>(part, out, M, N, n_split, stream);
}

// ---------------------------------------------------------------------------
// bf16: tensor-core tiles
// ---------------------------------------------------------------------------
namespace tc {

using namespace mma_tiles;
using bf16 = __nv_bfloat16;

// WR x WC warps, each computing TM x TN mma tiles of 16 rows x 8 columns; KC
// virtual rows a stage, STAGES stages in the ring.
template <int WR_, int WC_, int TM_, int TN_, int KC_, int STAGES_>
struct Cfg {
  static constexpr int WR = WR_, WC = WC_, TM = TM_, TN = TN_, KC = KC_, STAGES = STAGES_;
  static constexpr int THREADS = WR * WC * 32;
  static constexpr int BMR = WR * TM * 16;  // rows of the block's tile
  static constexpr int SN = WC * TN * 8;    // columns of its strip
  static constexpr int X_ELEMS = BMR * (KC + PAD);  // x stage [BMR][KC + PAD]
  static constexpr int W_ELEMS = KC * (SN + PAD);   // weight stage [KC][SN + PAD]
  static constexpr int SMEM = (int)sizeof(bf16) * STAGES * (X_ELEMS + W_ELEMS);
  static_assert(TN % 2 == 0 && SLICE_ALIGN % KC == 0 && KC % 16 == 0, "tile shape");
};
using Small = Cfg<1, 4, 1, 2, 64, 4>;   // 16 x 64, 4 warps: up to 16 rows (decode)
using Medium = Cfg<4, 1, 1, 8, 64, 3>;  // 64 x 64, 4 warps: up to 64 rows
using Large = Cfg<4, 2, 2, 8, 64, 4>;   // 128 x 128, 8 warps: prefill, cross K/V

// A unit of 8 bf16 values global -> shared: the first n (0..8) from src, the
// rest zeros, asynchronously.  dst is 16-byte aligned, src 8-byte aligned
// (ALIGNED16: 16-byte aligned); one 16-byte copy where src allows, else two of
// 8 bytes.  With n == 0 nothing is read.
template <bool ALIGNED16>
__device__ __forceinline__ void copy8(bf16* dst, const bf16* src, int n) {
  if (ALIGNED16 || (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
                 "l"(src), "r"(2 * n));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(smem_u32(dst)),
                 "l"(src), "r"(2 * min(n, 4)));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(smem_u32(dst + 4)),
                 "l"(n > 4 ? src + 4 : src), "r"(2 * max(n - 4, 0)));
  }
}

// grid (row tiles x column strips, slices (1 when FUSED)); blockIdx.x = row
// tile + row_tiles * strip, so the row tiles of a strip run side by side and
// share its weight through the L2.
template <typename C, int VEC, bool FUSED>
__global__ void __launch_bounds__(C::THREADS)
bsm_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
               const int* __restrict__ indices, const int* __restrict__ counts,
               bf16* __restrict__ out, float* __restrict__ part, int M, int K, int N,
               int block_k, int block_n, int max_blocks, int strips, int slice) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* x_s = reinterpret_cast<bf16*>(smem_raw);  // [STAGES][BMR][KC + PAD]
  bf16* w_s = x_s + C::STAGES * C::X_ELEMS;       // [STAGES][KC][SN + PAD]
  int* krow = reinterpret_cast<int*>(w_s + C::STAGES * C::W_ELEMS);  // [v_end - v_begin]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int row_tiles = (M + C::BMR - 1) / C::BMR;
  const int m0 = (blockIdx.x % row_tiles) * C::BMR, cs = blockIdx.x / row_tiles;
  const int tile = cs / strips;
  const int col0 = tile * block_n + (cs % strips) * C::SN;
  const int tile_end = min(N, (tile + 1) * block_n);
  const int len = counts[tile] * block_k;  // the tile's virtual rows
  // FUSED: every slice of the tile, one after another; else slice blockIdx.y
  const int v_begin = FUSED ? 0 : blockIdx.y * slice;
  const int v_end = FUSED ? len : min(len, v_begin + slice);
  const int* ids = indices + (size_t)tile * max_blocks;
  const int n_chunks = v_end > v_begin ? (v_end - v_begin + C::KC - 1) / C::KC : 0;

  // the weight row of each of the block's virtual rows, or -1 past K: one
  // division each, once, instead of one per copy
  for (int i = tid; i < v_end - v_begin; i += C::THREADS) {
    const int v = v_begin + i, kb = v / block_k;
    const int k = __ldg(ids + kb) * block_k + (v - kb * block_k);
    krow[i] = k < K ? k : -1;
  }
  // x rows past M: zeros in every stage, once (the copies skip them)
  for (int i = tid; i < C::STAGES * C::BMR * (C::KC / 8); i += C::THREADS) {
    const int r = i / (C::KC / 8) % C::BMR;
    if (m0 + r >= M)
      *reinterpret_cast<uint4*>(x_s + (i / (C::KC / 8)) * (C::KC + PAD) + i % (C::KC / 8) * 8) =
          make_uint4(0u, 0u, 0u, 0u);
  }
  __syncthreads();
  // weight row of virtual row v, or -1 past the slice or past K
  auto weight_row = [&](int v) { return v < v_end ? krow[v - v_begin] : -1; };
  auto load = [&](int c, int stage) {
    const int v0 = v_begin + c * C::KC;
    bf16* xs = x_s + stage * C::X_ELEMS;
    bf16* ws = w_s + stage * C::W_ELEMS;
    if constexpr (VEC == 1) {  // single elements, synchronously (odd shapes only)
      for (int i = tid; i < C::KC * C::SN; i += C::THREADS) {
        const int r = i / C::SN, col = col0 + i % C::SN;
        const int k = weight_row(v0 + r);
        ws[r * (C::SN + PAD) + i % C::SN] =
            k >= 0 && col < tile_end ? w[(size_t)k * N + col] : __float2bfloat16(0.f);
      }
      for (int i = tid; i < C::BMR * C::KC; i += C::THREADS) {
        const int r = i / C::KC, kv = i % C::KC, m = m0 + r;
        if (m >= M) continue;
        const int k = weight_row(v0 + kv);
        xs[r * (C::KC + PAD) + kv] = k >= 0 ? x[(size_t)m * K + k] : __float2bfloat16(0.f);
      }
    } else {  // units of 8 values (8 virtual rows of x lie in one K-block)
      constexpr int WPR = C::SN / 8;  // weight units per virtual row
#pragma unroll 4
      for (int i = tid; i < C::KC * WPR; i += C::THREADS) {
        const int r = i / WPR, col = col0 + (i % WPR) * 8;
        const int k = weight_row(v0 + r);
        const int n = k >= 0 ? min(8, tile_end - col) : 0;
        copy8<VEC == 8>(ws + r * (C::SN + PAD) + (i % WPR) * 8,
                        n > 0 ? w + (size_t)k * N + col : w, max(n, 0));
      }
      constexpr int XPR = C::KC / 8;  // x units per row
#pragma unroll 4
      for (int i = tid; i < C::BMR * XPR; i += C::THREADS) {
        const int r = i / XPR, kv = (i % XPR) * 8, m = m0 + r;
        if (m >= M) continue;
        const int k = weight_row(v0 + kv);
        const int n = k >= 0 ? min(8, K - k) : 0;
        copy8<VEC == 8>(xs + r * (C::KC + PAD) + kv, n > 0 ? x + (size_t)m * K + k : x, n);
      }
    }
  };

  const int wr = warp / C::WC, wc = warp % C::WC;
  float acc[C::TM][C::TN][4], total[C::TM][C::TN][4];  // total: FUSED only
#pragma unroll
  for (int tm = 0; tm < C::TM; ++tm)
#pragma unroll
    for (int tn = 0; tn < C::TN; ++tn)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[tm][tn][e] = 0.f;
  if constexpr (FUSED) {
#pragma unroll
    for (int tm = 0; tm < C::TM; ++tm)
#pragma unroll
      for (int tn = 0; tn < C::TN; ++tn)
#pragma unroll
        for (int e = 0; e < 4; ++e) total[tm][tn][e] = 0.f;
  }

#pragma unroll
  for (int s = 0; s < C::STAGES - 1; ++s) {
    if (s < n_chunks) load(s, s);
    cp_async_commit();
  }
  for (int c = 0; c < n_chunks; ++c) {
    cp_async_wait<C::STAGES - 2>();
    __syncthreads();  // chunk c landed; everyone is done with chunk c - 1's stage
    if (c + C::STAGES - 1 < n_chunks) load(c + C::STAGES - 1, (c + C::STAGES - 1) % C::STAGES);
    cp_async_commit();
    const bf16* xs = x_s + (c % C::STAGES) * C::X_ELEMS + wr * C::TM * 16 * (C::KC + PAD);
    const bf16* ws = w_s + (c % C::STAGES) * C::W_ELEMS + wc * C::TN * 8;
    const int v0 = v_begin + c * C::KC;
#pragma unroll
    for (int kk = 0; kk < C::KC / 16; ++kk) {
      if (v0 + kk * 16 >= v_end) break;  // the same 16-row steps in every tile shape
      uint32_t a[C::TM][4];
#pragma unroll
      for (int tm = 0; tm < C::TM; ++tm)
        load_a<C::KC>(a[tm], xs + tm * 16 * (C::KC + PAD) + kk * 16, lane);
#pragma unroll
      for (int np = 0; np < C::TN / 2; ++np) {
        uint32_t b[4];
        load_b_kn<C::SN>(b, ws + kk * 16 * (C::SN + PAD) + np * 16, lane);
#pragma unroll
        for (int tm = 0; tm < C::TM; ++tm) {
          mma_bf16(acc[tm][2 * np], a[tm], b[0], b[1]);
          mma_bf16(acc[tm][2 * np + 1], a[tm], b[2], b[3]);
        }
      }
    }
    if constexpr (FUSED) {
      const int vn = v0 + C::KC;
      if (vn >= v_end || vn % slice == 0) {  // the end of a slice: fold it in, start afresh
#pragma unroll
        for (int tm = 0; tm < C::TM; ++tm)
#pragma unroll
          for (int tn = 0; tn < C::TN; ++tn)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              total[tm][tn][e] += acc[tm][tn][e];
              acc[tm][tn][e] = 0.f;
            }
      }
    }
  }

  // epilogue: rows g and g + 8, columns 2t and 2t + 1 of each mma tile
  const int g = lane >> 2, t = lane & 3;
  const bool to_part = !FUSED && gridDim.y > 1;
  float* part_s = part + (size_t)blockIdx.y * M * N;
#pragma unroll
  for (int tm = 0; tm < C::TM; ++tm)
#pragma unroll
    for (int tn = 0; tn < C::TN; ++tn)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + (wr * C::TM + tm) * 16 + g + 8 * h;
        const int col = col0 + (wc * C::TN + tn) * 8 + 2 * t;
        if (m >= M || col >= tile_end) continue;
        const float v0 = FUSED ? total[tm][tn][2 * h] : acc[tm][tn][2 * h];
        const float v1 = FUSED ? total[tm][tn][2 * h + 1] : acc[tm][tn][2 * h + 1];
        const size_t o = (size_t)m * N + col;
        if (VEC >= 4) {  // col + 1 lies in the tile too, and o is even
          if (to_part)
            *reinterpret_cast<float2*>(part_s + o) = make_float2(v0, v1);
          else
            *reinterpret_cast<__nv_bfloat162*>(out + o) = __floats2bfloat162_rn(v0, v1);
        } else {
          const bool two = col + 1 < tile_end;
          if (to_part) {
            part_s[o] = v0;
            if (two) part_s[o + 1] = v1;
          } else {
            out[o] = __float2bfloat16(v0);
            if (two) out[o + 1] = __float2bfloat16(v1);
          }
        }
      }
}

template <typename C, int VEC, bool FUSED>
cudaError_t launch(const bf16* x, const bf16* w, const int* indices, const int* counts, bf16* out,
                   float* part, int M, int K, int N, int block_k, int block_n, int max_blocks,
                   int n_split, cudaStream_t stream) {
  const int strips = (block_n + C::SN - 1) / C::SN;
  const int n_tiles = (N + block_n - 1) / block_n;
  const int rows = max_blocks * block_k;
  const int slice = ((rows + n_split - 1) / n_split + SLICE_ALIGN - 1) / SLICE_ALIGN * SLICE_ALIGN;
  // the stages and the row table of the block's virtual rows
  const int smem = C::SMEM + (int)sizeof(int) * (FUSED ? rows : std::min(rows, slice));
  auto kernel = bsm_mma_kernel<C, VEC, FUSED>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(((M + C::BMR - 1) / C::BMR) * n_tiles * strips, FUSED ? 1 : n_split);
  kernel<<<grid, C::THREADS, smem, stream>>>(x, w, indices, counts, out, part, M, K, N,
                                              block_k, block_n, max_blocks, strips, slice);
  err = cudaGetLastError();
  if (err != cudaSuccess || FUSED || n_split == 1) return err;
  return finish<bf16>(part, out, M, N, n_split, stream);
}

template <int VEC>
cudaError_t dispatch(int tile, bool fused, const bf16* x, const bf16* w, const int* indices,
                     const int* counts, bf16* out, float* part, int M, int K, int N, int block_k,
                     int block_n, int max_blocks, int n_split, cudaStream_t s) {
#define BSM_ARGS x, w, indices, counts, out, part, M, K, N, block_k, block_n, max_blocks, n_split, s
  if (tile == 0 && !fused) return launch<Small, VEC, false>(BSM_ARGS);
  if constexpr (VEC >= 4) {  // the wider tiles take only the wider loads
    if (tile == 1) return fused ? launch<Medium, VEC, true>(BSM_ARGS)
                                : launch<Medium, VEC, false>(BSM_ARGS);
    if (tile == 2) return fused ? launch<Large, VEC, true>(BSM_ARGS)
                                : launch<Large, VEC, false>(BSM_ARGS);
  }
#undef BSM_ARGS
  return cudaErrorInvalidValue;
}

}  // namespace tc

}  // namespace

// x [M,K] and w [K,N] in one dtype (0 = float32, 1 = bfloat16), indices int32
// [ceil(N/block_n), max_blocks], counts int32 [ceil(N/block_n)], out [M,N] in
// that dtype, part fp32 scratch of n_split*M*N floats (unused when n_split ==
// 1 or fused).  All contiguous.
//   float32: vec 1, tile 0, fused 0; ceil(max_blocks * block_k / n_split) must
//     not exceed 1024.
//   bfloat16: vec 8 or 4 (copies in units of 8 values, 16 bytes, or two halves
//     where a row starts 8 bytes off; vec must divide K, N and both x's and w's
//     addresses in elements, and 8 must divide block_k and block_n) or 1
//     (element loads); tile 0 (16 x 64), 1 (64 x 64) or 2 (128 x 128), the
//     wider two only with vec >= 4; fused 1: each block runs every slice of
//     its tile (tile 1 or 2).
// Returns the launches' cudaError_t.
extern "C" int block_sparse_matmul_fwd(const void* x, const void* w, const void* indices,
                                       const void* counts, void* out, void* part, int M, int K,
                                       int N, int block_k, int block_n, int max_blocks, int vec,
                                       int n_split, int dtype, int tile, int fused, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || block_k <= 0 || block_n <= 0 || max_blocks <= 0 ||
      n_split <= 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* ix = static_cast<const int*>(indices);
  const int* cn = static_cast<const int*>(counts);
  float* p = static_cast<float*>(part);
  if (dtype == 0) {
    if (vec != 1 || tile != 0 || fused != 0 ||
        ((long long)max_blocks * block_k + n_split - 1) / n_split > KS_MAX)
      return cudaErrorInvalidValue;
    const float* xf = static_cast<const float*>(x);
    const float* wf = static_cast<const float*>(w);
    float* of = static_cast<float*>(out);
    if (M <= 2)
      return launch_fp32<2>(xf, wf, ix, cn, of, p, M, K, N, block_k, block_n, max_blocks,
                            n_split, s);
    return launch_fp32<8>(xf, wf, ix, cn, of, p, M, K, N, block_k, block_n, max_blocks,
                          n_split, s);
  }
  if (dtype != 1 || (vec != 8 && vec != 4 && vec != 1) || K % vec != 0 || N % vec != 0 ||
      (vec > 1 && (block_k % 8 != 0 || block_n % 8 != 0)) ||
      reinterpret_cast<uintptr_t>(x) % (2 * vec) != 0 ||
      reinterpret_cast<uintptr_t>(w) % (2 * vec) != 0)
    return cudaErrorInvalidValue;
  using tc::bf16;
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* wb = static_cast<const bf16*>(w);
  bf16* ob = static_cast<bf16*>(out);
  const bool f = fused != 0;
  switch (vec) {
    case 8: return tc::dispatch<8>(tile, f, xb, wb, ix, cn, ob, p, M, K, N, block_k, block_n,
                                   max_blocks, n_split, s);
    case 4: return tc::dispatch<4>(tile, f, xb, wb, ix, cn, ob, p, M, K, N, block_k, block_n,
                                   max_blocks, n_split, s);
    default: return tc::dispatch<1>(tile, f, xb, wb, ix, cn, ob, p, M, K, N, block_k, block_n,
                                    max_blocks, n_split, s);
  }
}

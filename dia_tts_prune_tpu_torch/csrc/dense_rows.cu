// Float-weight product for the decode step's rows, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package computes these contractions
// with XLA (dia_tts_prune_tpu/ops/modules.py::dense_general, one dot_general).
// It exists because the port must give a decode row the same bits whatever
// the other rows of the call are: a continuous-batching lane must equal its
// solo run, and a speculative verify row the loop step at its slot.  cuBLAS
// picks its algorithm, and with it each output's sum order, by the problem
// size, so at another row count a row sums in another order.  Here the plan
// is read from the weight's shape alone.  Same function as dense_general:
//   y[M, N] = x[M, K] @ w[K, N]
// with x and w both fp32 or both bf16, fp32 sums, one rounding to x's dtype.
//
// What bounds it on the H100: bytes.  A decode step has 2 rows a stream (8
// with four streams, 80 with 40 continuous-batching lanes): every weight
// byte serves 2 * M / 2 operations in bf16, far below the ridge point, so the
// time is K*N weight bytes over the memory rate if the weight is read once
// and enough bytes are in flight, plus the fixed cost of a launch.
//
// bf16 (namespace tc, the decode path): TMA in, wgmma from shared memory.
// * A block owns a strip of STRIP columns and the K slice [rank * slice,
//   (rank + 1) * slice) of its cluster rank; the slices come from the plan of
//   (K, N) alone (`row_plan` in the wrapper) and are whole stages of KC rows.
// * One thread of the copying warpgroup issues, per stage, two 2D TMA boxes
//   of the weight (KC rows x 64 columns each) and one of x (the group's rows
//   x KC columns), all 128-byte swizzled, on a full mbarrier that expects
//   their bytes; the multiplying warpgroup frees a stage on an empty one.
//   Out-of-bounds boxes fill zeros: rows past K, columns past N, x's rows
//   past the group.  No thread spends an instruction on a weight byte.
// * y^T = W^T x^T: the weight box is wgmma's A operand straight from shared
//   memory (MN-major, as TMA lays a row-major [K, N] weight down: no
//   registers, no permutes), x's rows the B operand (K-major).  One wgmma a
//   column tile and k-step, m64nNk16 with N = the group's rows rounded up to
//   16: the weight is read from shared memory once for every row, and from
//   device memory once for up to GROUP_ROWS = 128 rows (grid.z walks the
//   groups).  A wgmma output element is the same sum of its own row and
//   column whatever N (the row-bits probe of chip_smoke.py holds it to that).
// * The logits head's rows are 18504 bytes, not a multiple of 16, so no
//   tensor map describes it as [K, N]; nor as [K / 2, 2N] (a box must start
//   at a multiple of 16 bytes, and every odd row starts 8 past one: TMA
//   stops the kernel with an illegal instruction).  Its weight comes by the
//   copying warpgroup's 8-byte cp.async into the same swizzled layout, each
//   thread always the same 8 bytes of every second row, with x by TMA.
// * Other weights that no tensor map can describe (odd widths, unaligned
//   views) take the copying warpgroup's cp.async (8 or 4 bytes) or single
//   values, x too.  A copying thread marks a stage full once its copies of
//   it have landed and been fenced for the async proxy.
// * After the loop the multiplying threads write their fp32 sums into the
//   ring, each owner's columns one run, and one thread copies each run into
//   slot `rank` of its owner's inbox by the bulk-copy engine (distributed
//   shared memory, completing on the owner's mbarrier); each block adds its
//   inbox in rank order, rounds once and writes.  A cluster of one writes
//   its sums itself.
// A row's bits never depend on M or on the other rows: an output's sum runs
// over the slices of (K, N), its k-steps from the slice start, the merge in
// rank order, and a wgmma output element depends on its own row and column.
//
// fp32 (the parity fixtures): CUDA cores, true fp32 FMAs (no TF32).  A block
// owns a strip of 32*VEC columns, a slice of K rows and ROWS rows of x (grid
// (strips, slices, row tiles)); each warp walks its rows of the slice with one
// VEC-float load per lane, x's slice sits in shared memory, the accumulators
// stay in registers; the warps add in warp order, each slice writes an fp32
// partial and a second small kernel sums the partials in slice order.  With
// one slice the first kernel writes the output itself.  The slices come from
// `split_plan` of (K, N); the row tile changes which rows share a block, not a
// row's sum order.
#include <cooperative_groups.h>
#include <cuda.h>  // CUtensorMap and its enums (types only: no -lcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <array>
#include <map>
#include <mutex>
#include <tuple>

#include "mma_tiles.cuh"

namespace cg = cooperative_groups;

namespace {

// ---------------------------------------------------------------------------
// fp32: CUDA cores
// ---------------------------------------------------------------------------
constexpr int NWARPS = 4;
constexpr int LANES = 32;
constexpr int KS_MAX = 1024;  // rows of x a block holds in shared memory
constexpr int DEPTH = 8;      // rows whose loads a lane has in flight

// VEC fp32 weights as loaded from p (aligned to 4 * VEC bytes)
template <int VEC> struct Raw;
template <> struct Raw<4> {
  float4 v;
  __device__ __forceinline__ void load(const float* p) {
    v = __ldg(reinterpret_cast<const float4*>(p));
  }
  __device__ __forceinline__ float at(int j) const {
    return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
  }
};
template <> struct Raw<1> {
  float v;
  __device__ __forceinline__ void load(const float* p) { v = __ldg(p); }
  __device__ __forceinline__ float at(int) const { return v; }
};

// grid (column strips, K slices, row tiles); N % VEC == 0, so a lane's VEC
// columns lie wholly inside the weight or wholly outside
template <int VEC, int ROWS>
__global__ void __launch_bounds__(NWARPS * LANES)
dense_rows_fp32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                       float* __restrict__ out, float* __restrict__ part, int B, int K, int N,
                       int slice) {
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
    x_s[r][k] = b0 + r < B ? x[(size_t)(b0 + r) * K + k0 + k] : 0.f;
  }
  __syncthreads();

  float acc[ROWS][VEC];
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[r][j] = 0.f;

  if (col < N) {
    const float* wp = w + (size_t)k0 * N + col;
    for (int k = warp; k < len; k += NWARPS * DEPTH) {
      Raw<VEC> raw[DEPTH];
#pragma unroll
      for (int u = 0; u < DEPTH; ++u)  // the warp's rows k, k + NWARPS, ...: all loads first
        if (k + u * NWARPS < len) raw[u].load(wp + (size_t)(k + u * NWARPS) * N);
#pragma unroll
      for (int u = 0; u < DEPTH; ++u) {
        const int kk = k + u * NWARPS;
        if (kk >= len) break;
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          const float xv = x_s[r][kk];
#pragma unroll
          for (int j = 0; j < VEC; ++j) acc[r][j] = fmaf(xv, raw[u].at(j), acc[r][j]);
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
        out[o] = v;
      else
        part[(size_t)blockIdx.y * B * N + o] = v;
    }
  }
}

// out[i] = sum over slices of part[s, i], in slice order
__global__ void dense_rows_finish(const float* __restrict__ part, float* __restrict__ out,
                                  size_t BN, int n_split) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= BN) return;
  float v = 0.f;
  for (int s = 0; s < n_split; ++s) v += part[(size_t)s * BN + i];
  out[i] = v;
}

template <int VEC, int ROWS>
cudaError_t launch_fp32(const float* x, const float* w, float* out, float* part, int B, int K,
                        int N, int n_split, int slice, cudaStream_t stream) {
  const dim3 grid((N + LANES * VEC - 1) / (LANES * VEC), n_split, (B + ROWS - 1) / ROWS);
  dense_rows_fp32_kernel<VEC, ROWS><<<grid, NWARPS * LANES, 0, stream>>>(x, w, out, part, B, K,
                                                                          N, slice);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_split == 1) return err;
  const size_t BN = (size_t)B * N;
  dense_rows_finish<<<(unsigned)((BN + 255) / 256), 256, 0, stream>>>(part, out, BN, n_split);
  return cudaGetLastError();
}

template <int VEC>
cudaError_t dispatch_fp32_rows(const float* x, const float* w, float* out, float* part, int B,
                               int K, int N, int n_split, int slice, cudaStream_t s) {
  if (B <= 2) return launch_fp32<VEC, 2>(x, w, out, part, B, K, N, n_split, slice, s);
  if (B <= 4) return launch_fp32<VEC, 4>(x, w, out, part, B, K, N, n_split, slice, s);
  return launch_fp32<VEC, 8>(x, w, out, part, B, K, N, n_split, slice, s);
}

// ---------------------------------------------------------------------------
// bf16: TMA in, wgmma from shared memory, one cluster launch
// ---------------------------------------------------------------------------
namespace tc {

using mma_tiles::bar_arrive;
using mma_tiles::bar_init;
using mma_tiles::bar_wait;
using mma_tiles::cp_async4;
using mma_tiles::cp_async16;
using mma_tiles::cp_async_commit;
using mma_tiles::cp_async_wait;
using mma_tiles::smem_u32;
using bf16 = __nv_bfloat16;

constexpr int STRIP = 128;       // columns of a block's strip: TILES wgmma A tiles
constexpr int TILE = 64;         // columns of one A tile and of one weight box (128 bytes)
constexpr int TILES = STRIP / TILE;
constexpr int KSTEP = 16;        // k of one wgmma
constexpr int KC = 64;           // weight rows (and x columns) a stage: x rows of 128 bytes
constexpr int STEPS = KC / KSTEP;
constexpr int ROW_TILE = 16;     // rows of x a row tile holds: a group's wgmma N is a multiple
constexpr int GROUP_ROWS = 128;  // rows of x a block multiplies (grid.z walks the groups)
constexpr int RING_BYTES = 128 * 1024;  // the ring's shared memory
constexpr int MAX_CLUSTER = 16;  // blocks of a cluster the entry takes (above 8: non-portable)
constexpr int CONSUMERS = 128;   // one warpgroup multiplies
constexpr int PRODUCERS = 128;   // one warpgroup copies (the TMA route: one of its threads)
constexpr int NT = CONSUMERS + PRODUCERS;
constexpr int BOX_BYTES = KC * TILE * 2;  // one weight box: KC rows of 128 bytes
constexpr int W_BYTES = TILES * BOX_BYTES;
constexpr int UNITS_8 = STRIP * 2 / 8;     // 8-byte units of a strip's weight row
constexpr int ROWS_8 = PRODUCERS / UNITS_8;  // rows of a stage the copying threads take at once

// How a stage's weight and x arrive:
// TMA: boxes of w [K, N] and of x [M, K] (the entry's vec 16);
// COPY8: w by the copying warpgroup's 8-byte cp.async (vec 8, x by TMA: the
//   logits head, whose rows of 18504 bytes no tensor map describes), each
//   thread always the same 8 bytes of a row, every ROWS_8-th row;
// THREADS: the copying warpgroup's cp.async units or single values of w and
//   x (vec 8, 4 or 2; odd shapes, unaligned views).
enum Route { TMA = 0, COPY8 = 1, THREADS = 2 };

// shared memory at TB row tiles (16 rows of x each), from a 1024-byte
// boundary (the swizzle's period): the ring of stages (the weight's boxes,
// then x's rows; after the loop the block's own sums), the barriers of its
// stages and of the inbox, then the inbox: the fp32 sums of every rank for
// the block's share of the strip's columns.  Sums are stored a column's rows
// contiguous, ROW_STRIDE apart (even, and not a multiple of 32).
template <int TB>
struct Smem {
  static constexpr int ROWS = ROW_TILE * TB;
  static constexpr int X_BYTES = ROWS * KC * 2;
  static constexpr int STAGE = W_BYTES + X_BYTES;
  static constexpr int STAGES = RING_BYTES / STAGE;
  static constexpr int ROW_STRIDE = ROWS + 2;
  static constexpr int SUMS = STRIP * ROW_STRIDE * 4;  // a strip's sums, or an inbox
  static constexpr int BARRIERS = STAGES * STAGE;  // full[STAGES], empty[STAGES], inbox_full
  static constexpr int INBOX = BARRIERS + ((2 * STAGES + 1) * 8 + 15) / 16 * 16;
  static constexpr int BYTES = INBOX + SUMS + 1024;  // + the alignment slack
  static_assert(STAGE % 1024 == 0, "swizzle-aligned stages");
  static_assert(STAGES >= 3, "the copying threads' lag of STAGES - 2 chunks");
  static_assert(SUMS <= STAGES * STAGE, "the block's sums fit the ring");
};

// byte offset of byte `b` of row `r` in rows of 128 bytes swizzled as TMA's
// SWIZZLE_128B writes them (the 16-byte chunk index XOR the row mod 8)
__device__ __forceinline__ int swz(int r, int b) {
  return r * 128 + ((((b >> 4) ^ (r & 7)) << 4) | (b & 15));
}

// wgmma descriptor of a 128-byte-swizzled operand at shared address `addr`:
// lbo / sbo bytes between 8-row groups (see the A and B operands below)
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (uint64_t)(lbo >> 4) << 16 |
         (uint64_t)(sbo >> 4) << 32 | 1ull << 62;
}

// d[64 columns x N rows] += A (weight, MN-major: trans-a 1) . B (x, K-major);
// d[4c + 2h + j] is column 16 warp + g + 8h, row 8c + 2t + j (lane 4g + t)
template <int N>
__device__ __forceinline__ void wgmma(float (&d)[N / 2], uint64_t da, uint64_t db);

template <>
__device__ __forceinline__ void wgmma<16>(float (&d)[8], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7},"
      "%8, %9, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma<32>(float (&d)[16], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15},"
      "%16, %17, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma<48>(float (&d)[24], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17,"
      "%18, %19, %20, %21, %22, %23},"
      "%24, %25, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma<64>(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17,"
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31},"
      "%32, %33, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma<80>(float (&d)[40], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %42, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17,"
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34,"
      "%35, %36, %37, %38, %39},"
      "%40, %41, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma<96>(float (&d)[48], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17,"
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34,"
      "%35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47},"
      "%48, %49, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma<112>(float (&d)[56], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %58, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n112k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17,"
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34,"
      "%35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51,"
      "%52, %53, %54, %55},"
      "%56, %57, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma<128>(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17,"
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34,"
      "%35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51,"
      "%52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63},"
      "%64, %65, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// keeps the compiler from touching the accumulators while wgmma owns them
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void bar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// box of a 2D tensor map at (c0 innermost, c1) into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, int c0, int c1,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_u32(bar))
      : "memory");
}

// the threads' own shared-memory writes, made visible to wgmma (the async proxy)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// grid (cluster, strips, row groups), clusters of (cluster, 1, 1), NT threads;
// TB row tiles of 16 (a group's rows <= 16 * TB: one wgmma of N = 16 * TB a
// column tile and k-step).  wmap (TMA): w [K, N] in boxes of KC rows x TILE
// columns; xmap (TMA, COPY8): x [M, K] in boxes of 16 * TB rows x KC columns;
// both 128-byte swizzled.  COPY8: w 8-byte aligned, N % 4 == 0.  THREADS:
// weight units of `vec` bytes (8: cp.async, w 8-byte aligned and N % 4 == 0;
// 4: cp.async, w 4-byte aligned and N % 2 == 0; 2: single values); x in
// 16-byte units (x16: K % 8 == 0, x 16-byte aligned) or single values.
template <int TB, int ROUTE>
__global__ void __launch_bounds__(NT)
dense_rows_wgmma_kernel(const __grid_constant__ CUtensorMap wmap,
                        const __grid_constant__ CUtensorMap xmap, const bf16* __restrict__ x,
                        const bf16* __restrict__ w, bf16* __restrict__ out, int M, int K, int N,
                        int slice, int vec, int x16) {
  using S = Smem<TB>;
  constexpr int STAGES = S::STAGES, RS = S::ROW_STRIDE, ROWS = S::ROWS;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S::BARRIERS);
  uint64_t* empty = full + STAGES;
  uint64_t* inbox_full = empty + STAGES;
  float* inbox = reinterpret_cast<float*>(smem + S::INBOX);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), n_ranks = (int)gridDim.x;  // grid.x: one cluster
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // this block's group of rows: the same plan for every group
  const int g0 = blockIdx.z * GROUP_ROWS, B = min(GROUP_ROWS, M - g0);
  const int col0 = blockIdx.y * STRIP;
  const int k0 = min(K, rank * slice), k1 = min(K, k0 + slice);
  const int n_chunks = (k1 - k0 + KC - 1) / KC;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      // the expect_tx arrive (TMA, COPY8) and every copying thread (COPY8, THREADS)
      bar_init(full + s, ROUTE == TMA ? 1 : ROUTE == COPY8 ? 1 + PRODUCERS : PRODUCERS);
      bar_init(empty + s, CONSUMERS / 32);  // every multiplying warp
    }
    // every rank's bulk copy of its sums into this block's inbox
    bar_init(inbox_full, 1);
    bar_expect_tx(inbox_full, S::SUMS);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (ROUTE != THREADS && tid == CONSUMERS) {
    if (ROUTE == TMA)
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&wmap))
                   : "memory");
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&xmap)) : "memory");
  }
  __syncthreads();
  // the other blocks' inboxes are written only once every block has started
  asm volatile("barrier.cluster.arrive.relaxed;\n" ::: "memory");
  float acc[TILES][8 * TB];
#pragma unroll
  for (int t = 0; t < TILES; ++t)
#pragma unroll
    for (int e = 0; e < 8 * TB; ++e) acc[t][e] = 0.f;

  if (tid >= CONSUMERS) {
    // Chunk c (weight rows k0 + c*KC ...) into stage c % STAGES once the
    // multiplying warpgroup is done with its last chunk.  Slices are whole
    // stages, so a stage passes its slice's end only at K: rows past K, x's
    // rows past the group and columns past N are zeros (TMA's out-of-bounds
    // fill, or the copies' zero fill).
    const int pt = tid - CONSUMERS;
    if constexpr (ROUTE == TMA) {
      if (pt == 0) {
        for (int c = 0; c < n_chunks; ++c) {
          const int s = c % STAGES, k = k0 + c * KC;
          if (c >= STAGES) bar_wait(empty + s, (c / STAGES - 1) & 1);
          unsigned char* st = smem + s * S::STAGE;
          bar_expect_tx(full + s, S::STAGE);
#pragma unroll
          for (int t = 0; t < TILES; ++t)
            tma_load(st + t * BOX_BYTES, &wmap, col0 + t * TILE, k, full + s);
          tma_load(st + W_BYTES, &xmap, k, g0, full + s);
        }
      }
    } else if constexpr (ROUTE == COPY8) {
      // Thread pt copies the 8 bytes at unit pt % UNITS_8 of rows pt / UNITS_8
      // + ROWS_8 * q of every stage: its source steps ROWS_8 rows, its
      // destination 128 * ROWS_8 bytes, the swizzle's row phase alternating
      // between two values.  Each thread marks chunk c full LAG chunks later,
      // once its copies of it have landed and been fenced for the async proxy;
      // thread 0 also brings x's box by TMA on the same barrier.
      constexpr int LAG = STAGES - 2, REPS = KC / ROWS_8;
      static_assert(ROWS_8 * UNITS_8 == PRODUCERS && 8 % ROWS_8 == 0 && REPS % 2 == 0, "");
      const int u = pt % UNITS_8, r0 = pt / UNITS_8, b = u % (UNITS_8 / TILES) * 8;
      const bool col_ok = col0 + 4 * u < N;  // N % 4 == 0: a unit is wholly in or out
      const uint32_t dst0 = u / (UNITS_8 / TILES) * BOX_BYTES + r0 * 128 + (b & 15),
                     even = (((b >> 4) ^ r0) << 4), odd = (((b >> 4) ^ (r0 + ROWS_8)) << 4);
      const bf16* src0 = w + (size_t)(k0 + r0) * N + col0 + 4 * u;
      for (int c = 0; c < n_chunks; ++c) {
        const int s = c % STAGES;
        if (c >= STAGES) bar_wait(empty + s, (c / STAGES - 1) & 1);
        const uint32_t st = smem_u32(smem + s * S::STAGE) + dst0;
        const bf16* src = src0 + (size_t)c * KC * N;
        const int rows_left = k1 - (k0 + c * KC) - r0;  // rows r0 + ROWS_8 q inside the slice
#pragma unroll
        for (int q = 0; q < REPS; ++q) {
          const bool ok = col_ok && ROWS_8 * q < rows_left;
          asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                           st + q * ROWS_8 * 128 + ((q & 1) ? odd : even)),
                       "l"(ok ? src + (size_t)q * ROWS_8 * N : w), "r"(ok ? 8 : 0));
        }
        cp_async_commit();
        if (pt == 0) {
          bar_expect_tx(full + s, S::X_BYTES);
          tma_load(smem + s * S::STAGE + W_BYTES, &xmap, k0 + c * KC, g0, full + s);
        }
        if (c >= LAG) {
          cp_async_wait<LAG>();
          fence_proxy_async();
          bar_arrive(full + (c - LAG) % STAGES);
        }
      }
      cp_async_wait<0>();
      fence_proxy_async();
      for (int c = max(0, n_chunks - LAG); c < n_chunks; ++c) bar_arrive(full + c % STAGES);
    } else {
      // Each copying thread marks chunk c full LAG chunks later, once its own
      // copies of it have landed and been fenced for the async proxy (LAG =
      // STAGES - 2: the multiplying warpgroup frees a stage one chunk late).
      constexpr int LAG = STAGES - 2;
      const int per = vec / 2, upr = STRIP / per;
      for (int c = 0; c < n_chunks; ++c) {
        const int s = c % STAGES, r0 = k0 + c * KC;
        if (c >= STAGES) bar_wait(empty + s, (c / STAGES - 1) & 1);
        unsigned char* st = smem + s * S::STAGE;
        for (int i = pt; i < KC * upr; i += PRODUCERS) {
          const int r = i / upr, cc = i % upr * per, k = r0 + r, col = col0 + cc;
          const bool ok = k < k1 && col < N;
          unsigned char* dst = st + cc / TILE * BOX_BYTES + swz(r, cc % TILE * 2);
          const bf16* src = ok ? w + (size_t)k * N + col : w;
          if (vec == 8)
            asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(smem_u32(dst)),
                         "l"(src), "r"(ok ? 8 : 0));
          else if (vec == 4)
            cp_async4(dst, src, ok);
          else
            *reinterpret_cast<bf16*>(dst) = ok ? *src : __float2bfloat16(0.f);
        }
        unsigned char* xs = st + W_BYTES;
        if (x16) {
          for (int i = pt; i < ROWS * (KC / 8); i += PRODUCERS) {
            const int n = i / (KC / 8), q = i % (KC / 8), k = r0 + q * 8;
            const bool ok = n < B && k < k1;
            cp_async16(xs + swz(n, q * 16), ok ? x + (size_t)(g0 + n) * K + k : x, ok);
          }
        } else {
          for (int i = pt; i < ROWS * KC; i += PRODUCERS) {
            const int n = i / KC, kk = i % KC, k = r0 + kk;
            *reinterpret_cast<bf16*>(xs + swz(n, kk * 2)) =
                n < B && k < k1 ? x[(size_t)(g0 + n) * K + k] : __float2bfloat16(0.f);
          }
        }
        cp_async_commit();
        if (c >= LAG) {
          cp_async_wait<LAG>();
          fence_proxy_async();
          bar_arrive(full + (c - LAG) % STAGES);
        }
      }
      cp_async_wait<0>();
      fence_proxy_async();
      for (int c = max(0, n_chunks - LAG); c < n_chunks; ++c) bar_arrive(full + c % STAGES);
    }
  } else {
    // The multiplying warpgroup: every k-step of every stage (rows past K are
    // zeros in both operands: they add exact zeros), so the same steps run at
    // every M; each step one wgmma a column tile over all the group's rows.
    // A: the weight box, KC rows of 64 columns (MN-major, 8-row k groups 1024
    // bytes apart, a k-step 2048 bytes on); B: x's rows of the stage
    // (K-major, 8-row groups 1024 bytes apart, a k-step 32 bytes on).
    // One wgmma group in flight across stages: stage c's products are
    // issued before stage c - 1's are waited for and its stage freed.
    const uint32_t base = smem_u32(smem);
    for (int c = 0; c < n_chunks; ++c) {
      const int s = c % STAGES;
      bar_wait(full + s, (c / STAGES) & 1);
      if constexpr (ROUTE != TMA) fence_proxy_async();
      __syncwarp();
      const uint32_t ws = base + s * S::STAGE, xs = ws + W_BYTES;
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < STEPS; ++kk)
#pragma unroll
        for (int t = 0; t < TILES; ++t) {
          const uint32_t a = ws + t * BOX_BYTES + kk * KSTEP * 128, b = xs + kk * KSTEP * 2;
          wgmma<ROW_TILE * TB>(acc[t], sw128_desc(a, 1024, 1024), sw128_desc(b, 16, 1024));
        }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
      __syncwarp();
      // this warp's reads of the previous stage are done
      if (c > 0 && lane == 0) bar_arrive(empty + (c - 1) % STAGES);
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
    for (int t = 0; t < TILES; ++t) fence_acc(acc[t]);
  }
  __syncwarp();
  asm volatile("barrier.cluster.wait;\n" ::: "memory");
  // a multiplying thread's sums: acc[t][4c + 2h + j] is column 16 warp + g +
  // 8h of tile t, row 8c + 2t4 + j of the group
  const int g = lane >> 2, t4 = lane & 3;
  if (n_ranks == 1) {  // no other rank: round and write
    if (tid < CONSUMERS) {
#pragma unroll
      for (int t = 0; t < TILES; ++t)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int col = col0 + t * TILE + 16 * warp + g + 8 * h;
          if (col >= N) continue;
#pragma unroll
          for (int c = 0; c < 2 * TB; ++c)
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              const int n = 8 * c + 2 * t4 + j;
              if (n < B)
                out[(size_t)(g0 + n) * N + col] = __float2bfloat16(acc[t][4 * c + 2 * h + j]);
            }
        }
    }
    return;
  }
  // block `rank` finishes columns [rank * cpr, (rank + 1) * cpr) of the strip
  const int cpr = STRIP / n_ranks;
  if (tid < CONSUMERS) {
    // the sums into the ring (every stage consumed), column cc's rows at
    // cc * RS: owner o's columns are one run, which one thread then copies
    // into slot `rank` of o's inbox by the bulk-copy engine
    float* sums = reinterpret_cast<float*>(smem);
    fence_proxy_async();
#pragma unroll
    for (int t = 0; t < TILES; ++t)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int cc = t * TILE + 16 * warp + g + 8 * h;
#pragma unroll
        for (int c = 0; c < 2 * TB; ++c) {
          const int n = 8 * c + 2 * t4;
          if (n < B)
            *reinterpret_cast<float2*>(sums + cc * RS + n) =
                make_float2(acc[t][4 * c + 2 * h], acc[t][4 * c + 2 * h + 1]);
        }
      }
    fence_proxy_async();
    asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS) : "memory");
    if (tid == 0) {
      const uint32_t bytes = cpr * RS * 4;
      for (int o = 0; o < n_ranks; ++o) {
        uint32_t dst, bar;
        asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
                     : "=r"(dst) : "r"(smem_u32(inbox + rank * cpr * RS)), "r"(o));
        asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
                     : "=r"(bar) : "r"(smem_u32(inbox_full)), "r"(o));
        asm volatile(
            "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes "
            "[%0], [%1], %2, [%3];\n" ::"r"(dst), "r"(smem_u32(sums + o * cpr * RS)), "r"(bytes),
            "r"(bar)
            : "memory");
      }
    }
  }
  bar_wait(inbox_full, 0);  // every rank's sums for this block's columns
  // this block's inbox is whole, so every copy into it is done; it leaves only
  // once every block's is, so no copy still reads its ring
  asm volatile("barrier.cluster.arrive;\n" ::: "memory");
  // the block's columns, every row: ranks in rank order, one rounding
  for (int i = tid; i < cpr * B; i += NT) {
    const int n = i / cpr, mc = i % cpr, col = col0 + rank * cpr + mc;
    if (col >= N) continue;
    float part[MAX_CLUSTER];
#pragma unroll
    for (int r = 0; r < MAX_CLUSTER; ++r)
      if (r < n_ranks) part[r] = inbox[(size_t)(r * cpr + mc) * RS + n];
    float v = part[0];
#pragma unroll
    for (int r = 1; r < MAX_CLUSTER; ++r)
      if (r < n_ranks) v += part[r];
    out[(size_t)(g0 + n) * N + col] = __float2bfloat16(v);
  }
  asm volatile("barrier.cluster.wait;\n" ::: "memory");
}

// cuTensorMapEncodeTiled, reached through the runtime's entry-point query
// (the library links no -lcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &q);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return err == cudaSuccess && q == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(p)
                                                                   : nullptr;
  }();
  return fn;
}

// The tensor map of a row-major bf16 [rows, cols] at ptr, boxes of box_rows
// rows x TILE columns, 128-byte swizzled, out-of-bounds elements zero; cached
// by (ptr, rows, cols, box_rows), all that the map holds.  False if no
// encoder is found or it refuses the map.
bool tensor_map(CUtensorMap* map, const void* ptr, int rows, int cols, int box_rows) {
  using Key = std::tuple<uintptr_t, int, int, int>;
  static std::mutex mu;
  static std::map<Key, std::array<uint64_t, 16>> cache;
  static_assert(sizeof(CUtensorMap) == 16 * sizeof(uint64_t), "a tensor map is 128 bytes");
  const Key key{reinterpret_cast<uintptr_t>(ptr), rows, cols, box_rows};
  std::lock_guard<std::mutex> lock(mu);
  const auto it = cache.find(key);
  if (it != cache.end()) {
    memcpy(map, it->second.data(), sizeof(CUtensorMap));
    return true;
  }
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {(cuuint32_t)TILE, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  if (encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims, strides, box,
             unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return false;
  if (cache.size() >= 4096) cache.clear();
  std::array<uint64_t, 16> bytes;
  memcpy(bytes.data(), map, sizeof(CUtensorMap));
  cache.emplace(key, bytes);
  return true;
}

template <int TB, int ROUTE>
cudaError_t launch(const CUtensorMap& wmap, const CUtensorMap& xmap, const bf16* x, const bf16* w,
                   bf16* out, int M, int K, int N, int cluster, int slice, int vec, int x16,
                   cudaStream_t stream) {
  const auto kernel = dense_rows_wgmma_kernel<TB, ROUTE>;
  constexpr int smem = Smem<TB>::BYTES;
  // the opt-ins (shared memory above 48 KB, clusters above 8), once per device (of the first 64)
  static unsigned long long configured = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64 || !(configured >> dev & 1ull)) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    if (dev < 64) configured |= 1ull << dev;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, (N + STRIP - 1) / STRIP, (M + GROUP_ROWS - 1) / GROUP_ROWS);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, wmap, xmap, x, w, out, M, K, N, slice, vec, x16);
  const cudaError_t last = cudaGetLastError();  // clear it: the next entry's check reads it
  return err != cudaSuccess ? err : last;
}

// row tiles of 16 of a group: its rows (at most GROUP_ROWS) rounded up
__host__ __device__ constexpr int row_tiles(int M) {
  return ((M < GROUP_ROWS ? M : GROUP_ROWS) + ROW_TILE - 1) / ROW_TILE;
}

template <int ROUTE>
cudaError_t dispatch_rows(const CUtensorMap& wmap, const CUtensorMap& xmap, const bf16* x,
                          const bf16* w, bf16* out, int M, int K, int N, int cluster, int slice,
                          int vec, int x16, cudaStream_t s) {
#define DENSE_ROWS_TB(TB)                                                                  \
  case TB:                                                                                 \
    return launch<TB, ROUTE>(wmap, xmap, x, w, out, M, K, N, cluster, slice, vec, x16, s);
  switch (row_tiles(M)) {
    DENSE_ROWS_TB(1)
    DENSE_ROWS_TB(2)
    DENSE_ROWS_TB(3)
    DENSE_ROWS_TB(4)
    DENSE_ROWS_TB(5)
    DENSE_ROWS_TB(6)
    DENSE_ROWS_TB(7)
    DENSE_ROWS_TB(8)
    default: return cudaErrorInvalidValue;
  }
#undef DENSE_ROWS_TB
}

cudaError_t forward(const bf16* x, const bf16* w, bf16* out, int M, int K, int N, int vec,
                    int cluster, int slice, cudaStream_t s) {
  const uintptr_t wa = reinterpret_cast<uintptr_t>(w), xa = reinterpret_cast<uintptr_t>(x);
  if (cluster > MAX_CLUSTER || STRIP % cluster != 0 || slice % KC != 0 || wa % 2 != 0)
    return cudaErrorInvalidValue;
  const int x16 = K % 8 == 0 && xa % 16 == 0;
  CUtensorMap wmap, xmap;
  memset(&wmap, 0, sizeof wmap);
  memset(&xmap, 0, sizeof xmap);
  switch (vec) {
    case 16:
      if (wa % 16 != 0 || N % 8 != 0 || !x16) return cudaErrorInvalidValue;
      if (!tensor_map(&wmap, w, K, N, KC) || !tensor_map(&xmap, x, M, K, ROW_TILE * row_tiles(M)))
        return cudaErrorNotSupported;
      return dispatch_rows<TMA>(wmap, xmap, x, w, out, M, K, N, cluster, slice, vec, x16, s);
    case 8:
      if (wa % 8 != 0 || N % 4 != 0) return cudaErrorInvalidValue;
      if (!x16) break;  // x by the copying threads too
      if (!tensor_map(&xmap, x, M, K, ROW_TILE * row_tiles(M))) return cudaErrorNotSupported;
      return dispatch_rows<COPY8>(wmap, xmap, x, w, out, M, K, N, cluster, slice, vec, x16, s);
    case 4:
      if (wa % 4 != 0 || N % 2 != 0) return cudaErrorInvalidValue;
      break;
    case 2: break;
    default: return cudaErrorInvalidValue;
  }
  return dispatch_rows<THREADS>(wmap, xmap, x, w, out, M, K, N, cluster, slice, vec, x16, s);
}

}  // namespace tc

}  // namespace

// x [M,K] and w [K,N] of one dtype (0 = float32, 1 = bfloat16), out [M,N] of
// it, M >= 1.  All contiguous.  vec: see below.  K is cut into n_split slices
// of `slice` rows (n_split * slice >= K).
// * dtype 1: vec 16 = TMA (w and x 16-byte aligned, N % 8 == 0, K % 8 == 0),
//   else bytes of a weight copy in {8, 4, 2} (8: w 8-byte aligned and N % 4
//   == 0, x by TMA where it can be; 4: w 4-byte aligned and N % 2 == 0); the
//   slices are the blocks of a
//   cluster (n_split a power of two <= 16), slice a multiple of 64 (KC); part
//   unused.  One launch; M in groups of 128 rows.
// * dtype 0: vec in {4, 1} floats a weight load (4: w 16-byte aligned and
//   N % 4 == 0); slice <= 1024; part is fp32 scratch of n_split*M*N floats
//   (unused when n_split == 1).  Two launches when n_split > 1.
// Returns the launches' cudaError_t.
extern "C" int dense_rows_fwd(const void* x, const void* w, void* out, void* part, int M, int K,
                              int N, int vec, int n_split, int slice, int dtype, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || n_split <= 0 || slice <= 0 || vec <= 0 ||
      (long)n_split * slice < K)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uintptr_t wa = reinterpret_cast<uintptr_t>(w);
  if (dtype == 1)
    return tc::forward(static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
                       static_cast<__nv_bfloat16*>(out), M, K, N, vec, n_split, slice, s);
  if (dtype != 0 || slice > KS_MAX || (n_split > 1 && part == nullptr))
    return cudaErrorInvalidValue;
  const auto* xf = static_cast<const float*>(x);
  const auto* wf = static_cast<const float*>(w);
  auto* of = static_cast<float*>(out);
  auto* p = static_cast<float*>(part);
  switch (vec) {
    case 4:
      if (wa % 16 != 0 || N % 4 != 0) return cudaErrorInvalidValue;
      return dispatch_fp32_rows<4>(xf, wf, of, p, M, K, N, n_split, slice, s);
    case 1: return dispatch_fp32_rows<1>(xf, wf, of, p, M, K, N, n_split, slice, s);
    default: return cudaErrorInvalidValue;
  }
}

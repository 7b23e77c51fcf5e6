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
// and enough bytes are in flight.
//
// bf16 (namespace tc, the decode path): the int8 matmul's tensor-core design
// (csrc/int8_matmul.cu) with a bf16 weight that needs no widening.
// * The weight sits in the 16-row operand of mma.sync.m16n8k16 and x in the
//   8-wide one (y^T = W^T x^T): a multiplying warp owns 32 columns (two
//   m-tiles) and keeps ceil(M / 8) n-tiles of 8 rows of x in registers, so a
//   group of up to GROUP_ROWS rows reads the weight once.
// * A cluster of `cluster` blocks (up to 16, non-portable above 8) owns a
//   strip of STRIP columns; block `rank` walks the K slice [rank * slice,
//   (rank + 1) * slice) in 64-row stages of 16-row k-steps.  Its PWARPS
//   copying warps fill a ring of stages with cp.async (16-byte units from the
//   16-byte boundary at or before each row's first column where w is 16-byte
//   aligned and N % 4 == 0, else 4 bytes, else single values), x's columns of
//   the stage beside them, and mark a stage full on an mbarrier; its CWARPS
//   multiplying warps read a full stage into registers (8 bytes a load: four
//   columns of one row), free it on another mbarrier, pair the rows of a
//   k-step with byte permutes into the A fragments and multiply.  Column 4g +
//   2m + h of a warp's 32 is row g + 8h of its m-tile m, so one 8-byte load
//   feeds both m-tiles.
// * After the loop each multiplying thread pushes its fp32 sums into the
//   inbox of the block that finishes their columns (distributed shared
//   memory); after one cluster.sync() each block adds its inbox in rank
//   order, rounds once and writes.  No finish kernel, no scratch.
// * Rows: grid.z walks groups of GROUP_ROWS rows, each with the same plan
//   (the weight is read once a group).  One sum order per (K, N): the slices
//   come from the plan of (K, N) alone (`cluster_plan` in the wrapper, the
//   int8 matmul's), the k-steps from the slice start, the merge from the
//   rank order, and an mma output element depends on its own row and column
//   only.  A row's bits never depend on M or on the other rows.
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
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
// bf16: tensor cores, one cluster launch
// ---------------------------------------------------------------------------
namespace tc {

using namespace mma_tiles;
using bf16 = __nv_bfloat16;

constexpr int STRIP = 128;       // columns of a cluster's strip: CWARPS warps x 32
constexpr int KSTEP = 16;        // rows of one mma k-step; slices are multiples of it
constexpr int KC = 64;           // weight rows a stage
constexpr int STEPS = KC / KSTEP;
constexpr int RING_BYTES = 64 * 1024;  // the ring's shared memory
constexpr int MAX_CLUSTER = 16;  // blocks of a cluster the entry takes (above 8: non-portable)
constexpr int GROUP_ROWS = 64;   // rows of x a block multiplies (grid.z walks the groups)
constexpr int CWARPS = 4;        // warps across the strip, 32 columns each
constexpr int PWARPS = 4;        // warps that copy
constexpr int CONSUMERS = CWARPS * 32;   // threads that multiply
constexpr int NT = CONSUMERS + PWARPS * 32;  // and threads that copy
static_assert(NT % STRIP == 0, "a thread finishes one column");
constexpr int W_STRIDE = 2 * STRIP + 16;  // bytes of a weight row in shared memory
constexpr int X_STRIDE = KC + 8;          // bf16 of an x row in shared memory

// shared memory of TB n-tiles (8 rows of x each): the ring of stages, the
// barriers of its stages, then the block's inbox: the fp32 sums of every
// rank for the block's share of the strip's columns, at B rows
template <int TB>
struct Smem {
  static constexpr int W_BYTES = KC * W_STRIDE;
  static constexpr int X_BYTES = 8 * TB * X_STRIDE * (int)sizeof(bf16);
  static constexpr int STAGE = W_BYTES + X_BYTES;
  static constexpr int STAGES = RING_BYTES / STAGE < 3 ? 3 : RING_BYTES / STAGE;
  static constexpr int RING = STAGES * STAGE;
  static constexpr int BARRIERS = RING;  // full[STAGES], empty[STAGES]
  static constexpr int INBOX = BARRIERS + 2 * STAGES * 8;
  static constexpr int bytes(int B) { return INBOX + B * STRIP * (int)sizeof(float); }
  static_assert(W_BYTES % 16 == 0 && STAGE % 16 == 0 && INBOX % 16 == 0, "aligned parts");
};

// grid (cluster, strips, row groups), clusters of (cluster, 1, 1), NT threads;
// TB n-tiles of x (a group's rows <= 8 * TB); VEC bytes a weight copy (16: w
// 16-byte aligned and N % 4 == 0; 4: w 4-byte aligned and N % 2 == 0; 2: any)
template <int TB, int VEC>
__global__ void __launch_bounds__(NT)
dense_rows_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                      bf16* __restrict__ out, int M, int K, int N, int slice, int x_aligned) {
  using S = Smem<TB>;
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S::BARRIERS);
  constexpr int STAGES = S::STAGES;
  uint64_t* empty = full + STAGES;
  float* inbox = reinterpret_cast<float*>(smem + S::INBOX);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), n_ranks = (int)gridDim.x;  // grid.x: one cluster
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // this block's group of rows: the same plan for every group
  const int g0 = blockIdx.z * GROUP_ROWS, B = min(GROUP_ROWS, M - g0);
  x += (size_t)g0 * K;
  out += (size_t)g0 * N;
  const int col0 = blockIdx.y * STRIP;
  const int k0 = min(K, rank * slice), k1 = min(K, k0 + slice);
  const int n_chunks = (k1 - k0 + KC - 1) / KC;
  // block `rank` finishes columns [rank * cpr, (rank + 1) * cpr) of the strip,
  // a thread always the same one (NT % cpr == 0)
  const int cpr = STRIP / n_ranks, fin_col = col0 + rank * cpr + tid % cpr;
  // 16-byte copies: where weight row k's column col0 starts in its stage row
  // (0 or 8 bytes: N % 4 == 0)
  const bool shifted = VEC == 16 && N % 8 != 0;
  const auto shift = [&](int k) { return (int)(((size_t)k * N * 2) & 15); };
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      // each copying thread once its cp.async copies have landed, once after
      // its stores
      bar_init(full + s, 2 * PWARPS * 32);
      bar_init(empty + s, CONSUMERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // the other blocks' inboxes are written only once every block has started
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  const int g = lane >> 2, t = lane & 3;
  float acc[2][TB][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int p = 0; p < TB; ++p)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][p][e] = 0.f;

  if (tid >= CONSUMERS) {
    // The copying warps: chunk c (weight rows k0 + c*KC ...) into stage c %
    // STAGES once the multiplying warps are done with its last chunk; rows
    // past k1 are zeros, and what a stage holds in columns past N or in x's
    // rows past B (never copied) meets only outputs that are never written.
    for (int c = 0; c < n_chunks; ++c) {
      const int s = c % STAGES;
      if (c >= STAGES) bar_wait(empty + s, (c / STAGES - 1) & 1);
      unsigned char* ws = smem + s * S::STAGE;
      bf16* xs = reinterpret_cast<bf16*>(ws + S::W_BYTES);
      const int r0 = k0 + c * KC, pt = tid - CONSUMERS, PT = PWARPS * 32;
      if constexpr (VEC == 2) {  // single values, synchronously (odd shapes only)
        for (int i = pt; i < KC * STRIP; i += PT) {
          const int r = i / STRIP, cc = i % STRIP, k = r0 + r, col = col0 + cc;
          reinterpret_cast<bf16*>(ws + r * W_STRIDE)[cc] =
              k < k1 && col < N ? w[(size_t)k * N + col] : __float2bfloat16(0.f);
        }
      } else if constexpr (VEC == 16) {
        // 16-byte units from the 16-byte boundary at or before the row's
        // column col0 (w is 16-byte aligned, so only N % 8 != 0 shifts it, by
        // shift(k) bytes): 2 * STRIP / 16 units, one more when shifted.  A
        // unit past k1 is zeros; one past the weight's end copies only what
        // lies inside.
        const unsigned char* wb = reinterpret_cast<const unsigned char*>(w);
        const int upr = 2 * STRIP / 16 + shifted;
        for (int i = pt; i < KC * upr; i += PT) {
          const int r = i / upr, u = i % upr, k = r0 + r;
          const size_t at = ((size_t)k * N + col0) * 2 / 16 * 16 + 16 * u,
                       end = (size_t)K * N * 2;
          const int n = k < k1 && at < end ? (end - at < 16 ? (int)(end - at) : 16) : 0;
          asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                           smem_u32(ws + r * W_STRIDE + u * 16)),
                       "l"(n > 0 ? wb + at : wb), "r"(n));
        }
      } else {
#pragma unroll 4
        for (int i = pt; i < KC * (STRIP / 2); i += PT) {
          const int r = i / (STRIP / 2), u = i % (STRIP / 2), k = r0 + r, col = col0 + u * 2;
          const bool ok = k < k1 && col < N;
          cp_async4(ws + r * W_STRIDE + u * 4, ok ? w + (size_t)k * N + col : w, ok);
        }
      }
      if (x_aligned) {  // K % 8 == 0 and x 16-byte aligned: units of 8 wholly in or out
        for (int i = pt; i < B * (KC / 8); i += PT) {
          const int b = i / (KC / 8), k = r0 + i % (KC / 8) * 8;
          const bool ok = k < k1;
          cp_async16(xs + b * X_STRIDE + i % (KC / 8) * 8, ok ? x + (size_t)b * K + k : x, ok);
        }
      } else {
        for (int i = pt; i < B * KC; i += PT) {
          const int b = i / KC, k = r0 + i % KC;
          xs[b * X_STRIDE + i % KC] = k < k1 ? x[(size_t)b * K + k] : __float2bfloat16(0.f);
        }
      }
      bar_arrive_copies(full + s);
      bar_arrive(full + s);  // after this lane's stores, if any
    }
  } else {
    // A multiplying warp w: columns 32w.. of the strip, every k-step of every
    // stage, rows past the slice included (zeros in both operands: they add
    // exact zeros), so the same steps run at every M.  It reads all of its
    // operands of a stage first, then pairs and multiplies.  A lane's 8-byte
    // words are columns 4g..4g+3 of the warp's 32 at rows 2t, 2t+1, 2t+8,
    // 2t+9 of a step: column 4g+2m+h is row g+8h of m-tile m.
    for (int c = 0; c < n_chunks; ++c) {
      const int s = c % STAGES;
      bar_wait(full + s, (c / STAGES) & 1);
      const unsigned char* ws = smem + s * S::STAGE + (warp * 32 + 4 * g) * 2;
      const bf16* xs = reinterpret_cast<const bf16*>(smem + s * S::STAGE + S::W_BYTES);
      uint2 wv[STEPS][4];
      uint32_t xb[STEPS][TB][2];
#pragma unroll
      for (int kk = 0; kk < STEPS; ++kk) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int row = kk * KSTEP + 2 * t + (r & 1) + (r >> 1) * 8;
          wv[kk][r] = *reinterpret_cast<const uint2*>(ws + row * W_STRIDE +
                                                     (VEC == 16 ? shift(k0 + c * KC + row) : 0));
        }
        if constexpr (TB == 1) {  // rows g of x, k 2t..2t+1 and 2t+8..2t+9
          const bf16* xp = xs + g * X_STRIDE + kk * KSTEP + 2 * t;
          xb[kk][0][0] = *reinterpret_cast<const uint32_t*>(xp);
          xb[kk][0][1] = *reinterpret_cast<const uint32_t*>(xp + 8);
        } else {
#pragma unroll
          for (int q = 0; q < TB / 2; ++q) {  // two n-tiles a ldmatrix
            uint32_t f[4];
            load_b_nk<KC>(f, xs + q * 16 * X_STRIDE + kk * KSTEP, lane);
            xb[kk][2 * q][0] = f[0], xb[kk][2 * q][1] = f[1];
            xb[kk][2 * q + 1][0] = f[2], xb[kk][2 * q + 1][1] = f[3];
          }
        }
      }
      __syncwarp();
      if (lane == 0) bar_arrive(empty + s);  // the operands are in registers
#pragma unroll
      for (int kk = 0; kk < STEPS; ++kk) {
        const uint2* v = wv[kk];
        // m-tile 0 from the words' low halves (columns 4g, 4g+1), m-tile 1 from
        // the high ones (4g+2, 4g+3); a0/a1 rows 2t..2t+1, a2/a3 rows 2t+8..2t+9
        const uint32_t a[2][4] = {
            {low_pair(v[0].x, v[1].x), high_pair(v[0].x, v[1].x), low_pair(v[2].x, v[3].x),
             high_pair(v[2].x, v[3].x)},
            {low_pair(v[0].y, v[1].y), high_pair(v[0].y, v[1].y), low_pair(v[2].y, v[3].y),
             high_pair(v[2].y, v[3].y)}};
#pragma unroll
        for (int p = 0; p < TB; ++p) {
          mma(acc[0][p], a[0], xb[kk][p][0], xb[kk][p][1]);
          mma(acc[1][p], a[1], xb[kk][p][0], xb[kk][p][1]);
        }
      }
    }
  }
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  if (warp < CONSUMERS / 32) {
    // push the sums to the inbox of the block that finishes their columns:
    // rows 8p + 2t + h, columns 4g..4g+3 of the warp's 32 (m-tile 0 row g, row
    // g + 8, m-tile 1 row g, row g + 8), into slot `rank` of the owner
    const int cc = warp * 32 + 4 * g, owner = cc / cpr;
    float* dst = cluster.map_shared_rank(inbox, owner) + (size_t)rank * B * cpr + cc - owner * cpr;
#pragma unroll
    for (int p = 0; p < TB; ++p)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int b = 8 * p + 2 * t + h;
        if (b < B)
          *reinterpret_cast<float4*>(dst + (size_t)b * cpr) =
              make_float4(acc[0][p][h], acc[0][p][2 + h], acc[1][p][h], acc[1][p][2 + h]);
      }
  }
  cluster.sync();  // every block's sums are in their owners' inboxes

  // the block's columns, every row, by every thread (always the same column,
  // NT % cpr == 0), ROWS_AT_ONCE rows at a time with all their loads in
  // flight: ranks in rank order
  constexpr int ROWS_AT_ONCE = 2;
  if (fin_col < N) {
    for (int i0 = tid; i0 < B * cpr; i0 += ROWS_AT_ONCE * NT) {
      float part[ROWS_AT_ONCE][MAX_CLUSTER];
#pragma unroll
      for (int h = 0; h < ROWS_AT_ONCE; ++h)
#pragma unroll
        for (int r = 0; r < MAX_CLUSTER; ++r)
          if (r < n_ranks && i0 + h * NT < B * cpr)
            part[h][r] = inbox[(size_t)r * B * cpr + i0 + h * NT];
#pragma unroll
      for (int h = 0; h < ROWS_AT_ONCE; ++h) {
        if (i0 + h * NT >= B * cpr) break;
        float v = part[h][0];
#pragma unroll
        for (int r = 1; r < MAX_CLUSTER; ++r)
          if (r < n_ranks) v += part[h][r];
        out[(size_t)((i0 + h * NT) / cpr) * N + fin_col] = __float2bfloat16(v);
      }
    }
  }
}

template <int TB, int VEC>
cudaError_t launch(const bf16* x, const bf16* w, bf16* out, int M, int K, int N, int cluster,
                   int slice, cudaStream_t stream) {
  const auto kernel = dense_rows_mma_kernel<TB, VEC>;
  const int smem = Smem<TB>::bytes(8 * TB);  // the most any group of these n-tiles needs
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
  const int rows = M < GROUP_ROWS ? M : GROUP_ROWS;  // a group's rows (the last may hold fewer)
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, (N + STRIP - 1) / STRIP, (M + GROUP_ROWS - 1) / GROUP_ROWS);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = Smem<TB>::bytes(rows);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const int x_aligned = K % 8 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  err = cudaLaunchKernelEx(&cfg, kernel, x, w, out, M, K, N, slice, x_aligned);
  const cudaError_t last = cudaGetLastError();  // clear it: the next entry's check reads it
  return err != cudaSuccess ? err : last;
}

template <int VEC>
cudaError_t dispatch_rows(const bf16* x, const bf16* w, bf16* out, int M, int K, int N,
                          int cluster, int slice, cudaStream_t s) {
  if (M <= 8) return launch<1, VEC>(x, w, out, M, K, N, cluster, slice, s);
  if (M <= 16) return launch<2, VEC>(x, w, out, M, K, N, cluster, slice, s);
  if (M <= 32) return launch<4, VEC>(x, w, out, M, K, N, cluster, slice, s);
  return launch<8, VEC>(x, w, out, M, K, N, cluster, slice, s);
}

}  // namespace tc

}  // namespace

// x [M,K] and w [K,N] of one dtype (0 = float32, 1 = bfloat16), out [M,N] of
// it, M >= 1.  All contiguous.  vec: see below.  K is cut into n_split slices
// of `slice` rows (n_split * slice >= K).
// * dtype 1: vec in {16, 4, 2} bytes a weight copy (16: w 16-byte aligned and
//   N % 4 == 0; 4: w 4-byte aligned and N % 2 == 0); the slices are the
//   blocks of a cluster (n_split <= 16), slice a multiple of 64 (KC); part
//   unused.  One launch; M in groups of 64 rows.
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
  if (dtype == 1) {
    if (n_split > tc::MAX_CLUSTER || slice % tc::KC != 0 || wa % 2 != 0)
      return cudaErrorInvalidValue;
    const auto* xb = static_cast<const __nv_bfloat16*>(x);
    const auto* wb = static_cast<const __nv_bfloat16*>(w);
    auto* ob = static_cast<__nv_bfloat16*>(out);
    switch (vec) {
      case 16:
        if (wa % 16 != 0 || N % 4 != 0) return cudaErrorInvalidValue;
        return tc::dispatch_rows<16>(xb, wb, ob, M, K, N, n_split, slice, s);
      case 4:
        if (wa % 4 != 0 || N % 2 != 0) return cudaErrorInvalidValue;
        return tc::dispatch_rows<4>(xb, wb, ob, M, K, N, n_split, slice, s);
      case 2: return tc::dispatch_rows<2>(xb, wb, ob, M, K, N, n_split, slice, s);
      default: return cudaErrorInvalidValue;
    }
  }
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

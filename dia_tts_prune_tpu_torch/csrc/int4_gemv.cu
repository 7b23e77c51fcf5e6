// Int4-weight (nibble bytes) GEMV for the decode path, for Hopper (sm_90a).
//
// Replaces: dia_tts_prune_tpu/ops/kernels/int4_gemv.py — the Pallas kernel of
// `_make_kernel` (:40, pallas_call :129).  Same function for the halfsplit
// layout (byte[r, n] = row r in the low nibble, row r + K/2 in the high):
//   y = x[:, :K/2] @ sext(b << 4 >> 4)  +  x[:, K/2:] @ (b >> 4)
// with per-column scales [N] or grouped scales [K/G, N].  It also takes the
// two other layouts the packer can emit: row parity (byte r = rows 2r and
// 2r+1) and, for an odd K, one value per byte.
//
// Scales multiply fp32 partial sums, one per (group, column), as the JAX
// package's XLA form `int4_matmul_halfsplit_grouped` does.  The Pallas body
// instead multiplies the weights by their scales in the compute dtype before
// the MXU dot (:78-79), which in bf16 rounds every weight; that served the
// matrix unit, and here fp32 sums are both cheaper and closer to the
// dequantized kernel.
//
// What bounds it on the H100: bytes — K*N/2 weight bytes plus the scales, each
// byte used for 4*B operations, far below the ridge point at B <= 64 — if the
// weight is read once and enough bytes are in flight.
//
// bf16, halfsplit and parity (namespace tc, the decode path): tensor cores,
// one cluster launch a call, the design of csrc/int8_matmul.cu's tc route.
// * A cluster of `cluster` blocks (up to 16, non-portable above 8) owns a
//   strip of STRIP columns; block `rank` walks the byte rows [rank * slice,
//   (rank + 1) * slice) in stages of KC byte rows.  Its PWARPS copying warps
//   fill a ring of stages with cp.async — the stage's weight rows (16-byte
//   units from the 16-byte boundary at or before each row's first column where
//   w is 16-byte aligned and N % 4 == 0, else 4 bytes, else single bytes) and,
//   beside them, the 2 * KC values of each row of x that those bytes meet
//   (halfsplit: x[:, r0:r0+KC] and x[:, K/2+r0:K/2+r0+KC]; parity: x[:,
//   2r0:2r0+2KC]) — and mark it full on an mbarrier; its CWARPS multiplying
//   warps read the weight words of a full stage into registers, widen nibbles
//   to bf16 in registers and run mma.sync.m16n8k16 with the weight in the
//   16-row operand (y^T = W^T x^T), so the weight is copied once at any B <= 64.
// * Nibbles to bf16, exactly (|q| <= 8): a nibble u of each half-word masked
//   into 0x4300 | (u ^ 8) is 136 + q in bf16 (u ^ 8 = q + 8 for the signed
//   value q), and one bf16x2 subtraction of 136 leaves q.
// * Halfsplit: each stage is walked twice, once per nibble plane (16-byte-row
//   k-steps against that plane's x), so that the two planes' sums, which take
//   different scale rows, are never added before their scales.  Parity: a
//   byte's two nibbles are neighbouring rows of K, and one pass takes both —
//   a k-step's 16 rows are 8 byte rows, its lanes' pairs (2t, 2t+1) and (2t+8,
//   2t+9) the two nibbles of byte rows 2t and 2t+1, which meet x[4t..4t+3].
// * Scales: the multiplying warps keep one fp32 set of sums (`acc`) for the
//   scale row they are in; when the next k-step takes another scale row — a
//   new segment of byte rows, or the other halfsplit plane — the sums are
//   scaled once and added to the fp32 total (`tot`).  A k-step that crosses a
//   segment's end (groups that are not a multiple of its rows, odd shapes only)
//   runs once per segment, the other segment's rows masked to zeros.  So at
//   B = 64 two sets of 64 accumulators are live, never three.
// * After the loop each multiplying thread pushes its totals into the inbox of
//   the block that finishes their columns (block r a 1/cluster share of the
//   strip) through distributed shared memory — at B > 16 the inbox occupies
//   the ring's bytes, written once every block has left its ring; after one
//   cluster.sync() each block adds its inbox in rank order, rounds once and
//   writes.  No finish kernel, no fp32 scratch in device memory.
// * One sum order per (R, N, group): the slices come from the plan of the
//   weight's shape alone (`int4_gemv.cluster_plan` in the wrapper), the
//   k-steps and the flushes from the slice start and the scale segments, the
//   merge from the rank order.  A row's bits never depend on B.
//
// fp32, and the one-value-a-byte layout (odd K): CUDA cores.  A block owns a
// strip of 32*VEC columns and a slice of byte rows, a warp reads 32*VEC
// consecutive bytes of a row with one load per lane, both activation planes of
// the slice sit in shared memory, nibbles are unpacked in registers with two
// shifts, a lane starts the loads of DEPTH rows before it uses the first, and
// a second kernel sums the slices' partials in a fixed order.  Within a slice
// the rows are walked one scale segment at a time (the byte rows that share
// their two scale rows), so the scale is applied once per segment to the
// segment's sums.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_tiles.cuh"

namespace cg = cooperative_groups;

namespace {

// ---------------------------------------------------------------------------
// fp32 and one value a byte: CUDA cores
// ---------------------------------------------------------------------------
constexpr int NWARPS = 4;
constexpr int LANES = 32;
constexpr int RS_MAX = 512;  // byte rows of the weight a block walks
constexpr int DEPTH = 8;     // rows whose loads a lane has in flight

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// four bytes -> their low nibbles (sign-extended) and high nibbles (arithmetic shift)
__device__ __forceinline__ void unpack4(uint32_t word, float* lo, float* hi) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int b = (int8_t)(word >> (8 * i));
    lo[i] = (float)((int)((uint32_t)b << 28) >> 28);
    hi[i] = (float)(b >> 4);
  }
}

// VEC bytes as loaded from p (aligned to VEC bytes), and their two nibble planes
template <int VEC> struct Raw;
template <> struct Raw<4> {
  uint32_t v;
  __device__ __forceinline__ void load(const int8_t* p) {
    v = __ldg(reinterpret_cast<const uint32_t*>(p));
  }
  __device__ __forceinline__ void unpack(float* lo, float* hi) const { unpack4(v, lo, hi); }
};
template <> struct Raw<1> {
  int8_t v;
  __device__ __forceinline__ void load(const int8_t* p) { v = __ldg(p); }
  __device__ __forceinline__ void unpack(float* lo, float* hi) const {
    const int b = v;
    lo[0] = (float)((int)((uint32_t)b << 28) >> 28);
    hi[0] = (float)(b >> 4);
  }
};

// Layouts: which rows of x a byte row r meets.
//   0 halfsplit: low -> r, high -> r + R;  1 parity: low -> 2r, high -> 2r + 1;
//   2 one value per byte: low -> r, no high plane (a value in [-7, 7] is its
//   own sign-extended low nibble; the high plane meets zeros).
// grid (column strips, slices of byte rows, row tiles); N % VEC == 0.
template <typename T, int VEC, int ROWS>
__global__ void __launch_bounds__(NWARPS * LANES)
int4_gemv_kernel(const T* __restrict__ x, const int8_t* __restrict__ w,
                 const float* __restrict__ scale, T* __restrict__ out,
                 float* __restrict__ part, int B, int K, int R, int N, int layout, int seg,
                 int hi_off, int slice) {
  __shared__ float x_lo[ROWS][RS_MAX];
  __shared__ float x_hi[ROWS][RS_MAX];
  __shared__ float red[NWARPS - 1][ROWS][VEC][LANES];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int col = (blockIdx.x * LANES + lane) * VEC;
  const int r0 = blockIdx.y * slice;
  const int r1 = min(R, r0 + slice);
  const int len = max(r1 - r0, 0);
  const int b0 = blockIdx.z * ROWS;

  for (int i = tid; i < ROWS * len; i += NWARPS * LANES) {
    const int row = i / len, r = r0 + i % len;
    float lo = 0.f, hi = 0.f;
    if (b0 + row < B) {
      const T* xr = x + (size_t)(b0 + row) * K;
      if (layout == 0) {
        lo = to_f(xr[r]);
        hi = to_f(xr[r + R]);
      } else if (layout == 1) {
        lo = to_f(xr[2 * r]);
        hi = to_f(xr[2 * r + 1]);
      } else {
        lo = to_f(xr[r]);
      }
    }
    x_lo[row][r - r0] = lo;
    x_hi[row][r - r0] = hi;
  }
  __syncthreads();

  float tot[ROWS][VEC];
#pragma unroll
  for (int row = 0; row < ROWS; ++row)
#pragma unroll
    for (int j = 0; j < VEC; ++j) tot[row][j] = 0.f;

  if (col < N && len > 0) {
    for (int g = r0 / seg; g * seg < r1; ++g) {  // scale segments that meet the slice
      const int ra = max(r0, g * seg), rb = min(r1, (g + 1) * seg);
      float alo[ROWS][VEC], ahi[ROWS][VEC];
#pragma unroll
      for (int row = 0; row < ROWS; ++row)
#pragma unroll
        for (int j = 0; j < VEC; ++j) alo[row][j] = ahi[row][j] = 0.f;
      for (int r = ra + warp; r < rb; r += NWARPS * DEPTH) {
        Raw<VEC> raw[DEPTH];
#pragma unroll
        for (int u = 0; u < DEPTH; ++u)  // the warp's rows r, r + NWARPS, ...: all loads first
          if (r + u * NWARPS < rb) raw[u].load(w + (size_t)(r + u * NWARPS) * N + col);
#pragma unroll
        for (int u = 0; u < DEPTH; ++u) {
          const int rr = r + u * NWARPS;
          if (rr >= rb) break;
          float wl[VEC], wh[VEC];
          raw[u].unpack(wl, wh);
#pragma unroll
          for (int row = 0; row < ROWS; ++row) {
            const float xl = x_lo[row][rr - r0], xh = x_hi[row][rr - r0];
#pragma unroll
            for (int j = 0; j < VEC; ++j) {
              alo[row][j] = fmaf(xl, wl[j], alo[row][j]);
              ahi[row][j] = fmaf(xh, wh[j], ahi[row][j]);
            }
          }
        }
      }
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float sl = scale[(size_t)g * N + col + j];
        const float sh = scale[(size_t)(g + hi_off) * N + col + j];
#pragma unroll
        for (int row = 0; row < ROWS; ++row)
          tot[row][j] = fmaf(alo[row][j], sl, fmaf(ahi[row][j], sh, tot[row][j]));
      }
    }
  }

  // the block's warps hold sums over interleaved rows: add them in warp order
  if (warp > 0) {
#pragma unroll
    for (int row = 0; row < ROWS; ++row)
#pragma unroll
      for (int j = 0; j < VEC; ++j) red[warp - 1][row][j][lane] = tot[row][j];
  }
  __syncthreads();
  if (warp != 0 || col >= N) return;
  const bool direct = gridDim.y == 1;
#pragma unroll
  for (int row = 0; row < ROWS; ++row) {
    if (b0 + row >= B) break;
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      float v = tot[row][j];
#pragma unroll
      for (int wi = 0; wi < NWARPS - 1; ++wi) v += red[wi][row][j][lane];
      const size_t o = (size_t)(b0 + row) * N + col + j;
      if (direct)
        out[o] = from_f<T>(v);
      else
        part[(size_t)blockIdx.y * B * N + o] = v;
    }
  }
}

// out[b, n] = round(sum over slices of part[s, b, n]); the scales are in already
template <typename T>
__global__ void int4_gemv_finish(const float* __restrict__ part, T* __restrict__ out, int BN,
                                 int n_split) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= BN) return;
  float v = 0.f;
  for (int s = 0; s < n_split; ++s) v += part[(size_t)s * BN + i];
  out[i] = from_f<T>(v);
}

struct Args {
  const void *x, *w, *scale;
  void* out;
  float* part;
  int B, K, R, N, layout, seg, hi_off, n_split, slice;
  cudaStream_t stream;
};

template <typename T, int VEC, int ROWS>
cudaError_t launch(const Args& a) {
  const dim3 grid((a.N + LANES * VEC - 1) / (LANES * VEC), a.n_split, (a.B + ROWS - 1) / ROWS);
  int4_gemv_kernel<T, VEC, ROWS><<<grid, NWARPS * LANES, 0, a.stream>>>(
      static_cast<const T*>(a.x), static_cast<const int8_t*>(a.w),
      static_cast<const float*>(a.scale), static_cast<T*>(a.out), a.part, a.B, a.K, a.R, a.N,
      a.layout, a.seg, a.hi_off, a.slice);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || a.n_split == 1) return err;
  const int BN = a.B * a.N;
  int4_gemv_finish<T><<<(BN + 255) / 256, 256, 0, a.stream>>>(a.part, static_cast<T*>(a.out), BN,
                                                              a.n_split);
  return cudaGetLastError();
}

template <typename T, int VEC>
cudaError_t dispatch_rows(const Args& a) {
  return a.B <= 2 ? launch<T, VEC, 2>(a) : launch<T, VEC, 4>(a);
}

template <typename T>
cudaError_t dispatch_vec(int vec, const Args& a) {
  switch (vec) {
    case 4: return dispatch_rows<T, 4>(a);
    case 1: return dispatch_rows<T, 1>(a);
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// bf16, halfsplit and parity: tensor cores, one cluster launch
// ---------------------------------------------------------------------------
namespace tc {

using namespace mma_tiles;
using bf16 = __nv_bfloat16;

constexpr int STRIP = 128;       // columns of a cluster's strip: CWARPS warps x 32
constexpr int KSTEP = 16;        // byte rows of a step: two mma k-steps (halfsplit: one a
                                 // plane; parity: the 16 rows of K in 8 byte rows, twice)
constexpr int KC = 64;           // byte rows a stage; slices are multiples of it
constexpr int STEPS = KC / KSTEP;
constexpr int RING_BYTES = 64 * 1024;  // the ring's shared memory: its stages at 8 rows of x
constexpr int MAX_CLUSTER = 16;  // blocks of a cluster the entry takes (above 8: non-portable)
constexpr int CWARPS = 4;        // warps across the strip, 32 columns each
constexpr int PWARPS = 4;        // warps that copy
constexpr int CONSUMERS = CWARPS * 32;       // threads that multiply
constexpr int NT = CONSUMERS + PWARPS * 32;  // and threads that copy
static_assert(NT % STRIP == 0, "a thread finishes one column");
constexpr int W_STRIDE = STRIP + 16;  // bytes of a weight row in shared memory
constexpr int XCOLS = 2 * KC;         // values of an x row a stage holds
// bf16 of an x row in shared memory: ldmatrix rows (halfsplit) and 8-byte
// loads (parity) each fall in distinct banks
template <int LAYOUT> constexpr int x_stride() { return XCOLS + (LAYOUT == 0 ? 8 : 16); }
constexpr uint32_t MAGIC = 0x43084308u;  // bf16x2 (136, 136)

// shared memory of TB n-tiles (8 rows of x each): the ring of stages, the
// barriers of its stages, and the block's inbox (the fp32 totals of every rank
// for the block's share of the strip's columns, at up to 8 * TB rows).  At
// TB >= 4 the inbox takes over the ring's bytes once every block has left its
// ring (a cluster barrier after the loop); below, it lies beside them and the
// blocks push as soon as every block has started (one barrier fewer, which
// tools/torch_gemv_ab.py measured faster at B <= 16 and slower at B = 64).
template <int TB, int LAYOUT>
struct Smem {
  static constexpr int X_STRIDE = x_stride<LAYOUT>();
  static constexpr int W_BYTES = KC * W_STRIDE;
  static constexpr int X_BYTES = 8 * TB * X_STRIDE * (int)sizeof(bf16);
  static constexpr int STAGE = W_BYTES + X_BYTES;
  // as many stages as the ring's bytes hold (5 at B <= 8, 3 at B <= 64)
  static constexpr int STAGES = RING_BYTES / STAGE < 3 ? 3 : RING_BYTES / STAGE;
  static constexpr int RING = STAGES * STAGE;
  static constexpr int INBOX_BYTES = 8 * TB * STRIP * (int)sizeof(float);
  static constexpr bool ALIAS = TB >= 4;  // the inbox in the ring's bytes
  static constexpr int BARRIERS = ALIAS && INBOX_BYTES > RING ? INBOX_BYTES : RING;
  static constexpr int INBOX = ALIAS ? 0 : BARRIERS + 2 * STAGES * 8;
  static constexpr int BYTES = BARRIERS + 2 * STAGES * 8 + (ALIAS ? 0 : INBOX_BYTES);
  static_assert(W_BYTES % 16 == 0 && STAGE % 16 == 0 && BARRIERS % 16 == 0, "aligned parts");
};

__device__ __forceinline__ __nv_bfloat162 bf2(uint32_t u) {
  return *reinterpret_cast<const __nv_bfloat162*>(&u);
}

// the signed low nibbles of bytes 0 and 2 of p as a bf16x2 word (byte 0's in
// the low half), exactly.  (The conversion unit, int -> fp32 -> bf16x2, gives
// the same bits and measured slower at every decode shape: tools/torch_gemv_ab.py.)
__device__ __forceinline__ uint32_t nibbles(uint32_t p) {
  return bits(__hsub2(bf2((p & 0x000F000Fu) ^ MAGIC), bf2(MAGIC)));
}

// grid (cluster, strips), clusters of (cluster, 1, 1), NT threads; TB n-tiles
// of x (B <= 8 * TB); LAYOUT 0 halfsplit, 1 parity; VEC bytes a weight copy
// (N % VEC == 0 and w VEC-aligned); SEG: scale segments of seg byte rows may
// end inside a k-step.  Byte rows [g * seg, (g + 1) * seg) take scale row g
// (halfsplit's high plane g + hi_off).
// At one n-tile three blocks an SM (the plan's CLUSTER_BLOCKS) must fit the
// register file: at most 85 registers a thread.
template <int TB, int LAYOUT, int VEC, bool SEG>
__global__ void __launch_bounds__(NT, TB == 1 ? 3 : 1)
int4_gemv_mma_kernel(const bf16* __restrict__ x, const int8_t* __restrict__ w,
                     const float* __restrict__ scale, bf16* __restrict__ out, int B, int K,
                     int R, int N, int seg, int hi_off, int slice, int x_aligned) {
  using S = Smem<TB, LAYOUT>;
  constexpr int XS = S::X_STRIDE;
  constexpr int STAGES = S::STAGES;
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S::BARRIERS);
  uint64_t* empty = full + STAGES;
  float* inbox = reinterpret_cast<float*>(smem + S::INBOX);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), n_ranks = (int)gridDim.x;  // grid.x: one cluster
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int col0 = blockIdx.y * STRIP;
  const int k0 = min(R, rank * slice), k1 = min(R, k0 + slice);
  const int n_chunks = (k1 - k0 + KC - 1) / KC;
  // block `rank` finishes columns [rank * cpr, (rank + 1) * cpr) of the strip,
  // a thread always the same one (NT % cpr == 0)
  const int cpr = STRIP / n_ranks, fin_col = col0 + rank * cpr + tid % cpr;
  // 16-byte copies: where weight row k's column col0 starts in its stage row
  const bool shifted = VEC == 16 && N % 16 != 0;
  const auto shift = [&](int k) { return (int)(((size_t)k * N) & 15); };
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
  // beside the ring, the other blocks' inboxes are written once every block has started
  if constexpr (!S::ALIAS) asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  const int g = lane >> 2, t = lane & 3;
  float tot[2][TB][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int p = 0; p < TB; ++p)
#pragma unroll
      for (int e = 0; e < 4; ++e) tot[m][p][e] = 0.f;

  if (tid >= CONSUMERS) {
    // The copying warps: chunk c (byte rows k0 + c*KC ...) into stage c %
    // STAGES once the multiplying warps are done with its last chunk; rows
    // past k1 are zeros, and what a stage holds in columns past N or in x's
    // rows past B (never copied) meets only outputs that are never written.
    for (int c = 0; c < n_chunks; ++c) {
      const int s = c % STAGES;
      if (c >= STAGES) bar_wait(empty + s, (c / STAGES - 1) & 1);
      unsigned char* ws = smem + s * S::STAGE;
      bf16* xs = reinterpret_cast<bf16*>(ws + S::W_BYTES);
      const int r0 = k0 + c * KC, pt = tid - CONSUMERS, PT = PWARPS * 32;
      if constexpr (VEC == 1) {  // single bytes, synchronously (odd shapes only)
        for (int i = pt; i < KC * STRIP; i += PT) {
          const int r = i / STRIP, cc = i % STRIP, k = r0 + r, col = col0 + cc;
          ws[r * W_STRIDE + cc] = k < k1 && col < N ? (unsigned char)w[(size_t)k * N + col] : 0;
        }
      } else if constexpr (VEC == 16) {
        // 16-byte units from the 16-byte boundary at or before the row's
        // column col0 (w is 16-byte aligned, so only N % 16 != 0 shifts it, by
        // shift(k) bytes): STRIP / 16 units, one more when shifted.  A unit
        // past k1 is zeros; one past the weight's end copies only what lies inside.
        const int upr = STRIP / 16 + shifted;
        for (int i = pt; i < KC * upr; i += PT) {
          const int r = i / upr, u = i % upr, k = r0 + r;
          const size_t at = ((size_t)k * N + col0) / 16 * 16 + 16 * u, end = (size_t)R * N;
          const int n = k < k1 && at < end ? (end - at < 16 ? (int)(end - at) : 16) : 0;
          asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                           smem_u32(ws + r * W_STRIDE + u * 16)),
                       "l"(n > 0 ? w + at : w), "r"(n));
        }
      } else {
#pragma unroll 4
        for (int i = pt; i < KC * (STRIP / 4); i += PT) {
          const int r = i / (STRIP / 4), u = i % (STRIP / 4), k = r0 + r, col = col0 + u * 4;
          const bool ok = k < k1 && col < N;
          cp_async4(ws + r * W_STRIDE + u * 4, ok ? w + (size_t)k * N + col : w, ok);
        }
      }
      // x: halfsplit row columns [0, KC) the low plane's x[r0..], [KC, 2KC) the
      // high plane's x[R + r0..]; parity the 2KC columns x[2 r0..]
      if (x_aligned) {  // units of 8 values wholly inside or past the slice
        for (int i = pt; i < B * (XCOLS / 8); i += PT) {
          const int b = i / (XCOLS / 8), u = i % (XCOLS / 8);
          int src, ok;
          if constexpr (LAYOUT == 0) {
            const int r = r0 + (u % (KC / 8)) * 8;
            src = (u < KC / 8 ? 0 : R) + r, ok = r < k1;
          } else {
            src = 2 * r0 + 8 * u, ok = src < 2 * k1;
          }
          cp_async16(xs + b * XS + 8 * u, ok ? x + (size_t)b * K + src : x, ok);
        }
      } else {
        for (int i = pt; i < B * XCOLS; i += PT) {
          const int b = i / XCOLS, cc = i % XCOLS;
          int src, ok;
          if constexpr (LAYOUT == 0) {
            const int r = r0 + cc % KC;
            src = (cc < KC ? 0 : R) + r, ok = r < k1;
          } else {
            src = 2 * r0 + cc, ok = src < 2 * k1;
          }
          xs[b * XS + cc] = ok ? x[(size_t)b * K + src] : __float2bfloat16(0.f);
        }
      }
      bar_arrive_copies(full + s);
      bar_arrive(full + s);  // after this lane's stores, if any
    }
  } else {
    // A multiplying warp w: columns 32w.. of the strip.  The lane's weight
    // words of a step are columns 4g..4g+3 of the warp's 32 at byte rows 2t,
    // 2t+1, 2t+8, 2t+9: column 4g+2m+h is row g+8h of m-tile m.  `acc` holds
    // the sums of scale row `cur` since its last flush.
    float acc[2][TB][4];
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int p = 0; p < TB; ++p)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[m][p][e] = 0.f;
    const int wcol = col0 + warp * 32 + 4 * g;
    float sc[4] = {0.f, 0.f, 0.f, 0.f};
    int cur = -1;
    // the scale rows of the stage's first byte row, one a plane, and their values
    constexpr int PLANES = LAYOUT == 0 ? 2 : 1;
    int pf_row[PLANES];
    float pf[PLANES][4];
    const auto load_scales = [&](float (&v)[4], int row) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        v[j] = wcol + j < N ? __ldg(scale + (size_t)row * N + wcol + j) : 0.f;
    };
    // total += sums x their scales; then into scale row `row`
    const auto use_row = [&](int row) {
      if (row == cur) return;
      if (cur >= 0) {
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int p = 0; p < TB; ++p)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              tot[m][p][e] = fmaf(acc[m][p][e], sc[2 * m + (e >> 1)], tot[m][p][e]);
              acc[m][p][e] = 0.f;
            }
      }
      cur = row;
      if (row < 0) return;
#pragma unroll
      for (int pl = 0; pl < PLANES; ++pl)
        if (row == pf_row[pl]) {
#pragma unroll
          for (int j = 0; j < 4; ++j) sc[j] = pf[pl][j];
          return;
        }
      load_scales(sc, row);
    };
    // one mma k-step of the (masked) weight words a against x words xb, its
    // byte rows [ra, rb] (ra < k1), halves of a at rows rows[i][h]
    const auto kstep = [&](const uint32_t (&a)[2][4], const uint32_t (&xb)[TB][2], int ra,
                           int rb, int plane, const int (&rows)[4][2]) {
      rb = min(rb, k1 - 1);
      const int s0 = ra / seg, s1 = rb / seg, off = plane * hi_off;
      if (!SEG || s0 == s1) {
        use_row(s0 + off);
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int p = 0; p < TB; ++p) mma(acc[m][p], a[m], xb[p][0], xb[p][1]);
        return;
      }
      for (int sg = s0; sg <= s1; ++sg) {  // the k-step's part in each segment
        use_row(sg + off);
        uint32_t am[2][4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const uint32_t keep = (rows[i][0] / seg == sg ? 0x0000FFFFu : 0u) |
                                (rows[i][1] / seg == sg ? 0xFFFF0000u : 0u);
          am[0][i] = a[0][i] & keep, am[1][i] = a[1][i] & keep;
        }
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int p = 0; p < TB; ++p) mma(acc[m][p], am[m], xb[p][0], xb[p][1]);
      }
    };
    for (int c = 0; c < n_chunks; ++c) {
      const int s = c % STAGES, r0 = k0 + c * KC;
      // the stage's scale rows, loaded before its data arrive (the flushes then
      // find them in registers; measured faster at 2048x2048, level elsewhere)
#pragma unroll
      for (int pl = 0; pl < PLANES; ++pl) {
        pf_row[pl] = r0 / seg + pl * hi_off;
        load_scales(pf[pl], pf_row[pl]);
      }
      bar_wait(full + s, (c / STAGES) & 1);
      const unsigned char* ws = smem + s * S::STAGE + warp * 32 + 4 * g;
      const bf16* xs = reinterpret_cast<const bf16*>(smem + s * S::STAGE + S::W_BYTES);
      uint32_t wv[STEPS][4];
#pragma unroll
      for (int kk = 0; kk < STEPS; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int row = kk * KSTEP + 2 * t + (r & 1) + (r >> 1) * 8;
          wv[kk][r] = *reinterpret_cast<const uint32_t*>(
              ws + row * W_STRIDE + (VEC == 16 ? shift(r0 + row) : 0));
        }
      if constexpr (LAYOUT == 0) {
        // halfsplit: the low plane's k-steps, then the high plane's
#pragma unroll
        for (int plane = 0; plane < 2; ++plane) {
#pragma unroll
          for (int kk = 0; kk < STEPS; ++kk) {
            const int base = r0 + kk * KSTEP;
            if (base >= k1) break;
            uint32_t v01[4], v89[4];  // byte rows (2t, 2t+1) and (2t+8, 2t+9), column 4g+j
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              v01[j] = nibbles(__byte_perm(wv[kk][0], wv[kk][1], j | (4 + j) << 8) >> (4 * plane));
              v89[j] = nibbles(__byte_perm(wv[kk][2], wv[kk][3], j | (4 + j) << 8) >> (4 * plane));
            }
            const uint32_t a[2][4] = {{v01[0], v01[1], v89[0], v89[1]},
                                      {v01[2], v01[3], v89[2], v89[3]}};
            uint32_t xb[TB][2];
            const bf16* xp = xs + plane * KC + kk * KSTEP;
            if constexpr (TB == 1) {  // rows g of x, k 2t..2t+1 and 2t+8..2t+9
              xb[0][0] = *reinterpret_cast<const uint32_t*>(xp + g * XS + 2 * t);
              xb[0][1] = *reinterpret_cast<const uint32_t*>(xp + g * XS + 2 * t + 8);
            } else {
#pragma unroll
              for (int q = 0; q < TB / 2; ++q) {  // two n-tiles a ldmatrix
                uint32_t f[4];
                load_b_nk<XCOLS>(f, xp + q * 16 * XS, lane);
                xb[2 * q][0] = f[0], xb[2 * q][1] = f[1];
                xb[2 * q + 1][0] = f[2], xb[2 * q + 1][1] = f[3];
              }
            }
            const int rows[4][2] = {{base + 2 * t, base + 2 * t + 1},
                                    {base + 2 * t, base + 2 * t + 1},
                                    {base + 2 * t + 8, base + 2 * t + 9},
                                    {base + 2 * t + 8, base + 2 * t + 9}};
            kstep(a, xb, base, base + KSTEP - 1, plane, rows);
          }
        }
      } else {
        // parity: k-step h of step kk is byte rows base + 8h .. + 7 (rows
        // 2t and 2t+1 of them the lane's), i.e. x[2 base + 16h + 4t .. + 3]
#pragma unroll
        for (int kk = 0; kk < STEPS; ++kk) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int base = r0 + kk * KSTEP + 8 * h;
            if (base >= k1) break;
            const uint32_t w0 = wv[kk][2 * h], w1 = wv[kk][2 * h + 1];
            uint32_t v0[4], v1[4];  // byte rows 2t / 2t+1: (low, high) nibbles of column 4g+j
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              v0[j] = nibbles(__byte_perm(w0, w0 >> 4, j | (4 + j) << 8));
              v1[j] = nibbles(__byte_perm(w1, w1 >> 4, j | (4 + j) << 8));
            }
            const uint32_t a[2][4] = {{v0[0], v0[1], v1[0], v1[1]}, {v0[2], v0[3], v1[2], v1[3]}};
            uint32_t xb[TB][2];
#pragma unroll
            for (int p = 0; p < TB; ++p) {
              const uint2 v = *reinterpret_cast<const uint2*>(
                  xs + (8 * p + g) * XS + 2 * (kk * KSTEP + 8 * h) + 4 * t);
              xb[p][0] = v.x, xb[p][1] = v.y;
            }
            const int rows[4][2] = {{base + 2 * t, base + 2 * t},
                                    {base + 2 * t, base + 2 * t},
                                    {base + 2 * t + 1, base + 2 * t + 1},
                                    {base + 2 * t + 1, base + 2 * t + 1}};
            kstep(a, xb, base, base + 7, 0, rows);
          }
        }
      }
      __syncwarp();
      if (lane == 0) bar_arrive(empty + s);  // done with the stage
    }
    use_row(-1);  // the last sums into the total
  }
  // in the ring's bytes, the inboxes are written once every block has left its ring
  if constexpr (S::ALIAS) asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  if (warp < CONSUMERS / 32) {
    // push the totals to the inbox of the block that finishes their columns:
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
              make_float4(tot[0][p][h], tot[0][p][2 + h], tot[1][p][h], tot[1][p][2 + h]);
      }
  }
  cluster.sync();  // every block's totals are in their owners' inboxes

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

template <int TB, int LAYOUT, int VEC, bool SEG>
cudaError_t launch(const Args& a) {
  const auto kernel = int4_gemv_mma_kernel<TB, LAYOUT, VEC, SEG>;
  constexpr int smem = Smem<TB, LAYOUT>::BYTES;
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
  cfg.gridDim = dim3(a.n_split, (a.N + STRIP - 1) / STRIP);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = a.stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.n_split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const uintptr_t xp = reinterpret_cast<uintptr_t>(a.x);
  const int x_aligned = (xp & 15) == 0 && a.K % (LAYOUT == 0 ? 16 : 8) == 0;
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const bf16*>(a.x),
                           static_cast<const int8_t*>(a.w), static_cast<const float*>(a.scale),
                           static_cast<bf16*>(a.out), a.B, a.K, a.R, a.N, a.seg, a.hi_off,
                           a.slice, x_aligned);
  const cudaError_t last = cudaGetLastError();  // clear it: the next entry's check reads it
  return err != cudaSuccess ? err : last;
}

template <int LAYOUT, int VEC, bool SEG>
cudaError_t dispatch_rows(const Args& a) {
  if (a.B <= 8) return launch<1, LAYOUT, VEC, SEG>(a);
  if (a.B <= 16) return launch<2, LAYOUT, VEC, SEG>(a);
  if (a.B <= 32) return launch<4, LAYOUT, VEC, SEG>(a);
  return launch<8, LAYOUT, VEC, SEG>(a);
}

template <int LAYOUT, int VEC>
cudaError_t dispatch_seg(const Args& a, int S) {
  // a k-step spans 16 (halfsplit) / 8 (parity) byte rows
  const bool seg_inside = S > 1 && a.seg % (LAYOUT == 0 ? KSTEP : KSTEP / 2) != 0;
  return seg_inside ? dispatch_rows<LAYOUT, VEC, true>(a) : dispatch_rows<LAYOUT, VEC, false>(a);
}

template <int LAYOUT>
cudaError_t dispatch_vec(int vec, const Args& a, int S) {
  switch (vec) {
    case 16: return dispatch_seg<LAYOUT, 16>(a, S);
    case 4: return dispatch_seg<LAYOUT, 4>(a, S);
    case 1: return dispatch_seg<LAYOUT, 1>(a, S);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace tc

}  // namespace

// x [B,K] (dtype 0 = float32, 1 = bfloat16), 1 <= B <= 64, w int8 bytes [R,N]
// with R = K/2 (layouts 0 halfsplit, 1 parity) or R = K (layout 2, one value
// per byte), scale fp32 [S,N], out [B,N] in x's dtype.  All contiguous.  Byte
// rows [g*seg, (g+1)*seg) take scale row g for the low plane and g + hi_off for
// the high plane (per-column scales: S = 1, seg = R, hi_off = 0).  The byte
// rows are cut into n_split slices of `slice` rows (n_split * slice >= R).
// * dtype 1, layouts 0 and 1: vec in {16, 4, 1} bytes a weight copy (vec 16:
//   N % 4 == 0 and w 16-byte aligned); the slices are the blocks of a cluster
//   (n_split <= 16), slice a multiple of 64 (KC); part unused.  One launch.
// * otherwise: vec in {4, 1} must divide N and w's address; slice <= 512;
//   part is fp32 scratch of n_split*B*N floats (unused when n_split == 1).
//   Two launches when n_split > 1.
// Returns the launches' cudaError_t.
extern "C" int int4_gemv_fwd(const void* x, const void* w, const void* scale, void* out,
                             void* part, int B, int K, int R, int N, int S, int layout, int seg,
                             int hi_off, int vec, int n_split, int slice, int dtype,
                             void* stream) {
  if (B <= 0 || B > 64 || K <= 0 || R <= 0 || N <= 0 || S <= 0 || seg <= 0 || hi_off < 0 ||
      n_split <= 0 || slice <= 0 || vec <= 0 || layout < 0 || layout > 2 ||
      (long)n_split * slice < R || reinterpret_cast<uintptr_t>(w) % vec != 0 ||
      (layout == 2 ? R != K : 2 * R != K) || (R - 1) / seg + hi_off >= S)
    return cudaErrorInvalidValue;
  const Args a{x, w, scale, out, static_cast<float*>(part), B, K, R, N, layout, seg, hi_off,
               n_split, slice, static_cast<cudaStream_t>(stream)};
  if (dtype == 1 && layout != 2) {
    if (n_split > tc::MAX_CLUSTER || slice % tc::KC != 0 || N % (vec == 16 ? 4 : vec) != 0)
      return cudaErrorInvalidValue;
    return layout == 0 ? tc::dispatch_vec<0>(vec, a, S) : tc::dispatch_vec<1>(vec, a, S);
  }
  if (slice > RS_MAX || N % vec != 0) return cudaErrorInvalidValue;
  if (dtype == 0) return dispatch_vec<float>(vec, a);
  if (dtype == 1) return dispatch_vec<__nv_bfloat16>(vec, a);
  return cudaErrorInvalidValue;
}

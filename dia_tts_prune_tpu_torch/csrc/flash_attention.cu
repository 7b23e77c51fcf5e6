// Flash attention forward with segment masking (+ causal), for Hopper (sm_90a).
//
// Replaces: dia_tts_prune_tpu/ops/kernels/flash_attention.py — the Pallas
// kernels `_kernel` (:32, pallas_call :157) and `_fwd_kernel_lse` (:184,
// pallas_call :359, the forward that ops/modules.py:397 runs).  Same math:
// blockwise online softmax over key tiles, two positions attend iff their
// segment ids are equal (and, if causal, key <= query), GQA query head n
// reads kv head n / group, fully masked rows write exact zeros.  The
// training entry (`flash_attention_fwd_lse`) also writes each row's
// log-sum-exp, lse[b, n, t] = m + log(max(l, 1e-30)) with m taken as 0 on a
// fully masked row, which the backward kernels (flash_attention_bwd.cu) read
// to recompute the softmax weights.
//
// Two routes, chosen by the input dtype in the C entry points.
//
// bf16: tensor cores (flash_fwd_mma_kernel).  What bounds it on the H100:
// operations -- the encoder site (B=2, T=1024, 16 heads, H=128) does ~10
// GFLOP of masked products against ~17 MB of q/k/v/o, far above the card's
// ~295 FLOP/byte bf16 ridge, so the least time is the products at 989
// TFLOP/s, which only wgmma with TMA can approach (later work; this kernel
// uses mma.sync).  Design: one block per (64 query rows, query head,
// batch row), 4 warps of 16 rows.  The q tile is copied once through shared
// memory into mma A fragments (ldmatrix); 64-key K/V tiles stream through a
// two-stage cp.async ring (tile j+1 loads while tile j is computed).
// S = Q.K^T is mma.sync m16n8k16 bf16 -> fp32 (products of bf16 are exact in
// fp32); the online softmax runs on the accumulator fragments in log2 units
// (exp2 of s * scale * log2(e) less the row max), row max and sum reduced
// over the quad of lanes that shares a row; O += P.V takes P from
// the S registers repacked as A fragments and V through ldmatrix.trans.  P is
// fp32, and one bf16 rounding of it (2^-9 relative) would move outputs by more
// than the kernel's gate, so it enters as two MMAs, hi = bf16(P) and
// lo = bf16(P - hi): fp32-grade results for one more MMA per P.V step, which
// costs 15-22% of the kernel's time on the H100 (700 W,
// tools/torch_flash_variants.py; one rounding misses the gate 60-260 times
// over).
// Masks are never materialised: a key tile is skipped whole when it lies
// above the causal diagonal or when the segment-id ranges of the two tiles do
// not meet (sound for any ids: with prefix padding it drops most pad x real
// work); the per-element test (ids equal, key <= query if causal, in bounds)
// runs only on tiles that are not one segment on both sides, cross the
// diagonal or are ragged, as one column limit per row (diagonal and ragged
// end folded together) and one id compare per element.  Under causality the
// grid starts the query tiles with the most key tiles first.  The output is
// staged through shared memory so that its stores are 16 bytes a lane.
//
// fp32: CUDA cores (flash_fwd_kernel), unchanged from the first port: every
// product is an fp32 FMA (true fp32, no TF32), ceiling 67 TFLOP/s.  One block
// per (q tile of 32 rows, query head, batch row), 4 warps, 8 query rows per
// warp; the q tile stays in shared memory; each step loads one 32-key tile of
// K and V (K rows padded by one float so that lane j reading key j is
// bank-conflict free).  Lane j scores key j for the warp's 8 rows, the warp
// reduces max/sum with shuffles, and each lane accumulates H/32 output dims
// per row in registers.  Causal blocks stop at the tile holding their last
// row.
#include <algorithm>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "mma_tiles.cuh"

namespace {

constexpr float NEG = -1e30f;
constexpr int NWARPS = 4;
constexpr int ROWS = 8;               // query rows per warp
constexpr int BQ = NWARPS * ROWS;     // query rows per block
constexpr int BK = 32;                // keys per tile: one per lane

__device__ __forceinline__ float to_f(float x) { return x; }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int H>
constexpr size_t smem_bytes() {
  return sizeof(float) * (BQ * H + BK * (H + 1) + BK * H) + sizeof(int) * BK;
}

template <typename T, int H>
__global__ void __launch_bounds__(NWARPS * 32)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const int* __restrict__ q_seg, const int* __restrict__ kv_seg,
                 T* __restrict__ out, float* __restrict__ lse, int Tq, int Tk, int Nq, int Nkv,
                 int causal, float scale) {
  constexpr int DPL = H / 32;  // output dims per lane
  extern __shared__ float smem[];
  float* q_s = smem;                    // [BQ][H]
  float* k_s = q_s + BQ * H;            // [BK][H + 1]
  float* v_s = k_s + BK * (H + 1);      // [BK][H]
  int* seg_s = reinterpret_cast<int*>(v_s + BK * H);  // [BK]

  const int q0 = blockIdx.x * BQ;
  const int n = blockIdx.y;
  const int b = blockIdx.z;
  const int nk = n / (Nq / Nkv);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  for (int i = tid; i < BQ * H; i += NWARPS * 32) {
    const int r = i / H, d = i % H, row = q0 + r;
    q_s[i] = row < Tq ? to_f(q[(((size_t)b * Tq + row) * Nq + n) * H + d]) : 0.f;
  }

  int row_idx[ROWS], row_seg[ROWS];
  float m[ROWS], l[ROWS], acc[ROWS][DPL];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    row_idx[r] = q0 + warp * ROWS + r;
    row_seg[r] = row_idx[r] < Tq ? q_seg[(size_t)b * Tq + row_idx[r]] : 0;
    m[r] = NEG;
    l[r] = 0.f;
#pragma unroll
    for (int j = 0; j < DPL; ++j) acc[r][j] = 0.f;
  }

  // causal: no key beyond the block's last query row is ever needed
  const int k_stop = causal ? min(Tk, q0 + BQ) : Tk;
  for (int k0 = 0; k0 < k_stop; k0 += BK) {
    __syncthreads();  // previous tile fully consumed (and q tile stored)
    for (int i = tid; i < BK * H; i += NWARPS * 32) {
      const int j = i / H, d = i % H, key = k0 + j;
      float kv = 0.f, vv = 0.f;
      if (key < Tk) {
        const size_t off = (((size_t)b * Tk + key) * Nkv + nk) * H + d;
        kv = to_f(k[off]);
        vv = to_f(v[off]);
      }
      k_s[j * (H + 1) + d] = kv;
      v_s[j * H + d] = vv;
    }
    if (tid < BK) seg_s[tid] = (k0 + tid < Tk) ? kv_seg[(size_t)b * Tk + k0 + tid] : 0;
    __syncthreads();

    const int key = k0 + lane;
    const int key_seg = seg_s[lane];
    float s[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) s[r] = 0.f;
    const float* q_w = q_s + warp * ROWS * H;
    const float* k_row = k_s + lane * (H + 1);
#pragma unroll 4
    for (int d = 0; d < H; ++d) {
      const float kd = k_row[d];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) s[r] = fmaf(q_w[r * H + d], kd, s[r]);
    }

    float p[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const bool ok = key < Tk && row_idx[r] < Tq && key_seg == row_seg[r] &&
                      (!causal || key <= row_idx[r]);
      const float sr = ok ? s[r] * scale : NEG;
      const float m_new = fmaxf(m[r], warp_max(sr));
      // rows masked so far keep m == NEG; shift to 0 so exp cannot overflow
      const float m_safe = m_new <= NEG * 0.5f ? 0.f : m_new;
      const float alpha = m[r] <= NEG * 0.5f ? 0.f : expf(m[r] - m_safe);
      p[r] = ok ? expf(sr - m_safe) : 0.f;
      l[r] = l[r] * alpha + warp_sum(p[r]);
      m[r] = m_new;
#pragma unroll
      for (int j = 0; j < DPL; ++j) acc[r][j] *= alpha;
    }

#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float vj[DPL];
#pragma unroll
      for (int dd = 0; dd < DPL; ++dd) vj[dd] = v_s[j * H + lane + 32 * dd];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const float pj = __shfl_sync(0xffffffffu, p[r], j);
#pragma unroll
        for (int dd = 0; dd < DPL; ++dd) acc[r][dd] = fmaf(pj, vj[dd], acc[r][dd]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    if (row_idx[r] >= Tq) continue;
    const float inv = 1.f / fmaxf(l[r], 1e-30f);  // fully masked row: acc == 0 -> 0
    T* o = out + (((size_t)b * Tq + row_idx[r]) * Nq + n) * H;
#pragma unroll
    for (int dd = 0; dd < DPL; ++dd) o[lane + 32 * dd] = from_f<T>(acc[r][dd] * inv);
    if (lse != nullptr && lane == 0) {
      const float m_val = m[r] <= NEG * 0.5f ? 0.f : m[r];
      lse[((size_t)b * Nq + n) * Tq + row_idx[r]] = m_val + logf(fmaxf(l[r], 1e-30f));
    }
  }
}

template <typename T, int H>
cudaError_t launch(const void* q, const void* k, const void* v, const void* q_seg,
                   const void* kv_seg, void* out, float* lse, int B, int Tq, int Tk, int Nq,
                   int Nkv, int causal, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<H>();
  auto kernel = flash_fwd_kernel<T, H>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Tq + BQ - 1) / BQ, Nq, B);
  kernel<<<grid, NWARPS * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(q_seg), static_cast<const int*>(kv_seg), static_cast<T*>(out),
      lse, Tq, Tk, Nq, Nkv, causal, 1.0f / sqrtf((float)H));
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 route: tensor-core tiles
// ---------------------------------------------------------------------------
namespace tc {

using namespace mma_tiles;
using bf16 = __nv_bfloat16;

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int BM = WARPS * 16;   // query rows per block, 16 per warp
constexpr int BN = 64;           // keys per tile
// key tiles whose segment range a block keeps in shared memory; later tiles
// (beyond 32768 keys) are never skipped, only masked
constexpr int MAX_TABLE = 512;
constexpr float LOG2E = 1.4426950408889634f, LN2 = 0.6931471805599453f;

template <int H>
__host__ __device__ constexpr int tile_elems() { return 64 * (H + PAD); }

template <int H>
size_t smem_bytes(int n_table) {
  // q tile, two K and two V stages, two stages of key segment ids, the range table
  return sizeof(bf16) * 5 * tile_elems<H>() + sizeof(int) * 2 * BN +
         sizeof(SegRange) * n_table;
}

// One 64-key tile for the warp's 16 query rows: S = Q.K^T, online softmax,
// O += P.V.  Scores, m and the exponents are in log2 units (s * scale *
// log2(e), exp2), which saves a multiply per element.  This thread holds rows
// row0 (accumulator elements 0, 1) and row0 + 8 (elements 2, 3), key columns
// 2t, 2t+1 of each 8-key n-tile.  MASK: run the per-element test, as
// "column <= lim[r]" (the causal diagonal and the tile's ragged end, folded
// into one limit per row) and "segment ids equal".
template <int H, bool MASK>
__device__ __forceinline__ void fwd_tile(const uint32_t (&qf)[H / 16][4], const bf16* k_t,
                                         const bf16* v_t, const int* seg_t, const int (&lim)[2],
                                         const int (&rseg)[2], float scale_log2,
                                         float (&acc)[H / 8][4], float (&m)[2], float (&l)[2],
                                         int lane) {
  const int t = lane & 3;
  float s[BN / 8][4];
#pragma unroll
  for (int nt = 0; nt < BN / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < H / 16; ++kk) {
#pragma unroll
    for (int np = 0; np < BN / 16; ++np) {
      uint32_t b[4];
      load_b_nk<H>(b, k_t + np * 16 * (H + PAD) + kk * 16, lane);
      mma_bf16(s[2 * np], qf[kk], b[0], b[1]);
      mma_bf16(s[2 * np + 1], qf[kk], b[2], b[3]);
    }
  }

  float mx[2] = {NEG, NEG};
#pragma unroll
  for (int nt = 0; nt < BN / 8; ++nt) {
    int2 kseg = make_int2(0, 0);
    if (MASK) kseg = *reinterpret_cast<const int2*>(seg_t + nt * 8 + 2 * t);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = s[nt][e] * scale_log2;
      if (MASK) {
        const int r = e >> 1, c = nt * 8 + (e & 1);  // column c + 2t
        const bool ok = c <= lim[r] && ((e & 1) ? kseg.y : kseg.x) == rseg[r];
        x = ok ? x : NEG;
      }
      s[nt][e] = x;
      mx[e >> 1] = fmaxf(mx[e >> 1], x);
    }
  }
  float m_safe[2], alpha[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float m_new = fmaxf(m[r], quad_max(mx[r]));
    // rows masked so far keep m == NEG; shift to 0 so exp cannot overflow
    m_safe[r] = m_new <= NEG * 0.5f ? 0.f : m_new;
    alpha[r] = m[r] <= NEG * 0.5f ? 0.f : exp2f(m[r] - m_safe[r]);
    m[r] = m_new;
    l[r] *= alpha[r];
  }
#pragma unroll
  for (int nt = 0; nt < BN / 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float x = s[nt][e];
      // a masked score is NEG, never a real one: its weight is exactly 0
      const float p = exp2f(x - m_safe[e >> 1]);
      s[nt][e] = (!MASK || x > NEG * 0.5f) ? p : 0.f;
      l[e >> 1] += s[nt][e];
    }
  }
#pragma unroll
  for (int nt = 0; nt < H / 8; ++nt) {
    acc[nt][0] *= alpha[0];
    acc[nt][1] *= alpha[0];
    acc[nt][2] *= alpha[1];
    acc[nt][3] *= alpha[1];
  }
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk) {
    uint32_t hi[4], lo[4];
    c_to_a_split(s[2 * kk], s[2 * kk + 1], hi, lo);
#pragma unroll
    for (int dp = 0; dp < H / 16; ++dp) {
      uint32_t b[4];
      load_b_kn<H>(b, v_t + kk * 16 * (H + PAD) + dp * 16, lane);
      mma_bf16(acc[2 * dp], hi, b[0], b[1]);
      mma_bf16(acc[2 * dp], lo, b[0], b[1]);
      mma_bf16(acc[2 * dp + 1], hi, b[2], b[3]);
      mma_bf16(acc[2 * dp + 1], lo, b[2], b[3]);
    }
  }
}

// grid (B * Nq, query tiles); blockIdx.x = n + Nq * b.
template <int H>
__global__ void __launch_bounds__(THREADS, 2)
flash_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const int* __restrict__ q_seg,
                     const int* __restrict__ kv_seg, bf16* __restrict__ out,
                     float* __restrict__ lse, int Tq, int Tk, int Nq, int Nkv, int causal,
                     float scale_log2, int n_table) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* k_s = q_s + tile_elems<H>();      // [2 stages][BN][H + PAD]
  bf16* v_s = k_s + 2 * tile_elems<H>();  // [2 stages][BN][H + PAD]
  int* seg_s = reinterpret_cast<int*>(v_s + 2 * tile_elems<H>());  // [2 stages][BN]
  SegRange* table = reinterpret_cast<SegRange*>(seg_s + 2 * BN);   // [n_table]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n = blockIdx.x % Nq, b = blockIdx.x / Nq;
  // causal: the last query tiles have the most key tiles; start them first
  const int qt = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qt * BM, q_rows = min(BM, Tq - q0);
  const int nk = n / (Nq / Nkv);
  const size_t kv_stride = (size_t)Nkv * H;
  const bf16* k_b = k + (size_t)b * Tk * kv_stride + (size_t)nk * H;
  const bf16* v_b = v + (size_t)b * Tk * kv_stride + (size_t)nk * H;
  const int* kseg_b = kv_seg + (size_t)b * Tk;
  const int* qseg_b = q_seg + (size_t)b * Tq;

  load_tile_async<H, BM, THREADS>(q_s, q + (((size_t)b * Tq + q0) * Nq + n) * H,
                                  (size_t)Nq * H, q_rows, tid);

  const int n_kt = (Tk + BN - 1) / BN, n_tab = min(n_kt, n_table);
  seg_range_table(table, n_tab, kseg_b, Tk, warp, WARPS, lane);
  const SegRange qr = warp_seg_range(qseg_b, q0, Tq, lane);
  // causal: no key beyond the block's last query row is ever needed
  const int kt_end = causal ? min(n_kt, (q0 + q_rows - 1) / BN + 1) : n_kt;
  __syncthreads();  // the range table

  auto next = [&](int j) {
    do { ++j; } while (j < kt_end && j < n_tab && !ranges_meet(qr, table[j]));
    return j;
  };
  auto load_kv = [&](int j, int stage) {
    const int k0 = j * BN, rows = min(BN, Tk - k0);
    load_tile_async<H, BN, THREADS>(k_s + stage * tile_elems<H>(), k_b + k0 * kv_stride,
                                    kv_stride, rows, tid);
    load_tile_async<H, BN, THREADS>(v_s + stage * tile_elems<H>(), v_b + k0 * kv_stride,
                                    kv_stride, rows, tid);
    load_row_async(seg_s + stage * BN, kseg_b + k0, BN, rows, tid);
  };

  const int row0 = q0 + warp * 16 + (lane >> 2), row1 = row0 + 8;
  const int rseg[2] = {row0 < Tq ? qseg_b[row0] : 0, row1 < Tq ? qseg_b[row1] : 0};
  float acc[H / 8][4];
#pragma unroll
  for (int nt = 0; nt < H / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};

  int j = next(-1);
  if (j < kt_end) load_kv(j, 0);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();  // q tile and the first K/V tile
  uint32_t qf[H / 16][4];
#pragma unroll
  for (int kk = 0; kk < H / 16; ++kk)
    load_a<H>(qf[kk], q_s + warp * 16 * (H + PAD) + kk * 16, lane);

  for (int stage = 0; j < kt_end; stage ^= 1) {
    const int jn = next(j);
    if (jn < kt_end) load_kv(jn, stage ^ 1);  // lands while tile j is computed
    cp_async_commit();
    const int k0 = j * BN;
    const SegRange kr = j < n_tab ? table[j] : SegRange{-0x7fffffff - 1, 0x7fffffff};
    const bool whole = q_rows == BM && k0 + BN <= Tk && one_segment(qr, kr) &&
                       (!causal || k0 + BN <= q0);
    const bf16* k_t = k_s + stage * tile_elems<H>();
    const bf16* v_t = v_s + stage * tile_elems<H>();
    const int* seg_t = seg_s + stage * BN;
    if (whole) {
      fwd_tile<H, false>(qf, k_t, v_t, seg_t, {0, 0}, rseg, scale_log2, acc, m, l, lane);
    } else {
      // the last key column (tile-relative, less 2t) that each row may see
      const int last = Tk - 1 - k0 - 2 * (lane & 3);
      const int lim[2] = {causal ? min(last, row0 - k0 - 2 * (lane & 3)) : last,
                          causal ? min(last, row1 - k0 - 2 * (lane & 3)) : last};
      fwd_tile<H, true>(qf, k_t, v_t, seg_t, lim, rseg, scale_log2, acc, m, l, lane);
    }
    cp_async_wait<0>();
    __syncthreads();  // tile jn landed; everyone is done with this stage
    j = jn;
  }

  // epilogue: each warp stages its own 16 rows in its rows of the q tile
  // (nobody else reads them), then writes 16 bytes a lane
  const int t = lane & 3, g = lane >> 2;
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] = quad_sum(l[r]);
    inv[r] = 1.f / fmaxf(l[r], 1e-30f);  // fully masked row: acc == 0 -> 0
  }
  bf16* o_s = q_s + warp * 16 * (H + PAD);
  __syncwarp();
#pragma unroll
  for (int nt = 0; nt < H / 8; ++nt) {
    const int col = nt * 8 + 2 * t;
    *reinterpret_cast<__nv_bfloat162*>(o_s + g * (H + PAD) + col) =
        __floats2bfloat162_rn(acc[nt][0] * inv[0], acc[nt][1] * inv[0]);
    *reinterpret_cast<__nv_bfloat162*>(o_s + (g + 8) * (H + PAD) + col) =
        __floats2bfloat162_rn(acc[nt][2] * inv[1], acc[nt][3] * inv[1]);
  }
  __syncwarp();
  constexpr int CPR = H / 8;
#pragma unroll
  for (int i = lane; i < 16 * CPR; i += 32) {
    const int r = i / CPR, c = i % CPR, row = q0 + warp * 16 + r;
    if (row < Tq)
      *reinterpret_cast<uint4*>(out + (((size_t)b * Tq + row) * Nq + n) * H + c * 8) =
          *reinterpret_cast<const uint4*>(o_s + r * (H + PAD) + c * 8);
  }
  if (lse != nullptr && t == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r ? row1 : row0;
      if (row >= Tq) continue;
      const float m_val = m[r] <= NEG * 0.5f ? 0.f : m[r] * LN2;  // back to natural units
      lse[((size_t)b * Nq + n) * Tq + row] = m_val + logf(fmaxf(l[r], 1e-30f));
    }
  }
}

template <int H>
cudaError_t launch(const void* q, const void* k, const void* v, const void* q_seg,
                   const void* kv_seg, void* out, float* lse, int B, int Tq, int Tk, int Nq,
                   int Nkv, int causal, cudaStream_t stream) {
  const int n_table = std::min((Tk + BN - 1) / BN, MAX_TABLE);
  const size_t smem = smem_bytes<H>(n_table);
  auto kernel = flash_fwd_mma_kernel<H>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(B * Nq, (Tq + BM - 1) / BM);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const int*>(q_seg), static_cast<const int*>(kv_seg), static_cast<bf16*>(out),
      lse, Tq, Tk, Nq, Nkv, causal, LOG2E / sqrtf((float)H), n_table);
  return cudaGetLastError();
}

cudaError_t dispatch_h(int H, const void* q, const void* k, const void* v, const void* q_seg,
                       const void* kv_seg, void* out, float* lse, int B, int Tq, int Tk, int Nq,
                       int Nkv, int causal, cudaStream_t stream) {
  switch (H) {
    case 32:
      return launch<32>(q, k, v, q_seg, kv_seg, out, lse, B, Tq, Tk, Nq, Nkv, causal, stream);
    case 64:
      return launch<64>(q, k, v, q_seg, kv_seg, out, lse, B, Tq, Tk, Nq, Nkv, causal, stream);
    case 128:
      return launch<128>(q, k, v, q_seg, kv_seg, out, lse, B, Tq, Tk, Nq, Nkv, causal, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace tc

template <typename T>
cudaError_t dispatch_h(int H, const void* q, const void* k, const void* v, const void* q_seg,
                       const void* kv_seg, void* out, float* lse, int B, int Tq, int Tk, int Nq,
                       int Nkv, int causal, cudaStream_t stream) {
  switch (H) {
    case 32:
      return launch<T, 32>(q, k, v, q_seg, kv_seg, out, lse, B, Tq, Tk, Nq, Nkv, causal, stream);
    case 64:
      return launch<T, 64>(q, k, v, q_seg, kv_seg, out, lse, B, Tq, Tk, Nq, Nkv, causal, stream);
    case 128:
      return launch<T, 128>(q, k, v, q_seg, kv_seg, out, lse, B, Tq, Tk, Nq, Nkv, causal, stream);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t dispatch(const void* q, const void* k, const void* v, const void* q_seg,
                     const void* kv_seg, void* out, float* lse, int B, int Tq, int Tk, int Nq,
                     int Nkv, int H, int dtype, int causal, void* stream) {
  if (B <= 0 || Tq <= 0 || Tk <= 0 || Nkv <= 0 || Nq % Nkv != 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_h<float>(H, q, k, v, q_seg, kv_seg, out, lse, B, Tq, Tk, Nq, Nkv, causal, s);
  if (dtype == 1)  // the tensor-core route
    return tc::dispatch_h(H, q, k, v, q_seg, kv_seg, out, lse, B, Tq, Tk, Nq, Nkv, causal, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// q [B,Tq,Nq,H], k/v [B,Tk,Nkv,H] (dtype 0 = float32, 1 = bfloat16), segment
// ids int32 [B,Tq] / [B,Tk], out [B,Tq,Nq,H] in the input dtype.  All
// contiguous.  Returns the launch's cudaError_t.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   const void* q_seg, const void* kv_seg, void* out, int B,
                                   int Tq, int Tk, int Nq, int Nkv, int H, int dtype,
                                   int causal, void* stream) {
  return dispatch(q, k, v, q_seg, kv_seg, out, nullptr, B, Tq, Tk, Nq, Nkv, H, dtype, causal,
                  stream);
}

// The same forward, also writing lse float32 [B,Nq,Tq] (head-major, as the
// backward kernels read it).
extern "C" int flash_attention_fwd_lse(const void* q, const void* k, const void* v,
                                       const void* q_seg, const void* kv_seg, void* out,
                                       void* lse, int B, int Tq, int Tk, int Nq, int Nkv, int H,
                                       int dtype, int causal, void* stream) {
  if (lse == nullptr) return cudaErrorInvalidValue;
  return dispatch(q, k, v, q_seg, kv_seg, out, static_cast<float*>(lse), B, Tq, Tk, Nq, Nkv, H,
                  dtype, causal, stream);
}

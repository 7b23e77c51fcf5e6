// Flash attention backward (recompute-p) for Hopper (sm_90a): dK/dV and dQ.
//
// Replaces: dia_tts_prune_tpu/ops/kernels/flash_attention.py — the Pallas
// kernels `_bwd_kv_kernel` (:244, pallas_call :456) and `_bwd_q_kernel` (:297,
// pallas_call :481) behind `_flash_bwd_vjp` (:428).  Same math, from the
// forward's saved log-sum-exp rows and dd = sum_h dO*O:
//     s  = q.k^T * scale            p  = mask ? exp(s - lse) : 0
//     dv += p^T.dO                  dp = dO.v^T
//     ds = p * (dp - dd) * scale    dk += ds^T.q        dq += ds.k
// with mask = (segment ids equal) and, if causal, key <= query.  exp() is only
// evaluated under the mask (an unmasked pad<->real pair would overflow), so a
// fully masked row has p == 0 everywhere: its dq is exactly 0 and it adds
// nothing to dk/dv.  Accumulation is fp32 whatever the input dtype; results
// are rounded once to the input dtype.
//
// What bounds them on the H100: operations -- five tile products against the
// forward's two, at hundreds of FLOP per byte of q/k/v/dO.
//
// dK/dV, bf16: tensor cores (flash_bwd_kv_mma_kernel).  One block owns a
// (key tile of 64, kv head, batch row), 4 warps of 16 keys, and loops over the
// group's query heads and the 64-query tiles inside (the Pallas kernel writes
// one buffer per query head and leaves the sum over the group to XLA; its grid
// carries the accumulator across sequential query blocks).  The products are
// key-major so that everything dK/dV needs stays in registers: per 32-query
// sub-chunk, S^T = K.Q^T and dP^T = V.dO^T (mma.sync m16n8k16 bf16 -> fp32,
// K and V as A fragments, Q and dO through ldmatrix), then
// P^T = mask ? exp(S^T * scale - lse) : 0 (as exp2 of log2-scaled values)
// and dS^T = P^T (dP^T - dd) scale on the accumulator fragments, then
// dV += P^T.dO and dK += dS^T.Q with P^T and dS^T repacked as A fragments and
// dO and Q through ldmatrix.trans.  The JAX backward is fp32 throughout, so
// P^T and dS^T (fp32 values) enter their MMAs as hi + lo bf16 pairs (two MMAs
// each), which keeps fp32-grade gradients.  Q/dO tiles with their lse, dd and
// segment ids stream through a two-stage cp.async ring.  dK/dV for the
// block's 64 keys (2 x 64 x H fp32) stay in registers for the whole loop:
// they come out already reduced over the GQA group, with no atomics, in a
// fixed order of summation (bit-identical from run to run).  Query tiles are
// skipped whole when they lie above the diagonal (causal blocks start at it)
// or when their segment-id range does not meet the key tile's; the
// per-element mask (a column window per key row and one id compare) runs only
// on tiles that are not one segment on both sides, cross the diagonal or are
// ragged.  Under causality the grid starts the key tiles with the most query
// tiles first.  What holds it back on the H100 (700 W,
// tools/torch_flash_variants.py): the hi + lo pairs cost 13-20% of its time
// (dropping the lo MMAs misses the gradient gate 14-115 times over); at
// H = 128 it uses all 255 registers and spills 80 bytes a thread, yet
// 16-query sub-chunks, which spill 16, run 0-11% slower; and 2 x 4 warps a SM
// leave little to hide each warp's ldmatrix -> mma chains.  wgmma with TMA is
// the next step.
//
// dQ, bf16: tensor cores (flash_bwd_q_mma_kernel), on the forward's tile plan.
// One block owns (64 query rows, query head, batch row), 4 warps of 16 rows,
// and loops over its kv head's 64-key tiles (K, V and the key segment ids
// through a two-stage cp.async ring; causal blocks start with the query tiles
// that have the most key tiles).  Per 32-key sub-chunk, S = Q.K^T and
// dP = dO.V^T on mma.sync (Q and dO as A fragments held in registers for the
// whole loop, K and V through ldmatrix from their n-major tiles), then
// P = mask ? exp2(S * scale * log2(e) - lse * log2(e)) : 0 and
// dS / scale = P (dP - dd) on the accumulator fragments, then dQ += dS.K
// with dS repacked as hi + lo A fragments and K through ldmatrix.trans.  The
// scale multiplies the fp32 accumulator once, which is rounded once.  Key
// tiles above the diagonal or whose segment range does not meet the query
// tile's are skipped whole (the forward's rule, `tile_visits` in the
// wrapper); the per-element mask runs only on mixed, diagonal or ragged
// tiles.  Each block owns its rows: no atomics, bit-identical from run to run.
//
// dK/dV and dQ in fp32: CUDA cores, the first port's kernels, unchanged: every
// product is an fp32 FMA (fp32 stays true fp32, no TF32), ceiling 67 TFLOP/s.
// dK/dV: the same block plan with 32-key tiles; dQ mirrors the fp32 forward:
// one block per (query tile of 32, query head, batch row) looping over key
// tiles.  Causal blocks skip the tiles wholly above the diagonal.  Time and
// head dims are bounds-checked, never padded: any Tq/Tk, head_dim 32/64/128.
//
// The CUDA-core kernels: 4 warps.  A warp owns 8 rows of the block's own tile
// (keys for dK/dV, queries for dQ), whose operands it reads from shared memory
// as broadcast float4s; lane j scores tile-mate j of the other side, whose
// operand rows are padded to H + 4 floats so that float4 reads down a column
// of lanes are bank-conflict free.  The second stage (p^T.dO, ds^T.q, ds.k)
// broadcasts each p/ds with a shuffle and accumulates H/32 dims per lane.
#include <algorithm>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "mma_tiles.cuh"

namespace {

constexpr int NWARPS = 4;
constexpr int ROWS = 8;             // rows of the block's own tile per warp
constexpr int BT = NWARPS * ROWS;   // tile size on both sides: 32 queries x 32 keys
constexpr int NTHREADS = NWARPS * 32;

__device__ __forceinline__ float to_f(float x) { return x; }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }

// [BT][stride] fp32 tile of rows t0.. of head `head` from x [*, T, N, H]
// (batch offset already applied); rows beyond T are zero.
template <typename T, int H>
__device__ __forceinline__ void load_tile(float* dst, int stride, const T* __restrict__ x,
                                          int t0, int Tlen, int N, int head, int tid) {
  for (int i = tid; i < BT * H; i += NTHREADS) {
    const int r = i / H, d = i % H, t = t0 + r;
    dst[r * stride + d] = t < Tlen ? to_f(x[((size_t)t * N + head) * H + d]) : 0.f;
  }
}

// own[r] . other[lane] for the warp's 8 own rows (broadcast reads, stride H)
// against this lane's row of the other side (stride H + 4), for two operand
// pairs at once: a -> (own_a, oth_a), b -> (own_b, oth_b).
template <int H>
__device__ __forceinline__ void two_dots(const float* own_a, const float* own_b,
                                         const float* oth_a, const float* oth_b,
                                         float (&a)[ROWS], float (&b)[ROWS]) {
#pragma unroll
  for (int r = 0; r < ROWS; ++r) a[r] = b[r] = 0.f;
#pragma unroll 2
  for (int d = 0; d < H; d += 4) {
    const float4 xa = *reinterpret_cast<const float4*>(oth_a + d);
    const float4 xb = *reinterpret_cast<const float4*>(oth_b + d);
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const float4 wa = *reinterpret_cast<const float4*>(own_a + r * H + d);
      const float4 wb = *reinterpret_cast<const float4*>(own_b + r * H + d);
      a[r] = fmaf(wa.x, xa.x, a[r]);
      a[r] = fmaf(wa.y, xa.y, a[r]);
      a[r] = fmaf(wa.z, xa.z, a[r]);
      a[r] = fmaf(wa.w, xa.w, a[r]);
      b[r] = fmaf(wb.x, xb.x, b[r]);
      b[r] = fmaf(wb.y, xb.y, b[r]);
      b[r] = fmaf(wb.z, xb.z, b[r]);
      b[r] = fmaf(wb.w, xb.w, b[r]);
    }
  }
}

template <int H>
constexpr size_t smem_bytes() {
  // two own-side tiles [BT][H], two other-side tiles [BT][H + 4], lse, dd, segment ids
  return sizeof(float) * (2 * BT * H + 2 * BT * (H + 4) + 2 * BT) + sizeof(int) * BT;
}

// ---------------------------------------------------------------------------
// dK, dV: block = (key tile, kv head, batch row); loops over the group's query
// heads and the query tiles.
// ---------------------------------------------------------------------------
template <typename T, int H>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_kv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ dd, const int* __restrict__ q_seg,
                    const int* __restrict__ kv_seg, T* __restrict__ dk, T* __restrict__ dv,
                    int Tq, int Tk, int Nq, int Nkv, int causal, float scale) {
  constexpr int DPL = H / 32;
  constexpr int SO = H + 4;  // padded stride of the query-side tiles
  extern __shared__ float4 smem4[];
  float* k_s = reinterpret_cast<float*>(smem4);  // [BT][H]
  float* v_s = k_s + BT * H;                     // [BT][H]
  float* q_s = v_s + BT * H;                     // [BT][SO]
  float* do_s = q_s + BT * SO;                   // [BT][SO]
  float* lse_s = do_s + BT * SO;                 // [BT]
  float* dd_s = lse_s + BT;                      // [BT]
  int* seg_s = reinterpret_cast<int*>(dd_s + BT);  // [BT]

  const int k0 = blockIdx.x * BT;
  const int nk = blockIdx.y;
  const int b = blockIdx.z;
  const int group = Nq / Nkv;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  load_tile<T, H>(k_s, H, k + (size_t)b * Tk * Nkv * H, k0, Tk, Nkv, nk, tid);
  load_tile<T, H>(v_s, H, v + (size_t)b * Tk * Nkv * H, k0, Tk, Nkv, nk, tid);

  int key_idx[ROWS], key_seg[ROWS];
  float dk_acc[ROWS][DPL], dv_acc[ROWS][DPL];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    key_idx[r] = k0 + warp * ROWS + r;
    key_seg[r] = key_idx[r] < Tk ? kv_seg[(size_t)b * Tk + key_idx[r]] : 0;
#pragma unroll
    for (int j = 0; j < DPL; ++j) dk_acc[r][j] = dv_acc[r][j] = 0.f;
  }

  // causal: query tiles wholly above the diagonal (last row < first key) add nothing
  const int q_first = causal ? (k0 / BT) * BT : 0;
  const float* k_w = k_s + warp * ROWS * H;
  const float* v_w = v_s + warp * ROWS * H;
  const T* q_b = q + (size_t)b * Tq * Nq * H;
  const T* do_b = dout + (size_t)b * Tq * Nq * H;

  for (int g = 0; g < group; ++g) {
    const int n = nk * group + g;
    const float* lse_n = lse + ((size_t)b * Nq + n) * Tq;
    const float* dd_n = dd + ((size_t)b * Nq + n) * Tq;
    for (int q0 = q_first; q0 < Tq; q0 += BT) {
      __syncthreads();  // previous query tile fully consumed (and k/v tiles stored)
      load_tile<T, H>(q_s, SO, q_b, q0, Tq, Nq, n, tid);
      load_tile<T, H>(do_s, SO, do_b, q0, Tq, Nq, n, tid);
      if (tid < BT) {
        const int row = q0 + tid;
        const bool in = row < Tq;
        lse_s[tid] = in ? lse_n[row] : 0.f;
        dd_s[tid] = in ? dd_n[row] : 0.f;
        seg_s[tid] = in ? q_seg[(size_t)b * Tq + row] : 0;
      }
      __syncthreads();

      const int row = q0 + lane;
      const int row_seg = seg_s[lane];
      const float lse_l = lse_s[lane], dd_l = dd_s[lane];
      float s[ROWS], dp[ROWS];
      two_dots<H>(k_w, v_w, q_s + lane * SO, do_s + lane * SO, s, dp);

      float p[ROWS], ds[ROWS];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const bool ok = row < Tq && key_idx[r] < Tk && key_seg[r] == row_seg &&
                        (!causal || key_idx[r] <= row);
        p[r] = ok ? expf(s[r] * scale - lse_l) : 0.f;
        ds[r] = p[r] * (dp[r] - dd_l) * scale;
      }

#pragma unroll 2
      for (int j = 0; j < BT; ++j) {
        float doj[DPL], qj[DPL];
#pragma unroll
        for (int c = 0; c < DPL; ++c) {
          doj[c] = do_s[j * SO + lane + 32 * c];
          qj[c] = q_s[j * SO + lane + 32 * c];
        }
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          const float pj = __shfl_sync(0xffffffffu, p[r], j);
          const float dsj = __shfl_sync(0xffffffffu, ds[r], j);
#pragma unroll
          for (int c = 0; c < DPL; ++c) {
            dv_acc[r][c] = fmaf(pj, doj[c], dv_acc[r][c]);
            dk_acc[r][c] = fmaf(dsj, qj[c], dk_acc[r][c]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    if (key_idx[r] >= Tk) continue;
    const size_t off = (((size_t)b * Tk + key_idx[r]) * Nkv + nk) * H;
#pragma unroll
    for (int c = 0; c < DPL; ++c) {
      dk[off + lane + 32 * c] = from_f<T>(dk_acc[r][c]);
      dv[off + lane + 32 * c] = from_f<T>(dv_acc[r][c]);
    }
  }
}

// ---------------------------------------------------------------------------
// dQ: block = (query tile, query head, batch row); loops over key tiles.
// ---------------------------------------------------------------------------
template <typename T, int H>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_q_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                   const T* __restrict__ dout, const float* __restrict__ lse,
                   const float* __restrict__ dd, const int* __restrict__ q_seg,
                   const int* __restrict__ kv_seg, T* __restrict__ dq,
                   int Tq, int Tk, int Nq, int Nkv, int causal, float scale) {
  constexpr int DPL = H / 32;
  constexpr int SO = H + 4;  // padded stride of the key-side tiles
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);  // [BT][H]
  float* do_s = q_s + BT * H;                    // [BT][H]
  float* k_s = do_s + BT * H;                    // [BT][SO]
  float* v_s = k_s + BT * SO;                    // [BT][SO]
  int* seg_s = reinterpret_cast<int*>(v_s + BT * SO);  // [BT]

  const int q0 = blockIdx.x * BT;
  const int n = blockIdx.y;
  const int b = blockIdx.z;
  const int nk = n / (Nq / Nkv);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  load_tile<T, H>(q_s, H, q + (size_t)b * Tq * Nq * H, q0, Tq, Nq, n, tid);
  load_tile<T, H>(do_s, H, dout + (size_t)b * Tq * Nq * H, q0, Tq, Nq, n, tid);

  int row_idx[ROWS], row_seg[ROWS];
  float lse_r[ROWS], dd_r[ROWS], acc[ROWS][DPL];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    row_idx[r] = q0 + warp * ROWS + r;
    const bool in = row_idx[r] < Tq;
    row_seg[r] = in ? q_seg[(size_t)b * Tq + row_idx[r]] : 0;
    lse_r[r] = in ? lse[((size_t)b * Nq + n) * Tq + row_idx[r]] : 0.f;
    dd_r[r] = in ? dd[((size_t)b * Nq + n) * Tq + row_idx[r]] : 0.f;
#pragma unroll
    for (int j = 0; j < DPL; ++j) acc[r][j] = 0.f;
  }

  const float* q_w = q_s + warp * ROWS * H;
  const float* do_w = do_s + warp * ROWS * H;
  const T* k_b = k + (size_t)b * Tk * Nkv * H;
  const T* v_b = v + (size_t)b * Tk * Nkv * H;
  // causal: no key beyond the block's last query row is ever needed
  const int k_stop = causal ? min(Tk, q0 + BT) : Tk;

  for (int k0 = 0; k0 < k_stop; k0 += BT) {
    __syncthreads();  // previous key tile fully consumed (and q/dO tiles stored)
    load_tile<T, H>(k_s, SO, k_b, k0, Tk, Nkv, nk, tid);
    load_tile<T, H>(v_s, SO, v_b, k0, Tk, Nkv, nk, tid);
    if (tid < BT) seg_s[tid] = (k0 + tid < Tk) ? kv_seg[(size_t)b * Tk + k0 + tid] : 0;
    __syncthreads();

    const int key = k0 + lane;
    const int key_seg = seg_s[lane];
    float s[ROWS], dp[ROWS];
    two_dots<H>(q_w, do_w, k_s + lane * SO, v_s + lane * SO, s, dp);

    float ds[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const bool ok = key < Tk && row_idx[r] < Tq && key_seg == row_seg[r] &&
                      (!causal || key <= row_idx[r]);
      const float p = ok ? expf(s[r] * scale - lse_r[r]) : 0.f;
      ds[r] = p * (dp[r] - dd_r[r]) * scale;
    }

#pragma unroll 4
    for (int j = 0; j < BT; ++j) {
      float kj[DPL];
#pragma unroll
      for (int c = 0; c < DPL; ++c) kj[c] = k_s[j * SO + lane + 32 * c];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const float dsj = __shfl_sync(0xffffffffu, ds[r], j);
#pragma unroll
        for (int c = 0; c < DPL; ++c) acc[r][c] = fmaf(dsj, kj[c], acc[r][c]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    if (row_idx[r] >= Tq) continue;
    T* o = dq + (((size_t)b * Tq + row_idx[r]) * Nq + n) * H;
#pragma unroll
    for (int c = 0; c < DPL; ++c) o[lane + 32 * c] = from_f<T>(acc[r][c]);
  }
}

struct Args {
  const void *q, *k, *v, *dout, *lse, *dd, *q_seg, *kv_seg;
  void *out0, *out1;  // (dk, dv) or (dq, unused)
  int B, Tq, Tk, Nq, Nkv, causal;
  cudaStream_t stream;
};

// ---------------------------------------------------------------------------
// dK, dV in bf16: tensor-core tiles.  Block = (key tile of 64, kv head, batch
// row); loops over the group's query heads and their 64-query tiles.
// ---------------------------------------------------------------------------
namespace tc {

using namespace mma_tiles;
using bf16 = __nv_bfloat16;

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int BN = WARPS * 16;  // keys per block, 16 per warp
constexpr int BM = 64;          // queries per tile
constexpr int QS = 32;          // queries per sub-chunk (S^T and dP^T live in registers)
// query tiles whose segment range a block keeps in shared memory; later tiles
// (beyond 32768 queries) are never skipped, only masked
constexpr int MAX_TABLE = 512;
constexpr float LOG2E = 1.4426950408889634f;

template <int H>
__host__ __device__ constexpr int tile_elems() { return 64 * (H + PAD); }

template <int H>
size_t smem_bytes(int n_table) {
  // K and V tiles, two stages of Q and dO tiles, two stages of lse, dd and
  // query segment ids, the range table
  return sizeof(bf16) * 6 * tile_elems<H>() + sizeof(float) * 3 * 2 * BM +
         sizeof(SegRange) * n_table;
}

// One 64-query tile for the warp's 16 keys.  This thread holds keys key0
// (accumulator elements 0, 1) and key0 + 8 (elements 2, 3), query columns
// 2t, 2t+1 of each 8-query n-tile.  P^T = exp2(S^T * scale * log2(e) -
// lse * log2(e)).  MASK: run the per-element test, as "lo[r] <= column <=
// hi" (the causal diagonal and the tile's ragged end, tile-relative, less 2t)
// and "segment ids equal".
template <int H, bool MASK>
__device__ __forceinline__ void kv_tile(const bf16* k_w, const bf16* v_w, const bf16* q_t,
                                        const bf16* do_t, const float* lse_t, const float* dd_t,
                                        const int* seg_t, const int (&lo)[2], int hi,
                                        const int (&kseg)[2], float scale,
                                        float (&dk)[H / 8][4], float (&dv)[H / 8][4], int lane) {
  const int t = lane & 3;
#pragma unroll 1
  for (int c = 0; c < BM / QS; ++c) {
    float st[QS / 8][4], dpt[QS / 8][4];
#pragma unroll
    for (int nt = 0; nt < QS / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[nt][e] = dpt[nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < H / 16; ++kk) {
      uint32_t ka[4], va[4];
      load_a<H>(ka, k_w + kk * 16, lane);
      load_a<H>(va, v_w + kk * 16, lane);
#pragma unroll
      for (int np = 0; np < QS / 16; ++np) {
        uint32_t b[4];
        const int off = (c * QS + np * 16) * (H + PAD) + kk * 16;
        load_b_nk<H>(b, q_t + off, lane);
        mma_bf16(st[2 * np], ka, b[0], b[1]);
        mma_bf16(st[2 * np + 1], ka, b[2], b[3]);
        load_b_nk<H>(b, do_t + off, lane);
        mma_bf16(dpt[2 * np], va, b[0], b[1]);
        mma_bf16(dpt[2 * np + 1], va, b[2], b[3]);
      }
    }
    const float scale_log2 = scale * LOG2E;
#pragma unroll
    for (int nt = 0; nt < QS / 8; ++nt) {
      const int col = c * QS + nt * 8 + 2 * t;  // query within the tile (and col + 1)
      const float2 lse2 = *reinterpret_cast<const float2*>(lse_t + col);
      const float2 dd2 = *reinterpret_cast<const float2*>(dd_t + col);
      int2 qseg = make_int2(0, 0);
      if (MASK) qseg = *reinterpret_cast<const int2*>(seg_t + col);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, cc = c * QS + nt * 8 + (e & 1);  // column cc + 2t
        const bool ok = !MASK || (lo[r] <= cc && cc <= hi &&
                                  ((e & 1) ? qseg.y : qseg.x) == kseg[r]);
        // an unmasked pad<->real pair would overflow: its weight is exactly 0
        const float lse_q = ((e & 1) ? lse2.y : lse2.x) * LOG2E;
        const float p = ok ? exp2f(st[nt][e] * scale_log2 - lse_q) : 0.f;
        st[nt][e] = p;
        dpt[nt][e] = p * (dpt[nt][e] - ((e & 1) ? dd2.y : dd2.x)) * scale;
      }
    }
#pragma unroll
    for (int ks = 0; ks < QS / 16; ++ks) {
      uint32_t p_hi[4], p_lo[4], s_hi[4], s_lo[4];
      c_to_a_split(st[2 * ks], st[2 * ks + 1], p_hi, p_lo);
      c_to_a_split(dpt[2 * ks], dpt[2 * ks + 1], s_hi, s_lo);
#pragma unroll
      for (int dp = 0; dp < H / 16; ++dp) {
        uint32_t b[4];
        const int off = (c * QS + ks * 16) * (H + PAD) + dp * 16;
        load_b_kn<H>(b, do_t + off, lane);
        mma_bf16(dv[2 * dp], p_hi, b[0], b[1]);
        mma_bf16(dv[2 * dp], p_lo, b[0], b[1]);
        mma_bf16(dv[2 * dp + 1], p_hi, b[2], b[3]);
        mma_bf16(dv[2 * dp + 1], p_lo, b[2], b[3]);
        load_b_kn<H>(b, q_t + off, lane);
        mma_bf16(dk[2 * dp], s_hi, b[0], b[1]);
        mma_bf16(dk[2 * dp], s_lo, b[0], b[1]);
        mma_bf16(dk[2 * dp + 1], s_hi, b[2], b[3]);
        mma_bf16(dk[2 * dp + 1], s_lo, b[2], b[3]);
      }
    }
  }
}

// grid (B * Nkv, key tiles); blockIdx.x = nk + Nkv * b.
template <int H>
__global__ void __launch_bounds__(THREADS, 2)
flash_bwd_kv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const bf16* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ dd,
                        const int* __restrict__ q_seg, const int* __restrict__ kv_seg,
                        bf16* __restrict__ dk, bf16* __restrict__ dv, int Tq, int Tk, int Nq,
                        int Nkv, int causal, float scale, int n_table) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* k_s = reinterpret_cast<bf16*>(smem_raw);  // [BN][H + PAD]
  bf16* v_s = k_s + tile_elems<H>();               // [BN][H + PAD]
  bf16* q_s = v_s + tile_elems<H>();               // [2 stages][BM][H + PAD]
  bf16* do_s = q_s + 2 * tile_elems<H>();          // [2 stages][BM][H + PAD]
  float* lse_s = reinterpret_cast<float*>(do_s + 2 * tile_elems<H>());  // [2][BM]
  float* dd_s = lse_s + 2 * BM;                                          // [2][BM]
  int* seg_s = reinterpret_cast<int*>(dd_s + 2 * BM);                    // [2][BM]
  SegRange* table = reinterpret_cast<SegRange*>(seg_s + 2 * BM);        // [n_table]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nk = blockIdx.x % Nkv, b = blockIdx.x / Nkv;
  // causal: early key tiles meet the most query tiles, and start first
  const int kt = blockIdx.y, k0 = kt * BN, k_rows = min(BN, Tk - k0);
  const int group = Nq / Nkv;
  const size_t kv_stride = (size_t)Nkv * H, q_stride = (size_t)Nq * H;
  const size_t kv_off = ((size_t)b * Tk + k0) * kv_stride + (size_t)nk * H;
  const int* qseg_b = q_seg + (size_t)b * Tq;

  load_tile_async<H, BN, THREADS>(k_s, k + kv_off, kv_stride, k_rows, tid);
  load_tile_async<H, BN, THREADS>(v_s, v + kv_off, kv_stride, k_rows, tid);

  const int n_qt = (Tq + BM - 1) / BM, n_tab = min(n_qt, n_table);
  seg_range_table(table, n_tab, qseg_b, Tq, warp, WARPS, lane);
  const SegRange kr = warp_seg_range(kv_seg + (size_t)b * Tk, k0, Tk, lane);
  // causal: query tiles wholly above the diagonal (last row < first key) add nothing
  const int qt_first = causal ? kt : 0;  // BM == BN
  const int total = group * n_qt;        // (query head of the group, query tile) pairs
  __syncthreads();  // the range table

  auto visits = [&](int i) {
    return i >= qt_first && (i >= n_tab || ranges_meet(table[i], kr));
  };
  auto next = [&](int it) {
    do { ++it; } while (it < total && !visits(it % n_qt));
    return it;
  };
  auto load_q = [&](int it, int stage) {
    const int n = nk * group + it / n_qt, q0 = (it % n_qt) * BM, rows = min(BM, Tq - q0);
    const size_t q_off = ((size_t)b * Tq + q0) * q_stride + (size_t)n * H;
    const size_t row_off = ((size_t)b * Nq + n) * Tq + q0;
    load_tile_async<H, BM, THREADS>(q_s + stage * tile_elems<H>(), q + q_off, q_stride, rows,
                                    tid);
    load_tile_async<H, BM, THREADS>(do_s + stage * tile_elems<H>(), dout + q_off, q_stride,
                                    rows, tid);
    load_row_async(lse_s + stage * BM, lse + row_off, BM, rows, tid);
    load_row_async(dd_s + stage * BM, dd + row_off, BM, rows, tid);
    load_row_async(seg_s + stage * BM, qseg_b + q0, BM, rows, tid);
  };

  const int key0 = k0 + warp * 16 + (lane >> 2), key1 = key0 + 8;
  const int* kseg_b = kv_seg + (size_t)b * Tk;
  const int kseg[2] = {key0 < Tk ? kseg_b[key0] : 0, key1 < Tk ? kseg_b[key1] : 0};
  float dk_acc[H / 8][4], dv_acc[H / 8][4];
#pragma unroll
  for (int nt = 0; nt < H / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[nt][e] = dv_acc[nt][e] = 0.f;

  int it = next(-1);
  if (it < total) load_q(it, 0);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();  // K, V and the first query tile
  const bf16* k_w = k_s + warp * 16 * (H + PAD);
  const bf16* v_w = v_s + warp * 16 * (H + PAD);

  for (int stage = 0; it < total; stage ^= 1) {
    const int in = next(it);
    if (in < total) load_q(in, stage ^ 1);  // lands while this tile is computed
    cp_async_commit();
    const int i = it % n_qt, q0 = i * BM;
    const SegRange qr = i < n_tab ? table[i] : SegRange{-0x7fffffff - 1, 0x7fffffff};
    const bool whole = q0 + BM <= Tq && k_rows == BN && one_segment(qr, kr) &&
                       (!causal || i > kt);
    const bf16* q_t = q_s + stage * tile_elems<H>();
    const bf16* do_t = do_s + stage * tile_elems<H>();
    const float* lse_t = lse_s + stage * BM;
    const float* dd_t = dd_s + stage * BM;
    const int* seg_t = seg_s + stage * BM;
    if (whole) {
      kv_tile<H, false>(k_w, v_w, q_t, do_t, lse_t, dd_t, seg_t, {0, 0}, 0, kseg, scale,
                        dk_acc, dv_acc, lane);
    } else {
      // query columns (tile-relative, less 2t) each key may see: from its own
      // position if causal, up to the tile's ragged end
      const int t2 = 2 * (lane & 3);
      const int lo[2] = {causal ? key0 - q0 - t2 : -BM, causal ? key1 - q0 - t2 : -BM};
      kv_tile<H, true>(k_w, v_w, q_t, do_t, lse_t, dd_t, seg_t, lo, Tq - 1 - q0 - t2, kseg,
                       scale, dk_acc, dv_acc, lane);
    }
    cp_async_wait<0>();
    __syncthreads();  // the next tile landed; everyone is done with this stage
    it = in;
  }

  // epilogue: each warp stages its own 16 keys in its rows of the K and V
  // tiles (nobody else reads them), then writes 16 bytes a lane
  const int t = lane & 3, g = lane >> 2;
  bf16* dk_s = k_s + warp * 16 * (H + PAD);
  bf16* dv_s = v_s + warp * 16 * (H + PAD);
  __syncwarp();
#pragma unroll
  for (int nt = 0; nt < H / 8; ++nt) {
    const int col = nt * 8 + 2 * t;
    *reinterpret_cast<__nv_bfloat162*>(dk_s + g * (H + PAD) + col) =
        __floats2bfloat162_rn(dk_acc[nt][0], dk_acc[nt][1]);
    *reinterpret_cast<__nv_bfloat162*>(dk_s + (g + 8) * (H + PAD) + col) =
        __floats2bfloat162_rn(dk_acc[nt][2], dk_acc[nt][3]);
    *reinterpret_cast<__nv_bfloat162*>(dv_s + g * (H + PAD) + col) =
        __floats2bfloat162_rn(dv_acc[nt][0], dv_acc[nt][1]);
    *reinterpret_cast<__nv_bfloat162*>(dv_s + (g + 8) * (H + PAD) + col) =
        __floats2bfloat162_rn(dv_acc[nt][2], dv_acc[nt][3]);
  }
  __syncwarp();
  constexpr int CPR = H / 8;
#pragma unroll
  for (int i = lane; i < 16 * CPR; i += 32) {
    const int r = i / CPR, c = i % CPR, key = k0 + warp * 16 + r;
    if (key >= Tk) continue;
    const size_t off = (((size_t)b * Tk + key) * Nkv + nk) * H + c * 8;
    *reinterpret_cast<uint4*>(dk + off) =
        *reinterpret_cast<const uint4*>(dk_s + r * (H + PAD) + c * 8);
    *reinterpret_cast<uint4*>(dv + off) =
        *reinterpret_cast<const uint4*>(dv_s + r * (H + PAD) + c * 8);
  }
}

template <int H>
cudaError_t launch_kv(const Args& a) {
  const int n_table = std::min((a.Tq + BM - 1) / BM, MAX_TABLE);
  const size_t smem = smem_bytes<H>(n_table);
  auto kernel = flash_bwd_kv_mma_kernel<H>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(a.B * a.Nkv, (a.Tk + BN - 1) / BN);
  kernel<<<grid, THREADS, smem, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.dd),
      static_cast<const int*>(a.q_seg), static_cast<const int*>(a.kv_seg),
      static_cast<bf16*>(a.out0), static_cast<bf16*>(a.out1), a.Tq, a.Tk, a.Nq, a.Nkv,
      a.causal, 1.0f / sqrtf((float)H), n_table);
  return cudaGetLastError();
}

cudaError_t dispatch_kv(int H, const Args& a) {
  switch (H) {
    case 32: return launch_kv<32>(a);
    case 64: return launch_kv<64>(a);
    case 128: return launch_kv<128>(a);
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// dQ in bf16: tensor-core tiles.  Block = (64 query rows, query head, batch
// row); loops over its kv head's 64-key tiles, KS keys at a time.
// ---------------------------------------------------------------------------
constexpr int KS = 32;  // keys per sub-chunk of dQ (S and dP live in registers)

template <int H>
size_t q_smem_bytes(int n_table) {
  // Q and dO tiles, two stages of K and V tiles and of key segment ids, the range table
  return sizeof(bf16) * 6 * tile_elems<H>() + sizeof(int) * 2 * BN +
         sizeof(SegRange) * n_table;
}

// One 64-key tile for the warp's 16 query rows.  This thread holds rows row0
// (accumulator elements 0, 1) and row0 + 8 (elements 2, 3), key columns 2t,
// 2t+1 of each 8-key n-tile.  P = exp2(S * scale * log2(e) - lse * log2(e)),
// dS / scale = P (dP - dd); dQ += (dS / scale).K, the scale applied once at
// the end.  MASK: run the per-element test, as "column <= lim[r]" (the causal
// diagonal and the tile's ragged end, folded into one limit per row) and
// "segment ids equal".
template <int H, bool MASK>
__device__ __forceinline__ void dq_tile(const uint32_t (&qf)[H / 16][4],
                                        const uint32_t (&dof)[H / 16][4], const bf16* k_t,
                                        const bf16* v_t, const int* seg_t, const int (&lim)[2],
                                        const int (&rseg)[2], const float (&lse2)[2],
                                        const float (&ddr)[2], float scale_log2,
                                        float (&dq)[H / 8][4], int lane) {
  const int t = lane & 3;
#pragma unroll 1
  for (int c = 0; c < BN / KS; ++c) {
    float s[KS / 8][4], dp[KS / 8][4];
#pragma unroll
    for (int nt = 0; nt < KS / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < H / 16; ++kk) {
#pragma unroll
      for (int np = 0; np < KS / 16; ++np) {
        uint32_t b[4];
        const int off = (c * KS + np * 16) * (H + PAD) + kk * 16;
        load_b_nk<H>(b, k_t + off, lane);
        mma_bf16(s[2 * np], qf[kk], b[0], b[1]);
        mma_bf16(s[2 * np + 1], qf[kk], b[2], b[3]);
        load_b_nk<H>(b, v_t + off, lane);
        mma_bf16(dp[2 * np], dof[kk], b[0], b[1]);
        mma_bf16(dp[2 * np + 1], dof[kk], b[2], b[3]);
      }
    }
#pragma unroll
    for (int nt = 0; nt < KS / 8; ++nt) {
      int2 kseg = make_int2(0, 0);
      if (MASK) kseg = *reinterpret_cast<const int2*>(seg_t + c * KS + nt * 8 + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, cc = c * KS + nt * 8 + (e & 1);  // column cc + 2t
        const bool ok = !MASK || (cc <= lim[r] && ((e & 1) ? kseg.y : kseg.x) == rseg[r]);
        // an unmasked pad<->real pair would overflow: its weight is exactly 0
        const float p = ok ? exp2f(s[nt][e] * scale_log2 - lse2[r]) : 0.f;
        dp[nt][e] = p * (dp[nt][e] - ddr[r]);
      }
    }
#pragma unroll
    for (int ks = 0; ks < KS / 16; ++ks) {
      uint32_t hi[4], lo[4];
      c_to_a_split(dp[2 * ks], dp[2 * ks + 1], hi, lo);
#pragma unroll
      for (int hp = 0; hp < H / 16; ++hp) {
        uint32_t b[4];
        load_b_kn<H>(b, k_t + (c * KS + ks * 16) * (H + PAD) + hp * 16, lane);
        mma_bf16(dq[2 * hp], hi, b[0], b[1]);
        mma_bf16(dq[2 * hp], lo, b[0], b[1]);
        mma_bf16(dq[2 * hp + 1], hi, b[2], b[3]);
        mma_bf16(dq[2 * hp + 1], lo, b[2], b[3]);
      }
    }
  }
}

// grid (B * Nq, query tiles); blockIdx.x = n + Nq * b.
template <int H>
__global__ void __launch_bounds__(THREADS, 2)
flash_bwd_q_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, const bf16* __restrict__ dout,
                       const float* __restrict__ lse, const float* __restrict__ dd,
                       const int* __restrict__ q_seg, const int* __restrict__ kv_seg,
                       bf16* __restrict__ dq, int Tq, int Tk, int Nq, int Nkv, int causal,
                       float scale, int n_table) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);  // [BM][H + PAD]
  bf16* do_s = q_s + tile_elems<H>();              // [BM][H + PAD]
  bf16* k_s = do_s + tile_elems<H>();              // [2 stages][BN][H + PAD]
  bf16* v_s = k_s + 2 * tile_elems<H>();           // [2 stages][BN][H + PAD]
  int* seg_s = reinterpret_cast<int*>(v_s + 2 * tile_elems<H>());  // [2 stages][BN]
  SegRange* table = reinterpret_cast<SegRange*>(seg_s + 2 * BN);   // [n_table]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n = blockIdx.x % Nq, b = blockIdx.x / Nq;
  // causal: the last query tiles have the most key tiles; start them first
  const int qt = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qt * BM, q_rows = min(BM, Tq - q0);
  const int nk = n / (Nq / Nkv);
  const size_t kv_stride = (size_t)Nkv * H, q_stride = (size_t)Nq * H;
  const bf16* k_b = k + (size_t)b * Tk * kv_stride + (size_t)nk * H;
  const bf16* v_b = v + (size_t)b * Tk * kv_stride + (size_t)nk * H;
  const int* kseg_b = kv_seg + (size_t)b * Tk;
  const int* qseg_b = q_seg + (size_t)b * Tq;
  const size_t q_off = (((size_t)b * Tq + q0) * Nq + n) * H;

  load_tile_async<H, BM, THREADS>(q_s, q + q_off, q_stride, q_rows, tid);
  load_tile_async<H, BM, THREADS>(do_s, dout + q_off, q_stride, q_rows, tid);

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
  const float* lse_n = lse + ((size_t)b * Nq + n) * Tq;
  const float* dd_n = dd + ((size_t)b * Nq + n) * Tq;
  const float lse2[2] = {row0 < Tq ? lse_n[row0] * LOG2E : 0.f,
                         row1 < Tq ? lse_n[row1] * LOG2E : 0.f};
  const float ddr[2] = {row0 < Tq ? dd_n[row0] : 0.f, row1 < Tq ? dd_n[row1] : 0.f};
  float acc[H / 8][4];
#pragma unroll
  for (int nt = 0; nt < H / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;

  int j = next(-1);
  if (j < kt_end) load_kv(j, 0);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();  // Q, dO and the first K/V tile
  uint32_t qf[H / 16][4], dof[H / 16][4];
#pragma unroll
  for (int kk = 0; kk < H / 16; ++kk) {
    load_a<H>(qf[kk], q_s + warp * 16 * (H + PAD) + kk * 16, lane);
    load_a<H>(dof[kk], do_s + warp * 16 * (H + PAD) + kk * 16, lane);
  }
  const float scale_log2 = scale * LOG2E;

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
      dq_tile<H, false>(qf, dof, k_t, v_t, seg_t, {0, 0}, rseg, lse2, ddr, scale_log2, acc,
                        lane);
    } else {
      // the last key column (tile-relative, less 2t) that each row may see
      const int last = Tk - 1 - k0 - 2 * (lane & 3);
      const int lim[2] = {causal ? min(last, row0 - k0 - 2 * (lane & 3)) : last,
                          causal ? min(last, row1 - k0 - 2 * (lane & 3)) : last};
      dq_tile<H, true>(qf, dof, k_t, v_t, seg_t, lim, rseg, lse2, ddr, scale_log2, acc, lane);
    }
    cp_async_wait<0>();
    __syncthreads();  // tile jn landed; everyone is done with this stage
    j = jn;
  }

  // epilogue: each warp stages its own 16 rows in its rows of the Q tile
  // (nobody else reads them), then writes 16 bytes a lane
  const int t = lane & 3, g = lane >> 2;
  bf16* o_s = q_s + warp * 16 * (H + PAD);
  __syncwarp();
#pragma unroll
  for (int nt = 0; nt < H / 8; ++nt) {
    const int col = nt * 8 + 2 * t;
    *reinterpret_cast<__nv_bfloat162*>(o_s + g * (H + PAD) + col) =
        __floats2bfloat162_rn(acc[nt][0] * scale, acc[nt][1] * scale);
    *reinterpret_cast<__nv_bfloat162*>(o_s + (g + 8) * (H + PAD) + col) =
        __floats2bfloat162_rn(acc[nt][2] * scale, acc[nt][3] * scale);
  }
  __syncwarp();
  constexpr int CPR = H / 8;
#pragma unroll
  for (int i = lane; i < 16 * CPR; i += 32) {
    const int r = i / CPR, c = i % CPR, row = q0 + warp * 16 + r;
    if (row < Tq)
      *reinterpret_cast<uint4*>(dq + (((size_t)b * Tq + row) * Nq + n) * H + c * 8) =
          *reinterpret_cast<const uint4*>(o_s + r * (H + PAD) + c * 8);
  }
}

template <int H>
cudaError_t launch_q(const Args& a) {
  const int n_table = std::min((a.Tk + BN - 1) / BN, MAX_TABLE);
  const size_t smem = q_smem_bytes<H>(n_table);
  auto kernel = flash_bwd_q_mma_kernel<H>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(a.B * a.Nq, (a.Tq + BM - 1) / BM);
  kernel<<<grid, THREADS, smem, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.dd),
      static_cast<const int*>(a.q_seg), static_cast<const int*>(a.kv_seg),
      static_cast<bf16*>(a.out0), a.Tq, a.Tk, a.Nq, a.Nkv, a.causal, 1.0f / sqrtf((float)H),
      n_table);
  return cudaGetLastError();
}

cudaError_t dispatch_q(int H, const Args& a) {
  switch (H) {
    case 32: return launch_q<32>(a);
    case 64: return launch_q<64>(a);
    case 128: return launch_q<128>(a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace tc

template <typename T, int H>
cudaError_t launch_kv(const Args& a) {
  constexpr size_t smem = smem_bytes<H>();
  auto kernel = flash_bwd_kv_kernel<T, H>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((a.Tk + BT - 1) / BT, a.Nkv, a.B);
  kernel<<<grid, NTHREADS, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), static_cast<const float*>(a.lse),
      static_cast<const float*>(a.dd), static_cast<const int*>(a.q_seg),
      static_cast<const int*>(a.kv_seg), static_cast<T*>(a.out0), static_cast<T*>(a.out1),
      a.Tq, a.Tk, a.Nq, a.Nkv, a.causal, 1.0f / sqrtf((float)H));
  return cudaGetLastError();
}

template <typename T, int H>
cudaError_t launch_q(const Args& a) {
  constexpr size_t smem = smem_bytes<H>();
  auto kernel = flash_bwd_q_kernel<T, H>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((a.Tq + BT - 1) / BT, a.Nq, a.B);
  kernel<<<grid, NTHREADS, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), static_cast<const float*>(a.lse),
      static_cast<const float*>(a.dd), static_cast<const int*>(a.q_seg),
      static_cast<const int*>(a.kv_seg), static_cast<T*>(a.out0),
      a.Tq, a.Tk, a.Nq, a.Nkv, a.causal, 1.0f / sqrtf((float)H));
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_q(int H, const Args& a) {
  switch (H) {
    case 32: return launch_q<T, 32>(a);
    case 64: return launch_q<T, 64>(a);
    case 128: return launch_q<T, 128>(a);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t dispatch_kv_fp32(int H, const Args& a) {
  switch (H) {
    case 32: return launch_kv<float, 32>(a);
    case 64: return launch_kv<float, 64>(a);
    case 128: return launch_kv<float, 128>(a);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t dispatch(int H, int dtype, bool kv, const Args& a) {
  if (a.B <= 0 || a.Tq <= 0 || a.Tk <= 0 || a.Nkv <= 0 || a.Nq % a.Nkv != 0)
    return cudaErrorInvalidValue;
  if (dtype == 0) return kv ? dispatch_kv_fp32(H, a) : dispatch_q<float>(H, a);
  // bf16: both on the tensor cores
  if (dtype == 1) return kv ? tc::dispatch_kv(H, a) : tc::dispatch_q(H, a);
  return cudaErrorInvalidValue;
}

}  // namespace

// q/dout [B,Tq,Nq,H], k/v [B,Tk,Nkv,H] (dtype 0 = float32, 1 = bfloat16),
// lse/dd float32 [B,Nq,Tq], segment ids int32 [B,Tq] / [B,Tk]; dk/dv
// [B,Tk,Nkv,H] and dq [B,Tq,Nq,H] in the input dtype.  All contiguous.  Each
// entry returns its launch's cudaError_t.
extern "C" int flash_attention_bwd_kv(const void* q, const void* k, const void* v,
                                      const void* dout, const void* lse, const void* dd,
                                      const void* q_seg, const void* kv_seg, void* dk, void* dv,
                                      int B, int Tq, int Tk, int Nq, int Nkv, int H, int dtype,
                                      int causal, void* stream) {
  const Args a{q, k, v, dout, lse, dd, q_seg, kv_seg, dk, dv, B, Tq, Tk, Nq, Nkv, causal,
               static_cast<cudaStream_t>(stream)};
  return dispatch(H, dtype, true, a);
}

extern "C" int flash_attention_bwd_q(const void* q, const void* k, const void* v,
                                     const void* dout, const void* lse, const void* dd,
                                     const void* q_seg, const void* kv_seg, void* dq, int B,
                                     int Tq, int Tk, int Nq, int Nkv, int H, int dtype,
                                     int causal, void* stream) {
  const Args a{q, k, v, dout, lse, dd, q_seg, kv_seg, dq, nullptr, B, Tq, Tk, Nq, Nkv, causal,
               static_cast<cudaStream_t>(stream)};
  return dispatch(H, dtype, false, a);
}

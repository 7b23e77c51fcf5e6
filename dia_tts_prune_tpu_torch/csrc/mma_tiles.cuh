// Tile primitives for the bf16 tensor-core kernels (sm_90a):
// cp.async copies into padded shared-memory tiles, ldmatrix fragment loads,
// mma.sync m16n8k16 bf16 -> fp32, the hi + lo bf16 split of fp32 operands,
// quad reductions over the lanes that share an accumulator row, and the
// segment-range table that lets a block skip whole tiles.
//
// Fragment layouts of mma.sync.m16n8k16 (lane = 4 * g + t):
//   A (16 x 16, row-major)  a0 = (g, 2t..2t+1)   a1 = (g+8, 2t..2t+1)
//                           a2 = (g, 2t+8..2t+9) a3 = (g+8, 2t+8..2t+9)
//   B (16 x 8, k-major)     b0 = (k 2t..2t+1, n g)   b1 = (k 2t+8..2t+9, n g)
//   C (16 x 8, fp32)        c0, c1 = (g, 2t), (g, 2t+1)   c2, c3 = (g+8, 2t), (g+8, 2t+1)
// so a C tile pair of 8 columns each repacks in registers into one A k-step
// (the lower column of each pair in the low half of the bf16x2 word).
//
// Tiles are stored row-major with a row stride of H + 8 bf16 (16 bytes of
// padding): the eight 16-byte row segments that one ldmatrix phase reads then
// fall in eight different bank groups, for H = 32, 64 and 128 alike.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace mma_tiles {

constexpr int PAD = 8;  // bf16 of padding per tile row

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zeros when !valid (src is then not read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 16 : 0));
}

// 4 bytes global -> shared, asynchronously; zeros when !valid.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// rows [0, ROWS) of a [*, H] bf16 matrix (row r at src + r * row_stride) into a
// padded shared tile; rows >= valid_rows are zero-filled.  Every thread of the
// block calls it; ROWS * H / 8 must be a multiple of NTHREADS.
template <int H, int ROWS, int NTHREADS>
__device__ __forceinline__ void load_tile_async(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                                size_t row_stride, int valid_rows, int tid) {
  constexpr int CPR = H / 8;  // 16-byte chunks per row
  static_assert((ROWS * CPR) % NTHREADS == 0, "tile chunks must divide over the block");
#pragma unroll
  for (int it = 0; it < ROWS * CPR / NTHREADS; ++it) {
    const int i = tid + it * NTHREADS;
    const int r = i / CPR, c = i % CPR;
    const bool ok = r < valid_rows;
    cp_async16(dst + r * (H + PAD) + c * 8, ok ? src + r * row_stride + c * 8 : src, ok);
  }
}

// n consecutive 4-byte values (src[0..n)) into dst[0..n), zeros past `valid`;
// threads tid < n each copy one.
__device__ __forceinline__ void load_row_async(void* dst, const void* src, int n, int valid,
                                               int tid) {
  if (tid < n) {
    const bool ok = tid < valid;
    cp_async4(static_cast<uint32_t*>(dst) + tid,
              ok ? static_cast<const uint32_t*>(src) + tid : src, ok);
  }
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// d += a . b  (m16n8k16, bf16 inputs, fp32 accumulate; products of bf16 are exact in fp32)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a . b as mma_bf16, but not volatile: the compiler may move it among a
// stage's widening and loads (the GEMV kernels)
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// mbarriers of a ring of stages (the GEMV kernels): a stage is full when the
// copying warps' copies of it have landed, empty when every multiplying warp
// is done with it
__device__ __forceinline__ void bar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count));
}
__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
// arrives once this thread's earlier cp.async copies have landed
__device__ __forceinline__ void bar_arrive_copies(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}
// waits for the completion of the barrier's phase of the given parity
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred done;\nWAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT_%=;\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// A fragment for the 16 x 16 row-major tile at `tile` (row stride H + PAD).
template <int H>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const __nv_bfloat16* tile, int lane) {
  ldmatrix_x4(a, tile + (lane & 15) * (H + PAD) + (lane >> 4) * 8);
}

// B fragments of two n-tiles (b[0..1] rows n0..n0+7, b[2..3] rows n0+8..n0+15)
// for one 16-deep k-step, from a tile stored n-major ([n][k], as K for Q.K^T):
// `tile` points at (n0, k0).
template <int H>
__device__ __forceinline__ void load_b_nk(uint32_t (&b)[4], const __nv_bfloat16* tile, int lane) {
  ldmatrix_x4(b, tile + ((lane & 7) + ((lane >> 4) << 3)) * (H + PAD) + ((lane >> 3) & 1) * 8);
}

// B fragments of two n-tiles (columns n0..n0+7 and n0+8..n0+15) for one 16-deep
// k-step, from a tile stored k-major ([k][n], as V for P.V): `tile` points at (k0, n0).
template <int H>
__device__ __forceinline__ void load_b_kn(uint32_t (&b)[4], const __nv_bfloat16* tile, int lane) {
  ldmatrix_x4_trans(b, tile + ((lane & 7) + ((lane >> 3) & 1) * 8) * (H + PAD) + (lane >> 4) * 8);
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// fp32 pair -> (hi, lo) bf16x2 words with hi + lo == (x, y) to ~2^-17 relative:
// hi = bf16(x), lo = bf16(x - hi).  Two MMAs, one on each, keep an fp32
// operand's precision where one bf16 rounding would cost 2^-9.
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(x - hf.x, y - hf.y));
}

// A fragments (hi and lo) of one 16-deep k-step from two fp32 C tiles c0 (k
// columns 0..7) and c1 (8..15) of the same 16 rows.
__device__ __forceinline__ void c_to_a_split(const float (&c0)[4], const float (&c1)[4],
                                             uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  split_bf16(c0[0], c0[1], hi[0], lo[0]);
  split_bf16(c0[2], c0[3], hi[1], lo[1]);
  split_bf16(c1[0], c1[1], hi[2], lo[2]);
  split_bf16(c1[2], c1[3], hi[3], lo[3]);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Segment ids of one 64-position tile, summarised for tile skipping: the
// smallest and largest id of the positions in [t0, min(t0 + 64, T)).  Two
// tiles whose ranges do not meet hold no pair of equal ids, whatever the ids.
struct SegRange {
  int lo, hi;
};

// The range of seg[t0 .. t0+63] (bounded by T), computed by one whole warp.
__device__ __forceinline__ SegRange warp_seg_range(const int* __restrict__ seg, int t0, int T,
                                                   int lane) {
  int lo = 0x7fffffff, hi = -0x7fffffff - 1;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int t = t0 + lane + 32 * h;
    if (t < T) {
      const int s = seg[t];
      lo = min(lo, s);
      hi = max(hi, s);
    }
  }
  return {__reduce_min_sync(0xffffffffu, lo), __reduce_max_sync(0xffffffffu, hi)};
}

// Ranges of the first n tiles of seg[0, T) into table[0, n), all warps of the block.
__device__ __forceinline__ void seg_range_table(SegRange* table, int n, const int* __restrict__ seg,
                                                int T, int warp, int nwarps, int lane) {
  for (int i = warp; i < n; i += nwarps) {
    const SegRange r = warp_seg_range(seg, i * 64, T, lane);
    if (lane == 0) table[i] = r;
  }
}

__device__ __forceinline__ bool ranges_meet(SegRange a, SegRange b) {
  return !(a.hi < b.lo || b.hi < a.lo);
}

// one id on both sides: every pair of the two tiles has equal ids
__device__ __forceinline__ bool one_segment(SegRange a, SegRange b) {
  return a.lo == a.hi && b.lo == b.hi && a.lo == b.lo;
}

}  // namespace mma_tiles

// The whole decoder stack for one token, in one cooperative launch, for
// Hopper (sm_90a).
//
// Replaces: dia_tts_prune_tpu/ops/kernels/fused_step.py — the Pallas kernel
// `_kernel` (:433, pallas_call :1018), which walks a (layers, phases) grid in
// order on one TPU core and carries the activations in VMEM.  Same function:
// per layer, folded-norm -> qkv -> RoPE -> GQA self-attention over cache slots
// [valid_from[b], write_slot) plus the current token -> o_proj -> residual ->
// folded-norm -> cq -> RoPE -> cross-attention over text keys [0,
// cross_ends[b]) -> co_proj -> residual -> folded-norm -> gate/up -> SiLU*up
// -> wm -> residual.  Out: x [B, D] fp32 (before the final norm) and this
// token's K/V [2, L, B, Nkv, H] fp32.  Weights are int8 [K, N] row-major with
// per-column fp32 scales, or, for the MLP, nibble-int4 (two rows per byte).
//
// What bounds it on the H100: weight bytes (69 MB per layer int8, 44 MB with
// the int4 MLP; at a few rows a few operations per byte) — if the weight
// stream never stops.  Eight dependent phases a layer each need the last
// one's activations, but no weight depends on an activation, so:
//
// * One block an SM (grid = the SMs, cooperative): CWARPS consuming warps in
//   two halves of CGROUPS (each warp 32 columns of a strip) and PWARPS
//   copying warps, at most 168 registers a thread and a ring of ~200 KB.
//   (Two blocks of 4 + 4 warps an SM cap registers at 128: the attention
//   code spilled, and with ~115 KB of shared memory a block the spills left
//   L1 for L2 — tools/torch_fused_ab.py measured it slower.)
// * Copying warps never wait on activations.  Every block owns a fixed list
//   of GEMV items for the whole step — per layer and matrix, items of STRIP
//   columns x a K slice (`slice_rows`, from (K, pairing) alone, never from B
//   or the grid), dealt to blocks in contiguous ranges of each phase's item
//   list (`my_range`), the ranges rotated so that every block streams as many
//   items a layer — and its PWARPS copying warps stream those items' weight
//   rows, in the order the block will consume them across phases and layers,
//   into a ring of KC-row stages with 16-byte cp.async copies on mbarriers
//   (the ring of csrc/int8_matmul.cu's tc route).  A stage is refilled as soon
//   as it is free, so the next phase's weight is in flight while the
//   consuming warps run attention, norms and barrier waits.
// * GEMV items run on the tensor cores: mma.sync m16n8k16 with the weight,
//   widened to bf16 in registers (int8 exactly; nibbles by the exact
//   0x4300 | (u ^ 8) form of csrc/int4_gemv.cu), in the 16-row operand and 8
//   rows of x in the other, so up to 8 rows cost what 2 do, and more rows walk
//   more n-tiles over the same stage (up to 64 rows a pass; beyond, the
//   copying warps stream an item once per 64 rows).  The two halves take an
//   item's stages in turn and add their sums in half order at its end.  The
//   consuming warps stage the item's x slice in shared memory themselves
//   (bf16, normed where the input is x).  An item's fp32 sums (halfsplit
//   int4: times the slice's two scale rows) go to a scratch partial,
//   announced by a release add that nothing waits for; the block that ran
//   the strip's last slice, once it has run all its items of the phase,
//   waits until every item of the strip has arrived, adds the partials in
//   slice order and runs the strip's epilogue.
// * Three grid-wide barriers a layer, after o_proj, co_proj and wm (+
//   residual), where the next norm needs whole rows of x: a barrier of the
//   consuming warps only (an epoch-numbered arrive counter, never reset; the
//   copying warps stream on through it).  Each row's norm is the sum, in
//   strip order, of per-strip sums of squares that the residual epilogues
//   write.  Between, items wait on counters for exactly what they read: an
//   attention item on the qkv (cq) strips of its heads, an o_proj (co_proj)
//   item on the attention of the heads in its K slice, a wm item on the
//   gate/up strips in its K slice.  One grid.sync() at start-up (the
//   counters are zeroed in the kernel).
// * Attention items (one 32-slot chunk of one (row, kv head)) on the
//   consuming warps: scores as lane-strided dot products with butterfly
//   sums, a chunk softmax per head (a warp, butterfly max and sum), a thread
//   per (head, dim) over the chunk; the block that ran a (row, head group)'s
//   last chunk combines the chunks in chunk order, as for a strip.  Every K
//   and V value of a chunk is loaded before the first product that needs it,
//   and before the wait for this layer's q: one memory latency a chunk, not
//   one a slot.  The phase before asks L2 for the chunks' K/V rows.
//
// So every value's reduction order follows from K, N, the chunk size and the
// slot range alone: a row's result is the same bit for bit whatever the
// number of rows, the grid size or the run.  Slots outside a row's ranges are
// never read.  The launch is cooperative, so every block is resident and the
// waits cannot deadlock: an item waits only on earlier phases, which every
// block runs first, from the front of its own ring, or on items of the same
// phase once its own are done (a wait of more than WATCHDOG_NS traps all the
// same).
// -DFUSED_TIMELINE builds clock64 stamps per block and phase
// (tools/torch_fused_ab.py reads them).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cooperative_groups.h>
#include <stdint.h>

#include "mma_tiles.cuh"

namespace cg = cooperative_groups;

#ifdef FUSED_TIMELINE
// cycles per (block, phase, category), and per block globaltimer / clock64 at
// start and end
__device__ long long g_tl[4096][8][11];
__device__ long long g_span[4096][4];
extern "C" int fused_step_timeline(void* tl, void* span, int n) {
  cudaError_t e = cudaMemcpyFromSymbol(tl, g_tl, (size_t)n * 8 * 11 * sizeof(long long));
  if (e != cudaSuccess) return e;
  return cudaMemcpyFromSymbol(span, g_span, (size_t)n * 4 * sizeof(long long));
}
extern "C" int fused_step_timeline_reset() {
  static long long zero[4096 * 4] = {};
  return cudaMemcpyToSymbol(g_span, zero, sizeof(zero));
}
#endif

namespace {

using namespace mma_tiles;
using bf16 = __nv_bfloat16;

constexpr int CGROUPS = 4;             // consuming warps across a strip: 32 columns each
constexpr int HALVES = 2;              // and along it: each takes every other stage
constexpr int CWARPS = CGROUPS * HALVES;  // consuming warps
constexpr int PWARPS = 2;              // copying warps
constexpr int NC = CWARPS * 32;        // consuming threads
constexpr int NT = NC + PWARPS * 32;   // and copying threads
constexpr int STRIP = CGROUPS * 32;    // columns of a GEMV item
constexpr int KSTEP = 16;              // rows of one mma k-step
constexpr int KC = 64;                 // weight rows a stage
constexpr int STEPS = KC / KSTEP;
constexpr int KSLICE = 256;            // K rows of a GEMV item, at most
constexpr int W_STRIDE = STRIP + 16;   // bytes of a stage row
constexpr int STAGE = KC * W_STRIDE;
constexpr int MAX_STAGES = 32;
constexpr int XW = 2 * KSLICE + 8;     // bf16 of a staged x row: a slice's two planes
constexpr int PASS = 64;               // rows of x an item's pass holds (8 n-tiles)
constexpr int CH = 32;                 // cache slots of an attention chunk
constexpr int MAX_GH = 4096;           // query heads x head_dim of an attention item
constexpr int MAX_H = 256;             // head_dim
constexpr float NEG = -1e30f;
constexpr uint32_t MAGIC = 0x43084308u;  // bf16x2 (136, 136)
static_assert(NC % STRIP == 0, "consuming threads finish whole strips' columns");
static_assert(NC >= MAX_H && CH == 32, "attention: a thread a head dim, a lane a slot");

// cache kinds
constexpr int CACHE_F32 = 0, CACHE_BF16 = 1, CACHE_I8 = 2;
// matrices, in the FusedPack order
enum { M_QKV, M_O, M_CQ, M_CO, M_G, M_U, M_M };
// GEMV phases (A qkv, C o_proj, D cq, F co_proj, G gate/up, H wm)
enum { GA, GC, GD, GF, GG, GH, NGEMV };
// timeline phases (A .. H) and categories
enum { PA, PB, PC, PD, PE, PF, PG, PH };
enum { TL_DEP, TL_BAR, TL_X, TL_RING, TL_MMA, TL_ARRIVE, TL_FIN, TL_ATT, TL_FULL, TL_COPY,
       TL_ATT_LOAD, NTL };

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// K rows of a GEMV item: KSLICE, halved until it divides `pair` (an int4
// item lies inside one pairing tile), at most the matrix's rows
__host__ __device__ inline int slice_rows(int kp, int pair) {
  int s = KSLICE;
  if (pair > 0)
    while (pair % s) s /= 2;
  return s < kp ? s : kp;
}

// one matrix of a layer: rows kp (byte rows for int4), columns n, nibble
// pairing (0: int8), scales a layer
struct Dims {
  int kp, n, pair, s_layer;
};

__host__ __device__ inline Dims dims_of(int which, int D, int F, int Nq, int Nkv, int Ncq, int H,
                                        int int4, int mt) {
  const int nqkv = (Nq + 2 * Nkv) * H;
  switch (which) {
    case M_QKV: return {D, nqkv, 0, nqkv};
    case M_O: return {Nq * H, D, 0, D};
    case M_CQ: return {D, Ncq * H, 0, Ncq * H};
    case M_CO: return {Ncq * H, D, 0, D};
    case M_G:
    case M_U: return {int4 ? D / 2 : D, F, int4 ? D / 2 : 0, int4 ? 2 * F : F};
    default: return {int4 ? F / 2 : F, D, int4 ? F / (2 * mt) : 0, int4 ? mt * 2 * D : D};
  }
}

__host__ __device__ inline int matrix_of(int gph) {
  switch (gph) {
    case GA: return M_QKV;
    case GC: return M_O;
    case GD: return M_CQ;
    case GF: return M_CO;
    case GG: return M_G;
    default: return M_M;
  }
}

// items of a GEMV phase (gate and up: two a (slice, strip), side by side)
__host__ __device__ inline int gemv_items(const Dims& d, int gph) {
  const int n = cdiv(d.kp, slice_rows(d.kp, d.pair)) * cdiv(d.n, STRIP);
  return gph == GG ? 2 * n : n;
}

__device__ __forceinline__ float bf16r(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

struct Params {
  const int8_t* w[7];  // qkv, o, cq, co, g, u, m: [L, Kp, N]
  const float* s[7];
  const float* x_emb;  // [B, D]
  const int* pos;      // [B]
  const int* vf;       // [B]
  const int* wsp;      // [1] the write slot, in device memory (a replayed CUDA graph's
                       // steps each read their own); copied to ws at block start
  const int* cross_ends;  // [B]
  const float* inv_freq;  // [H/2]
  const void* sk;      // [L, B, T, Nkv, H]
  const void* sv;
  const void* ck;      // [L, B, S, Ncq, H]
  const void* cv;
  const float* sks;    // [L, B, T, Nkv] (int8 caches)
  const float* svs;
  const float* cks;    // [L, B, S, Ncq]
  const float* cvs;
  float* x;            // [B, D] the residual stream, and the output
  float* kv_out;       // [2, L, B, Nkv, H]
  // workspace
  float* qkv;          // [B, (Nq + 2 Nkv) H]
  float* cq;           // [B, Ncq H]
  float* att;          // [B, max(Nq, Ncq) H] attention out, bf16-rounded
  float* h;            // [B, F] bf16-rounded
  float* part[2];      // GEMV partials [slice, B, N]: phases A, D, G / C, F, H
  float* ss;           // [3, B, nsd] sums of squares of x by strip: after C, F, H
  float* apart;        // [B, NHMAX, NCH, H] attention partials
  float* am;           // [B, NHMAX, NCH]
  float* al;
  unsigned* cnt;       // every counter below, zeroed at start-up
  unsigned* gbar;      // the consuming warps' grid barrier
  unsigned* arrived[NGEMV];  // items of each GEMV phase's strips stored
  unsigned* done_qkv;  // strips of qkv / cq / h finished, a layer each
  unsigned* done_cq;
  unsigned* done_h;
  unsigned* arrived_self;   // [B, Nkv] self-attention chunks stored
  unsigned* arrived_cross;  // [B, Ncq]
  unsigned* done_att;  // [Nkv] rows whose self-attention of a head group is finished
  unsigned* done_catt;  // [Ncq] rows whose cross-attention of a head is finished
  int L, B, D, F, Nq, Nkv, Ncq, H, T, S, ws, cache, int4, mt;
  int ncnt, nsd, stages, vec16;
  float eps;
};

// one layer's matrix and its item plan
struct Mat {
  const int8_t* w;
  const float* s;
  int kp, n, pair, slice, nsl, ns;
};

__device__ inline Mat mat(const Params& p, int which, int l) {
  const Dims d = dims_of(which, p.D, p.F, p.Nq, p.Nkv, p.Ncq, p.H, p.int4, p.mt);
  Mat m;
  m.kp = d.kp;
  m.n = d.n;
  m.pair = d.pair;
  m.w = p.w[which] + (size_t)l * d.kp * d.n;
  m.s = p.s[which] + (size_t)l * d.s_layer;
  m.slice = slice_rows(d.kp, d.pair);
  m.nsl = cdiv(d.kp, m.slice);
  m.ns = cdiv(d.n, STRIP);
  return m;
}

// this block's items [lo, hi) of a phase's n: contiguous ranges, rotated by off
__device__ __forceinline__ void my_range(int n, int off, int& lo, int& hi) {
  const int nb = (int)gridDim.x, r = ((int)blockIdx.x + off) % nb;
  lo = (int)((long long)r * n / nb);
  hi = (int)((long long)(r + 1) * n / nb);
}

// each GEMV phase's rotation: the items of the layer's earlier GEMV phases,
// so that the blocks with an extra item differ from phase to phase
__device__ inline int gemv_offset(const Params& p, int gph) {
  int off = 0;
  for (int q = 0; q < gph; ++q)
    off += gemv_items(dims_of(matrix_of(q), p.D, p.F, p.Nq, p.Nkv, p.Ncq, p.H, p.int4, p.mt), q);
  return off % (int)gridDim.x;
}

struct Item {
  int which, sl, strip;
};

__device__ __forceinline__ Item item_of(int gph, int i, int ns) {
  if (gph == GG) return {M_G + (i & 1), (i >> 1) / ns, (i >> 1) % ns};
  return {matrix_of(gph), i / ns, i % ns};
}

// --------------------------------------------------------------------------
// timeline stamps (-DFUSED_TIMELINE), else nothing
// --------------------------------------------------------------------------
struct Tl {
#ifdef FUSED_TIMELINE
  long long t;
  int ph;
  bool on;
  __device__ void start() {
    on = threadIdx.x == 0 || threadIdx.x == NC;
    ph = 0;
    t = clock64();
  }
  __device__ void phase(int x) { ph = x; }
  __device__ void mark(int cat) {
    if (on) {
      const long long n = clock64();
      g_tl[blockIdx.x][ph][cat] += n - t;
      t = n;
    }
  }
#else
  __device__ void start() {}
  __device__ void phase(int) {}
  __device__ void mark(int) {}
#endif
};

// --------------------------------------------------------------------------
// synchronisation: the consuming warps' block barrier, counters, grid barrier
// --------------------------------------------------------------------------
__device__ __forceinline__ void csync() { asm volatile("bar.sync 1, %0;\n" ::"n"(NC) : "memory"); }

// a wait this long is a fault (a schedule that cannot finish): the kernel
// traps, so the launch fails instead of holding the card
constexpr long long WATCHDOG_NS = 2000000000LL;

__device__ __forceinline__ long long gtime() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ bool ring_try(uint64_t* bar, uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n.reg .pred done;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%1], %2;\n"
      "selp.u32 %0, 1, 0, done;\n}\n"
      : "=r"(ok)
      : "r"(smem_u32(bar)), "r"(parity)
      : "memory");
  return ok != 0;
}

// a ring stage's mbarrier phase of the given parity, under the watchdog
__device__ __forceinline__ void ring_wait(uint64_t* bar, uint32_t parity) {
  if (ring_try(bar, parity)) return;
  const long long t0 = gtime();
  while (!ring_try(bar, parity))
    if (gtime() - t0 > WATCHDOG_NS) __trap();
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* c) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(c) : "memory");
  return v;
}

__device__ __forceinline__ void red_add_release(unsigned* c) {
  asm volatile("red.release.gpu.global.add.u32 [%0], %1;\n" ::"l"(c), "r"(1u) : "memory");
}

// One more finished unit of what `counter` counts, after this block's stores:
// as in CUTLASS's GenericBarrier, the block barrier orders every consuming
// thread's stores before thread 0's release (and a waiter's acquire, before
// its block's loads past the barrier after it).  Nothing waits for the add.
__device__ void release(unsigned* counter) {
  csync();
  if (threadIdx.x == 0) red_add_release(counter);
}

// until *c >= target, under the watchdog
__device__ __forceinline__ void spin_until(const unsigned* c, unsigned target) {
  if (ld_acquire(c) >= target) return;
  const long long t0 = gtime();
  while (ld_acquire(c) < target)
    if (gtime() - t0 > WATCHDOG_NS) __trap();
}

// until one counter reaches target, the block's loads after it
__device__ void wait_one(const unsigned* c, unsigned target) {
  if (threadIdx.x == 0) spin_until(c, target);
  csync();
}

// up to three ranges of counters [lo, hi) that must all reach target
struct Ranges {
  int lo[3], hi[3], n;
};

__device__ void wait_counters(const unsigned* c, const Ranges& r, unsigned target) {
  if (threadIdx.x < 32) {
    for (int q = 0; q < r.n; ++q)
      for (int i = r.lo[q] + (int)threadIdx.x; i < r.hi[q]; i += 32) spin_until(c + i, target);
    __syncwarp();
  }
  csync();
}

// strips of STRIP columns that columns [a, b) touch
__device__ __forceinline__ void add_strips(Ranges& r, int a, int b) {
  r.lo[r.n] = a / STRIP;
  r.hi[r.n] = cdiv(b, STRIP);
  ++r.n;
}

__device__ void grid_barrier(unsigned* bar, unsigned target) {
  csync();
  if (threadIdx.x == 0) {
    red_add_release(bar);
    spin_until(bar, target);
  }
  csync();
}

// --------------------------------------------------------------------------
// shared memory: the ring of stages, its barriers, the staged x, scratch
// --------------------------------------------------------------------------
struct Smem {
  int bars, xs, fl, total;
};

// nch: the most chunks a (row, head) has (self or cross)
__host__ __device__ inline Smem smem_layout(int TB, int stages, int G, int H, int nch) {
  Smem s;
  s.bars = stages * STAGE;              // full[stages], empty[stages]
  s.xs = s.bars + 16 * stages;
  // rstd [PASS], red [CGROUPS][PASS], the second half's sums [STRIP][2 planes x 2 x TB x 4], attention
  s.fl = s.xs + 8 * TB * XW * 2;
  const int att = G * H + 2 * H + G * CH + G + 2 * G * nch + G;
  s.total = s.fl + 4 * (PASS + CGROUPS * PASS + STRIP * 16 * TB + att);
  return s;
}

__host__ __device__ inline int max_chunks(int T, int S) {
  const int t = cdiv(T, CH), s = cdiv(S, CH);
  return t > s ? t : s;
}

// --------------------------------------------------------------------------
// the copying warps
// --------------------------------------------------------------------------

// weight rows [k0, k0 + rows) of a strip into a stage; rows past `rows` and
// columns past n are zeros
__device__ __forceinline__ void copy_stage(const Params& p, const Mat& m, int strip, int k0,
                                           int rows, unsigned char* ws, int pt) {
  const int col0 = strip * STRIP;
  if (p.vec16) {  // n % 16 == 0 and 16-byte aligned weights: units wholly in or out
#pragma unroll
    for (int i = pt; i < KC * (STRIP / 16); i += PWARPS * 32) {
      const int r = i / (STRIP / 16), u = i % (STRIP / 16), col = col0 + 16 * u;
      const bool ok = r < rows && col < m.n;
      cp_async16(ws + r * W_STRIDE + 16 * u, ok ? m.w + (size_t)(k0 + r) * m.n + col : m.w, ok);
    }
  } else {
    for (int i = pt; i < KC * (STRIP / 4); i += PWARPS * 32) {
      const int r = i / (STRIP / 4), u = i % (STRIP / 4), col = col0 + 4 * u;
      const bool ok = r < rows && col < m.n;
      cp_async4(ws + r * W_STRIDE + 4 * u, ok ? m.w + (size_t)(k0 + r) * m.n + col : m.w, ok);
    }
  }
}

// every stage of every item of this block, in the order the consuming warps
// take them: layer by layer, phase by phase, item by item, once per pass of
// PASS rows
__device__ void produce(const Params& p, unsigned char* smem, uint64_t* full, uint64_t* empty,
                        Tl& tl) {
  const int pt = threadIdx.x - NC, passes = cdiv(p.B, PASS);
  const int tl_phase[NGEMV] = {PA, PC, PD, PF, PG, PH};
  uint32_t c = 0;
  for (int l = 0; l < p.L; ++l) {
    for (int gph = 0; gph < NGEMV; ++gph) {
      tl.phase(tl_phase[gph]);
      const Mat m0 = mat(p, matrix_of(gph), l);
      const Mat mu = gph == GG ? mat(p, M_U, l) : m0;
      int lo, hi;
      my_range(gemv_items(Dims{m0.kp, m0.n, m0.pair, 0}, gph), gemv_offset(p, gph), lo, hi);
      for (int i = lo; i < hi; ++i) {
        const Item it = item_of(gph, i, m0.ns);
        const Mat& m = it.which == M_U ? mu : m0;
        const int p0 = it.sl * m.slice, len = min(m.slice, m.kp - p0), nst = cdiv(len, KC);
        for (int pass = 0; pass < passes; ++pass)
          for (int j = 0; j < nst; ++j, ++c) {
            const int s = (int)(c % (uint32_t)p.stages);
            if (c >= (uint32_t)p.stages) ring_wait(empty + s, (c / p.stages - 1) & 1);
            tl.mark(TL_FULL);
            copy_stage(p, m, it.strip, p0 + j * KC, min(KC, len - j * KC), smem + s * STAGE, pt);
            bar_arrive_copies(full + s);
            bar_arrive(full + s);
            tl.mark(TL_COPY);
          }
      }
    }
  }
}

// --------------------------------------------------------------------------
// GEMV items on the consuming warps
// --------------------------------------------------------------------------

// bf16x2 words o[j] = (bf16(a.byte j), bf16(b.byte j)) of two words of four
// int8 values, exactly: a half 0x4300 | (q & 127) is 128 + (q & 127), one
// 0x4300 | (q & 128) is 128 (q >= 0) or 256 (q < 0), and their difference is q
__device__ __forceinline__ void widen_pairs(uint32_t a, uint32_t b, uint32_t (&o)[4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint32_t pr = __byte_perm(a, b, j | (4 + j) << 8);  // a.byte j in half 0, b.byte j in 1
    const uint32_t hi = (pr & 0x007F007Fu) | 0x43004300u;
    const uint32_t base = (pr & 0x00800080u) | 0x43004300u;
    const __nv_bfloat162 v = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&hi),
                                     *reinterpret_cast<const __nv_bfloat162*>(&base));
    o[j] = *reinterpret_cast<const uint32_t*>(&v);
  }
}

// the signed low nibbles of bytes 0 and 2 of pr as a bf16x2 word, exactly:
// a nibble u masked into 0x4300 | (u ^ 8) is 136 + q, less 136 in one op
__device__ __forceinline__ uint32_t nibbles(uint32_t pr) {
  const uint32_t u = (pr & 0x000F000Fu) ^ MAGIC, magic = MAGIC;
  const __nv_bfloat162 v = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&u),
                                   *reinterpret_cast<const __nv_bfloat162*>(&magic));
  return *reinterpret_cast<const uint32_t*>(&v);
}

// what a GEMV reads: rms-normed x (src == nullptr; rstd from the sums of
// squares `ss`) or a bf16-rounded buffer [B, K]
struct Input {
  const float* src;
  int K;
  const float* ss;
};

// rstd of rows r0 .. r0 + rows - 1: the strip sums of squares, loaded all at
// once into tmp, added in strip order
__device__ void row_rstd(const Params& p, const float* ss, int r0, int rows, float* tmp,
                         float* rstd) {
  for (int i = threadIdx.x; i < rows * p.nsd; i += NC) tmp[i] = __ldcg(ss + (size_t)r0 * p.nsd + i);
  csync();
  if ((int)threadIdx.x < rows) {
    float a = 0.f;
    for (int j = 0; j < p.nsd; ++j) a += tmp[threadIdx.x * p.nsd + j];
    rstd[threadIdx.x] = 1.f / sqrtf(a / (float)p.D + p.eps);
  }
}

// x of rows r0 .. r0 + 8 TB - 1 for an item's K rows [p0, p0 + len) into xs
// (bf16): plane 0 at columns [0, len), int4's high-nibble plane at [KSLICE,
// KSLICE + len); zeros up to the last stage's end and in rows past B
template <int TB>
__device__ void stage_x(const Params& p, const Mat& m, const Input& in, int p0, int len, int r0,
                        const float* rstd, bf16* xs) {
  const int padded = cdiv(len, KC) * KC, planes = m.pair ? 2 : 1;
  for (int e = threadIdx.x; e < planes * padded; e += NC) {  // a column, every row at once
    const int pl = e / padded, k = e % padded;
    int col = p0 + k;
    if (m.pair) col = col / m.pair * 2 * m.pair + col % m.pair + pl * m.pair;
    float v[8 * TB];
#pragma unroll
    for (int r = 0; r < 8 * TB; ++r) {
      const int b = r0 + r;
      v[r] = 0.f;
      if (k < len && b < p.B)
        v[r] = in.src ? __ldcg(in.src + (size_t)b * in.K + col)
                      : __ldcg(p.x + (size_t)b * p.D + col) * rstd[r];
    }
#pragma unroll
    for (int r = 0; r < 8 * TB; ++r) xs[r * XW + pl * KSLICE + k] = __float2bfloat16(v[r]);
  }
}

// one stage into the sums: a warp's 32 columns, every k-step, each n-tile.
// The lane's weight words of a k-step are columns 4g..4g+3 of the warp's 32
// at rows 2t, 2t+1, 2t+8, 2t+9: column 4g+2m+h is row g+8h of m-tile m.
template <int TB, int PL>
__device__ __forceinline__ void consume_stage(const unsigned char* ws, uint64_t* empty,
                                              const bf16* xs, int x0,
                                              float (&acc)[PL][2][TB][4], int warp, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const unsigned char* wp = ws + (warp % CGROUPS) * 32 + 4 * g;
  uint32_t wv[STEPS][4];
#pragma unroll
  for (int kk = 0; kk < STEPS; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      wv[kk][r] = *reinterpret_cast<const uint32_t*>(
          wp + (kk * KSTEP + 2 * t + (r & 1) + (r >> 1) * 8) * W_STRIDE);
  __syncwarp();
  if (lane == 0) bar_arrive(empty);  // the stage's words are in registers
#pragma unroll
  for (int kk = 0; kk < STEPS; ++kk) {
#pragma unroll
    for (int pl = 0; pl < PL; ++pl) {
      uint32_t a[2][4];
      if constexpr (PL == 1) {
        uint32_t lo[4], hi[4];
        widen_pairs(wv[kk][0], wv[kk][1], lo);
        widen_pairs(wv[kk][2], wv[kk][3], hi);
        a[0][0] = lo[0], a[0][1] = lo[1], a[0][2] = hi[0], a[0][3] = hi[1];
        a[1][0] = lo[2], a[1][1] = lo[3], a[1][2] = hi[2], a[1][3] = hi[3];
      } else {  // halfsplit nibbles: plane pl's k-step (low nibbles, then high)
        uint32_t v01[4], v89[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          v01[j] = nibbles(__byte_perm(wv[kk][0], wv[kk][1], j | (4 + j) << 8) >> (4 * pl));
          v89[j] = nibbles(__byte_perm(wv[kk][2], wv[kk][3], j | (4 + j) << 8) >> (4 * pl));
        }
        a[0][0] = v01[0], a[0][1] = v01[1], a[0][2] = v89[0], a[0][3] = v89[1];
        a[1][0] = v01[2], a[1][1] = v01[3], a[1][2] = v89[2], a[1][3] = v89[3];
      }
      const bf16* xp = xs + pl * KSLICE + x0 + kk * KSTEP + 2 * t;
#pragma unroll
      for (int q = 0; q < TB; ++q) {  // rows 8q + g of x, k 2t..2t+1 and 2t+8..2t+9
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(xp + (8 * q + g) * XW);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(xp + (8 * q + g) * XW + 8);
        mma(acc[pl][0][q], a[0], b0, b1);
        mma(acc[pl][1][q], a[1], b0, b1);
      }
    }
  }
}

// the item's sums of rows r0.. into part[sl, b, col] (int4: each plane times
// its scale row of the slice's tile, added)
template <int TB, int PL>
__device__ void store_partial(const Params& p, const Mat& m, int sl, int strip, int r0,
                              const float (&acc)[PL][2][TB][4], float* part, int warp, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const int col = strip * STRIP + (warp % CGROUPS) * 32 + 4 * g;
  if (col >= m.n) return;
  float slo[4], shi[4];
  if constexpr (PL == 2) {
    const int tile = sl * m.slice / m.pair;
    const float* s_lo = m.s + (size_t)(2 * tile) * m.n + col;
    const float* s_hi = m.s + (size_t)(2 * tile + 1) * m.n + col;
#pragma unroll
    for (int j = 0; j < 4; ++j) slo[j] = __ldg(s_lo + j), shi[j] = __ldg(s_hi + j);
  }
#pragma unroll
  for (int q = 0; q < TB; ++q)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int b = r0 + 8 * q + 2 * t + hh;
      if (b >= p.B) continue;
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {  // column 4g + j: m-tile j / 2, C row g + 8 (j % 2)
        const int mt = j >> 1, e = 2 * (j & 1) + hh;
        v[j] = PL == 1 ? acc[0][mt][q][e] : acc[0][mt][q][e] * slo[j] + acc[1][mt][q][e] * shi[j];
      }
      *reinterpret_cast<float4*>(part + ((size_t)sl * p.B + b) * m.n + col) =
          make_float4(v[0], v[1], v[2], v[3]);
    }
}

__device__ __forceinline__ float sum_slices(const float* part, int nsl, size_t stride, size_t off) {
  float v = 0.f;
#pragma unroll 8
  for (int s = 0; s < nsl; ++s) v += __ldcg(part + s * stride + off);
  return v;
}

// x[:, strip] += sums x scales (part == nullptr: x = x_emb), and each row's sum
// of squares over the strip's columns into ss[b, strip] (a fixed tree)
__device__ void finish_resid(const Params& p, const Mat* m, int strip, const float* part,
                             float* ss, float* red) {
  // thread t: column t % STRIP of the strip, rows t / STRIP, + NC / STRIP, ...
  const int tid = threadIdx.x, group = (tid % STRIP) >> 5, lane = tid & 31;
  const int col = strip * STRIP + tid % STRIP;
  const bool in = col < p.D;
  const float sc = in && m && !m->pair ? __ldg(m->s + col) : 1.f;
  for (int b0 = 0; b0 < p.B; b0 += PASS) {
    const int rows = min(PASS, p.B - b0);
    for (int r = tid / STRIP; r < rows; r += NC / STRIP) {
      const size_t at = (size_t)(b0 + r) * p.D + col;
      float xn = 0.f;
      if (in) {
        xn = m ? __ldcg(p.x + at) + sum_slices(part, m->nsl, (size_t)p.B * p.D, at) * sc
               : __ldg(p.x_emb + at);
        p.x[at] = xn;
      }
      float q = xn * xn;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) q += __shfl_xor_sync(0xffffffffu, q, o);
      if (lane == 0) red[group * PASS + r] = q;
    }
    csync();
    if (tid < rows) {
      float a = red[tid];
#pragma unroll
      for (int w = 1; w < CGROUPS; ++w) a += red[w * PASS + tid];
      ss[(size_t)(b0 + tid) * p.nsd + strip] = a;
    }
    csync();
  }
}

// the strip's epilogue once its last item has arrived: qkv / cq stored,
// SiLU(g) * u into h, or the residual and its sums of squares
__device__ void finish(const Params& p, int gph, const Mat& m, int strip, float* red) {
  // thread t: column t % STRIP of the strip, rows t / STRIP, + NC / STRIP, ...
  const int col = strip * STRIP + (int)threadIdx.x % STRIP, b1 = (int)threadIdx.x / STRIP;
  float* part = p.part[gph == GA || gph == GD || gph == GG ? 0 : 1];
  const size_t pst = (size_t)p.B * m.n;
  if (gph == GC || gph == GF || gph == GH) {
    finish_resid(p, &m, strip, part, p.ss + (size_t)(gph == GC ? 0 : gph == GF ? 1 : 2) * p.B * p.nsd,
                 red);
    return;
  }
  if (col >= m.n) return;
  if (gph == GG) {  // int8: column scales after the sum; int4: applied per slice
    const float sg = m.pair ? 1.f : __ldg(m.s + col);
    const float* su_row = p.s[M_U] + (m.s - p.s[M_G]);
    const float su = m.pair ? 1.f : __ldg(su_row + col);
    for (int b = b1; b < p.B; b += NC / STRIP) {
      const size_t off = (size_t)b * m.n + col;
      const float gv = sum_slices(part, m.nsl, pst, off) * sg;
      const float uv = sum_slices(part + m.nsl * pst, m.nsl, pst, off) * su;
      p.h[off] = bf16r(gv / (1.f + expf(-gv)) * uv);
    }
    return;
  }
  float* out = gph == GA ? p.qkv : p.cq;
  const float sc = __ldg(m.s + col);
  for (int b = b1; b < p.B; b += NC / STRIP) {
    const size_t off = (size_t)b * m.n + col;
    out[off] = sum_slices(part, m.nsl, pst, off) * sc;
  }
}

// --------------------------------------------------------------------------
// attention items on the consuming warps
// --------------------------------------------------------------------------

template <int KIND>
__device__ __forceinline__ float cache_at(const void* base, size_t i) {
  if (KIND == CACHE_F32) return __ldg(static_cast<const float*>(base) + i);
  if (KIND == CACHE_BF16)
    return __bfloat162float(__ldg(static_cast<const __nv_bfloat16*>(base) + i));
  return (float)__ldg(static_cast<const int8_t*>(base) + i);
}

// RoPE of lane d of a head whose unrotated values start at src (fp32, written
// by an earlier phase); the partner lane d +- H/2 is read directly and enters
// rounded to bf16, as the TPU kernel's bf16 half-swap matmul rounds it
__device__ __forceinline__ float rope_at(const Params& p, const float* src, int d, int pos) {
  const int half = p.H / 2;
  const float theta = (float)pos * p.inv_freq[d % half];
  const float c = cosf(theta), s = sinf(theta);
  const float v = __ldcg(src + d);
  const float pt = bf16r(__ldcg(src + (d < half ? d + half : d - half)));
  return d < half ? v * c - pt * s : v * c + pt * s;
}

// the slots [lo, hi) of chunk c of row b: self [valid_from, write_slot), cross [0, cross_ends)
__device__ __forceinline__ void chunk_slots(const Params& p, bool self, int b, int c, int& lo,
                                            int& hi) {
  if (self) {
    lo = max(c * CH, p.vf[b]);
    hi = min(c * CH + CH, p.ws);
  } else {
    lo = c * CH;
    hi = min(min(c * CH + CH, p.cross_ends[b]), p.S);
  }
}

// Ask L2 for the K and V rows of this block's attention chunks of layer l
// (self or cross), so that they wait there when the chunks run (an
// evict-last priority measured no faster: tools/torch_fused_ab.py).
__device__ void prefetch_chunks(const Params& p, int l, bool self) {
  const int NKV = self ? p.Nkv : p.Ncq;
  const int nch = self ? max(1, cdiv(p.ws, CH)) : cdiv(p.S, CH);
  const int T = self ? p.T : p.S;
  const int esize = p.cache == CACHE_F32 ? 4 : p.cache == CACHE_BF16 ? 2 : 1;
  const size_t row_bytes = (size_t)p.H * esize;
  const int lines = (int)cdiv((int)row_bytes, 128);
  int lo_i, hi_i;
  my_range(p.B * NKV * nch, 0, lo_i, hi_i);
  for (int i = lo_i; i < hi_i; ++i) {
    const int c = i % nch, n = (i / nch) % NKV, b = i / (nch * NKV);
    int lo, hi;
    chunk_slots(p, self, b, c, lo, hi);
    const int ns = max(0, hi - lo);
    for (int e = threadIdx.x; e < 2 * ns * lines; e += NC) {
      const int kv = e / (ns * lines), si = e / lines % ns, ln = e % lines;
      const char* base = static_cast<const char*>(kv ? (self ? p.sv : p.cv) : (self ? p.sk : p.ck));
      const char* at = base + ((((size_t)l * p.B + b) * T + lo + si) * NKV + n) * row_bytes + ln * 128;
      asm volatile("prefetch.global.L2 [%0];\n" ::"l"(at));
    }
  }
}

// one chunk of one (row, kv head): self (q from qkv, G = Nq/Nkv heads, the
// current token in chunk 0) or cross (q from cq, one head).  HJ: head dims a
// lane holds (H <= 32 HJ).  same_head: the block's last chunk was of this
// (row, head), so its inputs are met and q is in shared memory.
template <int KIND, int HJ>
__device__ void attention_item(const Params& p, int l, bool self, int item, bool same_head,
                               float* smem, Tl& tl) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int H = p.H;
  const int NKV = self ? p.Nkv : p.Ncq;
  const int G = self ? p.Nq / p.Nkv : 1;
  const int NH = NKV * G;
  const int T = self ? p.T : p.S;
  const int nch = self ? max(1, cdiv(p.ws, CH)) : cdiv(p.S, CH);
  const int nqkv = (p.Nq + 2 * p.Nkv) * H;
  const void* kc = self ? p.sk : p.ck;
  const void* vc = self ? p.sv : p.cv;
  const float* ksc = self ? p.sks : p.cks;
  const float* vsc = self ? p.svs : p.cvs;
  const float scale = 1.f / sqrtf((float)H);

  float* qs = smem;                // [G][H]
  float* kn = qs + G * H;          // [H]
  float* vn = kn + H;              // [H]
  float* sc = vn + H;              // [G][CH]
  float* scur = sc + G * CH;       // [G]
  const int c = item % nch, n = (item / nch) % NKV, b = item / (nch * NKV);
  int lo, hi;
  chunk_slots(p, self, b, c, lo, hi);
  const int ns = max(0, hi - lo);
  const bool cur = self && c == 0;
  const size_t row0 = ((size_t)l * p.B + b) * T;
  // The cache values first, before the wait for this layer's q (they are
  // older): K of the warp's slots (w, w + CWARPS, ...) over the lane's head
  // dims, V of every slot at the thread's head dim (tid < H), the int8
  // scales of the warp's slots (K) and of the lane's slot (V).  One memory
  // latency a chunk, not one a slot.
  float kr[CH / CWARPS][HJ], v[CH], ks[CH / CWARPS], vs = 1.f;
#pragma unroll
  for (int i = 0; i < CH / CWARPS; ++i) {
    const int si = warp + CWARPS * i;
#pragma unroll
    for (int j = 0; j < HJ; ++j) {
      const int d = lane + 32 * j;
      kr[i][j] = si < ns && d < H ? cache_at<KIND>(kc, ((row0 + lo + si) * NKV + n) * H + d) : 0.f;
    }
    ks[i] = KIND == CACHE_I8 && si < ns ? __ldg(ksc + (row0 + lo + si) * NKV + n) : 1.f;
  }
#pragma unroll
  for (int si = 0; si < CH; ++si)
    v[si] = si < ns && tid < H ? cache_at<KIND>(vc, ((row0 + lo + si) * NKV + n) * H + tid) : 0.f;
  if (KIND == CACHE_I8 && lane < ns) vs = __ldg(vsc + (row0 + lo + lane) * NKV + n);
  // its inputs: the qkv strips of the head group, or the cq strips of the head
  if (!same_head) {
    Ranges need;
    need.n = 0;
    if (self) {
      add_strips(need, n * G * H, (n + 1) * G * H);
      add_strips(need, (p.Nq + n) * H, (p.Nq + n + 1) * H);
      add_strips(need, (p.Nq + p.Nkv + n) * H, (p.Nq + p.Nkv + n + 1) * H);
      wait_counters(p.done_qkv, need, l + 1);
    } else {
      add_strips(need, n * H, (n + 1) * H);
      wait_counters(p.done_cq, need, l + 1);
    }
    tl.mark(TL_DEP);
    const int pos = p.pos[b];
#pragma unroll 2
    for (int e = tid; e < G * H; e += NC) {
      const int g = e / H, d = e % H;
      const float* src = self ? p.qkv + (size_t)b * nqkv + (n * G + g) * H
                              : p.cq + ((size_t)b * p.Ncq + n) * H;
      qs[e] = rope_at(p, src, d, pos);
    }
  }
  if (cur) {
    const int pos = p.pos[b];
    const float* kr0 = p.qkv + (size_t)b * nqkv + (p.Nq + n) * H;
    const float* vr = p.qkv + (size_t)b * nqkv + (p.Nq + p.Nkv + n) * H;
    for (int d = tid; d < H; d += NC) {
      const float kd = rope_at(p, kr0, d, pos), vd = __ldcg(vr + d);
      kn[d] = kd;
      vn[d] = vd;
      const size_t o = (((size_t)l * p.B + b) * p.Nkv + n) * H + d;
      p.kv_out[o] = kd;
      p.kv_out[(size_t)p.L * p.B * p.Nkv * H + o] = vd;
    }
  }
  csync();
  tl.mark(TL_ATT_LOAD);
  // scores: lane-strided dot products, butterfly sums
#pragma unroll
  for (int i = 0; i < CH / CWARPS; ++i) {
    const int si = warp + CWARPS * i;
    if (si >= ns) continue;
    for (int g = 0; g < G; ++g) {
      float a = 0.f;
#pragma unroll
      for (int j = 0; j < HJ; ++j)
        if (lane + 32 * j < H) a = fmaf(qs[g * H + lane + 32 * j], kr[i][j], a);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) a += __shfl_xor_sync(0xffffffffu, a, o);
      if (lane == 0) sc[g * CH + si] = a * scale * ks[i];
    }
  }
  if (cur && warp == 0) {  // the current token's key
    for (int g = 0; g < G; ++g) {
      float a = 0.f;
      for (int d = lane; d < H; d += 32) a = fmaf(qs[g * H + d], kn[d], a);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) a += __shfl_xor_sync(0xffffffffu, a, o);
      if (lane == 0) scur[g] = a * scale;
    }
  }
  csync();
  // chunk softmax partials: a warp a head, a lane a slot, butterfly max and sum
  const size_t pbase = ((size_t)b * NH + n * G) * nch + c;  // + g * nch
  for (int g = warp; g < G; g += CWARPS) {
    const float s = lane < ns ? sc[g * CH + lane] : NEG;
    float m = s;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    if (cur) m = fmaxf(m, scur[g]);
    const float e = lane < ns ? expf(s - m) : 0.f;
    float lsum = e;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) lsum += __shfl_xor_sync(0xffffffffu, lsum, o);
    if (lane < ns) sc[g * CH + lane] = KIND == CACHE_I8 ? e * vs : e;
    if (lane == 0) {
      if (cur) {
        const float ec = expf(scur[g] - m);
        lsum += ec;
        scur[g] = ec;
      }
      p.am[pbase + (size_t)g * nch] = m;
      p.al[pbase + (size_t)g * nch] = lsum;
    }
  }
  csync();
  // values: a thread a head dim
  if (tid < H) {
    for (int g = 0; g < G; ++g) {
      float a = 0.f;
#pragma unroll
      for (int si = 0; si < CH; ++si)
        if (si < ns) a = fmaf(sc[g * CH + si], v[si], a);
      if (cur) a = fmaf(scur[g], vn[tid], a);
      p.apart[(pbase + (size_t)g * nch) * H + tid] = a;
    }
  }
  release((self ? p.arrived_self : p.arrived_cross) + b * NKV + n);  // the chunk's partials
}

// Combine the chunks of (row b, kv head n) in chunk order once all have
// arrived: the chunks' maxima and sums into shared memory, each head's
// weights and denominator, then each (head, dim) over the chunks, four
// chunks' partials in flight.
__device__ void combine_chunks(const Params& p, int l, bool self, int b, int n, float* smem) {
  const int tid = threadIdx.x;
  const int H = p.H;
  const int NKV = self ? p.Nkv : p.Ncq;
  const int G = self ? p.Nq / p.Nkv : 1;
  const int NH = NKV * G;
  const int nch = self ? max(1, cdiv(p.ws, CH)) : cdiv(p.S, CH);
  float* cm = smem + G * H + 2 * H + G * CH + G;  // after the chunk's own scratch
  float* cl = cm + G * nch;
  float* cden = cl + G * nch;
  wait_one((self ? p.arrived_self : p.arrived_cross) + b * NKV + n, (unsigned)(l + 1) * nch);
  const size_t gbase = ((size_t)b * NH + n * G) * nch;  // + g * nch + chunk
  for (int i = tid; i < G * nch; i += NC) {
    cm[i] = __ldcg(p.am + gbase + i);
    cl[i] = __ldcg(p.al + gbase + i);
  }
  csync();
  if (tid < G) {
    const int g = tid;
    float mx = NEG;
    for (int k = 0; k < nch; ++k) mx = fmaxf(mx, cm[g * nch + k]);
    if (!self && mx <= NEG * 0.5f) mx = 0.f;  // a row with no keys: exact zeros
    float den = 0.f;
    for (int k = 0; k < nch; ++k) {
      const float f = expf(cm[g * nch + k] - mx);
      cm[g * nch + k] = f;
      den = fmaf(cl[g * nch + k], f, den);
    }
    cden[g] = self ? den : fmaxf(den, 1e-30f);
  }
  csync();
  constexpr int EJ = 2, KK = 8;  // (head, dim) outputs a thread, chunks in flight
  for (int e0 = tid; e0 < G * H; e0 += EJ * NC) {
    float num[EJ] = {0.f, 0.f};
    for (int k0 = 0; k0 < nch; k0 += KK) {
      float part[KK][EJ];
#pragma unroll
      for (int kk = 0; kk < KK; ++kk)
#pragma unroll
        for (int j = 0; j < EJ; ++j) {
          const int e = e0 + j * NC, k = k0 + kk;
          part[kk][j] = e < G * H && k < nch
                            ? __ldcg(p.apart + (gbase + (size_t)(e / H) * nch + k) * H + e % H)
                            : 0.f;
        }
#pragma unroll
      for (int kk = 0; kk < KK; ++kk)
#pragma unroll
        for (int j = 0; j < EJ; ++j) {
          const int e = e0 + j * NC;
          if (e < G * H && k0 + kk < nch) num[j] = fmaf(part[kk][j], cm[(e / H) * nch + k0 + kk], num[j]);
        }
    }
#pragma unroll
    for (int j = 0; j < EJ; ++j) {
      const int e = e0 + j * NC;
      if (e < G * H) p.att[((size_t)b * NH + n * G) * H + e] = bf16r(num[j] / cden[e / H]);
    }
  }
  release((self ? p.done_att : p.done_catt) + n);
}

// head dims a lane holds: 4 up to H = 128, else 8
template <int KIND>
__device__ void attention_chunk(const Params& p, int l, bool self, int item, int first,
                                float* smem, Tl& tl) {
  const int nch = self ? max(1, cdiv(p.ws, CH)) : cdiv(p.S, CH);
  const bool same_head = item > first && item / nch == (item - 1) / nch;
  if (p.H <= 128) attention_item<KIND, 4>(p, l, self, item, same_head, smem, tl);
  else attention_item<KIND, MAX_H / 32>(p, l, self, item, same_head, smem, tl);
}

__device__ void attention_phase(const Params& p, int l, bool self, float* smem, Tl& tl) {
  const int nkv = self ? p.Nkv : p.Ncq;
  const int nch = self ? max(1, cdiv(p.ws, CH)) : cdiv(p.S, CH);
  int lo, hi;
  my_range(p.B * nkv * nch, 0, lo, hi);
  for (int i = lo; i < hi; ++i) {
    if (p.cache == CACHE_F32) attention_chunk<CACHE_F32>(p, l, self, i, lo, smem, tl);
    else if (p.cache == CACHE_BF16) attention_chunk<CACHE_BF16>(p, l, self, i, lo, smem, tl);
    else attention_chunk<CACHE_I8>(p, l, self, i, lo, smem, tl);
    tl.mark(TL_ATT);
  }
  // the (row, head) pairs whose last chunk this block ran, after its own chunks
  for (int i = lo; i < hi; ++i)
    if (i % nch == nch - 1) {
      combine_chunks(p, l, self, i / (nch * nkv), (i / nch) % nkv, smem);
      tl.mark(TL_FIN);
    }
}

// --------------------------------------------------------------------------
// a GEMV phase on the consuming warps
// --------------------------------------------------------------------------
struct Consumer {
  unsigned char* smem;
  uint64_t* full;
  uint64_t* empty;
  bf16* xs;
  float* rstd;  // [8 TB]
  float* red;   // [CGROUPS][PASS]
  float* half;  // [PL x 2 x TB x 4][STRIP]: the second half's sums of an item
  uint32_t c;        // stages consumed
  long long xkey;    // what xs holds
  long long rkey;    // what rstd holds
};

template <int TB, int PL>
__device__ void gemv_pass(const Params& p, const Mat& m, const Item& it, int p0, int len, int r0,
                          float* part, Consumer& k, Tl& tl) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float acc[PL][2][TB][4];
#pragma unroll
  for (int pl = 0; pl < PL; ++pl)
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int q = 0; q < TB; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[pl][mt][q][e] = 0.f;
  // half h takes the item's stages h, h + HALVES, ...; every warp counts them all
  const int nst = cdiv(len, KC), h = warp / CGROUPS, tt = threadIdx.x % STRIP;
  for (int j = 0; j < nst; ++j, ++k.c) {
    if (j % HALVES != h) continue;
    const int s = (int)(k.c % (uint32_t)p.stages);
    ring_wait(k.full + s, (k.c / p.stages) & 1);
    tl.mark(TL_RING);
    consume_stage<TB, PL>(k.smem + s * STAGE, k.empty + s, k.xs, j * KC, acc, warp, lane);
    tl.mark(TL_MMA);
  }
  // the first half's sums plus the second's, in that order
  if (h == 1) {
#pragma unroll
    for (int pl = 0; pl < PL; ++pl)
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int q = 0; q < TB; ++q)
#pragma unroll
          for (int e = 0; e < 4; ++e) k.half[(((pl * 2 + mt) * TB + q) * 4 + e) * STRIP + tt] = acc[pl][mt][q][e];
  }
  csync();
  if (h == 1) return;
#pragma unroll
  for (int pl = 0; pl < PL; ++pl)
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int q = 0; q < TB; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[pl][mt][q][e] += k.half[(((pl * 2 + mt) * TB + q) * 4 + e) * STRIP + tt];
  store_partial<TB, PL>(p, m, it.sl, it.strip, r0, acc, part, warp, lane);
}

template <int TB>
__device__ void gemv_phase(const Params& p, int l, int gph, Consumer& k, Tl& tl) {
  const int tl_phase[NGEMV] = {PA, PC, PD, PF, PG, PH};
  tl.phase(tl_phase[gph]);
  if (gph == GA || gph == GD) prefetch_chunks(p, l, gph == GA);  // the next phase's attention
  const Mat m0 = mat(p, matrix_of(gph), l);
  const Mat mu = gph == GG ? mat(p, M_U, l) : m0;
  const int n_items = gemv_items(Dims{m0.kp, m0.n, m0.pair, 0}, gph);
  float* part = p.part[gph == GA || gph == GD || gph == GG ? 0 : 1];
  Input in{nullptr, p.D, nullptr};
  if (gph == GA) in.ss = p.ss + (size_t)2 * p.B * p.nsd;
  if (gph == GD) in.ss = p.ss;
  if (gph == GG) in.ss = p.ss + (size_t)p.B * p.nsd;
  if (gph == GC) in = Input{p.att, p.Nq * p.H, nullptr};
  if (gph == GF) in = Input{p.att, p.Ncq * p.H, nullptr};
  if (gph == GH) in = Input{p.h, p.F, nullptr};
  int lo, hi;
  my_range(n_items, gemv_offset(p, gph), lo, hi);
  for (int i = lo; i < hi; ++i) {
    const Item it = item_of(gph, i, m0.ns);
    const Mat& m = it.which == M_U ? mu : m0;
    const int p0 = it.sl * m.slice, len = min(m.slice, m.kp - p0);
    // wait for exactly what the item reads
    if (gph == GC || gph == GF || gph == GH) {
      Ranges need;
      need.n = 0;
      if (gph == GC) {  // the head groups of its K rows
        const int G = p.Nq / p.Nkv;
        need.lo[0] = p0 / p.H / G, need.hi[0] = (p0 + len - 1) / p.H / G + 1, need.n = 1;
        wait_counters(p.done_att, need, (unsigned)(l + 1) * p.B);
      } else if (gph == GF) {  // the heads of its K rows
        need.lo[0] = p0 / p.H, need.hi[0] = (p0 + len - 1) / p.H + 1, need.n = 1;
        wait_counters(p.done_catt, need, (unsigned)(l + 1) * p.B);
      } else {  // the h strips its rows meet (int4: both nibble planes)
        if (m.pair) {
          const int base = p0 / m.pair * 2 * m.pair + p0 % m.pair;
          add_strips(need, base, base + len);
          add_strips(need, base + m.pair, base + m.pair + len);
        } else {
          add_strips(need, p0, p0 + len);
        }
        wait_counters(p.done_h, need, l + 1);
      }
      tl.mark(TL_DEP);
    }
    for (int r0 = 0; r0 < p.B; r0 += PASS) {
      const long long key = (((long long)l * NGEMV + gph) * 65536 + it.sl) * 1024 + r0 / PASS;
      if (key != k.xkey) {
        csync();  // every warp is done with the last x
        const long long rk = ((long long)l * NGEMV + gph) * 1024 + r0 / PASS;
        if (in.src == nullptr && rk != k.rkey) {
          row_rstd(p, in.ss, r0, min(8 * TB, p.B - r0), reinterpret_cast<float*>(k.xs), k.rstd);
          k.rkey = rk;
          csync();
        }
        stage_x<TB>(p, m, in, p0, len, r0, k.rstd, k.xs);
        k.xkey = key;
        csync();
        tl.mark(TL_X);
      }
      float* dst = part + (it.which == M_U ? (size_t)m.nsl * p.B * m.n : 0);
      if (m.pair) gemv_pass<TB, 2>(p, m, it, p0, len, r0, dst, k, tl);
      else gemv_pass<TB, 1>(p, m, it, p0, len, r0, dst, k, tl);
    }
    release(p.arrived[gph] + it.strip);  // the item's partial is stored
    tl.mark(TL_ARRIVE);
  }
  // The strips whose last item (the last slice; gate/up: its up item) this
  // block ran: once all the strip's items have arrived, its epilogue.  Only
  // after the block's own items of the phase, so that no two blocks wait on
  // each other's unfinished items.
  const unsigned arrivals = (gph == GG ? 2 : 1) * m0.nsl;
  for (int i = lo; i < hi; ++i) {
    const Item it = item_of(gph, i, m0.ns);
    if (it.sl != m0.nsl - 1 || it.which == M_G) continue;
    wait_one(p.arrived[gph] + it.strip, (unsigned)(l + 1) * arrivals);
    finish(p, gph, m0, it.strip, k.red);
    if (gph == GA) release(p.done_qkv + it.strip);
    if (gph == GD) release(p.done_cq + it.strip);
    if (gph == GG) release(p.done_h + it.strip);
    tl.mark(TL_FIN);
  }
}

// --------------------------------------------------------------------------
// the kernel
// --------------------------------------------------------------------------

// TB n-tiles (8 rows each) of x a pass; one block an SM
template <int TB>
__global__ void __launch_bounds__(NT, 1) fused_step_kernel(Params params) {
  extern __shared__ __align__(16) unsigned char smem[];
  // the parameters in shared memory: every function takes them by reference
  // without a copy of the struct in local memory
  __shared__ Params sp;
  if (threadIdx.x == 0) {
    sp = params;
    // read once per block, before any chunk is planned; the loop keeps the slot
    // inside the cache, the clamp keeps a bad one from reading past it
    sp.ws = min(max(__ldg(params.wsp), 0), params.T - 1);
  }
  __syncthreads();
  const Params& p = sp;
  const Smem lay = smem_layout(TB, p.stages, p.Nq / p.Nkv, p.H, max_chunks(p.T, p.S));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + lay.bars);
  uint64_t* empty = full + p.stages;
  float* rstd = reinterpret_cast<float*>(smem + lay.fl);
  float* red = rstd + PASS;
  float* half = red + CGROUPS * PASS;
  float* att = half + STRIP * 16 * TB;
  const int tid = threadIdx.x;
  Tl tl;
  tl.start();
#ifdef FUSED_TIMELINE
  if (tid == 0) {
    for (int a = 0; a < 8; ++a)
      for (int c = 0; c < NTL; ++c) g_tl[blockIdx.x][a][c] = 0;
    g_span[blockIdx.x][0] = gtime();
    g_span[blockIdx.x][2] = clock64();
  }
#endif
  if (tid == 0) {
    for (int s = 0; s < p.stages; ++s) {
      // each copying thread once its cp.async copies have landed, once after them
      bar_init(full + s, 2 * PWARPS * 32);
      bar_init(empty + s, CGROUPS);  // the warps of the half that takes the stage
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // start-up: counters zeroed, x = x_emb with its sums of squares
  for (int i = blockIdx.x * NT + tid; i < p.ncnt; i += gridDim.x * NT) p.cnt[i] = 0u;
  if (tid < NC)
    for (int strip = blockIdx.x; strip < p.nsd; strip += gridDim.x)
      finish_resid(p, nullptr, strip, nullptr, p.ss + (size_t)2 * p.B * p.nsd, red);
  cg::this_grid().sync();
  tl.mark(TL_BAR);

  if (tid >= NC) {
    produce(p, smem, full, empty, tl);
    return;
  }
  Consumer k{smem, full, empty, reinterpret_cast<bf16*>(smem + lay.xs), rstd, red, half, 0u, -1,
             -1};
  unsigned epoch = 0;
  for (int l = 0; l < p.L; ++l) {
    gemv_phase<TB>(p, l, GA, k, tl);
    tl.phase(PB);
    attention_phase(p, l, true, att, tl);
    gemv_phase<TB>(p, l, GC, k, tl);
    grid_barrier(p.gbar, ++epoch * gridDim.x);
    tl.mark(TL_BAR);
    gemv_phase<TB>(p, l, GD, k, tl);
    tl.phase(PE);
    attention_phase(p, l, false, att, tl);
    gemv_phase<TB>(p, l, GF, k, tl);
    grid_barrier(p.gbar, ++epoch * gridDim.x);
    tl.mark(TL_BAR);
    gemv_phase<TB>(p, l, GG, k, tl);
    gemv_phase<TB>(p, l, GH, k, tl);
    if (l + 1 < p.L) {
      grid_barrier(p.gbar, ++epoch * gridDim.x);
      tl.mark(TL_BAR);
    }
  }
#ifdef FUSED_TIMELINE
  if (tid == 0) {
    g_span[blockIdx.x][1] = gtime();
    g_span[blockIdx.x][3] = clock64();
  }
#endif
}

// --------------------------------------------------------------------------
// host side: workspace layout, shared memory, launch
// --------------------------------------------------------------------------

// counters, in this order in the workspace's counter array
enum { C_GBAR, C_ARRIVED, C_DONE_QKV = C_ARRIVED + NGEMV, C_DONE_CQ, C_DONE_H, C_ARRIVED_SELF,
       C_ARRIVED_CROSS, C_DONE_ATT, C_DONE_CATT, C_COUNT };

struct Layout {
  size_t qkv, cq, att, h, part0, part1, ss, apart, am, al, cnt, total;
  int coff[C_COUNT + 1];  // offsets into the counters; coff[C_COUNT] = their number
  int nsd;
};

size_t align_up(size_t v) { return (v + 255) / 256 * 256; }

Layout layout(int B, int D, int F, int Nq, int Nkv, int Ncq, int H, int T, int S, int int4,
              int mt) {
  Layout o;
  const int nqkv = (Nq + 2 * Nkv) * H;
  size_t p0 = 0, p1 = 0;  // floats a row of each partial region
  int strips[NGEMV];
  for (int g = 0; g < NGEMV; ++g) {
    const Dims d = dims_of(matrix_of(g), D, F, Nq, Nkv, Ncq, H, int4, mt);
    const size_t per = (size_t)cdiv(d.kp, slice_rows(d.kp, d.pair)) * d.n * (g == GG ? 2 : 1);
    size_t& r = g == GA || g == GD || g == GG ? p0 : p1;
    r = per > r ? per : r;
    strips[g] = cdiv(d.n, STRIP);
  }
  o.nsd = cdiv(D, STRIP);
  const int nhmax = Nq > Ncq ? Nq : Ncq;
  int nch_max = cdiv(T, CH) > cdiv(S, CH) ? cdiv(T, CH) : cdiv(S, CH);
  if (nch_max < 1) nch_max = 1;
  const int sizes[C_COUNT] = {1, strips[GA], strips[GC], strips[GD], strips[GF], strips[GG],
                              strips[GH], cdiv(nqkv, STRIP), cdiv(Ncq * H, STRIP), cdiv(F, STRIP),
                              B * Nkv, B * Ncq, Nkv, Ncq};
  o.coff[0] = 0;
  for (int i = 0; i < C_COUNT; ++i) o.coff[i + 1] = o.coff[i] + sizes[i];
  size_t at = 0;
  auto take = [&](size_t bytes) { const size_t here = at; at += align_up(bytes); return here; };
  o.qkv = take(sizeof(float) * B * nqkv);
  o.cq = take(sizeof(float) * B * Ncq * H);
  o.att = take(sizeof(float) * B * nhmax * H);
  o.h = take(sizeof(float) * B * F);
  o.part0 = take(sizeof(float) * B * p0);
  o.part1 = take(sizeof(float) * B * p1);
  o.ss = take(sizeof(float) * 3 * B * o.nsd);
  o.apart = take(sizeof(float) * (size_t)B * nhmax * nch_max * H);
  o.am = take(sizeof(float) * (size_t)B * nhmax * nch_max);
  o.al = take(sizeof(float) * (size_t)B * nhmax * nch_max);
  o.cnt = take(sizeof(unsigned) * o.coff[C_COUNT]);
  o.total = at;
  return o;
}

template <int TB>
cudaError_t launch(Params& p, cudaStream_t stream) {
  auto kernel = fused_step_kernel<TB>;
  int dev = 0, sms = 0, coop = 0, optin = 0, per_sm_bytes = 0, per_sm = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)) !=
          cudaSuccess ||
      (err = cudaDeviceGetAttribute(&per_sm_bytes, cudaDevAttrMaxSharedMemoryPerMultiprocessor,
                                    dev)) != cudaSuccess)
    return err;
  if (!coop) return cudaErrorNotSupported;
  // the ring takes what the blocks an SM leave (1 KB a block is the system's)
  const int G = p.Nq / p.Nkv;
  int budget = per_sm_bytes - 1024;  // one block an SM (1 KB of it is the system's)
  if (budget > optin) budget = optin;
  budget -= (int)sizeof(Params) + 64;  // the kernel's static copy of its parameters
  const int nch = max_chunks(p.T, p.S);
  int stages = (budget - smem_layout(TB, 0, G, p.H, nch).total) / (STAGE + 16);
  if (stages > MAX_STAGES) stages = MAX_STAGES;
  if (stages < 2) return cudaErrorInvalidValue;
  p.stages = stages;
  const int smem = smem_layout(TB, stages, G, p.H, nch).total;
  if ((err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem)) !=
      cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, NT, smem)) !=
      cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  per_sm = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(per_sm * sms);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if ((err = cudaLaunchKernelEx(&cfg, kernel, p)) != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// Bytes of device scratch fused_step_fwd needs for these shapes.
extern "C" int fused_step_workspace_bytes(int B, int D, int F, int Nq, int Nkv, int Ncq, int H,
                                          int T, int S, int int4, int mt, long long* out) {
  if (B <= 0 || mt <= 0 || Nkv <= 0) return cudaErrorInvalidValue;
  *out = (long long)layout(B, D, F, Nq, Nkv, Ncq, H, T, S, int4, mt).total;
  return cudaSuccess;
}

// Weights/scales in the FusedPack order (wqkv, sqkv, wo, so, wcq, scq, wco,
// sco, wg, sg, wu, su, wm, sm), x_emb fp32 [B, D], int32 pos / valid_from /
// cross_ends [B], the int32 write slot [1] (device memory: each replay of a
// captured step reads the slot of its own), inv_freq fp32 [H/2], the four
// caches ([L, B, T|S, N, H],
// dtype `cache`: 0 fp32, 1 bf16, 2 int8) and, for int8, their four fp32
// scale tensors (else null); out x fp32 [B, D], kv fp32 [2, L, B, Nkv, H];
// work: fused_step_workspace_bytes of scratch.  All contiguous.  One
// cooperative launch on `stream`; returns its cudaError_t.
extern "C" int fused_step_fwd(
    const void* wqkv, const void* sqkv, const void* wo, const void* so, const void* wcq,
    const void* scq, const void* wco, const void* sco, const void* wg, const void* sg,
    const void* wu, const void* su, const void* wm, const void* sm, const void* x_emb,
    const void* pos, const void* vf, const void* cross_ends, const void* ws,
    const void* inv_freq,
    const void* sk, const void* sv, const void* ck, const void* cv, const void* sks,
    const void* svs, const void* cks, const void* cvs, void* x, void* kv, void* work,
    int L, int B, int D, int F, int Nq, int Nkv, int Ncq, int H, int T, int S,
    int cache, int int4, int mt, long long work_bytes, float eps, void* stream) {
  if (L <= 0 || B <= 0 || D <= 0 || F <= 0 || Nq <= 0 || Nkv <= 0 ||
      Nq % Nkv || Ncq <= 0 || H <= 0 || H % 2 || T <= 0 || S <= 0 || !ws ||
      cache < 0 || cache > 2 || mt <= 0 || (Nq / Nkv) * H > MAX_GH || H > MAX_H)
    return cudaErrorInvalidValue;
  const int nqkv = (Nq + 2 * Nkv) * H;
  if (nqkv % 4 || D % 4 || (Ncq * H) % 4 || F % 4) return cudaErrorInvalidValue;
  if (int4 && (D % 2 || F % (2 * mt))) return cudaErrorInvalidValue;
  if (cache == CACHE_I8 && (!sks || !svs || !cks || !cvs)) return cudaErrorInvalidValue;
  if (cdiv(D, STRIP) * 8 > XW) return cudaErrorInvalidValue;  // row_rstd's loads fit xs
  const Layout lo = layout(B, D, F, Nq, Nkv, Ncq, H, T, S, int4, mt);
  if (work_bytes < (long long)lo.total) return cudaErrorInvalidValue;
  Params p;
  const void* ws7[7] = {wqkv, wo, wcq, wco, wg, wu, wm};
  const void* ss7[7] = {sqkv, so, scq, sco, sg, su, sm};
  p.vec16 = 1;
  for (int i = 0; i < 7; ++i) {
    p.w[i] = static_cast<const int8_t*>(ws7[i]);
    p.s[i] = static_cast<const float*>(ss7[i]);
    if (reinterpret_cast<uintptr_t>(ws7[i]) % 4) return cudaErrorInvalidValue;
    if (reinterpret_cast<uintptr_t>(ws7[i]) % 16 ||
        dims_of(i, D, F, Nq, Nkv, Ncq, H, int4, mt).n % 16)
      p.vec16 = 0;
  }
  p.x_emb = static_cast<const float*>(x_emb);
  p.pos = static_cast<const int*>(pos);
  p.vf = static_cast<const int*>(vf);
  p.wsp = static_cast<const int*>(ws);
  p.cross_ends = static_cast<const int*>(cross_ends);
  p.inv_freq = static_cast<const float*>(inv_freq);
  p.sk = sk;
  p.sv = sv;
  p.ck = ck;
  p.cv = cv;
  p.sks = static_cast<const float*>(sks);
  p.svs = static_cast<const float*>(svs);
  p.cks = static_cast<const float*>(cks);
  p.cvs = static_cast<const float*>(cvs);
  p.x = static_cast<float*>(x);
  p.kv_out = static_cast<float*>(kv);
  char* wb = static_cast<char*>(work);
  p.qkv = reinterpret_cast<float*>(wb + lo.qkv);
  p.cq = reinterpret_cast<float*>(wb + lo.cq);
  p.att = reinterpret_cast<float*>(wb + lo.att);
  p.h = reinterpret_cast<float*>(wb + lo.h);
  p.part[0] = reinterpret_cast<float*>(wb + lo.part0);
  p.part[1] = reinterpret_cast<float*>(wb + lo.part1);
  p.ss = reinterpret_cast<float*>(wb + lo.ss);
  p.apart = reinterpret_cast<float*>(wb + lo.apart);
  p.am = reinterpret_cast<float*>(wb + lo.am);
  p.al = reinterpret_cast<float*>(wb + lo.al);
  p.cnt = reinterpret_cast<unsigned*>(wb + lo.cnt);
  p.ncnt = lo.coff[C_COUNT];
  p.gbar = p.cnt + lo.coff[C_GBAR];
  for (int g = 0; g < NGEMV; ++g) p.arrived[g] = p.cnt + lo.coff[C_ARRIVED + g];
  p.done_qkv = p.cnt + lo.coff[C_DONE_QKV];
  p.done_cq = p.cnt + lo.coff[C_DONE_CQ];
  p.done_h = p.cnt + lo.coff[C_DONE_H];
  p.arrived_self = p.cnt + lo.coff[C_ARRIVED_SELF];
  p.arrived_cross = p.cnt + lo.coff[C_ARRIVED_CROSS];
  p.done_att = p.cnt + lo.coff[C_DONE_ATT];
  p.done_catt = p.cnt + lo.coff[C_DONE_CATT];
  p.L = L; p.B = B; p.D = D; p.F = F; p.Nq = Nq; p.Nkv = Nkv; p.Ncq = Ncq; p.H = H;
  p.T = T; p.S = S; p.ws = 0; p.cache = cache; p.int4 = int4; p.mt = mt;
  p.nsd = lo.nsd;
  p.stages = 0;
  p.eps = eps;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#ifdef FUSED_TB
  // a build of one row tiling (chip_smoke.py's planted-fault copies, which run
  // at B = 2): FUSED_TB n-tiles a pass, and only rows it holds in one pass
  if (B > 8 * FUSED_TB) return cudaErrorInvalidValue;
  return launch<FUSED_TB>(p, s);
#else
  if (B <= 8) return launch<1>(p, s);
  if (B <= 16) return launch<2>(p, s);
  if (B <= 32) return launch<4>(p, s);
  return launch<8>(p, s);
#endif
}

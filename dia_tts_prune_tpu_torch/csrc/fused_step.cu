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
// the int4 MLP, at B = 2 a few operations per byte) and, at few rows, the
// latency of 8 dependent phases per layer.  On Hopper the blocks run in
// parallel, so each phase boundary is a grid-wide barrier
// (cooperative_groups::this_grid().sync()), and every block must be
// resident: the grid is sized from the occupancy calculator, and a launch the
// card cannot hold comes back as an error, never a hang.
//
// Phases of a layer, each spread over all blocks by a loop over work items:
//   A  rms(x) -> bf16 -> qkv GEMV                     (items: column strip x K slice)
//   B  self-attention, 32-slot chunks per (row, kv head), RoPE'd q/k on the fly
//   C  o_proj GEMV on the combined attention, x += ...
//   D  rms(x) -> cq GEMV
//   E  cross-attention, 32-key chunks per (row, head)
//   F  co_proj GEMV, x += ...
//   G  rms(x) -> gate and up GEMVs (one item reads both) -> h = bf16(silu(g)*u)
//   H  wm GEMV, x += ...
// A GEMV item owns 128 columns (a warp's 32 lanes x 4 bytes) and a slice of
// K; its 8 warps walk the slice's rows with 8 loads in flight per lane,
// every weight element is loaded once for up to RG rows (the rows are staged
// in shared memory RG at a time, and further groups, like rows beyond RT,
// re-read the item from cache), and the item's fp32 partial goes to scratch.  The
// last item of a strip to finish (an atomic counter decides who, not in
// which order anything is summed) adds the partials in slice order and runs
// the strip's epilogue.  Attention chunks keep (m, l, acc) partials, and the
// last chunk of a (row, head group) combines them in chunk order.  So every
// value's reduction order follows from K, N, the chunk size and the slot
// range alone: a row's result is the same bit for bit whatever the number of
// rows, the grid size or the run.  Slots outside a row's ranges are never
// read.  Everything is fp32 FMA on widened int8 (wgmma, TMA and cp.async
// rings are later work).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cooperative_groups.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int NT = 256;
constexpr int NWARPS = NT / 32;
constexpr int VEC = 4;             // int8 columns a lane loads at once
constexpr int STRIP = 32 * VEC;    // columns of a GEMV item
constexpr int DEPTH = 8;           // rows whose loads a lane has in flight
constexpr int CH = 32;             // cache slots of an attention chunk
constexpr int RG = 16;             // rows staged in shared memory at once
constexpr int MAX_GH = 4096;       // query heads x head_dim of an attention item
constexpr float NEG = -1e30f;

// cache kinds
constexpr int CACHE_F32 = 0, CACHE_BF16 = 1, CACHE_I8 = 2;

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// shared-memory floats before the phases' scratch: rstd of every row
__host__ __device__ inline int rstd_floats(int B) { return cdiv(B, 4) * 4; }

// K rows of a GEMV item: a power of two in [64, 512] giving at most 16
// slices, cut to divide `pair` (an int4 item must lie inside one pairing tile)
__host__ __device__ inline int plan_slice(int kp, int pair) {
  int s = 64;
  while (s * 16 < kp && s < 512) s *= 2;
  if (pair > 0)
    while (pair % s) s /= 2;
  return s;
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
  float* part;         // [2, MS, B, NMAX] GEMV partials
  float* apart;        // [B, NHMAX, NCH, H] attention partials
  float* am;           // [B, NHMAX, NCH]
  float* al;
  unsigned* cnt;       // [NCNT]
  int L, B, D, F, Nq, Nkv, Ncq, H, T, S, ws, cache, int4, mt;
  int ms, nmax, nch_max, ncnt;
  float eps;
};

struct Job {
  const int8_t* w;
  const float* s;
  int kp, n, pair, slice, nsl, nstrips;
};

__device__ inline Job make_job(const Params& p, int which, int l, int kp, int n, int pair,
                               int s_per_layer) {
  Job j;
  j.w = p.w[which] + (size_t)l * kp * n;
  j.s = p.s[which] + (size_t)l * s_per_layer;
  j.kp = kp;
  j.n = n;
  j.pair = pair;
  j.slice = plan_slice(kp, pair);
  j.nsl = cdiv(kp, j.slice);
  j.nstrips = cdiv(n, STRIP);
  return j;
}

// --------------------------------------------------------------------------
// rms(x) of every row, the same in every block: fixed-order sums
// --------------------------------------------------------------------------
__device__ void row_rstd(const Params& p, float* rstd, float* red) {
  const int tid = threadIdx.x;
  for (int b = 0; b < p.B; ++b) {
    float acc = 0.f;
    for (int k = tid; k < p.D; k += NT) {
      const float v = __ldcg(p.x + (size_t)b * p.D + k);
      acc = fmaf(v, v, acc);
    }
    red[tid] = acc;
    __syncthreads();
    for (int w = NT / 2; w > 0; w >>= 1) {
      if (tid < w) red[tid] += red[tid + w];
      __syncthreads();
    }
    if (tid == 0) rstd[b] = 1.f / sqrtf(red[0] / (float)p.D + p.eps);
    __syncthreads();
  }
}

// --------------------------------------------------------------------------
// GEMV items
// --------------------------------------------------------------------------

// input of a GEMV: rms-normed x (src == nullptr) or a bf16-rounded buffer
struct Input {
  const float* src;  // [B, K]
  int K;
  float* rstd;
};

__device__ __forceinline__ float in_value(const Params& p, const Input& in, int b, int k) {
  if (in.src == nullptr) return bf16r(__ldcg(p.x + (size_t)b * p.D + k) * in.rstd[b]);
  return __ldcg(in.src + (size_t)b * in.K + k);
}

// x of the item's rows r0 .. r0 + rows - 1 into shared memory: xs[b][i]
// (int8) or xs[b][0|1][i] (int4 low / high nibble rows); rows past B are zero
template <bool INT4>
__device__ void stage_x(const Params& p, const Job& j, const Input& in, int p0, int len,
                        int r0, int rows, float* xs) {
  const int per = INT4 ? 2 * len : len;
  for (int i = threadIdx.x; i < rows * len; i += NT) {
    const int bl = i / len, r = i % len, b = r0 + bl;
    const int pr = p0 + r;
    float lo = 0.f, hi = 0.f;
    if (b < p.B) {
      if (INT4) {
        const int t = pr / j.pair, rr = pr % j.pair;
        const int k = t * 2 * j.pair + rr;
        lo = in_value(p, in, b, k);
        hi = in_value(p, in, b, k + j.pair);
      } else {
        lo = in_value(p, in, b, pr);
      }
    }
    xs[bl * per + r] = lo;
    if (INT4) xs[bl * per + len + r] = hi;
  }
}

// one matrix of an item: part[slice, b, col] for the staged rows r0 ..
template <int RT, bool INT4>
__device__ void gemv_matrix(const Params& p, const Job& j, int strip, int sl, const float* xs,
                            int r0, int rows, float* red, float* part) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int col = strip * STRIP + lane * VEC;
  const int p0 = sl * j.slice;
  const int len = min(j.slice, j.kp - p0);
  const int per = INT4 ? 2 * len : len;
  const int tile = INT4 ? p0 / j.pair : 0;
  for (int rb = 0; rb < rows; rb += RT) {
    float acc[RT][VEC], acc2[RT][VEC];
#pragma unroll
    for (int r = 0; r < RT; ++r)
#pragma unroll
      for (int c = 0; c < VEC; ++c) acc[r][c] = acc2[r][c] = 0.f;
    if (col < j.n) {
      const int8_t* wp = j.w + (size_t)p0 * j.n + col;
      for (int k = warp; k < len; k += NWARPS * DEPTH) {
        uint32_t raw[DEPTH];
#pragma unroll
        for (int u = 0; u < DEPTH; ++u)
          if (k + u * NWARPS < len)
            raw[u] = __ldg(reinterpret_cast<const uint32_t*>(wp + (size_t)(k + u * NWARPS) * j.n));
#pragma unroll
        for (int u = 0; u < DEPTH; ++u) {
          const int kk = k + u * NWARPS;
          if (kk >= len) break;
#pragma unroll
          for (int c = 0; c < VEC; ++c) {
            const int v = (int)(int8_t)(raw[u] >> (8 * c));
            if (INT4) {
              const float lo = (float)((v << 28) >> 28), hi = (float)(v >> 4);
#pragma unroll
              for (int r = 0; r < RT; ++r) {
                acc[r][c] = fmaf(xs[(rb + r) * per + kk], lo, acc[r][c]);
                acc2[r][c] = fmaf(xs[(rb + r) * per + len + kk], hi, acc2[r][c]);
              }
            } else {
              const float wf = (float)v;
#pragma unroll
              for (int r = 0; r < RT; ++r) acc[r][c] = fmaf(xs[(rb + r) * per + kk], wf, acc[r][c]);
            }
          }
        }
      }
    }
    // the warps hold sums over interleaved rows: add them in warp order
    if (warp > 0) {
#pragma unroll
      for (int r = 0; r < RT; ++r)
#pragma unroll
        for (int c = 0; c < VEC; ++c) {
          float* q = red + ((((warp - 1) * RT + r) * VEC + c) * 2) * 32;
          q[lane] = acc[r][c];
          if (INT4) q[32 + lane] = acc2[r][c];
        }
    }
    __syncthreads();
    if (warp == 0 && col < j.n) {
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        const int b = r0 + rb + r;
        if (b >= p.B) break;
#pragma unroll
        for (int c = 0; c < VEC; ++c) {
          float v = acc[r][c], v2 = acc2[r][c];
          for (int wi = 0; wi < NWARPS - 1; ++wi) {
            const float* q = red + (((wi * RT + r) * VEC + c) * 2) * 32;
            v += q[lane];
            if (INT4) v2 += q[32 + lane];
          }
          if (INT4)  // per (tile, half, column) scales apply to the slice's sums
            v = v * j.s[(size_t)(tile * 2) * j.n + col + c] +
                v2 * j.s[(size_t)(tile * 2 + 1) * j.n + col + c];
          part[((size_t)sl * p.B + b) * p.nmax + col + c] = v;
        }
      }
    }
    __syncthreads();
  }
}

// the last item of a strip to arrive, by an atomic ticket
__device__ bool last_of(unsigned* counter, unsigned total, int* flag) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned prev = atomicAdd(counter, 1u);
    *flag = prev == total - 1;
    if (*flag) *counter = 0;  // next use is after a grid barrier
  }
  __syncthreads();
  if (*flag) __threadfence();
  return *flag;
}

__device__ __forceinline__ float sum_slices(const float* part, int nsl, size_t stride, size_t off) {
  float v = 0.f;
#pragma unroll 4
  for (int s = 0; s < nsl; ++s) v += __ldcg(part + s * stride + off);
  return v;
}

enum Epi { EPI_STORE, EPI_RESID, EPI_SWIGLU };

// a whole GEMV phase: one or two matrices (gate and up share their items)
template <int RT>
__device__ void gemv_phase(const Params& p, const Job& j0, const Job* j1, const Input& in,
                           Epi epi, float* out, int out_ld, bool scale_out, float* smem) {
  const int n_items = j0.nstrips * j0.nsl;
  if (in.src == nullptr && blockIdx.x < n_items) row_rstd(p, in.rstd, smem);
  int* flag = reinterpret_cast<int*>(smem);
  float* red = smem + 4;
  float* xs = red + (NWARPS - 1) * RT * VEC * 2 * 32;
  const size_t pstride = (size_t)p.B * p.nmax;
  float* part0 = p.part;
  float* part1 = p.part + (size_t)p.ms * pstride;
  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
    const int strip = item % j0.nstrips, sl = item / j0.nstrips;
    const int p0 = sl * j0.slice, len = min(j0.slice, j0.kp - p0);
    for (int r0 = 0; r0 < p.B; r0 += RG) {
      const int rows = cdiv(min(RG, p.B - r0), RT) * RT;
      __syncthreads();
      if (j0.pair) {
        stage_x<true>(p, j0, in, p0, len, r0, rows, xs);
        __syncthreads();
        gemv_matrix<RT, true>(p, j0, strip, sl, xs, r0, rows, red, part0);
        if (j1) gemv_matrix<RT, true>(p, *j1, strip, sl, xs, r0, rows, red, part1);
      } else {
        stage_x<false>(p, j0, in, p0, len, r0, rows, xs);
        __syncthreads();
        gemv_matrix<RT, false>(p, j0, strip, sl, xs, r0, rows, red, part0);
        if (j1) gemv_matrix<RT, false>(p, *j1, strip, sl, xs, r0, rows, red, part1);
      }
    }
    if (!last_of(p.cnt + strip, j0.nsl, flag)) continue;
    for (int i = threadIdx.x; i < p.B * STRIP; i += NT) {
      const int b = i / STRIP, col = strip * STRIP + i % STRIP;
      if (col >= j0.n) continue;
      const size_t off = (size_t)b * p.nmax + col;
      float v = sum_slices(part0, j0.nsl, pstride, off);
      if (scale_out) v *= j0.s[col];
      float* o = out + (size_t)b * out_ld + col;
      if (epi == EPI_STORE) {
        *o = v;
      } else if (epi == EPI_RESID) {
        *o = __ldcg(o) + v;
      } else {
        float u = sum_slices(part1, j0.nsl, pstride, off);
        if (scale_out) u *= j1->s[col];
        *o = bf16r(v / (1.f + expf(-v)) * u);
      }
    }
  }
}

// --------------------------------------------------------------------------
// attention items
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

// one attention phase: self (q from qkv, G = Nq/Nkv heads per item, the
// current token in chunk 0) or cross (q from cq, one head per item)
template <int KIND>
__device__ void attention_phase(const Params& p, int l, bool self, float* smem) {
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

  int* flag = reinterpret_cast<int*>(smem);
  float* qs = smem + 4;            // [G][H]
  float* kn = qs + G * H;          // [H]
  float* vn = kn + H;              // [H]
  float* sc = vn + H;              // [G][CH]
  float* scur = sc + G * CH;       // [G]
  const int n_items = p.B * NKV * nch;
  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
    const int c = item % nch, n = (item / nch) % NKV, b = item / (nch * NKV);
    const int pos = p.pos[b];
    int lo, hi;
    if (self) {
      lo = max(c * CH, p.vf[b]);
      hi = min(c * CH + CH, p.ws);
    } else {
      lo = c * CH;
      hi = min(min(c * CH + CH, p.cross_ends[b]), p.S);
    }
    const int ns = max(0, hi - lo);
    const bool cur = self && c == 0;
    __syncthreads();
    for (int e = tid; e < G * H; e += NT) {
      const int g = e / H, d = e % H;
      const float* src = self ? p.qkv + (size_t)b * nqkv + (n * G + g) * H
                              : p.cq + ((size_t)b * p.Ncq + n) * H;
      qs[e] = rope_at(p, src, d, pos);
    }
    if (cur) {
      const float* kr = p.qkv + (size_t)b * nqkv + (p.Nq + n) * H;
      const float* vr = p.qkv + (size_t)b * nqkv + (p.Nq + p.Nkv + n) * H;
      for (int d = tid; d < H; d += NT) {
        const float kd = rope_at(p, kr, d, pos), vd = __ldcg(vr + d);
        kn[d] = kd;
        vn[d] = vd;
        const size_t o = (((size_t)l * p.B + b) * p.Nkv + n) * H + d;
        p.kv_out[o] = kd;
        p.kv_out[(size_t)p.L * p.B * p.Nkv * H + o] = vd;
      }
    }
    __syncthreads();
    // scores: a warp per slot, lanes over the head dim, butterfly sums
    const size_t row0 = ((size_t)l * p.B + b) * T;
    for (int si = warp; si < ns + (cur ? 1 : 0); si += NWARPS) {
      const bool is_cur = si == ns;
      const size_t kbase = ((row0 + lo + si) * NKV + n) * H;
      for (int g = 0; g < G; ++g) {
        float a = 0.f;
        for (int d = lane; d < H; d += 32)
          a = fmaf(qs[g * H + d], is_cur ? kn[d] : cache_at<KIND>(kc, kbase + d), a);
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) a += __shfl_xor_sync(0xffffffffu, a, o);
        if (lane == 0) {
          a *= scale;
          if (is_cur) {
            scur[g] = a;
          } else {
            if (KIND == CACHE_I8) a *= __ldg(ksc + (row0 + lo + si) * NKV + n);
            sc[g * CH + si] = a;
          }
        }
      }
    }
    __syncthreads();
    // chunk softmax partials, one thread per head, slots in order
    const size_t pbase = ((size_t)b * NH + n * G) * nch + c;  // + g * nch
    if (tid < G) {
      const int g = tid;
      float m = NEG;
      for (int si = 0; si < ns; ++si) m = fmaxf(m, sc[g * CH + si]);
      if (cur) m = fmaxf(m, scur[g]);
      float lsum = 0.f;
      for (int si = 0; si < ns; ++si) {
        const float e = expf(sc[g * CH + si] - m);
        lsum += e;
        sc[g * CH + si] = KIND == CACHE_I8 ? e * __ldg(vsc + (row0 + lo + si) * NKV + n) : e;
      }
      if (cur) {
        const float e = expf(scur[g] - m);
        lsum += e;
        scur[g] = e;
      }
      p.am[pbase + (size_t)g * nch] = m;
      p.al[pbase + (size_t)g * nch] = lsum;
    }
    __syncthreads();
    for (int e = tid; e < G * H; e += NT) {
      const int g = e / H, d = e % H;
      float a = 0.f;
      for (int si = 0; si < ns; ++si)
        a = fmaf(sc[g * CH + si], cache_at<KIND>(vc, ((row0 + lo + si) * NKV + n) * H + d), a);
      if (cur) a = fmaf(scur[g], vn[d], a);
      p.apart[(pbase + (size_t)g * nch) * H + d] = a;
    }
    if (!last_of(p.cnt + b * NKV + n, nch, flag)) continue;
    // combine the chunks of this (row, head group) in chunk order
    for (int e = tid; e < G * H; e += NT) {
      const int g = e / H, d = e % H;
      const size_t base = ((size_t)b * NH + n * G + g) * nch;
      float mx = NEG;
      for (int k = 0; k < nch; ++k) mx = fmaxf(mx, __ldcg(p.am + base + k));
      if (!self && mx <= NEG * 0.5f) mx = 0.f;  // a row with no keys: exact zeros
      float num = 0.f, den = 0.f;
      for (int k = 0; k < nch; ++k) {
        const float f = expf(__ldcg(p.am + base + k) - mx);
        num = fmaf(__ldcg(p.apart + (base + k) * H + d), f, num);
        den = fmaf(__ldcg(p.al + base + k), f, den);
      }
      if (!self) den = fmaxf(den, 1e-30f);
      p.att[((size_t)b * NH + n * G + g) * H + d] = bf16r(num / den);
    }
  }
}

__device__ void attention(const Params& p, int l, bool self, float* smem) {
  if (p.cache == CACHE_F32) attention_phase<CACHE_F32>(p, l, self, smem);
  else if (p.cache == CACHE_BF16) attention_phase<CACHE_BF16>(p, l, self, smem);
  else attention_phase<CACHE_I8>(p, l, self, smem);
}

// --------------------------------------------------------------------------
// the kernel
// --------------------------------------------------------------------------
template <int RT>
__global__ void __launch_bounds__(NT) fused_step_kernel(Params p) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float smem[];
  float* rstd = smem;                       // [B]
  float* work = smem + rstd_floats(p.B);    // phases' own scratch
  const int gt = blockIdx.x * NT + threadIdx.x, gs = gridDim.x * NT;
  for (int i = gt; i < p.B * p.D; i += gs) p.x[i] = p.x_emb[i];
  for (int i = gt; i < p.ncnt; i += gs) p.cnt[i] = 0u;
  grid.sync();

  const int D = p.D, F = p.F, NqH = p.Nq * p.H, NcqH = p.Ncq * p.H;
  const int nqkv = (p.Nq + 2 * p.Nkv) * p.H;
  const int gk = p.int4 ? D / 2 : D, gpair = p.int4 ? D / 2 : 0;
  const int mk = p.int4 ? F / 2 : F, mpair = p.int4 ? F / (2 * p.mt) : 0;
  const int gs_l = p.int4 ? 2 * F : F, ms_l = p.int4 ? p.mt * 2 * D : D;
  const Input from_x{nullptr, D, rstd};
  for (int l = 0; l < p.L; ++l) {
    // A: qkv
    gemv_phase<RT>(p, make_job(p, 0, l, D, nqkv, 0, nqkv), nullptr, from_x, EPI_STORE, p.qkv,
                   nqkv, true, work);
    grid.sync();
    // B: self-attention
    attention(p, l, true, work);
    grid.sync();
    // C: o_proj + residual
    gemv_phase<RT>(p, make_job(p, 1, l, NqH, D, 0, D), nullptr, Input{p.att, NqH, rstd},
                   EPI_RESID, p.x, D, true, work);
    grid.sync();
    // D: cq
    gemv_phase<RT>(p, make_job(p, 2, l, D, NcqH, 0, NcqH), nullptr, from_x, EPI_STORE, p.cq,
                   NcqH, true, work);
    grid.sync();
    // E: cross-attention
    attention(p, l, false, work);
    grid.sync();
    // F: co_proj + residual
    gemv_phase<RT>(p, make_job(p, 3, l, NcqH, D, 0, D), nullptr, Input{p.att, NcqH, rstd},
                   EPI_RESID, p.x, D, true, work);
    grid.sync();
    // G: gate, up -> h
    const Job ju = make_job(p, 5, l, gk, F, gpair, gs_l);
    gemv_phase<RT>(p, make_job(p, 4, l, gk, F, gpair, gs_l), &ju, from_x, EPI_SWIGLU, p.h, F,
                   !p.int4, work);
    grid.sync();
    // H: wm + residual
    gemv_phase<RT>(p, make_job(p, 6, l, mk, D, mpair, ms_l), nullptr, Input{p.h, F, rstd},
                   EPI_RESID, p.x, D, !p.int4, work);
    grid.sync();
  }
}

// --------------------------------------------------------------------------
// host side: workspace layout, shared memory, launch
// --------------------------------------------------------------------------
struct Layout {
  size_t qkv, cq, att, h, part, apart, am, al, cnt, total;
  int ms, nmax, nch_max, ncnt, nhmax;
};

size_t align_up(size_t v) { return (v + 255) / 256 * 256; }

Layout layout(int B, int D, int F, int Nq, int Nkv, int Ncq, int H, int T, int S, int int4,
              int mt) {
  Layout o;
  const int nqkv = (Nq + 2 * Nkv) * H;
  const int kps[6] = {D, Nq * H, D, Ncq * H, int4 ? D / 2 : D, int4 ? F / 2 : F};
  const int pairs[6] = {0, 0, 0, 0, int4 ? D / 2 : 0, int4 ? F / (2 * mt) : 0};
  o.ms = 1;
  for (int i = 0; i < 6; ++i) {
    const int n = cdiv(kps[i], plan_slice(kps[i], pairs[i]));
    o.ms = n > o.ms ? n : o.ms;
  }
  o.nmax = nqkv;
  const int ns[3] = {D, Ncq * H, F};
  for (int i = 0; i < 3; ++i) o.nmax = ns[i] > o.nmax ? ns[i] : o.nmax;
  o.nhmax = Nq > Ncq ? Nq : Ncq;
  const int ct = cdiv(T, CH), cs = cdiv(S, CH);
  o.nch_max = ct > cs ? ct : cs;
  if (o.nch_max < 1) o.nch_max = 1;
  const int kvmax = Nkv > Ncq ? Nkv : Ncq;
  o.ncnt = cdiv(o.nmax, STRIP);
  if (B * kvmax > o.ncnt) o.ncnt = B * kvmax;
  size_t at = 0;
  auto take = [&](size_t bytes) { const size_t here = at; at += align_up(bytes); return here; };
  o.qkv = take(sizeof(float) * B * nqkv);
  o.cq = take(sizeof(float) * B * Ncq * H);
  o.att = take(sizeof(float) * B * o.nhmax * H);
  o.h = take(sizeof(float) * B * F);
  o.part = take(sizeof(float) * 2 * (size_t)o.ms * B * o.nmax);
  o.apart = take(sizeof(float) * (size_t)B * o.nhmax * o.nch_max * H);
  o.am = take(sizeof(float) * (size_t)B * o.nhmax * o.nch_max);
  o.al = take(sizeof(float) * (size_t)B * o.nhmax * o.nch_max);
  o.cnt = take(sizeof(unsigned) * o.ncnt);
  o.total = at;
  return o;
}

size_t smem_bytes(int RT, int B, int D, int F, int Nq, int Nkv, int Ncq, int H, int int4, int mt) {
  const int rows = cdiv(B < RG ? B : RG, RT) * RT;
  const int kps[6] = {D, Nq * H, D, Ncq * H, int4 ? D / 2 : D, int4 ? F / 2 : F};
  const int pairs[6] = {0, 0, 0, 0, int4 ? D / 2 : 0, int4 ? F / (2 * mt) : 0};
  int xs = 0;
  for (int i = 0; i < 6; ++i) {
    const int per = plan_slice(kps[i], pairs[i]) * (i >= 4 && int4 ? 2 : 1);
    xs = per > xs ? per : xs;
  }
  const size_t gemv = 4 + (size_t)(NWARPS - 1) * RT * VEC * 2 * 32 + (size_t)rows * xs;
  const int G = Nq / Nkv > 1 ? Nq / Nkv : 1;
  const size_t attn = 4 + (size_t)G * H + 2 * H + (size_t)G * CH + G;
  size_t work = gemv > attn ? gemv : attn;
  if (work < NT) work = NT;  // row_rstd's sums
  return sizeof(float) * (rstd_floats(B) + work);
}

template <int RT>
cudaError_t launch(Params& p, size_t smem, cudaStream_t stream) {
  auto kernel = fused_step_kernel<RT>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  if ((err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev)) != cudaSuccess)
    return err;
  if (!coop) return cudaErrorNotSupported;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, NT, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  if (per_sm > 4) per_sm = 4;
  void* args[] = {&p};
  err = cudaLaunchCooperativeKernel((const void*)kernel, dim3(per_sm * sms), dim3(NT), args, smem,
                                    stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// Bytes of device scratch fused_step_fwd needs for these shapes.
extern "C" int fused_step_workspace_bytes(int B, int D, int F, int Nq, int Nkv, int Ncq, int H,
                                          int T, int S, int int4, int mt, long long* out) {
  if (B <= 0 || mt <= 0) return cudaErrorInvalidValue;
  *out = (long long)layout(B, D, F, Nq, Nkv, Ncq, H, T, S, int4, mt).total;
  return cudaSuccess;
}

// Weights/scales in the FusedPack order (wqkv, sqkv, wo, so, wcq, scq, wco,
// sco, wg, sg, wu, su, wm, sm), x_emb fp32 [B, D], int32 pos / valid_from /
// cross_ends [B], inv_freq fp32 [H/2], the four caches ([L, B, T|S, N, H],
// dtype `cache`: 0 fp32, 1 bf16, 2 int8) and, for int8, their four fp32
// scale tensors (else null); out x fp32 [B, D], kv fp32 [2, L, B, Nkv, H];
// work: fused_step_workspace_bytes of scratch.  All contiguous.  One
// cooperative launch on `stream`; returns its cudaError_t.
extern "C" int fused_step_fwd(
    const void* wqkv, const void* sqkv, const void* wo, const void* so, const void* wcq,
    const void* scq, const void* wco, const void* sco, const void* wg, const void* sg,
    const void* wu, const void* su, const void* wm, const void* sm, const void* x_emb,
    const void* pos, const void* vf, const void* cross_ends, const void* inv_freq,
    const void* sk, const void* sv, const void* ck, const void* cv, const void* sks,
    const void* svs, const void* cks, const void* cvs, void* x, void* kv, void* work,
    int L, int B, int D, int F, int Nq, int Nkv, int Ncq, int H, int T, int S, int ws,
    int cache, int int4, int mt, long long work_bytes, float eps, void* stream) {
  if (L <= 0 || B <= 0 || D <= 0 || F <= 0 || Nq <= 0 || Nkv <= 0 ||
      Nq % Nkv || Ncq <= 0 || H <= 0 || H % 2 || T <= 0 || S <= 0 || ws < 0 || ws >= T ||
      cache < 0 || cache > 2 || mt <= 0 || (Nq / Nkv) * H > MAX_GH || H > MAX_GH)
    return cudaErrorInvalidValue;
  const int nqkv = (Nq + 2 * Nkv) * H;
  if (nqkv % VEC || D % VEC || (Ncq * H) % VEC || F % VEC) return cudaErrorInvalidValue;
  if (int4 && (D % 2 || F % (2 * mt))) return cudaErrorInvalidValue;
  if (cache == CACHE_I8 && (!sks || !svs || !cks || !cvs)) return cudaErrorInvalidValue;
  const Layout lo = layout(B, D, F, Nq, Nkv, Ncq, H, T, S, int4, mt);
  if (work_bytes < (long long)lo.total) return cudaErrorInvalidValue;
  Params p;
  const void* ws7[7] = {wqkv, wo, wcq, wco, wg, wu, wm};
  const void* ss7[7] = {sqkv, so, scq, sco, sg, su, sm};
  for (int i = 0; i < 7; ++i) {
    p.w[i] = static_cast<const int8_t*>(ws7[i]);
    p.s[i] = static_cast<const float*>(ss7[i]);
    if (reinterpret_cast<uintptr_t>(ws7[i]) % VEC) return cudaErrorInvalidValue;
  }
  p.x_emb = static_cast<const float*>(x_emb);
  p.pos = static_cast<const int*>(pos);
  p.vf = static_cast<const int*>(vf);
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
  p.part = reinterpret_cast<float*>(wb + lo.part);
  p.apart = reinterpret_cast<float*>(wb + lo.apart);
  p.am = reinterpret_cast<float*>(wb + lo.am);
  p.al = reinterpret_cast<float*>(wb + lo.al);
  p.cnt = reinterpret_cast<unsigned*>(wb + lo.cnt);
  p.L = L; p.B = B; p.D = D; p.F = F; p.Nq = Nq; p.Nkv = Nkv; p.Ncq = Ncq; p.H = H;
  p.T = T; p.S = S; p.ws = ws; p.cache = cache; p.int4 = int4; p.mt = mt;
  p.ms = lo.ms; p.nmax = lo.nmax; p.nch_max = lo.nch_max; p.ncnt = lo.ncnt;
  p.eps = eps;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 2) return launch<2>(p, smem_bytes(2, B, D, F, Nq, Nkv, Ncq, H, int4, mt), s);
  return launch<4>(p, smem_bytes(4, B, D, F, Nq, Nkv, Ncq, H, int4, mt), s);
}

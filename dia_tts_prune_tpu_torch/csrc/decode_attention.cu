// Single-token GQA decode attention over a KV cache, for Hopper (sm_90a).
//
// Replaces: dia_tts_prune_tpu/ops/kernels/decode_attention.py — the Pallas
// kernel `_kernel` (:33, pallas_call :133).  Same math: one query token per
// row against cache slots, fp32 online softmax, GQA query heads
// [n*G, (n+1)*G) read kv head n without repeating it.  Generalised from the
// TPU kernel's scalar valid_len to a per-row slot range [start_b, end_b): the
// self-attention passes [0, write_slot + 1), the cross-attention [0, text
// length of the row), and a row with an empty range (the CFG unconditional
// row, whose text is all padding) writes exact zeros.
//
// What bounds it on the H100: bytes.  Per step and layer it reads the valid
// K/V slots once (2 * valid * Nkv * H elements) and does ~4 FLOP per element
// read per query head in the group — about 1-2 FLOP/byte, two orders of
// magnitude below the ridge point.  The design therefore reads only
// [start_b, end_b) — slots past end are never loaded, so traffic follows the
// generated length and not the cache capacity — and spreads that read over
// many blocks: the range is cut into chunks of 128 slots (split-K, "flash
// decoding"), one block per (chunk, kv head, batch row).  Blocks cannot carry
// a running softmax to one another as the TPU's sequential grid does, so each
// writes its partial (max, sum, fp32 accumulator) and a second small kernel
// combines the chunks of every (row, query head).
//
// int8 caches (the JAX package's QuantKVCache, models/dia.py:57): K/V are int8
// [B,T,Nkv,H] with one fp32 scale per (slot, kv head), ks and vs [B,T,Nkv].
// The codes are widened in registers and the scales stay outside the dots, as
// `_sdpa_quant` (:85) has them: slot t scores (q . k8[t]) * ks[t] / sqrt(H) and
// contributes p[t] * vs[t] * v8[t].  That halves (bf16) or quarters (fp32) the
// bytes this kernel is bound by.  For self-attention the current token is not
// in the cache yet: `decode_step_scan` (:661-685) attends the quantized prefix
// and adds the token's unquantized k_new, v_new analytically, committing them
// quantized afterwards.  Here the combine pass takes k_new, v_new [B,Nkv,H] as
// one more partial with max = its score, sum = 1, accumulator = v_new.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr float NEG = -1e30f;
constexpr int NWARPS = 4;   // warp g < G owns query head n*G + g; all warps load tiles
constexpr int CHUNK = 128;  // cache slots per block (one split)
constexpr int BK = 32;      // slots per shared-memory tile: one per lane

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(int8_t x) { return (float)x; }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

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

// grid (n_split, Nkv, B); partials [B, Nq, n_split] (+ H for acc).  C is the
// cache's element type: T, or int8_t with the slot scales ks, vs [B, Tc, Nkv]
template <typename T, typename C, int H>
__global__ void __launch_bounds__(NWARPS * 32)
decode_partial_kernel(const T* __restrict__ q, const C* __restrict__ kc,
                      const C* __restrict__ vc, const float* __restrict__ ks,
                      const float* __restrict__ vs, const int* __restrict__ start,
                      const int* __restrict__ end, float* __restrict__ part_acc,
                      float* __restrict__ part_m, float* __restrict__ part_l, int Tc, int Nq,
                      int Nkv, float scale) {
  constexpr int DPL = H / 32;
  constexpr bool QUANT = sizeof(C) == 1;
  __shared__ float q_s[NWARPS][H];
  __shared__ float k_s[BK][H + 1];  // +1: lane j reading slot j is conflict free
  __shared__ float v_s[BK][H];
  __shared__ float ks_s[BK], vs_s[BK];

  const int split = blockIdx.x, n_split = gridDim.x;
  const int nk = blockIdx.y;
  const int b = blockIdx.z;
  const int G = Nq / Nkv;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  const int lo = max(start[b], 0);
  const int hi = min(end[b], Tc);
  const int c0 = lo + split * CHUNK;
  const int c1 = min(hi, c0 + CHUNK);

  for (int i = tid; i < G * H; i += NWARPS * 32) {
    const int g = i / H, d = i % H;
    q_s[g][d] = to_f(q[((size_t)b * Nq + nk * G + g) * H + d]);
  }

  float m = NEG, l = 0.f, acc[DPL];
#pragma unroll
  for (int j = 0; j < DPL; ++j) acc[j] = 0.f;

  for (int t0 = c0; t0 < c1; t0 += BK) {  // empty when this chunk lies past end
    __syncthreads();
    for (int i = tid; i < BK * H; i += NWARPS * 32) {
      const int j = i / H, d = i % H, slot = t0 + j;
      float kv = 0.f, vv = 0.f;
      if (slot < c1) {
        const size_t off = (((size_t)b * Tc + slot) * Nkv + nk) * H + d;
        kv = to_f(kc[off]);
        vv = to_f(vc[off]);
      }
      k_s[j][d] = kv;
      v_s[j][d] = vv;
    }
    if (QUANT && tid < BK) {
      const int slot = t0 + tid;
      const size_t off = ((size_t)b * Tc + slot) * Nkv + nk;
      ks_s[tid] = slot < c1 ? ks[off] : 0.f;
      vs_s[tid] = slot < c1 ? vs[off] : 0.f;
    }
    __syncthreads();
    if (warp < G) {
      const bool ok = t0 + lane < c1;
      float s = 0.f;
#pragma unroll 8
      for (int d = 0; d < H; ++d) s = fmaf(q_s[warp][d], k_s[lane][d], s);
      if (QUANT) s *= ks_s[lane];
      s = ok ? s * scale : NEG;
      const float m_new = fmaxf(m, warp_max(s));  // >= one real score: t0 < c1
      const float alpha = expf(m - m_new);         // m == NEG on the first tile -> 0
      const float p = ok ? expf(s - m_new) : 0.f;
      l = l * alpha + warp_sum(p);
      m = m_new;
      const float pv = QUANT ? p * vs_s[lane] : p;
#pragma unroll
      for (int dd = 0; dd < DPL; ++dd) acc[dd] *= alpha;
#pragma unroll 4
      for (int j = 0; j < BK; ++j) {
        const float pj = __shfl_sync(0xffffffffu, pv, j);
#pragma unroll
        for (int dd = 0; dd < DPL; ++dd) acc[dd] = fmaf(pj, v_s[j][lane + 32 * dd], acc[dd]);
      }
    }
  }

  if (warp < G) {
    const size_t idx = ((size_t)b * Nq + nk * G + warp) * n_split + split;
#pragma unroll
    for (int dd = 0; dd < DPL; ++dd) part_acc[idx * H + lane + 32 * dd] = acc[dd];
    if (lane == 0) {
      part_m[idx] = m;  // an empty chunk leaves m = NEG, l = 0
      part_l[idx] = l;
    }
  }
}

// grid (Nq, B), H threads: merge the chunks of one (row, query head) and, when
// k_new is given, the current token [B, Nkv, H] that is not in the cache
template <typename T>
__global__ void decode_combine_kernel(const float* __restrict__ part_acc,
                                      const float* __restrict__ part_m,
                                      const float* __restrict__ part_l,
                                      const T* __restrict__ q, const T* __restrict__ k_new,
                                      const T* __restrict__ v_new, T* __restrict__ out, int Nq,
                                      int Nkv, int H, int n_split, float scale) {
  __shared__ float dot_s[4];  // one per warp: H <= 128
  const int n = blockIdx.x, b = blockIdx.y, d = threadIdx.x;
  const size_t base = ((size_t)b * Nq + n) * n_split;
  float M = NEG;
  for (int s = 0; s < n_split; ++s)
    if (part_l[base + s] > 0.f) M = fmaxf(M, part_m[base + s]);
  float num = 0.f, den = 0.f, s_cur = 0.f;
  const size_t cur = ((size_t)b * Nkv + n / (Nq / Nkv)) * H + d;
  if (k_new != nullptr) {
    const float prod = warp_sum(to_f(q[((size_t)b * Nq + n) * H + d]) * to_f(k_new[cur]));
    if ((d & 31) == 0) dot_s[d >> 5] = prod;
    __syncthreads();
    for (int i = 0; i < H / 32; ++i) s_cur += dot_s[i];
    s_cur *= scale;
    M = fmaxf(M, s_cur);
    const float w = expf(s_cur - M);
    num = w * to_f(v_new[cur]);
    den = w;
  }
  for (int s = 0; s < n_split; ++s) {
    const float ls = part_l[base + s];
    if (ls > 0.f) {
      const float w = expf(part_m[base + s] - M);
      num = fmaf(w, part_acc[(base + s) * H + d], num);
      den = fmaf(w, ls, den);
    }
  }
  // empty range: num == 0 -> exact zero
  out[((size_t)b * Nq + n) * H + d] = from_f<T>(num / fmaxf(den, 1e-30f));
}

struct Args {
  const void *q, *kc, *vc, *ks, *vs, *k_new, *v_new, *start, *end;
  void* out;
  float* part;
  int B, Tc, Nq, Nkv, n_split;
  cudaStream_t stream;
};

template <typename T, typename C, int H>
cudaError_t launch(const Args& a) {
  float* part_acc = a.part;
  float* part_m = part_acc + (size_t)a.B * a.Nq * a.n_split * H;
  float* part_l = part_m + (size_t)a.B * a.Nq * a.n_split;
  const float scale = 1.0f / sqrtf((float)H);
  decode_partial_kernel<T, C, H><<<dim3(a.n_split, a.Nkv, a.B), NWARPS * 32, 0, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const C*>(a.kc), static_cast<const C*>(a.vc),
      static_cast<const float*>(a.ks), static_cast<const float*>(a.vs),
      static_cast<const int*>(a.start), static_cast<const int*>(a.end), part_acc, part_m, part_l,
      a.Tc, a.Nq, a.Nkv, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_combine_kernel<T><<<dim3(a.Nq, a.B), H, 0, a.stream>>>(
      part_acc, part_m, part_l, static_cast<const T*>(a.q), static_cast<const T*>(a.k_new),
      static_cast<const T*>(a.v_new), static_cast<T*>(a.out), a.Nq, a.Nkv, H, a.n_split, scale);
  return cudaGetLastError();
}

template <typename T, typename C>
cudaError_t dispatch_h(int H, const Args& a) {
  switch (H) {
    case 32: return launch<T, C, 32>(a);
    case 64: return launch<T, C, 64>(a);
    case 128: return launch<T, C, 128>(a);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch_cache(bool kv_int8, int H, const Args& a) {
  return kv_int8 ? dispatch_h<T, int8_t>(H, a) : dispatch_h<T, T>(H, a);
}

}  // namespace

extern "C" int decode_attention_chunk() { return CHUNK; }

// q [B,Nq,H] (dtype 0 = float32, 1 = bfloat16), start/end int32 [B], out
// [B,Nq,H] in q's dtype, part fp32 scratch of B*Nq*n_split*(H+2) floats with
// n_split = ceil(Tc / CHUNK).  Caches [B,Tc,Nkv,H]: in q's dtype (kv_int8 = 0;
// ks, vs null), or int8 with fp32 slot scales ks, vs [B,Tc,Nkv] (kv_int8 = 1).
// k_new, v_new [B,Nkv,H] in q's dtype: one more token that every row attends
// besides its slot range, or both null.  All contiguous.  Requires
// Nq / Nkv <= 4.  Returns the launches' cudaError_t.
extern "C" int decode_attention_fwd(const void* q, const void* kc, const void* vc,
                                    const void* ks, const void* vs, const void* k_new,
                                    const void* v_new, const void* start, const void* end,
                                    void* out, void* part, int B, int Tc, int Nq, int Nkv, int H,
                                    int dtype, int kv_int8, void* stream) {
  if (B <= 0 || Tc <= 0 || Nkv <= 0 || Nq % Nkv != 0 || Nq / Nkv > NWARPS ||
      (kv_int8 != 0) != (ks != nullptr) || (ks == nullptr) != (vs == nullptr) ||
      (k_new == nullptr) != (v_new == nullptr))
    return cudaErrorInvalidValue;
  const Args a{q, kc, vc, ks, vs, k_new, v_new, start, end, out, static_cast<float*>(part),
               B, Tc, Nq, Nkv, (Tc + CHUNK - 1) / CHUNK, static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return dispatch_cache<float>(kv_int8 != 0, H, a);
  if (dtype == 1) return dispatch_cache<__nv_bfloat16>(kv_int8 != 0, H, a);
  return cudaErrorInvalidValue;
}

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

// grid (n_split, Nkv, B); partials [B, Nq, n_split] (+ H for acc)
template <typename T, int H>
__global__ void __launch_bounds__(NWARPS * 32)
decode_partial_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                      const T* __restrict__ vc, const int* __restrict__ start,
                      const int* __restrict__ end, float* __restrict__ part_acc,
                      float* __restrict__ part_m, float* __restrict__ part_l, int Tc, int Nq,
                      int Nkv, float scale) {
  constexpr int DPL = H / 32;
  __shared__ float q_s[NWARPS][H];
  __shared__ float k_s[BK][H + 1];  // +1: lane j reading slot j is conflict free
  __shared__ float v_s[BK][H];

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
    __syncthreads();
    if (warp < G) {
      const bool ok = t0 + lane < c1;
      float s = 0.f;
#pragma unroll 8
      for (int d = 0; d < H; ++d) s = fmaf(q_s[warp][d], k_s[lane][d], s);
      s = ok ? s * scale : NEG;
      const float m_new = fmaxf(m, warp_max(s));  // >= one real score: t0 < c1
      const float alpha = expf(m - m_new);         // m == NEG on the first tile -> 0
      const float p = ok ? expf(s - m_new) : 0.f;
      l = l * alpha + warp_sum(p);
      m = m_new;
#pragma unroll
      for (int dd = 0; dd < DPL; ++dd) acc[dd] *= alpha;
#pragma unroll 4
      for (int j = 0; j < BK; ++j) {
        const float pj = __shfl_sync(0xffffffffu, p, j);
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

// grid (Nq, B), H threads: merge the chunks of one (row, query head)
template <typename T>
__global__ void decode_combine_kernel(const float* __restrict__ part_acc,
                                      const float* __restrict__ part_m,
                                      const float* __restrict__ part_l, T* __restrict__ out,
                                      int Nq, int H, int n_split) {
  const int n = blockIdx.x, b = blockIdx.y, d = threadIdx.x;
  const size_t base = ((size_t)b * Nq + n) * n_split;
  float M = NEG;
  for (int s = 0; s < n_split; ++s)
    if (part_l[base + s] > 0.f) M = fmaxf(M, part_m[base + s]);
  float num = 0.f, den = 0.f;
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

template <typename T, int H>
cudaError_t launch(const void* q, const void* kc, const void* vc, const void* start,
                   const void* end, void* out, float* part, int B, int Tc, int Nq, int Nkv,
                   int n_split, cudaStream_t stream) {
  float* part_acc = part;
  float* part_m = part_acc + (size_t)B * Nq * n_split * H;
  float* part_l = part_m + (size_t)B * Nq * n_split;
  decode_partial_kernel<T, H><<<dim3(n_split, Nkv, B), NWARPS * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kc), static_cast<const T*>(vc),
      static_cast<const int*>(start), static_cast<const int*>(end), part_acc, part_m, part_l,
      Tc, Nq, Nkv, 1.0f / sqrtf((float)H));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_combine_kernel<T><<<dim3(Nq, B), H, 0, stream>>>(part_acc, part_m, part_l,
                                                          static_cast<T*>(out), Nq, H, n_split);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_h(int H, const void* q, const void* kc, const void* vc, const void* start,
                       const void* end, void* out, float* part, int B, int Tc, int Nq, int Nkv,
                       int n_split, cudaStream_t stream) {
  switch (H) {
    case 32: return launch<T, 32>(q, kc, vc, start, end, out, part, B, Tc, Nq, Nkv, n_split, stream);
    case 64: return launch<T, 64>(q, kc, vc, start, end, out, part, B, Tc, Nq, Nkv, n_split, stream);
    case 128: return launch<T, 128>(q, kc, vc, start, end, out, part, B, Tc, Nq, Nkv, n_split, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int decode_attention_chunk() { return CHUNK; }

// q [B,Nq,H], caches [B,Tc,Nkv,H] (dtype 0 = float32, 1 = bfloat16), start/end
// int32 [B], out [B,Nq,H] in the input dtype, part fp32 scratch of
// B*Nq*n_split*(H+2) floats with n_split = ceil(Tc / CHUNK).  All contiguous.
// Requires Nq / Nkv <= 4.  Returns the launches' cudaError_t.
extern "C" int decode_attention_fwd(const void* q, const void* kc, const void* vc,
                                    const void* start, const void* end, void* out, void* part,
                                    int B, int Tc, int Nq, int Nkv, int H, int dtype,
                                    void* stream) {
  if (B <= 0 || Tc <= 0 || Nkv <= 0 || Nq % Nkv != 0 || Nq / Nkv > NWARPS)
    return cudaErrorInvalidValue;
  const int n_split = (Tc + CHUNK - 1) / CHUNK;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(part);
  if (dtype == 0)
    return dispatch_h<float>(H, q, kc, vc, start, end, out, p, B, Tc, Nq, Nkv, n_split, s);
  if (dtype == 1)
    return dispatch_h<__nv_bfloat16>(H, q, kc, vc, start, end, out, p, B, Tc, Nq, Nkv, n_split, s);
  return cudaErrorInvalidValue;
}

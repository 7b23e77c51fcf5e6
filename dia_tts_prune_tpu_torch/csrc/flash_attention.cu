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
// What bounds it on the H100: operations.  The encoder pass (B=2, T=1024,
// 16 heads, H=128) does ~1 GFLOP per layer against ~17 MB of q/k/v/o, far
// above the card's ~20 FLOP/byte (fp32, no tensor cores) and ~295 FLOP/byte
// (bf16 tensor cores) ridge points.  This first version runs every product as
// fp32 FMAs on the CUDA cores (bf16 inputs are widened on load; fp32 stays
// true fp32, no TF32), so its ceiling is the 67 TFLOP/s fp32 rate; tensor-core
// MMA for bf16 is later work.
//
// Design: one block per (q tile of 32 rows, query head, batch row), 4 warps,
// 8 query rows per warp.  The q tile stays in shared memory; each step loads
// one 32-key tile of K and V into shared memory (K rows padded by one float so
// that lane j reading key j is bank-conflict free).  Lane j scores key j for
// the warp's 8 rows, the warp reduces max/sum with shuffles, and each lane
// accumulates H/32 output dims per row in registers — the [Tq, Tk] scores
// never leave the SM.  Causal blocks stop at the tile holding their last row,
// so tiles above the diagonal are never loaded.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr float NEG = -1e30f;
constexpr int NWARPS = 4;
constexpr int ROWS = 8;               // query rows per warp
constexpr int BQ = NWARPS * ROWS;     // query rows per block
constexpr int BK = 32;                // keys per tile: one per lane

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
  if (dtype == 1)
    return dispatch_h<__nv_bfloat16>(H, q, k, v, q_seg, kv_seg, out, lse, B, Tq, Tk, Nq, Nkv,
                                     causal, s);
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

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
// What bounds them on the H100: operations — five tile products against the
// forward's two, at hundreds of FLOP per byte of q/k/v/dO.  Like the forward
// this first version runs every product as fp32 FMAs on the CUDA cores (bf16
// inputs are widened on load, fp32 stays true fp32), so its ceiling is the
// 67 TFLOP/s fp32 rate; tensor-core tiles are later work.
//
// Design.  The Pallas dK/dV kernel writes one fp32 buffer per *query* head
// and leaves the sum over the GQA group to XLA; its grid carries the
// accumulator across sequential query blocks.  Here one block owns a (key
// tile of 32, kv head, batch row) and loops over the group's query heads and
// over the query tiles inside, with dk/dv for its 32 keys in registers the
// whole time: they come out already reduced over the group, with no atomics,
// in a fixed order of summation (bit-identical from run to run).  The dQ
// kernel mirrors the forward: one block per (query tile of 32, query head,
// batch row) looping over key tiles.  Causal blocks skip the tiles wholly
// above the diagonal.  Time and head dims are bounds-checked, never padded:
// any Tq/Tk, head_dim 32/64/128.
//
// Both kernels: 4 warps.  A warp owns 8 rows of the block's own tile (keys
// for dK/dV, queries for dQ), whose operands it reads from shared memory as
// broadcast float4s; lane j scores tile-mate j of the other side, whose
// operand rows are padded to H + 4 floats so that float4 reads down a column
// of lanes are bank-conflict free.  The second stage (p^T.dO, ds^T.q, ds.k)
// broadcasts each p/ds with a shuffle and accumulates H/32 dims per lane.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int NWARPS = 4;
constexpr int ROWS = 8;             // rows of the block's own tile per warp
constexpr int BT = NWARPS * ROWS;   // tile size on both sides: 32 queries x 32 keys
constexpr int NTHREADS = NWARPS * 32;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

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
cudaError_t dispatch_h(int H, bool kv, const Args& a) {
  switch (H) {
    case 32: return kv ? launch_kv<T, 32>(a) : launch_q<T, 32>(a);
    case 64: return kv ? launch_kv<T, 64>(a) : launch_q<T, 64>(a);
    case 128: return kv ? launch_kv<T, 128>(a) : launch_q<T, 128>(a);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t dispatch(int H, int dtype, bool kv, const Args& a) {
  if (a.B <= 0 || a.Tq <= 0 || a.Tk <= 0 || a.Nkv <= 0 || a.Nq % a.Nkv != 0)
    return cudaErrorInvalidValue;
  if (dtype == 0) return dispatch_h<float>(H, kv, a);
  if (dtype == 1) return dispatch_h<__nv_bfloat16>(H, kv, a);
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

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
// byte used for 4*B operations.  The design is the int8 kernel's: a block owns
// a strip of 32*VEC columns and a slice of byte rows, a warp reads 32*VEC
// consecutive bytes of a row with one load per lane, both activation planes
// of the slice sit in shared memory, nibbles are unpacked in registers with
// two shifts, a lane starts the loads of DEPTH rows before it uses the first
// (one load in flight per warp would cost a memory latency per row), and a
// second kernel sums the slices' partials in a fixed order.
// Within a slice the rows are walked one scale segment at a time (the byte
// rows that share their two scale rows), so the scale is applied once per
// segment to the segment's sums.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

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
  int B, K, R, N, layout, seg, hi_off, n_split;
  cudaStream_t stream;
};

template <typename T, int VEC, int ROWS>
cudaError_t launch(const Args& a) {
  const int slice = (a.R + a.n_split - 1) / a.n_split;
  const dim3 grid((a.N + LANES * VEC - 1) / (LANES * VEC), a.n_split, (a.B + ROWS - 1) / ROWS);
  int4_gemv_kernel<T, VEC, ROWS><<<grid, NWARPS * LANES, 0, a.stream>>>(
      static_cast<const T*>(a.x), static_cast<const int8_t*>(a.w),
      static_cast<const float*>(a.scale), static_cast<T*>(a.out), a.part, a.B, a.K, a.R, a.N,
      a.layout, a.seg, a.hi_off, slice);
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

}  // namespace

// x [B,K] (dtype 0 = float32, 1 = bfloat16), w int8 bytes [R,N] with R = K/2
// (layouts 0 halfsplit, 1 parity) or R = K (layout 2, one value per byte),
// scale fp32 [S,N], out [B,N] in x's dtype, part fp32 scratch of n_split*B*N
// floats (unused when n_split == 1).  All contiguous.  Byte rows
// [g*seg, (g+1)*seg) take scale row g for the low plane and g + hi_off for
// the high plane (per-column scales: S = 1, seg = R, hi_off = 0).  vec in
// {4, 1} must divide N and w's address; ceil(R / n_split) must not exceed
// 512.  Returns the launches' cudaError_t.
extern "C" int int4_gemv_fwd(const void* x, const void* w, const void* scale, void* out,
                             void* part, int B, int K, int R, int N, int S, int layout, int seg,
                             int hi_off, int vec, int n_split, int dtype, void* stream) {
  if (B <= 0 || K <= 0 || R <= 0 || N <= 0 || S <= 0 || seg <= 0 || hi_off < 0 ||
      n_split <= 0 || vec <= 0 || layout < 0 || layout > 2 || N % vec != 0 ||
      reinterpret_cast<uintptr_t>(w) % vec != 0 || (R + n_split - 1) / n_split > RS_MAX ||
      (layout == 2 ? R != K : 2 * R != K) || (R - 1) / seg + hi_off >= S)
    return cudaErrorInvalidValue;
  const Args a{x, w, scale, out, static_cast<float*>(part), B, K, R, N, layout, seg, hi_off,
               n_split, static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return dispatch_vec<float>(vec, a);
  if (dtype == 1) return dispatch_vec<__nv_bfloat16>(vec, a);
  return cudaErrorInvalidValue;
}

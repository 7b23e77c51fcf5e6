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
// magnitude below the ridge point.  At Dia's sizes that is 0.1-2 us of bytes,
// so the launch, the latency of the first loads, each warp's chain of stages
// and the combine of the splits decide the time.  The design:
//
// * One launch per call.  The splits of one (row, kv head) are the CLUSTER
//   blocks of a thread-block cluster (grid (CLUSTER, Nkv, B)).  Block `rank`
//   takes the equal share [lo + n*rank/CLUSTER, lo + n*(rank+1)/CLUSTER) of
//   the row's own range [lo, lo + n), so no block sits past end, and a row's
//   summation order depends only on its range and the constants below —
//   never on B, the capacity Tc or the other rows.  Each block reduces its
//   warps' partials (max m, sum l, fp32 accumulator) in shared memory in warp
//   order; after cluster.sync() rank 0 reads the other blocks' partials
//   through distributed shared memory in rank order, adds the current token
//   (k_new, v_new) and writes the output.  No combine kernel, no scratch.
// * Every warp works, whatever G is.  A block's share is cut into NWARPS
//   equal slot ranges; each warp scores its slots against all G query heads
//   of the kv head, with q in registers.
// * Bytes in flight.  Each lane copies 16-byte units of K and V rows (8 bf16,
//   16 int8 or 4 fp32) with cp.async into a STAGES-deep ring of its warp, and
//   computes on exactly the units it copied itself, so the ring needs no
//   barrier: cp.async.wait_group keeps STAGES - 1 stages in flight while one
//   is computed.  Slots past the warp's range are zero-filled, never read.
// * Dots as lane-partial FMAs over a unit, then a butterfly over the LPS
//   lanes that share a slot (every lane ends with the same bits).  The
//   probabilities weight the lane's own V units; the lanes of different slots
//   are summed by a butterfly once, at the end of the warp's range.
//
// Numerics: fp32 products and sums, one rounding to the output dtype; scores
// carry log2(e) in their scale so the softmax takes exp2f; fixed orders
// everywhere, no atomics, so a call is bit-identical over runs.
//
// int8 caches (the JAX package's QuantKVCache, models/dia.py:57): K/V are int8
// [B,T,Nkv,H] with one fp32 scale per (slot, kv head), ks and vs [B,T,Nkv].
// The codes are widened exactly in registers and the scales stay outside the
// dots, as `_sdpa_quant` (:85) has them: slot t scores (q . k8[t]) * ks[t] /
// sqrt(H) and contributes p[t] * vs[t] * v8[t].  For self-attention the
// current token is not in the cache yet: `decode_step_scan` (:661-685) attends
// the quantized prefix and adds the token's unquantized k_new, v_new
// analytically; here rank 0 adds it as one more partial with max = its score,
// sum = 1, accumulator = v_new.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr float NEG = -1e30f;
constexpr float LOG2E = 1.44269504088896340736f;  // scores in log2 units: exp2f, not expf
constexpr int CLUSTER = 8;  // blocks (splits) per (row, kv head); the portable cluster size
constexpr int NWARPS = 4;   // warps per block, each an equal share of the block's slots
constexpr int NT = NWARPS * 32;
constexpr int UNITS = 2;    // 16-byte units of K (and of V) each lane copies per stage
constexpr int STAGES = 4;   // depth of each warp's cp.async ring

// Slot geometry of a cache element type C at head dim H: a slot's row is LPS
// units of EPL elements, one per lane, so a warp-wide copy covers SPI slots and
// a stage SPS.
template <typename C, int H>
struct Geom {
  static constexpr int EPL = 16 / (int)sizeof(C);
  static constexpr int LPS = H * (int)sizeof(C) / 16;
  static constexpr int SPI = 32 / LPS;
  static constexpr int SPS = UNITS * SPI;
  static_assert(LPS >= 1 && LPS <= 32 && 32 % LPS == 0, "a slot's row is 1..32 units");
};

// Dynamic shared memory: the rings (K and V units, and for int8 caches each
// lane's copy of its slots' scales), then the warps' and the block's partials.
template <typename C, int H, int GT>
struct Smem {
  static constexpr bool QUANT = sizeof(C) == 1;
  static constexpr int RING = NWARPS * STAGES * 2 * UNITS * 32;  // 16-byte units
  static constexpr int SRING = QUANT ? RING : 0;                 // floats
  static constexpr size_t ring = 0;
  static constexpr size_t sring = ring + (size_t)RING * 16;
  static constexpr size_t wacc = sring + (size_t)SRING * 4;      // [NWARPS][GT][H]
  static constexpr size_t wm = wacc + (size_t)NWARPS * GT * H * 4;  // [NWARPS][GT]
  static constexpr size_t wl = wm + (size_t)NWARPS * GT * 4;
  static constexpr size_t bacc = wl + (size_t)NWARPS * GT * 4;   // [GT][H]
  static constexpr size_t bm = bacc + (size_t)GT * H * 4;        // [GT]
  static constexpr size_t bl = bm + (size_t)GT * 4;
  static constexpr size_t scur = bl + (size_t)GT * 4;
  static constexpr size_t bytes = scur + (size_t)GT * 4;
  static_assert(bytes <= 227 * 1024, "shared memory of one block");
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// one 16-byte unit of cache elements, widened exactly to fp32
__device__ __forceinline__ void widen(const uint4& r, float (&f)[4]) {
  f[0] = __uint_as_float(r.x), f[1] = __uint_as_float(r.y);
  f[2] = __uint_as_float(r.z), f[3] = __uint_as_float(r.w);
}
__device__ __forceinline__ void widen(const uint4& r, float (&f)[8]) {
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // the lower address holds the lower half
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void widen(const uint4& r, float (&f)[16]) {
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int k = 0; k < 4; ++k) f[4 * i + k] = (float)((int32_t)(w[i] << (24 - 8 * k)) >> 24);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
// 16 / 4 bytes global -> shared, asynchronously; zeros when !ok (src is then not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(ok ? 4 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// until at most N of this thread's committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// grid (CLUSTER, Nkv, B), clusters of (CLUSTER, 1, 1), NT threads.  C is the
// cache's element type: T, or int8_t with the slot scales ks, vs [B, Tc, Nkv].
// GT >= G = Nq / Nkv query heads per kv head are held in registers (heads
// g >= G are zeros and never written).
template <typename T, typename C, int H, int GT>
__global__ void __launch_bounds__(NT)
decode_attention_kernel(const T* __restrict__ q, const C* __restrict__ kc,
                        const C* __restrict__ vc, const float* __restrict__ ks,
                        const float* __restrict__ vs, const T* __restrict__ k_new,
                        const T* __restrict__ v_new, const int* __restrict__ start,
                        const int* __restrict__ end, T* __restrict__ out, int Tc, int Nq,
                        int Nkv, float scale) {
  using Gm = Geom<C, H>;
  using Sm = Smem<C, H, GT>;
  constexpr int EPL = Gm::EPL, LPS = Gm::LPS, SPI = Gm::SPI, SPS = Gm::SPS;
  constexpr bool QUANT = Sm::QUANT;
  extern __shared__ __align__(16) unsigned char smem[];
  uint4* ring = reinterpret_cast<uint4*>(smem + Sm::ring);  // [NWARPS][STAGES][K, V][UNITS][32]
  float* sring = reinterpret_cast<float*>(smem + Sm::sring);
  float* wacc = reinterpret_cast<float*>(smem + Sm::wacc);
  float* wm = reinterpret_cast<float*>(smem + Sm::wm);
  float* wl = reinterpret_cast<float*>(smem + Sm::wl);
  float* bacc = reinterpret_cast<float*>(smem + Sm::bacc);
  float* bm = reinterpret_cast<float*>(smem + Sm::bm);
  float* bl = reinterpret_cast<float*>(smem + Sm::bl);
  float* scur = reinterpret_cast<float*>(smem + Sm::scur);

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int nk = blockIdx.y, b = blockIdx.z;
  const int G = Nq / Nkv;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int u = lane % LPS;    // the unit of a slot's row this lane copies
  const int sub = lane / LPS;  // its slot within a warp-wide copy

  // this warp's share of this block's share of the row's range
  const int lo = max(start[b], 0);
  const int n = max(min(end[b], Tc) - lo, 0);
  const int r0 = lo + n * rank / CLUSTER, nb = lo + n * (rank + 1) / CLUSTER - r0;
  const int w0 = r0 + nb * warp / NWARPS, w1 = r0 + nb * (warp + 1) / NWARPS;
  const int nst = (w1 - w0 + SPS - 1) / SPS;

  float qf[GT][EPL];
#pragma unroll
  for (int g = 0; g < GT; ++g)
#pragma unroll
    for (int e = 0; e < EPL; ++e)
      qf[g][e] = g < G ? to_f(q[((size_t)b * Nq + nk * G + g) * H + u * EPL + e]) : 0.f;

  const size_t slot_stride = (size_t)Nkv * H;
  const C* kb = kc + ((size_t)b * Tc * Nkv + nk) * H + u * EPL;
  const C* vb = vc + ((size_t)b * Tc * Nkv + nk) * H + u * EPL;
  const size_t sc0 = (size_t)b * Tc * Nkv + nk;
  uint4* my_ring = ring + (size_t)warp * STAGES * 2 * UNITS * 32;
  float* my_sring = sring + (size_t)warp * STAGES * 2 * UNITS * 32;

  auto copy_stage = [&](int j) {
    uint4* dst = my_ring + (j % STAGES) * 2 * UNITS * 32;
    float* sdst = my_sring + (j % STAGES) * 2 * UNITS * 32;
#pragma unroll
    for (int k = 0; k < UNITS; ++k) {
      const int slot = w0 + j * SPS + k * SPI + sub;
      const bool ok = slot < w1;
      const size_t off = ok ? (size_t)slot * slot_stride : 0;
      cp_async16(dst + k * 32 + lane, kb + off, ok);
      cp_async16(dst + (UNITS + k) * 32 + lane, vb + off, ok);
      if constexpr (QUANT) {
        const size_t so = sc0 + (ok ? (size_t)slot * Nkv : 0);
        cp_async4(sdst + k * 32 + lane, ks + so, ok);
        cp_async4(sdst + (UNITS + k) * 32 + lane, vs + so, ok);
      }
    }
  };

  float m[GT], l[GT], acc[GT][EPL];
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    m[g] = NEG, l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[g][e] = 0.f;
  }

#pragma unroll
  for (int j = 0; j < STAGES; ++j) {
    if (j < nst) copy_stage(j);
    cp_async_commit();  // empty groups too: the wait below counts groups
  }
  for (int j = 0; j < nst; ++j) {
    cp_async_wait<STAGES - 1>();  // stage j has landed
    const uint4* src = my_ring + (j % STAGES) * 2 * UNITS * 32;
    const float* ssrc = my_sring + (j % STAGES) * 2 * UNITS * 32;
    float s[UNITS][GT];
    bool ok[UNITS];
#pragma unroll
    for (int k = 0; k < UNITS; ++k) {
      ok[k] = w0 + j * SPS + k * SPI + sub < w1;
      float kf[EPL];
      widen(src[k * 32 + lane], kf);
      const float kscale = QUANT ? ssrc[k * 32 + lane] * scale : scale;
#pragma unroll
      for (int g = 0; g < GT; ++g) {
        float d = 0.f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) d = fmaf(qf[g][e], kf[e], d);
#pragma unroll
        for (int o = LPS / 2; o > 0; o >>= 1) d += __shfl_xor_sync(0xffffffffu, d, o);
        s[k][g] = ok[k] ? d * kscale : NEG;
      }
    }
    float p[UNITS][GT];
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      float mx = s[0][g];  // slot 0 of a stage is always in range
#pragma unroll
      for (int k = 1; k < UNITS; ++k) mx = fmaxf(mx, s[k][g]);
#pragma unroll
      for (int o = LPS; o < 32; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[g], mx);
      const float alpha = exp2f(m[g] - m_new);  // m == NEG on the first stage -> 0
      m[g] = m_new;
      float ps = 0.f;
#pragma unroll
      for (int k = 0; k < UNITS; ++k) {
        p[k][g] = ok[k] ? exp2f(s[k][g] - m_new) : 0.f;
        ps += p[k][g];
      }
      l[g] = fmaf(l[g], alpha, ps);
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[g][e] *= alpha;
    }
#pragma unroll
    for (int k = 0; k < UNITS; ++k) {
      float vf[EPL];
      widen(src[(UNITS + k) * 32 + lane], vf);
      const float vscale = QUANT ? ssrc[(UNITS + k) * 32 + lane] : 1.f;
#pragma unroll
      for (int g = 0; g < GT; ++g) {
        const float pv = p[k][g] * vscale;
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[g][e] = fmaf(pv, vf[e], acc[g][e]);
      }
    }
    __syncwarp();  // this stage's reads are done before its buffer is refilled
    if (j + STAGES < nst) copy_stage(j + STAGES);
    cp_async_commit();
  }
  cp_async_wait<0>();

  // the lanes of different slots hold partial sums over their own slots
#pragma unroll
  for (int g = 0; g < GT; ++g) {
#pragma unroll
    for (int o = LPS; o < 32; o <<= 1) {
      l[g] += __shfl_xor_sync(0xffffffffu, l[g], o);
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[g][e] += __shfl_xor_sync(0xffffffffu, acc[g][e], o);
    }
  }
  if (lane < LPS) {
#pragma unroll
    for (int g = 0; g < GT; ++g)
#pragma unroll
      for (int e = 0; e < EPL; ++e) wacc[(warp * GT + g) * H + u * EPL + e] = acc[g][e];
  }
  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < GT; ++g) wm[warp * GT + g] = m[g], wl[warp * GT + g] = l[g];
  }
  // rank 0: the current token's score for head g (warp g; G <= NWARPS)
  if (k_new != nullptr && rank == 0 && warp < G) {
    const T* qg = q + ((size_t)b * Nq + nk * G + warp) * H;
    const T* kn = k_new + ((size_t)b * Nkv + nk) * H;
    float d = 0.f;
#pragma unroll
    for (int i = lane; i < H; i += 32) d = fmaf(to_f(qg[i]), to_f(kn[i]), d);
    d = warp_sum(d);
    if (lane == 0) scur[warp] = d * scale;
  }
  __syncthreads();

  // the block's partial: its warps' partials merged in warp order
  for (int i = tid; i < G * H; i += NT) {
    const int g = i / H, d = i % H;
    float M = NEG;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w)
      if (wl[w * GT + g] > 0.f) M = fmaxf(M, wm[w * GT + g]);
    float a = 0.f, L = 0.f;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) {
      const float lw = wl[w * GT + g];
      if (lw > 0.f) {  // a warp with no slot has l == 0 (and m == NEG)
        const float e = exp2f(wm[w * GT + g] - M);
        a = fmaf(e, wacc[(w * GT + g) * H + d], a);
        L = fmaf(e, lw, L);
      }
    }
    bacc[g * H + d] = a;
    if (d == 0) bm[g] = M, bl[g] = L;
  }
  cluster.sync();  // every block's partial is in its shared memory

  if (rank == 0) {
    const size_t cur = ((size_t)b * Nkv + nk) * H;
    for (int i = tid; i < G * H; i += NT) {
      const int g = i / H, d = i % H;
      float pm[CLUSTER], pl[CLUSTER], pa[CLUSTER];
#pragma unroll
      for (int r = 0; r < CLUSTER; ++r) {  // distributed shared memory reads, all in flight
        pm[r] = cluster.map_shared_rank(bm, r)[g];
        pl[r] = cluster.map_shared_rank(bl, r)[g];
        pa[r] = cluster.map_shared_rank(bacc, r)[g * H + d];
      }
      float M = k_new != nullptr ? scur[g] : NEG;
#pragma unroll
      for (int r = 0; r < CLUSTER; ++r)
        if (pl[r] > 0.f) M = fmaxf(M, pm[r]);
      float num = 0.f, den = 0.f;
#pragma unroll
      for (int r = 0; r < CLUSTER; ++r) {
        if (pl[r] > 0.f) {
          const float e = exp2f(pm[r] - M);
          num = fmaf(e, pa[r], num);
          den = fmaf(e, pl[r], den);
        }
      }
      if (k_new != nullptr) {
        const float e = exp2f(scur[g] - M);
        num = fmaf(e, to_f(v_new[cur + d]), num);
        den += e;
      }
      // empty range and no current token: num == 0 -> exact zero
      out[((size_t)b * Nq + nk * G + g) * H + d] = from_f<T>(num / fmaxf(den, 1e-30f));
    }
  }
  cluster.sync();  // no block leaves while rank 0 may still read its shared memory
}

struct Args {
  const void *q, *kc, *vc, *ks, *vs, *k_new, *v_new, *start, *end;
  void* out;
  int B, Tc, Nq, Nkv;
  cudaStream_t stream;
};

template <typename T, typename C, int H, int GT>
cudaError_t launch(const Args& a) {
  const auto kernel = decode_attention_kernel<T, C, H, GT>;
  constexpr size_t smem = Smem<C, H, GT>::bytes;
  // the opt-in above 48 KB of shared memory, once per device (of the first 64)
  static unsigned long long configured = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64 || !(configured >> dev & 1ull)) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    if (dev < 64) configured |= 1ull << dev;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(CLUSTER, a.Nkv, a.B);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = a.stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CLUSTER;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const T*>(a.q), static_cast<const C*>(a.kc),
                           static_cast<const C*>(a.vc), static_cast<const float*>(a.ks),
                           static_cast<const float*>(a.vs), static_cast<const T*>(a.k_new),
                           static_cast<const T*>(a.v_new), static_cast<const int*>(a.start),
                           static_cast<const int*>(a.end), static_cast<T*>(a.out), a.Tc, a.Nq,
                           a.Nkv, LOG2E / sqrtf((float)H));
  const cudaError_t last = cudaGetLastError();  // clear it: the next entry's check reads it
  return err != cudaSuccess ? err : last;
}

template <typename T, typename C, int H>
cudaError_t dispatch_g(int G, const Args& a) {
  switch (G) {
    case 1: return launch<T, C, H, 1>(a);
    case 2: return launch<T, C, H, 2>(a);
    case 3:
    case 4: return launch<T, C, H, 4>(a);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T, typename C>
cudaError_t dispatch_h(int H, int G, const Args& a) {
  switch (H) {
    case 32: return dispatch_g<T, C, 32>(G, a);
    case 64: return dispatch_g<T, C, 64>(G, a);
    case 128: return dispatch_g<T, C, 128>(G, a);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch_cache(bool kv_int8, int H, int G, const Args& a) {
  return kv_int8 ? dispatch_h<T, int8_t>(H, G, a) : dispatch_h<T, T>(H, G, a);
}

}  // namespace

// q [B,Nq,H] (dtype 0 = float32, 1 = bfloat16), start/end int32 [B], out
// [B,Nq,H] in q's dtype.  Caches [B,Tc,Nkv,H], 16-byte aligned: in q's dtype
// (kv_int8 = 0; ks, vs null), or int8 with fp32 slot scales ks, vs [B,Tc,Nkv]
// (kv_int8 = 1).  k_new, v_new [B,Nkv,H] in q's dtype: one more token that
// every row attends besides its slot range, or both null.  All contiguous.
// Requires Nq / Nkv <= 4 (NWARPS).  One launch; returns its cudaError_t.
extern "C" int decode_attention_fwd(const void* q, const void* kc, const void* vc,
                                    const void* ks, const void* vs, const void* k_new,
                                    const void* v_new, const void* start, const void* end,
                                    void* out, int B, int Tc, int Nq, int Nkv, int H, int dtype,
                                    int kv_int8, void* stream) {
  if (B <= 0 || Tc <= 0 || Nkv <= 0 || Nq % Nkv != 0 || Nq / Nkv > NWARPS ||
      (kv_int8 != 0) != (ks != nullptr) || (ks == nullptr) != (vs == nullptr) ||
      (k_new == nullptr) != (v_new == nullptr) ||
      ((reinterpret_cast<uintptr_t>(kc) | reinterpret_cast<uintptr_t>(vc)) & 15) != 0)
    return cudaErrorInvalidValue;
  const Args a{q, kc, vc, ks, vs, k_new, v_new, start, end, out, B, Tc, Nq, Nkv,
               static_cast<cudaStream_t>(stream)};
  const int G = Nq / Nkv;
  if (dtype == 0) return dispatch_cache<float>(kv_int8 != 0, H, G, a);
  if (dtype == 1) return dispatch_cache<__nv_bfloat16>(kv_int8 != 0, H, G, a);
  return cudaErrorInvalidValue;
}

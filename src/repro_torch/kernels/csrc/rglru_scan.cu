// The RG-LRU diagonal linear recurrence, forward and backward, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/rglru_scan.py:lru_scan
// (_lru_kernel), which carries the f32 state h across a sequential grid
// axis over time chunks. The reference model differentiates
// jax.lax.associative_scan instead, so there is no TPU backward to copy:
// the backward here is the reverse scan of kernels/ref.py:lru_scan_bwd_ref.
//
// Contract: a, b (B, S, W), f32 or bf16, contiguous; optional h0 (B, W) f32.
//   forward:  h_t = a_t * h_{t-1} + b_t   (h_{-1} = h0 or 0), state in f32,
//             h written in a's type;
//   backward: given h (the forward's output) and g = dL/dh,
//             dh_t = g_t + a_{t+1} * dh_{t+1}   (dh_S = 0),
//             db_t = dh_t, da_t = dh_t * h_{t-1}, dh0 = a_0 * dh_0,
//             da and db in a's type, dh0 f32.
// Every step rounds the product and then the sum (__fmul_rn, __fadd_rn):
// nvcc would otherwise contract a * h + b into one FMA, and the plain
// PyTorch loop rounds twice. So the kernels are bitwise equal to their
// plain versions, in f32 and in bf16.
//
// What bounds it on this card: bytes. Each step does 2 FLOP per element
// (forward) against 12 bytes of f32 traffic, far below the card's
// FLOP-per-byte balance. At (1, 4096, 2560) f32 the forward moves 125.8 MB
// (37.6 us at 3.35 TB/s) and the backward 209.7 MB (62.6 us).
//
// What the design does about it: one thread owns one (b, w) chain, so a
// warp's loads of a time step are 32 neighbouring addresses (coalesced).
// A chain is S dependent steps, so a thread that waited on each load would
// be bound by latency; instead it keeps the next kUnroll steps' inputs in
// flight in registers (issued before the current chunk is computed). At
// batch 1 there are only W chains (2,560 threads at width 2560), so blocks
// are one warp each, spread over as many SMs as possible. Not done yet: a
// chunked two-pass scan that is parallel over time (it fills the card but
// changes the order of the f32 operations).
#include "common.cuh"

namespace repro {
namespace lru {

constexpr int kThreads = 32;  // one warp per block: W / 32 blocks per batch row
constexpr int kUnroll = 16;   // time steps of each input kept in flight

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);  // round to nearest even, as the casts
}

// Loads kUnroll steps of one chain starting at step t0 (steps past S are
// left at 0). p points at the chain's element of step 0; steps are W apart.
template <typename T>
__device__ __forceinline__ void load_chunk(float v[kUnroll], const T* p,
                                           int t0, int S, int W) {
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int t = t0 + u;
    v[u] = t < S ? to_f32(p[static_cast<long long>(t) * W]) : 0.0f;
  }
}

// Steps t0 - u for u < kUnroll, walking backward (steps below 0 are 0).
template <typename T>
__device__ __forceinline__ void load_chunk_rev(float v[kUnroll], const T* p,
                                               int t0, int W) {
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int t = t0 - u;
    v[u] = t >= 0 ? to_f32(p[static_cast<long long>(t) * W]) : 0.0f;
  }
}

// Grid (ceil(W / kThreads), B). h0 may be null (zero initial state).
template <typename T>
__global__ void __launch_bounds__(kThreads)
fwd_kernel(const T* __restrict__ a, const T* __restrict__ b,
           const float* __restrict__ h0, T* __restrict__ h, int S, int W) {
  const int w = blockIdx.x * kThreads + threadIdx.x;
  if (w >= W) return;
  const long long base = static_cast<long long>(blockIdx.y) * S * W + w;
  const T* pa = a + base;
  const T* pb = b + base;
  T* ph = h + base;
  float state = h0 ? h0[static_cast<long long>(blockIdx.y) * W + w] : 0.0f;
  float ac[kUnroll], bc[kUnroll], an[kUnroll], bn[kUnroll];
  load_chunk(ac, pa, 0, S, W);
  load_chunk(bc, pb, 0, S, W);
  for (int t0 = 0; t0 < S; t0 += kUnroll) {
    // the next chunk's loads are issued before this chunk is computed
    load_chunk(an, pa, t0 + kUnroll, S, W);
    load_chunk(bn, pb, t0 + kUnroll, S, W);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = t0 + u;
      if (t < S) {
        state = __fadd_rn(__fmul_rn(ac[u], state), bc[u]);
        ph[static_cast<long long>(t) * W] = from_f32<T>(state);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      ac[u] = an[u];
      bc[u] = bn[u];
    }
  }
}

// Grid (ceil(W / kThreads), B). h0 and dh0 may be null.
template <typename T>
__global__ void __launch_bounds__(kThreads)
bwd_kernel(const T* __restrict__ a, const T* __restrict__ h,
           const T* __restrict__ g, const float* __restrict__ h0,
           T* __restrict__ da, T* __restrict__ db, float* __restrict__ dh0,
           int S, int W) {
  const int w = blockIdx.x * kThreads + threadIdx.x;
  if (w >= W) return;
  const long long base = static_cast<long long>(blockIdx.y) * S * W + w;
  const T* pa = a + base;
  const T* pg = g + base;
  const T* ph = h + base;
  const float hinit =
      h0 ? h0[static_cast<long long>(blockIdx.y) * W + w] : 0.0f;
  float dh = 0.0f, a_next = 0.0f;
  // chunk u holds step t0 - u: a_t, g_t and h_{t-1}
  float ac[kUnroll], gc[kUnroll], hc[kUnroll];
  float an[kUnroll], gn[kUnroll], hn[kUnroll];
  load_chunk_rev(ac, pa, S - 1, W);
  load_chunk_rev(gc, pg, S - 1, W);
  load_chunk_rev(hc, ph, S - 2, W);
  for (int t0 = S - 1; t0 >= 0; t0 -= kUnroll) {
    load_chunk_rev(an, pa, t0 - kUnroll, W);
    load_chunk_rev(gn, pg, t0 - kUnroll, W);
    load_chunk_rev(hn, ph, t0 - kUnroll - 1, W);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = t0 - u;
      if (t >= 0) {
        dh = __fadd_rn(gc[u], __fmul_rn(a_next, dh));
        const float h_prev = t > 0 ? hc[u] : hinit;
        const long long off = static_cast<long long>(t) * W;
        db[base + off] = from_f32<T>(dh);
        da[base + off] = from_f32<T>(__fmul_rn(dh, h_prev));
        a_next = ac[u];
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      ac[u] = an[u];
      gc[u] = gn[u];
      hc[u] = hn[u];
    }
  }
  if (dh0) {
    dh0[static_cast<long long>(blockIdx.y) * W + w] = __fmul_rn(a_next, dh);
  }
}

inline bool bad_shape(int B, int S, int W) {
  return B <= 0 || S <= 0 || W <= 0 || B > 65535;
}

inline dim3 grid_of(int B, int W) {
  return dim3((W + kThreads - 1) / kThreads, B);
}

}  // namespace lru
}  // namespace repro

using namespace repro;

extern "C" {

// h = scan(a, b) in a's type; h0 (B, W) f32 or null. Returns
// cudaGetLastError() after the launch.
int repro_lru_scan_fwd(const void* a, const void* b, const void* h0,
                       int dtype, void* h, int B, int S, int W,
                       void* stream) {
  if (lru::bad_shape(B, S, W)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid = lru::grid_of(B, W);
  const float* h0f = static_cast<const float*>(h0);
  if (dtype == kF32) {
    lru::fwd_kernel<float><<<grid, lru::kThreads, 0, st>>>(
        static_cast<const float*>(a), static_cast<const float*>(b), h0f,
        static_cast<float*>(h), S, W);
  } else if (dtype == kBF16) {
    lru::fwd_kernel<__nv_bfloat16><<<grid, lru::kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(a),
        static_cast<const __nv_bfloat16*>(b), h0f,
        static_cast<__nv_bfloat16*>(h), S, W);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// da, db in a's type; dh0 (B, W) f32 written when not null; h0 may be null.
int repro_lru_scan_bwd(const void* a, const void* h, const void* g,
                       const void* h0, int dtype, void* da, void* db,
                       void* dh0, int B, int S, int W, void* stream) {
  if (lru::bad_shape(B, S, W)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid = lru::grid_of(B, W);
  const float* h0f = static_cast<const float*>(h0);
  float* dh0f = static_cast<float*>(dh0);
  if (dtype == kF32) {
    lru::bwd_kernel<float><<<grid, lru::kThreads, 0, st>>>(
        static_cast<const float*>(a), static_cast<const float*>(h),
        static_cast<const float*>(g), h0f, static_cast<float*>(da),
        static_cast<float*>(db), dh0f, S, W);
  } else if (dtype == kBF16) {
    using bf = __nv_bfloat16;
    lru::bwd_kernel<bf><<<grid, lru::kThreads, 0, st>>>(
        static_cast<const bf*>(a), static_cast<const bf*>(h),
        static_cast<const bf*>(g), h0f, static_cast<bf*>(da),
        static_cast<bf*>(db), dh0f, S, W);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

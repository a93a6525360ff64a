// Shared helpers of the kernels.
//
// The int8 row-quantization kernels: a "row" is one 256-wide slice of a
// flat-packed buffer (PACK_COLS in repro_torch/compression/api.py): one
// warp owns one row, each lane eight consecutive values, loaded with
// 16-byte vector loads.
//
// The TMA kernels (rglru_scan.cu, flash_attention_sm90.cu): mbarriers, and
// on the host libcuda's cuTensorMapEncodeTiled, looked up at run time
// through the CUDA runtime's cudaGetDriverEntryPoint (no source links
// libcuda), and a once-per-device shared-memory limit.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums; libcuda is not linked
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace repro {

constexpr int kCols = 256;          // values per row (one f32 scale each)
constexpr int kPerLane = 8;         // kCols / 32 lanes
constexpr int kWarpsPerBlock = 8;   // 256 threads, 8 rows per block

enum DType : int { kF32 = 0, kBF16 = 1 };

// Eight consecutive values of a row as f32.
template <typename T> struct Vec8;

template <> struct Vec8<float> {
  __device__ static void load(const float* p, float v[kPerLane]) {
    const float4 a = reinterpret_cast<const float4*>(p)[0];
    const float4 b = reinterpret_cast<const float4*>(p)[1];
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  }
  __device__ static void store(float* p, const float v[kPerLane]) {
    reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
  }
};

template <> struct Vec8<__nv_bfloat16> {
  __device__ static void load(const __nv_bfloat16* p, float v[kPerLane]) {
    const uint4 raw = reinterpret_cast<const uint4*>(p)[0];
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
  __device__ static void store(__nv_bfloat16* p, const float v[kPerLane]) {
    uint4 raw;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      // round-to-nearest-even, as XLA's and PyTorch's f32 -> bf16 casts
      h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    }
    reinterpret_cast<uint4*>(p)[0] = raw;
  }
};

// f32 reciprocal of 127. The reference runs under jit, and XLA compiles its
// `absmax / 127.0` (a division by a constant) as this product.
constexpr float kInv127 = 1.0f / 127.0f;

// Per-row symmetric int8 quantization of the eight values a lane holds, the
// row spread over the 32 lanes of a warp:
//   scale = max(absmax * kInv127, 1e-12),  q = clip(round_half_even(v / scale))
// v / scale is an IEEE division (__fdiv_rn; the build never uses fast
// math) and rounding is to nearest even, so the result is bitwise that of
// the reference.
//
// NaN: jnp.max propagates NaN while fmaxf drops it, so a NaN anywhere in the
// row is tracked separately and makes the row's scale NaN, as in the
// reference. Every q of such a row is then 0 (cvt.rni of NaN gives 0); the
// reference's int8 cast of NaN is unspecified, so q of a NaN row is not part
// of the contract.
__device__ __forceinline__ float quantize_lane(const float v[kPerLane],
                                               int8_t q[kPerLane]) {
  float amax = 0.0f;
  bool nan = false;
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) {
    amax = fmaxf(amax, fabsf(v[i]));
    nan |= isnan(v[i]);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  }
  nan = __any_sync(0xffffffffu, nan);
  float scale = fmaxf(__fmul_rn(amax, kInv127), 1e-12f);
  if (nan) scale = __int_as_float(0x7fc00000);
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) {
    int qi = __float2int_rn(__fdiv_rn(v[i], scale));
    qi = min(max(qi, -127), 127);
    q[i] = static_cast<int8_t>(qi);
  }
  return scale;
}

__device__ __forceinline__ void store_q8(int8_t* p, const int8_t q[kPerLane]) {
  uint2 raw;
  int8_t* b = reinterpret_cast<int8_t*>(&raw);
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) b[i] = q[i];
  reinterpret_cast<uint2*>(p)[0] = raw;
}

__device__ __forceinline__ void load_q8(const int8_t* p, float v[kPerLane]) {
  const uint2 raw = reinterpret_cast<const uint2*>(p)[0];
  const int8_t* b = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) v[i] = static_cast<float>(b[i]);
}

inline unsigned int row_blocks(long long rows) {
  return static_cast<unsigned int>((rows + kWarpsPerBlock - 1) / kWarpsPerBlock);
}

// ------------------------------------------------------- TMA, mbarriers --

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Returns once the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// Makes this thread's shared-memory writes visible to the TMA (async proxy).
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, looked up once (null if missing).
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t rc = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t rc = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return rc == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

constexpr int kMaxDevices = 64;

// Raises kernel's dynamic shared-memory limit to `bytes`, once for each
// device (the attribute is the device's; `done` is the caller's record of
// the devices done): a TMA launch then costs the host little more than
// encoding its maps.
template <typename K>
cudaError_t allow_smem_once(std::atomic<bool> (&done)[kMaxDevices], K kernel,
                            int bytes) {
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return rc;
  if (dev < kMaxDevices && done[dev].load(std::memory_order_acquire)) {
    return cudaSuccess;
  }
  rc = cudaFuncSetAttribute(kernel,
                            cudaFuncAttributeMaxDynamicSharedMemorySize,
                            bytes);
  if (rc == cudaSuccess && dev < kMaxDevices) {
    done[dev].store(true, std::memory_order_release);
  }
  return rc;
}

}  // namespace repro

// Per-row symmetric int8 quantize / dequantize for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels src/repro/kernels/quantize.py:quantize
// (_quant_kernel) and :dequantize (_dequant_kernel), which the int8 delta
// compression (compression/api.py::_roundtrip_leaves) runs once per dtype
// buffer of the flat-packed client delta: (R, 256) values, one f32 scale
// per 256-wide row.
//
// What bounds it on this card: bytes. Quantize reads 4 B and writes 1 B per
// value (plus 4 B per row); dequantize the reverse. Both do a handful of
// operations per value, some 300x below the H100's operations-per-byte
// balance, so the least time is the bytes over the 3.35 TB/s HBM rate.
//
// What the design does about it: one warp owns one 256-wide row; each lane
// moves its eight values with 16-byte vector loads (two float4 for f32, one
// for bf16) and 8-byte int8 stores, so every access is fully coalesced and
// each byte is touched once. The absmax is a warp-shuffle reduction in
// registers, the row never goes through shared memory, and nothing is
// padded: the ragged last block masks its rows. The TPU kernel's 256-row
// blocks have no counterpart here; 8 rows per 256-thread block keep enough
// warps in flight to cover HBM latency.
#include "common.cuh"

namespace repro {

template <typename T>
__global__ void quantize_kernel(const T* __restrict__ x,
                                int8_t* __restrict__ q,
                                float* __restrict__ s, long long rows) {
  const int lane = threadIdx.x & 31;
  const long long row =
      static_cast<long long>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;  // whole warp exits together: ragged last block
  const long long off = row * kCols + lane * kPerLane;
  float v[kPerLane];
  Vec8<T>::load(x + off, v);
  int8_t qv[kPerLane];
  const float scale = quantize_lane(v, qv);
  store_q8(q + off, qv);
  if (lane == 0) s[row] = scale;
}

template <typename T>
__global__ void dequantize_kernel(const int8_t* __restrict__ q,
                                  const float* __restrict__ s,
                                  T* __restrict__ out, long long rows) {
  const int lane = threadIdx.x & 31;
  const long long row =
      static_cast<long long>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;
  const long long off = row * kCols + lane * kPerLane;
  const float scale = s[row];
  float v[kPerLane];
  load_q8(q + off, v);
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) v[i] = __fmul_rn(v[i], scale);
  Vec8<T>::store(out + off, v);
}

}  // namespace repro

using namespace repro;

extern "C" {

// x: (rows, 256) f32 or bf16 -> q (rows, 256) int8, s (rows, 1) f32.
// Returns cudaGetLastError() after the launch (0 = launched).
int repro_quantize(const void* x, int dtype, void* q, void* s,
                   long long rows, void* stream) {
  if (rows <= 0) return 0;
  const dim3 grid(row_blocks(rows)), block(kWarpsPerBlock * 32);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) {
    quantize_kernel<float><<<grid, block, 0, st>>>(
        static_cast<const float*>(x), static_cast<int8_t*>(q),
        static_cast<float*>(s), rows);
  } else if (dtype == kBF16) {
    quantize_kernel<__nv_bfloat16><<<grid, block, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<int8_t*>(q),
        static_cast<float*>(s), rows);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// q (rows, 256) int8, s (rows, 1) f32 -> out (rows, 256) f32 or bf16.
int repro_dequantize(const void* q, const void* s, void* out, int dtype,
                     long long rows, void* stream) {
  if (rows <= 0) return 0;
  const dim3 grid(row_blocks(rows)), block(kWarpsPerBlock * 32);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) {
    dequantize_kernel<float><<<grid, block, 0, st>>>(
        static_cast<const int8_t*>(q), static_cast<const float*>(s),
        static_cast<float*>(out), rows);
  } else if (dtype == kBF16) {
    dequantize_kernel<__nv_bfloat16><<<grid, block, 0, st>>>(
        static_cast<const int8_t*>(q), static_cast<const float*>(s),
        static_cast<__nv_bfloat16*>(out), rows);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

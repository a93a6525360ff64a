// Fused intra-pod mean + int8 quantize + dequantize for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/reduce_compress.py:reduce_compress_roundtrip
// (_reduce_compress_roundtrip_kernel), the execution of the
// compress="int8"-tagged reduce_mean that the hierarchical reduction binds
// on the flat-packed pod deltas. Canonical input (L, G, R, 256): L pods
// (the ops wrapper folds the leading pod axes into L instead of a vmap), G
// clients per pod, R rows. For each (l, r): the f32 mean over g, summed in
// order g = 0..G-1 and multiplied by the f32 reciprocal of G (not divided,
// as the reference does), quantized per row as in quantize.cu, and written
// back three ways: back = q * s in x's dtype, q int8, s f32.
//
// What bounds it on this card: bytes. Per output value it reads G input
// values and writes one back value and one int8; at lm_350m's packed delta
// (R = 1.84 M rows, L = G = 2) that is about 12.2 GB for a few operations
// per value, so the least time is bytes over the 3.35 TB/s HBM rate.
//
// What the design does about it: one warp owns one (l, r) row and walks the
// G rows in order, accumulating each lane's eight values in registers from
// 16-byte vector loads. The f32 partial never goes to device memory (the
// point of fusing: the unfused chain writes and rereads it), the absmax is a
// warp-shuffle reduction, and back/q/s are written once with vector stores.
// Rows run over the grid, the ragged last block is masked, nothing padded.
#include "common.cuh"

namespace repro {

template <typename T>
__global__ void reduce_compress_roundtrip_kernel(
    const T* __restrict__ x, T* __restrict__ back, int8_t* __restrict__ q,
    float* __restrict__ s, long long L, long long G, long long R,
    float inv_g) {
  const int lane = threadIdx.x & 31;
  const long long row =
      static_cast<long long>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= L * R) return;
  const long long l = row / R;
  const long long r = row - l * R;
  const long long col = lane * kPerLane;
  // x[l, g, r, :] lives at ((l * G + g) * R + r) * 256
  const T* src = x + ((l * G) * R + r) * kCols + col;
  const long long g_stride = R * kCols;
  float acc[kPerLane];
  Vec8<T>::load(src, acc);
  for (long long g = 1; g < G; ++g) {
    float v[kPerLane];
    Vec8<T>::load(src + g * g_stride, v);
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) acc[i] = __fadd_rn(acc[i], v[i]);
  }
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) acc[i] = __fmul_rn(acc[i], inv_g);
  int8_t qv[kPerLane];
  const float scale = quantize_lane(acc, qv);
  const long long off = row * kCols + col;  // (l, r) row of the (L, R, 256) outputs
  float b[kPerLane];
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) {
    b[i] = __fmul_rn(static_cast<float>(qv[i]), scale);
  }
  Vec8<T>::store(back + off, b);
  store_q8(q + off, qv);
  if (lane == 0) s[row] = scale;
}

}  // namespace repro

using namespace repro;

extern "C" {

// x (L, G, R, 256) f32/bf16 -> back (L, R, 256) x.dtype, q (L, R, 256) int8,
// s (L, R, 1) f32. inv_g is the f32 value of 1/G. Returns cudaGetLastError().
int repro_reduce_compress_roundtrip(const void* x, int dtype, void* back,
                                    void* q, void* s, long long L,
                                    long long G, long long R, float inv_g,
                                    void* stream) {
  const long long rows = L * R;
  if (rows <= 0) return 0;
  if (G <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(row_blocks(rows)), block(kWarpsPerBlock * 32);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) {
    reduce_compress_roundtrip_kernel<float><<<grid, block, 0, st>>>(
        static_cast<const float*>(x), static_cast<float*>(back),
        static_cast<int8_t*>(q), static_cast<float*>(s), L, G, R, inv_g);
  } else if (dtype == kBF16) {
    reduce_compress_roundtrip_kernel<__nv_bfloat16><<<grid, block, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<__nv_bfloat16*>(back), static_cast<int8_t*>(q),
        static_cast<float*>(s), L, G, R, inv_g);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

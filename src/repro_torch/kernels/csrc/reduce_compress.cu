// The three int8 reduce/compress kernels of the hierarchical reduction for
// Hopper (sm_90a). They replace the Pallas TPU kernels of
// src/repro/kernels/reduce_compress.py:
//
//   reduce_compress_roundtrip (_reduce_compress_roundtrip_kernel, K3b): the
//     execution of the compress="int8"-tagged reduce_mean that the
//     hierarchical reduction binds on the flat-packed pod deltas;
//   reduce_compress (_reduce_compress_kernel, K3a): the same pass without
//     the roundtrip value, i.e. each pod's int8 wire payload;
//   dequant_accumulate (_dequant_accumulate_kernel, K3c): the cross-pod leg
//     on the receiving side, the mean over P pods of the dequantized
//     payloads.
//
// K3a/K3b take the canonical input (L, G, R, 256): L pods (the ops wrapper
// folds the leading pod axes into L instead of a vmap), G clients per pod,
// R rows. For each (l, r): the f32 mean over g, summed in order g = 0..G-1
// and multiplied by the f32 reciprocal of G (not divided, as the reference
// does), quantized per row as in quantize.cu, and written as q int8 and s
// f32, and for K3b also as back = q * s in x's dtype. K3c takes q (P, R,
// 256) int8 and s (P, R, 1) f32 and computes, per element, acc = q_0 s_0
// (one rounded product), acc = fma(q_p, s_p, acc) for p = 1..P-1 in order,
// and acc * f32(1/P): the reference's kernel as XLA compiles it, which
// contracts the product and the sum over P into a chain of fused
// multiply-adds.
//
// What bounds them on this card: bytes. K3b reads G input values and writes
// one back value and one int8 per output value, K3a the same without back,
// a few operations per value. K3c reads P int8 and writes one f32 per value.
// At lm_350m's packed delta (R = 1.84 M rows, L = G = P = 2) that is about
// 12.2 GB (K3b), 8.5 GB (K3a) and 2.9 GB (K3c), so the least time is bytes
// over the 3.35 TB/s HBM rate.
//
// What the design does about it: one warp owns one output row and walks
// the G (or P) input rows in order, accumulating each lane's eight values
// in registers from 16-byte (f32) or 8-byte (int8) vector loads. The f32
// partial never goes to device memory (the point of fusing: the unfused
// chain writes and rereads it), the absmax is a warp-shuffle reduction, and
// every output is written once with vector stores. Rows run over the grid,
// the ragged last block is masked, nothing is padded.
#include "common.cuh"

namespace repro {

// K3a (kRoundtrip false) and K3b (kRoundtrip true): one warp per (l, r).
template <typename T, bool kRoundtrip>
__global__ void reduce_compress_kernel(
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
  if constexpr (kRoundtrip) {
    float b[kPerLane];
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) {
      b[i] = __fmul_rn(static_cast<float>(qv[i]), scale);
    }
    Vec8<T>::store(back + off, b);
  }
  store_q8(q + off, qv);
  if (lane == 0) s[row] = scale;
}

// K3c: one warp per row r, the P payload rows walked in order.
__global__ void dequant_accumulate_kernel(
    const int8_t* __restrict__ q, const float* __restrict__ s,
    float* __restrict__ out, long long P, long long R, float inv_p) {
  const int lane = threadIdx.x & 31;
  const long long row =
      static_cast<long long>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= R) return;
  const long long col = lane * kPerLane;
  const int8_t* src = q + row * kCols + col;
  const long long p_stride = R * kCols;
  float acc[kPerLane];
  load_q8(src, acc);
  float scale = s[row];
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) acc[i] = __fmul_rn(acc[i], scale);
  for (long long p = 1; p < P; ++p) {
    float v[kPerLane];
    load_q8(src + p * p_stride, v);
    scale = s[p * R + row];
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) acc[i] = __fmaf_rn(v[i], scale, acc[i]);
  }
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) acc[i] = __fmul_rn(acc[i], inv_p);
  Vec8<float>::store(out + row * kCols + col, acc);
}

template <bool kRoundtrip>
int launch_reduce_compress(const void* x, int dtype, void* back, void* q,
                           void* s, long long L, long long G, long long R,
                           float inv_g, void* stream) {
  const long long rows = L * R;
  if (rows <= 0) return 0;
  if (G <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(row_blocks(rows)), block(kWarpsPerBlock * 32);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) {
    reduce_compress_kernel<float, kRoundtrip><<<grid, block, 0, st>>>(
        static_cast<const float*>(x), static_cast<float*>(back),
        static_cast<int8_t*>(q), static_cast<float*>(s), L, G, R, inv_g);
  } else if (dtype == kBF16) {
    reduce_compress_kernel<__nv_bfloat16, kRoundtrip><<<grid, block, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<__nv_bfloat16*>(back), static_cast<int8_t*>(q),
        static_cast<float*>(s), L, G, R, inv_g);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
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
  return launch_reduce_compress<true>(x, dtype, back, q, s, L, G, R, inv_g,
                                      stream);
}

// x (L, G, R, 256) f32/bf16 -> q (L, R, 256) int8, s (L, R, 1) f32: the
// wire payload. Returns cudaGetLastError().
int repro_reduce_compress(const void* x, int dtype, void* q, void* s,
                          long long L, long long G, long long R, float inv_g,
                          void* stream) {
  return launch_reduce_compress<false>(x, dtype, nullptr, q, s, L, G, R,
                                       inv_g, stream);
}

// q (P, R, 256) int8, s (P, R, 1) f32 -> out (R, 256) f32, the mean over P
// of q * s. inv_p is the f32 value of 1/P. Returns cudaGetLastError().
int repro_dequant_accumulate(const void* q, const void* s, void* out,
                             long long P, long long R, float inv_p,
                             void* stream) {
  if (R <= 0) return 0;
  if (P <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(row_blocks(R)), block(kWarpsPerBlock * 32);
  dequant_accumulate_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(q), static_cast<const float*>(s),
      static_cast<float*>(out), P, R, inv_p);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

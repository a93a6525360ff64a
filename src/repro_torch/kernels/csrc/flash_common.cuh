// What the two K2 sources share (flash_attention.cu: the SIMT and mma.sync
// kernels; flash_attention_sm90.cu: the wgmma kernels): the call's shape,
// the reference's visibility rule and block test, and the hi/lo bf16 split
// of an f32 operand. flash_attention.cu's header states the contract.
#pragma once

#include "common.cuh"

namespace repro {
namespace flash {

constexpr float kNegInf = -1e30f;  // the reference's NEG_INF

struct Shape {
  int Sq, Skv, Hq, Hkv, causal, window;
  float scale;
};

__host__ __device__ constexpr int cdiv(int n, int d) { return (n + d - 1) / d; }

// The reference's element mask (flash_attention.py:76-83).
__device__ __forceinline__ bool pair_visible(const Shape& s, int qp, int kp) {
  bool ok = kp < s.Skv;
  if (s.causal) ok = ok && kp <= qp;
  if (s.window > 0) ok = ok && kp > qp - s.window;
  return ok;
}

// The reference's block-pair test (flash_attention.py:58-65) for a q tile
// of bq rows at q0 and a kv tile of bkv rows at k0.
__device__ __forceinline__ bool tiles_visible(const Shape& s, int q0, int bq,
                                              int k0, int bkv) {
  if (s.causal && k0 > q0 + bq - 1) return false;
  if (s.window > 0 && k0 + bkv - 1 <= q0 - s.window) return false;
  return true;
}

// Every pair of the two tiles is visible and in range: no element mask.
__device__ __forceinline__ bool tiles_full(const Shape& s, int q0, int bq,
                                           int k0, int bkv) {
  if (q0 + bq > s.Sq || k0 + bkv > s.Skv) return false;
  if (s.causal && k0 + bkv - 1 > q0) return false;
  if (s.window > 0 && k0 <= q0 + bq - 1 - s.window) return false;
  return true;
}

// The visible kv tiles [t0, t1] of a q tile (a contiguous range).
template <int BQ, int BKV>
__device__ __forceinline__ void kv_range(const Shape& s, int q0, int& t0,
                                         int& t1) {
  t1 = cdiv(s.Skv, BKV) - 1;
  if (s.causal) t1 = min(t1, (q0 + BQ - 1) / BKV);
  t0 = 0;
  while (t0 <= t1 && !tiles_visible(s, q0, BQ, t0 * BKV, BKV)) ++t0;
}

// The visible q tiles [u0, u1] of a kv tile (a contiguous range).
template <int BQ, int BKV>
__device__ __forceinline__ void q_range(const Shape& s, int k0, int& u0,
                                        int& u1) {
  u0 = s.causal ? k0 / BQ : 0;
  u1 = cdiv(s.Sq, BQ) - 1;
  while (u0 <= u1 && !tiles_visible(s, u0 * BQ, BQ, k0, BKV)) ++u0;
  while (u1 >= u0 && !tiles_visible(s, u1 * BQ, BQ, k0, BKV)) --u1;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// Two f32 values as bf16 pairs hi = bf16(x) and lo = bf16(x - hi).
__device__ __forceinline__ void split(float x, float y, uint32_t& hi,
                                      uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  hi = as_u32(h);
  lo = as_u32(__floats2bfloat162_rn(x - hf.x, y - hf.y));
}

// The A fragments (hi and lo) of columns 16 kc .. 16 kc + 15 of a 16-row
// f32 tile held as C fragments c[n][4] of its n8 blocks. The same layout
// serves mma.sync m16n8k16 and, per warp, wgmma m64nNk16 with A in
// registers: the accumulator of n8 blocks 2 kc and 2 kc + 1 is the A
// fragment of k block kc, with no shuffle.
template <int N>
__device__ __forceinline__ void split_a(float (&c)[N][4], int kc,
                                        uint32_t hi[4], uint32_t lo[4]) {
  split(c[2 * kc][0], c[2 * kc][1], hi[0], lo[0]);
  split(c[2 * kc][2], c[2 * kc][3], hi[1], lo[1]);
  split(c[2 * kc + 1][0], c[2 * kc + 1][1], hi[2], lo[2]);
  split(c[2 * kc + 1][2], c[2 * kc + 1][3], hi[3], lo[3]);
}

inline Shape make_shape(int Sq, int Skv, int Hq, int Hkv, int causal,
                        int window, float scale) {
  Shape s;
  s.Sq = Sq; s.Skv = Skv; s.Hq = Hq; s.Hkv = Hkv;
  s.causal = causal; s.window = window; s.scale = scale;
  return s;
}

// Grid limits: B and Hq <= 65535, and at most 65535 tiles of 32 rows
// along Sq and Skv (the grids' third dimension).
inline bool bad_shape(int B, int Sq, int Skv, int Hq, int Hkv) {
  return B <= 0 || Sq <= 0 || Skv <= 0 || Hkv <= 0 || Hq % Hkv != 0 ||
         B > 65535 || Hq > 65535 || cdiv(Sq, 32) > 65535 ||
         cdiv(Skv, 32) > 65535;
}

}  // namespace flash
}  // namespace repro

// What the K2 sources share (flash_attention.cu: the SIMT and mma.sync
// kernels; flash_attention_sm90.cu: the wgmma kernels; flash_decode.cu:
// the split-KV decode forward): the call's shape, the reference's
// visibility rule and block test, the hi/lo bf16 split of an f32 operand
// and the mma.sync building blocks. flash_attention.cu's header states the
// contract.
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

// The mma.sync building blocks of flash_attention.cu's tensor-core kernels
// and flash_decode.cu. 16 bytes global -> shared, or 16 zero bytes when
// !valid (src not read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::
               "r"(smem_u32(dst)), "l"(src), "r"(valid ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Waits until at most N committed groups of this thread are in flight.
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8x8 bf16 matrices from shared memory; lane i gives the address of
// row i % 8 of matrix i / 8.
__device__ __forceinline__ void ldsm4(uint32_t r[4], const __nv_bfloat16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)) : "memory");
}
__device__ __forceinline__ void ldsm4_t(uint32_t r[4],
                                        const __nv_bfloat16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)) : "memory");
}

// c (16x8 f32) += a (16x16 bf16, row) * b (16x8 bf16, col).
__device__ __forceinline__ void mma(float c[4], const uint32_t a[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Lane offsets (in bf16) into a tile with row stride LD, for ldsm4:
// a_off: the A fragment of a 16x16 block of a row-major [m][k] tile;
// b_off: the B fragments of two n8 blocks (16 rows) x k16 of an [n][k] tile
//        (registers: b0, b1 of the first n block, then of the second);
// bt_off: the same from a [k][n] tile, with ldsm4_t.
__device__ __forceinline__ int a_off(int lane, int ld) {
  return (lane & 15) * ld + (lane >> 4) * 8;
}
__device__ __forceinline__ int b_off(int lane, int ld) {
  return ((lane >> 4) * 8 + (lane & 7)) * ld + ((lane >> 3) & 1) * 8;
}
__device__ __forceinline__ int bt_off(int lane, int ld) {
  return (((lane >> 3) & 1) * 8 + (lane & 7)) * ld + (lane >> 4) * 8;
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

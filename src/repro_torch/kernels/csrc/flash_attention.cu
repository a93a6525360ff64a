// GQA flash attention, forward and backward, for Hopper (sm_90a).
//
// Replaces, for the training path:
// - the forward: the Pallas TPU kernel
//   src/repro/kernels/flash_attention.py:flash_attention (_flash_kernel);
// - the backward: src/repro/models/attention.py:_flash_bwd_rule, the XLA
//   backward of flash_attention_xla (the reference model trains through
//   flash_attention_xla, whose forward is the same online softmax).
//
// Contract (the reference's): q (B, Sq, Hq, hd), k/v (B, Skv, Hkv, hd), f32
// or bf16, contiguous; query head h reads kv head h / G with G = Hq / Hkv.
// Scores s = (q . k) * scale in f32 (a product with the f32 scale, not a
// division by sqrt(hd)); positions start at 0 for q and k; a pair is visible
// when k_pos < Skv, and k_pos <= q_pos (causal), and k_pos > q_pos - window
// (window > 0). Masked scores are -1e30, not -inf, so that a row with no
// visible score in a tile gives exp(0) = 1 there and a later tile's
// correction exp(-1e30 - m) = 0 wipes it, where -inf would give NaN.
// Forward: out = acc / max(l, 1e-30) (an IEEE division) in q's type, and for
// the backward the f32 out and L = m + log(max(l, 1e-30)) (B, Sq, Hq).
// Backward (f32 inside, results in the input types):
//   D = rowsum(f32(dout) * out_f32), p = exp(s - L),
//   dv = p^T dout, dp = dout v^T, ds = p * (dp - D) * scale,
//   dq = ds k, dk = ds^T q, dk and dv summed over the G heads of a kv head.
//
// Two routes here, chosen by dtype (REPRO_FLASH_DISPATCH); the route
// table of kernels/flash_attention.py (ROUTES) sends the bf16 forward and
// bwd_dkdv at head dims 64 and 128 to flash_attention_sm90.cu's wgmma
// kernels instead, so this file's tensor-core forward and bwd_dkdv are
// instantiated at head dims 16, 32, 80 and 256 only, and bwd_dq at all.
//
// bf16: tensor cores (namespace tc, kernels tc_*). The FlashAttention-2
// structure on mma.sync.m16n8k16 (bf16 operands, f32 accumulators). What
// bounds it: bf16 tensor-core operations, 989 TFLOP/s dense on the H100
// SXM; per visible (q, k) pair the function does 4 hd FLOP forward and
// 14 hd backward (6 hd in bwd_dq, 8 hd in bwd_dkdv).
// - The products q.k^T and dout.v^T take two bf16 tensors and are exact on
//   the tensor cores with f32 accumulation. The products p.v, p^T.dout,
//   ds.k and ds^T.q take an f32 operand (p or ds): rounded once to bf16 it
//   would leave a relative error near 2^-9 in out_f32, far outside the
//   2e-5 that the gates hold out_f32, L and D to. So each such operand x
//   is split in registers into hi = bf16(x) and lo = bf16(x - hi) (x - hi
//   is exact in f32), and the product takes two MMAs with the same other
//   operand: about 2^-17 relative error. The split costs 6 hd MMA FLOP per
//   pair forward (against the function's 4 hd) and 20 hd backward (14 hd).
// - Tiles. Each warp owns 16 rows of the tile it accumulates for: query
//   rows in the forward and bwd_dq (4 warps, 64-row q tiles), kv rows in
//   bwd_dkdv (4 warps along 64 kv rows; at head dim 256 a second set of 4
//   warps takes the other half of the dk/dv columns and recomputes the
//   same scores, so the two accumulators stay at 128 registers a thread).
//   The scores stay in registers: the C fragment of S = Q K^T is re-packed
//   as the A fragment of P V (and likewise for dS), row max and row sum
//   are quad shuffles, nothing of the (Sq, Skv) scores reaches shared or
//   device memory. Fragments come from bf16 tiles in shared memory by
//   ldmatrix (.trans for the operands read along their rows); rows are
//   padded by 16 bytes, so the 8 rows an ldmatrix phase reads fall in 8
//   distinct bank groups. kv tiles (forward, bwd_dq) or q tiles
//   (bwd_dkdv) stream through a ring of two stages filled by cp.async, the
//   next tile's copy in flight while the current one is multiplied.
//   kv-tile rows: 64, 32 at head dim 256 (forward and bwd_dq); bwd_dkdv's
//   q tiles: 64 rows at head dim <= 64, else 32.
// - Order of work: tiles the causal or window rule hides entirely are
//   skipped with the reference's block test; tiles visible everywhere skip
//   the element mask. The grid is (Hq, B, tiles) so the block scheduler
//   takes the heaviest causal tiles of every head first.
// - GQA without atomics: for G = 1 a bwd_dkdv block writes dk and dv. For
//   G > 1 the grid runs over (query head, kv tile); each block writes its
//   head's f32 partials to scratch (2, B, Skv, Hq, hd) and tc_sum_heads
//   sums the G partials of a kv head in the order g = 0..G-1 and rounds
//   once. Deterministic, and G times the blocks of a loop over heads.
// wgmma and TMA with warp specialisation (the producer / consumer ring of
// the usual Hopper attention kernel) are flash_attention_sm90.cu's; bwd_dq
// on them is not done yet.
// Resources of the bf16 route (nvcc -Xptxas -v for sm_90a, as chip_smoke.py
// logs them at [build]; dynamic shared memory from fwd_smem, dq_smem,
// dkdv_smem): registers per thread, spills, shared memory per block; "-"
// where flash_attention_sm90.cu serves the call.
//   head dim          16     32     64     80    128    256
//   tc_fwd   regs     78     80      -    135      -    255
//            smem  15360  25600      -  56320      - 101376
//   tc_dq    regs    127    128    168    168    168    245
//            smem  18432  30720  55296  67584 104448 135168
//   tc_dkdv  regs    122    164      -    175      -    248
//            smem  19456  31744      -  45568      - 135680
//   tc_sum_heads: 32 registers, no shared memory.
// No instantiation spills (0 bytes spill stores and loads in every one).
// Each score takes an accurate expf (the reference's exp to ~1 ulp), not
// the faster __expf, whose error grows with |x|.
//
// f32: the SIMT kernels below (fwd_kernel, bwd_dq_kernel, bwd_dkdv_kernel).
// The reference specifies f32 arithmetic for both products (f32 operands,
// f32 accumulation), so the peak that applies is the f32 rate outside the
// tensor cores (67 TFLOP/s). The (Sq, Skv) scores never reach device
// memory. Each block owns a tile of TILE rows (64, or 32 at head dim 256 in
// the backward) and keeps its operand tiles in shared memory as f32,
// transposed ([d][row], rows padded to TILE + 4 floats); each of the 256
// threads owns an R x R piece of the TILE x TILE score tile. A row's TILE
// scores live in the 16 lanes of one half-warp, so row max and row sum are
// shuffles. One kernel computes D and dq per q tile, one dk and dv per kv
// tile (looping over the G query heads and their q tiles).
#include "flash_common.cuh"

#include <algorithm>


namespace repro {
namespace flash {

constexpr int kThreads = 256;        // 16 x 16; thread (tx, ty) owns rows
                                     // R*ty..R*ty+R-1 x cols R*tx..R*tx+R-1

// Rows of a tile: 64, or 32 where 64-row f32 tiles would not fit in shared
// memory (the backward kernels at head dim 256). The forward keeps 64.
template <int HD> constexpr int bwd_tile() { return HD > 128 ? 32 : 64; }
constexpr int kFwdTile = 64;

// The SIMT kernels run f32 only (bf16 takes the tensor-core route).
__device__ __forceinline__ float to_f32(float x) { return x; }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}

// The reference's block-pair test (flash_attention.py:58-65) on these tiles.
template <int TILE>
__device__ __forceinline__ bool tile_visible(const Shape& s, int q0, int k0) {
  if (s.causal && k0 > q0 + TILE - 1) return false;
  if (s.window > 0 && k0 + TILE - 1 <= q0 - s.window) return false;
  return true;
}

// dst[d * (TILE + 4) + r] = f32(src[r * row_stride + d]) for r < rows, else 0.
template <typename T, int HD, int TILE>
__device__ __forceinline__ void load_transposed(float* dst, const T* src,
                                                long long row_stride,
                                                int rows) {
  constexpr int ST = TILE + 4;
  for (int e = threadIdx.x; e < TILE * HD; e += kThreads) {
    const int r = e / HD, d = e - (e / HD) * HD;
    dst[d * ST + r] = r < rows ? to_f32(src[r * row_stride + d]) : 0.0f;
  }
}

// dst[r * HD + d] = f32(src[r * row_stride + d]) for r < rows, else 0.
template <typename T, int HD, int TILE>
__device__ __forceinline__ void load_rows(float* dst, const T* src,
                                          long long row_stride, int rows) {
  for (int e = threadIdx.x; e < TILE * HD; e += kThreads) {
    const int r = e / HD, d = e - (e / HD) * HD;
    dst[e] = r < rows ? to_f32(src[r * row_stride + d]) : 0.0f;
  }
}

// R consecutive floats of shared memory (16-byte aligned for R = 4, 8-byte
// for R = 2).
template <int R> __device__ __forceinline__ void unpack(const float* p,
                                                        float v[R]);
template <> __device__ __forceinline__ void unpack<4>(const float* p,
                                                      float v[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}
template <> __device__ __forceinline__ void unpack<2>(const float* p,
                                                      float v[2]) {
  const float2 t = *reinterpret_cast<const float2*>(p);
  v[0] = t.x; v[1] = t.y;
}

// acc[i][j] += sum_d A[d][ra + i] * Bt[d][cb + j] over two transposed tiles.
template <int HD, int TILE>
__device__ __forceinline__ void tile_dot(float acc[TILE / 16][TILE / 16],
                                         const float* A, const float* Bt,
                                         int ra, int cb) {
  constexpr int R = TILE / 16, ST = TILE + 4;
#pragma unroll 4
  for (int d = 0; d < HD; ++d) {
    float a[R], b[R];
    unpack<R>(A + d * ST + ra, a);
    unpack<R>(Bt + d * ST + cb, b);
#pragma unroll
    for (int i = 0; i < R; ++i) {
#pragma unroll
      for (int j = 0; j < R; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
}

// Stores a thread's R x R piece transposed: dst[(cb + j) * ST + ra + i].
template <int TILE>
__device__ __forceinline__ void store_transposed(
    float* dst, const float x[TILE / 16][TILE / 16], int ra, int cb) {
  constexpr int ST = TILE + 4;
#pragma unroll
  for (int j = 0; j < TILE / 16; ++j) {
    float* p = dst + (cb + j) * ST + ra;
    if constexpr (TILE == 64) {
      *reinterpret_cast<float4*>(p) =
          make_float4(x[0][j], x[1][j], x[2][j], x[3][j]);
    } else {
      static_assert(TILE == 32, "tiles of 32 or 64 rows");
      *reinterpret_cast<float2*>(p) = make_float2(x[0][j], x[1][j]);
    }
  }
}

// Max / sum over the 16 lanes of a half-warp (the TILE columns of a row).
__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) {
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  }
  return x;
}
__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) {
    x += __shfl_xor_sync(0xffffffffu, x, off);
  }
  return x;
}

// ---------------------------------------------------------------------------
// Forward. Grid (q tiles, Hq, B), heaviest causal tile first. Shared memory:
// Qt, Kt [HD][ST]; V [TILE][HD]; Pt [TILE][ST] (p transposed).
template <typename T, int HD, int TILE>
__global__ void __launch_bounds__(kThreads)
fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
           const T* __restrict__ v, T* __restrict__ out,
           float* __restrict__ out32, float* __restrict__ lse, Shape s) {
  constexpr int NC = HD / 16;  // output columns per thread: tx + 16 * c
  constexpr int R = TILE / 16, ST = TILE + 4;
  extern __shared__ __align__(16) float smem[];
  float* Qt = smem;
  float* Kt = Qt + HD * ST;
  float* Vs = Kt + HD * ST;
  float* Pt = Vs + TILE * HD;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int nq = (s.Sq + TILE - 1) / TILE;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.x)) * TILE;
  const int h = blockIdx.y, b = blockIdx.z, hk = h / (s.Hq / s.Hkv);
  const long long qs = static_cast<long long>(s.Hq) * HD;
  const long long ks = static_cast<long long>(s.Hkv) * HD;
  const long long qbase = (static_cast<long long>(b) * s.Sq + q0) * qs +
                          static_cast<long long>(h) * HD;
  const long long kbase = static_cast<long long>(b) * s.Skv * ks +
                          static_cast<long long>(hk) * HD;
  load_transposed<T, HD, TILE>(Qt, q + qbase, qs, min(TILE, s.Sq - q0));

  float m[R], l[R], acc[R][NC];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.0f;
  }
  for (int k0 = 0; k0 < s.Skv; k0 += TILE) {
    if (s.causal && k0 > q0 + TILE - 1) break;
    if (!tile_visible<TILE>(s, q0, k0)) continue;
    __syncthreads();  // the previous tile's Kt, Vs and Pt are consumed
    const int rows = min(TILE, s.Skv - k0);
    load_transposed<T, HD, TILE>(Kt, k + kbase + k0 * ks, ks, rows);
    load_rows<T, HD, TILE>(Vs, v + kbase + k0 * ks, ks, rows);
    __syncthreads();
    float sc[R][R] = {};
    tile_dot<HD, TILE>(sc, Qt, Kt, R * ty, R * tx);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int qp = q0 + R * ty + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const float x = sc[i][j] * s.scale;
        sc[i][j] = pair_visible(s, qp, k0 + R * tx + j) ? x : kNegInf;
        mx = fmaxf(mx, sc[i][j]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      const float corr = expf(m[i] - m_new);
      float rs = 0.0f;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        sc[i][j] = expf(sc[i][j] - m_new);
        rs += sc[i][j];
      }
      l[i] = l[i] * corr + half_warp_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= corr;
    }
    store_transposed<TILE>(Pt, sc, R * ty, R * tx);
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < TILE; ++c) {
      float p[R];
      unpack<R>(Pt + c * ST + R * ty, p);
#pragma unroll
      for (int cc = 0; cc < NC; ++cc) {
        const float vv = Vs[c * HD + tx + 16 * cc];
#pragma unroll
        for (int i = 0; i < R; ++i) acc[i][cc] = fmaf(p[i], vv, acc[i][cc]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = R * ty + i;
    if (q0 + r >= s.Sq) continue;
    const float ls = fmaxf(l[i], 1e-30f);
    const long long row = qbase + r * qs;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const float o = __fdiv_rn(acc[i][c], ls);
      out[row + tx + 16 * c] = from_f32<T>(o);
      if (out32) out32[row + tx + 16 * c] = o;
    }
    if (tx == 0) {
      lse[(static_cast<long long>(b) * s.Sq + q0 + r) * s.Hq + h] =
          m[i] + logf(ls);
    }
  }
}

// ---------------------------------------------------------------------------
// Backward, dq (and D). Grid (q tiles, Hq, B), heaviest causal tile first.
// Shared memory: Qt, dOt, Kt, Vt [HD][ST]; dSt [TILE][ST]; L, D [TILE].
template <typename T, int HD, int TILE>
__global__ void __launch_bounds__(kThreads)
bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const float* __restrict__ out32,
              const T* __restrict__ dout, const float* __restrict__ lse,
              float* __restrict__ delta, T* __restrict__ dq, Shape s) {
  constexpr int NC = HD / 16;
  constexpr int R = TILE / 16, ST = TILE + 4;
  extern __shared__ __align__(16) float smem[];
  float* Qt = smem;
  float* dOt = Qt + HD * ST;
  float* Kt = dOt + HD * ST;
  float* Vt = Kt + HD * ST;
  float* dSt = Vt + HD * ST;
  float* Ls = dSt + TILE * ST;
  float* Ds = Ls + TILE;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nq = (s.Sq + TILE - 1) / TILE;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.x)) * TILE;
  const int h = blockIdx.y, b = blockIdx.z, hk = h / (s.Hq / s.Hkv);
  const long long qs = static_cast<long long>(s.Hq) * HD;
  const long long ks = static_cast<long long>(s.Hkv) * HD;
  const long long qbase = (static_cast<long long>(b) * s.Sq + q0) * qs +
                          static_cast<long long>(h) * HD;
  const long long kbase = static_cast<long long>(b) * s.Skv * ks +
                          static_cast<long long>(hk) * HD;
  const long long lbase = (static_cast<long long>(b) * s.Sq + q0) * s.Hq + h;
  const int rows_q = min(TILE, s.Sq - q0);
  load_transposed<T, HD, TILE>(Qt, q + qbase, qs, rows_q);
  load_transposed<T, HD, TILE>(dOt, dout + qbase, qs, rows_q);
  __syncthreads();
  // D = rowsum(f32(dout) * out_f32), one warp per row.
  for (int r = warp; r < TILE; r += kThreads / 32) {
    float part = 0.0f;
    if (r < rows_q) {
      for (int d = lane; d < HD; d += 32) {
        part = fmaf(dOt[d * ST + r], out32[qbase + r * qs + d], part);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      part += __shfl_xor_sync(0xffffffffu, part, off);
    }
    if (lane == 0) {
      Ds[r] = part;
      Ls[r] = r < rows_q ? lse[lbase + r * s.Hq] : 0.0f;
      if (r < rows_q) delta[lbase + r * s.Hq] = part;
    }
  }

  float acc[R][NC];
#pragma unroll
  for (int i = 0; i < R; ++i) {
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.0f;
  }
  for (int k0 = 0; k0 < s.Skv; k0 += TILE) {
    if (s.causal && k0 > q0 + TILE - 1) break;
    if (!tile_visible<TILE>(s, q0, k0)) continue;
    __syncthreads();  // D and L written; the previous tile consumed
    const int rows = min(TILE, s.Skv - k0);
    load_transposed<T, HD, TILE>(Kt, k + kbase + k0 * ks, ks, rows);
    load_transposed<T, HD, TILE>(Vt, v + kbase + k0 * ks, ks, rows);
    __syncthreads();
    float sc[R][R] = {}, dp[R][R] = {};
    tile_dot<HD, TILE>(sc, Qt, Kt, R * ty, R * tx);
    tile_dot<HD, TILE>(dp, dOt, Vt, R * ty, R * tx);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int r = R * ty + i;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const float x = sc[i][j] * s.scale;
        const float sv = pair_visible(s, q0 + r, k0 + R * tx + j) ? x : kNegInf;
        const float p = expf(sv - Ls[r]);
        sc[i][j] = p * (dp[i][j] - Ds[r]) * s.scale;
      }
    }
    store_transposed<TILE>(dSt, sc, R * ty, R * tx);
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < TILE; ++c) {
      float a[R];
      unpack<R>(dSt + c * ST + R * ty, a);
#pragma unroll
      for (int cc = 0; cc < NC; ++cc) {
        const float kk = Kt[(tx + 16 * cc) * ST + c];
#pragma unroll
        for (int i = 0; i < R; ++i) acc[i][cc] = fmaf(a[i], kk, acc[i][cc]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = R * ty + i;
    if (r >= rows_q) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      dq[qbase + r * qs + tx + 16 * c] = from_f32<T>(acc[i][c]);
    }
  }
}

// ---------------------------------------------------------------------------
// Backward, dk and dv. Grid (kv tiles, Hkv, B), heaviest causal tile first
// (kv tile 0 is seen by every q tile). Thread (tx, ty) owns kv rows
// R*ty..R*ty+R-1 and q columns R*tx..R*tx+R-1 of the transposed score tile.
// Shared memory: Kt, Vt, Qt, dOt [HD][ST]; Ps, dSs [TILE q][ST]; L, D [TILE].
template <typename T, int HD, int TILE>
__global__ void __launch_bounds__(kThreads)
bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta, T* __restrict__ dk,
                T* __restrict__ dv, Shape s) {
  constexpr int NC = HD / 16;
  constexpr int R = TILE / 16, ST = TILE + 4;
  extern __shared__ __align__(16) float smem[];
  float* Kt = smem;
  float* Vt = Kt + HD * ST;
  float* Qt = Vt + HD * ST;
  float* dOt = Qt + HD * ST;
  float* Ps = dOt + HD * ST;
  float* dSs = Ps + TILE * ST;
  float* Ls = dSs + TILE * ST;
  float* Ds = Ls + TILE;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int k0 = blockIdx.x * TILE;
  const int hk = blockIdx.y, b = blockIdx.z, G = s.Hq / s.Hkv;
  const long long qs = static_cast<long long>(s.Hq) * HD;
  const long long ks = static_cast<long long>(s.Hkv) * HD;
  const long long kbase = (static_cast<long long>(b) * s.Skv + k0) * ks +
                          static_cast<long long>(hk) * HD;
  const int rows_k = min(TILE, s.Skv - k0);
  load_transposed<T, HD, TILE>(Kt, k + kbase, ks, rows_k);
  load_transposed<T, HD, TILE>(Vt, v + kbase, ks, rows_k);

  float dka[R][NC], dva[R][NC];
#pragma unroll
  for (int i = 0; i < R; ++i) {
#pragma unroll
    for (int c = 0; c < NC; ++c) dka[i][c] = dva[i][c] = 0.0f;
  }
  for (int g = 0; g < G; ++g) {
    const int h = hk * G + g;
    // causal: q tiles before k0 cannot see this kv tile
    for (int q0 = s.causal ? k0 : 0; q0 < s.Sq; q0 += TILE) {
      if (s.window > 0 && k0 + TILE - 1 <= q0 - s.window) break;
      if (!tile_visible<TILE>(s, q0, k0)) continue;
      __syncthreads();  // the previous q tile is consumed
      const int rows_q = min(TILE, s.Sq - q0);
      const long long qbase = (static_cast<long long>(b) * s.Sq + q0) * qs +
                              static_cast<long long>(h) * HD;
      const long long lbase =
          (static_cast<long long>(b) * s.Sq + q0) * s.Hq + h;
      load_transposed<T, HD, TILE>(Qt, q + qbase, qs, rows_q);
      load_transposed<T, HD, TILE>(dOt, dout + qbase, qs, rows_q);
      for (int r = threadIdx.x; r < TILE; r += kThreads) {
        Ls[r] = r < rows_q ? lse[lbase + r * s.Hq] : 0.0f;
        Ds[r] = r < rows_q ? delta[lbase + r * s.Hq] : 0.0f;
      }
      __syncthreads();
      float sc[R][R] = {}, dp[R][R] = {};
      tile_dot<HD, TILE>(sc, Kt, Qt, R * ty, R * tx);
      tile_dot<HD, TILE>(dp, Vt, dOt, R * ty, R * tx);
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int kp = k0 + R * ty + i;
#pragma unroll
        for (int j = 0; j < R; ++j) {
          const int r = R * tx + j;
          const float x = sc[i][j] * s.scale;
          const float sv = pair_visible(s, q0 + r, kp) ? x : kNegInf;
          const float p = r < rows_q ? expf(sv - Ls[r]) : 0.0f;
          sc[i][j] = p;
          dp[i][j] = p * (dp[i][j] - Ds[r]) * s.scale;
        }
      }
      // sc[i][j] is p^T[kv R*ty+i][q R*tx+j]; stored as Ps[q][kv].
      store_transposed<TILE>(Ps, sc, R * ty, R * tx);
      store_transposed<TILE>(dSs, dp, R * ty, R * tx);
      __syncthreads();
#pragma unroll 2
      for (int r = 0; r < TILE; ++r) {
        float p[R], ds[R];
        unpack<R>(Ps + r * ST + R * ty, p);
        unpack<R>(dSs + r * ST + R * ty, ds);
#pragma unroll
        for (int cc = 0; cc < NC; ++cc) {
          const int d = tx + 16 * cc;
          const float o = dOt[d * ST + r];
          const float qq = Qt[d * ST + r];
#pragma unroll
          for (int i = 0; i < R; ++i) {
            dva[i][cc] = fmaf(p[i], o, dva[i][cc]);
            dka[i][cc] = fmaf(ds[i], qq, dka[i][cc]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = R * ty + i;
    if (r >= rows_k) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      dk[kbase + r * ks + tx + 16 * c] = from_f32<T>(dka[i][c]);
      dv[kbase + r * ks + tx + 16 * c] = from_f32<T>(dva[i][c]);
    }
  }
}

// ---------------------------------------------------------------------------
// The bf16 route: tensor cores.
namespace tc {

using bf16 = __nv_bfloat16;

constexpr int kPad = 8;     // bf16 of padding per shared row (16 bytes)
constexpr int kStages = 2;  // the cp.async ring

// Tiles per head dim. Forward and bwd_dq: 4 warps of 16 query rows, kv
// tiles of BKV rows. bwd_dkdv: 4 warps of 16 kv rows (x DS at head dim 256,
// each set of 4 taking HD / DS of the dk/dv columns), q tiles of BQ rows.
template <int HD> struct FwdTiles {
  static constexpr int BQ = 64, BKV = HD > 128 ? 32 : 64, THREADS = 128;
};
template <int HD> struct DkdvTiles {
  static constexpr int BKV = 64, DS = HD > 128 ? 2 : 1;
  static constexpr int BQ = HD > 64 ? 32 : 64, THREADS = 128 * DS;
};

// 16 bytes global -> shared, or 16 zero bytes when !valid (src not read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::
               "r"(smem_u32(dst)), "l"(src), "r"(valid ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::
               "r"(smem_u32(dst)), "l"(src), "r"(valid ? 4 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Waits until at most one committed group of this thread is in flight.
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Four 8x8 bf16 matrices from shared memory; lane i gives the address of
// row i % 8 of matrix i / 8.
__device__ __forceinline__ void ldsm4(uint32_t r[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)) : "memory");
}
__device__ __forceinline__ void ldsm4_t(uint32_t r[4], const bf16* p) {
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

// ROWS rows of HD bf16 (row stride `stride` elements) into shared memory
// with row stride HD + kPad; rows >= `rows` are zero-filled.
template <int HD, int ROWS, int NT>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          long long stride, int rows) {
  constexpr int CPR = HD / 8, LD = HD + kPad;
  for (int c = threadIdx.x; c < ROWS * CPR; c += NT) {
    const int r = c / CPR, cc = c - r * CPR;
    const bool ok = r < rows;
    cp_async16(dst + r * LD + cc * 8, src + (ok ? r * stride : 0) + cc * 8,
               ok);
  }
}

// N f32 values src[r * stride] into dst[r]; zero for r >= rows.
template <int N, int NT>
__device__ __forceinline__ void load_vec(float* dst, const float* src,
                                         int stride, int rows) {
  for (int r = threadIdx.x; r < N; r += NT) {
    const bool ok = r < rows;
    cp_async4(dst + r, src + (ok ? static_cast<long long>(r) * stride : 0),
              ok);
  }
}

// ---------------------------------------------------------------------------
// Forward. Grid (Hq, B, q tiles), heaviest causal q tile first. Shared
// memory: Q [BQ][LD]; K, V [kStages][BKV][LD].
template <int HD>
__global__ void __launch_bounds__(FwdTiles<HD>::THREADS)
tc_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, bf16* __restrict__ out,
              float* __restrict__ out32, float* __restrict__ lse, Shape s) {
  using C = FwdTiles<HD>;
  constexpr int BQ = C::BQ, BKV = C::BKV, NT = C::THREADS, LD = HD + kPad;
  constexpr int NS = BKV / 8, ND = HD / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ks = Qs + BQ * LD;
  bf16* Vs = Ks + kStages * BKV * LD;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3, r0 = warp * 16;
  const int h = blockIdx.x, b = blockIdx.y, hk = h / (s.Hq / s.Hkv);
  const int q0 = (cdiv(s.Sq, BQ) - 1 - static_cast<int>(blockIdx.z)) * BQ;
  const long long qs = static_cast<long long>(s.Hq) * HD;
  const long long ks = static_cast<long long>(s.Hkv) * HD;
  const long long qbase = (static_cast<long long>(b) * s.Sq + q0) * qs +
                          static_cast<long long>(h) * HD;
  const long long kbase = static_cast<long long>(b) * s.Skv * ks +
                          static_cast<long long>(hk) * HD;
  int t0, t1;
  kv_range<BQ, BKV>(s, q0, t0, t1);
  load_tile<HD, BQ, NT>(Qs, q + qbase, qs, min(BQ, s.Sq - q0));
  if (t0 <= t1) {
    const int rows = min(BKV, s.Skv - t0 * BKV);
    load_tile<HD, BKV, NT>(Ks, k + kbase + t0 * BKV * ks, ks, rows);
    load_tile<HD, BKV, NT>(Vs, v + kbase + t0 * BKV * ks, ks, rows);
  }
  cp_async_commit();

  float o[ND][4], m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};
#pragma unroll
  for (int n = 0; n < ND; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.0f;
  for (int t = t0; t <= t1; ++t) {
    const int st = (t - t0) & 1;
    if (t < t1) {
      const int k1 = (t + 1) * BKV, rows = min(BKV, s.Skv - k1);
      load_tile<HD, BKV, NT>(Ks + (st ^ 1) * BKV * LD, k + kbase + k1 * ks,
                             ks, rows);
      load_tile<HD, BKV, NT>(Vs + (st ^ 1) * BKV * LD, v + kbase + k1 * ks,
                             ks, rows);
    }
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();
    const bf16* Kt = Ks + st * BKV * LD;
    const bf16* Vt = Vs + st * BKV * LD;
    const int k0 = t * BKV;

    float sc[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.0f;
    }
#pragma unroll
    for (int kk = 0; kk < HD; kk += 16) {
      uint32_t a[4];
      ldsm4(a, Qs + r0 * LD + kk + a_off(lane, LD));
#pragma unroll
      for (int n = 0; n < NS; n += 2) {
        uint32_t bb[4];
        ldsm4(bb, Kt + n * 8 * LD + kk + b_off(lane, LD));
        mma(sc[n], a, bb[0], bb[1]);
        mma(sc[n + 1], a, bb[2], bb[3]);
      }
    }
    const bool full = tiles_full(s, q0, BQ, k0, BKV);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = __fmul_rn(sc[n][e], s.scale);
        if (!full && !pair_visible(s, q0 + r0 + g + (e >> 1) * 8,
                                   k0 + n * 8 + 2 * t4 + (e & 1))) {
          x = kNegInf;
        }
        sc[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float corr[2], rs[2] = {0.0f, 0.0f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = quad_max(mx[i]);
      corr[i] = expf(m[i] - mx[i]);
      m[i] = mx[i];
    }
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sc[n][e] = expf(sc[n][e] - m[e >> 1]);
        rs[e >> 1] += sc[n][e];
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * corr[i] + quad_sum(rs[i]);
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      o[n][0] *= corr[0]; o[n][1] *= corr[0];
      o[n][2] *= corr[1]; o[n][3] *= corr[1];
    }
    // O += P_hi V + P_lo V
#pragma unroll
    for (int kc = 0; kc < BKV / 16; ++kc) {
      uint32_t hi[4], lo[4];
      split_a<NS>(sc, kc, hi, lo);
#pragma unroll
      for (int n = 0; n < ND; n += 2) {
        uint32_t bb[4];
        ldsm4_t(bb, Vt + kc * 16 * LD + n * 8 + bt_off(lane, LD));
        mma(o[n], hi, bb[0], bb[1]);
        mma(o[n], lo, bb[0], bb[1]);
        mma(o[n + 1], hi, bb[2], bb[3]);
        mma(o[n + 1], lo, bb[2], bb[3]);
      }
    }
    __syncthreads();  // stage st is refilled by the next iteration
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + g + 8 * i;
    if (q0 + row >= s.Sq) continue;
    const float ls = fmaxf(l[i], 1e-30f);
    const long long off = qbase + row * qs;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      const int c = n * 8 + 2 * t4;
      const float a = __fdiv_rn(o[n][2 * i], ls);
      const float bv = __fdiv_rn(o[n][2 * i + 1], ls);
      *reinterpret_cast<__nv_bfloat162*>(out + off + c) =
          __floats2bfloat162_rn(a, bv);
      if (out32) {
        *reinterpret_cast<float2*>(out32 + off + c) = make_float2(a, bv);
      }
    }
    if (t4 == 0) {
      lse[(static_cast<long long>(b) * s.Sq + q0 + row) * s.Hq + h] =
          m[i] + logf(ls);
    }
  }
}

// ---------------------------------------------------------------------------
// Backward, dq (and D). Grid (Hq, B, q tiles), heaviest causal q tile
// first. Shared memory: Q, dO [BQ][LD]; K, V [kStages][BKV][LD].
template <int HD>
__global__ void __launch_bounds__(FwdTiles<HD>::THREADS)
tc_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const float* __restrict__ out32,
                 const bf16* __restrict__ dout, const float* __restrict__ lse,
                 float* __restrict__ delta, bf16* __restrict__ dq, Shape s) {
  using C = FwdTiles<HD>;
  constexpr int BQ = C::BQ, BKV = C::BKV, NT = C::THREADS, LD = HD + kPad;
  constexpr int NS = BKV / 8, ND = HD / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* dOs = Qs + BQ * LD;
  bf16* Ks = dOs + BQ * LD;
  bf16* Vs = Ks + kStages * BKV * LD;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3, r0 = warp * 16;
  const int h = blockIdx.x, b = blockIdx.y, hk = h / (s.Hq / s.Hkv);
  const int q0 = (cdiv(s.Sq, BQ) - 1 - static_cast<int>(blockIdx.z)) * BQ;
  const long long qs = static_cast<long long>(s.Hq) * HD;
  const long long ks = static_cast<long long>(s.Hkv) * HD;
  const long long qbase = (static_cast<long long>(b) * s.Sq + q0) * qs +
                          static_cast<long long>(h) * HD;
  const long long kbase = static_cast<long long>(b) * s.Skv * ks +
                          static_cast<long long>(hk) * HD;
  const long long lbase = (static_cast<long long>(b) * s.Sq + q0) * s.Hq + h;
  const int rows_q = min(BQ, s.Sq - q0);
  int t0, t1;
  kv_range<BQ, BKV>(s, q0, t0, t1);
  load_tile<HD, BQ, NT>(Qs, q + qbase, qs, rows_q);
  load_tile<HD, BQ, NT>(dOs, dout + qbase, qs, rows_q);
  if (t0 <= t1) {
    const int rows = min(BKV, s.Skv - t0 * BKV);
    load_tile<HD, BKV, NT>(Ks, k + kbase + t0 * BKV * ks, ks, rows);
    load_tile<HD, BKV, NT>(Vs, v + kbase + t0 * BKV * ks, ks, rows);
  }
  cp_async_commit();

  // D = rowsum(f32(dout) * out_f32) of the warp's 16 rows (each row over
  // the warp's lanes); this thread keeps D and L of rows g and g + 8.
  float Dr[2] = {0.0f, 0.0f}, Lr[2];
#pragma unroll 1
  for (int r = 0; r < 16; ++r) {
    float part = 0.0f;
    if (r0 + r < rows_q) {
      const long long off = qbase + (r0 + r) * qs;
      for (int d = lane; d < HD; d += 32) {
        part = fmaf(__bfloat162float(dout[off + d]), out32[off + d], part);
      }
    }
#pragma unroll
    for (int x = 16; x > 0; x >>= 1) {
      part += __shfl_xor_sync(0xffffffffu, part, x);
    }
    if (r == g) Dr[0] = part;
    if (r == g + 8) Dr[1] = part;
    if (lane == 0 && r0 + r < rows_q) delta[lbase + (r0 + r) * s.Hq] = part;
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + g + 8 * i;
    Lr[i] = row < rows_q ? lse[lbase + row * s.Hq] : 0.0f;
  }

  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;
  }
  for (int t = t0; t <= t1; ++t) {
    const int st = (t - t0) & 1;
    if (t < t1) {
      const int k1 = (t + 1) * BKV, rows = min(BKV, s.Skv - k1);
      load_tile<HD, BKV, NT>(Ks + (st ^ 1) * BKV * LD, k + kbase + k1 * ks,
                             ks, rows);
      load_tile<HD, BKV, NT>(Vs + (st ^ 1) * BKV * LD, v + kbase + k1 * ks,
                             ks, rows);
    }
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();
    const bf16* Kt = Ks + st * BKV * LD;
    const bf16* Vt = Vs + st * BKV * LD;
    const int k0 = t * BKV;

    float sc[NS][4], dp[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[n][e] = dp[n][e] = 0.0f;
    }
#pragma unroll
    for (int kk = 0; kk < HD; kk += 16) {
      uint32_t a[4], ad[4];
      ldsm4(a, Qs + r0 * LD + kk + a_off(lane, LD));
      ldsm4(ad, dOs + r0 * LD + kk + a_off(lane, LD));
#pragma unroll
      for (int n = 0; n < NS; n += 2) {
        uint32_t bk[4], bv[4];
        ldsm4(bk, Kt + n * 8 * LD + kk + b_off(lane, LD));
        ldsm4(bv, Vt + n * 8 * LD + kk + b_off(lane, LD));
        mma(sc[n], a, bk[0], bk[1]);
        mma(sc[n + 1], a, bk[2], bk[3]);
        mma(dp[n], ad, bv[0], bv[1]);
        mma(dp[n + 1], ad, bv[2], bv[3]);
      }
    }
    const bool full = tiles_full(s, q0, BQ, k0, BKV);
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        float x = __fmul_rn(sc[n][e], s.scale);
        if (!full && !pair_visible(s, q0 + r0 + g + 8 * i,
                                   k0 + n * 8 + 2 * t4 + (e & 1))) {
          x = kNegInf;
        }
        const float p = expf(x - Lr[i]);
        sc[n][e] = __fmul_rn(p * (dp[n][e] - Dr[i]), s.scale);  // ds
      }
    }
    // dQ += dS_hi K + dS_lo K
#pragma unroll
    for (int kc = 0; kc < BKV / 16; ++kc) {
      uint32_t hi[4], lo[4];
      split_a<NS>(sc, kc, hi, lo);
#pragma unroll
      for (int n = 0; n < ND; n += 2) {
        uint32_t bb[4];
        ldsm4_t(bb, Kt + kc * 16 * LD + n * 8 + bt_off(lane, LD));
        mma(acc[n], hi, bb[0], bb[1]);
        mma(acc[n], lo, bb[0], bb[1]);
        mma(acc[n + 1], hi, bb[2], bb[3]);
        mma(acc[n + 1], lo, bb[2], bb[3]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + g + 8 * i;
    if (row >= rows_q) continue;
    const long long off = qbase + row * qs;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(dq + off + n * 8 + 2 * t4) =
          __floats2bfloat162_rn(acc[n][2 * i], acc[n][2 * i + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// Backward, dk and dv of one query head. Grid (Hq, B, kv tiles), kv tile 0
// first (it is seen by every causal q tile). Warp w owns kv rows
// 16 (w % 4) .. + 15 and dk/dv columns (w / 4) HD / DS .. + HD / DS - 1.
// For G = 1 it writes dk and dv; for G > 1 the f32 partials of head h to
// part[0 or 1][b][kv][h][:], summed by tc_sum_heads_kernel. Shared memory:
// K, V [BKV][LD]; Q, dO [kStages][BQ][LD]; L, D [kStages][BQ] f32.
template <int HD>
__global__ void __launch_bounds__(DkdvTiles<HD>::THREADS)
tc_bwd_dkdv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const bf16* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, bf16* __restrict__ dk,
                   bf16* __restrict__ dv, float* __restrict__ part, Shape s) {
  using C = DkdvTiles<HD>;
  constexpr int BQ = C::BQ, BKV = C::BKV, NT = C::THREADS, LD = HD + kPad;
  constexpr int HDW = HD / C::DS, NS = BQ / 8, NDW = HDW / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* Vs = Ks + BKV * LD;
  bf16* Qs = Vs + BKV * LD;
  bf16* dOs = Qs + kStages * BQ * LD;
  float* Ls = reinterpret_cast<float*>(dOs + kStages * BQ * LD);
  float* Ds = Ls + kStages * BQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int r0 = (warp & 3) * 16, c0 = (warp >> 2) * HDW;
  const int h = blockIdx.x, b = blockIdx.y, G = s.Hq / s.Hkv, hk = h / G;
  const int k0 = static_cast<int>(blockIdx.z) * BKV;
  const long long qs = static_cast<long long>(s.Hq) * HD;
  const long long ks = static_cast<long long>(s.Hkv) * HD;
  const long long kbase = (static_cast<long long>(b) * s.Skv + k0) * ks +
                          static_cast<long long>(hk) * HD;
  const long long qhead = static_cast<long long>(b) * s.Sq * qs +
                          static_cast<long long>(h) * HD;
  const long long lhead = static_cast<long long>(b) * s.Sq * s.Hq + h;
  const int rows_k = min(BKV, s.Skv - k0);
  // The visible q tiles [u0, u1] of this kv tile (a contiguous range).
  int u0, u1;
  q_range<BQ, BKV>(s, k0, u0, u1);

  auto load_q_tile = [&](int u, int stage) {
    const int qt0 = u * BQ, rows = min(BQ, s.Sq - qt0);
    load_tile<HD, BQ, NT>(Qs + stage * BQ * LD, q + qhead + qt0 * qs, qs,
                          rows);
    load_tile<HD, BQ, NT>(dOs + stage * BQ * LD, dout + qhead + qt0 * qs, qs,
                          rows);
    const long long l0 = lhead + static_cast<long long>(qt0) * s.Hq;
    load_vec<BQ, NT>(Ls + stage * BQ, lse + l0, s.Hq, rows);
    load_vec<BQ, NT>(Ds + stage * BQ, delta + l0, s.Hq, rows);
  };
  load_tile<HD, BKV, NT>(Ks, k + kbase, ks, rows_k);
  load_tile<HD, BKV, NT>(Vs, v + kbase, ks, rows_k);
  if (u0 <= u1) load_q_tile(u0, 0);
  cp_async_commit();

  float dka[NDW][4], dva[NDW][4];
#pragma unroll
  for (int n = 0; n < NDW; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.0f;
  }
  for (int u = u0; u <= u1; ++u) {
    const int st = (u - u0) & 1;
    if (u < u1) load_q_tile(u + 1, st ^ 1);
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();
    const bf16* Qt = Qs + st * BQ * LD;
    const bf16* dOt = dOs + st * BQ * LD;
    const float* Lt = Ls + st * BQ;
    const float* Dt = Ds + st * BQ;
    const int q0 = u * BQ;

    // S^T = K Q^T and dP^T = V dO^T: 16 kv rows x BQ q columns per warp.
    float sc[NS][4], dp[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[n][e] = dp[n][e] = 0.0f;
    }
#pragma unroll
    for (int kk = 0; kk < HD; kk += 16) {
      uint32_t a[4], av[4];
      ldsm4(a, Ks + r0 * LD + kk + a_off(lane, LD));
      ldsm4(av, Vs + r0 * LD + kk + a_off(lane, LD));
#pragma unroll
      for (int n = 0; n < NS; n += 2) {
        uint32_t bq[4], bo[4];
        ldsm4(bq, Qt + n * 8 * LD + kk + b_off(lane, LD));
        ldsm4(bo, dOt + n * 8 * LD + kk + b_off(lane, LD));
        mma(sc[n], a, bq[0], bq[1]);
        mma(sc[n + 1], a, bq[2], bq[3]);
        mma(dp[n], av, bo[0], bo[1]);
        mma(dp[n + 1], av, bo[2], bo[3]);
      }
    }
    const bool full = tiles_full(s, q0, BQ, k0, BKV);
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qc = n * 8 + 2 * t4 + (e & 1), qp = q0 + qc;
        float x = __fmul_rn(sc[n][e], s.scale);
        if (!full && !pair_visible(s, qp, k0 + r0 + g + 8 * (e >> 1))) {
          x = kNegInf;
        }
        const float p = (full || qp < s.Sq) ? expf(x - Lt[qc]) : 0.0f;
        dp[n][e] = __fmul_rn(p * (dp[n][e] - Dt[qc]), s.scale);  // ds^T
        sc[n][e] = p;                                            // p^T
      }
    }
    // dV += P^T_hi dO + P^T_lo dO, dK += dS^T_hi Q + dS^T_lo Q
#pragma unroll
    for (int kc = 0; kc < BQ / 16; ++kc) {
      uint32_t phi[4], plo[4], dhi[4], dlo[4];
      split_a<NS>(sc, kc, phi, plo);
      split_a<NS>(dp, kc, dhi, dlo);
#pragma unroll
      for (int n = 0; n < NDW; n += 2) {
        uint32_t bo[4], bq[4];
        ldsm4_t(bo, dOt + kc * 16 * LD + c0 + n * 8 + bt_off(lane, LD));
        ldsm4_t(bq, Qt + kc * 16 * LD + c0 + n * 8 + bt_off(lane, LD));
        mma(dva[n], phi, bo[0], bo[1]);
        mma(dva[n], plo, bo[0], bo[1]);
        mma(dva[n + 1], phi, bo[2], bo[3]);
        mma(dva[n + 1], plo, bo[2], bo[3]);
        mma(dka[n], dhi, bq[0], bq[1]);
        mma(dka[n], dlo, bq[0], bq[1]);
        mma(dka[n + 1], dhi, bq[2], bq[3]);
        mma(dka[n + 1], dlo, bq[2], bq[3]);
      }
    }
    __syncthreads();
  }
  const long long plane =
      static_cast<long long>(gridDim.y) * s.Skv * s.Hq * HD;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + g + 8 * i;
    if (row >= rows_k) continue;
    if (G == 1) {
      const long long off = kbase + row * ks + c0;
#pragma unroll
      for (int n = 0; n < NDW; ++n) {
        const int c = n * 8 + 2 * t4;
        *reinterpret_cast<__nv_bfloat162*>(dk + off + c) =
            __floats2bfloat162_rn(dka[n][2 * i], dka[n][2 * i + 1]);
        *reinterpret_cast<__nv_bfloat162*>(dv + off + c) =
            __floats2bfloat162_rn(dva[n][2 * i], dva[n][2 * i + 1]);
      }
    } else {
      const long long off =
          ((static_cast<long long>(b) * s.Skv + k0 + row) * s.Hq + h) * HD +
          c0;
#pragma unroll
      for (int n = 0; n < NDW; ++n) {
        const int c = n * 8 + 2 * t4;
        *reinterpret_cast<float2*>(part + off + c) =
            make_float2(dka[n][2 * i], dka[n][2 * i + 1]);
        *reinterpret_cast<float2*>(part + plane + off + c) =
            make_float2(dva[n][2 * i], dva[n][2 * i + 1]);
      }
    }
  }
}

// dk[b][kv][hk][d] = bf16(sum over g = 0..G-1, in order, of
// part[0][b][kv][hk * G + g][d]), and dv likewise from part[1].
__global__ void __launch_bounds__(256)
tc_sum_heads_kernel(const float* __restrict__ part, bf16* __restrict__ dk,
                    bf16* __restrict__ dv, long long n, long long plane,
                    int G, int Hkv, int hd) {
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x; i < n; i += step) {
    const long long d = i % hd, rest = i / hd;
    const long long hk = rest % Hkv, bs = rest / Hkv;
    const long long base = (bs * Hkv * G + hk * G) * hd + d;
    float a = part[base], c = part[plane + base];
    for (int j = 1; j < G; ++j) {
      a += part[base + j * hd];
      c += part[plane + base + j * hd];
    }
    dk[i] = __float2bfloat16_rn(a);
    dv[i] = __float2bfloat16_rn(c);
  }
}

template <int HD> constexpr size_t fwd_smem() {
  using C = FwdTiles<HD>;
  return sizeof(bf16) * (C::BQ + 2 * kStages * C::BKV) * (HD + kPad);
}
template <int HD> constexpr size_t dq_smem() {
  using C = FwdTiles<HD>;
  return sizeof(bf16) * (2 * C::BQ + 2 * kStages * C::BKV) * (HD + kPad);
}
template <int HD> constexpr size_t dkdv_smem() {
  using C = DkdvTiles<HD>;
  return sizeof(bf16) * (2 * C::BKV + 2 * kStages * C::BQ) * (HD + kPad) +
         sizeof(float) * 2 * kStages * C::BQ;
}

}  // namespace tc

// ---------------------------------------------------------------------------
// Host side: shared memory per kernel, and dispatch over (dtype, head_dim).

template <int HD, int TILE> constexpr size_t fwd_smem() {
  return sizeof(float) * (2 * HD * (TILE + 4) + TILE * HD + TILE * (TILE + 4));
}
template <int HD, int TILE> constexpr size_t dq_smem() {
  return sizeof(float) * (4 * HD * (TILE + 4) + TILE * (TILE + 4) + 2 * TILE);
}
template <int HD, int TILE> constexpr size_t dkdv_smem() {
  return sizeof(float) *
         (4 * HD * (TILE + 4) + 2 * TILE * (TILE + 4) + 2 * TILE);
}
// What a block may opt into on sm_90.
constexpr size_t kMaxSmem = 232448;
static_assert(fwd_smem<256, kFwdTile>() <= kMaxSmem, "fwd at hd 256");
static_assert(dq_smem<256, bwd_tile<256>()>() <= kMaxSmem, "dq at hd 256");
static_assert(dkdv_smem<256, bwd_tile<256>()>() <= kMaxSmem, "dkdv at hd 256");
static_assert(tc::fwd_smem<256>() <= kMaxSmem, "tc fwd at hd 256");
static_assert(tc::dq_smem<256>() <= kMaxSmem, "tc dq at hd 256");
static_assert(tc::dkdv_smem<256>() <= kMaxSmem, "tc dkdv at hd 256");

// Above 48 KB a kernel takes dynamic shared memory only after this call;
// without it the launch is refused (reported by cudaGetLastError).
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <typename T, int HD>
int launch_fwd(const void* q, const void* k, const void* v, void* out,
               void* out32, void* lse, int B, Shape s, cudaStream_t st) {
  constexpr int TILE = kFwdTile;
  constexpr size_t smem = fwd_smem<HD, TILE>();
  const cudaError_t e = allow_smem(fwd_kernel<T, HD, TILE>, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(cdiv(s.Sq, TILE), s.Hq, B);
  fwd_kernel<T, HD, TILE><<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out),
      static_cast<float*>(out32), static_cast<float*>(lse), s);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int HD>
int launch_dq(const void* q, const void* k, const void* v, const void* out32,
              const void* dout, const void* lse, void* delta, void* dq,
              int B, Shape s, cudaStream_t st) {
  constexpr int TILE = bwd_tile<HD>();
  constexpr size_t smem = dq_smem<HD, TILE>();
  const cudaError_t e = allow_smem(bwd_dq_kernel<T, HD, TILE>, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(cdiv(s.Sq, TILE), s.Hq, B);
  bwd_dq_kernel<T, HD, TILE><<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(out32),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<float*>(delta), static_cast<T*>(dq), s);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int HD>
int launch_dkdv(const void* q, const void* k, const void* v, const void* dout,
                const void* lse, const void* delta, void* dk, void* dv,
                void* /*part: the bf16 route's*/, int B, Shape s,
                cudaStream_t st) {
  constexpr int TILE = bwd_tile<HD>();
  constexpr size_t smem = dkdv_smem<HD, TILE>();
  const cudaError_t e = allow_smem(bwd_dkdv_kernel<T, HD, TILE>, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(cdiv(s.Skv, TILE), s.Hkv, B);
  bwd_dkdv_kernel<T, HD, TILE><<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), s);
  return static_cast<int>(cudaGetLastError());
}

// The bf16 route's launchers (tensor cores).
template <int HD>
int launch_tc_fwd(const void* q, const void* k, const void* v, void* out,
                  void* out32, void* lse, int B, Shape s, cudaStream_t st) {
  using bf16 = __nv_bfloat16;
  constexpr size_t smem = tc::fwd_smem<HD>();
  const cudaError_t e = allow_smem(tc::tc_fwd_kernel<HD>, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(s.Hq, B, cdiv(s.Sq, tc::FwdTiles<HD>::BQ));
  tc::tc_fwd_kernel<HD><<<grid, tc::FwdTiles<HD>::THREADS, smem, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out),
      static_cast<float*>(out32), static_cast<float*>(lse), s);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch_tc_dq(const void* q, const void* k, const void* v,
                 const void* out32, const void* dout, const void* lse,
                 void* delta, void* dq, int B, Shape s, cudaStream_t st) {
  using bf16 = __nv_bfloat16;
  constexpr size_t smem = tc::dq_smem<HD>();
  const cudaError_t e = allow_smem(tc::tc_bwd_dq_kernel<HD>, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(s.Hq, B, cdiv(s.Sq, tc::FwdTiles<HD>::BQ));
  tc::tc_bwd_dq_kernel<HD><<<grid, tc::FwdTiles<HD>::THREADS, smem, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const float*>(out32),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<float*>(delta), static_cast<bf16*>(dq), s);
  return static_cast<int>(cudaGetLastError());
}

// For G > 1, part is f32 scratch of 2 x B x Skv x Hq x hd.
template <int HD>
int launch_tc_dkdv(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta,
                   void* dk, void* dv, void* part, int B, Shape s,
                   cudaStream_t st) {
  using bf16 = __nv_bfloat16;
  using C = tc::DkdvTiles<HD>;
  const int G = s.Hq / s.Hkv;
  if (G > 1 && part == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  constexpr size_t smem = tc::dkdv_smem<HD>();
  cudaError_t e = allow_smem(tc::tc_bwd_dkdv_kernel<HD>, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(s.Hq, B, cdiv(s.Skv, C::BKV));
  tc::tc_bwd_dkdv_kernel<HD><<<grid, C::THREADS, smem, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv),
      G > 1 ? static_cast<float*>(part) : nullptr, s);
  e = cudaGetLastError();
  if (e != cudaSuccess || G == 1) return static_cast<int>(e);
  const long long n = static_cast<long long>(B) * s.Skv * s.Hkv * HD;
  const long long plane = static_cast<long long>(B) * s.Skv * s.Hq * HD;
  const long long blocks = std::min<long long>((n + 255) / 256, 132LL * 16);
  tc::tc_sum_heads_kernel<<<static_cast<unsigned int>(blocks), 256, 0, st>>>(
      static_cast<const float*>(part), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), n, plane, G, s.Hkv, HD);
  return static_cast<int>(cudaGetLastError());
}

// return f32 ? SIMT<float, hd>(args...) : TC<hd>(args...) for the
// (dtype, head_dim) of the call: f32 takes the SIMT kernels, bf16 the
// tensor-core kernels. WG_CASE is REPRO_FLASH_CASE, or REPRO_FLASH_F32_ONLY
// for a kernel whose bf16 call at head dims 64 and 128 takes
// flash_attention_sm90.cu's wgmma kernel instead (the forward and
// bwd_dkdv: kernels/flash_attention.py:ROUTES).
#define REPRO_FLASH_CASE(SIMT, TC, HD, ...)                                \
  case HD: return f32 ? SIMT<float, HD>(__VA_ARGS__) : TC<HD>(__VA_ARGS__);
#define REPRO_FLASH_F32_ONLY(SIMT, TC, HD, ...)                            \
  case HD:                                                                 \
    return f32 ? SIMT<float, HD>(__VA_ARGS__)                              \
               : static_cast<int>(cudaErrorInvalidValue);
#define REPRO_FLASH_DISPATCH(SIMT, TC, WG_CASE, ...)                       \
  do {                                                                     \
    if (dtype != kF32 && dtype != kBF16) {                                 \
      return static_cast<int>(cudaErrorInvalidValue);                      \
    }                                                                      \
    const bool f32 = dtype == kF32;                                        \
    switch (hd) {                                                          \
      REPRO_FLASH_CASE(SIMT, TC, 16, __VA_ARGS__)                          \
      REPRO_FLASH_CASE(SIMT, TC, 32, __VA_ARGS__)                          \
      WG_CASE(SIMT, TC, 64, __VA_ARGS__)                                   \
      REPRO_FLASH_CASE(SIMT, TC, 80, __VA_ARGS__)                          \
      WG_CASE(SIMT, TC, 128, __VA_ARGS__)                                  \
      REPRO_FLASH_CASE(SIMT, TC, 256, __VA_ARGS__)                         \
      default: return static_cast<int>(cudaErrorInvalidValue);             \
    }                                                                      \
  } while (0)

}  // namespace flash
}  // namespace repro

using namespace repro;
using namespace repro::flash;

extern "C" {

// Forward. out (B, Sq, Hq, hd) in q's type and lse (B, Sq, Hq) f32; out32
// (same shape as out, f32) is written when not null (bf16 inputs; for f32
// inputs out is the f32 output). Returns cudaGetLastError().
int repro_flash_fwd(const void* q, const void* k, const void* v, int dtype,
                    void* out, void* out32, void* lse, int B, int Sq,
                    int Skv, int Hq, int Hkv, int hd, int causal, int window,
                    float scale, void* stream) {
  if (bad_shape(B, Sq, Skv, Hq, Hkv)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Shape s = make_shape(Sq, Skv, Hq, Hkv, causal, window, scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  REPRO_FLASH_DISPATCH(launch_fwd, launch_tc_fwd, REPRO_FLASH_F32_ONLY, q, k,
                       v, out, out32, lse, B, s, st);
}

// Backward, first kernel: delta (B, Sq, Hq) f32 = D, and dq in q's type.
int repro_flash_bwd_dq(const void* q, const void* k, const void* v,
                       int dtype, const void* out32, const void* dout,
                       const void* lse, void* delta, void* dq, int B, int Sq,
                       int Skv, int Hq, int Hkv, int hd, int causal,
                       int window, float scale, void* stream) {
  if (bad_shape(B, Sq, Skv, Hq, Hkv)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Shape s = make_shape(Sq, Skv, Hq, Hkv, causal, window, scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  REPRO_FLASH_DISPATCH(launch_dq, launch_tc_dq, REPRO_FLASH_CASE, q, k, v,
                       out32, dout, lse, delta, dq, B, s, st);
}

// Backward, second kernel (after the first, which writes delta): dk and dv
// in k's type. part: f32 scratch (2, B, Skv, Hq, hd) for bf16 inputs with
// Hq > Hkv (the per-head partials), else unused and may be null.
int repro_flash_bwd_dkdv(const void* q, const void* k, const void* v,
                         int dtype, const void* dout, const void* lse,
                         const void* delta, void* dk, void* dv, void* part,
                         int B, int Sq, int Skv, int Hq, int Hkv, int hd,
                         int causal, int window, float scale, void* stream) {
  if (bad_shape(B, Sq, Skv, Hq, Hkv)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Shape s = make_shape(Sq, Skv, Hq, Hkv, causal, window, scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  REPRO_FLASH_DISPATCH(launch_dkdv, launch_tc_dkdv, REPRO_FLASH_F32_ONLY, q,
                       k, v, dout, lse, delta, dk, dv, part, B, s, st);
}

// Dynamic shared memory (bytes) of the mma.sync kernel `which` (0 the
// forward, 1 bwd_dq, 2 bwd_dkdv) at head dim hd, or -1 where it has no
// such instantiation.
int repro_flash_tc_smem(int which, int hd) {
  switch (hd) {
#define REPRO_FLASH_SMEM(HD)                                               \
  case HD:                                                                 \
    return which == 0   ? static_cast<int>(tc::fwd_smem<HD>())             \
           : which == 1 ? static_cast<int>(tc::dq_smem<HD>())              \
           : which == 2 ? static_cast<int>(tc::dkdv_smem<HD>())            \
                        : -1;
    REPRO_FLASH_SMEM(16)
    REPRO_FLASH_SMEM(32)
    REPRO_FLASH_SMEM(80)
    REPRO_FLASH_SMEM(256)
#undef REPRO_FLASH_SMEM
    case 64:
    case 128:
      return which == 1 ? static_cast<int>(hd == 64 ? tc::dq_smem<64>()
                                                    : tc::dq_smem<128>())
                        : -1;
    default: return -1;
  }
}

}  // extern "C"

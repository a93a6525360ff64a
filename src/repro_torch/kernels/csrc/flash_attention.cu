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
// What bounds it on this card: operations. The reference specifies f32
// arithmetic for both products (f32 operands, f32 accumulation), so the
// peak that applies is the f32 rate outside the tensor cores (67 TFLOP/s);
// at lm_350m's shapes (hd 64) a forward does 4 * hd = 256 FLOP per visible
// (q, k) pair against 4 * hd * 2 bytes of q/k/v/o per row, far above the
// card's FLOP-per-byte balance.
//
// What the design does about it: the (Sq, Skv) scores never reach device
// memory. Each block owns a 64-row tile and keeps its operand tiles in
// shared memory as f32, transposed ([d][row], rows padded to 68 floats so a
// thread reads four consecutive rows with one 16-byte load and stores hit
// four banks apart); each of the 256 threads owns a 4 x 4 piece of the
// 64 x 64 score tile, so one pair of 16-byte shared loads feeds 16 FMAs.
// A row's 64 scores live in the 16 lanes of one half-warp, so row max and
// row sum are shuffles. Tiles that the causal or window rule hides entirely
// are skipped with the reference's test applied to these tiles, and causal
// blocks are launched heaviest first. The backward recomputes p from L and
// is deterministic (no atomics): one kernel computes D and dq per q tile
// (looping over kv tiles), one computes dk and dv per kv tile (looping over
// the G query heads and their q tiles). Not done yet: tensor cores (mma/
// wgmma with an f32-exact split), TMA and pipelined loads.
#include "common.cuh"

namespace repro {
namespace flash {

constexpr int kTile = 64;            // rows of a q tile and of a kv tile
constexpr int kThreads = 256;        // 16 x 16; thread (tx, ty) owns rows
                                     // 4ty..4ty+3 x cols 4tx..4tx+3
constexpr int kStride = kTile + 4;   // row stride of a transposed tile
constexpr float kNegInf = -1e30f;    // the reference's NEG_INF

struct Shape {
  int Sq, Skv, Hq, Hkv, causal, window;
  float scale;
};

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

// The reference's block-pair test (flash_attention.py:58-65) on these tiles.
__device__ __forceinline__ bool tile_visible(const Shape& s, int q0, int k0) {
  if (s.causal && k0 > q0 + kTile - 1) return false;
  if (s.window > 0 && k0 + kTile - 1 <= q0 - s.window) return false;
  return true;
}

// The reference's element mask (flash_attention.py:76-83).
__device__ __forceinline__ bool pair_visible(const Shape& s, int qp, int kp) {
  bool ok = kp < s.Skv;
  if (s.causal) ok = ok && kp <= qp;
  if (s.window > 0) ok = ok && kp > qp - s.window;
  return ok;
}

// dst[d * kStride + r] = f32(src[r * row_stride + d]) for r < rows, else 0.
template <typename T, int HD>
__device__ __forceinline__ void load_transposed(float* dst, const T* src,
                                                long long row_stride,
                                                int rows) {
  for (int e = threadIdx.x; e < kTile * HD; e += kThreads) {
    const int r = e / HD, d = e - (e / HD) * HD;
    dst[d * kStride + r] = r < rows ? to_f32(src[r * row_stride + d]) : 0.0f;
  }
}

// dst[r * HD + d] = f32(src[r * row_stride + d]) for r < rows, else 0.
template <typename T, int HD>
__device__ __forceinline__ void load_rows(float* dst, const T* src,
                                          long long row_stride, int rows) {
  for (int e = threadIdx.x; e < kTile * HD; e += kThreads) {
    const int r = e / HD, d = e - (e / HD) * HD;
    dst[e] = r < rows ? to_f32(src[r * row_stride + d]) : 0.0f;
  }
}

__device__ __forceinline__ void unpack(const float* p, float v[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}

// acc[i][j] += sum_d A[d][ra + i] * Bt[d][cb + j] over two transposed tiles.
template <int HD>
__device__ __forceinline__ void tile_dot(float acc[4][4], const float* A,
                                         const float* Bt, int ra, int cb) {
#pragma unroll 4
  for (int d = 0; d < HD; ++d) {
    float a[4], b[4];
    unpack(A + d * kStride + ra, a);
    unpack(Bt + d * kStride + cb, b);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
}

// Stores a thread's 4 x 4 piece transposed: dst[(cb + j) * kStride + ra + i].
__device__ __forceinline__ void store_transposed(float* dst, const float x[4][4],
                                                 int ra, int cb) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    *reinterpret_cast<float4*>(dst + (cb + j) * kStride + ra) =
        make_float4(x[0][j], x[1][j], x[2][j], x[3][j]);
  }
}

// Max / sum over the 16 lanes of a half-warp (the 64 columns of a row).
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
// Qt, Kt [HD][kStride]; V [kTile][HD]; Pt [kTile][kStride] (p transposed).
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
           const T* __restrict__ v, T* __restrict__ out,
           float* __restrict__ out32, float* __restrict__ lse, Shape s) {
  constexpr int NC = HD / 16;  // output columns per thread: tx + 16 * c
  extern __shared__ __align__(16) float smem[];
  float* Qt = smem;
  float* Kt = Qt + HD * kStride;
  float* Vs = Kt + HD * kStride;
  float* Pt = Vs + kTile * HD;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int nq = (s.Sq + kTile - 1) / kTile;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.x)) * kTile;
  const int h = blockIdx.y, b = blockIdx.z, hk = h / (s.Hq / s.Hkv);
  const long long qs = static_cast<long long>(s.Hq) * HD;
  const long long ks = static_cast<long long>(s.Hkv) * HD;
  const long long qbase = (static_cast<long long>(b) * s.Sq + q0) * qs +
                          static_cast<long long>(h) * HD;
  const long long kbase = static_cast<long long>(b) * s.Skv * ks +
                          static_cast<long long>(hk) * HD;
  load_transposed<T, HD>(Qt, q + qbase, qs, min(kTile, s.Sq - q0));

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.0f;
  }
  for (int k0 = 0; k0 < s.Skv; k0 += kTile) {
    if (s.causal && k0 > q0 + kTile - 1) break;
    if (!tile_visible(s, q0, k0)) continue;
    __syncthreads();  // the previous tile's Kt, Vs and Pt are consumed
    const int rows = min(kTile, s.Skv - k0);
    load_transposed<T, HD>(Kt, k + kbase + k0 * ks, ks, rows);
    load_rows<T, HD>(Vs, v + kbase + k0 * ks, ks, rows);
    __syncthreads();
    float sc[4][4] = {};
    tile_dot<HD>(sc, Qt, Kt, 4 * ty, 4 * tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + 4 * ty + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float x = sc[i][j] * s.scale;
        sc[i][j] = pair_visible(s, qp, k0 + 4 * tx + j) ? x : kNegInf;
        mx = fmaxf(mx, sc[i][j]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      const float corr = expf(m[i] - m_new);
      float rs = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        sc[i][j] = expf(sc[i][j] - m_new);
        rs += sc[i][j];
      }
      l[i] = l[i] * corr + half_warp_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= corr;
    }
    store_transposed(Pt, sc, 4 * ty, 4 * tx);
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < kTile; ++c) {
      float p[4];
      unpack(Pt + c * kStride + 4 * ty, p);
#pragma unroll
      for (int cc = 0; cc < NC; ++cc) {
        const float vv = Vs[c * HD + tx + 16 * cc];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][cc] = fmaf(p[i], vv, acc[i][cc]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 4 * ty + i;
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
// Shared memory: Qt, dOt, Kt, Vt [HD][kStride]; dSt [kTile][kStride];
// L, D [kTile].
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const float* __restrict__ out32,
              const T* __restrict__ dout, const float* __restrict__ lse,
              float* __restrict__ delta, T* __restrict__ dq, Shape s) {
  constexpr int NC = HD / 16;
  extern __shared__ __align__(16) float smem[];
  float* Qt = smem;
  float* dOt = Qt + HD * kStride;
  float* Kt = dOt + HD * kStride;
  float* Vt = Kt + HD * kStride;
  float* dSt = Vt + HD * kStride;
  float* Ls = dSt + kTile * kStride;
  float* Ds = Ls + kTile;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nq = (s.Sq + kTile - 1) / kTile;
  const int q0 = (nq - 1 - static_cast<int>(blockIdx.x)) * kTile;
  const int h = blockIdx.y, b = blockIdx.z, hk = h / (s.Hq / s.Hkv);
  const long long qs = static_cast<long long>(s.Hq) * HD;
  const long long ks = static_cast<long long>(s.Hkv) * HD;
  const long long qbase = (static_cast<long long>(b) * s.Sq + q0) * qs +
                          static_cast<long long>(h) * HD;
  const long long kbase = static_cast<long long>(b) * s.Skv * ks +
                          static_cast<long long>(hk) * HD;
  const long long lbase = (static_cast<long long>(b) * s.Sq + q0) * s.Hq + h;
  const int rows_q = min(kTile, s.Sq - q0);
  load_transposed<T, HD>(Qt, q + qbase, qs, rows_q);
  load_transposed<T, HD>(dOt, dout + qbase, qs, rows_q);
  __syncthreads();
  // D = rowsum(f32(dout) * out_f32), one warp per row.
  for (int r = warp; r < kTile; r += kThreads / 32) {
    float part = 0.0f;
    if (r < rows_q) {
      for (int d = lane; d < HD; d += 32) {
        part = fmaf(dOt[d * kStride + r], out32[qbase + r * qs + d], part);
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

  float acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.0f;
  }
  for (int k0 = 0; k0 < s.Skv; k0 += kTile) {
    if (s.causal && k0 > q0 + kTile - 1) break;
    if (!tile_visible(s, q0, k0)) continue;
    __syncthreads();  // D and L written; the previous tile consumed
    const int rows = min(kTile, s.Skv - k0);
    load_transposed<T, HD>(Kt, k + kbase + k0 * ks, ks, rows);
    load_transposed<T, HD>(Vt, v + kbase + k0 * ks, ks, rows);
    __syncthreads();
    float sc[4][4] = {}, dp[4][4] = {};
    tile_dot<HD>(sc, Qt, Kt, 4 * ty, 4 * tx);
    tile_dot<HD>(dp, dOt, Vt, 4 * ty, 4 * tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = 4 * ty + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float x = sc[i][j] * s.scale;
        const float sv = pair_visible(s, q0 + r, k0 + 4 * tx + j) ? x : kNegInf;
        const float p = expf(sv - Ls[r]);
        sc[i][j] = p * (dp[i][j] - Ds[r]) * s.scale;
      }
    }
    store_transposed(dSt, sc, 4 * ty, 4 * tx);
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < kTile; ++c) {
      float a[4];
      unpack(dSt + c * kStride + 4 * ty, a);
#pragma unroll
      for (int cc = 0; cc < NC; ++cc) {
        const float kk = Kt[(tx + 16 * cc) * kStride + c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][cc] = fmaf(a[i], kk, acc[i][cc]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 4 * ty + i;
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
// 4ty..4ty+3 and q columns 4tx..4tx+3 of the transposed score tile.
// Shared memory: Kt, Vt, Qt, dOt [HD][kStride]; Ps, dSs [kTile q][kStride];
// L, D [kTile].
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta, T* __restrict__ dk,
                T* __restrict__ dv, Shape s) {
  constexpr int NC = HD / 16;
  extern __shared__ __align__(16) float smem[];
  float* Kt = smem;
  float* Vt = Kt + HD * kStride;
  float* Qt = Vt + HD * kStride;
  float* dOt = Qt + HD * kStride;
  float* Ps = dOt + HD * kStride;
  float* dSs = Ps + kTile * kStride;
  float* Ls = dSs + kTile * kStride;
  float* Ds = Ls + kTile;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int k0 = blockIdx.x * kTile;
  const int hk = blockIdx.y, b = blockIdx.z, G = s.Hq / s.Hkv;
  const long long qs = static_cast<long long>(s.Hq) * HD;
  const long long ks = static_cast<long long>(s.Hkv) * HD;
  const long long kbase = (static_cast<long long>(b) * s.Skv + k0) * ks +
                          static_cast<long long>(hk) * HD;
  const int rows_k = min(kTile, s.Skv - k0);
  load_transposed<T, HD>(Kt, k + kbase, ks, rows_k);
  load_transposed<T, HD>(Vt, v + kbase, ks, rows_k);

  float dka[4][NC], dva[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int c = 0; c < NC; ++c) dka[i][c] = dva[i][c] = 0.0f;
  }
  for (int g = 0; g < G; ++g) {
    const int h = hk * G + g;
    // causal: q tiles before k0 cannot see this kv tile
    for (int q0 = s.causal ? k0 : 0; q0 < s.Sq; q0 += kTile) {
      if (s.window > 0 && k0 + kTile - 1 <= q0 - s.window) break;
      if (!tile_visible(s, q0, k0)) continue;
      __syncthreads();  // the previous q tile is consumed
      const int rows_q = min(kTile, s.Sq - q0);
      const long long qbase = (static_cast<long long>(b) * s.Sq + q0) * qs +
                              static_cast<long long>(h) * HD;
      const long long lbase =
          (static_cast<long long>(b) * s.Sq + q0) * s.Hq + h;
      load_transposed<T, HD>(Qt, q + qbase, qs, rows_q);
      load_transposed<T, HD>(dOt, dout + qbase, qs, rows_q);
      for (int r = threadIdx.x; r < kTile; r += kThreads) {
        Ls[r] = r < rows_q ? lse[lbase + r * s.Hq] : 0.0f;
        Ds[r] = r < rows_q ? delta[lbase + r * s.Hq] : 0.0f;
      }
      __syncthreads();
      float sc[4][4] = {}, dp[4][4] = {};
      tile_dot<HD>(sc, Kt, Qt, 4 * ty, 4 * tx);
      tile_dot<HD>(dp, Vt, dOt, 4 * ty, 4 * tx);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kp = k0 + 4 * ty + i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = 4 * tx + j;
          const float x = sc[i][j] * s.scale;
          const float sv = pair_visible(s, q0 + r, kp) ? x : kNegInf;
          const float p = r < rows_q ? expf(sv - Ls[r]) : 0.0f;
          sc[i][j] = p;
          dp[i][j] = p * (dp[i][j] - Ds[r]) * s.scale;
        }
      }
      // sc[i][j] is p^T[kv 4ty+i][q 4tx+j]; stored as Ps[q][kv].
      store_transposed(Ps, sc, 4 * ty, 4 * tx);
      store_transposed(dSs, dp, 4 * ty, 4 * tx);
      __syncthreads();
#pragma unroll 2
      for (int r = 0; r < kTile; ++r) {
        float p[4], ds[4];
        unpack(Ps + r * kStride + 4 * ty, p);
        unpack(dSs + r * kStride + 4 * ty, ds);
#pragma unroll
        for (int cc = 0; cc < NC; ++cc) {
          const int d = tx + 16 * cc;
          const float o = dOt[d * kStride + r];
          const float qq = Qt[d * kStride + r];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            dva[i][cc] = fmaf(p[i], o, dva[i][cc]);
            dka[i][cc] = fmaf(ds[i], qq, dka[i][cc]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 4 * ty + i;
    if (r >= rows_k) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      dk[kbase + r * ks + tx + 16 * c] = from_f32<T>(dka[i][c]);
      dv[kbase + r * ks + tx + 16 * c] = from_f32<T>(dva[i][c]);
    }
  }
}

// ---------------------------------------------------------------------------
// Host side: shared memory per kernel, and dispatch over (dtype, head_dim).

template <int HD> constexpr size_t fwd_smem() {
  return sizeof(float) * (2 * HD * kStride + kTile * HD + kTile * kStride);
}
template <int HD> constexpr size_t dq_smem() {
  return sizeof(float) * (4 * HD * kStride + kTile * kStride + 2 * kTile);
}
template <int HD> constexpr size_t dkdv_smem() {
  return sizeof(float) * (4 * HD * kStride + 2 * kTile * kStride + 2 * kTile);
}

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
               void* out32, void* lse, dim3 grid, Shape s, cudaStream_t st) {
  const cudaError_t e = allow_smem(fwd_kernel<T, HD>, fwd_smem<HD>());
  if (e != cudaSuccess) return static_cast<int>(e);
  fwd_kernel<T, HD><<<grid, kThreads, fwd_smem<HD>(), st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out),
      static_cast<float*>(out32), static_cast<float*>(lse), s);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int HD>
int launch_dq(const void* q, const void* k, const void* v, const void* out32,
              const void* dout, const void* lse, void* delta, void* dq,
              dim3 grid, Shape s, cudaStream_t st) {
  const cudaError_t e = allow_smem(bwd_dq_kernel<T, HD>, dq_smem<HD>());
  if (e != cudaSuccess) return static_cast<int>(e);
  bwd_dq_kernel<T, HD><<<grid, kThreads, dq_smem<HD>(), st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(out32),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<float*>(delta), static_cast<T*>(dq), s);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int HD>
int launch_dkdv(const void* q, const void* k, const void* v, const void* dout,
                const void* lse, const void* delta, void* dk, void* dv,
                dim3 grid, Shape s, cudaStream_t st) {
  const cudaError_t e = allow_smem(bwd_dkdv_kernel<T, HD>, dkdv_smem<HD>());
  if (e != cudaSuccess) return static_cast<int>(e);
  bwd_dkdv_kernel<T, HD><<<grid, kThreads, dkdv_smem<HD>(), st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), s);
  return static_cast<int>(cudaGetLastError());
}

// return LAUNCH<T, hd>(args...) for the (dtype, head_dim) of the call.
#define REPRO_FLASH_DISPATCH(LAUNCH, ...)                                  \
  do {                                                                     \
    if (dtype != kF32 && dtype != kBF16) {                                 \
      return static_cast<int>(cudaErrorInvalidValue);                      \
    }                                                                      \
    const bool f32 = dtype == kF32;                                        \
    switch (hd) {                                                          \
      case 16: return f32 ? LAUNCH<float, 16>(__VA_ARGS__)                 \
                          : LAUNCH<__nv_bfloat16, 16>(__VA_ARGS__);        \
      case 32: return f32 ? LAUNCH<float, 32>(__VA_ARGS__)                 \
                          : LAUNCH<__nv_bfloat16, 32>(__VA_ARGS__);        \
      case 64: return f32 ? LAUNCH<float, 64>(__VA_ARGS__)                 \
                          : LAUNCH<__nv_bfloat16, 64>(__VA_ARGS__);        \
      case 80: return f32 ? LAUNCH<float, 80>(__VA_ARGS__)                 \
                          : LAUNCH<__nv_bfloat16, 80>(__VA_ARGS__);        \
      case 128: return f32 ? LAUNCH<float, 128>(__VA_ARGS__)               \
                           : LAUNCH<__nv_bfloat16, 128>(__VA_ARGS__);      \
      default: return static_cast<int>(cudaErrorInvalidValue);             \
    }                                                                      \
  } while (0)

inline Shape make_shape(int Sq, int Skv, int Hq, int Hkv, int causal,
                        int window, float scale) {
  Shape s;
  s.Sq = Sq; s.Skv = Skv; s.Hq = Hq; s.Hkv = Hkv;
  s.causal = causal; s.window = window; s.scale = scale;
  return s;
}

inline bool bad_shape(int B, int Sq, int Skv, int Hq, int Hkv) {
  return B <= 0 || Sq <= 0 || Skv <= 0 || Hkv <= 0 || Hq % Hkv != 0 ||
         B > 65535 || Hq > 65535;
}

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
  const dim3 grid((Sq + kTile - 1) / kTile, Hq, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  REPRO_FLASH_DISPATCH(launch_fwd, q, k, v, out, out32, lse, grid, s, st);
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
  const dim3 grid((Sq + kTile - 1) / kTile, Hq, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  REPRO_FLASH_DISPATCH(launch_dq, q, k, v, out32, dout, lse, delta, dq, grid,
                       s, st);
}

// Backward, second kernel (after the first, which writes delta): dk and dv
// in k's type.
int repro_flash_bwd_dkdv(const void* q, const void* k, const void* v,
                         int dtype, const void* dout, const void* lse,
                         const void* delta, void* dk, void* dv, int B,
                         int Sq, int Skv, int Hq, int Hkv, int hd, int causal,
                         int window, float scale, void* stream) {
  if (bad_shape(B, Sq, Skv, Hq, Hkv)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Shape s = make_shape(Sq, Skv, Hq, Hkv, causal, window, scale);
  const dim3 grid((Skv + kTile - 1) / kTile, Hkv, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  REPRO_FLASH_DISPATCH(launch_dkdv, q, k, v, dout, lse, delta, dk, dv, grid,
                       s, st);
}

}  // extern "C"

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
// memory. Each block owns a tile of TILE rows (64, or 32 at head dim 256,
// where four 64-row f32 operand tiles would not fit in shared memory) and
// keeps its operand tiles in shared memory as f32, transposed ([d][row],
// rows padded to TILE + 4 floats so a thread reads its R = TILE / 16
// consecutive rows with one 16- or 8-byte load and stores hit four banks
// apart); each of the 256 threads owns an R x R piece of the TILE x TILE
// score tile, so one pair of shared loads feeds R * R FMAs.
// A row's TILE scores live in the 16 lanes of one half-warp, so row max and
// row sum are shuffles. Tiles that the causal or window rule hides entirely
// are skipped with the reference's test applied to these tiles, and causal
// blocks are launched heaviest first. The backward recomputes p from L and
// is deterministic (no atomics): one kernel computes D and dq per q tile
// (looping over kv tiles), one computes dk and dv per kv tile (looping over
// the G query heads and their q tiles). At head dim 256 the forward keeps
// 64-row tiles (217 KiB of shared memory) and the two backward kernels take
// 32-row tiles (149 and 153 KiB). Not done yet: tensor cores (mma/wgmma with
// an f32-exact split), TMA and pipelined loads.
#include "common.cuh"


namespace repro {
namespace flash {

constexpr int kThreads = 256;        // 16 x 16; thread (tx, ty) owns rows
                                     // R*ty..R*ty+R-1 x cols R*tx..R*tx+R-1
constexpr float kNegInf = -1e30f;    // the reference's NEG_INF

// Rows of a tile: 64, or 32 where 64-row f32 tiles would not fit in shared
// memory (the backward kernels at head dim 256). The forward keeps 64.
template <int HD> constexpr int bwd_tile() { return HD > 128 ? 32 : 64; }
constexpr int kFwdTile = 64;

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
template <int TILE>
__device__ __forceinline__ bool tile_visible(const Shape& s, int q0, int k0) {
  if (s.causal && k0 > q0 + TILE - 1) return false;
  if (s.window > 0 && k0 + TILE - 1 <= q0 - s.window) return false;
  return true;
}

// The reference's element mask (flash_attention.py:76-83).
__device__ __forceinline__ bool pair_visible(const Shape& s, int qp, int kp) {
  bool ok = kp < s.Skv;
  if (s.causal) ok = ok && kp <= qp;
  if (s.window > 0) ok = ok && kp > qp - s.window;
  return ok;
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

// Above 48 KB a kernel takes dynamic shared memory only after this call;
// without it the launch is refused (reported by cudaGetLastError).
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

inline int tiles(int n, int tile) { return (n + tile - 1) / tile; }

template <typename T, int HD>
int launch_fwd(const void* q, const void* k, const void* v, void* out,
               void* out32, void* lse, int B, Shape s, cudaStream_t st) {
  constexpr int TILE = kFwdTile;
  constexpr size_t smem = fwd_smem<HD, TILE>();
  const cudaError_t e = allow_smem(fwd_kernel<T, HD, TILE>, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(tiles(s.Sq, TILE), s.Hq, B);
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
  const dim3 grid(tiles(s.Sq, TILE), s.Hq, B);
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
                int B, Shape s, cudaStream_t st) {
  constexpr int TILE = bwd_tile<HD>();
  constexpr size_t smem = dkdv_smem<HD, TILE>();
  const cudaError_t e = allow_smem(bwd_dkdv_kernel<T, HD, TILE>, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(tiles(s.Skv, TILE), s.Hkv, B);
  bwd_dkdv_kernel<T, HD, TILE><<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), s);
  return static_cast<int>(cudaGetLastError());
}

// return LAUNCH<T, hd>(args...) for the (dtype, head_dim) of the call.
#define REPRO_FLASH_CASE(LAUNCH, HD, ...)                                  \
  case HD: return f32 ? LAUNCH<float, HD>(__VA_ARGS__)                     \
                      : LAUNCH<__nv_bfloat16, HD>(__VA_ARGS__);
#define REPRO_FLASH_DISPATCH(LAUNCH, ...)                                  \
  do {                                                                     \
    if (dtype != kF32 && dtype != kBF16) {                                 \
      return static_cast<int>(cudaErrorInvalidValue);                      \
    }                                                                      \
    const bool f32 = dtype == kF32;                                        \
    switch (hd) {                                                          \
      REPRO_FLASH_CASE(LAUNCH, 16, __VA_ARGS__)                            \
      REPRO_FLASH_CASE(LAUNCH, 32, __VA_ARGS__)                            \
      REPRO_FLASH_CASE(LAUNCH, 64, __VA_ARGS__)                            \
      REPRO_FLASH_CASE(LAUNCH, 80, __VA_ARGS__)                            \
      REPRO_FLASH_CASE(LAUNCH, 128, __VA_ARGS__)                           \
      REPRO_FLASH_CASE(LAUNCH, 256, __VA_ARGS__)                           \
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  REPRO_FLASH_DISPATCH(launch_fwd, q, k, v, out, out32, lse, B, s, st);
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
  REPRO_FLASH_DISPATCH(launch_dq, q, k, v, out32, dout, lse, delta, dq, B, s,
                       st);
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  REPRO_FLASH_DISPATCH(launch_dkdv, q, k, v, dout, lse, delta, dk, dv, B, s,
                       st);
}

}  // extern "C"

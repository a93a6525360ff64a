// The RWKV-6 WKV recurrence (K5), forward and backward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/wkv6.py:wkv6
// (_wkv_kernel), which walks 64-step chunks of one (batch, head) in order
// and carries the N x N f32 state S in VMEM. The reference model
// differentiates its chunked jnp form (models/rwkv.py:chunked_wkv) with
// XLA, so there is no TPU backward to copy: the backward here is the
// chunked reverse pass of kernels/ref.py:wkv6_bwd_ref.
//
// Contract: r, k, v, logw (B, S, H, N) f32, u (H, N) f32, contiguous,
// N in {16, 32, 64}, any S (the ragged last chunk is masked here):
//   o_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T),
//   S_t = diag(exp(logw_t)) S_{t-1} + k_t v_t^T,   S_{-1} = 0.
// The forward writes o and the state entering each chunk, states
// (B, H, ceil(S / 64), N, N); the backward reads them and writes dr, dk,
// dv, dlogw and du (H, N).
//
// Chunked form. With lcw_i = sum_{t <= i} logw_t inside a chunk (lcw_{-1} =
// 0), every exponent is a difference that is <= 0:
//   o_i = (r_i * e^{lcw_{i-1}}) S_0 + sum_{j<i} A_ij v_j + (r_i . (u * k_i)) v_i,
//   A_ij = sum_n r_in k_jn e^{lcw_{i-1,n} - lcw_{j,n}},
//   S_C = e^{lcw_last} S_0 + sum_j (k_j * e^{lcw_last - lcw_j}) v_j^T.
// The reference's chunked_wkv and the Pallas kernel factor the pair decay
// as (r_i e^{lcw_{i-1}}) (k_j e^{-lcw_j}); e^{-lcw_j} overflows f32 once
// -lcw passes 88.7 inside a chunk, which the model's own decays reach. Here
// nothing computes e^{-lcw} on its own: the C x C x N pair exponentials are
// evaluated one by one. lcw is summed in f64 (in log2 units) and kept as
// two f32 words, hi + lo; a difference is (hi_a - hi_b) + (lo_a - lo_b),
// one f32 rounding of the result, then exp2f. An f32 sum would not do:
// lcw reaches a few thousand within a chunk under the model's strongest
// decays, and a difference of two such sums carries their rounding, about
// 1e-4 of relative error in the exponential, the whole tolerance.
//
// Backward. With dS_c = dL/dS at the end of chunk c (0 after the last),
// dA_ij = do_i . v_j and dd_i = do_i . v_i:
//   dS_{c-1} = e^{lcw_last} dS_c + sum_i (r_i e^{lcw_{i-1}}) do_i^T
//   dr'_i = e^{lcw_{i-1}} * (S_c do_i) + sum_{j<i} dA_ij k_j e^{lcw_{i-1} - lcw_j}
//   dk'_j = sum_{i>j} dA_ij r_i e^{lcw_{i-1} - lcw_j} + e^{lcw_last - lcw_j} * (dS_c v_j)
//   dr = dr' + u k dd,  dk = dk' + u r dd,
//   dv_j = sum_{i>j} A_ij do_i + (r_j . (u * k_j)) do_j + dS_c^T (k_j e^{lcw_last - lcw_j})
//   du = sum over batch and chunks of sum_i r_i k_i dd_i, in a fixed order
//        (over chunks per (b, h), then over b): no atomics.
// dlogw from the identity dL/dlcw_m = r_{m+1} dr'_{m+1} - k_m dk'_m (+ the
// state term at the chunk's last step), summed over m >= t inside the chunk:
//   dlogw_t = sum_{i>t} r_i dr'_i - sum_{j>=t} k_j dk'_j + rowsum(S_{c+1} * dS_c).
// The sums stop at the chunk's end, so the difference is of at most 64
// terms (applied over the whole sequence it would be a difference of two
// sums over 4,096 positions), and S_{c+1} is the state the forward saved for
// the next chunk. Per-step states rebuilt inside each chunk would give the
// same thing at N^2 extra work per step.
//
// What bounds it on this card: operations. The function's bytes (r, k, v,
// logw and u read once, o written once) are 209.7 MB at (1, 4096, 40, 64),
// 62.6 us at 3.35 TB/s; the chunk states add 41.9 MB of writes that only
// this design needs. The pair exponentials alone are 3.4e8 a pass, each
// on the SM's special-function unit (16 a clock per SM), beside the
// ~4 GFLOP of f32 products.
//
// What the design does about it (simple first): all pair work is per
// chunk, in parallel; only the state recursions run over chunks in order.
// Four kernels:
//   forward:  chunk_fwd_kernel (grid (chunks, H, B): the intra-chunk output,
//             r e^{lcw_{i-1}}, each chunk's own state contribution and its
//             decay), then state_fwd_kernel (grid (N / 16, H, B), chunks in
//             order: S_c, and the output's inter-chunk part);
//   backward: dstate_kernel (grid (N / 16, H, B), chunks in reverse: dS_c
//             for every chunk, its own cumulative sum and r e^{lcw_{i-1}};
//             the blocks of column block 0 also sum du over their chunks),
//             then grad_kernel (grid (chunks, H, B): every gradient of each
//             chunk from S_c, S_{c+1} and dS_c; and du's sum over b).
// (A backward whose sequential kernel also applied the dS terms, so that
// the chunk kernel could run first, took 6.27 ms at (1, 4096, 40, 64) on an
// H100 80GB HBM3 at 700 W, against 4.88 ms for this one: its C x N x N
// products per chunk ran on B x H = 40 blocks.)
// At (1, 4096, 40, 64) the chunk kernels run 2,560 blocks of 512 threads.
// Shared arrays that a warp reads down a column are padded to N + 1 words a
// row, so the 32 reads hit 32 banks. Not done yet: tensor cores for the
// products, and a secondary chunking that turns most pair exponentials into
// products of two factors <= 1.
#include "common.cuh"

namespace repro {
namespace wkv {

constexpr int kChunk = 64;
constexpr int kThreads = 512;
constexpr int kPairs = kChunk * (kChunk + 1) / 2;  // (i, j) with j <= i
constexpr int kValCols = 16;  // columns of S per block of the state passes

template <int N>
__host__ __device__ constexpr int vcols() { return N < kValCols ? N : kValCols; }

__device__ __forceinline__ long long at(int b, int t, int h, int S, int H,
                                        int N) {
  return ((static_cast<long long>(b) * S + t) * H + h) * N;
}

// Rows [t0, t0 + kChunk) of head h of x (B, S, H, N), columns [c0, c0 +
// W), into sh with row stride ld; zero past S.
__device__ __forceinline__ void load_rows(float* sh, int ld, const float* x,
                                          int b, int h, int t0, int S, int H,
                                          int N, int c0, int W) {
  for (int idx = threadIdx.x; idx < kChunk * W; idx += blockDim.x) {
    const int i = idx / W, c = idx % W;
    const int t = t0 + i;
    sh[i * ld + c] = t < S ? x[at(b, t, h, S, H, N) + c0 + c] : 0.0f;
  }
}

// The cumulative log-decay of a chunk in log2 units, summed in f64 and kept
// as two f32 words: lcw_i = sum_{t <= i} lw_t * log2(e) = hi + lo.
struct Lcw {
  float* hi;
  float* lo;
};

constexpr double kLog2e = 1.4426950408889634;

// Fills lcw from lw (kChunk x N, zero past S).
template <int N>
__device__ __forceinline__ void cumsum(Lcw lcw, const float* lw) {
  if (threadIdx.x < N) {
    const int n = threadIdx.x;
    double acc = 0.0;
    for (int i = 0; i < kChunk; ++i) {
      acc += static_cast<double>(lw[i * N + n]) * kLog2e;
      const float hi = static_cast<float>(acc);
      lcw.hi[i * (N + 1) + n] = hi;
      lcw.lo[i * (N + 1) + n] = static_cast<float>(acc - static_cast<double>(hi));
    }
  }
}

// 2^{(lcw_a - lcw_b)} from the two words of each: the hi difference is one
// f32 rounding of the result (relative 6e-8), where a difference of two
// rounded sums would carry their rounding (up to ~1e-4 once |lcw| is in
// the thousands).
template <int N>
__device__ __forceinline__ float decay(Lcw lcw, int a, int b, int n) {
  constexpr int P = N + 1;
  const float ha = a >= 0 ? lcw.hi[a * P + n] : 0.0f;
  const float la = a >= 0 ? lcw.lo[a * P + n] : 0.0f;
  const float hb = b >= 0 ? lcw.hi[b * P + n] : 0.0f;
  const float lb = b >= 0 ? lcw.lo[b * P + n] : 0.0f;
  return exp2f((ha - hb) + (la - lb));
}

// e^{lcw_{i-1,n} - lcw_{j,n}} (<= 1 for 0 <= j < i).
template <int N>
__device__ __forceinline__ float pair_decay(Lcw lcw, int i, int j, int n) {
  constexpr int P = N + 1;
  const int a = (i - 1) * P + n, b = j * P + n;
  return exp2f((lcw.hi[a] - lcw.hi[b]) + (lcw.lo[a] - lcw.lo[b]));
}

// The p-th pair (i, j) with j <= i, row by row.
__device__ __forceinline__ void pair_of(int p, int& i, int& j) {
  i = static_cast<int>((sqrtf(8.0f * p + 1.0f) - 1.0f) * 0.5f);
  if ((i + 1) * (i + 2) / 2 <= p) ++i;
  if (i * (i + 1) / 2 > p) --i;
  j = p - i * (i + 1) / 2;
}

// sum_n a[n] b[n] e^{lcw_{i-1,n} - lcw_{j,n}} (j < i), in four partial
// sums so that consecutive terms do not wait on each other.
template <int N>
__device__ __forceinline__ float decayed_dot(const float* a, const float* b,
                                             Lcw lcw, int i, int j) {
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll 4
  for (int n = 0; n < N; ++n) {
    acc[n % 4] += a[n] * b[n] * pair_decay<N>(lcw, i, j, n);
  }
  return (acc[0] + acc[1]) + (acc[2] + acc[3]);
}

// e^{lcw_{i-1,n}}: the decay from the chunk's start to step i.
template <int N>
__device__ __forceinline__ float decay_from_start(Lcw lcw, int i, int n) {
  return decay<N>(lcw, i - 1, -1, n);
}

// e^{lcw_last,n - lcw_{j,n}}: the decay from step j to the chunk's end
// (j = -1: the whole chunk).
template <int N>
__device__ __forceinline__ float decay_to_end(Lcw lcw, int j, int n) {
  return decay<N>(lcw, kChunk - 1, j, n);
}


// Rows [0, N) x columns [c0, c0 + W) of an N x N matrix m into sh (row
// stride ld), or from sh into m (store).
__device__ __forceinline__ void load_square(float* sh, int ld, const float* m,
                                            int N, int c0, int W) {
  for (int idx = threadIdx.x; idx < N * W; idx += blockDim.x) {
    sh[(idx / W) * ld + idx % W] = m[(idx / W) * N + c0 + idx % W];
  }
}

__device__ __forceinline__ void store_square(float* m, const float* sh,
                                             int ld, int N, int c0, int W) {
  for (int idx = threadIdx.x; idx < N * W; idx += blockDim.x) {
    m[(idx / W) * N + c0 + idx % W] = sh[(idx / W) * ld + idx % W];
  }
}

__device__ __forceinline__ long long chunk_mat(int b, int h, int c, int H,
                                               int nc, int N) {
  return ((static_cast<long long>(b) * H + h) * nc + c) * N * N;
}

__device__ __forceinline__ long long chunk_vec(int b, int h, int c, int H,
                                               int nc, int N) {
  return ((static_cast<long long>(b) * H + h) * nc + c) * N;
}

// ---------------------------------------------------------------- forward

template <int N>
constexpr size_t chunk_fwd_smem() {
  constexpr int P = N + 1;
  return sizeof(float) * (3 * kChunk * P + 2 * kChunk * N + kChunk * kChunk);
}

// Everything of one chunk that does not need the state entering it: the
// intra-chunk output sum_{j<=i} A_ij v_j (A_ii the bonus) into out,
// r_i e^{lcw_{i-1}} into rdec, the chunk's own state contribution
// sum_j (k_j e^{lcw_last - lcw_j}) v_j^T into states[c] and e^{lcw_last}
// into dvec[c]. Grid (ceil(S / 64), H, B): every chunk in parallel.
template <int N>
__global__ void __launch_bounds__(kThreads)
chunk_fwd_kernel(const float* __restrict__ r, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ lw,
                 const float* __restrict__ u, float* __restrict__ out,
                 float* __restrict__ rdec, float* __restrict__ states,
                 float* __restrict__ dvec, int S, int H) {
  constexpr int P = N + 1;
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int t0 = c * kChunk, nc = gridDim.x;
  extern __shared__ float smem[];
  const Lcw lcw{smem, smem + kChunk * P};  // kChunk x P each
  float* sk = smem + 2 * kChunk * P;       // kChunk x P: k, then k e^{lcw_last - lcw_j}
  float* sr = sk + kChunk * P;             // kChunk x N
  float* sv = sr + kChunk * N;             // kChunk x N
  float* sA = sv + kChunk * N;             // kChunk x kChunk (logw first)
  load_rows(sr, N, r, b, h, t0, S, H, N, 0, N);
  load_rows(sk, P, k, b, h, t0, S, H, N, 0, N);
  load_rows(sv, N, v, b, h, t0, S, H, N, 0, N);
  load_rows(sA, N, lw, b, h, t0, S, H, N, 0, N);
  __syncthreads();
  cumsum<N>(lcw, sA);
  __syncthreads();
  // scores A_ij (j < i) and the bonus r_i . (u * k_i) on the diagonal
  for (int p = threadIdx.x; p < kPairs; p += blockDim.x) {
    int i, j;
    pair_of(p, i, j);
    float a = 0.0f;
    if (j < i) {
      a = decayed_dot<N>(sr + i * N, sk + j * P, lcw, i, j);
    } else {
      for (int n = 0; n < N; ++n) {
        a += sr[i * N + n] * __ldg(u + h * N + n) * sk[i * P + n];
      }
    }
    sA[i * kChunk + j] = a;
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < kChunk * N; idx += blockDim.x) {
    const int i = idx / N, col = idx % N;  // col: a value column, and a channel
    const int t = t0 + i;
    if (t < S) {
      float o = 0.0f;
      for (int j = 0; j <= i; ++j) o += sA[i * kChunk + j] * sv[j * N + col];
      const long long at_t = at(b, t, h, S, H, N) + col;
      out[at_t] = o;
      rdec[at_t] = sr[idx] * decay_from_start<N>(lcw, i, col);
    }
    sk[i * P + col] *= decay_to_end<N>(lcw, i, col);
  }
  __syncthreads();
  float* dst = states + chunk_mat(b, h, c, H, nc, N);
  for (int idx = threadIdx.x; idx < N * N; idx += blockDim.x) {
    const int n = idx / N, col = idx % N;
    float s = 0.0f;
    for (int j = 0; j < kChunk; ++j) s += sk[j * P + n] * sv[j * N + col];
    dst[idx] = s;
  }
  if (threadIdx.x < N) {
    dvec[chunk_vec(b, h, c, H, nc, N) + threadIdx.x] =
        decay_to_end<N>(lcw, -1, threadIdx.x);
  }
}

template <int N>
constexpr size_t state_fwd_smem() {
  constexpr int V = vcols<N>();
  return sizeof(float) * (kChunk * N + 2 * N * V + N);
}

// The state recursion S_{c+1} = e^{lcw_last} S_c + dS_c (dS_c the chunk's
// own contribution, read from states[c], which then gets S_c), and the
// output's inter-chunk part, out_i += (r_i e^{lcw_{i-1}}) S_c. No pair
// exponentials and no cumulative sums: N^2 (V columns) a step. Grid (N / V,
// H, B): one (b, h) and V value columns of S per block, chunks in order.
template <int N>
__global__ void __launch_bounds__(kThreads)
state_fwd_kernel(const float* __restrict__ rdec, const float* __restrict__ dvec,
                 float* __restrict__ states, float* __restrict__ out, int S,
                 int H) {
  constexpr int V = vcols<N>();
  const int c0 = blockIdx.x * V, h = blockIdx.y, b = blockIdx.z;
  extern __shared__ float smem[];
  float* sR = smem;               // kChunk x N: r e^{lcw_{i-1}}
  float* sS = sR + kChunk * N;    // N x V: S_c
  float* sD = sS + N * V;         // N x V: the chunk's own contribution
  float* sdv = sD + N * V;        // N: e^{lcw_last}
  for (int idx = threadIdx.x; idx < N * V; idx += blockDim.x) sS[idx] = 0.0f;
  const int nc = (S + kChunk - 1) / kChunk;
  for (int c = 0; c < nc; ++c) {
    const int t0 = c * kChunk;
    float* st = states + chunk_mat(b, h, c, H, nc, N);
    __syncthreads();  // the previous chunk's update is done
    load_rows(sR, N, rdec, b, h, t0, S, H, N, 0, N);
    load_square(sD, V, st, N, c0, V);
    for (int n = threadIdx.x; n < N; n += blockDim.x) {
      sdv[n] = dvec[chunk_vec(b, h, c, H, nc, N) + n];
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < kChunk * V; idx += blockDim.x) {
      const int i = idx / V, col = idx % V;
      const int t = t0 + i;
      if (t >= S) continue;
      float o = 0.0f;
      for (int n = 0; n < N; ++n) o += sR[i * N + n] * sS[n * V + col];
      out[at(b, t, h, S, H, N) + c0 + col] += o;
    }
    store_square(st, sS, V, N, c0, V);
    __syncthreads();  // out and states have read S_c
    for (int idx = threadIdx.x; idx < N * V; idx += blockDim.x) {
      sS[idx] = sdv[idx / V] * sS[idx] + sD[idx];
    }
  }
}

// --------------------------------------------------------------- backward

template <int N>
constexpr size_t dstate_smem() {
  constexpr int P = N + 1, V = vcols<N>();
  return sizeof(float) * (2 * kChunk * P + 5 * kChunk * N + kChunk + N * V);
}

// The reverse state recursion, dS_{c-1} = e^{lcw_last} dS_c + sum_i (r_i
// e^{lcw_{i-1}}) do_i^T, writing dS_c (dL/dS at chunk c's end) to dstates[c];
// the blocks of column block 0 also sum du over their chunks, in order, into
// du_part[b][h]. Grid (N / V, H, B), chunks in reverse.
template <int N>
__global__ void __launch_bounds__(kThreads)
dstate_kernel(const float* __restrict__ r, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ lw,
              const float* __restrict__ dout, float* __restrict__ dstates,
              float* __restrict__ du_part, int S, int H) {
  constexpr int P = N + 1, V = vcols<N>();
  const int c0 = blockIdx.x * V, h = blockIdx.y, b = blockIdx.z;
  const bool with_du = blockIdx.x == 0;
  extern __shared__ float smem[];
  const Lcw lcw{smem, smem + kChunk * P};  // kChunk x P each
  float* sr = smem + 2 * kChunk * P;       // kChunk x N: r, then r e^{lcw_{i-1}}
  float* slw = sr + kChunk * N;            // kChunk x N
  float* sdo = slw + kChunk * N;           // kChunk x N
  float* sk = sdo + kChunk * N;            // kChunk x N (column block 0)
  float* sv = sk + kChunk * N;             // kChunk x N (column block 0)
  float* sdd = sv + kChunk * N;            // kChunk: do_i . v_i
  float* sdS = sdd + kChunk;               // N x V
  for (int idx = threadIdx.x; idx < N * V; idx += blockDim.x) sdS[idx] = 0.0f;
  float du_acc = 0.0f;  // thread n < N of column block 0
  const int nc = (S + kChunk - 1) / kChunk;
  for (int c = nc - 1; c >= 0; --c) {
    const int t0 = c * kChunk;
    __syncthreads();
    store_square(dstates + chunk_mat(b, h, c, H, nc, N), sdS, V, N, c0, V);
    load_rows(sr, N, r, b, h, t0, S, H, N, 0, N);
    load_rows(slw, N, lw, b, h, t0, S, H, N, 0, N);
    load_rows(sdo, N, dout, b, h, t0, S, H, N, 0, N);
    if (with_du) {
      load_rows(sk, N, k, b, h, t0, S, H, N, 0, N);
      load_rows(sv, N, v, b, h, t0, S, H, N, 0, N);
    }
    __syncthreads();
    cumsum<N>(lcw, slw);
    if (with_du) {
      for (int i = threadIdx.x; i < kChunk; i += blockDim.x) {
        float dd = 0.0f;
        for (int n = 0; n < N; ++n) dd += sdo[i * N + n] * sv[i * N + n];
        sdd[i] = dd;
      }
    }
    __syncthreads();
    if (with_du && threadIdx.x < N) {
      const int n = threadIdx.x;
      for (int i = 0; i < kChunk; ++i) {
        du_acc += sr[i * N + n] * sk[i * N + n] * sdd[i];
      }
    }
    __syncthreads();  // du has read r
    for (int idx = threadIdx.x; idx < kChunk * N; idx += blockDim.x) {
      sr[idx] *= decay_from_start<N>(lcw, idx / N, idx % N);
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < N * V; idx += blockDim.x) {
      const int n = idx / V, col = idx % V;
      float g = decay_to_end<N>(lcw, -1, n) * sdS[idx];
      for (int i = 0; i < kChunk; ++i) g += sr[i * N + n] * sdo[i * N + c0 + col];
      sdS[idx] = g;
    }
  }
  if (with_du && threadIdx.x < N) {
    du_part[(static_cast<long long>(b) * H + h) * N + threadIdx.x] = du_acc;
  }
}

template <int N>
constexpr size_t grad_smem() {
  constexpr int P = N + 1;
  return sizeof(float) * (8 * kChunk * P + 2 * kChunk * kChunk + 2 * N * P);
}

// The gradients of one chunk, given the state entering it (states[c]), the
// state entering the next (states[c + 1]) and dL/dS at its end
// (dstates[c]). Grid (ceil(S / 64), H, B): the chunks in parallel. Block
// (0, h, 0) also writes du[h] = sum_b du_part[b][h], b in order.
template <int N>
__global__ void __launch_bounds__(kThreads)
grad_kernel(const float* __restrict__ r, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ lw,
            const float* __restrict__ u, const float* __restrict__ states,
            const float* __restrict__ dstates, const float* __restrict__ dout,
            const float* __restrict__ du_part, float* __restrict__ dr,
            float* __restrict__ dk, float* __restrict__ dv,
            float* __restrict__ dlw, float* __restrict__ du, int S, int H,
            int B) {
  constexpr int P = N + 1;
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int t0 = c * kChunk, nc = gridDim.x;
  extern __shared__ float smem[];
  const Lcw lcw{smem, smem + kChunk * P};  // kChunk x P each
  float* sr = smem + 2 * kChunk * P;
  float* sk = sr + kChunk * P;     // k, then k e^{lcw_last - lcw_j}
  float* sv = sk + kChunk * P;
  float* sdo = sv + kChunk * P;
  float* sdr = sdo + kChunk * P;   // dr' (without the bonus)
  float* sdk = sdr + kChunk * P;   // dk' (without the bonus)
  float* sA = sdk + kChunk * P;    // scores, bonus on the diagonal (logw first)
  float* sdA = sA + kChunk * kChunk;  // do_i . v_j (j <= i)
  float* sS0 = sdA + kChunk * kChunk;  // N x P, the state entering the chunk
  float* sdS = sS0 + N * P;            // N x P, dL/dS at the chunk's end
  if (c == 0 && b == 0 && threadIdx.x < N) {
    float acc = 0.0f;
    for (int bb = 0; bb < B; ++bb) {
      acc += du_part[(static_cast<long long>(bb) * H + h) * N + threadIdx.x];
    }
    du[h * N + threadIdx.x] = acc;
  }
  load_rows(sr, P, r, b, h, t0, S, H, N, 0, N);
  load_rows(sk, P, k, b, h, t0, S, H, N, 0, N);
  load_rows(sv, P, v, b, h, t0, S, H, N, 0, N);
  load_rows(sdo, P, dout, b, h, t0, S, H, N, 0, N);
  load_rows(sA, N, lw, b, h, t0, S, H, N, 0, N);
  load_square(sS0, P, states + chunk_mat(b, h, c, H, nc, N), N, 0, N);
  load_square(sdS, P, dstates + chunk_mat(b, h, c, H, nc, N), N, 0, N);
  __syncthreads();
  cumsum<N>(lcw, sA);
  __syncthreads();
  for (int p = threadIdx.x; p < kPairs; p += blockDim.x) {
    int i, j;
    pair_of(p, i, j);
    float a = 0.0f, da = 0.0f;
    if (j < i) {
      a = decayed_dot<N>(sr + i * P, sk + j * P, lcw, i, j);
    } else {
      for (int n = 0; n < N; ++n) {
        a += sr[i * P + n] * __ldg(u + h * N + n) * sk[i * P + n];
      }
    }
    for (int n = 0; n < N; ++n) da += sdo[i * P + n] * sv[j * P + n];
    sA[i * kChunk + j] = a;
    sdA[i * kChunk + j] = da;
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < kChunk * N; idx += blockDim.x) {
    const int i = idx / N, n = idx % N;
    float x = 0.0f;
    for (int col = 0; col < N; ++col) x += sS0[n * P + col] * sdo[i * P + col];
    float gr = decay_from_start<N>(lcw, i, n) * x;
    for (int j = 0; j < i; ++j) {
      gr += sdA[i * kChunk + j] * sk[j * P + n] * pair_decay<N>(lcw, i, j, n);
    }
    float y = 0.0f;
    for (int col = 0; col < N; ++col) y += sdS[n * P + col] * sv[i * P + col];
    float gk = decay_to_end<N>(lcw, i, n) * y;
    for (int m = i + 1; m < kChunk; ++m) {
      gk += sdA[m * kChunk + i] * sr[m * P + n] * pair_decay<N>(lcw, m, i, n);
    }
    sdr[i * P + n] = gr;
    sdk[i * P + n] = gk;
    const int t = t0 + i;
    if (t < S) {
      const float bonus = __ldg(u + h * N + n) * sdA[i * kChunk + i];
      const long long o = at(b, t, h, S, H, N) + n;
      dr[o] = gr + bonus * sk[i * P + n];
      dk[o] = gk + bonus * sr[i * P + n];
    }
  }
  __syncthreads();
  if (threadIdx.x < N) {
    const int n = threadIdx.x;
    float rs = 0.0f;  // rowsum(S_C * dS), S_C the next chunk's S_0
    if (c + 1 < nc) {
      const float* st1 = states + chunk_mat(b, h, c + 1, H, nc, N) + n * N;
      for (int col = 0; col < N; ++col) rs += st1[col] * sdS[n * P + col];
    }
    float acc_r = 0.0f, acc_k = 0.0f;
    for (int i = kChunk - 1; i >= 0; --i) {
      acc_k += sk[i * P + n] * sdk[i * P + n];
      const int t = t0 + i;
      if (t < S) dlw[at(b, t, h, S, H, N) + n] = acc_r - acc_k + rs;
      acc_r += sr[i * P + n] * sdr[i * P + n];
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < kChunk * N; idx += blockDim.x) {
    const int j = idx / N, n = idx % N;
    sk[j * P + n] *= decay_to_end<N>(lcw, j, n);
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < kChunk * N; idx += blockDim.x) {
    const int j = idx / N, col = idx % N;
    const int t = t0 + j;
    if (t >= S) continue;
    float g = sA[j * kChunk + j] * sdo[j * P + col];
    for (int i = j + 1; i < kChunk; ++i) g += sA[i * kChunk + j] * sdo[i * P + col];
    for (int n = 0; n < N; ++n) g += sk[j * P + n] * sdS[n * P + col];
    dv[at(b, t, h, S, H, N) + col] = g;
  }
}

inline bool bad_shape(int B, int S, int H) {
  return B <= 0 || S <= 0 || H <= 0 || B > 65535 || H > 65535;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
}

template <int N>
int launch_fwd(const float* r, const float* k, const float* v,
               const float* lw, const float* u, float* out, float* states,
               float* rdec, float* dvec, int B, int S, int H,
               cudaStream_t st) {
  const int nc = (S + kChunk - 1) / kChunk;
  cudaError_t e = allow_smem(chunk_fwd_kernel<N>, chunk_fwd_smem<N>());
  if (e == cudaSuccess) e = allow_smem(state_fwd_kernel<N>, state_fwd_smem<N>());
  if (e != cudaSuccess) return static_cast<int>(e);
  chunk_fwd_kernel<N><<<dim3(nc, H, B), kThreads, chunk_fwd_smem<N>(), st>>>(
      r, k, v, lw, u, out, rdec, states, dvec, S, H);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  state_fwd_kernel<N><<<dim3(N / vcols<N>(), H, B), kThreads,
                        state_fwd_smem<N>(), st>>>(rdec, dvec, states, out, S,
                                                   H);
  return static_cast<int>(cudaGetLastError());
}

template <int N>
int launch_bwd(const float* r, const float* k, const float* v,
               const float* lw, const float* u, const float* states,
               const float* dout, float* dr, float* dk, float* dv,
               float* dlw, float* dstates, float* du_part, float* du, int B,
               int S, int H, cudaStream_t st) {
  const int nc = (S + kChunk - 1) / kChunk;
  cudaError_t e = allow_smem(dstate_kernel<N>, dstate_smem<N>());
  if (e == cudaSuccess) e = allow_smem(grad_kernel<N>, grad_smem<N>());
  if (e != cudaSuccess) return static_cast<int>(e);
  dstate_kernel<N><<<dim3(N / vcols<N>(), H, B), kThreads, dstate_smem<N>(),
                     st>>>(r, k, v, lw, dout, dstates, du_part, S, H);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  grad_kernel<N><<<dim3(nc, H, B), kThreads, grad_smem<N>(), st>>>(
      r, k, v, lw, u, states, dstates, dout, du_part, dr, dk, dv, dlw, du, S,
      H, B);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wkv
}  // namespace repro

using namespace repro;

extern "C" {

// out (B, S, H, N) and states (B, H, ceil(S/64), N, N); rdec (B, S, H, N)
// and dvec (B, H, ceil(S/64), N) are scratch. Returns cudaGetLastError()
// after the launches.
int repro_wkv6_fwd(const void* r, const void* k, const void* v,
                   const void* logw, const void* u, void* out, void* states,
                   void* rdec, void* dvec, int B, int S, int H, int N,
                   void* stream) {
  if (wkv::bad_shape(B, S, H)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float *fr = static_cast<const float*>(r), *fk = static_cast<const float*>(k),
              *fv = static_cast<const float*>(v), *fl = static_cast<const float*>(logw),
              *fu = static_cast<const float*>(u);
  float *fo = static_cast<float*>(out), *fs = static_cast<float*>(states),
        *fd = static_cast<float*>(rdec), *fw = static_cast<float*>(dvec);
  switch (N) {
    case 16: return wkv::launch_fwd<16>(fr, fk, fv, fl, fu, fo, fs, fd, fw, B, S, H, st);
    case 32: return wkv::launch_fwd<32>(fr, fk, fv, fl, fu, fo, fs, fd, fw, B, S, H, st);
    case 64: return wkv::launch_fwd<64>(fr, fk, fv, fl, fu, fo, fs, fd, fw, B, S, H, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// dr, dk, dv, dlogw (B, S, H, N), du (H, N); dstates (B, H, ceil(S/64), N,
// N) and du_part (B, H, N) are scratch.
int repro_wkv6_bwd(const void* r, const void* k, const void* v,
                   const void* logw, const void* u, const void* states,
                   const void* dout, void* dr, void* dk, void* dv,
                   void* dlogw, void* dstates, void* du_part, void* du,
                   int B, int S, int H, int N, void* stream) {
  if (wkv::bad_shape(B, S, H)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float *fr = static_cast<const float*>(r), *fk = static_cast<const float*>(k),
              *fv = static_cast<const float*>(v), *fl = static_cast<const float*>(logw),
              *fu = static_cast<const float*>(u),
              *fs = static_cast<const float*>(states),
              *fd = static_cast<const float*>(dout);
  float *gr = static_cast<float*>(dr), *gk = static_cast<float*>(dk),
        *gv = static_cast<float*>(dv), *gl = static_cast<float*>(dlogw),
        *gs = static_cast<float*>(dstates), *gp = static_cast<float*>(du_part),
        *gu = static_cast<float*>(du);
  switch (N) {
    case 16: return wkv::launch_bwd<16>(fr, fk, fv, fl, fu, fs, fd, gr, gk, gv, gl, gs, gp, gu, B, S, H, st);
    case 32: return wkv::launch_bwd<32>(fr, fk, fv, fl, fu, fs, fd, gr, gk, gv, gl, gs, gp, gu, B, S, H, st);
    case 64: return wkv::launch_bwd<64>(fr, fk, fv, fl, fu, fs, fd, gr, gk, gv, gl, gs, gp, gu, B, S, H, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"

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
// N in {16, 32, 64}, any S (the ragged last chunk is masked here), and an
// optional initial state s0 (B, H, N, N) f32:
//   o_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T),
//   S_t = diag(exp(logw_t)) S_{t-1} + k_t v_t^T,   S_{-1} = s0 (or 0).
// The forward writes o, the state entering each chunk, states
// (B, H, ceil(S / 64), N, N), and the state after the last real step,
// final (B, H, N, N): the tail of the last chunk is loaded as zeros, so
// its steps decay by e^0 = 1 and add k v^T = 0, as the reference pads
// (models/rwkv.py:chunked_wkv). The backward reads them and writes dr, dk,
// dv, dlogw, du (H, N) and, given s0, ds0 (B, H, N, N); an optional
// gradient for the final state, dfinal, starts its reverse pass (zero
// without it). No atomics: the same inputs give the same bits.
//
// Chunked form. With lcw_i = sum_{t <= i} logw_t inside a chunk (lcw_{-1} =
// 0), every exponent is a difference that is <= 0:
//   o_i = (r_i * e^{lcw_{i-1}}) S_c + sum_{j<i} A_ij v_j + (r_i . (u * k_i)) v_i,
//   A_ij = sum_n r_in k_jn e^{lcw_{i-1,n} - lcw_{j,n}},
//   S_{c+1} = diag(d_c) S_c + D_c,  d_c = e^{lcw_last},
//   D_c = sum_j (k_j * e^{lcw_last - lcw_j}) v_j^T.
// The reference's chunked_wkv and the Pallas kernel factor the pair decay
// as (r_i e^{lcw_{i-1}}) (k_j e^{-lcw_j}); e^{-lcw_j} overflows f32 once
// -lcw passes 88.7 inside a chunk, which the model's own decays reach. Here
// nothing computes e^{-lcw} on its own. lcw is summed in f64 (in log2
// units) and kept as two f32 words, hi + lo; a difference is (hi_a - hi_b)
// + (lo_a - lo_b), one f32 rounding of the result, then ex2.approx
// (relative error under 2^-22). An f32 sum would not do: lcw reaches a few
// thousand within a chunk under the model's strongest decays, and a
// difference of two such sums carries their rounding, about 1e-4 of
// relative error in the exponential, the whole tolerance. (Where only a
// prefix or a suffix of the chunk is needed, the f64 sum itself is rounded
// once.)
//
// Backward. With dS_c = dL/dS at the end of chunk c (0 after the last),
// dA_ij = do_i . v_j and dd_i = dA_ii:
//   dS_{c-1} = diag(d_c) dS_c + X_c,  X_c = sum_i (r_i e^{lcw_{i-1}}) do_i^T
//   dr'_i = e^{lcw_{i-1}} * (S_c do_i) + sum_{j<i} dA_ij k_j e^{lcw_{i-1} - lcw_j}
//   dk'_j = sum_{i>j} dA_ij r_i e^{lcw_{i-1} - lcw_j} + e^{lcw_last - lcw_j} * (dS_c v_j)
//   dr = dr' + u k dd,  dk = dk' + u r dd,
//   dv_j = sum_{i>=j} A_ij do_i + dS_c^T (k_j e^{lcw_last - lcw_j})
//   du = sum over batch and chunks of sum_i r_i k_i dd_i, in a fixed order.
// dlogw from the identity dL/dlcw_m = r_{m+1} dr'_{m+1} - k_m dk'_m (+ the
// state term at the chunk's last step), summed over m >= t inside the chunk:
//   dlogw_t = sum_{m>=t} (r_{m+1} dr'_{m+1} - k_m dk'_m) + rowsum(S_{c+1} * dS_c)
// (r_64 dr'_64 = 0). The sums stop at the chunk's end, so they run over at
// most 64 terms, and S_{c+1} is the state the forward saved for the next
// chunk.
//
// The design. Each pass is three stages, none of which walks the chunks
// of a (b, h) one after another with the chunk work in its loop:
//   (a) one block per chunk computes the chunk's own term of the
//       recursion: D_c (forward, into states[c + 1], the last chunk's into
//       final) or X_c (backward, into dstates[c - 1], chunk 0's into ds0
//       when s0 is given), and d_c;
//   (b) an elementwise scan over the B H N N entries of the chunk states
//       (scan_kernel): one thread per float4, the loads of 8 chunks issued
//       ahead of their 8 dependent updates, S_{c+1} = d_c S_c + D_c forward
//       (from S_0 = s0 or 0, ending with final) and dS_{c-1} = d_c dS_c +
//       X_c backward (from dS_{nc-1} = dfinal or 0, ending with ds0), in
//       place;
//   (c) one block per chunk computes the output (out_kernel, writing o
//       once) or every gradient (grad_kernel, plus a per-chunk du partial,
//       summed over (b, chunk) in order by du_sum_kernel).
// Inside a chunk, a secondary chunking into four sub-chunks of 16 steps:
// for i and j in different sub-chunks, the pair decay factors through the
// boundary beta (the last step before i's sub-chunk, or the last of j's),
//   e^{lcw_{i-1} - lcw_j} = e^{lcw_{i-1} - lcw_beta} e^{lcw_beta - lcw_j},
// two factors <= 1 (nothing overflows), so A, dr' and dk' over those
// sub-blocks are products of decayed r and k tiles. Only the four diagonal
// 16 x 16 sub-blocks evaluate one exponential per (pair, channel): 480 of a
// chunk's 2,016 pairs. Every product (A off the diagonal, A v, (r e^{lcw})
// S_c, D_c, X_c, dA = do v^T, dA k, dA^T r, S_c do, dS_c v, A^T do,
// k dS_c) runs on the tensor cores: mma.sync m16n8k8 TF32 with the 3xTF32
// split of both operands in registers, hi = cvt.rna.tf32(x), lo =
// cvt.rna.tf32(x - hi), a b ~ a_lo b_hi + a_hi b_lo + a_hi b_hi, f32
// accumulators. One TF32 rounding keeps about 3 decimal digits and misses
// the 1e-4 gates; the split leaves about 2^-21 a product. What sets out's
// error is the accumulation: each MMA's sum rounds less well than f32 to
// nearest (out at (1, 4096, 40, 64) reads between the two emulations of
// tests/test_torch_wkv6_design.py, each MMA's sum rounded to nearest and
// toward zero, about 0.7x the latter's, which the CPU tests hold to the
// gates).
// The decayed tiles are formed while the fragments are loaded; operands
// whose contraction index is contiguous on both sides are read two values
// at a time (warp_mma<true>). Tiles are staged by cp.async (logw first, so
// the f64 scan of lcw starts while the rest lands) into shared memory rows
// of N floats whose 16-byte pieces are XOR-swizzled by row (sw), so that
// the fragment loads of both operand layouts and the row-wise passes hit
// 32 distinct banks. The chunk kernels run 256 threads (8 warps: warp w
// owns sub-chunk w / 2 and half the columns) and fit two blocks an SM at
// N = 64 (out_kernel 106 KB, grad_kernel 108 KB: A reuses v's tile once v
// is consumed, and the backward's B operands S_c and dS_c come from L2).
// Each lane holds rows g and 15 - g of its warp's sub-chunk (warp_mma), so
// the per-pair loops of dr' and dk' take 15 steps on every lane.
//
// What bounds it on this card. The function's bytes (r, k, v, logw and u
// read once, o written once) are 209.7 MB at (1, 4096, 40, 64), 62.6 us at
// 3.35 TB/s; the chunk states add 41.9 MB that the forward writes (and the
// scan reads and writes once more) and the backward reads. The products are
// ~4 GFLOP forward and ~9 GFLOP backward: 24 and 53 us at the TF32 rate
// three times over. chip_smoke.py measured, on an H100 80GB HBM3 at 700 W,
// forward 0.42 ms (state_kernel 0.073, scan 0.026, out_kernel 0.247) and
// backward 0.97 ms (xterm_kernel 0.074, scan 0.026, grad_kernel 0.769,
// du_sum 0.008): the scans run at the memory's rate, the chunk kernels at
// 3-6x their bytes. What bounds those is the SIMT work around the MMAs
// (fragment addressing and the split, ~6 instructions an operand value),
// the per-pair loops of the diagonal sub-blocks (30,720 exponentials a
// chunk for A, again for dr' and for dk') and, with two blocks an SM that
// load and then compute, loads that the compute does not hide; the
// special-function unit is not the limit. Not done: wgmma, TMA and a
// persistent pipeline that loads chunk c + 1 while chunk c computes.
#include <stdint.h>

#include "common.cuh"

namespace repro {
namespace wkv {

constexpr int kChunk = 64;
constexpr int kSub = 16;                          // the secondary chunk
constexpr int kSubs = kChunk / kSub;              // 4
constexpr int kTri = kSubs * (kSubs + 1) / 2;     // 16 x 16 blocks on or below the diagonal
constexpr int kTriFloats = kTri * kSub * kSub;    // 2,560
constexpr int kThreads = 256;                     // 8 warps
constexpr int kScanUnroll = 8;                    // chunks a scan thread loads ahead
constexpr double kLog2e = 1.4426950408889634;

// Element (row, col) of a shared tile with rows of W floats: the 16-byte
// pieces of each row XOR-permuted by the row, so that an MMA fragment load
// ([g][t] or [t][g], g < 8, t < 4) and a row-wise pass hit 32 banks.
template <int W>
__device__ __forceinline__ int sw(int row, int col) {
  const int m = W >= 32 ? (((row & 3) << 3) | (row & 4))
                        : (((row & 2) << 2) | (row & 4));
  return row * W + (col ^ m);
}

// The 10 blocks of 16 x 16 on or below the diagonal of a 64 x 64 matrix
// (A or dA), element (i, j) with j / 16 <= i / 16.
struct Tri {
  float* p;
  __device__ __forceinline__ float& operator()(int i, int j) const {
    const int bi = i >> 4, bj = j >> 4;
    return p[(bi * (bi + 1) / 2 + bj) * (kSub * kSub) + sw<kSub>(i & 15, j & 15)];
  }
};

__device__ __forceinline__ long long at(int b, int t, int h, int S, int H,
                                        int N) {
  return ((static_cast<long long>(b) * S + t) * H + h) * N;
}

__device__ __forceinline__ long long chunk_mat(int b, int h, int c, int H,
                                               int nc, int N) {
  return ((static_cast<long long>(b) * H + h) * nc + c) * N * N;
}

__device__ __forceinline__ long long chunk_vec(int b, int h, int c, int H,
                                               int nc, int N) {
  return ((static_cast<long long>(b) * H + h) * nc + c) * N;
}

// ------------------------------------------------------------ copies

__device__ __forceinline__ void cp16(float* dst, const float* src, bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most `pending` of this thread's committed groups are in flight.
template <int pending>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(pending) : "memory");
}

__device__ __forceinline__ void cp_wait_all() {
  cp_commit();
  cp_wait<0>();
}

// Rows [t0, t0 + 64) of head h of x (B, S, H, N) into a swizzled tile, zero
// past S.
template <int N>
__device__ __forceinline__ void load_chunk(float* sh, const float* x, int b,
                                           int h, int t0, int S, int H) {
  constexpr int V = N / 4;
  for (int idx = threadIdx.x; idx < kChunk * V; idx += kThreads) {
    const int i = idx / V, c = (idx % V) * 4;
    const bool ok = t0 + i < S;
    cp16(sh + sw<N>(i, c), ok ? x + at(b, t0 + i, h, S, H, N) + c : x, ok);
  }
}

template <int N>
__device__ __forceinline__ void load_square(float* sh, const float* m) {
  constexpr int V = N / 4;
  for (int idx = threadIdx.x; idx < N * V; idx += kThreads) {
    const int i = idx / V, c = (idx % V) * 4;
    cp16(sh + sw<N>(i, c), m + i * N + c, true);
  }
}

// 2^x on the special-function unit: ex2.approx.ftz, relative error under
// 2^-22; results below 2^-126 flush to 0, far under what the gates see.
__device__ __forceinline__ float fexp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ------------------------------------------------------ tensor cores

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo + O(2^-22 |x|): hi rounded to nearest (so x - hi is exact).
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma(float c[4], const uint32_t a[4],
                                    const uint32_t b[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// acc[nt] (16 x 8, rows m0.., columns n0 + 8 nt..) += sum_{k0 <= k < k1}
// fa(row, k) fb(k, col) for nt < count, with the 3xTF32 split of both
// operands, small terms first; k1 - k0 a multiple of 8. The fragments of
// one warp (lane = 4 g + t): a (g, t), (g', t), (g, t + 4), (g', t + 4);
// b (t, g), (t + 4, g); acc (g, 2t), (g, 2t + 1), (g', 2t), (g', 2t + 1),
// where the MMA's rows g + 8 hold the tile's rows g' = 15 - g: each lane
// then holds rows g and 15 - g, whose pair loops in a diagonal sub-block
// take 15 steps together on every lane.
// kPairs: both operands hold the contraction index in contiguous pairs, so
// slots t and t + 4 of the k-step at k are taken as columns k + 2t and
// k + 2t + 1 of both (the same permutation of each k-step on both sides
// leaves the product unchanged), and fa(row, c), fb(c, col) return the
// float2 at c and c + 1: one 8-byte load for two values.
template <bool kPairs = false, int NT, class FA, class FB>
__device__ __forceinline__ void warp_mma(float (&acc)[NT][4], int m0, int n0,
                                         int k0, int k1, FA fa, FB fb,
                                         int count = NT) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = m0 + g, r1 = m0 + 15 - g;
#pragma unroll 2
  for (int k = k0; k < k1; k += 8) {
    float a[4];
    if constexpr (kPairs) {
      const float2 x0 = fa(r0, k + 2 * t), x1 = fa(r1, k + 2 * t);
      a[0] = x0.x, a[1] = x1.x, a[2] = x0.y, a[3] = x1.y;
    } else {
      a[0] = fa(r0, k + t), a[1] = fa(r1, k + t);
      a[2] = fa(r0, k + t + 4), a[3] = fa(r1, k + t + 4);
    }
    uint32_t ah[4], al[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) split(a[e], ah[e], al[e]);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      if (nt < count) {
        const int col = n0 + 8 * nt + g;
        float b[2];
        if constexpr (kPairs) {
          const float2 y = fb(k + 2 * t, col);
          b[0] = y.x, b[1] = y.y;
        } else {
          b[0] = fb(k + t, col), b[1] = fb(k + t + 4, col);
        }
        uint32_t bh[2], bl[2];
        split(b[0], bh[0], bl[0]);
        split(b[1], bh[1], bl[1]);
        mma(acc[nt], al, bh);
        mma(acc[nt], ah, bl);
        mma(acc[nt], ah, bh);
      }
    }
  }
}

__device__ __forceinline__ float2 ldg2(const float* p) {
  return __ldg(reinterpret_cast<const float2*>(p));
}

// Row and column of accumulator element e (0..3) of n-tile nt.
__device__ __forceinline__ int acc_row(int m0, int e) {
  const int g = (threadIdx.x & 31) >> 2;
  return m0 + (e < 2 ? g : 15 - g);
}
__device__ __forceinline__ int acc_col(int n0, int nt, int e) {
  return n0 + 8 * nt + 2 * (threadIdx.x & 3) + (e & 1);
}

template <int NT>
__device__ __forceinline__ void zero(float (&acc)[NT][4]) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.0f;
  }
}

// The warps of an N x N product: NT n-tiles each, WPM warps a 16-row block.
template <int N>
struct Square {
  static constexpr int NT = N == 64 ? 4 : 1;
  static constexpr int WPM = N / 8 / NT;
  static constexpr int kWarps = N / 16 * WPM;
};

// D (N x N) = sum_{j < 64} a(j, row) b(j, col) over two swizzled 64 x N
// tiles, stored row-major into dst (global).
template <int N>
__device__ __forceinline__ void square_product(float* dst, const float* a,
                                               const float* b) {
  using Sq = Square<N>;
  const int w = threadIdx.x >> 5;
  if (w >= Sq::kWarps) return;
  const int m0 = 16 * (w / Sq::WPM), n0 = 8 * Sq::NT * (w % Sq::WPM);
  float acc[Sq::NT][4];
  zero(acc);
  warp_mma(acc, m0, n0, 0, kChunk,
           [&](int row, int j) { return a[sw<N>(j, row)]; },
           [&](int j, int col) { return b[sw<N>(j, col)]; });
#pragma unroll
  for (int nt = 0; nt < Sq::NT; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; e += 2) {
      *reinterpret_cast<float2*>(dst + acc_row(m0, e) * N + acc_col(n0, nt, e)) =
          make_float2(acc[nt][e], acc[nt][e + 1]);
    }
  }
}

// ------------------------------------------------- cumulative decays

// lcw of the chunk: hi holds logw on entry; on exit hi + lo = sum_{t <= i}
// logw_t log2(e), summed in f64. Thread (s, n), s < 4: the rows of
// sub-chunk s of channel n, after the sums of the sub-chunks before it.
template <int N>
__device__ __forceinline__ void lcw_scan(float* hi, float* lo, double* part) {
  const int n = threadIdx.x % N, s = threadIdx.x / N;
  if (s < kSubs) {
    double acc = 0.0;
    for (int i = kSub * s; i < kSub * s + kSub; ++i) {
      acc += static_cast<double>(hi[sw<N>(i, n)]) * kLog2e;
    }
    part[s * N + n] = acc;
  }
  __syncthreads();
  if (s < kSubs) {
    double acc = 0.0;
    for (int q = 0; q < s; ++q) acc += part[q * N + n];
    for (int i = kSub * s; i < kSub * s + kSub; ++i) {
      acc += static_cast<double>(hi[sw<N>(i, n)]) * kLog2e;
      const float h = static_cast<float>(acc);
      hi[sw<N>(i, n)] = h;
      lo[sw<N>(i, n)] = static_cast<float>(acc - static_cast<double>(h));
    }
  }
}

// x_i *= 2^{sum_{t < i} logw_t log2 e} (kSuffix false: the decay from the
// chunk's start to step i) or x_j *= 2^{sum_{t > j} ...} (true: from step j
// to the chunk's end), each sum in f64 and rounded once; d[n] gets the
// whole chunk's decay 2^{lcw_last}.
template <int N, bool kSuffix>
__device__ __forceinline__ void scale_by_decay(float* x, const float* lw,
                                               double* part, float* d) {
  const int n = threadIdx.x % N, s = threadIdx.x / N;
  if (s < kSubs) {
    double acc = 0.0;
    for (int i = kSub * s; i < kSub * s + kSub; ++i) {
      acc += static_cast<double>(lw[sw<N>(i, n)]) * kLog2e;
    }
    part[s * N + n] = acc;
  }
  __syncthreads();
  if (s < kSubs) {
    double acc = 0.0, total = 0.0;
    for (int q = 0; q < kSubs; ++q) {
      total += part[q * N + n];
      if (kSuffix ? q > s : q < s) acc += part[q * N + n];
    }
    for (int step = 0; step < kSub; ++step) {
      const int i = kSub * s + (kSuffix ? kSub - 1 - step : step);
      x[sw<N>(i, n)] *= fexp2(static_cast<float>(acc));
      acc += static_cast<double>(lw[sw<N>(i, n)]) * kLog2e;
    }
    if (s == 0) d[n] = fexp2(static_cast<float>(total));
  }
}

// 2^{lcw_a - lcw_b} for a >= b in [-1, 63] (lcw_{-1} = 0).
template <int N>
struct Lcw {
  const float* hi;
  const float* lo;
  __device__ __forceinline__ float decay(int a, int b, int n) const {
    const float ha = a >= 0 ? hi[sw<N>(a, n)] : 0.0f;
    const float la = a >= 0 ? lo[sw<N>(a, n)] : 0.0f;
    const float hb = b >= 0 ? hi[sw<N>(b, n)] : 0.0f;
    const float lb = b >= 0 ? lo[sw<N>(b, n)] : 0.0f;
    return fexp2((ha - hb) + (la - lb));
  }
};

template <int N>
__device__ __forceinline__ float4 ld4(const float* t, int row, int n) {
  return *reinterpret_cast<const float4*>(t + sw<N>(row, n));
}

template <int N>
__device__ __forceinline__ float2 ld2(const float* t, int row, int n) {
  return *reinterpret_cast<const float2*>(t + sw<N>(row, n));
}

// 2^{(ha - hb) + (la - lb)}: one pair exponential from the hi and lo words.
__device__ __forceinline__ float pexp(float ha, float la, float hb, float lb) {
  return fexp2((ha - hb) + (la - lb));
}

constexpr int kSubPairs = kSub * (kSub - 1) / 2;   // 120 (i, j), j < i, a sub-block
constexpr int kDiagPairs = kSubs * kSubPairs;      // 480 a chunk

// The q-th pair (i, j), j < i, of the diagonal sub-blocks, row by row.
__device__ __forceinline__ void diag_pair(int q, int& i, int& j) {
  const int p = q / kSubPairs, x = q % kSubPairs;
  int ii = static_cast<int>((sqrtf(8.0f * x + 1.0f) + 1.0f) * 0.5f);
  if (ii * (ii - 1) / 2 > x) --ii;
  if (ii * (ii + 1) / 2 <= x) ++ii;
  i = kSub * p + ii;
  j = kSub * p + x - ii * (ii - 1) / 2;
}

// A (64 x 64, Tri) of a chunk: zero above the diagonal, the bonus
// r_i . (u k_i) on it, per-pair exponentials inside the diagonal sub-blocks
// and, below them, R~ K~^T on the tensor cores: for i in sub-chunk p >= 1,
// beta = 16 p - 1, R~_i = r_i e^{lcw_{i-1} - lcw_beta} and K~_j = k_j
// e^{lcw_beta - lcw_j} (j <= beta). Warp (p, h) computes half of block row
// p's 2p n-tiles.
template <int N>
__device__ __forceinline__ void scores(Tri A, const float* sr, const float* sk,
                                       Lcw<N> lcw, const float* u) {
  // the pairs below the diagonal of the diagonal sub-blocks, then the
  // bonus (in f64: it often cancels to a small sum); 4 channels a load
  for (int q = threadIdx.x; q < kDiagPairs + kChunk; q += kThreads) {
    if (q < kDiagPairs) {
      int i, j;
      diag_pair(q, i, j);
      float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll 4
      for (int n = 0; n < N; n += 4) {
        const float4 a = ld4<N>(sr, i, n), b = ld4<N>(sk, j, n);
        const float4 ha = ld4<N>(lcw.hi, i - 1, n), la = ld4<N>(lcw.lo, i - 1, n);
        const float4 hb = ld4<N>(lcw.hi, j, n), lb = ld4<N>(lcw.lo, j, n);
        acc[0] += a.x * b.x * pexp(ha.x, la.x, hb.x, lb.x);
        acc[1] += a.y * b.y * pexp(ha.y, la.y, hb.y, lb.y);
        acc[2] += a.z * b.z * pexp(ha.z, la.z, hb.z, lb.z);
        acc[3] += a.w * b.w * pexp(ha.w, la.w, hb.w, lb.w);
      }
      A(i, j) = (acc[0] + acc[1]) + (acc[2] + acc[3]);
    } else {
      const int i = q - kDiagPairs;
      double bonus = 0.0;
      for (int n = 0; n < N; n += 4) {
        const float4 a = ld4<N>(sr, i, n), b = ld4<N>(sk, i, n);
        const float4 w = __ldg(reinterpret_cast<const float4*>(u + n));
        bonus += static_cast<double>(a.x * w.x) * b.x;
        bonus += static_cast<double>(a.y * w.y) * b.y;
        bonus += static_cast<double>(a.z * w.z) * b.z;
        bonus += static_cast<double>(a.w * w.w) * b.w;
      }
      A(i, i) = static_cast<float>(bonus);
    }
  }
  for (int idx = threadIdx.x; idx < kSubs * kSub * kSub; idx += kThreads) {
    const int ii = (idx >> 4) & 15, jj = idx & 15, i = (idx >> 8) * kSub;
    if (jj > ii) A(i + ii, i + jj) = 0.0f;
  }
  const int w = threadIdx.x >> 5, p = w >> 1, half = w & 1;
  if (p == 0) return;
  const int beta = kSub * p - 1, m0 = kSub * p, n0 = 8 * p * half;
  float acc[3][4];
  zero(acc);
  const auto decayed = [&](const float* x, int row, int a, int b, int n) {
    const float2 v = ld2<N>(x, row, n);
    const float2 ha = ld2<N>(lcw.hi, a, n), la = ld2<N>(lcw.lo, a, n);
    const float2 hb = ld2<N>(lcw.hi, b, n), lb = ld2<N>(lcw.lo, b, n);
    return make_float2(v.x * pexp(ha.x, la.x, hb.x, lb.x),
                       v.y * pexp(ha.y, la.y, hb.y, lb.y));
  };
  warp_mma<true>(acc, m0, n0, 0, N,
                 [&](int i, int n) { return decayed(sr, i, i - 1, beta, n); },
                 [&](int n, int j) { return decayed(sk, j, beta, j, n); }, p);
#pragma unroll
  for (int nt = 0; nt < 3; ++nt) {
    if (nt < p) {
#pragma unroll
      for (int e = 0; e < 4; ++e) A(acc_row(m0, e), acc_col(n0, nt, e)) = acc[nt][e];
    }
  }
}

// ---------------------------------------------------------------- forward

template <int N>
constexpr size_t state_smem() {
  return sizeof(double) * kSubs * N + sizeof(float) * 3 * kChunk * N;
}

// Stage (a) of the forward: D_c = sum_j (k_j e^{lcw_last - lcw_j}) v_j^T into
// states[c + 1] (the last chunk's into final[b][h]) and e^{lcw_last} into
// dvec[c]. Grid (ceil(S / 64), H, B).
template <int N>
__global__ void __launch_bounds__(kThreads)
state_kernel(const float* __restrict__ k, const float* __restrict__ v,
             const float* __restrict__ lw, float* __restrict__ states,
             float* __restrict__ final, float* __restrict__ dvec, int S,
             int H) {
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z, nc = gridDim.x;
  extern __shared__ __align__(16) float smem[];
  double* part = reinterpret_cast<double*>(smem);
  float* sk = smem + 2 * kSubs * N;
  float* sv = sk + kChunk * N;
  float* sl = sv + kChunk * N;
  const int t0 = c * kChunk;
  load_chunk<N>(sk, k, b, h, t0, S, H);
  load_chunk<N>(sv, v, b, h, t0, S, H);
  load_chunk<N>(sl, lw, b, h, t0, S, H);
  cp_wait_all();
  __syncthreads();
  scale_by_decay<N, true>(sk, sl, part, dvec + chunk_vec(b, h, c, H, nc, N));
  __syncthreads();
  square_product<N>(c + 1 < nc ? states + chunk_mat(b, h, c + 1, H, nc, N)
                               : final + chunk_mat(b, h, 0, H, 1, N),
                    sk, sv);
}

// Stage (b) of both passes, over x (BH, nc, N, N) in place, one float4 of
// one (b, h) a thread; d (BH, nc, N) scales row n of an entry; init and
// extra (BH, N, N) may be null.
//   forward: x[0] = init (or 0), x[c] = d[c - 1] x[c - 1] + x[c]
//            (c = 1 .. nc - 1), then extra = d[nc - 1] x[nc - 1] + extra;
//   reverse: x[nc - 1] = init (or 0), x[c] = d[c + 1] x[c + 1] + x[c]
//            (c = nc - 2 .. 0), then extra = d[0] x[0] + extra;
// with x[c - 1], x[c + 1] the values just written. The loads of
// kScanUnroll chunks are issued before their updates.
template <bool kReverse>
__global__ void __launch_bounds__(kThreads)
scan_kernel(float* __restrict__ x, const float* __restrict__ d,
            const float* __restrict__ init, float* __restrict__ extra, int nc,
            int N, long long quads) {
  const long long q = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (q >= quads) return;
  const int per = N * N / 4;
  const long long bh = q / per;
  const int e = static_cast<int>(q % per) * 4;
  float4* xs = reinterpret_cast<float4*>(x + bh * nc * N * N + e);
  const float* ds = d + bh * nc * N + e / N;
  float4 s = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (init != nullptr) s = *reinterpret_cast<const float4*>(init + bh * N * N + e);
  xs[static_cast<long long>(kReverse ? nc - 1 : 0) * per] = s;
  const int steps = nc - 1;
  for (int s0 = 0; s0 < steps; s0 += kScanUnroll) {
    float4 xv[kScanUnroll];
    float dv[kScanUnroll];
#pragma unroll
    for (int u = 0; u < kScanUnroll; ++u) {
      const int c = kReverse ? nc - 2 - (s0 + u) : s0 + u + 1;
      if (s0 + u < steps) {
        xv[u] = xs[static_cast<long long>(c) * per];
        dv[u] = ds[static_cast<long long>(kReverse ? c + 1 : c - 1) * N];
      }
    }
#pragma unroll
    for (int u = 0; u < kScanUnroll; ++u) {
      const int c = kReverse ? nc - 2 - (s0 + u) : s0 + u + 1;
      if (s0 + u < steps) {
        s.x = dv[u] * s.x + xv[u].x;
        s.y = dv[u] * s.y + xv[u].y;
        s.z = dv[u] * s.z + xv[u].z;
        s.w = dv[u] * s.w + xv[u].w;
        xs[static_cast<long long>(c) * per] = s;
      }
    }
  }
  if (extra != nullptr) {
    float4* xe = reinterpret_cast<float4*>(extra + bh * N * N + e);
    const float dv = ds[static_cast<long long>(kReverse ? 0 : nc - 1) * N];
    const float4 xv = *xe;
    s.x = dv * s.x + xv.x;
    s.y = dv * s.y + xv.y;
    s.z = dv * s.z + xv.z;
    s.w = dv * s.w + xv.w;
    *xe = s;
  }
}

template <int N>
constexpr size_t out_smem() {
  return sizeof(float) * (kTriFloats + 5 * kChunk * N + N * N);
}

// Stage (c) of the forward: o of chunk c in one pass,
//   o = (r e^{lcw_{i-1}}) S_c + A v    (A with the bonus on its diagonal),
// both products on the tensor cores; warp (p, h) writes rows of sub-chunk
// p, half the columns. Grid (ceil(S / 64), H, B).
template <int N>
__global__ void __launch_bounds__(kThreads, 2)
out_kernel(const float* __restrict__ r, const float* __restrict__ k,
           const float* __restrict__ v, const float* __restrict__ lw,
           const float* __restrict__ u, const float* __restrict__ states,
           float* __restrict__ out, int S, int H) {
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z, nc = gridDim.x;
  extern __shared__ __align__(16) float smem[];
  const Tri A{smem};                      // the lcw scan's f64 sums first
  float* sr = smem + kTriFloats;
  float* sk = sr + kChunk * N;
  float* sv = sk + kChunk * N;
  float* shi = sv + kChunk * N;           // logw, then lcw's hi word
  float* slo = shi + kChunk * N;
  float* sS = slo + kChunk * N;           // S_c
  const int t0 = c * kChunk;
  load_chunk<N>(shi, lw, b, h, t0, S, H);  // first: the lcw scan needs it
  cp_commit();
  load_chunk<N>(sr, r, b, h, t0, S, H);
  load_chunk<N>(sk, k, b, h, t0, S, H);
  load_chunk<N>(sv, v, b, h, t0, S, H);
  load_square<N>(sS, states + chunk_mat(b, h, c, H, nc, N));
  cp_commit();
  cp_wait<1>();
  __syncthreads();
  lcw_scan<N>(shi, slo, reinterpret_cast<double*>(smem));
  cp_wait<0>();
  __syncthreads();
  const Lcw<N> lcw{shi, slo};
  scores<N>(A, sr, sk, lcw, u + h * N);
  __syncthreads();
  for (int idx = threadIdx.x; idx < kChunk * N; idx += kThreads) {
    const int i = idx / N, n = idx % N;   // r_i e^{lcw_{i-1}}
    sr[sw<N>(i, n)] *= lcw.decay(i - 1, -1, n);
  }
  __syncthreads();
  constexpr int NT = N / 16;
  const int w = threadIdx.x >> 5, p = w >> 1;
  const int m0 = kSub * p, n0 = (w & 1) * (N / 2);
  float acc[NT][4];
  zero(acc);
  warp_mma(acc, m0, n0, 0, N,
           [&](int i, int n) { return sr[sw<N>(i, n)]; },
           [&](int n, int col) { return sS[sw<N>(n, col)]; });
  warp_mma(acc, m0, n0, 0, m0 + kSub,
           [&](int i, int j) { return A(i, j); },
           [&](int j, int col) { return sv[sw<N>(j, col)]; });
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; e += 2) {
      const int t = t0 + acc_row(m0, e);
      if (t < S) {
        *reinterpret_cast<float2*>(out + at(b, t, h, S, H, N) + acc_col(n0, nt, e)) =
            make_float2(acc[nt][e], acc[nt][e + 1]);
      }
    }
  }
}

// --------------------------------------------------------------- backward

// Stage (a) of the backward: X_c = sum_i (r_i e^{lcw_{i-1}}) do_i^T into
// dstates[c - 1] and e^{lcw_last} into dvec[c], for every chunk but the
// first; chunk 0's X_0 into ds0[b][h] when ds0 is not null. Grid
// (ceil(S / 64), H, B).
template <int N>
__global__ void __launch_bounds__(kThreads)
xterm_kernel(const float* __restrict__ r, const float* __restrict__ dout,
             const float* __restrict__ lw, float* __restrict__ dstates,
             float* __restrict__ ds0, float* __restrict__ dvec, int S, int H) {
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z, nc = gridDim.x;
  if (c == 0 && ds0 == nullptr) return;
  extern __shared__ __align__(16) float smem[];
  double* part = reinterpret_cast<double*>(smem);
  float* sr = smem + 2 * kSubs * N;
  float* sdo = sr + kChunk * N;
  float* sl = sdo + kChunk * N;
  const int t0 = c * kChunk;
  load_chunk<N>(sr, r, b, h, t0, S, H);
  load_chunk<N>(sdo, dout, b, h, t0, S, H);
  load_chunk<N>(sl, lw, b, h, t0, S, H);
  cp_wait_all();
  __syncthreads();
  scale_by_decay<N, false>(sr, sl, part, dvec + chunk_vec(b, h, c, H, nc, N));
  __syncthreads();
  square_product<N>(c > 0 ? dstates + chunk_mat(b, h, c - 1, H, nc, N)
                         : ds0 + chunk_mat(b, h, 0, H, 1, N),
                    sr, sdo);
}

// A's own region (N < 64) or v's tile once v is consumed (N = 64).
template <int N>
constexpr bool kAInV = kChunk * N >= kTriFloats;

template <int N>
constexpr size_t grad_smem() {
  return sizeof(float) * (kTriFloats + 6 * kChunk * N +
                          (kAInV<N> ? 0 : kTriFloats) + N + 2 * kSubs * N);
}

// Stage (c) of the backward: every gradient of chunk c from S_c
// (states[c]), S_{c+1} (states[c + 1], for the last chunk final[b][h], or
// nothing when the final state has no gradient) and dS_c (dstates[c]), and du's
// partial sum over the chunk into du_part[b][h][c]. Warp (p, h) owns the
// rows of sub-chunk p and half the columns of dr', dk' and dv, so each
// thread holds dr' and dk' of the same elements; the diagonal sub-blocks'
// terms are added element by element. Grid (ceil(S / 64), H, B).
template <int N>
__global__ void __launch_bounds__(kThreads, 2)
grad_kernel(const float* __restrict__ r, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ lw,
            const float* __restrict__ u, const float* __restrict__ states,
            const float* __restrict__ final, const float* __restrict__ dstates,
            const float* __restrict__ dout, float* __restrict__ dr,
            float* __restrict__ dk,
            float* __restrict__ dv, float* __restrict__ dlw,
            float* __restrict__ du_part, int S, int H) {
  constexpr int NT = N / 16;
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z, nc = gridDim.x;
  extern __shared__ __align__(16) float smem[];
  const Tri dA{smem};                     // the lcw scan's f64 sums first
  float* sr = smem + kTriFloats;
  float* sk = sr + kChunk * N;
  float* sv = sk + kChunk * N;            // v, then A (N = 64)
  float* sdo = sv + kChunk * N;           // do, then dlogw's terms
  float* shi = sdo + kChunk * N;          // logw, then lcw's hi word
  float* slo = shi + kChunk * N;
  float* rest = slo + kChunk * N;
  const Tri A{kAInV<N> ? sv : rest};
  float* srs = rest + (kAInV<N> ? 0 : kTriFloats);  // rowsum(S_{c+1} dS_c)
  float* spart = srs + N;                 // 2 x 4 x N partial sums
  const float* S0 = states + chunk_mat(b, h, c, H, nc, N);
  const float* dS = dstates + chunk_mat(b, h, c, H, nc, N);
  const float* uh = u + h * N;
  const int t0 = c * kChunk;
  load_chunk<N>(shi, lw, b, h, t0, S, H);  // first: the lcw scan needs it
  cp_commit();
  load_chunk<N>(sr, r, b, h, t0, S, H);
  load_chunk<N>(sk, k, b, h, t0, S, H);
  load_chunk<N>(sv, v, b, h, t0, S, H);
  load_chunk<N>(sdo, dout, b, h, t0, S, H);
  cp_commit();
  cp_wait<1>();
  __syncthreads();
  lcw_scan<N>(shi, slo, reinterpret_cast<double*>(smem));
  cp_wait<0>();
  __syncthreads();
  const Lcw<N> lcw{shi, slo};
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5, p = w >> 1;
  const int m0 = kSub * p, n0 = (w & 1) * (N / 2);
  {  // dA = do v^T on and below the diagonal blocks: block row p, half its n-tiles
    float acc[kSubs][4];
    zero(acc);
    const int j0 = 8 * (p + 1) * (w & 1);
    warp_mma<true>(acc, m0, j0, 0, N,
                   [&](int i, int n) { return ld2<N>(sdo, i, n); },
                   [&](int n, int j) { return ld2<N>(sv, j, n); }, p + 1);
#pragma unroll
    for (int nt = 0; nt < kSubs; ++nt) {
      if (nt < p + 1) {
#pragma unroll
        for (int e = 0; e < 4; ++e) dA(acc_row(m0, e), acc_col(j0, nt, e)) = acc[nt][e];
      }
    }
  }
  // dS_c v_j, for dk' (from L2)
  float acc_sv[NT][4];
  zero(acc_sv);
  warp_mma<true>(acc_sv, m0, n0, 0, N,
                 [&](int j, int col) { return ld2<N>(sv, j, col); },
                 [&](int col, int n) { return ldg2(dS + n * N + col); });
  {  // rowsum(S_{c+1} * dS_c): a float4 of a row a thread, the row's
     // N / 4 lanes summed by shuffles in a fixed order
    constexpr int Q = N / 4;
    const bool last = c + 1 == nc;
    const float* S1 = last ? final + chunk_mat(b, h, 0, H, 1, N)
                           : states + chunk_mat(b, h, c + 1, H, nc, N);
#pragma unroll
    for (int e = threadIdx.x; e < N * Q; e += kThreads) {
      const int n = e / Q, q = e % Q;
      float x = 0.0f;
      if (!last || final != nullptr) {
        const float4 a = __ldg(reinterpret_cast<const float4*>(S1 + n * N) + q);
        const float4 z = __ldg(reinterpret_cast<const float4*>(dS + n * N) + q);
        x = (a.x * z.x + a.y * z.y) + (a.z * z.z + a.w * z.w);
      }
#pragma unroll
      for (int off = Q / 2; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
      if (q == 0) srs[n] = x;
    }
  }
  __syncthreads();  // dA is whole; v is consumed
  scores<N>(A, sr, sk, lcw, uh);
  // dr' = e^{lcw_{i-1}} (S_c do_i) + e^{lcw_{i-1} - lcw_beta} (dA K~)_i
  //       + the diagonal block's pairs
  float rdr[NT][4];
  {
    float acc_s[NT][4], acc_k[NT][4];
    zero(acc_s);
    zero(acc_k);
    warp_mma<true>(acc_s, m0, n0, 0, N,
                   [&](int i, int col) { return ld2<N>(sdo, i, col); },
                   [&](int col, int n) { return ldg2(S0 + n * N + col); });
    const int beta = m0 - 1;
    warp_mma(acc_k, m0, n0, 0, m0,
             [&](int i, int j) { return dA(i, j); },
             [&](int j, int n) { return sk[sw<N>(j, n)] * lcw.decay(beta, j, n); });
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      // the diagonal block's pairs of the lane's rows i0 = m0 + g (g of
      // them) and i1 = m0 + 15 - g (15 - g): 15 steps on every lane
      const int n = acc_col(n0, nt, 0), g = lane >> 2;
      const int i0 = m0 + g, i1 = m0 + 15 - g;
      const float2 ha0 = ld2<N>(lcw.hi, i0 > 0 ? i0 - 1 : 0, n);
      const float2 la0 = ld2<N>(lcw.lo, i0 > 0 ? i0 - 1 : 0, n);
      const float2 ha1 = ld2<N>(lcw.hi, i1 - 1, n), la1 = ld2<N>(lcw.lo, i1 - 1, n);
      float x[4] = {0.0f, 0.0f, 0.0f, 0.0f};  // (i0, n), (i0, n + 1), (i1, n), (i1, n + 1)
      for (int step = 0; step < kSub - 1; ++step) {
        const bool first = step < g;
        const int i = first ? i0 : i1, j = m0 + (first ? step : step - g);
        const float2 ha = first ? ha0 : ha1, la = first ? la0 : la1;
        const float d = dA(i, j);
        const float2 kk = ld2<N>(sk, j, n);
        const float2 hb = ld2<N>(lcw.hi, j, n), lb = ld2<N>(lcw.lo, j, n);
        const float t0 = d * kk.x * pexp(ha.x, la.x, hb.x, lb.x);
        const float t1 = d * kk.y * pexp(ha.y, la.y, hb.y, lb.y);
        if (first) {
          x[0] += t0;
          x[1] += t1;
        } else {
          x[2] += t0;
          x[3] += t1;
        }
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = acc_row(m0, e), c = acc_col(n0, nt, e);
        float y = lcw.decay(i - 1, -1, c) * acc_s[nt][e];
        if (p > 0) y += lcw.decay(i - 1, beta, c) * acc_k[nt][e];
        rdr[nt][e] = y + x[e];
      }
    }
  }
  __syncthreads();  // A is whole
  // dk' = e^{lcw_last - lcw_j} (dS_c v_j) + e^{lcw_beta - lcw_j} (dA^T R~')_j
  //       + the diagonal block's pairs, beta = the last step of j's sub-chunk
  float kdk[NT][4];
  {
    float acc_r[NT][4];
    zero(acc_r);
    const int beta = m0 + kSub - 1;
    warp_mma(acc_r, m0, n0, m0 + kSub, kChunk,
             [&](int j, int i) { return dA(i, j); },
             [&](int i, int n) { return sr[sw<N>(i, n)] * lcw.decay(i - 1, beta, n); });
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      // the diagonal block's pairs of the lane's rows j0 = m0 + g (15 - g
      // of them) and j1 = m0 + 15 - g (g): 15 steps on every lane
      const int n = acc_col(n0, nt, 0), g = lane >> 2;
      const int j0 = m0 + g, j1 = m0 + 15 - g;
      const float2 hb0 = ld2<N>(lcw.hi, j0, n), lb0 = ld2<N>(lcw.lo, j0, n);
      const float2 hb1 = ld2<N>(lcw.hi, j1, n), lb1 = ld2<N>(lcw.lo, j1, n);
      float x[4] = {0.0f, 0.0f, 0.0f, 0.0f};  // (j0, n), (j0, n + 1), (j1, n), (j1, n + 1)
      for (int step = 0; step < kSub - 1; ++step) {
        const bool first = step < kSub - 1 - g;
        const int j = first ? j0 : j1, i = j + 1 + (first ? step : step - (kSub - 1 - g));
        const float2 hb = first ? hb0 : hb1, lb = first ? lb0 : lb1;
        const float d = dA(i, j);
        const float2 rr = ld2<N>(sr, i, n);
        const float2 ha = ld2<N>(lcw.hi, i - 1, n), la = ld2<N>(lcw.lo, i - 1, n);
        const float t0 = d * rr.x * pexp(ha.x, la.x, hb.x, lb.x);
        const float t1 = d * rr.y * pexp(ha.y, la.y, hb.y, lb.y);
        if (first) {
          x[0] += t0;
          x[1] += t1;
        } else {
          x[2] += t0;
          x[3] += t1;
        }
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = acc_row(m0, e), c = acc_col(n0, nt, e);
        float y = lcw.decay(kChunk - 1, j, c) * acc_sv[nt][e];
        if (p < kSubs - 1) y += lcw.decay(beta, j, c) * acc_r[nt][e];
        kdk[nt][e] = y + x[e];
      }
    }
  }
  // dr = dr' + u k dd, dk = dk' + u r dd; keep r dr' and k dk' for dlogw
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = acc_row(m0, e), n = acc_col(n0, nt, e);
      const float ri = sr[sw<N>(i, n)], ki = sk[sw<N>(i, n)];
      const float bonus = __ldg(uh + n) * dA(i, i);
      const int t = t0 + i;
      if (t < S) {
        dr[at(b, t, h, S, H, N) + n] = rdr[nt][e] + bonus * ki;
        dk[at(b, t, h, S, H, N) + n] = kdk[nt][e] + bonus * ri;
      }
      rdr[nt][e] *= ri;
      kdk[nt][e] *= ki;
    }
  }
  {  // dv = A^T do + (k e^{lcw_last - lcw_j}) dS_c
    float acc[NT][4];
    zero(acc);
    warp_mma(acc, m0, n0, m0, kChunk,
             [&](int j, int i) { return A(i, j); },
             [&](int i, int col) { return sdo[sw<N>(i, col)]; });
    warp_mma(acc, m0, n0, 0, N,
             [&](int j, int n) { return sk[sw<N>(j, n)] * lcw.decay(kChunk - 1, j, n); },
             [&](int n, int col) { return __ldg(dS + n * N + col); });
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; e += 2) {
        const int t = t0 + acc_row(m0, e);
        if (t < S) {
          *reinterpret_cast<float2*>(dv + at(b, t, h, S, H, N) + acc_col(n0, nt, e)) =
              make_float2(acc[nt][e], acc[nt][e + 1]);
        }
      }
    }
  }
  __syncthreads();  // do is consumed: its tile takes w_m = r_{m+1} dr'_{m+1} - k_m dk'_m
  float* sw_ = sdo;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = acc_row(m0, e), n = acc_col(n0, nt, e);
      sw_[sw<N>((i + kChunk - 1) % kChunk, n)] = i > 0 ? rdr[nt][e] : 0.0f;
    }
  }
  __syncthreads();
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      sw_[sw<N>(acc_row(m0, e), acc_col(n0, nt, e))] -= kdk[nt][e];
    }
  }
  __syncthreads();
  // dlogw_t = sum_{m >= t} w_m + rowsum(S_{c+1} dS_c), and du's partial
  // sum_i r_i k_i dd_i: thread (s, n) over sub-chunk s, in order
  const int n = threadIdx.x % N, s = threadIdx.x / N;
  float* wpart = spart;
  float* upart = spart + kSubs * N;
  if (s < kSubs) {
    float ws = 0.0f, us = 0.0f;
    for (int i = kSub * s; i < kSub * s + kSub; ++i) {
      ws += sw_[sw<N>(i, n)];
      us += sr[sw<N>(i, n)] * sk[sw<N>(i, n)] * dA(i, i);
    }
    wpart[s * N + n] = ws;
    upart[s * N + n] = us;
  }
  __syncthreads();
  if (s < kSubs) {
    float acc = srs[n];
    for (int q = kSubs - 1; q > s; --q) acc += wpart[q * N + n];
    for (int i = kSub * s + kSub - 1; i >= kSub * s; --i) {
      acc += sw_[sw<N>(i, n)];
      if (t0 + i < S) dlw[at(b, t0 + i, h, S, H, N) + n] = acc;
    }
    if (s == 0) {
      float du = 0.0f;
      for (int q = 0; q < kSubs; ++q) du += upart[q * N + n];
      du_part[chunk_vec(b, h, c, H, nc, N) + n] = du;
    }
  }
}

// du[h][n] = sum over b, then chunks, of du_part[b][h][c][n], in order.
__global__ void du_sum_kernel(const float* __restrict__ du_part,
                              float* __restrict__ du, int B, int H, int nc,
                              int N) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= H * N) return;
  const int h = idx / N, n = idx % N;
  float acc = 0.0f;
  for (int b = 0; b < B; ++b) {
    const float* part = du_part + ((static_cast<long long>(b) * H + h) * nc) * N + n;
    for (int c = 0; c < nc; ++c) acc += part[static_cast<long long>(c) * N];
  }
  du[idx] = acc;
}

inline bool bad_shape(int B, int S, int H) {
  return B <= 0 || S <= 0 || H <= 0 || B > 65535 || H > 65535;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

// Blocks of kernel that one SM holds, or -1.
template <typename Kernel>
int blocks_per_sm(Kernel kernel, size_t bytes) {
  int n = 0;
  if (allow_smem(kernel, bytes) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kThreads,
                                                    bytes) != cudaSuccess) {
    return -1;
  }
  return n;
}

template <int N>
void occupancy(int* blocks) {
  blocks[0] = blocks_per_sm(state_kernel<N>, state_smem<N>());
  blocks[1] = blocks_per_sm(out_kernel<N>, out_smem<N>());
  blocks[2] = blocks_per_sm(xterm_kernel<N>, state_smem<N>());
  blocks[3] = blocks_per_sm(grad_kernel<N>, grad_smem<N>());
}

inline int launch_scan(bool reverse, float* x, const float* d,
                       const float* init, float* extra, int B, int H, int nc,
                       int N, cudaStream_t st) {
  const long long quads = static_cast<long long>(B) * H * N * N / 4;
  const unsigned blocks = static_cast<unsigned>((quads + kThreads - 1) / kThreads);
  if (reverse) {
    scan_kernel<true><<<blocks, kThreads, 0, st>>>(x, d, init, extra, nc, N, quads);
  } else {
    scan_kernel<false><<<blocks, kThreads, 0, st>>>(x, d, init, extra, nc, N, quads);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int N>
int launch_fwd(const float* r, const float* k, const float* v,
               const float* lw, const float* u, const float* s0, float* out,
               float* states, float* final, float* dvec, int B, int S, int H,
               cudaStream_t st) {
  const int nc = (S + kChunk - 1) / kChunk;
  const dim3 grid(nc, H, B);
  cudaError_t e = allow_smem(state_kernel<N>, state_smem<N>());
  if (e == cudaSuccess) e = allow_smem(out_kernel<N>, out_smem<N>());
  if (e != cudaSuccess) return static_cast<int>(e);
  state_kernel<N><<<grid, kThreads, state_smem<N>(), st>>>(k, v, lw, states,
                                                           final, dvec, S, H);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int rc = launch_scan(false, states, dvec, s0, final, B, H, nc, N, st);
  if (rc != 0) return rc;
  out_kernel<N><<<grid, kThreads, out_smem<N>(), st>>>(r, k, v, lw, u, states,
                                                       out, S, H);
  return static_cast<int>(cudaGetLastError());
}

template <int N>
int launch_bwd(const float* r, const float* k, const float* v,
               const float* lw, const float* u, const float* states,
               const float* final, const float* dout, const float* dfinal,
               float* dr, float* dk, float* dv, float* dlw, float* ds0,
               float* dstates, float* dvec, float* du_part, float* du, int B,
               int S, int H, cudaStream_t st) {
  const int nc = (S + kChunk - 1) / kChunk;
  const dim3 grid(nc, H, B);
  cudaError_t e = allow_smem(xterm_kernel<N>, state_smem<N>());
  if (e == cudaSuccess) e = allow_smem(grad_kernel<N>, grad_smem<N>());
  if (e != cudaSuccess) return static_cast<int>(e);
  xterm_kernel<N><<<grid, kThreads, state_smem<N>(), st>>>(
      r, dout, lw, dstates, ds0, dvec, S, H);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int rc = launch_scan(true, dstates, dvec, dfinal, ds0, B, H, nc, N, st);
  if (rc != 0) return rc;
  grad_kernel<N><<<grid, kThreads, grad_smem<N>(), st>>>(
      r, k, v, lw, u, states, dfinal != nullptr ? final : nullptr, dstates,
      dout, dr, dk, dv, dlw, du_part, S, H);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  du_sum_kernel<<<(H * N + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      du_part, du, B, H, nc, N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wkv
}  // namespace repro

using namespace repro;

extern "C" {

// s0 (B, H, N, N) or null (a zero state); out (B, S, H, N), states (B, H,
// ceil(S/64), N, N) and final (B, H, N, N); dvec (B, H, ceil(S/64), N) is
// scratch. Returns cudaGetLastError() after the launches.
int repro_wkv6_fwd(const void* r, const void* k, const void* v,
                   const void* logw, const void* u, const void* s0, void* out,
                   void* states, void* final, void* dvec, int B, int S, int H,
                   int N, void* stream) {
  if (wkv::bad_shape(B, S, H)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float *fr = static_cast<const float*>(r), *fk = static_cast<const float*>(k),
              *fv = static_cast<const float*>(v), *fl = static_cast<const float*>(logw),
              *fu = static_cast<const float*>(u), *f0 = static_cast<const float*>(s0);
  float *fo = static_cast<float*>(out), *fs = static_cast<float*>(states),
        *ff = static_cast<float*>(final), *fw = static_cast<float*>(dvec);
  switch (N) {
    case 16: return wkv::launch_fwd<16>(fr, fk, fv, fl, fu, f0, fo, fs, ff, fw, B, S, H, st);
    case 32: return wkv::launch_fwd<32>(fr, fk, fv, fl, fu, f0, fo, fs, ff, fw, B, S, H, st);
    case 64: return wkv::launch_fwd<64>(fr, fk, fv, fl, fu, f0, fo, fs, ff, fw, B, S, H, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Blocks an SM holds of state_kernel, out_kernel, xterm_kernel and
// grad_kernel at head dim N, into blocks[0..3].
int repro_wkv6_occupancy(int N, int* blocks) {
  switch (N) {
    case 16: wkv::occupancy<16>(blocks); return 0;
    case 32: wkv::occupancy<32>(blocks); return 0;
    case 64: wkv::occupancy<64>(blocks); return 0;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// dr, dk, dv, dlogw (B, S, H, N), du (H, N) and, when ds0 is not null,
// ds0 (B, H, N, N); dfinal (B, H, N, N) or null (a zero gradient), final
// the forward's (read only with dfinal); dstates (B, H, ceil(S/64), N, N),
// dvec and du_part (B, H, ceil(S/64), N) are scratch.
int repro_wkv6_bwd(const void* r, const void* k, const void* v,
                   const void* logw, const void* u, const void* states,
                   const void* final, const void* dout, const void* dfinal,
                   void* dr, void* dk, void* dv, void* dlogw, void* ds0,
                   void* dstates, void* dvec, void* du_part, void* du, int B,
                   int S, int H, int N, void* stream) {
  if (wkv::bad_shape(B, S, H)) return static_cast<int>(cudaErrorInvalidValue);
  if (dfinal != nullptr && final == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float *fr = static_cast<const float*>(r), *fk = static_cast<const float*>(k),
              *fv = static_cast<const float*>(v), *fl = static_cast<const float*>(logw),
              *fu = static_cast<const float*>(u),
              *fs = static_cast<const float*>(states),
              *ff = static_cast<const float*>(final),
              *fd = static_cast<const float*>(dout),
              *fg = static_cast<const float*>(dfinal);
  float *gr = static_cast<float*>(dr), *gk = static_cast<float*>(dk),
        *gv = static_cast<float*>(dv), *gl = static_cast<float*>(dlogw),
        *g0 = static_cast<float*>(ds0),
        *gs = static_cast<float*>(dstates), *gw = static_cast<float*>(dvec),
        *gp = static_cast<float*>(du_part), *gu = static_cast<float*>(du);
  switch (N) {
    case 16: return wkv::launch_bwd<16>(fr, fk, fv, fl, fu, fs, ff, fd, fg, gr, gk, gv, gl, g0, gs, gw, gp, gu, B, S, H, st);
    case 32: return wkv::launch_bwd<32>(fr, fk, fv, fl, fu, fs, ff, fd, fg, gr, gk, gv, gl, g0, gs, gw, gp, gu, B, S, H, st);
    case 64: return wkv::launch_bwd<64>(fr, fk, fv, fl, fu, fs, ff, fd, fg, gr, gk, gv, gl, g0, gs, gw, gp, gu, B, S, H, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"

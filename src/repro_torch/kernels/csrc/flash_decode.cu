// GQA flash attention forward for calls of few query rows (decoding), bf16,
// every head dim of K2, on Hopper (sm_90a): split-KV.
//
// Replaces, for a bf16 forward call whose query rows per kv head, Sq * G
// (G = Hq / Hkv), are at most kDecodeRows (kernels/flash_attention.py:
// DECODE_ROWS): the Pallas TPU kernel src/repro/kernels/flash_attention.py:
// 103 (flash_attention). The contract, the layouts and the arithmetic are
// flash_attention.cu's (its header): s = (q . k) * scale in f32, masked
// scores -1e30, out = acc / max(l, 1e-30), L = m + log(max(l, 1e-30)); it
// writes out (bf16), out32 and L, which a backward may read, so p enters
// P V through the hi/lo bf16 split and out32 and L keep their 2e-5 gates.
//
// What bounds it: bytes. K and V are read once (at B 4 x Sq 1 x Skv 4096 x
// 16:16 x 64, the encoder-decoder's decode step, 67 MB: 0.0200 ms at 3.35
// TB/s); the products are 4 hd FLOP a visible pair for at most 16 query
// rows of a kv head. flash_attention_sm90.cu's forward spends a 64-row
// wgmma and a block per query head on such a call (64 blocks on 132 SMs at
// that shape). What the design does about it:
// - Split over kv. decode_split_kernel's grid is (splits, Hkv, B): block
//   (sp, hk, b) reads rows sp * CHUNK .. + CHUNK - 1 of kv head hk once
//   (cp.async, 16-byte loads; K and V in two groups, the scores computed
//   while V lands) and scores all Sq * G query rows of that head against
//   them (row r = i * G + g: position i, query head hk * G + g). CHUNK is
//   256 rows at head dims up to 64 and 128 above, so the number of splits
//   depends on Skv and hd alone, never on the card: 1024 blocks at the
//   decode step's shape, two a streaming multiprocessor (76 KB of shared
//   memory each: Q, K and V, whose place the warps' partial O takes once
//   they are read). 128-row chunks at hd 64, 2048 blocks of 39 KB, took
//   longer (0.054 ms of device time against 0.047 on an H100).
// - Few rows on mma.sync. The Sq * G <= 16 query rows are one m16 tile
//   (zero rows past Sq * G): each of the 8 warps takes CHUNK / 8 kv rows,
//   S = Q K^T on m16n8k16 (exact bf16 products, f32 sums), the row max and
//   sum over the block through shared memory, then O = P_hi V + P_lo V on
//   the same MMAs (P's C fragment is the A fragment of P V: split_a), the
//   8 warps' partial O summed in shared memory in warp order. A split the
//   block test finds fully visible scores with no mask test.
// - Partials. A block writes its f32 (m, l, acc) of each row to scratch,
//   which the wrapper allocates. A row the visibility rule hides in the
//   whole split (and every row of a split the block test hides, whose K and
//   V are not read) writes m = -1e30, l = 0, acc = 0.
// - Combine. decode_combine_kernel, one warp a query row, folds the splits
//   in split order: m = max m_i, l = sum e^(m_i - m) l_i, out = sum e^(m_i
//   - m) acc_i / max(l, 1e-30) (an IEEE division), L = m + log(max(l,
//   1e-30)). No atomics: the result is bitwise the same from run to run.
//   Its loads of 8 splits are in flight at once (a load a split, one after
//   the other, took longer than the split kernel).
#include "flash_common.cuh"

namespace repro {
namespace flash {

using bf16 = __nv_bfloat16;

constexpr int kDecodeRows = 16;     // query rows a kv head: one m16 tile
constexpr int kDecodeThreads = 256; // 8 warps
constexpr int kDecodeWarps = kDecodeThreads / 32;

template <int HD> struct DecodeCfg {
  // kv rows of a split, and of each warp (one or two k16 blocks of P V)
  static constexpr int CHUNK = HD > 64 ? 128 : 256;
  static constexpr int NW = CHUNK / kDecodeWarps;
  static constexpr int LD = HD + 8;           // bf16 a shared row (+16 B)
  // columns of a P V pass: all of them up to hd 80, else 64 a pass
  static constexpr int CW = HD > 80 ? 64 : HD;
  // Q [16][LD], K and V [CHUNK][LD] bf16; row maxima and sums [8][16]
  // f32. The warps' partial O [8][16][CW] f32 overwrites K (and V, when
  // one pass reads V) once they are read.
  static constexpr int KV_BYTES = 2 * CHUNK * LD;
  static constexpr int PW_BYTES = 4 * kDecodeWarps * kDecodeRows * CW;
  static constexpr int SMEM = 2 * kDecodeRows * LD + 2 * KV_BYTES +
                              4 * 2 * kDecodeWarps * kDecodeRows;
  static_assert(NW % 16 == 0, "a warp's kv rows are whole k16 blocks");
  static_assert(HD % CW == 0 && (CW / 8) % 2 == 0, "whole n8 pairs a pass");
  static_assert(PW_BYTES <= (CW == HD ? 2 : 1) * KV_BYTES,
                "the partials fit where K (and V) were");
};

// The scaled scores of rows g and g + 8 (positions i0, i1; live0, live1:
// below Sq * G) against kv columns kc0 + 8 n + (0, 1), masked to -1e30
// where MASK and the visibility rule hides them, and their maxima. A
// split the block test finds fully visible takes MASK = false (rows past
// Sq * G then score 0: their sums are never read).
template <bool MASK, int NS>
__device__ __forceinline__ void decode_scores(float (&sc)[NS][4],
                                              float (&mx)[2], const Shape& s,
                                              int i0, int i1, bool live0,
                                              bool live1, int kc0) {
#pragma unroll
  for (int n = 0; n < NS; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = __fmul_rn(sc[n][e], s.scale);
      if (MASK) {
        const bool live = e < 2 ? live0 : live1;
        if (!live || !pair_visible(s, e < 2 ? i0 : i1, kc0 + n * 8 + (e & 1))) {
          x = kNegInf;
        }
      }
      sc[n][e] = x;
      mx[e >> 1] = fmaxf(mx[e >> 1], x);
    }
  }
}

// ROWS rows of HD bf16 (row stride `stride` elements) into shared memory
// with row stride LD; rows >= `rows` are zero-filled.
template <int HD, int ROWS, int LD>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src,
                                          long long stride, int rows) {
  constexpr int CPR = HD / 8;
  for (int c = threadIdx.x; c < ROWS * CPR; c += kDecodeThreads) {
    const int r = c / CPR, cc = c - r * CPR;
    const bool ok = r < rows;
    cp_async16(dst + r * LD + cc * 8, src + (ok ? r * stride : 0) + cc * 8,
               ok);
  }
}

// Split sp of kv head hk of batch row b: its partials acc [R][HD] and
// (m, l) [R][2] at slot (b * Hkv + hk) * splits + sp of part's two planes.
template <int HD>
__global__ void __launch_bounds__(kDecodeThreads)
decode_split_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, float* __restrict__ part,
                    Shape s, int splits) {
  using C = DecodeCfg<HD>;
  constexpr int CHUNK = C::CHUNK, NW = C::NW, LD = C::LD, CW = C::CW;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ks = Qs + kDecodeRows * LD;
  bf16* Vs = Ks + CHUNK * LD;
  float* Pw = reinterpret_cast<float*>(Ks);  // once K (and V) are read
  float* Mw = reinterpret_cast<float*>(Vs + CHUNK * LD);
  float* Lw = Mw + kDecodeWarps * kDecodeRows;
  const int sp = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int G = s.Hq / s.Hkv, R = s.Sq * G, c0 = sp * CHUNK;
  const long long slot =
      (static_cast<long long>(b) * s.Hkv + hk) * splits + sp;
  float* acc_out = part + slot * R * HD;
  float* ml_out = part +
                  static_cast<long long>(gridDim.z) * s.Hkv * splits * R * HD +
                  slot * R * 2;
  if (!tiles_visible(s, 0, s.Sq, c0, CHUNK)) {
    for (int e = threadIdx.x; e < R * HD; e += kDecodeThreads) {
      acc_out[e] = 0.0f;
    }
    for (int r = threadIdx.x; r < R; r += kDecodeThreads) {
      ml_out[2 * r] = kNegInf;
      ml_out[2 * r + 1] = 0.0f;
    }
    return;
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const long long ks = static_cast<long long>(s.Hkv) * HD;
  const long long kbase = (static_cast<long long>(b) * s.Skv + c0) * ks +
                          static_cast<long long>(hk) * HD;
  const int rows = min(CHUNK, s.Skv - c0);
  // Q's rows r = i * G + g (zero for r >= R) and K: one group; V: another
  for (int c = threadIdx.x; c < kDecodeRows * (HD / 8);
       c += kDecodeThreads) {
    const int r = c / (HD / 8), cc = c - r * (HD / 8);
    const bool ok = r < R;
    const long long off =
        ok ? ((static_cast<long long>(b) * s.Sq + r / G) * s.Hq + hk * G +
              r % G) * HD
           : 0;
    cp_async16(Qs + r * LD + cc * 8, q + off + cc * 8, ok);
  }
  load_rows<HD, CHUNK, LD>(Ks, k + kbase, ks, rows);
  cp_async_commit();
  load_rows<HD, CHUNK, LD>(Vs, v + kbase, ks, rows);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();

  // S = Q K^T over this warp's NW kv rows kw .. kw + NW - 1
  const int kw = warp * NW;
  float sc[NW / 8][4];
#pragma unroll
  for (int n = 0; n < NW / 8; ++n) sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.0f;
#pragma unroll
  for (int kk = 0; kk < HD; kk += 16) {
    uint32_t a[4];
    ldsm4(a, Qs + kk + a_off(lane, LD));
#pragma unroll
    for (int n = 0; n < NW / 8; n += 2) {
      uint32_t bb[4];
      ldsm4(bb, Ks + (kw + n * 8) * LD + kk + b_off(lane, LD));
      mma(sc[n], a, bb[0], bb[1]);
      mma(sc[n + 1], a, bb[2], bb[3]);
    }
  }
  // masked, scaled scores of rows g and g + 8; their maxima over the split
  float mx[2] = {kNegInf, kNegInf};
  if (tiles_full(s, 0, s.Sq, c0, CHUNK)) {
    decode_scores<false>(sc, mx, s, 0, 0, true, true, 0);
  } else {
    decode_scores<true>(sc, mx, s, g / G, (g + 8) / G, g < R, g + 8 < R,
                        c0 + kw + 2 * t4);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) mx[i] = quad_max(mx[i]);
  if (t4 == 0) {
    Mw[warp * kDecodeRows + g] = mx[0];
    Mw[warp * kDecodeRows + g + 8] = mx[1];
  }
  __syncthreads();
  // p = exp(s - m) with m the split's row max, 0 in a row with no visible
  // score in the split; the warp's row sums
  float m[2], rs[2] = {0.0f, 0.0f};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    m[i] = Mw[g + 8 * i];
    for (int w = 1; w < kDecodeWarps; ++w) {
      m[i] = fmaxf(m[i], Mw[w * kDecodeRows + g + 8 * i]);
    }
  }
#pragma unroll
  for (int n = 0; n < NW / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = e >> 1;
      const float p = m[i] == kNegInf ? 0.0f : expf(sc[n][e] - m[i]);
      sc[n][e] = p;
      rs[i] += p;
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) rs[i] = quad_sum(rs[i]);
  if (t4 == 0) {
    Lw[warp * kDecodeRows + g] = rs[0];
    Lw[warp * kDecodeRows + g + 8] = rs[1];
  }
  uint32_t phi[NW / 16][4], plo[NW / 16][4];
#pragma unroll
  for (int kc = 0; kc < NW / 16; ++kc) {
    split_a<NW / 8>(sc, kc, phi[kc], plo[kc]);
  }
  cp_async_wait<0>();
  __syncthreads();  // V has landed; every warp's row sums are written
  for (int r = threadIdx.x; r < R; r += kDecodeThreads) {
    float mm = Mw[r], ll = Lw[r];
    for (int w = 1; w < kDecodeWarps; ++w) {
      mm = fmaxf(mm, Mw[w * kDecodeRows + r]);
      ll += Lw[w * kDecodeRows + r];
    }
    ml_out[2 * r] = mm;
    ml_out[2 * r + 1] = ll;
  }
  // O = P_hi V + P_lo V, CW columns at a time: each warp's partial through
  // shared memory (where K was), summed over the warps in order
  for (int cb = 0; cb < HD; cb += CW) {
    float o[CW / 8][4];
#pragma unroll
    for (int n = 0; n < CW / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.0f;
#pragma unroll
    for (int kc = 0; kc < NW / 16; ++kc) {
#pragma unroll
      for (int n = 0; n < CW / 8; n += 2) {
        uint32_t bb[4];
        ldsm4_t(bb, Vs + (kw + kc * 16) * LD + cb + n * 8 + bt_off(lane, LD));
        mma(o[n], phi[kc], bb[0], bb[1]);
        mma(o[n], plo[kc], bb[0], bb[1]);
        mma(o[n + 1], phi[kc], bb[2], bb[3]);
        mma(o[n + 1], plo[kc], bb[2], bb[3]);
      }
    }
    // every warp has read K (and, in a single pass, V); a later pass: the
    // previous pass's sums have read Pw
    __syncthreads();
#pragma unroll
    for (int n = 0; n < CW / 8; ++n) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        *reinterpret_cast<float2*>(
            Pw + (warp * kDecodeRows + g + 8 * i) * CW + n * 8 + 2 * t4) =
            make_float2(o[n][2 * i], o[n][2 * i + 1]);
      }
    }
    __syncthreads();
    for (int e = threadIdx.x; e < R * CW; e += kDecodeThreads) {
      const int r = e / CW, c = e - r * CW;
      float a = Pw[r * CW + c];
      for (int w = 1; w < kDecodeWarps; ++w) {
        a += Pw[(w * kDecodeRows + r) * CW + c];
      }
      acc_out[r * HD + cb + c] = a;
    }
  }
}

// One warp a query row (b, hk, r) of the call (B * Hkv * R rows): its
// splits' partials folded in split order into out, out32 and L. The lanes
// read the splits' (m, l) 32 at a time (m = their max, exact in any
// order); then, split after split, each lane adds w_i = e^(m_i - m) times
// split i's partial of its columns, 8 splits' loads in flight at once.
__global__ void __launch_bounds__(kDecodeThreads)
decode_combine_kernel(const float* __restrict__ part, bf16* __restrict__ out,
                      float* __restrict__ out32, float* __restrict__ lse,
                      Shape s, int B, int hd, int splits) {
  constexpr int kMaxPerLane = 8;  // hd <= 256
  constexpr unsigned kAll = 0xffffffffu;
  const int G = s.Hq / s.Hkv, R = s.Sq * G;
  const long long rows = static_cast<long long>(B) * s.Hkv * R;
  const long long row = static_cast<long long>(blockIdx.x) * kDecodeWarps +
                        threadIdx.x / 32;
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  const int r = static_cast<int>(row % R);
  const long long bh = row / R;  // b * Hkv + hk
  const int hk = static_cast<int>(bh % s.Hkv), b = static_cast<int>(bh / s.Hkv);
  const float* acc = part + bh * splits * R * hd + static_cast<long long>(r) * hd;
  const float* ml = part + rows * splits * hd + bh * splits * R * 2 + 2 * r;
  const long long acc_step = static_cast<long long>(R) * hd, ml_step = 2LL * R;
  float m = kNegInf;
  for (int i = lane; i < splits; i += 32) m = fmaxf(m, ml[i * ml_step]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    m = fmaxf(m, __shfl_xor_sync(kAll, m, off));
  }
  float l = 0.0f, o[kMaxPerLane] = {};
  for (int base = 0; base < splits; base += 32) {
    const int n = min(32, splits - base);
    float wj = 0.0f, lj = 0.0f;  // split base + lane's weight and sum
    if (lane < n) {
      wj = expf(ml[(base + lane) * ml_step] - m);
      lj = ml[(base + lane) * ml_step + 1];
    }
#pragma unroll 8
    for (int j = 0; j < n; ++j) {
      const float w = __shfl_sync(kAll, wj, j);
      l += w * __shfl_sync(kAll, lj, j);
      const float* a = acc + (base + j) * acc_step;
#pragma unroll
      for (int c = 0; c < kMaxPerLane; ++c) {
        const int d = lane + 32 * c;
        if (d < hd) o[c] += w * a[d];
      }
    }
  }
  const float ls = fmaxf(l, 1e-30f);
  const long long pos = (static_cast<long long>(b) * s.Sq + r / G) * s.Hq +
                        hk * G + r % G;
#pragma unroll
  for (int c = 0; c < kMaxPerLane; ++c) {
    const int d = lane + 32 * c;
    if (d < hd) {
      const float x = __fdiv_rn(o[c], ls);
      out[pos * hd + d] = __float2bfloat16_rn(x);
      out32[pos * hd + d] = x;
    }
  }
  if (lane == 0) lse[pos] = m + logf(ls);
}

template <int HD>
int launch_decode(const void* q, const void* k, const void* v, void* out,
                  void* out32, void* lse, void* part, int B, Shape s,
                  cudaStream_t st) {
  using C = DecodeCfg<HD>;
  static std::atomic<bool> done[kMaxDevices];
  cudaError_t e = allow_smem_once(done, decode_split_kernel<HD>, C::SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int splits = cdiv(s.Skv, C::CHUNK);
  decode_split_kernel<HD><<<dim3(splits, s.Hkv, B), kDecodeThreads, C::SMEM,
                            st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<float*>(part), s, splits);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long rows =
      static_cast<long long>(B) * s.Hkv * s.Sq * (s.Hq / s.Hkv);
  decode_combine_kernel<<<static_cast<unsigned int>(
                              (rows + kDecodeWarps - 1) / kDecodeWarps),
                          kDecodeThreads, 0, st>>>(
      static_cast<const float*>(part), static_cast<bf16*>(out),
      static_cast<float*>(out32), static_cast<float*>(lse), s, B, HD, splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace flash
}  // namespace repro

using namespace repro;
using namespace repro::flash;

extern "C" {

// Forward of a bf16 call with Sq * Hq / Hkv <= 16 query rows a kv head:
// out (bf16), out32 and lse (f32), as repro_flash_fwd. part: f32 scratch of
// B * Hkv * splits * Sq * (Hq / Hkv) * (hd + 2) values, splits =
// ceil(Skv / repro_flash_decode_chunk(hd)). Returns cudaGetLastError(), or
// cudaErrorInvalidValue for another dtype, head dim or shape.
int repro_flash_decode(const void* q, const void* k, const void* v, int dtype,
                       void* out, void* out32, void* lse, void* part, int B,
                       int Sq, int Skv, int Hq, int Hkv, int hd, int causal,
                       int window, float scale, void* stream) {
  if (dtype != kBF16 || out32 == nullptr || part == nullptr ||
      bad_shape(B, Sq, Skv, Hq, Hkv) ||
      static_cast<long long>(Sq) * (Hq / Hkv) > kDecodeRows) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Shape s = make_shape(Sq, Skv, Hq, Hkv, causal, window, scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
#define REPRO_DECODE_CASE(HD)                                              \
  case HD:                                                                 \
    return launch_decode<HD>(q, k, v, out, out32, lse, part, B, s, st);
    REPRO_DECODE_CASE(16)
    REPRO_DECODE_CASE(32)
    REPRO_DECODE_CASE(64)
    REPRO_DECODE_CASE(80)
    REPRO_DECODE_CASE(128)
    REPRO_DECODE_CASE(256)
#undef REPRO_DECODE_CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// kv rows of a split at head dim hd, or -1.
int repro_flash_decode_chunk(int hd) {
  switch (hd) {
    case 16: return DecodeCfg<16>::CHUNK;
    case 32: return DecodeCfg<32>::CHUNK;
    case 64: return DecodeCfg<64>::CHUNK;
    case 80: return DecodeCfg<80>::CHUNK;
    case 128: return DecodeCfg<128>::CHUNK;
    case 256: return DecodeCfg<256>::CHUNK;
    default: return -1;
  }
}

}  // extern "C"

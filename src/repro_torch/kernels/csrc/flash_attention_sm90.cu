// GQA flash attention on Hopper's wgmma and TMA (sm_90a): the bf16
// forward, bwd_dq and bwd_dkdv at head dims 64 and 128.
//
// Replaces, for those calls:
// - the forward: the Pallas TPU kernel
//   src/repro/kernels/flash_attention.py:103 (flash_attention), except a
//   call of at most 16 query rows a kv head, which flash_decode.cu's
//   split-KV kernels take;
// - bwd_dq and bwd_dkdv: src/repro/models/attention.py:437
//   _flash_bwd_rule, the XLA backward of flash_attention_xla (D and dq,
//   then dk and dv).
// The contract, the layouts and the arithmetic are flash_attention.cu's
// (its header): s = (q . k) * scale in f32, masked scores -1e30, out =
// acc / max(l, 1e-30), L = m + log(max(l, 1e-30)); p = exp(s - L), ds =
// p (dp - D) scale; every product with an f32 operand (p, ds) takes the
// hi/lo bf16 split of that operand and two products, so out32, L and D keep
// their 2e-5 gates.
//
// What bounds it: bf16 tensor-core operations, 989 TFLOP/s dense on the
// H100 SXM, counted per visible (q, k) pair as chip_smoke.flash_work counts
// them: 4 hd FLOP forward, 6 hd in bwd_dq, 8 hd in bwd_dkdv. The split
// makes the issued products 6 hd forward, 8 hd in bwd_dq and 12 hd in
// bwd_dkdv. What the design does about it:
// - wgmma. Four warps issue one asynchronous m64nNk16 product from shared
//   memory (SS) or with A in registers (RS); the accumulators stay in
//   registers. A warpgroup's C fragment of S (or S^T) is, per warp, the A
//   fragment of the next product, so P (or P^T, dS^T) goes from the
//   accumulator to the RS operand by the split alone (flash_common.cuh:
//   split_a), as FlashAttention-3 does for 16-bit types.
// - TMA. q/k/v/dout are (B, S, H, hd) contiguous bf16: a 4-D tensor map
//   over (hd, H, S, B) with a box of (64, 1, rows, 1) and the 128-byte
//   swizzle; a box row is 128 bytes, one swizzle row, and head dim 128
//   takes two boxes a tile, stored one after the other. Rows past S are
//   zero-filled (a zero k row scores 0, not -1e30: the element mask hides
//   it, and stores past Sq or Skv are clipped). The wgmma descriptors use
//   the same swizzle: K-major operands (Q and K in S = Q K^T) step 32
//   bytes along a box row for each k16 and a box for each 64 columns;
//   MN-major operands (V in O += P V, K in dQ += dS K, dO and Q in dV and
//   dK) step 16 rows (2048 bytes) for each k16, and their N = hd spans the boxes, whose
//   stride is the descriptor's leading byte offset. The maps are encoded
//   on the host for each call (common.cuh: encode_tiled) and passed as
//   __grid_constant__ parameters; they hold raw pointers, which a CUDA
//   graph's replay keeps.
// - Warp specialisation. 384 threads: warpgroups 0 and 1 compute, 2 loads.
//   One producer thread keeps the next tiles in flight in a ring of full
//   and empty mbarriers; setmaxnreg gives the producer warpgroup 24
//   registers and each consumer thread 240 (ptxas: 168 at launch, no
//   spills). The two consumer warpgroups overlap each other: one's
//   softmax runs beside the other's products.
// - The elementwise work per score, not the products, is what is left at
//   hd 64 (the accurate expf, the hi/lo split, the mask): a tile that the
//   block test finds fully visible takes a copy of the pass with no mask
//   test in it (scores<false>, probs<false>), and descriptors of tiles
//   that stay put are rebuilt in the loop rather than held in registers.
//
// Forward (wg_fwd_kernel). Grid (Hq, B, q tiles), the heaviest causal q
// tile first. A block owns 128 q rows, 64 per consumer warpgroup. The
// producer loads Q once, then each visible kv tile (128 rows of K and V)
// into a ring of 2 stages. A consumer warpgroup: S = Q K^T (SS, m64n128,
// hd / 16 steps); the element mask only where the tile is not fully
// visible to its 64 rows (tiles the reference's block test hides are not
// loaded); the online softmax in registers; O += P_hi V + P_lo V (RS,
// m64n{hd}, 8 k steps each). Shared memory at hd 128: Q 32 KB + 2 x (K, V)
// 64 KB = 160 KB (+ 1 KB of alignment); at hd 64 half.
//
// bwd_dq (wg_bwd_dq_kernel), the forward's structure. Grid (Hq, B, q
// tiles), the heaviest causal q tile first. A block owns 128 q rows, 64
// per consumer warpgroup. The producer loads Q and dO once by TMA, then
// each visible kv tile (BKV rows of K and V: 128 at hd 64, 64 at hd 128)
// into a ring (2 stages at hd 64, 3 at hd 128). While Q and dO land, each
// consumer warp computes D = rowsum(f32(dO) out32) of its 16 rows from
// device memory (16-byte loads, two lanes a row), writes it to delta and
// keeps D and L of its two rows a thread in registers. A consumer
// warpgroup, per kv tile: S = Q K^T and dP = dO V^T (SS, m64n{BKV}, both
// K-major); p = exp(S scale - L) and dS = p (dP - D) scale in registers
// (the element mask only where the tile is not fully visible to its 64
// rows); dQ += dS_hi K + dS_lo K (RS, m64n{hd}, K read MN-major as V is
// in the forward). dq stays in registers (hd / 2 floats a thread) and is
// rounded once to bf16 at the end; no atomics, a fixed order. Registers:
// dq, S and dP (BKV / 2 each) and dS's fragments: at hd 128 the 64-row kv
// tile keeps them inside 240. Shared memory at hd 128: Q, dO 64 KB + 3 x
// (K, V) 96 KB = 160 KB (+ 1 KB of alignment); at hd 64 Q, dO 32 KB + 2 x
// 64 KB = 96 KB.
//
// bwd_dkdv (wg_bwd_dkdv_kernel). Grid (Hkv, B, kv tiles), kv tile 0 (seen
// by every causal q tile) first. A block owns 64 kv rows of one kv head
// and computes their dk and dv over all G = Hq / Hkv query heads, so no
// per-head partials reach device memory and no second kernel sums them.
// The producer loads K and V once, then streams the items (g = 0..G-1,
// then the visible q tiles of BQ rows in order; BQ 64, 32 at hd 128)
// through a ring of 4 stages: Q and dO by TMA from one thread, L and D
// (f32, Hq apart, which no TMA box can gather) by warps 1 and 2 of the
// producer warpgroup, one for the items of each consumer warpgroup.
// Consumer warpgroup w takes the items j = w, w + 2, ...: S^T = K Q^T and
// dP^T = V dO^T (SS, m64n{BQ}), P^T = exp(S^T - L), dS^T = P^T (dP^T -
// D) scale, dV += P^T_hi dO + P^T_lo dO and dK += dS^T_hi Q + dS^T_lo Q
// (RS, m64n{hd}). Each warpgroup's dk and dv stay in registers (128 a
// thread at hd 128, which is why its q tile is 32 rows: 64 spilled) until
// the end; then the two partial sums are added in shared memory
// (warpgroup 0's + warpgroup 1's) and rounded once to bf16. The order of
// every sum is fixed: deterministic, no atomics. Two warpgroups on
// alternate items of one 64-row kv tile, rather than one 128-row tile,
// keep the grid at Skv / 64 blocks a head: at 64:4 heads, batch 1 and S
// 4096 that is 256 blocks, heaviest first, where 128-row tiles would give
// 128 blocks of very unequal (causal) work on 132 SMs. Shared memory: K,
// V 32 KB + 4 x (Q, dO) 64 KB + L, D 1 KB = 97 KB at hd 128 (+ 1 KB of
// alignment), 82 KB at hd 64.
//
// Not done: intra-warpgroup overlap of one tile's softmax with the next
// tile's S = Q K^T (FlashAttention-3's second stage of pipelining; at hd
// 128 the registers of a second S tile are not there beside the split P),
// and one kernel for both backward halves (dq by atomics, as
// FlashAttention-3 does, would give up the fixed order). Calls of at most
// 16 query rows a kv head (decoding) take flash_decode.cu's forward.
#include "flash_common.cuh"

namespace repro {
namespace flash {
namespace wg {

using bf16 = __nv_bfloat16;

constexpr int kBox = 64;        // head-dim columns of a TMA box
constexpr int kRow = 128;       // bytes of a box row: one 128B-swizzle row
constexpr int kThreads = 384;   // warpgroups 0 and 1 compute, 2 loads
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;

template <int HD> struct FwdCfg {
  static constexpr int BQ = 128, BKV = 128, STAGES = 2;
  static constexpr int Q_BYTES = BQ * HD * 2, KV_BYTES = BKV * HD * 2;
  // 1 KB to align the base for the swizzle, Q, the K and V ring, barriers
  static constexpr int SMEM =
      1024 + Q_BYTES + STAGES * 2 * KV_BYTES + 8 * (1 + 2 * STAGES);
};

template <int HD> struct DqCfg {
  // kv tiles of 64 rows at hd 128: S and dP (BKV / 2 registers a thread
  // each) beside dq (HD / 2) and dS's hi and lo fragments fit in 240
  static constexpr int BQ = 128, BKV = HD > 64 ? 64 : 128;
  static constexpr int STAGES = HD > 64 ? 3 : 2;
  static constexpr int Q_BYTES = BQ * HD * 2, KV_BYTES = BKV * HD * 2;
  // alignment, Q and dO, the K and V ring, barriers
  static constexpr int SMEM =
      1024 + 2 * Q_BYTES + STAGES * 2 * KV_BYTES + 8 * (1 + 2 * STAGES);
};

template <int HD> struct DkdvCfg {
  // q tiles of 32 rows at hd 128: with 64, S^T and dP^T (64 registers a
  // thread) beside dk and dv (128) leave too few of the 240 and spill
  static constexpr int BKV = 64, BQ = HD > 64 ? 32 : 64, STAGES = 4;
  static constexpr int KV_BYTES = BKV * HD * 2, Q_BYTES = BQ * HD * 2;
  // alignment, K, V, the Q and dO ring, L and D of each stage, barriers
  static constexpr int SMEM = 1024 + 2 * KV_BYTES + 2 * STAGES * Q_BYTES +
                              2 * STAGES * BQ * 4 + 8 * (1 + 2 * STAGES);
  // the two warpgroups' partial dk or dv (hd / 2 floats a thread each)
  // are exchanged in the consumed Q and dO ring
  static_assert(HD * 128 * 4 <= 2 * STAGES * Q_BYTES, "exchange fits");
  static_assert(STAGES % 2 == 0, "a stage serves one warpgroup");
};

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024u - (smem_u32(p) & 1023u)) & 1023u);
}

// A (64, 1, ROWS, 1) box of the map at (col, h, row, b), completing on bar.
__device__ __forceinline__ void tma_load4(void* dst, const CUtensorMap* map,
                                          uint64_t* bar, int col, int h,
                                          int row, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(col),
      "r"(h), "r"(row), "r"(b)
      : "memory");
}

// Rows row .. row + ROWS - 1 of head h of batch row b: HD / 64 boxes of
// ROWS x 64, one after the other.
template <int HD, int ROWS>
__device__ __forceinline__ void tma_tile(bf16* dst, const CUtensorMap* map,
                                         uint64_t* bar, int h, int row,
                                         int b) {
#pragma unroll
  for (int c = 0; c < HD / kBox; ++c) {
    tma_load4(dst + c * ROWS * kBox, map, bar, c * kBox, h, row, b);
  }
}

// wgmma shared-memory descriptor of a 128B-swizzled operand: start address,
// leading byte offset `lbo`, stride byte offset 1024 (8 rows of 128 bytes).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo) {
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}
// K-major operand of a tile of ROWS rows: its descriptor, and what k
// block kk (16 columns) adds to it (the start address, in 16-byte units).
__device__ __forceinline__ uint64_t desc_k(uint32_t tile) {
  return sw128_desc(tile, 16);
}
template <int ROWS> __device__ __forceinline__ uint32_t step_k(int kk) {
  return ((kk / 4) * ROWS * kRow + (kk % 4) * 32) >> 4;
}
// MN-major operand of a tile of ROWS rows (N runs along the row and on
// into the next box, ROWS * 128 bytes on), and what k block kc (16 rows)
// adds to it.
template <int ROWS>
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile) {
  return sw128_desc(tile, ROWS * kRow);
}
__device__ __forceinline__ uint32_t step_mn(int kc) {
  return (kc * 16 * kRow) >> 4;
}
// d, recomputed where it is used: a descriptor of a tile that stays put
// (Q in the forward, K and V in bwd_dkdv) would otherwise be hoisted out
// of the loop with every k step's value, a register pair each, live
// across all of it.
__device__ __forceinline__ uint64_t here(uint64_t d) {
  asm volatile("" : "+l"(d));
  return d;
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// After wg_wait: the accumulators are read no earlier than here.
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N][4]) {
#pragma unroll
  for (int n = 0; n < N; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[n][e])::"memory");
  }
}

template <int R> __device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R> __device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

// d (64 x N f32, as n8 blocks d[N / 8][4]) += A B, bf16 operands:
// ss: A and B K-major in shared memory; rs: A in registers (one k16 block,
// a[4]), B MN-major in shared memory.
#define WG_D8(n)                                                           \
  "+f"(d[n][0]), "+f"(d[n][1]), "+f"(d[n][2]), "+f"(d[n][3]),              \
      "+f"(d[n + 1][0]), "+f"(d[n + 1][1]), "+f"(d[n + 1][2]),             \
      "+f"(d[n + 1][3])
#define WG_D16 WG_D8(0), WG_D8(2)
#define WG_D32 WG_D16, WG_D8(4), WG_D8(6)
#define WG_D64 WG_D32, WG_D8(8), WG_D8(10), WG_D8(12), WG_D8(14)
#define WG_R16                                                             \
  "{" "%0, %1, %2, %3, %4, %5, %6, %7, "                                   \
  "%8, %9, %10, %11, %12, %13, %14, %15" "}"
#define WG_R32                                                             \
  "{" "%0, %1, %2, %3, %4, %5, %6, %7, "                                   \
  "%8, %9, %10, %11, %12, %13, %14, %15, "                                 \
  "%16, %17, %18, %19, %20, %21, %22, %23, "                               \
  "%24, %25, %26, %27, %28, %29, %30, %31" "}"
#define WG_R64                                                             \
  "{" "%0, %1, %2, %3, %4, %5, %6, %7, "                                   \
  "%8, %9, %10, %11, %12, %13, %14, %15, "                                 \
  "%16, %17, %18, %19, %20, %21, %22, %23, "                               \
  "%24, %25, %26, %27, %28, %29, %30, %31, "                               \
  "%32, %33, %34, %35, %36, %37, %38, %39, "                               \
  "%40, %41, %42, %43, %44, %45, %46, %47, "                               \
  "%48, %49, %50, %51, %52, %53, %54, %55, "                               \
  "%56, %57, %58, %59, %60, %61, %62, %63" "}"

template <int N> struct Mma;

template <> struct Mma<32> {
  __device__ static void ss(float (&d)[4][4], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 " WG_R16
        ", %16, %17, p, 1, 1, 0, 0;\n}\n"
        : WG_D16
        : "l"(a), "l"(b), "r"(1));
  }
};

template <> struct Mma<64> {
  __device__ static void ss(float (&d)[8][4], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_R32
        ", %32, %33, p, 1, 1, 0, 0;\n}\n"
        : WG_D32
        : "l"(a), "l"(b), "r"(1));
  }
  __device__ static void rs(float (&d)[8][4], const uint32_t (&a)[4],
                            uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_R32
        ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : WG_D32
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <> struct Mma<128> {
  __device__ static void ss(float (&d)[16][4], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " WG_R64
        ", %64, %65, p, 1, 1, 0, 0;\n}\n"
        : WG_D64
        : "l"(a), "l"(b), "r"(1));
  }
  __device__ static void rs(float (&d)[16][4], const uint32_t (&a)[4],
                            uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " WG_R64
        ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : WG_D64
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

#undef WG_D8
#undef WG_D16
#undef WG_D32
#undef WG_D64
#undef WG_R16
#undef WG_R32
#undef WG_R64

template <int N> __device__ __forceinline__ void zero(float (&d)[N][4]) {
#pragma unroll
  for (int n = 0; n < N; ++n) d[n][0] = d[n][1] = d[n][2] = d[n][3] = 0.0f;
}

// The forward's scores s = (q . k) * scale of a thread's rows qr and qr + 8
// and columns kc + 8 n + (0, 1), masked to -1e30 where MASK and hidden,
// and their row maxima folded into mx. A tile the block test finds fully
// visible takes MASK = false: no per-element test.
template <bool MASK, int NS>
__device__ __forceinline__ void scores(float (&sc)[NS][4], float (&mx)[2],
                                       const Shape& s, int qr, int kc) {
#pragma unroll
  for (int n = 0; n < NS; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = __fmul_rn(sc[n][e], s.scale);
      if (MASK && !pair_visible(s, qr + (e >> 1) * 8, kc + n * 8 + (e & 1))) {
        x = kNegInf;
      }
      sc[n][e] = x;
      mx[e >> 1] = fmaxf(mx[e >> 1], x);
    }
  }
}

// bwd_dkdv: from S^T and dP^T (kv rows kr and kr + 8, q columns q0 +
// 8 n + 2 t4 + (0, 1)), p^T = exp(s - L) (0 for q rows past Sq) and
// ds^T = p (dp - D) scale, masked as scores(), each k block (16 q
// columns) split at once into the RS operands of dV += P^T dO (phi, plo)
// and dK += dS^T Q (dhi, dlo), so that few of the f32 values live at once.
template <bool MASK, int NS>
__device__ __forceinline__ void probs(float (&sc)[NS][4], float (&dp)[NS][4],
                                      uint32_t (&phi)[NS / 2][4],
                                      uint32_t (&plo)[NS / 2][4],
                                      uint32_t (&dhi)[NS / 2][4],
                                      uint32_t (&dlo)[NS / 2][4],
                                      const float* Lt, const float* Dt,
                                      const Shape& s, int q0, int kr,
                                      int t4) {
#pragma unroll
  for (int kc = 0; kc < NS / 2; ++kc) {
#pragma unroll
    for (int n = 2 * kc; n < 2 * kc + 2; ++n) {
      const int qc = n * 8 + 2 * t4;
      const float2 lv = *reinterpret_cast<const float2*>(Lt + qc);
      const float2 dv = *reinterpret_cast<const float2*>(Dt + qc);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qp = q0 + qc + (e & 1);
        float x = __fmul_rn(sc[n][e], s.scale);
        if (MASK && !pair_visible(s, qp, kr + 8 * (e >> 1))) x = kNegInf;
        const float p = (!MASK || qp < s.Sq)
                            ? expf(x - ((e & 1) ? lv.y : lv.x)) : 0.0f;
        dp[n][e] = __fmul_rn(p * (dp[n][e] - ((e & 1) ? dv.y : dv.x)),
                             s.scale);  // ds^T
        sc[n][e] = p;                   // p^T
      }
    }
    split_a<NS>(sc, kc, phi[kc], plo[kc]);
    split_a<NS>(dp, kc, dhi[kc], dlo[kc]);
  }
}

// bwd_dq: from S and dP (q rows qr and qr + 8, kv columns kc0 + 8 n +
// (0, 1)), p = exp(s - L) and ds = p (dp - D) scale, masked as scores(),
// each k block (16 kv columns) split at once into the RS operands of dQ +=
// dS K. Rows past Sq have zero Q and dO rows, L = D = 0: ds = 0.
template <bool MASK, int NS>
__device__ __forceinline__ void dscores(float (&sc)[NS][4],
                                        float (&dp)[NS][4],
                                        uint32_t (&dhi)[NS / 2][4],
                                        uint32_t (&dlo)[NS / 2][4],
                                        const float (&Lr)[2],
                                        const float (&Dr)[2], const Shape& s,
                                        int qr, int kc0) {
#pragma unroll
  for (int kc = 0; kc < NS / 2; ++kc) {
#pragma unroll
    for (int n = 2 * kc; n < 2 * kc + 2; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        float x = __fmul_rn(sc[n][e], s.scale);
        if (MASK && !pair_visible(s, qr + 8 * i, kc0 + n * 8 + (e & 1))) {
          x = kNegInf;
        }
        const float p = expf(x - Lr[i]);
        dp[n][e] = __fmul_rn(p * (dp[n][e] - Dr[i]), s.scale);
      }
    }
    split_a<NS>(dp, kc, dhi[kc], dlo[kc]);
  }
}

// ---------------------------------------------------------------------------
// Forward. Shared memory: Q [HD / 64][BQ][64]; stage st: K, V
// [HD / 64][BKV][64] each; barriers q_full, full[STAGES], empty[STAGES].
template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
wg_fwd_kernel(const __grid_constant__ CUtensorMap tq,
              const __grid_constant__ CUtensorMap tk,
              const __grid_constant__ CUtensorMap tv, bf16* __restrict__ out,
              float* __restrict__ out32, float* __restrict__ lse, Shape s) {
  using C = FwdCfg<HD>;
  constexpr int BQ = C::BQ, BKV = C::BKV, ST = C::STAGES;
  constexpr int NS = BKV / 8, ND = HD / 8;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = align1024(smem_raw);
  bf16* Qs = reinterpret_cast<bf16*>(base);
  bf16* KVs = reinterpret_cast<bf16*>(base + C::Q_BYTES);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(
      base + C::Q_BYTES + ST * 2 * C::KV_BYTES);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + ST;
  const int h = blockIdx.x, b = blockIdx.y, hk = h / (s.Hq / s.Hkv);
  const int q0 = (cdiv(s.Sq, BQ) - 1 - static_cast<int>(blockIdx.z)) * BQ;
  int t0, t1;
  kv_range<BQ, BKV>(s, q0, t0, t1);
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int i = 0; i < ST; ++i) {
      mbar_init(&full[i], 1);   // the producer's arrive.expect_tx
      mbar_init(&empty[i], 8);  // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int wgi = threadIdx.x / 128;
  if (wgi == 2) {
    regs_dec<kProducerRegs>();
    if (threadIdx.x == 256) {
      mbar_expect_tx(q_full, C::Q_BYTES);
      tma_tile<HD, BQ>(Qs, &tq, q_full, h, q0, b);
      for (int t = t0; t <= t1; ++t) {
        const int i = t - t0, st = i % ST;
        bf16* Ks = KVs + st * 2 * BKV * HD;
        mbar_wait(&empty[st], ((i / ST) & 1) ^ 1);
        mbar_expect_tx(&full[st], 2 * C::KV_BYTES);
        tma_tile<HD, BKV>(Ks, &tk, &full[st], hk, t * BKV, b);
        tma_tile<HD, BKV>(Ks + BKV * HD, &tv, &full[st], hk, t * BKV, b);
      }
    }
  } else {
    regs_inc<kConsumerRegs>();
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int g = lane >> 2, t4 = lane & 3;
    const int r0 = wgi * 64 + warp * 16;  // this warp's rows of the q tile
    const uint32_t q_tile = smem_u32(Qs) + wgi * 64 * kRow;
    float o[ND][4], m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};
    zero(o);
    mbar_wait(q_full, 0);
    for (int t = t0; t <= t1; ++t) {
      const int i = t - t0, st = i % ST, k0 = t * BKV;
      const uint32_t k_tile = smem_u32(KVs) + st * 2 * C::KV_BYTES;
      const uint32_t v_tile = k_tile + C::KV_BYTES;
      mbar_wait(&full[st], (i / ST) & 1);
      // S = Q K^T
      float sc[NS][4];
      zero(sc);
      const uint64_t qd = here(desc_k(q_tile)), kd = desc_k(k_tile);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        Mma<BKV>::ss(sc, qd + step_k<BQ>(kk), kd + step_k<BKV>(kk));
      }
      wg_commit();
      wg_wait();
      fence_acc(sc);
      float mx[2] = {m[0], m[1]};
      if (tiles_full(s, q0 + wgi * 64, 64, k0, BKV)) {
        scores<false>(sc, mx, s, q0 + r0 + g, k0 + 2 * t4);
      } else {
        scores<true>(sc, mx, s, q0 + r0 + g, k0 + 2 * t4);
      }
      float corr[2], rs[2] = {0.0f, 0.0f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = quad_max(mx[r]);
        corr[r] = expf(m[r] - mx[r]);
        m[r] = mx[r];
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
      for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + quad_sum(rs[r]);
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        o[n][0] *= corr[0]; o[n][1] *= corr[0];
        o[n][2] *= corr[1]; o[n][3] *= corr[1];
      }
      // O += P_hi V + P_lo V
      uint32_t phi[BKV / 16][4], plo[BKV / 16][4];
#pragma unroll
      for (int kc = 0; kc < BKV / 16; ++kc) {
        split_a<NS>(sc, kc, phi[kc], plo[kc]);
      }
      const uint64_t vd = desc_mn<BKV>(v_tile);
      wg_fence();
#pragma unroll
      for (int kc = 0; kc < BKV / 16; ++kc) {
        Mma<HD>::rs(o, phi[kc], vd + step_mn(kc));
        Mma<HD>::rs(o, plo[kc], vd + step_mn(kc));
      }
      wg_commit();
      wg_wait();
      fence_acc(o);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[st]);  // stage st is read
    }
    const long long qs = static_cast<long long>(s.Hq) * HD;
    const long long qbase = (static_cast<long long>(b) * s.Sq + q0) * qs +
                            static_cast<long long>(h) * HD;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + g + 8 * r;
      if (q0 + row >= s.Sq) continue;
      const float ls = fmaxf(l[r], 1e-30f);
      const long long off = qbase + row * qs;
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        const int c = n * 8 + 2 * t4;
        const float a = __fdiv_rn(o[n][2 * r], ls);
        const float bv = __fdiv_rn(o[n][2 * r + 1], ls);
        *reinterpret_cast<__nv_bfloat162*>(out + off + c) =
            __floats2bfloat162_rn(a, bv);
        *reinterpret_cast<float2*>(out32 + off + c) = make_float2(a, bv);
      }
      if (t4 == 0) {
        lse[(static_cast<long long>(b) * s.Sq + q0 + row) * s.Hq + h] =
            m[r] + logf(ls);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bwd_dq. Shared memory: Q, dO [HD / 64][BQ][64]; stage st: K, V
// [HD / 64][BKV][64]; barriers q_full, full[STAGES], empty[STAGES].
template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
wg_bwd_dq_kernel(const __grid_constant__ CUtensorMap tq,
                 const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv,
                 const __grid_constant__ CUtensorMap tdo,
                 const float* __restrict__ out32,
                 const bf16* __restrict__ dout,
                 const float* __restrict__ lse, float* __restrict__ delta,
                 bf16* __restrict__ dq, Shape s) {
  using C = DqCfg<HD>;
  constexpr int BQ = C::BQ, BKV = C::BKV, ST = C::STAGES;
  constexpr int NS = BKV / 8, ND = HD / 8;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = align1024(smem_raw);
  bf16* Qs = reinterpret_cast<bf16*>(base);
  bf16* dOs = Qs + BQ * HD;
  bf16* KVs = dOs + BQ * HD;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(
      base + 2 * C::Q_BYTES + ST * 2 * C::KV_BYTES);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + ST;
  const int h = blockIdx.x, b = blockIdx.y, hk = h / (s.Hq / s.Hkv);
  const int q0 = (cdiv(s.Sq, BQ) - 1 - static_cast<int>(blockIdx.z)) * BQ;
  int t0, t1;
  kv_range<BQ, BKV>(s, q0, t0, t1);
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int i = 0; i < ST; ++i) {
      mbar_init(&full[i], 1);   // the producer's arrive.expect_tx
      mbar_init(&empty[i], 8);  // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int wgi = threadIdx.x / 128;
  if (wgi == 2) {
    regs_dec<kProducerRegs>();
    if (threadIdx.x == 256) {
      mbar_expect_tx(q_full, 2 * C::Q_BYTES);
      tma_tile<HD, BQ>(Qs, &tq, q_full, h, q0, b);
      tma_tile<HD, BQ>(dOs, &tdo, q_full, h, q0, b);
      for (int t = t0; t <= t1; ++t) {
        const int i = t - t0, st = i % ST;
        bf16* Ks = KVs + st * 2 * BKV * HD;
        mbar_wait(&empty[st], ((i / ST) & 1) ^ 1);
        mbar_expect_tx(&full[st], 2 * C::KV_BYTES);
        tma_tile<HD, BKV>(Ks, &tk, &full[st], hk, t * BKV, b);
        tma_tile<HD, BKV>(Ks + BKV * HD, &tv, &full[st], hk, t * BKV, b);
      }
    }
  } else {
    regs_inc<kConsumerRegs>();
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int g = lane >> 2, t4 = lane & 3;
    const int r0 = wgi * 64 + warp * 16;  // this warp's rows of the q tile
    const long long qs = static_cast<long long>(s.Hq) * HD;
    const long long qbase = (static_cast<long long>(b) * s.Sq + q0) * qs +
                            static_cast<long long>(h) * HD;
    const long long lbase =
        (static_cast<long long>(b) * s.Sq + q0) * s.Hq + h;
    // D = rowsum(f32(dout) * out_f32) of the warp's 16 rows, while the TMA
    // loads Q and dO: lane l sums half l % 2 of row l / 2 (16-byte loads),
    // the pair of lanes adds the halves, and each thread takes D of its
    // rows g and g + 8 from their pairs. L of those rows likewise stays
    // in registers (0 past Sq, where dO is zero: ds = 0).
    float Dr[2], Lr[2];
    {
      const int row = r0 + (lane >> 1);
      float part = 0.0f;
      if (q0 + row < s.Sq) {
        const long long off = qbase + row * qs + (lane & 1) * (HD / 2);
#pragma unroll
        for (int c = 0; c < HD / 2; c += 8) {
          const uint4 raw = *reinterpret_cast<const uint4*>(dout + off + c);
          const float4 o0 = *reinterpret_cast<const float4*>(out32 + off + c);
          const float4 o1 =
              *reinterpret_cast<const float4*>(out32 + off + c + 4);
          const __nv_bfloat162* d2 =
              reinterpret_cast<const __nv_bfloat162*>(&raw);
          const float2 a = __bfloat1622float2(d2[0]);
          const float2 bb = __bfloat1622float2(d2[1]);
          const float2 cc = __bfloat1622float2(d2[2]);
          const float2 dd = __bfloat1622float2(d2[3]);
          part = fmaf(a.x, o0.x, part);
          part = fmaf(a.y, o0.y, part);
          part = fmaf(bb.x, o0.z, part);
          part = fmaf(bb.y, o0.w, part);
          part = fmaf(cc.x, o1.x, part);
          part = fmaf(cc.y, o1.y, part);
          part = fmaf(dd.x, o1.z, part);
          part = fmaf(dd.y, o1.w, part);
        }
      }
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      if ((lane & 1) == 0 && q0 + row < s.Sq) {
        delta[lbase + row * s.Hq] = part;
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        Dr[r] = __shfl_sync(0xffffffffu, part, 2 * (g + 8 * r));
        const int q = q0 + r0 + g + 8 * r;
        Lr[r] = q < s.Sq ? lse[lbase + (r0 + g + 8 * r) * s.Hq] : 0.0f;
      }
    }
    const uint32_t q_tile = smem_u32(Qs) + wgi * 64 * kRow;
    const uint32_t do_tile = smem_u32(dOs) + wgi * 64 * kRow;
    float dqa[ND][4];
    zero(dqa);
    mbar_wait(q_full, 0);
    for (int t = t0; t <= t1; ++t) {
      const int i = t - t0, st = i % ST, k0 = t * BKV;
      const uint32_t k_tile = smem_u32(KVs) + st * 2 * C::KV_BYTES;
      const uint32_t v_tile = k_tile + C::KV_BYTES;
      mbar_wait(&full[st], (i / ST) & 1);
      // S = Q K^T and dP = dO V^T: 64 q rows x BKV kv columns
      float sc[NS][4], dp[NS][4];
      zero(sc);
      zero(dp);
      const uint64_t qd = here(desc_k(q_tile)), dod = here(desc_k(do_tile));
      const uint64_t kd = desc_k(k_tile), vd = desc_k(v_tile);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        Mma<BKV>::ss(sc, qd + step_k<BQ>(kk), kd + step_k<BKV>(kk));
      }
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        Mma<BKV>::ss(dp, dod + step_k<BQ>(kk), vd + step_k<BKV>(kk));
      }
      wg_commit();
      wg_wait();
      fence_acc(sc);
      fence_acc(dp);
      // dQ += dS_hi K + dS_lo K (K read MN-major, as V in the forward)
      uint32_t dhi[BKV / 16][4], dlo[BKV / 16][4];
      if (tiles_full(s, q0 + wgi * 64, 64, k0, BKV)) {
        dscores<false>(sc, dp, dhi, dlo, Lr, Dr, s, q0 + r0 + g,
                       k0 + 2 * t4);
      } else {
        dscores<true>(sc, dp, dhi, dlo, Lr, Dr, s, q0 + r0 + g, k0 + 2 * t4);
      }
      const uint64_t km = desc_mn<BKV>(k_tile);
      wg_fence();
#pragma unroll
      for (int kc = 0; kc < BKV / 16; ++kc) {
        Mma<HD>::rs(dqa, dhi[kc], km + step_mn(kc));
        Mma<HD>::rs(dqa, dlo[kc], km + step_mn(kc));
      }
      wg_commit();
      wg_wait();
      fence_acc(dqa);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[st]);  // stage st is read
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + g + 8 * r;
      if (q0 + row >= s.Sq) continue;
      const long long off = qbase + row * qs;
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        *reinterpret_cast<__nv_bfloat162*>(dq + off + n * 8 + 2 * t4) =
            __floats2bfloat162_rn(dqa[n][2 * r], dqa[n][2 * r + 1]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bwd_dkdv. Shared memory: K, V [HD / 64][BKV][64]; Q, dO
// [STAGES][HD / 64][BQ][64]; L, D [STAGES][BQ] f32; barriers kv_full,
// full[STAGES], empty[STAGES].
template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
wg_bwd_dkdv_kernel(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   const __grid_constant__ CUtensorMap tdo,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, bf16* __restrict__ dk,
                   bf16* __restrict__ dv, Shape s) {
  using C = DkdvCfg<HD>;
  constexpr int BQ = C::BQ, BKV = C::BKV, ST = C::STAGES;
  constexpr int NS = BQ / 8, ND = HD / 8;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = align1024(smem_raw);
  bf16* Ks = reinterpret_cast<bf16*>(base);
  bf16* Vs = Ks + BKV * HD;
  bf16* Qs = Vs + BKV * HD;
  bf16* dOs = Qs + ST * BQ * HD;
  float* Ls = reinterpret_cast<float*>(dOs + ST * BQ * HD);
  float* Ds = Ls + ST * BQ;
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(Ds + ST * BQ);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + ST;
  const int hk = blockIdx.x, b = blockIdx.y, G = s.Hq / s.Hkv;
  const int k0 = static_cast<int>(blockIdx.z) * BKV;
  int u0, u1;
  q_range<BQ, BKV>(s, k0, u0, u1);
  const int nu = max(u1 - u0 + 1, 0), items = G * nu;
  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int i = 0; i < ST; ++i) {
      mbar_init(&full[i], 1 + 32);  // expect_tx, and the L/D warp's lanes
      mbar_init(&empty[i], 4);      // lane 0 of each warp of one warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int wgi = threadIdx.x / 128;
  if (wgi == 2) {
    regs_dec<kProducerRegs>();
    const int pw = (threadIdx.x - 256) / 32, lane = threadIdx.x % 32;
    if (pw == 0) {
      if (lane == 0) {
        mbar_expect_tx(kv_full, 2 * C::KV_BYTES);
        tma_tile<HD, BKV>(Ks, &tk, kv_full, hk, k0, b);
        tma_tile<HD, BKV>(Vs, &tv, kv_full, hk, k0, b);
        for (int j = 0; j < items; ++j) {
          const int h = hk * G + j / nu, q0 = (u0 + j % nu) * BQ;
          const int st = j % ST;
          mbar_wait(&empty[st], ((j / ST) & 1) ^ 1);
          mbar_expect_tx(&full[st], 2 * C::Q_BYTES);
          tma_tile<HD, BQ>(Qs + st * BQ * HD, &tq, &full[st], h, q0, b);
          tma_tile<HD, BQ>(dOs + st * BQ * HD, &tdo, &full[st], h, q0, b);
        }
      }
    } else if (pw < 3) {
      // L and D of the items of consumer warpgroup pw - 1 (j % 2 == pw -
      // 1), in order: a barrier's parity names its phase only while its
      // waiter skips no use of the stage. Lane i loads rows i (and i + 32)
      // (zero past Sq) before it waits for the stage.
      constexpr int R = BQ / 32;
      for (int j = pw - 1; j < items; j += 2) {
        const int h = hk * G + j / nu, q0 = (u0 + j % nu) * BQ;
        const int st = j % ST;
        float lv[R], dv_[R];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int q = q0 + lane + 32 * r;
          const long long off =
              (static_cast<long long>(b) * s.Sq + q) * s.Hq + h;
          lv[r] = q < s.Sq ? lse[off] : 0.0f;
          dv_[r] = q < s.Sq ? delta[off] : 0.0f;
        }
        mbar_wait(&empty[st], ((j / ST) & 1) ^ 1);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          Ls[st * BQ + lane + 32 * r] = lv[r];
          Ds[st * BQ + lane + 32 * r] = dv_[r];
        }
        mbar_arrive(&full[st]);
      }
    }
  } else {
    regs_inc<kConsumerRegs>();
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int g = lane >> 2, t4 = lane & 3;
    const int r0 = warp * 16;  // this warp's kv rows
    const uint32_t k_tile = smem_u32(Ks), v_tile = smem_u32(Vs);
    float dka[ND][4], dva[ND][4];
    zero(dka);
    zero(dva);
    mbar_wait(kv_full, 0);
    for (int j = wgi; j < items; j += 2) {
      const int q0 = (u0 + j % nu) * BQ, st = j % ST;
      const uint32_t q_tile = smem_u32(Qs + st * BQ * HD);
      const uint32_t do_tile = smem_u32(dOs + st * BQ * HD);
      const float* Lt = Ls + st * BQ;
      const float* Dt = Ds + st * BQ;
      mbar_wait(&full[st], (j / ST) & 1);
      // S^T = K Q^T and dP^T = V dO^T: 64 kv rows x BQ q columns
      float sc[NS][4], dp[NS][4];
      zero(sc);
      zero(dp);
      const uint64_t kd = here(desc_k(k_tile)), vd = here(desc_k(v_tile));
      const uint64_t qd = desc_k(q_tile), dod = desc_k(do_tile);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        Mma<BQ>::ss(sc, kd + step_k<BKV>(kk), qd + step_k<BQ>(kk));
      }
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        Mma<BQ>::ss(dp, vd + step_k<BKV>(kk), dod + step_k<BQ>(kk));
      }
      wg_commit();
      wg_wait();
      fence_acc(sc);
      fence_acc(dp);
      // dV += P^T_hi dO + P^T_lo dO, dK += dS^T_hi Q + dS^T_lo Q
      uint32_t phi[BQ / 16][4], plo[BQ / 16][4], dhi[BQ / 16][4],
          dlo[BQ / 16][4];
      if (tiles_full(s, q0, BQ, k0, BKV)) {
        probs<false>(sc, dp, phi, plo, dhi, dlo, Lt, Dt, s, q0, k0 + r0 + g,
                     t4);
      } else {
        probs<true>(sc, dp, phi, plo, dhi, dlo, Lt, Dt, s, q0, k0 + r0 + g,
                    t4);
      }
      const uint64_t dom = desc_mn<BQ>(do_tile), qm = desc_mn<BQ>(q_tile);
      wg_fence();
#pragma unroll
      for (int kc = 0; kc < BQ / 16; ++kc) {
        Mma<HD>::rs(dva, phi[kc], dom + step_mn(kc));
        Mma<HD>::rs(dva, plo[kc], dom + step_mn(kc));
        Mma<HD>::rs(dka, dhi[kc], qm + step_mn(kc));
        Mma<HD>::rs(dka, dlo[kc], qm + step_mn(kc));
      }
      wg_commit();
      wg_wait();
      fence_acc(dka);
      fence_acc(dva);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[st]);  // stage st is read
    }
    // dk = warpgroup 0's + warpgroup 1's, written by warpgroup 0; dv
    // likewise, written by warpgroup 1. Each gives the other its partial
    // through the consumed ring (every load of it has completed).
    float* xk = reinterpret_cast<float*>(Qs);
    float* xv = xk + ND * 4 * 128;
    consumers_sync();
#pragma unroll
    for (int n = 0; n < ND; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (wgi == 0) {
          xv[(n * 4 + e) * 128 + tid] = dva[n][e];
        } else {
          xk[(n * 4 + e) * 128 + tid] = dka[n][e];
        }
      }
    }
    consumers_sync();
    const long long ks = static_cast<long long>(s.Hkv) * HD;
    const long long kbase = (static_cast<long long>(b) * s.Skv + k0) * ks +
                            static_cast<long long>(hk) * HD;
    const int rows_k = min(BKV, s.Skv - k0);
    bf16* dst = wgi == 0 ? dk : dv;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + g + 8 * r;
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        float a, c;
        if (wgi == 0) {
          a = dka[n][2 * r] + xk[(n * 4 + 2 * r) * 128 + tid];
          c = dka[n][2 * r + 1] + xk[(n * 4 + 2 * r + 1) * 128 + tid];
        } else {
          a = xv[(n * 4 + 2 * r) * 128 + tid] + dva[n][2 * r];
          c = xv[(n * 4 + 2 * r + 1) * 128 + tid] + dva[n][2 * r + 1];
        }
        if (row < rows_k) {
          *reinterpret_cast<__nv_bfloat162*>(dst + kbase + row * ks + n * 8 +
                                             2 * t4) =
              __floats2bfloat162_rn(a, c);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Host side.

// The 4-D (hd, H, S, B) map of a contiguous (B, S, H, hd) bf16 tensor,
// boxes (64, 1, rows, 1), 128-byte swizzle, zero fill past S. False if the
// encoder refuses it.
inline bool make_map(CUtensorMap* map, const void* ptr, int B, int S, int H,
                     int hd, int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {dims[0] * 2, dims[0] * dims[1] * 2,
                                 dims[0] * dims[1] * dims[2] * 2};
  const cuuint32_t box[4] = {kBox, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD>
int launch_fwd(const void* q, const void* k, const void* v, void* out,
               void* out32, void* lse, int B, Shape s, cudaStream_t st) {
  using C = FwdCfg<HD>;
  CUtensorMap mq, mk, mv;
  if (!make_map(&mq, q, B, s.Sq, s.Hq, HD, C::BQ) ||
      !make_map(&mk, k, B, s.Skv, s.Hkv, HD, C::BKV) ||
      !make_map(&mv, v, B, s.Skv, s.Hkv, HD, C::BKV)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  static std::atomic<bool> done[kMaxDevices];
  const cudaError_t e = allow_smem_once(done, wg_fwd_kernel<HD>, C::SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(s.Hq, B, cdiv(s.Sq, C::BQ));
  wg_fwd_kernel<HD><<<grid, kThreads, C::SMEM, st>>>(
      mq, mk, mv, static_cast<bf16*>(out), static_cast<float*>(out32),
      static_cast<float*>(lse), s);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch_dq(const void* q, const void* k, const void* v, const void* out32,
              const void* dout, const void* lse, void* delta, void* dq,
              int B, Shape s, cudaStream_t st) {
  using C = DqCfg<HD>;
  CUtensorMap mq, mk, mv, mdo;
  if (!make_map(&mq, q, B, s.Sq, s.Hq, HD, C::BQ) ||
      !make_map(&mk, k, B, s.Skv, s.Hkv, HD, C::BKV) ||
      !make_map(&mv, v, B, s.Skv, s.Hkv, HD, C::BKV) ||
      !make_map(&mdo, dout, B, s.Sq, s.Hq, HD, C::BQ)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  static std::atomic<bool> done[kMaxDevices];
  const cudaError_t e = allow_smem_once(done, wg_bwd_dq_kernel<HD>, C::SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(s.Hq, B, cdiv(s.Sq, C::BQ));
  wg_bwd_dq_kernel<HD><<<grid, kThreads, C::SMEM, st>>>(
      mq, mk, mv, mdo, static_cast<const float*>(out32),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<float*>(delta), static_cast<bf16*>(dq), s);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch_dkdv(const void* q, const void* k, const void* v,
                const void* dout, const void* lse, const void* delta,
                void* dk, void* dv, int B, Shape s, cudaStream_t st) {
  using C = DkdvCfg<HD>;
  CUtensorMap mq, mk, mv, mdo;
  if (!make_map(&mq, q, B, s.Sq, s.Hq, HD, C::BQ) ||
      !make_map(&mk, k, B, s.Skv, s.Hkv, HD, C::BKV) ||
      !make_map(&mv, v, B, s.Skv, s.Hkv, HD, C::BKV) ||
      !make_map(&mdo, dout, B, s.Sq, s.Hq, HD, C::BQ)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  static std::atomic<bool> done[kMaxDevices];
  const cudaError_t e =
      allow_smem_once(done, wg_bwd_dkdv_kernel<HD>, C::SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(s.Hkv, B, cdiv(s.Skv, C::BKV));
  wg_bwd_dkdv_kernel<HD><<<grid, kThreads, C::SMEM, st>>>(
      mq, mk, mv, mdo, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wg
}  // namespace flash
}  // namespace repro

using namespace repro;
using namespace repro::flash;

extern "C" {

// Forward of a bf16 call at head dim 64 or 128: out (bf16), out32 and lse
// (f32), as repro_flash_fwd. Returns cudaGetLastError(), or
// cudaErrorInvalidValue for another dtype, head dim or shape, or a tensor
// map that cuTensorMapEncodeTiled refuses.
int repro_flash_wg_fwd(const void* q, const void* k, const void* v,
                       int dtype, void* out, void* out32, void* lse, int B,
                       int Sq, int Skv, int Hq, int Hkv, int hd, int causal,
                       int window, float scale, void* stream) {
  if (dtype != kBF16 || out32 == nullptr ||
      bad_shape(B, Sq, Skv, Hq, Hkv)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Shape s = make_shape(Sq, Skv, Hq, Hkv, causal, window, scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 64: return wg::launch_fwd<64>(q, k, v, out, out32, lse, B, s, st);
    case 128: return wg::launch_fwd<128>(q, k, v, out, out32, lse, B, s, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// bwd_dq of a bf16 call at head dim 64 or 128: delta (B, Sq, Hq) f32 = D
// and dq (bf16), as repro_flash_bwd_dq.
int repro_flash_wg_bwd_dq(const void* q, const void* k, const void* v,
                          int dtype, const void* out32, const void* dout,
                          const void* lse, void* delta, void* dq, int B,
                          int Sq, int Skv, int Hq, int Hkv, int hd,
                          int causal, int window, float scale, void* stream) {
  if (dtype != kBF16 || bad_shape(B, Sq, Skv, Hq, Hkv)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Shape s = make_shape(Sq, Skv, Hq, Hkv, causal, window, scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 64:
      return wg::launch_dq<64>(q, k, v, out32, dout, lse, delta, dq, B, s, st);
    case 128:
      return wg::launch_dq<128>(q, k, v, out32, dout, lse, delta, dq, B, s,
                                st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// bwd_dkdv of a bf16 call at head dim 64 or 128, after
// repro_flash_wg_bwd_dq (which writes delta): dk and dv (bf16), as
// repro_flash_bwd_dkdv but with no scratch.
int repro_flash_wg_bwd_dkdv(const void* q, const void* k, const void* v,
                            int dtype, const void* dout, const void* lse,
                            const void* delta, void* dk, void* dv, int B,
                            int Sq, int Skv, int Hq, int Hkv, int hd,
                            int causal, int window, float scale,
                            void* stream) {
  if (dtype != kBF16 || bad_shape(B, Sq, Skv, Hq, Hkv)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Shape s = make_shape(Sq, Skv, Hq, Hkv, causal, window, scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 64:
      return wg::launch_dkdv<64>(q, k, v, dout, lse, delta, dk, dv, B, s, st);
    case 128:
      return wg::launch_dkdv<128>(q, k, v, dout, lse, delta, dk, dv, B, s,
                                  st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Dynamic shared memory (bytes) of kernel `which` (0 the forward, 1
// bwd_dq, 2 bwd_dkdv) at head dim hd, or -1.
int repro_flash_wg_smem(int which, int hd) {
  if (hd != 64 && hd != 128) return -1;
  if (which == 0) {
    return hd == 64 ? wg::FwdCfg<64>::SMEM : wg::FwdCfg<128>::SMEM;
  }
  if (which == 1) {
    return hd == 64 ? wg::DqCfg<64>::SMEM : wg::DqCfg<128>::SMEM;
  }
  if (which == 2) {
    return hd == 64 ? wg::DkdvCfg<64>::SMEM : wg::DkdvCfg<128>::SMEM;
  }
  return -1;
}

}  // extern "C"

// The RG-LRU diagonal linear recurrence, forward and backward, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/rglru_scan.py:lru_scan
// (_lru_kernel), which carries the f32 state h across a sequential grid
// axis over time chunks. The reference model differentiates
// jax.lax.associative_scan instead, so there is no TPU backward to copy:
// the backward here is the reverse scan of kernels/ref.py:lru_scan_bwd_ref.
//
// Contract: a, b (B, S, W), f32 or bf16, contiguous; optional h0 (B, W) f32.
//   forward:  h_t = a_t * h_{t-1} + b_t   (h_{-1} = h0 or 0), state in f32,
//             h written in a's type;
//   backward: given h (the forward's output) and g = dL/dh,
//             dh_t = g_t + a_{t+1} * dh_{t+1}   (dh_S = 0),
//             db_t = dh_t, da_t = dh_t * h_{t-1}, dh0 = a_0 * dh_0,
//             da and db in a's type, dh0 f32.
// Every step rounds the product and then the sum (__fmul_rn, __fadd_rn):
// nvcc would otherwise contract a * h + b into one FMA, and the plain
// PyTorch loop rounds twice. Each chain runs its steps in order, one thread
// each, so both routes below are bitwise equal to the plain versions, in
// f32 and in bf16.
//
// What bounds it on this card: bytes. Each step does 2 FLOP per element
// (forward) against 12 bytes of f32 traffic, far below the card's
// FLOP-per-byte balance. At (1, 4096, 2560) f32 the forward moves 125.8 MB
// (37.6 us at 3.35 TB/s) and the backward 209.7 MB (62.6 us). The serial
// chain is not the limit: a step is one dependent multiply and add (about
// 8 cycles), 4,096 steps about 17-19 us.
//
// What keeps the memory busy is the number of bytes in flight: at 3.35 TB/s
// and 0.6-0.8 us of loaded latency the card needs 2-3 MB of loads
// outstanding, and at batch 1 there are only W chains (2,560) to issue them.
//
// TMA route (tma_fwd_kernel, tma_bwd_kernel), for a W whose rows are
// 16-byte multiples and 16-byte-aligned tensors:
// - A block owns kWT = 32 chains of one batch row: warp 1's lane 0 is the
//   producer, warp 0 the consumer (a lane a chain). Blocks of 16 chains
//   (160 blocks at W 2560, every SM busy) measured slower.
// - The producer keeps kStages stages of kTTile steps of each input in
//   flight with cp.async.bulk.tensor loads; each stage has a full and an
//   empty mbarrier. At (1, 4096, 2560) f32 that is 80 blocks x
//   2 inputs x 4 stages x 8 KB = 5.2 MB in flight (forward).
// - The consumer reads each step's inputs from shared memory (one
//   conflict-free load per input per step), runs the chain, writes the
//   step's outputs into an output stage, releases the input stage, and its
//   lane 0 stores the output stage with one TMA store per tensor
//   (cp.async.bulk.wait_group.read before a stage is written again).
// - A lane holds kU steps of each input in registers and loads the next kU
//   (the next tile's first kU after waiting for that tile) before it runs
//   the current ones. Loaded one step at a time, each step waited for its
//   shared-memory load behind the previous step's store (the compiler
//   cannot move a load above a store that may alias it): about 40 cycles
//   a step instead of the chain's 8.
// - The tensor maps are 3-D (W, S, B) with boxes [kWT, kTTile, 1], so a
//   box past S or W is zero-filled and a store there is clipped. A 2-D map
//   over (B * S, W) would load batch row b + 1's first steps into row b's
//   ragged last tile and store row b's results over row b + 1's.
// - Zero-filled steps past S leave the backward's carried (dh, a_next) at
//   (+0, +0), which is where the reverse scan starts: no step is skipped.
// - The backward walks the tiles from last to first. Its h stage holds
//   rows t0 - 1 ... t0 + kTTile - 2, so h_{t-1} is in the stage; row -1,
//   which the TMA zero-fills, is replaced by h0 (or 0) at t = 0. a_next
//   and dh carry across tiles; dh0 = a_0 * dh_0 at the end.
// The maps are encoded on the host for each call (cuTensorMapEncodeTiled,
// reached through cudaGetDriverEntryPoint by common.cuh's encode_tiled: no
// -lcuda) and passed as __grid_constant__ parameters; each kernel's
// shared-memory limit is set once.
//
// SIMT route (simt_fwd_kernel, simt_bwd_kernel), for everything else (W
// 45, 33, 1 or 100 in bf16; a contiguous view at an odd offset): one
// thread owns one chain, one warp a block, and each thread keeps the next
// kUnroll steps of each input in flight in registers.
//
// The caller (kernels/rglru_scan.py) picks the route before the launch;
// tma 0 asks for SIMT, 1 for TMA. Not done: a chunked two-pass scan that is
// parallel over time (it fills the card but changes the order of the f32
// operations).
#include "common.cuh"

namespace repro {
namespace lru {

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

// ---------------------------------------------------------------- SIMT --

constexpr int kThreads = 32;  // one warp per block: W / 32 blocks per batch row
constexpr int kUnroll = 16;   // time steps of each input kept in flight

// Loads kUnroll steps of one chain starting at step t0 (steps past S are
// left at 0). p points at the chain's element of step 0; steps are W apart.
template <typename T>
__device__ __forceinline__ void load_chunk(float v[kUnroll], const T* p,
                                           int t0, int S, int W) {
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int t = t0 + u;
    v[u] = t < S ? to_f32(p[static_cast<long long>(t) * W]) : 0.0f;
  }
}

// Steps t0 - u for u < kUnroll, walking backward (steps below 0 are 0).
template <typename T>
__device__ __forceinline__ void load_chunk_rev(float v[kUnroll], const T* p,
                                               int t0, int W) {
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int t = t0 - u;
    v[u] = t >= 0 ? to_f32(p[static_cast<long long>(t) * W]) : 0.0f;
  }
}

// Grid (ceil(W / kThreads), B). h0 may be null (zero initial state).
template <typename T>
__global__ void __launch_bounds__(kThreads)
simt_fwd_kernel(const T* __restrict__ a, const T* __restrict__ b,
                const float* __restrict__ h0, T* __restrict__ h, int S,
                int W) {
  const int w = blockIdx.x * kThreads + threadIdx.x;
  if (w >= W) return;
  const long long base = static_cast<long long>(blockIdx.y) * S * W + w;
  const T* pa = a + base;
  const T* pb = b + base;
  T* ph = h + base;
  float state = h0 ? h0[static_cast<long long>(blockIdx.y) * W + w] : 0.0f;
  float ac[kUnroll], bc[kUnroll], an[kUnroll], bn[kUnroll];
  load_chunk(ac, pa, 0, S, W);
  load_chunk(bc, pb, 0, S, W);
  for (int t0 = 0; t0 < S; t0 += kUnroll) {
    // the next chunk's loads are issued before this chunk is computed
    load_chunk(an, pa, t0 + kUnroll, S, W);
    load_chunk(bn, pb, t0 + kUnroll, S, W);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = t0 + u;
      if (t < S) {
        state = __fadd_rn(__fmul_rn(ac[u], state), bc[u]);
        ph[static_cast<long long>(t) * W] = from_f32<T>(state);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      ac[u] = an[u];
      bc[u] = bn[u];
    }
  }
}

// Grid (ceil(W / kThreads), B). h0 and dh0 may be null.
template <typename T>
__global__ void __launch_bounds__(kThreads)
simt_bwd_kernel(const T* __restrict__ a, const T* __restrict__ h,
                const T* __restrict__ g, const float* __restrict__ h0,
                T* __restrict__ da, T* __restrict__ db,
                float* __restrict__ dh0, int S, int W) {
  const int w = blockIdx.x * kThreads + threadIdx.x;
  if (w >= W) return;
  const long long base = static_cast<long long>(blockIdx.y) * S * W + w;
  const T* pa = a + base;
  const T* pg = g + base;
  const T* ph = h + base;
  const float hinit =
      h0 ? h0[static_cast<long long>(blockIdx.y) * W + w] : 0.0f;
  float dh = 0.0f, a_next = 0.0f;
  // chunk u holds step t0 - u: a_t, g_t and h_{t-1}
  float ac[kUnroll], gc[kUnroll], hc[kUnroll];
  float an[kUnroll], gn[kUnroll], hn[kUnroll];
  load_chunk_rev(ac, pa, S - 1, W);
  load_chunk_rev(gc, pg, S - 1, W);
  load_chunk_rev(hc, ph, S - 2, W);
  for (int t0 = S - 1; t0 >= 0; t0 -= kUnroll) {
    load_chunk_rev(an, pa, t0 - kUnroll, W);
    load_chunk_rev(gn, pg, t0 - kUnroll, W);
    load_chunk_rev(hn, ph, t0 - kUnroll - 1, W);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = t0 - u;
      if (t >= 0) {
        dh = __fadd_rn(gc[u], __fmul_rn(a_next, dh));
        const float h_prev = t > 0 ? hc[u] : hinit;
        const long long off = static_cast<long long>(t) * W;
        db[base + off] = from_f32<T>(dh);
        da[base + off] = from_f32<T>(__fmul_rn(dh, h_prev));
        a_next = ac[u];
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      ac[u] = an[u];
      gc[u] = gn[u];
      hc[u] = hn[u];
    }
  }
  if (dh0) {
    dh0[static_cast<long long>(blockIdx.y) * W + w] = __fmul_rn(a_next, dh);
  }
}

// ----------------------------------------------------------------- TMA --

constexpr int kTTile = 64;      // time steps of a stage (the box's S extent)
constexpr int kStages = 4;      // input stages in flight
constexpr int kOutStages = 2;   // output stages (one TMA store group each)
constexpr int kTmaThreads = 64; // warp 0 computes and stores, warp 1 loads
constexpr int kWT = 32;         // chains of a block: one a lane of warp 0
constexpr int kU = 16;          // steps of each input a lane holds in registers
constexpr int kChunks = kTTile / kU;

// kU steps of one chain from a stage, from row j0 (p: the lane's element
// of row 0; rows are kWT apart).
template <typename T>
__device__ __forceinline__ void load_steps(float v[kU], const T* p, int j0) {
#pragma unroll
  for (int u = 0; u < kU; ++u) v[u] = to_f32(p[(j0 + u) * kWT]);
}

// Box [kWT, kTTile, 1] at (w, t, b) into shared memory; completes on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int w, int t, int b) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(w),
      "r"(t), "r"(b)
      : "memory");
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          const void* src, int w, int t,
                                          int b) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group "
      "[%0, {%2, %3, %4}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(w), "r"(t), "r"(b)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Until at most N committed store groups still read shared memory.
template <int N> __device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// The ring of one block: NIN input tiles and NOUT output tiles a stage,
// each [kTTile][kWT] elements of T, then the full and empty barriers.
template <typename T, int NIN, int NOUT>
struct Ring {
  static constexpr int kTile = kTTile * kWT;
  static constexpr int kTileBytes = kTile * static_cast<int>(sizeof(T));
  static constexpr int kInBytes = NIN * kStages * kTileBytes;
  static constexpr int kOutBytes = NOUT * kOutStages * kTileBytes;
  // + the barriers, + 128 to align the base for the TMA
  static constexpr int kSmemBytes =
      kInBytes + kOutBytes + 2 * kStages * 8 + 128;

  T* in;
  T* out;
  uint64_t* full;
  uint64_t* empty;

  __device__ explicit Ring(unsigned char* raw) {
    const uint32_t pad = (128u - (smem_u32(raw) & 127u)) & 127u;
    unsigned char* base = raw + pad;
    in = reinterpret_cast<T*>(base);
    out = reinterpret_cast<T*>(base + kInBytes);
    full = reinterpret_cast<uint64_t*>(base + kInBytes + kOutBytes);
    empty = full + kStages;
  }
  __device__ T* in_tile(int i, int s) const {
    return in + (i * kStages + s) * kTile;
  }
  __device__ T* out_tile(int o, int s) const {
    return out + (o * kOutStages + s) * kTile;
  }

  __device__ void init() const {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);   // the producer's arrive.expect_tx
      mbar_init(&empty[s], 1);  // the consumer's lane 0, after __syncwarp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }

  // Producer: before tile k reuses stage s, wait for the consumer to have
  // released tile k - kStages, then load the stage's NIN boxes.
  __device__ void produce(int k, const CUtensorMap* const maps[NIN],
                          const int t0s[NIN], int w0, int b) const {
    const int s = k % kStages;
    if (k >= kStages) mbar_wait(&empty[s], ((k / kStages) - 1) & 1);
    mbar_expect_tx(&full[s], NIN * kTileBytes);
#pragma unroll
    for (int i = 0; i < NIN; ++i) {
      tma_load(in_tile(i, s), maps[i], &full[s], w0, t0s[i], b);
    }
  }

  // Consumer: tile k's inputs have arrived in its stage.
  __device__ void wait_inputs(int k) const {
    mbar_wait(&full[k % kStages], (k / kStages) & 1);
  }

  // Consumer, before it writes tile k's output stage: the store that last
  // read that stage (tile k - kOutStages) is done reading.
  __device__ void wait_output_stage(int k, int lane) const {
    if (k >= kOutStages) {
      if (lane == 0) bulk_wait_read<kOutStages - 1>();
      __syncwarp();
    }
  }

  // Consumer, after tile k: every lane is done with the input stage and
  // has written the output stage; lane 0 releases the one and stores the
  // other (one store group a tile).
  __device__ void release(int k, int lane, const CUtensorMap* const maps[NOUT],
                          int w0, int t0, int b) const {
    fence_async_smem();
    __syncwarp();
    if (lane == 0) {
      mbar_arrive(&empty[k % kStages]);
#pragma unroll
      for (int o = 0; o < NOUT; ++o) {
        tma_store(maps[o], out_tile(o, k % kOutStages), w0, t0, b);
      }
      bulk_commit();
    }
  }
};

// Grid (ceil(W / kWT), B), kTmaThreads threads. h0 may be null.
template <typename T>
__global__ void __launch_bounds__(kTmaThreads)
tma_fwd_kernel(__grid_constant__ const CUtensorMap map_a,
               __grid_constant__ const CUtensorMap map_b,
               __grid_constant__ const CUtensorMap map_h,
               const float* __restrict__ h0, int S, int W) {
  using R = Ring<T, 2, 1>;
  extern __shared__ unsigned char smem_raw[];
  const R ring(smem_raw);
  const int lane = threadIdx.x % 32;
  const int w0 = blockIdx.x * kWT;
  const int bi = blockIdx.y;
  const int tiles = (S + kTTile - 1) / kTTile;
  if (threadIdx.x == 0) ring.init();
  __syncthreads();

  if (threadIdx.x / 32 == 1) {  // the producer
    if (lane == 0) {
      const CUtensorMap* const maps[2] = {&map_a, &map_b};
      for (int k = 0; k < tiles; ++k) {
        const int t0s[2] = {k * kTTile, k * kTTile};
        ring.produce(k, maps, t0s, w0, bi);
      }
    }
    return;
  }

  const CUtensorMap* const out_maps[1] = {&map_h};
  const int w = w0 + lane;
  float state = 0.0f;
  if (h0 && w < W) state = h0[static_cast<long long>(bi) * W + w];
  // each lane holds kU steps of a and b in registers and loads the next kU
  // (from the next tile's stage after the last chunk) before computing
  // them: the loads' latency hides behind the chain
  float ac[kU], bc[kU], an[kU], bn[kU];
  ring.wait_inputs(0);
  load_steps<T>(ac, ring.in_tile(0, 0) + lane, 0);
  load_steps<T>(bc, ring.in_tile(1, 0) + lane, 0);
  for (int k = 0; k < tiles; ++k) {
    const int s = k % kStages;
    ring.wait_output_stage(k, lane);
    T* th = ring.out_tile(0, k % kOutStages) + lane;
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      if (c + 1 < kChunks) {
        load_steps<T>(an, ring.in_tile(0, s) + lane, (c + 1) * kU);
        load_steps<T>(bn, ring.in_tile(1, s) + lane, (c + 1) * kU);
      } else if (k + 1 < tiles) {
        const int s1 = (k + 1) % kStages;
        ring.wait_inputs(k + 1);
        load_steps<T>(an, ring.in_tile(0, s1) + lane, 0);
        load_steps<T>(bn, ring.in_tile(1, s1) + lane, 0);
      }
      // steps past S (zero-filled) run too: their stores are clipped
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        state = __fadd_rn(__fmul_rn(ac[u], state), bc[u]);
        th[(c * kU + u) * kWT] = from_f32<T>(state);
      }
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        ac[u] = an[u];
        bc[u] = bn[u];
      }
    }
    ring.release(k, lane, out_maps, w0, k * kTTile, bi);
  }
  if (lane == 0) bulk_wait_all();
}

// Grid (ceil(W / kWT), B), kTmaThreads threads. h0 and dh0 may be null.
template <typename T>
__global__ void __launch_bounds__(kTmaThreads)
tma_bwd_kernel(__grid_constant__ const CUtensorMap map_a,
               __grid_constant__ const CUtensorMap map_h,
               __grid_constant__ const CUtensorMap map_g,
               __grid_constant__ const CUtensorMap map_da,
               __grid_constant__ const CUtensorMap map_db,
               const float* __restrict__ h0, float* __restrict__ dh0, int S,
               int W) {
  using R = Ring<T, 3, 2>;
  extern __shared__ unsigned char smem_raw[];
  const R ring(smem_raw);
  const int lane = threadIdx.x % 32;
  const int w0 = blockIdx.x * kWT;
  const int bi = blockIdx.y;
  const int tiles = (S + kTTile - 1) / kTTile;
  if (threadIdx.x == 0) ring.init();
  __syncthreads();

  if (threadIdx.x / 32 == 1) {  // the producer, last tile first
    if (lane == 0) {
      const CUtensorMap* const maps[3] = {&map_a, &map_g, &map_h};
      for (int k = 0; k < tiles; ++k) {
        const int t0 = (tiles - 1 - k) * kTTile;
        const int t0s[3] = {t0, t0, t0 - 1};  // h one row earlier
        ring.produce(k, maps, t0s, w0, bi);
      }
    }
    return;
  }

  const CUtensorMap* const out_maps[2] = {&map_da, &map_db};
  const int w = w0 + lane;
  const bool inside = w < W;
  const float hinit =
      h0 && inside ? h0[static_cast<long long>(bi) * W + w] : 0.0f;
  float dh = 0.0f, a_next = 0.0f;
  // as the forward, walking each tile's chunks from the last: chunk c of
  // a stage holds rows c * kU ... c * kU + kU - 1 (h: h_{t0 + row - 1})
  float ac[kU], gc[kU], hc[kU], an[kU], gn[kU], hn[kU];
  constexpr int kTop = (kChunks - 1) * kU;
  ring.wait_inputs(0);
  load_steps<T>(ac, ring.in_tile(0, 0) + lane, kTop);
  load_steps<T>(gc, ring.in_tile(1, 0) + lane, kTop);
  load_steps<T>(hc, ring.in_tile(2, 0) + lane, kTop);
  for (int k = 0; k < tiles; ++k) {
    const int s = k % kStages;
    const int t0 = (tiles - 1 - k) * kTTile;
    ring.wait_output_stage(k, lane);
    T* tda = ring.out_tile(0, k % kOutStages) + lane;
    T* tdb = ring.out_tile(1, k % kOutStages) + lane;
#pragma unroll
    for (int c = kChunks - 1; c >= 0; --c) {
      if (c > 0) {
        load_steps<T>(an, ring.in_tile(0, s) + lane, (c - 1) * kU);
        load_steps<T>(gn, ring.in_tile(1, s) + lane, (c - 1) * kU);
        load_steps<T>(hn, ring.in_tile(2, s) + lane, (c - 1) * kU);
      } else if (k + 1 < tiles) {
        const int s1 = (k + 1) % kStages;
        ring.wait_inputs(k + 1);
        load_steps<T>(an, ring.in_tile(0, s1) + lane, kTop);
        load_steps<T>(gn, ring.in_tile(1, s1) + lane, kTop);
        load_steps<T>(hn, ring.in_tile(2, s1) + lane, kTop);
      }
#pragma unroll
      for (int u = kU - 1; u >= 0; --u) {
        const int j = c * kU + u;
        dh = __fadd_rn(gc[u], __fmul_rn(a_next, dh));
        // row -1 (t = 0) was zero-filled: h0 takes its place
        const float h_prev = (j == 0 && t0 == 0) ? hinit : hc[u];
        tda[j * kWT] = from_f32<T>(__fmul_rn(dh, h_prev));
        tdb[j * kWT] = from_f32<T>(dh);
        a_next = ac[u];
      }
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        ac[u] = an[u];
        gc[u] = gn[u];
        hc[u] = hn[u];
      }
    }
    ring.release(k, lane, out_maps, w0, t0, bi);
  }
  if (dh0 && inside) {
    dh0[static_cast<long long>(bi) * W + w] = __fmul_rn(a_next, dh);
  }
  if (lane == 0) bulk_wait_all();
}

// ---------------------------------------------------------------- host --

inline bool bad_shape(int B, int S, int W) {
  return B <= 0 || S <= 0 || W <= 0 || B > 65535;
}

inline dim3 grid_of(int B, int W, int wt) {
  return dim3((W + wt - 1) / wt, B);
}

// The 3-D (W, S, B) map of a contiguous (B, S, W) tensor, boxes
// [kWT, kTTile, 1], zero fill out of bounds. False if the encoder refuses it
// (an address or a row that is not a multiple of 16 bytes).
inline bool make_map(CUtensorMap* map, const void* ptr, int dtype, int B,
                     int S, int W) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t es = dtype == kF32 ? 4 : 2;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(W),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[2] = {dims[0] * es, dims[0] * dims[1] * es};
  const cuuint32_t box[3] = {kWT, kTTile, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode(map,
                dtype == kF32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                              : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                3, const_cast<void*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T>
cudaError_t launch_tma_fwd(const void* a, const void* b, const float* h0,
                           int dtype, void* h, int B, int S, int W,
                           cudaStream_t st) {
  CUtensorMap ma, mb, mh;
  if (!make_map(&ma, a, dtype, B, S, W) ||
      !make_map(&mb, b, dtype, B, S, W) ||
      !make_map(&mh, h, dtype, B, S, W)) {
    return cudaErrorInvalidValue;
  }
  constexpr int smem = Ring<T, 2, 1>::kSmemBytes;
  static std::atomic<bool> done[kMaxDevices];
  const cudaError_t rc = allow_smem_once(done, tma_fwd_kernel<T>, smem);
  if (rc != cudaSuccess) return rc;
  tma_fwd_kernel<T>
      <<<grid_of(B, W, kWT), kTmaThreads, smem, st>>>(ma, mb, mh, h0, S, W);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_tma_bwd(const void* a, const void* h, const void* g,
                           const float* h0, int dtype, void* da, void* db,
                           float* dh0, int B, int S, int W, cudaStream_t st) {
  CUtensorMap ma, mh, mg, mda, mdb;
  if (!make_map(&ma, a, dtype, B, S, W) ||
      !make_map(&mh, h, dtype, B, S, W) ||
      !make_map(&mg, g, dtype, B, S, W) ||
      !make_map(&mda, da, dtype, B, S, W) ||
      !make_map(&mdb, db, dtype, B, S, W)) {
    return cudaErrorInvalidValue;
  }
  constexpr int smem = Ring<T, 3, 2>::kSmemBytes;
  static std::atomic<bool> done[kMaxDevices];
  const cudaError_t rc = allow_smem_once(done, tma_bwd_kernel<T>, smem);
  if (rc != cudaSuccess) return rc;
  tma_bwd_kernel<T><<<grid_of(B, W, kWT), kTmaThreads, smem, st>>>(
      ma, mh, mg, mda, mdb, h0, dh0, S, W);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_fwd(const void* a, const void* b, const float* h0,
                       int dtype, void* h, int B, int S, int W, int tma,
                       cudaStream_t st) {
  if (tma) return launch_tma_fwd<T>(a, b, h0, dtype, h, B, S, W, st);
  simt_fwd_kernel<T><<<grid_of(B, W, kThreads), kThreads, 0, st>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), h0,
      static_cast<T*>(h), S, W);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd(const void* a, const void* h, const void* g,
                       const float* h0, int dtype, void* da, void* db,
                       float* dh0, int B, int S, int W, int tma,
                       cudaStream_t st) {
  if (tma) {
    return launch_tma_bwd<T>(a, h, g, h0, dtype, da, db, dh0, B, S, W, st);
  }
  simt_bwd_kernel<T><<<grid_of(B, W, kThreads), kThreads, 0, st>>>(
      static_cast<const T*>(a), static_cast<const T*>(h),
      static_cast<const T*>(g), h0, static_cast<T*>(da),
      static_cast<T*>(db), dh0, S, W);
  return cudaGetLastError();
}

}  // namespace lru
}  // namespace repro

using namespace repro;

extern "C" {

// h = scan(a, b) in a's type; h0 (B, W) f32 or null. tma 1 takes the TMA
// route (16-byte-aligned pointers and rows), 0 the SIMT route. Returns the
// launch's cudaError_t.
int repro_lru_scan_fwd(const void* a, const void* b, const void* h0,
                       int dtype, void* h, int B, int S, int W, int tma,
                       void* stream) {
  if (lru::bad_shape(B, S, W)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* h0f = static_cast<const float*>(h0);
  if (dtype == kF32) {
    return static_cast<int>(
        lru::launch_fwd<float>(a, b, h0f, dtype, h, B, S, W, tma, st));
  }
  if (dtype == kBF16) {
    return static_cast<int>(lru::launch_fwd<__nv_bfloat16>(
        a, b, h0f, dtype, h, B, S, W, tma, st));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// da, db in a's type; dh0 (B, W) f32 written when not null; h0 may be null.
// tma as for the forward.
int repro_lru_scan_bwd(const void* a, const void* h, const void* g,
                       const void* h0, int dtype, void* da, void* db,
                       void* dh0, int B, int S, int W, int tma,
                       void* stream) {
  if (lru::bad_shape(B, S, W)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* h0f = static_cast<const float*>(h0);
  float* dh0f = static_cast<float*>(dh0);
  if (dtype == kF32) {
    return static_cast<int>(lru::launch_bwd<float>(
        a, h, g, h0f, dtype, da, db, dh0f, B, S, W, tma, st));
  }
  if (dtype == kBF16) {
    return static_cast<int>(lru::launch_bwd<__nv_bfloat16>(
        a, h, g, h0f, dtype, da, db, dh0f, B, S, W, tma, st));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// Dynamic shared memory (bytes) of a TMA block, its ring: the forward's
// (backward 0) or the backward's, for dtype; -1 for another dtype.
int repro_lru_ring_smem(int dtype, int backward) {
  if (dtype == kF32) {
    return backward ? lru::Ring<float, 3, 2>::kSmemBytes
                    : lru::Ring<float, 2, 1>::kSmemBytes;
  }
  if (dtype == kBF16) {
    return backward ? lru::Ring<__nv_bfloat16, 3, 2>::kSmemBytes
                    : lru::Ring<__nv_bfloat16, 2, 1>::kSmemBytes;
  }
  return -1;
}

}  // extern "C"

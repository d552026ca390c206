// Flash attention forward for Hopper (sm_90a): bf16 in, fp32 accumulate.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::flash_attention_pallas
// (body _attn_kernel): blockwise online-softmax attention over q (B,Sq,H,D) and
// k/v (B,Sk,KVH,D) with GQA, causal, sliding window, tanh softcap, q_offset and
// a kv_valid length mask. Masked scores take the finite value -1e30, as in the
// Pallas kernel: with -inf a tile whose every entry is masked would give
// inf - inf = NaN in the running-max correction; with -1e30 such a tile is
// cancelled exactly (factor 2^(-1e30 - m) = 0) by the first later valid tile.
//
// Bound on the H100. Work: 4*B*H*Sq*Sk*D FLOPs (x1/2 when causal) at the
// 989 TFLOP/s bf16 tensor-core peak, against the bytes of q, k, v and o at
// 3.35 TB/s. At deepseek-7b's serving shape (B=4, S=2048, H=KVH=32, D=128,
// causal) that is 1.37e11 FLOPs = 0.139 ms against 268 MB = 0.080 ms: bound
// by operations, so prefill is about keeping the tensor cores fed. A decode
// step's one query row is bound by bytes: seamless's cross-attention (B=4,
// Sk=1500, H=KVH=16, D=64) reads 24.6 MB of K and V, 7.3 us.
//
// Design: FlashAttention-3's forward on the primitives of hopper.cuh.
//   * One block per (128-row q tile, head, batch), longest causal rows
//     first: a producer warpgroup and two consumer warpgroups of 64 q rows
//     (384 threads); setmaxnreg moves registers from the producer (24 a
//     thread) to the consumers (240), at every head dim.
//   * The producer's one thread loads Q once and K/V tiles (Tiles<D>: 128
//     rows up to D=128, 96 at 160, 64 at 256) by TMA into a ring of 2
//     stages; K and V each complete on their own full mbarrier and are
//     released on their own empty one.
//   * Consumer warpgroup w owns q rows 64w..64w+63. S_t = Q K_t^T is a wgmma
//     chain with both operands in shared memory (K K-major); O += P V is a
//     wgmma with P from registers (P rounded to bf16; the accumulator
//     layout is the A-fragment layout) and V read MN-major through the
//     transpose bit. Step t issues S_t, then P_{t-1} V_{t-1}, waits for S_t
//     only, and runs the online softmax of tile t (fp32, base 2,
//     ex2.approx; masks only on tiles a mask reaches into) while the tensor
//     cores finish P_{t-1} V_{t-1}; then O is rescaled and P_t packed.
//   * Up to D=160 the two warpgroups also take turns to issue their
//     products (FA3's ping-pong: named barriers 1 and 2), so that one's
//     softmax runs under the other's products. Both then step through
//     every tile of the block (masks do the rest) so that their turns pair
//     up; where only warpgroup 0 holds real rows (a one-row block) there is
//     no ping-pong and warpgroup 1 passes every tile. At D=256 the turns
//     measured slower and are off.
//   * Tiles that the causal, window or kv_valid masks empty for the whole
//     block are never loaded; without ping-pong a tile empty for one
//     warpgroup only is passed over by it (it waits for the stage and
//     releases it). Ragged Sq and Sk are zero-filled by TMA past the
//     tensor maps' edges; GQA reads kv head h / (H / KVH) by the map
//     coordinate.
//   * O leaves as FA3's does: each warpgroup writes its rows in bf16 over
//     its own rows of the Q tile (its last product is in), in the TMA box
//     layout, and one thread stores them by TMA, which clips rows past Sq
//     and columns past D. Direct 4-byte stores from the accumulators (the
//     earlier epilogue) held the consumers at each block's end and measured
//     slower at the prefill shapes. Packed and split blocks store directly.
//   * Split over the keys (Params::splits, kernels/flash_attention.py
//     split_count): for at most 64 q rows (a decode step's one row) where
//     the grid is under one wave of 132 blocks and the keys span two tiles
//     or more, each block's tiles are cut into `splits` runs of
//     ceil(n / splits) tiles in order, one block each. At one q row with
//     KVH < H, the G = H / KVH query heads of a kv head are the block's rows
//     (Params::group: a TMA box of 64 columns x G heads x 1 row), so each
//     K/V tile is read once for the group. Each split writes its normalized O (fp32) and its
//     LSE2 to scratch; the group's last split to finish (an atomic count,
//     reset to 0 by that block) merges them in split order, LSE2 = log2 sum
//     2^LSE2_i and O = sum 2^(LSE2_i - LSE2) O_i, reading past L1: one
//     launch, no atomics on the data, bitwise repeatable.
//   * A persistent grid (one block an SM walking the items, longest causal
//     rows first, in static turns; the ring's phases running on across
//     items) was tried: as fast at most shapes, slower at deepseek-7b's and
//     zamba2-7b's prefill, and it spilled at D=256. Not kept.
// Tiles are 128-byte swizzled boxes of 64 columns (hopper.cuh), the widest the
// swizzle takes, so D is loaded in 64-column boxes over 4-D maps
// (D, heads, S, B). At D=112 the second box reads columns 112-127 past the
// edge as zeros: both products run at D=128 and the pad columns are never
// stored (14% more tensor-core work than the head needs); D=160 runs at 192.
// Shared memory: 164 992 B a block up to D=128, 197 760 B at 160 and 256.
//
// Registers. A consumer holds O (DP/2 fp32 a thread: 64 at D=128, 96 at 160,
// 128 at 256), S (BK/2) and P (BK/4): at D=128 with 128-key tiles 160 plus
// addresses and the softmax's temporaries, more than the 168 a thread that
// a 384-thread launch gives ptxas. ptxas does allocate the region after
// setmaxnreg.inc within the raised count, but only when no `trap` is
// reachable from it: hopper::mbar_wait's 2-second trap, reachable from the
// consumers (and shared with the producer's region), made it allocate them
// as if capped. This kernel built so spills 200 B at D=112 and 128, 452 at
// 160 and 460 at 256, and ptxas serializes its wgmma (C7512, "insufficient
// register resources"), while the SASS addresses 175-215 registers; with
// the consumers' waits trap-free (hopper::mbar_wait_spin) it spills
// nothing, serializes nothing and addresses 237-238 at every head dim
// (ptxas 12.9; chip_smoke.py phase 1 builds both). The earlier
// notes read this as a cap of the launch (and cut
// K/V tiles to 96 rows and D=160 and 256 to one consumer warpgroup); it
// was the trap. A lost load still surfaces within 2 s: the producer
// thread, which keeps the trapping wait, waits at the end for a `done`
// barrier that every consumer warp arrives on after its stores.
// SASS: 164 HGMMA, 36 UTMALDG, no spills (chip_smoke.py phase 1 prints each
// kernel's addressed registers beside ptxas's 168 for the launch).
//
// Measured (tests/_torch_flash_compare.py, H100 80GB HBM3 at 700 W, per
// call in back-to-back runs, against the previous design in the same run):
// 0.300 ms at deepseek-7b's serving shape (was 0.356; sdpa one call 0.340,
// device 0.255; bound 0.139), 0.407 at stablelm-12b's (0.578), 0.329 at
// gemma2-9b's global shape with the softcap (0.437). The one-row calls are
// the host's back to back: 0.046 ms at the VLM's decode cross-attention
// (0.150), 0.0282 on the device (0.136; sdpa 0.0285), and 0.038 at
// seamless's (0.040), 0.0128 on the device (0.0227; sdpa 0.0087, bound
// 0.0073); there the wrapper's host path (kernels/flash_attention.py,
// _on_card) is what a split call must not add to. PERF.md section 6 has
// every shape.
//
// Training (the backward, csrc/flash_attention_bwd.cu) needs each row's
// log-sum-exp: with a non-null `lse` the epilogue (or the split merge)
// writes LSE2 = m + log2(l) of the base-2 scores y2 = log2(e) * (scaled,
// softcapped score), the domain the backward exponentiates in (P = 2^(y2 -
// LSE2)); -inf for a row that saw no key. The 4 threads of a quad hold the
// same m and l (one warp owns 16 rows). Serving passes null and nothing is
// written.
//
// Plain C interface for ctypes: every pointer and the stream are void*; the
// launch returns cudaGetLastError() so the caller can raise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = 240;
constexpr int CONSUMERS = 2;                  // consumer warpgroups, 64 q rows each
constexpr int BQ = 64 * CONSUMERS;            // q rows per block
constexpr int THREADS = 128 * (CONSUMERS + 1);   // and a producer warpgroup
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

// The tile shape at head_dim D (kernels/flash_attention.py TILES): kv rows
// per tile and K/V tiles in the ring. The source note says why.
template <int D>
struct Tiles {
  static constexpr int BK = 128, STAGES = 2;
  static constexpr bool PINGPONG = true;
};
template <>
struct Tiles<160> {
  static constexpr int BK = 96, STAGES = 2;
  static constexpr bool PINGPONG = true;
};
template <>
struct Tiles<256> {
  static constexpr int BK = 64, STAGES = 2;
  static constexpr bool PINGPONG = false;
};

// Head dim D in 64-column boxes; D = 112 is read as 128 and D = 160 as 192
// (the last box's columns past D are zeros past the edge of the tensor map).
template <int D>
struct Layout {
  static constexpr int BK = Tiles<D>::BK;                      // kv rows per tile
  static constexpr int STAGES = Tiles<D>::STAGES;              // K/V tiles in the ring
  static constexpr int NB = (D + hopper::BOX - 1) / hopper::BOX;
  static constexpr int DP = NB * hopper::BOX;                  // padded head dim
  static constexpr int Q_BOX = BQ * hopper::BOX_ROW_BYTES;     // bytes of one Q box
  static constexpr int KV_BOX = BK * hopper::BOX_ROW_BYTES;    // one K or V box
  static constexpr int Q_BYTES = NB * Q_BOX;
  static constexpr int KV_BYTES = NB * KV_BOX;                 // one K or V tile
  // Q, then K[STAGES], then V[STAGES], then the barriers and the merge's
  // flag; + alignment slack
  static constexpr int BARRIER_OFFSET = Q_BYTES + 2 * STAGES * KV_BYTES;
  static constexpr int BYTES = BARRIER_OFFSET + 128 + 1024;
};

// One launch's arguments beside the tensor maps. group > 0 packs the G =
// H / KVH query heads of a kv head into one block's rows (Sq = 1). splits > 1
// cuts each block's kv tiles into that many blocks, which write part_o and
// part_lse; the last of a group to finish (counted in counters, which it
// resets to 0) merges them into o (and lse where non-null).
struct Params {
  bf16* o;            // (B, Sq, H, D)
  float* lse;         // (B, H, Sq): the rows' LSE2, or null
  float* part_o;      // (splits, B, Sq, H, D): each split's normalized O, fp32
  float* part_lse;    // (splits, B, H, Sq): each split's LSE2
  int* counters;      // one a group of splits (q tile, head, batch), 0 between calls
  int Sq, H, KVH, group, splits, causal, window, q_offset, kv_valid;
  float scale, softcap;
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // .x (lo) in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// 2^x by the special-function unit (ex2.approx: relative error ~2^-22, far
// below the bf16 rounding P goes through).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// 1/x by the special-function unit (rcp.approx: within 1 ulp; 1/inf = 0).
__device__ __forceinline__ float fast_rcp(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The online softmax of one warpgroup's rows over one BK-key tile, in base
// 2: the scores are scaled (and softcapped), masked where a mask reaches
// into the tile, and replaced by p = 2^(x - m) with m the new running max;
// corr is the factor that the earlier sums are rescaled by. A masked score
// is -1e30 exactly, so a row with no key yet gives x - m = 0, as the Pallas
// kernel does. qpos is the q position of this thread's first row, r8 that
// of its second less qpos (8; 0 where the rows are packed heads).
struct Softmax {
  float scale, softcap;
  int causal, window, kv_valid, q_lo, qpos, r8, t4;

  template <int BK>
  __device__ __forceinline__ void update(float (&sc)[BK / 2], int kstart,
                                         float (&m_run)[2], float (&l_run)[2],
                                         float (&corr)[2]) const {
    if (softcap > 0.f) {        // c tanh(x s / c) log2(e) = cL - 2 cL / (1 + 2^(2 x s L / c))
      const float cl = softcap * LOG2E, k = 2.f * scale * LOG2E / softcap;
#pragma unroll
      for (int i = 0; i < BK / 2; ++i)
        sc[i] = fmaf(-2.f * cl, fast_rcp(1.f + fast_exp2(sc[i] * k)), cl);
    } else {
      const float scale_log2 = scale * LOG2E;
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) sc[i] *= scale_log2;
    }
    const bool need_mask = kstart + BK > kv_valid || (causal && kstart + BK - 1 > q_lo) ||
                           (window && q_lo + 63 - kstart >= window);
    if (need_mask) {
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qp = qpos + (e >= 2 ? r8 : 0);   // rows g and g + 8
          const int kp = kstart + 8 * j + 2 * t4 + (e & 1);
          bool ok = kp < kv_valid;
          if (causal) ok = ok && kp <= qp;
          if (window) ok = ok && qp - kp < window;
          if (!ok) sc[4 * j + e] = NEG_INF;
        }
      }
    }
    float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      mx[0] = fmaxf(mx[0], fmaxf(sc[4 * j], sc[4 * j + 1]));
      mx[1] = fmaxf(mx[1], fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {               // the 4 threads of a quad share a row
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      corr[r] = fast_exp2(m_run[r] - mx[r]);
      m_run[r] = mx[r];
    }
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sc[4 * j + e] = fast_exp2(sc[4 * j + e] - mx[e >> 1]);
        rs[e >> 1] += sc[4 * j + e];
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
      l_run[r] = l_run[r] * corr[r] + rs[r];
    }
  }
};

// log2 of a row's softmax denominator, from its running max and sum (base 2)
__device__ __forceinline__ float row_lse(float m, float l) {
  return m > 0.5f * NEG_INF && l > 0.f ? m + log2f(l) : -INFINITY;
}

// P rounded to bf16 pairs: n8 blocks 2s and 2s + 1 of the accumulator are the
// A fragment of the k16 slice s (hopper.cuh: the layouts agree).
template <int BK>
__device__ __forceinline__ void to_bf16_fragments(const float (&sc)[BK / 2],
                                                  uint32_t (&p)[BK / 16][4]) {
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
    p[j / 2][(j % 2) * 2] = pack_bf16(sc[4 * j], sc[4 * j + 1]);
    p[j / 2][(j % 2) * 2 + 1] = pack_bf16(sc[4 * j + 2], sc[4 * j + 3]);
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_kernel(__grid_constant__ const CUtensorMap qmap,
                 __grid_constant__ const CUtensorMap kmap,
                 __grid_constant__ const CUtensorMap vmap,
                 __grid_constant__ const CUtensorMap omap,   // o, 64-row boxes
                 const Params prm) {
  using L = Layout<D>;
  constexpr int BK = L::BK, STAGES = L::STAGES;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* sQ = base;
  unsigned char* sK = base + L::Q_BYTES;
  unsigned char* sV = sK + STAGES * L::KV_BYTES;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(base + L::BARRIER_OFFSET);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + STAGES;
  uint64_t* k_empty = v_full + STAGES;
  uint64_t* v_empty = k_empty + STAGES;
  uint64_t* done = v_empty + STAGES;            // every consumer warp has stored
  int* last_split = reinterpret_cast<int*>(done + 1);

  const int split = blockIdx.x % prm.splits;
  const int qt = gridDim.x / prm.splits - 1 - blockIdx.x / prm.splits;   // longest rows first
  const int b = blockIdx.z, G = prm.group;
  // packed: rows are the G query heads of kv head blockIdx.y, at q row 0
  const int kvh = G ? blockIdx.y : blockIdx.y / (prm.H / prm.KVH);
  const int h = G ? kvh * G : blockIdx.y;     // the (first) query head
  const int q0 = qt * BQ;
  const int rows = G ? G : min(BQ, prm.Sq - q0);   // the block's real rows
  const int row_step = G ? 0 : 1;             // q positions from one row to the next
  const int wgi = hopper::warpgroup_index();

  // The kv tiles that hold a key some row of this block may see, and this
  // split's share of them: ceil(n / splits) tiles each, in order.
  const int q_first = prm.q_offset + q0;
  const int q_last = q_first + (rows - 1) * row_step;
  int kv_end = prm.kv_valid;
  if (prm.causal) kv_end = min(kv_end, q_last + 1);
  const int kv_begin = prm.window ? max(0, q_first - prm.window + 1) : 0;
  int t_begin = kv_begin / BK;
  int t_end = max(t_begin, (kv_end + BK - 1) / BK);
  {
    const int per = (t_end - t_begin + prm.splits - 1) / prm.splits;
    t_begin = min(t_end, t_begin + split * per);
    t_end = min(t_end, t_begin + per);
  }

  if (threadIdx.x == 0) {
    hopper::mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(&k_full[s], 1);
      hopper::mbar_init(&v_full[s], 1);
      hopper::mbar_init(&k_empty[s], 4 * CONSUMERS);   // one arrival per consumer warp
      hopper::mbar_init(&v_empty[s], 4 * CONSUMERS);
    }
    hopper::mbar_init(done, 4 * CONSUMERS);
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (wgi == CONSUMERS) {                       // the producer warpgroup
    hopper::setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == 128 * CONSUMERS) {
      hopper::tma_prefetch_map(&qmap);
      hopper::tma_prefetch_map(&kmap);
      hopper::tma_prefetch_map(&vmap);
      // packed: a box of G heads of one row
      hopper::mbar_expect_tx(q_full, G ? L::NB * G * hopper::BOX_ROW_BYTES : L::Q_BYTES);
#pragma unroll
      for (int nb = 0; nb < L::NB; ++nb)
        hopper::tma_load_4d(sQ + nb * L::Q_BOX, &qmap, q_full, nb * hopper::BOX, h, q0, b);
      for (int t = t_begin; t < t_end; ++t) {
        const int i = t - t_begin, s = i % STAGES;
        const uint32_t free_parity = ((i / STAGES) & 1) ^ 1;
        unsigned char* k_s = sK + s * L::KV_BYTES;
        unsigned char* v_s = sV + s * L::KV_BYTES;
        hopper::mbar_wait(&k_empty[s], free_parity);
        hopper::mbar_expect_tx(&k_full[s], L::KV_BYTES);
#pragma unroll
        for (int nb = 0; nb < L::NB; ++nb)
          hopper::tma_load_4d(k_s + nb * L::KV_BOX, &kmap, &k_full[s], nb * hopper::BOX,
                              kvh, t * BK, b);
        hopper::mbar_wait(&v_empty[s], free_parity);
        hopper::mbar_expect_tx(&v_full[s], L::KV_BYTES);
#pragma unroll
        for (int nb = 0; nb < L::NB; ++nb)
          hopper::tma_load_4d(v_s + nb * L::KV_BOX, &vmap, &v_full[s], nb * hopper::BOX,
                              kvh, t * BK, b);
      }
      // the consumers wait without a time limit (hopper::mbar_wait_spin):
      // a lost load traps here instead
      hopper::mbar_wait(done, 0);
    }
    return;
  }

  // consumer warpgroup wgi: rows 64 wgi .. + 63 of the block
  hopper::setmaxnreg_inc<CONSUMER_REGS>();
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int r0 = wgi * 64 + warp * 16 + g;      // this thread's rows r0 and r0 + 8
  const int q_lo = q_first + wgi * 64 * row_step;   // first q position of this warpgroup
  const Softmax sm{prm.scale, prm.softcap, prm.causal, prm.window, prm.kv_valid, q_lo,
                   q_first + r0 * row_step, 8 * row_step, t4};
  // this warpgroup's own kv tiles [lo, hi); the block's others it passes on
  // (all of them where it holds no real row)
  // ping-pong only where both warpgroups hold real rows (not at one row)
  const bool pingpong = Tiles<D>::PINGPONG && rows > 64;
  int lo = t_end, hi = t_end;
  if (pingpong) {                               // both take every tile: turns pair up
    lo = t_begin;
  } else if (wgi * 64 < rows) {
    const int q_hi = q_lo + (min(rows - wgi * 64, 64) - 1) * row_step;
    int my_end = prm.kv_valid;
    if (prm.causal) my_end = min(my_end, q_hi + 1);
    lo = min(t_end, max(t_begin, prm.window ? max(0, q_lo - prm.window + 1) / BK : 0));
    hi = max(lo, min(t_end, (my_end + BK - 1) / BK));
  }
  const unsigned char* sQw = sQ + wgi * 64 * hopper::BOX_ROW_BYTES;
  auto stage = [&](int t) { return (t - t_begin) % STAGES; };
  auto parity = [&](int t) { return (uint32_t)(((t - t_begin) / STAGES) & 1); };
  auto release = [&](uint64_t* bar) {
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(bar);
  };
  auto pass = [&](int t) {                      // every key masked for these rows
    hopper::mbar_wait_spin(&k_full[stage(t)], parity(t));
    release(&k_empty[stage(t)]);
    hopper::mbar_wait_spin(&v_full[stage(t)], parity(t));
    release(&v_empty[stage(t)]);
  };
  // S = Q K_t^T: 64 rows x BK keys, both operands K-major in shared memory
  auto issue_s = [&](float (&sc)[BK / 2], int t) {
    const unsigned char* k_s = sK + stage(t) * L::KV_BYTES;
#pragma unroll
    for (int kk = 0; kk < L::DP / 16; ++kk) {
      const int box = kk / 4, off = (kk % 4) * 32;
      hopper::wgmma_ss<0, 0>(sc, hopper::desc_kmajor(sQw + box * L::Q_BOX + off),
                             hopper::desc_kmajor(k_s + box * L::KV_BOX + off), kk > 0);
    }
    hopper::wgmma_commit();
  };
  // O += P V_t: P from registers, V MN-major in shared memory (transpose bit)
  auto issue_pv = [&](float (&acc)[L::DP / 2], uint32_t (&p)[BK / 16][4], int t) {
    const unsigned char* v_s = sV + stage(t) * L::KV_BYTES;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      hopper::wgmma_rs<1>(acc, p[kk], hopper::desc_mnmajor(v_s + 2048 * kk, L::KV_BOX), 1);
    hopper::wgmma_commit();
  };

  // Ping-pong: the warpgroups issue their products in turns, ordered by
  // named barriers 1 and 2, so that one's softmax runs under the other's
  // products. Warpgroup 1 gives warpgroup 0 the first turn, and leaves out
  // its last hand-back, so that every arrival is waited for.
  int turns_left = hi - lo + 1;
  auto my_turn = [&]() {
    if (pingpong) hopper::named_sync(1 + wgi, 256);
  };
  auto your_turn = [&]() {
    if (pingpong && (--turns_left > 0 || wgi == 0)) hopper::named_arrive(2 - wgi, 256);
  };
  if (pingpong && wgi == 1 && lo < hi) hopper::named_arrive(1, 256);

  float acc[L::DP / 2];                         // O: 64 rows x DP, fp32
#pragma unroll
  for (int i = 0; i < L::DP / 2; ++i) acc[i] = 0.f;
  float m_run[2] = {NEG_INF, NEG_INF}, l_run[2] = {0.f, 0.f}, corr[2];
  float sc[BK / 2];
  uint32_t p[BK / 16][4];                       // P in bf16: the A fragments of P V

  hopper::mbar_wait_spin(q_full, 0);
  for (int t = t_begin; t < lo; ++t) pass(t);
  if (lo < hi) {
    hopper::mbar_wait_spin(&k_full[stage(lo)], parity(lo));
    hopper::fence_regs(sc);
    hopper::wgmma_fence();
    my_turn();
    issue_s(sc, lo);
    your_turn();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(sc);
    release(&k_empty[stage(lo)]);
    sm.update<BK>(sc, lo * BK, m_run, l_run, corr);
    to_bf16_fragments<BK>(sc, p);
    // In step t the tensor cores run S_t, then P_{t-1} V_{t-1}; the softmax
    // of S_t overlaps the second. O is rescaled once P_{t-1} V_{t-1} is in.
    for (int t = lo + 1; t < hi; ++t) {
      hopper::mbar_wait_spin(&k_full[stage(t)], parity(t));
      hopper::mbar_wait_spin(&v_full[stage(t - 1)], parity(t - 1));
      hopper::fence_regs(sc);
      hopper::fence_regs(acc);
      hopper::fence_regs(p);
      hopper::wgmma_fence();
      my_turn();
      issue_s(sc, t);
      issue_pv(acc, p, t - 1);
      your_turn();
      hopper::wgmma_wait<1>();                // S_t is in
      hopper::fence_regs(sc);
      release(&k_empty[stage(t)]);
      sm.update<BK>(sc, t * BK, m_run, l_run, corr);
      hopper::wgmma_wait<0>();                // P_{t-1} V_{t-1} is in
      hopper::fence_regs(acc);
      hopper::fence_regs(p);
      release(&v_empty[stage(t - 1)]);
#pragma unroll
      for (int j = 0; j < L::DP / 8; ++j) {
        acc[4 * j] *= corr[0];
        acc[4 * j + 1] *= corr[0];
        acc[4 * j + 2] *= corr[1];
        acc[4 * j + 3] *= corr[1];
      }
      to_bf16_fragments<BK>(sc, p);
    }
    hopper::mbar_wait_spin(&v_full[stage(hi - 1)], parity(hi - 1));
    hopper::fence_regs(acc);
    hopper::fence_regs(p);
    hopper::wgmma_fence();
    my_turn();
    issue_pv(acc, p, hi - 1);
    your_turn();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);
    release(&v_empty[stage(hi - 1)]);
  }
  for (int t = hi; t < t_end; ++t) pass(t);

  // rows r0 and r0 + 8; columns 8j + 2t, + 1 (pad columns are never stored).
  // Unsplit: O in bf16 and, where asked, the row log-sum-exp for the
  // backward in the softmax's base-2 domain: LSE2 = m + log2(l) of y2 =
  // log2(e) * (scaled, softcapped score), so that P = 2^(y2 - LSE2); -inf
  // where the row saw no key (m still the mask value). Split: this split's
  // normalized O in fp32 and its LSE2, for the merge. The 4 threads of a
  // quad hold the same m and l; one writes the LSE.
  const size_t split_rows = (size_t)gridDim.z * prm.Sq * prm.H;   // rows of one split
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + 8 * half;
    if (r >= rows) continue;
    const int row = G ? 0 : q0 + r, head = G ? h + r : h;
    const size_t orow = ((size_t)b * prm.Sq + row) * prm.H + head;
    const size_t lrow = ((size_t)b * prm.H + head) * prm.Sq + row;
    const float inv = 1.f / fmaxf(l_run[half], 1e-30f);
    const float lse2 = row_lse(m_run[half], l_run[half]);
    if (prm.splits > 1) {
      float* out = prm.part_o + (split * split_rows + orow) * D;
#pragma unroll
      for (int j = 0; j < L::DP / 8; ++j) {
        const int col = 8 * j + 2 * t4;
        if (col < D)
          *reinterpret_cast<float2*>(out + col) =
              make_float2(acc[4 * j + 2 * half] * inv, acc[4 * j + 2 * half + 1] * inv);
      }
      if (t4 == 0) prm.part_lse[split * split_rows + lrow] = lse2;
    } else if (G) {
      bf16* out = prm.o + orow * D;
#pragma unroll
      for (int j = 0; j < L::DP / 8; ++j) {
        const int col = 8 * j + 2 * t4;
        if (col < D)
          *reinterpret_cast<uint32_t*>(out + col) =
              pack_bf16(acc[4 * j + 2 * half] * inv, acc[4 * j + 2 * half + 1] * inv);
      }
      if (prm.lse != nullptr && t4 == 0) prm.lse[lrow] = lse2;
    } else if (prm.lse != nullptr && t4 == 0) {
      prm.lse[lrow] = lse2;
    }
  }
  if (prm.splits == 1 && !G) {
    // O in bf16 through this warpgroup's rows of the Q tile (its last
    // product is in) and out by TMA, rows past Sq and columns past D
    // clipped: 16-byte chunk j of row r at chunk j ^ (r % 8), as TMA lays
    // boxes out
    unsigned char* tile = sQ + wgi * 64 * hopper::BOX_ROW_BYTES;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = warp * 16 + g + 8 * half;
      const float inv = 1.f / fmaxf(l_run[half], 1e-30f);
#pragma unroll
      for (int j = 0; j < L::DP / 8; ++j)
        *reinterpret_cast<uint32_t*>(tile + (j / 8) * L::Q_BOX + r * hopper::BOX_ROW_BYTES +
                                     (((j % 8) ^ (r % 8)) << 4) + 4 * t4) =
            pack_bf16(acc[4 * j + 2 * half] * inv, acc[4 * j + 2 * half + 1] * inv);
    }
    hopper::fence_proxy_async();
    hopper::named_sync(4 + wgi, 128);
    if (threadIdx.x % 128 == 0 && wgi * 64 < rows) {
#pragma unroll
      for (int nb = 0; nb < L::NB; ++nb)
        hopper::tma_store_4d(&omap, tile + nb * L::Q_BOX, nb * hopper::BOX, h, q0 + wgi * 64, b);
      hopper::bulk_commit();
      hopper::bulk_wait_read<0>();            // the tile is read before the block ends
    }
  }
  if (prm.splits > 1) {
    // The group's last split to finish merges every split's rows, in split
    // order (bitwise repeatable whichever block is last): LSE2 = log2 sum_i
    // 2^LSE2_i and O = sum_i 2^(LSE2_i - LSE2) O_i; a row no split saw gets
    // O = 0 and LSE2 = -inf. Each thread's partials are made visible before
    // its block is counted; the last block reads them past L1 (ld.cg).
    const int tid = threadIdx.x;                // 0..255: the consumer warpgroups
    __threadfence();
    hopper::named_sync(3, 256);
    if (tid == 0) {
      int* count =
          prm.counters + ((size_t)b * gridDim.y + blockIdx.y) * (gridDim.x / prm.splits) + qt;
      const int last = atomicAdd(count, 1) == prm.splits - 1;
      if (last) *count = 0;                     // ready for the next call
      *last_split = last;
    }
    hopper::named_sync(3, 256);
    if (*last_split) {
      __threadfence();
      float* row_lse2 = reinterpret_cast<float*>(base);   // over Q, no longer read
      auto lse_of = [&](int r, int i) {
        const int row = G ? 0 : q0 + r, head = G ? h + r : h;
        return __ldcg(prm.part_lse + i * split_rows + ((size_t)b * prm.H + head) * prm.Sq + row);
      };
      for (int r = tid; r < rows; r += 256) {
        float m = -INFINITY, total = 0.f;
        for (int i = 0; i < prm.splits; ++i) m = fmaxf(m, lse_of(r, i));
        if (m != -INFINITY)
          for (int i = 0; i < prm.splits; ++i) total += exp2f(lse_of(r, i) - m);
        row_lse2[r] = m != -INFINITY ? m + log2f(total) : -INFINITY;
        if (prm.lse != nullptr) {
          const int row = G ? 0 : q0 + r, head = G ? h + r : h;
          prm.lse[((size_t)b * prm.H + head) * prm.Sq + row] = row_lse2[r];
        }
      }
      hopper::named_sync(3, 256);
      for (int idx = tid; idx < rows * (D / 2); idx += 256) {
        const int r = idx / (D / 2), c = 2 * (idx % (D / 2));
        const int row = G ? 0 : q0 + r, head = G ? h + r : h;
        const size_t orow = ((size_t)b * prm.Sq + row) * prm.H + head;
        const float lse2 = row_lse2[r];
        float x = 0.f, y = 0.f;
        if (lse2 != -INFINITY)
          for (int i = 0; i < prm.splits; ++i) {
            const float w = exp2f(lse_of(r, i) - lse2);
            const float2 p = __ldcg(reinterpret_cast<const float2*>(
                prm.part_o + (i * split_rows + orow) * D + c));
            x = fmaf(w, p.x, x);
            y = fmaf(w, p.y, y);
          }
        *reinterpret_cast<uint32_t*>(prm.o + orow * D + c) = pack_bf16(x, y);
      }
    }
  }
  release(done);
}

// q (B, Sq, H, D) and k, v (B, Sk, KVH, D) as 4-D maps, dims innermost first
// (D, heads, S, B), read in boxes of 64 columns x `heads_box` heads x `rows`
// rows x 1 batch.
bool encode_map(CUtensorMap* map, const void* p, int B, int S, int heads, int D,
                int heads_box, int rows) {
  const uint64_t dims[4] = {(uint64_t)D, (uint64_t)heads, (uint64_t)S, (uint64_t)B};
  const uint64_t strides[3] = {(uint64_t)D * 2, (uint64_t)heads * D * 2,
                               (uint64_t)S * heads * D * 2};
  const uint32_t box[4] = {(uint32_t)hopper::BOX, (uint32_t)heads_box, (uint32_t)rows, 1};
  return hopper::encode_bf16_map(map, p, 4, dims, strides, box);
}

template <int D>
int launch(const void* q, const void* k, const void* v, const Params& prm, int B, int Sk,
           cudaStream_t stream) {
  using L = Layout<D>;
  constexpr int bytes = L::BYTES;
  const int G = prm.group;
  CUtensorMap qm, km, vm, om;
  if (!encode_map(&qm, q, B, prm.Sq, prm.H, D, G ? G : 1, G ? 1 : BQ) ||
      !encode_map(&om, prm.o, B, prm.Sq, prm.H, D, 1, 64) ||
      !encode_map(&km, k, B, Sk, prm.KVH, D, 1, L::BK) ||
      !encode_map(&vm, v, B, Sk, prm.KVH, D, 1, L::BK))
    return static_cast<int>(cudaErrorInvalidValue);
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set = true;
  }
  const int q_tiles = G ? 1 : (prm.Sq + BQ - 1) / BQ;
  dim3 grid(q_tiles * prm.splits, G ? prm.KVH : prm.H, B);
  flash_fwd_kernel<D><<<grid, THREADS, bytes, stream>>>(qm, km, vm, om, prm);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Dynamic shared memory one block uses at head_dim D (0 if D is not built).
int flash_attention_smem_bytes(int D) {
  if (D == 64) return Layout<64>::BYTES;
  if (D == 112) return Layout<112>::BYTES;
  if (D == 128) return Layout<128>::BYTES;
  if (D == 160) return Layout<160>::BYTES;
  if (D == 256) return Layout<256>::BYTES;
  return 0;
}

// q (B,Sq,H,D), k/v (B,Sk,KVH,D), o (B,Sq,H,D): contiguous bf16, q, k and v
// 16-byte aligned. kv_valid <= Sk. lse: null (serving: nothing is written),
// or (B,H,Sq) fp32 for the rows' base-2 log-sum-exp (training). group: 0, or
// H / KVH (at most 64) with Sq = 1 to pack a kv head's query heads into one
// block. splits: 1, or the blocks each block's kv tiles are cut into, with
// part_o (splits,B,Sq,H,D) and part_lse (splits,B,H,Sq) fp32 scratch and
// int32 counters, one a block of the unsplit grid, all 0 (as the call
// leaves them). Returns a cudaError_t value: 0 when the launch was accepted.
int flash_attention_fwd_bf16(const void* q, const void* k, const void* v, void* o,
                             void* lse_out, void* part_o, void* part_lse, void* counters,
                             int B, int Sq,
                             int Sk, int H, int KVH, int D, float scale, int causal,
                             int window, float softcap, int q_offset, int kv_valid,
                             int group, int splits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1 || Sq < 1 || H < 1 || KVH < 1 || H % KVH || splits < 1 ||
      (group && (Sq != 1 || group != H / KVH || group > 64)) ||
      (splits > 1 && (part_o == nullptr || part_lse == nullptr || counters == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Params prm{static_cast<bf16*>(o), static_cast<float*>(lse_out),
                   static_cast<float*>(part_o), static_cast<float*>(part_lse),
                   static_cast<int*>(counters), Sq, H, KVH, group, splits, causal, window,
                   q_offset, kv_valid, scale, softcap};
  if (cudaError_t err = hopper::bind_thread_device(q)) return static_cast<int>(err);
  if (D == 64) return launch<64>(q, k, v, prm, B, Sk, s);
  if (D == 112) return launch<112>(q, k, v, prm, B, Sk, s);   // zamba2-7b: 3584 / 32 heads
  if (D == 128) return launch<128>(q, k, v, prm, B, Sk, s);
  if (D == 160) return launch<160>(q, k, v, prm, B, Sk, s);   // stablelm-12b: 5120 / 32 heads
  if (D == 256) return launch<256>(q, k, v, prm, B, Sk, s);   // gemma2-9b
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"

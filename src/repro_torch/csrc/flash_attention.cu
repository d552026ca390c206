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
// causal) that is 1.37e11 FLOPs = 0.139 ms against 268 MB = 0.080 ms; at
// zamba2-7b's (D=112) 0.122 ms: bound by operations, so the design is about
// keeping the tensor cores fed. It is FlashAttention-3's forward structure
// with its intra-warpgroup overlap, without its inter-warpgroup ping-pong:
//   * one block per (128-row q tile, head, batch), longest causal rows first;
//     three warpgroups, setmaxnreg moving registers from the producer (24)
//     to the two consumers (240) (at D=160 and 256 the producer is one warp:
//     see below);
//   * the producer's one thread loads Q once and K/V tiles of 96 rows (64 at
//     D=256) by TMA into a ring of 2 stages; K and V each complete on their
//     own full mbarrier and are released on their own empty one, so the next
//     K can load as soon as its stage's S is computed;
//   * consumer warpgroup w owns q rows 64w..64w+63. S_t = Q K_t^T is a
//     wgmma m64n96k16 (m64n64k16 at D=256) chain with both operands in
//     shared memory (K K-major); O += P V is a wgmma with P from registers (P rounded to bf16;
//     the accumulator layout is the A-fragment layout) and V read MN-major
//     through the transpose bit. Step t issues S_t, then P_{t-1} V_{t-1},
//     waits for S_t only, and runs the online softmax of tile t (fp32, base
//     2, ex2.approx; masks only on tiles a mask reaches into) while the
//     tensor cores finish P_{t-1} V_{t-1}; then O is rescaled and P_t packed.
//     Stages go back to the producer by one mbarrier arrival per warp; the
//     loop has no __syncthreads;
//   * tiles that the causal, window or kv_valid masks empty for the whole
//     block are never loaded; a tile empty for one warpgroup only is passed
//     over by it (it waits for the stage and releases it). Ragged Sq and Sk
//     are zero-filled by TMA past the tensor maps' edges, and the stores are
//     guarded; GQA reads kv head h / (H / KVH) by the map coordinate.
// Tiles are 128-byte swizzled boxes of 64 columns (hopper.cuh), the widest the
// swizzle takes, so D is loaded in 64-column boxes over 4-D maps
// (D, heads, S, B). At D=112 the second box reads columns 112-127 past the
// edge as zeros: both products run at D=128 and the pad columns are never
// stored. That costs 16/112 = 14% more tensor-core work at D=112 than the
// head needs; shared memory (132 224 B a block) is the same as at D=128.
// Why 96-row K/V tiles: ptxas allocates registers against the launch's cap
// of 168 a thread (384 threads), not the 240 that setmaxnreg gives the
// consumers, and with 128-row tiles S (64), P (32) and O (64) did not fit:
// it spilled and serialized every wgmma ("insufficient register
// resources"). 96-row tiles (S 48, P 24) fit with no spill and no
// serialization, and ran faster. The warpgroup index is broadcast by a
// shuffle (hopper::warpgroup_index) for the same reason: on threadIdx.x the
// compiler took every branch on it as divergent and serialized the wgmma
// there too. FA3's inter-warpgroup ping-pong, tried, ran slower here and
// serialized the wgmma again; it is not used.
//
// Head dims 160 (stablelm-12b, 5120 / 32) and 256 (gemma2-9b). O alone is
// DP / 2 fp32 registers a consumer thread: 96 at D=160 (run at 192, three
// boxes, columns 160-191 zero-filled past the edge and never stored) and 128
// at D=256, and beside S and P neither fits 168. The cap is set per SM
// sub-partition: each of the four holds 16 384 registers and takes every
// fourth warp, so 9 warps (two consumer warpgroups and a producer warp,
// tried) cap a thread at 168 as 12 do. So at these widths a block is one
// consumer warpgroup of 64 q rows and a producer warp (5 warps: cap 255),
// with no setmaxnreg (it needs whole warpgroups) and 2 stages of K/V tiles:
// 96 rows at D=160 (173 184 B of shared memory), 64 at D=256 (164 992 B).
// At D=256 96-row tiles (230 528 B) fit too, but ptxas then spilled 16
// bytes; the two ran at the same speed before the softcap below. ptxas
// (chip_smoke.py phase 1): 254 registers at D=160, 255 at D=256, no spills,
// no serialized wgmma. The cost of one consumer: each K/V tile is read for
// 64 q rows, not 128, and the softmax overlaps only this warpgroup's own
// P V.
// The tanh softcap (gemma2: 50) is c tanh(x / c) = c - 2c / (1 + e^(2x/c)):
// one ex2.approx and one rcp.approx a score, within ~1e-6 of c. tanhf's
// software sequence, tried first, was the costliest part of the kernel at
// D=256.
//
// Measured (chip_smoke.py, H100 80GB HBM3 at 700 W, PR 14): 0.378 ms at the
// serving shape, 2.7x the bound and 1.3x scaled_dot_product_attention
// (0.285 ms); ptxas: 168 registers, no spills, no serialization. What
// still holds it back: the two consumer warpgroups' softmax overlaps only
// their own P V
// (no ping-pong), and S, P and O must share 168 registers, which caps the
// K/V tile at 96 rows.
//
// Training (the backward, csrc/flash_attention_bwd.cu) needs each row's
// log-sum-exp: with a non-null `lse` the epilogue writes LSE2 = m + log2(l)
// of the base-2 scores y2 = log2(e) * (scaled, softcapped score), the domain
// the backward exponentiates in (P = 2^(y2 - LSE2)); -inf for a row that saw
// no key. The 4 threads of a quad hold the same m and l (at D=160 and 256 as
// at D<=128: one warp owns 16 rows either way). Serving passes null and
// nothing is written.
//
// Plain C interface for ctypes: every pointer and the stream are void*; the
// launch returns cudaGetLastError() so the caller can raise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = 240;
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

// The tile shape at head_dim D: consumer warpgroups (64 q rows each), kv rows
// per tile, tiles in the ring, and the producer's threads (a warpgroup that
// hands its registers to the consumers by setmaxnreg, or one warp and no
// setmaxnreg). The source note says why D=160 and 256 differ.
template <int D>
struct Tiles {
  static constexpr int CONSUMERS = 2, BK = 96, STAGES = 2, PRODUCER_THREADS = 128;
};
template <>
struct Tiles<160> {
  static constexpr int CONSUMERS = 1, BK = 96, STAGES = 2, PRODUCER_THREADS = 32;
};
template <>
struct Tiles<256> {
  static constexpr int CONSUMERS = 1, BK = 64, STAGES = 2, PRODUCER_THREADS = 32;
};

// Head dim D in 64-column boxes; D = 112 is read as 128 and D = 160 as 192
// (the last box's columns past D are zeros past the edge of the tensor map).
template <int D>
struct Layout {
  static constexpr int CONSUMERS = Tiles<D>::CONSUMERS;        // warpgroups
  static constexpr int BQ = 64 * CONSUMERS;                    // q rows per block
  static constexpr int BK = Tiles<D>::BK;                      // kv rows per tile
  static constexpr int STAGES = Tiles<D>::STAGES;              // K/V tiles in the ring
  static constexpr int THREADS = 128 * CONSUMERS + Tiles<D>::PRODUCER_THREADS;
  static constexpr bool SETMAXNREG = Tiles<D>::PRODUCER_THREADS == 128;
  static constexpr int NB = (D + hopper::BOX - 1) / hopper::BOX;
  static constexpr int DP = NB * hopper::BOX;                  // padded head dim
  static constexpr int Q_BOX = BQ * hopper::BOX_ROW_BYTES;     // bytes of one Q box
  static constexpr int KV_BOX = BK * hopper::BOX_ROW_BYTES;    // one K or V box
  static constexpr int Q_BYTES = NB * Q_BOX;
  static constexpr int KV_BYTES = NB * KV_BOX;                 // one K or V tile
  // Q, then K[STAGES], then V[STAGES], then the barriers; + alignment slack
  static constexpr int BARRIER_OFFSET = Q_BYTES + 2 * STAGES * KV_BYTES;
  static constexpr int BYTES = BARRIER_OFFSET + 128 + 1024;
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
// kernel does.
struct Softmax {
  float scale, softcap;
  int causal, window, kv_valid, q_lo, qpos, t4;

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
          const int qp = qpos + (e >= 2 ? 8 : 0);   // rows g and g + 8
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
__global__ void __launch_bounds__(Layout<D>::THREADS, 1)
flash_fwd_kernel(__grid_constant__ const CUtensorMap qmap,
                 __grid_constant__ const CUtensorMap kmap,
                 __grid_constant__ const CUtensorMap vmap, bf16* __restrict__ o,
                 float* __restrict__ lse, int Sq, int H, int KVH, float scale,
                 int causal, int window, float softcap, int q_offset, int kv_valid) {
  using L = Layout<D>;
  constexpr int BQ = L::BQ, BK = L::BK, STAGES = L::STAGES;
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

  const int qt = gridDim.x - 1 - blockIdx.x;    // longest causal rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KVH);
  const int q0 = qt * BQ;
  const int wgi = hopper::warpgroup_index();

  // The kv tiles that hold at least one key some row of this block may see.
  int kv_end = kv_valid;
  if (causal) kv_end = min(kv_end, q_offset + q0 + BQ);
  const int kv_begin = window ? max(0, q_offset + q0 - window + 1) : 0;
  const int t_begin = kv_begin / BK;
  const int t_end = (kv_end + BK - 1) / BK;

  if (threadIdx.x == 0) {
    hopper::mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(&k_full[s], 1);
      hopper::mbar_init(&v_full[s], 1);
      hopper::mbar_init(&k_empty[s], 4 * L::CONSUMERS);   // one arrival per consumer warp
      hopper::mbar_init(&v_empty[s], 4 * L::CONSUMERS);
    }

    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (wgi == L::CONSUMERS) {                    // producer warpgroup (or warp)
    if constexpr (L::SETMAXNREG) hopper::setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == 128 * L::CONSUMERS) {
      hopper::tma_prefetch_map(&qmap);
      hopper::tma_prefetch_map(&kmap);
      hopper::tma_prefetch_map(&vmap);
      hopper::mbar_expect_tx(q_full, L::Q_BYTES);
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
    }
  } else {                                      // consumer warpgroups
    // consumer warpgroup wgi: q rows q0 + 64 wgi .. + 63
    if constexpr (L::SETMAXNREG) hopper::setmaxnreg_inc<CONSUMER_REGS>();
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int g = lane / 4, t4 = lane % 4;
    const int q_lo = q_offset + q0 + wgi * 64;    // first q position of this warpgroup
    const Softmax sm{scale, softcap, causal, window, kv_valid, q_lo,
                     q_lo + warp * 16 + g, t4};
    // this warpgroup's own kv tiles [lo, hi); the block's others it passes on
    int my_end = kv_valid;
    if (causal) my_end = min(my_end, q_lo + 64);
    const int lo = min(t_end, max(t_begin, window ? max(0, q_lo - window + 1) / BK : 0));
    const int hi = max(lo, min(t_end, (my_end + BK - 1) / BK));
    const unsigned char* sQw = sQ + wgi * 64 * hopper::BOX_ROW_BYTES;
    auto stage = [&](int t) { return (t - t_begin) % STAGES; };
    auto parity = [&](int t) { return (uint32_t)(((t - t_begin) / STAGES) & 1); };
    auto release = [&](uint64_t* bar) {
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(bar);
    };
    auto pass = [&](int t) {                      // every key masked for these rows
      hopper::mbar_wait(&k_full[stage(t)], parity(t));
      release(&k_empty[stage(t)]);
      hopper::mbar_wait(&v_full[stage(t)], parity(t));
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

    float acc[L::DP / 2];                         // O: 64 rows x DP, fp32
#pragma unroll
    for (int i = 0; i < L::DP / 2; ++i) acc[i] = 0.f;
    float m_run[2] = {NEG_INF, NEG_INF}, l_run[2] = {0.f, 0.f}, corr[2];
    float sc[BK / 2];
    uint32_t p[BK / 16][4];                       // P in bf16: the A fragments of P V

    hopper::mbar_wait(q_full, 0);
    for (int t = t_begin; t < lo; ++t) pass(t);
    if (lo < hi) {
      hopper::mbar_wait(&k_full[stage(lo)], parity(lo));
      hopper::fence_regs(sc);
      hopper::wgmma_fence();
      issue_s(sc, lo);
      hopper::wgmma_wait<0>();
      hopper::fence_regs(sc);
      release(&k_empty[stage(lo)]);
      sm.update<BK>(sc, lo * BK, m_run, l_run, corr);
      to_bf16_fragments<BK>(sc, p);
      // In step t the tensor cores run S_t, then P_{t-1} V_{t-1}; the softmax
      // of S_t overlaps the second. O is rescaled once P_{t-1} V_{t-1} is in.
      for (int t = lo + 1; t < hi; ++t) {
        hopper::mbar_wait(&k_full[stage(t)], parity(t));
        hopper::mbar_wait(&v_full[stage(t - 1)], parity(t - 1));
        hopper::fence_regs(sc);
        hopper::fence_regs(acc);
        hopper::fence_regs(p);
        hopper::wgmma_fence();
        issue_s(sc, t);
        issue_pv(acc, p, t - 1);
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
      hopper::mbar_wait(&v_full[stage(hi - 1)], parity(hi - 1));
      hopper::fence_regs(acc);
      hopper::fence_regs(p);
      hopper::wgmma_fence();
      issue_pv(acc, p, hi - 1);
      hopper::wgmma_wait<0>();
      hopper::fence_regs(acc);
      release(&v_empty[stage(hi - 1)]);
    }
    for (int t = hi; t < t_end; ++t) pass(t);

// rows g and g + 8 of this warp's 16; columns 8j + 2t, + 1; pad columns
    // (D = 112) are never stored
    const int row0 = q0 + wgi * 64 + warp * 16 + g, row1 = row0 + 8;
    const float inv0 = 1.f / fmaxf(l_run[0], 1e-30f);
    const float inv1 = 1.f / fmaxf(l_run[1], 1e-30f);
    bf16* o0 = o + (((size_t)b * Sq + row0) * H + h) * D;
    bf16* o1 = o + (((size_t)b * Sq + row1) * H + h) * D;
#pragma unroll
    for (int j = 0; j < L::DP / 8; ++j) {
      const int col = 8 * j + 2 * t4;
      if (col >= D) continue;
      if (row0 < Sq)
        *reinterpret_cast<uint32_t*>(o0 + col) = pack_bf16(acc[4 * j] * inv0, acc[4 * j + 1] * inv0);
      if (row1 < Sq)
        *reinterpret_cast<uint32_t*>(o1 + col) = pack_bf16(acc[4 * j + 2] * inv1, acc[4 * j + 3] * inv1);
    }
    // The row log-sum-exp for the backward, in the softmax's base-2 domain:
    // LSE2 = m + log2(l) of y2 = log2(e) * (scaled, softcapped score), so
    // that P = 2^(y2 - LSE2). -inf where the row saw no key (m still the
    // mask value). The 4 threads of a quad hold the same m and l; one writes.
    if (lse != nullptr && t4 == 0) {
      float* lrow = lse + ((size_t)b * H + h) * Sq;
      if (row0 < Sq) lrow[row0] = row_lse(m_run[0], l_run[0]);
      if (row1 < Sq) lrow[row1] = row_lse(m_run[1], l_run[1]);
    }
  }
}

// q (B, Sq, H, D) and k, v (B, Sk, KVH, D) as 4-D maps, dims innermost first
// (D, heads, S, B), read in boxes of 64 columns x 1 head x rows x 1 batch.
bool encode_map(CUtensorMap* map, const void* p, int B, int S, int heads, int D,
                int rows) {
  const uint64_t dims[4] = {(uint64_t)D, (uint64_t)heads, (uint64_t)S, (uint64_t)B};
  const uint64_t strides[3] = {(uint64_t)D * 2, (uint64_t)heads * D * 2,
                               (uint64_t)S * heads * D * 2};
  const uint32_t box[4] = {(uint32_t)hopper::BOX, 1, (uint32_t)rows, 1};
  return hopper::encode_bf16_map(map, p, 4, dims, strides, box);
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse, int B,
           int Sq, int Sk, int H, int KVH, float scale, int causal, int window,
           float softcap, int q_offset, int kv_valid, cudaStream_t stream) {
  using L = Layout<D>;
  constexpr int bytes = L::BYTES;
  CUtensorMap qm, km, vm;
  if (!encode_map(&qm, q, B, Sq, H, D, L::BQ) ||
      !encode_map(&km, k, B, Sk, KVH, D, L::BK) ||
      !encode_map(&vm, v, B, Sk, KVH, D, L::BK))
    return static_cast<int>(cudaErrorInvalidValue);
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set = true;
  }
  dim3 grid((Sq + L::BQ - 1) / L::BQ, H, B);
  flash_fwd_kernel<D><<<grid, L::THREADS, bytes, stream>>>(
      qm, km, vm, static_cast<bf16*>(o), lse, Sq, H, KVH, scale, causal, window,
      softcap, q_offset, kv_valid);
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
// or (B,H,Sq) fp32 for the rows' base-2 log-sum-exp (training). Returns a
// cudaError_t value: 0 when the launch was accepted.
int flash_attention_fwd_bf16(const void* q, const void* k, const void* v, void* o,
                             void* lse_out, int B, int Sq, int Sk, int H, int KVH,
                             int D, float scale, int causal, int window, float softcap,
                             int q_offset, int kv_valid, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* lse = static_cast<float*>(lse_out);
  if (cudaError_t err = hopper::bind_thread_device(q)) return static_cast<int>(err);
  if (D == 64)
    return launch<64>(q, k, v, o, lse, B, Sq, Sk, H, KVH, scale, causal, window,
                      softcap, q_offset, kv_valid, s);
  if (D == 112)   // zamba2-7b: 3584 / 32 heads
    return launch<112>(q, k, v, o, lse, B, Sq, Sk, H, KVH, scale, causal, window,
                       softcap, q_offset, kv_valid, s);
  if (D == 128)
    return launch<128>(q, k, v, o, lse, B, Sq, Sk, H, KVH, scale, causal, window,
                       softcap, q_offset, kv_valid, s);
  if (D == 160)   // stablelm-12b: 5120 / 32 heads
    return launch<160>(q, k, v, o, lse, B, Sq, Sk, H, KVH, scale, causal, window,
                       softcap, q_offset, kv_valid, s);
  if (D == 256)   // gemma2-9b
    return launch<256>(q, k, v, o, lse, B, Sq, Sk, H, KVH, scale, causal, window,
                       softcap, q_offset, kv_valid, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"

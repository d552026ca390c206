// Flash attention backward for Hopper (sm_90a): bf16 in and out, fp32 sums.
//
// The gradient of csrc/flash_attention.cu's forward, which replaces the TPU
// kernel repro/kernels/flash_attention.py::flash_attention_pallas. The JAX
// package has no backward kernel (its CPU path differentiates
// ref.mha_chunked); this one makes training on the card take its gradient
// through hand-written kernels. Inputs: q, o, dO (B,Sq,H,D), k, v (B,Sk,KVH,D)
// and the forward's row log-sum-exp (B,H,Sq) fp32. Outputs dQ (B,Sq,H,D) and
// dK, dV (B,Sk,KVH,D) in bf16. Options: GQA, causal, sliding window, tanh
// softcap and a kv_valid length; q_offset is 0 (training never passes one).
// Head dims 64, 112 (run at 128), 128, 160 (run at 192) and 256: the pad
// columns are zero-filled by TMA past the tensor maps' edges and never
// stored.
//
// The LSE's domain. The forward runs its online softmax in base 2 on
// y2 = log2(e) * y, with y = x (or c tanh(x / c) under a softcap) and
// x = scale * q.k; it stores LSE2 = m + log2(l) of y2, where m is the row's
// running max and l its sum of 2^(y2 - m). So P = 2^(y2 - LSE2) here, with
// y2 computed by the forward's own instructions (ex2.approx, rcp.approx),
// and one exp2 a score. A row with no key to attend to has LSE2 = -inf; its
// P, and so every gradient it adds, is 0 (never inf - inf = NaN).
//
// Bound on the H100. Five products over the attended (q, k) pairs: S, dP,
// dV, dK and dQ, 10 B H D FLOPs a pair, at the 989 TFLOP/s bf16 peak: at
// deepseek-7b's training shape (B=2, S=2048, H=KVH=32, D=128, causal) 1.72e11
// FLOPs = 0.174 ms, against 2 x 2 x 4 x 33.5 MB of bf16 moved = 0.040 ms:
// bound by operations, so the design is about feeding the tensor cores.
//
// Design: FlashAttention-3's backward products on the primitives of
// hopper.cuh, in three kernels, deterministic: every output element is
// summed in a fixed order by one thread, with no atomics, so a backward run
// twice is bitwise equal (the restart contract, "resumes bit-identically",
// is checked on the card through it):
//   1. delta: Delta = rowsum(dO o O) in fp32, one warp per (b, q, h) row;
//   2. dkdv:  one block per (64-key tile, kv head, batch, column part) of
//             nine warps. A producer warp loads the K and V tiles once by
//             TMA, then, for each query head of the group and each step of
//             QSTEP q rows that can see a key of the tile, Q and dO by TMA
//             and LSE and Delta by its 32 lanes into a ring of stages
//             completed on mbarriers. Consumer warpgroup 0 computes
//             S^T = K Q^T (wgmma, both operands K-major), forms
//             P^T = 2^(y2 - LSE2) in registers and accumulates
//             dV += P^T dO with P^T in bf16 as the register A operand and dO
//             read MN-major through the transpose bit; it hands P^T dy (the
//             softcap's factor folded in) to warpgroup 1 through shared
//             memory (two fp32 buffers, a full and an empty mbarrier each).
//             Warpgroup 1 computes dP^T = V dO^T, forms
//             dS^T = P^T dy (dP^T - Delta) and accumulates dK += dS^T Q. So
//             P^T and dS^T are each computed once, and one warpgroup's
//             elementwise work overlaps the other's products. The GQA sum
//             over the group is the step loop;
//   3. dq:    one block per (64-row q tile, head, batch), longest causal
//             rows first: one consumer warpgroup and a producer warp. Q and
//             dO stay in shared memory; the producer streams 32-row K/V
//             tiles by TMA through the ring; the consumer recomputes
//             S = Q K^T and dP = dO V^T, forms dS and accumulates dQ += dS K
//             (dS from registers, K MN-major). Two blocks share an SM up to
//             head_dim 128.
// In both loops a step issues its first products and the previous step's
// accumulating product as one straight-line batch, then forms its P or dS
// while that product runs; the first step is peeled so that every batch in
// the loop issues the same groups. Conditional issues inside the loop (an
// earlier draft) made ptxas serialize every wgmma (C7514, C7515): it could
// not tell which group a wait retired. Accumulators are fenced only while
// no wgmma is in flight. A deeper pipeline, issuing the next step's S^T
// before this step's P^T is formed (two accumulator buffers over 32-row
// steps), was serialized too (C7515): ptxas wants every group retired
// before any accumulator is written, so a step's batch is retired before
// the next one is issued. dK and dQ are scaled by `scale` once, at the store.
// P and dS are rounded to bf16 for their products, as the forward rounds P.
//
// Registers set the plan. ptxas caps a thread by the launch's warps per SM
// sub-partition (16 384 registers, every fourth warp): 5 or 8 warps a block
// give 255, 9 to 12 warps (or two 5-warp blocks) 168. dK and dV of a 64-key
// tile take D/2 fp32 registers each a thread: at D=128 one warpgroup holding
// both and S^T, dP^T and their bf16 copies needs some 208 live registers,
// which only one 5-warp block an SM holds (the first design: 1.19 ms at
// deepseek-7b's training shape, the tensor cores idle during every
// elementwise pass). Split between two warpgroups, each holds one
// accumulator, its S^T or dP^T and one bf16 operand: 112 at D=128, under
// the 168 of nine warps. At 160 and 256 even one accumulator of D columns
// does not fit beside them, so the dkdv kernel cuts dK's and dV's columns
// into parts of at most 128 (two boxes: 128 + 64 at D=160, 128 + 128 at
// 256), one block each, and each part recomputes S^T and dP^T over the whole
// head dim (6 products' work where 4 would do); at 256 a step is 32 q rows so
// that the stages fit beside the resident K and V. The dq kernel steps over
// 32 keys so that two blocks (168 registers) hold its live set at D <= 128.
//
// dQ in a second pass (seven products in all) rather than accumulated by the
// dkdv blocks: accumulating it there deterministically needs dS (not dS^T)
// as an operand, so dS through shared memory and a dQ sum ordered across
// blocks (a semaphore per q tile), and dQ's fp32 partial tile in registers
// beside dK or dV, which the 168 cap does not hold at D >= 128. Not
// measured.
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

constexpr float LOG2E = 1.4426950408889634f;
constexpr int ROWS = 64;            // keys of a dkdv block, q rows of a dq block
constexpr int KSTEP = 32;           // keys of a dq step
constexpr int DKDV_THREADS = 288;   // the P and the dS warpgroups and a producer warp
constexpr int DQ_THREADS = 160;     // one consumer warpgroup and a producer warp
constexpr int DELTA_WARPS = 8;
constexpr int TILE_BOX = ROWS * hopper::BOX_ROW_BYTES;    // one 64-row box: 8 KB
constexpr int SM_SMEM = 233472;     // shared memory of one SM; a block reserves 1 KB more

// The tile plan at head_dim D (kernels/flash_attention.py BWD_TILES): D in
// 64-column boxes, dK/dV's column parts of at most two boxes, the dkdv
// kernel's q rows a step and stages, the dq kernel's stages, and the dq
// blocks an SM holds: two wherever two blocks' shared memory fits, so that
// one block's elementwise work overlaps the other's products.
template <int D>
struct Tiles {
  static constexpr int NB = (D + hopper::BOX - 1) / hopper::BOX;
  static constexpr int TILE = NB * TILE_BOX;                // one 64-row tile, every box
  static constexpr int QSTEP = NB <= 3 ? 64 : 32;           // q rows of a dkdv step
  static constexpr int QBOX = QSTEP * hopper::BOX_ROW_BYTES;
  static constexpr int QTILE = NB * QBOX;
  static constexpr int KTILE = NB * KSTEP * hopper::BOX_ROW_BYTES;   // one 32-row K or V tile
  static constexpr int DKDV_STAGES = NB <= 2 ? 3 : 2;
  static constexpr int DQ_STAGES = 4;
  // dkdv: K, V, (Q, dO) per stage, two buffers of P dy (64 keys x QSTEP,
  // fp32), then LSE and Delta per stage
  static constexpr int DKDV_PBUF = 2 * TILE + 2 * DKDV_STAGES * QTILE;
  static constexpr int DKDV_VEC = DKDV_PBUF + 2 * ROWS * QSTEP * 4;
  static constexpr int DKDV_BAR = DKDV_VEC + DKDV_STAGES * 2 * QSTEP * 4;
  // dq: Q, dO, then (K, V) per stage
  static constexpr int DQ_BAR = 2 * TILE + 2 * DQ_STAGES * KTILE;
  static constexpr int DKDV_BYTES = DKDV_BAR + 128 + 1024;   // + barriers, alignment slack
  static constexpr int DQ_BYTES = DQ_BAR + 128 + 1024;
  static constexpr int DQ_BLOCKS = 2 * (DQ_BYTES + 1024) <= SM_SMEM ? 2 : 1;
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // .x (lo) in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float fast_rcp(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The forward's score transform and its masks.
struct Score {
  float scale, softcap;
  int Sq, causal, window, kv_valid;

  // y2 of the raw product s, by the forward's instructions; dy = dy/dx (the
  // softcap's 1 - tanh^2, else 1)
  __device__ __forceinline__ float y2(float s, float& dy) const {
    if (softcap > 0.f) {        // c tanh(x / c) log2(e) = cL - 2 cL / (1 + 2^(2 x L / c))
      const float cl = softcap * LOG2E, k = 2.f * scale * LOG2E / softcap;
      const float r = fast_rcp(1.f + fast_exp2(s * k));
      const float t = fmaf(-2.f, r, 1.f);       // tanh(x / c)
      dy = fmaf(-t, t, 1.f);
      return fmaf(-2.f * cl, r, cl);
    }
    dy = 1.f;
    return s * (scale * LOG2E);
  }

  __device__ __forceinline__ bool visible(int qp, int kp) const {
    bool ok = qp < Sq && kp < kv_valid;
    if (causal) ok = ok && kp <= qp;
    if (window) ok = ok && qp - kp < window;
    return ok;
  }

  // whether some pair of the tile of NQ q rows from q0 and NK keys from k0
  // is masked
  template <int NQ, int NK>
  __device__ __forceinline__ bool tile_masked(int q0, int k0) const {
    return q0 + NQ > Sq || k0 + NK > kv_valid || (causal && k0 + NK - 1 > q0) ||
           (window && q0 + NQ - 1 - k0 >= window);
  }

  // P of one score (0 where masked or where the row attends to nothing)
  // and its softcap factor dy
  __device__ __forceinline__ float p(float s, float lse, int qp, int kp, bool masked,
                                     float& dy) const {
    const float pe = fast_exp2(y2(s, dy) - lse);
    return masked && !(visible(qp, kp) && lse != -INFINITY) ? 0.f : pe;
  }
};

// acc (64 x N) = A B^T over DP: A a 64-row tile and B an N-row tile of NB
// boxes, both K-major in shared memory (S^T = K Q^T and dP^T = V dO^T over
// 32 q rows, S = Q K^T and dP = dO V^T over 64 keys). One commit group.
template <int NB, int N>
__device__ __forceinline__ void issue_nt(float (&acc)[N / 2], const unsigned char* a,
                                         const unsigned char* b) {
  constexpr int B_BOX = N * hopper::BOX_ROW_BYTES;
#pragma unroll
  for (int kk = 0; kk < NB * 4; ++kk) {
    const int off = (kk % 4) * 32;
    hopper::wgmma_ss<0, 0>(acc, hopper::desc_kmajor(a + (kk / 4) * TILE_BOX + off),
                           hopper::desc_kmajor(b + (kk / 4) * B_BOX + off), kk > 0);
  }
  hopper::wgmma_commit();
}

// acc (64 x 64 PB) += X B: X (64 x K) from registers (the A fragments of its
// k16 slices), B the PB boxes at b of a K-row tile, its rows the
// contraction, read MN-major (dV += P^T dO and dK += dS^T Q over 32 q rows,
// dQ += dS K over 64 keys). One commit group.
template <int PB, int K>
__device__ __forceinline__ void issue_rn(float (&acc)[32 * PB],
                                         const uint32_t (&x)[K / 16][4],
                                         const unsigned char* b) {
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk)
    hopper::wgmma_rs<1>(acc, x[kk],
                        hopper::desc_mnmajor(b + 2048 * kk, K * hopper::BOX_ROW_BYTES), 1);
  hopper::wgmma_commit();
}

// 64 rows x 64 PB columns of fp32 accumulators (rows row0 and row0 + 8 of
// this thread, columns col0 + 8j + 2t) times `mul`, to bf16 rows of a
// (.., heads, D) tensor; rows at or past n_rows and columns past D are not
// stored.
template <int D, int PB>
__device__ __forceinline__ void store_rows(bf16* out, const float (&acc)[32 * PB], float mul,
                                           int row0, int col0, int n_rows, size_t row_stride,
                                           int t4) {
#pragma unroll
  for (int j = 0; j < 8 * PB; ++j) {
    const int col = col0 + 8 * j + 2 * t4;
    if (col >= D) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = row0 + 8 * half;
      if (row < n_rows)
        *reinterpret_cast<uint32_t*>(out + (size_t)row * row_stride + col) =
            pack_bf16(acc[4 * j + 2 * half] * mul, acc[4 * j + 2 * half + 1] * mul);
    }
  }
}

__device__ __forceinline__ void release(uint64_t* bar, int lane) {
  __syncwarp();
  if (lane == 0) hopper::mbar_arrive(bar);
}

template <int D>
__global__ void __launch_bounds__(DELTA_WARPS * 32)
flash_bwd_delta_kernel(const bf16* __restrict__ o, const bf16* __restrict__ dout,
                       float* __restrict__ delta, int rows, int Sq, int H) {
  const int row = blockIdx.x * DELTA_WARPS + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (row >= rows) return;                    // row = (b Sq + s) H + h
  const bf16* o_r = o + (size_t)row * D;
  const bf16* d_r = dout + (size_t)row * D;
  float acc = 0.f;
  for (int c = 2 * lane; c < D; c += 64) {
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(o_r + c));
    const float2 d = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(d_r + c));
    acc = fmaf(a.x, d.x, acc);
    acc = fmaf(a.y, d.y, acc);
  }
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, m);
  if (lane == 0) {
    const int h = row % H, s = (row / H) % Sq, b = row / (H * Sq);
    delta[((size_t)b * H + h) * Sq + s] = acc;
  }
}

// dK and dV of columns [128 part, 128 part + 64 PB) of one 64-key tile.
// Warpgroup 0 computes S^T and P^T and owns dV; warpgroup 1 computes dP^T
// and dS^T and owns dK; P^T dy crosses from the first to the second through
// shared memory (two buffers, a full and an empty mbarrier each), so each
// is computed once and the two warpgroups' products and elementwise work
// overlap. Warp 8 is the producer.
template <int D, int PB>
__global__ void __launch_bounds__(DKDV_THREADS, 1)
flash_bwd_dkdv_kernel(__grid_constant__ const CUtensorMap qmap,   // QSTEP-row boxes
                      __grid_constant__ const CUtensorMap kmap,
                      __grid_constant__ const CUtensorMap vmap,
                      __grid_constant__ const CUtensorMap omap,   // dO, QSTEP-row boxes
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      bf16* __restrict__ dk, bf16* __restrict__ dv, int Sk, int H, int KVH,
                      int part, Score sc) {
  using T = Tiles<D>;
  constexpr int NB = T::NB, STAGES = T::DKDV_STAGES, QS = T::QSTEP, NE = QS / 2;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* sK = base;
  unsigned char* sV = base + T::TILE;
  auto sQ = [&](int s) { return base + 2 * T::TILE + 2 * s * T::QTILE; };
  auto sO = [&](int s) { return base + 2 * T::TILE + (2 * s + 1) * T::QTILE; };
  float* pbuf = reinterpret_cast<float*>(base + T::DKDV_PBUF);   // [2][NE][128]
  float* sVec = reinterpret_cast<float*>(base + T::DKDV_VEC);    // [STAGES][LSE QS, Delta QS]
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(base + T::DKDV_BAR);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + STAGES;
  uint64_t* p_full = empty + STAGES;
  uint64_t* p_empty = p_full + 2;

  const int Sq = sc.Sq;
  const int k0 = blockIdx.x * ROWS, kvh = blockIdx.y, b = blockIdx.z;
  const int G = H / KVH;
  // the q rows [q_lo, q_hi) that can see a key of this tile, in QS-row steps
  const int q_lo = sc.causal ? k0 : 0;
  int q_hi = Sq;
  if (sc.window) q_hi = min(q_hi, k0 + ROWS - 1 + sc.window);
  if (k0 >= sc.kv_valid) q_hi = 0;
  const int qt_lo = q_lo / QS;
  const int nqt = q_hi > q_lo ? (q_hi + QS - 1) / QS - qt_lo : 0;
  const int items = G * nqt;                  // (query head, q step) pairs
  auto item_q0 = [&](int i) { return (qt_lo + i % nqt) * QS; };
  auto item_h = [&](int i) { return kvh * G + i / nqt; };

  if (threadIdx.x == 0) {
    hopper::mbar_init(kv_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(&full[s], 1 + 32);     // the TMA bytes, and each producer lane's vectors
      hopper::mbar_init(&empty[s], 8);         // one arrival per consumer warp
    }
    for (int i = 0; i < 2; ++i) {
      hopper::mbar_init(&p_full[i], 128);      // each thread of warpgroup 0 has written
      hopper::mbar_init(&p_empty[i], 128);     // each thread of warpgroup 1 has read
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  const int lane = threadIdx.x % 32, wg = hopper::warpgroup_index();
  if (wg == 2) {                              // the producer warp
    if (items == 0) return;
    if (lane == 0) {
      hopper::tma_prefetch_map(&qmap);
      hopper::tma_prefetch_map(&kmap);
      hopper::tma_prefetch_map(&vmap);
      hopper::tma_prefetch_map(&omap);
      hopper::mbar_expect_tx(kv_full, 2 * T::TILE);
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        hopper::tma_load_4d(sK + nb * TILE_BOX, &kmap, kv_full, nb * hopper::BOX, kvh, k0, b);
        hopper::tma_load_4d(sV + nb * TILE_BOX, &vmap, kv_full, nb * hopper::BOX, kvh, k0, b);
      }
    }
    for (int i = 0; i < items; ++i) {
      const int s = i % STAGES, h = item_h(i), q0 = item_q0(i);
      if (lane == 0) hopper::mbar_wait(&empty[s], ((i / STAGES) & 1) ^ 1);
      __syncwarp();
      if (lane == 0) {
        hopper::mbar_expect_tx(&full[s], 2 * T::QTILE);
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) {
          hopper::tma_load_4d(sQ(s) + nb * T::QBOX, &qmap, &full[s], nb * hopper::BOX, h, q0, b);
          hopper::tma_load_4d(sO(s) + nb * T::QBOX, &omap, &full[s], nb * hopper::BOX, h, q0, b);
        }
      }
      // the step's LSE and Delta; rows past Sq 0 (the masks zero their P)
      const size_t vec = ((size_t)b * H + h) * Sq;
      float* v_s = sVec + s * 2 * QS;
      for (int r = lane; r < QS; r += 32) {
        const bool ok = q0 + r < Sq;
        v_s[r] = ok ? lse[vec + q0 + r] : 0.f;
        v_s[QS + r] = ok ? delta[vec + q0 + r] : 0.f;
      }
      hopper::mbar_arrive(&full[s]);
    }
    return;
  }

  // the consumer warpgroups: keys kr0 and kr0 + 8 of this thread
  const int tid = threadIdx.x % 128, warp = tid / 32, g = lane / 4, t4 = lane % 4;
  const int kr0 = k0 + warp * 16 + g;
  const int part_off = part * 2 * T::QBOX;    // the part's first box in a q tile
  const unsigned char* a_tile = wg == 0 ? sK : sV;   // S^T = K Q^T, dP^T = V dO^T
  float acc[32 * PB];                         // dV (warpgroup 0) or dK (1): 64 keys x 64 PB
#pragma unroll
  for (int i = 0; i < 32 * PB; ++i) acc[i] = 0.f;

  if (items > 0) {
    float sacc[NE];                           // S^T or dP^T: 64 keys x QS q
    uint32_t frag[QS / 16][4];                // P^T or dS^T in bf16: A fragments
    // S^T = K Q^T (warpgroup 0) or dP^T = V dO^T (1) of step i
    auto issue_first = [&](int i) {
      const int s = i % STAGES;
      issue_nt<NB, QS>(sacc, wg == 0 ? sK : sV, wg == 0 ? sQ(s) : sO(s));
    };
    // dV += P^T dO (warpgroup 0) or dK += dS^T Q (1) of step i
    auto issue_second = [&](int i) {
      const int s = i % STAGES;
      issue_rn<PB, QS>(acc, frag, (wg == 0 ? sO(s) : sQ(s)) + part_off);
    };
    // step i's S^T (dP^T) is in: P^T (dS^T) in fp32, in place
    auto form = [&](int i) {
      const int s = i % STAGES, q0 = item_q0(i), buf = i & 1, use = i >> 1;
      const float* v_s = sVec + s * 2 * QS;
      float* pb = pbuf + buf * NE * 128 + tid;
      if (wg == 0) {                          // P^T = 2^(y2 - LSE2); P^T dy to warpgroup 1
        const bool masked = sc.tile_masked<QS, ROWS>(q0, k0);
        hopper::mbar_wait(&p_empty[buf], (use & 1) ^ 1);
#pragma unroll
        for (int j = 0; j < QS / 8; ++j) {    // q columns 8j + 2t, + 1 (rows kr0, kr0 + 8)
          const int ql = 8 * j + 2 * t4;
          const float2 l = *reinterpret_cast<const float2*>(v_s + ql);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float dy;
            sacc[4 * j + e] = sc.p(sacc[4 * j + e], (e & 1) ? l.y : l.x, q0 + ql + (e & 1),
                                   kr0 + (e >= 2 ? 8 : 0), masked, dy);
            pb[(4 * j + e) * 128] = sacc[4 * j + e] * dy;
          }
        }
        hopper::mbar_arrive(&p_full[buf]);
      } else {                                // dS^T = P^T dy (dP^T - Delta)
        hopper::mbar_wait(&p_full[buf], use & 1);
#pragma unroll
        for (int j = 0; j < QS / 8; ++j) {
          const float2 dl = *reinterpret_cast<const float2*>(v_s + QS + 8 * j + 2 * t4);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            sacc[4 * j + e] = pb[(4 * j + e) * 128] * (sacc[4 * j + e] - ((e & 1) ? dl.y : dl.x));
        }
        hopper::mbar_arrive(&p_empty[buf]);
      }
    };
    auto pack = [&]() {
#pragma unroll
      for (int j = 0; j < QS / 8; ++j) {
        frag[j / 2][(j % 2) * 2] = pack_bf16(sacc[4 * j], sacc[4 * j + 1]);
        frag[j / 2][(j % 2) * 2 + 1] = pack_bf16(sacc[4 * j + 2], sacc[4 * j + 3]);
      }
    };
    auto fence_all = [&]() {
      hopper::fence_regs(sacc);
      hopper::fence_regs(acc);
      hopper::fence_regs(frag);
      hopper::wgmma_fence();
    };

    hopper::mbar_wait(kv_full, 0);
    hopper::mbar_wait(&full[0], 0);
    fence_all();
    issue_first(0);
    hopper::wgmma_wait<0>();
    hopper::fence_regs(sacc);
    form(0);
    pack();
    // step i issues S^T_i (dP^T_i) and step i - 1's dV (dK) as one batch,
    // then forms step i's P^T (dS^T) while dV (dK) runs
    for (int i = 1; i < items; ++i) {
      hopper::mbar_wait(&full[i % STAGES], (i / STAGES) & 1);
      fence_all();
      issue_first(i);
      issue_second(i - 1);
      hopper::wgmma_wait<1>();                // S^T_i (dP^T_i) is in
      hopper::fence_regs(sacc);
      form(i);
      hopper::wgmma_wait<0>();                // step i - 1's dV (dK) is in: its stage is free
      hopper::fence_regs(acc);
      hopper::fence_regs(frag);
      release(&empty[(i - 1) % STAGES], lane);
      pack();
    }
    fence_all();
    issue_second(items - 1);
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);
    hopper::fence_regs(frag);
    release(&empty[(items - 1) % STAGES], lane);
  }
  const size_t kv_stride = (size_t)KVH * D;
  const size_t out = ((size_t)b * Sk * KVH + kvh) * D;
  store_rows<D, PB>((wg == 0 ? dv : dk) + out, acc, wg == 0 ? 1.f : sc.scale, kr0, part * 128,
                    Sk, kv_stride, t4);
}

template <int D>
__global__ void __launch_bounds__(DQ_THREADS, Tiles<D>::DQ_BLOCKS)
flash_bwd_dq_kernel(__grid_constant__ const CUtensorMap qmap,
                    __grid_constant__ const CUtensorMap kmap,
                    __grid_constant__ const CUtensorMap vmap,
                    __grid_constant__ const CUtensorMap omap,   // dO
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    bf16* __restrict__ dq, int H, int KVH, Score sc) {
  using T = Tiles<D>;
  constexpr int NB = T::NB, STAGES = T::DQ_STAGES;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* sQ = base;
  unsigned char* sO = base + T::TILE;
  auto sK = [&](int s) { return base + 2 * T::TILE + 2 * s * T::KTILE; };
  auto sV = [&](int s) { return base + 2 * T::TILE + (2 * s + 1) * T::KTILE; };
  uint64_t* q_full = reinterpret_cast<uint64_t*>(base + T::DQ_BAR);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + STAGES;

  const int Sq = sc.Sq;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * ROWS;   // longest causal rows first
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / (H / KVH);
  // the 32-key steps [t_lo, t_hi) that hold a key some row of this block sees
  int kv_end = sc.kv_valid;
  if (sc.causal) kv_end = min(kv_end, q0 + ROWS);
  const int kv_begin = sc.window ? max(0, q0 - sc.window + 1) : 0;
  const int t_lo = kv_begin / KSTEP;
  const int t_hi = kv_end > kv_begin ? (kv_end + KSTEP - 1) / KSTEP : t_lo;

  if (threadIdx.x == 0) {
    hopper::mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 4);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  const int lane = threadIdx.x % 32;
  if (hopper::warpgroup_index() == 1) {       // the producer warp
    if (lane != 0 || t_hi == t_lo) return;
    hopper::tma_prefetch_map(&qmap);
    hopper::tma_prefetch_map(&kmap);
    hopper::tma_prefetch_map(&vmap);
    hopper::tma_prefetch_map(&omap);
    hopper::mbar_expect_tx(q_full, 2 * T::TILE);
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      hopper::tma_load_4d(sQ + nb * TILE_BOX, &qmap, q_full, nb * hopper::BOX, h, q0, b);
      hopper::tma_load_4d(sO + nb * TILE_BOX, &omap, q_full, nb * hopper::BOX, h, q0, b);
    }
    for (int t = t_lo; t < t_hi; ++t) {
      const int i = t - t_lo, s = i % STAGES;
      hopper::mbar_wait(&empty[s], ((i / STAGES) & 1) ^ 1);
      hopper::mbar_expect_tx(&full[s], 2 * T::KTILE);
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        constexpr int KBOX = KSTEP * hopper::BOX_ROW_BYTES;
        hopper::tma_load_4d(sK(s) + nb * KBOX, &kmap, &full[s], nb * hopper::BOX, kvh,
                            t * KSTEP, b);
        hopper::tma_load_4d(sV(s) + nb * KBOX, &vmap, &full[s], nb * hopper::BOX, kvh,
                            t * KSTEP, b);
      }
    }
    return;
  }

  // the consumer warpgroup: q rows r0 and r0 + 8 of this thread
  const int warp = threadIdx.x / 32, g = lane / 4, t4 = lane % 4;
  const int r0 = q0 + warp * 16 + g;
  const size_t vec = ((size_t)b * H + h) * Sq;
  const float lr[2] = {r0 < Sq ? lse[vec + r0] : 0.f, r0 + 8 < Sq ? lse[vec + r0 + 8] : 0.f};
  const float dl[2] = {r0 < Sq ? delta[vec + r0] : 0.f,
                       r0 + 8 < Sq ? delta[vec + r0 + 8] : 0.f};
  float dq_acc[32 * NB];
#pragma unroll
  for (int i = 0; i < 32 * NB; ++i) dq_acc[i] = 0.f;

  if (t_hi > t_lo) {
    float s_acc[KSTEP / 2], dp[KSTEP / 2];    // S (then P dy, then dS) and dP: 64 q x 32 keys
    uint32_t ds[KSTEP / 16][4];               // dS in bf16: A fragments
    const int n = t_hi - t_lo;
    auto issue_sdp = [&](int i) {             // S = Q K^T and dP = dO V^T of key step t_lo + i
      issue_nt<NB, KSTEP>(s_acc, sQ, sK(i % STAGES));
      issue_nt<NB, KSTEP>(dp, sO, sV(i % STAGES));
    };
    auto issue_dq = [&](int i) { issue_rn<NB, KSTEP>(dq_acc, ds, sK(i % STAGES)); };
    auto form_p = [&](int i) {                // S is in: P dy in place
      const int kt0 = (t_lo + i) * KSTEP;
      const bool masked = sc.tile_masked<ROWS, KSTEP>(q0, kt0);
#pragma unroll
      for (int j = 0; j < KSTEP / 8; ++j)     // keys 8j + 2t, + 1 (rows r0, r0 + 8)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float dy;
          s_acc[4 * j + e] = sc.p(s_acc[4 * j + e], lr[e >> 1], r0 + (e >= 2 ? 8 : 0),
                                  kt0 + 8 * j + 2 * t4 + (e & 1), masked, dy) * dy;
        }
    };
    auto form_ds = [&]() {                    // dP is in: dS = P dy (dP - Delta)
#pragma unroll
      for (int e = 0; e < KSTEP / 2; ++e) s_acc[e] *= dp[e] - dl[(e >> 1) & 1];
    };
    auto pack = [&]() {
#pragma unroll
      for (int j = 0; j < KSTEP / 8; ++j) {
        ds[j / 2][(j % 2) * 2] = pack_bf16(s_acc[4 * j], s_acc[4 * j + 1]);
        ds[j / 2][(j % 2) * 2 + 1] = pack_bf16(s_acc[4 * j + 2], s_acc[4 * j + 3]);
      }
    };
    auto fence_all = [&]() {
      hopper::fence_regs(s_acc);
      hopper::fence_regs(dp);
      hopper::fence_regs(dq_acc);
      hopper::fence_regs(ds);
      hopper::wgmma_fence();
    };

    hopper::mbar_wait(q_full, 0);
    hopper::mbar_wait(&full[0], 0);
    fence_all();
    issue_sdp(0);
    hopper::wgmma_wait<1>();
    hopper::fence_regs(s_acc);
    form_p(0);
    hopper::wgmma_wait<0>();
    hopper::fence_regs(dp);
    form_ds();
    pack();
    // step i issues S_i, dP_i and step i - 1's dQ as one batch, then forms
    // dS_i while dQ runs
    for (int i = 1; i < n; ++i) {
      hopper::mbar_wait(&full[i % STAGES], (i / STAGES) & 1);
      fence_all();
      issue_sdp(i);
      issue_dq(i - 1);
      hopper::wgmma_wait<2>();                // S_i is in
      hopper::fence_regs(s_acc);
      form_p(i);
      hopper::wgmma_wait<1>();                // dP_i is in
      hopper::fence_regs(dp);
      form_ds();
      hopper::wgmma_wait<0>();                // step i - 1's dQ is in: its stage is free
      hopper::fence_regs(dq_acc);
      hopper::fence_regs(ds);
      release(&empty[(i - 1) % STAGES], lane);
      pack();
    }
    fence_all();
    issue_dq(n - 1);
    hopper::wgmma_wait<0>();
    hopper::fence_regs(dq_acc);
    hopper::fence_regs(ds);
    release(&empty[(n - 1) % STAGES], lane);
  }
  store_rows<D, NB>(dq + (((size_t)b * Sq) * H + h) * D, dq_acc, sc.scale, r0, 0, Sq,
                    (size_t)H * D, t4);
}

// q, dO (B, Sq, H, D) and k, v (B, Sk, KVH, D) as 4-D maps, dims innermost
// first (D, heads, S, B), read in boxes of 64 columns x 1 head x `rows` rows
// x 1 batch.
bool encode_map(CUtensorMap* map, const void* p, int B, int S, int heads, int D, int rows) {
  const uint64_t dims[4] = {(uint64_t)D, (uint64_t)heads, (uint64_t)S, (uint64_t)B};
  const uint64_t strides[3] = {(uint64_t)D * 2, (uint64_t)heads * D * 2,
                               (uint64_t)S * heads * D * 2};
  const uint32_t box[4] = {(uint32_t)hopper::BOX, 1, (uint32_t)rows, 1};
  return hopper::encode_bf16_map(map, p, 4, dims, strides, box);
}

// K and V in 64-row boxes (dkdv) and 32-row ones (dq); Q and dO in 64-row
// boxes (dq) and QSTEP-row ones (dkdv)
struct Maps {
  CUtensorMap q, o, q_step, o_step, k, v, k_step, v_step;
};

template <int D, int PB>
int launch_dkdv(const Maps& m, const float* lse, const float* delta, void* dk, void* dv,
                int B, int Sk, int H, int KVH, int part, const Score& sc,
                cudaStream_t stream) {
  constexpr int bytes = Tiles<D>::DKDV_BYTES;
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<D, PB>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set = true;
  }
  flash_bwd_dkdv_kernel<D, PB><<<dim3((Sk + ROWS - 1) / ROWS, KVH, B), DKDV_THREADS, bytes,
                                 stream>>>(m.q_step, m.k, m.v, m.o_step, lse, delta,
                                           static_cast<bf16*>(dk), static_cast<bf16*>(dv),
                                           Sk, H, KVH, part, sc);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* o, const void* dout,
           const void* lse, void* delta, void* dq, void* dk, void* dv, int B, int Sq, int Sk,
           int H, int KVH, const Score& sc, cudaStream_t stream) {
  using T = Tiles<D>;
  Maps m;
  if (!encode_map(&m.q, q, B, Sq, H, D, ROWS) || !encode_map(&m.o, dout, B, Sq, H, D, ROWS) ||
      !encode_map(&m.q_step, q, B, Sq, H, D, T::QSTEP) ||
      !encode_map(&m.o_step, dout, B, Sq, H, D, T::QSTEP) ||
      !encode_map(&m.k, k, B, Sk, KVH, D, ROWS) || !encode_map(&m.v, v, B, Sk, KVH, D, ROWS) ||
      !encode_map(&m.k_step, k, B, Sk, KVH, D, KSTEP) ||
      !encode_map(&m.v_step, v, B, Sk, KVH, D, KSTEP))
    return static_cast<int>(cudaErrorInvalidValue);
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_kernel<D>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           T::DQ_BYTES);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set = true;
  }
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  const int rows = B * Sq * H;
  flash_bwd_delta_kernel<D><<<(rows + DELTA_WARPS - 1) / DELTA_WARPS, DELTA_WARPS * 32, 0,
                              stream>>>(static_cast<const bf16*>(o),
                                        static_cast<const bf16*>(dout), dl, rows, Sq, H);
  int err = static_cast<int>(cudaGetLastError());
  // dK and dV in column parts of two boxes, the last of one where NB is odd
  if constexpr (T::NB >= 2)
    for (int part = 0; !err && part < T::NB / 2; ++part)
      err = launch_dkdv<D, 2>(m, l, dl, dk, dv, B, Sk, H, KVH, part, sc, stream);
  if constexpr (T::NB % 2 == 1)
    if (!err) err = launch_dkdv<D, 1>(m, l, dl, dk, dv, B, Sk, H, KVH, T::NB / 2, sc, stream);
  if (err) return err;
  flash_bwd_dq_kernel<D><<<dim3((Sq + ROWS - 1) / ROWS, H, B), DQ_THREADS, T::DQ_BYTES,
                           stream>>>(m.q, m.k_step, m.v_step, m.o, l, dl,
                                     static_cast<bf16*>(dq), H, KVH, sc);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Dynamic shared memory of one block of the dkdv (pass 0) or dq (pass 1)
// kernel at head_dim D; 0 if D is not built.
int flash_attention_bwd_smem_bytes(int D, int pass) {
  if (D == 64) return pass ? Tiles<64>::DQ_BYTES : Tiles<64>::DKDV_BYTES;
  if (D == 112) return pass ? Tiles<112>::DQ_BYTES : Tiles<112>::DKDV_BYTES;
  if (D == 128) return pass ? Tiles<128>::DQ_BYTES : Tiles<128>::DKDV_BYTES;
  if (D == 160) return pass ? Tiles<160>::DQ_BYTES : Tiles<160>::DKDV_BYTES;
  if (D == 256) return pass ? Tiles<256>::DQ_BYTES : Tiles<256>::DKDV_BYTES;
  return 0;
}

// q, o, dout, dq (B,Sq,H,D); k, v, dk, dv (B,Sk,KVH,D): contiguous bf16,
// 16-byte aligned; lse (B,H,Sq) fp32 from the forward, delta (B,H,Sq) fp32
// scratch. kv_valid <= Sk. Launches the delta, dkdv (one launch per column
// part) and dq kernels on the stream. Returns a cudaError_t value: 0 when
// every launch was accepted.
int flash_attention_bwd_bf16(const void* q, const void* k, const void* v, const void* o,
                             const void* dout, const void* lse, void* delta, void* dq,
                             void* dk, void* dv, int B, int Sq, int Sk, int H, int KVH,
                             int D, float scale, int causal, int window, float softcap,
                             int kv_valid, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Score sc{scale, softcap, Sq, causal, window, kv_valid};
  if (B < 1 || Sq < 1 || Sk < 1 || H < 1 || KVH < 1 || H % KVH)
    return static_cast<int>(cudaErrorInvalidValue);
  if (cudaError_t err = hopper::bind_thread_device(q)) return static_cast<int>(err);
  if (D == 64)
    return launch<64>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, Sq, Sk, H, KVH, sc, s);
  if (D == 112)   // zamba2-7b: 3584 / 32 heads, run at 128
    return launch<112>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, Sq, Sk, H, KVH, sc, s);
  if (D == 128)
    return launch<128>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, Sq, Sk, H, KVH, sc, s);
  if (D == 160)   // stablelm-12b: 5120 / 32 heads, run at 192
    return launch<160>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, Sq, Sk, H, KVH, sc, s);
  if (D == 256)   // gemma2-9b
    return launch<256>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, Sq, Sk, H, KVH, sc, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"

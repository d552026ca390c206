// Device and host pieces shared by the SSD scan's wgmma kernels: the forward
// (ssd_scan.cu) and the backward (ssd_scan_bwd.cu).
//
// The block shape both use: one consumer warpgroup (threads 0-127, 64 rows of
// wgmma) and one producer warp (threads 128-159) that feeds 64-step tiles by
// TMA. chunk_state_kernel forms each chunk's local state for both (and the
// local state gradient for the backward). chunk_cum forms the chunk's cumulative log-decay with every rounding
// explicit, so every kernel that calls it, forward or backward, sees bitwise
// the same cum. split_bf16 carries an fp32 operand as bf16 hi + lo for the
// tensor cores. The tensor maps read the model's layouts: (B, L, heads,
// width) for x, dy, b and c, and (B nc H, P, N) for the chunk states.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace ssd {

typedef __nv_bfloat16 bf16;

constexpr int CONSUMERS = 128;              // one warpgroup: 64 rows of wgmma
constexpr int THREADS = CONSUMERS + 32;     // and one producer warp
constexpr int ROWS = 64;                    // steps of one tile
constexpr int P = 64;                       // the one head_dim the wgmma kernels take
constexpr int QMAX = 256;                   // longest chunk: two steps a consumer thread
constexpr int BOXB = ROWS * hopper::BOX_ROW_BYTES;   // one 64 x 64 bf16 box
constexpr float LOG2E = 1.4426950408889634f;
constexpr int STAGES = 2;                   // tiles in the TMA ring
constexpr int PASS_THREADS = 256;           // state passes: 4 entries a thread
constexpr int PASS_ENTRIES = 4 * PASS_THREADS;

// Barrier 0 is __syncthreads; the consumer warpgroup syncs on its own.
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" :: "n"(CONSUMERS) : "memory");
}

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

// Element (r, col) of a 64-column bf16 box as TMA lands it with the 128-byte
// swizzle: 16-byte chunk c of row r at chunk c ^ (r % 8) (hopper.cuh).
__device__ __forceinline__ float box_at(const unsigned char* box, int r, int col) {
  const int off = r * hopper::BOX_ROW_BYTES + ((((col >> 3) ^ r) & 7) << 4) + ((col & 7) << 1);
  return __bfloat162float(*reinterpret_cast<const bf16*>(box + off));
}

// 2^x by the special-function unit (ex2.approx: relative error ~2^-22).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// (v0, v1) as hi + lo bf16 pairs: hi = bf16(v), lo = bf16(v - hi). v - hi is
// exact in fp32, and hi + lo keeps about 16 significant bits of v.
__device__ __forceinline__ void split_bf16(float v0, float v1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);   // .x (v0) low half
  const float2 hf = __bfloat1622float2(h);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(v0 - hf.x, v1 - hf.y));
}

// A 64 x 64 fp32 accumulator (the m64n64 layout, hopper.cuh) split into the
// hi + lo A fragments of a product over its 64 columns: n8 blocks 2 kk and
// 2 kk + 1 are the k16 slice kk.
__device__ __forceinline__ void split_fragments(const float (&d)[32], uint32_t (&hi)[4][4],
                                                uint32_t (&lo)[4][4]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    split_bf16(d[4 * j], d[4 * j + 1], hi[j / 2][(j % 2) * 2], lo[j / 2][(j % 2) * 2]);
    split_bf16(d[4 * j + 2], d[4 * j + 3], hi[j / 2][(j % 2) * 2 + 1],
               lo[j / 2][(j % 2) * 2 + 1]);
  }
}

// The chunk's dt and cum_s = sum_{r<=s} dt_r A for s < Q <= 256 into sDt and
// sCum, by the 128 consumer threads, thread i taking steps 2i and 2i + 1.
// Every rounding is explicit (no contraction into FMAs can differ), so each
// kernel that calls it sees bitwise the same cum.
__device__ inline void chunk_cum(const float* __restrict__ dtg, int dt_stride, float A, int Q,
                                 float* sDt, float* sCum, float* warp_tot) {
  const int i = threadIdx.x, lane = i & 31, warp = i >> 5, s0 = 2 * i;
  const float d0 = s0 < Q ? dtg[(size_t)s0 * dt_stride] : 0.f;
  const float d1 = s0 + 1 < Q ? dtg[(size_t)(s0 + 1) * dt_stride] : 0.f;
  const float a0 = __fmul_rn(d0, A), a1 = __fmul_rn(d1, A);
  float v = __fadd_rn(a0, a1);
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float n = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v = __fadd_rn(v, n);
  }
  float before = __shfl_up_sync(0xffffffffu, v, 1);
  if (lane == 0) before = 0.f;
  if (lane == 31) warp_tot[warp] = v;
  consumer_sync();
  float base = 0.f;
  for (int w = 0; w < warp; ++w) base = __fadd_rn(base, warp_tot[w]);
  const float c0 = __fadd_rn(__fadd_rn(base, before), a0);
  const float c1 = __fadd_rn(c0, a1);
  if (s0 < Q) {
    sDt[s0] = d0;
    sCum[s0] = c0;
  }
  if (s0 + 1 < Q) {
    sDt[s0 + 1] = d1;
    sCum[s0 + 1] = c1;
  }
  consumer_sync();
}

// Shared memory of chunk_state: the ring of (x or dy box, N/64 b or c
// boxes) stages, then a full and an empty barrier a stage; + slack to align
// to 1024.
template <int N>
struct StateLayout {
  static constexpr int NB = N / 64;
  static constexpr int STAGE = (1 + NB) * BOXB;
  static constexpr int BARRIER_OFFSET = STAGES * STAGE;
  static constexpr int BYTES = BARRIER_OFFSET + 2 * STAGES * 8 + 1024;
};

// Block (chunk c of half k, head h, batch b), the chunk index blockIdx.x =
// k nc + c: for k = 0 (the forward's only half) the chunk's local state
// s_loc[b,c,h] (P x N, fp32) = sum_s x_s^T (dt_s e^{tot - cum_s}) b_s and
// tot[b,c,h] = cum_{Q-1}; for k = 1 (the backward's second half) its local
// state gradient ds_loc[b,c,h] = sum_t dy_t^T e^{cum_t} c_t. The product is
// P x N over the chunk's Q steps on wgmma: A = the scaled x^T (or dy^T)
// from registers as bf16 hi + lo, B = b (or c) MN-major from shared memory.
template <int N>
__global__ void __launch_bounds__(THREADS)
chunk_state_kernel(__grid_constant__ const CUtensorMap xmap,
                   __grid_constant__ const CUtensorMap bmap,
                   __grid_constant__ const CUtensorMap dymap,
                   __grid_constant__ const CUtensorMap cmap,
                   const float* __restrict__ dt, const float* __restrict__ a_log,
                   float* __restrict__ s_loc, float* __restrict__ ds_loc,
                   float* __restrict__ tot_out, int L, int H, int G, int Q, int nc) {
  using Lay = StateLayout<N>;
  constexpr int NB = Lay::NB;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  __shared__ float sDt[QMAX], sCum[QMAX], sW[QMAX], warp_tot[CONSUMERS / 32];
  unsigned char* base = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + Lay::BARRIER_OFFSET);
  uint64_t* empty = full + STAGES;

  const int grad = blockIdx.x >= nc, c = blockIdx.x - grad * nc;
  const int h = blockIdx.y, b = blockIdx.z, g = h / (H / G);
  const int l0 = c * Q, ntiles = Q / ROWS;
  const CUtensorMap* vmap = grad ? &dymap : &xmap;
  const CUtensorMap* rmap = grad ? &cmap : &bmap;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], CONSUMERS / 32);   // one arrival a warp
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (hopper::warpgroup_index() == 1) {               // producer warp
    if (threadIdx.x == CONSUMERS) {
      hopper::tma_prefetch_map(vmap);
      hopper::tma_prefetch_map(rmap);
      for (int i = 0; i < ntiles; ++i) {
        const int s = i % STAGES;
        unsigned char* st = base + s * Lay::STAGE;
        hopper::mbar_wait(&empty[s], ((i / STAGES) & 1) ^ 1);
        hopper::mbar_expect_tx(&full[s], Lay::STAGE);
        hopper::tma_load_4d(st, vmap, &full[s], 0, h, l0 + i * ROWS, b);
#pragma unroll
        for (int nb = 0; nb < NB; ++nb)
          hopper::tma_load_4d(st + (1 + nb) * BOXB, rmap, &full[s], nb * hopper::BOX,
                              g, l0 + i * ROWS, b);
      }
    }
    return;
  }

  // consumer warpgroup: rows p0 and p0 + 8 of A = (v w)^T
  const float A = -expf(a_log[h]);
  chunk_cum(dt + ((size_t)b * L + l0) * H + h, H, A, Q, sDt, sCum, warp_tot);
  const float tot = sCum[Q - 1];
  for (int s = threadIdx.x; s < Q; s += CONSUMERS)
    sW[s] = grad ? expf(sCum[s]) : sDt[s] * expf(tot - sCum[s]);
  consumer_sync();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int p0 = warp * 16 + lane / 4, t4 = lane % 4;
  float acc[NB][32];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int k = 0; k < 32; ++k) acc[nb][k] = 0.f;

  for (int i = 0; i < ntiles; ++i) {
    const int s = i % STAGES;
    const unsigned char* st = base + s * Lay::STAGE;
    const float* w = sW + i * ROWS;
    hopper::mbar_wait(&full[s], (i / STAGES) & 1);
    // the A fragments of the four k16 slices: register e holds row
    // p0 + 8 (e & 1), steps 16 kk + 2 t4 + 8 (e >> 1) and the next one
    uint32_t ahi[4][4], alo[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = 16 * kk + 2 * t4 + 8 * (e >> 1), p = p0 + 8 * (e & 1);
        split_bf16(box_at(st, r, p) * w[r], box_at(st, r + 1, p) * w[r + 1],
                   ahi[kk][e], alo[kk][e]);
      }
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) hopper::fence_regs(acc[nb]);
    hopper::fence_regs(ahi);
    hopper::fence_regs(alo);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        const uint64_t bd = hopper::desc_mnmajor(st + (1 + nb) * BOXB + 2048 * kk, BOXB);
        hopper::wgmma_rs<1>(acc[nb], ahi[kk], bd, 1);
        hopper::wgmma_rs<1>(acc[nb], alo[kk], bd, 1);
      }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) hopper::fence_regs(acc[nb]);
    hopper::fence_regs(ahi);
    hopper::fence_regs(alo);
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&empty[s]);
  }

  // rows p0, p0 + 8; columns 64 nb + 8 j + 2 t4 and the next one
  const size_t bch = ((size_t)b * nc + c) * H + h;
  float* out = (grad ? ds_loc : s_loc) + bch * P * N;
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = nb * 64 + 8 * j + 2 * t4;
      *reinterpret_cast<float2*>(out + (size_t)p0 * N + n) =
          make_float2(acc[nb][4 * j], acc[nb][4 * j + 1]);
      *reinterpret_cast<float2*>(out + (size_t)(p0 + 8) * N + n) =
          make_float2(acc[nb][4 * j + 2], acc[nb][4 * j + 3]);
    }
  if (!grad && threadIdx.x == 0) tot_out[bch] = tot;
}

// A (B, L, heads, width) bf16 tensor as a 4-D map (width, heads, L, B) read
// in boxes of 64 columns x 1 head x 64 steps x 1 batch.
inline bool encode_steps_map(CUtensorMap* map, const void* p, int B, int L, int heads,
                             int width) {
  const uint64_t dims[4] = {(uint64_t)width, (uint64_t)heads, (uint64_t)L, (uint64_t)B};
  const uint64_t strides[3] = {(uint64_t)width * 2, (uint64_t)heads * width * 2,
                               (uint64_t)L * heads * width * 2};
  const uint32_t box[4] = {(uint32_t)hopper::BOX, 1, (uint32_t)ROWS, 1};
  return hopper::encode_bf16_map(map, p, 4, dims, strides, box);
}

// (B, nc, H, P, N) bf16 chunk states as a 3-D map (N, P, B nc H) read in
// boxes of 64 columns x 64 rows x 1 matrix.
inline bool encode_state_map(CUtensorMap* map, const void* p, int mats, int N) {
  const uint64_t dims[3] = {(uint64_t)N, (uint64_t)P, (uint64_t)mats};
  const uint64_t strides[2] = {(uint64_t)N * 2, (uint64_t)P * N * 2};
  const uint32_t box[3] = {(uint32_t)hopper::BOX, (uint32_t)P, 1};
  return hopper::encode_bf16_map(map, p, 3, dims, strides, box);
}

}  // namespace ssd

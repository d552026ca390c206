// Mamba2 chunked SSD scan backward for Hopper (sm_90a): two variants.
//
// The gradient of csrc/ssd_scan.cu's forward, which replaces the TPU kernel
// repro/kernels/ssd_scan.py::ssd_scan_pallas. JAX cannot differentiate the
// Pallas kernel; the reference's gradient is that of ref.ssd_chunked, and
// this is its counterpart on the card. For x (B,L,H,P), dt (B,L,H) fp32,
// a_log and d_skip (H,) fp32, b and c (B,L,G,N), the output gradient dy
// (B,L,H,P) and an optional gradient of the final state dstate (B,H,P,N)
// fp32, it returns dx (x's dtype), ddt (fp32), da_log and dd_skip (H,) fp32
// and db, dc (b's dtype).
//
// The math, per (batch, head) and chunk of Q steps, with A = -e^{a_log},
// cum_t = sum_{r<=t} dt_r A, tot = cum_{Q-1}, u_s = dt_s x_s, S_in the state
// entering the chunk and Gs the gradient of the state leaving it:
//   reverse state pass:  Gs_{c-1} = e^{tot_c} Gs_c + sum_t e^{cum_t} dy_t c_t^T
//   W_ts = (c_t . b_s) e^{cum_t - cum_s},  V_ts = (dy_t . u_s) e^{cum_t - cum_s}
//   (s <= t), M = (C B^T) o V:
//   du_s = sum_t W_ts dy_t + e^{tot - cum_s} Gs b_s;  dx = dt du + D dy
//   dc_t = sum_s V_ts b_s + e^{cum_t} S_in^T dy_t
//   db_s = sum_t V_ts c_t + e^{tot - cum_s} Gs^T u_s
//   d cum_t = sum_s M_ts - sum_t' M_t't + e^{cum_t} dy_t . (S_in c_t) - K_t,
//     K_s = e^{tot - cum_s} u_s . (Gs b_s); the last step also gets
//     d tot = sum_s K_s + e^{tot} <Gs, S_in>
//   d la_r = sum_{t>=r} d cum_t;  ddt = x . du + A d la;
//   da_log = A sum dt d la;  dd_skip = sum dy . x
// and db, dc are summed over the H/G heads of each group. The decay is
// formed per element and masked before it is exponentiated: cum reaches
// about -410 in a chunk, and e^{cum_t} e^{-cum_s} would overflow. Every
// exponent taken is <= 0 for dt >= 0. Both variants are deterministic: no
// atomics, every sum in a fixed order, so a backward run twice is bitwise
// equal (the restart contract needs it).
//
// Bound on the H100. Work per (b, h, chunk): C B^T and dY U^T over the
// causal half (Q^2 N and Q^2 P), W^T dY, V B and V^T C (Q^2 P + 2 Q^2 N), the
// state terms dY S_in, B Gs^T, U Gs (6 Q N P) and the chunk's two state
// products (4 Q N P), FLOPs counted as 2 a multiply-add. At zamba2-7b's
// training shape (B=2, L=2048, H=112, P=64, N=64, G=2, chunk 256) that is
// about 5.6e10 FLOPs against about 0.2 GB of inputs and outputs: 0.06 ms at
// the bf16 tensor-core peak, bound by operations.
//
// Variant "wgmma" (bf16, P = 64, N in {64, 128}, Q a multiple of 64 up to
// 256: every model shape, the forward's wgmma set), five kernels launched in
// order on one stream:
//   1. chunk_state, the forward's own kernel (ssd_common.cuh) over two
//      halves, one block per (chunk, head, batch) in each: over (x, b) the
//      chunk's local state s_loc = sum_s x_s^T (dt_s e^{tot - cum_s}) b_s
//      and tot, over (dy, c) its local state gradient ds_loc = sum_t
//      (e^{cum_t} dy_t)^T c_t; A the scaled x^T or dy^T from registers as
//      bf16 hi + lo, B from TMA;
//   2. state_pass, one block per (1024 state entries, head, batch): the only
//      sequential part, on the CUDA cores (pure bandwidth): S forward over
//      the chunks and Gs back over them, each written as bf16 hi + lo for
//      the next kernels, and each block's share of e^{tot} <Gs, S_in> (S_in
//      as hi + lo), which belongs to d tot;
//   3. rows, one block per (64-row t tile, head, chunk and batch), shaped
//      like flash's forward: dc = e^{cum_t} dY S_in (S_in hi and lo from
//      shared memory), then per s tile up to the diagonal C B^T and dY X^T
//      (wgmma, both operands the bf16 inputs, so the products are exact),
//      V = (dY X^T) dt_s e^{cum_t - cum_s} and M = (C B^T) o V per element
//      in fp32, dc += V B with V from registers as hi + lo; the row sums of
//      M and c_t . (e^{cum_t} S_in^T dy_t) by quad shuffles give d cum's
//      row part. No split is needed for dY U^T: dt_s is applied after;
//   4. cols, one block per (64-row s tile, head, chunk and batch), shaped
//      like flash's dK/dV: du = e^{tot - cum_s} B Gs^T and db = e^{tot -
//      cum_s} dt_s X Gs (Gs hi and lo), then per t tile from the diagonal
//      on the transposes B C^T and X dY^T, whose accumulators have s rows:
//      W^T = (B C^T) o decay and V^T = (X dY^T) dt_s o decay, du += W^T dY
//      and db += V^T C (W^T, V^T from registers as hi + lo). The column sums
//      of M are row sums of M^T in registers, with no shared-memory
//      reduction; the block writes dx = dt du + D dy, x . du, d cum's
//      column part -sum_t M_ts - K_s, and the tile's sums of K and dy . x;
//   5. reduce: blocks 0 .. H-1, one a head, walk (batch, chunk) in order:
//      d cum = row + column part (+ d tot at the chunk's last step, from
//      the K sums and the state pass's shares), its reverse scan d la, ddt,
//      and da_log and dd_skip; the other blocks sum db and dc over each
//      group's heads.
//   Each wgmma kernel has one producer warp that streams 64-step tiles by
//   TMA (4-D maps over (B,L,H,P) and (B,L,G,N), 128-byte swizzled
//   64-column boxes, N = 128 in two) into a ring of 2 stages on mbarriers,
//   and one consumer warpgroup; all of them recompute cum with the
//   forward's chunk_cum (ssd_common.cuh), so they see bitwise the same
//   decay. Each batch of wgmma is straight-line and retired before an
//   accumulator is written (ptxas serializes every wgmma otherwise), so a
//   step issues its products, waits, and then works on the CUDA cores.
//   Precision: every product with an fp32 operand (the scaled x and dy,
//   S_in, Gs, V, W) runs twice, on hi and on lo, into the same fp32 sums:
//   about 2^-17 relative, under the 1e-4 limit on the fp32 gradients.
//   C B^T is formed once a pass on the tensor cores (the fma variant forms
//   it twice a pass on the CUDA cores). db and dc leave the passes per head
//   in fp32 ((B,L,H,N) each, about 470 MB of traffic with the reduce's
//   reads at zamba2-7b, about 0.14 ms): a pass that summed a group's 56
//   heads itself would need atomics, or blocks that each walk a group's
//   heads (128 blocks at zamba2-7b, under the card's 132 SMs, each 56 heads
//   long), so the design keeps them.
//
// Variant "fma" (fp32, and bf16 shapes outside the set above), fp32 FMA on
// the CUDA cores, three kernels:
//   1. states, one block per (P-slice, head, batch): a loop over the chunks
//      that recomputes the fp32 state entering each, then a loop back over
//      them that carries Gs; both written in fp32.
//   2. chunks, one block per (P-slice and chunk, head, batch): every
//      gradient above for its P-slice. A row pass over the 64-row t tiles
//      (dc, and the row and column sums of M into d cum) and a column pass
//      over the 64-row s tiles (du, dx, db), each recomputing the (t, s)
//      tiles of C B^T and dY U^T up to the diagonal; then the reverse scan
//      of d cum within the chunk. Whatever contracts over P (dc, db, d cum)
//      is linear in the slice, so each slice writes partials: per head and
//      slice for db and dc, per (slice, batch, chunk) for da_log and dd_skip.
//   3. reduce: db and dc over each group's heads and the slices, ddt over
//      the slices, da_log and dd_skip over slices, batch and chunks.
//
// Plain C interface for ctypes: every pointer and the stream are void*; the
// launches return cudaGetLastError() so the caller can raise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"
#include "ssd_common.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int THREADS = 256;      // 16 x 16 threads: ty = tid / 16, tx = tid % 16
constexpr int TILE = 64;          // rows of t or s per tile
constexpr int QMAX = THREADS;     // the scans give each thread one step
constexpr int NMAX = 128;         // at most N / 16 = 8 columns of n a thread
constexpr int LDW = TILE + 4;     // row stride of the W and V tiles (floats)
constexpr int REDUCE_THREADS = 256;

__host__ __device__ constexpr int ld_n(int N) { return N + 4; }   // rows of b, c, states

// Shared memory of one block, in floats. states: cum[QMAX], dt[QMAX],
// R[TILE][ld_n] (b or c), V[TILE][PS + 4] (u or dy), S[PS][ld_n]. chunks:
// cum, dt, d cum's row and column parts and x . du, each [QMAX]; C, B
// [TILE][ld_n]; DY, U [TILE][PS + 4]; W, V [TILE][LDW]; S_in, Gs [PS][ld_n].
__host__ __device__ constexpr int states_floats(int N, int PS) {
  return 2 * QMAX + TILE * ld_n(N) + TILE * (PS + 4) + PS * ld_n(N);
}
__host__ __device__ constexpr int chunks_floats(int N, int PS) {
  return 5 * QMAX + 2 * TILE * ld_n(N) + 2 * TILE * (PS + 4) + 2 * TILE * LDW +
         2 * PS * ld_n(N);
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(bf16* p, float v) { *p = __float2bfloat16(v); }

__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

// Inclusive prefix sum over the block, one value per thread.
__device__ float block_scan(float v, float* warp_tot) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    float n = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += n;
  }
  if (lane == 31) warp_tot[warp] = v;
  __syncthreads();
  for (int w = 0; w < warp; ++w) v += warp_tot[w];
  __syncthreads();                  // warp_tot is free again
  return v;
}

// Sum over the block in a fixed order; every thread gets the total.
__device__ float block_sum(float v, float* warp_tot) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) warp_tot[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.f;
  for (int w = 0; w < THREADS / 32; ++w) s += warp_tot[w];
  __syncthreads();
  return s;
}

// Sum over the 16 threads of one row (same ty: one half of a warp). Every
// thread of the warp must call it.
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// dst[r][col] = src[r * row_stride + col] in fp32 for r < TILE, col < cols;
// rows at or past `rows` are zero.
template <typename T>
__device__ void load_rows(float* dst, int ld, const T* src, size_t row_stride,
                          int rows, int cols) {
  for (int e = threadIdx.x; e < TILE * cols; e += THREADS) {
    int r = e / cols, col = e - r * cols;
    dst[r * ld + col] = r < rows ? to_f(src[(size_t)r * row_stride + col]) : 0.f;
  }
}

// U[r][p] = x[r][p] * dt[r] in fp32, as load_rows.
template <typename T>
__device__ void load_u(float* dst, int ld, const T* src, size_t row_stride,
                       const float* dts, int rows, int cols) {
  for (int e = threadIdx.x; e < TILE * cols; e += THREADS) {
    int r = e / cols, col = e - r * cols;
    dst[r * ld + col] = r < rows ? to_f(src[(size_t)r * row_stride + col]) * dts[r] : 0.f;
  }
}

// o[r][c] = a_row(ty + 16 r) . b_row(tx + 16 c) over K columns (K % 4 == 0).
__device__ __forceinline__ void tile_dot(float (&o)[4][4], const float* a,
                                         const float* b, int ld, int K) {
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) o[r][c] = 0.f;
  for (int k = 0; k < K; k += 4) {
    float4 av[4], bv[4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
      av[r] = *reinterpret_cast<const float4*>(a + (ty + 16 * r) * ld + k);
#pragma unroll
    for (int c = 0; c < 4; ++c)
      bv[c] = *reinterpret_cast<const float4*>(b + (tx + 16 * c) * ld + k);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) o[r][c] += dot4(av[r], bv[c]);
  }
}

// The chunk's dt and cum into shared memory (one step a thread, Q <= 256).
__device__ void chunk_cum(const float* dtg, int H, float A, int Q, float* sDt,
                          float* sCum, float* warp_tot) {
  const int tid = threadIdx.x;
  const float d = tid < Q ? dtg[(size_t)tid * H] : 0.f;
  const float cum = block_scan(d * A, warp_tot);
  if (tid < Q) {
    sDt[tid] = d;
    sCum[tid] = cum;
  }
  __syncthreads();
}

// acc[cc][k] (entry p = tx + 16 cc, n = ty + 16 k) += sum_s w_s v_s[p] r_s[n]
// over one 64-row tile: the outer products of a chunk's state (v = u, r = b,
// w = e^{tot - cum_s}) or of its gradient (v = dy, r = c, w = e^{cum_t}).
template <int PS>
__device__ __forceinline__ void outer_tile(float (&acc)[PS / 16][NMAX / 16],
                                           const float* sV, const float* sR,
                                           const float* w, int rows, int nk,
                                           int ldn) {
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  for (int s = 0; s < rows; ++s) {
    float v[PS / 16];
#pragma unroll
    for (int cc = 0; cc < PS / 16; ++cc) v[cc] = sV[s * (PS + 4) + tx + 16 * cc] * w[s];
#pragma unroll
    for (int k = 0; k < NMAX / 16; ++k) {
      if (k < nk) {
        const float r = sR[s * ldn + ty + 16 * k];
#pragma unroll
        for (int cc = 0; cc < PS / 16; ++cc) acc[cc][k] += v[cc] * r;
      }
    }
  }
}

// ---- kernel 1: the states entering each chunk, and their gradients --------

template <typename T, int PS>
__global__ void __launch_bounds__(THREADS)
ssd_bwd_states_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                      const float* __restrict__ a_log, const T* __restrict__ bm,
                      const T* __restrict__ cm, const T* __restrict__ dy,
                      const float* __restrict__ dstate, float* __restrict__ s_in,
                      float* __restrict__ gs, int L, int H, int P, int G, int N, int Q) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float warp_tot[THREADS / 32];
  __shared__ float sW[QMAX];
  const int ldn = ld_n(N), ldp = PS + 4;
  float* sCum = smem;
  float* sDt = sCum + QMAX;
  float* sR = sDt + QMAX;
  float* sV = sR + TILE * ldn;
  float* sS = sV + TILE * ldp;

  const int p0 = blockIdx.x * PS, h = blockIdx.y, b = blockIdx.z;
  const int g = h / (H / G), nc = L / Q;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const float A = -expf(a_log[h]);
  const size_t xrow = (size_t)H * P, brow = (size_t)G * N;
  const T* xg = x + ((size_t)b * L * H + h) * P + p0;
  const T* dyg = dy + ((size_t)b * L * H + h) * P + p0;
  const float* dtg = dt + (size_t)b * L * H + h;
  const T* bg = bm + ((size_t)b * L * G + g) * N;
  const T* cg = cm + ((size_t)b * L * G + g) * N;
  const int nk = N / 16, ntiles = (Q + TILE - 1) / TILE;
  // slice p0 of the (b, chunk, h) state: entry (p, n) at + p * N + n
  auto state_at = [&](float* base, int ci) {
    return base + (((size_t)b * nc + ci) * H + h) * P * N + (size_t)p0 * N;
  };

  for (int e = tid; e < PS * ldn; e += THREADS) sS[e] = 0.f;
  for (int dir = 0; dir < 2; ++dir) {      // 0: states forward; 1: gradients back
    if (dir == 1) {
      __syncthreads();
      for (int e = tid; e < PS * N; e += THREADS) {
        const int p = e / N, n = e - p * N;
        sS[p * ldn + n] = dstate ? dstate[(((size_t)b * H + h) * P + p0) * N + e] : 0.f;
      }
    }
    for (int step = 0; step < nc; ++step) {
      const int ci = dir ? nc - 1 - step : step, l0 = ci * Q;
      chunk_cum(dtg + (size_t)l0 * H, H, A, Q, sDt, sCum, warp_tot);
      const float tot = sCum[Q - 1];
      if (tid < Q) sW[tid] = dir ? expf(sCum[tid]) : expf(tot - sCum[tid]);
      float* out = state_at(dir ? gs : s_in, ci);
      for (int e = tid; e < PS * N; e += THREADS) {
        const int p = e / N, n = e - p * N;
        out[e] = sS[p * ldn + n];
      }
      float acc[PS / 16][NMAX / 16];
#pragma unroll
      for (int cc = 0; cc < PS / 16; ++cc)
#pragma unroll
        for (int k = 0; k < NMAX / 16; ++k) acc[cc][k] = 0.f;
      for (int js = 0; js < ntiles; ++js) {
        const int s0 = js * TILE, rows = min(TILE, Q - s0);
        const size_t o = (size_t)(l0 + s0);
        if (dir) {
          load_rows(sR, ldn, cg + o * brow, brow, rows, N);
          load_rows(sV, ldp, dyg + o * xrow, xrow, rows, PS);
        } else {
          load_rows(sR, ldn, bg + o * brow, brow, rows, N);
          load_u(sV, ldp, xg + o * xrow, xrow, sDt + s0, rows, PS);
        }
        __syncthreads();
        outer_tile<PS>(acc, sV, sR, sW + s0, rows, nk, ldn);
        __syncthreads();              // sR, sV are refilled next
      }
      const float et = expf(tot);
#pragma unroll
      for (int cc = 0; cc < PS / 16; ++cc)
#pragma unroll
        for (int k = 0; k < NMAX / 16; ++k)
          if (k < nk) {
            float* sp = sS + (tx + 16 * cc) * ldn + ty + 16 * k;
            *sp = *sp * et + acc[cc][k];
          }
      __syncthreads();
    }
  }
}

// ---- kernel 2: every gradient of one chunk and P-slice ---------------------

template <typename T, int PS>
__global__ void __launch_bounds__(THREADS)
ssd_bwd_chunks_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                      const float* __restrict__ a_log, const T* __restrict__ bm,
                      const T* __restrict__ cm, const float* __restrict__ d_skip,
                      const T* __restrict__ dy, const float* __restrict__ s_in,
                      const float* __restrict__ gs, T* __restrict__ dx,
                      float* __restrict__ ddt_part, float* __restrict__ db_part,
                      float* __restrict__ dc_part, float* __restrict__ da_part,
                      float* __restrict__ dd_part, int B, int L, int H, int P, int G,
                      int N, int Q) {
  constexpr int NC = PS / 16;          // columns of p a thread
  extern __shared__ __align__(16) float smem[];
  __shared__ float warp_tot[THREADS / 32];
  const int ldn = ld_n(N), ldp = PS + 4;
  float* sCum = smem;
  float* sDt = sCum + QMAX;
  float* sRow = sDt + QMAX;            // d cum: sums over s, the S_in term
  float* sCol = sRow + QMAX;           // d cum: -(sums over t), -K
  float* sXdu = sCol + QMAX;           // x . du
  float* sC = sXdu + QMAX;
  float* sB = sC + TILE * ldn;
  float* sDY = sB + TILE * ldn;
  float* sU = sDY + TILE * ldp;
  float* sW = sU + TILE * ldp;
  float* sV = sW + TILE * LDW;
  float* sS = sV + TILE * LDW;
  float* sG = sS + PS * ldn;

  const int nc = L / Q;
  const int sl = blockIdx.x / nc, ci = blockIdx.x - sl * nc;
  const int p0 = sl * PS, h = blockIdx.y, b = blockIdx.z, g = h / (H / G);
  const int l0 = ci * Q;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const float A = -expf(a_log[h]), D = d_skip[h];
  const size_t xrow = (size_t)H * P, brow = (size_t)G * N;
  const size_t xoff = ((size_t)(b * L + l0) * H + h) * P + p0;
  const T* xg = x + xoff;
  const T* dyg = dy + xoff;
  T* dxg = dx + xoff;
  const float* dtg = dt + (size_t)(b * L + l0) * H + h;
  const T* bg = bm + ((size_t)(b * L + l0) * G + g) * N;
  const T* cg = cm + ((size_t)(b * L + l0) * G + g) * N;
  const size_t soff = (((size_t)b * nc + ci) * H + h) * P * N + (size_t)p0 * N;
  // per-head partials of this slice: step l of the chunk at + l * H * N
  const size_t poff = ((((size_t)sl * B + b) * L + l0) * H + h) * N;
  const int nk = N / 16, ntiles = (Q + TILE - 1) / TILE;

  chunk_cum(dtg, H, A, Q, sDt, sCum, warp_tot);
  if (tid < Q) sRow[tid] = sCol[tid] = 0.f;
  for (int e = tid; e < PS * N; e += THREADS) {
    const int p = e / N, n = e - p * N;
    sS[p * ldn + n] = s_in[soff + e];
    sG[p * ldn + n] = gs[soff + e];
  }
  __syncthreads();
  const float tot = sCum[Q - 1];

  // the masked tiles of one (t tile, s tile) pair: W = (C B^T) o decay and
  // V = (dY U^T) o decay into sW and sV, or (row pass) M = (C B^T) o V into
  // sW in place of W
  auto pair_tiles = [&](int t0, int s0, bool m_in_w) {
    float cb[4][4], du[4][4];
    tile_dot(cb, sC, sB, ldn, N);
    tile_dot(du, sDY, sU, ldp, PS);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int t = t0 + ty + 16 * r;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int s = s0 + tx + 16 * c;
        float w = 0.f, v = 0.f;
        if (s <= t && t < Q) {       // mask before exponentiating
          const float e = expf(sCum[t] - sCum[s]);
          w = cb[r][c] * e;
          v = du[r][c] * e;
        }
        sW[(ty + 16 * r) * LDW + tx + 16 * c] = m_in_w ? cb[r][c] * v : w;
        sV[(ty + 16 * r) * LDW + tx + 16 * c] = v;
      }
    }
  };

  // ---- row pass: dc per t tile, and d cum's row and column sums of M
  for (int it = 0; it < ntiles; ++it) {
    const int t0 = it * TILE, rows_t = min(TILE, Q - t0);
    load_rows(sC, ldn, cg + (size_t)t0 * brow, brow, rows_t, N);
    load_rows(sDY, ldp, dyg + (size_t)t0 * xrow, xrow, rows_t, PS);
    __syncthreads();
    // dc (t = ty + 16 r, n = tx + 16 k) = e^{cum_t} S_in^T dy_t to start
    float acc[4][NMAX / 16];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int k = 0; k < NMAX / 16; ++k) acc[r][k] = 0.f;
    for (int p = 0; p < PS; ++p) {
      float dv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) dv[r] = sDY[(ty + 16 * r) * ldp + p];
#pragma unroll
      for (int k = 0; k < NMAX / 16; ++k)
        if (k < nk) {
          const float sv = sS[p * ldn + tx + 16 * k];
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[r][k] += dv[r] * sv;
        }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int t = t0 + ty + 16 * r;
      const float e = t < Q ? expf(sCum[t]) : 0.f;
      float cs = 0.f;                // c_t . (e^{cum_t} S_in^T dy_t)
#pragma unroll
      for (int k = 0; k < NMAX / 16; ++k)
        if (k < nk) {
          acc[r][k] *= e;
          cs += sC[(ty + 16 * r) * ldn + tx + 16 * k] * acc[r][k];
        }
      cs = row_sum(cs);
      if (tx == 0 && t < Q) sRow[t] += cs;
    }
    for (int js = 0; js <= it; ++js) {
      const int s0 = js * TILE, rows_s = min(TILE, Q - s0);
      load_rows(sB, ldn, bg + (size_t)s0 * brow, brow, rows_s, N);
      load_u(sU, ldp, xg + (size_t)s0 * xrow, xrow, sDt + s0, rows_s, PS);
      __syncthreads();
      pair_tiles(t0, s0, true);
      __syncthreads();
      if (tid < TILE) {                // row sums of M, in order of s
        float sum = 0.f;
        for (int s = 0; s < TILE; ++s) sum += sW[tid * LDW + s];
        if (t0 + tid < Q) sRow[t0 + tid] += sum;
      } else if (tid < 2 * TILE) {     // column sums, in order of t
        const int s = tid - TILE;
        float sum = 0.f;
        for (int t = 0; t < TILE; ++t) sum += sW[t * LDW + s];
        if (s0 + s < Q) sCol[s0 + s] -= sum;
      }
      // dc += V B
      for (int s = 0; s < rows_s; ++s) {
        float vv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) vv[r] = sV[(ty + 16 * r) * LDW + s];
#pragma unroll
        for (int k = 0; k < NMAX / 16; ++k)
          if (k < nk) {
            const float bv = sB[s * ldn + tx + 16 * k];
#pragma unroll
            for (int r = 0; r < 4; ++r) acc[r][k] += vv[r] * bv;
          }
      }
      __syncthreads();                 // sB, sU, sW, sV are refilled next
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int t = t0 + ty + 16 * r;
      if (t < Q)
#pragma unroll
        for (int k = 0; k < NMAX / 16; ++k)
          if (k < nk) dc_part[poff + (size_t)t * H * N + tx + 16 * k] = acc[r][k];
    }
  }

  // ---- column pass: du, dx and db per s tile
  float k_sum = 0.f, dyx = 0.f;
  for (int js = 0; js < ntiles; ++js) {
    const int s0 = js * TILE, rows_s = min(TILE, Q - s0);
    load_rows(sB, ldn, bg + (size_t)s0 * brow, brow, rows_s, N);
    load_u(sU, ldp, xg + (size_t)s0 * xrow, xrow, sDt + s0, rows_s, PS);
    __syncthreads();
    // du (s = ty + 16 r, p = tx + 16 cc) = e^{tot - cum_s} Gs b_s and db (n =
    // tx + 16 k) = e^{tot - cum_s} Gs^T u_s to start
    float adu[4][NC], adb[4][NMAX / 16];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
#pragma unroll
      for (int cc = 0; cc < NC; ++cc) adu[r][cc] = 0.f;
#pragma unroll
      for (int k = 0; k < NMAX / 16; ++k) adb[r][k] = 0.f;
    }
    for (int n = 0; n < N; n += 4) {
      float4 bv[4], gv[NC];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        bv[r] = *reinterpret_cast<const float4*>(sB + (ty + 16 * r) * ldn + n);
#pragma unroll
      for (int cc = 0; cc < NC; ++cc)
        gv[cc] = *reinterpret_cast<const float4*>(sG + (tx + 16 * cc) * ldn + n);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int cc = 0; cc < NC; ++cc) adu[r][cc] += dot4(bv[r], gv[cc]);
    }
    for (int p = 0; p < PS; ++p) {
      float uv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) uv[r] = sU[(ty + 16 * r) * ldp + p];
#pragma unroll
      for (int k = 0; k < NMAX / 16; ++k)
        if (k < nk) {
          const float gv = sG[p * ldn + tx + 16 * k];
#pragma unroll
          for (int r = 0; r < 4; ++r) adb[r][k] += uv[r] * gv;
        }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int s = s0 + ty + 16 * r;
      const float w = s < Q ? expf(tot - sCum[s]) : 0.f;
      float ks = 0.f;                  // K_s = u_s . (e^{tot - cum_s} Gs b_s)
#pragma unroll
      for (int cc = 0; cc < NC; ++cc) {
        adu[r][cc] *= w;
        ks += sU[(ty + 16 * r) * ldp + tx + 16 * cc] * adu[r][cc];
      }
#pragma unroll
      for (int k = 0; k < NMAX / 16; ++k) adb[r][k] *= w;
      ks = row_sum(ks);
      if (tx == 0 && s < Q) {
        sCol[s] -= ks;
        k_sum += ks;
      }
    }
    for (int it = js; it < ntiles; ++it) {
      const int t0 = it * TILE, rows_t = min(TILE, Q - t0);
      __syncthreads();                 // sC, sDY, sW, sV are refilled
      load_rows(sC, ldn, cg + (size_t)t0 * brow, brow, rows_t, N);
      load_rows(sDY, ldp, dyg + (size_t)t0 * xrow, xrow, rows_t, PS);
      __syncthreads();
      pair_tiles(t0, s0, false);
      __syncthreads();
      // du += W^T dY, db += V^T C
      for (int t = 0; t < rows_t; ++t) {
        float wv[4], vv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          wv[r] = sW[t * LDW + ty + 16 * r];
          vv[r] = sV[t * LDW + ty + 16 * r];
        }
#pragma unroll
        for (int cc = 0; cc < NC; ++cc) {
          const float dv = sDY[t * ldp + tx + 16 * cc];
#pragma unroll
          for (int r = 0; r < 4; ++r) adu[r][cc] += wv[r] * dv;
        }
#pragma unroll
        for (int k = 0; k < NMAX / 16; ++k)
          if (k < nk) {
            const float cv = sC[t * ldn + tx + 16 * k];
#pragma unroll
            for (int r = 0; r < 4; ++r) adb[r][k] += vv[r] * cv;
          }
      }
    }
    // dx = dt du + D dy; x . du; dy . x; db's partial
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int s = s0 + ty + 16 * r;
      float xd = 0.f;
      if (s < Q) {
#pragma unroll
        for (int cc = 0; cc < NC; ++cc) {
          const size_t o = (size_t)s * xrow + tx + 16 * cc;
          const float xv = to_f(xg[o]), dv = to_f(dyg[o]);
          store(dxg + o, sDt[s] * adu[r][cc] + D * dv);
          xd += xv * adu[r][cc];
          dyx += dv * xv;
        }
#pragma unroll
        for (int k = 0; k < NMAX / 16; ++k)
          if (k < nk) db_part[poff + (size_t)s * H * N + tx + 16 * k] = adb[r][k];
      }
      xd = row_sum(xd);
      if (tx == 0 && s < Q) sXdu[s] = xd;
    }
    __syncthreads();                   // sB, sU are refilled next
  }

  // ---- d tot, the reverse scan of d cum, ddt, and the partials of da, dD
  float gsum = 0.f;                    // <Gs, S_in> over the slice
  for (int e = tid; e < PS * N; e += THREADS) {
    const int p = e / N, n = e - p * N;
    gsum += sG[p * ldn + n] * sS[p * ldn + n];
  }
  const float dtot = block_sum(k_sum + expf(tot) * gsum, warp_tot);
  const int r = Q - 1 - tid;           // thread tid scans step Q - 1 - tid
  float dcum = 0.f;
  if (tid < Q) dcum = sRow[r] + sCol[r] + (tid == 0 ? dtot : 0.f);
  const float dla = block_scan(dcum, warp_tot);   // sum_{t >= r} d cum_t
  float da = 0.f;
  if (tid < Q) {
    ddt_part[((((size_t)sl * B + b) * L + l0 + r) * H + h)] = sXdu[r] + A * dla;
    da = sDt[r] * dla;
  }
  da = block_sum(da, warp_tot);
  dyx = block_sum(dyx, warp_tot);
  if (tid == 0) {
    const size_t o = (((size_t)sl * B + b) * nc + ci) * H + h;
    da_part[o] = A * da;
    dd_part[o] = dyx;
  }
}

// ---- kernel 3: the sums over heads, slices, batch and chunks ---------------

// Output i of db then dc ((b, l, g, n) each, nbc = B L G N apiece): the
// per-head partials (per slice too: nsl of them) summed over the group's
// heads in a fixed order. Both variants' reduce kernels use it.
template <typename T>
__device__ __forceinline__ void sum_group_heads(long long i, long long nbc,
                                                const float* __restrict__ db_part,
                                                const float* __restrict__ dc_part,
                                                T* __restrict__ db, T* __restrict__ dc,
                                                int nsl, int B, int L, int H, int G,
                                                int N) {
  const bool is_c = i >= nbc;
  const long long j = is_c ? i - nbc : i;
  const int n = (int)(j % N), grp = (int)(j / N % G), hg = H / G;
  const long long bl = j / ((long long)N * G);
  const float* part = is_c ? dc_part : db_part;
  float s = 0.f;
  for (int sl = 0; sl < nsl; ++sl)
    for (int hh = grp * hg; hh < (grp + 1) * hg; ++hh)
      s += part[(((size_t)sl * B * L + bl) * H + hh) * N + n];
  store((is_c ? dc : db) + j, s);
}

template <typename T>
__global__ void __launch_bounds__(REDUCE_THREADS)
ssd_bwd_reduce_kernel(const float* __restrict__ ddt_part, const float* __restrict__ db_part,
                      const float* __restrict__ dc_part, const float* __restrict__ da_part,
                      const float* __restrict__ dd_part, float* __restrict__ ddt,
                      T* __restrict__ db, T* __restrict__ dc, float* __restrict__ da,
                      float* __restrict__ dd, int nsl, int B, int L, int H, int G, int N,
                      int nc) {
  const long long nbc = (long long)B * L * G * N, nt = (long long)B * L * H;
  const long long total = 2 * nbc + nt + 2 * H;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x) {
    if (i < 2 * nbc) {               // db, then dc: (b, l, g, n)
      sum_group_heads(i, nbc, db_part, dc_part, db, dc, nsl, B, L, H, G, N);
    } else if (i < 2 * nbc + nt) {   // ddt: (b, l, h)
      const long long j = i - 2 * nbc;
      float s = 0.f;
      for (int sl = 0; sl < nsl; ++sl) s += ddt_part[(size_t)sl * nt + j];
      ddt[j] = s;
    } else {                         // da_log, then dd_skip: (h,)
      const int j = (int)(i - 2 * nbc - nt);
      const bool is_d = j >= H;
      const int hh = is_d ? j - H : j;
      const float* part = is_d ? dd_part : da_part;
      float s = 0.f;
      for (long long k = 0; k < (long long)nsl * B * nc; ++k) s += part[k * H + hh];
      (is_d ? dd : da)[hh] = s;
    }
  }
}

template <typename T, int PS>
int launch(const void* x, const void* dt, const void* a_log, const void* b, const void* c,
           const void* d_skip, const void* dy, const void* dstate, void* dx, void* ddt,
           void* da, void* db, void* dc, void* dd, void* s_in, void* gs, void* ddt_part,
           void* db_part, void* dc_part, void* da_part, void* dd_part, int B, int L,
           int H, int P, int G, int N, int Q, cudaStream_t stream) {
  const int nsl = P / PS, nc = L / Q;
  const int states_bytes = states_floats(N, PS) * 4;
  const int chunks_bytes = chunks_floats(N, PS) * 4;
  cudaError_t err = cudaFuncSetAttribute(ssd_bwd_states_kernel<T, PS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         states_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(ssd_bwd_chunks_kernel<T, PS>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, chunks_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const T* xt = static_cast<const T*>(x);
  const T* bt = static_cast<const T*>(b);
  const T* ct = static_cast<const T*>(c);
  const T* dyt = static_cast<const T*>(dy);
  const float* dtf = static_cast<const float*>(dt);
  const float* af = static_cast<const float*>(a_log);
  float* sf = static_cast<float*>(s_in);
  float* gf = static_cast<float*>(gs);
  ssd_bwd_states_kernel<T, PS><<<dim3(nsl, H, B), THREADS, states_bytes, stream>>>(
      xt, dtf, af, bt, ct, dyt, static_cast<const float*>(dstate), sf, gf, L, H, P, G,
      N, Q);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  float* ddt_pf = static_cast<float*>(ddt_part);
  float* db_pf = static_cast<float*>(db_part);
  float* dc_pf = static_cast<float*>(dc_part);
  float* da_pf = static_cast<float*>(da_part);
  float* dd_pf = static_cast<float*>(dd_part);
  ssd_bwd_chunks_kernel<T, PS><<<dim3(nsl * nc, H, B), THREADS, chunks_bytes, stream>>>(
      xt, dtf, af, bt, ct, static_cast<const float*>(d_skip), dyt, sf, gf,
      static_cast<T*>(dx), ddt_pf, db_pf, dc_pf, da_pf, dd_pf, B, L, H, P, G, N, Q);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long total = 2LL * B * L * G * N + (long long)B * L * H + 2 * H;
  const long long want = (total + REDUCE_THREADS - 1) / REDUCE_THREADS;
  const int blocks = (int)(want < 132 * 16 ? want : 132 * 16);
  ssd_bwd_reduce_kernel<T><<<blocks, REDUCE_THREADS, 0, stream>>>(
      ddt_pf, db_pf, dc_pf, da_pf, dd_pf, static_cast<float*>(ddt), static_cast<T*>(db),
      static_cast<T*>(dc), static_cast<float*>(da), static_cast<float*>(dd), nsl, B, L,
      H, G, N, nc);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_slices(const void* x, const void* dt, const void* a_log, const void* b,
                  const void* c, const void* d_skip, const void* dy, const void* dstate,
                  void* dx, void* ddt, void* da, void* db, void* dc, void* dd, void* s_in,
                  void* gs, void* ddt_part, void* db_part, void* dc_part, void* da_part,
                  void* dd_part, int B, int L, int H, int P, int G, int N, int Q,
                  cudaStream_t s) {
  if (P % 64 == 0)
    return launch<T, 64>(x, dt, a_log, b, c, d_skip, dy, dstate, dx, ddt, da, db, dc, dd,
                         s_in, gs, ddt_part, db_part, dc_part, da_part, dd_part, B, L, H,
                         P, G, N, Q, s);
  if (P % 32 == 0)
    return launch<T, 32>(x, dt, a_log, b, c, d_skip, dy, dstate, dx, ddt, da, db, dc, dd,
                         s_in, gs, ddt_part, db_part, dc_part, da_part, dd_part, B, L, H,
                         P, G, N, Q, s);
  return launch<T, 16>(x, dt, a_log, b, c, d_skip, dy, dstate, dx, ddt, da, db, dc, dd,
                       s_in, gs, ddt_part, db_part, dc_part, da_part, dd_part, B, L, H, P,
                       G, N, Q, s);
}

// ---- variant "wgmma": chunk_state, state_pass, rows, cols, reduce ---------

namespace wg {

using ssd::align1024;
using ssd::box_at;
using ssd::BOXB;
using ssd::chunk_cum;
using ssd::chunk_state_kernel;
using ssd::consumer_sync;
using ssd::CONSUMERS;
using ssd::fast_exp2;
using ssd::LOG2E;
using ssd::P;
using ssd::PASS_ENTRIES;
using ssd::PASS_THREADS;
using ssd::ROWS;
using ssd::split_fragments;
using ssd::STAGES;
using ssd::StateLayout;
using ssd::THREADS;

// Shared memory of rows: the t tile's C (N/64 boxes) and dY (one box), the
// entering state's hi and lo (N/64 boxes each), the ring of (x box, N/64 b
// boxes) stages; barriers for the t tile, the state, and full and empty a
// stage.
template <int N>
struct RowsLayout {
  static constexpr int NB = N / 64;
  static constexpr int OPER = NB * BOXB;
  static constexpr int DY_OFFSET = OPER;
  static constexpr int HI_OFFSET = OPER + BOXB;
  static constexpr int LO_OFFSET = 2 * OPER + BOXB;
  static constexpr int RING_OFFSET = 3 * OPER + BOXB;
  static constexpr int STAGE = BOXB + OPER;
  static constexpr int BARRIER_OFFSET = RING_OFFSET + STAGES * STAGE;
  static constexpr int BYTES = BARRIER_OFFSET + (2 + 2 * STAGES) * 8 + 1024;
};

// Shared memory of cols: the s tile's B (N/64 boxes), x and dy (one box
// each), the leaving state's gradient hi and lo (N/64 boxes each), the ring
// of (dy box, N/64 c boxes) stages; barriers as rows.
template <int N>
struct ColsLayout {
  static constexpr int NB = N / 64;
  static constexpr int OPER = NB * BOXB;
  static constexpr int X_OFFSET = OPER;
  static constexpr int DY_OFFSET = OPER + BOXB;
  static constexpr int HI_OFFSET = OPER + 2 * BOXB;
  static constexpr int LO_OFFSET = 2 * OPER + 2 * BOXB;
  static constexpr int RING_OFFSET = 3 * OPER + 2 * BOXB;
  static constexpr int STAGE = BOXB + OPER;
  static constexpr int BARRIER_OFFSET = RING_OFFSET + STAGES * STAGE;
  static constexpr int BYTES = BARRIER_OFFSET + (2 + 2 * STAGES) * 8 + 1024;
};

// Sum of v over the 4 threads of a quad (the threads of one accumulator row).
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Sum over the consumer warpgroup in a fixed order; every consumer thread
// gets the total.
__device__ __forceinline__ float consumer_sum(float v, float* warp_tot) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  consumer_sync();                            // warp_tot is free
  if ((threadIdx.x & 31) == 0) warp_tot[threadIdx.x >> 5] = v;
  consumer_sync();
  return (warp_tot[0] + warp_tot[1]) + (warp_tot[2] + warp_tot[3]);
}

// Block (1024 state entries, head h, batch b): S <- e^{tot_c} S + s_loc_c
// over the chunks, the state entering each chunk written as hi + lo bf16
// (zero for chunk 0); then G <- e^{tot_c} G + ds_loc_c back over them from
// G = dstate (zero if null), the gradient of the state leaving each chunk
// written as hi + lo, and this block's share of e^{tot_c} <G_c, S_in_c>
// (S_in as hi + lo) to sg_part[b, c, h, block].
__global__ void __launch_bounds__(PASS_THREADS)
state_pass_kernel(const float* __restrict__ s_loc, const float* __restrict__ ds_loc,
                  const float* __restrict__ tot, const float* __restrict__ dstate,
                  bf16* __restrict__ s_hi, bf16* __restrict__ s_lo,
                  bf16* __restrict__ g_hi, bf16* __restrict__ g_lo,
                  float* __restrict__ sg_part, int nc, int H, int PN) {
  __shared__ float warp_tot[PASS_THREADS / 32];
  const int h = blockIdx.y, b = blockIdx.z, blk = blockIdx.x, nblk = gridDim.x;
  const int e = blk * PASS_ENTRIES + threadIdx.x * 4;
  auto put = [](bf16* hi, bf16* lo, const float (&v)[4]) {
    uint32_t h2[2], l2[2];
    ssd::split_bf16(v[0], v[1], h2[0], l2[0]);
    ssd::split_bf16(v[2], v[3], h2[1], l2[1]);
    *reinterpret_cast<uint2*>(hi) = make_uint2(h2[0], h2[1]);
    *reinterpret_cast<uint2*>(lo) = make_uint2(l2[0], l2[1]);
  };
  float v[4] = {0.f, 0.f, 0.f, 0.f};
  for (int c = 0; c < nc; ++c) {
    const size_t bch = ((size_t)b * nc + c) * H + h;
    const size_t o = bch * PN + e;
    put(s_hi + o, s_lo + o, v);
    const float4 sl = *reinterpret_cast<const float4*>(s_loc + o);
    const float et = expf(tot[bch]);
    // S e^{tot} + s_loc, rounded twice as the forward's state_pass
    v[0] = __fadd_rn(__fmul_rn(v[0], et), sl.x);
    v[1] = __fadd_rn(__fmul_rn(v[1], et), sl.y);
    v[2] = __fadd_rn(__fmul_rn(v[2], et), sl.z);
    v[3] = __fadd_rn(__fmul_rn(v[3], et), sl.w);
  }
  float gv[4] = {0.f, 0.f, 0.f, 0.f};
  if (dstate) {
    const float4 d = *reinterpret_cast<const float4*>(dstate + ((size_t)b * H + h) * PN + e);
    gv[0] = d.x, gv[1] = d.y, gv[2] = d.z, gv[3] = d.w;
  }
  for (int c = nc - 1; c >= 0; --c) {
    const size_t bch = ((size_t)b * nc + c) * H + h;
    const size_t o = bch * PN + e;
    put(g_hi + o, g_lo + o, gv);
    // <G, S_in> with S_in as this thread wrote it: hi + lo
    float dot = 0.f;
#pragma unroll
    for (int k = 0; k < 4; ++k)
      dot += gv[k] * (__bfloat162float(s_hi[o + k]) + __bfloat162float(s_lo[o + k]));
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, off);
    if ((threadIdx.x & 31) == 0) warp_tot[threadIdx.x >> 5] = dot;
    __syncthreads();
    const float et = expf(tot[bch]);
    if (threadIdx.x == 0) {
      float sum = 0.f;
      for (int w = 0; w < PASS_THREADS / 32; ++w) sum += warp_tot[w];
      sg_part[bch * nblk + blk] = et * sum;
    }
    __syncthreads();                            // warp_tot is free again
    const float4 dl = *reinterpret_cast<const float4*>(ds_loc + o);
    gv[0] = __fadd_rn(__fmul_rn(gv[0], et), dl.x);
    gv[1] = __fadd_rn(__fmul_rn(gv[1], et), dl.y);
    gv[2] = __fadd_rn(__fmul_rn(gv[2], et), dl.z);
    gv[3] = __fadd_rn(__fmul_rn(gv[3], et), dl.w);
  }
}

// Block (t tile, head h, chunk c and batch b as b nc + c): for the 64 rows
// t0 .. t0 + 63 of chunk c, dc per head (e^{cum_t} dY S_in + V B over the s
// tiles up to the diagonal) and d cum's row part (sum_s M_ts + c_t .
// e^{cum_t} S_in^T dy_t). Shaped like flash's forward: C B^T and dY X^T
// (S and its partner) per s tile on wgmma from shared memory; V = (dY X^T)
// dt_s e^{cum_t - cum_s} masked to s <= t, and M = (C B^T) o V, in
// registers; dc += V B with V from registers as hi + lo.
template <int N>
__global__ void __launch_bounds__(THREADS)
rows_kernel(__grid_constant__ const CUtensorMap xmap,
            __grid_constant__ const CUtensorMap bmap,
            __grid_constant__ const CUtensorMap cmap,
            __grid_constant__ const CUtensorMap dymap,
            __grid_constant__ const CUtensorMap himap,
            __grid_constant__ const CUtensorMap lomap,
            const float* __restrict__ dt, const float* __restrict__ a_log,
            float* __restrict__ dc_part, float* __restrict__ dcum_row,
            int L, int H, int G, int Q, int nc) {
  using Lay = RowsLayout<N>;
  constexpr int NB = Lay::NB;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  __shared__ float sDt[QMAX], sCum[QMAX], warp_tot[CONSUMERS / 32];
  unsigned char* base = align1024(smem_raw);
  unsigned char* sC = base;
  unsigned char* sDY = base + Lay::DY_OFFSET;
  unsigned char* sHi = base + Lay::HI_OFFSET;
  unsigned char* sLo = base + Lay::LO_OFFSET;
  unsigned char* ring = base + Lay::RING_OFFSET;
  uint64_t* t_full = reinterpret_cast<uint64_t*>(base + Lay::BARRIER_OFFSET);
  uint64_t* s_full = t_full + 1;
  uint64_t* full = s_full + 1;
  uint64_t* empty = full + STAGES;

  const int h = blockIdx.y, bc = blockIdx.z, b = bc / nc, c = bc % nc;
  const int it = gridDim.x - 1 - blockIdx.x;          // longest t tile first
  const int g = h / (H / G);
  const int l0 = c * Q, t0 = it * ROWS;

  if (threadIdx.x == 0) {
    hopper::mbar_init(t_full, 1);
    hopper::mbar_init(s_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], CONSUMERS / 32);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (hopper::warpgroup_index() == 1) {               // producer warp
    if (threadIdx.x == CONSUMERS) {
      hopper::tma_prefetch_map(&xmap);
      hopper::tma_prefetch_map(&bmap);
      hopper::mbar_expect_tx(t_full, Lay::OPER + BOXB);
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
        hopper::tma_load_4d(sC + nb * BOXB, &cmap, t_full, nb * hopper::BOX, g,
                            l0 + t0, b);
      hopper::tma_load_4d(sDY, &dymap, t_full, 0, h, l0 + t0, b);
      hopper::mbar_expect_tx(s_full, 2 * Lay::OPER);
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        hopper::tma_load_3d(sHi + nb * BOXB, &himap, s_full, nb * hopper::BOX, 0, bc * H + h);
        hopper::tma_load_3d(sLo + nb * BOXB, &lomap, s_full, nb * hopper::BOX, 0, bc * H + h);
      }
      for (int js = 0; js <= it; ++js) {
        const int s = js % STAGES;
        unsigned char* st = ring + s * Lay::STAGE;
        hopper::mbar_wait(&empty[s], ((js / STAGES) & 1) ^ 1);
        hopper::mbar_expect_tx(&full[s], Lay::STAGE);
        hopper::tma_load_4d(st, &xmap, &full[s], 0, h, l0 + js * ROWS, b);
#pragma unroll
        for (int nb = 0; nb < NB; ++nb)
          hopper::tma_load_4d(st + (1 + nb) * BOXB, &bmap, &full[s], nb * hopper::BOX,
                              g, l0 + js * ROWS, b);
      }
    }
    return;
  }

  // consumer warpgroup: rows r0 = 16 warp + lane / 4 and r1 = r0 + 8 of the
  // t tile; accumulator columns 8 j + 2 t4 and the next one
  const float A = -expf(a_log[h]);
  chunk_cum(dt + ((size_t)b * L + l0) * H + h, H, A, Q, sDt, sCum, warp_tot);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = warp * 16 + lane / 4, r1 = r0 + 8, t4 = lane % 4;
  const float cum0 = sCum[t0 + r0], cum1 = sCum[t0 + r1];

  // dc = e^{cum_t} dY S_in (S_in = hi + lo, MN-major: K = P rows of n)
  float dc[NB][32];
  hopper::mbar_wait(t_full, 0);
  hopper::mbar_wait(s_full, 0);
#pragma unroll
  for (int nb = 0; nb < NB; ++nb) hopper::fence_regs(dc[nb]);
  hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t ad = hopper::desc_kmajor(sDY + 32 * kk);
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      hopper::wgmma_ss<0, 1>(dc[nb], ad,
                             hopper::desc_mnmajor(sHi + nb * BOXB + 2048 * kk, BOXB), kk > 0);
      hopper::wgmma_ss<0, 1>(dc[nb], ad,
                             hopper::desc_mnmajor(sLo + nb * BOXB + 2048 * kk, BOXB), 1);
    }
  }
  hopper::wgmma_commit();
  hopper::wgmma_wait<0>();
#pragma unroll
  for (int nb = 0; nb < NB; ++nb) hopper::fence_regs(dc[nb]);
  const float e0 = expf(cum0), e1 = expf(cum1);
  float rs0 = 0.f, rs1 = 0.f;                         // d cum's row part
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = 8 * j + 2 * t4;
      const unsigned char* cb = sC + nb * BOXB;
      dc[nb][4 * j] *= e0;
      dc[nb][4 * j + 1] *= e0;
      dc[nb][4 * j + 2] *= e1;
      dc[nb][4 * j + 3] *= e1;
      rs0 += box_at(cb, r0, n) * dc[nb][4 * j] + box_at(cb, r0, n + 1) * dc[nb][4 * j + 1];
      rs1 += box_at(cb, r1, n) * dc[nb][4 * j + 2] + box_at(cb, r1, n + 1) * dc[nb][4 * j + 3];
    }

  // the s tiles up to the diagonal, one batch of products each: C B^T and
  // dY X^T; then V B
  for (int js = 0; js <= it; ++js) {
    const unsigned char* st = ring + (js % STAGES) * Lay::STAGE;
    hopper::mbar_wait(&full[js % STAGES], (js / STAGES) & 1);
    float sc[32], v[32];
    hopper::fence_regs(sc);
    hopper::fence_regs(v);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk) {
      const int off = (kk / 4) * BOXB + (kk % 4) * 32;
      hopper::wgmma_ss<0, 0>(sc, hopper::desc_kmajor(sC + off),
                             hopper::desc_kmajor(st + BOXB + off), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      hopper::wgmma_ss<0, 0>(v, hopper::desc_kmajor(sDY + 32 * kk),
                             hopper::desc_kmajor(st + 32 * kk), kk > 0);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(sc);
    hopper::fence_regs(v);
    // V = (dY X^T) dt_s e^{cum_t - cum_s}, s <= t (masked before the exp);
    // M = (C B^T) o V summed over s
    const bool diag = js == it;
    const float* cs = sCum + js * ROWS;
    const float* ds = sDt + js * ROWS;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int sl = 8 * j + 2 * t4 + (e & 1), row = e < 2 ? r0 : r1;
        const float ct = e < 2 ? cum0 : cum1;
        const float vv = diag && sl > row
            ? 0.f : v[4 * j + e] * ds[sl] * fast_exp2((ct - cs[sl]) * LOG2E);
        v[4 * j + e] = vv;
        if (e < 2) rs0 += sc[4 * j + e] * vv;
        else rs1 += sc[4 * j + e] * vv;
      }
    uint32_t vhi[4][4], vlo[4][4];
    split_fragments(v, vhi, vlo);
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) hopper::fence_regs(dc[nb]);
    hopper::fence_regs(vhi);
    hopper::fence_regs(vlo);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        const uint64_t bd = hopper::desc_mnmajor(st + (1 + nb) * BOXB + 2048 * kk, BOXB);
        hopper::wgmma_rs<1>(dc[nb], vhi[kk], bd, 1);
        hopper::wgmma_rs<1>(dc[nb], vlo[kk], bd, 1);
      }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) hopper::fence_regs(dc[nb]);
    hopper::fence_regs(vhi);
    hopper::fence_regs(vlo);
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&empty[js % STAGES]);
  }

  rs0 = quad_sum(rs0);
  rs1 = quad_sum(rs1);
  const size_t row0 = ((size_t)b * L + l0 + t0 + r0) * H + h;
  const size_t row1 = ((size_t)b * L + l0 + t0 + r1) * H + h;
  if (t4 == 0) {
    dcum_row[row0] = rs0;
    dcum_row[row1] = rs1;
  }
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = nb * 64 + 8 * j + 2 * t4;
      *reinterpret_cast<float2*>(dc_part + row0 * N + n) =
          make_float2(dc[nb][4 * j], dc[nb][4 * j + 1]);
      *reinterpret_cast<float2*>(dc_part + row1 * N + n) =
          make_float2(dc[nb][4 * j + 2], dc[nb][4 * j + 3]);
    }
}

// Block (s tile, head h, chunk c and batch b as b nc + c): for the 64 rows
// s0 .. s0 + 63 of chunk c, du (e^{tot - cum_s} B Gs^T + W^T dY over the t
// tiles from the diagonal on), dx = dt du + D dy, db per head (e^{tot -
// cum_s} dt_s X Gs + V^T C), x . du, d cum's column part (-sum_t M_ts -
// K_s), and the tile's sums of K_s and of dy . x. Shaped like flash's
// dK/dV: B C^T and X dY^T per t tile on wgmma give W^T and V^T with s rows,
// so the column sums of M are row sums of M^T in registers.
template <int N>
__global__ void __launch_bounds__(THREADS)
cols_kernel(__grid_constant__ const CUtensorMap xmap,
            __grid_constant__ const CUtensorMap bmap,
            __grid_constant__ const CUtensorMap cmap,
            __grid_constant__ const CUtensorMap dymap,
            __grid_constant__ const CUtensorMap himap,
            __grid_constant__ const CUtensorMap lomap,
            const float* __restrict__ dt, const float* __restrict__ a_log,
            const float* __restrict__ d_skip, bf16* __restrict__ dx,
            float* __restrict__ db_part, float* __restrict__ dcum_col,
            float* __restrict__ xdu, float* __restrict__ k_part,
            float* __restrict__ dd_part, int L, int H, int G, int Q, int nc) {
  using Lay = ColsLayout<N>;
  constexpr int NB = Lay::NB;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  __shared__ float sDt[QMAX], sCum[QMAX], warp_tot[CONSUMERS / 32];
  unsigned char* base = align1024(smem_raw);
  unsigned char* sB = base;
  unsigned char* sX = base + Lay::X_OFFSET;
  unsigned char* sDY = base + Lay::DY_OFFSET;
  unsigned char* sHi = base + Lay::HI_OFFSET;
  unsigned char* sLo = base + Lay::LO_OFFSET;
  unsigned char* ring = base + Lay::RING_OFFSET;
  uint64_t* s_full = reinterpret_cast<uint64_t*>(base + Lay::BARRIER_OFFSET);
  uint64_t* g_full = s_full + 1;
  uint64_t* full = g_full + 1;
  uint64_t* empty = full + STAGES;

  const int h = blockIdx.y, bc = blockIdx.z, b = bc / nc, c = bc % nc;
  const int js = blockIdx.x, ntiles = gridDim.x;      // longest s tile first
  const int g = h / (H / G);
  const int l0 = c * Q, s0 = js * ROWS;

  if (threadIdx.x == 0) {
    hopper::mbar_init(s_full, 1);
    hopper::mbar_init(g_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], CONSUMERS / 32);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (hopper::warpgroup_index() == 1) {               // producer warp
    if (threadIdx.x == CONSUMERS) {
      hopper::tma_prefetch_map(&cmap);
      hopper::tma_prefetch_map(&dymap);
      hopper::mbar_expect_tx(s_full, Lay::OPER + 2 * BOXB);
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
        hopper::tma_load_4d(sB + nb * BOXB, &bmap, s_full, nb * hopper::BOX, g,
                            l0 + s0, b);
      hopper::tma_load_4d(sX, &xmap, s_full, 0, h, l0 + s0, b);
      hopper::tma_load_4d(sDY, &dymap, s_full, 0, h, l0 + s0, b);
      hopper::mbar_expect_tx(g_full, 2 * Lay::OPER);
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        hopper::tma_load_3d(sHi + nb * BOXB, &himap, g_full, nb * hopper::BOX, 0, bc * H + h);
        hopper::tma_load_3d(sLo + nb * BOXB, &lomap, g_full, nb * hopper::BOX, 0, bc * H + h);
      }
      for (int i = 0; i < ntiles - js; ++i) {
        const int s = i % STAGES, t0 = (js + i) * ROWS;
        unsigned char* st = ring + s * Lay::STAGE;
        hopper::mbar_wait(&empty[s], ((i / STAGES) & 1) ^ 1);
        hopper::mbar_expect_tx(&full[s], Lay::STAGE);
        hopper::tma_load_4d(st, &dymap, &full[s], 0, h, l0 + t0, b);
#pragma unroll
        for (int nb = 0; nb < NB; ++nb)
          hopper::tma_load_4d(st + (1 + nb) * BOXB, &cmap, &full[s], nb * hopper::BOX,
                              g, l0 + t0, b);
      }
    }
    return;
  }

  // consumer warpgroup: rows r0 = 16 warp + lane / 4 and r1 = r0 + 8 of the
  // s tile; accumulator columns 8 j + 2 t4 and the next one
  const float A = -expf(a_log[h]), D = d_skip[h];
  chunk_cum(dt + ((size_t)b * L + l0) * H + h, H, A, Q, sDt, sCum, warp_tot);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = warp * 16 + lane / 4, r1 = r0 + 8, t4 = lane % 4;
  const float tot = sCum[Q - 1];
  const float cs0 = sCum[s0 + r0], cs1 = sCum[s0 + r1];
  const float dt0 = sDt[s0 + r0], dt1 = sDt[s0 + r1];

  // du = B Gs^T (Gs K-major: rows p of n) and db = X Gs (Gs MN-major: K = P
  // rows of n), each over Gs = hi + lo
  float du[32], db[NB][32];
  hopper::mbar_wait(s_full, 0);
  hopper::mbar_wait(g_full, 0);
  hopper::fence_regs(du);
#pragma unroll
  for (int nb = 0; nb < NB; ++nb) hopper::fence_regs(db[nb]);
  hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    const int off = (kk / 4) * BOXB + (kk % 4) * 32;
    const uint64_t ad = hopper::desc_kmajor(sB + off);
    hopper::wgmma_ss<0, 0>(du, ad, hopper::desc_kmajor(sHi + off), kk > 0);
    hopper::wgmma_ss<0, 0>(du, ad, hopper::desc_kmajor(sLo + off), 1);
  }
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t ad = hopper::desc_kmajor(sX + 32 * kk);
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      hopper::wgmma_ss<0, 1>(db[nb], ad,
                             hopper::desc_mnmajor(sHi + nb * BOXB + 2048 * kk, BOXB), kk > 0);
      hopper::wgmma_ss<0, 1>(db[nb], ad,
                             hopper::desc_mnmajor(sLo + nb * BOXB + 2048 * kk, BOXB), 1);
    }
  }
  hopper::wgmma_commit();
  hopper::wgmma_wait<0>();
  hopper::fence_regs(du);
#pragma unroll
  for (int nb = 0; nb < NB; ++nb) hopper::fence_regs(db[nb]);
  // scaled by e^{tot - cum_s} (db also by dt_s); K_s = dt_s x_s . du_s
  const float w0 = expf(tot - cs0), w1 = expf(tot - cs1);
  float k0 = 0.f, k1 = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int p = 8 * j + 2 * t4;
    du[4 * j] *= w0;
    du[4 * j + 1] *= w0;
    du[4 * j + 2] *= w1;
    du[4 * j + 3] *= w1;
    k0 += box_at(sX, r0, p) * du[4 * j] + box_at(sX, r0, p + 1) * du[4 * j + 1];
    k1 += box_at(sX, r1, p) * du[4 * j + 2] + box_at(sX, r1, p + 1) * du[4 * j + 3];
  }
  const float u0 = dt0 * w0, u1 = dt1 * w1;
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      db[nb][4 * j] *= u0;
      db[nb][4 * j + 1] *= u0;
      db[nb][4 * j + 2] *= u1;
      db[nb][4 * j + 3] *= u1;
    }

  // the t tiles from the diagonal on, one batch of products each: B C^T
  // and X dY^T; then W^T dY and V^T C
  float mc0 = 0.f, mc1 = 0.f;                         // sum_t M_ts
  for (int i = 0; i < ntiles - js; ++i) {
    const unsigned char* st = ring + (i % STAGES) * Lay::STAGE;
    hopper::mbar_wait(&full[i % STAGES], (i / STAGES) & 1);
    float w[32], v[32];
    hopper::fence_regs(w);
    hopper::fence_regs(v);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk) {
      const int off = (kk / 4) * BOXB + (kk % 4) * 32;
      hopper::wgmma_ss<0, 0>(w, hopper::desc_kmajor(sB + off),
                             hopper::desc_kmajor(st + BOXB + off), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      hopper::wgmma_ss<0, 0>(v, hopper::desc_kmajor(sX + 32 * kk),
                             hopper::desc_kmajor(st + 32 * kk), kk > 0);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(w);
    hopper::fence_regs(v);
    // W^T = (B C^T) e^{cum_t - cum_s} and V^T = (X dY^T) dt_s e^{cum_t -
    // cum_s}, t >= s (masked before the exp); M^T = (B C^T) o V^T summed
    // over t
    const bool diag = i == 0;
    const float* ct = sCum + (js + i) * ROWS;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int tl = 8 * j + 2 * t4 + (e & 1), row = e < 2 ? r0 : r1;
        const float cs = e < 2 ? cs0 : cs1, ds = e < 2 ? dt0 : dt1;
        const float dec = diag && tl < row ? 0.f : fast_exp2((ct[tl] - cs) * LOG2E);
        const float vv = v[4 * j + e] * ds * dec;
        if (e < 2) mc0 += w[4 * j + e] * vv;
        else mc1 += w[4 * j + e] * vv;
        w[4 * j + e] *= dec;
        v[4 * j + e] = vv;
      }
    uint32_t whi[4][4], wlo[4][4], vhi[4][4], vlo[4][4];
    split_fragments(w, whi, wlo);
    split_fragments(v, vhi, vlo);
    hopper::fence_regs(du);
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) hopper::fence_regs(db[nb]);
    hopper::fence_regs(whi);
    hopper::fence_regs(wlo);
    hopper::fence_regs(vhi);
    hopper::fence_regs(vlo);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t yd = hopper::desc_mnmajor(st + 2048 * kk, BOXB);
      hopper::wgmma_rs<1>(du, whi[kk], yd, 1);
      hopper::wgmma_rs<1>(du, wlo[kk], yd, 1);
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        const uint64_t cd = hopper::desc_mnmajor(st + (1 + nb) * BOXB + 2048 * kk, BOXB);
        hopper::wgmma_rs<1>(db[nb], vhi[kk], cd, 1);
        hopper::wgmma_rs<1>(db[nb], vlo[kk], cd, 1);
      }
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(du);
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) hopper::fence_regs(db[nb]);
    hopper::fence_regs(whi);
    hopper::fence_regs(wlo);
    hopper::fence_regs(vhi);
    hopper::fence_regs(vlo);
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&empty[i % STAGES]);
  }

  // dx = dt du + D dy, rounded once; x . du and dy . x
  const size_t row0 = ((size_t)b * L + l0 + s0 + r0) * H + h;
  const size_t row1 = ((size_t)b * L + l0 + s0 + r1) * H + h;
  float xd0 = 0.f, xd1 = 0.f, dyx = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int p = 8 * j + 2 * t4;
    const float x00 = box_at(sX, r0, p), x01 = box_at(sX, r0, p + 1);
    const float x10 = box_at(sX, r1, p), x11 = box_at(sX, r1, p + 1);
    const float y00 = box_at(sDY, r0, p), y01 = box_at(sDY, r0, p + 1);
    const float y10 = box_at(sDY, r1, p), y11 = box_at(sDY, r1, p + 1);
    *reinterpret_cast<__nv_bfloat162*>(dx + row0 * P + p) = __floats2bfloat162_rn(
        dt0 * du[4 * j] + D * y00, dt0 * du[4 * j + 1] + D * y01);
    *reinterpret_cast<__nv_bfloat162*>(dx + row1 * P + p) = __floats2bfloat162_rn(
        dt1 * du[4 * j + 2] + D * y10, dt1 * du[4 * j + 3] + D * y11);
    xd0 += x00 * du[4 * j] + x01 * du[4 * j + 1];
    xd1 += x10 * du[4 * j + 2] + x11 * du[4 * j + 3];
    dyx += (y00 * x00 + y01 * x01) + (y10 * x10 + y11 * x11);
  }
  xd0 = quad_sum(xd0);
  xd1 = quad_sum(xd1);
  k0 = dt0 * quad_sum(k0);
  k1 = dt1 * quad_sum(k1);
  mc0 = quad_sum(mc0);
  mc1 = quad_sum(mc1);
  if (t4 == 0) {
    xdu[row0] = xd0;
    xdu[row1] = xd1;
    dcum_col[row0] = -mc0 - k0;
    dcum_col[row1] = -mc1 - k1;
  }
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = nb * 64 + 8 * j + 2 * t4;
      *reinterpret_cast<float2*>(db_part + row0 * N + n) =
          make_float2(db[nb][4 * j], db[nb][4 * j + 1]);
      *reinterpret_cast<float2*>(db_part + row1 * N + n) =
          make_float2(db[nb][4 * j + 2], db[nb][4 * j + 3]);
    }
  // the tile's sums: K over its rows (a quad's lanes hold the same row sums,
  // so lane t4 == 0 adds them), dy . x over its entries
  const float ksum = consumer_sum(t4 == 0 ? k0 + k1 : 0.f, warp_tot);
  const float dsum = consumer_sum(dyx, warp_tot);
  if (threadIdx.x == 0) {
    const size_t o = (((size_t)b * nc + c) * ntiles + js) * H + h;
    k_part[o] = ksum;
    dd_part[o] = dsum;
  }
}

// Blocks 0 .. H-1, one a head h: over (batch, chunk) in order, d cum = the
// row and column parts, the chunk's last step also d tot = the chunk's K
// sums and its state pass partials; d la = the reverse cumulative sum of d
// cum within the chunk; ddt = x . du + A d la; da_log = A sum dt d la and
// dd_skip = the sum of the dy . x partials. Blocks from H on: db and dc, the
// per-head partials summed over each group's heads. No atomics: every sum
// runs in a fixed order.
__global__ void __launch_bounds__(REDUCE_THREADS)
reduce_kernel(const float* __restrict__ dcum_row, const float* __restrict__ dcum_col,
              const float* __restrict__ xdu, const float* __restrict__ k_part,
              const float* __restrict__ sg_part, const float* __restrict__ dd_part,
              const float* __restrict__ dt, const float* __restrict__ a_log,
              const float* __restrict__ db_part, const float* __restrict__ dc_part,
              float* __restrict__ ddt, bf16* __restrict__ db, bf16* __restrict__ dc,
              float* __restrict__ da, float* __restrict__ dd, int B, int L, int H, int G,
              int N, int Q, int nblk) {
  __shared__ float warp_tot[REDUCE_THREADS / 32];
  if (blockIdx.x >= H) {                   // db, then dc: (b, l, g, n)
    const long long nbc = (long long)B * L * G * N;
    for (long long i = (blockIdx.x - H) * (long long)blockDim.x + threadIdx.x; i < 2 * nbc;
         i += (long long)(gridDim.x - H) * blockDim.x)
      sum_group_heads(i, nbc, db_part, dc_part, db, dc, 1, B, L, H, G, N);
    return;
  }
  const int h = blockIdx.x, tid = threadIdx.x, nc = L / Q, ntiles = Q / ROWS;
  const float A = -expf(a_log[h]);
  const int r = Q - 1 - tid;               // thread tid scans step Q - 1 - tid
  float da_sum = 0.f, dd_sum = 0.f;
  for (int b = 0; b < B; ++b)
    for (int c = 0; c < nc; ++c) {
      const size_t bch = ((size_t)b * nc + c) * H + h;
      float dcum = 0.f;
      if (tid < Q) {
        const size_t o = ((size_t)b * L + c * Q + r) * H + h;
        dcum = dcum_row[o] + dcum_col[o];
      }
      if (tid == 0) {                      // d tot, at the chunk's last step
        float dtot = 0.f;
        for (int k = 0; k < ntiles; ++k) {
          const size_t o = (((size_t)b * nc + c) * ntiles + k) * H + h;
          dtot += k_part[o];
          dd_sum += dd_part[o];
        }
        for (int k = 0; k < nblk; ++k) dtot += sg_part[bch * nblk + k];
        dcum += dtot;
      }
      const float dla = block_scan(dcum, warp_tot);   // sum_{t >= r} d cum_t
      float part = 0.f;
      if (tid < Q) {
        const size_t o = ((size_t)b * L + c * Q + r) * H + h;
        ddt[o] = xdu[o] + A * dla;
        part = dt[o] * dla;
      }
      da_sum += block_sum(part, warp_tot);
    }
  if (tid == 0) {
    da[h] = A * da_sum;
    dd[h] = dd_sum;
  }
}

template <int N>
int launch(const void* x, const void* dt, const void* a_log, const void* b, const void* c,
           const void* d_skip, const void* dy, const void* dstate, void* dx, void* ddt,
           void* da, void* db, void* dc, void* dd, void* s_loc, void* ds_loc, void* tot,
           void* s_hi, void* s_lo, void* g_hi, void* g_lo, void* sg_part, void* db_part,
           void* dc_part, void* dcum_row, void* dcum_col, void* xdu, void* k_part,
           void* dd_part, int B, int L, int H, int G, int Q, cudaStream_t stream) {
  const int nc = L / Q, mats = B * nc * H, PN = P * N, nblk = PN / PASS_ENTRIES;
  CUtensorMap xm, dym, bm, cm, shm, slm, ghm, glm;
  if (!ssd::encode_steps_map(&xm, x, B, L, H, P) ||
      !ssd::encode_steps_map(&dym, dy, B, L, H, P) ||
      !ssd::encode_steps_map(&bm, b, B, L, G, N) ||
      !ssd::encode_steps_map(&cm, c, B, L, G, N) ||
      !ssd::encode_state_map(&shm, s_hi, mats, N) ||
      !ssd::encode_state_map(&slm, s_lo, mats, N) ||
      !ssd::encode_state_map(&ghm, g_hi, mats, N) ||
      !ssd::encode_state_map(&glm, g_lo, mats, N))
    return static_cast<int>(cudaErrorInvalidValue);
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(chunk_state_kernel<N>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           StateLayout<N>::BYTES);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(rows_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 RowsLayout<N>::BYTES);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(cols_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 ColsLayout<N>::BYTES);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set = true;
  }
  const float* dtp = static_cast<const float*>(dt);
  const float* alp = static_cast<const float*>(a_log);
  float* slp = static_cast<float*>(s_loc);
  float* dslp = static_cast<float*>(ds_loc);
  float* totp = static_cast<float*>(tot);
  float* sgp = static_cast<float*>(sg_part);
  float* dbp = static_cast<float*>(db_part);
  float* dcp = static_cast<float*>(dc_part);
  float* rowp = static_cast<float*>(dcum_row);
  float* colp = static_cast<float*>(dcum_col);
  float* xdup = static_cast<float*>(xdu);
  float* kp = static_cast<float*>(k_part);
  float* ddp = static_cast<float*>(dd_part);
  chunk_state_kernel<N><<<dim3(2 * nc, H, B), THREADS, StateLayout<N>::BYTES, stream>>>(
      xm, bm, dym, cm, dtp, alp, slp, dslp, totp, L, H, G, Q, nc);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  state_pass_kernel<<<dim3(nblk, H, B), PASS_THREADS, 0, stream>>>(
      slp, dslp, totp, static_cast<const float*>(dstate), static_cast<bf16*>(s_hi),
      static_cast<bf16*>(s_lo), static_cast<bf16*>(g_hi), static_cast<bf16*>(g_lo), sgp,
      nc, H, PN);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  rows_kernel<N><<<dim3(Q / ROWS, H, B * nc), THREADS, RowsLayout<N>::BYTES, stream>>>(
      xm, bm, cm, dym, shm, slm, dtp, alp, dcp, rowp, L, H, G, Q, nc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  cols_kernel<N><<<dim3(Q / ROWS, H, B * nc), THREADS, ColsLayout<N>::BYTES, stream>>>(
      xm, bm, cm, dym, ghm, glm, dtp, alp, static_cast<const float*>(d_skip),
      static_cast<bf16*>(dx), dbp, colp, xdup, kp, ddp, L, H, G, Q, nc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long want = (2LL * B * L * G * N + REDUCE_THREADS - 1) / REDUCE_THREADS;
  const int blocks = H + (int)(want < 132 * 8 ? want : 132 * 8);
  reduce_kernel<<<blocks, REDUCE_THREADS, 0, stream>>>(
      rowp, colp, xdup, kp, sgp, ddp, dtp, alp, dbp, dcp, static_cast<float*>(ddt),
      static_cast<bf16*>(db), static_cast<bf16*>(dc), static_cast<float*>(da),
      static_cast<float*>(dd), B, L, H, G, N, Q, nblk);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wg

}  // namespace

extern "C" {

// Dynamic shared memory of one block of the states (kernel 0) or chunks
// (kernel 1) kernel at state width N and P-slice PS.
int ssd_scan_bwd_smem_bytes(int kernel, int N, int PS) {
  return 4 * (kernel ? chunks_floats(N, PS) : states_floats(N, PS));
}

// x, dy, dx (B,L,H,P); b, c, db, dc (B,L,G,N): contiguous, bf16 (dtype 0) or
// fp32 (dtype 1). dt, ddt (B,L,H), a_log, d_skip, da, dd (H,), dstate
// (B,H,P,N; null: zero): fp32. Scratch from the caller, fp32: s_in and gs
// (B,L/Q,H,P,N), ddt_part (nsl,B,L,H), db_part and dc_part (nsl,B,L,H,N),
// da_part and dd_part (nsl,B,L/Q,H), nsl = P / (64, 32 or 16, the widest
// that divides P). Takes P % 16 == 0, N % 16 == 0 with N <= 128, 1 <= Q <=
// 256, L % Q == 0, H % G == 0 (the wrapper checks). Launches the states,
// chunks and reduce kernels in order; returns a cudaError_t value: 0 when
// every launch was accepted.
int ssd_scan_bwd(const void* x, const void* dt, const void* a_log, const void* b,
                 const void* c, const void* d_skip, const void* dy, const void* dstate,
                 void* dx, void* ddt, void* da, void* db, void* dc, void* dd, void* s_in,
                 void* gs, void* ddt_part, void* db_part, void* dc_part, void* da_part,
                 void* dd_part, int B, int L, int H, int P, int G, int N, int Q,
                 int dtype, void* stream) {
  if (B < 1 || L < 1 || H < 1 || G < 1 || P % 16 || P < 16 || N % 16 || N < 16 ||
      N > NMAX || Q < 1 || Q > QMAX || L % Q || H % G)
    return static_cast<int>(cudaErrorInvalidValue);
  if (cudaError_t err = hopper::bind_thread_device(x)) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_slices<bf16>(x, dt, a_log, b, c, d_skip, dy, dstate, dx, ddt, da, db,
                               dc, dd, s_in, gs, ddt_part, db_part, dc_part, da_part,
                               dd_part, B, L, H, P, G, N, Q, s);
  if (dtype == 1)
    return launch_slices<float>(x, dt, a_log, b, c, d_skip, dy, dstate, dx, ddt, da, db,
                                dc, dd, s_in, gs, ddt_part, db_part, dc_part, da_part,
                                dd_part, B, L, H, P, G, N, Q, s);
  return static_cast<int>(cudaErrorInvalidValue);
}


// Dynamic shared memory of one block of the wgmma variant's chunk_state
// (kernel 0), rows (1) or cols (2) at state width N (0 if N is not built).
int ssd_scan_bwd_wgmma_smem_bytes(int kernel, int N) {
  if (N == 64)
    return kernel == 0 ? ssd::StateLayout<64>::BYTES
         : kernel == 1 ? wg::RowsLayout<64>::BYTES : wg::ColsLayout<64>::BYTES;
  if (N == 128)
    return kernel == 0 ? ssd::StateLayout<128>::BYTES
         : kernel == 1 ? wg::RowsLayout<128>::BYTES : wg::ColsLayout<128>::BYTES;
  return 0;
}

// The wgmma variant. x, dy, dx (B,L,H,64) and b, c, db, dc (B,L,G,N):
// contiguous bf16, x, dy, b and c 16-byte aligned; dt, ddt (B,L,H), a_log,
// d_skip, da, dd (H,), dstate (B,H,64,N; null: zero): fp32. Scratch from the
// caller: s_loc and ds_loc (B,L/Q,H,64,N) and tot (B,L/Q,H) fp32; s_hi,
// s_lo, g_hi, g_lo (B,L/Q,H,64,N) bf16; sg_part (B,L/Q,H,64 N/1024),
// db_part and dc_part (B,L,H,N), dcum_row, dcum_col and xdu (B,L,H),
// k_part and dd_part (B,L/Q,Q/64,H) fp32. Takes N in {64, 128}, Q a
// multiple of 64 up to 256, L % Q == 0, H % G == 0, B L/Q <= 65535 (the
// wrapper checks). Launches chunk_state, state_pass, rows, cols and reduce
// in order; returns a cudaError_t value: 0 when every launch was accepted.
int ssd_scan_bwd_wgmma(const void* x, const void* dt, const void* a_log, const void* b,
                       const void* c, const void* d_skip, const void* dy,
                       const void* dstate, void* dx, void* ddt, void* da, void* db,
                       void* dc, void* dd, void* s_loc, void* ds_loc, void* tot,
                       void* s_hi, void* s_lo, void* g_hi, void* g_lo, void* sg_part,
                       void* db_part, void* dc_part, void* dcum_row, void* dcum_col,
                       void* xdu, void* k_part, void* dd_part, int B, int L, int H,
                       int P, int G, int N, int Q, void* stream) {
  if (B < 1 || H < 1 || G < 1 || P != wg::P || Q % wg::ROWS || Q < wg::ROWS ||
      Q > QMAX || L % Q || H % G || (long long)B * (L / Q) > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (cudaError_t err = hopper::bind_thread_device(x)) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N == 64)
    return wg::launch<64>(x, dt, a_log, b, c, d_skip, dy, dstate, dx, ddt, da, db, dc, dd,
                          s_loc, ds_loc, tot, s_hi, s_lo, g_hi, g_lo, sg_part, db_part,
                          dc_part, dcum_row, dcum_col, xdu, k_part, dd_part, B, L, H, G,
                          Q, s);
  if (N == 128)
    return wg::launch<128>(x, dt, a_log, b, c, d_skip, dy, dstate, dx, ddt, da, db, dc,
                           dd, s_loc, ds_loc, tot, s_hi, s_lo, g_hi, g_lo, sg_part,
                           db_part, dc_part, dcum_row, dcum_col, xdu, k_part, dd_part, B,
                           L, H, G, Q, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"

// Mamba2 chunked SSD scan backward for Hopper (sm_90a): fp32 FMA on the CUDA
// cores, fp32 and bf16 inputs.
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
// and db, dc are summed over the H/G heads of each group.
//
// Three kernels, deterministic: no atomics; every sum runs in a fixed order,
// so a backward run twice is bitwise equal.
//   1. states, one block per (P-slice, head, batch): a loop over the chunks
//      that recomputes the fp32 state entering each (the forward's wgmma
//      variant keeps only bf16 hi/lo copies, the fma variant none), then a
//      loop back over them that carries Gs; both written in fp32.
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
// The decay is formed per element and masked before it is exponentiated:
// cum reaches about -410 in a chunk, and e^{cum_t} e^{-cum_s} would
// overflow. Every exponent taken is <= 0 for dt >= 0.
//
// Bound on the H100. Work per (b, h, chunk): C B^T and dY U^T over the
// causal half (Q^2 N and Q^2 P), W^T dY, V B and V^T C (Q^2 P + 2 Q^2 N), the
// state terms dY S_in, B Gs^T, U Gs (6 Q N P) and the chunk's two state
// products (4 Q N P), FLOPs counted as 2 a multiply-add. At zamba2-7b's
// training shape (B=2, L=2048, H=112, P=64, N=64, G=2, chunk 256) that is
// about 5.6e10 FLOPs against about 0.2 GB of inputs and outputs: 0.06 ms at
// the bf16 tensor-core peak. This design computes C B^T and dY U^T twice
// (once per pass) on the CUDA cores, whose fp32 peak is 67 TFLOP/s: right
// and simple first, with no tensor cores. The wgmma/TMA redesign, as the
// forward had in PR 15, is the later speed work.
//
// Plain C interface for ctypes: every pointer and the stream are void*; the
// launch returns cudaGetLastError() so the caller can raise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

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
  const int hg = H / G;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x) {
    if (i < 2 * nbc) {               // db, then dc: (b, l, g, n)
      const bool is_c = i >= nbc;
      const long long j = is_c ? i - nbc : i;
      const int n = (int)(j % N), grp = (int)(j / N % G);
      const long long bl = j / ((long long)N * G);
      const float* part = is_c ? dc_part : db_part;
      float s = 0.f;
      for (int sl = 0; sl < nsl; ++sl)
        for (int hh = grp * hg; hh < (grp + 1) * hg; ++hh)
          s += part[(((size_t)sl * B * L + bl) * H + hh) * N + n];
      store((is_c ? dc : db) + j, s);
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

}  // extern "C"

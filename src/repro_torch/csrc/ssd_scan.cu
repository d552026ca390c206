// Mamba2 chunked SSD scan for Hopper (sm_90a): two variants.
//
// Replaces the TPU kernel repro/kernels/ssd_scan.py::ssd_scan_pallas (body
// _ssd_kernel) together with the work of its wrapper. For x (B,L,H,P), dt
// (B,L,H) fp32, a_log and d_skip (H,) fp32, b and c (B,L,G,N), with head h
// reading group h / (H/G), and chunks of Q steps:
//   cum_t   = sum_{r<=t} dt_r * A                    (A = -exp(a_log), in chunk)
//   y_t     = sum_{s<=t} (c_t . b_s) e^{cum_t - cum_s} u_s      (u = x * dt)
//           + e^{cum_t} (c_t . S)  + D x_t                     (S: carried state)
//   S      <- e^{cum_Q} S + sum_s e^{cum_Q - cum_s} u_s b_s^T   (fp32, P x N)
// and returns y in x's dtype and the final S (B,H,P,N) in fp32.
//
// Departures from the Pallas path, kept on purpose by both variants:
//   * the inputs are read in the layout the model hands over ((B,L,H,P) etc.);
//     u = x * dt and dt * A are formed here, so the fp32 head-major copies
//     that the Pallas wrapper builds are never materialised;
//   * the D skip is added in fp32 before the one rounding of y, as
//     ref.ssd_chunked does (the Pallas wrapper rounds y, then adds the skip
//     in x's dtype).
//
// Bound on the H100. Work per (b, h, chunk): Q^2 (N + P) FLOPs for the
// causal half of C.B^T and of W.u, plus 4 Q N P for the state term and the
// state update. Bytes: x and y, b and c once, dt in fp32, the state in fp32.
// At the serving prefill (B=4, L=2048, chunk 256) that is 4.5e10 FLOPs over
// 250 MB for zamba2-7b (H=112, P=64, N=64, G=2): 0.075 ms, bound by bytes;
// and 2.2e10 FLOPs over 77 MB for mamba2-370m (H=32, P=64, N=128, G=1),
// nearly balanced.
//
// Variant "wgmma" (bf16, P = 64, N in {64, 128}, Q a multiple of 64 up to
// 256; every model shape): the chunk-state decomposition of arXiv:2405.21060
// (section 7), three kernels launched in order on one stream:
//   1. chunk_state, one block per (chunk, head, batch): the chunk's local
//      state s_loc = sum_s x_s^T (dt_s e^{tot - cum_s}) b_s as a P x N
//      product over the chunk's Q steps on wgmma (A = the scaled x^T from
//      registers, B = b MN-major from shared memory), and tot = cum_{Q-1};
//   2. state_pass, one block per (1024 state entries, head, batch): the
//      only sequential part, S <- e^{tot_c} S + s_loc_c over the chunks on
//      the CUDA cores (pure bandwidth); it writes the state entering each
//      chunk as two bf16 tensors hi + lo and the final state in fp32;
//   3. chunk_scan, one block per (64-row t tile, head, chunk and batch),
//      the t tiles of a chunk side by side: acc = C_t S_in^T on wgmma (C and S_in K-major
//      from shared memory), scaled by e^{cum_t} per row; then per 64-step
//      s tile up to the diagonal, S = C B^T (wgmma, exactly flash's Q K^T),
//      W = S * e^{cum_t - cum_s} * dt_s masked to s <= t in registers (in
//      place of flash's softmax), acc += W x (wgmma, W from registers, x
//      MN-major: flash's P V), the W of one s tile formed while the tensor
//      cores run the previous tile's W x; y = acc + D x_t in fp32, rounded
//      once.
//   Each kernel has one producer warp that feeds 64-row tiles by TMA (4-D
//   maps over (B,L,H,P) and (B,L,G,N), 128-byte swizzled 64-column boxes,
//   so N = 128 is two boxes) into a ring of 2 stages on mbarriers, and one
//   consumer warpgroup. Both kernels recompute cum with one device function
//   (chunk_cum, explicit roundings, in ssd_common.cuh with the split and the
//   tensor maps, shared with the backward's wgmma kernels), so they see
//   bitwise the same decay.
//   Precision: a product of two bf16 values is exact in fp32, so C B^T loses
//   nothing; but x * w, W and S_in are fp32, and one bf16 rounding of them
//   (2^-9 relative) would exceed the 1e-4 state limit. Each such operand is
//   split as v = hi + lo (hi = bf16(v), lo = bf16(v - hi), about 16
//   significant bits) and multiplied against the exact bf16 operand twice
//   into the same fp32 accumulators: 2x the tensor-core work on those
//   products, far below the bytes. The decay is never factored into
//   e^{cum_t} e^{-cum_s} (cum reaches about -410 in a chunk and e^{410}
//   overflows): it is formed per element, masked before it is exponentiated.
//   The decomposition writes and reads the chunk states in fp32 and in
//   hi/lo and reads x twice: about 340 MB more than the bound's 250 MB at
//   zamba2-7b, so it cannot reach the algorithm's bound; that traffic is its
//   price for running every chunk in parallel.
//
// Variant "fma" (fp32, and bf16 shapes outside the set above): the first
// kernel, fp32 FMA products on the CUDA cores:
//   * one block per (P-slice of 32 or 16 columns, head, batch). Each row p of
//     the state evolves on its own given cum, b and c, so slicing P fills the
//     card: 256 blocks at mamba2-370m instead of 128 for 132 SMs, at the cost
//     of computing C.B^T once per slice;
//   * a loop over the chunks inside the block replaces the TPU's sequential
//     ("arbitrary") grid axis; the fp32 state slice stays in shared memory
//     across the loop;
//   * within a chunk the (t, s) square is cut into 64 x 64 tiles, and tiles
//     above the diagonal are skipped. Each thread owns a 4 x 4 micro-tile of
//     C.B^T and a 4 x 2 micro-tile of y, read from shared memory as float4
//     along N;
//   * the decay is masked before it is exponentiated: above the diagonal
//     cum_t - cum_s > 0 can overflow, and inf * 0 would be NaN;
//   * cum is a block-wide inclusive scan (one step per thread, Q <= 256).
// It is bound by operations on the CUDA cores (67 TFLOP/s): the Pallas
// kernel's fp32 dots, carried over without TF32.
//
// Plain C interface for ctypes: every pointer and the stream are void*; the
// launches return cudaGetLastError() so the caller can raise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "ssd_common.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int THREADS = 256;      // 16 x 16 threads
constexpr int TILE = 64;          // rows of t or s per tile
constexpr int PS = 32;            // widest P-slice of one block
constexpr int QMAX = THREADS;     // the scan gives each thread one step
constexpr int NMAX = 128;         // the state update keeps N/16 <= 8 sums a thread
constexpr int LDW = TILE + 4;     // row stride of the W tile (floats)

__host__ __device__ constexpr int ld_n(int N) { return N + 4; }   // rows of b, c, S

// Shared-memory layout, in floats: cum[QMAX], dt[QMAX], C[TILE][ld_n],
// B[TILE][ld_n], U[TILE][PS], W[TILE][LDW], S[PS][ld_n].
__host__ __device__ constexpr int smem_floats(int N) {
  return 2 * QMAX + 2 * TILE * ld_n(N) + TILE * PS + TILE * LDW + PS * ld_n(N);
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(bf16* p, float v) { *p = __float2bfloat16(v); }

__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

__device__ __forceinline__ float at(float4 v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
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

// U[r][p] = x[r][p] * dt[r] in fp32; rows past `rows` and columns past `ps`
// are zero.
template <typename T>
__device__ void load_u(float* sU, const T* xs, size_t row_stride,
                       const float* dts, int rows, int ps) {
  for (int e = threadIdx.x; e < TILE * PS; e += THREADS) {
    int r = e / PS, p = e - r * PS;
    sU[e] = (r < rows && p < ps) ? to_f(xs[(size_t)r * row_stride + p]) * dts[r] : 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ a_log, const T* __restrict__ bm,
                const T* __restrict__ cm, const float* __restrict__ d_skip,
                T* __restrict__ y, float* __restrict__ state,
                int L, int H, int P, int G, int N, int Q, int ps) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float warp_tot[THREADS / 32];
  const int ldn = ld_n(N);
  float* sCum = smem;
  float* sDt = sCum + QMAX;
  float* sC = sDt + QMAX;
  float* sB = sC + TILE * ldn;
  float* sU = sB + TILE * ldn;
  float* sW = sU + TILE * PS;
  float* sS = sW + TILE * LDW;

  const int p0 = blockIdx.x * ps, h = blockIdx.y, b = blockIdx.z;
  const int g = h / (H / G);
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const float A = -expf(a_log[h]);
  const float D = d_skip[h];
  const size_t xrow = (size_t)H * P;          // x, y: stride of one step
  const size_t brow = (size_t)G * N;          // b, c: stride of one step
  const T* xg = x + ((size_t)b * L * H + h) * P + p0;
  T* yg = y + ((size_t)b * L * H + h) * P + p0;
  const float* dtg = dt + (size_t)b * L * H + h;
  const T* bg = bm + ((size_t)b * L * G + g) * N;
  const T* cg = cm + ((size_t)b * L * G + g) * N;
  const int nk = N / 16;                      // state columns n = ty + 16 k
  const int ntiles = (Q + TILE - 1) / TILE;

  for (int e = tid; e < PS * ldn; e += THREADS) sS[e] = 0.f;

  for (int l0 = 0; l0 < L; l0 += Q) {
    // 1. the chunk's dt and cumulative log-decay
    const float d = tid < Q ? dtg[(size_t)(l0 + tid) * H] : 0.f;
    const float cum = block_scan(d * A, warp_tot);
    if (tid < Q) {
      sDt[tid] = d;
      sCum[tid] = cum;
    }
    __syncthreads();
    const float tot = sCum[Q - 1];

    // 2. y, one 64-row tile of t at a time; thread rows ty + 16 r, columns
    //    tx + 16 c of the P-slice
    for (int it = 0; it < ntiles; ++it) {
      const int t0 = it * TILE;
      load_rows(sC, ldn, cg + (size_t)(l0 + t0) * brow, brow, min(TILE, Q - t0), N);
      __syncthreads();

      // carried state: acc = e^{cum_t} (c_t . S_p)
      float acc[4][2];
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[r][0] = acc[r][1] = 0.f;
      for (int n = 0; n < N; n += 4) {
        float4 cv[4], sv[2];
#pragma unroll
        for (int r = 0; r < 4; ++r)
          cv[r] = *reinterpret_cast<const float4*>(sC + (ty + 16 * r) * ldn + n);
#pragma unroll
        for (int c = 0; c < 2; ++c)
          sv[c] = *reinterpret_cast<const float4*>(sS + (tx + 16 * c) * ldn + n);
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 2; ++c) acc[r][c] += dot4(cv[r], sv[c]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int t = t0 + ty + 16 * r;
        const float e = t < Q ? expf(sCum[t]) : 0.f;
        acc[r][0] *= e;
        acc[r][1] *= e;
      }

      // intra-chunk: acc += W u with W = (C B^T) ⊙ e^{cum_t - cum_s}, s <= t
      for (int js = 0; js <= it; ++js) {
        const int s0 = js * TILE, rows_s = min(TILE, Q - s0);
        load_rows(sB, ldn, bg + (size_t)(l0 + s0) * brow, brow, rows_s, N);
        load_u(sU, xg + (size_t)(l0 + s0) * xrow, xrow, sDt + s0, rows_s, ps);
        __syncthreads();
        float wv[4][4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) wv[r][c] = 0.f;
        for (int n = 0; n < N; n += 4) {
          float4 cv[4], bv[4];
#pragma unroll
          for (int r = 0; r < 4; ++r)
            cv[r] = *reinterpret_cast<const float4*>(sC + (ty + 16 * r) * ldn + n);
#pragma unroll
          for (int c = 0; c < 4; ++c)
            bv[c] = *reinterpret_cast<const float4*>(sB + (tx + 16 * c) * ldn + n);
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < 4; ++c) wv[r][c] += dot4(cv[r], bv[c]);
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int t = t0 + ty + 16 * r;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int s = s0 + tx + 16 * c;
            float w = 0.f;
            if (s <= t && t < Q) w = wv[r][c] * expf(sCum[t] - sCum[s]);
            sW[(ty + 16 * r) * LDW + tx + 16 * c] = w;
          }
        }
        __syncthreads();
        for (int s = 0; s < TILE; s += 4) {
          float4 wr[4];
#pragma unroll
          for (int r = 0; r < 4; ++r)
            wr[r] = *reinterpret_cast<const float4*>(sW + (ty + 16 * r) * LDW + s);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float u0 = sU[(s + q) * PS + tx], u1 = sU[(s + q) * PS + tx + 16];
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              const float w = at(wr[r], q);
              acc[r][0] += w * u0;
              acc[r][1] += w * u1;
            }
          }
        }
        __syncthreads();              // sB, sU, sW are refilled next
      }

      // y = acc + D x, rounded once
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int t = t0 + ty + 16 * r;
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int p = tx + 16 * c;
          if (t < Q && p < ps) {
            const size_t o = (size_t)(l0 + t) * xrow + p;
            store(yg + o, acc[r][c] + D * to_f(xg[o]));
          }
        }
      }
    }

    // 3. state: S = e^{tot} S + sum_s e^{tot - cum_s} u_s b_s^T; thread
    //    entries p = tx + 16 c, n = ty + 16 k
    float sacc[2][NMAX / 16];
#pragma unroll
    for (int k = 0; k < NMAX / 16; ++k) sacc[0][k] = sacc[1][k] = 0.f;
    for (int js = 0; js < ntiles; ++js) {
      const int s0 = js * TILE, rows_s = min(TILE, Q - s0);
      load_rows(sB, ldn, bg + (size_t)(l0 + s0) * brow, brow, rows_s, N);
      load_u(sU, xg + (size_t)(l0 + s0) * xrow, xrow, sDt + s0, rows_s, ps);
      __syncthreads();
      for (int s = 0; s < rows_s; ++s) {
        const float w = expf(tot - sCum[s0 + s]);
        const float u0 = sU[s * PS + tx] * w, u1 = sU[s * PS + tx + 16] * w;
#pragma unroll
        for (int k = 0; k < NMAX / 16; ++k) {
          if (k < nk) {
            const float bv = sB[s * ldn + ty + 16 * k];
            sacc[0][k] += u0 * bv;
            sacc[1][k] += u1 * bv;
          }
        }
      }
      __syncthreads();
    }
    const float et = expf(tot);
#pragma unroll
    for (int c = 0; c < 2; ++c)
#pragma unroll
      for (int k = 0; k < NMAX / 16; ++k)
        if (k < nk) {
          float* sp = sS + (tx + 16 * c) * ldn + ty + 16 * k;
          *sp = *sp * et + sacc[c][k];
        }
    __syncthreads();
  }

  float* st = state + ((size_t)b * H + h) * P * N + (size_t)p0 * N;
  for (int e = tid; e < ps * N; e += THREADS) {
    const int p = e / N, n = e - p * N;
    st[(size_t)p * N + n] = sS[p * ldn + n];
  }
}

template <typename T>
int launch(const void* x, const void* dt, const void* a_log, const void* b,
           const void* c, const void* d_skip, void* y, void* state, int B,
           int L, int H, int P, int G, int N, int Q, cudaStream_t stream) {
  const int bytes = smem_floats(N) * 4;
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int ps = P % PS == 0 ? PS : 16;
  dim3 grid(P / ps, H, B);
  ssd_scan_kernel<T><<<grid, THREADS, bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(a_log), static_cast<const T*>(b),
      static_cast<const T*>(c), static_cast<const float*>(d_skip),
      static_cast<T*>(y), static_cast<float*>(state), L, H, P, G, N, Q, ps);
  return static_cast<int>(cudaGetLastError());
}

// ---- variant "wgmma": chunk_state, state_pass, chunk_scan ------------------

namespace wg {

using ssd::align1024;
using ssd::box_at;
using ssd::BOXB;
using ssd::chunk_cum;
using ssd::chunk_state_kernel;
using ssd::CONSUMERS;
using ssd::fast_exp2;
using ssd::LOG2E;
using ssd::P;
using ssd::PASS_ENTRIES;
using ssd::PASS_THREADS;
using ssd::ROWS;
using ssd::split_bf16;
using ssd::split_fragments;
using ssd::STAGES;
using ssd::StateLayout;
using ssd::THREADS;

// Shared memory of chunk_scan: the t tile of C, the entering state's hi and
// lo (each 64 rows x N), the ring of (x box, N/64 b boxes) stages, then the
// barriers (C, state, full and empty a stage); + slack to align to 1024.
template <int N>
struct ScanLayout {
  static constexpr int NB = N / 64;
  static constexpr int OPER = NB * BOXB;
  static constexpr int RING_OFFSET = 3 * OPER;
  static constexpr int STAGE = BOXB + OPER;
  static constexpr int BARRIER_OFFSET = RING_OFFSET + STAGES * STAGE;
  static constexpr int BYTES = BARRIER_OFFSET + (2 + 2 * STAGES) * 8 + 1024;
};

// Block (1024 state entries, head h, batch b): S <- e^{tot_c} S + s_loc_c
// over the chunks; the state entering chunk c > 0 goes out as hi + lo bf16
// (chunk 0's is zero and is never read), the final state in fp32. P N
// (4096 or 8192) is a multiple of the 1024 entries of a block.
__global__ void __launch_bounds__(PASS_THREADS)
state_pass_kernel(const float* __restrict__ s_loc, const float* __restrict__ tot,
                  bf16* __restrict__ s_hi, bf16* __restrict__ s_lo,
                  float* __restrict__ state, int nc, int H, int PN) {
  const int h = blockIdx.y, b = blockIdx.z;
  const int e = blockIdx.x * PASS_ENTRIES + threadIdx.x * 4;
  float v[4] = {0.f, 0.f, 0.f, 0.f};
  for (int c = 0; c < nc; ++c) {
    const size_t bch = ((size_t)b * nc + c) * H + h;
    const size_t o = bch * PN + e;
    const float4 sl = *reinterpret_cast<const float4*>(s_loc + o);
    const float et = expf(tot[bch]);
    if (c > 0) {
      uint32_t hi[2], lo[2];
      split_bf16(v[0], v[1], hi[0], lo[0]);
      split_bf16(v[2], v[3], hi[1], lo[1]);
      *reinterpret_cast<uint2*>(s_hi + o) = make_uint2(hi[0], hi[1]);
      *reinterpret_cast<uint2*>(s_lo + o) = make_uint2(lo[0], lo[1]);
    }
    // S e^{tot} + s_loc, rounded twice as the plain version's two ops are
    v[0] = __fadd_rn(__fmul_rn(v[0], et), sl.x);
    v[1] = __fadd_rn(__fmul_rn(v[1], et), sl.y);
    v[2] = __fadd_rn(__fmul_rn(v[2], et), sl.z);
    v[3] = __fadd_rn(__fmul_rn(v[3], et), sl.w);
  }
  *reinterpret_cast<float4*>(state + ((size_t)b * H + h) * PN + e) =
      make_float4(v[0], v[1], v[2], v[3]);
}

// Block (t tile, head h, chunk c and batch b as b nc + c): y of the 64 rows
// t0 .. t0 + 63 of chunk c, all P columns. The t tiles of one (h, b, c) are
// neighbours in the grid, so the x and b tiles they share come from L2.
template <int N>
__global__ void __launch_bounds__(THREADS)
chunk_scan_kernel(__grid_constant__ const CUtensorMap xmap,
                  __grid_constant__ const CUtensorMap bmap,
                  __grid_constant__ const CUtensorMap cmap,
                  __grid_constant__ const CUtensorMap himap,
                  __grid_constant__ const CUtensorMap lomap,
                  const float* __restrict__ dt, const float* __restrict__ a_log,
                  const float* __restrict__ d_skip, bf16* __restrict__ y,
                  int L, int H, int G, int Q, int nc) {
  using Lay = ScanLayout<N>;
  constexpr int NB = Lay::NB;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  __shared__ float sDt[QMAX], sCum[QMAX], warp_tot[CONSUMERS / 32];
  unsigned char* base = align1024(smem_raw);
  unsigned char* sC = base;
  unsigned char* sHi = base + Lay::OPER;
  unsigned char* sLo = base + 2 * Lay::OPER;
  unsigned char* ring = base + Lay::RING_OFFSET;
  uint64_t* c_full = reinterpret_cast<uint64_t*>(base + Lay::BARRIER_OFFSET);
  uint64_t* s_full = c_full + 1;
  uint64_t* full = s_full + 1;
  uint64_t* empty = full + STAGES;

  const int h = blockIdx.y, bc = blockIdx.z, b = bc / nc, c = bc % nc;
  const int it = gridDim.x - 1 - blockIdx.x;          // longest t tile first
  const int g = h / (H / G);
  const int l0 = c * Q, t0 = it * ROWS;

  if (threadIdx.x == 0) {
    hopper::mbar_init(c_full, 1);
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
      hopper::tma_prefetch_map(&cmap);
      hopper::mbar_expect_tx(c_full, Lay::OPER);
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
        hopper::tma_load_4d(sC + nb * BOXB, &cmap, c_full, nb * hopper::BOX, g,
                            l0 + t0, b);
      if (c > 0) {
        hopper::mbar_expect_tx(s_full, 2 * Lay::OPER);
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) {
          hopper::tma_load_3d(sHi + nb * BOXB, &himap, s_full, nb * hopper::BOX, 0,
                              bc * H + h);
          hopper::tma_load_3d(sLo + nb * BOXB, &lomap, s_full, nb * hopper::BOX, 0,
                              bc * H + h);
        }
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

  float acc[32];
#pragma unroll
  for (int k = 0; k < 32; ++k) acc[k] = 0.f;
  hopper::mbar_wait(c_full, 0);

  // carried state: acc = e^{cum_t} (C_t S_in^T), S_in = hi + lo
  if (c > 0) {
    hopper::mbar_wait(s_full, 0);
    hopper::fence_regs(acc);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk) {
      const int off = (kk / 4) * BOXB + (kk % 4) * 32;
      const uint64_t ad = hopper::desc_kmajor(sC + off);
      hopper::wgmma_ss<0, 0>(acc, ad, hopper::desc_kmajor(sHi + off), 1);
      hopper::wgmma_ss<0, 0>(acc, ad, hopper::desc_kmajor(sLo + off), 1);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);
    const float e0 = expf(cum0), e1 = expf(cum1);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      acc[4 * j] *= e0;
      acc[4 * j + 1] *= e0;
      acc[4 * j + 2] *= e1;
      acc[4 * j + 3] *= e1;
    }
  }

  // intra-chunk: acc += W_s x_s over the s tiles up to the diagonal. Step js
  // issues S_js = C_t B_js^T and W_{js-1} x_{js-1} together, waits for S_js
  // only, and forms W_js on the CUDA cores while the tensor cores finish
  // W_{js-1} x_{js-1}; then stage js - 1 goes back to the producer and W_js
  // is split into the A fragments. The diagonal stage is kept: it holds x_t.
  auto stage = [&](int js) { return ring + (js % STAGES) * Lay::STAGE; };
  auto issue_s = [&](float (&sc)[32], int js) {
    const unsigned char* st = stage(js);
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk) {
      const int off = (kk / 4) * BOXB + (kk % 4) * 32;
      hopper::wgmma_ss<0, 0>(sc, hopper::desc_kmajor(sC + off),
                             hopper::desc_kmajor(st + BOXB + off), kk > 0);
    }
    hopper::wgmma_commit();
  };
  auto issue_wx = [&](float (&acc)[32], uint32_t (&whi)[4][4], uint32_t (&wlo)[4][4],
                      int js) {
    const unsigned char* st = stage(js);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t bd = hopper::desc_mnmajor(st + 2048 * kk, BOXB);
      hopper::wgmma_rs<1>(acc, whi[kk], bd, 1);
      hopper::wgmma_rs<1>(acc, wlo[kk], bd, 1);
    }
    hopper::wgmma_commit();
  };
  // W = S e^{cum_t - cum_s} dt_s where s <= t (masked before the exp), in
  // place. The decay is 2^{(cum_t - cum_s) log2 e} on the special-function
  // unit: the difference is formed in natural units first, so scaling it
  // costs one rounding of a small number, not of cum (which reaches about
  // -410). expf's range reduction around the same instruction was the
  // largest piece of this kernel's time.
  auto weights = [&](float (&sc)[32], int js) {
    const bool diag = js == it;
    const float* cs = sCum + js * ROWS;
    const float* ds = sDt + js * ROWS;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int sl = 8 * j + 2 * t4 + (e & 1), row = e < 2 ? r0 : r1;
        const float ct = e < 2 ? cum0 : cum1;
        sc[4 * j + e] = diag && sl > row
            ? 0.f : sc[4 * j + e] * fast_exp2((ct - cs[sl]) * LOG2E) * ds[sl];
      }
  };
  auto release = [&](int js) {
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&empty[js % STAGES]);
  };

  float sc[32];
  uint32_t whi[4][4], wlo[4][4];
  hopper::mbar_wait(&full[0], 0);
  hopper::fence_regs(sc);
  hopper::wgmma_fence();
  issue_s(sc, 0);
  hopper::wgmma_wait<0>();
  hopper::fence_regs(sc);
  weights(sc, 0);
  split_fragments(sc, whi, wlo);
  for (int js = 1; js <= it; ++js) {
    hopper::mbar_wait(&full[js % STAGES], (js / STAGES) & 1);
    hopper::fence_regs(sc);
    hopper::fence_regs(acc);
    hopper::fence_regs(whi);
    hopper::fence_regs(wlo);
    hopper::wgmma_fence();
    issue_s(sc, js);
    issue_wx(acc, whi, wlo, js - 1);
    hopper::wgmma_wait<1>();                 // S_js is in
    hopper::fence_regs(sc);
    weights(sc, js);
    hopper::wgmma_wait<0>();                 // W_{js-1} x_{js-1} is in
    hopper::fence_regs(acc);
    hopper::fence_regs(whi);
    hopper::fence_regs(wlo);
    release(js - 1);
    split_fragments(sc, whi, wlo);
  }
  hopper::fence_regs(acc);
  hopper::fence_regs(whi);
  hopper::fence_regs(wlo);
  hopper::wgmma_fence();
  issue_wx(acc, whi, wlo, it);
  hopper::wgmma_wait<0>();
  hopper::fence_regs(acc);
  const unsigned char* sx = stage(it);

  // y = acc + D x_t, rounded once; x_t is the diagonal s tile
  const float D = d_skip[h];
  bf16* y0 = y + (((size_t)b * L + l0 + t0 + r0) * H + h) * P;
  bf16* y1 = y + (((size_t)b * L + l0 + t0 + r1) * H + h) * P;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int p = 8 * j + 2 * t4;
    *reinterpret_cast<__nv_bfloat162*>(y0 + p) = __floats2bfloat162_rn(
        acc[4 * j] + D * box_at(sx, r0, p), acc[4 * j + 1] + D * box_at(sx, r0, p + 1));
    *reinterpret_cast<__nv_bfloat162*>(y1 + p) = __floats2bfloat162_rn(
        acc[4 * j + 2] + D * box_at(sx, r1, p), acc[4 * j + 3] + D * box_at(sx, r1, p + 1));
  }
}

template <int N>
int launch(const void* x, const void* dt, const void* a_log, const void* b,
           const void* c, const void* d_skip, void* y, void* state, void* s_loc,
           void* tot, void* s_hi, void* s_lo, int B, int L, int H, int G, int Q,
           cudaStream_t stream) {
  const int nc = L / Q, mats = B * nc * H;
  CUtensorMap xm, bm, cm, him, lom;
  if (!ssd::encode_steps_map(&xm, x, B, L, H, P) ||
      !ssd::encode_steps_map(&bm, b, B, L, G, N) ||
      !ssd::encode_steps_map(&cm, c, B, L, G, N) ||
      !ssd::encode_state_map(&him, s_hi, mats, N) ||
      !ssd::encode_state_map(&lom, s_lo, mats, N))
    return static_cast<int>(cudaErrorInvalidValue);
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(chunk_state_kernel<N>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           StateLayout<N>::BYTES);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(chunk_scan_kernel<N>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 ScanLayout<N>::BYTES);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set = true;
  }
  const float* dtp = static_cast<const float*>(dt);
  const float* alp = static_cast<const float*>(a_log);
  chunk_state_kernel<N><<<dim3(nc, H, B), THREADS, StateLayout<N>::BYTES, stream>>>(
      xm, bm, xm, bm, dtp, alp, static_cast<float*>(s_loc), nullptr,
      static_cast<float*>(tot), L, H, G, Q, nc);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int PN = P * N;
  state_pass_kernel<<<dim3(PN / PASS_ENTRIES, H, B), PASS_THREADS,
                      0, stream>>>(static_cast<const float*>(s_loc),
                                   static_cast<const float*>(tot), static_cast<bf16*>(s_hi),
                                   static_cast<bf16*>(s_lo), static_cast<float*>(state),
                                   nc, H, PN);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  chunk_scan_kernel<N><<<dim3(Q / ROWS, H, B * nc), THREADS, ScanLayout<N>::BYTES, stream>>>(
      xm, bm, cm, him, lom, dtp, alp, static_cast<const float*>(d_skip),
      static_cast<bf16*>(y), L, H, G, Q, nc);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wg

}  // namespace

extern "C" {

// Dynamic shared memory one block uses at state width N.
int ssd_scan_smem_bytes(int N) { return smem_floats(N) * 4; }

// x (B,L,H,P), b/c (B,L,G,N), y (B,L,H,P): contiguous, bf16 (dtype 0) or fp32
// (dtype 1); dt (B,L,H), a_log and d_skip (H,), state (B,H,P,N): fp32.
// Takes P % 16 == 0, N % 16 == 0 with N <= 128, 1 <= Q <= 256, L % Q == 0,
// H % G == 0 (the wrapper checks). Returns a cudaError_t value: 0 when the
// launch was accepted.
int ssd_scan_fwd(const void* x, const void* dt, const void* a_log,
                 const void* b, const void* c, const void* d_skip, void* y,
                 void* state, int B, int L, int H, int P, int G, int N, int Q,
                 int dtype, void* stream) {
  if (P % 16 || N % 16 || N > NMAX || Q < 1 || Q > QMAX || L % Q || H % G)
    return static_cast<int>(cudaErrorInvalidValue);
  if (cudaError_t err = hopper::bind_thread_device(x)) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<bf16>(x, dt, a_log, b, c, d_skip, y, state, B, L, H, P, G, N, Q, s);
  if (dtype == 1)
    return launch<float>(x, dt, a_log, b, c, d_skip, y, state, B, L, H, P, G, N, Q, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Dynamic shared memory of one block of the wgmma variant's chunk_state
// (kernel 0) or chunk_scan (kernel 1) at state width N (0 if N is not built).
int ssd_scan_wgmma_smem_bytes(int kernel, int N) {
  if (N == 64) return kernel ? wg::ScanLayout<64>::BYTES : ssd::StateLayout<64>::BYTES;
  if (N == 128) return kernel ? wg::ScanLayout<128>::BYTES : ssd::StateLayout<128>::BYTES;
  return 0;
}

// The wgmma variant. x (B,L,H,64), b/c (B,L,G,N), y (B,L,H,64): contiguous
// bf16, x, b and c 16-byte aligned; dt (B,L,H), a_log and d_skip (H,), state
// (B,H,64,N): fp32. Scratch from the caller: s_loc (B,L/Q,H,64,N) and tot
// (B,L/Q,H) fp32, s_hi and s_lo (B,L/Q,H,64,N) bf16. Takes N in {64, 128},
// Q a multiple of 64 up to 256, L % Q == 0, H % G == 0, B L/Q <= 65535 (the
// wrapper checks). Launches chunk_state, state_pass and chunk_scan in order;
// returns a cudaError_t value: 0 when all three launches were accepted.
int ssd_scan_wgmma_fwd(const void* x, const void* dt, const void* a_log,
                       const void* b, const void* c, const void* d_skip, void* y,
                       void* state, void* s_loc, void* tot, void* s_hi, void* s_lo,
                       int B, int L, int H, int P, int G, int N, int Q, void* stream) {
  if (P != wg::P || Q % wg::ROWS || Q < wg::ROWS || Q > QMAX || L % Q || H % G ||
      (long long)B * (L / Q) > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (cudaError_t err = hopper::bind_thread_device(x)) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N == 64)
    return wg::launch<64>(x, dt, a_log, b, c, d_skip, y, state, s_loc, tot, s_hi, s_lo,
                          B, L, H, G, Q, s);
  if (N == 128)
    return wg::launch<128>(x, dt, a_log, b, c, d_skip, y, state, s_loc, tot, s_hi,
                           s_lo, B, L, H, G, Q, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"

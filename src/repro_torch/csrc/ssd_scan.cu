// Mamba2 chunked SSD scan for Hopper (sm_90a): fp32 products on the CUDA cores.
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
// Departures from the Pallas path, kept on purpose:
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
// nearly balanced. This first kernel does its products as fp32 FMAs on the
// CUDA cores (67 TFLOP/s, not the tensor cores), so it is bound by
// operations: the Pallas kernel's fp32 dots, carried over without TF32.
//
// Design:
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
// Tensor cores (TF32 or bf16 mma/wgmma) are a later step for this kernel.
//
// Plain C interface for ctypes: every pointer and the stream are void*; the
// launch returns cudaGetLastError() so the caller can raise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<bf16>(x, dt, a_log, b, c, d_skip, y, state, B, L, H, P, G, N, Q, s);
  if (dtype == 1)
    return launch<float>(x, dt, a_log, b, c, d_skip, y, state, B, L, H, P, G, N, Q, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"

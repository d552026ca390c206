// Grouped (per-expert) GEMM for Hopper (sm_90a): (E,C,d) @ (E,d,f) -> (E,C,f).
//
// Replaces the TPU kernel repro/kernels/moe_gmm.py::gmm_pallas (moe_gmm.py:47,
// body _gmm_kernel :26): a bank of E independent matrix products over the MoE
// capacity buffer that models/moe.py gathers, x (E, C, d) row-major with d
// contiguous and w (E, d, f) with f contiguous. The sum over d is kept in fp32
// and the output is rounded once to x's dtype. The Pallas kernel pads C, d and
// f to its blocks on the host and slices the result back (moe_gmm.py:56-66,
// :87); this kernel masks its own ragged edges instead (zero-filled loads,
// guarded stores), so no padded copy is made.
//
// Bound on the H100. Work: 2*E*C*d*f FLOPs at the 989 TFLOP/s bf16 tensor-core
// peak, against the bytes of x, w and the output read or written once at
// 3.35 TB/s. At deepseek-moe-16b's shapes (E=64 experts, d=2048, f=1408):
//   prefill, B=4 x 2048 tokens, capacity C=968, gate/up:
//     3.57e11 FLOPs = 0.361 ms against 0.80 GB = 0.238 ms: bound by operations;
//   decode, 4 tokens, C=8 (the capacity floor):
//     369 MB of expert weights = 0.110 ms against 3.0e9 FLOPs: bound by bytes.
// The design is the simple right one, not yet the fast one:
//   * one thread block per (f-tile of 128, C-tile of 128, expert); a loop over
//     d inside the block takes the place of the TPU's sequential ("arbitrary")
//     fourth grid axis, with the (128 x 128) fp32 accumulator in registers;
//   * eight warps, each owning a 64 x 32 piece of the output tile: per 16-deep
//     step four ldmatrix.x4 loads of x (the A operand, row-major), two
//     ldmatrix.x4.trans loads of w (the B operand, f contiguous, exactly as V
//     is read in flash_attention.cu) and sixteen mma.sync m16n8k16
//     (bf16 x bf16 -> fp32);
//   * x and w tiles 32 deep are staged through shared memory with cp.async,
//     two stages, so the next tile loads while the current one is multiplied;
//     shared rows carry 8 bf16 of padding so that ldmatrix is free of bank
//     conflicts;
//   * 16-byte cp.async needs d and f to be multiples of 8 and 16-byte aligned
//     bases; other shapes take element-wise loads into the same pipeline;
//   * fp32 inputs take an FMA path of the same block tiling (256 threads, 8 x 8
//     outputs each, tiles 16 deep), never TF32, so that it keeps fp32 accuracy.
// wgmma, TMA, a deeper pipeline and a C-tile chosen per shape are later work:
// in the decode shape a 128-row C tile is 15/16 padding.
//
// Plain C interface for ctypes: every pointer and the stream are void*; the
// launch returns cudaGetLastError() so the caller can raise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int BM = 128;             // rows of C per block
constexpr int BN = 128;             // columns of f per block
constexpr int BK = 32;              // depth of one bf16 tile of d
constexpr int THREADS = 256;        // 8 warps: 2 along C (64 rows) x 4 along f (32 columns)
constexpr int PAD = 8;              // bf16 of padding per shared row
constexpr int LDA = BK + PAD;       // shared row stride of the x tile
constexpr int LDB = BN + PAD;       // shared row stride of the w tile
constexpr int A_TILE = BM * LDA;    // elements
constexpr int B_TILE = BK * LDB;
constexpr int STAGES = 2;
constexpr int BF16_SMEM = STAGES * (A_TILE + B_TILE) * 2;
constexpr int FK = 16;              // depth of one fp32 tile of d
constexpr int F32_SMEM = (FK * (BM + 1) + FK * BN) * 4;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  int n = pred ? 16 : 0;            // 0 source bytes: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // .x (lo) in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const bf16* p) {
  uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

// c += a (16x16, row) * b (16x8, col); bf16 inputs, fp32 accumulators.
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Stage the rows x cols tile at (r0, c0) of a row-major (n_rows, n_cols) bf16
// matrix into shared memory (row stride ld); entries past either edge are
// zero, so ragged tiles add nothing to the sums. VEC: 16-byte cp.async per
// chunk of 8 (n_cols % 8 == 0 and an aligned base); otherwise element-wise
// loads and stores into the same stage.
template <int ROWS, int COLS, bool VEC>
__device__ __forceinline__ void load_tile(bf16* smem, int ld, const bf16* g,
                                          int r0, int c0, int n_rows, int n_cols) {
  constexpr int CH = COLS / 8;      // 16-byte chunks per tile row
  static_assert(ROWS * CH % THREADS == 0, "tile chunks divide among threads");
#pragma unroll
  for (int i = 0; i < ROWS * CH / THREADS; ++i) {
    int c = threadIdx.x + i * THREADS;
    int r = c / CH, col = (c % CH) * 8;
    int gr = r0 + r, gc = c0 + col;
    bf16* dst = smem + r * ld + col;
    if (VEC) {
      bool ok = gr < n_rows && gc < n_cols;
      const bf16* src = ok ? g + (size_t)gr * n_cols + gc : g;
      cp_async16(dst, src, ok);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        bool ok = gr < n_rows && gc + j < n_cols;
        dst[j] = ok ? g[(size_t)gr * n_cols + gc + j] : __float2bfloat16(0.f);
      }
    }
  }
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
gmm_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                bf16* __restrict__ out, int C, int d, int f) {
  __shared__ __align__(16) bf16 sA[STAGES][A_TILE];
  __shared__ __align__(16) bf16 sB[STAGES][B_TILE];

  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM, e = blockIdx.z;
  const bf16* xe = x + (size_t)e * C * d;
  const bf16* we = w + (size_t)e * d * f;
  bf16* oe = out + (size_t)e * C * f;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / 4, wn = warp % 4;       // this warp's 64 x 32 piece
  const int g = lane >> 2, t4 = lane & 3;       // mma fragment row / column pair

  float acc[4][4][4];                           // [m16 tile][n8 tile][fragment]
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int nj = 0; nj < 4; ++nj)
      acc[mi][nj][0] = acc[mi][nj][1] = acc[mi][nj][2] = acc[mi][nj][3] = 0.f;

  const int k_tiles = (d + BK - 1) / BK;
  load_tile<BM, BK, VEC>(sA[0], LDA, xe, m0, 0, C, d);
  load_tile<BK, BN, VEC>(sB[0], LDB, we, 0, n0, d, f);
  cp_async_commit();

  for (int kt = 0; kt < k_tiles; ++kt) {
    const int stage = kt & 1;
    if (kt + 1 < k_tiles) {                     // prefetch the next d tile
      load_tile<BM, BK, VEC>(sA[stage ^ 1], LDA, xe, m0, (kt + 1) * BK, C, d);
      load_tile<BK, BN, VEC>(sB[stage ^ 1], LDB, we, (kt + 1) * BK, n0, d, f);
    }
    cp_async_commit();
    cp_async_wait<1>();                         // tile kt has landed
    __syncthreads();
    const bf16* a_s = sA[stage] + (wm * 64) * LDA;
    const bf16* b_s = sB[stage] + wn * 32;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t af[4][4], bfr[2][4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
        ldmatrix_x4(af[mi], a_s + (mi * 16 + (lane & 15)) * LDA + kk * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int nj = 0; nj < 2; ++nj)
        ldmatrix_x4_trans(bfr[nj], b_s + (kk * 16 + (lane & 15)) * LDB + nj * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
        for (int nj = 0; nj < 2; ++nj) {
          mma16816(acc[mi][2 * nj], af[mi], bfr[nj][0], bfr[nj][1]);
          mma16816(acc[mi][2 * nj + 1], af[mi], bfr[nj][2], bfr[nj][3]);
        }
      }
    }
    __syncthreads();                            // stage is free for the prefetch after next
  }

  // rows g and g + 8 of each m16 tile, columns 2*t4 and 2*t4 + 1 of each n8 tile
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = m0 + wm * 64 + mi * 16 + g + half * 8;
      if (row >= C) continue;
      bf16* orow = oe + (size_t)row * f;
#pragma unroll
      for (int nj = 0; nj < 4; ++nj) {
        const int col = n0 + wn * 32 + nj * 8 + t4 * 2;
        const float lo = acc[mi][nj][2 * half], hi = acc[mi][nj][2 * half + 1];
        if (VEC) {                              // f even: col < f covers both
          if (col < f) *reinterpret_cast<uint32_t*>(orow + col) = pack_bf16(lo, hi);
        } else {
          if (col < f) orow[col] = __float2bfloat16(lo);
          if (col + 1 < f) orow[col + 1] = __float2bfloat16(hi);
        }
      }
    }
  }
}

// fp32: the same (128 x 128) block tile and d loop, fp32 FMA. Thread (tx, ty)
// owns rows ty + 16 i and columns tx + 16 j (i, j < 8), so that the shared
// reads of a warp are broadcasts (x) and consecutive words (w). The x tile is
// stored transposed, one padding word per row.
__global__ void __launch_bounds__(THREADS)
gmm_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
               float* __restrict__ out, int C, int d, int f) {
  __shared__ float sA[FK][BM + 1];
  __shared__ float sB[FK][BN];

  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM, e = blockIdx.z;
  const float* xe = x + (size_t)e * C * d;
  const float* we = w + (size_t)e * d * f;
  float* oe = out + (size_t)e * C * f;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < d; k0 += FK) {
#pragma unroll
    for (int i = 0; i < BM * FK / THREADS; ++i) {
      int c = threadIdx.x + i * THREADS;
      int r = c / FK, k = c % FK;
      int gr = m0 + r, gk = k0 + k;
      sA[k][r] = (gr < C && gk < d) ? xe[(size_t)gr * d + gk] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < FK * BN / THREADS; ++i) {
      int c = threadIdx.x + i * THREADS;
      int k = c / BN, n = c % BN;
      int gk = k0 + k, gn = n0 + n;
      sB[k][n] = (gk < d && gn < f) ? we[(size_t)gk * f + gn] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < FK; ++kk) {
      float a[8], b[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = sA[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 8; ++j) b[j] = sB[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = m0 + ty + 16 * i;
    if (row >= C) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = n0 + tx + 16 * j;
      if (col < f) oe[(size_t)row * f + col] = acc[i][j];
    }
  }
}

}  // namespace

extern "C" {

// Shared memory of one block: dtype 0 (bf16) or 1 (fp32); 0 for another.
int moe_gmm_smem_bytes(int dtype) {
  if (dtype == 0) return BF16_SMEM;
  if (dtype == 1) return F32_SMEM;
  return 0;
}

// x (E,C,d), w (E,d,f), out (E,C,f): contiguous, all of one dtype, 0 = bf16,
// 1 = fp32. Returns a cudaError_t value: 0 when the launch was accepted.
int moe_gmm_fwd(const void* x, const void* w, void* out, int E, int C, int d,
                int f, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (E < 1 || C < 1 || d < 1 || f < 1) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid((f + BN - 1) / BN, (C + BM - 1) / BM, E);
  if (dtype == 0) {
    const bool vec = d % 8 == 0 && f % 8 == 0 &&
                     (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w)) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(out) % 4 == 0;
    const bf16* xb = static_cast<const bf16*>(x);
    const bf16* wb = static_cast<const bf16*>(w);
    bf16* ob = static_cast<bf16*>(out);
    if (vec)
      gmm_bf16_kernel<true><<<grid, THREADS, 0, s>>>(xb, wb, ob, C, d, f);
    else
      gmm_bf16_kernel<false><<<grid, THREADS, 0, s>>>(xb, wb, ob, C, d, f);
  } else if (dtype == 1) {
    gmm_f32_kernel<<<grid, THREADS, 0, s>>>(static_cast<const float*>(x),
                                            static_cast<const float*>(w),
                                            static_cast<float*>(out), C, d, f);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

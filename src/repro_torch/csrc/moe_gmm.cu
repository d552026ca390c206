// Grouped (per-expert) GEMM for Hopper (sm_90a): (E,C,d) @ (E,d,f) -> (E,C,f).
//
// Replaces the TPU kernel repro/kernels/moe_gmm.py::gmm_pallas (moe_gmm.py:47,
// body _gmm_kernel :26): a bank of E independent matrix products over the MoE
// capacity buffer that models/moe.py gathers, x (E, C, d) row-major with d
// contiguous and w (E, d, f) with f contiguous. The sum over d is kept in fp32
// and the output is rounded once to x's dtype. The Pallas kernel pads C, d and
// f to its blocks on the host and slices the result back (moe_gmm.py:56-66,
// :87); here the ragged edges are zero-filled by the loads and the stores are
// guarded, so no padded copy is made.
//
// Bound on the H100. Work: 2*E*C*d*f FLOPs at the 989 TFLOP/s bf16 tensor-core
// peak, against the bytes of x, w and the output read or written once at
// 3.35 TB/s. At deepseek-moe-16b's shapes (E=64 experts, d=2048, f=1408):
//   prefill, B=4 x 2048 tokens, capacity C=968, gate/up (and down, d and f
//   swapped): 3.57e11 FLOPs = 0.361 ms against 0.80 GB = 0.238 ms: bound by
//   operations;
//   decode, 4 tokens, C=8 (the capacity floor): 369 MB of expert weights
//   = 0.110 ms against 3.0e9 FLOPs: bound by bytes.
//
// Three paths, chosen in Python (kernels/moe_gmm.py::gmm_variant; the
// backward's by gmm_bwd_variant):
// * "wgmma", bf16 with d and f multiples of 8 (every model shape): TMA and
//   wgmma, built from hopper.cuh.
//   - A persistent grid (as many blocks as fit the card at once) walks the
//     (expert, C-tile, f-tile) tiles, f fastest. A tile never crosses an
//     expert: x and w are 3-D tensor maps, and TMA zero-fills rows past C
//     (968 is ragged) and columns past d and f.
//   - One producer thread fills a ring of stages, each 64 deep in d: the x
//     tile (64 d wide, one box) and the w tile (64-column boxes), 128-byte
//     swizzled, each stage completed on an mbarrier by its bytes.
//   - Consumer warpgroups of 64 rows each issue wgmma m64nNk16, x K-major
//     and w MN-major through the transpose bit, so no transposed copy of the
//     369 MB of expert weights is made. One group stays in flight; a stage
//     goes back to the producer by one mbarrier arrival per consumer warp
//     once the group that read it has completed.
//   - The fp32 sum stays in registers and is rounded once to bf16 into a
//     shared-memory output tile, which one thread stores by TMA (clipped at
//     the ragged edges) while the consumers start the next tile and the
//     producer loads it.
//   - Tile per shape. C > 64 (prefill): 128 x 256 tiles (two consumer
//     warpgroups of 64 x 256, 128 accumulators a thread), 3 stages of 48 KB
//     beside the 64 KB output tile,
//     and two blocks to a cluster on neighbouring C-tiles of one expert and
//     f-tile: each loads half of the shared w tile by TMA multicast into
//     both, and a stage is free once the consumers of both blocks have read
//     it. Alone, one block's tile reads 1.5 MB from L2 for 134 MFLOP, which
//     at the kernel's rate is several TB/s of L2 reads; the multicast takes
//     the w half of that down by half, and ran markedly faster than the
//     same tiles without it.
//     C <= 64 (decode, C=8): 64 x 64 tiles (one consumer warpgroup), 8
//     stages of 16 KB, no cluster. Decode is bound by the weight bytes, so
//     the padding rows cost only tensor-core cycles that the bytes leave idle
//     (8x the work is 2.4e10 FLOPs = 0.024 ms at peak against 0.110 ms of
//     weights), and TMA fills them with zeros without reading memory; the
//     64-wide f tile gives 1 408 tiles, 10.7 a block, so the last wave is
//     nearly full. Swapping the operands (f as wgmma's M, C=8 as its N) would
//     read the same bytes through another operand layout, so it was not
//     taken.
//   - The three tensor maps (x, w, out) are encoded inside the C entry
//     point, once per call (moe_gmm_encode_ns measures it).
//   - Measured (chip_smoke.py, H100 80GB HBM3 at 700 W): 0.602 ms at the
//     prefill gate/up shape (1.67x the bound, 1.20x torch.bmm's 0.501 ms;
//     0.710 with the epilogue's stores from registers), 0.159 ms at decode
//     (1.43x the bound, 1.14x torch.bmm's 0.140 ms); 168 registers (62 at
//     decode), no spills, no serialization. What still holds prefill back:
//     each consumer warpgroup reads the whole 64 x 256 w tile from shared
//     memory at every step, so with TMA's writes a stage costs about as many
//     shared-memory bytes per cycle as the card moves.
//   - The backward (training) runs on the same kernel, instantiated for the
//     operands' majorness, so that no operand is copied transposed: dx = dy
//     w^T reads dy as the forward reads x and w (E, d, f) as a K-major B (f
//     is the contraction and the contiguous axis: wgmma's plain B); dw =
//     x^T dy reads x (E, C, d) as an MN-major A through wgmma's transpose
//     bit and dy (E, C, f) as an MN-major B, the sum over C zero-filled by
//     TMA past its ragged end (488 at the training capacity). Two launches,
//     dx then dw, on the prefill configuration (dx on decode's where C <=
//     64). Before it the backward copied w^T (369 MB) and x^T (128 MB) and
//     ran the forward twice: 2.90 ms at deepseek-moe-16b's training
//     gate/up shape on an H100 80GB HBM3 at 700 W, 1.82 of it the copies
//     (chip_smoke.py phase gmm_bwd, torch.profiler). dw's tiles are only 8
//     steps deep (C = 488), so each tile's fill and epilogue weigh four
//     times as much as in the forward: the epilogue through shared memory
//     and a TMA store, overlapped with the next tile, took the backward
//     from 0.95-1.00 ms to 0.68-0.70 (torch.bmm's backward 0.68-0.71 in
//     the same run).
// * "mma", other bf16 shapes (d or f not a multiple of 8, which TMA cannot
//   address): one block per (f-tile 128, C-tile 128, expert), eight warps of
//   mma.sync m16n8k16 fed by ldmatrix from two cp.async stages 32 deep;
//   element-wise loads where 16-byte ones would be unaligned.
// * "fma", fp32: the same block tiling in fp32 FMA, never TF32, so that it
//   keeps fp32 accuracy.
//
// Plain C interface for ctypes: every pointer and the stream are void*; a
// launch returns cudaGetLastError() so the caller can raise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <chrono>

#include "hopper.cuh"

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

// ---- bf16 through TMA and wgmma --------------------------------------------

namespace wg {

constexpr int BKD = hopper::BOX;     // d depth of one stage: one box
constexpr int B_BOX_BYTES = BKD * hopper::BOX_ROW_BYTES;   // 64 d-rows x 64 f

// WGS consumer warpgroups of 64 rows each (a C tile of 64 * WGS rows), an f
// tile of BN columns in 64-column boxes, a ring of STAGES stages; CL blocks
// to a cluster.
template <int WGS, int BN, int STAGES, int CL>
struct Layout {
  static constexpr int BM = 64 * WGS;
  static constexpr int A_BYTES = BM * hopper::BOX_ROW_BYTES;   // BM rows of 64 d
  static constexpr int B_BOXES = BN / hopper::BOX;
  static constexpr int B_BYTES = B_BOXES * B_BOX_BYTES;
  static constexpr int STAGE = A_BYTES + B_BYTES;
  static constexpr int OUT_BYTES = BM * BN * 2;                  // the bf16 output tile
  static constexpr int BARRIERS = 2 * STAGES * 8;
  static constexpr int BYTES = STAGES * STAGE + OUT_BYTES + BARRIERS + 1024;   // + alignment slack
  static constexpr int THREADS = 128 * (WGS + 1);
  static_assert(B_BOXES % CL == 0, "each block of a cluster loads its share of w");
};

// Persistent: cluster c takes tile groups c, c + clusters, ... of the
// (expert, M-tile group, N-tile) order, N fastest, so clusters that run
// together share A tiles and one expert's B in L2. Block r of a cluster
// computes M-tile CL * group + r; the CL blocks share the B tile, and each
// loads 1/CL of it by TMA multicast into every block of the cluster, which
// divides the B traffic from L2 by CL. A stage is therefore free only once
// the consumers of every block of the cluster have read it: each consumer
// warp arrives on the empty barrier of every block.
// The last warpgroup's first thread is the producer; the others multiply.
// The ring runs on across tiles, so the producer loads the next tile while
// the consumers store this one.
// out (E, M, N) = A (E, M, K) B (E, K, N), each operand read as stored:
//   TA 0: A K-major (K contiguous), one box of 64 K x BM rows a stage;
//   TA 1: A MN-major (M contiguous), WGS boxes of 64 M x 64 K rows;
//   TB 1: B MN-major (N contiguous), BN / 64 boxes of 64 N x 64 K rows;
//   TB 0: B K-major (K contiguous), one box of 64 K x BN / CL rows a block.
// The forward is (TA, TB) = (0, 1): x (E, C, d), w (E, d, f). The backward's
// dx = dy w^T is (0, 0): w (E, d, f) is B K-major as stored, f the
// contraction; dw = x^T dy is (1, 1): x (E, C, d) is A MN-major and dy
// (E, C, f) B MN-major, C the contraction.
template <int WGS, int BN, int STAGES, int CL, int TA, int TB>
__global__ void __launch_bounds__(Layout<WGS, BN, STAGES, CL>::THREADS, 1)
gmm_wgmma_kernel(__grid_constant__ const CUtensorMap amap,
                 __grid_constant__ const CUtensorMap bmap,
                 __grid_constant__ const CUtensorMap omap, int E, int M, int N, int k_steps) {
  using L = Layout<WGS, BN, STAGES, CL>;
  constexpr int A_BOX_BYTES = 64 * hopper::BOX_ROW_BYTES;   // TA 1: 64 K rows of 64 M
  constexpr int B_ROWS = BN / CL;                           // TB 0: N rows a block loads
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* out_tile = base + STAGES * L::STAGE;   // 64-column boxes of BM rows
  uint64_t* full = reinterpret_cast<uint64_t*>(out_tile + L::OUT_BYTES);
  uint64_t* empty = full + STAGES;
  const int n_f = (N + BN - 1) / BN, n_c = (M + L::BM - 1) / L::BM;
  const int n_g = (n_c + CL - 1) / CL;            // M-tile groups, one per cluster
  const int groups = E * n_g * n_f;
  const int rank = CL > 1 ? (int)hopper::cluster_ctarank() : 0;
  const int cluster = blockIdx.x / CL, clusters = gridDim.x / CL;
  const int wgi = hopper::warpgroup_index();

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);             // the producer's expect_tx
      hopper::mbar_init(&empty[s], 4 * WGS * CL); // each consumer warp of the cluster
    }
    hopper::mbar_fence_init();
  }
  if constexpr (CL > 1) hopper::cluster_sync(); else __syncthreads();

  if (wgi == WGS) {                               // producer warpgroup
    if constexpr (WGS == 2) hopper::setmaxnreg_dec<40>();
    if (threadIdx.x == WGS * 128) {
      hopper::tma_prefetch_map(&amap);
      hopper::tma_prefetch_map(&bmap);
      const uint16_t mask = (uint16_t)((1u << CL) - 1);
      int it = 0;
      for (int grp = cluster; grp < groups; grp += clusters) {
        const int ft = grp % n_f, ct = (grp / n_f) % n_g * CL + rank, e = grp / (n_f * n_g);
        for (int k = 0; k < k_steps; ++k, ++it) {
          const int s = it % STAGES;
          hopper::mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
          unsigned char* st = base + s * L::STAGE;
          hopper::mbar_expect_tx(&full[s], L::STAGE);   // all of B lands here, 1/CL from each block
          if constexpr (TA == 0) {
            hopper::tma_load_3d(st, &amap, &full[s], k * BKD, ct * L::BM, e);
          } else {
#pragma unroll
            for (int b = 0; b < WGS; ++b)
              hopper::tma_load_3d(st + b * A_BOX_BYTES, &amap, &full[s],
                                  ct * L::BM + b * hopper::BOX, k * BKD, e);
          }
          if constexpr (TB == 1) {
#pragma unroll
            for (int i = 0; i < L::B_BOXES / CL; ++i) {
              const int nb = rank * (L::B_BOXES / CL) + i;
              unsigned char* dst = st + L::A_BYTES + nb * B_BOX_BYTES;
              const int col = ft * BN + nb * hopper::BOX;
              if constexpr (CL > 1)
                hopper::tma_load_3d_multicast(dst, &bmap, &full[s], col, k * BKD, e, mask);
              else
                hopper::tma_load_3d(dst, &bmap, &full[s], col, k * BKD, e);
            }
          } else {
            unsigned char* dst = st + L::A_BYTES + rank * B_ROWS * hopper::BOX_ROW_BYTES;
            const int row = ft * BN + rank * B_ROWS;
            if constexpr (CL > 1)
              hopper::tma_load_3d_multicast(dst, &bmap, &full[s], k * BKD, row, e, mask);
            else
              hopper::tma_load_3d(dst, &bmap, &full[s], k * BKD, row, e);
          }
        }
      }
    }
  } else {
    // consumer warpgroup wgi: rows wgi * 64 .. + 63 of each M tile
    if constexpr (WGS == 2) hopper::setmaxnreg_inc<232>();
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    auto release = [&](int s) {                   // stage s is read: free it cluster-wide
      if (lane != 0) return;
      if constexpr (CL > 1) {
#pragma unroll
        for (int r = 0; r < CL; ++r) hopper::mbar_arrive_cluster(&empty[s], r);
      } else {
        hopper::mbar_arrive(&empty[s]);
      }
    };
    float acc[BN / 2];
    int it = 0;
    for (int grp = cluster; grp < groups; grp += clusters) {
      const int ft = grp % n_f, ct = (grp / n_f) % n_g * CL + rank, e = grp / (n_f * n_g);
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
      for (int k = 0; k < k_steps; ++k, ++it) {
        const int s = it % STAGES;
        hopper::mbar_wait(&full[s], (it / STAGES) & 1);
        const unsigned char* a = base + s * L::STAGE;
        const unsigned char* b = base + s * L::STAGE + L::A_BYTES;
        hopper::fence_regs(acc);
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BKD / 16; ++kk) {
          const uint64_t da =
              TA == 0 ? hopper::desc_kmajor(a + wgi * 64 * hopper::BOX_ROW_BYTES + 32 * kk)
                      : hopper::desc_mnmajor(a + wgi * A_BOX_BYTES + 2048 * kk, A_BOX_BYTES);
          const uint64_t db = TB == 1 ? hopper::desc_mnmajor(b + 2048 * kk, B_BOX_BYTES)
                                      : hopper::desc_kmajor(b + 32 * kk);
          hopper::wgmma_ss<TA, TB>(acc, da, db, 1);
        }
        hopper::wgmma_commit();
        hopper::wgmma_wait<1>();                  // the previous stage is read
        hopper::fence_regs(acc);
        if (k > 0) release((it - 1) % STAGES);
      }
      hopper::wgmma_wait<0>();
      hopper::fence_regs(acc);
      release((it - 1) % STAGES);

      // The tile leaves through shared memory: rounded to bf16 into the
      // output tile (128-byte-swizzled boxes of 64 columns, as TMA stores
      // them; rows g and g + 8 of this warp's 16, columns 8j + 2t and + 1),
      // then one thread stores it by TMA and the consumers go on to the
      // next tile while it drains. TMA clips rows and columns past M and N
      // (an M-tile past the end, n_c not a multiple of CL, stores nothing).
      if (threadIdx.x == 0) hopper::bulk_wait_read<0>();   // the last tile's store has read it
      hopper::named_sync(1, 128 * WGS);
      const int r = wgi * 64 + warp * 16 + lane / 4, t2 = (lane % 4) * 4;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        unsigned char* row = out_tile + (j / 8) * L::BM * hopper::BOX_ROW_BYTES +
                             r * hopper::BOX_ROW_BYTES + (((j % 8) ^ (r % 8)) * 16) + t2;
        *reinterpret_cast<uint32_t*>(row) = pack_bf16(acc[4 * j], acc[4 * j + 1]);
        *reinterpret_cast<uint32_t*>(row + 8 * hopper::BOX_ROW_BYTES) =
            pack_bf16(acc[4 * j + 2], acc[4 * j + 3]);
      }
      hopper::fence_proxy_async();
      hopper::named_sync(1, 128 * WGS);
      if (threadIdx.x == 0) {
#pragma unroll
        for (int b = 0; b < BN / hopper::BOX; ++b)
          hopper::tma_store_3d(&omap, out_tile + b * L::BM * hopper::BOX_ROW_BYTES,
                               ft * BN + b * hopper::BOX, ct * L::BM, e);
        hopper::bulk_commit();
      }
    }
    if (threadIdx.x == 0) hopper::bulk_wait<0>();   // every store is done
  }
  // no block leaves while a peer may still multicast into it or arrive on
  // its barriers
  if constexpr (CL > 1) hopper::cluster_sync();
}

// A contiguous bf16 (E, rows, cols) tensor as a 3-D map, dims innermost
// first, read in boxes of 64 columns x box_rows rows of one expert;
// zero-filled past rows and cols, and never past an expert.
inline bool encode_3d(CUtensorMap* map, const void* p, int E, int rows, int cols,
                      int box_rows) {
  const uint64_t dims[3] = {(uint64_t)cols, (uint64_t)rows, (uint64_t)E};
  const uint64_t strides[2] = {(uint64_t)cols * 2, (uint64_t)rows * cols * 2};
  const uint32_t box[3] = {(uint32_t)hopper::BOX, (uint32_t)box_rows, 1};
  return hopper::encode_bf16_map(map, p, 3, dims, strides, box);
}

// The forward's maps: x (E, C, d) in (64 d x bm rows) boxes, w (E, d, f) in
// (64 f x 64 d) boxes.
inline bool encode_maps(CUtensorMap* xm, CUtensorMap* wm, const void* x,
                        const void* w, int E, int C, int d, int f, int bm) {
  return encode_3d(xm, x, E, C, d, bm) && encode_3d(wm, w, E, d, f, BKD);
}

// out (E, M, N) = A B over K, from the two maps the (TA, TB) layout reads.
template <int WGS, int BN, int STAGES, int CL, int TA, int TB>
int launch(const CUtensorMap& am, const CUtensorMap& bm, void* out, int E, int M, int N,
           int K, cudaStream_t stream) {
  using L = Layout<WGS, BN, STAGES, CL>;
  auto kernel = gmm_wgmma_kernel<WGS, BN, STAGES, CL, TA, TB>;
  CUtensorMap om;                                 // out in (64 N x BM rows) boxes
  if (!encode_3d(&om, out, E, M, N, L::BM)) return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.blockDim = dim3(L::THREADS);
  cfg.dynamicSmemBytes = L::BYTES;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // once per configuration: the shared-memory opt-in and how many clusters
  // fit on the card at once (the persistent grid)
  static int max_clusters = 0;
  if (!max_clusters) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
    if (err != cudaSuccess) return static_cast<int>(err);
    cfg.gridDim = dim3(CL * (hopper::sm_count() / CL));
    err = cudaOccupancyMaxActiveClusters(&max_clusters, kernel, &cfg);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (max_clusters < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  const int n_g = ((M + L::BM - 1) / L::BM + CL - 1) / CL;
  const long groups = (long)E * n_g * ((N + BN - 1) / BN);
  cfg.gridDim = dim3(CL * (int)(groups < max_clusters ? groups : max_clusters));
  cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, am, bm, om, E, M, N, (K + BKD - 1) / BKD);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The two configurations the C entry point chooses between: C > 64 (prefill)
// takes 128 x 256 tiles from 3 stages of 48 KB (and the 64 KB output tile),
// two blocks to a cluster sharing each w tile; C <= 64 (decode) 64 x 64
// tiles from 8 stages of 16 KB.
constexpr int PREFILL_WGS = 2, PREFILL_BN = 256, PREFILL_STAGES = 3, PREFILL_CL = 2;
constexpr int DECODE_WGS = 1, DECODE_BN = 64, DECODE_STAGES = 8, DECODE_CL = 1;
using Prefill = Layout<PREFILL_WGS, PREFILL_BN, PREFILL_STAGES, PREFILL_CL>;
using Decode = Layout<DECODE_WGS, DECODE_BN, DECODE_STAGES, DECODE_CL>;

}  // namespace wg

}  // namespace

extern "C" {

// Shared memory of one block of the mma (dtype 0, bf16) or fma (dtype 1,
// fp32) path; 0 for another.
int moe_gmm_smem_bytes(int dtype) {
  if (dtype == 0) return BF16_SMEM;
  if (dtype == 1) return F32_SMEM;
  return 0;
}

// The mma (dtype 0, bf16) and fma (dtype 1, fp32) paths: x (E,C,d), w (E,d,f),
// out (E,C,f), contiguous, all of one dtype. Returns a cudaError_t value: 0 when the launch was accepted.
int moe_gmm_fwd(const void* x, const void* w, void* out, int E, int C, int d,
                int f, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (E < 1 || C < 1 || d < 1 || f < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (cudaError_t err = hopper::bind_thread_device(x)) return static_cast<int>(err);
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

// The TMA + wgmma path: bf16 x (E,C,d), w (E,d,f), out (E,C,f), contiguous,
// d and f multiples of 8, x, w and out 16-byte aligned (what TMA can
// address).
// A 64-row C tile (one consumer warpgroup) where C <= 64, else 128 rows.
// Returns a cudaError_t value: 0 when the launch was accepted.
int moe_gmm_wgmma_fwd(const void* x, const void* w, void* out, int E, int C,
                      int d, int f, void* stream) {
  if (E < 1 || C < 1 || d < 1 || f < 1 || d % 8 || f % 8 ||
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w)) % 16 ||
      reinterpret_cast<uintptr_t>(out) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  if (cudaError_t err = hopper::bind_thread_device(x)) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  CUtensorMap xm, wm;
  if (!wg::encode_maps(&xm, &wm, x, w, E, C, d, f, C <= 64 ? 64 : 128))
    return static_cast<int>(cudaErrorInvalidValue);
  if (C <= 64)
    return wg::launch<wg::DECODE_WGS, wg::DECODE_BN, wg::DECODE_STAGES, wg::DECODE_CL, 0, 1>(
        xm, wm, out, E, C, f, d, s);
  return wg::launch<wg::PREFILL_WGS, wg::PREFILL_BN, wg::PREFILL_STAGES, wg::PREFILL_CL, 0, 1>(
      xm, wm, out, E, C, f, d, s);
}

// The backward of out = x w on the same kernel, each operand read as stored
// (no transposed copy): dx (E,C,d) = dy w^T over f, then dw (E,d,f) = x^T dy
// over C. bf16, contiguous, d and f multiples of 8, every pointer 16-byte
// aligned. dx takes the forward's tile by C (64 rows where C <= 64, else
// 128); dw's rows are d, always the 128-row tile. Returns a cudaError_t
// value: 0 when both launches were accepted.
int moe_gmm_wgmma_bwd(const void* x, const void* w, const void* dy, void* dx, void* dw,
                      int E, int C, int d, int f, void* stream) {
  if (E < 1 || C < 1 || d < 1 || f < 1 || d % 8 || f % 8 ||
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w) |
       reinterpret_cast<uintptr_t>(dy) | reinterpret_cast<uintptr_t>(dx) |
       reinterpret_cast<uintptr_t>(dw)) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  if (cudaError_t err = hopper::bind_thread_device(x)) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using namespace wg;
  CUtensorMap am, bm;
  int err;
  if (C <= 64) {
    if (!encode_3d(&am, dy, E, C, f, 64) || !encode_3d(&bm, w, E, d, f, DECODE_BN / DECODE_CL))
      return static_cast<int>(cudaErrorInvalidValue);
    err = launch<DECODE_WGS, DECODE_BN, DECODE_STAGES, DECODE_CL, 0, 0>(am, bm, dx, E, C, d,
                                                                        f, s);
  } else {
    if (!encode_3d(&am, dy, E, C, f, 128) ||
        !encode_3d(&bm, w, E, d, f, PREFILL_BN / PREFILL_CL))
      return static_cast<int>(cudaErrorInvalidValue);
    err = launch<PREFILL_WGS, PREFILL_BN, PREFILL_STAGES, PREFILL_CL, 0, 0>(am, bm, dx, E, C,
                                                                            d, f, s);
  }
  if (err) return err;
  if (!encode_3d(&am, x, E, C, d, BKD) || !encode_3d(&bm, dy, E, C, f, BKD))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch<PREFILL_WGS, PREFILL_BN, PREFILL_STAGES, PREFILL_CL, 1, 1>(am, bm, dw, E, d,
                                                                           f, C, s);
}

// Dynamic shared memory of the wgmma path with `wgs` consumer warpgroups
// (a C tile of 64 * wgs rows); 0 for another count.
int moe_gmm_wgmma_smem_bytes(int wgs) {
  if (wgs == 1) return wg::Decode::BYTES;
  if (wgs == 2) return wg::Prefill::BYTES;
  return 0;
}

// Host nanoseconds per call to encode the three tensor maps of one wgmma
// launch (x, w and the output, here laid over x's base), averaged over
// `iters` encodings; -1 if the encoder refuses them.
double moe_gmm_encode_ns(const void* x, const void* w, int E, int C, int d,
                         int f, int iters) {
  CUtensorMap xm, wm, om;
  const int bm = C <= 64 ? 64 : 128;
  if (!wg::encode_maps(&xm, &wm, x, w, E, C, d, f, bm) || !wg::encode_3d(&om, x, E, C, f, bm))
    return -1;
  auto t0 = std::chrono::steady_clock::now();
  for (int i = 0; i < iters; ++i) {
    wg::encode_maps(&xm, &wm, x, w, E, C, d, f, bm);
    wg::encode_3d(&om, x, E, C, f, bm);
  }
  auto t1 = std::chrono::steady_clock::now();
  return std::chrono::duration<double, std::nano>(t1 - t0).count() / iters;
}

}  // extern "C"

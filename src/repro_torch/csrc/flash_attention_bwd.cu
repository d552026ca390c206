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
//
// The LSE's domain. The forward runs its online softmax in base 2 on
// y2 = log2(e) * y, with y = x (or c tanh(x / c) under a softcap) and
// x = scale * q.k; it stores LSE2 = m + log2(l) of y2, where m is the row's
// running max and l its sum of 2^(y2 - m). So P = 2^(y2 - LSE2) here, with
// y2 computed by the forward's own instructions (ex2.approx, rcp.approx),
// and one exp2 a score. A row with no key to attend to has LSE2 = -inf; its
// P, and so every gradient it adds, is 0 (never inf - inf = NaN).
//
// Three kernels, deterministic: every output element is summed in a fixed
// order by one thread, with no atomics, so a backward run twice is bitwise
// equal (the data pipeline's restart contract, "resumes bit-identically",
// can then be checked on the card):
//   1. delta:  Delta = rowsum(dO o O) in fp32, one warp per (b, q, h) row;
//   2. dkdv:   one block per (64-key tile, kv head, batch). K and V stay in
//              shared memory; the block loops over the group's query heads
//              and the 32-row q tiles that can see the tile (2 cp.async
//              stages of Q, dO, LSE and Delta). Each warp owns 16 keys and
//              computes S^T = K Q^T and dP^T = V dO^T, P^T = 2^(y2 - LSE2),
//              dS^T = P^T o (dP^T - Delta) (times 1 - tanh^2 under a
//              softcap), then dV += P^T dO and dK += dS^T Q from registers
//              (the accumulator layout of two n8 blocks is the A fragment of
//              one k16 slice). The GQA sum over the group is this loop: no
//              host reduction;
//   3. dq:     one block per (64-row q tile, head, batch), longest causal
//              rows first; Q and dO stay in shared memory, K/V tiles of 64
//              rows stream through 2 cp.async stages; each warp owns 16 q
//              rows and recomputes S and dP, then dQ += dS K.
// dK and dQ are scaled by `scale` once, at the store. Products are
// mma.sync m16n8k16 (bf16 in, fp32 accumulate) from ldmatrix; P and dS are
// rounded to bf16 for their products, as the forward rounds P. Shared rows
// are padded by 8 elements, so the ldmatrix rows fall in distinct banks.
// Head dims 64, 112 and 128; 112 runs at 128, the pad columns loaded as
// zeros (cp.async's zero fill) and never stored.
//
// Bound on the H100. Five products over the attended (q, k) pairs: S, dP,
// dV, dK and dQ, 10 B H D FLOPs a pair, at the 989 TFLOP/s bf16 peak: at
// deepseek-7b's training shape (B=2, S=2048, H=KVH=32, D=128, causal) 1.72e11
// FLOPs = 0.174 ms, against 2 x 2 x 4 x 33.5 MB of bf16 moved = 0.040 ms:
// bound by operations. This design recomputes S and dP in kernel 3, seven
// products instead of five, so that nothing is summed across blocks; it is
// right and simple first (mma.sync from cp.async). wgmma fed by TMA is the
// later speed work (ROADMAP.md B).
//
// Plain C interface for ctypes: every pointer and the stream are void*; the
// launch returns cudaGetLastError() so the caller can raise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr float LOG2E = 1.4426950408889634f;
constexpr int THREADS = 128;   // 4 warps of 16 rows each
constexpr int BKV = 64;        // dkdv: keys of one block
constexpr int BQA = 32;        // dkdv: q rows of one step
constexpr int BQB = 64;        // dq: q rows of one block
constexpr int BKB = 64;        // dq: keys of one step
constexpr int PAD = 8;         // bf16 elements of padding a shared row
constexpr int DELTA_WARPS = 8;

template <int D>
struct Dims {
  static constexpr int DP = D <= 64 ? 64 : 128;   // the width the products run at
  static constexpr int LD = DP + PAD;             // shared row stride, elements
  static constexpr int CH = DP / 8;               // 16-byte chunks of a row
  static constexpr int DKDV_BYTES = (2 * BKV + 4 * BQA) * LD * 2 + 4 * BQA * 4;
  static constexpr int DQ_BYTES = (2 * BQB + 4 * BKB) * LD * 2;
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  int n = pred ? 16 : 0;        // 0 source bytes: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, bool pred) {
  uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  int n = pred ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
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

  // P of one score (0 where masked or where the row attends to nothing)
  __device__ __forceinline__ float p(float s, float lse, int qp, int kp, float& dy) const {
    const float y = y2(s, dy);
    return visible(qp, kp) && lse != -INFINITY ? fast_exp2(y - lse) : 0.f;
  }
};

// Rows [r0, r0 + ROWS) of one head of a (B, S, heads, D) bf16 tensor into
// shared rows of LD elements; rows at or past n_rows and columns past D are
// zero-filled. `base` points at (b, 0, head, 0); `stride` = heads * D.
template <int D, int ROWS>
__device__ __forceinline__ void load_rows(bf16* smem, const bf16* base, size_t stride,
                                          int r0, int n_rows) {
  using Dm = Dims<D>;
  constexpr int CHUNKS = ROWS * Dm::CH;
  static_assert(CHUNKS % THREADS == 0, "a tile's chunks divide among the threads");
#pragma unroll
  for (int i = 0; i < CHUNKS / THREADS; ++i) {
    const int c = threadIdx.x + i * THREADS;
    const int r = c / Dm::CH, col = (c % Dm::CH) * 8;
    const bool ok = r0 + r < n_rows && col < D;
    const bf16* src = ok ? base + (size_t)(r0 + r) * stride + col : base;
    cp_async16(smem + r * Dm::LD + col, src, ok);
  }
}

// Entries [r0, r0 + N) of a float row vector; past n, zero.
template <int N>
__device__ __forceinline__ void load_vec(float* smem, const float* g, int r0, int n) {
  for (int i = threadIdx.x; i < N; i += THREADS) {
    const bool ok = r0 + i < n;
    cp_async4(smem + i, ok ? g + r0 + i : g, ok);
  }
}

// acc (16 rows x 8*NB columns) += A (16 x DP, rows of `a`) B^T, with B given
// as NB*8 rows of `b` (both in shared memory, row stride LD): S = Q K^T,
// S^T = K Q^T, dP = dO V^T and dP^T = V dO^T alike.
template <int DP, int LD, int NB>
__device__ __forceinline__ void product_nt(float (&acc)[NB][4], const bf16* a, const bf16* b,
                                           int lane) {
#pragma unroll
  for (int n = 0; n < NB; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    uint32_t af[4];
    ldmatrix_x4(af, a + (lane & 15) * LD + kk * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int j = 0; j < NB / 2; ++j) {
      uint32_t bf[4];
      ldmatrix_x4(bf, b + (j * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD + kk * 16 +
                          ((lane >> 3) & 1) * 8);
      mma16816(acc[2 * j], af, bf[0], bf[1]);
      mma16816(acc[2 * j + 1], af, bf[2], bf[3]);
    }
  }
}

// acc (16 rows x DP) += X (16 x 8*NB, in registers, the accumulator layout
// of a product_nt) B, with B given as 8*NB rows of DP in shared memory: dV
// += P^T dO, dK += dS^T Q and dQ += dS K alike.
template <int DP, int LD, int NB>
__device__ __forceinline__ void product_rn(float (&acc)[DP / 8][4], const float (&x)[NB][4],
                                           const bf16* b, int lane) {
#pragma unroll
  for (int ks = 0; ks < NB / 2; ++ks) {
    const uint32_t af[4] = {pack_bf16(x[2 * ks][0], x[2 * ks][1]),
                            pack_bf16(x[2 * ks][2], x[2 * ks][3]),
                            pack_bf16(x[2 * ks + 1][0], x[2 * ks + 1][1]),
                            pack_bf16(x[2 * ks + 1][2], x[2 * ks + 1][3])};
#pragma unroll
    for (int nj = 0; nj < DP / 16; ++nj) {
      uint32_t bf[4];
      ldmatrix_x4_trans(bf, b + (ks * 16 + (lane & 15)) * LD + nj * 16 + (lane >> 4) * 8);
      mma16816(acc[2 * nj], af, bf[0], bf[1]);
      mma16816(acc[2 * nj + 1], af, bf[2], bf[3]);
    }
  }
}

// 16 rows x DP of fp32 accumulators (rows row0 and row0 + 8 of this thread)
// times `mul`, to bf16 rows of a (.., heads, D) tensor; rows at or past
// n_rows and columns past D are not stored.
template <int D, int DP>
__device__ __forceinline__ void store_rows(bf16* out, const float (&acc)[DP / 8][4], float mul,
                                           int row0, int n_rows, size_t row_stride, int t4) {
#pragma unroll
  for (int nb = 0; nb < DP / 8; ++nb) {
    const int col = nb * 8 + 2 * t4;
    if (col >= D) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = row0 + 8 * half;
      if (row < n_rows)
        *reinterpret_cast<uint32_t*>(out + (size_t)row * row_stride + col) =
            pack_bf16(acc[nb][2 * half] * mul, acc[nb][2 * half + 1] * mul);
    }
  }
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

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkdv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, const bf16* __restrict__ dout,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      bf16* __restrict__ dk, bf16* __restrict__ dv, int Sk, int H, int KVH,
                      Score sc) {
  using Dm = Dims<D>;
  constexpr int DP = Dm::DP, LD = Dm::LD, NB = BQA / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);
  bf16* sV = sK + BKV * LD;
  bf16* sQ = sV + BKV * LD;                   // [2][BQA][LD]
  bf16* sO = sQ + 2 * BQA * LD;               // dO: [2][BQA][LD]
  float* sL = reinterpret_cast<float*>(sO + 2 * BQA * LD);   // LSE: [2][BQA]
  float* sD = sL + 2 * BQA;                                   // Delta: [2][BQA]

  const int Sq = sc.Sq;
  const int k0 = blockIdx.x * BKV, kvh = blockIdx.y, b = blockIdx.z;
  const int G = H / KVH;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t4 = lane % 4;

  // the q rows [q_lo, q_hi) that can see a key of this tile
  int q_lo = 0, q_hi = Sq;
  if (sc.causal) q_lo = k0;
  if (sc.window) q_hi = min(q_hi, k0 + BKV - 1 + sc.window);
  if (k0 >= sc.kv_valid) q_hi = 0;
  const int qt_lo = q_lo / BQA;
  const int nqt = q_hi > q_lo ? (q_hi + BQA - 1) / BQA - qt_lo : 0;
  const int items = G * nqt;                  // (query head, q tile) pairs

  const size_t q_stride = (size_t)H * D, kv_stride = (size_t)KVH * D;
  float dk_acc[DP / 8][4], dv_acc[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;

  if (items > 0) {
    load_rows<D, BKV>(sK, k + (size_t)b * Sk * kv_stride + (size_t)kvh * D, kv_stride, k0, Sk);
    load_rows<D, BKV>(sV, v + (size_t)b * Sk * kv_stride + (size_t)kvh * D, kv_stride, k0, Sk);
    auto load_item = [&](int i, int st) {
      const int h = kvh * G + i / nqt, q0 = (qt_lo + i % nqt) * BQA;
      const size_t head = (size_t)b * Sq * q_stride + (size_t)h * D;
      load_rows<D, BQA>(sQ + st * BQA * LD, q + head, q_stride, q0, Sq);
      load_rows<D, BQA>(sO + st * BQA * LD, dout + head, q_stride, q0, Sq);
      const size_t vec = ((size_t)b * H + h) * Sq;
      load_vec<BQA>(sL + st * BQA, lse + vec, q0, Sq);
      load_vec<BQA>(sD + st * BQA, delta + vec, q0, Sq);
    };
    load_item(0, 0);
    cp_async_commit();
    const int kp0 = k0 + warp * 16 + g;       // this thread's keys: kp0 and kp0 + 8
    for (int i = 0; i < items; ++i) {
      const int st = i & 1;
      if (i + 1 < items) load_item(i + 1, st ^ 1);
      cp_async_commit();
      cp_async_wait<1>();                     // item i (and K, V) have landed
      __syncthreads();
      const int q0 = (qt_lo + i % nqt) * BQA;
      const bf16* Qs = sQ + st * BQA * LD;
      const bf16* Os = sO + st * BQA * LD;
      const float* Ls = sL + st * BQA;
      const float* Ds = sD + st * BQA;

      float p[NB][4], dp[NB][4], dy[NB][4];
      product_nt<DP, LD, NB>(p, sK + warp * 16 * LD, Qs, lane);     // S^T = K Q^T
#pragma unroll
      for (int n = 0; n < NB; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ql = n * 8 + 2 * t4 + (e & 1);
          p[n][e] = sc.p(p[n][e], Ls[ql], q0 + ql, kp0 + (e >= 2 ? 8 : 0), dy[n][e]);
        }
      product_rn<DP, LD, NB>(dv_acc, p, Os, lane);                  // dV += P^T dO
      product_nt<DP, LD, NB>(dp, sV + warp * 16 * LD, Os, lane);    // dP^T = V dO^T
#pragma unroll
      for (int n = 0; n < NB; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ql = n * 8 + 2 * t4 + (e & 1);
          dp[n][e] = p[n][e] * (dp[n][e] - Ds[ql]) * dy[n][e];      // dS^T
        }
      product_rn<DP, LD, NB>(dk_acc, dp, Qs, lane);                 // dK += dS^T Q
      __syncthreads();                        // the stage is free for item i + 2
    }
  }
  const size_t out = ((size_t)b * Sk * KVH + kvh) * D;
  store_rows<D, DP>(dk + out, dk_acc, sc.scale, k0 + warp * 16 + g, Sk, kv_stride, t4);
  store_rows<D, DP>(dv + out, dv_acc, 1.f, k0 + warp * 16 + g, Sk, kv_stride, t4);
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    bf16* __restrict__ dq, int Sk, int H, int KVH, Score sc) {
  using Dm = Dims<D>;
  constexpr int DP = Dm::DP, LD = Dm::LD, NB = BKB / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sO = sQ + BQB * LD;                   // dO
  bf16* sK = sO + BQB * LD;                   // [2][BKB][LD]
  bf16* sV = sK + 2 * BKB * LD;               // [2][BKB][LD]

  const int Sq = sc.Sq;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQB;   // longest causal rows first
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / (H / KVH);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t4 = lane % 4;

  // the key tiles [t_lo, t_hi) that hold a key some row of this block sees
  int kv_end = sc.kv_valid;
  if (sc.causal) kv_end = min(kv_end, q0 + BQB);
  const int kv_begin = sc.window ? max(0, q0 - sc.window + 1) : 0;
  const int t_lo = kv_begin / BKB;
  const int t_hi = kv_end > kv_begin ? (kv_end + BKB - 1) / BKB : t_lo;

  const size_t q_stride = (size_t)H * D, kv_stride = (size_t)KVH * D;
  const size_t head = (size_t)b * Sq * q_stride + (size_t)h * D;
  const bf16* kh = k + (size_t)b * Sk * kv_stride + (size_t)kvh * D;
  const bf16* vh = v + (size_t)b * Sk * kv_stride + (size_t)kvh * D;
  const int r0 = q0 + warp * 16 + g;          // this thread's rows: r0 and r0 + 8
  const size_t vec = ((size_t)b * H + h) * Sq;
  const float l[2] = {r0 < Sq ? lse[vec + r0] : 0.f, r0 + 8 < Sq ? lse[vec + r0 + 8] : 0.f};
  const float dl[2] = {r0 < Sq ? delta[vec + r0] : 0.f,
                       r0 + 8 < Sq ? delta[vec + r0 + 8] : 0.f};

  float dq_acc[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) dq_acc[n][0] = dq_acc[n][1] = dq_acc[n][2] = dq_acc[n][3] = 0.f;

  if (t_hi > t_lo) {
    load_rows<D, BQB>(sQ, q + head, q_stride, q0, Sq);
    load_rows<D, BQB>(sO, dout + head, q_stride, q0, Sq);
    load_rows<D, BKB>(sK, kh, kv_stride, t_lo * BKB, Sk);
    load_rows<D, BKB>(sV, vh, kv_stride, t_lo * BKB, Sk);
    cp_async_commit();
    for (int t = t_lo; t < t_hi; ++t) {
      const int st = (t - t_lo) & 1;
      if (t + 1 < t_hi) {
        load_rows<D, BKB>(sK + (st ^ 1) * BKB * LD, kh, kv_stride, (t + 1) * BKB, Sk);
        load_rows<D, BKB>(sV + (st ^ 1) * BKB * LD, vh, kv_stride, (t + 1) * BKB, Sk);
      }
      cp_async_commit();
      cp_async_wait<1>();                     // tile t (and Q, dO) have landed
      __syncthreads();
      const bf16* Ks = sK + st * BKB * LD;
      const bf16* Vs = sV + st * BKB * LD;

      float p[NB][4], dp[NB][4], dy[NB][4];
      product_nt<DP, LD, NB>(p, sQ + warp * 16 * LD, Ks, lane);     // S = Q K^T
#pragma unroll
      for (int n = 0; n < NB; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          p[n][e] = sc.p(p[n][e], l[e >> 1], r0 + (e >= 2 ? 8 : 0),
                         t * BKB + n * 8 + 2 * t4 + (e & 1), dy[n][e]);
      product_nt<DP, LD, NB>(dp, sO + warp * 16 * LD, Vs, lane);    // dP = dO V^T
#pragma unroll
      for (int n = 0; n < NB; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) dp[n][e] = p[n][e] * (dp[n][e] - dl[e >> 1]) * dy[n][e];
      product_rn<DP, LD, NB>(dq_acc, dp, Ks, lane);                 // dQ += dS K
      __syncthreads();                        // the stage is free for tile t + 2
    }
  }
  store_rows<D, DP>(dq + head, dq_acc, sc.scale, r0, Sq, q_stride, t4);
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* o, const void* dout,
           const void* lse, void* delta, void* dq, void* dk, void* dv, int B, int Sq, int Sk,
           int H, int KVH, const Score& sc, cudaStream_t stream) {
  using Dm = Dims<D>;
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<D>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           Dm::DKDV_BYTES);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(flash_bwd_dq_kernel<D>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, Dm::DQ_BYTES);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set = true;
  }
  const bf16 *qb = static_cast<const bf16*>(q), *kb = static_cast<const bf16*>(k),
             *vb = static_cast<const bf16*>(v), *ob = static_cast<const bf16*>(o),
             *dob = static_cast<const bf16*>(dout);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  const int rows = B * Sq * H;
  flash_bwd_delta_kernel<D><<<(rows + DELTA_WARPS - 1) / DELTA_WARPS, DELTA_WARPS * 32, 0,
                              stream>>>(ob, dob, dl, rows, Sq, H);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dkdv_kernel<D><<<dim3((Sk + BKV - 1) / BKV, KVH, B), THREADS, Dm::DKDV_BYTES,
                             stream>>>(qb, kb, vb, dob, l, dl, static_cast<bf16*>(dk),
                                       static_cast<bf16*>(dv), Sk, H, KVH, sc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dq_kernel<D><<<dim3((Sq + BQB - 1) / BQB, H, B), THREADS, Dm::DQ_BYTES,
                           stream>>>(qb, kb, vb, dob, l, dl, static_cast<bf16*>(dq), Sk, H,
                                     KVH, sc);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Dynamic shared memory of one block of the dkdv (pass 0) or dq (pass 1)
// kernel at head_dim D; 0 if D is not built.
int flash_attention_bwd_smem_bytes(int D, int pass) {
  if (D == 64) return pass ? Dims<64>::DQ_BYTES : Dims<64>::DKDV_BYTES;
  if (D == 112 || D == 128) return pass ? Dims<128>::DQ_BYTES : Dims<128>::DKDV_BYTES;
  return 0;
}

// q, o, dout, dq (B,Sq,H,D); k, v, dk, dv (B,Sk,KVH,D): contiguous bf16,
// 16-byte aligned; lse (B,H,Sq) fp32 from the forward, delta (B,H,Sq) fp32
// scratch. kv_valid <= Sk. Launches three kernels on the stream. Returns a
// cudaError_t value: 0 when every launch was accepted.
int flash_attention_bwd_bf16(const void* q, const void* k, const void* v, const void* o,
                             const void* dout, const void* lse, void* delta, void* dq,
                             void* dk, void* dv, int B, int Sq, int Sk, int H, int KVH,
                             int D, float scale, int causal, int window, float softcap,
                             int kv_valid, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Score sc{scale, softcap, Sq, causal, window, kv_valid};
  if (B < 1 || Sq < 1 || Sk < 1 || H < 1 || KVH < 1 || H % KVH)
    return static_cast<int>(cudaErrorInvalidValue);
  if (D == 64)
    return launch<64>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, Sq, Sk, H, KVH, sc, s);
  if (D == 112)   // zamba2-7b: 3584 / 32 heads, run at 128
    return launch<112>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, Sq, Sk, H, KVH, sc, s);
  if (D == 128)
    return launch<128>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, Sq, Sk, H, KVH, sc, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"

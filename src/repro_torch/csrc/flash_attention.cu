// Flash attention forward for Hopper (sm_90a): bf16 in, fp32 accumulate.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::flash_attention_pallas
// (body _attn_kernel): blockwise online-softmax attention over q (B,Sq,H,D) and
// k/v (B,Sk,KVH,D) with GQA, causal, sliding window, tanh softcap, q_offset and
// a kv_valid length mask. Masked scores take the finite value -1e30, as in the
// Pallas kernel: with -inf a tile whose every entry is masked would give
// inf - inf = NaN in the running-max correction; with -1e30 such a tile is
// cancelled exactly (factor exp(-1e30 - m) = 0) by the first later valid tile.
//
// Bound on the H100. Work: 4*B*H*Sq*Sk*D FLOPs (x1/2 when causal) at the
// 989 TFLOP/s bf16 tensor-core peak, against the bytes of q, k, v and o at
// 3.35 TB/s. At the serving shape (B=4, S=2048, H=KVH=32, D=128, causal) that is
// 1.37e11 FLOPs = 0.139 ms against 268 MB = 0.080 ms: the kernel is bound by
// operations, so the design is about keeping the tensor cores fed:
//   * one thread block per (64-row q tile, head, batch); four warps, each owning
//     16 q rows whose Q fragments stay in registers for the whole kv loop;
//   * a loop over 64-row K/V tiles replaces the TPU's sequential fourth grid
//     axis; the tiles are staged through shared memory with cp.async, two
//     stages deep, so the next tile loads while the current one is multiplied;
//   * both products use mma.sync m16n8k16 (bf16 x bf16 -> fp32); P stays in
//     registers (the S accumulator layout is the A-operand layout) and V
//     fragments come through ldmatrix.trans;
//   * tiles that the causal, window or kv_valid masks empty entirely are never
//     visited, which halves the causal work; ragged tails are masked in the
//     kernel (zero-filled loads, masked scores, guarded stores), never padded;
//   * GQA reads kv head h / (H / KVH) by index arithmetic; K/V are never
//     repeated.
// Shared-memory rows carry 8 bf16 of padding so that fragment loads and
// ldmatrix are free of bank conflicts. Head dims 64, 112 and 128 are built:
// each is a multiple of 16 (the mma k-step and the ldmatrix.trans n-step),
// its 16-byte row chunks divide among the 128 threads, and its padded shared
// row (D + 8) * 2 bytes stays a multiple of 16 for cp.async and ldmatrix.
// wgmma, TMA and warp specialisation are the next steps for this kernel.
//
// Plain C interface for ctypes: every pointer and the stream are void*; the
// launch returns cudaGetLastError() so the caller can raise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int BQ = 64;              // q rows per block
constexpr int BK = 64;              // kv rows per tile
constexpr int WARPS = BQ / 16;      // each warp owns 16 q rows
constexpr int THREADS = WARPS * 32;
constexpr int PAD = 8;              // bf16 of padding per shared-memory row
constexpr float NEG_INF = -1e30f;

template <int D>
struct Layout {
  static constexpr int LD = D + PAD;        // shared row stride, elements
  static constexpr int TILE = BK * LD;      // one K or V tile, elements
  // Q[BQ][LD], then K[2][BK][LD], then V[2][BK][LD]
  static constexpr int BYTES = (BQ * LD + 4 * TILE) * 2;
};

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

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // .x (lo) in the low half
  return *reinterpret_cast<uint32_t*>(&v);
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

// Stage rows [row0, row0 + 64) of one head into shared memory; rows at or past
// `limit` are zero-filled, so neither a ragged tail nor unwritten cache memory
// reaches the products.
template <int D>
__device__ __forceinline__ void load_tile(bf16* smem, const bf16* g, int row0,
                                          int limit, int row_stride) {
  constexpr int CH = D / 8;         // 16-byte chunks per row
  constexpr int LD = Layout<D>::LD;
  static_assert(BK * CH % THREADS == 0, "tile chunks divide among threads");
#pragma unroll
  for (int i = 0; i < BK * CH / THREADS; ++i) {
    int c = threadIdx.x + i * THREADS;
    int r = c / CH, col = (c % CH) * 8;
    bool ok = row0 + r < limit;
    const bf16* src = ok ? g + (size_t)(row0 + r) * row_stride + col : g;
    cp_async16(smem + r * LD + col, src, ok);
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o,
                 int Sq, int Sk, int H, int KVH, float scale, int causal,
                 int window, float softcap, int q_offset, int kv_valid) {
  constexpr int LD = Layout<D>::LD;
  constexpr int TILE = Layout<D>::TILE;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sK = sQ + BQ * LD;
  bf16* sV = sK + 2 * TILE;

  const int qt = gridDim.x - 1 - blockIdx.x;    // longest causal rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KVH);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t4 = lane & 3;       // mma fragment row / column pair
  const int q0 = qt * BQ;

  const bf16* qg = q + ((size_t)b * Sq * H + h) * D;
  const bf16* kg = k + ((size_t)b * Sk * KVH + kvh) * D;
  const bf16* vg = v + ((size_t)b * Sk * KVH + kvh) * D;

  // The kv tiles that hold at least one key some row of this tile may see.
  int kv_end = kv_valid;
  if (causal) kv_end = min(kv_end, q_offset + q0 + BQ);
  int kv_begin = window ? max(0, q_offset + q0 - window + 1) : 0;
  const int t_begin = kv_begin / BK;
  const int t_end = (kv_end + BK - 1) / BK;

  load_tile<D>(sQ, qg, q0, Sq, H * D);
  cp_async_commit();
  if (t_begin < t_end) {
    load_tile<D>(sK, kg, t_begin * BK, kv_valid, KVH * D);
    load_tile<D>(sV, vg, t_begin * BK, kv_valid, KVH * D);
  }
  cp_async_commit();
  cp_async_wait<1>();                           // Q has landed
  __syncthreads();

  uint32_t qf[D / 16][4];                       // A fragments of this warp's Q rows
  const bf16* sQw = sQ + warp * 16 * LD;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    int c = kk * 16 + t4 * 2;
    qf[kk][0] = ld32(sQw + g * LD + c);
    qf[kk][1] = ld32(sQw + (g + 8) * LD + c);
    qf[kk][2] = ld32(sQw + g * LD + c + 8);
    qf[kk][3] = ld32(sQw + (g + 8) * LD + c + 8);
  }

  float acc[D / 8][4];                          // O rows g, g+8; n-tile j = cols 8j..8j+7
#pragma unroll
  for (int j = 0; j < D / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m_run[2] = {NEG_INF, NEG_INF}, l_run[2] = {0.f, 0.f};
  const int qpos = q_offset + q0 + warp * 16 + g;   // row g; row g + 8 is qpos + 8

  for (int t = t_begin; t < t_end; ++t) {
    const int stage = (t - t_begin) & 1;
    if (t + 1 < t_end) {                        // prefetch the next tile
      load_tile<D>(sK + (stage ^ 1) * TILE, kg, (t + 1) * BK, kv_valid, KVH * D);
      load_tile<D>(sV + (stage ^ 1) * TILE, vg, (t + 1) * BK, kv_valid, KVH * D);
    }
    cp_async_commit();
    cp_async_wait<1>();                         // tile t has landed
    __syncthreads();
    const bf16* sKs = sK + stage * TILE;
    const bf16* sVs = sV + stage * TILE;

    // S = Q K^T for 16 rows x 64 keys per warp
    float s[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        const bf16* kr = sKs + (j * 8 + g) * LD + kk * 16 + t4 * 2;
        mma16816(s[j], qf[kk], ld32(kr), ld32(kr + 8));
      }
    }

    // scale, softcap, mask; then the online-softmax update
    const int kbase = t * BK;
    float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * scale;
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        int qp = qpos + (e >= 2 ? 8 : 0);
        int kp = kbase + j * 8 + t4 * 2 + (e & 1);
        bool ok = kp < kv_valid;
        if (causal) ok = ok && kp <= qp;
        if (window) ok = ok && qp - kp < window;
        x = ok ? x : NEG_INF;
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float rs[2] = {0.f, 0.f}, corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {               // the 4 threads of a quad share a row
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      corr[r] = __expf(m_run[r] - mx[r]);
      m_run[r] = mx[r];
    }
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = __expf(s[j][e] - mx[e >> 1]);
        rs[e >> 1] += s[j][e];
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
      l_run[r] = l_run[r] * corr[r] + rs[r];
    }
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      acc[j][0] *= corr[0]; acc[j][1] *= corr[0];
      acc[j][2] *= corr[1]; acc[j][3] *= corr[1];
    }

    // O += P V; P (bf16) goes from the S accumulators straight into A fragments
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t a[4];
      a[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      a[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      a[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int n = 0; n < D / 16; ++n) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, sVs + (kk * 16 + (lane & 15)) * LD + n * 16 + (lane >> 4) * 8);
        mma16816(acc[2 * n], a, bv[0], bv[1]);
        mma16816(acc[2 * n + 1], a, bv[2], bv[3]);
      }
    }
    __syncthreads();                            // stage is free for the prefetch after next
  }

  const int row0 = q0 + warp * 16 + g, row1 = row0 + 8;
  const float inv0 = 1.f / fmaxf(l_run[0], 1e-30f);
  const float inv1 = 1.f / fmaxf(l_run[1], 1e-30f);
  bf16* o0 = o + (((size_t)b * Sq + row0) * H + h) * D;
  bf16* o1 = o + (((size_t)b * Sq + row1) * H + h) * D;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    int col = j * 8 + t4 * 2;
    if (row0 < Sq)
      *reinterpret_cast<uint32_t*>(o0 + col) = pack_bf16(acc[j][0] * inv0, acc[j][1] * inv0);
    if (row1 < Sq)
      *reinterpret_cast<uint32_t*>(o1 + col) = pack_bf16(acc[j][2] * inv1, acc[j][3] * inv1);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int B, int Sq,
           int Sk, int H, int KVH, float scale, int causal, int window,
           float softcap, int q_offset, int kv_valid, cudaStream_t stream) {
  constexpr int bytes = Layout<D>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<D><<<grid, THREADS, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), Sq, Sk, H, KVH, scale,
      causal, window, softcap, q_offset, kv_valid);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Dynamic shared memory one block uses at head_dim D (0 if D is not built).
int flash_attention_smem_bytes(int D) {
  if (D == 64) return Layout<64>::BYTES;
  if (D == 112) return Layout<112>::BYTES;
  if (D == 128) return Layout<128>::BYTES;
  return 0;
}

// q (B,Sq,H,D), k/v (B,Sk,KVH,D), o (B,Sq,H,D): contiguous bf16. kv_valid <= Sk.
// Returns a cudaError_t value: 0 when the launch was accepted.
int flash_attention_fwd_bf16(const void* q, const void* k, const void* v, void* o,
                             int B, int Sq, int Sk, int H, int KVH, int D,
                             float scale, int causal, int window, float softcap,
                             int q_offset, int kv_valid, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return launch<64>(q, k, v, o, B, Sq, Sk, H, KVH, scale, causal, window,
                      softcap, q_offset, kv_valid, s);
  if (D == 112)   // zamba2-7b: 3584 / 32 heads
    return launch<112>(q, k, v, o, B, Sq, Sk, H, KVH, scale, causal, window,
                       softcap, q_offset, kv_valid, s);
  if (D == 128)
    return launch<128>(q, k, v, o, B, Sq, Sk, H, KVH, scale, causal, window,
                       softcap, q_offset, kv_valid, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"

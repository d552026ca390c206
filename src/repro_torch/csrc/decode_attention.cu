// Decode attention for Hopper (sm_90a): one query row a head over a bf16 KV
// cache, bf16 in, fp32 inside, bf16 out.
//
// Replaces no TPU kernel: the reference's decode attention
// (repro/kernels/ops.py::decode_attention) is plain jnp, a GEMV that XLA
// fuses. The port ran it as plain torch, which made fp32 copies of the whole
// allocated cache on every layer of every step and ran its masks as some
// twenty separate ops (19-29x this kernel's bound at the serving cells).
//
// What it computes is the plain version's arithmetic
// (kernels/decode_attention.py::decode_attention_plain): s = (q . k) * scale
// as fp32 sums of bf16 x bf16 products (exact in fp32), the tanh softcap,
// the masks (causal, kv_len, the window's start lo = max(0, q_pos - window +
// 1)), an fp32 softmax, P normalised and then rounded to bf16, and P V
// accumulated in fp32, rounded once to bf16. Positions outside [lo, hi) are
// never read: their P is exactly 0 in the plain version too.
//
// Bound on the H100: bytes. Per kv head and position it reads 2 D bf16 of K
// and V and does 4 g D FLOPs for the g = H / KVH query heads it serves, at
// most 12 FLOPs a byte (g = 12) against the 295 the bf16 tensor cores need
// to be the limit. At deepseek-7b's agent turn (B=4, H=KVH=32, D=128, ~8 640
// visible positions) a layer reads 566 MB of K and V: 0.169 ms at 3.35 TB/s;
// at its RAG cell (B=32, ~1 300 positions) 682 MB, 0.204 ms. So the design
// is about bytes in flight, not tensor cores: CUDA-core FMAs.
//
// Design. Two launches a call, enqueued by one C call, each over a grid of
// (splits, B x KVH) blocks of 256 threads:
//   * A block owns one kv head's g query rows (q in registers) and one
//     contiguous run of the visible positions [lo, hi), cut into `splits`
//     runs of ceil(n / splits) rounded up to whole block steps (STEP
//     positions: the lane groups times U) in order, the last ones short or
//     empty; the run is computed here from the lengths, so the host only
//     picks the count (kernels/decode_attention.py::split_count: about 16
//     blocks an SM, so that the grid fills the card several times over).
//   * A position's row of D bf16 is read by D/8 lanes with one 16-byte load
//     each (lane groups of 8, 16 or 32 lanes: a warp takes 4, 2 or 1
//     positions); each lane keeps U positions' loads in flight before it
//     uses them (U = 8 at g <= 2: 32 KB a block), with several blocks an SM.
//   * scores: each group's lanes form the g dot products of their 8 columns
//     and sum them over the group by shuffles; the lane owning a row writes
//     its fp32 score to scratch (B, H, Sk) and keeps the run's max and sum of
//     exp, merged over the block in warp order and written per split.
//   * pv: each block merges its rows' split statistics (a warp a row: the
//     max, then the sum of l_j exp(m_j - M), in a fixed order), forms
//     P = bf16(exp(s - M) / L) for
//     its run from the scores (one lane a row, shared in the group by
//     shuffles), streams its V run and accumulates P V in fp32 registers,
//     reduced over the block's lane groups in a fixed order. One split
//     writes the bf16 output; with more, each writes its fp32 partial and
//     the last block of a kv head to finish (a counter it resets to 0) sums
//     the partials in split order: no atomics on the data, bitwise
//     repeatable.
// The scores make a second trip through memory (4 B a head and position
// written and read: at the RAG cell 5.7 MB a layer, under 1% of the cache's
// bytes), which lets P be normalised before it is rounded, as the plain
// version rounds it; a one-pass online softmax could not round P that way.
// At large g the CUDA-core work grows as g (8 g FMAs and g shuffle sums a
// lane and position): at g = 12 the kernel is near its issue limit rather
// than its byte bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_GROUP = 12;
constexpr unsigned FULL = 0xffffffffu;

// Lanes of one position's row at head_dim D: one 16-byte chunk (8 bf16) a
// lane, in groups of a power of two (112 takes 16 lanes, 14 of them loading;
// 160 takes 32, 20 loading).
template <int D>
struct Shape {
  static constexpr int CHUNKS = D / 8;
  static constexpr int LANES = CHUNKS <= 8 ? 8 : CHUNKS <= 16 ? 16 : 32;
  static constexpr int GROUPS = THREADS / LANES;   // positions a block step
};

struct Params {
  const bf16* q;      // (B, 1, H, D)
  const bf16* k;      // (B, Sk, KVH, D)
  const bf16* v;
  bf16* o;            // (B, 1, H, D)
  float* scores;      // (B, H, Sk): the visible positions' masked scores
  float* stats;       // (B, H, splits, 2): each split's row max and sum of exp
  float* part;        // (B, H, splits, D): fp32 partial outputs (splits > 1)
  int* counters;      // (B * KVH), 0 between calls
  int Sk, H, KVH, G, splits, q_offset, kv_len, window;
  float scale, softcap;
};

// The split's run [start, end) of the visible positions [lo, hi): runs of
// ceil(n / splits) rounded up to a multiple of STEP, the block's step.
template <int STEP>
__device__ __forceinline__ void split_range(const Params& p, int split, int& start,
                                            int& end) {
  const int hi = min(min(p.kv_len, p.q_offset + 1), p.Sk);
  const int lo = p.window > 0 ? max(0, p.q_offset - p.window + 1) : 0;
  const int per = ((hi - lo + p.splits - 1) / p.splits + STEP - 1) / STEP * STEP;
  start = min(hi, lo + split * per);
  end = min(hi, start + per);
}

__device__ __forceinline__ uint4 load16(const bf16* ptr) {
  return __ldcs(reinterpret_cast<const uint4*>(ptr));    // read once: evict first
}

// 8 bf16 to fp32, exactly (a bf16 is the top half of an fp32).
__device__ __forceinline__ void unpack8(const uint4& x, float (&f)[8]) {
  const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// (m, l) <- the max and sum of exp(x - max) of both sets.
__device__ __forceinline__ void combine(float& m, float& l, float mo, float lo) {
  const float mx = fmaxf(m, mo);
  if (mx == -INFINITY) return;
  l = l * expf(m - mx) + lo * expf(mo - mx);
  m = mx;
}

template <int D, int G, int U>
__global__ void __launch_bounds__(THREADS) decode_scores_kernel(const Params p) {
  using S = Shape<D>;
  constexpr int L = S::LANES;
  const int split = blockIdx.x, bk = blockIdx.y;
  const int b = bk / p.KVH, kvh = bk - b * p.KVH, h0 = kvh * p.G;
  const int sub = threadIdx.x % L, grp = threadIdx.x / L;
  const bool active = sub < S::CHUNKS;
  int start, end;
  split_range<S::GROUPS * U>(p, split, start, end);

  float qf[G][8];
#pragma unroll
  for (int r = 0; r < G; ++r) {
    uint4 x = make_uint4(0, 0, 0, 0);
    if (active && r < p.G)
      x = *reinterpret_cast<const uint4*>(p.q + ((size_t)b * p.H + h0 + r) * D + sub * 8);
    unpack8(x, qf[r]);
  }
  const size_t row = (size_t)p.KVH * D;            // elements from one position to the next
  const bf16* kp = p.k + (size_t)b * p.Sk * row + (size_t)kvh * D + sub * 8;
  float* sc = p.scores + ((size_t)b * p.H + h0) * p.Sk;
  float m[G], l[G];                                 // of the rows this lane owns
#pragma unroll
  for (int r = 0; r < G; ++r) m[r] = -INFINITY, l[r] = 0.f;

  for (int base = start; base < end; base += S::GROUPS * U) {
    uint4 x[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int pos = base + u * S::GROUPS + grp;
      x[u] = active && pos < end ? load16(kp + pos * row) : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int pos = base + u * S::GROUPS + grp;
      float kf[8];
      unpack8(x[u], kf);
      float s[G];
#pragma unroll
      for (int r = 0; r < G; ++r) {
        float acc = 0.f;
#pragma unroll
        for (int i = 0; i < 8; ++i) acc = fmaf(qf[r][i], kf[i], acc);
#pragma unroll
        for (int off = L / 2; off > 0; off >>= 1) acc += __shfl_xor_sync(FULL, acc, off);
        s[r] = acc;
      }
      if (pos < end) {
#pragma unroll
        for (int r = 0; r < G; ++r) {
          if (r % L != sub || r >= p.G) continue;
          float x = s[r] * p.scale;
          if (p.softcap != 0.f) x = p.softcap * tanhf(x / p.softcap);
          sc[(size_t)r * p.Sk + pos] = x;
          if (x > m[r]) {
            l[r] = l[r] * expf(m[r] - x) + 1.f;
            m[r] = x;
          } else {
            l[r] += expf(x - m[r]);
          }
        }
      }
    }
  }

  // the run's (max, sum of exp) a row: over a warp's groups, then the warps in order
  __shared__ float red_m[WARPS][G], red_l[WARPS][G];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int r = 0; r < G; ++r) {
#pragma unroll
    for (int off = L; off < 32; off <<= 1) {
      const float mo = __shfl_xor_sync(FULL, m[r], off);
      const float lo = __shfl_xor_sync(FULL, l[r], off);
      combine(m[r], l[r], mo, lo);
    }
    if (lane == r % L) red_m[warp][r] = m[r], red_l[warp][r] = l[r];
  }
  __syncthreads();
  if (threadIdx.x < p.G) {
    const int r = threadIdx.x;
    float mm = -INFINITY, ll = 0.f;
    for (int w = 0; w < WARPS; ++w) combine(mm, ll, red_m[w][r], red_l[w][r]);
    float* st = p.stats + (((size_t)b * p.H + h0 + r) * p.splits + split) * 2;
    st[0] = mm;
    st[1] = ll;
  }
}

template <int D, int G, int U>
__global__ void __launch_bounds__(THREADS) decode_pv_kernel(const Params p) {
  using S = Shape<D>;
  constexpr int L = S::LANES;
  constexpr int RPL = (G + L - 1) / L;              // rows a lane owns
  __shared__ float row_m[G], row_l[G];
  __shared__ float red[WARPS][D];
  __shared__ int last;
  const int split = blockIdx.x, bk = blockIdx.y;
  const int b = bk / p.KVH, kvh = bk - b * p.KVH, h0 = kvh * p.G;
  const int sub = threadIdx.x % L, grp = threadIdx.x / L;
  const bool active = sub < S::CHUNKS;
  int start, end;
  split_range<S::GROUPS * U>(p, split, start, end);

  // each row's max and sum of exp over every split: a warp a row, the
  // splits over its lanes, summed in a fixed order
  {
    const int lane = threadIdx.x % 32;
    for (int r = threadIdx.x / 32; r < p.G; r += WARPS) {
      const float* st = p.stats + ((size_t)b * p.H + h0 + r) * p.splits * 2;
      float mm = -INFINITY;
      for (int j = lane; j < p.splits; j += 32) mm = fmaxf(mm, st[2 * j]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mm = fmaxf(mm, __shfl_xor_sync(FULL, mm, off));
      float ll = 0.f;
      for (int j = lane; j < p.splits; j += 32)
        if (st[2 * j] != -INFINITY) ll += st[2 * j + 1] * expf(st[2 * j] - mm);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) ll += __shfl_xor_sync(FULL, ll, off);
      if (lane == 0) row_m[r] = mm, row_l[r] = ll;
    }
  }
  __syncthreads();
  float mrow[RPL], lrow[RPL];
#pragma unroll
  for (int j = 0; j < RPL; ++j) {
    const int r = sub + j * L;
    mrow[j] = r < p.G ? row_m[r] : 0.f;
    lrow[j] = r < p.G ? row_l[r] : 1.f;
  }

  const size_t row = (size_t)p.KVH * D;
  const bf16* vp = p.v + (size_t)b * p.Sk * row + (size_t)kvh * D + sub * 8;
  const float* sc = p.scores + ((size_t)b * p.H + h0) * p.Sk;
  float acc[G][8];
#pragma unroll
  for (int r = 0; r < G; ++r)
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[r][i] = 0.f;

  for (int base = start; base < end; base += S::GROUPS * U) {
    uint4 x[U];
    float pr[U][RPL];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int pos = base + u * S::GROUPS + grp;
      x[u] = active && pos < end ? load16(vp + pos * row) : make_uint4(0, 0, 0, 0);
#pragma unroll
      for (int j = 0; j < RPL; ++j) {
        const int r = sub + j * L;
        pr[u][j] = r < p.G && pos < end ? sc[(size_t)r * p.Sk + pos] : -INFINITY;
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
      for (int j = 0; j < RPL; ++j)      // P normalised, then rounded to bf16
        pr[u][j] = pr[u][j] == -INFINITY
                       ? 0.f
                       : __bfloat162float(__float2bfloat16_rn(expf(pr[u][j] - mrow[j]) / lrow[j]));
      float vf[8];
      unpack8(x[u], vf);
#pragma unroll
      for (int r = 0; r < G; ++r) {
        const float w = __shfl_sync(FULL, pr[u][r / L], r % L, L);
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[r][i] = fmaf(w, vf[i], acc[r][i]);
      }
    }
  }

  // sum over the block's lane groups: a warp's by shuffles, then the warps in order
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int r = 0; r < G; ++r) {
    if (r >= p.G) break;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int off = L; off < 32; off <<= 1) acc[r][i] += __shfl_xor_sync(FULL, acc[r][i], off);
    if (lane < L && active)
#pragma unroll
      for (int i = 0; i < 8; ++i) red[warp][sub * 8 + i] = acc[r][i];
    __syncthreads();
    const size_t hrow = (size_t)b * p.H + h0 + r;
    for (int d = threadIdx.x; d < D; d += THREADS) {
      float s = 0.f;
      for (int w = 0; w < WARPS; ++w) s += red[w][d];
      if (p.splits == 1)
        p.o[hrow * D + d] = __float2bfloat16_rn(s);
      else
        p.part[(hrow * p.splits + split) * D + d] = s;
    }
    __syncthreads();
  }
  if (p.splits == 1) return;

  // the kv head's last block to finish sums the partials in split order;
  // each thread's partials are visible before its block is counted, and
  // the last block reads them past L1
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    last = atomicAdd(p.counters + bk, 1) == p.splits - 1;
    if (last) p.counters[bk] = 0;                 // ready for the next call
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int idx = threadIdx.x; idx < p.G * D; idx += THREADS) {
    const int r = idx / D, d = idx - r * D;
    const size_t hrow = (size_t)b * p.H + h0 + r;
    float s = 0.f;
#pragma unroll 4
    for (int j = 0; j < p.splits; ++j) s += __ldcg(p.part + (hrow * p.splits + j) * D + d);
    p.o[hrow * D + d] = __float2bfloat16_rn(s);
  }
}

template <int D, int G>
cudaError_t launch(const Params& p, int B, cudaStream_t s) {
  constexpr int U = G <= 2 ? 8 : G <= 4 ? 4 : 2;    // positions a lane keeps in flight
  const dim3 grid(p.splits, B * p.KVH);
  decode_scores_kernel<D, G, U><<<grid, THREADS, 0, s>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_pv_kernel<D, G, U><<<grid, THREADS, 0, s>>>(p);
  return cudaGetLastError();
}

// g rounded up to a built row count: 1, 2, 4, 8 or 12 (rows past g are
// zeros, never stored)
template <int D>
int launch_rows(const Params& p, int B, cudaStream_t s) {
  if (p.G <= 1) return static_cast<int>(launch<D, 1>(p, B, s));
  if (p.G <= 2) return static_cast<int>(launch<D, 2>(p, B, s));
  if (p.G <= 4) return static_cast<int>(launch<D, 4>(p, B, s));
  if (p.G <= 8) return static_cast<int>(launch<D, 8>(p, B, s));
  return static_cast<int>(launch<D, 12>(p, B, s));
}

}  // namespace

extern "C" {

// q (B,1,H,D), k/v (B,Sk,KVH,D), o (B,1,H,D): contiguous bf16, 16-byte
// aligned. H / KVH at most 12. The visible positions [lo, hi), hi =
// min(kv_len, q_offset + 1, Sk), lo = max(0, q_offset - window + 1) with a
// window (0: none), must not be empty. scratch: fp32, B*H*Sk +
// 2*B*H*splits floats, and B*H*splits*D more when splits > 1; counters:
// B*KVH int32, all 0 (as each call leaves them). Two kernels are enqueued
// on `stream`. Returns a cudaError_t value: 0 when both launches were
// accepted.
int decode_attention_bf16(const void* q, const void* k, const void* v, void* o, void* scratch,
                          void* counters, int B, int Sk, int H, int KVH, int D, int q_offset,
                          int kv_len, int window, int splits, float scale, float softcap,
                          void* stream) {
  if (B < 1 || Sk < 1 || KVH < 1 || H < KVH || H % KVH || H / KVH > MAX_GROUP ||
      splits < 1 || window < 0 || B * KVH > 65535 || scratch == nullptr ||
      (splits > 1 && counters == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int hi = std::min(std::min(kv_len, q_offset + 1), Sk);
  const int lo = window > 0 ? std::max(0, q_offset - window + 1) : 0;
  if (hi <= lo) return static_cast<int>(cudaErrorInvalidValue);
  float* scores = static_cast<float*>(scratch);
  float* stats = scores + (size_t)B * H * Sk;
  float* part = stats + (size_t)B * H * splits * 2;
  const Params p{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                 static_cast<const bf16*>(v), static_cast<bf16*>(o), scores, stats, part,
                 static_cast<int*>(counters), Sk, H, KVH, H / KVH, splits, q_offset, kv_len,
                 window, scale, softcap};
  if (cudaError_t err = hopper::bind_thread_device(q)) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64) return launch_rows<64>(p, B, s);     // seamless-m4t-large-v2
  if (D == 112) return launch_rows<112>(p, B, s);   // zamba2-7b, kimi-k2
  if (D == 128) return launch_rows<128>(p, B, s);
  if (D == 160) return launch_rows<160>(p, B, s);   // stablelm-12b
  if (D == 256) return launch_rows<256>(p, B, s);   // gemma2-9b
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"

// Flash attention backward for Hopper (sm_90a), on the CUDA cores.
//
// Replaces: nothing in Pallas. The reference trains through XLA's autodiff
// of its score-materialising attention (src/repro/models/layers.py:60-133
// attention/_sdpa); this kernel computes the same gradient for the
// function the forward kernels compute (csrc/flash_attention.cu and
// csrc/flash_attention_tc.cu, the port of
// src/repro/kernels/flash_attention.py:74 flash_attention_pallas), so the
// LM's training step (models/steps.py) differentiates attention on the
// card without the plain version. kernels/flash_attention.py's
// FlashAttention autograd Function calls it from its backward.
//
// The forward, for q (B, S, H, dh), k/v (B, Sk, KV, dh), int32 positions
// qpos (S,) / kpos (Sk,), query head h reading kv head h / (H / KV):
//   x_ij = (q_i . k_j) * scale;  t_ij = tanh(x_ij / cap), x_ij = cap t_ij  (cap != 0)
//   visible(i, j): kpos_j >= 0, (causal) qpos_i - kpos_j >= 0,
//                  (window > 0) qpos_i - kpos_j < window; others -1e30
//   m_i = max_j x_ij, p_ij = exp(x_ij - m_i) (0 on a fully masked row),
//   l_i = max(sum_j p_ij, 1e-30), o_i = sum_j p_ij v_j / l_i.
// On a row that sees a key, l_i >= 1 (its largest key gives exp(0)), so the
// clamp is inactive and P_ij = p_ij / l_i = exp(x_ij - lse_i) with
// lse_i = m_i + log l_i. A fully masked row has o_i = 0 and no gradient:
// lse_i = +inf there, so every P_ij is 0. With dP_ij = do_i . v_j and
// D_i = sum_j P_ij dP_ij (= do_i . o_i):
//   dS_ij = P_ij (dP_ij - D_i) * (1 - t_ij^2 where cap != 0)
//   dv_j = sum_i P_ij do_i,  dk_j = scale sum_i dS_ij q_i,
//   dq_i = scale sum_j dS_ij k_j.
// (The forward rounds p to v's type before P.V; the gradient takes the
// unrounded P, the gradient of the attention function at the inputs as
// given, computed in float32. D comes from dP, not from the forward's
// output: that output is rounded to the inputs' type, and do . o in bf16
// moved the gradients by several bf16 ulps of their largest element, far
// more than the rest of the arithmetic does.)
//
// Three launches, all float32 FMAs on the CUDA cores (no TF32, no bf16
// products; bf16 operands are widened when staged), no atomics: every
// output element is written by one block after a fixed walk, so the
// gradient is bitwise the same run to run.
//   (a) row_stats: one block per (q tile, batch*head); recomputes each
//       row's max, sum and sum_j p_ij dP_ij over the key tiles (online,
//       rescaled as the max moves), writes lse (B, H, S) and D (B, H, S)
//       float32 scratch. The forward kernels stay as they are (no lse
//       output), so their bitwise records stand.
//   (b) dkdv: one block per (kv tile, batch*kv head); keeps its K and V
//       tiles and the dk/dv accumulators, walks every query head of its
//       GQA group and every query tile in order: P, dP, dS, then
//       dv += P^T do and dk += dS^T q.
//   (c) dq: one block per (q tile, batch*head); keeps q, do, lse and D,
//       walks the key tiles in order: P, dP, dS, then dq += dS k.
// Tiles are T query rows x T keys, 256 threads: thread (tx = t % 16,
// ty = t / 16) computes the scores of rows ty + 16a and keys tx + 16b
// (a, b < R = T / 16), q/k/v/do staged row-major with rows of DHP + 4
// words (DHP = 64, 128 or 256: dh padded, the padding zero), so a score
// is R LDS.128 of q rows (broadcast over the half warp) and R of k rows
// (conflict-free: the padded stride puts eight consecutive rows on
// distinct bank quads) per 4 R^2 FMAs. T is 64 at DHP 64 and 128; at DHP
// 256 four 64-row tiles alone need 266,240 bytes, over the 232,448 a
// block may use, so T is 32 there (Tile<DHP>): the passes ask for 133,376
// / 142,080 / 137,856 bytes, and the score loop reads one word per FMA,
// twice the 64-row tile's. P and dS go through shared memory (rows of T +
// 1 words) for the products over rows (dk, dv: keys tx + 16b, columns 4
// ty + 64 g) and over keys (dq: rows tx + 16a). A (q tile, kv tile) pair
// that no position rule lets meet is skipped, the test on the tiles'
// position ranges (in a causal pass, the upper half of the diagonal).
//
// Bound on an H100 SXM: operations. Per visible (query, key) pair it does
// 9 products of dh multiply-adds (q.k and do.v in each pass, and the three
// gradient products): 18 dh flops, 2.3e11 flops a call at musicgen-medium's
// shape (B 4, S 2048, H = KV = 24, dh 64, causal), 3.5 ms at the 67
// TFLOP/s of float32 FMAs; bytes (q, k, v, do read and dq, dk, dv written
// once, 75 MB in bf16) take 23 us. The loops read 0.5
// shared-memory words per FMA, twice what the SM serves at the FMA rate,
// so about half of that peak is this design's ceiling (a quarter at DHP
// 256, whose 32-row tiles read one word per FMA).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

namespace {

constexpr int kThreads = 256;

template <int DHP>
struct Tile {
  // query rows and keys of a tile (kT == BQ == BK): 64, but 32 at DHP 256,
  // where four 64-row tiles of DHP + 4 words alone pass the 227 KB a
  // block may use
  static constexpr int kT = DHP == 256 ? 32 : 64;
  static constexpr int kR = kT / 16;           // rows (keys) of a tile a thread keeps
  static constexpr int kLd = DHP + 4;          // words per staged row
  static constexpr int kFloats = kT * kLd;
  static constexpr int kLdp = kT + 1;          // P and dS rows, padded
  static constexpr int kCols = DHP / 16;       // gradient columns a thread keeps
  // blocks an SM holds: at DHP 128 and 256 every pass's shared memory
  // admits one (so up to 255 registers a thread, where a cap of 128
  // spilled dq's accumulators at 128), at 64 two
  static constexpr int kMinBlocks = DHP == 64 ? 2 : 1;
};

// dynamic shared memory of each pass: tiles, P / dS, lse and D, positions
template <int DHP>
constexpr int smem_stats() {
  using T = Tile<DHP>;
  return static_cast<int>(sizeof(float) * 4 * T::kFloats + sizeof(int) * 2 * T::kT);
}
template <int DHP>
constexpr int smem_dkdv() {
  using T = Tile<DHP>;
  return static_cast<int>(sizeof(float) * (4 * T::kFloats + 2 * T::kT * T::kLdp + 2 * T::kT) +
                          sizeof(int) * 2 * T::kT);
}
template <int DHP>
constexpr int smem_dq() {
  using T = Tile<DHP>;
  return static_cast<int>(sizeof(float) * (4 * T::kFloats + T::kT * T::kLdp + 2 * T::kT) +
                          sizeof(int) * 2 * T::kT);
}
static_assert(smem_stats<256>() == 133376 && smem_dkdv<256>() == 142080 &&
                  smem_dq<256>() == 137856,
              "envelope.flash_bwd_smem_bytes mirrors these");

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

struct Params {
  const int* qpos;
  const int* kpos;
  int batch, s_len, sk_len, heads, kv_heads, dh, causal, window;
  float scale, cap;
};

// rows [r0, r0 + kT) of an operand whose row r starts at base + r *
// row_stride, widened to float32 into dst[kT][DHP + 4]; rows at or past
// `n` and columns at or past dh are 0
template <typename T, int DHP>
__device__ __forceinline__ void load_rows(float* dst, const T* base, int r0, int n, int row_stride,
                                          int dh) {
  constexpr int kLd = Tile<DHP>::kLd;
  for (int e = threadIdx.x; e < Tile<DHP>::kT * DHP; e += kThreads) {
    const int r = e / DHP, c = e % DHP;
    float x = 0.0f;
    if (r0 + r < n && c < dh) x = to_f32(base[static_cast<size_t>(r0 + r) * row_stride + c]);
    dst[r * kLd + c] = x;
  }
}

// positions [r0, r0 + t) of pos, `fill` at or past n
__device__ __forceinline__ void load_pos(int* dst, const int* pos, int r0, int n, int t,
                                         int fill) {
  for (int r = threadIdx.x; r < t; r += kThreads) dst[r] = r0 + r < n ? pos[r0 + r] : fill;
}

// row statistics [r0, r0 + t) of a (B*H, S) float32 array, `fill` past n
__device__ __forceinline__ void load_stat(float* dst, const float* src, int r0, int n, int t,
                                          float fill) {
  for (int r = threadIdx.x; r < t; r += kThreads) dst[r] = r0 + r < n ? src[r0 + r] : fill;
}

struct Range {
  long long lo, hi;  // lo > hi: no live position
};

// min and max of the first n positions (keys: those >= 0 only), read by
// every thread from shared memory
__device__ __forceinline__ Range range_of(const int* pos, int n, bool keys) {
  Range r{LLONG_MAX, LLONG_MIN};
  for (int i = 0; i < n; ++i) {
    const int x = pos[i];
    if (keys && x < 0) continue;
    r.lo = x < r.lo ? x : r.lo;
    r.hi = x > r.hi ? x : r.hi;
  }
  return r;
}

// false when no (query, key) pair of the two tiles is visible
__device__ __forceinline__ bool tiles_meet(Range q, Range k, const Params& p) {
  if (q.lo > q.hi || k.lo > k.hi) return false;
  if (p.causal && q.hi < k.lo) return false;
  if (p.window > 0 && q.lo - k.hi >= p.window) return false;
  return true;
}

__device__ __forceinline__ bool visible(int qp, int kp, const Params& p) {
  if (kp < 0) return false;
  const long long d = static_cast<long long>(qp) - kp;
  return (!p.causal || d >= 0) && (p.window <= 0 || d < p.window);
}

// acc[a][b] = sum over d < dh4 of A[ty + 16a][d] * B[tx + 16b][d], a, b
// < kR (dh4: dh rounded up to 4; the padding columns are 0)
template <int DHP>
__device__ __forceinline__ void dot_tile(const float* A, const float* B, int dh4, int tx, int ty,
                                         float acc[Tile<DHP>::kR][Tile<DHP>::kR]) {
  constexpr int kLd = Tile<DHP>::kLd, kR = Tile<DHP>::kR;
#pragma unroll
  for (int a = 0; a < kR; ++a) {
#pragma unroll
    for (int b = 0; b < kR; ++b) acc[a][b] = 0.0f;
  }
#pragma unroll 2
  for (int d = 0; d < dh4; d += 4) {
    float4 x[kR], y[kR];
#pragma unroll
    for (int a = 0; a < kR; ++a) x[a] = *reinterpret_cast<const float4*>(A + (ty + 16 * a) * kLd + d);
#pragma unroll
    for (int b = 0; b < kR; ++b) y[b] = *reinterpret_cast<const float4*>(B + (tx + 16 * b) * kLd + d);
#pragma unroll
    for (int a = 0; a < kR; ++a) {
#pragma unroll
      for (int b = 0; b < kR; ++b) {
        float s = acc[a][b];
        s = fmaf(x[a].x, y[b].x, s);
        s = fmaf(x[a].y, y[b].y, s);
        s = fmaf(x[a].z, y[b].z, s);
        s = fmaf(x[a].w, y[b].w, s);
        acc[a][b] = s;
      }
    }
  }
}

// the scaled (and softcapped) score of a raw q.k; t = tanh(x / cap)
template <bool kCap>
__device__ __forceinline__ float score(float raw, const Params& p, float& t) {
  float x = raw * p.scale;
  t = 0.0f;
  if constexpr (kCap) {
    t = tanhf(x / p.cap);
    x = t * p.cap;
  }
  return x;
}

// P and dS of one kT x kT tile pair from its raw scores s = q.k and
// dp = do.v: rows ty + 16a (query q0 + row), keys tx + 16b, a, b < R
template <int R, bool kCap>
__device__ __forceinline__ void probs_and_grads(const float s[R][R], const float dp[R][R],
                                                const int* s_qp, const int* s_kp,
                                                const float* s_lse, const float* s_dl, int q0,
                                                int tx, int ty, const Params& p, float pr[R][R],
                                                float ds[R][R]) {
#pragma unroll
  for (int a = 0; a < R; ++a) {
    const int i = ty + 16 * a;
    const bool row = q0 + i < p.s_len;
    const int qp = s_qp[i];
    const float lse = s_lse[i], dl = s_dl[i];
#pragma unroll
    for (int b = 0; b < R; ++b) {
      float t;
      const float x = score<kCap>(s[a][b], p, t);
      const float pij = row && visible(qp, s_kp[tx + 16 * b], p) ? expf(x - lse) : 0.0f;
      float g = pij * (dp[a][b] - dl);
      if constexpr (kCap) g *= 1.0f - t * t;
      pr[a][b] = pij;
      ds[a][b] = g;
    }
  }
}

__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// ------------------------------------------------------------- (a) lse, D
template <typename T, int DHP, bool kCap>
__global__ void __launch_bounds__(kThreads, Tile<DHP>::kMinBlocks)
    row_stats_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ dout, float* __restrict__ lse,
                     float* __restrict__ delta, Params p) {
  constexpr int kT = Tile<DHP>::kT, kR = Tile<DHP>::kR;
  extern __shared__ float4 smem4[];
  float* s_q = reinterpret_cast<float*>(smem4);
  float* s_do = s_q + Tile<DHP>::kFloats;
  float* s_k = s_do + Tile<DHP>::kFloats;
  float* s_v = s_k + Tile<DHP>::kFloats;
  int* s_qp = reinterpret_cast<int*>(s_v + Tile<DHP>::kFloats);
  int* s_kp = s_qp + kT;

  const int bh_count = p.batch * p.heads;
  const int n_qt = (p.s_len + kT - 1) / kT;
  const int qt = n_qt - 1 - static_cast<int>(blockIdx.x) / bh_count;  // longest first
  const int bh = static_cast<int>(blockIdx.x) % bh_count;
  const int bb = bh / p.heads, h = bh % p.heads;
  const int kvh = h / (p.heads / p.kv_heads);
  const int q0 = qt * kT;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int dh4 = (p.dh + 3) & ~3;
  const size_t q_row0 = (static_cast<size_t>(bb) * p.s_len * p.heads + h) * p.dh;
  const size_t k_row0 = (static_cast<size_t>(bb) * p.sk_len * p.kv_heads + kvh) * p.dh;

  load_rows<T, DHP>(s_q, q + q_row0, q0, p.s_len, p.heads * p.dh, p.dh);
  load_rows<T, DHP>(s_do, dout + q_row0, q0, p.s_len, p.heads * p.dh, p.dh);
  load_pos(s_qp, p.qpos, q0, p.s_len, kT, 0);
  __syncthreads();
  const Range qr = range_of(s_qp, min(kT, p.s_len - q0), false);

  // per row: the running max m (shared by the half warp), and this
  // thread's share of sum p and of sum p dP against it
  float m[kR], l[kR], pd[kR];
#pragma unroll
  for (int a = 0; a < kR; ++a) {
    m[a] = -INFINITY;
    l[a] = pd[a] = 0.0f;
  }
  const int n_kt = (p.sk_len + kT - 1) / kT;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kT;
    __syncthreads();  // the previous tile's reads are done
    load_pos(s_kp, p.kpos, k0, p.sk_len, kT, -1);
    __syncthreads();
    if (!tiles_meet(qr, range_of(s_kp, kT, true), p)) continue;
    load_rows<T, DHP>(s_k, k + k_row0, k0, p.sk_len, p.kv_heads * p.dh, p.dh);
    load_rows<T, DHP>(s_v, v + k_row0, k0, p.sk_len, p.kv_heads * p.dh, p.dh);
    __syncthreads();
    float s[kR][kR], dp[kR][kR];
    dot_tile<DHP>(s_q, s_k, dh4, tx, ty, s);
    dot_tile<DHP>(s_do, s_v, dh4, tx, ty, dp);
#pragma unroll
    for (int a = 0; a < kR; ++a) {
      const int i = ty + 16 * a;
      const bool row = q0 + i < p.s_len;
      float x[kR];
      bool vis[kR];
      float tmax = -INFINITY;
#pragma unroll
      for (int b = 0; b < kR; ++b) {
        float t;
        x[b] = score<kCap>(s[a][b], p, t);
        vis[b] = row && visible(s_qp[i], s_kp[tx + 16 * b], p);
        if (vis[b]) tmax = fmaxf(tmax, x[b]);
      }
      tmax = half_warp_max(tmax);
      const float mn = fmaxf(m[a], tmax);
      if (mn == -INFINITY) continue;  // the row has seen no key yet
      float sum = 0.0f, sum_pd = 0.0f;
#pragma unroll
      for (int b = 0; b < kR; ++b) {
        if (vis[b]) {
          const float e = expf(x[b] - mn);
          sum += e;
          sum_pd = fmaf(e, dp[a][b], sum_pd);
        }
      }
      const float corr = expf(m[a] - mn);
      l[a] = l[a] * corr + sum;
      pd[a] = pd[a] * corr + sum_pd;
      m[a] = mn;
    }
  }

  // each half warp owns rows ty + 16a: lse = m + log(sum p), D = sum p dP
  // / sum p (a row that saw no key: lse = +inf, D = 0)
#pragma unroll
  for (int a = 0; a < kR; ++a) {
    const int i = q0 + ty + 16 * a;
    const float lt = half_warp_sum(l[a]);
    const float dt = half_warp_sum(pd[a]);
    if (tx == 0 && i < p.s_len) {
      const size_t idx = static_cast<size_t>(bh) * p.s_len + i;
      const bool seen = m[a] != -INFINITY;
      lse[idx] = seen ? m[a] + logf(lt) : INFINITY;
      delta[idx] = seen ? dt / lt : 0.0f;
    }
  }
}

// ------------------------------------------------------------ (b) dk, dv
template <typename T, int DHP, bool kCap>
__global__ void __launch_bounds__(kThreads, Tile<DHP>::kMinBlocks)
    dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                const T* __restrict__ dout, const float* __restrict__ lse,
                const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                Params p) {
  constexpr int kT = Tile<DHP>::kT, kR = Tile<DHP>::kR, kLdp = Tile<DHP>::kLdp;
  constexpr int kLd = Tile<DHP>::kLd, kCols = Tile<DHP>::kCols;
  extern __shared__ float4 smem4[];
  float* s_k = reinterpret_cast<float*>(smem4);
  float* s_v = s_k + Tile<DHP>::kFloats;
  float* s_q = s_v + Tile<DHP>::kFloats;
  float* s_do = s_q + Tile<DHP>::kFloats;
  float* s_p = s_do + Tile<DHP>::kFloats;
  float* s_ds = s_p + kT * kLdp;
  float* s_lse = s_ds + kT * kLdp;
  float* s_dl = s_lse + kT;
  int* s_qp = reinterpret_cast<int*>(s_dl + kT);
  int* s_kp = s_qp + kT;

  const int bkv_count = p.batch * p.kv_heads;
  const int kt = static_cast<int>(blockIdx.x) / bkv_count;  // first keys meet the most queries
  const int bkv = static_cast<int>(blockIdx.x) % bkv_count;
  const int bb = bkv / p.kv_heads, kvh = bkv % p.kv_heads;
  const int rep = p.heads / p.kv_heads;
  const int k0 = kt * kT;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int dh4 = (p.dh + 3) & ~3;
  const size_t k_row0 = (static_cast<size_t>(bb) * p.sk_len * p.kv_heads + kvh) * p.dh;

  load_rows<T, DHP>(s_k, k + k_row0, k0, p.sk_len, p.kv_heads * p.dh, p.dh);
  load_rows<T, DHP>(s_v, v + k_row0, k0, p.sk_len, p.kv_heads * p.dh, p.dh);
  load_pos(s_kp, p.kpos, k0, p.sk_len, kT, -1);
  __syncthreads();
  const Range kr = range_of(s_kp, kT, true);

  float acc_k[kR][kCols], acc_v[kR][kCols];
#pragma unroll
  for (int b = 0; b < kR; ++b) {
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc_k[b][c] = acc_v[b][c] = 0.0f;
  }
  const int n_qt = (p.s_len + kT - 1) / kT;
  for (int r = 0; r < rep; ++r) {
    const int h = kvh * rep + r;
    const size_t q_row0 = (static_cast<size_t>(bb) * p.s_len * p.heads + h) * p.dh;
    const size_t stat0 = (static_cast<size_t>(bb) * p.heads + h) * p.s_len;
    for (int qt = 0; qt < n_qt; ++qt) {
      const int q0 = qt * kT;
      const int q_rows = min(kT, p.s_len - q0);
      __syncthreads();  // the previous tile's reads are done
      load_pos(s_qp, p.qpos, q0, p.s_len, kT, 0);
      load_stat(s_lse, lse + stat0, q0, p.s_len, kT, INFINITY);
      load_stat(s_dl, delta + stat0, q0, p.s_len, kT, 0.0f);
      __syncthreads();
      if (!tiles_meet(range_of(s_qp, q_rows, false), kr, p)) continue;
      load_rows<T, DHP>(s_q, q + q_row0, q0, p.s_len, p.heads * p.dh, p.dh);
      load_rows<T, DHP>(s_do, dout + q_row0, q0, p.s_len, p.heads * p.dh, p.dh);
      __syncthreads();
      float s[kR][kR], dp[kR][kR], pr[kR][kR], ds[kR][kR];
      dot_tile<DHP>(s_q, s_k, dh4, tx, ty, s);
      dot_tile<DHP>(s_do, s_v, dh4, tx, ty, dp);
      probs_and_grads<kR, kCap>(s, dp, s_qp, s_kp, s_lse, s_dl, q0, tx, ty, p, pr, ds);
#pragma unroll
      for (int a = 0; a < kR; ++a) {
#pragma unroll
        for (int b = 0; b < kR; ++b) {
          s_p[(ty + 16 * a) * kLdp + tx + 16 * b] = pr[a][b];
          s_ds[(ty + 16 * a) * kLdp + tx + 16 * b] = ds[a][b];
        }
      }
      __syncthreads();
      // dv[j] += sum_i P[i][j] do[i], dk[j] += sum_i dS[i][j] q[i]: keys
      // tx + 16b, columns 4 ty + 64 g + e
      for (int i = 0; i < q_rows; ++i) {
        float pj[kR], dj[kR];
#pragma unroll
        for (int b = 0; b < kR; ++b) {
          pj[b] = s_p[i * kLdp + tx + 16 * b];
          dj[b] = s_ds[i * kLdp + tx + 16 * b];
        }
#pragma unroll
        for (int g = 0; g < kCols / 4; ++g) {
          const float4 o4 = *reinterpret_cast<const float4*>(s_do + i * kLd + 4 * ty + 64 * g);
          const float4 q4 = *reinterpret_cast<const float4*>(s_q + i * kLd + 4 * ty + 64 * g);
#pragma unroll
          for (int b = 0; b < kR; ++b) {
            acc_v[b][4 * g + 0] = fmaf(pj[b], o4.x, acc_v[b][4 * g + 0]);
            acc_v[b][4 * g + 1] = fmaf(pj[b], o4.y, acc_v[b][4 * g + 1]);
            acc_v[b][4 * g + 2] = fmaf(pj[b], o4.z, acc_v[b][4 * g + 2]);
            acc_v[b][4 * g + 3] = fmaf(pj[b], o4.w, acc_v[b][4 * g + 3]);
            acc_k[b][4 * g + 0] = fmaf(dj[b], q4.x, acc_k[b][4 * g + 0]);
            acc_k[b][4 * g + 1] = fmaf(dj[b], q4.y, acc_k[b][4 * g + 1]);
            acc_k[b][4 * g + 2] = fmaf(dj[b], q4.z, acc_k[b][4 * g + 2]);
            acc_k[b][4 * g + 3] = fmaf(dj[b], q4.w, acc_k[b][4 * g + 3]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int b = 0; b < kR; ++b) {
    const int j = k0 + tx + 16 * b;
    if (j >= p.sk_len) continue;
    const size_t row = k_row0 + static_cast<size_t>(j) * p.kv_heads * p.dh;
#pragma unroll
    for (int g = 0; g < kCols / 4; ++g) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 4 * ty + 64 * g + e;
        if (c < p.dh) {
          dk[row + c] = from_f32<T>(acc_k[b][4 * g + e] * p.scale);
          dv[row + c] = from_f32<T>(acc_v[b][4 * g + e]);
        }
      }
    }
  }
}

// ------------------------------------------------------------------ (c) dq
template <typename T, int DHP, bool kCap>
__global__ void __launch_bounds__(kThreads, Tile<DHP>::kMinBlocks)
    dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              const T* __restrict__ dout, const float* __restrict__ lse,
              const float* __restrict__ delta, T* __restrict__ dq, Params p) {
  constexpr int kT = Tile<DHP>::kT, kR = Tile<DHP>::kR, kLdp = Tile<DHP>::kLdp;
  constexpr int kLd = Tile<DHP>::kLd, kCols = Tile<DHP>::kCols;
  extern __shared__ float4 smem4[];
  float* s_q = reinterpret_cast<float*>(smem4);
  float* s_do = s_q + Tile<DHP>::kFloats;
  float* s_k = s_do + Tile<DHP>::kFloats;
  float* s_v = s_k + Tile<DHP>::kFloats;
  float* s_ds = s_v + Tile<DHP>::kFloats;
  float* s_lse = s_ds + kT * kLdp;
  float* s_dl = s_lse + kT;
  int* s_qp = reinterpret_cast<int*>(s_dl + kT);
  int* s_kp = s_qp + kT;

  const int bh_count = p.batch * p.heads;
  const int n_qt = (p.s_len + kT - 1) / kT;
  const int qt = n_qt - 1 - static_cast<int>(blockIdx.x) / bh_count;  // longest first
  const int bh = static_cast<int>(blockIdx.x) % bh_count;
  const int bb = bh / p.heads, h = bh % p.heads;
  const int kvh = h / (p.heads / p.kv_heads);
  const int q0 = qt * kT;
  const int q_rows = min(kT, p.s_len - q0);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int dh4 = (p.dh + 3) & ~3;
  const size_t q_row0 = (static_cast<size_t>(bb) * p.s_len * p.heads + h) * p.dh;
  const size_t k_row0 = (static_cast<size_t>(bb) * p.sk_len * p.kv_heads + kvh) * p.dh;
  const size_t stat0 = static_cast<size_t>(bh) * p.s_len;

  load_rows<T, DHP>(s_q, q + q_row0, q0, p.s_len, p.heads * p.dh, p.dh);
  load_rows<T, DHP>(s_do, dout + q_row0, q0, p.s_len, p.heads * p.dh, p.dh);
  load_pos(s_qp, p.qpos, q0, p.s_len, kT, 0);
  load_stat(s_lse, lse + stat0, q0, p.s_len, kT, INFINITY);
  load_stat(s_dl, delta + stat0, q0, p.s_len, kT, 0.0f);
  __syncthreads();
  const Range qr = range_of(s_qp, q_rows, false);

  float acc[kR][kCols];
#pragma unroll
  for (int a = 0; a < kR; ++a) {
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[a][c] = 0.0f;
  }
  const int n_kt = (p.sk_len + kT - 1) / kT;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kT;
    __syncthreads();  // the previous tile's reads are done
    load_pos(s_kp, p.kpos, k0, p.sk_len, kT, -1);
    __syncthreads();
    if (!tiles_meet(qr, range_of(s_kp, kT, true), p)) continue;
    load_rows<T, DHP>(s_k, k + k_row0, k0, p.sk_len, p.kv_heads * p.dh, p.dh);
    load_rows<T, DHP>(s_v, v + k_row0, k0, p.sk_len, p.kv_heads * p.dh, p.dh);
    __syncthreads();
    float s[kR][kR], dp[kR][kR], pr[kR][kR], ds[kR][kR];
    dot_tile<DHP>(s_q, s_k, dh4, tx, ty, s);
    dot_tile<DHP>(s_do, s_v, dh4, tx, ty, dp);
    probs_and_grads<kR, kCap>(s, dp, s_qp, s_kp, s_lse, s_dl, q0, tx, ty, p, pr, ds);
#pragma unroll
    for (int a = 0; a < kR; ++a) {
#pragma unroll
      for (int b = 0; b < kR; ++b) s_ds[(ty + 16 * a) * kLdp + tx + 16 * b] = ds[a][b];
    }
    __syncthreads();
    // dq[i] += sum_j dS[i][j] k[j]: rows tx + 16a, columns 4 ty + 64 g + e
    const int k_rows = min(kT, p.sk_len - k0);
    for (int j = 0; j < k_rows; ++j) {
      float da[kR];
#pragma unroll
      for (int a = 0; a < kR; ++a) da[a] = s_ds[(tx + 16 * a) * kLdp + j];
#pragma unroll
      for (int g = 0; g < kCols / 4; ++g) {
        const float4 k4 = *reinterpret_cast<const float4*>(s_k + j * kLd + 4 * ty + 64 * g);
#pragma unroll
        for (int a = 0; a < kR; ++a) {
          acc[a][4 * g + 0] = fmaf(da[a], k4.x, acc[a][4 * g + 0]);
          acc[a][4 * g + 1] = fmaf(da[a], k4.y, acc[a][4 * g + 1]);
          acc[a][4 * g + 2] = fmaf(da[a], k4.z, acc[a][4 * g + 2]);
          acc[a][4 * g + 3] = fmaf(da[a], k4.w, acc[a][4 * g + 3]);
        }
      }
    }
  }
#pragma unroll
  for (int a = 0; a < kR; ++a) {
    const int i = tx + 16 * a;
    if (i >= q_rows) continue;
    const size_t row = q_row0 + static_cast<size_t>(q0 + i) * p.heads * p.dh;
#pragma unroll
    for (int g = 0; g < kCols / 4; ++g) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 4 * ty + 64 * g + e;
        if (c < p.dh) dq[row + c] = from_f32<T>(acc[a][4 * g + e] * p.scale);
      }
    }
  }
}

// ------------------------------------------------------------ launchers
template <typename K>
cudaError_t raise_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <typename T, int DHP, bool kCap>
int launch(const void* q, const void* k, const void* v, const void* dout, void* dq, void* dk,
           void* dv, float* lse, float* delta, const Params& p, cudaStream_t stream) {
  const T* tq = static_cast<const T*>(q);
  const T* tk = static_cast<const T*>(k);
  const T* tv = static_cast<const T*>(v);
  const T* tdo = static_cast<const T*>(dout);
  constexpr int kT = Tile<DHP>::kT;
  const unsigned n_qt = static_cast<unsigned>((p.s_len + kT - 1) / kT);
  const unsigned n_kt = static_cast<unsigned>((p.sk_len + kT - 1) / kT);
  const unsigned bh = static_cast<unsigned>(p.batch * p.heads);
  const unsigned bkv = static_cast<unsigned>(p.batch * p.kv_heads);

  auto stats = row_stats_kernel<T, DHP, kCap>;
  cudaError_t err = raise_smem(stats, smem_stats<DHP>());
  if (err != cudaSuccess) return static_cast<int>(err);
  stats<<<n_qt * bh, kThreads, smem_stats<DHP>(), stream>>>(tq, tk, tv, tdo, lse, delta, p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  auto kv = dkdv_kernel<T, DHP, kCap>;
  err = raise_smem(kv, smem_dkdv<DHP>());
  if (err != cudaSuccess) return static_cast<int>(err);
  kv<<<n_kt * bkv, kThreads, smem_dkdv<DHP>(), stream>>>(tq, tk, tv, tdo, lse, delta,
                                                         static_cast<T*>(dk),
                                                         static_cast<T*>(dv), p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  auto qk = dq_kernel<T, DHP, kCap>;
  err = raise_smem(qk, smem_dq<DHP>());
  if (err != cudaSuccess) return static_cast<int>(err);
  qk<<<n_qt * bh, kThreads, smem_dq<DHP>(), stream>>>(tq, tk, tv, tdo, lse, delta,
                                                      static_cast<T*>(dq), p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int DHP>
int launch_cap(const void* q, const void* k, const void* v, const void* dout, void* dq, void* dk,
               void* dv, float* lse, float* delta, const Params& p, cudaStream_t stream) {
  return p.cap != 0.0f ? launch<T, DHP, true>(q, k, v, dout, dq, dk, dv, lse, delta, p, stream)
                       : launch<T, DHP, false>(q, k, v, dout, dq, dk, dv, lse, delta, p, stream);
}

template <typename T>
int launch_dh(const void* q, const void* k, const void* v, const void* dout, void* dq, void* dk,
              void* dv, float* lse, float* delta, const Params& p, cudaStream_t stream) {
  if (p.dh <= 64) return launch_cap<T, 64>(q, k, v, dout, dq, dk, dv, lse, delta, p, stream);
  if (p.dh <= 128) return launch_cap<T, 128>(q, k, v, dout, dq, dk, dv, lse, delta, p, stream);
  return launch_cap<T, 256>(q, k, v, dout, dq, dk, dv, lse, delta, p, stream);
}

}  // namespace

// Plain C interface, loaded with ctypes. flash_attention_bwd enqueues the
// three kernels on `stream` and returns the first cudaGetLastError() that
// is not 0 (0 on success); it never synchronises and allocates nothing:
// lse and delta are (B, H, S) float32 scratch from the caller. The caller
// guarantees s, sk >= 1, b * h >= 1, 1 <= dh <= 256, h % kvh == 0,
// contiguous q, do, dq (B, S, H, dh) and k, v, dk, dv (B, Sk, KV, dh) of
// one type (bf16 when is_bf16, else float32), int32 positions, all on the
// current device (kernels/envelope.outside_flash_bwd_envelope).
extern "C" {

const char* flash_attention_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Dynamic shared memory of pass 0 (row statistics), 1 (dk, dv) or 2 (dq)
// at head width dh (0 outside 1..256): envelope.flash_bwd_smem_bytes.
int flash_attention_bwd_smem_bytes(int pass, int dh) {
  if (dh < 1 || dh > 256 || pass < 0 || pass > 2) return 0;
  if (dh <= 64) return pass == 0 ? smem_stats<64>() : pass == 1 ? smem_dkdv<64>() : smem_dq<64>();
  if (dh <= 128) {
    return pass == 0 ? smem_stats<128>() : pass == 1 ? smem_dkdv<128>() : smem_dq<128>();
  }
  return pass == 0 ? smem_stats<256>() : pass == 1 ? smem_dkdv<256>() : smem_dq<256>();
}

int flash_attention_bwd(const void* q, const void* k, const void* v, const void* dout,
                        const int* qpos, const int* kpos, void* dq, void* dk, void* dv,
                        float* lse, float* delta, int b, int s, int sk, int h, int kvh, int dh,
                        float scale, int causal, int window, float cap, int is_bf16,
                        void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Params p{qpos, kpos, b, s, sk, h, kvh, dh, causal, window, scale, cap};
  if (is_bf16) return launch_dh<__nv_bfloat16>(q, k, v, dout, dq, dk, dv, lse, delta, p, st);
  return launch_dh<float>(q, k, v, dout, dq, dk, dv, lse, delta, p, st);
}

}  // extern "C"

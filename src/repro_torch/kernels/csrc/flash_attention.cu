// Flash attention forward for Hopper (sm_90a), on the CUDA cores.
//
// Replaces (reference package): src/repro/kernels/flash_attention.py:74
// flash_attention_pallas, for float32 and for bf16 at head widths the
// tensor-core kernel (csrc/flash_attention_tc.cu) has no instantiation
// for (kernels/dispatch.py::resolve_flash). The LM's prefill attention
// (models/layers.py::attention) launches it once per layer on a CUDA
// tensor in float32 activations.
//
// What it computes, for q (B, S, H, dh), k/v (B, Sk, KV, dh), int32
// positions qpos (S,) and kpos (Sk,), query head h reading kv head
// h / (H / KV) (GQA; k and v are never repeated in memory):
//   s[i, j]  = (q_i . k_j) * scale          f32 accumulation, scale 1/sqrt(dh)
//   s[i, j]  = tanh(s / cap) * cap          when cap != 0
//   s[i, j]  = -1e30 where kpos_j < 0, or (causal) qpos_i - kpos_j < 0, or
//              (window > 0) qpos_i - kpos_j >= window
//   online softmax over kv tiles with the reference's guards: corr = 0
//   where m_prev <= -1e30, p = 0 where m_new <= -1e30; p is rounded to v's
//   type before P.V, which accumulates in f32; l sums the unrounded p;
//   out_i    = acc_i / max(l_i, 1e-30), in q's type (a fully masked row is 0).
// Inputs are float32 or bfloat16 (q, k, v, out of one type). Every product
// is a float32 FMA: no TF32, no bf16 products.
//
// Bound on an H100 SXM: operations. At musicgen-medium's prefill (B=4,
// S=2048, H=KV=24, dh=64, causal) the pairs a query sees are S(S+1)/2 per
// (b, h): 4 * B*H*dh * S(S+1)/2 = 5.2e10 flops, 0.77 ms at the 67 TFLOP/s
// of float32 FMAs outside the tensor cores, against 100 MB of q, k, v and
// out in float32 (30 us at 3.35 TB/s). Two more limits sit beside that
// one. An SMSP issues one warp instruction a clock and its FMA pipe takes
// one a clock, so every other instruction costs an FMA's slot. And an SM
// reads 32 words of shared memory a clock for 128 FMA lanes: a loop that
// loads more than 0.25 words per FMA a thread is bound by shared memory
// (a 4 x 4 tile read with scalar loads needs 0.5, an 8 x 4 one 0.375).
//
// Design. One block of 256 threads for each (q tile, batch*head); the TPU's
// sequential kv grid axis is a loop inside the block, with (m, l, acc) in
// registers. A row group of kLanes threads (tx = lane within it, ty = the
// group) owns kRows q rows; lane tx takes keys tx + kLanes j of each kv
// tile and output columns 4 tx + 4 kLanes g + {0..3}. Two layouts (the
// Layout structs below):
//   Narrow, dh <= 64: 256-row q tile, 64-key kv tile, 8 lanes a row group;
//     a thread keeps an 8 x 8 score tile and 8 rows x 8 columns of acc.
//     q is staged transposed (q^T, d-major), K row-major, so 4 d steps of
//     the score loop are 8 LDS.128 of K, 8 of q and 256 FMAs, and one key
//     of the P.V loop 2 LDS.128 of p, 2 of v and 64 FMAs: 0.25 words per
//     FMA in both.
//   Wide<DHP>, dh <= 128 and dh <= 256: 128- (64-) row q tile, 32-key kv
//     tile, 16 lanes a row group; q and K row-major.
// K rows are padded to DHP + 4 words, so the lanes reading consecutive
// keys at one d hit distinct bank quads. p goes to shared memory
// key-major (p^T, rows padded to BQ + 4), written and read by its own
// warp only (__syncwarp, no block barrier). K/V tiles are double-buffered:
// float32 at dh % 4 == 0 on 16-byte aligned operands copies them with
// cp.async (16 bytes, zero-filled past Sk) while the previous tile
// computes, one __syncthreads a tile; bf16 and other widths stage through
// registers. q is staged once, while the first tile copies. Tiles outside
// the block's live range are neither loaded nor visited. Inside it every
// warp classifies each tile for its own rows by warp votes over the key
// positions against its rows' min/max position, one tile ahead: fully
// masked (the warp skips it exactly: under the guards such a tile leaves
// (m, l, acc) as they were; in a causal prefill this is the upper half of
// the diagonal), fully visible (no mask arithmetic) or partial (the
// per-element rule). The softcap is a template switch. Exponentials: log2
// e is folded into the q scale (or applied after tanh), so a score costs
// one add and one ex2.approx.ftz (exp2f's own instruction without its
// subnormal path: a p below 2^-126, 1e-38 of a row's largest, is 0). The
// guards: corr = ex2(m_prev - m_new) is 0 when m_prev is -1e30 and m_new
// is not, and 1 when both are, where l and acc are still 0; p subtracts
// +1e30 instead of m_new on a row that has seen nothing, so every masked
// p is 0. acc is rescaled only when a row of the warp changed its
// maximum. Each thread keeps its share of the row sums l and reduces them
// across the row group once at the end (l is linear in the tiles and corr
// is the same on every lane of a row); the row maxima are reduced every
// tile. Ragged S and Sk are masked here (the Pallas kernel's S % q_block
// assert is a TPU tiling limit): rows past S are not written, keys past Sk
// read as kpos -1. Blocks start longest-first: the linear block index runs
// over every (batch, head) of the last q tile before the next one, so the
// short causal tiles fill the tail. The build has no fast-math: tanhf and
// the divisions are the accurate ones.
//
// Measured on an H100 SXM (tools/flash_f32_ab.py --fma-ceiling
// --profile): float32 FMAs in this arrangement (8 x 8 accumulators a
// thread, 256 threads) reach about 50 TFLOP/s fed from registers or by
// this loop's LDS.128 pattern, three quarters of the 67 peak, so about
// 1.0 ms is this call's practical floor; of the tile loop's clocks a warp,
// the score loop takes 42 %, p^T and P.V 39 %, issuing the copies 10 %,
// the softmax 7 % and classifying tiles 2 %; the barrier and the copies'
// wait are under 1 %.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#ifdef FLASH_PROFILE
// Per-phase clock64 sums over all warps of a launch, for
// tools/flash_f32_ab.py --profile (a build with -DFLASH_PROFILE only):
// [0] classifying tiles, [1] the copies' wait and the barrier, [2] issuing
// the copies, [3] the score loop, [4] the softmax, [5] p^T and P.V, [6]
// the prologue, [7] warps.
__device__ unsigned long long g_flash_profile[8];
#define FLASH_MARK(i)                          \
  {                                            \
    const unsigned long long c_ = clock64();   \
    prof_[i] += c_ - mark_;                    \
    mark_ = c_;                                \
  }
#else
#define FLASH_MARK(i)
#endif

namespace {

constexpr int kThreads = 256;
constexpr float kNeg = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kMasked = 0, kPartial = 1, kFull = 2;

// dh <= 64: q^T [64][BQ + 4], K [2][BK][64 + 4], V [2][BK][64],
// p^T [BK][BQ + 4].
struct Narrow {
  static constexpr int kDhp = 64, kLanes = 8, kRows = 8, kKeys = 8, kCols = 8;
  static constexpr int kBQ = 256, kBK = 64;  // kBQ == kThreads: a row a thread stages q
  static constexpr int kLdq = kBQ + 4, kLdk = kDhp + 4, kLdp = kBQ + 4;
  static constexpr int kQFloats = kDhp * kLdq, kKFloats = kBK * kLdk;
  static constexpr int kVFloats = kBK * kDhp, kPFloats = kBK * kLdp;
  __device__ static int row(int i, int ty) { return 8 * ty + i; }
  __device__ static int key(int j, int tx) { return tx + 8 * j; }
};

// 64 < dh <= DHP: q [BQ][DHP + 4], K [2][BK][DHP + 4], V [2][BK][DHP],
// p^T [BK][BQ + 4].
template <int DHP>
struct Wide {
  static constexpr int kDhp = DHP, kLanes = 16, kRows = DHP == 256 ? 4 : 8, kKeys = 2;
  static constexpr int kCols = DHP / 16, kBQ = 16 * kRows, kBK = 32;
  static constexpr int kLdq = DHP + 4, kLdk = DHP + 4, kLdp = kBQ + 4;
  static constexpr int kQFloats = kBQ * kLdq, kKFloats = kBK * kLdk;
  static constexpr int kVFloats = kBK * DHP, kPFloats = kBK * kLdp;
  __device__ static int row(int i, int ty) { return 64 * (i / 4) + 4 * ty + (i % 4); }
  __device__ static int key(int j, int tx) { return tx + 16 * j; }
};

// dynamic shared memory of a layout: the tiles, then the live tile range
template <typename L>
constexpr size_t smem_of() {
  return sizeof(float) * (static_cast<size_t>(L::kQFloats) + 2 * L::kKFloats +
                          2 * L::kVFloats + L::kPFloats) +
         2 * sizeof(int);
}

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

// 2^x, subnormal results flushed to 0 (MUFU.EX2 alone)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool fill) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = fill ? 16 : 0;  // 0: write zeros, read nothing
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

struct Params {
  const int* qpos;
  const int* kpos;
  int s_len, sk_len, heads, kv_heads, dh, causal, window;
  float scale, cap;
};

// The key positions of kv tile t a lane votes with (BK / 32 of them, -1
// past Sk).
template <int BK>
struct TileKeys {
  int kp[BK / 32];
};

template <int BK>
__device__ __forceinline__ TileKeys<BK> tile_keys(const Params& p, int t) {
  const int lane = threadIdx.x & 31;
  TileKeys<BK> keys;
#pragma unroll
  for (int u = 0; u < BK / 32; ++u) {
    const int key = t * BK + lane + 32 * u;
    keys.kp[u] = key < p.sk_len ? __ldg(p.kpos + key) : -1;
  }
  return keys;
}

// Kind of a kv tile for queries at positions in [qmin, qmax] (every lane
// of the warp gets it): masked when no key can be seen by any of them (a
// superset test), full when every key is seen by every one.
template <int BK>
__device__ __forceinline__ int kind_of(const Params& p, const TileKeys<BK>& keys, int qmin,
                                       int qmax) {
  bool live = false;
  bool full = true;
#pragma unroll
  for (int u = 0; u < BK / 32; ++u) {
    const int kp = keys.kp[u];
    bool lv = kp >= 0;
    bool fv = kp >= 0;
    if (p.causal) {
      lv = lv && kp <= qmax;
      fv = fv && kp <= qmin;
    }
    if (p.window > 0) {
      lv = lv && static_cast<int64_t>(qmin) - kp < p.window;
      fv = fv && static_cast<int64_t>(qmax) - kp < p.window;
    }
    live = live || lv;
    full = full && fv;
  }
  if (!__any_sync(0xffffffffu, live)) return kMasked;
  return __all_sync(0xffffffffu, full) ? kFull : kPartial;
}

// ------------------------------------------------------------ staging
// q once, scaled by qmul; rows past S and columns past dh are 0.
template <typename T, bool kAsync>
__device__ __forceinline__ void stage_q(Narrow, const T* q_base, int64_t q_stride, int q0,
                                        int rows, int dh, float qmul, float* s_q) {
  // q^T[d][r]: thread r reads its row (all loads in flight together) and
  // stores it down a column, the lanes on consecutive banks
  const int r = threadIdx.x;
  const T* src = q_base + (q0 + r) * q_stride;
  const bool in = r < rows;
  if constexpr (kAsync) {
    float4 x[Narrow::kDhp / 4];
#pragma unroll
    for (int c = 0; c < Narrow::kDhp / 4; ++c) {
      x[c] = in && 4 * c < dh ? __ldg(reinterpret_cast<const float4*>(src) + c)
                              : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
#pragma unroll
    for (int c = 0; c < Narrow::kDhp / 4; ++c) {
      s_q[(4 * c) * Narrow::kLdq + r] = x[c].x * qmul;
      s_q[(4 * c + 1) * Narrow::kLdq + r] = x[c].y * qmul;
      s_q[(4 * c + 2) * Narrow::kLdq + r] = x[c].z * qmul;
      s_q[(4 * c + 3) * Narrow::kLdq + r] = x[c].w * qmul;
    }
  } else {
#pragma unroll 16
    for (int d = 0; d < Narrow::kDhp; ++d) {
      s_q[d * Narrow::kLdq + r] = (in && d < dh ? to_f32(src[d]) : 0.0f) * qmul;
    }
  }
}

template <typename T, bool kAsync, int DHP>
__device__ __forceinline__ void stage_q(Wide<DHP>, const T* q_base, int64_t q_stride, int q0,
                                        int rows, int dh, float qmul, float* s_q) {
  using L = Wide<DHP>;
  for (int e = threadIdx.x; e < L::kBQ * DHP / 4; e += kThreads) {
    const int r = e / (DHP / 4);
    const int d = 4 * (e % (DHP / 4));
    float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (r < rows && d < dh) {
      const T* src = q_base + (q0 + r) * q_stride + d;
      if constexpr (kAsync) {
        x = __ldg(reinterpret_cast<const float4*>(src));
      } else {
        x.x = to_f32(src[0]);
        if (d + 1 < dh) x.y = to_f32(src[1]);
        if (d + 2 < dh) x.z = to_f32(src[2]);
        if (d + 3 < dh) x.w = to_f32(src[3]);
      }
    }
    x.x *= qmul;
    x.y *= qmul;
    x.z *= qmul;
    x.w *= qmul;
    *reinterpret_cast<float4*>(s_q + r * L::kLdq + d) = x;
  }
}

// Rows [BK][ld] of the tile at key k0 (K: ld = DHP + 4, V: ld = DHP):
// cp.async (16 bytes, zero past Sk) or through registers; columns past dh
// are never written.
template <typename T, bool kAsync, int DHP, int BK>
__device__ __forceinline__ void load_rows(const T* base, int64_t kv_stride, const Params& p,
                                          int k0, float* dst, int ld) {
#pragma unroll
  for (int u = 0; u < BK * DHP / 4 / kThreads; ++u) {
    const int e = static_cast<int>(threadIdx.x) + kThreads * u;
    const int r = e / (DHP / 4);
    const int d = 4 * (e % (DHP / 4));
    if (d >= p.dh) continue;
    const bool in = k0 + r < p.sk_len;
    const int64_t off = in ? (k0 + r) * kv_stride + d : 0;
    if constexpr (kAsync) {
      cp_async16(dst + r * ld + d, reinterpret_cast<const float*>(base) + off, in);
    } else {
      float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (in) {
        const T* src = base + off;
        x.x = to_f32(src[0]);
        if (d + 1 < p.dh) x.y = to_f32(src[1]);
        if (d + 2 < p.dh) x.z = to_f32(src[2]);
        if (d + 3 < p.dh) x.w = to_f32(src[3]);
      }
      *reinterpret_cast<float4*>(dst + r * ld + d) = x;
    }
  }
}

// kv tile tt into (kd, vd); with kAsync the copies are committed as one group
template <typename T, bool kAsync, typename L>
__device__ __forceinline__ void load_tile(const T* k_base, const T* v_base, int64_t kv_stride,
                                          const Params& p, int tt, float* kd, float* vd) {
  load_rows<T, kAsync, L::kDhp, L::kBK>(k_base, kv_stride, p, tt * L::kBK, kd, L::kLdk);
  load_rows<T, kAsync, L::kDhp, L::kBK>(v_base, kv_stride, p, tt * L::kBK, vd, L::kDhp);
  if constexpr (kAsync) cp_async_commit();
}

// K/V columns past dh stay 0 in both buffers (tile loads never write them)
template <typename L>
__device__ __forceinline__ void zero_pads(int dh, float* s_k, float* s_v) {
  for (int e = threadIdx.x; e < 2 * L::kBK * L::kDhp; e += kThreads) {
    const int r = e / L::kDhp;
    const int d = e % L::kDhp;
    if (d >= dh) {
      s_k[r * L::kLdk + d] = 0.0f;
      s_v[r * L::kDhp + d] = 0.0f;
    }
  }
}

// ------------------------------------------------------------ products
// s[i][j] = q_i . k_j over the padded width, one FMA chain per score in d
// order: q for 4 d first, then K in two halves of 4 keys
template <int R, int KC>
__device__ __forceinline__ void scores(Narrow, const float* s_q, const float* kb, int dh,
                                       int tx, int ty, float (&s)[R][KC]) {
  static_assert(R == 8 && KC == 8, "the Narrow tile is 8 x 8");
  const float* qr = s_q + 8 * ty;
  const float* kr = kb + tx * Narrow::kLdk;
  const int dq = (dh + 3) & ~3;
#pragma unroll 1
  for (int d = 0; d < dq; d += 4) {
    float qv[4][8];
#pragma unroll
    for (int dd = 0; dd < 4; ++dd) {
      const float4 qa = *reinterpret_cast<const float4*>(qr + (d + dd) * Narrow::kLdq);
      const float4 qb = *reinterpret_cast<const float4*>(qr + (d + dd) * Narrow::kLdq + 4);
      qv[dd][0] = qa.x; qv[dd][1] = qa.y; qv[dd][2] = qa.z; qv[dd][3] = qa.w;
      qv[dd][4] = qb.x; qv[dd][5] = qb.y; qv[dd][6] = qb.z; qv[dd][7] = qb.w;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float4 kf[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kf[j] = *reinterpret_cast<const float4*>(kr + 8 * (4 * h + j) * Narrow::kLdk + d);
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float& a = s[i][4 * h + j];
          a = fmaf(qv[0][i], kf[j].x, a);
          a = fmaf(qv[1][i], kf[j].y, a);
          a = fmaf(qv[2][i], kf[j].z, a);
          a = fmaf(qv[3][i], kf[j].w, a);
        }
      }
    }
  }
}

template <int DHP, int R, int KC>
__device__ __forceinline__ void scores(Wide<DHP>, const float* s_q, const float* kb, int,
                                       int tx, int ty, float (&s)[R][KC]) {
  using L = Wide<DHP>;
#pragma unroll 4
  for (int d = 0; d < DHP; d += 4) {
    float4 qf[R], kf[KC];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      qf[i] = *reinterpret_cast<const float4*>(s_q + L::row(i, ty) * L::kLdq + d);
    }
#pragma unroll
    for (int j = 0; j < KC; ++j) {
      kf[j] = *reinterpret_cast<const float4*>(kb + L::key(j, tx) * L::kLdk + d);
    }
#pragma unroll
    for (int i = 0; i < R; ++i) {
#pragma unroll
      for (int j = 0; j < KC; ++j) {
        s[i][j] = fmaf(qf[i].x, kf[j].x, s[i][j]);
        s[i][j] = fmaf(qf[i].y, kf[j].y, s[i][j]);
        s[i][j] = fmaf(qf[i].z, kf[j].z, s[i][j]);
        s[i][j] = fmaf(qf[i].w, kf[j].w, s[i][j]);
      }
    }
  }
}

// p^T[key][row] for this thread's rows and keys (its warp's rows only)
template <typename L, int R, int KC>
__device__ __forceinline__ void store_p(float* s_p, const float (&s)[R][KC], int tx, int ty) {
#pragma unroll
  for (int j = 0; j < KC; ++j) {
    const int kk = L::key(j, tx);
#pragma unroll
    for (int g = 0; g < R / 4; ++g) {
      *reinterpret_cast<float4*>(s_p + kk * L::kLdp + L::row(4 * g, ty)) =
          make_float4(s[4 * g][j], s[4 * g + 1][j], s[4 * g + 2][j], s[4 * g + 3][j]);
    }
  }
}

// acc[i][c] += p[i][kk] v[kk][column c] in key order; the columns of lane
// tx are 4 tx + 4 kLanes g + {0..3}
template <typename L, int R, int NC>
__device__ __forceinline__ void pv(const float* s_p, const float* vb, int tx, int ty,
                                   float (&acc)[R][NC]) {
  constexpr int kColStep = L::kLanes * 4;
#pragma unroll 8
  for (int kk = 0; kk < L::kBK; ++kk) {
    float4 pf[R / 4], vf[NC / 4];
#pragma unroll
    for (int g = 0; g < R / 4; ++g) {
      pf[g] = *reinterpret_cast<const float4*>(s_p + kk * L::kLdp + L::row(4 * g, ty));
    }
#pragma unroll
    for (int g = 0; g < NC / 4; ++g) {
      vf[g] = *reinterpret_cast<const float4*>(vb + kk * L::kDhp + kColStep * g + 4 * tx);
    }
#pragma unroll
    for (int g = 0; g < R / 4; ++g) {
      const float pr[4] = {pf[g].x, pf[g].y, pf[g].z, pf[g].w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
#pragma unroll
        for (int c = 0; c < NC / 4; ++c) {
          const int i = 4 * g + e;
          acc[i][4 * c] = fmaf(pr[e], vf[c].x, acc[i][4 * c]);
          acc[i][4 * c + 1] = fmaf(pr[e], vf[c].y, acc[i][4 * c + 1]);
          acc[i][4 * c + 2] = fmaf(pr[e], vf[c].z, acc[i][4 * c + 2]);
          acc[i][4 * c + 3] = fmaf(pr[e], vf[c].w, acc[i][4 * c + 3]);
        }
      }
    }
  }
}

// The online softmax of one tile's scores s (scaled, in log2 units unless
// the softcap comes first), with the per-element masks only on a partial
// tile. Leaves p (rounded to T) in s, rescales acc, updates m and this
// lane's share of l.
template <typename T, typename L, int R, int KC, int NC, bool kCap, bool kMask>
__device__ __forceinline__ void online_softmax(float (&s)[R][KC], float (&m)[R], float (&l)[R],
                                               float (&acc)[R][NC], const Params& p, int k0,
                                               int q0, int rows, int tx, int ty) {
  int kp[KC];
  int qp[R];
  if constexpr (kMask) {
#pragma unroll
    for (int j = 0; j < KC; ++j) {
      const int key = k0 + L::key(j, tx);
      kp[j] = key < p.sk_len ? __ldg(p.kpos + key) : -1;
    }
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int r = L::row(i, ty);
      qp[i] = r < rows ? __ldg(p.qpos + q0 + r) : 0;
    }
  }
  float corr[R];
  bool moved = false;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    float mt = kNeg;
#pragma unroll
    for (int j = 0; j < KC; ++j) {
      float x = s[i][j];
      if constexpr (kCap) x = tanhf(x / p.cap) * p.cap * kLog2e;
      if constexpr (kMask) {
        const int dpos = qp[i] - kp[j];
        bool ok = kp[j] >= 0;
        if (p.causal) ok = ok && dpos >= 0;
        if (p.window > 0) ok = ok && dpos < p.window;
        x = ok ? x : kNeg;
      }
      s[i][j] = x;
      mt = fmaxf(mt, x);
    }
    // the kLanes lanes of a row group are adjacent lanes of one warp
#pragma unroll
    for (int off = L::kLanes / 2; off > 0; off >>= 1) {
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
    }
    const float m_new = fmaxf(m[i], mt);
    corr[i] = ex2(m[i] - m_new);
    moved = moved || m_new != m[i];
    // a row that has seen no key subtracts +1e30: every p stays 0
    const float sub = m_new <= kNeg ? -kNeg : m_new;
    float sum = 0.0f;
#pragma unroll
    for (int j = 0; j < KC; ++j) {
      const float e = ex2(s[i][j] - sub);
      sum += e;
      s[i][j] = to_f32(from_f32<T>(e));  // p.astype(v.dtype) before P.V
    }
    m[i] = m_new;
    l[i] = l[i] * corr[i] + sum;
  }
  if (__any_sync(0xffffffffu, moved)) {
#pragma unroll
    for (int i = 0; i < R; ++i) {
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= corr[i];
    }
  }
}

// ------------------------------------------------------------ the kernel
template <typename T, typename L, bool kCap, bool kAsync>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, const Params p) {
  constexpr int R = L::kRows, KC = L::kKeys, NC = L::kCols, BQ = L::kBQ, BK = L::kBK;
  extern __shared__ __align__(16) float smem[];
  float* s_q = smem;
  float* s_k = s_q + L::kQFloats;              // 2 buffers
  float* s_v = s_k + 2 * L::kKFloats;          // 2 buffers
  float* s_p = s_v + 2 * L::kVFloats;
  int* s_range = reinterpret_cast<int*>(s_p + L::kPFloats);  // first, last live tile

#ifdef FLASH_PROFILE
  unsigned long long prof_[7] = {0, 0, 0, 0, 0, 0, 0};
  unsigned long long mark_ = clock64();
#endif
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int tx = tid % L::kLanes;
  const int ty = tid / L::kLanes;
  // blocks start in linear order (x fastest): the first B*H take every
  // head's last q tile, the longest under a causal mask, and so on down
  const int64_t lin = static_cast<int64_t>(blockIdx.y) * gridDim.x + blockIdx.x;
  const int tile = static_cast<int>(gridDim.x) - 1 - static_cast<int>(lin / gridDim.y);
  const int bh = static_cast<int>(lin % gridDim.y);
  const int q0 = tile * BQ;
  const int rows = min(BQ, p.s_len - q0);
  const int b = bh / p.heads;
  const int h = bh - b * p.heads;
  const int kvh = h / (p.heads / p.kv_heads);
  const int dh = p.dh;
  const int64_t q_stride = static_cast<int64_t>(p.heads) * dh;  // one position
  const int64_t kv_stride = static_cast<int64_t>(p.kv_heads) * dh;
  const T* q_base = q + (static_cast<int64_t>(b) * p.s_len * p.heads + h) * dh;
  const T* k_base = k + (static_cast<int64_t>(b) * p.sk_len * p.kv_heads + kvh) * dh;
  const T* v_base = v + (static_cast<int64_t>(b) * p.sk_len * p.kv_heads + kvh) * dh;
  T* o_base = out + (static_cast<int64_t>(b) * p.s_len * p.heads + h) * dh;

  // the block's and this warp's query positions (each warp reduces them)
  int qmin = INT_MAX, qmax = INT_MIN, wmin = INT_MAX, wmax = INT_MIN;
  for (int r = lane; r < rows; r += 32) {
    const int pos = __ldg(p.qpos + q0 + r);
    qmin = min(qmin, pos);
    qmax = max(qmax, pos);
  }
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = L::row(i, ty);
    if (r < rows) {
      const int pos = __ldg(p.qpos + q0 + r);
      wmin = min(wmin, pos);
      wmax = max(wmax, pos);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    qmin = min(qmin, __shfl_xor_sync(0xffffffffu, qmin, off));
    qmax = max(qmax, __shfl_xor_sync(0xffffffffu, qmax, off));
    wmin = min(wmin, __shfl_xor_sync(0xffffffffu, wmin, off));
    wmax = max(wmax, __shfl_xor_sync(0xffffffffu, wmax, off));
  }

  if (tid == 0) {
    s_range[0] = INT_MAX;
    s_range[1] = -1;
  }
  if (dh < L::kDhp) zero_pads<L>(dh, s_k, s_v);
  __syncthreads();

  const int n_tiles = (p.sk_len + BK - 1) / BK;
  {
    const int warp = tid >> 5;
    int first = INT_MAX;
    int last = -1;
    for (int t = warp; t < n_tiles; t += kThreads / 32) {
      if (kind_of<BK>(p, tile_keys<BK>(p, t), qmin, qmax) != kMasked) {
        first = min(first, t);
        last = t;
      }
    }
    if (lane == 0 && last >= 0) {
      atomicMin(&s_range[0], first);
      atomicMax(&s_range[1], last);
    }
  }
  __syncthreads();
  const int t_last = s_range[1];
  int t = s_range[0];

  float m[R], l[R], acc[R][NC];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    m[i] = kNeg;
    l[i] = 0.0f;  // this lane's share of the row sum
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.0f;
  }

  int buf = 0;
  int kind = kMasked;  // of tile t for this warp's rows
  if (t <= t_last) {
    load_tile<T, kAsync, L>(k_base, v_base, kv_stride, p, t, s_k, s_v);
    kind = kind_of<BK>(p, tile_keys<BK>(p, t), wmin, wmax);
  }
  // q once, scaled (log2 e folded in unless a softcap comes first), while
  // the first tile copies; the loop's first barrier publishes both
  stage_q<T, kAsync>(L{}, q_base, q_stride, q0, rows, dh, kCap ? p.scale : p.scale * kLog2e,
                     s_q);
  TileKeys<BK> ahead = tile_keys<BK>(p, t + 1);  // read one tile ahead
  FLASH_MARK(6)
  while (t <= t_last) {
    // the next tile any warp needs, and its kind for this warp
    int tn = t + 1;
    TileKeys<BK> keys = ahead;
    while (tn <= t_last && kind_of<BK>(p, keys, qmin, qmax) == kMasked) {
      keys = tile_keys<BK>(p, ++tn);
    }
    const int kind_n = tn <= t_last ? kind_of<BK>(p, keys, wmin, wmax) : kMasked;
    FLASH_MARK(0)
    if constexpr (kAsync) cp_async_wait_all();
    // tile t is in place; every warp is done with buffer buf ^ 1
    __syncthreads();
    FLASH_MARK(1)
    if (tn <= t_last) {
      load_tile<T, kAsync, L>(k_base, v_base, kv_stride, p, tn, s_k + (buf ^ 1) * L::kKFloats,
                              s_v + (buf ^ 1) * L::kVFloats);
    }
    ahead = tile_keys<BK>(p, tn + 1);  // lands while this tile computes
    FLASH_MARK(2)
    if (kind != kMasked) {
      float s[R][KC];
#pragma unroll
      for (int i = 0; i < R; ++i) {
#pragma unroll
        for (int j = 0; j < KC; ++j) s[i][j] = 0.0f;
      }
      scores(L{}, s_q, s_k + buf * L::kKFloats, dh, tx, ty, s);
      FLASH_MARK(3)
      if (kind == kPartial) {
        online_softmax<T, L, R, KC, NC, kCap, true>(s, m, l, acc, p, t * BK, q0, rows, tx, ty);
      } else {
        online_softmax<T, L, R, KC, NC, kCap, false>(s, m, l, acc, p, t * BK, q0, rows, tx, ty);
      }
      FLASH_MARK(4)
      __syncwarp();  // the warp's previous reads of p^T are done
      store_p<L>(s_p, s, tx, ty);
      __syncwarp();
      pv<L>(s_p, s_v + buf * L::kVFloats, tx, ty, acc);
      FLASH_MARK(5)
    }
    t = tn;
    kind = kind_n;
    buf ^= 1;
  }

#ifdef FLASH_PROFILE
  if (lane == 0) {
    for (int i = 0; i < 7; ++i) atomicAdd(&g_flash_profile[i], prof_[i]);
    atomicAdd(&g_flash_profile[7], 1ull);
  }
#endif
  constexpr int kColStep = L::kLanes * 4;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    float li = l[i];
#pragma unroll
    for (int off = L::kLanes / 2; off > 0; off >>= 1) {
      li += __shfl_xor_sync(0xffffffffu, li, off);
    }
    const int r = L::row(i, ty);
    if (r >= rows) continue;
    const float denom = fmaxf(li, 1e-30f);
    T* dst = o_base + (q0 + r) * q_stride;
#pragma unroll
    for (int g = 0; g < NC / 4; ++g) {
      const int c = kColStep * g + 4 * tx;
      if constexpr (kAsync) {
        if (c < dh) {
          *reinterpret_cast<float4*>(dst + c) =
              make_float4(acc[i][4 * g] / denom, acc[i][4 * g + 1] / denom,
                          acc[i][4 * g + 2] / denom, acc[i][4 * g + 3] / denom);
        }
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (c + e < dh) dst[c + e] = from_f32<T>(acc[i][4 * g + e] / denom);
        }
      }
    }
  }
}

// ------------------------------------------------------------ launchers
int smem_bytes(int dh) {
  if (dh < 1 || dh > 256) return 0;
  if (dh <= 64) return static_cast<int>(smem_of<Narrow>());
  if (dh <= 128) return static_cast<int>(smem_of<Wide<128>>());
  return static_cast<int>(smem_of<Wide<256>>());
}

template <typename T, typename L, bool kCap, bool kAsync>
int launch(const void* q, const void* k, const void* v, void* out, int b, const Params& p,
           cudaStream_t stream) {
  auto kernel = flash_attention_kernel<T, L, kCap, kAsync>;
  constexpr size_t kBytes = smem_of<L>();
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(kBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((p.s_len + L::kBQ - 1) / L::kBQ),
                  static_cast<unsigned>(b * p.heads));
  kernel<<<grid, kThreads, kBytes, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                             static_cast<const T*>(v), static_cast<T*>(out), p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename L>
int launch_cap(const void* q, const void* k, const void* v, void* out, int b, const Params& p,
               bool vec, cudaStream_t stream) {
  if constexpr (sizeof(T) == sizeof(float)) {
    if (vec) {
      return p.cap != 0.0f ? launch<T, L, true, true>(q, k, v, out, b, p, stream)
                           : launch<T, L, false, true>(q, k, v, out, b, p, stream);
    }
  }
  return p.cap != 0.0f ? launch<T, L, true, false>(q, k, v, out, b, p, stream)
                       : launch<T, L, false, false>(q, k, v, out, b, p, stream);
}

template <typename T>
int launch_dh(const void* q, const void* k, const void* v, void* out, int b, const Params& p,
              bool vec, cudaStream_t stream) {
  if (p.dh <= 64) return launch_cap<T, Narrow>(q, k, v, out, b, p, vec, stream);
  if (p.dh <= 128) return launch_cap<T, Wide<128>>(q, k, v, out, b, p, vec, stream);
  return launch_cap<T, Wide<256>>(q, k, v, out, b, p, vec, stream);
}

bool aligned16(const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; }

}  // namespace

// Plain C interface, loaded with ctypes. The launcher enqueues one kernel on
// `stream` and returns cudaGetLastError() (0 on success); it never
// synchronises and allocates nothing. The caller guarantees s >= 1,
// b * h >= 1, 1 <= dh <= 256, h % kvh == 0, contiguous operands of one type
// (bf16 when is_bf16, else float32) and int32 positions on the current
// device, and the envelope (kernels/envelope.py). float32 operands at
// dh % 4 == 0 whose bases are 16-byte aligned take the cp.async
// instantiation, any others the one that stages through registers.
extern "C" {

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

#ifdef FLASH_PROFILE
int flash_attention_profile(unsigned long long* out, int reset) {
  if (reset) {
    const unsigned long long zero[8] = {0, 0, 0, 0, 0, 0, 0, 0};
    return static_cast<int>(cudaMemcpyToSymbol(g_flash_profile, zero, sizeof(zero)));
  }
  return static_cast<int>(cudaMemcpyFromSymbol(out, g_flash_profile, sizeof(g_flash_profile)));
}
#endif

// Dynamic shared memory one block asks for at head width dh (0 outside
// 1..256): envelope.flash_smem_bytes.
int flash_attention_smem_bytes(int dh) { return smem_bytes(dh); }

int flash_attention(const void* q, const void* k, const void* v, const int* qpos,
                    const int* kpos, void* out, int b, int s, int sk, int h, int kvh, int dh,
                    float scale, int causal, int window, float cap, int is_bf16,
                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Params p{qpos, kpos, s, sk, h, kvh, dh, causal, window, scale, cap};
  if (is_bf16) return launch_dh<__nv_bfloat16>(q, k, v, out, b, p, false, st);
  const bool vec = dh % 4 == 0 && aligned16(q) && aligned16(k) && aligned16(v) && aligned16(out);
  return launch_dh<float>(q, k, v, out, b, p, vec, st);
}

}  // extern "C"

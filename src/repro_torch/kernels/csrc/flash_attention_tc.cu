// Flash attention forward for Hopper (sm_90a) on the tensor cores: bf16
// operands, wgmma products, K/V tiles brought in by TMA.
//
// Replaces (reference package): src/repro/kernels/flash_attention.py:74
// flash_attention_pallas, for bf16 at the head widths of the repo's
// attention configs (64, 96, 112, 128, 256). Float32, and bf16 at any other
// width, run the CUDA-core kernel (csrc/flash_attention.cu); the route is
// chosen by kernels/dispatch.py::resolve_flash.
//
// What it computes, for q (B, S, H, dh), k/v (B, Sk, KV, dh) bf16, int32
// positions qpos (S,) and kpos (Sk,), query head h reading kv head
// h / (H / KV) (GQA; k and v are never repeated in memory):
//   s[i, j]  = (q_i . k_j) * scale          f32 accumulation, scale 1/sqrt(dh)
//   s[i, j]  = tanh(s / cap) * cap          when cap != 0
//   s[i, j]  = -1e30 where kpos_j < 0, or (causal) qpos_i - kpos_j < 0, or
//              (window > 0) qpos_i - kpos_j >= window
//   online softmax over kv tiles with the reference's guards: corr = 0
//   where m_prev <= -1e30, p = 0 where m_new <= -1e30; p is rounded to
//   bf16 before P.V, which accumulates in f32; l sums the unrounded f32 p;
//   out_i    = acc_i / max(l_i, 1e-30) in bf16 (a fully masked row is 0).
// The scale, softcap and masks are applied in this order in f32 on the
// accumulator fragments, as the reference does, with tanhf and no fast
// math. The softmax runs in log2 units: log2(e) is folded into the scale,
// x = s * scale * log2(e) (after the softcap, in natural units, where
// there is one), m is the running max of x and p = exp2f(x - m), which is
// exp(s * scale - m_natural) up to one rounding of the argument (relative
// 2^-24 of it, about 1e-6 of p at the scores' range) and exp2f's 2 ulps.
// On a tile with neither softcap nor per-element masks the row max is taken
// on the raw scores (the positive factor keeps their order) and each p is
// one fma and one ex2. The guards are the reference's (corr = 0 where the
// old max is <= -1e30, p = 0 where the new one is), read in log2 units:
// they differ only for a row whose largest score lies in (-1e30, -6.9e29].
// Measured on the card (chip_smoke.py) every bf16 case stays at the share
// of the limit that expf gave (0.400 at musicgen's call). l sums the f32 p
// in four partial sums per row; only the order of the f32 sums differs
// from the reference.
//
// Design. A block of 384 threads owns a (128-row q tile, batch*head): two
// consumer warpgroups of 64 rows each (wgmma takes 64 rows) and a producer
// warpgroup, of which one warp works. setmaxnreg moves registers from the
// producer (40 a thread, 24 at dh = 256) to the consumers (232, 240 at
// dh = 256) inside the block's 168 x 384 allocation; the launcher refuses a
// build whose count at entry is smaller, which would leave the consumers
// waiting. The producer loads the q tile once by TMA and walks the kv
// tiles, reading the key positions of 256 keys at a time: for each tile it
// decides from the q tile's min/max query position whether any query can
// see any key (a conservative test: a tile no query sees leaves
// (m, l, acc) as they were under the reference's guards, so skipping it is
// exact) and whether every query sees every key (then no per-element mask
// is needed); only a visible tile waits for a free stage of the K/V ring,
// gets its positions and flag written beside it and its K and V loads
// issued by TMA, tracked by one mbarrier per stage (full: bytes arrived;
// empty: the eight consumer warps are done). A sentinel tile index ends
// the walk. Each consumer warpgroup runs S = Q.K^T with wgmma.m64nNk16 (Q
// resident in shared memory as A, K the K-major B operand, both under the
// 128-byte swizzle the TMA maps write), applies scale, softcap and masks on
// the accumulator fragment (the softcap and the masks are template
// switches, chosen per tile), takes row max and row sum over the 4 threads
// of a quad (__shfl_xor_sync 1 and 2), packs p to bf16 pairs in registers
// and runs O += P.V with the register-A form of wgmma, V the MN-major B
// operand (the transpose bit), one 64-column chunk of the output per
// instruction. acc stays in registers across kv tiles. The two products
// of neighbouring tiles overlap: a turn issues S of tile t and P.V of tile
// t-1, waits for S alone, runs the softmax of t while P.V of t-1 is still
// on the tensor cores, then waits for it, rescales acc by corr and packs
// p of t. The two warpgroups take turns to issue their products (named
// barriers 1 and 2), so one's softmax runs under the other's products.
//
// TMA maps are 4-D, (dh, heads, S, B) for q and (dh, KV, Sk, B) for k and
// v, so rows past S or Sk inside a batch read as zeros (keys past Sk also
// carry position -1 in the producer's copy), never the next batch's rows.
// Under the 128-byte swizzle a box is at most 64 bf16 wide, so a row of dh
// columns loads as ceil(dh / 64) column boxes (columns past dh read as
// zeros; the products skip the k-steps past dh and the epilogue drops the
// output columns past it). The maps are built on the host per call with
// cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPoint so the
// library needs no -lcuda, and passed as __grid_constant__ parameters.
// q tiles are issued last-first, so the long causal rows start first.
//
// Tiles, per head width (BQ query rows, BK keys a kv tile, a ring of st
// K/V stages; dynamic shared memory with 1 KB of alignment slack;
// kernels/envelope.py::flash_tc_smem_bytes):
//   dh 64:          BQ 128, BK 128, st 3, 117,328 bytes
//   dh 96/112/128:  BQ 128, BK 128, st 2, 165,944 bytes (dh padded to 128)
//   dh 256:         BQ 128, BK  64, st 2, 198,200 bytes
// A consumer thread holds acc (dh_padded / 2 floats), the score tile
// (BK / 2 floats) and the packed p (BK / 4 words); ptxas -v reports 0
// spills for all five widths.
//
// Bound on an H100 SXM, the largest of three times. Tensor cores: 4 flops
// per (query, key) pair per head column, 5.2e10 at musicgen-medium's
// prefill (B=4, S=2048, H=KV=24, dh=64, causal: 2.0e8 visible pairs), 52 us
// at 989 TFLOP/s. Exponentials: one ex2 per visible pair on the
// special-function units, 16 a clock on each of 132 SMs (about 4.2e12 a
// second at 1.98 GHz), 48 us for the same call. HBM: q, k, v and out once,
// 100 MB, 30 us at 3.35 TB/s. So the tensor cores and the ex2 floor bind
// together at dh = 64; at larger dh the tensor cores bind alone. The
// softmax's other float32 work (scale, max, subtraction, sums, rescale,
// packing) shares the issue slots with the ex2s and is what this design
// leaves on the critical path.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kConsumerWarps = 8;                    // two warpgroups
constexpr int kThreads = 32 * kConsumerWarps + 128;  // + the producer warpgroup
constexpr float kNeg = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;        // exp(y) = exp2(y log2(e))

template <int DH>
struct Cfg {
  static constexpr int kChunks = (DH + 63) / 64;     // 64-column boxes
  static constexpr int kBQ = 128;
  static constexpr int kBK = DH > 128 ? 64 : 128;
  static constexpr int kStages = DH <= 64 ? 3 : 2;   // K/V ring
  static constexpr int kScanTiles = 256 / kBK;       // kv tiles tested at once
  // setmaxnreg, per thread: 128 x producer + 256 x consumer = 64,512, the
  // block's allocation at 168 a thread. dh = 256 needs 240 in a consumer.
  static constexpr int kProducerRegs = DH > 128 ? 24 : 40;
  static constexpr int kConsumerRegs = DH > 128 ? 240 : 232;
  static constexpr int kSR = kBK / 2;                // score floats / thread
  static constexpr int kChunkQ = kBQ * 128;          // bytes of one box
  static constexpr int kChunkKV = kBK * 128;
  static constexpr int kStageBytes = kChunks * kChunkKV;   // K or V
  static constexpr int kOffK = kChunks * kChunkQ;
  static constexpr int kOffV = kOffK + kStages * kStageBytes;
  static constexpr int kOffKpos = kOffV + kStages * kStageBytes;
  static constexpr int kOffTile = kOffKpos + kStages * kBK * 4;
  static constexpr int kOffBar = kOffTile + kStages * 8;
  static constexpr int kBytes = kOffBar + (1 + 2 * kStages) * 8 + 1024;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory matrix descriptor, 128-byte swizzle. Byte offsets:
// lbo between 64-wide atoms along the strided dimension where the layout
// uses it, sbo between groups of 8 rows (1024 bytes under this swizzle).
__device__ __forceinline__ uint64_t make_desc(uint32_t saddr, uint32_t lbo, uint32_t sbo) {
  uint64_t d = static_cast<uint64_t>((saddr & 0x3FFFFu) >> 4);
  d |= static_cast<uint64_t>((lbo >> 4) & 0x3FFFu) << 16;
  d |= static_cast<uint64_t>((sbo >> 4) & 0x3FFFu) << 32;
  d |= static_cast<uint64_t>(1) << 62;
  return d;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keep the compiler from moving reads or writes of wgmma registers across
// the fence, commit and wait above.
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void pin(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// S (+)= A.B, A (64 x 16) and B (N x 16) K-major in shared memory; N = 64
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// S (+)= A.B, A (64 x 16) and B (N x 16) K-major in shared memory; N = 128
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D += A.B, A (64 x 16) bf16 in registers, B (16 x N) MN-major in shared
// memory (the transpose bit); N = 64
__device__ __forceinline__ void wgmma_rs_n64_tb(float (&d)[32], const uint32_t (&a)[4],
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// S = Q.K^T for one 64-row warpgroup tile over the k-steps inside dh: Q
// (A) and K (B) K-major under the 128-byte swizzle, 64 columns a box.
template <int DH>
__device__ __forceinline__ void issue_qk(float (&s)[Cfg<DH>::kSR], uint32_t q_addr,
                                         uint32_t k_addr) {
  using C = Cfg<DH>;
#pragma unroll
  for (int c = 0; c < C::kChunks; ++c) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if (64 * c + 16 * kk < DH) {
        const uint64_t da = make_desc(q_addr + c * C::kChunkQ + 32 * kk, 16, 1024);
        const uint64_t db = make_desc(k_addr + c * C::kChunkKV + 32 * kk, 16, 1024);
        if constexpr (C::kBK == 128) {
          wgmma_ss_n128(s, da, db, (c | kk) != 0);
        } else {
          wgmma_ss_n64(s, da, db, (c | kk) != 0);
        }
      }
    }
  }
}

// O += P.V: P from registers (A), V MN-major (B, transposed), one 64-column
// output box per instruction.
template <class C>
__device__ __forceinline__ void issue_pv(float (&acc)[C::kChunks][32],
                                         const uint32_t (&pa)[C::kBK / 16][4], uint32_t v_addr) {
#pragma unroll
  for (int j = 0; j < C::kBK / 16; ++j) {
#pragma unroll
    for (int c = 0; c < C::kChunks; ++c) {
      wgmma_rs_n64_tb(acc[c], pa[j], make_desc(v_addr + c * C::kChunkKV + j * 2048, 1024, 1024));
    }
  }
}

// Scale, softcap and masks on one score tile in the accumulator fragment
// (value i: row (i >> 1) & 1 of the thread's two, key
// (i >> 2) * 8 + 2 * (lane & 3) + (i & 1)), the row max over the quad, the
// reference's guards; s becomes the unrounded p, m and l move on, corr is
// what acc must be scaled by. The softcap and the per-element masks are
// template switches, so the unrolled loop carries no per-element test the
// compiler could turn into work done for every element.
template <class C, bool kCap, bool kMask>
__device__ __forceinline__ void softmax_tile(float (&s)[C::kSR], float (&m)[2], float (&l)[2],
                                             float (&corr)[2], const int (&qp)[2],
                                             const int* kp_s, int lane, float scale, int causal,
                                             int window, float cap) {
  // Scores in log2 units, x = s * scale * log2(e) (after the softcap where
  // there is one), so p = exp2(x - m). Without softcap and masks the row
  // max is taken on the raw scores (scale * log2(e) > 0 keeps the order)
  // and each p is one fma and one ex2.
  const float scale2 = scale * kLog2e;
  float mx[2][4];                  // four partial maxima and sums per row
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int u = 0; u < 4; ++u) mx[r][u] = kNeg;
  }
#pragma unroll
  for (int i = 0; i < C::kSR; ++i) {
    const int r = (i >> 1) & 1;
    float x = s[i];
    if (kCap || kMask) {
      x *= scale;
      if (kCap) x = tanhf(x / cap) * cap;
      x *= kLog2e;
      if (kMask) {
        const int kpj = kp_s[(i >> 2) * 8 + (lane & 3) * 2 + (i & 1)];
        const int dpos = qp[r] - kpj;
        bool ok = kpj >= 0;
        if (causal) ok = ok && dpos >= 0;
        if (window > 0) ok = ok && dpos < window;
        x = ok ? x : kNeg;
      }
      s[i] = x;
    }
    mx[r][(i >> 2) & 3] = fmaxf(mx[r][(i >> 2) & 3], x);
  }
  float sub[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float row = fmaxf(fmaxf(mx[r][0], mx[r][1]), fmaxf(mx[r][2], mx[r][3]));
    row = fmaxf(row, __shfl_xor_sync(0xffffffffu, row, 1));
    row = fmaxf(row, __shfl_xor_sync(0xffffffffu, row, 2));
    if (!(kCap || kMask)) row *= scale2;
    const float m_new = fmaxf(m[r], row);
    corr[r] = m[r] <= kNeg ? 0.0f : exp2f(m[r] - m_new);
    // the p = 0 guard of a row with no visible key: x - inf is -inf
    sub[r] = m_new <= kNeg ? __int_as_float(0x7f800000) : m_new;
    m[r] = m_new;
  }
  float sum[2][4] = {};
#pragma unroll
  for (int i = 0; i < C::kSR; ++i) {
    const int r = (i >> 1) & 1;
    const float p = (kCap || kMask) ? exp2f(s[i] - sub[r]) : exp2f(fmaf(s[i], scale2, -sub[r]));
    sum[r][(i >> 2) & 3] += p;                       // l sums the unrounded p
    s[i] = p;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] = l[r] * corr[r] + ((sum[r][0] + sum[r][1]) + (sum[r][2] + sum[r][3]));
  }
}

template <class C>
__device__ __forceinline__ void softmax_any(float (&s)[C::kSR], float (&m)[2], float (&l)[2],
                                            float (&corr)[2], const int (&qp)[2],
                                            const int* kp_s, bool all_seen, int lane,
                                            float scale, int causal, int window, float cap) {
  if (cap != 0.0f) {
    if (all_seen) {
      softmax_tile<C, true, false>(s, m, l, corr, qp, kp_s, lane, scale, causal, window, cap);
    } else {
      softmax_tile<C, true, true>(s, m, l, corr, qp, kp_s, lane, scale, causal, window, cap);
    }
  } else if (all_seen) {
    softmax_tile<C, false, false>(s, m, l, corr, qp, kp_s, lane, scale, causal, window, cap);
  } else {
    softmax_tile<C, false, true>(s, m, l, corr, qp, kp_s, lane, scale, causal, window, cap);
  }
}

// p to bf16 pairs: the accumulator fragment of keys 16j..16j+15 is the A
// fragment of the j-th k-step of P.V.
template <class C>
__device__ __forceinline__ void pack_p(uint32_t (&pa)[C::kBK / 16][4], const float (&s)[C::kSR]) {
#pragma unroll
  for (int j = 0; j < C::kBK / 16; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) pa[j][e] = pack_bf16(s[8 * j + 2 * e], s[8 * j + 2 * e + 1]);
  }
}

template <int DH>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_tc_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          const int* __restrict__ qpos, const int* __restrict__ kpos,
                          __nv_bfloat16* __restrict__ out, int s_len, int sk_len, int heads,
                          int kv_heads, float scale, int causal, int window, float cap) {
  using C = Cfg<DH>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;      // swizzle atoms: 1 KB
  uint8_t* smem = smem_raw + (base - raw);
  int* s_kpos = reinterpret_cast<int*>(smem + C::kOffKpos);   // [stage][BK]
  int* s_tile = reinterpret_cast<int*>(smem + C::kOffTile);   // [stage]{tile, all seen}
  const uint32_t bar_q = base + C::kOffBar;
  auto bar_full = [&](int st) { return bar_q + 8u * (1 + st); };
  auto bar_empty = [&](int st) { return bar_q + 8u * (1 + C::kStages + st); };

  const int tile = static_cast<int>(gridDim.x) - 1 - static_cast<int>(blockIdx.x);
  const int q0 = tile * C::kBQ;
  const int b = static_cast<int>(blockIdx.y) / heads;
  const int h = static_cast<int>(blockIdx.y) - b * heads;
  const int kvh = h / (heads / kv_heads);
  const int warp = static_cast<int>(threadIdx.x) >> 5;
  const int lane = static_cast<int>(threadIdx.x) & 31;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int st = 0; st < C::kStages; ++st) {
      mbar_init(bar_full(st), 1);
      mbar_init(bar_empty(st), kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= kConsumerWarps) {
    // ------------------------------------------------------------ producer
    // The producer warpgroup hands its registers to the consumers; one
    // warp of it works, the other three leave.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(C::kProducerRegs));
    if (warp != kConsumerWarps) return;
    if (lane == 0) {
      mbar_expect_tx(bar_q, C::kChunks * C::kChunkQ);
#pragma unroll
      for (int c = 0; c < C::kChunks; ++c) {
        tma_load_4d(base + c * C::kChunkQ, &tm_q, bar_q, 64 * c, h, q0, b);
      }
    }
    const int rows = min(C::kBQ, s_len - q0);
    int qmin = INT_MAX;
    int qmax = INT_MIN;
    for (int r = lane; r < rows; r += 32) {
      const int p = __ldg(qpos + q0 + r);
      qmin = min(qmin, p);
      qmax = max(qmax, p);
    }
    qmin = __reduce_min_sync(0xffffffffu, qmin);
    qmax = __reduce_max_sync(0xffffffffu, qmax);

    const int n_tiles = (sk_len + C::kBK - 1) / C::kBK;
    int stage = 0;
    int phase = 0;
    for (int t0 = 0; t0 < n_tiles; t0 += C::kScanTiles) {
      // the key positions of 256 keys are read at once (coalesced, BK / 32
      // a lane per tile), so a run of tiles no query sees costs one round
      // trip to memory per group, not one per tile
      int kp[C::kScanTiles][C::kBK / 32];
#pragma unroll
      for (int g = 0; g < C::kScanTiles; ++g) {
#pragma unroll
        for (int e = 0; e < C::kBK / 32; ++e) {
          const int j = (t0 + g) * C::kBK + lane + 32 * e;
          kp[g][e] = j < sk_len ? __ldg(kpos + j) : -1;
        }
      }
#pragma unroll
      for (int g = 0; g < C::kScanTiles; ++g) {
        if (t0 + g >= n_tiles) break;
        bool seen = false;
        bool all_seen = true;
#pragma unroll
        for (int e = 0; e < C::kBK / 32; ++e) {
          bool any = kp[g][e] >= 0;
          bool all = kp[g][e] >= 0;
          if (causal) {
            any = any && kp[g][e] <= qmax;
            all = all && kp[g][e] <= qmin;
          }
          if (window > 0) {
            any = any && static_cast<long long>(qmin) - kp[g][e] < window;
            all = all && static_cast<long long>(qmax) - kp[g][e] < window;
          }
          seen = seen || any;
          all_seen = all_seen && all;
        }
        if (!__any_sync(0xffffffffu, seen)) continue;
        all_seen = __all_sync(0xffffffffu, all_seen);
        mbar_wait(bar_empty(stage), phase ^ 1);
#pragma unroll
        for (int e = 0; e < C::kBK / 32; ++e) s_kpos[stage * C::kBK + lane + 32 * e] = kp[g][e];
        if (lane == 0) {
          s_tile[2 * stage] = t0 + g;
          s_tile[2 * stage + 1] = all_seen ? 1 : 0;
        }
        __syncwarp();
        if (lane == 0) {
          const int k0 = (t0 + g) * C::kBK;
          mbar_expect_tx(bar_full(stage), 2 * C::kStageBytes);
          const uint32_t k_dst = base + C::kOffK + stage * C::kStageBytes;
          const uint32_t v_dst = base + C::kOffV + stage * C::kStageBytes;
#pragma unroll
          for (int c = 0; c < C::kChunks; ++c) {
            tma_load_4d(k_dst + c * C::kChunkKV, &tm_k, bar_full(stage), 64 * c, kvh, k0, b);
            tma_load_4d(v_dst + c * C::kChunkKV, &tm_v, bar_full(stage), 64 * c, kvh, k0, b);
          }
        }
        if (++stage == C::kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    mbar_wait(bar_empty(stage), phase ^ 1);
    if (lane == 0) {
      s_tile[2 * stage] = -1;                        // the walk is over
      mbar_arrive(bar_full(stage));
    }
  } else {
    // ----------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(C::kConsumerRegs));
    const int wg = warp >> 2;
    const int w = warp & 3;
    const int r0 = 64 * wg + 16 * w + (lane >> 2);   // rows r0 and r0 + 8
    int qp[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + r0 + 8 * r;
      qp[r] = row < s_len ? __ldg(qpos + row) : 0;
    }
    float m[2] = {kNeg, kNeg};
    float l[2] = {0.0f, 0.0f};
    float acc[C::kChunks][32];
#pragma unroll
    for (int c = 0; c < C::kChunks; ++c) {
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[c][i] = 0.0f;
    }
    float s[C::kSR];
#pragma unroll
    for (int i = 0; i < C::kSR; ++i) s[i] = 0.0f;
    uint32_t pa[C::kBK / 16][4];                     // bf16 p of the last tile
    const uint32_t q_addr = base + wg * 64 * 128;
    // The warpgroups take turns to issue their products (named barrier
    // 1 + wg is this warpgroup's turn); warpgroup 0 goes first.
    if (wg == 1) asm volatile("bar.arrive 1, 256;\n" ::: "memory");
    mbar_wait(bar_q, 0);

    // One kv tile per turn, the products of two tiles in flight: S of tile
    // t is issued, then P.V of tile t-1; the softmax of t runs while P.V of
    // t-1 is still on the tensor cores, and acc is rescaled only after it.
    // The first tile (S alone) and the last P.V are peeled off the loop, so
    // every turn issues and waits for the same two groups.
    const uint32_t k_base = base + C::kOffK;
    const uint32_t v_base = base + C::kOffV;
    int stage = 0;
    int phase = 0;
    mbar_wait(bar_full(stage), phase);
    if (s_tile[2 * stage] >= 0) {
      wgmma_fence();
      issue_qk<DH>(s, q_addr, k_base + stage * C::kStageBytes);
      wgmma_commit();
      wgmma_wait_all();
      pin(s);
      float corr[2];
      softmax_any<C>(s, m, l, corr, qp, s_kpos + stage * C::kBK, s_tile[2 * stage + 1] != 0,
                      lane, scale, causal, window, cap);
      pack_p<C>(pa, s);
      int prev = stage;
      if (++stage == C::kStages) {
        stage = 0;
        phase ^= 1;
      }
      while (true) {
        mbar_wait(bar_full(stage), phase);
        if (s_tile[2 * stage] < 0) break;
        pin(s);
#pragma unroll
        for (int c = 0; c < C::kChunks; ++c) pin(acc[c]);
#pragma unroll
        for (int j = 0; j < C::kBK / 16; ++j) pin(pa[j]);
        asm volatile("bar.sync %0, 256;\n" ::"r"(1 + wg) : "memory");
        wgmma_fence();
        issue_qk<DH>(s, q_addr, k_base + stage * C::kStageBytes);
        wgmma_commit();
        issue_pv<C>(acc, pa, v_base + prev * C::kStageBytes);
        wgmma_commit();
        asm volatile("bar.arrive %0, 256;\n" ::"r"(2 - wg) : "memory");
        asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
        pin(s);
        softmax_any<C>(s, m, l, corr, qp, s_kpos + stage * C::kBK,
                        s_tile[2 * stage + 1] != 0, lane, scale, causal, window, cap);
        wgmma_wait_all();
#pragma unroll
        for (int c = 0; c < C::kChunks; ++c) pin(acc[c]);
#pragma unroll
        for (int j = 0; j < C::kBK / 16; ++j) pin(pa[j]);
        if (lane == 0) mbar_arrive(bar_empty(prev));
#pragma unroll
        for (int c = 0; c < C::kChunks; ++c) {
#pragma unroll
          for (int i = 0; i < 32; ++i) acc[c][i] *= corr[(i >> 1) & 1];
        }
        pack_p<C>(pa, s);
        prev = stage;
        if (++stage == C::kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
#pragma unroll
      for (int c = 0; c < C::kChunks; ++c) pin(acc[c]);
#pragma unroll
      for (int j = 0; j < C::kBK / 16; ++j) pin(pa[j]);
      wgmma_fence();
      issue_pv<C>(acc, pa, v_base + prev * C::kStageBytes);
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int c = 0; c < C::kChunks; ++c) pin(acc[c]);
      if (lane == 0) mbar_arrive(bar_empty(prev));
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + r0 + 8 * r;
      if (row >= s_len) continue;
      const float denom = fmaxf(l[r], 1e-30f);
      __nv_bfloat16* o = out + ((static_cast<int64_t>(b) * s_len + row) * heads + h) * DH;
#pragma unroll
      for (int c = 0; c < C::kChunks; ++c) {
#pragma unroll
        for (int g = 0; g < 8; ++g) {
          const int col = 64 * c + 8 * g + 2 * (lane & 3);
          if (col < DH) {
            const int i = 4 * g + 2 * r;
            *reinterpret_cast<__nv_bfloat162*>(o + col) =
                __floats2bfloat162_rn(acc[c][i] / denom, acc[c][i + 1] / denom);
          }
        }
      }
    }
  }
}

// ------------------------------------------------------------------ host
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// error codes of this library beside cudaError_t's
constexpr int kErrNoEncoder = -1;
constexpr int kErrEncode = -2;
constexpr int kErrHeadDim = -3;
constexpr int kErrRegisters = -4;
constexpr int kMaxDevices = 64;

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                              &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(p);
    }
  }
  return fn;
}

// A 4-D map over a contiguous (B, rows, heads, dh) bf16 tensor, dh
// innermost, read in boxes of 64 columns x 1 head x box_rows rows.
int make_map(CUtensorMap* map, const void* ptr, int dh, int heads, int rows, int b,
             int box_rows) {
  EncodeTiled fn = encoder();
  if (fn == nullptr) return kErrNoEncoder;
  const cuuint64_t row_bytes = static_cast<cuuint64_t>(dh) * 2;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(dh), static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(rows), static_cast<cuuint64_t>(b)};
  const cuuint64_t strides[3] = {row_bytes, row_bytes * heads, row_bytes * heads * rows};
  const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  CUresult res = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                    strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                    CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                    CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : kErrEncode;
}

template <int DH>
int launch(const void* q, const void* k, const void* v, const int* qpos, const int* kpos,
           void* out, int b, int s, int sk, int h, int kvh, float scale, int causal, int window,
           float cap, cudaStream_t stream) {
  using C = Cfg<DH>;
  CUtensorMap tm_q, tm_k, tm_v;
  int err = make_map(&tm_q, q, DH, h, s, b, C::kBQ);
  if (err != 0) return err;
  if (sk > 0) {
    err = make_map(&tm_k, k, DH, kvh, sk, b, C::kBK);
    if (err != 0) return err;
    err = make_map(&tm_v, v, DH, kvh, sk, b, C::kBK);
    if (err != 0) return err;
  } else {                                           // no kv tile is ever loaded
    tm_k = tm_q;
    tm_v = tm_q;
  }
  auto kernel = flash_attention_tc_kernel<DH>;
  int device = 0;
  cudaError_t derr = cudaGetDevice(&device);
  if (derr != cudaSuccess) return static_cast<int>(derr);
  static bool ready[kMaxDevices] = {};               // once per width and card
  if (device >= kMaxDevices || !ready[device]) {
    cudaFuncAttributes attr;
    cudaError_t cerr = cudaFuncGetAttributes(&attr, kernel);
    if (cerr != cudaSuccess) return static_cast<int>(cerr);
    // setmaxnreg only moves registers inside the block's allocation: a
    // smaller count at entry would leave the consumers waiting forever
    if (attr.numRegs * kThreads <
        C::kProducerRegs * 128 + C::kConsumerRegs * 32 * kConsumerWarps) {
      return kErrRegisters;
    }
    cerr = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kBytes);
    if (cerr != cudaSuccess) return static_cast<int>(cerr);
    if (device < kMaxDevices) ready[device] = true;
  }
  const dim3 grid(static_cast<unsigned>((s + C::kBQ - 1) / C::kBQ), static_cast<unsigned>(b * h));
  kernel<<<grid, kThreads, C::kBytes, stream>>>(tm_q, tm_k, tm_v, qpos, kpos,
                                                static_cast<__nv_bfloat16*>(out), s, sk, h, kvh,
                                                scale, causal, window, cap);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface, loaded with ctypes. The launcher builds the three TMA
// maps, enqueues one kernel on `stream` and returns 0, a cudaError_t, or a
// negative code of this library (flash_attention_tc_error_string names
// each); it never synchronises and allocates nothing. The caller
// guarantees s >= 1, b * h >= 1, dh one of 64, 96, 112, 128, 256,
// h % kvh == 0, contiguous bf16 operands with 16-byte aligned bases and
// int32 positions on the current device, and the envelope
// (kernels/envelope.py).
extern "C" {

const char* flash_attention_tc_error_string(int err) {
  switch (err) {
    case kErrNoEncoder:
      return "cuTensorMapEncodeTiled not found through cudaGetDriverEntryPoint";
    case kErrEncode:
      return "cuTensorMapEncodeTiled refused a tensor map";
    case kErrHeadDim:
      return "no tensor-core instantiation for this head width";
    case kErrRegisters:
      return "compiled with fewer registers at entry than setmaxnreg hands out";
    default:
      return cudaGetErrorString(static_cast<cudaError_t>(err));
  }
}

int flash_attention_tc_smem_bytes(int dh) {
  switch (dh) {
    case 64: return Cfg<64>::kBytes;
    case 96: return Cfg<96>::kBytes;
    case 112: return Cfg<112>::kBytes;
    case 128: return Cfg<128>::kBytes;
    case 256: return Cfg<256>::kBytes;
    default: return kErrHeadDim;
  }
}

int flash_attention_tc(const void* q, const void* k, const void* v, const int* qpos,
                       const int* kpos, void* out, int b, int s, int sk, int h, int kvh, int dh,
                       float scale, int causal, int window, float cap, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dh) {
    case 64:
      return launch<64>(q, k, v, qpos, kpos, out, b, s, sk, h, kvh, scale, causal, window, cap, st);
    case 96:
      return launch<96>(q, k, v, qpos, kpos, out, b, s, sk, h, kvh, scale, causal, window, cap, st);
    case 112:
      return launch<112>(q, k, v, qpos, kpos, out, b, s, sk, h, kvh, scale, causal, window, cap,
                         st);
    case 128:
      return launch<128>(q, k, v, qpos, kpos, out, b, s, sk, h, kvh, scale, causal, window, cap,
                         st);
    case 256:
      return launch<256>(q, k, v, qpos, kpos, out, b, s, sk, h, kvh, scale, causal, window, cap,
                         st);
    default:
      return kErrHeadDim;
  }
}

}  // extern "C"

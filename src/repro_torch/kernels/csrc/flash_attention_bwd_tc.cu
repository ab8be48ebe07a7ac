// Flash attention backward for Hopper (sm_90a) on the tensor cores: bf16
// operands, wgmma products, tiles brought in by TMA.
//
// Replaces: nothing in Pallas. The reference trains through XLA's autodiff
// of its score-materialising attention (src/repro/models/layers.py:60-133
// attention/_sdpa). This is the tensor-core route of the port's attention
// backward, beside the CUDA-core kernel (csrc/flash_attention_bwd.cu): bf16
// at the head widths 64, 96, 112 and 128 (96 and 112 run as 128, the
// columns past dh read as zeros) come here; float32, and bf16 at any other
// width up to 128, go there (kernels/dispatch.py::resolve_flash_bwd).
//
// It computes what the CUDA-core kernel computes (its header states the
// forward and the gradient): for q, do (B, S, H, dh), k, v (B, Sk, KV, dh)
// bf16 and int32 positions qpos (S,), kpos (Sk,), query head h reading kv
// head h / (H / KV),
//   x_ij = (q_i . k_j) scale, softcapped x_ij = cap t_ij, t_ij = tanh(x_ij / cap)
//   P_ij = exp(x_ij - lse_i) on the unrounded scores, 0 where (i, j) is not
//          visible (kpos_j < 0, causal qpos_i < kpos_j, window
//          qpos_i - kpos_j >= window); lse_i = +inf on a row that sees no key
//   dP_ij = do_i . v_j,  D_i = sum_j P_ij dP_ij (from dP, never do . o)
//   dS_ij = P_ij (dP_ij - D_i) (1 - t_ij^2 where cap != 0)
//   dv_j = sum_i P_ij do_i,  dk_j = scale sum_i dS_ij q_i,  dq_i = scale sum_j dS_ij k_j
// with float32 accumulation and each output rounded once to bf16. No
// atomics: every output element is written by one block after a fixed
// walk, so a replayed step is bitwise the first.
//
// Precision. q, k, v and do are bf16, so S = q.k and dP = do.v on the
// tensor cores are the exact products summed in float32, as on the CUDA
// cores up to the order of the sums. P and dS are float32 and a wgmma
// operand is bf16: each is fed to the gradient products as a hi/lo pair,
// hi = bf16(x), lo = bf16(x - hi), two register-A wgmmas into one
// accumulator in a fixed order (hi, then lo). The other operand (do, q or
// k) is exactly bf16, so a product carries about 2^-17 relative error:
// float32 grade. One bf16 rounding of P and dS (2^-9) was measured on the
// card at 3.3-5.7 times the gate chip_smoke.py holds the gradient to (one
// bf16 ulp of the element plus 2^-12 of the largest), which the hi/lo
// pair holds at 0.80-0.92, as the CUDA-core kernel's float32 products do.
//
// Three launches, as on the CUDA cores; each block is 384 threads: two
// consumer warpgroups (wgmma takes 64 rows) and a producer warpgroup of
// which one warp works (setmaxnreg moves the registers: 40 a producer
// thread, 232 a consumer thread, inside the block's 168 x 384). The
// producer brings tiles by TMA (cp.async.bulk.tensor, 128-byte swizzle,
// 64-column boxes) through a ring of stages tracked by mbarriers (full:
// bytes arrived; empty: the eight consumer warps are done), decides from
// the tiles' position ranges whether a tile pair can meet at all (a pair
// no position rule lets meet is skipped: exact, it adds nothing) and
// whether every pair is visible (then the per-element masks are skipped:
// a per-tile flag written beside the stage, as the forward's), and ends
// the walk with a sentinel.
//   (a) stats_tc_kernel: one block per (128-row q tile, b*h), 64 rows a
//       consumer warpgroup. Q and dO once; K and V tiles of 64 keys
//       through the ring. S = Q.K^T and dP = dO.V^T as ss-form wgmma; the
//       online max, sum p and sum p dP (rescaled as the max moves) over a
//       quad's row; writes lse and D into the (2, B, H, S) float32 scratch.
//   (b) dkdv_tc_kernel: one block per (128-key tile, b*kv head), 64 keys a
//       consumer warpgroup. K and V once; Q, dO (32-row q tiles), lse, D
//       and the query positions through the ring, walking the GQA group's
//       heads and then the q tiles in order. S^T = K.Q^T and dP^T = V.dO^T
//       (M = keys, N = 32 queries), so P^T and dS^T land in the
//       accumulator layout that the register-A form takes as A; then
//       dv += P^T.dO and dk += dS^T.Q with dO and Q as MN-major B (the
//       transpose bit). dk and dv stay in registers across the walk (128
//       floats a thread above dh 64); 32-row q tiles keep S^T, dP^T and
//       their hi/lo fragments small beside them.
//   (c) dq_tc_kernel: one block per (128-row q tile, b*h), the walk of (a);
//       S, dP, then dq += dS.K with K as the MN-major B operand.
// Per visible (query, key) pair that is 12 products of dh multiply-adds:
// S and dP in each pass, and the hi/lo halves of dv, dk and dq.
//
// Bound on an H100 SXM (chip_smoke.py bwd_bound): the gradient's five
// products (q.k, do.v, dq, dk, dv: 10 dh flops a visible pair) at the
// 989 TFLOP/s bf16 tensor-core peak; at musicgen-medium's layer (B 4,
// S 2048, H = KV = 24, dh 64, causal: 2.0e8 visible pairs) 2.6e11 flops,
// 0.13 ms; bytes (q, k, v, do read and dq, dk, dv written once, 75 MB)
// 0.02 ms. This design does 12 products, 0.31 ms at that peak, and three
// ex2 per pair on the special-function units (6e8, about 0.14 ms at 16
// a clock an SM); the per-element float32 work beside them (scale,
// softcap, masks, dS, the hi/lo split) shares the issue slots and, with no
// overlap of one tile's elementwise work with the next tile's products
// inside a warpgroup, is what this design leaves on the critical path.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

namespace {

constexpr int kConsumerWarps = 8;                    // two warpgroups
constexpr int kThreads = 32 * kConsumerWarps + 128;  // + the producer warpgroup
// setmaxnreg, per thread: 128 x 40 + 256 x 232 = 64,512, the block's
// allocation at 168 a thread
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
static_assert(128 * kProducerRegs + 256 * kConsumerRegs == 168 * kThreads, "");

// The two consumer warpgroups take turns to issue their S and dP products
// (named barrier 1 + wg is warpgroup wg's turn; warpgroup 0 goes first),
// so one's elementwise work runs under the other's products, as the
// forward's warpgroups do.
__device__ __forceinline__ void turns_begin(int wg) {
  if (wg == 1) asm volatile("bar.arrive 1, 256;\n" ::: "memory");
}
__device__ __forceinline__ void turn_wait(int wg) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(1 + wg) : "memory");
}
__device__ __forceinline__ void turn_pass(int wg) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(2 - wg) : "memory");
}

template <int DH>
struct Cfg {
  static constexpr int kChunks = (DH + 63) / 64;     // 64-column boxes
  // (a) and (c): 128 query rows a block, kv tiles of 64 keys
  static constexpr int kBQ = 128;
  static constexpr int kBK = 64;
  static constexpr int kRowStages = DH <= 64 ? 4 : 3;
  static constexpr int kScanTiles = 4;               // kv tiles tested at once
  static constexpr int kChunkQ = kBQ * 128;          // bytes of one box
  static constexpr int kChunkK = kBK * 128;
  static constexpr int kRowStage = kChunks * kChunkK;  // K or V of a stage
  static constexpr int kRowOffDo = kChunks * kChunkQ;
  static constexpr int kRowOffK = 2 * kChunks * kChunkQ;
  static constexpr int kRowOffV = kRowOffK + kRowStages * kRowStage;
  static constexpr int kRowOffKpos = kRowOffV + kRowStages * kRowStage;
  static constexpr int kRowOffTile = kRowOffKpos + kRowStages * kBK * 4;
  static constexpr int kRowOffBar = kRowOffTile + kRowStages * 8;
  static constexpr int kRowBytes = kRowOffBar + (1 + 2 * kRowStages) * 8 + 1024;
  // (b): 128 keys a block, q tiles of 32 rows (measured faster than 64 at
  // dh 64, with fewer registers live beside the dk and dv accumulators)
  static constexpr int kKB = 128;
  static constexpr int kQB = 32;
  static constexpr int kQSteps = kQB / 16;           // k-steps of dv, dk
  static constexpr int kColStages = 4;
  static constexpr int kChunkKB = kKB * 128;
  static constexpr int kChunkQB = kQB * 128;
  static constexpr int kColStage = kChunks * kChunkQB;  // Q or dO of a stage
  static constexpr int kColOffV = kChunks * kChunkKB;
  static constexpr int kColOffQ = 2 * kChunks * kChunkKB;
  static constexpr int kColOffDo = kColOffQ + kColStages * kColStage;
  // [stage]{lse log2(e), D, qpos}[kQB]
  static constexpr int kColOffStat = kColOffDo + kColStages * kColStage;
  static constexpr int kColOffTile = kColOffStat + kColStages * 3 * kQB * 4;
  static constexpr int kColOffBar = kColOffTile + kColStages * 8;
  static constexpr int kColBytes = kColOffBar + (1 + 2 * kColStages) * 8 + 1024;
};

struct Params {
  const int* qpos;
  const int* kpos;
  float* lse;                 // (B, H, S): written by (a), read by (b), (c)
  float* delta;
  __nv_bfloat16* dq;          // written by (c)
  __nv_bfloat16* dk;          // written by (b)
  __nv_bfloat16* dv;
  int s_len, sk_len, heads, kv_heads, causal, window;
  float scale, cap;
};

// ------------------------------------------------ Hopper helpers (as in
// csrc/flash_attention_tc.cu)
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

// Wait until the phase of parity `parity` has completed. A wait that
// lasts 2^35 clocks (about 18 s; a tile's wait is microseconds) traps, so
// a fault in the ring's protocol ends the launch with an error instead of
// holding the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done = 0;
  const long long start = clock64();
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (!done && clock64() - start > (1LL << 35)) __trap();
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

// D (+)= A.B, A (64 x 16) and B (64 x 16) K-major in shared memory
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

// D (+)= A.B, A (64 x 16) and B (32 x 16) K-major in shared memory
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t da, uint64_t db,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D += A.B, A (64 x 16) bf16 in registers, B (16 x 64) MN-major in shared
// memory (the transpose bit)
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

// ------------------------------------------------------------ the math
// D = A.B^T for one 64 x N tile (N = 64 or 32) over the k-steps inside
// dh: A (64 rows) and B (N rows) K-major under the 128-byte swizzle, `ca`
// and `cb` bytes between their 64-column boxes.
template <int DH, int N>
__device__ __forceinline__ void issue_nt(float (&d)[N / 2], uint32_t a_addr, int ca,
                                         uint32_t b_addr, int cb) {
#pragma unroll
  for (int c = 0; c < Cfg<DH>::kChunks; ++c) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if (64 * c + 16 * kk < DH) {
        const uint64_t da = make_desc(a_addr + c * ca + 32 * kk, 16, 1024);
        const uint64_t db = make_desc(b_addr + c * cb + 32 * kk, 16, 1024);
        if constexpr (N == 64) {
          wgmma_ss_n64(d, da, db, (c | kk) != 0);
        } else {
          wgmma_ss_n32(d, da, db, (c | kk) != 0);
        }
      }
    }
  }
}

// acc += (hi + lo).B: the A fragments of KS k-steps (16 rows of B each)
// in registers, B (16 KS rows) MN-major (the transpose bit), `cb` bytes
// between its 64-column boxes, one box of the output a product; for each
// k-step and box the hi half goes first, then the lo half.
template <int DH, int KS>
__device__ __forceinline__ void issue_grad(float (&acc)[Cfg<DH>::kChunks][32],
                                           const uint32_t (&hi)[KS][4],
                                           const uint32_t (&lo)[KS][4], uint32_t b_addr, int cb) {
#pragma unroll
  for (int j = 0; j < KS; ++j) {
#pragma unroll
    for (int c = 0; c < Cfg<DH>::kChunks; ++c) {
      const uint64_t db = make_desc(b_addr + c * cb + j * 2048, 1024, 1024);
      wgmma_rs_n64_tb(acc[c], hi[j], db);
      wgmma_rs_n64_tb(acc[c], lo[j], db);
    }
  }
}

// x (64 x 16 KS accumulator fragment) to bf16 hi/lo pairs: the fragment
// of columns 16j..16j+15 is the A fragment of the j-th k-step.
template <int KS>
__device__ __forceinline__ void split_pack(const float (&x)[8 * KS], uint32_t (&hi)[KS][4],
                                           uint32_t (&lo)[KS][4]) {
#pragma unroll
  for (int j = 0; j < KS; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float a = x[8 * j + 2 * e], b = x[8 * j + 2 * e + 1];
      const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
      const float2 hf = __bfloat1622float2(h);
      const __nv_bfloat162 l = __floats2bfloat162_rn(a - hf.x, b - hf.y);
      hi[j][e] = *reinterpret_cast<const uint32_t*>(&h);
      lo[j][e] = *reinterpret_cast<const uint32_t*>(&l);
    }
  }
}

// the scaled (and softcapped) score of a raw q.k; t = tanh(x / cap)
template <bool kCap>
__device__ __forceinline__ float score(float raw, float scale, float cap, float& t) {
  float x = raw * scale;
  t = 0.0f;
  if constexpr (kCap) {
    t = tanhf(x / cap);
    x = t * cap;
  }
  return x;
}

constexpr float kLog2e = 1.4426950408889634f;      // exp(y) = exp2(y log2(e))
constexpr float kLn2 = 0.6931471805599453f;

// The exponentials run in log2 units, as the forward kernels': lse and the
// running max are carried times log2(e) and p = exp2(x log2(e) - lse
// log2(e)), the scale folded into one fma where there is no softcap. The
// argument's rounding moves p by about 2^-24 of the argument, relative
// (a few 1e-6 at these scores), far below the gate; the accurate expf
// spends several more instructions a pair on the same p.
// p of a raw score s (the softcapped, scaled score x when kCap) against
// lse2 = lse log2(e); sl2 = scale log2(e)
template <bool kCap>
__device__ __forceinline__ float prob(float s, float x, float sl2, float lse2) {
  return kCap ? exp2f(fmaf(x, kLog2e, -lse2)) : exp2f(fmaf(s, sl2, -lse2));
}

__device__ __forceinline__ bool visible(int qp, int kp, int causal, int window) {
  if (kp < 0) return false;
  const long long d = static_cast<long long>(qp) - kp;
  return (!causal || d >= 0) && (window <= 0 || d < window);
}

// Fragment element i of a thread (lane) in a 64 x 64 accumulator: row
// 16 w + (lane >> 2) + 8 ((i >> 1) & 1), column (i >> 2) 8 + 2 (lane & 3) + (i & 1).
__device__ __forceinline__ int frag_col(int i, int lane) {
  return (i >> 2) * 8 + 2 * (lane & 3) + (i & 1);
}

// (a): one kv tile's update of the online row statistics. s and dp are the
// raw S and dP of the warpgroup's 64 rows (this thread's two) against 64
// keys (kp_s: their positions); m (log2 units) is shared by the quad, l
// and pd are this thread's shares of sum p and sum p dP against it.
template <bool kCap, bool kMask>
__device__ __forceinline__ void stats_tile(float (&s)[32], const float (&dp)[32], float (&m)[2],
                                           float (&l)[2], float (&pd)[2], const int (&qp)[2],
                                           const int* kp_s, int lane, const Params& p) {
  // x in log2 units with a softcap; without one the max is taken on the
  // raw scores (scale log2(e) > 0 keeps their order) and scaled once
  const float sl2 = p.scale * kLog2e;
  float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int r = (i >> 1) & 1;
    float x = s[i];
    if (kCap) {
      float t;
      x = score<true>(s[i], p.scale, p.cap, t) * kLog2e;
    }
    if (kMask && !visible(qp[r], kp_s[frag_col(i, lane)], p.causal, p.window)) x = -INFINITY;
    tmax[r] = fmaxf(tmax[r], x);
    s[i] = x;
  }
  float mn[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 1));
    tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 2));
    mn[r] = fmaxf(m[r], kCap ? tmax[r] : tmax[r] * sl2);
  }
  float sum[2] = {0.0f, 0.0f}, spd[2] = {0.0f, 0.0f};
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int r = (i >> 1) & 1;
    // 0 for a key the row does not see
    const float e = kCap ? exp2f(s[i] - mn[r]) : exp2f(fmaf(s[i], sl2, -mn[r]));
    sum[r] += e;
    spd[r] = fmaf(e, dp[i], spd[r]);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (mn[r] == -INFINITY) continue;            // the row has seen no key yet
    const float corr = exp2f(m[r] - mn[r]);
    l[r] = l[r] * corr + sum[r];
    pd[r] = pd[r] * corr + spd[r];
    m[r] = mn[r];
  }
}

// (c): dS of one tile, rows of the thread (lse log2(e), D, positions per
// row), keys along the columns (kp_s). s becomes dS.
template <bool kCap, bool kMask>
__device__ __forceinline__ void ds_rows(float (&s)[32], const float (&dp)[32], const float (&lse2)[2],
                                        const float (&dl)[2], const int (&qp)[2], const int* kp_s,
                                        int lane, const Params& p) {
  const float sl2 = p.scale * kLog2e;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int r = (i >> 1) & 1;
    float t;
    const float x = score<kCap>(s[i], p.scale, p.cap, t);
    float pij = prob<kCap>(s[i], x, sl2, lse2[r]);
    if (kMask && !visible(qp[r], kp_s[frag_col(i, lane)], p.causal, p.window)) pij = 0.0f;
    float g = pij * (dp[i] - dl[r]);
    if (kCap) g *= 1.0f - t * t;
    s[i] = g;
  }
}

// (b): P^T and dS^T of one 64 x N tile, keys along the rows (kp per
// row), queries along the columns (lse log2(e), D and positions from the
// stage). s becomes P^T, dp becomes dS^T.
template <int N, bool kCap, bool kMask>
__device__ __forceinline__ void p_ds_cols(float (&s)[N / 2], float (&dp)[N / 2],
                                          const int (&kp)[2], const float* lse_s,
                                          const float* dl_s, const int* qp_s, int lane,
                                          const Params& p) {
  const float sl2 = p.scale * kLog2e;
#pragma unroll
  for (int g = 0; g < N / 8; ++g) {
    const int col = 8 * g + 2 * (lane & 3);
    const float2 lse2 = *reinterpret_cast<const float2*>(lse_s + col);
    const float2 dl2 = *reinterpret_cast<const float2*>(dl_s + col);
    int2 qp2 = make_int2(0, 0);
    if (kMask) qp2 = *reinterpret_cast<const int2*>(qp_s + col);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = 4 * g + u;
      const int r = u >> 1;
      const bool odd = (u & 1) != 0;
      float t;
      const float x = score<kCap>(s[i], p.scale, p.cap, t);
      float pij = prob<kCap>(s[i], x, sl2, odd ? lse2.y : lse2.x);
      if (kMask && !visible(odd ? qp2.y : qp2.x, kp[r], p.causal, p.window)) pij = 0.0f;
      float g_ = pij * (dp[i] - (odd ? dl2.y : dl2.x));
      if (kCap) g_ *= 1.0f - t * t;
      s[i] = pij;
      dp[i] = g_;
    }
  }
}

// ------------------------------------------------ (a) and (c): q-row blocks
// The producer of (a) and (c): Q and dO once, then the visible kv tiles of
// 64 keys in order through the ring, each with its key positions and its
// flag (all pairs visible) beside it; a sentinel ends the walk.
template <int DH>
__device__ __forceinline__ void row_producer(const CUtensorMap* tm_q, const CUtensorMap* tm_do,
                                             const CUtensorMap* tm_k, const CUtensorMap* tm_v,
                                             uint32_t base, uint8_t* smem, int q0, int b, int h,
                                             int kvh, int lane, const Params& p) {
  using C = Cfg<DH>;
  int* s_kpos = reinterpret_cast<int*>(smem + C::kRowOffKpos);
  int* s_tile = reinterpret_cast<int*>(smem + C::kRowOffTile);
  const uint32_t bar_q = base + C::kRowOffBar;
  auto bar_full = [&](int st) { return bar_q + 8u * (1 + st); };
  auto bar_empty = [&](int st) { return bar_q + 8u * (1 + C::kRowStages + st); };
  if (lane == 0) {
    mbar_expect_tx(bar_q, 2 * C::kChunks * C::kChunkQ);
#pragma unroll
    for (int c = 0; c < C::kChunks; ++c) {
      tma_load_4d(base + c * C::kChunkQ, tm_q, bar_q, 64 * c, h, q0, b);
      tma_load_4d(base + C::kRowOffDo + c * C::kChunkQ, tm_do, bar_q, 64 * c, h, q0, b);
    }
  }
  const int rows = min(C::kBQ, p.s_len - q0);
  int qmin = INT_MAX;
  int qmax = INT_MIN;
  for (int r = lane; r < rows; r += 32) {
    const int x = __ldg(p.qpos + q0 + r);
    qmin = min(qmin, x);
    qmax = max(qmax, x);
  }
  qmin = __reduce_min_sync(0xffffffffu, qmin);
  qmax = __reduce_max_sync(0xffffffffu, qmax);

  const int n_tiles = (p.sk_len + C::kBK - 1) / C::kBK;
  int stage = 0;
  int phase = 0;
  for (int t0 = 0; t0 < n_tiles; t0 += C::kScanTiles) {
    int kp[C::kScanTiles][C::kBK / 32];
#pragma unroll
    for (int g = 0; g < C::kScanTiles; ++g) {
#pragma unroll
      for (int e = 0; e < C::kBK / 32; ++e) {
        const int j = (t0 + g) * C::kBK + lane + 32 * e;
        kp[g][e] = j < p.sk_len ? __ldg(p.kpos + j) : -1;
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
        if (p.causal) {
          any = any && kp[g][e] <= qmax;
          all = all && kp[g][e] <= qmin;
        }
        if (p.window > 0) {
          any = any && static_cast<long long>(qmin) - kp[g][e] < p.window;
          all = all && static_cast<long long>(qmax) - kp[g][e] < p.window;
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
        mbar_expect_tx(bar_full(stage), 2 * C::kRowStage);
        const uint32_t k_dst = base + C::kRowOffK + stage * C::kRowStage;
        const uint32_t v_dst = base + C::kRowOffV + stage * C::kRowStage;
#pragma unroll
        for (int c = 0; c < C::kChunks; ++c) {
          tma_load_4d(k_dst + c * C::kChunkK, tm_k, bar_full(stage), 64 * c, kvh, k0, b);
          tma_load_4d(v_dst + c * C::kChunkK, tm_v, bar_full(stage), 64 * c, kvh, k0, b);
        }
      }
      if (++stage == C::kRowStages) {
        stage = 0;
        phase ^= 1;
      }
    }
  }
  mbar_wait(bar_empty(stage), phase ^ 1);
  if (lane == 0) {
    s_tile[2 * stage] = -1;                          // the walk is over
    mbar_arrive(bar_full(stage));
  }
}

// (a) when kDq is false, (c) when it is true.
template <int DH, bool kDq>
__device__ __forceinline__ void row_pass(const CUtensorMap* tm_q, const CUtensorMap* tm_do,
                                         const CUtensorMap* tm_k, const CUtensorMap* tm_v,
                                         const Params& p) {
  using C = Cfg<DH>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;      // swizzle atoms: 1 KB
  uint8_t* smem = smem_raw + (base - raw);
  const int* s_kpos = reinterpret_cast<const int*>(smem + C::kRowOffKpos);
  const volatile int* s_tile = reinterpret_cast<const volatile int*>(smem + C::kRowOffTile);
  const uint32_t bar_q = base + C::kRowOffBar;
  auto bar_full = [&](int st) { return bar_q + 8u * (1 + st); };
  auto bar_empty = [&](int st) { return bar_q + 8u * (1 + C::kRowStages + st); };

  const int q0 = (static_cast<int>(gridDim.x) - 1 - static_cast<int>(blockIdx.x)) * C::kBQ;
  const int b = static_cast<int>(blockIdx.y) / p.heads;
  const int h = static_cast<int>(blockIdx.y) - b * p.heads;
  const int kvh = h / (p.heads / p.kv_heads);
  const int warp = static_cast<int>(threadIdx.x) >> 5;
  const int lane = static_cast<int>(threadIdx.x) & 31;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int st = 0; st < C::kRowStages; ++st) {
      mbar_init(bar_full(st), 1);
      mbar_init(bar_empty(st), kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= kConsumerWarps) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (warp != kConsumerWarps) return;
    row_producer<DH>(tm_q, tm_do, tm_k, tm_v, base, smem, q0, b, h, kvh, lane, p);
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int wg = warp >> 2;
  const int r0 = 64 * wg + 16 * (warp & 3) + (lane >> 2);   // rows r0 and r0 + 8
  const size_t stat0 = static_cast<size_t>(blockIdx.y) * p.s_len;   // (b, h) of (B, H, S)
  int qp[2];
  float lse2[2], dl[2];                              // (c): the row statistics
  float m[2], l[2], pd[2];                           // (a): the online ones
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + r0 + 8 * r;
    const bool in = row < p.s_len;
    qp[r] = in ? __ldg(p.qpos + row) : 0;
    if (kDq) {
      lse2[r] = in ? p.lse[stat0 + row] * kLog2e : INFINITY;
      dl[r] = in ? p.delta[stat0 + row] : 0.0f;
    }
    m[r] = -INFINITY;
    l[r] = pd[r] = 0.0f;
  }
  float acc[C::kChunks][32];
#pragma unroll
  for (int c = 0; c < C::kChunks; ++c) {
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[c][i] = 0.0f;
  }
  float s[32], dp[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.0f;
  const uint32_t q_addr = base + wg * 64 * 128;
  const uint32_t do_addr = base + C::kRowOffDo + wg * 64 * 128;
  turns_begin(wg);
  mbar_wait(bar_q, 0);

  int stage = 0;
  int phase = 0;
  while (true) {
    mbar_wait(bar_full(stage), phase);
    if (s_tile[2 * stage] < 0) break;
    const bool all_seen = s_tile[2 * stage + 1] != 0;
    const uint32_t k_addr = base + C::kRowOffK + stage * C::kRowStage;
    const uint32_t v_addr = base + C::kRowOffV + stage * C::kRowStage;
    const int* kp_s = s_kpos + stage * C::kBK;
    pin(s);
    pin(dp);
    turn_wait(wg);
    wgmma_fence();
    issue_nt<DH, 64>(s, q_addr, C::kChunkQ, k_addr, C::kChunkK);
    issue_nt<DH, 64>(dp, do_addr, C::kChunkQ, v_addr, C::kChunkK);
    wgmma_commit();
    turn_pass(wg);
    wgmma_wait_all();
    pin(s);
    pin(dp);
    if constexpr (kDq) {
      if (p.cap != 0.0f) {
        if (all_seen) ds_rows<true, false>(s, dp, lse2, dl, qp, kp_s, lane, p);
        else ds_rows<true, true>(s, dp, lse2, dl, qp, kp_s, lane, p);
      } else if (all_seen) {
        ds_rows<false, false>(s, dp, lse2, dl, qp, kp_s, lane, p);
      } else {
        ds_rows<false, true>(s, dp, lse2, dl, qp, kp_s, lane, p);
      }
      uint32_t gh[4][4], gl[4][4];
      split_pack<4>(s, gh, gl);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        pin(gh[j]);
        pin(gl[j]);
      }
#pragma unroll
      for (int c = 0; c < C::kChunks; ++c) pin(acc[c]);
      wgmma_fence();
      issue_grad<DH, 4>(acc, gh, gl, k_addr, C::kChunkK);
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int c = 0; c < C::kChunks; ++c) pin(acc[c]);
    } else {
      if (p.cap != 0.0f) {
        if (all_seen) stats_tile<true, false>(s, dp, m, l, pd, qp, kp_s, lane, p);
        else stats_tile<true, true>(s, dp, m, l, pd, qp, kp_s, lane, p);
      } else if (all_seen) {
        stats_tile<false, false>(s, dp, m, l, pd, qp, kp_s, lane, p);
      } else {
        stats_tile<false, true>(s, dp, m, l, pd, qp, kp_s, lane, p);
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(bar_empty(stage));
    if (++stage == C::kRowStages) {
      stage = 0;
      phase ^= 1;
    }
  }

  if constexpr (kDq) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + r0 + 8 * r;
      if (row >= p.s_len) continue;
      __nv_bfloat16* o = p.dq + ((static_cast<int64_t>(b) * p.s_len + row) * p.heads + h) * DH;
#pragma unroll
      for (int c = 0; c < C::kChunks; ++c) {
#pragma unroll
        for (int g = 0; g < 8; ++g) {
          const int col = 64 * c + 8 * g + 2 * (lane & 3);
          if (col < DH) {
            const int i = 4 * g + 2 * r;
            *reinterpret_cast<__nv_bfloat162*>(o + col) =
                __floats2bfloat162_rn(acc[c][i] * p.scale, acc[c][i + 1] * p.scale);
          }
        }
      }
    }
  } else {
    // lse = m ln(2) + log(sum p), D = sum p dP / sum p over the quad (a
    // row that saw no key: lse = +inf, D = 0)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      pd[r] += __shfl_xor_sync(0xffffffffu, pd[r], 1);
      pd[r] += __shfl_xor_sync(0xffffffffu, pd[r], 2);
      const int row = q0 + r0 + 8 * r;
      if ((lane & 3) == 0 && row < p.s_len) {
        const bool seen = m[r] != -INFINITY;
        p.lse[stat0 + row] = seen ? m[r] * kLn2 + logf(l[r]) : INFINITY;
        p.delta[stat0 + row] = seen ? pd[r] / l[r] : 0.0f;
      }
    }
  }
}

template <int DH>
__global__ void __launch_bounds__(kThreads, 1)
stats_tc_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_do,
                const __grid_constant__ CUtensorMap tm_k, const __grid_constant__ CUtensorMap tm_v,
                const Params p) {
  row_pass<DH, false>(&tm_q, &tm_do, &tm_k, &tm_v, p);
}

template <int DH>
__global__ void __launch_bounds__(kThreads, 1)
dq_tc_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_do,
             const __grid_constant__ CUtensorMap tm_k, const __grid_constant__ CUtensorMap tm_v,
             const Params p) {
  row_pass<DH, true>(&tm_q, &tm_do, &tm_k, &tm_v, p);
}

// ------------------------------------------------------- (b) dk, dv
template <int DH>
__global__ void __launch_bounds__(kThreads, 1)
dkdv_tc_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_do,
               const __grid_constant__ CUtensorMap tm_k, const __grid_constant__ CUtensorMap tm_v,
               const Params p) {
  using C = Cfg<DH>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* smem = smem_raw + (base - raw);
  float* s_stat = reinterpret_cast<float*>(smem + C::kColOffStat);   // [stage]{lse, D, qpos}[64]
  int* s_tile = reinterpret_cast<int*>(smem + C::kColOffTile);       // [stage]{live, all seen}
  const uint32_t bar_kv = base + C::kColOffBar;
  auto bar_full = [&](int st) { return bar_kv + 8u * (1 + st); };
  auto bar_empty = [&](int st) { return bar_kv + 8u * (1 + C::kColStages + st); };

  const int k0 = static_cast<int>(blockIdx.x) * C::kKB;  // first keys meet the most queries
  const int b = static_cast<int>(blockIdx.y) / p.kv_heads;
  const int kvh = static_cast<int>(blockIdx.y) - b * p.kv_heads;
  const int rep = p.heads / p.kv_heads;
  const int warp = static_cast<int>(threadIdx.x) >> 5;
  const int lane = static_cast<int>(threadIdx.x) & 31;

  if (threadIdx.x == 0) {
    mbar_init(bar_kv, 1);
    for (int st = 0; st < C::kColStages; ++st) {
      mbar_init(bar_full(st), 1);
      mbar_init(bar_empty(st), kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= kConsumerWarps) {
    // ------------------------------------------------------------ producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (warp != kConsumerWarps) return;
    if (lane == 0) {
      mbar_expect_tx(bar_kv, 2 * C::kChunks * C::kChunkKB);
#pragma unroll
      for (int c = 0; c < C::kChunks; ++c) {
        tma_load_4d(base + c * C::kChunkKB, &tm_k, bar_kv, 64 * c, kvh, k0, b);
        tma_load_4d(base + C::kColOffV + c * C::kChunkKB, &tm_v, bar_kv, 64 * c, kvh, k0, b);
      }
    }
    // the key block's live positions: range and whether every key is live
    int kmin = INT_MAX;
    int kmax = INT_MIN;
    bool kall = true;
#pragma unroll
    for (int e = 0; e < C::kKB / 32; ++e) {
      const int j = k0 + lane + 32 * e;
      const int x = j < p.sk_len ? __ldg(p.kpos + j) : -1;
      if (x >= 0) {
        kmin = min(kmin, x);
        kmax = max(kmax, x);
      } else {
        kall = false;
      }
    }
    kmin = __reduce_min_sync(0xffffffffu, kmin);
    kmax = __reduce_max_sync(0xffffffffu, kmax);
    kall = __all_sync(0xffffffffu, kall);
    const bool klive = kmin <= kmax;
    const int n_qt = (p.s_len + C::kQB - 1) / C::kQB;
    int stage = 0;
    int phase = 0;
    for (int r = 0; r < rep && klive; ++r) {
      const int h = kvh * rep + r;
      const size_t stat0 = (static_cast<size_t>(b) * p.heads + h) * p.s_len;
      for (int qt = 0; qt < n_qt; ++qt) {
        const int q0 = qt * C::kQB;
        constexpr int kRows = C::kQB / 32;           // q rows a lane
        int qp[kRows];
        bool seen = false;
        bool all_seen = true;
#pragma unroll
        for (int e = 0; e < kRows; ++e) {
          const int row = q0 + lane + 32 * e;
          const bool in = row < p.s_len;
          qp[e] = in ? __ldg(p.qpos + row) : 0;
          if (!in) continue;
          bool any = true;
          bool all = kall;
          if (p.causal) {
            any = any && qp[e] >= kmin;
            all = all && qp[e] >= kmax;
          }
          if (p.window > 0) {
            any = any && static_cast<long long>(qp[e]) - kmax < p.window;
            all = all && static_cast<long long>(qp[e]) - kmin < p.window;
          }
          seen = seen || any;
          all_seen = all_seen && all;
        }
        if (!__any_sync(0xffffffffu, seen)) continue;
        all_seen = __all_sync(0xffffffffu, all_seen);
        float lse[kRows], dl[kRows];
#pragma unroll
        for (int e = 0; e < kRows; ++e) {
          const int row = q0 + lane + 32 * e;
          const bool in = row < p.s_len;
          lse[e] = in ? __ldg(p.lse + stat0 + row) * kLog2e : INFINITY;
          dl[e] = in ? __ldg(p.delta + stat0 + row) : 0.0f;
        }
        mbar_wait(bar_empty(stage), phase ^ 1);
        float* st_lse = s_stat + stage * 3 * C::kQB;
#pragma unroll
        for (int e = 0; e < kRows; ++e) {
          st_lse[lane + 32 * e] = lse[e];
          st_lse[C::kQB + lane + 32 * e] = dl[e];
          reinterpret_cast<int*>(st_lse)[2 * C::kQB + lane + 32 * e] = qp[e];
        }
        if (lane == 0) {
          s_tile[2 * stage] = 1;
          s_tile[2 * stage + 1] = all_seen ? 1 : 0;
        }
        __syncwarp();
        if (lane == 0) {
          mbar_expect_tx(bar_full(stage), 2 * C::kColStage);
          const uint32_t q_dst = base + C::kColOffQ + stage * C::kColStage;
          const uint32_t do_dst = base + C::kColOffDo + stage * C::kColStage;
#pragma unroll
          for (int c = 0; c < C::kChunks; ++c) {
            tma_load_4d(q_dst + c * C::kChunkQB, &tm_q, bar_full(stage), 64 * c, h, q0, b);
            tma_load_4d(do_dst + c * C::kChunkQB, &tm_do, bar_full(stage), 64 * c, h, q0, b);
          }
        }
        if (++stage == C::kColStages) {
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
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const volatile int* s_tile_v = s_tile;
    const int wg = warp >> 2;
    const int kr0 = 64 * wg + 16 * (warp & 3) + (lane >> 2);  // keys kr0 and kr0 + 8 of the block
    int kp[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int j = k0 + kr0 + 8 * r;
      kp[r] = j < p.sk_len ? __ldg(p.kpos + j) : -1;
    }
    float acc_k[C::kChunks][32], acc_v[C::kChunks][32];
#pragma unroll
    for (int c = 0; c < C::kChunks; ++c) {
#pragma unroll
      for (int i = 0; i < 32; ++i) acc_k[c][i] = acc_v[c][i] = 0.0f;
    }
    float s[C::kQB / 2], dp[C::kQB / 2];
#pragma unroll
    for (int i = 0; i < C::kQB / 2; ++i) s[i] = dp[i] = 0.0f;
    const uint32_t k_addr = base + wg * 64 * 128;
    const uint32_t v_addr = base + C::kColOffV + wg * 64 * 128;
    turns_begin(wg);
    mbar_wait(bar_kv, 0);

    int stage = 0;
    int phase = 0;
    while (true) {
      mbar_wait(bar_full(stage), phase);
      if (s_tile_v[2 * stage] < 0) break;
      const bool all_seen = s_tile_v[2 * stage + 1] != 0;
      const uint32_t q_addr = base + C::kColOffQ + stage * C::kColStage;
      const uint32_t do_addr = base + C::kColOffDo + stage * C::kColStage;
      const float* st_lse = s_stat + stage * 3 * C::kQB;
      pin(s);
      pin(dp);
      turn_wait(wg);
      wgmma_fence();
      issue_nt<DH, C::kQB>(s, k_addr, C::kChunkKB, q_addr, C::kChunkQB);    // S^T = K.Q^T
      issue_nt<DH, C::kQB>(dp, v_addr, C::kChunkKB, do_addr, C::kChunkQB);  // dP^T = V.dO^T
      wgmma_commit();
      turn_pass(wg);
      wgmma_wait_all();
      pin(s);
      pin(dp);
      const float* dl_s = st_lse + C::kQB;
      const int* qp_s = reinterpret_cast<const int*>(st_lse + 2 * C::kQB);
      constexpr int N = C::kQB;
      if (p.cap != 0.0f) {
        if (all_seen) p_ds_cols<N, true, false>(s, dp, kp, st_lse, dl_s, qp_s, lane, p);
        else p_ds_cols<N, true, true>(s, dp, kp, st_lse, dl_s, qp_s, lane, p);
      } else if (all_seen) {
        p_ds_cols<N, false, false>(s, dp, kp, st_lse, dl_s, qp_s, lane, p);
      } else {
        p_ds_cols<N, false, true>(s, dp, kp, st_lse, dl_s, qp_s, lane, p);
      }
      uint32_t ph[C::kQSteps][4], pl[C::kQSteps][4], gh[C::kQSteps][4], gl[C::kQSteps][4];
      split_pack<C::kQSteps>(s, ph, pl);
      split_pack<C::kQSteps>(dp, gh, gl);
#pragma unroll
      for (int j = 0; j < C::kQSteps; ++j) {
        pin(ph[j]);
        pin(pl[j]);
        pin(gh[j]);
        pin(gl[j]);
      }
#pragma unroll
      for (int c = 0; c < C::kChunks; ++c) {
        pin(acc_k[c]);
        pin(acc_v[c]);
      }
      wgmma_fence();
      issue_grad<DH, C::kQSteps>(acc_v, ph, pl, do_addr, C::kChunkQB);   // dv += P^T.dO
      issue_grad<DH, C::kQSteps>(acc_k, gh, gl, q_addr, C::kChunkQB);    // dk += dS^T.Q
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int c = 0; c < C::kChunks; ++c) {
        pin(acc_k[c]);
        pin(acc_v[c]);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(bar_empty(stage));
      if (++stage == C::kColStages) {
        stage = 0;
        phase ^= 1;
      }
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int j = k0 + kr0 + 8 * r;
      if (j >= p.sk_len) continue;
      const int64_t row = ((static_cast<int64_t>(b) * p.sk_len + j) * p.kv_heads + kvh) * DH;
#pragma unroll
      for (int c = 0; c < C::kChunks; ++c) {
#pragma unroll
        for (int g = 0; g < 8; ++g) {
          const int col = 64 * c + 8 * g + 2 * (lane & 3);
          if (col < DH) {
            const int i = 4 * g + 2 * r;
            *reinterpret_cast<__nv_bfloat162*>(p.dk + row + col) =
                __floats2bfloat162_rn(acc_k[c][i] * p.scale, acc_k[c][i + 1] * p.scale);
            *reinterpret_cast<__nv_bfloat162*>(p.dv + row + col) =
                __floats2bfloat162_rn(acc_v[c][i], acc_v[c][i + 1]);
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
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault,
                                              &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(ptr);
    }
  }
  return fn;
}

// A 4-D map over a contiguous (B, rows, heads, dh) bf16 tensor, dh
// innermost, read in boxes of 64 columns x 1 head x box_rows rows; rows
// past `rows` and columns past dh read as zeros.
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

// Once per kernel and card: refuse a build whose register count at entry
// is smaller than setmaxnreg hands out (the consumers would wait forever),
// and raise the dynamic shared memory limit.
template <typename K>
int prepare(K kernel, int bytes, bool (&ready)[kMaxDevices], int device) {
  if (device < kMaxDevices && ready[device]) return 0;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (attr.numRegs * kThreads < kProducerRegs * 128 + kConsumerRegs * 32 * kConsumerWarps) {
    return kErrRegisters;
  }
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device < kMaxDevices) ready[device] = true;
  return 0;
}

template <int DH>
int launch(const void* q, const void* k, const void* v, const void* dout, const Params& p0,
           int b, cudaStream_t stream) {
  using C = Cfg<DH>;
  const int s = p0.s_len, sk = p0.sk_len, h = p0.heads, kvh = p0.kv_heads;
  // (a), (c): q and dO in 128-row boxes, k and v in 64; (b) the other way
  CUtensorMap rq, rdo, rk, rv, cq, cdo, ck, cv;
  int err = 0;
  if ((err = make_map(&rq, q, DH, h, s, b, C::kBQ)) != 0) return err;
  if ((err = make_map(&rdo, dout, DH, h, s, b, C::kBQ)) != 0) return err;
  if ((err = make_map(&rk, k, DH, kvh, sk, b, C::kBK)) != 0) return err;
  if ((err = make_map(&rv, v, DH, kvh, sk, b, C::kBK)) != 0) return err;
  if ((err = make_map(&cq, q, DH, h, s, b, C::kQB)) != 0) return err;
  if ((err = make_map(&cdo, dout, DH, h, s, b, C::kQB)) != 0) return err;
  if ((err = make_map(&ck, k, DH, kvh, sk, b, C::kKB)) != 0) return err;
  if ((err = make_map(&cv, v, DH, kvh, sk, b, C::kKB)) != 0) return err;

  int device = 0;
  cudaError_t derr = cudaGetDevice(&device);
  if (derr != cudaSuccess) return static_cast<int>(derr);
  static bool ready[3][kMaxDevices] = {};
  auto stats = stats_tc_kernel<DH>;
  auto dkdv = dkdv_tc_kernel<DH>;
  auto dq = dq_tc_kernel<DH>;
  if ((err = prepare(stats, C::kRowBytes, ready[0], device)) != 0) return err;
  if ((err = prepare(dkdv, C::kColBytes, ready[1], device)) != 0) return err;
  if ((err = prepare(dq, C::kRowBytes, ready[2], device)) != 0) return err;

  const dim3 rows(static_cast<unsigned>((s + C::kBQ - 1) / C::kBQ), static_cast<unsigned>(b * h));
  const dim3 keys(static_cast<unsigned>((sk + C::kKB - 1) / C::kKB),
                  static_cast<unsigned>(b * kvh));
  stats<<<rows, kThreads, C::kRowBytes, stream>>>(rq, rdo, rk, rv, p0);
  derr = cudaGetLastError();
  if (derr != cudaSuccess) return static_cast<int>(derr);
  dkdv<<<keys, kThreads, C::kColBytes, stream>>>(cq, cdo, ck, cv, p0);
  derr = cudaGetLastError();
  if (derr != cudaSuccess) return static_cast<int>(derr);
  dq<<<rows, kThreads, C::kRowBytes, stream>>>(rq, rdo, rk, rv, p0);
  return static_cast<int>(cudaGetLastError());
}

template <int DH>
int smem_of(int pass) {
  return pass == 1 ? Cfg<DH>::kColBytes : Cfg<DH>::kRowBytes;
}

}  // namespace

// Plain C interface, loaded with ctypes. flash_attention_bwd_tc builds
// the eight TMA maps, enqueues the three kernels on `stream` and returns 0,
// the first cudaError_t that is not 0, or a negative code of this library
// (flash_attention_bwd_tc_error_string names each); it never synchronises
// and allocates nothing: lse and delta are (B, H, S) float32 scratch from
// the caller. The caller guarantees s, sk >= 1, b * h >= 1, dh one of 64,
// 96, 112, 128, h % kvh == 0, contiguous bf16 q, do, dq (B, S, H, dh) and
// k, v, dk, dv (B, Sk, KV, dh) with 16-byte aligned bases for q, k, v, do,
// int32 positions, all on the current device, and the envelope
// (kernels/envelope.outside_flash_bwd_tc_envelope).
extern "C" {

const char* flash_attention_bwd_tc_error_string(int err) {
  switch (err) {
    case kErrNoEncoder:
      return "cuTensorMapEncodeTiled not found through cudaGetDriverEntryPoint";
    case kErrEncode:
      return "cuTensorMapEncodeTiled refused a tensor map";
    case kErrHeadDim:
      return "no tensor-core backward instantiation for this head width";
    case kErrRegisters:
      return "compiled with fewer registers at entry than setmaxnreg hands out";
    default:
      return cudaGetErrorString(static_cast<cudaError_t>(err));
  }
}

// Dynamic shared memory of pass 0 (row statistics), 1 (dk, dv) or 2 (dq)
// at head width dh (negative for a width with no instantiation):
// envelope.flash_bwd_tc_smem_bytes.
int flash_attention_bwd_tc_smem_bytes(int pass, int dh) {
  if (pass < 0 || pass > 2) return kErrHeadDim;
  switch (dh) {
    case 64: return smem_of<64>(pass);
    case 96: return smem_of<96>(pass);
    case 112: return smem_of<112>(pass);
    case 128: return smem_of<128>(pass);
    default: return kErrHeadDim;
  }
}

int flash_attention_bwd_tc(const void* q, const void* k, const void* v, const void* dout,
                           const int* qpos, const int* kpos, void* dq, void* dk, void* dv,
                           float* lse, float* delta, int b, int s, int sk, int h, int kvh, int dh,
                           float scale, int causal, int window, float cap, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Params p{qpos, kpos, lse, delta, static_cast<__nv_bfloat16*>(dq),
                 static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv),
                 s, sk, h, kvh, causal, window, scale, cap};
  switch (dh) {
    case 64: return launch<64>(q, k, v, dout, p, b, st);
    case 96: return launch<96>(q, k, v, dout, p, b, st);
    case 112: return launch<112>(q, k, v, dout, p, b, st);
    case 128: return launch<128>(q, k, v, dout, p, b, st);
    default: return kErrHeadDim;
  }
}

}  // extern "C"

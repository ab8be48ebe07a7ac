// Monte-Carlo non-ideal ADC evaluation for Hopper (sm_90a).
//
// Replaces (reference package, src/repro/kernels/mc_eval.py):
//   mc_eval<false> <- mc_adc_eval_pallas_population (:129)
//                     and mc_adc_eval_pallas (:92), the P=1 case
//   mc_eval<true>  <- mc_adc_eval_cal_pallas_population (:231)
//                     and mc_adc_eval_cal_pallas (:194), the P=1 case
//
// What it computes, for one shared sample batch x (M, C), P designs and
// S perturbed hardware instances (core/nonideal.py compiles the operands):
//   u[s,m,c]     = (x[m,c] - lo[s,c]) * scale[s,c]        code position
//   out[p,s,m,c] = sum over k of values[.., c, k]
//                  where lb[p,s,c,k] <= u[s,m,c] < ub[p,s,c,k]
// lb/ub are (P, S, C, 2^N) interval tables; values are the nominal ladder
// (C, 2^N) shared by every (p, s), or, for calibrated tables, one ladder
// per (p, s): (P, S, C, 2^N). lo/scale (S, C) are shared across designs
// (common random numbers). All float32; out is (P, S, M, C).
//
// Bound on an H100 SXM: bytes. It writes P*S*M*C floats and reads x, the
// tables and the rows once, at 3.35 TB/s. At the search shape (P=16,
// S=32, cardio test split M=636, C=21, 2^N=16) that is 28.8 MB, 8.59 us
// (Tensor.fill_ writes the same output in 8.59 us on an H100 80GB HBM3 at
// 700 W). The selection itself is 2^N leaf tests an output, three issue
// slots each; the card runs 9.5 T leaf tests/s in this kernel's
// arrangement from registers (tools/mc_eval_ab.py --leaf-ceiling), so the
// search shape's 109 M tests need 11.6 us, and with the position, key,
// load and store (472 instructions a batch of 8 rows at 2^N = 16, 384 of
// them leaf tests) about 14.2 us: issue, not HBM, sets the floor. It
// runs at 20.4 us, 70 % of that issue rate (PERF.md, findings).
//
// Design. A thread owns one channel of one (p, s) and runs the 2^N leaves
// of that channel from registers, unrolled at compile time for 2^N in
// {2, 4, 8, 16, 32} (three registers a leaf; 2^N = 64 would need 192).
// A leaf [lb, ub) is tested on integer order keys: (unsigned)(key(u) -
// key(lb)) < width, one subtract and one compare where two float compares
// ran slower (8.2 against 9.5 T tests/s), then a predicated add.rn. Block
// (x, y) takes (p, s) = x and chunk y of M. It stages that (p, s)'s
// leaves in shared memory once, by coalesced loads, as keys, widths and
// values, k-major ([2^N][C]: at one k the threads of a warp read
// neighbouring words, the lanes of one channel the same word); each
// thread then copies its channel's leaves into registers. Loading them
// from global memory straight into registers by 16-byte loads, the first
// design, ran at 53-59 us: every row lane of every chunk reloaded the
// table in a scattered pattern. Thread t takes channel t % C and row lane
// t / C, R = 128 / C lanes a block (one lane, and channels t, t + 128,
// ... where C > 128), so neighbouring threads write neighbouring words of
// out[p, s]; a lane walks rows m, m + R, ... of its chunk kBatch at a
// time (their x loads in flight together, kBatch independent sums a
// leaf), and only a chunk's last batch checks its rows. A chunk holds at
// most kChunkBytes of x, so it stays in an SM's L1 across the (p, s) of
// one chunk that the SM takes in turn (x is gridDim.x, the fastest), and
// M is cut finer where P*S alone gives fewer than kMinBlocks blocks. 128 threads, 64 KB chunks and batches of 8 rows were the
// fastest of the variants timed (PERF.md, findings). (p, s) and chunks loop
// beyond the grid's limits. envelope.mc_geometry mirrors the geometry and
// mc_eval_geometry below returns it. The tile knob (block_m, the
// reference's Pallas M-tile) sets a chunk's rows, a whole number of row
// lanes x kBatch; a tile the kernel cannot take is refused with a negative
// code, never clamped. A chunk decides which block computes which rows,
// never an output's sum order, so every tile gives the same bits. Any
// other leaf count (2^N = 64, 128, ...) runs the same kernel with a
// run-time leaf loop over the staged leaves, each shared-memory read
// serving the batch's 8 rows.
//
// Exactness. u rounds the subtract and the multiply separately
// (__fsub_rn, __fmul_rn), as the plain version's two PyTorch operations
// do; the build uses no fast-math, and the intrinsics are never contracted
// into a fused multiply-add. key(f) orders floats as float compares do
// (-0.0 shares +0.0's key; a NaN keys outside every interval), and an
// empty or NaN-bounded leaf has width 0, so the live leaves are exactly
// those with lb <= u < ub. out starts at 0.0f and adds each live value in
// k order with round-to-nearest adds, for any lb/ub: the plain version's
// selection sum bit for bit. A NaN position selects nothing (0.0), and a
// selected -0.0 gives +0.0 in both.

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kThreads = 128;              // threads per block
constexpr int kBatch = 8;                  // rows a lane carries at once
constexpr int64_t kChunkBytes = 65536;    // x bytes of a block's chunk of M
constexpr int64_t kMinBlocks = 264;        // two blocks an SM of an H100
constexpr size_t kDefaultSmem = 48 * 1024;
constexpr int64_t kMaxGridX = 2147483647;
constexpr int64_t kMaxGridY = 65535;
constexpr int64_t kMaxChunkRows = int64_t{1} << 30;  // a chunk's rows fit 32-bit ints

int64_t ceil_div(int64_t a, int64_t b) { return (a + b - 1) / b; }

struct Geometry {
  int row_lanes;       // R: rows a block walks side by side
  int64_t chunk_rows;  // rows of M a block takes, R * kBatch * a whole number
  int64_t chunks;      // chunks of M, over gridDim.y
  int64_t grid_x;      // (p, s) looped with this stride
  int64_t grid_y;      // chunks looped with this stride
  int leaves;          // the unrolled leaf count, 0: run-time leaf loop
  size_t smem;         // dynamic shared memory a block asks for
};

// Tiles the kernel cannot take (envelope.mc_tile_error names the same
// limits); returned by the geometry export and the launcher.
constexpr int kTileBelowOne = -1;
constexpr int kTileNotWholeBatches = -2;
constexpr int kTileAboveMaxChunkRows = -3;

// The launch of a call; block_m > 0 (the tile knob) sets the chunk's rows
// and nothing else, block_m = 0 keeps the heuristic. Returns 0, or a
// kTile* code for a tile the kernel cannot take (never clamped).
int geometry_of(int64_t m, int c, int n, int64_t ps_total, int64_t block_m, Geometry& g) {
  g.row_lanes = c >= kThreads ? 1 : kThreads / c;
  if (block_m > 0) {
    if (block_m % (int64_t{g.row_lanes} * kBatch) != 0) return kTileNotWholeBatches;
    if (block_m > kMaxChunkRows) return kTileAboveMaxChunkRows;
    g.chunk_rows = block_m;
  } else if (block_m < 0) {
    return kTileBelowOne;
  } else {
    const int64_t batches = ceil_div(ceil_div(m, g.row_lanes), kBatch);  // a lane's
    const int64_t batch_bytes = int64_t{4} * c * g.row_lanes * kBatch;   // of x
    int64_t chunks = ceil_div(batches, batch_bytes < kChunkBytes ? kChunkBytes / batch_bytes : 1);
    int64_t fill = ceil_div(kMinBlocks, ps_total);
    if (fill > batches) fill = batches;
    if (chunks < fill) chunks = fill;
    g.chunk_rows = int64_t{g.row_lanes} * kBatch * ceil_div(batches, chunks);
  }
  g.chunks = ceil_div(m, g.chunk_rows);
  g.grid_x = ps_total < kMaxGridX ? ps_total : kMaxGridX;
  g.grid_y = g.chunks < kMaxGridY ? g.chunks : kMaxGridY;
  const bool unrolled = n == 2 || n == 4 || n == 8 || n == 16 || n == 32;
  g.leaves = unrolled ? n : 0;
  g.smem = sizeof(float) * 3 * static_cast<size_t>(c) * n;
  return 0;
}

// A float's place in float order as an int: f1 < f2 exactly where
// key(f1) < key(f2) for any non-NaN f1, f2 (-0.0 is made +0.0 first, so
// the two zeros share a key). A NaN keys above key(+inf) or below
// key(-inf), outside every interval below.
__device__ __forceinline__ int order_key(float f) {
  const int b = __float_as_int(__fadd_rn(f, 0.0f));
  return b ^ ((b >> 31) & 0x7fffffff);
}

// The leaf [lb, ub) as (key(lb), width): lb <= u < ub exactly where
// (unsigned)(key(u) - key(lb)) < width. Width 0 where no u is inside
// (lb >= ub, or either is NaN). All widths fit: key(+inf) - key(-inf) <
// 2^32, and so does the distance from any key below key(lb) to key(ub).
__device__ __forceinline__ void leaf_keys(float lb, float ub, int& key, unsigned& width) {
  key = order_key(lb);
  width = lb < ub ? static_cast<unsigned>(order_key(ub)) - static_cast<unsigned>(key) : 0u;
}

// acc += v where key(u) lies in [key, key + width): one integer
// subtract, one unsigned compare, one predicated round-to-nearest add
__device__ __forceinline__ void select_add(float& acc, int ku, int key, unsigned width,
                                           float v) {
  asm("{\n\t.reg .pred p;\n\t.reg .u32 d;\n\t"
      "sub.u32 d, %1, %2;\n\t"
      "setp.lt.u32 p, d, %3;\n\t"
      "@p add.rn.f32 %0, %0, %4;\n\t}"
      : "+f"(acc)
      : "r"(ku), "r"(key), "r"(width), "f"(v));
}

// key of the code position u = (x - lo) * scale, each step rounded once
__device__ __forceinline__ int position_key(const float* xp, float lo, float sc) {
  return order_key(__fmul_rn(__fsub_rn(__ldg(xp), lo), sc));
}

// One block per (p, s) and chunk of M (see the header). kLeaves > 0: each
// thread copies its channel's staged leaves into registers and the leaf
// loop is unrolled; 0: the leaf loop runs over shared memory, n leaves.
template <bool kPerInstanceValues, int kLeaves>
__global__ void __launch_bounds__(kThreads, kLeaves == 32 ? 2 : 4)
mc_eval_kernel(const float* __restrict__ x, const float* __restrict__ lb,
               const float* __restrict__ ub, const float* __restrict__ values,
               const float* __restrict__ lo, const float* __restrict__ scale,
               float* __restrict__ out, int64_t m, int c, int n, int64_t ps_total,
               int s_count, int64_t chunk_rows, int64_t chunks, int row_lanes) {
  extern __shared__ int smem[];
  const int cn = c * n;                      // the envelope keeps it < 2^16
  int* s_key = smem;
  unsigned* s_width = reinterpret_cast<unsigned*>(smem + cn);
  float* s_val = reinterpret_cast<float*>(smem + 2 * cn);
  const int nn = kLeaves ? kLeaves : n;
  const int lane = static_cast<int>(threadIdx.x) / c;   // 0 where C >= kThreads
  const int step = row_lanes * c;                         // a lane's step

  for (int64_t ps = blockIdx.x; ps < ps_total; ps += gridDim.x) {
    const int64_t s = ps % s_count;
    const float* lb_ps = lb + ps * cn;
    const float* ub_ps = ub + ps * cn;
    const float* val_ps = values + (kPerInstanceValues ? ps * cn : 0);
    __syncthreads();                 // the previous (p, s) is done with smem
    for (int i = threadIdx.x; i < cn; i += kThreads) {
      const int t = (i % nn) * c + i / nn;       // (c, k) -> k-major
      leaf_keys(__ldg(lb_ps + i), __ldg(ub_ps + i), s_key[t], s_width[t]);
      s_val[t] = __ldg(val_ps + i);
    }
    __syncthreads();
    if (lane >= row_lanes) continue;             // C does not divide kThreads
    for (int ch = static_cast<int>(threadIdx.x) % c; ch < c; ch += kThreads) {
      const float lo_c = __ldg(lo + s * c + ch);
      const float sc_c = __ldg(scale + s * c + ch);
      constexpr int kRegs = kLeaves ? kLeaves : 1;
      int r_key[kRegs];
      unsigned r_width[kRegs];
      float r_val[kRegs];
      if constexpr (kLeaves > 0) {
#pragma unroll
        for (int k = 0; k < kLeaves; ++k) {
          r_key[k] = s_key[k * c + ch];
          r_width[k] = s_width[k * c + ch];
          r_val[k] = s_val[k * c + ch];
        }
      }
      for (int64_t chunk = blockIdx.y; chunk < chunks; chunk += gridDim.y) {
        const int64_t start = chunk * chunk_rows;
        const int64_t last = m < start + chunk_rows ? m : start + chunk_rows;
        const int64_t first = start + lane;
        // the lane's rows of the chunk are first + r for r = 0, R, 2R, ...
        // < rows; a chunk has at most kMaxChunkRows rows, so r and the
        // offsets below fit an int
        const int rows = first < last ? static_cast<int>(last - first) : 0;
        const float* xp = x + first * c + ch;
        float* op = out + (ps * m + first) * c + ch;
        // kBatch rows of the lane at once: their loads in flight together,
        // kBatch independent sums for each leaf; only a chunk's last batch
        // checks its rows
        int r = 0;
        auto batch = [&](auto tail) {
          constexpr bool kTail = decltype(tail)::value;
          int ku[kBatch];
          float acc[kBatch];
#pragma unroll
          for (int i = 0; i < kBatch; ++i) {
            const bool in = !kTail || r + i * row_lanes < rows;
            ku[i] = in ? position_key(xp + i * step, lo_c, sc_c) : 0;
            acc[i] = 0.0f;
          }
          if constexpr (kLeaves > 0) {
#pragma unroll
            for (int k = 0; k < kLeaves; ++k) {
#pragma unroll
              for (int i = 0; i < kBatch; ++i) {
                select_add(acc[i], ku[i], r_key[k], r_width[k], r_val[k]);
              }
            }
          } else {
            for (int k = 0; k < n; ++k) {
              const int key = s_key[k * c + ch];
              const unsigned width = s_width[k * c + ch];
              const float v = s_val[k * c + ch];
#pragma unroll
              for (int i = 0; i < kBatch; ++i) select_add(acc[i], ku[i], key, width, v);
            }
          }
#pragma unroll
          for (int i = 0; i < kBatch; ++i) {
            if (!kTail || r + i * row_lanes < rows) op[i * step] = acc[i];
          }
        };
        for (; r + (kBatch - 1) * row_lanes < rows; r += kBatch * row_lanes) {
          batch(std::false_type{});
          xp += kBatch * step;
          op += kBatch * step;
        }
        if (r < rows) batch(std::true_type{});
      }
    }
  }
}

template <bool kCal, int kLeaves>
int launch(const Geometry& g, const float* x, const float* lb, const float* ub,
           const float* values, const float* lo, const float* scale, float* out,
           int64_t m, int c, int n, int64_t ps_total, int s, cudaStream_t stream) {
  auto kernel = mc_eval_kernel<kCal, kLeaves>;
  if (g.smem > kDefaultSmem) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(g.smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(static_cast<unsigned>(g.grid_x), static_cast<unsigned>(g.grid_y));
  kernel<<<grid, kThreads, g.smem, stream>>>(x, lb, ub, values, lo, scale, out, m, c, n,
                                             ps_total, s, g.chunk_rows, g.chunks, g.row_lanes);
  return static_cast<int>(cudaGetLastError());
}

template <bool kCal>
int dispatch(const Geometry& g, const float* x, const float* lb, const float* ub,
             const float* values, const float* lo, const float* scale, float* out,
             int64_t m, int c, int n, int64_t ps_total, int s, cudaStream_t st) {
  switch (g.leaves) {
    case 2: return launch<kCal, 2>(g, x, lb, ub, values, lo, scale, out, m, c, n, ps_total, s, st);
    case 4: return launch<kCal, 4>(g, x, lb, ub, values, lo, scale, out, m, c, n, ps_total, s, st);
    case 8: return launch<kCal, 8>(g, x, lb, ub, values, lo, scale, out, m, c, n, ps_total, s, st);
    case 16: return launch<kCal, 16>(g, x, lb, ub, values, lo, scale, out, m, c, n, ps_total, s, st);
    case 32: return launch<kCal, 32>(g, x, lb, ub, values, lo, scale, out, m, c, n, ps_total, s, st);
    default: return launch<kCal, 0>(g, x, lb, ub, values, lo, scale, out, m, c, n, ps_total, s, st);
  }
}

}  // namespace

// Plain C interface, loaded with ctypes. The launcher enqueues one kernel on
// `stream` and returns cudaGetLastError() (0 on success); it never
// synchronises and allocates nothing. The caller guarantees contiguous
// float32 operands on the current device and the shared-memory envelope
// (kernels/envelope.py); a call with no outputs (m, c, p or s 0) launches
// nothing.
extern "C" {

const char* mc_eval_error_string(int err) {
  switch (err) {
    case kTileBelowOne: return "Monte-Carlo tile: block_m below 1 row";
    case kTileNotWholeBatches:
      return "Monte-Carlo tile: block_m not a whole number of row lanes x kBatch rows";
    case kTileAboveMaxChunkRows: return "Monte-Carlo tile: block_m above kMaxChunkRows (2^30)";
    default: return cudaGetErrorString(static_cast<cudaError_t>(err));
  }
}

// The launch geometry of a call with m, c, p, s >= 1 at tile block_m (0:
// the heuristic), as envelope.mc_geometry computes it: out[0..7] =
// threads, row lanes, chunk rows, chunks, grid x, grid y, unrolled leaf
// count (0: run-time leaf loop), dynamic shared memory bytes. Returns 0,
// or the kTile* code of a tile the kernel cannot take (out untouched).
int mc_eval_geometry(long long m, int c, int n, int p, int s, long long block_m,
                     long long* out) {
  Geometry g;
  const int err = geometry_of(m, c, n, static_cast<int64_t>(p) * s, block_m, g);
  if (err != 0) return err;
  out[0] = kThreads;
  out[1] = g.row_lanes;
  out[2] = g.chunk_rows;
  out[3] = g.chunks;
  out[4] = g.grid_x;
  out[5] = g.grid_y;
  out[6] = g.leaves;
  out[7] = static_cast<long long>(g.smem);
  return 0;
}

int mc_eval(const float* x, const float* lb, const float* ub, const float* values,
            const float* lo, const float* scale, float* out, long long m, int c,
            int n, int p, int s, int per_instance_values, long long block_m, void* stream) {
  if (m <= 0 || c <= 0 || p <= 0 || s <= 0) return 0;
  const int64_t ps_total = static_cast<int64_t>(p) * s;
  Geometry g;
  const int err = geometry_of(m, c, n, ps_total, block_m, g);
  if (err != 0) return err;
  auto st = static_cast<cudaStream_t>(stream);
  return per_instance_values
             ? dispatch<true>(g, x, lb, ub, values, lo, scale, out, m, c, n, ps_total, s, st)
             : dispatch<false>(g, x, lb, ub, values, lo, scale, out, m, c, n, ps_total, s, st);
}

}  // extern "C"

// Fused ADC + printed-classifier bank kernels for Hopper (sm_90a).
//
// Replaces (reference package, src/repro/kernels/qmlp.py):
//   qmlp_mlp_bank_kernel <- bespoke_mlp_bank_pallas (:210)
//                           and bespoke_mlp_pallas (:140), the D=1 case
//   qmlp_svm_bank_kernel <- bespoke_svm_bank_pallas (:250)
//                           and bespoke_svm_pallas (:178), the D=1 case
//
// What they compute, for D deployed designs against one shared batch x (M, F):
//   code[m,f] = clamp(floor((x[m,f] - lo[f]) * scale[f]), 0, 2^N - 1)
//   q[d,m,f]  = table[d, f, code[m,f]]
//   mlp: out[d,m,:] = relu(q[d,m,:] @ W1[d] + b1[d]) @ W2[d] + b2[d]
//   svm: out[d,m,:] = q[d,m,:] @ W[d] + b[d]
// All float32; out is (D, M, O).
//
// Bound on an H100 SXM. Bytes that must move:
//   4 * (M*F + D*M*O + D*(F*2^N + F*H + H + H*O + O) + 2*F)  at 3.35 TB/s;
// operations: 2*D*M*(F*H + H*O) at 67 TFLOP/s (f32, no tensor cores).
// At the serve shapes (D <= 6, M = 1024) both are well under a tenth of a
// microsecond, so a launch is bound by its latency: the launch, the round
// trips that bring x and the operands, and a thread's chain of F
// dependent code -> gather -> multiply-add steps. At the wide shape (D =
// 64, M = 65536, cardio's MLP) the bound is 16.7 us of bytes; the
// multiply-adds need 15 us at the float32 peak, and every (design, row,
// feature) needs one table gather from shared memory, so shared-memory
// instructions, not bytes, set the pace there (PERF.md).
//
// Design. The Pallas body is a one-hot selection sum over the 2^N codes,
// because gathers are weak on the TPU's vector unit. On Hopper it is a
// gather from tables held in shared memory. One device body serves both
// classifiers (the SVM is the MLP without its hidden layer). Block (x, y)
// takes a tile of R sample rows and a group of G designs: the largest
// group whose operands fit kGroupBytes (at most kMaxGroup) that still
// leaves kMinBlocks blocks (one an SM) of full tiles, so G = 1 at the
// serve shapes (each block stages one design) and 16 at the wide one; R,
// a multiple of 4, is cut so that the tiles times the groups give
// kMinBlocks blocks wherever M allows, at most kMaxRows rows and
// kCodeWords codes. All kThreads threads first load the block's x tile,
// coalesced, eight loads a thread in flight; while those are in flight
// the warps stage the group's tables, weights and biases side by side
// (each operand by its own threads, so none waits on another's loads;
// this is a third of a serve call), weight rows padded to a multiple of 4
// words. Each (row, feature) code is computed once, as a table offset f *
// 2^N + code, into shared memory, feature-major (F, R), and serves every
// design of the group; its 16-byte words are swizzled by feature so that
// the transposing writes spread over the banks. Thread t < (R / 4) * L
// then takes 4 rows (one 16-byte word of codes a feature) and design lane
// t / (R / 4) of L = min(G, kThreads / (R / 4)), and runs designs lane,
// lane + L, ... of the group: a 16-byte weight read and a code word serve
// 4 rows, which cut the shared-memory instructions per (design, row,
// feature) from 4 to 1.75 (one row a thread ran the wide MLP at 200 us).
// Hidden units and logits run in register chunks (kHChunk, kOChunk), so
// any H and O run. Where O <= kOChunk and a warp holds 32 consecutive row
// groups of one design, the warp puts its logits through a run in shared
// memory and writes them as one contiguous run of 16-byte streaming
// stores (scattered stores from 4 rows a thread cost as much again); the
// serve shapes' few threads store directly. One design at the edge of
// the envelope runs the same body unpadded, one row a thread.
// envelope.bank_geometry mirrors the geometry and qmlp_bank_geometry
// below returns it. The tile knob (block_m, the reference's Pallas M-tile)
// sets R alone, the group and the layout staying the heuristic's; a tile
// the kernel cannot take is refused with a negative code, never clamped.
// R decides which block computes which rows, never an output's order, so
// every tile gives the same bits (kernels/dispatch.py picks it from the
// tuned table, perf/autotune.py).
//
// Exactness. The code math uses the same f32 lo/scale rows as the plain
// version (computed on the host in f64, cast once) and rounds the subtract
// and the multiply separately (__fsub_rn, __fmul_rn), so floorf sees the
// same value; the build uses no fast-math. Every output keeps the order of
// the first bank kernel: for each hidden unit an fmaf chain over f = 0 ..
// F-1 from 0, then + b1 and the ReLU, then an fmaf chain over the hidden
// units, then + b2 (SVM: the fmaf chain over f, then + b); so the logits
// are bitwise those of that kernel on every input. Against the plain
// version's matmuls (another order) they agree bitwise where every partial
// sum is exact (dyadic tables, power-of-two weights, fixed-point biases:
// every exported front) and to rounding otherwise.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;              // threads per block (8 warps)
constexpr int kRowsPerThread = 4;          // rows a thread carries (padded layout)
constexpr int kHChunk = 8;                 // hidden units in registers at once
constexpr int kOChunk = 4;                 // logits in registers at once
constexpr int kMaxRows = 256;              // rows a block takes at most
constexpr int kCodeWords = 8192;           // codes of a block's x tile (R*F), R > 4
constexpr int kGroupBytes = 65536;         // a group's design operands, G > 1
constexpr int kMaxGroup = 16;              // designs a block serves
constexpr int kWarpRun = 32 * kRowsPerThread * kOChunk;  // a warp's staged logits
constexpr int64_t kMinBlocks = 132;        // one block an SM of an H100
constexpr int64_t kSmemMax = 232448;       // opt-in shared memory a block may use
constexpr int64_t kMaxGridX = 2147483647;
constexpr size_t kDefaultSmem = 48 * 1024;

int64_t ceil_div(int64_t a, int64_t b) { return (a + b - 1) / b; }
__host__ __device__ inline int64_t round4(int64_t v) { return (v + 3) / 4 * 4; }

// float words of g designs' staged operands, each operand a region of its
// own; padded: weight rows padded to a multiple of 4 and every region to a
// multiple of 4 words, so each starts on 16 bytes
int64_t operand_words(bool mlp, bool pad, int64_t g, int64_t f, int64_t n, int64_t h,
                      int64_t o) {
  auto region = [pad](int64_t w) { return pad ? round4(w) : w; };
  const int64_t op = pad ? round4(o) : o;
  if (!mlp) return region(g * f * n) + region(g * f * op) + region(g * o);
  const int64_t hp = pad ? round4(h) : h;
  return region(g * f * n) + region(g * f * hp) + region(g * h) + region(g * h * op) +
         region(g * o);
}

struct Geometry {
  int rows;        // R: sample rows a block takes
  int per_thread;  // rows a thread carries: kRowsPerThread, 1 unpadded
  int lanes;       // L: design lanes; (R / per_thread) * L threads compute
  int group;       // G: designs a block serves
  int64_t groups;  // ceil(D / G), grid y
  int64_t tiles;   // ceil(M / R)
  int64_t grid_x;  // tiles looped with this stride
  bool pad;        // weight rows padded to 16 bytes
  bool staged;     // each warp's logits go out as one contiguous run
  size_t smem;
};

// a warp of 32 units of one design stages its logits (O <= kOChunk)
bool staged_of(bool pad, int64_t rows, int o) {
  return pad && o <= kOChunk && (rows / kRowsPerThread) % 32 == 0;
}

// float words of shared memory a block of g designs and `rows` rows stages
int64_t block_words(bool mlp, bool pad, int64_t g, int64_t rows, int f, int n, int h, int o) {
  return operand_words(mlp, pad, g, f, n, h, o) + rows * f +
         (staged_of(pad, rows, o) ? (kThreads / 32) * kWarpRun : 0);
}

// Tiles the kernel cannot take (envelope.bank_tile_error names the same
// limits); returned by the geometry export and the launchers.
constexpr int kTileBelowOne = -1;
constexpr int kTileAboveMaxRows = -2;
constexpr int kTileAboveCodeWords = -3;
constexpr int kTileNotWholeRowGroups = -4;
constexpr int kTileAboveSmem = -5;

// The launch of a call; block_m > 0 sets R (the tile knob) and nothing
// else, block_m = 0 keeps the heuristic. Returns 0, or a kTile* code for a
// tile the kernel cannot take (never clamped).
int geometry_of(bool mlp, int64_t m, int f, int n, int h, int o, int d, int64_t block_m,
                Geometry& g) {
  int64_t fit = kGroupBytes / (4 * operand_words(mlp, true, 1, f, n, h, o));
  if (fit > kMaxGroup) fit = kMaxGroup;
  if (fit > d) fit = d;
  // the largest group that still leaves kMinBlocks blocks of full tiles;
  // 1 where none does
  const int64_t full = m / kMaxRows > 1 ? m / kMaxRows : 1;
  while (fit > 1 && ceil_div(d, fit) * full < kMinBlocks) --fit;
  if (fit < 1) fit = 1;
  g.groups = ceil_div(d, fit);
  g.group = static_cast<int>(ceil_div(d, g.groups));
  const int64_t by_fill = m * g.groups / kMinBlocks;
  int64_t rows = kMaxRows;
  if (rows > kCodeWords / f) rows = kCodeWords / f;
  if (rows > by_fill) rows = by_fill;
  if (rows > round4(m)) rows = round4(m);
  rows = rows / kRowsPerThread * kRowsPerThread;
  if (rows < kRowsPerThread) rows = kRowsPerThread;
  g.pad = true;
  g.per_thread = kRowsPerThread;
  if (4 * block_words(mlp, true, g.group, rows, f, n, h, o) > kSmemMax) {
    // one design near the limit (G = 1): unpadded rows, one row a thread,
    // R cut to what is left (the envelope leaves 2*F words, so R >= 2)
    g.pad = false;
    g.per_thread = 1;
    const int64_t one = operand_words(mlp, false, 1, f, n, h, o);
    rows = kMaxRows;
    if (rows > kCodeWords / f) rows = kCodeWords / f;
    if (rows > by_fill) rows = by_fill;
    if (rows > m) rows = m;
    if (rows > (kSmemMax / 4 - one) / f) rows = (kSmemMax / 4 - one) / f;
    if (rows < 1) rows = 1;
  }
  if (block_m > 0) {
    const int64_t by_codes = kCodeWords / f > g.per_thread ? kCodeWords / f : g.per_thread;
    if (block_m > kMaxRows) return kTileAboveMaxRows;
    if (block_m > by_codes) return kTileAboveCodeWords;
    if (block_m % g.per_thread != 0) return kTileNotWholeRowGroups;
    if (4 * block_words(mlp, g.pad, g.group, block_m, f, n, h, o) > kSmemMax)
      return kTileAboveSmem;
    rows = block_m;
  } else if (block_m < 0) {
    return kTileBelowOne;
  }
  g.staged = staged_of(g.pad, rows, o);
  g.rows = static_cast<int>(rows);
  const int units = g.rows / g.per_thread;
  g.lanes = g.group < kThreads / units ? g.group : kThreads / units;
  g.tiles = ceil_div(m, rows);
  g.grid_x = g.tiles < kMaxGridX ? g.tiles : kMaxGridX;
  g.smem = sizeof(float) * static_cast<size_t>(block_words(mlp, g.pad, g.group, rows, f, n, h, o));
  return 0;
}

// (a + b) mod c for a, b < c
__device__ __forceinline__ int add_mod(int a, int b, int c) {
  const int s = a + b;
  return s >= c ? s - c : s;
}

__device__ __forceinline__ int adc_code(float x, float lo, float scale, int n) {
  float u = floorf(__fmul_rn(__fsub_rn(x, lo), scale));
  u = fminf(fmaxf(u, 0.0f), static_cast<float>(n - 1));
  return static_cast<int>(u);
}

// nrows rows of `width` floats from src into rows of `stride` floats, the
// padding zeroed, by threads first .. first + count - 1 of the block (the
// caller's own); the row and column of a thread's next element are
// carried, not divided out
__device__ __forceinline__ void stage_rows(float* dst, const float* __restrict__ src, int nrows,
                                           int width, int stride, int first, int count) {
  const int i0 = static_cast<int>(threadIdx.x) - first;
  if (i0 < 0 || i0 >= count) return;
  const int total = nrows * stride;
  if (stride == width) {
#pragma unroll 4
    for (int i = i0; i < total; i += count) dst[i] = __ldg(src + i);
    return;
  }
  int r = i0 / stride, col = i0 - (i0 / stride) * stride;
  const int dr = count / stride, dc = count - (count / stride) * stride;
#pragma unroll 4
  for (int i = i0; i < total; i += count) {
    float v = 0.0f;
    if (col < width) v = __ldg(src + r * width + col);
    dst[i] = v;
    r += dr;
    col += dc;
    if (col >= stride) {
      col -= stride;
      ++r;
    }
  }
}

// the table values of RT rows' codes at feature c: the codes are
// feature-major, RT rows' codes one 16-byte word (its place in the row of
// codes swizzled by sw, see bank_body)
template <int RT>
__device__ __forceinline__ void gather(const int* s_idx, const float* tab, int c, int rows,
                                       int r0, int sw, float (&q)[RT]) {
  if constexpr (RT == 4) {
    const int4 iv = *reinterpret_cast<const int4*>(s_idx + c * rows + 4 * ((r0 >> 2) ^ (c & sw)));
    q[0] = tab[iv.x], q[1] = tab[iv.y], q[2] = tab[iv.z], q[3] = tab[iv.w];
  } else {
    q[0] = tab[s_idx[c * rows + r0]];
  }
}

// W weights from p (the first `left` of them used); padded rows are read
// as 16-byte words
template <bool kPad, int W>
__device__ __forceinline__ void weight_chunk(const float* p, int left, float (&w)[W]) {
  if constexpr (kPad) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    w[0] = a.x, w[1] = a.y, w[2] = a.z, w[3] = a.w;
    if constexpr (W == 8) {
      float4 b = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (left > 4) b = *reinterpret_cast<const float4*>(p + 4);
      w[4] = b.x, w[5] = b.y, w[6] = b.z, w[7] = b.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < W; ++k) {
      w[k] = 0.0f;
      if (k < left) w[k] = p[k];
    }
  }
}

struct BankArgs {
  const float* x;
  const float* tables;
  const float* lo;
  const float* scale;
  const float* w1;    // svm: w
  const float* b1;    // svm: b
  const float* w2;    // svm: unused
  const float* b2;    // svm: unused
  float* out;
  int64_t m;
  int f, n, h, o, d;  // svm: h unused
  int rows, lanes, group;
  int64_t tiles;
  int staged;         // warp runs through shared memory
  int vec_out;        // those runs go out as 16-byte stores
};

// The one body of both bank kernels (see the header). kPad: the padded
// layout, kRowsPerThread rows a thread; otherwise unpadded, one row.
template <bool kMlp, bool kPad>
__device__ __forceinline__ void bank_body(const BankArgs& a) {
  constexpr int RT = kPad ? kRowsPerThread : 1;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int f = a.f, n = a.n, h = kMlp ? a.h : 0, o = a.o;
  const int hp = kPad ? static_cast<int>(round4(h)) : h;
  const int op = kPad ? static_cast<int>(round4(o)) : o;
  auto region = [](int w) { return kPad ? static_cast<int>(round4(w)) : w; };
  const int group = a.group, rows = a.rows;
  // the group's operands: tables | w1 | b1 | w2 | b2 (svm: tables | w | b),
  // then the tile's codes, feature-major (F, R)
  float* s_tab = smem;
  float* s_w1 = s_tab + region(group * f * n);
  float* s_b1 = s_w1 + region(group * f * (kMlp ? hp : op));
  float* s_w2 = s_b1 + region(group * (kMlp ? h : o));
  float* s_b2 = s_w2 + (kMlp ? region(group * h * op) : 0);
  int* s_idx = reinterpret_cast<int*>(kMlp ? s_b2 + region(group * o) : s_w2);
  // each warp's logits: 32 units x RT rows x O, 16-byte aligned (staged only)
  float* s_run = reinterpret_cast<float*>(s_idx + rows * f) +
                 (threadIdx.x / 32) * kWarpRun;

  const int t = threadIdx.x;
  const int d0 = static_cast<int>(blockIdx.y) * group;
  const int count = min(group, a.d - d0);
  const int units = rows / RT;
  const int unit = t % units;
  const int lane = t / units;
  const int iters = (group + a.lanes - 1) / a.lanes;
  // codes are stored feature-major, (F, R); in the padded layout the 16-byte
  // word of rows 4q..4q+3 at feature c sits at word q ^ (c & 7) of the row,
  // so that the transposing writes below spread over the banks (R / 4 a
  // multiple of 8; otherwise unswizzled)
  const int sw = (RT == 4 && units % 8 == 0) ? 7 : 0;
  // a thread's tile elements e = t, t + kThreads, ... as (row, feature)
  const int r_first = t / f, c_first = t - (t / f) * f;
  const int r_step = kThreads / f, c_step = kThreads - (kThreads / f) * f;

  for (int64_t tile = blockIdx.x; tile < a.tiles; tile += gridDim.x) {
    const int64_t row0 = tile * rows;
    const bool first = tile == blockIdx.x;
    if (!first) __syncthreads();              // the previous tile is done with s_idx
    const int rows_here = a.m - row0 < rows ? static_cast<int>(a.m - row0) : rows;
    // x tile -> codes, eight loads a thread in flight; the first tile
    // stages the group's operands, warps in parallel, between its first
    // batch's loads and their use. Rows past the ragged end get code 0, so
    // every code a thread gathers through is in range.
    {
      const int words = rows_here * f;
      const int slots = rows * f;
      const float* xt = a.x + row0 * f;
      int r = r_first, c = c_first;
      for (int e0 = t; e0 == t || e0 < slots; e0 += 8 * kThreads) {
        float v[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const int e = e0 + k * kThreads;
          v[k] = 0.0f;
          if (e < words) v[k] = __ldg(xt + e);
        }
        if (first && e0 == t) {
          const int64_t dd = d0;
          if constexpr (kMlp) {
            stage_rows(s_tab, a.tables + dd * f * n, count * f, n, n, 0, 128);
            stage_rows(s_w1, a.w1 + dd * f * h, count * f, h, hp, 128, 64);
            stage_rows(s_w2, a.w2 + dd * h * o, count * h, o, op, 192, 32);
            stage_rows(s_b1, a.b1 + dd * h, count, h, h, 224, 16);
            stage_rows(s_b2, a.b2 + dd * o, count, o, o, 240, 16);
          } else {
            stage_rows(s_tab, a.tables + dd * f * n, count * f, n, n, 0, 160);
            stage_rows(s_w1, a.w1 + dd * f * o, count * f, o, op, 160, 64);
            stage_rows(s_b1, a.b1 + dd * o, count, o, o, 224, 32);
          }
        }
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const int e = e0 + k * kThreads;
          if (e < slots) {
            const int code = e < words ? adc_code(v[k], __ldg(a.lo + c), __ldg(a.scale + c), n) : 0;
            s_idx[c * rows + (((r >> 2) ^ (c & sw)) << 2) + (r & 3)] = c * n + code;
          }
          r += r_step;
          c += c_step;
          if (c >= f) {
            c -= f;
            ++r;
          }
        }
      }
    }
    __syncthreads();
    if (lane >= a.lanes) continue;
    const int r0 = unit * RT;                  // the thread's first row in the tile
    for (int it = 0; it < iters; ++it) {
      const int gi = lane + it * a.lanes;      // one design a warp where staged
      if (gi >= count || (!a.staged && r0 >= rows_here)) break;
      const float* tab = s_tab + gi * f * n;
      const float* w1 = s_w1 + gi * f * (kMlp ? hp : op);
      const float* b1 = s_b1 + gi * (kMlp ? h : o);
      const float* w2 = s_w2 + gi * h * op;
      const float* b2 = kMlp ? s_b2 + gi * o : b1;
      float* yr = a.out + ((d0 + gi) * a.m + row0 + r0) * o;
      for (int o0 = 0; o0 < o; o0 += kOChunk) {
        float acc_o[RT][kOChunk];
#pragma unroll
        for (int i = 0; i < RT; ++i)
#pragma unroll
          for (int k = 0; k < kOChunk; ++k) acc_o[i][k] = 0.0f;
        if constexpr (kMlp) {
          for (int h0 = 0; h0 < h; h0 += kHChunk) {
            float acc_h[RT][kHChunk];
#pragma unroll
            for (int i = 0; i < RT; ++i)
#pragma unroll
              for (int j = 0; j < kHChunk; ++j) acc_h[i][j] = 0.0f;
            // two features' loads in flight (four ran slower: 208 registers)
#pragma unroll 2
            for (int c = 0; c < f; ++c) {
              float q[RT], w[kHChunk];
              gather<RT>(s_idx, tab, c, rows, r0, sw, q);
              weight_chunk<kPad>(w1 + c * hp + h0, h - h0, w);
#pragma unroll
              for (int j = 0; j < kHChunk; ++j) {
                if (h0 + j < h) {
#pragma unroll
                  for (int i = 0; i < RT; ++i) acc_h[i][j] = fmaf(q[i], w[j], acc_h[i][j]);
                }
              }
            }
#pragma unroll
            for (int j = 0; j < kHChunk; ++j) {
              if (h0 + j < h) {
                float w[kOChunk];
                weight_chunk<kPad>(w2 + (h0 + j) * op + o0, o - o0, w);
                const float bj = b1[h0 + j];
#pragma unroll
                for (int i = 0; i < RT; ++i) {
                  const float hv = fmaxf(acc_h[i][j] + bj, 0.0f);
#pragma unroll
                  for (int k = 0; k < kOChunk; ++k)
                    if (o0 + k < o) acc_o[i][k] = fmaf(hv, w[k], acc_o[i][k]);
                }
              }
            }
          }
        } else {
          // four features' loads in flight (padded SVM; the MLP's larger
          // body ran slower unrolled)
#pragma unroll (kPad ? 4 : 1)
          for (int c = 0; c < f; ++c) {
            float q[RT], w[kOChunk];
            gather<RT>(s_idx, tab, c, rows, r0, sw, q);
            weight_chunk<kPad>(w1 + c * op + o0, o - o0, w);
#pragma unroll
            for (int k = 0; k < kOChunk; ++k) {
              if (o0 + k < o) {
#pragma unroll
                for (int i = 0; i < RT; ++i) acc_o[i][k] = fmaf(q[i], w[k], acc_o[i][k]);
              }
            }
          }
        }
        // the thread's RT rows of this chunk; staged (O <= kOChunk, a warp
        // of 32 consecutive units of one design), they are RT * O words of
        // the warp's run of 32 * RT * O contiguous logits, which the warp
        // then writes out as one run
        float* dst = a.staged ? s_run + (threadIdx.x % 32) * RT * o : yr;
#pragma unroll
        for (int k = 0; k < kOChunk; ++k) {
          if (o0 + k < o) {
            const float bk = b2[o0 + k];
#pragma unroll
            for (int i = 0; i < RT; ++i) {
              if (r0 + i < rows_here) dst[i * o + o0 + k] = acc_o[i][k] + bk;
            }
          }
        }
      }
      if (a.staged) {
        __syncwarp();
        const int first_row = r0 - (threadIdx.x % 32) * RT;   // the warp's first
        const int valid = min(32 * RT, max(0, rows_here - first_row)) * o;
        float* run = a.out + ((d0 + gi) * a.m + row0 + first_row) * o;
        const int l = threadIdx.x % 32;
        if (a.vec_out) {
          for (int i = 4 * l; i < valid; i += 128) {
            if (i + 4 <= valid) {
              __stcs(reinterpret_cast<float4*>(run + i),
                     *reinterpret_cast<const float4*>(s_run + i));
            } else {
              for (int j = i; j < valid; ++j) run[j] = s_run[j];
            }
          }
        } else {
          for (int i = l; i < valid; i += 32) run[i] = s_run[i];
        }
        __syncwarp();
      }
    }
  }
}

// The MLP's launch bounds ask for two blocks an SM (128 registers): left
// free, ptxas took more and the serve shapes ran slower.
__global__ void __launch_bounds__(kThreads, 2) qmlp_mlp_bank_kernel(BankArgs a) {
  bank_body<true, true>(a);
}

__global__ void __launch_bounds__(kThreads) qmlp_mlp_bank_kernel_unpadded(BankArgs a) {
  bank_body<true, false>(a);
}

__global__ void __launch_bounds__(kThreads) qmlp_svm_bank_kernel(BankArgs a) {
  bank_body<false, true>(a);
}

__global__ void __launch_bounds__(kThreads) qmlp_svm_bank_kernel_unpadded(BankArgs a) {
  bank_body<false, false>(a);
}

int launch(void (*kernel)(BankArgs), const Geometry& g, const BankArgs& a, cudaStream_t stream) {
  if (g.smem > kDefaultSmem) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(g.smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(static_cast<unsigned>(g.grid_x), static_cast<unsigned>(g.groups));
  kernel<<<grid, kThreads, g.smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

BankArgs args_of(const Geometry& g, const float* x, const float* tables, const float* lo,
                 const float* scale, const float* w1, const float* b1, const float* w2,
                 const float* b2, float* out, long long m, int f, int n, int h, int o, int d) {
  const bool vec = (m * o) % 4 == 0 && (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  return BankArgs{x, tables, lo, scale, w1, b1, w2, b2, out, static_cast<int64_t>(m),
                  f, n, h, o, d, g.rows, g.lanes, g.group, g.tiles, g.staged ? 1 : 0,
                  vec ? 1 : 0};
}

}  // namespace

// Plain C interface, loaded with ctypes. Each launcher enqueues one kernel on
// `stream` and returns cudaGetLastError() (0 on success); it never
// synchronises and allocates nothing. The caller guarantees contiguous
// float32 operands on the current device and the shared-memory and grid
// envelope (kernels/envelope.py); a call with no outputs launches nothing.
extern "C" {

const char* qmlp_error_string(int err) {
  switch (err) {
    case kTileBelowOne: return "bank tile: block_m below 1 row";
    case kTileAboveMaxRows: return "bank tile: block_m above kMaxRows (256) rows";
    case kTileAboveCodeWords: return "bank tile: block_m above kCodeWords / F rows";
    case kTileNotWholeRowGroups:
      return "bank tile: block_m not a multiple of kRowsPerThread (4) in the padded layout";
    case kTileAboveSmem: return "bank tile: block_m needs more than kSmemMax bytes of shared memory";
    default: return cudaGetErrorString(static_cast<cudaError_t>(err));
  }
}

// The launch geometry of a call with m, f, n, o, d >= 1 (h >= 1 for an
// MLP) at tile block_m (0: the heuristic), as envelope.bank_geometry
// computes it: out[0..11] = threads, rows, rows a thread carries, lanes,
// group, groups, tiles, grid x, grid y, weight rows padded (0/1), logits
// staged (0/1), dynamic shared memory bytes. Returns 0, or the kTile* code
// of a tile the kernel cannot take (out untouched).
int qmlp_bank_geometry(int mlp, long long m, int f, int n, int h, int o, int d,
                       long long block_m, long long* out) {
  Geometry g;
  const int err = geometry_of(mlp != 0, m, f, n, h, o, d, block_m, g);
  if (err != 0) return err;
  out[0] = kThreads;
  out[1] = g.rows;
  out[2] = g.per_thread;
  out[3] = g.lanes;
  out[4] = g.group;
  out[5] = g.groups;
  out[6] = g.tiles;
  out[7] = g.grid_x;
  out[8] = g.groups;
  out[9] = g.pad ? 1 : 0;
  out[10] = g.staged ? 1 : 0;
  out[11] = static_cast<long long>(g.smem);
  return 0;
}

int qmlp_mlp_bank(const float* x, const float* tables, const float* lo,
                  const float* scale, const float* w1, const float* b1,
                  const float* w2, const float* b2, float* out, long long m,
                  int f, int n, int h, int o, int d, long long block_m, void* stream) {
  if (m <= 0 || f <= 0 || o <= 0 || d <= 0) return 0;
  Geometry g;
  const int err = geometry_of(true, m, f, n, h, o, d, block_m, g);
  if (err != 0) return err;
  const BankArgs a = args_of(g, x, tables, lo, scale, w1, b1, w2, b2, out, m, f, n, h, o, d);
  return launch(g.pad ? qmlp_mlp_bank_kernel : qmlp_mlp_bank_kernel_unpadded, g, a,
                static_cast<cudaStream_t>(stream));
}

int qmlp_svm_bank(const float* x, const float* tables, const float* lo,
                  const float* scale, const float* w, const float* b, float* out,
                  long long m, int f, int n, int o, int d, long long block_m, void* stream) {
  if (m <= 0 || f <= 0 || o <= 0 || d <= 0) return 0;
  Geometry g;
  const int err = geometry_of(false, m, f, n, 0, o, d, block_m, g);
  if (err != 0) return err;
  const BankArgs a = args_of(g, x, tables, lo, scale, w, b, nullptr, nullptr, out, m, f, n, 0,
                             o, d);
  return launch(g.pad ? qmlp_svm_bank_kernel : qmlp_svm_bank_kernel_unpadded, g, a,
                static_cast<cudaStream_t>(stream));
}

}  // extern "C"

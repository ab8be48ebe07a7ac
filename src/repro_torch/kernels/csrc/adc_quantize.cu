// Population ADC quantizer for Hopper (sm_90a).
//
// Replaces (reference package, src/repro/kernels/adc_quantize.py):
//   adc_quantize_population <- adc_quantize_pallas_population (:139)
//                              and adc_quantize_pallas (:101), the P=1 case
//
// What it computes, for one shared sample batch x (M, C) and P baked
// value tables (P, C, 2^N):
//   code[m,c]    = clamp(floor((x[m,c] - lo[c]) * scale[c]), 0, 2^N - 1)
//   out[p,m,c]   = tables[p, c, code[m,c]]
// All float32; out is (P, M, C). It is the inner loop of every search
// generation: the train and the test split each go through the whole
// population in one launch.
//
// Bound on an H100 SXM: bytes. It reads x once (4*M*C), the tables and the
// rows (4*(P*C*2^N + 2*C)), and writes P times its input (4*P*M*C), at
// 3.35 TB/s; the arithmetic is a few operations per output. At the search
// shape (cardio train split, M=1488, C=21, 2^N=16, P=16) that is 2.15 MB,
// 0.64 us, so a call is bound by its latency: the launch, one round trip
// for x and the tables, the stores. At the wide shape (P=64, M=65536) it
// is 358 MB, 106.8 us, which Tensor.fill_ of the output nearly reaches
// (PERF.md).
//
// Design. The Pallas body is a one-hot selection sum over the 2^N codes,
// because gathers are weak on the TPU's vector unit. On Hopper it is a
// gather from tables held in shared memory. x is walked as one flat array
// of M*C elements. Block (x, y) takes span x (a run of `span` elements, a
// multiple of 4) for a group of G individuals, y. G is the largest group
// whose tables fit kGroupBytes (at most kMaxGroup) that still leaves
// kMinBlocks blocks (two an SM) of spans of at least one chunk a thread:
// G = 1 at the search's shapes, where a block stages one 1.3 KB table (a
// group of 16 staged 21 KB a block and ran at 6.2 us, a group of 4 at 4.0
// us), and 32 at the wide shape, where x is then read twice, not P times.
// G = 1 also where one table needs more than kGroupBytes (up to the 227 KB
// a block may have). The spans are cut finely enough that the groups
// times the spans give kMinBlocks blocks wherever M*C allows, and no span
// is longer than kSpanMax. A thread carries kChunks chunks of 4
// neighbouring elements: it issues every x load of its chunks (16-byte
// loads where x, out and M*C allow) before it stages the tables, so the
// loads and the staging are in flight together; then it computes each
// element's code once and stores the G outputs from it, one 16-byte
// streaming store (st.global.cs: the output is not read back soon) per
// chunk and individual, so a warp writes 512 contiguous bytes of out[p] at
// a time. The channel of an element comes from its chunk's by one compare
// and subtract a step, never by a division. Offsets inside a span are
// 32-bit, the span's base and out[p]'s are 64-bit. The launch bounds ask
// for two blocks an SM: without them ptxas spilled at 48 registers.
// envelope.quantize_geometry mirrors the geometry and adc_quantize_geometry
// below returns it. The tile knob (block_m sample rows, the reference's
// Pallas M-tile) sets the span to block_m * C rounded up to a multiple of
// 4, at most kSpanMax; a tile the kernel cannot take is refused with a
// negative code, never clamped. A span decides which block copies which
// elements, so every tile gives the same bits.
//
// Exactness. The code math uses the same f32 lo/scale rows as the plain
// version (computed on the host in f64, cast once) and rounds the subtract
// and the multiply separately (__fsub_rn, __fmul_rn), so floorf sees the
// same value; the build uses no fast-math. A NaN code position clamps to
// code 0 (fmaxf), as the reference's conversion and the plain version do.
// The value is a copy from the table, so the kernel and the plain version
// agree bitwise.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;              // threads per block
constexpr int kChunks = 4;                 // chunks of 4 elements a thread carries
constexpr int kSpanMax = kThreads * 4 * kChunks;  // elements a block takes
constexpr int kSpanFull = kThreads * 4;    // a span of one chunk a thread
constexpr int kGroupBytes = 49152;         // a group's tables, G > 1
constexpr int kMaxGroup = 32;              // individuals a block serves
constexpr int64_t kMinBlocks = 264;        // two blocks an SM of an H100
constexpr int64_t kMaxGridX = 2147483647;
constexpr size_t kDefaultSmem = 48 * 1024;

int64_t ceil_div(int64_t a, int64_t b) { return (a + b - 1) / b; }

struct Geometry {
  int group;       // G: individuals a block serves
  int64_t groups;  // ceil(P / G), grid y
  int span;        // elements of the flat x a block takes, a multiple of 4
  int64_t spans;   // ceil(M*C / span)
  int64_t grid_x;  // spans looped with this stride
  size_t smem;     // G tables and the two range rows
};

// Tiles the kernel cannot take (envelope.quantize_tile_error names the same
// limits); returned by the geometry export and the launcher.
constexpr int kTileBelowOne = -1;
constexpr int kTileAboveSpanMax = -2;

// The launch of a call; block_m > 0 (the tile knob, sample rows) sets the
// span to block_m * C rounded up to a multiple of 4 and nothing else,
// block_m = 0 keeps the heuristic. Returns 0, or a kTile* code for a tile
// the kernel cannot take (never clamped).
int geometry_of(int64_t m, int c, int n, int p, int64_t block_m, Geometry& g) {
  const int64_t total = m * c;
  int64_t fit = (kGroupBytes - int64_t{8} * c) / (int64_t{4} * c * n);
  if (fit > kMaxGroup) fit = kMaxGroup;
  if (fit > p) fit = p;
  // the largest group that still leaves kMinBlocks blocks of full spans
  // (a chunk a thread); 1 where none does
  const int64_t full = total / kSpanFull > 1 ? total / kSpanFull : 1;
  while (fit > 1 && ceil_div(p, fit) * full < kMinBlocks) --fit;
  if (fit < 1) fit = 1;
  g.groups = ceil_div(p, fit);
  g.group = static_cast<int>(ceil_div(p, g.groups));
  int64_t span;
  if (block_m > 0) {
    if (block_m > kSpanMax) return kTileAboveSpanMax;   // block_m * C below overflows
    span = ceil_div(block_m * c, 4) * 4;
    if (span > kSpanMax) return kTileAboveSpanMax;
  } else if (block_m < 0) {
    return kTileBelowOne;
  } else {
    int64_t spans = ceil_div(total, kSpanMax);
    const int64_t fill = ceil_div(kMinBlocks, g.groups);
    if (spans < fill) spans = fill;
    span = ceil_div(total, spans) / 4 * 4;
    if (span < 4) span = 4;
  }
  g.span = static_cast<int>(span);
  g.spans = ceil_div(total, span);
  g.grid_x = g.spans < kMaxGridX ? g.spans : kMaxGridX;
  g.smem = sizeof(float) * (static_cast<size_t>(g.group) * c * n + 2 * static_cast<size_t>(c));
  return 0;
}

// (a + b) mod c for a, b < c
__device__ __forceinline__ int add_mod(int a, int b, int c) {
  const int s = a + b;
  return s >= c ? s - c : s;
}

__device__ __forceinline__ int adc_code(float x, float lo, float scale, float top) {
  float u = floorf(__fmul_rn(__fsub_rn(x, lo), scale));
  u = fminf(fmaxf(u, 0.0f), top);
  return static_cast<int>(u);
}

// The thread's chunks of span s into v (0.0 past the end); returns the
// span's length.
template <bool kVec>
__device__ __forceinline__ int load_span(const float* __restrict__ x, int64_t s, int span,
                                         int64_t total, float (&v)[kChunks][4]) {
  const int64_t base = s * span;
  const int rem = total - base < span ? static_cast<int>(total - base) : span;
  const float* xs = x + base;
#pragma unroll
  for (int k = 0; k < kChunks; ++k) {
    const int e = 4 * (static_cast<int>(threadIdx.x) + k * kThreads);
    if constexpr (kVec) {
      float4 q = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (e < rem) q = __ldg(reinterpret_cast<const float4*>(xs + e));
      v[k][0] = q.x;
      v[k][1] = q.y;
      v[k][2] = q.z;
      v[k][3] = q.w;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        v[k][j] = 0.0f;
        if (e + j < rem) v[k][j] = __ldg(xs + e + j);
      }
    }
  }
  return rem;
}

// kVec: x, out and M*C allow 16-byte loads and stores (every chunk is then
// whole or wholly outside the span); otherwise the same walk, one word at a
// time.
template <bool kVec>
__global__ void __launch_bounds__(kThreads, 2)
adc_quantize_population_kernel(const float* __restrict__ x, const float* __restrict__ tables,
                               const float* __restrict__ lo, const float* __restrict__ scale,
                               float* __restrict__ out, int64_t total, int c, int n, int p,
                               int group, int span, int64_t spans) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int cn = c * n;                        // the envelope keeps G*C*2^N < 2^16
  float* s_lo = smem + group * cn;             // (C)
  float* s_sc = s_lo + c;                      // (C)
  const int t = threadIdx.x;
  const int p0 = static_cast<int>(blockIdx.y) * group;
  const int count = min(group, p - p0);
  const float top = static_cast<float>(n - 1);

  // channel bookkeeping: element e of a span has channel (base + e) mod C
  const int ch_thread = (4 * t) % c;           // the thread's first chunk
  const int ch_chunk = (4 * kThreads) % c;     // from one chunk to the next
  const int ch_span = span % c;                // from one span to the next
  const int ch_grid = static_cast<int>((gridDim.x % c) * static_cast<unsigned>(ch_span) % c);
  int ch_base = static_cast<int>((blockIdx.x % c) * static_cast<unsigned>(ch_span) % c);

  int64_t sp = blockIdx.x;
  float v[kChunks][4];
  int rem = load_span<kVec>(x, sp, span, total, v);   // in flight while the tables stage

  const float* tab = tables + static_cast<int64_t>(p0) * cn;
  const int words = count * cn;
  if ((cn & 3) == 0 && (reinterpret_cast<uintptr_t>(tables) & 15) == 0) {
    const float4* src = reinterpret_cast<const float4*>(tab);
#pragma unroll 8
    for (int i = t; i < words / 4; i += kThreads) smem4[i] = __ldg(src + i);
  } else {
#pragma unroll 8
    for (int i = t; i < words; i += kThreads) smem[i] = __ldg(tab + i);
  }
  for (int i = t; i < c; i += kThreads) {
    s_lo[i] = __ldg(lo + i);
    s_sc[i] = __ldg(scale + i);
  }
  __syncthreads();

  for (;;) {
    // codes, as table offsets ch * 2^N + code, once for every individual
    int idx[kChunks][4];
    int ch = add_mod(ch_base, ch_thread, c);
#pragma unroll
    for (int k = 0; k < kChunks; ++k) {
      int cj = ch;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        idx[k][j] = cj * n + adc_code(v[k][j], s_lo[cj], s_sc[cj], top);
        cj = cj + 1 == c ? 0 : cj + 1;
      }
      ch = add_mod(ch, ch_chunk, c);
    }
    float* os = out + p0 * total + sp * span;
#pragma unroll 1
    for (int g = 0; g < count; ++g, os += total) {
      const float* s_tab = smem + g * cn;
#pragma unroll
      for (int k = 0; k < kChunks; ++k) {
        const int e = 4 * (t + k * kThreads);
        if constexpr (kVec) {
          if (e < rem) {
            __stcs(reinterpret_cast<float4*>(os + e),
                   make_float4(s_tab[idx[k][0]], s_tab[idx[k][1]], s_tab[idx[k][2]],
                               s_tab[idx[k][3]]));
          }
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if (e + j < rem) __stcs(os + e + j, s_tab[idx[k][j]]);
          }
        }
      }
    }
    sp += gridDim.x;
    if (sp >= spans) break;
    ch_base = add_mod(ch_base, ch_grid, c);
    rem = load_span<kVec>(x, sp, span, total, v);
  }
}

template <bool kVec>
int launch(const Geometry& g, const float* x, const float* tables, const float* lo,
           const float* scale, float* out, int64_t total, int c, int n, int p,
           cudaStream_t stream) {
  auto kernel = adc_quantize_population_kernel<kVec>;
  if (g.smem > kDefaultSmem) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(g.smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(static_cast<unsigned>(g.grid_x), static_cast<unsigned>(g.groups));
  kernel<<<grid, kThreads, g.smem, stream>>>(x, tables, lo, scale, out, total, c, n, p,
                                             g.group, g.span, g.spans);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* ptr) { return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0; }

}  // namespace

// Plain C interface, loaded with ctypes. The launcher enqueues one kernel on
// `stream` and returns cudaGetLastError() (0 on success); it never
// synchronises and allocates nothing. The caller guarantees contiguous
// float32 operands on the current device and the shared-memory and grid
// envelope (kernels/envelope.py); a call with no outputs launches nothing.
extern "C" {

const char* adcq_error_string(int err) {
  switch (err) {
    case kTileBelowOne: return "quantizer tile: block_m below 1 row";
    case kTileAboveSpanMax:
      return "quantizer tile: block_m * C above kSpanMax (4096) elements a block takes";
    default: return cudaGetErrorString(static_cast<cudaError_t>(err));
  }
}

// The launch geometry of a call with m, c, n, p >= 1 at tile block_m (0:
// the heuristic), as envelope.quantize_geometry computes it: out[0..7] =
// threads, group, groups, span, spans, grid x, grid y, dynamic shared
// memory bytes. Returns 0, or the kTile* code of a tile the kernel cannot
// take (out untouched).
int adc_quantize_geometry(long long m, int c, int n, int p, long long block_m,
                          long long* out) {
  Geometry g;
  const int err = geometry_of(m, c, n, p, block_m, g);
  if (err != 0) return err;
  out[0] = kThreads;
  out[1] = g.group;
  out[2] = g.groups;
  out[3] = g.span;
  out[4] = g.spans;
  out[5] = g.grid_x;
  out[6] = g.groups;
  out[7] = static_cast<long long>(g.smem);
  return 0;
}

int adc_quantize_population(const float* x, const float* tables, const float* lo,
                            const float* scale, float* out, long long m, int c,
                            int n, int p, long long block_m, void* stream) {
  if (m <= 0 || c <= 0 || p <= 0) return 0;
  Geometry g;
  const int err = geometry_of(m, c, n, p, block_m, g);
  if (err != 0) return err;
  const int64_t total = static_cast<int64_t>(m) * c;
  auto st = static_cast<cudaStream_t>(stream);
  const bool vec = total % 4 == 0 && aligned16(x) && aligned16(out);
  return vec ? launch<true>(g, x, tables, lo, scale, out, total, c, n, p, st)
             : launch<false>(g, x, tables, lo, scale, out, total, c, n, p, st);
}

}  // extern "C"

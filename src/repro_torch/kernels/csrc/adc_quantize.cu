// Population ADC quantizer for Hopper (sm_90a).
//
// Replaces (reference package, src/repro/kernels/adc_quantize.py):
//   adc_quantize_population <- adc_quantize_pallas_population
//                              (and adc_quantize_pallas, the P=1 case)
//
// What it computes, for one shared sample batch x (M, C) and P baked
// value tables (P, C, 2^N):
//   code[m,c]    = clamp(floor((x[m,c] - lo[c]) * scale[c]), 0, 2^N - 1)
//   out[p,m,c]   = tables[p, c, code[m,c]]
// All float32; out is (P, M, C). It is the inner loop of every search
// generation: the train and the test split each go through the whole
// population in one launch.
//
// Design. The Pallas body is a one-hot selection sum over the 2^N codes,
// because gathers are weak on the TPU's vector unit. On Hopper it is a
// gather from a table held in shared memory. The grid is
// (ceil(M / kTileRows), P): each block stages individual p's table and both
// range rows in shared memory once, then its threads walk the
// (kTileRows x C) tile in flat m*C + c order, so x reads and out writes are
// coalesced whatever C is. The ragged M edge is masked here, with no padded
// copy of x. Offsets are 64-bit.
//
// Exactness. The code math uses the same f32 lo/scale rows as the plain
// version (computed on the host in f64, cast once) and rounds the subtract
// and the multiply separately (__fsub_rn, __fmul_rn), so floorf sees the
// same value; the build uses no fast-math. The value is a copy from the
// table, so the kernel and the plain version agree bitwise.
//
// Bound on an H100 SXM: bytes. It reads x once (4*M*C), the tables and the
// rows (4*(P*C*2^N + 2*C)), and writes P times its input (4*P*M*C), at
// 3.35 TB/s; the arithmetic is a few operations per output. At the search
// shape (cardio train split, M=1488, C=21, 2^N=16, P=16) that is 2.15 MB,
// about 0.64 us, so a call is bound by launch latency. Making it reach the
// byte bound at wide shapes (several outputs per thread as 16-byte stores,
// x tiles reused across individuals in one block) is later work.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;    // threads per block
constexpr int kTileRows = 256;   // sample rows per block
constexpr size_t kDefaultSmem = 48 * 1024;

__global__ void __launch_bounds__(kThreads)
adc_quantize_population_kernel(const float* __restrict__ x,
                               const float* __restrict__ tables,
                               const float* __restrict__ lo,
                               const float* __restrict__ scale,
                               float* __restrict__ out, int64_t m, int c, int n) {
  extern __shared__ float smem[];
  float* s_tab = smem;               // (C, 2^N)
  float* s_lo = s_tab + c * n;       // (C)
  float* s_sc = s_lo + c;            // (C)
  const int64_t p = blockIdx.y;
  const float* tab = tables + p * c * n;
  for (int i = threadIdx.x; i < c * n; i += blockDim.x) s_tab[i] = tab[i];
  for (int i = threadIdx.x; i < c; i += blockDim.x) {
    s_lo[i] = lo[i];
    s_sc[i] = scale[i];
  }
  __syncthreads();

  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * kTileRows;
  const int64_t rows = (m - row0) < kTileRows ? (m - row0) : kTileRows;
  const int64_t count = rows * c;
  const float* xt = x + row0 * c;
  float* ot = out + (p * m + row0) * c;
  const float top = static_cast<float>(n - 1);
  for (int64_t i = threadIdx.x; i < count; i += blockDim.x) {
    const int ch = static_cast<int>(i % c);
    float u = floorf(__fmul_rn(__fsub_rn(__ldg(xt + i), s_lo[ch]), s_sc[ch]));
    u = fminf(fmaxf(u, 0.0f), top);
    ot[i] = s_tab[ch * n + static_cast<int>(u)];
  }
}

}  // namespace

// Plain C interface, loaded with ctypes. The launcher enqueues one kernel on
// `stream` and returns cudaGetLastError() (0 on success); it never
// synchronises and allocates nothing. The caller guarantees m >= 1, p >= 1,
// contiguous float32 operands on the current device, and the shared-memory
// and grid envelope (kernels/envelope.py).
extern "C" {

const char* adcq_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int adc_quantize_population(const float* x, const float* tables, const float* lo,
                            const float* scale, float* out, long long m, int c,
                            int n, int p, void* stream) {
  const size_t smem = sizeof(float) * (static_cast<size_t>(c) * n + 2 * static_cast<size_t>(c));
  if (smem > kDefaultSmem) {
    cudaError_t err = cudaFuncSetAttribute(adc_quantize_population_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(static_cast<unsigned>((m + kTileRows - 1) / kTileRows),
                  static_cast<unsigned>(p));
  adc_quantize_population_kernel<<<grid, kThreads, smem,
                                   static_cast<cudaStream_t>(stream)>>>(
      x, tables, lo, scale, out, static_cast<int64_t>(m), c, n);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

// Fused ADC + printed-classifier bank kernels for Hopper (sm_90a).
//
// Replaces (reference package, src/repro/kernels/qmlp.py):
//   qmlp_mlp_bank  <- bespoke_mlp_bank_pallas (and bespoke_mlp_pallas, the D=1 case)
//   qmlp_svm_bank  <- bespoke_svm_bank_pallas (and bespoke_svm_pallas, the D=1 case)
//
// What they compute, for D deployed designs against one shared batch x (M, F):
//   code[m,f] = clamp(floor((x[m,f] - lo[f]) * scale[f]), 0, 2^N - 1)
//   q[d,m,f]  = table[d, f, code[m,f]]
//   mlp: out[d,m,:] = relu(q[d,m,:] @ W1[d] + b1[d]) @ W2[d] + b2[d]
//   svm: out[d,m,:] = q[d,m,:] @ W[d] + b[d]
// All float32; out is (D, M, O).
//
// Design. The Pallas body is a one-hot selection sum over the 2^N codes,
// because gathers are weak on the TPU's vector unit. On Hopper the natural
// form is a gather from a table held in shared memory. The grid is
// (ceil(M / kRows), D): each block stages design d's table, weights, biases
// and both range rows in shared memory once, then each thread owns one
// sample row. It derives each feature's code, gathers the table value,
// accumulates kChunk hidden sums (or logits) in registers, applies the bias
// and ReLU, runs the (H, O) product and writes O logits. Any H and O run in
// register chunks; the ragged M edge is masked here, with no padded copy
// of x. Offsets into x and out are 64-bit.
//
// Exactness. The code math uses the same f32 lo/scale rows as the plain
// version (computed on the host in f64, cast once) and rounds the subtract
// and the multiply separately (__fsub_rn, __fmul_rn), so floorf sees the
// same value; the build uses no fast-math. Products and sums run in
// another order than the plain version's matmuls, so logits agree bitwise
// where every partial sum is exact (dyadic tables, power-of-two weights,
// fixed-point biases: every exported front) and to rounding otherwise.
//
// Bound on an H100 SXM. Bytes that must move:
//   4 * (M*F + D*M*O + D*(F*2^N + F*H + H + H*O + O) + 2*F)  at 3.35 TB/s;
// operations: 2*D*M*(F*H + H*O) at 67 TFLOP/s (f32, no tensor cores).
// At serving shapes (D <= 16, M <= 1024) both are well under a microsecond,
// so a launch is bound by launch latency, not by bytes or operations. x is
// re-read once per design (L2 holds it). Making it fast (cp.async or TMA
// staging, several rows per thread, sharing x across designs in a block) is
// later work.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kRows = 128;   // threads per block, one sample row each
constexpr int kChunk = 8;    // hidden units / logits held in registers at once
constexpr size_t kDefaultSmem = 48 * 1024;

__device__ __forceinline__ int adc_code(float x, float lo, float scale, int n) {
  float u = floorf(__fmul_rn(__fsub_rn(x, lo), scale));
  u = fminf(fmaxf(u, 0.0f), static_cast<float>(n - 1));
  return static_cast<int>(u);
}

__device__ __forceinline__ void stage(float* dst, const float* __restrict__ src,
                                      int count) {
  for (int i = threadIdx.x; i < count; i += blockDim.x) dst[i] = src[i];
}

__global__ void __launch_bounds__(kRows)
qmlp_mlp_bank_kernel(const float* __restrict__ x, const float* __restrict__ tables,
                     const float* __restrict__ lo, const float* __restrict__ scale,
                     const float* __restrict__ w1, const float* __restrict__ b1,
                     const float* __restrict__ w2, const float* __restrict__ b2,
                     float* __restrict__ out, int64_t m, int f, int n, int h, int o) {
  extern __shared__ float smem[];
  float* s_tab = smem;                 // (F, 2^N)
  float* s_w1 = s_tab + f * n;         // (F, H)
  float* s_b1 = s_w1 + f * h;          // (H)
  float* s_w2 = s_b1 + h;              // (H, O)
  float* s_b2 = s_w2 + h * o;          // (O)
  float* s_lo = s_b2 + o;              // (F)
  float* s_sc = s_lo + f;              // (F)
  const int64_t d = blockIdx.y;
  stage(s_tab, tables + d * f * n, f * n);
  stage(s_w1, w1 + d * f * h, f * h);
  stage(s_b1, b1 + d * h, h);
  stage(s_w2, w2 + d * h * o, h * o);
  stage(s_b2, b2 + d * o, o);
  stage(s_lo, lo, f);
  stage(s_sc, scale, f);
  __syncthreads();

  const int64_t row = static_cast<int64_t>(blockIdx.x) * kRows + threadIdx.x;
  if (row >= m) return;
  const float* xr = x + row * f;
  float* yr = out + (d * m + row) * o;
  for (int o0 = 0; o0 < o; o0 += kChunk) {
    float acc_o[kChunk];
#pragma unroll
    for (int k = 0; k < kChunk; ++k) acc_o[k] = 0.0f;
    for (int h0 = 0; h0 < h; h0 += kChunk) {
      float acc_h[kChunk];
#pragma unroll
      for (int j = 0; j < kChunk; ++j) acc_h[j] = 0.0f;
      for (int c = 0; c < f; ++c) {
        const float q = s_tab[c * n + adc_code(__ldg(xr + c), s_lo[c], s_sc[c], n)];
        const float* w1r = s_w1 + c * h + h0;
#pragma unroll
        for (int j = 0; j < kChunk; ++j)
          if (h0 + j < h) acc_h[j] = fmaf(q, w1r[j], acc_h[j]);
      }
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        if (h0 + j < h) {
          const float hv = fmaxf(acc_h[j] + s_b1[h0 + j], 0.0f);
          const float* w2r = s_w2 + (h0 + j) * o + o0;
#pragma unroll
          for (int k = 0; k < kChunk; ++k)
            if (o0 + k < o) acc_o[k] = fmaf(hv, w2r[k], acc_o[k]);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kChunk; ++k)
      if (o0 + k < o) yr[o0 + k] = acc_o[k] + s_b2[o0 + k];
  }
}

__global__ void __launch_bounds__(kRows)
qmlp_svm_bank_kernel(const float* __restrict__ x, const float* __restrict__ tables,
                     const float* __restrict__ lo, const float* __restrict__ scale,
                     const float* __restrict__ w, const float* __restrict__ b,
                     float* __restrict__ out, int64_t m, int f, int n, int o) {
  extern __shared__ float smem[];
  float* s_tab = smem;                 // (F, 2^N)
  float* s_w = s_tab + f * n;          // (F, O)
  float* s_b = s_w + f * o;            // (O)
  float* s_lo = s_b + o;               // (F)
  float* s_sc = s_lo + f;              // (F)
  const int64_t d = blockIdx.y;
  stage(s_tab, tables + d * f * n, f * n);
  stage(s_w, w + d * f * o, f * o);
  stage(s_b, b + d * o, o);
  stage(s_lo, lo, f);
  stage(s_sc, scale, f);
  __syncthreads();

  const int64_t row = static_cast<int64_t>(blockIdx.x) * kRows + threadIdx.x;
  if (row >= m) return;
  const float* xr = x + row * f;
  float* yr = out + (d * m + row) * o;
  for (int o0 = 0; o0 < o; o0 += kChunk) {
    float acc[kChunk];
#pragma unroll
    for (int k = 0; k < kChunk; ++k) acc[k] = 0.0f;
    for (int c = 0; c < f; ++c) {
      const float q = s_tab[c * n + adc_code(__ldg(xr + c), s_lo[c], s_sc[c], n)];
      const float* wr = s_w + c * o + o0;
#pragma unroll
      for (int k = 0; k < kChunk; ++k)
        if (o0 + k < o) acc[k] = fmaf(q, wr[k], acc[k]);
    }
#pragma unroll
    for (int k = 0; k < kChunk; ++k)
      if (o0 + k < o) yr[o0 + k] = acc[k] + s_b[o0 + k];
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= kDefaultSmem) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

dim3 bank_grid(long long m, int d) {
  return dim3(static_cast<unsigned>((m + kRows - 1) / kRows), static_cast<unsigned>(d));
}

}  // namespace

// Plain C interface, loaded with ctypes. Each launcher enqueues one kernel on
// `stream` and returns cudaGetLastError() (0 on success); it never
// synchronises and allocates nothing. The caller guarantees m >= 1, d >= 1,
// contiguous float32 operands on the current device, and the shared-memory
// envelope (kernels/envelope.py).
extern "C" {

const char* qmlp_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int qmlp_mlp_bank(const float* x, const float* tables, const float* lo,
                  const float* scale, const float* w1, const float* b1,
                  const float* w2, const float* b2, float* out, long long m,
                  int f, int n, int h, int o, int d, void* stream) {
  const size_t smem = sizeof(float) * (static_cast<size_t>(f) * n +
                                       static_cast<size_t>(f) * h + h +
                                       static_cast<size_t>(h) * o + o + 2 * f);
  cudaError_t err = allow_smem(qmlp_mlp_bank_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  qmlp_mlp_bank_kernel<<<bank_grid(m, d), kRows, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      x, tables, lo, scale, w1, b1, w2, b2, out, static_cast<int64_t>(m), f, n, h, o);
  return static_cast<int>(cudaGetLastError());
}

int qmlp_svm_bank(const float* x, const float* tables, const float* lo,
                  const float* scale, const float* w, const float* b, float* out,
                  long long m, int f, int n, int o, int d, void* stream) {
  const size_t smem = sizeof(float) * (static_cast<size_t>(f) * n +
                                       static_cast<size_t>(f) * o + o + 2 * f);
  cudaError_t err = allow_smem(qmlp_svm_bank_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  qmlp_svm_bank_kernel<<<bank_grid(m, d), kRows, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      x, tables, lo, scale, w, b, out, static_cast<int64_t>(m), f, n, o);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

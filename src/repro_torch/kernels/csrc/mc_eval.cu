// Monte-Carlo non-ideal ADC evaluation for Hopper (sm_90a).
//
// Replaces (reference package, src/repro/kernels/mc_eval.py):
//   mc_eval<false> <- mc_adc_eval_pallas_population
//                     (and mc_adc_eval_pallas, the P=1 case)
//   mc_eval<true>  <- mc_adc_eval_cal_pallas_population
//                     (and mc_adc_eval_cal_pallas, the P=1 case)
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
// Design. The Pallas body is a one-hot sweep over the 2^N leaves because
// the TPU gathers poorly; here the per-(p, s) operands sit in shared
// memory and each thread scans them for its element. Grid (M-tiles, P*S);
// where P*S exceeds gridDim.y's 65,535 each block loops over (p, s) with
// stride gridDim.y. A block stages lb, ub and values for its (p, s)
// k-major, as [2^N][C]: the threads of a warp walk neighbouring channels,
// so the loads at one k hit neighbouring banks (the [C][2^N] layout would
// be a 16- to 32-way bank conflict at 2^N = 16..32). It stages lo[s] and
// scale[s] too, then walks the (kTileRows x C) tile in flat m*C + c order,
// so x reads and out writes are coalesced whatever C is. The ragged M edge
// is masked here. Offsets into the operands are 64-bit, indices inside a
// tile 32-bit, and a thread's channel is stepped, not divided out. The
// scan over at most 64 leaves is linear; a binary search over sorted
// bounds, and TMA staging, are later work.
//
// Exactness. u rounds the subtract and the multiply separately
// (__fsub_rn, __fmul_rn), as the plain version's two PyTorch operations
// do; the build uses no fast-math, and the intrinsics are never contracted
// into a fused multiply-add. out starts at 0.0f and adds each selected
// value in k order with __fadd_rn, which is the plain version's selection
// sum bit for bit: at most one leaf is live (the perturbed tree walk
// partitions the line), none for NaN input or u = +inf (then 0.0), and a
// selected -0.0 gives +0.0 in both.
//
// Bound on an H100 SXM: bytes. It writes P*S*M*C floats and reads x once,
// the tables once (P*S*C*2^N each for lb and ub, C*2^N or P*S*C*2^N for
// values) and the rows once, at 3.35 TB/s; the scan is about 2^N compares
// per output. At the search shape (P=16, S=32, cardio test split M=636,
// C=21, 2^N=16) the output alone is 27.4 MB, about 8.2 us; evaluate_
// robustness at D=6, S=32 writes 10.3 MB. The linear scan reads 2^N
// bound pairs from shared memory per output, so at 2^N=16 it may be
// bound by shared-memory traffic rather than by HBM.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;    // threads per block
constexpr int kTileRows = 128;   // sample rows per block
constexpr size_t kDefaultSmem = 48 * 1024;
constexpr int kMaxGridY = 65535;

template <bool kPerInstanceValues>
__global__ void __launch_bounds__(kThreads)
mc_eval_kernel(const float* __restrict__ x, const float* __restrict__ lb,
               const float* __restrict__ ub, const float* __restrict__ values,
               const float* __restrict__ lo, const float* __restrict__ scale,
               float* __restrict__ out, int64_t m, int c, int n, int64_t ps_total,
               int s_count) {
  extern __shared__ float smem[];
  const int cn = c * n;
  float* s_lb = smem;              // [2^N][C]
  float* s_ub = s_lb + cn;         // [2^N][C]
  float* s_val = s_ub + cn;        // [2^N][C]
  float* s_lo = s_val + cn;        // (C)
  float* s_sc = s_lo + c;          // (C)

  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * kTileRows;
  // in-tile indices are 32-bit: a tile holds at most kTileRows * C
  // elements, and the envelope bounds C far below 2^31 / kTileRows
  const int rows = static_cast<int>((m - row0) < kTileRows ? (m - row0) : kTileRows);
  const int count = rows * c;
  const float* xt = x + row0 * c;
  // each thread's channel advances by blockDim.x mod C per step, so the
  // walk needs no division (ch0, step < C)
  const int ch0 = static_cast<int>(threadIdx.x) % c;
  const int step = static_cast<int>(blockDim.x) % c;

  if (!kPerInstanceValues) {
    // the nominal ladder is the same for every (p, s): stage it once
    for (int i = threadIdx.x; i < cn; i += blockDim.x) {
      s_val[(i % n) * c + i / n] = values[i];
    }
  }
  for (int64_t ps = blockIdx.y; ps < ps_total; ps += gridDim.y) {
    const int64_t s = ps % s_count;
    const float* lb_ps = lb + ps * cn;
    const float* ub_ps = ub + ps * cn;
    __syncthreads();               // the previous (p, s) is done with smem
    for (int i = threadIdx.x; i < cn; i += blockDim.x) {
      const int t = (i % n) * c + i / n;       // (c, k) -> k-major
      s_lb[t] = lb_ps[i];
      s_ub[t] = ub_ps[i];
      if (kPerInstanceValues) s_val[t] = values[ps * cn + i];
    }
    for (int i = threadIdx.x; i < c; i += blockDim.x) {
      s_lo[i] = lo[s * c + i];
      s_sc[i] = scale[s * c + i];
    }
    __syncthreads();

    float* ot = out + (ps * m + row0) * c;
    int ch = ch0;
    for (int i = threadIdx.x; i < count; i += blockDim.x) {
      const float u = __fmul_rn(__fsub_rn(__ldg(xt + i), s_lo[ch]), s_sc[ch]);
      float acc = 0.0f;
      for (int k = 0; k < n; ++k) {
        const int t = k * c + ch;
        if (u >= s_lb[t] && u < s_ub[t]) acc = __fadd_rn(acc, s_val[t]);
      }
      ot[i] = acc;
      ch += step;
      if (ch >= c) ch -= c;
    }
  }
}

}  // namespace

// Plain C interface, loaded with ctypes. The launcher enqueues one kernel on
// `stream` and returns cudaGetLastError() (0 on success); it never
// synchronises and allocates nothing. The caller guarantees m >= 1,
// p >= 1, s >= 1, contiguous float32 operands on the current device, and
// the shared-memory envelope (kernels/envelope.py).
extern "C" {

const char* mc_eval_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int mc_eval(const float* x, const float* lb, const float* ub, const float* values,
            const float* lo, const float* scale, float* out, long long m, int c,
            int n, int p, int s, int per_instance_values, void* stream) {
  const size_t smem =
      sizeof(float) * (3 * static_cast<size_t>(c) * n + 2 * static_cast<size_t>(c));
  const int64_t ps_total = static_cast<int64_t>(p) * s;
  const dim3 grid(static_cast<unsigned>((m + kTileRows - 1) / kTileRows),
                  static_cast<unsigned>(ps_total < kMaxGridY ? ps_total : kMaxGridY));
  auto kernel = per_instance_values ? mc_eval_kernel<true> : mc_eval_kernel<false>;
  if (smem > kDefaultSmem) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      x, lb, ub, values, lo, scale, out, static_cast<int64_t>(m), c, n, ps_total, s);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

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
// Inputs are float32 or bfloat16 (q, k, v, out of one type).
//
// Design. One block of 256 threads for each (64-row q tile, batch*head):
// the TPU's sequential kv grid axis becomes a loop inside the block, and
// the running (m, l, acc) stay in registers. A block stages its q tile
// once and each 64-key K/V tile in shared memory as float32 (rows padded
// to an odd stride, so the 16 threads that read 16 rows at one column hit
// 16 banks), then each thread computes a 4 x 4 score tile (rows ty + 16i,
// keys tx + 16j), reduces its rows' max and sum across the 16 threads of
// the row with warp shuffles, writes p to shared memory, and accumulates
// 4 rows x ceil(dh/16) columns of P.V (the column count is a template
// parameter, so the accumulator is a register array). A kv tile in which
// no key is visible to any query of the q tile (a conservative test on
// the tile's min/max query position, folded into the barrier with
// __syncthreads_or) is skipped: under the reference's guards such a tile
// leaves (m, l, acc) as they were, so the skip is exact; it halves a
// causal prefill's work. Ragged S and Sk are masked here (the Pallas
// kernel's S % q_block assert is a TPU tiling limit): rows past S are not
// written, keys past Sk read as kpos -1. q tiles are issued last-first so
// the longest causal rows start first. No fast-math: expf, tanhf and the
// divisions are the accurate ones.
//
// Bound on an H100 SXM: operations. At the musicgen-medium prefill
// (B=4, S=2048, H=KV=24, dh=64, bf16, causal) the pairs a query sees are
// S(S+1)/2 per (b, h): 4 * B*H*dh * S(S+1)/2 = 5.2e10 flops, 52 us at the
// 989 TFLOP/s bf16 tensor-core rate, against 100 MB of q, k, v and out
// (30 us at 3.35 TB/s). This kernel runs its multiply-adds on the CUDA
// cores in float32, whose peak is 67 TFLOP/s (0.8 ms for that call), and
// each thread loads 8 shared-memory words per 16 multiply-adds, so it is
// bound by shared-memory bandwidth at about half that rate at best. bf16
// at the configs' head widths runs the tensor-core kernel instead; this
// one keeps float32, which it holds at 2e-5 (neither bf16 nor TF32
// products would).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;  // 16 x 16 threads
constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per kv tile
constexpr int kRows = 4;       // rows per thread: ty + 16 i
constexpr int kCols = 4;       // score columns per thread: tx + 16 j
constexpr float kNeg = -1e30f;
constexpr size_t kDefaultSmem = 48 * 1024;

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

template <typename T, int kNJ>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const int* __restrict__ qpos,
                       const int* __restrict__ kpos, T* __restrict__ out, int s_len,
                       int sk_len, int heads, int kv_heads, int dh, float scale,
                       int causal, int window, float cap) {
  extern __shared__ float smem[];
  const int ld = dh + 1;                 // odd stride for even dh
  const int ldp = kBK + 1;
  float* s_q = smem;                     // [kBQ][ld]
  float* s_k = s_q + kBQ * ld;           // [kBK][ld]
  float* s_v = s_k + kBK * ld;           // [kBK][dh]
  float* s_p = s_v + kBK * dh;           // [kBQ][ldp]
  int* s_kpos = reinterpret_cast<int*>(s_p + kBQ * ldp);  // [kBK]

  const int tile = static_cast<int>(gridDim.x) - 1 - static_cast<int>(blockIdx.x);
  const int q0 = tile * kBQ;
  const int rows = min(kBQ, s_len - q0);
  const int b = static_cast<int>(blockIdx.y) / heads;
  const int h = static_cast<int>(blockIdx.y) - b * heads;
  const int kvh = h / (heads / kv_heads);
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;

  const int64_t q_stride = static_cast<int64_t>(heads) * dh;      // one position
  const int64_t kv_stride = static_cast<int64_t>(kv_heads) * dh;
  const T* q_base = q + (static_cast<int64_t>(b) * s_len * heads + h) * dh;
  const T* k_base = k + (static_cast<int64_t>(b) * sk_len * kv_heads + kvh) * dh;
  const T* v_base = v + (static_cast<int64_t>(b) * sk_len * kv_heads + kvh) * dh;
  T* o_base = out + (static_cast<int64_t>(b) * s_len * heads + h) * dh;

  for (int e = threadIdx.x; e < kBQ * dh; e += kThreads) {
    const int r = e / dh;
    const int d = e - r * dh;
    s_q[r * ld + d] = r < rows ? to_f32(q_base[(q0 + r) * q_stride + d]) : 0.0f;
  }
  int my_qpos[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = ty + 16 * i;
    my_qpos[i] = r < rows ? __ldg(qpos + q0 + r) : 0;
  }
  int qmin = INT_MAX;
  int qmax = INT_MIN;
  for (int r = 0; r < rows; ++r) {
    const int p = __ldg(qpos + q0 + r);
    qmin = min(qmin, p);
    qmax = max(qmax, p);
  }

  float m[kRows], l[kRows], acc[kRows][kNJ];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNeg;
    l[i] = 0.0f;
#pragma unroll
    for (int jj = 0; jj < kNJ; ++jj) acc[i][jj] = 0.0f;
  }

  const int n_tiles = (sk_len + kBK - 1) / kBK;
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBK;
    // Can any query of this tile see key k0 + threadIdx.x? A superset
    // test; the barrier also ends the previous tile's reads of s_k, s_v,
    // s_p and s_kpos.
    int kp = -1;
    if (threadIdx.x < kBK && k0 + static_cast<int>(threadIdx.x) < sk_len) {
      kp = __ldg(kpos + k0 + threadIdx.x);
    }
    bool live = kp >= 0;
    if (causal) live = live && kp <= qmax;
    if (window > 0) live = live && static_cast<int64_t>(qmin) - kp < window;
    if (!__syncthreads_or(live)) continue;

    if (threadIdx.x < kBK) s_kpos[threadIdx.x] = kp;
    for (int e = threadIdx.x; e < kBK * dh; e += kThreads) {
      const int r = e / dh;
      const int d = e - r * dh;
      const bool in = k0 + r < sk_len;
      const int64_t off = (k0 + r) * kv_stride + d;
      s_k[r * ld + d] = in ? to_f32(k_base[off]) : 0.0f;
      s_v[r * dh + d] = in ? to_f32(v_base[off]) : 0.0f;
    }
    __syncthreads();

    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.0f;
    }
#pragma unroll 4
    for (int d = 0; d < dh; ++d) {
      float qv[kRows], kv[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) qv[i] = s_q[(ty + 16 * i) * ld + d];
#pragma unroll
      for (int j = 0; j < kCols; ++j) kv[j] = s_k[(tx + 16 * j) * ld + d];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
#pragma unroll
        for (int j = 0; j < kCols; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
      }
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      float row_max = kNeg;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        float x = s[i][j] * scale;
        if (cap != 0.0f) x = tanhf(x / cap) * cap;
        const int kpj = s_kpos[tx + 16 * j];
        const int dpos = my_qpos[i] - kpj;
        bool ok = kpj >= 0;
        if (causal) ok = ok && dpos >= 0;
        if (window > 0) ok = ok && dpos < window;
        x = ok ? x : kNeg;
        s[i][j] = x;
        row_max = fmaxf(row_max, x);
      }
      // the 16 threads of a row are one half-warp (same ty)
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) {
        row_max = fmaxf(row_max, __shfl_xor_sync(0xffffffffu, row_max, off));
      }
      const float m_new = fmaxf(m[i], row_max);
      const float corr = m[i] <= kNeg ? 0.0f : expf(m[i] - m_new);
      float row_sum = 0.0f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float p = m_new <= kNeg ? 0.0f : expf(s[i][j] - m_new);
        row_sum += p;
        // p.astype(v.dtype) before P.V
        s_p[(ty + 16 * i) * ldp + tx + 16 * j] = to_f32(from_f32<T>(p));
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) {
        row_sum += __shfl_xor_sync(0xffffffffu, row_sum, off);
      }
      m[i] = m_new;
      l[i] = l[i] * corr + row_sum;
#pragma unroll
      for (int jj = 0; jj < kNJ; ++jj) acc[i][jj] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float pv[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) pv[i] = s_p[(ty + 16 * i) * ldp + kk];
#pragma unroll
      for (int jj = 0; jj < kNJ; ++jj) {
        const int c = tx + 16 * jj;
        const float vv = c < dh ? s_v[kk * dh + c] : 0.0f;
#pragma unroll
        for (int i = 0; i < kRows; ++i) acc[i][jj] = fmaf(pv[i], vv, acc[i][jj]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = ty + 16 * i;
    if (r >= rows) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int jj = 0; jj < kNJ; ++jj) {
      const int c = tx + 16 * jj;
      if (c < dh) o_base[(q0 + r) * q_stride + c] = from_f32<T>(acc[i][jj] / denom);
    }
  }
}

size_t smem_bytes(int dh) {
  return sizeof(float) * (static_cast<size_t>(kBQ) * (dh + 1) +
                          static_cast<size_t>(kBK) * (dh + 1) +
                          static_cast<size_t>(kBK) * dh +
                          static_cast<size_t>(kBQ) * (kBK + 1)) +
         sizeof(int) * kBK;
}

template <typename T, int kNJ>
int launch(const void* q, const void* k, const void* v, const int* qpos, const int* kpos,
           void* out, int b, int s, int sk, int h, int kvh, int dh, float scale, int causal,
           int window, float cap, cudaStream_t stream) {
  const size_t smem = smem_bytes(dh);
  auto kernel = flash_attention_kernel<T, kNJ>;
  if (smem > kDefaultSmem) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(static_cast<unsigned>((s + kBQ - 1) / kBQ), static_cast<unsigned>(b * h));
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), qpos, kpos,
      static_cast<T*>(out), s, sk, h, kvh, dh, scale, causal, window, cap);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dh(const void* q, const void* k, const void* v, const int* qpos, const int* kpos,
              void* out, int b, int s, int sk, int h, int kvh, int dh, float scale, int causal,
              int window, float cap, cudaStream_t stream) {
  // columns per thread: ceil(dh / 16), rounded up to a power of two
  if (dh <= 16)
    return launch<T, 1>(q, k, v, qpos, kpos, out, b, s, sk, h, kvh, dh, scale, causal, window,
                        cap, stream);
  if (dh <= 32)
    return launch<T, 2>(q, k, v, qpos, kpos, out, b, s, sk, h, kvh, dh, scale, causal, window,
                        cap, stream);
  if (dh <= 64)
    return launch<T, 4>(q, k, v, qpos, kpos, out, b, s, sk, h, kvh, dh, scale, causal, window,
                        cap, stream);
  if (dh <= 128)
    return launch<T, 8>(q, k, v, qpos, kpos, out, b, s, sk, h, kvh, dh, scale, causal, window,
                        cap, stream);
  return launch<T, 16>(q, k, v, qpos, kpos, out, b, s, sk, h, kvh, dh, scale, causal, window,
                       cap, stream);
}

}  // namespace

// Plain C interface, loaded with ctypes. The launcher enqueues one kernel on
// `stream` and returns cudaGetLastError() (0 on success); it never
// synchronises and allocates nothing. The caller guarantees s >= 1,
// b * h >= 1, 1 <= dh <= 256, h % kvh == 0, contiguous operands of one type
// (bf16 when is_bf16, else float32) and int32 positions on the current
// device, and the envelope (kernels/envelope.py).
extern "C" {

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int flash_attention(const void* q, const void* k, const void* v, const int* qpos,
                    const int* kpos, void* out, int b, int s, int sk, int h, int kvh, int dh,
                    float scale, int causal, int window, float cap, int is_bf16,
                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return launch_dh<__nv_bfloat16>(q, k, v, qpos, kpos, out, b, s, sk, h, kvh, dh, scale,
                                    causal, window, cap, st);
  }
  return launch_dh<float>(q, k, v, qpos, kpos, out, b, s, sk, h, kvh, dh, scale, causal,
                          window, cap, st);
}

}  // extern "C"

// K3: the log-mel frontend after the DFT, in two launches.
//
// Replaces the post-DFT part of avsr_tpu/ops/audio_features.py:
// logmel_frontend (the plain-jnp successor of the deleted Pallas fused
// log-mel): power = re^2 + im^2, the [F -> M] mel product, log(+floor),
// Δ and ΔΔ over edge-clamped frames (clamped at each utterance's last
// valid frame, then at the array edges), per-utterance mean/variance
// normalization over valid frames (eps 1e-8), zeroing of padded frames,
// and stack/skip framing with a masked tail and the new lengths.
// The framing gather and the two windowed-DFT products stay matmuls in
// the caller, as the reference leaves them to XLA.
//
// What bounds it on an H100: memory.  The inputs re and im
// ([B, T, F] fp32, F = 257) are read once — 157 MB at B = 128, 6 s — and
// the mel product is 2 x F x M = 15 kFLOP per frame, small against that.
// Design: launch 1 (mel_log_kernel) gives each block RB frames; it stages
// the mel matrix and the frames' power spectra in shared memory and writes
// only the [B, T, M] log-mel (M = 30, 11% of the input bytes).  Launch 2
// (post_kernel) gives each block one (mel bin, utterance) column: the
// deltas of bin m need only column m, so the static, Δ and ΔΔ columns
// (3 x T floats) stay in shared memory through the delta windows, the two
// masked reductions, and the stacked writes — nothing but the final
// features goes back to device memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int RB = 16;        // frames per block in launch 1
constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
mel_log_kernel(const float* __restrict__ re, const float* __restrict__ im,
               const float* __restrict__ melw,  // [F, M]
               float* __restrict__ logmel,      // [rows, M]
               int rows, int F, int M, float log_floor) {
  extern __shared__ float sm[];
  float* w_s = sm;           // [F * M]
  float* p_s = sm + F * M;   // [RB * F]
  const int row0 = blockIdx.x * RB;
  for (int idx = threadIdx.x; idx < F * M; idx += blockDim.x) w_s[idx] = melw[idx];
  for (int idx = threadIdx.x; idx < RB * F; idx += blockDim.x) {
    const int r = idx / F;
    const int f = idx - r * F;
    const int row = row0 + r;
    float a = 0.f, b = 0.f;
    if (row < rows) {
      a = re[(size_t)row * F + f];
      b = im[(size_t)row * F + f];
    }
    p_s[idx] = __fadd_rn(__fmul_rn(a, a), __fmul_rn(b, b));
  }
  __syncthreads();
  for (int o = threadIdx.x; o < RB * M; o += blockDim.x) {
    const int r = o / M;
    const int m = o - r * M;
    const int row = row0 + r;
    if (row >= rows) continue;
    const float* p = p_s + r * F;
    float acc = 0.f;
    for (int f = 0; f < F; ++f) acc = fmaf(p[f], w_s[f * M + m], acc);
    logmel[(size_t)row * M + m] = logf(acc + log_floor);
  }
}

__device__ __forceinline__ int floordiv(int a, int b) {
  const int q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}

// Block-wide sum of three values; every thread gets the totals.
__device__ __forceinline__ void block_sum3(float& a, float& b, float& c) {
  __shared__ float red[3][THREADS / 32];
  for (int off = 16; off > 0; off >>= 1) {
    a += __shfl_down_sync(0xffffffffu, a, off);
    b += __shfl_down_sync(0xffffffffu, b, off);
    c += __shfl_down_sync(0xffffffffu, c, off);
  }
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (lane == 0) {
    red[0][warp] = a;
    red[1][warp] = b;
    red[2][warp] = c;
  }
  __syncthreads();
  a = b = c = 0.f;
  for (int w = 0; w < THREADS / 32; ++w) {
    a += red[0][w];
    b += red[1][w];
    c += red[2][w];
  }
  __syncthreads();  // red is reused by the next call
}

// Δ of column src into dst: regression window N, indices clamped to [0, T).
__device__ __forceinline__ void delta_column(const float* src, float* dst,
                                             int T, int N) {
  float denom = 0.f;
  for (int n = 1; n <= N; ++n) denom += 2.0f * n * n;
  for (int t = threadIdx.x; t < T; t += blockDim.x) {
    float acc = 0.f;
    for (int n = 1; n <= N; ++n) {
      const float hi = src[min(t + n, T - 1)];
      const float lo = src[max(t - n, 0)];
      acc = acc + (float)n * (hi - lo);
    }
    dst[t] = acc / denom;
  }
}

__global__ void __launch_bounds__(THREADS)
post_kernel(const float* __restrict__ logmel,  // [B, T, M]
            const int* __restrict__ feat_len,  // [B]
            float* __restrict__ out,           // [B, Tp, stack * 3M]
            int* __restrict__ new_len,         // [B]
            int T, int M, int Tp, int stack, int skip, int N) {
  extern __shared__ float col[];  // [3][T]: static, Δ, ΔΔ of bin m
  float* e = col;
  float* d1 = col + T;
  float* d2 = col + 2 * T;
  const int m = blockIdx.x;
  const int b = blockIdx.y;
  const int L = feat_len[b];
  const int Lc = min(max(L, 0), T);   // valid frames
  const int last = max(Lc - 1, 0);    // edge frame for the delta windows

  const float* src = logmel + (size_t)b * T * M + m;
  for (int t = threadIdx.x; t < T; t += blockDim.x) e[t] = src[(size_t)min(t, last) * M];
  __syncthreads();
  delta_column(e, d1, T, N);
  __syncthreads();
  delta_column(d1, d2, T, N);
  __syncthreads();

  const float denom = (float)max(Lc, 1);
  float s0 = 0.f, s1 = 0.f, s2 = 0.f;
  for (int t = threadIdx.x; t < Lc; t += blockDim.x) {
    s0 += e[t];
    s1 += d1[t];
    s2 += d2[t];
  }
  block_sum3(s0, s1, s2);
  const float mu0 = s0 / denom, mu1 = s1 / denom, mu2 = s2 / denom;
  float v0 = 0.f, v1 = 0.f, v2 = 0.f;
  for (int t = threadIdx.x; t < Lc; t += blockDim.x) {
    const float a = e[t] - mu0, bb = d1[t] - mu1, cc = d2[t] - mu2;
    v0 += a * a;
    v1 += bb * bb;
    v2 += cc * cc;
  }
  block_sum3(v0, v1, v2);
  const float inv0 = 1.0f / sqrtf(v0 / denom + 1e-8f);
  const float inv1 = 1.0f / sqrtf(v1 / denom + 1e-8f);
  const float inv2 = 1.0f / sqrtf(v2 / denom + 1e-8f);

  int nl = max(floordiv(L - stack, skip) + 1, min(L, 1));
  nl = min(max(nl, 0), Tp);
  if (m == 0 && threadIdx.x == 0) new_len[b] = nl;

  const int D = 3 * M;
  float* ob = out + (size_t)b * Tp * stack * D;
  for (int idx = threadIdx.x; idx < Tp * stack; idx += blockDim.x) {
    const int tp = idx / stack;
    const int t = tp * skip + (idx - tp * stack);
    float y0 = 0.f, y1 = 0.f, y2 = 0.f;
    if (tp < nl && t < Lc) {
      y0 = (e[t] - mu0) * inv0;
      y1 = (d1[t] - mu1) * inv1;
      y2 = (d2[t] - mu2) * inv2;
    }
    float* o = ob + (size_t)idx * D;
    o[m] = y0;
    o[M + m] = y1;
    o[2 * M + m] = y2;
  }
}

cudaError_t allow_smem(const void* fn, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace

// logmel: [B, T, M] fp32 scratch; out: [B, Tp, stack * 3M]; new_len: [B].
extern "C" int avsr_logmel_post_dft(const void* re, const void* im,
                                    const void* feat_len, const void* melw,
                                    void* logmel, void* out, void* new_len,
                                    int B, int T, int F, int M, int Tp,
                                    int stack, int skip, int delta_window,
                                    float log_floor, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int rows = B * T;
  if (rows > 0) {
    const size_t smem = ((size_t)F * M + (size_t)RB * F) * sizeof(float);
    cudaError_t e = allow_smem((const void*)mel_log_kernel, smem);
    if (e != cudaSuccess) return (int)e;
    mel_log_kernel<<<(rows + RB - 1) / RB, THREADS, smem, st>>>(
        static_cast<const float*>(re), static_cast<const float*>(im),
        static_cast<const float*>(melw), static_cast<float*>(logmel), rows, F,
        M, log_floor);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  if (B > 0 && M > 0) {
    const size_t smem = (size_t)3 * T * sizeof(float);
    cudaError_t e = allow_smem((const void*)post_kernel, smem);
    if (e != cudaSuccess) return (int)e;
    post_kernel<<<dim3(M, B), THREADS, smem, st>>>(
        static_cast<const float*>(logmel), static_cast<const int*>(feat_len),
        static_cast<float*>(out), static_cast<int*>(new_len), T, M, Tp, stack,
        skip, delta_window);
  }
  return (int)cudaGetLastError();
}

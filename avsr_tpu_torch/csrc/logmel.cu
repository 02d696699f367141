// K3: the log-mel frontend after the DFT, in three launches.
//
// Replaces the post-DFT part of avsr_tpu/ops/audio_features.py:
// logmel_frontend (the plain-jnp successor of the deleted Pallas fused
// log-mel): power = re^2 + im^2, the [F -> M] mel product, log(+floor),
// Δ and ΔΔ over edge-clamped frames (clamped at each utterance's last
// valid frame, then at the array edges), per-utterance mean/variance
// normalization over valid frames (two passes, eps 1e-8), zeroing of
// padded frames, and stack/skip framing with a masked tail and the new
// lengths.  The framing gather and the two windowed-DFT products stay
// matmuls in the caller, as the reference leaves them to XLA.
//
// What bounds it on an H100: memory.  The inputs re and im ([B, T, F]
// fp32, F = 257) are read once, 157 MB at B = 128, 6 s, and the stacked
// output (stack * 3M floats a stacked frame) written once, 72.6 MB; the
// rest is small.  Design:
//
// 1. mel_band_kernel streams re and im: a block takes 16 frames (a
//    16-byte aligned run of 16 * F floats, read as float4), forms their
//    power spectra in shared memory and multiplies by the BANDED mel
//    matrix: per mel bin the first bin, the count and the weights of its
//    band (``kernels.mel_band_table``: 460 weights of the presets' 7,710).
//    Each output sums its band with fmaf in ascending f: a zero weight is
//    a no-op of fmaf on a finite power, so this is bit for bit the dense
//    sequential product.  It writes only the log-mel, transposed to
//    [B, M, T] so that each bin's frames are contiguous.
// 2. stats_kernel, a block of 128 threads per (utterance, mel bin) (a B =
//    8 request's 240 columns spread over the SMs, a column's frames over
//    four warps): the bin's frames, clamped at the last valid one, and
//    their Δ in shared memory, ΔΔ formed on the fly, then the mean and the
//    inverse standard deviation of each of the three over the valid frames
//    (two passes): [B, 2, 3M].
// 3. writer_kernel, a block per (utterance, chunk of stacked frames): it
//    stages the chunk's log-mel frames with the 2N-frame halo the two delta
//    windows need, forms Δ and ΔΔ, normalizes, and writes whole stacked
//    frames (stack * 3M floats, a contiguous run of its normalized frames)
//    with 8-byte stores, a warp a frame; no output sector is written by two
//    blocks.
//
// The delta window is a template parameter at the presets' 2 (unrolled),
// a runtime one otherwise.
//
// The frontend's options are instances of the same launches:
// feature_type="spectrogram" (log(power + floor) over the fft/2+1 bins) is
// launch 1 with the identity as its banded matrix (a band of one bin of
// weight 1 a bin: fmaf(p, 1, 0) is p, so the product is exact);
// add_deltas=False stages and writes the static features only (D = M, no
// halo); normalization="none" replaces launch 2 by a block of the lengths,
// and "global" (one mean and variance over every valid frame and feature of
// the batch, denominator max(valid frames * D, 1), rsqrt(var + 1e-8): the
// reference's audio_features.py:297-309) runs launch 2 twice, once for
// every column's valid sum and once for its squared deviations from the
// mean, each followed by a one-block reduce of the [B, M, 3] partial sums in
// a fixed order: no atomics, the same bits every run.
//
// ``stages`` (bit 1, 2, 4) runs the launches apart for timing; the kernel
// wrapper runs all three.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MEL_THREADS = 256;
constexpr int MEL_ROWS = 16;     // frames a block of launch 1, at most (a multiple of 4)
constexpr int STAT_THREADS = 128;  // a block a column in launch 2
constexpr int WR_THREADS = 256;
constexpr size_t SMEM_LIMIT = 232448;

__device__ __forceinline__ float power(float a, float b) {
  return __fadd_rn(__fmul_rn(a, a), __fmul_rn(b, b));
}

__global__ void __launch_bounds__(MEL_THREADS)
mel_band_kernel(const float* __restrict__ re, const float* __restrict__ im,
                const int* __restrict__ band,       // [M, 3]: first bin, count, offset
                const float* __restrict__ weights,  // [nw]
                float* __restrict__ logmel,         // [B, M, T]
                int rows, int T, int F, int M, int nw, int rows_per_block, float log_floor) {
  extern __shared__ __align__(16) float sm[];
  float* p_s = sm;                                 // [rows_per_block * F]
  float* w_s = p_s + rows_per_block * F;           // [nw]
  int* band_s = reinterpret_cast<int*>(w_s + nw);  // [3M]
  const long long row0 = (long long)blockIdx.x * rows_per_block;
  const int nrows = (int)min((long long)rows_per_block, rows - row0);
  for (int i = threadIdx.x; i < nw; i += MEL_THREADS) w_s[i] = weights[i];
  for (int i = threadIdx.x; i < 3 * M; i += MEL_THREADS) band_s[i] = band[i];

  // row0 is a multiple of 4, so the run starts 16-byte aligned
  const size_t base = (size_t)row0 * F;
  const int n = nrows * F;
  const int n4 = n >> 2;
  const float4* re4 = reinterpret_cast<const float4*>(re + base);
  const float4* im4 = reinterpret_cast<const float4*>(im + base);
  float4* p4 = reinterpret_cast<float4*>(p_s);
  constexpr int U = 4;
  for (int i0 = 0; i0 < n4; i0 += U * MEL_THREADS) {
    float4 x[U], y[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = i0 + u * MEL_THREADS + threadIdx.x;
      if (i < n4) {
        x[u] = __ldg(re4 + i);
        y[u] = __ldg(im4 + i);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = i0 + u * MEL_THREADS + threadIdx.x;
      if (i < n4)
        p4[i] = make_float4(power(x[u].x, y[u].x), power(x[u].y, y[u].y),
                            power(x[u].z, y[u].z), power(x[u].w, y[u].w));
    }
  }
  for (int i = 4 * n4 + threadIdx.x; i < n; i += MEL_THREADS)
    p_s[i] = power(re[base + i], im[base + i]);
  __syncthreads();

  // consecutive threads take consecutive frames of one bin: the [B, M, T]
  // stores run along t
  for (int o = threadIdx.x; o < nrows * M; o += MEL_THREADS) {
    const int m = o / nrows;
    const int r = o - m * nrows;
    const int f0 = band_s[3 * m], cnt = band_s[3 * m + 1];
    const float* p = p_s + r * F + f0;
    const float* w = w_s + band_s[3 * m + 2];
    float acc = 0.f;
    for (int k = 0; k < cnt; ++k) acc = fmaf(p[k], w[k], acc);
    const long long row = row0 + r;
    const long long bb = row / T;
    const int t = (int)(row - bb * T);
    logmel[((size_t)bb * M + m) * T + t] = logf(acc + log_floor);
  }
}

__device__ __forceinline__ int floordiv(int a, int b) {
  const int q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}

__device__ __forceinline__ int stacked_len(int L, int T, int Tp, int stack, int skip) {
  int nl = max(floordiv(L - stack, skip) + 1, min(L, 1));
  return min(max(nl, 0), Tp);
}

// feature columns a frame: the static features and, with deltas, Δ and ΔΔ
__host__ __device__ __forceinline__ int feature_width(int M, int deltas) {
  return deltas ? 3 * M : M;
}

__device__ __forceinline__ float delta_denom(int N) {
  float denom = 0.f;
  for (int n = 1; n <= N; ++n) denom += 2.0f * n * n;
  return denom;
}

// Δ at frame t of the column src (index i = frame - origin), regression
// window N (NT when NT > 0: the presets' 2, unrolled), frame indices
// clamped to [0, T)
template <int NT>
__device__ __forceinline__ float delta_at(const float* src, int origin, int t, int T, int N_rt,
                                          float denom) {
  const int N = NT > 0 ? NT : N_rt;
  float acc = 0.f;
#pragma unroll
  for (int n = 1; n <= N; ++n) {
    const float hi = src[min(t + n, T - 1) - origin];
    const float lo = src[max(t - n, 0) - origin];
    acc = acc + (float)n * (hi - lo);
  }
  return acc / denom;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Sums of a, b and c over the block (STAT_THREADS), in every thread.
__device__ __forceinline__ void block_sum3(float& a, float& b, float& c, float* red) {
  a = warp_sum(a);
  b = warp_sum(b);
  c = warp_sum(c);
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    red[3 * warp] = a;
    red[3 * warp + 1] = b;
    red[3 * warp + 2] = c;
  }
  __syncthreads();
  a = b = c = 0.f;
#pragma unroll
  for (int w = 0; w < STAT_THREADS / 32; ++w) {
    a += red[3 * w];
    b += red[3 * w + 1];
    c += red[3 * w + 2];
  }
  __syncthreads();  // red is reused by the next call
}

// What launch 2's blocks write: the per-utterance statistics, or the
// partial sums of the global ones.
enum StatMode { STATS_UTTERANCE = 1, STATS_GLOBAL_SUM = 2, STATS_GLOBAL_SQ = 3 };

// A block per (utterance, bin): in STATS_UTTERANCE, stats [B, 2, D] = (means,
// inverse std) of the static, Δ and ΔΔ columns (the static only without
// deltas) over the valid frames; in STATS_GLOBAL_SUM / _SQ, part [B, M, 3]
// = the columns' sums over the valid frames / their squared deviations from
// the batch mean gstat[0]; new_len [B].
template <int NT>
__global__ void __launch_bounds__(STAT_THREADS)
stats_kernel(const float* __restrict__ logmel,  // [B, M, T]
             const int* __restrict__ feat_len, float* __restrict__ stats,
             int* __restrict__ new_len, float* __restrict__ part,
             const float* __restrict__ gstat, int T, int M, int Tp, int stack, int skip,
             int N_rt, int deltas, int mode) {
  extern __shared__ float sm[];
  __shared__ float red[3 * STAT_THREADS / 32];
  const int N = deltas ? (NT > 0 ? NT : N_rt) : 0;
  const int col = blockIdx.x;  // b * M + m
  const int b = col / M, m = col - b * M;
  float* e = sm;       // [T]
  float* d1 = e + T;   // [T]
  const int L = feat_len[b];
  const int Lc = min(max(L, 0), T);
  const int last = max(Lc - 1, 0);
  const float denom = delta_denom(N);
  const float* src = logmel + (size_t)col * T;
  // ΔΔ at the valid frames reads Δ up to N frames on, which reads the
  // log-mel up to 2N frames on (indices clamped to [0, T))
  const int Te = min(Lc + 2 * N, T), T1 = min(Lc + N, T);
  for (int t0 = threadIdx.x; t0 < Te; t0 += 4 * STAT_THREADS) {  // four loads in flight
    float x[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int t = t0 + STAT_THREADS * u;
      if (t < Te) x[u] = src[min(t, last)];
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int t = t0 + STAT_THREADS * u;
      if (t < Te) e[t] = x[u];
    }
  }
  __syncthreads();
  if (deltas)
    for (int t = threadIdx.x; t < T1; t += STAT_THREADS) d1[t] = delta_at<NT>(e, 0, t, T, N, denom);
  __syncthreads();

  // the sums (ΔΔ formed on the fly); per utterance then the squares
  const float cnt = (float)max(Lc, 1);
  float* pb = part + (size_t)col * 3;
  if (mode == STATS_GLOBAL_SQ) {
    const float mu = gstat[0];
    float v0 = 0.f, v1 = 0.f, v2 = 0.f;
    for (int t = threadIdx.x; t < Lc; t += STAT_THREADS) {
      const float a = e[t] - mu;
      v0 += a * a;
      if (deltas) {
        const float bb = d1[t] - mu, cc = delta_at<NT>(d1, 0, t, T, N, denom) - mu;
        v1 += bb * bb;
        v2 += cc * cc;
      }
    }
    block_sum3(v0, v1, v2, red);
    if (threadIdx.x == 0) {
      pb[0] = v0;
      pb[1] = v1;
      pb[2] = v2;
    }
    return;
  }
  float s0 = 0.f, s1 = 0.f, s2 = 0.f;
  for (int t = threadIdx.x; t < Lc; t += STAT_THREADS) {
    s0 += e[t];
    if (deltas) {
      s1 += d1[t];
      s2 += delta_at<NT>(d1, 0, t, T, N, denom);
    }
  }
  block_sum3(s0, s1, s2, red);
  if (threadIdx.x == 0 && m == 0) new_len[b] = stacked_len(L, T, Tp, stack, skip);
  if (mode == STATS_GLOBAL_SUM) {
    if (threadIdx.x == 0) {
      pb[0] = s0;
      pb[1] = s1;
      pb[2] = s2;
    }
    return;
  }
  const float mu0 = s0 / cnt, mu1 = s1 / cnt, mu2 = s2 / cnt;
  float v0 = 0.f, v1 = 0.f, v2 = 0.f;
  for (int t = threadIdx.x; t < Lc; t += STAT_THREADS) {
    const float a = e[t] - mu0;
    v0 += a * a;
    if (deltas) {
      const float bb = d1[t] - mu1;
      const float cc = delta_at<NT>(d1, 0, t, T, N, denom) - mu2;
      v1 += bb * bb;
      v2 += cc * cc;
    }
  }
  block_sum3(v0, v1, v2, red);
  if (threadIdx.x == 0) {
    const int D = feature_width(M, deltas);
    float* mu = stats + (size_t)b * 2 * D;
    float* inv = mu + D;
    mu[m] = mu0;
    inv[m] = 1.0f / sqrtf(v0 / cnt + 1e-8f);
    if (deltas) {
      mu[M + m] = mu1;
      mu[2 * M + m] = mu2;
      inv[M + m] = 1.0f / sqrtf(v1 / cnt + 1e-8f);
      inv[2 * M + m] = 1.0f / sqrtf(v2 / cnt + 1e-8f);
    }
  }
}

constexpr int REDUCE_THREADS = 1024;

// The global statistics from launch 2's partial sums part [n], in a fixed
// order (a thread a strided run, then a tree): pass 1 writes the mean
// gstat[0] = sum / max(valid frames * D, 1), pass 2 the inverse standard
// deviation gstat[1] = 1 / sqrt(sum / max(..) + 1e-8).
__global__ void __launch_bounds__(REDUCE_THREADS)
global_stat_reduce(const float* __restrict__ part, const int* __restrict__ feat_len,
                   float* __restrict__ gstat, int n, int B, int T, int D, int pass) {
  __shared__ float red[REDUCE_THREADS];
  __shared__ int frames;
  float s = 0.f;
  for (int i = threadIdx.x; i < n; i += REDUCE_THREADS) s += part[i];
  red[threadIdx.x] = s;
  if (threadIdx.x == 0) {
    int c = 0;
    for (int b = 0; b < B; ++b) c += min(max(feat_len[b], 0), T);
    frames = c;
  }
  __syncthreads();
  for (int w = REDUCE_THREADS / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) red[threadIdx.x] += red[threadIdx.x + w];
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    const float denom = fmaxf((float)frames * (float)D, 1.0f);
    gstat[pass - 1] = pass == 1 ? red[0] / denom : 1.0f / sqrtf(red[0] / denom + 1e-8f);
  }
}

// normalization="none": new_len [B] only
__global__ void lengths_kernel(const int* __restrict__ feat_len, int* __restrict__ new_len,
                               int B, int T, int Tp, int stack, int skip) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b < B) new_len[b] = stacked_len(feat_len[b], T, Tp, stack, skip);
}

// The frames a chunk of stacked frames [tp0, tp1) reads, and the halo its
// delta windows add, clamped to [0, T).
struct ChunkFrames {
  int ta, tb;  // frames of the output
  int s0, s1;  // staged log-mel frames: [ta - 2N, tb + 2N]
  int u0, u1;  // Δ frames: [ta - N, tb + N]
};

__host__ __device__ __forceinline__ ChunkFrames chunk_frames(int tp0, int tp1, int T, int stack,
                                                             int skip, int N) {
  ChunkFrames c;
  c.ta = tp0 * skip;
  c.tb = (tp1 - 1) * skip + stack - 1;
  c.s0 = c.ta - 2 * N > 0 ? c.ta - 2 * N : 0;
  c.s1 = c.tb + 2 * N < T - 1 ? c.tb + 2 * N : T - 1;
  c.u0 = c.ta - N > 0 ? c.ta - N : 0;
  c.u1 = c.tb + N < T - 1 ? c.tb + N : T - 1;
  return c;
}

// N is the delta window with deltas, else 0 (no halo)
size_t writer_smem(int M, int chunk, int stack, int skip, int N, int deltas) {
  const int ns = (chunk - 1) * skip + stack + 4 * N;  // staged frames, at most
  const int ny = (chunk - 1) * skip + stack;          // output frames, at most
  const int D = feature_width(M, deltas);
  return ((size_t)(deltas ? 2 : 1) * M * ns + (size_t)ny * D + (size_t)2 * D) * sizeof(float);
}

// A block per (chunk of stacked frames, utterance): out [B, Tp, stack * D],
// normalized by the utterance's statistics (norm 1), the batch's gstat
// (norm 2) or not at all (norm 0).  N is 0 without deltas.
template <int NT>
__global__ void __launch_bounds__(WR_THREADS)
writer_kernel(const float* __restrict__ logmel,  // [B, M, T]
              const int* __restrict__ feat_len, const float* __restrict__ stats,
              const float* __restrict__ gstat, float* __restrict__ out, int T, int M, int Tp,
              int stack, int skip, int N, int chunk, int deltas, int norm) {
  extern __shared__ __align__(16) float sm[];
  const int b = blockIdx.y;
  const int tp0 = blockIdx.x * chunk;
  const int tp1 = min(tp0 + chunk, Tp);
  const ChunkFrames c = chunk_frames(tp0, tp1, T, stack, skip, N);
  const int ns = c.s1 - c.s0 + 1;
  const int ny = c.tb - c.ta + 1;
  const int D = feature_width(M, deltas);
  float* e_s = sm;                            // [M][ns]: log-mel frames s0..s1
  float* d1_s = e_s + M * ns;                 // [M][ns]: Δ at frames u0..u1 (index frame - s0)
  float* y_s = d1_s + (deltas ? M * ns : 0);  // [ny][D]: normalized features of frames ta..tb
  float* st_s = y_s + ny * D;                 // [2D]: means, inverse std
  const int L = feat_len[b];
  const int Lc = min(max(L, 0), T);
  const int last = max(Lc - 1, 0);
  const int nl = stacked_len(L, T, Tp, stack, skip);
  const float denom = delta_denom(N);

  for (int i = threadIdx.x; i < 2 * D; i += WR_THREADS)
    st_s[i] = norm == 1 ? stats[(size_t)b * 2 * D + i] : norm == 2 ? gstat[i < D ? 0 : 1]
                                                                   : (i < D ? 0.f : 1.f);
  const float* src = logmel + (size_t)b * M * T;
  for (int i0 = 0; i0 < M * ns; i0 += 4 * WR_THREADS) {  // four loads in flight a thread
    float x[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = i0 + u * WR_THREADS + threadIdx.x;
      if (i < M * ns) {
        const int m = i / ns;
        x[u] = src[(size_t)m * T + min(c.s0 + (i - m * ns), last)];
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = i0 + u * WR_THREADS + threadIdx.x;
      if (i < M * ns) e_s[i] = x[u];
    }
  }
  __syncthreads();
  const int nu = deltas ? c.u1 - c.u0 + 1 : 0;
  for (int i = threadIdx.x; i < M * nu; i += WR_THREADS) {
    const int m = i / nu;
    const int t = c.u0 + (i - m * nu);
    d1_s[m * ns + t - c.s0] = delta_at<NT>(e_s + m * ns, c.s0, t, T, N, denom);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < ny * M; i += WR_THREADS) {  // the static, Δ, ΔΔ of (t, m)
    const int tl = i / M;
    const int m = i - tl * M;
    const int t = c.ta + tl;
    float* y = y_s + tl * D + m;
    // norm 0 keeps the raw features: (x - 0) * 1 is x
    if (t < Lc) {
      const int at = m * ns + t - c.s0;
      y[0] = norm == 0 ? e_s[at] : (e_s[at] - st_s[m]) * st_s[D + m];
      if (deltas) {
        const float d2 = delta_at<NT>(d1_s + m * ns, c.s0, t, T, N, denom);
        y[M] = norm == 0 ? d1_s[at] : (d1_s[at] - st_s[M + m]) * st_s[D + M + m];
        y[2 * M] = norm == 0 ? d2 : (d2 - st_s[2 * M + m]) * st_s[D + 2 * M + m];
      }
    } else {
      y[0] = 0.f;
      if (deltas) y[M] = y[2 * M] = 0.f;
    }
  }
  __syncthreads();

  // whole stacked frames tp0..tp1-1, a warp a frame: stacked frame tp is the
  // stack * 3M contiguous features of frames tp * skip onwards in y_s
  const int RW = stack * D;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int tl = warp; tl < tp1 - tp0; tl += WR_THREADS / 32) {
    const bool live = tp0 + tl < nl;
    const float* y = y_s + tl * skip * D;
    float* o = out + ((size_t)b * Tp + tp0 + tl) * RW;
    if (RW % 2 == 0 && (skip * D) % 2 == 0) {  // 8-byte aligned in y_s and the output
      const float2* y2 = reinterpret_cast<const float2*>(y);
      float2* o2 = reinterpret_cast<float2*>(o);
      for (int q = lane; q < RW / 2; q += 32) o2[q] = live ? y2[q] : make_float2(0.f, 0.f);
    } else {
      for (int q = lane; q < RW; q += 32) o[q] = live ? y[q] : 0.f;
    }
  }
}

cudaError_t allow_smem(const void* fn, size_t bytes) {
  if (bytes > SMEM_LIMIT) return cudaErrorInvalidValue;
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

size_t mel_smem(int rows_per_block, int F, int M, int nw) {
  return ((size_t)rows_per_block * F + nw + 3 * M) * sizeof(float);
}

}  // namespace

// Shared memory of launch 3's blocks (``kernels.logmel_writer_smem``).
extern "C" long long avsr_logmel_writer_smem(int M, int chunk, int stack, int skip, int N,
                                             int deltas) {
  return (long long)writer_smem(M, chunk, stack, skip, deltas ? N : 0, deltas);
}

// logmel: [B, M, T] fp32 scratch; stats: [B, 2, D] fp32 scratch (D = 3M with
// deltas, else M); gpart: [B * M * 3 + 2] fp32 scratch (the global
// statistics' partial sums, then their mean and inverse std); out: [B, Tp,
// stack * D]; new_len: [B]; band [M, 3] int32 and weights [nw] fp32 from
// kernels.mel_band_table (the identity for the spectrogram); norm 0 none, 1
// per utterance, 2 global.
extern "C" int avsr_logmel_post_dft(const void* re, const void* im, const void* feat_len,
                                    const void* band, const void* weights, void* logmel,
                                    void* stats, void* out, void* new_len, void* gpart, int B,
                                    int T, int F, int M, int nw, int Tp, int stack, int skip,
                                    int delta_window, int chunk, float log_floor, int deltas,
                                    int norm, int stages, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (B < 0 || T < 0 || F < 1 || M < 1 || nw < 0 || Tp < 0 || stack < 1 || skip < 1 ||
      delta_window < 0 || chunk < 1 || norm < 0 || norm > 2 || (deltas && delta_window < 1))
    return (int)cudaErrorInvalidValue;
  const int rows = B * T;
  if ((stages & 1) && rows > 0) {
    int rpb = MEL_ROWS;
    while (rpb > 4 && mel_smem(rpb, F, M, nw) > SMEM_LIMIT) rpb /= 2;
    const size_t smem = mel_smem(rpb, F, M, nw);
    cudaError_t e = allow_smem((const void*)mel_band_kernel, smem);
    if (e != cudaSuccess) return (int)e;
    mel_band_kernel<<<(rows + rpb - 1) / rpb, MEL_THREADS, smem, st>>>(
        static_cast<const float*>(re), static_cast<const float*>(im),
        static_cast<const int*>(band), static_cast<const float*>(weights),
        static_cast<float*>(logmel), rows, T, F, M, nw, rpb, log_floor);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  const bool n2 = deltas && delta_window == 2;  // the presets' window, unrolled
  const int N = deltas ? delta_window : 0;
  const int D = feature_width(M, deltas);
  float* part = static_cast<float*>(gpart);
  float* gstat = part + (size_t)B * M * 3;
  if ((stages & 2) && B > 0 && norm == 0) {
    lengths_kernel<<<(B + 127) / 128, 128, 0, st>>>(static_cast<const int*>(feat_len),
                                                    static_cast<int*>(new_len), B, T, Tp, stack,
                                                    skip);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  } else if ((stages & 2) && B > 0) {
    const size_t smem = (size_t)2 * T * sizeof(float);
    const void* fn = n2 ? (const void*)stats_kernel<2> : (const void*)stats_kernel<0>;
    cudaError_t e = allow_smem(fn, smem);
    if (e != cudaSuccess) return (int)e;
    const int passes = norm == 1 ? 1 : 2;
    for (int pass = 1; pass <= passes; ++pass) {
      const int mode = norm == 1 ? STATS_UTTERANCE : pass == 1 ? STATS_GLOBAL_SUM : STATS_GLOBAL_SQ;
      if (n2)
        stats_kernel<2><<<B * M, STAT_THREADS, smem, st>>>(
            static_cast<const float*>(logmel), static_cast<const int*>(feat_len),
            static_cast<float*>(stats), static_cast<int*>(new_len), part, gstat, T, M, Tp,
            stack, skip, delta_window, deltas, mode);
      else
        stats_kernel<0><<<B * M, STAT_THREADS, smem, st>>>(
            static_cast<const float*>(logmel), static_cast<const int*>(feat_len),
            static_cast<float*>(stats), static_cast<int*>(new_len), part, gstat, T, M, Tp,
            stack, skip, delta_window, deltas, mode);
      e = cudaGetLastError();
      if (e != cudaSuccess) return (int)e;
      if (norm == 2) {
        global_stat_reduce<<<1, REDUCE_THREADS, 0, st>>>(part, static_cast<const int*>(feat_len),
                                                         gstat, B * M * 3, B, T, D, pass);
        e = cudaGetLastError();
        if (e != cudaSuccess) return (int)e;
      }
    }
  }
  if ((stages & 4) && B > 0 && Tp > 0) {
    const size_t smem = writer_smem(M, chunk, stack, skip, N, deltas);
    const void* fn = n2 ? (const void*)writer_kernel<2> : (const void*)writer_kernel<0>;
    cudaError_t e = allow_smem(fn, smem);
    if (e != cudaSuccess) return (int)e;
    const dim3 grid((Tp + chunk - 1) / chunk, B);
    if (n2)
      writer_kernel<2><<<grid, WR_THREADS, smem, st>>>(
          static_cast<const float*>(logmel), static_cast<const int*>(feat_len),
          static_cast<const float*>(stats), gstat, static_cast<float*>(out), T, M, Tp, stack,
          skip, N, chunk, deltas, norm);
    else
      writer_kernel<0><<<grid, WR_THREADS, smem, st>>>(
          static_cast<const float*>(logmel), static_cast<const int*>(feat_len),
          static_cast<const float*>(stats), gstat, static_cast<float*>(out), T, M, Tp, stack,
          skip, N, chunk, deltas, norm);
  }
  return (int)cudaGetLastError();
}

// K9: the conformer conv module's span between its two pointwise products,
// forward.
//
// Replaces avsr_tpu/models/transformer.py:transformer_encoder_apply's
// conformer conv module (transformer.py:231-266), which the JAX package
// leaves to XLA.  The two pointwise products stay matrix products (torch
// code here, as the reference leaves them to XLA): the kernel takes their
// first one, u = bf16(LN(h) * mask) @ w_in ([T, B, 2d] bf16, time-major as
// the encoder stack is), and returns the operand of the second one:
//
//   g = bf16(u + bf16(b_in))                     (the biased pointwise)
//   y = bf16(a * bf16(sigmoid(gate)))            (GLU; a, gate = g[:d], g[d:])
//   y = y * mask                                  (padded steps of the stack)
//   z[t] = sum_j y[t + j - k/2] * dw[j]           (fp32, depthwise, SAME: zeros
//                                                  beyond the padded horizon)
//   z = LN(z) (fp32 statistics over d, eps 1e-6, conv_dw_ln scale / bias)
//   out = bf16(z * sigmoid(z))                    (swish)
//
// Every row is computed, padded ones included, as in the reference; a valid
// row never reads a padded one (the mask zeroes them first), so valid
// outputs do not depend on the pad horizon.  The depthwise weights are the
// reference's [k, 1, d] (WIO) layout, read as [k, d].
//
// What bounds it on an H100: at the phase check's batch (B = 128, T = 197,
// d = 512, k = 15) the function reads 51.6 MB of u and writes 25.8 MB: ~23
// us of HBM time, against ~0.39 GFLOP of fp32 work (~6 us at 67 TFLOP/s):
// byte-bound.  Design, the simple one: one block per (utterance, tile of TT
// = 16 time steps); a thread owns one channel pair (256 threads at d =
// 512).  The tile's GLU'd rows plus the k - 1 halo rows are staged in shared
// memory as fp32 ([TT + k - 1][d], 60 KB at d = 512, k = 15); each thread
// then runs the k-tap conv of its own two channels for the TT rows in
// registers, so the stage and the conv need no barrier.  The LayerNorm
// reduces over the d channels of each row with warp shuffles and one
// shared partial per warp, summed in a fixed order (the same bits every
// run), mean first, then the centred squares, as the reference does.  The
// halo rows are read by two neighbouring blocks (k - 1 = 14 extra rows per
// 16: up to 1.9x u's bytes, mostly from L2); a wider tile is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int TT = 16;  // time steps per block

__device__ __forceinline__ float bf_round(float x) {
  return __bfloat162float(__float2bfloat16(x));
}
__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

int block_threads(int d) { return ((d / 2 + 31) / 32) * 32; }

size_t conv_smem(int d, int k) {
  const int nwarps = block_threads(d) / 32;
  return (size_t)(TT + k - 1) * d * 4 + (size_t)2 * nwarps * TT * 4;
}

__global__ void conformer_conv_kernel(const __nv_bfloat16* __restrict__ u,     // [T, B, 2d]
                                      const __nv_bfloat16* __restrict__ b_in,  // [2d]
                                      const float* __restrict__ dw,            // [k, d]
                                      const float* __restrict__ ln_scale,      // [d]
                                      const float* __restrict__ ln_bias,       // [d]
                                      const int* __restrict__ lengths,         // [B]
                                      __nv_bfloat16* __restrict__ out,         // [T, B, d]
                                      int T, int B, int d, int k) {
  extern __shared__ __align__(16) float smem[];
  const int nwarps = blockDim.x / 32;
  const int rows = TT + k - 1;
  float* x_s = smem;                            // [rows][d] GLU'd, masked rows
  float* sum_s = x_s + (size_t)rows * d;        // [nwarps][TT]
  float* sq_s = sum_s + (size_t)nwarps * TT;    // [nwarps][TT]
  const int b = blockIdx.y, t0 = blockIdx.x * TT, half = k / 2;
  const int len = lengths[b];
  const int c = threadIdx.x;  // channels 2c, 2c + 1
  const bool own = 2 * c < d;

  // stage: rows t0 - k/2 .. t0 + TT - 1 + k/2; zeros outside [0, T)
  if (own) {
    const __nv_bfloat162 ba = reinterpret_cast<const __nv_bfloat162*>(b_in)[c];
    const __nv_bfloat162 bg = reinterpret_cast<const __nv_bfloat162*>(b_in + d)[c];
    for (int r = 0; r < rows; ++r) {
      const int t = t0 - half + r;
      float y0 = 0.f, y1 = 0.f;
      if (t >= 0 && t < T) {
        const __nv_bfloat16* row = u + ((size_t)t * B + b) * 2 * d;
        const __nv_bfloat162 a = reinterpret_cast<const __nv_bfloat162*>(row)[c];
        const __nv_bfloat162 g = reinterpret_cast<const __nv_bfloat162*>(row + d)[c];
        const float a0 = bf_round(__low2float(a) + __low2float(ba));
        const float a1 = bf_round(__high2float(a) + __high2float(ba));
        const float g0 = bf_round(__low2float(g) + __low2float(bg));
        const float g1 = bf_round(__high2float(g) + __high2float(bg));
        const float m = t < len ? 1.f : 0.f;
        y0 = bf_round(a0 * bf_round(sigmoid(g0))) * m;
        y1 = bf_round(a1 * bf_round(sigmoid(g1))) * m;
      }
      reinterpret_cast<float2*>(x_s + (size_t)r * d)[c] = make_float2(y0, y1);
    }
  }

  // the k-tap depthwise conv of this thread's two channels, TT rows
  float acc0[TT], acc1[TT];
#pragma unroll
  for (int r = 0; r < TT; ++r) acc0[r] = acc1[r] = 0.f;
  if (own) {
    for (int j = 0; j < k; ++j) {
      const float2 w = reinterpret_cast<const float2*>(dw + (size_t)j * d)[c];
#pragma unroll
      for (int r = 0; r < TT; ++r) {
        const float2 x = reinterpret_cast<const float2*>(x_s + (size_t)(r + j) * d)[c];
        acc0[r] = fmaf(x.x, w.x, acc0[r]);
        acc1[r] = fmaf(x.y, w.y, acc1[r]);
      }
    }
  }

  // LayerNorm over d per row: the mean, then the centred squares
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int r = 0; r < TT; ++r) {
    const float s = warp_sum(acc0[r] + acc1[r]);
    if (lane == 0) sum_s[warp * TT + r] = s;
  }
  __syncthreads();
  float mu[TT];
#pragma unroll
  for (int r = 0; r < TT; ++r) {
    float s = 0.f;
    for (int w = 0; w < nwarps; ++w) s += sum_s[w * TT + r];
    mu[r] = s / d;
    const float e0 = acc0[r] - mu[r], e1 = acc1[r] - mu[r];
    const float q = warp_sum(own ? e0 * e0 + e1 * e1 : 0.f);
    if (lane == 0) sq_s[warp * TT + r] = q;
  }
  __syncthreads();
  if (!own) return;
  const float2 sc = reinterpret_cast<const float2*>(ln_scale)[c];
  const float2 bi = reinterpret_cast<const float2*>(ln_bias)[c];
#pragma unroll
  for (int r = 0; r < TT; ++r) {
    const int t = t0 + r;
    if (t >= T) break;
    float s = 0.f;
    for (int w = 0; w < nwarps; ++w) s += sq_s[w * TT + r];
    const float rstd = rsqrtf(s / d + 1e-6f);
    const float z0 = (acc0[r] - mu[r]) * rstd * sc.x + bi.x;
    const float z1 = (acc1[r] - mu[r]) * rstd * sc.y + bi.y;
    reinterpret_cast<__nv_bfloat162*>(out + ((size_t)t * B + b) * d)[c] =
        __floats2bfloat162_rn(z0 * sigmoid(z0), z1 * sigmoid(z1));
  }
}

}  // namespace

// Shared-memory bytes the launch asks for (the wrapper checks the limit).
extern "C" long long avsr_conformer_conv_smem(int d, int k) { return (long long)conv_smem(d, k); }

extern "C" int avsr_conformer_conv(const void* u, const void* b_in, const void* dw,
                                   const void* ln_scale, const void* ln_bias,
                                   const void* lengths, void* out, int T, int B, int d, int k,
                                   void* stream) {
  if (d % 2 || d < 2 || d > 1024 || k < 1 || k % 2 == 0 || T < 1 || B < 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem = conv_smem(d, k);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        conformer_conv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((T + TT - 1) / TT, B);
  conformer_conv_kernel<<<grid, block_threads(d), smem, reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(u), static_cast<const __nv_bfloat16*>(b_in),
      static_cast<const float*>(dw), static_cast<const float*>(ln_scale),
      static_cast<const float*>(ln_bias), static_cast<const int*>(lengths),
      static_cast<__nv_bfloat16*>(out), T, B, d, k);
  return (int)cudaGetLastError();
}

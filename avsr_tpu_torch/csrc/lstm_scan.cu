// K1: direction-batched masked LSTM recurrence, forward.
//
// Replaces avsr_tpu/ops/rnn.py:_bilstm_scan_core (forward,
// _bilstm_scan_core_fwd_impl with save=False), the hand-derived JAX core
// every BiLSTM layer of the encoders runs.  Per step t and direction g:
//
//   gates = float(xw[t,g]) + (bf16(h) @ bf16(Wh[g]), fp32 accumulate) + b[g]
//   i, f, o = sigmoid; g = tanh;  c' = f*c + i*g;  h' = o * tanh(c')
//   m = mask[t,g,b]:  (h, c) <- m ? (h', c') : (h, c);  ys[t,g] = bf16(h' * m)
//
// The backward direction's stream arrives pre-flipped in time, so one
// forward scan serves both directions (G = 2 for a BiLSTM layer).
//
// What bounds it on an H100: the recurrence is sequential in t, and at the
// main path's shapes (B = 128, H = 256, G = 2) one step is only
// 2 x 128 x 256 x 1024 MACs (134 MFLOP) — too little work to fill 132 SMs
// with tensor-core tiles, so a step costs launch latency, the time to
// bring each block's Wh slice (32 KB bf16; all of Wh, 1 MB, stays in L2)
// into shared memory, and the shared-memory issue rate of the product.
// Design: one grid launch per step from a host loop inside this file (one
// ctypes call per layer, not per step).  Each block owns one direction, a
// tile of BT batch rows and a tile of UT hidden units, and computes ALL
// FOUR gates of those units, so the cell update needs nothing from other
// blocks; h is double-buffered in device memory between steps (every block
// reads all H units of its rows' previous h), c is updated in place (only
// its owner reads it).  The wrapper passes Wh pre-tiled as
// [G, H/UT, H, UT, 4] (unit tile, k, unit, gate), so a block's slice is one
// contiguous 16-byte-vectorized copy and each thread reads the four gate
// weights of its unit for one k as a single 8-byte shared-memory load.
// The epilogue's operands (xw, b, c, h, mask) are loaded before the
// product so their latency overlaps it.  The product runs on CUDA cores
// with fp32 FMAs on bf16-rounded operands — exact products, fp32
// accumulation, the reference's numerics.  A persistent cluster kernel
// keeping Wh resident in distributed shared memory and using wgmma is
// later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BT = 16;  // batch rows per block
constexpr int UT = 16;  // hidden units per block
constexpr int THREADS = BT * UT;
constexpr int VEC = 8;  // 16-byte loads in flight per thread while staging

__device__ __forceinline__ float sigmoidf_(float x) {
  return 1.0f / (1.0f + expf(-x));
}

__device__ __forceinline__ float bf_lo(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float bf_hi(uint32_t v) { return __uint_as_float(v & 0xffff0000u); }

__global__ void __launch_bounds__(THREADS)
lstm_step_kernel(const __nv_bfloat16* __restrict__ wh_tiled,  // [G, H/UT, H, UT, 4]
                 const float* __restrict__ bias,              // [G, 4H]
                 const __nv_bfloat16* __restrict__ xw_t,      // [G, B, 4H]
                 const float* __restrict__ mask_t,            // [G, B]
                 const float* __restrict__ h_in,              // [G, B, H]
                 float* __restrict__ h_out,                   // [G, B, H]
                 float* __restrict__ c,                       // [G, B, H] in place
                 __nv_bfloat16* __restrict__ ys_t,            // [G, B, H]
                 int B, int H) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* w_s = reinterpret_cast<__nv_bfloat16*>(smem);  // [H][UT][4]
  __nv_bfloat16* h_s = w_s + (size_t)H * UT * 4;                // [BT][H]

  const int g = blockIdx.z;
  const int tile = blockIdx.x;
  const int row0 = blockIdx.y * BT;
  const int tid = threadIdx.x;
  const int r = tid / UT;
  const int u = tid - r * UT;
  const int row = row0 + r;
  const int unit = tile * UT + u;
  const bool live = row < B;
  const int H4 = 4 * H;

  // Epilogue operands first.
  const size_t gb = (size_t)g * B + (live ? row : 0);
  const size_t s = gb * H + unit;
  const __nv_bfloat16* x = xw_t + gb * H4;
  const float* bb = bias + (size_t)g * H4;
  float xi = 0.f, xf = 0.f, xg = 0.f, xo = 0.f, c_prev = 0.f, h_prev = 0.f, m = 0.f;
  if (live) {
    xi = __bfloat162float(x[unit]);
    xf = __bfloat162float(x[H + unit]);
    xg = __bfloat162float(x[2 * H + unit]);
    xo = __bfloat162float(x[3 * H + unit]);
    c_prev = c[s];
    h_prev = h_in[s];
    m = mask_t[gb];
  }
  const float bi = bb[unit], bf = bb[H + unit], bg = bb[2 * H + unit], bo = bb[3 * H + unit];

  // This block's Wh slice: one contiguous [H][UT][4] bf16 run.
  {
    const uint4* src = reinterpret_cast<const uint4*>(
        wh_tiled + ((size_t)g * (H / UT) + tile) * H * UT * 4);
    uint4* dst = reinterpret_cast<uint4*>(w_s);
    const int n = H * UT * 4 / 8;
    for (int c0 = tid; c0 < n; c0 += VEC * THREADS) {
      uint4 v[VEC];
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const int ci = c0 + j * THREADS;
        if (ci < n) v[j] = src[ci];
      }
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const int ci = c0 + j * THREADS;
        if (ci < n) dst[ci] = v[j];
      }
    }
  }
  // The previous h of this block's rows, rounded to bf16 (the reference
  // casts h to the compute dtype before the recurrent product).
  {
    const int per_row = H / 4;
    const int n = BT * per_row;
    __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(h_s);
    for (int c0 = tid; c0 < n; c0 += VEC * THREADS) {
      float4 v[VEC];
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const int ci = c0 + j * THREADS;
        const int rr = ci / per_row;
        const int rrow = row0 + rr;
        v[j] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (ci < n && rrow < B)
          v[j] = reinterpret_cast<const float4*>(h_in + ((size_t)g * B + rrow) * H)
              [ci - rr * per_row];
      }
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const int ci = c0 + j * THREADS;
        if (ci < n) {
          dst[2 * ci] = __floats2bfloat162_rn(v[j].x, v[j].y);
          dst[2 * ci + 1] = __floats2bfloat162_rn(v[j].z, v[j].w);
        }
      }
    }
  }
  __syncthreads();

  // acc[q] = sum_k bf16(h[row, k]) * Wh[k, q*H + unit]
  float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
  const uint32_t* hr = reinterpret_cast<const uint32_t*>(h_s + r * H);  // bf16 pairs
  const uint2* wu = reinterpret_cast<const uint2*>(w_s) + u;             // 4 gates / k
#pragma unroll 4
  for (int k2 = 0; k2 < H / 2; ++k2) {
    const uint32_t hh = hr[k2];
    const uint2 w0 = wu[(2 * k2) * UT];
    const uint2 w1 = wu[(2 * k2 + 1) * UT];
    const float h0 = bf_lo(hh), h1 = bf_hi(hh);
    a0 = fmaf(h0, bf_lo(w0.x), a0);
    a1 = fmaf(h0, bf_hi(w0.x), a1);
    a2 = fmaf(h0, bf_lo(w0.y), a2);
    a3 = fmaf(h0, bf_hi(w0.y), a3);
    a0 = fmaf(h1, bf_lo(w1.x), a0);
    a1 = fmaf(h1, bf_hi(w1.x), a1);
    a2 = fmaf(h1, bf_lo(w1.y), a2);
    a3 = fmaf(h1, bf_hi(w1.y), a3);
  }
  if (!live) return;

  const float i = sigmoidf_((xi + a0) + bi);
  const float f = sigmoidf_((xf + a1) + bf);
  const float gt = tanhf((xg + a2) + bg);
  const float o = sigmoidf_((xo + a3) + bo);
  const float c_new = f * c_prev + i * gt;
  const float h_new = o * tanhf(c_new);
  h_out[s] = m * h_new + (1.0f - m) * h_prev;
  c[s] = m * c_new + (1.0f - m) * c_prev;
  ys_t[s] = __float2bfloat16(h_new * m);
}

}  // namespace

// wh_tiled: [G, H/UT, H, UT, 4] bf16 (see above; H must be a multiple of UT).
// hbuf: [2][G, B, H] fp32 with h0 in slot 0; after T steps h_T is in slot
// T % 2.  c: [G, B, H] fp32 holding c0 on entry and c_T on return.
extern "C" int avsr_lstm_scan_fwd(const void* wh_tiled, const void* bias,
                                  const void* xw, const void* mask, void* hbuf,
                                  void* c, void* ys, int T, int G, int B,
                                  int H, void* stream) {
  if (H % UT != 0) return (int)cudaErrorInvalidValue;
  const dim3 grid(H / UT, (B + BT - 1) / BT, G);
  const dim3 block(THREADS);
  const size_t smem = ((size_t)H * UT * 4 + (size_t)BT * H) * sizeof(__nv_bfloat16);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        lstm_step_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const size_t gbh = (size_t)G * B * H;
  const __nv_bfloat16* xw_p = static_cast<const __nv_bfloat16*>(xw);
  const float* mask_p = static_cast<const float*>(mask);
  float* h_p = static_cast<float*>(hbuf);
  __nv_bfloat16* ys_p = static_cast<__nv_bfloat16*>(ys);
  for (int t = 0; t < T; ++t) {
    lstm_step_kernel<<<grid, block, smem, st>>>(
        static_cast<const __nv_bfloat16*>(wh_tiled), static_cast<const float*>(bias),
        xw_p + (size_t)t * G * B * 4 * H, mask_p + (size_t)t * G * B,
        h_p + (size_t)(t & 1) * gbh, h_p + (size_t)((t + 1) & 1) * gbh,
        static_cast<float*>(c), ys_p + (size_t)t * gbh, B, H);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaGetLastError();
}

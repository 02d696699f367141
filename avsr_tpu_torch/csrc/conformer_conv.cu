// K9: the conformer conv module's span between its two pointwise products,
// forward and backward.
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
// Backward: JAX's autodiff of the same lines, last step first, with its
// rounding points (dout is the output's bf16 cotangent; x is the conv's
// output before the LayerNorm, xh its normalised value):
//
//   dz  = dout * (s + z * s * sigmoid(-z)),  s = sigmoid(z)      (fp32, swish)
//   dln_scale += dz * xh;  dln_bias += dz
//   dx  = rstd * (dxh - mean(dxh) - xh * mean(dxh * xh)),  dxh = dz * scale
//   dy  = bf16(sum_j dx[t - j + k/2] * dw[j])   (the conv's transpose: the taps
//                                                reversed; bf16, the transpose
//                                                of the cast of y to fp32)
//   ddw[j] += y[t + j - k/2] * dx[t]             (per channel, over B and T)
//   dy  = dy * mask
//   da  = bf16(dy * s_g);  ds = bf16(dy * a)     (s_g = bf16(sigmoid(gate)))
//   dgate = bf16(ds * bf16(s_g * bf16(sigmoid(-gate))))   (jax's logistic JVP)
//   du  = [da, dgate];  db_in = bf16(sum over B, T of du)  (fp32 sum, rounded
//                                                          once to bf16)
//
// The backward recomputes the GLU, the conv and the row statistics from u
// (nothing but the inputs is saved) and computes every row, padded ones
// included: their cotangents are not assumed to be zero.
//
// What bounds it on an H100: at the phase check's batch (B = 128, T = 197,
// d = 512, k = 15) the forward reads 51.6 MB of u and writes 25.8 MB: ~23
// us of HBM time, against ~0.39 GFLOP of fp32 work (~6 us at 67 TFLOP/s):
// byte-bound.  The backward's own function reads u (51.6 MB) and dout (25.8
// MB) and writes du (51.6 MB): ~129 MB, ~39 us, also byte-bound; the kernel
// moves more: an fp32 dx scratch [T, B, d] (51.6 MB written, read back with
// its halo), u read twice, and per-block partial sums (~20 MB).
//
// Design, the simple one.  Forward: one block per (utterance, tile of TT =
// 16 time steps); a thread owns one channel pair (256 threads at d = 512).
// The tile's GLU'd rows plus the k - 1 halo rows are staged in shared
// memory as fp32 ([TT + k - 1][d], 60 KB at d = 512, k = 15); each thread
// then runs the k-tap conv of its own two channels for the TT rows in
// registers, so the stage and the conv need no barrier.  The LayerNorm
// reduces over the d channels of each row with warp shuffles and one
// shared partial per warp, summed in a fixed order (the same bits every
// run), mean first, then the centred squares, as the reference does.  The
// halo rows are read by two neighbouring blocks (k - 1 = 14 extra rows per
// 16: up to 1.9x u's bytes, mostly from L2); a wider tile is later work.
// Backward, three launches, one block per (utterance, chunk of CH = 64
// steps) for the first two:
//   1. per tile of the chunk: the forward's recompute (the same code, so the
//      same z), the swish and LayerNorm backward (two more row reductions),
//      dx written in fp32; dln_scale / dln_bias summed over the chunk in
//      registers;
//   2. per tile of the chunk: y and dx staged with their k - 1 halo (y as
//      bf16, which it is exactly; 92 KB at d = 512), the transposed conv,
//      the ddw sums (added into the block's own partial row), the mask and
//      the GLU backward into du; db_in summed over the chunk;
//   3. every partial summed over the blocks in a fixed order (8 lanes, then
//      the lanes in order): no atomics, the same bits every run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int TT = 16;  // time steps per tile
constexpr int CH = 64;  // time steps per block of the backward's first two launches

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
size_t bwd_ln_smem(int d, int k) {
  const int nwarps = block_threads(d) / 32;
  return conv_smem(d, k) + (size_t)2 * nwarps * TT * 4;
}
size_t bwd_in_smem(int d, int k) { return (size_t)(TT + k - 1) * d * (2 + 4); }

// the biased, GLU'd and masked row t of utterance b for channels 2c, 2c + 1
// (zeros outside [0, T)), each value exactly a bf16
__device__ __forceinline__ float2 glu_row(const __nv_bfloat16* __restrict__ u,
                                          __nv_bfloat162 ba, __nv_bfloat162 bg, int t, int T,
                                          int B, int b, int d, int c, int len) {
  if (t < 0 || t >= T) return make_float2(0.f, 0.f);
  const __nv_bfloat16* row = u + ((size_t)t * B + b) * 2 * d;
  const __nv_bfloat162 a = reinterpret_cast<const __nv_bfloat162*>(row)[c];
  const __nv_bfloat162 g = reinterpret_cast<const __nv_bfloat162*>(row + d)[c];
  const float a0 = bf_round(__low2float(a) + __low2float(ba));
  const float a1 = bf_round(__high2float(a) + __high2float(ba));
  const float g0 = bf_round(__low2float(g) + __low2float(bg));
  const float g1 = bf_round(__high2float(g) + __high2float(bg));
  const float m = t < len ? 1.f : 0.f;
  return make_float2(bf_round(a0 * bf_round(sigmoid(g0))) * m,
                     bf_round(a1 * bf_round(sigmoid(g1))) * m);
}

// The forward of one tile of TT rows from t0 up to the LayerNorm: the GLU'd
// rows and their halo staged in x_s, the conv of this thread's two channels
// in acc0 / acc1, each row's mean in mu, and each warp's sum of the row's
// centred squares in sq_s (`row_rstd` reads them).  Every thread of the
// block must reach this with all the others.
__device__ __forceinline__ void conv_tile(
    const __nv_bfloat16* __restrict__ u, const __nv_bfloat16* __restrict__ b_in,
    const float* __restrict__ dw, float* x_s, float* sum_s, float* sq_s, int T, int B, int d,
    int k, int b, int t0, int len, float (&acc0)[TT], float (&acc1)[TT], float (&mu)[TT]) {
  const int nwarps = blockDim.x / 32;
  const int rows = TT + k - 1, half = k / 2;
  const int c = threadIdx.x;  // channels 2c, 2c + 1
  const bool own = 2 * c < d;

  // stage: rows t0 - k/2 .. t0 + TT - 1 + k/2
  if (own) {
    const __nv_bfloat162 ba = reinterpret_cast<const __nv_bfloat162*>(b_in)[c];
    const __nv_bfloat162 bg = reinterpret_cast<const __nv_bfloat162*>(b_in + d)[c];
    for (int r = 0; r < rows; ++r)
      reinterpret_cast<float2*>(x_s + (size_t)r * d)[c] =
          glu_row(u, ba, bg, t0 - half + r, T, B, b, d, c, len);
  }

  // the k-tap depthwise conv of this thread's two channels, TT rows
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

  // LayerNorm statistics over d per row: the mean, then the centred squares
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int r = 0; r < TT; ++r) {
    const float s = warp_sum(acc0[r] + acc1[r]);
    if (lane == 0) sum_s[warp * TT + r] = s;
  }
  __syncthreads();
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
}

// the reciprocal standard deviation of row r of the tile, from conv_tile's
// per-warp sums in a fixed order
__device__ __forceinline__ float row_rstd(const float* sq_s, int r, int d) {
  const int nwarps = blockDim.x / 32;
  float s = 0.f;
  for (int w = 0; w < nwarps; ++w) s += sq_s[w * TT + r];
  return rsqrtf(s / d + 1e-6f);
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
  float* x_s = smem;                                  // [TT + k - 1][d] GLU'd, masked rows
  float* sum_s = x_s + (size_t)(TT + k - 1) * d;      // [nwarps][TT]
  float* sq_s = sum_s + (size_t)nwarps * TT;          // [nwarps][TT]
  const int b = blockIdx.y, t0 = blockIdx.x * TT;
  const int c = threadIdx.x;
  float acc0[TT], acc1[TT], mu[TT];
  conv_tile(u, b_in, dw, x_s, sum_s, sq_s, T, B, d, k, b, t0, lengths[b], acc0, acc1, mu);
  if (2 * c >= d) return;
  const float2 sc = reinterpret_cast<const float2*>(ln_scale)[c];
  const float2 bi = reinterpret_cast<const float2*>(ln_bias)[c];
#pragma unroll
  for (int r = 0; r < TT; ++r) {
    const int t = t0 + r;
    if (t >= T) break;
    const float rstd = row_rstd(sq_s, r, d);
    const float z0 = (acc0[r] - mu[r]) * rstd * sc.x + bi.x;
    const float z1 = (acc1[r] - mu[r]) * rstd * sc.y + bi.y;
    reinterpret_cast<__nv_bfloat162*>(out + ((size_t)t * B + b) * d)[c] =
        __floats2bfloat162_rn(z0 * sigmoid(z0), z1 * sigmoid(z1));
  }
}

// Backward launch 1: swish and LayerNorm backward -> dx [T, B, d] fp32; the
// chunk's dln_scale / dln_bias sums into its partial row (at column k * d).
__global__ void conv_bwd_ln_kernel(const __nv_bfloat16* __restrict__ u,
                                   const __nv_bfloat16* __restrict__ b_in,
                                   const float* __restrict__ dw,
                                   const float* __restrict__ ln_scale,
                                   const float* __restrict__ ln_bias,
                                   const int* __restrict__ lengths,
                                   const __nv_bfloat16* __restrict__ dout,  // [T, B, d]
                                   float* __restrict__ dx,                  // [T, B, d]
                                   float* __restrict__ part,  // [B * chunks][(k + 4) * d]
                                   int T, int B, int d, int k) {
  extern __shared__ __align__(16) float smem[];
  const int nwarps = blockDim.x / 32;
  float* x_s = smem;
  float* sum_s = x_s + (size_t)(TT + k - 1) * d;
  float* sq_s = sum_s + (size_t)nwarps * TT;
  float* s1_s = sq_s + (size_t)nwarps * TT;  // [nwarps][TT]: sums of dxh
  float* s2_s = s1_s + (size_t)nwarps * TT;  // [nwarps][TT]: sums of dxh * xh
  const int b = blockIdx.y, c0 = blockIdx.x * CH, len = lengths[b];
  const int c = threadIdx.x;
  const bool own = 2 * c < d;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float2 sc = make_float2(0.f, 0.f), bi = make_float2(0.f, 0.f);
  if (own) {
    sc = reinterpret_cast<const float2*>(ln_scale)[c];
    bi = reinterpret_cast<const float2*>(ln_bias)[c];
  }
  float dsc0 = 0.f, dsc1 = 0.f, dbi0 = 0.f, dbi1 = 0.f;
  const int c_end = min(c0 + CH, T);
  for (int t0 = c0; t0 < c_end; t0 += TT) {
    float acc0[TT], acc1[TT], mu[TT], rstd[TT];
    conv_tile(u, b_in, dw, x_s, sum_s, sq_s, T, B, d, k, b, t0, len, acc0, acc1, mu);
    // acc becomes xh; dxh kept beside it
    float dxh0[TT], dxh1[TT];
#pragma unroll
    for (int r = 0; r < TT; ++r) {
      const int t = t0 + r;
      rstd[r] = row_rstd(sq_s, r, d);
      const float xh0 = (acc0[r] - mu[r]) * rstd[r], xh1 = (acc1[r] - mu[r]) * rstd[r];
      float g0 = 0.f, g1 = 0.f;
      if (own && t < T) {
        const __nv_bfloat162 g =
            reinterpret_cast<const __nv_bfloat162*>(dout + ((size_t)t * B + b) * d)[c];
        g0 = __low2float(g);
        g1 = __high2float(g);
      }
      const float z0 = xh0 * sc.x + bi.x, z1 = xh1 * sc.y + bi.y;
      const float sp0 = sigmoid(z0), sp1 = sigmoid(z1);
      const float dz0 = g0 * sp0 + (z0 * g0) * (sp0 * sigmoid(-z0));
      const float dz1 = g1 * sp1 + (z1 * g1) * (sp1 * sigmoid(-z1));
      dsc0 = fmaf(dz0, xh0, dsc0);
      dsc1 = fmaf(dz1, xh1, dsc1);
      dbi0 += dz0;
      dbi1 += dz1;
      acc0[r] = xh0;
      acc1[r] = xh1;
      dxh0[r] = dz0 * sc.x;
      dxh1[r] = dz1 * sc.y;
      const float s1 = warp_sum(dxh0[r] + dxh1[r]);
      const float s2 = warp_sum(dxh0[r] * xh0 + dxh1[r] * xh1);
      if (lane == 0) {
        s1_s[warp * TT + r] = s1;
        s2_s[warp * TT + r] = s2;
      }
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < TT; ++r) {
      const int t = t0 + r;
      float m1 = 0.f, m2 = 0.f;
      for (int w = 0; w < nwarps; ++w) {
        m1 += s1_s[w * TT + r];
        m2 += s2_s[w * TT + r];
      }
      m1 /= d;
      m2 /= d;
      if (own && t < T)
        reinterpret_cast<float2*>(dx + ((size_t)t * B + b) * d)[c] =
            make_float2(rstd[r] * (dxh0[r] - m1 - acc0[r] * m2),
                        rstd[r] * (dxh1[r] - m1 - acc1[r] * m2));
    }
  }
  if (own) {
    float* row = part + ((size_t)b * gridDim.x + blockIdx.x) * (k + 4) * d + (size_t)k * d;
    reinterpret_cast<float2*>(row)[c] = make_float2(dsc0, dsc1);
    reinterpret_cast<float2*>(row + d)[c] = make_float2(dbi0, dbi1);
  }
}

// Backward launch 2: the conv's transpose and ddw, the mask and the GLU
// backward -> du [T, B, 2d] bf16; the chunk's ddw sums (columns [0, k * d))
// and db_in sums (columns (k + 2) * d ..) into its partial row.  A thread
// reads and writes only its own channels, so the stage needs no barrier.
__global__ void conv_bwd_in_kernel(const __nv_bfloat16* __restrict__ u,
                                   const __nv_bfloat16* __restrict__ b_in,
                                   const float* __restrict__ dw,
                                   const int* __restrict__ lengths,
                                   const float* __restrict__ dx,      // [T, B, d]
                                   __nv_bfloat16* __restrict__ du,    // [T, B, 2d]
                                   float* __restrict__ part,          // [B * chunks][(k + 4) * d]
                                   int T, int B, int d, int k) {
  extern __shared__ __align__(16) float smem[];
  const int rows = TT + k - 1, half = k / 2;
  float* dx_s = smem;                                                       // [rows][d]
  __nv_bfloat162* y_s = reinterpret_cast<__nv_bfloat162*>(dx_s + (size_t)rows * d);  // [rows][d/2]
  const int b = blockIdx.y, c0 = blockIdx.x * CH, len = lengths[b];
  const int c = threadIdx.x;
  if (2 * c >= d) return;
  const int dp = d / 2;
  const __nv_bfloat162 ba = reinterpret_cast<const __nv_bfloat162*>(b_in)[c];
  const __nv_bfloat162 bg = reinterpret_cast<const __nv_bfloat162*>(b_in + d)[c];
  float* row = part + ((size_t)b * gridDim.x + blockIdx.x) * (k + 4) * d;
  float2* ddw_part = reinterpret_cast<float2*>(row);
  float dba0 = 0.f, dba1 = 0.f, dbg0 = 0.f, dbg1 = 0.f;
  const int c_end = min(c0 + CH, T);
  for (int t0 = c0; t0 < c_end; t0 += TT) {
    for (int r = 0; r < rows; ++r) {
      const int t = t0 - half + r;
      const float2 y = glu_row(u, ba, bg, t, T, B, b, d, c, len);
      y_s[(size_t)r * dp + c] = __floats2bfloat162_rn(y.x, y.y);  // exact: y is a bf16
      float2 g = make_float2(0.f, 0.f);
      if (t >= 0 && t < T) g = reinterpret_cast<const float2*>(dx + ((size_t)t * B + b) * d)[c];
      reinterpret_cast<float2*>(dx_s + (size_t)r * d)[c] = g;
    }
    // the transposed conv: dy[r] = sum_j dx[r + k - 1 - j] * dw[j]
    float dy0[TT], dy1[TT];
#pragma unroll
    for (int r = 0; r < TT; ++r) dy0[r] = dy1[r] = 0.f;
    for (int j = 0; j < k; ++j) {
      const float2 w = reinterpret_cast<const float2*>(dw + (size_t)j * d)[c];
      float s0 = 0.f, s1 = 0.f;
#pragma unroll
      for (int r = 0; r < TT; ++r) {
        const float2 g = reinterpret_cast<const float2*>(dx_s + (size_t)(r + k - 1 - j) * d)[c];
        dy0[r] = fmaf(g.x, w.x, dy0[r]);
        dy1[r] = fmaf(g.y, w.y, dy1[r]);
        // ddw[j] += y[t + j - k/2] * dx[t]; rows past T hold dx = 0
        const float2 y = __bfloat1622float2(y_s[(size_t)(r + j) * dp + c]);
        const float2 gc = reinterpret_cast<const float2*>(dx_s + (size_t)(r + half) * d)[c];
        s0 = fmaf(y.x, gc.x, s0);
        s1 = fmaf(y.y, gc.y, s1);
      }
      const float2 prev = t0 == c0 ? make_float2(0.f, 0.f) : ddw_part[(size_t)j * dp + c];
      ddw_part[(size_t)j * dp + c] = make_float2(prev.x + s0, prev.y + s1);
    }
    // the mask and the GLU backward, with the reference's bf16 roundings
#pragma unroll
    for (int r = 0; r < TT; ++r) {
      const int t = t0 + r;
      if (t >= T) break;
      const float m = t < len ? 1.f : 0.f;
      const float e0 = bf_round(dy0[r]) * m, e1 = bf_round(dy1[r]) * m;
      const __nv_bfloat16* urow = u + ((size_t)t * B + b) * 2 * d;
      const __nv_bfloat162 a = reinterpret_cast<const __nv_bfloat162*>(urow)[c];
      const __nv_bfloat162 g = reinterpret_cast<const __nv_bfloat162*>(urow + d)[c];
      const float a0 = bf_round(__low2float(a) + __low2float(ba));
      const float a1 = bf_round(__high2float(a) + __high2float(ba));
      const float g0 = bf_round(__low2float(g) + __low2float(bg));
      const float g1 = bf_round(__high2float(g) + __high2float(bg));
      const float sg0 = bf_round(sigmoid(g0)), sg1 = bf_round(sigmoid(g1));
      const float da0 = bf_round(e0 * sg0), da1 = bf_round(e1 * sg1);
      const float ds0 = bf_round(e0 * a0), ds1 = bf_round(e1 * a1);
      const float dg0 = bf_round(ds0 * bf_round(sg0 * bf_round(sigmoid(-g0))));
      const float dg1 = bf_round(ds1 * bf_round(sg1 * bf_round(sigmoid(-g1))));
      __nv_bfloat16* drow = du + ((size_t)t * B + b) * 2 * d;
      reinterpret_cast<__nv_bfloat162*>(drow)[c] = __floats2bfloat162_rn(da0, da1);
      reinterpret_cast<__nv_bfloat162*>(drow + d)[c] = __floats2bfloat162_rn(dg0, dg1);
      dba0 += da0;
      dba1 += da1;
      dbg0 += dg0;
      dbg1 += dg1;
    }
  }
  float* db_row = row + (size_t)(k + 2) * d;
  reinterpret_cast<float2*>(db_row)[c] = make_float2(dba0, dba1);
  reinterpret_cast<float2*>(db_row + d)[c] = make_float2(dbg0, dbg1);
}

// Backward launch 3: out[i] = sum over the n_part partial rows of part[p][i],
// lanes p = y, y + 8, ... first, then the 8 lanes in order; columns from
// `round_from` on (db_in) rounded to bf16.
__global__ void reduce_parts_kernel(const float* __restrict__ part, float* __restrict__ out,
                                    int n_part, int n, int round_from) {
  __shared__ float lanes[8][32];
  const int i = blockIdx.x * 32 + threadIdx.x;
  float acc = 0.f;
  if (i < n)
    for (int p = threadIdx.y; p < n_part; p += 8) acc += part[(size_t)p * n + i];
  lanes[threadIdx.y][threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.y == 0 && i < n) {
    float s = 0.f;
    for (int w = 0; w < 8; ++w) s += lanes[w][threadIdx.x];
    out[i] = i >= round_from ? bf_round(s) : s;
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

bool bad_shape(int T, int B, int d, int k) {
  return d % 2 || d < 2 || d > 1024 || k < 1 || k % 2 == 0 || T < 1 || B < 1;
}

}  // namespace

// Shared-memory bytes the largest launch asks for (the wrapper checks the limit).
extern "C" long long avsr_conformer_conv_smem(int d, int k) {
  size_t m = conv_smem(d, k);
  if (bwd_ln_smem(d, k) > m) m = bwd_ln_smem(d, k);
  if (bwd_in_smem(d, k) > m) m = bwd_in_smem(d, k);
  return (long long)m;
}

// Rows of the backward's partial sums: B * ceil(T / CH), each (k + 4) * d floats.
extern "C" int avsr_conformer_conv_bwd_parts(int T, int B) { return B * ((T + CH - 1) / CH); }

extern "C" int avsr_conformer_conv(const void* u, const void* b_in, const void* dw,
                                   const void* ln_scale, const void* ln_bias,
                                   const void* lengths, void* out, int T, int B, int d, int k,
                                   void* stream) {
  if (bad_shape(T, B, d, k)) return (int)cudaErrorInvalidValue;
  const size_t smem = conv_smem(d, k);
  const cudaError_t e = allow_smem(conformer_conv_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((T + TT - 1) / TT, B);
  conformer_conv_kernel<<<grid, block_threads(d), smem, reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(u), static_cast<const __nv_bfloat16*>(b_in),
      static_cast<const float*>(dw), static_cast<const float*>(ln_scale),
      static_cast<const float*>(ln_bias), static_cast<const int*>(lengths),
      static_cast<__nv_bfloat16*>(out), T, B, d, k);
  return (int)cudaGetLastError();
}

// dout [T, B, d] bf16 -> du [T, B, 2d] bf16 and grads [(k + 4) * d] fp32:
// ddw [k, d], dln_scale [d], dln_bias [d], db_in [2d] (bf16 values).  dx
// [T, B, d] fp32 and part [B * ceil(T / CH), (k + 4) * d] fp32 are scratch.
extern "C" int avsr_conformer_conv_bwd(const void* u, const void* b_in, const void* dw,
                                       const void* ln_scale, const void* ln_bias,
                                       const void* lengths, const void* dout, void* dx,
                                       void* part, void* du, void* grads, int T, int B, int d,
                                       int k, void* stream) {
  if (bad_shape(T, B, d, k)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const size_t smem_ln = bwd_ln_smem(d, k), smem_in = bwd_in_smem(d, k);
  cudaError_t e = allow_smem(conv_bwd_ln_kernel, smem_ln);
  if (e != cudaSuccess) return (int)e;
  e = allow_smem(conv_bwd_in_kernel, smem_in);
  if (e != cudaSuccess) return (int)e;
  const __nv_bfloat16* ub = static_cast<const __nv_bfloat16*>(u);
  const __nv_bfloat16* bb = static_cast<const __nv_bfloat16*>(b_in);
  const float* w = static_cast<const float*>(dw);
  const int* lens = static_cast<const int*>(lengths);
  float* dxf = static_cast<float*>(dx);
  float* pf = static_cast<float*>(part);
  const dim3 grid((T + CH - 1) / CH, B);
  conv_bwd_ln_kernel<<<grid, block_threads(d), smem_ln, st>>>(
      ub, bb, w, static_cast<const float*>(ln_scale), static_cast<const float*>(ln_bias), lens,
      static_cast<const __nv_bfloat16*>(dout), dxf, pf, T, B, d, k);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  conv_bwd_in_kernel<<<grid, block_threads(d), smem_in, st>>>(
      ub, bb, w, lens, dxf, static_cast<__nv_bfloat16*>(du), pf, T, B, d, k);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int n = (k + 4) * d;
  reduce_parts_kernel<<<(n + 31) / 32, dim3(32, 8), 0, st>>>(
      pf, static_cast<float*>(grads), B * (int)grid.x, n, (k + 2) * d);
  return (int)cudaGetLastError();
}

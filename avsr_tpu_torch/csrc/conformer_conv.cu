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
// MB) and writes du (51.6 MB): ~129 MB, ~39 us, also byte-bound.
//
// Forward, "fused" (k = 15, d a multiple of 8 up to 512: every preset's
// conformer conv; kernels.conformer_fwd_plan): the fused backward's
// skeleton.  One pass over time per item (utterance b, chunk [c0, c1) of
// its steps, chunks cut so that a small batch fills a wave of two blocks an
// SM); a thread owns one channel (512 threads at d = 512).  Tiles of BR = 8
// rows in two stages that lag by k / 2 + 2 rows: A computes each row's GLU
// once (biased, masked, exactly bf16) into a window of y's last 24 rows in
// the thread's registers; B runs the k-tap conv of its 8 rows over the
// window (own channel: no barrier, no shared memory),
// the LayerNorm statistics (two row reductions: per warp by halving
// exchanges, then the warps' partials by a 16-lane tree, the same bits in
// every thread), the swish, and writes out once.  u's rows (2 KB at d =
// 512) arrive by bulk copies issued by one thread two tiles ahead, counted
// on three mbarriers.  u is read once, plus 14 rows at each chunk edge.
// The GLU (glu_channel) and the conv with its statistics (conv_ln_tile)
// are the fused backward's own functions, so the backward's stage B
// recomputes z with the forward's bits.  The sigmoids are sigmoid_fast
// (ex2.approx and rcp.approx, no div.rn slow path).
//
// Forward, "tiles" (every other shape the wrapper takes): one block per
// (utterance, tile of TT = 16 time steps); a thread owns one channel pair.
// The tile's GLU'd rows plus the k - 1 halo rows are staged in shared
// memory as fp32 ([TT + k - 1][d]); each thread then runs the k-tap conv of
// its own two channels for the TT rows in registers.  The LayerNorm
// reduces over the d channels of each row with warp shuffles and one shared
// partial per warp, summed in a fixed order, mean first, then the centred
// squares, as the reference does.  The halo rows are read by two
// neighbouring blocks (k - 1 = 14 extra rows per 16: up to 1.9x u's bytes).
//
// Backward, "fused" (k = 15, d a multiple of 8 up to 512: every preset's
// conformer conv; kernels.conformer_bwd_plan): one pass over time per item
// (utterance b, chunk [c0, c1) of its steps), then one launch that sums the
// items' partial rows.  A thread owns one channel (512 threads at d = 512:
// one block of 16 warps an SM).  The pass walks tiles of BR = 8 rows in
// three stages that lag each other by k / 2 = 7 rows, so each stage finds
// in shared memory the rows it needs, computed by the same thread (its own
// channel: no barrier):
//   A  rows t + 14: the GLU of u (biased, masked; exactly bf16; the
//      forward's glu_channel) into a ring of the last 22 rows of y, and
//      bf16(sigmoid(gate)) into a ring of its own for stage C;
//   B  rows t + 7: the conv over y's ring and the LayerNorm statistics (the
//      forward's conv_ln_tile: the same z), the swish and LayerNorm backward
//      (four row reductions: per warp by halving exchanges, 9 shuffles for
//      the tile's 8 rows, then the warps' partials by a 16-lane tree, the
//      same bits in every thread) -> dx into a ring of its last 22 rows
//      (fp32, never in device memory); dln_scale, dln_bias and ddw (y's
//      ring against dx) summed in registers over the rows the item owns;
//   C  rows t: the conv's transpose over dx's ring, the mask and the GLU
//      backward with u's row (still in its ring) -> du, written once;
//      db_in summed in registers.
// u's rows (2 KB at d = 512) and dout's (1 KB) arrive by bulk copies (one
// per row: an utterance's rows are B rows apart) issued by one thread two
// tiles ahead, into a ring of 38 u rows (each used by stages A and C) and
// three tiles of dout rows, counted on three mbarriers: 48 KB in flight.
// u and dout are read once, plus 28 rows of u and 14 of dout at each chunk
// edge inside an utterance.  The chunk is the whole utterance where the
// batch fills a wave (B > 66); smaller batches cut it into as many chunks
// as make a wave of 132 items, of at least 16 steps each.  An item's sums
// go to its partial row (ddw, dln, db_in: (k + 4) d floats, 4.9 MB at B =
// 128), which the second launch sums over the items in a fixed order.
// It is bound by instructions, not bytes (~0.40 ms against a 0.039 ms byte
// bound at the phase check's batch): the four row reductions, two sigmoids
// and three divisions a row-channel of stage B take most of it.
//
// Backward, "general" (every other (T, B, d, k) the forward takes), three
// launches, one block per (utterance, chunk of CH = 64 steps) for the first
// two:
//   1. per tile of the chunk: the forward's recompute (the same code, so the
//      same z), the swish and LayerNorm backward (two more row reductions),
//      dx written in fp32 to device memory; dln_scale / dln_bias summed over
//      the chunk in registers;
//   2. per tile of the chunk: y and dx staged with their k - 1 halo (y as
//      bf16, which it is exactly; 92 KB at d = 512), the transposed conv,
//      the ddw sums (added into the block's own partial row), the mask and
//      the GLU backward into du; db_in summed over the chunk;
//   3. every partial summed over the blocks in a fixed order (8 lanes, then
//      the lanes in order): no atomics, the same bits every run.
// The fused route's second launch is the same reduction.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "cluster_ptx.cuh"

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
// Bounded for 512 threads (d = 1024): unbounded, it took 155 registers a
// thread and a block of 512 could not launch.
__global__ void __launch_bounds__(512) conv_bwd_ln_kernel(const __nv_bfloat16* __restrict__ u,
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

// ---- the fused backward -------------------------------------------------------

constexpr int BK = 15;                  // taps of the fused backward
constexpr int BH = BK / 2;              // the stages' lag in rows
constexpr int BR = 8;                   // rows a tile
constexpr int DEPTH = 2;                // tiles of rows in flight ahead of the one in use
constexpr int NBUF = DEPTH + 1;         // dout buffers and mbarriers
constexpr int RU = 2 * BH + NBUF * BR;  // rows of u's ring
constexpr int RW = 2 * BH + BR;         // rows of y's and dx's rings
constexpr int PRO = (4 * BH + BR - 1) / BR;  // tiles before the first of stage C
constexpr int FUSED_MAX_D = 512;        // a thread a channel
constexpr int FUSED_WARPS = FUSED_MAX_D / 32;

// Shared memory of the fused backward at d channels, byte offsets: u's ring
// [RU][2d] bf16, dout's buffers [NBUF][BR][d] bf16, y's and bf16(sigmoid(
// gate))'s rings [RW][d] bf16, dx's ring [RW][d] fp32, the four row
// reductions' per-warp partials [16 warps][BR] fp32 (mean, centred squares,
// dxh, dxh * xh), the mbarriers.
struct FusedLayout {
  size_t dout, y, sg, dx, red, bars, total;
  __host__ __device__ explicit FusedLayout(int d) {
    dout = (size_t)RU * 2 * d * 2;
    y = dout + (size_t)NBUF * BR * d * 2;
    sg = y + (size_t)RW * d * 2;
    dx = sg + (size_t)RW * d * 2;
    red = dx + (size_t)RW * d * 4;
    bars = red + (size_t)4 * FUSED_WARPS * BR * 4;
    total = bars + (size_t)NBUF * 8;
  }
};

bool fused_shape(int d, int k) { return k == BK && d % 8 == 0 && d >= 8 && d <= FUSED_MAX_D; }

__device__ __forceinline__ int ring(int t, int n) { return ((t % n) + n) % n; }
// s mod n for 0 <= s < 2n
__device__ __forceinline__ int wrap(int s, int n) { return s >= n ? s - n : s; }

// The warp's sums of a tile's BR = 8 rows, v[r] this lane's value of row r,
// by halving exchanges: at lane bits 4, 3 and 2 each lane keeps half of its
// rows and adds its partner's half (4 + 2 + 1 shuffles), then a plain tree
// over lane bits 1 and 0: 9 shuffles where a tree a row takes 40.  Returns
// the warp's sum of row (lane >> 2) & 7, the same bits on every run.
__device__ __forceinline__ float warp_rows_sum(const float (&v)[BR]) {
  const int lane = threadIdx.x & 31;
  float a[4], b[2];
  const bool h4 = lane & 16, h3 = lane & 8, h2 = lane & 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    a[i] = (h4 ? v[i + 4] : v[i]) + __shfl_xor_sync(0xffffffffu, h4 ? v[i] : v[i + 4], 16);
#pragma unroll
  for (int i = 0; i < 2; ++i)
    b[i] = (h3 ? a[i + 2] : a[i]) + __shfl_xor_sync(0xffffffffu, h3 ? a[i] : a[i + 2], 8);
  float c = (h2 ? b[1] : b[0]) + __shfl_xor_sync(0xffffffffu, h2 ? b[0] : b[1], 4);
  c += __shfl_xor_sync(0xffffffffu, c, 2);
  c += __shfl_xor_sync(0xffffffffu, c, 1);
  return c;
}

// This warp's row sums into the partials red[warp][BR] (one lane a row).
__device__ __forceinline__ void put_rows(float* red, const float (&v)[BR]) {
  const float s = warp_rows_sum(v);
  const int lane = threadIdx.x & 31;
  if ((lane & 3) == 0) red[(threadIdx.x / 32) * BR + (lane >> 2)] = s;
}

// The block's row sums from the warps' partials red[w][BR] (nwarps <= 16),
// in every thread: lanes 0-15 read warp l's partial of row r, lanes 16-31
// of row r + 4, a 4-level tree over each 16 lanes, then the two broadcast.
// One order for every thread: the same bits in all of them.
__device__ __forceinline__ void rows_total(const float* red, int nwarps, float (&tot)[BR]) {
  const int lane = threadIdx.x & 31, wl = lane & 15, hi = lane >> 4;
#pragma unroll
  for (int r = 0; r < BR / 2; ++r) {
    float v = wl < nwarps ? red[wl * BR + r + 4 * hi] : 0.f;
#pragma unroll
    for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    tot[r] = __shfl_sync(0xffffffffu, v, 0);
    tot[r + BR / 2] = __shfl_sync(0xffffffffu, v, 16);
  }
}

// sigmoid(x) = 1 / (1 + e^-x) from one ex2.approx and one rcp.approx, both
// flushing subnormals (a few ulps; 0 where e^-x overflows): no div.rn slow
// path and none of __expf's subnormal scaling
__device__ __forceinline__ float sigmoid_fast(float x) {
  float e, r;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(e) : "f"(x * -1.4426950408889634f));
  asm("rcp.approx.ftz.f32 %0, %1;\n" : "=f"(r) : "f"(1.f + e));
  return r;
}

// One channel of a row's biased GLU from u's two halves ua, ug (bf16
// values) and the bias ba, bg: a = bf16(ua + ba), g = bf16(ug + bg), *sg =
// bf16(sigmoid(g)) and the unmasked y = bf16(a * sg).  The fused forward
// and the fused backward's stage A both run it: the same y.
__device__ __forceinline__ float glu_channel(float ua, float ug, float ba, float bg, float* sg) {
  const float a = bf_round(ua + ba), g = bf_round(ug + bg);
  *sg = bf_round(sigmoid_fast(g));
  return bf_round(a * *sg);
}

// The conv of this thread's channel over a tile's BR rows from yw, y's rows
// t - k/2 .. t + BR - 1 + k/2 (the forward's taps and sum order), the rows'
// LayerNorm statistics over the block's channels (the mean, then the
// centred squares; two row reductions, each ending at a block barrier,
// over the per-warp partials red1 / red2; the means as products with inv_d
// = 1 / d), and for each row xh = (x - mu) rstd and z = xh scale + bias.
// The fused forward and the fused backward's stage B both run it, so z has
// the same bits in both.
__device__ __forceinline__ void conv_ln_tile(const float (&yw)[RW], const float (&w)[BK], bool own,
                                             int nwarps, float inv_d, float sc, float bi,
                                             float* red1, float* red2, float (&xh)[BR],
                                             float (&z)[BR], float (&rstd)[BR]) {
  float x[BR], mu[BR], t1[BR];
#pragma unroll
  for (int r = 0; r < BR; ++r) {
    x[r] = 0.f;
#pragma unroll
    for (int j = 0; j < BK; ++j) x[r] = fmaf(yw[r + j], w[j], x[r]);
  }
  put_rows(red1, x);
  __syncthreads();
  rows_total(red1, nwarps, mu);
#pragma unroll
  for (int r = 0; r < BR; ++r) {
    mu[r] = __fmul_rn(mu[r], inv_d);
    const float e = __fsub_rn(x[r], mu[r]);
    t1[r] = own ? __fmul_rn(e, e) : 0.f;
  }
  put_rows(red2, t1);
  __syncthreads();
  rows_total(red2, nwarps, t1);
#pragma unroll
  for (int r = 0; r < BR; ++r) {
    rstd[r] = rsqrtf(__fmaf_rn(t1[r], inv_d, 1e-6f));
    xh[r] = __fmul_rn(__fsub_rn(x[r], mu[r]), rstd[r]);
    z[r] = __fmaf_rn(xh[r], sc, bi);
  }
}

// Item blockIdx.x = b * nc + chunk: the steps [c0, c1), c0 = chunk * CH
// (the chunks: kernels.conformer_bwd_plan); thread c owns channel c (and
// channel d + c of u and du).  Partial row of the item: ddw [k][d],
// dln_scale [d], dln_bias [d], db_in [2d] (fp32 sums over the rows it owns).
__global__ void __launch_bounds__(FUSED_MAX_D, 1)
conv_bwd_fused_kernel(const __nv_bfloat16* __restrict__ u,       // [T, B, 2d]
                      const __nv_bfloat16* __restrict__ b_in,    // [2d]
                      const float* __restrict__ dw,              // [k, d]
                      const float* __restrict__ ln_scale,        // [d]
                      const float* __restrict__ ln_bias,         // [d]
                      const int* __restrict__ lengths,           // [B]
                      const __nv_bfloat16* __restrict__ dout,    // [T, B, d]
                      float* __restrict__ part,                  // [B * nc][(k + 4) d]
                      __nv_bfloat16* __restrict__ du,            // [T, B, 2d]
                      float* __restrict__ z_out,                 // [T, B, d] or null
                      int T, int B, int d, int CH, int nc) {
  extern __shared__ __align__(128) unsigned char fsm[];  // FusedLayout
  const FusedLayout lay(d);
  const int b = blockIdx.x / nc, c0 = (blockIdx.x % nc) * CH, c1 = min(c0 + CH, T);
  const int len = lengths[b];
  const int c = threadIdx.x, nwarps = blockDim.x / 32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const bool own = c < d;
  const __nv_bfloat16* u_s = reinterpret_cast<const __nv_bfloat16*>(fsm);     // [RU][2d]
  const __nv_bfloat16* do_s = reinterpret_cast<const __nv_bfloat16*>(fsm + lay.dout);
  __nv_bfloat16* y_s = reinterpret_cast<__nv_bfloat16*>(fsm + lay.y);        // [RW][d]
  __nv_bfloat16* sg_s = reinterpret_cast<__nv_bfloat16*>(fsm + lay.sg);      // [RW][d]
  float* dx_s = reinterpret_cast<float*>(fsm + lay.dx);                      // [RW][d]
  float* red1 = reinterpret_cast<float*>(fsm + lay.red);                     // [4][16][BR]
  float* red2 = red1 + FUSED_WARPS * BR;
  float* red3 = red2 + FUSED_WARPS * BR;
  float* red4 = red3 + FUSED_WARPS * BR;
  uint64_t* full = reinterpret_cast<uint64_t*>(fsm + lay.bars);              // [NBUF]
  const int ntiles = PRO + (c1 - c0 + BR - 1) / BR;
  // the rows each stage computes: A (y) [a_lo, a_hi), B (dx) [b_lo, b_hi),
  // C (du) [c0, c1); the rows of u and dout copied are those inside [0, T)
  const int a_lo = c0 - 2 * BH, a_hi = c1 + 2 * BH, b_lo = c0 - BH, b_hi = c1 + BH;

  // tile n's rows: C from c0 + (n - PRO) BR, B 7 rows later, A 14; its u
  // rows (A's) into u's ring and its dout rows (B's) into buffer n % NBUF
  auto issue = [&](int n) {
    const int C0 = c0 + (n - PRO) * BR;
    const uint32_t bar = cluster_ptx::smem_addr(&full[n % NBUF]);
    uint32_t bytes = 0;
    for (int r = 0; r < BR; ++r) {
      const int ta = C0 + 2 * BH + r, tb = C0 + BH + r;
      if (ta >= max(a_lo, 0) && ta < min(a_hi, T)) bytes += 4 * d;
      if (tb >= max(b_lo, 0) && tb < min(b_hi, T)) bytes += 2 * d;
    }
    cluster_ptx::mbar_expect(&full[n % NBUF], bytes);
    for (int r = 0; r < BR; ++r) {
      const int ta = C0 + 2 * BH + r, tb = C0 + BH + r;
      if (ta >= max(a_lo, 0) && ta < min(a_hi, T))
        cluster_ptx::bulk_g2s(cluster_ptx::smem_addr(u_s + (size_t)ring(ta, RU) * 2 * d),
                              u + ((size_t)ta * B + b) * 2 * d, 4 * d, bar);
      if (tb >= max(b_lo, 0) && tb < min(b_hi, T))
        cluster_ptx::bulk_g2s(cluster_ptx::smem_addr(do_s + ((size_t)(n % NBUF) * BR + r) * d),
                              dout + ((size_t)tb * B + b) * d, 2 * d, bar);
    }
  };
  if (threadIdx.x == 0) {
    for (int i = 0; i < NBUF; ++i) cluster_ptx::mbar_init(&full[i], 1);
    cluster_ptx::fence_mbar_init();
    for (int n = 0; n < DEPTH && n < ntiles; ++n) issue(n);
  }

  // this thread's channel of the operands, and its sums
  float ba = 0.f, bg = 0.f, sc = 0.f, bi = 0.f, w[BK], ddw[BK];
#pragma unroll
  for (int j = 0; j < BK; ++j) w[j] = ddw[j] = 0.f;
  if (own) {
    ba = __bfloat162float(b_in[c]);
    bg = __bfloat162float(b_in[d + c]);
    sc = ln_scale[c];
    bi = ln_bias[c];
#pragma unroll
    for (int j = 0; j < BK; ++j) w[j] = dw[(size_t)j * d + c];
  }
  float dsc = 0.f, dbi = 0.f, dba = 0.f, dbg = 0.f;
  const float inv_d = 1.f / d;

  for (int n = 0; n < ntiles; ++n) {
    const int C0 = c0 + (n - PRO) * BR, B0 = C0 + BH, A0 = C0 + 2 * BH;
    // ring slots of rows C0 (u's and y's rings) and C0 - BH (dx's)
    const int su = ring(C0, RU), sy = ring(C0, RW), sx = ring(C0 - BH, RW);
    // every thread is past tile n - 1: its u rows (stage C) and dout
    // buffer (stage B) may be overwritten by tile n + DEPTH's copies
    __syncthreads();
    if (threadIdx.x == 0 && n + DEPTH < ntiles) issue(n + DEPTH);
    cluster_ptx::mbar_wait(&full[n % NBUF], (n / NBUF) & 1);

    // A: y of rows A0 .. A0 + BR - 1 (zero outside [0, T))
    if (own) {
#pragma unroll
      for (int r = 0; r < BR; ++r) {
        const int t = A0 + r;
        if (t < a_lo || t >= a_hi) continue;
        float y = 0.f, sg = 0.f;
        if (t >= 0 && t < T) {
          const __nv_bfloat16* row = u_s + (size_t)wrap(su + 2 * BH + r, RU) * 2 * d;
          y = glu_channel(__bfloat162float(row[c]), __bfloat162float(row[d + c]), ba, bg, &sg) *
              (t < len ? 1.f : 0.f);
        }
        const size_t slot = (size_t)wrap(sy + 2 * BH + r, RW) * d + c;
        y_s[slot] = __float2bfloat16(y);    // exact
        sg_s[slot] = __float2bfloat16(sg);  // exact, for stage C
      }
    }

    // B: dx of rows B0 .. B0 + BR - 1, from y's rows C0 .. C0 + RW - 1
    if (B0 + BR > b_lo && B0 < b_hi) {
      float yw[RW];
#pragma unroll
      for (int i = 0; i < RW; ++i)
        yw[i] = own ? __bfloat162float(y_s[(size_t)wrap(sy + i, RW) * d + c]) : 0.f;
      float x[BR], zr[BR], rstd[BR], t1[BR], t2[BR];
      conv_ln_tile(yw, w, own, nwarps, inv_d, sc, bi, red1, red2, x, zr, rstd);  // x: xh
      const __nv_bfloat16* dob = do_s + (size_t)(n % NBUF) * BR * d;
      float dxh[BR];
#pragma unroll
      for (int r = 0; r < BR; ++r) {
        const int t = B0 + r;
        const float xh = x[r], z = zr[r];
        const float g = own && t >= 0 && t < T ? __bfloat162float(dob[(size_t)r * d + c]) : 0.f;
        const float sp = sigmoid(z);
        const float dz = g * sp + (z * g) * (sp * sigmoid(-z));
        if (t >= c0 && t < c1) {
          dsc = fmaf(dz, xh, dsc);
          dbi += dz;
          if (z_out != nullptr && own) z_out[((size_t)t * B + b) * d + c] = z;
        }
        dxh[r] = dz * sc;
        t2[r] = dxh[r] * xh;
      }
      put_rows(red3, dxh);
      put_rows(red4, t2);
      __syncthreads();
      rows_total(red3, nwarps, t1);
      rows_total(red4, nwarps, t2);
#pragma unroll
      for (int r = 0; r < BR; ++r) {
        const int t = B0 + r;
        const float m1 = t1[r] / d, m2 = t2[r] / d;
        // rows outside [0, T) hold dx = 0
        const float g = t >= 0 && t < T ? rstd[r] * (dxh[r] - m1 - x[r] * m2) : 0.f;
        if (own && t >= b_lo && t < b_hi) dx_s[(size_t)wrap(sx + 2 * BH + r, RW) * d + c] = g;
        // ddw[j] += y[t + j - k/2] * dx[t] over the rows the item owns
        if (t >= c0 && t < c1) {
#pragma unroll
          for (int j = 0; j < BK; ++j) ddw[j] = fmaf(yw[r + j], g, ddw[j]);
        }
      }
    }

    // C: du of rows C0 .. C0 + BR - 1 in [c0, c1), from dx's rows C0 - 7 ..
    if (own && C0 + BR > c0 && C0 < c1) {
      float xw[RW];
#pragma unroll
      for (int i = 0; i < RW; ++i) xw[i] = dx_s[(size_t)wrap(sx + i, RW) * d + c];
#pragma unroll
      for (int r = 0; r < BR; ++r) {
        const int t = C0 + r;
        if (t < c0 || t >= c1) continue;
        // the transposed conv: dy[t] = sum_j dx[t - j + k/2] * dw[j]
        float dy = 0.f;
#pragma unroll
        for (int j = 0; j < BK; ++j) dy = fmaf(xw[r + 2 * BH - j], w[j], dy);
        // the mask and the GLU backward, with the reference's bf16 roundings
        const float e = bf_round(dy) * (t < len ? 1.f : 0.f);
        const __nv_bfloat16* row = u_s + (size_t)wrap(su + r, RU) * 2 * d;
        const float a = bf_round(__bfloat162float(row[c]) + ba);
        const float g = bf_round(__bfloat162float(row[d + c]) + bg);
        const float sg = __bfloat162float(sg_s[(size_t)wrap(sy + r, RW) * d + c]);
        const float da = bf_round(e * sg);
        const float dg = bf_round(bf_round(e * a) * bf_round(sg * bf_round(sigmoid(-g))));
        __nv_bfloat16* drow = du + ((size_t)t * B + b) * 2 * d;
        drow[c] = __float2bfloat16(da);
        drow[d + c] = __float2bfloat16(dg);
        dba += da;
        dbg += dg;
      }
    }
  }

  if (own) {
    float* row = part + (size_t)blockIdx.x * (BK + 4) * d;
#pragma unroll
    for (int j = 0; j < BK; ++j) row[(size_t)j * d + c] = ddw[j];
    row[(size_t)BK * d + c] = dsc;
    row[(size_t)(BK + 1) * d + c] = dbi;
    row[(size_t)(BK + 2) * d + c] = dba;
    row[(size_t)(BK + 3) * d + c] = dbg;
  }
}

// ---- the fused forward ------------------------------------------------------

constexpr int FPRO = 2;      // tiles of stage A alone before the first of stage B
constexpr int FWD_CTAS = 2;  // blocks of the fused forward an SM (kernels.CONV_FWD_CTAS_PER_SM)

// Shared memory of the fused forward at d channels, byte offsets: u's tiles
// [NBUF][BR][2d] bf16 (the one in use and DEPTH ahead), the two row
// reductions' per-warp partials [16 warps][BR] fp32, the tiles' mbarriers.
// (y's window lives in each thread's registers: its own channel.)
struct FwdLayout {
  size_t red, bars, total;
  __host__ __device__ explicit FwdLayout(int d) {
    red = (size_t)NBUF * BR * 2 * d * 2;
    bars = red + (size_t)2 * FUSED_WARPS * BR * 4;
    total = bars + (size_t)NBUF * 8;
  }
};

// Item blockIdx.x = b * nc + chunk: the steps [c0, c1), c0 = chunk * CH
// (kernels.conformer_fwd_plan); thread c owns channel c.  Z: also write
// LayerNorm's output z_out (the checks' instance).  Tile n: stage A,
// y of rows c0 - 9 + 8 n .. c0 - 2 + 8 n (those of [c0 - k/2, c1 + k/2)
// inside [0, T) from u, every other row 0, computed without a branch so
// the rows' chains overlap); stage B from tile FPRO on, the conv, LayerNorm
// and swish of rows c0 + 8 (n - FPRO) .., written where they lie in [c0,
// c1).  Two blocks an SM (at most 64 registers a thread, 50 KB of shared
// memory at d = 512); the checks' instance one.
template <bool Z>
__global__ void __launch_bounds__(FUSED_MAX_D, Z ? 1 : FWD_CTAS)
conv_fwd_fused_kernel(const __nv_bfloat16* __restrict__ u,       // [T, B, 2d]
                      const __nv_bfloat16* __restrict__ b_in,    // [2d]
                      const float* __restrict__ dw,              // [k, d]
                      const float* __restrict__ ln_scale,        // [d]
                      const float* __restrict__ ln_bias,         // [d]
                      const int* __restrict__ lengths,           // [B]
                      __nv_bfloat16* __restrict__ out,           // [T, B, d]
                      float* __restrict__ z_out,                 // [T, B, d] (Z)
                      int T, int B, int d, int CH, int nc) {
  extern __shared__ __align__(128) unsigned char fsm[];  // FwdLayout
  const FwdLayout lay(d);
  const int b = blockIdx.x / nc, c0 = (blockIdx.x % nc) * CH, c1 = min(c0 + CH, T);
  const int len = lengths[b];
  const int c = threadIdx.x, nwarps = blockDim.x / 32;
  const bool own = c < d;
  const __nv_bfloat16* u_s = reinterpret_cast<const __nv_bfloat16*>(fsm);   // [NBUF][BR][2d]
  float* red1 = reinterpret_cast<float*>(fsm + lay.red);                   // [2][16][BR]
  float* red2 = red1 + FUSED_WARPS * BR;
  uint64_t* full = reinterpret_cast<uint64_t*>(fsm + lay.bars);            // [NBUF]
  const int ntiles = FPRO + (c1 - c0 + BR - 1) / BR;
  // the rows of y the item needs, and those of them that u gives
  const int a_lo = c0 - BH, a_hi = c1 + BH, u_lo = max(a_lo, 0), u_hi = min(a_hi, T);

  // tile n's u rows (stage A's) into buffer n % NBUF, a bulk copy a row
  // issued by lane r of warp 0 (the rows' issues side by side), after lane
  // 0 has announced their bytes
  const int lane = threadIdx.x % 32;
  auto issue = [&](int n) {
    const int A0 = c0 + BH + (n - FPRO) * BR;
    const int r0 = max(A0, u_lo), r1 = min(A0 + BR, u_hi);
    const uint32_t bar = cluster_ptx::smem_addr(&full[n % NBUF]);
    if (lane == 0)
      cluster_ptx::mbar_expect(&full[n % NBUF], (uint32_t)(r1 > r0 ? (r1 - r0) * 4 * d : 0));
    __syncwarp();
    const int t = A0 + lane;
    if (lane < BR && t >= r0 && t < r1)
      cluster_ptx::bulk_g2s(
          cluster_ptx::smem_addr(u_s + ((size_t)(n % NBUF) * BR + lane) * 2 * d),
          u + ((size_t)t * B + b) * 2 * d, 4 * d, bar);
  };
  if (threadIdx.x == 0) {
    for (int i = 0; i < NBUF; ++i) cluster_ptx::mbar_init(&full[i], 1);
    cluster_ptx::fence_mbar_init();
  }
  __syncwarp();
  if (threadIdx.x < 32)
    for (int n = 0; n < DEPTH && n < ntiles; ++n) issue(n);

  // this thread's channel of the operands
  float ba = 0.f, bg = 0.f, sc = 0.f, bi = 0.f, w[BK];
#pragma unroll
  for (int j = 0; j < BK; ++j) w[j] = 0.f;
  if (own) {
    ba = __bfloat162float(b_in[c]);
    bg = __bfloat162float(b_in[d + c]);
    sc = ln_scale[c];
    bi = ln_bias[c];
#pragma unroll
    for (int j = 0; j < BK; ++j) w[j] = dw[(size_t)j * d + c];
  }
  const float inv_d = 1.f / d;
  const int cc = own ? c : 0;  // a thread past d reads channel 0 and keeps nothing
  // y of this thread's channel, the last three tiles of stage A: rows A0 -
  // 2 BR .. A0 + BR - 1 of the current tile (those before the item's first
  // tile never reach stage B)
  float win[3 * BR];
#pragma unroll
  for (int i = 0; i < 3 * BR; ++i) win[i] = 0.f;

  for (int n = 0; n < ntiles; ++n) {
    const int A0 = c0 + BH + (n - FPRO) * BR, B0 = c0 + (n - FPRO) * BR;
    // fwd: tile start
    // every thread is past tile n - 1: its u buffer takes tile n + DEPTH's rows
    __syncthreads();
    if (threadIdx.x < 32 && n + DEPTH < ntiles) issue(n + DEPTH);
    cluster_ptx::mbar_wait(&full[n % NBUF], (n / NBUF) & 1);
    // fwd: u rows in

    // A: y of rows A0 .. A0 + BR - 1 into the window's last tile (this
    // thread's channel, exactly bf16); a row u does not give reads whatever
    // the buffer holds, and keeps 0
    {
#pragma unroll
      for (int i = 0; i < 2 * BR; ++i) win[i] = win[i + BR];
      const __nv_bfloat16* ub = u_s + (size_t)(n % NBUF) * BR * 2 * d + cc;
      // the tile's rows [r_lo, r_hi) that u gives and the mask keeps
      const int r_lo = max(u_lo, A0) - A0, r_hi = min(min(u_hi, len), A0 + BR) - A0;
#pragma unroll
      for (int r = 0; r < BR; ++r) {
        float sg;
        const float y = glu_channel(__bfloat162float(ub[(size_t)r * 2 * d]),
                                    __bfloat162float(ub[(size_t)r * 2 * d + d]), ba, bg, &sg);
        win[2 * BR + r] = own && r >= r_lo && r < r_hi ? y : 0.f;
      }
    }
    // fwd: y formed

    // B: rows B0 .. B0 + BR - 1 from y's rows B0 - k/2 .. B0 + BR - 1 + k/2,
    // the window's rows 2 .. 2 BR + BR - 1 (B0 - k/2 = A0 - 2 BR + 2)
    if (n >= FPRO) {
      float yw[RW];
#pragma unroll
      for (int i = 0; i < RW; ++i) yw[i] = win[i + 3 * BR - RW];
      float xh[BR], z[BR], rstd[BR];
      conv_ln_tile(yw, w, own, nwarps, inv_d, sc, bi, red1, red2, xh, z, rstd);
      // fwd: z formed
      // the tile's rows the item owns, from row B0's element of this thread
      const int nv = own ? min(BR, c1 - B0) : 0;
      const size_t step = (size_t)B * d;
      __nv_bfloat16* op = out + ((size_t)B0 * B + b) * d + cc;
      float* zp = Z ? z_out + ((size_t)B0 * B + b) * d + cc : nullptr;
#pragma unroll
      for (int r = 0; r < BR; ++r) {
        if (r < nv) {
          *op = __float2bfloat16(z[r] * sigmoid_fast(z[r]));  // swish
          if (Z) *zp = z[r];
        }
        op += step;
        if (Z) zp += step;
      }
    }
    // fwd: out written
  }
  // fwd: end
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

// Rows of the general backward's partial sums: B * ceil(T / CH), each (k + 4) * d floats.
extern "C" int avsr_conformer_conv_bwd_parts(int T, int B) { return B * ((T + CH - 1) / CH); }

// Shared-memory bytes of the fused backward at d channels (FusedLayout).
extern "C" long long avsr_conformer_conv_bwd_fused_smem(int d) {
  return (long long)FusedLayout(d).total;
}

// Shared-memory bytes of the fused forward at d channels (FwdLayout).
extern "C" long long avsr_conformer_conv_fwd_fused_smem(int d) {
  return (long long)FwdLayout(d).total;
}

// Blocks of the fused forward that an SM holds at once at d channels (0 on
// an error).
extern "C" int avsr_conformer_conv_fwd_fused_occupancy(int d) {
  const size_t smem = FwdLayout(d).total;
  if (allow_smem(conv_fwd_fused_kernel<false>, smem) != cudaSuccess) return 0;
  int n = 0;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, conv_fwd_fused_kernel<false>,
                                                       (d + 31) / 32 * 32, smem) == cudaSuccess
             ? n
             : 0;
}

// The fused forward (k = 15, d a multiple of 8 up to 512): the items
// (utterance, chunk of CH steps), nc chunks an utterance, nc * CH >= T; out
// [T, B, d] bf16, and where z is not null z [T, B, d] fp32 (LayerNorm's
// output, for the checks).
extern "C" int avsr_conformer_conv_fwd_fused(const void* u, const void* b_in, const void* dw,
                                             const void* ln_scale, const void* ln_bias,
                                             const void* lengths, void* out, void* z, int T,
                                             int B, int d, int k, int CH, int nc, void* stream) {
  if (bad_shape(T, B, d, k) || !fused_shape(d, k) || CH < 1 || nc < 1 || nc * CH < T ||
      (nc - 1) * CH >= T || out == nullptr)
    return (int)cudaErrorInvalidValue;
  const size_t smem = FwdLayout(d).total;
  auto* const kernel =
      z != nullptr ? &conv_fwd_fused_kernel<true> : &conv_fwd_fused_kernel<false>;
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<B * nc, (d + 31) / 32 * 32, smem, reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(u), static_cast<const __nv_bfloat16*>(b_in),
      static_cast<const float*>(dw), static_cast<const float*>(ln_scale),
      static_cast<const float*>(ln_bias), static_cast<const int*>(lengths),
      static_cast<__nv_bfloat16*>(out), static_cast<float*>(z), T, B, d, CH, nc);
  return (int)cudaGetLastError();
}

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

// The fused backward (k = 15, d a multiple of 8 up to 512): the items
// (utterance, chunk of CH steps), nc chunks an utterance, nc * CH >= T; part
// [B * nc, (k + 4) * d] fp32 is scratch; the outputs as the general entry's;
// z [T, B, d] fp32, where not null, takes stage B's recompute of
// LayerNorm's output (for the checks).
extern "C" int avsr_conformer_conv_bwd_fused(const void* u, const void* b_in, const void* dw,
                                             const void* ln_scale, const void* ln_bias,
                                             const void* lengths, const void* dout, void* part,
                                             void* du, void* grads, void* z, int T, int B, int d,
                                             int k, int CH, int nc, void* stream) {
  if (bad_shape(T, B, d, k) || !fused_shape(d, k) || CH < 1 || nc < 1 || nc * CH < T ||
      (nc - 1) * CH >= T)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const size_t smem = FusedLayout(d).total;
  cudaError_t e = allow_smem(conv_bwd_fused_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  float* pf = static_cast<float*>(part);
  conv_bwd_fused_kernel<<<B * nc, (d + 31) / 32 * 32, smem, st>>>(
      static_cast<const __nv_bfloat16*>(u), static_cast<const __nv_bfloat16*>(b_in),
      static_cast<const float*>(dw), static_cast<const float*>(ln_scale),
      static_cast<const float*>(ln_bias), static_cast<const int*>(lengths),
      static_cast<const __nv_bfloat16*>(dout), pf, static_cast<__nv_bfloat16*>(du),
      static_cast<float*>(z), T, B, d, CH, nc);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int n = (k + 4) * d;
  reduce_parts_kernel<<<(n + 31) / 32, dim3(32, 8), 0, st>>>(pf, static_cast<float*>(grads),
                                                            B * nc, n, (k + 2) * d);
  return (int)cudaGetLastError();
}

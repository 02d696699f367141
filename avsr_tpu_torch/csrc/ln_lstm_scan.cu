// K13: direction-batched masked LN-LSTM recurrence, forward and backward.
//
// Forward: replaces the scan body of avsr_tpu/ops/rnn.py:lstm_scan's plain
// lax.scan (rnn.py:535-553) over lstm_step with LayerNorm cells (its LN
// branch, rnn.py:92-136, with _gate_layer_norm, rnn.py:56-64), the
// recurrence of every encoder layer with layer_norm=True.  The reference
// runs the two directions of a bidirectional layer as two scans
// (rnn.py:782-799); here, as in K1, the backward direction's input product
// and mask arrive flipped in time and one scan serves both (G = 2), which is
// the same function.  Per step t, direction g and batch row:
//
//   hp = bf16(h * rd)                        (rd = 1 without recurrent dropout)
//   z  = float(xw[t]) + hp @ bf16(Wh[g])     (fp32 accumulate)
//   gn = each of the 4 gate blocks of z normalised over its H units:
//        (z - mean) / sqrt(var + 1e-5), var the population variance
//   i, f, o = sigmoid, g = tanh of (gn * ln_gamma + b)   (no beta on the gates)
//   c' = f * c + i * g
//   h' = o * tanh(LN(c') * ln_cell_gamma + ln_cell_beta)
//   m = mask[t]:  h <- m ? h' : h;  c <- m ? c' : c;  ys[t] = bf16(h' * m)
//
// In save mode (training) each step also writes what the backward needs:
// hp (bf16, 2H bytes a row-step: the operand, for the caller's dWh), the
// carry c entering the step (fp32, 4H) and z (fp32, 16H).  Keeping z costs
// 16H bytes a row-step (206 MB at [T=197, G=2, B=128, H=256]) and spares the
// backward the recomputation of the recurrent product, BR x H x 4H FMAs a
// block a step; keeping only the per-row statistics (32 bytes a row-step)
// would not spare it, since the gates themselves are needed.
//
// Backward: the reverse scan of JAX's autodiff of that body, with its
// rounding points: the cotangent of the operand hp is rounded to bf16 (the
// transpose of the cast), then scaled by rd; the cotangent of the bf16 xw
// is bf16(dz).  Per step t from T-1 down to 0, with (dh, dc) the cotangents
// of the carries leaving step t:
//
//   recompute gn, the gates, c', LN(c') and its tanh from z[t] and c_res[t]
//   dh' = (dh + dys[t]) * m;  do = dh' * tanh(..);  dcfo = dh' o (1 - tanh^2)
//   dc' = dc * m + LN_back(dcfo * ln_cell_gamma)
//   dpre = [dc' g i(1-i), dc' c f(1-f), dc' i (1-g^2), do o(1-o)]
//   dz = LN_back per gate block of (dpre * ln_gamma);  dxw[t] = bf16(dz)
//   dh <- bf16(dz @ Wh^T) * rd + dh * (1 - m);  dc <- dc' f + dc (1 - m)
//
// with LN_back(dy) = rstd (dy - mean(dy) - x_hat mean(dy x_hat)) over the
// normalised block, and the parameter sums db += dpre, dln_gamma += dpre *
// gn, dln_cell_gamma += dcfo * LN(c'), dln_cell_beta += dcfo over (T, B).
// The recurrent product's cotangent is dz, which is also dxw's, so dWh =
// h_res^T dxw is one product over all steps, left to the caller (as K1's).
//
// What bounds it on an H100: the chain of T dependent steps, each with two
// row-wide reductions inside the recurrence (the gate blocks' and the
// cell's LayerNorm over all H units of a row; the backward has both again
// before its recurrent product).  Design: one persistent launch a call, a
// block a (direction, tile of BR batch rows) that owns all 4H gate columns
// of its rows, so every LayerNorm is a reduction inside the block (a warp a
// (row, block), the two-pass variance of jnp.var) and no block waits on
// another.  The price is Wh: 2 x 4H^2 bytes (512 KB at H = 256) does not
// fit shared memory, so every step streams it from L2 (each block reads it
// once a step, 8-byte loads of four adjacent gate columns, which every row
// of the tile reuses from registers, 16 rows of them in flight a thread:
// the loads wait on L2's latency, not its bandwidth); the forward's and the
// backward's products are CUDA-core fp32 FMAs of bf16-rounded operands,
// exact products summed in another order than the reference.  The backward reads Wh^T
// [G, 4H, H] (a copy the wrapper makes), so its dh product reads consecutive
// units as consecutive addresses.  The parameter sums are kept per block in
// registers (a thread a column, the rows of a step summed in order) and
// written as per-tile partials; a second launch sums the tiles in order: no
// atomics, the same bits every run.  Rows past B and padded steps (mask 0,
// rows of length 0 included) keep their carries bit for bit and give zero
// outputs and cotangents.  The recurrent-dropout mask is a template
// instance: without it the kernel reads nothing more.
//
// Two routes, chosen by shape (kernels.ln_lstm_family): at H a multiple of
// 64 from 128 to 384 (every preset's 256) the cluster kernels of
// ln_lstm_cluster.cuh (avsr_ln_lstm_cluster_*: one persistent launch of
// 8-CTA clusters a call, Wh slices resident in shared memory, the products
// on the tensor cores, the LayerNorm statistics exchanged between the
// CTAs), which describes them; every other multiple of 4 up to 512 the
// block kernels below (avsr_ln_lstm_scan_*).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "ln_lstm_cluster.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int BR = 4;  // batch rows a block (8 measured slower at B = 128)
constexpr float LN_EPS = 1e-5f;
constexpr size_t SMEM_LIMIT = 232448;

__device__ __forceinline__ float sigmoidf_(float x) { return 1.0f / (1.0f + expf(-x)); }

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;  // the same bits in every lane: each level adds a pair in both orders
}

// mean and 1/sqrt(var + eps) of x[0..n), two passes, computed by a whole
// warp; every lane gets both
__device__ __forceinline__ void warp_row_stats(const float* x, int n, float& mean,
                                               float& rstd) {
  const int lane = threadIdx.x & 31;
  float s = 0.f;
  for (int u = lane; u < n; u += 32) s += x[u];
  mean = warp_sum(s) / (float)n;
  float v = 0.f;
  for (int u = lane; u < n; u += 32) {
    const float d = x[u] - mean;
    v += d * d;
  }
  rstd = 1.0f / sqrtf(warp_sum(v) / (float)n + LN_EPS);
}

__device__ __forceinline__ float bf_lo(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float bf_hi(uint32_t v) { return __uint_as_float(v & 0xffff0000u); }
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// shared memory of a block, in floats
__host__ __device__ constexpr size_t fwd_floats(int H) {
  // hp [H][BR], z [BR][4H], h, c, c' [BR][H], gate stats [BR][4][2],
  // cell stats [BR][2], mask [BR]
  return (size_t)BR * (8 * (size_t)H + 11);
}
__host__ __device__ constexpr size_t bwd_floats(int H) {
  // gn [BR][4H], dpre [BR][4H], dz^T [4H][BR], c_res, cn, dcfo, dh, dc
  // [BR][H], gate stats and their backward sums [BR][4][2] each, cell stats
  // and sums [BR][2] each, mask [BR]
  return (size_t)BR * (17 * (size_t)H + 21);
}

// the BR values of one k of a [K][BR] array in shared memory
__device__ __forceinline__ void load_rows(const float* src, float* v) {
  const float4* p = reinterpret_cast<const float4*>(src);
#pragma unroll
  for (int q = 0; q < BR / 4; ++q) {
    const float4 a = p[q];
    v[4 * q] = a.x;
    v[4 * q + 1] = a.y;
    v[4 * q + 2] = a.z;
    v[4 * q + 3] = a.w;
  }
}

// Forward.  grid (row tiles, G), THREADS threads; thread tid owns the gate
// column quads q = tid + THREADS * j (columns 4q..4q+3), j < NQ, in the
// product.
template <int NQ, bool RD>
__global__ void __launch_bounds__(THREADS, 1)
ln_lstm_fwd_kernel(const __nv_bfloat16* __restrict__ wh,  // [G, H, 4H]
                   const float* __restrict__ bias,        // [G, 4H]
                   const float* __restrict__ lng,         // [G, 4H]
                   const float* __restrict__ lncg,        // [G, H]
                   const float* __restrict__ lncb,        // [G, H]
                   const __nv_bfloat16* __restrict__ xw,  // [T, G, B, 4H]
                   const float* __restrict__ mask,        // [T, G, B]
                   const float* __restrict__ rd,          // [G, B, H] (RD)
                   float* __restrict__ h_io,              // [G, B, H]: h0 in, hT out
                   float* __restrict__ c_io,              // [G, B, H]: c0 in, cT out
                   __nv_bfloat16* __restrict__ ys,        // [T, G, B, H]
                   __nv_bfloat16* __restrict__ h_res,     // [T, G, B, H] or null
                   float* __restrict__ c_res,             // [T, G, B, H] or null
                   float* __restrict__ z_res,             // [T, G, B, 4H] or null
                   int T, int G, int B, int H) {
  extern __shared__ __align__(16) float sm[];
  const int H4 = 4 * H;
  float* hp_s = sm;                 // [H][BR]
  float* z_s = hp_s + H * BR;       // [BR][4H]
  float* h_s = z_s + BR * H4;       // [BR][H]
  float* c_s = h_s + BR * H;        // [BR][H]
  float* cn_s = c_s + BR * H;       // [BR][H]
  float* gst = cn_s + BR * H;       // [BR][4][2]
  float* cst = gst + BR * 8;        // [BR][2]
  float* m_s = cst + BR * 2;        // [BR]
  const int g = blockIdx.y;
  const int row0 = blockIdx.x * BR;
  const int tid = threadIdx.x, warp = tid >> 5;
  const bool save = z_res != nullptr;
  const __nv_bfloat16* whg = wh + (size_t)g * H * H4;
  const float* bg = bias + (size_t)g * H4;
  const float* lngg = lng + (size_t)g * H4;
  const float* lncgg = lncg + (size_t)g * H;
  const float* lncbg = lncb + (size_t)g * H;

  for (int i = tid; i < BR * H; i += THREADS) {
    const int r = i / H, u = i - r * H;
    const int row = row0 + r;
    float h = 0.f, c = 0.f, keep = 1.f;
    if (row < B) {
      const size_t at = ((size_t)g * B + row) * H + u;
      h = h_io[at];
      c = c_io[at];
      if (RD) keep = rd[at];
    }
    h_s[i] = h;
    c_s[i] = c;
    hp_s[u * BR + r] = round_bf16(RD ? h * keep : h);
  }
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    const size_t tg = (size_t)t * G + g;
    if (tid < BR) m_s[tid] = row0 + tid < B ? mask[tg * B + row0 + tid] : 0.f;
    // z = xw + hp @ Wh: the tile's rows against four adjacent gate columns
    float acc[NQ][BR][4];
#pragma unroll
    for (int j = 0; j < NQ; ++j)
#pragma unroll
      for (int r = 0; r < BR; ++r)
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[j][r][k] = 0.f;
    // KB rows of Wh in flight a thread: the loads are L2 latency, not bandwidth
    constexpr int KB = 16 / NQ;
    for (int k0 = 0; k0 < H; k0 += KB) {
      uint2 w[NQ][KB];
#pragma unroll
      for (int j = 0; j < NQ; ++j) {
        const int q = tid + THREADS * j;
#pragma unroll
        for (int kk = 0; kk < KB; ++kk)  // past H: zero weights, a no-op FMA
          w[j][kk] = q < H && k0 + kk < H
                         ? __ldg(reinterpret_cast<const uint2*>(whg + (size_t)(k0 + kk) * H4
                                                                + 4 * q))
                         : make_uint2(0u, 0u);
      }
#pragma unroll
      for (int kk = 0; kk < KB; ++kk) {
        float hv[BR];
        load_rows(hp_s + min(k0 + kk, H - 1) * BR, hv);
#pragma unroll
        for (int j = 0; j < NQ; ++j) {
          const float w0 = bf_lo(w[j][kk].x), w1 = bf_hi(w[j][kk].x);
          const float w2 = bf_lo(w[j][kk].y), w3 = bf_hi(w[j][kk].y);
#pragma unroll
          for (int r = 0; r < BR; ++r) {
            acc[j][r][0] = fmaf(hv[r], w0, acc[j][r][0]);
            acc[j][r][1] = fmaf(hv[r], w1, acc[j][r][1]);
            acc[j][r][2] = fmaf(hv[r], w2, acc[j][r][2]);
            acc[j][r][3] = fmaf(hv[r], w3, acc[j][r][3]);
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < NQ; ++j) {
      const int q = tid + THREADS * j;
      if (q >= H) continue;
#pragma unroll
      for (int r = 0; r < BR; ++r) {
        const int row = row0 + r;
        float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
        if (row < B) {
          const size_t at = (tg * B + row) * H4 + 4 * q;
          const uint2 x = *reinterpret_cast<const uint2*>(xw + at);
          z = make_float4(bf_lo(x.x) + acc[j][r][0], bf_hi(x.x) + acc[j][r][1],
                          bf_lo(x.y) + acc[j][r][2], bf_hi(x.y) + acc[j][r][3]);
          if (save) *reinterpret_cast<float4*>(z_res + at) = z;
        }
        *reinterpret_cast<float4*>(z_s + r * H4 + 4 * q) = z;
      }
    }
    __syncthreads();
    for (int p = warp; p < 4 * BR; p += WARPS) {  // (row, gate block) pairs
      float mean, rstd;
      warp_row_stats(z_s + (p >> 2) * H4 + (p & 3) * H, H, mean, rstd);
      if ((tid & 31) == 0) {
        gst[2 * p] = mean;
        gst[2 * p + 1] = rstd;
      }
    }
    __syncthreads();
    for (int i = tid; i < BR * H; i += THREADS) {
      const int r = i / H, u = i - r * H;
      float a[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int col = k * H + u;
        const float gn = (z_s[r * H4 + col] - gst[8 * r + 2 * k]) * gst[8 * r + 2 * k + 1];
        a[k] = gn * lngg[col] + bg[col];
      }
      const float ig = sigmoidf_(a[0]), fg = sigmoidf_(a[1]), gg = tanhf(a[2]);
      cn_s[i] = fg * c_s[i] + ig * gg;
      z_s[r * H4 + 3 * H + u] = sigmoidf_(a[3]);  // o, read below by this thread
    }
    __syncthreads();
    for (int r = warp; r < BR; r += WARPS) {
      float mean, rstd;
      warp_row_stats(cn_s + r * H, H, mean, rstd);
      if ((tid & 31) == 0) {
        cst[2 * r] = mean;
        cst[2 * r + 1] = rstd;
      }
    }
    __syncthreads();
    for (int i = tid; i < BR * H; i += THREADS) {
      const int r = i / H, u = i - r * H;
      const int row = row0 + r;
      const float c_new = cn_s[i];
      const float cfo = (c_new - cst[2 * r]) * cst[2 * r + 1] * lncgg[u] + lncbg[u];
      const float h_new = z_s[r * H4 + 3 * H + u] * tanhf(cfo);
      const float m = m_s[r];
      const float h = m * h_new + (1.f - m) * h_s[i];
      if (row < B) {
        const size_t at = (tg * B + row) * H + u;
        if (save) {
          h_res[at] = __float2bfloat16(hp_s[u * BR + r]);  // exact: hp is bf16-valued
          c_res[at] = c_s[i];
        }
        ys[at] = __float2bfloat16(h_new * m);
      }
      c_s[i] = m * c_new + (1.f - m) * c_s[i];
      h_s[i] = h;
      float keep = 1.f;
      if (RD && row < B) keep = rd[((size_t)g * B + row) * H + u];
      hp_s[u * BR + r] = round_bf16(RD ? h * keep : h);
    }
    __syncthreads();
  }
  for (int i = tid; i < BR * H; i += THREADS) {
    const int r = i / H, u = i - r * H;
    if (row0 + r < B) {
      const size_t at = ((size_t)g * B + row0 + r) * H + u;
      h_io[at] = h_s[i];
      c_io[at] = c_s[i];
    }
  }
}

// Backward.  grid (row tiles, G).  part [G, tiles, 10H]: the tile's sums of
// db [4H], dln_gamma [4H], dln_cell_gamma [H], dln_cell_beta [H].
template <int NQ, bool RD>
__global__ void __launch_bounds__(THREADS, 1)
ln_lstm_bwd_kernel(const __nv_bfloat16* __restrict__ whT,  // [G, 4H, H]
                   const float* __restrict__ bias, const float* __restrict__ lng,
                   const float* __restrict__ lncg, const float* __restrict__ lncb,
                   const float* __restrict__ mask,         // [T, G, B]
                   const float* __restrict__ rd,           // [G, B, H] (RD)
                   const float* __restrict__ c_res,        // [T, G, B, H]
                   const float* __restrict__ z_res,        // [T, G, B, 4H]
                   const __nv_bfloat16* __restrict__ dys,  // [T, G, B, H]
                   float* __restrict__ dh_io,              // [G, B, H]: dhT in, dh0 out
                   float* __restrict__ dc_io,              // [G, B, H]: dcT in, dc0 out
                   __nv_bfloat16* __restrict__ dxw,        // [T, G, B, 4H]
                   float* __restrict__ part,               // [G, tiles, 10H]
                   int T, int G, int B, int H) {
  extern __shared__ __align__(16) float sm[];
  const int H4 = 4 * H;
  float* gn_s = sm;                 // [BR][4H]: z, then gn
  float* dp_s = gn_s + BR * H4;     // [BR][4H]: i, f, g, o, then dpre
  float* dzT = dp_s + BR * H4;      // [4H][BR]
  float* cp_s = dzT + H4 * BR;      // [BR][H]: c_res[t]
  float* cn_s = cp_s + BR * H;      // [BR][H]: c', then LN(c')
  float* dcf_s = cn_s + BR * H;     // [BR][H]: dcfo
  float* dh_s = dcf_s + BR * H;     // [BR][H]
  float* dc_s = dh_s + BR * H;      // [BR][H]
  float* gst = dc_s + BR * H;       // [BR][4][2]: mean, rstd
  float* gsum = gst + BR * 8;       // [BR][4][2]: mean(dy), mean(dy x_hat)
  float* cst = gsum + BR * 8;       // [BR][2]
  float* csum = cst + BR * 2;       // [BR][2]
  float* m_s = csum + BR * 2;       // [BR]
  const int g = blockIdx.y;
  const int row0 = blockIdx.x * BR;
  const int tid = threadIdx.x, warp = tid >> 5;
  const __nv_bfloat16* whg = whT + (size_t)g * H4 * H;
  const float* bg = bias + (size_t)g * H4;
  const float* lngg = lng + (size_t)g * H4;
  const float* lncgg = lncg + (size_t)g * H;
  const float* lncbg = lncb + (size_t)g * H;

  float a_db[NQ][4], a_dlng[NQ][4], a_dcg[NQ], a_dcb[NQ];
#pragma unroll
  for (int j = 0; j < NQ; ++j) {
    a_dcg[j] = a_dcb[j] = 0.f;
#pragma unroll
    for (int k = 0; k < 4; ++k) a_db[j][k] = a_dlng[j][k] = 0.f;
  }
  for (int i = tid; i < BR * H; i += THREADS) {
    const int r = i / H, u = i - r * H;
    const int row = row0 + r;
    float dh = 0.f, dc = 0.f;
    if (row < B) {
      const size_t at = ((size_t)g * B + row) * H + u;
      dh = dh_io[at];
      dc = dc_io[at];
    }
    dh_s[i] = dh;
    dc_s[i] = dc;
  }

  for (int t = T - 1; t >= 0; --t) {
    const size_t tg = (size_t)t * G + g;
    if (tid < BR) m_s[tid] = row0 + tid < B ? mask[tg * B + row0 + tid] : 0.f;
    for (int i = tid; i < BR * (H4 / 4); i += THREADS) {
      const int r = i / H, q = i - r * H;
      const int row = row0 + r;
      float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
      if (row < B) z = *reinterpret_cast<const float4*>(z_res + (tg * B + row) * H4 + 4 * q);
      *reinterpret_cast<float4*>(gn_s + r * H4 + 4 * q) = z;
    }
    for (int i = tid; i < BR * H; i += THREADS) {
      const int r = i / H, u = i - r * H;
      cp_s[i] = row0 + r < B ? c_res[(tg * B + row0 + r) * H + u] : 0.f;
    }
    __syncthreads();
    for (int p = warp; p < 4 * BR; p += WARPS) {
      float mean, rstd;
      warp_row_stats(gn_s + (p >> 2) * H4 + (p & 3) * H, H, mean, rstd);
      if ((tid & 31) == 0) {
        gst[2 * p] = mean;
        gst[2 * p + 1] = rstd;
      }
    }
    __syncthreads();
    for (int i = tid; i < BR * H; i += THREADS) {  // A: gn, the gates, c'
      const int r = i / H, u = i - r * H;
      float act[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int col = k * H + u;
        const float gn = (gn_s[r * H4 + col] - gst[8 * r + 2 * k]) * gst[8 * r + 2 * k + 1];
        gn_s[r * H4 + col] = gn;
        const float a = gn * lngg[col] + bg[col];
        act[k] = k == 2 ? tanhf(a) : sigmoidf_(a);
        dp_s[r * H4 + col] = act[k];
      }
      cn_s[i] = act[1] * cp_s[i] + act[0] * act[2];
    }
    __syncthreads();
    for (int r = warp; r < BR; r += WARPS) {
      float mean, rstd;
      warp_row_stats(cn_s + r * H, H, mean, rstd);
      if ((tid & 31) == 0) {
        cst[2 * r] = mean;
        cst[2 * r + 1] = rstd;
      }
    }
    __syncthreads();
    for (int i = tid; i < BR * H; i += THREADS) {  // B: the output's cotangents
      const int r = i / H, u = i - r * H;
      const int row = row0 + r;
      const float cn = (cn_s[i] - cst[2 * r]) * cst[2 * r + 1];
      const float tc = tanhf(cn * lncgg[u] + lncbg[u]);
      const float m = m_s[r];
      const float dy = row < B ? __bfloat162float(dys[(tg * B + row) * H + u]) : 0.f;
      const float dh_new = (dh_s[i] + dy) * m;
      const float o = dp_s[r * H4 + 3 * H + u];
      const float d_o = dh_new * tc;
      cn_s[i] = cn;
      dcf_s[i] = dh_new * o * (1.f - tc * tc);
      dp_s[r * H4 + 3 * H + u] = d_o * o * (1.f - o);
    }
    __syncthreads();
    for (int r = warp; r < BR; r += WARPS) {  // the cell LN's backward means
      const int lane = tid & 31;
      float s1 = 0.f, s2 = 0.f;
      for (int u = lane; u < H; u += 32) {
        const float dy = dcf_s[r * H + u] * lncgg[u];
        s1 += dy;
        s2 += dy * cn_s[r * H + u];
      }
      s1 = warp_sum(s1);
      s2 = warp_sum(s2);
      if (lane == 0) {
        csum[2 * r] = s1 / (float)H;
        csum[2 * r + 1] = s2 / (float)H;
      }
    }
    __syncthreads();
    for (int i = tid; i < BR * H; i += THREADS) {  // C: dc', the gates' cotangents, dc
      const int r = i / H, u = i - r * H;
      const float m = m_s[r];
      const float dcn = dcf_s[i] * lncgg[u];
      const float dc_new =
          dc_s[i] * m + cst[2 * r + 1] * (dcn - csum[2 * r] - cn_s[i] * csum[2 * r + 1]);
      float* a = dp_s + r * H4 + u;
      const float ig = a[0], fg = a[H], gg = a[2 * H];
      a[0] = dc_new * gg * ig * (1.f - ig);
      a[H] = dc_new * cp_s[i] * fg * (1.f - fg);
      a[2 * H] = dc_new * ig * (1.f - gg * gg);
      dc_s[i] = dc_new * fg + dc_s[i] * (1.f - m);
    }
    __syncthreads();
    for (int p = warp; p < 4 * BR; p += WARPS) {  // the gate LN's backward means
      const int lane = tid & 31;
      const int r = p >> 2, k = p & 3;
      float s1 = 0.f, s2 = 0.f;
      for (int u = lane; u < H; u += 32) {
        const int col = k * H + u;
        const float dy = dp_s[r * H4 + col] * lngg[col];
        s1 += dy;
        s2 += dy * gn_s[r * H4 + col];
      }
      s1 = warp_sum(s1);
      s2 = warp_sum(s2);
      if (lane == 0) {
        gsum[2 * p] = s1 / (float)H;
        gsum[2 * p + 1] = s2 / (float)H;
      }
    }
    __syncthreads();
    // D: dz and dxw, a thread four adjacent columns; the parameter sums
#pragma unroll
    for (int j = 0; j < NQ; ++j) {
      const int q = tid + THREADS * j;
      if (q < H) {
#pragma unroll
        for (int r = 0; r < BR; ++r) {
          float dz[4];
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int col = 4 * q + k;
            const int blk = col / H;
            const float dp = dp_s[r * H4 + col], gn = gn_s[r * H4 + col];
            a_db[j][k] += dp;
            a_dlng[j][k] += dp * gn;
            const int p = 4 * r + blk;
            dz[k] = gst[2 * p + 1] * (dp * lngg[col] - gsum[2 * p] - gn * gsum[2 * p + 1]);
            dzT[col * BR + r] = dz[k];
          }
          const int row = row0 + r;
          if (row < B) {
            __nv_bfloat162 lo = __floats2bfloat162_rn(dz[0], dz[1]);
            __nv_bfloat162 hi = __floats2bfloat162_rn(dz[2], dz[3]);
            uint2 v;
            v.x = *reinterpret_cast<uint32_t*>(&lo);
            v.y = *reinterpret_cast<uint32_t*>(&hi);
            *reinterpret_cast<uint2*>(dxw + (tg * B + row) * H4 + 4 * q) = v;
          }
        }
      }
      const int u = tid + THREADS * j;
      if (u < H) {
#pragma unroll
        for (int r = 0; r < BR; ++r) {
          a_dcg[j] += dcf_s[r * H + u] * cn_s[r * H + u];
          a_dcb[j] += dcf_s[r * H + u];
        }
      }
    }
    __syncthreads();
    // E: dh = bf16(dz @ Wh^T) * rd + dh * (1 - m).  The 4H columns are cut
    // into four runs of H (the gate blocks), each summed by a quarter of the
    // block for four adjacent units (8-byte loads of Wh^T, as the
    // forward's), then the four partial sums added in block order (dpre's
    // buffer, read for the last time in D, holds them).
    {
      constexpr int QT = THREADS / 4;  // threads of a quarter
      const int quarter = tid / QT, lane = tid - quarter * QT;
      const __nv_bfloat16* wq = whg + (size_t)quarter * H * H;
      for (int q = lane; q < H / 4; q += QT) {
        float acc[BR][4];
#pragma unroll
        for (int r = 0; r < BR; ++r)
#pragma unroll
          for (int k = 0; k < 4; ++k) acc[r][k] = 0.f;
        constexpr int KB = 16;  // rows of Wh^T in flight a thread
        for (int c0 = 0; c0 < H; c0 += KB) {
          uint2 w[KB];
#pragma unroll
          for (int kk = 0; kk < KB; ++kk)
            w[kk] = c0 + kk < H
                        ? __ldg(reinterpret_cast<const uint2*>(wq + (size_t)(c0 + kk) * H + 4 * q))
                        : make_uint2(0u, 0u);
#pragma unroll
          for (int kk = 0; kk < KB; ++kk) {
            float dz[BR];
            load_rows(dzT + (quarter * H + min(c0 + kk, H - 1)) * BR, dz);
            const float w0 = bf_lo(w[kk].x), w1 = bf_hi(w[kk].x);
            const float w2 = bf_lo(w[kk].y), w3 = bf_hi(w[kk].y);
#pragma unroll
            for (int r = 0; r < BR; ++r) {
              acc[r][0] = fmaf(dz[r], w0, acc[r][0]);
              acc[r][1] = fmaf(dz[r], w1, acc[r][1]);
              acc[r][2] = fmaf(dz[r], w2, acc[r][2]);
              acc[r][3] = fmaf(dz[r], w3, acc[r][3]);
            }
          }
        }
#pragma unroll
        for (int r = 0; r < BR; ++r)
          *reinterpret_cast<float4*>(dp_s + (quarter * BR + r) * H + 4 * q) =
              make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
      }
    }
    __syncthreads();
    for (int i = tid; i < BR * H; i += THREADS) {
      const int r = i / H, u = i - r * H;
      float d = dp_s[i];
#pragma unroll
      for (int k = 1; k < 4; ++k) d += dp_s[k * BR * H + i];
      d = round_bf16(d);
      if (RD) d = row0 + r < B ? d * rd[((size_t)g * B + row0 + r) * H + u] : 0.f;
      dh_s[i] = d + dh_s[i] * (1.f - m_s[r]);
    }
    __syncthreads();
  }
  for (int i = tid; i < BR * H; i += THREADS) {
    const int r = i / H, u = i - r * H;
    if (row0 + r < B) {
      const size_t at = ((size_t)g * B + row0 + r) * H + u;
      dh_io[at] = dh_s[i];
      dc_io[at] = dc_s[i];
    }
  }
  float* pt = part + ((size_t)g * gridDim.x + blockIdx.x) * 10 * H;
#pragma unroll
  for (int j = 0; j < NQ; ++j) {
    const int q = tid + THREADS * j;
    if (q < H) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        pt[4 * q + k] = a_db[j][k];
        pt[H4 + 4 * q + k] = a_dlng[j][k];
      }
      pt[2 * H4 + q] = a_dcg[j];
      pt[2 * H4 + H + q] = a_dcb[j];
    }
  }
}

// out [G, n] = the sum over tiles of part [G, tiles, n], in tile order
__global__ void ln_lstm_part_reduce(const float* __restrict__ part, float* __restrict__ out,
                                    int tiles, int n) {
  const int g = blockIdx.y;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int k = 0; k < tiles; ++k) s += part[((size_t)g * tiles + k) * n + i];
  out[(size_t)g * n + i] = s;
}

// column quads a thread by H: one up to H = 256, two up to 512
template <bool BWD, bool RD>
const void* kernel_for(int H) {
  if (H <= THREADS)
    return BWD ? (const void*)ln_lstm_bwd_kernel<1, RD> : (const void*)ln_lstm_fwd_kernel<1, RD>;
  if (H <= 2 * THREADS)
    return BWD ? (const void*)ln_lstm_bwd_kernel<2, RD> : (const void*)ln_lstm_fwd_kernel<2, RD>;
  return nullptr;
}

size_t smem_bytes(int H, bool bwd) {
  return (bwd ? bwd_floats(H) : fwd_floats(H)) * sizeof(float);
}

cudaError_t prepare(const void* fn, size_t smem) {
  if (fn == nullptr || smem > SMEM_LIMIT) return cudaErrorInvalidValue;
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace

// Shared memory of a block (``kernels.ln_lstm_smem``).
extern "C" long long avsr_ln_lstm_smem(int H, int backward) {
  return (long long)smem_bytes(H, backward != 0);
}

// Forward, one launch.  wh [G, H, 4H] bf16; bias, lng [G, 4H], lncg, lncb
// [G, H] fp32; xw [T, G, B, 4H] bf16; mask [T, G, B] fp32; rd [G, B, H] fp32
// or null; h, c [G, B, H] fp32 (h0, c0 in; hT, cT out); ys [T, G, B, H]
// bf16; h_res (bf16), c_res [T, G, B, H] and z_res [T, G, B, 4H] (fp32) all
// three or none (save mode).  H a multiple of 4 up to 512.
extern "C" int avsr_ln_lstm_scan_fwd(const void* wh, const void* bias, const void* lng,
                                     const void* lncg, const void* lncb, const void* xw,
                                     const void* mask, const void* rd, void* h, void* c,
                                     void* ys, void* h_res, void* c_res, void* z_res, int T,
                                     int G, int B, int H, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (T < 0 || G < 1 || B < 1 || H < 4 || H % 4) return (int)cudaErrorInvalidValue;
  const void* fn = rd != nullptr ? kernel_for<false, true>(H) : kernel_for<false, false>(H);
  const size_t smem = smem_bytes(H, false);
  cudaError_t e = prepare(fn, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((B + BR - 1) / BR, G);
  void* args[] = {(void*)&wh, (void*)&bias, (void*)&lng, (void*)&lncg, (void*)&lncb,
                  (void*)&xw, (void*)&mask, (void*)&rd, &h, &c, &ys, &h_res, &c_res, &z_res,
                  &T, &G, &B, &H};
  e = cudaLaunchKernel(fn, grid, dim3(THREADS), args, smem, st);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// Backward, two launches: the reverse scan, then the tiles' parameter sums
// reduced in order.  whT [G, 4H, H] bf16 (Wh transposed); dh, dc [G, B, H]
// fp32 (dhT, dcT in; dh0, dc0 out); dxw [T, G, B, 4H] bf16; part [G, tiles,
// 10H] fp32 scratch; grads [G, 10H] fp32: db, dln_gamma, dln_cell_gamma,
// dln_cell_beta.
extern "C" int avsr_ln_lstm_scan_bwd(const void* whT, const void* bias, const void* lng,
                                     const void* lncg, const void* lncb, const void* mask,
                                     const void* rd, const void* c_res, const void* z_res,
                                     const void* dys, void* dh, void* dc, void* dxw, void* part,
                                     void* grads, int T, int G, int B, int H, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (T < 1 || G < 1 || B < 1 || H < 4 || H % 4) return (int)cudaErrorInvalidValue;
  const void* fn = rd != nullptr ? kernel_for<true, true>(H) : kernel_for<true, false>(H);
  const size_t smem = smem_bytes(H, true);
  cudaError_t e = prepare(fn, smem);
  if (e != cudaSuccess) return (int)e;
  const int tiles = (B + BR - 1) / BR;
  void* args[] = {(void*)&whT, (void*)&bias, (void*)&lng, (void*)&lncg, (void*)&lncb,
                  (void*)&mask, (void*)&rd, (void*)&c_res, (void*)&z_res, (void*)&dys, &dh,
                  &dc, &dxw, &part, &T, &G, &B, &H};
  e = cudaLaunchKernel(fn, dim3(tiles, G), dim3(THREADS), args, smem, st);
  if (e != cudaSuccess) return (int)e;
  const int n = 10 * H;
  ln_lstm_part_reduce<<<dim3((n + 255) / 256, G), 256, 0, st>>>(
      static_cast<const float*>(part), static_cast<float*>(grads), tiles, n);
  return (int)cudaGetLastError();
}

// The H of the cluster kernels' instances (kernels.ln_lstm_family's rule: a
// multiple of 64 from 128, the backward's shared memory within the card's).
#define AVSR_LN_LSTM_CLUSTER_WIDTHS(X) X(128) X(192) X(256) X(320) X(384)

// Shared memory of one CTA of the cluster kernels at width H
// (``kernels.ln_lstm_cluster_smem``), or -1 for a width with no instance.
extern "C" long long avsr_ln_lstm_cluster_smem(int H, int backward) {
  switch (H) {
#define AVSR_CASE(W) \
  case W:            \
    return (long long)(backward ? ln_cl::Shape<W>::BWD_SMEM : ln_cl::Shape<W>::FWD_SMEM);
    AVSR_LN_LSTM_CLUSTER_WIDTHS(AVSR_CASE)
#undef AVSR_CASE
    default:
      return -1;
  }
}

// cudaOccupancyMaxActiveClusters of the cluster forward or backward at
// width H (0 on an error or a width with no instance).
extern "C" int avsr_ln_lstm_cluster_max_active(int H, int backward) {
  switch (H) {
#define AVSR_CASE(W) \
  case W:            \
    return ln_cl::max_active<W>(backward != 0);
    AVSR_LN_LSTM_CLUSTER_WIDTHS(AVSR_CASE)
#undef AVSR_CASE
    default:
      return 0;
  }
}

// Forward on the cluster route, one launch.  wcl: Wh in the cluster layout
// [G, 8, H/64, 4, 8, H] bf16 (kernels.cluster_lstm_weights); the other
// operands as avsr_ln_lstm_scan_fwd's.
extern "C" int avsr_ln_lstm_cluster_fwd(const void* wcl, const void* bias, const void* lng,
                                        const void* lncg, const void* lncb, const void* xw,
                                        const void* mask, const void* rd, void* h, void* c,
                                        void* ys, void* h_res, void* c_res, void* z_res, int T,
                                        int G, int B, int H, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (T < 0 || G < 1 || B < 1 || (h_res == nullptr) != (z_res == nullptr) ||
      (c_res == nullptr) != (z_res == nullptr))
    return (int)cudaErrorInvalidValue;
  switch (H) {
#define AVSR_CASE(W) \
  case W:            \
    return (int)ln_cl::fwd<W>(wcl, bias, lng, lncg, lncb, xw, mask, rd, h, c, ys, h_res, c_res, \
                              z_res, T, G, B, st);
    AVSR_LN_LSTM_CLUSTER_WIDTHS(AVSR_CASE)
#undef AVSR_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Backward on the cluster route, three launches: the row statistics of
// every step (stats [T, G, B, 10] fp32 scratch), the reverse scan, the
// tiles' parameter sums reduced in order (part [G, ceil(B/16), 10H] fp32
// scratch; grads as avsr_ln_lstm_scan_bwd's).  wcl in the cluster layout;
// dh, dc [G, B, H] fp32: dhT, dcT in, dh0, dc0 out.
extern "C" int avsr_ln_lstm_cluster_bwd(const void* wcl, const void* bias, const void* lng,
                                        const void* lncg, const void* lncb, const void* mask,
                                        const void* rd, const void* c_res, const void* z_res,
                                        const void* dys, void* dh, void* dc, void* dxw,
                                        void* stats, void* part, void* grads, int T, int G,
                                        int B, int H, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (T < 1 || G < 1 || B < 1) return (int)cudaErrorInvalidValue;
  cudaError_t e;
  switch (H) {
#define AVSR_CASE(W)                                                                        \
  case W:                                                                                   \
    e = ln_cl::bwd<W>(wcl, bias, lng, lncg, lncb, mask, rd, c_res, z_res, dys, dh, dc, dxw, \
                      stats, part, T, G, B, st);                                            \
    break;
    AVSR_LN_LSTM_CLUSTER_WIDTHS(AVSR_CASE)
#undef AVSR_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
  if (e != cudaSuccess) return (int)e;
  const int n = 10 * H;
  ln_lstm_part_reduce<<<dim3((n + 255) / 256, G), 256, 0, st>>>(
      static_cast<const float*>(part), static_cast<float*>(grads), (B + 15) / 16, n);
  return (int)cudaGetLastError();
}

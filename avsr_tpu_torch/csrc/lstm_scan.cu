// K1: direction-batched masked LSTM recurrence, forward and backward.
//
// Forward: replaces avsr_tpu/ops/rnn.py:_bilstm_scan_core_fwd_impl (with
// save=False for serving, save=True for training, where each step also
// writes the bf16 (h, c) carries entering it: the residuals of the
// backward), the hand-derived JAX core every BiLSTM layer of the encoders
// runs.  The backward (rnn.py:_bilstm_scan_core_bwd) is described further
// down, above its kernel.  Per step t and direction g of the forward:
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
                 __nv_bfloat16* __restrict__ h_res_t,         // [G, B, H] or null
                 __nv_bfloat16* __restrict__ c_res_t,         // [G, B, H] or null
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
    if (h_res_t != nullptr) {  // residuals for the backward: the carries entering step t
      h_res_t[s] = __float2bfloat16(h_prev);
      c_res_t[s] = __float2bfloat16(c_prev);
    }
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

// ---------------------------------------------------------------------------
// Backward: replaces avsr_tpu/ops/rnn.py:_bilstm_scan_core_bwd, the reverse
// scan of the hand-written VJP.  Per step t (from T-1 down to 0):
//
//   dh_out = bf16(dgates[t+1]) @ Wh[g]^T (fp32 accumulate) + dh_direct[t+1]
//   gates recomputed from xw[t], bf16 h_res[t] @ Wh[g] and b; c_prev =
//   float(c_res[t]) (the bf16-rounded carry, as the reference recomputes)
//   the pointwise backward of rnn.py:405-425 -> fp32 dgates[t];
//   dxw[t] = bf16(dgates[t]); db += dgates[t] (unrounded, summed over rows)
//   dh_direct[t] = dh_out * (1 - m);  dc <- dc_new * f + dc_out * (1 - m)
//
// and after the loop dh0 = bf16(dgates[0]) @ Wh[g]^T + dh_direct[0].
// dWh = h_res^T @ dxw over all steps is one large product outside the
// scan (as the reference hoists it), left to the caller.
//
// What bounds it on an H100: the same as the forward, twice over.  A step
// does two [16 x K] x [K x 16]-per-block products (K = 4H for the dh
// product, H per gate for the recompute), each out of a 32 KB operand
// slice staged from L2, plus one read of the 16 dgates rows the previous
// launch wrote (32 KB): ~104 KB of shared memory per block, two blocks per
// SM.  Design: one launch per step from a host loop, like the forward; a
// block owns (direction g, BT batch rows, UT hidden units) and keeps those
// units' fp32 dh_direct / dc carries in device memory (only the owner reads
// them).  The dh product needs all 4H dgates of its rows, written by every
// block in the previous launch: the launch boundary is the only
// synchronisation.  Its operand, rows u0..u0+UT of Wh[g] [H, 4H], is passed
// pre-tiled as [G, H/UT, H, UT, 4] (tile, k quad, unit, k within the quad)
// so a thread reads four consecutive k of its unit as one 8-byte load and
// a warp's 16 units are adjacent; the recompute reads the forward's tiled
// slice.  db is summed over the block's rows in shared memory and
// accumulated per (row tile, gate unit) in a buffer the block owns, so
// the final launch reduces BT-row partial sums in a fixed order: no
// atomics, the same bits every run.  Padded rows (mask 0, including rows of
// length 0) produce zero dgates and carry dh/dc through unchanged.
// ---------------------------------------------------------------------------

__device__ __forceinline__ void stage_contig(uint4* dst, const uint4* src, int n, int n_valid,
                                             int tid) {
  for (int c0 = tid; c0 < n; c0 += VEC * THREADS) {
    uint4 v[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const int ci = c0 + j * THREADS;
      v[j] = make_uint4(0u, 0u, 0u, 0u);
      if (ci < n_valid) v[j] = src[ci];
    }
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const int ci = c0 + j * THREADS;
      if (ci < n) dst[ci] = v[j];
    }
  }
}

// acc = sum_k dg_s[r, k] * Wh[g][unit, k], k over 4H (tiled operand wT_s).
__device__ __forceinline__ float dh_product(const __nv_bfloat16* dg_s,
                                            const __nv_bfloat16* wT_s, int r, int u,
                                            int H) {
  const uint2* dr = reinterpret_cast<const uint2*>(dg_s + (size_t)r * 4 * H);
  const uint2* wu = reinterpret_cast<const uint2*>(wT_s) + u;
  float a0 = 0.f, a1 = 0.f;
#pragma unroll 4
  for (int kq = 0; kq < H; ++kq) {
    const uint2 d = dr[kq];
    const uint2 w = wu[kq * UT];
    a0 = fmaf(bf_lo(d.x), bf_lo(w.x), a0);
    a1 = fmaf(bf_hi(d.x), bf_hi(w.x), a1);
    a0 = fmaf(bf_lo(d.y), bf_lo(w.y), a0);
    a1 = fmaf(bf_hi(d.y), bf_hi(w.y), a1);
  }
  return a0 + a1;
}

__global__ void __launch_bounds__(THREADS)
lstm_bwd_step_kernel(const __nv_bfloat16* __restrict__ wh_tiled,   // [G, H/UT, H, UT, 4]
                     const __nv_bfloat16* __restrict__ whT_tiled,  // [G, H/UT, H, UT, 4]
                     const float* __restrict__ bias,               // [G, 4H]
                     const __nv_bfloat16* __restrict__ xw_t,       // [G, B, 4H]
                     const float* __restrict__ mask_t,             // [G, B]
                     const __nv_bfloat16* __restrict__ h_res_t,    // [G, B, H]
                     const __nv_bfloat16* __restrict__ c_res_t,    // [G, B, H]
                     const __nv_bfloat16* __restrict__ dys_t,      // [G, B, H]
                     const __nv_bfloat16* __restrict__ dg_next,    // [G, B, 4H] or null
                     float* __restrict__ dh_dir,                   // [G, B, H] in/out
                     float* __restrict__ dc,                       // [G, B, H] in/out
                     float* __restrict__ db_part,                  // [G, B/BT, 4H]
                     __nv_bfloat16* __restrict__ dxw_t,            // [G, B, 4H]
                     int B, int H) {
  extern __shared__ __align__(16) unsigned char smem[];
  const size_t tile_elems = (size_t)H * UT * 4;
  __nv_bfloat16* wT_s = reinterpret_cast<__nv_bfloat16*>(smem);  // [H][UT][4]
  __nv_bfloat16* wf_s = wT_s + tile_elems;                       // [H][UT][4]
  __nv_bfloat16* dg_s = wf_s + tile_elems;                       // [BT][4H]
  __nv_bfloat16* h_s = dg_s + (size_t)BT * 4 * H;                // [BT][H]
  float* red_s = reinterpret_cast<float*>(h_s + (size_t)BT * H);  // [BT][4][UT]

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
  const int nrows = min(BT, B - row0);

  // Epilogue operands first, so their latency overlaps the staging.
  const size_t gb = (size_t)g * B + (live ? row : 0);
  const size_t s = gb * H + unit;
  const __nv_bfloat16* x = xw_t + gb * H4;
  const float* bb = bias + (size_t)g * H4;
  float xi = 0.f, xf = 0.f, xg = 0.f, xo = 0.f, c_prev = 0.f, m = 0.f, dy = 0.f;
  float dhd = 0.f, dco = 0.f;
  if (live) {
    xi = __bfloat162float(x[unit]);
    xf = __bfloat162float(x[H + unit]);
    xg = __bfloat162float(x[2 * H + unit]);
    xo = __bfloat162float(x[3 * H + unit]);
    c_prev = __bfloat162float(c_res_t[s]);
    m = mask_t[gb];
    dy = __bfloat162float(dys_t[s]);
    dhd = dh_dir[s];
    dco = dc[s];
  }
  const float bi = bb[unit], bf = bb[H + unit], bg = bb[2 * H + unit], bo = bb[3 * H + unit];

  const size_t tile_off = ((size_t)g * (H / UT) + tile) * tile_elems;
  const int tile_chunks = (int)(tile_elems / 8);
  stage_contig(reinterpret_cast<uint4*>(wf_s),
               reinterpret_cast<const uint4*>(wh_tiled + tile_off), tile_chunks, tile_chunks,
               tid);
  stage_contig(reinterpret_cast<uint4*>(h_s),
               reinterpret_cast<const uint4*>(h_res_t + ((size_t)g * B + row0) * H),
               BT * H / 8, nrows * H / 8, tid);
  if (dg_next != nullptr) {
    stage_contig(reinterpret_cast<uint4*>(wT_s),
                 reinterpret_cast<const uint4*>(whT_tiled + tile_off), tile_chunks,
                 tile_chunks, tid);
    stage_contig(reinterpret_cast<uint4*>(dg_s),
                 reinterpret_cast<const uint4*>(dg_next + ((size_t)g * B + row0) * H4),
                 BT * H4 / 8, nrows * H4 / 8, tid);
  }
  __syncthreads();

  // dh_out = dgates[t+1] @ Wh^T + dh_direct (rnn.py:427-431); at t = T-1 it is dhT.
  const float dh_out = (dg_next != nullptr ? dh_product(dg_s, wT_s, r, u, H) : 0.f) + dhd;

  // Gate recompute from the bf16 residual h (rnn.py:393-398).
  float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
  {
    const uint32_t* hr = reinterpret_cast<const uint32_t*>(h_s + r * H);
    const uint2* wu = reinterpret_cast<const uint2*>(wf_s) + u;
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
  }

  float dgi = 0.f, dgf = 0.f, dgg = 0.f, dgo = 0.f;
  if (live) {
    const float i = sigmoidf_((xi + a0) + bi);
    const float f = sigmoidf_((xf + a1) + bf);
    const float gt = tanhf((xg + a2) + bg);
    const float o = sigmoidf_((xo + a3) + bo);
    const float c_new = f * c_prev + i * gt;
    const float tc = tanhf(c_new);
    // rnn.py:405-425
    const float dh_new = (dh_out + dy) * m;
    const float dh_prev_direct = dh_out * (1.0f - m);
    float dc_new = dco * m;
    const float dc_prev_direct = dco * (1.0f - m);
    const float d_o = dh_new * tc;
    dc_new = dc_new + dh_new * o * (1.0f - tc * tc);
    const float df = dc_new * c_prev;
    const float di = dc_new * gt;
    const float dgate = dc_new * i;
    const float dc_prev = dc_new * f + dc_prev_direct;
    dgi = di * i * (1.0f - i);
    dgf = df * f * (1.0f - f);
    dgg = dgate * (1.0f - gt * gt);
    dgo = d_o * o * (1.0f - o);
    __nv_bfloat16* dx = dxw_t + gb * H4;
    dx[unit] = __float2bfloat16(dgi);
    dx[H + unit] = __float2bfloat16(dgf);
    dx[2 * H + unit] = __float2bfloat16(dgg);
    dx[3 * H + unit] = __float2bfloat16(dgo);
    dh_dir[s] = dh_prev_direct;
    dc[s] = dc_prev;
  }
  red_s[(r * 4 + 0) * UT + u] = dgi;
  red_s[(r * 4 + 1) * UT + u] = dgf;
  red_s[(r * 4 + 2) * UT + u] = dgg;
  red_s[(r * 4 + 3) * UT + u] = dgo;
  __syncthreads();
  if (tid < 4 * UT) {  // db: this block's rows, unrounded dgates (rnn.py:432)
    const int q = tid / UT, uu = tid - q * UT;
    float acc = 0.f;
    for (int rr = 0; rr < BT; ++rr) acc += red_s[(rr * 4 + q) * UT + uu];
    db_part[((size_t)g * gridDim.y + blockIdx.y) * H4 + q * H + tile * UT + uu] += acc;
  }
}

// After the reverse loop: dh0 = dgates[0] @ Wh^T + dh_direct[0], and (row
// tile 0's blocks) db = sum of the row-tile partials, in row-tile order.
__global__ void __launch_bounds__(THREADS)
lstm_bwd_final_kernel(const __nv_bfloat16* __restrict__ whT_tiled,  // [G, H/UT, H, UT, 4]
                      const __nv_bfloat16* __restrict__ dg0,        // [G, B, 4H]
                      const float* __restrict__ dh_dir,             // [G, B, H]
                      const float* __restrict__ db_part,            // [G, B/BT, 4H]
                      float* __restrict__ dh0,                      // [G, B, H]
                      float* __restrict__ db,                       // [G, 4H]
                      int B, int H) {
  extern __shared__ __align__(16) unsigned char smem[];
  const size_t tile_elems = (size_t)H * UT * 4;
  __nv_bfloat16* wT_s = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* dg_s = wT_s + tile_elems;
  const int g = blockIdx.z;
  const int tile = blockIdx.x;
  const int row0 = blockIdx.y * BT;
  const int tid = threadIdx.x;
  const int r = tid / UT;
  const int u = tid - r * UT;
  const int row = row0 + r;
  const int unit = tile * UT + u;
  const int H4 = 4 * H;
  const int nrows = min(BT, B - row0);
  const int tile_chunks = (int)(tile_elems / 8);
  stage_contig(reinterpret_cast<uint4*>(wT_s),
               reinterpret_cast<const uint4*>(
                   whT_tiled + ((size_t)g * (H / UT) + tile) * tile_elems),
               tile_chunks, tile_chunks, tid);
  stage_contig(reinterpret_cast<uint4*>(dg_s),
               reinterpret_cast<const uint4*>(dg0 + ((size_t)g * B + row0) * H4),
               BT * H4 / 8, nrows * H4 / 8, tid);
  __syncthreads();
  const float acc = dh_product(dg_s, wT_s, r, u, H);
  if (row < B) {
    const size_t s = ((size_t)g * B + row) * H + unit;
    dh0[s] = acc + dh_dir[s];
  }
  if (blockIdx.y == 0 && tid < 4 * UT) {
    const int q = tid / UT, uu = tid - q * UT;
    const int col = q * H + tile * UT + uu;
    float sum = 0.f;
    for (int rt = 0; rt < (int)gridDim.y; ++rt)
      sum += db_part[((size_t)g * gridDim.y + rt) * H4 + col];
    db[(size_t)g * H4 + col] = sum;
  }
}

}  // namespace

// wh_tiled: [G, H/UT, H, UT, 4] bf16 (see above; H must be a multiple of UT).
// hbuf: [2][G, B, H] fp32 with h0 in slot 0; after T steps h_T is in slot
// T % 2.  c: [G, B, H] fp32 holding c0 on entry and c_T on return.
// h_res, c_res: [T, G, B, H] bf16 residuals, or both null (no save).
extern "C" int avsr_lstm_scan_fwd(const void* wh_tiled, const void* bias,
                                  const void* xw, const void* mask, void* hbuf,
                                  void* c, void* ys, void* h_res, void* c_res, int T,
                                  int G, int B, int H, void* stream) {
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
  __nv_bfloat16* hr_p = static_cast<__nv_bfloat16*>(h_res);
  __nv_bfloat16* cr_p = static_cast<__nv_bfloat16*>(c_res);
  const bool save = hr_p != nullptr && cr_p != nullptr;
  for (int t = 0; t < T; ++t) {
    lstm_step_kernel<<<grid, block, smem, st>>>(
        static_cast<const __nv_bfloat16*>(wh_tiled), static_cast<const float*>(bias),
        xw_p + (size_t)t * G * B * 4 * H, mask_p + (size_t)t * G * B,
        h_p + (size_t)(t & 1) * gbh, h_p + (size_t)((t + 1) & 1) * gbh,
        static_cast<float*>(c), ys_p + (size_t)t * gbh,
        save ? hr_p + (size_t)t * gbh : nullptr, save ? cr_p + (size_t)t * gbh : nullptr,
        B, H);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaGetLastError();
}

// Backward.  whT_tiled: [G, H/UT, H, UT, 4] with [g, t, kq, u, j] =
// Wh[g, t*UT + u, 4*kq + j].  dh_dir / dc: [G, B, H] fp32 holding dhT / dcT
// on entry; dc holds dc0 on return.  db_part: [G, ceil(B/BT), 4H] fp32,
// zeroed.  Outputs: dxw [T, G, B, 4H] bf16, dh0 [G, B, H], db [G, 4H] fp32.
extern "C" int avsr_lstm_scan_bwd(const void* wh_tiled, const void* whT_tiled,
                                  const void* bias, const void* xw, const void* mask,
                                  const void* h_res, const void* c_res, const void* dys,
                                  void* dh_dir, void* dc, void* db_part, void* dxw,
                                  void* dh0, void* db, int T, int G, int B, int H,
                                  void* stream) {
  if (H % UT != 0 || T < 1) return (int)cudaErrorInvalidValue;
  const dim3 grid(H / UT, (B + BT - 1) / BT, G);
  const dim3 block(THREADS);
  const size_t tile_bytes = (size_t)H * UT * 4 * sizeof(__nv_bfloat16);
  const size_t rows_bytes = (size_t)BT * 4 * H * sizeof(__nv_bfloat16);
  const size_t smem_step = 2 * tile_bytes + rows_bytes +
                           (size_t)BT * H * sizeof(__nv_bfloat16) +
                           (size_t)BT * 4 * UT * sizeof(float);
  const size_t smem_final = tile_bytes + rows_bytes;
  cudaError_t e = cudaFuncSetAttribute(
      lstm_bwd_step_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_step);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(lstm_bwd_final_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_final);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const size_t gbh = (size_t)G * B * H;
  const size_t gb4h = 4 * gbh;
  const __nv_bfloat16* xw_p = static_cast<const __nv_bfloat16*>(xw);
  const float* mask_p = static_cast<const float*>(mask);
  const __nv_bfloat16* hr_p = static_cast<const __nv_bfloat16*>(h_res);
  const __nv_bfloat16* cr_p = static_cast<const __nv_bfloat16*>(c_res);
  const __nv_bfloat16* dys_p = static_cast<const __nv_bfloat16*>(dys);
  __nv_bfloat16* dxw_p = static_cast<__nv_bfloat16*>(dxw);
  for (int t = T - 1; t >= 0; --t) {
    lstm_bwd_step_kernel<<<grid, block, smem_step, st>>>(
        static_cast<const __nv_bfloat16*>(wh_tiled),
        static_cast<const __nv_bfloat16*>(whT_tiled), static_cast<const float*>(bias),
        xw_p + (size_t)t * gb4h, mask_p + (size_t)t * G * B, hr_p + (size_t)t * gbh,
        cr_p + (size_t)t * gbh, dys_p + (size_t)t * gbh,
        t + 1 < T ? dxw_p + (size_t)(t + 1) * gb4h : nullptr, static_cast<float*>(dh_dir),
        static_cast<float*>(dc), static_cast<float*>(db_part), dxw_p + (size_t)t * gb4h, B,
        H);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  lstm_bwd_final_kernel<<<grid, block, smem_final, st>>>(
      static_cast<const __nv_bfloat16*>(whT_tiled), dxw_p, static_cast<const float*>(dh_dir),
      static_cast<const float*>(db_part), static_cast<float*>(dh0), static_cast<float*>(db), B,
      H);
  return (int)cudaGetLastError();
}

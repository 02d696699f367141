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
// Variational recurrent dropout (train mode only; the reference's plain
// scan with recurrent_dropout_masks, avsr_tpu/ops/rnn.py:535-547 one
// direction, :654-668 fused): an optional rd [G, B, H] fp32 mask (0 or
// 1/keep, constant over time, not flipped with the stream) scales the
// recurrent product's operand, which becomes bf16(h * rd), NOT bf16(h) * rd
// (1/keep is not a power of two); the fp32 carry h stays unmasked, and the
// saved residual h_res is that operand, bf16(h * rd).  The backward
// multiplies the cotangent of the operand (dgates @ Wh^T) by rd before it
// adds the carried dh.  With no mask (serving, or rate 0) the factor is 1.0
// and every value keeps its bits.
//
// Two routes, chosen by shape (kernels.lstm_family, the `cluster` argument
// of the entry points below).  Where H is a multiple of 64 from 128 to 384
// (every preset: H = 256), each entry point issues ONE persistent launch of
// thread-block clusters that keep their Wh slices resident in shared memory,
// run the recurrent products on the tensor cores and exchange h (or the
// backward's dh partials) through distributed shared memory
// (lstm_cluster.cuh, which describes it).  Every other H that is a multiple
// of UT = 16 takes the per-step kernels of this file, described next.
//
// What bounds the per-step route on an H100: the recurrence is sequential in
// t, and at B = 128, H = 256, G = 2 one step is only 2 x 128 x 256 x 1024
// MACs (134 MFLOP): too little work to fill 132 SMs, so a step costs launch
// latency, the time to bring each block's Wh slice (32 KB bf16; all of Wh,
// 1 MB, stays in L2) into shared memory, and the shared-memory issue rate of
// the product.  Design: one grid launch per step from a host loop inside
// this file (one ctypes call per layer, not per step).  Each block owns one
// direction, a tile of BT batch rows and a tile of UT hidden units, and
// computes ALL FOUR gates of those units, so the cell update needs nothing
// from other blocks; h is double-buffered in device memory between steps
// (every block reads all H units of its rows' previous h), c is updated in
// place (only its owner reads it).  The wrapper passes Wh pre-tiled as
// [G, H/UT, H, UT, 4] (unit tile, k, unit, gate), so a block's slice is one
// contiguous 16-byte-vectorized copy and each thread reads the four gate
// weights of its unit for one k as a single 8-byte shared-memory load.
// The epilogue's operands (xw, b, c, h, mask) are loaded before the
// product so their latency overlaps it.  The product runs on CUDA cores
// with fp32 FMAs on bf16-rounded operands — exact products, fp32
// accumulation, the reference's numerics.
//
// The fp32 policy (train.compute_dtype = "float32"; avsr_lstm_scan_fwd_f32 /
// _bwd_f32, counted as lstm_scan_f32_*): the per-step kernels' fp32
// instance at every width, G = 2 and no recurrent-dropout mask (the
// one-direction and masked fp32 scans are still to be ported and the
// wrappers raise).  xw, ys, the residuals h_res / c_res, dys and dxw are
// fp32, the products fp32 FMAs on fp32 operands: the reference's
// rnn.py:341-378 and :382-450 with every cast to the compute dtype the
// identity.  A block's fp32 Wh slice is 64 KB at H = 256 (the forward asks
// for 80 KB with h_s, the backward 209 KB with the transposed slice, 16
// dgates rows and h_res), so both opt in above 48 KB and the backward runs
// one block an SM; H is capped at 272 by the backward's shared memory
// (kernels.lstm_family).  At the fast model's shapes (G = 2, B = 128, H =
// 256) each of a step's 256 blocks stages its 64 KB slice from L2 (16 MB a
// step) for 67 M FMAs (134 MFLOP, 2 us at 67 TFLOP/s): the launch and the
// staging bound a step, as on the bf16 per-step route, with twice the bytes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "lstm_cluster.cuh"

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

// The per-step kernels are templated on the element type E of Wh, xw, the
// outputs and the residuals: bf16 (the bf16 policy) or fp32 (the fp32
// policy, train.compute_dtype = "float32": the reference's same lines with
// fp32 operands and no rounding point).  Elem<E> holds what differs: the
// conversions, the staging of h (fp32 carry -> E operand) and the inner
// products over shared memory, which keep the bf16 instance's order.
template <typename E> struct Elem;
template <> struct Elem<__nv_bfloat16> {
  __device__ __forceinline__ static float get(__nv_bfloat16 x) { return __bfloat162float(x); }
  __device__ __forceinline__ static __nv_bfloat16 put(float x) { return __float2bfloat16(x); }
  // four fp32 values to elements 4i..4i+3 of dst
  __device__ __forceinline__ static void put4(__nv_bfloat16* dst, int i, float4 v) {
    __nv_bfloat162* d = reinterpret_cast<__nv_bfloat162*>(dst);
    d[2 * i] = __floats2bfloat162_rn(v.x, v.y);
    d[2 * i + 1] = __floats2bfloat162_rn(v.z, v.w);
  }
  // acc[q] = sum_k hr[k] * w_s[k][u][q]: the four gates of unit u
  __device__ __forceinline__ static void gates(const __nv_bfloat16* h_row, const __nv_bfloat16* w_s, int u, int H,
                               float& a0, float& a1, float& a2, float& a3) {
    const uint32_t* hr = reinterpret_cast<const uint32_t*>(h_row);  // bf16 pairs
    const uint2* wu = reinterpret_cast<const uint2*>(w_s) + u;      // 4 gates / k
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
  // sum_k dg_s[r, k] * Wh[g][unit, k], k over 4H (tiled operand wT_s)
  __device__ __forceinline__ static float dh(const __nv_bfloat16* dg_row, const __nv_bfloat16* wT_s, int u,
                             int H) {
    const uint2* dr = reinterpret_cast<const uint2*>(dg_row);
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
};
template <> struct Elem<float> {
  __device__ __forceinline__ static float get(float x) { return x; }
  __device__ __forceinline__ static float put(float x) { return x; }
  __device__ __forceinline__ static void put4(float* dst, int i, float4 v) {
    reinterpret_cast<float4*>(dst)[i] = v;
  }
  __device__ __forceinline__ static void gates(const float* h_row, const float* w_s, int u, int H, float& a0,
                               float& a1, float& a2, float& a3) {
    const float4* wu = reinterpret_cast<const float4*>(w_s) + u;  // 4 gates / k
#pragma unroll 4
    for (int k = 0; k < H; ++k) {
      const float hk = h_row[k];
      const float4 w = wu[k * UT];
      a0 = fmaf(hk, w.x, a0);
      a1 = fmaf(hk, w.y, a1);
      a2 = fmaf(hk, w.z, a2);
      a3 = fmaf(hk, w.w, a3);
    }
  }
  __device__ __forceinline__ static float dh(const float* dg_row, const float* wT_s, int u, int H) {
    const float4* dr = reinterpret_cast<const float4*>(dg_row);
    const float4* wu = reinterpret_cast<const float4*>(wT_s) + u;
    float a0 = 0.f, a1 = 0.f;
#pragma unroll 4
    for (int kq = 0; kq < H; ++kq) {
      const float4 d = dr[kq];
      const float4 w = wu[kq * UT];
      a0 = fmaf(d.x, w.x, a0);
      a1 = fmaf(d.y, w.y, a1);
      a0 = fmaf(d.z, w.z, a0);
      a1 = fmaf(d.w, w.w, a1);
    }
    return a0 + a1;
  }
};

template <typename E>
__global__ void __launch_bounds__(THREADS)
lstm_step_kernel(const E* __restrict__ wh_tiled,     // [G, H/UT, H, UT, 4]
                 const float* __restrict__ bias,     // [G, 4H]
                 const E* __restrict__ xw_t,         // [G, B, 4H]
                 const float* __restrict__ mask_t,   // [G, B]
                 const float* __restrict__ h_in,     // [G, B, H]
                 float* __restrict__ h_out,          // [G, B, H]
                 float* __restrict__ c,              // [G, B, H] in place
                 E* __restrict__ ys_t,               // [G, B, H]
                 E* __restrict__ h_res_t,            // [G, B, H] or null
                 E* __restrict__ c_res_t,            // [G, B, H] or null
                 const float* __restrict__ rd,       // [G, B, H] or null
                 int B, int H) {
  using X = Elem<E>;
  extern __shared__ __align__(16) unsigned char smem[];
  E* w_s = reinterpret_cast<E*>(smem);   // [H][UT][4]
  E* h_s = w_s + (size_t)H * UT * 4;     // [BT][H]

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
  const E* x = xw_t + gb * H4;
  const float* bb = bias + (size_t)g * H4;
  float xi = 0.f, xf = 0.f, xg = 0.f, xo = 0.f, c_prev = 0.f, h_prev = 0.f, m = 0.f;
  if (live) {
    xi = X::get(x[unit]);
    xf = X::get(x[H + unit]);
    xg = X::get(x[2 * H + unit]);
    xo = X::get(x[3 * H + unit]);
    c_prev = c[s];
    h_prev = h_in[s];
    m = mask_t[gb];
    if (h_res_t != nullptr) {  // residuals for the backward: the product's operand
      h_res_t[s] = X::put(rd != nullptr ? h_prev * rd[s] : h_prev);
      c_res_t[s] = X::put(c_prev);  // and the carry entering step t
    }
  }
  const float bi = bb[unit], bf = bb[H + unit], bg = bb[2 * H + unit], bo = bb[3 * H + unit];

  // This block's Wh slice: one contiguous [H][UT][4] run.
  {
    const uint4* src = reinterpret_cast<const uint4*>(
        wh_tiled + ((size_t)g * (H / UT) + tile) * H * UT * 4);
    uint4* dst = reinterpret_cast<uint4*>(w_s);
    const int n = H * UT * 4 * (int)sizeof(E) / 16;
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
  // The previous h of this block's rows, times the recurrent-dropout mask
  // where there is one, in E (the reference casts h, or h * rd, to the
  // compute dtype before the recurrent product).
  {
    const int per_row = H / 4;
    const int n = BT * per_row;
    for (int c0 = tid; c0 < n; c0 += VEC * THREADS) {
      float4 v[VEC];
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const int ci = c0 + j * THREADS;
        const int rr = ci / per_row;
        const int rrow = row0 + rr;
        v[j] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (ci < n && rrow < B) {
          const size_t ro = ((size_t)g * B + rrow) * H;
          v[j] = reinterpret_cast<const float4*>(h_in + ro)[ci - rr * per_row];
          if (rd != nullptr) {
            const float4 q = reinterpret_cast<const float4*>(rd + ro)[ci - rr * per_row];
            v[j] = make_float4(v[j].x * q.x, v[j].y * q.y, v[j].z * q.z, v[j].w * q.w);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const int ci = c0 + j * THREADS;
        if (ci < n) X::put4(h_s, ci, v[j]);
      }
    }
  }
  __syncthreads();

  // acc[q] = sum_k E(h[row, k]) * Wh[k, q*H + unit]
  float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
  X::gates(h_s + r * H, w_s, u, H, a0, a1, a2, a3);
  if (!live) return;

  const float i = sigmoidf_((xi + a0) + bi);
  const float f = sigmoidf_((xf + a1) + bf);
  const float gt = tanhf((xg + a2) + bg);
  const float o = sigmoidf_((xo + a3) + bo);
  const float c_new = f * c_prev + i * gt;
  const float h_new = o * tanhf(c_new);
  h_out[s] = m * h_new + (1.0f - m) * h_prev;
  c[s] = m * c_new + (1.0f - m) * c_prev;
  ys_t[s] = X::put(h_new * m);
}

// ---------------------------------------------------------------------------
// Backward: replaces avsr_tpu/ops/rnn.py:_bilstm_scan_core_bwd, the reverse
// scan of the hand-written VJP.  Per step t (from T-1 down to 0):
//
//   dh_out = E(dgates[t+1]) @ Wh[g]^T (fp32 accumulate) + dh_direct[t+1]
//   gates recomputed from xw[t], E h_res[t] @ Wh[g] and b; c_prev =
//   float(c_res[t]) (the E-rounded carry, as the reference recomputes)
//   the pointwise backward of rnn.py:405-425 -> fp32 dgates[t];
//   dxw[t] = E(dgates[t]); db += dgates[t] (unrounded, summed over rows)
//   dh_direct[t] = dh_out * (1 - m);  dc <- dc_new * f + dc_out * (1 - m)
//
// and after the loop dh0 = E(dgates[0]) @ Wh[g]^T + dh_direct[0].
// dWh = h_res^T @ dxw over all steps is one large product outside the
// scan (as the reference hoists it), left to the caller.
//
// What bounds the per-step route on an H100: the same as the forward, twice
// over.  A step
// does two [16 x K] x [K x 16]-per-block products (K = 4H for the dh
// product, H per gate for the recompute), each out of a 32 KB operand
// slice staged from L2 (64 KB in fp32), plus one read of the 16 dgates rows
// the previous launch wrote (32 KB; 64 KB): ~104 KB of shared memory per
// block at H = 256, two blocks per SM (fp32: ~209 KB, one).  Design: one
// launch per step from a host loop, like the forward; a
// block owns (direction g, BT batch rows, UT hidden units) and keeps those
// units' fp32 dh_direct / dc carries in device memory (only the owner reads
// them).  The dh product needs all 4H dgates of its rows, written by every
// block in the previous launch: the launch boundary is the only
// synchronisation.  Its operand, rows u0..u0+UT of Wh[g] [H, 4H], is passed
// pre-tiled as [G, H/UT, H, UT, 4] (tile, k quad, unit, k within the quad)
// so a thread reads four consecutive k of its unit as one 8-byte (fp32:
// 16-byte) load and a warp's 16 units are adjacent; the recompute reads the
// forward's tiled slice.  db is summed over the block's rows in shared
// memory and accumulated per (row tile, gate unit) in a buffer the block
// owns, so the final launch reduces BT-row partial sums in a fixed order:
// no atomics, the same bits every run.  Padded rows (mask 0, including rows
// of length 0) produce zero dgates and carry dh/dc through unchanged.
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

template <typename E>
__global__ void __launch_bounds__(THREADS)
lstm_bwd_step_kernel(const E* __restrict__ wh_tiled,    // [G, H/UT, H, UT, 4]
                     const E* __restrict__ whT_tiled,   // [G, H/UT, H, UT, 4]
                     const float* __restrict__ bias,    // [G, 4H]
                     const E* __restrict__ xw_t,        // [G, B, 4H]
                     const float* __restrict__ mask_t,  // [G, B]
                     const E* __restrict__ h_res_t,     // [G, B, H]
                     const E* __restrict__ c_res_t,     // [G, B, H]
                     const E* __restrict__ dys_t,       // [G, B, H]
                     const E* __restrict__ dg_next,     // [G, B, 4H] or null
                     float* __restrict__ dh_dir,        // [G, B, H] in/out
                     float* __restrict__ dc,            // [G, B, H] in/out
                     float* __restrict__ db_part,       // [G, B/BT, 4H]
                     E* __restrict__ dxw_t,             // [G, B, 4H]
                     const float* __restrict__ rd,      // [G, B, H] or null
                     int B, int H) {
  using X = Elem<E>;
  constexpr int EPC = 16 / sizeof(E);  // elements a 16-byte chunk
  extern __shared__ __align__(16) unsigned char smem[];
  const size_t tile_elems = (size_t)H * UT * 4;
  E* wT_s = reinterpret_cast<E*>(smem);  // [H][UT][4]
  E* wf_s = wT_s + tile_elems;           // [H][UT][4]
  E* dg_s = wf_s + tile_elems;           // [BT][4H]
  E* h_s = dg_s + (size_t)BT * 4 * H;    // [BT][H]
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
  const E* x = xw_t + gb * H4;
  const float* bb = bias + (size_t)g * H4;
  float xi = 0.f, xf = 0.f, xg = 0.f, xo = 0.f, c_prev = 0.f, m = 0.f, dy = 0.f;
  float dhd = 0.f, dco = 0.f, rdv = 1.f;
  if (live) {
    if (rd != nullptr) rdv = rd[s];
    xi = X::get(x[unit]);
    xf = X::get(x[H + unit]);
    xg = X::get(x[2 * H + unit]);
    xo = X::get(x[3 * H + unit]);
    c_prev = X::get(c_res_t[s]);
    m = mask_t[gb];
    dy = X::get(dys_t[s]);
    dhd = dh_dir[s];
    dco = dc[s];
  }
  const float bi = bb[unit], bf = bb[H + unit], bg = bb[2 * H + unit], bo = bb[3 * H + unit];

  const size_t tile_off = ((size_t)g * (H / UT) + tile) * tile_elems;
  const int tile_chunks = (int)(tile_elems / EPC);
  stage_contig(reinterpret_cast<uint4*>(wf_s),
               reinterpret_cast<const uint4*>(wh_tiled + tile_off), tile_chunks, tile_chunks,
               tid);
  stage_contig(reinterpret_cast<uint4*>(h_s),
               reinterpret_cast<const uint4*>(h_res_t + ((size_t)g * B + row0) * H),
               BT * H / EPC, nrows * H / EPC, tid);
  if (dg_next != nullptr) {
    stage_contig(reinterpret_cast<uint4*>(wT_s),
                 reinterpret_cast<const uint4*>(whT_tiled + tile_off), tile_chunks,
                 tile_chunks, tid);
    stage_contig(reinterpret_cast<uint4*>(dg_s),
                 reinterpret_cast<const uint4*>(dg_next + ((size_t)g * B + row0) * H4),
                 BT * H4 / EPC, nrows * H4 / EPC, tid);
  }
  __syncthreads();

  // dh_out = (dgates[t+1] @ Wh^T) * rd + dh_direct (rnn.py:427-431; the
  // product is the cotangent of the operand h * rd); at t = T-1 it is dhT.
  const float dh_out =
      (dg_next != nullptr ? X::dh(dg_s + (size_t)r * H4, wT_s, u, H) * rdv : 0.f) + dhd;

  // Gate recompute from the residual h (rnn.py:393-398).
  float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
  X::gates(h_s + r * H, wf_s, u, H, a0, a1, a2, a3);

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
    E* dx = dxw_t + gb * H4;
    dx[unit] = X::put(dgi);
    dx[H + unit] = X::put(dgf);
    dx[2 * H + unit] = X::put(dgg);
    dx[3 * H + unit] = X::put(dgo);
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

// After the reverse loop: dh0 = (dgates[0] @ Wh^T) * rd + dh_direct[0], and
// (row tile 0's blocks) db = sum of the row-tile partials, in row-tile order.
template <typename E>
__global__ void __launch_bounds__(THREADS)
lstm_bwd_final_kernel(const E* __restrict__ whT_tiled,   // [G, H/UT, H, UT, 4]
                      const E* __restrict__ dg0,         // [G, B, 4H]
                      const float* __restrict__ dh_dir,  // [G, B, H]
                      const float* __restrict__ db_part,  // [G, B/BT, 4H]
                      float* __restrict__ dh0,           // [G, B, H]
                      float* __restrict__ db,            // [G, 4H]
                      const float* __restrict__ rd,      // [G, B, H] or null
                      int B, int H) {
  constexpr int EPC = 16 / sizeof(E);
  extern __shared__ __align__(16) unsigned char smem[];
  const size_t tile_elems = (size_t)H * UT * 4;
  E* wT_s = reinterpret_cast<E*>(smem);
  E* dg_s = wT_s + tile_elems;
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
  const int tile_chunks = (int)(tile_elems / EPC);
  stage_contig(reinterpret_cast<uint4*>(wT_s),
               reinterpret_cast<const uint4*>(
                   whT_tiled + ((size_t)g * (H / UT) + tile) * tile_elems),
               tile_chunks, tile_chunks, tid);
  stage_contig(reinterpret_cast<uint4*>(dg_s),
               reinterpret_cast<const uint4*>(dg0 + ((size_t)g * B + row0) * H4),
               BT * H4 / EPC, nrows * H4 / EPC, tid);
  __syncthreads();
  const float acc = Elem<E>::dh(dg_s + (size_t)r * H4, wT_s, u, H);
  if (row < B) {
    const size_t s = ((size_t)g * B + row) * H + unit;
    dh0[s] = (rd != nullptr ? acc * rd[s] : acc) + dh_dir[s];
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

// The per-step route's forward: one launch a step (see above).
template <typename E>
cudaError_t step_fwd(const void* wh_tiled, const void* bias, const void* xw, const void* mask,
                     void* hbuf, void* c, void* ys, void* h_res, void* c_res, const void* rd,
                     int T, int G, int B, int H, cudaStream_t st) {
  if (H % UT != 0) return cudaErrorInvalidValue;
  const dim3 grid(H / UT, (B + BT - 1) / BT, G);
  const dim3 block(THREADS);
  const size_t smem = ((size_t)H * UT * 4 + (size_t)BT * H) * sizeof(E);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        lstm_step_kernel<E>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const size_t gbh = (size_t)G * B * H;
  const E* xw_p = static_cast<const E*>(xw);
  const float* mask_p = static_cast<const float*>(mask);
  float* h_p = static_cast<float*>(hbuf);
  E* ys_p = static_cast<E*>(ys);
  E* hr_p = static_cast<E*>(h_res);
  E* cr_p = static_cast<E*>(c_res);
  const bool save = hr_p != nullptr && cr_p != nullptr;
  for (int t = 0; t < T; ++t) {
    lstm_step_kernel<E><<<grid, block, smem, st>>>(
        static_cast<const E*>(wh_tiled), static_cast<const float*>(bias),
        xw_p + (size_t)t * G * B * 4 * H, mask_p + (size_t)t * G * B,
        h_p + (size_t)(t & 1) * gbh, h_p + (size_t)((t + 1) & 1) * gbh,
        static_cast<float*>(c), ys_p + (size_t)t * gbh,
        save ? hr_p + (size_t)t * gbh : nullptr, save ? cr_p + (size_t)t * gbh : nullptr,
        static_cast<const float*>(rd), B, H);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  return cudaGetLastError();
}

// The per-step route's backward: one launch a step and a final one.
template <typename E>
cudaError_t step_bwd(const void* wh_tiled, const void* whT_tiled, const void* bias,
                     const void* xw, const void* mask, const void* h_res, const void* c_res,
                     const void* dys, void* dh_dir, void* dc, void* db_part, void* dxw,
                     void* dh0, void* db, const void* rd, int T, int G, int B, int H,
                     cudaStream_t st) {
  if (H % UT != 0 || T < 1) return cudaErrorInvalidValue;
  const dim3 grid(H / UT, (B + BT - 1) / BT, G);
  const dim3 block(THREADS);
  const size_t tile_bytes = (size_t)H * UT * 4 * sizeof(E);
  const size_t rows_bytes = (size_t)BT * 4 * H * sizeof(E);
  const size_t smem_step = 2 * tile_bytes + rows_bytes + (size_t)BT * H * sizeof(E) +
                           (size_t)BT * 4 * UT * sizeof(float);
  const size_t smem_final = tile_bytes + rows_bytes;
  cudaError_t e = cudaFuncSetAttribute(
      lstm_bwd_step_kernel<E>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_step);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(lstm_bwd_final_kernel<E>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_final);
  if (e != cudaSuccess) return e;
  const size_t gbh = (size_t)G * B * H;
  const size_t gb4h = 4 * gbh;
  const E* xw_p = static_cast<const E*>(xw);
  const float* mask_p = static_cast<const float*>(mask);
  const E* hr_p = static_cast<const E*>(h_res);
  const E* cr_p = static_cast<const E*>(c_res);
  const E* dys_p = static_cast<const E*>(dys);
  E* dxw_p = static_cast<E*>(dxw);
  for (int t = T - 1; t >= 0; --t) {
    lstm_bwd_step_kernel<E><<<grid, block, smem_step, st>>>(
        static_cast<const E*>(wh_tiled), static_cast<const E*>(whT_tiled),
        static_cast<const float*>(bias), xw_p + (size_t)t * gb4h, mask_p + (size_t)t * G * B,
        hr_p + (size_t)t * gbh, cr_p + (size_t)t * gbh, dys_p + (size_t)t * gbh,
        t + 1 < T ? dxw_p + (size_t)(t + 1) * gb4h : nullptr, static_cast<float*>(dh_dir),
        static_cast<float*>(dc), static_cast<float*>(db_part), dxw_p + (size_t)t * gb4h,
        static_cast<const float*>(rd), B, H);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  lstm_bwd_final_kernel<E><<<grid, block, smem_final, st>>>(
      static_cast<const E*>(whT_tiled), dxw_p, static_cast<const float*>(dh_dir),
      static_cast<const float*>(db_part), static_cast<float*>(dh0), static_cast<float*>(db),
      static_cast<const float*>(rd), B, H);
  return cudaGetLastError();
}

}  // namespace

// The H of the cluster kernels' instances (kernels.lstm_family's rule: a
// multiple of 64 from 128, the backward's shared memory within the card's).
#define AVSR_LSTM_CLUSTER_WIDTHS(X) X(128) X(192) X(256) X(320) X(384)

// Shared memory of one CTA of the cluster kernels at width H, or -1 for a
// width with no instance.
extern "C" long long avsr_lstm_cluster_smem(int H, int backward) {
  switch (H) {
#define AVSR_CASE(W)                                                         \
  case W:                                                                    \
    return (long long)(backward ? lstm_cl::Shape<W>::BWD_SMEM : lstm_cl::Shape<W>::FWD_SMEM);
    AVSR_LSTM_CLUSTER_WIDTHS(AVSR_CASE)
#undef AVSR_CASE
    default:
      return -1;
  }
}

// cudaOccupancyMaxActiveClusters of the cluster forward or backward at
// width H (0 on an error or a width with no instance).
extern "C" int avsr_lstm_cluster_max_active(int H, int backward) {
  switch (H) {
#define AVSR_CASE(W) \
  case W:            \
    return lstm_cl::max_active<W>(backward != 0);
    AVSR_LSTM_CLUSTER_WIDTHS(AVSR_CASE)
#undef AVSR_CASE
    default:
      return 0;
  }
}

// cluster = 0, the per-step route: wh_tiled [G, H/UT, H, UT, 4] bf16 (see
// above; H a multiple of UT).  cluster = 1: wh_tiled is the cluster layout
// [G, 8, H/64, 4, 8, H] (lstm_cluster.cuh) and H one of its instances.
// hbuf: [2][G, B, H] fp32 with h0 in slot 0; after T steps h_T is in slot
// T % 2.  c: [G, B, H] fp32 holding c0 on entry and c_T on return.
// h_res, c_res: [T, G, B, H] bf16 residuals, or both null (no save).
// rd: [G, B, H] fp32 recurrent-dropout mask, or null.
extern "C" int avsr_lstm_scan_fwd(const void* wh_tiled, const void* bias,
                                  const void* xw, const void* mask, void* hbuf,
                                  void* c, void* ys, void* h_res, void* c_res, const void* rd,
                                  int T, int G, int B, int H, int cluster, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (cluster) {
    if (B < 1 || G < 1 || (h_res == nullptr) != (c_res == nullptr))
      return (int)cudaErrorInvalidValue;
    switch (H) {
#define AVSR_CASE(W) \
  case W:            \
    return (int)lstm_cl::fwd<W>(wh_tiled, bias, xw, mask, hbuf, c, ys, h_res, c_res, rd, T, G, \
                                B, st);
      AVSR_LSTM_CLUSTER_WIDTHS(AVSR_CASE)
#undef AVSR_CASE
      default:
        return (int)cudaErrorInvalidValue;
    }
  }
  return (int)step_fwd<__nv_bfloat16>(wh_tiled, bias, xw, mask, hbuf, c, ys, h_res, c_res, rd,
                                       T, G, B, H, st);
}

// The fp32 policy's K1 (G = 2, no recurrent-dropout mask): the per-step
// route's fp32 instance at any H that is a multiple of UT whose backward
// fits a block's shared memory (H <= 272): wh_tiled [G, H/UT, H, UT, 4],
// xw, ys, h_res and c_res fp32, the rest as above.
extern "C" int avsr_lstm_scan_fwd_f32(const void* wh_tiled, const void* bias, const void* xw,
                                      const void* mask, void* hbuf, void* c, void* ys,
                                      void* h_res, void* c_res, int T, int G, int B, int H,
                                      void* stream) {
  if (B < 1 || G < 1 || (h_res == nullptr) != (c_res == nullptr))
    return (int)cudaErrorInvalidValue;
  return (int)step_fwd<float>(wh_tiled, bias, xw, mask, hbuf, c, ys, h_res, c_res, nullptr, T, G,
                              B, H, reinterpret_cast<cudaStream_t>(stream));
}

// Backward.  cluster = 0: whT_tiled [G, H/UT, H, UT, 4] with [g, t, kq, u,
// j] = Wh[g, t*UT + u, 4*kq + j]; dh_dir / dc: [G, B, H] fp32 holding dhT /
// dcT on entry; db_part: [G, ceil(B/BT), 4H] fp32, zeroed.  cluster = 1:
// wh_tiled in the cluster layout, whT_tiled unused, dh_dir read only (dhT),
// db_part [G, ceil(B/16), 4H] scratch.  dc holds dc0 on return.  rd: the
// forward's [G, B, H] fp32 mask, or null.  Outputs: dxw [T, G, B, 4H] bf16,
// dh0 [G, B, H], db [G, 4H] fp32.
extern "C" int avsr_lstm_scan_bwd(const void* wh_tiled, const void* whT_tiled,
                                  const void* bias, const void* xw, const void* mask,
                                  const void* h_res, const void* c_res, const void* dys,
                                  void* dh_dir, void* dc, void* db_part, void* dxw,
                                  void* dh0, void* db, const void* rd, int T, int G, int B,
                                  int H, int cluster, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (cluster) {
    if (T < 1 || B < 1 || G < 1) return (int)cudaErrorInvalidValue;
    switch (H) {
#define AVSR_CASE(W)                                                                   \
  case W:                                                                              \
    return (int)lstm_cl::bwd<W>(wh_tiled, bias, xw, mask, h_res, c_res, dys, dh_dir, dc, \
                                db_part, dxw, dh0, db, rd, T, G, B, st);
      AVSR_LSTM_CLUSTER_WIDTHS(AVSR_CASE)
#undef AVSR_CASE
      default:
        return (int)cudaErrorInvalidValue;
    }
  }
  return (int)step_bwd<__nv_bfloat16>(wh_tiled, whT_tiled, bias, xw, mask, h_res, c_res, dys,
                                       dh_dir, dc, db_part, dxw, dh0, db, rd, T, G, B, H, st);
}

// The fp32 policy's K1 backward on the per-step route: operands as the
// bf16 per-step backward's (whT_tiled, dh_dir / dc holding dhT / dcT,
// db_part zeroed), xw, h_res, c_res, dys and dxw fp32.
extern "C" int avsr_lstm_scan_bwd_f32(const void* wh_tiled, const void* whT_tiled,
                                      const void* bias, const void* xw, const void* mask,
                                      const void* h_res, const void* c_res, const void* dys,
                                      void* dh_dir, void* dc, void* db_part, void* dxw,
                                      void* dh0, void* db, int T, int G, int B, int H,
                                      void* stream) {
  if (B < 1 || G < 1) return (int)cudaErrorInvalidValue;
  return (int)step_bwd<float>(wh_tiled, whT_tiled, bias, xw, mask, h_res, c_res, dys, dh_dir, dc,
                              db_part, dxw, dh0, db, nullptr, T, G, B, H,
                              reinterpret_cast<cudaStream_t>(stream));
}

// K12: direction-batched masked GRU recurrence, forward and backward.
//
// Forward: replaces the scan body of avsr_tpu/ops/rnn.py:gru_scan (its
// gru_step, rnn.py:139-166, over a lax.scan, :555-583), the recurrence of
// every GRU layer of the encoders (cell_type="gru").  The reference runs the
// two directions of a bidirectional layer as two scans (rnn.py:786-799);
// here, as in K1, the backward direction's input product and mask arrive
// flipped in time and one scan serves both (G = 2), which is the same
// function.  Per step t and direction g:
//
//   hw = bf16(h) @ bf16(Wh[g])  (fp32 accumulate; no recurrent bias)
//   x  = float(xw[t,g]) + b[g]                  gate order r, z, n
//   r = sigmoid(x_r + hw_r);  z = sigmoid(x_z + hw_z);  n = tanh(x_n + r * hw_n)
//   h' = (1 - z) * n + z * h
//   m = mask[t,g,b]:  h <- m ? h' : h;  ys[t,g] = bf16(h' * m)
//
// and in save mode (training) each step also writes bf16(h) entering it,
// the product's operand, from which the backward recomputes the gates.
//
// Backward: the reverse scan of JAX's autodiff of that body, transposed
// with its rounding points (the cotangent of bf16(h), the product's operand,
// is rounded to bf16, as the transpose of the cast is; the cotangent of the
// bf16 xw likewise).  Per step t from T-1 down to 0, with D the cotangent
// of the carry leaving step t:
//
//   D = bf16(dhw[t+1] @ Wh^T) + dh_direct[t+1]    (D = dhT at t = T-1)
//   gates recomputed from xw[t], b and float(h_res[t]) @ Wh;  h = h_res[t]
//   dh' = (D + dys[t]) * m;  dh_direct[t] = D * (1 - m) + dh' * z
//   dn = dh' (1 - z) (1 - n^2);  dz = dh' (h - n) z (1 - z)
//   dr = dn * hw_n * r (1 - r);  dhw_n = dn * r
//   dxw[t] = bf16([dr, dz, dn]);  dhw[t] = [dr, dz, dhw_n] (fp32);  db += [dr, dz, dn]
//
// and dh0 = bf16(dhw[0] @ Wh^T) + dh_direct[0].  Unlike K1, dWh is not
// h_res^T dxw: the n block's recurrent cotangent is dn * r, not dn.  So the
// kernel writes dhw [T, G, B, 3H] and dWh = h_res^T dhw is one product over
// all steps, left to the caller.
//
// What bounds it on an H100: as K1's per-step route (lstm_scan.cu), the
// chain of T dependent steps; a step at B = 128, H = 256, G = 2 is only
// 2 x 128 x 256 x 768 MACs, so a step costs launch latency, staging each
// block's Wh slice from L2 and the CUDA-core product.  Design: K1's per-step
// route.  One ctypes call per layer call, one grid launch per step from a
// host loop; a block owns (direction g, BT = 16 batch rows, UT = 16 hidden
// units) and computes all three gates of its units, because each unit's
// gates need only that unit's columns of Wh: the cell update stays in the
// block, and h is double-buffered in device memory between steps.  Wh is
// passed tiled as [G, H/UT, H, UT, 4] (the fourth gate slot zero), so a
// block's slice is one contiguous copy and a thread reads its unit's three
// gate weights for one k as one 8-byte load.  The backward's dh product
// needs all 3H of dhw[t+1] for its rows, written by every block in the
// previous launch: the launch boundary is the only synchronisation; it reads
// Wh^T tiled as [G, H/UT, 3H/4, UT, 4] ([g, t, kq, u, j] = Wh[g, t*UT + u,
// 4 kq + j]) against the fp32 dhw rows.  db is summed per (row tile, gate
// unit) in a buffer the block owns, and the final launch reduces those in
// row-tile order: no atomics, the same bits every run.  Padded rows (mask
// 0, including rows of length 0) give zero dxw and dhw and carry dh through
// unchanged.  The products are exact fp32 FMAs of bf16-rounded operands (the
// backward's dh product of fp32 dhw by bf16 Wh), only summed in another
// order than the reference.
//
// Two routes, chosen by shape (kernels.gru_family): at H a multiple of 128
// from 128 to 384 (every preset's 256) the cluster kernels of
// gru_cluster.cuh (avsr_gru_cluster_*: one persistent launch of 8-CTA
// clusters a call, Wh slices resident in shared memory, the products on the
// tensor cores), which describes them; every other multiple of 16 up to 512
// the per-step kernels below (avsr_gru_scan_*).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gru_cluster.cuh"

namespace {

constexpr int BT = 16;  // batch rows per block
constexpr int UT = 16;  // hidden units per block
constexpr int THREADS = BT * UT;
constexpr int VEC = 8;  // 16-byte loads in flight per thread while staging

__device__ __forceinline__ float sigmoidf_(float x) { return 1.0f / (1.0f + expf(-x)); }
__device__ __forceinline__ float bf_lo(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float bf_hi(uint32_t v) { return __uint_as_float(v & 0xffff0000u); }
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// n 16-byte chunks from src to dst, zeros past n_valid.
__device__ __forceinline__ void stage(uint4* dst, const uint4* src, int n, int n_valid, int tid) {
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

// a[q] = sum_k h_s[r, k] * Wh[k, q*H + unit], q = r, z, n (tiled slice w_s).
__device__ __forceinline__ void gate_product(const __nv_bfloat16* h_s, const __nv_bfloat16* w_s,
                                             int r, int u, int H, float& a0, float& a1,
                                             float& a2) {
  a0 = a1 = a2 = 0.f;
  const uint32_t* hr = reinterpret_cast<const uint32_t*>(h_s + (size_t)r * H);  // bf16 pairs
  const uint2* wu = reinterpret_cast<const uint2*>(w_s) + u;                      // 4 slots / k
#pragma unroll 4
  for (int k2 = 0; k2 < H / 2; ++k2) {
    const uint32_t hh = hr[k2];
    const uint2 w0 = wu[(2 * k2) * UT];
    const uint2 w1 = wu[(2 * k2 + 1) * UT];
    const float h0 = bf_lo(hh), h1 = bf_hi(hh);
    a0 = fmaf(h0, bf_lo(w0.x), a0);
    a1 = fmaf(h0, bf_hi(w0.x), a1);
    a2 = fmaf(h0, bf_lo(w0.y), a2);
    a0 = fmaf(h1, bf_lo(w1.x), a0);
    a1 = fmaf(h1, bf_hi(w1.x), a1);
    a2 = fmaf(h1, bf_lo(w1.y), a2);
  }
}

__global__ void __launch_bounds__(THREADS)
gru_step_kernel(const __nv_bfloat16* __restrict__ wh_tiled,  // [G, H/UT, H, UT, 4]
                const float* __restrict__ bias,              // [G, 3H]
                const __nv_bfloat16* __restrict__ xw_t,      // [G, B, 3H]
                const float* __restrict__ mask_t,            // [G, B]
                const float* __restrict__ h_in,              // [G, B, H]
                float* __restrict__ h_out,                   // [G, B, H]
                __nv_bfloat16* __restrict__ ys_t,            // [G, B, H]
                __nv_bfloat16* __restrict__ h_res_t,         // [G, B, H] or null
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
  const int H3 = 3 * H;

  // Epilogue operands first, so their latency overlaps the staging.
  const size_t gb = (size_t)g * B + (live ? row : 0);
  const size_t s = gb * H + unit;
  const __nv_bfloat16* x = xw_t + gb * H3;
  const float* bb = bias + (size_t)g * H3;
  float xr = 0.f, xz = 0.f, xn = 0.f, h_prev = 0.f, m = 0.f;
  if (live) {
    xr = __bfloat162float(x[unit]) + bb[unit];
    xz = __bfloat162float(x[H + unit]) + bb[H + unit];
    xn = __bfloat162float(x[2 * H + unit]) + bb[2 * H + unit];
    h_prev = h_in[s];
    m = mask_t[gb];
    if (h_res_t != nullptr) h_res_t[s] = __float2bfloat16(h_prev);  // the product's operand
  }

  const int tile_chunks = H * UT * 4 / 8;
  stage(reinterpret_cast<uint4*>(w_s),
        reinterpret_cast<const uint4*>(wh_tiled + ((size_t)g * (H / UT) + tile) * H * UT * 4),
        tile_chunks, tile_chunks, tid);
  // the previous h of this block's rows, rounded to bf16
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
        v[j] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (ci < n && row0 + rr < B)
          v[j] = reinterpret_cast<const float4*>(h_in + ((size_t)g * B + row0 + rr) * H)
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

  float a0, a1, a2;
  gate_product(h_s, w_s, r, u, H, a0, a1, a2);
  if (!live) return;
  const float rg = sigmoidf_(xr + a0);
  const float zg = sigmoidf_(xz + a1);
  const float ng = tanhf(xn + rg * a2);
  const float h_new = (1.0f - zg) * ng + zg * h_prev;
  h_out[s] = m * h_new + (1.0f - m) * h_prev;
  ys_t[s] = __float2bfloat16(h_new * m);
}

// acc = sum_k dhw_s[r, k] * Wh[g][unit, k], k over 3H (fp32 rows, the tiled
// bf16 operand wT_s [3H/4][UT][4]).
__device__ __forceinline__ float dh_product(const float* dg_s, const __nv_bfloat16* wT_s, int r,
                                            int u, int H) {
  const float4* dr = reinterpret_cast<const float4*>(dg_s + (size_t)r * 3 * H);
  const uint2* wu = reinterpret_cast<const uint2*>(wT_s) + u;
  float a0 = 0.f, a1 = 0.f;
#pragma unroll 4
  for (int kq = 0; kq < 3 * H / 4; ++kq) {
    const float4 d = dr[kq];
    const uint2 w = wu[kq * UT];
    a0 = fmaf(d.x, bf_lo(w.x), a0);
    a1 = fmaf(d.y, bf_hi(w.x), a1);
    a0 = fmaf(d.z, bf_lo(w.y), a0);
    a1 = fmaf(d.w, bf_hi(w.y), a1);
  }
  return a0 + a1;
}

__global__ void __launch_bounds__(THREADS)
gru_bwd_step_kernel(const __nv_bfloat16* __restrict__ wh_tiled,   // [G, H/UT, H, UT, 4]
                    const __nv_bfloat16* __restrict__ whT_tiled,  // [G, H/UT, 3H/4, UT, 4]
                    const float* __restrict__ bias,               // [G, 3H]
                    const __nv_bfloat16* __restrict__ xw_t,       // [G, B, 3H]
                    const float* __restrict__ mask_t,             // [G, B]
                    const __nv_bfloat16* __restrict__ h_res_t,    // [G, B, H]
                    const __nv_bfloat16* __restrict__ dys_t,      // [G, B, H]
                    const float* __restrict__ dhw_next,           // [G, B, 3H] or null
                    float* __restrict__ dh_dir,                   // [G, B, H] in/out
                    float* __restrict__ db_part,                  // [G, B/BT, 3H]
                    __nv_bfloat16* __restrict__ dxw_t,            // [G, B, 3H]
                    float* __restrict__ dhw_t,                    // [G, B, 3H]
                    int B, int H) {
  extern __shared__ __align__(16) unsigned char smem[];
  const size_t tile_elems = (size_t)H * UT * 4;
  const size_t tileT_elems = (size_t)3 * H * UT;
  float* dg_s = reinterpret_cast<float*>(smem);                            // [BT][3H]
  float* red_s = dg_s + (size_t)BT * 3 * H;                                // [BT][3][UT]
  __nv_bfloat16* wf_s = reinterpret_cast<__nv_bfloat16*>(red_s + BT * 3 * UT);  // [H][UT][4]
  __nv_bfloat16* wT_s = wf_s + tile_elems;                                 // [3H/4][UT][4]
  __nv_bfloat16* h_s = wT_s + tileT_elems;                                 // [BT][H]

  const int g = blockIdx.z;
  const int tile = blockIdx.x;
  const int row0 = blockIdx.y * BT;
  const int tid = threadIdx.x;
  const int r = tid / UT;
  const int u = tid - r * UT;
  const int row = row0 + r;
  const int unit = tile * UT + u;
  const bool live = row < B;
  const int H3 = 3 * H;
  const int nrows = min(BT, B - row0);

  const size_t gb = (size_t)g * B + (live ? row : 0);
  const size_t s = gb * H + unit;
  const __nv_bfloat16* x = xw_t + gb * H3;
  const float* bb = bias + (size_t)g * H3;
  float xr = 0.f, xz = 0.f, xn = 0.f, h_prev = 0.f, m = 0.f, dy = 0.f, dhd = 0.f;
  if (live) {
    xr = __bfloat162float(x[unit]) + bb[unit];
    xz = __bfloat162float(x[H + unit]) + bb[H + unit];
    xn = __bfloat162float(x[2 * H + unit]) + bb[2 * H + unit];
    h_prev = __bfloat162float(h_res_t[s]);
    m = mask_t[gb];
    dy = __bfloat162float(dys_t[s]);
    dhd = dh_dir[s];
  }

  stage(reinterpret_cast<uint4*>(wf_s),
        reinterpret_cast<const uint4*>(wh_tiled + ((size_t)g * (H / UT) + tile) * tile_elems),
        (int)(tile_elems / 8), (int)(tile_elems / 8), tid);
  stage(reinterpret_cast<uint4*>(h_s),
        reinterpret_cast<const uint4*>(h_res_t + ((size_t)g * B + row0) * H), BT * H / 8,
        nrows * H / 8, tid);
  if (dhw_next != nullptr) {
    stage(reinterpret_cast<uint4*>(wT_s),
          reinterpret_cast<const uint4*>(whT_tiled + ((size_t)g * (H / UT) + tile) * tileT_elems),
          (int)(tileT_elems / 8), (int)(tileT_elems / 8), tid);
    stage(reinterpret_cast<uint4*>(dg_s),
          reinterpret_cast<const uint4*>(dhw_next + ((size_t)g * B + row0) * H3), BT * H3 / 4,
          nrows * H3 / 4, tid);
  }
  __syncthreads();

  // D: the cotangent of the carry leaving step t; the product's part is the
  // cotangent of bf16(h_{t+1}), rounded as the transposed cast rounds it
  const float d_out =
      (dhw_next != nullptr ? round_bf16(dh_product(dg_s, wT_s, r, u, H)) : 0.f) + dhd;

  float a0, a1, a2;
  gate_product(h_s, wf_s, r, u, H, a0, a1, a2);

  float dr = 0.f, dz = 0.f, dn = 0.f;
  if (live) {
    const float rg = sigmoidf_(xr + a0);
    const float zg = sigmoidf_(xz + a1);
    const float ng = tanhf(xn + rg * a2);
    const float dh_new = (d_out + dy) * m;
    dh_dir[s] = d_out * (1.0f - m) + dh_new * zg;
    dn = dh_new * (1.0f - zg) * (1.0f - ng * ng);
    dz = dh_new * (h_prev - ng) * zg * (1.0f - zg);
    dr = dn * a2 * rg * (1.0f - rg);
    __nv_bfloat16* dx = dxw_t + gb * H3;
    dx[unit] = __float2bfloat16(dr);
    dx[H + unit] = __float2bfloat16(dz);
    dx[2 * H + unit] = __float2bfloat16(dn);
    float* dw = dhw_t + gb * H3;
    dw[unit] = dr;
    dw[H + unit] = dz;
    dw[2 * H + unit] = dn * rg;
  }
  red_s[(r * 3 + 0) * UT + u] = dr;
  red_s[(r * 3 + 1) * UT + u] = dz;
  red_s[(r * 3 + 2) * UT + u] = dn;
  __syncthreads();
  if (tid < 3 * UT) {  // db: this block's rows, unrounded cotangents
    const int q = tid / UT, uu = tid - q * UT;
    float acc = 0.f;
    for (int rr = 0; rr < BT; ++rr) acc += red_s[(rr * 3 + q) * UT + uu];
    db_part[((size_t)g * gridDim.y + blockIdx.y) * H3 + q * H + tile * UT + uu] += acc;
  }
}

// After the reverse loop: dh0 = bf16(dhw[0] @ Wh^T) + dh_direct[0], and (row
// tile 0's blocks) db = sum of the row-tile partials, in row-tile order.
__global__ void __launch_bounds__(THREADS)
gru_bwd_final_kernel(const __nv_bfloat16* __restrict__ whT_tiled,  // [G, H/UT, 3H/4, UT, 4]
                     const float* __restrict__ dhw0,               // [G, B, 3H]
                     const float* __restrict__ dh_dir,             // [G, B, H]
                     const float* __restrict__ db_part,            // [G, B/BT, 3H]
                     float* __restrict__ dh0,                      // [G, B, H]
                     float* __restrict__ db,                       // [G, 3H]
                     int B, int H) {
  extern __shared__ __align__(16) unsigned char smem[];
  const size_t tileT_elems = (size_t)3 * H * UT;
  float* dg_s = reinterpret_cast<float*>(smem);                         // [BT][3H]
  __nv_bfloat16* wT_s = reinterpret_cast<__nv_bfloat16*>(dg_s + (size_t)BT * 3 * H);
  const int g = blockIdx.z;
  const int tile = blockIdx.x;
  const int row0 = blockIdx.y * BT;
  const int tid = threadIdx.x;
  const int r = tid / UT;
  const int u = tid - r * UT;
  const int row = row0 + r;
  const int unit = tile * UT + u;
  const int H3 = 3 * H;
  const int nrows = min(BT, B - row0);
  stage(reinterpret_cast<uint4*>(wT_s),
        reinterpret_cast<const uint4*>(whT_tiled + ((size_t)g * (H / UT) + tile) * tileT_elems),
        (int)(tileT_elems / 8), (int)(tileT_elems / 8), tid);
  stage(reinterpret_cast<uint4*>(dg_s),
        reinterpret_cast<const uint4*>(dhw0 + ((size_t)g * B + row0) * H3), BT * H3 / 4,
        nrows * H3 / 4, tid);
  __syncthreads();
  const float acc = round_bf16(dh_product(dg_s, wT_s, r, u, H));
  if (row < B) {
    const size_t s = ((size_t)g * B + row) * H + unit;
    dh0[s] = acc + dh_dir[s];
  }
  if (blockIdx.y == 0 && tid < 3 * UT) {
    const int q = tid / UT, uu = tid - q * UT;
    const int col = q * H + tile * UT + uu;
    float sum = 0.f;
    for (int rt = 0; rt < (int)gridDim.y; ++rt)
      sum += db_part[((size_t)g * gridDim.y + rt) * H3 + col];
    db[(size_t)g * H3 + col] = sum;
  }
}

size_t fwd_smem(int H) { return ((size_t)H * UT * 4 + (size_t)BT * H) * sizeof(__nv_bfloat16); }

size_t bwd_smem(int H) {
  return ((size_t)BT * 3 * H + (size_t)BT * 3 * UT) * sizeof(float) +
         ((size_t)H * UT * 4 + (size_t)3 * H * UT + (size_t)BT * H) * sizeof(__nv_bfloat16);
}

size_t final_smem(int H) {
  return (size_t)BT * 3 * H * sizeof(float) + (size_t)3 * H * UT * sizeof(__nv_bfloat16);
}

}  // namespace

// Shared memory of one block of the forward (backward = 0) or backward
// step kernel at width H (the backward's final kernel takes less).
extern "C" long long avsr_gru_step_smem(int H, int backward) {
  return (long long)(backward ? bwd_smem(H) : fwd_smem(H));
}

// Forward.  wh_tiled [G, H/UT, H, UT, 4] bf16 (slot 3 zero), bias [G, 3H]
// fp32, xw [T, G, B, 3H] bf16, mask [T, G, B] fp32; hbuf [2][G, B, H] fp32
// with h0 in slot 0, h_T in slot T % 2 after T steps; ys [T, G, B, H] bf16;
// h_res [T, G, B, H] bf16 or null (no save).  H a multiple of UT.
extern "C" int avsr_gru_scan_fwd(const void* wh_tiled, const void* bias, const void* xw,
                                 const void* mask, void* hbuf, void* ys, void* h_res, int T,
                                 int G, int B, int H, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (H % UT != 0 || H < UT || B < 1 || G < 1) return (int)cudaErrorInvalidValue;
  const dim3 grid(H / UT, (B + BT - 1) / BT, G);
  const size_t smem = fwd_smem(H);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(gru_step_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const size_t gbh = (size_t)G * B * H;
  const __nv_bfloat16* xw_p = static_cast<const __nv_bfloat16*>(xw);
  const float* mask_p = static_cast<const float*>(mask);
  float* h_p = static_cast<float*>(hbuf);
  __nv_bfloat16* ys_p = static_cast<__nv_bfloat16*>(ys);
  __nv_bfloat16* hr_p = static_cast<__nv_bfloat16*>(h_res);
  for (int t = 0; t < T; ++t) {
    gru_step_kernel<<<grid, THREADS, smem, st>>>(
        static_cast<const __nv_bfloat16*>(wh_tiled), static_cast<const float*>(bias),
        xw_p + (size_t)t * 3 * gbh, mask_p + (size_t)t * G * B, h_p + (size_t)(t & 1) * gbh,
        h_p + (size_t)((t + 1) & 1) * gbh, ys_p + (size_t)t * gbh,
        hr_p != nullptr ? hr_p + (size_t)t * gbh : nullptr, B, H);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaGetLastError();
}

// Backward.  whT_tiled [G, H/UT, 3H/4, UT, 4] bf16 with [g, t, kq, u, j] =
// Wh[g, t*UT + u, 4*kq + j]; h_res, dys [T, G, B, H] bf16; dh_dir [G, B, H]
// fp32 holding dhT on entry (overwritten); db_part [G, ceil(B/BT), 3H] fp32,
// zeroed.  Outputs: dxw [T, G, B, 3H] bf16, dhw [T, G, B, 3H] fp32, dh0
// [G, B, H] and db [G, 3H] fp32.
extern "C" int avsr_gru_scan_bwd(const void* wh_tiled, const void* whT_tiled, const void* bias,
                                 const void* xw, const void* mask, const void* h_res,
                                 const void* dys, void* dh_dir, void* db_part, void* dxw,
                                 void* dhw, void* dh0, void* db, int T, int G, int B, int H,
                                 void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (H % UT != 0 || H < UT || T < 1 || B < 1 || G < 1) return (int)cudaErrorInvalidValue;
  const dim3 grid(H / UT, (B + BT - 1) / BT, G);
  cudaError_t e = cudaFuncSetAttribute(gru_bwd_step_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)bwd_smem(H));
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(gru_bwd_final_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)final_smem(H));
  if (e != cudaSuccess) return (int)e;
  const size_t gbh = (size_t)G * B * H;
  const __nv_bfloat16* xw_p = static_cast<const __nv_bfloat16*>(xw);
  const float* mask_p = static_cast<const float*>(mask);
  const __nv_bfloat16* hr_p = static_cast<const __nv_bfloat16*>(h_res);
  const __nv_bfloat16* dys_p = static_cast<const __nv_bfloat16*>(dys);
  __nv_bfloat16* dxw_p = static_cast<__nv_bfloat16*>(dxw);
  float* dhw_p = static_cast<float*>(dhw);
  for (int t = T - 1; t >= 0; --t) {
    gru_bwd_step_kernel<<<grid, THREADS, bwd_smem(H), st>>>(
        static_cast<const __nv_bfloat16*>(wh_tiled),
        static_cast<const __nv_bfloat16*>(whT_tiled), static_cast<const float*>(bias),
        xw_p + (size_t)t * 3 * gbh, mask_p + (size_t)t * G * B, hr_p + (size_t)t * gbh,
        dys_p + (size_t)t * gbh, t + 1 < T ? dhw_p + (size_t)(t + 1) * 3 * gbh : nullptr,
        static_cast<float*>(dh_dir), static_cast<float*>(db_part), dxw_p + (size_t)t * 3 * gbh,
        dhw_p + (size_t)t * 3 * gbh, B, H);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  gru_bwd_final_kernel<<<grid, THREADS, final_smem(H), st>>>(
      static_cast<const __nv_bfloat16*>(whT_tiled), dhw_p, static_cast<const float*>(dh_dir),
      static_cast<const float*>(db_part), static_cast<float*>(dh0), static_cast<float*>(db), B,
      H);
  return (int)cudaGetLastError();
}

// The H of the cluster kernels' instances (kernels.gru_family's rule: a
// multiple of 128 from 128, the backward's shared memory within the card's).
#define AVSR_GRU_CLUSTER_WIDTHS(X) X(128) X(256) X(384)

// Shared memory of one CTA of the cluster kernels at width H
// (``kernels.gru_cluster_smem``), or -1 for a width with no instance.
extern "C" long long avsr_gru_cluster_smem(int H, int backward) {
  switch (H) {
#define AVSR_CASE(W) \
  case W:            \
    return (long long)(backward ? gru_cl::Shape<W>::BWD_SMEM : gru_cl::Shape<W>::FWD_SMEM);
    AVSR_GRU_CLUSTER_WIDTHS(AVSR_CASE)
#undef AVSR_CASE
    default:
      return -1;
  }
}

// cudaOccupancyMaxActiveClusters of the cluster forward or backward at
// width H (0 on an error or a width with no instance).
extern "C" int avsr_gru_cluster_max_active(int H, int backward) {
  switch (H) {
#define AVSR_CASE(W) \
  case W:            \
    return gru_cl::max_active<W>(backward != 0);
    AVSR_GRU_CLUSTER_WIDTHS(AVSR_CASE)
#undef AVSR_CASE
    default:
      return 0;
  }
}

// Forward on the cluster route, one launch.  wcl: Wh in the cluster layout
// [G, 8, H/64, 3, 8, H] bf16 (kernels.cluster_gru_weights); hbuf [2][G, B,
// H] fp32 with h0 in slot 0, h_T in slot T % 2 after T steps; the other
// operands as avsr_gru_scan_fwd's.
extern "C" int avsr_gru_cluster_fwd(const void* wcl, const void* bias, const void* xw,
                                    const void* mask, void* hbuf, void* ys, void* h_res, int T,
                                    int G, int B, int H, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (T < 0 || G < 1 || B < 1) return (int)cudaErrorInvalidValue;
  switch (H) {
#define AVSR_CASE(W) \
  case W:            \
    return (int)gru_cl::fwd<W>(wcl, bias, xw, mask, hbuf, ys, h_res, T, G, B, st);
    AVSR_GRU_CLUSTER_WIDTHS(AVSR_CASE)
#undef AVSR_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Backward on the cluster route, two launches: the reverse scan and the row
// tiles' db reduced in order.  wcl in the cluster layout; dhT [G, B, H]
// fp32 (read only); db_part [G, ceil(B/16), 3H] fp32 scratch; outputs as
// avsr_gru_scan_bwd's.
extern "C" int avsr_gru_cluster_bwd(const void* wcl, const void* bias, const void* xw,
                                    const void* mask, const void* h_res, const void* dys,
                                    const void* dhT, void* db_part, void* dxw, void* dhw,
                                    void* dh0, void* db, int T, int G, int B, int H,
                                    void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (T < 1 || G < 1 || B < 1) return (int)cudaErrorInvalidValue;
  switch (H) {
#define AVSR_CASE(W)                                                                       \
  case W:                                                                                  \
    return (int)gru_cl::bwd<W>(wcl, bias, xw, mask, h_res, dys, dhT, db_part, dxw, dhw, dh0, \
                               db, T, G, B, st);
    AVSR_GRU_CLUSTER_WIDTHS(AVSR_CASE)
#undef AVSR_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

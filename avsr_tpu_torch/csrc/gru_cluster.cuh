// K12 on thread-block clusters: the masked GRU recurrence, forward and
// backward, as one persistent launch per layer call (gru_scan.cu's
// avsr_gru_cluster_* entry points; kernels.gru_family says "cluster": H a
// multiple of 128 from 128 to 384, every preset's H = 256).  The functions
// are gru_scan.cu's (its header comment): avsr_tpu/ops/rnn.py:gru_scan's
// lax.scan over gru_step (rnn.py:139-166, :555-594) forward, and the reverse
// scan of JAX's autodiff of that body backward.
//
// What bounds it on an H100: the chain of T dependent steps.  The per-step
// route paid a launch a step (2T + 1 a backward call), staged each block's
// Wh slice from L2 every launch and multiplied on the CUDA cores: 12.1 us a
// step forward, 31.7 backward at [197, 2, 128, 256].  Here a step is K1's
// (lstm_cluster.cuh): the product out of shared memory on the tensor cores
// and one exchange between the SMs of a cluster.
//
// Geometry: K1's with three gates.  A cluster of C = 8 CTAs owns one
// (direction g, tile of BR = 16 batch rows) for all T steps; CTA r owns the
// UR = H/8 units [r UR, (r+1) UR) with their r, z and n gates and keeps its
// Wh[g] slice (3 UR x H bf16, 48 KB at H = 256; kernels.cluster_gru_weights:
// [g, r, w, q, j, k] = Wh[g, k, q H + r UR + 8 w + j]) resident in shared
// memory, column-major and swizzled, so that ldmatrix feeds the forward's
// bf16(h) . Wh and ldmatrix.trans the backward's dhw . Wh^T from the same
// bytes.  Warp w owns 8 units, its 24 slice columns ordered [gate][unit]: a
// thread's m16n8k16 C fragments hold the r, z and n products of (rows gid,
// gid + 8) x (units 2 tig, 2 tig + 1), and hw_n stays apart from x_n, as
// n = tanh(x_n + r hw_n) needs.  3 UR must be a multiple of 16 (the
// backward's k-steps over the slice columns): H a multiple of 128.
//
// Forward step t: wait for bf16(h_t) in slot t % 2; hw = bf16(h) . Wh (fp32
// accumulators); r, z, n and h' = (1 - z) n + z h on the fp32 carry; the
// masked carry; bf16(h_{t+1}) to every peer by st.async into slot (t+1) % 2
// under mbarriers, as in K1.  Save mode writes h_res[t] = bf16(h_t), the
// product's operand.
//
// Backward step t (from T-1 down): D = bf16(sum in rank order of the 8 CTAs'
// partial dhw[t+1] . slice^T) + dh_direct (D = dhT at t = T-1); the gates
// recomputed a step ahead from h_res with the resident slice (the
// forward's product on the same operand and slice: the same bits); dh' = (D
// + dys[t]) m; dh_direct = D (1 - m) + dh' z; dn, dz, dr; dhw = [dr, dz,
// dn r] (fp32: the recurrent product's cotangent, whose n block is not
// dxw's), dxw[t] = bf16([dr, dz, dn]), db in registers; the partial dh
// products to their owners (K1's reduce-scatter).  dhw is also written to
// device memory for the caller's dWh = h_res^T dhw.  One launch a call
// replaces the 2T + 1 of the per-step route; db is summed per (g, row
// tile), then over tiles in order by a small launch: no atomics.
//
// The fp32 cotangent operand.  JAX's transpose of dot(bf16 h, bf16 Wh,
// preferred_element_type=f32) is dot_general(f32 dhw, bf16 Wh) rounded to
// bf16 once at the end, so dhw is not rounded before the product.  Each dhw
// is split into hi = bf16(dhw) and lo = bf16(dhw - hi), and two mma.syncs
// (hi . slice^T, lo . slice^T) accumulate into one fp32 sum: 16 significant
// bits of dhw (the residual is below 2^-16 |dhw|, far under the final bf16
// rounding), at twice the tensor-core work of the dh product (12 k-steps a
// warp instead of 6 at H = 256) and a second 4 KB tile.
//
// Rows past B run on zeros and write nothing; masked steps carry h (dh)
// through bit for bit; a 0-length row keeps h0 and passes dhT.

#pragma once

#include "lstm_cluster.cuh"

namespace {
namespace gru_cl {

using lstm_cl::BR;
using lstm_cl::C;
using lstm_cl::bf_at;
using lstm_cl::sigm;
using lstm_cl::tanh_;
using mma_attn::bf16;
using mma_attn::ldsm_x4;
using mma_attn::mma;
using mma_attn::pack_bf16;
using mma_attn::smem_addr;
using mma_attn::swz;
using cluster_ptx::cluster_arrive;
using cluster_ptx::cluster_rank;
using cluster_ptx::cluster_wait;
using cluster_ptx::fence_mbar_init;
using cluster_ptx::map_rank;
using cluster_ptx::mbar_expect;
using cluster_ptx::mbar_init;
using cluster_ptx::mbar_wait;
using cluster_ptx::st_async_b32;

template <int H>
struct Shape {
  static constexpr int UR = H / C;           // hidden units per CTA
  static constexpr int NW = UR / 8;          // warps: 8 units (24 slice columns) each
  static constexpr int THREADS = 32 * NW;
  static constexpr int NCOL = 3 * UR;        // slice columns: 3 gates of UR units
  static constexpr int DGP = (NCOL + 63) / 64 * 64;  // dhw tile pitch: 8 swizzle chunks a row
  static constexpr size_t W_BYTES = (size_t)NCOL * H * 2;
  static constexpr size_t HT_BYTES = (size_t)BR * H * 2;
  static constexpr size_t DG_BYTES = (size_t)BR * DGP * 2;
  static constexpr size_t RED_BYTES = (size_t)C * BR * UR * 4;
  static constexpr size_t FWD_SMEM = W_BYTES + 2 * HT_BYTES + 2 * 8;
  static constexpr size_t BWD_SMEM = W_BYTES + HT_BYTES + 2 * DG_BYTES + 2 * RED_BYTES + 2 * 8;
  static_assert(H % 128 == 0, "8 units a warp; the slice's 3 UR columns in 16-column k-steps");
};

__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}

// acc[q][e] = sum_k h[row, k] Wh[k, q*H + unit], q = r, z, n, over the
// tile's rows and the warp's 8 units (e as in K1's gate_product)
template <int H>
__device__ __forceinline__ void gate_product(const bf16* ht, const bf16* ws, int warp, int lane,
                                             float (&acc)[3][4]) {
  float acc2[2][3][4];  // even and odd k steps: two chains of half the depth
#pragma unroll
  for (int c = 0; c < 2; ++c)
#pragma unroll
    for (int q = 0; q < 3; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc2[c][q][e] = 0.f;
  const int arow = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int achunk = lane >> 4;
  const int brow = warp * 24 + (lane & 7) + (lane >> 4) * 8;  // gates r, z
  const int nrow = warp * 24 + 16 + (lane & 7);               // gate n (lanes 0-15)
  const int bchunk = (lane >> 3) & 1;
#pragma unroll
  for (int kk = 0; kk < H / 16; ++kk) {
    uint32_t a[4], b[4], bn[2];
    ldsm_x4(a, ht + swz<H>(arow, kk * 2 + achunk));
    ldsm_x4(b, ws + swz<H>(brow, kk * 2 + bchunk));
    ldsm_x2(bn, ws + swz<H>(nrow, kk * 2 + bchunk));
    mma(acc2[kk & 1][0], a, b[0], b[1]);
    mma(acc2[kk & 1][1], a, b[2], b[3]);
    mma(acc2[kk & 1][2], a, bn[0], bn[1]);
  }
#pragma unroll
  for (int q = 0; q < 3; ++q)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[q][e] = acc2[0][q][e] + acc2[1][q][e];
}

// ---- forward ----------------------------------------------------------------

template <int H>
__global__ void __launch_bounds__(Shape<H>::THREADS, 1)
gru_cluster_fwd(const bf16* __restrict__ wcl,    // [G, C, NCOL, H]
                const float* __restrict__ bias,  // [G, 3H]
                const bf16* __restrict__ xw,     // [T, G, B, 3H]
                const float* __restrict__ mask,  // [T, G, B]
                float* __restrict__ hbuf,        // [2, G, B, H]: h0 in slot 0; hT to slot T % 2
                bf16* __restrict__ ys,           // [T, G, B, H]
                bf16* __restrict__ h_res,        // [T, G, B, H] or null
                int T, int G, int B) {
  using S = Shape<H>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ws = reinterpret_cast<bf16*>(smem);
  bf16* hs = ws + S::NCOL * H;                                    // [2][BR][H]
  uint64_t* full = reinterpret_cast<uint64_t*>(hs + 2 * BR * H);  // [2]: slot s's h arrived

  const int rank = (int)cluster_rank();
  const int g = blockIdx.y;
  const int row0 = (blockIdx.x / C) * BR;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int unit = rank * S::UR + warp * 8 + 2 * tig;
  const int rows[2] = {row0 + gid, row0 + gid + 8};
  const bool live[2] = {rows[0] < B, rows[1] < B};
  const int H3 = 3 * H;
  const bool save = h_res != nullptr;

  lstm_cl::stage_slice<H, S::NCOL>(ws, wcl + ((size_t)g * C + rank) * S::NCOL * H, tid);
  const float* h0 = hbuf + (size_t)g * B * H;
  for (int i = tid; i < BR * H / 2; i += S::THREADS) {
    const int r = i / (H / 2), k = 2 * (i - r * (H / 2));
    float2 v = make_float2(0.f, 0.f);
    if (row0 + r < B) v = *reinterpret_cast<const float2*>(h0 + (size_t)(row0 + r) * H + k);
    *reinterpret_cast<uint32_t*>(hs + swz<H>(r, k >> 3) + (k & 7)) = pack_bf16(v.x, v.y);
  }
  float h[4], bq[3][2];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const size_t o = ((size_t)g * B + (live[e >> 1] ? rows[e >> 1] : 0)) * H + unit + (e & 1);
    h[e] = live[e >> 1] ? hbuf[o] : 0.f;
  }
#pragma unroll
  for (int q = 0; q < 3; ++q)
#pragma unroll
    for (int j = 0; j < 2; ++j) bq[q][j] = bias[(size_t)g * H3 + q * H + unit + j];

  uint32_t xc[2][3], xn[2][3];
  float mc[2], mn[2];
  auto load_step = [&](int t, uint32_t (&x)[2][3], float (&m)[2]) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const size_t gb = ((size_t)t * G + g) * B + rows[r];
#pragma unroll
      for (int q = 0; q < 3; ++q)
        x[r][q] = live[r] ? *reinterpret_cast<const uint32_t*>(xw + gb * H3 + q * H + unit) : 0u;
      m[r] = live[r] ? mask[gb] : 0.f;
    }
  };
  if (T > 0) load_step(0, xc, mc);
  if (tid == 0) {
    mbar_init(&full[0], 1);
    mbar_init(&full[1], 1);
    fence_mbar_init();
  }
  mma_attn::cp_async_wait<0>();
  cluster_arrive();
  cluster_wait();

  for (int t = 0; t < T; ++t) {
    const int slot = t & 1;
    if (t > 0) {
      if (tid == 0) mbar_expect(&full[slot], (uint32_t)S::HT_BYTES);
      mbar_wait(&full[slot], ((t - 1) >> 1) & 1);
    }
    if (t + 1 < T) load_step(t + 1, xn, mn);
    float acc[3][4];
    gate_product<H>(hs + slot * BR * H, ws, warp, lane, acc);

    uint32_t hpk[2], ypk[2], hrpk[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float y[2], hin[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int e = 2 * r + j;
        const float rg = sigm((bf_at(xc[r][0], j) + bq[0][j]) + acc[0][e]);
        const float zg = sigm((bf_at(xc[r][1], j) + bq[1][j]) + acc[1][e]);
        const float ng = tanh_((bf_at(xc[r][2], j) + bq[2][j]) + rg * acc[2][e]);
        const float h_new = (1.0f - zg) * ng + zg * h[e];
        const float m = mc[r];
        hin[j] = h[e];
        y[j] = h_new * m;
        h[e] = m * h_new + (1.0f - m) * h[e];
      }
      hpk[r] = pack_bf16(h[2 * r], h[2 * r + 1]);
      ypk[r] = pack_bf16(y[0], y[1]);
      hrpk[r] = pack_bf16(hin[0], hin[1]);
    }
    if (t + 1 < T) {
      bf16* nt = hs + (slot ^ 1) * BR * H;
      const uint32_t a0 = smem_addr(nt + swz<H>(gid, unit >> 3) + (unit & 7));
      const uint32_t a1 = smem_addr(nt + swz<H>(gid + 8, unit >> 3) + (unit & 7));
      const uint32_t bar = smem_addr(&full[slot ^ 1]);
#pragma unroll
      for (int p = 0; p < C; ++p) {
        const uint32_t pbar = map_rank(bar, p);
        st_async_b32(map_rank(a0, p), hpk[0], pbar);
        st_async_b32(map_rank(a1, p), hpk[1], pbar);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (!live[r]) continue;
      const size_t o = (((size_t)t * G + g) * B + rows[r]) * H + unit;
      *reinterpret_cast<uint32_t*>(ys + o) = ypk[r];
      if (save) *reinterpret_cast<uint32_t*>(h_res + o) = hrpk[r];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mc[r] = mn[r];
#pragma unroll
      for (int q = 0; q < 3; ++q) xc[r][q] = xn[r][q];
    }
  }
  cluster_arrive();
  cluster_wait();

  float* hT = hbuf + (size_t)(T & 1) * G * B * H;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    if (!live[e >> 1]) continue;
    hT[((size_t)g * B + rows[e >> 1]) * H + unit + (e & 1)] = h[e];
  }
}

// ---- backward ---------------------------------------------------------------

template <int H>
__global__ void __launch_bounds__(Shape<H>::THREADS, 1)
gru_cluster_bwd(const bf16* __restrict__ wcl,    // [G, C, NCOL, H]
                const float* __restrict__ bias,  // [G, 3H]
                const bf16* __restrict__ xw,     // [T, G, B, 3H]
                const float* __restrict__ mask,  // [T, G, B]
                const bf16* __restrict__ h_res,  // [T, G, B, H]
                const bf16* __restrict__ dys,    // [T, G, B, H]
                const float* __restrict__ dhT,   // [G, B, H]
                float* __restrict__ db_part,     // [G, ceil(B / BR), 3H]
                bf16* __restrict__ dxw,          // [T, G, B, 3H]
                float* __restrict__ dhw,         // [T, G, B, 3H]
                float* __restrict__ dh0,         // [G, B, H]
                int T, int G, int B) {
  using S = Shape<H>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ws = reinterpret_cast<bf16*>(smem);
  bf16* hr = ws + S::NCOL * H;                               // [BR][H]: the next recompute's rows
  bf16* dgh = hr + BR * H;                                   // [BR][DGP]: bf16(dhw)
  bf16* dgl = dgh + BR * S::DGP;                             // [BR][DGP]: bf16(dhw - hi)
  float* red = reinterpret_cast<float*>(dgl + BR * S::DGP);  // [2][C][BR][UR]
  uint64_t* full = reinterpret_cast<uint64_t*>(red + 2 * C * BR * S::UR);

  const int rank = (int)cluster_rank();
  const int g = blockIdx.y;
  const int tile = blockIdx.x / C;
  const int row0 = tile * BR;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int ul = warp * 8 + 2 * tig;
  const int unit = rank * S::UR + ul;
  const int rows[2] = {row0 + gid, row0 + gid + 8};
  const bool live[2] = {rows[0] < B, rows[1] < B};
  const int H3 = 3 * H;

  lstm_cl::stage_slice<H, S::NCOL>(ws, wcl + ((size_t)g * C + rank) * S::NCOL * H, tid);
  lstm_cl::stage_rows<H>(hr, h_res + ((size_t)(T - 1) * G + g) * B * H, row0, B, tid);

  float dhd[4], bq[3][2], dbacc[3][2];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const size_t o = ((size_t)g * B + (live[e >> 1] ? rows[e >> 1] : 0)) * H + unit + (e & 1);
    dhd[e] = live[e >> 1] ? dhT[o] : 0.f;
  }
#pragma unroll
  for (int q = 0; q < 3; ++q)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      bq[q][j] = bias[(size_t)g * H3 + q * H + unit + j];
      dbacc[q][j] = 0.f;
    }

  // step t's operands of the thread's cells: xw, h_res, dys (bf16 pairs), mask
  uint32_t x[2][3], hp[2], dy[2];
  float m[2];
  auto load_step = [&](int t) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const size_t gb = ((size_t)t * G + g) * B + rows[r];
#pragma unroll
      for (int q = 0; q < 3; ++q)
        x[r][q] = live[r] ? *reinterpret_cast<const uint32_t*>(xw + gb * H3 + q * H + unit) : 0u;
      hp[r] = live[r] ? *reinterpret_cast<const uint32_t*>(h_res + gb * H + unit) : 0u;
      dy[r] = live[r] ? *reinterpret_cast<const uint32_t*>(dys + gb * H + unit) : 0u;
      m[r] = live[r] ? mask[gb] : 0.f;
    }
  };
  load_step(T - 1);
  float gacc[3][4];
  mma_attn::cp_async_wait<0>();
  __syncthreads();
  gate_product<H>(hr, ws, warp, lane, gacc);
  if (T >= 2) {
    __syncthreads();  // every warp has read the tile
    lstm_cl::stage_rows<H>(hr, h_res + ((size_t)(T - 2) * G + g) * B * H, row0, B, tid);
  }
  if (tid == 0) {
    mbar_init(&full[0], 1);
    mbar_init(&full[1], 1);
    fence_mbar_init();
  }
  cluster_arrive();
  cluster_wait();

  for (int t = T - 1; t >= 0; --t) {
    float d_out[4];
    if (t < T - 1) {
      lstm_cl::wait_partials<H>(full, t + 1, T, tid);
      lstm_cl::sum_partials<H>(red, t + 1, gid, ul, d_out);
#pragma unroll
      for (int e = 0; e < 4; ++e) d_out[e] = mma_attn::round_bf16(d_out[e]) + dhd[e];
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) d_out[e] = dhd[e];
    }

    // the pointwise backward on the recomputed gates
    uint32_t dxv[2][3];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float dw[3][2], dx[3][2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int e = 2 * r + j;
        const float rg = sigm((bf_at(x[r][0], j) + bq[0][j]) + gacc[0][e]);
        const float zg = sigm((bf_at(x[r][1], j) + bq[1][j]) + gacc[1][e]);
        const float ng = tanh_((bf_at(x[r][2], j) + bq[2][j]) + rg * gacc[2][e]);
        const float hv = bf_at(hp[r], j);
        const float mm = m[r];
        const float dh_new = (d_out[e] + bf_at(dy[r], j)) * mm;
        dhd[e] = d_out[e] * (1.0f - mm) + dh_new * zg;
        const float dn = dh_new * (1.0f - zg) * (1.0f - ng * ng);
        const float dz = dh_new * (hv - ng) * zg * (1.0f - zg);
        const float dr = dn * gacc[2][e] * rg * (1.0f - rg);
        dx[0][j] = dw[0][j] = dr;
        dx[1][j] = dw[1][j] = dz;
        dx[2][j] = dn;
        dw[2][j] = dn * rg;
#pragma unroll
        for (int q = 0; q < 3; ++q) dbacc[q][j] += dx[q][j];
      }
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        dxv[r][q] = pack_bf16(dx[q][0], dx[q][1]);
        const uint32_t hi = pack_bf16(dw[q][0], dw[q][1]);
        const uint32_t lo = pack_bf16(dw[q][0] - bf_at(hi, 0), dw[q][1] - bf_at(hi, 1));
        const int n = warp * 24 + q * 8 + 2 * tig;
        const int at = swz<S::DGP>(gid + 8 * r, n >> 3) + (n & 7);
        *reinterpret_cast<uint32_t*>(dgh + at) = hi;
        *reinterpret_cast<uint32_t*>(dgl + at) = lo;
        if (live[r])
          *reinterpret_cast<float2*>(dhw + (((size_t)t * G + g) * B + rows[r]) * H3 + q * H +
                                     unit) = make_float2(dw[q][0], dw[q][1]);
      }
    }
    __syncthreads();

    // partial dh = dhw . slice^T (hi and lo into one fp32 sum), to the owners
    {
      const bf16* const tiles[2] = {dgh, dgl};
      lstm_cl::send_dh_partials<H, S::NCOL, S::DGP, 2>(tiles, ws, red, full, t, rank, warp,
                                                        lane);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (!live[r]) continue;
      const size_t gb = ((size_t)t * G + g) * B + rows[r];
#pragma unroll
      for (int q = 0; q < 3; ++q)
        *reinterpret_cast<uint32_t*>(dxw + gb * H3 + q * H + unit) = dxv[r][q];
    }

    if (t > 0) {  // while the partials travel: step t-1's operands and recomputed gates
      load_step(t - 1);
      mma_attn::cp_async_wait<0>();
      __syncthreads();  // h_res[t-1] has landed
      gate_product<H>(hr, ws, warp, lane, gacc);
      if (t >= 2) {
        __syncthreads();  // every warp has read the tile
        lstm_cl::stage_rows<H>(hr, h_res + ((size_t)(t - 2) * G + g) * B * H, row0, B, tid);
      }
    }
  }

  lstm_cl::wait_partials<H>(full, 0, T, tid);
  float p0[4];
  lstm_cl::sum_partials<H>(red, 0, gid, ul, p0);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    if (!live[e >> 1]) continue;
    dh0[((size_t)g * B + rows[e >> 1]) * H + unit + (e & 1)] = mma_attn::round_bf16(p0[e]) + dhd[e];
  }
  // db over the tile's rows: the quad's 8 row groups
#pragma unroll
  for (int q = 0; q < 3; ++q)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float v = dbacc[q][j];
      v += __shfl_xor_sync(0xffffffffu, v, 4);
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      if (gid == 0) db_part[((size_t)g * (gridDim.x / C) + tile) * H3 + q * H + unit + j] = v;
    }
  cluster_arrive();
  cluster_wait();
}

// ---- launches ---------------------------------------------------------------

template <int H>
cudaError_t fwd(const void* wcl, const void* bias, const void* xw, const void* mask, void* hbuf,
                void* ys, void* h_res, int T, int G, int B, cudaStream_t st) {
  using S = Shape<H>;
  return lstm_cl::launch_cluster(gru_cluster_fwd<H>, S::FWD_SMEM, S::THREADS, (B + BR - 1) / BR,
                                 G, st, static_cast<const bf16*>(wcl),
                                 static_cast<const float*>(bias), static_cast<const bf16*>(xw),
                                 static_cast<const float*>(mask), static_cast<float*>(hbuf),
                                 static_cast<bf16*>(ys), static_cast<bf16*>(h_res), T, G, B);
}

template <int H>
cudaError_t bwd(const void* wcl, const void* bias, const void* xw, const void* mask,
                const void* h_res, const void* dys, const void* dhT, void* db_part, void* dxw,
                void* dhw, void* dh0, void* db, int T, int G, int B, cudaStream_t st) {
  using S = Shape<H>;
  const int n_tiles = (B + BR - 1) / BR;
  cudaError_t e = lstm_cl::launch_cluster(
      gru_cluster_bwd<H>, S::BWD_SMEM, S::THREADS, n_tiles, G, st, static_cast<const bf16*>(wcl),
      static_cast<const float*>(bias), static_cast<const bf16*>(xw),
      static_cast<const float*>(mask), static_cast<const bf16*>(h_res),
      static_cast<const bf16*>(dys), static_cast<const float*>(dhT),
      static_cast<float*>(db_part), static_cast<bf16*>(dxw), static_cast<float*>(dhw),
      static_cast<float*>(dh0), T, G, B);
  if (e != cudaSuccess) return e;
  lstm_cl::lstm_db_reduce<<<dim3((3 * H + 255) / 256, G), 256, 0, st>>>(
      static_cast<const float*>(db_part), static_cast<float*>(db), n_tiles, 3 * H);
  return cudaGetLastError();
}

template <int H>
int max_active(bool backward) {
  using S = Shape<H>;
  return backward ? lstm_cl::max_active_clusters((const void*)gru_cluster_bwd<H>, S::THREADS,
                                                 S::BWD_SMEM)
                  : lstm_cl::max_active_clusters((const void*)gru_cluster_fwd<H>, S::THREADS,
                                                 S::FWD_SMEM);
}

}  // namespace gru_cl
}  // namespace

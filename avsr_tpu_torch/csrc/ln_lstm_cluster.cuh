// K13 on thread-block clusters: the masked LN-LSTM recurrence, forward and
// backward, as one persistent launch per layer call (ln_lstm_scan.cu's
// avsr_ln_lstm_cluster_* entry points; kernels.ln_lstm_family says
// "cluster": H a multiple of 64 from 128 to 384, every preset's H = 256).
// The functions are ln_lstm_scan.cu's (its header comment): the reference's
// lax.scan over lstm_step with LayerNorm cells (avsr_tpu/ops/rnn.py:535-553,
// its LN branch :92-136, _gate_layer_norm :56-64) forward, and the reverse
// scan of JAX's autodiff of that body backward.
//
// What bounds it on an H100: the chain of T dependent steps, each with two
// row-wide LayerNorms inside the recurrence.  The block design (one block a
// (direction, 4 rows) owning all 4H gate columns) kept every LayerNorm
// inside a block but streamed the 512 KB Wh from L2 every step into
// CUDA-core FMAs, 21 us a step forward.  Here the step's latency is K1's
// (lstm_cluster.cuh: the product out of shared memory, one exchange of h)
// plus one cluster exchange per statistics round.
//
// Geometry: K1's.  A cluster of C = 8 CTAs owns one (direction g, tile of
// BR = 16 batch rows) for all T steps; CTA r owns the UR = H/8 units [r UR,
// (r+1) UR) with all four gates, and keeps its Wh[g] slice (4 UR x H bf16,
// 64 KB at H = 256; the cluster_lstm_weights layout) resident in shared
// memory, column-major and swizzled: ldmatrix feeds the forward's h . Wh,
// ldmatrix.trans the backward's dz . Wh^T from the same bytes.  Warp w owns
// 8 units, its 32 slice columns ordered [gate][unit], so a thread's m16n8k16
// C fragments hold every gate of (rows gid, gid + 8) x (units 2 tig, 2 tig +
// 1).  h goes to the peers by st.async into two alternating slots under
// mbarriers, as in K1; a cluster barrier only opens and closes the scan.
//
// LN statistics merge (one exchange per statistics round, not two).  Each
// gate block of a row, and the cell's c', is normalised over H units spread
// over the 8 CTAs.  A warp forms (mean, M2) of its 8 units by the two-pass
// form (a quad's butterfly sums, then the squared deviations from that
// mean); the CTA merges its NW warps' partials, and every CTA sends its
// (mean, M2) per (row, block) to every peer.  Each CTA merges the 8 in rank
// order with Chan's formula for equal counts n:
//   mean = (sum_i mean_i) / k,   M2 = sum_i (M2_i + n (mean_i - mean)^2),
// var = M2 / H (the population variance of jnp.var), rstd = rsqrt(var +
// 1e-5).  This is the two-pass form up to rounding (no E[x^2] - E[x]^2
// cancellation) at one exchange where the exact two-pass form takes two;
// tests/test_torch_ln_lstm_cluster.py holds a mirror of it against jnp.var.
// The backward's LN sums (mean(dy), mean(dy x_hat)) are plain sums: warp,
// CTA, then the 8 CTAs' partials in rank order.
//
// Forward step t: wait for h_t; z = xw[t] + bf16(h rd) . Wh (fp32 on the
// tensor cores); the gate blocks' statistics (one exchange); i, f, g, o and
// c' = f c + i g; the cell's statistics (one exchange); h' = o tanh(LN(c')
// gamma_c + beta_c); the masked carries; bf16(h' rd) to every peer.  Save
// mode writes h_res (the operand, bf16), c_res (the carry entering, fp32)
// and z (fp32, 16H bytes a row-step: 206 MB at [197, 2, 128, 256]), the
// present contract.  z is kept, not recomputed: its write and its read are
// each ~62 us of HBM time at that shape against a chain of ~0.8 ms, and with
// z the backward needs no forward product at all (the row statistics of z
// and of c' are recomputed by a separate, fully parallel launch before the
// reverse scan, avsr_ln_lstm_cluster_bwd's first launch).
//
// Backward step t (from T-1 down): dh = bf16(sum in rank order of the 8 CTAs'
// partial dz . slice^T of step t+1) * rd + dh_direct; the cell recomputed
// from z[t], c_res[t] and the step's statistics; dh' = (dh + dys[t]) m; the
// cell LN's backward sums (one exchange); dc', dpre; the gate LN's backward
// sums (one exchange); dz = LN_back(dpre gamma) per gate block; dxw[t] =
// bf16(dz); the partial dh products to their owners (K1's reduce-scatter).
// The parameter sums (db, dln_gamma, dln_cell_gamma, dln_cell_beta) stay in
// the registers of each column's owner across the steps and are written per
// (g, row tile), then summed over tiles in order by a small launch: no
// atomics, the same bits every run.
//
// The fp32 cotangent operand.  JAX's transpose of dot(bf16 h, bf16 Wh,
// preferred_element_type=f32) is dot_general(f32 dz, bf16 Wh) rounded to
// bf16 once at the end, so dz may not be rounded before the product (K1
// rounds dgates there because its reference's custom VJP does).  Each dz is
// split into hi = bf16(dz) and lo = bf16(dz - hi), and two mma.syncs (hi .
// slice^T, lo . slice^T) accumulate into one fp32 sum: 16 significant bits
// of dz (the residual is below 2^-16 |dz|, far under the final bf16
// rounding), at twice the tensor-core work of the dh product (16 k-steps a
// warp instead of 8 at H = 256) and a second 4 KB dz tile; hi is dxw itself.
//
// Rows past B run on zeros and write nothing; masked steps carry h and c
// (dh and dc) through bit for bit; a 0-length row keeps h0 / c0 and passes
// dhT / dcT.  The recurrent-dropout mask is an instance (RD) of its own.

#pragma once

#include "lstm_cluster.cuh"

namespace {
namespace ln_cl {

using lstm_cl::BR;
using lstm_cl::C;
using lstm_cl::bf_at;
using lstm_cl::sigm;
using lstm_cl::tanh_;
using mma_attn::bf16;
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
using cluster_ptx::st_async_v2f32;

constexpr float LN_EPS = 1e-5f;
constexpr unsigned FULL = 0xffffffffu;
constexpr int NSTAT = 10;  // a row-step's statistics: (mean, rstd) of 4 gate blocks and the cell

template <int H>
struct Shape {
  using K1 = lstm_cl::Shape<H>;
  static constexpr int UR = K1::UR;
  static constexpr int NW = K1::NW;
  static constexpr int THREADS = K1::THREADS;
  static constexpr int NCOL = K1::NCOL;
  static constexpr int DGP = (NCOL + 63) / 64 * 64;  // dz tile pitch: 8 swizzle chunks a row
  static constexpr size_t W_BYTES = K1::W_BYTES;
  static constexpr size_t HT_BYTES = K1::HT_BYTES;
  static constexpr size_t DG_BYTES = (size_t)BR * DGP * 2;       // one bf16 dz tile (hi or lo)
  static constexpr size_t RED_BYTES = K1::RED_BYTES;               // a slot of dh partials
  static constexpr size_t WG_BYTES = (size_t)NW * BR * 4 * 8;      // warps' gate partials
  static constexpr size_t WC_BYTES = (size_t)NW * BR * 8;          // warps' cell partials
  static constexpr size_t RG_BYTES = (size_t)C * BR * 4 * 8;       // the CTAs' gate partials
  static constexpr size_t RC_BYTES = (size_t)C * BR * 8;           // the CTAs' cell partials
  static constexpr size_t STAT_BYTES = WG_BYTES + WC_BYTES + RG_BYTES + RC_BYTES;
  static constexpr size_t FWD_SMEM = W_BYTES + 2 * HT_BYTES + STAT_BYTES + 4 * 8;
  static constexpr size_t BWD_SMEM = W_BYTES + 2 * DG_BYTES + 2 * RED_BYTES + STAT_BYTES + 4 * 8;
  static_assert(H % 64 == 0 && H >= 128, "K1's geometry");
};

// (mean, M2) of a warp's 8 values of one row (the thread's two, the quad's
// four threads): the two-pass form by butterflies; every lane of the quad
// gets the same bits.
__device__ __forceinline__ float2 warp8_stats(float v0, float v1) {
  float s = v0 + v1;
  s += __shfl_xor_sync(FULL, s, 1);
  s += __shfl_xor_sync(FULL, s, 2);
  const float mean = s * 0.125f;
  const float d0 = v0 - mean, d1 = v1 - mean;
  float m2 = d0 * d0 + d1 * d1;
  m2 += __shfl_xor_sync(FULL, m2, 1);
  m2 += __shfl_xor_sync(FULL, m2, 2);
  return make_float2(mean, m2);
}

// the quad's sums of (a, b) pairs, each thread holding two of each
__device__ __forceinline__ float2 warp8_sums(float a0, float a1, float b0, float b1) {
  float a = a0 + a1, b = b0 + b1;
  a += __shfl_xor_sync(FULL, a, 1);
  b += __shfl_xor_sync(FULL, b, 1);
  a += __shfl_xor_sync(FULL, a, 2);
  b += __shfl_xor_sync(FULL, b, 2);
  return make_float2(a, b);
}

// Chan's merge of K (mean, M2) partials of n values each, in order
template <int K>
__device__ __forceinline__ float2 merge_stats(const float2* p, int stride, float n) {
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < K; ++i) s += p[i * stride].x;
  const float mean = s / (float)K;
  float m2 = 0.f;
#pragma unroll
  for (int i = 0; i < K; ++i) {
    const float2 v = p[i * stride];
    const float d = v.x - mean;
    m2 += v.y + n * (d * d);
  }
  return make_float2(mean, m2);
}

// K partial (a, b) sums added in order
template <int K>
__device__ __forceinline__ float2 merge_sums(const float2* p, int stride) {
  float2 s = p[0];
#pragma unroll
  for (int i = 1; i < K; ++i) {
    s.x += p[i * stride].x;
    s.y += p[i * stride].y;
  }
  return s;
}

// The CTA's partial of each of the P (row, slot) pairs, merged from its
// warps' partials wp [NW][P] (merge_stats when STATS, else merge_sums), to
// slot [rank][pair] of every peer's receive buffer rv [C][P], counted on
// the peer's barrier `bar`.
template <int H, int P, bool STATS>
__device__ __forceinline__ void send_partials(const float2* wp, float2* rv, uint64_t* bar,
                                              int rank, int tid) {
  using S = Shape<H>;
  const uint32_t bar_a = smem_addr(bar);
  for (int idx = tid; idx < P * C; idx += S::THREADS) {
    const int p = idx % P, peer = idx / P;
    float2 v;
    if constexpr (STATS)
      v = merge_stats<S::NW>(wp + p, P, 8.f);
    else
      v = merge_sums<S::NW>(wp + p, P);
    st_async_v2f32(map_rank(smem_addr(rv + rank * P + p), (uint32_t)peer), v.x, v.y,
                   map_rank(bar_a, (uint32_t)peer));
  }
}

// one phase of a receive buffer's barrier: every CTA's partials have arrived
__device__ __forceinline__ void wait_phase(uint64_t* bar, uint32_t bytes, int parity, int tid) {
  if (tid == 0) mbar_expect(bar, bytes);
  mbar_wait(bar, (uint32_t)parity);
}

// v of (quad lane q), for q = 0..3: a quad's four values to every lane
__device__ __forceinline__ float from_lane(float v, int lane, int q) {
  return __shfl_sync(FULL, v, (lane & ~3) | q);
}

// ---- forward ----------------------------------------------------------------

template <int H, bool RD>
__global__ void __launch_bounds__(Shape<H>::THREADS, 1)
ln_lstm_cluster_fwd(const bf16* __restrict__ wcl,    // [G, C, NCOL, H]
                    const float* __restrict__ bias,  // [G, 4H]
                    const float* __restrict__ lng,   // [G, 4H]
                    const float* __restrict__ lncg,  // [G, H]
                    const float* __restrict__ lncb,  // [G, H]
                    const bf16* __restrict__ xw,     // [T, G, B, 4H]
                    const float* __restrict__ mask,  // [T, G, B]
                    const float* __restrict__ rd,    // [G, B, H] (RD)
                    float* __restrict__ h_io,        // [G, B, H]: h0 in, hT out
                    float* __restrict__ c_io,        // [G, B, H]: c0 in, cT out
                    bf16* __restrict__ ys,           // [T, G, B, H]
                    bf16* __restrict__ h_res,        // [T, G, B, H] or null
                    float* __restrict__ c_res,       // [T, G, B, H] or null
                    float* __restrict__ z_res,       // [T, G, B, 4H] or null
                    int T, int G, int B) {
  using S = Shape<H>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ws = reinterpret_cast<bf16*>(smem);
  bf16* hs = ws + S::NCOL * H;                                  // [2][BR][H]
  float2* wpg = reinterpret_cast<float2*>(hs + 2 * BR * H);     // [NW][BR * 4]
  float2* wpc = wpg + S::NW * BR * 4;                           // [NW][BR]
  float2* rvg = wpc + S::NW * BR;                               // [C][BR * 4]
  float2* rvc = rvg + C * BR * 4;                               // [C][BR]
  uint64_t* bars = reinterpret_cast<uint64_t*>(rvc + C * BR);  // h slots 0, 1; gates; cell
  uint64_t* full = bars;
  uint64_t* gbar = bars + 2;
  uint64_t* cbar = bars + 3;

  const int rank = (int)cluster_rank();
  const int g = blockIdx.y;
  const int row0 = (blockIdx.x / C) * BR;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int unit = rank * S::UR + warp * 8 + 2 * tig;
  const int rows[2] = {row0 + gid, row0 + gid + 8};
  const bool live[2] = {rows[0] < B, rows[1] < B};
  const int H4 = 4 * H;
  const bool save = z_res != nullptr;

  lstm_cl::stage_slice<H>(ws, wcl + ((size_t)g * C + rank) * S::NCOL * H, tid);

  // bf16(h0 * rd) of the tile's rows, all H units, into slot 0
  for (int i = tid; i < BR * H / 2; i += S::THREADS) {
    const int r = i / (H / 2), k = 2 * (i - r * (H / 2));
    float2 v = make_float2(0.f, 0.f);
    if (row0 + r < B) {
      const size_t o = ((size_t)g * B + row0 + r) * H + k;
      v = *reinterpret_cast<const float2*>(h_io + o);
      if constexpr (RD) {
        const float2 q = *reinterpret_cast<const float2*>(rd + o);
        v = make_float2(v.x * q.x, v.y * q.y);
      }
    }
    *reinterpret_cast<uint32_t*>(hs + swz<H>(r, k >> 3) + (k & 7)) = pack_bf16(v.x, v.y);
  }
  // the thread's cells: fp32 h and c, the dropout factors; its parameters
  float h[4], cs[4], rdv[4], bq[4][2], gq[4][2], cg[2], cb[2];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const size_t o = ((size_t)g * B + (live[e >> 1] ? rows[e >> 1] : 0)) * H + unit + (e & 1);
    h[e] = live[e >> 1] ? h_io[o] : 0.f;
    cs[e] = live[e >> 1] ? c_io[o] : 0.f;
    rdv[e] = 1.f;
    if constexpr (RD) rdv[e] = live[e >> 1] ? rd[o] : 1.f;
  }
#pragma unroll
  for (int j = 0; j < 2; ++j) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      bq[q][j] = bias[(size_t)g * H4 + q * H + unit + j];
      gq[q][j] = lng[(size_t)g * H4 + q * H + unit + j];
    }
    cg[j] = lncg[(size_t)g * H + unit + j];
    cb[j] = lncb[(size_t)g * H + unit + j];
  }

  uint32_t xc[2][4], xn[2][4];
  float mc[2], mn[2];
  auto load_step = [&](int t, uint32_t (&x)[2][4], float (&m)[2]) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const size_t gb = ((size_t)t * G + g) * B + rows[r];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        x[r][q] = live[r] ? *reinterpret_cast<const uint32_t*>(xw + gb * H4 + q * H + unit) : 0u;
      m[r] = live[r] ? mask[gb] : 0.f;
    }
  };
  if (T > 0) load_step(0, xc, mc);
  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) mbar_init(&bars[i], 1);
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
    float z[4][4];
    lstm_cl::gate_product<H>(hs + slot * BR * H, ws, warp, lane, z);
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) z[q][e] = bf_at(xc[e >> 1][q], e & 1) + z[q][e];
    if (save) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (!live[r]) continue;
        const size_t gb = ((size_t)t * G + g) * B + rows[r];
#pragma unroll
        for (int q = 0; q < 4; ++q)
          *reinterpret_cast<float2*>(z_res + gb * H4 + q * H + unit) =
              make_float2(z[q][2 * r], z[q][2 * r + 1]);
      }
    }

    // the gate blocks' statistics: warp partials, the CTA's to every peer,
    // then the 8 CTAs' merged by lane tig for gate tig and shared in the quad
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float2 mine = make_float2(0.f, 0.f);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float2 v = warp8_stats(z[q][2 * r], z[q][2 * r + 1]);
        if (q == tig) mine = v;
      }
      wpg[warp * BR * 4 + (gid + 8 * r) * 4 + tig] = mine;
    }
    __syncthreads();
    send_partials<H, BR * 4, true>(wpg, rvg, gbar, rank, tid);
    wait_phase(gbar, (uint32_t)S::RG_BYTES, t & 1, tid);
    float gmean[2][4], grstd[2][4];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float2 v = merge_stats<C>(rvg + (gid + 8 * r) * 4 + tig, BR * 4, (float)S::UR);
      const float rs = rsqrtf(v.y / (float)H + LN_EPS);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        gmean[r][q] = from_lane(v.x, lane, q);
        grstd[r][q] = from_lane(rs, lane, q);
      }
    }

    // the gates and c'
    float og[4], cn[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1, j = e & 1;
      float a[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) a[q] = (z[q][e] - gmean[r][q]) * grstd[r][q] * gq[q][j] + bq[q][j];
      const float i = sigm(a[0]), f = sigm(a[1]), gt = tanh_(a[2]);
      og[e] = sigm(a[3]);
      cn[e] = f * cs[e] + i * gt;
    }
    // the cell's statistics
    {
      float2 mine = make_float2(0.f, 0.f);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float2 v = warp8_stats(cn[2 * r], cn[2 * r + 1]);
        if (r == tig) mine = v;
      }
      if (tig < 2) wpc[warp * BR + gid + 8 * tig] = mine;
    }
    __syncthreads();
    send_partials<H, BR, true>(wpc, rvc, cbar, rank, tid);
    wait_phase(cbar, (uint32_t)S::RC_BYTES, t & 1, tid);
    float cmean[2], crstd[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float2 v = merge_stats<C>(rvc + gid + 8 * r, BR, (float)S::UR);
      cmean[r] = v.x;
      crstd[r] = rsqrtf(v.y / (float)H + LN_EPS);
    }

    uint32_t hpk[2], ypk[2], hrpk[2];
    float cin[4];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float y[2], hin[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int e = 2 * r + j;
        const float cfo = (cn[e] - cmean[r]) * crstd[r] * cg[j] + cb[j];
        const float h_new = og[e] * tanh_(cfo);
        const float m = mc[r];
        hin[j] = h[e];
        cin[e] = cs[e];
        y[j] = h_new * m;
        h[e] = m * h_new + (1.0f - m) * h[e];
        cs[e] = m * cn[e] + (1.0f - m) * cs[e];
      }
      hpk[r] = pack_bf16(h[2 * r] * rdv[2 * r], h[2 * r + 1] * rdv[2 * r + 1]);
      ypk[r] = pack_bf16(y[0], y[1]);
      hrpk[r] = pack_bf16(hin[0] * rdv[2 * r], hin[1] * rdv[2 * r + 1]);
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
      if (save) {
        *reinterpret_cast<uint32_t*>(h_res + o) = hrpk[r];
        *reinterpret_cast<float2*>(c_res + o) = make_float2(cin[2 * r], cin[2 * r + 1]);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mc[r] = mn[r];
#pragma unroll
      for (int q = 0; q < 4; ++q) xc[r][q] = xn[r][q];
    }
  }
  // no CTA leaves while a peer may still address its shared memory
  cluster_arrive();
  cluster_wait();

#pragma unroll
  for (int e = 0; e < 4; ++e) {
    if (!live[e >> 1]) continue;
    const size_t o = ((size_t)g * B + rows[e >> 1]) * H + unit + (e & 1);
    h_io[o] = h[e];
    c_io[o] = cs[e];
  }
}

// ---- the backward's statistics ----------------------------------------------

// The row statistics of every saved step, fully parallel ahead of the
// reverse scan: a warp a (t, g, b) row computes the 4 gate blocks' (mean,
// rstd) of z by the two-pass form, the gates and c' = f c + i g from them,
// and c''s (mean, rstd): stats [T, G, B, NSTAT].
template <int H>
__global__ void __launch_bounds__(256)
ln_lstm_cluster_stats(const float* __restrict__ bias, const float* __restrict__ lng,
                      const float* __restrict__ c_res, const float* __restrict__ z_res,
                      float* __restrict__ stats, int n_rows, int G, int B) {
  constexpr int K = H / 32;  // units a lane in each block
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5);
  if (row >= n_rows) return;
  const int g = (row / B) % G;
  const float* z = z_res + (size_t)row * 4 * H;
  float st[NSTAT];
  float act[3][K];  // i, f, g of the lane's units
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    float v[K], s = 0.f;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      v[k] = z[q * H + lane + 32 * k];
      s += v[k];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(FULL, s, o);
    const float mean = s / (float)H;
    float m2 = 0.f;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const float d = v[k] - mean;
      m2 += d * d;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) m2 += __shfl_xor_sync(FULL, m2, o);
    const float rstd = rsqrtf(m2 / (float)H + LN_EPS);
    st[2 * q] = mean;
    st[2 * q + 1] = rstd;
    if (q < 3) {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int col = (size_t)g * 4 * H + q * H + lane + 32 * k;
        const float a = (v[k] - mean) * rstd * lng[col] + bias[col];
        act[q][k] = q == 2 ? tanh_(a) : sigm(a);
      }
    }
  }
  float cn[K], s = 0.f;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    cn[k] = act[1][k] * c_res[(size_t)row * H + lane + 32 * k] + act[0][k] * act[2][k];
    s += cn[k];
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(FULL, s, o);
  const float mean = s / (float)H;
  float m2 = 0.f;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const float d = cn[k] - mean;
    m2 += d * d;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m2 += __shfl_xor_sync(FULL, m2, o);
  st[8] = mean;
  st[9] = rsqrtf(m2 / (float)H + LN_EPS);
  if (lane < NSTAT) {
    float v = st[0];
#pragma unroll
    for (int i = 1; i < NSTAT; ++i)
      if (lane == i) v = st[i];
    stats[(size_t)row * NSTAT + lane] = v;
  }
}

// ---- backward ---------------------------------------------------------------

template <int H, bool RD>
__global__ void __launch_bounds__(Shape<H>::THREADS, 1)
ln_lstm_cluster_bwd(const bf16* __restrict__ wcl,     // [G, C, NCOL, H]
                    const float* __restrict__ bias,   // [G, 4H]
                    const float* __restrict__ lng,    // [G, 4H]
                    const float* __restrict__ lncg,   // [G, H]
                    const float* __restrict__ lncb,   // [G, H]
                    const float* __restrict__ mask,   // [T, G, B]
                    const float* __restrict__ rd,     // [G, B, H] (RD)
                    const float* __restrict__ c_res,  // [T, G, B, H]
                    const float* __restrict__ z_res,  // [T, G, B, 4H]
                    const float* __restrict__ stats,  // [T, G, B, NSTAT]
                    const bf16* __restrict__ dys,     // [T, G, B, H]
                    float* __restrict__ dh_io,        // [G, B, H]: dhT in, dh0 out
                    float* __restrict__ dc_io,        // [G, B, H]: dcT in, dc0 out
                    bf16* __restrict__ dxw,           // [T, G, B, 4H]
                    float* __restrict__ part,         // [G, tiles, 10H]
                    int T, int G, int B) {
  using S = Shape<H>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ws = reinterpret_cast<bf16*>(smem);
  bf16* dgh = ws + S::NCOL * H;                                 // [BR][DGP]: bf16(dz)
  bf16* dgl = dgh + BR * S::DGP;                                // [BR][DGP]: bf16(dz - hi)
  float* red = reinterpret_cast<float*>(dgl + BR * S::DGP);     // [2][C][BR][UR]
  float2* wpg = reinterpret_cast<float2*>(red + 2 * C * BR * S::UR);  // [NW][BR * 4]
  float2* wpc = wpg + S::NW * BR * 4;                           // [NW][BR]
  float2* rvg = wpc + S::NW * BR;                               // [C][BR * 4]
  float2* rvc = rvg + C * BR * 4;                               // [C][BR]
  uint64_t* bars = reinterpret_cast<uint64_t*>(rvc + C * BR);  // partial slots 0, 1; gates; cell
  uint64_t* full = bars;
  uint64_t* gbar = bars + 2;
  uint64_t* cbar = bars + 3;

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
  const int H4 = 4 * H;

  lstm_cl::stage_slice<H>(ws, wcl + ((size_t)g * C + rank) * S::NCOL * H, tid);

  float dhd[4], dcs[4], rdv[4], bq[4][2], gq[4][2], cg[2], cb[2];
  float a_db[4][2], a_dg[4][2], a_dcg[2], a_dcb[2];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const size_t o = ((size_t)g * B + (live[e >> 1] ? rows[e >> 1] : 0)) * H + unit + (e & 1);
    dhd[e] = live[e >> 1] ? dh_io[o] : 0.f;
    dcs[e] = live[e >> 1] ? dc_io[o] : 0.f;
    rdv[e] = 1.f;
    if constexpr (RD) rdv[e] = live[e >> 1] ? rd[o] : 1.f;
  }
#pragma unroll
  for (int j = 0; j < 2; ++j) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      bq[q][j] = bias[(size_t)g * H4 + q * H + unit + j];
      gq[q][j] = lng[(size_t)g * H4 + q * H + unit + j];
      a_db[q][j] = a_dg[q][j] = 0.f;
    }
    cg[j] = lncg[(size_t)g * H + unit + j];
    cb[j] = lncb[(size_t)g * H + unit + j];
    a_dcg[j] = a_dcb[j] = 0.f;
  }

  // step t's operands of the thread's cells: z, c_res, dys, mask, statistics
  struct Step {
    float z[4][4], c[4], m[2], st[2][NSTAT];
    uint32_t dy[2];
  };
  auto load_step = [&](int t, Step& s) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const size_t gb = ((size_t)t * G + g) * B + rows[r];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float2 v = live[r] ? *reinterpret_cast<const float2*>(z_res + gb * H4 + q * H + unit)
                                 : make_float2(0.f, 0.f);
        s.z[q][2 * r] = v.x;
        s.z[q][2 * r + 1] = v.y;
      }
      const float2 cv = live[r] ? *reinterpret_cast<const float2*>(c_res + gb * H + unit)
                                : make_float2(0.f, 0.f);
      s.c[2 * r] = cv.x;
      s.c[2 * r + 1] = cv.y;
      s.dy[r] = live[r] ? *reinterpret_cast<const uint32_t*>(dys + gb * H + unit) : 0u;
      s.m[r] = live[r] ? mask[gb] : 0.f;
#pragma unroll
      for (int i = 0; i < NSTAT; i += 2) {
        const float2 v = live[r] ? *reinterpret_cast<const float2*>(stats + gb * NSTAT + i)
                                 : make_float2(0.f, 0.f);
        s.st[r][i] = v.x;
        s.st[r][i + 1] = v.y;
      }
    }
  };
  Step cur, nxt;
  load_step(T - 1, cur);
  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) mbar_init(&bars[i], 1);
    fence_mbar_init();
  }
  mma_attn::cp_async_wait<0>();
  cluster_arrive();
  cluster_wait();

  for (int t = T - 1; t >= 0; --t) {
    if (t > 0) load_step(t - 1, nxt);
    float dh_out[4];
    if (t < T - 1) {
      lstm_cl::wait_partials<H>(full, t + 1, T, tid);
      lstm_cl::sum_partials<H>(red, t + 1, gid, ul, dh_out);
#pragma unroll
      for (int e = 0; e < 4; ++e) dh_out[e] = mma_attn::round_bf16(dh_out[e]) * rdv[e] + dhd[e];
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) dh_out[e] = dhd[e];
    }

    // the cell recomputed from z and the statistics; the output's cotangents
    float gn[4][4], act[4][4], cnh[4], dcf[4], d_o[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1, j = e & 1;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        gn[q][e] = (cur.z[q][e] - cur.st[r][2 * q]) * cur.st[r][2 * q + 1];
        const float a = gn[q][e] * gq[q][j] + bq[q][j];
        act[q][e] = q == 2 ? tanh_(a) : sigm(a);
      }
      const float c_new = act[1][e] * cur.c[e] + act[0][e] * act[2][e];
      cnh[e] = (c_new - cur.st[r][8]) * cur.st[r][9];
      const float tc = tanh_(cnh[e] * cg[j] + cb[j]);
      const float m = cur.m[r];
      const float dh_new = (dh_out[e] + bf_at(cur.dy[r], j)) * m;
      dhd[e] = dh_out[e] * (1.0f - m);
      d_o[e] = dh_new * tc;
      dcf[e] = dh_new * act[3][e] * (1.0f - tc * tc);
      a_dcg[j] += dcf[e] * cnh[e];
      a_dcb[j] += dcf[e];
    }
    // the cell LN's backward sums: sum dy, sum dy x_hat with dy = dcfo gamma_c
    {
      float2 mine = make_float2(0.f, 0.f);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float y0 = dcf[2 * r] * cg[0], y1 = dcf[2 * r + 1] * cg[1];
        const float2 v = warp8_sums(y0, y1, y0 * cnh[2 * r], y1 * cnh[2 * r + 1]);
        if (r == tig) mine = v;
      }
      if (tig < 2) wpc[warp * BR + gid + 8 * tig] = mine;
    }
    __syncthreads();
    send_partials<H, BR, false>(wpc, rvc, cbar, rank, tid);
    wait_phase(cbar, (uint32_t)S::RC_BYTES, (T - 1 - t) & 1, tid);
    float dpre[4][4];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float2 s = merge_sums<C>(rvc + gid + 8 * r, BR);
      const float m1 = s.x / (float)H, m2 = s.y / (float)H;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int e = 2 * r + j;
        const float m = cur.m[r];
        const float dc_new =
            dcs[e] * m + cur.st[r][9] * (dcf[e] * cg[j] - m1 - cnh[e] * m2);
        const float ig = act[0][e], fg = act[1][e], gg = act[2][e], og = act[3][e];
        dpre[0][e] = dc_new * gg * ig * (1.0f - ig);
        dpre[1][e] = dc_new * cur.c[e] * fg * (1.0f - fg);
        dpre[2][e] = dc_new * ig * (1.0f - gg * gg);
        dpre[3][e] = d_o[e] * og * (1.0f - og);
        dcs[e] = dc_new * fg + dcs[e] * (1.0f - m);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          a_db[q][j] += dpre[q][e];
          a_dg[q][j] += dpre[q][e] * gn[q][e];
        }
      }
    }
    // the gate LN's backward sums per (row, gate block), dy = dpre gamma
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float2 mine = make_float2(0.f, 0.f);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float y0 = dpre[q][2 * r] * gq[q][0], y1 = dpre[q][2 * r + 1] * gq[q][1];
        const float2 v = warp8_sums(y0, y1, y0 * gn[q][2 * r], y1 * gn[q][2 * r + 1]);
        if (q == tig) mine = v;
      }
      wpg[warp * BR * 4 + (gid + 8 * r) * 4 + tig] = mine;
    }
    __syncthreads();
    send_partials<H, BR * 4, false>(wpg, rvg, gbar, rank, tid);
    wait_phase(gbar, (uint32_t)S::RG_BYTES, (T - 1 - t) & 1, tid);
    uint32_t hi[2][4];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float2 s = merge_sums<C>(rvg + (gid + 8 * r) * 4 + tig, BR * 4);
      const float m1t = s.x / (float)H, m2t = s.y / (float)H;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float m1 = from_lane(m1t, lane, q), m2 = from_lane(m2t, lane, q);
        float dz[2], lo[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int e = 2 * r + j;
          dz[j] = cur.st[r][2 * q + 1] * (dpre[q][e] * gq[q][j] - m1 - gn[q][e] * m2);
        }
        hi[r][q] = pack_bf16(dz[0], dz[1]);
        lo[0] = dz[0] - bf_at(hi[r][q], 0);
        lo[1] = dz[1] - bf_at(hi[r][q], 1);
        const int n = warp * 32 + q * 8 + 2 * tig;
        const int at = swz<S::DGP>(gid + 8 * r, n >> 3) + (n & 7);
        *reinterpret_cast<uint32_t*>(dgh + at) = hi[r][q];
        *reinterpret_cast<uint32_t*>(dgl + at) = pack_bf16(lo[0], lo[1]);
      }
    }
    __syncthreads();

    // partial dh = dz . slice^T (hi and lo into one fp32 sum), to the owners
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
      for (int q = 0; q < 4; ++q)
        *reinterpret_cast<uint32_t*>(dxw + gb * H4 + q * H + unit) = hi[r][q];
    }
    if (t > 0) cur = nxt;
  }

  lstm_cl::wait_partials<H>(full, 0, T, tid);
  float p0[4];
  lstm_cl::sum_partials<H>(red, 0, gid, ul, p0);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    if (!live[e >> 1]) continue;
    const size_t o = ((size_t)g * B + rows[e >> 1]) * H + unit + (e & 1);
    dh_io[o] = mma_attn::round_bf16(p0[e]) * rdv[e] + dhd[e];
    dc_io[o] = dcs[e];
  }
  // the parameter sums over the tile's rows: the quad's 8 row groups
  float* pt = part + ((size_t)g * (gridDim.x / C) + tile) * 10 * H;
  auto rows_sum = [&](float v) {
    v += __shfl_xor_sync(FULL, v, 4);
    v += __shfl_xor_sync(FULL, v, 8);
    v += __shfl_xor_sync(FULL, v, 16);
    return v;
  };
#pragma unroll
  for (int j = 0; j < 2; ++j) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float db = rows_sum(a_db[q][j]), dg = rows_sum(a_dg[q][j]);
      if (gid == 0) {
        pt[q * H + unit + j] = db;
        pt[H4 + q * H + unit + j] = dg;
      }
    }
    const float dcg = rows_sum(a_dcg[j]), dcb = rows_sum(a_dcb[j]);
    if (gid == 0) {
      pt[2 * H4 + unit + j] = dcg;
      pt[2 * H4 + H + unit + j] = dcb;
    }
  }
  cluster_arrive();
  cluster_wait();
}

// ---- launches ---------------------------------------------------------------

template <int H>
cudaError_t fwd(const void* wcl, const void* bias, const void* lng, const void* lncg,
                const void* lncb, const void* xw, const void* mask, const void* rd, void* h,
                void* c, void* ys, void* h_res, void* c_res, void* z_res, int T, int G, int B,
                cudaStream_t st) {
  using S = Shape<H>;
  return lstm_cl::launch_cluster(
      rd != nullptr ? ln_lstm_cluster_fwd<H, true> : ln_lstm_cluster_fwd<H, false>, S::FWD_SMEM,
      S::THREADS, (B + BR - 1) / BR, G, st, static_cast<const bf16*>(wcl),
      static_cast<const float*>(bias), static_cast<const float*>(lng),
      static_cast<const float*>(lncg), static_cast<const float*>(lncb),
      static_cast<const bf16*>(xw), static_cast<const float*>(mask),
      static_cast<const float*>(rd), static_cast<float*>(h), static_cast<float*>(c),
      static_cast<bf16*>(ys), static_cast<bf16*>(h_res), static_cast<float*>(c_res),
      static_cast<float*>(z_res), T, G, B);
}

// the statistics launch, then the reverse scan (the caller reduces `part`)
template <int H>
cudaError_t bwd(const void* wcl, const void* bias, const void* lng, const void* lncg,
                const void* lncb, const void* mask, const void* rd, const void* c_res,
                const void* z_res, const void* dys, void* dh, void* dc, void* dxw, void* stats,
                void* part, int T, int G, int B, cudaStream_t st) {
  using S = Shape<H>;
  const int n_rows = T * G * B;
  ln_lstm_cluster_stats<H><<<(n_rows + 7) / 8, 256, 0, st>>>(
      static_cast<const float*>(bias), static_cast<const float*>(lng),
      static_cast<const float*>(c_res), static_cast<const float*>(z_res),
      static_cast<float*>(stats), n_rows, G, B);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return lstm_cl::launch_cluster(
      rd != nullptr ? ln_lstm_cluster_bwd<H, true> : ln_lstm_cluster_bwd<H, false>, S::BWD_SMEM,
      S::THREADS, (B + BR - 1) / BR, G, st, static_cast<const bf16*>(wcl),
      static_cast<const float*>(bias), static_cast<const float*>(lng),
      static_cast<const float*>(lncg), static_cast<const float*>(lncb),
      static_cast<const float*>(mask), static_cast<const float*>(rd),
      static_cast<const float*>(c_res), static_cast<const float*>(z_res),
      static_cast<const float*>(stats), static_cast<const bf16*>(dys), static_cast<float*>(dh),
      static_cast<float*>(dc), static_cast<bf16*>(dxw), static_cast<float*>(part), T, G, B);
}

template <int H>
int max_active(bool backward) {
  using S = Shape<H>;
  return backward ? lstm_cl::max_active_clusters((const void*)ln_lstm_cluster_bwd<H, false>,
                                                 S::THREADS, S::BWD_SMEM)
                  : lstm_cl::max_active_clusters((const void*)ln_lstm_cluster_fwd<H, false>,
                                                 S::THREADS, S::FWD_SMEM);
}

}  // namespace ln_cl
}  // namespace

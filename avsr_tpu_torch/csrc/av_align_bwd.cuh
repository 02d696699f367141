// K8's backward: the reverse scan of the AV-Align fusion's gradient
// (av_align_scan.cu's avsr_av_align_bwd_* entry points), the gradient JAX's
// autodiff takes through the rematerialized scan body of
// avsr_tpu/models/fusion.py:av_align_apply (:118-141), for either read
// (Bahdanau's additive score, Luong's dot score: the template argument DOT).
// Per step t, from T-1 down to 0, with m = mask[t, b] (av_align_scan.cu's
// backward comment has the full chain):
//
//   dctx' = m * (dctx_out + dctxs[t])                 (the read's cotangent)
//   dw[s] = bf16(dctx' . values[s]);  dsc = w * (dw - sum(w * dw))
//   dq = sum_s dpre (Bahdanau) or bf16(sum_s dsc[s] keys[s]) (Luong)
//   dquery = bf16(dq @ wq^T);  dh' = m * (dh_out + dhs[t]) + dquery
//   the LSTM cell backward -> dgates (dxw[t]), dc
//   dh_out, dctx_out of step t-1 = bf16(dgates @ [Wh ; ctx_proj]^T) + (1 - m) * (dh_out, dctx_out)
//
// and the memory's gradients, sums over t of per-step terms:
//
//   dvalues[b, s, :] = sum_t bf16(w[t, b, s]) * dctx'[t, b, :]
//   dkeys (Luong)    = sum_t dsc[t, b, s] * bf16(q[t, b, :])
//   dkeys (Bahdanau) = sum_t (deb + deb * e) * (1 - e),  e = tanh(keys[b, s, a] + q[t, b, a]),
//                      deb = bf16(dsc[t, b, s] * bf16(v[a]));  dv[a] += dsc * bf16(e)
//
// What bounds it on an H100: the recurrence's chain of T dependent steps.
// A step of one row streams the row's keys and values from L2 (Bahdanau at
// T_v = 150: 77 KB fp32 and 154 KB bf16; the 128 rows of a train batch:
// 30 MB a step, L2-resident) through a few rounds of loads in flight, and
// multiplies the rows' dgates into [Wh ; ctx_proj] (1024 x 768 bf16 at
// lrs2_av_align's widths).  The per-step kernels this replaces spent ~56 us
// a step in two launches, reading and rewriting each row's dkeys and
// dvalues (49 MB a step at B = 128) to add the step's terms.
//
// Design, five launches a call:
// (1) the regate: every step's gates and h' from the saved carries, in
//     parallel over t on the tensor cores, and (2) a query launch, q =
//     bf16(h') @ wq for every (t, b), also on the tensor cores (rounded to
//     bf16 for the dot score);
// (3) the recurrence: one persistent launch of 16-CTA thread-block clusters
//     (a non-portable size), a cluster per 16 RPC batch rows.  CTA rank r
//     owns row r (and, with RPC = 2 rows a CTA, row 16 + r on a second set
//     of 256 threads with a barrier of its own): it runs the row's read
//     backward, from its keys and values in L2 and its q, w and dctxs[t]
//     prefetched by cp.async a step ahead, and the cell backward, and holds
//     the row's dh_out, dc, dctx_out and db for all T steps.  RPC = 2 halves
//     the clusters: 16-CTA clusters of ~200 KB CTAs fit 7 at a time on the
//     card, and a 128-row batch at one row a CTA needs 8.  The product
//     dgates @ [Wh ; ctx_proj]^T is split over the cluster by output column:
//     CTA r holds NC = (H + Dc) / 16 rows of [Wh ; ctx_proj] (96 KB bf16 at
//     H = 256, Dc = 512) resident in shared memory for the whole scan.
//     Each step every row's bf16(dgates) goes into its row of every CTA's
//     dgates tile (one bulk copy a peer, counted on the peer's mbarrier);
//     each CTA waits for the tile, runs its columns' mma.sync product (bf16
//     operands, fp32 accumulators) and sends each row's bf16 results to the
//     row's owner (st.async), which waits for them at the top of the next
//     step.  One slot each suffices: a peer writes a CTA's dgates tile for
//     step t-1 only after it received that CTA's results of step t, which
//     the CTA sends after its reads of the tile, and a CTA's results slot
//     for step t-1 only after it received the CTA's dgates of step t, which
//     follow the CTA's reads of the slot.  The Luong read's dquery = bf16(dq
//     @ wq^T) runs the same way, as a second exchange inside the step (its
//     wq, 256 x 256, is 128 KB: read from L2 by every row at every step it
//     cost ~8 us a step): each row's bf16(dq), exact since Luong's dq is
//     rounded, into a dq tile, each CTA's H / 16 rows of wq resident, the
//     results back to the owners.  Bahdanau's wq (256 x 128) is staged whole
//     where it fits and its dquery runs in the row's threads.  The
//     recurrence writes the row's dsc, dctx' and dq per step and never
//     touches dkeys or dvalues.
// (4) the sums after the scan, two launches, each output tile owned by one
//     block, written (no accumulation into a zeroed buffer): dvalues and
//     Luong's dkeys as [S x T] . [T x N] products per row on the tensor
//     cores, the fp32 operand split into two bf16 terms (hi + lo: products
//     exact to ~2^-16, fp32 accumulation; the reference rounds each step's
//     term to bf16 instead), and Bahdanau's dkeys as a tiled pass over (b,
//     32 keys, 128 units) with the keys in registers, looping t and skipping
//     every (t, key) whose dsc is exactly 0 (masked steps, keys of zero
//     weight), which also forms dv's per-tile partials.
// Every sum has one owner and a fixed order, with no atomics: two runs give
// the same bits.  A masked step and a key of zero weight add exactly 0, so
// a 0-length audio or video row's gradients are exactly 0.

#pragma once

#include "attention_mma.cuh"
#include "bahdanau_core.cuh"
#include "cluster_ptx.cuh"

namespace {
namespace align_bwd {

using bahdanau::bf_hi;
using bahdanau::bf_lo;
using bahdanau::bf_round;
using bahdanau::Key;
using bahdanau::tanh_fast;  // the energies' tanh, 19,200 a row and step at the align widths
using mma_attn::bf16;
using mma_attn::cp_async16;
using mma_attn::cp_async4;
using mma_attn::cp_async_commit;
using mma_attn::cp_async_wait;
using mma_attn::ldsm_x4;
using mma_attn::ldsm_x4_trans;
using mma_attn::mma;
using mma_attn::pack_bf16;
using mma_attn::smem_addr;
using namespace cluster_ptx;

constexpr int C = 16;         // CTAs per cluster: an mma row tile of 16 batch rows per RPC
constexpr int HT = 256;       // threads per row a CTA owns (its "half" when it owns two)
constexpr int HWARPS = HT / 32;
constexpr int UPT = 2;        // hidden units per thread: H <= 512

// the barrier of one row's threads (named barriers 1 and 2; 0 is __syncthreads)
__device__ __forceinline__ void row_sync(int half) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(1 + half) : "memory");
}

// the sum of one value per thread over one row's threads, in a fixed order
__device__ __forceinline__ float row_sum(float x, float* red, int htid, int half) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  if ((htid & 31) == 0) red[htid >> 5] = x;
  row_sync(half);
  float r = red[0];
#pragma unroll
  for (int w = 1; w < HWARPS; ++w) r += red[w];
  row_sync(half);  // red is reused by the next reduction
  return r;
}

// a [rows][D] bf16 tile, D a multiple of 64: 16-byte chunk c of row r sits
// at chunk c ^ (r & 7) (conflict-free ldmatrix)
__host__ __device__ __forceinline__ int swzr(int row, int chunk, int D) {
  return row * D + ((chunk ^ (row & 7)) << 3);
}
__host__ __device__ __forceinline__ size_t up16(size_t x) { return (x + 15) & ~(size_t)15; }

// The recurrence's shared memory, byte offsets, for RPC rows per CTA: the
// resident slice of [Wh ; ctx_proj] [NC][4H], the dgates tile [16 RPC][4H],
// each row's own bf16(dgates) [4H] and results [H + Dc] (bf16), wq [H][A]
// (Bahdanau, when staged), each row's fp32 vectors (FL floats); for the
// Luong read the dquery product's pieces: the CTA's H / 16 rows of wq, the
// dq tile [16 RPC][A], each row's own bf16(dq) [A] and dquery results [H];
// four mbarriers (dgates, results, dq, dquery).
struct Layout {
  int NC, K, S4, FL;
  size_t ws, dg, dgrow, res, res_row, wq, fl, wqs, dqt, dqrow, res2, res2_row, bars, total;
  __host__ __device__ Layout(int H, int Dc, int A, int S, int Dv, int RPC, bool wq_smem,
                             bool dot) {
    NC = (H + Dc) / C;
    K = 4 * H;
    S4 = (S + 3) & ~3;
    // q, v, dq [A]; dctx, dco [Dv]; dquery [H]; part [8 HT]; red [8]; w, dsc [S4]
    FL = 3 * A + 2 * Dv + H + 8 * HT + 8 + 2 * S4;
    res_row = up16((size_t)(H + Dc) * 2);
    ws = 0;
    dg = ws + (size_t)NC * K * 2;
    dgrow = dg + (size_t)C * RPC * K * 2;
    res = dgrow + (size_t)RPC * K * 2;
    wq = res + RPC * res_row;
    fl = wq + (wq_smem ? (size_t)H * A * 2 : 0);
    wqs = fl + (size_t)RPC * FL * 4;
    dqt = wqs + (dot ? (size_t)(H / C) * A * 2 : 0);
    dqrow = dqt + (dot ? (size_t)C * RPC * A * 2 : 0);
    res2 = dqrow + (dot ? (size_t)RPC * A * 2 : 0);
    res2_row = up16((size_t)H * 2);
    bars = res2 + (dot ? RPC * res2_row : 0);
    total = bars + 32;
  }
};

struct ScanArgs {
  const bf16* w_all;     // [H + Dc, 4H] rows of [Wh ; ctx_proj]
  const bf16* wq;        // [H, A]
  const bf16* vatt;      // [A] or null (dot)
  const void* keys;      // [B, S, A] fp32 (bf16 for dot)
  const bf16* values;    // [B, S, Dv]
  const float* aligns;   // [T, B, S] the forward's weights
  const float* q;        // [T, B, A] (bf16-rounded for dot)
  const float* act;      // [T, B, 4H] i, f, g, o
  const float* c_res;    // [T, B, H]
  const float* mask;     // [T, B]
  const float* dhs;      // [T, B, H]
  const float* dctxs;    // [T, B, Dv]
  const float* dhT;      // [B, H]
  const float* dcT;      // [B, H]
  const float* dctxT;    // [B, Dv]
  float* dxw;            // [T, B, 4H]
  float* dq;             // [T, B, A]
  float* dsc;            // [T, B, S]
  float* dctxp;          // [T, B, Dv] dctx'
  float* db_rows;        // [B, 4H]
  int T, B, H, Dc, A, S, Dv, wq_smem;
};

// The read backward of one row and step, without the memory's gradients:
// dsc (to dsc_s and dsc_out), dq (dq_s, dq_out) and, for Bahdanau, dquery
// (dquery_s), from
// the weights w_s, q_s (bf16(q) for dot), v_s and dctx' (dctx_s), all in
// shared memory.  The arithmetic of K10's per-step backward (bahdanau_attend.cu).
// The row's HT threads run it (tid their index among them, half the row's
// barrier); LOADS 16-byte loads in flight per thread in its passes.
template <bool DOT, int CPL, int LOADS>
__device__ void read_bwd_rec(int tid, int half, const float* w_s, const float* q_s,
                             const float* v_s, const float* dctx_s,
                             const typename Key<DOT>::type* __restrict__ keys,
                             const bf16* __restrict__ values, const bf16* wq, int H, int A, int S,
                             int Dv, float* dsc_s, float* part, float* red, float* dq_s,
                             float* dquery_s, float* __restrict__ dsc_out,
                             float* __restrict__ dq_out) {
  const int lane = tid & 31, warp = tid >> 5;
  constexpr int KB = LOADS / 2;  // keys in flight per thread in the dq pass

  // dw = bf16(dctx' . values[s]): a warp per key, KPW keys at a time, a
  // lane per 16-byte chunk (8 channels), CPL chunks of a key per lane in
  // flight (LOADS loads a lane); a key of weight 0 is skipped (dw 0)
  {
    constexpr int KPW = LOADS / CPL;
    const int Cc = Dv / 8;
    const float4* dc4 = reinterpret_cast<const float4*>(dctx_s);
    for (int s0 = warp * KPW; s0 < S; s0 += HWARPS * KPW) {
      float acc[KPW], wb[KPW];
#pragma unroll
      for (int j = 0; j < KPW; ++j) {
        acc[j] = 0.f;
        wb[j] = s0 + j < S ? w_s[s0 + j] : 0.f;
      }
      for (int c0 = 0; c0 < Cc; c0 += 32 * CPL) {
        uint4 u[KPW][CPL];
#pragma unroll
        for (int j = 0; j < KPW; ++j)
#pragma unroll
          for (int h = 0; h < CPL; ++h) {
            const int c = c0 + 32 * h + lane;
            u[j][h] = wb[j] != 0.f && c < Cc
                          ? reinterpret_cast<const uint4*>(values + (size_t)(s0 + j) * Dv)[c]
                          : make_uint4(0u, 0u, 0u, 0u);
          }
#pragma unroll
        for (int h = 0; h < CPL; ++h) {
          const int c = c0 + 32 * h + lane;
          const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
          const float4 g0 = c < Cc ? dc4[2 * c] : z, g1 = c < Cc ? dc4[2 * c + 1] : z;
#pragma unroll
          for (int j = 0; j < KPW; ++j) {
            acc[j] = fmaf(g0.x, bf_lo(u[j][h].x), acc[j]);
            acc[j] = fmaf(g0.y, bf_hi(u[j][h].x), acc[j]);
            acc[j] = fmaf(g0.z, bf_lo(u[j][h].y), acc[j]);
            acc[j] = fmaf(g0.w, bf_hi(u[j][h].y), acc[j]);
            acc[j] = fmaf(g1.x, bf_lo(u[j][h].z), acc[j]);
            acc[j] = fmaf(g1.y, bf_hi(u[j][h].z), acc[j]);
            acc[j] = fmaf(g1.z, bf_lo(u[j][h].w), acc[j]);
            acc[j] = fmaf(g1.w, bf_hi(u[j][h].w), acc[j]);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < KPW; ++j) {
        float a = acc[j];
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) a += __shfl_xor_sync(0xffffffffu, a, o);
        if (lane == 0 && s0 + j < S) dsc_s[s0 + j] = bf_round(a);
      }
    }
    row_sync(half);
  }

  // dsc = w * (dw - sum(w * dw))
  {
    float g = 0.f;
    for (int s = tid; s < S; s += HT) g += w_s[s] * dsc_s[s];
    g = row_sum(g, red, tid, half);
    for (int s = tid; s < S; s += HT) {
      const float x = w_s[s] * (dsc_s[s] - g);
      dsc_s[s] = x;
      dsc_out[s] = x;
    }
    row_sync(half);
  }

  // dq: a thread per 4 key units (Bahdanau's fp32 keys) or 8 (Luong's bf16
  // ones), the keys over slices (KB in flight); a key with dsc exactly 0 is
  // skipped
  {
    constexpr int U = DOT ? 8 : 4;  // key units a thread
    const int AU = A / U, slices = HT / AU;
    const int c = tid % AU, sl = tid / AU;
    if (sl < slices) {
      float dq[U];
#pragma unroll
      for (int i = 0; i < U; ++i) dq[i] = 0.f;
      if constexpr (DOT) {
        const uint4* k8 = reinterpret_cast<const uint4*>(keys) + c;
        for (int s0 = sl; s0 < S; s0 += KB * slices) {
          float d[KB];
          uint4 kk[KB];
#pragma unroll
          for (int j = 0; j < KB; ++j) {
            const int s = s0 + j * slices;
            d[j] = s < S ? dsc_s[s] : 0.f;
            kk[j] = d[j] != 0.f ? k8[(size_t)s * AU] : make_uint4(0u, 0u, 0u, 0u);
          }
#pragma unroll
          for (int j = 0; j < KB; ++j) {
            dq[0] = fmaf(d[j], bf_lo(kk[j].x), dq[0]);
            dq[1] = fmaf(d[j], bf_hi(kk[j].x), dq[1]);
            dq[2] = fmaf(d[j], bf_lo(kk[j].y), dq[2]);
            dq[3] = fmaf(d[j], bf_hi(kk[j].y), dq[3]);
            dq[4] = fmaf(d[j], bf_lo(kk[j].z), dq[4]);
            dq[5] = fmaf(d[j], bf_hi(kk[j].z), dq[5]);
            dq[6] = fmaf(d[j], bf_lo(kk[j].w), dq[6]);
            dq[7] = fmaf(d[j], bf_hi(kk[j].w), dq[7]);
          }
        }
      } else {
        const float4 qq = reinterpret_cast<const float4*>(q_s)[c];
        const float4 vv = reinterpret_cast<const float4*>(v_s)[c];
        const float qx[4] = {qq.x, qq.y, qq.z, qq.w};
        const float vx[4] = {vv.x, vv.y, vv.z, vv.w};
        const float4* k4 = reinterpret_cast<const float4*>(keys) + c;
        for (int s0 = sl; s0 < S; s0 += KB * slices) {
          float d[KB];
          float4 kk[KB];
#pragma unroll
          for (int j = 0; j < KB; ++j) {
            const int s = s0 + j * slices;
            d[j] = s < S ? dsc_s[s] : 0.f;
            kk[j] = d[j] != 0.f ? k4[(size_t)s * AU] : make_float4(0.f, 0.f, 0.f, 0.f);
          }
#pragma unroll
          for (int j = 0; j < KB; ++j) {
            if (d[j] == 0.f) continue;
            const float kx[4] = {kk[j].x, kk[j].y, kk[j].z, kk[j].w};
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const float e = tanh_fast(kx[i] + qx[i]);
              const float deb = bf_round(d[j] * vx[i]);
              dq[i] += (deb + deb * e) * (1.0f - e);
            }
          }
        }
      }
#pragma unroll
      for (int i = 0; i < U; ++i) part[sl * A + U * c + i] = dq[i];
    }
    row_sync(half);
    for (int a = tid; a < A; a += HT) {
      float x = 0.f;
      for (int j = 0; j < slices; ++j) x += part[j * A + a];
      if (DOT) x = bf_round(x);  // the cast's cotangent
      dq_s[a] = x;
      dq_out[a] = x;
    }
    row_sync(half);
  }

  // dquery[k] = bf16(dq . wq[k, :]) (Bahdanau; the Luong read's runs on
  // the cluster's tensor cores, in the recurrence): a thread per query unit,
  // its row's 16-byte chunks LOADS at a time, in an order rotated by k
  // (spreads the shared-memory banks when wq is staged)
  if constexpr (!DOT) {
    const int A8 = A / 8;
    for (int k = tid; k < H; k += HT) {
      const uint4* wr = reinterpret_cast<const uint4*>(wq + (size_t)k * A);
      const int r0 = k % A8;
      float acc = 0.f;
      for (int i0 = 0; i0 < A8; i0 += LOADS) {
        uint4 u[LOADS];
        int c8[LOADS];
#pragma unroll
        for (int j = 0; j < LOADS; ++j) {
          c8[j] = i0 + j + r0;
          if (c8[j] >= A8) c8[j] -= A8;
          u[j] = i0 + j < A8 ? wr[c8[j]] : make_uint4(0u, 0u, 0u, 0u);
        }
#pragma unroll
        for (int j = 0; j < LOADS; ++j) {
          if (i0 + j >= A8) continue;
          const float* g = dq_s + 8 * c8[j];
          acc = fmaf(g[0], bf_lo(u[j].x), acc);
          acc = fmaf(g[1], bf_hi(u[j].x), acc);
          acc = fmaf(g[2], bf_lo(u[j].y), acc);
          acc = fmaf(g[3], bf_hi(u[j].y), acc);
          acc = fmaf(g[4], bf_lo(u[j].z), acc);
          acc = fmaf(g[5], bf_hi(u[j].z), acc);
          acc = fmaf(g[6], bf_lo(u[j].w), acc);
          acc = fmaf(g[7], bf_hi(u[j].w), acc);
        }
      }
      dquery_s[k] = bf_round(acc);
    }
  }
}

// (3) The recurrence: a cluster of C CTAs per 16 RPC batch rows, walking
// all T steps (the design note at the top).  CTA rank r owns rows r and, when
// RPC = 2, 16 + r of the cluster's tile, each on HT threads of its own (a
// "half" with its own named barrier); the halves meet at the exchange and the
// product.
template <bool DOT, int CPL, int RPC>
__global__ void __launch_bounds__(HT * RPC, 1) align_bwd_scan(const ScanArgs p) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int NTH = HT * RPC;
  const int H = p.H, K = 4 * H, A = p.A, S = p.S, Dv = p.Dv, T = p.T, B = p.B;
  const Layout L(H, p.Dc, A, S, Dv, RPC, p.wq_smem != 0, DOT);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int half = tid / HT, htid = tid - half * HT;
  const int gid = lane >> 2, tig = lane & 3;
  bf16* ws = reinterpret_cast<bf16*>(smem + L.ws);
  bf16* dg = reinterpret_cast<bf16*>(smem + L.dg);
  bf16* dgrow = reinterpret_cast<bf16*>(smem + L.dgrow) + (size_t)half * K;
  bf16* res = reinterpret_cast<bf16*>(smem + L.res + half * L.res_row);
  bf16* wq_s = reinterpret_cast<bf16*>(smem + L.wq);
  float* q_s = reinterpret_cast<float*>(smem + L.fl) + (size_t)half * L.FL;
  float* v_s = q_s + A;
  float* dq_s = v_s + A;
  float* dctx_s = dq_s + A;
  float* dco_s = dctx_s + Dv;
  float* dquery_s = dco_s + Dv;
  float* part = dquery_s + H;
  float* red = part + 8 * HT;
  float* w_s = red + 8;
  float* dsc_s = w_s + L.S4;
  bf16* wqs = reinterpret_cast<bf16*>(smem + L.wqs);  // Luong: wq rows rank*KQ ..
  bf16* dqt = reinterpret_cast<bf16*>(smem + L.dqt);
  bf16* dqrow = reinterpret_cast<bf16*>(smem + L.dqrow) + (size_t)half * A;
  const bf16* res2 = reinterpret_cast<const bf16*>(smem + L.res2 + half * L.res2_row);
  // [0] dgates, [1] their products, [2] dq (Luong), [3] its products
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L.bars);

  const int rank = (int)cluster_rank();
  const int crow = half * C + rank;  // the row's place in the cluster's tile
  const int b = (blockIdx.x / C) * C * RPC + crow;
  const bool live = b < B;
  const int NC = L.NC, NT = NC / 8, KCH = K / 8, KQ = H / C;
  const bf16* wq = p.wq_smem ? wq_s : p.wq;
  using KeyT = typename Key<DOT>::type;
  const KeyT* keys = static_cast<const KeyT*>(p.keys) + (size_t)(live ? b : 0) * S * A;
  const bf16* values = p.values + (size_t)(live ? b : 0) * S * Dv;

  // the resident slice (rows rank*NC .. of [Wh ; ctx_proj]) and wq
  for (int ci = tid; ci < NC * KCH; ci += NTH) {
    const int n = ci / KCH, c = ci - n * KCH;
    cp_async16(ws + swzr(n, c, K), p.w_all + ((size_t)rank * NC + n) * K + c * 8, true);
  }
  if (p.wq_smem)
    for (int ci = tid; ci < H * A / 8; ci += NTH) cp_async16(wq_s + ci * 8, p.wq + ci * 8, true);
  if (DOT)  // rows rank*KQ .. of wq, the B operand of the CTA's dquery columns
    for (int ci = tid; ci < KQ * (A / 8); ci += NTH) {
      const int n = ci / (A / 8), c = ci - n * (A / 8);
      cp_async16(wqs + swzr(n, c, A), p.wq + ((size_t)rank * KQ + n) * A + c * 8, true);
    }
  cp_async_commit();
  if (!DOT)
    for (int a = htid; a < A; a += HT) v_s[a] = __bfloat162float(p.vatt[a]);
  for (int i = htid; i < K; i += HT) dgrow[i] = __float2bfloat16(0.f);  // a dead row sends 0
  for (int a = htid; a < A; a += HT) dq_s[a] = 0.f;                      // (and dq 0)

  // the row's carries: dh_out, dc (registers, a thread per unit), dctx_out
  float dh_out[UPT], dc[UPT], db[UPT][4];
#pragma unroll
  for (int j = 0; j < UPT; ++j) {
    const int u = htid + j * HT;
    const bool ok = live && u < H;
    dh_out[j] = ok ? p.dhT[(size_t)b * H + u] : 0.f;
    dc[j] = ok ? p.dcT[(size_t)b * H + u] : 0.f;
#pragma unroll
    for (int q = 0; q < 4; ++q) db[j][q] = 0.f;
  }
  for (int d = htid; d < Dv; d += HT) dco_s[d] = live ? p.dctxT[(size_t)b * Dv + d] : 0.f;

  // step t's operands: the cell's in registers, the read's into shared
  // memory by cp.async (waited for at the top of the step)
  float m = 0.f, act_r[UPT][4], cres_r[UPT], dhs_r[UPT];
  auto load_step = [&](int t) {
    const size_t tb = (size_t)t * B + b;
    m = live ? p.mask[tb] : 0.f;
#pragma unroll
    for (int j = 0; j < UPT; ++j) {
      const int u = htid + j * HT;
      const bool ok = live && u < H;
#pragma unroll
      for (int q = 0; q < 4; ++q) act_r[j][q] = ok ? p.act[tb * K + q * H + u] : 0.f;
      cres_r[j] = ok ? p.c_res[tb * H + u] : 0.f;
      dhs_r[j] = ok ? p.dhs[tb * H + u] : 0.f;
    }
    if (live) {
      for (int s = htid; s < S; s += HT) cp_async4(w_s + s, p.aligns + tb * S + s, true);
      if (!DOT)  // Luong's dq needs no q
        for (int c = htid; c < A / 4; c += HT)
          cp_async16(q_s + 4 * c, p.q + tb * A + 4 * c, true);
      for (int c = htid; c < Dv / 4; c += HT)
        cp_async16(dctx_s + 4 * c, p.dctxs + tb * Dv + 4 * c, true);
    }
    cp_async_commit();
  };
  load_step(T - 1);
  if (tid == 0) {
    for (int i = 0; i < 4; ++i) mbar_init(&bars[i], 1);
    fence_mbar_init();
  }
  cp_async_wait<0>();
  // every CTA of the cluster has started, staged and initialised its
  // barriers: dgates and results may be written
  cluster_arrive();
  cluster_wait();

  const uint32_t dg_a = smem_addr(dg);
  const uint32_t res_a = smem_addr(reinterpret_cast<bf16*>(smem + L.res));
  const uint32_t bar_dg = smem_addr(&bars[0]), bar_res = smem_addr(&bars[1]);
  const uint32_t dqt_a = smem_addr(dqt), res2_a = smem_addr(smem + L.res2);
  const uint32_t bar_dq = smem_addr(&bars[2]), bar_res2 = smem_addr(&bars[3]);
  const int sw = crow & 7;  // the row's 16-byte chunks sit at chunk ^ sw in every tile
  float m_next = 0.f;  // the mask of step t + 1
  for (int t = T - 1; t >= 0; --t) {
    const size_t tb = (size_t)t * B + b;
    if (t < T - 1) {  // step t+1's products: slot phase (T - 2 - t)
      if (tid == 0) mbar_expect(&bars[1], (uint32_t)(RPC * L.res_row));
      mbar_wait(&bars[1], (uint32_t)((T - 2 - t) & 1));
      const float keep = 1.0f - m_next;
#pragma unroll
      for (int j = 0; j < UPT; ++j) {
        const int u = htid + j * HT;
        if (u < H) dh_out[j] = __bfloat162float(res[u]) + keep * dh_out[j];
      }
      for (int d = htid; d < Dv; d += HT)
        dco_s[d] = (p.Dc > 0 ? __bfloat162float(res[H + d]) : 0.f) + keep * dco_s[d];
    }
    cp_async_wait<0>();
    __syncthreads();  // the step's w, q and dctxs have landed

    if (live) {
      for (int d = htid; d < Dv; d += HT) {
        const float x = m * (dco_s[d] + dctx_s[d]);
        dctx_s[d] = x;
        p.dctxp[tb * Dv + d] = x;
      }
      row_sync(half);
      if (m != 0.f) {
        read_bwd_rec<DOT, CPL, 16 / RPC>(htid, half, w_s, q_s, v_s, dctx_s, keys, values, wq, H,
                                         A, S, Dv, dsc_s, part, red, dq_s, dquery_s,
                                         p.dsc + tb * S, p.dq + tb * A);
      } else {  // a masked step: the read takes a zero cotangent
        for (int s = htid; s < S; s += HT) p.dsc[tb * S + s] = 0.f;
        for (int a = htid; a < A; a += HT) {
          p.dq[tb * A + a] = 0.f;
          dq_s[a] = 0.f;
        }
        for (int k = htid; k < H; k += HT) dquery_s[k] = 0.f;
      }
      row_sync(half);
    }
    if constexpr (DOT) {
      // dquery = bf16(dq @ wq^T) on the cluster's tensor cores: each row's
      // bf16(dq) (exact: Luong's dq is rounded) into row crow of every CTA's
      // dq tile by one bulk copy a peer, then the CTA's KQ columns of the
      // [16 RPC x A] . [A x H] product to the rows' owners
      for (int c = htid; c < A / 8; c += HT) {
        const float* x = dq_s + 8 * c;
        *reinterpret_cast<uint4*>(dqrow + ((c ^ sw) << 3)) =
            make_uint4(pack_bf16(x[0], x[1]), pack_bf16(x[2], x[3]), pack_bf16(x[4], x[5]),
                       pack_bf16(x[6], x[7]));
      }
      fence_proxy_async();
      __syncthreads();
      if (htid < C)
        bulk_copy_to_peer(map_rank(dqt_a + 2 * crow * A, htid), smem_addr(dqrow), A * 2,
                          map_rank(bar_dq, htid));
      const uint32_t ph = (uint32_t)((T - 1 - t) & 1);
      if (warp < RPC * (KQ / 8)) {
        if (tid == 0) mbar_expect(&bars[2], (uint32_t)(C * RPC * A * 2));
        mbar_wait(&bars[2], ph);
        const int mt = warp / (KQ / 8), n0 = (warp - mt * (KQ / 8)) * 8;
        float acc0[4] = {0.f, 0.f, 0.f, 0.f}, acc1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
        for (int kk = 0; kk < A / 16; kk += 2) {
          uint32_t a0[4], a1[4], bb[4];
          ldsm_x4(a0, dqt + swzr(16 * mt + (lane & 15), 2 * kk + (lane >> 4), A));
          ldsm_x4(a1, dqt + swzr(16 * mt + (lane & 15), 2 * kk + 2 + (lane >> 4), A));
          ldsm_x4(bb, wqs + swzr(n0 + (lane & 7), 2 * kk + (lane >> 3), A));
          mma(acc0, a0, bb[0], bb[1]);
          mma(acc1, a1, bb[2], bb[3]);
        }
        const uint32_t slot =
            res2_a + (uint32_t)(mt * L.res2_row) + 2 * (rank * KQ + n0 + 2 * tig);
        st_async_b32(map_rank(slot, gid), pack_bf16(acc0[0] + acc1[0], acc0[1] + acc1[1]),
                     map_rank(bar_res2, gid));
        st_async_b32(map_rank(slot, gid + 8), pack_bf16(acc0[2] + acc1[2], acc0[3] + acc1[3]),
                     map_rank(bar_res2, gid + 8));
      }
      if (tid == 0) mbar_expect(&bars[3], (uint32_t)(RPC * L.res2_row));
      mbar_wait(&bars[3], ph);
    }
    if (live) {
      // the cell backward of the row's units
#pragma unroll
      for (int j = 0; j < UPT; ++j) {
        const int u = htid + j * HT;
        if (u >= H) continue;
        const float i = act_r[j][0], f = act_r[j][1], g = act_r[j][2], o = act_r[j][3];
        const float c_prev = cres_r[j];
        const float tc = tanhf(f * c_prev + i * g);
        const float dquery = DOT ? __bfloat162float(res2[u]) : dquery_s[u];
        const float dh_new = m * (dh_out[j] + dhs_r[j]) + dquery;
        const float dco = dc[j];
        const float dc_new = m * dco + dh_new * o * (1.0f - tc * tc);
        const float dgq[4] = {dc_new * g * i * (1.0f - i), dc_new * c_prev * f * (1.0f - f),
                              dc_new * i * (1.0f - g * g), dh_new * tc * o * (1.0f - o)};
        dc[j] = dc_new * f + (1.0f - m) * dco;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          p.dxw[tb * K + q * H + u] = dgq[q];
          db[j][q] += dgq[q];
          const int i = q * H + u;
          dgrow[(((i >> 3) ^ sw) << 3) + (i & 7)] = __float2bfloat16(dgq[q]);
        }
      }
    }
    fence_proxy_async();  // dgrow's bytes, before the bulk copies read them
    __syncthreads();  // dgrow is complete; the step's shared operands are read
    m_next = m;
    if (t == 0) break;

    load_step(t - 1);
    // bf16(dgates) of this row (staged in the row's swizzled order) into
    // row crow of every CTA's dgates tile, one bulk copy a peer
    if (htid < C)
      bulk_copy_to_peer(map_rank(dg_a + 2 * crow * K, htid), smem_addr(dgrow), K * 2,
                        map_rank(bar_dg, htid));
    if (tid == 0) mbar_expect(&bars[0], (uint32_t)(C * RPC * K * 2));
    mbar_wait(&bars[0], (uint32_t)((T - 1 - t) & 1));
    // this CTA's NC columns of dgates @ [Wh ; ctx_proj]^T: a warp per (16-row
    // m-tile, 8-column n-tile), two accumulator chains (even and odd k steps)
    if (warp < RPC * NT) {
      const int mt = warp / NT, n0 = (warp - mt * NT) * 8;
      float acc0[4] = {0.f, 0.f, 0.f, 0.f}, acc1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
      for (int kk = 0; kk < K / 16; kk += 2) {
        uint32_t a0[4], a1[4], bb[4];
        ldsm_x4(a0, dg + swzr(16 * mt + (lane & 15), 2 * kk + (lane >> 4), K));
        ldsm_x4(a1, dg + swzr(16 * mt + (lane & 15), 2 * kk + 2 + (lane >> 4), K));
        ldsm_x4(bb, ws + swzr(n0 + (lane & 7), 2 * kk + (lane >> 3), K));
        mma(acc0, a0, bb[0], bb[1]);
        mma(acc1, a1, bb[2], bb[3]);
      }
      // bf16 of each (row, column pair) to the row's owner: tile row 16 mt
      // + gid is rank gid's row of half mt
      const uint32_t slot = res_a + (uint32_t)(mt * L.res_row) + 2 * (rank * NC + n0 + 2 * tig);
      st_async_b32(map_rank(slot, gid), pack_bf16(acc0[0] + acc1[0], acc0[1] + acc1[1]),
                   map_rank(bar_res, gid));
      st_async_b32(map_rank(slot, gid + 8), pack_bf16(acc0[2] + acc1[2], acc0[3] + acc1[3]),
                   map_rank(bar_res, gid + 8));
    }
  }

  if (live) {
#pragma unroll
    for (int j = 0; j < UPT; ++j) {
      const int u = htid + j * HT;
      if (u >= H) continue;
#pragma unroll
      for (int q = 0; q < 4; ++q) p.db_rows[(size_t)b * K + q * H + u] = db[j][q];
    }
  }
  // no CTA leaves while a peer may still address its shared memory
  cluster_arrive();
  cluster_wait();
}

__device__ __forceinline__ float sigmoid_ieee(float x) { return 1.0f / (1.0f + expf(-x)); }

// (1) The regate on the tensor cores: for every row r = (t, b) of R = T * B,
// gates = (xw + [bf16(h_res) | bf16(ctx_res)] @ [Wh ; ctx_proj]) + b (one
// fp32 accumulation over both products), i, f, o = sigmoid, g = tanh -> act
// [R, 4H], and h' = o * tanh(f * c_res + i * g) -> hnew [R, H].  A block of
// 4 warps owns 64 rows x 16 hidden units (their four gates: 64 columns),
// over k = the H + Dc rows of w_all in chunks of 64: the rows' fp32 carries
// rounded to bf16 into a [row][k] tile, w_all's chunk by cp.async into a
// [k][gate, unit] tile; the products' fragments then pass through the same
// shared memory, so that a thread takes the four gates of one (row, unit)
// at a time.  The sums' order and association differ from the forward's
// CUDA-core gate launch: h' within fp32 rounding of it.
__global__ void __launch_bounds__(128) align_regate_mma(
    const bf16* __restrict__ w_all, const float* __restrict__ bias, const float* __restrict__ xw,
    const float* __restrict__ h_res, const float* __restrict__ c_res,
    const float* __restrict__ ctx_res, float* __restrict__ act, float* __restrict__ hnew, int R,
    int H, int Dc) {
  __shared__ __align__(128) unsigned char tiles[64 * 64 * 4];
  bf16* a_s = reinterpret_cast<bf16*>(tiles);  // [row][k]
  bf16* b_s = a_s + 64 * 64;                   // [k][16 q + unit]
  float* g_s = reinterpret_cast<float*>(tiles);  // after the products: [row][16 q + unit]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int u0 = blockIdx.x * 16, r0 = blockIdx.y * 64, K4 = 4 * H;
  float acc[4][2][4];  // [gate][unit group of 8][fragment]
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[q][j][e] = 0.f;
  for (int k0 = 0; k0 < H + Dc; k0 += 64) {
    const bool is_h = k0 < H;  // H is a multiple of 64: a chunk is h's or ctx's
    const float* src = is_h ? h_res : ctx_res;
    const int ld = is_h ? H : Dc, kc = is_h ? k0 : k0 - H;
    for (int i = tid; i < 64 * 8; i += 128) {
      const int k = i >> 3, ch = i & 7;
      cp_async16(b_s + swzr(k, ch, 64), w_all + (size_t)(k0 + k) * K4 + (ch >> 1) * H + u0 +
                                            8 * (ch & 1), true);
    }
    cp_async_commit();
    for (int i = tid; i < 64 * 16; i += 128) {
      const int r = i >> 4, c4 = i & 15;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r0 + r < R)
        v = *reinterpret_cast<const float4*>(src + (size_t)(r0 + r) * ld + kc + 4 * c4);
      *reinterpret_cast<uint2*>(a_s + swzr(r, c4 >> 1, 64) + 4 * (c4 & 1)) =
          make_uint2(pack_bf16(v.x, v.y), pack_bf16(v.z, v.w));
    }
    cp_async_wait<0>();
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t a[4];
      mma_attn::load_a<64>(a, a_s, warp * 16, kk, lane);
#pragma unroll
      for (int q = 0; q < 4; ++q) {  // columns 16 q .. 16 q + 15: gate q of the 16 units
        uint32_t bb[4];
        mma_attn::load_bt<64>(bb, b_s, 16 * kk, q, lane);
        mma(acc[q][0], a, bb[0], bb[1]);
        mma(acc[q][1], a, bb[2], bb[3]);
      }
    }
    __syncthreads();  // the tiles are read
  }
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        g_s[(warp * 16 + gid + 8 * (e >> 1)) * 64 + 16 * q + 8 * j + 2 * tig + (e & 1)] =
            acc[q][j][e];
  __syncthreads();
#pragma unroll 1
  for (int i = tid; i < 64 * 16; i += 128) {
    const int r = i >> 4, u = i & 15, row = r0 + r, unit = u0 + u;
    if (row >= R) continue;
    float gt[4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
      gt[q] = (xw[(size_t)row * K4 + q * H + unit] + g_s[r * 64 + 16 * q + u]) +
              bias[q * H + unit];
    const float ig = sigmoid_ieee(gt[0]), f = sigmoid_ieee(gt[1]), g = tanhf(gt[2]),
                o = sigmoid_ieee(gt[3]);
    float* a4 = act + (size_t)row * K4 + unit;
    a4[0] = ig;
    a4[H] = f;
    a4[2 * H] = g;
    a4[3 * H] = o;
    hnew[(size_t)row * H + unit] = o * tanhf(f * c_res[(size_t)row * H + unit] + ig * g);
  }
}

// (2) q = bf16(hnew) @ wq for R = T * B rows on the tensor cores, rounded to
// bf16 when `round` (the dot score's cast): blocks of 4 warps walk 64-row
// tiles, wq [H][A] staged once per block.
__global__ void __launch_bounds__(128) align_query_kernel(const float* __restrict__ hnew,
                                                          const bf16* __restrict__ wq,
                                                          float* __restrict__ q, int R, int H,
                                                          int A, int round) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* wq_s = reinterpret_cast<bf16*>(smem);  // [H][A], rows k
  bf16* h_s = wq_s + (size_t)H * A;            // [64][H]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int A8 = A / 8, H4 = H / 4;
  for (int ci = tid; ci < H * A8; ci += 128) {
    const int k = ci / A8, c = ci - k * A8;
    cp_async16(wq_s + swzr(k, c, A), wq + (size_t)k * A + c * 8, true);
  }
  cp_async_commit();
  const int tiles = (R + 63) / 64;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int r0 = tile * 64;
    __syncthreads();  // the previous tile's rows are read
    for (int i = tid; i < 64 * H4; i += 128) {
      const int r = i / H4, k4 = i - r * H4;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r0 + r < R) v = reinterpret_cast<const float4*>(hnew + (size_t)(r0 + r) * H)[k4];
      *reinterpret_cast<uint2*>(h_s + swzr(r, k4 >> 1, H) + 4 * (k4 & 1)) =
          make_uint2(pack_bf16(v.x, v.y), pack_bf16(v.z, v.w));
    }
    cp_async_wait<0>();
    __syncthreads();
    for (int nc = 0; nc < A / 64; ++nc) {
      float acc[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
      for (int kk = 0; kk < H / 16; ++kk) {
        uint32_t a[4];
        ldsm_x4(a, h_s + swzr(warp * 16 + (lane & 15), 2 * kk + (lane >> 4), H));
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          uint32_t bb[4];
          ldsm_x4_trans(bb, wq_s + swzr(16 * kk + (lane & 7) + (((lane >> 3) & 1) << 3),
                                        2 * (4 * nc + np) + (lane >> 4), A));
          mma(acc[2 * np], a, bb[0], bb[1]);
          mma(acc[2 * np + 1], a, bb[2], bb[3]);
        }
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = nc * 64 + 8 * j + 2 * tig;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = r0 + warp * 16 + gid + 8 * r;
          if (row >= R) continue;
          float x0 = acc[j][2 * r], x1 = acc[j][2 * r + 1];
          if (round) {
            x0 = bf_round(x0);
            x1 = bf_round(x1);
          }
          *reinterpret_cast<float2*>(q + (size_t)row * A + col) = make_float2(x0, x1);
        }
      }
    }
  }
}

// (4) out[b, m, n] = sum_t P[t, b, m] X[t, b, n] for a 64 x 64 tile
// (blockIdx: n tile, m tile, b): the split operand as hi + lo bf16 terms
// (P when SPLIT_P, else X), the other rounded to bf16 (exact for w and
// Luong's bf16(q)); 64 steps a chunk, staged through registers (P
// transposed to [m][t], X as [t][n]).  M any, N a multiple of 64.
template <bool SPLIT_P>
__global__ void __launch_bounds__(128) align_outer_sum(const float* __restrict__ P,
                                                       const float* __restrict__ X,
                                                       float* __restrict__ out, int T, int B,
                                                       int M, int N) {
  __shared__ __align__(128) bf16 pa[2][64 * 64];  // [m][t]: hi, lo
  __shared__ __align__(128) bf16 xb[2][64 * 64];  // [t][n]: hi, lo
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int n0 = blockIdx.x * 64, m0 = blockIdx.y * 64, b = blockIdx.z;
  float acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  for (int t0 = 0; t0 < T; t0 += 64) {
    for (int i = tid; i < 64 * 64; i += 128) {
      const int k = i >> 6, mm = i & 63, t = t0 + k, mi = m0 + mm;
      const float x = (t < T && mi < M) ? P[((size_t)t * B + b) * M + mi] : 0.f;
      const bf16 hi = __float2bfloat16(x);
      const int o = swzr(mm, k >> 3, 64) + (k & 7);
      pa[0][o] = hi;
      if (SPLIT_P) pa[1][o] = __float2bfloat16(x - __bfloat162float(hi));
    }
    for (int i = tid; i < 64 * 16; i += 128) {
      const int k = i >> 4, n4 = i & 15, t = t0 + k;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (t < T) x = reinterpret_cast<const float4*>(X + ((size_t)t * B + b) * N + n0)[n4];
      const uint32_t h01 = pack_bf16(x.x, x.y), h23 = pack_bf16(x.z, x.w);
      const int o = swzr(k, n4 >> 1, 64) + 4 * (n4 & 1);
      *reinterpret_cast<uint2*>(&xb[0][o]) = make_uint2(h01, h23);
      if (!SPLIT_P)
        *reinterpret_cast<uint2*>(&xb[1][o]) =
            make_uint2(pack_bf16(x.x - bf_lo(h01), x.y - bf_hi(h01)),
                       pack_bf16(x.z - bf_lo(h23), x.w - bf_hi(h23)));
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t a[4], a2[4];
      mma_attn::load_a<64>(a, pa[0], warp * 16, kk, lane);
      if (SPLIT_P) mma_attn::load_a<64>(a2, pa[1], warp * 16, kk, lane);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bb[4];
        mma_attn::load_bt<64>(bb, xb[0], 16 * kk, np, lane);
        mma(acc[2 * np], a, bb[0], bb[1]);
        mma(acc[2 * np + 1], a, bb[2], bb[3]);
        if (SPLIT_P) {
          mma(acc[2 * np], a2, bb[0], bb[1]);
          mma(acc[2 * np + 1], a2, bb[2], bb[3]);
        } else {
          mma_attn::load_bt<64>(bb, xb[1], 16 * kk, np, lane);
          mma(acc[2 * np], a, bb[0], bb[1]);
          mma(acc[2 * np + 1], a, bb[2], bb[3]);
        }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = n0 + 8 * j + 2 * tig;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = m0 + warp * 16 + gid + 8 * r;
      if (row < M)
        *reinterpret_cast<float2*>(out + ((size_t)b * M + row) * N + col) =
            make_float2(acc[j][2 * r], acc[j][2 * r + 1]);
    }
  }
}

constexpr int ES = 32;   // keys per block of the energy pass
constexpr int ETC = 32;  // steps a chunk

// (4) Bahdanau's dkeys and dv's partials: a block per (32 keys, row b, 128
// units), warp w keys 4w .. 4w+3 of the tile, a lane 4 units; the keys in
// registers, dsc and q staged 32 steps at a time.  dv_part [B, ceil(S/32),
// A]: the block's sum over its keys and all steps.
__global__ void __launch_bounds__(256) align_dkeys_energy(
    const float* __restrict__ keys, const float* __restrict__ q, const float* __restrict__ dsc,
    const bf16* __restrict__ vatt, float* __restrict__ dkeys, float* __restrict__ dv_part, int T,
    int B, int S, int A) {
  __shared__ float dsc_c[ETC][ES];
  __shared__ __align__(16) float q_c[ETC][128];
  __shared__ float dv_red[8][128];
  const int tid = threadIdx.x, lane = tid & 31, sg = tid >> 5;
  const int s0 = blockIdx.x * ES, b = blockIdx.y, a0 = blockIdx.z * 128;
  const int a = a0 + 4 * lane;
  const bool aok = a < A;
  float kx[4][4], acc[4][4], dv[4] = {0.f, 0.f, 0.f, 0.f}, vv[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = s0 + 4 * sg + i;
    float4 k4 = make_float4(0.f, 0.f, 0.f, 0.f);
    if (aok && s < S) k4 = *reinterpret_cast<const float4*>(keys + ((size_t)b * S + s) * A + a);
    kx[i][0] = k4.x;
    kx[i][1] = k4.y;
    kx[i][2] = k4.z;
    kx[i][3] = k4.w;
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) vv[j] = aok ? __bfloat162float(vatt[a + j]) : 0.f;
  for (int t0 = 0; t0 < T; t0 += ETC) {
    __syncthreads();  // the previous chunk is consumed
    for (int i = tid; i < ETC * ES; i += 256) {
      const int tt = i / ES, ss = i - tt * ES, t = t0 + tt, s = s0 + ss;
      dsc_c[tt][ss] = (t < T && s < S) ? dsc[((size_t)t * B + b) * S + s] : 0.f;
    }
    for (int i = tid; i < ETC * 32; i += 256) {
      const int tt = i >> 5, c = i & 31, t = t0 + tt, aa = a0 + 4 * c;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (t < T && aa < A) x = *reinterpret_cast<const float4*>(q + ((size_t)t * B + b) * A + aa);
      reinterpret_cast<float4*>(q_c[tt])[c] = x;
    }
    __syncthreads();
    const int tn = min(ETC, T - t0);
    for (int tt = 0; tt < tn; ++tt) {
      const float4 q4 = reinterpret_cast<const float4*>(q_c[tt])[lane];
      const float qx[4] = {q4.x, q4.y, q4.z, q4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float d = dsc_c[tt][4 * sg + i];  // one key for the whole warp
        if (d == 0.f) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float e = tanh_fast(kx[i][j] + qx[j]);
          const float deb = bf_round(d * vv[j]);
          acc[i][j] += (deb + deb * e) * (1.0f - e);
          dv[j] = fmaf(d, bf_round(e), dv[j]);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = s0 + 4 * sg + i;
    if (aok && s < S)
      *reinterpret_cast<float4*>(dkeys + ((size_t)b * S + s) * A + a) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) dv_red[sg][4 * lane + j] = dv[j];
  __syncthreads();
  if (tid < 128 && a0 + tid < A) {
    float x = 0.f;
#pragma unroll
    for (int w = 0; w < 8; ++w) x += dv_red[w][tid];
    dv_part[((size_t)b * gridDim.x + blockIdx.x) * A + a0 + tid] = x;
  }
}

// ---- launches ---------------------------------------------------------------

// the recurrence's shared memory: wq staged when the total fits
inline bool stage_wq(int H, int Dc, int A, int S, int Dv, int RPC, bool dot, size_t limit) {
  return !dot && Layout(H, Dc, A, S, Dv, RPC, true, dot).total <= limit;
}

// the dw pass's 16-byte chunks of a value row per lane: two where the row
// has more than 256 channels
inline int chunks_per_lane(int Dv) { return Dv > 256 ? 2 : 1; }

template <bool DOT, int CPL, int RPC>
cudaLaunchConfig_t scan_config(const Layout& L, int B, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C * ((B + C * RPC - 1) / (C * RPC)), 1, 1);
  cfg.blockDim = dim3(HT * RPC, 1, 1);
  cfg.dynamicSmemBytes = L.total;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <bool DOT, int CPL, int RPC>
cudaError_t set_scan_attributes(const Layout& L) {
  auto* kern = align_bwd_scan<DOT, CPL, RPC>;
  cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.total);
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
}

template <bool DOT, int CPL, int RPC>
cudaError_t scan_t(const ScanArgs& args, cudaStream_t st, size_t limit) {
  const Layout L(args.H, args.Dc, args.A, args.S, args.Dv, RPC, args.wq_smem != 0, DOT);
  if (L.total > limit) return cudaErrorInvalidValue;
  cudaError_t e = set_scan_attributes<DOT, CPL, RPC>(L);
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = scan_config<DOT, CPL, RPC>(L, args.B, attr);
  cfg.stream = st;
  e = cudaLaunchKernelEx(&cfg, align_bwd_scan<DOT, CPL, RPC>, args);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <bool DOT>
cudaError_t scan(const ScanArgs& args, int rpc, cudaStream_t st, size_t limit) {
  const bool two = chunks_per_lane(args.Dv) == 2;
  if (rpc == 2)
    return two ? scan_t<DOT, 2, 2>(args, st, limit) : scan_t<DOT, 1, 2>(args, st, limit);
  return two ? scan_t<DOT, 2, 1>(args, st, limit) : scan_t<DOT, 1, 1>(args, st, limit);
}

// the recurrence's clusters that can be resident at once (0 on an error)
template <bool DOT, int CPL, int RPC>
int max_active_t(int H, int Dc, int A, int S, int Dv, size_t limit) {
  const Layout L(H, Dc, A, S, Dv, RPC, stage_wq(H, Dc, A, S, Dv, RPC, DOT, limit), DOT);
  if (L.total > limit || set_scan_attributes<DOT, CPL, RPC>(L) != cudaSuccess) return 0;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = scan_config<DOT, CPL, RPC>(L, 16 * C * RPC, attr);
  int n = 0;
  return cudaOccupancyMaxActiveClusters(&n, (void*)align_bwd_scan<DOT, CPL, RPC>, &cfg) ==
                 cudaSuccess
             ? n
             : 0;
}

template <bool DOT>
int max_active(int H, int Dc, int A, int S, int Dv, int rpc, size_t limit) {
  const bool two = chunks_per_lane(Dv) == 2;
  if (rpc == 2)
    return two ? max_active_t<DOT, 2, 2>(H, Dc, A, S, Dv, limit)
               : max_active_t<DOT, 1, 2>(H, Dc, A, S, Dv, limit);
  return two ? max_active_t<DOT, 2, 1>(H, Dc, A, S, Dv, limit)
             : max_active_t<DOT, 1, 1>(H, Dc, A, S, Dv, limit);
}

}  // namespace align_bwd
}  // namespace

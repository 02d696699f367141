// K8's forward on thread-block clusters: the AV-Align fusion scan
// (av_align_scan.cu's avsr_av_align_fwd), one persistent launch per call.
// The function is av_align_scan.cu's (its header comment): the scan body of
// avsr_tpu/models/fusion.py:av_align_apply (:118-141), rnn.lstm_step
// (avsr_tpu/ops/rnn.py:112-127) and the read of ops/attention.py:125-178
// under the bf16 policy, for either score (the template argument DOT).
// Per step t and batch row, with m = mask[t, b]:
//
//   gates = ((xw[t] + bf16(ctx) @ bf16(ctx_proj)) + bf16(h) @ bf16(Wh)) + b
//   i, f, o = sigmoid; g = tanh;  c' = f*c + i*g;  h' = o * tanh(c')
//   q = bf16(h') @ wq (fp32; rounded to bf16 for the dot score)
//   ctx', w = the read of the video memory from q        (bahdanau_core.cuh)
//   (h, c, ctx) <- m*(h', c', ctx') + (1-m)*(h, c, ctx)
//   hs[t] = h' * m;  ctxs[t] = ctx' * m;  aligns[t] = w * m
//
// The mask is a length mask (0 or 1 at each step, as av_align_apply builds
// it): bf16 of the carried h is then bf16(h') on a live step, the read's
// query, and a masked step skips the read, which the masked update makes of
// it anyway.
//
// What bounds it on an H100: the chain of T dependent steps.  A step of one
// row multiplies [bf16 h ; bf16 ctx] [768] into [Wh ; ctx_proj] [768 x 1024]
// (lrs2_av_align's widths) and reads the row's keys and values from L2
// (Bahdanau at T_v = 150: 77 KB fp32 keys, 154 KB bf16 values).  The
// per-step kernels this replaces took two launches a step (394 a call at
// T = 197), re-staged each gate block's weight slices (96 KB) from L2 at
// every step and ran the gate product on the CUDA cores: 33 us a step.
//
// Design.  A cluster of C = 16 CTAs (a non-portable size) owns 16 RPC batch
// rows and walks all T steps; clusters never wait on each other, so more
// clusters than fit at once run in waves.  RPC, the rows a CTA reads, is 1,
// or 2 where the card cannot hold every 16-row cluster at once (at B = 128,
// 7 of 8 fit: kernels.av_align_fwd_rows_per_cta).
// - Gate warps.  CTA r owns the UR = H / 16 hidden units [r UR, (r+1) UR)
//   with all four gates, so the cell update stays in the CTA, and holds its
//   4 UR columns of [Wh ; ctx_proj] (96 KB bf16 at H = 256, Dc = 512; 64 KB
//   for the Luong fusion's Dc = 256) resident in shared memory for the
//   whole scan (kernels.cluster_align_weights: per unit group of 8, a [K]
//   [32] run, 16-byte chunk q of row k at q ^ ((k >> 1) & 3), so that
//   ldmatrix.trans gives the B fragments conflict-free).  Per m-tile of 16
//   rows, KS NW warps (NW = UR / 8 unit groups x KS parts of k) run
//   mma.sync m16n8k16 (bf16 operands, fp32 accumulators) on the bf16 h and
//   ctx tiles, the two products in two accumulators so that the sum keeps
//   the reference's order ((xw + ctx.cp) + h.Wh) + b.  At one row a CTA k
//   is split in two halves (KS = 2): the second half's warps leave their
//   partials in shared memory.  At two rows a CTA each warp takes all of k
//   (KS = 1): 640 threads leave 96 registers a thread, where 768 left 80 and
//   spilled.  The first part's warps do the cell update in registers, where
//   the fp32 c and h carries stay (rows gid, gid + 8, units 2 tig, 2 tig + 1
//   of a warp's group: four cells a thread, as lstm_cluster.cuh), and the
//   next step's xw comes by cp.async into shared memory.  The h product of
//   step t+1 needs only h_{t+1}: it runs while step t's read is in flight,
//   and the ctx product waits for the read's context.
// - Read threads.  CTA r reads row r of each m-tile on THREADS = 256
//   threads of its own (a named barrier per row, bahdanau::RowGroup):
//   bahdanau_core.cuh's scores, softmax, renormalisation and context with
//   its loads in flight, from its q.  The energies' tanh is the backward's
//   tanh_fast and the context keeps half as many value rows in flight at
//   two rows a CTA: with tanhf and 8 rows the 96 registers of 640 threads
//   spilled.  q runs on the cluster's tensor cores as an exchange: each
//   CTA holds wq's A / 16 columns [r A/16, (r+1) A/16)
//   (4 KB / 8 KB), computes them for every row of the tile from the h tile
//   and sends each row's values to the row's owner (no CTA holds all of
//   wq: the Luong read's is 128 KB).  A masked step skips the read and
//   writes zeros.
// - Exchanges (st.async and bulk copies into the peers' shared memory,
//   each counted on the receiver's mbarrier; cluster_ptx.cuh).  Each unit
//   owner sends bf16 of its cells' carried h to row and unit of every
//   peer's h tile, slot (t+1) % 2; each row owner sends bf16 of the row's
//   carried context, staged in the tile's swizzled order, to the row of
//   every peer's ctx tile (one bulk copy a peer, every step, a masked one
//   too: so the ctx phase of every step waits on every row owner, which
//   keeps the read threads within one step of the gate warps); q values go
//   to their row's owner.  The fp32 h, c and ctx stay with their owners for
//   the masked update and the outputs hs, ctxs, aligns and (save mode) the
//   carries entering each step, h_res, c_res, ctx_res.
//   No step waits on a cluster-wide barrier: one only opens the scan
//   (every CTA started, its barriers initialised) and one closes it (no
//   CTA leaves while a peer may address its shared memory).
// Why two h slots and one slot each of ctx and q suffice.  h_{t+1} goes to
// slot (t+1) % 2 after a CTA's cell update of step t; the slot's previous
// contents, h_{t-1}, were last read by the q product of step t-2, which
// precedes its reader's send of step t-2's context, and by the h product of
// step t-1, which precedes its CTA's sends of h_t, which its reader waits
// for before it sends step t-1's context; every cell update of step t waits
// for that context, and h_{t+1} follows it.  The context of step t reaches a
// peer's ctx tile after the row owner received h_{t+1} from that peer, which
// the peer sends after its gate warps' reads, at step t, of what the tile
// held (step t-1's context; in program order, and at one row a CTA through
// the barrier of the two halves of k).  q of step t+1 reaches its owner
// after h_{t+2}, which follows the owner's context of step t, sent after its
// read of step t used q.  The staging row of a context is rewritten only
// after h_{t+2}, by which time every peer has received the bulk copy that
// read it.  And the bytes of one phase of a barrier cannot meet the previous
// phase, whose local arrival (expect_tx) precedes what the senders needed
// first.  No atomics, every sum in a fixed order: two runs give the same
// bits.
// Rows past B run on zeros and write nothing; a 0-length audio row (every
// step masked) carries its zero state and emits zeros; a 0-length video row
// reads zero weights and a zero context (bahdanau_core.cuh).

#pragma once

#include "av_align_bwd.cuh"

namespace {
namespace align_fwd {

using align_bwd::swzr;
using align_bwd::up16;
using bahdanau::bf_round;
using bahdanau::Key;
using bahdanau::RowGroup;
using mma_attn::bf16;
using mma_attn::cp_async16;
using mma_attn::cp_async_commit;
using mma_attn::cp_async_wait;
using mma_attn::ldsm_x4;
using mma_attn::ldsm_x4_trans;
using mma_attn::mma;
using mma_attn::pack_bf16;
using mma_attn::smem_addr;
using namespace cluster_ptx;

constexpr int C = 16;                  // CTAs per cluster: one mma row tile of rows per RPC
constexpr int RT = bahdanau::THREADS;  // read threads per row
constexpr int MAX_NW = 2;              // unit groups of 8 per CTA: H <= 256

// parts of k per unit group's gate warps: two halves at one row a CTA, all
// of k at two (the register budget of 640 threads)
__host__ __device__ constexpr int k_parts(int RPC) { return RPC == 1 ? 2 : 1; }
// threads of a CTA: the reads' and the gate warps'
__host__ __device__ constexpr int threads(int RPC, int NW) {
  return RPC * (RT + 32 * k_parts(RPC) * NW);
}

// sigmoid and tanh from one ex2.approx and one rcp.approx each, as
// lstm_cluster.cuh's: the cell update sits on the serial chain of every step
__device__ __forceinline__ float sigm(float x) { return __fdividef(1.0f, 1.0f + __expf(-x)); }
__device__ __forceinline__ float tanh_(float x) {
  return 1.0f - __fdividef(2.0f, 1.0f + __expf(2.0f * x));
}

// a unit group's [K][32] slice: 16-byte chunk q of row k at q ^ ((k >> 1) & 3)
__device__ __forceinline__ int swzw(int k, int q) { return k * 32 + ((q ^ ((k >> 1) & 3)) << 3); }

// The shared memory, byte offsets, for RPC rows per CTA: the resident slice
// [NW][K][32]; wq's A/16 columns as NQ n-tiles [NQ][H][8]; the h tile, two
// slots of [16 RPC][H]; the ctx tile [16 RPC][Dc] (bf16, swizzled rows);
// the second k half's partials [NW][32 values][32 lanes] fp32 (one row a
// CTA only); the
// next step's xw of each cell thread [RPC][NW][8 pairs][32 lanes][2]; per row
// read, q [A] (the exchange's target), v [A], the fp32 context carry [Dv],
// the scores [S4], reduction slots [8], partial sums [8 THREADS] fp32 and the
// bf16 carry staged for its bulk copies [Dc]; the mbarriers: h slots 0 and
// 1, ctx, q of each row.
struct Layout {
  int K, NW, NQ, S4;
  size_t ws, wq, ht, ht_slot, ct, part, xs, rows, row, bars, total;
  __host__ __device__ Layout(int H, int Dc, int A, int S, int Dv, int RPC) {
    K = H + Dc;
    NW = H / 128;
    NQ = A / 128;
    S4 = (S + 3) & ~3;
    ws = 0;
    wq = ws + (size_t)NW * K * 32 * 2;
    ht = wq + (size_t)NQ * H * 8 * 2;
    ht_slot = (size_t)C * RPC * H * 2;
    ct = ht + 2 * ht_slot;
    part = ct + (size_t)C * RPC * Dc * 2;
    xs = part + (RPC == 1 ? (size_t)NW * 32 * 32 * 4 : 0);
    rows = xs + (size_t)RPC * NW * 32 * 16 * 4;
    row = up16((size_t)(2 * A + Dv + S4 + 8 + 8 * RT) * 4 + (size_t)Dc * 2);
    bars = rows + RPC * row;
    total = bars + (size_t)(3 + RPC) * 8;
  }
};

struct FwdArgs {
  const bf16* w;        // [16, NW, H + Dc, 32] kernels.cluster_align_weights
  const bf16* wq;       // [H, A]
  const bf16* vatt;     // [A] or null (dot)
  const float* bias;    // [4H]
  const float* xw;      // [T, B, 4H]
  const float* mask;    // [T, B]
  const void* keys;     // [B, S, A] fp32 (bf16 for dot)
  const bf16* values;   // [B, S, Dv]
  const float* mbias;   // [B, S]
  const float* mmask;   // [B, S]
  float* hs;            // [T, B, H]
  float* ctxs;          // [T, B, Dv]
  float* aligns;        // [T, B, S]
  float* hT;            // [B, H]
  float* cT;            // [B, H]
  float* ctxT;          // [B, Dv]
  float* h_res;         // [T, B, H] or null
  float* c_res;         // [T, B, H] or null
  float* ctx_res;       // [T, B, Dv] or null
  int T, B, H, Dc, A, S, Dv;
};

// acc[q][e] = the product of the A tile's m-tile mt (bf16, swizzled rows of
// D) over k-steps [k0, k1) and the unit group's slice rows kw + 16 kk ..:
// the C fragments of its four gate n-tiles (e = 0, 1 row gid, units 2 tig +
// e; e = 2, 3 row gid + 8).  One chain per gate: the four n-tiles' mma.sync
// of a k-step are independent.
__device__ __forceinline__ void gate_part(const bf16* at, int D, int mt, const bf16* wsg, int kw,
                                          int k0, int k1, int lane, float (&acc)[4][4]) {
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[q][e] = 0.f;
  const int r8 = (lane & 7) + ((lane >> 3) & 1) * 8, hi = lane >> 4, arow = 16 * mt + r8;
#pragma unroll 4
  for (int kk = k0; kk < k1; ++kk) {
    uint32_t x[4];
    ldsm_x4(x, at + swzr(arow, 2 * kk + hi, D));
    const int kr = kw + 16 * kk + r8;
#pragma unroll
    for (int qp = 0; qp < 2; ++qp) {  // gates 2 qp and 2 qp + 1
      uint32_t b[4];
      ldsm_x4_trans(b, wsg + swzw(kr, 2 * qp + hi));
      mma(acc[2 * qp], x, b[0], b[1]);
      mma(acc[2 * qp + 1], x, b[2], b[3]);
    }
  }
}

// 8 bytes global -> shared; zero-filled (nothing read) when !valid
__device__ __forceinline__ void cp_async8(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 8 : 0)
               : "memory");
}

// the context's epilogue of one row: ctxs[t] = ctx' * m, the fp32 carry,
// and bf16 of the carry into the staging row in its tile row's swizzle
struct FwdContext {
  float* ctxs;  // this row's [Dv] slice of ctxs[t]
  float* ctx;   // the fp32 carry [Dv]
  bf16* stage;  // [Dc]
  float m;
  int sw;
  __device__ void operator()(int d, float x) const {
    ctxs[d] = x * m;
    const float c = m * x + (1.0f - m) * ctx[d];
    ctx[d] = c;
    stage[(((d >> 3) ^ sw) << 3) + (d & 7)] = __float2bfloat16(c);
  }
};

// the weights' epilogue of one row (either route): aligns[t] = w * m
struct AlignWeights {
  float* aligns;  // this row's [S] slice of aligns[t]
  float m;
  __device__ void operator()(int s, float w) const { aligns[s] = w * m; }
};

template <bool DOT, int RPC>
__global__ void __launch_bounds__(threads(RPC, MAX_NW), 1) align_fwd_scan(const FwdArgs p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int H = p.H, Dc = p.Dc, A = p.A, S = p.S, Dv = p.Dv, T = p.T, B = p.B, H4 = 4 * H;
  const Layout L(H, Dc, A, S, Dv, RPC);
  const int K = L.K, NW = L.NW, NQ = L.NQ, UR = H / C;
  constexpr int KS = k_parts(RPC);
  constexpr int LOADS = RPC == 1 ? bahdanau::LOADS : bahdanau::LOADS / 2;  // value rows in flight
  const int NTH = threads(RPC, NW);
  const int tid = threadIdx.x, lane = tid & 31, gid = lane >> 2, tig = lane & 3;
  const int rank = (int)cluster_rank();
  const int row0 = (blockIdx.x / C) * C * RPC;  // the cluster's first batch row
  bf16* ws = reinterpret_cast<bf16*>(smem + L.ws);
  bf16* wqs = reinterpret_cast<bf16*>(smem + L.wq);
  bf16* ht = reinterpret_cast<bf16*>(smem + L.ht);
  const bf16* ct = reinterpret_cast<const bf16*>(smem + L.ct);
  float* part = reinterpret_cast<float*>(smem + L.part);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L.bars);  // h0, h1, ctx, q[RPC]
  const size_t ht_elems = L.ht_slot / 2;
  const uint32_t ht_bytes = (uint32_t)L.ht_slot, ct_bytes = (uint32_t)(C * RPC * Dc * 2);
  const bool save = p.h_res != nullptr;

  // the resident slice and wq's columns (16-byte chunks of contiguous runs)
  {
    const bf16* src = p.w + (size_t)rank * NW * K * 32;
    for (int ci = tid; ci < NW * K * 4; ci += NTH) {
      const int g = ci / (K * 4), k = (ci >> 2) - g * K;
      cp_async16(ws + (size_t)g * K * 32 + swzw(k, ci & 3), src + (size_t)ci * 8, true);
    }
    for (int ci = tid; ci < NQ * H; ci += NTH) {
      const int nt = ci / H, k = ci - nt * H;
      cp_async16(wqs + (size_t)ci * 8, p.wq + (size_t)k * A + rank * (A / C) + nt * 8, true);
    }
    cp_async_commit();
  }

  const bool reader = tid < RPC * RT;
  const int half = tid / RT, htid = tid - half * RT;  // a read thread's row and index
  // the row's scratch (the layout's per row list)
  float* q_s = reinterpret_cast<float*>(smem + L.rows + (reader ? half : 0) * L.row);
  float* v_s = q_s + A;
  float* ctx_f = v_s + A;
  float* p_s = ctx_f + Dv;
  float* red = p_s + L.S4;
  float* rpart = red + 8;
  bf16* stage = reinterpret_cast<bf16*>(rpart + 8 * RT);
  if (reader) {
    if (!DOT)
      for (int a = htid; a < A; a += RT) v_s[a] = __bfloat162float(p.vatt[a]);
    for (int d = htid; d < Dv; d += RT) ctx_f[d] = 0.f;
    for (int d = htid; d < Dc; d += RT) stage[d] = __float2bfloat16(0.f);
    fence_proxy_async();  // the staging row's zeros, before the bulk copies read it
  }
  if (tid == 0) {
    for (int i = 0; i < 3 + RPC; ++i) mbar_init(&bars[i], 1);
    fence_mbar_init();
  }
  cp_async_wait<0>();
  // every CTA of the cluster has started, staged and initialised its
  // barriers: the tiles and q may be written
  cluster_arrive();
  cluster_wait();

  if (reader) {
    // ------------------------------------------------------------ the reads
    const int wg = htid >> 5;
    const int crow = half * C + rank, b = row0 + crow;
    const bool live = b < B;
    const RowGroup grp{htid, 1 + half};
    using KeyT = typename Key<DOT>::type;
    const KeyT* keys = static_cast<const KeyT*>(p.keys) + (size_t)(live ? b : 0) * S * A;
    const bf16* values = p.values + (size_t)(live ? b : 0) * S * Dv;
    const uint32_t q_a = smem_addr(q_s), qbar = smem_addr(&bars[3 + half]);
    const uint32_t ct_a = smem_addr(ct) + (uint32_t)(2 * crow * Dc);
    const uint32_t ctxbar = smem_addr(&bars[2]);
    const int sw = crow & 7;
    float m_next = live ? p.mask[b] : 0.f;
    for (int t = 0; t < T; ++t) {
      const float m = m_next;
      if (t + 1 < T) m_next = live ? p.mask[(size_t)(t + 1) * B + b] : 0.f;
      const int slot = (t + 1) & 1;  // h_{t+1}: the carried h' of step t
      if (tid == 0) mbar_expect(&bars[slot], ht_bytes);
      mbar_wait(&bars[slot], (uint32_t)((t >> 1) & 1));
      // q = bf16(h') @ wq: this CTA's columns for the m-tile's 16 rows, each
      // row's values to its owner (rank gid, gid + 8 of this half)
      if (wg < NQ) {
        const bf16* at = ht + slot * ht_elems;
        const bf16* wb = wqs + (size_t)wg * H * 8;
        float a0[4] = {0.f, 0.f, 0.f, 0.f}, a1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
        for (int kk = 0; kk < H / 16; kk += 2) {
          uint32_t x0[4], x1[4], bb[4];
          ldsm_x4(x0, at + swzr(C * half + (lane & 15), 2 * kk + (lane >> 4), H));
          ldsm_x4(x1, at + swzr(C * half + (lane & 15), 2 * kk + 2 + (lane >> 4), H));
          ldsm_x4_trans(bb, wb + (size_t)(16 * kk + lane) * 8);
          mma(a0, x0, bb[0], bb[1]);
          mma(a1, x1, bb[2], bb[3]);
        }
        const uint32_t qa = q_a + 4 * (rank * (A / C) + wg * 8 + 2 * tig);
        st_async_v2f32(map_rank(qa, gid), a0[0] + a1[0], a0[1] + a1[1], map_rank(qbar, gid));
        st_async_v2f32(map_rank(qa, gid + 8), a0[2] + a1[2], a0[3] + a1[3],
                       map_rank(qbar, gid + 8));
      }
      if (htid == 0) mbar_expect(&bars[3 + half], (uint32_t)(A * 4));
      mbar_wait(&bars[3 + half], (uint32_t)(t & 1));
      if (save && live)  // the context carry entering step t
        for (int d = htid; d < Dv; d += RT) p.ctx_res[((size_t)t * B + b) * Dv + d] = ctx_f[d];
      if (m != 0.f) {
        if (DOT) {  // the dot score's cast of q
          for (int a = htid; a < A; a += RT) q_s[a] = bf_round(q_s[a]);
          grp.sync();
        }
        const size_t tb = (size_t)t * B + b;
        bahdanau::scores_context<DOT, true, LOADS>(
            grp, q_s, v_s, keys, values, p.mbias + (size_t)b * S, p.mmask + (size_t)b * S, A, S,
            Dv, p_s, red, rpart, AlignWeights{p.aligns + tb * S, m},
            FwdContext{p.ctxs + tb * Dv, ctx_f, stage, m, sw});
        fence_proxy_async();  // the staging row's bytes, before the bulk copies read them
        grp.sync();
      } else if (live) {  // a masked step: carry the context, emit zeros
        const size_t tb = (size_t)t * B + b;
        for (int d = htid; d < Dv; d += RT) p.ctxs[tb * Dv + d] = 0.f;
        for (int s = htid; s < S; s += RT) p.aligns[tb * S + s] = 0.f;
      }
      if (t + 1 < T && htid < C)  // the carried context into row crow of every ctx tile
        bulk_copy_to_peer(map_rank(ct_a, htid), smem_addr(stage), (uint32_t)(Dc * 2),
                          map_rank(ctxbar, htid));
    }
    if (live)
      for (int d = htid; d < Dv; d += RT) p.ctxT[(size_t)b * Dv + d] = ctx_f[d];
  } else {
    // ------------------------------------------------- the gate warps
    const int gw = (tid - RPC * RT) >> 5, mt = gw / (KS * NW), w2 = gw - mt * KS * NW;
    const int ug = w2 % NW, kh = w2 / NW;
    const bf16* wsg = ws + (size_t)ug * K * 32;
    float* pp = part + (size_t)ug * 32 * 32 + lane;  // [32 values][32 lanes] (KS = 2: mt = 0)
    const int kh_h = H / 16 / KS, kh_c = Dc / 16 / KS;  // k-steps per part
    // the thread's cells (first half only): rows r[i] of the tile, units u, u + 1
    const int u = rank * UR + ug * 8 + 2 * tig;
    const int r[2] = {C * mt + gid, C * mt + gid + 8};
    const int brow[2] = {row0 + r[0], row0 + r[1]};
    const bool lv[2] = {brow[0] < B, brow[1] < B};
    float h[4] = {0.f, 0.f, 0.f, 0.f}, c[4] = {0.f, 0.f, 0.f, 0.f};
    const float* bias = p.bias + u;  // read at each use (L1): registers are scarce at RPC = 2
    // step t's xw pairs (row i, gate q: units u, u + 1) by cp.async into the
    // thread's slots, and its mask, while step t-1 runs
    float2* xs = reinterpret_cast<float2*>(smem + L.xs) + (size_t)(mt * NW + ug) * 8 * 32 + lane;
    float mc[2], mn[2];
    auto fetch_step = [&](int t) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const size_t tb = (size_t)t * B + (lv[i] ? brow[i] : 0);
#pragma unroll
        for (int q = 0; q < 4; ++q)
          cp_async8(xs + (4 * i + q) * 32, p.xw + tb * H4 + q * H + u, lv[i]);
        mn[i] = lv[i] ? p.mask[tb] : 0.f;
      }
      cp_async_commit();
    };
    if (kh == 0) fetch_step(0);

    float acc_h[4][4], acc_c[4][4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc_h[q][e] = acc_c[q][e] = 0.f;  // h_0 = ctx_0 = 0
    for (int t = 0; t < T; ++t) {
      if (t > 0) {  // the carried context of step t-1 from every row owner
        if (tid == RPC * RT) mbar_expect(&bars[2], ct_bytes);
        mbar_wait(&bars[2], (uint32_t)((t - 1) & 1));
        gate_part(ct, Dc, mt, wsg, H, kh * kh_c, (kh + 1) * kh_c, lane, acc_c);
      }
      if (KS == 2) {  // the second half's partials to the first's
        if (kh == 1) {
#pragma unroll
          for (int q = 0; q < 4; ++q)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              pp[(4 * q + e) * 32] = acc_c[q][e];
              pp[(16 + 4 * q + e) * 32] = acc_h[q][e];
            }
        }
        asm volatile("bar.sync %0, %1;\n" ::"r"(1 + RPC + mt), "r"(64 * NW) : "memory");
      }
      if (kh == 0) {
        cp_async_wait<0>();  // this step's xw
        mc[0] = mn[0];
        mc[1] = mn[1];
        uint32_t hpk[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          float hy[2], hin[2], cin[2];
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int e = 2 * i + j;
            float gt[4];
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const float2 x2 = xs[(4 * i + q) * 32];
              const float x = j ? x2.y : x2.x;
              float cc = acc_c[q][e], hh = acc_h[q][e];
              if (KS == 2) {
                cc += pp[(4 * q + e) * 32];
                hh += pp[(16 + 4 * q + e) * 32];
              }
              gt[q] = ((x + cc) + hh) + bias[q * H + j];
            }
            const float ig = sigm(gt[0]), f = sigm(gt[1]), g = tanh_(gt[2]), o = sigm(gt[3]);
            const float c_new = f * c[e] + ig * g;
            const float h_new = o * tanh_(c_new);
            const float m = mc[i];
            hin[j] = h[e];
            cin[j] = c[e];
            hy[j] = h_new * m;
            h[e] = m * h_new + (1.0f - m) * h[e];
            c[e] = m * c_new + (1.0f - m) * c[e];
          }
          hpk[i] = pack_bf16(h[2 * i], h[2 * i + 1]);
          if (lv[i]) {
            const size_t o = ((size_t)t * B + brow[i]) * H + u;
            *reinterpret_cast<float2*>(p.hs + o) = make_float2(hy[0], hy[1]);
            if (save) {
              *reinterpret_cast<float2*>(p.h_res + o) = make_float2(hin[0], hin[1]);
              *reinterpret_cast<float2*>(p.c_res + o) = make_float2(cin[0], cin[1]);
            }
          }
        }
        if (t + 1 < T) fetch_step(t + 1);  // "memory": after the reads of the slots
        // bf16 of the carried h into slot (t+1) % 2 of every peer's h tile
        const int slot = (t + 1) & 1;
        bf16* nt = ht + slot * ht_elems;
        const uint32_t a0 = smem_addr(nt + swzr(r[0], u >> 3, H) + (u & 7));
        const uint32_t a1 = smem_addr(nt + swzr(r[1], u >> 3, H) + (u & 7));
        const uint32_t bar = smem_addr(&bars[slot]);
#pragma unroll 4
        for (int pr = 0; pr < C; ++pr) {
          const uint32_t pbar = map_rank(bar, pr);
          st_async_b32(map_rank(a0, pr), hpk[0], pbar);
          st_async_b32(map_rank(a1, pr), hpk[1], pbar);
        }
      }
      if (t + 1 < T) {  // the h product of step t+1, while step t's read runs
        mbar_wait(&bars[(t + 1) & 1], (uint32_t)((t >> 1) & 1));
        gate_part(ht + ((t + 1) & 1) * ht_elems, H, mt, wsg, 0, kh * kh_h, (kh + 1) * kh_h, lane,
                  acc_h);
      }
    }
    if (kh == 0)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if (!lv[i]) continue;
        const size_t o = (size_t)brow[i] * H + u;
        *reinterpret_cast<float2*>(p.hT + o) = make_float2(h[2 * i], h[2 * i + 1]);
        *reinterpret_cast<float2*>(p.cT + o) = make_float2(c[2 * i], c[2 * i + 1]);
      }
  }
  // no CTA leaves while a peer may still address its shared memory
  cluster_arrive();
  cluster_wait();
}

// ---- launches ---------------------------------------------------------------

template <bool DOT, int RPC>
cudaLaunchConfig_t fwd_config(const Layout& L, int B, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C * ((B + C * RPC - 1) / (C * RPC)), 1, 1);
  cfg.blockDim = dim3(threads(RPC, L.NW), 1, 1);
  cfg.dynamicSmemBytes = L.total;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <bool DOT, int RPC>
cudaError_t set_fwd_attributes(const Layout& L) {
  auto* kern = align_fwd_scan<DOT, RPC>;
  cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.total);
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
}

template <bool DOT, int RPC>
cudaError_t fwd_t(const FwdArgs& a, cudaStream_t st) {
  const Layout L(a.H, a.Dc, a.A, a.S, a.Dv, RPC);
  cudaError_t e = set_fwd_attributes<DOT, RPC>(L);
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = fwd_config<DOT, RPC>(L, a.B, attr);
  cfg.stream = st;
  e = cudaLaunchKernelEx(&cfg, align_fwd_scan<DOT, RPC>, a);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <bool DOT>
cudaError_t fwd(const FwdArgs& a, int rpc, cudaStream_t st) {
  return rpc == 2 ? fwd_t<DOT, 2>(a, st) : fwd_t<DOT, 1>(a, st);
}

// the clusters of one launch that can be resident at once (0 on an error)
template <bool DOT, int RPC>
int max_active_t(const Layout& L) {
  if (set_fwd_attributes<DOT, RPC>(L) != cudaSuccess) return 0;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = fwd_config<DOT, RPC>(L, 16 * C * RPC, attr);
  int n = 0;
  return cudaOccupancyMaxActiveClusters(&n, (void*)align_fwd_scan<DOT, RPC>, &cfg) == cudaSuccess
             ? n
             : 0;
}

}  // namespace align_fwd
}  // namespace

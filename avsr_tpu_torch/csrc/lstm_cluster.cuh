// K1 / K2 on thread-block clusters: the masked LSTM recurrence, forward and
// backward, as one persistent launch per layer call (lstm_scan.cu's entry
// points take this route where kernels.lstm_family says "cluster": H a
// multiple of 64 from 128 to 384, every preset's H = 256).  The functions
// are lstm_scan.cu's (its header comment): avsr_tpu/ops/rnn.py
// _bilstm_scan_core_fwd_impl / _lstm_scan_core_fwd_impl forward and
// _bilstm_scan_core_bwd / _lstm_scan_core_bwd backward.
//
// What bounds it on an H100: the chain of T dependent steps.  One step of
// one direction at B = 128, H = 256 is 128 x 256 x 1024 MACs, a few hundred
// cycles of one SM's tensor cores; the per-step kernels spent ~12.5 us
// (forward) and ~32 us (backward) a step on launches, on bringing each
// block's Wh slice back from L2 and on CUDA-core FMAs.  Here the step's
// latency is what is left: the product out of shared memory (its operands'
// bytes: the 64 KB slice and each warp's copy of the bf16 h tile), the cell
// update, and one exchange of h (forward) or of dh partials (backward)
// between the SMs of a cluster.
//
// Design.  A cluster of C = 8 CTAs owns one (direction g, tile of BR = 16
// batch rows) and walks all T steps; clusters never wait on each other, so
// more clusters than fit at once run in waves.  CTA rank r owns the UR =
// H / 8 hidden units [r*UR, (r+1)*UR) with all four gates, so the cell
// update stays in the CTA, and c, h (fp32), dh and dc stay in registers for
// the whole scan.  Its Wh[g] slice, the NCOL = 4 UR gate columns of its
// units over all H inputs (64 KB bf16 at H = 256), is loaded once by
// cp.async and stays resident in shared memory, stored column-major ([n][k],
// k contiguous; 16-byte chunks XOR-swizzled by row) so that ldmatrix gives
// the B fragments of the gate product h . Wh and ldmatrix.trans those of
// the backward's dh product dgates . Wh^T from the same bytes.  Warp w
// owns 8 units: its 32 slice columns are [gate q][unit j] (n = 32 w + 8 q
// + j), so in the mma.sync m16n8k16 C fragments (bf16 operands, fp32
// accumulators) of its four gate tiles a thread holds all four gates of
// (rows gid, gid + 8) x (units 2 tig, 2 tig + 1): the cell update needs
// no shuffle.  The products are exact in fp32; only the summation order
// differs from the reference.  Shared memory at H = 256: 81,936 bytes
// forward, 110,608 backward, so two CTAs fit an SM (B = 128, G = 2 is 16
// clusters, more than fit one CTA a SM).
//
// The exchange.  A CTA writes into a peer's shared memory with st.async
// (mapa addresses), each store counting its bytes on the peer's mbarrier
// for that buffer; the receiver announces the bytes it expects
// (arrive.expect_tx, one thread) and waits for the phase (try_wait.parity,
// acquire at cluster scope), so no step waits on a cluster-wide barrier
// (PERF.md has what that saved).
// A cluster barrier only opens the scan (every CTA started, its barriers
// initialised) and closes it (no CTA leaves while a peer may address it).
//
// Forward step t: wait for h_t in slot t % 2 (step 0 reads bf16(h0), staged
// locally); the gate product; the cell update on the fp32 carries; each
// thread sends its bf16(h_{t+1}) pairs into slot (t+1) % 2 of every peer's
// h tile; ys[t] (and h_res[t], c_res[t] in save mode) are written from
// registers.  xw[t+1] and mask[t+1] are loaded while step t's product runs.
// Why two slots suffice: a peer sends h_{t+2} into this CTA's slot t % 2
// during its step t+1, so after it received all of h_{t+1}, which every
// thread of this CTA sends only after its warp's step t product, the last
// read of that slot; and the bytes of one use of a slot cannot meet the
// previous phase, which completed before this CTA sent what the senders
// needed first.
//
// Backward step t (t from T-1 down): dh_out = the sum, in rank order, of
// the 8 partial dh products of step t+1 that the peers left in this CTA's
// receive slot (t+1) % 2, plus dh_direct; the pointwise VJP on the gates
// recomputed a step ahead; db accumulated in registers from the unrounded
// dgates; bf16(dgates) [BR x NCOL] to shared memory; the partial dh =
// bf16(dgates) . slice^T [BR x H] (fp32); its columns are sent to their
// owners' receive slot t % 2 (st.async.v2.f32: a reduce-scatter, each owner
// summing the 8 partials in rank order); dxw[t] = bf16(dgates) to global.
// While the partials travel, the CTA recomputes step t-1's gates from
// h_res[t-1] (staged by cp.async during the previous step) and loads that
// step's xw, c_res, dys and mask.  The reduce-scatter moves fp32 [BR x UR]
// x 8 = 16 KB per CTA a step, half what broadcasting the bf16 dgates slice
// would, and one 64 KB slice serves both products, so H = 384's CTA still
// fits (210 KB).  Receive slots alternate by step: a peer sends step t-2's
// partials into slot t % 2 after it received this CTA's step t-1 partials,
// which this CTA sends after a __syncthreads that follows every warp's read
// of step t's.  After the loop, dh0 = step 0's partials + dh_direct.  db is
// summed over the CTA's rows (the thread's two rows, then shfl_xor over the
// quad's 8 row groups) and written per (g, row tile) to db_part; a small
// launch sums the row tiles in order.  No atomics: two runs give the same
// bits.  Rows past B (the last tile) run on zeros and write nothing; masked
// steps carry the state through exactly, as the reference's m * new +
// (1 - m) * old does.
//
// Recurrent dropout (lstm_scan.cu's header): each thread holds the rd mask
// of its four cells for the whole scan.  The forward scales its h by it
// before rounding what it sends (bf16(h * rd): every CTA's units are
// rounded after the product, before the exchange) and what it saves as
// h_res; bf16(h0 * rd) is staged the same way.  The forward is an instance
// of its own (RD), since a runtime factor of 1.0 on the exchange's chain
// cost the unmasked G = 2 forward 10-17 % (PERF.md §6); the unmasked
// instance keeps the unmasked kernel's statements, and its rd parameter
// comes last so that the others keep their offsets.  The backward
// scales the summed partials, the cotangent of that operand, before adding
// dh_direct; without a mask its factor is 1.0, the same bits as before.

#pragma once

#include "attention_mma.cuh"
#include "cluster_ptx.cuh"

namespace {
namespace lstm_cl {

using mma_attn::bf16;
using mma_attn::cp_async16;
using mma_attn::cp_async_commit;
using mma_attn::cp_async_wait;
using mma_attn::ldsm_x4;
using mma_attn::ldsm_x4_trans;
using mma_attn::mma;
using mma_attn::pack_bf16;
using mma_attn::smem_addr;
using mma_attn::swz;

constexpr int C = 8;    // CTAs per cluster (the portable maximum)
constexpr int BR = 16;  // batch rows per cluster: one mma row tile

template <int H>
struct Shape {
  static constexpr int UR = H / C;        // hidden units per CTA
  static constexpr int NW = UR / 8;       // warps: 8 units (32 slice columns) each
  static constexpr int THREADS = 32 * NW;
  static constexpr int NCOL = 4 * UR;     // slice columns: 4 gates of UR units
  static constexpr size_t W_BYTES = (size_t)NCOL * H * 2;
  static constexpr size_t HT_BYTES = (size_t)BR * H * 2;       // one bf16 h tile
  static constexpr size_t DG_BYTES = (size_t)BR * NCOL * 2;    // bf16 dgates rows
  static constexpr size_t RED_BYTES = (size_t)C * BR * UR * 4;  // one slot of partials
  static constexpr size_t FWD_SMEM = W_BYTES + 2 * HT_BYTES + 2 * 8;  // + 2 mbarriers
  static constexpr size_t BWD_SMEM = W_BYTES + HT_BYTES + DG_BYTES + 2 * RED_BYTES + 2 * 8;
  static_assert(H % 64 == 0 && H >= 128, "8 units a warp; 8 swizzle chunks a dgates row");
};

// sigmoid and tanh from one ex2.approx and one rcp.approx each (within a
// few fp32 ulps; tanh's absolute error is ~1e-7 near 0).  IEEE expf, tanhf
// and division carry slow-path branches that kept the four cells' chains
// from interleaving, and sit on the serial chain of every step.
__device__ __forceinline__ float sigm(float x) { return __fdividef(1.0f, 1.0f + __expf(-x)); }
__device__ __forceinline__ float tanh_(float x) {
  return 1.0f - __fdividef(2.0f, 1.0f + __expf(2.0f * x));
}
__device__ __forceinline__ float bf_lo(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float bf_hi(uint32_t v) { return __uint_as_float(v & 0xffff0000u); }
__device__ __forceinline__ float bf_at(uint32_t v, int j) { return j ? bf_hi(v) : bf_lo(v); }

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

// ---- shared pieces ----------------------------------------------------------

// The CTA's Wh slice [NCOL][H] (global: contiguous per (g, rank)) into
// swizzled shared memory; one cp.async group.  NCOL: K1's 4 gates of H/8
// units, or K12's 3.
template <int H, int NCOL = Shape<H>::NCOL>
__device__ __forceinline__ void stage_slice(bf16* ws, const bf16* src, int tid) {
  using S = Shape<H>;
  constexpr int CPR = H / 8;  // 16-byte chunks per row
  for (int ci = tid; ci < NCOL * CPR; ci += S::THREADS) {
    const int n = ci / CPR;
    cp_async16(ws + swz<H>(n, ci - n * CPR), src + (size_t)ci * 8, true);
  }
  cp_async_commit();
}

// Rows [row0, row0 + BR) of a bf16 [B, H] matrix into a swizzled h tile,
// zero-filled past B; one cp.async group.
template <int H>
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* src, int row0, int B, int tid) {
  using S = Shape<H>;
  constexpr int CPR = H / 8;
  for (int ci = tid; ci < BR * CPR; ci += S::THREADS) {
    const int r = ci / CPR, ch = ci - r * CPR;
    const bool valid = row0 + r < B;
    cp_async16(dst + swz<H>(r, ch), src + (size_t)(valid ? row0 + r : 0) * H + ch * 8, valid);
  }
  cp_async_commit();
}

// acc[q][e] = sum_k h[row, k] Wh[k, q*H + unit] over the tile's rows and
// the warp's 8 units: e = 0, 1 row gid, units 2 tig + e; e = 2, 3 row gid
// + 8.  ht: a swizzled [BR][H] bf16 tile; ws: the swizzled slice.
template <int H>
__device__ __forceinline__ void gate_product(const bf16* ht, const bf16* ws, int warp, int lane,
                                             float (&acc)[4][4]) {
  float acc2[2][4][4];  // even and odd k steps: two chains of half the depth
#pragma unroll
  for (int c = 0; c < 2; ++c)
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc2[c][q][e] = 0.f;
  const int arow = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int achunk = lane >> 4;
  const int brow = warp * 32 + (lane & 7) + (lane >> 4) * 8;
  const int bchunk = (lane >> 3) & 1;
#pragma unroll
  for (int kk = 0; kk < H / 16; ++kk) {
    uint32_t a[4];
    ldsm_x4(a, ht + swz<H>(arow, kk * 2 + achunk));
#pragma unroll
    for (int qp = 0; qp < 2; ++qp) {  // gates 2 qp and 2 qp + 1
      uint32_t b[4];
      ldsm_x4(b, ws + swz<H>(brow + qp * 16, kk * 2 + bchunk));
      mma(acc2[kk & 1][2 * qp], a, b[0], b[1]);
      mma(acc2[kk & 1][2 * qp + 1], a, b[2], b[3]);
    }
  }
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[q][e] = acc2[0][q][e] + acc2[1][q][e];
}

// ---- the backward's dh partials ---------------------------------------------
// (K1's, and K12's and K13's in gru_cluster.cuh and ln_lstm_cluster.cuh)

// Step s's partials have arrived in this CTA's receive slot s % 2 (its ((T
// - 1 - s) / 2)-th phase of the reverse scan).
template <int H>
__device__ __forceinline__ void wait_partials(uint64_t* full, int s, int T, int tid) {
  if (tid == 0) mbar_expect(&full[s & 1], (uint32_t)Shape<H>::RED_BYTES);
  mbar_wait(&full[s & 1], ((T - 1 - s) >> 1) & 1);
}

// The thread's cells' sums, in rank order, of the 8 CTAs' partials of step
// s in the receive slots red [2][C][BR][UR] (ul: the thread's first unit
// within the CTA).
template <int H>
__device__ __forceinline__ void sum_partials(const float* red, int s, int gid, int ul,
                                             float (&out)[4]) {
  constexpr int UR = Shape<H>::UR;
  const float* rp = red + (s & 1) * C * BR * UR;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float2 acc = *reinterpret_cast<const float2*>(rp + (gid + 8 * r) * UR + ul);
#pragma unroll
    for (int src = 1; src < C; ++src) {
      const float2 v = *reinterpret_cast<const float2*>(rp + (src * BR + gid + 8 * r) * UR + ul);
      acc.x += v.x;
      acc.y += v.y;
    }
    out[2 * r] = acc.x;
    out[2 * r + 1] = acc.y;
  }
}

// The partial dh = sum over a < NA of dg[a] . slice^T ([BR x NCOL] bf16
// tiles of pitch P against the resident slice, into one fp32 sum: K1's
// bf16(dgates), or the hi and lo halves of K12's and K13's fp32 cotangent):
// warp w's 64 hidden columns, sent to their owners' receive slot t % 2 at
// this CTA's rank (st.async.v2.f32, counted on the owner's barrier).
template <int H, int NCOL, int P, int NA>
__device__ __forceinline__ void send_dh_partials(const bf16* const (&dg)[NA], const bf16* ws,
                                                 float* red, uint64_t* full, int t, int rank,
                                                 int warp, int lane) {
  constexpr int UR = Shape<H>::UR;
  const int gid = lane >> 2, tig = lane & 3;
  float acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  const int arow = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int achunk = lane >> 4;
  const int brow = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int bchunk = warp * 8 + (lane >> 4);
#pragma unroll
  for (int kk = 0; kk < NCOL / 16; ++kk) {
    uint32_t a[NA][4];
#pragma unroll
    for (int i = 0; i < NA; ++i) ldsm_x4(a[i], dg[i] + swz<P>(arow, kk * 2 + achunk));
#pragma unroll
    for (int p = 0; p < 4; ++p) {  // hidden columns 64 w + 16 p + [0, 16)
      uint32_t b[4];
      ldsm_x4_trans(b, ws + swz<H>(kk * 16 + brow, bchunk + 2 * p));
#pragma unroll
      for (int i = 0; i < NA; ++i) {
        mma(acc[2 * p], a[i], b[0], b[1]);
        mma(acc[2 * p + 1], a[i], b[2], b[3]);
      }
    }
  }
  float* sl = red + (t & 1) * C * BR * UR + rank * BR * UR;
  const uint32_t bar = smem_addr(&full[t & 1]);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int hc = warp * 64 + j * 8 + 2 * tig;
    const int owner = hc / UR, uc = hc - owner * UR;
    const uint32_t obar = map_rank(bar, owner);
    st_async_v2f32(map_rank(smem_addr(sl + gid * UR + uc), owner), acc[j][0], acc[j][1], obar);
    st_async_v2f32(map_rank(smem_addr(sl + (gid + 8) * UR + uc), owner), acc[j][2], acc[j][3],
                   obar);
  }
}

// ---- forward ----------------------------------------------------------------

template <int H, bool RD>
__global__ void __launch_bounds__(Shape<H>::THREADS, 1)
lstm_cluster_fwd(const bf16* __restrict__ wcl,    // [G, C, NCOL, H]
                 const float* __restrict__ bias,  // [G, 4H]
                 const bf16* __restrict__ xw,     // [T, G, B, 4H]
                 const float* __restrict__ mask,  // [T, G, B]
                 float* __restrict__ hbuf,        // [2, G, B, H]: h0 in slot 0; hT to slot T % 2
                 float* __restrict__ c,           // [G, B, H]: c0 in, cT out
                 bf16* __restrict__ ys,           // [T, G, B, H]
                 bf16* __restrict__ h_res,        // [T, G, B, H] or null
                 bf16* __restrict__ c_res,        // [T, G, B, H] or null
                 int T, int G, int B,
                 const float* __restrict__ rd) {  // [G, B, H] (RD) or null
  using S = Shape<H>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ws = reinterpret_cast<bf16*>(smem);
  bf16* hs = ws + S::NCOL * H;                                // [2][BR][H]
  uint64_t* full = reinterpret_cast<uint64_t*>(hs + 2 * BR * H);  // [2]: slot s's h arrived

  const int rank = (int)cluster_rank();
  const int g = blockIdx.y;
  const int row0 = (blockIdx.x / C) * BR;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int ul = warp * 8 + 2 * tig;  // the thread's first unit within the CTA
  const int unit = rank * S::UR + ul;
  const int rows[2] = {row0 + gid, row0 + gid + 8};
  const bool live[2] = {rows[0] < B, rows[1] < B};
  const int H4 = 4 * H;
  const bool save = h_res != nullptr;

  stage_slice<H>(ws, wcl + ((size_t)g * C + rank) * S::NCOL * H, tid);

  // bf16(h0 * rd) of the tile's rows, all H units, into slot 0
  const float* h0 = hbuf + (size_t)g * B * H;
  for (int i = tid; i < BR * H / 2; i += S::THREADS) {
    const int r = i / (H / 2), k = 2 * (i - r * (H / 2));
    float2 v = make_float2(0.f, 0.f);
    if constexpr (RD) {
      if (row0 + r < B) {
        const size_t o = (size_t)(row0 + r) * H + k;
        const float2 q = *reinterpret_cast<const float2*>(rd + (size_t)g * B * H + o);
        v = *reinterpret_cast<const float2*>(h0 + o);
        v = make_float2(v.x * q.x, v.y * q.y);
      }
    } else {
      if (row0 + r < B) v = *reinterpret_cast<const float2*>(h0 + (size_t)(row0 + r) * H + k);
    }
    *reinterpret_cast<uint32_t*>(hs + swz<H>(r, k >> 3) + (k & 7)) = pack_bf16(v.x, v.y);
  }
  // the thread's cells: fp32 h and c, the recurrent-dropout factors, its bias
  float h[4], cs[4], rdv[4], bq[4][2];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const size_t o = ((size_t)g * B + (live[e >> 1] ? rows[e >> 1] : 0)) * H + unit + (e & 1);
    h[e] = live[e >> 1] ? hbuf[o] : 0.f;  // slot 0
    cs[e] = live[e >> 1] ? c[o] : 0.f;
    if constexpr (RD) rdv[e] = live[e >> 1] ? rd[o] : 1.f;
  }
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int j = 0; j < 2; ++j) bq[q][j] = bias[(size_t)g * H4 + q * H + unit + j];

  // xw[t] (bf16 pairs: the thread's two units, per row and gate) and mask[t]
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
    mbar_init(&full[0], 1);
    mbar_init(&full[1], 1);
    fence_mbar_init();
  }

  cp_async_wait<0>();
  // every CTA of the cluster has started (DSMEM may be written), staged and
  // initialised its barriers
  cluster_arrive();
  cluster_wait();

  for (int t = 0; t < T; ++t) {
    const int slot = t & 1;
    if (t > 0) {  // h_t from the 8 CTAs: slot t % 2's ((t - 1) / 2)-th phase
      if (tid == 0) mbar_expect(&full[slot], (uint32_t)S::HT_BYTES);
      mbar_wait(&full[slot], ((t - 1) >> 1) & 1);
    }
    if (t + 1 < T) load_step(t + 1, xn, mn);
    float acc[4][4];
    gate_product<H>(hs + slot * BR * H, ws, warp, lane, acc);

    uint32_t hpk[2], ypk[2], hrpk[2], crpk[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float y[2], hin[2], cin[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int e = 2 * r + j;
        const float i = sigm((bf_at(xc[r][0], j) + acc[0][e]) + bq[0][j]);
        const float f = sigm((bf_at(xc[r][1], j) + acc[1][e]) + bq[1][j]);
        const float gt = tanh_((bf_at(xc[r][2], j) + acc[2][e]) + bq[2][j]);
        const float o = sigm((bf_at(xc[r][3], j) + acc[3][e]) + bq[3][j]);
        const float c_new = f * cs[e] + i * gt;
        const float h_new = o * tanh_(c_new);
        const float m = mc[r];
        hin[j] = h[e];
        cin[j] = cs[e];
        y[j] = h_new * m;
        h[e] = m * h_new + (1.0f - m) * h[e];
        cs[e] = m * c_new + (1.0f - m) * cs[e];
      }
      // the next product's operand, bf16(h * rd), and the backward's
      // residuals: step t's operand and the carry entering it (the
      // unmasked instance keeps the unmasked kernel's statements)
      if constexpr (RD) {
        hpk[r] = pack_bf16(h[2 * r] * rdv[2 * r], h[2 * r + 1] * rdv[2 * r + 1]);
        ypk[r] = pack_bf16(y[0], y[1]);
        hrpk[r] = pack_bf16(hin[0] * rdv[2 * r], hin[1] * rdv[2 * r + 1]);
      } else {
        hpk[r] = pack_bf16(h[2 * r], h[2 * r + 1]);
        ypk[r] = pack_bf16(y[0], y[1]);
        hrpk[r] = pack_bf16(hin[0], hin[1]);  // the carries entering step t:
      }
      crpk[r] = pack_bf16(cin[0], cin[1]);  // the backward's residuals
    }

    // bf16(h_{t+1}) of the thread's cells into slot t+1 of every peer's
    // tile, counted on the peer's barrier of that slot
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
        *reinterpret_cast<uint32_t*>(c_res + o) = crpk[r];
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

  float* hT = hbuf + (size_t)(T & 1) * G * B * H;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    if (!live[e >> 1]) continue;
    const size_t o = ((size_t)g * B + rows[e >> 1]) * H + unit + (e & 1);
    hT[o] = h[e];
    c[o] = cs[e];
  }
}

// ---- backward ---------------------------------------------------------------

template <int H>
__global__ void __launch_bounds__(Shape<H>::THREADS, 1)
lstm_cluster_bwd(const bf16* __restrict__ wcl,     // [G, C, NCOL, H]
                 const float* __restrict__ bias,   // [G, 4H]
                 const bf16* __restrict__ xw,      // [T, G, B, 4H]
                 const float* __restrict__ mask,   // [T, G, B]
                 const bf16* __restrict__ h_res,   // [T, G, B, H]
                 const bf16* __restrict__ c_res,   // [T, G, B, H]
                 const bf16* __restrict__ dys,     // [T, G, B, H]
                 const float* __restrict__ dhT,    // [G, B, H]
                 float* __restrict__ dc,           // [G, B, H]: dcT in, dc0 out
                 float* __restrict__ db_part,      // [G, ceil(B / BR), 4H]
                 bf16* __restrict__ dxw,           // [T, G, B, 4H]
                 float* __restrict__ dh0,          // [G, B, H]
                 const float* __restrict__ rd,     // [G, B, H] or null
                 int T, int G, int B) {
  using S = Shape<H>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ws = reinterpret_cast<bf16*>(smem);
  bf16* hr = ws + S::NCOL * H;              // [BR][H]: h_res rows of the next recompute
  bf16* dg = hr + BR * H;                   // [BR][NCOL]
  float* red = reinterpret_cast<float*>(dg + BR * S::NCOL);  // [2][C][BR][UR]
  uint64_t* full = reinterpret_cast<uint64_t*>(red + 2 * C * BR * S::UR);  // [2]: slot s's partials

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

  stage_slice<H>(ws, wcl + ((size_t)g * C + rank) * S::NCOL * H, tid);
  stage_rows<H>(hr, h_res + ((size_t)(T - 1) * G + g) * B * H, row0, B, tid);

  float dhd[4], dcs[4], rdv[4], bq[4][2], dbacc[4][4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const size_t o = ((size_t)g * B + (live[e >> 1] ? rows[e >> 1] : 0)) * H + unit + (e & 1);
    dhd[e] = live[e >> 1] ? dhT[o] : 0.f;
    dcs[e] = live[e >> 1] ? dc[o] : 0.f;
    rdv[e] = live[e >> 1] && rd != nullptr ? rd[o] : 1.f;
#pragma unroll
    for (int q = 0; q < 4; ++q) dbacc[q][e] = 0.f;
  }
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int j = 0; j < 2; ++j) bq[q][j] = bias[(size_t)g * H4 + q * H + unit + j];

  // step t's operands of the thread's cells: xw, c_res, dys (bf16 pairs), mask
  uint32_t x[2][4], cr[2], dy[2];
  float m[2];
  auto load_step = [&](int t) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const size_t gb = ((size_t)t * G + g) * B + rows[r];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        x[r][q] = live[r] ? *reinterpret_cast<const uint32_t*>(xw + gb * H4 + q * H + unit) : 0u;
      cr[r] = live[r] ? *reinterpret_cast<const uint32_t*>(c_res + gb * H + unit) : 0u;
      dy[r] = live[r] ? *reinterpret_cast<const uint32_t*>(dys + gb * H + unit) : 0u;
      m[r] = live[r] ? mask[gb] : 0.f;
    }
  };
  load_step(T - 1);
  float gacc[4][4];
  cp_async_wait<0>();
  __syncthreads();
  gate_product<H>(hr, ws, warp, lane, gacc);
  if (T >= 2) {
    __syncthreads();  // every warp has read the tile
    stage_rows<H>(hr, h_res + ((size_t)(T - 2) * G + g) * B * H, row0, B, tid);
  }
  if (tid == 0) {
    mbar_init(&full[0], 1);
    mbar_init(&full[1], 1);
    fence_mbar_init();
  }
  // every CTA of the cluster has started and initialised its barriers:
  // partials may be written
  cluster_arrive();
  cluster_wait();

  for (int t = T - 1; t >= 0; --t) {
    float dh_out[4];
    if (t < T - 1) {
      wait_partials<H>(full, t + 1, T, tid);
      sum_partials<H>(red, t + 1, gid, ul, dh_out);
#pragma unroll
      for (int e = 0; e < 4; ++e) dh_out[e] = dh_out[e] * rdv[e] + dhd[e];
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) dh_out[e] = dhd[e];
    }

    // the pointwise backward of rnn.py:405-425 on the recomputed gates
    uint32_t dxv[2][4];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float dgq[4][2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int e = 2 * r + j;
        const float i = sigm((bf_at(x[r][0], j) + gacc[0][e]) + bq[0][j]);
        const float f = sigm((bf_at(x[r][1], j) + gacc[1][e]) + bq[1][j]);
        const float gt = tanh_((bf_at(x[r][2], j) + gacc[2][e]) + bq[2][j]);
        const float o = sigm((bf_at(x[r][3], j) + gacc[3][e]) + bq[3][j]);
        const float c_prev = bf_at(cr[r], j);
        const float c_new = f * c_prev + i * gt;
        const float tc = tanh_(c_new);
        const float mm = m[r];
        const float dh_new = (dh_out[e] + bf_at(dy[r], j)) * mm;
        const float dh_prev_direct = dh_out[e] * (1.0f - mm);
        float dc_new = dcs[e] * mm;
        const float dc_prev_direct = dcs[e] * (1.0f - mm);
        const float d_o = dh_new * tc;
        dc_new = dc_new + dh_new * o * (1.0f - tc * tc);
        const float df = dc_new * c_prev;
        const float di = dc_new * gt;
        const float dgate = dc_new * i;
        dcs[e] = dc_new * f + dc_prev_direct;
        dhd[e] = dh_prev_direct;
        dgq[0][j] = di * i * (1.0f - i);
        dgq[1][j] = df * f * (1.0f - f);
        dgq[2][j] = dgate * (1.0f - gt * gt);
        dgq[3][j] = d_o * o * (1.0f - o);
#pragma unroll
        for (int q = 0; q < 4; ++q) dbacc[q][e] += dgq[q][j];
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        dxv[r][q] = pack_bf16(dgq[q][0], dgq[q][1]);
        const int n = warp * 32 + q * 8 + 2 * tig;
        *reinterpret_cast<uint32_t*>(dg + swz<S::NCOL>(gid + 8 * r, n >> 3) + (n & 7)) = dxv[r][q];
      }
    }
    __syncthreads();

    // partial dh = bf16(dgates) . slice^T, to the owners
    {
      const bf16* const tiles[1] = {dg};
      send_dh_partials<H, S::NCOL, S::NCOL, 1>(tiles, ws, red, full, t, rank, warp, lane);
    }
    // dxw[t], after the sends
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (!live[r]) continue;
      const size_t gb = ((size_t)t * G + g) * B + rows[r];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        *reinterpret_cast<uint32_t*>(dxw + gb * H4 + q * H + unit) = dxv[r][q];
    }

    if (t > 0) {  // while the partials travel: step t-1's operands and recomputed gates
      load_step(t - 1);
      cp_async_wait<0>();
      __syncthreads();  // h_res[t-1] has landed
      gate_product<H>(hr, ws, warp, lane, gacc);
      if (t >= 2) {
        __syncthreads();  // every warp has read the tile
        stage_rows<H>(hr, h_res + ((size_t)(t - 2) * G + g) * B * H, row0, B, tid);
      }
    }
  }

  wait_partials<H>(full, 0, T, tid);
  float part[4];
  sum_partials<H>(red, 0, gid, ul, part);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    if (!live[e >> 1]) continue;
    const size_t o = ((size_t)g * B + rows[e >> 1]) * H + unit + (e & 1);
    dh0[o] = part[e] * rdv[e] + dhd[e];
    dc[o] = dcs[e];
  }
  // db over the tile's rows: the thread's two, then the quad's 8 row groups
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float v = dbacc[q][j] + dbacc[q][2 + j];
      v += __shfl_xor_sync(0xffffffffu, v, 4);
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      if (gid == 0)
        db_part[((size_t)g * (gridDim.x / C) + tile) * H4 + q * H + unit + j] = v;
    }
  // no CTA leaves while a peer may still address its shared memory
  cluster_arrive();
  cluster_wait();
}

// db[g, col] = sum over row tiles, in order, of db_part[g, tile, col]
__global__ void lstm_db_reduce(const float* __restrict__ db_part, float* __restrict__ db,
                               int n_tiles, int H4) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  const int g = blockIdx.y;
  if (col >= H4) return;
  float s = 0.f;
  for (int t = 0; t < n_tiles; ++t) s += db_part[((size_t)g * n_tiles + t) * H4 + col];
  db[(size_t)g * H4 + col] = s;
}

// ---- launches ---------------------------------------------------------------

template <typename Kernel, typename... Args>
cudaError_t launch_cluster(Kernel kern, size_t smem, int threads, int n_tiles, int G,
                           cudaStream_t st, Args... args) {
  cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C * n_tiles, G, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kern, args...);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <int H>
cudaError_t fwd(const void* wcl, const void* bias, const void* xw, const void* mask, void* hbuf,
                void* c, void* ys, void* h_res, void* c_res, const void* rd, int T, int G, int B,
                cudaStream_t st) {
  using S = Shape<H>;
  return launch_cluster(rd != nullptr ? lstm_cluster_fwd<H, true> : lstm_cluster_fwd<H, false>,
                        S::FWD_SMEM, S::THREADS, (B + BR - 1) / BR, G, st,
                        static_cast<const bf16*>(wcl), static_cast<const float*>(bias),
                        static_cast<const bf16*>(xw), static_cast<const float*>(mask),
                        static_cast<float*>(hbuf), static_cast<float*>(c), static_cast<bf16*>(ys),
                        static_cast<bf16*>(h_res), static_cast<bf16*>(c_res), T, G, B,
                        static_cast<const float*>(rd));
}

template <int H>
cudaError_t bwd(const void* wcl, const void* bias, const void* xw, const void* mask,
                const void* h_res, const void* c_res, const void* dys, const void* dhT, void* dc,
                void* db_part, void* dxw, void* dh0, void* db, const void* rd, int T, int G,
                int B, cudaStream_t st) {
  using S = Shape<H>;
  const int n_tiles = (B + BR - 1) / BR;
  cudaError_t e = launch_cluster(
      lstm_cluster_bwd<H>, S::BWD_SMEM, S::THREADS, n_tiles, G, st,
      static_cast<const bf16*>(wcl), static_cast<const float*>(bias),
      static_cast<const bf16*>(xw), static_cast<const float*>(mask),
      static_cast<const bf16*>(h_res), static_cast<const bf16*>(c_res),
      static_cast<const bf16*>(dys), static_cast<const float*>(dhT), static_cast<float*>(dc),
      static_cast<float*>(db_part), static_cast<bf16*>(dxw), static_cast<float*>(dh0),
      static_cast<const float*>(rd), T, G, B);
  if (e != cudaSuccess) return e;
  lstm_db_reduce<<<dim3((4 * H + 255) / 256, G), 256, 0, st>>>(
      static_cast<const float*>(db_part), static_cast<float*>(db), n_tiles, 4 * H);
  return cudaGetLastError();
}

// the clusters of a launch of `kern` that can be resident at once (0 on an
// error)
inline int max_active_clusters(const void* kern, int threads, size_t smem) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C * 64, 2, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveClusters(&n, kern, &cfg);
  return e == cudaSuccess ? n : 0;
}

template <int H>
int max_active(bool backward) {
  using S = Shape<H>;
  return backward ? max_active_clusters((const void*)lstm_cluster_bwd<H>, S::THREADS,
                                        S::BWD_SMEM)
                  : max_active_clusters((const void*)lstm_cluster_fwd<H, false>, S::THREADS,
                                        S::FWD_SMEM);
}

}  // namespace lstm_cl
}  // namespace

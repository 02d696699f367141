// K5's cross attention at (dk, dv) = (128, 256): the teacher-forced
// decoder's queries over the prepared memory (avsr_tpu/models/
// transformer_decoder.py:359-373), forward and backward, one block per
// (utterance b, head h).  The function and its rounding points are
// attention_mma.cuh's (decoder_attention.cu's header):
//
//   s[i, j]  = float(bf16(q_i . k_j)) / sqrt(128) + bias[b, j]          (fp32)
//   P[i, :]  = softmax(s[i, :])   (fp32: max, expf(s - max), sum, div_row)
//   ctx[i]   = bf16(sum_j bf16(P[i, j]) * v_j)               (fp32 accumulate)
//   dP = bf16(dctx . V^T);  D_i = sum_j dP[i, j] P[i, j]
//   dsc = bf16(P (dP - D) / sqrt(128))
//   dQ = bf16(dsc . K);  dK = bf16(dsc^T . Q);  dV = bf16(bf16(P)^T . dctx)
//
// The bias is added, never used to skip a key: a memory of length 0 gets
// the uniform softmax over its S keys.  Key columns the tiles pad past S
// take s = -inf, P = 0.  The forward saves the row max and the row sum
// (fp32 [B, nh, Q] each) and the backward recomputes P from them with the
// forward's expression and product order, so bit for bit; no [B, nh, Q, S]
// tensor is written, and the backward has no scratch in device memory.
//
// What bounds it on an H100: bytes.  At lrs2_av_v2's shape (B = 128, 4
// heads, Q = 80, S = 197) one (b, h) reads q 20 KB, k 50 KB, v 101 KB
// and writes ctx 41 KB: 109 MB for the call (~33 us at 3.35 TB/s) against
// 6 GFLOP (~6 us at 989 TFLOP/s); the backward also reads dctx and writes
// dq, dk, dv.  The streamed kernels (attention_mma.cuh's streamed tiles,
// which run this instance only past the lengths these hold) read K 4 times
// and V twice per (b, h) in the forward (two 64-row query blocks, each
// split over two value-column blocks that formed the same scores), and K
// and V 4 times and q and dctx 8 times in the backward.  Here each operand
// passes through shared memory once per (b, h):
//
// * Rows arrive by bulk copies (cp.async.bulk, one row per lane of a
//   producer warp; the (b, h) rows of q, k, v and dctx are strided in
//   device memory) into shared memory, counted on mbarriers: tiles of TK =
//   32 key rows (K, V) into a ring of slots, each with a "full" barrier the
//   copies complete and an "empty" one the consumer warps arrive on, so the
//   producer runs as far ahead as the ring allows (as many slots as the
//   layout fits: 3-8 forward, 2-6 backward).  Staged rows are padded by 16
//   bytes (q and K rows 272 B, dctx and V rows 528 B), so the 8 rows one
//   ldmatrix reads fall in 8 bank groups.
// * Forward: persistent, one block an SM walking the items (b, h, 16 ns
//   queries), ns <= 5 strips of 16 queries an item (Q = 80 is 5, Q = 150
//   two items of 5), 2 ns consumer warps: two per strip.  The producer
//   streams an item's q rows (into one of two buffers), key tiles and value
//   tiles, and runs on into the next item while the consumers finish this
//   one.  The key tiles pass once: the strip's two warps take alternate
//   16-key steps, form bf16(q.k) on the tensor cores and store it to
//   shared memory (exact: the score is rounded to bf16 there), keeping the
//   row max; then each re-reads its own steps for the sum and overwrites
//   them with bf16(P), the two halves' max and sum combined in a fixed
//   order.  The value tiles pass once: the strip's two warps split the 256
//   value columns (128 each, 64 accumulators a thread) of P.V with bf16(P)
//   read from shared memory.  No score, P or ctx element is formed twice
//   and no warp holds no query.
// * Backward: one block per (b, h) holds every query (Q <= 160: ns <= 10
//   strips), its q and dctx rows (bulk copies too) and statistics
//   resident, with two warps a strip up to 9 strips (Q <= 144, the main
//   path's 80) and one at 10.  The key/value tile pairs pass twice: first
//   for D (a strip's warps take its alternate 16-key steps of P and dP,
//   their sums combined in a fixed order), then for the gradients: each
//   warp forms P and dsc for its (strip, key steps) into shared memory
//   (bf16), then, after a barrier, accumulates its strip's share of dQ's
//   128 columns in registers over every tile, and the warps share the
//   tile's 24 tasks of 16 keys x 32 columns of dV (16) and dK (8), each
//   summed over all queries and written once, by its one owner, as bf16.
//
// Every output element has one writer and every sum a fixed order: no
// atomics, the same bits on every run.

#pragma once

#include "cluster_ptx.cuh"

namespace {
namespace xattn {

using mma_attn::bf16;
using mma_attn::mma;
using mma_attn::neg_inf;
using mma_attn::pack_bf16;
using mma_attn::round_bf16;
using mma_attn::Scale;
using mma_attn::smem_addr;

constexpr int DK = 128, DV = 256;
constexpr int TK = 32;                   // key rows a ring tile
constexpr int KP = DK + 8;               // elements between staged q / key rows (272 B)
constexpr int VP = DV + 8;               // elements between staged dctx / value rows (528 B)
constexpr int PP = TK + 8;               // elements between rows of the backward's P and dsc
constexpr int FWD_STRIPS = 5;            // 16-query strips a forward block holds at most
constexpr int BWD_STRIPS = 10;           // ... a backward block (every query: Q <= 160)
constexpr int BWD_PAIRED = 9;            // strips up to which the backward runs two warps a strip
constexpr int FWD_MIN_SLOTS = 3, FWD_MAX_SLOTS = 8;  // ring tiles of the forward
constexpr int BWD_MIN_SLOTS = 2, BWD_MAX_SLOTS = 6;  // ... of the backward
constexpr int FWD_THREADS = 32 * (2 * FWD_STRIPS + 1);
constexpr size_t SMEM_LIMIT = 232448;  // bytes a block may use on an H100

// ---- PTX ------------------------------------------------------------------

using cluster_ptx::bulk_g2s;
using cluster_ptx::mbar_arrive;
// the consumer warps' barrier (the producer warp never joins it)
__device__ __forceinline__ void consumers_sync(int nthreads) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(nthreads) : "memory");
}

// ---- fragments of pitched tiles (attention_mma.cuh) ---------------------------

using mma_attn::pitched::load_a;
using mma_attn::pitched::load_at;
using mma_attn::pitched::load_b;
using mma_attn::pitched::load_bt;

// acc = A (16 rows at r0 of a, KD 16-column steps) . B^T (16 rows at n0 of
// b): the kd order of attention_mma.cuh's product, so the scores' bits
template <int KD>
__device__ __forceinline__ void product(float (&acc)[2][4], const bf16* a, int pa, int r0,
                                        const bf16* b, int pb, int n0, int lane) {
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
#pragma unroll 2
  for (int kd = 0; kd < KD; ++kd) {
    uint32_t af[4], bf[4];
    load_a(af, a, pa, r0, 16 * kd, lane);
    load_b(bf, b, pb, n0, 16 * kd, lane);
    mma(acc[0], af, bf[0], bf[1]);
    mma(acc[1], af, bf[2], bf[3]);
  }
}

// zero `bytes` (a multiple of 16) of shared memory
__device__ __forceinline__ void zero_smem(unsigned char* p, size_t bytes, int tid, int nthreads) {
  for (size_t c = tid; c < bytes / 16; c += nthreads)
    reinterpret_cast<uint4*>(p)[c] = make_uint4(0u, 0u, 0u, 0u);
}

// ---- forward ----------------------------------------------------------------

// Shared memory of a forward block of ns strips over S keys with a ring of
// `slots` tiles, byte offsets: the ring (slots of TK value rows; a key tile
// takes TK rows of KP in a slot), two q buffers [16 ns][KP] (the next
// item's rows land while this one's are in use), the scores and then
// bf16(P) [16 ns][sp] (sp = S rounded up to 16, plus 8), the two halves'
// max and sum [2][2][16 ns] fp32, the mbarriers (the ring's full and
// empty, then the q buffers' full and empty).
struct FwdLayout {
  int sp;
  size_t q, sc, red, bars, total;
  __host__ __device__ FwdLayout(int ns, int S, int slots) {
    sp = ((S + 15) & ~15) + 8;
    q = (size_t)slots * TK * VP * 2;
    sc = q + (size_t)2 * 16 * ns * KP * 2;
    red = sc + (size_t)16 * ns * sp * 2;
    bars = red + (size_t)4 * 16 * ns * 4;
    total = bars + (size_t)(2 * slots + 4) * 8;
  }
};

struct FwdConfig {
  int ns, slots;
};
// the strips a forward block holds and its ring at Q queries and S keys:
// the fewest blocks per (b, h) whose layout fits with FWD_MIN_SLOTS, as few
// strips a block as that allows, then as many slots as fit, up to
// FWD_MAX_SLOTS ({0, 0}: none fits)
inline FwdConfig fwd_config(int Q, int S) {
  const int nst = (Q + 15) / 16;
  for (int nc = (nst + FWD_STRIPS - 1) / FWD_STRIPS; nc <= nst; ++nc) {
    const int ns = (nst + nc - 1) / nc;
    if (FwdLayout(ns, S, FWD_MIN_SLOTS).total > SMEM_LIMIT) continue;
    int slots = FWD_MIN_SLOTS;
    while (slots < FWD_MAX_SLOTS && FwdLayout(ns, S, slots + 1).total <= SMEM_LIMIT) ++slots;
    return FwdConfig{ns, slots};
  }
  return FwdConfig{0, 0};
}

// Persistent: block x takes the items (b, h, 16 ns queries) x, x + grid, ...
// with 2 ns consumer warps and a producer, which streams each item's q rows
// (into the q buffer the item before last freed), key tiles and value tiles
// through one ring, running ahead into the next item while the consumers
// finish this one.  row_max / row_sum null: nothing saved (serving).
__global__ void __launch_bounds__(FWD_THREADS)
xattn_fwd(const bf16* __restrict__ q,  // [B, Q, nh, DK]
          const bf16* __restrict__ k,  // [B, S, nh, DK]
          const bf16* __restrict__ v,  // [B, S, nh, DV]
          const float* __restrict__ bias,  // [B, S]
          float* __restrict__ row_max, float* __restrict__ row_sum,  // [B, nh, Q]
          bf16* __restrict__ ctx,  // [B, Q, nh, DV]
          int B, int Q, int S, int nh, int ns, int slots) {
  extern __shared__ __align__(128) unsigned char smem[];
  const FwdLayout L(ns, S, slots);
  const int nch = ((Q + 15) / 16 + ns - 1) / ns, items = nch * nh * B;
  const int ncw = 2 * ns, nthreads = 32 * (ncw + 1);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nks = (S + 15) >> 4, nkt = (S + TK - 1) / TK;
  const size_t qbuf = (size_t)16 * ns * KP;  // elements of a q buffer
  bf16* sc_s = reinterpret_cast<bf16*>(smem + L.sc);
  float* red = reinterpret_cast<float*>(smem + L.red);  // [max | sum][half][16 ns]
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L.bars);
  uint64_t* empty = full + slots;
  uint64_t* qfull = empty + slots;
  uint64_t* qempty = qfull + 2;
  auto q_buf = [&](int j) { return reinterpret_cast<bf16*>(smem + L.q) + (j & 1) * qbuf; };
  auto slot_base = [&](int g) { return smem + (size_t)(g % slots) * TK * VP * 2; };
  // item it: (chunk c of 16 ns queries, head h, utterance b)
  auto item = [&](int it, int& b, int& h, int& i0) {
    i0 = (it % nch) * 16 * ns;
    h = (it / nch) % nh;
    b = it / (nch * nh);
  };

  // the ring and the q buffers zeroed: the rows the copies leave (keys past
  // S, queries past Q) hold finite values
  zero_smem(smem, L.sc, threadIdx.x, nthreads);
  if (threadIdx.x == 0) {
    for (int s = 0; s < slots; ++s) {
      cluster_ptx::mbar_init(&full[s], 1);
      cluster_ptx::mbar_init(&empty[s], ncw);
    }
    for (int s = 0; s < 2; ++s) {
      cluster_ptx::mbar_init(&qfull[s], 1);
      cluster_ptx::mbar_init(&qempty[s], ncw);
    }
    cluster_ptx::fence_mbar_init();
  }
  cluster_ptx::fence_proxy_async();
  __syncthreads();

  if (warp == ncw) {  // the producer: per item its q rows, key tiles, value tiles
    int g = 0, j = 0;
    for (int it = blockIdx.x; it < items; it += gridDim.x, ++j) {
      int b, h, i0;
      item(it, b, h, i0);
      if (j >= 2) cluster_ptx::mbar_wait(&qempty[j & 1], ((j >> 1) - 1) & 1);
      const int nq = min(16 * ns, Q - i0);
      if (lane == 0) cluster_ptx::mbar_expect(&qfull[j & 1], nq * DK * 2);
      __syncwarp();
      for (int r = lane; r < nq; r += 32)
        bulk_g2s(smem_addr(q_buf(j) + r * KP), q + (((size_t)b * Q + i0 + r) * nh + h) * DK,
                 DK * 2, smem_addr(&qfull[j & 1]));
      for (int e = 0; e < 2 * nkt; ++e, ++g) {
        const int slot = g % slots, use = g / slots;
        if (use > 0) cluster_ptx::mbar_wait(&empty[slot], (use - 1) & 1);
        const bool is_v = e >= nkt;
        const int t = is_v ? e - nkt : e, rows = min(TK, S - t * TK);
        const uint32_t rb = is_v ? DV * 2 : DK * 2, pitch = is_v ? VP * 2 : KP * 2;
        if (lane == 0) cluster_ptx::mbar_expect(&full[slot], rows * rb);
        __syncwarp();
        if (lane < rows) {
          const int jj = t * TK + lane;
          const bf16* src = is_v ? v + ((size_t)b * S + jj) * nh * DV + (size_t)h * DV
                                 : k + ((size_t)b * S + jj) * nh * DK + (size_t)h * DK;
          bulk_g2s(smem_addr(slot_base(g)) + lane * pitch, src, rb, smem_addr(&full[slot]));
        }
      }
    }
    return;
  }

  const int sw = warp % ns, hw = warp / ns;  // this warp's strip and half
  const int r0 = 16 * sw, g8 = lane >> 2, t2 = 2 * (lane & 3), row0 = r0 + g8;
  const int nc = 32 * ncw;
  const Scale sc = mma_attn::scale<DK>();
  auto wait_full = [&](int g) { cluster_ptx::mbar_wait(&full[g % slots], (g / slots) & 1); };
  auto release = [&](uint64_t* bar) {
    __syncwarp();
    if (lane == 0) mbar_arrive(bar);
  };
  // this thread's column of key step ks for its element (nt, e)
  auto col = [&](int ks, int nt, int e) { return ks * 16 + nt * 8 + t2 + (e & 1); };
  auto sc_at = [&](int ks, int nt, int r) {
    return reinterpret_cast<uint32_t*>(sc_s + (size_t)(row0 + 8 * r) * L.sp + ks * 16 + nt * 8 +
                                       t2);
  };
  auto bits = [](uint32_t x, int hi) { return __uint_as_float(hi ? x & 0xffff0000u : x << 16); };

  int g = 0, j = 0;
  for (int it = blockIdx.x; it < items; it += gridDim.x, ++j, g += 2 * nkt) {
    int b, h, i0;
    item(it, b, h, i0);
    const float* bb = bias + (size_t)b * S;
    auto score = [&](float raw, int jj) {
      return jj < S ? mma_attn::unscale<DK>(raw, sc) + __ldg(bb + jj) : neg_inf();
    };
    consumers_sync(nc);  // the item before's P and partial sums are read

    // the scores: alternate 16-key steps of the strip, bf16(q.k) stored
    float mx[2] = {neg_inf(), neg_inf()};
    {
      uint32_t qa[DK / 16][4];
      cluster_ptx::mbar_wait(&qfull[j & 1], (j >> 1) & 1);
#pragma unroll
      for (int kd = 0; kd < DK / 16; ++kd) load_a(qa[kd], q_buf(j), KP, r0, 16 * kd, lane);
      release(&qempty[j & 1]);
      for (int t = 0; t < nkt; ++t) {
        wait_full(g + t);
        const int ks = 2 * t + hw;
        if (ks < nks) {
          const bf16* k_t = reinterpret_cast<const bf16*>(slot_base(g + t));
          float acc[2][4];
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
#pragma unroll
          for (int kd = 0; kd < DK / 16; ++kd) {
            uint32_t bf[4];
            load_b(bf, k_t, KP, 16 * hw, 16 * kd, lane);
            mma(acc[0], qa[kd], bf[0], bf[1]);
            mma(acc[1], qa[kd], bf[2], bf[3]);
          }
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const float lo = round_bf16(acc[nt][2 * r]), hi = round_bf16(acc[nt][2 * r + 1]);
              *sc_at(ks, nt, r) = pack_bf16(lo, hi);
              mx[r] = fmaxf(mx[r], fmaxf(score(lo, col(ks, nt, 2 * r)),
                                         score(hi, col(ks, nt, 2 * r + 1))));
            }
          }
        }
        release(&empty[(g + t) % slots]);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = mma_attn::quad_max(mx[r]);
      if ((lane & 3) == 0) red[hw * 16 * ns + row0 + 8 * r] = mx[r];
    }
    consumers_sync(nc);
#pragma unroll
    for (int r = 0; r < 2; ++r) mx[r] = fmaxf(red[row0 + 8 * r], red[16 * ns + row0 + 8 * r]);

    // the sum over this warp's own steps (each thread re-reads what it
    // stored), then bf16(P) over them
    float sm[2] = {0.f, 0.f};
    for (int ks = hw; ks < nks; ks += 2)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const uint32_t x = *sc_at(ks, nt, r);
#pragma unroll
          for (int c = 0; c < 2; ++c)
            sm[r] += expf(score(bits(x, c), col(ks, nt, 2 * r + c)) - mx[r]);
        }
    float* red_sum = red + 2 * 16 * ns;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sm[r] = mma_attn::quad_sum(sm[r]);
      if ((lane & 3) == 0) red_sum[hw * 16 * ns + row0 + 8 * r] = sm[r];
    }
    consumers_sync(nc);
    float rl[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sm[r] = red_sum[row0 + 8 * r] + red_sum[16 * ns + row0 + 8 * r];
      rl[r] = __frcp_rn(sm[r]);
    }
    for (int ks = hw; ks < nks; ks += 2)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          uint32_t* p = sc_at(ks, nt, r);
          const uint32_t x = *p;
          float w[2];
#pragma unroll
          for (int c = 0; c < 2; ++c)
            w[c] = mma_attn::div_row(expf(score(bits(x, c), col(ks, nt, 2 * r + c)) - mx[r]),
                                     sm[r], rl[r]);
          *p = pack_bf16(w[0], w[1]);
        }
    consumers_sync(nc);

    // P.V: this warp's strip by its 128 value columns
    float o[DV / 16][4];
#pragma unroll
    for (int nd = 0; nd < DV / 16; ++nd)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[nd][e] = 0.f;
    for (int t = 0; t < nkt; ++t) {
      wait_full(g + nkt + t);
      const bf16* v_t = reinterpret_cast<const bf16*>(slot_base(g + nkt + t));
#pragma unroll
      for (int kk = 0; kk < TK / 16; ++kk) {
        const int ks = 2 * t + kk;
        if (ks < nks) {
          uint32_t pa[4];
          load_a(pa, sc_s, L.sp, r0, 16 * ks, lane);
#pragma unroll
          for (int np = 0; np < DV / 32; ++np) {
            uint32_t vb[4];
            load_bt(vb, v_t, VP, 16 * kk, 128 * hw + 16 * np, lane);
            mma(o[2 * np], pa, vb[0], vb[1]);
            mma(o[2 * np + 1], pa, vb[2], vb[3]);
          }
        }
      }
      release(&empty[(g + nkt + t) % slots]);
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = i0 + row0 + 8 * r;
      if (i >= Q) continue;
      bf16* out = ctx + ((size_t)b * Q + i) * nh * DV + (size_t)h * DV + 128 * hw + t2;
#pragma unroll
      for (int nd = 0; nd < DV / 16; ++nd)
        *reinterpret_cast<uint32_t*>(out + nd * 8) = pack_bf16(o[nd][2 * r], o[nd][2 * r + 1]);
      if (row_max != nullptr && hw == 0 && (lane & 3) == 0) {
        row_max[((size_t)b * nh + h) * Q + i] = mx[r];
        row_sum[((size_t)b * nh + h) * Q + i] = sm[r];
      }
    }
  }
}

// ---- backward ---------------------------------------------------------------

// Shared memory of a backward block of ns strips with a ring of `slots`
// key tiles [TK][KP] each with its value tile [TK][VP], byte offsets: the
// ring, q [16 ns][KP], dctx [16 ns][VP], bf16 P and dsc of the current tile
// [16 ns][PP] each, the row max, the row sum and the two halves' D [4][16
// ns] fp32, the mbarriers (the ring's full and empty, then q's and dctx's).
struct BwdLayout {
  size_t q, o, p, ds, st, bars, total;
  __host__ __device__ BwdLayout(int ns, int slots) {
    q = (size_t)slots * TK * (KP + VP) * 2;
    o = q + (size_t)16 * ns * KP * 2;
    p = o + (size_t)16 * ns * VP * 2;
    ds = p + (size_t)16 * ns * PP * 2;
    st = ds + (size_t)16 * ns * PP * 2;
    bars = st + (size_t)4 * 16 * ns * 4;
    total = bars + (size_t)(2 * slots + 1) * 8;
  }
};

// the backward's ring at ns strips: as many slots as fit, up to
// BWD_MAX_SLOTS (0: not even BWD_MIN_SLOTS fit)
inline int bwd_slots(int ns) {
  int slots = 0;
  for (int n = BWD_MIN_SLOTS; n <= BWD_MAX_SLOTS; ++n)
    if (BwdLayout(ns, n).total <= SMEM_LIMIT) slots = n;
  return slots;
}

// One block per (b, h) with all Q <= 16 BWD_STRIPS queries: WPS ns consumer
// warps (ns = Q / 16 rounded up), WPS = 2 up to MAXS = BWD_PAIRED strips,
// else 1, and a producer.  A strip's WPS warps take its alternate 16-key
// steps and split dQ's 128 columns; the cap keeps each instance within 96
// registers a thread (its warps' allocation granularity), so none spills.
template <int WPS, int MAXS>
__global__ void __launch_bounds__(32 * (WPS * MAXS + 1))
xattn_bwd(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
          const float* __restrict__ bias, const float* __restrict__ row_max,
          const float* __restrict__ row_sum,
          const bf16* __restrict__ dctx,  // [B, Q, nh, DV]
          bf16* __restrict__ dq,          // [B, Q, nh, DK]
          bf16* __restrict__ dk,          // [B, S, nh, DK]
          bf16* __restrict__ dv,          // [B, S, nh, DV]
          int Q, int S, int nh, int slots) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int DQW = DK / WPS;  // dQ columns a warp accumulates
  const int ns = (Q + 15) >> 4, ncw = WPS * ns, nthreads = 32 * (ncw + 1);
  const BwdLayout L(ns, slots);
  const int b = blockIdx.z, h = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nks = (S + 15) >> 4, nkt = (S + TK - 1) / TK;
  constexpr size_t SLOT = (size_t)TK * (KP + VP) * 2;
  bf16* q_s = reinterpret_cast<bf16*>(smem + L.q);
  bf16* o_s = reinterpret_cast<bf16*>(smem + L.o);
  bf16* p_s = reinterpret_cast<bf16*>(smem + L.p);
  bf16* ds_s = reinterpret_cast<bf16*>(smem + L.ds);
  float* mx_s = reinterpret_cast<float*>(smem + L.st);  // [16 ns] each: max, sum, D halves
  float* sm_s = mx_s + 16 * ns;
  float* dred = sm_s + 16 * ns;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L.bars);
  uint64_t* empty = full + slots;
  uint64_t* qo_full = empty + slots;  // q's and dctx's rows

  // the ring, q and dctx zeroed: the rows the copies leave (keys past S,
  // queries past Q) hold finite values
  zero_smem(smem, L.p, threadIdx.x, nthreads);
  const size_t st = ((size_t)b * nh + h) * Q;
  for (int i = threadIdx.x; i < 16 * ns; i += nthreads) {
    mx_s[i] = i < Q ? row_max[st + i] : 0.f;
    sm_s[i] = i < Q ? row_sum[st + i] : 1.f;
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < slots; ++s) {
      cluster_ptx::mbar_init(&full[s], 1);
      cluster_ptx::mbar_init(&empty[s], ncw);
    }
    cluster_ptx::mbar_init(qo_full, 1);
    cluster_ptx::fence_mbar_init();
  }
  cluster_ptx::fence_proxy_async();
  __syncthreads();

  if (warp == ncw) {  // the producer: q's and dctx's rows, then each key tile
                      // with its value tile, twice
    if (lane == 0) cluster_ptx::mbar_expect(qo_full, Q * (DK + DV) * 2);
    __syncwarp();
    for (int r = lane; r < Q; r += 32) {
      const size_t i = ((size_t)b * Q + r) * nh + h;
      bulk_g2s(smem_addr(q_s + r * KP), q + i * DK, DK * 2, smem_addr(qo_full));
      bulk_g2s(smem_addr(o_s + r * VP), dctx + i * DV, DV * 2, smem_addr(qo_full));
    }
    for (int e = 0; e < 2 * nkt; ++e) {
      const int slot = e % slots, use = e / slots;
      if (use > 0) cluster_ptx::mbar_wait(&empty[slot], (use - 1) & 1);
      const int t = e % nkt, rows = min(TK, S - t * TK);
      const uint32_t bar = smem_addr(&full[slot]);
      if (lane == 0) cluster_ptx::mbar_expect(&full[slot], rows * (DK + DV) * 2);
      __syncwarp();
      if (lane < rows) {
        const size_t j = (size_t)b * S + t * TK + lane;
        const uint32_t dst = smem_addr(smem + slot * SLOT);
        bulk_g2s(dst + lane * KP * 2, k + j * nh * DK + (size_t)h * DK, DK * 2, bar);
        bulk_g2s(dst + TK * KP * 2 + lane * VP * 2, v + j * nh * DV + (size_t)h * DV, DV * 2,
                 bar);
      }
    }
    return;
  }

  const int sw = warp % ns, hw = warp / ns;  // this warp's strip and part (0 .. WPS-1)
  const int r0 = 16 * sw, g = lane >> 2, t2 = 2 * (lane & 3), row0 = r0 + g;
  const int nc = 32 * ncw;
  const Scale sc = mma_attn::scale<DK>();
  const float* bb = bias + (size_t)b * S;
  auto slot_of = [&](int e) {
    return reinterpret_cast<const bf16*>(smem + (size_t)(e % slots) * SLOT);
  };
  auto wait_full = [&](int e) { cluster_ptx::mbar_wait(&full[e % slots], (e / slots) & 1); };
  auto release = [&](int e) {
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[e % slots]);
  };
  // P and bf16(dP) of this warp's strip at key step ks (rows 16 (ks & 1) of
  // the tile at kv), with the forward's score expression and product order
  auto p_dp = [&](const bf16* kv, int ks, float (&p)[2][4], float (&dp)[2][4]) {
    const int kr = 16 * (ks & 1);
    product<DK / 16>(p, q_s, KP, r0, kv, KP, kr, lane);
    product<DV / 16>(dp, o_s, VP, r0, kv + TK * KP, VP, kr, lane);
#pragma unroll
    for (int r = 0; r < 2; ++r) {  // the row's statistics, read here to spare registers
      const float mx = mx_s[row0 + 8 * r], sm = sm_s[row0 + 8 * r], rl = __frcp_rn(sm);
      const bool valid = row0 + 8 * r < Q;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int e = 2 * r + c, j = ks * 16 + nt * 8 + t2 + c;
          const float s = j < S ? mma_attn::unscale<DK>(round_bf16(p[nt][e]), sc) + __ldg(bb + j)
                                : neg_inf();
          // queries past Q (zero q and dctx rows) take P = 0: they add nothing
          p[nt][e] = valid ? mma_attn::div_row(expf(s - mx), sm, rl) : 0.f;
          dp[nt][e] = round_bf16(dp[nt][e]);
        }
    }
  };

  cluster_ptx::mbar_wait(qo_full, 0);

  // first pass: D = rowsum(dP * P), the strip's parts summed in order
  float D[2] = {0.f, 0.f};
  for (int t = 0; t < nkt; ++t) {
    wait_full(t);
    auto d_step = [&](int ks) {
      if (ks < nks) {
        float p[2][4], dp[2][4];
        p_dp(slot_of(t), ks, p, dp);
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) D[e >> 1] += dp[nt][e] * p[nt][e];
      }
    };
    if constexpr (WPS == 2) {  // the tile's two 16-key steps: one this warp's
      d_step(2 * t + hw);
    } else {
      d_step(2 * t);
      d_step(2 * t + 1);
    }
    release(t);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    D[r] = mma_attn::quad_sum(D[r]);
    if ((lane & 3) == 0) dred[hw * 16 * ns + row0 + 8 * r] = D[r];
  }
  consumers_sync(nc);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    D[r] = dred[row0 + 8 * r];
    if (WPS == 2) D[r] += dred[16 * ns + row0 + 8 * r];
  }

  // second pass: dsc per tile; dQ in registers; the tile's dV and dK
  float dqa[DQW / 8][4];
#pragma unroll
  for (int nd = 0; nd < DQW / 8; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) dqa[nd][e] = 0.f;
  for (int t = 0; t < nkt; ++t) {
    wait_full(nkt + t);
    const bf16* k_t = slot_of(nkt + t);
    auto ds_step = [&](int kk) {
      const int ks = 2 * t + kk;
      float p[2][4], ds[2][4];
      if (ks < nks) {
        p_dp(k_t, ks, p, ds);
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            ds[nt][e] = mma_attn::unscale<DK>(p[nt][e] * (ds[nt][e] - D[e >> 1]), sc);
      } else {  // a key step past S: nothing (the tile's second step)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) p[nt][e] = ds[nt][e] = 0.f;
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const size_t at = (size_t)(row0 + 8 * r) * PP + 16 * kk + nt * 8 + t2;
          *reinterpret_cast<uint32_t*>(p_s + at) = pack_bf16(p[nt][2 * r], p[nt][2 * r + 1]);
          *reinterpret_cast<uint32_t*>(ds_s + at) = pack_bf16(ds[nt][2 * r], ds[nt][2 * r + 1]);
        }
    };
    if constexpr (WPS == 2) {
      ds_step(hw);
    } else {
      ds_step(0);
      ds_step(1);
    }
    consumers_sync(nc);

    // dQ (strip, this warp's DQW columns) += dsc . K over the tile's 32 keys
#pragma unroll
    for (int kk = 0; kk < TK / 16; ++kk) {
      uint32_t a[4];
      load_a(a, ds_s, PP, r0, 16 * kk, lane);
#pragma unroll
      for (int np = 0; np < DQW / 16; ++np) {
        uint32_t kb[4];
        load_bt(kb, k_t, KP, 16 * kk, DQW * hw + 16 * np, lane);
        mma(dqa[2 * np], a, kb[0], kb[1]);
        mma(dqa[2 * np + 1], a, kb[2], kb[3]);
      }
    }
    release(nkt + t);  // the slot's last reader: the producer may refill it
    // the tile's 24 tasks of 16 keys x 32 columns: dV (16), then dK (8)
    for (int task = warp; task < 24; task += ncw) {
      const bool is_v = task < 16;
      const int kk = is_v ? task >> 3 : (task - 16) >> 2;
      const int c0 = 32 * (is_v ? task & 7 : (task - 16) & 3);
      const bf16* at = is_v ? p_s : ds_s;
      const bf16* bt = is_v ? o_s : q_s;
      const int pb = is_v ? VP : KP;
      float acc[4][4];
#pragma unroll
      for (int nd = 0; nd < 4; ++nd)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nd][e] = 0.f;
      for (int qs = 0; qs < ns; ++qs) {
        uint32_t a[4];
        load_at(a, at, PP, 16 * qs, 16 * kk, lane);
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          uint32_t bf[4];
          load_bt(bf, bt, pb, 16 * qs, c0 + 16 * np, lane);
          mma(acc[2 * np], a, bf[0], bf[1]);
          mma(acc[2 * np + 1], a, bf[2], bf[3]);
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int j = t * TK + 16 * kk + g + 8 * r;
        if (j >= S) continue;
        bf16* out = is_v ? dv + ((size_t)b * S + j) * nh * DV + (size_t)h * DV
                         : dk + ((size_t)b * S + j) * nh * DK + (size_t)h * DK;
        out += c0 + t2;
#pragma unroll
        for (int nd = 0; nd < 4; ++nd)
          *reinterpret_cast<uint32_t*>(out + nd * 8) = pack_bf16(acc[nd][2 * r], acc[nd][2 * r + 1]);
      }
    }
    consumers_sync(nc);  // the tile's P and dsc are read: the next tile's may land
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = row0 + 8 * r;
    if (i >= Q) continue;
    bf16* out = dq + ((size_t)b * Q + i) * nh * DK + (size_t)h * DK + DQW * hw + t2;
#pragma unroll
    for (int nd = 0; nd < DQW / 8; ++nd)
      *reinterpret_cast<uint32_t*>(out + nd * 8) = pack_bf16(dqa[nd][2 * r], dqa[nd][2 * r + 1]);
  }
}

// ---- launchers ----------------------------------------------------------------

template <typename K>
cudaError_t allow(K kernel, size_t bytes) {
  return bytes <= 48 * 1024 ? cudaSuccess
                            : cudaFuncSetAttribute(kernel,
                                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                   (int)bytes);
}

// q [B, Q, nh, DK], k [B, S, nh, DK], v [B, S, nh, DV] bf16 contiguous,
// bias [B, S] fp32; row_max / row_sum fp32 [B, nh, Q] (both null: not
// saved); ctx [B, Q, nh, DV] bf16.
inline cudaError_t launch_fwd(const void* q, const void* k, const void* v, const float* bias,
                              float* row_max, float* row_sum, void* ctx, int B, int Q, int S,
                              int nh, cudaStream_t stream) {
  if (B < 1 || Q < 1 || S < 1 || nh < 1 || bias == nullptr ||
      (row_max == nullptr) != (row_sum == nullptr))
    return cudaErrorInvalidValue;
  const FwdConfig c = fwd_config(Q, S);
  if (c.ns == 0) return cudaErrorInvalidValue;
  const FwdLayout L(c.ns, S, c.slots);
  cudaError_t e = allow(xattn_fwd, L.total);
  if (e != cudaSuccess) return e;
  int dev = 0, sms = 0;
  e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  // one persistent block an SM (its layout takes most of the SM's shared memory)
  const int items = ((Q + 15) / 16 + c.ns - 1) / c.ns * nh * B;
  xattn_fwd<<<items < sms ? items : sms, 32 * (2 * c.ns + 1), L.total, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      bias, row_max, row_sum, static_cast<bf16*>(ctx), B, Q, S, nh, c.ns, c.slots);
  return cudaGetLastError();
}

// The forward's operands and statistics and dctx [B, Q, nh, DV] bf16 ->
// dq, dk, dv bf16 shaped as q, k, v.  Q <= 16 BWD_STRIPS.
inline cudaError_t launch_bwd(const void* q, const void* k, const void* v, const float* bias,
                              const float* row_max, const float* row_sum, const void* dctx,
                              void* dq, void* dk, void* dv, int B, int Q, int S, int nh,
                              cudaStream_t stream) {
  if (B < 1 || Q < 1 || Q > 16 * BWD_STRIPS || S < 1 || nh < 1 || bias == nullptr)
    return cudaErrorInvalidValue;
  const int ns = (Q + 15) / 16, slots = bwd_slots(ns);
  if (slots == 0) return cudaErrorInvalidValue;
  const BwdLayout L(ns, slots);
  const bool paired = ns <= BWD_PAIRED;
  const auto kernel = paired ? xattn_bwd<2, BWD_PAIRED> : xattn_bwd<1, BWD_STRIPS>;
  cudaError_t e = allow(kernel, L.total);
  if (e != cudaSuccess) return e;
  kernel<<<dim3(1, nh, B), 32 * ((paired ? 2 : 1) * ns + 1), L.total, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      bias, row_max, row_sum, static_cast<const bf16*>(dctx), static_cast<bf16*>(dq),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), Q, S, nh, slots);
  return cudaGetLastError();
}

}  // namespace xattn
}  // namespace

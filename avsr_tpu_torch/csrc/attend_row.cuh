// K10's row read ("row", kernels.attend_route): the RNN decoder's attention
// read at one query row a memory row (W = 1: greedy decode and the
// teacher-forced loop's forward).  It computes bahdanau_core.cuh's
// function, rounding points included (avsr_tpu/ops/attention.py:attend,
// Bahdanau :140-151, Luong :152-163, the mask :165-171):
//
//   q  = bf16(query) . wq                                (fp32; Luong: bf16(q))
//   additive: sc[s] = sum_a bf16(tanh(keys[s, a] + q[a])) bf16(v[a]) + bias[s]
//   dot:      sc[s] = sum_a keys[s, a] q[a] + bias[s]
//   p = softmax(sc) * mask;  w = p / max(sum p, 1e-9) * min(sum mask, 1)
//   ctx[d] = sum_s bf16(w[s]) values[s, d]               (fp32)
//
// Design: one CTA a query row (one an SM: N = 128 rows fill a wave of 132
// SMs), in clusters of two CTAs (consecutive rows; one where N is odd): 16
// consumer warps that compute the read and a producer warp that streams
// the memory row through a ring of SLOTS slots of shared memory by bulk
// asynchronous copies (cp.async.bulk), each counted on the slot's full
// mbarrier; the consumers free a slot on its empty mbarrier (one arrival a
// warp), so no copy waits for a block barrier and no consumer waits for an
// issue.  The row's bytes are one sequence of chunks: the keys' chunks (kc
// keys each), then the values' (vc keys each).  The producer starts once
// the consumers' first loads (the query, bias, mask, v and their columns
// of wq) are in flight, and keeps WINDOW chunks in flight: the row streams
// while the block forms q, the values' chunks land while the scores and
// the softmax run, and a load issued meanwhile queues behind ~75 KB a row,
// not the whole ring (with every slot in flight at once the set-up's loads
// waited ~9 us on the H100).  Luong's keys are its values (one tensor):
// where the row fits in the ring (S <= 200 at the presets' 512 columns) its
// chunks are issued once and the context reads the slots the scores read,
// so the row is read from device memory once; a longer row (16 s, S = 531)
// is read in two passes, the scores' and the context's.
//
//   1. q: CTA r of a cluster forms the columns [r A / 2, (r + 1) A / 2) for
//      both rows of the cluster, so every CTA reads half of wq from L2 (all
//      128 CTAs read wq at once: 33.5 MB of Luong's wq a step whole, 16.8
//      halved); a consumer per 8 columns and a slice of the rows (16-byte
//      loads, a warp's contiguous runs of whole lines, 16 rows in flight a
//      thread), the slices' partial sums in the ring's last QSLOTS slots
//      (the producer fills them only once q is formed), added in a fixed
//      order; the other row's columns go into its CTA's q by st.async,
//      counted on that CTA's mbarrier.
//   2. scores, chunk by chunk as they land: a warp a key, each lane a float4
//      (Bahdanau: fp32 keys) or 16 bytes (Luong: 8 bf16 keys) of the key
//      row, a shuffle tree over the warp, two keys a warp in flight.
//      Bahdanau's energies are tanhf, the reference's function (tanh_fast,
//      one ex2.approx and one rcp.approx, measured no faster on the H100:
//      the scores wait on the row's bytes, not on the multi-function unit).
//   3. softmax, mask and renormalisation: three block reductions (the max,
//      the sum, then the masked sum and the mask's sum together), each a
//      shuffle tree and the warps' partials in order; the quotients are
//      div_row's from rcp_newton's reciprocal (no div.rn slow path).
//   4. context, chunk by chunk: a thread per 16-byte chunk (8 channels) of
//      a value row and a slice of the keys (key s to slice s % slices, in
//      increasing s whatever the chunking), the slices' sums added in a
//      fixed order at the end.
//
// Every sum runs in a fixed order, so every run gives the same bits.  A
// memory of length 0 (every bias -1e30, every mask 0) gives zero weights
// and a zero context, as the reference does.  What bounds it on an H100:
// the row's bytes, read once (S (4 A + 2 Dv) for Bahdanau, S 2 A for
// Luong's one tensor), at N = 128, S = 197: 51.6 MB (15.4 us at 3.35 TB/s)
// and 25.8 MB (7.7 us); what holds it back, the wq reads and the small
// loads that queue in L2 behind the stream before the scores can start
// (PERF.md).  Requirements (checked by the launcher): Hq, A and Dv
// multiples of 16, Hq <= 1024, A <= 512, Dv <= 2048, S <= 1024, Layout's
// total within a block's shared memory.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attend_grouped.cuh"
#include "bahdanau_core.cuh"
#include "cluster_ptx.cuh"

namespace {
namespace attend_row {

using bf16 = __nv_bfloat16;

constexpr int CONSUMERS = 512;    // threads that compute the read
constexpr int CWARPS = CONSUMERS / 32;
constexpr int THREADS = CONSUMERS + 32;  // and a producer warp that issues the copies
constexpr int SLOTS = 8;          // chunks of the row in flight, landed or in use
constexpr int WINDOW = 3;         // chunks in flight: enough for the row's share of the
                                  // bandwidth, few enough that a load waits little behind them
constexpr int SLOT = 25600;       // bytes a slot: Luong's 197 x 512 bf16 row in 8 slots
constexpr int QLD = 16;           // rows of wq in flight a thread
constexpr int QSLOTS = 2;         // the ring's last slots, which hold q's partial sums first
constexpr int MAX_HQ = 1024;      // query width (two values a consumer)
constexpr int MAX_S = 1024;       // keys a row (two bias and mask values a consumer)

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ inline size_t up16(size_t x) { return (x + 15) & ~(size_t)15; }

// The chunk plan and the shared memory of one CTA, byte offsets: the ring
// [SLOTS][SLOT] (q's partial sums before its last slots' first chunks, the
// context's after the last chunk), q [A] fp32, v [A] fp32 (Bahdanau), the
// cluster's bf16(query) [2][Hq] fp32, the scores then weights [S] fp32,
// bias and mask [S], the reductions' slots [2 CWARPS], the mbarriers: the
// slots' full and empty ones, q's partial sums read, the other CTA's
// columns of q landed.  `same`: the keys are the values (Luong's one
// tensor, A == Dv).
struct Layout {
  int kc, vc, nk, nv;  // keys a chunk of each pass; chunks of each (nv = 0: the
                       // context reads the keys' chunks, the row resident)
  size_t ring, q, v, qin, p, bias, mask, red, bars, total;
  __host__ __device__ Layout(int Hq, int A, int S, int Dv, bool dot, bool same) {
    const int kb = A * (dot ? 2 : 4), vb = Dv * 2;
    kc = SLOT / kb < S ? SLOT / kb : S;
    vc = SLOT / vb < S ? SLOT / vb : S;
    if (same && S <= SLOTS * kc) {
      kc = vc = cdiv(S, SLOTS);
      nk = cdiv(S, kc);
      nv = 0;
    } else {
      nk = cdiv(S, kc);
      nv = cdiv(S, vc);
    }
    size_t o = 0;
    ring = o;  o += (size_t)SLOTS * SLOT;
    q = o;     o += up16((size_t)A * 4);
    v = o;     o += dot ? 0 : up16((size_t)A * 4);
    qin = o;   o += up16((size_t)2 * Hq * 4);
    p = o;     o += up16((size_t)S * 4);
    bias = o;  o += up16((size_t)S * 4);
    mask = o;  o += up16((size_t)S * 4);
    red = o;   o += (size_t)2 * CWARPS * 4;
    bars = o;  o += (size_t)(2 * SLOTS + 2) * 8;
    total = o;
  }
};

// the consumer warps' barrier (the producer warp never joins it)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS) : "memory");
}

// the consumers' max (MAX) or sum of one value a thread: a shuffle tree,
// then the warps' partials in order (the same bits in every thread)
template <bool MAX>
__device__ __forceinline__ float block_reduce(float x, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float y = __shfl_xor_sync(0xffffffffu, x, o);
    x = MAX ? fmaxf(x, y) : x + y;
  }
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = x;
  consumers_sync();
  float r = red[0];
#pragma unroll
  for (int w = 1; w < CWARPS; ++w) r = MAX ? fmaxf(r, red[w]) : r + red[w];
  consumers_sync();  // red is reused by the next reduction
  return r;
}

// the consumers' signal that their first loads are in flight, and the
// producer's wait for it
__device__ __forceinline__ void go_arrive() {
  asm volatile("bar.arrive 2, %0;\n" ::"n"(THREADS) : "memory");
}
__device__ __forceinline__ void go_wait() {
  asm volatile("bar.sync 2, %0;\n" ::"n"(THREADS) : "memory");
}

template <bool DOT>
__global__ void __launch_bounds__(THREADS, 1)
attend_row_kernel(const float* __restrict__ query,      // [N, Hq]
                  const bf16* __restrict__ wq,          // [Hq, A]
                  const bf16* __restrict__ vatt,        // [A] (null: Luong)
                  const void* __restrict__ keys_in,     // [B, S, A] fp32 / bf16 (Luong)
                  const bf16* __restrict__ values,      // [B, S, Dv]
                  const float* __restrict__ bias,       // [B, S]
                  const float* __restrict__ mask,       // [B, S]
                  float* __restrict__ ctx,              // [N, Dv]
                  float* __restrict__ weights,          // [N, S]
                  int W, int Hq, int A, int S, int Dv) {
  using bahdanau::bf_hi;
  using bahdanau::bf_lo;
  using bahdanau::bf_round;
  extern __shared__ __align__(128) unsigned char rsm[];
  // row: start
  using Key = typename bahdanau::Key<DOT>::type;
  const bool same = DOT && static_cast<const void*>(values) == keys_in && A == Dv;
  const Layout L(Hq, A, S, Dv, DOT, same);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const size_t n = blockIdx.x, m = n / W;  // query row n reads memory row n / W
  unsigned char* ring = rsm + L.ring;
  float* q_s = reinterpret_cast<float*>(rsm + L.q);
  float* v_s = reinterpret_cast<float*>(rsm + L.v);
  float* qin = reinterpret_cast<float*>(rsm + L.qin);
  float* p_s = reinterpret_cast<float*>(rsm + L.p);
  float* bias_s = reinterpret_cast<float*>(rsm + L.bias);
  float* mask_s = reinterpret_cast<float*>(rsm + L.mask);
  float* red = reinterpret_cast<float*>(rsm + L.red);
  uint64_t* full = reinterpret_cast<uint64_t*>(rsm + L.bars);
  uint64_t* empty = full + SLOTS;
  const Key* keys = static_cast<const Key*>(keys_in) + m * S * A;
  values += m * S * Dv;
  const int kb = A * (int)sizeof(Key), vb = Dv * 2, total = L.nk + L.nv;
  const bool stream = L.nv > 0;  // slots are reused: the consumers free them

  uint64_t* qdone = empty + SLOTS;  // q's partial sums, in the last QSLOTS slots, are read
  uint64_t* qx = qdone + 1;         // the peer CTA's columns of q have landed
  // the cluster: C CTAs (1 or 2) of consecutive rows n0 .. n0 + C - 1; CTA r
  // forms q's columns [r A / C, (r + 1) A / C) for the C rows
  const int C = attend_grouped::cluster_size(), r = (int)cluster_ptx::cluster_rank();
  const size_t n0 = n - r;
  const int Ac = A / C;
  if (tid == 0) {
    for (int i = 0; i < SLOTS; ++i) {
      cluster_ptx::mbar_init(&full[i], 1);
      cluster_ptx::mbar_init(&empty[i], CWARPS);
    }
    cluster_ptx::mbar_init(qdone, CWARPS);
    cluster_ptx::mbar_init(qx, 1);
    cluster_ptx::fence_mbar_init();
    if (C > 1) cluster_ptx::mbar_expect(qx, (uint32_t)((A - Ac) * 4));
  }
  __syncthreads();
  attend_grouped::cluster_arrive_relaxed();  // this CTA runs, its barriers are set

  if (warp == CWARPS) {
    // the producer: chunk g of the row's sequence (the keys' chunks, then
    // the values') into slot g % SLOTS once the consumers have freed it,
    // counted on the slot's full mbarrier; it starts once the consumers'
    // first loads are in flight, so they are not queued behind the row
    cluster_ptx::cluster_wait();
    go_wait();
    if (lane == 0) {
      for (int g = 0; g < total; ++g) {
        if (g >= SLOTS) cluster_ptx::mbar_wait(&empty[g % SLOTS], (uint32_t)((g / SLOTS - 1) & 1));
        if (g >= SLOTS - QSLOTS && g < SLOTS) cluster_ptx::mbar_wait(qdone, 0);
        // at most WINDOW chunks in flight
        if (g >= WINDOW) {
          const int h = g - WINDOW;
          cluster_ptx::mbar_wait(&full[h % SLOTS], (uint32_t)((h / SLOTS) & 1));
        }
        const bool key = g < L.nk;
        const int c = key ? g : g - L.nk, per = key ? L.kc : L.vc, rb = key ? kb : vb;
        const int s0 = c * per, ns = min(S, s0 + per) - s0;
        const unsigned char* src = key ? reinterpret_cast<const unsigned char*>(keys)
                                       : reinterpret_cast<const unsigned char*>(values);
        uint64_t* bar = &full[g % SLOTS];
        cluster_ptx::mbar_expect(bar, (uint32_t)(ns * rb));
        cluster_ptx::bulk_g2s(cluster_ptx::smem_addr(ring + (size_t)(g % SLOTS) * SLOT),
                              src + (size_t)s0 * rb, (uint32_t)(ns * rb),
                              cluster_ptx::smem_addr(bar));
      }
    }
    return;
  }

  auto wait = [&](int g) { cluster_ptx::mbar_wait(&full[g % SLOTS], (uint32_t)((g / SLOTS) & 1)); };
  // a warp is done with chunk g: one arrival of the slot's empty barrier
  auto release = [&](int g) {
    if (!stream) return;
    __syncwarp();
    if (lane == 0) cluster_ptx::mbar_arrive(&empty[g % SLOTS]);
  };

  // the C queries, v, bias and mask in flight
  float qv[2][MAX_HQ / CONSUMERS], bx[MAX_S / CONSUMERS], mx_[MAX_S / CONSUMERS], vx = 0.f;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < MAX_HQ / CONSUMERS; ++j) {
      const int k = tid + j * CONSUMERS;
      qv[i][j] = i < C && k < Hq ? query[(n0 + i) * Hq + k] : 0.f;
    }
#pragma unroll
  for (int j = 0; j < MAX_S / CONSUMERS; ++j) {
    const int s = tid + j * CONSUMERS;
    bx[j] = s < S ? bias[m * S + s] : 0.f;
    mx_[j] = s < S ? mask[m * S + s] : 0.f;
  }
  if (!DOT && tid < A) vx = __bfloat162float(vatt[tid]);
  // then this CTA's columns of wq, as [Hq][G] 16-byte chunks of 8 columns:
  // consumer t owns chunk column g8 = r Gc + t % Gc of the rows k = t / Gc
  // (mod qsl), so a warp's loads of one step are contiguous runs of whole L2
  // lines (every CTA reads its share of wq, and the L2 serves lines, not
  // 16-byte pieces); then the producer's signal
  const int G = A / 8, Gc = G / C, qsl = CONSUMERS / Gc, g8 = r * Gc + tid % Gc, sl = tid / Gc;
  const bool qlane = sl < qsl;
  const uint4* w8 = reinterpret_cast<const uint4*>(wq) + g8;
  uint4 ww[QLD];
  auto load_wq = [&](int k0) {
#pragma unroll
    for (int j = 0; j < QLD; ++j) {
      const int k = k0 + j * qsl;
      ww[j] = qlane && k < Hq ? w8[(size_t)k * G] : make_uint4(0u, 0u, 0u, 0u);
    }
  };
  load_wq(sl);
  go_arrive();
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < MAX_HQ / CONSUMERS; ++j) {
      const int k = tid + j * CONSUMERS;
      if (i < C && k < Hq) qin[i * Hq + k] = bf_round(qv[i][j]);
    }
#pragma unroll
  for (int j = 0; j < MAX_S / CONSUMERS; ++j) {
    const int s = tid + j * CONSUMERS;
    if (s < S) {
      bias_s[s] = bx[j];
      mask_s[s] = mx_[j];
    }
  }
  if (!DOT && tid < A) v_s[tid] = vx;
  consumers_sync();
  // row: set up

  // 1. q: each consumer's partial sums of its 8 columns over its rows for
  // the C queries (QLD rows of wq in flight), into the ring's last QSLOTS
  // slots (which the producer fills only once q is formed), then the qsl
  // slices added in order; this row's columns into q_s, the peer's into the
  // peer's q_s (st.async, counted on its qx mbarrier)
  {
    float acc[2][8];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    for (int k0 = sl; k0 < Hq; k0 += QLD * qsl) {
      if (k0 != sl) load_wq(k0);
#pragma unroll
      for (int j = 0; j < QLD; ++j) {
        const int k = k0 + j * qsl;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          if (i >= C) continue;
          const float x = k < Hq ? qin[i * Hq + k] : 0.f;
          acc[i][0] = fmaf(x, bf_lo(ww[j].x), acc[i][0]);
          acc[i][1] = fmaf(x, bf_hi(ww[j].x), acc[i][1]);
          acc[i][2] = fmaf(x, bf_lo(ww[j].y), acc[i][2]);
          acc[i][3] = fmaf(x, bf_hi(ww[j].y), acc[i][3]);
          acc[i][4] = fmaf(x, bf_lo(ww[j].z), acc[i][4]);
          acc[i][5] = fmaf(x, bf_hi(ww[j].z), acc[i][5]);
          acc[i][6] = fmaf(x, bf_lo(ww[j].w), acc[i][6]);
          acc[i][7] = fmaf(x, bf_hi(ww[j].w), acc[i][7]);
        }
      }
    }
    // [qsl][C][Ac] fp32
    float* qpart = reinterpret_cast<float*>(ring + (size_t)(SLOTS - QSLOTS) * SLOT);
    if (qlane)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if (i >= C) continue;
        float4* o = reinterpret_cast<float4*>(qpart + ((size_t)sl * C + i) * Ac + 8 * (tid % Gc));
        o[0] = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
        o[1] = make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
      }
    consumers_sync();
    cluster_ptx::cluster_wait();  // every CTA of the cluster runs, its barriers set
    for (int e = tid; e < A; e += CONSUMERS) {
      const int i = e / Ac, a = e % Ac;
      float x = 0.f;
      for (int j = 0; j < qsl; ++j) x += qpart[((size_t)j * C + i) * Ac + a];
      if (DOT) x = bf_round(x);  // the dot score's cast of q
      float* dst = q_s + r * Ac + a;
      if (i == r)
        *dst = x;
      else
        cluster_ptx::st_async_b32(cluster_ptx::map_rank(cluster_ptx::smem_addr(dst), i),
                                  __float_as_uint(x),
                                  cluster_ptx::map_rank(cluster_ptx::smem_addr(qx), i));
    }
    __syncwarp();
    if (lane == 0) cluster_ptx::mbar_arrive(qdone);  // the last slots are free for the producer
    if (C > 1) cluster_ptx::mbar_wait(qx, 0);  // the peer's columns of q
    consumers_sync();
  }
  // row: q formed

  // 2. the scores of each key chunk as it lands: a warp a key, two keys in
  // flight (their chains interleaved)
  for (int g = 0; g < L.nk; ++g) {
    wait(g);
    const int s0 = g * L.kc, s1 = min(S, s0 + L.kc);
    const unsigned char* slot = ring + (size_t)(g % SLOTS) * SLOT;
    for (int s = s0 + warp; s < s1; s += 2 * CWARPS) {
      const int s2 = min(s + CWARPS, s1 - 1);  // a warp past the chunk redoes key s1 - 1
      float acc = 0.f, acc2 = 0.f;
      if constexpr (DOT) {
        const uint4* k8 = reinterpret_cast<const uint4*>(slot + (size_t)(s - s0) * kb);
        const uint4* k8b = reinterpret_cast<const uint4*>(slot + (size_t)(s2 - s0) * kb);
        const float4* q4 = reinterpret_cast<const float4*>(q_s);
        for (int c = lane; c < A / 8; c += 32) {
          const uint4 kv = k8[c], kw = k8b[c];
          const float4 qa = q4[2 * c], qb = q4[2 * c + 1];
          acc = fmaf(bf_lo(kv.x), qa.x, acc);
          acc2 = fmaf(bf_lo(kw.x), qa.x, acc2);
          acc = fmaf(bf_hi(kv.x), qa.y, acc);
          acc2 = fmaf(bf_hi(kw.x), qa.y, acc2);
          acc = fmaf(bf_lo(kv.y), qa.z, acc);
          acc2 = fmaf(bf_lo(kw.y), qa.z, acc2);
          acc = fmaf(bf_hi(kv.y), qa.w, acc);
          acc2 = fmaf(bf_hi(kw.y), qa.w, acc2);
          acc = fmaf(bf_lo(kv.z), qb.x, acc);
          acc2 = fmaf(bf_lo(kw.z), qb.x, acc2);
          acc = fmaf(bf_hi(kv.z), qb.y, acc);
          acc2 = fmaf(bf_hi(kw.z), qb.y, acc2);
          acc = fmaf(bf_lo(kv.w), qb.z, acc);
          acc2 = fmaf(bf_lo(kw.w), qb.z, acc2);
          acc = fmaf(bf_hi(kv.w), qb.w, acc);
          acc2 = fmaf(bf_hi(kw.w), qb.w, acc2);
        }
      } else {
        const float4* k4 = reinterpret_cast<const float4*>(slot + (size_t)(s - s0) * kb);
        const float4* k4b = reinterpret_cast<const float4*>(slot + (size_t)(s2 - s0) * kb);
        const float4* q4 = reinterpret_cast<const float4*>(q_s);
        const float4* v4 = reinterpret_cast<const float4*>(v_s);
        for (int c = lane; c < A / 4; c += 32) {
          const float4 kk = k4[c], kw = k4b[c], qq = q4[c], vv = v4[c];
          acc = fmaf(bf_round(tanhf(kk.x + qq.x)), vv.x, acc);
          acc2 = fmaf(bf_round(tanhf(kw.x + qq.x)), vv.x, acc2);
          acc = fmaf(bf_round(tanhf(kk.y + qq.y)), vv.y, acc);
          acc2 = fmaf(bf_round(tanhf(kw.y + qq.y)), vv.y, acc2);
          acc = fmaf(bf_round(tanhf(kk.z + qq.z)), vv.z, acc);
          acc2 = fmaf(bf_round(tanhf(kw.z + qq.z)), vv.z, acc2);
          acc = fmaf(bf_round(tanhf(kk.w + qq.w)), vv.w, acc);
          acc2 = fmaf(bf_round(tanhf(kw.w + qq.w)), vv.w, acc2);
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        acc += __shfl_xor_sync(0xffffffffu, acc, o);
        acc2 += __shfl_xor_sync(0xffffffffu, acc2, o);
      }
      if (lane == 0) {
        p_s[s] = acc + bias_s[s];
        if (s + CWARPS < s1) p_s[s + CWARPS] = acc2 + bias_s[s + CWARPS];
      }
    }
    release(g);
  }
  consumers_sync();
  // row: scores formed

  // 3. softmax (fp32), the mask, the renormalisation and the empty-memory zero
  {
    float mx = __int_as_float(0xff800000u);  // -inf
    for (int s = tid; s < S; s += CONSUMERS) mx = fmaxf(mx, p_s[s]);
    mx = block_reduce<true>(mx, red);
    float sum = 0.f;
    for (int s = tid; s < S; s += CONSUMERS) {
      const float e = expf(p_s[s] - mx);
      p_s[s] = e;
      sum += e;
    }
    sum = block_reduce<false>(sum, red);
    const float rs = attend_grouped::rcp_newton(sum);
    float psum = 0.f, msum = 0.f;
    for (int s = tid; s < S; s += CONSUMERS) {
      const float mk = mask_s[s];
      const float pk = mma_attn::div_row(p_s[s], sum, rs) * mk;
      p_s[s] = pk;
      psum += pk;
      msum += mk;
    }
    psum = block_reduce<false>(psum, red);
    msum = block_reduce<false>(msum, red);
    const float denom = fmaxf(psum, 1e-9f), scale = fminf(msum, 1.0f);
    const float rden = attend_grouped::rcp_newton(denom);
    for (int s = tid; s < S; s += CONSUMERS) {
      const float w = mma_attn::div_row(p_s[s], denom, rden) * scale;
      weights[n * S + s] = w;
      p_s[s] = bf_round(w);
    }
    consumers_sync();
  }
  // row: softmax done

  // 4. the context of each value chunk as it lands (the key chunks again
  // where the row is resident): a thread per 8-channel chunk and a slice of
  // the keys, keys of weight exactly 0 left out
  {
    const int C = Dv / 8, csl = CONSUMERS / C, c = tid % C, cs = tid / C;
    float acc[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[j] = 0.f;
    const int nc = stream ? L.nv : L.nk, per = stream ? L.vc : L.kc;
    for (int i = 0; i < nc; ++i) {
      const int g = stream ? L.nk + i : i;
      wait(g);
      const int s0 = i * per, s1 = min(S, s0 + per);
      const unsigned char* slot = ring + (size_t)(g % SLOTS) * SLOT;
      if (cs < csl) {
        // this slice's first key of the chunk: s = cs (mod csl)
        for (int s = s0 + ((cs - s0 % csl) + csl) % csl; s < s1; s += csl) {
          const float pw = p_s[s];
          if (pw == 0.f) continue;
          const uint4 u = reinterpret_cast<const uint4*>(slot + (size_t)(s - s0) * vb)[c];
          acc[0] = fmaf(pw, bf_lo(u.x), acc[0]);
          acc[1] = fmaf(pw, bf_hi(u.x), acc[1]);
          acc[2] = fmaf(pw, bf_lo(u.y), acc[2]);
          acc[3] = fmaf(pw, bf_hi(u.y), acc[3]);
          acc[4] = fmaf(pw, bf_lo(u.z), acc[4]);
          acc[5] = fmaf(pw, bf_hi(u.z), acc[5]);
          acc[6] = fmaf(pw, bf_lo(u.w), acc[6]);
          acc[7] = fmaf(pw, bf_hi(u.w), acc[7]);
        }
      }
      release(g);
    }
    // row: context chunks read
    // every chunk is in and read: the ring holds the slices' partial sums
    consumers_sync();
    float* cpart = reinterpret_cast<float*>(ring);
    if (cs < csl) {
      *reinterpret_cast<float4*>(cpart + (size_t)cs * Dv + 8 * c) =
          make_float4(acc[0], acc[1], acc[2], acc[3]);
      *reinterpret_cast<float4*>(cpart + (size_t)cs * Dv + 8 * c + 4) =
          make_float4(acc[4], acc[5], acc[6], acc[7]);
    }
    consumers_sync();
    for (int d = tid; d < Dv; d += CONSUMERS) {
      float x = 0.f;
      for (int j = 0; j < csl; ++j) x += cpart[(size_t)j * Dv + d];
      ctx[n * Dv + d] = x;
    }
  }
  // row: context done
}

}  // namespace attend_row
}  // namespace

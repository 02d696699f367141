// K10: the RNN decoder's attention read at every decode step, with the
// additive (Bahdanau) or the dot (Luong) score.  Replaces
// avsr_tpu/ops/attention.py:attend (Bahdanau branch :140-151, Luong branch
// :152-163, masking :165-171) as avsr_tpu/models/decoder.py:decoder_step
// (:160-164) calls it: query [N, Hq] fp32 (the top LSTM layer's h) over a
// memory of B rows, N = B W (W beams an utterance, 1 outside the beam
// search), query row n reading memory row n / W as the reference reads its
// beam-tiled copy: keys [B, S, A] (fp32 projected keys, or the bf16 memory
// for Luong, A its width), values [B, S, Dv] bf16, bias and mask [B, S]
// fp32 -> context [N, Dv] fp32 and weights [N, S] fp32.  The arithmetic
// and its rounding points are those of bahdanau_core.cuh.  Three kernels,
// chosen by shape alone (kernels.attend_route):
//
// * "grouped" (attend_grouped.cuh), a beam step's read (2 <= W <= 16 at
//   widths that are multiples of 16): a cluster of CTAs per memory row,
//   each key and value row read once for the W queries.  At N = 80 beams
//   (B = 8, W = 10), S = 197, A = 128, Dv = 768 the untiled memory is 0.8 MB
//   of keys and 2.4 MB of values a step (~1.0 us at 3.35 TB/s; tiled over
//   the beams it would be 32 MB); Luong's 512-wide memory, one tensor, 1.6 MB.
// * "row" (attend_row.cuh), one query row a memory row (W = 1: greedy and
//   the teacher-forced loop's forward) at widths that are multiples of 16:
//   a CTA of 512 threads a row, the memory row streamed through a ring of
//   bulk-copied chunks in shared memory from the kernel's first cycle, q
//   formed while it streams.  At N = 128, S = 197 the row is 403 KB (Luong
//   202 KB, read once), 51.6 MB a step (25.8 MB).
// * "general" (bahdanau_attend_kernel), every other shape (widths that are
//   not multiples of 16; more than 16 beams): one block of 256 threads per
//   query row, the q product inside it (bahdanau_core.cuh's read), the keys
//   and values of row n / W.
//
// Backward: the teacher-forced decoder's K reads of one memory form a loop
// (avsr_tpu/models/decoder.py:267-295 differentiates attend inside a
// jax.checkpoint'ed lax.scan over the K label positions, the memory closed
// over and its cotangent summed over the steps).  Each step's term of the
// memory's gradients depends on the step only through row vectors its
// backward forms anyway:
//
//   dw[s]  = bf16(sum_d dctx[d] * bf16(values[s, d]))
//   dsc[s] = w[s] * (dw[s] - sum_j w[j] dw[j])
//            (the softmax backward through the mask and the renormalisation:
//            a valid row's w is its softmax with padded positions exactly 0,
//            an empty row's w is 0, so its gradients are 0, not NaN)
//   additive: e = tanh(keys[s, a] + q[a]);  deb = bf16(dsc[s] * bf16(v[a]))
//     dq[a] = sum_s (deb + deb * e) * (1 - e)   (tanh' as JAX takes it)
//     dv[a] = sum_s dsc[s] bf16(e)
//   dot (q here bf16(q), keys bf16): dq[a] = bf16(sum_s dsc[s] keys[s, a])
//   dquery[k] = bf16(sum_a dq[a] * wq[k, a])
//   dvalues = sum_k bf16(w[k])^T (x) dctx[k];  dot dkeys = sum_k dsc[k]^T (x) q[k]
//   additive dkeys = sum_k (deb + deb * e) * (1 - e) with q[k]
//
// (the bf16 roundings are the transposes of the reference's casts; dq and
// dv are the row's factors of the weight gradients, which the caller forms
// as one product over the steps).  So the per-step kernel
// (attend_step_bwd_kernel) writes dquery, which the LSTM step's backward
// needs at once, and the step's rows dsc, dctx, q, dq and dv of buffers
// [K, N, *] that the loop keeps; it never touches a memory-sized gradient.
// Once after the loop, the sums of av_align_bwd.cuh (align_outer_sum:
// dvalues, Luong's dkeys, on the tensor cores; align_dkeys_energy:
// Bahdanau's dkeys), reached through av_align_scan.cu's
// avsr_av_align_bwd_sums, write dkeys and dvalues once; at widths those do
// not take (A or Dv not a multiple of 64) attend_loop_sums_kernel here, on
// the CUDA cores.
//
// Per-step design: a cluster of CS = 2 CTAs per row, CTA r owning the r-th
// half of the row's keys, of q's columns, of dquery's units and of the
// saved rows (two measured fastest for the Bahdanau read on an H100 and
// within 3% of one for Luong's; four and eight slower for both: PERF.md).  q: each CTA its columns (bahdanau_core.cuh's q_partials on a
// column slice), broadcast into every CTA's shared memory
// (st.shared::cluster); dw over the CTA's keys (a warp per key, a lane per
// 8 channels); the softmax backward's sum(w dw) as one partial a CTA,
// exchanged and summed in rank order; dq (and dv) the same way, A partials
// a CTA; dquery over the CTA's units from the full dq.  Every CTA sums the
// partials in the same order, so every run gives the same bits; a cluster
// barrier (release / acquire) after each exchange.  A key of weight
// exactly 0 is skipped and adds exactly 0.  Bound on an H100: the row's
// keys (fp32, or bf16 for the dot score) and values (bf16) read once, and
// wq: at N = 128, S = 197, A = 128, Dv = 768, 12.9 + 38.7 MB a step (15.4
// us at 3.35 TB/s; the 80 steps of a loop reread them, L2-resident only in
// part); Luong at Hk = Dv = 512 one 25.8 MB memory read once.  The
// cluster splits a row's 400 KB stream over two SMs' load queues (one CTA
// a row is 128 CTAs on 132 SMs).

// The fp32 policy (train.compute_dtype = "float32"; avsr_bahdanau_attend_f32,
// avsr_attend_step_bwd_f32, avsr_attend_loop_sums_f32, counted as
// bahdanau_attend_f32[_bwd, _sums]): the general kernel, the per-step
// backward and the CUDA-core loop sums are templated on the element type E
// of wq, v and the values (bahdanau_core.cuh's Elem): fp32 operands, every
// bf16 rounding point above the identity, the products fp32 FMAs.  Every
// fp32 read takes the general kernel (kernels.attend_route routes by
// dtype: the grouped and row reads stage bf16 tiles for the tensor cores
// and the bulk copies), every fp32 loop the CUDA-core sums.  Bahdanau's
// score only: the Luong reads' fp32 instance is still to be ported.  What
// bounds them on an H100: the bytes of the memory rows, the values now in
// fp32 (4.8 MB of values and 0.8 MB of keys a beam step at B = 8, S = 197,
// A = 128, Dv = 768, 1.7 us at 3.35 TB/s; the general kernel reads a
// memory row once per query row, so a width-10 beam step streams 56 MB,
// mostly from L2), and the dependent reductions of a block a row.

#include <algorithm>

#include "attend_grouped.cuh"
#include "attend_row.cuh"
#include "bahdanau_core.cuh"
#include "cluster_ptx.cuh"

namespace {

using bahdanau::Elem;
using bahdanau::Key;

struct RowWeights {
  float* w;
  __device__ void operator()(int s, float x) const { w[s] = x; }
};

struct RowContext {
  float* ctx;
  __device__ void operator()(int d, float x) const { ctx[d] = x; }
};

template <bool DOT, typename E>
__global__ void __launch_bounds__(bahdanau::THREADS)
bahdanau_attend_kernel(const float* __restrict__ query,          // [N, Hq]
                       const E* __restrict__ wq,                 // [Hq, A]
                       const E* __restrict__ vatt,               // [A] or null (dot)
                       const void* __restrict__ keys_in,         // [B, S, A] Key<DOT>
                       const E* __restrict__ values,             // [B, S, Dv]
                       const float* __restrict__ bias,           // [B, S]
                       const float* __restrict__ mask,           // [B, S]
                       float* __restrict__ ctx,                  // [N, Dv]
                       float* __restrict__ weights,              // [N, S]
                       int W, int Hq, int A, int S, int Dv) {
  extern __shared__ __align__(16) float smem[];
  const auto* keys = static_cast<const typename Key<DOT>::type*>(keys_in);
  const size_t n = blockIdx.x, m = n / W;  // query row n reads memory row n / W
  bahdanau::read<DOT>(query + n * Hq, wq, vatt, keys + m * S * A, values + m * S * Dv,
                      bias + m * S, mask + m * S, Hq, A, S, Dv, smem,
                      RowWeights{weights + n * S}, RowContext{ctx + n * Dv});
}

// ---- the per-step backward -------------------------------------------------

using bahdanau::bf_hi;
using bahdanau::bf_lo;
using bahdanau::bf_round;
using bahdanau::KPW;
using bahdanau::LOADS;
using bahdanau::THREADS;
using bahdanau::WARPS;

constexpr int CS = 2;  // CTAs a row of the per-step backward

// a store into the shared memory of cluster CTA `rank` (addr a mapa address)
__device__ __forceinline__ void st_peer(uint32_t addr, float v) {
  asm volatile("st.shared::cluster.f32 [%0], %1;\n" ::"r"(addr), "f"(v) : "memory");
}

// x into the same shared-memory word of every CTA of the cluster
__device__ __forceinline__ void to_all(float* p, float x) {
  const uint32_t a = cluster_ptx::smem_addr(p);
#pragma unroll
  for (int r = 0; r < CS; ++r) st_peer(cluster_ptx::map_rank(a, r), x);
}

// the cluster's barrier: its stores into peers' shared memory visible after it
__device__ __forceinline__ void cluster_sync() {
  cluster_ptx::cluster_arrive();
  cluster_ptx::cluster_wait();
}

// The shared memory of one CTA, in floats: q [A] (then dq), v [A], dctx
// [Dv], the bf16-rounded query [Hq], dw then dsc of the CTA's keys [Sc],
// the g exchange [CS], the reduction slots, the partial sums [8 THREADS],
// and the dq and dv exchanges [CS][A] each.
struct StepLayout {
  int q, v, dctx, qin, dsc, gx, red, part, dqx, dvx, total;
  __host__ __device__ StepLayout(int Hq, int A, int S, int Dv) {
    int o = 0;
    q = o;    o += A;
    v = o;    o += A;
    dctx = o; o += Dv;
    qin = o;  o += Hq;
    dsc = o;  o += (S + CS - 1) / CS;
    gx = o;   o += CS;
    red = o;  o += WARPS;
    o = (o + 3) & ~3;
    part = o; o += 8 * THREADS;
    dqx = o;  o += CS * A;
    dvx = o;  o += CS * A;
    total = o;
  }
};

// One row's read backward, split over a cluster of CS CTAs (row n = the
// cluster's index; CTA r owns the r-th slice of the keys, of q's columns,
// of dquery's units and of the saved rows), without the memory's
// gradients.  Writes dquery [N, Hq] and this step's rows of the loop's
// buffers: dsc [N, S], dctx [N, Dv], q [N, A] (bf16(q) for the dot score),
// dq [N, A], dv [N, A] (additive only).
template <bool DOT, typename E>
__global__ void __launch_bounds__(THREADS)
attend_step_bwd_kernel(const float* __restrict__ query,           // [N, Hq]
                       const E* __restrict__ wq,                  // [Hq, A]
                       const E* __restrict__ vatt,                // [A] or null (dot)
                       const void* __restrict__ keys_in,          // [N, S, A] Key<DOT>
                       const E* __restrict__ values,              // [N, S, Dv]
                       const float* __restrict__ weights,         // [N, S]
                       const float* __restrict__ dctx,            // [N, Dv]
                       float* __restrict__ dquery,                // [N, Hq]
                       float* __restrict__ dsc_out,               // [N, S]
                       float* __restrict__ dctx_out,              // [N, Dv]
                       float* __restrict__ q_out,                 // [N, A]
                       float* __restrict__ dq_out,                // [N, A]
                       float* __restrict__ dv_out,                // [N, A] or null (dot)
                       int Hq, int A, int S, int Dv) {
  using X = Elem<E>;
  static_assert(!DOT || sizeof(E) == 2, "the dot score's fp32 read is still to be ported");
  extern __shared__ __align__(16) float smem[];
  const StepLayout L(Hq, A, S, Dv);
  float* q_s = smem + L.q;
  float* v_s = smem + L.v;
  float* dctx_s = smem + L.dctx;
  float* qin = smem + L.qin;
  float* dsc_s = smem + L.dsc;
  float* gx = smem + L.gx;
  float* red = smem + L.red;
  float* part = smem + L.part;
  float* dqx = smem + L.dqx;
  float* dvx = smem + L.dvx;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rank = (int)cluster_ptx::cluster_rank();
  const size_t n = blockIdx.x / CS;
  const auto* keys = static_cast<const typename Key<DOT>::type*>(keys_in) + n * S * A;
  values += n * S * Dv;
  weights += n * S;
  // this CTA's slices: keys [s_lo, s_hi), q's column pairs [p_lo, p_hi),
  // dquery's units [k_lo, k_hi), the saved rows' channels
  const int Sc = (S + CS - 1) / CS, s_lo = min(S, rank * Sc), s_hi = min(S, s_lo + Sc);
  const int P = A / 2, Pc = (P + CS - 1) / CS, p_lo = min(P, rank * Pc),
            p_hi = min(P, p_lo + Pc);
  const int Hc = (Hq + CS - 1) / CS, k_lo = min(Hq, rank * Hc), k_hi = min(Hq, k_lo + Hc);
  const int Dc = (Dv + CS - 1) / CS, d_lo = min(Dv, rank * Dc), d_hi = min(Dv, d_lo + Dc);
  // the peers' shared memory is written only once every CTA has started
  cluster_ptx::cluster_arrive();

  for (int i = tid; i < Hq; i += THREADS) qin[i] = X::round(query[n * Hq + i]);
  if (!DOT)
    for (int i = tid; i < A; i += THREADS) v_s[i] = X::get(vatt[i]);
  for (int d = tid; d < Dv; d += THREADS) {
    const float x = dctx[n * Dv + d];
    dctx_s[d] = x;
    if (d >= d_lo && d < d_hi) dctx_out[n * Dv + d] = x;
  }
  __syncthreads();

  // q, this CTA's columns (2 LOADS rows of wq in flight: at Luong's 512
  // columns a thread walks 128 rows), the slices summed in a fixed order
  const int qsl = bahdanau::q_partials<2 * LOADS>(qin, wq, Hq, A, p_lo, p_hi, part);
  __syncthreads();
  cluster_ptx::cluster_wait();
  for (int j = tid; j < 2 * (p_hi - p_lo); j += THREADS) {
    float x = 0.f;
    for (int sl = 0; sl < qsl; ++sl) x += part[sl * 2 * (p_hi - p_lo) + j];
    if (DOT) x = bf_round(x);  // the dot score's cast of q
    const int a = 2 * p_lo + j;
    to_all(q_s + a, x);
    q_out[n * A + a] = x;
  }
  cluster_sync();

  // dw of this CTA's keys: a warp per key (KW keys in flight), a lane per
  // 8-channel chunk of the value row; keys of weight exactly 0 skipped
  {
    constexpr int KW = 2 * KPW;
    const int C = Dv / 8;
    const float4* dc4 = reinterpret_cast<const float4*>(dctx_s);
    for (int s0 = s_lo + warp * KW; s0 < s_hi; s0 += WARPS * KW) {
      float acc[KW], wb[KW];
#pragma unroll
      for (int j = 0; j < KW; ++j) {
        acc[j] = 0.f;
        wb[j] = s0 + j < s_hi ? weights[s0 + j] : 0.f;
      }
      for (int c = lane; c < C; c += 32) {
        const float4 g0 = dc4[2 * c], g1 = dc4[2 * c + 1];
        const float g[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
        typename X::Chunk u[KW];
#pragma unroll
        for (int j = 0; j < KW; ++j)
          u[j] = wb[j] != 0.f ? X::load8(values + (size_t)(s0 + j) * Dv, c) : X::zero8();
#pragma unroll
        for (int j = 0; j < KW; ++j) {
          if (wb[j] == 0.f) continue;  // uniform over the warp: one key
#pragma unroll
          for (int i = 0; i < 8; ++i) acc[j] = fmaf(g[i], X::at(u[j], i), acc[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < KW; ++j) {
        float a = acc[j];
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) a += __shfl_xor_sync(0xffffffffu, a, o);
        if (lane == 0 && s0 + j < s_hi) dsc_s[s0 + j - s_lo] = X::round(a);
      }
    }
    __syncthreads();
  }

  // g = sum_s w dw: this CTA's part to every CTA, summed there in rank order
  {
    float gp = 0.f;
    for (int s = s_lo + tid; s < s_hi; s += THREADS) gp += weights[s] * dsc_s[s - s_lo];
    gp = bahdanau::block_reduce<false>(gp, red);
    if (tid < CS) st_peer(cluster_ptx::map_rank(cluster_ptx::smem_addr(gx + rank), tid), gp);
  }
  cluster_sync();
  float g = 0.f;
#pragma unroll
  for (int p = 0; p < CS; ++p) g += gx[p];
  // dsc = w (dw - g), exactly 0 where w is
  for (int s = s_lo + tid; s < s_hi; s += THREADS) {
    const float w = weights[s];
    const float d = w == 0.f ? 0.f : w * (dsc_s[s - s_lo] - g);
    dsc_s[s - s_lo] = d;
    dsc_out[n * S + s] = d;
  }
  __syncthreads();

  // the keys' pass over this CTA's keys: dq (and dv) partials, a thread per
  // UW key units (the dot score's bf16 keys 8, the additive score's fp32
  // keys 4), the keys over THREADS / (A/UW) slices (KB in flight)
  constexpr int UW = DOT ? 8 : 4, KB = 8;
  const int AU = A / UW, ksl = THREADS / AU;
  {
    const int c = tid % AU, sl = tid / AU;
    float dq[UW], dv[UW];
#pragma unroll
    for (int i = 0; i < UW; ++i) dq[i] = dv[i] = 0.f;
    if (sl < ksl) {
      if constexpr (DOT) {
        const uint4* k8 = reinterpret_cast<const uint4*>(keys) + c;
        for (int s0 = s_lo + sl; s0 < s_hi; s0 += KB * ksl) {
          float d[KB];
          uint4 kk[KB];
#pragma unroll
          for (int j = 0; j < KB; ++j) {
            const int s = s0 + j * ksl;
            d[j] = s < s_hi ? dsc_s[s - s_lo] : 0.f;
            kk[j] = d[j] != 0.f ? k8[(size_t)s * AU] : make_uint4(0u, 0u, 0u, 0u);
          }
#pragma unroll
          for (int j = 0; j < KB; ++j) {
            if (d[j] == 0.f) continue;
            const uint32_t kw[4] = {kk[j].x, kk[j].y, kk[j].z, kk[j].w};
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              dq[2 * i] = fmaf(d[j], bf_lo(kw[i]), dq[2 * i]);
              dq[2 * i + 1] = fmaf(d[j], bf_hi(kw[i]), dq[2 * i + 1]);
            }
          }
        }
      } else {
        const float4 qq = reinterpret_cast<const float4*>(q_s)[c];
        const float4 vv = reinterpret_cast<const float4*>(v_s)[c];
        const float qx[4] = {qq.x, qq.y, qq.z, qq.w};
        const float vx[4] = {vv.x, vv.y, vv.z, vv.w};
        const float4* k4 = reinterpret_cast<const float4*>(keys) + c;
        for (int s0 = s_lo + sl; s0 < s_hi; s0 += KB * ksl) {
          float d[KB];
          float4 kk[KB];
#pragma unroll
          for (int j = 0; j < KB; ++j) {
            const int s = s0 + j * ksl;
            d[j] = s < s_hi ? dsc_s[s - s_lo] : 0.f;
            kk[j] = d[j] != 0.f ? k4[(size_t)s * AU] : make_float4(0.f, 0.f, 0.f, 0.f);
          }
#pragma unroll
          for (int j = 0; j < KB; ++j) {
            if (d[j] == 0.f) continue;
            const float kx[4] = {kk[j].x, kk[j].y, kk[j].z, kk[j].w};
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const float e = tanhf(kx[i] + qx[i]);
              const float deb = X::round(d[j] * vx[i]);
              dq[i] += (deb + deb * e) * (1.0f - e);  // tanh' as JAX takes it
              dv[i] = fmaf(d[j], X::round(e), dv[i]);
            }
          }
        }
      }
#pragma unroll
      for (int i = 0; i < UW; ++i) {
        part[sl * A + UW * c + i] = dq[i];
        if (!DOT) part[(ksl + sl) * A + UW * c + i] = dv[i];
      }
    }
  }
  __syncthreads();
  // this CTA's sums over its keys into row `rank` of every CTA's exchange
  for (int a = tid; a < A; a += THREADS) {
    float x = 0.f, y = 0.f;
    for (int j = 0; j < ksl; ++j) {
      x += part[j * A + a];
      if (!DOT) y += part[(ksl + j) * A + a];
    }
    to_all(dqx + rank * A + a, x);
    if (!DOT) to_all(dvx + rank * A + a, y);
  }
  cluster_sync();
  // dq (and dv): the CTAs' sums in rank order, the same bits in every CTA
  for (int a = tid; a < A; a += THREADS) {
    float x = 0.f, y = 0.f;
#pragma unroll
    for (int p = 0; p < CS; ++p) {
      x += dqx[p * A + a];
      if (!DOT) y += dvx[p * A + a];
    }
    if (DOT) x = bf_round(x);  // the cotangent of the dot score's cast of q
    q_s[a] = x;                // q is no longer needed: dq
    if (a >= 2 * p_lo && a < 2 * p_hi) {
      dq_out[n * A + a] = x;
      if (!DOT) dv_out[n * A + a] = y;
    }
  }
  __syncthreads();

  // dquery = bf16(dq @ wq^T), this CTA's units: a warp per KQ units at a
  // time (their rows of wq in flight together), a lane per 8-unit chunk
  constexpr int KQ = 8;
  for (int k0 = k_lo + warp * KQ; k0 < k_hi; k0 += WARPS * KQ) {
    float acc[KQ];
#pragma unroll
    for (int j = 0; j < KQ; ++j) acc[j] = 0.f;
    for (int c8 = lane; c8 < A / 8; c8 += 32) {
      typename X::Chunk u[KQ];
#pragma unroll
      for (int j = 0; j < KQ; ++j)
        u[j] = k0 + j < k_hi ? X::load8(wq + (size_t)(k0 + j) * A, c8) : X::zero8();
      const float4 ga = reinterpret_cast<const float4*>(q_s)[2 * c8];
      const float4 gb = reinterpret_cast<const float4*>(q_s)[2 * c8 + 1];
      const float g[8] = {ga.x, ga.y, ga.z, ga.w, gb.x, gb.y, gb.z, gb.w};
#pragma unroll
      for (int j = 0; j < KQ; ++j) {
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[j] = fmaf(g[i], X::at(u[j], i), acc[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < KQ; ++j) {
      float a = acc[j];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) a += __shfl_xor_sync(0xffffffffu, a, o);
      if (lane == 0 && k0 + j < k_hi) dquery[n * Hq + k0 + j] = X::round(a);
    }
  }
}

// ---- the memory's gradients after a loop, at widths the tensor-core sums
// of av_align_bwd.cuh do not take (A or Dv not a multiple of 64) ----------

// A thread per output element (dvalues' [N, S, Dv], then dkeys' [N, S, A]),
// the K steps in order: dvalues = sum_k bf16(w[k]) dctx[k]; dot dkeys = sum_k
// dsc[k] q[k]; additive dkeys = sum_k (deb + deb e)(1 - e).  Steps of
// weight or dsc exactly 0 add nothing.
template <bool DOT, typename E>
__global__ void __launch_bounds__(256)
attend_loop_sums_kernel(const float* __restrict__ keys,            // [N, S, A] (additive)
                        const E* __restrict__ vatt,                // [A] or null (dot)
                        const float* __restrict__ weights,         // [K, N, S]
                        const float* __restrict__ q,               // [K, N, A]
                        const float* __restrict__ dsc,             // [K, N, S]
                        const float* __restrict__ dctx,            // [K, N, Dv]
                        float* __restrict__ dkeys,                 // [N, S, A]
                        float* __restrict__ dvalues,               // [N, S, Dv]
                        int K, int N, int S, int A, int Dv) {
  const size_t nv = (size_t)N * S * Dv, total = nv + (size_t)N * S * A;
  const size_t NS = (size_t)N * S;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    float acc = 0.f;
    if (i < nv) {
      const size_t d = i % Dv, ns = i / Dv, n = ns / S;
      for (int k = 0; k < K; ++k) {
        const float w = Elem<E>::round(weights[k * NS + ns]);
        if (w != 0.f) acc = fmaf(w, dctx[((size_t)k * N + n) * Dv + d], acc);
      }
      dvalues[i] = acc;
    } else {
      const size_t j = i - nv, a = j % A, ns = j / A, n = ns / S;
      if constexpr (DOT) {
        for (int k = 0; k < K; ++k) {
          const float d = dsc[k * NS + ns];
          if (d != 0.f) acc = fmaf(d, q[((size_t)k * N + n) * A + a], acc);
        }
      } else {
        const float key = keys[j], v = Elem<E>::get(vatt[a]);
        for (int k = 0; k < K; ++k) {
          const float d = dsc[k * NS + ns];
          if (d == 0.f) continue;
          const float e = tanhf(key + q[((size_t)k * N + n) * A + a]);
          const float deb = Elem<E>::round(d * v);
          acc += (deb + deb * e) * (1.0f - e);
        }
      }
      dkeys[j] = acc;
    }
  }
}
}  // namespace

extern "C" long long avsr_bahdanau_smem(int Hq, int A, int S) {
  return (long long)bahdanau::read_smem_bytes(Hq, A, S);
}

// "general": N query rows over N / W memory rows, a block a query row.  dot
// != 0: the Luong read (keys bf16, vatt null); else the Bahdanau read (keys
// fp32).
namespace {

template <bool DOT, typename E>
int general_launch(const void* query, const void* wq, const void* vatt, const void* keys,
                   const void* values, const void* bias, const void* mask, void* ctx,
                   void* weights, int N, int W, int Hq, int A, int S, int Dv, void* stream) {
  if (N < 1 || W < 1 || N % W || S < 1 || Hq < 1 || A % 8 || A > 512 || Dv % 8 || Dv > 2048 ||
      (!DOT && vatt == nullptr))
    return (int)cudaErrorInvalidValue;
  auto* const kernel = &bahdanau_attend_kernel<DOT, E>;
  const size_t smem = bahdanau::read_smem_bytes(Hq, A, S);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<N, bahdanau::THREADS, smem, reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(query), static_cast<const E*>(wq), static_cast<const E*>(vatt),
      keys, static_cast<const E*>(values), static_cast<const float*>(bias),
      static_cast<const float*>(mask), static_cast<float*>(ctx), static_cast<float*>(weights),
      W, Hq, A, S, Dv);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int avsr_bahdanau_attend(const void* query, const void* wq, const void* vatt,
                                    const void* keys, const void* values, const void* bias,
                                    const void* mask, void* ctx, void* weights, int N, int W,
                                    int Hq, int A, int S, int Dv, int dot, void* stream) {
  auto* const launch = dot ? &general_launch<true, __nv_bfloat16>
                           : &general_launch<false, __nv_bfloat16>;
  return launch(query, wq, vatt, keys, values, bias, mask, ctx, weights, N, W, Hq, A, S, Dv,
                stream);
}

// The fp32 policy's general kernel (the Bahdanau read): wq [Hq, A], vatt [A]
// and values [B, S, Dv] fp32, the rest as above.
extern "C" int avsr_bahdanau_attend_f32(const void* query, const void* wq, const void* vatt,
                                        const void* keys, const void* values, const void* bias,
                                        const void* mask, void* ctx, void* weights, int N, int W,
                                        int Hq, int A, int S, int Dv, void* stream) {
  return general_launch<false, float>(query, wq, vatt, keys, values, bias, mask, ctx, weights,
                                      N, W, Hq, A, S, Dv, stream);
}

namespace {

bool row_shape_ok(int Hq, int A, int S, int Dv, bool dot) {
  return S >= 1 && S <= attend_row::MAX_S && Hq >= 16 && Hq % 16 == 0 &&
         Hq <= attend_row::MAX_HQ && A >= 16 && A % 16 == 0 && A <= 512 && Dv >= 16 &&
         Dv % 16 == 0 && Dv <= 2048 &&
         attend_row::Layout(Hq, A, S, Dv, dot, false).total <= 232448;
}

}  // namespace

// The row read's shared memory per CTA in bytes (attend_row.cuh's Layout;
// kernels.attend_row_smem mirrors it), or -1 for a shape it does not take.
extern "C" long long avsr_attend_row_smem(int Hq, int A, int S, int Dv, int dot) {
  if (!row_shape_ok(Hq, A, S, Dv, dot != 0)) return -1;
  return (long long)attend_row::Layout(Hq, A, S, Dv, dot != 0, false).total;
}

namespace {

// N / C clusters of C CTAs (consecutive query rows; C = 2 where N is even,
// else 1), the row read's shared memory set
template <bool DOT>
cudaError_t row_config(int N, int C, size_t smem, cudaLaunchAttribute* attr,
                       cudaLaunchConfig_t* cfg) {
  *cfg = {};
  cfg->gridDim = dim3(N, 1, 1);
  cfg->blockDim = dim3(attend_row::THREADS, 1, 1);
  cfg->dynamicSmemBytes = smem;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaFuncSetAttribute(attend_row::attend_row_kernel<DOT>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <bool DOT>
cudaError_t row_launch(const void* query, const void* wq, const void* vatt, const void* keys,
                       const void* values, const void* bias, const void* mask, void* ctx,
                       void* weights, int N, int W, int Hq, int A, int S, int Dv,
                       cudaStream_t st) {
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg;
  const size_t smem = attend_row::Layout(Hq, A, S, Dv, DOT, false).total;
  cudaError_t e = row_config<DOT>(N, N % 2 == 0 ? 2 : 1, smem, attr, &cfg);
  if (e != cudaSuccess) return e;
  cfg.stream = st;
  using bf = __nv_bfloat16;
  e = cudaLaunchKernelEx(&cfg, attend_row::attend_row_kernel<DOT>,
                         static_cast<const float*>(query), static_cast<const bf*>(wq),
                         static_cast<const bf*>(vatt), keys, static_cast<const bf*>(values),
                         static_cast<const float*>(bias), static_cast<const float*>(mask),
                         static_cast<float*>(ctx), static_cast<float*>(weights), W, Hq, A, S,
                         Dv);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <bool DOT>
int row_max_active(int Hq, int A, int S, int Dv) {
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg;
  const size_t smem = attend_row::Layout(Hq, A, S, Dv, DOT, false).total;
  if (row_config<DOT>(264, 2, smem, attr, &cfg) != cudaSuccess) return 0;
  int n = 0;
  return cudaOccupancyMaxActiveClusters(&n, (void*)attend_row::attend_row_kernel<DOT>, &cfg) ==
                 cudaSuccess
             ? n
             : 0;
}

}  // namespace

// The row read's clusters of two CTAs (two query rows) that can be resident
// at once (0 on an error or a shape it does not take).
extern "C" int avsr_attend_row_max_active(int Hq, int A, int S, int Dv, int dot) {
  if (!row_shape_ok(Hq, A, S, Dv, dot != 0)) return 0;
  return dot ? row_max_active<true>(Hq, A, S, Dv) : row_max_active<false>(Hq, A, S, Dv);
}

// "row": N query rows over N / W memory rows, a CTA of 512 threads and a
// producer warp a query row, the memory row streamed through shared memory,
// q formed by clusters of two CTAs (one where N is odd) (dot != 0: Luong,
// keys bf16, vatt null; keys == values: the row read once where it fits).
extern "C" int avsr_attend_row(const void* query, const void* wq, const void* vatt,
                               const void* keys, const void* values, const void* bias,
                               const void* mask, void* ctx, void* weights, int N, int W, int Hq,
                               int A, int S, int Dv, int dot, void* stream) {
  if (N < 1 || W < 1 || N % W || !row_shape_ok(Hq, A, S, Dv, dot != 0) ||
      (!dot && vatt == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  auto* const launch = dot ? &row_launch<true> : &row_launch<false>;
  return (int)launch(query, wq, vatt, keys, values, bias, mask, ctx, weights, N, W, Hq, A, S, Dv,
                     st);
}

namespace {

bool grouped_shape_ok(int B, int W, int Hq, int A, int S, int Dv, int C) {
  return B >= 1 && W >= 1 && W <= attend_grouped::MAX_W && S >= 1 && S <= attend_grouped::MAX_S &&
         Hq >= 16 && Hq % 16 == 0 &&
         A >= 16 && A % 16 == 0 && A <= 512 && Dv >= 16 && Dv % 16 == 0 && Dv <= 2048 &&
         (C == 1 || C == 2 || C == 4 || C == 8 || C == 16);
}

// B clusters of C CTAs (one a memory row), the kernel's shared memory set
template <bool DOT>
cudaError_t grouped_config(int B, int C, size_t smem, cudaLaunchAttribute* attr,
                           cudaLaunchConfig_t* cfg) {
  *cfg = {};
  cfg->gridDim = dim3(B * C, 1, 1);
  cfg->blockDim = dim3(attend_grouped::THREADS, 1, 1);
  cfg->dynamicSmemBytes = smem;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  auto* const kernel = attend_grouped::attend_grouped_kernel<DOT>;
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess && C > 8)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return e;
}

template <bool DOT>
cudaError_t grouped_launch(const void* query, const void* wq, const void* vatt, const void* keys,
                           const void* values, const void* bias, const void* mask, void* ctx,
                           void* weights, int B, int W, int Hq, int A, int S, int Dv, int C,
                           cudaStream_t st) {
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg;
  const size_t smem = attend_grouped::Layout(W, S, Hq, A, Dv, C, DOT).total;
  cudaError_t e = grouped_config<DOT>(B, C, smem, attr, &cfg);
  if (e != cudaSuccess) return e;
  cfg.stream = st;
  using bf = __nv_bfloat16;
  e = cudaLaunchKernelEx(&cfg, attend_grouped::attend_grouped_kernel<DOT>,
                         static_cast<const float*>(query), static_cast<const bf*>(wq),
                         static_cast<const bf*>(vatt), keys, static_cast<const bf*>(values),
                         static_cast<const float*>(bias), static_cast<const float*>(mask),
                         static_cast<float*>(ctx), static_cast<float*>(weights), W, Hq, A, S,
                         Dv);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <bool DOT>
int grouped_max_active(int W, int Hq, int A, int S, int Dv, int C) {
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg;
  const size_t smem = attend_grouped::Layout(W, S, Hq, A, Dv, C, DOT).total;
  if (grouped_config<DOT>(132, C, smem, attr, &cfg) != cudaSuccess) return 0;
  int n = 0;
  return cudaOccupancyMaxActiveClusters(&n, (void*)attend_grouped::attend_grouped_kernel<DOT>,
                                        &cfg) == cudaSuccess
             ? n
             : 0;
}

}  // namespace

// The grouped read's shared memory per CTA in bytes (attend_grouped.cuh's
// Layout; kernels.attend_grouped_smem mirrors it).
extern "C" long long avsr_attend_grouped_smem(int W, int S, int Hq, int A, int Dv, int C,
                                              int dot) {
  return (long long)attend_grouped::Layout(W, S, Hq, A, Dv, C, dot != 0).total;
}

// The clusters of C CTAs (a memory row each) that can be resident at once
// (0 on an error or a shape the kernel does not take).
extern "C" int avsr_attend_grouped_max_active(int W, int S, int Hq, int A, int Dv, int C,
                                              int dot) {
  if (!grouped_shape_ok(1, W, Hq, A, S, Dv, C)) return 0;
  return dot ? grouped_max_active<true>(W, Hq, A, S, Dv, C)
             : grouped_max_active<false>(W, Hq, A, S, Dv, C);
}

// "grouped": N = B W query rows over the untiled memory [B, S], a cluster of
// C CTAs per memory row (dot != 0: Luong, keys bf16, vatt null).
extern "C" int avsr_attend_grouped(const void* query, const void* wq, const void* vatt,
                                   const void* keys, const void* values, const void* bias,
                                   const void* mask, void* ctx, void* weights, int B, int W,
                                   int Hq, int A, int S, int Dv, int C, int dot, void* stream) {
  if (!grouped_shape_ok(B, W, Hq, A, S, Dv, C) || (!dot && vatt == nullptr) ||
      attend_grouped::Layout(W, S, Hq, A, Dv, C, dot != 0).total > 232448)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  auto* const launch = dot ? &grouped_launch<true> : &grouped_launch<false>;
  return (int)launch(query, wq, vatt, keys, values, bias, mask, ctx, weights, B, W, Hq, A, S, Dv,
                     C, st);
}

namespace {

constexpr size_t STEP_SMEM_LIMIT = 232448;  // bytes a block may use on an H100

bool step_shape_ok(int Hq, int A, int S, int Dv) {
  return S >= 1 && Hq >= 1 && A % 8 == 0 && A >= 8 && A <= 512 && Dv % 8 == 0 && Dv >= 8 &&
         Dv <= 2048 && (size_t)StepLayout(Hq, A, S, Dv).total * sizeof(float) <= STEP_SMEM_LIMIT;
}

size_t step_smem(int Hq, int A, int S, int Dv) {
  return (size_t)StepLayout(Hq, A, S, Dv).total * sizeof(float);
}

// N clusters of CS CTAs, the kernel's shared memory set
template <bool DOT, typename E>
cudaError_t step_config(int N, size_t smem, cudaLaunchAttribute* attr, cudaLaunchConfig_t* cfg) {
  *cfg = {};
  cfg->gridDim = dim3(N * CS, 1, 1);
  cfg->blockDim = dim3(THREADS, 1, 1);
  cfg->dynamicSmemBytes = smem;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CS;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaFuncSetAttribute(attend_step_bwd_kernel<DOT, E>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <bool DOT, typename E>
cudaError_t step_launch(const void* query, const void* wq, const void* vatt, const void* keys,
                        const void* values, const void* weights, const void* dctx, void* dquery,
                        void* dsc, void* dctx_out, void* q, void* dq, void* dv, int N, int Hq,
                        int A, int S, int Dv, cudaStream_t st) {
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg;
  cudaError_t e = step_config<DOT, E>(N, step_smem(Hq, A, S, Dv), attr, &cfg);
  if (e != cudaSuccess) return e;
  cfg.stream = st;
  e = cudaLaunchKernelEx(&cfg, attend_step_bwd_kernel<DOT, E>, static_cast<const float*>(query),
                         static_cast<const E*>(wq), static_cast<const E*>(vatt), keys,
                         static_cast<const E*>(values), static_cast<const float*>(weights),
                         static_cast<const float*>(dctx), static_cast<float*>(dquery),
                         static_cast<float*>(dsc), static_cast<float*>(dctx_out),
                         static_cast<float*>(q), static_cast<float*>(dq), static_cast<float*>(dv),
                         Hq, A, S, Dv);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <bool DOT>
int step_max_active(int Hq, int A, int S, int Dv) {
  using bf = __nv_bfloat16;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg;
  if (step_config<DOT, bf>(128, step_smem(Hq, A, S, Dv), attr, &cfg) != cudaSuccess) return 0;
  int n = 0;
  return cudaOccupancyMaxActiveClusters(&n, (void*)attend_step_bwd_kernel<DOT, bf>, &cfg) ==
                 cudaSuccess
             ? n
             : 0;
}

}  // namespace

// The per-step backward's shared memory per CTA in bytes, or -1 for a shape
// it does not take.
extern "C" long long avsr_attend_step_bwd_smem(int Hq, int A, int S, int Dv) {
  if (!step_shape_ok(Hq, A, S, Dv)) return -1;
  return (long long)step_smem(Hq, A, S, Dv);
}

// The clusters (a row each) that can be resident at once (0 on an error or
// a shape it does not take).
extern "C" int avsr_attend_step_bwd_max_active(int Hq, int A, int S, int Dv, int dot) {
  if (!step_shape_ok(Hq, A, S, Dv)) return 0;
  return dot ? step_max_active<true>(Hq, A, S, Dv) : step_max_active<false>(Hq, A, S, Dv);
}

// One step's read backward (dot != 0: the Luong read, keys bf16, vatt and dv
// null; else Bahdanau, keys fp32): query [N, Hq], wq [Hq, A], vatt [A],
// keys [N, S, A], values [N, S, Dv] bf16, weights [N, S] (the forward's),
// dctx [N, Dv] -> dquery [N, Hq], and the step's rows dsc [N, S], dctx_out
// [N, Dv], q [N, A], dq [N, A], dv [N, A], fp32, every element written; a
// cluster of CS CTAs per row.
extern "C" int avsr_attend_step_bwd(const void* query, const void* wq, const void* vatt,
                                    const void* keys, const void* values, const void* weights,
                                    const void* dctx, void* dquery, void* dsc, void* dctx_out,
                                    void* q, void* dq, void* dv, int N, int Hq, int A, int S,
                                    int Dv, int dot, void* stream) {
  if (N < 1 || !step_shape_ok(Hq, A, S, Dv) || (!dot && (vatt == nullptr || dv == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  using bf = __nv_bfloat16;
  auto* const launch = dot ? &step_launch<true, bf> : &step_launch<false, bf>;
  return (int)launch(query, wq, vatt, keys, values, weights, dctx, dquery, dsc, dctx_out, q, dq,
                     dv, N, Hq, A, S, Dv, st);
}

// The fp32 policy's step (the Bahdanau read): wq [Hq, A], vatt [A] and values
// [N, S, Dv] fp32, the rest as above.
extern "C" int avsr_attend_step_bwd_f32(const void* query, const void* wq, const void* vatt,
                                        const void* keys, const void* values,
                                        const void* weights, const void* dctx, void* dquery,
                                        void* dsc, void* dctx_out, void* q, void* dq, void* dv,
                                        int N, int Hq, int A, int S, int Dv, void* stream) {
  if (N < 1 || !step_shape_ok(Hq, A, S, Dv) || vatt == nullptr || dv == nullptr)
    return (int)cudaErrorInvalidValue;
  return (int)step_launch<false, float>(query, wq, vatt, keys, values, weights, dctx, dquery,
                                        dsc, dctx_out, q, dq, dv, N, Hq, A, S, Dv,
                                        reinterpret_cast<cudaStream_t>(stream));
}

namespace {

// a thread an output element, at most 16 blocks of 256 an SM
int loop_sums_blocks(int N, int S, int A, int Dv) {
  const size_t total = (size_t)N * S * (A + Dv);
  return (int)std::min<size_t>((total + 255) / 256, 132 * 16);
}

}  // namespace

// The memory's gradients after a loop of K steps on the CUDA cores, any A
// and Dv multiples of 8: keys [N, S, A] fp32 and vatt [A] (Bahdanau; unused
// when dot), weights and dsc [K, N, S], q [K, N, A], dctx [K, N, Dv] fp32 ->
// dkeys [N, S, A], dvalues [N, S, Dv] fp32, written.
extern "C" int avsr_attend_loop_sums(const void* keys, const void* vatt, const void* weights,
                                     const void* q, const void* dsc, const void* dctx,
                                     void* dkeys, void* dvalues, int K, int N, int A, int S,
                                     int Dv, int dot, void* stream) {
  if (K < 1 || N < 1 || S < 1 || A < 1 || Dv < 1 || (!dot && vatt == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  using bf = __nv_bfloat16;
  auto* kern = dot ? &attend_loop_sums_kernel<true, bf> : &attend_loop_sums_kernel<false, bf>;
  kern<<<loop_sums_blocks(N, S, A, Dv), 256, 0, st>>>(
      static_cast<const float*>(keys), static_cast<const bf*>(vatt),
      static_cast<const float*>(weights), static_cast<const float*>(q),
      static_cast<const float*>(dsc), static_cast<const float*>(dctx), static_cast<float*>(dkeys),
      static_cast<float*>(dvalues), K, N, S, A, Dv);
  return (int)cudaGetLastError();
}

// The fp32 policy's sums (the Bahdanau read): vatt [A] fp32, the rest as
// above.
extern "C" int avsr_attend_loop_sums_f32(const void* keys, const void* vatt, const void* weights,
                                         const void* q, const void* dsc, const void* dctx,
                                         void* dkeys, void* dvalues, int K, int N, int A, int S,
                                         int Dv, void* stream) {
  if (K < 1 || N < 1 || S < 1 || A < 1 || Dv < 1 || vatt == nullptr)
    return (int)cudaErrorInvalidValue;
  attend_loop_sums_kernel<false, float>
      <<<loop_sums_blocks(N, S, A, Dv), 256, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
          static_cast<const float*>(keys), static_cast<const float*>(vatt),
          static_cast<const float*>(weights), static_cast<const float*>(q),
          static_cast<const float*>(dsc), static_cast<const float*>(dctx),
          static_cast<float*>(dkeys), static_cast<float*>(dvalues), K, N, S, A, Dv);
  return (int)cudaGetLastError();
}

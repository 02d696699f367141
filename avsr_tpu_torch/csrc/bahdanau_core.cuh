// The attention read, one query row per block, shared by K10
// (bahdanau_attend.cu: the RNN decoder's read at every decode step) and
// K8 (av_align_scan.cu: the AV-Align fusion's read at every audio step),
// with either score: the additive one (Bahdanau) or the dot one (Luong
// "general"), chosen by the template argument DOT of read.
// It replaces avsr_tpu/ops/attention.py:attend, Bahdanau branch
// (:140-151) and Luong branch (:152-163), with its masking (:165-171),
// under the bf16 policy:
//
//   q[a]   = sum_k bf16(query[k]) * wq[k, a]                 (fp32)
//   additive: keys [S, A] fp32 (the projected memory), v [A]
//     e[s,a] = tanh(keys[s, a] + q[a])                        (fp32)
//     sc[s]  = sum_a bf16(e[s, a]) * bf16(v[a]) + bias[s]     (fp32)
//   dot: keys [S, A] bf16 (the raw memory, A its width), no v
//     sc[s]  = sum_a keys[s, a] * bf16(q[a]) + bias[s]        (fp32)
//   p      = softmax(sc);  p *= mask;  p /= max(sum(p), 1e-9)
//   w      = p * min(sum(mask), 1)
//   ctx[d] = sum_s bf16(w[s]) * values[s, d]                  (fp32)
//
// so a memory of length 0 (every bias -1e30, every mask 0) gives zero
// weights and a zero context, as the reference does (not K6's uniform
// mean).  Under the fp32 policy (train.compute_dtype = "float32") the same
// lines run on fp32 wq, v and values with every bf16 rounding point the
// identity and the additive energies by tanhf: the read, its q product and
// its context loop are templated on the element type E of those operands
// (Elem below; the additive score only: the dot score's fp32 instance is
// still to be ported).  The bias is added to every key, never used to skip one; a key
// whose bf16 weight is 0 is left out of the context sum, which adds
// exactly 0 for it.
//
// The read's backward lives with its callers, each split for its loop:
// K10's per-step kernel (bahdanau_attend.cu) and K8's recurrence
// (av_align_bwd.cuh) save the rows from which the memory's gradients are
// summed after the loop.
//
// Design: 256 threads per row (a block, or in K8's cluster forward a row's
// thread set with a named barrier: the read from q, scores_context, is
// templated on the group).  q: thread pairs of outputs
// (one 4-byte load of wq per k, LOADS rows in flight) with k split over
// THREADS / (A/2) slices, summed in a fixed order (the dot score rounds it
// to bf16 once, in shared memory).  Scores: a warp per key, KPW keys in
// flight per warp, each lane one float4 (additive) or one 16-byte chunk of
// 8 bf16 values (dot) of the key row; the additive energies run on the
// CUDA cores (tanhf; tanh_fast in K8's cluster forward); either dot over the
// key row is a shuffle reduction.
// Softmax and the renormalisation are fp32 block reductions.
// Context: a thread per 16-byte chunk (8 channels) of a value row, LOADS
// rows in flight, the keys split over THREADS / (Dv/8) slices, summed in a
// fixed order: the same bits every run.  (With one load in flight per key
// the context loop would be a chain of ~S / slices dependent L2 round
// trips.)  What bounds it on an H100: the bytes of the keys (fp32, or
// bf16 for the dot score) and values (bf16) of the row, read once; the
// sequential dependence of the reductions at one block per row.
// Requirements (checked by the wrappers): A % 8 == 0, A <= 512, Dv % 8 ==
// 0, Dv <= 2048; for the dot score A is the key width, so the RNN
// decoder's 512-wide fused memory meets the limit exactly.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace bahdanau {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int KPW = 4;    // keys in flight per warp in the score loop
constexpr int LOADS = 8;  // loads in flight per thread in the q and context loops

__device__ __forceinline__ float bf_lo(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float bf_hi(uint32_t v) { return __uint_as_float(v & 0xffff0000u); }
__device__ __forceinline__ float bf_round(float x) {
  return __bfloat162float(__float2bfloat16(x));
}
// tanh from one ex2.approx and one rcp.approx (absolute error ~1e-7)
__device__ __forceinline__ float tanh_fast(float x) {
  return 1.0f - __fdividef(2.0f, 1.0f + __expf(2.0f * x));
}

// The keys' element type: fp32 projected keys (additive score) or the bf16
// raw memory (dot score).
template <bool DOT> struct Key { using type = float; };
template <> struct Key<true> { using type = __nv_bfloat16; };

// The element type E of wq, v and the values: bf16 (the bf16 policy) or
// fp32 (the fp32 policy).  Elem<E> holds what differs: the conversion, the
// rounding point (bf16, or the identity), a chunk of 8 consecutive
// elements loaded at once (one 16-byte load, or two) and a pair of them;
// the loops that use them keep the bf16 instance's order of operations.
template <typename E> struct Elem;
template <> struct Elem<__nv_bfloat16> {
  using Chunk = uint4;
  static __device__ __forceinline__ float get(__nv_bfloat16 x) { return __bfloat162float(x); }
  static __device__ __forceinline__ float round(float x) { return bf_round(x); }
  // elements 8c .. 8c + 7 of p
  static __device__ __forceinline__ Chunk load8(const __nv_bfloat16* p, size_t c) {
    return reinterpret_cast<const uint4*>(p)[c];
  }
  static __device__ __forceinline__ Chunk zero8() { return make_uint4(0u, 0u, 0u, 0u); }
  // element j of a chunk (j a constant once the caller's loop is unrolled)
  static __device__ __forceinline__ float at(const Chunk& u, int j) {
    const uint32_t w = j < 2 ? u.x : j < 4 ? u.y : j < 6 ? u.z : u.w;
    return (j & 1) ? bf_hi(w) : bf_lo(w);
  }
  // elements 2i and 2i + 1 of p
  static __device__ __forceinline__ float2 pair(const __nv_bfloat16* p, size_t i) {
    const uint32_t w = reinterpret_cast<const uint32_t*>(p)[i];
    return make_float2(bf_lo(w), bf_hi(w));
  }
};
template <> struct Elem<float> {
  struct Chunk {
    float4 a, b;
  };
  static __device__ __forceinline__ float get(float x) { return x; }
  static __device__ __forceinline__ float round(float x) { return x; }
  static __device__ __forceinline__ Chunk load8(const float* p, size_t c) {
    const float4* q = reinterpret_cast<const float4*>(p) + 2 * c;
    return Chunk{q[0], q[1]};
  }
  static __device__ __forceinline__ Chunk zero8() {
    return Chunk{make_float4(0.f, 0.f, 0.f, 0.f), make_float4(0.f, 0.f, 0.f, 0.f)};
  }
  static __device__ __forceinline__ float at(const Chunk& u, int j) {
    const float4& v = j < 4 ? u.a : u.b;
    const int k = j & 3;
    return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
  }
  static __device__ __forceinline__ float2 pair(const float* p, size_t i) {
    return reinterpret_cast<const float2*>(p)[i];
  }
};

// The THREADS threads that run one read, and their barrier: a whole block
// (K10, K8's per-step read kernel) or one row's threads inside a larger
// block (K8's cluster forward, av_align_fwd.cuh: named barrier `id`).
struct BlockGroup {
  __device__ int tid() const { return threadIdx.x; }
  __device__ void sync() const { __syncthreads(); }
};
struct RowGroup {
  int t, id;  // the thread's index among the row's THREADS; the barrier (1..15)
  __device__ int tid() const { return t; }
  __device__ void sync() const {
    asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(THREADS) : "memory");
  }
};

// group-wide max (MAX) or sum of one value per thread, in a fixed order
template <bool MAX, class G>
__device__ __forceinline__ float group_reduce(const G& grp, float x, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float y = __shfl_xor_sync(0xffffffffu, x, o);
    x = MAX ? fmaxf(x, y) : x + y;
  }
  if (grp.tid() % 32 == 0) red[grp.tid() / 32] = x;
  grp.sync();
  float r = red[0];
#pragma unroll
  for (int w = 1; w < WARPS; ++w) r = MAX ? fmaxf(r, red[w]) : r + red[w];
  grp.sync();  // red is reused by the next reduction
  return r;
}
template <bool MAX>
__device__ __forceinline__ float block_reduce(float x, float* red) {
  return group_reduce<MAX>(BlockGroup{}, x, red);
}

// The q product's partial sums over the column pairs [p_lo, p_hi) of wq
// [Hq, A] E, qin [Hq] (E-rounded, in shared memory): a thread per pair, k
// split over THREADS / (p_hi - p_lo) slices (LD rows of wq in flight);
// slice sl's sum of column 2 p_lo + j lands at part[sl * 2 (p_hi - p_lo) +
// j].  Returns the slices, which the caller sums in order after a
// barrier.  The read takes every column; the per-step backward a cluster
// CTA's slice.
template <int LD, typename E>
__device__ __forceinline__ int q_partials(const float* qin, const E* __restrict__ wq, int Hq,
                                          int A, int p_lo, int p_hi, float* part) {
  const int tid = threadIdx.x;
  const int npair = p_hi - p_lo, slices = THREADS / npair;
  const int cp = tid % npair, sl = tid / npair;
  if (sl < slices) {
    float a0 = 0.f, a1 = 0.f;
    for (int k0 = sl; k0 < Hq; k0 += LD * slices) {
      float2 ww[LD];
#pragma unroll
      for (int j = 0; j < LD; ++j) {
        const int k = k0 + j * slices;
        ww[j] = k < Hq ? Elem<E>::pair(wq, (size_t)k * (A / 2) + p_lo + cp)
                       : make_float2(0.f, 0.f);
      }
#pragma unroll
      for (int j = 0; j < LD; ++j) {
        const int k = k0 + j * slices;
        const float x = k < Hq ? qin[k] : 0.f;
        a0 = fmaf(x, ww[j].x, a0);
        a1 = fmaf(x, ww[j].y, a1);
      }
    }
    part[sl * 2 * npair + 2 * cp] = a0;
    part[sl * 2 * npair + 2 * cp + 1] = a1;
  }
  return slices;
}

// q = qin @ wq for one row -> q_s [A] fp32, rounded to bf16 when ROUND (the
// dot score's cast of q): q_partials over every column (LOADS rows of wq
// in flight), the slices summed in a fixed order.  Ends with a barrier.
template <bool ROUND, typename E>
__device__ __forceinline__ void q_product(const float* qin, const E* __restrict__ wq, int Hq,
                                          int A, float* part, float* q_s) {
  const int slices = q_partials<LOADS>(qin, wq, Hq, A, 0, A / 2, part);
  __syncthreads();
  for (int a = threadIdx.x; a < A; a += THREADS) {
    float s = 0.f;
    for (int j = 0; j < slices; ++j) s += part[j * A + a];
    q_s[a] = ROUND ? bf_round(s) : s;
  }
  __syncthreads();
}

// Shared memory of one read, in bytes: q and v [A] (v unused by the dot
// score), the query [Hq], the scores [S], the reduction slots and the
// partial sums [8 * THREADS].
__host__ __device__ inline size_t read_smem_bytes(int Hq, int A, int S) {
  return (size_t)(2 * A + Hq + S + WARPS + 8 * THREADS) * sizeof(float);
}

// The read from its q: the scores, the softmax with the mask and the
// renormalisation, and the context, run by the group's THREADS threads.
// q_s [A] fp32 (bf16-rounded for the dot score), v_s [A] (E v as fp32;
// unused by the dot score), keys [S, A] (fp32 additive, bf16 dot), values
// [S, Dv] E, bias / mask [S] fp32 (this row's slices); scratch p_s [S],
// red [WARPS], part [8 * THREADS] fp32.  w_out(s, w) receives each weight,
// ctx_out(d, x) each context channel.  FAST: the additive score's tanh is
// tanh_fast (fewer registers than tanhf's slow path; never in fp32);
// LOADS_ value rows in flight per thread in the context.
template <bool DOT, bool FAST = false, int LOADS_ = LOADS, class G, class WeightOut,
          class CtxOut, typename E>
__device__ void scores_context(const G& grp, const float* q_s, const float* v_s,
                               const typename Key<DOT>::type* __restrict__ keys,
                               const E* __restrict__ values, const float* __restrict__ bias,
                               const float* __restrict__ mask, int A, int S, int Dv, float* p_s,
                               float* red, float* part, WeightOut w_out, CtxOut ctx_out) {
  using X = Elem<E>;
  static_assert(!DOT || sizeof(E) == 2, "the dot score's fp32 read is still to be ported");
  static_assert(!FAST || sizeof(E) == 2, "the fp32 read takes tanhf");
  const int tid = grp.tid(), lane = tid & 31, warp = tid >> 5;
  const auto tanh_ = [](float x) { return FAST ? tanh_fast(x) : tanhf(x); };

  if constexpr (DOT) {
    // scores: a warp per key, KPW keys at a time, 8 bf16 keys per lane load
    const int A8 = A / 8;
    const uint4* k8 = reinterpret_cast<const uint4*>(keys);
    const float4* q4 = reinterpret_cast<const float4*>(q_s);
    for (int s0 = warp * KPW; s0 < S; s0 += WARPS * KPW) {
      float acc[KPW];
#pragma unroll
      for (int j = 0; j < KPW; ++j) acc[j] = 0.f;
      for (int c = lane; c < A8; c += 32) {
        uint4 kv[KPW];
#pragma unroll
        for (int j = 0; j < KPW; ++j)
          kv[j] = s0 + j < S ? k8[(size_t)(s0 + j) * A8 + c] : make_uint4(0u, 0u, 0u, 0u);
        const float4 qa = q4[2 * c], qb = q4[2 * c + 1];
#pragma unroll
        for (int j = 0; j < KPW; ++j) {
          acc[j] = fmaf(bf_lo(kv[j].x), qa.x, acc[j]);
          acc[j] = fmaf(bf_hi(kv[j].x), qa.y, acc[j]);
          acc[j] = fmaf(bf_lo(kv[j].y), qa.z, acc[j]);
          acc[j] = fmaf(bf_hi(kv[j].y), qa.w, acc[j]);
          acc[j] = fmaf(bf_lo(kv[j].z), qb.x, acc[j]);
          acc[j] = fmaf(bf_hi(kv[j].z), qb.y, acc[j]);
          acc[j] = fmaf(bf_lo(kv[j].w), qb.z, acc[j]);
          acc[j] = fmaf(bf_hi(kv[j].w), qb.w, acc[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < KPW; ++j) {
        float a = acc[j];
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) a += __shfl_xor_sync(0xffffffffu, a, o);
        if (lane == 0 && s0 + j < S) p_s[s0 + j] = a + bias[s0 + j];
      }
    }
    grp.sync();
  } else {
    // scores: a warp per key, KPW keys at a time, a float4 of the key per lane
    const int A4 = A / 4;
    const float4* k4 = reinterpret_cast<const float4*>(keys);
    const float4* q4 = reinterpret_cast<const float4*>(q_s);
    const float4* v4 = reinterpret_cast<const float4*>(v_s);
    for (int s0 = warp * KPW; s0 < S; s0 += WARPS * KPW) {
      float acc[KPW];
#pragma unroll
      for (int j = 0; j < KPW; ++j) acc[j] = 0.f;
      for (int c = lane; c < A4; c += 32) {
        float4 kv[KPW];
#pragma unroll
        for (int j = 0; j < KPW; ++j)
          kv[j] = s0 + j < S ? k4[(size_t)(s0 + j) * A4 + c] : make_float4(0.f, 0.f, 0.f, 0.f);
        const float4 qq = q4[c], vv = v4[c];
#pragma unroll
        for (int j = 0; j < KPW; ++j) {
          acc[j] = fmaf(X::round(tanh_(kv[j].x + qq.x)), vv.x, acc[j]);
          acc[j] = fmaf(X::round(tanh_(kv[j].y + qq.y)), vv.y, acc[j]);
          acc[j] = fmaf(X::round(tanh_(kv[j].z + qq.z)), vv.z, acc[j]);
          acc[j] = fmaf(X::round(tanh_(kv[j].w + qq.w)), vv.w, acc[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < KPW; ++j) {
        float a = acc[j];
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) a += __shfl_xor_sync(0xffffffffu, a, o);
        if (lane == 0 && s0 + j < S) p_s[s0 + j] = a + bias[s0 + j];
      }
    }
    grp.sync();
  }

  // softmax (fp32), the mask, the renormalisation and the empty-memory zero
  {
    float mx = __int_as_float(0xff800000u);  // -inf
    for (int s = tid; s < S; s += THREADS) mx = fmaxf(mx, p_s[s]);
    mx = group_reduce<true>(grp, mx, red);
    float sum = 0.f;
    for (int s = tid; s < S; s += THREADS) {
      const float e = expf(p_s[s] - mx);
      p_s[s] = e;
      sum += e;
    }
    sum = group_reduce<false>(grp, sum, red);
    float psum = 0.f, msum = 0.f;
    for (int s = tid; s < S; s += THREADS) {
      const float m = mask[s];
      const float p = p_s[s] / sum * m;
      p_s[s] = p;
      psum += p;
      msum += m;
    }
    psum = group_reduce<false>(grp, psum, red);
    msum = group_reduce<false>(grp, msum, red);
    const float denom = fmaxf(psum, 1e-9f), scale = fminf(msum, 1.0f);
    for (int s = tid; s < S; s += THREADS) {
      const float w = p_s[s] / denom * scale;
      w_out(s, w);
      p_s[s] = X::round(w);
    }
    grp.sync();
  }

  // context: a thread per 8-channel chunk, keys split over slices
  {
    const int C = Dv / 8, slices = THREADS / C;
    const int c = tid % C, sl = tid / C;
    if (sl < slices) {
      float acc[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[j] = 0.f;
      for (int s0 = sl; s0 < S; s0 += LOADS_ * slices) {
        float p[LOADS_];
        typename X::Chunk u[LOADS_];  // LOADS_ value rows in flight
#pragma unroll
        for (int j = 0; j < LOADS_; ++j) {
          const int s = s0 + j * slices;
          p[j] = s < S ? p_s[s] : 0.f;
          u[j] = p[j] != 0.f ? X::load8(values, (size_t)s * C + c) : X::zero8();
        }
#pragma unroll
        for (int j = 0; j < LOADS_; ++j) {
          if (p[j] == 0.f) continue;
#pragma unroll
          for (int i = 0; i < 8; ++i) acc[i] = fmaf(p[j], X::at(u[j], i), acc[i]);
        }
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) part[sl * Dv + 8 * c + j] = acc[j];
    }
    grp.sync();
    for (int d = tid; d < Dv; d += THREADS) {
      float x = 0.f;
      for (int j = 0; j < slices; ++j) x += part[j * Dv + d];
      ctx_out(d, x);
    }
  }
}

// One read.  query [Hq] fp32, wq [Hq, A] E, vatt [A] E (null for the dot
// score), keys [S, A] (fp32 additive, bf16 dot), values [S, Dv] E, bias /
// mask [S] fp32 (this row's slices).  w_out(s, w) receives each weight,
// ctx_out(d, x) each context channel.
template <bool DOT, class WeightOut, class CtxOut, typename E>
__device__ void read(const float* __restrict__ query, const E* __restrict__ wq,
                     const E* __restrict__ vatt, const typename Key<DOT>::type* __restrict__ keys,
                     const E* __restrict__ values, const float* __restrict__ bias,
                     const float* __restrict__ mask, int Hq, int A, int S, int Dv, float* smem,
                     WeightOut w_out, CtxOut ctx_out) {
  float* q_s = smem;           // [A]
  float* v_s = q_s + A;        // [A]
  float* qin = v_s + A;        // [Hq] bf16-rounded query
  float* p_s = qin + Hq;       // [S] scores, weights, then bf16(weights)
  float* red = p_s + S;        // [WARPS]
  float* part = red + WARPS;   // [8 * THREADS]
  const int tid = threadIdx.x;

  for (int i = tid; i < Hq; i += THREADS) qin[i] = Elem<E>::round(query[i]);
  if (!DOT)
    for (int i = tid; i < A; i += THREADS) v_s[i] = Elem<E>::get(vatt[i]);
  __syncthreads();

  q_product<DOT>(qin, wq, Hq, A, part, q_s);
  // an fp32 value chunk takes twice a bf16 one's registers: half as many in flight
  constexpr int LD = sizeof(E) == 2 ? LOADS : LOADS / 2;
  scores_context<DOT, false, LD>(BlockGroup{}, q_s, v_s, keys, values, bias, mask, A, S, Dv, p_s,
                                 red, part, w_out, ctx_out);
}

}  // namespace bahdanau

// K10's grouped read ("grouped", kernels.attend_route): the RNN decoder's
// attention read at a beam step, the W beams of each utterance reading its
// one memory row.  It computes bahdanau_core.cuh's function, rounding
// points included (avsr_tpu/ops/attention.py:attend, Bahdanau :140-151,
// Luong :152-163, the mask :165-171), for query row n = b W + w over
// memory row b, as the reference reads its beam-tiled copy:
//
//   q[w]      = bf16(query[w]) . wq                      (fp32; Luong: bf16(q))
//   additive: sc[w, s] = sum_a bf16(tanh(keys[s, a] + q[w, a])) bf16(v[a]) + bias[s]
//   dot:      sc[w, s] = sum_a keys[s, a] bf16(q[w, a]) + bias[s]
//   p = softmax(sc[w]) * mask;  w = p / max(sum p, 1e-9) * min(sum mask, 1)
//   ctx[w, d] = sum_s bf16(w[s]) values[s, d]             (fp32)
//
// Design: a cluster of C CTAs per memory row b (kernels.attend_grouped_cluster:
// C as many as keep the B clusters within one wave, up to 16), 512 threads
// each, one CTA an SM.
// CTA r of the cluster owns a share of q's columns, a chunk of the keys and
// a slice of the value columns, so every byte of the row is read from
// device memory once for the W queries, and nothing is formed twice but the
// softmax over W x S scores:
//
//   1. q: CTA r forms its 16-column groups of q for the W queries on the
//      tensor cores (mma.sync, bf16(query) as one 16-row strip, fp32
//      sums; wq's columns staged once), and stores them into every CTA's
//      shared memory (st.async, each counted on the receiver's mbarrier: no
//      cluster barrier, whose release arrive is a GPU-wide memory barrier).
//   2. scores of CTA r's key chunk, [r S / C, (r + 1) S / C), for the W
//      queries: Bahdanau's energies on the CUDA cores, each key row read
//      once for the W queries.  tanh(k + q) = 1 - 2 / (1 + e^2k e^2q):
//      e^2k once per key element and e^2q once per query element (expf),
//      so each energy costs one rcp.approx (the multi-function unit bounds
//      this stage) instead of an exp and a reciprocal; where some |k| or
//      |q| of the CTA exceeds 40 (a factor could leave fp32's normal range)
//      the CTA takes tanhf(k + q) instead.  Luong's [W, Hk] . [Hk, chunk]
//      on the tensor cores (bf16 products, fp32 sums), the chunk staged
//      once.  The chunk's scores (key-major, so contiguous) go into every
//      CTA's shared memory the same way.
//   3. every CTA runs the same softmax, mask and renormalisation over all
//      W x S scores, in the same order, so every CTA holds the same bits;
//      CTA r writes the weights of its key chunk.
//   4. context: bf16(w) [16 x S] . values [S x its columns] on the tensor
//      cores, the slice staged once (cp.async at the start, behind the
//      other stages).
//
// The products split their 16-step k loops over the warps and add the
// warps' partial sums in a fixed order (strip_product), so every run gives
// the same bits.  A memory of length 0 (every bias -1e30, every mask 0)
// gives zero weights and a zero context, as the reference does.  What
// bounds it on an H100: the bytes of the untiled memory, read once (B S (4 A
// + 2 Dv) for Bahdanau, B S 2 Hk for Luong), wq and the small rows; at the
// presets' beam step (B = 8, W = 10, S = 197) the multi-function unit's
// W S A reciprocals a row for Bahdanau, the dependent stages' latencies
// and the launch.  Requirements (checked by the launcher): 1 <= W <= 16, Hq,
// A and Dv multiples of 16, A <= 512, Dv <= 2048, C in {1, 2, 4, 8, 16}
// (a CTA of a cluster larger than S owns no key).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bahdanau_core.cuh"
#include "cluster_ptx.cuh"

namespace {
namespace attend_grouped {

using bf16 = __nv_bfloat16;

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_W = 16;          // queries of a memory row: one 16-row strip
constexpr float EXP_RANGE = 40.f;  // |k|, |q| for which e^2k e^2q stays exact enough
constexpr int MAX_S = 768;  // keys a row
constexpr int SPT = (MAX_S + THREADS - 1) / THREADS;  // bias and mask values a thread

__host__ __device__ inline int up16(int x) { return (x + 15) & ~15; }
// warps a 16-column group of a strip product takes: its k steps split over
// WARPS / ng of them (at least one)
__host__ __device__ inline int ksplit(int ng) { return ng >= WARPS ? 1 : WARPS / ng; }

// Shared memory of one CTA, byte offsets (every region a multiple of 16
// bytes; bf16 rows padded by 16 bytes, so the 8 rows one ldmatrix reads fall
// in 8 bank groups):
//   qa   bf16(query) [16][Hq + 8]      wq   wq's columns [Hq][16 qg + 8]
//   qx   q [W][A] fp32 (Bahdanau) or bf16(q) [16][A + 8] (Luong)
//   v    bf16(v) [A] fp32 (Bahdanau)
//   keys the chunk [SC][A] fp32 (Bahdanau) or [SCP][A + 8] bf16
//   ek, eq  e^2k [SC][A] and e^2q [W][A] fp32 (Bahdanau)
//   bias, mask [S_pad]                 sc   the scores [S_pad][Wp] fp32 (Wp: W rounded
//                                      up to 4; a key chunk is contiguous)
//   p    bf16(w) [16][S_pad + 8]       vals the value columns [S_pad][16 vg + 8]
//   part the strip products' partial sums    bars the q and score arrivals' mbarriers
// qg / vg: the most 16-column groups of q / of the values a CTA owns; SC
// the longest key chunk (SCP rounded up to 16).
struct Layout {
  int S_pad, SC, SCP, Wp, qg, vg, pq, pw, pk, pp, pv;
  size_t qa, wq, qx, v, keys, ek, eq, bias, mask, sc, p, vals, part, bars, total;
  __host__ __device__ Layout(int W, int S, int Hq, int A, int Dv, int C, bool dot) {
    S_pad = up16(S);
    SC = (S + C - 1) / C;
    SCP = up16(SC);
    Wp = (W + 3) & ~3;
    qg = (A / 16 + C - 1) / C;
    vg = (Dv / 16 + C - 1) / C;
    pq = Hq + 8;
    pw = 16 * qg + 8;
    pk = A + 8;
    pp = S_pad + 8;
    pv = 16 * vg + 8;
    // a CTA's product of ng groups writes ng ksplit(ng) units, at most 16
    // for ng < 16 and ng past that; a CTA may own fewer groups than qg / vg
    // (17 q groups over 8 CTAs: 3 x 5 units in one, 2 x 8 in the others)
    int units = 16;
    units = units > qg ? units : qg;
    units = units > vg ? units : vg;
    if (dot) units = units > SCP / 16 ? units : SCP / 16;
    size_t o = 0;
    qa = o;
    o += (size_t)16 * pq * 2;
    wq = o;
    o += (size_t)Hq * pw * 2;
    qx = o;
    o += dot ? (size_t)16 * pk * 2 : (size_t)W * A * 4;
    v = o;
    o += dot ? 0 : (size_t)A * 4;
    keys = o;
    o += dot ? (size_t)SCP * pk * 2 : (size_t)SC * A * 4;
    ek = o;
    o += dot ? 0 : (size_t)SC * A * 4;
    eq = o;
    o += dot ? 0 : (size_t)W * A * 4;
    bias = o;
    o += (size_t)S_pad * 4;
    mask = o;
    o += (size_t)S_pad * 4;
    sc = o;
    o += (size_t)S_pad * Wp * 4;
    p = o;
    o += (size_t)16 * pp * 2;
    vals = o;
    o += (size_t)S_pad * pv * 2;
    part = o;
    o += (size_t)units * 16 * 16 * 4;
    bars = o;
    total = o + 16;
  }
};

__device__ __forceinline__ int cluster_size() {
  uint32_t n;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(n));
  return (int)n;
}
// the cluster barrier's arrival without memory ordering (this CTA runs)
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
// a 16-byte store into a cluster CTA's shared memory (addr a mapa
// address) whose bytes complete the transaction count of that CTA's
// mbarrier bar (a mapa address too); the receiver's wait on bar sees them
__device__ __forceinline__ void st_async16(uint32_t addr, uint4 x, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], {%1, %2, %3, %4}, [%5];\n"
      ::"r"(addr), "r"(x.x), "r"(x.y), "r"(x.z), "r"(x.w), "r"(bar)
      : "memory");
}

// 16-byte chunks of this CTA's shared memory into the same place in every
// other CTA of the cluster, by every thread, each counted on the receiver's
// mbarrier at `bar` (this CTA's shared address of it): chunk i of n at
// byte offset at(i) from `base`.  The CTA's own copy is already there.
template <class At>
__device__ __forceinline__ void to_peers(const unsigned char* base, int n, int C, int r,
                                         const uint64_t* bar, At at) {
  const uint32_t a0 = mma_attn::smem_addr(base), b0 = mma_attn::smem_addr(bar);
#pragma unroll 1
  for (int i = threadIdx.x; i < n * (C - 1); i += THREADS) {
    const int pr = i / n, off = at(i % n);
    const uint32_t rr = pr + (pr >= r);
    st_async16(cluster_ptx::map_rank(a0 + off, rr), *reinterpret_cast<const uint4*>(base + off),
               cluster_ptx::map_rank(b0, rr));
  }
}

// 1 / y to within an ulp or so: rcp.approx and one Newton step (no slow
// path; y a positive normal number)
__device__ __forceinline__ float rcp_newton(float y) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;\n" : "=f"(r) : "f"(y));
  return fmaf(r, fmaf(-y, r, 1.f), r);
}

// one exchange of warp_sums: of the 2h values a lane holds, the lanes whose
// bit `o` is set keep the upper h, the others the lower h, each summed with
// the partner's (lane ^ o) copy
template <int H, int O>
__device__ __forceinline__ void halve(float (&acc)[MAX_W], int lane) {
  const bool up = lane & O;
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const float send = up ? acc[i] : acc[i + H], keep = up ? acc[i + H] : acc[i];
    acc[i] = keep + __shfl_xor_sync(0xffffffffu, send, O);
  }
}
// the sum over the warp's 32 lanes of each of the MAX_W = 16 values a lane
// holds (acc[0..16)), halving the values at each exchange: on return acc[0]
// of lane l holds the sum of value l / 2, the same bits in lanes l and l ^ 1
__device__ __forceinline__ void warp_sums(float (&acc)[MAX_W], int lane) {
  static_assert(MAX_W == 16, "four halvings over lanes 16, 8, 4, 2");
  halve<8, 16>(acc, lane);
  halve<4, 8>(acc, lane);
  halve<2, 4>(acc, lane);
  halve<1, 2>(acc, lane);
  acc[0] += __shfl_xor_sync(0xffffffffu, acc[0], 1);
}

// One 16-row strip times ng 16-column groups: out(i, j, x_j, x_j+1) for
// rows i < rows and even columns j < 16 ng, x the sum over the k steps
// [0, nk) of la(a, kd) (the strip's 16 x 16 A fragment) times lb(b, g, kd)
// (group g's 16 x 16 B fragment, two n-tiles).  Group g's k steps are split
// over ksplit(ng) warps, four steps a warp at least; the partial sums meet
// in `part` and are added in the warps' order.  Called by every thread;
// ends with a barrier (part is free again).
template <class LoadA, class LoadB, class Out>
__device__ __forceinline__ void strip_product(int ng, int nk, int rows, float* part, LoadA la,
                                              LoadB lb, Out out) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int ks = max(1, min(ksplit(ng), nk / 4)), width = 16 * ng;
  const int g8 = lane >> 2, t2 = 2 * (lane & 3);
  for (int u = warp; u < ng * ks; u += WARPS) {
    const int g = u % ng, kq = u / ng;
    float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    for (int kd = kq * nk / ks; kd < (kq + 1) * nk / ks; ++kd) {
      uint32_t a[4], b[4];
      la(a, kd);
      lb(b, g, kd);
      mma_attn::mma(acc[0], a, b[0], b[1]);
      mma_attn::mma(acc[1], a, b[2], b[3]);
    }
    float* pk = part + (size_t)kq * 16 * width;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(pk + (size_t)(g8 + 8 * h) * width + 16 * g + 8 * nt + t2) =
            make_float2(acc[nt][2 * h], acc[nt][2 * h + 1]);
  }
  __syncthreads();
  #pragma unroll 1
  for (int o = threadIdx.x; o < rows * width / 2; o += THREADS) {
    const int i = o / (width / 2), j = 2 * (o % (width / 2));
    float x0 = 0.f, x1 = 0.f;
    for (int kq = 0; kq < ks; ++kq) {
      const float2 y = *reinterpret_cast<const float2*>(part + ((size_t)kq * 16 + i) * width + j);
      x0 += y.x;
      x1 += y.y;
    }
    out(i, j, x0, x1);
  }
  __syncthreads();
}

// bf16(tanh(k + q)) of two elements from the factors k = e^2k, q = e^2q:
// 1 - 2 / (1 + e^2k e^2q), one rcp.approx each, rounded to bf16 in one
// cvt.rn.bf16x2 (round to nearest even, as the reference casts)
__device__ __forceinline__ float2 energies(float k0, float q0, float k1, float q1) {
  float r0, r1;
  asm("rcp.approx.ftz.f32 %0, %1;\n" : "=f"(r0) : "f"(fmaf(k0, q0, 1.f)));
  asm("rcp.approx.ftz.f32 %0, %1;\n" : "=f"(r1) : "f"(fmaf(k1, q1, 1.f)));
  const uint32_t u = mma_attn::pack_bf16(fmaf(-2.f, r0, 1.f), fmaf(-2.f, r1, 1.f));
  return make_float2(__uint_as_float(u << 16), __uint_as_float(u & 0xffff0000u));
}

// Bahdanau's scores of the keys [0, nS) of k_s [nS][A] for the W queries, from
// the factors: k_s = e^2k, q_s [W][A] = e^2q, v_s [A]: a warp a key, each
// lane a float4 of it against every query (MAX_W sums a lane, halved over
// the warp by warp_sums); score (s, w) + bias into sc [S_pad][Wp] at row s0
// + s.
__device__ __forceinline__ void additive_scores(const float* k_s, const float* q_s,
                                                const float* v_s, const float* bias_s, float* sc,
                                                int nS, int s0, int W, int Wp, int A) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const float4* v4 = reinterpret_cast<const float4*>(v_s);
  const float4* q4 = reinterpret_cast<const float4*>(q_s);
#pragma unroll 1
  for (int j = warp; j < nS; j += WARPS) {
    const float4* k4 = reinterpret_cast<const float4*>(k_s + (size_t)j * A);
    float acc[MAX_W];
#pragma unroll
    for (int w = 0; w < MAX_W; ++w) acc[w] = 0.f;
#pragma unroll 1
    for (int c = lane; c < A / 4; c += 32) {
      const float4 kk = k4[c], vv = v4[c];
#pragma unroll
      for (int w = 0; w < MAX_W; ++w) {
        if (w < W) {
          const float4 qq = q4[w * (A / 4) + c];
          const float2 e01 = energies(kk.x, qq.x, kk.y, qq.y);
          const float2 e23 = energies(kk.z, qq.z, kk.w, qq.w);
          acc[w] = fmaf(e01.x, vv.x, acc[w]);
          acc[w] = fmaf(e01.y, vv.y, acc[w]);
          acc[w] = fmaf(e23.x, vv.z, acc[w]);
          acc[w] = fmaf(e23.y, vv.w, acc[w]);
        }
      }
    }
    warp_sums(acc, lane);
    const int w = lane / 2;
    if (lane % 2 == 0 && w < W) sc[(size_t)(s0 + j) * Wp + w] = acc[0] + bias_s[s0 + j];
  }
}

// The same scores from k_s = keys and q_s = q themselves, bf16(tanhf(k +
// q)), where a factor could leave fp32's normal range: a warp a (key,
// query) pair, a lane a float4, the lanes' sums over the warp.
__device__ __noinline__ void additive_scores_tanh(const float* k_s, const float* q_s,
                                                  const float* v_s, const float* bias_s,
                                                  float* sc, int nS, int s0, int W, int Wp,
                                                  int A) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll 1
  for (int pr = warp; pr < W * nS; pr += WARPS) {
    const int w = pr % W, j = pr / W;
    float acc = 0.f;
#pragma unroll 1
    for (int a = 4 * lane; a < A; a += 128)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        acc = fmaf(bahdanau::bf_round(tanhf(k_s[(size_t)j * A + a + i] + q_s[w * A + a + i])),
                   v_s[a + i], acc);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if (lane == 0) sc[(size_t)(s0 + j) * Wp + w] = acc + bias_s[s0 + j];
  }
}

// The softmax, mask and renormalisation of the NQ queries w[q] of a warp
// (live[q]: w[q] < W) over their S scores sc[s * Wp + w], the lanes taking
// the keys s = lane + 32 k; sums over a lane's keys in order, then over the
// lanes in a fixed order; the queries' chains interleaved.  The quotients
// by a row's sums are div_row's (IEEE's bits for quotients above ~2^-100
// given the correctly rounded reciprocal) from rcp_newton's reciprocal,
// without div.rn's or rcp.rn's slow paths.  The weights of keys [s0, s1) go
// to weights [., S] at rows n0 + w, bf16(w) of every key to P's rows.  A
// dead query takes part in the shuffles and writes nothing.  IN_REGS (S <=
// 32 NV): scores in registers, every step predicated rather than branched
// (a key past S holds -inf, then 0, and adds exactly 0); else loops over sc
// between the passes.
template <int NQ, bool IN_REGS>
__device__ __forceinline__ void softmax_queries(float* sc, const float* mask_s, int Wp, int S,
                                                const int (&w)[NQ], const bool (&live)[NQ],
                                                float* weights, size_t n0, int s0, int s1,
                                                bf16* p_s, int pp) {
  constexpr int NV = IN_REGS ? 8 : 1;
  const int lane = threadIdx.x % 32;
  const float ninf = __int_as_float(0xff800000u);
  float x[NQ][NV], mx[NQ], sum[NQ], psum[NQ], msum[NQ], rs[NQ];
  int n[NQ];
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    n[q] = live[q] ? S : 0;
    mx[q] = ninf;
    sum[q] = psum[q] = msum[q] = 0.f;
  }
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    if constexpr (IN_REGS) {
#pragma unroll
      for (int k = 0; k < NV; ++k) {
        const int s = lane + 32 * k;
        x[q][k] = s < n[q] ? sc[s * Wp + w[q]] : ninf;
        mx[q] = fmaxf(mx[q], x[q][k]);
      }
    } else {
#pragma unroll 1
      for (int s = lane; s < n[q]; s += 32) mx[q] = fmaxf(mx[q], sc[s * Wp + w[q]]);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int q = 0; q < NQ; ++q) mx[q] = fmaxf(mx[q], __shfl_xor_sync(0xffffffffu, mx[q], o));
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    if constexpr (IN_REGS) {
#pragma unroll
      for (int k = 0; k < NV; ++k) {
        x[q][k] = expf(x[q][k] - mx[q]);
        sum[q] += x[q][k];
      }
    } else {
#pragma unroll 1
      for (int s = lane; s < n[q]; s += 32) {
        const float e = expf(sc[s * Wp + w[q]] - mx[q]);
        sc[s * Wp + w[q]] = e;
        sum[q] += e;
      }
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int q = 0; q < NQ; ++q) sum[q] += __shfl_xor_sync(0xffffffffu, sum[q], o);
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    rs[q] = rcp_newton(sum[q]);
    if constexpr (IN_REGS) {
#pragma unroll
      for (int k = 0; k < NV; ++k) {
        const int s = lane + 32 * k;
        const float m = s < n[q] ? mask_s[s] : 0.f;
        x[q][k] = mma_attn::div_row(x[q][k], sum[q], rs[q]) * m;
        psum[q] += x[q][k];
        msum[q] += m;
      }
    } else {
#pragma unroll 1
      for (int s = lane; s < n[q]; s += 32) {
        const float m = mask_s[s];
        const float p = mma_attn::div_row(sc[s * Wp + w[q]], sum[q], rs[q]) * m;
        sc[s * Wp + w[q]] = p;
        psum[q] += p;
        msum[q] += m;
      }
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      psum[q] += __shfl_xor_sync(0xffffffffu, psum[q], o);
      msum[q] += __shfl_xor_sync(0xffffffffu, msum[q], o);
    }
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    const float denom = fmaxf(psum[q], 1e-9f), scale = fminf(msum[q], 1.0f);
    const float rden = rcp_newton(denom);
    float* wr = weights + (n0 + w[q]) * S;
    bf16* prow = p_s + (size_t)w[q] * pp;
    if constexpr (IN_REGS) {
#pragma unroll
      for (int k = 0; k < NV; ++k) {
        const int s = lane + 32 * k;
        const float y = mma_attn::div_row(x[q][k], denom, rden) * scale;
        if (s < n[q]) {
          if (s >= s0 && s < s1) wr[s] = y;
          prow[s] = __float2bfloat16(y);
        }
      }
    } else {
#pragma unroll 1
      for (int s = lane; s < n[q]; s += 32) {
        const float y = mma_attn::div_row(sc[s * Wp + w[q]], denom, rden) * scale;
        if (s >= s0 && s < s1) wr[s] = y;
        prow[s] = __float2bfloat16(y);
      }
    }
  }
}

template <bool DOT>
__global__ void __launch_bounds__(THREADS, THREADS <= 256 ? 2 : 1)
attend_grouped_kernel(const float* __restrict__ query,      // [B W, Hq]
                      const bf16* __restrict__ wq,          // [Hq, A]
                      const bf16* __restrict__ vatt,        // [A] (null: Luong)
                      const void* __restrict__ keys_in,     // [B, S, A] fp32 / bf16 (Luong)
                      const bf16* __restrict__ values,      // [B, S, Dv]
                      const float* __restrict__ bias,       // [B, S]
                      const float* __restrict__ mask,       // [B, S]
                      float* __restrict__ ctx,              // [B W, Dv]
                      float* __restrict__ weights,          // [B W, S]
                      int W, int Hq, int A, int S, int Dv) {
  using mma_attn::pitched::load_a;
  using mma_attn::pitched::load_b;
  using mma_attn::pitched::load_bt;
  extern __shared__ __align__(128) unsigned char gsm[];
  const int C = cluster_size(), r = (int)cluster_ptx::cluster_rank();
  const int b = blockIdx.x / C;
  const Layout lay(W, S, Hq, A, Dv, C, DOT);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  bf16* qa = reinterpret_cast<bf16*>(gsm + lay.qa);
  bf16* wq_s = reinterpret_cast<bf16*>(gsm + lay.wq);
  float* bias_s = reinterpret_cast<float*>(gsm + lay.bias);
  float* mask_s = reinterpret_cast<float*>(gsm + lay.mask);
  float* sc_s = reinterpret_cast<float*>(gsm + lay.sc);
  bf16* p_s = reinterpret_cast<bf16*>(gsm + lay.p);
  bf16* vals = reinterpret_cast<bf16*>(gsm + lay.vals);
  float* part = reinterpret_cast<float*>(gsm + lay.part);

  // this CTA's share: q's column groups [qg0, qg0 + nqg), the keys [s0, s0 +
  // nS), the value column groups [vg0, vg0 + nvg)
  const int nq = A / 16, nv = Dv / 16;
  const int qg0 = r * nq / C, nqg = (r + 1) * nq / C - qg0;
  const int s0 = r * S / C, nS = (r + 1) * S / C - s0;
  const int vg0 = r * nv / C, nvg = (r + 1) * nv / C - vg0;
  const size_t n0 = (size_t)b * W;  // the row's first query

  // the q columns and the scores of the other CTAs arrive by st.async,
  // counted on two mbarriers armed here with the bytes they will bring
  uint64_t* bars = reinterpret_cast<uint64_t*>(gsm + lay.bars);
  if (tid == 0) {
    cluster_ptx::mbar_init(&bars[0], 1);
    cluster_ptx::mbar_init(&bars[1], 1);
    cluster_ptx::fence_mbar_init();
    cluster_ptx::mbar_expect(&bars[0], (uint32_t)(W * (A - 16 * nqg) * (DOT ? 2 : 4)));
    cluster_ptx::mbar_expect(&bars[1], (uint32_t)((S - nS) * lay.Wp * 4));
  }
  cluster_arrive_relaxed();  // this CTA runs, its barriers are armed

  // the query rows (a CTA that forms q), v, bias and mask in flight, into registers
  constexpr int QL = 4;  // float4s of the query a thread holds
  const int nq4 = nqg > 0 ? W * Hq / 4 : 0;
  // (predicated loads, no select on their values: nothing waits for them yet)
  float4 qin[QL];
#pragma unroll
  for (int u = 0; u < QL; ++u) {
    const int i = tid + u * THREADS;
    qin[u] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (i < nq4) qin[u] = *reinterpret_cast<const float4*>(query + n0 * Hq + 4 * (size_t)i);
  }
  bf16 vin = __float2bfloat16(0.f);
  if (!DOT && tid < A) vin = vatt[tid];
  float bin[SPT], min_[SPT];
#pragma unroll
  for (int u = 0; u < SPT; ++u) {
    const int s = tid + u * THREADS;
    bin[u] = min_[u] = 0.f;
    if (s < S) {
      bin[u] = bias[(size_t)b * S + s];
      min_[u] = mask[(size_t)b * S + s];
    }
  }

  // copy group 0: wq's columns of this CTA's q groups; group 1: the key chunk
  // (16-byte cp.async; the value columns go in flight once q is out)
  using mma_attn::cp_async16;
  #pragma unroll 1
  for (int i = tid; i < Hq * 2 * nqg; i += THREADS) {
    const int k = i / (2 * nqg), cc = i % (2 * nqg);
    cp_async16(wq_s + (size_t)k * lay.pw + 8 * cc, wq + (size_t)k * A + 16 * qg0 + 8 * cc, true);
  }
  mma_attn::cp_async_commit();
  if constexpr (DOT) {
    bf16* k_s = reinterpret_cast<bf16*>(gsm + lay.keys);
    const bf16* kr = static_cast<const bf16*>(keys_in) + ((size_t)b * S + s0) * A;
    #pragma unroll 1
    for (int i = tid; i < lay.SCP * (A / 8); i += THREADS) {
      const int j = i / (A / 8), cc = i % (A / 8);
      const bool ok = j < nS;
      cp_async16(k_s + (size_t)j * lay.pk + 8 * cc, kr + (size_t)(ok ? j : 0) * A + 8 * cc, ok);
    }
  } else {
    float* k_s = reinterpret_cast<float*>(gsm + lay.keys);
    const float* kr = static_cast<const float*>(keys_in) + ((size_t)b * S + s0) * A;
    #pragma unroll 1
    for (int i = tid; i < nS * A / 4; i += THREADS) cp_async16(k_s + 4 * i, kr + 4 * i, true);
  }
  mma_attn::cp_async_commit();

  // bf16(query) (rows past W zero; more than QL float4s a thread in passes),
  // v, and the zero rows of bf16(q) (Luong) and of P
  if (nqg > 0) {
    const uint4 z = make_uint4(0u, 0u, 0u, 0u);
    for (int i = tid; i < (16 - W) * Hq / 8; i += THREADS)
      *reinterpret_cast<uint4*>(qa + (size_t)(W + i / (Hq / 8)) * lay.pq + 8 * (i % (Hq / 8))) = z;
    for (int base = 0; base < nq4; base += QL * THREADS) {
#pragma unroll
      for (int u = 0; u < QL; ++u) {
        const int i = base + tid + u * THREADS;
        if (i >= nq4) continue;
        if (base > 0) qin[u] = *reinterpret_cast<const float4*>(query + n0 * Hq + 4 * (size_t)i);
        const int w = 4 * i / Hq, k = 4 * i % Hq;
        uint2 h;
        h.x = mma_attn::pack_bf16(qin[u].x, qin[u].y);
        h.y = mma_attn::pack_bf16(qin[u].z, qin[u].w);
        *reinterpret_cast<uint2*>(qa + (size_t)w * lay.pq + k) = h;
      }
    }
  }
  if constexpr (DOT) {
    bf16* qb = reinterpret_cast<bf16*>(gsm + lay.qx);
    for (int i = tid; i < (16 - W) * lay.pk / 8; i += THREADS)
      reinterpret_cast<uint4*>(qb + (size_t)W * lay.pk)[i] = make_uint4(0u, 0u, 0u, 0u);
  } else {
    float* v_s = reinterpret_cast<float*>(gsm + lay.v);
    for (int a = tid; a < A; a += THREADS) v_s[a] = __bfloat162float(a == tid ? vin : vatt[a]);
  }
  #pragma unroll 1
  for (int i = tid; i < 16 * lay.pp / 8; i += THREADS)
    reinterpret_cast<uint4*>(p_s)[i] = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
  for (int u = 0; u < SPT; ++u) {
    const int s = tid + u * THREADS;
    if (s < S) {
      bias_s[s] = bin[u];
      mask_s[s] = min_[u];
    }
  }

  // 1. q: this CTA's columns for the W queries, then into every CTA
  mma_attn::cp_async_wait<1>();
  __syncthreads();
  if (nqg > 0)
    strip_product(
        nqg, Hq / 16, W, part,
        [&](uint32_t (&a)[4], int kd) { load_a(a, qa, lay.pq, 0, 16 * kd, lane); },
        [&](uint32_t (&bb)[4], int g, int kd) { load_bt(bb, wq_s, lay.pw, 16 * kd, 16 * g, lane); },
        [&](int w, int j, float x0, float x1) {
          const int a = 16 * qg0 + j;
          if constexpr (DOT)
            *reinterpret_cast<uint32_t*>(reinterpret_cast<bf16*>(gsm + lay.qx) + w * lay.pk + a) =
                mma_attn::pack_bf16(x0, x1);
          else
            *reinterpret_cast<float2*>(reinterpret_cast<float*>(gsm + lay.qx) + w * A + a) =
                make_float2(x0, x1);
        });
  cluster_ptx::cluster_wait();  // every CTA of the cluster runs, its barriers armed
  if (nqg > 0) {
    // a row's 16 nqg columns are 4 nqg fp32 chunks (Luong: 2 nqg bf16 chunks)
    const int cpr = DOT ? 2 * nqg : 4 * nqg;
    to_peers(gsm + lay.qx, W * cpr, C, r, &bars[0], [&](int i) {
      const int w = i / cpr, f = i % cpr;
      return DOT ? 2 * (w * lay.pk + 16 * qg0 + 8 * f) : 4 * (w * A + 16 * qg0 + 4 * f);
    });
  }
  // group 2: this CTA's value columns of every key (rows past S zero)
  #pragma unroll 1
  for (int i = tid; i < lay.S_pad * 2 * nvg; i += THREADS) {
    const int j = i / (2 * nvg), cc = i % (2 * nvg);
    const bool ok = j < S;
    cp_async16(vals + (size_t)j * lay.pv + 8 * cc,
               values + ((size_t)b * S + (ok ? j : 0)) * Dv + 16 * vg0 + 8 * cc, ok);
  }
  mma_attn::cp_async_commit();
  mma_attn::cp_async_wait<1>();
  cluster_ptx::mbar_wait(&bars[0], 0);  // every CTA's q columns
  __syncthreads();

  // 2. the scores of the key chunk for the W queries, then into every CTA
  if constexpr (DOT) {
    const bf16* qb = reinterpret_cast<const bf16*>(gsm + lay.qx);
    const bf16* k_s = reinterpret_cast<const bf16*>(gsm + lay.keys);
    strip_product(
        lay.SCP / 16, A / 16, W, part,
        [&](uint32_t (&a)[4], int kd) { load_a(a, qb, lay.pk, 0, 16 * kd, lane); },
        [&](uint32_t (&bb)[4], int g, int kd) { load_b(bb, k_s, lay.pk, 16 * g, 16 * kd, lane); },
        [&](int w, int j, float x0, float x1) {
          if (j < nS) sc_s[(s0 + j) * lay.Wp + w] = x0 + bias_s[s0 + j];
          if (j + 1 < nS) sc_s[(s0 + j + 1) * lay.Wp + w] = x1 + bias_s[s0 + j + 1];
        });
  } else {
    // a warp a key, each lane a float4 of it against every query (MAX_W sums
    // a lane, halved over the warp by warp_sums)
    const float* q_s = reinterpret_cast<const float*>(gsm + lay.qx);
    const float* k_s = reinterpret_cast<const float*>(gsm + lay.keys);
    float* ek = reinterpret_cast<float*>(gsm + lay.ek);
    float* eq = reinterpret_cast<float*>(gsm + lay.eq);
    const float* v_s = reinterpret_cast<const float*>(gsm + lay.v);
    bool small = true;
#pragma unroll 1
    for (int i = tid; i < nS * A; i += THREADS) {
      small &= fabsf(k_s[i]) <= EXP_RANGE;
      ek[i] = expf(2.f * k_s[i]);
    }
#pragma unroll 1
    for (int i = tid; i < W * A; i += THREADS) {
      small &= fabsf(q_s[i]) <= EXP_RANGE;
      eq[i] = expf(2.f * q_s[i]);
    }
    if (__syncthreads_and(small))
      additive_scores(ek, eq, v_s, bias_s, sc_s, nS, s0, W, lay.Wp, A);
    else
      additive_scores_tanh(k_s, q_s, v_s, bias_s, sc_s, nS, s0, W, lay.Wp, A);
  }
  __syncthreads();
  // the chunk's rows of sc are contiguous: nS Wp / 4 chunks of 16 bytes
  to_peers(gsm + lay.sc, nS * lay.Wp / 4, C, r, &bars[1],
           [&](int i) { return 4 * (s0 * lay.Wp + 4 * i); });
  mma_attn::cp_async_wait<0>();
  cluster_ptx::mbar_wait(&bars[1], 0);  // every CTA's scores
  // this CTA has received everything the others send it: the cluster's
  // closing barrier (waited at the end) keeps every CTA resident until all
  // of them have
  cluster_arrive_relaxed();
  __syncthreads();

  // 3. the softmax of each query over all S scores (the same bits in every
  // CTA), queries warp and warp + WARPS of a warp; this CTA writes its
  // chunk's weights
  {
    constexpr int NQ = (MAX_W + WARPS - 1) / WARPS;
    int wq_[NQ];
    bool live[NQ];
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      live[q] = warp + q * WARPS < W;
      wq_[q] = live[q] ? warp + q * WARPS : 0;
    }
    if (S <= 256)
      softmax_queries<NQ, true>(sc_s, mask_s, lay.Wp, S, wq_, live, weights, n0, s0, s0 + nS,
                                p_s, lay.pp);
    else
      softmax_queries<NQ, false>(sc_s, mask_s, lay.Wp, S, wq_, live, weights, n0, s0, s0 + nS,
                                 p_s, lay.pp);
  }
  __syncthreads();

  // 4. the context of this CTA's value columns
  if (nvg > 0)
    strip_product(
        nvg, lay.S_pad / 16, W, part,
        [&](uint32_t (&a)[4], int kd) { load_a(a, p_s, lay.pp, 0, 16 * kd, lane); },
        [&](uint32_t (&bb)[4], int g, int kd) { load_bt(bb, vals, lay.pv, 16 * kd, 16 * g, lane); },
        [&](int w, int j, float x0, float x1) {
          *reinterpret_cast<float2*>(ctx + (n0 + w) * Dv + 16 * vg0 + j) = make_float2(x0, x1);
        });
  cluster_ptx::cluster_wait();
}

}  // namespace attend_grouped
}  // namespace

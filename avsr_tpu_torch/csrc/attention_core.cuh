// Multi-head attention on CUDA-core FMAs, forward and backward, at any head
// widths that are multiples of 8: the family that runs K4 (the fusion core,
// avsr_tpu/models/fusion.py:226-235), K5 (the teacher-forced decoder
// attention, avsr_tpu/models/transformer_decoder.py:335-373) and K11 (the
// encoder self attention, avsr_tpu/models/transformer.py:204-224) at the
// widths attention_mma.cuh's tensor-core kernels are not built for
// (kernels.attention_family routes by width; the presets' widths all have
// tensor-core instances), and K4's and K5's fp32 instances at every width.
// The mask is attention_mma.cuh's functor (LengthMask, CausalMask,
// BiasMask; at(b) gives utterance b's additive mask (i, j) -> float).
//
// Templated on the element type E of q, k, v, ctx and the gradients.  Under
// the bf16 policy (E = bf16):
//
//   s[i, j]  = float(bf16(q_i . k_j)) / sqrt(A) + mask(b, i, j)
//   P[i, :]  = softmax(s[i, :])                       (fp32)
//   ctx[i]   = bf16(sum_j bf16(P[i, j]) * v_j)        (fp32 accumulate)
//
// Under the fp32 policy (E = fp32, train.compute_dtype = "float32", the
// TF1 reference's full precision) the same lines with every bf16 rounding
// point the identity (Elem<float>::round): fp32 operands, fp32 products,
// fp32 FMA sums.  The mask constants are the bf16 policy's.
//
// The mask is ADDED, as in the JAX reference, never used to skip a key, so
// a row whose every key is masked gets the reference's uniform softmax.
// Backward, with the rounding points of JAX's autodiff of that reference
// (the mask enters only through P, whose masked entries are exactly 0):
//
//   dP  = E(dctx @ V^T);  dS = P * (dP - rowsum(dP * P))
//   dsc = E(dS / sqrt(A))
//   dQ  = E(dsc @ K);  dK = E(dsc^T @ Q);  dV = E(E(P)^T @ dctx)
//
// Its residual is the fp32 weights P, which the forward writes when asked
// (K4's alignments always), not attention_mma.cuh's row statistics.
//
// Layouts: q [B, Ta, nh, A], k [B, Tv, nh, A], v [B, Tv, nh, dv], ctx
// [B, Ta, nh, dv] (E); P [B, nh, Ta, Tv] (fp32).  Both launches take q, k
// and v as strided views (the row of time step t of utterance b starts ld
// elements after the row of t - 1; K11 reads them in place from its
// [B, T, 3, nh, dh] product), and the backward writes dq, dk and dv the
// same way.
//
// What bounds it on an H100: the CUDA cores' FMA rate (67 TFLOP/s fp32)
// and, beneath it, shared memory's issue rate: every product reads one
// operand from shared memory per FMA or pair of FMAs.  Design, forward: one
// block per (b, h, tile of QT = 16 queries); the tile's queries in shared
// memory, the keys of that (b, h) streamed through it in chunks of CH = 64
// rows transposed to 32-bit words [A words][CH] (a word is a bf16 pair or
// one fp32 value), so a thread owning one key reads its word with no bank
// conflict while the queries' words are broadcast (each thread a key and
// QT / 4 of the queries, the block's 256 threads over 64 keys); the scores
// of the whole row sit in shared memory through the softmax (one warp per
// row); then the values stream through the same buffer in chunks of CH
// rows for the P.V product (a thread owns 4 queries x 2 channels), its
// fp32 sums carried over the chunks in shared memory.  Backward, two launches.  Pass 1, per
// (b, h, query tile): dP against V (chunks staged transposed), the softmax
// backward in shared memory, dsc written to an E scratch [B, nh, Ta, Tv],
// then dQ against K's chunks.  Pass 2, per (b, h, tile of KT = 16 keys):
// the tile's dsc / P columns over all Ta queries in shared memory, Q and
// dctx streamed in chunks of CH rows, dK and dV summed over all queries
// inside the block.  Each output row has one owner block, and each sum
// runs over the keys (or queries) in order, chunk after chunk: no atomics,
// the same bits every run, and the bf16 instance's bits those of the
// whole-row staging it replaced.  Shared memory holds the scores' rows
// (QT Tv fp32; the backward's KT Ta twice) and one chunk: K4's fp32
// instance at its 16 s limits (T_a = 531, T_v = 401, A = dv = 128) asks for
// 148 KB (pass 2), K5's cross at (128, 256) over 150 labels 142 KB;
// attn_smem gives the largest of the three launches and the wrappers raise
// with the numbers past the card's limit.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {
namespace core_attn {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int QT = 16;  // queries per block (forward, backward pass 1)
constexpr int KT = 16;  // keys per block (backward pass 2)
constexpr int CH = 64;  // rows of the streamed operand a chunk
constexpr int QG = THREADS / CH;  // thread groups of the score products, QT / QG rows each
static_assert(THREADS % CH == 0 && QT % QG == 0, "the score products' thread layout");

__device__ __forceinline__ float bf_lo(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float bf_hi(uint32_t v) { return __uint_as_float(v & 0xffff0000u); }

// The element type's 32-bit words and rounding points.
template <typename E> struct Elem;
template <> struct Elem<__nv_bfloat16> {
  static constexpr int PER_WORD = 2;  // elements a 32-bit word
  __device__ static float round(float x) { return __bfloat162float(__float2bfloat16(x)); }
  __device__ static float get(__nv_bfloat16 x) { return __bfloat162float(x); }
  __device__ static __nv_bfloat16 put(float x) { return __float2bfloat16(x); }
  // acc + a . b over the word's elements, low one first
  __device__ static float fma_word(uint32_t a, uint32_t b, float acc) {
    acc = fmaf(bf_lo(a), bf_lo(b), acc);
    return fmaf(bf_hi(a), bf_hi(b), acc);
  }
  __device__ static float2 pair(const __nv_bfloat16* row, int cp) {
    const uint32_t w = reinterpret_cast<const uint32_t*>(row)[cp];
    return make_float2(bf_lo(w), bf_hi(w));
  }
  __device__ static void store_pair(__nv_bfloat16* row, int cp, float a0, float a1) {
    reinterpret_cast<__nv_bfloat162*>(row)[cp] = __floats2bfloat162_rn(a0, a1);
  }
};
template <> struct Elem<float> {
  static constexpr int PER_WORD = 1;
  __device__ static float round(float x) { return x; }
  __device__ static float get(float x) { return x; }
  __device__ static float put(float x) { return x; }
  __device__ static float fma_word(uint32_t a, uint32_t b, float acc) {
    return fmaf(__uint_as_float(a), __uint_as_float(b), acc);
  }
  __device__ static float2 pair(const float* row, int cp) {
    return reinterpret_cast<const float2*>(row)[cp];
  }
  __device__ static void store_pair(float* row, int cp, float a0, float a1) {
    reinterpret_cast<float2*>(row)[cp] = make_float2(a0, a1);
  }
};

// rows [0, n_rows) of `row_elems` elements each, at `stride` elements apart
// in device memory, into contiguous shared rows; rows >= n_valid are zero.
template <typename E>
__device__ void stage_rows(E* dst, const E* src, int n_rows, int n_valid, int row_elems,
                           size_t stride) {
  const int cpr = row_elems * (int)sizeof(E) / 16;
  for (int c = threadIdx.x; c < n_rows * cpr; c += THREADS) {
    const int r = c / cpr, cc = c - r * cpr;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r < n_valid) v = reinterpret_cast<const uint4*>(src + (size_t)r * stride)[cc];
    reinterpret_cast<uint4*>(dst + (size_t)r * row_elems)[cc] = v;
  }
}

// the same rows transposed into 32-bit words: dst[p * col_stride + r] holds
// word p of row r (elements 2p, 2p+1 in bf16, element p in fp32).
// Neighbouring threads take neighbouring rows, so a warp's stores fall in
// distinct banks.
template <typename E>
__device__ void stage_cols(uint32_t* dst, const E* src, int n_rows, int row_elems, size_t stride,
                           int col_stride) {
  const int cpr = row_elems * (int)sizeof(E) / 16;
  for (int c = threadIdx.x; c < n_rows * cpr; c += THREADS) {
    const int cc = c / n_rows, r = c - cc * n_rows;
    const uint4 v = reinterpret_cast<const uint4*>(src + (size_t)r * stride)[cc];
    const int p = 4 * cc;
    dst[(size_t)(p + 0) * col_stride + r] = v.x;
    dst[(size_t)(p + 1) * col_stride + r] = v.y;
    dst[(size_t)(p + 2) * col_stride + r] = v.z;
    dst[(size_t)(p + 3) * col_stride + r] = v.w;
  }
}

// out[i][j] = sum over the depth of rows[i] . colsT[.][j] for the QT rows and
// every j < n_cols <= CH (colsT's words col_stride apart): the score-like
// products of both kernels.  Thread t takes column j = t % CH for the QT /
// QG rows of group t / CH: a warp's column words are consecutive and its
// row words one broadcast.
template <typename E, typename Epi>
__device__ __forceinline__ void rows_by_cols(const E* rows_s, const uint32_t* colsT_s, int n_cols,
                                             int col_stride, int depth, Epi epi) {
  constexpr int R = QT / QG;
  const uint32_t* rq = reinterpret_cast<const uint32_t*>(rows_s);
  const int np = depth / Elem<E>::PER_WORD;
  const int j = threadIdx.x % CH, i0 = threadIdx.x / CH * R;
  if (j >= n_cols) return;
  float acc[R];
#pragma unroll
  for (int i = 0; i < R; ++i) acc[i] = 0.f;
  for (int p = 0; p < np; ++p) {
    const uint32_t kk = colsT_s[(size_t)p * col_stride + j];
#pragma unroll
    for (int i = 0; i < R; ++i) acc[i] = Elem<E>::fma_word(rq[(i0 + i) * np + p], kk, acc[i]);
  }
#pragma unroll
  for (int i = 0; i < R; ++i) epi(i0 + i, j, acc[i]);
}

// acc_s[i][2c..2c+1] (+)= sum_j w_s[i * wstride + j] * mat_s[j][2c..2c+1]
// for the rows of w_s in groups of 4 (n_rows of them, rounded up) and
// j < n, starting from 0 where `first`; a thread owns 4 rows x 2 channels.
// acc_s is [16][width] fp32: the sums carried from chunk to chunk.
template <typename E>
__device__ __forceinline__ void weights_by_rows(const float* w_s, int wstride, int n_rows,
                                                const E* mat_s, int n, int width, float* acc_s,
                                                bool first) {
  const int npair = width / 2;
  const int ngrp = (n_rows + 3) / 4;
  for (int item = threadIdx.x; item < ngrp * npair; item += THREADS) {
    const int grp = item / npair, cp = item - grp * npair;
    float a0[4], a1[4];
#pragma unroll
    for (int ii = 0; ii < 4; ++ii) {
      float* acc = acc_s + (size_t)(grp * 4 + ii) * width + 2 * cp;
      a0[ii] = first ? 0.f : acc[0];
      a1[ii] = first ? 0.f : acc[1];
    }
    for (int j = 0; j < n; ++j) {
      const float2 vv = Elem<E>::pair(mat_s + (size_t)j * width, cp);
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
        const float w = w_s[(size_t)(grp * 4 + ii) * wstride + j];
        a0[ii] = fmaf(w, vv.x, a0[ii]);
        a1[ii] = fmaf(w, vv.y, a1[ii]);
      }
    }
#pragma unroll
    for (int ii = 0; ii < 4; ++ii) {
      float* acc = acc_s + (size_t)(grp * 4 + ii) * width + 2 * cp;
      acc[0] = a0[ii];
      acc[1] = a1[ii];
    }
  }
}

// rows i < n_rows of acc_s ([16][width] fp32) to out_row(i), rounded to E
template <typename E, typename Row>
__device__ __forceinline__ void store_rows(const float* acc_s, int n_rows, int width, Row out_row) {
  const int npair = width / 2;
  for (int item = threadIdx.x; item < n_rows * npair; item += THREADS) {
    const int i = item / npair, cp = item - i * npair;
    const float* acc = acc_s + (size_t)i * width + 2 * cp;
    Elem<E>::store_pair(out_row(i), cp, acc[0], acc[1]);
  }
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Forward.  `mask.at(b)(i, j)` is the additive mask of query i and key j
// of utterance b; P may be null (no backward wanted: the weights stay in
// shared memory).
template <typename E, typename Mask>
__global__ void __launch_bounds__(THREADS)
attn_fwd_kernel(const E* __restrict__ q,   // [B, Ta, nh, A], rows ldq apart
                const E* __restrict__ k,   // [B, Tv, nh, A], rows ldk apart
                const E* __restrict__ v,   // [B, Tv, nh, dv], rows ldv apart
                Mask mask,
                float* __restrict__ P,     // [B, nh, Ta, Tv] or null
                E* __restrict__ ctx,       // [B, Ta, nh, dv]
                int Ta, int Tv, int nh, int A, int dv, int ldq, int ldk, int ldv) {
  using X = Elem<E>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.z, h = blockIdx.y, i0 = blockIdx.x * QT;
  const int nq = min(QT, Ta - i0);
  const int width = max(A, dv);
  E* kv_s = reinterpret_cast<E*>(smem);                      // a chunk: K^T words, then V
  E* q_s = kv_s + (size_t)CH * width;                        // [QT][A]
  float* s_s = reinterpret_cast<float*>(q_s + (size_t)QT * A);  // [QT][Tv]
  float* acc_s = s_s + (size_t)QT * Tv;                       // [QT][dv]

  stage_rows(q_s, q + ((size_t)b * Ta + i0) * ldq + (size_t)h * A, QT, nq, A, (size_t)ldq);
  const float sq = sqrtf((float)A);
  const auto m = mask.at(b);
  for (int c0 = 0; c0 < Tv; c0 += CH) {
    const int kc = min(CH, Tv - c0);
    stage_cols(reinterpret_cast<uint32_t*>(kv_s),
               k + ((size_t)b * Tv + c0) * ldk + (size_t)h * A, kc, A, (size_t)ldk, CH);
    __syncthreads();
    rows_by_cols(q_s, reinterpret_cast<const uint32_t*>(kv_s), kc, CH, A,
                 [&](int i, int j, float acc) {
                   s_s[i * Tv + c0 + j] = X::round(acc) / sq + m(i0 + i, c0 + j);
                 });
    __syncthreads();
  }

  // fp32 softmax per query row, one warp per row; P out in fp32, E(P) kept
  // for the P.V product.
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int i = warp; i < QT; i += WARPS) {
    float* row = s_s + i * Tv;
    if (i >= nq) {
      for (int j = lane; j < Tv; j += 32) row[j] = 0.f;
      continue;
    }
    float mx = __int_as_float(0xff800000u);  // -inf
    for (int j = lane; j < Tv; j += 32) mx = fmaxf(mx, row[j]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < Tv; j += 32) {
      const float e = expf(row[j] - mx);
      row[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    float* out = P ? P + (((size_t)b * nh + h) * Ta + i0 + i) * Tv : nullptr;
    for (int j = lane; j < Tv; j += 32) {
      const float p = row[j] / sum;
      if (out) out[j] = p;
      row[j] = X::round(p);
    }
  }
  __syncthreads();

  for (int c0 = 0; c0 < Tv; c0 += CH) {
    const int kc = min(CH, Tv - c0);
    stage_rows(kv_s, v + ((size_t)b * Tv + c0) * ldv + (size_t)h * dv, kc, kc, dv, (size_t)ldv);
    __syncthreads();
    weights_by_rows(s_s + c0, Tv, nq, kv_s, kc, dv, acc_s, c0 == 0);
    __syncthreads();
  }
  store_rows<E>(acc_s, nq, dv, [&](int i) { return ctx + (((size_t)b * Ta + i0 + i) * nh + h) * dv; });
}

// Backward pass 1: dsc rows and dQ for one (b, h, query tile).
template <typename E>
__global__ void __launch_bounds__(THREADS)
attn_bwd_q_kernel(const E* __restrict__ k,         // [B, Tv, nh, A], rows ldk apart
                  const E* __restrict__ v,         // [B, Tv, nh, dv], rows ldv apart
                  const float* __restrict__ P,     // [B, nh, Ta, Tv]
                  const E* __restrict__ dctx,      // [B, Ta, nh, dv]
                  E* __restrict__ dsc,             // [B, nh, Ta, Tv] scratch
                  E* __restrict__ dq,              // [B, Ta, nh, A], rows lddq apart
                  int Ta, int Tv, int nh, int A, int dv, int ldk, int ldv, int lddq) {
  using X = Elem<E>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.z, h = blockIdx.y, i0 = blockIdx.x * QT;
  const int nq = min(QT, Ta - i0);
  const int width = max(A, dv);
  E* kv_s = reinterpret_cast<E*>(smem);                        // a chunk: V^T words, then K
  E* do_s = kv_s + (size_t)CH * width;                         // [QT][dv]
  float* s_s = reinterpret_cast<float*>(do_s + (size_t)QT * dv);  // [QT][Tv]
  float* acc_s = s_s + (size_t)QT * Tv;                         // [QT][A]

  stage_rows(do_s, dctx + (((size_t)b * Ta + i0) * nh + h) * dv, QT, nq, dv, (size_t)nh * dv);
  for (int c0 = 0; c0 < Tv; c0 += CH) {
    const int kc = min(CH, Tv - c0);
    stage_cols(reinterpret_cast<uint32_t*>(kv_s),
               v + ((size_t)b * Tv + c0) * ldv + (size_t)h * dv, kc, dv, (size_t)ldv, CH);
    __syncthreads();
    rows_by_cols(do_s, reinterpret_cast<const uint32_t*>(kv_s), kc, CH, dv,
                 [&](int i, int j, float acc) { s_s[i * Tv + c0 + j] = X::round(acc); });
    __syncthreads();
  }

  // softmax backward, one warp per row; rows >= nq stay zero (dctx was 0).
  const float sq = sqrtf((float)A);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int i = warp; i < nq; i += WARPS) {
    float* row = s_s + i * Tv;
    const float* prow = P + (((size_t)b * nh + h) * Ta + i0 + i) * Tv;
    float rs = 0.f;
    for (int j = lane; j < Tv; j += 32) rs += row[j] * prow[j];
    rs = warp_sum(rs);
    E* out = dsc + (((size_t)b * nh + h) * Ta + i0 + i) * Tv;
    for (int j = lane; j < Tv; j += 32) {
      const E d = X::put(prow[j] * (row[j] - rs) / sq);
      out[j] = d;
      row[j] = X::get(d);
    }
  }
  __syncthreads();

  for (int c0 = 0; c0 < Tv; c0 += CH) {
    const int kc = min(CH, Tv - c0);
    stage_rows(kv_s, k + ((size_t)b * Tv + c0) * ldk + (size_t)h * A, kc, kc, A, (size_t)ldk);
    __syncthreads();
    weights_by_rows(s_s + c0, Tv, nq, kv_s, kc, A, acc_s, c0 == 0);
    __syncthreads();
  }
  store_rows<E>(acc_s, nq, A, [&](int i) { return dq + ((size_t)b * Ta + i0 + i) * lddq + (size_t)h * A; });
}

// Backward pass 2: dK and dV rows for one (b, h, key tile), summed over
// every query of the utterance.
template <typename E>
__global__ void __launch_bounds__(THREADS)
attn_bwd_kv_kernel(const E* __restrict__ q,         // [B, Ta, nh, A], rows ldq apart
                   const float* __restrict__ P,     // [B, nh, Ta, Tv]
                   const E* __restrict__ dctx,      // [B, Ta, nh, dv]
                   const E* __restrict__ dsc,       // [B, nh, Ta, Tv]
                   E* __restrict__ dk,              // [B, Tv, nh, A], rows lddk apart
                   E* __restrict__ dv_out,          // [B, Tv, nh, dv], rows lddv apart
                   int Ta, int Tv, int nh, int A, int dv, int ldq, int lddk, int lddv) {
  using X = Elem<E>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.z, h = blockIdx.y, j0 = blockIdx.x * KT;
  const int nk = min(KT, Tv - j0);
  E* q_s = reinterpret_cast<E*>(smem);                            // a chunk [CH][A]
  E* do_s = q_s + (size_t)CH * A;                                 // a chunk [CH][dv]
  float* dsT_s = reinterpret_cast<float*>(do_s + (size_t)CH * dv);  // [KT][Ta]
  float* pT_s = dsT_s + (size_t)KT * Ta;                              // [KT][Ta]
  float* acck_s = pT_s + (size_t)KT * Ta;                             // [KT][A]
  float* accv_s = acck_s + (size_t)KT * A;                            // [KT][dv]

  const size_t col0 = (((size_t)b * nh + h) * Ta) * Tv + j0;
  for (int c = threadIdx.x; c < KT * Ta; c += THREADS) {
    const int i = c / KT, jj = c - i * KT;  // neighbouring threads on neighbouring keys
    float d = 0.f, p = 0.f;
    if (jj < nk) {
      d = X::get(dsc[col0 + (size_t)i * Tv + jj]);
      p = X::round(P[col0 + (size_t)i * Tv + jj]);
    }
    dsT_s[jj * Ta + i] = d;
    pT_s[jj * Ta + i] = p;
  }
  for (int c0 = 0; c0 < Ta; c0 += CH) {
    const int qc = min(CH, Ta - c0);
    stage_rows(q_s, q + ((size_t)b * Ta + c0) * ldq + (size_t)h * A, qc, qc, A, (size_t)ldq);
    stage_rows(do_s, dctx + (((size_t)b * Ta + c0) * nh + h) * dv, qc, qc, dv, (size_t)nh * dv);
    __syncthreads();
    weights_by_rows(dsT_s + c0, Ta, nk, q_s, qc, A, acck_s, c0 == 0);
    weights_by_rows(pT_s + c0, Ta, nk, do_s, qc, dv, accv_s, c0 == 0);
    __syncthreads();
  }
  store_rows<E>(acck_s, nk, A,
                [&](int jj) { return dk + ((size_t)b * Tv + j0 + jj) * lddk + (size_t)h * A; });
  store_rows<E>(accv_s, nk, dv,
                [&](int jj) { return dv_out + ((size_t)b * Tv + j0 + jj) * lddv + (size_t)h * dv; });
}

size_t fwd_smem(int Tv, int A, int dv, size_t es) {
  return (size_t)CH * (A > dv ? A : dv) * es + (size_t)QT * A * es + (size_t)QT * Tv * 4 +
         (size_t)QT * dv * 4;
}
size_t bwd_q_smem(int Tv, int A, int dv, size_t es) {
  return (size_t)CH * (A > dv ? A : dv) * es + (size_t)QT * dv * es + (size_t)QT * Tv * 4 +
         (size_t)QT * A * 4;
}
size_t bwd_kv_smem(int Ta, int A, int dv, size_t es) {
  return (size_t)CH * (A + dv) * es + (size_t)2 * KT * Ta * 4 + (size_t)KT * (A + dv) * 4;
}

// the largest shared-memory request of the three launches at element size es
size_t attn_smem(int Ta, int Tv, int A, int dv, size_t es) {
  size_t m = fwd_smem(Tv, A, dv, es);
  if (bwd_q_smem(Tv, A, dv, es) > m) m = bwd_q_smem(Tv, A, dv, es);
  if (bwd_kv_smem(Ta, A, dv, es) > m) m = bwd_kv_smem(Ta, A, dv, es);
  return m;
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// The forward over E operands q, k, v rows ld* elements apart (nh * A, nh *
// A and nh * dv for contiguous operands; multiples of 8, as the 16-byte
// staging loads need).
template <typename E, typename Mask>
cudaError_t launch_attn_fwd(const void* q, const void* k, const void* v, Mask mask, void* P,
                            void* ctx, int B, int Ta, int Tv, int nh, int A, int dv, int ldq,
                            int ldk, int ldv, cudaStream_t stream) {
  if (A % 8 || dv % 8 || Ta < 1 || Tv < 1 || ldq % 8 || ldk % 8 || ldv % 8)
    return cudaErrorInvalidValue;
  const size_t smem = fwd_smem(Tv, A, dv, sizeof(E));
  cudaError_t e = core_attn::allow_smem(attn_fwd_kernel<E, Mask>, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((Ta + QT - 1) / QT, nh, B);
  attn_fwd_kernel<E, Mask><<<grid, THREADS, smem, stream>>>(
      static_cast<const E*>(q), static_cast<const E*>(k), static_cast<const E*>(v), mask,
      static_cast<float*>(P), static_cast<E*>(ctx), Ta, Tv, nh, A, dv, ldq, ldk, ldv);
  return cudaGetLastError();
}

// The backward, reading q, k, v rows ld* elements apart as the forward does
// and writing dq, dk, dv rows ldd* elements apart (nh * A, nh * A and nh *
// dv for contiguous gradients; even, as the paired stores need); dsc an E
// scratch [B, nh, Ta, Tv].
template <typename E>
cudaError_t launch_attn_bwd(const void* q, const void* k, const void* v, const void* P,
                            const void* dctx, void* dsc, void* dq, void* dk, void* dv_out,
                            int B, int Ta, int Tv, int nh, int A, int dv, int ldq, int ldk,
                            int ldv, int lddq, int lddk, int lddv, cudaStream_t stream) {
  if (A % 8 || dv % 8 || Ta < 1 || Tv < 1 || ldq % 8 || ldk % 8 || ldv % 8 || lddq % 2 ||
      lddk % 2 || lddv % 2)
    return cudaErrorInvalidValue;
  const size_t smem_q = bwd_q_smem(Tv, A, dv, sizeof(E));
  const size_t smem_kv = bwd_kv_smem(Ta, A, dv, sizeof(E));
  cudaError_t e = allow_smem(attn_bwd_q_kernel<E>, smem_q);
  if (e != cudaSuccess) return e;
  e = allow_smem(attn_bwd_kv_kernel<E>, smem_kv);
  if (e != cudaSuccess) return e;
  attn_bwd_q_kernel<E><<<dim3((Ta + QT - 1) / QT, nh, B), THREADS, smem_q, stream>>>(
      static_cast<const E*>(k), static_cast<const E*>(v), static_cast<const float*>(P),
      static_cast<const E*>(dctx), static_cast<E*>(dsc), static_cast<E*>(dq), Ta, Tv, nh, A, dv,
      ldk, ldv, lddq);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  attn_bwd_kv_kernel<E><<<dim3((Tv + KT - 1) / KT, nh, B), THREADS, smem_kv, stream>>>(
      static_cast<const E*>(q), static_cast<const float*>(P), static_cast<const E*>(dctx),
      static_cast<const E*>(dsc), static_cast<E*>(dk), static_cast<E*>(dv_out), Ta, Tv, nh, A, dv,
      ldq, lddk, lddv);
  return cudaGetLastError();
}

}  // namespace core_attn
}  // namespace

// K4: the cross-attention fusion core, forward and backward.
//
// Replaces the core of avsr_tpu/models/fusion.py:cross_attention_fusion_apply
// (fusion.py:226-235), which the JAX package leaves to XLA: audio queries
// over video keys and values, per (utterance b, head h), under the bf16
// policy:
//
//   s[i, j]  = float(bf16(q_i . k_j)) / sqrt(A) + (1 - valid_j) * -1e9
//   P[i, :]  = softmax(s[i, :])                       (fp32)
//   ctx[i]   = bf16(sum_j bf16(P[i, j]) * v_j)        (fp32 accumulate)
//
// The key-padding mask is ADDED, as in the reference, so a row whose video
// length is 0 gets the reference's uniform softmax over all T_v keys.  P is
// written out (fp32 [B, nh, T_a, T_v]): the module's head-averaged
// alignments read it, and so does the backward.  The projections, the
// audio mask and the AU head stay matrix products outside.
//
// Backward, with the rounding points of JAX's autodiff of the reference:
//
//   dP  = bf16(dctx @ V^T);  dS = P * (dP - rowsum(dP * P))
//   dsc = bf16(dS / sqrt(A))
//   dQ  = bf16(dsc @ K);  dK = bf16(dsc^T @ Q);  dV = bf16(bf16(P)^T @ dctx)
//
// What bounds it on an H100: at the main path's shapes (B = 128, 4 heads,
// T_a = 50, T_v = 150, A = dv = 128) the whole core is ~1.2 GFLOP forward
// and ~2.5 GFLOP backward over ~40 MB of q/k/v/P traffic: neither the
// tensor cores nor HBM are near their limits, and the time goes to the
// shared-memory issue rate of the products (CUDA-core fp32 FMAs on
// bf16-rounded operands, the reference's numerics) and to launch latency.
// Design, forward: one block per (b, h, tile of QT = 16 queries); K of that
// (b, h) is staged in shared memory transposed to bf16 pairs [A/2][T_v], so
// a thread owning one key reads its pair with no bank conflict while the
// queries' pairs are broadcast; the scores of the tile sit in shared
// memory through the softmax (one warp per row); then V, natural layout,
// replaces K in the same buffer for the P.V product (a thread owns 4
// queries x 2 channels).  Shared memory is T_v*max(A, dv)*2 + QT*A*2 +
// QT*T_v*4 bytes: 52 KB at T_v = 150, 132 KB at the preset's 16 s limit of
// T_v = 400 (the wrapper raises above that).
// Backward, two launches.  Pass 1, per (b, h, query tile): dP against V
// (staged transposed), the softmax backward in shared memory, dsc written
// to a bf16 scratch [B, nh, T_a, T_v], then dQ against K staged in the
// same buffer.  Pass 2, per (b, h, tile of KT = 16 keys): the whole T_a
// range of Q, dctx and the tile's dsc / P columns in shared memory, dK and
// dV summed over all queries inside the block.  Each output row has one
// owner block, so there are no atomics, no zero-fill pass, and the sums
// are taken in a fixed order: the same bits every run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int QT = 16;  // queries per block (forward, backward pass 1)
constexpr int KT = 16;  // keys per block (backward pass 2)

__device__ __forceinline__ float bf_lo(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float bf_hi(uint32_t v) { return __uint_as_float(v & 0xffff0000u); }
__device__ __forceinline__ float bf_round(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// rows [0, n_rows) of `row_elems` bf16 each, at `stride` elements apart in
// device memory, into contiguous shared rows; rows >= n_valid are zero.
__device__ void stage_rows(__nv_bfloat16* dst, const __nv_bfloat16* src, int n_rows,
                           int n_valid, int row_elems, size_t stride) {
  const int cpr = row_elems / 8;
  for (int c = threadIdx.x; c < n_rows * cpr; c += THREADS) {
    const int r = c / cpr, cc = c - r * cpr;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r < n_valid) v = reinterpret_cast<const uint4*>(src + (size_t)r * stride)[cc];
    reinterpret_cast<uint4*>(dst + (size_t)r * row_elems)[cc] = v;
  }
}

// the same rows transposed into bf16 pairs: dst[p * n_rows + r] holds
// elements (2p, 2p+1) of row r.
__device__ void stage_cols(uint32_t* dst, const __nv_bfloat16* src, int n_rows,
                           int row_elems, size_t stride) {
  const int cpr = row_elems / 8;
  for (int c = threadIdx.x; c < n_rows * cpr; c += THREADS) {
    const int r = c / cpr, cc = c - r * cpr;
    const uint4 v = reinterpret_cast<const uint4*>(src + (size_t)r * stride)[cc];
    const int p = 4 * cc;
    dst[(size_t)(p + 0) * n_rows + r] = v.x;
    dst[(size_t)(p + 1) * n_rows + r] = v.y;
    dst[(size_t)(p + 2) * n_rows + r] = v.z;
    dst[(size_t)(p + 3) * n_rows + r] = v.w;
  }
}

// out[i][j] = sum_p rows[i][2p..2p+1] . colsT[p][j] for the QT rows and every
// j < n_cols (one thread per j): the score-like products of both kernels.
template <typename Epi>
__device__ __forceinline__ void rows_by_cols(const __nv_bfloat16* rows_s,
                                             const uint32_t* colsT_s, int n_cols, int depth,
                                             Epi epi) {
  const uint32_t* rq = reinterpret_cast<const uint32_t*>(rows_s);
  const int np = depth / 2;
  for (int j = threadIdx.x; j < n_cols; j += THREADS) {
    float acc[QT];
#pragma unroll
    for (int i = 0; i < QT; ++i) acc[i] = 0.f;
    for (int p = 0; p < np; ++p) {
      const uint32_t kk = colsT_s[(size_t)p * n_cols + j];
      const float k0 = bf_lo(kk), k1 = bf_hi(kk);
#pragma unroll
      for (int i = 0; i < QT; ++i) {
        const uint32_t qq = rq[i * np + p];
        acc[i] = fmaf(bf_lo(qq), k0, acc[i]);
        acc[i] = fmaf(bf_hi(qq), k1, acc[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < QT; ++i) epi(i, j, acc[i]);
  }
}

// out[i][2c..2c+1] = sum_j w_s[i * wstride + j] * mat_s[j][2c..2c+1] for the
// QT rows of w_s and j < n; a thread owns 4 rows x 2 channels.  `store`
// receives (row, channel pair, two sums).
template <typename Store>
__device__ __forceinline__ void weights_by_rows(const float* w_s, int wstride, int n_rows,
                                                const __nv_bfloat16* mat_s, int n, int width,
                                                Store store) {
  const uint32_t* mv = reinterpret_cast<const uint32_t*>(mat_s);
  const int npair = width / 2;
  const int ngrp = (n_rows + 3) / 4;
  for (int item = threadIdx.x; item < ngrp * npair; item += THREADS) {
    const int grp = item / npair, cp = item - grp * npair;
    float a0[4] = {0.f, 0.f, 0.f, 0.f}, a1[4] = {0.f, 0.f, 0.f, 0.f};
    for (int j = 0; j < n; ++j) {
      const uint32_t vv = mv[(size_t)j * npair + cp];
      const float v0 = bf_lo(vv), v1 = bf_hi(vv);
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
        const float w = w_s[(size_t)(grp * 4 + ii) * wstride + j];
        a0[ii] = fmaf(w, v0, a0[ii]);
        a1[ii] = fmaf(w, v1, a1[ii]);
      }
    }
#pragma unroll
    for (int ii = 0; ii < 4; ++ii)
      if (grp * 4 + ii < n_rows) store(grp * 4 + ii, cp, a0[ii], a1[ii]);
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

__global__ void __launch_bounds__(THREADS)
fusion_fwd_kernel(const __nv_bfloat16* __restrict__ q,   // [B, Ta, nh, A]
                  const __nv_bfloat16* __restrict__ k,   // [B, Tv, nh, A]
                  const __nv_bfloat16* __restrict__ v,   // [B, Tv, nh, dv]
                  const int* __restrict__ vlen,          // [B]
                  float* __restrict__ P,                 // [B, nh, Ta, Tv]
                  __nv_bfloat16* __restrict__ ctx,       // [B, Ta, nh, dv]
                  int Ta, int Tv, int nh, int A, int dv) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.z, h = blockIdx.y, i0 = blockIdx.x * QT;
  const int nq = min(QT, Ta - i0);
  const int width = max(A, dv);
  __nv_bfloat16* kv_s = reinterpret_cast<__nv_bfloat16*>(smem);  // K^T pairs, then V
  __nv_bfloat16* q_s = kv_s + (size_t)Tv * width;                // [QT][A]
  float* s_s = reinterpret_cast<float*>(q_s + (size_t)QT * A);    // [QT][Tv]

  stage_rows(q_s, q + (((size_t)b * Ta + i0) * nh + h) * A, QT, nq, A, (size_t)nh * A);
  stage_cols(reinterpret_cast<uint32_t*>(kv_s), k + ((size_t)b * Tv * nh + h) * A, Tv, A,
             (size_t)nh * A);
  __syncthreads();

  const int len = vlen[b];
  const float sq = sqrtf((float)A);
  rows_by_cols(q_s, reinterpret_cast<const uint32_t*>(kv_s), Tv, A,
               [&](int i, int j, float acc) {
                 const float invalid = j < len ? 0.f : 1.f;
                 s_s[i * Tv + j] = bf_round(acc) / sq + invalid * -1e9f;
               });
  __syncthreads();

  // fp32 softmax per query row, one warp per row; P out in fp32, bf16(P)
  // kept for the P.V product.
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
    float* out = P + (((size_t)b * nh + h) * Ta + i0 + i) * Tv;
    for (int j = lane; j < Tv; j += 32) {
      const float p = row[j] / sum;
      out[j] = p;
      row[j] = bf_round(p);
    }
  }
  __syncthreads();

  stage_rows(kv_s, v + ((size_t)b * Tv * nh + h) * dv, Tv, Tv, dv, (size_t)nh * dv);
  __syncthreads();
  weights_by_rows(s_s, Tv, nq, kv_s, Tv, dv, [&](int i, int cp, float a0, float a1) {
    reinterpret_cast<__nv_bfloat162*>(ctx + (((size_t)b * Ta + i0 + i) * nh + h) * dv)[cp] =
        __floats2bfloat162_rn(a0, a1);
  });
}

// Backward pass 1: dsc rows and dQ for one (b, h, query tile).
__global__ void __launch_bounds__(THREADS)
fusion_bwd_q_kernel(const __nv_bfloat16* __restrict__ k,     // [B, Tv, nh, A]
                    const __nv_bfloat16* __restrict__ v,     // [B, Tv, nh, dv]
                    const float* __restrict__ P,             // [B, nh, Ta, Tv]
                    const __nv_bfloat16* __restrict__ dctx,  // [B, Ta, nh, dv]
                    __nv_bfloat16* __restrict__ dsc,         // [B, nh, Ta, Tv] scratch
                    __nv_bfloat16* __restrict__ dq,          // [B, Ta, nh, A]
                    int Ta, int Tv, int nh, int A, int dv) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.z, h = blockIdx.y, i0 = blockIdx.x * QT;
  const int nq = min(QT, Ta - i0);
  const int width = max(A, dv);
  __nv_bfloat16* kv_s = reinterpret_cast<__nv_bfloat16*>(smem);  // V^T pairs, then K
  __nv_bfloat16* do_s = kv_s + (size_t)Tv * width;               // [QT][dv]
  float* s_s = reinterpret_cast<float*>(do_s + (size_t)QT * dv);  // [QT][Tv]

  stage_rows(do_s, dctx + (((size_t)b * Ta + i0) * nh + h) * dv, QT, nq, dv,
             (size_t)nh * dv);
  stage_cols(reinterpret_cast<uint32_t*>(kv_s), v + ((size_t)b * Tv * nh + h) * dv, Tv, dv,
             (size_t)nh * dv);
  __syncthreads();
  rows_by_cols(do_s, reinterpret_cast<const uint32_t*>(kv_s), Tv, dv,
               [&](int i, int j, float acc) { s_s[i * Tv + j] = bf_round(acc); });
  __syncthreads();

  // softmax backward, one warp per row; rows >= nq stay zero (dctx was 0).
  const float sq = sqrtf((float)A);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int i = warp; i < nq; i += WARPS) {
    float* row = s_s + i * Tv;
    const float* prow = P + (((size_t)b * nh + h) * Ta + i0 + i) * Tv;
    float rs = 0.f;
    for (int j = lane; j < Tv; j += 32) rs += row[j] * prow[j];
    rs = warp_sum(rs);
    __nv_bfloat16* out = dsc + (((size_t)b * nh + h) * Ta + i0 + i) * Tv;
    for (int j = lane; j < Tv; j += 32) {
      const __nv_bfloat16 d = __float2bfloat16(prow[j] * (row[j] - rs) / sq);
      out[j] = d;
      row[j] = __bfloat162float(d);
    }
  }
  __syncthreads();

  stage_rows(kv_s, k + ((size_t)b * Tv * nh + h) * A, Tv, Tv, A, (size_t)nh * A);
  __syncthreads();
  weights_by_rows(s_s, Tv, nq, kv_s, Tv, A, [&](int i, int cp, float a0, float a1) {
    reinterpret_cast<__nv_bfloat162*>(dq + (((size_t)b * Ta + i0 + i) * nh + h) * A)[cp] =
        __floats2bfloat162_rn(a0, a1);
  });
}

// Backward pass 2: dK and dV rows for one (b, h, key tile), summed over
// every query of the utterance.
__global__ void __launch_bounds__(THREADS)
fusion_bwd_kv_kernel(const __nv_bfloat16* __restrict__ q,     // [B, Ta, nh, A]
                     const float* __restrict__ P,             // [B, nh, Ta, Tv]
                     const __nv_bfloat16* __restrict__ dctx,  // [B, Ta, nh, dv]
                     const __nv_bfloat16* __restrict__ dsc,   // [B, nh, Ta, Tv]
                     __nv_bfloat16* __restrict__ dk,          // [B, Tv, nh, A]
                     __nv_bfloat16* __restrict__ dv_out,      // [B, Tv, nh, dv]
                     int Ta, int Tv, int nh, int A, int dv) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.z, h = blockIdx.y, j0 = blockIdx.x * KT;
  const int nk = min(KT, Tv - j0);
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem);   // [Ta][A]
  __nv_bfloat16* do_s = q_s + (size_t)Ta * A;                    // [Ta][dv]
  float* dsT_s = reinterpret_cast<float*>(do_s + (size_t)Ta * dv);  // [KT][Ta]
  float* pT_s = dsT_s + (size_t)KT * Ta;                              // [KT][Ta]

  stage_rows(q_s, q + ((size_t)b * Ta * nh + h) * A, Ta, Ta, A, (size_t)nh * A);
  stage_rows(do_s, dctx + ((size_t)b * Ta * nh + h) * dv, Ta, Ta, dv, (size_t)nh * dv);
  const size_t col0 = (((size_t)b * nh + h) * Ta) * Tv + j0;
  for (int c = threadIdx.x; c < KT * Ta; c += THREADS) {
    const int i = c / KT, jj = c - i * KT;  // neighbouring threads on neighbouring keys
    float d = 0.f, p = 0.f;
    if (jj < nk) {
      d = __bfloat162float(dsc[col0 + (size_t)i * Tv + jj]);
      p = bf_round(P[col0 + (size_t)i * Tv + jj]);
    }
    dsT_s[jj * Ta + i] = d;
    pT_s[jj * Ta + i] = p;
  }
  __syncthreads();

  weights_by_rows(dsT_s, Ta, nk, q_s, Ta, A, [&](int jj, int cp, float a0, float a1) {
    reinterpret_cast<__nv_bfloat162*>(dk + (((size_t)b * Tv + j0 + jj) * nh + h) * A)[cp] =
        __floats2bfloat162_rn(a0, a1);
  });
  weights_by_rows(pT_s, Ta, nk, do_s, Ta, dv, [&](int jj, int cp, float a0, float a1) {
    reinterpret_cast<__nv_bfloat162*>(dv_out + (((size_t)b * Tv + j0 + jj) * nh + h) * dv)[cp] =
        __floats2bfloat162_rn(a0, a1);
  });
}

size_t fwd_smem(int Tv, int A, int dv) {
  return (size_t)Tv * (A > dv ? A : dv) * 2 + (size_t)QT * A * 2 + (size_t)QT * Tv * 4;
}
size_t bwd_q_smem(int Tv, int A, int dv) {
  return (size_t)Tv * (A > dv ? A : dv) * 2 + (size_t)QT * dv * 2 + (size_t)QT * Tv * 4;
}
size_t bwd_kv_smem(int Ta, int A, int dv) {
  return (size_t)Ta * (A + dv) * 2 + (size_t)2 * KT * Ta * 4;
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace

// Shared-memory bytes each launch asks for (the wrapper checks the limit).
extern "C" long long avsr_fusion_attn_smem(int Ta, int Tv, int A, int dv) {
  size_t m = fwd_smem(Tv, A, dv);
  if (bwd_q_smem(Tv, A, dv) > m) m = bwd_q_smem(Tv, A, dv);
  if (bwd_kv_smem(Ta, A, dv) > m) m = bwd_kv_smem(Ta, A, dv);
  return (long long)m;
}

extern "C" int avsr_fusion_attn_fwd(const void* q, const void* k, const void* v,
                                    const void* vlen, void* P, void* ctx, int B, int Ta,
                                    int Tv, int nh, int A, int dv, void* stream) {
  if (A % 8 || dv % 8 || Ta < 1 || Tv < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = fwd_smem(Tv, A, dv);
  cudaError_t e = allow_smem(fusion_fwd_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((Ta + QT - 1) / QT, nh, B);
  fusion_fwd_kernel<<<grid, THREADS, smem, reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(vlen),
      static_cast<float*>(P), static_cast<__nv_bfloat16*>(ctx), Ta, Tv, nh, A, dv);
  return (int)cudaGetLastError();
}

extern "C" int avsr_fusion_attn_bwd(const void* q, const void* k, const void* v,
                                    const void* P, const void* dctx, void* dsc, void* dq,
                                    void* dk, void* dv_out, int B, int Ta, int Tv, int nh,
                                    int A, int dv, void* stream) {
  if (A % 8 || dv % 8 || Ta < 1 || Tv < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const size_t smem_q = bwd_q_smem(Tv, A, dv);
  const size_t smem_kv = bwd_kv_smem(Ta, A, dv);
  cudaError_t e = allow_smem(fusion_bwd_q_kernel, smem_q);
  if (e != cudaSuccess) return (int)e;
  e = allow_smem(fusion_bwd_kv_kernel, smem_kv);
  if (e != cudaSuccess) return (int)e;
  fusion_bwd_q_kernel<<<dim3((Ta + QT - 1) / QT, nh, B), THREADS, smem_q, st>>>(
      static_cast<const __nv_bfloat16*>(k), static_cast<const __nv_bfloat16*>(v),
      static_cast<const float*>(P), static_cast<const __nv_bfloat16*>(dctx),
      static_cast<__nv_bfloat16*>(dsc), static_cast<__nv_bfloat16*>(dq), Ta, Tv, nh, A, dv);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  fusion_bwd_kv_kernel<<<dim3((Tv + KT - 1) / KT, nh, B), THREADS, smem_kv, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const float*>(P),
      static_cast<const __nv_bfloat16*>(dctx), static_cast<const __nv_bfloat16*>(dsc),
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv_out), Ta, Tv, nh, A,
      dv);
  return (int)cudaGetLastError();
}

// K11: the transformer encoder's self-attention core, forward and backward,
// on the tensor cores (attention_mma.cuh).
//
// Replaces the core of avsr_tpu/models/transformer.py:transformer_encoder_apply
// (transformer.py:204-224), which the JAX package leaves to XLA: every step
// of an utterance attends over every valid step of the same utterance, per
// (utterance b, head h), with dh = d / heads, under the bf16 policy:
//
//   s[i, j]  = float(bf16(q_i . k_j)) / sqrt(dh) + (1 - valid_j) * -1e9
//   P[i, :]  = softmax(s[i, :])                       (fp32)
//   ctx[i]   = bf16(sum_j bf16(P[i, j]) * v_j)        (fp32 accumulate)
//
// The mask is ADDED, as in the reference, so a row of length 0 gets the
// uniform softmax over all T keys (its outputs are masked later by the
// stack).  The reference's one [d, 3d] product over [wq | wk | wv]
// (transformer.py:212-216), the head merge, the wo product and the residual
// stay torch code.
//
// Operands: the product qkv [B, T, 3, nh, dh] bf16 as it comes out of the
// matmul.  q, k and v are strided views of it, read in place (row stride
// 3 * nh * dh elements), so no copy of the three views is made.  ctx comes
// out [B, T, nh, dh] bf16, ready for the head merge.
//
// Backward (the autodiff of the same lines, with the rounding points of the
// header of attention_mma.cuh): the context cotangent dctx [B, T, nh, dh]
// bf16 -> dqkv [B, T, 3, nh, dh] bf16.  dq, dk and dv are written straight
// into the three strided views of one tensor, which is the cotangent of the
// [d, 3d] product: one matmul backward follows and nothing is copied.  The
// backward's residual is the forward's row max and row sum, fp32 [B, nh, T]
// each (1.6 MB at B = 128, T = 197, where the fp32 weights P would take 159
// MB per layer); the backward recomputes P from them, the operands and the
// lengths, bit for bit the forward's.  Its scratch is
// D = rowsum(dP * P), fp32 [B, nh, T]; no [B, nh, T, T] tensor is written.
// Serving passes null statistics and writes none.
//
// What bounds it on an H100 (B = 128, 8 heads, T = 197, dh = 64): the
// forward reads 77.5 MB of qkv and writes 25.8 MB of ctx, ~31 us of HBM
// time against ~10 us for its 10.2 GFLOP at the bf16 tensor-core peak; the
// backward reads qkv, dctx and the statistics and writes dqkv, ~183 MB (~55
// us), against ~26 us for the 25.4 GFLOP of its five products (the scores
// recomputed, dP, dQ, dK, dV): both byte-bound.  Design: attention_mma.cuh
// (mma.sync tiles from swizzled shared memory, 64 queries or keys per
// block, the scores in registers, one owner block per output row, no
// atomics).  Tensor-core instance at head width 64 (the lrs2_av_v2
// preset's 512 / 8 heads); T from 1 to 531, the preset's 16 s limit
// (shared memory at T = 531: 147 KB forward, 164 KB for the backward's key
// launch).  Other head widths (multiples of 8) run on attention_core.cuh's
// CUDA-core kernels, whose residual is the fp32 weights
// (avsr_encoder_attn_core_*; kernels.attention_family routes by width).

#include "attention_mma.cuh"
#include "attention_core.cuh"

namespace {
constexpr int DH = 64;
}

// Shared-memory bytes the largest of the three launches asks for; -1 for a
// head width the kernels are not built for.
extern "C" long long avsr_encoder_attn_smem(int T, int dh) {
  return dh == DH ? (long long)mma_attn::attn_smem<DH>(T, T) : -1;
}

// row_max / row_sum null: nothing saved (serving); else fp32 [B, nh, T]
// each, the backward's residual.
extern "C" int avsr_encoder_attn_fwd(const void* qkv, const void* lengths, void* row_max,
                                     void* row_sum, void* ctx, int B, int T, int nh, int dh,
                                     void* stream) {
  if (dh != DH) return (int)cudaErrorInvalidValue;
  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(qkv);
  const int d = nh * dh;
  return (int)mma_attn::launch_fwd<DH>(
      q, q + d, q + 2 * d, mma_attn::LengthMask{static_cast<const int*>(lengths)},
      static_cast<float*>(row_max), static_cast<float*>(row_sum), ctx, B, T, T, nh, 3 * d, 3 * d,
      3 * d, d, reinterpret_cast<cudaStream_t>(stream));
}

// D: an fp32 [B, nh, T] scratch; dqkv [B, T, 3, nh, dh] bf16 out.
extern "C" int avsr_encoder_attn_bwd(const void* qkv, const void* lengths, const void* row_max,
                                     const void* row_sum, const void* dctx, void* D, void* dqkv,
                                     int B, int T, int nh, int dh, void* stream) {
  if (dh != DH) return (int)cudaErrorInvalidValue;
  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(qkv);
  __nv_bfloat16* dq = static_cast<__nv_bfloat16*>(dqkv);
  const int d = nh * dh;
  return (int)mma_attn::launch_bwd<DH>(
      q, q + d, q + 2 * d, mma_attn::LengthMask{static_cast<const int*>(lengths)},
      static_cast<const float*>(row_max), static_cast<const float*>(row_sum), dctx,
      static_cast<float*>(D), dq, dq + d, dq + 2 * d, B, T, T, nh, 3 * d, 3 * d, 3 * d, d, 3 * d,
      3 * d, 3 * d, reinterpret_cast<cudaStream_t>(stream));
}

// The CUDA-core route at any dh that is a multiple of 8, q, k and v read in
// place from qkv as above: P fp32 [B, nh, T, T] out where not null (the
// backward's residual on this route).
extern "C" int avsr_encoder_attn_core_fwd(const void* qkv, const void* lengths, void* P,
                                          void* ctx, int B, int T, int nh, int dh, void* stream) {
  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(qkv);
  const int d = nh * dh;
  return (int)core_attn::launch_attn_fwd<__nv_bfloat16>(
      q, q + d, q + 2 * d, mma_attn::LengthMask{static_cast<const int*>(lengths)}, P, ctx, B, T,
      T, nh, dh, dh, 3 * d, 3 * d, 3 * d, reinterpret_cast<cudaStream_t>(stream));
}

// dsc: a bf16 [B, nh, T, T] scratch; dqkv [B, T, 3, nh, dh] bf16 out.
extern "C" int avsr_encoder_attn_core_bwd(const void* qkv, const void* P, const void* dctx,
                                          void* dsc, void* dqkv, int B, int T, int nh, int dh,
                                          void* stream) {
  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(qkv);
  __nv_bfloat16* dq = static_cast<__nv_bfloat16*>(dqkv);
  const int d = nh * dh;
  return (int)core_attn::launch_attn_bwd<__nv_bfloat16>(q, q + d, q + 2 * d, P, dctx, dsc, dq, dq + d, dq + 2 * d,
                                         B, T, T, nh, dh, dh, 3 * d, 3 * d, 3 * d, 3 * d, 3 * d,
                                         3 * d, reinterpret_cast<cudaStream_t>(stream));
}

// K11: the transformer encoder's self-attention core, forward and backward.
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
// This is K4's contract (cross_attention.cu) with T_q = T_k = T and the key
// mask from the stack's own lengths.  The mask is ADDED, as in the
// reference, so a row of length 0 gets the uniform softmax over all T keys
// (its outputs are masked later by the stack).  The reference's one [d, 3d]
// product over [wq | wk | wv] (transformer.py:212-216), the head merge, the
// wo product and the residual stay torch code.
//
// Operands: the product qkv [B, T, 3, nh, dh] bf16 as it comes out of the
// matmul.  q, k and v are strided views of it, read in place: both launches
// of attention_core.cuh take row strides (3 * nh * dh elements here), so no
// copy of the three views is made.  ctx comes out [B, T, nh, dh] bf16, ready
// for the head merge.
//
// Backward (the autodiff of the same lines, with the rounding points of the
// header of attention_core.cuh): the context cotangent dctx [B, T, nh, dh]
// bf16 -> dqkv [B, T, 3, nh, dh] bf16.  dq, dk and dv are written straight
// into the three strided views of one tensor, which is the cotangent of the
// [d, 3d] product: one matmul backward follows and nothing is copied.  The
// backward needs the weights P.  They are SAVED, not recomputed: the
// forward's save mode writes P as fp32 [B, nh, T, T] (159 MB per layer at
// B = 128, T = 197; 636 MB over the 3 + 1 layers of an lrs2_av_v2 step,
// held until the backward), as K4's forward always does.  Recomputing them
// would cost a third launch and the q.k product again; the card has the
// memory.  Serving passes P = null and writes none.
//
// What bounds it on an H100: at the serving path's 6 s batch of the phase
// check (B = 128, 8 heads, T = 197, dh = 64) the forward reads 77.5 MB of qkv
// and writes 25.8 MB of ctx for 10.2 GFLOP: ~31 us of HBM time against
// ~10 us at the bf16 tensor-core peak, so byte-bound.  The backward's own
// function reads qkv and dctx and writes dqkv, ~181 MB (~54 us), for 20.3
// GFLOP (~21 us); the kernel moves more: P twice (rows in pass 1, columns
// in pass 2) and a bf16 dsc scratch [B, nh, T, T] (79 MB) written by pass 1
// and read by pass 2.  Like K4's, these kernels spend their time on the
// shared-memory issue rate of CUDA-core fp32 FMAs on bf16-rounded operands
// (the reference's numerics) rather than on either limit; wgmma tiles are
// later work.  Design: the shared forward and backward of
// attention_core.cuh (one block per (b, h, 16 queries), K staged transposed
// then V in one shared buffer, fp32 softmax in shared memory, one warp per
// row; a two-launch backward with one owner block per output row, no
// atomics).  Shared memory of the forward is T*dh*2 + 16*dh*2 + 16*T*4
// bytes: 39.9 KB at T = 197, 104 KB at the preset's 16 s limit of T = 531
// audio steps; the backward's key pass stages all T queries and dctx rows,
// T*dh*4 + 2*16*T*4 bytes: 75.6 KB at T = 197, 203.9 KB at T = 531 (the
// wrapper checks every request against the card's limit and raises above
// T = 531).

#include "attention_core.cuh"

// Shared-memory bytes the largest of the three launches asks for.
extern "C" long long avsr_encoder_attn_smem(int T, int dh) {
  return (long long)attn_smem(T, T, dh, dh);
}

// P null: no weights written (serving); else fp32 [B, nh, T, T] for the
// backward.
extern "C" int avsr_encoder_attn_fwd(const void* qkv, const void* lengths, void* P, void* ctx,
                                     int B, int T, int nh, int dh, void* stream) {
  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(qkv);
  const int d = nh * dh;
  return (int)launch_attn_fwd(q, q + d, q + 2 * d, LengthMask{static_cast<const int*>(lengths)},
                              P, ctx, B, T, T, nh, dh, dh, 3 * d, 3 * d, 3 * d,
                              reinterpret_cast<cudaStream_t>(stream));
}

// dsc: a bf16 [B, nh, T, T] scratch; dqkv [B, T, 3, nh, dh] bf16 out.
extern "C" int avsr_encoder_attn_bwd(const void* qkv, const void* P, const void* dctx, void* dsc,
                                     void* dqkv, int B, int T, int nh, int dh, void* stream) {
  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(qkv);
  __nv_bfloat16* dq = static_cast<__nv_bfloat16*>(dqkv);
  const int d = nh * dh;
  return (int)launch_attn_bwd(q, q + d, q + 2 * d, P, dctx, dsc, dq, dq + d, dq + 2 * d, B, T, T,
                              nh, dh, dh, 3 * d, 3 * d, 3 * d, 3 * d, 3 * d, 3 * d,
                              reinterpret_cast<cudaStream_t>(stream));
}

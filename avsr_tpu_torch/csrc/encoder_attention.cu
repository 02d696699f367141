// K11: the transformer encoder's self-attention core, forward.
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
// matmul.  q, k and v are strided views of it, read in place: the forward of
// attention_core.cuh takes a row stride (`launch_attn_fwd`, 3 * nh * dh
// elements here), so no copy of the three views is made.  ctx comes out
// [B, T, nh, dh] bf16, ready for the head merge.  No weights are written
// (P = null): nothing reads them, and K11's backward (later work) will
// recompute them, as K5's forward-only mode does.
//
// What bounds it on an H100: at the serving path's 6 s batch of the phase
// check (B = 128, 8 heads, T = 197, dh = 64) the core reads 77.5 MB of qkv
// and writes 25.8 MB of ctx for 10.2 GFLOP: ~31 us of HBM time against
// ~10 us at the bf16 tensor-core peak, so byte-bound.  This kernel, like
// K4's, spends its time on the shared-memory issue rate of CUDA-core fp32
// FMAs on bf16-rounded operands (the reference's numerics) rather than on
// either limit; wgmma tiles are later work.  Design: the shared forward of
// attention_core.cuh (one block per (b, h, 16 queries), K staged transposed
// then V in one shared buffer, fp32 softmax in shared memory, one warp per
// row).  Shared memory is T*dh*2 + 16*dh*2 + 16*T*4 bytes: 39.9 KB at T =
// 197, 104 KB at the preset's 16 s limit of T = 531 audio steps (the wrapper
// raises above that).

#include "attention_core.cuh"

// Shared-memory bytes the launch asks for (the wrapper checks the limit).
extern "C" long long avsr_encoder_attn_smem(int T, int dh) {
  return (long long)fwd_smem(T, dh, dh);
}

extern "C" int avsr_encoder_attn_fwd(const void* qkv, const void* lengths, void* ctx, int B,
                                     int T, int nh, int dh, void* stream) {
  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(qkv);
  const int d = nh * dh;
  return (int)launch_attn_fwd(q, q + d, q + 2 * d, LengthMask{static_cast<const int*>(lengths)},
                              nullptr, ctx, B, T, T, nh, dh, dh, 3 * d, 3 * d, 3 * d,
                              reinterpret_cast<cudaStream_t>(stream));
}

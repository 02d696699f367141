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
// Design: the shared forward and backward of attention_core.cuh (one block
// per (b, h, 16 queries), K then V staged in one shared buffer, fp32
// softmax, P written; a two-launch backward with one owner block per output
// row), with the key-padding mask from the video lengths.  Shared memory is
// T_v*max(A, dv)*2 + QT*A*2 + QT*T_v*4 bytes: 52 KB at T_v = 150, 132 KB at
// the preset's 16 s limit of T_v = 400 (the wrapper raises above that).

#include "attention_core.cuh"

// Shared-memory bytes each launch asks for (the wrapper checks the limit).
extern "C" long long avsr_fusion_attn_smem(int Ta, int Tv, int A, int dv) {
  return (long long)attn_smem(Ta, Tv, A, dv);
}

extern "C" int avsr_fusion_attn_fwd(const void* q, const void* k, const void* v,
                                    const void* vlen, void* P, void* ctx, int B, int Ta,
                                    int Tv, int nh, int A, int dv, void* stream) {
  return (int)launch_attn_fwd(q, k, v, LengthMask{static_cast<const int*>(vlen)}, P, ctx, B,
                              Ta, Tv, nh, A, dv, nh * A, nh * A, nh * dv,
                              reinterpret_cast<cudaStream_t>(stream));
}

extern "C" int avsr_fusion_attn_bwd(const void* q, const void* k, const void* v,
                                    const void* P, const void* dctx, void* dsc, void* dq,
                                    void* dk, void* dv_out, int B, int Ta, int Tv, int nh,
                                    int A, int dv, void* stream) {
  return (int)launch_attn_bwd(q, k, v, P, dctx, dsc, dq, dk, dv_out, B, Ta, Tv, nh, A, dv,
                              nh * A, nh * A, nh * dv, nh * A, nh * A, nh * dv,
                              reinterpret_cast<cudaStream_t>(stream));
}

// K5: the teacher-forced decoder attention, forward and backward.
//
// Replaces the two attention cores of
// avsr_tpu/models/transformer_decoder.py:teacher_forced_logits, which the
// JAX package leaves to XLA: the causal self attention over the K label
// positions (transformer_decoder.py:342-350) and the cross attention of
// those positions over the prepared memory (:359-373).  Per (row b, head h),
// under the bf16 policy:
//
//   s[i, j]  = float(bf16(q_i . k_j)) / sqrt(dk) + mask(b, i, j)
//   P[i, :]  = softmax(s[i, :])                       (fp32)
//   ctx[i]   = bf16(sum_j bf16(P[i, j]) * v_j)        (fp32 accumulate)
//
// with one of two masks, each the reference's constant:
//   causal:  (1 - [j <= i]) * -1e9          (self attention, S = Q)
//   bias:    bias[b, j], the memory's -1e30 on padded positions (cross)
// The mask is added, never used to skip a key: a memory of length 0 gets
// the reference's uniform softmax over all S keys.  The backward (dq, dk,
// dv; no gradient flows to the mask) is the softmax-attention backward of
// attention_core.cuh with JAX's rounding points: dP = bf16(dctx V^T), the
// scores' cotangent rounded to bf16 before the dq/dk products.
//
// Shapes on the main path (lrs2_av_fast, B = 128, label cap K = 80, 4
// heads): self q/k/v [128, 80, 4, 64]; cross q [128, 80, 4, 128] against
// keys [128, 50, 4, 128] and values [128, 50, 4, 256].
//
// What bounds it on an H100: the self forward moves 21 MB of q/k/v/ctx and
// 13.1 MB of fp32 P (written for the backward) for 0.84 GFLOP; the cross
// forward 51 MB and 8.2 MB of P for 1.6 GFLOP.  At 3.35 TB/s and 989
// TFLOP/s both are byte-bound, at ~10 and ~18 us;
// the kernel spends its time on the shared-memory issue rate of
// CUDA-core FMAs on bf16-rounded operands (the reference's numerics) and on
// launch latency.
//
// Design: the shared kernels of attention_core.cuh (one block per (b, h,
// 16 queries), K then V staged in one shared buffer, fp32 softmax, P
// written only when a backward will read it; a two-launch backward with one
// owner block per output row, no atomics).  Shared memory of the forward
// is S*max(dk, dv)*2 + 16*dk*2 + 16*S*4 bytes: 17 KB for the self instance,
// 33 KB for the cross one, 81 KB at the preset's 16 s memory of S = 133;
// the backward's key pass stages all Q queries, 134 KB at the 150-label
// horizon (the wrapper checks every request against the card's limit).

#include "attention_core.cuh"

namespace {

// (1 - [j <= i]) * -1e9: the causal mask of transformer_decoder.py:335-348
struct CausalMask {
  __device__ float operator()(int, int i, int j) const {
    const float masked = j <= i ? 0.f : 1.f;
    return masked * -1e9f;
  }
};

// the prepared memory's additive key bias [B, S] (0 or -1e30)
struct BiasMask {
  const float* bias;
  int S;
  __device__ float operator()(int b, int, int j) const { return bias[(size_t)b * S + j]; }
};

}  // namespace

// Shared-memory bytes the largest of the three launches asks for.
extern "C" long long avsr_decoder_attn_smem(int Q, int S, int dk, int dv) {
  return (long long)attn_smem(Q, S, dk, dv);
}

// bias null: the causal mask (Q must equal S).  P null: no weights written.
extern "C" int avsr_decoder_attn_fwd(const void* q, const void* k, const void* v,
                                     const void* bias, void* P, void* ctx, int B, int Q, int S,
                                     int nh, int dk, int dv, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (bias == nullptr) {
    if (Q != S) return (int)cudaErrorInvalidValue;
    return (int)launch_attn_fwd(q, k, v, CausalMask{}, P, ctx, B, Q, S, nh, dk, dv, nh * dk,
                                nh * dk, nh * dv, st);
  }
  return (int)launch_attn_fwd(q, k, v, BiasMask{static_cast<const float*>(bias), S}, P, ctx, B,
                              Q, S, nh, dk, dv, nh * dk, nh * dk, nh * dv, st);
}

extern "C" int avsr_decoder_attn_bwd(const void* q, const void* k, const void* v,
                                     const void* P, const void* dctx, void* dsc, void* dq,
                                     void* dk_out, void* dv_out, int B, int Q, int S, int nh,
                                     int dk, int dv, void* stream) {
  return (int)launch_attn_bwd(q, k, v, P, dctx, dsc, dq, dk_out, dv_out, B, Q, S, nh, dk, dv,
                              nh * dk, nh * dk, nh * dv, nh * dk, nh * dk, nh * dv,
                              reinterpret_cast<cudaStream_t>(stream));
}

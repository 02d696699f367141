// K4: the cross-attention fusion core, forward and backward, on the tensor
// cores (attention_mma.cuh).
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
// alignments read it.  The projections, the audio mask and the AU head stay
// matrix products outside.
//
// Backward (the autodiff of the same lines, with the rounding points of the
// header of attention_mma.cuh): the context cotangent dctx [B, T_a, nh, dv]
// -> dq, dk, dv.  Its residual is the forward's row max and row sum, fp32
// [B, nh, T_a] each, from which it recomputes P bit for bit; it never reads
// P, and its only scratch is D = rowsum(dP * P), fp32 [B, nh, T_a].
// Serving passes null statistics and writes none.
//
// What bounds it on an H100: bytes.  At the fast model's shapes (B = 128,
// 4 heads, T_a = 50, T_v = 150, A = dv = 128) the forward reads q, k, v
// (45.9 MB) and writes ctx and P (22.0 MB, P 15.4 MB of it): ~20 us at 3.35
// TB/s, for 1.2 GFLOP; the backward reads q, k, v, dctx and the lengths
// and writes dq, dk, dv (~98 MB, ~29 us).  At lrs2_av_v2's T_a = 197 P
// alone is 60.5 MB.  Design: attention_mma.cuh's streamed tiles at head
// widths (A, dv) = (128, 128), both presets' 4 heads x 128, and (128, 64),
// the fusion's memory_value_dim = 256 override over 4 heads.  The video
// keys and values (forward, launch 1) and the audio queries (launch 2)
// stream through two slots of 64-row tiles, so shared memory is the same at
// any length (48 KB forward, 96 / 98 KB for the backward's two launches at
// 128 / 128) and the presets' 16 s limits (T_v = 400, T_a = 531) are taken;
// the forward holds the scores of up to 10 steps of 16 keys (T_v = 150 in
// one pass, its keys and values each read once) and takes longer rows in
// three passes.  The divisions by sqrt(128) are corrected products with the
// reciprocal (div_row): IEEE division's per-element check and slow-path
// branch had doubled the kernels' time.  Other head widths (multiples of
// 8) run on attention_core.cuh's CUDA-core kernels, whose residual is P
// itself (avsr_fusion_attn_core_fwd, and the backward shared with K5,
// avsr_attn_core_bwd; kernels.attention_family routes).  The fp32 policy's
// K4 is attention_core.cuh's fp32 instance at every width
// (avsr_fusion_attn_core_fwd_f32, avsr_attn_core_bwd_f32): at the fast
// model's shapes its forward does 2.0 GFLOP of CUDA-core FMAs (~29 us at
// 67 TFLOP/s) and moves 120 MB of fp32 q, k, v, ctx and P (~36 us at 3.35
// TB/s).

#include "attention_mma.cuh"
#include "attention_core.cuh"

namespace {
using mma_attn::LengthMask;

// the head-width pairs the tensor-core kernels are built for
bool built_for(int A, int dv) { return A == 128 && (dv == 128 || dv == 64); }
}  // namespace

// P: fp32 [B, nh, Ta, Tv] out; row_max / row_sum null (serving) or fp32
// [B, nh, Ta] each out, the backward's residual.
extern "C" int avsr_fusion_attn_fwd(const void* q, const void* k, const void* v,
                                    const void* vlen, void* P, void* row_max, void* row_sum,
                                    void* ctx, int B, int Ta, int Tv, int nh, int A, int dv,
                                    void* stream) {
  if (!built_for(A, dv)) return (int)cudaErrorInvalidValue;
  const LengthMask mask{static_cast<const int*>(vlen)};
  float *p = static_cast<float*>(P), *mx = static_cast<float*>(row_max),
        *sm = static_cast<float*>(row_sum);
  const cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int lq = nh * A, lv = nh * dv;
  // the scores of up to 10 steps of 16 keys held: T_v = 150 in one pass
  const auto launch = dv == 128 ? mma_attn::launch_stream_fwd<128, 128, 10, LengthMask>
                                : mma_attn::launch_stream_fwd<128, 64, 10, LengthMask>;
  return (int)launch(q, k, v, mask, p, mx, sm, ctx, B, Ta, Tv, nh, lq, lq, lv, lv, st);
}

// D: an fp32 [B, nh, Ta] scratch; dq, dk, dv_out bf16, shaped as q, k, v.
extern "C" int avsr_fusion_attn_bwd(const void* q, const void* k, const void* v,
                                    const void* vlen, const void* row_max, const void* row_sum,
                                    const void* dctx, void* D, void* dq, void* dk, void* dv_out,
                                    int B, int Ta, int Tv, int nh, int A, int dv, void* stream) {
  if (!built_for(A, dv)) return (int)cudaErrorInvalidValue;
  const LengthMask mask{static_cast<const int*>(vlen)};
  const float *mx = static_cast<const float*>(row_max), *sm = static_cast<const float*>(row_sum);
  const cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int lq = nh * A, lv = nh * dv;
  const auto launch = dv == 128 ? mma_attn::launch_stream_bwd<128, 128, LengthMask>
                                : mma_attn::launch_stream_bwd<128, 64, LengthMask>;
  return (int)launch(q, k, v, mask, mx, sm, dctx, static_cast<float*>(D), dq, dk, dv_out, B, Ta,
                     Tv, nh, lq, lq, lv, lv, lq, lq, lv, st);
}

// The CUDA-core route at any A, dv that are multiples of 8: P fp32 [B, nh,
// Ta, Tv] out (the alignments, and the backward's residual on this route).
extern "C" int avsr_fusion_attn_core_fwd(const void* q, const void* k, const void* v,
                                         const void* vlen, void* P, void* ctx, int B, int Ta,
                                         int Tv, int nh, int A, int dv, void* stream) {
  return (int)core_attn::launch_attn_fwd<__nv_bfloat16>(
      q, k, v, LengthMask{static_cast<const int*>(vlen)}, P, ctx, B, Ta, Tv, nh, A, dv, nh * A,
      nh * A, nh * dv, reinterpret_cast<cudaStream_t>(stream));
}

// The fp32 policy's K4 (attention_core.cuh's fp32 instance, at any A, dv
// that are multiples of 8): q, k, v and ctx fp32, P as above.  Its backward
// is avsr_attn_core_bwd_f32.
extern "C" int avsr_fusion_attn_core_fwd_f32(const void* q, const void* k, const void* v,
                                             const void* vlen, void* P, void* ctx, int B, int Ta,
                                             int Tv, int nh, int A, int dv, void* stream) {
  return (int)core_attn::launch_attn_fwd<float>(
      q, k, v, LengthMask{static_cast<const int*>(vlen)}, P, ctx, B, Ta, Tv, nh, A, dv, nh * A,
      nh * A, nh * dv, reinterpret_cast<cudaStream_t>(stream));
}

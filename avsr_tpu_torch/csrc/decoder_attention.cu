// K5: the teacher-forced decoder attention, forward and backward, on the
// tensor cores (attention_mma.cuh).
//
// Replaces the two attention cores of
// avsr_tpu/models/transformer_decoder.py:teacher_forced_logits, which the
// JAX package leaves to XLA: the causal self attention over the K label
// positions (transformer_decoder.py:335-350) and the cross attention of
// those positions over the prepared memory (:359-373).  Per (row b, head h),
// under the bf16 policy:
//
//   s[i, j]  = float(bf16(q_i . k_j)) / sqrt(dk) + mask(b, i, j)
//   P[i, :]  = softmax(s[i, :])                       (fp32)
//   ctx[i]   = bf16(sum_j bf16(P[i, j]) * v_j)        (fp32 accumulate)
//
// with one of two masks (attention_mma.cuh), each the reference's constant:
//   CausalMask:  (1 - [j <= i]) * -1e9     (self attention, S = Q)
//   BiasMask:    bias[b, j], the memory's -1e30 on padded positions (cross)
// The mask is added, never used to skip a key whose weight may be nonzero:
// a memory of length 0 gets the reference's uniform softmax over all S
// keys.  The backward (dq, dk, dv; no gradient flows to the mask) has the
// rounding points of attention_mma.cuh's header.  The decoder reads no
// weights, so the forward writes only ctx and, in train mode, the softmax's
// row max and row sum (fp32 [B, nh, Q] each); the backward recomputes P
// from them bit for bit, with D = rowsum(dP * P) (fp32 [B, nh, Q]) its only
// scratch (none in decoder_cross_attention.cuh's backward): no [B, nh, Q, S]
// tensor is written in either direction.
//
// Shapes on the main path (B = 128, label cap K = 80, 4 heads): self q/k/v
// [128, 80, 4, 64]; cross q [128, 80, 4, 128] against keys [128, S, 4, 128]
// and values [128, S, 4, 256], S = 50 (lrs2_av_fast's memory) or 197
// (lrs2_av_v2's, every audio step; 531 at its 16 s limit).
//
// What bounds it on an H100: bytes.  The self forward moves 21 MB of
// q/k/v/ctx and the statistics for 0.84 GFLOP, the cross forward at S = 50
// 51 MB for 1.6 GFLOP: ~6 and ~15 us at 3.35 TB/s against ~1 and ~2 us at
// 989 TFLOP/s.
//
// Design, by instance:
// * Self, (dk, dv) = (64, 64), CausalMask: the whole-row kernels (K11's):
//   K and V of the (b, h) staged once per block, the scores held, one
//   owner block per output row.  A warp skips the key steps past its last
//   query (forward, launch 1) and the query steps before its first key
//   (launch 2): their weights are exactly 0, so the skip changes no bit.
//   Shared memory grows with S (fwd (64 + 2 Sp) * 128 B, launch 2 (128 +
//   2 Sp) * 128 + 16 Sp B, Sp = S rounded up to 16): S <= 784.
// * Cross, (dk, dv) = (128, 256), BiasMask: decoder_cross_attention.cuh's
//   kernels, one block per (b, h) (the forward: per 80 queries): K and V
//   pass through a ring of bulk-copied tiles once per (b, h) (the
//   backward: twice, D first), every score and weight is formed once, and
//   the queries (the backward: with dctx) stay resident.  The forward
//   takes any Q and S up to its shared memory at one 16-query strip (S <=
//   5376); the backward Q <= 160 (every preset caps its labels at 150) and
//   any S.
// * Cross past those lengths (avsr_decoder_cross_stream_*; the wrapper
//   routes by shape, kernels.decoder_cross_route): the streamed tiles
//   (K4's), under which keys and values (forward, launch 1) and queries
//   with dctx (launch 2) pass through a ring of two tile slots, so shared
//   memory does not grow with Q or S.  At dv = 256 the accumulators of ctx
//   (128 floats a thread) or of dK and dV (192) would spill, so the
//   forward and launch 2 split the value columns over two blocks (NSPLIT =
//   2), each forming the same scores and P; the backward streams 32-row
//   tiles so that two ~97 KB blocks share an SM.  D is an fp32 [B, nh, Q]
//   scratch there.
// * The fp32 policy (train.compute_dtype = "float32"), both attentions at
//   every width: attention_core.cuh's fp32 instance (avsr_decoder_attn_
//   core_fwd_f32, avsr_attn_core_bwd_f32), fp32 operands and FMA sums with
//   no rounding point, its residual the fp32 weights.  At the main path's
//   shapes its operations bound it: the self forward's 0.84 GFLOP and the
//   cross forward's 1.6 GFLOP of FMAs take ~13 and ~23 us at 67 TFLOP/s.

#include "attention_mma.cuh"
#include "attention_core.cuh"
#include "decoder_cross_attention.cuh"

namespace {
using mma_attn::BiasMask;
using mma_attn::CausalMask;

constexpr int SELF_DH = 64;                    // the self instance's head width
constexpr int CROSS_DK = xattn::DK, CROSS_DV = xattn::DV;  // the cross instance's head widths
constexpr int CROSS_HELD = 13;   // 16-key steps of scores the streamed cross forward holds
constexpr int CROSS_SPLIT = 2;   // value-column slices of the streamed cross kernels
constexpr int CROSS_TR = 32;     // rows of the streamed cross backward's tiles

bool self_instance(int Q, int S, int dk, int dv) {
  return Q == S && dk == SELF_DH && dv == SELF_DH;
}
bool cross_instance(int dk, int dv) { return dk == CROSS_DK && dv == CROSS_DV; }
}  // namespace

// The tensor-core instances.  bias null: the causal self attention (Q == S,
// dk = dv = 64); else the cross attention under the bias at (128, 256).
// row_max / row_sum null: nothing saved (serving); else fp32 [B, nh, Q]
// each out, the backward's residual.
extern "C" int avsr_decoder_attn_fwd(const void* q, const void* k, const void* v,
                                     const void* bias, void* row_max, void* row_sum, void* ctx,
                                     int B, int Q, int S, int nh, int dk, int dv, void* stream) {
  const cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  float *mx = static_cast<float*>(row_max), *sm = static_cast<float*>(row_sum);
  if (bias == nullptr) {
    if (!self_instance(Q, S, dk, dv)) return (int)cudaErrorInvalidValue;
    const int ld = nh * SELF_DH;
    return (int)mma_attn::launch_fwd<SELF_DH>(q, k, v, CausalMask{}, mx, sm, ctx, B, Q, S, nh,
                                              ld, ld, ld, ld, st);
  }
  if (!cross_instance(dk, dv)) return (int)cudaErrorInvalidValue;
  return (int)xattn::launch_fwd(q, k, v, static_cast<const float*>(bias), mx, sm, ctx, B, Q, S,
                                nh, st);
}

// D: an fp32 [B, nh, Q] scratch of the self instance (the cross instance
// keeps D in shared memory: null); dq, dk_out, dv_out bf16, shaped as q, k, v.
extern "C" int avsr_decoder_attn_bwd(const void* q, const void* k, const void* v,
                                     const void* bias, const void* row_max, const void* row_sum,
                                     const void* dctx, void* D, void* dq, void* dk_out,
                                     void* dv_out, int B, int Q, int S, int nh, int dk, int dv,
                                     void* stream) {
  const cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const float *mx = static_cast<const float*>(row_max), *sm = static_cast<const float*>(row_sum);
  float* Dp = static_cast<float*>(D);
  if (bias == nullptr) {
    if (!self_instance(Q, S, dk, dv)) return (int)cudaErrorInvalidValue;
    const int ld = nh * SELF_DH;
    return (int)mma_attn::launch_bwd<SELF_DH>(q, k, v, CausalMask{}, mx, sm, dctx, Dp, dq, dk_out,
                                              dv_out, B, Q, S, nh, ld, ld, ld, ld, ld, ld, ld, st);
  }
  if (!cross_instance(dk, dv)) return (int)cudaErrorInvalidValue;
  return (int)xattn::launch_bwd(q, k, v, static_cast<const float*>(bias), mx, sm, dctx, dq,
                                dk_out, dv_out, B, Q, S, nh, st);
}

// The cross instance on the streamed tiles, at (dk, dv) = (128, 256): the
// lengths the kernels above do not hold.  Same operands as
// avsr_decoder_attn_fwd / _bwd; D an fp32 [B, nh, Q] scratch.
extern "C" int avsr_decoder_cross_stream_fwd(const void* q, const void* k, const void* v,
                                             const void* bias, void* row_max, void* row_sum,
                                             void* ctx, int B, int Q, int S, int nh,
                                             void* stream) {
  if (bias == nullptr) return (int)cudaErrorInvalidValue;
  const int lk = nh * CROSS_DK, lv = nh * CROSS_DV;
  return (int)mma_attn::launch_stream_fwd<CROSS_DK, CROSS_DV, CROSS_HELD, BiasMask, CROSS_SPLIT>(
      q, k, v, BiasMask{static_cast<const float*>(bias), S}, nullptr,
      static_cast<float*>(row_max), static_cast<float*>(row_sum), ctx, B, Q, S, nh, lk, lk, lv,
      lv, reinterpret_cast<cudaStream_t>(stream));
}

extern "C" int avsr_decoder_cross_stream_bwd(const void* q, const void* k, const void* v,
                                             const void* bias, const void* row_max,
                                             const void* row_sum, const void* dctx, void* D,
                                             void* dq, void* dk_out, void* dv_out, int B, int Q,
                                             int S, int nh, void* stream) {
  if (bias == nullptr || D == nullptr) return (int)cudaErrorInvalidValue;
  const int lk = nh * CROSS_DK, lv = nh * CROSS_DV;
  return (int)mma_attn::launch_stream_bwd<CROSS_DK, CROSS_DV, BiasMask, CROSS_SPLIT, CROSS_TR>(
      q, k, v, BiasMask{static_cast<const float*>(bias), S},
      static_cast<const float*>(row_max), static_cast<const float*>(row_sum), dctx,
      static_cast<float*>(D), dq, dk_out, dv_out, B, Q, S, nh, lk, lk, lv, lv, lk, lk, lv,
      reinterpret_cast<cudaStream_t>(stream));
}

// The cross kernels' layouts, for the wrapper's mirror of them
// (kernels.decoder_cross_fwd_strips / _fwd_smem / DECODER_CROSS_MAX_Q): the
// strips a forward block holds at Q queries and S keys (0: the forward does
// not take S); a forward block's shared memory at ns strips and a ring of
// `slots` tiles; the backward's at ns strips with its ring (-1: it does not
// take 16 ns queries).
extern "C" int avsr_decoder_cross_fwd_strips(int Q, int S) {
  return Q < 1 || S < 1 ? 0 : xattn::fwd_config(Q, S).ns;
}
extern "C" long long avsr_decoder_cross_fwd_smem(int ns, int S, int slots) {
  return (long long)xattn::FwdLayout(ns, S, slots).total;
}
extern "C" long long avsr_decoder_cross_bwd_smem(int ns) {
  if (ns < 1 || ns > xattn::BWD_STRIPS || xattn::bwd_slots(ns) == 0) return -1;
  return (long long)xattn::BwdLayout(ns, xattn::bwd_slots(ns)).total;
}

// The CUDA-core route (attention_core.cuh): any dk, dv that are multiples of
// 8.  P: the fp32 weights [B, nh, Q, S], written where not null (the
// backward's residual on this route).  E: bf16, or fp32 (the fp32 policy's
// K5, at every width).
template <typename E>
cudaError_t core_fwd(const void* q, const void* k, const void* v, const void* bias, void* P,
                     void* ctx, int B, int Q, int S, int nh, int dk, int dv, void* stream) {
  const cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (bias == nullptr) {
    if (Q != S) return cudaErrorInvalidValue;
    return core_attn::launch_attn_fwd<E>(q, k, v, CausalMask{}, P, ctx, B, Q, S, nh, dk, dv,
                                         nh * dk, nh * dk, nh * dv, st);
  }
  return core_attn::launch_attn_fwd<E>(q, k, v, BiasMask{static_cast<const float*>(bias), S}, P,
                                       ctx, B, Q, S, nh, dk, dv, nh * dk, nh * dk, nh * dv, st);
}

extern "C" int avsr_decoder_attn_core_fwd(const void* q, const void* k, const void* v,
                                          const void* bias, void* P, void* ctx, int B, int Q,
                                          int S, int nh, int dk, int dv, void* stream) {
  return (int)core_fwd<__nv_bfloat16>(q, k, v, bias, P, ctx, B, Q, S, nh, dk, dv, stream);
}

extern "C" int avsr_decoder_attn_core_fwd_f32(const void* q, const void* k, const void* v,
                                              const void* bias, void* P, void* ctx, int B, int Q,
                                              int S, int nh, int dk, int dv, void* stream) {
  return (int)core_fwd<float>(q, k, v, bias, P, ctx, B, Q, S, nh, dk, dv, stream);
}

// The CUDA-core route's backward from the fp32 weights P [B, nh, Tq, Tk]
// over contiguous q [B, Tq, nh, dk], k [B, Tk, nh, dk], v [B, Tk, nh, dv]:
// K5's and K4's (the mask enters only through P).  dsc: a [B, nh, Tq, Tk]
// scratch of the operands' type; dq, dk_out, dv_out shaped as q, k, v.
extern "C" int avsr_attn_core_bwd(const void* q, const void* k, const void* v, const void* P,
                                  const void* dctx, void* dsc, void* dq, void* dk_out,
                                  void* dv_out, int B, int Tq, int Tk, int nh, int dk, int dv,
                                  void* stream) {
  return (int)core_attn::launch_attn_bwd<__nv_bfloat16>(
      q, k, v, P, dctx, dsc, dq, dk_out, dv_out, B, Tq, Tk, nh, dk, dv, nh * dk, nh * dk, nh * dv,
      nh * dk, nh * dk, nh * dv, reinterpret_cast<cudaStream_t>(stream));
}

extern "C" int avsr_attn_core_bwd_f32(const void* q, const void* k, const void* v, const void* P,
                                      const void* dctx, void* dsc, void* dq, void* dk_out,
                                      void* dv_out, int B, int Tq, int Tk, int nh, int dk, int dv,
                                      void* stream) {
  return (int)core_attn::launch_attn_bwd<float>(
      q, k, v, P, dctx, dsc, dq, dk_out, dv_out, B, Tq, Tk, nh, dk, dv, nh * dk, nh * dk, nh * dv,
      nh * dk, nh * dk, nh * dv, reinterpret_cast<cudaStream_t>(stream));
}

// Shared-memory bytes of the largest launch of the CUDA-core route at these
// lengths and widths, bf16 operands (fp32 = 0) or fp32 ones (for K4, K5 and
// K11 alike: the wrappers check it).
extern "C" long long avsr_attn_core_smem(int Tq, int Tk, int dk, int dv, int fp32) {
  return (long long)core_attn::attn_smem(Tq, Tk, dk, dv, fp32 ? 4 : 2);
}

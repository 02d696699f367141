// K10: one attention read per row, the RNN decoder's read at every decode
// step, with the additive (Bahdanau) or the dot (Luong) score.  Replaces
// avsr_tpu/ops/attention.py:attend (Bahdanau branch :140-151, Luong branch
// :152-163, masking :165-171) as avsr_tpu/models/decoder.py:decoder_step
// (:160-164) calls it over the beam-tiled memory: query [N, Hq] fp32 (the
// top LSTM layer's h), keys [N, S, A] (fp32 projected keys, or the bf16
// memory for Luong, A its width), values [N, S, Dv] bf16, bias and mask
// [N, S] fp32 -> context [N, Dv] fp32 and weights [N, S] fp32.  The
// arithmetic, its rounding points and the design are those of
// bahdanau_core.cuh: one block per row, the q product inside the kernel.
//
// What bounds it on an H100: the bytes of the tiled keys and values, read
// once: at N = 80 beams, S = 197, A = 128, Dv = 768 that is 8.1 MB of
// keys and 24.2 MB of values per step (~9.6 us at 3.35 TB/s), against
// 2 * S * (A + Dv) FMAs per row.  The beams of one utterance read the same
// memory; reading the untiled memory by n / W would cut the bytes tenfold
// (later work, with K6's identical item).  Luong at N = 80, S = 197, a
// 512-wide memory with no value projection: keys and values are the same
// bf16 memory, 16.1 MB each per step (~9.7 us; ~4.8 us if one buffer were
// read once).
//
// Backward (bahdanau_attend_bwd_kernel): the teacher-forced decoder's read
// at every training step, one launch per decoder step, a block per row,
// the body bahdanau::read_bwd.  It adds this row's dkeys [S, A] and
// dvalues [S, Dv] (fp32) into zeroed buffers, writes dquery [Hq], and the
// row's factors dq [A] and dv [A] of the weight gradients (formed by the
// caller as one product per step, as the reference's autodiff forms them).
// Bound on an H100: the keys (fp32) and values (bf16) read once, the fp32
// dkeys / dvalues read and written once: at N = 128, S = 197, A = 128,
// Dv = 768, 12.9 + 38.7 MB read, 2 x 90.4 MB of fp32 gradients moved, per
// decoder step.

#include "bahdanau_core.cuh"

namespace {

using bahdanau::Key;

struct RowWeights {
  float* w;
  __device__ void operator()(int s, float x) const { w[s] = x; }
};

struct RowContext {
  float* ctx;
  __device__ void operator()(int d, float x) const { ctx[d] = x; }
};

template <bool DOT>
__global__ void __launch_bounds__(bahdanau::THREADS)
bahdanau_attend_kernel(const float* __restrict__ query,          // [N, Hq]
                       const __nv_bfloat16* __restrict__ wq,     // [Hq, A]
                       const __nv_bfloat16* __restrict__ vatt,   // [A] or null (dot)
                       const void* __restrict__ keys_in,         // [N, S, A] Key<DOT>
                       const __nv_bfloat16* __restrict__ values, // [N, S, Dv]
                       const float* __restrict__ bias,           // [N, S]
                       const float* __restrict__ mask,           // [N, S]
                       float* __restrict__ ctx,                  // [N, Dv]
                       float* __restrict__ weights,              // [N, S]
                       int Hq, int A, int S, int Dv) {
  extern __shared__ __align__(16) float smem[];
  const auto* keys = static_cast<const typename Key<DOT>::type*>(keys_in);
  const size_t n = blockIdx.x;
  bahdanau::read<DOT>(query + n * Hq, wq, vatt, keys + n * S * A, values + n * S * Dv,
                      bias + n * S, mask + n * S, Hq, A, S, Dv, smem,
                      RowWeights{weights + n * S}, RowContext{ctx + n * Dv});
}

struct DctxRow {
  const float* dctx;
  __device__ float operator()(int d) const { return dctx[d]; }
};

template <bool DOT>
__global__ void __launch_bounds__(bahdanau::THREADS)
bahdanau_attend_bwd_kernel(const float* __restrict__ query,           // [N, Hq]
                           const __nv_bfloat16* __restrict__ wq,      // [Hq, A]
                           const __nv_bfloat16* __restrict__ vatt,    // [A] or null (dot)
                           const void* __restrict__ keys_in,          // [N, S, A] Key<DOT>
                           const __nv_bfloat16* __restrict__ values,  // [N, S, Dv]
                           const float* __restrict__ weights,         // [N, S]
                           const float* __restrict__ dctx,            // [N, Dv]
                           float* __restrict__ dquery,                // [N, Hq]
                           float* __restrict__ dq,                    // [N, A]
                           float* __restrict__ dv_rows,               // [N, A] += or null (dot)
                           float* __restrict__ dkeys,                 // [N, S, A] +=
                           float* __restrict__ dvalues,               // [N, S, Dv] +=
                           int Hq, int A, int S, int Dv) {
  extern __shared__ __align__(16) float smem[];
  const auto* keys = static_cast<const typename Key<DOT>::type*>(keys_in);
  const size_t n = blockIdx.x;
  bahdanau::read_bwd<DOT>(query + n * Hq, wq, vatt, keys + n * S * A, values + n * S * Dv,
                          weights + n * S, DctxRow{dctx + n * Dv}, Hq, A, S, Dv, smem,
                          dkeys + n * S * A, dvalues + n * S * Dv, dq + n * A,
                          DOT ? nullptr : dv_rows + n * A, dquery + n * Hq);
}

}  // namespace

extern "C" long long avsr_bahdanau_smem(int Hq, int A, int S) {
  return (long long)bahdanau::read_smem_bytes(Hq, A, S);
}

// dot != 0: the Luong read (keys bf16, vatt null); else the Bahdanau read
// (keys fp32).
extern "C" int avsr_bahdanau_attend(const void* query, const void* wq, const void* vatt,
                                    const void* keys, const void* values, const void* bias,
                                    const void* mask, void* ctx, void* weights, int N, int Hq,
                                    int A, int S, int Dv, int dot, void* stream) {
  if (N < 1 || S < 1 || Hq < 1 || A % 8 || A > 512 || Dv % 8 || Dv > 2048 ||
      (!dot && vatt == nullptr))
    return (int)cudaErrorInvalidValue;
  auto* const kernel = dot ? &bahdanau_attend_kernel<true> : &bahdanau_attend_kernel<false>;
  const size_t smem = bahdanau::read_smem_bytes(Hq, A, S);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<N, bahdanau::THREADS, smem, reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(query), static_cast<const __nv_bfloat16*>(wq),
      static_cast<const __nv_bfloat16*>(vatt), keys, static_cast<const __nv_bfloat16*>(values),
      static_cast<const float*>(bias), static_cast<const float*>(mask), static_cast<float*>(ctx),
      static_cast<float*>(weights), Hq, A, S, Dv);
  return (int)cudaGetLastError();
}

extern "C" long long avsr_bahdanau_bwd_smem(int Hq, int A, int S, int Dv) {
  return (long long)(bahdanau::read_bwd_smem_floats(Hq, A, S, Dv) * sizeof(float));
}

// dv_rows (Bahdanau only: null for the dot score), dkeys and dvalues are
// accumulated: the caller passes them zeroed.
extern "C" int avsr_bahdanau_attend_bwd(const void* query, const void* wq, const void* vatt,
                                        const void* keys, const void* values, const void* weights,
                                        const void* dctx, void* dquery, void* dq, void* dv_rows,
                                        void* dkeys, void* dvalues, int N, int Hq, int A, int S,
                                        int Dv, int dot, void* stream) {
  if (N < 1 || S < 1 || Hq < 1 || A % 8 || A > 512 || Dv % 8 || Dv > 2048 ||
      (!dot && (vatt == nullptr || dv_rows == nullptr)))
    return (int)cudaErrorInvalidValue;
  auto* const kernel =
      dot ? &bahdanau_attend_bwd_kernel<true> : &bahdanau_attend_bwd_kernel<false>;
  const size_t smem = bahdanau::read_bwd_smem_floats(Hq, A, S, Dv) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<N, bahdanau::THREADS, smem, reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(query), static_cast<const __nv_bfloat16*>(wq),
      static_cast<const __nv_bfloat16*>(vatt), keys, static_cast<const __nv_bfloat16*>(values),
      static_cast<const float*>(weights), static_cast<const float*>(dctx),
      static_cast<float*>(dquery), static_cast<float*>(dq), static_cast<float*>(dv_rows),
      static_cast<float*>(dkeys), static_cast<float*>(dvalues), Hq, A, S, Dv);
  return (int)cudaGetLastError();
}

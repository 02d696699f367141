// K6: single-query decode attention (one new position per row against the
// keys and values it may attend to), the two attention reads of
// avsr_tpu/models/transformer_decoder.py:decode_step:
//
//   * self attention over the bf16 KV cache [N, L, nh*dh] at the shared
//     position pos (transformer_decoder.py:271-280): key j is valid iff
//     j <= pos, the others get -1e9;
//   * cross attention over the prepared memory (_cross_attend_rows,
//     :199-214): keys [N, S, nh*A], values [N, S, nh*dv], the memory's
//     additive bias [N, S] (0 or -1e30).
//
// Per (row n, head h), under the bf16 policy:
//
//   s_j  = float(bf16(q . k_j)) * (1 / sqrt(dk)) + bias[n, j]
//   p    = softmax(s)                                  (fp32)
//   ctx  = bf16(sum_j bf16(p_j) * v_j)                  (fp32 accumulate)
//
// (the scale is the reciprocal product PyTorch's CUDA division by a Python
// scalar computes).  Cross mode adds the bias to every key, masked or not:
// a memory of length 0 has every key at -1e30 and gets the reference's
// uniform weights.  Self mode reads keys 0..pos only: a key past pos has
// score -1e9 + s against a row maximum >= s_0, so its weight exp(-1e9 - m)
// is exactly 0 in fp32 and it adds exactly 0 * v_j to the context, which
// the reference's full-length read also gets; the kernel skips the bytes.
//
// What bounds it on an H100: the bytes of the keys and values read, once
// (HBM), against two FMAs per byte pair: at N = 80 beams, the self read is
// (pos + 1) * 80 * (512 + 512) B (12.3 MB at pos = 149, ~3.7 us) and the
// cross read 80 * 50 * (1024 + 2048) B = 12.3 MB (~3.7 us).  Design: one block
// of 128 threads per (n, h); the query sits in shared memory as fp32;
// scores by groups of dk/8 lanes, each lane one 16-byte chunk of a key row
// (a warp reads four 128-byte rows at a time for dk = 64), reduced with
// shuffles inside the group; the fp32 softmax over the block; P.V with a
// thread per channel pair and the keys split over the remaining thread
// slices, summed in a fixed order (the same bits every run).  Two launches
// per decoder layer per step; the cache write at pos stays a slice
// assignment on the same stream before the self launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;

__device__ __forceinline__ float bf_lo(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float bf_hi(uint32_t v) { return __uint_as_float(v & 0xffff0000u); }
__device__ __forceinline__ float bf_round(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// block-wide max (MAX) or sum of one value per thread, in a fixed order
template <bool MAX>
__device__ __forceinline__ float block_reduce(float x, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float y = __shfl_xor_sync(0xffffffffu, x, o);
    x = MAX ? fmaxf(x, y) : x + y;
  }
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = x;
  __syncthreads();
  float r = red[0];
#pragma unroll
  for (int w = 1; w < WARPS; ++w) r = MAX ? fmaxf(r, red[w]) : r + red[w];
  __syncthreads();  // red is reused by the next reduction
  return r;
}

template <bool HAS_BIAS>
__global__ void __launch_bounds__(THREADS)
decode_attn_kernel(const __nv_bfloat16* __restrict__ q,  // [N, nh, dk]
                   const __nv_bfloat16* __restrict__ k,  // [N, L, nh, dk]
                   const __nv_bfloat16* __restrict__ v,  // [N, L, nh, dv]
                   const float* __restrict__ bias,       // [N, L] (cross mode)
                   __nv_bfloat16* __restrict__ ctx,      // [N, nh, dv]
                   int L, int n_keys, int nh, int dk, int dv) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int h = blockIdx.x, n = blockIdx.y;
  float* q_s = reinterpret_cast<float*>(smem);  // [dk]
  float* p_s = q_s + dk;                        // [n_keys] scores, then bf16(P)
  float* red = p_s + L;                         // [WARPS]
  float* part = red + WARPS;                    // [THREADS * 2] P.V partial sums
  const int tid = threadIdx.x;

  const __nv_bfloat16* qn = q + ((size_t)n * nh + h) * dk;
  for (int i = tid; i < dk; i += THREADS) q_s[i] = __bfloat162float(qn[i]);
  __syncthreads();

  // scores: G lanes per key, each lane a 16-byte chunk (8 elements) of it
  const int cpr = dk / 8;
  int G = 1;
  while (G * 2 <= cpr && G * 2 <= 32) G *= 2;
  const int groups = THREADS / G, g = tid / G, lg = tid % G;
  const size_t row = (size_t)nh * dk;
  const __nv_bfloat16* kb = k + ((size_t)n * L * nh + h) * dk;
  const float inv_sq = 1.0f / sqrtf((float)dk);
  for (int j0 = 0; j0 < n_keys; j0 += groups) {  // uniform trip count: shuffles are safe
    const int j = j0 + g;
    float acc = 0.f;
    if (j < n_keys) {
      const uint4* kr = reinterpret_cast<const uint4*>(kb + (size_t)j * row);
      for (int c = lg; c < cpr; c += G) {
        const uint4 u = kr[c];
        const float* qq = q_s + c * 8;
        acc = fmaf(qq[0], bf_lo(u.x), acc);
        acc = fmaf(qq[1], bf_hi(u.x), acc);
        acc = fmaf(qq[2], bf_lo(u.y), acc);
        acc = fmaf(qq[3], bf_hi(u.y), acc);
        acc = fmaf(qq[4], bf_lo(u.z), acc);
        acc = fmaf(qq[5], bf_hi(u.z), acc);
        acc = fmaf(qq[6], bf_lo(u.w), acc);
        acc = fmaf(qq[7], bf_hi(u.w), acc);
      }
    }
    for (int o = G / 2; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if (j < n_keys && lg == 0) {
      float s = bf_round(acc) * inv_sq;
      if (HAS_BIAS) s += bias[(size_t)n * L + j];
      p_s[j] = s;
    }
  }
  __syncthreads();

  // fp32 softmax over the block; P rounded to bf16 for the product
  float mx = __int_as_float(0xff800000u);  // -inf
  for (int j = tid; j < n_keys; j += THREADS) mx = fmaxf(mx, p_s[j]);
  mx = block_reduce<true>(mx, red);
  float sum = 0.f;
  for (int j = tid; j < n_keys; j += THREADS) {
    const float e = expf(p_s[j] - mx);
    p_s[j] = e;
    sum += e;
  }
  sum = block_reduce<false>(sum, red);
  for (int j = tid; j < n_keys; j += THREADS) p_s[j] = bf_round(p_s[j] / sum);
  __syncthreads();

  // P.V: a thread per channel pair, keys split over `slices` thread groups
  const int npair = dv / 2;
  const size_t vrow = (size_t)nh * dv;
  const __nv_bfloat16* vb = v + ((size_t)n * L * nh + h) * dv;
  __nv_bfloat162* out = reinterpret_cast<__nv_bfloat162*>(ctx + ((size_t)n * nh + h) * dv);
  if (npair > THREADS) {
    for (int cp = tid; cp < npair; cp += THREADS) {
      float a0 = 0.f, a1 = 0.f;
      for (int j = 0; j < n_keys; ++j) {
        const uint32_t vv = reinterpret_cast<const uint32_t*>(vb + (size_t)j * vrow)[cp];
        a0 = fmaf(p_s[j], bf_lo(vv), a0);
        a1 = fmaf(p_s[j], bf_hi(vv), a1);
      }
      out[cp] = __floats2bfloat162_rn(a0, a1);
    }
    return;
  }
  const int slices = THREADS / npair;
  const int cp = tid % npair, sl = tid / npair;
  if (sl < slices) {
    float a0 = 0.f, a1 = 0.f;
    for (int j = sl; j < n_keys; j += slices) {
      const uint32_t vv = reinterpret_cast<const uint32_t*>(vb + (size_t)j * vrow)[cp];
      a0 = fmaf(p_s[j], bf_lo(vv), a0);
      a1 = fmaf(p_s[j], bf_hi(vv), a1);
    }
    part[2 * tid] = a0;
    part[2 * tid + 1] = a1;
  }
  __syncthreads();
  if (tid < npair) {
    float a0 = 0.f, a1 = 0.f;
    for (int s = 0; s < slices; ++s) {
      a0 += part[2 * (s * npair + tid)];
      a1 += part[2 * (s * npair + tid) + 1];
    }
    out[tid] = __floats2bfloat162_rn(a0, a1);
  }
}

}  // namespace

// bias null: self mode over keys [0, n_keys); else cross mode, n_keys = L.
extern "C" int avsr_decode_attn(const void* q, const void* k, const void* v, const void* bias,
                                void* ctx, int N, int L, int n_keys, int nh, int dk, int dv,
                                void* stream) {
  if (dk % 8 || dv % 8 || n_keys < 1 || n_keys > L || N < 1 || nh < 1)
    return (int)cudaErrorInvalidValue;
  if (bias != nullptr && n_keys != L) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(dk + L + WARPS + 2 * THREADS) * sizeof(float);
  const dim3 grid(nh, N);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const __nv_bfloat16* qb = static_cast<const __nv_bfloat16*>(q);
  const __nv_bfloat16* kb = static_cast<const __nv_bfloat16*>(k);
  const __nv_bfloat16* vb = static_cast<const __nv_bfloat16*>(v);
  __nv_bfloat16* cb = static_cast<__nv_bfloat16*>(ctx);
  if (bias == nullptr) {
    decode_attn_kernel<false><<<grid, THREADS, smem, st>>>(qb, kb, vb, nullptr, cb, L, n_keys,
                                                           nh, dk, dv);
  } else {
    decode_attn_kernel<true><<<grid, THREADS, smem, st>>>(
        qb, kb, vb, static_cast<const float*>(bias), cb, L, n_keys, nh, dk, dv);
  }
  return (int)cudaGetLastError();
}

// K8: the AV-Align fusion scan, forward and backward.  Replaces the scan
// body of avsr_tpu/models/fusion.py:av_align_apply (:118-141): a unidirectional
// LSTM over the audio encoder's output with input feeding, and at every
// audio step one attention read of the video memory with the new h as the
// query, Bahdanau (fp32 projected keys [B, S, A], v) or Luong (the bf16
// memory as keys [B, S, Hk], no v): the read's template argument DOT, and
// the entry points' dot flag.  Per step t, under the bf16 policy:
//
//   gates  = ((xw[t] + bf16(ctx) @ bf16(ctx_proj)) + bf16(h) @ bf16(Wh)) + b
//            (xw is the hoisted fp32 input product; fp32 accumulation)
//   i, f, o = sigmoid; g = tanh;  c' = f*c + i*g;  h' = o * tanh(c')
//   ctx', w = read(query h', the video memory)          (bahdanau_core.cuh)
//   m = mask[t, b]:  (h, c, ctx) <- m*(h', c', ctx') + (1-m)*(h, c, ctx)
//   hs[t] = h' * m;  ctxs[t] = ctx' * m;  aligns[t] = w * m
//
// The read's query is h' itself, not the masked carry.  A row whose step is
// masked (m == 0) keeps its carries and emits zeros, so its read is
// skipped: that is exactly what the masked update makes of it.
//
// The forward has two routes, chosen by shape (kernels.av_align_family):
// every preset's widths take avsr_av_align_fwd, one persistent launch of
// 16-CTA thread-block clusters per call (av_align_fwd.cuh has its design:
// [Wh ; ctx_proj] resident in shared memory, the gate products on the
// tensor cores, h, ctx and q exchanged between the CTAs); other widths take
// avsr_av_align_scan, the per-step kernels below.
//
// The per-step route: one host loop in C over the T steps, two launches per
// step on the caller's stream.  (a) Gate launch: a block owns BT = 16 batch
// rows x UT = 16 hidden units and computes all four gates of its units from
// the bf16 ctx and h rows (staged in shared memory) against the pre-tiled
// [K][UT][4] weight slices (K1's layout, kernels.tile_lstm_weights), with
// fp32 FMAs on bf16-rounded operands; it applies the cell update and the
// mask and writes h' for the read.  (b) Read launch: a block per batch row
// runs bahdanau::read and the masked epilogue.  h and ctx are
// double-buffered in device memory, c is updated in place (only its owner
// reads it).  A step costs two launches' latency, the staging of each gate
// block's weight slices and the read's dependent reductions.  With save
// (training), the gate launch also writes the fp32 h and c entering the
// step and the read launch the fp32 ctx entering it: the carries the
// reference's jax.checkpoint keeps, the backward's residuals (~103 MB at
// T = 197, B = 128; the cluster route writes the same).  The backward is
// described further down, above its kernels.
//
// The fp32 policy (train.compute_dtype = "float32"; avsr_av_align_scan_f32,
// counted as av_align_scan_f32): the per-step route's instance on fp32 Wh,
// ctx_proj, wq, v and values, every bf16 rounding point above the identity
// and the products fp32 FMAs on fp32 operands (the reference's same lines
// with every cast to the compute dtype the identity; tanhf, never
// tanh_fast).  Every fp32 shape takes it (kernels.av_align_family routes by
// dtype: the cluster forward keeps bf16 [Wh ; ctx_proj] resident for the
// tensor cores).  A block's fp32 slices of [Wh ; ctx_proj] are 196 KB at
// align's H = 256, Dc = 512, and with its fp32 h and ctx rows would pass
// the 227 KB a block may use, so the fp32 gate launch stages them in chunks
// of RCH_E<float> = 128 input rows (32 KB, with the rows' 8 KB), summing
// the same terms in the same order.  What bounds a step on an H100: the
// 128 blocks' 25 MB of weight slices from L2 (B = 128) and the chunks'
// barriers, the read's dependent reductions, and two launches' latency;
// its arithmetic, 2 x 128 x 768 x 1024 FLOP (0.2 GFLOP, 3 us at 67 TFLOP/s
// fp32), is the least of it.

#include "av_align_fwd.cuh"
#include "bahdanau_core.cuh"

namespace {

constexpr int BT = 16;  // batch rows per gate block
constexpr int UT = 16;  // hidden units per gate block
constexpr int GTHREADS = BT * UT;
constexpr int VEC = 8;  // 16-byte loads in flight per thread while staging

__device__ __forceinline__ float sigmoidf_(float x) { return 1.0f / (1.0f + expf(-x)); }

// A contiguous run of n 16-byte chunks into shared memory.
__device__ __forceinline__ void stage_copy(uint4* dst, const uint4* src, int n, int tid) {
  for (int c0 = tid; c0 < n; c0 += VEC * GTHREADS) {
    uint4 v[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const int ci = c0 + j * GTHREADS;
      if (ci < n) v[j] = src[ci];
    }
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const int ci = c0 + j * GTHREADS;
      if (ci < n) dst[ci] = v[j];
    }
  }
}

// Input rows of [Wh ; ctx_proj] a chunk of the chunked gate product stages:
// 32 KB of a block's weight slices in either element type.
constexpr int RCH = 256;
template <typename E>
__host__ __device__ constexpr int rch() {
  return RCH * 2 / (int)sizeof(E);
}

// Rows row0 .. row0 + BT of an fp32 [B, K] matrix, rounded to bf16, into
// dst [BT][K]; rows past B are zero.
__device__ __forceinline__ void stage_rows(__nv_bfloat16* dst, const float* src, int row0, int B,
                                           int K, int tid) {
  const int per_row = K / 4;
  const int n = BT * per_row;
  __nv_bfloat162* d2 = reinterpret_cast<__nv_bfloat162*>(dst);
  for (int c0 = tid; c0 < n; c0 += VEC * GTHREADS) {
    float4 v[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const int ci = c0 + j * GTHREADS;
      const int rr = ci / per_row;
      v[j] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (ci < n && row0 + rr < B)
        v[j] = reinterpret_cast<const float4*>(src + (size_t)(row0 + rr) * K)[ci - rr * per_row];
    }
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const int ci = c0 + j * GTHREADS;
      if (ci < n) {
        d2[2 * ci] = __floats2bfloat162_rn(v[j].x, v[j].y);
        d2[2 * ci + 1] = __floats2bfloat162_rn(v[j].z, v[j].w);
      }
    }
  }
}

// a[q] += sum_k x[k] * W[k, q*H + unit] for the four gates q, from a bf16
// row x_s [K] and the block's tiled slice w_s [K][UT][4].
__device__ __forceinline__ void gate_product(const __nv_bfloat16* x_s, const __nv_bfloat16* w_s,
                                             int u, int K, float (&a)[4]) {
  const uint32_t* xr = reinterpret_cast<const uint32_t*>(x_s);  // bf16 pairs
  const uint2* wu = reinterpret_cast<const uint2*>(w_s) + u;      // 4 gates / k
#pragma unroll 4
  for (int k2 = 0; k2 < K / 2; ++k2) {
    const uint32_t xx = xr[k2];
    const uint2 w0 = wu[(2 * k2) * UT];
    const uint2 w1 = wu[(2 * k2 + 1) * UT];
    const float x0 = bahdanau::bf_lo(xx), x1 = bahdanau::bf_hi(xx);
    a[0] = fmaf(x0, bahdanau::bf_lo(w0.x), a[0]);
    a[1] = fmaf(x0, bahdanau::bf_hi(w0.x), a[1]);
    a[2] = fmaf(x0, bahdanau::bf_lo(w0.y), a[2]);
    a[3] = fmaf(x0, bahdanau::bf_hi(w0.y), a[3]);
    a[0] = fmaf(x1, bahdanau::bf_lo(w1.x), a[0]);
    a[1] = fmaf(x1, bahdanau::bf_hi(w1.x), a[1]);
    a[2] = fmaf(x1, bahdanau::bf_lo(w1.y), a[2]);
    a[3] = fmaf(x1, bahdanau::bf_hi(w1.y), a[3]);
  }
}

// fp32 a[q] += sum_k x[k] * W[k, q*H + unit] (the fp32 policy's instance):
// the same terms in the same order.
__device__ __forceinline__ void gate_product(const float* x_s, const float* w_s, int u, int K,
                                             float (&a)[4]) {
  const float4* wu = reinterpret_cast<const float4*>(w_s) + u;  // 4 gates / k
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    const float x = x_s[k];
    const float4 w = wu[k * UT];
    a[0] = fmaf(x, w.x, a[0]);
    a[1] = fmaf(x, w.y, a[1]);
    a[2] = fmaf(x, w.z, a[2]);
    a[3] = fmaf(x, w.w, a[3]);
  }
}

// Columns [k0, k0 + kn) of rows row0 .. row0 + BT of an fp32 [B, K] matrix,
// rounded to bf16 (or copied, for an fp32 dst), into dst [BT][kn]; rows
// past B are zero (kn, k0 multiples of 4).
__device__ __forceinline__ void stage_cols(__nv_bfloat16* dst, const float* src, int row0, int B,
                                           int K, int k0, int kn, int tid) {
  const int per_row = kn / 4;
  __nv_bfloat162* d2 = reinterpret_cast<__nv_bfloat162*>(dst);
  for (int ci = tid; ci < BT * per_row; ci += GTHREADS) {
    const int rr = ci / per_row;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + rr < B)
      v = reinterpret_cast<const float4*>(src + (size_t)(row0 + rr) * K + k0)[ci - rr * per_row];
    d2[2 * ci] = __floats2bfloat162_rn(v.x, v.y);
    d2[2 * ci + 1] = __floats2bfloat162_rn(v.z, v.w);
  }
}
__device__ __forceinline__ void stage_cols(float* dst, const float* src, int row0, int B, int K,
                                           int k0, int kn, int tid) {
  const int per_row = kn / 4;
  float4* d4 = reinterpret_cast<float4*>(dst);
  for (int ci = tid; ci < BT * per_row; ci += GTHREADS) {
    const int rr = ci / per_row;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + rr < B)
      v = reinterpret_cast<const float4*>(src + (size_t)(row0 + rr) * K + k0)[ci - rr * per_row];
    d4[ci] = v;
  }
}

// a[q] += sum_k x[k] W[k, q H + unit] over the K rows of one input (the
// carried context against ctx_proj, or h against Wh), rch<E>() rows at a
// time: the same terms in the same order as gate_product over all K at
// once.  Every thread of the block takes part (barriers inside).
template <typename E>
__device__ __forceinline__ void gate_product_chunked(const E* __restrict__ w_tiled,
                                                     const float* __restrict__ x, int row0,
                                                     int B, int K, int r, int u, int tid,
                                                     E* w_s, E* x_s, float (&a)[4]) {
  for (int k0 = 0; k0 < K; k0 += rch<E>()) {
    const int kn = min(rch<E>(), K - k0);
    __syncthreads();  // the previous chunk is consumed
    stage_copy(reinterpret_cast<uint4*>(w_s),
               reinterpret_cast<const uint4*>(w_tiled + (size_t)k0 * UT * 4),
               kn * UT * 4 * (int)sizeof(E) / 16, tid);
    stage_cols(x_s, x, row0, B, K, k0, kn, tid);
    __syncthreads();
    gate_product(x_s + (size_t)r * kn, w_s, u, kn, a);
  }
}

// The cell update from the four gates' sums, the mask and the step's
// outputs of one (row, unit): both gate launches' epilogue.
__device__ __forceinline__ void gate_cell(const float (&xg)[4], const float (&ac)[4],
                                          const float (&ah)[4], const float (&bq)[4],
                                          float c_prev, float h_prev, float m, size_t s,
                                          float* __restrict__ h_out, float* __restrict__ c,
                                          float* __restrict__ hnew, float* __restrict__ hs_t) {
  float gt[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) gt[q] = ((xg[q] + ac[q]) + ah[q]) + bq[q];
  const float i = sigmoidf_(gt[0]);
  const float f = sigmoidf_(gt[1]);
  const float g = tanhf(gt[2]);
  const float o = sigmoidf_(gt[3]);
  const float c_new = f * c_prev + i * g;
  const float h_new = o * tanhf(c_new);
  h_out[s] = m * h_new + (1.0f - m) * h_prev;
  c[s] = m * c_new + (1.0f - m) * c_prev;
  hnew[s] = h_new;
  hs_t[s] = h_new * m;
}

__global__ void __launch_bounds__(GTHREADS)
align_gate_kernel(const __nv_bfloat16* __restrict__ wh_tiled,  // [H/UT, H, UT, 4]
                  const __nv_bfloat16* __restrict__ cp_tiled,  // [H/UT, Dc, UT, 4] or null
                  const float* __restrict__ bias,              // [4H]
                  const float* __restrict__ xw_t,              // [B, 4H]
                  const float* __restrict__ mask_t,            // [B]
                  const float* __restrict__ h_in,              // [B, H]
                  float* __restrict__ h_out,                   // [B, H]
                  float* __restrict__ c,                       // [B, H] in place
                  const float* __restrict__ ctx_in,            // [B, Dc]
                  float* __restrict__ hnew,                    // [B, H] h' (the read's query)
                  float* __restrict__ hs_t,                    // [B, H]
                  float* __restrict__ h_res_t,                 // [B, H] or null (save)
                  float* __restrict__ c_res_t,                 // [B, H] or null (save)
                  int B, int H, int Dc) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* wh_s = reinterpret_cast<__nv_bfloat16*>(smem);  // [H][UT][4]
  __nv_bfloat16* cp_s = wh_s + (size_t)H * UT * 4;                // [Dc][UT][4]
  __nv_bfloat16* h_s = cp_s + (size_t)Dc * UT * 4;                // [BT][H]
  __nv_bfloat16* x_s = h_s + (size_t)BT * H;                      // [BT][Dc]

  const int tile = blockIdx.x;
  const int row0 = blockIdx.y * BT;
  const int tid = threadIdx.x;
  const int r = tid / UT;
  const int u = tid - r * UT;
  const int row = row0 + r;
  const int unit = tile * UT + u;
  const bool live = row < B;

  // Epilogue operands first, so their latency overlaps the staging.
  const size_t s = (size_t)(live ? row : 0) * H + unit;
  float xg[4] = {0.f, 0.f, 0.f, 0.f}, c_prev = 0.f, h_prev = 0.f, m = 0.f;
  if (live) {
    const float* x = xw_t + (size_t)row * 4 * H;
#pragma unroll
    for (int q = 0; q < 4; ++q) xg[q] = x[q * H + unit];
    c_prev = c[s];
    h_prev = h_in[s];
    m = mask_t[row];
    if (h_res_t != nullptr) {  // the carries entering step t
      h_res_t[s] = h_prev;
      c_res_t[s] = c_prev;
    }
  }
  float bq[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) bq[q] = bias[q * H + unit];

  stage_copy(reinterpret_cast<uint4*>(wh_s),
             reinterpret_cast<const uint4*>(wh_tiled + (size_t)tile * H * UT * 4),
             H * UT * 4 / 8, tid);
  stage_rows(h_s, h_in, row0, B, H, tid);
  if (Dc > 0) {
    stage_copy(reinterpret_cast<uint4*>(cp_s),
               reinterpret_cast<const uint4*>(cp_tiled + (size_t)tile * Dc * UT * 4),
               Dc * UT * 4 / 8, tid);
    stage_rows(x_s, ctx_in, row0, B, Dc, tid);
  }
  __syncthreads();

  float ac[4] = {0.f, 0.f, 0.f, 0.f}, ah[4] = {0.f, 0.f, 0.f, 0.f};
  if (Dc > 0) gate_product(x_s + (size_t)r * Dc, cp_s, u, Dc, ac);
  gate_product(h_s + (size_t)r * H, wh_s, u, H, ah);
  if (!live) return;
  gate_cell(xg, ac, ah, bq, c_prev, h_prev, m, s, h_out, c, hnew, hs_t);
}

// The fp32 policy's gate launch: align_gate_kernel's arithmetic on fp32
// operands (no rounding point), the weight slices and the h / ctx rows
// staged rch<float>() input rows at a time.
__global__ void __launch_bounds__(GTHREADS)
align_gate_f32_kernel(const float* __restrict__ wh_tiled,  // [H/UT, H, UT, 4]
                      const float* __restrict__ cp_tiled,  // [H/UT, Dc, UT, 4] or null
                      const float* __restrict__ bias,      // [4H]
                      const float* __restrict__ xw_t,      // [B, 4H]
                      const float* __restrict__ mask_t,    // [B]
                      const float* __restrict__ h_in,      // [B, H]
                      float* __restrict__ h_out,           // [B, H]
                      float* __restrict__ c,               // [B, H] in place
                      const float* __restrict__ ctx_in,    // [B, Dc]
                      float* __restrict__ hnew,            // [B, H] h' (the read's query)
                      float* __restrict__ hs_t,            // [B, H]
                      float* __restrict__ h_res_t,         // [B, H] or null (save)
                      float* __restrict__ c_res_t,         // [B, H] or null (save)
                      int B, int H, int Dc) {
  __shared__ __align__(16) float w_s[rch<float>() * UT * 4];
  __shared__ __align__(16) float x_s[BT * rch<float>()];

  const int tile = blockIdx.x;
  const int row0 = blockIdx.y * BT;
  const int tid = threadIdx.x;
  const int r = tid / UT;
  const int u = tid - r * UT;
  const int row = row0 + r;
  const int unit = tile * UT + u;
  const bool live = row < B;

  const size_t s = (size_t)(live ? row : 0) * H + unit;
  float xg[4] = {0.f, 0.f, 0.f, 0.f}, c_prev = 0.f, h_prev = 0.f, m = 0.f;
  if (live) {
    const float* x = xw_t + (size_t)row * 4 * H;
#pragma unroll
    for (int q = 0; q < 4; ++q) xg[q] = x[q * H + unit];
    c_prev = c[s];
    h_prev = h_in[s];
    m = mask_t[row];
    if (h_res_t != nullptr) {  // the carries entering step t
      h_res_t[s] = h_prev;
      c_res_t[s] = c_prev;
    }
  }
  float bq[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) bq[q] = bias[q * H + unit];

  float ac[4] = {0.f, 0.f, 0.f, 0.f}, ah[4] = {0.f, 0.f, 0.f, 0.f};
  if (Dc > 0)
    gate_product_chunked(cp_tiled + (size_t)tile * Dc * UT * 4, ctx_in, row0, B, Dc, r, u, tid,
                         w_s, x_s, ac);
  gate_product_chunked(wh_tiled + (size_t)tile * H * UT * 4, h_in, row0, B, H, r, u, tid, w_s,
                       x_s, ah);
  if (!live) return;
  gate_cell(xg, ac, ah, bq, c_prev, h_prev, m, s, h_out, c, hnew, hs_t);
}

using align_fwd::AlignWeights;
using bahdanau::Key;

struct AlignContext {
  const float* ctx_in;  // this row's carry [Dv]
  float* ctx_out;
  float* ctxs;          // this row's [Dv] slice of ctxs[t]
  float m;
  __device__ void operator()(int d, float x) const {
    ctxs[d] = x * m;
    ctx_out[d] = m * x + (1.0f - m) * ctx_in[d];
  }
};

template <bool DOT, typename E>
__global__ void __launch_bounds__(bahdanau::THREADS)
align_read_kernel_t(const float* __restrict__ hnew,            // [B, H]
                    const float* __restrict__ mask_t,          // [B]
                    const E* __restrict__ wq,                  // [H, A]
                    const E* __restrict__ vatt,                // [A] or null (dot)
                    const void* __restrict__ keys_in,          // [B, S, A] Key<DOT>
                    const E* __restrict__ values,              // [B, S, Dv]
                    const float* __restrict__ mbias,           // [B, S]
                    const float* __restrict__ mmask,           // [B, S]
                    const float* __restrict__ ctx_in,          // [B, Dv]
                    float* __restrict__ ctx_out,               // [B, Dv]
                    float* __restrict__ ctxs_t,                // [B, Dv]
                    float* __restrict__ aligns_t,              // [B, S]
                    float* __restrict__ ctx_res_t,             // [B, Dv] or null (save)
                    int H, int A, int S, int Dv) {
  extern __shared__ __align__(16) unsigned char smem[];
  const auto* keys = static_cast<const typename Key<DOT>::type*>(keys_in);
  const size_t b = blockIdx.x;
  const float m = mask_t[b];
  if (ctx_res_t != nullptr)  // the context carry entering step t
    for (int d = threadIdx.x; d < Dv; d += bahdanau::THREADS)
      ctx_res_t[b * Dv + d] = ctx_in[b * Dv + d];
  if (m == 0.f) {  // a masked step: carry the context, emit zeros
    for (int d = threadIdx.x; d < Dv; d += bahdanau::THREADS) {
      ctx_out[b * Dv + d] = ctx_in[b * Dv + d];
      ctxs_t[b * Dv + d] = 0.f;
    }
    for (int s = threadIdx.x; s < S; s += bahdanau::THREADS) aligns_t[b * S + s] = 0.f;
    return;
  }
  bahdanau::read<DOT>(hnew + b * H, wq, vatt, keys + b * S * A, values + b * S * Dv,
                      mbias + b * S, mmask + b * S, H, A, S, Dv, reinterpret_cast<float*>(smem),
                      AlignWeights{aligns_t + b * S, m},
                      AlignContext{ctx_in + b * Dv, ctx_out + b * Dv, ctxs_t + b * Dv, m});
}

size_t gate_smem_bytes(int H, int Dc) {
  return ((size_t)H * UT * 4 + (size_t)Dc * UT * 4 + (size_t)BT * H + (size_t)BT * Dc) *
         sizeof(__nv_bfloat16);
}

// the fp32 gate launch's (static) shared memory: a chunk's slices and rows
constexpr size_t GATE_F32_SMEM = ((size_t)rch<float>() * UT * 4 + BT * rch<float>()) *
                                 sizeof(float);

// The per-step forward's host loop over the T steps, two launches a step
// (gate, read) on E operands (bf16: the whole slices staged, dynamic
// shared memory; fp32: the chunked gate launch).  Operands as
// avsr_av_align_scan's.
template <bool DOT, typename E>
int step_scan(const void* wh_tiled, const void* cp_tiled, const void* bias, const void* xw,
              const void* mask, const void* wq, const void* vatt, const void* keys,
              const void* values, const void* mbias, const void* mmask, void* hbuf, void* c,
              void* ctxbuf, void* hnew, void* hs, void* ctxs, void* aligns, void* h_res,
              void* c_res, void* ctx_res, int T, int B, int H, int Dc, int A, int S, int Dv,
              cudaStream_t st) {
  constexpr bool F32 = sizeof(E) == 4;
  const size_t smem_g = F32 ? 0 : gate_smem_bytes(H, Dc);
  const size_t smem_r = bahdanau::read_smem_bytes(H, A, S);
  auto* const align_read_kernel = &align_read_kernel_t<DOT, E>;
  cudaError_t e;
  if (smem_g > 48 * 1024) {
    e = cudaFuncSetAttribute(align_gate_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_g);
    if (e != cudaSuccess) return (int)e;
  }
  if (smem_r > 48 * 1024) {
    e = cudaFuncSetAttribute(align_read_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_r);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 ggrid(H / UT, (B + BT - 1) / BT);
  const size_t bh = (size_t)B * H, bd = (size_t)B * Dv;
  const float* xw_p = static_cast<const float*>(xw);
  const float* mask_p = static_cast<const float*>(mask);
  float* h_p = static_cast<float*>(hbuf);
  float* ctx_p = static_cast<float*>(ctxbuf);
  float* hs_p = static_cast<float*>(hs);
  float* ctxs_p = static_cast<float*>(ctxs);
  float* al_p = static_cast<float*>(aligns);
  const bool save = h_res != nullptr && c_res != nullptr && ctx_res != nullptr;
  float* hr_p = static_cast<float*>(h_res);
  float* cr_p = static_cast<float*>(c_res);
  float* xr_p = static_cast<float*>(ctx_res);
  for (int t = 0; t < T; ++t) {
    const size_t cur = (size_t)(t & 1), nxt = (size_t)((t + 1) & 1);
    const float* b_p = static_cast<const float*>(bias);
    float* hr_t = save ? hr_p + (size_t)t * bh : nullptr;
    float* cr_t = save ? cr_p + (size_t)t * bh : nullptr;
    if constexpr (F32)
      align_gate_f32_kernel<<<ggrid, GTHREADS, 0, st>>>(
          static_cast<const float*>(wh_tiled), static_cast<const float*>(cp_tiled), b_p,
          xw_p + (size_t)t * B * 4 * H, mask_p + (size_t)t * B, h_p + cur * bh, h_p + nxt * bh,
          static_cast<float*>(c), ctx_p + cur * bd, static_cast<float*>(hnew),
          hs_p + (size_t)t * bh, hr_t, cr_t, B, H, Dc);
    else
      align_gate_kernel<<<ggrid, GTHREADS, smem_g, st>>>(
          static_cast<const __nv_bfloat16*>(wh_tiled),
          static_cast<const __nv_bfloat16*>(cp_tiled), b_p, xw_p + (size_t)t * B * 4 * H,
          mask_p + (size_t)t * B, h_p + cur * bh, h_p + nxt * bh, static_cast<float*>(c),
          ctx_p + cur * bd, static_cast<float*>(hnew), hs_p + (size_t)t * bh, hr_t, cr_t, B, H,
          Dc);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    align_read_kernel<<<B, bahdanau::THREADS, smem_r, st>>>(
        static_cast<const float*>(hnew), mask_p + (size_t)t * B, static_cast<const E*>(wq),
        static_cast<const E*>(vatt), keys, static_cast<const E*>(values),
        static_cast<const float*>(mbias), static_cast<const float*>(mmask), ctx_p + cur * bd,
        ctx_p + nxt * bd, ctxs_p + (size_t)t * bd, al_p + (size_t)t * B * S,
        save ? xr_p + (size_t)t * bd : nullptr, H, A, S, Dv);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Backward: the reverse scan of the gradient JAX's autodiff takes through the
// rematerialized body (fusion.py:118-141), from the carries saved by the
// forward (h_res, c_res, ctx_res: fp32, entering each step), the forward's
// alignments (a live row's read weights) and the cotangents dhs, dctxs of
// the outputs and dhT, dcT, dctxT of the final carries.  Per step t, from
// T-1 down to 0, with m = mask[t, b]:
//
//   dctx' = m * (dctx_out + dctxs[t])                 (the read's cotangent)
//   read backward (skipped when m == 0: its cotangent is 0) -> dquery, dq[t],
//   dsc[t] (the scores' cotangent)
//   dh' = m * (dh_out + dhs[t]) + dquery
//   the LSTM cell backward on the recomputed gates -> dgates = dxw[t] (fp32,
//   as xw is), db +=, dc <- dc' * f + (1 - m) * dc_out
//   dh_out(t-1)   = bf16(dgates @ Wh^T)       + (1 - m) * dh_out
//   dctx_out(t-1) = bf16(dgates @ ctx_proj^T) + (1 - m) * dctx_out
//
// (the bf16 roundings are the transposes of the reference's casts).  The
// memory's gradients dkeys and dvalues are sums over t of terms formed from
// dsc[t], dctx'[t] and q[t] (av_align_bwd.cuh), taken after the scan.
// dWh, dctx_proj, dwq and dv are single fp32 products after the scan, over
// the saved carries, dxw, dq, the recomputed queries and dv's rows (left to
// the caller, as K1 leaves dWh).
//
// Launches (av_align_bwd.cuh has the design): (1) the regate recomputes
// every step's gates and h' from the saved carries in parallel over time,
// into fp32 act [T, B, 4H] and hnew [T, B, H]; (2) the query launch, q from
// hnew; (3) the recurrence, one launch of thread-block clusters walking all
// T steps; (4) the sums after the scan (two launches).  Widths the
// recurrence does not take run the per-step backward (av_align_step_bwd.cuh),
// chosen by shape (kernels.av_align_bwd_family).
// ---------------------------------------------------------------------------

}  // namespace

#include "av_align_step_bwd.cuh"

// Shared memory per block of the forward's largest launch, in bytes.
extern "C" long long avsr_av_align_smem(int H, int Dc, int A, int S, int Dv) {
  (void)Dv;
  const size_t g = gate_smem_bytes(H, Dc), r = bahdanau::read_smem_bytes(H, A, S);
  return (long long)(g > r ? g : r);
}

// wh_tiled [H/UT, H, UT, 4] and cp_tiled [H/UT, Dc, UT, 4] bf16 (cp_tiled
// null and Dc = 0 without input feeding, else Dc = Dv); bias [4H]; xw
// [T, B, 4H] and mask [T, B] fp32; wq [H, A], vatt [A] bf16 (null when dot);
// keys [B, S, A] fp32 (bf16 when dot: the Luong read), values [B, S, Dv]
// bf16, mbias / mmask [B, S] fp32.  hbuf [2][B, H]
// and ctxbuf [2][B, Dv] fp32 hold the zero initial carries in slot 0; after
// T steps the final ones are in slot T % 2; c [B, H] fp32 in place; hnew
// [B, H] fp32 scratch.  Outputs hs [T, B, H], ctxs [T, B, Dv], aligns
// [T, B, S] fp32; with save, h_res / c_res [T, B, H] and ctx_res [T, B, Dv]
// fp32 (all three null without).
extern "C" int avsr_av_align_scan(const void* wh_tiled, const void* cp_tiled, const void* bias,
                                  const void* xw, const void* mask, const void* wq,
                                  const void* vatt, const void* keys, const void* values,
                                  const void* mbias, const void* mmask, void* hbuf, void* c,
                                  void* ctxbuf, void* hnew, void* hs, void* ctxs, void* aligns,
                                  void* h_res, void* c_res, void* ctx_res,
                                  int T, int B, int H, int Dc, int A, int S, int Dv, int dot,
                                  void* stream) {
  if (B < 1 || S < 1 || H % UT || H % 4 || Dc % 4 || (Dc > 0 && cp_tiled == nullptr) ||
      A % 8 || A > 512 || Dv % 8 || Dv > 2048 || (!dot && vatt == nullptr))
    return (int)cudaErrorInvalidValue;
  using bf = __nv_bfloat16;
  auto* const scan = dot ? &step_scan<true, bf> : &step_scan<false, bf>;
  return scan(wh_tiled, cp_tiled, bias, xw, mask, wq, vatt, keys, values, mbias, mmask, hbuf, c,
              ctxbuf, hnew, hs, ctxs, aligns, h_res, c_res, ctx_res, T, B, H, Dc, A, S, Dv,
              reinterpret_cast<cudaStream_t>(stream));
}

// The fp32 policy's per-step forward (the Bahdanau read): wh_tiled,
// cp_tiled, wq, vatt and values fp32, the rest as avsr_av_align_scan's.
extern "C" int avsr_av_align_scan_f32(const void* wh_tiled, const void* cp_tiled,
                                      const void* bias, const void* xw, const void* mask,
                                      const void* wq, const void* vatt, const void* keys,
                                      const void* values, const void* mbias, const void* mmask,
                                      void* hbuf, void* c, void* ctxbuf, void* hnew, void* hs,
                                      void* ctxs, void* aligns, void* h_res, void* c_res,
                                      void* ctx_res, int T, int B, int H, int Dc, int A, int S,
                                      int Dv, void* stream) {
  if (B < 1 || S < 1 || H % UT || Dc % UT || (Dc > 0 && cp_tiled == nullptr) || A % 8 ||
      A > 512 || Dv % 8 || Dv > 2048 || vatt == nullptr)
    return (int)cudaErrorInvalidValue;
  return step_scan<false, float>(wh_tiled, cp_tiled, bias, xw, mask, wq, vatt, keys, values,
                                 mbias, mmask, hbuf, c, ctxbuf, hnew, hs, ctxs, aligns, h_res,
                                 c_res, ctx_res, T, B, H, Dc, A, S, Dv,
                                 reinterpret_cast<cudaStream_t>(stream));
}

// The fp32 per-step forward's shared memory per block of its largest
// launch, in bytes: the chunked gate launch's or the read's.
extern "C" long long avsr_av_align_f32_smem(int H, int Dc, int A, int S, int Dv) {
  (void)Dc;
  (void)Dv;
  const size_t r = bahdanau::read_smem_bytes(H, A, S);
  return (long long)(GATE_F32_SMEM > r ? GATE_F32_SMEM : r);
}

// The cluster route of the forward (av_align_fwd.cuh).  Shapes it takes: H
// = 128 or 256 (one or two unit groups of 8 a CTA), Dc = Dv a multiple of
// 64 up to 2048 (input feeding), A a multiple of 128 up to 512 (A / 16
// columns of q a CTA: whole n-tiles), S >= 1, and its shared memory within
// the card's; rpc = 1 or 2 rows per CTA.
namespace {

constexpr size_t SMEM_LIMIT = 232448;  // bytes a block may use on an H100

bool fwd_shape_ok(int H, int Dc, int A, int S, int Dv, int rpc) {
  return (rpc == 1 || rpc == 2) && (H == 128 || H == 256) && Dc == Dv && Dv % 64 == 0 &&
         Dv <= 2048 && A % 128 == 0 && A <= 512 && S >= 1 &&
         align_fwd::Layout(H, Dc, A, S, Dv, rpc).total <= SMEM_LIMIT;
}

}  // namespace

// The cluster forward's shared memory per CTA in bytes at rpc rows per CTA,
// or -1 for a shape it does not take.
extern "C" long long avsr_av_align_fwd_smem(int H, int Dc, int A, int S, int Dv, int rpc) {
  if (!fwd_shape_ok(H, Dc, A, S, Dv, rpc)) return -1;
  return (long long)align_fwd::Layout(H, Dc, A, S, Dv, rpc).total;
}

// The cluster forward's clusters that can be resident at once (0 on an error).
extern "C" int avsr_av_align_fwd_max_active(int H, int Dc, int A, int S, int Dv, int dot,
                                            int rpc) {
  if (!fwd_shape_ok(H, Dc, A, S, Dv, rpc)) return 0;
  const align_fwd::Layout L(H, Dc, A, S, Dv, rpc);
  if (rpc == 2)
    return dot ? align_fwd::max_active_t<true, 2>(L) : align_fwd::max_active_t<false, 2>(L);
  return dot ? align_fwd::max_active_t<true, 1>(L) : align_fwd::max_active_t<false, 1>(L);
}

// w [16, H/128, H + Dc, 32] bf16 (kernels.cluster_align_weights of [Wh ;
// ctx_proj]); wq [H, A], vatt [A] bf16 (null when dot); bias [4H]; xw [T, B,
// 4H] and mask [T, B] (0 or 1) fp32; keys [B, S, A] fp32 (bf16 when dot),
// values [B, S, Dv] bf16, mbias / mmask [B, S] fp32 -> hs [T, B, H], ctxs
// [T, B, Dv], aligns [T, B, S], the final carries hT, cT [B, H], ctxT [B,
// Dv] and, with save, h_res / c_res [T, B, H], ctx_res [T, B, Dv] (all
// three null without), fp32, from zero initial carries; every element of
// the live rows written.  One launch; none when T = 0.
extern "C" int avsr_av_align_fwd(const void* w, const void* wq, const void* vatt,
                                 const void* bias, const void* xw, const void* mask,
                                 const void* keys, const void* values, const void* mbias,
                                 const void* mmask, void* hs, void* ctxs, void* aligns, void* hT,
                                 void* cT, void* ctxT, void* h_res, void* c_res, void* ctx_res,
                                 int T, int B, int H, int Dc, int A, int S, int Dv, int dot,
                                 int rpc, void* stream) {
  const bool save = h_res != nullptr;
  if (T < 0 || B < 1 || !fwd_shape_ok(H, Dc, A, S, Dv, rpc) || (!dot && vatt == nullptr) ||
      save != (c_res != nullptr) || save != (ctx_res != nullptr))
    return (int)cudaErrorInvalidValue;
  if (T == 0) return (int)cudaSuccess;
  using bf = __nv_bfloat16;
  align_fwd::FwdArgs a;
  a.w = static_cast<const bf*>(w);
  a.wq = static_cast<const bf*>(wq);
  a.vatt = static_cast<const bf*>(vatt);
  a.bias = static_cast<const float*>(bias);
  a.xw = static_cast<const float*>(xw);
  a.mask = static_cast<const float*>(mask);
  a.keys = keys;
  a.values = static_cast<const bf*>(values);
  a.mbias = static_cast<const float*>(mbias);
  a.mmask = static_cast<const float*>(mmask);
  a.hs = static_cast<float*>(hs);
  a.ctxs = static_cast<float*>(ctxs);
  a.aligns = static_cast<float*>(aligns);
  a.hT = static_cast<float*>(hT);
  a.cT = static_cast<float*>(cT);
  a.ctxT = static_cast<float*>(ctxT);
  a.h_res = static_cast<float*>(h_res);
  a.c_res = static_cast<float*>(c_res);
  a.ctx_res = static_cast<float*>(ctx_res);
  a.T = T;
  a.B = B;
  a.H = H;
  a.Dc = Dc;
  a.A = A;
  a.S = S;
  a.Dv = Dv;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  return (int)(dot ? align_fwd::fwd<true>(a, rpc, st) : align_fwd::fwd<false>(a, rpc, st));
}

// Backward, five launches on the caller's stream from three entry points,
// called in order by the wrapper: avsr_av_align_bwd_prep (the regate and the
// query launch),
// avsr_av_align_bwd_scan (the recurrence), avsr_av_align_bwd_sums (the
// memory's gradients).  Shapes the recurrence takes: H a multiple of 64 (of
// 128 for the Luong read) up to 512, Dc = 0 or Dv, H + Dc a multiple of 128
// up to 1024, Dv a multiple of 64 up to 2048, A a multiple of 64 up to 512,
// S >= 1 (the wrapper caps it), and its shared memory within the card's.
namespace {

bool bwd_shape_ok(int H, int Dc, int A, int S, int Dv, int rpc, int dot) {
  return (rpc == 1 || rpc == 2) && H % (dot ? 128 : 64) == 0 && H <= 512 &&
         (Dc == 0 || Dc == Dv) &&
         (H + Dc) % (8 * align_bwd::C) == 0 && H + Dc <= 64 * align_bwd::C &&
         Dv % 64 == 0 && Dv <= 2048 && A % 64 == 0 && A <= 512 && S >= 1 &&
         align_bwd::Layout(H, Dc, A, S, Dv, rpc, false, dot != 0).total <= SMEM_LIMIT;
}

}  // namespace

// The recurrence's shared memory per CTA in bytes at rpc rows per CTA (1 or
// 2; Bahdanau's wq staged where it fits), or -1 for a shape it does not take.
extern "C" long long avsr_av_align_bwd_smem(int H, int Dc, int A, int S, int Dv, int dot,
                                            int rpc) {
  if (!bwd_shape_ok(H, Dc, A, S, Dv, rpc, dot)) return -1;
  const bool wq = align_bwd::stage_wq(H, Dc, A, S, Dv, rpc, dot != 0, SMEM_LIMIT);
  return (long long)align_bwd::Layout(H, Dc, A, S, Dv, rpc, wq, dot != 0).total;
}

// The recurrence's clusters that can be resident at once (0 on an error).
extern "C" int avsr_av_align_bwd_max_active(int H, int Dc, int A, int S, int Dv, int dot,
                                            int rpc) {
  if (!bwd_shape_ok(H, Dc, A, S, Dv, rpc, dot)) return 0;
  return dot ? align_bwd::max_active<true>(H, Dc, A, S, Dv, rpc, SMEM_LIMIT)
             : align_bwd::max_active<false>(H, Dc, A, S, Dv, rpc, SMEM_LIMIT);
}

// (1) and (2).  w_all [H + Dc, 4H] bf16, the rows of [Wh ; ctx_proj]; bias
// [4H]; xw [T, B, 4H]; the saved carries h_res / c_res [T, B, H], ctx_res
// [T, B, Dc] (unused when Dc = 0); wq [H, A] bf16 -> act [T, B, 4H] (i, f,
// g, o), hnew [T, B, H] (the recomputed queries) and q [T, B, A] =
// bf16(hnew) @ wq (rounded to bf16 when dot), fp32.
extern "C" int avsr_av_align_bwd_prep(const void* w_all, const void* bias, const void* xw,
                                      const void* h_res, const void* c_res, const void* ctx_res,
                                      const void* wq, void* act, void* hnew, void* q, int T,
                                      int B, int H, int Dc, int A, int dot, void* stream) {
  if (T < 1 || B < 1 || H % 64 || H > 512 || Dc % 64 || A % 64 || A > 512)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int R = T * B;
  align_bwd::align_regate_mma<<<dim3(H / 16, (R + 63) / 64), 128, 0, st>>>(
      static_cast<const __nv_bfloat16*>(w_all), static_cast<const float*>(bias),
      static_cast<const float*>(xw), static_cast<const float*>(h_res),
      static_cast<const float*>(c_res), static_cast<const float*>(ctx_res),
      static_cast<float*>(act), static_cast<float*>(hnew), R, H, Dc);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const size_t smem_q = ((size_t)H * A + 64 * (size_t)H) * sizeof(__nv_bfloat16);
  e = cudaFuncSetAttribute(align_bwd::align_query_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_q);
  if (e != cudaSuccess) return (int)e;
  const int tiles = (R + 63) / 64;
  align_bwd::align_query_kernel<<<tiles < 264 ? tiles : 264, 128, smem_q, st>>>(
      static_cast<const float*>(hnew), static_cast<const __nv_bfloat16*>(wq),
      static_cast<float*>(q), R, H, A, dot);
  return (int)cudaGetLastError();
}

// (3).  w_all [H + Dc, 4H] bf16, the rows of [Wh ; ctx_proj]; wq [H, A],
// vatt [A] bf16 (null when dot); keys [B, S, A] fp32 (bf16 when dot),
// values [B, S, Dv] bf16; aligns [T, B, S] (the forward's); q, act from
// prep; c_res [T, B, H], mask [T, B], the cotangents dhs [T, B, H], dctxs
// [T, B, Dv], dhT / dcT [B, H], dctxT [B, Dv] (all fp32) -> dxw [T, B, 4H],
// dq [T, B, A], dsc [T, B, S], dctxp [T, B, Dv] (dctx'), db_rows [B, 4H],
// fp32, every element written; rpc rows per CTA (1 or 2).
extern "C" int avsr_av_align_bwd_scan(const void* w_all, const void* wq, const void* vatt,
                                      const void* keys, const void* values, const void* aligns,
                                      const void* q, const void* act, const void* c_res,
                                      const void* mask, const void* dhs, const void* dctxs,
                                      const void* dhT, const void* dcT, const void* dctxT,
                                      void* dxw, void* dq, void* dsc, void* dctxp, void* db_rows,
                                      int T, int B, int H, int Dc, int A, int S, int Dv, int dot,
                                      int rpc, void* stream) {
  if (T < 1 || B < 1 || !bwd_shape_ok(H, Dc, A, S, Dv, rpc, dot) || (!dot && vatt == nullptr))
    return (int)cudaErrorInvalidValue;
  using bf = __nv_bfloat16;
  align_bwd::ScanArgs a;
  a.w_all = static_cast<const bf*>(w_all);
  a.wq = static_cast<const bf*>(wq);
  a.vatt = static_cast<const bf*>(vatt);
  a.keys = keys;
  a.values = static_cast<const bf*>(values);
  a.aligns = static_cast<const float*>(aligns);
  a.q = static_cast<const float*>(q);
  a.act = static_cast<const float*>(act);
  a.c_res = static_cast<const float*>(c_res);
  a.mask = static_cast<const float*>(mask);
  a.dhs = static_cast<const float*>(dhs);
  a.dctxs = static_cast<const float*>(dctxs);
  a.dhT = static_cast<const float*>(dhT);
  a.dcT = static_cast<const float*>(dcT);
  a.dctxT = static_cast<const float*>(dctxT);
  a.dxw = static_cast<float*>(dxw);
  a.dq = static_cast<float*>(dq);
  a.dsc = static_cast<float*>(dsc);
  a.dctxp = static_cast<float*>(dctxp);
  a.db_rows = static_cast<float*>(db_rows);
  a.T = T;
  a.B = B;
  a.H = H;
  a.Dc = Dc;
  a.A = A;
  a.S = S;
  a.Dv = Dv;
  a.wq_smem = align_bwd::stage_wq(H, Dc, A, S, Dv, rpc, dot != 0, SMEM_LIMIT) ? 1 : 0;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  return (int)(dot ? align_bwd::scan<true>(a, rpc, st, SMEM_LIMIT)
                   : align_bwd::scan<false>(a, rpc, st, SMEM_LIMIT));
}

// (4).  keys [B, S, A] fp32 and vatt [A] bf16 (Bahdanau; unused when dot);
// aligns [T, B, S], q [T, B, A], dsc [T, B, S], dctxp [T, B, Dv] fp32 ->
// dvalues [B, S, Dv], dkeys [B, S, A] and, for Bahdanau, dv_part [B,
// ceil(S / 32), A] (null when dot), fp32, written.
extern "C" int avsr_av_align_bwd_sums(const void* keys, const void* vatt, const void* aligns,
                                      const void* q, const void* dsc, const void* dctxp,
                                      void* dkeys, void* dvalues, void* dv_part, int T, int B,
                                      int A, int S, int Dv, int dot, void* stream) {
  if (T < 1 || B < 1 || S < 1 || Dv % 64 || A % 64 || (!dot && (vatt == nullptr ||
                                                               dv_part == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int mt = (S + 63) / 64;
  align_bwd::align_outer_sum<false><<<dim3(Dv / 64, mt, B), 128, 0, st>>>(
      static_cast<const float*>(aligns), static_cast<const float*>(dctxp),
      static_cast<float*>(dvalues), T, B, S, Dv);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  if (dot)
    align_bwd::align_outer_sum<true><<<dim3(A / 64, mt, B), 128, 0, st>>>(
        static_cast<const float*>(dsc), static_cast<const float*>(q), static_cast<float*>(dkeys),
        T, B, S, A);
  else
    align_bwd::align_dkeys_energy<<<dim3((S + align_bwd::ES - 1) / align_bwd::ES, B,
                                         (A + 127) / 128),
                                    256, 0, st>>>(
        static_cast<const float*>(keys), static_cast<const float*>(q),
        static_cast<const float*>(dsc), static_cast<const __nv_bfloat16*>(vatt),
        static_cast<float*>(dkeys), static_cast<float*>(dv_part), T, B, S, A);
  return (int)cudaGetLastError();
}

// The per-step backward (av_align_step_bwd.cuh): every shape the forward's
// per-step kernels take.  Two entry points, called in order by the wrapper.
namespace {

template <typename E>
int step_bwd_prep(const void* wh_tiled, const void* cp_tiled, const void* bias, const void* xw,
                  const void* h_res, const void* c_res, const void* ctx_res, void* act,
                  void* hnew, int T, int B, int H, int Dc, void* stream) {
  if (T < 1 || B < 1 || H % UT || Dc % UT || (Dc > 0 && cp_tiled == nullptr))
    return (int)cudaErrorInvalidValue;
  const int t_per_block = 8;  // enough blocks to fill the card
  align_regate_kernel<E><<<dim3(H / UT, (B + BT - 1) / BT, (T + t_per_block - 1) / t_per_block),
                           GTHREADS, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const E*>(wh_tiled), static_cast<const E*>(cp_tiled),
      static_cast<const float*>(bias), static_cast<const float*>(xw),
      static_cast<const float*>(h_res), static_cast<const float*>(c_res),
      static_cast<const float*>(ctx_res), static_cast<float*>(act), static_cast<float*>(hnew), T,
      B, H, Dc, t_per_block);
  return (int)cudaGetLastError();
}

template <bool DOT, typename E>
int step_bwd_scan(const void* w_all_t, const void* mask, const void* wq, const void* vatt,
                  const void* keys, const void* values, const void* aligns, const void* hnew,
                  const void* act, const void* c_res, const void* dhs, const void* dctxs,
                  void* dh, void* dc, void* dctx, void* dxw, void* dq, void* dv_acc,
                  void* db_acc, void* dkeys, void* dvalues, int T, int B, int H, int Dc, int A,
                  int S, int Dv, void* stream) {
  if (T < 1 || B < 1 || S < 1 || H % UT || Dc % UT || Dv % UT || (Dc > 0 && Dc != Dv) ||
      A % 8 || A > 512 || Dv > 2048 || (!DOT && (vatt == nullptr || dv_acc == nullptr)))
    return (int)cudaErrorInvalidValue;
  const size_t smem_r = step_row_smem_bytes(H, A, S, Dv);
  auto* const align_bwd_row_kernel = &align_bwd_row_kernel_t<DOT, E>;
  cudaError_t e;
  if (smem_r > 48 * 1024) {
    e = cudaFuncSetAttribute(align_bwd_row_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_r);
    if (e != cudaSuccess) return (int)e;
  }
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const dim3 pgrid((H + Dv) / UT, (B + BT - 1) / BT);
  const size_t bh = (size_t)B * H, b4h = 4 * bh, bd = (size_t)B * Dv, bs = (size_t)B * S;
  const size_t ba = (size_t)B * A;
  const float* mask_p = static_cast<const float*>(mask);
  float* dxw_p = static_cast<float*>(dxw);
  for (int t = T - 1; t >= 0; --t) {
    if (t + 1 < T) {
      align_bwd_product_kernel<E><<<pgrid, GTHREADS, 0, st>>>(
          static_cast<const E*>(w_all_t), dxw_p + (size_t)(t + 1) * b4h,
          mask_p + (size_t)(t + 1) * B, static_cast<float*>(dh), static_cast<float*>(dctx), B, H,
          Dc, Dv);
      e = cudaGetLastError();
      if (e != cudaSuccess) return (int)e;
    }
    align_bwd_row_kernel<<<B, bahdanau::THREADS, smem_r, st>>>(
        static_cast<const E*>(wq), static_cast<const E*>(vatt), keys,
        static_cast<const E*>(values), static_cast<const float*>(aligns) + (size_t)t * bs,
        static_cast<const float*>(hnew) + (size_t)t * bh, mask_p + (size_t)t * B,
        static_cast<const float*>(act) + (size_t)t * b4h,
        static_cast<const float*>(c_res) + (size_t)t * bh,
        static_cast<const float*>(dhs) + (size_t)t * bh,
        static_cast<const float*>(dctxs) + (size_t)t * bd, static_cast<const float*>(dh),
        static_cast<const float*>(dctx), static_cast<float*>(dc), dxw_p + (size_t)t * b4h,
        static_cast<float*>(dq) + (size_t)t * ba, static_cast<float*>(dv_acc),
        static_cast<float*>(db_acc), static_cast<float*>(dkeys), static_cast<float*>(dvalues), H,
        A, S, Dv);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// The regate.  wh_tiled [H/UT, H, UT, 4], cp_tiled [H/UT, Dc, UT, 4] bf16
// (null when Dc = 0); bias [4H]; xw [T, B, 4H]; the saved carries h_res /
// c_res [T, B, H], ctx_res [T, B, Dc] -> act [T, B, 4H] (i, f, g, o), hnew
// [T, B, H] (the recomputed queries), fp32.
extern "C" int avsr_av_align_step_bwd_prep(const void* wh_tiled, const void* cp_tiled,
                                           const void* bias, const void* xw, const void* h_res,
                                           const void* c_res, const void* ctx_res, void* act,
                                           void* hnew, int T, int B, int H, int Dc,
                                           void* stream) {
  return step_bwd_prep<__nv_bfloat16>(wh_tiled, cp_tiled, bias, xw, h_res, c_res, ctx_res, act,
                                      hnew, T, B, H, Dc, stream);
}

// The fp32 policy's regate: wh_tiled and cp_tiled fp32, the rest as above.
extern "C" int avsr_av_align_step_bwd_prep_f32(const void* wh_tiled, const void* cp_tiled,
                                               const void* bias, const void* xw,
                                               const void* h_res, const void* c_res,
                                               const void* ctx_res, void* act, void* hnew, int T,
                                               int B, int H, int Dc, void* stream) {
  return step_bwd_prep<float>(wh_tiled, cp_tiled, bias, xw, h_res, c_res, ctx_res, act, hnew, T,
                              B, H, Dc, stream);
}

// The reverse scan, two launches a step.  w_all_t [(H+Dc)/UT, H, UT, 4]
// bf16, [Wh ; ctx_proj] tiled for the carries' products; mask [T, B]; wq
// [H, A], vatt [A] bf16 (null when dot); keys [B, S, A] fp32 (bf16 when
// dot), values [B, S, Dv] bf16; aligns [T, B, S] (the forward's); hnew,
// act from the regate; c_res [T, B, H]; the cotangents dhs [T, B, H],
// dctxs [T, B, Dv]; dh / dc [B, H] and dctx [B, Dv] hold dhT, dcT, dctxT on
// entry (all fp32).  Outputs: dxw [T, B, 4H], dq [T, B, A] written; dv_acc
// [B, A] (null when dot), db_acc [B, 4H], dkeys [B, S, A] and dvalues [B,
// S, Dv] accumulated into zeroed buffers.
extern "C" int avsr_av_align_step_bwd_scan(
    const void* w_all_t, const void* mask, const void* wq, const void* vatt, const void* keys,
    const void* values, const void* aligns, const void* hnew, const void* act, const void* c_res,
    const void* dhs, const void* dctxs, void* dh, void* dc, void* dctx, void* dxw, void* dq,
    void* dv_acc, void* db_acc, void* dkeys, void* dvalues, int T, int B, int H, int Dc, int A,
    int S, int Dv, int dot, void* stream) {
  using bf = __nv_bfloat16;
  auto* const scan = dot ? &step_bwd_scan<true, bf> : &step_bwd_scan<false, bf>;
  return scan(w_all_t, mask, wq, vatt, keys, values, aligns, hnew, act, c_res, dhs, dctxs, dh,
              dc, dctx, dxw, dq, dv_acc, db_acc, dkeys, dvalues, T, B, H, Dc, A, S, Dv, stream);
}

// The fp32 policy's reverse scan (the Bahdanau read): w_all_t, wq, vatt and
// values fp32, the rest as above.
extern "C" int avsr_av_align_step_bwd_scan_f32(
    const void* w_all_t, const void* mask, const void* wq, const void* vatt, const void* keys,
    const void* values, const void* aligns, const void* hnew, const void* act, const void* c_res,
    const void* dhs, const void* dctxs, void* dh, void* dc, void* dctx, void* dxw, void* dq,
    void* dv_acc, void* db_acc, void* dkeys, void* dvalues, int T, int B, int H, int Dc, int A,
    int S, int Dv, void* stream) {
  return step_bwd_scan<false, float>(w_all_t, mask, wq, vatt, keys, values, aligns, hnew, act,
                                     c_res, dhs, dctxs, dh, dc, dctx, dxw, dq, dv_acc, db_acc,
                                     dkeys, dvalues, T, B, H, Dc, A, S, Dv, stream);
}

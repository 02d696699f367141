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
// What bounds it on an H100: the recurrence is sequential in t and a step
// is small (at B = 8: 8 x 768 x 1024 MACs of gates and 8 reads of 150
// keys): a step costs two launches' latency, the staging of each gate
// block's weight slices (Wh 32 KB + ctx_proj 64 KB bf16, all of it L2
// resident after step 0) and the read's dependent reductions.  Design, as
// K1's forward: one host loop in C over the T steps, two launches per step
// on the caller's stream.  (a) Gate launch: a block owns BT = 16 batch rows
// x UT = 16 hidden units and computes all four gates of its units from the
// bf16 ctx and h rows (staged in shared memory) against the pre-tiled
// [K][UT][4] weight slices (K1's layout, kernels.tile_lstm_weights), with
// fp32 FMAs on bf16-rounded operands; it applies the cell update and the
// mask and writes h' for the read.  (b) Read launch: a block per batch row
// runs bahdanau::read and the masked epilogue.  h and ctx are
// double-buffered in device memory, c is updated in place (only its owner
// reads it).  A persistent kernel holding the weights in shared memory
// across steps is later work.  With save (training), the gate launch also
// writes the fp32 h and c entering the step and the read launch the fp32
// ctx entering it: the carries the reference's jax.checkpoint keeps, the
// backward's residuals (~103 MB at T = 197, B = 128).  The backward is
// described further down, above its kernels.

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

using bahdanau::Key;

struct AlignWeights {
  float* aligns;  // this row's [S] slice of aligns[t]
  float m;
  __device__ void operator()(int s, float w) const { aligns[s] = w * m; }
};

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

template <bool DOT>
__global__ void __launch_bounds__(bahdanau::THREADS)
align_read_kernel_t(const float* __restrict__ hnew,            // [B, H]
                    const float* __restrict__ mask_t,          // [B]
                    const __nv_bfloat16* __restrict__ wq,      // [H, A]
                    const __nv_bfloat16* __restrict__ vatt,    // [A] or null (dot)
                    const void* __restrict__ keys_in,          // [B, S, A] Key<DOT>
                    const __nv_bfloat16* __restrict__ values,  // [B, S, Dv]
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

// ---------------------------------------------------------------------------
// Backward: the reverse scan of the gradient JAX's autodiff takes through the
// rematerialized body (fusion.py:118-141), from the carries saved by the
// forward (h_res, c_res, ctx_res: fp32, entering each step), the forward's
// alignments (a live row's read weights) and the cotangents dhs, dctxs of
// the outputs and dhT, dcT, dctxT of the final carries.  Per step t, from
// T-1 down to 0, with m = mask[t, b]:
//
//   dctx' = m * (dctx_out + dctxs[t])                 (the read's cotangent)
//   read backward (bahdanau::read_bwd, skipped when m == 0: its cotangent
//   is 0) -> dquery, dkeys / dvalues += , dq[t], dv_acc +=
//   dh' = m * (dh_out + dhs[t]) + dquery
//   the LSTM cell backward on the recomputed gates -> dgates = dxw[t] (fp32,
//   as xw is), db_acc +=, dc <- dc' * f + (1 - m) * dc_out
//   dh_out(t-1)   = bf16(dgates @ Wh^T)       + (1 - m) * dh_out
//   dctx_out(t-1) = bf16(dgates @ ctx_proj^T) + (1 - m) * dctx_out
//
// (the bf16 roundings are the transposes of the reference's casts).  dWh,
// dctx_proj, dwq and dv are single fp32 products after the scan, over the
// saved carries, dxw, dq, the recomputed queries and dv_acc (left to the
// caller, as K1 leaves dWh).
//
// What bounds it on an H100: as the forward, the sequential steps'
// latency.  Design: (0) one regate launch recomputes every step's gates and
// h' from the saved carries in parallel over time (the gate launch's
// arithmetic and tiled weights, so h' has the forward's bits), into fp32
// act [T, B, 4H] and hnew [T, B, H]; then per step (1) a row launch, a block
// per batch row: the read backward and the pointwise cell backward of the
// row's H units; (2) a product launch (before the row launch of the step
// below) forming dh_out and dctx_out from the step's fp32 dgates against
// rows of [Wh ; ctx_proj], pre-tiled as K1's backward tiles Wh (a block:
// 16 rows x 16 of the H + Dv output columns, the rows' dgates staged in
// shared memory).  The launch boundary is the only synchronisation; each
// buffer element has one writer per launch: no atomics, the same bits every
// run.
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(GTHREADS)
align_regate_kernel(const __nv_bfloat16* __restrict__ wh_tiled,  // [H/UT, H, UT, 4]
                    const __nv_bfloat16* __restrict__ cp_tiled,  // [H/UT, Dc, UT, 4] or null
                    const float* __restrict__ bias,              // [4H]
                    const float* __restrict__ xw,                // [T, B, 4H]
                    const float* __restrict__ h_res,             // [T, B, H]
                    const float* __restrict__ c_res,             // [T, B, H]
                    const float* __restrict__ ctx_res,           // [T, B, Dc]
                    float* __restrict__ act,                     // [T, B, 4H] i, f, g, o
                    float* __restrict__ hnew,                    // [T, B, H]
                    int T, int B, int H, int Dc, int t_per_block) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* wh_s = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* cp_s = wh_s + (size_t)H * UT * 4;
  __nv_bfloat16* h_s = cp_s + (size_t)Dc * UT * 4;
  __nv_bfloat16* x_s = h_s + (size_t)BT * H;

  const int tile = blockIdx.x;
  const int row0 = blockIdx.y * BT;
  const int tid = threadIdx.x;
  const int r = tid / UT;
  const int u = tid - r * UT;
  const int row = row0 + r;
  const int unit = tile * UT + u;
  const bool live = row < B;
  const size_t bh = (size_t)B * H;

  stage_copy(reinterpret_cast<uint4*>(wh_s),
             reinterpret_cast<const uint4*>(wh_tiled + (size_t)tile * H * UT * 4),
             H * UT * 4 / 8, tid);
  if (Dc > 0)
    stage_copy(reinterpret_cast<uint4*>(cp_s),
               reinterpret_cast<const uint4*>(cp_tiled + (size_t)tile * Dc * UT * 4),
               Dc * UT * 4 / 8, tid);
  float bq[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) bq[q] = bias[q * H + unit];

  const int t0 = blockIdx.z * t_per_block;
  const int t1 = min(T, t0 + t_per_block);
  for (int t = t0; t < t1; ++t) {
    __syncthreads();  // the previous step's rows are consumed
    const size_t s = (size_t)t * bh + (size_t)(live ? row : 0) * H + unit;
    float xg[4] = {0.f, 0.f, 0.f, 0.f}, c_prev = 0.f;
    if (live) {
      const float* x = xw + ((size_t)t * B + row) * 4 * H;
#pragma unroll
      for (int q = 0; q < 4; ++q) xg[q] = x[q * H + unit];
      c_prev = c_res[s];
    }
    stage_rows(h_s, h_res + (size_t)t * bh, row0, B, H, tid);
    if (Dc > 0) stage_rows(x_s, ctx_res + (size_t)t * B * Dc, row0, B, Dc, tid);
    __syncthreads();
    float ac[4] = {0.f, 0.f, 0.f, 0.f}, ah[4] = {0.f, 0.f, 0.f, 0.f};
    if (Dc > 0) gate_product(x_s + (size_t)r * Dc, cp_s, u, Dc, ac);
    gate_product(h_s + (size_t)r * H, wh_s, u, H, ah);
    if (!live) continue;
    float gt[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) gt[q] = ((xg[q] + ac[q]) + ah[q]) + bq[q];
    const float i = sigmoidf_(gt[0]);
    const float f = sigmoidf_(gt[1]);
    const float g = tanhf(gt[2]);
    const float o = sigmoidf_(gt[3]);
    float* a = act + ((size_t)t * B + row) * 4 * H;
    a[unit] = i;
    a[H + unit] = f;
    a[2 * H + unit] = g;
    a[3 * H + unit] = o;
    hnew[s] = o * tanhf(f * c_prev + i * g);
  }
}

// dh_out / dctx_out of the step below from this step's dgates: a block owns
// BT rows x UT of the H + Dv output columns; columns < H + Dc take the
// product against rows of [Wh ; ctx_proj] (w_all_t [(H+Dc)/UT, H, UT, 4]:
// [t, kq, u, j] = W[t*UT + u, 4*kq + j]), the rest (no input feeding) only
// the masked carry term.
__global__ void __launch_bounds__(GTHREADS)
align_bwd_product_kernel(const __nv_bfloat16* __restrict__ w_all_t,
                         const float* __restrict__ dg,      // [B, 4H] this step's dgates
                         const float* __restrict__ mask_t,  // [B] this step's mask
                         float* __restrict__ dh,            // [B, H] in/out
                         float* __restrict__ dctx,          // [B, Dv] in/out
                         int B, int H, int Dc, int Dv) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* w_s = reinterpret_cast<__nv_bfloat16*>(smem);  // [H][UT][4]
  float* dg_s = reinterpret_cast<float*>(w_s + (size_t)H * UT * 4);  // [BT][4H]

  const int tile = blockIdx.x;
  const int row0 = blockIdx.y * BT;
  const int tid = threadIdx.x;
  const int r = tid / UT;
  const int u = tid - r * UT;
  const int row = row0 + r;
  const int col = tile * UT + u;
  const bool product = tile * UT < H + Dc;  // uniform over the block

  float old = 0.f, m = 0.f;
  if (row < B) {
    m = mask_t[row];
    old = col < H ? dh[(size_t)row * H + col] : dctx[(size_t)row * Dv + col - H];
  }
  float acc = 0.f;
  if (product) {
    stage_copy(reinterpret_cast<uint4*>(w_s),
               reinterpret_cast<const uint4*>(w_all_t + (size_t)tile * H * UT * 4),
               H * UT * 4 / 8, tid);
    const int nrows = min(BT, B - row0);
    const int chunks = BT * H;  // float4s of the rows' dgates
    float4* d4 = reinterpret_cast<float4*>(dg_s);
    const float4* s4 = reinterpret_cast<const float4*>(dg + (size_t)row0 * 4 * H);
    for (int c0 = tid; c0 < chunks; c0 += VEC * GTHREADS) {
      float4 v[VEC];
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const int ci = c0 + j * GTHREADS;
        v[j] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (ci < nrows * H) v[j] = s4[ci];
      }
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const int ci = c0 + j * GTHREADS;
        if (ci < chunks) d4[ci] = v[j];
      }
    }
    __syncthreads();
    const float4* dr = reinterpret_cast<const float4*>(dg_s) + (size_t)r * H;
    const uint2* wu = reinterpret_cast<const uint2*>(w_s) + u;
    float a0 = 0.f, a1 = 0.f;
#pragma unroll 4
    for (int kq = 0; kq < H; ++kq) {
      const float4 d = dr[kq];
      const uint2 w = wu[kq * UT];
      a0 = fmaf(d.x, bahdanau::bf_lo(w.x), a0);
      a1 = fmaf(d.y, bahdanau::bf_hi(w.x), a1);
      a0 = fmaf(d.z, bahdanau::bf_lo(w.y), a0);
      a1 = fmaf(d.w, bahdanau::bf_hi(w.y), a1);
    }
    acc = bahdanau::bf_round(a0 + a1);
  }
  if (row >= B) return;
  const float x = acc + (1.0f - m) * old;
  if (col < H)
    dh[(size_t)row * H + col] = x;
  else
    dctx[(size_t)row * Dv + col - H] = x;
}

struct AlignDctx {
  const float* dctx;   // this row's dctx_out [Dv]
  const float* dctxs;  // this row's [Dv] slice of dctxs[t]
  float m;
  __device__ float operator()(int d) const { return m * (dctx[d] + dctxs[d]); }
};

// One step's row launch: the read backward and the cell backward of row b.
template <bool DOT>
__global__ void __launch_bounds__(bahdanau::THREADS)
align_bwd_row_kernel_t(const __nv_bfloat16* __restrict__ wq,      // [H, A]
                       const __nv_bfloat16* __restrict__ vatt,    // [A] or null (dot)
                       const void* __restrict__ keys_in,          // [B, S, A] Key<DOT>
                       const __nv_bfloat16* __restrict__ values,  // [B, S, Dv]
                       const float* __restrict__ aligns_t,        // [B, S]
                       const float* __restrict__ hnew_t,          // [B, H]
                       const float* __restrict__ mask_t,          // [B]
                       const float* __restrict__ act_t,           // [B, 4H]
                       const float* __restrict__ c_res_t,         // [B, H]
                       const float* __restrict__ dhs_t,           // [B, H]
                       const float* __restrict__ dctxs_t,         // [B, Dv]
                       const float* __restrict__ dh,              // [B, H] dh_out
                       const float* __restrict__ dctx,            // [B, Dv] dctx_out
                       float* __restrict__ dc,                    // [B, H] in/out
                       float* __restrict__ dxw_t,                 // [B, 4H]
                       float* __restrict__ dq_t,                  // [B, A]
                       float* __restrict__ dv_acc,                // [B, A] += or null (dot)
                       float* __restrict__ db_acc,                // [B, 4H] +=
                       float* __restrict__ dkeys,                 // [B, S, A] +=
                       float* __restrict__ dvalues,               // [B, S, Dv] +=
                       int H, int A, int S, int Dv) {
  extern __shared__ __align__(16) float fsmem[];
  const auto* keys = static_cast<const typename Key<DOT>::type*>(keys_in);
  float* dquery = fsmem + bahdanau::read_bwd_smem_floats(H, A, S, Dv);  // [H]
  const size_t b = blockIdx.x;
  const int tid = threadIdx.x;
  const float m = mask_t[b];
  if (m != 0.f) {
    bahdanau::read_bwd<DOT>(hnew_t + b * H, wq, vatt, keys + b * S * A, values + b * S * Dv,
                            aligns_t + b * S, AlignDctx{dctx + b * Dv, dctxs_t + b * Dv, m}, H,
                            A, S, Dv, fsmem, dkeys + b * S * A, dvalues + b * S * Dv,
                            dq_t + b * A, DOT ? nullptr : dv_acc + b * A, dquery);
  } else {  // a masked step: the read takes a zero cotangent
    for (int a = tid; a < A; a += bahdanau::THREADS) dq_t[b * A + a] = 0.f;
    for (int k = tid; k < H; k += bahdanau::THREADS) dquery[k] = 0.f;
  }
  __syncthreads();
  const float* a4 = act_t + b * 4 * H;
  float* dx = dxw_t + b * 4 * H;
  float* dbr = db_acc + b * 4 * H;
  for (int u = tid; u < H; u += bahdanau::THREADS) {
    const size_t s = b * H + u;
    const float i = a4[u], f = a4[H + u], g = a4[2 * H + u], o = a4[3 * H + u];
    const float c_prev = c_res_t[s];
    const float tc = tanhf(f * c_prev + i * g);
    const float dh_new = m * (dh[s] + dhs_t[s]) + dquery[u];
    const float dco = dc[s];
    const float dc_new = m * dco + dh_new * o * (1.0f - tc * tc);
    const float dgi = dc_new * g * i * (1.0f - i);
    const float dgf = dc_new * c_prev * f * (1.0f - f);
    const float dgg = dc_new * i * (1.0f - g * g);
    const float dgo = dh_new * tc * o * (1.0f - o);
    dc[s] = dc_new * f + (1.0f - m) * dco;
    dx[u] = dgi;
    dx[H + u] = dgf;
    dx[2 * H + u] = dgg;
    dx[3 * H + u] = dgo;
    dbr[u] += dgi;
    dbr[H + u] += dgf;
    dbr[2 * H + u] += dgg;
    dbr[3 * H + u] += dgo;
  }
}

size_t product_smem_bytes(int H) {
  return (size_t)H * UT * 4 * sizeof(__nv_bfloat16) + (size_t)BT * 4 * H * sizeof(float);
}

size_t row_smem_bytes(int H, int A, int S, int Dv) {
  return (bahdanau::read_bwd_smem_floats(H, A, S, Dv) + H) * sizeof(float);
}

}  // namespace

// Shared memory per block of the largest launch of the forward and the
// backward, in bytes.
extern "C" long long avsr_av_align_smem(int H, int Dc, int A, int S, int Dv) {
  size_t m = gate_smem_bytes(H, Dc);
  const size_t more[3] = {bahdanau::read_smem_bytes(H, A, S), product_smem_bytes(H),
                          row_smem_bytes(H, A, S, Dv)};
  for (size_t x : more) m = x > m ? x : m;
  return (long long)m;
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
  const size_t smem_g = gate_smem_bytes(H, Dc);
  const size_t smem_r = bahdanau::read_smem_bytes(H, A, S);
  auto* const align_read_kernel = dot ? &align_read_kernel_t<true> : &align_read_kernel_t<false>;
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
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
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
    align_gate_kernel<<<ggrid, GTHREADS, smem_g, st>>>(
        static_cast<const __nv_bfloat16*>(wh_tiled), static_cast<const __nv_bfloat16*>(cp_tiled),
        static_cast<const float*>(bias), xw_p + (size_t)t * B * 4 * H, mask_p + (size_t)t * B,
        h_p + cur * bh, h_p + nxt * bh, static_cast<float*>(c), ctx_p + cur * bd,
        static_cast<float*>(hnew), hs_p + (size_t)t * bh, save ? hr_p + (size_t)t * bh : nullptr,
        save ? cr_p + (size_t)t * bh : nullptr, B, H, Dc);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    align_read_kernel<<<B, bahdanau::THREADS, smem_r, st>>>(
        static_cast<const float*>(hnew), mask_p + (size_t)t * B,
        static_cast<const __nv_bfloat16*>(wq), static_cast<const __nv_bfloat16*>(vatt), keys,
        static_cast<const __nv_bfloat16*>(values),
        static_cast<const float*>(mbias), static_cast<const float*>(mmask), ctx_p + cur * bd,
        ctx_p + nxt * bd, ctxs_p + (size_t)t * bd, al_p + (size_t)t * B * S,
        save ? xr_p + (size_t)t * bd : nullptr, H, A, S, Dv);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaGetLastError();
}

// Backward.  wh_tiled / cp_tiled as the forward's; w_all_t [(H+Dc)/UT, H,
// UT, 4] bf16, [Wh ; ctx_proj] tiled for the carries' products; bias [4H];
// xw [T, B, 4H], mask [T, B]; wq [H, A], vatt [A] bf16 (null when dot);
// keys [B, S, A] fp32 (bf16 when dot), values [B, S, Dv] bf16; aligns
// [T, B, S] (the forward's); the saved
// carries h_res / c_res [T, B, H], ctx_res [T, B, Dv] (used only with input
// feeding, Dc = Dv); the cotangents dhs [T, B, H], dctxs [T, B, Dv]; dh /
// dc [B, H] and dctx [B, Dv] hold dhT, dcT, dctxT on entry (all fp32).
// Scratch: act [T, B, 4H], hnew [T, B, H] (written: the recomputed queries,
// a factor of dwq).  Outputs: dxw [T, B, 4H], dq [T, B, A]; dv_acc [B, A]
// (null when dot), db_acc [B, 4H], dkeys [B, S, A] and dvalues [B, S, Dv]
// accumulated into zeroed buffers.
extern "C" int avsr_av_align_scan_bwd(
    const void* wh_tiled, const void* cp_tiled, const void* w_all_t, const void* bias,
    const void* xw, const void* mask, const void* wq, const void* vatt, const void* keys,
    const void* values, const void* aligns, const void* h_res, const void* c_res,
    const void* ctx_res, const void* dhs, const void* dctxs, void* dh, void* dc, void* dctx,
    void* act, void* hnew, void* dxw, void* dq, void* dv_acc, void* db_acc, void* dkeys,
    void* dvalues, int T, int B, int H, int Dc, int A, int S, int Dv, int dot, void* stream) {
  if (T < 1 || B < 1 || S < 1 || H % UT || H % 4 || Dc % UT || Dv % UT ||
      (Dc > 0 && (cp_tiled == nullptr || Dc != Dv)) || A % 8 || A > 512 || Dv % 8 ||
      Dv > 2048 || (!dot && (vatt == nullptr || dv_acc == nullptr)))
    return (int)cudaErrorInvalidValue;
  const size_t smem_g = gate_smem_bytes(H, Dc);
  const size_t smem_p = product_smem_bytes(H);
  const size_t smem_r = row_smem_bytes(H, A, S, Dv);
  auto* const align_bwd_row_kernel =
      dot ? &align_bwd_row_kernel_t<true> : &align_bwd_row_kernel_t<false>;
  cudaError_t e;
  const void* fns[3] = {reinterpret_cast<const void*>(align_regate_kernel),
                        reinterpret_cast<const void*>(align_bwd_product_kernel),
                        reinterpret_cast<const void*>(align_bwd_row_kernel)};
  const size_t sizes[3] = {smem_g, smem_p, smem_r};
  for (int k = 0; k < 3; ++k) {
    if (sizes[k] <= 48 * 1024) continue;
    e = cudaFuncSetAttribute(fns[k], cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)sizes[k]);
    if (e != cudaSuccess) return (int)e;
  }
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int row_tiles = (B + BT - 1) / BT;
  // regate: enough blocks to fill the card, each staging its weights once
  const int t_per_block = 8;
  const dim3 rgrid(H / UT, row_tiles, (T + t_per_block - 1) / t_per_block);
  align_regate_kernel<<<rgrid, GTHREADS, smem_g, st>>>(
      static_cast<const __nv_bfloat16*>(wh_tiled), static_cast<const __nv_bfloat16*>(cp_tiled),
      static_cast<const float*>(bias), static_cast<const float*>(xw),
      static_cast<const float*>(h_res), static_cast<const float*>(c_res),
      static_cast<const float*>(ctx_res), static_cast<float*>(act), static_cast<float*>(hnew), T,
      B, H, Dc, t_per_block);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const dim3 pgrid((H + Dv) / UT, row_tiles);
  const size_t bh = (size_t)B * H, b4h = 4 * bh, bd = (size_t)B * Dv, bs = (size_t)B * S;
  const size_t ba = (size_t)B * A;
  const float* mask_p = static_cast<const float*>(mask);
  float* dxw_p = static_cast<float*>(dxw);
  for (int t = T - 1; t >= 0; --t) {
    if (t + 1 < T) {
      align_bwd_product_kernel<<<pgrid, GTHREADS, smem_p, st>>>(
          static_cast<const __nv_bfloat16*>(w_all_t), dxw_p + (size_t)(t + 1) * b4h,
          mask_p + (size_t)(t + 1) * B, static_cast<float*>(dh), static_cast<float*>(dctx), B, H,
          Dc, Dv);
      e = cudaGetLastError();
      if (e != cudaSuccess) return (int)e;
    }
    align_bwd_row_kernel<<<B, bahdanau::THREADS, smem_r, st>>>(
        static_cast<const __nv_bfloat16*>(wq), static_cast<const __nv_bfloat16*>(vatt), keys,
        static_cast<const __nv_bfloat16*>(values),
        static_cast<const float*>(aligns) + (size_t)t * bs,
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

// K8's per-step backward, the gradient of the scan body of
// avsr_tpu/models/fusion.py:av_align_apply (:118-141, under jax.checkpoint):
// the route of kernels.av_align_bwd_family for the widths the cluster
// recurrence (av_align_bwd.cuh) does not take.  The
// forward runs at any H and Dv that are multiples of 16 and A a multiple of
// 8 (kernels.av_align_family); the cluster recurrence takes H a multiple of
// 64 (Luong: 128) up to 512, H + Dc a multiple of 128 up to 1024, A and Dv
// multiples of 64.  These kernels take every shape the forward takes: they
// are the per-step backward of the tree before the cluster recurrence
// (restored, not padded operands on the cluster kernels: padding leaves the
// widths the cluster refuses at any padding, H > 512 or H + Dc > 1024, to
// a second route anyway), with the shared memory of the regate and the
// carries' product bounded by staging [Wh ; ctx_proj] in chunks of input
// rows, so no width the forward's step kernels take is refused here.
//
// The arithmetic is the reverse scan of av_align_scan.cu's header, per step
// t from T-1 down to 0 (m = mask[t, b]):
//
//   dctx' = m * (dctx_out + dctxs[t])                 (the read's cotangent)
//   read backward (bahdanau::read_bwd below, skipped when m == 0) -> dquery,
//   dkeys / dvalues += , dq[t], dv_acc +=
//   dh' = m * (dh_out + dhs[t]) + dquery
//   the LSTM cell backward on the recomputed gates -> dgates = dxw[t], db +=,
//   dc <- dc' * f + (1 - m) * dc_out
//   dh_out(t-1)   = bf16(dgates @ Wh^T)       + (1 - m) * dh_out
//   dctx_out(t-1) = bf16(dgates @ ctx_proj^T) + (1 - m) * dctx_out
//
// Launches: (0) the regate recomputes every step's gates and h' from the
// saved carries in parallel over time (the gate launch's arithmetic and
// tiled weights, the products summed in the same order), into fp32 act [T,
// B, 4H] and hnew [T, B, H]; then per step (1) a row launch, a block per
// batch row: the read backward and the pointwise cell backward of the row's
// H units; (2) a product launch (before the row launch of the step below)
// forming dh_out and dctx_out from the step's fp32 dgates against rows of
// [Wh ; ctx_proj] (a block: 16 rows x 16 of the H + Dv output columns).
// The memory's gradients are summed inside the scan, each row's by its own
// block.  The launch boundary is the only synchronisation; each buffer
// element has one writer per launch: no atomics, the same bits every run.
// What bounds it: the steps' latency (three launches a step).
//
// The fp32 policy (avsr_av_align_step_bwd_prep_f32 / _scan_f32, counted as
// av_align_scan_f32_bwd): the three launches templated on the element type
// E of [Wh ; ctx_proj], wq, v and the values (bahdanau_core.cuh's Elem),
// every bf16 rounding point above the identity, the products fp32 FMAs;
// the regate's and the product's chunks hold half as many fp32 rows, the
// same 32 KB.  Every fp32 shape takes it (kernels.av_align_bwd_family
// routes by dtype).
//
// Included by av_align_scan.cu after its per-step forward, whose helpers
// (BT, UT, GTHREADS, RCH, rch, stage_copy, stage_cols, gate_product,
// gate_product_chunked, sigmoidf_) it uses.

#pragma once

namespace bahdanau {

// ---------------------------------------------------------------------------
// The backward of one read, for K8's per-step backward: the gradient JAX's
// autodiff takes through attention.py:140-163,167-177 for the context's
// cotangent dctx, given the forward's weights w.  q and the energies are recomputed (the remat of the
// reference's jax.checkpoint: the tanh tensor is never saved).  Per row:
//
//   dw[s]  = bf16(sum_d dctx[d] * bf16(values[s, d]))
//   dvalues[s, d] += bf16(bf16(w[s]) * dctx[d])
//   dsc[s] = w[s] * (dw[s] - sum_j w[j] dw[j])
//            (the softmax backward through the mask and the renormalisation:
//            a valid row's w is its softmax with padded positions exactly 0,
//            an empty row's w is 0, so its gradients are 0, not NaN)
//   additive score:
//     e      = tanh(keys[s, a] + q[a]);  deb = bf16(dsc[s] * bf16(v[a]))
//     dpre   = (deb + deb * e) * (1 - e)      (tanh' as JAX takes it)
//     dkeys[s, a] += dpre;  dq[a] = sum_s dpre;  dv[a] += sum_s dsc[s] bf16(e)
//   dot score (q here is bf16(q), keys bf16):
//     dkeys[s, a] += bf16(dsc[s] * q[a]);  dq[a] = bf16(sum_s dsc[s] keys[s, a])
//   dquery[k] = bf16(sum_a dq[a] * wq[k, a])
//
// (the bf16 roundings are the transposes of the reference's casts).  dq and
// dv are this row's factors of the weight gradients dwq = bf16(query)^T dq
// and dv (none for the dot score), which the callers form outside the
// kernels.  A key whose weight is exactly 0 adds exactly 0 everywhere and is
// skipped.  Design: dw and the dvalues update take a warp per key (a lane
// per 8-channel chunk of the value row, KPW keys per warp); dsc is a block
// reduction; the keys' pass takes a thread per 4 key units and splits the
// keys over THREADS / (A/4) slices (4 keys in flight), dq (and dv) summed
// over the slices in a fixed order; dquery a thread per query unit.  The
// row's dkeys / dvalues are owned by its block: no atomics.
// ---------------------------------------------------------------------------

__host__ __device__ inline size_t read_bwd_smem_floats(int Hq, int A, int S, int Dv) {
  return (size_t)2 * A + Dv + Hq + S + WARPS + 8 * THREADS;
}

// query [Hq] fp32, wq [Hq, A] E, vatt [A] E (null for the dot score), keys
// [S, A] (fp32 additive, bf16 dot), values [S, Dv] E, w [S] fp32 (the
// forward's weights); dctx_in(d) gives the context cotangent.  dkeys [S, A]
// and dvalues [S, Dv] fp32 are accumulated (+=), dv_acc [A] too (additive
// only: null for the dot score); dq_out [A] and dquery [Hq] are written
// (dquery may point to shared memory).  E = float: the fp32 policy's
// instance (the additive score only).
template <bool DOT, class DctxIn, typename E>
__device__ void read_bwd(const float* __restrict__ query, const E* __restrict__ wq,
                         const E* __restrict__ vatt,
                         const typename Key<DOT>::type* __restrict__ keys,
                         const E* __restrict__ values, const float* __restrict__ w,
                         DctxIn dctx_in, int Hq, int A, int S, int Dv, float* smem,
                         float* __restrict__ dkeys, float* __restrict__ dvalues,
                         float* __restrict__ dq_out, float* __restrict__ dv_acc, float* dquery) {
  using X = Elem<E>;
  static_assert(!DOT || sizeof(E) == 2, "the dot score's fp32 read is still to be ported");
  float* q_s = smem;          // [A] q, then dq
  float* v_s = q_s + A;       // [A]
  float* dctx_s = v_s + A;    // [Dv]
  float* qin = dctx_s + Dv;   // [Hq] bf16-rounded query
  float* dsc_s = qin + Hq;    // [S] dw, then dsc
  float* red = dsc_s + S;     // [WARPS]
  float* part = red + WARPS;  // [8 * THREADS]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  for (int i = tid; i < Hq; i += THREADS) qin[i] = X::round(query[i]);
  if (!DOT)
    for (int i = tid; i < A; i += THREADS) v_s[i] = X::get(vatt[i]);
  for (int d = tid; d < Dv; d += THREADS) dctx_s[d] = dctx_in(d);
  __syncthreads();
  q_product<DOT>(qin, wq, Hq, A, part, q_s);

  // dw and the dvalues update: a warp per key, a lane per 8-channel chunk
  {
    const int C = Dv / 8;
    const float4* dc4 = reinterpret_cast<const float4*>(dctx_s);
    for (int s0 = warp * KPW; s0 < S; s0 += WARPS * KPW) {
      float acc[KPW], wb[KPW];
#pragma unroll
      for (int j = 0; j < KPW; ++j) {
        acc[j] = 0.f;
        wb[j] = s0 + j < S ? w[s0 + j] : 0.f;
      }
      for (int c = lane; c < C; c += 32) {
        const float4 g0 = dc4[2 * c], g1 = dc4[2 * c + 1];
        const float g[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
        typename X::Chunk u[KPW];
#pragma unroll
        for (int j = 0; j < KPW; ++j)
          u[j] = wb[j] != 0.f ? X::load8(values + (size_t)(s0 + j) * Dv, c) : X::zero8();
#pragma unroll
        for (int j = 0; j < KPW; ++j) {
          if (wb[j] == 0.f) continue;  // uniform over the warp: one key
#pragma unroll
          for (int i = 0; i < 8; ++i) acc[j] = fmaf(g[i], X::at(u[j], i), acc[j]);
          const float ws = X::round(wb[j]);
          float4* dv4 = reinterpret_cast<float4*>(dvalues + (size_t)(s0 + j) * Dv) + 2 * c;
          float4 a0 = dv4[0], a1 = dv4[1];
          a0.x += X::round(ws * g0.x); a0.y += X::round(ws * g0.y);
          a0.z += X::round(ws * g0.z); a0.w += X::round(ws * g0.w);
          a1.x += X::round(ws * g1.x); a1.y += X::round(ws * g1.y);
          a1.z += X::round(ws * g1.z); a1.w += X::round(ws * g1.w);
          dv4[0] = a0;
          dv4[1] = a1;
        }
      }
#pragma unroll
      for (int j = 0; j < KPW; ++j) {
        float a = acc[j];
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) a += __shfl_xor_sync(0xffffffffu, a, o);
        if (lane == 0 && s0 + j < S) dsc_s[s0 + j] = X::round(a);
      }
    }
    __syncthreads();
  }

  // dsc = w * (dw - sum(w * dw))
  {
    float g = 0.f;
    for (int s = tid; s < S; s += THREADS) g += w[s] * dsc_s[s];
    g = block_reduce<false>(g, red);
    for (int s = tid; s < S; s += THREADS) dsc_s[s] = w[s] * (dsc_s[s] - g);
    __syncthreads();
  }

  if constexpr (DOT) {
    // dkeys and dq: a thread per 4 key units, keys over slices
    const int A4 = A / 4, slices = THREADS / A4;
    const int c = tid % A4, sl = tid / A4;
    if (sl < slices) {
      const float4 qq = reinterpret_cast<const float4*>(q_s)[c];  // bf16(q)
      const uint2* k2 = reinterpret_cast<const uint2*>(keys) + c;
      float4* dk4 = reinterpret_cast<float4*>(dkeys) + c;
      float dq[4] = {0.f, 0.f, 0.f, 0.f};
      constexpr int KB = 4;  // keys in flight per thread
      for (int s0 = sl; s0 < S; s0 += KB * slices) {
        float d[KB];
        uint2 kk[KB];
        float4 acc[KB];
#pragma unroll
        for (int j = 0; j < KB; ++j) {
          const int s = s0 + j * slices;
          d[j] = s < S ? dsc_s[s] : 0.f;
          if (d[j] != 0.f) {
            kk[j] = k2[(size_t)s * A4];
            acc[j] = dk4[(size_t)s * A4];
          }
        }
#pragma unroll
        for (int j = 0; j < KB; ++j) {
          if (d[j] == 0.f) continue;
          dq[0] = fmaf(d[j], bf_lo(kk[j].x), dq[0]);
          dq[1] = fmaf(d[j], bf_hi(kk[j].x), dq[1]);
          dq[2] = fmaf(d[j], bf_lo(kk[j].y), dq[2]);
          dq[3] = fmaf(d[j], bf_hi(kk[j].y), dq[3]);
          acc[j].x += bf_round(d[j] * qq.x);
          acc[j].y += bf_round(d[j] * qq.y);
          acc[j].z += bf_round(d[j] * qq.z);
          acc[j].w += bf_round(d[j] * qq.w);
          dk4[(size_t)(s0 + j * slices) * A4] = acc[j];
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) part[sl * A + 4 * c + i] = dq[i];
    }
    __syncthreads();
    for (int a = tid; a < A; a += THREADS) {
      float x = 0.f;
      for (int j = 0; j < slices; ++j) x += part[j * A + a];
      q_s[a] = bf_round(x);  // q is no longer needed: dq, the cast's cotangent
      dq_out[a] = q_s[a];
    }
    __syncthreads();
  } else {
    // energies: dkeys, dq, dv; a thread per 4 attention units, keys over slices
    const int A4 = A / 4, slices = THREADS / A4;
    const int c = tid % A4, sl = tid / A4;
    if (sl < slices) {
      const float4 qq = reinterpret_cast<const float4*>(q_s)[c];
      const float4 vv = reinterpret_cast<const float4*>(v_s)[c];
      const float4* k4 = reinterpret_cast<const float4*>(keys) + c;
      float4* dk4 = reinterpret_cast<float4*>(dkeys) + c;
      float dq[4] = {0.f, 0.f, 0.f, 0.f}, dv[4] = {0.f, 0.f, 0.f, 0.f};
      constexpr int KB = 4;  // keys in flight per thread
      for (int s0 = sl; s0 < S; s0 += KB * slices) {
        float d[KB];
        float4 kk[KB], acc[KB];
#pragma unroll
        for (int j = 0; j < KB; ++j) {
          const int s = s0 + j * slices;
          d[j] = s < S ? dsc_s[s] : 0.f;
          if (d[j] != 0.f) {
            kk[j] = k4[(size_t)s * A4];
            acc[j] = dk4[(size_t)s * A4];
          }
        }
#pragma unroll
        for (int j = 0; j < KB; ++j) {
          if (d[j] == 0.f) continue;
          const float kx[4] = {kk[j].x, kk[j].y, kk[j].z, kk[j].w};
          const float qx[4] = {qq.x, qq.y, qq.z, qq.w};
          const float vx[4] = {vv.x, vv.y, vv.z, vv.w};
          float dp[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float e = tanhf(kx[i] + qx[i]);
            const float deb = X::round(d[j] * vx[i]);
            dp[i] = (deb + deb * e) * (1.0f - e);
            dq[i] += dp[i];
            dv[i] = fmaf(d[j], X::round(e), dv[i]);
          }
          acc[j].x += dp[0];
          acc[j].y += dp[1];
          acc[j].z += dp[2];
          acc[j].w += dp[3];
          dk4[(size_t)(s0 + j * slices) * A4] = acc[j];
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        part[sl * A + 4 * c + i] = dq[i];
        part[(slices + sl) * A + 4 * c + i] = dv[i];
      }
    }
    __syncthreads();
    for (int a = tid; a < A; a += THREADS) {
      float x = 0.f, y = 0.f;
      for (int j = 0; j < slices; ++j) {
        x += part[j * A + a];
        y += part[(slices + j) * A + a];
      }
      q_s[a] = x;  // q is no longer needed: dq
      dq_out[a] = x;
      dv_acc[a] += y;
    }
    __syncthreads();
  }

  // dquery = bf16(dq @ wq^T): a thread per query unit, its row of wq
  for (int k = tid; k < Hq; k += THREADS) {
    const E* wr = wq + (size_t)k * A;
    float acc = 0.f;
    for (int c8 = 0; c8 < A / 8; ++c8) {
      const typename X::Chunk u = X::load8(wr, c8);
      const float* g = q_s + 8 * c8;
#pragma unroll
      for (int i = 0; i < 8; ++i) acc = fmaf(g[i], X::at(u, i), acc);
    }
    dquery[k] = X::round(acc);
  }
}

}  // namespace bahdanau

namespace {

template <typename E>
__global__ void __launch_bounds__(GTHREADS)
align_regate_kernel(const E* __restrict__ wh_tiled,              // [H/UT, H, UT, 4]
                    const E* __restrict__ cp_tiled,              // [H/UT, Dc, UT, 4] or null
                    const float* __restrict__ bias,              // [4H]
                    const float* __restrict__ xw,                // [T, B, 4H]
                    const float* __restrict__ h_res,             // [T, B, H]
                    const float* __restrict__ c_res,             // [T, B, H]
                    const float* __restrict__ ctx_res,           // [T, B, Dc]
                    float* __restrict__ act,                     // [T, B, 4H] i, f, g, o
                    float* __restrict__ hnew,                    // [T, B, H]
                    int T, int B, int H, int Dc, int t_per_block) {
  __shared__ __align__(16) E w_s[rch<E>() * UT * 4];
  __shared__ __align__(16) E x_s[BT * rch<E>()];

  const int tile = blockIdx.x;
  const int row0 = blockIdx.y * BT;
  const int tid = threadIdx.x;
  const int r = tid / UT;
  const int u = tid - r * UT;
  const int row = row0 + r;
  const int unit = tile * UT + u;
  const bool live = row < B;
  const size_t bh = (size_t)B * H;

  float bq[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) bq[q] = bias[q * H + unit];

  const int t0 = blockIdx.z * t_per_block;
  const int t1 = min(T, t0 + t_per_block);
  for (int t = t0; t < t1; ++t) {
    const size_t s = (size_t)t * bh + (size_t)(live ? row : 0) * H + unit;
    float xg[4] = {0.f, 0.f, 0.f, 0.f}, c_prev = 0.f;
    if (live) {
      const float* x = xw + ((size_t)t * B + row) * 4 * H;
#pragma unroll
      for (int q = 0; q < 4; ++q) xg[q] = x[q * H + unit];
      c_prev = c_res[s];
    }
    float ac[4] = {0.f, 0.f, 0.f, 0.f}, ah[4] = {0.f, 0.f, 0.f, 0.f};
    if (Dc > 0)
      gate_product_chunked(cp_tiled + (size_t)tile * Dc * UT * 4, ctx_res + (size_t)t * B * Dc,
                           row0, B, Dc, r, u, tid, w_s, x_s, ac);
    gate_product_chunked(wh_tiled + (size_t)tile * H * UT * 4, h_res + (size_t)t * bh, row0, B, H,
                         r, u, tid, w_s, x_s, ah);
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

// the four gate weights of one (k, unit) of a tiled slice: element quad i
// of p, as fp32
__device__ __forceinline__ float4 quad(const __nv_bfloat16* p, int i) {
  const uint2 w = reinterpret_cast<const uint2*>(p)[i];
  return make_float4(bahdanau::bf_lo(w.x), bahdanau::bf_hi(w.x), bahdanau::bf_lo(w.y),
                     bahdanau::bf_hi(w.y));
}
__device__ __forceinline__ float4 quad(const float* p, int i) {
  return reinterpret_cast<const float4*>(p)[i];
}

// dh_out / dctx_out of the step below from this step's dgates: a block owns
// BT rows x UT of the H + Dv output columns; columns < H + Dc take the
// product against rows of [Wh ; ctx_proj] (w_all_t [(H+Dc)/UT, H, UT, 4]:
// [t, kq, u, j] = W[t*UT + u, 4*kq + j]), rch<E>() / 2 quads of the 4H
// dgates at a time; the rest (no input feeding) only the masked carry term.
template <typename E>
__global__ void __launch_bounds__(GTHREADS)
align_bwd_product_kernel(const E* __restrict__ w_all_t,
                         const float* __restrict__ dg,      // [B, 4H] this step's dgates
                         const float* __restrict__ mask_t,  // [B] this step's mask
                         float* __restrict__ dh,            // [B, H] in/out
                         float* __restrict__ dctx,          // [B, Dv] in/out
                         int B, int H, int Dc, int Dv) {
  // quads of dgates a chunk: 128 in bf16 (16 KB of weights, 32 KB of rows), 64 in fp32
  constexpr int QCH = rch<E>() / 2;
  __shared__ __align__(16) E w_s[QCH * UT * 4];
  __shared__ __align__(16) float4 dg_s[BT * QCH];

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
    const int nrows = min(BT, B - row0);
    const float4* s4 = reinterpret_cast<const float4*>(dg);  // [B][H] quads
    const E* wu = w_s + 4 * u;
    float a0 = 0.f, a1 = 0.f;
    for (int k0 = 0; k0 < H; k0 += QCH) {
      const int kn = min(QCH, H - k0);
      __syncthreads();  // the previous chunk is consumed
      stage_copy(reinterpret_cast<uint4*>(w_s),
                 reinterpret_cast<const uint4*>(w_all_t + ((size_t)tile * H + k0) * UT * 4),
                 kn * UT * 4 * (int)sizeof(E) / 16, tid);
      for (int ci = tid; ci < BT * kn; ci += GTHREADS) {
        const int rr = ci / kn, kq = ci - rr * kn;
        dg_s[rr * kn + kq] = rr < nrows ? s4[(size_t)(row0 + rr) * H + k0 + kq]
                                        : make_float4(0.f, 0.f, 0.f, 0.f);
      }
      __syncthreads();
      const float4* dr = dg_s + (size_t)r * kn;
#pragma unroll 4
      for (int kq = 0; kq < kn; ++kq) {
        const float4 d = dr[kq];
        const float4 w = quad(wu, kq * UT);
        a0 = fmaf(d.x, w.x, a0);
        a1 = fmaf(d.y, w.y, a1);
        a0 = fmaf(d.z, w.z, a0);
        a1 = fmaf(d.w, w.w, a1);
      }
    }
    acc = bahdanau::Elem<E>::round(a0 + a1);
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
template <bool DOT, typename E>
__global__ void __launch_bounds__(bahdanau::THREADS)
align_bwd_row_kernel_t(const E* __restrict__ wq,                  // [H, A]
                       const E* __restrict__ vatt,                // [A] or null (dot)
                       const void* __restrict__ keys_in,          // [B, S, A] Key<DOT>
                       const E* __restrict__ values,              // [B, S, Dv]
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
  const auto* keys = static_cast<const typename bahdanau::Key<DOT>::type*>(keys_in);
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

size_t step_row_smem_bytes(int H, int A, int S, int Dv) {
  return (bahdanau::read_bwd_smem_floats(H, A, S, Dv) + H) * sizeof(float);
}

}  // namespace

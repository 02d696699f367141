// K6: single-query decode attention (one new position per row against the
// keys and values it may attend to), the two attention reads of
// avsr_tpu/models/transformer_decoder.py:decode_step:
//
//   * self attention over the bf16 KV cache [N, L, nh*dh] at the shared
//     position pos (transformer_decoder.py:271-280): key j is valid iff
//     j <= pos, the others get -1e9;
//   * cross attention over the prepared memory (_cross_attend_rows,
//     :199-214): keys [B, S, nh*A], values [B, S, nh*dv], the memory's
//     additive bias [B, S] (0 or -1e30).  The memory is NOT tiled over the
//     beams: query row n = b * W + w (W = N / B beams of utterance b) reads
//     memory row b, as the reference's beam-tiled copy would give it.
//
// Per (row n, head h), under the bf16 policy:
//
//   s_j  = float(bf16(q . k_j)) * (1 / sqrt(dk)) + bias[n / W, j]
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
// (HBM), against two FMAs per byte pair.  At N = 80 beams (B = 8, W = 10)
// the self read is (pos + 1) * 80 * 1 KB (12.3 MB at pos = 149, ~3.7 us)
// and the cross read of the v2 memory 8 * 197 * 3 KB = 4.8 MB (~1.4 us).
// Three routes, chosen by shape alone (kernels.decode_attention_route):
//
// * "grouped", cross mode with W >= 2 beams a memory row, widths that are
//   multiples of 16: a CTA per (memory row b, head h, slice of dv / CV
//   value columns; kernels.decode_grouped_slices: CV as many as make a
//   wave, each slice 32 columns at least) copies the W queries, all of the
//   row's keys and its slice of the values into shared memory at once
//   (16-byte cp.async, every row in flight; rows padded by 16 bytes), forms
//   the W x S scores on the tensor cores (mma.sync, W padded to 16-row
//   strips), the fp32 softmax a warp a query, and bf16(P) . V over its
//   columns on the tensor cores.  No exchange between CTAs: each key row
//   is read once for the W queries by each of the CV CTAs of (b, h), each
//   value row once.  The memory is read for the W beams at once: 4.8 MB a
//   v2 step where the beam-tiled read moved 48 MB.
// * "rows", self mode at nh * dh = 256 (every preset's decoder): one block
//   of 16 warps per row n, every head.  The row's keys 0..pos and values
//   0..pos are contiguous in the cache ((pos + 1) * 512 B each): thread 0
//   issues them all at once as bulk copies of 32-key tiles, one mbarrier a
//   tile, so the whole row is in flight while the warps wait for its first
//   tile.  A warp takes one key row at a time (lane l its 16-byte chunk,
//   elements 8l..8l+7, of head l / (dh / 8)), reduced over the head's
//   dh / 8 lanes with shuffles; the fp32 softmax a warp per head; P.V with
//   the keys split over the 16 warps (lane l its 8 channels), the partial
//   rows summed in warp order.
// * "general", every other shape (greedy's cross read, W = 1, with nothing
//   to share; other self widths; a cache or a memory longer than the
//   kernels above hold in shared memory): one block of 128 threads per
//   (n, h), row n reading key row n / W; the query in
//   shared memory as fp32; scores by groups of dk/8 lanes, each lane one
//   16-byte chunk of a key row, reduced with shuffles inside the group; the
//   fp32 softmax over the block; P.V with a thread per channel pair and the
//   keys split over the remaining thread slices, summed in a fixed order.
//
// The fp32 policy (train.compute_dtype = "float32": the fp32 KV cache and
// memory, the reference's same lines with no bf16 rounding point) runs the
// "general" kernel's fp32 instance (avsr_decode_attn_f32) for every read,
// self and cross, beam and greedy: its CUDA-core FMAs take fp32 operands
// as they are, and the bytes it reads double.  A beam step's cross read of
// the fp32 memory is then one block per (beam, head), each reading its
// utterance's memory row: W times the untiled bytes, through L2.
//
// Every route sums in a fixed order: the same bits every run.  Two
// launches per decoder layer per step; the cache write at pos stays a slice
// assignment on the same stream before the self launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cluster_ptx.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int ROW_WIDTH = 256;            // nh * dh of the rows kernel: one 16-byte chunk a lane
constexpr int ROW_WARPS = 16;
constexpr int ROW_THREADS = 32 * ROW_WARPS;
constexpr int ROW_TILE = 32;              // keys a bulk copy of the rows kernel
constexpr size_t SMEM_LIMIT = 232448;     // bytes a block may use on an H100

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

// ---- "general" ---------------------------------------------------------------
//
// Templated on the element type E of q, k, v and ctx: bf16 (the bf16
// policy, above) or fp32 (the fp32 policy: the same lines with no rounding
// point, s_j = (q . k_j) * (1 / sqrt(dk)) + bias, ctx = sum_j p_j v_j, all
// fp32 FMAs; kernels.decode_attention_route sends every fp32 read here,
// counted as decode_attention_f32).  A lane's 16-byte chunk of a key row
// holds 16 / sizeof(E) elements: 8 bf16 or 4 fp32.

template <typename E> struct Elem;
template <> struct Elem<__nv_bfloat16> {
  __device__ static float round(float x) { return bf_round(x); }
  __device__ static float get(__nv_bfloat16 x) { return __bfloat162float(x); }
  // q_s[0..7] . the 8 elements of u
  __device__ static float dot_chunk(const float* qq, uint4 u, float acc) {
    acc = fmaf(qq[0], bf_lo(u.x), acc);
    acc = fmaf(qq[1], bf_hi(u.x), acc);
    acc = fmaf(qq[2], bf_lo(u.y), acc);
    acc = fmaf(qq[3], bf_hi(u.y), acc);
    acc = fmaf(qq[4], bf_lo(u.z), acc);
    acc = fmaf(qq[5], bf_hi(u.z), acc);
    acc = fmaf(qq[6], bf_lo(u.w), acc);
    acc = fmaf(qq[7], bf_hi(u.w), acc);
    return acc;
  }
  __device__ static float2 pair(const __nv_bfloat16* row, int cp) {
    const uint32_t vv = reinterpret_cast<const uint32_t*>(row)[cp];
    return make_float2(bf_lo(vv), bf_hi(vv));
  }
  __device__ static void store_pair(__nv_bfloat16* row, int cp, float a0, float a1) {
    reinterpret_cast<__nv_bfloat162*>(row)[cp] = __floats2bfloat162_rn(a0, a1);
  }
};
template <> struct Elem<float> {
  __device__ static float round(float x) { return x; }
  __device__ static float get(float x) { return x; }
  __device__ static float dot_chunk(const float* qq, uint4 u, float acc) {
    acc = fmaf(qq[0], __uint_as_float(u.x), acc);
    acc = fmaf(qq[1], __uint_as_float(u.y), acc);
    acc = fmaf(qq[2], __uint_as_float(u.z), acc);
    acc = fmaf(qq[3], __uint_as_float(u.w), acc);
    return acc;
  }
  __device__ static float2 pair(const float* row, int cp) {
    return reinterpret_cast<const float2*>(row)[cp];
  }
  __device__ static void store_pair(float* row, int cp, float a0, float a1) {
    reinterpret_cast<float2*>(row)[cp] = make_float2(a0, a1);
  }
};

template <bool HAS_BIAS, typename E>
__global__ void __launch_bounds__(THREADS)
decode_attn_kernel(const E* __restrict__ q,       // [N, nh, dk]
                   const E* __restrict__ k,       // [N / W, L, nh, dk]
                   const E* __restrict__ v,       // [N / W, L, nh, dv]
                   const float* __restrict__ bias,  // [N / W, L] (cross mode)
                   E* __restrict__ ctx,           // [N, nh, dv]
                   int W, int L, int n_keys, int nh, int dk, int dv) {
  using X = Elem<E>;
  constexpr int EPC = 16 / sizeof(E);  // elements a 16-byte chunk
  extern __shared__ __align__(16) unsigned char smem[];
  const int h = blockIdx.x, n = blockIdx.y, m = n / W;  // m: the key / value row
  float* q_s = reinterpret_cast<float*>(smem);  // [dk]
  float* p_s = q_s + dk;                        // [n_keys] scores, then P
  float* red = p_s + L;                         // [WARPS]
  float* part = red + WARPS;                    // [THREADS * 2] P.V partial sums
  const int tid = threadIdx.x;

  const E* qn = q + ((size_t)n * nh + h) * dk;
  for (int i = tid; i < dk; i += THREADS) q_s[i] = X::get(qn[i]);
  __syncthreads();

  // scores: G lanes per key, each lane a 16-byte chunk (EPC elements) of it
  const int cpr = dk / EPC;
  int G = 1;
  while (G * 2 <= cpr && G * 2 <= 32) G *= 2;
  const int groups = THREADS / G, g = tid / G, lg = tid % G;
  const size_t row = (size_t)nh * dk;
  const E* kb = k + ((size_t)m * L * nh + h) * dk;
  const float inv_sq = 1.0f / sqrtf((float)dk);
  // unrolled: the key rows' loads of four passes in flight at once
#pragma unroll 4
  for (int j0 = 0; j0 < n_keys; j0 += groups) {  // uniform trip count: shuffles are safe
    const int j = j0 + g;
    float acc = 0.f;
    if (j < n_keys) {
      const uint4* kr = reinterpret_cast<const uint4*>(kb + (size_t)j * row);
      for (int c = lg; c < cpr; c += G) acc = X::dot_chunk(q_s + c * EPC, kr[c], acc);
    }
    for (int o = G / 2; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if (j < n_keys && lg == 0) {
      float s = X::round(acc) * inv_sq;
      if (HAS_BIAS) s += bias[(size_t)m * L + j];
      p_s[j] = s;
    }
  }
  __syncthreads();

  // fp32 softmax over the block; P rounded to E for the product
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
  for (int j = tid; j < n_keys; j += THREADS) p_s[j] = X::round(p_s[j] / sum);
  __syncthreads();

  // P.V: a thread per channel pair, keys split over `slices` thread groups
  const int npair = dv / 2;
  const size_t vrow = (size_t)nh * dv;
  const E* vb = v + ((size_t)m * L * nh + h) * dv;
  E* out = ctx + ((size_t)n * nh + h) * dv;
  // unrolled: eight value rows' loads in flight, summed in key order
  if (npair > THREADS) {
    for (int cp = tid; cp < npair; cp += THREADS) {
      float a0 = 0.f, a1 = 0.f;
#pragma unroll 8
      for (int j = 0; j < n_keys; ++j) {
        const float2 vv = X::pair(vb + (size_t)j * vrow, cp);
        a0 = fmaf(p_s[j], vv.x, a0);
        a1 = fmaf(p_s[j], vv.y, a1);
      }
      X::store_pair(out, cp, a0, a1);
    }
    return;
  }
  const int slices = THREADS / npair;
  const int cp = tid % npair, sl = tid / npair;
  if (sl < slices) {
    float a0 = 0.f, a1 = 0.f;
#pragma unroll 8
    for (int j = sl; j < n_keys; j += slices) {
      const float2 vv = X::pair(vb + (size_t)j * vrow, cp);
      a0 = fmaf(p_s[j], vv.x, a0);
      a1 = fmaf(p_s[j], vv.y, a1);
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
    X::store_pair(out, tid, a0, a1);
  }
}

// ---- "rows" ------------------------------------------------------------------

// Shared memory of the rows kernel over n_keys keys and nh heads, byte
// offsets: the keys and the values [n_keys][256] bf16, the scores then
// bf16(P) [nh][n_keys] fp32, the warps' P.V partial rows [16][256] fp32, one
// mbarrier per 32-key tile of keys, then of values.
struct RowLayout {
  int tiles;
  size_t v, p, part, bars, total;
  __host__ __device__ RowLayout(int n_keys, int nh) {
    tiles = (n_keys + ROW_TILE - 1) / ROW_TILE;
    v = (size_t)n_keys * ROW_WIDTH * 2;
    p = 2 * v;
    part = p + (((size_t)nh * n_keys * 4 + 15) & ~(size_t)15);
    bars = part + (size_t)ROW_WARPS * ROW_WIDTH * 4;
    total = bars + (size_t)2 * tiles * 8;
  }
};

// Self attention of row n over its cache keys [0, n_keys), every head; G =
// dh / 8 lanes a head (a power of two up to 32).
template <int G>
__global__ void __launch_bounds__(ROW_THREADS)
decode_rows_kernel(const __nv_bfloat16* __restrict__ q,  // [N, 256]
                   const __nv_bfloat16* __restrict__ k,  // [N, L, 256]
                   const __nv_bfloat16* __restrict__ v,  // [N, L, 256]
                   __nv_bfloat16* __restrict__ ctx,      // [N, 256]
                   int L, int n_keys, int nh) {
  extern __shared__ __align__(128) unsigned char rsm[];  // RowLayout
  const RowLayout lay(n_keys, nh);
  const int n = blockIdx.x, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const __nv_bfloat16* k_s = reinterpret_cast<const __nv_bfloat16*>(rsm);
  const __nv_bfloat16* v_s = reinterpret_cast<const __nv_bfloat16*>(rsm + lay.v);
  float* p_s = reinterpret_cast<float*>(rsm + lay.p);
  float* part = reinterpret_cast<float*>(rsm + lay.part);
  uint64_t* full = reinterpret_cast<uint64_t*>(rsm + lay.bars);  // [keys' tiles | values' tiles]

  if (threadIdx.x == 0) {
    for (int t = 0; t < 2 * lay.tiles; ++t) cluster_ptx::mbar_init(&full[t], 1);
    cluster_ptx::fence_mbar_init();
    // every tile of the row at once: keys first, then values
    const size_t row0 = (size_t)n * L * ROW_WIDTH;
    for (int t = 0; t < 2 * lay.tiles; ++t) {
      const int tt = t % lay.tiles, rows = min(ROW_TILE, n_keys - tt * ROW_TILE);
      const uint32_t bytes = (uint32_t)rows * ROW_WIDTH * 2;
      const size_t off = (size_t)tt * ROW_TILE * ROW_WIDTH;
      cluster_ptx::mbar_expect(&full[t], bytes);
      cluster_ptx::bulk_g2s(cluster_ptx::smem_addr(rsm + (t < lay.tiles ? 0 : lay.v) + off * 2),
                            (t < lay.tiles ? k : v) + row0 + off, bytes,
                            cluster_ptx::smem_addr(&full[t]));
    }
  }
  // this lane's 8 query elements (head lane / G), fp32
  float qf[8];
  {
    const uint4 u = reinterpret_cast<const uint4*>(q + (size_t)n * ROW_WIDTH)[lane];
    qf[0] = bf_lo(u.x); qf[1] = bf_hi(u.x); qf[2] = bf_lo(u.y); qf[3] = bf_hi(u.y);
    qf[4] = bf_lo(u.z); qf[5] = bf_hi(u.z); qf[6] = bf_lo(u.w); qf[7] = bf_hi(u.w);
  }
  const float inv_sq = 1.0f / sqrtf((float)(8 * G));
  const int head = lane / G;
  __syncthreads();  // the barriers' initialisation

  // scores: warp w takes keys w, w + 8, ... of each tile as it lands
  for (int t = 0; t < lay.tiles; ++t) {
    cluster_ptx::mbar_wait(&full[t], 0);
    const int j_end = min(n_keys, (t + 1) * ROW_TILE);
#pragma unroll 4
    for (int j = t * ROW_TILE + warp; j < j_end; j += ROW_WARPS) {
      const uint4 u = reinterpret_cast<const uint4*>(k_s + (size_t)j * ROW_WIDTH)[lane];
      float acc = 0.f;
      acc = fmaf(qf[0], bf_lo(u.x), acc);
      acc = fmaf(qf[1], bf_hi(u.x), acc);
      acc = fmaf(qf[2], bf_lo(u.y), acc);
      acc = fmaf(qf[3], bf_hi(u.y), acc);
      acc = fmaf(qf[4], bf_lo(u.z), acc);
      acc = fmaf(qf[5], bf_hi(u.z), acc);
      acc = fmaf(qf[6], bf_lo(u.w), acc);
      acc = fmaf(qf[7], bf_hi(u.w), acc);
#pragma unroll
      for (int o = G / 2; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
      if (lane % G == 0) p_s[(size_t)head * n_keys + j] = bf_round(acc) * inv_sq;
    }
  }
  __syncthreads();

  // the fp32 softmax, a warp per head; P rounded to bf16 for the product
  for (int hh = warp; hh < nh; hh += ROW_WARPS) {
    float* ps = p_s + (size_t)hh * n_keys;
    float mx = __int_as_float(0xff800000u);  // -inf
    for (int j = lane; j < n_keys; j += 32) mx = fmaxf(mx, ps[j]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    float sum = 0.f;
    for (int j = lane; j < n_keys; j += 32) {
      const float e = expf(ps[j] - mx);
      ps[j] = e;
      sum += e;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    __syncwarp();
    for (int j = lane; j < n_keys; j += 32) ps[j] = bf_round(ps[j] / sum);
  }
  __syncthreads();

  // P.V: warp w the keys w, w + 8, ...; lane l its 8 channels
  float acc[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) acc[e] = 0.f;
  const float* ph = p_s + (size_t)head * n_keys;
  for (int t = 0; t < lay.tiles; ++t) {
    cluster_ptx::mbar_wait(&full[lay.tiles + t], 0);
    const int j_end = min(n_keys, (t + 1) * ROW_TILE);
#pragma unroll 4
    for (int j = t * ROW_TILE + warp; j < j_end; j += ROW_WARPS) {
      const uint4 u = reinterpret_cast<const uint4*>(v_s + (size_t)j * ROW_WIDTH)[lane];
      const float p = ph[j];
      acc[0] = fmaf(p, bf_lo(u.x), acc[0]);
      acc[1] = fmaf(p, bf_hi(u.x), acc[1]);
      acc[2] = fmaf(p, bf_lo(u.y), acc[2]);
      acc[3] = fmaf(p, bf_hi(u.y), acc[3]);
      acc[4] = fmaf(p, bf_lo(u.z), acc[4]);
      acc[5] = fmaf(p, bf_hi(u.z), acc[5]);
      acc[6] = fmaf(p, bf_lo(u.w), acc[6]);
      acc[7] = fmaf(p, bf_hi(u.w), acc[7]);
    }
  }
  float4* pw = reinterpret_cast<float4*>(part + (size_t)warp * ROW_WIDTH + 8 * lane);
  pw[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
  pw[1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
  __syncthreads();
  if (threadIdx.x >= ROW_WIDTH) return;
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < ROW_WARPS; ++w) s += part[w * ROW_WIDTH + threadIdx.x];
  ctx[(size_t)n * ROW_WIDTH + threadIdx.x] = __float2bfloat16(s);
}

template <int G>
cudaError_t launch_rows(const void* q, const void* k, const void* v, void* ctx, int N, int L,
                        int n_keys, int nh, size_t smem, cudaStream_t st) {
  cudaError_t e = cudaFuncSetAttribute(decode_rows_kernel<G>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  decode_rows_kernel<G><<<N, ROW_THREADS, smem, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(ctx), L, n_keys, nh);
  return cudaGetLastError();
}

// ---- "grouped" ---------------------------------------------------------------

constexpr int GRP_THREADS = 256;

// Shared memory of a grouped CTA of nst strips of 16 queries over S_pad
// keys (S rounded up to 16) and dvs value columns at key width dk, byte
// offsets: the queries [16 nst][dk + 8] bf16, the keys [S_pad][dk + 8]
// bf16, the value columns [S_pad][dvs + 8] bf16 (every row 16 bytes past a
// multiple of 128: the 8 rows one ldmatrix reads fall in 8 bank groups), the
// scores [16 nst][S_pad] fp32, bf16(P) [16 nst][S_pad + 8].
struct GroupLayout {
  size_t k, v, s, p, total;
  __host__ __device__ GroupLayout(int nst, int S_pad, int dk, int dvs) {
    k = (size_t)16 * nst * (dk + 8) * 2;
    v = k + (size_t)S_pad * (dk + 8) * 2;
    s = v + (size_t)S_pad * (dvs + 8) * 2;
    p = s + (size_t)16 * nst * S_pad * 4;
    total = p + (size_t)16 * nst * (S_pad + 8) * 2;
  }
};

// One CTA per (memory row b, head h, slice r of dvs value columns)
// (blockIdx.x = (b nh + h) CV + r): the W queries of utterance b as 16-row
// strips against all S keys of memory row b on the tensor cores, the fp32
// softmax a warp a query, bf16(P) . V over its value columns on the tensor
// cores.  Each key row is read once for the W queries by each of the CV
// CTAs of (b, h), each value row once.
__global__ void __launch_bounds__(GRP_THREADS)
decode_grouped_kernel(const __nv_bfloat16* __restrict__ q,  // [B W, nh, dk]
                      const __nv_bfloat16* __restrict__ k,  // [B, S, nh, dk]
                      const __nv_bfloat16* __restrict__ v,  // [B, S, nh, dv]
                      const float* __restrict__ bias,       // [B, S]
                      __nv_bfloat16* __restrict__ ctx,      // [B W, nh, dv]
                      int W, int S, int CV, int nh, int dk, int dv) {
  using mma_attn::pitched::load_a;
  using mma_attn::pitched::load_b;
  using mma_attn::pitched::load_bt;
  extern __shared__ __align__(128) unsigned char gsm[];  // GroupLayout
  const int r = blockIdx.x % CV, bh = blockIdx.x / CV, b = bh / nh, h = bh % nh;
  const int nst = (W + 15) / 16, S_pad = (S + 15) & ~15, dvs = dv / CV;
  const GroupLayout lay(nst, S_pad, dk, dvs);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g8 = lane >> 2, t2 = 2 * (lane & 3);
  const int kp = dk + 8, vp = dvs + 8, pp = S_pad + 8;  // row pitches, elements
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(gsm);
  __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(gsm + lay.k);
  __nv_bfloat16* v_s = reinterpret_cast<__nv_bfloat16*>(gsm + lay.v);
  float* s_s = reinterpret_cast<float*>(gsm + lay.s);                 // [16 nst][S_pad]
  __nv_bfloat16* p_s = reinterpret_cast<__nv_bfloat16*>(gsm + lay.p);  // [16 nst][pp]

  // the queries, the keys and the slice's value columns: every row at once,
  // 16 bytes a copy; the rows past W and S zero-filled
  const int qc = dk / 8, vc = dvs / 8;
  for (int i = tid; i < 16 * nst * qc; i += GRP_THREADS) {
    const int w = i / qc, cc = i % qc;
    const bool ok = w < W;
    mma_attn::cp_async16(q_s + (size_t)w * kp + 8 * cc,
                         q + (((size_t)b * W + (ok ? w : 0)) * nh + h) * dk + 8 * cc, ok);
  }
  for (int i = tid; i < S_pad * qc; i += GRP_THREADS) {
    const int j = i / qc, cc = i % qc;
    const bool ok = j < S;
    mma_attn::cp_async16(k_s + (size_t)j * kp + 8 * cc,
                         k + (((size_t)b * S + (ok ? j : 0)) * nh + h) * dk + 8 * cc, ok);
  }
  for (int i = tid; i < S_pad * vc; i += GRP_THREADS) {
    const int j = i / vc, cc = i % vc;
    const bool ok = j < S;
    mma_attn::cp_async16(
        v_s + (size_t)j * vp + 8 * cc,
        v + (((size_t)b * S + (ok ? j : 0)) * nh + h) * dv + (size_t)r * dvs + 8 * cc, ok);
  }
  mma_attn::cp_async_commit();
  mma_attn::cp_async_wait<0>();
  __syncthreads();

  // the scores, a (strip, 16-key step) a warp at a time: float(bf16(q . k))
  // / sqrt(dk) + bias, -inf past S
  const float inv_sq = 1.0f / sqrtf((float)dk);
  const float* bb = bias + (size_t)b * S;
  const int nks = S_pad / 16;
  for (int it = warp; it < nst * nks; it += GRP_THREADS / 32) {
    const int st = it / nks, ks = it % nks;
    float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    for (int kd = 0; kd < dk / 16; ++kd) {
      uint32_t af[4], bf[4];
      load_a(af, q_s, kp, 16 * st, 16 * kd, lane);
      load_b(bf, k_s, kp, 16 * ks, 16 * kd, lane);
      mma_attn::mma(acc[0], af, bf[0], bf[1]);
      mma_attn::mma(acc[1], af, bf[2], bf[3]);
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 16 * st + g8 + 8 * (e >> 1), j = 16 * ks + 8 * nt + t2 + (e & 1);
        s_s[(size_t)i * S_pad + j] =
            j < S ? bf_round(acc[nt][e]) * inv_sq + bb[j] : __int_as_float(0xff800000u);
      }
  }
  __syncthreads();

  // the fp32 softmax, a warp a query: bf16(P), zero past S and past W
  for (int i = warp; i < 16 * nst; i += GRP_THREADS / 32) {
    __nv_bfloat16* pr = p_s + (size_t)i * pp;
    if (i >= W) {
      for (int j = lane; j < S_pad; j += 32) pr[j] = __float2bfloat16(0.f);
      continue;
    }
    const float* sr = s_s + (size_t)i * S_pad;
    float m = __int_as_float(0xff800000u);  // -inf
    for (int j = lane; j < S; j += 32) m = fmaxf(m, sr[j]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    float sum = 0.f;
    for (int j = lane; j < S; j += 32) sum += expf(sr[j] - m);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    for (int j = lane; j < S_pad; j += 32)
      pr[j] = __float2bfloat16(j < S ? expf(sr[j] - m) / sum : 0.f);
  }
  __syncthreads();

  // bf16(P) . V over the slice's columns, a (strip, 16 columns) a warp
  const int ncs = dvs / 16;
  for (int it = warp; it < nst * ncs; it += GRP_THREADS / 32) {
    const int st = it / ncs, cs = it % ncs;
    float o[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    for (int ks = 0; ks < nks; ++ks) {
      uint32_t pa[4], vb[4];
      load_a(pa, p_s, pp, 16 * st, 16 * ks, lane);
      load_bt(vb, v_s, vp, 16 * ks, 16 * cs, lane);
      mma_attn::mma(o[0], pa, vb[0], vb[1]);
      mma_attn::mma(o[1], pa, vb[2], vb[3]);
    }
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int i = 16 * st + g8 + 8 * rr;
      if (i >= W) continue;
      __nv_bfloat16* out =
          ctx + (((size_t)b * W + i) * nh + h) * dv + (size_t)r * dvs + 16 * cs + t2;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
        *reinterpret_cast<uint32_t*>(out + 8 * nt) =
            mma_attn::pack_bf16(o[nt][2 * rr], o[nt][2 * rr + 1]);
    }
  }
}

template <typename E>
cudaError_t launch_general(const void* q, const void* k, const void* v, const void* bias,
                           void* ctx, int N, int B, int L, int n_keys, int nh, int dk, int dv,
                           cudaStream_t st) {
  if (dk % 8 || dv % 8 || n_keys < 1 || n_keys > L || N < 1 || B < 1 || N % B || nh < 1)
    return cudaErrorInvalidValue;
  if (bias != nullptr && n_keys != L) return cudaErrorInvalidValue;
  const size_t smem = (size_t)(dk + L + WARPS + 2 * THREADS) * sizeof(float);
  if (smem > SMEM_LIMIT) return cudaErrorInvalidValue;
  const dim3 grid(nh, N);
  const int W = N / B;
  const E* qb = static_cast<const E*>(q);
  const E* kb = static_cast<const E*>(k);
  const E* vb = static_cast<const E*>(v);
  E* cb = static_cast<E*>(ctx);
  if (smem > 48 * 1024) {  // lengths past ~12,000 keys
    const cudaFuncAttribute at = cudaFuncAttributeMaxDynamicSharedMemorySize;
    const cudaError_t e = bias == nullptr
                              ? cudaFuncSetAttribute(decode_attn_kernel<false, E>, at, (int)smem)
                              : cudaFuncSetAttribute(decode_attn_kernel<true, E>, at, (int)smem);
    if (e != cudaSuccess) return e;
  }
  if (bias == nullptr) {
    decode_attn_kernel<false, E><<<grid, THREADS, smem, st>>>(qb, kb, vb, nullptr, cb, W, L,
                                                              n_keys, nh, dk, dv);
  } else {
    decode_attn_kernel<true, E><<<grid, THREADS, smem, st>>>(
        qb, kb, vb, static_cast<const float*>(bias), cb, W, L, n_keys, nh, dk, dv);
  }
  return cudaGetLastError();
}

}  // namespace

// "general": bias null, self mode over keys [0, n_keys) of row n's cache
// (B == N); else cross mode over memory row n / (N / B), n_keys = L.
// bf16 operands and context.
extern "C" int avsr_decode_attn(const void* q, const void* k, const void* v, const void* bias,
                                void* ctx, int N, int B, int L, int n_keys, int nh, int dk,
                                int dv, void* stream) {
  return (int)launch_general<__nv_bfloat16>(q, k, v, bias, ctx, N, B, L, n_keys, nh, dk, dv,
                                            reinterpret_cast<cudaStream_t>(stream));
}

// The same over fp32 operands and context (the fp32 policy's K6).
extern "C" int avsr_decode_attn_f32(const void* q, const void* k, const void* v,
                                    const void* bias, void* ctx, int N, int B, int L, int n_keys,
                                    int nh, int dk, int dv, void* stream) {
  return (int)launch_general<float>(q, k, v, bias, ctx, N, B, L, n_keys, nh, dk, dv,
                                    reinterpret_cast<cudaStream_t>(stream));
}

// Shared-memory bytes of the rows kernel (the wrapper's route checks the limit).
extern "C" long long avsr_decode_rows_smem(int n_keys, int nh) {
  return (long long)RowLayout(n_keys, nh).total;
}

// "rows": self mode of rows [N] over keys [0, n_keys) of their caches at
// nh heads of width dh, nh * dh = 256, dh / 8 a power of two.
extern "C" int avsr_decode_attn_rows(const void* q, const void* k, const void* v, void* ctx,
                                     int N, int L, int n_keys, int nh, int dh, void* stream) {
  if (N < 1 || nh < 1 || nh * dh != ROW_WIDTH || n_keys < 1 || n_keys > L)
    return (int)cudaErrorInvalidValue;
  const size_t smem = RowLayout(n_keys, nh).total;
  if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  switch (dh / 8) {
    case 1: return (int)launch_rows<1>(q, k, v, ctx, N, L, n_keys, nh, smem, st);
    case 2: return (int)launch_rows<2>(q, k, v, ctx, N, L, n_keys, nh, smem, st);
    case 4: return (int)launch_rows<4>(q, k, v, ctx, N, L, n_keys, nh, smem, st);
    case 8: return (int)launch_rows<8>(q, k, v, ctx, N, L, n_keys, nh, smem, st);
    case 16: return (int)launch_rows<16>(q, k, v, ctx, N, L, n_keys, nh, smem, st);
    case 32: return (int)launch_rows<32>(q, k, v, ctx, N, L, n_keys, nh, smem, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Shared-memory bytes of a grouped CTA: W queries over S keys, dvs value columns.
extern "C" long long avsr_decode_grouped_smem(int W, int S, int dk, int dvs) {
  return (long long)GroupLayout((W + 15) / 16, (S + 15) & ~15, dk, dvs).total;
}

// "grouped": cross mode of N = B W queries over the untiled memory [B, S] at
// widths dk, dv multiples of 16, each (b, h)'s value columns split over CV
// CTAs (dv / CV a multiple of 16).
extern "C" int avsr_decode_attn_grouped(const void* q, const void* k, const void* v,
                                        const void* bias, void* ctx, int B, int W, int S, int CV,
                                        int nh, int dk, int dv, void* stream) {
  if (B < 1 || W < 1 || S < 1 || nh < 1 || dk % 16 || dv % 16 || dk < 16 || CV < 1 ||
      dv % (16 * CV) || bias == nullptr)
    return (int)cudaErrorInvalidValue;
  const size_t smem = GroupLayout((W + 15) / 16, (S + 15) & ~15, dk, dv / CV).total;
  if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(decode_grouped_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  decode_grouped_kernel<<<B * nh * CV, GRP_THREADS, smem, reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const float*>(bias),
      static_cast<__nv_bfloat16*>(ctx), W, S, CV, nh, dk, dv);
  return (int)cudaGetLastError();
}

// Multi-head attention over one utterance's keys on the H100's tensor cores
// (mma.sync m16n8k16, bf16 operands, fp32 accumulators), forward and
// backward, with the mask a functor.  K11 (encoder_attention.cu: the
// transformer encoder's self attention, avsr_tpu/models/transformer.py:204-224),
// K4 (cross_attention.cu: the fusion's audio queries over video keys,
// avsr_tpu/models/fusion.py:226-235) and K5 (decoder_attention.cu: the
// teacher-forced decoder's causal self attention, and its cross attention
// over the memory at the lengths decoder_cross_attention.cuh's kernels do
// not hold, avsr_tpu/models/transformer_decoder.py:335-373) run on it
// at the head widths it is built for; other widths (multiples of 8) take
// attention_core.cuh's CUDA-core kernels.  It computes, per (utterance b,
// head h), with DK the width of q and k and DV the width of v and ctx:
//
//   s[i, j]  = float(bf16(q_i . k_j)) / sqrt(DK) + mask(b, i, j)        (fp32)
//   P[i, :]  = softmax(s[i, :])     (fp32: max, expf(s - max), sum, divide)
//   ctx[i]   = bf16(sum_j bf16(P[i, j]) * v_j)              (fp32 accumulate)
//
// and, with the rounding points of JAX's autodiff of those lines,
//
//   dP  = bf16(dctx @ V^T);  D_i = sum_j dP[i, j] * P[i, j]
//   dsc = bf16(P * (dP - D) / sqrt(DK))
//   dQ  = bf16(dsc @ K);  dK = bf16(dsc^T @ Q);  dV = bf16(bf16(P)^T @ dctx)
//
// The mask is ADDED, never used to skip a key whose weight may be nonzero,
// so a row whose every key is masked gets the uniform softmax over its Tk
// keys (the causal mask's keys past a query, whose weights are exactly 0,
// are skipped a 16-key step at a time).  Key columns the tiles pad past Tk
// take s = -inf, P = 0: they are not keys.
//
// What bounds it on an H100: bytes.  K11 at B = 128, 8 heads, T = 197,
// DK = DV = 64 reads 77.5 MB and writes 25.8 MB forward (~31 us at 3.35
// TB/s) for 10.2 GFLOP (~10 us at 989 TFLOP/s); K4 at B = 128, 4 heads,
// T_a = 50, T_v = 150, DK = DV = 128 moves 67.8 MB forward, 15.4 MB of it
// the fp32 weights the module's alignments read (~20 us), for 1.2 GFLOP.
// The backwards read q, k, v, dctx and the row statistics and write dq,
// dk, dv.  What the kernels spend is latency: few warps per SM (registers),
// dependent mma chains, the softmax's arithmetic.
//
// Common design.  Every product is an mma.sync on fragments loaded by
// ldmatrix (.trans where the k axis of the B operand runs along the rows of
// the staged tile) from tiles staged by 16-byte cp.async into shared memory
// whose 16-byte chunks are XOR-swizzled by row (conflict-free ldmatrix);
// rows at or beyond the valid count are zero-filled.  A block owns 64 rows
// (4 warps of 16): queries forward and in the backward's launch 1, keys in
// launch 2.  A warp's scores stay in registers as mma C fragments; the
// exact two-pass softmax reduces over the quad's lanes (shfl_xor 1, 2), so
// a row never leaves its warp; bf16(P) is repacked from the C fragments
// into the A fragments of the P.V product in registers.  The save mode
// writes the row max and the row sum, fp32 [B, nh, Tq] each: the
// backward's residual, in place of the weights.  The backward is two
// launches and no [B, nh, Tq, Tk] tensor: launch 1 takes P from q, k, the
// mask and the saved statistics with exactly the forward's expression and
// fragment order (the forward's P bit for bit), forms dP, writes D (fp32
// [B, nh, Tq]) and sums dQ = dsc.K; launch 2 forms s, P and dP for its keys
// with the forward's operand roles (queries as the A operand), dsc from D,
// and transposes bf16(P) and dsc in registers (movmatrix) into the A
// fragments of dV += bf16(P)^T.dctx and dK += dsc^T.Q.  Every output row
// has one owner block and every sum a fixed order, with no atomics: a run
// gives the same bits every time.  Divisions are div_row, a corrected
// product with the reciprocal, not div.rn's per-element range check and
// slow-path branch (exact products where sqrt(DK) is a power of two).
//
// Two families share that arithmetic, by what they stage:
//
// * Whole rows (attn_mma_*; K11 and K5's causal self attention, DK = DV =
//   DH = 64).  K and V of the (b, h), or the backward key launch's Q and
//   dctx, are staged whole, once per block (forward: V's copy in flight
//   while the scores are formed).
//   The forward holds KC = 13 steps of 16 keys (T <= 208 in one pass, an
//   instance of its own in which the q fragments die after the scores);
//   longer rows take a max, a sum and a P.V pass per 208-key chunk, each
//   recomputing q.k^T (the T = 531 limit: three chunks).  Launch 2 holds
//   its keys' B fragments.  Shared memory grows with T: DH = 64, Tp = T
//   rounded up to 16: forward (64 + 2 Tp) * 128 B (61 KB at T = 197, 147 KB
//   at T = 531); launch 1 (128 + 2 Tp) * 128 B; launch 2 (128 + 2 Tp) * 128
//   + 16 Tp B (164 KB at T = 531).
// * Streamed tiles (attn_mma_stream_*; K4, (DK, DV) = (128, 128) and (128,
//   64), and K5's cross attention at (128, 256) past its own kernels'
//   lengths: Q > 160 backward, S > 5376 forward).  Whole rows of 128-wide K
//   and V do not fit at the presets' 16 s limits (the forward would need
//   221 KB at T_v = 400, launch 2 320 KB at T_a = 531), so the operand a
//   block runs over (keys and values forward and in launch 1, queries, dctx
//   and their rows' statistics in launch 2) passes through a ring of two slots of 64-row tiles, each fetched one
//   tile ahead of its use: shared memory is the same at any T (48 KB
//   forward, 96 and 98 KB for the backward's launches at 128 / 128), and
//   any T is taken.  The forward holds HELD steps of 16 keys in registers
//   (fitted to the row: K4's 10 for T_v = 150), each of K and V streaming
//   once; bf16(P) is packed into the P.V fragments before the values arrive,
//   so q's fragments and the fp32 scores are dead by then (at 128 the
//   scores' 80 floats and ctx's 64 are never live together).  Past that the
//   keys stream three times, q.k^T recomputed a tile at a time: the max,
//   the sum, then P and P.V with each key tile followed by its value tile.
//   The weights P (fp32 [B, nh, Tq, Tk], K4's alignments) are written from
//   the registers when asked for.  Launch 1 streams each key tile with its
//   value tile twice (D, then dQ); launch 2 streams each query tile once and
//   reads its own keys' fragments from shared memory at each step, so only
//   the dK and dV accumulators (128 floats at 128 / 128) stay in registers.
//   With 128-wide heads the whole-row design's shared memory would also
//   halve the blocks per SM; with K11's 64-wide ones the streamed design
//   read slower on the card (PERF.md §6, PR 10), so each keeps its own.
//   At DV = 256 the accumulators would spill (ctx 128 floats a thread, dK
//   and dV 192): NSPLIT = 2 splits the value columns over two blocks (the
//   forward and launch 2 each form the same scores, P and dsc over the full
//   widths, one half of ctx, or of dV and dK, accumulated per block), and
//   launch 1 reads its q and dctx fragments from the staged rows at each
//   step instead of holding them.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {
namespace mma_attn {

using bf16 = __nv_bfloat16;

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int ROWS = 16 * WARPS;  // queries (forward, launch 1) or keys (launch 2) per block
constexpr int KC = 13;            // 16-key steps of forward scores held in registers

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000u); }
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}
// x / y with r the correctly rounded 1 / y: one Markstein correction of
// x * r, without div.rn's per-element range check and slow-path branch.
// It divides each weight by its row sum (0 <= x <= 1 <= y) and, at a head
// width whose square root is not a power of two, the scores and their
// cotangents by sqrt(DK).  It is the correctly rounded quotient while the
// remainder x - y q stays a normal number: for the weights, quotients above
// ~2^-100; by sqrt(128), IEEE's bits for every bf16 x and for random fp32
// x wherever the quotient is above 1e-30 (tools/check_div_row.py).
// tools/torch_k11_division_ab.py times K11 with it against IEEE division
// and counts the weights where the two differ.
__device__ __forceinline__ float div_row(float x, float y, float r) {
  const float q = __fmul_rn(x, r);
  return __fmaf_rn(__fmaf_rn(-y, q, x), r, q);
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ---- PTX wrappers --------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16 bytes global -> shared; zero-filled (nothing read) when !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 16 : 0));
}
// 4 bytes global -> shared; zero-filled (nothing read) when !valid
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
// the transpose of an 8x8 bf16 fragment held one b32 (a row's column pair)
// per lane
__device__ __forceinline__ uint32_t movmatrix_trans(uint32_t x) {
  uint32_t y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n" : "=r"(y) : "r"(x));
  return y;
}
// d += a (16x16, row) . b (16x8, col)
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ---- staged tiles ----------------------------------------------------------
// A tile is rows of D bf16; chunk c (8 elements, 16 bytes) of row r sits at
// chunk c ^ (r & 7), so the 8 rows one ldmatrix reads hit 8 bank groups.

template <int D>
__device__ __forceinline__ int swz(int row, int chunk) {
  return row * D + ((chunk ^ (row & 7)) << 3);
}

// rows [0, n_rows) at `ld` elements apart in device memory into a swizzled
// tile; rows >= n_valid are zero.
template <int D>
__device__ __forceinline__ void stage(bf16* dst, const bf16* src, size_t ld, int n_rows,
                                      int n_valid) {
  constexpr int CPR = D / 8;
  for (int c = threadIdx.x; c < n_rows * CPR; c += THREADS) {
    const int r = c / CPR, ch = c % CPR;
    const bool ok = r < n_valid;
    cp_async16(dst + swz<D>(r, ch), ok ? src + (size_t)r * ld + ch * 8 : src, ok);
  }
}

// A fragment: tile rows r0..r0+15 (m) by columns 16 kd..16 kd+15 (k)
template <int D>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* tile, int r0, int kd,
                                       int lane) {
  ldsm_x4(a, tile + swz<D>(r0 + (lane & 15), 2 * kd + (lane >> 4)));
}
// B fragments of two n-tiles whose n runs along tile rows n0..n0+15 and k
// along columns 16 kd..16 kd+15: {b0, b1} of rows n0..n0+7, then n0+8..n0+15
template <int D>
__device__ __forceinline__ void load_b(uint32_t (&b)[4], const bf16* tile, int n0, int kd,
                                       int lane) {
  ldsm_x4(b, tile + swz<D>(n0 + (lane & 7) + ((lane >> 4) << 3), 2 * kd + ((lane >> 3) & 1)));
}
// B fragments of two n-tiles whose k runs along tile rows k0..k0+15 and n
// along columns 16 np..16 np+15: {b0, b1} of columns 16 np..+7, then +8..+15
template <int D>
__device__ __forceinline__ void load_bt(uint32_t (&b)[4], const bf16* tile, int k0, int np,
                                        int lane) {
  ldsm_x4_trans(b, tile + swz<D>(k0 + (lane & 7) + (((lane >> 3) & 1) << 3),
                                  2 * np + (lane >> 4)));
}

// The masks.  A mask functor's at(b) gives the additive mask of utterance
// b, (i, j) -> float, added to every score (never used to skip a key whose
// weight may be nonzero).  For the whole-row kernels it also gives
// keys(i_last, Tk), how many leading keys can carry a nonzero weight for
// queries 0..i_last, and first_query(j0), the first query that can weigh
// key j0 or a later one: those kernels skip the 16-key or 16-query steps
// outside them, whose weights are exactly 0 in fp32 and never a row's max,
// so the skip changes no bit.

// (1 - valid_j) * -1e9 from per-utterance key counts: the key-padding mask
// of the encoder's self attention (K11, the stack's own lengths) and of the
// fusion (K4, the video lengths).  Nothing is skipped: a row of length 0
// gets the uniform softmax over all its keys.
struct LengthMask {
  const int* len;
  struct Row {
    int n;
    __device__ float operator()(int, int j) const { return (j < n ? 0.f : 1.f) * -1e9f; }
    __device__ int keys(int, int Tk) const { return Tk; }
    __device__ int first_query(int) const { return 0; }
  };
  __device__ Row at(int b) const { return Row{len[b]}; }
};

// (1 - [j <= i]) * -1e9: the causal mask of the decoder's self attention
// (K5, avsr_tpu/models/transformer_decoder.py:335-348).  Keys past a
// query's position weigh exactly 0 (key 0 <= i always wins the max).
struct CausalMask {
  struct Row {
    __device__ float operator()(int i, int j) const { return (j <= i ? 0.f : 1.f) * -1e9f; }
    __device__ int keys(int i_last, int Tk) const { return min(Tk, i_last + 1); }
    __device__ int first_query(int j0) const { return j0; }
  };
  __device__ Row at(int) const { return Row{}; }
};

// the prepared memory's additive key bias, fp32 [B, S] (0 or -1e30): the
// decoder's cross attention (K5, transformer_decoder.py:359-373).  A memory
// of length 0 has -1e30 on every key: the uniform softmax over all S.
struct BiasMask {
  const float* bias;
  int S;
  struct Row {
    const float* b;
    __device__ float operator()(int, int j) const { return __ldg(b + j); }
  };
  __device__ Row at(int b) const { return Row{bias + (size_t)b * S}; }
};

// ---- the shared arithmetic -------------------------------------------------
// C fragment element e of a 16x8 tile: row g + 8 (e >> 1), column 2 t + (e & 1)
// with g = lane / 4, t = lane % 4.

// acc[nt] = a . b over the DH/16 k steps, in that order: the one sequence
// the forward and both backward launches use for q.k^T (and dctx.V^T)
template <int KD>
__device__ __forceinline__ void product2(float (&acc)[2][4], const uint32_t (&a)[KD][4],
                                         const uint32_t (&b)[KD][4]) {
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
#pragma unroll
  for (int kd = 0; kd < KD; ++kd) {
    mma(acc[0], a[kd], b[kd][0], b[kd][1]);
    mma(acc[1], a[kd], b[kd][2], b[kd][3]);
  }
}

// the scale of the scores: sqrt(DK) and its correctly rounded reciprocal
struct Scale {
  float sq, r;
};
template <int DK>
__device__ __forceinline__ Scale scale() {
  const float sq = sqrtf((float)DK);
  return Scale{sq, __frcp_rn(sq)};
}
// x / sqrt(DK): x * r, exact, where sqrt(DK) is a power of two (K11's 8),
// else div_row
template <int DK>
__device__ __forceinline__ float unscale(float x, Scale sc) {
  constexpr bool pow2 = DK == 4 || DK == 16 || DK == 64 || DK == 256;
  return pow2 ? x * sc.r : div_row(x, sc.sq, sc.r);
}

// s of query i, key j from the q.k accumulator; keys >= Tk are padding
template <int DK, typename Row>
__device__ __forceinline__ float score(float acc, int i, int j, int Tk, Scale sc, const Row& m) {
  return j < Tk ? unscale<DK>(round_bf16(acc), sc) + m(i, j) : neg_inf();
}

// the A fragment of a 16x16 product from the C fragments of its two 16x8
// halves along k (rounded to bf16)
__device__ __forceinline__ void c_to_a(uint32_t (&a)[4], const float (&c)[2][4]) {
  a[0] = pack_bf16(c[0][0], c[0][1]);
  a[1] = pack_bf16(c[0][2], c[0][3]);
  a[2] = pack_bf16(c[1][0], c[1][1]);
  a[3] = pack_bf16(c[1][2], c[1][3]);
}
// the A fragment of the transposed 16x16 tile (rows = the C fragments'
// columns), rounded to bf16
__device__ __forceinline__ void c_to_a_trans(uint32_t (&a)[4], const float (&c)[2][4]) {
  a[0] = movmatrix_trans(pack_bf16(c[0][0], c[0][1]));
  a[1] = movmatrix_trans(pack_bf16(c[1][0], c[1][1]));
  a[2] = movmatrix_trans(pack_bf16(c[0][2], c[0][3]));
  a[3] = movmatrix_trans(pack_bf16(c[1][2], c[1][3]));
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// the scores of key steps [c KC, c KC + KC) of a warp's 16 queries (steps
// past nks left as they were)
template <int DH, typename Row>
__device__ __forceinline__ void score_chunk(float (&s)[KC][2][4],
                                            const uint32_t (&qa)[DH / 16][4],
                                            const bf16* k_s, int c, int nks, int i_g, int Tk,
                                            Scale sc, const Row& m, int lane) {
#pragma unroll
  for (int kk = 0; kk < KC; ++kk) {
    const int ks = c * KC + kk;
    if (ks < nks) {
      uint32_t kb[DH / 16][4];
#pragma unroll
      for (int kd = 0; kd < DH / 16; ++kd) load_b<DH>(kb[kd], k_s, ks * 16, kd, lane);
      float acc[2][4];
      product2(acc, qa, kb);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[kk][nt][e] = score<DH>(acc[nt][e], i_g + 8 * (e >> 1),
                               ks * 16 + nt * 8 + 2 * (lane & 3) + (e & 1), Tk, sc, m);
    }
  }
}

// ---- forward -----------------------------------------------------------------

// One block per (b, h, 64 queries).  row_max / row_sum null: nothing saved.
// ONE: every key in one chunk (Tk <= 16 KC), so the q fragments die after
// the scores and the chunk loops fold away.
template <int DH, typename Mask, bool ONE>
__global__ void __launch_bounds__(THREADS)
attn_mma_fwd(const bf16* __restrict__ q,  // [B, Tq, nh, DH], rows ldq apart
             const bf16* __restrict__ k,  // [B, Tk, nh, DH], rows ldk apart
             const bf16* __restrict__ v,  // [B, Tk, nh, DH], rows ldv apart
             Mask mask, float* __restrict__ row_max, float* __restrict__ row_sum,  // [B, nh, Tq]
             bf16* __restrict__ ctx,  // [B, Tq, nh, DH], rows ldc apart
             int Tq, int Tk, int nh, int ldq, int ldk, int ldv, int ldc) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int b = blockIdx.z, h = blockIdx.y, i0 = blockIdx.x * ROWS;
  const int nks = (Tk + 15) >> 4, Tkp = nks << 4;
  bf16* q_s = reinterpret_cast<bf16*>(smem);  // [ROWS][DH]
  bf16* k_s = q_s + ROWS * DH;                // [Tkp][DH]
  bf16* v_s = k_s + (size_t)Tkp * DH;         // [Tkp][DH]
  stage<DH>(q_s, q + ((size_t)b * Tq + i0) * ldq + (size_t)h * DH, ldq, ROWS, min(ROWS, Tq - i0));
  stage<DH>(k_s, k + (size_t)b * Tk * ldk + (size_t)h * DH, ldk, Tkp, Tk);
  cp_async_commit();
  stage<DH>(v_s, v + (size_t)b * Tk * ldv + (size_t)h * DH, ldv, Tkp, Tk);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int i_g = i0 + warp * 16 + (lane >> 2);  // this thread's rows: i_g, i_g + 8
  const bool active = i0 + warp * 16 < Tq;
  const Scale sc = scale<DH>();
  const auto m = mask.at(b);
  // the key steps that can weigh this warp's queries
  const int nkw = (m.keys(min(Tq, i0 + warp * 16 + 16) - 1, Tk) + 15) >> 4;
  const int nch = ONE ? 1 : (nkw + KC - 1) / KC;
  uint32_t qa[DH / 16][4];
  float s[KC][2][4];
  float mx[2] = {neg_inf(), neg_inf()}, sm[2] = {0.f, 0.f};
  if (active) {
#pragma unroll
    for (int kd = 0; kd < DH / 16; ++kd) load_a<DH>(qa[kd], q_s, warp * 16, kd, lane);
    for (int c = 0; c < nch; ++c) {
      score_chunk<DH>(s, qa, k_s, c, nkw, i_g, Tk, sc, m, lane);
#pragma unroll
      for (int kk = 0; kk < KC; ++kk)
        if (c * KC + kk < nkw)
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[kk][nt][e]);
    }
    mx[0] = quad_max(mx[0]);
    mx[1] = quad_max(mx[1]);
    for (int c = 0; c < nch; ++c) {
      if (nch > 1) score_chunk<DH>(s, qa, k_s, c, nkw, i_g, Tk, sc, m, lane);
#pragma unroll
      for (int kk = 0; kk < KC; ++kk)
        if (c * KC + kk < nkw)
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float ex = expf(s[kk][nt][e] - mx[e >> 1]);
              sm[e >> 1] += ex;
              if (nch == 1) s[kk][nt][e] = ex;
            }
    }
    sm[0] = quad_sum(sm[0]);
    sm[1] = quad_sum(sm[1]);
  }
  const float rl[2] = {__frcp_rn(sm[0]), __frcp_rn(sm[1])};
  cp_async_wait<0>();
  __syncthreads();
  if (!active) return;

  float o[DH / 8][4];
#pragma unroll
  for (int nd = 0; nd < DH / 8; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nd][e] = 0.f;
  for (int c = 0; c < nch; ++c) {
    if (nch > 1) score_chunk<DH>(s, qa, k_s, c, nkw, i_g, Tk, sc, m, lane);
#pragma unroll
    for (int kk = 0; kk < KC; ++kk) {
      const int ks = c * KC + kk;
      if (ks < nkw) {
        float p[2][4];
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            p[nt][e] = div_row(nch == 1 ? s[kk][nt][e] : expf(s[kk][nt][e] - mx[e >> 1]),
                               sm[e >> 1], rl[e >> 1]);
        uint32_t pa[4];
        c_to_a(pa, p);
#pragma unroll
        for (int np = 0; np < DH / 16; ++np) {
          uint32_t vb[4];
          load_bt<DH>(vb, v_s, ks * 16, np, lane);
          mma(o[2 * np], pa, vb[0], vb[1]);
          mma(o[2 * np + 1], pa, vb[2], vb[3]);
        }
      }
    }
  }

  const int t2 = 2 * (lane & 3);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = i_g + 8 * r;
    if (i >= Tq) continue;
    bf16* out = ctx + ((size_t)b * Tq + i) * ldc + (size_t)h * DH + t2;
#pragma unroll
    for (int nd = 0; nd < DH / 8; ++nd)
      *reinterpret_cast<uint32_t*>(out + nd * 8) = pack_bf16(o[nd][2 * r], o[nd][2 * r + 1]);
    if (row_max != nullptr && (lane & 3) == 0) {
      row_max[((size_t)b * nh + h) * Tq + i] = mx[r];
      row_sum[((size_t)b * nh + h) * Tq + i] = sm[r];
    }
  }
}

// ---- backward ------------------------------------------------------------------

// Launch 1: D and dQ for one (b, h, 64 queries).
template <int DH, typename Mask>
__global__ void __launch_bounds__(THREADS)
attn_mma_bwd_q(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, Mask mask,
               const float* __restrict__ row_max, const float* __restrict__ row_sum,
               const bf16* __restrict__ dctx,  // [B, Tq, nh, DH], rows ldo apart
               float* __restrict__ D,          // [B, nh, Tq]
               bf16* __restrict__ dq,          // [B, Tq, nh, DH], rows lddq apart
               int Tq, int Tk, int nh, int ldq, int ldk, int ldv, int ldo, int lddq) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int b = blockIdx.z, h = blockIdx.y, i0 = blockIdx.x * ROWS;
  const int nks = (Tk + 15) >> 4, Tkp = nks << 4;
  const int nq = min(ROWS, Tq - i0);
  bf16* q_s = reinterpret_cast<bf16*>(smem);  // [ROWS][DH]
  bf16* do_s = q_s + ROWS * DH;               // [ROWS][DH]
  bf16* k_s = do_s + ROWS * DH;               // [Tkp][DH]
  bf16* v_s = k_s + (size_t)Tkp * DH;         // [Tkp][DH]
  stage<DH>(q_s, q + ((size_t)b * Tq + i0) * ldq + (size_t)h * DH, ldq, ROWS, nq);
  stage<DH>(do_s, dctx + ((size_t)b * Tq + i0) * ldo + (size_t)h * DH, ldo, ROWS, nq);
  stage<DH>(k_s, k + (size_t)b * Tk * ldk + (size_t)h * DH, ldk, Tkp, Tk);
  stage<DH>(v_s, v + (size_t)b * Tk * ldv + (size_t)h * DH, ldv, Tkp, Tk);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (i0 + warp * 16 >= Tq) return;
  const int i_g = i0 + warp * 16 + (lane >> 2);
  const Scale sc = scale<DH>();
  const auto m = mask.at(b);
  const int nkw = (m.keys(min(Tq, i0 + warp * 16 + 16) - 1, Tk) + 15) >> 4;
  const size_t st = ((size_t)b * nh + h) * Tq;
  float mx[2], sm[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = i_g + 8 * r;
    mx[r] = i < Tq ? row_max[st + i] : 0.f;
    sm[r] = i < Tq ? row_sum[st + i] : 1.f;
  }
  const float rl[2] = {__frcp_rn(sm[0]), __frcp_rn(sm[1])};
  uint32_t qa[DH / 16][4], da[DH / 16][4];
#pragma unroll
  for (int kd = 0; kd < DH / 16; ++kd) {
    load_a<DH>(qa[kd], q_s, warp * 16, kd, lane);
    load_a<DH>(da[kd], do_s, warp * 16, kd, lane);
  }

  // P and bf16(dP) of key step ks
  auto p_dp = [&](int ks, float (&p)[2][4], float (&dp)[2][4]) {
    uint32_t kb[DH / 16][4];
#pragma unroll
    for (int kd = 0; kd < DH / 16; ++kd) load_b<DH>(kb[kd], k_s, ks * 16, kd, lane);
    product2(p, qa, kb);
#pragma unroll
    for (int kd = 0; kd < DH / 16; ++kd) load_b<DH>(kb[kd], v_s, ks * 16, kd, lane);
    product2(dp, da, kb);
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float s = score<DH>(p[nt][e], i_g + 8 * (e >> 1),
                              ks * 16 + nt * 8 + 2 * (lane & 3) + (e & 1), Tk, sc, m);
        p[nt][e] = div_row(expf(s - mx[e >> 1]), sm[e >> 1], rl[e >> 1]);
        dp[nt][e] = round_bf16(dp[nt][e]);
      }
  };

  float dsum[2] = {0.f, 0.f};
  for (int ks = 0; ks < nkw; ++ks) {
    float p[2][4], dp[2][4];
    p_dp(ks, p, dp);
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) dsum[e >> 1] += dp[nt][e] * p[nt][e];
  }
  dsum[0] = quad_sum(dsum[0]);
  dsum[1] = quad_sum(dsum[1]);

  float acc[DH / 8][4];
#pragma unroll
  for (int nd = 0; nd < DH / 8; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nd][e] = 0.f;
  for (int ks = 0; ks < nkw; ++ks) {
    float p[2][4], dp[2][4];
    p_dp(ks, p, dp);
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) p[nt][e] = unscale<DH>(p[nt][e] * (dp[nt][e] - dsum[e >> 1]), sc);
    uint32_t dsa[4];
    c_to_a(dsa, p);
#pragma unroll
    for (int np = 0; np < DH / 16; ++np) {
      uint32_t kb[4];
      load_bt<DH>(kb, k_s, ks * 16, np, lane);
      mma(acc[2 * np], dsa, kb[0], kb[1]);
      mma(acc[2 * np + 1], dsa, kb[2], kb[3]);
    }
  }

  const int t2 = 2 * (lane & 3);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = i_g + 8 * r;
    if (i >= Tq) continue;
    bf16* out = dq + ((size_t)b * Tq + i) * lddq + (size_t)h * DH + t2;
#pragma unroll
    for (int nd = 0; nd < DH / 8; ++nd)
      *reinterpret_cast<uint32_t*>(out + nd * 8) = pack_bf16(acc[nd][2 * r], acc[nd][2 * r + 1]);
    if ((lane & 3) == 0) D[st + i] = dsum[r];
  }
}

// Launch 2: dK and dV for one (b, h, 64 keys), summed over every query.
template <int DH, typename Mask>
__global__ void __launch_bounds__(THREADS)
attn_mma_bwd_kv(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, Mask mask,
                const float* __restrict__ row_max, const float* __restrict__ row_sum,
                const float* __restrict__ D, const bf16* __restrict__ dctx,
                bf16* __restrict__ dk,  // [B, Tk, nh, DH], rows lddk apart
                bf16* __restrict__ dv,  // [B, Tk, nh, DH], rows lddv apart
                int Tq, int Tk, int nh, int ldq, int ldk, int ldv, int ldo, int lddk,
                int lddv) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int b = blockIdx.z, h = blockIdx.y, j0 = blockIdx.x * ROWS;
  const int nqs = (Tq + 15) >> 4, Tqp = nqs << 4;
  const int nk = min(ROWS, Tk - j0);
  bf16* k_s = reinterpret_cast<bf16*>(smem);  // [ROWS][DH]
  bf16* v_s = k_s + ROWS * DH;                // [ROWS][DH]
  bf16* q_s = v_s + ROWS * DH;                // [Tqp][DH]
  bf16* do_s = q_s + (size_t)Tqp * DH;        // [Tqp][DH]
  float* mx_s = reinterpret_cast<float*>(do_s + (size_t)Tqp * DH);  // [Tqp] x 4
  float* sm_s = mx_s + Tqp;
  float* rl_s = sm_s + Tqp;
  float* d_s = rl_s + Tqp;
  stage<DH>(k_s, k + ((size_t)b * Tk + j0) * ldk + (size_t)h * DH, ldk, ROWS, nk);
  stage<DH>(v_s, v + ((size_t)b * Tk + j0) * ldv + (size_t)h * DH, ldv, ROWS, nk);
  stage<DH>(q_s, q + (size_t)b * Tq * ldq + (size_t)h * DH, ldq, Tqp, Tq);
  stage<DH>(do_s, dctx + (size_t)b * Tq * ldo + (size_t)h * DH, ldo, Tqp, Tq);
  cp_async_commit();
  // padded queries: finite statistics and D = 0 (their q and dctx rows are
  // zero, so they add nothing)
  const size_t st = ((size_t)b * nh + h) * Tq;
  for (int i = threadIdx.x; i < Tqp; i += THREADS) {
    mx_s[i] = i < Tq ? row_max[st + i] : 0.f;
    sm_s[i] = i < Tq ? row_sum[st + i] : 1.f;
    rl_s[i] = __frcp_rn(sm_s[i]);
    d_s[i] = i < Tq ? D[st + i] : 0.f;
  }
  cp_async_wait<0>();
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (j0 + warp * 16 >= Tk) return;
  const Scale sc = scale<DH>();
  const auto m = mask.at(b);
  const int g = lane >> 2, t2 = 2 * (lane & 3);
  // the warp's 16 keys as the B operand of q.k^T and dctx.V^T
  uint32_t kb[DH / 16][4], vb[DH / 16][4];
#pragma unroll
  for (int kd = 0; kd < DH / 16; ++kd) {
    load_b<DH>(kb[kd], k_s, warp * 16, kd, lane);
    load_b<DH>(vb[kd], v_s, warp * 16, kd, lane);
  }
  float dk_acc[DH / 8][4], dv_acc[DH / 8][4];
#pragma unroll
  for (int nd = 0; nd < DH / 8; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[nd][e] = dv_acc[nd][e] = 0.f;

  // the query steps that can weigh this warp's keys
  for (int qs = m.first_query(j0 + warp * 16) >> 4; qs < nqs; ++qs) {
    uint32_t a[DH / 16][4];
    float p[2][4], dp[2][4];
#pragma unroll
    for (int kd = 0; kd < DH / 16; ++kd) load_a<DH>(a[kd], q_s, qs * 16, kd, lane);
    product2(p, a, kb);
#pragma unroll
    for (int kd = 0; kd < DH / 16; ++kd) load_a<DH>(a[kd], do_s, qs * 16, kd, lane);
    product2(dp, a, vb);
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = qs * 16 + g + 8 * (e >> 1);
        const float s = score<DH>(p[nt][e], i, j0 + warp * 16 + nt * 8 + t2 + (e & 1), Tk, sc, m);
        p[nt][e] = div_row(expf(s - mx_s[i]), sm_s[i], rl_s[i]);
        dp[nt][e] = unscale<DH>(p[nt][e] * (round_bf16(dp[nt][e]) - d_s[i]), sc);  // dsc before rounding
      }
    uint32_t pa[4], dsa[4];
    c_to_a_trans(pa, p);
    c_to_a_trans(dsa, dp);
#pragma unroll
    for (int np = 0; np < DH / 16; ++np) {
      uint32_t bt[4];
      load_bt<DH>(bt, do_s, qs * 16, np, lane);
      mma(dv_acc[2 * np], pa, bt[0], bt[1]);
      mma(dv_acc[2 * np + 1], pa, bt[2], bt[3]);
      load_bt<DH>(bt, q_s, qs * 16, np, lane);
      mma(dk_acc[2 * np], dsa, bt[0], bt[1]);
      mma(dk_acc[2 * np + 1], dsa, bt[2], bt[3]);
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int j = j0 + warp * 16 + g + 8 * r;
    if (j >= Tk) continue;
    bf16* odk = dk + ((size_t)b * Tk + j) * lddk + (size_t)h * DH + t2;
    bf16* odv = dv + ((size_t)b * Tk + j) * lddv + (size_t)h * DH + t2;
#pragma unroll
    for (int nd = 0; nd < DH / 8; ++nd) {
      *reinterpret_cast<uint32_t*>(odk + nd * 8) =
          pack_bf16(dk_acc[nd][2 * r], dk_acc[nd][2 * r + 1]);
      *reinterpret_cast<uint32_t*>(odv + nd * 8) =
          pack_bf16(dv_acc[nd][2 * r], dv_acc[nd][2 * r + 1]);
    }
  }
}

// ---- launchers -------------------------------------------------------------------

inline int pad16_host(int n) { return (n + 15) & ~15; }
template <int DH>
size_t fwd_smem(int Tk) {
  return (size_t)(ROWS + 2 * pad16_host(Tk)) * DH * 2;
}
template <int DH>
size_t bwd_q_smem(int Tk) {
  return (size_t)(2 * ROWS + 2 * pad16_host(Tk)) * DH * 2;
}
template <int DH>
size_t bwd_kv_smem(int Tq) {
  return (size_t)(2 * ROWS + 2 * pad16_host(Tq)) * DH * 2 + (size_t)4 * pad16_host(Tq) * 4;
}
// the largest request of the three launches
template <int DH>
size_t attn_smem(int Tq, int Tk) {
  size_t m = fwd_smem<DH>(Tk);
  if (bwd_q_smem<DH>(Tk) > m) m = bwd_q_smem<DH>(Tk);
  if (bwd_kv_smem<DH>(Tq) > m) m = bwd_kv_smem<DH>(Tq);
  return m;
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// The forward over q, k, v rows ld* elements apart and ctx rows ldc apart
// (multiples of 8: the 16-byte copies); the operands 16-byte aligned.
template <int DH, typename Mask>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, Mask mask, float* row_max,
                       float* row_sum, void* ctx, int B, int Tq, int Tk, int nh, int ldq, int ldk,
                       int ldv, int ldc, cudaStream_t stream) {
  if (Tq < 1 || Tk < 1 || ldq % 8 || ldk % 8 || ldv % 8 || ldc % 2 ||
      (row_max == nullptr) != (row_sum == nullptr))
    return cudaErrorInvalidValue;
  const size_t smem = fwd_smem<DH>(Tk);
  const auto kernel =
      (Tk + 15) / 16 <= KC ? attn_mma_fwd<DH, Mask, true> : attn_mma_fwd<DH, Mask, false>;
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  kernel<<<dim3((Tq + ROWS - 1) / ROWS, nh, B), THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v), mask,
      row_max, row_sum, static_cast<bf16*>(ctx), Tq, Tk, nh, ldq, ldk, ldv, ldc);
  return cudaGetLastError();
}

// The backward from the forward's operands and row statistics: D is an fp32
// [B, nh, Tq] scratch; dq, dk, dv rows are written ldd* elements apart.
template <int DH, typename Mask>
cudaError_t launch_bwd(const void* q, const void* k, const void* v, Mask mask,
                       const float* row_max, const float* row_sum, const void* dctx, float* D,
                       void* dq, void* dk, void* dv, int B, int Tq, int Tk, int nh, int ldq,
                       int ldk, int ldv, int ldo, int lddq, int lddk, int lddv,
                       cudaStream_t stream) {
  if (Tq < 1 || Tk < 1 || ldq % 8 || ldk % 8 || ldv % 8 || ldo % 8 || lddq % 2 || lddk % 2 ||
      lddv % 2)
    return cudaErrorInvalidValue;
  const size_t smem_q = bwd_q_smem<DH>(Tk), smem_kv = bwd_kv_smem<DH>(Tq);
  cudaError_t e = allow_smem(attn_mma_bwd_q<DH, Mask>, smem_q);
  if (e != cudaSuccess) return e;
  e = allow_smem(attn_mma_bwd_kv<DH, Mask>, smem_kv);
  if (e != cudaSuccess) return e;
  const bf16 *qb = static_cast<const bf16*>(q), *kb = static_cast<const bf16*>(k),
             *vb = static_cast<const bf16*>(v), *dob = static_cast<const bf16*>(dctx);
  attn_mma_bwd_q<DH, Mask><<<dim3((Tq + ROWS - 1) / ROWS, nh, B), THREADS, smem_q, stream>>>(
      qb, kb, vb, mask, row_max, row_sum, dob, D, static_cast<bf16*>(dq), Tq, Tk, nh, ldq, ldk,
      ldv, ldo, lddq);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  attn_mma_bwd_kv<DH, Mask><<<dim3((Tk + ROWS - 1) / ROWS, nh, B), THREADS, smem_kv, stream>>>(
      qb, kb, vb, mask, row_max, row_sum, D, dob, static_cast<bf16*>(dk), static_cast<bf16*>(dv),
      Tq, Tk, nh, ldq, ldk, ldv, ldo, lddk, lddv);
  return cudaGetLastError();
}

// ---- streamed tiles ----------------------------------------------------------

// acc[nt] = A . B^T over the D/16 k steps, in that order: the one sequence
// the forward and both backward launches use for q.k^T and dctx.V^T.  A's
// 16 rows are held fragments; B's 16 rows (n) are tile rows n0..n0+15.
template <int D>
__device__ __forceinline__ void product(float (&acc)[2][4], const uint32_t (&a)[D / 16][4],
                                        const bf16* tile, int n0, int lane) {
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
#pragma unroll
  for (int kd = 0; kd < D / 16; ++kd) {
    uint32_t b[4];
    load_b<D>(b, tile, n0, kd, lane);
    mma(acc[0], a[kd], b[0], b[1]);
    mma(acc[1], a[kd], b[2], b[3]);
  }
}
// the same with A's rows read from a staged tile too (rows r0..r0+15)
template <int D>
__device__ __forceinline__ void product(float (&acc)[2][4], const bf16* a_tile, int r0,
                                        const bf16* tile, int n0, int lane) {
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
#pragma unroll
  for (int kd = 0; kd < D / 16; ++kd) {
    uint32_t a[4], b[4];
    load_a<D>(a, a_tile, r0, kd, lane);
    load_b<D>(b, tile, n0, kd, lane);
    mma(acc[0], a, b[0], b[1]);
    mma(acc[1], a, b[2], b[3]);
  }
}
// acc (16 x W) += a (16 x 16) . the tile's rows k0..k0+15, columns
// c0..c0+W-1 (a tile of D-wide rows; c0 a multiple of 16)
template <int D, int W = D>
__device__ __forceinline__ void accumulate(float (&acc)[W / 8][4], const uint32_t (&a)[4],
                                           const bf16* tile, int k0, int lane, int c0 = 0) {
#pragma unroll
  for (int np = 0; np < W / 16; ++np) {
    uint32_t b[4];
    load_bt<D>(b, tile, k0, (c0 >> 4) + np, lane);
    mma(acc[2 * np], a, b[0], b[1]);
    mma(acc[2 * np + 1], a, b[2], b[3]);
  }
}

// a 16-key step of scores in place, for rows i_g, i_g + 8 and keys j0..j0+15
template <int DK, typename Row>
__device__ __forceinline__ void scores(float (&s)[2][4], int i_g, int j0, int Tk, Scale sc,
                                       const Row& m, int lane) {
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      s[nt][e] = score<DK>(s[nt][e], i_g + 8 * (e >> 1), j0 + nt * 8 + 2 * (lane & 3) + (e & 1), Tk,
                       sc, m);
}

// a 16-key step of weights into P's rows i_g, i_g + 8 (fp32 rows of Tk,
// row i of this (b, h) at P + i Tk; rows >= Tq and columns >= Tk skipped)
__device__ __forceinline__ void store_p(float* P, const float (&p)[2][4], int i_g, int j0, int Tq,
                                        int Tk, int lane) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = i_g + 8 * r;
    if (i >= Tq) continue;
    float* row = P + (size_t)i * Tk;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const int j = j0 + nt * 8 + 2 * (lane & 3);
      if (!(Tk & 1) && j < Tk) {
        *reinterpret_cast<float2*>(row + j) = make_float2(p[nt][2 * r], p[nt][2 * r + 1]);
      } else {
        if (j < Tk) row[j] = p[nt][2 * r];
        if (j + 1 < Tk) row[j + 1] = p[nt][2 * r + 1];
      }
    }
  }
}

// A ring of two slots of `slot` bytes each in shared memory, through which
// a stream of n elements (tiles) passes: fetch(e, dst) issues the cp.async
// copies of element e into dst.  Each element is fetched one step ahead of
// its use, one cp.async group each, and the block passes a barrier before
// each.  Every thread of the block calls next() for every element, in
// order.
template <typename Fetch>
struct Ring {
  unsigned char* base;
  int slot;
  int n;
  Fetch fetch;
  int e;

  __device__ __forceinline__ void issue(int i) {
    if (i < n) fetch(i, base + (size_t)(i & 1) * slot);
    cp_async_commit();
  }
  // the first element's group (with whatever the caller staged before)
  __device__ __forceinline__ void start() { issue(0); }
  // the next element, landed; the slot of the one before it, which every
  // thread is done with, takes the element after it
  __device__ __forceinline__ const bf16* next() {
    cp_async_wait<0>();
    __syncthreads();
    issue(e + 1);
    return reinterpret_cast<const bf16*>(base + (size_t)(e++ & 1) * slot);
  }
};
template <typename Fetch>
__device__ __forceinline__ Ring<Fetch> ring(unsigned char* base, int slot, int n, Fetch fetch) {
  return Ring<Fetch>{base, slot, n, fetch, 0};
}

// forward

// One block per (b, h, 64 queries, one of NSPLIT column slices of ctx:
// DVP = DV / NSPLIT values each; every slice forms the same scores and
// weights, slice 0 writes P and the statistics).  P, row_max / row_sum
// null: not written.  ONE: every key in one pass (Tk <= 16 HELD), the
// scores held.
template <int DK, int DV, int HELD, typename Mask, bool ONE, int NSPLIT>
__global__ void __launch_bounds__(THREADS)
attn_mma_stream_fwd(const bf16* __restrict__ q,  // [B, Tq, nh, DK], rows ldq apart
                    const bf16* __restrict__ k,  // [B, Tk, nh, DK], rows ldk apart
                    const bf16* __restrict__ v,  // [B, Tk, nh, DV], rows ldv apart
                    Mask mask, float* __restrict__ P,  // [B, nh, Tq, Tk]
                    float* __restrict__ row_max, float* __restrict__ row_sum,  // [B, nh, Tq]
                    bf16* __restrict__ ctx,  // [B, Tq, nh, DV], rows ldc apart
                    int Tq, int Tk, int nh, int ldq, int ldk, int ldv, int ldc) {
  constexpr int DVP = DV / NSPLIT;
  constexpr int DM = DK > DVP ? DK : DVP;
  extern __shared__ __align__(128) unsigned char smem[];
  const int b = blockIdx.z, h = blockIdx.y / NSPLIT, i0 = blockIdx.x * ROWS;
  const bool lead = blockIdx.y % NSPLIT == 0;  // the slice that writes P and the statistics
  const int nks = (Tk + 15) >> 4, nkt = (Tk + ROWS - 1) / ROWS;
  bf16* q_s = reinterpret_cast<bf16*>(smem);  // [ROWS][DK]
  const bf16* kb = k + (size_t)b * Tk * ldk + (size_t)h * DK;
  // this slice's columns of the head's values (and of ctx): blockIdx.y DVP on
  const bf16* vb = v + (size_t)b * Tk * ldv + (size_t)blockIdx.y * DVP;
  // the stream: ONE, the key tiles, then the value tiles; else the key
  // tiles twice (the max, the sum), then each key tile and its value tile
  auto fetch = [=](int e, unsigned char* dst) {
    int t = e;
    bool is_v = false;
    if constexpr (ONE) {
      is_v = e >= nkt;
      if (is_v) t = e - nkt;
    } else if (e < 2 * nkt) {
      if (e >= nkt) t = e - nkt;
    } else {
      t = (e - 2 * nkt) >> 1;
      is_v = (e - 2 * nkt) & 1;
    }
    const int n = min(ROWS, Tk - t * ROWS);
    if (is_v)
      stage<DVP>(reinterpret_cast<bf16*>(dst), vb + (size_t)t * ROWS * ldv, ldv, ROWS, n);
    else
      stage<DK>(reinterpret_cast<bf16*>(dst), kb + (size_t)t * ROWS * ldk, ldk, ROWS, n);
  };
  auto kv = ring(smem + ROWS * DK * 2, ROWS * DM * 2, (ONE ? 2 : 4) * nkt, fetch);
  stage<DK>(q_s, q + ((size_t)b * Tq + i0) * ldq + (size_t)h * DK, ldq, ROWS, min(ROWS, Tq - i0));
  kv.start();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int i_g = i0 + warp * 16 + (lane >> 2);  // this thread's rows: i_g, i_g + 8
  const bool active = i0 + warp * 16 < Tq;
  const Scale sc = scale<DK>();
  const auto m = mask.at(b);
  const size_t st = ((size_t)b * nh + h) * Tq;
  float* Pbh = P != nullptr && lead ? P + st * Tk : nullptr;
  uint32_t qa[DK / 16][4];
  float mx[2] = {neg_inf(), neg_inf()}, sm[2] = {0.f, 0.f};
  float o[DVP / 8][4];
#pragma unroll
  for (int nd = 0; nd < DVP / 8; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nd][e] = 0.f;

  if constexpr (ONE) {
    float s[HELD][2][4];
#pragma unroll
    for (int t = 0; t < (HELD + 3) / 4; ++t) {
      if (t < nkt) {
        const bf16* k_t = kv.next();
        if (active) {
          if (t == 0) {
#pragma unroll
            for (int kd = 0; kd < DK / 16; ++kd) load_a<DK>(qa[kd], q_s, warp * 16, kd, lane);
          }
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const int ks = 4 * t + kk;
            if (ks < HELD && ks < nks) {
              product<DK>(s[ks], qa, k_t, kk * 16, lane);
              scores<DK>(s[ks], i_g, ks * 16, Tk, sc, m, lane);
#pragma unroll
              for (int nt = 0; nt < 2; ++nt)
#pragma unroll
                for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[ks][nt][e]);
            }
          }
        }
      }
    }
    uint32_t pa[HELD][4];
    if (active) {
      mx[0] = quad_max(mx[0]);
      mx[1] = quad_max(mx[1]);
#pragma unroll
      for (int ks = 0; ks < HELD; ++ks)
        if (ks < nks)
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              s[ks][nt][e] = expf(s[ks][nt][e] - mx[e >> 1]);
              sm[e >> 1] += s[ks][nt][e];
            }
      sm[0] = quad_sum(sm[0]);
      sm[1] = quad_sum(sm[1]);
      const float rl[2] = {__frcp_rn(sm[0]), __frcp_rn(sm[1])};
#pragma unroll
      for (int ks = 0; ks < HELD; ++ks)
        if (ks < nks) {
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              s[ks][nt][e] = div_row(s[ks][nt][e], sm[e >> 1], rl[e >> 1]);
          if (Pbh != nullptr) store_p(Pbh, s[ks], i_g, ks * 16, Tq, Tk, lane);
          c_to_a(pa[ks], s[ks]);
        }
    }
#pragma unroll
    for (int t = 0; t < (HELD + 3) / 4; ++t) {
      if (t < nkt) {
        const bf16* v_t = kv.next();
        if (active) {
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            if (4 * t + kk < HELD && 4 * t + kk < nks)
              accumulate<DVP>(o, pa[4 * t + kk], v_t, kk * 16, lane);
        }
      }
    }
  } else {
    // the max
    for (int t = 0; t < nkt; ++t) {
      const bf16* k_t = kv.next();
      if (!active) continue;
      if (t == 0) {
#pragma unroll
        for (int kd = 0; kd < DK / 16; ++kd) load_a<DK>(qa[kd], q_s, warp * 16, kd, lane);
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const int ks = 4 * t + kk;
        if (ks < nks) {
          float s[2][4];
          product<DK>(s, qa, k_t, kk * 16, lane);
          scores<DK>(s, i_g, ks * 16, Tk, sc, m, lane);
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
        }
      }
    }
    mx[0] = quad_max(mx[0]);
    mx[1] = quad_max(mx[1]);
    // the sum
    for (int t = 0; t < nkt; ++t) {
      const bf16* k_t = kv.next();
      if (!active) continue;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const int ks = 4 * t + kk;
        if (ks < nks) {
          float s[2][4];
          product<DK>(s, qa, k_t, kk * 16, lane);
          scores<DK>(s, i_g, ks * 16, Tk, sc, m, lane);
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) sm[e >> 1] += expf(s[nt][e] - mx[e >> 1]);
        }
      }
    }
    sm[0] = quad_sum(sm[0]);
    sm[1] = quad_sum(sm[1]);
    const float rl[2] = {__frcp_rn(sm[0]), __frcp_rn(sm[1])};
    // P, and P.V
    for (int t = 0; t < nkt; ++t) {
      const bf16* k_t = kv.next();
      uint32_t pa[4][4];
      if (active) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const int ks = 4 * t + kk;
          if (ks < nks) {
            float s[2][4];
            product<DK>(s, qa, k_t, kk * 16, lane);
            scores<DK>(s, i_g, ks * 16, Tk, sc, m, lane);
#pragma unroll
            for (int nt = 0; nt < 2; ++nt)
#pragma unroll
              for (int e = 0; e < 4; ++e)
                s[nt][e] = div_row(expf(s[nt][e] - mx[e >> 1]), sm[e >> 1], rl[e >> 1]);
            if (Pbh != nullptr) store_p(Pbh, s, i_g, ks * 16, Tq, Tk, lane);
            c_to_a(pa[kk], s);
          }
        }
      }
      const bf16* v_t = kv.next();
      if (active) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          if (4 * t + kk < nks) accumulate<DVP>(o, pa[kk], v_t, kk * 16, lane);
      }
    }
  }
  if (!active) return;

  const int t2 = 2 * (lane & 3);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = i_g + 8 * r;
    if (i >= Tq) continue;
    bf16* out = ctx + ((size_t)b * Tq + i) * ldc + (size_t)blockIdx.y * DVP + t2;
#pragma unroll
    for (int nd = 0; nd < DVP / 8; ++nd)
      *reinterpret_cast<uint32_t*>(out + nd * 8) = pack_bf16(o[nd][2 * r], o[nd][2 * r + 1]);
    if (row_max != nullptr && lead && (lane & 3) == 0) {
      row_max[st + i] = mx[r];
      row_sum[st + i] = sm[r];
    }
  }
}

// backward

// Launch 1: D and dQ for one (b, h, 64 queries); the keys and values
// stream in tiles of TR rows.
template <int DK, int DV, typename Mask, int TR>
__global__ void __launch_bounds__(THREADS)
attn_mma_stream_bwd_q(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, Mask mask,
                      const float* __restrict__ row_max, const float* __restrict__ row_sum,
                      const bf16* __restrict__ dctx,  // [B, Tq, nh, DV], rows ldo apart
                      float* __restrict__ D,          // [B, nh, Tq]
                      bf16* __restrict__ dq,          // [B, Tq, nh, DK], rows lddq apart
                      int Tq, int Tk, int nh, int ldq, int ldk, int ldv, int ldo, int lddq) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int b = blockIdx.z, h = blockIdx.y, i0 = blockIdx.x * ROWS;
  const int nks = (Tk + 15) >> 4, nkt = (Tk + TR - 1) / TR;
  const int nq = min(ROWS, Tq - i0);
  bf16* q_s = reinterpret_cast<bf16*>(smem);  // [ROWS][DK]
  bf16* do_s = q_s + ROWS * DK;               // [ROWS][DV]
  const bf16* kb = k + (size_t)b * Tk * ldk + (size_t)h * DK;
  const bf16* vb = v + (size_t)b * Tk * ldv + (size_t)h * DV;
  // the stream: each key tile with its value tile ([TR][DK], then
  // [TR][DV]), twice
  auto fetch = [=](int e, unsigned char* dst) {
    const int t = e < nkt ? e : e - nkt, n = min(TR, Tk - t * TR);
    bf16* d = reinterpret_cast<bf16*>(dst);
    stage<DK>(d, kb + (size_t)t * TR * ldk, ldk, TR, n);
    stage<DV>(d + TR * DK, vb + (size_t)t * TR * ldv, ldv, TR, n);
  };
  auto kv = ring(smem + ROWS * (DK + DV) * 2, TR * (DK + DV) * 2, 2 * nkt, fetch);
  stage<DK>(q_s, q + ((size_t)b * Tq + i0) * ldq + (size_t)h * DK, ldq, ROWS, nq);
  stage<DV>(do_s, dctx + ((size_t)b * Tq + i0) * ldo + (size_t)h * DV, ldo, ROWS, nq);
  kv.start();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool active = i0 + warp * 16 < Tq;
  const int i_g = i0 + warp * 16 + (lane >> 2);
  const Scale sc = scale<DK>();
  const auto m = mask.at(b);
  const size_t st = ((size_t)b * nh + h) * Tq;
  float mx[2], sm[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = i_g + 8 * r;
    mx[r] = active && i < Tq ? row_max[st + i] : 0.f;
    sm[r] = active && i < Tq ? row_sum[st + i] : 1.f;
  }
  const float rl[2] = {__frcp_rn(sm[0]), __frcp_rn(sm[1])};
  // the warp's q and dctx A fragments held in registers, or (HOLD false:
  // wide heads, where they and dQ's accumulators would spill) read from the
  // staged rows at each step, in the same k order
  constexpr bool HOLD = DK + DV <= 256;
  uint32_t qa[HOLD ? DK / 16 : 1][4], da[HOLD ? DV / 16 : 1][4];

  // P and bf16(dP) of the key step at rows kk*16.. of a streamed tile
  auto p_dp = [&](const bf16* kv_t, int kk, int ks, float (&p)[2][4], float (&dp)[2][4]) {
    if constexpr (HOLD) {
      product<DK>(p, qa, kv_t, kk * 16, lane);
      product<DV>(dp, da, kv_t + TR * DK, kk * 16, lane);
    } else {
      product<DK>(p, q_s, warp * 16, kv_t, kk * 16, lane);
      product<DV>(dp, do_s, warp * 16, kv_t + TR * DK, kk * 16, lane);
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float s = score<DK>(p[nt][e], i_g + 8 * (e >> 1),
                              ks * 16 + nt * 8 + 2 * (lane & 3) + (e & 1), Tk, sc, m);
        p[nt][e] = div_row(expf(s - mx[e >> 1]), sm[e >> 1], rl[e >> 1]);
        dp[nt][e] = round_bf16(dp[nt][e]);
      }
  };

  float dsum[2] = {0.f, 0.f};
  for (int t = 0; t < nkt; ++t) {
    const bf16* kv_t = kv.next();
    if (!active) continue;
    if constexpr (HOLD) {
      if (t == 0) {
#pragma unroll
        for (int kd = 0; kd < DK / 16; ++kd) load_a<DK>(qa[kd], q_s, warp * 16, kd, lane);
#pragma unroll
        for (int kd = 0; kd < DV / 16; ++kd) load_a<DV>(da[kd], do_s, warp * 16, kd, lane);
      }
    }
    for (int kk = 0; kk < min(TR / 16, nks - TR / 16 * t); ++kk) {
      float p[2][4], dp[2][4];
      p_dp(kv_t, kk, TR / 16 * t + kk, p, dp);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) dsum[e >> 1] += dp[nt][e] * p[nt][e];
    }
  }
  dsum[0] = quad_sum(dsum[0]);
  dsum[1] = quad_sum(dsum[1]);

  float acc[DK / 8][4];
#pragma unroll
  for (int nd = 0; nd < DK / 8; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nd][e] = 0.f;
  for (int t = 0; t < nkt; ++t) {
    const bf16* kv_t = kv.next();
    if (!active) continue;
    for (int kk = 0; kk < min(TR / 16, nks - TR / 16 * t); ++kk) {
      float p[2][4], dp[2][4];
      p_dp(kv_t, kk, TR / 16 * t + kk, p, dp);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          p[nt][e] = unscale<DK>(p[nt][e] * (dp[nt][e] - dsum[e >> 1]), sc);
      uint32_t dsa[4];
      c_to_a(dsa, p);
      accumulate<DK>(acc, dsa, kv_t, kk * 16, lane);
    }
  }
  if (!active) return;

  const int t2 = 2 * (lane & 3);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = i_g + 8 * r;
    if (i >= Tq) continue;
    bf16* out = dq + ((size_t)b * Tq + i) * lddq + (size_t)h * DK + t2;
#pragma unroll
    for (int nd = 0; nd < DK / 8; ++nd)
      *reinterpret_cast<uint32_t*>(out + nd * 8) = pack_bf16(acc[nd][2 * r], acc[nd][2 * r + 1]);
    if ((lane & 3) == 0) D[st + i] = dsum[r];
  }
}

// Launch 2: dK and dV for one (b, h, 64 keys), summed over every query;
// with NSPLIT > 1, one column slice of each (DK / NSPLIT of dK, DV / NSPLIT
// of dV) per block: every slice forms the same P and dsc over the full
// widths (staged, not held), only the accumulators are split.
template <int DK, int DV, typename Mask, int NSPLIT, int TR>
__global__ void __launch_bounds__(THREADS)
attn_mma_stream_bwd_kv(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, Mask mask,
                       const float* __restrict__ row_max, const float* __restrict__ row_sum,
                       const float* __restrict__ D, const bf16* __restrict__ dctx,
                       bf16* __restrict__ dk,  // [B, Tk, nh, DK], rows lddk apart
                       bf16* __restrict__ dv,  // [B, Tk, nh, DV], rows lddv apart
                       int Tq, int Tk, int nh, int ldq, int ldk, int ldv, int ldo,
                       int lddk, int lddv) {
  constexpr int DKP = DK / NSPLIT, DVP = DV / NSPLIT;
  extern __shared__ __align__(128) unsigned char smem[];
  const int b = blockIdx.z, h = blockIdx.y / NSPLIT, part = blockIdx.y % NSPLIT;
  const int j0 = blockIdx.x * ROWS;
  const int nqs = (Tq + 15) >> 4, nqt = (Tq + TR - 1) / TR;
  const int nk = min(ROWS, Tk - j0);
  bf16* k_s = reinterpret_cast<bf16*>(smem);  // [ROWS][DK]
  bf16* v_s = k_s + ROWS * DK;                // [ROWS][DV]
  const bf16* qb = q + (size_t)b * Tq * ldq + (size_t)h * DK;
  const bf16* ob = dctx + (size_t)b * Tq * ldo + (size_t)h * DV;
  const size_t st = ((size_t)b * nh + h) * Tq;
  // the stream: each query tile [TR][DK] with its dctx tile [TR][DV] and
  // its rows' max, sum and D (fp32 [3][TR]; zero past Tq)
  auto fetch = [=](int t, unsigned char* dst) {
    const int n = min(TR, Tq - t * TR);
    bf16* d = reinterpret_cast<bf16*>(dst);
    stage<DK>(d, qb + (size_t)t * TR * ldq, ldq, TR, n);
    stage<DV>(d + TR * DK, ob + (size_t)t * TR * ldo, ldo, TR, n);
    float* stats = reinterpret_cast<float*>(d + TR * (DK + DV));
    for (int c = threadIdx.x; c < 3 * TR; c += THREADS) {
      const int a = c / TR, r = c % TR;
      const float* src = (a == 0 ? row_max : a == 1 ? row_sum : D) + st + t * TR;
      cp_async4(stats + c, r < n ? src + r : src, r < n);
    }
  };
  auto qo = ring(smem + ROWS * (DK + DV) * 2, TR * (DK + DV) * 2 + 3 * TR * 4, nqt, fetch);
  stage<DK>(k_s, k + ((size_t)b * Tk + j0) * ldk + (size_t)h * DK, ldk, ROWS, nk);
  stage<DV>(v_s, v + ((size_t)b * Tk + j0) * ldv + (size_t)h * DV, ldv, ROWS, nk);
  qo.start();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool active = j0 + warp * 16 < Tk;
  const Scale sc = scale<DK>();
  const auto m = mask.at(b);
  const int g = lane >> 2, t2 = 2 * (lane & 3);
  float dk_acc[DKP / 8][4], dv_acc[DVP / 8][4];
#pragma unroll
  for (int nd = 0; nd < DKP / 8; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[nd][e] = 0.f;
#pragma unroll
  for (int nd = 0; nd < DVP / 8; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) dv_acc[nd][e] = 0.f;

  for (int t = 0; t < nqt; ++t) {
    const bf16* q_t = qo.next();
    if (!active) continue;
    const bf16* do_t = q_t + TR * DK;
    const float* stats = reinterpret_cast<const float*>(do_t + TR * DV);
    for (int qq = 0; qq < min(TR / 16, nqs - TR / 16 * t); ++qq) {
      float p[2][4], dp[2][4];
      product<DK>(p, q_t, qq * 16, k_s, warp * 16, lane);
      product<DV>(dp, do_t, qq * 16, v_s, warp * 16, lane);
      float mx[2], sm[2], rl[2], d[2];
      bool valid[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int lr = qq * 16 + g + 8 * r;
        valid[r] = t * TR + lr < Tq;
        mx[r] = stats[lr];
        sm[r] = stats[TR + lr];
        d[r] = stats[2 * TR + lr];
        rl[r] = __frcp_rn(sm[r]);
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const float s = score<DK>(p[nt][e], t * TR + qq * 16 + g + 8 * r,
                                j0 + warp * 16 + nt * 8 + t2 + (e & 1), Tk, sc, m);
          // padded queries (zero q and dctx rows, zero statistics) add nothing
          p[nt][e] = valid[r] ? div_row(expf(s - mx[r]), sm[r], rl[r]) : 0.f;
          // dsc before rounding
          dp[nt][e] = unscale<DK>(p[nt][e] * (round_bf16(dp[nt][e]) - d[r]), sc);
        }
      uint32_t pa[4], dsa[4];
      c_to_a_trans(pa, p);
      c_to_a_trans(dsa, dp);
      accumulate<DV, DVP>(dv_acc, pa, do_t, qq * 16, lane, part * DVP);
      accumulate<DK, DKP>(dk_acc, dsa, q_t, qq * 16, lane, part * DKP);
    }
  }
  if (!active) return;

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int j = j0 + warp * 16 + g + 8 * r;
    if (j >= Tk) continue;
    bf16* odk = dk + ((size_t)b * Tk + j) * lddk + (size_t)h * DK + part * DKP + t2;
    bf16* odv = dv + ((size_t)b * Tk + j) * lddv + (size_t)h * DV + part * DVP + t2;
#pragma unroll
    for (int nd = 0; nd < DKP / 8; ++nd)
      *reinterpret_cast<uint32_t*>(odk + nd * 8) =
          pack_bf16(dk_acc[nd][2 * r], dk_acc[nd][2 * r + 1]);
#pragma unroll
    for (int nd = 0; nd < DVP / 8; ++nd)
      *reinterpret_cast<uint32_t*>(odv + nd * 8) =
          pack_bf16(dv_acc[nd][2 * r], dv_acc[nd][2 * r + 1]);
  }
}

// launchers

template <int DK, int DVP>
constexpr size_t stream_fwd_smem() {
  return (size_t)ROWS * (DK + 2 * (DK > DVP ? DK : DVP)) * 2;
}
template <int DK, int DV, int TR>
constexpr size_t stream_bwd_q_smem() {
  return (size_t)(ROWS + 2 * TR) * (DK + DV) * 2;
}
template <int DK, int DV, int TR>
constexpr size_t stream_bwd_kv_smem() {
  return (size_t)ROWS * (DK + DV) * 2 + 2 * ((size_t)TR * (DK + DV) * 2 + 3 * TR * 4);
}

// The forward over q, k, v rows ld* elements apart and ctx rows ldc apart
// (multiples of 8: the 16-byte copies); the operands 16-byte aligned.  P
// (fp32 [B, nh, Tq, Tk]) and the statistics are written where not null.
// HELD: the 16-key steps whose scores the one-pass forward holds; NSPLIT:
// the column slices of ctx, one block each (a slice's DV / NSPLIT values
// are what a thread accumulates).
template <int DK, int DV, int HELD, typename Mask, int NSPLIT = 1>
cudaError_t launch_stream_fwd(const void* q, const void* k, const void* v, Mask mask, float* P,
                       float* row_max, float* row_sum, void* ctx, int B, int Tq, int Tk, int nh,
                       int ldq, int ldk, int ldv, int ldc, cudaStream_t stream) {
  static_assert(DV % (16 * NSPLIT) == 0, "a column slice is whole 16-column steps");
  if (Tq < 1 || Tk < 1 || ldq % 8 || ldk % 8 || ldv % 8 || ldc % 2 ||
      (row_max == nullptr) != (row_sum == nullptr))
    return cudaErrorInvalidValue;
  constexpr size_t smem = stream_fwd_smem<DK, DV / NSPLIT>();
  const auto kernel = (Tk + 15) / 16 <= HELD
                          ? attn_mma_stream_fwd<DK, DV, HELD, Mask, true, NSPLIT>
                          : attn_mma_stream_fwd<DK, DV, HELD, Mask, false, NSPLIT>;
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  kernel<<<dim3((Tq + ROWS - 1) / ROWS, nh * NSPLIT, B), THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v), mask,
      P, row_max, row_sum, static_cast<bf16*>(ctx), Tq, Tk, nh, ldq, ldk, ldv, ldc);
  return cudaGetLastError();
}

// The backward from the forward's operands and row statistics: D is an fp32
// [B, nh, Tq] scratch; dq, dk, dv rows are written ldd* elements apart.
// NSPLIT: the column slices of dK and dV, one launch-2 block each; TR: the
// rows of the tiles the streamed operands pass in (64, or 32 where two
// blocks of wide heads would not fit an SM's shared memory otherwise).
template <int DK, int DV, typename Mask, int NSPLIT = 1, int TR = ROWS>
cudaError_t launch_stream_bwd(const void* q, const void* k, const void* v, Mask mask,
                       const float* row_max, const float* row_sum, const void* dctx, float* D,
                       void* dq, void* dk, void* dv, int B, int Tq, int Tk, int nh, int ldq,
                       int ldk, int ldv, int ldo, int lddq, int lddk, int lddv,
                       cudaStream_t stream) {
  if (Tq < 1 || Tk < 1 || ldq % 8 || ldk % 8 || ldv % 8 || ldo % 8 || lddq % 2 || lddk % 2 ||
      lddv % 2)
    return cudaErrorInvalidValue;
  static_assert(TR % 16 == 0 && ROWS % TR == 0, "a stream tile is whole 16-row steps");
  constexpr size_t smem_q = stream_bwd_q_smem<DK, DV, TR>();
  constexpr size_t smem_kv = stream_bwd_kv_smem<DK, DV, TR>();
  const auto kernel_q = attn_mma_stream_bwd_q<DK, DV, Mask, TR>;
  const auto kernel_kv = attn_mma_stream_bwd_kv<DK, DV, Mask, NSPLIT, TR>;
  cudaError_t e = allow_smem(kernel_q, smem_q);
  if (e != cudaSuccess) return e;
  e = allow_smem(kernel_kv, smem_kv);
  if (e != cudaSuccess) return e;
  const bf16 *qb = static_cast<const bf16*>(q), *kb = static_cast<const bf16*>(k),
             *vb = static_cast<const bf16*>(v), *dob = static_cast<const bf16*>(dctx);
  kernel_q<<<dim3((Tq + ROWS - 1) / ROWS, nh, B), THREADS, smem_q, stream>>>(
      qb, kb, vb, mask, row_max, row_sum, dob, D, static_cast<bf16*>(dq), Tq, Tk, nh, ldq, ldk,
      ldv, ldo, lddq);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  kernel_kv<<<dim3((Tk + ROWS - 1) / ROWS, nh * NSPLIT, B), THREADS, smem_kv, stream>>>(
      qb, kb, vb, mask, row_max, row_sum, D, dob, static_cast<bf16*>(dk), static_cast<bf16*>(dv),
      Tq, Tk, nh, ldq, ldk, ldv, ldo, lddk, lddv);
  return cudaGetLastError();
}

// ---- fragments of pitched tiles (rows P elements apart) --------------------
// K5's cross kernels (decoder_cross_attention.cuh) and K6's grouped read
// (decode_attention.cu) stage rows padded by 16 bytes instead of swizzled.
namespace pitched {

// A: rows r0..r0+15 (m) by columns c0..c0+15 (k)
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* t, int P, int r0, int c0,
                                       int lane) {
  ldsm_x4(a, t + (size_t)(r0 + (lane & 15)) * P + c0 + ((lane >> 4) << 3));
}
// A as the transpose of the tile: m along columns c0..c0+15, k along rows
// r0..r0+15
__device__ __forceinline__ void load_at(uint32_t (&a)[4], const bf16* t, int P, int r0, int c0,
                                        int lane) {
  ldsm_x4_trans(
      a, t + (size_t)(r0 + (lane & 7) + ((lane >> 4) << 3)) * P + c0 + (((lane >> 3) & 1) << 3));
}
// B of two n-tiles, n along rows n0..n0+15, k along columns c0..c0+15
__device__ __forceinline__ void load_b(uint32_t (&b)[4], const bf16* t, int P, int n0, int c0,
                                       int lane) {
  ldsm_x4(
      b, t + (size_t)(n0 + (lane & 7) + ((lane >> 4) << 3)) * P + c0 + (((lane >> 3) & 1) << 3));
}
// B of two n-tiles, k along rows k0..k0+15, n along columns c0..c0+15
__device__ __forceinline__ void load_bt(uint32_t (&b)[4], const bf16* t, int P, int k0, int c0,
                                        int lane) {
  ldsm_x4_trans(
      b, t + (size_t)(k0 + (lane & 7) + (((lane >> 3) & 1) << 3)) * P + c0 + ((lane >> 4) << 3));
}

}  // namespace pitched

}  // namespace mma_attn
}  // namespace

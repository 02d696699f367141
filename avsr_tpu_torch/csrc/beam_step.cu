// K7: one step of width-W beam search, fused: the body of
// avsr_tpu/decode/beam.py:beam_search's loop (beam.py:142-195) after the
// decoder step, for one batch row per block:
//
//   1. step_logp = log_softmax(logits) in fp32, (x - max) - log(sum exp);
//   2. PAD and GO set to NEG_INF = -1e30 after the softmax;
//   3. a finished beam continues with the EOS-only row (0 at EOS, NEG_INF
//      elsewhere);
//   4. cand_logp = logp[w] + step_logp[v], cand_len = lens[w] + !finished[w];
//   5. score = cand_logp / lp[cand_len], lp the length-penalty table
//      ((5 + len) / 6)^alpha (all ones for alpha = 0) that the caller
//      computes once with torch, so both paths divide by the same values;
//   6. the top W of the W*V candidates by score, ties to the LOWER flat
//      index (lax.top_k's order, and the stable descending sort's);
//   7. parent = flat / V, token = flat % V; logp, lens and finished gathered
//      by parent; finished |= token == EOS; the next feed is EOS where the
//      parent had finished, else the token.
//
// The token and parent rows are written straight into row t of the
// (token, parent) trellis; the flat parent index b * W + parent is written
// for the caller's gather of the KV caches (which stays a torch
// index_select, as does the host-side early exit).
//
// What bounds it on an H100: nothing the card does; the step reads
// B * W * V * 4 bytes of logits (14 KB at B = 8, W = 10, V = 44) and is set
// by launch latency.  It replaces ~25 host-launched PyTorch ops per step
// with one launch.  Design: one block of 256 threads per batch row; a warp
// per beam for the log-softmax (lanes over the vocabulary, shuffle
// reductions); the candidates' scores and log probs in shared memory; W
// rounds of a block argmax over (score desc, index asc), each round
// retiring its winner (scores are finite, so -inf marks a taken slot);
// then one thread per beam gathers and writes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr float NEG_INF = -1.0e30f;
constexpr int PAD_ID = 0, GO_ID = 1, EOS_ID = 2;

// (val, idx) beats (ov, oi): larger score, or equal score and lower index
__device__ __forceinline__ bool beats(float val, int idx, float ov, int oi) {
  return val > ov || (val == ov && idx < oi);
}

__global__ void __launch_bounds__(THREADS)
beam_step_kernel(const float* __restrict__ logits,     // [B*W, V]
                 const float* __restrict__ logp,       // [B, W]
                 const int* __restrict__ lens,         // [B, W]
                 const uint8_t* __restrict__ finished, // [B, W] (bool)
                 const float* __restrict__ lp_table,   // [n_lp]
                 int64_t* __restrict__ token,          // [B, W] = trellis row t
                 int64_t* __restrict__ parent,         // [B, W] = trellis row t
                 int64_t* __restrict__ flat_parent,    // [B*W]
                 int64_t* __restrict__ feed,           // [B, W]
                 float* __restrict__ logp_out,         // [B, W]
                 int* __restrict__ lens_out,           // [B, W]
                 uint8_t* __restrict__ finished_out,   // [B, W]
                 int W, int V, int n_lp) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x;
  const int nc = W * V;
  float* score_s = reinterpret_cast<float*>(smem);  // [W*V]
  float* clogp_s = score_s + nc;                     // [W*V]
  float* red_v = clogp_s + nc;                       // [WARPS]
  int* red_i = reinterpret_cast<int*>(red_v + WARPS);  // [WARPS]
  int* sel_s = red_i + WARPS;                        // [W]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  // 1-5: a warp per beam
  for (int w = warp; w < W; w += WARPS) {
    const int r = b * W + w;
    const float* row = logits + (size_t)r * V;
    const bool fin = finished[r] != 0;
    const float lp0 = logp[r];
    int cl = lens[r] + (fin ? 0 : 1);
    cl = cl < n_lp ? cl : n_lp - 1;
    const float pen = lp_table[cl];
    float mx = __int_as_float(0xff800000u), lse = 0.f;
    if (!fin) {
      for (int v = lane; v < V; v += 32) mx = fmaxf(mx, row[v]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      float sum = 0.f;
      for (int v = lane; v < V; v += 32) sum += expf(row[v] - mx);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      lse = logf(sum);
    }
    for (int v = lane; v < V; v += 32) {
      float step;
      if (fin) step = v == EOS_ID ? 0.f : NEG_INF;
      else step = (v == PAD_ID || v == GO_ID) ? NEG_INF : (row[v] - mx) - lse;
      const float c = lp0 + step;
      clogp_s[w * V + v] = c;
      score_s[w * V + v] = c / pen;
    }
  }
  __syncthreads();

  // 6: W rounds of a block argmax; the winner's slot is retired with -inf
  for (int rnd = 0; rnd < W; ++rnd) {
    float bv = __int_as_float(0xff800000u);
    int bi = 0x7fffffff;
    for (int c = threadIdx.x; c < nc; c += THREADS)
      if (beats(score_s[c], c, bv, bi)) { bv = score_s[c]; bi = c; }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, bv, o);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
      if (beats(ov, oi, bv, bi)) { bv = ov; bi = oi; }
    }
    if (lane == 0) { red_v[warp] = bv; red_i[warp] = bi; }
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int w = 1; w < WARPS; ++w)
        if (beats(red_v[w], red_i[w], bv, bi)) { bv = red_v[w]; bi = red_i[w]; }
      sel_s[rnd] = bi;
      score_s[bi] = __int_as_float(0xff800000u);
    }
    __syncthreads();
  }

  // 7: gather by parent, one thread per new beam
  if (threadIdx.x < W) {
    const int w = threadIdx.x, r = b * W + w;
    const int flat = sel_s[w];
    const int p = flat / V, tk = flat - p * V;
    const int pr = b * W + p;
    const bool was_fin = finished[pr] != 0;
    token[r] = tk;
    parent[r] = p;
    flat_parent[r] = pr;
    feed[r] = was_fin ? EOS_ID : tk;
    logp_out[r] = clogp_s[flat];
    lens_out[r] = lens[pr] + (was_fin ? 0 : 1);
    finished_out[r] = (was_fin || tk == EOS_ID) ? 1 : 0;
  }
}

}  // namespace

extern "C" int avsr_beam_step(const void* logits, const void* logp, const void* lens,
                              const void* finished, const void* lp_table, void* token,
                              void* parent, void* flat_parent, void* feed, void* logp_out,
                              void* lens_out, void* finished_out, int B, int W, int V, int n_lp,
                              void* stream) {
  if (B < 1 || W < 1 || V <= EOS_ID || n_lp < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)2 * W * V * sizeof(float) + (size_t)2 * WARPS * 4 + (size_t)W * 4;
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  beam_step_kernel<<<B, THREADS, smem, reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(logits), static_cast<const float*>(logp),
      static_cast<const int*>(lens), static_cast<const uint8_t*>(finished),
      static_cast<const float*>(lp_table), static_cast<int64_t*>(token),
      static_cast<int64_t*>(parent), static_cast<int64_t*>(flat_parent),
      static_cast<int64_t*>(feed), static_cast<float*>(logp_out), static_cast<int*>(lens_out),
      static_cast<uint8_t*>(finished_out), W, V, n_lp);
  return (int)cudaGetLastError();
}

// K7: one step of width-W beam search, fused: the body of
// avsr_tpu/decode/beam.py:beam_search's loop (beam.py:142-195) after the
// decoder step, and the loop's condition on the new carry (beam.py:130-140),
// one batch row per block:
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
//      parent had finished, else the token;
//   8. settled[b]: every new beam of the row finished or dead (logp <
//      NEG_INF / 2), the loop's condition, so the caller's host check reads
//      one [B] flag tensor.
//
// The token and parent rows are written straight into row t of the
// (token, parent) trellis; the flat parent index b * W + parent is written
// for the caller's gather of the decoder state (a torch index_select).
//
// What bounds it on an H100: nothing the card does; the step reads
// B * W * V * 4 bytes of logits (14 KB at B = 8, W = 10, V = 44): launch
// latency and the chain of dependent steps inside one block.  Design:
//
// - A candidate is one 64-bit key: the order-preserving bits of its score
//   in the high word, the complement of its flat index in the low word.
//   Keys are distinct, a larger key is a better candidate, and equal scores
//   order by the lower flat index with no second compare.
// - A warp per beam: the logits row read once (into shared memory), max,
//   sum and log as shuffle reductions, the W*V candidates' keys and log
//   probs in shared memory.
// - Two levels of top W.  The global top W lies in the union of each beam's
//   own top K = min(W, V), so each warp first ranks its beam's candidates
//   and keeps its best K, best first: by counting (each key's rank is the
//   number of keys above it, V reads a key) where ceil(V / 32) * V <= 64 K,
//   else by K rounds of a warp max under the previous round's key
//   (``kernels.beam_step_level1`` picks, the caller passes it).  After ONE
//   block barrier every thread takes candidates of the union and counts the
//   union's keys above each (16-byte broadcast loads, no dependent chain: a
//   binary search of each list measured 5,000 cycles of 10,800 at W = 10);
//   a candidate whose count is below W is new beam number count, and its
//   thread gathers and writes that beam.  A second barrier
//   (__syncthreads_and) forms the settled flag.
//
// The old design (W rounds of a block argmax, 2W block barriers, the logits
// read three times from global memory) is gone.
//
// Also here: an empty kernel, launched by ``kernels.launch_floor``, whose
// device time is the floor of one launch on the card.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_WARPS = 16;
constexpr float NEG_INF = -1.0e30f;
constexpr int PAD_ID = 0, GO_ID = 1, EOS_ID = 2;
constexpr size_t SMEM_LIMIT = 232448;  // bytes of shared memory one block may use

typedef unsigned long long u64;

}  // namespace

// One carry [B, W] and the step outputs written with it.  Mirrored by
// kernels._BeamCarry (ctypes): pointer fields only.
struct BeamCarry {
  float* logp;           // [B, W]
  int* lens;             // [B, W]
  uint8_t* finished;     // [B, W] (bool)
  int64_t* flat_parent;  // [B * W]
  int64_t* feed;         // [B, W]
  uint8_t* settled;      // [B] (bool)
};

// Mirrored by kernels._BeamStepArgs: 8-byte fields only, no padding.
struct BeamStepArgs {
  BeamCarry carry[2];       // a step reads carry[src] and writes carry[src ^ 1]
  const float* lp_table;    // [n_lp]
  int64_t* tokens;          // [L, B, W] trellis: row t at tokens + t * B * W
  int64_t* parents;         // [L, B, W]
  long long B, W, V, n_lp;
  long long count_level1;   // 1: rank each beam's candidates by counting; 0: rounds
};

namespace {

__device__ __forceinline__ u64 make_key(float s, int flat) {
  unsigned u = __float_as_uint(s);
  if (u == 0x80000000u) u = 0u;  // -0 ranks with +0, as the compare does
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ((u64)u << 32) | (u64)(~(unsigned)flat);
}

__device__ __forceinline__ int key_flat(u64 k) { return (int)~(unsigned)k; }

__device__ __forceinline__ int above(const ulonglong2& x, u64 k) {
  return (x.x > k ? 1 : 0) + (x.y > k ? 1 : 0);
}

// keys of ``keys`` (n, a multiple of two, 16-byte aligned) above k0 and k1:
// 16-byte broadcast loads, four in flight, no dependence between them
__device__ __forceinline__ void count_above(const u64* keys, int n, u64 k0, u64 k1, int& r0,
                                            int& r1) {
  const ulonglong2* k2 = reinterpret_cast<const ulonglong2*>(keys);
  const int n2 = n / 2;
  int a0 = 0, a1 = 0, b0 = 0, b1 = 0;
  int i = 0;
  for (; i + 4 <= n2; i += 4) {
    const ulonglong2 x = k2[i], y = k2[i + 1], z = k2[i + 2], w = k2[i + 3];
    a0 += above(x, k0) + above(y, k0);
    b0 += above(z, k0) + above(w, k0);
    a1 += above(x, k1) + above(y, k1);
    b1 += above(z, k1) + above(w, k1);
  }
  for (; i < n2; ++i) {
    const ulonglong2 x = k2[i];
    a0 += above(x, k0);
    a1 += above(x, k1);
  }
  r0 = a0 + b0;
  r1 = a1 + b1;
}

__host__ __device__ __forceinline__ long long even(long long n) { return n + (n & 1); }

__global__ void __launch_bounds__(MAX_WARPS * 32)
beam_step_kernel(const BeamStepArgs a, const float* __restrict__ logits, int t, int src) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int W = (int)a.W, V = (int)a.V, n_lp = (int)a.n_lp;
  const int K = W < V ? W : V;
  const int Vp = (int)even(V), nt = (int)even((long long)W * K);
  const int b = blockIdx.x;
  // rows of even length, so that every row starts 16-byte aligned; the pad
  // keys are 0, below every real key
  u64* top_s = reinterpret_cast<u64*>(smem);  // [nt] each beam's best K, best first
  u64* key_s = top_s + nt;                     // [W][Vp] every candidate's key
  float* clogp_s = reinterpret_cast<float*>(key_s + (size_t)W * Vp);  // [W][Vp] log probs
  float* topc_s = clogp_s + (size_t)W * Vp;    // [W*K] the log probs of top_s
  const BeamCarry in = a.carry[src];
  const BeamCarry out = a.carry[src ^ 1];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  if (threadIdx.x == 0 && nt > W * K) top_s[W * K] = 0ull;

  // 1-5 and the first level: a warp per beam
  for (int w = warp; w < W; w += nwarps) {
    const int r = b * W + w;
    float* cw = clogp_s + w * Vp;
    u64* kw = key_s + w * Vp;
    // the row is read whether or not the beam finished (a finished beam
    // takes the EOS-only row), so its loads go out with the state's
    const float* row = logits + (size_t)r * V;
#pragma unroll 4
    for (int v = lane; v < V; v += 32) cw[v] = __ldg(row + v);
    const bool fin = in.finished[r] != 0;
    const float lp0 = in.logp[r];
    int cl = in.lens[r] + (fin ? 0 : 1);
    cl = cl < n_lp ? cl : n_lp - 1;
    const float pen = a.lp_table[cl];
    float mx = __int_as_float(0xff800000u), lse = 0.f;
    if (!fin) {
      for (int v = lane; v < V; v += 32) mx = fmaxf(mx, cw[v]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      float sum = 0.f;
      for (int v = lane; v < V; v += 32) sum += expf(cw[v] - mx);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      lse = logf(sum);
    }
    for (int v = lane; v < V; v += 32) {
      float step;
      if (fin) step = v == EOS_ID ? 0.f : NEG_INF;
      else step = (v == PAD_ID || v == GO_ID) ? NEG_INF : (cw[v] - mx) - lse;
      const float c = lp0 + step;
      cw[v] = c;
      kw[v] = make_key(c / pen, w * V + v);
    }
    if (lane == 0 && Vp > V) kw[V] = 0ull;
    __syncwarp();
    u64* tw = top_s + w * K;
    float* tcw = topc_s + w * K;
    if (a.count_level1) {  // each key's rank among its beam's: two keys a lane at once
      for (int v = lane; v < V; v += 64) {
        const bool two = v + 32 < V;
        const u64 k0 = kw[v], k1 = two ? kw[v + 32] : ~0ull;
        int r0, r1;
        count_above(kw, Vp, k0, k1, r0, r1);
        if (r0 < K) {
          tw[r0] = k0;
          tcw[r0] = cw[v];
        }
        if (two && r1 < K) {
          tw[r1] = k1;
          tcw[r1] = cw[v + 32];
        }
      }
    } else {
      u64 thr = ~0ull;
      for (int i = 0; i < K; ++i) {
        u64 best = 0ull;  // below every key of a finite or infinite score
        for (int v = lane; v < V; v += 32) {
          const u64 k = kw[v];
          if (k < thr && k > best) best = k;
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
          const u64 other = __shfl_xor_sync(0xffffffffu, best, o);
          best = other > best ? other : best;
        }
        if (lane == 0) {
          tw[i] = best;
          tcw[i] = cw[key_flat(best) - w * V];
        }
        thr = best;
      }
    }
  }
  __syncthreads();

  // second level: each candidate of the union counts the keys of the union
  // above it; a count below W is its new beam's number, and its thread
  // writes that beam
  bool settled = true;
  int64_t* tok_row = a.tokens + (size_t)t * a.B * W;
  int64_t* par_row = a.parents + (size_t)t * a.B * W;
  for (int c = threadIdx.x; c < W * K; c += blockDim.x) {
    const u64 k = top_s[c];
    int rank, unused;
    count_above(top_s, nt, k, k, rank, unused);
    if (rank < W) {
      const int flat = key_flat(k);
      const int p = flat / V, tk = flat - p * V;
      const int r = b * W + rank, pr = b * W + p;
      const bool was_fin = in.finished[pr] != 0;
      const bool fin = was_fin || tk == EOS_ID;
      const float lg = topc_s[c];
      tok_row[r] = tk;
      par_row[r] = p;
      out.flat_parent[r] = pr;
      out.feed[r] = was_fin ? EOS_ID : tk;
      out.logp[r] = lg;
      out.lens[r] = in.lens[pr] + (was_fin ? 0 : 1);
      out.finished[r] = fin ? 1 : 0;
      settled = settled && (fin || lg < NEG_INF * 0.5f);
    }
  }
  settled = __syncthreads_and(settled) != 0;
  if (threadIdx.x == 0) out.settled[b] = settled ? 1 : 0;
}

__global__ void empty_kernel() {}

size_t step_smem(long long W, long long V) {
  const long long K = W < V ? W : V;
  return (size_t)(even(W * K) + W * even(V)) * sizeof(u64) +
         (size_t)(W * even(V) + W * K) * sizeof(float);
}

}  // namespace

extern "C" long long avsr_beam_step_smem(int W, int V) { return (long long)step_smem(W, V); }

// One step: reads a->carry[src] and logits [B*W, V] f32, writes
// a->carry[src ^ 1] and row t of the trellis.
extern "C" int avsr_beam_step(const BeamStepArgs* a, const void* logits, int t, int src,
                              void* stream) {
  if (a->B < 1 || a->W < 1 || a->V <= EOS_ID || a->n_lp < 1 || (src & ~1))
    return (int)cudaErrorInvalidValue;
  const size_t smem = step_smem(a->W, a->V);
  if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        (const void*)beam_step_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int warps = a->W < MAX_WARPS ? (int)a->W : MAX_WARPS;
  beam_step_kernel<<<(unsigned)a->B, warps * 32, smem, reinterpret_cast<cudaStream_t>(stream)>>>(
      *a, static_cast<const float*>(logits), t, src);
  return (int)cudaGetLastError();
}

extern "C" int avsr_launch_floor(void* stream) {
  empty_kernel<<<1, 32, 0, reinterpret_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}

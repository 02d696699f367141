"""K7's two-level top W (``csrc/beam_step.cu``), mirrored on the CPU.

The kernel turns each candidate's score into a 64-bit key (the score's
order-preserving bits, then the complement of its flat index), keeps each
beam's best K = min(W, V) keys, best first (by counting, or by K rounds of
a max under the previous round's key: ``kernels.beam_step_level1``), and
ranks each kept key by counting the kept keys above it; a rank below W is
a new beam's number.  The mirror below does the same in
numpy on the plain twin's scores, so its picks must equal
``beam_step_plain``'s exactly (parents, tokens, the gathered state, the
settled flags), over random, dead-beam, finished-beam and all-tied states
and a grid of (W, V) up to the wrapper's limit.  The settled flags are also
held against the JAX loop condition on the new carry.  Every (W, V) the
first K7 wrapper took must still be admitted.
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avsr_tpu_torch import kernels
from avsr_tpu_torch.data.units import EOS_ID, GO_ID, PAD_ID
from avsr_tpu_torch.decode import beam

NEG_INF = -1.0e30
# (W, V): the presets' beams over their vocabularies, one beam, 32 beams,
# V below W, and the wrapper's largest W * V (6128) at one and ten beams
GRID = [(10, 44), (10, 31), (1, 44), (32, 44), (4, 3), (16, 5), (3, 9), (100, 61),
        (1, 6128), (10, 612), (2042, 3)]
CASES = ["random", "dead", "finished", "ties"]


def keys_of(scores: np.ndarray) -> np.ndarray:
    """[..., n] fp32 scores -> uint64 keys over the flat index of the last
    axis (``make_key``): larger is better, ties to the lower index."""
    u = scores.astype(np.float32).view(np.uint32).copy()
    u[u == 0x80000000] = 0  # -0 ranks with +0
    neg = (u & 0x80000000) != 0
    u = np.where(neg, ~u, u | np.uint32(0x80000000)).astype(np.uint64)
    flat = np.arange(scores.shape[-1], dtype=np.uint64)
    return (u << np.uint64(32)) | (~flat & np.uint64(0xFFFFFFFF))


def level1_count(kw: np.ndarray, K: int) -> np.ndarray:
    """[V] keys of one beam -> its best K, best first, by counting."""
    rank = (kw[None, :] > kw[:, None]).sum(axis=1)
    top = np.zeros(K, np.uint64)
    keep = rank < K
    top[rank[keep]] = kw[keep]
    return top


def level1_rounds(kw: np.ndarray, K: int) -> np.ndarray:
    """The same by K rounds of a max under the previous round's key."""
    thr = np.uint64(0xFFFFFFFFFFFFFFFF)
    top = np.zeros(K, np.uint64)
    for i in range(K):
        below = kw[kw < thr]
        top[i] = thr = below.max()
    return top


def count_above(lists: np.ndarray, k: np.ndarray) -> np.ndarray:
    """The kept keys above each k (the kernel's second level): lists [W, K]
    of every beam's best, k [n] -> [n]."""
    return (lists.reshape(1, -1) > k[:, None]).sum(axis=1)


def mirror_step(logits, logp, lens, finished, lp_table):
    """The kernel's selection on the plain twin's scores: (token, parent,
    flat index) [B, W] of the new beams."""
    B, W = logp.shape
    V = logits.shape[-1]
    step = torch.log_softmax(logits, dim=-1)
    step[:, PAD_ID] = NEG_INF
    step[:, GO_ID] = NEG_INF
    eos_only = torch.full((V,), NEG_INF)
    eos_only[EOS_ID] = 0.0
    step = torch.where(finished[:, :, None], eos_only, step.reshape(B, W, V))
    cand = logp[:, :, None] + step
    cl = (lens + (~finished).int()).clamp(max=lp_table.shape[0] - 1)
    scores = (cand / lp_table[cl.long()][:, :, None]).reshape(B, W * V).numpy()
    K = min(W, V)
    level1 = level1_count if kernels.beam_step_level1(W, V) == "count" else level1_rounds
    flat = np.zeros((B, W), np.int64)
    for b in range(B):
        keys = keys_of(scores[b]).reshape(W, V)
        lists = np.stack([level1(keys[w], K) for w in range(W)])
        np.testing.assert_array_equal(  # both ways of level 1 keep the same list
            lists, np.stack([(level1_rounds if level1 is level1_count else level1_count)(
                keys[w], K) for w in range(W)]))
        cands = lists.reshape(-1)
        rank = np.concatenate([count_above(lists, cands[i:i + 512])
                               for i in range(0, cands.size, 512)])
        win = rank < W
        assert sorted(rank[win].tolist()) == list(range(W))  # every new beam once
        flat[b, rank[win]] = (~cands[win] & np.uint64(0xFFFFFFFF)).astype(np.int64)
    return flat % V, flat // V, flat


def step_inputs(B, W, V, case, seed):
    rng = np.random.default_rng(seed)
    logits = (3 * rng.standard_normal((B * W, V))).astype(np.float32)
    logp = (-20 * rng.uniform(size=(B, W))).astype(np.float32)
    lens = rng.integers(0, 60, (B, W)).astype(np.int32)
    finished = rng.uniform(size=(B, W)) < 0.3
    if case == "dead":  # only beam 0 live, as at the first step
        logp[:, 1:] = NEG_INF
        finished[:] = False
    elif case == "finished":
        finished[:, : max(1, W // 2)] = True
    elif case == "ties":  # one uniform row and score everywhere
        logits[:] = 0.0
        logp[:] = 0.0
        lens[:] = 0
        finished[:] = False
    return [torch.from_numpy(x) for x in (logits, logp, lens, finished)]


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("W,V", GRID)
def test_two_level_topw_equals_plain(W, V, case):
    B = 2 if W * V <= 1000 else 1
    args = step_inputs(B, W, V, case, seed=W * 7 + V)
    lp_table = beam.length_penalty_table(64, 0.6 if V % 2 else 0.0, "cpu")
    tok = torch.empty((B, W), dtype=torch.int64)
    par = torch.empty((B, W), dtype=torch.int64)
    out = beam.beam_step_plain(*args, lp_table, tok, par, beam.step_buffers(B, W, "cpu"))
    token, parent, flat = mirror_step(*args, lp_table)
    np.testing.assert_array_equal(token, tok.numpy())
    np.testing.assert_array_equal(parent, par.numpy())
    np.testing.assert_array_equal(out.flat_parent.numpy(),
                                  (np.arange(B)[:, None] * W + parent).reshape(-1))
    if case == "ties" and V >= W + 2:  # lax.top_k's order: the lower flat index first
        assert (parent == 0).all() and (token == np.arange(2, 2 + W)).all()
    # the loop's condition on the new carry, as avsr_tpu/decode/beam.py:130-140
    settled = jnp.all(jnp.logical_or(jnp.asarray(out.finished.numpy()),
                                     jnp.asarray(out.logp.numpy()) < NEG_INF / 2), axis=1)
    np.testing.assert_array_equal(out.settled.numpy(), np.asarray(settled))


def test_keys_order_scores_then_lower_index():
    s = np.array([1.5, -0.0, 0.0, -2.0, 1.5, -np.inf, 3e38, -1e30], np.float32)
    k = keys_of(s)
    assert len(set(k.tolist())) == len(s)  # distinct: the order is total
    want = sorted(range(len(s)), key=lambda i: (-float(s[i]), i))
    np.testing.assert_array_equal(np.argsort(k)[::-1], want)


def test_every_shape_the_first_wrapper_took_is_admitted():
    """The first K7 wrapper took W >= 1, V past EOS and 2 W V 4 + 128 bytes
    within 48 KB; the kernel takes each of them in one block (at most 16
    warps) within the card's shared memory, by either level-1 route."""
    n = 0
    for W in range(1, 2043):
        for V in range(3, 6128 // W + 1):
            old = 2 * W * V * 4 + 32 * 4 <= 48 * 1024
            if not old:
                continue
            n += 1
            assert kernels.beam_step_admits(W, V), (W, V)
            assert kernels.beam_step_smem(W, V) <= kernels.SMEM_LIMIT, (W, V)
            assert kernels.beam_step_level1(W, V) in ("count", "rounds")
    assert n > 40000
    for W, V in itertools.product((1, 10, 2043), (6129 // 1, 613, 3)):
        if W * V > 6128:
            assert not kernels.beam_step_admits(W, V), (W, V)


def test_level1_route_by_shape():
    assert kernels.beam_step_level1(10, 44) == "count"   # the presets' beam
    assert kernels.beam_step_level1(32, 44) == "count"
    assert kernels.beam_step_level1(1, 44) == "rounds"   # one beam: one round
    assert kernels.beam_step_level1(1, 6128) == "rounds"
    assert kernels.beam_step_level1(10, 612) == "rounds"

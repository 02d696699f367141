"""K6's grouped cross read: the beams of an utterance read its one memory row.

The port's beam search no longer tiles a transformer decoder's memories
over the beams: K6 (``decode_attention``) takes the memory's B rows and the
N = B * W queries, query row n reading memory row n // W.  These tests hold
the plain twin over the untiled memory against itself over the tiled one
and against the JAX package's ``_cross_attend_rows`` over the tiled memory
(as its beam search reads it), the whole beam search against JAX's and
against the exhaustive search, and the CUDA wrapper's checks and route
table (which run without a card).
"""

from __future__ import annotations

import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avsr_tpu.configs import DecoderConfig
from avsr_tpu.data.units import EOS_ID, GO_ID, PAD_ID
from avsr_tpu.decode import beam as jbeam
from avsr_tpu.models import decoder as jdec
from avsr_tpu.models import transformer_decoder as jtd
from avsr_tpu.ops import attention as jattn
from avsr_tpu_torch import convert, kernels
from avsr_tpu_torch.decode import beam as tbeam
from avsr_tpu_torch.models import decoder as tdec
from avsr_tpu_torch.models import transformer_decoder as ttd
from avsr_tpu_torch.ops import attention as tattn

# two decoder layers, 4 heads of 8, a 24-wide memory (6 value channels a head)
CFG = dataclasses.replace(DecoderConfig(), decoder_type="transformer", hidden_units=(32, 32),
                          num_heads=4, attention_units=8, embedding_dim=16,
                          sampling_probability=0.0)
V, M = 20, 24
# the JAX package's toy-vocabulary decoder, two layers (tests/test_transformer_decoder.py)
TV, MAXLEN = 5, 3
TCFG = DecoderConfig(embedding_dim=4, hidden_units=(8, 8), attention_units=4,
                     max_label_length=MAXLEN, decoder_type="transformer", num_heads=2,
                     dropout_rate=0.0)
# fp32 on the CPU: the twin and the reference differ only by the summation
# order of their fp32 products and softmax (values of order one)
F32_TOL = dict(atol=1e-5, rtol=1e-4)


@pytest.fixture(autouse=True)
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _operands(seed, B, W, S, nh=2, dk=8, dv=16, lens=None):
    """Queries [B*W, nh, dk], an untiled memory's keys [B, S, nh, dk] and
    values [B, S, nh, dv], its bias [B, S] (row 1 of length 0)."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B * W, nh, dk)).astype(np.float32)
    k = rng.standard_normal((B, S, nh, dk)).astype(np.float32)
    v = rng.standard_normal((B, S, nh, dv)).astype(np.float32)
    lens = np.array(lens if lens is not None else [S, 0, 3][:B])
    bias = ((1.0 - (np.arange(S)[None, :] < lens[:, None])) * -1e30).astype(np.float32)
    return q, k, v, bias


@pytest.mark.parametrize("W", [1, 3, 10])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_untiled_twin_is_the_tiled_twin_bit_for_bit(W, dtype):
    """The twin over the memory's B rows gives the same bits as over the
    memory tiled W times (beams contiguous per row, as the reference tiles)."""
    q, k, v, bias = (torch.from_numpy(x) for x in _operands(W, 3, W, 7))
    q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
    got = ttd.decode_attention_plain(q, k, v, bias, 7)
    tile = lambda x: x.repeat_interleave(W, dim=0)  # noqa: E731
    want = ttd.decode_attention_plain(q, tile(k), tile(v), tile(bias), 7)
    assert torch.equal(got, want)


@pytest.mark.parametrize("W", [1, 3, 10])
def test_grouped_cross_rows_match_jax_over_the_tiled_memory(W):
    """The port's ``_cross_attend_rows`` over the untiled memories (B rows)
    against the reference's over the memories tiled W times, with a
    length-0 memory row (its beams get the uniform weights: the mean of
    the row's values), fp32."""
    B, S, D = 3, 7, 32
    params = jdec.decoder_init(jax.random.PRNGKey(W), CFG, [M], V)
    layer_j = params["layers"][0]
    tparams = convert.from_jax(jax.tree_util.tree_map(np.asarray, params), device="cpu")
    rng = np.random.default_rng(W)
    memory = rng.standard_normal((B, S, M)).astype(np.float32)
    lengths = np.array([S, 0, 4], np.int32)
    h = rng.standard_normal((B * W, D)).astype(np.float32)
    mem_t = tattn.prepare_memory("value_only", tparams["atts"][0], torch.from_numpy(memory),
                                 torch.from_numpy(lengths), torch.float32)
    tiled = np.repeat(memory, W, axis=0)
    mem_j = jattn.prepare_memory("value_only", params["atts"][0], jnp.asarray(tiled),
                                 jnp.asarray(np.repeat(lengths, W)), compute_dtype=jnp.float32)
    cross_j = jtd.prepare_cross(params, CFG, [mem_j], compute_dtype=jnp.float32)
    cross_t = ttd.prepare_cross(tparams, CFG, [mem_t], torch.float32)
    assert cross_t[0][0].shape[0] == B and cross_j[0][0].shape[0] == B * W
    want = jtd._cross_attend_rows(layer_j, CFG, jnp.asarray(h), [mem_j], cross_j[0],
                                  jnp.float32)
    got = ttd._cross_attend_rows(tparams["layers"][0], CFG, torch.from_numpy(h), [mem_t],
                                 cross_t[0], torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)
    # the length-0 row's beams read the plain mean of its values, each head
    mean = mem_t.values[1].numpy().mean(axis=0)
    for w in range(W):
        np.testing.assert_allclose(got[W + w].numpy(), mean, **F32_TOL)


def test_twin_matches_jax_rows_over_tiled_memory_with_empty_row():
    """The twin's grouped read against the reference's single-query lines
    (``_cross_attend_rows``' core) over the tiled memory; the length-0
    row's beams get the uniform weights, the mean of the row's values."""
    B, W, S, nh, dk, dv = 3, 4, 6, 2, 8, 16
    q, k, v, bias = _operands(5, B, W, S, nh, dk, dv)
    kt, vt, bt = (np.repeat(x, W, axis=0) for x in (k, v, bias))
    s = jnp.einsum("nha,nsha->nhs", q, kt).astype(jnp.float32) / np.sqrt(dk)
    want = jnp.einsum("nhs,nshd->nhd", jax.nn.softmax(s + bt[:, None, :], axis=-1), vt)
    got = ttd.decode_attention_plain(*(torch.from_numpy(x) for x in (q, k, v, bias)), S)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)
    for w in range(W):
        np.testing.assert_allclose(got[W + w].numpy(), v[1].mean(axis=0), **F32_TOL)


def _decoder_and_memory(seed, m_len=(7, 4, 0), S=7):
    params = jdec.decoder_init(jax.random.PRNGKey(seed), CFG, [M], V)
    rng = np.random.default_rng(seed)
    memory = rng.standard_normal((len(m_len), S, M)).astype(np.float32)
    lengths = np.array(m_len, np.int32)
    mem_j = jattn.prepare_memory("value_only", params["atts"][0], jnp.asarray(memory),
                                 jnp.asarray(lengths), compute_dtype=jnp.float32)
    tparams = convert.from_jax(jax.tree_util.tree_map(np.asarray, params), device="cpu")
    mem_t = tattn.prepare_memory("value_only", tparams["atts"][0], torch.from_numpy(memory),
                                 torch.from_numpy(lengths), torch.float32)
    return params, tparams, mem_j, mem_t


@pytest.mark.parametrize("width", [1, 3, 5])
def test_two_layer_beam_search_matches_jax(width):
    """Beam search on a two-layer transformer decoder over a memory batch
    with a length-0 row, the port's memory untiled: ids, lengths and steps
    identical to avsr_tpu's (which tiles it), scores within 1e-4 relative."""
    params, tparams, mem_j, mem_t = _decoder_and_memory(width)
    rj = jbeam.beam_search(params, CFG, [mem_j], 8, beam_width=width, length_penalty=0.6,
                           compute_dtype=jnp.float32)
    rt = tbeam.beam_search(tparams, CFG, [mem_t], 8, beam_width=width, length_penalty=0.6,
                           cdt=torch.float32)
    np.testing.assert_array_equal(rt.ids.numpy(), np.asarray(rj.ids))
    np.testing.assert_array_equal(rt.lengths.numpy(), np.asarray(rj.lengths))
    assert rt.steps == int(rj.steps)
    np.testing.assert_allclose(rt.scores.numpy(), np.asarray(rj.scores), rtol=1e-4)


def test_beam_search_reads_the_untiled_memory():
    """The transformer's cross keys are projected once per memory row, not
    per beam: ``prepare_cross`` sees B rows whatever the width."""
    _, tparams, _, mem_t = _decoder_and_memory(2)
    seen = []
    real = tdec.prepare_cross

    def spy(params, cfg, memories, cdt):
        seen.append([m.values.shape[0] for m in memories])
        return real(params, cfg, memories, cdt)

    tdec.prepare_cross = spy
    try:
        tbeam.beam_search(tparams, CFG, [mem_t], 4, beam_width=4, cdt=torch.float32)
    finally:
        tdec.prepare_cross = real
    assert seen == [[3]]


def _score(tparams, mem, b, seq):
    """Teacher-forced log prob of ``seq`` for row b through the port's
    ``decoder_step`` (the JAX test's ``score_sequence``)."""
    N = mem.values.shape[0]
    state = tdec.initial_state(TCFG, N, MAXLEN, torch.float32, "cpu")
    cross = tdec.prepare_cross(tparams, TCFG, [mem], torch.float32)
    tok = torch.full((N,), GO_ID, dtype=torch.long)
    total = 0.0
    for t in seq:
        state, logits = tdec.decoder_step(tparams, TCFG, tok, state, [mem], cross, torch.float32)
        total += float(torch.log_softmax(logits, dim=-1)[b, t])
        tok = torch.full((N,), t, dtype=torch.long)
    return total


def test_two_layer_beam_equals_exhaustive():
    """With a width above the number of finished candidates, the grouped
    beam search on the two-layer toy decoder returns the exhaustive best
    EOS-terminated sequence and its score (tests/test_transformer_decoder.py:135)."""
    params = jdec.decoder_init(jax.random.PRNGKey(2), TCFG, [6], TV)
    rng = np.random.default_rng(3)
    memory = rng.standard_normal((2, 3, 6)).astype(np.float32)
    tparams = convert.from_jax(jax.tree_util.tree_map(np.asarray, params), device="cpu")
    mem = tattn.prepare_memory("value_only", tparams["atts"][0], torch.from_numpy(memory),
                               torch.tensor([3, 2], dtype=torch.int32), torch.float32)
    res = tbeam.beam_search(tparams, TCFG, [mem], MAXLEN, beam_width=16, length_penalty=0.0,
                            cdt=torch.float32)
    for b in range(2):
        best, best_score = None, -np.inf
        for L in range(1, MAXLEN + 1):
            for body in itertools.product([3, 4], repeat=L - 1):
                seq = list(body) + [EOS_ID]
                s = _score(tparams, mem, b, seq)
                if s > best_score:
                    best, best_score = seq, s
        got = [int(x) for x in res.ids[b] if x != PAD_ID]
        assert got == best, f"row {b}: beam {got} != exhaustive {best}"
        np.testing.assert_allclose(float(res.scores[b]), best_score, rtol=1e-4)


@pytest.mark.parametrize("N, B", [(7, 3), (10, 4), (5, 0)])
def test_queries_not_a_multiple_of_the_memory_rows_raise(N, B):
    """N query rows over B memory rows need N = B * W."""
    q = torch.zeros(N, 2, 8)
    kv = torch.zeros(B, 5, 2, 8)
    with pytest.raises(ValueError, match="multiple of B"):
        ttd.decode_attention_plain(q, kv, kv, torch.zeros(B, 5), 5)
    with pytest.raises(ValueError, match="multiple of B"):
        kernels.decode_attention_route(N, B, 5, 5, 2, 8, 8, cross=True)


def test_launcher_rejects_cpu_tensors_and_counts_no_launch():
    """The CUDA wrapper checks the device before building or launching, on
    every route, and counts no launch."""
    bf = torch.bfloat16
    before = dict(kernels.LAUNCHES)
    cases = (
        # grouped: the presets' cross widths (128, 256), 10 beams of 2 memory rows
        (torch.zeros(20, 4, 128, dtype=bf), torch.zeros(2, 9, 4, 128, dtype=bf),
         torch.zeros(2, 9, 4, 256, dtype=bf), torch.zeros(2, 9), 9),
        # rows: self at 4 heads of 64
        (torch.zeros(3, 4, 64, dtype=bf), torch.zeros(3, 9, 4, 64, dtype=bf),
         torch.zeros(3, 9, 4, 64, dtype=bf), None, 4),
        # grouped at other widths, two beams a row
        (torch.zeros(6, 2, 16, dtype=bf), torch.zeros(3, 9, 2, 16, dtype=bf),
         torch.zeros(3, 9, 2, 32, dtype=bf), torch.zeros(3, 9), 9),
        # general: greedy's cross read, a beam a row
        (torch.zeros(3, 2, 8, dtype=bf), torch.zeros(3, 9, 2, 8, dtype=bf),
         torch.zeros(3, 9, 2, 16, dtype=bf), torch.zeros(3, 9), 9),
    )
    for q, k, v, bias, n_keys in cases:
        with pytest.raises(ValueError, match="expected a tensor on"):
            kernels.decode_attention(q, k, v, bias, n_keys)
    assert kernels.LAUNCHES == before


def test_route_table_is_a_function_of_shape():
    """``decode_attention_route`` by shape alone: the grouped cross read of
    two beams or more at widths that are multiples of 16 while a CTA holds
    the memory row, the rows kernel for the self read at nh * dh = 256 while a row fits in
    shared memory, the general kernel for every other shape; the same
    answer every call."""
    route = kernels.decode_attention_route
    # the presets' main path: v2 / fast memories and 16 s, beams and greedy
    for N, B in ((80, 8), (128, 128), (30, 1), (20, 10)):
        for S in (50, 197, 531):
            # greedy (one beam a row) reads on the general kernel, and so
            # does a 16 s memory, whose keys fit one CTA only with 16 value
            # columns (narrower than DECODE_GROUP_MIN_COLS)
            want = "grouped" if N > B and S < 531 else "general"
            assert route(N, B, S, S, 4, 128, 256, cross=True) == want
            assert route(N, B, S, S, 4, 128, 256, cross=True) == want
        for pos in (0, 37, 149):
            assert route(N, N, 150, pos + 1, 4, 64, 64, cross=False) == "rows"
    # the grouped read takes widths that are multiples of 16 (the tensor
    # cores' k step); other multiples of 8 and greedy read on the general kernel
    assert route(80, 8, 197, 197, 4, 64, 64, cross=True) == "grouped"
    assert route(6, 3, 9, 9, 2, 16, 32, cross=True) == "grouped"
    assert route(6, 3, 9, 9, 2, 8, 16, cross=True) == "general"
    assert route(6, 3, 9, 9, 2, 64, 88, cross=True) == "general"
    assert route(3, 3, 9, 9, 2, 16, 32, cross=True) == "general"
    # a memory too long for one CTA's shared memory: the general kernel
    assert kernels.decode_grouped_slices(8, 10, 6000, 4, 128, 256) == 0
    assert route(80, 8, 6000, 6000, 4, 128, 256, cross=True) == "general"
    # the value columns' slices: a wave of CTAs over the (row, head) pairs
    slices = kernels.decode_grouped_slices
    assert slices(8, 10, 197, 4, 128, 256) == 4   # 128 CTAs of 64 columns
    assert slices(8, 10, 50, 4, 128, 256) == 4
    assert slices(8, 10, 531, 4, 128, 256) == 0   # the 16 s memory fits at 16 columns only
    assert slices(128, 10, 197, 4, 128, 256) == 1
    assert slices(3, 10, 40, 4, 64, 96) == 3   # 32 columns a slice at least
    assert slices(8, 10, 197, 1, 16, 16) == 1  # dv = 16: one slice of 16
    for B, W, S in ((8, 10, 197), (2, 5, 300), (1, 17, 100)):
        cv = slices(B, W, S, 4, 128, 256)
        assert cv >= 1 and 256 % (16 * cv) == 0 and 256 // cv >= 32
        assert kernels.decode_grouped_smem(W, S, 128, 256 // cv) <= kernels.SMEM_LIMIT
    assert kernels.decode_grouped_smem(10, 197, 128, 64) == (
        16 * 136 * 2 + 208 * 136 * 2 + 208 * 72 * 2 + 16 * 208 * 4 + 16 * 216 * 2)
    # self: other widths
    assert route(16, 16, 40, 20, 4, 32, 32, cross=False) == "general"  # nh * dh = 128
    assert route(16, 16, 40, 20, 8, 32, 32, cross=False) == "rows"     # 8 heads of 32
    assert route(16, 16, 40, 20, 1, 256, 256, cross=False) == "rows"
    assert route(16, 16, 40, 20, 2, 128, 64, cross=False) == "general"  # dk != dv
    # dk / 8 = 3 lanes a head: not a power of two
    assert route(16, 16, 40, 20, 256 // 24 + 1, 24, 24, cross=False) == "general"
    # a cache row too long for shared memory
    longest = max(n for n in range(1, 400) if kernels.decode_rows_smem(n, 4) <= kernels.SMEM_LIMIT)
    assert route(8, 8, 400, longest, 4, 64, 64, cross=False) == "rows"
    assert route(8, 8, 400, longest + 1, 4, 64, 64, cross=False) == "general"
    assert kernels.decode_rows_smem(150, 4) == 150 * 1024 + 2400 + 16384 + 2 * 5 * 8
    with pytest.raises(ValueError, match="multiples of 8"):
        route(8, 8, 10, 10, 4, 60, 60, cross=False)
    with pytest.raises(ValueError, match="n_keys"):
        route(8, 8, 10, 11, 4, 64, 64, cross=False)

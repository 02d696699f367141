"""Decoding in the port against ``avsr_tpu.decode``: the beam step K7's
plain twin, beam search with and without the length penalty, greedy
decode, and the mirrors of the JAX package's own decode invariants
(``tests/test_transformer_decoder.py:135,153``, ``tests/test_beam.py:161``;
the port's decoder is the transformer, so the greedy early-exit mirror
runs it).

Tolerances: fp32 throughout.  Parents, tokens, lengths, finished flags,
ids and step counts identical; log probs and scores within 1e-5 (one
log-softmax and a few fp32 sums apart) or 1e-4 relative after whole
decodes, as the JAX beam tests hold theirs.
"""

import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avsr_tpu.configs import DecoderConfig
from avsr_tpu.data.units import EOS_ID, GO_ID, PAD_ID, builtin_unit_dict
from avsr_tpu.decode import beam as jbeam
from avsr_tpu.decode.greedy import greedy_decode as jgreedy
from avsr_tpu.models import decoder as jdec
from avsr_tpu.models import seq2seq as jseq
from avsr_tpu.ops import attention as jattn
from avsr_tpu_torch import convert
from avsr_tpu_torch.decode import beam as tbeam
from avsr_tpu_torch.decode.greedy import greedy_decode as tgreedy
from avsr_tpu_torch.models import decoder as tdec
from avsr_tpu_torch.ops import attention as tattn
from avsr_tpu_torch.serve import Predictor
from tests.test_torch_slice import _request, small_fast_cfg

NEG_INF = -1.0e30
CFG = dataclasses.replace(DecoderConfig(), decoder_type="transformer", hidden_units=(32,),
                          num_heads=4, attention_units=8, embedding_dim=16,
                          sampling_probability=0.0)
V, M = 20, 24
# the JAX package's toy-vocabulary decoder (tests/test_transformer_decoder.py)
TV, MAXLEN = 5, 3
TCFG = DecoderConfig(embedding_dim=4, hidden_units=(8, 8), attention_units=4,
                     max_label_length=MAXLEN, decoder_type="transformer", num_heads=2,
                     dropout_rate=0.0)


@pytest.fixture(autouse=True)
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _jax_step(logits, logp, lens, finished, alpha):
    """The JAX beam step body (avsr_tpu/decode/beam.py:149-195) after the
    decoder, on given logits [B*W, V] and state [B, W]."""
    B, W = logp.shape
    Vv = logits.shape[-1]
    step_logp = jax.nn.log_softmax(logits, axis=-1)
    step_logp = step_logp.at[:, PAD_ID].set(NEG_INF).at[:, GO_ID].set(NEG_INF).reshape(B, W, Vv)
    eos_only = jnp.full((Vv,), NEG_INF).at[EOS_ID].set(0.0)
    step_logp = jnp.where(finished[:, :, None], eos_only[None, None, :], step_logp)
    cand_logp = logp[:, :, None] + step_logp
    cand_lens = jnp.broadcast_to((lens + jnp.where(finished, 0, 1))[:, :, None], (B, W, Vv))
    cand_scores = cand_logp / jbeam._length_penalty(cand_lens, alpha)
    _, flat_idx = jax.lax.top_k(cand_scores.reshape(B, W * Vv), W)
    parent, token = flat_idx // Vv, flat_idx % Vv
    was_finished = jnp.take_along_axis(finished, parent, axis=1)
    return dict(
        parent=parent, token=token,
        logp=jnp.take_along_axis(cand_logp.reshape(B, W * Vv), flat_idx, axis=1),
        lens=jnp.take_along_axis(cand_lens.reshape(B, W * Vv), flat_idx, axis=1),
        finished=was_finished | (token == EOS_ID),
        feed=jnp.where(was_finished, EOS_ID, token))


def _step_inputs(seed, B=3, W=4, Vv=9, ties=False):
    rng = np.random.default_rng(seed)
    if ties:  # one uniform row and one score for every beam: exact ties everywhere
        return (np.zeros((B * W, Vv), np.float32), np.zeros((B, W), np.float32),
                np.zeros((B, W), np.int32), np.zeros((B, W), bool))
    logits = (3 * rng.standard_normal((B * W, Vv))).astype(np.float32)
    logp = (-10 * rng.uniform(size=(B, W))).astype(np.float32)
    logp[0, 2:] = NEG_INF  # dead beams
    lens = rng.integers(0, 9, (B, W)).astype(np.int32)
    finished = rng.uniform(size=(B, W)) < 0.3
    return logits, logp, lens, finished


@pytest.mark.parametrize("alpha", [0.0, 0.6])
@pytest.mark.parametrize("case", ["random", "ties"])
def test_beam_step_twin_matches_jax_step_body(case, alpha):
    logits, logp, lens, finished = _step_inputs(3, ties=case == "ties")
    want = _jax_step(*(jnp.asarray(x) for x in (logits, logp, lens, finished)), alpha)
    B, W = logp.shape
    tok = torch.full((B, W), -1, dtype=torch.int64)
    par = torch.full((B, W), -1, dtype=torch.int64)
    out = tbeam.beam_step_plain(torch.from_numpy(logits), torch.from_numpy(logp),
                                torch.from_numpy(lens), torch.from_numpy(finished),
                                tbeam.length_penalty_table(12, alpha, "cpu"), tok, par,
                                tbeam.step_buffers(B, W, "cpu"))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(want["token"]))
    np.testing.assert_array_equal(par.numpy(), np.asarray(want["parent"]))
    np.testing.assert_array_equal(out.flat_parent.numpy(),
                                  (np.arange(B)[:, None] * W + np.asarray(want["parent"])).ravel())
    for name in ("lens", "finished", "feed"):
        np.testing.assert_array_equal(getattr(out, name).numpy(), np.asarray(want[name]))
    np.testing.assert_allclose(out.logp.numpy(), np.asarray(want["logp"]), rtol=1e-6, atol=1e-5)
    # the loop's condition on the new carry (avsr_tpu/decode/beam.py:130-140)
    settled = jnp.logical_or(want["finished"], want["logp"] < NEG_INF / 2)
    np.testing.assert_array_equal(out.settled.numpy(), np.asarray(jnp.all(settled, axis=1)))
    if case == "ties":  # lax.top_k's order: the lower flat index first
        assert (par == 0).all() and (tok == torch.arange(2, 2 + W)).all()
    # the wrapper on CPU tensors is the twin
    tok2, par2 = torch.empty_like(tok), torch.empty_like(par)
    out2 = tbeam.beam_step(torch.from_numpy(logits), torch.from_numpy(logp),
                           torch.from_numpy(lens), torch.from_numpy(finished),
                           tbeam.length_penalty_table(12, alpha, "cpu"), tok2, par2,
                           tbeam.step_buffers(B, W, "cpu"))
    assert torch.equal(tok2, tok) and torch.equal(out2.logp, out.logp)


def test_length_penalty_table_matches_jax():
    for alpha in (0.0, 0.6, 1.0):
        want = jbeam._length_penalty(jnp.arange(151), alpha)
        np.testing.assert_allclose(tbeam.length_penalty_table(150, alpha, "cpu").numpy(),
                                   np.asarray(want), rtol=1e-6)


def _decoder_and_memory(seed, m_len=(7, 4, 0), S=7, cfg=CFG, Mm=M, Vv=V):
    params = jdec.decoder_init(jax.random.PRNGKey(seed), cfg, [Mm], Vv)
    rng = np.random.default_rng(seed)
    memory = rng.standard_normal((len(m_len), S, Mm)).astype(np.float32)
    lengths = np.array(m_len, np.int32)
    mem_j = jattn.prepare_memory("value_only", params["atts"][0], jnp.asarray(memory),
                                 jnp.asarray(lengths), compute_dtype=jnp.float32)
    tparams = convert.from_jax(jax.tree_util.tree_map(np.asarray, params), device="cpu")
    mem_t = tattn.prepare_memory("value_only", tparams["atts"][0], torch.from_numpy(memory),
                                 torch.from_numpy(lengths), torch.float32)
    return params, tparams, mem_j, mem_t


@pytest.mark.parametrize("alpha", [0.0, 0.6])
def test_beam_search_matches_jax(alpha):
    """Width-4 beam over a memory batch with a length-0 row: ids, lengths,
    steps identical to avsr_tpu's, scores within 1e-4 relative."""
    params, tparams, mem_j, mem_t = _decoder_and_memory(1)
    rj = jbeam.beam_search(params, CFG, [mem_j], 8, beam_width=4, length_penalty=alpha,
                           compute_dtype=jnp.float32)
    rt = tbeam.beam_search(tparams, CFG, [mem_t], 8, beam_width=4, length_penalty=alpha,
                           cdt=torch.float32)
    np.testing.assert_array_equal(rt.ids.numpy(), np.asarray(rj.ids))
    np.testing.assert_array_equal(rt.lengths.numpy(), np.asarray(rj.lengths))
    assert rt.steps == int(rj.steps)
    np.testing.assert_allclose(rt.scores.numpy(), np.asarray(rj.scores), rtol=1e-4)


def test_beam_search_early_exit_matches_jax():
    """EOS forced by the output bias: both packages stop after the same
    step with the same ids and scores (the K7 finished-beam rows)."""
    params, tparams, mem_j, mem_t = _decoder_and_memory(4)
    params = dict(params, out_b=params["out_b"].at[EOS_ID].set(6.0))
    tparams["out_b"][EOS_ID] = 6.0
    rj = jbeam.beam_search(params, CFG, [mem_j], 12, beam_width=3, length_penalty=0.6,
                           compute_dtype=jnp.float32)
    rt = tbeam.beam_search(tparams, CFG, [mem_t], 12, beam_width=3, length_penalty=0.6,
                           cdt=torch.float32)
    assert rt.steps == int(rj.steps) < 12
    np.testing.assert_array_equal(rt.ids.numpy(), np.asarray(rj.ids))
    np.testing.assert_allclose(rt.scores.numpy(), np.asarray(rj.scores), rtol=1e-4)


@pytest.fixture(scope="module")
def greedy_run():
    """The small lrs2_av_fast-shaped model: JAX encode + greedy against the
    port's encode + greedy on the same weights and request."""
    cfg = small_fast_cfg(horizon=12)
    units = builtin_unit_dict(cfg.data.unit)
    jparams = jseq.model_init(jax.random.PRNGKey(7), cfg, units.vocab_size)
    pred = Predictor(convert.from_jax(jax.tree_util.tree_map(np.asarray, jparams), device="cpu"),
                     cfg, units, device="cpu", batch_size=2, audio_seconds=1.0)
    arrays, _ = pred.assemble(*_request(np.random.default_rng(7), 2))
    enc_j = jseq.encode(jparams, cfg, jseq.Batch(**{k: jnp.asarray(v) for k, v in arrays.items()}))
    ids_j, len_j = jgreedy(jparams["decoder"], cfg.decoder, enc_j.memories, 12,
                           compute_dtype=jnp.float32)
    res_t = tgreedy(pred.params["decoder"], cfg.decoder, pred.encode(arrays).memories, 12,
                    cdt=torch.float32)
    return ids_j, len_j, res_t


def test_greedy_ids_match_jax(greedy_run):
    ids_j, _, res_t = greedy_run
    assert tuple(res_t.ids.shape) == (2, 12)
    np.testing.assert_array_equal(res_t.ids.numpy(), np.asarray(ids_j))


def test_greedy_lengths_match_jax(greedy_run):
    _, len_j, res_t = greedy_run
    np.testing.assert_array_equal(res_t.lengths.numpy(), np.asarray(len_j))
    assert 1 <= res_t.steps <= 12


# ---- mirrors of the JAX package's decode invariants ----------------------


def _toy(seed, mem_seed=None, B=2, S=3, H=6):
    """tests/test_transformer_decoder.py's decoder and memory, in both."""
    params = jdec.decoder_init(jax.random.PRNGKey(seed), TCFG, [H], TV)
    rng = np.random.default_rng(seed if mem_seed is None else mem_seed)
    memory = rng.standard_normal((B, S, H)).astype(np.float32)
    lengths = np.array([S, S - 1], np.int32)
    tparams = convert.from_jax(jax.tree_util.tree_map(np.asarray, params), device="cpu")
    mem_t = tattn.prepare_memory("value_only", tparams["atts"][0], torch.from_numpy(memory),
                                 torch.from_numpy(lengths), torch.float32)
    return params, tparams, mem_t


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


def test_beam_equals_exhaustive_with_transformer_decoder():
    """Mirror of tests/test_transformer_decoder.py:135: with a width above
    the number of finished candidates, beam search returns the exhaustive
    best EOS-terminated sequence and its score."""
    _, tparams, mem = _toy(2, mem_seed=3)
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


def test_greedy_decode_runs():
    """Mirror of tests/test_transformer_decoder.py:153."""
    _, tparams, mem = _toy(4, mem_seed=5)
    res = tgreedy(tparams, TCFG, [mem], 4, cdt=torch.float32)
    assert tuple(res.ids.shape) == (2, 4)
    assert bool((res.lengths >= 1).all())
    for b in range(2):
        eos = (res.ids[b] == EOS_ID).nonzero()
        if len(eos):
            assert bool((res.ids[b, int(eos[0]) + 1:] == PAD_ID).all())


def test_greedy_early_exit_when_all_finish():
    """Mirror of tests/test_beam.py:161 with the transformer decoder: an
    EOS-biased output stops the loop early; a longer horizon only appends
    PAD and changes neither the ids nor the lengths."""
    _, tparams, mem = _toy(0)
    tparams["out_b"][EOS_ID] = 50.0
    short = tgreedy(tparams, TCFG, [mem], MAXLEN + 2, cdt=torch.float32)
    long = tgreedy(tparams, TCFG, [mem], MAXLEN + 20, cdt=torch.float32)
    assert short.steps == long.steps == 1
    L = short.ids.shape[1]
    assert torch.equal(short.ids, long.ids[:, :L])
    assert bool((long.ids[:, L:] == PAD_ID).all())
    assert torch.equal(short.lengths, long.lengths)


def test_beam_width_one_equals_greedy():
    """Mirror of tests/test_beam.py:84 with the transformer decoder."""
    _, tparams, mem = _toy(1)
    res = tbeam.beam_search(tparams, TCFG, [mem], MAXLEN, beam_width=1, length_penalty=0.0,
                            cdt=torch.float32)
    g = tgreedy(tparams, TCFG, [mem], MAXLEN, cdt=torch.float32)
    assert torch.equal(res.ids, g.ids)

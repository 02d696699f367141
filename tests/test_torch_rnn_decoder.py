"""The attention-LSTM decoder of the port (``avsr_tpu_torch/ops/rnn.py``
``lstm_step``, ``avsr_tpu_torch/models/decoder.py`` RNN branch) against
``avsr_tpu``, and the beam / greedy engines driving it: mirrors of
``tests/test_beam.py``'s invariants (beam == exhaustive, width 1 ==
greedy, early exit of beam and greedy) with the RNN decoder, and whole
decodes against ``avsr_tpu.decode``.

Weights come from the JAX package's ``decoder_init`` / ``lstm_init``,
converted with ``convert.from_jax``; inputs from seeded numpy.
Tolerances: fp32 steps at atol / rtol 1e-5 (fp32 sums in another order),
the bf16 policy at atol 1e-2 (a value on a bf16 rounding boundary can land
one ulp apart); ids, lengths and step counts identical; scores within
1e-4 relative, as the JAX beam tests hold theirs.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avsr_tpu.configs import DecoderConfig
from avsr_tpu.data.units import EOS_ID, GO_ID, PAD_ID
from avsr_tpu.decode import beam as jbeam
from avsr_tpu.decode.greedy import greedy_decode as jgreedy
from avsr_tpu.models import decoder as jdec
from avsr_tpu.ops import attention as jattn
from avsr_tpu.ops import rnn as jrnn
from avsr_tpu_torch import convert
from avsr_tpu_torch.decode import beam as tbeam
from avsr_tpu_torch.decode.greedy import greedy_decode as tgreedy
from avsr_tpu_torch.models import decoder as tdec
from avsr_tpu_torch.ops import attention as tattn
from avsr_tpu_torch.ops import rnn as trnn

DT = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# the JAX package's toy decoder (tests/test_beam.py)
V, MAXLEN = 5, 3
CFG = DecoderConfig(embedding_dim=4, hidden_units=(6,), attention_units=4,
                    max_label_length=MAXLEN)


@pytest.fixture(autouse=True)
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _to_torch(tree):
    return convert.from_jax(jax.tree_util.tree_map(np.asarray, tree), device="cpu")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("preprojected", [False, True])
def test_lstm_step_matches_jax(dtype, preprojected):
    jdt, tdt = DT[dtype]
    params = jrnn.lstm_init(jax.random.PRNGKey(0), 12, 16)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 64 if preprojected else 12)).astype(np.float32)
    h = rng.standard_normal((3, 16)).astype(np.float32)
    c = rng.standard_normal((3, 16)).astype(np.float32)
    (hj, cj), _ = jrnn.lstm_step(params, jnp.asarray(x), (jnp.asarray(h), jnp.asarray(c)),
                                 preprojected=preprojected, compute_dtype=jdt)
    (ht, ct), out = trnn.lstm_step(_to_torch(params), torch.from_numpy(x),
                                   (torch.from_numpy(h), torch.from_numpy(c)), tdt,
                                   preprojected=preprojected)
    tol = dict(atol=1e-5, rtol=1e-5) if dtype == "float32" else dict(atol=1e-2, rtol=0)
    np.testing.assert_allclose(ht.numpy(), np.asarray(hj), **tol)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), **tol)
    assert out is ht


def test_lstm_step_refuses_layer_norm():
    """LN cells used to raise here (no decoder cell uses them); ported with
    K13, ``lstm_step`` now normalises the gate blocks where the params hold
    ``ln_gamma`` (and the cell only with ``ln_cell_gamma``), as the
    reference's does."""
    p = trnn.lstm_init(torch.Generator().manual_seed(0), 4, 8, "cpu")
    p["ln_gamma"] = 1.0 + 0.1 * torch.arange(32, dtype=torch.float32) / 32
    x = torch.randn((2, 4), generator=torch.Generator().manual_seed(1))
    state = (0.5 * torch.ones(2, 8), torch.linspace(-1, 1, 16).view(2, 8))
    (h, c), out = trnn.lstm_step(p, x, state, torch.float32)
    jp = {k: jnp.asarray(v.numpy()) for k, v in p.items()}
    (hj, cj), _ = jrnn.lstm_step(jp, jnp.asarray(x.numpy()),
                                 tuple(jnp.asarray(t.numpy()) for t in state),
                                 compute_dtype=jnp.float32)
    np.testing.assert_allclose(h.numpy(), np.asarray(hj), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(c.numpy(), np.asarray(cj), atol=1e-5, rtol=1e-5)
    assert out is h


def _decoder_and_memory(seed, cfg, lengths=(7, 4, 0), S=7, M=10, Vv=11):
    params = jdec.decoder_init(jax.random.PRNGKey(seed), cfg, [M], Vv)
    rng = np.random.default_rng(seed)
    memory = rng.standard_normal((len(lengths), S, M)).astype(np.float32)
    lens = np.asarray(lengths, np.int32)
    mem_j = [jattn.prepare_memory(cfg.attention_type, params["atts"][0], jnp.asarray(memory),
                                  jnp.asarray(lens), compute_dtype=jdt)
             for jdt in (jnp.float32, jnp.bfloat16)]
    tparams = _to_torch(params)
    mem_t = [tattn.prepare_memory(cfg.attention_type, tparams["atts"][0], torch.from_numpy(memory),
                                  torch.from_numpy(lens), tdt)
             for tdt in (torch.float32, torch.bfloat16)]
    return params, tparams, mem_j, mem_t


@pytest.mark.parametrize("attention_type", ["bahdanau", "luong"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("value_dim", [None, 6])
def test_decoder_step_matches_jax(dtype, value_dim, attention_type):
    """Three steps of a 2-layer decoder: every state tensor and the logits."""
    jdt, tdt = DT[dtype]
    cfg = DecoderConfig(embedding_dim=8, hidden_units=(12, 12), attention_units=8,
                        memory_value_dim=value_dim, attention_type=attention_type)
    params, tparams, mem_j, mem_t = _decoder_and_memory(1, cfg)
    k = 0 if dtype == "float32" else 1
    N = 3
    sj = jdec.initial_state(cfg, N, [mem_j[k].values.shape[-1]])
    st = tdec.initial_state(cfg, N, 4, tdt, "cpu", memory_dims=[mem_t[k].values.shape[-1]])
    tol = dict(atol=1e-5, rtol=1e-5) if dtype == "float32" else dict(atol=1e-2, rtol=0)
    for tokens in ([GO_ID] * N, [3, 7, 2], [4, 4, 9]):
        sj, lj = jdec.decoder_step(params, cfg, jnp.asarray(tokens, jnp.int32), sj, [mem_j[k]],
                                   compute_dtype=jdt)
        st, lt = tdec.decoder_step(tparams, cfg, torch.tensor(tokens), st, [mem_t[k]], None, tdt)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **tol)
        for a, b in zip(jax.tree_util.tree_leaves(st), jax.tree_util.tree_leaves(sj)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **tol)
    assert isinstance(st, tdec.DecoderState) and len(st.lstm) == 2
    assert float(st.contexts[0][2].abs().max()) == 0.0  # the length-0 memory row


def test_rnn_state_and_training_dispatch():
    cfg = DecoderConfig(embedding_dim=4, hidden_units=(6, 5), attention_units=4)
    st = tdec.initial_state(cfg, 3, 9, torch.float32, "cpu", memory_dims=[7])
    assert [tuple(h.shape) for h, _ in st.lstm] == [(3, 6), (3, 5)]
    assert [tuple(c.shape) for c in st.contexts] == [(3, 7)]
    with pytest.raises(ValueError, match="memory_dims"):
        tdec.initial_state(cfg, 3, 9, torch.float32, "cpu")
    assert tdec.prepare_cross({}, cfg, [], torch.float32) is None
    # teacher forcing of the RNN decoder is ported (it used to raise)
    params = tdec.decoder_init(torch.Generator().manual_seed(0), cfg, [7], 5, "cpu")
    mem = tattn.prepare_memory("bahdanau", params["atts"][0], torch.randn(2, 4, 7),
                               torch.tensor([4, 0]), torch.float32)
    logits = tdec.teacher_forced_logits(params, cfg, torch.zeros(2, 3, dtype=torch.long),
                                        torch.tensor([3, 2]), [mem], torch.float32)
    assert tuple(logits.shape) == (2, 3, 5) and bool(torch.isfinite(logits).all())
    # Luong attention is ported now (it used to raise); an unknown type raises
    with pytest.raises(ValueError, match="unknown attention type"):
        tdec.decoder_init(torch.Generator(), DecoderConfig(attention_type="dot"), [7], 5, "cpu")


def test_decoder_init_matches_jax_tree():
    cfg = DecoderConfig(embedding_dim=8, hidden_units=(12, 10), attention_units=8,
                        memory_value_dim=6)
    jp = jdec.decoder_init(jax.random.PRNGKey(0), cfg, [10, 14], 11)
    tp = tdec.decoder_init(torch.Generator().manual_seed(0), cfg, [10, 14], 11, "cpu")
    assert jax.tree_util.tree_map(lambda x: tuple(x.shape), convert.to_jax_numpy(tp)) == \
        jax.tree_util.tree_map(lambda x: tuple(x.shape), jp)


@pytest.mark.parametrize("attention_type", ["bahdanau", "luong"])
@pytest.mark.parametrize("alpha", [0.0, 0.6])
def test_beam_search_matches_jax(alpha, attention_type):
    """Width-4 beam over a memory batch with a length-0 row."""
    cfg = DecoderConfig(embedding_dim=8, hidden_units=(12,), attention_units=8,
                        attention_type=attention_type)
    params, tparams, mem_j, mem_t = _decoder_and_memory(2, cfg)
    rj = jbeam.beam_search(params, cfg, [mem_j[0]], 8, beam_width=4, length_penalty=alpha,
                           compute_dtype=jnp.float32)
    rt = tbeam.beam_search(tparams, cfg, [mem_t[0]], 8, beam_width=4, length_penalty=alpha,
                           cdt=torch.float32)
    np.testing.assert_array_equal(rt.ids.numpy(), np.asarray(rj.ids))
    np.testing.assert_array_equal(rt.lengths.numpy(), np.asarray(rj.lengths))
    assert rt.steps == int(rj.steps)
    np.testing.assert_allclose(rt.scores.numpy(), np.asarray(rj.scores), rtol=1e-4)


def test_greedy_decode_matches_jax():
    cfg = DecoderConfig(embedding_dim=8, hidden_units=(12,), attention_units=8)
    params, tparams, mem_j, mem_t = _decoder_and_memory(3, cfg)
    ids_j, len_j = jgreedy(params, cfg, [mem_j[0]], 8, compute_dtype=jnp.float32)
    res = tgreedy(tparams, cfg, [mem_t[0]], 8, cdt=torch.float32)
    np.testing.assert_array_equal(res.ids.numpy(), np.asarray(ids_j))
    np.testing.assert_array_equal(res.lengths.numpy(), np.asarray(len_j))


# ---- mirrors of tests/test_beam.py with the RNN decoder -------------------


def _build(seed=0, B=2, S=3, H=5):
    """tests/test_beam.py's ``build``: the toy decoder and a full-length memory."""
    params = jdec.decoder_init(jax.random.PRNGKey(seed), CFG, [H], V)
    memory = np.random.default_rng(seed).standard_normal((B, S, H)).astype(np.float32)
    tparams = _to_torch(params)
    mem = tattn.prepare_memory("bahdanau", tparams["atts"][0], torch.from_numpy(memory),
                               torch.full((B,), S), torch.float32)
    return tparams, mem, B


def _score(tparams, mem, b, seq):
    """Teacher-forced log prob of ``seq`` for row b through ``decoder_step``."""
    N = mem.values.shape[0]
    state = tdec.initial_state(CFG, N, MAXLEN, torch.float32, "cpu",
                               memory_dims=[mem.values.shape[-1]])
    tok = torch.full((N,), GO_ID, dtype=torch.long)
    total = 0.0
    for t in seq:
        state, logits = tdec.decoder_step(tparams, CFG, tok, state, [mem], None, torch.float32)
        total += float(torch.log_softmax(logits, dim=-1)[b, t])
        tok = torch.full((N,), t, dtype=torch.long)
    return total


def test_beam_equals_exhaustive():
    """Mirror of tests/test_beam.py::test_beam_equals_exhaustive."""
    tparams, mem, B = _build()
    res = tbeam.beam_search(tparams, CFG, [mem], MAXLEN, beam_width=16, length_penalty=0.0,
                            cdt=torch.float32)
    for b in range(B):
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


def test_beam_width_one_equals_greedy():
    """Mirror of tests/test_beam.py::test_beam_width_one_equals_greedy."""
    tparams, mem, _ = _build(seed=1)
    res = tbeam.beam_search(tparams, CFG, [mem], MAXLEN, beam_width=1, length_penalty=0.0,
                            cdt=torch.float32)
    assert torch.equal(res.ids, tgreedy(tparams, CFG, [mem], MAXLEN, cdt=torch.float32).ids)


def test_early_exit_when_all_beams_finish():
    """Mirror of tests/test_beam.py::test_early_exit_when_all_beams_finish."""
    tparams, mem, _ = _build()
    tparams["out_b"][EOS_ID] = 50.0
    short = tbeam.beam_search(tparams, CFG, [mem], MAXLEN + 2, beam_width=2, cdt=torch.float32)
    long = tbeam.beam_search(tparams, CFG, [mem], MAXLEN + 20, beam_width=2, cdt=torch.float32)
    assert short.steps == 2 and long.steps == 2
    L = short.ids.shape[1]
    assert torch.equal(short.ids, long.ids[:, :L])
    assert bool((long.ids[:, L:] == PAD_ID).all())
    np.testing.assert_allclose(short.scores.numpy(), long.scores.numpy(), rtol=1e-6)
    assert torch.equal(short.lengths, long.lengths)


def test_greedy_early_exit_when_all_finish():
    """Mirror of tests/test_beam.py::test_greedy_early_exit_when_all_finish."""
    tparams, mem, _ = _build()
    tparams["out_b"][EOS_ID] = 50.0
    short = tgreedy(tparams, CFG, [mem], MAXLEN + 2, cdt=torch.float32)
    long = tgreedy(tparams, CFG, [mem], MAXLEN + 20, cdt=torch.float32)
    L = short.ids.shape[1]
    assert torch.equal(short.ids, long.ids[:, :L])
    assert bool((long.ids[:, L:] == PAD_ID).all())
    assert torch.equal(short.lengths, long.lengths)

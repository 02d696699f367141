"""The port's transformer encoder (``avsr_tpu_torch/models/transformer.py``)
against ``avsr_tpu.models.encoder`` / ``avsr_tpu.models.transformer`` on the
CPU, on the same weights (carried across by ``convert.from_jax``) and the
same inputs made from a seed with numpy.

Sizes: d = 32, 4 heads, 2 layers, conformer conv kernel 5 and 15 (wider
than the shortest sequences), with and without ``time_reduction=(1, 2)``,
ragged lengths with a 0-length row.  Tolerances: the fp32 policy at atol
/ rtol 1e-4 (sums in another order through two layers), as
``tests/test_torch_slice.py`` states it.  The bf16 policy: JAX on the CPU
rounds every step of its bf16 sigmoid (``1 / (1 + exp(-x))``) and tanh-GELU
to bf16, where the port, like XLA's fused elementwise code on the TPU and
like the K9 kernel, rounds each function's result once (measured: 34% of
the sigmoids and 43% of the GELUs one bf16 ulp apart).  With those two
functions computed step by step as JAX's CPU backend does
(``_stepwise_bf16``), every other rounding point agrees and the outputs
are held at atol 1e-2, as ``tests/test_torch_slice.py`` holds its bf16
memories (measured max 5.3e-3); with the port's own functions the one-ulp
differences are carried through the residual stream and the outputs are
held at atol 2e-2 and a mean of 2e-3 (measured max 1.19e-2, mean 1.4e-3).
The plain versions of the two kernels' spans (K11, the self-attention
core; K9, the conv module between its pointwise products) are held alone
against a jnp transcription of ``transformer.py:212-223`` and ``:240-264``:
at 1e-5 in fp32 and at 2e-2 in bf16 (one bf16 ulp of a value of order one,
K4's context tolerance).
"""

import contextlib
import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avsr_tpu.configs import EncoderConfig
from avsr_tpu.models import encoder as jenc
from avsr_tpu.models.transformer_common import layer_norm as jlayer_norm
from avsr_tpu_torch import convert
from avsr_tpu_torch import configs as tconfigs
from avsr_tpu_torch.models import encoder as tenc
from avsr_tpu_torch.models import transformer as tfm


@pytest.fixture(autouse=True)
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


D_IN = 6
LENGTHS = (11, 6, 0, 9)
DTYPES = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16),
          "bf16_stepwise": (jnp.bfloat16, torch.bfloat16)}
TOL = {"fp32": dict(atol=1e-4, rtol=1e-4), "bf16": dict(atol=2e-2, rtol=0),
       "bf16_stepwise": dict(atol=1e-2, rtol=0)}
MEAN_TOL = {"fp32": 1e-5, "bf16": 2e-3, "bf16_stepwise": 5e-4}


@contextlib.contextmanager
def _stepwise_bf16():
    """bf16 sigmoid and tanh-GELU rounded after every step, as JAX's CPU
    backend computes ``jax.nn.sigmoid`` and ``jax.nn.gelu`` on bf16."""
    sigmoid, gelu = torch.sigmoid, torch.nn.functional.gelu

    def step_sigmoid(x):
        return 1.0 / (1.0 + torch.exp(-x)) if x.dtype == torch.bfloat16 else sigmoid(x)

    def step_gelu(x, approximate="none"):
        if x.dtype != torch.bfloat16:
            return gelu(x, approximate=approximate)
        c = torch.tensor(np.sqrt(2 / np.pi), dtype=x.dtype)
        return x * (0.5 * (1.0 + torch.tanh(c * (x + 0.044715 * x ** 3))))

    with mock.patch.object(tfm.torch, "sigmoid", step_sigmoid), \
            mock.patch.object(tfm.F, "gelu", step_gelu):
        yield


def _cfg(conv_kernel=5, time_reduction=None, hidden=(32, 32), heads=4, **kw):
    return EncoderConfig(hidden_units=hidden, encoder_type="transformer", num_heads=heads,
                         dropout_rate=0.0, conv_kernel=conv_kernel,
                         time_reduction=time_reduction, **kw)


def _tcfg(cfg):
    """The same config in the port's own copy of the config classes."""
    return tconfigs.EncoderConfig(**dataclasses.asdict(cfg))


def _inputs(seed, T=11, lengths=LENGTHS):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((T, len(lengths), D_IN)).astype(np.float32)
    return x, np.asarray(lengths, np.int32)


def _params(cfg, seed):
    jparams = jenc.encoder_init(jax.random.PRNGKey(seed), cfg, D_IN)
    tparams = convert.from_jax(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    return jparams, tparams


def _run_torch(tparams, cfg, x, lengths, tdt):
    return tenc.encoder_apply(tparams, _tcfg(cfg), torch.from_numpy(x),
                              torch.from_numpy(lengths), tdt)


@pytest.mark.parametrize("policy", ["fp32", "bf16", "bf16_stepwise"])
@pytest.mark.parametrize("time_reduction", [None, (1, 2)], ids=["no_reduction", "reduction_1_2"])
@pytest.mark.parametrize("conv_kernel", [5, 15])
def test_encoder_matches_jax(conv_kernel, time_reduction, policy):
    cfg = _cfg(conv_kernel, time_reduction)
    jdt, tdt = DTYPES[policy]
    jparams, tparams = _params(cfg, seed=conv_kernel)
    x, lengths = _inputs(seed=conv_kernel + 1)
    out_j, (sum_j,) = jenc.encoder_apply(jparams, cfg, jnp.asarray(x), jnp.asarray(lengths),
                                         compute_dtype=jdt)
    with _stepwise_bf16() if policy == "bf16_stepwise" else contextlib.nullcontext():
        out_t, (sum_t,) = _run_torch(tparams, cfg, x, lengths, tdt)
    assert out_t.dtype == torch.float32 and tuple(out_t.shape) == out_j.shape
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), **TOL[policy])
    np.testing.assert_allclose(sum_t.numpy(), np.asarray(sum_j), **TOL[policy])
    assert float(np.abs(out_t.numpy() - np.asarray(out_j)).mean()) < MEAN_TOL[policy]
    out_lengths = tenc.encoder_output_lengths(_tcfg(cfg), torch.from_numpy(lengths))
    for b, L in enumerate(out_lengths.tolist()):
        assert bool((out_t[L:, b] == 0).all())


def _jnp_attention(qkv, lengths):
    """transformer.py:212-223 on a given [B, T, 3, nh, dh] product."""
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    dh = q.shape[-1]
    scores = jnp.einsum("bqhd,bkhd->bhqk", q, k).astype(jnp.float32) / np.sqrt(dh)
    key_valid = (jnp.arange(q.shape[1])[None, :] < lengths[:, None]).astype(jnp.float32)
    scores = scores + (1.0 - key_valid)[:, None, None, :] * -1e9
    w = jax.nn.softmax(scores, axis=-1).astype(qkv.dtype)
    return jnp.einsum("bhqk,bkhd->bqhd", w, v)


@pytest.mark.parametrize("policy", ["fp32", "bf16"])
def test_attention_plain_matches_jnp(policy):
    jdt, tdt = DTYPES[policy]
    rng = np.random.default_rng(4)
    qkv = rng.standard_normal((4, 11, 3, 4, 8)).astype(np.float32)
    lengths = np.asarray(LENGTHS, np.int32)
    want = np.asarray(_jnp_attention(jnp.asarray(qkv, jdt), jnp.asarray(lengths)), np.float32)
    got = tfm.encoder_self_attention_plain(torch.from_numpy(qkv).to(tdt),
                                           torch.from_numpy(lengths))
    assert got.dtype == tdt and tuple(got.shape) == (4, 11, 4, 8)
    np.testing.assert_allclose(got.float().numpy(), want, atol=1e-5 if policy == "fp32" else 2e-2,
                               rtol=0)
    # the 0-length row: the uniform softmax over all keys, the mean of v
    np.testing.assert_allclose(got[2].float().numpy(),
                               np.broadcast_to(qkv[2, :, 2].astype(np.float32).mean(0), (11, 4, 8)),
                               atol=1e-5 if policy == "fp32" else 2e-2)


@pytest.mark.parametrize("policy", ["fp32", "bf16"])
def test_attention_weights_from_saved_statistics(policy):
    """The forward's save mode keeps the softmax's row statistics, and the
    weights recomputed from them are the forward's bit for bit: they give
    the forward's context to the bit, twice over; they are the softmax of
    the scores (to fp32 rounding; JAX's ``jax.nn.softmax`` in fp32), rows
    summing to 1, the 0-length row exactly 1/T over its T keys."""
    jdt, tdt = DTYPES[policy]
    rng = np.random.default_rng(6)
    qkv_np = rng.standard_normal((4, 11, 3, 4, 8)).astype(np.float32)
    qkv = torch.from_numpy(qkv_np).to(tdt)
    lengths = torch.from_numpy(np.asarray(LENGTHS, np.int32))
    ctx, (row_max, row_sum) = tfm.encoder_self_attention_fwd_plain(qkv, lengths, save=True)
    assert torch.equal(ctx, tfm.encoder_self_attention_plain(qkv, lengths))
    w = tfm.encoder_self_attention_weights(qkv, lengths, row_max, row_sum)
    assert w.dtype == torch.float32 and tuple(w.shape) == (4, 4, 11, 11)
    assert torch.equal(torch.einsum("bhqk,bkhd->bqhd", w.to(tdt), qkv[:, :, 2]), ctx)
    assert torch.equal(w, tfm.encoder_self_attention_weights(qkv, lengths, row_max, row_sum))
    torch.testing.assert_close(w, torch.softmax(tfm._attention_scores(qkv, lengths), dim=-1),
                               atol=1e-6, rtol=0)
    torch.testing.assert_close(w.sum(dim=-1), torch.ones((4, 4, 11)), atol=1e-6, rtol=0)
    assert torch.equal(w[2], torch.full((4, 11, 11), 1.0 / 11))
    if policy == "fp32":
        q, k = jnp.asarray(qkv_np[:, :, 0]), jnp.asarray(qkv_np[:, :, 1])
        scores = jnp.einsum("bqhd,bkhd->bhqk", q, k) / np.sqrt(8)
        key_valid = (jnp.arange(11)[None, :] < jnp.asarray(LENGTHS)[:, None]).astype(jnp.float32)
        want = jax.nn.softmax(scores + (1.0 - key_valid)[:, None, None, :] * -1e9, axis=-1)
        np.testing.assert_allclose(w.numpy(), np.asarray(want), atol=1e-6, rtol=0)


def _jnp_conv_module(u, b_in, dw, ln_scale, ln_bias, lengths):
    """transformer.py:241-264 from the first pointwise product to the
    operand of the second, time-major u [T, B, 2d]."""
    cdt = u.dtype
    d = u.shape[-1] // 2
    mask = (jnp.arange(u.shape[0])[:, None] < lengths[None, :]).astype(jnp.float32)
    g = u + b_in.astype(cdt)
    a, b_gate = jnp.split(g, 2, axis=-1)
    y = a * jax.nn.sigmoid(b_gate)
    y = y * mask[:, :, None].astype(cdt)
    yb = jnp.transpose(y, (1, 0, 2)).astype(jnp.float32)
    yb = jax.lax.conv_general_dilated(yb, dw.astype(jnp.float32), window_strides=(1,),
                                      padding="SAME", dimension_numbers=("NWC", "WIO", "NWC"),
                                      feature_group_count=d)
    y = jlayer_norm(jnp.transpose(yb, (1, 0, 2)), ln_scale, ln_bias)
    return (y * jax.nn.sigmoid(y)).astype(cdt)


@pytest.mark.parametrize("policy", ["fp32", "bf16"])
@pytest.mark.parametrize("k", [5, 15])
def test_conformer_conv_plain_matches_jnp(k, policy):
    jdt, tdt = DTYPES[policy]
    rng = np.random.default_rng(k)
    T, d = 11, 32
    u = rng.standard_normal((T, 4, 2 * d)).astype(np.float32)
    b_in = (0.1 * rng.standard_normal(2 * d)).astype(np.float32)
    dw = (rng.standard_normal((k, 1, d)) / np.sqrt(k)).astype(np.float32)
    ln_scale = (1.0 + 0.1 * rng.standard_normal(d)).astype(np.float32)
    ln_bias = (0.1 * rng.standard_normal(d)).astype(np.float32)
    lengths = np.asarray(LENGTHS, np.int32)
    want = _jnp_conv_module(jnp.asarray(u, jdt), *map(jnp.asarray, (b_in, dw, ln_scale, ln_bias,
                                                                     lengths)))
    got = tfm.conformer_conv_plain(torch.from_numpy(u).to(tdt),
                                   *map(torch.from_numpy, (b_in, dw, ln_scale, ln_bias, lengths)))
    assert got.dtype == tdt and tuple(got.shape) == (T, 4, d)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=1e-5 if policy == "fp32" else 2e-2, rtol=0)


def test_wrappers_take_the_plain_versions_on_the_cpu():
    rng = np.random.default_rng(9)
    qkv = torch.from_numpy(rng.standard_normal((2, 5, 3, 2, 8)).astype(np.float32))
    lengths = torch.tensor([5, 2])
    assert torch.equal(tfm.encoder_self_attention(qkv, lengths),
                       tfm.encoder_self_attention_plain(qkv, lengths))
    u = torch.from_numpy(rng.standard_normal((5, 2, 16)).astype(np.float32))
    args = (torch.zeros(16), torch.ones(3, 1, 8), torch.ones(8), torch.zeros(8), lengths)
    assert torch.equal(tfm.conformer_conv(u, *args), tfm.conformer_conv_plain(u, *args))


@pytest.mark.parametrize("time_reduction", [None, (1, 2)], ids=["no_reduction", "reduction_1_2"])
def test_padding_invariance(time_reduction):
    """The same content padded to two horizons: identical valid outputs
    (padded keys masked, the conv module's input masked, absolute
    positions), as tests/test_transformer_encoder.py holds the reference."""
    cfg = _cfg(conv_kernel=15, time_reduction=time_reduction)
    _, tparams = _params(cfg, seed=21)
    x, lengths = _inputs(seed=22, T=9, lengths=(9, 4, 0))
    x[4:, 1] = 0.0
    outs = []
    for T in (9, 17):
        xp = np.zeros((T, 3, D_IN), np.float32)
        xp[:9] = x
        outs.append(_run_torch(tparams, cfg, xp, lengths, torch.float32)[0].numpy())
    n = outs[0].shape[0]
    np.testing.assert_allclose(outs[0], outs[1][:n], rtol=1e-5, atol=1e-5)
    assert np.all(outs[1][n:] == 0.0)


def test_zero_length_row():
    """A row with no valid step gives zero outputs and a zero summary, and
    leaves the other rows as they are without it."""
    cfg = _cfg(conv_kernel=5)
    _, tparams = _params(cfg, seed=31)
    x, lengths = _inputs(seed=32, T=7, lengths=(7, 0, 5))
    out, (summary,) = _run_torch(tparams, cfg, x, lengths, torch.float32)
    assert bool((out[:, 1] == 0).all()) and bool((summary[1] == 0).all())
    alone, _ = _run_torch(tparams, cfg, x[:, [0, 2]], lengths[[0, 2]], torch.float32)
    np.testing.assert_allclose(out[:, [0, 2]].numpy(), alone.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kw, match", [
    (dict(hidden=(16, 32)), "hidden_units equal"),
    (dict(hidden=(18,)), "num_heads"),
    (dict(hidden=(9,), heads=3), "even"),
    (dict(residual=True), "RNN-stack knob"),
    (dict(recurrent_dropout_rate=0.1), "RNN-only"),
    (dict(conv_kernel=4), "odd width"),
], ids=["dims", "heads", "odd_d", "residual", "recurrent_dropout", "even_kernel"])
def test_config_validation_matches_jax(kw, match):
    cfg = _cfg(**{"conv_kernel": None, **kw})
    with pytest.raises(ValueError, match=match):
        jenc.encoder_init(jax.random.PRNGKey(0), cfg, D_IN)
    with pytest.raises(ValueError, match=match):
        tenc.encoder_init(torch.Generator().manual_seed(0), _tcfg(cfg), D_IN, "cpu")


def test_unknown_encoder_type_and_output_dim():
    with pytest.raises(ValueError, match="encoder_type"):
        tenc.encoder_init(torch.Generator(), tconfigs.EncoderConfig(
            hidden_units=(8,), encoder_type="wavenet"), D_IN, "cpu")
    assert tenc.encoder_output_dim(_tcfg(_cfg())) == jenc.encoder_output_dim(_cfg()) == 32
    # the conformer conv is transformer-only, in both packages
    rnn_cfg = EncoderConfig(hidden_units=(8,), conv_kernel=5)
    with pytest.raises(ValueError, match="transformer-only"):
        jenc.encoder_init(jax.random.PRNGKey(0), rnn_cfg, D_IN)
    with pytest.raises(ValueError, match="transformer-only"):
        tenc.encoder_init(torch.Generator(), _tcfg(rnn_cfg), D_IN, "cpu")


@pytest.mark.parametrize("time_reduction", [None, (1, 2), (2, 2)],
                         ids=["no_reduction", "reduction_1_2", "reduction_2_2"])
def test_init_tree_matches_jax(time_reduction):
    """Keys, shapes and dtypes of the port's seeded init equal the JAX
    tree's: the conv weights, ``conv_dw`` [k, 1, d] and the fold."""
    cfg = _cfg(conv_kernel=15, time_reduction=time_reduction)
    jshapes = jax.tree_util.tree_map(
        lambda a: (tuple(a.shape), str(a.dtype)),
        jax.eval_shape(lambda k: jenc.encoder_init(k, cfg, D_IN), jax.random.PRNGKey(0)))
    tparams = tenc.encoder_init(torch.Generator().manual_seed(0), _tcfg(cfg), D_IN, "cpu")
    tshapes = jax.tree_util.tree_map(lambda a: (tuple(a.shape), str(a.dtype).split(".")[-1]),
                                     convert.to_jax_numpy(tparams))
    assert jax.tree_util.tree_structure(tshapes) == jax.tree_util.tree_structure(jshapes)
    assert jax.tree_util.tree_leaves(tshapes) == jax.tree_util.tree_leaves(jshapes)
    assert ("fold" in tparams["layers"][1]) == (time_reduction is not None)


def test_train_mode_dropout_draws_from_the_generator():
    """Train mode at the preset's rate 0.1: the branch dropout comes from
    the generator (the same seed repeats bit for bit, another seed gives
    other outputs), eval mode ignores the rate, as the reference does, and
    train mode at rate 0 equals eval mode."""
    cfg = dataclasses.replace(_cfg(), dropout_rate=0.1)
    _, tparams = _params(_cfg(), seed=41)
    x, lengths = _inputs(seed=42)
    a = _run_torch_train(tparams, cfg, x, lengths, seed=1)[0]
    b = _run_torch_train(tparams, cfg, x, lengths, seed=1)[0]
    c = _run_torch_train(tparams, cfg, x, lengths, seed=2)[0]
    ev = _run_torch(tparams, cfg, x, lengths, torch.float32)[0]
    assert torch.equal(a, b) and not torch.equal(a, c) and not torch.equal(a, ev)
    assert bool(torch.isfinite(a).all())
    for out in (a, c):  # padded steps stay exactly zero
        for i, n in enumerate(LENGTHS):
            assert bool((out[n:, i] == 0).all())
    assert torch.equal(_run_torch(tparams, cfg, x, lengths, torch.float32)[0], ev)
    nodrop = _run_torch_train(tparams, _cfg(), x, lengths, seed=1)[0]
    assert torch.equal(nodrop, ev)


def _run_torch_train(tparams, cfg, x, lengths, seed=0):
    return tenc.encoder_apply(tparams, _tcfg(cfg), torch.from_numpy(x), torch.from_numpy(lengths),
                              torch.float32, train=True,
                              generator=torch.Generator().manual_seed(seed))

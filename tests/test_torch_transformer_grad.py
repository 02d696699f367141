"""Gradients of the port's transformer encoder (``avsr_tpu_torch/models/
transformer.py``) against ``jax.vjp`` of ``avsr_tpu``'s, on the CPU, on the
same weights (``convert.from_jax``) and inputs made from a seed with numpy.

On CPU tensors ``EncoderSelfAttention`` and ``ConformerConv`` run the plain
forwards and the hand-written backward twins
(``encoder_self_attention_bwd_plain``, ``conformer_conv_bwd_plain``).  The
twins are held alone against ``jax.vjp`` of jnp transcriptions of the two
spans (``transformer.py:212-223`` and ``:240-264``), and the whole stack's
input and parameter gradients against ``jax.vjp`` of
``transformer_encoder_apply``; sizes d = 32, 4 heads, 2 layers, conv
kernels 3, 5 and 15, with and without ``time_reduction=(1, 2)``, ragged
lengths with a 0-length row.

Tolerances.  The fp32 policy: the spans at atol 2e-5 / rtol 1e-5 (sums in
another order; measured at most 4e-6 on values up to 11), the stack's
gradient leaves at a relative norm error of 1e-4.  The bf16 policy, with
JAX's CPU rounding of every step of the bf16 sigmoid and tanh-GELU mirrored
(``_stepwise_bf16``, as ``tests/test_torch_transformer_encoder.py`` does for
the forward):

* K11's dqkv at 3e-2 of the largest reference value, as
  ``tests/test_torch_fusion_grad.py`` holds K4's (a value within one ulp of
  a rounding boundary lands 2^-8 relative apart after another summation
  order);
* K9's du at one bf16 ulp of its largest value (2^-7 of max |du|) and a
  mean of 1e-3: an fp32 sum of the conv's transpose that lands on the other
  side of dy's bf16 rounding moves da and dgate by one ulp of dy, not of
  themselves (measured 1.6e-2 on values up to 5.4); ddw and the LayerNorm's
  gradients come out of fp32 arithmetic on identical bf16 operands and keep
  the fp32 tolerance;
* K9's db_in: JAX's CPU backend reduces the bf16 cotangent in bf16, one
  rounding per term in (t, b) order (measured: bit-equal to that sequential
  sum); the port, like XLA on the TPU, sums in fp32 and rounds once.  db_in
  is held to one bf16 ulp of the rounded wide sum of the twin's own du, and
  to JAX's value at 2^-5 of the largest (measured 0.07 on values up to
  9.4);
* the stack's leaves at a relative norm error of 3e-2 (measured at most
  9.7e-3, conv_b_in's 9.4e-3).
"""

import contextlib
import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avsr_tpu.models import encoder as jenc
from avsr_tpu.models import transformer as jtfm
from avsr_tpu_torch import convert
from avsr_tpu_torch.models import encoder as tenc
from avsr_tpu_torch.models import transformer as tfm
from avsr_tpu_torch.utils.params import tree_leaves, tree_map
from tests.test_torch_transformer_encoder import (DTYPES, LENGTHS, _cfg, _inputs, _jnp_attention,
                                                  _jnp_conv_module, _params, _stepwise_bf16,
                                                  _tcfg)
from tests.test_torch_train import _by_path

POLICIES = {"fp32": DTYPES["fp32"], "bf16": DTYPES["bf16_stepwise"]}
FP32_TOL = dict(atol=2e-5, rtol=1e-5)


@pytest.fixture(autouse=True)
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _policy(policy):
    return _stepwise_bf16() if policy == "bf16" else contextlib.nullcontext()


def _f32(x):
    return np.asarray(jnp.asarray(x, jnp.float32)) if not isinstance(x, torch.Tensor) \
        else x.detach().float().numpy()


@pytest.mark.parametrize("policy", list(POLICIES))
def test_attention_bwd_plain_matches_jax_vjp(policy):
    jdt, tdt = POLICIES[policy]
    rng = np.random.default_rng(5)
    qkv = rng.standard_normal((4, 11, 3, 4, 8)).astype(np.float32)
    dctx = rng.standard_normal((4, 11, 4, 8)).astype(np.float32)
    lengths = np.asarray(LENGTHS, np.int32)
    _, vjp = jax.vjp(lambda x: _jnp_attention(x, jnp.asarray(lengths)), jnp.asarray(qkv, jdt))
    (want,) = vjp(jnp.asarray(dctx, jdt))
    tq, tl = torch.from_numpy(qkv).to(tdt), torch.from_numpy(lengths)
    _, (row_max, row_sum) = tfm.encoder_self_attention_fwd(tq, tl, save=True)
    assert row_max.dtype == row_sum.dtype == torch.float32
    assert tuple(row_max.shape) == tuple(row_sum.shape) == (4, 4, 11)
    got = tfm.encoder_self_attention_bwd_plain(tq, tl, row_max, row_sum,
                                               torch.from_numpy(dctx).to(tdt))
    assert got.dtype == tdt and tuple(got.shape) == qkv.shape
    want = _f32(want)
    if policy == "fp32":
        np.testing.assert_allclose(_f32(got), want, **FP32_TOL)
    else:
        np.testing.assert_allclose(_f32(got), want, atol=3e-2 * np.abs(want).max(), rtol=0)
    # the 0-length row attends uniformly over all keys: its values take
    # dctx's mean over the queries, each key the same share
    np.testing.assert_allclose(_f32(got)[2, :, 2],
                               np.broadcast_to(dctx[2].mean(0), (11, 4, 8)),
                               atol=1e-5 if policy == "fp32" else 2e-2)


@pytest.mark.parametrize("shape", [(2, 5, 2, 8), (3, 11, 4, 8), (2, 17, 1, 16)],
                         ids=["T5", "T11", "T17_one_head"])
def test_attention_saves_no_weights(shape):
    """``EncoderSelfAttention`` keeps for its backward the operands, the
    lengths and the softmax's row statistics [B, nh, T]: no tensor of the
    weights' [B, nh, T, T] shape, and nothing of T x T elements."""
    B, T, nh, dh = shape
    rng = np.random.default_rng(T)
    qkv = torch.from_numpy(rng.standard_normal((B, T, 3, nh, dh)).astype(np.float32))
    qkv.requires_grad_(True)
    lengths = torch.from_numpy(rng.integers(0, T + 1, size=B))
    saved = []

    def pack(x):
        saved.append(x)
        return x

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda x: x):
        out = tfm.EncoderSelfAttention.apply(qkv, lengths)
    assert [tuple(x.shape) for x in saved] == [(B, T, 3, nh, dh), (B,), (B, nh, T), (B, nh, T)]
    assert saved[0] is qkv and saved[1] is lengths
    assert all(x.numel() < B * nh * T * T or x is qkv for x in saved)
    out.backward(torch.ones_like(out))
    assert qkv.grad is not None and tuple(qkv.grad.shape) == (B, T, 3, nh, dh)


def _conv_inputs(k, T=11, d=32, seed=0):
    rng = np.random.default_rng(seed + k)
    return dict(u=rng.standard_normal((T, 4, 2 * d)).astype(np.float32),
                b_in=(0.1 * rng.standard_normal(2 * d)).astype(np.float32),
                dw=(rng.standard_normal((k, 1, d)) / np.sqrt(k)).astype(np.float32),
                ln_scale=(1.0 + 0.1 * rng.standard_normal(d)).astype(np.float32),
                ln_bias=(0.1 * rng.standard_normal(d)).astype(np.float32),
                lengths=np.asarray(LENGTHS, np.int32),
                dout=rng.standard_normal((T, 4, d)).astype(np.float32))


@pytest.mark.parametrize("policy", list(POLICIES))
@pytest.mark.parametrize("k", [3, 5, 15])
def test_conformer_conv_bwd_plain_matches_jax_vjp(k, policy):
    jdt, tdt = POLICIES[policy]
    x = _conv_inputs(k)
    names = ("b_in", "dw", "ln_scale", "ln_bias")
    _, vjp = jax.vjp(lambda u, *p: _jnp_conv_module(u, *p, jnp.asarray(x["lengths"])),
                     jnp.asarray(x["u"], jdt), *(jnp.asarray(x[n]) for n in names))
    want = [_f32(g) for g in vjp(jnp.asarray(x["dout"], jdt))]
    with _policy(policy):
        got = tfm.conformer_conv_bwd_plain(
            torch.from_numpy(x["u"]).to(tdt), *(torch.from_numpy(x[n]) for n in names),
            torch.from_numpy(x["lengths"]), torch.from_numpy(x["dout"]).to(tdt))
    assert got[0].dtype == tdt and all(g.dtype == torch.float32 for g in got[1:])
    got = [_f32(g) for g in got]
    for g, w in zip(got, want):
        assert g.shape == w.shape
    du, db_in, ddw, dls, dlb = got
    for g, w in ((ddw, want[2]), (dls, want[3]), (dlb, want[4])):
        np.testing.assert_allclose(g, w, **FP32_TOL)
    if policy == "fp32":
        np.testing.assert_allclose(du, want[0], **FP32_TOL)
        np.testing.assert_allclose(db_in, want[1], **FP32_TOL)
        return
    diff = np.abs(du - want[0])
    assert diff.max() <= 2.0 ** -7 * np.abs(want[0]).max() and diff.mean() < 1e-3, diff.max()
    wide_sum = _f32(jnp.asarray(du.astype(np.float64).sum(axis=(0, 1)), jnp.bfloat16))
    np.testing.assert_allclose(db_in, wide_sum, atol=0, rtol=2.0 ** -7)
    np.testing.assert_allclose(db_in, want[1], atol=2.0 ** -5 * np.abs(want[1]).max(), rtol=0)
    # the padded steps of the conv's input take no gradient
    du_t = _f32(du)
    for b, n in enumerate(LENGTHS):
        assert np.all(du_t[n:, b] == 0.0)


def _encoder_grads(cfg, policy, seed, train=False):
    """(JAX's, the port's) gradients of <out, r> for a random r, keyed by
    the parameter tree's paths plus ("x",)."""
    jdt, tdt = POLICIES[policy]
    jparams, tparams = _params(cfg, seed=seed)
    x, lengths = _inputs(seed=seed + 1)
    jkw = dict(train=True, dropout_rng=jax.random.PRNGKey(0)) if train else {}
    out_j, vjp = jax.vjp(lambda p, xx: jenc.encoder_apply(p, cfg, xx, jnp.asarray(lengths),
                                                          compute_dtype=jdt, **jkw)[0],
                         jparams, jnp.asarray(x))
    r = np.random.default_rng(seed + 2).standard_normal(out_j.shape).astype(np.float32)
    gp_j, gx_j = vjp(jnp.asarray(r))
    want = {**_by_path(gp_j), ("x",): np.asarray(gx_j)}

    tparams = tree_map(lambda t: t.requires_grad_(True), tparams)
    tx = torch.from_numpy(x).requires_grad_(True)
    tkw = dict(train=True, generator=torch.Generator().manual_seed(0)) if train else {}
    with _policy(policy):
        out_t, _ = tenc.encoder_apply(tparams, _tcfg(cfg), tx, torch.from_numpy(lengths), tdt,
                                      **tkw)
        (out_t * torch.from_numpy(r)).sum().backward()
    it = iter(t.grad for _, t in tree_leaves(tparams))
    got = dict(tree_leaves(convert.to_jax_numpy(tree_map(lambda _: next(it), tparams))))
    got[("x",)] = tx.grad.numpy()
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j),
                               atol=1e-4 if policy == "fp32" else 2e-2)
    return want, got


@pytest.mark.parametrize("policy", list(POLICIES))
@pytest.mark.parametrize("time_reduction", [None, (1, 2)], ids=["no_reduction", "reduction_1_2"])
def test_encoder_grads_match_jax_vjp(time_reduction, policy):
    """Every parameter of both layers (attention, conv module, FFN, fold,
    input projection, final LayerNorm) and the input, through K11's and
    K9's backward twins."""
    want, got = _encoder_grads(_cfg(conv_kernel=5, time_reduction=time_reduction), policy,
                               seed=51)
    assert set(got) == set(want)
    for key, w in want.items():
        err = np.linalg.norm(got[key] - w) / np.linalg.norm(w)
        assert err < (1e-4 if policy == "fp32" else 3e-2), (key, err)
        assert np.abs(got[key]).max() > 0, key


def test_encoder_dropout_matches_jax_with_injected_masks():
    """Train mode at rate 0.25: the same keep masks handed to both packages'
    own dropout formulas (JAX's ``inverted_dropout`` through a patched
    ``bernoulli``, the port's ``_dropout`` through a patched
    ``dropout_mask``), in the reference's order per layer: attention, conv,
    FFN.  fp32; outputs and every gradient leaf as without dropout."""
    cfg = dataclasses.replace(_cfg(conv_kernel=3), dropout_rate=0.25)
    keep = 0.75
    rng = np.random.default_rng(61)
    masks = [rng.uniform(size=(11, len(LENGTHS), 32)) < keep for _ in range(6)]
    jmasks, tmasks = iter(masks), iter(masks)
    calls = []

    def bernoulli(key, p, shape):
        assert p == keep and tuple(shape) == (11, len(LENGTHS), 32)
        return jnp.asarray(next(jmasks))

    def dropout_mask(generator, p, shape, dtype=torch.float32):
        assert p == keep and tuple(shape) == (11, len(LENGTHS), 32)
        calls.append(generator)
        return torch.from_numpy(next(tmasks)).to(dtype) / p

    with mock.patch.object(jax.random, "bernoulli", bernoulli), \
            mock.patch.object(tfm, "dropout_mask", dropout_mask):
        want, got = _encoder_grads(cfg, "fp32", seed=61, train=True)
    assert len(calls) == 6 and next(jmasks, None) is None
    for key, w in want.items():
        err = np.linalg.norm(got[key] - w) / np.linalg.norm(w)
        assert err < 1e-4, (key, err)


def test_dropout_formula_matches_inverted_dropout():
    """``where(keep, x / keep_prob, 0)`` on both sides: bit-equal, not the
    one-ulp different ``x * (1 / keep_prob)``."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((64, 8, 16)).astype(np.float32)
    mask = rng.uniform(size=x.shape) < 0.9
    with mock.patch.object(jax.random, "bernoulli", lambda k, p, s: jnp.asarray(mask)):
        want = np.asarray(jtfm._dropout(jnp.asarray(x), 0.1, jax.random.PRNGKey(0)))
    with mock.patch.object(tfm, "dropout_mask",
                           lambda g, p, s, dtype=torch.float32: torch.from_numpy(mask) / p):
        got = tfm._dropout(torch.from_numpy(x), 0.1, torch.Generator()).numpy()
    np.testing.assert_array_equal(got, want)


def test_cpu_autograd_runs_the_plain_twins():
    """On CPU tensors with a gradient asked, the stack goes through
    ``EncoderSelfAttention`` and ``ConformerConv``, whose backward runs the
    plain twins, and their gradients equal the twins' own."""
    rng = np.random.default_rng(9)
    qkv = torch.from_numpy(rng.standard_normal((2, 5, 3, 2, 8)).astype(np.float32))
    lengths = torch.tensor([5, 2])
    dctx = torch.from_numpy(rng.standard_normal((2, 5, 2, 8)).astype(np.float32))
    x = _conv_inputs(5, T=5, d=8)
    conv_args = [torch.from_numpy(x[n]) for n in ("u", "b_in", "dw", "ln_scale", "ln_bias")]
    conv_args = [a[:, :2] if i == 0 else a for i, a in enumerate(conv_args)]
    dout = torch.from_numpy(x["dout"][:, :2])

    with mock.patch.object(tfm, "encoder_self_attention_bwd_plain",
                           wraps=tfm.encoder_self_attention_bwd_plain) as att_bwd, \
            mock.patch.object(tfm, "conformer_conv_bwd_plain",
                              wraps=tfm.conformer_conv_bwd_plain) as conv_bwd, \
            mock.patch.object(tfm.EncoderSelfAttention, "apply",
                              wraps=tfm.EncoderSelfAttention.apply) as att_fn, \
            mock.patch.object(tfm.ConformerConv, "apply", wraps=tfm.ConformerConv.apply) as conv_fn:
        q = qkv.clone().requires_grad_(True)
        out = tfm.encoder_self_attention(q, lengths)
        assert torch.equal(out.detach(), tfm.encoder_self_attention_plain(qkv, lengths))
        out.backward(dctx)
        leaves = [a.clone().requires_grad_(True) for a in conv_args]
        y = tfm.conformer_conv(*leaves, lengths)
        assert torch.equal(y.detach(), tfm.conformer_conv_plain(*conv_args, lengths))
        y.backward(dout)
    assert att_fn.call_count == att_bwd.call_count == conv_fn.call_count == conv_bwd.call_count == 1
    _, stats = tfm.encoder_self_attention_fwd(qkv, lengths, save=True)
    assert torch.equal(q.grad, tfm.encoder_self_attention_bwd_plain(qkv, lengths, *stats, dctx))
    twin = tfm.conformer_conv_bwd_plain(*conv_args, lengths, dout)
    for leaf, g in zip(leaves, twin):
        assert torch.equal(leaf.grad, g)
    # without a gradient asked, no autograd Function is entered
    with mock.patch.object(tfm.EncoderSelfAttention, "apply", side_effect=RuntimeError), \
            mock.patch.object(tfm.ConformerConv, "apply", side_effect=RuntimeError):
        tfm.encoder_self_attention(qkv, lengths)
        tfm.conformer_conv(*conv_args, lengths)

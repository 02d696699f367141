"""The training slice of the scan-free ``lrs2_av_v2`` model against
``avsr_tpu``: the loss and every gradient leaf, three optimizer steps, and
the encoders' seeded branch dropout.

The config is ``test_torch_v2_slice.small_v2_cfg`` (3 + 1 transformer
encoder layers with the conformer conv, k = 15, d = 32 with 4 heads; the
cross-attention fusion with the AU head, A = 8; a 1-layer transformer
decoder, d = 32) in fp32, train mode with dropout 0 and noise off (torch's
random draws cannot equal JAX's), label smoothing 0.1, warmup-cosine with
2 warmup steps and a ``max_gradient_norm`` small enough that clipping
bites; B = 4, 1 s of audio (31 encoder steps, wider than the conv kernel),
8 labels, a row with no video frame (``test_torch_train.batch_arrays``).
On CPU tensors the encoders' self attention and conv module go through
``EncoderSelfAttention`` and ``ConformerConv``, whose backward runs the
plain twins.

Tolerances, as ``tests/test_torch_align_train.py`` states them: the loss
at rtol 1e-5; each gradient leaf at a relative norm error of 1e-4 (fp32
through 3 + 1 encoder layers, the fusion and the decoder; only summation
order differs); metrics per step at rtol 1e-4 and the parameters after the
steps at atol 2e-5 / rtol 1e-4 (Adam divides by sqrt(nu): a near-zero
gradient element's summation noise moves its update by a few 1e-6).
"""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from avsr_tpu.data.units import builtin_unit_dict
from avsr_tpu.models import seq2seq as jseq
from avsr_tpu.train import step as jstep
from avsr_tpu_torch import convert
from avsr_tpu_torch.models import seq2seq as tseq
from avsr_tpu_torch.train import optim as toptim
from avsr_tpu_torch.train import step as tstep
from avsr_tpu_torch.utils.params import tree_leaves, tree_map
from test_torch_train import _assert_trees_close, _by_path, _jbatch, batch_arrays
from test_torch_v2_slice import small_v2_cfg

MAX_NORM = 0.5


@pytest.fixture(autouse=True)
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def v2_train_cfg(encoder_dropout=0.0, **train):
    base = small_v2_cfg()
    drop = lambda c: dataclasses.replace(c, dropout_rate=encoder_dropout)  # noqa: E731
    return base.replace(
        audio_encoder=drop(base.audio_encoder), video_encoder=drop(base.video_encoder),
        decoder=dataclasses.replace(base.decoder, dropout_rate=0.0),
        train=dataclasses.replace(base.train, lr_schedule="warmup_cosine", warmup_steps=2,
                                  max_gradient_norm=MAX_NORM, label_smoothing=0.1,
                                  num_epochs=2, **train))


@pytest.fixture(scope="module")
def setup():
    cfg = v2_train_cfg()
    V = builtin_unit_dict(cfg.data.unit).vocab_size
    jparams = jseq.model_init(jax.random.PRNGKey(3), cfg, V)
    arrays = batch_arrays(0, V)
    tparams = convert.from_jax(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    return cfg, V, jparams, tparams, arrays


def test_loss_and_every_gradient_leaf_match_jax(setup):
    cfg, _, jparams, tparams, arrays = setup
    lf = jax.jit(lambda p, b: jseq.loss_fn(p, cfg, b, train=True, rng=jax.random.PRNGKey(0)))
    (_, m_j), g_j = jax.value_and_grad(lf, has_aux=True)(jparams, _jbatch(arrays))
    opt, _ = toptim.build_optimizer(cfg.train)
    state = tstep.train_state_from_params(tparams, opt)
    m_t, g_t = tstep.loss_and_grads(state.params, tseq.batch_to_device(arrays, "cpu"), cfg=cfg,
                                    generator=torch.Generator().manual_seed(0))
    assert set(m_t) == {"loss", "ce_loss", "au_loss"}
    for k in m_t:
        np.testing.assert_allclose(float(m_t[k]), float(m_j[k]), rtol=1e-5, err_msg=k)
    assert all(g is not None for g in g_t)
    it = iter(g_t)
    grads = dict(tree_leaves(convert.to_jax_numpy(tree_map(lambda _: next(it), state.params))))
    want = _by_path(g_j)
    assert set(grads) == set(want)
    for k, w in want.items():
        err = np.linalg.norm(grads[k] - w) / np.linalg.norm(w)
        assert err < 1e-4, (k, err)
    # the encoders' self attention (K11) and conv module (K9) spans: every
    # parameter around them takes a gradient, in both stacks
    for enc in ("audio_encoder", "video_encoder"):
        for leaf in ("wq", "wk", "wv", "wo", "conv_w_in", "conv_b_in", "conv_dw",
                     "conv_dw_ln_scale", "conv_dw_ln_bias", "conv_w_out"):
            assert np.abs(grads[(enc, "layers", 0, leaf)]).max() > 0, (enc, leaf)
    assert np.abs(grads[("audio_encoder", "in_proj")]).max() > 0


def _run_jax(cfg, jparams, arrays, steps):
    state, tx = jstep.create_train_state(jax.random.PRNGKey(0), cfg, 1)
    state = state._replace(params=jparams, opt_state=tx.init(jparams))
    fn = jax.jit(functools.partial(jstep.train_step, cfg=cfg, tx=tx))
    metrics = []
    for _ in range(steps):
        state, m = fn(state, _jbatch(arrays), jax.random.PRNGKey(7))
        metrics.append({k: float(v) for k, v in m.items()})
    return state.params, metrics


def _run_port(cfg, tparams, arrays, steps, seed=7):
    opt, _ = toptim.build_optimizer(cfg.train)
    state = tstep.train_state_from_params(tparams, opt)
    batch = tseq.batch_to_device(arrays, "cpu")
    metrics = []
    for _ in range(steps):
        state, m = tstep.train_step(state, batch, cfg=cfg, optimizer=opt,
                                    generator=torch.Generator().manual_seed(seed))
        metrics.append({k: float(v) for k, v in m.items()})
    assert state.step == steps
    return state.params, metrics


def test_three_train_steps_match_jax(setup):
    """Warmup-cosine (lr 0, then 5e-4, then 1e-3) with clipping on every
    step: metrics per step and the parameters after three updates."""
    cfg, _, jparams, tparams, arrays = setup
    pj, mj = _run_jax(cfg, jparams, arrays, 3)
    pt, mt = _run_port(cfg, tparams, arrays, 3)
    for a, b in zip(mt, mj):
        assert set(a) == set(b) == {"loss", "ce_loss", "au_loss", "grad_norm"}
        assert a["grad_norm"] > MAX_NORM  # clipping bites
        for k in a:
            np.testing.assert_allclose(a[k], b[k], rtol=1e-4, err_msg=k)
    _assert_trees_close(pt, pj, atol=2e-5, rtol=1e-4)


def test_encoder_dropout_is_seeded_and_trains(setup):
    """The preset's encoder dropout 0.1: a step's masks come from the step's
    generator (the same seed repeats the step exactly, another seed does
    not, and either differs from the step without dropout); five
    constant-lr steps on one batch lower the loss."""
    _, _, _, tparams, arrays = setup
    cfg = v2_train_cfg(encoder_dropout=0.1, learning_rate=1e-3)
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, lr_schedule="constant"))
    assert tstep.host_sampling_p(cfg, 0) == 0.0
    _, m1 = _run_port(cfg, tparams, arrays, 1, seed=1)
    _, m1b = _run_port(cfg, tparams, arrays, 1, seed=1)
    _, m2 = _run_port(cfg, tparams, arrays, 1, seed=2)
    _, m0 = _run_port(v2_train_cfg(learning_rate=1e-3), tparams, arrays, 1, seed=1)
    assert m1 == m1b and m1[0]["loss"] != m2[0]["loss"] != m0[0]["loss"]
    _, m = _run_port(cfg, tparams, arrays, 5, seed=3)
    losses = [x["loss"] for x in m]
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses

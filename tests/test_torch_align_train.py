"""The training slice of the reference-dims AV-Align model (``lrs2_av_align``,
``configs.lrs2_full()``) against ``avsr_tpu``: the loss and every gradient
leaf, three optimizer steps, scheduled sampling and the decoder's dropout.

The config is ``test_torch_align_slice.small_align_cfg`` (hidden 32,
A = 8, decoder embedding 16) in fp32, train mode with dropout 0 and noise
off (torch's random draws cannot equal JAX's), AU targets on, label
smoothing 0.1, warmup-cosine with 2 warmup steps and a
``max_gradient_norm`` small enough that clipping bites; B = 4, 1 s of
audio, 8 labels (``test_torch_train.batch_arrays``).  Scheduled sampling is
compared at p = 0, and at p = 1 with the output bias of one unit raised by
100, so that both packages sample that unit at every step whatever their
random draws.

Tolerances: the loss at rtol 1e-5; each gradient leaf at a relative norm
error of 1e-4 (fp32 through 4 recurrent layers, the fusion scan and the
decoder loop; only summation order differs); parameters after the steps
at atol 2e-5 / rtol 1e-4 (Adam divides by sqrt(nu): a near-zero gradient
element's summation noise moves its update by a few 1e-6).  The coin rate
of scheduled sampling is held to 4.5 standard deviations of a binomial.

The loss and gradient checks and the three steps also run on
``lrs2_av_align_uni_luong`` (``test_torch_align_slice.UNI_LUONG``: one-
direction encoders, Luong reads in the fusion and the decoder), at the
same tolerances: the same fp32 arithmetic, only summation order differs.
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
from avsr_tpu_torch.configs import DecoderConfig as TDecoderConfig
from avsr_tpu_torch.data.units import GO_ID
from avsr_tpu_torch.models import decoder as tdec
from avsr_tpu_torch.models import seq2seq as tseq
from avsr_tpu_torch.ops import attention as tattn
from avsr_tpu_torch.train import optim as toptim
from avsr_tpu_torch.train import step as tstep
from avsr_tpu_torch.utils.params import tree_leaves, tree_map
from test_torch_align_slice import VARIANTS, small_align_cfg
from test_torch_train import _assert_trees_close, _by_path, _jbatch, batch_arrays

MAX_NORM = 0.5
UNIT = 7  # the unit whose output bias dominates in the p = 1 cases


@pytest.fixture(autouse=True)
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def align_train_cfg(p=0.0, ramp=0, decoder_dropout=0.0, variant="bahdanau", **train):
    base = small_align_cfg(variant=variant)
    nodrop = lambda c: dataclasses.replace(c, dropout_rate=0.0)  # noqa: E731
    return base.replace(
        audio_encoder=nodrop(base.audio_encoder), video_encoder=nodrop(base.video_encoder),
        decoder=dataclasses.replace(base.decoder, dropout_rate=decoder_dropout,
                                    sampling_probability=p, sampling_ramp_steps=ramp),
        train=dataclasses.replace(base.train, lr_schedule="warmup_cosine", warmup_steps=2,
                                  max_gradient_norm=MAX_NORM, label_smoothing=0.1,
                                  num_epochs=2, **train))


def _setup(variant):
    cfg = align_train_cfg(variant=variant)
    V = builtin_unit_dict(cfg.data.unit).vocab_size
    jparams = jseq.model_init(jax.random.PRNGKey(3), cfg, V)
    arrays = batch_arrays(0, V)
    tparams = convert.from_jax(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    return cfg, V, jparams, tparams, arrays


@pytest.fixture(scope="module")
def setup():
    return _setup("bahdanau")


@pytest.fixture(scope="module", params=VARIANTS)
def each_setup(request):
    """``setup`` for each AV-Align configuration the port serves."""
    return _setup(request.param)


def _grads_by_path(state, grads):
    it = iter(grads)
    return dict(tree_leaves(convert.to_jax_numpy(tree_map(lambda _: next(it), state.params))))


def _loss_and_grads_match(cfg, jparams, tparams, arrays):
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
    grads, want = _grads_by_path(state, g_t), _by_path(g_j)
    assert set(grads) == set(want)
    for k, w in want.items():
        err = np.linalg.norm(grads[k] - w) / np.linalg.norm(w)
        assert err < 1e-4, (k, err)
    return m_t, grads


def test_loss_and_every_gradient_leaf_match_jax(each_setup):
    """p = 0: pure teacher forcing through the fusion scan's and the
    decoder reads' hand-derived backward."""
    cfg, V, jparams, tparams, arrays = each_setup
    _, grads = _loss_and_grads_match(cfg, jparams, tparams, arrays)
    # the fusion cell, context projection and attention, the decoder's
    # attention and cell: every leaf of both recurrences takes a gradient
    # (Luong's attention is its lone wq)
    keys = [("fusion", "cell", "wh"), ("fusion", "ctx_proj"), ("fusion", "att", "wq"),
            ("decoder", "atts", 0, "wq"), ("decoder", "cells", 0, "wh"), ("decoder", "embedding"),
            ("audio_encoder", "layers", 2, "fwd", "wh"),
            ("video_encoder", "layers", 0, "fwd", "wx")]
    if cfg.fusion.attention_type == "bahdanau":
        keys += [("fusion", "att", "v"), ("fusion", "att", "wm"), ("decoder", "atts", 0, "v")]
    for k in keys:
        assert np.abs(grads[k]).max() > 0, k


def test_sampling_with_a_dominating_unit_matches_jax(each_setup):
    """p = 1 with ``out_b[UNIT] += 100``: both packages feed UNIT at every
    step after the first, so loss and gradients agree leaf for leaf."""
    cfg, V, jparams, _, arrays = each_setup
    cfg = cfg.replace(decoder=dataclasses.replace(cfg.decoder, sampling_probability=1.0))
    jparams = jax.tree_util.tree_map(lambda x: x, jparams)
    jparams["decoder"]["out_b"] = jparams["decoder"]["out_b"].at[UNIT].add(100.0)
    tparams = convert.from_jax(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    m_t, _ = _loss_and_grads_match(cfg, jparams, tparams, arrays)
    assert float(m_t["ce_loss"]) > 50.0  # the bias dominates the gold units


def _run_jax(cfg, jparams, arrays, steps):
    state, tx = jstep.create_train_state(jax.random.PRNGKey(0), cfg, 1)
    state = state._replace(params=jparams, opt_state=tx.init(jparams))
    fn = jax.jit(functools.partial(jstep.train_step, cfg=cfg, tx=tx))
    metrics = []
    for _ in range(steps):
        state, m = fn(state, _jbatch(arrays), jax.random.PRNGKey(7))
        metrics.append({k: float(v) for k, v in m.items()})
    return state.params, metrics


def _run_port(cfg, tparams, arrays, steps, step0=0, seed=7):
    opt, _ = toptim.build_optimizer(cfg.train)
    state = tstep.train_state_from_params(tparams, opt)._replace(step=step0)
    batch = tseq.batch_to_device(arrays, "cpu")
    metrics = []
    for _ in range(steps):
        state, m = tstep.train_step(state, batch, cfg=cfg, optimizer=opt,
                                    generator=torch.Generator().manual_seed(seed))
        metrics.append({k: float(v) for k, v in m.items()})
    assert state.step == step0 + steps
    return state.params, metrics


def test_three_train_steps_match_jax(each_setup):
    """Warmup-cosine (lr 0, then 5e-4, then 1e-3) with clipping on every
    step: metrics per step and the parameters after three updates."""
    cfg, V, jparams, tparams, arrays = each_setup
    pj, mj = _run_jax(cfg, jparams, arrays, 3)
    pt, mt = _run_port(cfg, tparams, arrays, 3)
    for a, b in zip(mt, mj):
        assert set(a) == set(b) == {"loss", "ce_loss", "au_loss", "grad_norm"}
        assert a["grad_norm"] > MAX_NORM  # clipping bites
        for k in a:
            np.testing.assert_allclose(a[k], b[k], rtol=1e-4, err_msg=k)
    _assert_trees_close(pt, pj, atol=2e-5, rtol=1e-4)


def test_eval_step_matches_jax(setup):
    cfg, V, jparams, tparams, arrays = setup
    cfg = cfg.replace(decoder=dataclasses.replace(cfg.decoder, sampling_probability=0.5,
                                                  dropout_rate=0.5))
    want = jax.jit(functools.partial(jstep.eval_step, cfg=cfg))(jparams, _jbatch(arrays))
    got = tstep.eval_step(tparams, tseq.batch_to_device(arrays, "cpu"), cfg=cfg)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5, err_msg=k)


def test_ramp_matches_endpoints(setup):
    """Mirror of tests/test_sampling_ramp.py::test_ramp_matches_endpoints:
    at step 0 the ramped p is 0 (the step equals a sampling-off step); at
    step >= ramp it equals the constant-p step, parameter for parameter."""
    _, _, _, tparams, arrays = setup
    ramp = 4
    _, m_ramp0 = _run_port(align_train_cfg(0.5, ramp), tparams, arrays, 1)
    _, m_off0 = _run_port(align_train_cfg(0.0, 0), tparams, arrays, 1)
    np.testing.assert_allclose(m_ramp0[0]["ce_loss"], m_off0[0]["ce_loss"], rtol=1e-6)
    p_ramp, m_ramp = _run_port(align_train_cfg(0.5, ramp), tparams, arrays, 1, step0=ramp)
    p_const, m_const = _run_port(align_train_cfg(0.5, 0), tparams, arrays, 1, step0=ramp)
    np.testing.assert_allclose(m_ramp[0]["ce_loss"], m_const[0]["ce_loss"], rtol=1e-6)
    for a, b in zip(tree_leaves(p_ramp), tree_leaves(p_const)):
        np.testing.assert_allclose(a[1].detach().numpy(), b[1].detach().numpy(), rtol=1e-6,
                                   atol=1e-6)
    # mid-ramp sampling feeds the model's own predictions: another loss
    _, m_mid = _run_port(align_train_cfg(0.5, ramp), tparams, arrays, 1, step0=ramp // 2)
    assert m_mid[0]["ce_loss"] != m_off0[0]["ce_loss"]


def test_host_sampling_p_mirror():
    """Mirror of tests/test_sampling_ramp.py::test_host_sampling_p_mirror,
    and equal to the reference's on the same configs."""
    cfg = align_train_cfg(0.5, ramp=10)
    assert tstep.host_sampling_p(cfg, 0) == 0.0
    assert tstep.host_sampling_p(cfg, 5) == 0.25
    assert tstep.host_sampling_p(cfg, 10) == 0.5
    assert tstep.host_sampling_p(cfg, 99) == 0.5
    assert tstep.host_sampling_p(align_train_cfg(0.5, 0), 7) == 0.5
    assert tstep.host_sampling_p(align_train_cfg(0.0, 0), 7) == 0.0
    for c in (cfg, align_train_cfg(0.3, 7), align_train_cfg(0.0, 3)):
        for s in (-2, 0, 3, 7, 50):
            assert tstep.host_sampling_p(c, s) == jstep.host_sampling_p(c, s)


# ---- the decoder loop itself -------------------------------------------------

CFG = TDecoderConfig(embedding_dim=8, hidden_units=(12, 10), attention_units=8)
V, S, M = 11, 7, 10


def _decoder(seed=1, B=3, K=6, dtype=torch.float32):
    gen = torch.Generator().manual_seed(seed)
    params = tdec.decoder_init(gen, CFG, [M], V, "cpu")
    memory = torch.randn((B, S, M), generator=gen)
    mem = tattn.prepare_memory("bahdanau", params["atts"][0], memory,
                               torch.tensor([S, 4, 0] + [S] * (B - 3)), dtype)
    targets = torch.randint(3, V, (B, K), generator=gen)
    return params, mem, targets, torch.full((B,), K)


def test_scheduled_sampling_edge_cases():
    """Mirror of tests/test_decoder.py::test_scheduled_sampling_edge_cases:
    p ~ 0 equals teacher forcing; at p = 1 the gold inputs are never read
    after step 0, so changing them changes nothing."""
    params, mem, targets, lengths = _decoder()
    base = tdec.teacher_forced_logits(params, CFG, targets, lengths, [mem], torch.float32)
    p0 = tdec.teacher_forced_logits(params, CFG, targets, lengths, [mem], torch.float32,
                                    generator=torch.Generator().manual_seed(2),
                                    sampling_probability=1e-9)
    np.testing.assert_allclose(base.numpy(), p0.numpy(), rtol=1e-5, atol=1e-5)

    def p1(tg):
        return tdec.teacher_forced_logits(params, CFG, tg, lengths, [mem], torch.float32,
                                          generator=torch.Generator().manual_seed(3),
                                          sampling_probability=1.0)

    targets_b = targets.clone()
    targets_b[:, 0] = (targets[:, 0] % (V - 3)) + 3
    targets_b[:, 1:-1] = 3
    np.testing.assert_allclose(p1(targets).numpy(), p1(targets_b).numpy(), rtol=1e-5, atol=1e-5)
    assert not np.allclose(p1(targets).numpy(), base.numpy())


def test_coin_rate_and_step_zero(monkeypatch):
    """A Bernoulli(p) coin per row per step after step 0: with one unit's
    output bias dominating, every coin that fires feeds that unit and gold
    never does, so the unit's share of the fed tokens estimates p (B = 256,
    8 coin steps: 2,048 coins; 4.5 standard deviations); step 0 always
    feeds GO."""
    p, B, K = 0.3, 256, 9
    params, mem, targets, lengths = _decoder(B=B, K=K)
    targets = torch.where(targets == UNIT, torch.full_like(targets, UNIT + 1), targets)
    params["out_b"][UNIT] = 100.0
    fed = []
    step = tdec.decoder_step

    def record(prm, cfg, tokens, *a, **kw):
        fed.append(tokens.clone())
        return step(prm, cfg, tokens, *a, **kw)

    monkeypatch.setattr(tdec, "decoder_step", record)
    with torch.no_grad():
        tdec.teacher_forced_logits(params, CFG, targets, lengths, [mem], torch.float32,
                                   generator=torch.Generator().manual_seed(5),
                                   sampling_probability=p)
    assert len(fed) == K and bool((fed[0] == GO_ID).all())
    later = torch.stack(fed[1:])
    rate = float((later == UNIT).float().mean())
    sd = (p * (1 - p) / later.numel()) ** 0.5
    assert abs(rate - p) < 4.5 * sd, (rate, sd)
    gold = targets[:, :-1].t()
    assert bool(((later == UNIT) | (later == gold)).all())


def test_dropout_keeps_the_undropped_state():
    """``decoder_step(..., dropout_masks=)``: each layer's output is
    multiplied by its mask on the way to the next layer, the reads and the
    output product; the state keeps the undropped h (``decoder.py:152-159``)."""
    params, mem, _, _ = _decoder()
    st0 = tdec.initial_state(CFG, 3, 4, torch.float32, "cpu", memory_dims=[M])
    tok = torch.full((3,), GO_ID)
    gen = torch.Generator().manual_seed(4)
    masks = [(torch.rand((3, h), generator=gen) < 0.5).float() * 2.0 for h in CFG.hidden_units]
    st_plain, lg_plain = tdec.decoder_step(params, CFG, tok, st0, [mem], None, torch.float32)
    st_drop, lg_drop = tdec.decoder_step(params, CFG, tok, st0, [mem], None, torch.float32,
                                         dropout_masks=masks)
    torch.testing.assert_close(st_drop.lstm[0], st_plain.lstm[0], rtol=0, atol=0)
    assert not torch.allclose(st_drop.lstm[1][0], st_plain.lstm[1][0])  # layer 2 saw dropped h
    assert not torch.allclose(lg_drop, lg_plain)


def test_decoder_dropout_only_in_training(setup):
    """Mirror of tests/test_properties.py::test_decoder_dropout_only_in_training
    with the RNN decoder: dropout 0.5 changes training logits between seeds
    and never eval logits."""
    _, _, _, tparams, arrays = setup
    cfg = align_train_cfg(decoder_dropout=0.5)
    batch = tseq.batch_to_device(arrays, "cpu")
    with torch.no_grad():
        e1, _ = tseq.forward(tparams, cfg, batch, train=False)
        e2, _ = tseq.forward(tparams, cfg, batch, train=False,
                             generator=torch.Generator().manual_seed(9))
        t1, _ = tseq.forward(tparams, cfg, batch, train=True,
                             generator=torch.Generator().manual_seed(3))
        t2, _ = tseq.forward(tparams, cfg, batch, train=True,
                             generator=torch.Generator().manual_seed(4))
    assert torch.equal(e1, e2)
    assert not torch.allclose(t1, t2)


def test_train_step_draws_are_seeded_and_the_loss_falls(setup):
    """With the preset's p = 0.1 and dropout 0.1 everywhere: the same seed
    repeats a step exactly, another seed does not; eight constant-lr steps
    on one batch lower the loss."""
    _, _, _, tparams, arrays = setup
    drop = lambda c: dataclasses.replace(c, dropout_rate=0.1)  # noqa: E731
    base = align_train_cfg(p=0.1, decoder_dropout=0.1, learning_rate=1e-3)
    cfg = base.replace(audio_encoder=drop(base.audio_encoder),
                       video_encoder=drop(base.video_encoder),
                       train=dataclasses.replace(base.train, lr_schedule="constant"))

    def first_loss(seed):
        return _run_port(cfg, tparams, arrays, 1, seed=seed)[1][0]["loss"]

    assert first_loss(1) == first_loss(1) != first_loss(2)
    _, metrics = _run_port(cfg, tparams, arrays, 8, seed=1)
    losses = [m["loss"] for m in metrics]
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses

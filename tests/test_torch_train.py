"""The training slice of the port against ``avsr_tpu.train``: the loss and
every gradient leaf, three optimizer steps, gradient accumulation, the
schedules and the optimizers.

The config is ``test_torch_slice.small_fast_cfg`` (the ``lrs2_av_fast``
structure at hidden 32) in fp32, train mode with dropout 0 and noise off
(torch's random draws cannot equal JAX's), AU targets on, label smoothing
0.1, warmup-cosine with 2 warmup steps and a ``max_gradient_norm`` small
enough that clipping bites; B = 4, 1 s of audio, 8 labels.

Tolerances: the loss at rtol 1e-5; each gradient leaf at a relative norm
error of 1e-4 (fp32 through a 4-layer recurrent stack; only summation
order differs); parameters after the steps at atol 2e-5 / rtol 1e-4 (Adam
divides by sqrt(nu): a near-zero gradient element's summation noise moves
its update by a few 1e-6, as ``tests/test_grad_accum.py`` notes).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avsr_tpu.configs import NoiseConfig, TrainConfig
from avsr_tpu.data.units import EOS_ID, builtin_unit_dict
from avsr_tpu.models import seq2seq as jseq
from avsr_tpu.train import optim as joptim
from avsr_tpu.train import step as jstep
from avsr_tpu_torch import convert
from avsr_tpu_torch.models import seq2seq as tseq
from avsr_tpu_torch.ops.noise import NoiseBank
from avsr_tpu_torch.train import optim as toptim
from avsr_tpu_torch.train import step as tstep
from avsr_tpu_torch.utils.params import tree_leaves, tree_map
from test_torch_slice import small_fast_cfg

MAX_NORM = 0.5


@pytest.fixture(autouse=True)
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def train_cfg(**train):
    base = small_fast_cfg()
    nodrop = lambda c: dataclasses.replace(c, dropout_rate=0.0)  # noqa: E731
    return base.replace(
        audio_encoder=nodrop(base.audio_encoder), video_encoder=nodrop(base.video_encoder),
        decoder=nodrop(base.decoder),
        train=dataclasses.replace(base.train, lr_schedule="warmup_cosine", warmup_steps=2,
                                  max_gradient_norm=MAX_NORM, label_smoothing=0.1,
                                  num_epochs=2, **train))


def batch_arrays(seed, V, B=4, S=16000, T_v=25, K=8):
    rng = np.random.default_rng(seed)
    a_len = rng.integers(S // 2, S + 1, B).astype(np.int32)
    a_len[0] = S
    audio = (0.3 * rng.standard_normal((B, S))).astype(np.float32)
    audio *= np.arange(S)[None, :] < a_len[:, None]
    v_len = np.minimum(np.ceil(a_len / S * T_v), T_v).astype(np.int32)
    v_len[-1] = 0  # an utterance with no video frame
    t_len = rng.integers(1, K + 1, B).astype(np.int32)
    targets = np.zeros((B, K), np.int32)
    for i, n in enumerate(t_len):
        targets[i, :n - 1] = rng.integers(3, V, n - 1)
        targets[i, n - 1] = EOS_ID
    return dict(
        audio=audio, audio_lengths=a_len,
        video=rng.uniform(0, 1, (B, T_v, 36, 36, 1)).astype(np.float32), video_lengths=v_len,
        targets=targets, target_lengths=t_len,
        au_targets=rng.standard_normal((B, 31, 2)).astype(np.float32),
        au_row_weights=np.array([1.0] * (B - 1) + [0.0], np.float32))


def _jbatch(arrays):
    return jseq.Batch(**{k: jnp.asarray(v) for k, v in arrays.items()})


def _leaf_key(path):
    return tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path)


def _by_path(jtree):
    return {_leaf_key(p): np.asarray(x)
            for p, x in jax.tree_util.tree_flatten_with_path(jtree)[0]}


def _assert_trees_close(ttree, jtree, **tol):
    want = _by_path(jtree)
    got = dict(tree_leaves(convert.to_jax_numpy(ttree)))
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, err_msg=str(k), **tol)


@pytest.fixture(scope="module")
def setup():
    cfg = train_cfg()
    V = builtin_unit_dict(cfg.data.unit).vocab_size
    jparams = jseq.model_init(jax.random.PRNGKey(3), cfg, V)
    arrays = batch_arrays(0, V)
    return cfg, V, jparams, convert.from_jax(jax.tree_util.tree_map(np.asarray, jparams)), arrays


def test_loss_and_every_gradient_leaf_match_jax(setup):
    cfg, V, jparams, tparams, arrays = setup
    lf = jax.jit(lambda p, b: jseq.loss_fn(p, cfg, b, train=True, rng=jax.random.PRNGKey(0)))
    (l_j, m_j), g_j = jax.value_and_grad(lf, has_aux=True)(jparams, _jbatch(arrays))
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
    assert set(grads) == set(want) and len(want) == 61
    for k, w in want.items():
        err = np.linalg.norm(grads[k] - w) / np.linalg.norm(w)
        assert err < 1e-4, (k, err)


def _run_jax(cfg, jparams, arrays, steps, accum=1):
    state, tx = jstep.create_train_state(jax.random.PRNGKey(0), cfg, 1)
    state = state._replace(params=jparams, opt_state=tx.init(jparams))
    fn = jax.jit(functools.partial(jstep.train_step, cfg=cfg, tx=tx, accum=accum))
    metrics = []
    for _ in range(steps):
        state, m = fn(state, _jbatch(arrays), jax.random.PRNGKey(7))
        metrics.append({k: float(v) for k, v in m.items()})
    return state.params, metrics


def _run_port(cfg, tparams, arrays, steps, accum=1):
    opt, _ = toptim.build_optimizer(cfg.train)
    state = tstep.train_state_from_params(tparams, opt)
    batch = tseq.batch_to_device(arrays, "cpu")
    metrics = []
    for _ in range(steps):
        state, m = tstep.train_step(state, batch, cfg=cfg, optimizer=opt,
                                    generator=torch.Generator().manual_seed(7), accum=accum)
        metrics.append({k: float(v) for k, v in m.items()})
    assert state.step == steps
    return state.params, metrics


def test_three_train_steps_match_jax(setup):
    """Warmup-cosine (lr 0, then 5e-4, then 1e-3) with clipping on every
    step: metrics per step and the parameters after three updates."""
    cfg, V, jparams, tparams, arrays = setup
    pj, mj = _run_jax(cfg, jparams, arrays, 3)
    pt, mt = _run_port(cfg, tparams, arrays, 3)
    for a, b in zip(mt, mj):
        assert set(a) == set(b) == {"loss", "ce_loss", "au_loss", "grad_norm"}
        assert a["grad_norm"] > MAX_NORM  # clipping bites
        for k in a:
            np.testing.assert_allclose(a[k], b[k], rtol=1e-4, err_msg=k)
    assert mt[1]["loss"] == pytest.approx(mt[0]["loss"], rel=1e-6)  # first step: lr 0
    _assert_trees_close(pt, pj, atol=2e-5, rtol=1e-4)


def test_accum2_matches_jax_accum2_and_accum1(setup):
    """Token-weighted accumulation over 2 micro-batches of unequal label
    counts: equal to JAX's accum=2 over two steps (AU loss on); without AU
    targets (the AU term's token weighting only approximates its frame
    normalization) its CE and updates equal the full-batch step's, as
    ``tests/test_grad_accum.py`` holds the reference."""
    cfg, V, jparams, tparams, arrays = setup
    pj, mj = _run_jax(cfg, jparams, arrays, 2, accum=2)
    pt, mt = _run_port(cfg, tparams, arrays, 2, accum=2)
    for a, b in zip(mt, mj):
        for k in b:
            np.testing.assert_allclose(a[k], b[k], rtol=1e-4, err_msg=k)
    _assert_trees_close(pt, pj, atol=2e-5, rtol=1e-4)

    no_au = {k: v for k, v in arrays.items() if not k.startswith("au_")}
    pt2, mt2 = _run_port(cfg, tparams, no_au, 2, accum=2)
    pt1, mt1 = _run_port(cfg, tparams, no_au, 2, accum=1)
    for a, b in zip(mt2, mt1):
        np.testing.assert_allclose(a["ce_loss"], b["ce_loss"], rtol=1e-5)
    for a, b in zip(tree_leaves(pt2), tree_leaves(pt1)):
        np.testing.assert_allclose(a[1].detach().numpy(), b[1].detach().numpy(),
                                   atol=2e-5, rtol=1e-4, err_msg=str(a[0]))


@pytest.mark.parametrize("kind", ["constant", "exponential", "cosine", "warmup_cosine"])
def test_schedules_match_reference(kind):
    cfg = TrainConfig(learning_rate=3e-4, lr_schedule=kind, lr_decay=0.1, warmup_steps=50,
                      num_epochs=3)
    sched = toptim.build_schedule(cfg, 100)
    ref = joptim.build_schedule(cfg, 100)
    for s in (0, 1, 49, 50, 99, 100, 150, 299, 5000):
        assert sched(s) == pytest.approx(joptim.host_schedule_value(cfg, s, 100), rel=1e-12)
        assert sched(s) == pytest.approx(float(ref(s)), rel=1e-5, abs=1e-10)  # optax: fp32


@pytest.mark.parametrize("kind", ["adam", "adamw", "sgd"])
def test_optimizer_updates_match_optax(kind):
    """Four updates of the port's optimizer against the reference's optax
    chain (clip by global norm, then the optimizer on its schedule) on the
    same gradients, clipping on some steps and not on others."""
    cfg = TrainConfig(optimizer=kind, learning_rate=1e-2, lr_schedule="warmup_cosine",
                      warmup_steps=2, max_gradient_norm=2.0, weight_decay=0.01, num_epochs=1)
    rng = np.random.default_rng(5)
    params = [rng.standard_normal(s).astype(np.float32) for s in ((3, 4), (5,), (2, 2, 2))]
    tx, _ = joptim.build_optimizer(cfg, 10)
    jp = [jnp.asarray(p) for p in params]
    jstate = tx.init(jp)
    opt, _ = toptim.build_optimizer(cfg, 10)
    tp = [torch.from_numpy(p.copy()) for p in params]
    tstate = opt.init(tp)
    for scale in (3.0, 0.1, 1.0, 0.2):
        grads = [scale * rng.standard_normal(p.shape).astype(np.float32) for p in params]
        upd, jstate = tx.update([jnp.asarray(g) for g in grads], jstate, jp)
        jp = [p + u for p, u in zip(jp, upd)]
        tstate = opt.update(tp, [torch.from_numpy(g) for g in grads], tstate)
        for a, b in zip(tp, jp):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-7)


def test_unported_optimizer_and_options_raise():
    with pytest.raises(ValueError, match="lamb"):
        toptim.build_optimizer(TrainConfig(optimizer="lamb"))
    with pytest.raises(ValueError, match="unknown lr schedule"):
        toptim.build_schedule(TrainConfig(lr_schedule="step"))


def test_eval_step_matches_jax(setup):
    cfg, V, jparams, tparams, arrays = setup
    want = jax.jit(functools.partial(jstep.eval_step, cfg=cfg))(jparams, _jbatch(arrays))
    got = tstep.eval_step(tparams, tseq.batch_to_device(arrays, "cpu"), cfg=cfg)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5, err_msg=k)


def test_train_step_draws_are_seeded_and_the_loss_falls(setup):
    """With dropout 0.1 and noise mixing on, a step's draws depend only on
    (seed, step): the same seed repeats the step exactly, another seed
    does not; and eight constant-lr steps on one batch lower the loss."""
    _, V, _, tparams, arrays = setup
    base = train_cfg(learning_rate=1e-3)
    drop = lambda c: dataclasses.replace(c, dropout_rate=0.1)  # noqa: E731
    cfg = base.replace(audio_encoder=drop(base.audio_encoder),
                       video_encoder=drop(base.video_encoder), decoder=drop(base.decoder),
                       noise=NoiseConfig(enabled=True),
                       train=dataclasses.replace(base.train, lr_schedule="constant"))
    rng = np.random.default_rng(9)
    bank = NoiseBank.create({"babble": rng.standard_normal((3, 20000)).astype(np.float32),
                             "cafe": rng.standard_normal((2, 18000)).astype(np.float32)})
    batch = tseq.batch_to_device(arrays, "cpu")
    opt, _ = toptim.build_optimizer(cfg.train)

    def first_loss(seed):
        st = tstep.train_state_from_params(tparams, opt)
        _, m = tstep.train_step(st, batch, cfg=cfg, optimizer=opt, noise_bank=bank,
                                generator=torch.Generator().manual_seed(seed))
        return float(m["loss"])

    assert first_loss(1) == first_loss(1) != first_loss(2)
    state = tstep.train_state_from_params(tparams, opt)
    losses = []
    for _ in range(8):
        state, m = tstep.train_step(state, batch, cfg=cfg, optimizer=opt, noise_bank=bank,
                                    generator=torch.Generator().manual_seed(1))
        losses.append(float(m["loss"]))
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses

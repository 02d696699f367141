"""The frontend's options (K3's option instances' plain twin), SpecAugment,
LAMB and ``attend_batched_queries`` against ``avsr_tpu``.

Every (feature_type, add_deltas, normalization) combination of
``logmel_frontend`` is held against the reference's at both DFT routes
(the matmul DFT, and ``use_matmul_dft=False``: ``torch.fft.rfft`` against
XLA's rfft), with the padding invariance of the global statistics;
SpecAugment's masks drawn on the host from a JAX key are held bit-equal to
the reference's; LAMB's updates and state against ``optax`` over several
steps (a zero leaf among the parameters); both attention scores of
``attend_batched_queries``; and an ``AVSR`` with the options trains,
checkpoints, restores and predicts on the CPU.

Inputs come from seeded numpy.  Tolerances: the features at atol 1e-3
(rtol 1e-4) of log-domain values of order 10 (fp32 powers summed in
another order; the rfft route's power is re^2 + im^2 here and |X|^2
there); LAMB at rtol 1e-5 (fp32 moments and norms); the attention at
rtol 1e-5, atol 1e-6 (fp32 policy).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from avsr_tpu.configs import AudioFrontendConfig
from avsr_tpu.ops import attention as jattn
from avsr_tpu.ops import audio_features as jaf
from avsr_tpu.ops.specaugment import spec_augment as jspec_augment
from avsr_tpu.train import optim as joptim
from avsr_tpu_torch import configs as tconfigs
from avsr_tpu_torch import convert, kernels
from avsr_tpu_torch.avsr import AVSR
from avsr_tpu_torch.configs import AudioFrontendConfig as TAudioFrontendConfig
from avsr_tpu_torch.configs import TrainConfig
from avsr_tpu_torch.models import seq2seq as tseq
from avsr_tpu_torch.ops import attention as tattn
from avsr_tpu_torch.ops import audio_features as taf
from avsr_tpu_torch.ops import specaugment as tsa
from avsr_tpu_torch.train import optim as toptim
from avsr_tpu_torch.utils import rng as trng
from avsr_tpu_torch.utils.params import tree_leaves
from test_torch_train import batch_arrays
from test_torch_trainer import synth, tiny_cfg

OPTIONS = [(ft, d, n) for ft in ("logmel", "spectrogram") for d in (True, False)
           for n in ("per_utterance", "global", "none")]


def _wavs(seed, B=3, S=7200):
    rng = np.random.default_rng(seed)
    wav = (0.3 * rng.standard_normal((B, S))).astype(np.float32)
    lengths = np.array([S, 5000, 300][:B], np.int32)  # the last: no full frame
    wav = wav * (np.arange(S)[None, :] < lengths[:, None])
    return wav.astype(np.float32), lengths


@pytest.mark.parametrize("matmul_dft", [True, False], ids=["matmul_dft", "rfft"])
@pytest.mark.parametrize("option", OPTIONS, ids=["-".join(map(str, o)) for o in OPTIONS])
def test_frontend_options_match_jax(option, matmul_dft):
    """``logmel_frontend`` at each option against the reference's: the
    features (D = 3M or M a frame, stacked; 257 bins for the spectrogram)
    and the lengths; padded frames exactly zero."""
    ft, deltas, norm = option
    kw = dict(feature_type=ft, add_deltas=deltas, normalization=norm,
              use_matmul_dft=matmul_dft)
    jcfg, tcfg = AudioFrontendConfig(**kw), TAudioFrontendConfig(**kw)
    wav, lengths = _wavs(OPTIONS.index(option))
    fj, nj = jaf.logmel_frontend(jnp.asarray(wav), jnp.asarray(lengths), jcfg)
    before = dict(kernels.LAUNCHES)
    ft_, nt = taf.logmel_frontend(torch.from_numpy(wav), torch.from_numpy(lengths), tcfg)
    assert kernels.LAUNCHES == before
    assert tuple(ft_.shape) == tuple(fj.shape)
    assert ft_.shape[-1] == tcfg.output_dim == jcfg.output_dim
    np.testing.assert_array_equal(nt.numpy(), np.asarray(nj))
    np.testing.assert_allclose(ft_.numpy(), np.asarray(fj), atol=1e-3, rtol=1e-4)
    for b in range(len(lengths)):
        assert bool((ft_[b, int(nt[b]):] == 0).all())


@pytest.mark.parametrize("deltas", [True, False], ids=["deltas", "static"])
def test_global_normalization_pad_invariant(deltas):
    """Mirror of tests/test_audio_frontend.py::test_global_normalization_pad_invariant:
    the global statistics run over valid frames only, so the same utterance
    in a longer bucket gives the same features; padded frames stay zero."""
    cfg = TAudioFrontendConfig(normalization="global", add_deltas=deltas)
    rng = np.random.default_rng(3)
    wav = rng.standard_normal(6000).astype(np.float32)
    w1 = np.zeros((1, 8000), np.float32)
    w1[0, :6000] = wav
    w2 = np.zeros((1, 12000), np.float32)
    w2[0, :6000] = wav
    lengths = torch.tensor([6000], dtype=torch.int32)
    f1, n1 = taf.logmel_frontend(torch.from_numpy(w1), lengths, cfg)
    f2, n2 = taf.logmel_frontend(torch.from_numpy(w2), lengths, cfg)
    T = int(n1[0])
    assert T == int(n2[0])
    np.testing.assert_allclose(f1[0, :T].numpy(), f2[0, :T].numpy(), rtol=1e-5, atol=1e-6)
    assert torch.all(f2[0, T:] == 0)


def test_option_instances_on_k3():
    """The spectrogram's banded matrix is the identity (a band of one bin of
    weight 1 a bin: K3's product is exact); the kernel wrapper refuses an
    unknown normalization and CPU tensors before counting a launch, and
    counts the option instances apart."""
    cfg = TAudioFrontendConfig(feature_type="spectrogram")
    band, weights = taf._mel_band(cfg, torch.device("cpu"))
    F = cfg.fft_length // 2 + 1
    assert tuple(band.shape) == (F, 3)
    assert torch.equal(band[:, 0], torch.arange(F, dtype=torch.int32))
    assert torch.equal(band[:, 1], torch.ones(F, dtype=torch.int32))
    assert torch.equal(weights, torch.ones(F))
    assert "logmel_post_dft_options" in kernels.LAUNCHES
    assert kernels.LOGMEL_NORMS == {"none": 0, "per_utterance": 1, "global": 2}
    B, T, M = 1, 10, 30
    before = dict(kernels.LAUNCHES)
    common = (torch.zeros(B, T, F), torch.zeros(B, T, F), torch.ones(B, dtype=torch.int32),
              torch.zeros(M, 3, dtype=torch.int32), torch.zeros(F * M))
    kw = dict(log_floor=1e-6, delta_window=2, stack=8, skip=3)
    with pytest.raises(ValueError, match="unknown normalization"):
        taf.logmel_frontend(torch.zeros(1, 800), torch.tensor([800]),
                            TAudioFrontendConfig(normalization="batch"))
    with pytest.raises(ValueError, match="expected a tensor on"):
        kernels.logmel_post_dft(*common, deltas=False, normalization="global", **kw)
    assert kernels.LAUNCHES == before
    # the writer's shared memory without deltas: no Δ staging, no halo
    assert kernels.logmel_writer_smem(257, 16, 8, 3, 2, deltas=False) == \
        4 * (257 * 53 + 53 * 257 + 2 * 257)
    assert kernels.logmel_writer_smem(30, 16, 8, 3, 2) == \
        4 * (2 * 30 * 61 + 53 * 90 + 180)


# ---------------------------------------------------------------------------
# SpecAugment
# ---------------------------------------------------------------------------


def test_randint_per_row_matches_jax():
    """``utils/rng.py``'s host ``randint32`` of shape (n,) with a per-row
    maxval, bit for bit as ``jax.random.randint``."""
    for seed, n in ((0, 5), (7, 1), (123, 64)):
        key = jax.random.PRNGKey(seed)
        words = tuple(np.asarray(jax.random.key_data(key), np.uint32))
        maxval = np.random.default_rng(seed).integers(-3, 300, n).astype(np.int32)
        want = jax.random.randint(key, (n,), 0, jnp.asarray(maxval))
        np.testing.assert_array_equal(trng.randint32(words, 0, maxval, n), np.asarray(want))
        want = jax.random.randint(key, (n, 1), 0, 70000)
        np.testing.assert_array_equal(trng.randint32(words, 0, 70000, n),
                                      np.asarray(want)[:, 0])
    words = tuple(np.asarray(jax.random.key_data(jax.random.PRNGKey(3)), np.uint32))
    assert int(trng.randint32(words, 0, 10)) == int(jax.random.randint(
        jax.random.PRNGKey(3), (), 0, 10))


@pytest.mark.parametrize("seed", [0, 1, 5])
def test_spec_augment_masks_match_jax(seed):
    """Mirror of tests/test_specaugment.py: the masks the host draws from a
    JAX key (time masks first, then frequency masks; widths 0..W inclusive;
    time starts inside each utterance's valid frames) equal the reference's
    bit for bit, and applying them gives its features."""
    B, T, D = 4, 40, 16
    rng = np.random.default_rng(seed)
    feat = rng.standard_normal((B, T, D)).astype(np.float32)
    lengths = np.array([40, 30, 5, 1], np.int32)
    kw = dict(num_time_masks=2, time_mask_width=8, num_freq_masks=2, freq_mask_width=4)
    key = jax.random.PRNGKey(seed)
    ones = np.asarray(jspec_augment(key, jnp.ones((B, T, D)), jnp.asarray(lengths), **kw))
    want = np.asarray(jspec_augment(key, jnp.asarray(feat), jnp.asarray(lengths), **kw))
    keep_t, keep_d = tsa.spec_augment_masks_from_key(
        tuple(np.asarray(jax.random.key_data(key), np.uint32)), lengths, T, D, **kw)
    np.testing.assert_array_equal(keep_t[:, :, None] * keep_d[:, None, :], ones)
    got = tsa.apply_masks(torch.from_numpy(feat), torch.from_numpy(keep_t),
                          torch.from_numpy(keep_d))
    np.testing.assert_array_equal(got.numpy(), want)


def test_spec_augment_generator_draws():
    """The training path's draws from a ``torch.Generator``: deterministic
    per seed, spans of at most W frames / channels, time spans starting
    inside each utterance's valid frames; the 0/1 masks leave the other
    values exactly as they were."""
    B, T, D = 64, 50, 20
    feat = torch.ones((B, T, D))
    lengths = torch.randint(1, T + 1, (B,), generator=torch.Generator().manual_seed(0))
    kw = dict(num_time_masks=1, time_mask_width=6, num_freq_masks=1, freq_mask_width=5)
    a = tsa.spec_augment(torch.Generator().manual_seed(1), feat, lengths, **kw)
    b = tsa.spec_augment(torch.Generator().manual_seed(1), feat, lengths, **kw)
    c = tsa.spec_augment(torch.Generator().manual_seed(2), feat, lengths, **kw)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert set(torch.unique(a).tolist()) <= {0.0, 1.0}
    time_masked = (a == 0).all(dim=2)       # [B, T]: whole frames zeroed
    freq_masked = (a == 0).all(dim=1)       # [B, D]: whole channels zeroed
    for r in range(B):
        t_idx = torch.nonzero(time_masked[r]).flatten()
        if len(t_idx):
            assert len(t_idx) <= 6 and int(t_idx[0]) < max(int(lengths[r]) - 1, 1)
            assert int(t_idx[-1]) - int(t_idx[0]) + 1 == len(t_idx)
        assert int(freq_masked[r].sum()) <= 5
    assert bool(time_masked.any()) and bool(freq_masked.any())


def test_spec_augment_in_train_encode_only():
    """``cfg.audio.spec_augment`` masks the features in a train-mode encode
    (drawn from the step's generator), never in eval mode."""
    cfg = tiny_cfg(tconfigs).override({"audio.spec_augment": True, "audio.time_masks": 1,
                                       "audio.time_mask_width": 4, "audio.freq_masks": 1,
                                       "audio.freq_mask_width": 2})
    V = 44
    params = tseq.model_init(cfg, V, torch.Generator().manual_seed(0), "cpu")
    batch = tseq.batch_to_device(batch_arrays(0, V), "cpu")
    with torch.no_grad():
        e1 = tseq.encode(params, cfg, batch).memories[0].values
        e2 = tseq.encode(params, cfg, batch).memories[0].values
        t1 = tseq.encode(params, cfg, batch, train=True,
                         generator=torch.Generator().manual_seed(1)).memories[0].values
        t2 = tseq.encode(params, cfg, batch, train=True,
                         generator=torch.Generator().manual_seed(2)).memories[0].values
    assert torch.equal(e1, e2) and not torch.equal(t1, t2)


# ---------------------------------------------------------------------------
# LAMB
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("clip", [0.0, 1.0], ids=["no_clip", "clip"])
def test_lamb_matches_optax(clip):
    """``Optimizer("lamb")`` against the reference's optax chain (global-norm
    clip, then ``optax.lamb``: Adam at eps 1e-6, decayed weights, the trust
    ratio, the schedule) over five steps: parameters and the mu / nu
    moments; a leaf of zeros (param norm 0: trust ratio 1) among them."""
    cfg = TrainConfig(optimizer="lamb", learning_rate=3e-2, weight_decay=1e-2,
                      max_gradient_norm=clip, lr_schedule="warmup_cosine", warmup_steps=2,
                      num_epochs=1)
    tx, _ = joptim.build_optimizer(cfg, steps_per_epoch=10)
    opt, _ = toptim.build_optimizer(TrainConfig(**dataclasses.asdict(cfg)), steps_per_epoch=10)
    rng = np.random.default_rng(4)
    shapes = [(3, 4), (5,), (2, 2, 3)]
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes] + \
        [np.zeros((4,), np.float32)]
    jp = [jnp.asarray(p) for p in params]
    jstate = tx.init(jp)
    tp = [torch.from_numpy(p.copy()) for p in params]
    tstate = opt.init(tp)
    for step in range(5):
        grads = [(2.0 * rng.standard_normal(p.shape)).astype(np.float32) for p in params]
        upd, jstate = tx.update([jnp.asarray(g) for g in grads], jstate, jp)
        jp = optax.apply_updates(jp, upd)
        tstate = opt.update(tp, [torch.from_numpy(g) for g in grads], tstate)
        for a, b in zip(tp, jp):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-7)
    adam = [s for s in jax.tree_util.tree_leaves(
        jstate, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)][0]
    assert tstate["count"] == int(adam.count) == 5
    for name in ("mu", "nu"):
        for a, b in zip(tstate[name], getattr(adam, name)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-9)


def test_lamb_trust_ratio_guards_zero_norms():
    """The trust ratio is 1 where the parameter's or the update's norm is 0,
    else ||param|| / ||update||."""
    p = [torch.zeros(3), torch.ones(4), torch.full((2,), 3.0)]
    u = [torch.ones(3), torch.zeros(4), torch.full((2,), 4.0)]
    r = toptim.Optimizer.trust_ratios(p, u)
    assert [float(x) for x in r] == [1.0, 1.0, 0.75]


# ---------------------------------------------------------------------------
# attend_batched_queries
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("att_type", ["bahdanau", "luong"])
def test_attend_batched_queries_matches_jax(att_type):
    """Mirror of tests/test_attention.py::test_batched_queries_match_single
    for both scores: the contexts and weights of every query of [B, T, Q]
    against the reference's, a memory row with 2 of 5 valid positions and
    an empty one (its weights and context 0)."""
    rng = np.random.default_rng(2)
    B, S, T, H, Q, A = 3, 5, 4, 6, 4, 7
    jp = jattn.attention_init(att_type, jax.random.PRNGKey(2), Q, H, A)
    memory = rng.standard_normal((B, S, H)).astype(np.float32)
    lengths = np.array([5, 2, 0], np.int32)
    queries = rng.standard_normal((B, T, Q)).astype(np.float32)
    jmem = jattn.prepare_memory(att_type, jp, jnp.asarray(memory), jnp.asarray(lengths),
                                compute_dtype=jnp.float32)
    cj, wj = jattn.attend_batched_queries(att_type, jp, jnp.asarray(queries), jmem,
                                          compute_dtype=jnp.float32)
    tp = convert.from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    tmem = tattn.prepare_memory(att_type, tp, torch.from_numpy(memory),
                                torch.from_numpy(lengths), torch.float32)
    ct, wt = tattn.attend_batched_queries(att_type, tp, torch.from_numpy(queries), tmem,
                                          torch.float32)
    assert tuple(ct.shape) == (B, T, H) and tuple(wt.shape) == (B, T, S)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(wt.numpy(), np.asarray(wj), rtol=1e-5, atol=1e-6)
    assert float(wt[2].abs().max()) == 0.0 and float(wt[1, :, 2:].abs().max()) == 0.0


# ---------------------------------------------------------------------------
# the options through the API
# ---------------------------------------------------------------------------


def test_avsr_with_the_options_trains_checkpoints_restores_and_predicts(tmp_path):
    """``AVSR`` with the spectrogram, no deltas, global normalization,
    SpecAugment and LAMB (chip_smoke.spectrogram_cfg()'s options) on the
    CPU: an epoch with a checkpoint, a new ``AVSR`` over the run directory
    that restores it (LAMB's state is Adam's mu / nu / count), and a
    prediction."""
    data = synth(n=8)
    cfg = tiny_cfg(tconfigs).override({
        "audio.feature_type": "spectrogram", "audio.add_deltas": False,
        "audio.normalization": "global", "audio.spec_augment": True,
        "audio.time_mask_width": 3, "audio.freq_mask_width": 4,
        "train.optimizer": "lamb", "train.weight_decay": 1e-4})
    run = str(tmp_path / "run")
    a = AVSR(config=cfg, run_dir=run, train_utterances=data, eval_utterances=data,
             device="cpu")
    layer0 = a.trainer.state.params["audio_encoder"]["layers"][0]["fwd"]
    assert tuple(layer0["wx"].shape) == ((cfg.audio.fft_length // 2 + 1) * 3, 64)
    a.train(num_epochs=1)
    step = int(a.trainer.state.step)
    assert step >= 2 and a.trainer.ckpt.latest_step() == step
    assert set(a.trainer.state.opt_state) == {"count", "mu", "nu"}
    b = AVSR(config=cfg, run_dir=run, train_utterances=data, eval_utterances=data,
             device="cpu")
    assert b.trainer.restore_checkpoint() == step
    for (p, x), (_, y) in zip(tree_leaves(a.trainer.state.params),
                              tree_leaves(b.trainer.state.params)):
        assert torch.equal(x, y), p
    for x, y in zip(a.trainer.state.opt_state["nu"], b.trainer.state.opt_state["nu"]):
        assert torch.equal(x, y)
    out = b.predict(data[:2])
    assert [u for u, _ in out] == [u.uid for u in data[:2]]

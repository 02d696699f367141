"""The reference's audio-only, video-only and bimodal regimes: ``avsr_tpu``
against the PyTorch port on the same converted weights and the same
request.

Each regime is its preset (``audio_tcdtimit``, ``video_tcdtimit``, the same
with ``video.use_au_features`` at au_dim 17, ``bimodal_tcdtimit``, and
``bimodal_tcdtimit`` with ``decoder_type="transformer"``: two memories
zipped with the cross keys) at small widths: a 2-layer BiLSTM audio encoder
of 32 (the presets' 3 layers of 256 cut), a 1-layer video encoder of 32,
a 1-layer decoder of 32 with A = 8 and embedding 16 (the transformer
decoder 4 heads), beam width 3, horizon 12, B = 2, 1 s of audio, fp32,
dropout 0.  Checked per regime: the memories (values and keys) at atol /
rtol 1e-4, as ``tests/test_torch_align_slice.py`` states that tolerance;
beam ids, lengths, steps and transcripts through ``Predictor`` identical,
scores within 1e-4; greedy ids and lengths identical; the train-mode loss
at rtol 1e-5 and every gradient leaf at a relative norm error of 1e-4, as
``tests/test_torch_align_train.py`` states them; ``loss_given_encode`` on
the encode equal to ``loss_fn``, in both packages.  The full-width trees of
the three presets (and the AU variant): keys, shapes and dtypes equal to
the JAX package's, the parameter counts, and the round trip through
``convert`` bit-exact.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avsr_tpu import configs
from avsr_tpu.configs import DecodeConfig
from avsr_tpu.data.units import builtin_unit_dict
from avsr_tpu.decode.beam import beam_search as jbeam
from avsr_tpu.decode.greedy import greedy_decode as jgreedy
from avsr_tpu.models import seq2seq as jseq
from avsr_tpu_torch import configs as tconfigs
from avsr_tpu_torch import convert
from avsr_tpu_torch.decode.greedy import greedy_decode as tgreedy
from avsr_tpu_torch.models import seq2seq as tseq
from avsr_tpu_torch.serve import Predictor, input_signature
from avsr_tpu_torch.train import optim as toptim
from avsr_tpu_torch.train import step as tstep
from avsr_tpu_torch.utils.params import param_count, tree_leaves, tree_map
from tests.test_torch_convert import _paths
from tests.test_torch_slice import _request
from tests.test_torch_train import _by_path

REGIMES = ("audio", "video", "video_au", "bimodal", "bimodal_transformer")
PRESET = {"audio": "audio_tcdtimit", "video": "video_tcdtimit", "video_au": "video_tcdtimit",
          "bimodal": "bimodal_tcdtimit", "bimodal_transformer": "bimodal_tcdtimit"}
AU_DIM = 17


@pytest.fixture(autouse=True)
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def small_regime_cfg(regime, beam_width=3, horizon=12):
    base = configs.PRESETS[PRESET[regime]]()
    nodrop = dict(dropout_rate=0.0)
    dec = dict(hidden_units=(32,), embedding_dim=16, attention_units=8,
               max_label_length=horizon, dropout_rate=0.0)
    if regime == "bimodal_transformer":
        dec.update(decoder_type="transformer", num_heads=4)
    video = base.video
    if regime == "video_au":
        video = dataclasses.replace(video, use_au_features=True, au_dim=AU_DIM)
    return base.replace(
        audio_encoder=dataclasses.replace(base.audio_encoder, hidden_units=(32, 32), **nodrop),
        video_encoder=dataclasses.replace(base.video_encoder, hidden_units=(32,), **nodrop),
        video=video,
        decoder=dataclasses.replace(base.decoder, **dec),
        decode=DecodeConfig(beam_width=beam_width, max_decode_length=horizon),
        train=dataclasses.replace(base.train, compute_dtype="float32"),
    )


def regime_request(regime, rng, n):
    """The request's audio and video lists; None for a modality the
    architecture does not read (AU video as [T_v, AU_DIM] intensities)."""
    audio, video = _request(rng, n)
    if regime == "video_au":
        video = [rng.uniform(0, 3, (len(v), AU_DIM)).astype(np.float32) for v in video]
    if regime == "audio":
        video = None
    if regime in ("video", "video_au"):
        audio = None
    return audio, video


def _jbatch(arrays):
    return jseq.Batch(**{k: jnp.asarray(v) for k, v in arrays.items()})


def _with_targets(arrays, V, seed):
    rng = np.random.default_rng(seed)
    B = next(iter(arrays.values())).shape[0]
    t_len = np.array([5, 3][:B] + [1] * max(B - 2, 0), np.int32)
    targets = np.zeros((B, 6), np.int32)
    for i, n in enumerate(t_len):
        targets[i, :n - 1] = rng.integers(3, V, n - 1)
        targets[i, n - 1] = 2  # EOS
    return dict(arrays, targets=targets, target_lengths=t_len)


@pytest.fixture(scope="module", params=REGIMES)
def regime_run(request):
    regime = request.param
    cfg = small_regime_cfg(regime)
    units = builtin_unit_dict(cfg.data.unit)
    V = units.vocab_size
    jparams = jseq.model_init(jax.random.PRNGKey(21), cfg, V)
    tparams = convert.from_jax(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    pred = Predictor(tparams, cfg, units, device="cpu", batch_size=2, audio_seconds=1.0)
    audio, video = regime_request(regime, np.random.default_rng(21), 2)
    arrays, n = pred.assemble(audio, video)
    enc_j = jseq.encode(jparams, cfg, _jbatch(arrays))
    res_j = jbeam(jparams["decoder"], cfg.decoder, enc_j.memories, cfg.decode.max_decode_length,
                  beam_width=cfg.decode.beam_width, compute_dtype=jnp.float32)
    greedy_j = jgreedy(jparams["decoder"], cfg.decoder, enc_j.memories, 12,
                       compute_dtype=jnp.float32)
    enc_t = pred.encode(arrays)
    return dict(regime=regime, cfg=cfg, V=V, pred=pred, arrays=arrays, jparams=jparams,
                tparams=tparams, enc_j=enc_j, res_j=res_j, greedy_j=greedy_j, enc_t=enc_t,
                res_t=pred.beam(enc_t), texts=pred.transcribe(audio=audio, video=video),
                greedy_t=tgreedy(tparams["decoder"], cfg.decoder, enc_t.memories, 12,
                                 cdt=torch.float32), n=n)


def test_request_reads_only_the_architectures_modalities(regime_run):
    regime, arrays = regime_run["regime"], regime_run["arrays"]
    want = {"audio": {"audio"}, "video": {"video"}, "video_au": {"video"}}.get(
        regime, {"audio", "video"})
    assert {k for k in arrays if not k.endswith("_lengths")} == want
    if regime == "video_au":
        assert arrays["video"].dtype == np.float32 and arrays["video"].shape == (2, 25, AU_DIM)


def test_memories_match(regime_run):
    mj, mt = regime_run["enc_j"].memories, regime_run["enc_t"].memories
    assert len(mt) == len(mj) == (2 if regime_run["regime"].startswith("bimodal") else 1)
    for a, b in zip(mt, mj):
        assert tuple(a.values.shape) == b.values.shape and a.values.shape[-1] == 64
        for name in ("values", "keys"):
            x, y = getattr(a, name), getattr(b, name)
            if x is None:  # a value-only memory: the port keeps no keys
                assert regime_run["cfg"].decoder.decoder_type == "transformer"
                continue
            np.testing.assert_allclose(x.numpy(), np.asarray(y), atol=1e-4, rtol=1e-4)
        np.testing.assert_array_equal(a.mask.numpy(), np.asarray(b.mask))
        np.testing.assert_array_equal(a.bias.numpy(), np.asarray(b.bias))


def test_beam_ids_steps_and_scores_match(regime_run):
    rj, rt = regime_run["res_j"], regime_run["res_t"]
    np.testing.assert_array_equal(rt.ids.numpy(), np.asarray(rj.ids))
    np.testing.assert_array_equal(rt.lengths.numpy(), np.asarray(rj.lengths))
    assert rt.steps == int(rj.steps)
    np.testing.assert_allclose(rt.scores.numpy(), np.asarray(rj.scores), atol=1e-4, rtol=0)


def test_transcripts_match(regime_run):
    pred, ids = regime_run["pred"], np.asarray(regime_run["res_j"].ids)
    assert regime_run["texts"] == [pred.decode_ids(ids[i]) for i in range(regime_run["n"])]


def test_greedy_ids_and_lengths_match(regime_run):
    ids_j, len_j = regime_run["greedy_j"]
    res = regime_run["greedy_t"]
    np.testing.assert_array_equal(res.ids.numpy(), np.asarray(ids_j))
    np.testing.assert_array_equal(res.lengths.numpy(), np.asarray(len_j))


def test_loss_given_encode_equals_loss_fn(regime_run):
    """Eval mode: the loss from the encode already made equals ``loss_fn``'s,
    and the JAX package's."""
    cfg, arrays = regime_run["cfg"], _with_targets(regime_run["arrays"], regime_run["V"], 3)
    batch = tseq.batch_to_device(arrays, "cpu")
    with torch.no_grad():
        l_fn, m_fn = tseq.loss_fn(regime_run["tparams"], cfg, batch, train=False)
        enc = tseq.encode(regime_run["tparams"], cfg, batch)
        l_ge, m_ge = tseq.loss_given_encode(regime_run["tparams"], cfg, batch, enc)
    assert set(m_fn) == set(m_ge) == {"ce_loss", "loss"}
    assert float(l_ge) == float(l_fn)
    jb = _jbatch(arrays)
    l_j, _ = jseq.loss_given_encode(regime_run["jparams"], cfg, jb,
                                    jseq.encode(regime_run["jparams"], cfg, jb))
    np.testing.assert_allclose(float(l_ge), float(l_j), rtol=1e-5)


def test_loss_and_every_gradient_leaf_match_jax(regime_run):
    cfg, V = regime_run["cfg"], regime_run["V"]
    arrays = _with_targets(regime_run["arrays"], V, 4)
    lf = jax.jit(lambda p, b: jseq.loss_fn(p, cfg, b, train=True, rng=jax.random.PRNGKey(0)))
    (_, m_j), g_j = jax.value_and_grad(lf, has_aux=True)(regime_run["jparams"], _jbatch(arrays))
    opt, _ = toptim.build_optimizer(cfg.train)
    tparams = tree_map(lambda t: t.clone(), regime_run["tparams"])
    state = tstep.train_state_from_params(tparams, opt)
    m_t, g_t = tstep.loss_and_grads(state.params, tseq.batch_to_device(arrays, "cpu"), cfg=cfg,
                                    generator=torch.Generator().manual_seed(0))
    assert set(m_t) == {"loss", "ce_loss"}
    for k in m_t:
        np.testing.assert_allclose(float(m_t[k]), float(m_j[k]), rtol=1e-5, err_msg=k)
    assert all(g is not None for g in g_t)
    it = iter(g_t)
    grads = dict(tree_leaves(convert.to_jax_numpy(tree_map(lambda _: next(it), state.params))))
    want = _by_path(g_j)
    assert set(grads) == set(want)
    for k, w in want.items():
        err = np.linalg.norm(grads[k] - w) / max(np.linalg.norm(w), 1e-30)
        assert err < 1e-4, (k, err)
        assert np.abs(grads[k]).max() > 0, k


def test_predictor_requires_the_architectures_modalities(regime_run):
    pred, regime = regime_run["pred"], regime_run["regime"]
    audio, video = regime_request(regime, np.random.default_rng(5), 1)
    if audio is not None:
        with pytest.raises(ValueError, match="needs audio"):
            pred.assemble(None, video)
    if video is not None:
        with pytest.raises(ValueError, match="needs video"):
            pred.assemble(audio, None)
    # a modality the architecture does not read is ignored, as the JAX
    # package's Predictor ignores it
    other_audio, other_video = _request(np.random.default_rng(5), 1)
    arrays, n = pred.assemble(audio if audio is not None else other_audio,
                              video if video is not None else other_video)
    assert n == 1 and set(arrays) == set(regime_run["arrays"])


# ---------------------------------------------------------------------------
# full width
# ---------------------------------------------------------------------------

FULL = {"audio_tcdtimit": {}, "video_tcdtimit": {}, "bimodal_tcdtimit": {},
        "video_tcdtimit_au": {"video.use_au_features": True}}
COUNTS = {"audio_tcdtimit": 6_195_487, "video_tcdtimit": 1_941_663,
          "bimodal_tcdtimit": 7_730_975, "video_tcdtimit_au": 1_833_631}


def _full(name):
    over = FULL[name]
    preset = name.replace("_au", "")
    cfg, tcfg = configs.PRESETS[preset](), tconfigs.PRESETS[preset]()
    if over:
        cfg, tcfg = cfg.override(over), tcfg.override(over)
    vocab = builtin_unit_dict(cfg.data.unit).vocab_size
    shapes = jax.eval_shape(lambda k: jseq.model_init(k, cfg, vocab), jax.random.PRNGKey(0))
    return tcfg, vocab, shapes


@pytest.mark.parametrize("name", sorted(FULL))
def test_full_width_model_init_matches_jax_tree(name):
    cfg, vocab, shapes = _full(name)
    params = tseq.model_init(cfg, vocab, torch.Generator().manual_seed(0), "cpu")
    got = dict(tree_leaves(convert.to_jax_numpy(params)))
    want = _by_path(jax.tree_util.tree_map(lambda s: np.zeros((), s.dtype), shapes))
    assert _paths(convert.to_jax_numpy(params)) == _paths(shapes)
    flat = dict(zip(want, jax.tree_util.tree_leaves(shapes)))
    for k, s in flat.items():
        assert got[k].shape == s.shape and got[k].dtype == s.dtype, k
    assert param_count(params) == COUNTS[name]
    assert tseq.memory_dims_of(cfg) == {"bimodal_tcdtimit": [512, 512]}.get(name, [512])
    if name == "video_tcdtimit_au":
        assert list(params["video_frontend"]) == ["au_proj", "au_bias"]
        assert tuple(params["video_frontend"]["au_proj"].shape) == (2, 128)


@pytest.mark.parametrize("name", sorted(FULL))
def test_full_width_round_trip_is_bit_exact(name):
    _, _, shapes = _full(name)
    rng = np.random.default_rng(1)
    tree = jax.tree_util.tree_map(lambda s: rng.standard_normal(s.shape).astype(s.dtype), shapes)
    back = convert.to_jax_numpy(convert.from_jax(tree, device="cpu"))
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(tree)
    for a, b in zip(jax.tree_util.tree_leaves(tree), jax.tree_util.tree_leaves(back)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", sorted(configs.PRESETS))
def test_every_preset_is_accepted(name):
    """``model_init`` and ``memory_dims_of`` take all eight presets, and the
    request signature names the inputs the JAX package's does."""
    from avsr_tpu.serve import _input_signature

    cfg, jcfg = tconfigs.PRESETS[name](), configs.PRESETS[name]()
    vocab = builtin_unit_dict(cfg.data.unit).vocab_size
    shapes = jax.eval_shape(lambda k: jseq.model_init(k, jcfg, vocab), jax.random.PRNGKey(0))
    assert tseq.memory_dims_of(cfg) == jseq.memory_dims_of(jcfg)
    n = sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes))
    assert param_count(tseq.model_init(cfg, vocab, torch.Generator().manual_seed(0), "cpu")) == n
    for transfer in ("compact", "float32"):
        assert input_signature(cfg, 8, 6.0, None, transfer) == [
            (nm, tuple(sh), dt) for nm, sh, dt in _input_signature(jcfg, 8, 6.0, None, transfer)]

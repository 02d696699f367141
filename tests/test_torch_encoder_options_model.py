"""The encoder's cell options in whole models against ``avsr_tpu``, and their
parameter trees through the port's conversions, checkpoints, serving
artifacts and the ``AVSR`` API (the scans and the encoder stack are
``test_torch_encoder_options.py``'s).

The models are ``lrs2_av_align`` (``test_torch_align_slice.small_align_cfg``:
hidden 32, A = 8, decoder embedding 16, fp32) with the two option sets the
card trains and serves: recurrent dropout 0.2 in both encoders and residual
audio layers (``RD_RESIDUAL``), and GRU cells in both encoders with highway
audio layers (``GRU_HIGHWAY``); dropout, scheduled sampling and noise off
(torch's random draws cannot equal JAX's), the recurrent dropout masks
injected into both packages by patching each package's ``_rd_masks``.
Tolerances: the loss at rtol 1e-4, each gradient leaf at a relative norm
error of 1e-4 (fp32 through 4 recurrent layers, the fusion scan and the
decoder loop; only summation order differs), beam ids and steps equal;
the trees' round trips bit-exact.
"""

import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avsr_tpu import serve as jserve
from avsr_tpu.data.units import builtin_unit_dict
from avsr_tpu.decode.beam import beam_search as jbeam
from avsr_tpu.models import seq2seq as jseq
from avsr_tpu_torch import configs as tconfigs
from avsr_tpu_torch import convert, kernels
from avsr_tpu_torch import serve as tserve
from avsr_tpu_torch.avsr import AVSR
from avsr_tpu_torch.data.units import builtin_unit_dict as tbuiltin
from avsr_tpu_torch.models import seq2seq as tseq
from avsr_tpu_torch.serve import Predictor
from avsr_tpu_torch.train import optim as toptim
from avsr_tpu_torch.train import step as tstep
from avsr_tpu_torch.train.checkpoint import CheckpointManager, params_to_numpy
from avsr_tpu_torch.utils.params import tree_leaves, tree_map
from test_torch_align_slice import small_align_cfg
from test_torch_encoder_options import _inject
from test_torch_slice import _request
from test_torch_train import _by_path, _jbatch, batch_arrays
from test_torch_trainer import synth

LOSS_RTOL = GRAD_REL_TOL = 1e-4

# the two configurations the card trains and serves (chip_smoke.rd_residual_cfg
# and gru_highway_cfg), applied to the lrs2_av_align preset
RD_RESIDUAL = {"audio_encoder.recurrent_dropout_rate": 0.2,
               "video_encoder.recurrent_dropout_rate": 0.2, "audio_encoder.residual": True,
               "name": "lrs2_av_align_rd_residual"}
GRU_HIGHWAY = {"audio_encoder.cell_type": "gru", "video_encoder.cell_type": "gru",
               "audio_encoder.highway": True, "name": "lrs2_av_align_gru_highway"}


@pytest.fixture(autouse=True)
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _model_cfg(over):
    base = small_align_cfg()
    cfg = base.override({k: v for k, v in over.items() if k != "name"})
    nodrop = lambda c: dataclasses.replace(c, dropout_rate=0.0)  # noqa: E731
    return cfg.replace(audio_encoder=nodrop(cfg.audio_encoder),
                       video_encoder=nodrop(cfg.video_encoder),
                       decoder=dataclasses.replace(cfg.decoder, dropout_rate=0.0,
                                                   sampling_probability=0.0))


@functools.lru_cache(maxsize=None)
def _build(name):
    cfg = _model_cfg({"rd_residual": RD_RESIDUAL, "gru_highway": GRU_HIGHWAY}[name])
    V = builtin_unit_dict(cfg.data.unit).vocab_size
    jparams = jseq.model_init(jax.random.PRNGKey(21), cfg, V)
    tparams = convert.from_jax(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    return dict(name=name, cfg=cfg, V=V, jparams=jparams, tparams=tparams)


@pytest.fixture(scope="module", params=["rd_residual", "gru_highway"])
def model(request):
    return _build(request.param)


def test_model_tree_matches_the_jax_init(model):
    """The port's own init gives the JAX init's tree: the GRU leaves [D, 3H],
    ``hw_w`` / ``hw_b`` on the audio layers 1-2 only, in the same flatten
    order (``hw_b`` and ``hw_w`` after ``bwd`` and ``fwd``)."""
    cfg, V = model["cfg"], model["V"]
    tcfg = tconfigs.ExperimentConfig.from_dict(cfg.to_dict())
    mine = tseq.model_init(tcfg, V, torch.Generator().manual_seed(0), "cpu")
    keys = lambda tree: [(convert.path_key(p), tuple(np.shape(x)))  # noqa: E731
                         for p, x in convert.jax_order_leaves(tree)]
    assert keys(convert.to_jax_numpy(mine)) == keys(model["jparams"])
    names = [convert.path_key(p) for p, _ in convert.jax_order_leaves(mine)]
    if model["name"] == "gru_highway":
        assert names.index("audio_encoder/layers/1/hw_b") == \
            names.index("audio_encoder/layers/1/fwd/wx") + 1
        assert "audio_encoder/layers/0/hw_w" not in names
        assert "video_encoder/layers/0/hw_w" not in names
        assert tuple(mine["audio_encoder"]["layers"][0]["fwd"]["wh"].shape) == (32, 96)
    else:
        assert not any("hw_" in n for n in names)


def test_model_loss_and_gradients_match_jax(model):
    """The train-mode loss and every gradient leaf against JAX's on the
    same batch, with the recurrent dropout masks injected into both (one
    pair per layer: the audio encoder's three, then the video encoder's)."""
    cfg, jparams, tparams, V = model["cfg"], model["jparams"], model["tparams"], model["V"]
    arrays = batch_arrays(0, V)
    rng = np.random.default_rng(22)
    masks = [tuple(((rng.uniform(size=(4, 32)) < 0.8) / 0.8).astype(np.float32)
                   for _ in range(2)) for _ in range(4)]
    pj, pt = _inject(masks)
    with pj, pt:
        lf = lambda p, b: jseq.loss_fn(p, cfg, b, train=True, rng=jax.random.PRNGKey(0))  # noqa: E731
        (_, m_j), g_j = jax.jit(jax.value_and_grad(lf, has_aux=True))(jparams, _jbatch(arrays))
        opt, _ = toptim.build_optimizer(cfg.train)
        state = tstep.train_state_from_params(tparams, opt)
        m_t, g_t = tstep.loss_and_grads(state.params, tseq.batch_to_device(arrays, "cpu"),
                                        cfg=tconfigs.ExperimentConfig.from_dict(cfg.to_dict()),
                                        generator=torch.Generator().manual_seed(0))
    np.testing.assert_allclose(float(m_t["loss"]), float(m_j["loss"]), rtol=LOSS_RTOL)
    it = iter(g_t)
    grads = dict(tree_leaves(convert.to_jax_numpy(tree_map(lambda _: next(it), state.params))))
    want = _by_path(g_j)
    assert set(grads) == set(want)
    for k, w in want.items():
        assert np.any(grads[k] != 0), k
        err = np.linalg.norm(grads[k] - w) / np.linalg.norm(w)
        assert err < GRAD_REL_TOL, (k, err)


def test_model_beam_matches_jax(model):
    """Serving (eval mode: no recurrent dropout) through the port's
    ``Predictor``: the beam's ids and steps equal JAX's on the same
    request and weights."""
    cfg = model["cfg"]
    units = builtin_unit_dict(cfg.data.unit)
    tcfg = tconfigs.ExperimentConfig.from_dict(cfg.to_dict())
    pred = Predictor(model["tparams"], tcfg, tbuiltin(tcfg.data.unit), device="cpu",
                     batch_size=2, audio_seconds=1.0)
    audio, video = _request(np.random.default_rng(23), 2)
    arrays, _ = pred.assemble(audio, video)
    before = dict(kernels.LAUNCHES)
    res_t = pred.beam(pred.encode(arrays))
    assert kernels.LAUNCHES == before
    enc_j = jseq.encode(model["jparams"], cfg, _jbatch(arrays))
    res_j = jbeam(model["jparams"]["decoder"], cfg.decoder, enc_j.memories,
                  cfg.decode.max_decode_length, beam_width=cfg.decode.beam_width,
                  compute_dtype=jnp.float32)
    np.testing.assert_array_equal(res_t.ids.numpy(), np.asarray(res_j.ids))
    assert res_t.steps == int(res_j.steps)
    assert units.vocab_size == model["V"]


# ---------------------------------------------------------------------------
# round trips
# ---------------------------------------------------------------------------


def test_gru_highway_tree_round_trips(tmp_path):
    """The GRU / highway tree: ``convert`` both ways (and ``from_jax_leaves``
    in the JAX flatten order) bit-exact; a checkpoint's save, restore and
    average; and the serving artifact's ``params.npz`` byte-equal to the JAX
    package's."""
    model = _build("gru_highway")
    cfg, jparams, V = model["cfg"], model["jparams"], model["V"]
    tcfg = tconfigs.ExperimentConfig.from_dict(cfg.to_dict())
    jleaves = [np.asarray(x) for x in jax.tree_util.tree_leaves(jparams)]
    template = tseq.model_init(tcfg, V, torch.Generator(), device="meta")
    via_leaves = convert.from_jax_leaves(template, jleaves, device="cpu")
    back = [x for _, x in convert.jax_order_leaves(convert.to_jax_numpy(via_leaves))]
    assert len(back) == len(jleaves)
    assert all(a.tobytes() == b.tobytes() for a, b in zip(back, jleaves))
    tparams = model["tparams"]
    opt, _ = toptim.build_optimizer(tcfg.train)
    state = tstep.train_state_from_params(tree_map(torch.clone, tparams), opt)
    mgr = CheckpointManager(str(tmp_path / "ckpt"), keep=5)
    mgr.save(1, state._replace(step=1))
    with torch.no_grad():
        for _, t in tree_leaves(state.params):
            t.add_(1.0)
    mgr.save(2, state._replace(step=2))
    fresh = tstep.train_state_from_params(
        tseq.model_init(tcfg, V, torch.Generator().manual_seed(5), "cpu"), opt)
    want = dict(tree_leaves(tparams))
    restored, _, _ = mgr.restore(fresh, step=1)
    for p, a in tree_leaves(restored.params):
        assert torch.equal(a, want[p]), p
    avg, used = mgr.average(fresh, last_n=2)
    assert used == [1, 2]
    for p, a in tree_leaves(avg.params):
        torch.testing.assert_close(a, want[p] + 0.5, rtol=0, atol=1e-6, msg=str(p))
    assert "audio_encoder/layers/2/hw_w" in params_to_numpy(avg.params)
    kw = dict(use_beam=True, batch_size=2, audio_seconds=0.5, transfer="compact")
    units = builtin_unit_dict(cfg.data.unit)
    jdir = jserve.save_artifact(str(tmp_path / "jax"),
                                *jserve.export_decode(jparams, cfg, platforms=("cpu",), **kw),
                                units)
    tdir = tserve.save_artifact(str(tmp_path / "port"),
                                *tserve.export_decode(tparams, tcfg, **kw), tbuiltin(tcfg.data.unit))
    with np.load(os.path.join(jdir, "params.npz")) as j, \
            np.load(os.path.join(tdir, "params.npz")) as t:
        assert sorted(t.files) == sorted(j.files) and j.files
        for k in j.files:
            assert (j[k].dtype, j[k].shape) == (t[k].dtype, t[k].shape), k
            assert j[k].tobytes() == t[k].tobytes(), k
    loaded = Predictor.load(tdir, device="cpu")
    for p, a in tree_leaves(loaded.params):
        assert torch.equal(a, want[p]), p


def test_avsr_gru_trains_checkpoints_restores_and_predicts(tmp_path):
    """``AVSR(cell_type="gru")`` on the CPU, as the reference builds it: two
    train steps with a checkpoint, a new ``AVSR`` over the run directory that
    restores it, and a prediction; the encoder's leaves are GRU leaves."""
    data = synth(n=8)
    kw = dict(architecture="audio", cell_type="gru", encoder_units_per_layer=(16,),
              decoder_units_per_layer=(16,), embedding_size=8, batch_size=4,
              max_label_length=6, compute_dtype="float32", beam_width=3,
              train_utterances=data, eval_utterances=data, device="cpu")
    run = str(tmp_path / "run")
    a = AVSR(run_dir=run, **kw)
    assert a.config.audio_encoder.cell_type == "gru"
    assert tuple(a.trainer.state.params["audio_encoder"]["layers"][0]["fwd"]["wh"].shape) == \
        (16, 48)
    a.train(num_epochs=1)
    step = int(a.trainer.state.step)
    assert step >= 2 and a.trainer.ckpt.latest_step() == step
    b = AVSR(run_dir=run, **kw)
    assert b.trainer.restore_checkpoint() == step
    for (p, x), (_, y) in zip(tree_leaves(a.trainer.state.params),
                              tree_leaves(b.trainer.state.params)):
        assert torch.equal(x, y), p
    out = b.predict(data[:2])
    assert [u for u, _ in out] == [u.uid for u in data[:2]]
    assert all(isinstance(text, str) for _, text in out)

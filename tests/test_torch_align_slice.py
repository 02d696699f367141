"""The whole serving slice of the reference-dims AV-Align model:
``avsr_tpu`` encode + beam search / greedy decode against the PyTorch
port's ``Predictor`` on the same weights and the same request.

The config has the ``lrs2_av_align`` structure (``configs.lrs2_full()``:
log-mel frontend with stack 8 / skip 3, a 3-layer BiLSTM audio encoder
without time reduction, the 36x36 lip-ROI CNN and a 1-layer video BiLSTM,
the AV-Align fusion with input feeding, a Bahdanau read per audio step and
the AU head, and a 1-layer attention-LSTM decoder, compact int16/uint8
transfer) at small widths (hidden 32, A = 8, decoder embedding 16), beam
width 3, horizon 12, B = 2, 1 s of audio, fp32.  Tolerances: memories
(values and Bahdanau keys), alignments and AU predictions at atol / rtol
1e-4 (fp32 through the frontend's normalization and 3+1 recurrent layers
of sums in another order); beam ids, steps and transcripts identical;
scores within 1e-4; greedy ids and lengths identical.  The bf16 policy's
memories at atol 1e-2.  The full-width tree: keys, shapes and dtypes equal
to the JAX package's, and the round trip through ``convert`` bit-exact.

Every check runs on both AV-Align configurations the port serves: the
``lrs2_av_align`` preset (BiLSTM encoders, Bahdanau reads) and
``lrs2_av_align_uni_luong`` (``UNI_LUONG``: the same preset with
one-direction encoders, kernel K2, and Luong reads in the fusion and the
decoder), whose memory is the fusion LSTM's 32 plus the one-direction
video encoder's 32 channels.
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
from avsr_tpu_torch.serve import Predictor
from avsr_tpu_torch.utils.params import param_count
from tests.test_torch_convert import _paths
from tests.test_torch_slice import _request


@pytest.fixture(autouse=True)
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


# lrs2_av_align_uni_luong: the lrs2_av_align preset (configs.lrs2_full())
# with one-direction encoders and Luong attention in the fusion and the
# decoder, as the reference's AV-Align example script builds it
UNI_LUONG = {"audio_encoder.bidirectional": False, "video_encoder.bidirectional": False,
             "fusion.attention_type": "luong", "decoder.attention_type": "luong",
             "name": "lrs2_av_align_uni_luong"}
VARIANTS = ("bahdanau", "uni_luong")


def small_align_cfg(beam_width=3, horizon=12, compute_dtype="float32", variant="bahdanau"):
    base = configs.lrs2_full()
    if variant == "uni_luong":
        base = base.override(UNI_LUONG)
    return base.replace(
        audio_encoder=dataclasses.replace(base.audio_encoder, hidden_units=(32, 32, 32)),
        video_encoder=dataclasses.replace(base.video_encoder, hidden_units=(32,)),
        fusion=dataclasses.replace(base.fusion, attention_units=8),
        decoder=dataclasses.replace(base.decoder, hidden_units=(32,), embedding_dim=16,
                                    attention_units=8, max_label_length=horizon),
        decode=DecodeConfig(beam_width=beam_width, max_decode_length=horizon),
        train=dataclasses.replace(base.train, compute_dtype=compute_dtype),
    )


def _jbatch(arrays):
    return jseq.Batch(**{k: jnp.asarray(v) for k, v in arrays.items()})


@pytest.fixture(scope="module", params=VARIANTS)
def align_run(request):
    cfg = small_align_cfg(variant=request.param)
    units = builtin_unit_dict(cfg.data.unit)
    jparams = jseq.model_init(jax.random.PRNGKey(11), cfg, units.vocab_size)
    tparams = convert.from_jax(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    pred = Predictor(tparams, cfg, units, device="cpu", batch_size=2, audio_seconds=1.0)
    audio, video = _request(np.random.default_rng(11), 2)
    arrays, n = pred.assemble(audio, video)
    enc_j = jseq.encode(jparams, cfg, _jbatch(arrays))
    res_j = jbeam(jparams["decoder"], cfg.decoder, enc_j.memories, cfg.decode.max_decode_length,
                  beam_width=cfg.decode.beam_width, compute_dtype=jnp.float32)
    greedy_j = jgreedy(jparams["decoder"], cfg.decoder, enc_j.memories, 12,
                       compute_dtype=jnp.float32)
    enc_t = pred.encode(arrays)
    return dict(cfg=cfg, variant=request.param, pred=pred, enc_j=enc_j, res_j=res_j,
                greedy_j=greedy_j, enc_t=enc_t,
                res_t=pred.beam(enc_t), texts=pred.transcribe(audio=audio, video=video),
                greedy_t=tgreedy(tparams["decoder"], cfg.decoder, enc_t.memories, 12,
                                 cdt=torch.float32), n=n)


def test_memories_match(align_run):
    mj, mt = align_run["enc_j"].memories[0], align_run["enc_t"].memories[0]
    width = {"bahdanau": 96, "uni_luong": 64}[align_run["variant"]]
    assert tuple(mt.values.shape) == mj.values.shape == (2, 31, width)
    for name in ("values", "keys"):
        np.testing.assert_allclose(getattr(mt, name).numpy(), np.asarray(getattr(mj, name)),
                                   atol=1e-4, rtol=1e-4)
    np.testing.assert_array_equal(mt.mask.numpy(), np.asarray(mj.mask))
    np.testing.assert_array_equal(mt.bias.numpy(), np.asarray(mj.bias))


def test_alignments_and_au_predictions_match(align_run):
    aj, at = align_run["enc_j"].aux, align_run["enc_t"].aux
    np.testing.assert_allclose(at["av_alignments"].numpy(), np.asarray(aj["av_alignments"]),
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(at["au_predictions"].numpy(), np.asarray(aj["au_predictions"]),
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_array_equal(at["audio_feature_lengths"].numpy(),
                                  np.asarray(aj["audio_feature_lengths"]))


def test_beam_ids_steps_and_scores_match(align_run):
    rj, rt = align_run["res_j"], align_run["res_t"]
    np.testing.assert_array_equal(rt.ids.numpy(), np.asarray(rj.ids))
    np.testing.assert_array_equal(rt.lengths.numpy(), np.asarray(rj.lengths))
    assert rt.steps == int(rj.steps)
    np.testing.assert_allclose(rt.scores.numpy(), np.asarray(rj.scores), atol=1e-4, rtol=0)


def test_transcripts_match(align_run):
    pred, ids = align_run["pred"], np.asarray(align_run["res_j"].ids)
    assert align_run["texts"] == [pred.decode_ids(ids[i]) for i in range(align_run["n"])]


def test_greedy_ids_and_lengths_match(align_run):
    ids_j, len_j = align_run["greedy_j"]
    res = align_run["greedy_t"]
    np.testing.assert_array_equal(res.ids.numpy(), np.asarray(ids_j))
    np.testing.assert_array_equal(res.lengths.numpy(), np.asarray(len_j))


@pytest.mark.parametrize("variant", VARIANTS)
def test_bf16_policy_memories_match(variant):
    """The main path's bf16 policy through the whole encode, the fusion
    scan's 31 steps included: one-ulp flips (2^-8 relative) at rounding
    boundaries carried by the recurrences; held at atol 1e-2 and a mean
    deviation of 5e-4."""
    cfg = small_align_cfg(compute_dtype="bfloat16", variant=variant)
    units = builtin_unit_dict(cfg.data.unit)
    jparams = jseq.model_init(jax.random.PRNGKey(5), cfg, units.vocab_size)
    pred = Predictor(convert.from_jax(jax.tree_util.tree_map(np.asarray, jparams), device="cpu"),
                     cfg, units, device="cpu", batch_size=2, audio_seconds=1.0)
    arrays, _ = pred.assemble(*_request(np.random.default_rng(5), 2))
    mj = jseq.encode(jparams, cfg, _jbatch(arrays)).memories[0]
    mt = pred.encode(arrays).memories[0]
    for name in ("values", "keys"):
        a = getattr(mt, name).float().numpy()
        b = np.asarray(getattr(mj, name), np.float32)
        np.testing.assert_allclose(a, b, atol=1e-2, rtol=0)
        assert float(np.abs(a - b).mean()) < 5e-4


def test_av_align_emits_alignments_and_au(align_run):
    """Mirror of tests/test_seq2seq.py::test_av_align_emits_alignments_and_au:
    the alignment rows over valid audio steps sum to 1."""
    aux = align_run["enc_t"].aux
    assert aux["au_predictions"] is not None
    fl = aux["audio_feature_lengths"].numpy()
    for b in range(2):
        sums = aux["av_alignments"][: fl[b], b].sum(-1).numpy()
        np.testing.assert_allclose(sums, 1.0, rtol=1e-4)


def _align_tree_shapes(variant="bahdanau"):
    cfg, tcfg = configs.lrs2_full(), tconfigs.lrs2_full()
    if variant == "uni_luong":
        cfg, tcfg = cfg.override(UNI_LUONG), tcfg.override(UNI_LUONG)
    vocab = builtin_unit_dict(cfg.data.unit).vocab_size
    shapes = jax.eval_shape(lambda k: jseq.model_init(k, cfg, vocab), jax.random.PRNGKey(0))
    return tcfg, vocab, shapes


def test_full_width_model_init_matches_jax_tree():
    """The full-width ``lrs2_av_align`` tree: the fusion cell, its context
    projection and attention, the AU head, the attention-LSTM decoder."""
    cfg, vocab, shapes = _align_tree_shapes()
    params = tseq.model_init(cfg, vocab, torch.Generator().manual_seed(0), "cpu")
    assert _paths(convert.to_jax_numpy(params)) == _paths(shapes)
    f, d = params["fusion"], params["decoder"]
    assert tuple(f["cell"]["wx"].shape) == (512, 1024) and tuple(f["ctx_proj"].shape) == (512, 1024)
    assert tuple(f["att"]["wm"].shape) == (512, 128) and tuple(f["au_w"].shape) == (512, 2)
    assert tuple(d["cells"][0]["wx"].shape) == (896, 1024)
    assert tuple(d["atts"][0]["wm"].shape) == (768, 128)
    assert tuple(d["out_w"].shape) == (1024, vocab)
    assert tseq.memory_dims_of(cfg) == [768]


def test_full_width_uni_luong_tree_matches_jax():
    """The full-width ``lrs2_av_align_uni_luong`` tree: one ``fwd`` cell per
    encoder layer, Luong's lone ``wq`` in the fusion [256, 256] and the
    decoder [256, 512] (no ``wm``, no ``v``), 4,496,302 parameters."""
    cfg, vocab, shapes = _align_tree_shapes("uni_luong")
    params = tseq.model_init(cfg, vocab, torch.Generator().manual_seed(0), "cpu")
    assert _paths(convert.to_jax_numpy(params)) == _paths(shapes)
    assert param_count(params) == 4_496_302
    for enc in ("audio_encoder", "video_encoder"):
        assert all(list(layer) == ["fwd"] for layer in params[enc]["layers"])
    f, d = params["fusion"], params["decoder"]
    assert list(f["att"]) == ["wq"] and tuple(f["att"]["wq"].shape) == (256, 256)
    assert list(d["atts"][0]) == ["wq"] and tuple(d["atts"][0]["wq"].shape) == (256, 512)
    assert tuple(f["cell"]["wx"].shape) == (256, 1024) and tuple(f["ctx_proj"].shape) == (256, 1024)
    assert tseq.memory_dims_of(cfg) == [512]


@pytest.mark.parametrize("variant", VARIANTS)
def test_full_width_round_trip_is_bit_exact(variant):
    _, _, shapes = _align_tree_shapes(variant)
    rng = np.random.default_rng(1)
    tree = jax.tree_util.tree_map(lambda s: rng.standard_normal(s.shape).astype(s.dtype), shapes)
    back = convert.to_jax_numpy(convert.from_jax(tree, device="cpu"))
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(tree)
    for a, b in zip(jax.tree_util.tree_leaves(tree), jax.tree_util.tree_leaves(back)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_training_this_structure_raises(align_run):
    """Teacher forcing, the loss and the train step of the RNN decoder and
    the AV-Align fusion are ported now (they used to raise "not ported"):
    ``forward`` and ``loss_fn`` run on this structure; a structure outside
    the port still refuses clearly."""
    cfg, pred = align_run["cfg"], align_run["pred"]
    tcfg = tconfigs.ExperimentConfig.from_dict(cfg.to_dict())
    arrays, _ = pred.assemble(*_request(np.random.default_rng(2), 2))
    arrays["targets"] = np.full((2, 4), 3, np.int32)
    arrays["target_lengths"] = np.array([4, 2], np.int32)
    batch = tseq.batch_to_device(arrays, "cpu")
    with torch.no_grad():
        logits, _ = tseq.forward(pred.params, tcfg, batch)
        loss, metrics = tseq.loss_fn(pred.params, tcfg, batch, train=False)
    assert tuple(logits.shape) == (2, 4, pred.params["decoder"]["out_b"].shape[0])
    assert bool(torch.isfinite(logits).all()) and np.isfinite(float(loss))
    assert set(metrics) == {"ce_loss", "loss"}
    other = tcfg.replace(decoder=dataclasses.replace(tcfg.decoder, decoder_type="transformer"))
    with pytest.raises(ValueError, match="the port covers"):
        tseq.model_init(other, 44, torch.Generator(), "cpu")

"""The whole serving slice of the scan-free ``lrs2_av_v2`` model:
``avsr_tpu`` encode + beam search / greedy decode against the PyTorch
port's ``Predictor`` on the same weights and the same request; and the
decode entry points with parameters that require a gradient.

The config has the ``lrs2_av_v2`` structure (log-mel frontend with stack 8
/ skip 3, a 3-layer transformer audio encoder with the conformer conv
module (k = 15) and no time reduction, the 36x36 lip-ROI CNN and a 1-layer
transformer video encoder, 4-head cross-attention fusion with the AU head,
a 1-layer transformer decoder, compact int16/uint8 transfer) at small
widths (d = 32 with 4 heads, A = 8, decoder d = 32), beam width 3, horizon
12, B = 2, 1 s of audio, fp32.  Tolerances, as
``tests/test_torch_slice.py`` states them: memories at atol / rtol 1e-4
(fp32 through the frontend's normalization and 3+1 transformer layers of
sums in another order); beam ids, steps, greedy ids and transcripts
identical; scores within 1e-4.  The bf16 policy's memories at atol 1e-2
plus one bf16 ulp of the value (rtol 2^-7), and a mean of 2e-3: the
context half of the memory is the fusion's bf16-rounded output and reaches
2-4, where one ulp is 1.6e-2, and one-ulp flips there dominate (measured
over seeds 5-7: at most 8.6e-3 beyond one ulp, mean 1.0e-3, whether or
not JAX's CPU rounding of the bf16 sigmoid and GELU is mirrored, see
``tests/test_torch_transformer_encoder.py``).  The full-width tree: keys,
shapes and dtypes equal to the JAX package's (19,144,366 parameters), and the
round trip through ``convert`` bit-exact.

Decoding with a train state's parameters (every leaf ``requires_grad``):
``Predictor.encode`` / ``beam`` / ``__call__``, ``beam_search`` and
``greedy_decode`` record no autograd graph (no output has a ``grad_fn``),
enter none of the port's autograd Functions (``BiLSTMScanCore``,
``AVAlignScan``, ``FusionAttention``, ``DecoderAttention``,
``BahdanauAttend``, ``EncoderSelfAttention``, ``ConformerConv``:
monkeypatched to raise) and run every decoder step
with autograd off, for the ``lrs2_av_fast``, ``lrs2_av_align``,
``lrs2_av_v2`` and ``lrs2_av_align_uni_luong`` structures.
"""

import contextlib
import dataclasses
from unittest import mock

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
from avsr_tpu_torch.decode.beam import beam_search as tbeam
from avsr_tpu_torch.decode.greedy import greedy_decode as tgreedy
from avsr_tpu_torch.models import decoder as tdec
from avsr_tpu_torch.models import fusion as tfus
from avsr_tpu_torch.models import seq2seq as tseq
from avsr_tpu_torch.models import transformer as ttfm
from avsr_tpu_torch.models import transformer_decoder as ttdec
from avsr_tpu_torch.ops import attention as tattn
from avsr_tpu_torch.ops import rnn as trnn
from avsr_tpu_torch.serve import Predictor
from avsr_tpu_torch.utils.numerics import compute_dtype_of
from avsr_tpu_torch.utils.params import param_count, tree_map
from tests.test_torch_align_slice import small_align_cfg
from tests.test_torch_convert import _paths
from tests.test_torch_slice import _request, small_fast_cfg


@pytest.fixture(autouse=True)
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def small_v2_cfg(beam_width=3, horizon=12, compute_dtype="float32"):
    base = configs.lrs2_av_v2()
    return base.replace(
        audio_encoder=dataclasses.replace(base.audio_encoder, hidden_units=(32, 32, 32),
                                          num_heads=4),
        video_encoder=dataclasses.replace(base.video_encoder, hidden_units=(32,), num_heads=4),
        fusion=dataclasses.replace(base.fusion, attention_units=8),
        decoder=dataclasses.replace(base.decoder, hidden_units=(32,), embedding_dim=16,
                                    attention_units=8, max_label_length=horizon),
        decode=DecodeConfig(beam_width=beam_width, max_decode_length=horizon),
        train=dataclasses.replace(base.train, compute_dtype=compute_dtype),
    )


def _jbatch(arrays):
    return jseq.Batch(**{k: jnp.asarray(v) for k, v in arrays.items()})


def _v2_pair(seed, cfg):
    units = builtin_unit_dict(cfg.data.unit)
    jparams = jseq.model_init(jax.random.PRNGKey(seed), cfg, units.vocab_size)
    pred = Predictor(convert.from_jax(jax.tree_util.tree_map(np.asarray, jparams), device="cpu"),
                     cfg, units, device="cpu", batch_size=2, audio_seconds=1.0)
    return jparams, pred


@pytest.fixture(scope="module")
def v2_run():
    cfg = small_v2_cfg()
    jparams, pred = _v2_pair(13, cfg)
    audio, video = _request(np.random.default_rng(13), 2)
    arrays, n = pred.assemble(audio, video)
    enc_j = jseq.encode(jparams, cfg, _jbatch(arrays))
    res_j = jbeam(jparams["decoder"], cfg.decoder, enc_j.memories, cfg.decode.max_decode_length,
                  beam_width=cfg.decode.beam_width, compute_dtype=jnp.float32)
    greedy_j = jgreedy(jparams["decoder"], cfg.decoder, enc_j.memories, 12,
                       compute_dtype=jnp.float32)
    enc_t = pred.encode(arrays)
    return dict(cfg=cfg, pred=pred, arrays=arrays, enc_j=enc_j, res_j=res_j, greedy_j=greedy_j,
                enc_t=enc_t, res_t=pred.beam(enc_t), texts=pred.transcribe(audio=audio,
                                                                           video=video),
                greedy_t=tgreedy(pred.params["decoder"], cfg.decoder, enc_t.memories, 12,
                                 cdt=torch.float32), n=n)


def test_memories_match(v2_run):
    mj, mt = v2_run["enc_j"].memories[0], v2_run["enc_t"].memories[0]
    assert tuple(mt.values.shape) == mj.values.shape == (2, 31, 64)
    np.testing.assert_allclose(mt.values.numpy(), np.asarray(mj.values), atol=1e-4, rtol=1e-4)
    np.testing.assert_array_equal(mt.mask.numpy(), np.asarray(mj.mask))
    np.testing.assert_array_equal(mt.bias.numpy(), np.asarray(mj.bias))
    aj, at = v2_run["enc_j"].aux, v2_run["enc_t"].aux
    np.testing.assert_array_equal(at["audio_feature_lengths"].numpy(),
                                  np.asarray(aj["audio_feature_lengths"]))
    for name in ("av_alignments", "au_predictions"):
        np.testing.assert_allclose(at[name].numpy(), np.asarray(aj[name]), atol=1e-4, rtol=1e-4)


def test_beam_ids_steps_and_scores_match(v2_run):
    rj, rt = v2_run["res_j"], v2_run["res_t"]
    np.testing.assert_array_equal(rt.ids.numpy(), np.asarray(rj.ids))
    np.testing.assert_array_equal(rt.lengths.numpy(), np.asarray(rj.lengths))
    assert rt.steps == int(rj.steps)
    np.testing.assert_allclose(rt.scores.numpy(), np.asarray(rj.scores), atol=1e-4, rtol=0)


def test_greedy_ids_and_lengths_match(v2_run):
    ids_j, len_j = v2_run["greedy_j"]
    res = v2_run["greedy_t"]
    np.testing.assert_array_equal(res.ids.numpy(), np.asarray(ids_j))
    np.testing.assert_array_equal(res.lengths.numpy(), np.asarray(len_j))


def test_transcripts_match(v2_run):
    pred, ids = v2_run["pred"], np.asarray(v2_run["res_j"].ids)
    assert v2_run["texts"] == [pred.decode_ids(ids[i]) for i in range(v2_run["n"])]
    assert pred(**v2_run["arrays"]).tolist() == v2_run["res_t"].ids.tolist()


def test_bf16_policy_memories_match():
    """The bf16 policy through the whole encode: three audio layers, the
    video layer and the fusion."""
    cfg = small_v2_cfg(compute_dtype="bfloat16")
    jparams, pred = _v2_pair(5, cfg)
    arrays, _ = pred.assemble(*_request(np.random.default_rng(5), 2))
    mj = np.asarray(jseq.encode(jparams, cfg, _jbatch(arrays)).memories[0].values, np.float32)
    mt = pred.encode(arrays).memories[0].values.float().numpy()
    np.testing.assert_allclose(mt, mj, atol=1e-2, rtol=2.0 ** -7)
    assert float(np.abs(mt - mj).mean()) < 2e-3


def _v2_tree_shapes():
    cfg = configs.lrs2_av_v2()
    vocab = builtin_unit_dict(cfg.data.unit).vocab_size
    shapes = jax.eval_shape(lambda k: jseq.model_init(k, cfg, vocab), jax.random.PRNGKey(0))
    return tconfigs.lrs2_av_v2(), vocab, shapes


def test_full_width_model_init_matches_jax_tree():
    """The full-width ``lrs2_av_v2`` tree: two transformer encoder stacks
    with the conformer conv module, the fusion, the transformer decoder."""
    cfg, vocab, shapes = _v2_tree_shapes()
    params = tseq.model_init(cfg, vocab, torch.Generator().manual_seed(0), "cpu")
    assert _paths(convert.to_jax_numpy(params)) == _paths(shapes)
    assert param_count(params) == sum(int(np.prod(s.shape)) for s in
                                      jax.tree_util.tree_leaves(shapes)) == 19_144_366
    a = params["audio_encoder"]
    assert len(a["layers"]) == 3 and len(params["video_encoder"]["layers"]) == 1
    assert tuple(a["layers"][0]["conv_dw"].shape) == (15, 1, 512)
    assert tuple(a["in_proj"].shape) == (720, 512)
    assert tseq.memory_dims_of(cfg) == [1024]


def test_full_width_round_trip_is_bit_exact():
    _, _, shapes = _v2_tree_shapes()
    rng = np.random.default_rng(2)
    tree = jax.tree_util.tree_map(lambda s: rng.standard_normal(s.shape).astype(s.dtype), shapes)
    params = convert.from_jax(tree, device="cpu")
    # the depthwise kernels keep the reference's [k, 1, d] layout
    np.testing.assert_array_equal(params["audio_encoder"]["layers"][2]["conv_dw"].numpy(),
                                  tree["audio_encoder"]["layers"][2]["conv_dw"])
    back = convert.to_jax_numpy(params)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(tree)
    for a, b in zip(jax.tree_util.tree_leaves(tree), jax.tree_util.tree_leaves(back)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_train_mode_encode_returns_a_graph(v2_run):
    """``encode(train=True)`` with the preset's encoder dropout (0.1) and
    parameters that require a gradient: memories with a graph back to the
    encoders' parameters, through the two autograd Functions of the stack
    (the gradients themselves: tests/test_torch_transformer_grad.py and
    tests/test_torch_v2_train.py)."""
    cfg, pred = v2_run["cfg"], v2_run["pred"]
    tcfg = tconfigs.ExperimentConfig.from_dict(cfg.to_dict())
    assert tcfg.audio_encoder.dropout_rate == tcfg.video_encoder.dropout_rate == 0.1
    params = tree_map(lambda t: t.detach().clone().requires_grad_(True), pred.params)
    batch = tseq.batch_to_device(v2_run["arrays"], "cpu")
    with mock.patch.object(ttfm.EncoderSelfAttention, "apply",
                           wraps=ttfm.EncoderSelfAttention.apply) as att, \
            mock.patch.object(ttfm.ConformerConv, "apply", wraps=ttfm.ConformerConv.apply) as conv:
        enc = tseq.encode(params, tcfg, batch, train=True,
                          generator=torch.Generator().manual_seed(0))
    values = enc.memories[0].values
    assert values.grad_fn is not None and bool(torch.isfinite(values).all())
    assert att.call_count == conv.call_count == 4  # 3 audio + 1 video layers
    (g,) = torch.autograd.grad(values.sum(), [params["audio_encoder"]["layers"][0]["conv_dw"]])
    assert bool(torch.isfinite(g).all()) and bool((g != 0).any())


# ---- decoding with parameters that require a gradient -------------------

FUNCTIONS = (trnn.BiLSTMScanCore, tfus.AVAlignScan, tfus.FusionAttention,
             ttdec.DecoderAttention, tattn.BahdanauAttend, ttfm.EncoderSelfAttention,
             ttfm.ConformerConv)
STRUCTURES = {"fast": small_fast_cfg, "align": small_align_cfg, "v2": small_v2_cfg,
              "uni_luong": lambda: small_align_cfg(variant="uni_luong")}


@contextlib.contextmanager
def _functions_refused():
    """Every autograd Function of the port raises when entered."""
    with contextlib.ExitStack() as stack:
        for fn in FUNCTIONS:
            stack.enter_context(mock.patch.object(
                fn, "apply", side_effect=RuntimeError(f"{fn.__name__} entered")))
        yield


def _no_graph(*tensors):
    return all(t is None or (t.grad_fn is None and not t.requires_grad) for t in tensors)


@pytest.mark.parametrize("structure", list(STRUCTURES))
def test_decode_records_no_autograd(structure):
    cfg = STRUCTURES[structure]()
    units = builtin_unit_dict(cfg.data.unit)
    params = tseq.model_init(cfg, units.vocab_size, torch.Generator().manual_seed(3), "cpu")
    params = tree_map(lambda t: t.requires_grad_(True), params)
    pred = Predictor(params, cfg, units, device="cpu", batch_size=2, audio_seconds=1.0)
    arrays, _ = pred.assemble(*_request(np.random.default_rng(3), 2))

    # outside the entry points, these parameters do take the autograd path
    with _functions_refused(), pytest.raises(RuntimeError, match="entered"):
        tseq.encode(params, cfg, tseq.batch_to_device(arrays, "cpu"))

    grad_in_steps = []
    step = tdec.decoder_step

    def recording_step(*args, **kwargs):
        grad_in_steps.append(torch.is_grad_enabled())
        return step(*args, **kwargs)

    with _functions_refused(), mock.patch.object(tdec, "decoder_step", recording_step):
        ids = pred(**arrays)
        enc = pred.encode(arrays)
        res = pred.beam(enc)
        d = cfg.decode
        res2 = tbeam(params["decoder"], cfg.decoder, enc.memories, d.max_decode_length,
                     beam_width=d.beam_width, cdt=compute_dtype_of(cfg))
        greedy = tgreedy(params["decoder"], cfg.decoder, enc.memories, d.max_decode_length,
                         cdt=compute_dtype_of(cfg))
    m = enc.memories[0]
    assert _no_graph(m.values, m.keys, m.mask, m.bias, res.scores, res2.scores, greedy.ids)
    assert grad_in_steps and not any(grad_in_steps)
    assert ids.tolist() == res.ids.tolist() == res2.ids.tolist()
    assert tuple(greedy.ids.shape) == (2, cfg.decode.max_decode_length)

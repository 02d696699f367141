"""The whole serving slice: ``avsr_tpu`` encode + beam search against the
PyTorch port's ``Predictor`` on the same weights and the same request.

The config has the ``lrs2_av_fast`` structure — log-mel frontend with
stack 8 / skip 3, a 3-layer BiLSTM audio encoder with time reduction
(2, 2, 1), the 36x36 lip-ROI CNN and a 1-layer video BiLSTM, 4-head
cross-attention fusion, a 1-layer transformer decoder, compact int16/uint8
transfer — at small widths (hidden 32, decoder d = 32), beam width 3,
horizon 12, B = 2, 1 s of audio, fp32.  Tolerances: memories at
atol 1e-4 / rtol 1e-4 (fp32 through a 4-layer recurrent stack and the
frontend's normalization); beam ids, steps and transcripts identical;
scores within 1e-4.
"""

import dataclasses
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avsr_tpu import configs
from avsr_tpu.configs import DecodeConfig
from avsr_tpu.data.units import builtin_unit_dict
from avsr_tpu.decode.beam import beam_search as jbeam
from avsr_tpu.models import seq2seq as jseq
from avsr_tpu_torch import convert
from avsr_tpu_torch.serve import Predictor

torch.set_num_threads(1)


def small_fast_cfg(beam_width=3, horizon=12):
    base = configs.lrs2_av_fast()
    return base.replace(
        audio_encoder=dataclasses.replace(base.audio_encoder, hidden_units=(32, 32, 32)),
        video_encoder=dataclasses.replace(base.video_encoder, hidden_units=(32,)),
        fusion=dataclasses.replace(base.fusion, attention_units=8),
        decoder=dataclasses.replace(base.decoder, hidden_units=(32,), embedding_dim=16,
                                    attention_units=8, max_label_length=horizon),
        decode=DecodeConfig(beam_width=beam_width, max_decode_length=horizon),
        train=dataclasses.replace(base.train, compute_dtype="float32"),
    )


def _request(rng, n, seconds=1.0):
    audio, video = [], []
    for i in range(n):
        ns = int(16000 * seconds) - 4000 * i
        t = np.arange(ns) / 16000.0
        audio.append((0.4 * np.sin(2 * np.pi * (300 + 200 * i) * t)
                      + 0.05 * rng.standard_normal(ns)).astype(np.float32))
        nf = int(np.ceil(ns / 16000 * 25))
        video.append(rng.uniform(0, 1, (nf, 36, 36, 1)).astype(np.float32))
    return audio, video


@pytest.fixture(scope="module")
def slice_run():
    cfg = small_fast_cfg()
    units = builtin_unit_dict(cfg.data.unit)
    jparams = jseq.model_init(jax.random.PRNGKey(3), cfg, units.vocab_size)
    tparams = convert.from_jax(jax.tree_util.tree_map(np.asarray, jparams))
    pred = Predictor(tparams, cfg, units, device="cpu", batch_size=2,
                     audio_seconds=1.0, transfer="compact")
    audio, video = _request(np.random.default_rng(3), 2)
    arrays, n = pred.assemble(audio, video)
    assert arrays["audio"].dtype == np.int16 and arrays["video"].dtype == np.uint8

    enc_j = jseq.encode(jparams, cfg, jseq.Batch(**{k: jnp.asarray(v) for k, v in arrays.items()}))
    res_j = jbeam(jparams["decoder"], cfg.decoder, enc_j.memories, cfg.decode.max_decode_length,
                  beam_width=cfg.decode.beam_width, compute_dtype=jnp.float32)
    enc_t = pred.encode(arrays)
    res_t = pred.beam(enc_t)
    texts = pred.transcribe(audio=audio, video=video)
    return dict(pred=pred, enc_j=enc_j, res_j=res_j, enc_t=enc_t, res_t=res_t, texts=texts, n=n)


def test_memories_match(slice_run):
    mj, mt = slice_run["enc_j"].memories[0], slice_run["enc_t"].memories[0]
    assert tuple(mt.values.shape) == mj.values.shape
    np.testing.assert_allclose(mt.values.numpy(), np.asarray(mj.values), atol=1e-4, rtol=1e-4)
    np.testing.assert_array_equal(mt.mask.numpy(), np.asarray(mj.mask))
    np.testing.assert_array_equal(mt.bias.numpy(), np.asarray(mj.bias))
    np.testing.assert_array_equal(
        slice_run["enc_t"].aux["audio_feature_lengths"].numpy(),
        np.asarray(slice_run["enc_j"].aux["audio_feature_lengths"]))


def test_beam_ids_steps_and_scores_match(slice_run):
    rj, rt = slice_run["res_j"], slice_run["res_t"]
    np.testing.assert_array_equal(rt.ids.numpy(), np.asarray(rj.ids))
    np.testing.assert_array_equal(rt.lengths.numpy(), np.asarray(rj.lengths))
    assert rt.steps == int(rj.steps)
    np.testing.assert_allclose(rt.scores.numpy(), np.asarray(rj.scores), atol=1e-4, rtol=0)


def test_transcripts_match(slice_run):
    pred, rj = slice_run["pred"], slice_run["res_j"]
    ids = np.asarray(rj.ids)
    want = [pred.decode_ids(ids[i]) for i in range(slice_run["n"])]
    assert slice_run["texts"] == want


def test_bf16_policy_memories_match():
    """The main path's bf16 policy through the whole encode: both sides
    round the same operands to bf16 at the same points; a value near a
    rounding boundary can land one bf16 ulp (2^-8 relative) apart and
    propagate through the 3+1 recurrent layers.  Measured: 2e-3 max (one
    ulp at 0.25-0.5), 5e-5 mean over seeds 5-7; held at atol 1e-2 (2.5
    ulps near 1) and a mean deviation of 5e-4."""
    base = small_fast_cfg()
    cfg = base.replace(train=dataclasses.replace(base.train, compute_dtype="bfloat16"))
    units = builtin_unit_dict(cfg.data.unit)
    jparams = jseq.model_init(jax.random.PRNGKey(5), cfg, units.vocab_size)
    pred = Predictor(convert.from_jax(jax.tree_util.tree_map(np.asarray, jparams)), cfg,
                     units, device="cpu", batch_size=2, audio_seconds=1.0)
    arrays, _ = pred.assemble(*_request(np.random.default_rng(5), 2))
    mj = jseq.encode(jparams, cfg, jseq.Batch(**{k: jnp.asarray(v) for k, v in arrays.items()}))
    mt = pred.encode(arrays)
    vj = np.asarray(mj.memories[0].values, np.float32)
    vt = mt.memories[0].values.float().numpy()
    np.testing.assert_allclose(vt, vj, atol=1e-2, rtol=0)
    assert float(np.abs(vt - vj).mean()) < 5e-4


def test_predictor_rejects_bad_requests(slice_run):
    pred = slice_run["pred"]
    audio, video = _request(np.random.default_rng(4), 1)
    with pytest.raises(ValueError, match="horizon"):
        pred.assemble([np.zeros(17000, np.float32)], video)
    with pytest.raises(ValueError, match="range"):
        pred.assemble([audio[0] * 4.0], video)
    with pytest.raises(ValueError, match="counts differ"):
        pred.assemble(audio, video + video)


def test_port_never_imports_jax():
    """Importing every module of the port leaves jax out of sys.modules."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import avsr_tpu_torch\n"
        "for m in pkgutil.walk_packages(avsr_tpu_torch.__path__, 'avsr_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or k.startswith(('jax.', 'jaxlib')))\n"
        "assert not bad, bad\n"
        "print(len([k for k in sys.modules if k.startswith('avsr_tpu_torch')]))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 23  # the train/ package, ops/noise, utils/rng

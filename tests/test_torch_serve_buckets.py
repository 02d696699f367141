"""Serving replies against the bucket that decodes them, in both packages.

A bucketed artifact pads each request to its bucket's horizon (the audio
samples and video frames of the smallest bucket that fits it), so one
utterance can be decoded over a shorter or a longer padded batch.  Here
the same utterances, short enough for both buckets, are decoded by each
bucket of a two-bucket export, written by the JAX package
(``avsr_tpu.serve.export_decode`` + ``save_artifact``, loaded as a
``BucketedPredictor``) and by the port (``convert.from_jax`` of the same
parameters, its ``export_decode`` + ``save_artifact``, loaded with
``device="cpu"``), and the hypothesis ids that move between the buckets
are compared across the packages.

Cases: the cross-attention fusion + transformer decoder beam
(``lrs2_av_fast``'s structure at small widths) and the AV-Align + RNN
decoder beam, each in fp32 and in the bf16 policy (the card's), from
``avsr_tpu.models.seq2seq.model_init`` parameters (a fixed key, not
trained), three ragged utterances on the compact wire's grids.  Each
package's ids in the long bucket equal its ids in the short one: padding
to a longer horizon moves no beam in either package here.  In fp32 the
port's ids also equal the reference's in each bucket, so the port pads as
the reference does.  In the bf16 policy the two packages' ids may differ
(JAX's CPU backend rounds every step of a bf16 elementwise function, the
port once: ROADMAP's translation hazards), but not between buckets.
"""

import jax
import numpy as np
import pytest
import torch

from avsr_tpu import configs as jconfigs
from avsr_tpu import serve as jserve
from avsr_tpu.data.units import builtin_unit_dict as jbuiltin
from avsr_tpu.models import seq2seq as jseq
from avsr_tpu_torch import configs as tconfigs
from avsr_tpu_torch import convert
from avsr_tpu_torch import serve as tserve
from avsr_tpu_torch.data.units import builtin_unit_dict as tbuiltin
from test_torch_serve_artifact import grid_request
from test_torch_slice import small_fast_cfg
from test_torch_trainer import tiny_cfg

CASES = {
    # name: (JAX config, the two buckets' audio seconds, the request's seconds)
    "xattn_xfdec_beam": (lambda: small_fast_cfg(), (1.0, 2.0), 1.0),
    "av_align_rnn_beam": (lambda: tiny_cfg(jconfigs, "av_align"), (0.5, 1.0), 0.5),
}


@pytest.fixture(autouse=True)
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _with_dtype(cfg, dtype):
    import dataclasses

    return cfg.replace(train=dataclasses.replace(cfg.train, compute_dtype=dtype))


def _export_both(jcfg, seconds, tmp):
    """The two-bucket artifact of each package: (JAX BucketedPredictor, the
    port's), their buckets ascending."""
    units = jbuiltin(jcfg.data.unit)
    jparams = jseq.model_init(jax.random.PRNGKey(11), jcfg, units.vocab_size)
    tcfg = tconfigs.ExperimentConfig.from_dict(jcfg.to_dict())
    tparams = convert.from_jax(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    jb, tb = [], []
    for s in seconds:
        kw = dict(use_beam=True, batch_size=3, audio_seconds=s, platforms=("cpu",),
                  transfer="compact", n_best=1)
        extra = {"architecture": jcfg.architecture, "use_beam": True, "checkpoint_step": 1,
                 "audio_seconds": s, "transfer": "compact", "n_best": 1}
        exported, leaves, sig = jserve.export_decode(jparams, jcfg, **kw)
        jb.append(jserve.Predictor.load(jserve.save_artifact(
            str(tmp / f"jax_{s}"), exported, leaves, sig, units, extra_meta=extra)))
        program, tleaves, tsig = tserve.export_decode(tparams, tcfg, **kw)
        tb.append(tserve.Predictor.load(tserve.save_artifact(
            str(tmp / f"port_{s}"), program, tleaves, tsig, tbuiltin(tcfg.data.unit),
            extra_meta=extra), device="cpu"))
    return jserve.BucketedPredictor(jb), tserve.BucketedPredictor(tb)


def _ids(pred, req, assemble):
    arrays, n = assemble(req.get("audio"), req.get("video"))
    return np.asarray(pred(**arrays))[:n]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_bucket_moves_no_beam_in_either_package(case, dtype, tmp_path):
    make, seconds, req_seconds = CASES[case]
    jcfg = _with_dtype(make(), dtype)
    jpred, tpred = _export_both(jcfg, seconds, tmp_path)
    for seed in (0, 1):
        req = grid_request(jcfg, req_seconds, 3, seed)
        # the request fits the short bucket, so the bucketed predictors pick it
        assert jpred._pick(req["audio"], req.get("video")) is jpred.buckets[0]
        assert tpred._pick(req["audio"], req.get("video")) is tpred.buckets[0]
        j_ids = [_ids(p, req, p._assemble) for p in jpred.buckets]
        t_ids = [_ids(p, req, p.assemble) for p in tpred.buckets]
        j_moved = [not np.array_equal(a, b) for a, b in zip(j_ids[0], j_ids[1])]
        t_moved = [not np.array_equal(a, b) for a, b in zip(t_ids[0], t_ids[1])]
        assert t_moved == j_moved == [False] * 3, (t_moved, j_moved)
        if dtype == "float32":
            for j, t in zip(j_ids, t_ids):
                np.testing.assert_array_equal(t, j)

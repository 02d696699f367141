"""The port's serving artifacts (``avsr_tpu_torch/serve.py``) against the
JAX package's (``avsr_tpu/serve.py``), and the reference's own serving
tests (``tests/test_serve.py``) on the port.

Against JAX, on parameters from ``avsr_tpu.models.seq2seq.model_init``
(a fixed key, not trained; fp32 compute, as ``tests/test_serve.py``'s
configs), each case written by both packages: the JAX artifact by
``export_decode(..., platforms=("cpu",))`` + ``save_artifact``, the port's
by ``convert.from_jax(..., device="cpu")`` + the port's ``export_decode`` +
``save_artifact``, with the extra keys ``export_serving_artifact`` writes:

* the ``params.npz`` arrays are byte-equal, leaf for leaf (the files are
  not: zip entries carry their write time);
* ``meta.json`` is equal on every key but ``platforms``, JAX's
  ``jax_version`` / ``calling_convention`` and the port's ``torch_version``
  / ``config``;
* the port's ``Predictor.load(..., device="cpu")`` gives the JAX
  ``Predictor.load``'s transcripts on the same ragged requests, aligned to
  the compact wire's grids (int16 PCM, uint8 pixels) so both transfers see
  the same values; n-best hypotheses equal, their scores within
  ``SCORE_RTOL`` (fp32 through both stacks, sums in another order).

Cases: an audio greedy artifact, an ``av_align`` cross-attention fusion +
transformer decoder beam artifact (the ``lrs2_av_fast`` structure at small
widths), an AV-Align + RNN decoder beam artifact with ``n_best=3``; each at
compact and float32 transfer.

On the port alone, mirroring ``tests/test_serve.py:71-190``: the round trip
equals ``AVSR.predict``, compact input out of range is rejected, float32
transfer, the bucketed export routes to the smallest fit, overruns are
rejected, a never-trained model raises, ``data_parallel`` above the device
count raises; also a JAX-written directory is refused and the loaded
parameters are not transferred again between calls.
"""

import json
import os
import types
from unittest import mock

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
from avsr_tpu_torch.avsr import AVSR
from avsr_tpu_torch.data.synthetic import SyntheticSpec, generate
from avsr_tpu_torch.data.units import builtin_unit_dict as tbuiltin
from avsr_tpu_torch.utils.params import tree_leaves
from test_torch_slice import small_fast_cfg
from test_torch_trainer import tiny_cfg

SCORE_RTOL = 1e-5
META_APART = {"platforms", "jax_version", "calling_convention", "torch_version", "config"}


@pytest.fixture(autouse=True)
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


# -- against the JAX package -------------------------------------------------

CASES = {
    # name: (JAX config, use_beam, n_best, audio seconds)
    "audio_greedy": (lambda: tiny_cfg(jconfigs, "audio"), False, 1, 0.5),
    "xattn_xfdec_beam": (lambda: small_fast_cfg(), True, 1, 1.0),
    "av_align_rnn_nbest": (lambda: tiny_cfg(jconfigs, "av_align"), True, 3, 0.5),
}


def grid_request(cfg, seconds, n, seed):
    """n ragged utterances on the compact wire's grids (int16 PCM, uint8
    pixels): the JAX config's modalities, the longest at the horizon."""
    rng = np.random.default_rng(seed)
    S = int(round(seconds * cfg.audio.sample_rate))
    lengths = [S - (S // 3) * i for i in range(n)]
    audio = [np.round(rng.uniform(-0.6, 0.6, L) * 32767).astype(np.float32) / 32767
             for L in lengths]
    kw = {"audio": audio}
    if cfg.architecture != "audio":
        v = cfg.video
        kw["video"] = [np.round(rng.uniform(0, 1, (int(np.ceil(L / cfg.audio.sample_rate
                                                              * cfg.data.video_fps)),
                                                   v.roi_height, v.roi_width, v.channels))
                                * 255).astype(np.float32) / 255 for L in lengths]
    return kw


@pytest.fixture(scope="module", params=[(c, t) for c in CASES for t in ("compact", "float32")],
                ids=lambda p: f"{p[0]}-{p[1]}")
def both(request, tmp_path_factory):
    name, transfer = request.param
    make, use_beam, n_best, seconds = CASES[name]
    jcfg = make()
    units = jbuiltin(jcfg.data.unit)
    jparams = jseq.model_init(jax.random.PRNGKey(7), jcfg, units.vocab_size)
    kw = dict(use_beam=use_beam, batch_size=3, audio_seconds=seconds, platforms=("cpu",),
              transfer=transfer, n_best=n_best)
    extra = {"architecture": jcfg.architecture, "use_beam": use_beam, "checkpoint_step": 5,
             "audio_seconds": seconds, "transfer": transfer, "n_best": n_best}
    tmp = tmp_path_factory.mktemp(f"{name}_{transfer}")
    exported, leaves, sig = jserve.export_decode(jparams, jcfg, **kw)
    jdir = jserve.save_artifact(str(tmp / "jax"), exported, leaves, sig, units, extra_meta=extra)

    tcfg = tconfigs.ExperimentConfig.from_dict(jcfg.to_dict())
    tparams = convert.from_jax(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    program, tleaves, tsig = tserve.export_decode(tparams, tcfg, **kw)
    tdir = tserve.save_artifact(str(tmp / "port"), program, tleaves, tsig,
                                tbuiltin(tcfg.data.unit), extra_meta=extra)
    return dict(jdir=jdir, tdir=tdir, cfg=jcfg, n_best=n_best, seconds=seconds)


def test_params_npz_byte_equal(both):
    with np.load(os.path.join(both["jdir"], "params.npz")) as j, \
            np.load(os.path.join(both["tdir"], "params.npz")) as t:
        assert sorted(t.files) == sorted(j.files)
        assert j.files and all(k.startswith("leaf_") for k in j.files)
        for k in j.files:
            a, b = j[k], t[k]
            assert (a.dtype, a.shape) == (b.dtype, b.shape), k
            assert a.tobytes() == b.tobytes(), k


def test_meta_equal_but_framework_keys(both):
    with open(os.path.join(both["jdir"], "meta.json")) as f:
        jm = json.load(f)
    with open(os.path.join(both["tdir"], "meta.json")) as f:
        tm = json.load(f)
    assert {k: v for k, v in tm.items() if k not in META_APART} == \
        {k: v for k, v in jm.items() if k not in META_APART}
    assert {"jax_version", "calling_convention"} <= set(jm) and "config" not in jm
    assert tm["platforms"] == ["cpu", "gpu"] and tm["num_devices"] == 1
    assert "torch_version" in tm and "jax_version" not in tm
    assert tm["config"] == json.loads(both["cfg"].to_json())


def test_transcripts_equal_jax(both):
    jp = jserve.Predictor.load(both["jdir"])
    tp = tserve.Predictor.load(both["tdir"], device="cpu")
    assert tp.batch_size == jp.batch_size == 3 and tp.n_best == jp.n_best == both["n_best"]
    for seed in (0, 1):
        req = grid_request(both["cfg"], both["seconds"], 2 + seed, seed)
        want = jp.transcribe(**req)
        assert tp.transcribe(**req) == want
        if both["n_best"] > 1:
            jn, tn = jp.transcribe_nbest(**req), tp.transcribe_nbest(**req)
            assert [[h for h, _ in a] for a in tn] == [[h for h, _ in a] for a in jn]
            np.testing.assert_allclose([[s for _, s in a] for a in tn],
                                       [[s for _, s in a] for a in jn], rtol=SCORE_RTOL)
            assert [a[0][0] for a in tn] == want


def test_export_checks_follow_the_reference():
    cfg = tconfigs.ExperimentConfig.from_dict(tiny_cfg(jconfigs, "audio").to_dict())
    params = {"w": torch.zeros(2)}
    with pytest.raises(ValueError, match="exceeds decode.beam_width"):
        tserve.export_decode(params, cfg, n_best=4)
    with pytest.raises(ValueError, match="requires beam decoding"):
        tserve.export_decode(params, cfg, use_beam=False, n_best=2)
    with pytest.raises(ValueError, match="tpu"):
        tserve.export_decode(params, cfg, platforms=("cpu", "tpu"))


# -- the reference's serving tests on the port -------------------------------

@pytest.fixture(scope="module")
def data():
    utts = generate(SyntheticSpec(num_utterances=8, min_chars=2, max_chars=3, seed=11,
                                  alphabet="ab", roi=20, char_duration_s=0.1))
    for u in utts:  # on the compact wire's grids, as real 16-bit wavs and uint8 crops are
        u.waveform = (np.round(u.waveform * 32767.0) / 32767.0).astype(np.float32)
        u.video = (np.round(u.video * 255.0) / 255.0).astype(np.float32)
    return utts


def tiny_avsr(run_dir, data):
    return AVSR(architecture="audio", encoder_units_per_layer=(16,),
                decoder_units_per_layer=(16,), embedding_size=8, batch_size=4,
                max_label_length=6, compute_dtype="float32", run_dir=str(run_dir),
                train_utterances=data, eval_utterances=data, device="cpu")


@pytest.fixture(scope="module")
def trained(tmp_path_factory, data):
    avsr = tiny_avsr(tmp_path_factory.mktemp("serve") / "run", data)
    avsr.train(num_epochs=1)
    return avsr


def test_export_roundtrip_matches_predict(trained, data, tmp_path):
    want = dict(trained.predict(data[:4], use_beam=False))
    out = tserve.export_serving_artifact(trained, str(tmp_path / "artifact"), use_beam=False,
                                         batch_size=4, audio_seconds=0.5)
    pred = tserve.Predictor.load(out, device="cpu")
    got = pred.transcribe(audio=[u.waveform for u in data[:4]])
    assert got == [want[u.uid] for u in data[:4]]
    # self-describing: inventory and id semantics in meta
    assert pred.meta["architecture"] == "audio" and pred.meta["eos_id"] == 2
    assert pred.meta["use_beam"] is False and not pred.use_beam
    assert pred.meta["checkpoint_step"] == trained.trainer._host_step > 0
    assert pred.batch_size == 4
    assert sorted(pred.meta["platforms"]) == ["cpu", "gpu"]
    assert pred._inputs["audio"]["dtype"] == "int16"  # compact by default
    # the parameters were placed once, at load: the calls reuse them
    before = [(p, t.data_ptr(), t.device) for p, t in tree_leaves(pred.params)]
    assert pred.transcribe(audio=[u.waveform for u in data[:2]]) == got[:2]
    assert [(p, t.data_ptr(), t.device) for p, t in tree_leaves(pred.params)] == before
    assert all(d.type == "cpu" for _, _, d in before)


def test_beam_and_nbest_artifacts_match_predict(trained, data, tmp_path):
    want = dict(trained.predict(data[:4], use_beam=True))
    want_n = dict(trained.predict(data[:4], n_best=3))
    top1 = tserve.Predictor.load(tserve.export_serving_artifact(
        trained, str(tmp_path / "beam"), batch_size=4, audio_seconds=0.5), device="cpu")
    nbest = tserve.Predictor.load(tserve.export_serving_artifact(
        trained, str(tmp_path / "nbest"), batch_size=4, audio_seconds=0.5, n_best=3),
        device="cpu")
    wavs = [u.waveform for u in data[:4]]
    assert top1.transcribe(audio=wavs) == nbest.transcribe(audio=wavs) == \
        [want[u.uid] for u in data[:4]]
    alts = nbest.transcribe_nbest(audio=wavs)
    for u, a in zip(data[:4], alts):
        assert [h for h, _ in a] == [h for h, _ in want_n[u.uid]]
        np.testing.assert_allclose([s for _, s in a], [s for _, s in want_n[u.uid]], rtol=1e-6)
    with pytest.raises(ValueError, match="top-1 only"):
        top1.transcribe_nbest(audio=wavs)
    arrays, _ = nbest.assemble(audio=wavs)
    ids, scores = nbest(**arrays)
    assert ids.shape == (4, 3, trained.config.decode.max_decode_length) and scores.shape == (4, 3)


def test_compact_wire_rejects_out_of_range(trained, tmp_path):
    out = tserve.export_serving_artifact(trained, str(tmp_path / "rng"), use_beam=False,
                                         batch_size=2, audio_seconds=0.4)
    pred = tserve.Predictor.load(out, device="cpu")
    with pytest.raises(ValueError, match="int16-PCM-range"):
        pred.transcribe(audio=[np.full(1600, 2.5, np.float32)])
    with pytest.raises(ValueError, match="int16-PCM-range"):
        pred.validate_utterance(audio=np.full(1600, 2.5, np.float32))
    # full-scale 16-bit PCM is valid: a clipped recording's most negative sample
    full_scale = np.full(1600, -32768.0 / 32767.0, np.float32)
    assert pred.transcribe(audio=[full_scale])
    pred.validate_utterance(audio=full_scale)


def test_float32_transfer_export(trained, data, tmp_path):
    want = dict(trained.predict(data[:2], use_beam=False))
    out = tserve.export_serving_artifact(trained, str(tmp_path / "f32"), use_beam=False,
                                         batch_size=2, audio_seconds=0.5, transfer="float32")
    pred = tserve.Predictor.load(out, device="cpu")
    assert pred._inputs["audio"]["dtype"] == "float32"
    arrays, _ = pred.assemble(audio=[u.waveform for u in data[:2]])
    assert arrays["audio"].dtype == np.float32  # float requests go through unchanged
    np.testing.assert_array_equal(arrays["audio"][0, :len(data[0].waveform)], data[0].waveform)
    assert pred.transcribe(audio=[u.waveform for u in data[:2]]) == \
        [want[u.uid] for u in data[:2]]


@pytest.mark.parametrize("horizons", [(0.4, 1.0), "1.0,0.4"], ids=["sequence", "string"])
def test_bucketed_export_routes_to_smallest_fit(trained, data, tmp_path, horizons):
    want = dict(trained.predict(data[:2], use_beam=False))
    out = tserve.export_serving_artifact(trained, str(tmp_path / "buckets"), use_beam=False,
                                         batch_size=2, audio_seconds=horizons)
    assert sorted(os.listdir(out)) == ["bucket_0.4s", "bucket_1s", "meta.json"]
    pred = tserve.load_predictor(out, device="cpu")
    assert isinstance(pred, tserve.BucketedPredictor) and len(pred.buckets) == 2
    short = [u.waveform for u in data[:2]]  # <= 0.3 s each
    assert pred._pick(short, None)._inputs["audio"]["shape"][1] == int(0.4 * 16_000)
    assert pred.transcribe(audio=short) == [want[u.uid] for u in data[:2]]
    long = [np.zeros(int(0.8 * 16_000), np.float32)]
    assert pred._pick(long, None)._inputs["audio"]["shape"][1] == int(1.0 * 16_000)
    with pytest.raises(ValueError, match="exported horizon"):
        pred.transcribe(audio=[np.zeros(int(1.2 * 16_000), np.float32)])
    # a string horizon is one bucket, never its characters
    one = tserve.export_serving_artifact(trained, str(tmp_path / "ten"), use_beam=False,
                                         batch_size=2, audio_seconds="1.0")
    assert isinstance(tserve.load_predictor(one, device="cpu"), tserve.Predictor)


def test_predictor_rejects_overruns(trained, data, tmp_path):
    out = tserve.export_serving_artifact(trained, str(tmp_path / "small"), use_beam=False,
                                         batch_size=2, audio_seconds=0.3)
    pred = tserve.Predictor.load(out, device="cpu")
    with pytest.raises(ValueError, match="exceed the exported batch size"):
        pred.transcribe(audio=[u.waveform for u in data[:3]])
    with pytest.raises(ValueError, match="exported horizon"):
        pred.transcribe(audio=[np.zeros(16_000, np.float32)])


def test_export_never_trained_raises(tmp_path, data):
    avsr = tiny_avsr(tmp_path / "fresh", data)
    with pytest.raises(RuntimeError, match="never-trained"):
        tserve.export_serving_artifact(avsr, str(tmp_path / "artifact"))
    assert not (tmp_path / "artifact").exists()


def test_data_parallel_export_raises(trained, tmp_path):
    with pytest.raises(ValueError, match="only 1 devices visible"):
        tserve.export_serving_artifact(trained, str(tmp_path / "dp"), data_parallel=2)
    # with enough cards it names what is not ported
    on_cards = types.SimpleNamespace(trainer=types.SimpleNamespace(device="cuda"))
    with mock.patch.object(torch.cuda, "device_count", return_value=4):
        with pytest.raises(NotImplementedError, match="queue 1 item 8"):
            tserve.export_serving_artifact(on_cards, str(tmp_path / "dp4"), data_parallel=4)
    assert not (tmp_path / "dp").exists() and not (tmp_path / "dp4").exists()


def test_jax_written_artifact_is_refused(tmp_path):
    cfg = tiny_cfg(jconfigs, "audio")
    units = jbuiltin(cfg.data.unit)
    jparams = jseq.model_init(jax.random.PRNGKey(0), cfg, units.vocab_size)
    exported, leaves, sig = jserve.export_decode(jparams, cfg, use_beam=False, batch_size=2,
                                                 audio_seconds=0.3, platforms=("cpu",))
    out = jserve.save_artifact(str(tmp_path / "jax"), exported, leaves, sig, units)
    with pytest.raises(ValueError, match="artifact of the JAX package"):
        tserve.Predictor.load(out, device="cpu")
    with pytest.raises(ValueError, match="artifact of the JAX package"):
        tserve.load_predictor(out, device="cpu")


def test_load_refuses_leaves_of_another_model(trained, tmp_path):
    """A leaf in the wrong slot raises instead of decoding silently wrong."""
    out = tserve.export_serving_artifact(trained, str(tmp_path / "a"), use_beam=False,
                                         batch_size=2, audio_seconds=0.3)
    with np.load(os.path.join(out, "params.npz")) as z:
        leaves = {k: z[k] for k in z.files}
    keys = sorted(leaves)
    shapes = [leaves[k].shape for k in keys]
    i = next(i for i in range(len(keys) - 1) if shapes[i] != shapes[i + 1])
    leaves[keys[i]], leaves[keys[i + 1]] = leaves[keys[i + 1]], leaves[keys[i]]
    np.savez(os.path.join(out, "params.npz"), **leaves)
    with pytest.raises(ValueError, match="the model wants"):
        tserve.Predictor.load(out, device="cpu")

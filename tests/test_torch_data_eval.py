"""The port's data path and eval scoring against the JAX package's copies
(``avsr_tpu/data``, ``avsr_tpu/eval``, ``avsr_tpu/native``): the same
synthetic corpus, TFRecord files byte-equal and read back equal by either
package (native framing and the Python fallback), the same bucketed batches
array for array at the same seed, ``to_model_batch`` on the CPU equal to
the numpy it was given, and the same CER / WER, edit distances (native
and NumPy) and error analysis on seeded random pairs.  The native library
builds at first use into the repository's ``build/``, never into the
package, and without a host compiler every consumer takes its Python path.
"""

import dataclasses

import numpy as np
import pytest
import torch

from avsr_tpu.configs import DataConfig as JDataConfig
from avsr_tpu.data import grain_loader as jgrain
from avsr_tpu.data import loader as jloader
from avsr_tpu.data import synthetic as jsyn
from avsr_tpu.data import tfrecord as jtf
from avsr_tpu.data.units import builtin_unit_dict as jbuiltin
from avsr_tpu.eval import analysis as jana
from avsr_tpu.eval import metrics as jmet
from avsr_tpu_torch import native
from avsr_tpu_torch.configs import DataConfig
from avsr_tpu_torch.data import grain_loader as tgrain
from avsr_tpu_torch.data import loader as tloader
from avsr_tpu_torch.data import synthetic as tsyn
from avsr_tpu_torch.data import tfrecord as ttf
from avsr_tpu_torch.data.units import builtin_unit_dict
from avsr_tpu_torch.eval import analysis as tana
from avsr_tpu_torch.eval import metrics as tmet
from avsr_tpu_torch.models import seq2seq as tseq

SPEC = dict(num_utterances=12, seed=4)


def _utts(pkg):
    return pkg.generate(pkg.SyntheticSpec(**SPEC))


def _assert_utts_equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert (x.uid, x.transcript) == (y.uid, y.transcript)
        for f in ("waveform", "video", "au"):
            np.testing.assert_array_equal(getattr(x, f), getattr(y, f), err_msg=f)


def test_synthetic_corpus_and_noise_bank_equal():
    _assert_utts_equal(_utts(tsyn), _utts(jsyn))
    np.testing.assert_array_equal(tsyn.make_noise_bank(3, 4000, seed=2),
                                  jsyn.make_noise_bank(3, 4000, seed=2))


@pytest.mark.parametrize("codec", ["float32", "uint8"])
@pytest.mark.parametrize("framing", ["native", "python"])
def test_records_byte_equal_and_cross_readable(tmp_path, monkeypatch, codec, framing):
    n = 12
    if framing == "python":
        monkeypatch.setattr(ttf, "_native", lambda: None)
        n = 3  # the Python crc is slow over float video records
    else:
        assert native.available()
    utts = _utts(tsyn)[:n]
    pj = str(tmp_path / "j.tfrecord")
    pt = str(tmp_path / "t.tfrecord")
    jtf.write_dataset(_utts(jsyn)[:n], pj, video_codec=codec)
    ttf.write_dataset(utts, pt, video_codec=codec)
    assert open(pj, "rb").read() == open(pt, "rb").read()
    _assert_utts_equal(ttf.read_dataset(pj), jtf.read_dataset(pt))
    _assert_utts_equal(ttf.read_dataset(pt), jtf.read_dataset(pj))
    src_t, src_j = tgrain.TFRecordDataSource(pj), jgrain.TFRecordDataSource(pt)
    assert len(src_t) == len(src_j) == len(utts) and src_t.uids() == src_j.uids()
    _assert_utts_equal([src_t[i] for i in range(3)], [src_j[i] for i in range(3)])


def test_corrupt_record_raises(tmp_path):
    p = str(tmp_path / "c.tfrecord")
    ttf.write_dataset(_utts(tsyn)[:2], p)
    buf = bytearray(open(p, "rb").read())
    buf[20] ^= 0xFF
    open(p, "wb").write(bytes(buf))
    with pytest.raises(ValueError):
        list(ttf.iter_records(p))


LOADERS = {
    "audio": dict(require_audio=True, require_video=False),
    "av": dict(require_audio=True, require_video=True, au_target_stacking=(8, 3)),
    "video": dict(require_audio=False, require_video=True),
}


@pytest.mark.parametrize("kind", sorted(LOADERS))
@pytest.mark.parametrize("transfer", ["float32", "compact"])
def test_bucketing_loader_epochs_equal(kind, transfer):
    data = dict(batch_size=4, audio_bucket_boundaries=(60, 120), label_bucket_caps=(5, 8),
                transfer_dtype=transfer, seed=3)
    jl = jloader.BucketingLoader(_utts(jsyn), jbuiltin("character"), JDataConfig(**data),
                                 **LOADERS[kind])
    tl = tloader.BucketingLoader(_utts(tsyn), builtin_unit_dict("character"),
                                 DataConfig(**data), **LOADERS[kind])
    assert ({b: dataclasses.astuple(s) for b, s in tl.bucket_shapes().items()}
            == {b: dataclasses.astuple(s) for b, s in jl.bucket_shapes().items()})
    for shuffle in (True, False):
        got, want = list(tl.epoch(shuffle)), list(jl.epoch(shuffle))
        assert len(got) == len(want) > 1
        for (bt, t), (bj, j) in zip(got, want):
            assert bt == bj and set(t) == set(j)
            for k in j:
                if isinstance(j[k], np.ndarray):
                    assert t[k].dtype == j[k].dtype, k
                    np.testing.assert_array_equal(t[k], j[k], err_msg=k)
                else:
                    assert t[k] == j[k], k


def test_to_model_batch_equals_its_numpy():
    data = DataConfig(batch_size=4, audio_bucket_boundaries=(60, 120), transfer_dtype="compact")
    tl = tloader.BucketingLoader(_utts(tsyn), builtin_unit_dict("character"), data,
                                 require_video=True, au_target_stacking=(8, 3))
    _, nb = next(tl.epoch(shuffle=False))
    batch = tloader.to_model_batch(nb, device="cpu")
    assert isinstance(batch, tseq.Batch)
    for name in tseq.Batch._fields:
        t = getattr(batch, name)
        if nb.get(name) is None:
            assert t is None, name
            continue
        assert t.device.type == "cpu"
        if name == "uid_hashes":
            assert t.dtype == torch.int64
        np.testing.assert_array_equal(t.numpy(), nb[name], err_msg=name)
    assert batch.audio.dtype == torch.int16 and batch.video.dtype == torch.uint8
    # the scoring fields stay in the host batch
    assert nb["num_real"] == 4 and len(nb["uids"]) == 4 and len(nb["references"]) == 4


def _pairs(seed, n=40):
    rng = np.random.default_rng(seed)
    words = ["the", "a", "cat", "sat", "on", "mat", "dog", "ran", "x", "quick"]
    out = []
    for i in range(n):
        ref = " ".join(rng.choice(words, rng.integers(0, 8)))
        hyp = list(ref)
        for _ in range(rng.integers(0, 5)):
            op = rng.integers(0, 3)
            pos = int(rng.integers(0, len(hyp) + 1))
            ch = str(rng.choice(list("abcdehmnorstx ")))
            if op == 0:
                hyp.insert(pos, ch)
            elif hyp and pos < len(hyp):
                if op == 1:
                    hyp[pos] = ch
                else:
                    del hyp[pos]
        out.append((ref, "".join(hyp), f"u{i}"))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_levenshtein_native_and_numpy_equal_jax(seed):
    assert native.available()
    for ref, hyp, _ in _pairs(seed):
        want = jmet.levenshtein(ref, hyp)
        assert tmet.levenshtein(ref, hyp) == want
        assert tmet._levenshtein_np(ref, hyp) == want
        assert tmet.levenshtein(ref.split(), hyp.split()) == jmet.levenshtein(ref.split(),
                                                                               hyp.split())


@pytest.mark.parametrize("seed", [0, 1])
def test_error_rate_summaries_and_analysis_equal(tmp_path, seed):
    pairs = _pairs(seed)
    accs = []
    for mod in (tmet, jmet):
        acc = mod.ErrorRateAccumulator()
        for ref, hyp, uid in pairs:
            acc.update(ref, hyp, uid)
        accs.append(acc)
    assert accs[0].summary() == accs[1].summary()
    pt, pj = str(tmp_path / "t.txt"), str(tmp_path / "j.txt")
    accs[0].write_predictions(pt)
    accs[1].write_predictions(pj)
    assert open(pt).read() == open(pj).read()
    triples = [(uid, r, h) for r, h, uid in pairs]
    assert tana.analyze(triples) == jana.analyze(triples)
    assert tana.analyze_file(pt) == jana.analyze_file(pj)
    assert tana.align("kitten", "sitting") == jana.align("kitten", "sitting")


def test_native_builds_into_build_dir_at_first_use():
    assert native.available()
    path = native.library_path()
    assert path.parent.name == "build" and path.exists()
    assert not list(native.SOURCE.parent.glob("*.so"))
    assert native.crc32c(b"123456789") == 0xE3069283  # the crc32c check value


def test_without_a_compiler_the_python_paths_run(tmp_path, monkeypatch):
    """No host compiler: ``available()`` is False, framing and scoring take
    their Python paths and give the same files and distances."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native.shutil, "which", lambda _: None)
    monkeypatch.delenv("CXX", raising=False)
    assert not native.available()
    assert not (tmp_path / "build").exists()
    with pytest.raises(RuntimeError, match="unavailable"):
        native.crc32c(b"x")
    p = str(tmp_path / "t.tfrecord")
    ttf.write_dataset(_utts(tsyn)[:3], p)
    pj = str(tmp_path / "j.tfrecord")
    jtf.write_dataset(_utts(jsyn)[:3], pj)
    assert open(p, "rb").read() == open(pj, "rb").read()
    _assert_utts_equal(ttf.read_dataset(p), _utts(tsyn)[:3])
    for ref, hyp, _ in _pairs(5, 10):
        assert tmet.levenshtein(ref, hyp) == jmet.levenshtein(ref, hyp)
    _assert_utts_equal([tgrain.TFRecordDataSource(p)[0]], [jtf.read_dataset(pj)[0]])

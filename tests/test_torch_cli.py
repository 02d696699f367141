"""The port's CLI (``python -m avsr_tpu_torch.cli``) against the JAX
package's (``avsr_tpu.cli``): ``show-config`` prints the same config for
every preset; ``write-records`` (synthetic, sharded, noise banks,
recordings, and a real-media manifest through ``data/ingest.py``) writes
byte-equal files; ``build-units`` and ``analyze`` print the same reports.
Then a ``train`` -> ``train --resume`` -> ``evaluate --greedy`` ->
``average-checkpoints`` -> ``decode`` round trip on a tiny config with
``--device cpu``, and a ``train`` -> ``export`` -> ``transcribe`` round
trip (a greedy artifact, a bucketed n-best one from the best checkpoint;
``.wav`` and ``.npy`` inputs).  The port's parser has every subcommand and
flag of the JAX parser, and ``--device`` where a command builds a model or
loads an artifact."""

import argparse
import json
import os
import wave
from unittest import mock

import numpy as np
import pytest
import torch

from avsr_tpu import cli as jcli
from avsr_tpu.configs import PRESETS
from avsr_tpu_torch import cli as tcli
from avsr_tpu_torch import configs as tconfigs
from avsr_tpu_torch.data import tfrecord
from avsr_tpu_torch.eval.metrics import ErrorRateAccumulator
from test_torch_trainer import tiny_cfg


@pytest.fixture(autouse=True)
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _out(capsys, main, argv):
    capsys.readouterr()
    assert main(argv) == 0
    return capsys.readouterr().out


def _same_files(a, b):
    for name in sorted(os.listdir(a)):
        with open(os.path.join(a, name), "rb") as f, open(os.path.join(b, name), "rb") as g:
            assert f.read() == g.read(), name
    assert sorted(os.listdir(a)) == sorted(os.listdir(b))


@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_show_config_equals_reference(capsys, preset):
    argv = ["show-config", "--preset", preset, "--set", "train.learning_rate=0.0005",
            "--set", "decode.beam_width=4", "--set", "data.audio_bucket_boundaries=[100,200]"]
    got = _out(capsys, tcli.main, argv)
    assert got == _out(capsys, jcli.main, argv)
    cfg = json.loads(got)
    assert cfg["name"] == preset and cfg["decode"]["beam_width"] == 4
    assert _out(capsys, tcli.main, ["show-config", "--preset", preset]) == \
        _out(capsys, jcli.main, ["show-config", "--preset", preset])


def test_show_config_file_and_errors(tmp_path, capsys):
    path = tmp_path / "cfg.json"
    path.write_text(tiny_cfg(tconfigs, "av_align").to_json())
    argv = ["show-config", "--config", str(path)]
    assert _out(capsys, tcli.main, argv) == _out(capsys, jcli.main, argv)
    assert _out(capsys, tcli.main, ["show-config"]) == _out(capsys, jcli.main, ["show-config"])
    with pytest.raises(SystemExit):
        tcli.main(["show-config", "--set", "train.nonexistent=1"])
    with pytest.raises(SystemExit):
        tcli.main(["show-config", "--preset", "no_such_preset"])
    with pytest.raises(SystemExit):
        tcli.main(["show-config", "--set", "novalue"])


@pytest.mark.parametrize("extra", [
    [],
    ["--noise-out", "{d}/noise.tfrecord", "--seed", "3"],
    ["--shards", "2", "--video-codec", "uint8", "--max-chars", "4", "--char-duration", "0.1"],
], ids=["plain", "with-noise", "sharded-uint8"])
def test_write_records_synthetic_byte_equal(tmp_path, capsys, extra):
    outs = {}
    for name, main in (("jax", jcli.main), ("port", tcli.main)):
        d = str(tmp_path / name)
        os.makedirs(d)
        argv = ["write-records", "--synthetic", "5", "--out", f"{d}/train.tfrecord",
                "--noise-samples", "8000"] + [x.format(d=d) for x in extra]
        outs[name] = _out(capsys, main, argv).replace(d, "D")
    assert outs["port"] == outs["jax"]
    _same_files(str(tmp_path / "jax"), str(tmp_path / "port"))


def _write_wav(path, x, rate=16_000):
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes(np.clip(np.asarray(x) * 32767.0, -32768, 32767).astype("<i2").tobytes())


def test_write_noise_banks_byte_equal(tmp_path, capsys):
    media = tmp_path / "media"
    media.mkdir()
    rng = np.random.default_rng(4)
    for i, rate in enumerate((16_000, 8_000)):
        _write_wav(media / f"n{i}.wav", 0.3 * rng.standard_normal(9000), rate)
    (media / "list.txt").write_text(f"# babble\n{media}/n0.wav\n{media}/n1.wav\n")
    for name, main in (("jax", jcli.main), ("port", tcli.main)):
        d = tmp_path / name
        d.mkdir()
        _out(capsys, main, ["write-records", "--noise-out", f"{d}/synth_bank.tfrecord",
                            "--seed", "7", "--noise-samples", "4000"])
        _out(capsys, main, ["write-records", "--noise-wavs", f"{media}/list.txt",
                            "--noise-out", f"{d}/bank.tfrecord", "--noise-samples", "4000"])
        _out(capsys, main, ["write-records", "--noise-wavs", f"{media}/n0.wav,{media}/n1.wav",
                            "--noise-out", f"{d}/bank2.tfrecord", "--noise-samples", "3000"])
    _same_files(str(tmp_path / "jax"), str(tmp_path / "port"))


def test_write_records_manifest_byte_equal(tmp_path, capsys):
    """A real-media manifest: wav (16 and 8 kHz), OpenFace AU CSV, a
    precomputed ROI stack (uint8 range and [0, 1]) and an LRS2-style
    transcript file, relative paths; both codecs, and two shards."""
    media = tmp_path / "media"
    media.mkdir()
    rng = np.random.default_rng(2)
    _write_wav(media / "u0.wav", 0.3 * np.sin(np.arange(8000) / 7.0))
    _write_wav(media / "u1.wav", 0.2 * rng.standard_normal(6000), rate=8_000)
    (media / "u0.csv").write_text("frame, AU01_r, AU02_r\n1, 0.5, 1.5\n2, 0.6, 1.25\n")
    np.save(media / "u0.npy", rng.integers(0, 256, (5, 20, 20)).astype(np.uint8))
    np.save(media / "u1.npy", rng.uniform(0, 1, (4, 20, 20, 1)).astype(np.float32))
    (media / "u1.txt").write_text("Text:  GOOD MORNING\nConf: 3\n")
    (media / "man.csv").write_text(
        "uid,transcript,transcript_file,wav,au_csv,roi_npy\n"
        "u0,hello there,,u0.wav,u0.csv,u0.npy\n"
        "u1,,u1.txt,u1.wav,,u1.npy\n")
    outs = {}
    for name, main in (("jax", jcli.main), ("port", tcli.main)):
        d = tmp_path / name
        d.mkdir()
        outs[name] = [
            _out(capsys, main, ["write-records", "--manifest", f"{media}/man.csv", "--out",
                                f"{d}/{codec}.tfrecord", "--video-codec", codec,
                                "--shards", shards]).replace(str(d), "D")
            for codec, shards in (("uint8", "1"), ("float32", "2"))]
    assert outs["port"] == outs["jax"]
    _same_files(str(tmp_path / "jax"), str(tmp_path / "port"))
    utts = tfrecord.read_dataset(str(tmp_path / "port" / "uint8.tfrecord"))
    assert [u.transcript for u in utts] == ["hello there", "GOOD MORNING"]
    assert utts[0].au.shape == (2, 2) and utts[1].video.shape == (4, 20, 20, 1)
    with pytest.raises(SystemExit):
        tcli.main(["write-records", "--manifest", f"{media}/man.csv"])
    with pytest.raises(SystemExit):
        tcli.main(["write-records"])


def test_build_units_and_analyze_equal_reference(tmp_path, capsys):
    records = str(tmp_path / "train.tfrecord")
    _out(capsys, tcli.main, ["write-records", "--synthetic", "6", "--out", records,
                             "--seed", "3"])
    man = tmp_path / "corpus.csv"
    man.write_text("uid,transcript\na,aab c\nb,ab\n")
    for argv in (["--records", records], ["--manifest", str(man), "--min-count", "2"],
                 ["--records", records, "--manifest", str(man), "--unit-type", "word"]):
        outs = {}
        for name, main in (("jax", jcli.main), ("port", tcli.main)):
            path = str(tmp_path / f"units_{name}.txt")
            outs[name] = _out(capsys, main, ["build-units", *argv, "--out", path]
                              ).replace(path, "OUT")
        assert outs["port"] == outs["jax"], argv
        with open(tmp_path / "units_jax.txt") as a, open(tmp_path / "units_port.txt") as b:
            assert a.read() == b.read()
    with pytest.raises(SystemExit):
        tcli.main(["build-units", "--out", str(tmp_path / "u.txt")])

    preds = []
    refs = ["".join(np.random.default_rng(i).choice(list("abc "), 8)) for i in range(12)]
    for k in range(2):  # two systems' hypotheses of one eval set
        acc = ErrorRateAccumulator()
        r = np.random.default_rng(100 + k)
        for i, ref in enumerate(refs):
            hyp = "".join(r.choice(list("abc "), int(r.integers(5, 10))))
            acc.update(ref, hyp, f"u{i}")
        path = str(tmp_path / f"predictions_{k}.txt")
        acc.write_predictions(path)
        preds.append(path)
    for argv in (["--predictions", preds[0], "--top", "3"],
                 ["--predictions", preds[0], "--bootstrap", "200", "--compare", preds[1]],
                 ["--run-dir", str(tmp_path)]):
        assert _out(capsys, tcli.main, ["analyze", *argv]) == \
            _out(capsys, jcli.main, ["analyze", *argv]), argv


def test_train_resume_evaluate_average_decode_round_trip(tmp_path, capsys):
    records = str(tmp_path / "train.tfrecord")
    _out(capsys, tcli.main, ["write-records", "--synthetic", "8", "--out", records,
                             "--max-chars", "4", "--char-duration", "0.1"])
    cfg = tiny_cfg(tconfigs, num_epochs=1, save_every_steps=0).override(
        {"data.audio_train_records": records, "data.audio_eval_records": records})
    cfg_path = str(tmp_path / "cfg.json")
    with open(cfg_path, "w") as f:
        f.write(cfg.to_json())
    run = ["--config", cfg_path, "--run-dir", str(tmp_path / "run"), "--device", "cpu"]

    first = json.loads(_out(capsys, tcli.main, ["train", *run, "--epochs", "1",
                                                "--logfile", str(tmp_path / "train.log")]))
    assert np.isfinite(first["final"]["loss"])
    steps = sorted(int(s) for s in os.listdir(tmp_path / "run" / "checkpoints") if s.isdigit())
    assert len(steps) == 1
    second = json.loads(_out(capsys, tcli.main, ["train", *run, "--epochs", "2", "--resume"]))
    assert second["final"]["num_utterances"] == 8
    with open(tmp_path / "run" / "checkpoints" / f"extra_{2 * steps[0]}.json") as f:
        assert json.load(f) == {"epoch": 2, "batches_done": 0}
    ev = json.loads(_out(capsys, tcli.main, ["evaluate", *run, "--greedy"]))
    assert ev["num_utterances"] == 8 and np.isfinite(ev["loss"])
    avg = json.loads(_out(capsys, tcli.main, ["average-checkpoints", *run, "--last", "2"]))
    assert avg["averaged_step"] == 2 * steps[0] + 1
    dec = json.loads(_out(capsys, tcli.main, ["decode", *run, "--checkpoint",
                                              str(avg["averaged_step"])]))
    assert dec["num_utterances"] == 8
    best = json.loads(_out(capsys, tcli.main, ["evaluate", *run, "--checkpoint", "best",
                                               "--greedy"]))
    assert np.isfinite(best["loss"])
    assert os.path.exists(tmp_path / "train.log")
    assert os.path.exists(tmp_path / "run" / "predictions_final.txt")


def test_train_export_transcribe_round_trip(tmp_path, capsys):
    """The CLI's serving path: write-records -> train -> export -> a
    ``Predictor`` and ``transcribe`` from the artifact alone."""
    from avsr_tpu_torch.serve import BucketedPredictor, Predictor, load_predictor

    records = str(tmp_path / "train.tfrecord")
    _out(capsys, tcli.main, ["write-records", "--synthetic", "6", "--out", records,
                             "--max-chars", "3", "--char-duration", "0.1"])
    cfg = tiny_cfg(tconfigs, num_epochs=1, save_every_steps=0).override(
        {"data.audio_train_records": records, "data.audio_eval_records": records})
    cfg_path = str(tmp_path / "cfg.json")
    with open(cfg_path, "w") as f:
        f.write(cfg.to_json())
    run = ["--config", cfg_path, "--run-dir", str(tmp_path / "run"), "--device", "cpu"]
    _out(capsys, tcli.main, ["train", *run, "--epochs", "1"])

    art = str(tmp_path / "artifact")
    out = json.loads(_out(capsys, tcli.main, ["export", *run, "--out", art, "--greedy",
                                              "--batch-size", "2", "--seconds", "0.5"]))
    assert out == {"artifact": art}
    utts = tfrecord.read_dataset(records)
    pred = Predictor.load(art, device="cpu")
    hyps = pred.transcribe(audio=[utts[0].waveform, utts[1].waveform])
    assert len(hyps) == 2 and all(isinstance(h, str) for h in hyps)
    assert pred.meta["checkpoint_step"] > 0 and not pred.use_beam
    with pytest.raises(ValueError, match="tpu"):
        tcli.main(["export", *run, "--out", str(tmp_path / "x"), "--platforms", "cpu,tpu"])

    # 3 inputs > batch size 2: the chunking loop; the wav goes through int16
    # PCM, the .npy files are the raw waveforms
    wav_path = str(tmp_path / "u0.wav")
    _write_wav(wav_path, np.clip(utts[0].waveform, -1, 1))
    npys = []
    for i in (1, 2):
        npys.append(str(tmp_path / f"u{i}.npy"))
        np.save(npys[-1], utts[i].waveform)
    out_path = str(tmp_path / "hyps.jsonl")
    stdout = _out(capsys, tcli.main, ["transcribe", "--artifact", art, wav_path, *npys,
                                      "--out", out_path, "--device", "cpu"])
    with open(out_path) as f:
        lines = [json.loads(line) for line in f]
    assert [line["file"] for line in lines] == [wav_path, *npys]
    assert lines[1]["text"] == hyps[1]  # the same bytes as the request above
    assert [json.loads(line) for line in stdout.strip().splitlines()] == lines
    with pytest.raises(SystemExit, match="n_best=1"):
        tcli.main(["transcribe", "--artifact", art, npys[0], "--n-best", "2", "--device", "cpu"])

    buckets = str(tmp_path / "buckets")
    _out(capsys, tcli.main, ["export", *run, "--out", buckets, "--checkpoint", "best",
                             "--batch-size", "2", "--seconds", "0.4,1.0", "--n-best", "2",
                             "--transfer", "float32"])
    bp = load_predictor(buckets, device="cpu")
    assert isinstance(bp, BucketedPredictor) and bp.n_best == 2
    assert [p.meta["transfer"] for p in bp.buckets] == ["float32", "float32"]
    lines = [json.loads(line) for line in _out(capsys, tcli.main, [
        "transcribe", "--artifact", buckets, *npys, "--n-best", "2", "--device",
        "cpu"]).strip().splitlines()]
    want = bp.transcribe_nbest(audio=[np.load(p) for p in npys])
    assert [(line["text"], [(a["text"], a["score"]) for a in line["alternatives"]])
            for line in lines] == [(w[0][0], w) for w in want]


class _Parsed(Exception):
    pass


def _subcommands(main):
    """{subcommand: its option strings (positionals by dest)} of ``main``'s
    parser, caught at its ``parse_args``."""
    seen = {}

    def parse_args(self, args=None, namespace=None):
        seen["parser"] = self
        raise _Parsed

    with mock.patch.object(argparse.ArgumentParser, "parse_args", parse_args):
        with pytest.raises(_Parsed):
            main(["show-config"])
    sub = next(a for a in seen["parser"]._actions if isinstance(a, argparse._SubParsersAction))
    return {name: {o for a in p._actions for o in (a.option_strings or [a.dest])}
            for name, p in sub.choices.items()}


def test_parser_has_every_reference_command_and_flag():
    ref, port = _subcommands(jcli.main), _subcommands(tcli.main)
    assert list(port) == list(ref)
    with_device = {"train", "evaluate", "decode", "average-checkpoints", "export", "serve",
                   "transcribe"}
    for name, flags in ref.items():
        assert port[name] - flags == ({"--device"} if name in with_device else set()), name
        assert flags <= port[name], name

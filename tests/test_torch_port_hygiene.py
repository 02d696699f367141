"""The port stands alone and runs on the card unless asked otherwise.

* ``chip_smoke.py`` imports nothing of ``avsr_tpu`` (read with ``ast``:
  the script is not imported here).
* The port's own copies of ``avsr_tpu/configs.py`` and
  ``avsr_tpu/data/units.py`` agree with the originals: every preset of
  ``PRESETS`` as ``dataclasses.asdict``, the (de)serialization helpers, and
  every builtin unit inventory with its id conventions.
* ``convert.from_jax``, ``seq2seq.model_init``, ``data.loader.to_model_batch``,
  ``serve.Predictor``, ``Predictor.load``, ``serve.load_predictor``,
  ``serve_host.make_server``, ``AVSR``, ``train.loop.Trainer`` and the CLI's
  ``--device`` (``export``, ``serve`` and ``transcribe`` too) default to the
  card (a CPU-only torch refuses them without ``device="cpu"``: none runs on
  the CPU unasked); the internal ``*_init`` helpers take the device from
  their caller.
* Every CUDA source has a plain C interface (no PyTorch headers) and names
  the JAX function it replaces; every kernel counted in ``LAUNCHES`` has
  its entry, with its source, in ``chip_smoke.py``'s kernels line.
"""

import ast
import dataclasses
import inspect
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch

from avsr_tpu import configs as jconfigs
from avsr_tpu.data import units as junits
from avsr_tpu_torch import configs as tconfigs
from avsr_tpu_torch import convert, kernels
from avsr_tpu_torch.data import loader
from avsr_tpu_torch.data import units as tunits
from avsr_tpu_torch.models import (decoder, encoder, fusion, seq2seq, transformer,
                                   transformer_decoder, video_cnn)
from avsr_tpu_torch.ops import attention, rnn
from avsr_tpu_torch.serve import Predictor
from avsr_tpu_torch.utils import params as uparams
from test_torch_trainer import tiny_cfg

ROOT = Path(__file__).resolve().parents[1]


def test_chip_smoke_imports_nothing_of_avsr_tpu():
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names.append(node.module or "")
    assert "avsr_tpu_torch.configs" in names  # the walk sees the script's imports
    bad = [n for n in names if n == "avsr_tpu" or n.startswith("avsr_tpu.")]
    assert not bad, bad
    assert not [n for n in names if n == "jax" or n.startswith("jax.")]


@pytest.mark.parametrize("name", sorted(jconfigs.PRESETS))
def test_presets_equal_in_both_packages(name):
    want = dataclasses.asdict(jconfigs.PRESETS[name]())
    got = tconfigs.PRESETS[name]()
    assert dataclasses.asdict(got) == want
    assert got.to_json() == jconfigs.PRESETS[name]().to_json()
    # a JAX config's dict builds the same port config, and back
    assert tconfigs.ExperimentConfig.from_dict(want) == got
    assert jconfigs.ExperimentConfig.from_dict(got.to_dict()).to_dict() == want


def test_config_helpers_agree():
    base = tconfigs.lrs2_av_fast()
    over = {"train.learning_rate": 3e-4, "decoder.num_heads": 2, "data.audio_bucket_boundaries":
            [100, 200]}
    assert (base.override(over).to_dict()
            == jconfigs.lrs2_av_fast().override(over).to_dict())
    with pytest.raises(KeyError, match="unknown config key"):
        tconfigs.ExperimentConfig.from_dict({"decoder": {"learing_rate": 1.0}})
    assert [f.name for f in dataclasses.fields(tconfigs.ExperimentConfig)] == \
        [f.name for f in dataclasses.fields(jconfigs.ExperimentConfig)]


@pytest.mark.parametrize("unit_type", ["character", "character_lrs2", "phoneme", "viseme"])
def test_builtin_units_equal_in_both_packages(unit_type):
    j, t = junits.builtin_unit_dict(unit_type), tunits.builtin_unit_dict(unit_type)
    assert t.idx_to_unit == j.idx_to_unit and t.unit_to_idx == j.unit_to_idx
    assert t.vocab_size == j.vocab_size and t.unit_type == j.unit_type
    assert (tunits.PAD_ID, tunits.GO_ID, tunits.EOS_ID) == (junits.PAD_ID, junits.GO_ID,
                                                            junits.EOS_ID) == (0, 1, 2)
    text = "hello 2 you" if unit_type.startswith("character") else " ".join(j.idx_to_unit[3:6])
    assert t.encode(text) == j.encode(text)
    assert t.decode(j.encode(text)) == j.decode(j.encode(text))


def test_entry_points_default_to_the_card(tmp_path):
    from avsr_tpu_torch import cli
    from avsr_tpu_torch.avsr import AVSR
    from avsr_tpu_torch.data.synthetic import SyntheticSpec, generate
    from avsr_tpu_torch.train.loop import Trainer

    from avsr_tpu_torch import serve, serve_host

    for fn in (convert.from_jax, convert.from_jax_leaves, seq2seq.model_init,
               loader.to_model_batch, AVSR, Trainer, Predictor.load, serve.load_predictor,
               serve_host.make_server):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    records = str(tmp_path / "train.tfrecord")
    assert cli.main(["write-records", "--synthetic", "2", "--out", records]) == 0
    seen = {}
    with mock.patch.object(cli, "_build_avsr", lambda args: seen.setdefault("device",
                                                                            args.device)):
        with pytest.raises(AttributeError):
            cli.main(["train", "--preset", "lrs2_av_fast"])
    assert seen["device"] == "cuda"
    with mock.patch.object(cli, "_build_avsr", lambda args: seen.__setitem__("export",
                                                                             args.device)):
        with pytest.raises(AttributeError):
            cli.main(["export", "--preset", "lrs2_av_fast", "--out", str(tmp_path / "x")])

    def loaded(what):
        def load(*args, **kwargs):
            seen[what] = kwargs["device"]
            raise RuntimeError("loaded")
        return load

    with mock.patch.object(serve_host, "make_server", loaded("serve")), \
            mock.patch.object(serve, "load_predictor", loaded("transcribe")):
        for argv in (["serve", "--artifact", "x"], ["transcribe", "--artifact", "x", "a.wav"]):
            with pytest.raises(RuntimeError, match="loaded"):
                cli.main(argv)
    assert (seen["export"], seen["serve"], seen["transcribe"]) == ("cuda",) * 3
    if torch.cuda.is_available():
        pytest.skip("a CUDA build of torch would place the tensors on the card")
    cfg = tconfigs.lrs2_av_fast()
    with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
        convert.from_jax({"w": np.zeros(2, np.float32)})
    with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
        seq2seq.model_init(cfg, 44, torch.Generator().manual_seed(0))
    nb = loader.NumpyBatch(audio=np.zeros((2, 8), np.int16),
                           audio_lengths=np.array([8, 4], np.int32))
    with pytest.raises((AssertionError, RuntimeError), match="CUDA|accelerator"):
        loader.to_model_batch(nb)
    data = generate(SyntheticSpec(num_utterances=2, seed=0))
    with pytest.raises(RuntimeError, match="CUDA"):
        AVSR(architecture="audio", train_utterances=data, run_dir=str(tmp_path / "a"))
    units = tunits.builtin_unit_dict("character")
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(tconfigs.audio_only_tcdtimit(), units,
                loader.BucketingLoader(data, units, tconfigs.DataConfig()),
                run_dir=str(tmp_path / "t"))
    argv = ["--set", f"data.audio_train_records={records}", "--run-dir", str(tmp_path / "c")]
    for cmd in ("train", "evaluate", "decode", "average-checkpoints"):
        with pytest.raises(RuntimeError, match="CUDA"):
            cli.main([cmd, "--preset", "audio_tcdtimit", *argv])
    assert not (tmp_path / "a").exists() and not (tmp_path / "t").exists()
    art = str(tmp_path / "artifact")
    cfg = tiny_cfg(tconfigs, "audio")
    params = seq2seq.model_init(cfg, units.vocab_size, torch.Generator().manual_seed(0), "cpu")
    serve.save_artifact(art, *serve.export_decode(params, cfg, batch_size=2, audio_seconds=0.2),
                        units)
    for load in (Predictor.load, serve.load_predictor):
        with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
            load(art)
        assert load(art, device="cpu").transcribe(audio=[np.zeros(1600, np.float32)])
    p = convert.from_jax({"w": np.zeros(2, np.float32)}, device="cpu")
    assert p["w"].device.type == "cpu"
    assert loader.to_model_batch(nb, device="cpu").audio.device.type == "cpu"


@pytest.mark.parametrize("fn", [
    rnn.lstm_init, rnn.gru_init, rnn.cell_init, attention.value_only_init, attention.bahdanau_init, attention.attention_init,
    encoder.encoder_init, video_cnn.video_cnn_init, fusion.cross_attention_fusion_init,
    fusion.av_align_init, decoder.decoder_init,
    transformer_decoder.transformer_decoder_init, transformer.transformer_encoder_init,
    uparams.glorot_uniform, uparams.orthogonal,
    uparams.normal_init, uparams.zeros,
], ids=lambda f: f.__name__)
def test_init_helpers_take_the_callers_device(fn):
    param = inspect.signature(fn).parameters["device"]
    assert param.default is inspect.Parameter.empty


@pytest.mark.parametrize("name", sorted(tconfigs.PRESETS))
def test_kernel_length_limits_take_every_bucket(name):
    """The loader's largest bucket (16 s: 1600 audio frames) fits the
    kernels' length limits: its video frames ``kernels.FUSION_MAX_TV``
    (K4, K8; 401 = ceil(1600 * 25 / 100) + 1) and its stacked audio steps
    ``kernels.ATTEND_MAX_S`` (K4's T_a, K10, K11), so a warm-up step on
    every bucket reaches the kernels."""
    cfg = tconfigs.PRESETS[name]()
    shapes = loader.BucketingLoader([], tunits.builtin_unit_dict(cfg.data.unit), cfg.data,
                                    frame_step=cfg.audio.frame_step,
                                    frame_length=cfg.audio.frame_length).bucket_shapes()
    a = cfg.audio
    video = max(s.video_frames for s in shapes.values())
    frames = max((s.audio_samples - a.frame_length) // a.frame_step + 1 for s in shapes.values())
    steps = (frames - a.frame_stacking) // a.frame_skipping + 1
    assert video == kernels.FUSION_MAX_TV == 401
    assert steps == kernels.ATTEND_MAX_S == 531


@pytest.mark.parametrize("name", sorted(tconfigs.PRESETS))
def test_rnn_option_kernels_take_every_bucket(name):
    """Every RNN encoder of every preset, with GRU cells or under recurrent
    dropout, reaches a kernel at every bucket's batch size: K12
    (``kernels.gru_family``: one cluster launch a call, or one launch a
    step, each looping over time, so no length limit) and the masked K1 /
    K2 (``kernels.lstm_family``, the unmasked kernels' route) take the
    encoder's width at each direction count."""
    cfg = tconfigs.PRESETS[name]()
    sizes = cfg.data.bucket_batch_sizes or (cfg.data.batch_size,)
    encoders = [e for e in (cfg.audio_encoder, cfg.video_encoder) if e.encoder_type == "rnn"]
    for enc in encoders:
        G = 2 if enc.bidirectional else 1
        for H in enc.hidden_units:
            for B in sorted(set(sizes)) + [1, 8]:
                assert kernels.gru_family(G, B, H) in ("cluster", "step")
                assert kernels.lstm_family(G, B, H) in ("cluster", "step")
            smem = (kernels.gru_cluster_smem if kernels.gru_family(G, 1, H) == "cluster"
                    else kernels.gru_step_smem)
            assert smem(H, backward=True) <= kernels.SMEM_LIMIT


@pytest.mark.parametrize("name", sorted(tconfigs.PRESETS))
def test_ln_lstm_and_frontend_options_take_every_bucket(name):
    """Every RNN encoder of every preset, with LN-LSTM cells, reaches K13 at
    every bucket's batch size (``kernels.ln_lstm_family``; one launch a
    call, cluster or block, that loops over time, so no length limit), and every
    frontend option of the preset's audio frontend fits K3 at every bucket
    (the writer's chunk for 3M or M features, the spectrogram's 257 bins;
    the statistics' column of frames)."""
    cfg = tconfigs.PRESETS[name]()
    sizes = sorted(set(cfg.data.bucket_batch_sizes or (cfg.data.batch_size,))) + [1, 8]
    for enc in (cfg.audio_encoder, cfg.video_encoder):
        if enc.encoder_type != "rnn":
            continue
        G = 2 if enc.bidirectional else 1
        for H in enc.hidden_units:
            for B in sizes:
                assert kernels.ln_lstm_family(G, B, H) in ("cluster", "block")
            smem = (kernels.ln_lstm_cluster_smem if kernels.ln_lstm_family(G, 1, H) == "cluster"
                    else kernels.ln_lstm_smem)
            assert smem(H, backward=True) <= kernels.SMEM_LIMIT
    a = cfg.audio
    shapes = loader.BucketingLoader([], tunits.builtin_unit_dict(cfg.data.unit), cfg.data,
                                    frame_step=a.frame_step,
                                    frame_length=a.frame_length).bucket_shapes()
    for s in shapes.values():
        T = (s.audio_samples - a.frame_length) // a.frame_step + 1
        Tp = (T - a.frame_stacking) // a.frame_skipping + 1
        assert kernels.logmel_stats_fits(T)
        for M in (a.num_mel_bins, a.fft_length // 2 + 1):
            for deltas in (True, False):
                for B in sizes:
                    chunk = kernels.logmel_writer_chunk(B, Tp, M, a.frame_stacking,
                                                        a.frame_skipping, a.delta_window, deltas)
                    assert kernels.logmel_writer_smem(M, chunk, a.frame_stacking,
                                                      a.frame_skipping, a.delta_window,
                                                      deltas) <= kernels.SMEM_LIMIT


OPTIONS = {"layer_norm": {"audio_encoder.layer_norm": True,
                          "audio_encoder.recurrent_dropout_rate": 0.2},
           "spectrogram": {"audio.feature_type": "spectrogram"},
           "static": {"audio.add_deltas": False},
           "global": {"audio.normalization": "global"},
           "none": {"audio.normalization": "none"},
           "rfft": {"audio.use_matmul_dft": False},
           "spec_augment": {"audio.spec_augment": True},
           "lamb": {"train.optimizer": "lamb"}}


@pytest.mark.parametrize("option", sorted(OPTIONS))
def test_every_option_trains_with_remat_and_only_k1_of_its_scans_takes_fp32(option):
    """Each option the port used to refuse now initialises, trains a step
    (and one more with ``train.remat``), and decodes on the CPU; on the
    card the fp32 policy is accepted by K1's kernels and still refused by
    K12's and K13's, whose fp32 instances are still to be ported."""
    cfg = tiny_cfg(tconfigs).override(OPTIONS[option])
    V = tunits.builtin_unit_dict(cfg.data.unit).vocab_size
    from avsr_tpu_torch.train import step as tstep
    from test_torch_train import batch_arrays

    state, opt = tstep.create_train_state(cfg, V, torch.Generator().manual_seed(0), "cpu")
    batch = seq2seq.batch_to_device(batch_arrays(0, V), "cpu")
    state, metrics = tstep.train_step(state, batch, cfg=cfg, optimizer=opt,
                                      generator=torch.Generator().manual_seed(1))
    assert np.isfinite(float(metrics["loss"]))
    state, metrics = tstep.train_step(state, batch, cfg=cfg.override({"train.remat": True}),
                                      optimizer=opt, generator=torch.Generator().manual_seed(2))
    assert np.isfinite(float(metrics["loss"])) and state.step == 2
    with torch.no_grad():
        enc = seq2seq.encode(state.params, cfg, batch)
    assert all(torch.isfinite(m.values).all() for m in enc.memories)
    from avsr_tpu_torch.utils.numerics import check_policy

    check_policy(torch.float32, "K1")
    for family in ("K12", "K13"):
        with pytest.raises(ValueError, match=f"{family}: the fp32 instance"):
            check_policy(torch.float32, family)


def test_ln_leaves_take_the_callers_device():
    """The LN leaves are made on the caller's device, as the LSTM's are."""
    p = rnn.lstm_init(torch.Generator(), 4, 8, "meta", layer_norm=True)
    assert {k: v.device.type for k, v in p.items()} == dict.fromkeys(p, "meta")


def test_predictor_defaults_to_the_card():
    assert inspect.signature(Predictor).parameters["device"].default == "cuda"


CSRC = sorted((ROOT / "avsr_tpu_torch" / "csrc").glob("*.cu*"))


@pytest.mark.parametrize("src", CSRC, ids=lambda p: p.name)
def test_cuda_sources_are_plain_c_and_name_their_reference(src):
    text = src.read_text()
    assert "#include <torch" not in text and "ATen" not in text and "pybind11" not in text
    head = text.split("#include")[0]
    assert "avsr_tpu/" in head, f"{src.name}: the leading comment names no JAX function"
    if src.suffix == ".cu":
        assert 'extern "C"' in text


def test_every_kernel_has_its_chip_smoke_entry():
    smoke = (ROOT / "chip_smoke.py").read_text()
    for name in kernels.LAUNCHES:
        assert f'"{name}": ("avsr_tpu_torch/csrc/' in smoke, name
    for src in CSRC:
        if src.suffix == ".cu":
            assert f"avsr_tpu_torch/csrc/{src.name}" in smoke, src.name


def test_ptxas_report_reads_registers_and_spills(tmp_path, monkeypatch):
    """``kernels.ptxas_report`` parses the ``ptxas -v`` log the build keeps
    beside the library (chip_smoke phase 20 fails a K11 kernel on it)."""
    lib = tmp_path / "libavsr_kernels_0123.so"
    (tmp_path / "libavsr_kernels_0123.encoder_attention.ptxas.txt").write_text(
        "ptxas info    : 0 bytes gmem\n"
        "ptxas info    : Compiling entry function '_Z12attn_mma_fwdv' for 'sm_90a'\n"
        "ptxas info    : Function properties for _Z12attn_mma_fwdv\n"
        "    112 bytes stack frame, 412 bytes spill stores, 332 bytes spill loads\n"
        "ptxas info    : Used 168 registers, used 1 barriers, 112 bytes cumulative stack size\n"
        "ptxas info    : Compiling entry function '_Z14attn_mma_bwd_qv' for 'sm_90a'\n"
        "ptxas info    : Function properties for _Z14attn_mma_bwd_qv\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 125 registers, used 1 barriers, 472 bytes cmem[0]\n")
    monkeypatch.setattr(kernels, "build", lambda: lib)
    assert kernels.ptxas_report("encoder_attention") == {
        "_Z12attn_mma_fwdv": {"registers": 168, "spill_stores": 412, "spill_loads": 332},
        "_Z14attn_mma_bwd_qv": {"registers": 125, "spill_stores": 0, "spill_loads": 0},
    }

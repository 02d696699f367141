"""The port's ``Trainer`` (``avsr_tpu_torch/train/loop.py``) against the JAX
package's, and the reference's own invariants of the loop.

Parity: the JAX ``AVSR`` / ``Trainer`` and the port's train the same tiny
config (``tiny_cfg``: ``audio`` and ``av_align`` with the AU loss, fp32,
Adam at lr 1e-3, dropout 0, scheduled sampling 0, noise off; two buckets; 12 synthetic
utterances in batches of 4, 2 epochs, a checkpoint every 2 steps, a beam
eval every epoch) from the same parameters (the JAX state's, through
``convert.from_jax``).  Without random draws the two runs see the same
batches in the same order; they agree on:

* the logged per-step losses at rtol 1e-4, and the parameters at the end
  at atol 2e-5 / rtol 1e-4 (``tests/test_torch_train.py``'s step
  tolerances);
* the checkpoint step labels, every ``extra_*.json`` and ``best.json``,
  exactly;
* the eval CER, the predictions files and the error-rate files, exactly:
  the decoded ids agree in these runs (a file that differed would show
  the ids that differ, and the test would fail there).

At the reference loop test's lr 5e-3 (``reference_lr``) the losses agree
at rtol 1e-4 and the first gradients to a millionth of the largest; the
parameters hold to atol 2e-5 / rtol 1e-4 plus the first Adam update's
difference, which is of order lr where a first gradient is about eps.

The invariants (port alone, the same tiny config): mid-epoch and
graceful-stop resumes are bit-exact, ``warmup`` leaves training
bit-identical, early-stop patience survives a resume, ``best.json`` pins
its step, ``evaluate(checkpoint="best")`` restores that step, a fresh run
discards an old ``best.json``, the SIGTERM handler requests the stop, and
the constructor's checks.
"""

import dataclasses
import json
import os
import shutil
import signal

import jax
import numpy as np
import pytest
import torch

from avsr_tpu import configs as jconfigs
from avsr_tpu.avsr import AVSR as JAVSR
from avsr_tpu_torch import configs as tconfigs
from avsr_tpu_torch import convert
from avsr_tpu_torch.avsr import AVSR
from avsr_tpu_torch.data.synthetic import SyntheticSpec, generate
from avsr_tpu_torch.utils.params import tree_leaves


@pytest.fixture(autouse=True)
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def tiny_cfg(c, arch="audio", **train):
    """A tiny config of either package (``c`` is its ``configs`` module)."""
    return c.ExperimentConfig(
        architecture=arch,
        audio=c.AudioFrontendConfig(num_mel_bins=12, fft_length=256, frame_stacking=3,
                                    frame_skipping=3),
        video=c.VideoFrontendConfig(roi_height=20, roi_width=20, conv_channels=(4, 8),
                                    embedding_dim=12),
        audio_encoder=c.EncoderConfig(hidden_units=(16,), bidirectional=True, dropout_rate=0.0),
        video_encoder=c.EncoderConfig(hidden_units=(8,), bidirectional=True, dropout_rate=0.0),
        fusion=c.FusionConfig(attention_units=12, au_loss_weight=0.5),
        decoder=c.DecoderConfig(embedding_dim=8, hidden_units=(16,), attention_units=12,
                                max_label_length=6, dropout_rate=0.0),
        data=c.DataConfig(batch_size=4, audio_bucket_boundaries=(40, 80), max_label_length=6),
        train=c.TrainConfig(**{**dict(learning_rate=1e-3, num_epochs=2, compute_dtype="float32",
                                      log_every_steps=1, save_every_steps=2), **train}),
        decode=c.DecodeConfig(beam_width=3, max_decode_length=6),
        name=f"tiny_{arch}")


def synth(n=12, seed=0):
    """n utterances of 2-5 characters (0.2-0.5 s: both buckets), 20x20 ROIs."""
    return generate(SyntheticSpec(num_utterances=n, min_chars=2, max_chars=5, seed=seed,
                                  alphabet="abcd", char_duration_s=0.1, roi=20))


def port_avsr(run_dir, arch="audio", data=None, **train):
    data = synth() if data is None else data
    return AVSR(config=tiny_cfg(tconfigs, arch, **train), run_dir=str(run_dir),
                train_utterances=data, eval_utterances=data, device="cpu")


def load_jax_params(trainer, jparams):
    """Copy a JAX parameter tree into the port trainer's state tensors."""
    src = dict(tree_leaves(convert.from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                                            device="cpu")))
    with torch.no_grad():
        for p, t in tree_leaves(trainer.state.params):
            t.copy_(src[p])


def params_equal(a, b):
    return all(torch.equal(x, y) for (_, x), (_, y) in zip(tree_leaves(a), tree_leaves(b)))


def read_jsonl(run_dir, kind):
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        return [r for r in map(json.loads, f) if r["kind"] == kind]


# ---------------------------------------------------------------------------
# parity with the JAX Trainer
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=["audio", "av_align"])
def parity(request, tmp_path_factory):
    arch = request.param
    tmp = tmp_path_factory.mktemp(f"parity_{arch}")
    data = synth()
    j = JAVSR(config=tiny_cfg(jconfigs, arch), run_dir=str(tmp / "jax"),
              train_utterances=data, eval_utterances=data)
    t = AVSR(config=tiny_cfg(tconfigs, arch), run_dir=str(tmp / "port"),
             train_utterances=data, eval_utterances=data, device="cpu")
    load_jax_params(t.trainer, j.trainer.state.params)
    jm = j.train()
    tm = t.train()
    return dict(j=j, t=t, jm=jm, tm=tm, jdir=str(tmp / "jax"), tdir=str(tmp / "port"))


def test_logged_losses_match(parity):
    jl, tl = (read_jsonl(parity[k], "train") for k in ("jdir", "tdir"))
    assert len(jl) == len(tl) == 8  # 2 epochs x 4 batches, a log line a step
    for a, b in zip(jl, tl):
        assert (a["step"], a["epoch"], a["bucket"]) == (b["step"], b["epoch"], b["bucket"])
        np.testing.assert_allclose(b["loss"], a["loss"], rtol=1e-4)
        np.testing.assert_allclose(b["lr"], a["lr"], rtol=1e-6)
        assert b["sampling_p"] == a["sampling_p"]


def test_final_parameters_match(parity):
    want = {convert.path_key(p): np.asarray(x) for p, x in
            convert.jax_order_leaves(jax.tree_util.tree_map(np.asarray,
                                                            parity["j"].trainer.state.params))}
    got = {convert.path_key(p): x for p, x in
           convert.jax_order_leaves(convert.to_jax_numpy(parity["t"].trainer.state.params))}
    assert list(got) == list(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, atol=2e-5, rtol=1e-4, err_msg=k)
    assert parity["t"].trainer._host_step == int(parity["j"].trainer.state.step) == 8


def test_checkpoint_labels_extras_and_best_match(parity):
    jck = os.path.join(parity["jdir"], "checkpoints")
    tck = os.path.join(parity["tdir"], "checkpoints")
    assert parity["t"].trainer.ckpt.all_steps() == parity["j"].trainer.ckpt.all_steps() \
        == [2, 4, 6, 8]
    extras = sorted(f for f in os.listdir(jck) if f.startswith("extra_"))
    assert extras == sorted(f for f in os.listdir(tck) if f.startswith("extra_"))
    for f in extras:
        with open(os.path.join(jck, f)) as a, open(os.path.join(tck, f)) as b:
            assert json.load(a) == json.load(b), f
    with open(os.path.join(parity["jdir"], "best.json")) as a, \
            open(os.path.join(parity["tdir"], "best.json")) as b:
        assert json.load(a) == json.load(b)


def test_eval_cer_and_prediction_files_match(parity):
    for k in ("cer", "wer", "num_utterances"):
        assert parity["tm"][k] == parity["jm"][k], k
    np.testing.assert_allclose(parity["tm"]["loss"], parity["jm"]["loss"], rtol=1e-4)
    files = sorted(f for f in os.listdir(parity["jdir"])
                   if f.startswith(("predictions_", "error_rates_")))
    assert len(files) == 4
    for f in files:
        with open(os.path.join(parity["jdir"], f)) as a, \
                open(os.path.join(parity["tdir"], f)) as b:
            assert a.read() == b.read(), f
    je, te = (read_jsonl(parity[k], "eval") for k in ("jdir", "tdir"))
    assert [r["cer"] for r in je] == [r["cer"] for r in te]


# ---------------------------------------------------------------------------
# parity at the reference loop test's learning rate (tests/test_train_loop.py)
# ---------------------------------------------------------------------------

REFERENCE_LR = 5e-3
ADAM_EPS = 1e-8  # optax.adam's default, the port's Optimizer.EPS


@pytest.fixture(scope="module", params=["audio", "av_align"])
def reference_lr(request, tmp_path_factory):
    """Both trainers at lr 5e-3 with a checkpoint after every step."""
    arch = request.param
    tmp = tmp_path_factory.mktemp(f"reference_lr_{arch}")
    data = synth()
    kw = dict(learning_rate=REFERENCE_LR, save_every_steps=1, keep_checkpoints=10,
              eval_every_epochs=100)
    j = JAVSR(config=tiny_cfg(jconfigs, arch, **kw), run_dir=str(tmp / "jax"),
              train_utterances=data, eval_utterances=data)
    t = AVSR(config=tiny_cfg(tconfigs, arch, **kw), run_dir=str(tmp / "port"),
             train_utterances=data, eval_utterances=data, device="cpu")
    load_jax_params(t.trainer, j.trainer.state.params)
    j.train()
    t.train()

    def jax_keyed(tree):
        return {convert.path_key(p): np.asarray(x) for p, x in
                convert.jax_order_leaves(jax.tree_util.tree_map(np.asarray, tree))}

    import optax
    jstate, _, _ = j.trainer.ckpt.restore(j.trainer.state, 1)
    with np.load(os.path.join(tmp, "port", "checkpoints", "1", "opt_state.npz")) as z:
        tmu = {k[len("mu/"):]: z[k] for k in z.files if k.startswith("mu/")}
    # mu after the first step is (1 - b1) g: the clipped first gradients.
    first = dict(jax={k: v / 0.1 for k, v in jax_keyed(optax.tree_utils.tree_get(
        jstate.opt_state, "mu")).items()}, port={k: v / 0.1 for k, v in tmu.items()})
    final = dict(jax=jax_keyed(j.trainer.state.params),
                 port=dict((convert.path_key(p), x) for p, x in convert.jax_order_leaves(
                     convert.to_jax_numpy(t.trainer.state.params))))
    return dict(jdir=str(tmp / "jax"), tdir=str(tmp / "port"), first=first, final=final)


def test_reference_lr_losses_match(reference_lr):
    jl, tl = (read_jsonl(reference_lr[k], "train") for k in ("jdir", "tdir"))
    assert len(jl) == len(tl) == 8
    for a, b in zip(jl, tl):
        assert a["step"] == b["step"]
        np.testing.assert_allclose(b["loss"], a["loss"], rtol=1e-4)


def test_reference_lr_first_gradients_match(reference_lr):
    """The first step's gradients agree to fp32 rounding of the largest
    gradient (a millionth of it)."""
    want, got = reference_lr["first"]["jax"], reference_lr["first"]["port"]
    assert sorted(got) == sorted(want)
    scale = max(float(np.abs(w).max()) for w in want.values())
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=0, atol=1e-6 * scale, err_msg=k)


def test_reference_lr_parameters_drift_only_by_the_first_adam_step(reference_lr):
    """At lr 5e-3 a few parameters end past atol 2e-5 / rtol 1e-4.  Each is
    one whose first gradient is about Adam's eps (1e-8): the first update
    ``g / (|g| + eps)`` turns a rounding-size gradient difference (6e-10 on
    a gradient of 8e-9) into a difference of order lr.  So every element
    holds to the stated tolerance plus exactly that first update's
    difference, computed from each run's own first gradient; any other
    drift (a formula that differs, the bias correction, eps placement)
    fails here."""
    g_j, g_p = reference_lr["first"]["jax"], reference_lr["first"]["port"]
    want, got = reference_lr["final"]["jax"], reference_lr["final"]["port"]
    for k, w in want.items():
        u_j = g_j[k] / (np.abs(g_j[k]) + ADAM_EPS)
        u_p = g_p[k] / (np.abs(g_p[k]) + ADAM_EPS)
        first_step = REFERENCE_LR * np.abs(u_j - u_p)
        limit = 2e-5 + 1e-4 * np.abs(w) + first_step
        excess = np.abs(got[k] - w) - limit
        assert excess.max() <= 0, (k, np.unravel_index(np.argmax(excess), w.shape),
                                   float(excess.max()))


# ---------------------------------------------------------------------------
# the reference's invariants
# ---------------------------------------------------------------------------


def test_midepoch_resume_bit_exact(tmp_path):
    a = port_avsr(tmp_path / "a", save_every_steps=1, keep_checkpoints=10,
                  eval_every_epochs=100)
    a.train()  # 4 batches an epoch -> 8 steps
    assert a.trainer._host_step == 8
    shutil.copytree(tmp_path / "a" / "checkpoints", tmp_path / "b" / "checkpoints")
    b = port_avsr(tmp_path / "b", save_every_steps=1, keep_checkpoints=10,
                  eval_every_epochs=100)
    assert b.trainer.restore_checkpoint(step=6) == 6
    assert b.trainer.epoch == 1 and b.trainer._resume_batches == 2
    b.train()
    assert b.trainer._host_step == 8 and b.trainer.state.step == 8
    assert params_equal(a.trainer.state.params, b.trainer.state.params)
    for x, y in zip(a.trainer.state.opt_state["nu"], b.trainer.state.opt_state["nu"]):
        assert torch.equal(x, y)


def test_graceful_stop_resumes_bit_exact(tmp_path):
    kw = dict(keep_checkpoints=10, eval_every_epochs=100)
    a = port_avsr(tmp_path / "full", **kw)
    a.train()
    b = port_avsr(tmp_path / "stop", **kw)
    orig = b.trainer.logger.log

    def stopping_log(kind, **fields):
        orig(kind, **fields)
        if kind == "train" and fields.get("step") == 5:  # mid-epoch 2
            b.trainer.request_stop()

    b.trainer.logger.log = stopping_log
    b.train()
    assert b.trainer._host_step == 5
    c = port_avsr(tmp_path / "stop", **kw)
    assert c.trainer.try_restore_latest_checkpoint()
    assert c.trainer.epoch == 1 and c.trainer._resume_batches == 1
    c.train()
    assert c.trainer._host_step == 8
    assert params_equal(a.trainer.state.params, c.trainer.state.params)


def test_sigterm_during_train_requests_the_stop(tmp_path):
    """``train`` installs a SIGTERM handler that only requests the stop,
    and puts the previous handler back after."""
    before = signal.getsignal(signal.SIGTERM)
    b = port_avsr(tmp_path / "sig", eval_every_epochs=100)
    orig = b.trainer.logger.log
    seen = []

    def log(kind, **fields):
        orig(kind, **fields)
        if kind == "train" and fields.get("step") == 2:
            handler = signal.getsignal(signal.SIGTERM)
            seen.append(handler)
            handler(signal.SIGTERM, None)

    b.trainer.logger.log = log
    b.train()
    assert callable(seen[0]) and seen[0] is not before
    assert b.trainer._host_step == 2 and b.trainer.ckpt.latest_step() == 2
    assert signal.getsignal(signal.SIGTERM) is before


def test_warmup_is_invisible_to_training(tmp_path):
    a = port_avsr(tmp_path / "a", "av_align", num_epochs=1, eval_every_epochs=100)
    gen_state = a.trainer._generator.get_state()
    before = [x.clone() for _, x in tree_leaves(a.trainer.state.params)]
    assert a.trainer.warmup() == len(a.trainer.train_loader.bucket_shapes()) == 2
    assert all(torch.equal(x, y) for x, (_, y) in zip(before, tree_leaves(a.trainer.state.params)))
    assert torch.equal(a.trainer._generator.get_state(), gen_state)
    assert a.trainer.state.opt_state["count"] == 0 and a.trainer._host_step == 0
    a.train()
    b = port_avsr(tmp_path / "b", "av_align", num_epochs=1, eval_every_epochs=100)
    b.train()
    assert params_equal(a.trainer.state.params, b.trainer.state.params)


def _script_evals(trainer, cers):
    """Replace the eval with a scripted CER sequence; checkpoints still
    happen for real."""
    it = iter(cers)

    def fake_evaluate(*, epoch=None, use_beam=True, loader=None):
        return {"cer": next(it), "wer": 1.0, "num_utterances": 12}

    trainer.evaluate = fake_evaluate


def test_best_json_pins_its_step(tmp_path):
    av = port_avsr(tmp_path / "keep1", num_epochs=4, keep_checkpoints=1, save_every_steps=0)
    _script_evals(av.trainer, [0.5, 0.3, 0.6, 0.4])
    av.train()
    with open(tmp_path / "keep1" / "best.json") as f:
        best = json.load(f)
    assert best["cer"] == 0.3 and best["epoch"] == 2 and best["step"] == 8
    assert av.trainer.ckpt.all_steps() == [8, 16]


def test_early_stop_patience_survives_resume(tmp_path):
    av = port_avsr(tmp_path / "run", num_epochs=2, early_stop_patience=2, save_every_steps=0)
    _script_evals(av.trainer, [0.3, 0.5])  # improve, then plateau
    av.train()
    assert av.trainer._evals_since_best == 1
    with open(tmp_path / "run" / "best.json") as f:
        assert json.load(f)["evals_since_best"] == 1
    again = port_avsr(tmp_path / "run", num_epochs=6, early_stop_patience=2, save_every_steps=0)
    assert again.trainer._evals_since_best == 1 and again.trainer._best_cer == 0.3
    assert again.trainer.ckpt._preserved == {4}
    _script_evals(again.trainer, [0.6, 0.6, 0.6])
    again.train(try_restore_latest_checkpoint=True)
    assert again.trainer.epoch == 3  # one more plateaued eval reached the patience


def test_evaluate_checkpoint_best_restores_that_step(tmp_path):
    av = port_avsr(tmp_path / "run", num_epochs=3, save_every_steps=0)
    _script_evals(av.trainer, [0.5, 0.2, 0.6])
    av.train()
    with open(tmp_path / "run" / "best.json") as f:
        best_step = json.load(f)["step"]
    assert best_step == 8 and av._resolve_checkpoint_step("best") == 8
    del av.trainer.evaluate
    metrics = av.evaluate(checkpoint="best")
    assert np.isfinite(metrics["loss"])
    assert av.trainer._host_step == av.trainer.state.step == 8
    saved = port_avsr(tmp_path / "other")
    saved.trainer.ckpt = av.trainer.ckpt
    saved.trainer.restore_checkpoint(8)
    assert params_equal(saved.trainer.state.params, av.trainer.state.params)


def test_fresh_run_discards_an_old_best_json(tmp_path):
    av = port_avsr(tmp_path / "run", num_epochs=1, save_every_steps=0)
    _script_evals(av.trainer, [0.1])
    av.train()
    assert os.path.exists(tmp_path / "run" / "best.json")
    fresh = port_avsr(tmp_path / "run", num_epochs=1, save_every_steps=0)
    assert fresh.trainer._best_cer == 0.1
    _script_evals(fresh.trainer, [0.9])
    fresh.train()  # fresh (no resume): the old record describes another model
    with open(tmp_path / "run" / "best.json") as f:
        assert json.load(f)["cer"] == 0.9


def test_constructor_checks(tmp_path):
    data = synth()
    base = tiny_cfg(tconfigs)
    with pytest.raises(ValueError, match="grad_accum_steps"):
        AVSR(config=base.override({"train.grad_accum_steps": 3}), run_dir=str(tmp_path / "a"),
             train_utterances=data, device="cpu")
    with pytest.raises(ValueError, match="must divide its batch"):
        AVSR(config=base.override({"data.bucket_grad_accum": [2, 3]}),
             run_dir=str(tmp_path / "b"), train_utterances=data, device="cpu")
    with pytest.raises(ValueError, match="ROADMAP.md queue 1 item 8"):
        AVSR(config=base.override({"train.num_data_shards": 2}), run_dir=str(tmp_path / "c"),
             train_utterances=data, device="cpu")
    rng = np.random.default_rng(0)
    bank = {n: rng.standard_normal((1, 20_000)).astype(np.float32)
            for n in ("babble", "cafe", "street")}
    av = AVSR(config=base.override({"noise.noise_types": ["cafe", "babble"]}),
              run_dir=str(tmp_path / "d"), train_utterances=data, noise_bank=bank, device="cpu")
    assert av.trainer.noise_bank.names == ("cafe", "babble")
    assert torch.equal(av.trainer.noise_bank.banks[1], torch.from_numpy(bank["babble"]))


def test_bucket_grad_accum_trains(tmp_path):
    """Per-bucket accumulation factors take the accumulating step; each
    bucket's factor comes from ``data.bucket_grad_accum``."""
    data = synth()
    cfg = tiny_cfg(tconfigs, num_epochs=1, eval_every_epochs=100).override(
        {"data.bucket_grad_accum": [2, 1]})
    av = AVSR(config=cfg, run_dir=str(tmp_path / "acc"), train_utterances=data, device="cpu")
    assert [av.trainer._accum_for(b) for b in (0, 1)] == [2, 1]
    av.train()
    losses = [r["loss"] for r in read_jsonl(str(tmp_path / "acc"), "train")]
    assert len(losses) == 4 and np.all(np.isfinite(losses))

"""The port's public API (``avsr_tpu_torch/avsr.py`` ``AVSR``), mirroring
``tests/test_avsr_api.py``, against the JAX package's ``AVSR``.

A module fixture trains the JAX ``AVSR`` (flat kwargs, audio, a typed
babble / cafe noise bank with training noise on) for one epoch; the port's
``AVSR`` built from the same kwargs takes its trained parameters
(``convert.from_jax``).  On them:

* ``predict`` (greedy and beam) gives the JAX transcripts, and
  ``predict(n_best=3)`` the JAX n-best hypotheses with their scores at
  rtol 1e-5, rank 0 equal to the top-1 beam;
* the fixed-SNR noise matrix (clean, babble 0 dB, cafe 0 dB) gives the
  JAX CER per condition exactly and the eval loss at rtol 1e-5: the port
  draws JAX's eval noise bit for bit (``utils/rng.py``).

The API's own contracts run on the port alone: flat kwargs, the
bogus-checkpoint and never-trained errors, explicit zero epochs, the
eval-only construction and the config route to a typed noise bank.
"""

import dataclasses

import numpy as np
import pytest
import torch

from avsr_tpu.avsr import AVSR as JAVSR
from avsr_tpu_torch.avsr import AVSR
from avsr_tpu_torch.data.synthetic import SyntheticSpec, Utterance, generate, make_noise_bank
from avsr_tpu_torch.data.tfrecord import write_dataset
from avsr_tpu_torch.decode.beam import beam_search
from avsr_tpu_torch.utils.params import tree_leaves
from test_torch_trainer import load_jax_params, params_equal

KW = dict(architecture="audio", encoder_units_per_layer=(16,), decoder_units_per_layer=(16,),
          embedding_size=8, batch_size=4, max_label_length=6, compute_dtype="float32",
          beam_width=4)


@pytest.fixture(autouse=True)
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def data():
    return generate(SyntheticSpec(num_utterances=8, min_chars=2, max_chars=3, seed=9,
                                  alphabet="ab", roi=20, char_duration_s=0.1))


def _bank():
    rng = np.random.default_rng(11)
    return {"babble": rng.standard_normal((1, 60_000)).astype(np.float32),
            "cafe": rng.uniform(-1, 1, (1, 60_000)).astype(np.float32)}


@pytest.fixture(scope="module")
def pair(data, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("api")
    kw = dict(KW, noise_snr_db=(0.0, 10.0), train_utterances=data, eval_utterances=data,
              noise_bank=_bank())
    j = JAVSR(run_dir=str(tmp / "jax"), **kw)
    j.train(num_epochs=1)
    t = AVSR(run_dir=str(tmp / "port"), device="cpu", **kw)
    load_jax_params(t.trainer, j.trainer.state.params)
    t.trainer._host_step = int(j.trainer.state.step)
    return j, t


def test_flat_kwargs_build_the_reference_config(tmp_path, data):
    kw = dict(unit="character", learning_rate=3e-3, dropout_probability=0.0,
              sampling_probability=0.0, num_epochs=2, train_utterances=data,
              eval_utterances=data)
    t = AVSR(**dict(KW, **kw), run_dir=str(tmp_path / "t"), device="cpu")
    j_cfg = JAVSR(**dict(KW, **kw), run_dir=str(tmp_path / "j")).config
    assert t.config.to_dict() == j_cfg.to_dict()
    assert t.config.decoder.hidden_units == (16,) and t.config.decode.beam_width == 4
    t.train(num_epochs=1)
    summary = t.evaluate(use_beam=True)
    assert {"cer", "wer", "loss", "seconds", "utterances_per_sec"} <= set(summary)


@pytest.mark.parametrize("use_beam", [False, True], ids=["greedy", "beam"])
def test_predict_matches_jax(pair, data, use_beam):
    j, t = pair
    got = t.predict(data[:5], use_beam=use_beam)
    assert got == j.predict(data[:5], use_beam=use_beam)
    assert len(got) == 5 and all(isinstance(h, str) for _, h in got)


def test_predict_n_best_matches_jax(pair, data):
    j, t = pair
    want = j.predict(data[:5], use_beam=True, n_best=3)
    got = t.predict(data[:5], use_beam=True, n_best=3)
    top1 = dict(t.predict(data[:5], use_beam=True))
    assert [u for u, _ in got] == [u for u, _ in want]
    for (uid, alts), (_, jalts) in zip(got, want):
        assert len(alts) == 3 and alts[0][0] == top1[uid]
        assert [h for h, _ in alts] == [h for h, _ in jalts]
        np.testing.assert_allclose([s for _, s in alts], [s for _, s in jalts], rtol=1e-5)
        scores = [s for _, s in alts]
        assert scores == sorted(scores, reverse=True)
    with pytest.raises(ValueError, match="use_beam"):
        t.predict(data[:3], use_beam=False, n_best=2)
    with pytest.raises(ValueError, match="exceeds decode.beam_width"):
        t.predict(data[:3], n_best=5)


def test_beam_n_best_rank0_is_the_top1(pair, data):
    """``beam_search(n_best=)`` itself: rank 0 of every n-best field equals
    the top-1 fields, and n_best=1 fills no n-best field."""
    from avsr_tpu_torch.data.loader import to_model_batch
    from avsr_tpu_torch.models import seq2seq

    _, t = pair
    _, nb = next(iter(t.eval_loader.epoch(shuffle=False)))
    params, cfg = t.trainer.state.params, t.config
    with torch.no_grad():
        out = seq2seq.encode(params, cfg, to_model_batch(nb, "cpu"))
    one = beam_search(params["decoder"], cfg.decoder, out.memories, 6, beam_width=4,
                      cdt=torch.float32)
    many = beam_search(params["decoder"], cfg.decoder, out.memories, 6, beam_width=4,
                       cdt=torch.float32, n_best=4)
    assert one.nbest_ids is None and one.nbest_scores is None
    assert many.nbest_ids.shape == (4, 4, 6)
    assert torch.equal(many.nbest_ids[:, 0], one.ids) and torch.equal(many.ids, one.ids)
    assert torch.equal(many.nbest_scores[:, 0], one.scores)
    assert torch.equal(many.nbest_lengths[:, 0], one.lengths)


def test_noise_type_matrix_matches_jax(pair):
    j, t = pair
    assert t.trainer.noise_bank.names == ("babble", "cafe")
    want = j.evaluate_noise_matrix(snrs=(None, 0.0), use_beam=False)
    got = t.evaluate_noise_matrix(snrs=(None, 0.0), use_beam=False)
    assert set(got) == set(want) == {"clean", "babble_0dB", "cafe_0dB"}
    for tag in want:
        assert got[tag]["cer"] == want[tag]["cer"], tag
        assert got[tag]["wer"] == want[tag]["wer"], tag
        np.testing.assert_allclose(got[tag]["loss"], want[tag]["loss"], rtol=1e-5, err_msg=tag)
    assert got["babble_0dB"]["loss"] != got["cafe_0dB"]["loss"]
    for tag in ("final", "final_babble_0dB", "final_cafe_0dB"):
        with open(f"{j.trainer.run_dir}/error_rates_{tag}.txt") as a, \
                open(f"{t.trainer.run_dir}/error_rates_{tag}.txt") as b:
            assert a.read() == b.read(), tag


def _small(tmp_path, name, data, **kw):
    return AVSR(**dict(KW, **kw), run_dir=str(tmp_path / name), train_utterances=data,
                eval_utterances=data, device="cpu")


def test_evaluate_bogus_checkpoint_fails_loudly(tmp_path, data):
    avsr = _small(tmp_path, "rb", data)
    with pytest.raises(ValueError, match="cannot resolve checkpoint"):
        avsr.evaluate(checkpoint="/nowhere/model.ckpt")
    with pytest.raises(FileNotFoundError, match="no checkpoint for step"):
        avsr.evaluate(checkpoint=123)
    with pytest.raises(FileNotFoundError, match="best.json"):
        avsr.evaluate(checkpoint="best")
    avsr.train(num_epochs=1)
    step = avsr.trainer.ckpt.latest_step()
    with pytest.raises(ValueError, match="not under this run"):
        avsr.evaluate(checkpoint=f"/some/other/run/checkpoints/{step}")
    assert "cer" in avsr.evaluate(checkpoint=step, use_beam=False)
    assert "cer" in avsr.evaluate(checkpoint=f"{avsr.trainer.ckpt.directory}/{step}",
                                  use_beam=False)


def test_never_trained_raises_and_a_new_session_restores(tmp_path, data):
    fresh = _small(tmp_path, "fresh", data)
    with pytest.raises(RuntimeError, match="never-trained"):
        fresh.evaluate()
    with pytest.raises(RuntimeError, match="never-trained"):
        fresh.evaluate_noise_matrix(snrs=(None,), use_beam=False)
    with pytest.raises(RuntimeError, match="never-trained"):
        fresh.predict(data[:2], use_beam=False)
    trained = _small(tmp_path, "ptrain", data)
    trained.train(num_epochs=1)
    again = _small(tmp_path, "ptrain", data)
    assert len(again.predict(data[:2], use_beam=False)) == 2
    assert again.trainer._host_step == trained.trainer._host_step == 2
    assert params_equal(trained.trainer.state.params, again.trainer.state.params)


def test_explicit_zero_epochs_trains_nothing(tmp_path, data):
    avsr = _small(tmp_path, "z", data)
    before = [x.clone() for _, x in tree_leaves(avsr.trainer.state.params)]
    assert avsr.train(num_epochs=0) == {}
    assert avsr.trainer._host_step == 0 and avsr.trainer.ckpt.all_steps() == []
    assert all(torch.equal(a, b) for a, (_, b) in zip(before, tree_leaves(
        avsr.trainer.state.params)))


def test_eval_only_avsr_and_matrix_restore(tmp_path, data):
    kw = dict(KW, run_dir=str(tmp_path / "eo"), device="cpu")
    AVSR(train_utterances=data, eval_utterances=data, **kw).train(num_epochs=1)
    av2 = AVSR(eval_utterances=data, **kw)
    with pytest.raises(ValueError, match="eval-only"):
        av2.train(num_epochs=1)
    results = av2.evaluate_noise_matrix((None,), use_beam=False)
    assert av2.trainer._host_step > 0 and "clean" in results
    with pytest.raises(ValueError, match="no data"):
        AVSR(**kw)


def test_noise_bank_records_config_route(tmp_path, data):
    paths = {}
    for name, seed in (("babble", 1), ("cafe", 2)):
        bank = make_noise_bank(num_rows=2, row_samples=30_000, seed=seed)
        paths[name] = str(tmp_path / f"{name}.tfrecord")
        write_dataset([Utterance(uid=f"{name}{i}", transcript="", waveform=bank[i])
                       for i in range(bank.shape[0])], paths[name])
    avsr = _small(tmp_path, "rbank", data)
    assert avsr.trainer.noise_bank is None
    cfg = dataclasses.replace(avsr.config, noise=dataclasses.replace(
        avsr.config.noise, bank_records=(("babble", paths["babble"]), ("cafe", paths["cafe"]))))
    avsr2 = AVSR(config=cfg, run_dir=str(tmp_path / "rbank2"), train_utterances=data,
                 eval_utterances=data, device="cpu")
    bank = avsr2.trainer.noise_bank
    assert bank is not None and bank.names == ("babble", "cafe")
    assert all(b.shape[0] == 1 and b.shape[1] == 60_000 for b in bank.banks)
    jb = JAVSR(config=cfg, run_dir=str(tmp_path / "rbank3"), train_utterances=data,
               eval_utterances=data).trainer.noise_bank
    for a, b in zip(bank.banks, jb.banks):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))

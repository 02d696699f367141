"""The port's TensorBoard writer and metrics logger
(``avsr_tpu_torch/utils/tensorboard.py``, ``utils/logging.py``) against the
JAX package's: the same events give the same bytes, file name included,
when both read one wall clock (the port's injected as ``clock=``, the
JAX package's by patching ``time.time``); each package reads the other's
files."""

import glob
import os
import time

import pytest

from avsr_tpu.utils import logging as jlogging
from avsr_tpu.utils import tensorboard as jtb
from avsr_tpu_torch.utils import logging as tlogging
from avsr_tpu_torch.utils import tensorboard as ttb

WALL = 1_700_000_123.25


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("event", [
    dict(wall_time=1.5, step=3, summary=[("a", 2.0)]),
    dict(wall_time=WALL, step=0, summary=[("train/loss", 3.25), ("train/lr", 1e-3)]),
    dict(wall_time=WALL, step=None, file_version="brain.Event:2", summary=[]),
    dict(wall_time=0.0, step=2 ** 40, summary=[("eval_noise/babble_0dB/cer", -0.5)]),
], ids=["golden", "two-values", "version", "big-step"])
def test_encode_event_equals_reference(event):
    def enc(mod):
        vals = [mod._encode_summary_value(t, v) for t, v in event["summary"]]
        return mod._encode_event(event["wall_time"], step=event["step"],
                                 file_version=event.get("file_version"), summary_values=vals)

    assert enc(ttb) == enc(jtb)


def test_event_file_byte_equal(tmp_path, monkeypatch):
    monkeypatch.setattr(time, "time", lambda: WALL)
    files = {}
    for name, mk in (("jax", lambda d: jtb.EventWriter(d)),
                     ("port", lambda d: ttb.EventWriter(d, clock=lambda: WALL))):
        w = mk(str(tmp_path / name))
        w.add_scalar("loss", 3.25, step=1, wall_time=10.0)
        w.add_scalars({"cer": 0.5, "wer": 1.0}, step=2)
        w.add_scalars({}, step=3)  # nothing written
        w.close()
        files[name] = w.path
    assert os.path.basename(files["port"]) == os.path.basename(files["jax"])
    assert _bytes(files["port"]) == _bytes(files["jax"])
    want = jtb.read_events(files["jax"])
    assert ttb.read_events(files["jax"]) == want == jtb.read_events(files["port"])
    assert want[1] == (10.0, 1, {"loss": 3.25}) and want[2][:2] == (WALL, 2)


def test_metrics_logger_byte_equal(tmp_path, monkeypatch):
    """metrics.jsonl and the mirrored event file: train records with
    tensor-like values, an eval with no step (inherits the last), noise
    conditions as their own tag namespace, string fields kept."""
    import torch

    monkeypatch.setattr(time, "time", lambda: WALL)
    runs = {}
    for name, mk in (("jax", lambda d: jlogging.MetricsLogger(d, tensorboard=True)),
                     ("port", lambda d: tlogging.MetricsLogger(d, tensorboard=True,
                                                               clock=lambda: WALL))):
        d = str(tmp_path / name)
        lg = mk(d)
        loss = torch.tensor(2.5) if name == "port" else 2.5
        lg.log("train", step=5, epoch=0, loss=loss, lr=1e-3, bucket=0, sampling_p=0.0)
        lg.log("epoch", epoch=1, seconds=1.25, frames_per_sec=4321.5)
        lg.log("eval", epoch=-1, cer=0.25, wer=0.75, num_utterances=12, condition="clean")
        lg.log("eval_noise", condition="babble_10dB", cer=0.5, wer=1.0)
        lg.log("note", text="not a number")
        lg.close()
        runs[name] = d
    assert (_bytes(os.path.join(runs["port"], "metrics.jsonl"))
            == _bytes(os.path.join(runs["jax"], "metrics.jsonl")))
    (fj,), (ft,) = (glob.glob(os.path.join(runs[n], "tb", "events.out.tfevents.*"))
                    for n in ("jax", "port"))
    assert os.path.basename(ft) == os.path.basename(fj)
    assert _bytes(ft) == _bytes(fj)
    events = ttb.read_events(ft)
    assert [e[1] for e in events] == [0, 5, 1, 1, 1]  # the text record has no scalar
    assert set(events[4][2]) == {"eval_noise/babble_10dB/cer", "eval_noise/babble_10dB/wer"}


def test_logfile_attached_once(tmp_path):
    lg = tlogging.MetricsLogger(str(tmp_path / "run"), logfile=str(tmp_path / "a.log"))
    lg.add_logfile(str(tmp_path / "a.log"))
    lg.info("hello once")
    lg.close()
    paths = [getattr(h, "baseFilename", None) for h in lg._log.handlers]
    assert paths.count(os.path.abspath(tmp_path / "a.log")) == 1
    for h in list(lg._log.handlers):
        if getattr(h, "baseFilename", None) == os.path.abspath(tmp_path / "a.log"):
            h.close()
            lg._log.removeHandler(h)
    assert open(tmp_path / "a.log").read().count("hello once") == 1

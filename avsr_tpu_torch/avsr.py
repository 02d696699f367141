"""Public experiment API: the ``AVSR`` class (counterpart of
``avsr_tpu/avsr.py``).

The constructor takes a ready ``ExperimentConfig`` via ``config=`` or the
reference-style flat knobs (unit type and file, record paths per
modality, architecture, encoder / decoder sizes, attention type, batch
size, LR, dropout, scheduled sampling, beam width, max label length, SNR
and noise selection), opens the records as lazy sources (an audio and a
video record file inner-joined by uid) or takes in-memory utterances, and
exposes ``train``, ``evaluate`` (``checkpoint=`` a step, ``"best"`` or a
path), ``decode``, ``evaluate_noise_matrix`` and ``predict(n_best=)`` on
the port's ``Trainer``.  ``device`` (default ``"cuda"``) places the model
and every batch; the CPU only when asked for.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional, Sequence

import numpy as np

from avsr_tpu_torch.configs import (AudioFrontendConfig, DataConfig, DecodeConfig,
                                    DecoderConfig, EncoderConfig, ExperimentConfig,
                                    FusionConfig, NoiseConfig, TrainConfig,
                                    VideoFrontendConfig)
from avsr_tpu_torch.data import tfrecord
from avsr_tpu_torch.data.loader import BucketingLoader, to_model_batch
from avsr_tpu_torch.data.units import load_or_builtin
from avsr_tpu_torch.models import seq2seq
from avsr_tpu_torch.train.loop import Trainer


class AVSR:
    """One experiment: datasets + model + training/eval state."""

    def __init__(
        self,
        *,
        config: Optional[ExperimentConfig] = None,
        # ---- reference-style knobs ----
        unit: str = "character",
        unit_file: Optional[str] = None,
        audio_train_record: Optional[str] = None,
        audio_test_record: Optional[str] = None,
        video_train_record: Optional[str] = None,
        video_test_record: Optional[str] = None,
        architecture: str = "audio",  # audio | video | av_align | bimodal
        encoder_units_per_layer: Sequence[int] = (256, 256, 256),
        video_encoder_units_per_layer: Sequence[int] = (256,),
        decoder_units_per_layer: Sequence[int] = (256,),
        cell_type: str = "lstm",
        bidirectional: bool = True,
        attention_type: str = "bahdanau",
        embedding_size: int = 128,
        batch_size: int = 32,
        learning_rate: float = 1e-3,
        lr_decay: float = 0.0,
        optimizer: str = "adam",
        max_gradient_norm: float = 1.0,
        dropout_probability: float = 0.1,
        sampling_probability: float = 0.0,
        sampling_ramp_steps: int = 0,
        beam_width: int = 10,
        max_label_length: int = 150,
        noise_snr_db: Optional[Sequence[float]] = None,
        # one record path (anonymous type) or {type: path} (babble/cafe)
        noise_bank_record: "Optional[str | Dict[str, str]]" = None,
        au_loss_weight: float = 0.0,
        compute_dtype: str = "bfloat16",
        run_dir: Optional[str] = None,
        num_epochs: int = 100,
        seed: int = 42,
        # in-memory data injection (tests / synthetic experiments)
        train_utterances=None,
        eval_utterances=None,
        # [N, L] array (anonymous type) or {type: [Ni, Li]} typed bank
        noise_bank: "Optional[np.ndarray | Dict[str, np.ndarray]]" = None,
        mesh=None,
        device="cuda",
    ):
        if config is None:
            config = ExperimentConfig(
                architecture=architecture,
                audio=AudioFrontendConfig(),
                video=VideoFrontendConfig(embedding_dim=embedding_size),
                audio_encoder=EncoderConfig(
                    cell_type=cell_type, hidden_units=tuple(encoder_units_per_layer),
                    bidirectional=bidirectional, dropout_rate=dropout_probability),
                video_encoder=EncoderConfig(
                    cell_type=cell_type, hidden_units=tuple(video_encoder_units_per_layer),
                    bidirectional=bidirectional, dropout_rate=dropout_probability),
                fusion=FusionConfig(attention_type=attention_type, au_loss_weight=au_loss_weight),
                decoder=DecoderConfig(
                    embedding_dim=embedding_size, hidden_units=tuple(decoder_units_per_layer),
                    attention_type=attention_type, dropout_rate=dropout_probability,
                    sampling_probability=sampling_probability,
                    sampling_ramp_steps=sampling_ramp_steps, max_label_length=max_label_length),
                noise=NoiseConfig(
                    enabled=noise_snr_db is not None,
                    snr_db=tuple(noise_snr_db) if noise_snr_db else NoiseConfig().snr_db),
                data=DataConfig(
                    unit=unit, unit_file=unit_file,
                    audio_train_records=audio_train_record, audio_eval_records=audio_test_record,
                    video_train_records=video_train_record, video_eval_records=video_test_record,
                    batch_size=batch_size, max_label_length=max_label_length),
                train=TrainConfig(
                    learning_rate=learning_rate, lr_decay=lr_decay, optimizer=optimizer,
                    max_gradient_norm=max_gradient_norm, num_epochs=num_epochs,
                    compute_dtype=compute_dtype, seed=seed),
                decode=DecodeConfig(beam_width=beam_width, max_decode_length=max_label_length),
                name=f"{architecture}_{unit}",
            )
        self.config = config
        self.unit_dict = load_or_builtin(config.data.unit_file, config.data.unit)

        # Record paths open as streaming random-access sources; AV runs
        # inner-join the two record files by uid.
        train_utts = train_utterances
        if train_utts is None and config.data.audio_train_records:
            train_utts = _open_source(config.data.audio_train_records,
                                      config.data.video_train_records)
        eval_utts = eval_utterances
        if eval_utts is None and config.data.audio_eval_records:
            eval_utts = _open_source(config.data.audio_eval_records,
                                     config.data.video_eval_records)
        if train_utts is None and config.data.video_train_records:
            train_utts = _open_source(config.data.video_train_records, None)
        if eval_utts is None and config.data.video_eval_records:
            eval_utts = _open_source(config.data.video_eval_records, None)
        self._has_train_data = train_utts is not None
        if train_utts is None:
            if eval_utts is None:
                raise ValueError("no data: pass train/eval record paths or utterances")
            # EVAL-ONLY construction: the eval set stands in for schedule /
            # warmup metadata only; train() refuses below.
            train_utts = eval_utts

        au_stacking = None
        if config.architecture == "av_align" and config.fusion.au_loss_weight > 0:
            au_stacking = (config.audio.frame_stacking, config.audio.frame_skipping)

        def mk(utts):
            return BucketingLoader(
                utts, self.unit_dict, config.data, require_audio=seq2seq.uses_audio(config),
                require_video=seq2seq.uses_video(config), frame_step=config.audio.frame_step,
                frame_length=config.audio.frame_length, au_target_stacking=au_stacking,
                au_dim=config.fusion.au_dim)

        self.train_loader = mk(train_utts)
        self.eval_loader = mk(eval_utts) if eval_utts is not None else None

        if noise_bank is None and not noise_bank_record and config.noise.bank_records:
            # config-file/CLI route: noise.bank_records ((type, path), ...)
            noise_bank_record = {name: path for name, path in config.noise.bank_records}
        if noise_bank is None and noise_bank_record:
            noise_bank = _load_noise_bank(noise_bank_record)

        self.trainer = Trainer(config, self.unit_dict, self.train_loader, self.eval_loader,
                               run_dir=run_dir, noise_bank=noise_bank, mesh=mesh, device=device)

    # -- reference-parity entry points -----------------------------------

    def train(self, num_epochs: Optional[int] = None, logfile: Optional[str] = None,
              try_restore_latest_checkpoint: bool = False) -> Dict[str, float]:
        if not self._has_train_data:
            raise ValueError("train() called on an eval-only AVSR (constructed without "
                             "training data); pass data.*_train_records or utterances")
        if logfile:
            self.trainer.logger.add_logfile(logfile)
        return self.trainer.train(num_epochs,
                                  try_restore_latest_checkpoint=try_restore_latest_checkpoint)

    def evaluate(self, checkpoint=None, epoch: Optional[int] = None,
                 use_beam: bool = True) -> Dict[str, float]:
        """Evaluate the eval set; ``checkpoint`` restores an explicit step
        (an int, a step string, ``"best"``, or a path ending in the step
        directory).  An unresolvable checkpoint, or a never-trained state
        with no checkpoint on disk, raises."""
        self._restore_for_eval(checkpoint)
        return self.trainer.evaluate(epoch=epoch, use_beam=use_beam)

    def _restore_for_eval(self, checkpoint) -> None:
        """Explicit checkpoint > in-session state (params trained, averaged
        or restored this session) > latest on disk > raise."""
        tr = self.trainer
        if checkpoint is not None:
            step = self._resolve_checkpoint_step(checkpoint)
            tr.state, _, _ = tr.ckpt.restore(tr.state, step)
            tr._host_step = step
        elif tr._host_step != 0:
            return  # keep in-session state (e.g. an unsaved average)
        elif tr.ckpt.latest_step() is not None:
            tr.state, _, step = tr.ckpt.restore(tr.state)
            tr._host_step = int(step)
        else:
            raise RuntimeError(
                "evaluate() called on a never-trained model: no checkpoint under "
                f"{tr.ckpt.directory} and no training steps taken this session — the result "
                "would score randomly-initialized parameters.  Train first, or pass checkpoint=.")

    def _resolve_checkpoint_step(self, checkpoint) -> int:
        """checkpoint -> step int; raises on anything unresolvable.
        ``"best"`` resolves through run_dir/best.json."""
        tr = self.trainer
        if isinstance(checkpoint, str) and checkpoint == "best":
            path = os.path.join(tr.run_dir, "best.json")
            if not os.path.exists(path):
                raise FileNotFoundError(f"checkpoint='best' but no best.json under {tr.run_dir} "
                                        "— it is written when training runs with an eval set")
            with open(path) as f:
                step = int(json.load(f)["step"])
        elif isinstance(checkpoint, int):
            step = checkpoint
        else:
            ck = os.path.normpath(str(checkpoint))
            base = os.path.basename(ck)
            try:
                step = int(base)
            except ValueError:
                raise ValueError(
                    f"cannot resolve checkpoint {checkpoint!r}: expected a step number or a path "
                    "ending in the step directory (e.g. .../checkpoints/42)") from None
            # a full path must point INTO this run's checkpoint directory
            parent = os.path.dirname(os.path.abspath(ck))
            if base != ck and parent != tr.ckpt.directory:
                raise ValueError(f"checkpoint path {checkpoint!r} is not under this run's "
                                 f"checkpoint directory {tr.ckpt.directory}")
        if step not in tr.ckpt.all_steps():
            raise FileNotFoundError(f"no checkpoint for step {step} under {tr.ckpt.directory}; "
                                    f"available: {tr.ckpt.all_steps()}")
        return step

    def decode(self, use_beam: bool = True):
        """Decode the eval set; returns the evaluation summary."""
        return self.trainer.evaluate(use_beam=use_beam)

    def evaluate_noise_matrix(self, snrs=(None, 20.0, 10.0, 0.0, -5.0), noise_types=None,
                              use_beam: bool = True, checkpoint=None):
        """Per-(noise type x SNR)-condition evaluation, with ``evaluate``'s
        restore policy."""
        self._restore_for_eval(checkpoint)
        return self.trainer.evaluate_noise_matrix(snrs, noise_types=noise_types,
                                                  use_beam=use_beam)

    def predict(self, utterances, use_beam: bool = True, n_best: int = 1):
        """Transcribe in-memory utterances -> list of (uid, hypothesis).

        Restores the latest checkpoint when one exists and nothing was
        trained this session; a never-trained model raises.  ``n_best > 1``
        (beam only) returns ``(uid, [(hypothesis, score), ...])`` ranked
        best-first with length-normalized log-prob scores."""
        tr = self.trainer
        if tr._host_step == 0:
            if tr.ckpt.latest_step() is not None:
                tr.state, _, step = tr.ckpt.restore(tr.state)
                tr._host_step = int(step)
            else:
                raise RuntimeError(
                    "predict() called on a never-trained model: no checkpoint under "
                    f"{tr.ckpt.directory} and no training steps taken this session.  Train "
                    "first, or point run_dir at a trained run.")
        cfg = self.config
        loader = BucketingLoader(
            list(utterances), self.unit_dict, cfg.data, require_audio=seq2seq.uses_audio(cfg),
            require_video=seq2seq.uses_video(cfg), frame_step=cfg.audio.frame_step,
            frame_length=cfg.audio.frame_length)
        if n_best > 1 and not use_beam:
            raise ValueError("n_best > 1 requires use_beam=True")
        if n_best > cfg.decode.beam_width:
            raise ValueError(f"n_best {n_best} exceeds decode.beam_width {cfg.decode.beam_width}")
        out = []

        def drain(res, np_batch) -> None:
            if n_best > 1:
                ids, scores = res[0].numpy(), res[1].numpy()
                for j in range(np_batch["num_real"]):
                    alts = [(self.unit_dict.decode(ids[j, r]), float(scores[j, r]))
                            for r in range(ids.shape[1])]
                    out.append((np_batch["uids"][j], alts))
            else:
                ids = res.numpy()
                for j in range(np_batch["num_real"]):
                    out.append((np_batch["uids"][j], self.unit_dict.decode(ids[j])))

        pending = None
        for _, np_batch in loader.epoch(shuffle=False):
            res = tr.decode(to_model_batch(np_batch, tr.device), use_beam, n_best)
            if pending is not None:
                drain(*pending)
            pending = (res, np_batch)
        if pending is not None:
            drain(*pending)
        return out


def _load_noise_bank(record: "str | Dict[str, str]"):
    """Noise-bank records -> per-type waveform arrays: one record path
    (an anonymous type) or {type: path}; each type's waveforms are
    concatenated into one long [1, L] row (segments are drawn by offset)."""

    def one(path: str) -> np.ndarray:
        rows = [np.asarray(u.waveform, np.float32) for u in tfrecord.read_dataset(path)
                if u.waveform is not None]
        if not rows:
            raise ValueError(f"noise bank record {path!r} has no waveforms")
        return np.concatenate(rows)[None, :]

    if isinstance(record, dict):
        return {name: one(path) for name, path in record.items()}
    return one(record)


def _open_source(records: str, video_records: Optional[str]):
    """Open record file(s) as a lazy random-access source; with a video
    record file, INNER-join by uid.  Paths may be single files, shard globs
    or comma-separated lists."""
    from avsr_tpu_torch.data.grain_loader import JoinedAVSource, open_sharded

    src = open_sharded(records)
    if video_records:
        return JoinedAVSource(src, open_sharded(video_records))
    return src

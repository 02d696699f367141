"""Training loop: epochs, evaluation, checkpointing, metrics (counterpart of
``avsr_tpu/train/loop.py``).

The reference's epoch loop on the port's train step: the bucketing loader
walked with a prefetch thread, per-epoch and per-K-step checkpoints
(``train/checkpoint.py``), bit-exact resume mid-epoch and after a graceful
stop (SIGTERM), best-CER tracking with ``best.json`` and early stopping,
a warm-up step per bucket that leaves training untouched, and greedy or
width-W beam evaluation writing prediction and error-rate files, over
fixed-SNR noise conditions too.

Port-specific points:

* Device: ``device`` (default ``"cuda"``) holds the state and every batch;
  a CUDA device on a machine without one raises.  Nothing falls back to
  the CPU.
* Randomness: the train step's noise and dropout depend only on (seed,
  step, micro-batch) (``train/step.py``); the Trainer holds the generator
  seeded ``train.seed + 1``, as the reference's ``_data_rng`` is, and the
  step reads only its seed, so a warm-up step or an eval consumes nothing.
* Host syncs: the loop reads the device only at log steps (the loss and
  the gradient norm), at checkpoints and in evaluation; the step counter,
  the lr and the sampling probability are host mirrors.
* Host-to-device: ``to_model_batch`` copies a batch from pinned host
  memory without blocking, issued from the prefetch thread onto the
  device's default stream, which the train step's kernels also run on,
  so the copy is ordered before the step that reads it; the caching host
  allocator keeps each pinned block until its copy has finished.
* Decode and eval run under ``torch.inference_mode()`` with the train
  state's parameters.
* Multi-device training (a mesh, ``train.num_data_shards`` or
  ``num_model_shards`` > 1) is not ported and raises.
"""

from __future__ import annotations

import dataclasses
import json
import os
import signal
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from avsr_tpu_torch.configs import ExperimentConfig
from avsr_tpu_torch.data.loader import BucketingLoader, prefetch, to_model_batch
from avsr_tpu_torch.data.units import UnitDict
from avsr_tpu_torch.decode.beam import beam_search
from avsr_tpu_torch.decode.greedy import greedy_decode
from avsr_tpu_torch.eval.metrics import ErrorRateAccumulator
from avsr_tpu_torch.models import seq2seq
from avsr_tpu_torch.ops.noise import NoiseBank
from avsr_tpu_torch.train import step as step_lib
from avsr_tpu_torch.train.checkpoint import CheckpointManager
from avsr_tpu_torch.utils.logging import MetricsLogger
from avsr_tpu_torch.utils.numerics import compute_dtype_of
from avsr_tpu_torch.utils.params import param_count, tree_map


def check_device(device, what: str) -> torch.device:
    """``device`` as a torch.device; a CUDA device where torch finds none
    raises instead of running elsewhere."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{what}: device {str(device)!r} asked for, but torch finds no CUDA "
                           "device; pass device='cpu' to run on the CPU")
    return dev


class Trainer:
    def __init__(self, cfg: ExperimentConfig, unit_dict: UnitDict,
                 train_loader: BucketingLoader, eval_loader: Optional[BucketingLoader] = None,
                 *, run_dir: Optional[str] = None, noise_bank=None,
                 logfile: Optional[str] = None, mesh=None, device="cuda"):
        self.device = check_device(device, "Trainer")
        if mesh is not None or cfg.train.num_data_shards > 1 or cfg.train.num_model_shards > 1:
            raise ValueError(
                "multi-device training (a mesh, train.num_data_shards or num_model_shards > 1) "
                "is not ported: ROADMAP.md queue 1 item 8")
        self.cfg = cfg
        self.units = unit_dict
        self.train_loader = train_loader
        self.eval_loader = eval_loader
        self.run_dir = run_dir or os.path.join("runs", cfg.name)
        self.logger = MetricsLogger(self.run_dir, logfile, tensorboard=cfg.train.tensorboard)
        # Gradient accumulation: validate factors up front (a bad factor
        # otherwise surfaces as an opaque split error mid-epoch).
        bga = cfg.data.bucket_grad_accum
        if cfg.train.grad_accum_steps < 1:
            raise ValueError("train.grad_accum_steps must be >= 1")
        if bga:
            bbs = cfg.data.bucket_batch_sizes
            if bbs and len(bga) != len(bbs):
                raise ValueError(f"data.bucket_grad_accum ({len(bga)}) must match "
                                 f"data.bucket_batch_sizes ({len(bbs)})")
            for i, a in enumerate(bga):
                bsz = bbs[i] if bbs else cfg.data.batch_size
                if a < 1 or bsz % a:
                    raise ValueError(f"bucket {i}: grad accum {a} must divide its batch "
                                     f"size {bsz}")
        elif cfg.train.grad_accum_steps > 1:
            for bsz in set(cfg.data.bucket_batch_sizes or ()) | {cfg.data.batch_size}:
                if bsz % cfg.train.grad_accum_steps:
                    raise ValueError(f"train.grad_accum_steps ({cfg.train.grad_accum_steps}) "
                                     f"must divide every batch size (got {bsz})")
        self.noise_bank = None
        if noise_bank is not None:
            bank = NoiseBank.create(noise_bank, device=self.device)
            # noise.noise_types selects which named types train/eval may
            # draw from; it applies only to typed banks.  Unknown names
            # fail loudly.
            if bank.num_types > 1 and cfg.noise.noise_types:
                keep = tuple(cfg.noise.noise_types)
                idxs = [bank.type_index(n) for n in keep]
                bank = NoiseBank(keep, tuple(bank.banks[i] for i in idxs))
            self.noise_bank = bank

        self._steps_per_epoch = max(len(train_loader), 1)
        self.state, self.optimizer = step_lib.create_train_state(
            cfg, unit_dict.vocab_size, torch.Generator().manual_seed(cfg.train.seed),
            self.device, self._steps_per_epoch)
        self.logger.info(f"model: {param_count(self.state.params):,} params "
                         f"({cfg.architecture}, vocab {unit_dict.vocab_size}) on {self.device}")
        self.ckpt = CheckpointManager(os.path.join(self.run_dir, cfg.train.checkpoint_dir),
                                      keep=cfg.train.keep_checkpoints)
        self.epoch = 0
        # Host mirror of state.step: the step advances by exactly 1 per
        # train step, so the host tracks it without reading the device.
        self._host_step = 0
        # Batches already consumed in the in-progress epoch at restore
        # time: train() fast-forwards past them, so a mid-epoch resume
        # continues bit-exactly instead of replaying.
        self._resume_batches = 0
        # Best-eval tracking: lowest in-train eval CER so far, persisted to
        # run_dir/best.json and pinned against keep-N pruning; feeds
        # train.early_stop_patience.
        self._best_cer = float("inf")
        self._evals_since_best = 0
        self._best_record = None
        self._load_best_record()
        self._generator = torch.Generator().manual_seed(cfg.train.seed + 1)
        # Graceful-preemption flag: set by request_stop() / SIGTERM during
        # train(); the loop checkpoints the exact iterator position and
        # returns, so the next resume continues bit-exactly.
        self._stop_requested = False

    def _accum_for(self, bucket: int) -> int:
        bga = self.cfg.data.bucket_grad_accum
        if bga:
            return max(int(bga[bucket]), 1)
        return max(self.cfg.train.grad_accum_steps, 1)

    def _train_step(self, bucket: int, batch: seq2seq.Batch) -> Dict[str, torch.Tensor]:
        """One optimizer step on ``self.state`` (in place): the metrics as
        device tensors."""
        self.state, metrics = step_lib.train_step(
            self.state, batch, cfg=self.cfg, optimizer=self.optimizer,
            generator=self._generator, noise_bank=self.noise_bank,
            accum=self._accum_for(bucket))
        return metrics

    def average_checkpoints(self, steps=None, last_n: int = 5, save: bool = True) -> int:
        """Average the last-N (or given) checkpoints' parameters, adopt the
        result as the current state, and (by default) save it as a NEW
        checkpoint step past the newest one on disk.  Returns that step."""
        self.state, used = self.ckpt.average(self.state, steps=steps, last_n=last_n)
        self._host_step = int(used[-1])
        # Past the NEWEST checkpoint on disk, not just the newest averaged
        # one: averaging older steps never clobbers a later checkpoint.
        new_step = max(self.ckpt.all_steps()) + 1
        if save:
            # The saved payload's step equals its label: restore derives
            # the step's randomness, the schedules and the next save's
            # label from it.
            self.state = self.state._replace(step=new_step)
            self.ckpt.save(new_step, self.state, {"epoch": self.epoch, "averaged_from": used})
            self._host_step = new_step
        self.logger.info(f"averaged checkpoints {used}"
                         + (f" -> saved as step {new_step}" if save else ""))
        return new_step if save else used[-1]

    def request_stop(self) -> None:
        """Ask the running train() loop to checkpoint and return after the
        current step (signal-handler safe: only sets a flag)."""
        self._stop_requested = True

    # ------------------------------------------------------------------

    def try_restore_latest_checkpoint(self) -> bool:
        """Resume from the newest checkpoint if one exists."""
        if self.ckpt.latest_step() is None:
            return False
        self.restore_checkpoint()
        return True

    def restore_checkpoint(self, step: Optional[int] = None) -> int:
        """Restore params/opt-state/step plus the data-iterator position
        (epoch + batches consumed in it); ``step=None`` = latest.  Training
        then continues as an uninterrupted run would: the loader's order is
        deterministic in (seed, epoch) and the step's randomness in the
        restored step."""
        self.state, extra, step = self.ckpt.restore(self.state, step=step)
        self.epoch = int(extra.get("epoch", 0)) if extra else 0
        self._resume_batches = int(extra.get("batches_done", 0)) if extra else 0
        self._host_step = int(step)
        self.train_loader.set_epoch(self.epoch)
        self.logger.info(f"restored checkpoint at step {step}, epoch {self.epoch}"
                         + (f" (+{self._resume_batches} batches)" if self._resume_batches
                            else ""))
        return int(step)

    def train(self, num_epochs: Optional[int] = None, *,
              try_restore_latest_checkpoint: bool = False,
              evaluate_every: Optional[int] = None) -> Dict[str, float]:
        cfg = self.cfg
        # `is None`, not `or`: an explicit 0 means "no epochs" / "never
        # eval in-train".
        if num_epochs is None:
            num_epochs = cfg.train.num_epochs
        if evaluate_every is None:
            evaluate_every = cfg.train.eval_every_epochs
        if try_restore_latest_checkpoint:
            self.try_restore_latest_checkpoint()
        if self._host_step == 0 and self._best_record is not None:
            # FRESH run in a directory holding a previous run's best.json:
            # that record describes another model's CER.  Reset the tracker.
            self.logger.info("fresh run: discarding previous run's best.json "
                             f"(step {self._best_record.get('step')}, "
                             f"cer {self._best_record.get('cer')})")
            self._best_record = None
            self._best_cer = float("inf")
            self._evals_since_best = 0
            self.ckpt.set_preserved(set())
            try:
                os.remove(os.path.join(self.run_dir, "best.json"))
            except OSError:
                pass
        if cfg.train.warmup_compile:
            self.warmup()

        # SIGTERM -> graceful stop (cluster preemption notice): checkpoint
        # the iterator position and return instead of dying mid-step.
        prev_handler = None
        if threading.current_thread() is threading.main_thread():
            try:
                prev_handler = signal.signal(signal.SIGTERM, lambda *_: self.request_stop())
            except (ValueError, OSError):  # non-main interpreter contexts
                prev_handler = None
        try:
            return self._train_epochs(num_epochs, evaluate_every)
        finally:
            if prev_handler is not None:
                signal.signal(signal.SIGTERM, prev_handler)

    def _train_epochs(self, num_epochs: int, evaluate_every: int) -> Dict[str, float]:
        cfg = self.cfg
        last_metrics: Dict[str, float] = {}
        while self.epoch < num_epochs:
            t_epoch = time.time()
            frames = 0
            skip = self._resume_batches
            self._resume_batches = 0
            batches_done = skip

            def device_batches():
                # Batch assembly AND the host->device copy both run on the
                # prefetch thread, so the next batch is copied while the
                # current step computes.
                for i, (bucket, np_batch) in enumerate(self.train_loader.epoch()):
                    if i < skip:
                        # fast-forward to the checkpointed iterator position
                        continue
                    yield bucket, np_batch, to_model_batch(np_batch, self.device)

            for bucket, np_batch, batch in prefetch(device_batches()):
                metrics = self._train_step(bucket, batch)
                self._host_step += 1
                batches_done += 1
                step_i = self._host_step
                if np_batch.get("audio_lengths") is not None:
                    frames += int(np.sum(np_batch["audio_lengths"]) // 160)
                elif np_batch.get("video_lengths") is not None:
                    frames += int(np.sum(np_batch["video_lengths"]))
                if step_i % max(cfg.train.log_every_steps, 1) == 0:
                    # lr / sampling-p are host mirrors of the schedules; the
                    # step just taken saw the pre-increment counter
                    self.logger.log(
                        "train", step=step_i, epoch=self.epoch, loss=float(metrics["loss"]),
                        grad_norm=float(metrics["grad_norm"]), bucket=bucket,
                        lr=self.optimizer.schedule(step_i - 1),
                        sampling_p=step_lib.host_sampling_p(cfg, step_i - 1))
                if cfg.train.save_every_steps and step_i % cfg.train.save_every_steps == 0:
                    self.ckpt.save(step_i, self.state,
                                   {"epoch": self.epoch, "batches_done": batches_done})
                if self._stop_requested:
                    # graceful preemption: persist the exact iterator
                    # position; a resume continues bit-exactly from here
                    self.ckpt.save(step_i, self.state,
                                   {"epoch": self.epoch, "batches_done": batches_done})
                    self.logger.info(f"stop requested: checkpointed step {step_i} (epoch "
                                     f"{self.epoch}, {batches_done} batches) and exiting "
                                     "train loop")
                    return last_metrics
            self.epoch += 1
            dt = time.time() - t_epoch
            fps = frames / max(dt, 1e-9)
            self.logger.log("epoch", epoch=self.epoch, seconds=dt, frames_per_sec=fps)
            self.logger.info(f"epoch {self.epoch}: {dt:.1f}s, {fps:.0f} frames/s")
            # epoch boundary: iterator state resets (batches_done = 0)
            self.ckpt.save(self._host_step, self.state, {"epoch": self.epoch, "batches_done": 0})
            if (self.eval_loader is not None and evaluate_every
                    and self.epoch % evaluate_every == 0):
                last_metrics = self.evaluate(epoch=self.epoch)
                if self._update_best(last_metrics):
                    return last_metrics
        return last_metrics

    def _load_best_record(self) -> None:
        """Resume best-CER tracking from run_dir/best.json; re-pins the
        best step against pruning."""
        path = os.path.join(self.run_dir, "best.json")
        if not os.path.exists(path):
            return
        try:
            with open(path) as f:
                best = json.load(f)
            self._best_cer = float(best["cer"])
            # Patience survives preemption.
            self._evals_since_best = int(best.get("evals_since_best", 0))
            self._best_record = best
            self.ckpt.set_preserved({int(best["step"])})
        except (ValueError, KeyError, OSError):
            self.logger.info(f"ignoring unreadable best record {path}")

    def _write_best_record(self) -> None:
        with open(os.path.join(self.run_dir, "best.json"), "w") as f:
            json.dump(self._best_record, f)

    def _update_best(self, metrics: Dict[str, float]) -> bool:
        """Track the best in-train eval CER; returns True when
        ``train.early_stop_patience`` says to stop.  The best step goes to
        run_dir/best.json (``checkpoint="best"``) and is pinned against
        keep-N pruning."""
        cer = metrics.get("cer")
        if cer is None:
            return False
        if cer < self._best_cer:
            self._best_cer = float(cer)
            self._evals_since_best = 0
            self._best_record = {
                "step": self._host_step, "epoch": self.epoch, "cer": float(cer),
                "wer": float(metrics.get("wer", -1.0)), "evals_since_best": 0,
            }
            self._write_best_record()
            self.ckpt.set_preserved({self._host_step})
            self.logger.info(f"new best CER {cer:.4f} at step {self._host_step} "
                             "(best.json; checkpoint pinned)")
            return False
        self._evals_since_best += 1
        if self._best_record is not None:
            self._best_record["evals_since_best"] = self._evals_since_best
            self._write_best_record()
        patience = self.cfg.train.early_stop_patience
        if patience and self._evals_since_best >= patience:
            self.logger.info(f"early stop: no CER improvement in {self._evals_since_best} "
                             f"evals (best {self._best_cer:.4f})")
            return True
        return False

    def warmup(self) -> int:
        """One train step per bucket shape on a THROWAWAY copy of the
        parameters and moments: every kernel is built and every bucket's
        allocations made before epoch 1.  The train state, the generator
        and the loaders are untouched (the step updates its state in place,
        so the live tensors must not see it), and training afterwards is
        bit-identical to training without warmup.  Returns the number of
        buckets stepped."""
        loader = self.train_loader
        if not hasattr(loader, "bucket_shapes"):
            return 0
        n = 0
        bs_for = getattr(loader, "batch_size_for", lambda b: self.cfg.data.batch_size)
        for b, shp in sorted(loader.bucket_shapes().items()):
            batch = to_model_batch(self._dummy_batch(shp, bs_for(b)), self.device)
            opt = {k: ([m.detach().clone() for m in v] if isinstance(v, list) else v)
                   for k, v in self.state.opt_state.items()}
            params = tree_map(lambda t: t.detach().clone().requires_grad_(True),
                              self.state.params)
            _, metrics = step_lib.train_step(
                step_lib.TrainState(params, opt, self._host_step), batch, cfg=self.cfg,
                optimizer=self.optimizer, generator=self._generator,
                noise_bank=self.noise_bank, accum=self._accum_for(b))
            float(metrics["loss"])  # host sync: wait out the step
            n += 1
            self.logger.info(f"warmup: bucket {b} stepped (audio={shp.audio_samples}, "
                             f"video={shp.video_frames}, labels={shp.label_len})")
        return n

    def _dummy_batch(self, shp, batch_size: Optional[int] = None):
        """Zero batch matching one bucket's static shapes (and the
        transfer dtypes), mirroring BucketingLoader._assemble."""
        cfg = self.cfg
        loader = self.train_loader
        B = batch_size if batch_size is not None else cfg.data.batch_size
        compact = cfg.data.transfer_dtype == "compact"
        arch = cfg.architecture
        out = {"uids": [f"warmup{i}" for i in range(B)], "num_real": B,
               "uid_hashes": np.arange(B, dtype=np.uint32)}
        if arch in ("audio", "av_align", "bimodal"):
            S = shp.audio_samples
            out["audio"] = np.zeros((B, S), np.int16 if compact else np.float32)
            out["audio_lengths"] = np.full((B,), S, np.int32)
        if arch in ("video", "av_align", "bimodal"):
            T = shp.video_frames
            # AU-feature datasets feed [T, au_dim] instead of ROI frames
            kind, fshape = loader.video_signature()
            if kind == "au":
                out["video"] = np.zeros((B, T, fshape[0]), np.float32)
            else:
                out["video"] = np.zeros((B, T, *fshape), np.uint8 if compact else np.float32)
            out["video_lengths"] = np.full((B,), T, np.int32)
        if getattr(loader, "au_target_stacking", None) is not None:
            stack, skip = loader.au_target_stacking
            T_raw = max((shp.audio_samples - loader.frame_length) // loader.frame_step + 1, 1)
            T_a = max((T_raw - stack) // skip + 1, 1)
            out["au_targets"] = np.zeros((B, T_a, loader.au_dim), np.float32)
            out["au_row_weights"] = np.ones((B,), np.float32)
        tgt = np.zeros((B, shp.label_len), np.int32)
        tgt[:, 0] = 2  # EOS
        out["targets"] = tgt
        out["target_lengths"] = np.ones((B,), np.int32)
        return out

    # ------------------------------------------------------------------

    def evaluate(self, *, epoch: Optional[int] = None, use_beam: bool = True,
                 loader: Optional[BucketingLoader] = None) -> Dict[str, float]:
        """Decode the eval set, write predictions, return CER/WER, the
        token-weighted eval loss and the time taken."""
        loader = loader or self.eval_loader
        acc = ErrorRateAccumulator()
        losses: List[float] = []
        weights: List[int] = []
        t_eval = time.time()

        def drain(ids, metrics, np_batch) -> None:
            # the first host reads of this batch's results
            n_real = np_batch["num_real"]
            losses.append(float(metrics["loss"]))
            # Per-batch losses are token means; weight them by real token
            # count so the summary is the corpus token mean.
            tl = np.asarray(np_batch["target_lengths"][:n_real])
            K_cap = np_batch["targets"].shape[1]
            weights.append(int(np.minimum(tl, K_cap).sum()))
            # Score against the UNTRUNCATED reference carried by the loader
            # (the targets are capped at the bucket's label horizon).
            refs = np_batch.get("references")
            ids = ids.numpy()
            for j in range(n_real):
                hyp = self.units.decode(ids[j])
                ref = refs[j] if refs is not None else self.units.decode(np_batch["targets"][j])
                acc.update(ref, hyp, np_batch["uids"][j])

        # One-deep pipeline: batch i+1 is decoded before batch i's loss is
        # read and its hypotheses scored.
        pending = None
        for _, np_batch in loader.epoch(shuffle=False):
            ids, metrics = self._eval_decode(to_model_batch(np_batch, self.device), use_beam)
            if pending is not None:
                drain(*pending)
            pending = (ids, metrics, np_batch)
        if pending is not None:
            drain(*pending)
        tag = f"epoch{epoch}" if epoch is not None else "final"
        if self.cfg.noise.eval_snr_db is not None:
            if self.noise_bank is not None and self.noise_bank.num_types > 1:
                tag += f"_{self.cfg.noise.eval_noise_type}"
            tag += f"_{self.cfg.noise.eval_snr_db:g}dB"
        acc.write_predictions(os.path.join(self.run_dir, f"predictions_{tag}.txt"))
        summary = acc.summary()
        dt = time.time() - t_eval
        summary["seconds"] = round(dt, 3)
        summary["utterances_per_sec"] = round(summary["num_utterances"] / max(dt, 1e-9), 2)
        if losses:
            summary["loss"] = float(np.average(losses, weights=np.maximum(weights, 1)))
        with open(os.path.join(self.run_dir, f"error_rates_{tag}.txt"), "w") as f:
            f.write(f"CER {summary['cer']:.6f}\nWER {summary['wer']:.6f}\n"
                    f"utterances {summary['num_utterances']}\n")
        self.logger.log("eval", epoch=epoch or -1, **summary)
        self.logger.info(f"eval {tag}: CER {summary['cer']:.4f} WER {summary['wer']:.4f}")
        return summary

    def evaluate_noise_matrix(self, snrs=(None, 20.0, 10.0, 0.0, -5.0), *,
                              noise_types: Optional[List[str]] = None, use_beam: bool = True,
                              epoch: Optional[int] = None) -> Dict[str, Dict[str, float]]:
        """Per-(noise type x SNR)-condition evaluation matrix.  SNR ``None``
        means clean (evaluated once, type-independent); ``noise_types``
        defaults to every type of the bank (an untyped bank gives SNR-only
        conditions)."""
        if noise_types is None:
            if self.noise_bank is not None and self.noise_bank.num_types > 1:
                noise_types = list(self.noise_bank.names)
            else:
                noise_types = [None]
        results: Dict[str, Dict[str, float]] = {}
        original = self.cfg
        try:
            for snr in snrs:
                conditions = ([(None, None)] if snr is None
                              else [(ntype, snr) for ntype in noise_types])
                for ntype, csnr in conditions:
                    tag = "clean" if csnr is None else (
                        f"{csnr:g}dB" if ntype is None else f"{ntype}_{csnr:g}dB")
                    self.cfg = dataclasses.replace(original, noise=dataclasses.replace(
                        original.noise, eval_snr_db=csnr,
                        eval_noise_type=(ntype if ntype is not None
                                         else original.noise.eval_noise_type)))
                    results[tag] = self.evaluate(epoch=epoch, use_beam=use_beam)
                    self.logger.log("eval_noise", condition=tag, **results[tag])
        finally:
            self.cfg = original
        return results

    @torch.inference_mode()
    def _eval_decode(self, batch: seq2seq.Batch, use_beam: bool):
        """One encode feeding both the teacher-forced eval loss and the
        beam or greedy decode: (ids on the host, metrics on the device)."""
        cfg = self.cfg
        params = self.state.params
        out = seq2seq.encode(params, cfg, batch, train=False, noise_bank=self.noise_bank,
                             eval_snr=cfg.noise.eval_snr_db)
        _, metrics = seq2seq.loss_given_encode(params, cfg, batch, out, train=False)
        return self._decode_memories(out, use_beam).ids, metrics

    def _decode_memories(self, out: seq2seq.EncodeOutput, use_beam: bool, n_best: int = 1):
        cfg = self.cfg
        if use_beam and cfg.decode.beam_width > 1:
            return beam_search(self.state.params["decoder"], cfg.decoder, out.memories,
                               cfg.decode.max_decode_length, beam_width=cfg.decode.beam_width,
                               length_penalty=cfg.decode.length_penalty,
                               cdt=compute_dtype_of(cfg), n_best=n_best)
        return greedy_decode(self.state.params["decoder"], cfg.decoder, out.memories,
                             cfg.decode.max_decode_length, cdt=compute_dtype_of(cfg))

    @torch.inference_mode()
    def decode(self, batch: seq2seq.Batch, use_beam: bool = True, n_best: int = 1):
        """Encode (clean) and decode one batch with the train state's
        parameters: ids [B, L] on the host, or with ``n_best > 1`` (beam)
        the (ids [B, N, L], scores [B, N]) alternatives."""
        out = seq2seq.encode(self.state.params, self.cfg, batch, train=False,
                             noise_bank=self.noise_bank)
        res = self._decode_memories(out, use_beam, n_best)
        return (res.nbest_ids, res.nbest_scores) if n_best > 1 else res.ids

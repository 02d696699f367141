"""Input pipeline: bucketing batcher over utterance datasets.

Rebuild of the reference's tf.data pipeline (upstream:avsr/io_utils.py,
SURVEY.md §2.2 row 10): parse records, join audio+video streams, label->id
with GO/EOS handling, shuffle, and padded BUCKETED batching: every batch is
padded to its bucket's (T_audio, T_video, label_len) maxima (static shapes,
SURVEY §5.7), so the kernels see a few shapes, not one per batch.

The loader is host-side Python/NumPy (the TF1 C++ tf.data equivalent here is
the native TFRecord framing in avsr_tpu_torch/native plus NumPy assembly);
an optional grain-backed parallel variant is provided for multi-worker
hosts.  A copy of ``avsr_tpu/data/loader.py``, the same batches array for
array at the same seed; only ``to_model_batch`` differs: it copies a batch
to the card as the port's ``Batch``.
"""

from __future__ import annotations

import dataclasses
import logging
import zlib
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

_log = logging.getLogger("avsr_tpu_torch")

from avsr_tpu_torch.configs import DataConfig
from avsr_tpu_torch.data.synthetic import Utterance
from avsr_tpu_torch.data.units import EOS_ID, UnitDict


@dataclasses.dataclass(frozen=True)
class BucketShape:
    """Static pad shape for one bucket."""

    audio_samples: int
    video_frames: int
    label_len: int


class NumpyBatch(dict):
    """Host-side batch: dict of numpy arrays matching seq2seq.Batch fields."""


def _bucket_for(
    length: int, boundaries: Sequence[int]
) -> int:
    for i, b in enumerate(boundaries):
        if length <= b:
            return i
    return len(boundaries) - 1


class BucketingLoader:
    """Epoch iterator producing static-shape padded batches.

    Args:
      utterances: the dataset — either an in-memory list (synthetic /
        tfrecord.read_dataset) or any random-access source with ``__len__``
        + ``__getitem__`` (grain_loader.TFRecordDataSource /
        JoinedAVSource).  Sources are fetched LAZILY per epoch, so a
        multi-GB streamed corpus never materializes in host RAM: at most
        ``num_buckets x batch_size`` decoded utterances are buffered at
        once (SURVEY.md §2.3 row 5 tf.data-streaming equivalent).
      unit_dict: symbol table for transcript -> ids (+EOS).
      cfg: DataConfig (batch size, bucket boundaries, num_workers...).
        ``cfg.num_workers > 0`` fetches+decodes records in that many
        multiprocessing workers (bounded in-flight window) — the picklable
        seek-based sources decode in parallel while the device computes.
      require_audio / require_video: which modalities the architecture needs.
      The final short batch pads by repeating examples (keeps shapes
      static); repeated rows get zero loss weight via target_lengths=0.
    """

    def __init__(
        self,
        utterances,
        unit_dict: UnitDict,
        cfg: DataConfig,
        *,
        require_audio: bool = True,
        require_video: bool = False,
        frame_step: int = 160,
        frame_length: int = 400,
        # Emit per-audio-feature-frame AU regression targets (TASLP AU loss):
        # video-rate AU curves resampled to the stacked-feature rate by
        # nearest frame.  Tuple (stack, skip) of the audio frontend, or None.
        au_target_stacking: Optional[Tuple[int, int]] = None,
        au_dim: int = 2,
        seed: Optional[int] = None,
    ):
        self.utts = utterances
        self.units = unit_dict
        self.cfg = cfg
        self.require_audio = require_audio
        self.require_video = require_video
        self.frame_step = frame_step
        self.frame_length = frame_length
        self.au_target_stacking = au_target_stacking
        self.au_dim = au_dim
        self.seed = cfg.seed if seed is None else seed
        self._epoch = 0
        self._warned_oov = False
        self._warned_truncation = False
        self._video_sig: Optional[Tuple[str, Tuple[int, ...]]] = None
        self._bucket_shapes = self._compute_bucket_shapes()

    # -- static shapes ------------------------------------------------------

    def _compute_bucket_shapes(self) -> Dict[int, BucketShape]:
        bounds = list(self.cfg.audio_bucket_boundaries)
        caps = self.cfg.label_bucket_caps
        if caps is not None and len(caps) != len(bounds):
            raise ValueError(
                f"label_bucket_caps ({len(caps)}) must match "
                f"audio_bucket_boundaries ({len(bounds)})"
            )
        bbs = self.cfg.bucket_batch_sizes
        if bbs is not None and len(bbs) != len(bounds):
            raise ValueError(
                f"bucket_batch_sizes ({len(bbs)}) must match "
                f"audio_bucket_boundaries ({len(bounds)})"
            )
        bga = self.cfg.bucket_grad_accum
        if bga is not None and len(bga) != len(bounds):
            raise ValueError(
                f"bucket_grad_accum ({len(bga)}) must match "
                f"audio_bucket_boundaries ({len(bounds)})"
            )
        shapes = {}
        max_label = self.cfg.max_label_length
        for i, b in enumerate(bounds):
            samples = (b - 1) * self.frame_step + self.frame_length
            # video runs at cfg.video_fps; audio frames at 100 Hz
            vframes = int(np.ceil(b * self.cfg.video_fps / 100.0)) + 1
            label_len = max_label if caps is None else min(caps[i], max_label)
            shapes[i] = BucketShape(samples, vframes, label_len)
        return shapes

    def bucket_shapes(self) -> Dict[int, BucketShape]:
        return dict(self._bucket_shapes)

    def video_signature(self) -> Optional[Tuple[str, Tuple[int, ...]]]:
        """Which video modality this dataset feeds: ``("roi", frame_shape)``
        for pixel crops, ``("au", (dim,))`` for AU-feature streams, or None
        when the loader carries no video.  Determined by peeking the first
        utterance ONCE (sources are random-access by contract) — used by
        Trainer.warmup() to compile the right program instead of guessing."""
        if not self.require_video:
            return None
        if self._video_sig is None:
            if len(self.utts) == 0:
                raise ValueError("cannot infer video signature: empty dataset")
            u0 = self.utts[0]
            if u0.video is not None:
                self._video_sig = ("roi", tuple(u0.video.shape[1:]))
            elif u0.au is not None:
                self._video_sig = ("au", (int(u0.au.shape[1]),))
            else:
                raise ValueError(
                    "require_video=True but the first utterance has neither "
                    "video frames nor AU features"
                )
        return self._video_sig

    def batch_size_for(self, bucket: int) -> int:
        """This bucket's batch size (DataConfig.bucket_batch_sizes, falling
        back to the global batch_size)."""
        bbs = self.cfg.bucket_batch_sizes
        return self.cfg.batch_size if bbs is None else int(bbs[bucket])

    def set_epoch(self, epoch: int) -> None:
        """Pin the epoch counter so the NEXT ``epoch()`` call reproduces the
        shuffle order of training epoch ``epoch`` (orders are deterministic
        in ``seed + epoch``) — used by checkpoint restore to resume the
        data iterator mid-epoch."""
        self._epoch = int(epoch)

    # -- iteration ----------------------------------------------------------

    def __len__(self) -> int:
        """Approximate batches/epoch (exact for uniform batch sizes; with
        bucket_batch_sizes it estimates using the global batch_size — used
        only for lr-schedule horizon and progress reporting)."""
        return int(np.ceil(len(self.utts) / self.cfg.batch_size))

    def epoch(self, shuffle: bool = True) -> Iterator[Tuple[int, NumpyBatch]]:
        """Yield (bucket_id, batch) pairs for one epoch.

        Utterances are fetched from the source lazily (and in parallel when
        cfg.num_workers > 0); only the partially-filled bucket buffers are
        held in memory, so corpus size does not bound host RSS."""
        order = np.arange(len(self.utts))
        if shuffle:
            rng = np.random.default_rng(self.seed + self._epoch)
            rng.shuffle(order)
        self._epoch += 1

        buckets: Dict[int, List[Utterance]] = {}
        for u in self._iter_utterances(order):
            if self.require_audio:
                wlen = len(u.waveform) if u.waveform is not None else 0
                length = max((wlen - self.frame_length) // self.frame_step + 1, 1)
            else:
                vlen = (
                    u.video.shape[0] if u.video is not None
                    else (u.au.shape[0] if u.au is not None else 0)
                )
                # Boundaries are in 100 Hz audio-frame units; video/AU
                # streams run at cfg.video_fps.  Convert to the boundary
                # timescale so the chosen bucket's video capacity
                # (ceil(b*fps/100)+1, _compute_bucket_shapes) fits the
                # utterance — comparing raw 25 Hz frame counts against
                # 100 Hz boundaries would land long videos in buckets
                # that hold a quarter of their frames.
                length = int(np.ceil(vlen * 100.0 / self.cfg.video_fps))
            b = _bucket_for(int(length), self.cfg.audio_bucket_boundaries)
            buckets.setdefault(b, []).append(u)
            if len(buckets[b]) == self.batch_size_for(b):
                yield b, self._assemble(b, buckets.pop(b))
        # flush partial batches, repeating rows to keep shapes static
        for b, batch_utts in buckets.items():
            n_real = len(batch_utts)
            while len(batch_utts) < self.batch_size_for(b):
                batch_utts.append(batch_utts[len(batch_utts) % n_real])
            yield b, self._assemble(b, batch_utts, n_real=n_real)

    def _iter_utterances(self, order: np.ndarray) -> Iterator[Utterance]:
        """Fetch utterances in `order`, optionally via a bounded-window
        multiprocessing pool (DataConfig.num_workers)."""
        if self.cfg.num_workers <= 0 or len(order) == 0:
            for idx in order:
                yield self.utts[int(idx)]
            return
        yield from _parallel_fetch(self.utts, order, self.cfg.num_workers)

    def _warn_truncation(self, kind: str, uid: str, have: int, cap: int):
        """An utterance longer than the LAST bucket boundary is clipped to
        that bucket's capacity — the model never sees the tail while eval
        scores the full reference.  Loud (once): this looks exactly like
        model error otherwise.  Fix: extend audio_bucket_boundaries."""
        if self._warned_truncation:
            return
        self._warned_truncation = True
        _log.warning(
            "utterance %r: %s length %d exceeds the largest bucket's "
            "capacity %d and is TRUNCATED (further truncations not "
            "logged); extend data.audio_bucket_boundaries to cover the "
            "corpus", uid, kind, have, cap,
        )

    def _assemble(
        self, bucket: int, batch_utts: List[Utterance],
        n_real: Optional[int] = None,
    ) -> NumpyBatch:
        shape = self._bucket_shapes[bucket]
        B = len(batch_utts)
        out = NumpyBatch()
        out["uids"] = [u.uid for u in batch_utts]
        out["num_real"] = n_real if n_real is not None else B
        # Stable per-utterance hash (crc32 of uid): keys eval-time noise
        # assignment to the UTTERANCE, not its batch position, so a fixed
        # (type x SNR) condition is reproducible across batch compositions.
        out["uid_hashes"] = np.asarray(
            [zlib.crc32(u.uid.encode("utf-8")) for u in batch_utts], np.uint32
        )

        if self.require_audio:
            S = shape.audio_samples
            wav = np.zeros((B, S), np.float32)
            wlen = np.zeros((B,), np.int32)
            for j, u in enumerate(batch_utts):
                w = u.waveform
                n = min(len(w), S)
                if len(w) > S and (
                    (len(w) - self.frame_length) // self.frame_step
                    > (S - self.frame_length) // self.frame_step
                ):
                    # warn only when whole FRAMES are lost: a sub-frame
                    # sample tail (bucket capacities are frame-aligned,
                    # waveforms are not) never reaches the frontend anyway
                    self._warn_truncation("audio", u.uid, len(w), S)
                wav[j, :n] = w[:n]
                wlen[j] = n
            if self.cfg.transfer_dtype == "compact":
                # int16 PCM transfer: x32767 inverts load_wav's /32767, so
                # data that originated as 16-bit PCM round-trips bit-exactly;
                # the device dequantizes inside the jitted step.  Data off
                # the int16 grid would be silently distorted by clipping —
                # fail loudly instead (mirrors the video-range check).
                lo, hi = float(wav.min()), float(wav.max())
                if lo < -32768.0 / 32767.0 or hi > 1.0:
                    raise ValueError(
                        "data.transfer_dtype='compact' requires int16-PCM-"
                        f"range audio in [-32768/32767, 1]; batch has range "
                        f"[{lo:g}, {hi:g}] (gain-augmented or synthetic "
                        "audio must be rescaled, or use transfer_dtype="
                        "'float32')"
                    )
                wav = np.round(wav * 32767.0).astype(np.int16)
            out["audio"] = wav
            out["audio_lengths"] = wlen

        if self.require_video:
            T = shape.video_frames
            first = batch_utts[0]
            if first.video is not None:
                fshape = first.video.shape[1:]
                vid = np.zeros((B, T, *fshape), np.float32)
                vlen = np.zeros((B,), np.int32)
                for j, u in enumerate(batch_utts):
                    v = u.video
                    n = min(v.shape[0], T)
                    if v.shape[0] > T:
                        self._warn_truncation("video", u.uid, v.shape[0], T)
                    vid[j, :n] = v[:n]
                    vlen[j] = n
                if self.cfg.transfer_dtype == "compact":
                    # uint8 ROI transfer (round(v*255), the TFRecord uint8
                    # codec); device dequantizes with /255.  Requires [0, 1]
                    # crops — fail loudly rather than silently clip.
                    lo, hi = float(vid.min()), float(vid.max())
                    if lo < 0.0 or hi > 1.0:
                        raise ValueError(
                            "data.transfer_dtype='compact' requires video in "
                            f"[0, 1]; batch has range [{lo:g}, {hi:g}]"
                        )
                    vid = np.round(vid * 255.0).astype(np.uint8)
            else:  # AU feature path
                au_dim = first.au.shape[1]
                vid = np.zeros((B, T, au_dim), np.float32)
                vlen = np.zeros((B,), np.int32)
                for j, u in enumerate(batch_utts):
                    v = u.au
                    n = min(v.shape[0], T)
                    vid[j, :n] = v[:n]
                    vlen[j] = n
            out["video"] = vid
            out["video_lengths"] = vlen

        if self.au_target_stacking is not None:
            stack, skip = self.au_target_stacking
            # audio feature frames for this bucket's padded waveform
            T_raw = max((shape.audio_samples - self.frame_length)
                        // self.frame_step + 1, 1)
            T_a = max((T_raw - stack) // skip + 1, 1)
            au_t = np.zeros((B, T_a, self.au_dim), np.float32)
            # 1.0 = row contributes to the AU loss.  Repeated padding rows
            # and au=None utterances must weigh 0 — their all-zero targets
            # would otherwise regress AU predictions toward 0 at full
            # weight (the CE loss already excludes them via tlen=0).
            au_w = np.zeros((B,), np.float32)
            n_eff = n_real if n_real is not None else B
            feat_rate = 100.0 / skip  # stacked-feature frames per second
            for j, u in enumerate(batch_utts):
                au = u.au
                if au is None or j >= n_eff:
                    continue
                au_w[j] = 1.0
                wlen = len(u.waveform) if u.waveform is not None else 0
                n_aud = max(
                    ((min(wlen, shape.audio_samples)
                      - self.frame_length) // self.frame_step + 1 - stack)
                    // skip + 1, 0)
                for t in range(min(n_aud, T_a)):
                    v_idx = min(
                        int(round(t / feat_rate * self.cfg.video_fps)),
                        au.shape[0] - 1,
                    )
                    au_t[j, t, : au.shape[1]] = au[v_idx, : self.au_dim]
            out["au_targets"] = au_t
            out["au_row_weights"] = au_w

        K = shape.label_len
        tgt = np.zeros((B, K), np.int32)
        tlen = np.zeros((B,), np.int32)
        on_unknown = "error" if self.cfg.strict_units else "drop"
        # Scoring references: the DECODED text of the FULL encoded transcript,
        # independent of the bucket label cap K.  The training horizon is
        # capped (targets below); the reference an eval hypothesis is scored
        # against must NOT be, or label_bucket_caps silently shortens
        # references and inflates CER/WER.
        references: List[str] = []
        for j, u in enumerate(batch_utts):
            if not self.cfg.strict_units and not self._warned_oov:
                n_oov = self.units.count_unknown(u.transcript)
                if n_oov:
                    self._warned_oov = True
                    _log.warning(
                        "transcript %r contains %d unit(s) outside the %s "
                        "inventory; they are DROPPED from targets (set "
                        "data.strict_units=true to fail instead)",
                        u.transcript, n_oov, self.units.unit_type,
                    )
            full_ids = self.units.encode(u.transcript, on_unknown=on_unknown)
            references.append(self.units.decode(full_ids, stop_at_eos=False))
            ids = np.asarray(full_ids, np.int32)[:K]
            tgt[j, : len(ids)] = ids
            tlen[j] = len(ids)
        # repeated padding rows contribute zero loss
        if n_real is not None:
            tlen[n_real:] = 0
        out["references"] = references
        out["targets"] = tgt
        out["target_lengths"] = tlen
        return out


#: per-worker-process source handle, installed by the pool initializer so the
#: (potentially index-heavy) source pickles ONCE per worker, not per task.
_WORKER_SOURCE = None


def _worker_init(source) -> None:
    global _WORKER_SOURCE
    _WORKER_SOURCE = source


def _worker_fetch(idx: int):
    return _WORKER_SOURCE[idx]


def _parallel_fetch(source, order: np.ndarray, num_workers: int):
    """Fetch+decode records in worker processes, preserving `order`.

    The in-flight window is bounded (4 tasks per worker) so results never
    accumulate unboundedly ahead of the consumer — the tf.data
    parallel-parse equivalent (SURVEY.md §2.3 row 5)."""
    import collections
    import multiprocessing as mp
    from concurrent.futures import ProcessPoolExecutor

    window = num_workers * 4
    # spawn, not fork: the training process carries live device threads
    # and fork() in a threaded process risks deadlocks.  The data modules
    # import without torch's device runtime, so spawned workers start cheap.
    ex = ProcessPoolExecutor(
        max_workers=num_workers, mp_context=mp.get_context("spawn"),
        initializer=_worker_init, initargs=(source,),
    )
    try:
        pending: "collections.deque" = collections.deque()
        it = iter(order)
        for idx in it:
            pending.append(ex.submit(_worker_fetch, int(idx)))
            if len(pending) >= window:
                break
        while pending:
            yield pending.popleft().result()
            for idx in it:
                pending.append(ex.submit(_worker_fetch, int(idx)))
                break
    finally:
        ex.shutdown(wait=False, cancel_futures=True)


class PrefetchIterator:
    """Background-thread prefetch (tf.data's prefetch equivalent,
    SURVEY.md §2.3 row 5): batch assembly overlaps device compute."""

    def __init__(self, iterator: Iterator, depth: int = 2):
        import queue
        import threading

        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._sentinel = object()
        self._err: Optional[BaseException] = None

        def worker():
            try:
                for item in iterator:
                    self._q.put(item)
            except BaseException as e:  # surfaced on the consumer side
                self._err = e
            finally:
                self._q.put(self._sentinel)

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._sentinel:
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item


def prefetch(iterator: Iterator, depth: int = 2) -> Iterator:
    return PrefetchIterator(iterator, depth)


def to_model_batch(np_batch: NumpyBatch, device="cuda"):
    """NumpyBatch -> the port's ``seq2seq.Batch`` on ``device``
    (``seq2seq.batch_to_device``: pinned, non-blocking copies; ``uid_hashes``
    on the host); ``num_real``, ``uids`` and ``references`` are not batch
    fields and stay in ``np_batch`` for scoring."""
    from avsr_tpu_torch.models.seq2seq import batch_to_device

    return batch_to_device(np_batch, device)

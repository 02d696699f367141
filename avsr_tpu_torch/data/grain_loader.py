"""Streaming / random-access data sources over TFRecord files.

SURVEY.md §2.3 row 5 plans the tf.data replacement as a host-side loader
with sharded TFRecord parsing.  This module provides the corpus-scale
ingest layer:

* ``TFRecordDataSource`` — a random-access source (grain protocol:
  ``__len__`` + ``__getitem__``) that indexes a record file by seeking
  through the 12-byte framing headers only and decodes payloads lazily per
  access.  Host RSS stays bounded by the working set, not the corpus size —
  LRS2-scale (multi-GB) record files stream without materializing
  (the reference's tf.data streamed the same way, SURVEY §2.2 row 10).
* ``JoinedAVSource`` — the two-record iterator equivalent
  (upstream:avsr/io_utils.py make_iterator_from_two_records): INNER joins
  an audio and a video record file by uid, counting and reporting dropped
  unmatched utterances instead of silently mixing modality availability.
Sources are picklable (the file handle is opened lazily per process), so
multiprocessing decode workers can fetch records in parallel
(DataConfig.num_workers; see loader.BucketingLoader).  A copy of
``avsr_tpu/data/grain_loader.py``.
"""

from __future__ import annotations

import logging
from typing import List, Optional, Tuple

from avsr_tpu_torch.data import proto, tfrecord
from avsr_tpu_torch.data.synthetic import Utterance

log = logging.getLogger("avsr_tpu_torch")


class TFRecordDataSource:
    """Seek-based random-access source over one TFRecord file.

    Indexing reads only framing headers (O(records) bytes); ``__getitem__``
    seeks to the record span, crc-verifies, and decodes one utterance.
    """

    def __init__(self, path: str, verify: bool = True):
        self.path = path
        self.verify = verify
        self._index: List[Tuple[int, int]] = tfrecord.index_records(path)
        self._file = None  # opened lazily; never pickled

    # -- pickling (multiprocessing workers) --------------------------------
    def __getstate__(self):
        state = dict(self.__dict__)
        state["_file"] = None
        return state

    def _handle(self):
        if self._file is None:
            self._file = open(self.path, "rb")
        return self._file

    # -- source protocol ----------------------------------------------------
    def __len__(self) -> int:
        return len(self._index)

    def record_bytes(self, i: int) -> bytes:
        off, ln = self._index[i]
        return tfrecord.read_record_at(self._handle(), off, ln, self.verify)

    def __getitem__(self, i: int) -> Utterance:
        return tfrecord.utterance_from_bytes(self.record_bytes(i))

    def uids(self) -> List[str]:
        """One streaming pass decoding ONLY record contexts -> uid list."""
        out = []
        for i in range(len(self)):
            ctx = proto.decode_sequence_example_context(self.record_bytes(i))
            out.append(ctx["uid"][0].decode())
        return out


class JoinedAVSource:
    """Inner join of an audio and a video record source by uid.

    Every item has BOTH modalities; utterances present in only one file are
    dropped (counted in ``dropped_audio`` / ``dropped_video`` and logged) —
    a mixed-availability batch would otherwise dispatch the wrong video
    codec or silently feed zero video (SURVEY §2.2 row 10 two-record
    iterator semantics)."""

    def __init__(self, audio: TFRecordDataSource, video: TFRecordDataSource):
        self.audio = audio
        self.video = video
        a_uids = audio.uids()
        v_uids = {u: j for j, u in enumerate(video.uids())}
        self._pairs: List[Tuple[int, int]] = [
            (i, v_uids[u]) for i, u in enumerate(a_uids) if u in v_uids
        ]
        self.dropped_audio = len(a_uids) - len(self._pairs)
        self.dropped_video = len(v_uids) - len(self._pairs)
        if self.dropped_audio or self.dropped_video:
            log.warning(
                "AV uid join dropped %d audio-only and %d video-only "
                "utterances (%d joined)",
                self.dropped_audio, self.dropped_video, len(self._pairs),
            )
        if not self._pairs:
            raise ValueError(
                "audio/video record files share no uids — nothing to train on"
            )

    def __getstate__(self):
        return dict(self.__dict__)

    def __len__(self) -> int:
        return len(self._pairs)

    def __getitem__(self, i: int) -> Utterance:
        ai, vi = self._pairs[i]
        u = self.audio[ai]
        v = self.video[vi]
        u.video = v.video
        u.au = v.au
        return u


class ConcatSource:
    """Concatenation of random-access sources — SHARDED record corpora
    (`train-00000-of-00016.tfrecord`...) behave as one dataset.  Item i
    resolves to its shard by cumulative offset; uids() concatenates in
    shard order, so uid joins and deterministic shuffles are stable."""

    def __init__(self, sources: List[TFRecordDataSource]):
        if not sources:
            raise ValueError("ConcatSource needs at least one shard")
        self.sources = list(sources)
        self._offsets = []
        total = 0
        for s in self.sources:
            self._offsets.append(total)
            total += len(s)
        self._total = total

    def __len__(self) -> int:
        return self._total

    def _locate(self, i: int) -> Tuple[int, int]:
        import bisect

        if not 0 <= i < self._total:
            raise IndexError(i)
        k = bisect.bisect_right(self._offsets, i) - 1
        return k, i - self._offsets[k]

    def __getitem__(self, i: int) -> Utterance:
        k, j = self._locate(i)
        return self.sources[k][j]

    def record_bytes(self, i: int) -> bytes:
        k, j = self._locate(i)
        return self.sources[k].record_bytes(j)

    def uids(self) -> List[str]:
        out: List[str] = []
        for s in self.sources:
            out.extend(s.uids())
        return out


def expand_pattern(pattern: str) -> List[str]:
    """Expand a record pattern — one path, a glob of shards, or a
    comma-separated list of either — into a deterministic path list (glob
    matches sorted, so concatenation/shuffle order is seed-stable).  A
    part with no glob match is kept as a literal path (and fails loudly
    downstream if absent)."""
    import glob as _glob

    paths: List[str] = []
    for part in pattern.split(","):
        part = part.strip()
        if not part:
            continue
        matches = sorted(_glob.glob(part)) if _glob.has_magic(part) else []
        paths.extend(matches if matches else [part])
    if not paths:
        raise ValueError(f"empty record pattern {pattern!r}")
    return paths


def open_sharded(pattern: str) -> "TFRecordDataSource | ConcatSource":
    """Open one record file, a glob of shards, or a comma-separated list of
    either (``expand_pattern`` semantics), as a single random-access
    source."""
    paths = expand_pattern(pattern)
    if len(paths) == 1:
        return TFRecordDataSource(paths[0])
    return ConcatSource([TFRecordDataSource(p) for p in paths])


def load_utterances(path: str) -> List[Utterance]:
    """Eagerly materialize a record file (small-corpus convenience)."""
    src = TFRecordDataSource(path)
    return [src[i] for i in range(len(src))]

"""TFRecord container IO + AV utterance (de)serialization.

Rebuild of the reference's dataset-serialization layer
(upstream:avsr/dataset_writer.py + io_utils.py, SURVEY.md §2.2 rows 10-11,
§3.3): per-utterance audio/video/transcript records in TFRecord files.
Framing/crc run through the native C++ layer (avsr_tpu_torch/native, built
at first use) with a pure Python fallback; record payloads are
tf.train.SequenceExample wire format (avsr_tpu_torch/data/proto.py) so
files interoperate with TF tooling — without TensorFlow anywhere in this
stack.  A copy of ``avsr_tpu/data/tfrecord.py``: the two packages write
byte-equal files and read each other's.

Schema per utterance (one SequenceExample):
  context:
    "uid"            bytes[1]
    "transcript"     bytes[1]
    "sample_rate"    int64[1]          (audio records)
    "waveform_len"   int64[1]
    "video_shape"    int64[3]          (T, H, W — video records)
    "au_dim"         int64[1]          (AU records)
  feature_lists:
    "waveform"       float frames (chunked rows)
    "video"          bytes per frame (H*W float32, raw little-endian)
    "au"             float per frame
"""

from __future__ import annotations

import os
import struct
from typing import Iterator, List, Optional, Tuple

import numpy as np

from avsr_tpu_torch.data import proto
from avsr_tpu_torch.data.synthetic import Utterance

from avsr_tpu_torch import native as _native_lib


def _native():
    """The native framing where its library builds (at the first call),
    else None: the Python path below."""
    return _native_lib if _native_lib.available() else None


# ---------------------------------------------------------------------------
# Pure-python framing fallback
# ---------------------------------------------------------------------------

_CRC_TABLE: Optional[np.ndarray] = None


def _crc_table() -> np.ndarray:
    global _CRC_TABLE
    if _CRC_TABLE is None:
        poly = np.uint32(0x82F63B78)
        table = np.zeros(256, np.uint32)
        for i in range(256):
            c = np.uint32(i)
            for _ in range(8):
                c = (poly ^ (c >> np.uint32(1))) if (c & np.uint32(1)) else (c >> np.uint32(1))
            table[i] = c
        _CRC_TABLE = table
    return _CRC_TABLE


def _crc32c_py(data: bytes) -> int:
    table = _crc_table()
    c = np.uint32(0xFFFFFFFF)
    arr = np.frombuffer(data, np.uint8)
    for b in arr:
        c = table[(c ^ b) & np.uint32(0xFF)] ^ (c >> np.uint32(8))
    return int(c ^ np.uint32(0xFFFFFFFF))


def masked_crc32c(data: bytes) -> int:
    lib = _native()
    if lib is not None:
        return lib.masked_crc32c(data)
    crc = _crc32c_py(data)
    return ((crc >> 15) | (crc << 17) & 0xFFFFFFFF) + 0xA282EAD8 & 0xFFFFFFFF


def frame_record(data: bytes) -> bytes:
    lib = _native()
    if lib is not None:
        return lib.tfrecord_frame(data)
    header = struct.pack("<Q", len(data))
    return (
        header
        + struct.pack("<I", masked_crc32c(header))
        + data
        + struct.pack("<I", masked_crc32c(data))
    )


def iter_records(path: str, verify: bool = True) -> Iterator[bytes]:
    """Yield record payloads from a TFRecord file."""
    with open(path, "rb") as f:
        buf = f.read()
    lib = _native()
    if lib is not None:
        for off, ln in lib.tfrecord_index(buf, verify=verify):
            yield buf[off : off + ln]
        return
    pos = 0
    n = len(buf)
    while pos < n:
        if pos + 12 > n:
            raise ValueError("truncated TFRecord stream")
        (ln,) = struct.unpack_from("<Q", buf, pos)
        (len_crc,) = struct.unpack_from("<I", buf, pos + 8)
        if verify and masked_crc32c(buf[pos : pos + 8]) != len_crc:
            raise ValueError("length crc mismatch")
        start = pos + 12
        if start + ln + 4 > n:
            raise ValueError("truncated TFRecord stream")
        data = buf[start : start + ln]
        if verify:
            (data_crc,) = struct.unpack_from("<I", buf, start + ln)
            if masked_crc32c(data) != data_crc:
                raise ValueError("data crc mismatch")
        yield data
        pos = start + ln + 4


def index_records(path: str) -> List[Tuple[int, int]]:
    """Scan a TFRecord file's framing WITHOUT loading payloads.

    Seeks through the stream reading only the 12-byte headers (length-crc
    verified), so indexing a multi-GB file touches O(records) bytes of RAM —
    the streaming-ingest counterpart of the in-memory native index
    (SURVEY.md §2.3 row 5).  Returns [(payload_offset, payload_len)].
    """
    spans: List[Tuple[int, int]] = []
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        pos = 0
        while pos < size:
            header = f.read(12)
            if len(header) < 12:
                raise ValueError("truncated TFRecord stream")
            (ln,) = struct.unpack_from("<Q", header, 0)
            (len_crc,) = struct.unpack_from("<I", header, 8)
            if masked_crc32c(header[:8]) != len_crc:
                raise ValueError(f"length crc mismatch at offset {pos}")
            if pos + 16 > size or ln > size - pos - 16:
                raise ValueError("truncated TFRecord stream")
            spans.append((pos + 12, ln))
            pos += 12 + ln + 4
            f.seek(pos)
    return spans


def read_record_at(f, offset: int, length: int, verify: bool = True) -> bytes:
    """Read one record payload from an open binary file by span."""
    f.seek(offset)
    data = f.read(length)
    if len(data) != length:
        raise ValueError("truncated TFRecord payload")
    if verify:
        crc_bytes = f.read(4)
        if len(crc_bytes) != 4:
            # file truncated after indexing (writer crash / partial copy):
            # keep the module's ValueError contract, not struct.error
            raise ValueError(f"truncated TFRecord crc at offset {offset}")
        (data_crc,) = struct.unpack("<I", crc_bytes)
        if masked_crc32c(data) != data_crc:
            raise ValueError(f"data crc mismatch at offset {offset}")
    return data


class TFRecordWriter:
    """Streaming TFRecord writer (named for parity with the reference's
    ``TFRecordWriter`` class, upstream:avsr/dataset_writer.py)."""

    def __init__(self, path: str):
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._f = open(path, "wb")

    def write(self, payload: bytes) -> None:
        self._f.write(frame_record(payload))

    def close(self) -> None:
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# ---------------------------------------------------------------------------
# Utterance <-> SequenceExample
# ---------------------------------------------------------------------------

_WAVE_CHUNK = 1024  # samples per FloatList row (keeps rows small)


def utterance_to_bytes(u: Utterance, video_codec: str = "float32") -> bytes:
    """Serialize one utterance.

    ``video_codec`` selects the on-disk video representation explicitly (no
    value-range inference — lossy storage must be opted into by the writer):
      * "float32" (default): bit-exact little-endian float storage.
      * "uint8": lossy 8-bit quantization for lip-ROI crops in [0, 1]
        (4x smaller records; decode rescales by 1/255).  Raises if any
        video value falls outside [0, 1].
    The codec used is recorded in the record's "video_dtype" context field,
    so readers decode either form transparently.
    """
    context = {
        "uid": [u.uid.encode()],
        "transcript": [u.transcript.encode()],
    }
    feature_lists = {}
    if u.waveform is not None:
        wav = np.asarray(u.waveform, np.float32)
        context["waveform_len"] = [int(wav.shape[0])]
        # ndarray rows hit the proto packed-FloatList fast path (no
        # per-sample Python boxing) — the corpus-writer hot loop.
        feature_lists["waveform"] = [
            wav[i : i + _WAVE_CHUNK] for i in range(0, len(wav), _WAVE_CHUNK)
        ]
    if u.video is not None:
        vid = np.asarray(u.video, np.float32)
        T, H, W = vid.shape[0], vid.shape[1], vid.shape[2]
        context["video_shape"] = [T, H, W]
        if video_codec == "uint8":
            vmin, vmax = float(vid.min()), float(vid.max())
            if vmin < 0.0 or vmax > 1.0:
                raise ValueError(
                    f"video_codec='uint8' requires values in [0, 1]; got "
                    f"[{vmin:g}, {vmax:g}] for uid={u.uid!r}"
                )
            context["video_dtype"] = [b"uint8"]
            q = np.clip(np.round(vid * 255.0), 0, 255).astype(np.uint8)
            feature_lists["video"] = [[q[t].tobytes()] for t in range(T)]
        elif video_codec == "float32":
            context["video_dtype"] = [b"float32"]
            feature_lists["video"] = [
                [vid[t].astype("<f4").tobytes()] for t in range(T)
            ]
        else:
            raise ValueError(f"unknown video_codec: {video_codec!r}")
    if u.au is not None:
        au = np.asarray(u.au, np.float32)
        context["au_dim"] = [int(au.shape[1])]
        feature_lists["au"] = [au[t] for t in range(au.shape[0])]
    return proto.encode_sequence_example(context, feature_lists)


def utterance_from_bytes(data: bytes) -> Utterance:
    context, fls = proto.decode_sequence_example(data)
    uid = context["uid"][0].decode()
    transcript = context["transcript"][0].decode()
    waveform = video = au = None
    if "waveform" in fls:
        waveform = np.concatenate(
            [np.asarray(r, np.float32) for r in fls["waveform"]]
        )
        if "waveform_len" in context:
            waveform = waveform[: int(context["waveform_len"][0])]
    if "video" in fls:
        T, H, W = (int(x) for x in context["video_shape"])
        vdtype = context.get("video_dtype", [b"float32"])[0]
        if vdtype == b"uint8":
            frames = [
                np.frombuffer(r[0], np.uint8).reshape(H, W).astype(np.float32)
                / 255.0
                for r in fls["video"]
            ]
        else:
            frames = [
                np.frombuffer(r[0], "<f4").reshape(H, W) for r in fls["video"]
            ]
        video = np.stack(frames)[..., None]
    if "au" in fls:
        au = np.stack([np.asarray(r, np.float32) for r in fls["au"]])
    return Utterance(uid=uid, transcript=transcript, waveform=waveform,
                     video=video, au=au)


def write_dataset(
    utterances: List[Utterance], path: str, video_codec: str = "float32",
    num_shards: int = 1,
) -> List[str]:
    """Serialize utterances; ``num_shards > 1`` writes contiguous chunks to
    ``{path}-{i:05d}-of-{n:05d}`` (readable as one dataset via the shard
    glob ``{path}-*`` — data/grain_loader.open_sharded).  Returns the
    written paths."""
    if num_shards <= 1:
        with TFRecordWriter(path) as w:
            for u in utterances:
                w.write(utterance_to_bytes(u, video_codec=video_codec))
        return [path]
    n = len(utterances)
    per = -(-n // num_shards)
    paths = []
    for i in range(num_shards):
        shard_path = f"{path}-{i:05d}-of-{num_shards:05d}"
        paths.append(shard_path)
        with TFRecordWriter(shard_path) as w:
            for u in utterances[i * per : (i + 1) * per]:
                w.write(utterance_to_bytes(u, video_codec=video_codec))
    return paths


def read_dataset(path: str) -> List[Utterance]:
    return [utterance_from_bytes(r) for r in iter_records(path)]

"""TensorBoard scalar event files, written without TensorFlow (counterpart
of ``avsr_tpu/utils/tensorboard.py``: the same bytes for the same events).

Standard ``events.out.tfevents.*`` files any stock TensorBoard install can
point at, built on the port's own protobuf wire codec (``data/proto.py``)
and masked-crc32c record framing (``data/tfrecord.py``).

Wire format (tensorflow/core/util/event.proto + framework/summary.proto):

  Event  { double wall_time = 1; int64 step = 2;
           oneof { string file_version = 3; Summary summary = 5; } }
  Summary{ repeated Value value = 1; }
  Value  { string tag = 1; float simple_value = 2; }

Each record is TFRecord-framed (length, masked crc of length, payload,
masked crc of payload); the first event in a file carries
``file_version = "brain.Event:2"``.  The wall clock is injectable
(``EventWriter(clock=)``): the file name and the version event read it,
so two writers on one clock write equal bytes.
"""

from __future__ import annotations

import os
import socket
import struct
import time
from typing import Callable, Dict, Iterable, Optional

from avsr_tpu_torch.data.proto import (_iter_fields, _write_len_delimited, _write_tag,
                                       _write_varint)
from avsr_tpu_torch.data.tfrecord import frame_record, iter_records

_FILE_VERSION = "brain.Event:2"


def _encode_summary_value(tag: str, value: float) -> bytes:
    buf = bytearray()
    _write_len_delimited(buf, 1, tag.encode("utf-8"))
    _write_tag(buf, 2, 5)  # simple_value: float (fixed32)
    buf += struct.pack("<f", float(value))
    return bytes(buf)


def _encode_event(wall_time: float, step: Optional[int] = None,
                  file_version: Optional[str] = None,
                  summary_values: Iterable[bytes] = ()) -> bytes:
    buf = bytearray()
    _write_tag(buf, 1, 1)  # wall_time: double (fixed64)
    buf += struct.pack("<d", float(wall_time))
    if step is not None:
        _write_tag(buf, 2, 0)  # step: int64 (varint; steps are >= 0)
        _write_varint(buf, int(step))
    if file_version is not None:
        _write_len_delimited(buf, 3, file_version.encode("utf-8"))
    values = list(summary_values)
    if values:
        summ = bytearray()
        for v in values:
            _write_len_delimited(summ, 1, v)
        _write_len_delimited(buf, 5, bytes(summ))
    return bytes(buf)


class EventWriter:
    """Append-only writer of one ``events.out.tfevents.*`` file.

    ``add_scalars`` writes one Event holding every (tag, value) pair at
    the given step.  ``clock`` gives the wall time of the file name, of the
    version event and of every event written without its own.
    """

    def __init__(self, logdir: str, clock: Callable[[], float] = time.time):
        os.makedirs(logdir, exist_ok=True)
        self._clock = clock
        name = f"events.out.tfevents.{clock():.6f}.{socket.gethostname()}"
        self.path = os.path.join(logdir, name)
        self._f = open(self.path, "ab")
        self._write(_encode_event(clock(), file_version=_FILE_VERSION))
        self.flush()

    def _write(self, payload: bytes) -> None:
        self._f.write(frame_record(payload))

    def add_scalar(self, tag: str, value: float, step: int,
                   wall_time: Optional[float] = None) -> None:
        self.add_scalars({tag: value}, step, wall_time=wall_time)

    def add_scalars(self, scalars: Dict[str, float], step: int,
                    wall_time: Optional[float] = None) -> None:
        if not scalars:
            return
        self._write(_encode_event(
            wall_time if wall_time is not None else self._clock(), step=step,
            summary_values=[_encode_summary_value(t, v) for t, v in scalars.items()]))

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        if not self._f.closed:
            self._f.flush()
            self._f.close()


def read_events(path: str):
    """Decode an event file back into ``[(wall_time, step, {tag: value}),
    ...]`` (file_version events get an empty dict): a reader for the
    subset ``EventWriter`` emits."""
    out = []
    for rec in iter_records(path):
        wall_time, step, scalars = 0.0, 0, {}
        for field, wire, val in _iter_fields(rec):
            if field == 1 and wire == 1:
                wall_time = struct.unpack("<d", val)[0]
            elif field == 2 and wire == 0:
                step = int(val)
            elif field == 5 and wire == 2:
                for f2, w2, v2 in _iter_fields(val):
                    if f2 == 1 and w2 == 2:
                        tag, num = None, None
                        for f3, w3, v3 in _iter_fields(v2):
                            if f3 == 1 and w3 == 2:
                                tag = v3.decode("utf-8")
                            elif f3 == 2 and w3 == 5:
                                num = struct.unpack("<f", v3)[0]
                        if tag is not None and num is not None:
                            scalars[tag] = num
        out.append((wall_time, step, scalars))
    return out

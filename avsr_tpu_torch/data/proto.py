"""Minimal protobuf wire-format codec for tf.train.{Example, SequenceExample}.

The reference serializes utterances as ``tf.train.SequenceExample`` protos in
TFRecord files (upstream:avsr/dataset_writer.py + io_utils.py, SURVEY.md §2.2
rows 10-11).  To read/write those files WITHOUT TensorFlow in the training
path, this module implements the tiny subset of the protobuf wire format the
Example/SequenceExample schema needs:

  BytesList   { repeated bytes value = 1; }
  FloatList   { repeated float value = 1 [packed]; }
  Int64List   { repeated int64 value = 1 [packed]; }
  Feature     { BytesList=1 | FloatList=2 | Int64List=3 }
  Features    { map<string, Feature> feature = 1; }
  FeatureList { repeated Feature feature = 1; }
  FeatureLists{ map<string, FeatureList> feature_list = 1; }
  Example         { Features features = 1; }
  SequenceExample { Features context = 1; FeatureLists feature_lists = 2; }

Round-trip compatibility with TensorFlow's own serialization is pinned by
tests/test_tfrecord.py (which uses the installed TF only inside the test,
per SURVEY §7.0: TF allowed in offline tooling/tests, never in training).
A copy of ``avsr_tpu/data/proto.py``.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Union

FeatureValue = Union[List[bytes], List[float], List[int]]

_WT_VARINT = 0
_WT_64BIT = 1
_WT_LEN = 2
_WT_32BIT = 5


# ---------------------------------------------------------------------------
# wire primitives
# ---------------------------------------------------------------------------


def _write_varint(buf: bytearray, v: int) -> None:
    if v < 0:
        v += 1 << 64
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            buf.append(b | 0x80)
        else:
            buf.append(b)
            return


def _read_varint(data: bytes, pos: int):
    """UNSIGNED base-128 varint, capped at 10 bytes (the longest legal
    64-bit varint).  Tags and length prefixes must never be interpreted as
    signed: a crafted length >= 2^63 read as negative would move the parse
    position BACKWARD (infinite loop on hostile records — framing CRCs are
    attacker-computable), and unbounded continuation bytes would do O(n^2)
    bigint work.  Raises ValueError on truncation/overlength."""
    result = 0
    shift = 0
    end = min(pos + 10, len(data))
    while pos < end:
        b = data[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result & 0xFFFFFFFFFFFFFFFF, pos
        shift += 7
    raise ValueError("malformed varint (truncated or longer than 10 bytes)")


def _read_signed_varint(data: bytes, pos: int):
    """Int64 VALUE semantics: two's-complement reinterpretation of the
    unsigned wire varint (proto int64 fields encode negatives this way)."""
    v, pos = _read_varint(data, pos)
    if v >= 1 << 63:
        v -= 1 << 64
    return v, pos


def _write_tag(buf: bytearray, field: int, wire_type: int) -> None:
    _write_varint(buf, (field << 3) | wire_type)


def _write_len_delimited(buf: bytearray, field: int, payload: bytes) -> None:
    _write_tag(buf, field, _WT_LEN)
    _write_varint(buf, len(payload))
    buf.extend(payload)


def _iter_fields(data: bytes):
    """Iterate (field, wire_type, payload) with STRICT bounds: a declared
    length that overruns the buffer raises instead of silently yielding a
    Python-clamped short slice (which would decode truncated waveforms /
    feature rows as valid shorter data)."""
    pos = 0
    n = len(data)
    while pos < n:
        tag, pos = _read_varint(data, pos)
        field, wt = tag >> 3, tag & 7
        if wt == _WT_LEN:
            ln, pos = _read_varint(data, pos)
            if ln > n - pos:
                raise ValueError(
                    f"length-delimited field overruns buffer "
                    f"({ln} declared, {n - pos} remaining)"
                )
            yield field, wt, data[pos : pos + ln]
            pos += ln
        elif wt == _WT_VARINT:
            v, pos = _read_signed_varint(data, pos)
            yield field, wt, v
        elif wt == _WT_32BIT:
            if n - pos < 4:
                raise ValueError("truncated fixed32 field")
            yield field, wt, data[pos : pos + 4]
            pos += 4
        elif wt == _WT_64BIT:
            if n - pos < 8:
                raise ValueError("truncated fixed64 field")
            yield field, wt, data[pos : pos + 8]
            pos += 8
        else:
            raise ValueError(f"unsupported wire type {wt}")


# ---------------------------------------------------------------------------
# Feature encode/decode
# ---------------------------------------------------------------------------


def encode_feature(value: FeatureValue) -> bytes:
    """Infer the list type from the first element (empty -> bytes list).

    NumPy float arrays take a zero-copy fast path (packed FloatList straight
    from the buffer) — corpus-scale record writing is dominated by waveform
    serialization otherwise."""
    import numpy as _np

    if isinstance(value, _np.ndarray):
        if value.dtype.kind == "f":
            packed = _np.ascontiguousarray(value, dtype="<f4").tobytes()
            pl = bytearray()
            _write_len_delimited(pl, 1, packed)
            out = bytearray()
            _write_len_delimited(out, 2, bytes(pl))
            return bytes(out)
        if value.dtype.kind in "iu":
            value = [int(v) for v in value.reshape(-1)]
        else:
            raise TypeError(
                f"cannot encode ndarray feature of dtype {value.dtype}"
            )
    inner = bytearray()
    if len(value) and isinstance(value[0], (bytes, bytearray)):
        for v in value:
            _write_len_delimited(inner, 1, bytes(v))
        kind = 1
    elif len(value) and isinstance(value[0], (float, _np.floating)):
        packed = struct.pack(f"<{len(value)}f", *value)
        pl = bytearray()
        _write_len_delimited(pl, 1, packed)
        inner = pl
        kind = 2
    elif len(value) and isinstance(value[0], (int, _np.integer)):
        pl = bytearray()
        packed = bytearray()
        for v in value:
            _write_varint(packed, int(v))
        _write_len_delimited(pl, 1, bytes(packed))
        inner = pl
        kind = 3
    elif len(value):
        # Silently writing an empty BytesList here would round-trip
        # "successfully" with the values dropped — corrupt corpora
        # discovered only at training time.
        raise TypeError(
            f"cannot encode feature element of type {type(value[0])}"
        )
    else:  # empty
        kind = 1
    out = bytearray()
    _write_len_delimited(out, kind, bytes(inner))
    return bytes(out)


def decode_feature(data: bytes) -> FeatureValue:
    for field, wt, payload in _iter_fields(data):
        if field == 1:  # BytesList
            return [p for f, w, p in _iter_fields(payload) if f == 1]
        if field == 2:  # FloatList (packed or unpacked)
            vals: List[float] = []
            for f, w, p in _iter_fields(payload):
                if f != 1:
                    continue
                if w == _WT_LEN:
                    vals.extend(struct.unpack(f"<{len(p)//4}f", p))
                elif w == _WT_32BIT:
                    vals.append(struct.unpack("<f", p)[0])
            return vals
        if field == 3:  # Int64List (packed or unpacked)
            ivals: List[int] = []
            for f, w, p in _iter_fields(payload):
                if f != 1:
                    continue
                if w == _WT_LEN:
                    pos = 0
                    while pos < len(p):
                        v, pos = _read_signed_varint(p, pos)
                        ivals.append(v)
                else:
                    ivals.append(p)
            return ivals
    return []


# ---------------------------------------------------------------------------
# Features / FeatureLists / SequenceExample
# ---------------------------------------------------------------------------


def _encode_map_entry(key: str, value_payload: bytes) -> bytes:
    entry = bytearray()
    _write_len_delimited(entry, 1, key.encode())
    _write_len_delimited(entry, 2, value_payload)
    return bytes(entry)


def encode_features(features: Dict[str, FeatureValue]) -> bytes:
    out = bytearray()
    for k in sorted(features):
        _write_len_delimited(out, 1, _encode_map_entry(k, encode_feature(features[k])))
    return bytes(out)


def decode_features(data: bytes) -> Dict[str, FeatureValue]:
    out: Dict[str, FeatureValue] = {}
    for field, _wt, payload in _iter_fields(data):
        if field != 1:
            continue
        key, val = None, None
        for f, _w, p in _iter_fields(payload):
            if f == 1:
                key = p.decode()
            elif f == 2:
                val = p
        if key is not None and val is not None:
            out[key] = decode_feature(val)
    return out


def encode_feature_list(features: List[FeatureValue]) -> bytes:
    out = bytearray()
    for f in features:
        _write_len_delimited(out, 1, encode_feature(f))
    return bytes(out)


def decode_feature_list(data: bytes) -> List[FeatureValue]:
    return [decode_feature(p) for f, _w, p in _iter_fields(data) if f == 1]


def encode_feature_lists(fls: Dict[str, List[FeatureValue]]) -> bytes:
    out = bytearray()
    for k in sorted(fls):
        _write_len_delimited(
            out, 1, _encode_map_entry(k, encode_feature_list(fls[k]))
        )
    return bytes(out)


def decode_feature_lists(data: bytes) -> Dict[str, List[FeatureValue]]:
    out: Dict[str, List[FeatureValue]] = {}
    for field, _wt, payload in _iter_fields(data):
        if field != 1:
            continue
        key, val = None, None
        for f, _w, p in _iter_fields(payload):
            if f == 1:
                key = p.decode()
            elif f == 2:
                val = p
        if key is not None and val is not None:
            out[key] = decode_feature_list(val)
    return out


def encode_example(features: Dict[str, FeatureValue]) -> bytes:
    out = bytearray()
    _write_len_delimited(out, 1, encode_features(features))
    return bytes(out)


def decode_example(data: bytes) -> Dict[str, FeatureValue]:
    for field, _wt, payload in _iter_fields(data):
        if field == 1:
            return decode_features(payload)
    return {}


def encode_sequence_example(
    context: Dict[str, FeatureValue],
    feature_lists: Dict[str, List[FeatureValue]],
) -> bytes:
    out = bytearray()
    if context:
        _write_len_delimited(out, 1, encode_features(context))
    if feature_lists:
        _write_len_delimited(out, 2, encode_feature_lists(feature_lists))
    return bytes(out)


def decode_sequence_example_context(data: bytes) -> Dict[str, FeatureValue]:
    """Decode ONLY the context of a SequenceExample, skipping feature_lists.

    Streaming ingest uses this for cheap metadata scans (uid, lengths) —
    the heavy per-frame feature_lists bytes are never parsed."""
    for field, _wt, payload in _iter_fields(data):
        if field == 1:
            return decode_features(payload)
    return {}


def decode_sequence_example(data: bytes):
    context: Dict[str, FeatureValue] = {}
    feature_lists: Dict[str, List[FeatureValue]] = {}
    for field, _wt, payload in _iter_fields(data):
        if field == 1:
            context = decode_features(payload)
        elif field == 2:
            feature_lists = decode_feature_lists(payload)
    return context, feature_lists

"""Native (C++) host components, loaded with ctypes (counterpart of
``avsr_tpu/native``): crc32c, TFRecord framing and Levenshtein distance
from ``avsr_native.cc``, the port's copy of the JAX package's source.

The library is compiled at first use (the first ``available()`` call, which
every entry point makes), never at import, into the repository's
``build/`` directory beside the CUDA kernels' library, named by a hash of
the source.  Where no host compiler is found or the build fails,
``available()`` is False and every consumer (``data/tfrecord.py``,
``eval/metrics.py``) runs its Python / NumPy path: the absence of a
toolchain costs speed, not capability.  This is host code; no device
kernel is here.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

SOURCE = Path(__file__).resolve().parent / "avsr_native.cc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-Wall")

_lib: Optional[ctypes.CDLL] = None
_tried = False


def library_path() -> Path:
    """Where the build puts the library: ``build/libavsr_native_<hash>.so``,
    the hash over the source and the flags."""
    h = hashlib.sha256(SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libavsr_native_{h.hexdigest()[:16]}.so"


def _build(out: Path) -> bool:
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        return False
    tmp = None
    try:
        out.parent.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
        os.close(fd)
        subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, str(SOURCE)], check=True,
                       stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL, timeout=300)
        os.replace(tmp, out)  # atomic: concurrent builders never see half a file
        return True
    except (OSError, subprocess.SubprocessError):
        if tmp is not None and os.path.exists(tmp):
            os.unlink(tmp)
        return False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    so = library_path()
    if not so.exists() and not _build(so):
        return None
    try:
        lib = ctypes.CDLL(str(so))
    except OSError:
        return None
    lib.avsr_crc32c.restype = ctypes.c_uint32
    lib.avsr_crc32c.argtypes = [ctypes.c_char_p, ctypes.c_uint64]
    lib.avsr_masked_crc32c.restype = ctypes.c_uint32
    lib.avsr_masked_crc32c.argtypes = [ctypes.c_char_p, ctypes.c_uint64]
    lib.avsr_tfrecord_index.restype = ctypes.c_int64
    lib.avsr_tfrecord_index.argtypes = [
        ctypes.c_char_p, ctypes.c_uint64,
        ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_uint64),
        ctypes.c_int64, ctypes.c_int,
    ]
    lib.avsr_tfrecord_frame.restype = ctypes.c_uint64
    lib.avsr_tfrecord_frame.argtypes = [ctypes.c_char_p, ctypes.c_uint64, ctypes.c_char_p]
    lib.avsr_levenshtein.restype = ctypes.c_int64
    lib.avsr_levenshtein.argtypes = [
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
    ]
    _lib = lib
    return lib


def available() -> bool:
    """Whether the native library is built and loaded (building it at the
    first call)."""
    return _load() is not None


def _need() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    return lib


# ---------------------------------------------------------------------------
# crc32c
# ---------------------------------------------------------------------------


def crc32c(data: bytes) -> int:
    return int(_need().avsr_crc32c(data, len(data)))


def masked_crc32c(data: bytes) -> int:
    return int(_need().avsr_masked_crc32c(data, len(data)))


# ---------------------------------------------------------------------------
# TFRecord framing
# ---------------------------------------------------------------------------


def tfrecord_index(buf: bytes, verify: bool = True) -> List[Tuple[int, int]]:
    """Return [(data_offset, data_length)] for all records in the buffer."""
    lib = _need()
    # every record is >= 16 bytes of framing; start small and grow on the C
    # side's -4 (capacity) code rather than size the index at the bound
    hard = max(len(buf) // 16, 1)
    cap = min(65536, hard)
    while True:
        offsets = (ctypes.c_uint64 * cap)()
        lengths = (ctypes.c_uint64 * cap)()
        n = lib.avsr_tfrecord_index(buf, len(buf), offsets, lengths, cap, int(verify))
        if n == -4:
            if cap >= hard:
                raise ValueError("corrupt TFRecord stream (trailing bytes after the last "
                                 "record)")
            cap = min(cap * 4, hard)
            continue
        if n < 0:
            raise ValueError(f"corrupt TFRecord stream (code {n})")
        return [(int(offsets[i]), int(lengths[i])) for i in range(n)]


def tfrecord_frame(data: bytes) -> bytes:
    out = ctypes.create_string_buffer(len(data) + 16)
    n = _need().avsr_tfrecord_frame(data, len(data), out)
    return out.raw[:n]


# ---------------------------------------------------------------------------
# edit distance
# ---------------------------------------------------------------------------


def levenshtein_ids(a, b) -> int:
    """Edit distance of two int id sequences (insert / delete / substitute,
    cost 1)."""
    lib = _need()
    # contiguous: the C kernel reads stride-1
    aa = np.ascontiguousarray(a, np.int32)
    bb = np.ascontiguousarray(b, np.int32)
    return int(lib.avsr_levenshtein(aa.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), len(aa),
                                    bb.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), len(bb)))

"""Hand-written CUDA kernels: build at first use, ctypes binding, launch counts.

The sources live in ``avsr_tpu_torch/csrc/*.cu``.  They expose a plain C
interface (pointers and the CUDA stream as ``void*``, sizes as ``int``;
each entry point returns ``cudaGetLastError()``), so the build is one
``nvcc`` call with no PyTorch headers: it takes seconds, not the minutes a
``torch.utils.cpp_extension`` build takes.  The shared library goes to
``build/`` at the repository root, named by a hash of the sources and
flags, and is reused while they are unchanged.

Nothing here runs at import time: the CPU tests import every module on a
machine with no ``nvcc`` and no GPU.  The functions below are the CUDA side
of the wrappers in ``ops/rnn.py`` and ``ops/audio_features.py``; each one
checks its tensors, allocates the outputs with ``torch.empty``, launches on
the current stream, raises on a nonzero CUDA status, and adds one to its
entry of ``LAUNCHES``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

# Launch counts of each kernel wrapper: +1 per wrapper call that launched
# its kernel (one call may issue several grid launches, e.g. one per step).
LAUNCHES: Dict[str, int] = {"lstm_scan_fwd": 0, "logmel_post_dft": 0}

LSTM_UNIT_TILE = 16  # hidden units per block of the LSTM kernel (UT in the source)

_lib: Optional[ctypes.CDLL] = None
BUILD_SECONDS: Optional[float] = None


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        cand = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.exists(cand):
            return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return found


def build() -> Path:
    """Compile every ``csrc/*.cu`` into one shared library (cached by hash)."""
    global BUILD_SECONDS
    sources = sorted(CSRC.glob("*.cu"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    out = BUILD_DIR / f"libavsr_kernels_{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({res.returncode}):\n{' '.join(cmd)}\n{res.stderr}"
        )
    os.replace(tmp, out)
    BUILD_SECONDS = time.perf_counter() - t0
    return out


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.avsr_lstm_scan_fwd.argtypes = [p, p, p, p, p, p, p, i, i, i, i, p]
        lib.avsr_lstm_scan_fwd.restype = i
        lib.avsr_logmel_post_dft.argtypes = [
            p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, f, p,
        ]
        lib.avsr_logmel_post_dft.restype = i
        _lib = lib
    return _lib


def _check(name: str, x: torch.Tensor, dtype: torch.dtype, shape: Tuple,
           device: torch.device) -> None:
    if x.device != device or x.device.type != "cuda":
        raise ValueError(f"{name}: expected a tensor on {device}, got {x.device}")
    if x.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def tile_lstm_weights(wh: torch.Tensor) -> torch.Tensor:
    """[G, H, 4H] -> [G, H/UT, H, UT, 4], the layout the LSTM kernel reads:
    each block's Wh slice is contiguous and the four gate weights of one
    hidden unit are adjacent (``csrc/lstm_scan.cu``)."""
    G, H, _ = wh.shape
    nt = H // LSTM_UNIT_TILE
    return wh.view(G, H, 4, nt, LSTM_UNIT_TILE).permute(0, 3, 1, 4, 2).contiguous()


def lstm_scan_fwd(wh, b, xw, mask, h0, c0):
    """K1: direction-batched masked LSTM recurrence, forward (CUDA).

    wh [G,H,4H] bf16, b [G,4H] f32, xw [T,G,B,4H] bf16, mask [T,G,B] f32,
    h0/c0 [G,B,H] f32 -> (ys [T,G,B,H] bf16, hT [G,B,H] f32, cT f32).
    """
    T, G, B, H4 = xw.shape
    H = H4 // 4
    dev = xw.device
    _check("xw", xw, torch.bfloat16, (T, G, B, 4 * H), dev)
    _check("wh", wh, torch.bfloat16, (G, H, 4 * H), dev)
    _check("b", b, torch.float32, (G, 4 * H), dev)
    _check("mask", mask, torch.float32, (T, G, B), dev)
    _check("h0", h0, torch.float32, (G, B, H), dev)
    _check("c0", c0, torch.float32, (G, B, H), dev)
    if H % LSTM_UNIT_TILE:
        raise ValueError(f"lstm_scan_fwd: H={H} must be a multiple of {LSTM_UNIT_TILE}")
    lib = _load()
    wh_tiled = tile_lstm_weights(wh)
    hbuf = torch.empty((2, G, B, H), dtype=torch.float32, device=dev)
    hbuf[0].copy_(h0)
    c = c0.clone()
    ys = torch.empty((T, G, B, H), dtype=torch.bfloat16, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.avsr_lstm_scan_fwd(
        wh_tiled.data_ptr(), b.data_ptr(), xw.data_ptr(), mask.data_ptr(),
        hbuf.data_ptr(), c.data_ptr(), ys.data_ptr(), T, G, B, H, stream,
    )
    _raise_on(err, "lstm_scan_fwd launch")
    LAUNCHES["lstm_scan_fwd"] += 1
    return ys, hbuf[T % 2], c


def logmel_post_dft(re, im, feat_len, mel_w, *, log_floor: float,
                    delta_window: int, stack: int, skip: int):
    """K3: power -> mel -> log -> Δ/ΔΔ -> masked CMVN -> stack (CUDA).

    re/im [B,T,F] f32, feat_len [B] int32, mel_w [F,M] f32 ->
    (features [B,T',3*M*stack] f32, lengths [B] int32).
    """
    B, T, F = re.shape
    M = mel_w.shape[1]
    dev = re.device
    _check("re", re, torch.float32, (B, T, F), dev)
    _check("im", im, torch.float32, (B, T, F), dev)
    _check("feat_len", feat_len, torch.int32, (B,), dev)
    _check("mel_w", mel_w, torch.float32, (F, M), dev)
    Tp = max(0, (T - stack) // skip + 1)
    lib = _load()
    logmel = torch.empty((B, T, M), dtype=torch.float32, device=dev)
    out = torch.empty((B, Tp, 3 * M * stack), dtype=torch.float32, device=dev)
    new_len = torch.empty((B,), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.avsr_logmel_post_dft(
        re.data_ptr(), im.data_ptr(), feat_len.data_ptr(), mel_w.data_ptr(),
        logmel.data_ptr(), out.data_ptr(), new_len.data_ptr(),
        B, T, F, M, Tp, stack, skip, delta_window, float(log_floor), stream,
    )
    _raise_on(err, "logmel_post_dft launch")
    LAUNCHES["logmel_post_dft"] += 1
    return out, new_len

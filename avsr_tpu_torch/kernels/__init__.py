"""Hand-written CUDA kernels: build at first use, ctypes binding, launch counts.

The sources live in ``avsr_tpu_torch/csrc/*.cu``.  They expose a plain C
interface (pointers and the CUDA stream as ``void*``, sizes as ``int``;
each entry point returns ``cudaGetLastError()``), so the build is one
``nvcc`` per source (started together) and a link, with no PyTorch
headers: it takes seconds, not the minutes a ``torch.utils.cpp_extension``
build takes.  The shared library goes to
``build/`` at the repository root, named by a hash of the sources and
flags, and is reused while they are unchanged.

Nothing here runs at import time: the CPU tests import every module on a
machine with no ``nvcc`` and no GPU.  The functions below are the CUDA side
of the wrappers in ``ops/rnn.py``, ``ops/audio_features.py`` and
``models/fusion.py``; each one checks its tensors, allocates the outputs
and scratch with ``torch.empty`` / ``torch.zeros``, launches on the current
stream, raises on a nonzero CUDA status, and adds one to its entry of
``LAUNCHES``.
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
LAUNCHES: Dict[str, int] = {
    "lstm_scan_fwd": 0, "lstm_scan_bwd": 0, "logmel_post_dft": 0,
    "fusion_attention_fwd": 0, "fusion_attention_bwd": 0,
}

LSTM_UNIT_TILE = 16  # hidden units per block of the LSTM kernels (UT in the source)
LSTM_ROW_TILE = 16   # batch rows per block of the LSTM kernels (BT in the source)
FUSION_MAX_TV = 400  # video frames the fusion kernel takes: 16 s at 25 fps
SMEM_LIMIT = 232448  # bytes of shared memory one block may use on an H100

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
    """Compile every ``csrc/*.cu`` into one shared library (cached by hash):
    one ``nvcc -c`` per source, all started together, then one link."""
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
    tag = f"{h.hexdigest()[:16]}.{os.getpid()}"
    t0 = time.perf_counter()
    nvcc = _nvcc()
    compile_flags = [f for f in NVCC_FLAGS if f != "-shared"]
    objects = [BUILD_DIR / f"{src.stem}.{tag}.o" for src in sources]
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    try:
        procs = [subprocess.Popen([nvcc, *compile_flags, "-c", "-o", str(obj), str(src)],
                                  stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                 for src, obj in zip(sources, objects)]
        errors = []
        for src, proc in zip(sources, procs):
            _, err = proc.communicate()
            if proc.returncode != 0:
                errors.append(f"nvcc failed on {src.name} ({proc.returncode}):\n{err}")
        if errors:
            raise RuntimeError("\n".join(errors))
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), *map(str, objects)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(
                f"nvcc link failed ({res.returncode}):\n{' '.join(cmd)}\n{res.stderr}")
    finally:
        for obj in objects:
            obj.unlink(missing_ok=True)
    os.replace(tmp, out)
    BUILD_SECONDS = time.perf_counter() - t0
    return out


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.avsr_lstm_scan_fwd.argtypes = [p, p, p, p, p, p, p, p, p, i, i, i, i, p]
        lib.avsr_lstm_scan_fwd.restype = i
        lib.avsr_lstm_scan_bwd.argtypes = [p] * 14 + [i, i, i, i, p]
        lib.avsr_lstm_scan_bwd.restype = i
        lib.avsr_fusion_attn_smem.argtypes = [i, i, i, i]
        lib.avsr_fusion_attn_smem.restype = ctypes.c_longlong
        lib.avsr_fusion_attn_fwd.argtypes = [p] * 6 + [i] * 6 + [p]
        lib.avsr_fusion_attn_fwd.restype = i
        lib.avsr_fusion_attn_bwd.argtypes = [p] * 9 + [i] * 6 + [p]
        lib.avsr_fusion_attn_bwd.restype = i
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
    if x.data_ptr() % 16:
        raise ValueError(f"{name}: expected a 16-byte aligned tensor")


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


def tile_lstm_weights_t(wh: torch.Tensor) -> torch.Tensor:
    """[G, H, 4H] -> [G, H/UT, H, UT, 4], the layout the LSTM backward's dh
    product reads: [g, t, kq, u, j] = Wh[g, t*UT + u, 4*kq + j], so each
    block's rows of Wh are one contiguous run and a thread reads four
    consecutive k of its unit as one 8-byte load (``csrc/lstm_scan.cu``)."""
    G, H, _ = wh.shape
    nt = H // LSTM_UNIT_TILE
    return wh.view(G, nt, LSTM_UNIT_TILE, H, 4).permute(0, 1, 3, 2, 4).contiguous()


def _check_lstm(xw, wh, b, mask, T, G, B, H, dev):
    _check("xw", xw, torch.bfloat16, (T, G, B, 4 * H), dev)
    _check("wh", wh, torch.bfloat16, (G, H, 4 * H), dev)
    _check("b", b, torch.float32, (G, 4 * H), dev)
    _check("mask", mask, torch.float32, (T, G, B), dev)
    if H % LSTM_UNIT_TILE:
        raise ValueError(f"lstm scan: H={H} must be a multiple of {LSTM_UNIT_TILE}")


def lstm_scan_fwd(wh, b, xw, mask, h0, c0, *, save: bool = False):
    """K1: direction-batched masked LSTM recurrence, forward (CUDA).

    wh [G,H,4H] bf16, b [G,4H] f32, xw [T,G,B,4H] bf16, mask [T,G,B] f32,
    h0/c0 [G,B,H] f32 -> (ys [T,G,B,H] bf16, hT [G,B,H] f32, cT f32,
    h_res, c_res), the last two the bf16 [T,G,B,H] carries entering each
    step when ``save`` (the backward's residuals), else None.
    """
    T, G, B, H4 = xw.shape
    H = H4 // 4
    dev = xw.device
    _check_lstm(xw, wh, b, mask, T, G, B, H, dev)
    _check("h0", h0, torch.float32, (G, B, H), dev)
    _check("c0", c0, torch.float32, (G, B, H), dev)
    lib = _load()
    wh_tiled = tile_lstm_weights(wh)
    hbuf = torch.empty((2, G, B, H), dtype=torch.float32, device=dev)
    hbuf[0].copy_(h0)
    c = c0.clone()
    ys = torch.empty((T, G, B, H), dtype=torch.bfloat16, device=dev)
    h_res = c_res = None
    if save:
        h_res = torch.empty((T, G, B, H), dtype=torch.bfloat16, device=dev)
        c_res = torch.empty((T, G, B, H), dtype=torch.bfloat16, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.avsr_lstm_scan_fwd(
        wh_tiled.data_ptr(), b.data_ptr(), xw.data_ptr(), mask.data_ptr(),
        hbuf.data_ptr(), c.data_ptr(), ys.data_ptr(),
        h_res.data_ptr() if save else None, c_res.data_ptr() if save else None,
        T, G, B, H, stream,
    )
    _raise_on(err, "lstm_scan_fwd launch")
    LAUNCHES["lstm_scan_fwd"] += 1
    return ys, hbuf[T % 2], c, h_res, c_res


def lstm_scan_bwd(wh, b, xw, mask, h_res, c_res, dys, dhT, dcT):
    """K1: the reverse scan of the hand-written VJP (CUDA).

    Same operands as the forward plus the bf16 residuals h_res/c_res
    [T,G,B,H] and the cotangents dys [T,G,B,H] bf16, dhT/dcT [G,B,H] f32
    -> (dxw [T,G,B,4H] bf16 (= dgates), db [G,4H] f32, dh0, dc0 [G,B,H]
    f32).  dWh is one product over all steps, left to the caller.
    """
    T, G, B, H4 = xw.shape
    H = H4 // 4
    dev = xw.device
    _check_lstm(xw, wh, b, mask, T, G, B, H, dev)
    for name, x in (("h_res", h_res), ("c_res", c_res), ("dys", dys)):
        _check(name, x, torch.bfloat16, (T, G, B, H), dev)
    _check("dhT", dhT, torch.float32, (G, B, H), dev)
    _check("dcT", dcT, torch.float32, (G, B, H), dev)
    if T < 1:
        raise ValueError("lstm_scan_bwd: needs at least one step")
    lib = _load()
    wh_tiled = tile_lstm_weights(wh)
    whT_tiled = tile_lstm_weights_t(wh)
    dh_dir = dhT.clone()
    dc = dcT.clone()
    n_row_tiles = -(-B // LSTM_ROW_TILE)
    db_part = torch.zeros((G, n_row_tiles, 4 * H), dtype=torch.float32, device=dev)
    dxw = torch.empty((T, G, B, 4 * H), dtype=torch.bfloat16, device=dev)
    dh0 = torch.empty((G, B, H), dtype=torch.float32, device=dev)
    db = torch.empty((G, 4 * H), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.avsr_lstm_scan_bwd(
        wh_tiled.data_ptr(), whT_tiled.data_ptr(), b.data_ptr(), xw.data_ptr(),
        mask.data_ptr(), h_res.data_ptr(), c_res.data_ptr(), dys.data_ptr(),
        dh_dir.data_ptr(), dc.data_ptr(), db_part.data_ptr(), dxw.data_ptr(),
        dh0.data_ptr(), db.data_ptr(), T, G, B, H, stream,
    )
    _raise_on(err, "lstm_scan_bwd launch")
    LAUNCHES["lstm_scan_bwd"] += 1
    return dxw, db, dh0, dc


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


def _check_fusion(q, k, v, dev):
    B, Ta, nh, A = q.shape
    Tv, dv = k.shape[1], v.shape[-1]
    _check("q", q, torch.bfloat16, (B, Ta, nh, A), dev)
    _check("k", k, torch.bfloat16, (B, Tv, nh, A), dev)
    _check("v", v, torch.bfloat16, (B, Tv, nh, dv), dev)
    if A % 8 or dv % 8:
        raise ValueError(f"fusion attention: head dims {A}/{dv} must be multiples of 8")
    if not (1 <= Ta and 1 <= Tv <= FUSION_MAX_TV):
        raise ValueError(f"fusion attention: T_a={Ta}, T_v={Tv}; the kernel takes "
                         f"1 <= T_v <= {FUSION_MAX_TV}")
    smem = _load().avsr_fusion_attn_smem(Ta, Tv, A, dv)
    if smem > SMEM_LIMIT:
        raise ValueError(f"fusion attention: T_a={Ta}, T_v={Tv}, A={A}, dv={dv} need "
                         f"{smem} bytes of shared memory per block (limit {SMEM_LIMIT})")
    return B, Ta, Tv, nh, A, dv


def fusion_attention_fwd(q, k, v, video_lengths):
    """K4: the cross-attention fusion core, forward (CUDA).

    q [B,T_a,nh,A], k [B,T_v,nh,A], v [B,T_v,nh,dv] bf16, video_lengths [B]
    int32 -> (ctx [B,T_a,nh,dv] bf16, weights [B,nh,T_a,T_v] f32).
    """
    dev = q.device
    B, Ta, Tv, nh, A, dv = _check_fusion(q, k, v, dev)
    _check("video_lengths", video_lengths, torch.int32, (B,), dev)
    lib = _load()
    P = torch.empty((B, nh, Ta, Tv), dtype=torch.float32, device=dev)
    ctx = torch.empty((B, Ta, nh, dv), dtype=torch.bfloat16, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.avsr_fusion_attn_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), video_lengths.data_ptr(),
        P.data_ptr(), ctx.data_ptr(), B, Ta, Tv, nh, A, dv, stream)
    _raise_on(err, "fusion_attention_fwd launch")
    LAUNCHES["fusion_attention_fwd"] += 1
    return ctx, P


def fusion_attention_bwd(q, k, v, weights, dctx):
    """K4: the cross-attention fusion core, backward (CUDA).

    The forward's q, k, v, its fp32 weights [B,nh,T_a,T_v] and the context
    cotangent dctx [B,T_a,nh,dv] bf16 -> (dq, dk, dv) in bf16.
    """
    dev = q.device
    B, Ta, Tv, nh, A, dv = _check_fusion(q, k, v, dev)
    _check("weights", weights, torch.float32, (B, nh, Ta, Tv), dev)
    _check("dctx", dctx, torch.bfloat16, (B, Ta, nh, dv), dev)
    lib = _load()
    dsc = torch.empty((B, nh, Ta, Tv), dtype=torch.bfloat16, device=dev)
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dvv = torch.empty_like(v)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.avsr_fusion_attn_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), weights.data_ptr(), dctx.data_ptr(),
        dsc.data_ptr(), dq.data_ptr(), dk.data_ptr(), dvv.data_ptr(),
        B, Ta, Tv, nh, A, dv, stream)
    _raise_on(err, "fusion_attention_bwd launch")
    LAUNCHES["fusion_attention_bwd"] += 1
    return dq, dk, dvv

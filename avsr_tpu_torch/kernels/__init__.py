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
of the wrappers in ``ops/rnn.py``, ``ops/audio_features.py``,
``ops/attention.py``, ``models/fusion.py``, ``models/transformer_decoder.py``,
``models/transformer.py`` and ``decode/beam.py``; each one checks its tensors, allocates the outputs
and scratch with ``torch.empty`` / ``torch.zeros``, launches on the current
stream, raises on a nonzero CUDA status, and adds one to its entry of
``LAUNCHES``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

# Launch counts of each kernel wrapper: +1 per wrapper call that launched
# its kernel (one call may issue several grid launches, e.g. one per step).
# The LSTM kernels count a one-direction scan (G = 1, K2) apart from the
# direction-fused one (K1), and a scan under a recurrent-dropout mask
# (``*_rd_*``, train mode) apart from an unmasked one; the GRU scan (K12)
# counts G = 1 apart (``gru_scan_uni_*``), and the LN-LSTM scan (K13) both
# (``ln_lstm_scan[_uni][_rd]_*``), each on its cluster route; their other
# routes (other widths) count apart, whatever G and the mask:
# ``gru_scan_step_*`` (K12's per-step kernels) and ``ln_lstm_scan_block_*``
# (K13's block kernel); the Bahdanau read kernels count a Luong (dot
# score) read apart from an additive one.  K10's backward counts its
# per-step kernel per step (``*_attend_bwd``) and the memory's sums per
# loop (``*_attend_sums``).  K9's forward counts the pass over time
# (``conformer_conv_fwd``) apart from the tiles (``conformer_conv_fwd_tiles``,
# other shapes).  K10's forward counts the grouped read
# (``*_attend_grouped``), the row read (``*_attend_row``) and the general
# kernel (``*_attend``) apart.  K3 counts the frontend's option instances
# (spectrogram, no deltas, global or no normalization) apart from the
# presets' log-mel one.  The fp32 policy's instances (K1's per-step
# kernels, the CUDA-core attention family for K4 and K5, K6's general
# kernel, K8's per-step kernels and K10's general kernel, per-step backward
# and CUDA-core sums) count apart, as ``*_f32*``.
LAUNCHES: Dict[str, int] = {
    "lstm_scan_fwd": 0, "lstm_scan_bwd": 0, "lstm_scan_uni_fwd": 0, "lstm_scan_uni_bwd": 0,
    "lstm_scan_rd_fwd": 0, "lstm_scan_rd_bwd": 0, "lstm_scan_uni_rd_fwd": 0,
    "lstm_scan_uni_rd_bwd": 0,
    "gru_scan_fwd": 0, "gru_scan_bwd": 0, "gru_scan_uni_fwd": 0, "gru_scan_uni_bwd": 0,
    "gru_scan_step_fwd": 0, "gru_scan_step_bwd": 0,
    "ln_lstm_scan_fwd": 0, "ln_lstm_scan_bwd": 0, "ln_lstm_scan_uni_fwd": 0,
    "ln_lstm_scan_uni_bwd": 0, "ln_lstm_scan_rd_fwd": 0, "ln_lstm_scan_rd_bwd": 0,
    "ln_lstm_scan_uni_rd_fwd": 0, "ln_lstm_scan_uni_rd_bwd": 0,
    "ln_lstm_scan_block_fwd": 0, "ln_lstm_scan_block_bwd": 0,
    "logmel_post_dft": 0, "logmel_post_dft_options": 0,
    "fusion_attention_fwd": 0, "fusion_attention_bwd": 0,
    "decoder_attention_fwd": 0, "decoder_attention_bwd": 0,
    "decode_attention": 0, "beam_step": 0, "av_align_scan": 0, "av_align_scan_bwd": 0,
    "bahdanau_attend": 0, "bahdanau_attend_grouped": 0, "bahdanau_attend_row": 0,
    "bahdanau_attend_bwd": 0, "bahdanau_attend_sums": 0, "av_align_scan_luong": 0,
    "av_align_scan_luong_bwd": 0, "luong_attend": 0, "luong_attend_grouped": 0,
    "luong_attend_row": 0, "luong_attend_bwd": 0, "luong_attend_sums": 0,
    "encoder_attention_fwd": 0, "encoder_attention_bwd": 0, "conformer_conv_fwd": 0,
    "conformer_conv_fwd_tiles": 0, "conformer_conv_bwd": 0,
    "lstm_scan_f32_fwd": 0, "lstm_scan_f32_bwd": 0, "fusion_attention_f32_fwd": 0,
    "fusion_attention_f32_bwd": 0, "decoder_attention_f32_fwd": 0,
    "decoder_attention_f32_bwd": 0, "decode_attention_f32": 0, "av_align_scan_f32": 0,
    "av_align_scan_f32_bwd": 0, "bahdanau_attend_f32": 0, "bahdanau_attend_f32_bwd": 0,
    "bahdanau_attend_f32_sums": 0,
}

LSTM_UNIT_TILE = 16  # hidden units per block of the per-step LSTM kernels (UT in the source)
LSTM_ROW_TILE = 16   # batch rows per block of the per-step LSTM kernels (BT in the source)
LSTM_CLUSTER = 8     # CTAs per cluster of the cluster LSTM kernels (C in lstm_cluster.cuh)
LSTM_CLUSTER_ROWS = 16  # batch rows per cluster (BR in lstm_cluster.cuh)
ALIGN_CLUSTER = 16   # CTAs per cluster of K8's cluster kernels (C in av_align_fwd/bwd.cuh)
# video frames the fusion kernels (K4, K8) take: the largest bucket's video
# capacity, ceil(1600 * 25 / 100) + 1 (``data/loader.py``'s bucket shapes;
# every preset's last audio boundary is 1600 frames), one past 16 s at 25 fps
FUSION_MAX_TV = 401
ATTEND_MAX_S = 531   # steps K10, K11 and K4 (T_a) take: the audio steps of 16 s, (1598 - 8) // 3 + 1
CONV_MAX_D = 1024    # channels K9 takes: one channel pair per thread, 512 threads at most
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
    compile_flags = [f for f in NVCC_FLAGS if f != "-shared"] + ["-Xptxas", "-v"]
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
            else:
                _ptxas_log(out, src.stem).write_text(err)
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


def _ptxas_log(lib: Path, stem: str) -> Path:
    return lib.with_name(f"{lib.stem}.{stem}.ptxas.txt")


def ptxas_report(stem: str) -> Dict[str, Dict[str, int]]:
    """Per kernel of ``csrc/<stem>.cu`` (mangled name -> registers, spill
    stores and spill loads in bytes), from ``ptxas -v`` at the build of the
    current library."""
    report: Dict[str, Dict[str, int]] = {}
    name = None
    for line in _ptxas_log(build(), stem).read_text().splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
            report[name] = {"registers": 0, "spill_stores": 0, "spill_loads": 0}
        elif name and "spill stores" in line:
            parts = line.replace(",", " ").split()
            report[name]["spill_stores"] = int(parts[parts.index("spill") - 2])
            report[name]["spill_loads"] = int(parts[-4])
        elif name and "Used" in line and "registers" in line:
            parts = line.replace(",", " ").split()
            report[name]["registers"] = int(parts[parts.index("registers") - 1])
    return report


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.avsr_lstm_scan_fwd.argtypes = [p] * 10 + [i] * 5 + [p]
        lib.avsr_lstm_scan_fwd.restype = i
        lib.avsr_lstm_scan_bwd.argtypes = [p] * 15 + [i] * 5 + [p]
        lib.avsr_lstm_scan_bwd.restype = i
        lib.avsr_lstm_scan_fwd_f32.argtypes = [p] * 9 + [i] * 4 + [p]
        lib.avsr_lstm_scan_fwd_f32.restype = i
        lib.avsr_lstm_scan_bwd_f32.argtypes = [p] * 14 + [i] * 4 + [p]
        lib.avsr_lstm_scan_bwd_f32.restype = i
        lib.avsr_gru_step_smem.argtypes = [i, i]
        lib.avsr_gru_step_smem.restype = ctypes.c_longlong
        lib.avsr_gru_scan_fwd.argtypes = [p] * 7 + [i] * 4 + [p]
        lib.avsr_gru_scan_fwd.restype = i
        lib.avsr_gru_scan_bwd.argtypes = [p] * 13 + [i] * 4 + [p]
        lib.avsr_gru_scan_bwd.restype = i
        lib.avsr_gru_cluster_smem.argtypes = [i, i]
        lib.avsr_gru_cluster_smem.restype = ctypes.c_longlong
        lib.avsr_gru_cluster_max_active.argtypes = [i, i]
        lib.avsr_gru_cluster_max_active.restype = i
        lib.avsr_gru_cluster_fwd.argtypes = [p] * 7 + [i] * 4 + [p]
        lib.avsr_gru_cluster_fwd.restype = i
        lib.avsr_gru_cluster_bwd.argtypes = [p] * 12 + [i] * 4 + [p]
        lib.avsr_gru_cluster_bwd.restype = i
        lib.avsr_ln_lstm_smem.argtypes = [i, i]
        lib.avsr_ln_lstm_smem.restype = ctypes.c_longlong
        lib.avsr_ln_lstm_scan_fwd.argtypes = [p] * 14 + [i] * 4 + [p]
        lib.avsr_ln_lstm_scan_fwd.restype = i
        lib.avsr_ln_lstm_scan_bwd.argtypes = [p] * 15 + [i] * 4 + [p]
        lib.avsr_ln_lstm_scan_bwd.restype = i
        lib.avsr_ln_lstm_cluster_smem.argtypes = [i, i]
        lib.avsr_ln_lstm_cluster_smem.restype = ctypes.c_longlong
        lib.avsr_ln_lstm_cluster_max_active.argtypes = [i, i]
        lib.avsr_ln_lstm_cluster_max_active.restype = i
        lib.avsr_ln_lstm_cluster_fwd.argtypes = [p] * 14 + [i] * 4 + [p]
        lib.avsr_ln_lstm_cluster_fwd.restype = i
        lib.avsr_ln_lstm_cluster_bwd.argtypes = [p] * 16 + [i] * 4 + [p]
        lib.avsr_ln_lstm_cluster_bwd.restype = i
        lib.avsr_lstm_cluster_smem.argtypes = [i, i]
        lib.avsr_lstm_cluster_smem.restype = ctypes.c_longlong
        lib.avsr_lstm_cluster_max_active.argtypes = [i, i]
        lib.avsr_lstm_cluster_max_active.restype = i
        lib.avsr_fusion_attn_fwd.argtypes = [p] * 8 + [i] * 6 + [p]
        lib.avsr_fusion_attn_fwd.restype = i
        lib.avsr_fusion_attn_bwd.argtypes = [p] * 11 + [i] * 6 + [p]
        lib.avsr_fusion_attn_bwd.restype = i
        lib.avsr_logmel_post_dft.argtypes = [p] * 10 + [i] * 10 + [f] + [i] * 3 + [p]
        lib.avsr_logmel_post_dft.restype = i
        lib.avsr_logmel_writer_smem.argtypes = [i] * 6
        lib.avsr_logmel_writer_smem.restype = ctypes.c_longlong
        lib.avsr_fusion_attn_core_fwd.argtypes = [p] * 6 + [i] * 6 + [p]
        lib.avsr_fusion_attn_core_fwd.restype = i
        lib.avsr_fusion_attn_core_fwd_f32.argtypes = [p] * 6 + [i] * 6 + [p]
        lib.avsr_fusion_attn_core_fwd_f32.restype = i
        lib.avsr_attn_core_smem.argtypes = [i, i, i, i, i]
        lib.avsr_attn_core_smem.restype = ctypes.c_longlong
        lib.avsr_decoder_attn_fwd.argtypes = [p] * 7 + [i] * 6 + [p]
        lib.avsr_decoder_attn_fwd.restype = i
        lib.avsr_decoder_attn_bwd.argtypes = [p] * 11 + [i] * 6 + [p]
        lib.avsr_decoder_attn_bwd.restype = i
        lib.avsr_decoder_cross_stream_fwd.argtypes = [p] * 7 + [i] * 4 + [p]
        lib.avsr_decoder_cross_stream_fwd.restype = i
        lib.avsr_decoder_cross_stream_bwd.argtypes = [p] * 11 + [i] * 4 + [p]
        lib.avsr_decoder_cross_stream_bwd.restype = i
        lib.avsr_decoder_cross_fwd_strips.argtypes = [i, i]
        lib.avsr_decoder_cross_fwd_strips.restype = i
        lib.avsr_decoder_cross_fwd_smem.argtypes = [i, i, i]
        lib.avsr_decoder_cross_fwd_smem.restype = ctypes.c_longlong
        lib.avsr_decoder_cross_bwd_smem.argtypes = [i]
        lib.avsr_decoder_cross_bwd_smem.restype = ctypes.c_longlong
        lib.avsr_decoder_attn_core_fwd.argtypes = [p] * 6 + [i] * 6 + [p]
        lib.avsr_decoder_attn_core_fwd.restype = i
        lib.avsr_decoder_attn_core_fwd_f32.argtypes = [p] * 6 + [i] * 6 + [p]
        lib.avsr_decoder_attn_core_fwd_f32.restype = i
        lib.avsr_attn_core_bwd.argtypes = [p] * 9 + [i] * 6 + [p]
        lib.avsr_attn_core_bwd.restype = i
        lib.avsr_attn_core_bwd_f32.argtypes = [p] * 9 + [i] * 6 + [p]
        lib.avsr_attn_core_bwd_f32.restype = i
        lib.avsr_decode_attn.argtypes = [p] * 5 + [i] * 7 + [p]
        lib.avsr_decode_attn.restype = i
        lib.avsr_decode_attn_f32.argtypes = [p] * 5 + [i] * 7 + [p]
        lib.avsr_decode_attn_f32.restype = i
        lib.avsr_decode_attn_rows.argtypes = [p] * 4 + [i] * 5 + [p]
        lib.avsr_decode_attn_rows.restype = i
        lib.avsr_decode_rows_smem.argtypes = [i, i]
        lib.avsr_decode_rows_smem.restype = ctypes.c_longlong
        lib.avsr_decode_attn_grouped.argtypes = [p] * 5 + [i] * 7 + [p]
        lib.avsr_decode_attn_grouped.restype = i
        lib.avsr_decode_grouped_smem.argtypes = [i] * 4
        lib.avsr_decode_grouped_smem.restype = ctypes.c_longlong
        lib.avsr_beam_step.argtypes = [ctypes.POINTER(_BeamStepArgs), p, i, i, p]
        lib.avsr_beam_step.restype = i
        lib.avsr_beam_step_smem.argtypes = [i, i]
        lib.avsr_beam_step_smem.restype = ctypes.c_longlong
        lib.avsr_launch_floor.argtypes = [p]
        lib.avsr_launch_floor.restype = i
        lib.avsr_av_align_smem.argtypes = [i, i, i, i, i]
        lib.avsr_av_align_smem.restype = ctypes.c_longlong
        lib.avsr_av_align_scan.argtypes = [p] * 21 + [i] * 8 + [p]
        lib.avsr_av_align_scan.restype = i
        lib.avsr_av_align_fwd_smem.argtypes = [i] * 6
        lib.avsr_av_align_fwd_smem.restype = ctypes.c_longlong
        lib.avsr_av_align_fwd_max_active.argtypes = [i] * 7
        lib.avsr_av_align_fwd_max_active.restype = i
        lib.avsr_av_align_fwd.argtypes = [p] * 19 + [i] * 9 + [p]
        lib.avsr_av_align_fwd.restype = i
        lib.avsr_av_align_bwd_smem.argtypes = [i] * 7
        lib.avsr_av_align_bwd_smem.restype = ctypes.c_longlong
        lib.avsr_av_align_bwd_max_active.argtypes = [i] * 7
        lib.avsr_av_align_bwd_max_active.restype = i
        lib.avsr_av_align_bwd_prep.argtypes = [p] * 10 + [i] * 6 + [p]
        lib.avsr_av_align_bwd_prep.restype = i
        lib.avsr_av_align_bwd_scan.argtypes = [p] * 20 + [i] * 9 + [p]
        lib.avsr_av_align_bwd_scan.restype = i
        lib.avsr_av_align_bwd_sums.argtypes = [p] * 9 + [i] * 6 + [p]
        lib.avsr_av_align_bwd_sums.restype = i
        lib.avsr_av_align_step_bwd_prep.argtypes = [p] * 9 + [i] * 4 + [p]
        lib.avsr_av_align_step_bwd_prep.restype = i
        lib.avsr_av_align_step_bwd_scan.argtypes = [p] * 21 + [i] * 8 + [p]
        lib.avsr_av_align_step_bwd_scan.restype = i
        lib.avsr_av_align_scan_f32.argtypes = [p] * 21 + [i] * 7 + [p]
        lib.avsr_av_align_scan_f32.restype = i
        lib.avsr_av_align_f32_smem.argtypes = [i] * 5
        lib.avsr_av_align_f32_smem.restype = ctypes.c_longlong
        lib.avsr_av_align_step_bwd_prep_f32.argtypes = [p] * 9 + [i] * 4 + [p]
        lib.avsr_av_align_step_bwd_prep_f32.restype = i
        lib.avsr_av_align_step_bwd_scan_f32.argtypes = [p] * 21 + [i] * 7 + [p]
        lib.avsr_av_align_step_bwd_scan_f32.restype = i
        lib.avsr_bahdanau_attend_f32.argtypes = [p] * 9 + [i] * 6 + [p]
        lib.avsr_bahdanau_attend_f32.restype = i
        lib.avsr_attend_step_bwd_f32.argtypes = [p] * 13 + [i] * 5 + [p]
        lib.avsr_attend_step_bwd_f32.restype = i
        lib.avsr_attend_loop_sums_f32.argtypes = [p] * 8 + [i] * 5 + [p]
        lib.avsr_attend_loop_sums_f32.restype = i
        lib.avsr_bahdanau_smem.argtypes = [i, i, i]
        lib.avsr_bahdanau_smem.restype = ctypes.c_longlong
        lib.avsr_bahdanau_attend.argtypes = [p] * 9 + [i] * 7 + [p]
        lib.avsr_bahdanau_attend.restype = i
        lib.avsr_attend_row.argtypes = [p] * 9 + [i] * 7 + [p]
        lib.avsr_attend_row.restype = i
        lib.avsr_attend_row_smem.argtypes = [i] * 5
        lib.avsr_attend_row_smem.restype = ctypes.c_longlong
        lib.avsr_attend_row_max_active.argtypes = [i] * 5
        lib.avsr_attend_row_max_active.restype = i
        lib.avsr_attend_grouped.argtypes = [p] * 9 + [i] * 8 + [p]
        lib.avsr_attend_grouped.restype = i
        lib.avsr_attend_grouped_smem.argtypes = [i] * 7
        lib.avsr_attend_grouped_smem.restype = ctypes.c_longlong
        lib.avsr_attend_grouped_max_active.argtypes = [i] * 7
        lib.avsr_attend_grouped_max_active.restype = i
        lib.avsr_attend_step_bwd_smem.argtypes = [i] * 4
        lib.avsr_attend_step_bwd_smem.restype = ctypes.c_longlong
        lib.avsr_attend_step_bwd_max_active.argtypes = [i] * 5
        lib.avsr_attend_step_bwd_max_active.restype = i
        lib.avsr_attend_step_bwd.argtypes = [p] * 13 + [i] * 6 + [p]
        lib.avsr_attend_step_bwd.restype = i
        lib.avsr_attend_loop_sums.argtypes = [p] * 8 + [i] * 6 + [p]
        lib.avsr_attend_loop_sums.restype = i
        lib.avsr_encoder_attn_smem.argtypes = [i, i]
        lib.avsr_encoder_attn_smem.restype = ctypes.c_longlong
        lib.avsr_encoder_attn_fwd.argtypes = [p] * 5 + [i] * 4 + [p]
        lib.avsr_encoder_attn_fwd.restype = i
        lib.avsr_encoder_attn_bwd.argtypes = [p] * 7 + [i] * 4 + [p]
        lib.avsr_encoder_attn_bwd.restype = i
        lib.avsr_encoder_attn_core_fwd.argtypes = [p] * 4 + [i] * 4 + [p]
        lib.avsr_encoder_attn_core_fwd.restype = i
        lib.avsr_encoder_attn_core_bwd.argtypes = [p] * 5 + [i] * 4 + [p]
        lib.avsr_encoder_attn_core_bwd.restype = i
        lib.avsr_conformer_conv_smem.argtypes = [i, i]
        lib.avsr_conformer_conv_smem.restype = ctypes.c_longlong
        lib.avsr_conformer_conv.argtypes = [p] * 7 + [i] * 4 + [p]
        lib.avsr_conformer_conv.restype = i
        lib.avsr_conformer_conv_bwd_parts.argtypes = [i, i]
        lib.avsr_conformer_conv_bwd_parts.restype = i
        lib.avsr_conformer_conv_bwd.argtypes = [p] * 11 + [i] * 4 + [p]
        lib.avsr_conformer_conv_bwd.restype = i
        lib.avsr_conformer_conv_bwd_fused_smem.argtypes = [i]
        lib.avsr_conformer_conv_bwd_fused_smem.restype = ctypes.c_longlong
        lib.avsr_conformer_conv_bwd_fused.argtypes = [p] * 11 + [i] * 6 + [p]
        lib.avsr_conformer_conv_bwd_fused.restype = i
        lib.avsr_conformer_conv_fwd_fused_smem.argtypes = [i]
        lib.avsr_conformer_conv_fwd_fused_smem.restype = ctypes.c_longlong
        lib.avsr_conformer_conv_fwd_fused.argtypes = [p] * 8 + [i] * 6 + [p]
        lib.avsr_conformer_conv_fwd_fused.restype = i
        lib.avsr_conformer_conv_fwd_fused_occupancy.argtypes = [i]
        lib.avsr_conformer_conv_fwd_fused_occupancy.restype = i
        _lib = lib
    return _lib


def _check(name: str, x: torch.Tensor, dtype: torch.dtype, shape: Tuple,
           device: torch.device, align: int = 16) -> None:
    if x.device != device or x.device.type != "cuda":
        raise ValueError(f"{name}: expected a tensor on {device}, got {x.device}")
    if x.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if x.data_ptr() % align:
        raise ValueError(f"{name}: expected a {align}-byte aligned tensor")


def _ptr(x: Optional[torch.Tensor]) -> Optional[int]:
    return None if x is None else x.data_ptr()


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def tile_lstm_weights(wh: torch.Tensor) -> torch.Tensor:
    """[G, K, 4H] -> [G, H/UT, K, UT, 4], the layout the per-step LSTM
    kernels and K8's per-step route read (K = H for Wh, K = the context
    width for K8's ``ctx_proj``): each
    block's weight slice is contiguous and the four gate weights of one
    hidden unit are adjacent (``csrc/lstm_scan.cu``, ``csrc/av_align_scan.cu``)."""
    G, K, H4 = wh.shape
    nt = H4 // 4 // LSTM_UNIT_TILE
    return wh.view(G, K, 4, nt, LSTM_UNIT_TILE).permute(0, 3, 1, 4, 2).contiguous()


def tile_lstm_weights_t(wh: torch.Tensor) -> torch.Tensor:
    """[G, H, 4H] -> [G, H/UT, H, UT, 4], the layout the LSTM backward's dh
    product reads: [g, t, kq, u, j] = Wh[g, t*UT + u, 4*kq + j], so each
    block's rows of Wh are one contiguous run and a thread reads four
    consecutive k of its unit as one 8-byte load (``csrc/lstm_scan.cu``)."""
    G, H, _ = wh.shape
    nt = H // LSTM_UNIT_TILE
    return wh.view(G, nt, LSTM_UNIT_TILE, H, 4).permute(0, 1, 3, 2, 4).contiguous()


def lstm_cluster_smem(H: int, backward: bool) -> int:
    """Shared memory of one CTA of the cluster LSTM kernels at width H
    (``csrc/lstm_cluster.cuh`` ``Shape``): the resident Wh slice (H*H
    bytes); the forward's two bf16 h tiles (64 H); the backward's one
    h_res tile (32 H), bf16 dgates rows (16 H) and two slots of fp32 dh
    partials (128 H); two 8-byte mbarriers."""
    return H * H + (176 * H if backward else 64 * H) + 16


def lstm_step_smem(H: int, backward: bool, elem_bytes: int = 2) -> int:
    """Shared memory of a block of the per-step LSTM kernels at width H with
    ``elem_bytes`` operands (``csrc/lstm_scan.cu``): the forward's Wh slice
    [H, UT, 4] and h rows [BT, H]; the backward's two slices, the dgates
    rows [BT, 4H], the h_res rows and the db partials [BT, 4, UT] fp32."""
    tile, rows = H * LSTM_UNIT_TILE * 4, LSTM_ROW_TILE * H
    if not backward:
        return (tile + rows) * elem_bytes
    return (2 * tile + 5 * rows) * elem_bytes + LSTM_ROW_TILE * 4 * LSTM_UNIT_TILE * 4


def lstm_family(G: int, B: int, H: int, dtype: torch.dtype = torch.bfloat16) -> str:
    """The kernels that run an LSTM scan of G directions, B rows and width
    H with ``dtype`` operands: "cluster", one persistent launch of
    thread-block clusters per layer call (``csrc/lstm_cluster.cuh``), where
    the operands are bf16 and H is a multiple of 64 from 128 (8 units a
    warp, 8 swizzle chunks a dgates row) whose backward fits a CTA's shared
    memory (H <= 384; every preset has H = 256); else "step", the per-step
    kernels (``csrc/lstm_scan.cu``), which take any multiple of 16 in bf16
    and, in fp32 (the fp32 policy's instance), the multiples of 16 whose
    backward fits a block (H <= 272).  Chosen by shape and type alone, never
    after a failure; other shapes raise."""
    if G < 1 or B < 1 or H < LSTM_UNIT_TILE or H % LSTM_UNIT_TILE:
        raise ValueError(f"lstm scan: G={G}, B={B}, H={H}; the kernels take G, B >= 1 and H a "
                         f"positive multiple of {LSTM_UNIT_TILE}")
    if dtype == torch.float32:
        if lstm_step_smem(H, backward=True, elem_bytes=4) > SMEM_LIMIT:
            raise ValueError(f"lstm scan: the fp32 per-step kernels stage a block's fp32 Wh "
                             f"slices whole; H={H} needs {lstm_step_smem(H, True, 4)} bytes "
                             f"of shared memory (limit {SMEM_LIMIT})")
        return "step"
    if dtype != torch.bfloat16:
        raise ValueError(f"lstm scan: the kernels take bf16 or fp32 operands, got {dtype}")
    if H % 64 == 0 and H >= 128 and lstm_cluster_smem(H, backward=True) <= SMEM_LIMIT:
        return "cluster"
    return "step"


def cluster_lstm_weights(wh: torch.Tensor) -> torch.Tensor:
    """[G, H, 4H] -> [G, 8, H/64, 4, 8, H], the layout the cluster LSTM
    kernels read: [g, r, w, q, j, k] = Wh[g, k, q*H + r*H/8 + 8*w + j], so
    CTA r's slice (its H/8 units' four gates over all H inputs) is one
    contiguous [H/2, H] run, column-major, whose rows are warp w's 8 units
    gate by gate (``csrc/lstm_cluster.cuh``)."""
    G, H, _ = wh.shape
    return wh.view(G, H, 4, LSTM_CLUSTER, H // 64, 8).permute(0, 3, 4, 2, 5, 1).contiguous()


def _check_lstm(xw, wh, b, mask, T, G, B, H, dev, rd=None):
    """The operands of K1 / K2 in bf16 (the bf16 policy) or fp32 (the fp32
    policy: K1 only, G = 2 without a recurrent-dropout mask; the other
    fp32 instances are still to be ported) -> (family, dtype)."""
    dt = xw.dtype
    if dt == torch.float32 and (G != 2 or rd is not None):
        raise ValueError(f"lstm scan: the fp32 instance runs K1 (G = 2) without a recurrent-"
                         f"dropout mask; G={G}, mask {rd is not None} is still to be ported")
    _check("xw", xw, dt, (T, G, B, 4 * H), dev)
    _check("wh", wh, dt, (G, H, 4 * H), dev)
    _check("b", b, torch.float32, (G, 4 * H), dev)
    _check("mask", mask, torch.float32, (T, G, B), dev)
    return lstm_family(G, B, H, dt), dt


def _lstm_counter(name: str, G: int, rd=None, dtype: torch.dtype = torch.bfloat16) -> str:
    """``lstm_scan_fwd`` -> ``lstm_scan[_uni][_rd]_fwd``: G = 1 (K2) and a
    recurrent-dropout mask counted apart; ``lstm_scan_f32_fwd`` for the fp32
    policy's instance."""
    stem, kind = name.rsplit("_", 1)
    if dtype == torch.float32:
        return f"{stem}_f32_{kind}"
    return stem + ("_uni" if G == 1 else "") + ("_rd" if rd is not None else "") + "_" + kind


def _check_rd(rd, G, B, H, dev) -> None:
    if rd is not None:
        _check("rd", rd, torch.float32, (G, B, H), dev)


def lstm_scan_fwd(wh, b, xw, mask, h0, c0, *, save: bool = False, rd=None):
    """K1: direction-batched masked LSTM recurrence, forward (CUDA); at
    G = 1, K2 (one direction), counted as ``lstm_scan_uni_fwd``.

    wh [G,H,4H] bf16, b [G,4H] f32, xw [T,G,B,4H] bf16, mask [T,G,B] f32,
    h0/c0 [G,B,H] f32 -> (ys [T,G,B,H] bf16, hT [G,B,H] f32, cT f32,
    h_res, c_res), the last two when ``save`` (the backward's residuals:
    the bf16 [T,G,B,H] operand of each step's recurrent product and the
    carry c entering it), else None.  ``rd`` [G,B,H] f32 is the recurrent
    dropout mask (the operand becomes bf16(h * rd)); a masked call counts
    as ``lstm_scan[_uni]_rd_fwd``.  Runs on the family ``lstm_family``
    names: one cluster launch, or one launch per step.  With wh and xw in
    fp32 (the fp32 policy: G = 2, no mask) the per-step kernels' fp32
    instance runs and ys, h_res and c_res are fp32, counted as
    ``lstm_scan_f32_fwd``.
    """
    T, G, B, H4 = xw.shape
    H = H4 // 4
    dev = xw.device
    family, dt = _check_lstm(xw, wh, b, mask, T, G, B, H, dev, rd)
    _check("h0", h0, torch.float32, (G, B, H), dev)
    _check("c0", c0, torch.float32, (G, B, H), dev)
    _check_rd(rd, G, B, H, dev)
    lib = _load()
    cluster = family == "cluster"
    w = cluster_lstm_weights(wh) if cluster else tile_lstm_weights(wh)
    hbuf = torch.empty((2, G, B, H), dtype=torch.float32, device=dev)
    hbuf[0].copy_(h0)
    c = c0.clone()
    ys = torch.empty((T, G, B, H), dtype=dt, device=dev)
    h_res = c_res = None
    if save:
        h_res = torch.empty((T, G, B, H), dtype=dt, device=dev)
        c_res = torch.empty((T, G, B, H), dtype=dt, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    common = (w.data_ptr(), b.data_ptr(), xw.data_ptr(), mask.data_ptr(), hbuf.data_ptr(),
              c.data_ptr(), ys.data_ptr(), _ptr(h_res), _ptr(c_res))
    if dt == torch.float32:
        err = lib.avsr_lstm_scan_fwd_f32(*common, T, G, B, H, stream)
    else:
        err = lib.avsr_lstm_scan_fwd(*common, _ptr(rd), T, G, B, H, int(cluster), stream)
    _raise_on(err, "lstm_scan_fwd launch")
    LAUNCHES[_lstm_counter("lstm_scan_fwd", G, rd, dt)] += 1
    return ys, hbuf[T % 2], c, h_res, c_res


def lstm_scan_bwd(wh, b, xw, mask, h_res, c_res, dys, dhT, dcT, *, rd=None):
    """K1: the reverse scan of the hand-written VJP (CUDA); at G = 1, K2's,
    counted as ``lstm_scan_uni_bwd``.

    Same operands as the forward plus the bf16 residuals h_res/c_res
    [T,G,B,H] and the cotangents dys [T,G,B,H] bf16, dhT/dcT [G,B,H] f32
    -> (dxw [T,G,B,4H] bf16 (= dgates), db [G,4H] f32, dh0, dc0 [G,B,H]
    f32).  dWh is one product over all steps, left to the caller.  With
    the forward's mask ``rd`` the cotangent of each product's operand is
    scaled by it (counted as ``lstm_scan[_uni]_rd_bwd``).  The cluster
    family is one cluster launch and a row-tile sum of db; the per-step
    family one launch per step and a final one.  In fp32 (the fp32
    policy's instance, ``lstm_scan_f32_bwd``) the residuals, dys and dxw
    are fp32.
    """
    T, G, B, H4 = xw.shape
    H = H4 // 4
    dev = xw.device
    family, dt = _check_lstm(xw, wh, b, mask, T, G, B, H, dev, rd)
    for name, x in (("h_res", h_res), ("c_res", c_res), ("dys", dys)):
        _check(name, x, dt, (T, G, B, H), dev)
    _check("dhT", dhT, torch.float32, (G, B, H), dev)
    _check("dcT", dcT, torch.float32, (G, B, H), dev)
    _check_rd(rd, G, B, H, dev)
    if T < 1:
        raise ValueError("lstm_scan_bwd: needs at least one step")
    lib = _load()
    dc = dcT.clone()
    if family == "cluster":
        w, wT, dh_dir = cluster_lstm_weights(wh), None, dhT
        db_part = torch.empty((G, -(-B // LSTM_CLUSTER_ROWS), 4 * H), dtype=torch.float32,
                              device=dev)
    else:
        w, wT, dh_dir = tile_lstm_weights(wh), tile_lstm_weights_t(wh), dhT.clone()
        db_part = torch.zeros((G, -(-B // LSTM_ROW_TILE), 4 * H), dtype=torch.float32,
                              device=dev)
    dxw = torch.empty((T, G, B, 4 * H), dtype=dt, device=dev)
    dh0 = torch.empty((G, B, H), dtype=torch.float32, device=dev)
    db = torch.empty((G, 4 * H), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    common = (w.data_ptr(), _ptr(wT), b.data_ptr(), xw.data_ptr(),
              mask.data_ptr(), h_res.data_ptr(), c_res.data_ptr(), dys.data_ptr(),
              dh_dir.data_ptr(), dc.data_ptr(), db_part.data_ptr(), dxw.data_ptr(),
              dh0.data_ptr(), db.data_ptr())
    if dt == torch.float32:
        err = lib.avsr_lstm_scan_bwd_f32(*common, T, G, B, H, stream)
    else:
        err = lib.avsr_lstm_scan_bwd(*common, _ptr(rd), T, G, B, H, int(family == "cluster"),
                                     stream)
    _raise_on(err, "lstm_scan_bwd launch")
    LAUNCHES[_lstm_counter("lstm_scan_bwd", G, rd, dt)] += 1
    return dxw, db, dh0, dc


def gru_step_smem(H: int, backward: bool) -> int:
    """Shared memory of one block of K12's step kernels at width H
    (``csrc/gru_scan.cu``): the forward's tiled Wh slice [H, 16, 4] and 16
    bf16 h rows (160 H bytes); the backward's 16 fp32 dhw rows [16, 3H], its
    fp32 db partials [16, 3, 16], the tiled Wh and Wh^T slices and 16 bf16
    h_res rows (448 H + 3072 bytes)."""
    return 448 * H + 3072 if backward else 160 * H


def _dz_pitch(ncol: int) -> int:
    """Columns of a row of the cluster backwards' bf16 cotangent tiles (DGP
    in the sources): the slice's columns rounded up to 64, 8 swizzle
    chunks."""
    return -(-ncol // 64) * 64


def gru_cluster_smem(H: int, backward: bool) -> int:
    """Shared memory of one CTA of K12's cluster kernels at width H
    (``csrc/gru_cluster.cuh`` ``Shape``): the resident Wh slice (3 H/8 x H
    bf16, 3 H^2 / 4 bytes); the forward's two bf16 h tiles (64 H); the
    backward's h_res tile (32 H), the hi and lo bf16 dhw tiles (64 DGP
    bytes) and two slots of fp32 dh partials (128 H); two 8-byte
    mbarriers."""
    w = 3 * H * H // 4
    if not backward:
        return w + 64 * H + 16
    return w + 32 * H + 64 * _dz_pitch(3 * H // LSTM_CLUSTER) + 128 * H + 16


def gru_family(G: int, B: int, H: int) -> str:
    """The kernels that run a GRU scan (K12) of G directions, B rows and
    width H: "cluster", one persistent launch of 8-CTA clusters a call
    (``csrc/gru_cluster.cuh``), where H is a multiple of 128 (8 units a
    warp; the slice's 3 H/8 columns in 16-column k-steps) whose backward
    fits a CTA's shared memory (H <= 384; every preset has H = 256); else
    "step", one launch a step (``csrc/gru_scan.cu``), where H is a multiple
    of 16 whose backward block fits (H <= 512).  Chosen by shape alone,
    never after a failure; other shapes raise."""
    if G < 1 or B < 1 or H < LSTM_UNIT_TILE or H % LSTM_UNIT_TILE \
            or gru_step_smem(H, backward=True) > SMEM_LIMIT:
        raise ValueError(f"gru scan: G={G}, B={B}, H={H}; the kernels take G, B >= 1 and H a "
                         f"positive multiple of {LSTM_UNIT_TILE} up to 512")
    if H % 128 == 0 and gru_cluster_smem(H, backward=True) <= SMEM_LIMIT:
        return "cluster"
    return "step"


def cluster_gru_weights(wh: torch.Tensor) -> torch.Tensor:
    """[G, H, 3H] -> [G, 8, H/64, 3, 8, H], the layout K12's cluster kernels
    read: [g, r, w, q, j, k] = Wh[g, k, q*H + r*H/8 + 8*w + j], so CTA r's
    slice (its H/8 units' r, z and n gates over all H inputs) is one
    contiguous [3H/8, H] run, column-major, whose rows are warp w's 8 units
    gate by gate (``csrc/gru_cluster.cuh``)."""
    G, H, _ = wh.shape
    return wh.view(G, H, 3, LSTM_CLUSTER, H // 64, 8).permute(0, 3, 4, 2, 5, 1).contiguous()


def tile_gru_weights(wh: torch.Tensor) -> torch.Tensor:
    """[G, H, 3H] -> [G, H/UT, H, UT, 4], K1's per-step layout with the
    fourth gate slot zero: a thread reads its unit's r, z, n weights for
    one k as one 8-byte load (``csrc/gru_scan.cu``)."""
    G, H, _ = wh.shape
    return tile_lstm_weights(torch.cat([wh, wh.new_zeros((G, H, H))], dim=-1))


def tile_gru_weights_t(wh: torch.Tensor) -> torch.Tensor:
    """[G, H, 3H] -> [G, H/UT, 3H/4, UT, 4]: [g, t, kq, u, j] = Wh[g, t*UT
    + u, 4*kq + j], the layout the backward's dh product reads."""
    G, H, H3 = wh.shape
    nt = H // LSTM_UNIT_TILE
    return wh.view(G, nt, LSTM_UNIT_TILE, H3 // 4, 4).permute(0, 1, 3, 2, 4).contiguous()


def _check_gru(xw, wh, b, mask, T, G, B, H, dev):
    _check("xw", xw, torch.bfloat16, (T, G, B, 3 * H), dev)
    _check("wh", wh, torch.bfloat16, (G, H, 3 * H), dev)
    _check("b", b, torch.float32, (G, 3 * H), dev)
    _check("mask", mask, torch.float32, (T, G, B), dev)
    return gru_family(G, B, H)


def gru_scan_fwd(wh, b, xw, mask, h0, *, save: bool = False):
    """K12: direction-batched masked GRU recurrence, forward (CUDA); at
    G = 1 counted as ``gru_scan_uni_fwd``.

    wh [G,H,3H] bf16, b [G,3H] f32, xw [T,G,B,3H] bf16, mask [T,G,B] f32,
    h0 [G,B,H] f32 -> (ys [T,G,B,H] bf16, hT [G,B,H] f32, h_res), h_res the
    bf16 [T,G,B,H] carries entering each step (the product's operand) when
    ``save``, else None.  Runs on the family ``gru_family`` names: one
    cluster launch, or one launch per step (counted as
    ``gru_scan_step_fwd``).
    """
    T, G, B, H3 = xw.shape
    H = H3 // 3
    dev = xw.device
    family = _check_gru(xw, wh, b, mask, T, G, B, H, dev)
    _check("h0", h0, torch.float32, (G, B, H), dev)
    lib = _load()
    hbuf = torch.empty((2, G, B, H), dtype=torch.float32, device=dev)
    hbuf[0].copy_(h0)
    ys = torch.empty((T, G, B, H), dtype=torch.bfloat16, device=dev)
    h_res = torch.empty((T, G, B, H), dtype=torch.bfloat16, device=dev) if save else None
    cluster = family == "cluster"
    w = cluster_gru_weights(wh) if cluster else tile_gru_weights(wh)
    stream = torch.cuda.current_stream(dev).cuda_stream
    launch = lib.avsr_gru_cluster_fwd if cluster else lib.avsr_gru_scan_fwd
    err = launch(w.data_ptr(), b.data_ptr(), xw.data_ptr(), mask.data_ptr(),
                 hbuf.data_ptr(), ys.data_ptr(), _ptr(h_res), T, G, B, H, stream)
    _raise_on(err, "gru_scan_fwd launch")
    LAUNCHES[("gru_scan_uni_fwd" if G == 1 else "gru_scan_fwd") if cluster
             else "gru_scan_step_fwd"] += 1
    return ys, hbuf[T % 2], h_res


def gru_scan_bwd(wh, b, xw, mask, h_res, dys, dhT):
    """K12: the reverse scan of the GRU's gradient (CUDA); at G = 1
    counted as ``gru_scan_uni_bwd``.

    Same operands as the forward plus its h_res [T,G,B,H] bf16 and the
    cotangents dys [T,G,B,H] bf16, dhT [G,B,H] f32 -> (dxw [T,G,B,3H] bf16,
    db [G,3H] f32, dh0 [G,B,H] f32, dhw [T,G,B,3H] f32: the cotangent of
    each step's recurrent product, whose n block is dn * r, so dWh =
    h_res^T dhw, one product over all steps, is the caller's).  The cluster
    family is one cluster launch and a row-tile sum of db; the per-step
    family one launch per step and a final one (counted as
    ``gru_scan_step_bwd``).
    """
    T, G, B, H3 = xw.shape
    H = H3 // 3
    dev = xw.device
    family = _check_gru(xw, wh, b, mask, T, G, B, H, dev)
    _check("h_res", h_res, torch.bfloat16, (T, G, B, H), dev)
    _check("dys", dys, torch.bfloat16, (T, G, B, H), dev)
    _check("dhT", dhT, torch.float32, (G, B, H), dev)
    if T < 1:
        raise ValueError("gru_scan_bwd: needs at least one step")
    lib = _load()
    dxw = torch.empty((T, G, B, H3), dtype=torch.bfloat16, device=dev)
    dhw = torch.empty((T, G, B, H3), dtype=torch.float32, device=dev)
    dh0 = torch.empty((G, B, H), dtype=torch.float32, device=dev)
    db = torch.empty((G, H3), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    if family == "cluster":
        w = cluster_gru_weights(wh)  # alive until the launches are queued
        db_part = torch.empty((G, -(-B // LSTM_CLUSTER_ROWS), H3), dtype=torch.float32,
                              device=dev)
        err = lib.avsr_gru_cluster_bwd(
            w.data_ptr(), b.data_ptr(), xw.data_ptr(), mask.data_ptr(), h_res.data_ptr(),
            dys.data_ptr(), dhT.data_ptr(), db_part.data_ptr(), dxw.data_ptr(), dhw.data_ptr(),
            dh0.data_ptr(), db.data_ptr(), T, G, B, H, stream)
        counter = "gru_scan_uni_bwd" if G == 1 else "gru_scan_bwd"
    else:
        dh_dir = dhT.clone()
        db_part = torch.zeros((G, -(-B // LSTM_ROW_TILE), H3), dtype=torch.float32, device=dev)
        w, wT = tile_gru_weights(wh), tile_gru_weights_t(wh)
        err = lib.avsr_gru_scan_bwd(
            w.data_ptr(), wT.data_ptr(), b.data_ptr(),
            xw.data_ptr(), mask.data_ptr(), h_res.data_ptr(), dys.data_ptr(), dh_dir.data_ptr(),
            db_part.data_ptr(), dxw.data_ptr(), dhw.data_ptr(), dh0.data_ptr(), db.data_ptr(),
            T, G, B, H, stream)
        counter = "gru_scan_step_bwd"
    _raise_on(err, "gru_scan_bwd launch")
    LAUNCHES[counter] += 1
    return dxw, db, dh0, dhw


LN_LSTM_MAX_H = 512  # two column quads a thread of 256 (NQ in ln_lstm_scan.cu)
LN_LSTM_ROWS = 4     # batch rows a block of K13 (BR in ln_lstm_scan.cu)


def ln_lstm_smem(H: int, backward: bool) -> int:
    """Shared memory of one block of K13 at width H (``csrc/ln_lstm_scan.cu``
    ``fwd_floats`` / ``bwd_floats``): the forward's operand, gates, carries
    and statistics, BR * (8H + 11) floats; the backward's normalised gates,
    their cotangents (and transposed), the saved carry, the cell's state and
    cotangents, BR * (17H + 21) floats."""
    return 4 * LN_LSTM_ROWS * ((17 * H + 21) if backward else (8 * H + 11))


LN_LSTM_NSTAT = 10  # a row-step's statistics the cluster backward reads (NSTAT)


def ln_lstm_cluster_smem(H: int, backward: bool) -> int:
    """Shared memory of one CTA of K13's cluster kernels at width H
    (``csrc/ln_lstm_cluster.cuh`` ``Shape``): K1's resident Wh slice (H*H
    bytes); the forward's two bf16 h tiles (64 H), the backward's hi and lo
    bf16 dz tiles (64 DGP bytes) and two slots of fp32 dh partials (128 H);
    the statistics' buffers, the warps' (mean, M2) or sums partials for 16
    rows x (4 gate blocks + the cell) and the 8 CTAs' (640 NW + 5120 bytes,
    NW = H/64 warps); four 8-byte mbarriers."""
    stat = 640 * (H // 64) + 5120 + 32
    if not backward:
        return H * H + 64 * H + stat
    return H * H + 64 * _dz_pitch(H // 2) + 128 * H + stat


def ln_lstm_family(G: int, B: int, H: int) -> str:
    """The kernels that run an LN-LSTM scan (K13) of G directions, B rows and
    width H: "cluster", one persistent launch of 8-CTA clusters a call
    (``csrc/ln_lstm_cluster.cuh``), where H is a multiple of 64 from 128
    whose backward fits a CTA's shared memory (H <= 384; every preset has H
    = 256); else "block", one persistent launch a call, a block a
    (direction, tile of ``LN_LSTM_ROWS`` rows) owning all 4H gate columns
    (``csrc/ln_lstm_scan.cu``), at every multiple of 4 up to
    ``LN_LSTM_MAX_H``.  Any T.  Chosen by shape alone, never after a
    failure; other shapes raise."""
    if G < 1 or B < 1 or not 4 <= H <= LN_LSTM_MAX_H or H % 4:
        raise ValueError(f"ln_lstm scan: G={G}, B={B}, H={H}; the kernel takes G, B >= 1 and "
                         f"H a multiple of 4 up to {LN_LSTM_MAX_H}")
    if H % 64 == 0 and H >= 128 and ln_lstm_cluster_smem(H, backward=True) <= SMEM_LIMIT:
        return "cluster"
    return "block"


def _check_ln_lstm(wh, b, lng, lncg, lncb, mask, T, G, B, H, dev):
    _check("wh", wh, torch.bfloat16, (G, H, 4 * H), dev)
    _check("b", b, torch.float32, (G, 4 * H), dev)
    _check("ln_gamma", lng, torch.float32, (G, 4 * H), dev)
    _check("ln_cell_gamma", lncg, torch.float32, (G, H), dev)
    _check("ln_cell_beta", lncb, torch.float32, (G, H), dev)
    _check("mask", mask, torch.float32, (T, G, B), dev)
    return ln_lstm_family(G, B, H)


def ln_lstm_scan_fwd(wh, b, lng, lncg, lncb, xw, mask, h0, c0, *, save: bool = False,
                     rd=None):
    """K13: direction-batched masked LN-LSTM recurrence, forward (CUDA), one
    launch; counted as ``ln_lstm_scan[_uni][_rd]_fwd`` (G = 1 and a
    recurrent-dropout mask apart).

    wh [G,H,4H] bf16, b / lng [G,4H] f32, lncg / lncb [G,H] f32, xw
    [T,G,B,4H] bf16, mask [T,G,B] f32, h0 / c0 [G,B,H] f32, rd [G,B,H] f32 or
    None -> (ys [T,G,B,H] bf16, hT, cT [G,B,H] f32, h_res, c_res, z): when
    ``save``, each step's bf16 operand bf16(h * rd) and the fp32 carry c
    entering it [T,G,B,H] and its fp32 pre-LN gates [T,G,B,4H], else None.
    Runs on the family ``ln_lstm_family`` names (the block route counted as
    ``ln_lstm_scan_block_fwd``).
    """
    T, G, B, H4 = xw.shape
    H = H4 // 4
    dev = xw.device
    family = _check_ln_lstm(wh, b, lng, lncg, lncb, mask, T, G, B, H, dev)
    _check("xw", xw, torch.bfloat16, (T, G, B, 4 * H), dev)
    _check("h0", h0, torch.float32, (G, B, H), dev)
    _check("c0", c0, torch.float32, (G, B, H), dev)
    _check_rd(rd, G, B, H, dev)
    h, c = h0.clone(), c0.clone()
    ys = torch.empty((T, G, B, H), dtype=torch.bfloat16, device=dev)
    h_res = c_res = z = None
    if save:
        h_res = torch.empty((T, G, B, H), dtype=torch.bfloat16, device=dev)
        c_res = torch.empty((T, G, B, H), dtype=torch.float32, device=dev)
        z = torch.empty((T, G, B, 4 * H), dtype=torch.float32, device=dev)
    cluster = family == "cluster"
    lib = _load()
    w = cluster_lstm_weights(wh) if cluster else wh  # alive until the launch is queued
    launch = lib.avsr_ln_lstm_cluster_fwd if cluster else lib.avsr_ln_lstm_scan_fwd
    err = launch(
        w.data_ptr(), b.data_ptr(), lng.data_ptr(), lncg.data_ptr(), lncb.data_ptr(),
        xw.data_ptr(), mask.data_ptr(), _ptr(rd), h.data_ptr(), c.data_ptr(), ys.data_ptr(),
        _ptr(h_res), _ptr(c_res), _ptr(z), T, G, B, H,
        torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "ln_lstm_scan_fwd launch")
    LAUNCHES[_lstm_counter("ln_lstm_scan_fwd", G, rd) if cluster
             else "ln_lstm_scan_block_fwd"] += 1
    return ys, h, c, h_res, c_res, z


def ln_lstm_scan_bwd(wh, b, lng, lncg, lncb, mask, c_res, z, dys, dhT, dcT, *, rd=None):
    """K13: the reverse scan of the LN-LSTM's gradient (CUDA), one launch and
    the parameter sums' reduce; counted as ``ln_lstm_scan[_uni][_rd]_bwd``.

    The forward's parameters and mask, its saved c_res [T,G,B,H] f32 and z
    [T,G,B,4H] f32, the cotangents dys [T,G,B,H] bf16, dhT / dcT [G,B,H] f32
    -> (dxw [T,G,B,4H] bf16 (= bf16(dz)), db, dln_gamma [G,4H], dln_cell_gamma,
    dln_cell_beta [G,H], dh0, dc0 [G,B,H], all f32).  dWh = h_res^T dxw, one
    product over all steps, is the caller's.  The cluster family is a
    launch for the steps' row statistics, one cluster launch and the
    parameter sums' reduce; the block family (counted as
    ``ln_lstm_scan_block_bwd``) one launch and the reduce.
    """
    T, G, B, H4 = z.shape
    H = H4 // 4
    dev = z.device
    family = _check_ln_lstm(wh, b, lng, lncg, lncb, mask, T, G, B, H, dev)
    _check("c_res", c_res, torch.float32, (T, G, B, H), dev)
    _check("z", z, torch.float32, (T, G, B, 4 * H), dev)
    _check("dys", dys, torch.bfloat16, (T, G, B, H), dev)
    _check("dhT", dhT, torch.float32, (G, B, H), dev)
    _check("dcT", dcT, torch.float32, (G, B, H), dev)
    _check_rd(rd, G, B, H, dev)
    if T < 1:
        raise ValueError("ln_lstm_scan_bwd: needs at least one step")
    dh, dc = dhT.clone(), dcT.clone()
    dxw = torch.empty((T, G, B, 4 * H), dtype=torch.bfloat16, device=dev)
    grads = torch.empty((G, 10 * H), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    lib = _load()
    if family == "cluster":
        w = cluster_lstm_weights(wh)  # alive until the launches are queued
        stats = torch.empty((T, G, B, LN_LSTM_NSTAT), dtype=torch.float32, device=dev)
        part = torch.empty((G, -(-B // LSTM_CLUSTER_ROWS), 10 * H), dtype=torch.float32,
                           device=dev)
        err = lib.avsr_ln_lstm_cluster_bwd(
            w.data_ptr(), b.data_ptr(), lng.data_ptr(), lncg.data_ptr(), lncb.data_ptr(),
            mask.data_ptr(), _ptr(rd), c_res.data_ptr(), z.data_ptr(), dys.data_ptr(),
            dh.data_ptr(), dc.data_ptr(), dxw.data_ptr(), stats.data_ptr(), part.data_ptr(),
            grads.data_ptr(), T, G, B, H, stream)
        counter = _lstm_counter("ln_lstm_scan_bwd", G, rd)
    else:
        whT = wh.transpose(1, 2).contiguous()
        part = torch.empty((G, -(-B // LN_LSTM_ROWS), 10 * H), dtype=torch.float32, device=dev)
        err = lib.avsr_ln_lstm_scan_bwd(
            whT.data_ptr(), b.data_ptr(), lng.data_ptr(), lncg.data_ptr(), lncb.data_ptr(),
            mask.data_ptr(), _ptr(rd), c_res.data_ptr(), z.data_ptr(), dys.data_ptr(),
            dh.data_ptr(), dc.data_ptr(), dxw.data_ptr(), part.data_ptr(), grads.data_ptr(),
            T, G, B, H, stream)
        counter = "ln_lstm_scan_block_bwd"
    _raise_on(err, "ln_lstm_scan_bwd launch")
    LAUNCHES[counter] += 1
    db, dlng, dlncg, dlncb = grads.split((4 * H, 4 * H, H, H), dim=1)
    return dxw, db, dlng, dlncg, dlncb, dh, dc


def mel_band_table(mel_w) -> Tuple[np.ndarray, np.ndarray]:
    """K3's banded mel matrix from the dense one ([F, M], numpy): band [M, 3]
    int32 (first bin, count, offset into the weights) and the weights
    float32, each bin's run from its first to its last nonzero bin in
    ascending f (zeros inside a run kept).  Summed with fmaf in that order
    it gives the bits of the dense sequential sum: a zero weight is a no-op
    of fmaf on a finite power."""
    w = np.asarray(mel_w, dtype=np.float32)
    band = np.zeros((w.shape[1], 3), np.int32)
    runs = []
    offset = 0
    for m in range(w.shape[1]):
        nz = np.flatnonzero(w[:, m])
        if nz.size:
            f0, f1 = int(nz[0]), int(nz[-1]) + 1
            runs.append(w[f0:f1, m])
            band[m] = (f0, f1 - f0, offset)
            offset += f1 - f0
        else:
            band[m] = (0, 0, offset)
    weights = np.concatenate(runs) if runs else np.zeros((0,), np.float32)
    return band, weights.astype(np.float32)


LOGMEL_STAGES = 7  # K3's three launches: 1 the mel product, 2 the statistics, 4 the writer
LOGMEL_CHUNKS = (16, 8, 4, 2, 1)  # stacked frames a block of K3's writer, largest first
WAVE_BLOCKS = 132  # one block an SM of an H100
# K3's normalizations (``AudioFrontendConfig.normalization``) as the kernel's codes
LOGMEL_NORMS = {"none": 0, "per_utterance": 1, "global": 2}


def logmel_writer_smem(M: int, chunk: int, stack: int, skip: int, N: int,
                       deltas: bool = True) -> int:
    """Shared memory of a block of K3's writer (``writer_smem`` in
    ``csrc/logmel.cu``): the staged log-mel (and, with deltas, Δ) of the
    chunk's frames with their 2N halo (none without deltas), its normalized
    features (3M or M a frame) and the statistics."""
    N = N if deltas else 0
    D = 3 * M if deltas else M
    ns = (chunk - 1) * skip + stack + 4 * N
    ny = (chunk - 1) * skip + stack
    return 4 * ((2 if deltas else 1) * M * ns + ny * D + 2 * D)


def logmel_writer_chunk(B: int, Tp: int, M: int = 30, stack: int = 8, skip: int = 3,
                        N: int = 2, deltas: bool = True) -> int:
    """Stacked frames a block of K3's writer takes: the largest chunk whose
    blocks fit shared memory and still number two an SM (a request's B = 8
    has few utterances, so its blocks come from time); else the smallest."""
    fits = [c for c in LOGMEL_CHUNKS
            if logmel_writer_smem(M, c, stack, skip, N, deltas) <= SMEM_LIMIT]
    if not fits:
        raise ValueError(f"logmel: {M} bins, stack {stack}, skip {skip}, window {N}: a "
                         "stacked frame does not fit one block")
    for chunk in fits:
        if B * -(-Tp // chunk) >= 2 * WAVE_BLOCKS:
            return chunk
    return fits[-1]


def logmel_stats_fits(T: int) -> bool:
    """Whether a block of K3's statistics launch (one column's log-mel and
    Δ of T frames in shared memory: 8 T bytes) fits an SM."""
    return 8 * T <= SMEM_LIMIT


def _check_logmel(re, im, feat_len, band, weights, normalization):
    B, T, F = re.shape
    M = band.shape[0]
    dev = re.device
    _check("re", re, torch.float32, (B, T, F), dev)
    _check("im", im, torch.float32, (B, T, F), dev)
    _check("feat_len", feat_len, torch.int32, (B,), dev)
    _check("band", band, torch.int32, (M, 3), dev)
    _check("weights", weights, torch.float32, tuple(weights.shape), dev)
    if weights.dim() != 1 or not logmel_stats_fits(T):
        raise ValueError(f"logmel: weights of shape {tuple(weights.shape)} or T={T} frames")
    if normalization not in LOGMEL_NORMS:
        raise ValueError(f"logmel: unknown normalization {normalization!r}")
    return B, T, F, M, dev


def _logmel_launch(re, im, feat_len, band, weights, scratch, log_floor, delta_window, stack,
                   skip, deltas, normalization, stages):
    B, T, F = re.shape
    M = band.shape[0]
    logmel, stats, out, new_len, gpart = scratch
    Tp = out.shape[1]
    chunk = logmel_writer_chunk(B, Tp, M, stack, skip, delta_window, deltas)
    err = _load().avsr_logmel_post_dft(
        re.data_ptr(), im.data_ptr(), feat_len.data_ptr(), band.data_ptr(), weights.data_ptr(),
        logmel.data_ptr(), stats.data_ptr(), out.data_ptr(), new_len.data_ptr(),
        gpart.data_ptr(), B, T, F, M, weights.shape[0], Tp, stack, skip, delta_window, chunk,
        float(log_floor), int(deltas), LOGMEL_NORMS[normalization], stages,
        torch.cuda.current_stream(re.device).cuda_stream)
    _raise_on(err, "logmel_post_dft launch")


def logmel_scratch(B: int, T: int, M: int, stack: int, skip: int, dev, deltas: bool = True):
    """K3's scratch and outputs: (logmel [B, M, T], stats [B, 2, D], out
    [B, T', D * stack], new_len [B], gpart [B * M * 3 + 2]: the global
    statistics' partial sums, then their mean and inverse std), D = 3M with
    deltas, else M."""
    Tp = max(0, (T - stack) // skip + 1)
    D = 3 * M if deltas else M
    return (torch.empty((B, M, T), dtype=torch.float32, device=dev),
            torch.empty((B, 2, D), dtype=torch.float32, device=dev),
            torch.empty((B, Tp, D * stack), dtype=torch.float32, device=dev),
            torch.empty((B,), dtype=torch.int32, device=dev),
            torch.empty((B * M * 3 + 2,), dtype=torch.float32, device=dev))


def logmel_stages(re, im, feat_len, band, weights, scratch, *, log_floor: float,
                  delta_window: int, stack: int, skip: int, stages: int, deltas: bool = True,
                  normalization: str = "per_utterance") -> None:
    """K3's launches of ``stages`` (bits of ``LOGMEL_STAGES``) into
    ``scratch`` (``logmel_scratch``'s tensors): chip_smoke times the three
    apart.  Counts no launch."""
    B, T, F, M, dev = _check_logmel(re, im, feat_len, band, weights, normalization)
    for name, x, want in zip(("logmel", "stats", "out", "new_len", "gpart"), scratch,
                             logmel_scratch(B, T, M, stack, skip, "meta", deltas)):
        _check(name, x, want.dtype, tuple(want.shape), dev)
    _logmel_launch(re, im, feat_len, band, weights, scratch, log_floor, delta_window, stack,
                   skip, deltas, normalization, stages)


def logmel_post_dft(re, im, feat_len, band, weights, *, log_floor: float,
                    delta_window: int, stack: int, skip: int, deltas: bool = True,
                    normalization: str = "per_utterance"):
    """K3: power -> banded product (the mel matrix, or the identity for the
    spectrogram) -> log -> Δ/ΔΔ (``deltas``) -> normalization (per
    utterance, global over the batch, or none) -> stack (CUDA).

    re/im [B,T,F] f32, feat_len [B] int32, the banded matrix (band [M, 3]
    int32, weights f32, ``mel_band_table``) -> (features [B,T',D*stack]
    f32, D = 3M with deltas else M, lengths [B] int32).  The presets'
    instance (a mel band of M < F bins, deltas, per-utterance) counts as
    ``logmel_post_dft``, every other (the spectrogram's band holds all F
    bins) as ``logmel_post_dft_options``.
    """
    B, T, F, M, dev = _check_logmel(re, im, feat_len, band, weights, normalization)
    scratch = logmel_scratch(B, T, M, stack, skip, dev, deltas)
    _logmel_launch(re, im, feat_len, band, weights, scratch, log_floor, delta_window, stack,
                   skip, deltas, normalization, LOGMEL_STAGES)
    default = M < F and deltas and normalization == "per_utterance"
    LAUNCHES["logmel_post_dft" if default else "logmel_post_dft_options"] += 1
    return scratch[2], scratch[3]


# The head widths (dk, dv) at which each attention kernel has tensor-core
# instances (``csrc/attention_mma.cuh``); every other pair of multiples of 8
# runs on the CUDA-core family (``csrc/attention_core.cuh``).  K5's cross
# attention at (128, 256) has kernels of its own (``DECODER_CROSS_WIDTHS``).
MMA_WIDTHS = {
    "encoder_attention": ((64, 64),),
    "fusion_attention": ((128, 128), (128, 64)),
    "decoder_self_attention": ((64, 64),),
    "decoder_cross_attention": (),
}
DECODER_CROSS_WIDTHS = (128, 256)
DECODER_SELF_MAX_S = 784  # K5's causal instance stages whole rows: 16384 + 272 S bytes at most
# K5's cross kernels (``csrc/decoder_cross_attention.cuh``): the backward
# holds every query of a (b, h) in one block, 10 strips of 16 at most (the
# presets cap their labels at 150); the forward 5 strips a block
DECODER_CROSS_MAX_Q = 160
DECODER_CROSS_FWD_STRIPS = 5


def attention_family(kernel: str, dk: int, dv: int, dtype: torch.dtype = torch.bfloat16) -> str:
    """The kernel family that runs ``kernel`` (a key of ``MMA_WIDTHS``) at
    head widths (dk, dv) on ``dtype`` operands: "cross", K5's cross kernels
    (one block per (b, h), ``csrc/decoder_cross_attention.cuh``), "mma",
    the tensor-core instances of ``csrc/attention_mma.cuh``, or "core", the
    CUDA-core kernels that take any widths that are multiples of 8 (their
    16-byte row loads) and save the fp32 weights for the backward; fp32
    operands (the fp32 policy: K4 and K5) always take "core", its fp32
    instance.  Chosen by shape and type alone, never after a failure; other
    widths raise."""
    _check_widths(kernel, dk, dv)
    if dtype == torch.float32:
        return "core"
    if kernel == "decoder_cross_attention" and (dk, dv) == DECODER_CROSS_WIDTHS:
        return "cross"
    return "mma" if (dk, dv) in MMA_WIDTHS[kernel] else "core"


def decoder_cross_fwd_smem(strips: int, S: int, slots: int = 3) -> int:
    """Shared memory of a block of K5's cross forward holding ``strips``
    strips of 16 queries over S keys with a ring of ``slots`` tiles, bytes
    (``FwdLayout``): the ring of 32-row value tiles (528-byte rows), two q
    buffers [16 strips, 272 B], the scores then bf16(P) [16 strips, 2 (S
    rounded up to 16) + 16 B], the halves' max and sum (fp32 [4, 16
    strips]), 2 slots + 4 mbarriers."""
    sp = (S + 15) // 16 * 16 + 8
    return slots * 32 * 528 + 16 * strips * (2 * 272 + 2 * sp + 16) + (2 * slots + 4) * 8


def decoder_cross_route(Q: int, S: int, backward: bool) -> str:
    """The kernels that run K5's cross attention at (128, 256) over Q
    queries and S keys: "resident", its own (``csrc/decoder_cross_attention.cuh``),
    where they hold the lengths (the forward any Q and S whose scores one
    16-query strip holds, S <= 5376; the backward every query of a (b, h)
    in one block, Q <= ``DECODER_CROSS_MAX_Q``, and any S), else "stream",
    the streamed tiles (``csrc/attention_mma.cuh``, two column slices a
    (b, h)), which take any length.  Chosen by shape alone, never after a
    failure; each direction by its own limits (the residual, the row max
    and sum, is the same on both routes)."""
    if Q < 1 or S < 1:
        raise ValueError(f"decoder attention: Q={Q} and S={S} must be at least 1")
    fits = Q <= DECODER_CROSS_MAX_Q if backward else decoder_cross_fwd_strips(Q, S) > 0
    return "resident" if fits else "stream"


def decoder_cross_fwd_strips(Q: int, S: int) -> int:
    """Strips of 16 queries a block of K5's cross forward holds: the fewest
    blocks per (b, h) (5 strips each at most) whose shared memory fits with
    the least ring (3 tiles), the fewest strips a block that number allows;
    0 where none fits (``fwd_config``)."""
    nst = -(-Q // 16)
    for nc in range(-(-nst // DECODER_CROSS_FWD_STRIPS), nst + 1):
        ns = -(-nst // nc)
        if decoder_cross_fwd_smem(ns, S) <= SMEM_LIMIT:
            return ns
    return 0


def _check_widths(what: str, dk: int, dv: int) -> None:
    if dk < 8 or dv < 8 or dk % 8 or dv % 8:
        raise ValueError(f"{what}: head widths dk={dk}, dv={dv}; the kernels take positive "
                         f"multiples of 8")


def attention_core_smem(Tq: int, Tk: int, dk: int, dv: int, elem_bytes: int = 2) -> int:
    """Shared memory of the largest launch of the CUDA-core attention family
    (``csrc/attention_core.cuh`` ``attn_smem``) over ``elem_bytes``
    operands: a chunk of 64 streamed rows, a tile of 16 rows, the scores'
    rows fp32 and the 16 rows' fp32 sums; pass 2 the tile's dsc / P columns
    over every query."""
    fwd = 64 * max(dk, dv) * elem_bytes + 16 * dk * elem_bytes + 64 * Tk + 64 * dv
    bwd_q = 64 * max(dk, dv) * elem_bytes + 16 * dv * elem_bytes + 64 * Tk + 64 * dk
    bwd_kv = 64 * (dk + dv) * elem_bytes + 128 * Tq + 64 * (dk + dv)
    return max(fwd, bwd_q, bwd_kv)


def _check_core(what: str, Tq: int, Tk: int, dk: int, dv: int,
                dtype: torch.dtype = torch.bfloat16) -> None:
    """The CUDA-core route keeps whole rows of scores in shared memory: its
    lengths are capped by the card's limit at the given widths."""
    fp32 = dtype == torch.float32
    smem = _load().avsr_attn_core_smem(Tq, Tk, dk, dv, int(fp32))
    if smem > SMEM_LIMIT:
        raise ValueError(f"{what}: the CUDA-core kernels at head widths dk={dk}, dv={dv} "
                         f"({'the fp32 instance' if fp32 else 'no tensor-core instance'}) keep "
                         f"whole rows of scores; T_q={Tq}, T_k={Tk} need {smem} bytes of shared "
                         f"memory per block (limit {SMEM_LIMIT})")


def _check_dtype(what: str, x: torch.Tensor) -> torch.dtype:
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{what}: the kernels take bf16 or fp32 operands, got {x.dtype}")
    return x.dtype


def _check_fusion(q, k, v, video_lengths, dev):
    B, Ta, nh, A = q.shape
    Tv, dv = k.shape[1], v.shape[-1]
    dt = _check_dtype("fusion attention", q)
    _check("q", q, dt, (B, Ta, nh, A), dev)
    _check("k", k, dt, (B, Tv, nh, A), dev)
    _check("v", v, dt, (B, Tv, nh, dv), dev)
    _check("video_lengths", video_lengths, torch.int32, (B,), dev, align=4)
    if not (1 <= Ta <= ATTEND_MAX_S and 1 <= Tv <= FUSION_MAX_TV):
        raise ValueError(f"fusion attention: T_a={Ta}, T_v={Tv}; the kernels take "
                         f"1 <= T_a <= {ATTEND_MAX_S} and 1 <= T_v <= {FUSION_MAX_TV}")
    if attention_family("fusion_attention", A, dv, dt) == "core":
        _check_core("fusion attention", Ta, Tv, A, dv, dt)
    return B, Ta, Tv, nh, A, dv


def fusion_attention_fwd(q, k, v, video_lengths, *, save: bool = False):
    """K4: the cross-attention fusion core, forward (CUDA).

    q [B,T_a,nh,A], k [B,T_v,nh,A], v [B,T_v,nh,dv] bf16, video_lengths [B]
    int32 -> (ctx [B,T_a,nh,dv] bf16, weights [B,nh,T_a,T_v] f32, the
    backward's residual when ``save``, else None): on the tensor cores
    (``attention_family`` "mma") the softmax's row statistics (row_max,
    row_sum), fp32 [B,nh,T_a] each; on the CUDA-core route the weights
    themselves, a one-tuple.  fp32 q, k, v (the fp32 policy) run the
    CUDA-core family's fp32 instance, ctx fp32, counted as
    ``fusion_attention_f32_fwd``.
    """
    dev = q.device
    B, Ta, Tv, nh, A, dv = _check_fusion(q, k, v, video_lengths, dev)
    lib = _load()
    fp32 = q.dtype == torch.float32
    P = torch.empty((B, nh, Ta, Tv), dtype=torch.float32, device=dev)
    ctx = torch.empty((B, Ta, nh, dv), dtype=q.dtype, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    if attention_family("fusion_attention", A, dv, q.dtype) == "core":
        launch = lib.avsr_fusion_attn_core_fwd_f32 if fp32 else lib.avsr_fusion_attn_core_fwd
        err = launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), video_lengths.data_ptr(),
                     P.data_ptr(), ctx.data_ptr(), B, Ta, Tv, nh, A, dv, stream)
        res = (P,) if save else None
    else:
        res = tuple(torch.empty((B, nh, Ta), dtype=torch.float32, device=dev)
                    for _ in range(2)) if save else None
        err = lib.avsr_fusion_attn_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), video_lengths.data_ptr(), P.data_ptr(),
            *((None, None) if res is None else map(_ptr, res)), ctx.data_ptr(),
            B, Ta, Tv, nh, A, dv, stream)
    _raise_on(err, "fusion_attention_fwd launch")
    LAUNCHES["fusion_attention_f32_fwd" if fp32 else "fusion_attention_fwd"] += 1
    return ctx, P, res


def fusion_attention_bwd(q, k, v, video_lengths, row_max, row_sum, dctx):
    """K4: the cross-attention fusion core, backward (CUDA, tensor cores).

    The forward's q, k, v, video lengths and saved row statistics (fp32
    [B,nh,T_a] each), and the context cotangent dctx [B,T_a,nh,dv] bf16 ->
    (dq, dk, dv) in bf16.  The weights are recomputed from the statistics;
    the only scratch is D = rowsum(dP * P), fp32 [B,nh,T_a].  Widths with no
    tensor-core instance take ``attention_bwd_core``.
    """
    dev = q.device
    B, Ta, Tv, nh, A, dv = _check_fusion(q, k, v, video_lengths, dev)
    if attention_family("fusion_attention", A, dv, q.dtype) != "mma":
        raise ValueError(f"fusion attention: no tensor-core instance at A={A}, dv={dv}; its "
                         f"backward reads the weights (attention_bwd_core)")
    _check("row_max", row_max, torch.float32, (B, nh, Ta), dev, align=4)
    _check("row_sum", row_sum, torch.float32, (B, nh, Ta), dev, align=4)
    _check("dctx", dctx, torch.bfloat16, (B, Ta, nh, dv), dev)
    lib = _load()
    D = torch.empty((B, nh, Ta), dtype=torch.float32, device=dev)
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dvv = torch.empty_like(v)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.avsr_fusion_attn_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), video_lengths.data_ptr(), row_max.data_ptr(),
        row_sum.data_ptr(), dctx.data_ptr(), D.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dvv.data_ptr(), B, Ta, Tv, nh, A, dv, stream)
    _raise_on(err, "fusion_attention_bwd launch")
    LAUNCHES["fusion_attention_bwd"] += 1
    return dq, dk, dvv


def _check_decoder_attention(q, k, v, bias, dev):
    """K5's operands and the family that runs them (``attention_family``):
    the causal tensor-core instance takes Q = S <= ``DECODER_SELF_MAX_S``,
    the cross kernels any lengths (``decoder_cross_route``); the CUDA-core
    route is capped by shared memory."""
    B, Q, nh, dk = q.shape
    S, dv = k.shape[1], v.shape[-1]
    dt = _check_dtype("decoder attention", q)
    _check("q", q, dt, (B, Q, nh, dk), dev)
    _check("k", k, dt, (B, S, nh, dk), dev)
    _check("v", v, dt, (B, S, nh, dv), dev)
    if bias is None:
        if Q != S:
            raise ValueError(f"decoder attention: the causal mask needs Q == S, got {Q} and {S}")
    else:
        _check("bias", bias, torch.float32, (B, S), dev)
    if Q < 1 or S < 1:
        raise ValueError(f"decoder attention: Q={Q} and S={S} must be at least 1")
    kind = "decoder_self_attention" if bias is None else "decoder_cross_attention"
    family = attention_family(kind, dk, dv, dt)
    if family == "core":
        _check_core("decoder attention", Q, S, dk, dv, dt)
    elif bias is None and S > DECODER_SELF_MAX_S:
        raise ValueError(f"decoder attention: the causal instance stages whole rows and takes "
                         f"Q = S <= {DECODER_SELF_MAX_S}, got {S}")
    return B, Q, S, nh, dk, dv, family


def decoder_attention_fwd(q, k, v, bias, *, save: bool):
    """K5: the teacher-forced decoder attention, forward (CUDA).

    q [B,Q,nh,dk], k [B,S,nh,dk], v [B,S,nh,dv] bf16; ``bias`` [B,S] f32
    (the memory's additive key bias) or None for the causal mask (Q == S)
    -> (ctx [B,Q,nh,dv] bf16, the backward's residual when ``save``, else
    None): on the tensor cores (``attention_family`` "mma" or "cross") the
    softmax's row statistics (row_max, row_sum), fp32 [B,nh,Q] each, and no weights
    are written; on the CUDA-core route the fp32 weights [B,nh,Q,S], a
    one-tuple.  fp32 q, k, v (the fp32 policy) run the CUDA-core family's
    fp32 instance, ctx fp32, counted as ``decoder_attention_f32_fwd``.
    """
    dev = q.device
    B, Q, S, nh, dk, dv, family = _check_decoder_attention(q, k, v, bias, dev)
    lib = _load()
    fp32 = q.dtype == torch.float32
    ctx = torch.empty((B, Q, nh, dv), dtype=q.dtype, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    if family == "core":
        P = torch.empty((B, nh, Q, S), dtype=torch.float32, device=dev) if save else None
        launch = lib.avsr_decoder_attn_core_fwd_f32 if fp32 else lib.avsr_decoder_attn_core_fwd
        err = launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(bias), _ptr(P),
                     ctx.data_ptr(), B, Q, S, nh, dk, dv, stream)
        res = (P,) if save else None
    else:
        res = tuple(torch.empty((B, nh, Q), dtype=torch.float32, device=dev)
                    for _ in range(2)) if save else None
        stats = (None, None) if res is None else map(_ptr, res)
        if family == "cross" and decoder_cross_route(Q, S, backward=False) == "stream":
            err = lib.avsr_decoder_cross_stream_fwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(), *stats,
                ctx.data_ptr(), B, Q, S, nh, stream)
        else:
            err = lib.avsr_decoder_attn_fwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(bias), *stats, ctx.data_ptr(),
                B, Q, S, nh, dk, dv, stream)
    _raise_on(err, "decoder_attention_fwd launch")
    LAUNCHES["decoder_attention_f32_fwd" if fp32 else "decoder_attention_fwd"] += 1
    return ctx, res


def decoder_attention_bwd(q, k, v, bias, row_max, row_sum, dctx):
    """K5: the teacher-forced decoder attention, backward (CUDA, tensor
    cores).

    The forward's q, k, v, bias (None: causal) and saved row statistics
    (fp32 [B,nh,Q] each), and the context cotangent dctx [B,Q,nh,dv] bf16
    -> (dq, dk, dv) in bf16.  The weights are recomputed from the
    statistics; the only scratch is D = rowsum(dP * P), fp32 [B,nh,Q] (the
    cross kernels' resident route keeps it on chip).  Widths with no
    tensor-core instance take ``attention_bwd_core``.
    """
    dev = q.device
    B, Q, S, nh, dk, dv, family = _check_decoder_attention(q, k, v, bias, dev)
    if family == "core":
        raise ValueError(f"decoder attention: no tensor-core instance at dk={dk}, dv={dv}; its "
                         f"backward reads the weights (attention_bwd_core)")
    _check("row_max", row_max, torch.float32, (B, nh, Q), dev, align=4)
    _check("row_sum", row_sum, torch.float32, (B, nh, Q), dev, align=4)
    _check("dctx", dctx, torch.bfloat16, (B, Q, nh, dv), dev)
    lib = _load()
    # the cross kernels keep D in shared memory; the streamed tiles do not
    resident = family == "cross" and decoder_cross_route(Q, S, backward=True) == "resident"
    D = None if resident else torch.empty((B, nh, Q), dtype=torch.float32, device=dev)
    dq = torch.empty_like(q)
    dkk = torch.empty_like(k)
    dvv = torch.empty_like(v)
    stream = torch.cuda.current_stream(dev).cuda_stream
    operands = (q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(bias), row_max.data_ptr(),
                row_sum.data_ptr(), dctx.data_ptr(), _ptr(D), dq.data_ptr(), dkk.data_ptr(),
                dvv.data_ptr())
    if family == "cross" and not resident:
        err = lib.avsr_decoder_cross_stream_bwd(*operands, B, Q, S, nh, stream)
    else:
        err = lib.avsr_decoder_attn_bwd(*operands, B, Q, S, nh, dk, dv, stream)
    _raise_on(err, "decoder_attention_bwd launch")
    LAUNCHES["decoder_attention_bwd"] += 1
    return dq, dkk, dvv


def attention_bwd_core(kernel: str, q, k, v, weights, dctx):
    """The backward of K4 (``kernel`` "fusion_attention") or K5
    ("decoder_attention") on the CUDA-core route, from the forward's fp32
    weights [B,nh,T_q,T_k]: q [B,T_q,nh,dk], k [B,T_k,nh,dk], v
    [B,T_k,nh,dv] and dctx [B,T_q,nh,dv] bf16 -> (dq, dk, dv) in bf16.  The
    mask enters only through the weights; the scratch is the scores'
    cotangent, bf16 [B,nh,T_q,T_k].  Counted as the kernel's backward.  In
    fp32 (the fp32 policy's instance: operands, gradients and scratch
    fp32) counted as ``<kernel>_f32_bwd``."""
    B, Tq, nh, dk = q.shape
    Tk, dv = k.shape[1], v.shape[-1]
    dev = q.device
    dt = _check_dtype(kernel, q)
    _check("q", q, dt, (B, Tq, nh, dk), dev)
    _check("k", k, dt, (B, Tk, nh, dk), dev)
    _check("v", v, dt, (B, Tk, nh, dv), dev)
    _check("weights", weights, torch.float32, (B, nh, Tq, Tk), dev)
    _check("dctx", dctx, dt, (B, Tq, nh, dv), dev)
    _check_widths(kernel, dk, dv)
    _check_core(kernel, Tq, Tk, dk, dv, dt)
    lib = _load()
    fp32 = dt == torch.float32
    dsc = torch.empty((B, nh, Tq, Tk), dtype=dt, device=dev)
    dq = torch.empty_like(q)
    dkk = torch.empty_like(k)
    dvv = torch.empty_like(v)
    stream = torch.cuda.current_stream(dev).cuda_stream
    launch = lib.avsr_attn_core_bwd_f32 if fp32 else lib.avsr_attn_core_bwd
    err = launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), weights.data_ptr(), dctx.data_ptr(),
                 dsc.data_ptr(), dq.data_ptr(), dkk.data_ptr(), dvv.data_ptr(), B, Tq, Tk, nh, dk,
                 dv, stream)
    _raise_on(err, f"{kernel}_bwd launch")
    LAUNCHES[f"{kernel}_f32_bwd" if fp32 else f"{kernel}_bwd"] += 1
    return dq, dkk, dvv


# K6's self instance (``csrc/decode_attention.cu``, "rows"): one block per
# cache row, every head; the row's nh * dh = 256 channels are one 16-byte
# chunk a lane of a warp, its keys and values staged whole in shared memory
DECODE_ROW_WIDTH = 256
DECODE_ROW_TILE = 32  # keys a bulk copy
# K6's grouped cross read ("grouped"): a CTA per (memory row, head, slice
# of value columns), the W queries of the row on the tensor cores
DECODE_GROUP_BLOCKS = 132    # CTAs of one wave: an SM each
# value columns a CTA holds at least: each slice reads all of the row's
# keys, and 16-column slices (the only ones that fit at the 16 s memory)
# read them so often that the general kernel is faster
DECODE_GROUP_MIN_COLS = 32


def decode_rows_smem(n_keys: int, nh: int) -> int:
    """Shared memory of K6's self instance over ``n_keys`` keys at ``nh``
    heads, bytes (``RowLayout``): the keys and values [n_keys, 256] bf16,
    the scores [nh, n_keys] fp32 (rounded up to 16 bytes), the 16 warps'
    partial context rows [16, 256] fp32, one mbarrier a 32-key tile of each."""
    tiles = -(-n_keys // DECODE_ROW_TILE)
    p = 2 * n_keys * DECODE_ROW_WIDTH * 2
    part = p + (nh * n_keys * 4 + 15) // 16 * 16
    return part + 16 * DECODE_ROW_WIDTH * 4 + 2 * tiles * 8


def decode_grouped_smem(W: int, S: int, dk: int, dvs: int) -> int:
    """Shared memory of a CTA of K6's grouped cross read (``GroupLayout``)
    over W queries (16-row strips), S keys (rounded up to 16) and dvs value
    columns: the queries and keys [., dk + 8] bf16, the value columns [S,
    dvs + 8] bf16, the scores [16 strips, S] fp32, bf16(P) [16 strips, S +
    8], bytes."""
    rows, sp = -(-W // 16) * 16, -(-S // 16) * 16
    return (rows * (dk + 8) * 2 + sp * (dk + 8) * 2 + sp * (dvs + 8) * 2 + rows * sp * 4
            + rows * (sp + 8) * 2)


def decode_grouped_slices(B: int, W: int, S: int, nh: int, dk: int, dv: int) -> int:
    """CV, the CTAs of K6's grouped cross read per (memory row, head), each
    a slice of dv / CV value columns (a multiple of 16, at least
    ``DECODE_GROUP_MIN_COLS`` where dv has them): the most that keep B nh
    CV within a wave of ``DECODE_GROUP_BLOCKS``, among those whose CTA fits
    in shared memory (else the fewest that fit); 0 where none fits or the
    widths are not multiples of 16 (the tensor cores' k step)."""
    if dk % 16 or dv % 16:
        return 0
    fits = [c for c in range(1, dv // 16 + 1)
            if dv % (16 * c) == 0 and dv // c >= min(dv, DECODE_GROUP_MIN_COLS)
            and decode_grouped_smem(W, S, dk, dv // c) <= SMEM_LIMIT]
    if not fits:
        return 0
    target = max(1, DECODE_GROUP_BLOCKS // (B * nh))
    within = [c for c in fits if c <= target]
    return max(within) if within else min(fits)


def decode_attention_route(N: int, B: int, L: int, n_keys: int, nh: int, dk: int, dv: int,
                           cross: bool, dtype: torch.dtype = torch.bfloat16) -> str:
    """The kernel that runs K6 for N query rows over B key rows of length L
    (W = N / B queries a key row), ``n_keys`` of them read: "grouped", the
    cross read of W >= 2 beams at widths that are multiples of 16 while a
    CTA holds the memory row's keys (``decode_grouped_slices``): the W
    queries of a memory row as one tile on the tensor cores, each key and
    value row through shared memory once for them; "rows", the self read of
    a cache row per block at nh * dk = nh * dv = 256 and dk / 8 a power of
    two, while the row's keys and values fit in shared memory;
    "general", the CUDA-core kernel of one block per (n, h), every other
    shape (greedy's cross read among them: at W = 1 there is nothing to
    share), and every read of fp32 operands (the fp32 policy: the general
    kernel's fp32 instance).  Chosen by shape and type alone, never after a
    failure."""
    if N < 1 or B < 1 or N % B:
        raise ValueError(f"decode attention: {N} query rows over {B} key rows; N must be a "
                         f"positive multiple of B")
    _check_widths("decode attention", dk, dv)
    if not 1 <= n_keys <= L:
        raise ValueError(f"decode attention: n_keys={n_keys} with L={L}")
    if dtype == torch.float32:
        return "general"
    if cross:
        W = N // B
        if W >= 2 and decode_grouped_slices(B, W, L, nh, dk, dv) > 0:
            return "grouped"
        return "general"
    g = dk // 8
    if (N == B and dk == dv and nh * dk == DECODE_ROW_WIDTH and g & (g - 1) == 0
            and decode_rows_smem(n_keys, nh) <= SMEM_LIMIT):
        return "rows"
    return "general"


def decode_attention(q, k, v, bias, n_keys: int):
    """K6: single-query decode attention (CUDA).

    q [N,nh,dk] bf16 against k [B,L,nh,dk] and v [B,L,nh,dv] bf16, query
    row n reading key row n // (N / B) (a beam of utterance n // W reads
    its untiled memory); ``bias`` [B,L] f32 adds the memory's key bias to all
    L keys (cross attention, ``n_keys`` == L), or None: self attention over
    keys [0, n_keys) of each row's cache (B == N) -> ctx [N,nh,dv] bf16.
    The kernel by ``decode_attention_route``.  fp32 q, k, v (the fp32
    policy) run the general kernel's fp32 instance, ctx fp32, counted as
    ``decode_attention_f32``.
    """
    N, nh, dk = q.shape
    B, L = k.shape[:2]
    dv = v.shape[-1]
    dev = q.device
    dt = _check_dtype("decode attention", q)
    route = decode_attention_route(N, B, L, n_keys, nh, dk, dv, bias is not None, dt)
    _check("q", q, dt, (N, nh, dk), dev)
    _check("k", k, dt, (B, L, nh, dk), dev)
    _check("v", v, dt, (B, L, nh, dv), dev)
    if bias is not None:
        _check("bias", bias, torch.float32, (B, L), dev)
        if n_keys != L:
            raise ValueError(f"decode attention: the cross read takes every key, n_keys={n_keys} "
                             f"with L={L}")
    elif B != N:
        raise ValueError(f"decode attention: the self read takes a cache row per query row, "
                         f"got {N} queries over {B} rows")
    lib = _load()
    ctx = torch.empty((N, nh, dv), dtype=dt, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    fp32 = dt == torch.float32
    if route == "grouped":
        cv = decode_grouped_slices(B, N // B, L, nh, dk, dv)
        err = lib.avsr_decode_attn_grouped(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                           bias.data_ptr(), ctx.data_ptr(), B, N // B, L, cv, nh,
                                           dk, dv, stream)
    elif route == "rows":
        err = lib.avsr_decode_attn_rows(q.data_ptr(), k.data_ptr(), v.data_ptr(), ctx.data_ptr(),
                                        N, L, n_keys, nh, dk, stream)
    else:
        launch = lib.avsr_decode_attn_f32 if fp32 else lib.avsr_decode_attn
        err = launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(bias), ctx.data_ptr(), N, B,
                     L, n_keys, nh, dk, dv, stream)
    _raise_on(err, "decode_attention launch")
    LAUNCHES["decode_attention_f32" if fp32 else "decode_attention"] += 1
    return ctx


class _BeamCarry(ctypes.Structure):
    """``BeamCarry`` of ``csrc/beam_step.cu``: one carry's pointers."""
    _fields_ = [(name, ctypes.c_void_p) for name in
                ("logp", "lens", "finished", "flat_parent", "feed", "settled")]


class _BeamStepArgs(ctypes.Structure):
    """``BeamStepArgs`` of ``csrc/beam_step.cu`` (8-byte fields only)."""
    _fields_ = [("carry", _BeamCarry * 2), ("lp_table", ctypes.c_void_p),
                ("tokens", ctypes.c_void_p), ("parents", ctypes.c_void_p),
                ("B", ctypes.c_longlong), ("W", ctypes.c_longlong), ("V", ctypes.c_longlong),
                ("n_lp", ctypes.c_longlong), ("count_level1", ctypes.c_longlong)]


def beam_step_admits(W: int, V: int) -> bool:
    """The (W, V) K7 takes: W >= 1, V past EOS, and 2 W V 4 + 128 bytes
    within 48 KB (the first kernel's limit, kept: every (B, W, V) it took)."""
    return W >= 1 and V > 2 and 2 * W * V * 4 + 32 * 4 <= 48 * 1024


def beam_step_smem(W: int, V: int) -> int:
    """Shared memory of K7's block (``step_smem`` in ``csrc/beam_step.cu``):
    every candidate's key and log prob, and each beam's best min(W, V), the
    key rows padded to an even length."""
    def even(n):
        return n + (n & 1)

    K = min(W, V)
    return 8 * (even(W * K) + W * even(V)) + 4 * (W * even(V) + W * K)


def beam_step_level1(W: int, V: int) -> str:
    """How K7 ranks one beam's V candidates to keep its best K = min(W, V):
    "count" (each key's rank is the number of keys above it: ceil(V / 32) V
    reads a lane) where that is at most 64 K, else "rounds" (K rounds of a
    warp max under the previous round's key)."""
    return "count" if -(-V // 32) * V <= 64 * min(W, V) else "rounds"


def _check_beam_carry(c, B, W, dev, outputs: bool) -> _BeamCarry:
    _check("logp", c.logp, torch.float32, (B, W), dev, align=4)
    _check("lens", c.lens, torch.int32, (B, W), dev, align=4)
    _check("finished", c.finished, torch.bool, (B, W), dev, align=1)
    if not outputs:
        return _BeamCarry(c.logp.data_ptr(), c.lens.data_ptr(), c.finished.data_ptr())
    _check("flat_parent", c.flat_parent, torch.int64, (B * W,), dev, align=8)
    _check("feed", c.feed, torch.int64, (B, W), dev, align=8)
    _check("settled", c.settled, torch.bool, (B,), dev, align=1)
    return _BeamCarry(*(getattr(c, name).data_ptr() for name, _ in _BeamCarry._fields_))


def _beam_args(lp_table, tokens, parents, carry0, carry1, B, W, V,
               both_written: bool) -> _BeamStepArgs:
    """The kernel's arguments, every tensor checked: steps read carry 0 and
    write carry 1, and the other way round where ``both_written``."""
    dev = lp_table.device
    _check("lp_table", lp_table, torch.float32, tuple(lp_table.shape), dev)
    if lp_table.dim() != 1 or lp_table.shape[0] < 1 or B < 1 or not beam_step_admits(W, V):
        raise ValueError(f"beam step: B={B}, W={W}, V={V} or a length table of "
                         f"{tuple(lp_table.shape)}")
    c0 = _check_beam_carry(carry0, B, W, dev, outputs=both_written)
    c1 = _check_beam_carry(carry1, B, W, dev, outputs=True)
    for name in ("logp", "lens", "finished"):
        if getattr(c0, name) == getattr(c1, name):
            raise ValueError(f"beam step: the new {name} overwrites the one it reads")
    return _BeamStepArgs((c0, c1), lp_table.data_ptr(), tokens.data_ptr(), parents.data_ptr(),
                         B, W, V, lp_table.shape[0], int(beam_step_level1(W, V) == "count"))


def _check_logits(logits, N: int, V: int, dev) -> None:
    if (logits.dtype != torch.float32 or logits.shape != (N, V) or logits.device != dev
            or not logits.is_contiguous()):
        raise ValueError(f"beam step: logits {logits.dtype} {tuple(logits.shape)} on "
                         f"{logits.device}, expected contiguous float32 ({N}, {V}) on {dev}")


class _CarryIn(NamedTuple):
    """The carry a step reads."""
    logp: torch.Tensor
    lens: torch.Tensor
    finished: torch.Tensor


def beam_step(logits, logp, lens, finished, lp_table, tokens_row, parents_row, out):
    """K7: one fused beam step (CUDA), checked and launched in one call.

    logits [B*W,V] f32, the carry (logp [B,W] f32, lens [B,W] int32,
    finished [B,W] bool), lp_table [n] f32 (the length penalty of each
    length); writes the token and parent rows [B,W] int64 (row t of the
    trellis) and ``out`` (a ``decode.beam.StepOut``), the new carry and the
    step's outputs: flat_parent [B*W] int64, feed [B,W]
    int64, logp, lens, finished, and settled [B] bool (every new beam of
    the row finished or dead: the loop's condition).  Returns ``out``.  A
    search checks once and launches per step through ``BeamStep``.
    """
    B, W = logp.shape
    V = logits.shape[-1]
    dev = logits.device
    _check("tokens_row", tokens_row, torch.int64, (B, W), dev, align=8)
    _check("parents_row", parents_row, torch.int64, (B, W), dev, align=8)
    args = _beam_args(lp_table, tokens_row, parents_row, _CarryIn(logp, lens, finished), out,
                      B, W, V, both_written=False)
    _check_logits(logits, B * W, V, lp_table.device)
    err = _load().avsr_beam_step(ctypes.byref(args), logits.data_ptr(), 0, 0,
                                 torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "beam_step launch")
    LAUNCHES["beam_step"] += 1
    return out


class BeamStep:
    """K7 for one beam search: ``step(logits, t, src)`` reads carry ``src``
    of ``carries`` (two ``decode.beam.StepOut``), writes carry ``1 - src``
    and row t of the [L, B, W] int64 trellises ``tokens`` and ``parents``.

    Every tensor but the logits is checked here, once, and the stream (the
    current one now), the entry point and the kernel's arguments are fixed
    here: a step checks the logits and makes one five-argument call.
    """

    def __init__(self, lp_table, tokens, parents, carries, V: int):
        L, B, W = tokens.shape
        dev = lp_table.device
        _check("tokens", tokens, torch.int64, (L, B, W), dev)
        _check("parents", parents, torch.int64, (L, B, W), dev)
        self._args = _beam_args(lp_table, tokens, parents, carries[0], carries[1], B, W, V,
                                both_written=True)
        self._ref = ctypes.byref(self._args)
        self._fn = _load().avsr_beam_step
        self._stream = torch.cuda.current_stream(dev).cuda_stream
        self._shape, self._dev, self._L = (B * W, V), dev, L

    def __call__(self, logits, t: int, src: int) -> None:
        if (logits.dtype != torch.float32 or logits.shape != self._shape
                or logits.device != self._dev or not logits.is_contiguous()):
            _check_logits(logits, *self._shape, self._dev)
        if not 0 <= t < self._L or src not in (0, 1):
            raise ValueError(f"beam step: row {t} of a {self._L}-row trellis, carry {src}")
        _raise_on(self._fn(self._ref, logits.data_ptr(), t, src, self._stream),
                  "beam_step launch")
        LAUNCHES["beam_step"] += 1


def launch_floor(stream: Optional[int] = None) -> None:
    """One launch of an empty kernel on ``stream`` (a CUDA stream handle, by
    default the current stream's): chip_smoke times it beside K7 as the
    floor of a launch.  Counts nothing."""
    if stream is None:
        stream = torch.cuda.current_stream().cuda_stream
    _raise_on(_load().avsr_launch_floor(stream), "launch_floor")


def _operand_dtype(what: str, x: torch.Tensor, dot: bool) -> torch.dtype:
    """The compute dtype of a K8 / K10 call, from its weight ``x``: bf16
    (the bf16 policy, either score) or fp32 (the fp32 policy's instance:
    Bahdanau's score only; its Luong read is still to be ported)."""
    dt = x.dtype
    if dt == torch.float32 and dot:
        raise ValueError(f"{what}: the fp32 instance runs the Bahdanau read; the Luong read's "
                         f"fp32 instance is still to be ported")
    if dt not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{what}: the kernels take bf16 or fp32 operands, got {dt}")
    return dt


def _check_score(v, keys, B, S, A, dev, dt=torch.bfloat16):
    """The score's operands: Bahdanau's v [A] in the compute dtype ``dt``
    and fp32 keys [B, S, A], or Luong's (v None) bf16 keys [B, S, A], A the
    memory width."""
    if v is not None:
        _check("v", v, dt, (A,), dev)
    _check("keys", keys, torch.float32 if v is not None else torch.bfloat16, (B, S, A), dev)


ALIGN_F32_CHUNK = 128  # input rows a chunk of K8's fp32 gate launch and regate (rch<float>)


def av_align_step_smem(H: int, Dc: int, A: int, S: int, elem_bytes: int = 2) -> int:
    """Shared memory per block of K8's per-step forward with ``elem_bytes``
    operands (``csrc/av_align_scan.cu`` ``avsr_av_align_smem`` /
    ``avsr_av_align_f32_smem``), bytes: the larger of the gate launch's
    (bf16: the [H + Dc, 16 units, 4 gates] weight slices and 16 bf16 h and
    ctx rows; fp32: a chunk of ``ALIGN_F32_CHUNK`` input rows of them) and
    the read launch's (``bahdanau_core.cuh`` ``read_smem_bytes``)."""
    K = H + Dc if elem_bytes == 2 else ALIGN_F32_CHUNK
    gate = (64 * K + 16 * K) * elem_bytes
    return max(gate, attend_general_smem(H, A, S))


def attend_general_smem(Hq: int, A: int, S: int) -> int:
    """Shared memory of a block of one read on 256 threads (K10's general
    kernel, K8's per-step read launch; ``bahdanau_core.cuh``
    ``read_smem_bytes``), bytes, in either policy: q and v [A], the query
    [Hq], the scores [S], 8 reduction slots and 8 x 256 partial sums, fp32."""
    return (2 * A + Hq + S + 8 + 8 * 256) * 4


def attend_step_bwd_smem(Hq: int, A: int, S: int, Dv: int) -> int:
    """Shared memory of a CTA of K10's per-step backward
    (``csrc/bahdanau_attend.cu`` ``StepLayout``), bytes, in either policy:
    q and v [A], dctx [Dv], the query [Hq], the CTA's half of dw / dsc,
    the exchange of g [2], 8 reduction slots (then aligned to 16 bytes), 8
    x 256 partial sums and the dq and dv exchanges [2, A], fp32."""
    o = 2 * A + Dv + Hq + -(-S // 2) + 2 + 8
    return ((o + 3) // 4 * 4 + 8 * 256 + 4 * A) * 4


def av_align_fwd_smem(H: int, Dc: int, A: int, S: int, Dv: int, rows_per_cta: int) -> int:
    """Shared memory per CTA of K8's cluster forward (``csrc/av_align_fwd.cuh``
    ``Layout``) at 1 or 2 rows per CTA, bytes: the resident [H + Dc, H/4]
    slice of [Wh ; ctx_proj], wq's A/16 columns, two bf16 h tiles [16 rpc,
    H], the ctx tile [16 rpc, Dc], at one row a CTA the second k half's
    fp32 partials (4 KB per unit group of 8), the cell threads' next xw (2 KB
    per unit group and m-tile); per row read, q, v, the context carry,
    the scores, 8 reduction slots and 2,048 partial sums (fp32) and its
    staged bf16 context [Dc]; 3 + rpc mbarriers."""
    def up16(x):
        return (x + 15) // 16 * 16

    C, nw, rpc = ALIGN_CLUSTER, H // 128, rows_per_cta
    row = up16((2 * A + Dv + (S + 3) // 4 * 4 + 8 + 8 * 256) * 4 + 2 * Dc)
    return (2 * nw * (H + Dc) * 32 + 2 * (A // 128) * H * 8 + 2 * 2 * C * rpc * H
            + 2 * C * rpc * Dc + (4096 * nw if rpc == 1 else 0) + 2048 * rpc * nw + rpc * row
            + 8 * (3 + rpc))


def av_align_family(H: int, Dc: int, A: int, S: int, Dv: int,
                    dtype: torch.dtype = torch.bfloat16) -> str:
    """The kernels that run K8's forward at these widths (Dc = 0 without
    input feeding, else Dv; A the key width) on ``dtype`` operands:
    "cluster", one persistent launch of 16-CTA thread-block clusters per
    call (``csrc/av_align_fwd.cuh``), where the operands are bf16, H is 128
    or 256 (one or two groups of 8 units a CTA), Dc = Dv is a multiple of 64
    (a swizzled ctx tile; input feeding), A a multiple of 128 (whole n-tiles
    of q a CTA) and one row a CTA fits a CTA's shared memory (every
    preset's and uni-Luong's widths); else "step", the per-step kernels
    (``csrc/av_align_scan.cu``), every fp32 call among them (the fp32
    policy's instance).  Chosen by shape and type alone, never after a
    failure; other shapes raise."""
    if (H < LSTM_UNIT_TILE or H % LSTM_UNIT_TILE or A < 8 or A % 8 or A > 512
            or Dv < LSTM_UNIT_TILE or Dv % LSTM_UNIT_TILE or Dv > 2048 or Dc not in (0, Dv)):
        raise ValueError(f"av_align scan: H={H}, Dc={Dc}, A={A}, Dv={Dv}; the kernels take H and "
                         f"Dv multiples of {LSTM_UNIT_TILE}, Dv at most 2048, A a multiple of 8 "
                         f"up to 512 and Dc 0 or Dv")
    if not 1 <= S <= FUSION_MAX_TV:
        raise ValueError(f"av_align scan: T_v={S}; the kernels take 1 <= T_v <= {FUSION_MAX_TV}")
    if dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"av_align scan: the kernels take bf16 or fp32 operands, got {dtype}")
    f32 = dtype == torch.float32
    if (not f32 and H in (128, 256) and Dc == Dv and Dv % 64 == 0 and A % 128 == 0
            and av_align_fwd_smem(H, Dc, A, S, Dv, 1) <= SMEM_LIMIT):
        return "cluster"
    smem = av_align_step_smem(H, Dc, A, S, 4 if f32 else 2)
    if smem > SMEM_LIMIT:
        raise ValueError(f"av_align scan: H={H}, Dc={Dc}, A={A}, T_v={S} need {smem} bytes "
                         f"of shared memory per block (limit {SMEM_LIMIT})")
    return "step"


@functools.lru_cache(maxsize=None)
def _fwd_max_active(H: int, Dc: int, A: int, S: int, Dv: int, dot: bool, rpc: int) -> int:
    return int(_load().avsr_av_align_fwd_max_active(H, Dc, A, S, Dv, int(dot), rpc))


def av_align_fwd_rows_per_cta(B: int, H: int, Dc: int, A: int, S: int, Dv: int,
                              dot: bool) -> int:
    """Batch rows per CTA of K8's cluster forward: 1 while its 16-row
    clusters of 16 CTAs all fit the card at once, else 2 where the layout
    fits (32-row clusters, each CTA reading two rows on thread sets of its
    own; at B = 128 the card holds 7 of the 8 clusters one row a CTA needs).
    Chosen by shape and occupancy alone."""
    if (-(-B // ALIGN_CLUSTER) <= _fwd_max_active(H, Dc, A, S, Dv, dot, 1)
            or av_align_fwd_smem(H, Dc, A, S, Dv, 2) > SMEM_LIMIT):
        return 1
    return 2


def cluster_align_weights(wh: torch.Tensor, ctx_proj: Optional[torch.Tensor]) -> torch.Tensor:
    """[H, 4H] Wh and [Dc, 4H] ctx_proj -> [16, H/128, H + Dc, 32], the
    layout K8's cluster forward reads: [r, g, k, 8q + j] = [Wh ;
    ctx_proj][k, q*H + r*H/16 + 8g + j], so CTA r's slice (its H/16 units'
    four gates over all H + Dc inputs) is one contiguous run, a [K, 32] block
    per group of 8 units whose 16-byte chunks are its gates
    (``csrc/av_align_fwd.cuh``)."""
    w = wh if ctx_proj is None else torch.cat([wh, ctx_proj], dim=0)
    K, H = w.shape[0], w.shape[1] // 4
    return (w.view(K, 4, ALIGN_CLUSTER, H // 128, 8).permute(2, 3, 0, 1, 4).contiguous()
            .view(ALIGN_CLUSTER, H // 128, K, 32))


def _check_av_align(wh, b, ctx_proj, wq, v, xw, mask, keys, values):
    """K8's operands, wh, ctx_proj, wq, v and values all bf16 (the bf16
    policy) or all fp32 (the fp32 policy, Bahdanau's read) -> (T, B, H, Dc,
    A, S, Dv, dev, family, dtype)."""
    T, B, H4 = xw.shape
    H = H4 // 4
    S, A = keys.shape[1], keys.shape[2]
    Dv = values.shape[-1]
    dev = xw.device
    dt = _operand_dtype("av_align scan", wh, v is None)
    _check("wh", wh, dt, (H, 4 * H), dev)
    _check("b", b, torch.float32, (4 * H,), dev)
    if ctx_proj is not None:
        _check("ctx_proj", ctx_proj, dt, (Dv, 4 * H), dev)
    _check("wq", wq, dt, (H, A), dev)
    _check_score(v, keys, B, S, A, dev, dt)
    _check("xw", xw, torch.float32, (T, B, 4 * H), dev)
    _check("mask", mask, torch.float32, (T, B), dev)
    _check("values", values, dt, (B, S, Dv), dev)
    if B < 1:
        raise ValueError(f"av_align scan: B={B}; the kernels take B >= 1")
    Dc = Dv if ctx_proj is not None else 0
    family = av_align_family(H, Dc, A, S, Dv, dt)
    return T, B, H, Dc, A, S, Dv, dev, family, dt


def av_align_scan(wh, b, ctx_proj, wq, v, xw, mask, keys, values, mbias, mmask, *,
                  save: bool = False):
    """K8: the AV-Align fusion scan, forward (CUDA); with ``v`` None its
    Luong instance, counted as ``av_align_scan_luong``; with fp32 wh,
    ctx_proj, wq, v and values the fp32 policy's instance (the per-step
    kernels), counted as ``av_align_scan_f32``.

    wh [H,4H] bf16, b [4H] f32, ctx_proj [Dv,4H] bf16 or None (no input
    feeding), wq [H,A] bf16, v [A] bf16 (None: Luong), xw [T,B,4H] f32, mask
    [T,B] f32 (a length mask: 0 or 1); the video memory: keys [B,S,A] f32
    (Luong: the bf16 memory, A its width), values [B,S,Dv] bf16, mbias /
    mmask [B,S] f32 -> (hs [T,B,H], ctxs [T,B,Dv], aligns [T,B,S], hT, cT
    [B,H], ctxT [B,Dv], res), all fp32, from zero initial carries; res is
    (h_res, c_res [T,B,H], ctx_res [T,B,Dv]), the fp32 carries entering each
    step, when ``save`` (the backward's residuals), else None.  Runs on the
    family ``av_align_family`` names: one cluster launch after the weights'
    layout (``cluster_align_weights``), or two launches per step.
    """
    T, B, H, Dc, A, S, Dv, dev, family, dt = _check_av_align(wh, b, ctx_proj, wq, v, xw, mask,
                                                             keys, values)
    _check("mbias", mbias, torch.float32, (B, S), dev)
    _check("mmask", mmask, torch.float32, (B, S), dev)
    lib = _load()

    def empty(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    hs, ctxs, aligns = empty(T, B, H), empty(T, B, Dv), empty(T, B, S)
    res = (empty(T, B, H), empty(T, B, H), empty(T, B, Dv)) if save else None
    res_ptrs = tuple(r.data_ptr() for r in res) if save else (None, None, None)
    stream = torch.cuda.current_stream(dev).cuda_stream
    dot = v is None
    if family == "cluster":
        hT, cT, ctxT = empty(B, H), empty(B, H), empty(B, Dv)
        if T == 0:  # no step: the zero initial carries
            for x in (hT, cT, ctxT):
                x.zero_()
        w = cluster_align_weights(wh, ctx_proj)
        rpc = av_align_fwd_rows_per_cta(B, H, Dc, A, S, Dv, dot)
        err = lib.avsr_av_align_fwd(
            w.data_ptr(), wq.data_ptr(), _ptr(v), b.data_ptr(), xw.data_ptr(), mask.data_ptr(),
            keys.data_ptr(), values.data_ptr(), mbias.data_ptr(), mmask.data_ptr(),
            hs.data_ptr(), ctxs.data_ptr(), aligns.data_ptr(), hT.data_ptr(), cT.data_ptr(),
            ctxT.data_ptr(), *res_ptrs, T, B, H, Dc, A, S, Dv, int(dot), rpc, stream)
    else:
        wh_tiled = tile_lstm_weights(wh[None])[0]
        cp_tiled = None if ctx_proj is None else tile_lstm_weights(ctx_proj[None])[0]
        hbuf = torch.zeros((2, B, H), dtype=torch.float32, device=dev)
        c = torch.zeros((B, H), dtype=torch.float32, device=dev)
        ctxbuf = torch.zeros((2, B, Dv), dtype=torch.float32, device=dev)
        hnew = empty(B, H)
        ptrs = (wh_tiled.data_ptr(), _ptr(cp_tiled), b.data_ptr(), xw.data_ptr(),
                mask.data_ptr(), wq.data_ptr(), _ptr(v), keys.data_ptr(), values.data_ptr(),
                mbias.data_ptr(), mmask.data_ptr(), hbuf.data_ptr(), c.data_ptr(),
                ctxbuf.data_ptr(), hnew.data_ptr(), hs.data_ptr(), ctxs.data_ptr(),
                aligns.data_ptr(), *res_ptrs)
        if dt == torch.float32:
            err = lib.avsr_av_align_scan_f32(*ptrs, T, B, H, Dc, A, S, Dv, stream)
        else:
            err = lib.avsr_av_align_scan(*ptrs, T, B, H, Dc, A, S, Dv, int(dot), stream)
        hT, cT, ctxT = hbuf[T % 2], c, ctxbuf[T % 2]
    _raise_on(err, "av_align_scan launch")
    LAUNCHES[align_counter("av_align_scan", dot, dt)] += 1
    return hs, ctxs, aligns, hT, cT, ctxT, res


def align_counter(name: str, dot: bool, dtype: torch.dtype = torch.bfloat16) -> str:
    """``av_align_scan[_bwd]`` -> the ``LAUNCHES`` entry of a K8 call: the
    Luong instance's ``av_align_scan_luong[_bwd]``, the fp32 policy's
    ``av_align_scan_f32[_bwd]``."""
    tag = "_f32" if dtype == torch.float32 else "_luong" if dot else ""
    return "av_align_scan" + tag + name[len("av_align_scan"):]


def av_align_bwd_smem(H: int, Dc: int, A: int, S: int, Dv: int, dot: bool,
                      rows_per_cta: int = 1) -> int:
    """Shared memory per CTA of K8 backward's cluster recurrence
    (``csrc/av_align_bwd.cuh`` ``Layout``, wq not staged), bytes, at 1 or 2
    batch rows per CTA: the CTA's H + Dc rows of [Wh ; ctx_proj] against
    the 4H gates, the cluster's and the row's bf16 dgates, the saved-carry
    rows, the per-row fp32 scratch (q, v, dq [A]; dctx, dco [Dv]; dquery
    [H]; 8 x 256 partial sums; 8 reduction slots; weights and dsc [S]), for
    Luong the dquery exchange's tiles, and the mbarriers."""
    def up16(x):
        return (x + 15) // 16 * 16

    C, rpc = ALIGN_CLUSTER, rows_per_cta
    K, S4 = 4 * H, (S + 3) // 4 * 4
    fl = 3 * A + 2 * Dv + H + 8 * 256 + 8 + 2 * S4
    total = (H + Dc) // C * K * 2 + C * rpc * K * 2 + rpc * K * 2 + rpc * up16((H + Dc) * 2)
    total += rpc * fl * 4
    if dot:
        total += H // C * A * 2 + C * rpc * A * 2 + rpc * A * 2 + rpc * up16(H * 2)
    return total + 32


def av_align_step_bwd_smem(H: int, A: int, S: int, Dv: int) -> int:
    """Shared memory of the row launch of K8's per-step backward
    (``csrc/av_align_step_bwd.cuh`` ``step_row_smem_bytes``), bytes, in
    either policy: the read's fp32 scratch (q, v [A]; dctx [Dv]; the query
    [H]; dw / dsc [S]; 8 reduction slots; 8 x 256 partial sums) and dquery
    [H].  Its regate and product launches stage fixed chunks (40 and 48 KB
    in bf16; 40 and 32 KB in fp32)."""
    return (2 * A + Dv + 2 * H + S + 8 + 8 * 256) * 4


def av_align_bwd_family(H: int, Dc: int, A: int, S: int, Dv: int, dot: bool,
                        dtype: torch.dtype = torch.bfloat16) -> str:
    """The kernels that run K8's backward at these widths on ``dtype``
    operands: "cluster", the regate, one persistent launch of 16-CTA
    clusters for the recurrence and the memory's sums after it
    (``csrc/av_align_bwd.cuh``), where the operands are bf16, H is a
    multiple of 64 (Luong: 128) up to 512, H + Dc a multiple of 128 up to
    1024, A and Dv multiples of 64 and one row a CTA fits a CTA's shared
    memory (every preset's and uni-Luong's widths); else "step", the
    per-step kernels (``csrc/av_align_step_bwd.cuh``), which take every
    shape the forward takes, every fp32 call among them (the fp32 policy's
    instance).  Chosen by shape and type alone, never after a failure; it
    raises exactly where ``av_align_family`` raises."""
    av_align_family(H, Dc, A, S, Dv, dtype)
    if dtype == torch.float32:
        return "step"
    if (H % (128 if dot else 64) == 0 and H <= 512 and (H + Dc) % (8 * ALIGN_CLUSTER) == 0
            and H + Dc <= 64 * ALIGN_CLUSTER and Dv % 64 == 0 and A % 64 == 0
            and av_align_bwd_smem(H, Dc, A, S, Dv, dot, 1) <= SMEM_LIMIT):
        return "cluster"
    return "step"


def av_align_bwd_info(H: int, Dc: int, A: int, S: int, Dv: int, dot: bool,
                      rows_per_cta: int = 1) -> Dict[str, int]:
    """K8 backward's recurrence at these widths (``csrc/av_align_bwd.cuh``)
    with 1 or 2 batch rows per CTA: its shared memory per CTA in bytes (-1
    for a shape it does not take) and the 16-CTA clusters that can be
    resident at once."""
    lib = _load()
    return {"smem": int(lib.avsr_av_align_bwd_smem(H, Dc, A, S, Dv, int(dot), rows_per_cta)),
            "max_active_clusters": _bwd_max_active(H, Dc, A, S, Dv, bool(dot), rows_per_cta)}


@functools.lru_cache(maxsize=None)
def _bwd_max_active(H: int, Dc: int, A: int, S: int, Dv: int, dot: bool, rpc: int) -> int:
    return int(_load().avsr_av_align_bwd_max_active(H, Dc, A, S, Dv, int(dot), rpc))


def av_align_bwd_rows_per_cta(B: int, H: int, Dc: int, A: int, S: int, Dv: int,
                              dot: bool) -> int:
    """Batch rows per CTA of K8 backward's recurrence: 1 while its 16-row
    clusters of 16 CTAs all fit the card at once, else 2 (32-row clusters:
    one wave of half as many, each CTA running its two rows' reads side by
    side; at B = 128 the card holds 7 of the 8 clusters one row a CTA
    needs) where two rows a CTA fit its shared memory.  Chosen by shape and
    occupancy alone."""
    if (-(-B // 16) <= _bwd_max_active(H, Dc, A, S, Dv, dot, 1)
            or av_align_bwd_smem(H, Dc, A, S, Dv, dot, 2) > SMEM_LIMIT):
        return 1
    return 2


def av_align_scan_bwd_stages(wh, b, ctx_proj, wq, v, xw, mask, keys, values, aligns, h_res,
                             c_res, ctx_res, dhs, dctxs, dhT, dcT, dctxT, *,
                             rows_per_cta: Optional[int] = None):
    """K8 backward as its three stages over buffers allocated here, on the
    route ``av_align_bwd_family`` names: ({"prep", "scan", "sums"},
    finish), where each stage launches on the current stream and raises on
    a CUDA error, and ``finish()`` gives ``av_align_scan_bwd``'s outputs
    once the three have run in order.  The cluster route: "prep" the regate
    and the query launch, "scan" the recurrence, "sums" dkeys and dvalues
    (every output and scratch with ``torch.empty``: each element is
    written).  The step route: "prep" the regate, "scan" the per-step
    launches, which add each step's memory gradients into zeroed buffers
    ("sums" launches nothing).  No stage counts a launch
    (``av_align_scan_bwd`` does); run alone, a stage times its part of the
    call.  Same operands and checks as ``av_align_scan_bwd``;
    ``rows_per_cta`` (1 or 2) is the cluster recurrence's layout, by
    default ``av_align_bwd_rows_per_cta``'s."""
    T, B, H, Dc, A, S, Dv, dev, _, dt = _check_av_align(wh, b, ctx_proj, wq, v, xw, mask, keys,
                                                        values)
    f32 = torch.float32
    _check("aligns", aligns, f32, (T, B, S), dev)
    for name, x, shape in (("h_res", h_res, (T, B, H)), ("c_res", c_res, (T, B, H)),
                           ("ctx_res", ctx_res, (T, B, Dv)), ("dhs", dhs, (T, B, H)),
                           ("dctxs", dctxs, (T, B, Dv)), ("dhT", dhT, (B, H)),
                           ("dcT", dcT, (B, H)), ("dctxT", dctxT, (B, Dv))):
        _check(name, x, f32, shape, dev)
    lib = _load()
    dot = int(v is None)
    family = av_align_bwd_family(H, Dc, A, S, Dv, bool(dot), dt)
    w_all = wh if ctx_proj is None else torch.cat([wh, ctx_proj], dim=0)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def empty(*shape):
        return torch.empty(shape, dtype=f32, device=dev)

    if family == "step":
        if rows_per_cta is not None:
            raise ValueError("av_align scan backward: the per-step route has no rows per CTA")
        wh_tiled = tile_lstm_weights(wh[None])[0]
        cp_tiled = None if ctx_proj is None else tile_lstm_weights(ctx_proj[None])[0]
        # [H+Dc, 4H] -> [(H+Dc)/UT, H, UT, 4]: the layout of the carries' product
        w_all_t = w_all.view(-1, LSTM_UNIT_TILE, H, 4).permute(0, 2, 1, 3).contiguous()
        dh, dc, dctx = dhT.clone(), dcT.clone(), dctxT.clone()
        act, hnew, dxw, dq = empty(T, B, 4 * H), empty(T, B, H), empty(T, B, 4 * H), empty(T, B, A)

        def zeros(*shape):
            return torch.zeros(shape, dtype=f32, device=dev)

        dv_acc = None if dot else zeros(B, A)
        db_acc, dkeys, dvalues = zeros(B, 4 * H), zeros(B, S, A), zeros(B, S, Dv)

        fp32 = dt == f32

        def step_prep():
            prep = lib.avsr_av_align_step_bwd_prep_f32 if fp32 else lib.avsr_av_align_step_bwd_prep
            _raise_on(prep(
                wh_tiled.data_ptr(), _ptr(cp_tiled), b.data_ptr(), xw.data_ptr(),
                h_res.data_ptr(), c_res.data_ptr(), ctx_res.data_ptr(), act.data_ptr(),
                hnew.data_ptr(), T, B, H, Dc, stream), "av_align_scan_bwd prep launch")

        def step_scan():
            ptrs = (w_all_t.data_ptr(), mask.data_ptr(), wq.data_ptr(), _ptr(v), keys.data_ptr(),
                    values.data_ptr(), aligns.data_ptr(), hnew.data_ptr(), act.data_ptr(),
                    c_res.data_ptr(), dhs.data_ptr(), dctxs.data_ptr(), dh.data_ptr(),
                    dc.data_ptr(), dctx.data_ptr(), dxw.data_ptr(), dq.data_ptr(), _ptr(dv_acc),
                    db_acc.data_ptr(), dkeys.data_ptr(), dvalues.data_ptr())
            if fp32:
                err = lib.avsr_av_align_step_bwd_scan_f32(*ptrs, T, B, H, Dc, A, S, Dv, stream)
            else:
                err = lib.avsr_av_align_step_bwd_scan(*ptrs, T, B, H, Dc, A, S, Dv, dot, stream)
            _raise_on(err, "av_align_scan_bwd scan launch")

        def step_finish():
            return dxw, db_acc.sum(dim=0), dq, dv_acc, dkeys, dvalues, hnew

        return {"prep": step_prep, "scan": step_scan, "sums": lambda: None}, step_finish

    if rows_per_cta is None:
        rows_per_cta = av_align_bwd_rows_per_cta(B, H, Dc, A, S, Dv, bool(dot))
    if lib.avsr_av_align_bwd_smem(H, Dc, A, S, Dv, dot, rows_per_cta) < 0:
        raise ValueError(f"av_align scan backward: H={H}, Dc={Dc}, A={A}, Dv={Dv}, T_v={S}: no "
                         f"cluster layout at {rows_per_cta} rows a CTA")
    act, hnew, q = empty(T, B, 4 * H), empty(T, B, H), empty(T, B, A)
    dxw, dq, dsc, dctxp, db_rows = (empty(T, B, 4 * H), empty(T, B, A), empty(T, B, S),
                                    empty(T, B, Dv), empty(B, 4 * H))
    dkeys, dvalues = empty(B, S, A), empty(B, S, Dv)
    dv_part = None if dot else empty(B, -(-S // 32), A)

    def prep():
        _raise_on(lib.avsr_av_align_bwd_prep(
            w_all.data_ptr(), b.data_ptr(), xw.data_ptr(), h_res.data_ptr(),
            c_res.data_ptr(), ctx_res.data_ptr(), wq.data_ptr(), act.data_ptr(), hnew.data_ptr(),
            q.data_ptr(), T, B, H, Dc, A, dot, stream), "av_align_scan_bwd prep launch")

    def scan():
        _raise_on(lib.avsr_av_align_bwd_scan(
            w_all.data_ptr(), wq.data_ptr(), _ptr(v), keys.data_ptr(), values.data_ptr(),
            aligns.data_ptr(), q.data_ptr(), act.data_ptr(), c_res.data_ptr(), mask.data_ptr(),
            dhs.data_ptr(), dctxs.data_ptr(), dhT.data_ptr(), dcT.data_ptr(), dctxT.data_ptr(),
            dxw.data_ptr(), dq.data_ptr(), dsc.data_ptr(), dctxp.data_ptr(), db_rows.data_ptr(),
            T, B, H, Dc, A, S, Dv, dot, rows_per_cta, stream), "av_align_scan_bwd scan launch")

    def sums():
        _raise_on(lib.avsr_av_align_bwd_sums(
            keys.data_ptr(), _ptr(v), aligns.data_ptr(), q.data_ptr(), dsc.data_ptr(),
            dctxp.data_ptr(), dkeys.data_ptr(), dvalues.data_ptr(), _ptr(dv_part), T, B, A, S, Dv,
            dot, stream), "av_align_scan_bwd sums launch")

    def finish():
        return (dxw, db_rows.sum(dim=0), dq, None if dv_part is None else dv_part.sum(dim=1),
                dkeys, dvalues, hnew)

    return {"prep": prep, "scan": scan, "sums": sums}, finish


def av_align_scan_bwd(wh, b, ctx_proj, wq, v, xw, mask, keys, values, aligns, h_res, c_res,
                      ctx_res, dhs, dctxs, dhT, dcT, dctxT):
    """K8: the reverse scan of the fusion's gradient (CUDA); with ``v``
    None its Luong instance, counted as ``av_align_scan_luong_bwd``; with
    fp32 weights and values the fp32 policy's instance (the per-step
    kernels), counted as ``av_align_scan_f32_bwd``.

    The forward's operands (no memory bias or mask: they enter through
    ``aligns`` [T,B,S], the forward's read weights), its saved fp32 carries
    h_res / c_res [T,B,H], ctx_res [T,B,Dv], the cotangents dhs [T,B,H],
    dctxs [T,B,Dv] and dhT, dcT [B,H], dctxT [B,Dv] (fp32) -> (dxw
    [T,B,4H], db [4H], dq [T,B,A], dv_rows [B,A] (None for Luong), dkeys
    [B,S,A], dvalues [B,S,Dv], hnew [T,B,H]), all fp32: dxw is dgates; dq,
    dv_rows and hnew (the recomputed queries) are the factors of dwq and dv,
    and dWh / dctx_proj are products over h_res / ctx_res and dxw, left to
    the caller.  On the route ``av_align_bwd_family`` names: five launches
    (``csrc/av_align_bwd.cuh``: the regate, the queries, the recurrence in
    one launch of thread-block clusters and the memory's two gradients,
    summed over the steps after the scan), or the per-step kernels
    (``csrc/av_align_step_bwd.cuh``: the regate, then two launches a step).
    """
    stages, finish = av_align_scan_bwd_stages(wh, b, ctx_proj, wq, v, xw, mask, keys, values,
                                              aligns, h_res, c_res, ctx_res, dhs, dctxs, dhT,
                                              dcT, dctxT)
    for name in ("prep", "scan", "sums"):
        stages[name]()
    LAUNCHES[align_counter("av_align_scan_bwd", v is None, wh.dtype)] += 1
    return finish()


def _check_bahdanau(what, query, wq, v, keys, values, smem_fn, *smem_args):
    """The operands both K10 launches share (either score): N query rows
    over a memory of B rows (keys and values [B, S, *], N a multiple of B),
    their limits and the shared memory that the row kernel's ``smem_fn(Hq,
    A, S, *smem_args)`` asks (the library is loaded only once the operands
    pass): (N, Hq, S, A, Dv, dev, dtype), wq, v and values all in the
    compute dtype (bf16, or fp32 for the fp32 policy's Bahdanau read)."""
    N, Hq = query.shape
    B, S, A = keys.shape
    Dv = values.shape[-1]
    dev = query.device
    dt = _operand_dtype(what, wq, v is None)
    _check("query", query, torch.float32, (N, Hq), dev)
    _check("wq", wq, dt, (Hq, A), dev)
    _check_score(v, keys, B, S, A, dev, dt)
    _check("values", values, dt, (B, S, Dv), dev)
    _check_attend_shape(what, N, B, S, A, Dv)
    smem = getattr(_load(), smem_fn)(Hq, A, S, *smem_args)
    if smem > SMEM_LIMIT:
        raise ValueError(f"{what}: Hq={Hq}, A={A}, S={S}, Dv={Dv} need {smem} bytes of "
                         f"shared memory per block (limit {SMEM_LIMIT})")
    return N, Hq, S, A, Dv, dev, dt


def _check_attend_shape(what, N, B, S, A, Dv):
    if N < 1 or B < 1 or N % B:
        raise ValueError(f"{what}: {N} query rows over {B} memory rows; N must be a positive "
                         f"multiple of B")
    if A % 8 or A > 512 or Dv % 8 or Dv > 2048:
        raise ValueError(f"{what}: A={A} must be a multiple of 8 up to 512, "
                         f"Dv={Dv} a multiple of 8 up to 2048")
    if not 1 <= S <= ATTEND_MAX_S:
        raise ValueError(f"{what}: S={S}, N={N}; the kernel takes 1 <= S <= {ATTEND_MAX_S}")


# K10's grouped read (``csrc/attend_grouped.cuh``, "grouped"): a cluster of C
# CTAs of 512 threads per memory row, the W queries of the row as one 16-row
# strip on the tensor cores
ATTEND_GROUP_MAX_W = 16     # beams a memory row: one strip of the tensor cores
ATTEND_GROUP_CLUSTERS = (1, 2, 4, 8, 16)  # CTAs a cluster (16: the non-portable size)
# Clusters of C such CTAs (one an SM: 512 threads of ~85 registers) that an
# H100 SXM holds at once, by C (cudaOccupancyMaxActiveClusters on the card;
# chip_smoke fails where the library's count differs): a GPC places a
# cluster, and fewer GPCs than 132 / 16 have 16 free SMs
ATTEND_GROUP_WAVE = {1: 132, 2: 66, 4: 30, 8: 15, 16: 7}


def attend_grouped_units(S: int, A: int, Dv: int, C: int, dot: bool) -> int:
    """The 16 x 16 fp32 units of partial sums a CTA of K10's grouped read
    holds (``Layout`` in ``csrc/attend_grouped.cuh``): a strip product over
    ng 16-column groups splits its k steps over up to 16 // ng of the 16
    warps, so it writes ng * (16 // ng) <= 16 units for ng < 16 and ng past
    that; ng is at most qg / vg (q's / the values' column groups of the CTA
    that owns the most) or, for Luong's scores, the longest key chunk's."""
    SCP = -(-(-(-S // C)) // 16) * 16
    return max(16, -(-(A // 16) // C), -(-(Dv // 16) // C), SCP // 16 if dot else 0)


def attend_grouped_smem(W: int, S: int, Hq: int, A: int, Dv: int, C: int, dot: bool) -> int:
    """Shared memory of a CTA of K10's grouped read (``Layout`` in
    ``csrc/attend_grouped.cuh``) over W queries, S keys and a cluster of C
    CTAs, bytes: bf16(query) [16, Hq + 8], wq's columns [Hq, 16 qg + 8] bf16,
    q [W, A] fp32 (Luong: bf16 [16, A + 8]), v [A] fp32 (Bahdanau), the key
    chunk [SC, A] fp32 and its e^2k, e^2q [W, A] (Luong: bf16 [SCP, A + 8]),
    bias and mask [S_pad],
    the scores [S_pad, Wp] fp32 (Wp: W rounded up to 4), bf16(P) [16, S_pad
    + 8], the value columns [S_pad, 16 vg + 8] bf16, the products' partial
    sums (``attend_grouped_units`` units of 16 x 16 fp32) and two mbarriers;
    qg / vg the most 16-column groups of q / the values a CTA owns, SC the
    longest key chunk (SCP rounded up to 16)."""
    def up16(x):
        return (x + 15) // 16 * 16

    S_pad, SC = up16(S), -(-S // C)
    SCP, qg, vg = up16(SC), -(-(A // 16) // C), -(-(Dv // 16) // C)
    part = attend_grouped_units(S, A, Dv, C, dot) * 16 * 16 * 4
    q = 16 * (A + 8) * 2 if dot else W * A * 4 + A * 4
    keys = SCP * (A + 8) * 2 if dot else 2 * SC * A * 4 + W * A * 4  # + e^2k, e^2q
    return (16 * (Hq + 8) * 2 + Hq * (16 * qg + 8) * 2 + q + keys + 2 * S_pad * 4
            + S_pad * -(-W // 4) * 4 * 4 + 16 * (S_pad + 8) * 2 + S_pad * (16 * vg + 8) * 2 + part
            + 16)  # the two mbarriers


def attend_grouped_cluster(B: int, W: int, S: int, Hq: int, A: int, Dv: int, dot: bool) -> int:
    """C, the CTAs of K10's grouped read per memory row (a cluster): the most
    whose B clusters fit in one wave (``ATTEND_GROUP_WAVE``), among those
    whose CTA fits in shared memory (else the fewest that fit); 0 where none
    fits or the shape is not the kernel's (W from 1 to
    ``ATTEND_GROUP_MAX_W``, Hq, A and Dv multiples of 16, S up to 768)."""
    if not (1 <= W <= ATTEND_GROUP_MAX_W and Hq >= 16 and Hq % 16 == 0 and A % 16 == 0
            and 16 <= A <= 512 and Dv % 16 == 0 and 16 <= Dv <= 2048 and B >= 1
            and 1 <= S <= 768):
        return 0
    fits = [c for c in ATTEND_GROUP_CLUSTERS
            if attend_grouped_smem(W, S, Hq, A, Dv, c, dot) <= SMEM_LIMIT]
    if not fits:
        return 0
    wave = [c for c in fits if B <= ATTEND_GROUP_WAVE[c]]
    return max(wave) if wave else min(fits)


# K10's row read (``csrc/attend_row.cuh``, "row"): a CTA a query row, 512
# threads that compute and a producer warp that streams the memory row
# through a ring of slots of shared memory by bulk copies; clusters of two
# CTAs (one where N is odd) split q's columns
ATTEND_ROW_CLUSTER = 2
ATTEND_ROW_CONSUMERS = 512  # CONSUMERS
ATTEND_ROW_SLOTS = 8        # chunks of the row in flight or in use (SLOTS)
ATTEND_ROW_SLOT = 25600     # bytes a slot (SLOT): Luong's 197 x 512 bf16 row in 8 slots
ATTEND_ROW_MAX_HQ = 1024    # MAX_HQ, MAX_S: two values a consumer
ATTEND_ROW_MAX_S = 1024


def attend_row_plan(S: int, A: int, Dv: int, dot: bool, same: bool) -> Dict[str, int]:
    """The chunks of K10's row read (``Layout`` in ``csrc/attend_row.cuh``):
    ``kc`` / ``vc`` keys a chunk of the keys' / the values' pass and ``nk``
    / ``nv`` chunks of each; ``nv`` 0 where the keys are the values
    (``same``: Luong's one tensor) and the row fits in the ring, whose
    context then reads the keys' chunks again (the row read once)."""
    kb, vb = A * (2 if dot else 4), Dv * 2
    kc, vc = min(S, ATTEND_ROW_SLOT // kb), min(S, ATTEND_ROW_SLOT // vb)
    if same and S <= ATTEND_ROW_SLOTS * kc:
        kc = vc = -(-S // ATTEND_ROW_SLOTS)
        return {"kc": kc, "vc": vc, "nk": -(-S // kc), "nv": 0}
    return {"kc": kc, "vc": vc, "nk": -(-S // kc), "nv": -(-S // vc)}


def attend_row_smem(Hq: int, A: int, S: int, Dv: int, dot: bool) -> int:
    """Shared memory of a CTA of K10's row read (``Layout`` in
    ``csrc/attend_row.cuh``), bytes: the ring [SLOTS, SLOT] (q's partial sums
    first, the context's after its last chunk), q [A] fp32, v [A] fp32
    (Bahdanau), the cluster's two bf16(query) [2, Hq] fp32, the scores,
    bias and mask [S] fp32 each (every region rounded up to 16 bytes), the
    reductions' slots [2 x 16 consumer warps], the slots' full and empty
    mbarriers and two more (q's partial sums read, the other CTA's columns
    of q landed)."""
    def up16(x):
        return (x + 15) // 16 * 16

    return (ATTEND_ROW_SLOTS * ATTEND_ROW_SLOT + up16(4 * A) + (0 if dot else up16(4 * A))
            + up16(8 * Hq) + 3 * up16(4 * S) + 2 * (ATTEND_ROW_CONSUMERS // 32) * 4
            + (2 * ATTEND_ROW_SLOTS + 2) * 8)


def attend_row_info(Hq: int, A: int, S: int, Dv: int, dot: bool) -> Dict[str, int]:
    """K10's row read as built: a CTA's shared memory (the library's
    ``Layout``; -1 for a shape it does not take) and the clusters of
    ``ATTEND_ROW_CLUSTER`` CTAs that can be resident at once."""
    lib = _load()
    return {"smem": int(lib.avsr_attend_row_smem(Hq, A, S, Dv, int(dot))),
            "max_active_clusters": int(lib.avsr_attend_row_max_active(Hq, A, S, Dv, int(dot)))}


def attend_row_admits(Hq: int, A: int, S: int, Dv: int, dot: bool) -> bool:
    """Whether K10's row read takes these widths: Hq, A and Dv multiples of
    16 (Hq up to 1024, A up to 512, Dv up to 2048), S up to 1024, and a CTA
    within a block's shared memory (``attend_row_smem``)."""
    return (1 <= S <= ATTEND_ROW_MAX_S and 16 <= Hq <= ATTEND_ROW_MAX_HQ and Hq % 16 == 0
            and A % 16 == 0 and 16 <= A <= 512
            and Dv % 16 == 0 and 16 <= Dv <= 2048
            and attend_row_smem(Hq, A, S, Dv, dot) <= SMEM_LIMIT)


def attend_route(N: int, B: int, S: int, Hq: int, A: int, Dv: int, dot: bool,
                 dtype: torch.dtype = torch.bfloat16) -> str:
    """The kernel that runs K10 for N query rows over a memory of B rows
    (W = N / B beams a row): "grouped", a beam step's read, W from 2 to
    ``ATTEND_GROUP_MAX_W`` at widths that are multiples of 16 while a
    cluster's CTAs hold the row (``attend_grouped_cluster``): each key and
    value row read once for the W queries; "row", one query a memory row (W
    = 1: greedy and the teacher-forced loop) at widths the row read takes
    (``attend_row_admits``): a CTA a row streaming it through shared memory
    (where the grouped read measured 2.3-3.2x slower than a block per
    query row on the H100); "general", every other shape the wrapper takes
    (widths that are not multiples of 16, more than 16 beams): a block of
    256 threads per query row (``bahdanau_core.cuh``'s read).  The grouped
    read also beat the general kernel on the H100 where its clusters take
    two or more waves (8 rows of 16 CTAs over the 16 s memory, 32 rows at S
    = 197), so W >= 2 takes it at every shape it holds.  fp32 operands (the
    fp32 policy's instance) take "general" at every shape: the grouped and
    row reads stage bf16 tiles.  Chosen by shape and type alone, never
    after a failure."""
    _check_attend_shape("attend", N, B, S, A, Dv)
    if dtype == torch.float32:
        return "general"
    W = N // B
    if W >= 2 and attend_grouped_cluster(B, W, S, Hq, A, Dv, dot) > 0:
        return "grouped"
    if W == 1 and attend_row_admits(Hq, A, S, Dv, dot):
        return "row"
    return "general"


def attend_grouped_info(W: int, S: int, Hq: int, A: int, Dv: int, C: int,
                        dot: bool) -> Dict[str, int]:
    """K10's grouped read as built: a CTA's shared memory (the library's
    ``Layout``) and the clusters of C CTAs that can be resident at once."""
    lib = _load()
    return {"smem": int(lib.avsr_attend_grouped_smem(W, S, Hq, A, Dv, C, int(dot))),
            "max_active_clusters": int(lib.avsr_attend_grouped_max_active(
                W, S, Hq, A, Dv, C, int(dot)))}


def bahdanau_attend(query, wq, v, keys, values, bias, mask):
    """K10: the attention read (CUDA): Bahdanau, or with ``v`` None Luong;
    the grouped read counted as ``bahdanau_attend_grouped`` /
    ``luong_attend_grouped``, the row read as ``bahdanau_attend_row`` /
    ``luong_attend_row``, the general kernel as ``bahdanau_attend`` /
    ``luong_attend``.

    query [N,Hq] f32, wq [Hq,A] bf16, v [A] bf16 (None: Luong), and a
    memory of B rows, N = B W: keys [B,S,A] f32 (Luong: the bf16 memory, A
    its width), values [B,S,Dv] bf16, bias / mask [B,S] f32; query row n
    reads memory row n // W -> (ctx [N,Dv] f32, weights [N,S] f32; a row
    whose every position is masked gets zeros in both).  The kernel by
    ``attend_route``.  With wq, v and values fp32 (the fp32 policy) the
    general kernel's fp32 instance, counted as ``bahdanau_attend_f32``.
    """
    N, Hq, S, A, Dv, dev, dt = _check_bahdanau("bahdanau attend", query, wq, v, keys, values,
                                               "avsr_bahdanau_smem")
    B = keys.shape[0]
    _check("bias", bias, torch.float32, (B, S), dev)
    _check("mask", mask, torch.float32, (B, S), dev)
    dot = v is None
    route = attend_route(N, B, S, Hq, A, Dv, dot, dt)
    lib = _load()
    ctx = torch.empty((N, Dv), dtype=torch.float32, device=dev)
    weights = torch.empty((N, S), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    args = (query.data_ptr(), wq.data_ptr(), _ptr(v), keys.data_ptr(), values.data_ptr(),
            bias.data_ptr(), mask.data_ptr(), ctx.data_ptr(), weights.data_ptr())
    if route == "grouped":
        C = attend_grouped_cluster(B, N // B, S, Hq, A, Dv, dot)
        err = lib.avsr_attend_grouped(*args, B, N // B, Hq, A, S, Dv, C, int(dot), stream)
    elif route == "row":
        err = lib.avsr_attend_row(*args, N, N // B, Hq, A, S, Dv, int(dot), stream)
    elif dt == torch.float32:
        err = lib.avsr_bahdanau_attend_f32(*args, N, N // B, Hq, A, S, Dv, stream)
    else:
        err = lib.avsr_bahdanau_attend(*args, N, N // B, Hq, A, S, Dv, int(dot), stream)
    _raise_on(err, f"bahdanau_attend ({route}) launch")
    LAUNCHES[attend_counter(route, dot, dt)] += 1
    return ctx, weights


def attend_counter(route: str, dot: bool, dtype: torch.dtype = torch.bfloat16) -> str:
    """The ``LAUNCHES`` entry of a K10 forward launch on ``route``
    (``bahdanau_attend_f32`` for the fp32 policy's general kernel)."""
    if dtype == torch.float32:
        return "bahdanau_attend_f32"
    return (("luong_attend" if dot else "bahdanau_attend")
            + {"grouped": "_grouped", "row": "_row", "general": ""}[route])


def attend_bwd_info(Hq: int, A: int, S: int, Dv: int, dot: bool) -> Dict[str, int]:
    """K10's per-step backward at these widths: its shared memory per CTA in
    bytes (-1 for a shape it does not take) and the clusters (rows, two CTAs
    each) that can be resident at once."""
    lib = _load()
    return {"smem": int(lib.avsr_attend_step_bwd_smem(Hq, A, S, Dv)),
            "max_active_clusters": int(lib.avsr_attend_step_bwd_max_active(
                Hq, A, S, Dv, int(dot)))}


def attend_step_bwd(query, wq, v, keys, values, weights, dctx, dsc, dctx_out, q, dq, dv):
    """K10: one step of the read loop's backward (CUDA), Bahdanau, or with
    ``v`` None Luong, counted as ``luong_attend_bwd``.

    The forward's query [N,Hq] f32, wq [Hq,A] bf16, v [A] bf16 (None:
    Luong), keys [N,S,A] (f32; Luong bf16), values [N,S,Dv] bf16, its
    weights [N,S] f32 and the context cotangent dctx [N,Dv] f32 -> dquery
    [N,Hq] f32; writes the step's rows (slot k of the loop's buffers, each
    contiguous fp32): dsc [N,S], dctx_out [N,Dv], q [N,A] (Luong: bf16(q)),
    dq [N,A] and dv [N,A] (None for Luong).  No memory-sized gradient.  A
    cluster of two CTAs a row.  With wq, v and values fp32 (the fp32
    policy) its fp32 instance, counted as ``bahdanau_attend_f32_bwd``.
    """
    if keys.shape[0] != query.shape[0]:
        raise ValueError(f"attend step bwd: a memory row per query row, got {query.shape[0]} "
                         f"queries over {keys.shape[0]} rows")
    N, Hq, S, A, Dv, dev, dt = _check_bahdanau("attend step bwd", query, wq, v, keys, values,
                                               "avsr_bahdanau_smem")
    f32 = torch.float32
    _check("weights", weights, f32, (N, S), dev)
    _check("dctx", dctx, f32, (N, Dv), dev)
    for name, x, shape in (("dsc", dsc, (N, S)), ("dctx_out", dctx_out, (N, Dv)),
                           ("q", q, (N, A)), ("dq", dq, (N, A))):
        _check(name, x, f32, shape, dev, align=4)
    if (v is None) != (dv is None):
        raise ValueError("attend step bwd: dv rows go with v (Bahdanau) and only with it")
    if dv is not None:
        _check("dv", dv, f32, (N, A), dev, align=4)
    lib = _load()
    if lib.avsr_attend_step_bwd_smem(Hq, A, S, Dv) < 0:
        raise ValueError(f"attend step bwd: Hq={Hq}, A={A}, S={S}, Dv={Dv} is not a shape the "
                         f"kernel takes")
    dquery = torch.empty((N, Hq), dtype=f32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptrs = (query.data_ptr(), wq.data_ptr(), _ptr(v), keys.data_ptr(), values.data_ptr(),
            weights.data_ptr(), dctx.data_ptr(), dquery.data_ptr(), dsc.data_ptr(),
            dctx_out.data_ptr(), q.data_ptr(), dq.data_ptr(), _ptr(dv))
    if dt == f32:
        err = lib.avsr_attend_step_bwd_f32(*ptrs, N, Hq, A, S, Dv, stream)
        counter = "bahdanau_attend_f32_bwd"
    else:
        err = lib.avsr_attend_step_bwd(*ptrs, N, Hq, A, S, Dv, int(v is None), stream)
        counter = "bahdanau_attend_bwd" if v is not None else "luong_attend_bwd"
    _raise_on(err, "attend_step_bwd launch")
    LAUNCHES[counter] += 1
    return dquery


def attend_sums_family(A: int, Dv: int, dtype: torch.dtype = torch.bfloat16) -> str:
    """The route of a read loop's memory sums, by width and type alone: the
    tensor-core sums of ``av_align_bwd.cuh`` (``"tensor_core"``) where the
    operands are bf16 and A and Dv are multiples of 64, else the CUDA-core
    kernel of ``bahdanau_attend.cu`` (``"cuda_core"``; every fp32 loop, the
    fp32 policy's instance)."""
    if dtype == torch.float32:
        return "cuda_core"
    return "tensor_core" if A % 64 == 0 and Dv % 64 == 0 else "cuda_core"


def attend_loop_sums(keys, v, weights, q, dsc, dctx):
    """K10: the memory's gradients of a read loop of K steps (CUDA), once
    after its last step; Bahdanau, or with ``v`` None Luong, counted as
    ``luong_attend_sums``.

    keys [N,S,A] (f32; Luong bf16, unused), v [A] bf16 (None: Luong), and
    the loop's rows: the forward's weights [K,N,S], q [K,N,A] (Luong:
    bf16(q)), dsc [K,N,S], dctx [K,N,Dv], all f32 -> (dkeys [N,S,A], dvalues
    [N,S,Dv]) f32, each element written once: the steps' terms summed in a
    fixed order.  Routed by ``attend_sums_family``.  With an fp32 v (the
    fp32 policy) the CUDA-core kernel's fp32 instance, counted as
    ``bahdanau_attend_f32_sums``.
    """
    K, N, S = weights.shape
    A, Dv = q.shape[-1], dctx.shape[-1]
    dev = weights.device
    f32 = torch.float32
    dt = torch.bfloat16 if v is None else _operand_dtype("attend loop sums", v, False)
    _check("keys", keys, f32 if v is not None else torch.bfloat16, (N, S, A), dev)
    if v is not None:
        _check("v", v, dt, (A,), dev)
    for name, x, shape in (("weights", weights, (K, N, S)), ("q", q, (K, N, A)),
                           ("dsc", dsc, (K, N, S)), ("dctx", dctx, (K, N, Dv))):
        _check(name, x, f32, shape, dev)
    if A % 8 or Dv % 8:
        raise ValueError(f"attend loop sums: A={A} and Dv={Dv} must be multiples of 8")
    lib = _load()
    dkeys = torch.empty((N, S, A), dtype=f32, device=dev)
    dvalues = torch.empty((N, S, Dv), dtype=f32, device=dev)
    dot = int(v is None)
    stream = torch.cuda.current_stream(dev).cuda_stream
    counter = "bahdanau_attend_sums" if v is not None else "luong_attend_sums"
    if dt == f32:
        err = lib.avsr_attend_loop_sums_f32(
            keys.data_ptr(), v.data_ptr(), weights.data_ptr(), q.data_ptr(), dsc.data_ptr(),
            dctx.data_ptr(), dkeys.data_ptr(), dvalues.data_ptr(), K, N, A, S, Dv, stream)
        counter = "bahdanau_attend_f32_sums"
    elif attend_sums_family(A, Dv) == "tensor_core":
        dv_part = None if dot else torch.empty((N, -(-S // 32), A), dtype=f32, device=dev)
        err = lib.avsr_av_align_bwd_sums(
            keys.data_ptr(), _ptr(v), weights.data_ptr(), q.data_ptr(), dsc.data_ptr(),
            dctx.data_ptr(), dkeys.data_ptr(), dvalues.data_ptr(), _ptr(dv_part), K, N, A, S, Dv,
            dot, stream)
    else:
        err = lib.avsr_attend_loop_sums(
            keys.data_ptr(), _ptr(v), weights.data_ptr(), q.data_ptr(), dsc.data_ptr(),
            dctx.data_ptr(), dkeys.data_ptr(), dvalues.data_ptr(), K, N, A, S, Dv, dot, stream)
    _raise_on(err, "attend_loop_sums launch")
    LAUNCHES[counter] += 1
    return dkeys, dvalues


def _check_encoder_attention(qkv, lengths, dev):
    B, T, _, nh, dh = qkv.shape
    _check("qkv", qkv, torch.bfloat16, (B, T, 3, nh, dh), dev)
    _check("lengths", lengths, torch.int32, (B,), dev, align=4)
    if not 1 <= T <= ATTEND_MAX_S:
        raise ValueError(f"encoder attention: T={T}; the kernel takes 1 <= T <= {ATTEND_MAX_S}")
    family = attention_family("encoder_attention", dh, dh)
    if family == "core":
        _check_core("encoder attention", T, T, dh, dh)
    else:
        smem = _load().avsr_encoder_attn_smem(T, dh)
        if smem > SMEM_LIMIT:
            raise ValueError(f"encoder attention: T={T}, dh={dh} need {smem} bytes of shared "
                             f"memory per block (limit {SMEM_LIMIT})")
    return B, T, nh, dh, family


def encoder_attention_fwd(qkv, lengths, *, save: bool = False):
    """K11: the transformer encoder's self-attention core, forward (CUDA).

    qkv [B,T,3,nh,dh] bf16 (the one [d, 3d] product, read in place as the
    q, k and v views), lengths [B] int32 (the keys' valid counts) -> (ctx
    [B,T,nh,dh] bf16, the backward's residual when ``save``, else None): at
    dh = 64, on the tensor cores, the softmax's row statistics (row_max,
    row_sum), fp32 [B,nh,T] each; at another multiple of 8, on the CUDA-core
    route (``attention_family``), the fp32 weights [B,nh,T,T], a one-tuple.
    """
    dev = qkv.device
    B, T, nh, dh, family = _check_encoder_attention(qkv, lengths, dev)
    lib = _load()
    ctx = torch.empty((B, T, nh, dh), dtype=torch.bfloat16, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    if family == "core":
        P = torch.empty((B, nh, T, T), dtype=torch.float32, device=dev) if save else None
        err = lib.avsr_encoder_attn_core_fwd(qkv.data_ptr(), lengths.data_ptr(), _ptr(P),
                                             ctx.data_ptr(), B, T, nh, dh, stream)
        res = (P,) if save else None
    else:
        res = tuple(torch.empty((B, nh, T), dtype=torch.float32, device=dev)
                    for _ in range(2)) if save else None
        err = lib.avsr_encoder_attn_fwd(qkv.data_ptr(), lengths.data_ptr(),
                                        *((None, None) if res is None else map(_ptr, res)),
                                        ctx.data_ptr(), B, T, nh, dh, stream)
    _raise_on(err, "encoder_attention_fwd launch")
    LAUNCHES["encoder_attention_fwd"] += 1
    return ctx, res


def encoder_attention_bwd(qkv, lengths, row_max, row_sum, dctx):
    """K11: the transformer encoder's self-attention core, backward (CUDA,
    tensor cores).

    The forward's qkv [B,T,3,nh,64] bf16, lengths [B] int32 and saved row
    statistics (fp32 [B,nh,T] each), and the context cotangent dctx
    [B,T,nh,64] bf16 -> dqkv [B,T,3,nh,64] bf16, the cotangent of the
    [d, 3d] product (dq, dk and dv written in place into its three views).
    The weights are recomputed from the statistics; the only scratch is
    D = rowsum(dP * P), fp32 [B,nh,T].  Other head widths take
    ``encoder_attention_bwd_core``.
    """
    dev = qkv.device
    B, T, nh, dh, family = _check_encoder_attention(qkv, lengths, dev)
    if family != "mma":
        raise ValueError(f"encoder attention: no tensor-core instance at dh={dh}; its backward "
                         f"reads the weights (encoder_attention_bwd_core)")
    _check("row_max", row_max, torch.float32, (B, nh, T), dev, align=4)
    _check("row_sum", row_sum, torch.float32, (B, nh, T), dev, align=4)
    _check("dctx", dctx, torch.bfloat16, (B, T, nh, dh), dev)
    lib = _load()
    D = torch.empty((B, nh, T), dtype=torch.float32, device=dev)
    dqkv = torch.empty_like(qkv)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.avsr_encoder_attn_bwd(qkv.data_ptr(), lengths.data_ptr(), row_max.data_ptr(),
                                    row_sum.data_ptr(), dctx.data_ptr(), D.data_ptr(),
                                    dqkv.data_ptr(), B, T, nh, dh, stream)
    _raise_on(err, "encoder_attention_bwd launch")
    LAUNCHES["encoder_attention_bwd"] += 1
    return dqkv


def encoder_attention_bwd_core(qkv, lengths, weights, dctx):
    """K11's backward on the CUDA-core route (head widths with no
    tensor-core instance): the forward's qkv, lengths and fp32 weights
    [B,nh,T,T], and dctx [B,T,nh,dh] bf16 -> dqkv [B,T,3,nh,dh] bf16; the
    scratch is the scores' cotangent, bf16 [B,nh,T,T]."""
    dev = qkv.device
    B, T, nh, dh, _ = _check_encoder_attention(qkv, lengths, dev)
    _check("weights", weights, torch.float32, (B, nh, T, T), dev)
    _check("dctx", dctx, torch.bfloat16, (B, T, nh, dh), dev)
    lib = _load()
    dsc = torch.empty((B, nh, T, T), dtype=torch.bfloat16, device=dev)
    dqkv = torch.empty_like(qkv)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.avsr_encoder_attn_core_bwd(qkv.data_ptr(), weights.data_ptr(), dctx.data_ptr(),
                                         dsc.data_ptr(), dqkv.data_ptr(), B, T, nh, dh, stream)
    _raise_on(err, "encoder_attention_bwd launch")
    LAUNCHES["encoder_attention_bwd"] += 1
    return dqkv


def _check_conformer_conv(u, b_in, dw, ln_scale, ln_bias, lengths):
    T, B, d2 = u.shape
    d = d2 // 2
    k = dw.shape[0]
    dev = u.device
    _check("u", u, torch.bfloat16, (T, B, 2 * d), dev)
    _check("b_in", b_in, torch.bfloat16, (2 * d,), dev, align=4)
    _check("dw", dw, torch.float32, (k, d), dev, align=8)
    _check("ln_scale", ln_scale, torch.float32, (d,), dev, align=8)
    _check("ln_bias", ln_bias, torch.float32, (d,), dev, align=8)
    _check("lengths", lengths, torch.int32, (B,), dev, align=4)
    if d2 % 4 or not 2 <= d <= CONV_MAX_D or k % 2 == 0 or T < 1 or B < 1:
        raise ValueError(f"conformer conv: u {tuple(u.shape)}, k={k}; the kernel takes an even "
                         f"d up to {CONV_MAX_D}, an odd k and T, B >= 1")
    smem = _load().avsr_conformer_conv_smem(d, k)
    if smem > SMEM_LIMIT:
        raise ValueError(f"conformer conv: d={d}, k={k} need {smem} bytes of shared memory per "
                         f"block (limit {SMEM_LIMIT})")
    return T, B, d, k, dev


def conformer_conv_fwd(u, b_in, dw, ln_scale, ln_bias, lengths, z=None):
    """K9: the conformer conv module between its two pointwise products,
    forward (CUDA); the kernel by ``conformer_fwd_plan``: the pass over
    time counted as ``conformer_conv_fwd``, the tiles as
    ``conformer_conv_fwd_tiles``.

    u [T,B,2d] bf16 (the first pointwise product), b_in [2d] bf16, dw [k,d]
    f32 (the depthwise kernel), ln_scale / ln_bias [d] f32, lengths [B]
    int32 -> [T,B,d] bf16: GLU, mask, depthwise conv, LayerNorm, swish.
    ``z`` (the pass over time only; checks): an f32 [T,B,d] tensor that
    takes LayerNorm's output.
    """
    T, B, d, k, dev = _check_conformer_conv(u, b_in, dw, ln_scale, ln_bias, lengths)
    plan = conformer_fwd_plan(T, B, d, k)
    if z is not None:
        if plan["route"] != "fused":
            raise ValueError("conformer conv: z is written by the pass over time only")
        _check("z", z, torch.float32, (T, B, d), dev)
    lib = _load()
    out = torch.empty((T, B, d), dtype=torch.bfloat16, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    operands = (u.data_ptr(), b_in.data_ptr(), dw.data_ptr(), ln_scale.data_ptr(),
                ln_bias.data_ptr(), lengths.data_ptr(), out.data_ptr())
    if plan["route"] == "fused":
        err = lib.avsr_conformer_conv_fwd_fused(*operands, _ptr(z), T, B, d, k, plan["chunk"],
                                                plan["chunks"], stream)
    else:
        err = lib.avsr_conformer_conv(*operands, T, B, d, k, stream)
    _raise_on(err, f"conformer_conv_fwd ({plan['route']}) launch")
    LAUNCHES["conformer_conv_fwd" if plan["route"] == "fused" else "conformer_conv_fwd_tiles"] += 1
    return out


# K9's fused forward (``csrc/conformer_conv.cu``, ``conv_fwd_fused_kernel``):
# one pass over time per item, a thread per channel, the backward's taps and
# widths
CONV_FWD_CTAS_PER_SM = 2  # FWD_CTAS: blocks an SM holds (64 registers at most, 50 KB at d = 512)
CONV_FWD_ITEMS = CONV_FWD_CTAS_PER_SM * WAVE_BLOCKS  # items of one wave of an H100


def conformer_fwd_fused_smem(d: int) -> int:
    """Shared memory of K9's fused forward at d channels, bytes
    (``FwdLayout``): u's three tiles [BR, 2d] bf16, the two row reductions'
    per-warp partials (2 x 16 warps x BR fp32), three mbarriers (y's window
    is in registers)."""
    rows, bufs = CONV_BWD_ROWS, CONV_BWD_BUFS
    return bufs * rows * 4 * d + 2 * (CONV_BWD_MAX_D // 32) * rows * 4 + bufs * 8


def conformer_fwd_plan(T: int, B: int, d: int, k: int) -> Dict[str, object]:
    """How K9's forward runs at (T, B, d, k), by shape alone: the route
    ("fused", one pass over time per item, at the fused backward's shapes:
    k = 15 and d a multiple of 8 up to 512; "tiles", a block per 16 steps,
    every other shape), its items' chunks of steps (``chunks`` an
    utterance of ``chunk`` steps each, ``chunk`` a multiple of the 8-row
    tile: as many chunks as keep the B utterances' items within one wave of
    ``CONV_FWD_ITEMS``, one where B fills it) and its shared memory
    (bytes)."""
    if k == CONV_BWD_TAPS and d % 8 == 0 and 8 <= d <= CONV_BWD_MAX_D:
        rows = CONV_BWD_ROWS
        nc = max(1, CONV_FWD_ITEMS // B)
        ch = rows * -(-T // (rows * nc))
        return {"route": "fused", "chunks": -(-T // ch), "chunk": ch,
                "smem": conformer_fwd_fused_smem(d)}
    tt = 16  # TT: steps a block of the tiles; their fp32 stage [TT + k - 1, d] and partials
    return {"route": "tiles", "chunks": -(-T // tt), "chunk": tt,
            "smem": (tt + k - 1) * d * 4 + 2 * -(-(d // 2) // 32) * tt * 4}


# K9's fused backward (``csrc/conformer_conv.cu``, ``conv_bwd_fused_kernel``):
# one pass over time per item (utterance, chunk of steps), a thread per
# channel, at every preset's taps and widths up to 512 channels
CONV_BWD_TAPS = 15        # BK: its register windows are sized by the taps
CONV_BWD_MAX_D = 512      # FUSED_MAX_D: a thread a channel
CONV_BWD_ROWS = 8         # BR: rows a tile of the pass
CONV_BWD_BUFS = 3         # NBUF: tiles of rows in flight (two ahead) and in use
CONV_BWD_BLOCKS = 132     # items of one wave: one block an SM of an H100
CONV_BWD_MIN_CH = 16      # the fewest steps of a chunk
CONV_BWD_GENERAL_CH = 64  # CH: steps a block of the general backward's first two launches


def conformer_bwd_fused_smem(d: int) -> int:
    """Shared memory of K9's fused backward at d channels, bytes
    (``FusedLayout``): u's ring of 2 (k/2) + 3 BR rows [2d] bf16, dout's
    three tiles [BR, d] bf16, y's, bf16(sigmoid(gate))'s and dx's rings of
    2 (k/2) + BR rows [d] (bf16, bf16, fp32), the row reductions' per-warp
    partials (4 x 16 warps x BR fp32), three mbarriers."""
    h, rows, bufs = CONV_BWD_TAPS // 2, CONV_BWD_ROWS, CONV_BWD_BUFS
    ring_u, ring_w = 2 * h + bufs * rows, 2 * h + rows
    return (ring_u * 4 * d + bufs * rows * 2 * d + 2 * ring_w * 2 * d + ring_w * 4 * d
            + 4 * (CONV_BWD_MAX_D // 32) * rows * 4 + bufs * 8)


def conformer_general_smem(d: int, k: int) -> int:
    """Shared memory of the largest launch of K9's general backward (and of
    its forward), bytes (``avsr_conformer_conv_smem``): the LayerNorm
    launch's fp32 [16 + k - 1, d] stage and four per-warp [16] partials, or
    the transposed conv's [16 + k - 1, d] stages of fp32 dx and bf16 y."""
    nwarps = -(-(d // 2) // 32)
    return max((16 + k - 1) * d * 4 + 4 * nwarps * 16 * 4, (16 + k - 1) * d * 6)


def conformer_bwd_plan(T: int, B: int, d: int, k: int) -> Dict[str, object]:
    """How K9's backward runs at (T, B, d, k), by shape alone: the route
    ("fused", one pass over time per item and a sum of the items' partial
    rows, at k = 15 and d a multiple of 8 up to 512; "general", the three
    launches, every other shape), its items' chunks of steps (``chunks`` an
    utterance of ``chunk`` steps each: one chunk where B items fill a wave
    of ``CONV_BWD_BLOCKS``, else enough for a wave, each at least
    ``CONV_BWD_MIN_CH`` steps), the rows of partial sums (one an item, each
    (k + 4) d floats), the fp32 dx scratch [T, B, d] (general only, elements)
    and the shared memory of its largest launch (bytes)."""
    if k == CONV_BWD_TAPS and d % 8 == 0 and 8 <= d <= CONV_BWD_MAX_D:
        nc = max(1, min(CONV_BWD_BLOCKS // B, T // CONV_BWD_MIN_CH))
        ch = -(-T // nc)
        nc = -(-T // ch)
        return {"route": "fused", "chunks": nc, "chunk": ch, "part_rows": B * nc,
                "dx_elements": 0, "smem": conformer_bwd_fused_smem(d)}
    nc = -(-T // CONV_BWD_GENERAL_CH)
    return {"route": "general", "chunks": nc, "chunk": CONV_BWD_GENERAL_CH, "part_rows": B * nc,
            "dx_elements": T * B * d, "smem": conformer_general_smem(d, k)}


def conformer_conv_bwd(u, b_in, dw, ln_scale, ln_bias, lengths, dout, z=None):
    """K9: the conformer conv module's backward (CUDA), recomputing the
    forward from its inputs; the kernels by ``conformer_bwd_plan``.

    The forward's operands and the output's cotangent dout [T,B,d] bf16 ->
    (du [T,B,2d] bf16, db_in [2d], ddw [k,d], dln_scale [d], dln_bias [d],
    all f32; db_in holds bf16 values, the transpose of the bias's cast).
    ``z`` (the fused route only; checks): an f32 [T,B,d] tensor that takes
    the recompute of LayerNorm's output.
    """
    T, B, d, k, dev = _check_conformer_conv(u, b_in, dw, ln_scale, ln_bias, lengths)
    _check("dout", dout, torch.bfloat16, (T, B, d), dev)
    plan = conformer_bwd_plan(T, B, d, k)
    if z is not None:
        if plan["route"] != "fused":
            raise ValueError("conformer conv bwd: z is written by the fused route only")
        _check("z", z, torch.float32, (T, B, d), dev)
    lib = _load()
    f32 = torch.float32
    part = torch.empty((plan["part_rows"], (k + 4) * d), dtype=f32, device=dev)
    du = torch.empty((T, B, 2 * d), dtype=torch.bfloat16, device=dev)
    grads = torch.empty(((k + 4) * d,), dtype=f32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    operands = (u.data_ptr(), b_in.data_ptr(), dw.data_ptr(), ln_scale.data_ptr(),
                ln_bias.data_ptr(), lengths.data_ptr(), dout.data_ptr())
    if plan["route"] == "fused":
        err = lib.avsr_conformer_conv_bwd_fused(*operands, part.data_ptr(), du.data_ptr(),
                                                grads.data_ptr(), _ptr(z), T, B, d, k,
                                                plan["chunk"], plan["chunks"], stream)
    else:
        dx = torch.empty((T, B, d), dtype=f32, device=dev)
        err = lib.avsr_conformer_conv_bwd(*operands, dx.data_ptr(), part.data_ptr(),
                                          du.data_ptr(), grads.data_ptr(), T, B, d, k, stream)
    _raise_on(err, "conformer_conv_bwd launch")
    LAUNCHES["conformer_conv_bwd"] += 1
    ddw, dln_scale, dln_bias, db_in = grads.split([k * d, d, d, 2 * d])
    return du, db_in, ddw.view(k, d), dln_scale, dln_bias

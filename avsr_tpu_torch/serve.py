"""Serving: pad, quantize, encode + beam decode, ids -> text.

Counterpart of ``avsr_tpu/serve.py``'s ``Predictor`` around the exported
``decode`` program: the same static (B, S) request shape, the same host
quantization for compact transfer (int16 PCM audio, uint8 ROI pixels,
dequantized on the device inside ``seq2seq.encode``), and the same
``decode_ids`` rules.  The port runs the model code directly from port
parameters plus the config and the unit dictionary; a torch-native
serving artifact is later work.

>>> p = Predictor(params, cfg, unit_dict, device="cuda")
>>> p.transcribe(audio=[wav1, wav2], video=[roi1, roi2])
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from avsr_tpu.configs import ExperimentConfig
from avsr_tpu.data.units import EOS_ID, GO_ID, PAD_ID, UnitDict
from avsr_tpu_torch.decode.beam import BeamResult, beam_search
from avsr_tpu_torch.models import seq2seq
from avsr_tpu_torch.utils.numerics import compute_dtype_of
from avsr_tpu_torch.utils.params import Params


def input_signature(cfg: ExperimentConfig, batch_size: int, audio_seconds: float,
                    video_seconds: Optional[float], transfer: str) -> List[Tuple[str, tuple, str]]:
    """(name, shape, dtype) of each request array (``av_align``, ROI video)."""
    if video_seconds is None:
        video_seconds = audio_seconds
    compact = transfer == "compact"
    S = int(round(audio_seconds * cfg.audio.sample_rate))
    T_v = int(math.ceil(video_seconds * cfg.data.video_fps))
    v = cfg.video
    return [
        ("audio", (batch_size, S), "int16" if compact else "float32"),
        ("audio_lengths", (batch_size,), "int32"),
        ("video", (batch_size, T_v, v.roi_height, v.roi_width, v.channels),
         "uint8" if compact else "float32"),
        ("video_lengths", (batch_size,), "int32"),
    ]


def quantize(name: str, s: np.ndarray, dtype: str) -> np.ndarray:
    """Float request -> wire dtype (host-side half of compact transfer)."""
    if dtype == "int16":
        if np.issubdtype(s.dtype, np.integer):
            return s.astype(np.int16)
        lo, hi = (float(s.min()), float(s.max())) if s.size else (0.0, 0.0)
        if lo < -32768.0 / 32767.0 - 1e-6 or hi > 1.0 + 1e-6:
            raise ValueError(
                f"{name} request range [{lo:.4f}, {hi:.4f}]; compact transfer "
                "expects int16-PCM-range waveforms in [-32768/32767, 1]")
        return np.clip(np.round(s * 32767.0), -32768, 32767).astype(np.int16)
    if dtype == "uint8":
        if s.dtype == np.uint8:
            return s
        lo, hi = (float(s.min()), float(s.max())) if s.size else (0.0, 0.0)
        if lo < -1e-6 or hi > 1.0 + 1e-6:
            raise ValueError(
                f"{name} request range [{lo:.3f}, {hi:.3f}]; compact transfer "
                "expects ROI pixels in [0, 1]")
        return np.round(s * 255.0).astype(np.uint8)
    return s.astype(dtype)


class Predictor:
    """Encode + width-W beam decode of fixed-shape request batches."""

    def __init__(self, params: Params, cfg: ExperimentConfig, unit_dict: UnitDict, *,
                 device, batch_size: int = 8, audio_seconds: float = 6.0,
                 video_seconds: Optional[float] = None, transfer: str = "compact"):
        self.params = params
        self.cfg = cfg
        self.device = device
        self._units = list(unit_dict.idx_to_unit[3:])
        self._unit_type = unit_dict.unit_type
        self._inputs = {n: (shape, dt) for n, shape, dt in input_signature(
            cfg, batch_size, audio_seconds, video_seconds, transfer)}
        self._cdt = compute_dtype_of(cfg)

    def _pad_batch(self, name: str, seqs: Sequence[np.ndarray]):
        shape, dtype = self._inputs[name]
        if len(seqs) > shape[0]:
            raise ValueError(
                f"{len(seqs)} {name} inputs exceed the batch size {shape[0]}; "
                "split the request")
        out = np.zeros(shape, dtype)
        lengths = np.zeros((shape[0],), np.int32)
        for i, s in enumerate(seqs):
            s = np.asarray(s)
            if s.shape[0] > shape[1]:
                raise ValueError(
                    f"{name} input {i} has {s.shape[0]} steps; horizon is {shape[1]}")
            if s.shape[1:] != shape[2:]:
                raise ValueError(
                    f"{name} input {i} trailing shape {s.shape[1:]} != {shape[2:]}")
            out[i, : s.shape[0]] = quantize(name, s, dtype)
            lengths[i] = s.shape[0]
        return out, lengths

    def assemble(self, audio: Sequence[np.ndarray], video: Sequence[np.ndarray]):
        """Pad and quantize a request: (host arrays by input name, count)."""
        if audio is None or video is None:
            raise ValueError("the av_align model needs audio and video")
        if len(audio) != len(video):
            raise ValueError("audio/video request counts differ")
        if not audio:
            raise ValueError("empty request: no utterances")
        arrays: Dict[str, np.ndarray] = {}
        for name, seqs in (("audio", audio), ("video", video)):
            arrays[name], arrays[f"{name}_lengths"] = self._pad_batch(name, seqs)
        return arrays, len(audio)

    def encode(self, arrays: Dict[str, np.ndarray]) -> seq2seq.EncodeOutput:
        return seq2seq.encode(self.params, self.cfg,
                              seq2seq.batch_to_device(arrays, self.device))

    def beam(self, enc_out: seq2seq.EncodeOutput) -> BeamResult:
        d = self.cfg.decode
        return beam_search(self.params["decoder"], self.cfg.decoder, enc_out.memories,
                           d.max_decode_length, beam_width=d.beam_width,
                           length_penalty=d.length_penalty, cdt=self._cdt)

    def __call__(self, **arrays) -> np.ndarray:
        """Padded full-shape arrays in, best hypothesis ids [B, L] out."""
        return self.beam(self.encode(arrays)).ids.numpy()

    def decode_ids(self, ids: np.ndarray) -> str:
        toks = []
        for i in ids:
            i = int(i)
            if i == EOS_ID:
                break
            if i in (PAD_ID, GO_ID) or not 0 <= i - 3 < len(self._units):
                continue
            toks.append(self._units[i - 3])
        return ("" if self._unit_type.startswith("character") else " ").join(toks)

    def transcribe(self, *, audio: Sequence[np.ndarray],
                   video: Sequence[np.ndarray]) -> List[str]:
        """Variable-length utterances in, transcripts out."""
        arrays, n = self.assemble(audio, video)
        ids = self(**arrays)
        return [self.decode_ids(ids[i]) for i in range(n)]

"""Serving: pad, quantize, encode + beam decode, ids -> text.

Counterpart of ``avsr_tpu/serve.py``'s ``Predictor`` around the exported
``decode`` program, for every architecture the port runs (``audio``,
``video`` with the ROI CNN or AU features, ``bimodal``, and ``av_align``:
``lrs2_av_fast``, BiLSTM encoders, cross-attention fusion + transformer
decoder; ``lrs2_av_align``, AV-Align fusion + attention-LSTM decoder, with
BiLSTM encoders and Bahdanau reads or one-direction encoders and Luong
reads; ``lrs2_av_v2``, transformer encoders, cross-attention fusion +
transformer decoder): the inputs the architecture reads (the others are
None), the same static (B, S) request shape,
the same host quantization for compact transfer (int16 PCM audio, uint8
ROI pixels, dequantized on the device inside ``seq2seq.encode``), and the
same ``decode_ids`` rules.  The port runs the model code directly from port
parameters plus the config and the unit dictionary; a torch-native
serving artifact is later work.  ``encode``, ``beam`` and ``__call__`` run
under ``torch.inference_mode()``, so parameters that require a gradient
(a train state's) record no graph.

>>> p = Predictor(params, cfg, unit_dict)  # on the card; device="cpu" for the plain path
>>> p.transcribe(audio=[wav1, wav2], video=[roi1, roi2])
>>> Predictor(audio_params, audio_cfg, unit_dict).transcribe(audio=[wav1, wav2])
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from avsr_tpu_torch.configs import ExperimentConfig
from avsr_tpu_torch.data.units import EOS_ID, GO_ID, PAD_ID, UnitDict
from avsr_tpu_torch.decode.beam import BeamResult, beam_search
from avsr_tpu_torch.models import seq2seq
from avsr_tpu_torch.utils.numerics import compute_dtype_of
from avsr_tpu_torch.utils.params import Params


def input_signature(cfg: ExperimentConfig, batch_size: int, audio_seconds: float,
                    video_seconds: Optional[float], transfer: str) -> List[Tuple[str, tuple, str]]:
    """(name, shape, dtype) of each array the architecture reads
    (``avsr_tpu/serve.py:_input_signature``): compact transfer ships int16
    PCM audio and uint8 ROI video; AU-feature video stays float32 (its
    intensities are not bounded to [0, 1])."""
    if video_seconds is None:
        video_seconds = audio_seconds
    compact = transfer == "compact"
    sig: List[Tuple[str, tuple, str]] = []
    if seq2seq.uses_audio(cfg):
        S = int(round(audio_seconds * cfg.audio.sample_rate))
        sig.append(("audio", (batch_size, S), "int16" if compact else "float32"))
        sig.append(("audio_lengths", (batch_size,), "int32"))
    if seq2seq.uses_video(cfg):
        T_v = int(math.ceil(video_seconds * cfg.data.video_fps))
        v = cfg.video
        if v.use_au_features:
            shape, vdt = (batch_size, T_v, v.au_dim), "float32"
        else:
            shape = (batch_size, T_v, v.roi_height, v.roi_width, v.channels)
            vdt = "uint8" if compact else "float32"
        sig.append(("video", shape, vdt))
        sig.append(("video_lengths", (batch_size,), "int32"))
    return sig


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
                 device="cuda", batch_size: int = 8, audio_seconds: float = 6.0,
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

    def assemble(self, audio: Optional[Sequence[np.ndarray]] = None,
                 video: Optional[Sequence[np.ndarray]] = None):
        """Pad and quantize a request: (host arrays by input name, count).
        Each modality the architecture reads is required; one it does not
        read is ignored (``avsr_tpu/serve.py:_assemble``)."""
        n = None
        arrays: Dict[str, np.ndarray] = {}
        for name, seqs in (("audio", audio), ("video", video)):
            if name not in self._inputs:
                continue
            if seqs is None:
                raise ValueError(f"the {self.cfg.architecture} model needs {name}")
            arrays[name], arrays[f"{name}_lengths"] = self._pad_batch(name, seqs)
            if n is None:
                n = len(seqs)
            elif len(seqs) != n:
                raise ValueError("audio/video request counts differ")
        if not n:
            raise ValueError("empty request: no utterances")
        return arrays, n

    @torch.inference_mode()
    def encode(self, arrays: Dict[str, np.ndarray]) -> seq2seq.EncodeOutput:
        return seq2seq.encode(self.params, self.cfg,
                              seq2seq.batch_to_device(arrays, self.device))

    @torch.inference_mode()
    def beam(self, enc_out: seq2seq.EncodeOutput) -> BeamResult:
        d = self.cfg.decode
        return beam_search(self.params["decoder"], self.cfg.decoder, enc_out.memories,
                           d.max_decode_length, beam_width=d.beam_width,
                           length_penalty=d.length_penalty, cdt=self._cdt)

    @torch.inference_mode()
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

    def transcribe(self, *, audio: Optional[Sequence[np.ndarray]] = None,
                   video: Optional[Sequence[np.ndarray]] = None) -> List[str]:
        """Variable-length utterances in, transcripts out."""
        arrays, n = self.assemble(audio, video)
        ids = self(**arrays)
        return [self.decode_ids(ids[i]) for i in range(n)]

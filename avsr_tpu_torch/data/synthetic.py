"""Synthetic AV micro-dataset for integration tests and benchmarks.

The reference has no test suite (SURVEY.md §4); this framework's integration
tests overfit audio-only / video-only / AV-Align models on a committed-seed
synthetic dataset to ~0 CER (SURVEY §4.4).  The construction makes the
transcript recoverable from BOTH modalities:

  * audio: each character is a fixed-frequency tone segment (distinct
    per character), so an acoustic model can learn char <-> tone;
  * video: each character is a distinct 2-D Gaussian-blob position in the
    lip-ROI frame, so a visual model can learn char <-> blob position;
  * noise bank: deterministic pseudo-babble/cafe noise rows for the SNR
    mixing tests.

A copy of ``avsr_tpu/data/synthetic.py``: the same seed makes the same
arrays in both packages.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from avsr_tpu_torch.data.units import UnitDict, builtin_unit_dict


@dataclass
class Utterance:
    uid: str
    transcript: str
    waveform: Optional[np.ndarray] = None  # [S] float32
    video: Optional[np.ndarray] = None     # [T, H, W, 1] float32
    au: Optional[np.ndarray] = None        # [T, au_dim] float32


@dataclass
class SyntheticSpec:
    num_utterances: int = 32
    min_chars: int = 2
    max_chars: int = 6
    sample_rate: int = 16_000
    char_duration_s: float = 0.12
    video_fps: float = 25.0
    roi: int = 36
    alphabet: str = "abcdefgh"
    seed: int = 0
    au_dim: int = 2


def _char_freq(c: str) -> float:
    # distinct tones 300..3000 Hz spread over the alphabet
    return 300.0 + (ord(c) - ord("a")) * 150.0


def _char_blob(c: str, roi: int) -> tuple:
    i = ord(c) - ord("a")
    gx = (i % 4) / 3.0
    gy = (i // 4 % 4) / 3.0
    return (4 + gx * (roi - 9), 4 + gy * (roi - 9))


def generate(spec: SyntheticSpec = SyntheticSpec()) -> List[Utterance]:
    rng = np.random.default_rng(spec.seed)
    chars_per_s = 1.0 / spec.char_duration_s
    utts: List[Utterance] = []
    spc = int(spec.sample_rate * spec.char_duration_s)  # samples per char
    fpc = spec.video_fps * spec.char_duration_s         # frames per char
    for n in range(spec.num_utterances):
        k = int(rng.integers(spec.min_chars, spec.max_chars + 1))
        text = "".join(rng.choice(list(spec.alphabet), k))
        # --- audio: tone per char + tiny noise floor
        wav = np.zeros(spc * k, np.float32)
        t = np.arange(spc) / spec.sample_rate
        for i, c in enumerate(text):
            tone = np.sin(2 * np.pi * _char_freq(c) * t).astype(np.float32)
            wav[i * spc : (i + 1) * spc] = 0.5 * tone
        wav += 0.01 * rng.standard_normal(len(wav)).astype(np.float32)
        # --- video: moving blob per char
        T = max(int(round(fpc * k)), 1)
        vid = np.zeros((T, spec.roi, spec.roi, 1), np.float32)
        yy, xx = np.mgrid[0 : spec.roi, 0 : spec.roi]
        au = np.zeros((T, spec.au_dim), np.float32)
        for f in range(T):
            c = text[min(int(f / fpc), k - 1)]
            cx, cy = _char_blob(c, spec.roi)
            blob = np.exp(-((xx - cx) ** 2 + (yy - cy) ** 2) / (2 * 2.5**2))
            # clip to [0, 1]: lip-ROI crops are pixel data, and the compact
            # uint8 transfer/storage codecs require that range
            vid[f, :, :, 0] = np.clip(
                blob + 0.05 * rng.standard_normal(
                    (spec.roi, spec.roi)
                ).astype(np.float32),
                0.0, 1.0,
            )
            au[f, 0] = cx / spec.roi
            au[f, 1 % spec.au_dim] = cy / spec.roi
        utts.append(
            Utterance(
                uid=f"synth{n:04d}", transcript=text,
                waveform=wav, video=vid, au=au,
            )
        )
    return utts


def make_noise_bank(
    num_rows: int = 4, row_samples: int = 32_000, seed: int = 1
) -> np.ndarray:
    """Deterministic pseudo noise bank [N, L]: filtered noise ~ babble/cafe."""
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(num_rows):
        white = rng.standard_normal(row_samples).astype(np.float32)
        # cheap coloration: moving average with row-dependent window
        w = 3 + 2 * i
        kern = np.ones(w, np.float32) / w
        rows.append(np.convolve(white, kern, mode="same").astype(np.float32))
    return np.stack(rows)

"""Waveform -> log-mel features (counterpart of ``avsr_tpu/ops/audio_features.py``).

Same pipeline and layouts as the reference: framing by gather, a
Hann-windowed real DFT as two matmuls (compute-dtype operands, fp32
accumulation), the power spectrum, a mel product, ``log(. + floor)``,
edge-clamped Δ/ΔΔ, per-utterance masked normalization, zeroing of padded
frames, and stack/skip framing.  Batch-major [B, T, D]; lengths are int32.

Everything after the DFT is kernel K3: ``logmel_post_dft`` launches the
CUDA kernel (``csrc/logmel.cu``) for tensors on a GPU and runs
``logmel_post_dft_plain`` for tensors on the CPU.  The mel filterbank and
the DFT matrices are numpy copies of the reference's (its module imports
jax); ``tests/test_torch_audio_features.py`` holds them equal.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from avsr_tpu.configs import AudioFrontendConfig
from avsr_tpu_torch import kernels
from avsr_tpu_torch.utils.numerics import dot_f32


def hz_to_mel(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f, dtype=np.float64) / 700.0)


@functools.lru_cache(maxsize=None)
def mel_filterbank(num_mel_bins: int, num_spectrogram_bins: int, sample_rate: int,
                   lower_hz: float, upper_hz: float) -> np.ndarray:
    """Triangular mel weight matrix [num_spectrogram_bins, num_mel_bins]
    (tf.signal.linear_to_mel_weight_matrix construction)."""
    nyquist = sample_rate / 2.0
    freqs = np.linspace(0.0, nyquist, num_spectrogram_bins)
    mel_freqs = hz_to_mel(freqs)
    mel_edges = np.linspace(hz_to_mel(lower_hz), hz_to_mel(upper_hz), num_mel_bins + 2)
    lower, center, upper = mel_edges[:-2], mel_edges[1:-1], mel_edges[2:]
    up_slope = (mel_freqs[:, None] - lower[None, :]) / np.maximum(
        center - lower, 1e-12)[None, :]
    down_slope = (upper[None, :] - mel_freqs[:, None]) / np.maximum(
        upper - center, 1e-12)[None, :]
    weights = np.maximum(0.0, np.minimum(up_slope, down_slope))
    weights[0, :] = 0.0  # DC bin carries no mel energy
    return weights.astype(np.float32)


def num_frames(num_samples: int, frame_length: int, frame_step: int) -> int:
    """Full frames only (tf.signal.stft pad_end=False semantics)."""
    if num_samples < frame_length:
        return 0
    return 1 + (num_samples - frame_length) // frame_step


def frame_signal(x: torch.Tensor, frame_length: int, frame_step: int) -> torch.Tensor:
    """[B, S] -> [B, T, frame_length] overlapping frames (gather)."""
    T = num_frames(x.shape[-1], frame_length, frame_step)
    starts = torch.arange(T, device=x.device) * frame_step
    idx = starts[:, None] + torch.arange(frame_length, device=x.device)[None, :]
    return x[..., idx]


@functools.lru_cache(maxsize=None)
def hann_window(frame_length: int) -> np.ndarray:
    # Periodic Hann (tf.signal default), not symmetric.
    n = np.arange(frame_length, dtype=np.float64)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * n / frame_length)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _dft_matrices(frame_length: int, fft_length: int) -> Tuple[np.ndarray, np.ndarray]:
    """Hann-windowed real DFT as two [min(frame, fft), fft//2+1] matrices."""
    eff = min(frame_length, fft_length)
    n = np.arange(fft_length)[:, None]
    k = np.arange(fft_length // 2 + 1)[None, :]
    ang = -2.0 * np.pi * n * k / fft_length
    cos = np.cos(ang)[:eff, :]
    sin = np.sin(ang)[:eff, :]
    win = hann_window(frame_length)[:eff, None].astype(np.float64)
    return (cos * win).astype(np.float32), (sin * win).astype(np.float32)


def stft(wav: torch.Tensor, frame_length: int, frame_step: int, fft_length: int,
         cdt: torch.dtype = torch.float32) -> Tuple[torch.Tensor, torch.Tensor]:
    """[B, S] -> (re, im) [B, T, fft_length//2+1] fp32 via the matmul DFT."""
    cos_m, sin_m = _dft_matrices(frame_length, fft_length)
    eff = cos_m.shape[0]
    f = frame_signal(wav, frame_length, frame_step)[..., :eff]
    dev = wav.device
    re = dot_f32(f, torch.from_numpy(cos_m).to(dev), cdt)
    im = dot_f32(f, torch.from_numpy(sin_m).to(dev), cdt)
    return re, im


def stft_power(wav, frame_length, frame_step, fft_length, cdt=torch.float32):
    re, im = stft(wav, frame_length, frame_step, fft_length, cdt)
    return re * re + im * im


def delta_features(feat: torch.Tensor, window: int = 2) -> torch.Tensor:
    """Regression deltas along time [B, T, D], edges replicated."""
    N = window
    denom = 2.0 * sum(n * n for n in range(1, N + 1))
    T = feat.shape[1]
    padded = torch.cat(
        [feat[:, :1].expand(-1, N, -1), feat, feat[:, -1:].expand(-1, N, -1)], dim=1)
    out = torch.zeros_like(feat)
    for n in range(1, N + 1):
        out = out + n * (padded[:, N + n:N + n + T] - padded[:, N - n:N - n + T])
    return out / denom


def _time_mask(T: int, lengths: torch.Tensor) -> torch.Tensor:
    return (torch.arange(T, device=lengths.device)[None, :] < lengths[:, None]).float()


def masked_normalize(feat: torch.Tensor, lengths: torch.Tensor, eps: float = 1e-8):
    """Per-utterance mean/var normalization over valid frames only."""
    mask = _time_mask(feat.shape[1], lengths)
    denom = torch.clamp(mask.sum(1, keepdim=True), min=1.0)[..., None]
    m = mask[..., None]
    mean = (feat * m).sum(1, keepdim=True) / denom
    var = ((feat - mean).square() * m).sum(1, keepdim=True) / denom
    return (feat - mean) * torch.rsqrt(var + eps) * m


def stack_lengths(lengths: torch.Tensor, stack: int, skip: int, Tp: int) -> torch.Tensor:
    new_len = torch.maximum(
        torch.div(lengths - stack, skip, rounding_mode="floor") + 1,
        torch.clamp(lengths, max=1))
    return torch.clamp(new_len, 0, Tp).to(torch.int32)


def stack_frames(feat: torch.Tensor, lengths: torch.Tensor, stack: int, skip: int):
    """Stack ``stack`` frames every ``skip`` frames: [B,T,D] -> [B,T',D*stack]."""
    if stack <= 1 and skip <= 1:
        return feat, lengths
    B, T, D = feat.shape
    Tp = max(0, (T - stack) // skip + 1)
    idx = (torch.arange(Tp, device=feat.device) * skip)[:, None] + torch.arange(
        stack, device=feat.device)[None, :]
    out = feat[:, idx].reshape(B, Tp, stack * D)
    new_len = stack_lengths(lengths, stack, skip, Tp)
    return out * _time_mask(Tp, new_len)[..., None], new_len


def _check_supported(cfg: AudioFrontendConfig) -> None:
    if (cfg.feature_type != "logmel" or not cfg.add_deltas
            or cfg.normalization != "per_utterance" or not cfg.use_matmul_dft):
        raise ValueError(
            "the port's frontend covers feature_type='logmel', add_deltas=True, "
            "normalization='per_utterance', use_matmul_dft=True")


def _mel_matrix(cfg: AudioFrontendConfig, device) -> torch.Tensor:
    w = mel_filterbank(cfg.num_mel_bins, cfg.fft_length // 2 + 1, cfg.sample_rate,
                       cfg.mel_lower_hz, cfg.mel_upper_hz)
    return torch.from_numpy(w).to(device)


def logmel_post_dft_plain(re, im, feat_len, cfg: AudioFrontendConfig):
    """Plain-PyTorch K3: everything ``logmel_frontend`` does after the DFT."""
    power = re * re + im * im
    feat = torch.log(power @ _mel_matrix(cfg, re.device) + cfg.log_floor)
    # Edge-replicate the last valid frame into the padded tail before the
    # delta windows, so tail deltas do not depend on the pad length.
    T = feat.shape[1]
    t_idx = torch.minimum(
        torch.arange(T, device=feat.device)[None, :],
        torch.clamp(feat_len[:, None].long() - 1, min=0))
    feat_edge = torch.gather(feat, 1, t_idx[..., None].expand(-1, -1, feat.shape[-1]))
    d1 = delta_features(feat_edge, cfg.delta_window)
    d2 = delta_features(d1, cfg.delta_window)
    feat = torch.cat([feat, d1, d2], dim=-1)
    feat = masked_normalize(feat, feat_len)
    feat = feat * _time_mask(T, feat_len)[..., None]
    return stack_frames(feat, feat_len, cfg.frame_stacking, cfg.frame_skipping)


def logmel_post_dft(re, im, feat_len, cfg: AudioFrontendConfig):
    """K3 wrapper: CUDA kernel for GPU tensors, plain version on the CPU."""
    _check_supported(cfg)
    if re.device.type == "cpu":
        return logmel_post_dft_plain(re, im, feat_len, cfg)
    return kernels.logmel_post_dft(
        re.float().contiguous(), im.float().contiguous(),
        feat_len.to(torch.int32).contiguous(), _mel_matrix(cfg, re.device),
        log_floor=cfg.log_floor, delta_window=cfg.delta_window,
        stack=cfg.frame_stacking, skip=cfg.frame_skipping,
    )


def logmel_frontend(wav: torch.Tensor, wav_lengths: torch.Tensor,
                    cfg: AudioFrontendConfig, *, cdt: torch.dtype = torch.float32):
    """[B, S] waveform + [B] int32 lengths -> ([B, T', D_out] fp32, [B] int32)."""
    _check_supported(cfg)
    re, im = stft(wav, cfg.frame_length, cfg.frame_step, cfg.fft_length, cdt)
    wav_lengths = wav_lengths.to(torch.int32)
    feat_len = torch.where(
        wav_lengths >= cfg.frame_length,
        1 + torch.div(wav_lengths - cfg.frame_length, cfg.frame_step, rounding_mode="floor"),
        torch.zeros_like(wav_lengths)).to(torch.int32)
    return logmel_post_dft(re, im, feat_len, cfg)

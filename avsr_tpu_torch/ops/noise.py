"""SNR-controlled additive-noise mixing on the device (counterpart of
``avsr_tpu/ops/noise.py``: ``NoiseBank``, ``_masked_power``, ``mix_at_snr``,
``_sample_type_segments``, ``sample_and_mix``).

Training mixes noise into the clean waveform inside the step: per example
a noise type, a bank row, an offset and an SNR are drawn (from the step's
``torch.Generator``), and the example stays clean with
``clean_probability``.  SNR convention: ``snr_db = 10*log10(P_speech /
P_noise)``, powers measured over the utterance's valid samples.  The
fixed-condition eval mixing (``mix_fixed_snr``) keys each utterance's
(row, offset) draw on its uid hash through JAX's threefry PRNG: the port
draws them on the host with ``utils/rng.py``'s numpy threefry2x32, bit for
bit as the JAX package draws them, copies the B pairs to the device once,
and gathers and mixes there.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from avsr_tpu_torch.utils import rng


@dataclasses.dataclass(frozen=True)
class NoiseBank:
    """Named noise-type bank: one [Ni, Li] waveform tensor per noise type."""

    names: Tuple[str, ...]
    banks: Tuple[torch.Tensor, ...]

    def __post_init__(self):
        if len(self.names) != len(self.banks) or not self.names:
            raise ValueError("NoiseBank needs one array per type name")

    @classmethod
    def create(cls, banks: Union["NoiseBank", torch.Tensor, np.ndarray,
                                  Dict[str, Union[torch.Tensor, np.ndarray]]],
               default_name: str = "noise", device=None) -> "NoiseBank":
        """Coerce a raw [N, L] array or a {type: [Ni, Li]} dict (moved to
        ``device`` when one is given)."""
        if isinstance(banks, cls):
            return banks

        def as_2d(x):
            return torch.atleast_2d(torch.as_tensor(x, dtype=torch.float32, device=device))

        if isinstance(banks, dict):
            names = tuple(banks.keys())
            return cls(names, tuple(as_2d(banks[n]) for n in names))
        return cls((default_name,), (as_2d(banks),))

    @property
    def num_types(self) -> int:
        return len(self.names)

    def type_index(self, name: Optional[str]) -> int:
        """Resolve a type name to its bank index (None -> 0)."""
        if name is None:
            return 0
        try:
            return self.names.index(name)
        except ValueError:
            raise KeyError(f"unknown noise type {name!r}; bank has {list(self.names)}") from None


def _valid(S: int, lengths: torch.Tensor, dtype) -> torch.Tensor:
    return (torch.arange(S, device=lengths.device)[None, :] < lengths[:, None]).to(dtype)


def _masked_power(x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Mean power over valid samples. x: [B, S], lengths: [B] -> [B]."""
    mask = _valid(x.shape[-1], lengths, x.dtype)
    denom = torch.clamp(lengths.to(x.dtype), min=1.0)
    return (x.square() * mask).sum(dim=-1) / denom


def _gather_segments(bank: torch.Tensor, idx: torch.Tensor, offsets: torch.Tensor,
                     length: int) -> torch.Tensor:
    """bank [N, L], idx [B], offsets [B] -> [B, length] noise segments."""
    cols = offsets[:, None] + torch.arange(length, device=bank.device)[None, :]
    return bank[idx[:, None], cols]


def mix_at_snr(wav: torch.Tensor, wav_lengths: torch.Tensor, noise: torch.Tensor,
               snr_db: torch.Tensor) -> torch.Tensor:
    """Mix ``noise`` [B, S] into ``wav`` [B, S] at ``snr_db`` [B] per
    example; padding stays zero."""
    p_speech = _masked_power(wav, wav_lengths)
    p_noise = _masked_power(noise, wav_lengths)
    scale = torch.sqrt(p_speech / torch.clamp(p_noise, min=1e-12)) * torch.pow(
        10.0, -snr_db / 20.0)
    return wav + scale[:, None] * noise * _valid(wav.shape[-1], wav_lengths, wav.dtype)


def _sample_type_segments(generator: torch.Generator, bank: NoiseBank, batch: int,
                          length: int) -> torch.Tensor:
    """One noise segment per example, (type, row, offset) drawn uniformly:
    [B, length]."""
    dev = bank.banks[0].device
    segs = []
    for arr in bank.banks:
        N, L = arr.shape
        if L < length:
            raise ValueError(f"noise bank rows ({L}) shorter than waveform ({length})")
        idx = torch.randint(0, N, (batch,), generator=generator, device=dev)
        offsets = torch.randint(0, L - length + 1, (batch,), generator=generator, device=dev)
        segs.append(_gather_segments(arr, idx, offsets, length))
    if bank.num_types == 1:
        return segs[0]
    type_idx = torch.randint(0, bank.num_types, (batch,), generator=generator, device=dev)
    stacked = torch.stack(segs)  # [types, B, length]
    return stacked[type_idx, torch.arange(batch, device=dev)]


def sample_and_mix(generator: torch.Generator, wav: torch.Tensor, wav_lengths: torch.Tensor,
                   noise_bank: Union[NoiseBank, torch.Tensor], snr_choices: Sequence[float],
                   clean_probability: float = 0.0) -> torch.Tensor:
    """Training-time mixing: per example draw (noise type, row, offset,
    SNR from ``snr_choices``); leave the example clean with
    ``clean_probability``.  The generator must live on ``wav``'s device."""
    bank = NoiseBank.create(noise_bank, device=wav.device)
    B, S = wav.shape
    dev = wav.device
    choice = torch.randint(0, len(snr_choices), (B,), generator=generator, device=dev)
    snrs = torch.tensor(tuple(snr_choices), dtype=torch.float32, device=dev)[choice]
    noise = _sample_type_segments(generator, bank, B, S)
    noisy = mix_at_snr(wav, wav_lengths, noise, snrs)
    if clean_probability > 0.0:
        keep_clean = torch.rand((B,), generator=generator, device=dev) < clean_probability
        noisy = torch.where(keep_clean[:, None], wav, noisy)
    return noisy


def mix_fixed_snr(wav: torch.Tensor, wav_lengths: torch.Tensor,
                  noise_bank: Union[NoiseBank, torch.Tensor], snr_db, *,
                  noise_type: Optional[str] = None, seed: int = 0,
                  uid_hashes=None) -> torch.Tensor:
    """Deterministic fixed-(type x SNR) mixing for evaluation: one bank row
    and offset per utterance, a function of ``seed`` and the utterance's
    ``uid_hashes`` entry ([B] uint32 crc32 of the uid, on the host; without
    hashes its batch position), so an utterance gets the same noise in any
    batch.  ``snr_db`` is a float or a 0-d tensor; ``noise_type`` picks the
    bank type by name (None -> the first)."""
    bank = NoiseBank.create(noise_bank, device=wav.device)
    arr = bank.banks[bank.type_index(noise_type)]
    B, S = wav.shape
    N, L = arr.shape
    if L < S:
        raise ValueError(f"noise bank rows ({L}) shorter than waveform ({S})")
    if uid_hashes is None:
        hashes = np.arange(B, dtype=np.uint32)
    else:
        if isinstance(uid_hashes, torch.Tensor):
            uid_hashes = uid_hashes.cpu().numpy()
        hashes = np.asarray(uid_hashes).astype(np.uint32)
    idx, offsets = rng.fixed_snr_draws(seed, hashes, N, L - S + 1)
    draws = torch.from_numpy(np.stack([idx, offsets]).astype(np.int64))
    if wav.device.type == "cuda":
        draws = draws.pin_memory()
    draws = draws.to(wav.device, non_blocking=True)
    noise = _gather_segments(arr, draws[0], draws[1], S)
    snrs = torch.as_tensor(snr_db, dtype=torch.float32, device=wav.device).expand(B)
    return mix_at_snr(wav, wav_lengths, noise, snrs)

"""Noise mixing and training randomness of the port.

``mix_at_snr`` is deterministic and is held against ``avsr_tpu.ops.noise``
on the same segments (fp32, rtol 1e-5: only summation order differs).
``sample_and_mix`` draws from a ``torch.Generator``, whose numbers cannot
equal JAX's, so it is tested by what the draws must satisfy: every noisy
row's achieved SNR is one of the configured values (within 1e-3 dB), its
noise is a scaled slice of one bank row, the clean share is near
``clean_probability`` (binomial standard deviation 0.009 at B=2000, held
at 0.04), each SNR value is drawn about equally often, and padding stays
zero.  Dropout masks keep ~keep of the entries at 1/keep.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avsr_tpu.ops import noise as jnoise
from avsr_tpu_torch.ops import noise as tnoise
from avsr_tpu_torch.utils import rng as trng

SNRS = (-5.0, 0.0, 10.0, 20.0)


@pytest.fixture(autouse=True)
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _speech(rng, B, S):
    lengths = rng.integers(S // 2, S + 1, B).astype(np.int32)
    wav = rng.standard_normal((B, S)).astype(np.float32) * 0.3
    wav *= np.arange(S)[None, :] < lengths[:, None]
    return wav, lengths


def test_mix_at_snr_matches_jax():
    rng = np.random.default_rng(0)
    wav, lengths = _speech(rng, 4, 300)
    noise = rng.standard_normal((4, 300)).astype(np.float32)
    snr = np.array([-5.0, 0.0, 10.0, 20.0], np.float32)
    want = jnoise.mix_at_snr(jnp.asarray(wav), jnp.asarray(lengths), jnp.asarray(noise),
                             jnp.asarray(snr))
    got = tnoise.mix_at_snr(torch.from_numpy(wav), torch.from_numpy(lengths),
                            torch.from_numpy(noise), torch.from_numpy(snr))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        tnoise._masked_power(torch.from_numpy(wav), torch.from_numpy(lengths)).numpy(),
        np.asarray(jnoise._masked_power(jnp.asarray(wav), jnp.asarray(lengths))), rtol=1e-6)


def test_sample_and_mix_statistics():
    rng = np.random.default_rng(1)
    B, S = 2000, 64
    wav, lengths = _speech(rng, B, S)
    banks = {"babble": rng.standard_normal((3, 200)).astype(np.float32),
             "cafe": 5.0 + rng.standard_normal((2, 150)).astype(np.float32)}
    bank = tnoise.NoiseBank.create(banks)
    out = tnoise.sample_and_mix(torch.Generator().manual_seed(0), torch.from_numpy(wav),
                                torch.from_numpy(lengths), bank, SNRS, 0.2).numpy()
    again = tnoise.sample_and_mix(torch.Generator().manual_seed(0), torch.from_numpy(wav),
                                  torch.from_numpy(lengths), bank, SNRS, 0.2).numpy()
    np.testing.assert_array_equal(out, again)
    valid = np.arange(S)[None, :] < lengths[:, None]
    assert np.all(out[~valid] == 0)
    noise = out - wav
    clean = np.all(noise == 0, axis=1)
    assert abs(clean.mean() - 0.2) < 0.04
    p_s = (wav ** 2).sum(1) / lengths
    p_n = (noise ** 2).sum(1) / lengths
    snr = 10 * np.log10(p_s[~clean] / p_n[~clean])
    nearest = np.abs(snr[:, None] - np.asarray(SNRS)[None, :])
    assert nearest.min(axis=1).max() < 1e-3
    counts = np.bincount(nearest.argmin(axis=1), minlength=4) / (~clean).sum()
    assert np.all(np.abs(counts - 0.25) < 0.05)
    # every noise segment is a scaled contiguous slice of one bank row
    rows = [(name, r) for name, arr in banks.items() for r in arr]
    for i in np.flatnonzero(~clean)[:40]:
        n = noise[i, :lengths[i]]
        hit = False
        for _, r in rows:
            for off in range(len(r) - S + 1):
                seg = r[off:off + lengths[i]]
                scale = n @ seg / (seg @ seg)
                if np.allclose(n, scale * seg, rtol=1e-4, atol=1e-5):
                    hit = True
                    break
            if hit:
                break
        assert hit, i


def test_noise_bank_validation():
    bank = tnoise.NoiseBank.create({"babble": np.zeros((2, 50), np.float32),
                                    "cafe": np.zeros((1, 60), np.float32)})
    assert bank.num_types == 2 and bank.type_index("cafe") == 1 and bank.type_index(None) == 0
    with pytest.raises(KeyError, match="unknown noise type"):
        bank.type_index("street")
    plain = tnoise.NoiseBank.create(np.zeros(40, np.float32))
    assert plain.names == ("noise",) and tuple(plain.banks[0].shape) == (1, 40)
    with pytest.raises(ValueError, match="shorter than waveform"):
        tnoise.sample_and_mix(torch.Generator().manual_seed(0), torch.zeros(2, 55),
                              torch.tensor([55, 30]), bank, SNRS)


def test_dropout_mask_keep_rate_and_scale():
    g = torch.Generator().manual_seed(3)
    m = trng.dropout_mask(g, 0.9, (400, 500))
    kept = m != 0
    assert abs(float(kept.float().mean()) - 0.9) < 3e-3
    torch.testing.assert_close(m[kept], torch.full_like(m[kept], 1 / 0.9))
    mb = trng.dropout_mask(torch.Generator().manual_seed(3), 0.9, (400, 500), torch.bfloat16)
    assert mb.dtype == torch.bfloat16
    assert torch.equal(mb != 0, kept)  # same generator state, same draws


def test_fold_in_is_deterministic_and_spreads():
    seeds = {trng.fold_in(42, s) for s in range(1000)}
    assert len(seeds) == 1000
    assert trng.fold_in(42, 7) == trng.fold_in(42, 7) != trng.fold_in(43, 7)
    assert all(0 <= s < 2 ** 63 for s in seeds)

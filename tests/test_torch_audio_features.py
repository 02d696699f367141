"""Log-mel frontend of the PyTorch port against ``avsr_tpu.ops.audio_features``.

Everything after the DFT is the K3 wrapper, which runs its plain version
on CPU tensors.  Tolerances: fp32 at atol 1e-4 / rtol 1e-4 — the
features are per-utterance normalized (unit variance), and fp32 sums in a
different order move log-mel values of near-silent bins by a few 1e-6
before the 1/std scaling.  Under the bf16 policy both sides round the
same frames and DFT matrices to bf16 and accumulate in fp32, so the
products agree exactly and only summation order differs; the bound is
the same order, stated at atol 1e-3.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avsr_tpu.configs import AudioFrontendConfig
from avsr_tpu.ops import audio_features as jaf
from avsr_tpu_torch import kernels
from avsr_tpu_torch.ops import audio_features as taf

torch.set_num_threads(1)

CFG = AudioFrontendConfig()  # the lrs2_av_fast frontend: 30 mels, Δ/ΔΔ, stack 8 / skip 3
TOL = {"float32": dict(atol=1e-4, rtol=1e-4), "bfloat16": dict(atol=1e-3, rtol=1e-3)}


def test_filterbank_and_dft_matrices_equal_reference():
    a = taf.mel_filterbank(30, 257, 16000, 80.0, 7600.0)
    b = jaf.mel_filterbank(30, 257, 16000, 80.0, 7600.0)
    np.testing.assert_array_equal(a, b)
    for x, y in zip(taf._dft_matrices(400, 512), jaf._dft_matrices(400, 512)):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(taf.hann_window(400), jaf.hann_window(400))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_logmel_frontend_matches_jax(dtype):
    rng = np.random.default_rng(0)
    S = 16000
    lengths = np.array([16000, 9000, 2500, 300], np.int32)  # the last has no full frame
    wav = np.zeros((len(lengths), S), np.float32)
    for i, n in enumerate(lengths):
        t = np.arange(n) / 16000.0
        wav[i, :n] = 0.3 * np.sin(2 * np.pi * (200 + 300 * i) * t) + 0.05 * rng.standard_normal(n)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    fj, nj = jaf.logmel_frontend(jnp.asarray(wav), jnp.asarray(lengths), CFG, compute_dtype=jdt)
    ft, nt = taf.logmel_frontend(torch.from_numpy(wav), torch.from_numpy(lengths), CFG, cdt=tdt)
    assert ft.dtype == torch.float32 and nt.dtype == torch.int32
    assert tuple(ft.shape) == fj.shape == (4, jaf.output_frames(CFG, S), CFG.output_dim)
    np.testing.assert_array_equal(nt.numpy(), np.asarray(nj))
    np.testing.assert_allclose(ft.numpy(), np.asarray(fj), **TOL[dtype])


def test_stft_power_and_deltas_match_jax():
    rng = np.random.default_rng(1)
    wav = rng.standard_normal((2, 4000)).astype(np.float32)
    pj = jaf.stft_power(jnp.asarray(wav), 400, 160, 512)
    pt = taf.stft_power(torch.from_numpy(wav), 400, 160, 512)
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=1e-4, atol=1e-3)
    feat = rng.standard_normal((2, 7, 5)).astype(np.float32)
    np.testing.assert_allclose(
        taf.delta_features(torch.from_numpy(feat), 2).numpy(),
        np.asarray(jaf.delta_features(jnp.asarray(feat), 2)), atol=1e-6, rtol=1e-5)
    lengths = np.array([7, 4], np.int32)
    st, lt = taf.stack_frames(torch.from_numpy(feat), torch.from_numpy(lengths), 3, 2)
    sj, lj = jaf.stack_frames(jnp.asarray(feat), jnp.asarray(lengths), 3, 2)
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    np.testing.assert_array_equal(lt.numpy(), np.asarray(lj))


def test_frontend_padding_invariance():
    """Mirror of tests/test_audio_frontend.py::test_frontend_padding_invariance:
    the same audio padded to two lengths gives identical valid features."""
    cfg = AudioFrontendConfig(normalization="per_utterance")
    rng = np.random.default_rng(2)
    wav = rng.standard_normal(6000).astype(np.float32)
    w1 = np.zeros((1, 8000), np.float32)
    w1[0, :6000] = wav
    w2 = np.zeros((1, 12000), np.float32)
    w2[0, :6000] = wav
    lengths = torch.tensor([6000], dtype=torch.int32)
    f1, n1 = taf.logmel_frontend(torch.from_numpy(w1), lengths, cfg)
    f2, n2 = taf.logmel_frontend(torch.from_numpy(w2), lengths, cfg)
    assert int(n1[0]) == int(n2[0])
    T = int(n1[0])
    np.testing.assert_allclose(f1[0, :T].numpy(), f2[0, :T].numpy(), rtol=2e-4, atol=2e-4)
    assert torch.all(f2[0, T:] == 0)


def test_cuda_launcher_rejects_cpu_tensors():
    B, T, F, M = 1, 10, 257, 30
    before = dict(kernels.LAUNCHES)
    with pytest.raises(ValueError, match="expected a tensor on"):
        kernels.logmel_post_dft(
            torch.zeros(B, T, F), torch.zeros(B, T, F), torch.ones(B, dtype=torch.int32),
            torch.zeros(M, 3, dtype=torch.int32), torch.zeros(F * M), log_floor=1e-6,
            delta_window=2, stack=8, skip=3)
    assert kernels.LAUNCHES == before

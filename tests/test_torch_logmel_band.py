"""K3's decomposition (``csrc/logmel.cu``), mirrored on the CPU.

The kernel's mel product is BANDED: per mel bin the run of frequency bins
from its first to its last nonzero weight (``kernels.mel_band_table``),
summed with fmaf in ascending f.  A zero weight is a no-op of an fma on a
finite power, so the banded chain has the bits of the dense sequential
one; the test holds that with an fma emulated in float64 (a float32
product is exact there; each step is rounded once to float32), at 30, 40
and 80 bins and FFT sizes 512 and 1024.

Its statistics and writer launches are mirrored in numpy with the
kernel's own index math: the log-mel transposed to [B, M, T]; per (row,
bin) the frames clamped at the last valid one, Δ on the frames ΔΔ needs
and ΔΔ on the valid ones, two-pass means and variances; per (row, chunk
of stacked frames) the staged frames [ta - 2N, tb + 2N] and Δ frames
[ta - N, tb + N] clamped to [0, T), the normalized features of frames ta
to tb, and each stacked frame copied whole from them.  The mirror must
give ``logmel_post_dft_plain``'s features (fp32 sums in another order:
atol 1e-4, as tests/test_torch_audio_features.py) and its lengths, on
ragged batches with rows of no frame, of fewer frames than a stack and of
every frame, at every writer chunk size.
"""

import dataclasses

import numpy as np
import pytest
import torch

from avsr_tpu_torch import kernels
from avsr_tpu_torch.configs import AudioFrontendConfig
from avsr_tpu_torch.ops import audio_features as af

CFG = AudioFrontendConfig()  # the presets' frontend: 30 mels, fft 512, stack 8 / skip 3


def fma32(a, b, c):
    """fmaf emulated: the exact product plus c, rounded once to float32
    (then a zero weight returns c unchanged, as fmaf does)."""
    return (a.astype(np.float64) * b.astype(np.float64) + c.astype(np.float64)).astype(np.float32)


@pytest.mark.parametrize("fft", [512, 1024])
@pytest.mark.parametrize("mels", [30, 40, 80])
def test_band_table_holds_the_dense_matrix(mels, fft):
    F = fft // 2 + 1
    dense = af.mel_filterbank(mels, F, 16000, 80.0, 7600.0)
    band, weights = kernels.mel_band_table(dense)
    assert band.dtype == np.int32 and weights.dtype == np.float32
    rebuilt = np.zeros_like(dense)
    for m, (f0, cnt, off) in enumerate(band):
        assert 0 <= f0 and f0 + cnt <= F and off + cnt <= weights.size
        rebuilt[f0:f0 + cnt, m] = weights[off:off + cnt]
    np.testing.assert_array_equal(rebuilt, dense)
    assert ((dense != 0).sum(axis=1) <= 2).all()  # a frequency bin feeds two mel bins at most
    if (mels, fft) == (30, 512):
        assert (dense != 0).sum() == 460 and weights.size == 460


@pytest.mark.parametrize("fft", [512, 1024])
@pytest.mark.parametrize("mels", [30, 40, 80])
def test_banded_sum_has_the_dense_chain_bits(mels, fft):
    F = fft // 2 + 1
    dense = af.mel_filterbank(mels, F, 16000, 80.0, 7600.0)
    band, weights = kernels.mel_band_table(dense)
    rng = np.random.default_rng(mels + fft)
    re, im = (rng.standard_normal((6, F)).astype(np.float32) * 30 for _ in range(2))
    p = (re * re + im * im).astype(np.float32)
    p[0] = 0.0  # silence
    acc = np.zeros((6, mels), np.float32)
    for f in range(F):  # the dense sequential chain
        acc = fma32(p[:, f:f + 1], dense[f][None, :], acc)
    banded = np.zeros((6, mels), np.float32)
    for m, (f0, cnt, off) in enumerate(band):
        a = np.zeros(6, np.float32)
        for k in range(cnt):
            a = fma32(p[:, f0 + k], np.full(6, weights[off + k], np.float32), a)
        banded[:, m] = a
    np.testing.assert_array_equal(banded.view(np.uint32), acc.view(np.uint32))


def delta(col, t, N, T, origin=0):
    """Δ of ``col`` (indexed frame - origin) at frame t, indices clamped to [0, T)."""
    acc = np.float32(0.0)
    for n in range(1, N + 1):
        acc = acc + np.float32(n) * (col[min(t + n, T - 1) - origin] - col[max(t - n, 0) - origin])
    return acc / np.float32(2 * sum(n * n for n in range(1, N + 1)))


def mirror(re, im, feat_len, cfg, chunk):
    """K3's three launches with the kernel's index math, in numpy."""
    re, im, feat_len = re.numpy(), im.numpy(), feat_len.numpy()
    B, T, F = re.shape
    M, N = cfg.num_mel_bins, cfg.delta_window
    stack, skip, D = cfg.frame_stacking, cfg.frame_skipping, 3 * cfg.num_mel_bins
    Tp = max(0, (T - stack) // skip + 1)
    band, weights = kernels.mel_band_table(af._filterbank(cfg))
    # launch 1: the banded product, log-mel [B, M, T]
    p = re * re + im * im
    logmel = np.zeros((B, M, T), np.float32)
    for m, (f0, cnt, off) in enumerate(band):
        logmel[:, m, :] = np.log(p[:, :, f0:f0 + cnt] @ weights[off:off + cnt] + cfg.log_floor)
    # launch 2: a column's statistics
    mu = np.zeros((B, D), np.float32)
    inv = np.zeros((B, D), np.float32)
    new_len = np.zeros(B, np.int32)
    for b in range(B):
        L = int(feat_len[b])
        Lc = min(max(L, 0), T)
        last = max(Lc - 1, 0)
        Te, T1 = min(Lc + 2 * N, T), min(Lc + N, T)
        nl = max((L - stack) // skip + 1, min(L, 1))
        new_len[b] = min(max(nl, 0), Tp)
        for m in range(M):
            e = np.array([logmel[b, m, min(t, last)] for t in range(Te)], np.float32)
            d1 = np.array([delta(e, t, N, T) for t in range(T1)], np.float32)
            d2 = np.array([delta(d1, t, N, T) for t in range(Lc)], np.float32)
            cnt = np.float32(max(Lc, 1))
            for j, x in enumerate((e[:Lc], d1[:Lc], d2)):
                mean = x.sum(dtype=np.float32) / cnt
                var = ((x - mean) ** 2).sum(dtype=np.float32) / cnt
                mu[b, j * M + m] = mean
                inv[b, j * M + m] = 1.0 / np.sqrt(var + np.float32(1e-8))
    # launch 3: a block per (row, chunk of stacked frames)
    out = np.full((B, Tp, stack * D), np.nan, np.float32)
    for b in range(B):
        L = int(feat_len[b])
        Lc = min(max(L, 0), T)
        last = max(Lc - 1, 0)
        for tp0 in range(0, Tp, chunk):
            tp1 = min(tp0 + chunk, Tp)
            ta, tb = tp0 * skip, (tp1 - 1) * skip + stack - 1
            s0, s1 = max(ta - 2 * N, 0), min(tb + 2 * N, T - 1)
            u0, u1 = max(ta - N, 0), min(tb + N, T - 1)
            assert tb <= T - 1
            e = np.array([[logmel[b, m, min(f, last)] for f in range(s0, s1 + 1)]
                          for m in range(M)], np.float32)
            d1 = np.full_like(e, np.nan)  # only frames u0..u1 are formed
            for m in range(M):
                for t in range(u0, u1 + 1):
                    d1[m, t - s0] = delta(e[m], t, N, T, origin=s0)
            y = np.zeros((tb - ta + 1, D), np.float32)
            for t in range(ta, min(tb + 1, Lc)):
                for m in range(M):
                    x = (e[m, t - s0], d1[m, t - s0], delta(d1[m], t, N, T, origin=s0))
                    for j in range(3):
                        k = j * M + m
                        y[t - ta, k] = (x[j] - mu[b, k]) * inv[b, k]
            for tl in range(tp1 - tp0):
                live = tp0 + tl < new_len[b]
                run = y.reshape(-1)[tl * skip * D:(tl * skip + stack) * D]
                out[b, tp0 + tl] = run if live else 0.0
    return out, new_len


def frames(cfg, lengths, S, seed):
    rng = np.random.default_rng(seed)
    wav = (0.3 * rng.standard_normal((len(lengths), S))).astype(np.float32)
    lengths = np.asarray(lengths, np.int32)
    wav *= np.arange(S)[None, :] < lengths[:, None]
    re, im = af.stft(torch.from_numpy(wav), cfg.frame_length, cfg.frame_step, cfg.fft_length)
    lengths = torch.from_numpy(lengths)
    feat_len = torch.where(
        lengths >= cfg.frame_length,
        1 + torch.div(lengths - cfg.frame_length, cfg.frame_step, rounding_mode="floor"),
        torch.zeros_like(lengths)).to(torch.int32)
    return re, im, feat_len


@pytest.mark.parametrize("chunk", [1, 2, 4, 8, 16])
def test_mirror_equals_plain_ragged(chunk):
    """Rows of every frame (1 s), none (300 samples), 4 frames (1,000
    samples: fewer than a stack) and 6,100 samples."""
    re, im, feat_len = frames(CFG, [16000, 300, 1000, 6100], 16000, seed=chunk)
    want, want_len = af.logmel_post_dft_plain(re, im, feat_len, CFG)
    got, got_len = mirror(re, im, feat_len, CFG, chunk)
    np.testing.assert_array_equal(got_len, want_len.numpy())
    np.testing.assert_allclose(got, want.numpy(), atol=1e-4, rtol=0)


@pytest.mark.parametrize("mels,stack,skip", [(40, 4, 2), (30, 3, 1), (80, 1, 1)])
def test_mirror_equals_plain_other_framings(mels, stack, skip):
    cfg = dataclasses.replace(CFG, num_mel_bins=mels, frame_stacking=stack, frame_skipping=skip)
    re, im, feat_len = frames(cfg, [8000, 1000, 0], 8000, seed=mels)
    want, want_len = af.logmel_post_dft_plain(re, im, feat_len, cfg)
    for chunk in (3, kernels.logmel_writer_chunk(3, want.shape[1], mels, stack, skip, 2)):
        got, got_len = mirror(re, im, feat_len, cfg, chunk)
        np.testing.assert_array_equal(got_len, want_len.numpy())
        np.testing.assert_allclose(got, want.numpy(), atol=1e-4, rtol=0)


def test_writer_chunk_and_shared_memory():
    """The presets' 6 s request (B = 8, 197 stacked frames) takes chunks of
    4 (400 blocks), a B = 128 train batch chunks of 16 (1,664 blocks);
    every chunk of every shape fits a block's shared memory."""
    assert kernels.logmel_writer_chunk(8, 197) == 4
    assert kernels.logmel_writer_chunk(128, 197) == 16
    assert kernels.logmel_writer_chunk(1, 197) == 1
    for chunk in kernels.LOGMEL_CHUNKS:
        for M in (30, 40, 80):
            assert kernels.logmel_writer_smem(M, chunk, 8, 3, 2) <= kernels.SMEM_LIMIT


def test_statistics_take_every_length_the_first_kernel_took():
    """The first K3 held a column's log-mel, Δ and ΔΔ of T frames in one
    block (12 T bytes); its statistics now hold the log-mel and Δ (8 T
    bytes): every T the first took, 16 s (1,598 frames) among them, fits."""
    assert kernels.logmel_stats_fits(1598)
    assert kernels.logmel_stats_fits(kernels.SMEM_LIMIT // 12)  # the first kernel's longest
    assert not kernels.logmel_stats_fits(kernels.SMEM_LIMIT // 8 + 1)

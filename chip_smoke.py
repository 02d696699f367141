#!/usr/bin/env python3
"""GPU smoke test of the PyTorch port (``avsr_tpu_torch``) on one card.

    python3 chip_smoke.py

Phases, in order; any failure exits nonzero before the final line:

1. device  — require CUDA; print ``nvidia-smi`` name and power limit.
2. build   — compile the CUDA kernels from ``avsr_tpu_torch/csrc`` into
             ``build/`` (one nvcc per source, all started together,
             sm_90a) and print the build time.
3. K1      — the BiLSTM recurrence kernel against its plain PyTorch
             version on the card at [T=99, G=2, B=128, H=256], bf16, ragged
             lengths with a 0-length row; max errors and median CUDA-event
             times (B=128, B=8).
4. K3      — the post-DFT log-mel kernel against its plain version at
             [B=128, S=96000] (6 s at 16 kHz), ragged lengths; same report.
5. serve   — the full-width ``lrs2_av_fast`` model (random weights from a
             seeded generator) behind a CUDA ``Predictor`` with compact
             transfer, batch 8, 6 s audio / 150 frames, width-10 beam with
             horizon 150: transcribe 3 requests of 8 ragged utterances,
             require that the serving kernels (K1 fwd, K3, K4 fwd) launched
             during those requests, check the ids' shape and range, and
             hold the fused decoder memory of the kernel path against the
             plain path on the card.
6. K1 bwd  — the LSTM backward kernel against its plain twin on the same
             residuals and random cotangents at [T=99, G=2, B=128, H=256]:
             errors on dxw, db, dh0, dc0 and dWh; times at B=128 and B=8.
7. K4      — the fusion attention kernels, forward and backward, against
             their plain twins at [B=128, 4 heads, T_a=50, T_v=150,
             A=dv=128] with ragged video lengths including 0: errors on
             ctx, P, dq, dk, dv; times; and the errors again at the
             preset's 16 s limit (T_a=133, T_v=400, B=4).
8. train   — the full-width ``lrs2_av_fast`` train step at B=128, 6 s,
             label cap 80, AU targets, dropout 0.1, noise mixing on (a
             seeded synthetic two-type bank): (a) the loss and every
             gradient leaf of the kernel path against the plain path with
             the same generator seed, each kernel-path gradient present,
             finite and not all zero; (b) every kernel launched during the
             training steps; (c) 10 steps on one batch at a constant lr,
             the last loss below the first; (d) median ms per step after 2
             warm-up steps, 10 ms audio frames/s, peak device memory.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import json
import statistics
import subprocess
import sys
import time
from unittest import mock

import numpy as np

K1_TOL = 2e-2    # bf16 outputs (one bf16 ulp near 1 is 3.9e-3) and fp32 states
K3_TOL = 1e-3    # normalized fp32 features; sums in another order
MEMORY_TOL = 5e-2  # fused memory after 3+1 bf16 BiLSTM layers and the fusion
# K1 backward, max abs error over max |plain|: dgates are rounded to bf16
# (2^-8 relative) and feed the next step's dh product, so a one-ulp flip
# moves dh by about that much; dWh sums T*B such products in fp32.
K1B_REL_TOL = 2e-2
# K4: ctx is bf16 (abs 2e-2 at values of order 1); P is fp32 in [0, 1] but
# its scores are rounded to bf16 before the softmax, so a sum order that
# flips one rounding moves a weight by ~0.4% of itself; gradients are bf16
# (relative to the largest plain value).
K4_CTX_TOL = 2e-2
K4_P_TOL = 5e-3
K4_GRAD_REL_TOL = 2e-2
# train step, kernel path against plain path with the same draws: bf16
# rounding flips through 4 recurrent layers, forward and backward.
LOSS_REL_TOL = 1e-2
GRAD_LEAF_REL_TOL = 5e-2

SERVE_KERNELS = ("lstm_scan_fwd", "logmel_post_dft", "fusion_attention_fwd")


def fail(phase: str, msg: str) -> None:
    print(f"FAIL [{phase}]: {msg}", file=sys.stderr)
    sys.exit(1)


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median CUDA-event time of one call of ``fn``, in milliseconds."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def rel_err(a, b) -> float:
    """Max abs error over the largest |plain| value."""
    return max_err(a, b) / max(float(b.float().abs().max()), 1e-30)


def k1_inputs(T, G, B, H, dev, seed=0):
    import torch

    g = torch.Generator().manual_seed(seed)
    wh = torch.randn((G, H, 4 * H), generator=g) / H ** 0.5
    b = 0.1 * torch.randn((G, 4 * H), generator=g)
    xw = torch.randn((T, G, B, 4 * H), generator=g).to(torch.bfloat16)
    lengths = torch.randint(1, T + 1, (B,), generator=g)
    lengths[0] = T
    lengths[1] = 0  # a row with no valid step
    m = (torch.arange(T)[:, None] < lengths[None, :]).float()
    mask = torch.stack([m, torch.flip(m, (0,))], dim=1)[:, :G]
    h0 = torch.zeros((G, B, H))
    c0 = torch.zeros((G, B, H))
    return [x.to(dev) for x in (wh, b, xw, mask, h0, c0)]


def k1_bwd_inputs(T, G, B, H, dev, seed=0):
    """K1 operands, the kernel forward's residuals and random cotangents."""
    import torch

    from avsr_tpu_torch.ops import rnn

    wh, b, xw, mask, h0, c0 = k1_inputs(T, G, B, H, dev, seed)
    _, (h_res, c_res) = rnn.scan_core_fwd(wh, b, xw, mask, h0, c0, torch.bfloat16, save=True)
    g = torch.Generator().manual_seed(seed + 1)
    dys = torch.randn((T, G, B, H), generator=g).to(torch.bfloat16).to(dev)
    dhT = torch.randn((G, B, H), generator=g).to(dev)
    dcT = torch.randn((G, B, H), generator=g).to(dev)
    return [wh, b, xw, mask, h_res, c_res, dys, dhT, dcT, torch.bfloat16]


def k3_inputs(cfg, B, S, dev, seed=1):
    import torch

    from avsr_tpu_torch.ops import audio_features as af

    g = torch.Generator().manual_seed(seed)
    wav = 0.3 * torch.randn((B, S), generator=g)
    lengths = torch.randint(S // 2, S + 1, (B,), generator=g, dtype=torch.int32)
    lengths[0] = S
    lengths[1] = 300   # no full 400-sample frame: zero frames, zero output
    lengths[2] = 1000  # 4 frames, fewer than one 8-frame stack
    wav = wav * (torch.arange(S)[None, :] < lengths[:, None])
    wav, lengths = wav.to(dev), lengths.to(dev)
    re, im = af.stft(wav, cfg.frame_length, cfg.frame_step, cfg.fft_length, torch.bfloat16)
    feat_len = torch.where(
        lengths >= cfg.frame_length,
        1 + torch.div(lengths - cfg.frame_length, cfg.frame_step, rounding_mode="floor"),
        torch.zeros_like(lengths)).to(torch.int32)
    return re.contiguous(), im.contiguous(), feat_len


def k4_inputs(B, nh, Ta, Tv, A, dev, seed=2):
    import torch

    g = torch.Generator().manual_seed(seed)
    q = torch.randn((B, Ta, nh, A), generator=g).to(torch.bfloat16)
    k = torch.randn((B, Tv, nh, A), generator=g).to(torch.bfloat16)
    v = torch.randn((B, Tv, nh, A), generator=g).to(torch.bfloat16)
    vlen = torch.randint(1, Tv + 1, (B,), generator=g, dtype=torch.int32)
    vlen[0] = Tv
    vlen[1] = 0  # no video: the reference's uniform softmax over all keys
    dctx = torch.randn((B, Ta, nh, A), generator=g).to(torch.bfloat16)
    return [x.to(dev) for x in (q, k, v, vlen, dctx)]


def request(rng, n, seconds=6.0, fps=25.0):
    audio, video = [], []
    for _ in range(n):
        sec = float(rng.uniform(min(2.0, seconds / 2), seconds))
        ns = int(sec * 16000)
        t = np.arange(ns) / 16000.0
        f0 = rng.uniform(120, 300)
        wav = 0.3 * np.sin(2 * np.pi * f0 * t) + 0.2 * np.sin(2 * np.pi * 3.1 * f0 * t)
        audio.append((wav + 0.05 * rng.standard_normal(ns)).astype(np.float32))
        nf = min(int(np.ceil(sec * fps)), int(np.ceil(seconds * fps)))
        video.append(rng.uniform(0, 1, (nf, 36, 36, 1)).astype(np.float32))
    return audio, video


def train_batch(cfg, vocab_size, dev, B=128, seconds=6.0, label_cap=80, seed=3):
    """One bucket-3 batch as the loader ships it: int16 PCM, uint8 ROI
    crops, ragged 2-6 s utterances, EOS-terminated targets up to the label
    cap, AU targets at the frontend rate.  Returns (batch, 10 ms audio
    frames per step as ``bench.py`` counts them)."""
    from avsr_tpu.data.units import EOS_ID
    from avsr_tpu_torch.models import seq2seq

    rng = np.random.default_rng(seed)
    S = int(seconds * 16000)
    T_v = int(np.ceil(seconds * 25))
    audio, video = request(rng, B, seconds)
    arrays = {
        "audio": np.zeros((B, S), np.int16),
        "audio_lengths": np.array([len(a) for a in audio], np.int32),
        "video": np.zeros((B, T_v, 36, 36, 1), np.uint8),
        "video_lengths": np.array([len(v) for v in video], np.int32),
        "targets": np.zeros((B, label_cap), np.int32),
        "target_lengths": rng.integers(10, label_cap + 1, B).astype(np.int32),
        "au_row_weights": np.ones((B,), np.float32),
    }
    for i, (a, v) in enumerate(zip(audio, video)):
        arrays["audio"][i, :len(a)] = np.round(np.clip(a, -1, 1) * 32767).astype(np.int16)
        arrays["video"][i, :len(v)] = np.round(v * 255).astype(np.uint8)
        n = arrays["target_lengths"][i]
        arrays["targets"][i, :n - 1] = rng.integers(3, vocab_size, n - 1)
        arrays["targets"][i, n - 1] = EOS_ID
    T_front = (int((S - cfg.audio.frame_length) / cfg.audio.frame_step + 1)
               - cfg.audio.frame_stacking) // cfg.audio.frame_skipping + 1
    # AU intensities: a level per utterance in [0, 1] with small frame noise
    # (learnable, as real slowly varying intensities are; N(0, 1) targets
    # would sit at the loss floor from the first step)
    level = rng.uniform(0.0, 1.0, (B, 1, cfg.fusion.au_dim))
    arrays["au_targets"] = (level + 0.05 * rng.standard_normal(
        (B, T_front, cfg.fusion.au_dim))).astype(np.float32)
    return seq2seq.batch_to_device(arrays, dev), B * int(
        (S - cfg.audio.frame_length) / cfg.audio.frame_step + 1)


def noise_bank(cfg, dev, seed=4, rows=8, length=120000):
    """A synthetic two-type bank from a seed: tone mixtures ("babble") and
    white noise ("cafe"), longer than the 6 s waveform."""
    from avsr_tpu_torch.ops.noise import NoiseBank

    rng = np.random.default_rng(seed)
    t = np.arange(length) / 16000.0
    babble = sum(np.sin(2 * np.pi * rng.uniform(100, 400, (rows, 1)) * t[None, :]
                        + rng.uniform(0, 6.3, (rows, 1))) for _ in range(5))
    cafe = rng.standard_normal((rows, length))
    banks = {"babble": 0.1 * babble, "cafe": 0.05 * cafe}
    return NoiseBank.create({n: banks[n].astype(np.float32) for n in cfg.noise.noise_types},
                            device=dev)


@contextlib.contextmanager
def plain_cores():
    """Route every kernel wrapper to its plain version (reference runs)."""
    from avsr_tpu_torch.models import fusion as fus
    from avsr_tpu_torch.ops import audio_features as af
    from avsr_tpu_torch.ops import rnn

    with mock.patch.object(rnn, "scan_core_fwd", rnn.bilstm_scan_core_fwd_impl), \
            mock.patch.object(rnn, "scan_core_bwd", rnn.bilstm_scan_core_bwd_plain), \
            mock.patch.object(af, "logmel_post_dft", af.logmel_post_dft_plain), \
            mock.patch.object(fus, "fusion_attention_fwd", fus.fusion_attention_fwd_plain), \
            mock.patch.object(fus, "fusion_attention_bwd", fus.fusion_attention_bwd_plain):
        yield


def phase_k1(dev, report):
    import torch

    from avsr_tpu_torch.ops import rnn

    # the audio encoder's first-layer shape (T = 99 after the (2,...) pyramid)
    wh, b, xw, mask, h0, c0 = k1_inputs(99, 2, 128, 256, dev)
    ys_k, hT_k, cT_k = rnn.bilstm_scan_core(wh, b, xw, mask, h0, c0, torch.bfloat16)
    ys_p, hT_p, cT_p = rnn.bilstm_scan_core_plain(wh, b, xw, mask, h0, c0, torch.bfloat16)
    torch.cuda.synchronize()
    errs = {"ys": max_err(ys_k, ys_p), "hT": max_err(hT_k, hT_p), "cT": max_err(cT_k, cT_p)}
    k1_err = max(errs.values())
    print(f"K1 max abs err {errs} (tol {K1_TOL})")
    if not (k1_err <= K1_TOL) or not torch.isfinite(ys_k.float()).all():
        fail("K1", f"kernel disagrees with the plain version: {errs}")
    k1 = {}
    for B in (128, 8):
        args = k1_inputs(99, 2, B, 256, dev, seed=B)
        k1[B] = (time_ms(lambda: rnn.bilstm_scan_core(*args, torch.bfloat16)),
                 time_ms(lambda: rnn.bilstm_scan_core_plain(*args, torch.bfloat16), reps=5))
        print(f"K1 [T=99,G=2,B={B},H=256] kernel {k1[B][0]:.4f} ms  plain {k1[B][1]:.4f} ms")
    report["lstm_scan_fwd"] = (k1_err, k1[128][0], k1[128][1])


def phase_k3(dev, report, cfg):
    import torch

    from avsr_tpu_torch.ops import audio_features as af

    re, im, feat_len = k3_inputs(cfg.audio, 128, 96000, dev)
    f_k, n_k = af.logmel_post_dft(re, im, feat_len, cfg.audio)
    f_p, n_p = af.logmel_post_dft_plain(re, im, feat_len, cfg.audio)
    torch.cuda.synchronize()
    k3_err = max_err(f_k, f_p)
    print(f"K3 max abs err {k3_err} (tol {K3_TOL}); out {tuple(f_k.shape)}")
    if not torch.equal(n_k, n_p):
        fail("K3", "kernel and plain lengths differ")
    if not (k3_err <= K3_TOL) or not torch.isfinite(f_k).all():
        fail("K3", f"kernel disagrees with the plain version: {k3_err}")
    k3 = {}
    for B in (128, 8):
        args = k3_inputs(cfg.audio, B, 96000, dev, seed=B)
        k3[B] = (time_ms(lambda: af.logmel_post_dft(*args, cfg.audio)),
                 time_ms(lambda: af.logmel_post_dft_plain(*args, cfg.audio), reps=10))
        print(f"K3 [B={B},S=96000] kernel {k3[B][0]:.4f} ms  plain {k3[B][1]:.4f} ms")
    report["logmel_post_dft"] = (k3_err, k3[128][0], k3[128][1])


def phase_serve(dev, card, cfg):
    import torch

    from avsr_tpu.data.units import builtin_unit_dict
    from avsr_tpu_torch import kernels
    from avsr_tpu_torch.models import seq2seq
    from avsr_tpu_torch.serve import Predictor
    from avsr_tpu_torch.utils.params import param_count

    units = builtin_unit_dict(cfg.data.unit)
    t0 = time.perf_counter()
    params = seq2seq.model_init(cfg, units.vocab_size, torch.Generator().manual_seed(0), dev)
    pred = Predictor(params, cfg, units, device=dev, batch_size=8, audio_seconds=6.0,
                     transfer="compact")
    print(f"serve: model_init {time.perf_counter() - t0:.3f} s, "
          f"{param_count(params)} params")
    rng = np.random.default_rng(0)
    requests = [request(rng, 8) for _ in range(4)]
    pred.transcribe(audio=requests[0][0], video=requests[0][1])  # warm-up request
    torch.cuda.synchronize()

    kernels.reset_launches()
    latencies, texts = [], []
    for audio, video in requests[1:]:
        t0 = time.perf_counter()
        texts.append(pred.transcribe(audio=audio, video=video))
        torch.cuda.synchronize()
        latencies.append((time.perf_counter() - t0) * 1e3)
    launches = dict(kernels.LAUNCHES)
    print(f"serve launches {launches}")
    for name in SERVE_KERNELS:
        if launches[name] == 0:
            fail("serve", f"kernel {name} was not launched by the serving path")
    if any(len(t) != 8 for t in texts):
        fail("serve", "wrong number of transcripts")

    arrays, _ = pred.assemble(*requests[1])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    enc_k = pred.encode(arrays)
    torch.cuda.synchronize()
    t_enc = (time.perf_counter() - t0) * 1e3
    res = pred.beam(enc_k)
    t_beam = (time.perf_counter() - t0) * 1e3 - t_enc
    ids = res.ids
    V = units.vocab_size
    if tuple(ids.shape) != (8, cfg.decode.max_decode_length) or int(ids.min()) < 0 \
            or int(ids.max()) >= V:
        fail("serve", f"ids of shape {tuple(ids.shape)} in [{int(ids.min())}, {int(ids.max())}]")
    before = dict(kernels.LAUNCHES)
    with plain_cores():
        enc_p = pred.encode(arrays)
    if kernels.LAUNCHES != before:
        fail("serve", "the plain reference run launched a kernel")
    mk, mp = enc_k.memories[0].values, enc_p.memories[0].values
    if tuple(mk.shape) != (8, 50, 1024) or not torch.isfinite(mk).all():
        fail("serve", f"fused memory of shape {tuple(mk.shape)} or not finite")
    mem_err = max_err(mk, mp)
    mem_mean = float((mk - mp).abs().mean())
    print(f"serve fused memory {tuple(mk.shape)}: max abs err {mem_err} mean {mem_mean} "
          f"(tol {MEMORY_TOL}) vs the plain path")
    if not mem_err <= MEMORY_TOL:
        fail("serve", f"kernel path memory disagrees with the plain path: {mem_err}")
    print(f"serve [{card}] per-request latency ms (B=8, 6 s, beam 10, horizon 150): "
          f"{[round(x, 3) for x in latencies]} median {statistics.median(latencies):.3f}; "
          f"encode {t_enc:.3f} ms, beam {t_beam:.3f} ms ({res.steps} steps)")
    print(f"serve sample transcript: {texts[0][0][:60]!r}")


def phase_k1_bwd(dev, report):
    import torch

    from avsr_tpu_torch.ops import rnn

    args = k1_bwd_inputs(99, 2, 128, 256, dev)
    out_k = rnn.scan_core_bwd(*args)
    out_p = rnn.bilstm_scan_core_bwd_plain(*args)
    torch.cuda.synchronize()
    names = ("dWh", "db", "dxw", "dh0", "dc0")
    errs = {n: rel_err(a, b) for n, a, b in zip(names, out_k, out_p)}
    abs_errs = {n: max_err(a, b) for n, a, b in zip(names, out_k, out_p)}
    print(f"K1 bwd max abs err {abs_errs}; relative to max |plain| {errs} "
          f"(tol {K1B_REL_TOL})")
    if not all(torch.isfinite(x.float()).all() for x in out_k):
        fail("K1 bwd", "non-finite kernel output")
    if not max(errs.values()) <= K1B_REL_TOL:
        fail("K1 bwd", f"kernel disagrees with the plain twin: {errs}")
    times = {}
    for B in (128, 8):
        a = k1_bwd_inputs(99, 2, B, 256, dev, seed=B)
        if B == 8:  # half a row tile: the kernels' zero-filled rows
            small = max(rel_err(x, y) for x, y in zip(rnn.scan_core_bwd(*a),
                                                       rnn.bilstm_scan_core_bwd_plain(*a)))
            print(f"K1 bwd at B=8: max relative err {small} (tol {K1B_REL_TOL})")
            if not small <= K1B_REL_TOL:
                fail("K1 bwd", f"kernel disagrees with the plain twin at B=8: {small}")
        times[B] = (time_ms(lambda: rnn.scan_core_bwd(*a)),
                    time_ms(lambda: rnn.bilstm_scan_core_bwd_plain(*a), reps=5))
        print(f"K1 bwd [T=99,G=2,B={B},H=256] kernel {times[B][0]:.4f} ms  "
              f"plain {times[B][1]:.4f} ms")
    report["lstm_scan_bwd"] = (max(abs_errs.values()), times[128][0], times[128][1])


def phase_k4(dev, report):
    import torch

    from avsr_tpu_torch.models import fusion as fus

    q, k, v, vlen, dctx = k4_inputs(128, 4, 50, 150, 128, dev)
    ctx_k, w_k = fus.fusion_attention_fwd(q, k, v, vlen)
    ctx_p, w_p = fus.fusion_attention_fwd_plain(q, k, v, vlen)
    g_k = fus.fusion_attention_bwd(q, k, v, w_p, dctx)
    g_p = fus.fusion_attention_bwd_plain(q, k, v, w_p, dctx)
    torch.cuda.synchronize()
    fwd_errs = {"ctx": max_err(ctx_k, ctx_p), "P": max_err(w_k, w_p)}
    grad_errs = {n: rel_err(a, b) for n, a, b in zip(("dq", "dk", "dv"), g_k, g_p)}
    grad_abs = {n: max_err(a, b) for n, a, b in zip(("dq", "dk", "dv"), g_k, g_p)}
    print(f"K4 fwd max abs err {fwd_errs} (tol ctx {K4_CTX_TOL}, P {K4_P_TOL}); "
          f"row of length 0 uniform: {float(w_k[1].min())}..{float(w_k[1].max())}")
    print(f"K4 bwd max abs err {grad_abs}; relative to max |plain| {grad_errs} "
          f"(tol {K4_GRAD_REL_TOL})")
    if not (fwd_errs["ctx"] <= K4_CTX_TOL and fwd_errs["P"] <= K4_P_TOL):
        fail("K4", f"forward kernel disagrees with the plain twin: {fwd_errs}")
    if not max(grad_errs.values()) <= K4_GRAD_REL_TOL:
        fail("K4", f"backward kernel disagrees with the plain twin: {grad_errs}")
    # the preset's 16 s limit: T_v = 400 frames, T_a = 133 fused steps
    lq, lk, lv, lvlen, ldctx = k4_inputs(4, 4, 133, 400, 128, dev, seed=3)
    lctx_k, lw_k = fus.fusion_attention_fwd(lq, lk, lv, lvlen)
    lctx_p, lw_p = fus.fusion_attention_fwd_plain(lq, lk, lv, lvlen)
    long_errs = {"ctx": max_err(lctx_k, lctx_p), "P": max_err(lw_k, lw_p)}
    long_errs.update({n: rel_err(a, b) for n, a, b in zip(
        ("dq", "dk", "dv"), fus.fusion_attention_bwd(lq, lk, lv, lw_p, ldctx),
        fus.fusion_attention_bwd_plain(lq, lk, lv, lw_p, ldctx))})
    print(f"K4 at [B=4,T_a=133,T_v=400]: ctx/P max abs err, dq/dk/dv relative {long_errs}")
    if not (long_errs["ctx"] <= K4_CTX_TOL and long_errs["P"] <= K4_P_TOL
            and max(long_errs[n] for n in ("dq", "dk", "dv")) <= K4_GRAD_REL_TOL):
        fail("K4", f"kernels disagree with the plain twins at T_v=400: {long_errs}")
    t = {
        "fwd": (time_ms(lambda: fus.fusion_attention_fwd(q, k, v, vlen)),
                time_ms(lambda: fus.fusion_attention_fwd_plain(q, k, v, vlen))),
        "bwd": (time_ms(lambda: fus.fusion_attention_bwd(q, k, v, w_p, dctx)),
                time_ms(lambda: fus.fusion_attention_bwd_plain(q, k, v, w_p, dctx))),
    }
    for name, (tk, tp) in t.items():
        print(f"K4 {name} [B=128,nh=4,T_a=50,T_v=150,A=128] kernel {tk:.4f} ms  "
              f"plain {tp:.4f} ms")
    report["fusion_attention_fwd"] = (max(fwd_errs.values()), *t["fwd"])
    report["fusion_attention_bwd"] = (max(grad_abs.values()), *t["bwd"])


def phase_train(dev, card, cfg):
    import dataclasses

    import torch

    from avsr_tpu.configs import NoiseConfig
    from avsr_tpu.data.units import builtin_unit_dict
    from avsr_tpu_torch import kernels
    from avsr_tpu_torch.train import step as tstep
    from avsr_tpu_torch.utils import rng as trng
    from avsr_tpu_torch.utils.params import tree_leaves

    cfg = cfg.replace(noise=NoiseConfig(enabled=True))
    V = builtin_unit_dict(cfg.data.unit).vocab_size
    batch, frames_per_step = train_batch(cfg, V, dev)
    bank = noise_bank(cfg, dev)
    state, _ = tstep.create_train_state(cfg, V, torch.Generator().manual_seed(0), dev)
    names = ["/".join(map(str, p)) for p, _ in tree_leaves(state.params)]

    # (a) agreement with the plain path, same draws
    m_k, g_k = tstep.loss_and_grads(state.params, batch, cfg=cfg,
                                    generator=trng.generator_for(7, dev), noise_bank=bank)
    before = dict(kernels.LAUNCHES)
    with plain_cores():
        m_p, g_p = tstep.loss_and_grads(state.params, batch, cfg=cfg,
                                        generator=trng.generator_for(7, dev), noise_bank=bank)
    torch.cuda.synchronize()
    if kernels.LAUNCHES != before:
        fail("train", "the plain reference run launched a kernel")
    for n, g in zip(names, g_k):
        if g is None:
            fail("train", f"no gradient reaches {n} on the kernel path")
        if not torch.isfinite(g).all() or not bool((g != 0).any()):
            fail("train", f"gradient of {n} is non-finite or all zero on the kernel path")
    loss_rel = abs(float(m_k["loss"]) - float(m_p["loss"])) / abs(float(m_p["loss"]))
    rels = {n: float((a - b).norm() / b.norm()) for n, a, b in zip(names, g_k, g_p)}
    worst = max(rels, key=rels.get)
    print(f"train (a) loss kernel {float(m_k['loss']):.6f} plain {float(m_p['loss']):.6f} "
          f"(rel diff {loss_rel:.3e}, tol {LOSS_REL_TOL}); {len(names)} gradient leaves, "
          f"all present, finite, nonzero; worst leaf rel err {rels[worst]:.3e} ({worst}), "
          f"median {statistics.median(rels.values()):.3e} (tol {GRAD_LEAF_REL_TOL})")
    if not (loss_rel <= LOSS_REL_TOL and rels[worst] <= GRAD_LEAF_REL_TOL):
        fail("train", "kernel path disagrees with the plain path")

    # (b)-(d): 10 steps on the batch at a constant lr, launches counted.  The
    # preset warms up to 1e-3 over 400 steps; a constant 1e-3 from random
    # weights overshoots (Adam's first steps move every weight by ~lr), so
    # the check runs at a tenth of the peak.
    cfg_c = cfg.replace(train=dataclasses.replace(cfg.train, lr_schedule="constant",
                                                  learning_rate=1e-4))
    state, opt = tstep.create_train_state(cfg_c, V, torch.Generator().manual_seed(0), dev)
    gen = torch.Generator().manual_seed(11)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    losses, parts, times = [], [], []
    for _ in range(10):
        t0 = time.perf_counter()
        state, metrics = tstep.train_step(state, batch, cfg=cfg_c, optimizer=opt,
                                          generator=gen, noise_bank=bank)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(metrics["loss"]))
        parts.append((float(metrics["ce_loss"]), float(metrics["au_loss"])))
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    print(f"train (b) launches over 10 steps {launches}")
    for name, n in launches.items():
        if n == 0:
            fail("train", f"kernel {name} was not launched by the training steps")
    print(f"train (c) losses {[round(x, 4) for x in losses]} (ce, au) "
          f"{[(round(c, 4), round(a, 4)) for c, a in parts]}; grad_norm last "
          f"{float(metrics['grad_norm']):.4f}")
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        fail("train", "the loss did not fall over 10 steps")
    step_ms = statistics.median(times[2:])
    print(f"train (d) [{card}] lrs2_av_fast B=128 6 s: ms/step {[round(x, 3) for x in times]} "
          f"median after 2 warm-up {step_ms:.3f}; {frames_per_step / step_ms * 1e3:.0f} "
          f"10 ms audio frames/s; peak memory {peak / 2**30:.3f} GiB")
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        from avsr_tpu.configs import lrs2_av_fast
        from avsr_tpu_torch import kernels
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here ({e})", file=sys.stderr)
        return 2

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    t_start = time.perf_counter()

    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail("device", f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0].strip()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {kind}")

    # 2. build
    t0 = time.perf_counter()
    try:
        lib = kernels.build()
    except RuntimeError as e:
        fail("build", str(e))
    print(f"build: {time.perf_counter() - t0:.3f} s -> {lib.name} "
          f"(nvcc {kernels.BUILD_SECONDS if kernels.BUILD_SECONDS is not None else 'cached'} s)")

    cfg = lrs2_av_fast()
    report = {}
    for n, run in ((3, lambda: phase_k1(dev, report)),
                   (4, lambda: phase_k3(dev, report, cfg)),
                   (5, lambda: phase_serve(dev, card, cfg)),
                   (6, lambda: phase_k1_bwd(dev, report)),
                   (7, lambda: phase_k4(dev, report)),
                   (8, lambda: report.update(launches=phase_train(dev, card, cfg)))):
        t0 = time.perf_counter()
        run()
        print(f"phase {n}: {time.perf_counter() - t0:.1f} s")
    print(f"total {time.perf_counter() - t_start:.1f} s")

    sources = {
        "lstm_scan_fwd": ("avsr_tpu_torch/csrc/lstm_scan.cu", "avsr_tpu/ops/rnn.py:341"),
        "lstm_scan_bwd": ("avsr_tpu_torch/csrc/lstm_scan.cu", "avsr_tpu/ops/rnn.py:382"),
        "logmel_post_dft": ("avsr_tpu_torch/csrc/logmel.cu",
                            "avsr_tpu/ops/audio_features.py:242"),
        "fusion_attention_fwd": ("avsr_tpu_torch/csrc/cross_attention.cu",
                                 "avsr_tpu/models/fusion.py:226"),
        "fusion_attention_bwd": ("avsr_tpu_torch/csrc/cross_attention.cu",
                                 "avsr_tpu/models/fusion.py:226"),
    }
    launches = report["launches"]
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], "max_abs_err": report[name][0],
         "ms": report[name][1], "plain_ms": report[name][2]}
        for name, (src, rep) in sources.items()]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""GPU smoke test of the PyTorch port (``avsr_tpu_torch``) on one card.

    python3 chip_smoke.py

Phases, in order; any failure exits nonzero before the final line:

1. device  — require CUDA; print ``nvidia-smi`` name and power limit.
2. build   — compile the CUDA kernels from ``avsr_tpu_torch/csrc`` into
             ``build/`` (nvcc, sm_90a) and print the build time.
3. K1      — the BiLSTM recurrence kernel against its plain PyTorch
             version on the card at [T=99, G=2, B=128, H=256], bf16, ragged
             lengths; max errors and median CUDA-event times (B=128, B=8).
4. K3      — the post-DFT log-mel kernel against its plain version at
             [B=128, S=96000] (6 s at 16 kHz), ragged lengths; same report.
5. slice   — the full-width ``lrs2_av_fast`` model (random weights from a
             seeded generator) behind a CUDA ``Predictor`` with compact
             transfer, batch 8, 6 s audio / 150 frames, width-10 beam with
             horizon 150: transcribe 3 requests of 8 ragged utterances,
             require that both kernels launched during those requests,
             check the ids' shape and range, and hold the fused decoder
             memory of the kernel path against the plain path on the card.

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


def k1_inputs(T, G, B, H, dev, seed=0):
    import torch

    g = torch.Generator().manual_seed(seed)
    wh = torch.randn((G, H, 4 * H), generator=g) / H ** 0.5
    b = 0.1 * torch.randn((G, 4 * H), generator=g)
    xw = torch.randn((T, G, B, 4 * H), generator=g).to(torch.bfloat16)
    lengths = torch.randint(1, T + 1, (B,), generator=g)
    lengths[0] = T
    m = (torch.arange(T)[:, None] < lengths[None, :]).float()
    mask = torch.stack([m, torch.flip(m, (0,))], dim=1)[:, :G]
    h0 = torch.zeros((G, B, H))
    c0 = torch.zeros((G, B, H))
    return [x.to(dev) for x in (wh, b, xw, mask, h0, c0)]


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


def request(rng, n, seconds=6.0, fps=25.0):
    audio, video = [], []
    for _ in range(n):
        sec = float(rng.uniform(2.0, seconds))
        ns = int(sec * 16000)
        t = np.arange(ns) / 16000.0
        f0 = rng.uniform(120, 300)
        wav = 0.3 * np.sin(2 * np.pi * f0 * t) + 0.2 * np.sin(2 * np.pi * 3.1 * f0 * t)
        audio.append((wav + 0.05 * rng.standard_normal(ns)).astype(np.float32))
        nf = min(int(np.ceil(sec * fps)), int(np.ceil(seconds * fps)))
        video.append(rng.uniform(0, 1, (nf, 36, 36, 1)).astype(np.float32))
    return audio, video


@contextlib.contextmanager
def plain_cores():
    """Route the slice through the kernels' plain versions (reference run)."""
    from avsr_tpu_torch.ops import audio_features as af
    from avsr_tpu_torch.ops import rnn

    with mock.patch.object(rnn, "bilstm_scan_core", rnn.bilstm_scan_core_plain), \
            mock.patch.object(af, "logmel_post_dft", af.logmel_post_dft_plain):
        yield


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        from avsr_tpu.configs import lrs2_av_fast
        from avsr_tpu.data.units import builtin_unit_dict
        from avsr_tpu_torch import kernels
        from avsr_tpu_torch.models import seq2seq
        from avsr_tpu_torch.ops import audio_features as af
        from avsr_tpu_torch.ops import rnn
        from avsr_tpu_torch.serve import Predictor
        from avsr_tpu_torch.utils.params import param_count
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here ({e})", file=sys.stderr)
        return 2

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)

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

    report = {}

    # 3. K1 at the audio encoder's first-layer shape (T = 99 after the (2,...) pyramid)
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
    report["K1"] = (k1_err, k1)

    # 4. K3 at 6 s of 16 kHz audio
    cfg = lrs2_av_fast()
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
    report["K3"] = (k3_err, k3)

    # 5. the slice: full-width lrs2_av_fast behind a CUDA Predictor
    units = builtin_unit_dict(cfg.data.unit)
    t0 = time.perf_counter()
    params = seq2seq.model_init(cfg, units.vocab_size, torch.Generator().manual_seed(0), dev)
    pred = Predictor(params, cfg, units, device=dev, batch_size=8, audio_seconds=6.0,
                     transfer="compact")
    print(f"slice: model_init {time.perf_counter() - t0:.3f} s, "
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
    print(f"slice launches {launches}")
    for name, n in launches.items():
        if n == 0:
            fail("slice", f"kernel {name} was not launched by the main path")
    if any(len(t) != 8 for t in texts):
        fail("slice", "wrong number of transcripts")

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
        fail("slice", f"ids of shape {tuple(ids.shape)} in [{int(ids.min())}, {int(ids.max())}]")
    before = dict(kernels.LAUNCHES)
    with plain_cores():
        enc_p = pred.encode(arrays)
    if kernels.LAUNCHES != before:
        fail("slice", "the plain reference run launched a kernel")
    mk, mp = enc_k.memories[0].values, enc_p.memories[0].values
    if tuple(mk.shape) != (8, 50, 1024) or not torch.isfinite(mk).all():
        fail("slice", f"fused memory of shape {tuple(mk.shape)} or not finite")
    mem_err = max_err(mk, mp)
    mem_mean = float((mk - mp).abs().mean())
    print(f"slice fused memory {tuple(mk.shape)}: max abs err {mem_err} mean {mem_mean} "
          f"(tol {MEMORY_TOL}) vs the plain path")
    if not mem_err <= MEMORY_TOL:
        fail("slice", f"kernel path memory disagrees with the plain path: {mem_err}")
    print(f"slice [{card}] per-request latency ms (B=8, 6 s, beam 10, horizon 150): "
          f"{[round(x, 3) for x in latencies]} median {statistics.median(latencies):.3f}; "
          f"encode {t_enc:.3f} ms, beam {t_beam:.3f} ms ({res.steps} steps)")
    print(f"slice sample transcript: {texts[0][0][:60]!r}")

    kernels_line = {"kernels": [
        {"name": "lstm_scan_fwd", "route": "cuda", "source": "avsr_tpu_torch/csrc/lstm_scan.cu",
         "replaces": "avsr_tpu/ops/rnn.py:341", "launches": launches["lstm_scan_fwd"],
         "max_abs_err": report["K1"][0], "ms": report["K1"][1][128][0],
         "plain_ms": report["K1"][1][128][1]},
        {"name": "logmel_post_dft", "route": "cuda", "source": "avsr_tpu_torch/csrc/logmel.cu",
         "replaces": "avsr_tpu/ops/audio_features.py:242",
         "launches": launches["logmel_post_dft"], "max_abs_err": report["K3"][0],
         "ms": report["K3"][1][128][0], "plain_ms": report["K3"][1][128][1]},
    ]}
    print(json.dumps(kernels_line))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

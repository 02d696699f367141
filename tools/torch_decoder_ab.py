#!/usr/bin/env python3
"""Time K5, K6 and K7, the decoder's attention kernels and the beam step, in several checkouts on one card.

    python3 tools/torch_decoder_ab.py --trees build/parent . --order ABBA [--parts k5 k6 k7]

Each run is a process of its own started in one checkout (``--trees``, A
first, then B, C, ...): it builds that checkout's kernels and times the
device work of its ``models.transformer_decoder`` wrappers (chip_smoke's
``device_ms``: CUDA events around 20 calls queued behind a spin kernel).

K5, the teacher-forced attention (``--parts k5``), on chip_smoke's
``k5_inputs`` at three shapes: lrs2_av_fast's causal self attention [B=128,
Q=S=80, 4 heads, 64] and cross attention [B=128, Q=80, S=50, dk=128,
dv=256], and lrs2_av_v2's cross attention (S=197), the bias masking a
ragged tail of each memory and every key of one.  The forward is timed in
save mode, as a train step runs it, and the backward from that forward's
residual, whichever the checkout's backward takes (the fp32 weights, or
the softmax's row statistics).  Each run also times the library yardstick,
``scaled_dot_product_attention`` with the same additive mask, forward and
backward (chip_smoke's ``sdpa_bwd_device_ms``: autograd's device time less
the forward's).

K6, the decode step's single-query attention (``--parts k6``), on
chip_smoke's ``k6_inputs``: a serve request's beam step, N = 80 rows (B =
8 utterances, W = 10 beams), self attention over the 150-step cache at
position 149 and cross attention over the fast (S = 50) and the v2 (S =
197) memory; a greedy step, N = 128 rows of one beam, the same reads.  A
checkout whose K6 reads the untiled memory (``kernels.decode_attention_route``)
gets B memory rows; an older one the memory tiled over the beams, as its
beam search gave it (the tiling is set-up, outside the timed calls).  The
pairs (self + cross) are summed from the parts.

K7, the beam step (``--parts k7``), on chip_smoke's ``k7_inputs`` at [B=8,
W=10, V=44] (a serve request) and B=128: the device ms and the CUDA-event
ms of one step as the checkout's beam search calls it (its
``decode.beam.beam_stepper``'s step, checked once per search, where it has
one; else the one-shot ``beam_step``); then 150 steps of the search's loop
without the decoder (the step and the loop's condition with its host
sync, as the checkout's ``beam_search`` issues them), their host us and
device events a step; then the full-width ``lrs2_av_fast`` beam search of
one B=8 request (random weights from a seed, 6 s, width 10, horizon 150:
``Predictor.beam`` on encoded memories), its ms (host clock, median of 5)
and device events a beam step under the profiler.

The runs go in ``--order`` (A B B A by default), so the checkouts share the
card's state; the last line is one JSON object with every run's numbers.
Needs a CUDA card; another checkout is typically the parent commit
unpacked with ``git archive`` into a git-ignored directory.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

RUN = r"""
import inspect, json, sys
sys.path.insert(0, ".")
import torch
import chip_smoke as cs
from avsr_tpu_torch import kernels
from avsr_tpu_torch.models import transformer_decoder as tdec

kernels.build()
dev = torch.device("cuda", 0)
stats = "row_max" in inspect.signature(tdec.decoder_attention_bwd).parameters
out = {}
for name, Q, S, dk, dv, causal in (("fast_self", 80, 80, 64, 64, True),
                                   ("fast_cross", 80, 50, 128, 256, False),
                                   ("v2_cross", 80, 197, 128, 256, False)) if "k5" in PARTS else ():
    q, k, v, bias, dctx = cs.k5_inputs(128, Q, S, dk, dv, dev, causal, seed=Q + S + dv)
    res = tdec.decoder_attention_fwd(q, k, v, bias, save=True)[1]
    args = (q, k, v, bias, *res) if stats else (q, k, v, res)
    mask = (torch.triu(torch.full((Q, S), -1e9, device=dev), diagonal=1) if causal
            else bias[:, None, None, :]).to(torch.bfloat16)
    out[f"fwd_{name}"] = cs.device_ms(lambda: tdec.decoder_attention_fwd(q, k, v, bias, save=True))
    out[f"bwd_{name}"] = cs.device_ms(lambda: tdec.decoder_attention_bwd(*args, dctx))
    out[f"sdpa_fwd_{name}"] = cs.device_ms(lambda: cs.sdpa(q, k, v, mask))
    out[f"sdpa_bwd_{name}"] = cs.sdpa_bwd_device_ms(q, k, v, mask, dctx)


def k6_inputs(N, B, L, dk, dv, cross, seed):
    # q [N, 4, dk] against B key rows; the memory's lengths ragged, row 1 empty
    g = torch.Generator().manual_seed(seed)
    q = torch.randn((N, 4, dk), generator=g).to(torch.bfloat16)
    k = torch.randn((B, L, 4, dk), generator=g).to(torch.bfloat16)
    v = torch.randn((B, L, 4, dv), generator=g).to(torch.bfloat16)
    bias = None
    if cross:
        lens = torch.randint(1, L + 1, (B,), generator=g)
        lens[0], lens[1] = L, 0
        bias = (1.0 - (torch.arange(L)[None, :] < lens[:, None]).float()) * -1e30
    return [None if x is None else x.to(dev) for x in (q, k, v, bias)]


untiled = hasattr(kernels, "decode_attention_route")
for N, B in ((80, 8), (128, 128)) if "k6" in PARTS else ():
    q, k, v, _ = k6_inputs(N, N, 150, 64, 64, False, seed=N)
    self_ms = cs.device_ms(lambda: tdec.decode_attention(q, k, v, None, 150))
    out[f"k6_self_N{N}"] = self_ms
    for S in (50, 197):
        qc, kc, vc, bc = k6_inputs(N, B, S, 128, 256, True, seed=N + S)
        if not untiled:
            kc, vc, bc = (x.repeat_interleave(N // B, dim=0) for x in (kc, vc, bc))
        ms = cs.device_ms(lambda: tdec.decode_attention(qc, kc, vc, bc, S))
        out[f"k6_cross_S{S}_N{N}"] = ms
        out[f"k6_pair_S{S}_N{N}"] = self_ms + ms


def k7_loop(B):
    # a search's step and loop condition on fixed inputs: (call, loop step)
    from avsr_tpu_torch.decode import beam
    W, V = 10, 44
    logits, logp, lens, finished = cs.k7_inputs(B, W, V, dev, seed=8)
    lp = beam.length_penalty_table(150, 0.0, dev)
    tokens = torch.empty((150, B, W), dtype=torch.int64, device=dev)
    parents = torch.empty((150, B, W), dtype=torch.int64, device=dev)
    if hasattr(beam, "beam_stepper"):
        carries = (beam.step_buffers(B, W, dev), beam.step_buffers(B, W, dev))
        for c in carries:
            for x, y in zip((c.logp, c.lens, c.finished), (logp, lens, finished)):
                x.copy_(y)
        step = beam.beam_stepper(lp, tokens, parents, carries, V)

        def loop(t):
            step(logits, t, t % 2)
            return bool(carries[1 - t % 2].settled.all())
        return (lambda: step(logits, 0, 0)), loop

    def loop(t):
        settled = finished | (logp < -1.0e30 / 2)
        done = bool(settled.all())
        beam.beam_step(logits, logp, lens, finished, lp, tokens[t], parents[t])
        return done
    return (lambda: beam.beam_step(logits, logp, lens, finished, lp, tokens[0], parents[0])), loop


if "k7" in PARTS:
    import time
    import numpy as np
    from avsr_tpu_torch.configs import lrs2_av_fast
    from avsr_tpu_torch.data.units import builtin_unit_dict
    from avsr_tpu_torch.models import seq2seq
    from avsr_tpu_torch.serve import Predictor

    with torch.inference_mode():
        for B in (8, 128):
            call, loop = k7_loop(B)
            out[f"k7_dev_B{B}"] = cs.device_ms(call)
            out[f"k7_ms_B{B}"] = cs.time_ms(call)
            for t in range(10):
                loop(t)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for t in range(150):
                loop(t)
            torch.cuda.synchronize()
            out[f"k7_loop_host_us_B{B}"] = (time.perf_counter() - t0) / 150 * 1e6
            events, _ = cs.device_events(lambda: [loop(t) for t in range(150)])
            out[f"k7_loop_events_B{B}"] = len(events) / 150
    cfg = lrs2_av_fast()
    units = builtin_unit_dict(cfg.data.unit)
    params = seq2seq.model_init(cfg, units.vocab_size, torch.Generator().manual_seed(0), dev)
    pred = Predictor(params, cfg, units, device=dev, batch_size=8, audio_seconds=6.0,
                     transfer="compact")
    audio, video = cs.request(np.random.default_rng(0), 8)
    arrays, _ = pred.assemble(audio, video)
    enc = pred.encode(arrays)
    res = pred.beam(enc)
    times = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = pred.beam(enc)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    events, span = cs.device_events(lambda: pred.beam(enc))
    busy, share = cs.busy_share(events, span)
    out["beam_ms"] = sorted(times)[2]
    out["beam_steps"] = res.steps
    out["beam_events_per_step"] = len(events) / res.steps
    out["beam_busy_share"] = share
print(json.dumps(out))
"""


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trees", nargs="+", required=True, help="checkouts A, B, ...")
    ap.add_argument("--order", default="ABBA")
    ap.add_argument("--parts", nargs="+", default=["k5", "k6"], choices=["k5", "k6", "k7"])
    args = ap.parse_args()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card)
    runs = []
    for which in args.order:
        tree = args.trees[ord(which) - ord("A")]
        res = subprocess.run([sys.executable, "-c", f"PARTS = {args.parts!r}\n" + RUN], cwd=tree,
                             capture_output=True, text=True, env=dict(os.environ))
        if res.returncode != 0:
            print(res.stderr[-4000:], file=sys.stderr)
            return 1
        r = json.loads(res.stdout.strip().splitlines()[-1])
        print(f"{which} ({tree}): device ms " + ", ".join(f"{k} {x:.4f}" for k, x in r.items()),
              flush=True)
        runs.append(dict(r, tree=tree, which=which))
    print(json.dumps({"card": card, "runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

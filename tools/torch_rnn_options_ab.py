#!/usr/bin/env python3
"""Time K12 and K13, the GRU and LN-LSTM scans, in several checkouts on one card.

    python3 tools/torch_rnn_options_ab.py --trees build/parent . --order ABBA --parts kernels serve

Each run is a process of its own started in one checkout (``--trees``, A
first, then B, C, ...): it builds that checkout's kernels and, for
``--parts kernels``, times the device work (chip_smoke's ``device_ms``: CUDA
events around calls queued behind a spin kernel) of its
``kernels.gru_scan_fwd`` / ``gru_scan_bwd`` (K12) and
``kernels.ln_lstm_scan_fwd`` / ``ln_lstm_scan_bwd`` (K13, unmasked and under
a recurrent-dropout mask) wrappers: the forward serving and in save mode, the
backward alone and with the caller's dWh product (``ops.rnn.gru_core_bwd`` /
``ln_core_bwd``), on chip_smoke's ``k12_inputs`` / ``k13_inputs`` (bf16,
ragged, a 0-length row) at the train paths' shapes [T, G=2, B=128, H=256],
T = 197 (the audio layers) and 150 (the video layer), and counts the device
events of one call of each.  For ``--parts serve`` it serves chip_smoke's
``lrs2_av_align_ln`` (``ln_cfg``) and ``lrs2_av_align_gru_highway``
(``gru_highway_cfg``) models (random weights from seed 0, B = 8 requests of
6 s, beam 10) through a CUDA ``Predictor``, one warm-up request and then
``--requests`` timed ones on the host clock to a synchronise, and times one
encode of a request's batch alone.  The runs go in ``--order`` (A B B A by
default), so the checkouts share the card's state; the last line is one
JSON object with every run's numbers.  Needs a CUDA card; another checkout
is typically the parent commit unpacked with ``git archive`` into a
git-ignored directory.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

RUN = r"""
import json, statistics, sys, time
sys.path.insert(0, ".")
import numpy as np
import torch
import chip_smoke as cs
from avsr_tpu_torch import kernels
from avsr_tpu_torch.ops import rnn

kernels.build()
dev = torch.device("cuda", 0)
bf = torch.bfloat16
B, H = 128, 256
out = {}
if "kernels" in PARTS:
    for T in (197, 150):
        a = cs.k12_inputs(T, 2, B, H, dev, seed=T)
        wh, b, xw, mask, h0 = a
        whb = wh.to(bf)
        _, h_res = rnn.gru_core_fwd(*a, bf, True)
        g = torch.Generator().manual_seed(T + 1)
        dys = torch.randn((T, 2, B, H), generator=g).to(bf).to(dev)
        dhT = torch.randn((2, B, H), generator=g).to(dev)
        fwd = lambda: kernels.gru_scan_fwd(whb, b, xw, mask, h0)
        bwd = lambda: kernels.gru_scan_bwd(whb, b, xw, mask, h_res, dys, dhT)
        k = f"k12_T{T}"
        out[f"{k}_fwd"] = cs.device_ms(fwd)
        out[f"{k}_fwd_save"] = cs.device_ms(lambda: kernels.gru_scan_fwd(whb, b, xw, mask, h0,
                                                                         save=True))
        out[f"{k}_bwd"] = cs.device_ms(bwd)
        out[f"{k}_bwd_with_dwh"] = cs.device_ms(
            lambda: rnn.gru_core_bwd(wh, b, xw, mask, h_res, dys, dhT, bf))
        out[f"{k}_fwd_events"] = len(cs.device_events(fwd)[0])
        out[f"{k}_bwd_events"] = len(cs.device_events(bwd)[0])
        for masked in (False, True):
            a = cs.k13_inputs(T, 2, B, H, dev, seed=T)
            wh, b, lng, lncg, lncb, xw, mask, h0, c0 = a
            rd = cs.rd_mask(2, B, H, dev, T) if masked else None
            p = (wh.to(bf), b, lng, lncg, lncb)
            _, (h_res, c_res, z) = rnn.ln_core_fwd(*a, bf, True, rd)
            g = torch.Generator().manual_seed(T + 2)
            dys = torch.randn((T, 2, B, H), generator=g).to(bf).to(dev)
            dhT = torch.randn((2, B, H), generator=g).to(dev)
            dcT = torch.randn((2, B, H), generator=g).to(dev)
            fwd = lambda: kernels.ln_lstm_scan_fwd(*p, xw, mask, h0, c0, rd=rd)
            bwd = lambda: kernels.ln_lstm_scan_bwd(*p, mask, c_res, z, dys, dhT, dcT, rd=rd)
            k = f"k13{'_rd' if masked else ''}_T{T}"
            out[f"{k}_fwd"] = cs.device_ms(fwd, reps=5, warmup=1)
            out[f"{k}_fwd_save"] = cs.device_ms(
                lambda: kernels.ln_lstm_scan_fwd(*p, xw, mask, h0, c0, save=True, rd=rd),
                reps=5, warmup=1)
            out[f"{k}_bwd"] = cs.device_ms(bwd, reps=5, warmup=1)
            out[f"{k}_bwd_with_dwh"] = cs.device_ms(
                lambda: rnn.ln_core_bwd(wh, b, lng, lncg, lncb, mask, h_res, c_res, z, dys, dhT,
                                        dcT, bf, rd), reps=5, warmup=1)
            out[f"{k}_fwd_events"] = len(cs.device_events(fwd)[0])
            out[f"{k}_bwd_events"] = len(cs.device_events(bwd)[0])
if "serve" in PARTS:
    from avsr_tpu_torch.data.units import builtin_unit_dict
    from avsr_tpu_torch.models import seq2seq
    from avsr_tpu_torch.serve import Predictor
    for name, make in (("serve_ln", cs.ln_cfg), ("serve_gru_highway", cs.gru_highway_cfg)):
        cfg = make()
        units = builtin_unit_dict(cfg.data.unit)
        params = seq2seq.model_init(cfg, units.vocab_size, torch.Generator().manual_seed(0), dev)
        pred = Predictor(params, cfg, units, device=dev, batch_size=8, audio_seconds=6.0,
                         transfer="compact")
        rng = np.random.default_rng(0)
        make_request = cs.regime_request(cfg)
        requests = [make_request(rng, 8) for _ in range(REQUESTS + 1)]
        with torch.inference_mode():
            pred.transcribe(audio=requests[0][0], video=requests[0][1])
            torch.cuda.synchronize()
            lat = []
            for audio, video in requests[1:]:
                t0 = time.perf_counter()
                pred.transcribe(audio=audio, video=video)
                torch.cuda.synchronize()
                lat.append((time.perf_counter() - t0) * 1e3)
            arrays, _ = pred.assemble(*requests[1])
            enc = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                pred.encode(arrays)
                torch.cuda.synchronize()
                enc.append((time.perf_counter() - t0) * 1e3)
        out[f"{name}_request_ms"] = statistics.median(lat)
        out[f"{name}_request_ms_all"] = lat
        out[f"{name}_encode_ms"] = statistics.median(enc)
print(json.dumps(out))
"""


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trees", nargs="+", required=True, help="checkouts A, B, ...")
    ap.add_argument("--order", default="ABBA")
    ap.add_argument("--parts", nargs="+", choices=("kernels", "serve"),
                    default=["kernels", "serve"])
    ap.add_argument("--requests", type=int, default=5)
    args = ap.parse_args()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card)
    run = RUN.replace("PARTS", repr(tuple(args.parts))).replace("REQUESTS", str(args.requests))
    runs = []
    for which in args.order:
        tree = args.trees[ord(which) - ord("A")]
        res = subprocess.run([sys.executable, "-c", run], cwd=tree, capture_output=True,
                             text=True, env=dict(os.environ))
        if res.returncode != 0:
            print(res.stderr[-4000:], file=sys.stderr)
            return 1
        r = json.loads(res.stdout.strip().splitlines()[-1])
        print(f"{which} ({tree}): " + ", ".join(f"{k} {x:.4f}" if isinstance(x, float) else
                                                f"{k} {x}" for k, x in r.items()), flush=True)
        runs.append(dict(r, tree=tree, which=which))
    print(json.dumps({"card": card, "parts": args.parts, "runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

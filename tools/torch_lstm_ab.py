#!/usr/bin/env python3
"""Time K1 and K2, the LSTM scan's forward and backward, in several checkouts on one card.

    python3 tools/torch_lstm_ab.py --trees build/parent . --order ABBA

Each run is a process of its own started in one checkout (``--trees``, A
first, then B, C, ...): it builds that checkout's kernels and times the
device work (chip_smoke's ``device_ms``: CUDA events around 20 calls queued
behind a spin kernel) of its ``kernels.lstm_scan_fwd`` (serving, and in save
mode as a train step runs it) and ``kernels.lstm_scan_bwd`` wrappers, and of
``ops.rnn.scan_core_bwd`` (the backward with the caller's dWh product), on
chip_smoke's ``k1_inputs`` / ``k2_inputs`` (bf16, ragged, a 0-length row) at
the train paths' shapes: K1 [T, G=2, B=128, H=256] at T = 99, 50 (the fast
audio encoder), 150 (the video encoder) and 197 (lrs2_av_align's audio
layers), and K2 [T, G=1, B=128, H=256] at T = 197 and 150
(lrs2_av_align_uni_luong's encoders).  It also counts the device events of
one forward and one backward call under the profiler.  The runs go in
``--order`` (A B B A by default), so the checkouts share the card's state;
the last line is one JSON object with every run's numbers.  Needs a CUDA
card; another checkout is typically the parent commit unpacked with ``git
archive`` into a git-ignored directory.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

RUN = r"""
import json, sys
sys.path.insert(0, ".")
import torch
import chip_smoke as cs
from avsr_tpu_torch import kernels
from avsr_tpu_torch.ops import rnn

kernels.build()
dev = torch.device("cuda", 0)
bf = torch.bfloat16
out = {}
for name, T, G in (("k1_T99", 99, 2), ("k1_T50", 50, 2), ("k1_T150", 150, 2), ("k1_T197", 197, 2),
                   ("k2_T197", 197, 1), ("k2_T150", 150, 1)):
    args = (cs.k1_inputs(T, 2, 128, 256, dev, seed=T) if G == 2
            else cs.k2_inputs(T, 128, 256, dev, T))
    wh, b, xw, mask, h0, c0 = args
    whb = wh.to(bf)
    _, (h_res, c_res) = rnn.scan_core_fwd(*args, bf, save=True)
    g = torch.Generator().manual_seed(T + G)
    dys = torch.randn((T, G, 128, 256), generator=g).to(bf).to(dev)
    dhT = torch.randn((G, 128, 256), generator=g).to(dev)
    dcT = torch.randn((G, 128, 256), generator=g).to(dev)
    fwd = lambda: kernels.lstm_scan_fwd(whb, b, xw, mask, h0, c0)
    bwd = lambda: kernels.lstm_scan_bwd(whb, b, xw, mask, h_res, c_res, dys, dhT, dcT)
    out[f"{name}_fwd"] = cs.device_ms(fwd)
    out[f"{name}_fwd_save"] = cs.device_ms(lambda: kernels.lstm_scan_fwd(whb, b, xw, mask, h0, c0,
                                                                         save=True))
    out[f"{name}_bwd"] = cs.device_ms(bwd)
    out[f"{name}_bwd_with_dwh"] = cs.device_ms(
        lambda: rnn.scan_core_bwd(wh, b, xw, mask, h_res, c_res, dys, dhT, dcT, bf))
    out[f"{name}_fwd_events"] = len(cs.device_events(fwd)[0])
    out[f"{name}_bwd_events"] = len(cs.device_events(bwd)[0])
print(json.dumps(out))
"""


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trees", nargs="+", required=True, help="checkouts A, B, ...")
    ap.add_argument("--order", default="ABBA")
    args = ap.parse_args()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card)
    runs = []
    for which in args.order:
        tree = args.trees[ord(which) - ord("A")]
        res = subprocess.run([sys.executable, "-c", RUN], cwd=tree, capture_output=True, text=True,
                             env=dict(os.environ))
        if res.returncode != 0:
            print(res.stderr[-4000:], file=sys.stderr)
            return 1
        r = json.loads(res.stdout.strip().splitlines()[-1])
        print(f"{which} ({tree}): " + ", ".join(f"{k} {x:.4f}" if isinstance(x, float) else
                                                f"{k} {x}" for k, x in r.items()), flush=True)
        runs.append(dict(r, tree=tree, which=which))
    print(json.dumps({"card": card, "runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Time K3, the log-mel frontend after the DFT, and the whole frontend in several checkouts on one card.

    python3 tools/torch_frontend_ab.py --trees build/parent . --order ABBA

Each run is a process of its own started in one checkout (``--trees``, A
first, then B, C, ...): it builds that checkout's kernels and, on
chip_smoke's ``k3_inputs`` (lrs2_av_fast's frontend: 30 mel bins, Δ and
ΔΔ, stack 8 / skip 3; ragged lengths with a row of no full frame and one
shorter than a stack) at B = 128 and B = 8, 6 s and 16 s (S = 96,000 and
256,000 samples), times ``ops.audio_features.logmel_post_dft``: its device
ms (chip_smoke's ``device_ms``: CUDA events around 20 calls queued behind
a spin kernel) and its CUDA-event ms a call (host work included).  Where
the checkout's chip_smoke has ``k3_stage_ms``, also the device ms of each
of K3's launches apart.  Then the whole frontend (``logmel_frontend``: the
framing, the two DFT products in bf16 and K3) of a B = 8, 6 s request: its
CUDA-event ms and its device events a call under the profiler.

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
import json, sys
sys.path.insert(0, ".")
import torch
import chip_smoke as cs
from avsr_tpu_torch import kernels
from avsr_tpu_torch.configs import lrs2_av_fast
from avsr_tpu_torch.ops import audio_features as af

kernels.build()
dev = torch.device("cuda", 0)
cfg = lrs2_av_fast().audio
out = {}
for B, S in ((128, 96000), (8, 96000), (128, 256000), (8, 256000)):
    args = cs.k3_inputs(cfg, B, S, dev, seed=B + S)
    tag = f"B{B}_S{S}"
    out[f"k3_dev_{tag}"] = cs.device_ms(lambda: af.logmel_post_dft(*args, cfg))
    out[f"k3_ms_{tag}"] = cs.time_ms(lambda: af.logmel_post_dft(*args, cfg))
    if hasattr(cs, "k3_stage_ms"):
        for name, ms in cs.k3_stage_ms(args, cfg).items():
            out[f"k3_{name}_dev_{tag}"] = ms
    del args
g = torch.Generator().manual_seed(0)
wav = (0.3 * torch.randn((8, 96000), generator=g)).to(dev)
lengths = torch.randint(32000, 96001, (8,), generator=g, dtype=torch.int32).to(dev)
run = lambda: af.logmel_frontend(wav, lengths, cfg, cdt=torch.bfloat16)
out["frontend_ms_B8"] = cs.time_ms(run)
events, _ = cs.device_events(run)
out["frontend_events_B8"] = len(events)
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
        res = subprocess.run([sys.executable, "-c", RUN], cwd=tree, capture_output=True,
                             text=True, env=dict(os.environ))
        if res.returncode != 0:
            print(res.stderr[-4000:], file=sys.stderr)
            return 1
        r = json.loads(res.stdout.strip().splitlines()[-1])
        print(f"{which} ({tree}): " + ", ".join(f"{k} {x:.4f}" for k, x in r.items()),
              flush=True)
        runs.append(dict(r, tree=tree, which=which))
    print(json.dumps({"card": card, "runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Time K4, K11 and K9 in two checkouts on one card.

    python3 tools/torch_fusion_ab.py --trees build/parent . --order ABBA [--parts k4 k11 k9]

Each run is a process of its own started in one checkout (``--trees``, A
first): it builds that checkout's kernels and times the device work of its
wrappers (chip_smoke's ``device_ms``: CUDA events around 20 calls queued
behind a spin kernel).  K4 (``--parts k4``), the cross-attention fusion
core, at the fast model's shape [B=128, 4 heads, T_a=50, T_v=150, 128] and
at ``lrs2_av_v2``'s T_a=197, on chip_smoke's ``k4_inputs`` (ragged video
lengths with a 0-length row): the forward as serving calls it, and the
backward from the forward's residual, whichever the checkout's backward
takes (the fp32 weights, or the softmax's row statistics).  K11 (``k11``),
the encoder's self attention, which shares K4's tensor-core header
(``csrc/attention_mma.cuh``): forward in save mode and backward at
lrs2_av_v2's [B=128, 8 heads, T=197, 64] on chip_smoke's ``k11_inputs``.
K9 (``k9``), the conformer conv module, forward and backward at
lrs2_av_v2's [T=197, B=128, d=512, k=15] on chip_smoke's ``k9_inputs``
(ragged lengths, a 0-length row), the forward also at a request's B = 8
and at the 16 s limit (B = 4, T = 531), and the library yardstick of the
backward, cuDNN's depthwise conv1d backward alone (autograd's device time
less the forward's, as chip_smoke phase 26 takes it).  The runs go in
``--order`` (A B B A by default), so both checkouts share the card's
state; the last line is one JSON object with every run's numbers.  Needs
a CUDA card; the other checkout is typically the parent commit unpacked
with ``git archive`` into a git-ignored directory.
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
from avsr_tpu_torch.models import fusion as fus
from avsr_tpu_torch.models import transformer as tfm

kernels.build()
dev = torch.device("cuda", 0)
out = {}
for Ta in (50, 197) if "k4" in PARTS else ():
    q, k, v, vlen, dctx = cs.k4_inputs(128, 4, Ta, 150, 128, dev)
    if "row_max" in inspect.signature(fus.fusion_attention_bwd).parameters:
        _, _, stats = fus.fusion_attention_fwd(q, k, v, vlen, save=True)
        residual = (vlen, *stats)
    else:
        residual = (fus.fusion_attention_fwd(q, k, v, vlen)[1],)
    out[f"fwd_T_a{Ta}"] = cs.device_ms(lambda: fus.fusion_attention_fwd(q, k, v, vlen))
    out[f"bwd_T_a{Ta}"] = cs.device_ms(lambda: fus.fusion_attention_bwd(q, k, v, *residual, dctx))
if "k11" in PARTS:
    qkv, lens = cs.k11_inputs(128, 197, dev, seed=197)
    dctx = torch.randn((128, 197, 8, 64), generator=torch.Generator().manual_seed(198))
    dctx = dctx.to(torch.bfloat16).to(dev)
    _, st = tfm.encoder_self_attention_fwd(qkv, lens, save=True)
    out["k11_fwd"] = cs.device_ms(lambda: tfm.encoder_self_attention_fwd(qkv, lens, save=True))
    out["k11_bwd"] = cs.device_ms(lambda: tfm.encoder_self_attention_bwd(qkv, lens, *st, dctx))
if "k9" in PARTS:
    import torch.nn.functional as F
    args = cs.k9_inputs(128, 197, dev, seed=203)
    dout = torch.randn((197, 128, 512), generator=torch.Generator().manual_seed(204))
    dout = dout.to(torch.bfloat16).to(dev)
    out["k9_fwd"] = cs.device_ms(lambda: tfm.conformer_conv_fwd(*args))
    for tag, B, T in (("B8", 8, 197), ("16s", 4, 531)):
        a = cs.k9_inputs(B, T, dev, seed=T + B)
        out[f"k9_fwd_{tag}"] = cs.device_ms(lambda: tfm.conformer_conv_fwd(*a))
    out["k9_bwd"] = cs.device_ms(lambda: tfm.conformer_conv_bwd(*args, dout))
    x = torch.randn((128, 512, 197), device=dev, requires_grad=True)
    w = args[2].float()[:, 0, :].t()[:, None, :].contiguous().requires_grad_(True)
    gz = torch.randn((128, 512, 197), device=dev)
    with torch.no_grad():
        t_fwd = cs.device_ms(lambda: F.conv1d(x, w, padding=7, groups=512))
    out["k9_bwd_cudnn_conv"] = cs.device_ms(
        lambda: torch.autograd.grad(F.conv1d(x, w, padding=7, groups=512), (x, w), gz)) - t_fwd
print(json.dumps(out))
"""


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trees", nargs=2, required=True, help="checkout A, checkout B")
    ap.add_argument("--order", default="ABBA")
    ap.add_argument("--parts", nargs="+", default=["k4", "k11", "k9"],
                    choices=["k4", "k11", "k9"])
    args = ap.parse_args()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card)
    runs = []
    for which in args.order:
        tree = args.trees["AB".index(which)]
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

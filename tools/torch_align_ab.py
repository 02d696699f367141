#!/usr/bin/env python3
"""Time K8, the AV-Align fusion scan, forward and backward, in several checkouts on one card.

    python3 tools/torch_align_ab.py --trees build/parent . --order ABBA [--parts fwd bwd]

Each run is a process of its own started in one checkout (``--trees``, A
first, then B, C, ...): it builds that checkout's kernels and, for both
read instances (Bahdanau: ``lrs2_av_align``'s fusion, H=256, A=128,
Dv=512; Luong: ``lrs2_av_align_uni_luong``'s, Hk=Dv=256), times:

- ``fwd``: the forward, ``models.fusion.av_align_scan_fwd`` on chip_smoke's
  ``k8_inputs`` / ``k8_luong_inputs`` (ragged masks with a 0-length audio
  row and a 0-length video row) at [T_a, B, T_v] = [197, 8, 150] (a serving
  request), [197, 128, 150] (the train batch) and [531, 32, 400] (the 16 s
  limits): the device ms of one call without and with save mode (the train
  launch), the device events of one call under the profiler and the
  microseconds a step;
- ``bwd``: the backward, ``models.fusion.av_align_scan_bwd`` on chip_smoke's
  ``k8_bwd_inputs`` (the kernel forward's alignments and saved carries,
  random cotangents) at the train shape [T_a=197, B=128, T_v=150] and at the
  16 s limits [T_a=531, B=32, T_v=400]: the device ms of one call, its
  device events under the profiler and the profiler's device time and
  launches by kernel name (the split of a call over its launch kinds).  In
  a checkout whose backward runs in stages (``chip_smoke.k8_bwd_split``) it
  also times the stages apart (the regate and the queries, the recurrence,
  the memory's gradients) at [197, B, 150] for B = 16 (one 16-row tile), 112
  and 128, with the recurrence at 1 and at 2 batch rows per CTA, and the
  recurrence's microseconds a step in one cluster (B = 16) at T_v = 16, 50,
  150 and 400 and with every step masked (no read).

Device ms are chip_smoke's ``device_ms``: CUDA events around 5 calls queued
behind a spin kernel.  The runs go in ``--order`` (A B B A by default), so
the checkouts share the card's state; the last line is one JSON object with
every run's numbers.  Needs a CUDA card; another checkout is typically the
parent commit unpacked with ``git archive`` into a git-ignored directory.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

RUN = r"""
import collections, json, sys
sys.path.insert(0, ".")
import torch
import chip_smoke as cs
from avsr_tpu_torch import kernels
from avsr_tpu_torch.models import fusion as fus

kernels.build()
dev = torch.device("cuda", 0)
out = {}
for kind, seed, make in (("bahdanau", 13, cs.k8_inputs), ("luong", 53, cs.k8_luong_inputs)):
    if "fwd" not in PARTS:
        break
    for T, B, Tv in ((197, 8, 150), (197, 128, 150), (531, 32, 400)):
        args = make(B, dev, seed + B + T, T=T, Tv=Tv)
        name = f"fwd_{kind}_T{T}_B{B}"
        for save in (False, True):
            fn = lambda: fus.av_align_scan_fwd(*args, save=save, attention_type=kind)
            out[name + ("_save" if save else "") + "_device_ms"] = cs.device_ms(fn, reps=5,
                                                                               warmup=1)
        fn = lambda: fus.av_align_scan_fwd(*args, attention_type=kind)
        ev, _ = cs.device_events(fn)
        out[f"{name}_events"] = len(ev)
        out[f"{name}_us_per_step"] = out[f"{name}_device_ms"] * 1e3 / T
        del args
        torch.cuda.empty_cache()
for name, kind, seed, B, widths in (("bahdanau_T197", "bahdanau", 29, 128, {}),
                                    ("luong_T197", "luong", 61, 128, {}),
                                    ("bahdanau_T531", "bahdanau", 31, 32, dict(T=531, Tv=400)),
                                    ("luong_T531", "luong", 63, 32, dict(T=531, Tv=400))):
    if "bwd" not in PARTS:
        break
    args = cs.k8_bwd_inputs(B, dev, seed, attention_type=kind, **widths)
    fn = lambda: fus.av_align_scan_bwd(*args, attention_type=kind)
    out[f"{name}_device_ms"] = cs.device_ms(fn, reps=5, warmup=1)
    ev, _ = cs.device_events(fn)
    out[f"{name}_events"] = len(ev)
    by = collections.defaultdict(lambda: [0, 0.0])
    for s, e, n in ev:
        by[n[:48]][0] += 1
        by[n[:48]][1] += (e - s) / 1e3
    out[f"{name}_by_kernel_ms"] = {n: [c, round(ms, 4)] for n, (c, ms) in
                                   sorted(by.items(), key=lambda kv: -kv[1][1])}
    del args
    torch.cuda.empty_cache()
if "bwd" in PARTS and hasattr(cs, "k8_bwd_split"):  # a checkout whose backward runs in stages
    for kind, seed in (("bahdanau", 29), ("luong", 61)):
        for B in (16, 112, 128):
            args = cs.k8_bwd_inputs(B, dev, seed, attention_type=kind)
            for rpc in (1, 2):
                out[f"{kind}_B{B}_rows_per_cta{rpc}_stages_device_ms"] = cs.k8_bwd_split(
                    args, kind, rows_per_cta=rpc)
            del args
            torch.cuda.empty_cache()
        # the recurrence's us a step in one cluster (B=16, one row a CTA) as
        # the memory grows, and with every step masked (no read at all)
        for Tv in (16, 50, 150, 400, 0):
            args = cs.k8_bwd_inputs(16, dev, seed, attention_type=kind, Tv=Tv or 150)
            if not Tv:
                args[4] = torch.zeros_like(args[4])
            scan = cs.k8_bwd_split(args, kind, rows_per_cta=1)["scan"]
            out[f"{kind}_B16_Tv{Tv or 'masked'}_scan_us_per_step"] = scan * 1e3 / 197
print(json.dumps(out))
"""


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trees", nargs="+", required=True, help="checkouts A, B, ...")
    ap.add_argument("--order", default="ABBA")
    ap.add_argument("--parts", nargs="+", choices=("fwd", "bwd"), default=["fwd", "bwd"])
    args = ap.parse_args()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card)
    runs = []
    for which in args.order:
        tree = args.trees[ord(which) - ord("A")]
        run = RUN.replace("PARTS", repr(tuple(args.parts)))
        res = subprocess.run([sys.executable, "-c", run], cwd=tree, capture_output=True, text=True,
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

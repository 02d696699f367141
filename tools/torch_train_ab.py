#!/usr/bin/env python3
"""Alternate the PyTorch port's full-width train step between checkouts on one card.

    python3 tools/torch_train_ab.py --trees build/parent . --preset v2 --order ABBA --steps 12

Each run is a process of its own started in one checkout (``--trees``, A
first): it builds that checkout's kernels, makes the train cell of its
``chip_smoke.py`` for ``--preset`` (``fast``: ``lrs2_av_fast`` at constant
lr 1e-4; ``v2``: ``lrs2_av_v2`` at constant lr 3e-5; ``align``:
``lrs2_av_align`` (``configs.lrs2_full``) at 1e-4; ``uni_luong``: chip_smoke's
``uni_luong_cfg`` (``lrs2_av_align_uni_luong``) at 1e-4; ``ln``: its
``ln_cfg`` (``lrs2_av_align_ln``, LN-LSTM encoders on K13) and
``gru_highway``: its ``gru_highway_cfg`` (``lrs2_av_align_gru_highway``, GRU
encoders on K12), both at 1e-4; all B=128, 6 s,
label cap 80, noise mixing on), times ``--steps`` train steps on the host
clock to a synchronise, reads the peak device memory, and profiles three
more steps: the device's busy time and event count per step and the device
time per step of the kernels by name: the LSTM scan (``lstm``: K1, K2 and
K13, every kernel whose name holds ``lstm``, with its event count), the GRU
scan (``gru``: K12, every kernel whose name holds ``gru_``), the RNN
decoder's read (``k10``: every kernel whose name holds ``attend``, with its
event count), the memory gradients' sums after a scan or a teacher-forced
loop (``sums``: ``align_outer_sum`` and ``align_dkeys_energy``, K8's and
K10's), the AV-Align fusion scan's forward (``k8_fwd``: the cluster kernel
``align_fwd_scan``, or the per-step route's ``align_gate_kernel`` and
``align_read_kernel``, with its event count) and its backward (``k8``: every
other kernel whose name holds ``align_``, with its event count), the
conformer conv module's kernels (``k9``: K9's forward, its backward's pass
and partial sums), torch's
fills, copies and casts, and adds (``fill``, ``copy``, ``add``: every
kernel whose name holds the word; autograd's sums of a
gradient are adds) and the attention kernels, told apart by
their mask and family (``k11``: the
whole-row kernels under the length mask, the encoder self attention;
``k4``: the streamed ones under the length mask, the fusion core; ``k5``:
every other attention kernel, the decoder's teacher-forced attention under
its causal and bias masks, on either family).  The runs go in ``--order``
(A B B A by default), so both checkouts share the card's state; the last
line is one JSON object with every run's numbers.  Needs a CUDA card; the
other checkout is typically the parent commit unpacked with ``git archive``
into a git-ignored directory.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

RUN = r"""
import collections, json, statistics, sys, time
sys.path.insert(0, ".")
import torch
import chip_smoke as cs
from avsr_tpu_torch import configs, kernels
from avsr_tpu_torch.configs import NoiseConfig
from avsr_tpu_torch.data.units import builtin_unit_dict
from avsr_tpu_torch.train import step as tstep
import dataclasses

kernels.build()
dev = torch.device("cuda", 0)
cfg = PRESET().replace(noise=NoiseConfig(enabled=True))
cfg = cfg.replace(train=dataclasses.replace(cfg.train, lr_schedule="constant", learning_rate=LR))
V = builtin_unit_dict(cfg.data.unit).vocab_size
batch, frames = cs.train_batch(cfg, V, dev)
bank = cs.noise_bank(cfg, dev)
state, opt = tstep.create_train_state(cfg, V, torch.Generator().manual_seed(0), dev)
gen = torch.Generator().manual_seed(11)
torch.cuda.synchronize()
torch.cuda.reset_peak_memory_stats()
times = []
for _ in range(STEPS):
    t0 = time.perf_counter()
    state, _ = tstep.train_step(state, batch, cfg=cfg, optimizer=opt, generator=gen,
                                noise_bank=bank)
    torch.cuda.synchronize()
    times.append((time.perf_counter() - t0) * 1e3)
peak = torch.cuda.max_memory_allocated()

def three():
    st = state
    for _ in range(3):
        st, _ = tstep.train_step(st, batch, cfg=cfg, optimizer=opt, generator=gen,
                                 noise_bank=bank)

ev, span = cs.device_events(three)
busy, share = cs.busy_share(ev, span)
def kind(name):
    if "lstm" in name:
        return "lstm"
    if "gru_" in name:
        return "gru"
    if "attend" in name:
        return "k10"
    if "align_outer_sum" in name or "align_dkeys_energy" in name:
        return "sums"
    if any(k in name for k in ("align_fwd_scan", "align_gate_kernel", "align_read_kernel")):
        return "k8_fwd"
    if "align_" in name:
        return "k8"
    if any(k in name for k in ("conformer_conv", "conv_bwd", "reduce_parts")):
        return "k9"
    low = name.lower()
    if "fill" in low:
        return "fill"
    if "copy" in low:
        return "copy"
    if "add" in low:
        return "add"
    if "attn_" not in name:
        return "other"
    if "LengthMask" in name:
        return "k4" if "attn_mma_stream_" in name else "k11"
    return "k5"

by = collections.defaultdict(float)
count = collections.Counter()
for s, e, name in ev:
    by[kind(name)] += e - s
    count[kind(name)] += 1
print(json.dumps({"step_ms": times, "peak_gib": peak / 2**30, "busy_ms_per_step": busy / 3e3,
                  "busy_share": share, "events_per_step": len(ev) / 3,
                  "lstm_events_per_step": count["lstm"] / 3,
                  "gru_events_per_step": count["gru"] / 3,
                  "k8_fwd_events_per_step": count["k8_fwd"] / 3,
                  "k8_events_per_step": count["k8"] / 3, "k10_events_per_step": count["k10"] / 3,
                  **{f"{k}_ms_per_step": by[k] / 3e3
                     for k in ("lstm", "gru", "k8_fwd", "k8", "k10", "sums", "k11", "k4", "k5", "k9",
                               "fill", "copy", "add")}}))
"""


# --preset: the config function and the constant learning rate of its train cell
PRESETS = {"fast": ("configs.lrs2_av_fast", "1e-4"), "v2": ("configs.lrs2_av_v2", "3e-5"),
           "align": ("configs.lrs2_full", "1e-4"), "uni_luong": ("cs.uni_luong_cfg", "1e-4"),
           "ln": ("cs.ln_cfg", "1e-4"), "gru_highway": ("cs.gru_highway_cfg", "1e-4")}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trees", nargs=2, required=True, help="checkout A, checkout B")
    ap.add_argument("--order", default="ABBA")
    ap.add_argument("--steps", type=int, default=12)
    ap.add_argument("--preset", choices=sorted(PRESETS), default="v2")
    args = ap.parse_args()
    preset, lr = PRESETS[args.preset]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card)
    runs = []
    for which in args.order:
        tree = args.trees["AB".index(which)]
        run = RUN.replace("STEPS", str(args.steps)).replace("PRESET", preset).replace("LR", lr)
        res = subprocess.run([sys.executable, "-c", run],
                             cwd=tree, capture_output=True, text=True, env=dict(os.environ))
        if res.returncode != 0:
            print(res.stderr[-4000:], file=sys.stderr)
            return 1
        r = json.loads(res.stdout.strip().splitlines()[-1])
        after = r["step_ms"][2:]  # two warm-up steps
        r.update(tree=tree, which=which, median_ms=statistics.median(after),
                 quartiles_ms=statistics.quantiles(after, n=4))
        print(f"{which} ({tree}): median {r['median_ms']:.3f} ms per step (quartiles "
              f"{r['quartiles_ms'][0]:.3f}-{r['quartiles_ms'][2]:.3f}), peak "
              f"{r['peak_gib']:.3f} GiB, device busy {r['busy_ms_per_step']:.3f} ms per step "
              f"(share {r['busy_share']:.3f}, {r['events_per_step']:.1f} events), per step: "
              f"LSTM scan {r['lstm_ms_per_step']:.3f} ms ({r['lstm_events_per_step']:.1f} "
              f"events), K8 fwd {r['k8_fwd_ms_per_step']:.3f} ms "
              f"({r['k8_fwd_events_per_step']:.1f} events), K8 bwd {r['k8_ms_per_step']:.3f} ms "
              f"({r['k8_events_per_step']:.1f} events), "
              f"K10 {r['k10_ms_per_step']:.3f} ms ({r['k10_events_per_step']:.1f} events), "
              f"the memory sums {r['sums_ms_per_step']:.3f} ms, K11 {r['k11_ms_per_step']:.3f} "
              f"ms, K4 {r['k4_ms_per_step']:.3f} ms, K5 {r['k5_ms_per_step']:.3f} ms, K9 "
              f"{r['k9_ms_per_step']:.3f} ms; fills "
              f"{r['fill_ms_per_step']:.3f}, copies and casts {r['copy_ms_per_step']:.3f}, adds "
              f"{r['add_ms_per_step']:.3f} ms", flush=True)
        runs.append(r)
    print(json.dumps({"card": card, "preset": args.preset, "runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

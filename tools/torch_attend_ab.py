#!/usr/bin/env python3
"""Time K10, the RNN decoder's attention read, forward and over a teacher-forced loop's backward, in several checkouts on one card.

    python3 tools/torch_attend_ab.py --trees build/parent . --order ABBA [--parts fwd bwd]

Each run is a process of its own started in one checkout (``--trees``, A
first, then B, C, ...): it builds that checkout's kernels and, for both
reads (Bahdanau: ``lrs2_av_align``'s decoder, Hq=256, A=128, the fused
memory Dv=768; Luong: ``lrs2_av_align_uni_luong``'s, Hk=Dv=512, the memory
its own keys), times:

``--parts fwd``, the forward read as the decode steps issue it
(``ops.attention.attend`` under ``torch.inference_mode``): a serve
request's beam step, N = 80 query rows (8 utterances, 10 beams) over S =
197 and over the 16 s memory (S = 531), and a greedy step, N = 128 rows of
one beam, over S = 197 and 531, each memory ragged with a 0-length row;
device ms (chip_smoke's ``device_ms``: CUDA events around 20 calls queued
behind a spin kernel); and the teacher-forced loop's forward, K = 80 reads
of one memory at N = 128, S = 197 (through the checkout's read loop where
it has one).  Where the checkout's chip_smoke has ``k10_launch``, each shape
also on every kernel it names (``K10_ROUTES``: the grouped read, the row
read and the general kernel; in a checkout before the row read, "row" is
the block per query row of the general kernel), whatever the route.  A checkout whose K10 reads the
untiled memory (``kernels.attend_route``) gets the beam step's 8 memory
rows; an older one the memory tiled over the beams, as its beam search
gave it (the tiling is set-up, outside the timed calls).

``--parts bwd``, the backward of a teacher-forced loop: a memory as the
train step has it (fp32, requiring a gradient, B=128, S=197, ragged with a
0-length row), K=80 queries and context cotangents from a seed, the K reads
forward under autograd (inside the checkout's read loop where it has one,
``ops.attention.open_read_loop``) and the backward of the whole loop
(``torch.autograd.grad`` over the memory, wq, v and the queries): its
device time (CUDA events around 3 backwards queued behind a spin kernel),
its device events under the profiler, split by kernel kind (K10's
kernels, the memory sums of ``av_align_bwd.cuh``, fills, adds, copies and
casts, matrix products, the rest) and the peak device memory of a forward
and backward.  It also splits one call apart: in a checkout with the
per-call backward (``kernels.bahdanau_attend_bwd``) the three
``torch.zeros`` of its outputs, the kernel alone, the weight gradients with
their rounding, and the casts of the operands; in one with the loop route,
the per-step kernel alone and the sums of a loop.

The runs go in ``--order`` (A B B A by default); the last line is one JSON
object with every run's numbers.  Needs a CUDA card; another checkout is
typically the parent commit unpacked with ``git archive`` into a
git-ignored directory.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

RUN = r"""
import collections, contextlib, json, sys
sys.path.insert(0, ".")
import torch
import chip_smoke as cs
from avsr_tpu_torch import kernels
from avsr_tpu_torch.ops import attention as attn
from avsr_tpu_torch.utils.numerics import rounded

kernels.build()
dev = torch.device("cuda", 0)
bf = torch.bfloat16
N, S, K, Hq = 128, 197, 80, 256
LOOP = hasattr(attn, "open_read_loop")


def kind(name):
    if "attend" in name:
        return "k10"
    if "align_outer_sum" in name or "align_dkeys_energy" in name:
        return "sums"
    if "fill" in name.lower():
        return "fill"
    if "copy" in name.lower() or "cast" in name.lower():
        return "copy"
    if "add" in name.lower() or "Sum" in name or "reduce" in name:
        return "add"
    if "gemm" in name or "gemv" in name or "xmma" in name or "cutlass" in name:
        return "matmul"
    return "other"


out = {"loop_route": LOOP, "untiled": hasattr(kernels, "attend_route")}


def fwd_memory(typ, A, Dv, B, W, S, seed):
    # params, queries [B W, Hq] and a prepared memory of B rows (tiled W times
    # for a checkout without the untiled read), bf16 values, row 1 empty
    g = torch.Generator().manual_seed(seed)
    params = {"wq": (torch.randn(Hq, A, generator=g) / Hq ** 0.5).to(dev)}
    if typ == "bahdanau":
        params["v"] = (torch.randn(A, generator=g) / A ** 0.5).to(dev)
        params["wm"] = (torch.randn(Dv, A, generator=g) / Dv ** 0.5).to(dev)
        memory = torch.randn(B, S, Dv, generator=g)
    else:
        memory = (0.5 * torch.randn(B, S, A, generator=g)).to(bf)
    lens = torch.randint(1, S + 1, (B,), generator=g)
    lens[0], lens[1] = S, 0
    query = (0.5 * torch.randn(B * W, Hq, generator=g)).to(dev)
    mem = attn.prepare_memory(typ, params, memory.to(dev), lens.to(dev), bf)
    mem = mem._replace(values=mem.values.to(bf), keys=mem.values.to(bf) if typ == "luong" else mem.keys)
    if W > 1 and not out["untiled"]:
        tile = lambda x: x.repeat_interleave(W, dim=0).contiguous()
        values = tile(mem.values)
        keys = values if typ == "luong" else tile(mem.keys)
        mem = attn.AttentionMemory(values=values, keys=keys, mask=tile(mem.mask), bias=tile(mem.bias))
    return params, query, mem


ROUTES = getattr(cs, "K10_ROUTES", ("grouped", "row"))
for typ, A, Dv in (("bahdanau", 128, 768), ("luong", 512, 512)) if "fwd" in PARTS else ():
    with torch.inference_mode():
        for what, B, W, S_ in (("beam", 8, 10, S), ("beam16", 8, 10, 531), ("greedy", 128, 1, S),
                               ("greedy16", 128, 1, 531)):
            params, query, mem = fwd_memory(typ, A, Dv, B, W, S_, seed=B + W + (S_ != S))
            out[f"{typ}_fwd_{what}_device_ms"] = cs.device_ms(
                lambda: attn.attend(typ, params, query, mem, bf))
            if hasattr(cs, "k10_launch"):
                ops = attn.kernel_operands(typ, params, mem, bf)
                out[f"{typ}_fwd_{what}_by_route"] = {r: cs.device_ms(
                    lambda: cs.k10_launch(r, query, *ops, mem.bias, mem.mask))
                    for r in ROUTES}
        # the teacher-forced loop's forward: K reads of one memory (B = 128,
        # S = 197), each step's query its own, as the train step issues them
        params, _, mem = fwd_memory(typ, A, Dv, N, 1, S, seed=7)
        queries = (0.5 * torch.randn(K, N, Hq, generator=torch.Generator().manual_seed(8))).to(dev)
        if LOOP:
            st = attn.LoopState(typ, mem, bf, K)
            st.bind(mem.keys, mem.values, params["wq"], params.get("v"))
            step = lambda k: attn.read_fwd(st, queries[k])  # noqa: E731
        else:
            step = lambda k: attn.attend(typ, params, queries[k], mem, bf)  # noqa: E731
        out[f"{typ}_fwd_loop{K}_device_ms"] = cs.device_ms(
            lambda: [step(k) for k in range(K)], reps=3, warmup=1)

for typ, A, Dv in (("bahdanau", 128, 768), ("luong", 512, 512)) if "bwd" in PARTS else ():
    g = torch.Generator().manual_seed(5)
    params = {"wq": (torch.randn(Hq, A, generator=g) / Hq ** 0.5).to(dev).requires_grad_()}
    if typ == "bahdanau":
        params["v"] = (torch.randn(A, generator=g) / A ** 0.5).to(dev).requires_grad_()
        params["wm"] = (torch.randn(Dv, A, generator=g) / Dv ** 0.5).to(dev)
    memory = torch.randn(N, S, Dv, generator=g).to(dev).requires_grad_()
    lens = torch.randint(1, S + 1, (N,), generator=g)
    lens[0], lens[1] = S, 0
    queries = (0.5 * torch.randn(K, N, Hq, generator=g)).to(dev).requires_grad_()
    dctxs = torch.randn(K, N, Dv, generator=g).to(dev)
    leaves = [memory, queries] + [params[k] for k in ("wq", "v") if k in params]

    def forward():
        mem = attn.prepare_memory(typ, params, memory, lens.to(dev), bf)
        loop = attn.open_read_loop(typ, params, mem, bf, K) if LOOP else None
        kw = {"loop": loop} if LOOP else {}
        return [attn.attend(typ, params, queries[k], mem, bf, **kw)[0] for k in range(K)]

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    ctxs = forward()
    torch.autograd.grad(ctxs, leaves, list(dctxs))
    torch.cuda.synchronize()
    out[f"{typ}_peak_mb"] = (torch.cuda.max_memory_allocated() - before) / 1e6
    ctxs = forward()
    bwd = lambda: torch.autograd.grad(ctxs, leaves, list(dctxs), retain_graph=True)
    out[f"{typ}_loop_bwd_device_ms"] = cs.device_ms(bwd, reps=3, warmup=1)
    ev, _ = cs.device_events(bwd)
    by = collections.defaultdict(lambda: [0, 0.0])
    names = collections.defaultdict(lambda: [0, 0.0])
    for s, e, n in ev:
        by[kind(n)][0] += 1
        by[kind(n)][1] += (e - s) / 1e3
        names[n[:60]][0] += 1
        names[n[:60]][1] += (e - s) / 1e3
    out[f"{typ}_loop_bwd_events"] = len(ev)
    out[f"{typ}_loop_bwd_by_kind"] = {k: [n, round(ms, 4)] for k, (n, ms) in by.items()}
    out[f"{typ}_loop_bwd_top"] = sorted(([n, c, round(ms, 4)] for n, (c, ms) in names.items()),
                                        key=lambda x: -x[2])[:8]
    del ctxs

    # one call apart
    with torch.no_grad():
        mem = attn.prepare_memory(typ, params, memory, lens.to(dev), bf)
        q0, d0 = queries[0].detach().contiguous(), dctxs[0].contiguous()
        split = {}
        if hasattr(kernels, "bahdanau_attend_bwd"):
            wq, v, keys, values = attn.kernel_operands(typ, params, mem, bf)
            _, w = attn.attend_fwd(typ, params, q0, mem, bf)
            split["casts"] = cs.device_ms(lambda: attn.kernel_operands(typ, params, mem, bf))
            split["zeros"] = cs.device_ms(lambda: (
                torch.zeros((N, A), device=dev), torch.zeros((N, S, A), device=dev),
                torch.zeros((N, S, Dv), device=dev)))
            lib = kernels._load()
            dq_, dv_ = torch.zeros(N, Hq, device=dev), torch.zeros(N, A, device=dev)
            dvr = None if v is None else torch.zeros(N, A, device=dev)
            dk_, dval_ = torch.zeros(N, S, A, device=dev), torch.zeros(N, S, Dv, device=dev)
            st = torch.cuda.current_stream(dev).cuda_stream
            split["kernel"] = cs.device_ms(lambda: lib.avsr_bahdanau_attend_bwd(
                q0.data_ptr(), wq.data_ptr(), kernels._ptr(v), keys.data_ptr(),
                values.data_ptr(), w.data_ptr(), d0.data_ptr(), dq_.data_ptr(), dv_.data_ptr(),
                kernels._ptr(dvr), dk_.data_ptr(), dval_.data_ptr(), N, Hq, A, S, Dv,
                int(v is None), st))
            def wgrads():
                dwq, dv = attn.attention_weight_grads(q0, dv_, dvr, bf)
                return rounded(dwq, bf).float(), None if dv is None else rounded(dv, bf).float()
            split["weight_grads"] = cs.device_ms(wgrads)
            split["accumulate_one_step"] = cs.device_ms(lambda: (dk_ + dk_, dval_ + dval_))
        if LOOP:
            st = attn.LoopState(typ, mem, bf, K)
            st.bind(mem.keys, mem.values, params["wq"], params.get("v"))
            for k in range(K):
                st.next_step()
                st.queries[k] = queries[k].detach()
                st.weights[k] = attn.read_fwd(st, st.queries[k])[1]
            split["step_kernel"] = cs.device_ms(
                lambda: attn.read_step_bwd(st, 0, q0, st.weights[0], d0))
            split["sums_per_loop"] = cs.device_ms(lambda: attn.read_loop_sums(st), reps=5)
        out[f"{typ}_split_device_ms"] = split
print(json.dumps(out))
"""


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trees", nargs="+", required=True, help="checkout A, B, ...")
    ap.add_argument("--order", default="ABBA")
    ap.add_argument("--parts", nargs="+", default=["fwd", "bwd"], choices=["fwd", "bwd"])
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
        r.update(tree=tree, which=which)
        parts = []
        for t in ("bahdanau", "luong"):
            if "fwd" in args.parts:
                parts.append(f"{t} fwd device ms beam step {r[f'{t}_fwd_beam_device_ms']:.5f}, "
                             f"over 16 s {r[f'{t}_fwd_beam16_device_ms']:.5f}, "
                             f"greedy step {r[f'{t}_fwd_greedy_device_ms']:.5f}, "
                             f"over 16 s {r[f'{t}_fwd_greedy16_device_ms']:.5f}; the loop's "
                             f"forward, K = 80 reads, {r[f'{t}_fwd_loop80_device_ms']:.4f}")
                if f"{t}_fwd_beam_by_route" in r:
                    parts.append(f"{t} fwd device ms by kernel: beam step "
                                 f"{r[f'{t}_fwd_beam_by_route']}, over 16 s "
                                 f"{r[f'{t}_fwd_beam16_by_route']}, greedy step "
                                 f"{r[f'{t}_fwd_greedy_by_route']}, over 16 s "
                                 f"{r[f'{t}_fwd_greedy16_by_route']}")
            if "bwd" in args.parts:
                parts.append(
                    f"{t} loop bwd {r[f'{t}_loop_bwd_device_ms']:.4f} ms device, "
                    f"{r[f'{t}_loop_bwd_events']} events, by kind {r[f'{t}_loop_bwd_by_kind']}, "
                    f"peak {r[f'{t}_peak_mb']:.1f} MB, one call {r[f'{t}_split_device_ms']}")
        print(f"{which} ({tree}, untiled {r['untiled']}): " + "; ".join(parts), flush=True)
        runs.append(r)
    print(json.dumps({"card": card, "runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

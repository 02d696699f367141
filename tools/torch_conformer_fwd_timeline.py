#!/usr/bin/env python3
"""Where one launch of K9's fused forward spends its cycles, on one card.

    python3 tools/torch_conformer_fwd_timeline.py [--shapes 128,197 8,197 4,531]

Builds an instrumented copy of the port's kernels in a temporary directory:
in ``conv_fwd_fused_kernel`` (``csrc/conformer_conv.cu``) lane 0 of every
warp sums, over the item's tiles, the ``clock64()`` cycles of each stage of
a tile (the barrier and the wait for the tile's u rows, stage A's GLU rows,
stage B's conv and LayerNorm statistics with their two block barriers, the
swish and the stores) and writes the sums at the end.  It runs
``kernels.conformer_conv_fwd`` once on chip_smoke's ``k9_inputs`` (d = 512,
k = 15) at each (B, T) and prints per stage the median and the largest sum
over every warp of every item, the tiles an item, and the device ms of the
plain and the instrumented kernel beside the SM clock.  Needs a CUDA card
and ``nvcc``; the repository's own build is not touched.
"""

from __future__ import annotations

import argparse
import shutil
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

HEADER = """
static __device__ long long* g_marks;
#define TL(i) do { const long long t_ = clock64(); tl_acc[i] += t_ - tl_prev; tl_prev = t_; } \\
  while (0)
"""
SETTER = """
extern "C" int timeline_set_marks(void* p) {
  return (int)cudaMemcpyToSymbol(g_marks, &p, sizeof(p));
}
"""
STAGES = ("barrier + u wait", "A: GLU rows", "B: conv + LN stats", "B: swish + stores")
# (anchor, text inserted after it)
MARKS = (
    ("  const int ntiles = FPRO + (c1 - c0 + BR - 1) / BR;\n",
     "  long long tl_acc[5] = {0, 0, 0, 0, 0}, tl_prev = clock64();\n"),
    ("    // fwd: tile start\n", "    TL(4);\n"),
    ("    // fwd: u rows in\n", "    TL(0);\n"),
    ("    // fwd: y formed\n", "    TL(1);\n"),
    ("      // fwd: z formed\n", "      TL(2);\n"),
    ("    // fwd: out written\n", "    TL(3);\n"),
    ("  // fwd: end\n",
     "  if ((threadIdx.x & 31) == 0 && g_marks)\n"
     "    for (int i = 0; i < 5; ++i)\n"
     "      g_marks[((long long)blockIdx.x * 16 + (threadIdx.x >> 5)) * 8 + i] = tl_acc[i];\n"),
)


def instrument(csrc: Path) -> None:
    f = csrc / "conformer_conv.cu"
    s = f.read_text()
    for anchor, text in MARKS:
        if s.count(anchor) != 1:
            raise SystemExit(f"conformer_conv.cu no longer has one {anchor.strip()!r}: "
                             f"update MARKS")
        s = s.replace(anchor, anchor + text, 1)
    s = s.replace('#include "cluster_ptx.cuh"\n', '#include "cluster_ptx.cuh"\n' + HEADER, 1)
    f.write_text(s + SETTER)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shapes", nargs="+", default=["128,197", "8,197", "4,531"],
                    help="B,T of each run")
    args = ap.parse_args()
    import ctypes

    import torch

    import chip_smoke as cs
    from avsr_tpu_torch import kernels
    from avsr_tpu_torch.models import transformer as tfm

    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card)
    csrc0, build0 = kernels.CSRC, kernels.BUILD_DIR
    tmp = Path(tempfile.mkdtemp(prefix="k9_fwd_timeline_"))
    shutil.copytree(csrc0, tmp / "csrc")
    instrument(tmp / "csrc")
    kernels.CSRC, kernels.BUILD_DIR, kernels._lib = tmp / "csrc", tmp / "build", None
    try:
        lib = kernels._load()
        lib.timeline_set_marks.argtypes = [ctypes.c_void_p]
        for shape in args.shapes:
            B, T = (int(x) for x in shape.split(","))
            a = cs.k9_inputs(B, T, dev, seed=T + B)
            plan = kernels.conformer_fwd_plan(T, B, 512, 15)
            run = lambda: tfm.conformer_conv_fwd(*a)  # noqa: E731
            lib.timeline_set_marks(None)
            plain_ms = cs.device_ms(run)
            items = B * plan["chunks"]
            marks = torch.zeros((items, 16, 8), dtype=torch.int64, device=dev)
            lib.timeline_set_marks(marks.data_ptr())
            marked_ms = cs.device_ms(run)
            marks.zero_()
            run()
            torch.cuda.synchronize()
            lib.timeline_set_marks(None)
            m = marks.cpu()
            clock = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm",
                                    "--format=csv,noheader"],
                                   capture_output=True, text=True).stdout.strip()
            tiles = 2 + -(-plan["chunk"] // 8)
            print(f"K9 fused forward [B={B},T={T},d=512,k=15] {items} items of {plan['chunk']} "
                  f"steps ({tiles} tiles): device ms {plain_ms:.5f} (instrumented "
                  f"{marked_ms:.5f}), SM clock {clock}; cycles an item by stage (sums over its "
                  f"tiles, median / max over warps)")
            order = (4, 0, 1, 2, 3)
            names = ("loop + prior tile end",) + STAGES
            for i, name in zip(order, names):
                d = [int(m[it, w, i]) for it in range(items) for w in range(16)]
                print(f"  {name:>22}: median {statistics.median(d):9.0f}, max {max(d):9d}")
            tot = [int(m[it, w, :5].sum()) for it in range(items) for w in range(16)]
            print(f"  {'total':>22}: median {statistics.median(tot):9.0f}, max {max(tot):9d}")
            by_chunk = {c: statistics.median(int(m[it, w, :5].sum()) for it in range(c, items,
                                                                                   plan["chunks"])
                                             for w in range(16))
                        for c in range(min(plan["chunks"], 4))}
            print(f"  total by chunk (median cycles, the first chunks): {by_chunk}")
    finally:
        kernels.CSRC, kernels.BUILD_DIR, kernels._lib = csrc0, build0, None
    return 0


if __name__ == "__main__":
    sys.exit(main())

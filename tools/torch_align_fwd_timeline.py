#!/usr/bin/env python3
"""Where a step of K8's cluster forward spends its cycles, on one card.

    python3 tools/torch_align_fwd_timeline.py [--B 8] [--luong]

Builds an instrumented copy of the port's kernels in a temporary directory:
``clock64()`` marks, written at every step by CTA 0's first read thread and
its first gate thread at the phase boundaries of ``csrc/av_align_fwd.cuh``
and of ``bahdanau_core.cuh``'s ``scores_context`` (the read thread: the h
tile's wait, the q product and its sends, q's wait, the scores, the softmax,
the context, the carried context's bulk copies up to the next step; the gate
thread: the context's wait, the context product, the two halves' barrier,
the cell update and the h sends, the h tile's wait, the h product).  It runs
``models.fusion.av_align_scan_fwd`` on chip_smoke's ``k8_inputs`` (or
``k8_luong_inputs``) at [T_a=197, B, T_v=150], whose row 0 is live at every
step, and prints each phase's median cycles over steps 10-186 beside the
card's SM clock.  A mark is one global store; the instrumented step runs a
little longer than the plain one.  The marks hold one row a CTA (B up to
the 16-row clusters the card holds at once); at two the tool refuses.
Needs a CUDA card and ``nvcc``; the repository's own build is not touched.
"""

from __future__ import annotations

import argparse
import ctypes
import shutil
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

READ_PHASES = ("h wait", "q product+send", "q wait", "scores", "softmax", "context",
               "ctx send, next")
GATE_PHASES = ("ctx wait", "ctx product", "halves' barrier", "cell + h send", "h wait",
               "h product")

# (file, anchor, text inserted after the anchor)
MARKS = (
    ("bahdanau_core.cuh", "namespace bahdanau {\n",
     "static __device__ long long g_read[1024][8];\nstatic __device__ int g_step;\n"
     "__device__ __forceinline__ void mark(int k) {\n"
     "  if (blockIdx.x == 0 && threadIdx.x == 0) g_read[g_step][k] = clock64();\n}\n"),
    ("bahdanau_core.cuh",
     "  // softmax (fp32), the mask, the renormalisation and the empty-memory zero\n  {\n",
     "    mark(3);\n"),
    ("bahdanau_core.cuh", "  // context: a thread per 8-channel chunk, keys split over slices\n  {\n",
     "    mark(4);\n"),
    ("bahdanau_core.cuh", "      ctx_out(d, x);\n    }\n  }\n", "  mark(5);\n"),
    ("av_align_fwd.cuh", "namespace align_fwd {\n",
     "static __device__ long long g_gate[1024][8];\n"),
    ("av_align_fwd.cuh", "      const int slot = (t + 1) & 1;  // h_{t+1}: the carried h' of step t\n",
     "      if (tid == 0) { bahdanau::g_step = t; bahdanau::mark(7); }\n"),
    ("av_align_fwd.cuh", "      mbar_wait(&bars[slot], (uint32_t)((t >> 1) & 1));\n",
     "      bahdanau::mark(0);\n"),
    ("av_align_fwd.cuh", "      if (htid == 0) mbar_expect(&bars[3 + half], (uint32_t)(A * 4));\n",
     "      bahdanau::mark(1);\n"),
    ("av_align_fwd.cuh", "      mbar_wait(&bars[3 + half], (uint32_t)(t & 1));\n",
     "      bahdanau::mark(2);\n"),
    ("av_align_fwd.cuh", "    float acc_h[4][4], acc_c[4][4];\n",
     "    const bool g0 = blockIdx.x == 0 && tid == RPC * RT;\n"),
    ("av_align_fwd.cuh", "        mbar_wait(&bars[2], (uint32_t)((t - 1) & 1));\n",
     "        if (g0) g_gate[t][0] = clock64();\n"),
    ("av_align_fwd.cuh",
     "        gate_part(ct, Dc, mt, wsg, H, kh * kh_c, (kh + 1) * kh_c, lane, acc_c);\n",
     "        if (g0) g_gate[t][1] = clock64();\n"),
    ("av_align_fwd.cuh", "\"r\"(64 * NW) : \"memory\");\n      }\n",
     "      if (g0) g_gate[t][2] = clock64();\n"),
    ("av_align_fwd.cuh", "          st_async_b32(map_rank(a1, pr), hpk[1], pbar);\n        }\n",
     "        if (g0) g_gate[t][3] = clock64();\n"),
    ("av_align_fwd.cuh", "        mbar_wait(&bars[(t + 1) & 1], (uint32_t)((t >> 1) & 1));\n",
     "        if (g0) g_gate[t][4] = clock64();\n"),
    ("av_align_fwd.cuh", "                  acc_h);\n", "        if (g0) g_gate[t][5] = clock64();\n"),
)
DUMP = """
extern "C" int avsr_debug_timeline(long long* read, long long* gate) {
  cudaError_t e = cudaMemcpyFromSymbol(read, bahdanau::g_read, sizeof(long long) * 1024 * 8);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaMemcpyFromSymbol(gate, align_fwd::g_gate, sizeof(long long) * 1024 * 8);
}
"""


def instrument(csrc: Path) -> None:
    """Insert the marks into the copy ``csrc`` (each anchor must occur)."""
    for name, anchor, text in MARKS:
        f = csrc / name
        s = f.read_text()
        if anchor not in s:
            raise RuntimeError(f"{name}: anchor not found: {anchor!r}")
        f.write_text(s.replace(anchor, anchor + text, 1))
    scan = csrc / "av_align_scan.cu"
    scan.write_text(scan.read_text() + DUMP)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--B", type=int, default=8)
    ap.add_argument("--luong", action="store_true")
    args = ap.parse_args()
    import numpy as np
    import torch

    import chip_smoke as cs
    from avsr_tpu_torch import kernels
    from avsr_tpu_torch.models import fusion as fus

    tmp = Path(tempfile.mkdtemp(prefix="k8_timeline_"))
    shutil.copytree(kernels.CSRC, tmp / "csrc")
    instrument(tmp / "csrc")
    kernels.CSRC, kernels.BUILD_DIR = tmp / "csrc", tmp / "build"
    lib = kernels._load()
    lib.avsr_debug_timeline.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    kind = "luong" if args.luong else "bahdanau"
    make = cs.k8_luong_inputs if args.luong else cs.k8_inputs
    a = make(args.B, torch.device("cuda", 0), 5)
    S, A, Dv = a[5].keys.shape[1], a[5].keys.shape[2], a[5].values.shape[-1]
    if kernels.av_align_fwd_rows_per_cta(args.B, 256, Dv, A, S, Dv, args.luong) != 1:
        raise SystemExit(f"B={args.B} runs two rows a CTA: the marks hold one")
    for _ in range(3):
        fus.av_align_scan_fwd(*a, attention_type=kind)
    torch.cuda.synchronize()
    read, gate = np.zeros((1024, 8), np.int64), np.zeros((1024, 8), np.int64)
    if lib.avsr_debug_timeline(read.ctypes.data, gate.ctypes.data) != 0:
        raise RuntimeError("reading the marks failed")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    steps = range(10, 187)

    def med(d):
        return statistics.median(int(x) for x in d)

    print(f"{card.strip()}; K8 {kind} [T_a=197,B={args.B},T_v=150], CTA 0: median cycles of "
          f"each phase of a step over steps {steps.start}-{steps.stop - 1}")
    # the read thread: mark 7 opens step t, marks 0-5 follow, step t+1's mark 7 closes it
    order = (7, 0, 1, 2, 3, 4, 5)
    for (i, j), name in zip(zip(order, order[1:]), READ_PHASES):
        print(f"  read  {name:16s} {med(read[t, j] - read[t, i] for t in steps)}")
    print(f"  read  {READ_PHASES[-1]:16s} {med(read[t + 1, 7] - read[t, 5] for t in steps)}")
    print(f"  read  whole step       {med(read[t + 1, 7] - read[t, 7] for t in steps)}")
    print(f"  gate  {GATE_PHASES[0]:16s} {med(gate[t, 0] - gate[t - 1, 5] for t in steps)}")
    for k in range(1, 6):
        print(f"  gate  {GATE_PHASES[k]:16s} {med(gate[t, k] - gate[t, k - 1] for t in steps)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

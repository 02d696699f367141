#!/usr/bin/env python3
"""Where one launch of K10's forward at one query row a memory row spends its cycles, on one card.

    python3 tools/torch_attend_row_timeline.py [--kernel general row] [--S 197 531]

Builds an instrumented copy of the port's kernels in a temporary directory
(lane 0 of every warp writes ``clock64()`` at the stage boundaries of the
kernel) and runs one launch, straight into the library, on chip_smoke's
``k10_inputs`` (Bahdanau: Hq=256, A=128, Dv=768) and ``k10_luong_inputs``
(Luong: Hq=256, Hk=Dv=512) at N = 128 query rows over 128 memory rows, one
a row (greedy's and the teacher-forced loop's read), with a 0-length row.
For each stage it prints the median and the largest cycles over every warp
of every block, beside the SM clock and the device ms of the plain and the
instrumented kernel (chip_smoke's ``device_ms``).

``--kernel general``: ``bahdanau_attend_kernel`` (``bahdanau_core.cuh``'s
``read``, a block of 8 warps a query row): the query's rounding, the q
product, the scores, the softmax, the context.  ``--kernel row``:
``attend_row_kernel`` (``csrc/attend_row.cuh``; its 16 consumer warps):
the set-up (the query, bias, mask and v loaded, the producer warp
started), the q product, the scores over the key chunks as they land, the
softmax, the context over the value chunks, and the sums of the context's
slices.  A
mark is one global store a warp; the instrumented launch runs a little
longer than the plain one.  Needs a CUDA card and ``nvcc``; the
repository's own build is not touched.
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
#define MARK(i) do { \\
  if ((threadIdx.x & 31) == 0 && (threadIdx.x >> 5) < 16 && g_marks) \\
    g_marks[((long long)blockIdx.x * 16 + (threadIdx.x >> 5)) * 8 + (i)] = clock64(); \\
} while (0)
"""
SETTER = """
extern "C" int timeline_set_marks(void* p) {
  return (int)cudaMemcpyToSymbol(g_marks, &p, sizeof(p));
}
"""

# kernel -> (the header the marks go in, [(anchor, text inserted after it)], stage names)
MARKS = {
    "general": ("bahdanau_core.cuh", [
        ("  float* part = red + WARPS;   // [8 * THREADS]\n  const int tid = threadIdx.x;\n",
         "  MARK(0);\n"),
        ("    for (int i = tid; i < A; i += THREADS) v_s[i] = __bfloat162float(vatt[i]);\n"
         "  __syncthreads();\n", "  MARK(1);\n"),
        ("  q_product<DOT>(qin, wq, Hq, A, part, q_s);\n", "  MARK(2);\n"),
        ("  // softmax (fp32), the mask, the renormalisation and the empty-memory zero\n  {\n",
         "    MARK(3);\n"),
        ("  // context: a thread per 8-channel chunk, keys split over slices\n  {\n",
         "    MARK(4);\n"),
        ("      ctx_out(d, x);\n    }\n  }\n", "  MARK(5);\n"),
    ], ("query rounded", "q product", "scores", "softmax", "context")),
    "row": ("attend_row.cuh", [
        ("  // row: start\n", "  MARK(0);\n"),
        ("  // row: set up\n", "  MARK(1);\n"),
        ("  // row: q formed\n", "  MARK(2);\n"),
        ("  // row: scores formed\n", "  MARK(3);\n"),
        ("  // row: softmax done\n", "  MARK(4);\n"),
        ("    // row: context chunks read\n", "    MARK(5);\n"),
        ("  // row: context done\n", "  MARK(6);\n"),
    ], ("set-up", "q product", "scores", "softmax", "context chunks", "context sums")),
}


def instrument(csrc: Path, kernel: str) -> None:
    """Insert the marks of ``kernel`` into the copy ``csrc`` (each anchor
    must occur once)."""
    name, marks, _ = MARKS[kernel]
    f = csrc / name
    s = f.read_text()
    for anchor, text in marks:
        if s.count(anchor) != 1:
            raise SystemExit(f"{name} no longer has one {anchor.strip()!r}: update MARKS")
        s = s.replace(anchor, anchor + text, 1)
    s = s.replace("#include <stdint.h>\n", "#include <stdint.h>\n" + HEADER, 1)
    f.write_text(s)
    attend = csrc / "bahdanau_attend.cu"
    attend.write_text(attend.read_text() + SETTER)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel", nargs="+", default=["general", "row"], choices=sorted(MARKS))
    ap.add_argument("--S", nargs="+", type=int, default=[197])
    args = ap.parse_args()
    import ctypes

    import torch

    import chip_smoke as cs
    from avsr_tpu_torch import kernels
    from avsr_tpu_torch.ops import attention as attn

    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card)
    csrc0, build0 = kernels.CSRC, kernels.BUILD_DIR
    for kernel in args.kernel:
        tmp = Path(tempfile.mkdtemp(prefix=f"k10_{kernel}_timeline_"))
        shutil.copytree(csrc0, tmp / "csrc")
        instrument(tmp / "csrc", kernel)
        kernels.CSRC, kernels.BUILD_DIR, kernels._lib = tmp / "csrc", tmp / "build", None
        lib = kernels._load()
        lib.timeline_set_marks.argtypes = [ctypes.c_void_p]
        _, _, stages = MARKS[kernel]
        for S in args.S:
            for make in (cs.k10_inputs, cs.k10_luong_inputs):
                typ, att, query, mem, _ = make(128, dev, seed=S + 3, S=S)
                ops = attn.kernel_operands(typ, att, mem, torch.bfloat16)
                run = lambda: cs.k10_launch(kernel, query, *ops, mem.bias, mem.mask)  # noqa: E731
                lib.timeline_set_marks(None)
                plain_ms = cs.device_ms(run)
                marks = torch.zeros((128, 16, 8), dtype=torch.int64, device=dev)
                lib.timeline_set_marks(marks.data_ptr())
                marked_ms = cs.device_ms(run)
                marks.zero_()
                run()
                torch.cuda.synchronize()
                lib.timeline_set_marks(None)
                m = marks.cpu()
                warps = [w for w in range(16) if int(m[0, w, 0]) != 0]
                clock = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm",
                                        "--format=csv,noheader"],
                                       capture_output=True, text=True).stdout.strip()
                print(f"{kernel} {typ} [N=128,S={S}]: device ms {plain_ms:.5f} (instrumented "
                      f"{marked_ms:.5f}), SM clock {clock}, {len(warps)} warps a block")
                for i, name in enumerate(stages, start=1):
                    d = [int(m[b, w, i] - m[b, w, i - 1]) for b in range(128) for w in warps]
                    print(f"  {name:>14}: median {statistics.median(d):8.0f} cycles, "
                          f"max {max(d):8d}")
                tot = [int(m[b, w, len(stages)] - m[b, w, 0]) for b in range(128) for w in warps]
                print(f"  {'total':>14}: median {statistics.median(tot):8.0f} cycles, "
                      f"max {max(tot):8d}")
    kernels.CSRC, kernels.BUILD_DIR, kernels._lib = csrc0, build0, None
    return 0


if __name__ == "__main__":
    sys.exit(main())

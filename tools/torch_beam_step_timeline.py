#!/usr/bin/env python3
"""Where one launch of K7, the fused beam step, spends its cycles on the card.

    python3 tools/torch_beam_step_timeline.py [--shapes 8,10,44 8,1,44 8,32,44]

Builds an instrumented copy of ``avsr_tpu_torch/csrc/beam_step.cu`` into
``build/`` (lane 0 of every warp writes ``clock64()`` at eight marks, each
after an instruction that consumes the value the stage produced, so a mark
waits for its loads), runs it through ``kernels.BeamStep`` on chip_smoke's
``k7_inputs`` and prints, per stage, the median and the largest cycles over
every warp of every block: the beam's state and length penalty loaded, its
logits row staged, the log-softmax, the keys written, the first level (its
best min(W, V)), the block barrier, the second level (ranks and writes),
and the settled flag's barrier (where W > 16 a warp's marks are those of
its last beam).  It also prints the device ms of the kernel and of its
instrumented copy (chip_smoke's ``device_ms``) and the SM clock.  Needs a
CUDA card and ``nvcc``.
"""

from __future__ import annotations

import argparse
import ctypes
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

MARKS = [  # (text of the source, the same text with its mark)
    ("  if (threadIdx.x == 0 && nt > W * K) top_s[W * K] = 0ull;\n",
     "  if (threadIdx.x == 0 && nt > W * K) top_s[W * K] = 0ull;\n  MARK(0, 0.f);\n"),
    ("    const float pen = a.lp_table[cl];\n",
     "    const float pen = a.lp_table[cl];\n    MARK(1, pen);\n"),
    ("    float mx = __int_as_float(0xff800000u), lse = 0.f;\n",
     "    __syncwarp();\n    MARK(2, cw[lane % V]);\n"
     "    float mx = __int_as_float(0xff800000u), lse = 0.f;\n"),
    ("      lse = logf(sum);\n    }\n", "      lse = logf(sum);\n    }\n    MARK(3, lse);\n"),
    ("    if (lane == 0 && Vp > V) kw[V] = 0ull;\n    __syncwarp();\n",
     "    if (lane == 0 && Vp > V) kw[V] = 0ull;\n    __syncwarp();\n    MARK(4, 0.f);\n"),
    ("  __syncthreads();\n", "  MARK(5, 0.f);\n  __syncthreads();\n  MARK(6, 0.f);\n"),
    ("  settled = __syncthreads_and(settled) != 0;\n",
     "  MARK(7, (float)settled);\n  settled = __syncthreads_and(settled) != 0;\n"
     "  MARK(8, (float)settled);\n"),
]
HEADER = r"""
__device__ long long* g_marks;
#define MARK(i, v) do { unsigned mark_dep_; \
  asm volatile("mov.b32 %0, %1;" : "=r"(mark_dep_) : "f"(v)); (void)mark_dep_; \
  if ((threadIdx.x & 31) == 0 && g_marks) \
    g_marks[((long long)blockIdx.x * 16 + (threadIdx.x >> 5)) * 16 + (i)] = clock64(); \
} while (0)
extern "C" int timeline_set_marks(void* p) {
  return (int)cudaMemcpyToSymbol(g_marks, &p, sizeof(p));
}
"""
STAGES = ["state and penalty", "logits row", "log-softmax", "keys", "first level",
          "block barrier", "second level", "settled barrier"]


def instrumented_source() -> str:
    src = (ROOT / "avsr_tpu_torch/csrc/beam_step.cu").read_text()
    for plain, marked in MARKS:
        if src.count(plain) != 1:
            raise SystemExit(f"beam_step.cu no longer has one {plain.strip()!r}: update MARKS")
        src = src.replace(plain, marked)
    return src.replace("#include <stdint.h>\n", "#include <stdint.h>\n" + HEADER, 1)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shapes", nargs="+", default=["8,10,44", "8,1,44", "8,32,44"],
                    help="B,W,V of each run")
    args = ap.parse_args()

    import torch

    import chip_smoke as cs
    from avsr_tpu_torch import kernels
    from avsr_tpu_torch.decode import beam

    out_dir = kernels.BUILD_DIR / "beam_step_timeline"
    out_dir.mkdir(parents=True, exist_ok=True)
    src, lib_path = out_dir / "beam_step_timeline.cu", out_dir / "libbeam_step_timeline.so"
    src.write_text(instrumented_source())
    res = subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", str(lib_path), str(src)],
                         capture_output=True, text=True)
    if res.returncode != 0:
        print(res.stderr, file=sys.stderr)
        return 1
    lib = ctypes.CDLL(str(lib_path))
    lib.avsr_beam_step.argtypes = [ctypes.POINTER(kernels._BeamStepArgs), ctypes.c_void_p,
                                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.avsr_beam_step.restype = ctypes.c_int
    lib.timeline_set_marks.argtypes = [ctypes.c_void_p]
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card)
    for shape in args.shapes:
        B, W, V = (int(x) for x in shape.split(","))
        logits, logp, lens, finished = cs.k7_inputs(B, W, V, dev, seed=8)
        lp_table = beam.length_penalty_table(150, 0.0, dev)
        tokens = torch.empty((4, B, W), dtype=torch.int64, device=dev)
        parents = torch.empty((4, B, W), dtype=torch.int64, device=dev)
        carries = (beam.step_buffers(B, W, dev), beam.step_buffers(B, W, dev))
        for x, y in zip((carries[0].logp, carries[0].lens, carries[0].finished),
                        (logp, lens, finished)):
            x.copy_(y)
        step = kernels.BeamStep(lp_table, tokens, parents, carries, V)
        kernel_ms = cs.device_ms(lambda: step(logits, 0, 0))
        marks = torch.zeros((B, 16, 16), dtype=torch.int64, device=dev)
        step._fn = lib.avsr_beam_step
        lib.timeline_set_marks(marks.data_ptr())
        marked_ms = cs.device_ms(lambda: step(logits, 0, 0))
        step(logits, 0, 0)
        torch.cuda.synchronize()
        m = marks.cpu()
        warps = min(W, 16)
        clock = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader"],
                               capture_output=True, text=True).stdout.strip()
        print(f"[B={B},W={W},V={V}] device ms {kernel_ms:.4f} (instrumented {marked_ms:.4f}), "
              f"SM clock {clock}")
        for i, name in enumerate(STAGES, start=1):
            d = [int(m[b, w, i] - m[b, w, i - 1]) for b in range(B) for w in range(warps)]
            print(f"  {name:>18}: median {statistics.median(d):8.0f} cycles, max {max(d):8d}")
        total = [int(m[b, w, 8] - m[b, w, 0]) for b in range(B) for w in range(warps)]
        print(f"  {'total':>18}: median {statistics.median(total):8.0f} cycles, "
              f"max {max(total):8d}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

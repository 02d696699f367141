#!/usr/bin/env python3
"""Check div_row's quotient against IEEE division on the CPU.

    python3 tools/check_div_row.py

``avsr_tpu_torch/csrc/attention_mma.cuh`` divides the attention scores and
their cotangents by sqrt(DK) with ``div_row(x, y, r)``: q = x * r with r
the correctly rounded 1 / y, then one correction fma(fma(-y, q, x), r, q),
in place of IEEE division's per-element range check and slow-path branch.
This compiles the same three roundings as C++ (``g++``, fused multiply-adds
only where written) and counts, for y = sqrt(128) (K4's width) and
sqrt(64) = 8 (K11's), the inputs where the quotient differs from IEEE
x / y: over every finite bf16 x (the scores are bf16 before the division)
and over 2^27 random fp32 bit patterns (the cotangents), both in all and
where |x / y| >= 1e-30.  The binary goes to ``build/`` at the repository
root; the last line is one JSON object with the counts.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

SOURCE = r"""
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <random>

static float bits(uint32_t u) { float x; std::memcpy(&x, &u, 4); return x; }
static bool same(float a, float b) { return std::memcmp(&a, &b, 4) == 0; }
// div_row of attention_mma.cuh
static float div_row(float x, float y, float r) {
  volatile float q = x * r;
  return std::fmaf(std::fmaf(-y, q, x), r, q);
}

int main() {
  const float ys[2] = {std::sqrt(128.f), std::sqrt(64.f)};
  std::printf("{");
  for (int k = 0; k < 2; ++k) {
    const float y = ys[k];
    volatile float one = 1.f;
    const float r = one / y;
    long n[2] = {0, 0}, diff[2] = {0, 0}, diff_big[2] = {0, 0};
    std::mt19937 gen(1);
    for (long i = 0; i < 65536 + (1L << 27); ++i) {
      const int set = i < 65536 ? 0 : 1;  // every bf16 value, then random fp32 bits
      const float x = set == 0 ? bits((uint32_t)i << 16) : bits(gen());
      if (!std::isfinite(x)) continue;
      volatile float want = x / y;
      const float w = want, got = div_row(x, y, r);
      ++n[set];
      if (!same(w, got)) {
        ++diff[set];
        if (std::fabs(w) >= 1e-30f) ++diff_big[set];
      }
    }
    std::printf("%s\"%.9g\": {\"bf16_inputs\": %ld, \"bf16_differ\": %ld, "
                "\"bf16_differ_above_1e-30\": %ld, \"fp32_inputs\": %ld, \"fp32_differ\": %ld, "
                "\"fp32_differ_above_1e-30\": %ld}",
                k ? ", " : "", y, n[0], diff[0], diff_big[0], n[1], diff[1], diff_big[1]);
  }
  std::printf("}\n");
  return 0;
}
"""


def main() -> int:
    build = Path(__file__).resolve().parents[1] / "build"
    build.mkdir(exist_ok=True)
    src, exe = build / "check_div_row.cpp", build / "check_div_row"
    src.write_text(SOURCE)
    cc = subprocess.run(["g++", "-O2", "-ffp-contract=off", "-o", str(exe), str(src)],
                        capture_output=True, text=True)
    if cc.returncode != 0:
        print(cc.stderr, file=sys.stderr)
        return 1
    out = subprocess.run([str(exe)], capture_output=True, text=True, check=True).stdout.strip()
    for y, c in json.loads(out).items():
        print(f"y = {y}: bf16 x {c['bf16_differ']} of {c['bf16_inputs']} differ "
              f"({c['bf16_differ_above_1e-30']} with |x / y| >= 1e-30); random fp32 x "
              f"{c['fp32_differ']} of {c['fp32_inputs']} ({c['fp32_differ_above_1e-30']})")
    print(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())

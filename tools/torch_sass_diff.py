#!/usr/bin/env python3
"""Compare the machine code of one CUDA source's kernels across checkouts.

    python3 tools/torch_sass_diff.py --trees build/parent . \\
        --source avsr_tpu_torch/csrc/lstm_scan.cu --match lstm_cluster

Each checkout's source is compiled to a cubin with the port's own nvcc
flags (``kernels.NVCC_FLAGS``, for ``sm_90a``), and ``cuobjdump`` lists each
kernel's SASS and resource usage (registers, stack, shared memory).
Kernels are paired across checkouts by their demangled name up to the
parameter list, with a last ``false`` template argument dropped (a kernel
that gained a ``bool`` template parameter keeps its name for its ``false``
instance).  For each kernel that the first checkout and another share,
the script prints both resource lines and whether the instruction streams
are identical once addresses and encodings are stripped; if not, the
count of instructions in each and the first lines that differ.  Kernels
whose name holds none of ``--match`` are skipped.  The last line is one
JSON object with every comparison.  Needs the CUDA toolkit (``nvcc``,
``cuobjdump`` and ``cu++filt`` or ``c++filt``); no card is used.
"""

from __future__ import annotations

import argparse
import difflib
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def _tool(name: str) -> str:
    cuda = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(cuda, "bin", name)
    return cand if os.path.exists(cand) else (shutil.which(name) or name)


def _demangle(names):
    filt = _tool("cu++filt")
    if not os.path.exists(filt) and not shutil.which(filt):
        filt = shutil.which("c++filt") or "c++filt"
    out = subprocess.run([filt], input="\n".join(names), capture_output=True, text=True,
                         check=True).stdout.splitlines()
    return dict(zip(names, out))


def _key(demangled: str) -> str:
    m = re.match(r"(.*?<.*?>)\(", demangled)
    head = m.group(1) if m else demangled.split("(")[0]
    return re.sub(r", (?:\(bool\)0|false)>$", ">", head)


def _cubin(tree: str, source: str, work: str, tag: str) -> str:
    from avsr_tpu_torch.kernels import NVCC_FLAGS

    flags = [f for f in NVCC_FLAGS if f not in ("-shared", "-Xcompiler", "-fPIC")]
    out = os.path.join(work, f"{tag}.cubin")
    src = os.path.abspath(os.path.join(tree, source))
    res = subprocess.run([_tool("nvcc"), *flags, "-cubin", "-o", out, src],
                         capture_output=True, text=True, cwd=os.path.dirname(src))
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{res.stderr}")
    return out


def _functions(cubin: str):
    """{mangled name: (list of instruction texts, resource line)}."""
    sass = subprocess.run([_tool("cuobjdump"), "-sass", cubin], capture_output=True, text=True,
                          check=True).stdout
    res = subprocess.run([_tool("cuobjdump"), "-res-usage", cubin], capture_output=True,
                         text=True, check=True).stdout
    funcs, cur = {}, None
    for line in sass.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            cur = m.group(1)
            funcs[cur] = []
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s*(.*?)\s*;", line)
        if cur and m:
            funcs[cur].append(re.sub(r"\s+", " ", m.group(1)))
    usage, name = {}, None
    for line in res.splitlines():
        m = re.match(r"\s*Function (\S+):", line)
        if m:
            name = m.group(1)
        elif name and "REG:" in line:
            usage[name] = " ".join(line.split())
            name = None
    return {k: (v, usage.get(k, "")) for k, v in funcs.items()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trees", nargs="+", required=True, help="checkouts: the first is the base")
    ap.add_argument("--source", required=True, help="the .cu file, relative to each checkout")
    ap.add_argument("--match", nargs="+", default=[""], help="substrings of kernel names")
    args = ap.parse_args()
    work = tempfile.mkdtemp(prefix="sass_diff_")
    try:
        per_tree = []
        for i, tree in enumerate(args.trees):
            funcs = _functions(_cubin(tree, args.source, work, f"t{i}"))
            names = _demangle(list(funcs))
            per_tree.append({_key(names[k]): v for k, v in funcs.items()
                             if any(s in names[k] for s in args.match)})
    finally:
        shutil.rmtree(work, ignore_errors=True)
    base, result = per_tree[0], []
    for tree, funcs in zip(args.trees[1:], per_tree[1:]):
        for key in sorted(set(base) & set(funcs)):
            (a, ra), (b, rb) = base[key], funcs[key]
            diff = [d for d in difflib.unified_diff(a, b, lineterm="", n=0)
                    if d[:1] in "+-" and d[:3] not in ("+++", "---")]
            same = a == b
            print(f"{tree} {key}: {'identical SASS' if same else 'SASS differs'} "
                  f"({len(a)} / {len(b)} instructions); {args.trees[0]}: {ra}; {tree}: {rb}")
            for d in diff[:6]:
                print(f"    {d}")
            result.append(dict(tree=tree, kernel=key, identical=same, instructions=[len(a), len(b)],
                               differing_lines=len(diff), resources=[ra, rb]))
        for key in sorted(set(base) ^ set(funcs)):
            print(f"{tree} {key}: only in {'the base' if key in base else tree}")
    print(json.dumps({"source": args.source, "trees": args.trees, "kernels": result}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

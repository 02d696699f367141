#!/usr/bin/env python3
"""K11's softmax division on the card: ``div_row`` against IEEE ``e / l``.

    python3 tools/torch_k11_division_ab.py

The tensor-core attention core (``avsr_tpu_torch/csrc/attention_mma.cuh``)
divides each weight by its row sum with ``div_row``, a branch-free
correction of ``e * (1 / l)``.  This script builds two copies of K11 from
the checkout's sources into ``build/k11_division/``: the sources as they are,
and the same sources with every ``div_row(e, l, y)`` call replaced by
``e / l`` (CUDA's IEEE division, with its per-element range check and
slow-path branch).  It holds both against the plain PyTorch version at
B=128, 8 heads, T=197, dh=64, times their forward and backward (device ms,
chip_smoke's CUDA-event timing) in the order div_row, IEEE, IEEE, div_row,
and compares ``div_row`` with IEEE division on 2^25 pairs (e = exp(-x), x
uniform on [0, 110) and on [0, 2); l uniform on [1, 601), a quarter of them
whole): how many quotients differ, by how many ulps, and the largest one
that differs.  Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

CHECK = r'''
__global__ void div_row_check_kernel(const float* e, const float* l, float* out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = mma_attn::div_row(e[i], l[i], __frcp_rn(l[i]));
}
extern "C" int div_row_check(const void* e, const void* l, void* out, int n) {
  div_row_check_kernel<<<(n + 255) / 256, 256>>>(static_cast<const float*>(e),
                                                  static_cast<const float*>(l),
                                                  static_cast<float*>(out), n);
  return (int)cudaGetLastError();
}
'''


def build(kernels) -> dict:
    csrc = ROOT / "avsr_tpu_torch" / "csrc"
    core = (csrc / "attention_mma.cuh").read_text()
    head, sep, body = core.partition("__device__ __forceinline__ uint32_t pack_bf16")
    ieee = head + sep + body.replace("div_row(", "div_ieee(")
    ieee = ieee.replace("__device__ __forceinline__ uint32_t pack_bf16",
                        "__device__ __forceinline__ float div_ieee(float e, float l, float) {\n"
                        "  return e / l;\n}\n__device__ __forceinline__ uint32_t pack_bf16", 1)
    if ieee.count("div_ieee(") < 4:
        raise RuntimeError("attention_mma.cuh: no div_row call sites found")
    libs, procs = {}, []
    for name, text in (("div_row", core), ("ieee", ieee)):
        out = ROOT / "build" / "k11_division" / name
        out.mkdir(parents=True, exist_ok=True)
        (out / "attention_mma.cuh").write_text(text)
        (out / "encoder_attention.cu").write_text(
            (csrc / "encoder_attention.cu").read_text() + (CHECK if name == "div_row" else ""))
        libs[name] = out / "libk11.so"
        procs.append(subprocess.Popen([kernels._nvcc(), *kernels.NVCC_FLAGS, "-o",
                                       str(libs[name]), str(out / "encoder_attention.cu")],
                                      stderr=subprocess.PIPE, text=True))
    for p in procs:
        _, err = p.communicate()
        if p.returncode:
            raise RuntimeError(err)
    return {name: ctypes.CDLL(str(path)) for name, path in libs.items()}


def main() -> int:
    import torch

    import chip_smoke as cs
    from avsr_tpu_torch import kernels
    from avsr_tpu_torch.models import transformer as tfm

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card)
    libs = build(kernels)
    P, I = ctypes.c_void_p, ctypes.c_int
    dev = torch.device("cuda", 0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    qkv, lens = cs.k11_inputs(128, 197, dev, seed=197)
    B, T, _, nh, dh = qkv.shape
    dctx = torch.randn((B, T, nh, dh), generator=torch.Generator().manual_seed(200))
    dctx = dctx.to(torch.bfloat16).to(dev)
    ctx_p, st_p = tfm.encoder_self_attention_fwd_plain(qkv, lens, save=True)
    g_p = tfm.encoder_self_attention_bwd_plain(qkv, lens, *st_p, dctx)
    ctx = torch.empty((B, T, nh, dh), dtype=torch.bfloat16, device=dev)
    D, dqkv = torch.empty_like(st_p[0]), torch.empty_like(qkv)
    st = (torch.empty_like(st_p[0]), torch.empty_like(st_p[1]))
    calls = {}
    for name, lib in libs.items():
        lib.avsr_encoder_attn_fwd.argtypes = [P] * 5 + [I] * 4 + [P]
        lib.avsr_encoder_attn_bwd.argtypes = [P] * 7 + [I] * 4 + [P]
        fwd = (lambda lib=lib: lib.avsr_encoder_attn_fwd(
            qkv.data_ptr(), lens.data_ptr(), st[0].data_ptr(), st[1].data_ptr(), ctx.data_ptr(),
            B, T, nh, dh, stream))
        bwd = (lambda lib=lib: lib.avsr_encoder_attn_bwd(
            qkv.data_ptr(), lens.data_ptr(), st_p[0].data_ptr(), st_p[1].data_ptr(),
            dctx.data_ptr(), D.data_ptr(), dqkv.data_ptr(), B, T, nh, dh, stream))
        if fwd() or bwd():
            raise RuntimeError(f"{name}: launch failed")
        torch.cuda.synchronize()
        print(f"{name}: ctx max abs err {cs.max_err(ctx, ctx_p)}, dqkv relative to max |plain| "
              f"{cs.rel_err(dqkv, g_p)}")
        calls[name] = (fwd, bwd)
    for name in ("div_row", "ieee", "ieee", "div_row"):
        fwd, bwd = calls[name]
        print(f"[{card}] K11 with {name}, B=128, 8 heads, T=197, dh=64: forward (save mode) "
              f"{cs.device_ms(fwd):.4f} ms, backward {cs.device_ms(bwd):.4f} ms (device)",
              flush=True)

    lib = libs["div_row"]
    lib.div_row_check.argtypes = [P, P, P, I]
    g = torch.Generator(device=dev).manual_seed(0)
    n = 1 << 24
    for hi in (110.0, 2.0):
        e = torch.exp(-hi * torch.rand(n, device=dev, generator=g))
        l = 1.0 + 600.0 * torch.rand(n, device=dev, generator=g)
        l[: n // 4] = torch.floor(l[: n // 4])
        out = torch.empty_like(e)
        if lib.div_row_check(e.data_ptr(), l.data_ptr(), out.data_ptr(), n):
            raise RuntimeError("div_row_check: launch failed")
        ref = e / l
        bad = out != ref
        ulps = int((out.view(torch.int32) - ref.view(torch.int32)).abs().max())
        largest = float(ref[bad].max()) if bool(bad.any()) else None
        print(f"div_row against IEEE e / l, e = exp(-U[0, {hi})), {n} pairs: {int(bad.sum())} "
              f"differ, by at most {ulps} ulp; the largest quotient that differs: {largest}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

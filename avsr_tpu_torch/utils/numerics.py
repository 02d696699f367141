"""Dtype policy helpers shared by the port's modules.

The reference computes matmuls on compute-dtype (bf16) operands and, where
it asks for ``preferred_element_type=float32``, returns the fp32
accumulator.  A bf16 product of two bf16 values is exact in fp32, so
upcasting the ROUNDED operands and multiplying in fp32 gives the same
result up to summation order, on the CPU and on the GPU alike (which keeps
the CPU parity tests meaningful).  Where the reference's matmul returns the
compute dtype, the port multiplies in that dtype directly.
"""

from __future__ import annotations

import contextlib

import torch


def compute_dtype_of(cfg) -> torch.dtype:
    return torch.bfloat16 if cfg.train.compute_dtype == "bfloat16" else torch.float32


def dot_f32(a: torch.Tensor, b: torch.Tensor, cdt: torch.dtype) -> torch.Tensor:
    """``a @ b`` on compute-dtype operands with an fp32 result."""
    return a.to(cdt).float() @ b.to(cdt).float()


def rounded(x: torch.Tensor, cdt: torch.dtype) -> torch.Tensor:
    """``x`` rounded to the compute dtype, back in fp32: what the transpose
    of the reference's cast to ``cdt`` makes of a cotangent (the port's
    hand-written backward twins apply it where JAX's autodiff does)."""
    return x.to(cdt).float()


@contextlib.contextmanager
def full_precision(cdt: torch.dtype):
    """Under the fp32 policy (``cdt`` float32): every float32 matrix product
    at "highest" precision and every cuDNN convolution without TF32, whatever
    the process's flags are (PyTorch's default lets cuDNN's fp32
    convolutions run in TF32); the flags are put back on exit.  The bf16
    policy leaves them as they are.  The flags are the process's, so a
    backward that runs after the forward's scope ends needs a scope of its
    own (``train.step.loss_and_grads`` holds one over both)."""
    if cdt != torch.float32:
        yield
        return
    matmul = torch.get_float32_matmul_precision()
    cudnn = torch.backends.cudnn.allow_tf32
    torch.set_float32_matmul_precision("highest")
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(matmul)
        torch.backends.cudnn.allow_tf32 = cudnn


# The kernel families with an fp32 instance on the card: lrs2_av_fast's
# (K1's direction-fused scan without a recurrent-dropout mask, K4, K5 and
# K6) and lrs2_av_align's (K1, K8 and K10 with the Bahdanau read); K3 and
# K7 take no operand of the compute dtype.  The Luong reads' instances
# ("K8 Luong", "K10 Luong") are still to be ported.
FP32_FAMILIES = ("K1", "K4", "K5", "K6", "K8", "K10")


def check_policy(cdt: torch.dtype, family: str) -> None:
    """Raises unless the CUDA kernels of ``family`` ("K1", "K1 rd", "K2",
    "K4", ..., "K8 Luong", "K10 Luong", ..., "K13") run the compute dtype
    ``cdt`` on the card: every
    family takes the bf16 policy, those of ``FP32_FAMILIES`` the fp32 one
    too.  A wrapper calls it for GPU tensors only: on the CPU every family
    runs its plain version under either policy."""
    if cdt == torch.bfloat16 or (cdt == torch.float32 and family in FP32_FAMILIES):
        return
    if cdt == torch.float32:
        raise ValueError(f"{family}: the fp32 instance of its kernels is still to be ported; on "
                         f"the card the fp32 policy runs {', '.join(FP32_FAMILIES)}")
    raise ValueError(f"{family}: the kernels run the bf16 or the fp32 policy, got {cdt}")

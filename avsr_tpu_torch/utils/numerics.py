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

import torch


def compute_dtype_of(cfg) -> torch.dtype:
    return torch.bfloat16 if cfg.train.compute_dtype == "bfloat16" else torch.float32


def dot_f32(a: torch.Tensor, b: torch.Tensor, cdt: torch.dtype) -> torch.Tensor:
    """``a @ b`` on compute-dtype operands with an fp32 result."""
    return a.to(cdt).float() @ b.to(cdt).float()

"""Precision of the reference's products.

``f32``: float32 with TF32 switched off (a float32 product on the H100
otherwise may run in TF32, which is a lower precision). ``fp8``: the
control, one precision below the bfloat16 that the configurations state:
both operands of every product are rounded to float8 e4m3 with one scale a
tensor (its largest magnitude onto 448, the format's largest), the product
taken in f32, and the gradient passed straight through the rounding.
"""
from __future__ import annotations

import torch

F8_MAX = 448.0


def strict_f32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded through float8 e4m3 with a per-tensor scale; the
    gradient passes straight through."""
    amax = x.detach().abs().amax().clamp_min(1e-30)
    scale = amax / F8_MAX
    q = (x.detach() / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale
    return x + (q - x.detach())


def mm(a: torch.Tensor, b: torch.Tensor, mode: str) -> torch.Tensor:
    """``a @ b`` in float32, through fp8 operands under the control."""
    if mode == "fp8":
        a, b = fp8_round(a), fp8_round(b)
    elif mode != "f32":
        raise ValueError(f"precision {mode!r}; known: f32, fp8")
    return a @ b


def einsum(eq: str, a: torch.Tensor, b: torch.Tensor, mode: str) -> torch.Tensor:
    if mode == "fp8":
        a, b = fp8_round(a), fp8_round(b)
    return torch.einsum(eq, a, b)

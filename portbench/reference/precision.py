"""Operand rounding of the references' products: float32, bfloat16 or float8 e4m3.

``bf16`` rounds each operand of a matrix product or a convolution to
bfloat16, the precision that the configurations state (``STATED``): the
error that rounding alone brings, the yardstick of a served answer's gap.
``fp8`` is the nearest precision below the bf16 that the configurations
state: each operand of a matrix product or a convolution is scaled so that
its largest magnitude sits at e4m3's largest finite value (448), rounded to
e4m3 and scaled back, the per-tensor scaling of fp8 training.  Gradients
pass through the rounding unchanged (straight-through), as in fp8 training
where the forward's operands are what is rounded.
"""

from __future__ import annotations

import contextlib

import torch

E4M3_MAX = 448.0
# A configuration's ``dtype`` -> the operand rounding that it states.
STATED = {"bfloat16": "bf16"}


class _RoundFp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        scale = x.detach().abs().amax().clamp_min(1e-30) / E4M3_MAX
        return (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale

    @staticmethod
    def backward(ctx, g):
        return g


def operand(x: torch.Tensor, precision: str) -> torch.Tensor:
    """``x`` as a product's operand in ``precision`` ('exact', 'bf16' or 'fp8')."""
    if precision == "exact":
        return x
    if precision == "bf16":
        return x.to(torch.bfloat16).to(x.dtype)
    if precision == "fp8":
        return _RoundFp8.apply(x)
    raise ValueError(f"unknown precision {precision!r}")


@contextlib.contextmanager
def float32_exact():
    """TF32 off for matmuls and cuDNN inside the block, restored after."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved

"""The control's lower precision: the reference with every product
computed one step below what the configuration states.

The configuration computes in bfloat16 (``TPU.COMPUTE_DTYPE``); one step
below is fp8, as fp8 training runs it: each product's operands rounded to
e4m3 and, in a backward, the gradient arriving at its output rounded to
e5m2, each tensor with one scale from its largest magnitude.  That holds
for the FBO and the classifier too, which the port runs above the stated
precision, in float32.
"""

from __future__ import annotations

import torch

E4M3_MAX = 448.0        # the largest finite float8_e4m3fn
E5M2_MAX = 57344.0      # the largest finite float8_e5m2


def _round(x: torch.Tensor, dtype, largest: float) -> torch.Tensor:
    scale = x.abs().amax().clamp(min=1e-30) / largest
    return (x / scale).to(dtype).to(x.dtype) * scale


class _RoundGrad(torch.autograd.Function):
    """The identity forward; the gradient rounded to e5m2 backward."""

    @staticmethod
    def forward(ctx, y):
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2, E5M2_MAX)


class Lower:
    """The control's rounding: ``lower(x)`` for a product's operand (e4m3,
    gradients pass it unchanged), ``lower.out(y)`` for its output (the
    gradient that arrives there rounded to e5m2)."""

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        rounded = _round(x.detach(), torch.float8_e4m3fn, E4M3_MAX)
        return x + (rounded - x).detach() if x.requires_grad else rounded

    def out(self, y: torch.Tensor) -> torch.Tensor:
        return _RoundGrad.apply(y) if y.requires_grad else y


lower = Lower()

"""3D and pointwise convolutions over channels-last activations (port of
``lfb_tpu/ops/conv3d.py``).

Activations are NDHWC at every public function; weights are in the Caffe2
layout (Cout, Cin/groups, kT, kH, kW), which is what ``F.conv3d`` takes.  An
NDHWC tensor seen through ``permute(0, 4, 1, 2, 3)`` already has
``channels_last_3d`` strides, so cuDNN runs its channels-last kernels and
no copy is made on the way in or out.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F


def conv3d(x: torch.Tensor, w: torch.Tensor, *,
           strides: Sequence[int] = (1, 1, 1),
           padding: Sequence[int] = (0, 0, 0),
           dilation: Sequence[int] = (1, 1, 1), groups: int = 1,
           bias: torch.Tensor | None = None) -> torch.Tensor:
    """(B, T, H, W, Cin) x (Cout, Cin/groups, kT, kH, kW) -> (B, T', H', W',
    Cout) with symmetric per-dim padding, in ``x``'s dtype."""
    w = w.to(dtype=x.dtype, memory_format=torch.channels_last_3d)
    out = F.conv3d(x.permute(0, 4, 1, 2, 3), w, None, tuple(strides),
                   tuple(padding), tuple(dilation), groups)
    out = out.permute(0, 2, 3, 4, 1)
    if bias is not None:
        out = out + bias.to(out.dtype)
    return out.contiguous()


def conv1x1(x: torch.Tensor, w: torch.Tensor,
            bias: torch.Tensor | None = None) -> torch.Tensor:
    """Pointwise conv as one matmul: ``x`` (..., Cin), ``w`` (Cout, Cin) or a
    (Cout, Cin, 1, 1, 1) kernel.  The bias is added after rounding to
    ``x``'s dtype, as ``lfb_tpu`` does."""
    out = F.linear(x, w.reshape(w.shape[0], w.shape[1]).to(x.dtype))
    if bias is not None:
        out = out + bias.to(out.dtype)
    return out

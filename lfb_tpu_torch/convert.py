"""Weights carried between ``lfb_tpu``'s params in memory and the port's.

``lfb_tpu`` keeps conv kernels as (kT, kH, kW, Cin, Cout) and FC weights as
(Cin, Cout); the port keeps the Caffe2 layout, which is PyTorch's own:
(Cout, Cin/g, kT, kH, kW) and (Cout, Cin).  The names are the Caffe2 blob
names in both.  A released ``.pkl`` (or a checkpoint of either package)
loads into the port through its own
:func:`lfb_tpu_torch.train.checkpoints.load_params_into`; the functions
here carry params between the two packages in memory, as the tests do.  An
optimizer state (``lfb_tpu``'s or the port's ``SGDState``) converts too:
its momentum buffers have the params' names and layouts.
"""

from __future__ import annotations

import numpy as np
import torch

from lfb_tpu_torch.train.checkpoints import tpu_to_c2
from lfb_tpu_torch.train.optimizer import SGDState


def params_from_jax(params, device: torch.device | str = 'cuda'):
    """``lfb_tpu`` params (numpy arrays) -> the port's f32 params on
    ``device``; an ``SGDState`` -> the port's ``SGDState`` with converted
    momentum."""
    if hasattr(params, 'momentum'):
        return SGDState(momentum=params_from_jax(params.momentum, device))
    return {name: torch.tensor(tpu_to_c2(name, np.asarray(value)),
                               device=device)
            for name, value in params.items()}


def params_to_jax(params):
    """Inverse of :func:`params_from_jax`: numpy arrays in ``lfb_tpu``'s
    layout; an ``SGDState`` gives an ``SGDState`` of numpy momentum, which
    ``lfb_tpu.train.optimizer`` reads as its own (same field)."""
    if isinstance(params, SGDState):
        return SGDState(momentum=params_to_jax(params.momentum))
    out = {}
    for name, value in params.items():
        a = value.detach().to('cpu', torch.float32).numpy()
        if a.ndim == 5:
            a = np.transpose(a, (2, 3, 4, 1, 0))
        elif a.ndim == 2:
            a = a.T
        out[name] = np.ascontiguousarray(a)
    return out

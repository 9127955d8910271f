"""Weights carried between ``lfb_tpu`` and the port.

``lfb_tpu`` keeps conv kernels as (kT, kH, kW, Cin, Cout) and FC weights as
(Cin, Cout); the port keeps the Caffe2 layout, which is PyTorch's own:
(Cout, Cin/g, kT, kH, kW) and (Cout, Cin).  The names are the Caffe2 blob
names in both, so a released ``.pkl`` loads through
``lfb_tpu.train.checkpoints.load_params_into`` followed by
:func:`params_from_jax`.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from lfb_tpu.train.checkpoints import tpu_to_c2


def params_from_jax(params: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """``lfb_tpu`` params (numpy arrays) -> the port's f32 params."""
    return {name: torch.tensor(tpu_to_c2(name, np.asarray(value)))
            for name, value in params.items()}


def params_to_jax(params: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """Inverse of :func:`params_from_jax`: numpy arrays in ``lfb_tpu``'s
    layout."""
    out = {}
    for name, value in params.items():
        a = value.detach().to('cpu', torch.float32).numpy()
        if a.ndim == 5:
            a = np.transpose(a, (2, 3, 4, 1, 0))
        elif a.ndim == 2:
            a = a.T
        out[name] = np.ascontiguousarray(a)
    return out

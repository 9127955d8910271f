"""SGD with Caffe2 ``MomentumSGDUpdate`` semantics (port of
``lfb_tpu/train/optimizer.py``; reference
``lib/models/model_builder_video.py:348-389``):

    g    := grad + wd * param          (wd = WEIGHT_DECAY_BN for '_bn' params)
    V    := mu * V + lr * g            (lr lives INSIDE the momentum buffer)
    step := (1 + mu) * V - mu * V_prev   if nesterov else V
    param -= step

Because lr is inside V, a step change of lr rescales V by new_lr / old_lr
(:func:`correct_momentum`, the reference's ``_CorrectMomentum``).  Frozen
parameters get no momentum buffer and are never touched.  The port updates
the parameters and buffers in place, in f32, under ``torch.no_grad``; the
functions return them so their signatures mirror ``lfb_tpu``'s.  The LR
schedule is the port's copy of ``lfb_tpu``'s (``train/lr_policy.py``).
"""

from __future__ import annotations

from typing import Dict, Mapping, NamedTuple

import torch

from lfb_tpu_torch.train.lr_policy import get_lr_at_iter  # noqa: F401  (re-export)
from lfb_tpu_torch.utils.profiling import count


class SGDState(NamedTuple):
    momentum: Dict[str, torch.Tensor]   # only trainable entries present


def init_state(params: Mapping[str, torch.Tensor], frozen: set) -> SGDState:
    return SGDState(momentum={k: torch.zeros_like(v)
                              for k, v in params.items() if k not in frozen})


@torch.no_grad()
def apply_updates(params: Dict[str, torch.Tensor],
                  grads: Mapping[str, torch.Tensor], state: SGDState, *,
                  lr: float, momentum: float, nesterov: bool,
                  weight_decay: float, weight_decay_bn: float):
    """One momentum-SGD update of every parameter that has a momentum
    buffer, in place.  Returns (params, state)."""
    count('optimizer.tensors', len(state.momentum))
    for name, v in state.momentum.items():
        p = params[name]
        g = grads[name].float()
        wd = weight_decay_bn if '_bn' in name else weight_decay
        if wd:
            g = g + wd * p
        v_new = momentum * v + lr * g
        step = (1.0 + momentum) * v_new - momentum * v if nesterov else v_new
        p.sub_(step)
        v.copy_(v_new)
    return params, state


@torch.no_grad()
def correct_momentum(state: SGDState, correction: float) -> SGDState:
    """Scale every momentum buffer by new_lr / old_lr, in place, on an LR
    step."""
    for v in state.momentum.values():
        v.mul_(correction)
    return state

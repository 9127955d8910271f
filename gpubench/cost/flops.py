"""The model's floating-point operations per batch, counted by PyTorch's
``FlopCounterMode`` on the frozen reference over meta tensors (shapes
only: no memory, no device, no data).

Counted: phase A and phase B of the real boxes (AVA) or clips, and for a
train step the forward with the backward of the trainable parameters only,
once (no recomputation).  Padding rows, recomputation and anything else a
program may do on top are not work the user asked for.
"""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from gpubench.reference import model as M


def _inputs(arch: M.Arch, clips: int, boxes: int):
    meta = torch.device('meta')
    data = torch.empty((clips, arch.frames, arch.crop, arch.crop, 3),
                       dtype=torch.uint8, device=meta)
    rows = clips * boxes if arch.roi_head else clips
    rois = torch.empty((rows, 5), device=meta) if arch.roi_head else None
    return data, rois, rows


def _params(specs, trainable=()):
    return {name: torch.empty(shape, device='meta',
                              requires_grad=name in trainable)
            for name, shape, _ in specs}


def two_phase(model: dict, clips: int, boxes: int) -> float:
    """FLOPs of phase A and phase B of one batch of ``clips``."""
    arch_a = M.Arch(model, 'test', infer_only=True)
    arch_b = M.Arch(model, 'test')
    data, rois, rows = _inputs(arch_b, clips, boxes)
    params = _params(M.param_specs(arch_b))
    window = torch.empty((rows, arch_b.rows_in_window, arch_b.lfb_dim),
                         device='meta')
    with FlopCounterMode(display=False) as count, torch.no_grad():
        M.head_features(params, data, rois, arch_a)
        feat = M.head_features(params, data, rois, arch_b)
        M.classify(params, feat, window, arch_b)
    return float(count.get_total_flops())


def train_step(model: dict, clips: int, boxes: int) -> float:
    """FLOPs of one train step's forward and backward."""
    arch = M.Arch(model, 'train')
    data, rois, rows = _inputs(arch, clips, boxes)
    specs = M.param_specs(arch)
    trainable = M.trainable_names(arch, [n for n, _, _ in specs])
    params = _params(specs, set(trainable))
    window = torch.empty((rows, arch.rows_in_window, arch.lfb_dim),
                         device='meta')
    labels = torch.empty((rows, arch.num_classes), device='meta')
    with FlopCounterMode(display=False) as count:
        if arch.freeze_backbone:
            with torch.no_grad():
                feat = M.head_features(params, data, rois, arch)
        else:
            feat = M.head_features(params, data, rois, arch)
        logits = M.classify(params, feat, window, arch)
        loss, _ = M.sigmoid_ce(logits, labels)
        torch.autograd.grad(loss, [params[n] for n in trainable],
                            allow_unused=True)
    return float(count.get_total_flops())

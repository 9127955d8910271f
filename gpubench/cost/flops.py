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


def _inputs(arch, clips: int, boxes: int):
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


def two_phase(net, model: dict, clips: int, boxes: int) -> float:
    """FLOPs of phase A and phase B of one batch of ``clips`` through the
    reference network ``net`` (a module of ``reference/``)."""
    arch_a = net.Arch(model, 'test', infer_only=True)
    arch_b = net.Arch(model, 'test')
    data, rois, rows = _inputs(arch_b, clips, boxes)
    params = _params(net.param_specs(arch_b))
    window = torch.empty((rows, arch_b.rows_in_window, arch_b.lfb_dim),
                         device='meta')
    with FlopCounterMode(display=False) as count, torch.no_grad():
        net.head_features(params, data, rois, arch_a)
        feat = net.head_features(params, data, rois, arch_b)
        net.classify(params, feat, window, arch_b)
    return float(count.get_total_flops())


def train_step(net, dataset, model: dict, clips: int, boxes: int) -> float:
    """FLOPs of one train step's forward and backward through ``net``,
    with the loss of ``dataset`` (a module of ``reference/datasets/``)."""
    arch = net.Arch(model, 'train')
    data, rois, rows = _inputs(arch, clips, boxes)
    specs = net.param_specs(arch)
    trainable = net.trainable_names(arch, [n for n, _, _ in specs])
    params = _params(specs, set(trainable))
    window = torch.empty((rows, arch.rows_in_window, arch.lfb_dim),
                         device='meta')
    labels = dataset.empty_labels(rows, arch.num_classes,
                                  torch.device('meta'))
    with FlopCounterMode(display=False) as count:
        if arch.freeze_backbone:
            with torch.no_grad():
                feat = net.head_features(params, data, rois, arch)
        else:
            feat = net.head_features(params, data, rois, arch)
        logits = net.classify(params, feat, window, arch)
        loss = dataset.loss(logits, labels)
        torch.autograd.grad(loss, [params[n] for n in trainable],
                            allow_unused=True)
    return float(count.get_total_flops())

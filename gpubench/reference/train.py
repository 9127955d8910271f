"""The reference's train step: the stage-2 loss and its gradients, taken a
block of clips at a time, and Caffe2's momentum SGD (the LFB paper's
``lib/models/model_builder_video.py:348-389``):

    g    := grad + wd * param         (wd = WEIGHT_DECAY_BN for '_bn' params)
    V    := mu * V + lr * g           (lr inside the momentum buffer)
    step := (1 + mu) * V - mu * V_prev   with Nesterov, else V
    param -= step

With the frozen affine every clip's rows are independent of the other
clips', so the loss over the whole batch (each clip's weighted sum over
the batch's weighted count) and its gradient are sums over blocks of
clips: a block's activations are all that is ever held.
"""

from __future__ import annotations

from typing import Dict, Mapping

import torch

from gpubench.reference import model as M


def sgd_update(params: Dict[str, torch.Tensor], grads: Mapping,
               momentum: Dict[str, torch.Tensor], *, lr: float, mu: float,
               nesterov: bool, wd: float, wd_bn: float) -> None:
    """One momentum-SGD step of every parameter that has a momentum
    buffer, in place."""
    with torch.no_grad():
        for name, v in momentum.items():
            p = params[name]
            g = grads[name] + (wd_bn if '_bn' in name else wd) * p
            v_new = mu * v + lr * g
            p -= (1.0 + mu) * v_new - mu * v if nesterov else v_new
            v.copy_(v_new)


def loss_and_grads(params: Mapping[str, torch.Tensor], trainable, batch,
                   window_rows, bank_feats, masks, arch: M.Arch, *,
                   block: int, quant: M.Quant = None):
    """(loss, {name: gradient}, logits of the rows) of the stage-2 loss
    over the whole batch.

    ``batch`` holds 'data' (B, T, H, W, 3) uint8 and 'labels'; AVA also
    'rois' (N, 5) and 'weight' (N,), the real rows only; ``window_rows``
    (N, W) bank rows of those rows; ``masks`` the dropout masks of those
    rows.  ``block`` clips go through the backbone at a time."""
    data, labels = batch['data'], batch['labels']
    weight = batch.get('weight')
    clips = data.shape[0]
    count = (float(weight.sum()) * labels.shape[1] if weight is not None
             else float(labels.numel()))
    leaves = {k: params[k].detach().requires_grad_(True) for k in trainable}
    p = {**params, **leaves}
    grads = {k: torch.zeros_like(v) for k, v in leaves.items()}
    total = 0.0

    def backward(loss):
        got = torch.autograd.grad(loss, [leaves[k] for k in trainable],
                                  allow_unused=True)
        for k, g in zip(trainable, got):
            if g is not None:
                grads[k] += g

    if arch.freeze_backbone:
        # The backbone's output carries no gradient: its features once,
        # block by block, then the head over every row.
        with torch.no_grad():
            feat = torch.cat([
                M.head_features(params, data[b:b + block], None, arch, quant)
                for b in range(0, clips, block)])
        window = bank_feats[window_rows].float()
        logits = M.classify(p, feat, window, arch, masks, quant)
        num, _ = M.sigmoid_ce(logits, labels, weight)
        loss = num / max(count, 1.0)
        backward(loss)
        return float(loss.detach()), grads, logits.detach()
    rois = batch['rois']
    logits_all = torch.zeros((rois.shape[0], arch.num_classes),
                             device=rois.device)
    for b in range(0, clips, block):
        sel = ((rois[:, 0] >= b) & (rois[:, 0] < b + block)).nonzero()[:, 0]
        if sel.numel() == 0:
            continue
        r = rois[sel].clone()
        r[:, 0] -= b
        feat = M.head_features(p, data[b:b + block], r, arch, quant)
        window = bank_feats[window_rows[sel]].float()
        logits = M.classify(p, feat, window, arch,
                            {k: m[sel] for k, m in masks.items()}, quant)
        num, _ = M.sigmoid_ce(logits, labels[sel],
                              None if weight is None else weight[sel])
        loss = num / max(count, 1.0)
        backward(loss)
        total += float(loss.detach())
        logits_all[sel] = logits.detach()
    return total, grads, logits_all

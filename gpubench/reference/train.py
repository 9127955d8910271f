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
clips: a block's activations are all that is ever held.  One path serves
a RoI head and a clip head alike; with the backbone frozen, its features
are taken block by block and the head runs once over every row.
"""

from __future__ import annotations

from typing import Dict, Mapping

import torch


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


def loss_and_grads(net, dataset, params: Mapping[str, torch.Tensor],
                   trainable, batch, window_rows, bank_feats, masks, arch, *,
                   block: int, quant=None):
    """(loss, {name: gradient}, logits of the rows) of the stage-2 loss
    over the whole batch.

    ``net`` is the reference network (a module of ``reference/``, of
    which ``arch`` is an ``Arch``), ``dataset`` the dataset's reference
    side (``reference/datasets/``: its ``loss`` and ``loss_count``).
    ``batch`` holds 'data' (B, T, H, W, 3) uint8 and 'labels'; a RoI head
    also 'rois' (N, 5) and 'weight' (N,), the real rows only;
    ``window_rows`` (N, W) bank rows of those rows; ``masks`` the dropout
    masks of those rows.  ``block`` clips go through the backbone at a
    time."""
    data, labels = batch['data'], batch['labels']
    weight = batch.get('weight')
    clips = data.shape[0]
    count = dataset.loss_count(labels, weight)
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
                net.head_features(params, data[b:b + block], None, arch,
                                  quant)
                for b in range(0, clips, block)])
        window = bank_feats[window_rows].float()
        logits = net.classify(p, feat, window, arch, masks, quant)
        loss = dataset.loss(logits, labels, weight) / max(count, 1.0)
        backward(loss)
        return float(loss.detach()), grads, logits.detach()
    # Each row belongs to one clip (a RoI head's rows to the clip in their
    # first column, a clip head's row i to clip i): a block of clips, with
    # its rows' logits and loss, is all that is ever held.
    rois = batch['rois'] if arch.roi_head else None
    owner = (rois[:, 0] if rois is not None
             else torch.arange(clips, device=data.device))
    logits_all = torch.zeros((owner.shape[0], arch.num_classes),
                             device=data.device)
    for b in range(0, clips, block):
        sel = ((owner >= b) & (owner < b + block)).nonzero()[:, 0]
        if sel.numel() == 0:
            continue
        r = None
        if rois is not None:
            r = rois[sel].clone()
            r[:, 0] -= b
        feat = net.head_features(p, data[b:b + block], r, arch, quant)
        window = bank_feats[window_rows[sel]].float()
        logits = net.classify(p, feat, window, arch,
                              {k: m[sel] for k, m in masks.items()}, quant)
        num = dataset.loss(logits, labels[sel],
                           None if weight is None else weight[sel])
        loss = num / max(count, 1.0)
        backward(loss)
        total += float(loss.detach())
        logits_all[sel] = logits.detach().to(logits_all.dtype)
    return total, grads, logits_all

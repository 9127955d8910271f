"""The reference's losses, shared by the datasets that train with them
(:mod:`gpubench.reference.datasets`)."""

from __future__ import annotations

import torch


def sigmoid_ce(logits, labels, weight=None):
    """The sum of the per-element sigmoid cross-entropy, each row's
    weighted by its ``weight``."""
    z = logits
    per = torch.clamp(z, min=0) - z * labels + torch.log1p(torch.exp(-z.abs()))
    return per.sum() if weight is None else (per * weight[:, None]).sum()


def sigmoid_ce_count(labels, weight=None) -> float:
    """What the loss of a whole batch divides :func:`sigmoid_ce` by: the
    count of weighted elements."""
    if weight is None:
        return float(labels.numel())
    return float(weight.sum()) * labels.shape[1]


def multi_hot_labels(rows: int, classes: int, device) -> torch.Tensor:
    """An uninitialised (rows, classes) label tensor, as the batches'."""
    return torch.empty((rows, classes), device=device)


def multi_label_logits(logits: torch.Tensor) -> torch.Tensor:
    """A multi-label head's logits as the comparison reads them: as they
    are (a single-label head's would be their log-softmax)."""
    return logits

"""EPIC-Kitchens verbs' side of the reference: an example's window of bank
rows and the single-label loss, as the LFB paper's
``lib/datasets/epic.py:310-331`` and its softmax loss define them.

The paper's verb sampler walks the frames of [centre - half, centre +
half], half = WINDOW_SIZE * FPS // 2, in order, and appends the video's
feature at each frame that has one until it holds WINDOW_SIZE; zeros fill
the rest.  Here the same walk runs over the benchmark's packed index
tables, whose frames lie in ascending order in each video's row: a
feature's place in the window is the count of the video's features inside
the window before it.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

__all__ = ['window_rows', 'loss', 'loss_count', 'empty_labels',
           'compared_logits']


def window_rows(tables: Dict[str, torch.Tensor],
                host: Dict[str, np.ndarray], model: dict, *, zero: int,
                generator: torch.Generator) -> torch.Tensor:
    """(N, window) bank row ids of a batch's N clips, from their videos
    and centre frames (``host['video']``, ``host['center']``): the first
    ``window`` features whose frame lies in the inclusive [centre - half,
    centre + half], the zero row ``zero`` after them.  Nothing is drawn
    from ``generator``."""
    frame_ids, rows = tables['frame_ids'], tables['rows']
    window, fps = model['LFB.WINDOW_SIZE'], model['EPIC.FPS']
    dev = frame_ids.device
    video = torch.from_numpy(host['video']).to(dev).long()
    center = torch.from_numpy(host['center']).to(dev).long()
    half = window * fps // 2
    fid = frame_ids[video]
    inside = ((fid >= 0) & (fid >= (center - half)[:, None])
              & (fid <= (center + half)[:, None]))
    place = torch.cumsum(inside.long(), dim=1) - 1
    taken = inside & (place < window)
    out = torch.full((video.shape[0], window), zero, dtype=rows.dtype,
                     device=dev)
    clip, slot = taken.nonzero(as_tuple=True)
    out[clip, place[clip, slot]] = rows[video][clip, slot]
    return out


def loss(logits, labels, weight=None):
    """The sum over the rows of the softmax cross-entropy of each row's
    logits at its one label (``weight``: each row's weight)."""
    log_p = torch.log_softmax(logits, dim=-1)
    per = -log_p.gather(-1, labels.long()[:, None])[:, 0]
    return per.sum() if weight is None else (per * weight).sum()


def loss_count(labels, weight=None) -> float:
    """What the loss of a whole batch divides :func:`loss` by: the count of
    (weighted) rows."""
    if weight is None:
        return float(labels.shape[0])
    return float(weight.sum())


def empty_labels(rows: int, classes: int, device) -> torch.Tensor:
    """An uninitialised (rows,) tensor of class ids, as the batches'."""
    return torch.empty((rows,), dtype=torch.long, device=device)


def compared_logits(logits: torch.Tensor) -> torch.Tensor:
    """A single-label head's logits as the comparison reads them: their
    log-softmax, in float64."""
    return torch.log_softmax(logits.double(), dim=-1)

"""Charades' side of the reference: an example's window of bank rows (the
LFB paper's ``lib/datasets/charades.py:250-270`` sampler, over the
benchmark's packed index tables) and the multi-label loss."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from gpubench.reference.losses import multi_label_logits as compared_logits
from gpubench.reference.losses import multi_hot_labels as empty_labels
from gpubench.reference.losses import sigmoid_ce as loss
from gpubench.reference.losses import sigmoid_ce_count as loss_count

__all__ = ['window_rows', 'loss', 'loss_count', 'empty_labels',
           'compared_logits']


def window_rows(tables: Dict[str, torch.Tensor],
                host: Dict[str, np.ndarray], model: dict, *, zero: int,
                generator: torch.Generator) -> torch.Tensor:
    """(N, window) bank row ids of a batch's N clips, from their videos
    and centre frames (``host['video']``, ``host['center']``): the first
    ``window`` features whose frame lies in [begin, begin + secs * fps],
    begin = round(centre - secs / 2 * fps), secs = window /
    clips_per_second; the zero row ``zero`` after them.  Nothing is drawn
    from ``generator``."""
    frame_ids, rows = tables['frame_ids'], tables['rows']
    window, fps = model['LFB.WINDOW_SIZE'], model['CHARADES.FPS']
    dev = frame_ids.device
    video = torch.from_numpy(host['video']).to(dev).long()
    center = torch.from_numpy(host['center']).to(dev)
    secs = window // model['CHARADES.LFB_CLIPS_PER_SECOND']
    begin = torch.round(center.float() - secs / 2.0 * fps).long()
    end = begin + secs * fps
    fid = frame_ids[video]
    inside = (fid >= 0) & (fid >= begin[:, None]) & (fid <= end[:, None])
    width = fid.shape[1]
    key = torch.where(inside, torch.arange(width, device=dev), width + 1)
    pick = torch.argsort(key, dim=-1, stable=True)[:, :window]
    got = torch.take_along_dim(rows[video], pick, dim=-1)
    return torch.where(torch.take_along_dim(inside, pick, dim=-1), got, zero)

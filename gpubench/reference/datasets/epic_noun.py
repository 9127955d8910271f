"""EPIC-Kitchens nouns' side of the reference: an example's window of bank
rows and the single-label loss, as the LFB paper's
``lib/datasets/epic.py:338-374`` and its softmax loss define them.

The paper's noun sampler takes secs = WINDOW_SIZE / (K * fps_lfb) seconds
around the centre (K = MAX_NUM_FEATS_PER_NOUN_LFB_FRAME, fps_lfb =
NOUN_LFB_FRAMES_PER_SECOND): lower = int(c - secs / 2 * fps), upper =
int(lower + secs * fps), in floating point as Python computes them.  It
walks the frames of [lower, upper] in order, takes up to K boxes of each
frame that has any, and stops once it holds WINDOW_SIZE; zeros fill the
rest.  Here the same walk runs over the benchmark's packed index tables,
whose entries lie in frame order in each video's row, a frame's boxes
side by side: a box is taken when it is among its frame's first K and the
boxes taken before it in the window number under WINDOW_SIZE.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from gpubench.reference.datasets.epic_verb import (compared_logits,
                                                   empty_labels, loss,
                                                   loss_count)

__all__ = ['window_rows', 'loss', 'loss_count', 'empty_labels',
           'compared_logits']


def bounds(center: torch.Tensor, model: dict):
    """The inclusive [lower, upper] frames of each centre's window, in
    float64 with truncation toward zero, as the paper's ``int()``."""
    fps = model['EPIC.FPS']
    secs = model['LFB.WINDOW_SIZE'] / float(
        model['EPIC.MAX_NUM_FEATS_PER_NOUN_LFB_FRAME']
        * model['EPIC.NOUN_LFB_FRAMES_PER_SECOND'])
    lower = torch.trunc(center.double() - secs / 2 * fps)
    upper = torch.trunc(lower + secs * fps)
    return lower.long(), upper.long()


def window_rows(tables: Dict[str, torch.Tensor],
                host: Dict[str, np.ndarray], model: dict, *, zero: int,
                generator: torch.Generator) -> torch.Tensor:
    """(N, window) bank row ids of a batch's N clips, from their videos
    and centre frames (``host['video']``, ``host['center']``): the boxes
    the paper's walk takes, in its order, the zero row ``zero`` after
    them.  Nothing is drawn from ``generator``."""
    frame_ids, rows = tables['frame_ids'], tables['rows']
    window = model['LFB.WINDOW_SIZE']
    k = model['EPIC.MAX_NUM_FEATS_PER_NOUN_LFB_FRAME']
    dev = frame_ids.device
    video = torch.from_numpy(host['video']).to(dev).long()
    center = torch.from_numpy(host['center']).to(dev).long()
    lower, upper = bounds(center, model)
    fid = frame_ids[video]
    inside = (fid >= 0) & (fid >= lower[:, None]) & (fid <= upper[:, None])
    # A box's rank among its frame's boxes: its slot less its frame's first.
    slot = torch.arange(fid.shape[1], device=dev).expand_as(fid)
    new_frame = torch.ones_like(inside)
    new_frame[:, 1:] = fid[:, 1:] != fid[:, :-1]
    first = torch.cummax(torch.where(new_frame, slot, 0), dim=1).values
    walked = inside & (slot - first < k)
    place = torch.cumsum(walked.long(), dim=1) - 1
    taken = walked & (place < window)
    out = torch.full((video.shape[0], window), zero, dtype=rows.dtype,
                     device=dev)
    clip, col = taken.nonzero(as_tuple=True)
    out[clip, place[clip, col]] = rows[video][clip, col]
    return out

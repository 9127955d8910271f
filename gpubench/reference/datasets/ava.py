"""AVA's side of the reference: an example's window of bank rows (the LFB
paper's ``lib/datasets/ava.py:300-323`` sampler, over the benchmark's
packed index tables) and the multi-label loss.

The tables are the benchmark's (``datasets/ava.py``), the rows those the
benchmark drew; the random draw of a window (at most K features of each
second, uniformly among that second's) is worked out again here from the
generator the program was given: one uniform number per (row, second,
stored slot), the K smallest taken, empty slots last.
"""

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

SEC_BASE = 902
NUM_SECS = 897


def window_rows(tables: Dict[str, torch.Tensor],
                host: Dict[str, np.ndarray], model: dict, *, zero: int,
                generator: torch.Generator) -> torch.Tensor:
    """(N, window * k) bank row ids of a batch's N box rows, from their
    videos and keyframe seconds (``host['meta']``); the zero row ``zero``
    fills what a second lacks."""
    table, counts = tables['table'], tables['counts']
    window = model['LFB.WINDOW_SIZE']
    k = model['AVA.LFB_MAX_NUM_FEAT_PER_STEP']
    dev = table.device
    meta = torch.from_numpy(host['meta']).to(dev)
    video, sec = meta[:, 0], meta[:, 1]
    k_store = table.shape[-1]
    secs = (sec.long()[:, None] - window // 2 - SEC_BASE
            + torch.arange(window, device=dev))
    inside = (secs >= 0) & (secs < NUM_SECS)
    secs = secs.clamp(0, NUM_SECS - 1)
    vid = video.long()[:, None]
    n = torch.where(inside, counts[vid, secs], 0)
    u = torch.rand((video.shape[0], window, k_store), generator=generator,
                   device=dev)
    u = u + (torch.arange(k_store, device=dev) >= n[..., None]) * 10.0
    pick = torch.argsort(u, dim=-1)[..., :k]
    rows = torch.take_along_dim(table[vid, secs], pick, dim=-1)
    keep = torch.arange(k, device=dev) < n.clamp(max=k)[..., None]
    return torch.where(keep, rows, zero).reshape(video.shape[0], window * k)

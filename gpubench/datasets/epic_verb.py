"""EPIC-Kitchens verbs (the LFB paper's ``lib/datasets/epic.py``): one verb
a clip, and a bank of one row a second of each video, keyed by the
video's name.

The bank's tables are those of the port's ``FrameDeviceBank``: a (video,
slot) table of frame ids (-1 past the video's rows) and one of row ids
(the zero row there); a window is the 'epic_verb' one.  The names map to
the tables' dense video ids, so a batch names each clip's video by its id
and its centre frame (``lfb_video_idx`` / ``lfb_center``).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

PHASE_A_OUTPUT = 'pool5'


def tables(model: dict, count_model: dict, rng: np.random.Generator
           ) -> Tuple[Dict[str, np.ndarray], np.ndarray, int]:
    """(the tables, the frames of each video, the bank's rows) from the
    count model: 'videos' videos of 'frames' [lo, hi] frames each, drawn
    uniform, scaled to 'hours' in all at EPIC.FPS and clipped to [lo, hi];
    a row every 'row_every' frames from 'first_frame'."""
    lo, hi = count_model['frames']
    frames = rng.integers(lo, hi + 1, size=count_model['videos'])
    total_frames = count_model['hours'] * 3600 * model['EPIC.FPS']
    frames = np.clip(np.round(frames * (total_frames / frames.sum())),
                     lo, hi).astype(np.int64)
    first, every = count_model['first_frame'], count_model['row_every']
    rows = (frames - first) // every + 1
    total = int(rows.sum())
    width = max(model['LFB.WINDOW_SIZE'], int(rows.max()))
    slot = np.arange(width)
    used = slot < rows[:, None]
    start = np.cumsum(rows) - rows
    frame_ids = np.where(used, first + every * slot, -1)
    row_ids = np.where(used, start[:, None] + slot, total)
    return {'frame_ids': frame_ids, 'rows': row_ids}, frames, total


def port_bank(bank, model: dict):
    """The port's device bank over the same rows and tables."""
    from lfb_tpu_torch.bank.device_bank import FrameDeviceBank
    return FrameDeviceBank(
        bank.feats, bank.tables['frame_ids'], bank.tables['rows'],
        window_size=model['LFB.WINDOW_SIZE'], window_mode='epic_verb',
        fps=model['EPIC.FPS'])


def batch_keys(model: dict, contract: dict, bank, rng: np.random.Generator,
               *, clips: int, crop: int, labels: bool
               ) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]:
    """(a batch's keys but its frames, the host's copy: 'video' and
    'center'): each clip's video uniform, its centre uniform over the
    video's frames, its verb uniform over the classes."""
    video = rng.integers(0, bank.videos, clips)
    center = (rng.random(clips) * bank.lengths[video]).astype(np.int64)
    keys = {'lfb_video_idx': video.astype(np.int32),
            'lfb_center': center.astype(np.int32)}
    if labels:
        keys['labels'] = rng.integers(0, model['MODEL.NUM_CLASSES'], clips)
    return keys, {'video': video, 'center': center}


def real(host: Dict[str, np.ndarray], clips: int, device) -> torch.Tensor:
    """A batch's real rows: every clip."""
    return torch.arange(clips, device=device)


def compared_logits(prob: torch.Tensor) -> torch.Tensor:
    """The train step's logits as the comparison reads them, from the
    'prob' the port's step returns: the log of its softmax, which is the
    logits' log-softmax."""
    return torch.log(prob.double())

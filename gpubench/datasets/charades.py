"""Charades (the LFB paper's ``lib/datasets/charades.py``): one label set
a clip, and a bank of a row every few frames of each video.

The bank's tables are those of the port's ``FrameDeviceBank``: a (video,
slot) table of frame ids (-1 past the video's rows) and one of row ids
(the zero row there); a window is the 'charades' one.  A batch names each
clip's video and centre frame (``lfb_video_idx`` / ``lfb_center``).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

PHASE_A_OUTPUT = 'pool5'


def tables(model: dict, count_model: dict, rng: np.random.Generator
           ) -> Tuple[Dict[str, np.ndarray], np.ndarray, int]:
    """(the tables, the frames of each video, the bank's rows) from the
    count model: 'videos' videos of 'rows' [lo, hi) rows each (video 0
    of 'video0_rows' where given), a row every 'row_every' frames from
    'first_frame'."""
    lo, hi = count_model['rows']
    rows = rng.integers(lo, hi, size=count_model['videos'])
    if 'video0_rows' in count_model:
        rows[0] = count_model['video0_rows']
    total = int(rows.sum())
    width = max(model['LFB.WINDOW_SIZE'], int(rows.max()))
    slot = np.arange(width)
    used = slot < rows[:, None]
    start = np.cumsum(rows) - rows
    frame_ids = np.where(used, count_model['first_frame']
                         + count_model['row_every'] * slot, -1)
    row_ids = np.where(used, start[:, None] + slot, total)
    lengths = count_model['first_frame'] + count_model['row_every'] * rows
    return {'frame_ids': frame_ids, 'rows': row_ids}, lengths, total


def port_bank(bank, model: dict):
    """The port's device bank over the same rows and tables."""
    from lfb_tpu_torch.bank.device_bank import FrameDeviceBank
    return FrameDeviceBank(
        bank.feats, bank.tables['frame_ids'], bank.tables['rows'],
        window_size=model['LFB.WINDOW_SIZE'], window_mode='charades',
        fps=model['CHARADES.FPS'],
        clips_per_second=model['CHARADES.LFB_CLIPS_PER_SECOND'])


def batch_keys(model: dict, contract: dict, bank, rng: np.random.Generator,
               *, clips: int, crop: int, labels: bool
               ) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]:
    """(a batch's keys but its frames, the host's copy: 'video' and
    'center'): each clip's video uniform, its centre uniform over the
    video's frames, each (clip, class) positive with probability
    ``contract['label_rate']``."""
    video = rng.integers(0, bank.videos, clips)
    center = (rng.random(clips) * bank.lengths[video]).astype(np.int64)
    keys = {'lfb_video_idx': video.astype(np.int32),
            'lfb_center': center.astype(np.int32)}
    if labels:
        keys['labels'] = (rng.random((clips, model['MODEL.NUM_CLASSES']))
                          < contract['label_rate']).astype(np.float32)
    return keys, {'video': video, 'center': center}


def real(host: Dict[str, np.ndarray], clips: int, device) -> torch.Tensor:
    """A batch's real rows: every clip."""
    return torch.arange(clips, device=device)


def compared_logits(prob: torch.Tensor) -> torch.Tensor:
    """The train step's logits as the comparison reads them, from the
    'prob' the port's step returns: the inverse of its sigmoid."""
    return torch.logit(prob.double())

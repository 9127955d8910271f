"""EPIC-Kitchens nouns (the LFB paper's ``lib/datasets/epic.py``): one noun
a clip, and a bank of object-detector features, up to
EPIC.MAX_NUM_FEATS_PER_NOUN_LFB_FRAME boxes at each detector frame.

The bank's tables are those the port's ``FrameDeviceBank.build_noun``
builds from a detector bank: each frame's boxes are consecutive entries
of its video's row that share the frame's id, in frame order, empty
frames skipped; a (video, slot) table of frame ids (-1 past the video's
entries) and one of row ids (the zero row there), at least
LFB.WINDOW_SIZE columns wide.  A window is the 'epic_noun' one.  A batch
names each clip's video by its id and its centre frame, as the verb
cell's do.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from gpubench.datasets.epic_verb import (PHASE_A_OUTPUT, batch_keys,
                                         compared_logits, real)

__all__ = ['tables', 'port_bank', 'batch_keys', 'real', 'PHASE_A_OUTPUT',
           'compared_logits']


def tables(model: dict, count_model: dict, rng: np.random.Generator
           ) -> Tuple[Dict[str, np.ndarray], np.ndarray, int]:
    """(the tables, the frames of each video, the bank's rows) from the
    count model: 'videos' videos of 'frames' [lo, hi] frames each, drawn
    uniform, scaled to 'hours' in all at EPIC.FPS and clipped to [lo, hi]
    (the verb cell's draw); a detector frame every 'row_every' frames from
    'first_frame', with min(K, Poisson('boxes_mean')) boxes at each, K the
    configuration's EPIC.MAX_NUM_FEATS_PER_NOUN_LFB_FRAME."""
    lo, hi = count_model['frames']
    frames = rng.integers(lo, hi + 1, size=count_model['videos'])
    total_frames = count_model['hours'] * 3600 * model['EPIC.FPS']
    frames = np.clip(np.round(frames * (total_frames / frames.sum())),
                     lo, hi).astype(np.int64)
    first, every = count_model['first_frame'], count_model['row_every']
    detector = (frames - first) // every + 1         # detector frames a video
    cap = model['EPIC.MAX_NUM_FEATS_PER_NOUN_LFB_FRAME']
    boxes = np.minimum(rng.poisson(count_model['boxes_mean'],
                                   size=int(detector.sum())), cap)
    # Each detector frame's video and frame id, then one entry a box.
    video_of = np.repeat(np.arange(frames.size), detector)
    frame_start = np.cumsum(detector) - detector
    frame_of = first + every * (np.arange(video_of.size)
                                - frame_start[video_of])
    entry_video = np.repeat(video_of, boxes)
    entry_frame = np.repeat(frame_of, boxes)
    per_video = np.bincount(entry_video, minlength=frames.size)
    total = int(per_video.sum())
    start = np.cumsum(per_video) - per_video
    slot = np.arange(total) - start[entry_video]
    width = max(model['LFB.WINDOW_SIZE'], int(per_video.max()))
    frame_ids = np.full((frames.size, width), -1, np.int64)
    row_ids = np.full((frames.size, width), total, np.int64)
    frame_ids[entry_video, slot] = entry_frame
    row_ids[entry_video, slot] = np.arange(total)
    return {'frame_ids': frame_ids, 'rows': row_ids}, frames, total


def port_bank(bank, model: dict):
    """The port's device bank over the same rows and tables."""
    from lfb_tpu_torch.bank.device_bank import FrameDeviceBank
    return FrameDeviceBank(
        bank.feats, bank.tables['frame_ids'], bank.tables['rows'],
        window_size=model['LFB.WINDOW_SIZE'], window_mode='epic_noun',
        max_per_frame=model['EPIC.MAX_NUM_FEATS_PER_NOUN_LFB_FRAME'],
        frames_per_second=model['EPIC.NOUN_LFB_FRAMES_PER_SECOND'],
        fps=model['EPIC.FPS'])

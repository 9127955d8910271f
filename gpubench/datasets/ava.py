"""AVA (the LFB paper's ``lib/datasets/ava.py``): boxes on keyframes, and
a bank of up to K rows for each (video, second) of seconds 902-1798.

The bank's tables are those of the port's ``AvaDeviceBank``: a (video,
second, slot) table of row ids, the rows in (video, second) order, empty
slots naming the zero row, and a (video, second) count.  A batch follows
the port's data-layer contract (``data/ava.py``): clip b owns box rows
[b * MAX_BOXES_PER_CLIP, (b + 1) * MAX_BOXES_PER_CLIP), its real boxes
first, then zero rows with ``box_mask`` 0.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

NUM_SECS = 897
SEC_BASE = 902

PHASE_A_OUTPUT = 'box_pooled'


def tables(model: dict, count_model: dict, rng: np.random.Generator
           ) -> Tuple[Dict[str, np.ndarray], np.ndarray, int]:
    """(the tables, the frames of each video (none here), the bank's
    rows) from the count model: Poisson('rows_per_second') rows a
    second, clipped at 'max_rows_per_second', in 'videos' videos."""
    counts = rng.poisson(count_model['rows_per_second'], size=(
        count_model['videos'], NUM_SECS)).clip(
        0, count_model['max_rows_per_second'])
    total = int(counts.sum())
    k_store = max(model['AVA.LFB_MAX_NUM_FEAT_PER_STEP'], int(counts.max()))
    start = np.cumsum(counts.reshape(-1)).reshape(counts.shape) - counts
    slot = np.arange(k_store)
    table = np.where(slot < counts[..., None], start[..., None] + slot,
                     total)
    return {'table': table, 'counts': counts}, np.zeros(0), total


def port_bank(bank, model: dict):
    """The port's device bank over the same rows and tables."""
    from lfb_tpu_torch.bank.device_bank import AvaDeviceBank
    return AvaDeviceBank(bank.feats, bank.tables['table'],
                         bank.tables['counts'],
                         window_size=model['LFB.WINDOW_SIZE'],
                         k=model['AVA.LFB_MAX_NUM_FEAT_PER_STEP'])


def batch_keys(model: dict, contract: dict, bank, rng: np.random.Generator,
               *, clips: int, crop: int, labels: bool
               ) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]:
    """(a batch's keys but its frames, the host's copy: 'rois', 'meta'
    and the 'real' rows): ``contract['boxes_per_clip']`` boxes a clip,
    corners uniform in the crop's halves, each (box, class) positive with
    probability ``contract['label_rate']``."""
    slots = model['TPU.MAX_BOXES_PER_CLIP']
    boxes = contract['boxes_per_clip']
    rows = clips * slots
    rois = np.zeros((rows, 5), np.float32)
    meta = np.zeros((rows, 4), np.float32)
    mask = np.zeros(rows, np.float32)
    real = (np.arange(clips)[:, None] * slots
            + np.arange(boxes)[None, :]).reshape(-1)
    video = rng.integers(0, bank.videos, clips)
    sec = rng.integers(SEC_BASE, SEC_BASE + NUM_SECS, clips)
    corners = np.concatenate(
        [rng.uniform(0, crop / 2, (real.size, 2)),
         rng.uniform(crop / 2, crop, (real.size, 2))], axis=1)
    rois[real, 0] = real // slots
    rois[real, 1:] = corners
    meta[real] = np.stack([video[real // slots], sec[real // slots],
                           np.full(real.size, 400), np.full(real.size,
                                                            600)], 1)
    mask[real] = 1.0
    keys = {'proposals': rois, 'metadata': meta, 'box_mask': mask}
    if labels:
        y = np.zeros((rows, model['MODEL.NUM_CLASSES']), np.float32)
        y[real] = rng.random((real.size, model['MODEL.NUM_CLASSES'])) < \
            contract['label_rate']
        keys['labels'] = y
    return keys, {'rois': rois, 'meta': meta, 'real': real}


def real(host: Dict[str, np.ndarray], clips: int, device) -> torch.Tensor:
    """A batch's real rows: its boxes."""
    return torch.from_numpy(host['real']).to(device)


def compared_logits(prob: torch.Tensor) -> torch.Tensor:
    """The train step's logits as the comparison reads them, from the
    'prob' the port's step returns: the inverse of its sigmoid."""
    return torch.logit(prob.double())

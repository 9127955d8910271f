"""The one batch generator: every batch of every cell, from the
configuration's batch contract, the traffic mix's split and the seed.

A batch follows the port's data-layer contract (``data/ava.py``: clip b
owns box rows [b * MAX_BOXES_PER_CLIP, (b + 1) * MAX_BOXES_PER_CLIP), its
real boxes first, then zero rows with ``box_mask`` 0; the clip datasets'
``lfb_video_idx`` / ``lfb_center``).  Frames are uniform uint8 drawn on
the device; boxes, keys and labels are drawn on the host (a few thousand
numbers).  Batch ``index`` of a seed is the same wherever it is made.

Frames are not white noise: each clip is a coarse random scene (a uniform
random grid of 1/8 the frames, 1/16 the height and width, stretched
trilinearly) with uniform noise over it, so clips, and the boxes within
a clip, see different content, as a camera's would.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from gpubench import seeds
from gpubench.bank import AVA_NUM_SECS, AVA_SEC_BASE, BankData


def frames_of(clips: int, frames: int, crop: int, g: torch.Generator,
              device) -> torch.Tensor:
    """(clips, frames, crop, crop, 3) uint8, a clip at a time."""
    out = torch.empty((clips, frames, crop, crop, 3), dtype=torch.uint8,
                      device=device)
    coarse = (max(1, frames // 8), max(1, crop // 16), max(1, crop // 16))
    for c in range(clips):
        scene = torch.rand((1, 3) + coarse, generator=g, device=device)
        scene = torch.nn.functional.interpolate(
            scene, size=(frames, crop, crop), mode='trilinear',
            align_corners=False)[0].permute(1, 2, 3, 0)
        noise = torch.rand(scene.shape, generator=g, device=device)
        out[c] = (scene * 192.0 + noise * 64.0).to(torch.uint8)
    return out


def make_batch(config: dict, split: str, bank: BankData, seed: int,
               index: int, device, *, labels: bool
               ) -> Tuple[Dict[str, torch.Tensor], Dict[str, np.ndarray]]:
    """(the step's batch on ``device``, the host's copy of its keys:
    'rois', 'meta' and the 'real' rows for AVA, 'video' and 'center' for
    clips)."""
    model, contract = config['model'], config['batch']
    key = 'TRAIN' if split == 'train' else 'TEST'
    clips = model[key + '.BATCH_SIZE']
    crop, frames = model[key + '.CROP_SIZE'], model[key + '.VIDEO_LENGTH']
    classes = model['MODEL.NUM_CLASSES']
    rng = seeds.rng(seed, 'batch', index)
    g = torch.Generator(device=device).manual_seed(
        seeds.derive(seed, 'frames', index))
    batch = {'data': frames_of(clips, frames, crop, g, device)}
    host: Dict[str, np.ndarray] = {}

    def put(name, array):
        batch[name] = torch.from_numpy(np.ascontiguousarray(array)).to(device)

    if model['DATASET'] == 'ava':
        slots = model['TPU.MAX_BOXES_PER_CLIP']
        boxes = contract['boxes_per_clip']
        rows = clips * slots
        rois = np.zeros((rows, 5), np.float32)
        meta = np.zeros((rows, 4), np.float32)
        mask = np.zeros(rows, np.float32)
        real = (np.arange(clips)[:, None] * slots
                + np.arange(boxes)[None, :]).reshape(-1)
        video = rng.integers(0, bank.videos, clips)
        sec = rng.integers(AVA_SEC_BASE, AVA_SEC_BASE + AVA_NUM_SECS, clips)
        corners = np.concatenate(
            [rng.uniform(0, crop / 2, (real.size, 2)),
             rng.uniform(crop / 2, crop, (real.size, 2))], axis=1)
        rois[real, 0] = real // slots
        rois[real, 1:] = corners
        meta[real] = np.stack([video[real // slots], sec[real // slots],
                               np.full(real.size, 400), np.full(real.size,
                                                                600)], 1)
        mask[real] = 1.0
        put('proposals', rois)
        put('metadata', meta)
        put('box_mask', mask)
        host.update(rois=rois, meta=meta, real=real)
        if labels:
            y = np.zeros((rows, classes), np.float32)
            y[real] = rng.random((real.size, classes)) < contract['label_rate']
            put('labels', y)
    else:
        video = rng.integers(0, bank.videos, clips)
        center = (rng.random(clips) * bank.lengths[video]).astype(np.int64)
        put('lfb_video_idx', video.astype(np.int32))
        put('lfb_center', center.astype(np.int32))
        host.update(video=video, center=center)
        if labels:
            put('labels', (rng.random((clips, classes))
                           < contract['label_rate']).astype(np.float32))
    return batch, host

"""The one batch generator: every batch of every cell, from the
configuration's batch contract, the traffic mix's split and the seed.

A batch follows the port's data-layer contract: the frames, shared by
every dataset, and the keys and labels of the configuration's dataset
(``datasets/<dataset>.py``).  Frames are uniform uint8 drawn on the
device; boxes, keys and labels are drawn on the host (a few thousand
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
from gpubench.bank import BankData


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


def make_batch(dataset, config: dict, split: str, bank: BankData, seed: int,
               index: int, device, *, labels: bool
               ) -> Tuple[Dict[str, torch.Tensor], Dict[str, np.ndarray]]:
    """(the step's batch on ``device``, the host's copy of its keys, as
    ``dataset``'s ``batch_keys`` (a module of ``datasets/``) gives
    them)."""
    model, contract = config['model'], config['batch']
    key = 'TRAIN' if split == 'train' else 'TEST'
    clips = model[key + '.BATCH_SIZE']
    crop, frames = model[key + '.CROP_SIZE'], model[key + '.VIDEO_LENGTH']
    rng = seeds.rng(seed, 'batch', index)
    g = torch.Generator(device=device).manual_seed(
        seeds.derive(seed, 'frames', index))
    batch = {'data': frames_of(clips, frames, crop, g, device)}
    keys, host = dataset.batch_keys(model, contract, bank, rng, clips=clips,
                                    crop=crop, labels=labels)
    for name, array in keys.items():
        batch[name] = torch.from_numpy(np.ascontiguousarray(array)).to(device)
    return batch, host

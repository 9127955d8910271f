"""Long-term feature bank construction (port of ``lfb_tpu/bank/lfb.py``;
reference ``tools/lfb_loader.py``).

:func:`extract_ava_bank` and :func:`extract_frame_bank` are the sweep loop
of ``get_lfb`` (``lfb_tpu/bank/lfb.py:153-177``): the bank-extraction
(lfb_infer_only) forward over a sequence of batches, collected into the
reference-format host bank, ``{video_idx: {sec: [2048-d feats]}}`` for AVA
and ``{video: {frame: 2048-d feat}}`` for Charades and EPIC.  Bank pickles
(:func:`load_lfb`, :func:`write_lfb`) are the reference's format, so banks
interchange with ``lfb_tpu`` and the reference.  The ``DataLoader`` wiring
of ``get_lfb`` is not ported.
"""

from __future__ import annotations

import logging
import os
from typing import Dict, Iterable, List, Mapping, Sequence

import numpy as np
import torch

from lfb_tpu_torch.models.spec import ModelSpec
from lfb_tpu_torch.train import checkpoints
from lfb_tpu_torch.train.steps import make_eval_step

logger = logging.getLogger(__name__)


def construct_ava_lfb(features: List[np.ndarray],
                      metadata: List[np.ndarray],
                      masks: List[np.ndarray]) -> Dict[int, Dict[int, list]]:
    """{video_idx: {sec: [2048-d feats]}} (reference ``lfb_loader.py:81-112``).
    ``masks`` excludes the fixed-shape padding rows the reference never has."""
    lfb: Dict[int, Dict[int, list]] = {}
    total_sec = num_boxes = 0
    for feats, meta, mask in zip(features, metadata, masks):
        for i in range(feats.shape[0]):
            if mask[i] == 0:
                continue
            video_id = int(np.round(meta[i, 0]))
            sec = int(np.round(meta[i, 1]))
            video = lfb.setdefault(video_id, {})
            if sec not in video:
                video[sec] = []
                total_sec += 1
            video[sec].append(np.squeeze(feats[i]))
            num_boxes += 1
    logger.info('AVA LFB: %d secs, %d boxes in %d videos',
                total_sec, num_boxes, len(lfb))
    return lfb


def construct_frame_level_lfb(features: List[np.ndarray],
                              clip_metadata: Sequence,
                              dataset: str) -> Dict:
    """{video: {frame: feat}} for EPIC (keyed by video name; ``clip_metadata``
    rows (_, video, frame, ...)) and Charades (keyed by video idx; rows
    (video_idx, frame)).  ``clip_metadata`` is the sweep's clip list, so the
    padded duplicates after its end are dropped (reference
    ``lfb_loader.py:51-78``)."""
    lfb: Dict = {}
    global_idx = 0
    for feats in features:
        for i in range(feats.shape[0]):
            if global_idx >= len(clip_metadata):
                break
            if dataset == 'epic':
                _, video_id, frame_id = clip_metadata[global_idx][:3]
            else:
                video_id, frame_id = clip_metadata[global_idx]
            global_idx += 1
            lfb.setdefault(video_id, {})[frame_id] = np.squeeze(feats[i])
    logger.info('Frame-level LFB: %d frames in %d videos', global_idx,
                len(lfb))
    return lfb


def load_lfb(cfg, is_train: bool) -> Dict:
    """The pickled bank of one split from ``LFB.LOAD_LFB_PATH``."""
    path = os.path.join(cfg.LFB.LOAD_LFB_PATH,
                        'train_lfb.pkl' if is_train else 'val_lfb.pkl')
    logger.info('Loading LFB from %s', path)
    return checkpoints.read_pkl(path)


def write_lfb(cfg, lfb: Dict, is_train: bool) -> str:
    """Pickle ``lfb`` into ``CHECKPOINT.DIR`` (protocol 2, as the
    reference); returns the path."""
    path = os.path.join(cfg.CHECKPOINT.DIR,
                        'train_lfb.pkl' if is_train else 'val_lfb.pkl')
    checkpoints.write_pkl(path, lfb)
    logger.info('Inferred LFB saved as %s', path)
    return path


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def extract_ava_bank(spec: ModelSpec, params: Mapping[str, torch.Tensor],
                     batches: Iterable[Mapping]) -> Dict[int, Dict[int, list]]:
    """Sweep the bank-extraction forward over ``batches`` (each with 'data',
    'proposals', 'metadata' and 'box_mask') and build the host bank."""
    if not (spec.lfb_infer_only and spec.head_type == 'roi'):
        raise ValueError('extract_ava_bank needs the AVA lfb_infer_only spec')
    step = make_eval_step(spec)
    features, metadata, masks = [], [], []
    for batch in batches:
        out = step(params, batch)
        features.append(_host(out['box_pooled'].float()))
        metadata.append(_host(batch['metadata']))
        masks.append(_host(batch['box_mask']))
    return construct_ava_lfb(features, metadata, masks)


def extract_frame_bank(spec: ModelSpec, params: Mapping[str, torch.Tensor],
                       batches: Iterable[Mapping], clip_metadata: Sequence,
                       dataset: str) -> Dict:
    """Sweep the clip-level bank-extraction forward over ``batches`` (each
    with 'data') and build the frame-level host bank of ``dataset``
    ('charades' or 'epic') from ``clip_metadata``, the sweep's clip list in
    batch order (see :func:`construct_frame_level_lfb`)."""
    if not (spec.lfb_infer_only and spec.head_type == 'basic'):
        raise ValueError('extract_frame_bank needs a clip-level '
                         'lfb_infer_only spec')
    step = make_eval_step(spec)
    features = [_host(step(params, batch)['pool5'].float())
                for batch in batches]
    return construct_frame_level_lfb(features, clip_metadata, dataset)

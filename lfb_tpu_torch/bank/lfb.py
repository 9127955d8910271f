"""Long-term feature bank construction for AVA (port of the AVA part of
``lfb_tpu/bank/lfb.py``; reference ``tools/lfb_loader.py``).

:func:`extract_ava_bank` is the sweep loop of ``get_lfb``
(``lfb_tpu/bank/lfb.py:153-171``): the bank-extraction (lfb_infer_only)
forward over a sequence of batches, collected into the reference-format
host bank ``{video_idx: {sec: [2048-d feats]}}``.
"""

from __future__ import annotations

import logging
from typing import Dict, Iterable, List, Mapping

import numpy as np
import torch

from lfb_tpu_torch.models.spec import ModelSpec
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

"""Long-term feature bank construction (port of ``lfb_tpu/bank/lfb.py``;
reference ``tools/lfb_loader.py``).

:func:`get_lfb` loads a pickled bank or sweeps a whole split with the
bank-extraction (lfb_infer_only) model: the split's frames come from disk
through the data layer's ``DataLoader`` and ``DeviceFeed``, and
:func:`extract_ava_bank` / :func:`extract_frame_bank` run the forward over
those batches and collect the reference-format host bank,
``{video_idx: {sec: [2048-d feats]}}`` for AVA and ``{video: {frame: 2048-d
feat}}`` for Charades and EPIC.  Bank pickles (:func:`load_lfb`,
:func:`write_lfb`) are the reference's format, so banks interchange with
``lfb_tpu`` and the reference.
"""

from __future__ import annotations

import logging
import os
from typing import Dict, Iterable, List, Mapping, Optional, Sequence

import numpy as np
import torch

from lfb_tpu_torch.data.loader import DataLoader, DeviceFeed, get_input_db
from lfb_tpu_torch.models.model import init_params
from lfb_tpu_torch.models.spec import ModelSpec, build_spec
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


def get_lfb(cfg, params_file: str, is_train: bool, *, device='cuda',
            params: Optional[Mapping[str, torch.Tensor]] = None) -> Dict:
    """Build (or load) the bank of one split (``lfb_tpu/bank/lfb.py:100``).

    ``LFB.LOAD_LFB`` reads the split's pickle (:func:`load_lfb`).  Otherwise
    the bank-extraction model, ``params`` or its init with ``params_file``
    loaded into it, sweeps the split on ``device``: the lfb_infer_only
    dataset at the center crop, with the TRAIN lists when ``is_train``,
    batch by batch from the ``DataLoader`` through ``to_device``.  AVA's
    metadata and box masks stay on the host, from the numpy batches.  With
    ``LFB.WRITE_LFB`` the bank is pickled into ``CHECKPOINT.DIR``.
    """
    if cfg.LFB.LOAD_LFB:
        return load_lfb(cfg, is_train)
    device = torch.device(device)
    split = cfg.TEST.DATA_TYPE or 'val'
    spec = build_spec(cfg, split, lfb_infer_only=True)
    if params is None:
        assert params_file, 'LFB.MODEL_PARAMS_FILE is not specified.'
        logger.info('Inferring LFB from %s', params_file)
        init = init_params(spec, torch.Generator(device=device).manual_seed(
            cfg.RNG_SEED))
        params = checkpoints.load_params_into(params_file, init,
                                              device=device)[0]
    db = get_input_db(cfg, split, lfb_infer_only=True, shift=1,
                      get_train_lfb=is_train, device=device)
    loader = DataLoader(db, cfg.TEST.BATCH_SIZE,
                        num_workers=cfg.DATALOADER.NUM_WORKERS,
                        prefetch=cfg.DATALOADER.PREFETCH_BATCHES,
                        seed=cfg.RNG_SEED, is_train=False)
    feed = DeviceFeed(loader, device, 'LFB sweep ({})'.format(
        'train' if is_train else split))
    try:
        if cfg.DATASET == 'ava':
            lfb = extract_ava_bank(spec, params, (
                {**dev, 'metadata': host['metadata'],
                 'box_mask': host['box_mask']} for host, dev in feed))
        else:
            lfb = extract_frame_bank(
                spec, params, (dev for _, dev in feed),
                db.lfb_frames if cfg.DATASET == 'charades' else db.annotations,
                cfg.DATASET)
    finally:
        loader.shutdown()
    if cfg.LFB.WRITE_LFB:
        write_lfb(cfg, lfb, is_train)
    return lfb

"""AVA dataset: spatio-temporal action detection over person boxes (port
of ``lfb_tpu/data/ava.py``).

Reference: ``lib/datasets/ava.py`` + ``lib/datasets/ava_data_input.py``.
Differences from the reference are fixed-shape padding and explicit
RNG; sampling semantics (keyframes, detection thresholds, 64-frame windows,
LFB window sampling with zero padding) are preserved.

Batch blob contract (per local batch of B clips, Nmax = B * MAX_BOXES_PER_CLIP):
  data            (B, T, S, S, 3) uint8 RGB crops (TPU.DEVICE_NORMALIZE) or
                  float32 normalized RGB
  labels          (Nmax, 80) multi-hot
  proposals       (Nmax, 5)  [clip_idx, x1, y1, x2, y2] crop pixels
  original_boxes  (Nmax, 5)  [clip_idx, x1, y1, x2, y2] normalized [0,1]
  metadata        (Nmax, 4)  [video_idx, sec, orig_h, orig_w]
  box_mask        (Nmax,)    1.0 = real box
  lfb             (Nmax, WINDOW*K, 2048) when LFB enabled
"""

from __future__ import annotations

import logging
import os
from typing import Dict, List, Optional

import numpy as np

from lfb_tpu_torch.data import transforms
from lfb_tpu_torch.data.frame_lists import get_sequence, load_image_lists

logger = logging.getLogger(__name__)

AVA_VALID_FRAMES = range(902, 1799)
CENTER_CROP_INDEX = 1


def sec_to_frame(sec: int, fps: int) -> int:
    return (sec - 900) * fps


def load_boxes_and_labels(filenames, *, is_train: bool, detect_thresh: float,
                          full_eval: bool):
    """CSV rows: video, sec, x1, y1, x2, y2, label[, score]; boxes keyed by
    coordinates accumulate multi-labels (reference ``ava.py:54-103``)."""
    ret: Dict[str, Dict[int, Dict[str, list]]] = {}
    count = unique = 0
    for filename in filenames:
        with open(filename, 'r') as f:
            for line in f:
                row = line.strip().split(',')
                assert len(row) in (7, 8), row
                video_name, frame_sec = row[0], int(row[1])
                if not is_train and not full_eval and frame_sec % 4 != 0:
                    continue
                box_key = ','.join(row[2:6])
                box = [float(x) for x in row[2:6]]
                label = -1 if row[6] == '' else int(row[6])
                if len(row) == 8 and float(row[7]) < detect_thresh:
                    continue
                if video_name not in ret:
                    ret[video_name] = {sec: {} for sec in AVA_VALID_FRAMES}
                if box_key not in ret[video_name][frame_sec]:
                    ret[video_name][frame_sec][box_key] = [box, []]
                    unique += 1
                ret[video_name][frame_sec][box_key][1].append(label)
                if label != -1:
                    count += 1
    logger.info('AVA annotations: %d unique boxes, %d labels', unique, count)
    return {v: {sec: list(boxes.values()) for sec, boxes in secs.items()}
            for v, secs in ret.items()}


def sample_lfb_window(video_lfb: dict, sec: int, *, window_size: int, k: int,
                      lfb_dim: int, rng: np.random.Generator) -> np.ndarray:
    """(window*k, lfb_dim) zero-padded window; <=k random feats per second
    (reference ``ava.py:300-323`` -- zeros intentionally remain in the
    window and participate in FBO softmax)."""
    lower = sec - (window_size // 2)
    out = np.zeros((window_size * k, lfb_dim), np.float32)
    for j, si in enumerate(range(lower, lower + window_size)):
        feats = video_lfb.get(si)
        if feats:
            n_used = min(len(feats), k)
            for slot, idx in enumerate(
                    rng.choice(len(feats), n_used, replace=False)):
                out[j * k + slot] = feats[idx]
    return out


class AvaDataset:
    blob_names = ('data', 'labels', 'proposals', 'original_boxes',
                  'metadata', 'box_mask', 'lfb')

    def __init__(self, cfg, split: str, lfb_infer_only: bool = False,
                 shift: Optional[int] = None, lfb=None,
                 get_train_lfb: bool = False, device='cuda'):
        self.cfg = cfg
        self.split = split
        self.lfb_infer_only = lfb_infer_only
        self.shift = shift
        self.is_train_aug = split == 'train' and not lfb_infer_only

        if lfb_infer_only:
            self.lfb_enabled = False
            full_eval = True
            detect_thresh = cfg.AVA.LFB_DETECTION_SCORE_THRESH
        else:
            self.lfb_enabled = cfg.LFB.ENABLED
            # Phase-specific settings the reference injects by mutating the
            # global config (``train_net.py:107-108``, ``test_net.py:58``):
            if split == 'train':
                full_eval = cfg.AVA.FULL_EVAL_DURING_TRAINING
                detect_thresh = cfg.AVA.DETECTION_SCORE_THRESH_TRAIN
            else:
                full_eval = getattr_or(cfg.AVA, 'FULL_EVAL', True)
                detect_thresh = getattr_or(
                    cfg.AVA, 'DETECTION_SCORE_THRESH',
                    cfg.AVA.DETECTION_SCORE_THRESH_EVAL[0])
        self.full_eval = full_eval
        self.detect_thresh = detect_thresh

        list_dir = cfg.AVA.FRAME_LIST_DIR
        use_train_lists = split == 'train' or get_train_lfb
        list_files = [os.path.join(list_dir, f) for f in
                      (cfg.AVA.TRAIN_LISTS if use_train_lists
                       else cfg.AVA.TEST_LISTS)]
        (self.image_paths, _, self.video_idx_to_name,
         self.video_name_to_idx) = load_image_lists(list_files, cfg.DATADIR)

        ann_dir = cfg.AVA.ANNOTATION_DIR
        if lfb_infer_only:
            ann_files = (cfg.AVA.TRAIN_LFB_BOX_LISTS if get_train_lfb
                         else cfg.AVA.TEST_LFB_BOX_LISTS)
        else:
            ann_files = (cfg.AVA.TRAIN_BOX_LISTS if split == 'train'
                         else cfg.AVA.TEST_BOX_LISTS)
        boxes = load_boxes_and_labels(
            [os.path.join(ann_dir, f) for f in ann_files],
            is_train=split == 'train', detect_thresh=detect_thresh,
            full_eval=full_eval)
        assert len(boxes) == len(self.image_paths), \
            (len(boxes), len(self.image_paths))
        self.boxes_and_labels = [boxes[self.video_idx_to_name[i]]
                                 for i in range(len(self.image_paths))]

        self.keyframe_indices = [
            (vi, sec, sec_to_frame(sec, cfg.AVA.FPS))
            for vi in range(len(self.boxes_and_labels))
            for sec in self.boxes_and_labels[vi]
            if sec in AVA_VALID_FRAMES and self.boxes_and_labels[vi][sec]]
        # Count what the fixed-shape batches actually emit (keyframes over
        # the MAX_BOXES_PER_CLIP cap are truncated in minibatch()), so the
        # metric trim in eval/metrics.get_ava_eval_arrays stays aligned.
        self.num_boxes_used = sum(
            min(len(self.boxes_and_labels[vi][sec]), cfg.TPU.MAX_BOXES_PER_CLIP)
            for vi, sec, _ in self.keyframe_indices)

        if split == 'train':
            self.sample_rate = cfg.TRAIN.SAMPLE_RATE
            self.video_length = cfg.TRAIN.VIDEO_LENGTH
        else:
            self.sample_rate = cfg.TEST.SAMPLE_RATE
            self.video_length = cfg.TEST.VIDEO_LENGTH
        self.seq_len = self.video_length * self.sample_rate
        self.crop_size = (cfg.TRAIN.CROP_SIZE if self.is_train_aug
                          else cfg.TEST.CROP_SIZE)

        if self.lfb_enabled:
            assert lfb is not None
            if (cfg.TPU.DEVICE_BANK and not hasattr(lfb, 'gather')):
                from lfb_tpu_torch.bank.device_bank import build_device_bank
                lfb = build_device_bank(cfg, lfb, device=device)
            self.lfb = lfb
            # A device bank gathers windows on-device from (video, sec)
            # already present in the metadata blob; no host windows needed.
            self.device_bank = hasattr(lfb, 'gather')
            n_bank = (lfb.num_videos() if self.device_bank else len(lfb))
            assert len(self.image_paths) == n_bank, \
                (len(self.image_paths), n_bank)
        else:
            self.device_bank = False
        logger.info('AVA %s: %d videos, %d keyframes, %d boxes',
                    split, len(self.image_paths), self.db_size(),
                    self.num_boxes_used)

    def db_size(self) -> int:
        return len(self.keyframe_indices)

    def minibatch(self, indices: List[int],
                  rng: np.random.Generator) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        half_len = self.seq_len // 2
        max_boxes = cfg.TPU.MAX_BOXES_PER_CLIP
        B = len(indices)
        S = self.crop_size
        shift = CENTER_CROP_INDEX if self.shift is None else self.shift

        out_u8 = cfg.TPU.DEVICE_NORMALIZE and not (
            self.is_train_aug and cfg.TRAIN.USE_COLOR_AUGMENTATION)
        data = np.zeros((B, self.video_length, S, S, 3),
                        np.uint8 if out_u8 else np.float32)
        n_max = B * max_boxes
        labels = np.zeros((n_max, cfg.MODEL.NUM_CLASSES), np.float32)
        proposals = np.zeros((n_max, 5), np.float32)
        original_boxes = np.zeros((n_max, 5), np.float32)
        metadata = np.zeros((n_max, 4), np.float32)
        box_mask = np.zeros((n_max,), np.float32)
        lfb_rows = (np.zeros((n_max, cfg.LFB.NUM_LFB_FEAT, cfg.LFB.LFB_DIM),
                             np.float32)
                    if self.lfb_enabled and not self.device_bank else None)

        # Box rows are CLIP-ALIGNED: clip b owns rows [b*max_boxes,
        # (b+1)*max_boxes), padding interleaved per clip rather than packed
        # at the tail, as in lfb_tpu, whose data-parallel step shards 'data'
        # by clip and the box blobs by row and needs device d's box rows to
        # reference device d's clips only.  Padding rows are zeros: they name
        # clip 0 and carry box_mask 0.  All consumers filter by box_mask, not
        # by contiguity (eval/metrics.py, models/model.py).
        for b, idx in enumerate(indices):
            row = b * max_boxes
            if self.split == 'train':
                idx = int(rng.integers(len(self.keyframe_indices)))
            video_idx, sec, center_idx = self.keyframe_indices[idx]
            seq = get_sequence(center_idx, half_len, self.sample_rate,
                               len(self.image_paths[video_idx]))
            clip = transforms.load_frames(
                [self.image_paths[video_idx][f] for f in seq],
                retry=cfg.IMG_LOAD_RETRY)
            height, width = clip.shape[1:3]

            box_label_list = self.boxes_and_labels[video_idx][sec]
            if len(box_label_list) > max_boxes:
                logger.warning('keyframe (%d, %d): %d boxes truncated to %d',
                               video_idx, sec, len(box_label_list), max_boxes)
                box_label_list = box_label_list[:max_boxes]
            boxes = np.array([bl[0] for bl in box_label_list], np.float32)

            clip, tboxes = transforms.preprocess_clip(
                clip, is_train=self.is_train_aug, crop_size=S, cfg=cfg,
                rng=rng, spatial_shift=shift, boxes=boxes,
                force_flip=cfg.AVA.FORCE_TEST_FLIP and not self.is_train_aug,
                output_uint8=out_u8)
            data[b] = clip

            window = None
            if self.lfb_enabled and not self.device_bank:
                window = sample_lfb_window(
                    self.lfb[video_idx], sec,
                    window_size=cfg.LFB.WINDOW_SIZE,
                    k=cfg.AVA.LFB_MAX_NUM_FEAT_PER_STEP,
                    lfb_dim=cfg.LFB.LFB_DIM, rng=rng)

            for box_idx, (box, box_labels) in enumerate(box_label_list):
                proposals[row, 0] = b
                proposals[row, 1:] = tboxes[box_idx]
                original_boxes[row, 0] = b
                original_boxes[row, 1:] = box
                metadata[row] = (video_idx, sec, height, width)
                for lbl in box_labels:
                    if lbl != -1:
                        assert 1 <= lbl <= 80, lbl
                        labels[row, lbl - 1] = 1.0
                box_mask[row] = 1.0
                if window is not None:
                    lfb_rows[row] = window
                row += 1

        batch = {'data': data, 'labels': labels, 'proposals': proposals,
                 'original_boxes': original_boxes, 'metadata': metadata,
                 'box_mask': box_mask}
        if lfb_rows is not None:
            batch['lfb'] = lfb_rows
        return batch


def getattr_or(section, key, default):
    return section[key] if key in section else default

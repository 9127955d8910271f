"""Charades dataset: multi-label video classification (port of
``lfb_tpu/data/charades.py``).

Reference: ``lib/datasets/charades.py`` + ``charades_data_input.py``.
Train samples one random clip center per video; test enumerates
videos x NUM_TEST_CLIPS (3 spatial shifts x N segments); labels are the
union of frame labels inside the clip span (video-level at test).
"""

from __future__ import annotations

import logging
import os
from typing import Dict, List, Optional

import numpy as np

from lfb_tpu_torch.data import transforms
from lfb_tpu_torch.data.frame_lists import get_sequence, load_image_lists

logger = logging.getLogger(__name__)

CENTER_CROP_INDEX = 1


def aggregate_labels(label_list) -> List[int]:
    out = set()
    for labels in label_list:
        out.update(labels)
    return sorted(out)


def sample_train_center(rng: np.random.Generator, num_frames: int,
                        seq_len: int) -> int:
    half_len = seq_len // 2
    if num_frames < seq_len:
        return num_frames // 2
    return int(rng.integers(half_len, num_frames - half_len + 1))


def segment_center(segment_id: int, num_frames: int,
                   num_segments: int) -> int:
    return int(np.round(float(num_frames) / num_segments * (segment_id + 0.5)))


def get_lfb_frames(image_paths, fps: int, clips_per_second: int):
    """(video_idx, frame) pairs every FPS/clips_per_second frames
    (reference ``charades.py:235-248``)."""
    freq = fps // clips_per_second
    return [(vi, i) for vi in range(len(image_paths))
            for i in range(len(image_paths[vi])) if (i + 1) % freq == 0]


def sample_lfb_window(video_lfb: dict, center_idx: int, *, window_size: int,
                      clips_per_second: int, fps: int,
                      lfb_dim: int) -> np.ndarray:
    """(window_size, lfb_dim) zero-padded window of bank features around the
    clip center (reference ``charades.py:251-276``)."""
    from lfb_tpu_torch.data.lfb_windows import fill_window
    secs = window_size // clips_per_second
    begin = int(np.round(center_idx - (float(secs) / 2.0 * fps)))
    out = fill_window(video_lfb, begin, begin + secs * fps,
                      window_size=window_size, lfb_dim=lfb_dim)
    if not out.any():
        logger.warning('No LFB features in window at frame %d', center_idx)
    return out


class CharadesDataset:
    blob_names = ('data', 'labels', 'lfb')

    def __init__(self, cfg, split: str, lfb_infer_only: bool = False,
                 shift: Optional[int] = None, lfb=None,
                 get_train_lfb: bool = False, device='cuda'):
        self.cfg = cfg
        self.split = split
        self.lfb_infer_only = lfb_infer_only
        self.shift = shift
        self.is_train_aug = split == 'train' and not lfb_infer_only
        self.lfb_enabled = cfg.LFB.ENABLED and not lfb_infer_only

        list_dir = cfg.CHARADES.FRAME_LIST_DIR
        use_train = split == 'train' or get_train_lfb
        list_files = [os.path.join(list_dir, f) for f in
                      (cfg.CHARADES.TRAIN_LISTS if use_train
                       else cfg.CHARADES.TEST_LISTS)]
        (self.image_paths, self.image_labels, self.video_idx_to_name,
         self.video_name_to_idx) = load_image_lists(list_files, cfg.DATADIR)

        if split != 'train':
            for vi in range(len(self.image_labels)):
                video_labels = aggregate_labels(self.image_labels[vi])
                self.image_labels[vi] = [video_labels] * len(self.image_labels[vi])
        self.num_videos = len(self.image_paths)

        # NUM_TEST_CLIPS is phase-injected by the reference
        # (``train_net.py:109``, ``test_net.py:91-92``).
        self.num_test_clips = (
            cfg.CHARADES['NUM_TEST_CLIPS'] if 'NUM_TEST_CLIPS' in cfg.CHARADES
            else cfg.CHARADES.NUM_TEST_CLIPS_DURING_TRAINING)
        self.num_test_segments = self.num_test_clips // 3

        if split == 'train':
            self.sample_rate = cfg.TRAIN.SAMPLE_RATE
            self.video_length = cfg.TRAIN.VIDEO_LENGTH
        else:
            self.sample_rate = cfg.TEST.SAMPLE_RATE
            self.video_length = cfg.TEST.VIDEO_LENGTH
        self.seq_len = self.video_length * self.sample_rate
        self.crop_size = (cfg.TRAIN.CROP_SIZE if self.is_train_aug
                          else cfg.TEST.CROP_SIZE)

        if lfb_infer_only:
            self.lfb_frames = get_lfb_frames(
                self.image_paths, cfg.CHARADES.FPS,
                cfg.CHARADES.LFB_CLIPS_PER_SECOND)
            logger.info('Charades LFB inference: %d clips in %d videos',
                        len(self.lfb_frames), self.num_videos)
        if self.lfb_enabled:
            assert lfb is not None
            if cfg.TPU.DEVICE_BANK and not hasattr(lfb, 'gather'):
                from lfb_tpu_torch.bank.device_bank import build_device_bank
                lfb = build_device_bank(cfg, lfb, device=device)
            self.lfb = lfb
            self.device_bank = hasattr(lfb, 'gather')
            n_bank = lfb.num_videos() if self.device_bank else len(lfb)
            assert len(self.image_paths) == n_bank
        else:
            self.device_bank = False
        logger.info('Charades %s: %d videos', split, self.num_videos)

    def db_size(self) -> int:
        if self.lfb_infer_only:
            return len(self.lfb_frames)
        if self.split == 'train':
            return self.num_videos
        return self.num_videos * self.num_test_clips

    def minibatch(self, indices: List[int],
                  rng: np.random.Generator) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        half_len = self.seq_len // 2
        B = len(indices)
        S = self.crop_size
        out_u8 = cfg.TPU.DEVICE_NORMALIZE and not (
            self.is_train_aug and cfg.TRAIN.USE_COLOR_AUGMENTATION)
        data = np.zeros((B, self.video_length, S, S, 3),
                        np.uint8 if out_u8 else np.float32)
        labels = np.zeros((B, cfg.MODEL.NUM_CLASSES), np.float32)
        lfb_rows = (np.zeros((B, cfg.LFB.WINDOW_SIZE, cfg.LFB.LFB_DIM),
                             np.float32)
                    if self.lfb_enabled and not self.device_bank else None)
        lfb_video_idx = (np.zeros((B,), np.int32)
                         if self.lfb_enabled and self.device_bank else None)
        lfb_center = (np.zeros((B,), np.int32)
                      if self.lfb_enabled and self.device_bank else None)

        for b, idx in enumerate(indices):
            if self.lfb_infer_only:
                video_idx, center_idx = self.lfb_frames[idx]
                shift = CENTER_CROP_INDEX
            else:
                video_idx = idx % self.num_videos
                num_frames = len(self.image_paths[video_idx])
                if self.split == 'train':
                    center_idx = sample_train_center(rng, num_frames,
                                                     self.seq_len)
                    shift = None
                else:
                    multi_clip_idx = idx // self.num_videos
                    shift = multi_clip_idx % 3
                    center_idx = segment_center(
                        multi_clip_idx // 3, num_frames,
                        self.num_test_segments)
            num_frames = len(self.image_paths[video_idx])
            seq = get_sequence(center_idx, half_len, self.sample_rate,
                               num_frames)
            clip = transforms.load_frames(
                [self.image_paths[video_idx][f] for f in seq],
                retry=cfg.IMG_LOAD_RETRY)
            clip, _ = transforms.preprocess_clip(
                clip, is_train=self.is_train_aug, crop_size=S, cfg=cfg,
                rng=rng,
                spatial_shift=(shift if shift is not None
                               else CENTER_CROP_INDEX),
                output_uint8=out_u8)
            data[b] = clip

            for lbl in aggregate_labels(
                    self.image_labels[video_idx][seq[0]:seq[-1] + 1]):
                labels[b, lbl] = 1.0

            if self.lfb_enabled:
                if self.device_bank:
                    lfb_video_idx[b] = video_idx
                    lfb_center[b] = center_idx
                else:
                    lfb_rows[b] = sample_lfb_window(
                        self.lfb[video_idx], center_idx,
                        window_size=cfg.LFB.WINDOW_SIZE,
                        clips_per_second=cfg.CHARADES.LFB_CLIPS_PER_SECOND,
                        fps=cfg.CHARADES.FPS, lfb_dim=cfg.LFB.LFB_DIM)

        batch = {'data': data, 'labels': labels}
        if lfb_rows is not None:
            batch['lfb'] = lfb_rows
        if lfb_video_idx is not None:
            batch['lfb_video_idx'] = lfb_video_idx
            batch['lfb_center'] = lfb_center
        return batch

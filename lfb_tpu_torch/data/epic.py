"""EPIC-Kitchens dataset: verb/noun clip classification over action segments
(port of ``lfb_tpu/data/epic.py``).

Reference: ``lib/datasets/epic.py`` + ``epic_data_input.py``.  Persons
P01-P25 are train, the rest val; a train clip centers on a random frame of
its action segment, test on the middle frame.  Verb LFB windows gather
clip-model features within +-WINDOW/2 seconds; noun LFB windows gather up to
10 detector features per frame until WINDOW rows are filled.
"""

from __future__ import annotations

import csv
import logging
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from lfb_tpu_torch.data import transforms
from lfb_tpu_torch.data.frame_lists import load_image_lists

logger = logging.getLogger(__name__)

CENTER_CROP_INDEX = 1
TRAIN_PERSON_INDICES = range(1, 26)
NUM_CLASSES_VERB = 125
NUM_CLASSES_NOUN = 352


def sec_to_frame(sec: float, fps: int) -> int:
    return int(np.round(float(sec) * fps))


def time_to_sec(timestamp: str) -> float:
    hour, minute, sec = timestamp.split(':')
    return 3600.0 * int(hour) + 60.0 * int(minute) + float(sec)


def filename_to_frame_id(img_path: str) -> int:
    return int(img_path[-10:-4])


def load_annotations(cfg, is_train: bool):
    """(person, video, start_frame, stop_frame, verb, noun) tuples from
    EPIC_train_action_labels.csv (reference ``epic.py:236-283``)."""
    annotations = []
    verb_set, noun_set = set(), set()
    filename = os.path.join(cfg.EPIC.ANNOTATION_DIR, cfg.EPIC.ANNOTATIONS)
    with open(filename, 'r', newline='') as f:
        f.readline()  # header
        for row in csv.reader(f):
            person = row[1]
            in_train = int(person[1:]) in TRAIN_PERSON_INDICES
            if is_train != in_train:
                continue
            video_name = row[2]
            start_frame = sec_to_frame(time_to_sec(row[4]), cfg.EPIC.FPS)
            stop_frame = sec_to_frame(time_to_sec(row[5]), cfg.EPIC.FPS)
            verb, noun = int(row[-5]), int(row[-3])
            assert 0 <= verb < NUM_CLASSES_VERB and 0 <= noun < NUM_CLASSES_NOUN
            annotations.append(
                (person, video_name, start_frame, stop_frame, verb, noun))
            verb_set.add(verb)
            noun_set.add(noun)
    logger.info('EPIC: %d annotations, %d verbs, %d nouns',
                len(annotations), len(verb_set), len(noun_set))
    expected = cfg.TRAIN.DATASET_SIZE if is_train else cfg.TEST.DATASET_SIZE
    if expected and len(annotations) != expected:
        logger.warning('EPIC annotation count %d != expected %d',
                       len(annotations), expected)
    return annotations


def get_segment_sequence(rng: Optional[np.random.Generator],
                         start_frame: int, stop_frame: int, half_len: int,
                         sample_rate: int, num_frames: int,
                         is_train: bool) -> Tuple[List[int], int]:
    center = (int(rng.integers(start_frame, stop_frame + 1)) if is_train
              else (stop_frame + start_frame) // 2)
    seq = [min(max(i, 0), num_frames - 1)
           for i in range(center - half_len, center + half_len, sample_rate)]
    return seq, center


def lfb_frame_annotations(image_paths: dict, fps: int,
                          clips_per_second: int):
    """Pseudo-annotations for the bank-construction sweep, one clip per
    ``fps // clips_per_second`` frames (reference ``epic.py:286-303``)."""
    freq = fps // clips_per_second
    anns = []
    for video_name, paths in image_paths.items():
        for img_path in paths:
            frame = filename_to_frame_id(img_path)
            if frame % freq == 0:
                anns.append((video_name[:3], video_name, frame, frame, 0, 0))
    return anns


def sample_verb_lfb(video_lfb: dict, center_idx: int, *, window_size: int,
                    fps: int, lfb_dim: int) -> np.ndarray:
    from lfb_tpu_torch.data.lfb_windows import fill_window
    half_len = (window_size * fps) // 2
    return fill_window(video_lfb, center_idx - half_len,
                       center_idx + half_len,
                       window_size=window_size, lfb_dim=lfb_dim)


def sample_noun_lfb(video_lfb: dict, center_idx: int, *, window_size: int,
                    max_per_frame: int, frames_per_second: int, fps: int,
                    lfb_dim: int) -> np.ndarray:
    secs = float(window_size) / (max_per_frame * frames_per_second)
    lower = int(center_idx - (secs / 2) * fps)
    upper = int(lower + secs * fps)
    chunks = []
    num_feat = 0
    for frame_idx in range(lower, upper + 1):
        feats = video_lfb.get(frame_idx)
        if feats is not None and not (isinstance(feats, list) and not feats):
            take = min(max_per_frame, feats.shape[0])
            chunks.append(np.asarray(feats)[:take])
            num_feat += take
            if num_feat >= window_size:
                break
    out = np.zeros((window_size, lfb_dim), np.float32)
    if chunks:
        stacked = np.vstack(chunks)[:window_size]
        out[:stacked.shape[0]] = stacked
    else:
        logger.warning('No noun LFB sampled (center_idx: %d)', center_idx)
    return out


class EpicDataset:
    blob_names = ('data', 'labels', 'lfb')

    def __init__(self, cfg, split: str, lfb_infer_only: bool = False,
                 shift: Optional[int] = None, lfb=None,
                 get_train_lfb: bool = False, device='cuda'):
        self.cfg = cfg
        self.split = split
        self.is_train = split == 'train'
        self.lfb_infer_only = lfb_infer_only
        self.shift = shift
        self.is_train_aug = self.is_train and not lfb_infer_only
        self.lfb_enabled = cfg.LFB.ENABLED and not lfb_infer_only

        list_dir = cfg.EPIC.FRAME_LIST_DIR
        use_train = self.is_train or get_train_lfb
        list_files = [os.path.join(list_dir, f) for f in
                      (cfg.EPIC.TRAIN_LISTS if use_train
                       else cfg.EPIC.TEST_LISTS)]
        (self.image_paths, self.image_labels, self.video_idx_to_name,
         self.video_name_to_idx) = load_image_lists(
            list_files, cfg.DATADIR, return_dict=True)

        if lfb_infer_only:
            self.annotations = lfb_frame_annotations(
                self.image_paths, cfg.EPIC.FPS,
                cfg.EPIC.VERB_LFB_CLIPS_PER_SECOND)
            logger.info('EPIC LFB inference: %d clips in %d videos',
                        len(self.annotations), len(self.image_paths))
        else:
            self.annotations = load_annotations(cfg, self.is_train)

        if self.is_train:
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
            if cfg.TPU.DEVICE_BANK and not hasattr(lfb, 'gather'):
                from lfb_tpu_torch.bank.device_bank import build_device_bank
                lfb = build_device_bank(cfg, lfb, self.video_name_to_idx,
                                        device=device)
            self.lfb = lfb
            self.device_bank = hasattr(lfb, 'gather')
            n_bank = lfb.num_videos() if self.device_bank else len(lfb)
            assert len(self.image_paths) == n_bank, \
                (len(self.image_paths), n_bank)
        else:
            self.device_bank = False

    def db_size(self) -> int:
        return len(self.annotations)

    def sample_lfb(self, video_name: str, center_idx: int) -> np.ndarray:
        cfg = self.cfg
        if cfg.EPIC.CLASS_TYPE == 'noun':
            return sample_noun_lfb(
                self.lfb[self.video_name_to_idx[video_name]], center_idx,
                window_size=cfg.LFB.WINDOW_SIZE,
                max_per_frame=cfg.EPIC.MAX_NUM_FEATS_PER_NOUN_LFB_FRAME,
                frames_per_second=cfg.EPIC.NOUN_LFB_FRAMES_PER_SECOND,
                fps=cfg.EPIC.FPS, lfb_dim=cfg.LFB.LFB_DIM)
        return sample_verb_lfb(
            self.lfb[video_name], center_idx,
            window_size=cfg.LFB.WINDOW_SIZE, fps=cfg.EPIC.FPS,
            lfb_dim=cfg.LFB.LFB_DIM)

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
        labels = np.zeros((B,), np.int32)
        lfb_rows = (np.zeros((B, cfg.LFB.WINDOW_SIZE, cfg.LFB.LFB_DIM),
                             np.float32)
                    if self.lfb_enabled and not self.device_bank else None)
        lfb_video_idx = (np.zeros((B,), np.int32)
                         if self.lfb_enabled and self.device_bank else None)
        lfb_center = (np.zeros((B,), np.int32)
                      if self.lfb_enabled and self.device_bank else None)
        shift = CENTER_CROP_INDEX if self.shift is None else self.shift

        for b, idx in enumerate(indices):
            if self.is_train:
                idx = int(rng.integers(len(self.annotations)))
            (person, video_name, start_frame, stop_frame, verb,
             noun) = self.annotations[idx]
            num_frames = len(self.image_paths[video_name])
            seq, center_idx = get_segment_sequence(
                rng, start_frame, stop_frame, half_len, self.sample_rate,
                num_frames, self.is_train)
            clip = transforms.load_frames(
                [self.image_paths[video_name][f] for f in seq],
                retry=cfg.IMG_LOAD_RETRY)
            clip, _ = transforms.preprocess_clip(
                clip, is_train=self.is_train_aug, crop_size=S, cfg=cfg,
                rng=rng, spatial_shift=shift, output_uint8=out_u8)
            data[b] = clip
            labels[b] = verb if cfg.EPIC.CLASS_TYPE == 'verb' else noun
            if self.lfb_enabled:
                if self.device_bank:
                    lfb_video_idx[b] = self.video_name_to_idx[video_name]
                    lfb_center[b] = center_idx
                else:
                    lfb_rows[b] = self.sample_lfb(video_name, center_idx)

        batch = {'data': data, 'labels': labels}
        if lfb_rows is not None:
            batch['lfb'] = lfb_rows
        if lfb_video_idx is not None:
            batch['lfb_video_idx'] = lfb_video_idx
            batch['lfb_center'] = lfb_center
        return batch

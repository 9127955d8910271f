"""Frame-list CSV parsing + clip frame-sequence sampling (port of
``lfb_tpu/data/frame_lists.py``; reference
``lib/datasets/dataset_helper.py``).  Frame lists are
space-separated with header: ``original_video_id video_id frame_id path
labels`` where labels is a comma-separated int list or '""'.
"""

from __future__ import annotations

import os
from collections import defaultdict
from typing import Dict, List, Sequence


def load_image_lists(list_filenames: Sequence[str], datadir: str,
                     return_dict: bool = False):
    """Returns (image_paths, labels, video_idx_to_name, video_name_to_idx);
    indexed by video idx (lists) or video name (dicts)."""
    image_paths = defaultdict(list)
    labels = defaultdict(list)
    video_name_to_idx: Dict[str, int] = {}
    video_idx_to_name: Dict[int, str] = {}

    for list_filename in list_filenames:
        with open(list_filename, 'r') as f:
            f.readline()  # header
            for line in f:
                row = line.split()
                assert len(row) == 5, row
                video_name = row[0]
                if video_name not in video_name_to_idx:
                    idx = len(video_name_to_idx)
                    video_name_to_idx[video_name] = idx
                    video_idx_to_name[idx] = video_name
                key = video_name if return_dict else video_name_to_idx[video_name]
                image_paths[key].append(os.path.join(datadir, row[3]))
                frame_labels = row[-1].replace('"', '')
                if frame_labels:
                    labels[key].append([int(x) for x in frame_labels.split(',')])
                else:
                    labels[key].append([])

    if return_dict:
        return (dict(image_paths), dict(labels),
                video_idx_to_name, video_name_to_idx)
    paths = [image_paths[i] for i in range(len(image_paths))]
    lbls = [labels[i] for i in range(len(labels))]
    return paths, lbls, video_idx_to_name, video_name_to_idx


def get_sequence(center_idx: int, half_len: int, sample_rate: int,
                 num_frames: int) -> List[int]:
    """Strided frame indices around a center, clamped to [0, num_frames)."""
    return [min(max(i, 0), num_frames - 1)
            for i in range(center_idx - half_len, center_idx + half_len,
                           sample_rate)]

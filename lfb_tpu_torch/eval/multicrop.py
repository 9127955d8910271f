"""AVA multi-crop testing: merge 2 flips x 3 scales x 3 spatial shifts
(port of ``lfb_tpu/eval/multicrop.py``).

Reference: ``lib/utils/metrics.py:599-724``.  Per (flip, scale): the three
spatial-shift score files are merged with crop-visibility logic -- a box's
prediction from a crop that does not overlap it is discarded -- averaging
sigmoids of the surviving logits; then the six (flip, scale) files are
summed into ``final_multi_crop_testing_results.csv``.
"""

from __future__ import annotations

import logging
import os
from typing import Callable, Dict, List

import numpy as np

from lfb_tpu_torch.eval.ava_eval import evaluate_ava_from_files

logger = logging.getLogger(__name__)


def sigmoid(x: float) -> float:
    return float(1.0 / (1.0 + np.exp(-x)))


def merge_3shift_files(shift_score_files: List[str], flip: bool, scale: int,
                       video_shape_fn: Callable[[str], tuple],
                       max_crop: int = 256) -> str:
    """Merge left/center/right shift detections with visibility gating.

    ``video_shape_fn(video_id) -> (height, width)`` supplies original frame
    sizes (the reference reads each video's first JPEG,
    ``metrics.py:649-653``).
    """
    out_filename = shift_score_files[0].replace('_shift0', '_combined')
    video_shapes: Dict[str, tuple] = {}
    fins = [open(f, 'r') for f in shift_score_files]
    with open(out_filename, 'w') as fout:
        for lines in zip(*fins):
            items = [ln.split(',') for ln in lines]
            scores = [float(it[-1]) for it in items]
            box = [float(v) for v in items[0][2:6]]
            video = items[0][0]
            assert all(it[0] == video for it in items)

            if video not in video_shapes:
                video_shapes[video] = video_shape_fn(video)
            height, width = video_shapes[video]
            height, width = scale, float(width * scale) / height
            norm_crop_size = float(min(height, max_crop)) / width

            center_left = 0.5 - norm_crop_size / 2.0
            center_right = 0.5 + norm_crop_size / 2.0
            lcrop_right = norm_crop_size
            rcrop_left = 1.0 - norm_crop_size

            if flip:
                box[0], box[2] = 1.0 - box[2], 1.0 - box[0]

            valid = []
            if box[2] > center_left and box[0] < center_right:
                valid.append(scores[1])
            if box[0] < lcrop_right:
                valid.append(scores[0])
            if box[2] > rcrop_left:
                valid.append(scores[2])
            combined = float(np.mean([sigmoid(s) for s in valid]))
            fout.write(','.join(items[0][:-1] + [str(combined)]) + '\n')
    for f in fins:
        f.close()
    return out_filename


def merge_score_files(score_files: List[str],
                      out_filename: str = 'final_multi_crop_testing_results.csv'
                      ) -> str:
    """Sum scores across the six (flip, scale) combined files."""
    all_lines = []
    for path in score_files:
        with open(path, 'r') as f:
            all_lines.append(f.readlines())
    with open(out_filename, 'w') as fout:
        for s_lines in zip(*all_lines):
            combined = float(np.sum([float(s.split(',')[-1])
                                     for s in s_lines]))
            fout.write(','.join(s_lines[0].split(',')[:-1]
                                + ['%f' % combined]) + '\n')
    return out_filename


def default_video_shape_fn(cfg):
    """Read each video's first frame for its size (reference behavior)."""
    import cv2

    def fn(video):
        path = os.path.join(cfg.DATADIR, video, video + '_000001.jpg')
        im = cv2.imread(path)
        assert im is not None, path
        return im.shape[0], im.shape[1]
    return fn


def combine_ava_multi_crops(cfg, output_dir: str = '.',
                            video_shape_fn=None) -> float:
    """Full multi-crop merge + final evaluation (reference
    ``metrics.py:599-616``).  Returns the final mAP."""
    if video_shape_fn is None:
        video_shape_fn = default_video_shape_fn(cfg)
    final_map = 0.0
    for threshold in cfg.AVA.DETECTION_SCORE_THRESH_EVAL:
        score_files = []
        for scale in cfg.AVA.TEST_MULTI_CROP_SCALES:
            for flip in (False, True):
                shift_files = [
                    os.path.join(output_dir,
                                 'detections_final_%d%s_shift%d_%.03f.csv' % (
                                     scale, '_flip' if flip else '', shift,
                                     threshold))
                    for shift in range(3)]
                combined = merge_3shift_files(
                    shift_files, flip, scale, video_shape_fn)
                _eval_file(cfg, combined)
                score_files.append(combined)
        final = merge_score_files(
            score_files,
            os.path.join(output_dir, 'final_multi_crop_testing_results.csv'))
        final_map = _eval_file(cfg, final)
    return final_map


def _eval_file(cfg, score_filename: str) -> float:
    ann = cfg.AVA.ANNOTATION_DIR
    metrics = evaluate_ava_from_files(
        os.path.join(ann, 'ava_action_list_v2.1_for_activitynet_2018.pbtxt'),
        os.path.join(ann, 'ava_val_v2.1.csv'),
        score_filename,
        os.path.join(ann, 'ava_val_excluded_timestamps_v2.1.csv'))
    return metrics['PascalBoxes_Precision/mAP@0.5IOU']

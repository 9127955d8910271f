"""AVA spatio-temporal action detection evaluation: Pascal mAP@0.5IoU (the
port's copy of ``lfb_tpu/eval/ava_eval.py``).

The reference drives a *vendored* copy of the ActivityNet/TF-object-detection
``PascalDetectionEvaluator`` (fetched at dataset-download time, SURVEY.md
§2.1) through ``lib/utils/ava_eval_helper.py``.  lfb_tpu implements the
evaluator natively (vectorized numpy): per-class corpus AP with greedy
score-ordered IoU-0.5 matching and the TF-style interpolated
precision-envelope AP integral.

File formats (CSV annotations, labelmap pbtxt, exclusion lists, detections
output) match the reference exactly.
"""

from __future__ import annotations

import csv
import logging
import time
from collections import defaultdict
from typing import Dict, List, Set

import numpy as np

logger = logging.getLogger(__name__)


def make_image_key(video_id, timestamp) -> str:
    return '%s,%04d' % (video_id, int(timestamp))


def read_csv(csv_file: str, class_whitelist=None, load_score: bool = False):
    """AVA-format CSV -> ({key: [[y1,x1,y2,x2]]}, {key: [label]}, {key: [score]})."""
    boxes = defaultdict(list)
    labels = defaultdict(list)
    scores = defaultdict(list)
    with open(csv_file, 'r') as f:
        for row in csv.reader(f):
            assert len(row) in (7, 8), row
            key = make_image_key(row[0], row[1])
            x1, y1, x2, y2 = (float(v) for v in row[2:6])
            action_id = int(row[6])
            if class_whitelist and action_id not in class_whitelist:
                continue
            boxes[key].append([y1, x1, y2, x2])
            labels[key].append(action_id)
            scores[key].append(float(row[7]) if load_score else 1.0)
    return boxes, labels, scores


def read_exclusions(exclusions_file: str) -> Set[str]:
    excluded = set()
    if exclusions_file:
        with open(exclusions_file, 'r') as f:
            for row in csv.reader(f):
                assert len(row) == 2, row
                excluded.add(make_image_key(row[0], row[1]))
    return excluded


def read_labelmap(labelmap_file: str):
    """Parse the pbtxt labelmap -> ([{'id', 'name'}], {ids})."""
    labelmap = []
    class_ids = set()
    name = ''
    with open(labelmap_file, 'r') as f:
        for line in f:
            if line.startswith('  name:'):
                name = line.split('"')[1]
            elif line.startswith('  id:') or line.startswith('  label_id:'):
                class_id = int(line.strip().split(' ')[-1])
                labelmap.append({'id': class_id, 'name': name})
                class_ids.add(class_id)
    return labelmap, class_ids


# --------------------------------------------------------------------------- #
# Pascal detection mAP (corpus AP, IoU >= 0.5)
# --------------------------------------------------------------------------- #

def _iou_matrix(det: np.ndarray, gt: np.ndarray) -> np.ndarray:
    """IoU between (N,4) and (M,4) [y1,x1,y2,x2] boxes (float areas)."""
    y1 = np.maximum(det[:, None, 0], gt[None, :, 0])
    x1 = np.maximum(det[:, None, 1], gt[None, :, 1])
    y2 = np.minimum(det[:, None, 2], gt[None, :, 2])
    x2 = np.minimum(det[:, None, 3], gt[None, :, 3])
    inter = np.clip(y2 - y1, 0, None) * np.clip(x2 - x1, 0, None)
    a_det = (det[:, 2] - det[:, 0]) * (det[:, 3] - det[:, 1])
    a_gt = (gt[:, 2] - gt[:, 0]) * (gt[:, 3] - gt[:, 1])
    union = a_det[:, None] + a_gt[None, :] - inter
    return np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0)


def compute_average_precision(precision: np.ndarray,
                              recall: np.ndarray) -> float:
    """TF-OD-API-style AP: monotone precision envelope integrated over
    recall steps."""
    if precision.size == 0:
        return 0.0
    recall = np.concatenate([[0.0], recall, [1.0]])
    precision = np.concatenate([[0.0], precision, [0.0]])
    for i in range(len(precision) - 2, -1, -1):
        precision[i] = max(precision[i], precision[i + 1])
    idx = np.where(recall[1:] != recall[:-1])[0] + 1
    return float(np.sum((recall[idx] - recall[idx - 1]) * precision[idx]))


def pascal_map(groundtruth, detections, excluded_keys: Set[str],
               categories) -> Dict[str, float]:
    """Corpus mAP@0.5 over categories; returns the reference's metric dict
    shape with 'PascalBoxes_Precision/mAP@0.5IOU'."""
    gt_boxes, gt_labels, _ = groundtruth
    dt_boxes, dt_labels, dt_scores = detections
    iou_thresh = 0.5

    class_aps = {}
    per_class_scores: Dict[int, List[float]] = defaultdict(list)
    per_class_tp: Dict[int, List[int]] = defaultdict(list)
    per_class_num_gt: Dict[int, int] = defaultdict(int)

    for key, labels in gt_labels.items():
        if key in excluded_keys:
            continue
        for lbl in labels:
            per_class_num_gt[lbl] += 1

    for key in dt_boxes:
        if key in excluded_keys:
            continue
        d_boxes = np.asarray(dt_boxes[key], np.float64)
        d_labels = np.asarray(dt_labels[key])
        d_scores = np.asarray(dt_scores[key], np.float64)
        g_boxes = (np.asarray(gt_boxes.get(key, []), np.float64)
                   if key in gt_boxes else np.zeros((0, 4)))
        g_labels = (np.asarray(gt_labels.get(key, []))
                    if key in gt_labels else np.zeros((0,), np.int64))

        for cls in np.unique(d_labels):
            sel = d_labels == cls
            boxes_c = d_boxes[sel]
            scores_c = d_scores[sel]
            gsel = g_labels == cls
            gt_c = g_boxes[gsel] if g_boxes.size else np.zeros((0, 4))
            order = np.argsort(-scores_c)
            matched = np.zeros(len(gt_c), bool)
            for di in order:
                tp = 0
                if len(gt_c):
                    ious = _iou_matrix(boxes_c[di:di + 1], gt_c)[0]
                    best = int(np.argmax(ious))
                    if ious[best] >= iou_thresh and not matched[best]:
                        matched[best] = True
                        tp = 1
                per_class_scores[int(cls)].append(float(scores_c[di]))
                per_class_tp[int(cls)].append(tp)

    aps = []
    metrics = {}
    for cat in categories:
        cls = cat['id']
        num_gt = per_class_num_gt.get(cls, 0)
        if num_gt == 0:
            continue
        scores = np.asarray(per_class_scores.get(cls, []), np.float64)
        tp = np.asarray(per_class_tp.get(cls, []), np.float64)
        order = np.argsort(-scores)
        tp = tp[order]
        cum_tp = np.cumsum(tp)
        recall = cum_tp / num_gt
        precision = cum_tp / np.arange(1, len(tp) + 1)
        ap = compute_average_precision(precision, recall)
        aps.append(ap)
        metrics['PascalBoxes_PerformanceByCategory/AP@0.5IOU/{}'.format(
            cat['name'])] = ap
    metrics['PascalBoxes_Precision/mAP@0.5IOU'] = (
        float(np.mean(aps)) if aps else 0.0)
    return metrics


def run_evaluation(categories, groundtruth, detections, excluded_keys):
    metrics = pascal_map(groundtruth, detections, excluded_keys, categories)
    logger.info('mAP@0.5IOU: %.5f',
                metrics['PascalBoxes_Precision/mAP@0.5IOU'])
    return metrics


# --------------------------------------------------------------------------- #
# Array -> official-format conversion (reference ``ava_eval_helper.py:208-254``)
# --------------------------------------------------------------------------- #

def get_ava_eval_data(scores, boxes, metadata, class_whitelist,
                      video_idx_to_name):
    out_scores = defaultdict(list)
    out_labels = defaultdict(list)
    out_boxes = defaultdict(list)
    for i in range(scores.shape[0]):
        video_idx = int(np.round(metadata[i][0]))
        sec = int(np.round(metadata[i][1]))
        key = make_image_key(video_idx_to_name[video_idx], sec)
        # row is [batch_idx, x1, y1, x2, y2] -> [y1, x1, y2, x2]
        b = boxes[i].tolist()
        box = [b[2], b[1], b[4], b[3]]
        for cls_idx, score in enumerate(scores[i].tolist()):
            if cls_idx + 1 in class_whitelist:
                out_scores[key].append(score)
                out_labels[key].append(cls_idx + 1)
                out_boxes[key].append(box)
    return out_boxes, out_labels, out_scores


def write_results(detections, filename: str) -> None:
    boxes, labels, scores = detections
    with open(filename, 'w') as f:
        for key in boxes:
            for box, label, score in zip(boxes[key], labels[key], scores[key]):
                f.write('%s,%.03f,%.03f,%.03f,%.03f,%d,%.04f\n' % (
                    key, box[1], box[0], box[3], box[2], label, score))
    logger.info('AVA results wrote to %s', filename)


def evaluate_ava(preds, original_boxes, metadata, excluded_keys,
                 class_whitelist, categories, groundtruth,
                 video_idx_to_name, name='latest', output_dir='.') -> float:
    import os
    start = time.time()
    detections = get_ava_eval_data(preds, original_boxes, metadata,
                                   class_whitelist, video_idx_to_name)
    logger.info('Evaluating %d detection vs %d GT frames',
                len(detections[0]), len(groundtruth[0]))
    write_results(detections,
                  os.path.join(output_dir, 'detections_%s.csv' % name))
    results = run_evaluation(categories, groundtruth, detections,
                             excluded_keys)
    logger.info('AVA eval done in %.2f seconds.', time.time() - start)
    return results['PascalBoxes_Precision/mAP@0.5IOU']


def evaluate_ava_from_files(labelmap, groundtruth, detections, exclusions):
    categories, class_whitelist = read_labelmap(labelmap)
    excluded_keys = read_exclusions(exclusions)
    gt = read_csv(groundtruth, class_whitelist, load_score=False)
    dt = read_csv(detections, class_whitelist, load_score=True)
    return run_evaluation(categories, gt, dt, excluded_keys)

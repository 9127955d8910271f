"""Metrics aggregation across train/eval loops (port of
``lfb_tpu/eval/metrics.py``).

Reference: ``lib/utils/metrics.py``.  Differences: operates on the
step's numpy outputs (no workspace fetches), and AVA's fixed-shape padded
box rows are dropped via ``box_mask`` before aggregation (the reference has
ragged rows and instead trims only the duplicated final batch, which is
preserved here via ``total_num_boxes``).

The Charades mAP / wAP / AUC (:func:`mean_ap_metric`) are ``lfb_tpu``'s,
computed as scikit-learn's ``average_precision_score(average=None)`` and
macro ``roc_auc_score`` compute them, in numpy: the port does not
depend on scikit-learn.
"""

from __future__ import annotations

import logging
import os
import pickle
from collections import defaultdict
from typing import Dict, Optional

import numpy as np

logger = logging.getLogger(__name__)


def topk_correct(preds: np.ndarray, labels: np.ndarray, k: int) -> int:
    """Number of rows whose label is within the top-k scores."""
    topk = np.argsort(-preds, axis=1)[:, :k]
    return int(np.sum(topk == labels.reshape(-1, 1)))


def _binary_clf_curve(y_true: np.ndarray, y_score: np.ndarray):
    """(fps, tps) at each distinct score, highest first, as scikit-learn's
    ``_binary_clf_curve``: a stable descending sort, one threshold per
    distinct score (ties are one step), float64 cumulative sums."""
    order = np.argsort(y_score, kind='mergesort')[::-1]
    y_score, y_true = y_score[order], y_true[order]
    distinct = np.where(np.diff(y_score))[0]
    thresholds = np.r_[distinct, y_true.size - 1]
    tps = np.cumsum(y_true * 1.0, dtype=np.float64)[thresholds]
    return 1 + thresholds - tps, tps


def _check_column_target(target: np.ndarray) -> None:
    """The ``ValueError`` scikit-learn raises before scoring a target it
    cannot read as binary or multilabel-indicator: no column, or no row."""
    if target.ndim != 2 or target.shape[0] == 0 or target.shape[1] == 0:
        raise ValueError('target of shape {} is neither binary nor '
                         'multilabel-indicator'.format(target.shape))


def average_precision_per_class(target: np.ndarray,
                                predict: np.ndarray) -> np.ndarray:
    """Per-column average precision, ``average_precision_score(target,
    predict, average=None)``: the step integral sum((R_k - R_{k-1}) P_k)
    over the thresholds; a column without positives scores 0."""
    _check_column_target(target)
    aps = np.zeros(target.shape[1])
    for c in range(target.shape[1]):
        fps, tps = _binary_clf_curve(target[:, c] == 1, predict[:, c])
        precision = np.zeros_like(tps)
        np.divide(tps, tps + fps, out=precision, where=(tps + fps) != 0)
        recall = (tps / tps[-1] if tps[-1] != 0 else np.ones_like(tps))
        # scikit-learn's order: reversed, with (precision 1, recall 0) last.
        precision = np.hstack((precision[::-1], 1))
        recall = np.hstack((recall[::-1], 0))
        aps[c] = max(0.0, -np.sum(np.diff(recall) * precision[:-1]))
    return aps


def roc_auc_macro(target: np.ndarray, predict: np.ndarray) -> float:
    """``roc_auc_score(target, predict)`` (macro over columns): the mean of
    the trapezoid areas under the columns' ROC curves.  A column that holds
    one class only scores NaN, with a warning, as scikit-learn 1.9 scores it
    (older releases raised ``ValueError``)."""
    _check_column_target(target)
    aucs = []
    for c in range(target.shape[1]):
        y = target[:, c] == 1
        if len(np.unique(y)) != 2:
            logger.warning('Only one class is present in column %d: its ROC '
                           'AUC is not defined', c)
            aucs.append(np.nan)
            continue
        fps, tps = _binary_clf_curve(y, predict[:, c])
        fpr = np.r_[0, fps] / fps[-1]
        tpr = np.r_[0, tps] / tps[-1]
        aucs.append(float(np.sum(np.diff(fpr) * (tpr[1:] + tpr[:-1]) / 2)))
    return float(np.mean(aucs))


def mean_ap_metric(predicts: np.ndarray, targets: np.ndarray):
    """Charades mAP/wAP/AUC over classes with >=1 positive (reference
    ``metrics.py:444-482``)."""
    predicts = np.vstack(predicts)
    targets = np.vstack(targets)
    keep = ~np.all(targets == 0, axis=0)
    predict = predicts[:, keep]
    target = targets[:, keep]
    mean_auc, aps = 0.0, np.zeros(1)
    try:
        mean_auc = roc_auc_macro(target, predict)
    except ValueError:
        logger.warning('roc_auc unavailable for this sample')
    try:
        aps = average_precision_per_class(target, predict)
    except ValueError:
        logger.warning('average_precision unavailable for this sample')
    mean_ap = float(np.mean(aps))
    weights = np.sum(target.astype(float), axis=0)
    weights = weights / np.sum(weights)
    mean_wap = float(np.sum(np.multiply(aps, weights)))
    all_aps = np.zeros((1, targets.shape[1]))
    all_aps[:, keep] = aps
    return mean_auc, mean_ap, mean_wap, all_aps.flatten()


def get_ava_mini_groundtruth(full_groundtruth):
    """Frames with sec % 4 == 0 (reference ``metrics.py:67-80``)."""
    ret = [defaultdict(list), defaultdict(list), defaultdict(list)]
    for i in range(3):
        for key, value in full_groundtruth[i].items():
            if int(key.split(',')[1]) % 4 == 0:
                ret[i][key] = value
    return ret


class MetricsCalculator:

    def __init__(self, cfg, split: str, video_idx_to_name=None,
                 total_num_boxes: Optional[int] = None,
                 num_test_clips: int = 1, full_eval: bool = True,
                 output_dir: str = '.'):
        self.cfg = cfg
        self.split = split
        self.video_idx_to_name = video_idx_to_name
        self.total_num_boxes = total_num_boxes
        self.num_test_clips = num_test_clips
        self.full_eval = full_eval
        self.output_dir = output_dir

        self.best_top1 = float('inf')
        self.best_top5 = float('inf')
        self.best_map = -float('inf')
        self.lr = 0.0
        self.full_map = 0.0
        self.avg_err = self.avg_err5 = 0.0

        if cfg.DATASET == 'ava':
            from lfb_tpu_torch.eval import ava_eval
            ann = cfg.AVA.ANNOTATION_DIR
            self.excluded_keys = ava_eval.read_exclusions(
                os.path.join(ann, 'ava_val_excluded_timestamps_v2.1.csv'))
            self.categories, self.class_whitelist = ava_eval.read_labelmap(
                os.path.join(ann,
                             'ava_action_list_v2.1_for_activitynet_2018.pbtxt'))
            self.full_groundtruth = ava_eval.read_csv(
                os.path.join(ann, 'ava_val_v2.1.csv'), self.class_whitelist)
            self.mini_groundtruth = get_ava_mini_groundtruth(
                self.full_groundtruth)
        self.reset()

    def reset(self):
        self.aggr_err = 0.0
        self.aggr_err5 = 0.0
        self.aggr_loss = 0.0
        self.aggr_batch_size = 0
        self.all_preds = []
        self.all_labels = []
        self.all_original_boxes = []
        self.all_metadata = []

    # ------------------------------------------------------------------ #

    def update_train(self, loss: float, preds: np.ndarray,
                     labels: np.ndarray, lr: float):
        batch_size = preds.shape[0]
        self.lr = lr
        self.aggr_loss += float(loss) * batch_size
        self.aggr_batch_size += batch_size
        if not self.cfg.MODEL.MULTI_LABEL:
            err = (1.0 - topk_correct(preds, labels, 1) / batch_size) * 100
            err5 = (1.0 - topk_correct(preds, labels, 5) / batch_size) * 100
            self.aggr_err += err * batch_size
            self.aggr_err5 += err5 * batch_size
            return err, err5
        return None, None

    def update_test(self, preds: np.ndarray, labels: np.ndarray,
                    original_boxes: Optional[np.ndarray] = None,
                    metadata: Optional[np.ndarray] = None,
                    box_mask: Optional[np.ndarray] = None,
                    loss: Optional[float] = None):
        if box_mask is not None:
            real = box_mask > 0
            preds, labels = preds[real], labels[real]
            if original_boxes is not None:
                original_boxes = original_boxes[real]
            if metadata is not None:
                metadata = metadata[real]
        self.aggr_batch_size += preds.shape[0]
        if loss is not None:
            self.aggr_loss += float(loss) * preds.shape[0]
        self.all_preds.append(preds)
        self.all_labels.append(labels)
        if self.cfg.MODEL.MULTI_LABEL:
            if original_boxes is not None:
                self.all_original_boxes.append(original_boxes)
            if metadata is not None:
                self.all_metadata.append(metadata)
        else:
            bs = preds.shape[0]
            err = (1.0 - topk_correct(preds, labels, 1) / bs) * 100
            err5 = (1.0 - topk_correct(preds, labels, 5) / bs) * 100
            self.aggr_err += err * bs
            self.aggr_err5 += err5 * bs

    # ------------------------------------------------------------------ #

    def stack_predictions(self):
        all_preds = np.vstack(self.all_preds)
        all_labels = (np.vstack(self.all_labels)
                      if self.cfg.MODEL.MULTI_LABEL
                      else np.concatenate(self.all_labels))
        num_to_use = self.num_test_clips * self.cfg.TEST.DATASET_SIZE
        if num_to_use and all_preds.shape[0] >= num_to_use:
            all_preds = all_preds[:num_to_use]
            all_labels = all_labels[:num_to_use]
        return all_preds, all_labels

    def aggregate_predictions_from_clips(self):
        """Charades clip->video max aggregation (reference
        ``metrics.py:165-186``: clip c of video v is row v + c*num_videos)."""
        all_preds, all_labels = self.stack_predictions()
        n_videos = all_preds.shape[0] // self.num_test_clips
        for i in range(n_videos):
            for clip in range(1, self.num_test_clips):
                j = i + clip * n_videos
                assert np.array_equal(all_labels[i], all_labels[j]), (i, clip)
                all_preds[i] = np.maximum(all_preds[i], all_preds[j])
        return all_preds[:n_videos], all_labels[:n_videos]

    def get_ava_eval_arrays(self):
        preds = np.vstack(self.all_preds)
        labels = np.vstack(self.all_labels)
        boxes = np.vstack(self.all_original_boxes)
        metadata = np.vstack(self.all_metadata)
        n = self.total_num_boxes
        assert preds.shape[0] >= n, (preds.shape, n)
        return preds[:n], labels[:n], boxes[:n], metadata[:n]

    def finalize_metrics(self, is_train: bool = False,
                         name: str = 'latest') -> Dict[str, float]:
        cfg = self.cfg
        out: Dict[str, float] = {}
        if self.aggr_batch_size:
            out['loss'] = self.aggr_loss / self.aggr_batch_size
        if cfg.MODEL.MULTI_LABEL:
            if is_train:
                self.full_map = 0.0
            elif cfg.DATASET == 'charades':
                if self.num_test_clips > 1:
                    preds, labels = self.aggregate_predictions_from_clips()
                else:
                    preds, labels = self.stack_predictions()
                self.full_map = mean_ap_metric(preds, labels)[1]
            elif cfg.DATASET == 'ava':
                from lfb_tpu_torch.eval import ava_eval
                preds, _, boxes, metadata = self.get_ava_eval_arrays()
                self.full_map = ava_eval.evaluate_ava(
                    preds, boxes, metadata, self.excluded_keys,
                    self.class_whitelist, self.categories,
                    groundtruth=(self.full_groundtruth if self.full_eval
                                 else self.mini_groundtruth),
                    video_idx_to_name=self.video_idx_to_name, name=name,
                    output_dir=self.output_dir)
            out['full_map'] = self.full_map
        else:
            if self.aggr_batch_size:
                self.avg_err = self.aggr_err / self.aggr_batch_size
                self.avg_err5 = self.aggr_err5 / self.aggr_batch_size
            out['err'] = self.avg_err
            out['err5'] = self.avg_err5
            if not is_train:
                preds, labels = self.stack_predictions()
                path = os.path.join(self.output_dir,
                                    'epic_predictions_%s.pkl' % name)
                with open(path, 'wb') as f:
                    pickle.dump((preds, labels), f, protocol=2)
                logger.info('EPIC predictions saved to %s', path)
        return out

    def compute_and_log_best(self):
        if self.cfg.MODEL.MULTI_LABEL:
            if self.full_map > self.best_map:
                self.best_map = self.full_map
                logger.info('* Best model: mAP: %7.3f', self.best_map)
        else:
            if self.avg_err < self.best_top1:
                self.best_top1 = self.avg_err
                self.best_top5 = self.avg_err5
                logger.info('* Best model: top1: %7.3f top5: %7.3f',
                            self.best_top1, self.best_top5)

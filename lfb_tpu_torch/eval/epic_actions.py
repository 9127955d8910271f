"""EPIC-Kitchens action evaluation: combine verb and noun predictions (the
port's copy of ``lfb_tpu/eval/epic_actions.py``, numpy only).

Reference: ``tools/evaluate_actions.py``.  Action score = softmax(verb) x
softmax(noun) outer product weighted by the training-set P(verb|noun) prior;
top-k accuracy over the val segments.
"""

from __future__ import annotations

import csv
import logging
import os
import pickle
from typing import Optional

import numpy as np

logger = logging.getLogger(__name__)

NUM_TEST_SEG = 5281


def get_training_action_freq(num_verbs: int, num_nouns: int,
                             annotation_root: str) -> np.ndarray:
    seen = np.zeros((num_verbs, num_nouns))
    path = os.path.join(annotation_root, 'EPIC_train_action_labels.csv')
    with open(path, 'r') as f:
        f.readline()
        for row in csv.reader(f):
            assert len(row) == 14, len(row)
            person = int(row[1][1:])
            assert 1 <= person <= 32
            if person <= 25:
                seen[int(row[-5]), int(row[-3])] += 1
    return seen / seen.sum()


def softmax(x: np.ndarray) -> np.ndarray:
    assert x.ndim == 2
    e_x = np.exp(x - np.max(x, axis=1, keepdims=True))
    return e_x / e_x.sum(axis=1, keepdims=True)


def top_k_single(scores: np.ndarray, labels: np.ndarray, k: int,
                 num_seg: int = NUM_TEST_SEG) -> float:
    assert scores.shape[0] == num_seg and labels.shape[0] == num_seg
    correct = sum(1 for i in range(num_seg)
                  if int(labels[i]) in scores[i].argsort()[-k:])
    return 100.0 * correct / num_seg


def top_k_actions(verb_pred, noun_pred, verb_labels, noun_labels, k,
                  prior: Optional[np.ndarray] = None,
                  num_seg: int = NUM_TEST_SEG) -> float:
    correct = 0
    for i in range(num_seg):
        action_scores = np.outer(verb_pred[i], noun_pred[i])
        if prior is not None:
            action_scores = action_scores * prior
        top_v, top_n = np.unravel_index(
            np.argsort(-action_scores, axis=None), action_scores.shape)
        for v, n in zip(top_v[:k].tolist(), top_n[:k].tolist()):
            if int(verb_labels[i]) == v and int(noun_labels[i]) == n:
                correct += 1
                break
    return 100.0 * correct / num_seg


def evaluate_actions(verb_file: str, noun_file: str, annotation_root: str,
                     num_seg: int = NUM_TEST_SEG):
    with open(verb_file, 'rb') as f:
        verb_pred, verb_labels = pickle.load(f, encoding='latin1')
    with open(noun_file, 'rb') as f:
        noun_pred, noun_labels = pickle.load(f, encoding='latin1')
    verb_pred = softmax(np.asarray(verb_pred))
    noun_pred = softmax(np.asarray(noun_pred))

    action_freq = get_training_action_freq(
        verb_pred.shape[1], noun_pred.shape[1], annotation_root)
    v_given_n = action_freq / (np.sum(action_freq, axis=1, keepdims=True)
                               + 1e-5)
    results = {}
    for k in (1, 5):
        results['verb_top%d' % k] = top_k_single(
            verb_pred, verb_labels, k, num_seg)
        results['noun_top%d' % k] = top_k_single(
            noun_pred, noun_labels, k, num_seg)
        results['action_top%d' % k] = top_k_actions(
            verb_pred, noun_pred, verb_labels, noun_labels, k, v_given_n,
            num_seg)
        logger.info('Top-%d  verb %.4f  noun %.4f  action %.4f', k,
                    results['verb_top%d' % k], results['noun_top%d' % k],
                    results['action_top%d' % k])
    return results

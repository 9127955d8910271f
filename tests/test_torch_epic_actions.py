"""EPIC-Kitchens action scores: the port's copy
(``lfb_tpu_torch/eval/epic_actions.py``) and its command line
(``python -m lfb_tpu_torch.tools.evaluate_actions``) against
``lfb_tpu/eval/epic_actions.py`` and ``tools/evaluate_actions.py``, on
seeded verb and noun prediction pickles in the format ``test_net`` writes
(``(scores, labels)``, protocol 2) and the training-set action labels of
``tests/synthetic.py:build_epic``.  Every accuracy is equal: both sides run
the same numpy on the same arrays."""

import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

from lfb_tpu.eval import epic_actions as jax_epic_actions
from lfb_tpu_torch.eval import epic_actions
from lfb_tpu_torch.tools import evaluate_actions
from tests import synthetic

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NUM_SEG = 40


@pytest.fixture(scope='module')
def epic(tmp_path_factory):
    """(annotation dir, verb pickle, noun pickle) for ``NUM_SEG`` segments
    over the synthetic split's 5 verb and 7 noun classes."""
    root = str(tmp_path_factory.mktemp('epic_actions'))
    ann = synthetic.build_epic(root, num_frames=4)['EPIC']['ANNOTATION_DIR']
    rng = np.random.RandomState(5)
    paths = []
    for kind, classes in (('verb', 5), ('noun', 7)):
        path = os.path.join(root, 'epic_predictions_{}.pkl'.format(kind))
        with open(path, 'wb') as f:
            pickle.dump((rng.randn(NUM_SEG, classes).astype(np.float32) * 2,
                         rng.randint(0, classes, NUM_SEG)), f, protocol=2)
        paths.append(path)
    return ann, paths[0], paths[1]


def test_prior_and_softmax_match_lfb_tpu(epic):
    ann, _, _ = epic
    prior = epic_actions.get_training_action_freq(5, 7, ann)
    np.testing.assert_array_equal(
        prior, jax_epic_actions.get_training_action_freq(5, 7, ann))
    assert prior.sum() == pytest.approx(1.0) and (prior > 0).any()
    x = np.random.RandomState(0).randn(6, 9)
    np.testing.assert_array_equal(epic_actions.softmax(x),
                                  jax_epic_actions.softmax(x))


@pytest.mark.parametrize('k', [1, 5])
def test_top_k_matches_lfb_tpu(epic, k):
    ann, verb_file, noun_file = epic
    with open(verb_file, 'rb') as f:
        verb, verb_labels = pickle.load(f)
    with open(noun_file, 'rb') as f:
        noun, noun_labels = pickle.load(f)
    prior = jax_epic_actions.get_training_action_freq(5, 7, ann)
    args = (epic_actions.softmax(verb), epic_actions.softmax(noun),
            verb_labels, noun_labels, k)
    got = epic_actions.top_k_actions(*args, prior=prior, num_seg=NUM_SEG)
    assert got == jax_epic_actions.top_k_actions(*args, prior=prior,
                                                 num_seg=NUM_SEG)
    assert (epic_actions.top_k_single(args[0], verb_labels, k, NUM_SEG)
            == jax_epic_actions.top_k_single(args[0], verb_labels, k,
                                             NUM_SEG))


def test_evaluate_actions_cli_matches_tools_evaluate_actions(epic):
    """The port's ``main`` in process and as ``python -m``, against the
    reference script's logged accuracies and ``lfb_tpu``'s
    ``evaluate_actions``."""
    ann, verb_file, noun_file = epic
    argv = ['--verb_file', verb_file, '--noun_file', noun_file,
            '--annotation_root', ann, '--num_seg', str(NUM_SEG)]
    got = evaluate_actions.main(argv)
    want = jax_epic_actions.evaluate_actions(verb_file, noun_file, ann,
                                             num_seg=NUM_SEG)
    assert got == want
    assert sorted(got) == sorted(
        '{}_top{}'.format(kind, k) for kind in ('verb', 'noun', 'action')
        for k in (1, 5))
    assert all(0 <= v <= 100 for v in got.values())
    env = dict(os.environ, PYTHONPATH=REPO)
    outs = [subprocess.run(cmd + argv, cwd=REPO, env=env, capture_output=True,
                           text=True, timeout=120)
            for cmd in ([sys.executable, '-m',
                         'lfb_tpu_torch.tools.evaluate_actions'],
                        [sys.executable,
                         os.path.join(REPO, 'tools', 'evaluate_actions.py')])]
    lines = []
    for proc in outs:
        assert proc.returncode == 0, proc.stderr[-2000:]
        lines.append([line.split(']: ', 1)[1] for line in
                      proc.stdout.splitlines() if 'Top-' in line])
    assert len(lines[0]) == 2 and lines[0] == lines[1]
    assert lines[0][0] == 'Top-1  verb {:.4f}  noun {:.4f}  action {:.4f}'.format(
        got['verb_top1'], got['noun_top1'], got['action_top1'])


"""The port's eval layer against lfb_tpu's, and its Charades mAP / wAP / AUC
against scikit-learn, on the CPU.

* ``mean_ap_metric`` and its parts are numpy versions of scikit-learn's
  ``average_precision_score(average=None)`` and macro ``roc_auc_score``
  (the port does not depend on scikit-learn): held to scikit-learn and to
  ``lfb_tpu``'s sklearn-backed function within 1e-12, with ties, a column
  without positives (dropped), a column of positives only (no AUC: NaN, as
  scikit-learn 1.9 gives) and no positives at all (the ``ValueError``
  branches).
* ``ava_eval``, ``MetricsCalculator`` and ``multicrop`` are copies of
  ``lfb_tpu``'s numpy code: on the same inputs they write the same bytes and
  return the same mAP, exactly.
"""

import os
import pickle
import warnings

import numpy as np
import pytest

torch = pytest.importorskip('torch')
cv2 = pytest.importorskip('cv2')
skm = pytest.importorskip('sklearn.metrics')

from lfb_tpu.core import config as jax_config  # noqa: E402
from lfb_tpu.eval import ava_eval as jax_ava_eval  # noqa: E402
from lfb_tpu.eval import metrics as jax_metrics  # noqa: E402
from lfb_tpu.eval import multicrop as jax_multicrop  # noqa: E402
from lfb_tpu_torch.core import config as port_config  # noqa: E402
from lfb_tpu_torch.eval import ava_eval, metrics, multicrop  # noqa: E402
from tests import synthetic  # noqa: E402


def both_cfgs(overrides, opts=()):
    out = []
    for module in (jax_config, port_config):
        cfg = module.default_config()
        module.merge_dict_into(cfg, overrides)
        module.merge_cfg_from_list(cfg, list(opts))
        out.append(module.finalize(cfg))
    return out


def targets_case(name, rng):
    n, c = 30, 6
    target = (rng.random((n, c)) < 0.3).astype(np.float32)
    predict = rng.random((n, c)).astype(np.float32)
    if name == 'ties':
        predict = np.round(predict * 4) / 4
    elif name == 'a column without positives':
        target[:, 2] = 0
    elif name == 'a column of positives only':
        target[:, 4] = 1
    elif name == 'one kept column':
        target[:] = 0
        target[::3, 1] = 1
    elif name == 'no positives':
        target[:] = 0
    return predict, target


CASES = ['random', 'ties', 'a column without positives',
         'a column of positives only', 'one kept column', 'no positives']


@pytest.mark.parametrize('case', CASES)
def test_mean_ap_metric_matches_sklearn_and_lfb_tpu(case):
    predict, target = targets_case(case, np.random.default_rng(CASES.index(case)))
    # Batches of rows, as the meter hands them over.
    preds, targets = [predict[:10], predict[10:]], [target[:10], target[10:]]
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')
        ref = jax_metrics.mean_ap_metric(preds, targets)
    port = metrics.mean_ap_metric(preds, targets)
    for a, b in zip(port, ref):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-12, equal_nan=True)
    if case == 'a column of positives only':
        assert np.isnan(port[0]) and 0 < port[1] <= 1
    if case == 'no positives':
        assert port[:3] == (0.0, 0.0, 0.0)


@pytest.mark.parametrize('case', CASES[:4])
def test_ap_and_auc_match_sklearn(case):
    predict, target = targets_case(case, np.random.default_rng(7))
    keep = target.any(axis=0)
    predict, target = predict[:, keep], target[:, keep]
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')
        ref_ap = skm.average_precision_score(target, predict, average=None)
        ref_auc = skm.roc_auc_score(target, predict)
    np.testing.assert_allclose(
        metrics.average_precision_per_class(target, predict), ref_ap,
        rtol=0, atol=1e-12)
    np.testing.assert_allclose(metrics.roc_auc_macro(target, predict),
                               ref_auc, rtol=0, atol=1e-12, equal_nan=True)


def test_empty_targets_raise_as_sklearn():
    empty = np.zeros((4, 0), np.float32)
    for fn in (metrics.average_precision_per_class, metrics.roc_auc_macro):
        with pytest.raises(ValueError):
            fn(empty, empty)
    with pytest.raises(ValueError):
        skm.average_precision_score(empty, empty, average=None)


def test_topk_and_mini_groundtruth_match():
    rng = np.random.default_rng(0)
    preds, labels = rng.random((20, 9)), rng.integers(0, 9, 20)
    for k in (1, 3, 5):
        assert (metrics.topk_correct(preds, labels, k)
                == jax_metrics.topk_correct(preds, labels, k))
    full = [{'v,{:04d}'.format(s): [s] for s in range(900, 910)}
            for _ in range(3)]
    assert (metrics.get_ava_mini_groundtruth(full)
            == jax_metrics.get_ava_mini_groundtruth(full))


@pytest.fixture(scope='module')
def ava(tmp_path_factory):
    return synthetic.build_ava(str(tmp_path_factory.mktemp('ava')))


def ava_rows(rng, n_boxes=16, n_videos=2):
    """Scores, original boxes and metadata rows of an AVA sweep."""
    preds = rng.random((n_boxes, 80)).astype(np.float32)
    boxes = np.concatenate([np.zeros((n_boxes, 1)), np.sort(
        rng.random((n_boxes, 4)), axis=1)], axis=1).astype(np.float32)
    meta = np.stack([rng.integers(0, n_videos, n_boxes),
                     rng.integers(902, 906, n_boxes), np.full(n_boxes, 48),
                     np.full(n_boxes, 64)], axis=1).astype(np.float32)
    return preds, boxes, meta


def test_ava_eval_matches_lfb_tpu(ava, tmp_path):
    ann = ava['AVA']['ANNOTATION_DIR']
    labelmap = os.path.join(
        ann, 'ava_action_list_v2.1_for_activitynet_2018.pbtxt')
    gt = os.path.join(ann, 'ava_val_v2.1.csv')
    excl = os.path.join(ann, 'ava_val_excluded_timestamps_v2.1.csv')
    cats, whitelist = ava_eval.read_labelmap(labelmap)
    assert (cats, whitelist) == jax_ava_eval.read_labelmap(labelmap)
    assert ava_eval.read_csv(gt, whitelist) == jax_ava_eval.read_csv(
        gt, whitelist)
    assert ava_eval.read_exclusions(excl) == jax_ava_eval.read_exclusions(excl)
    preds, boxes, meta = ava_rows(np.random.default_rng(1))
    names = {0: 'AVA00', 1: 'AVA01'}
    maps = []
    for module, out in ((ava_eval, tmp_path / 'port'),
                        (jax_ava_eval, tmp_path / 'ref')):
        os.makedirs(out)
        maps.append(module.evaluate_ava(
            preds, boxes, meta, set(), whitelist, cats,
            module.read_csv(gt, whitelist), names, name='t',
            output_dir=str(out)))
    assert maps[0] == maps[1] and 0 <= maps[0] <= 1
    port_csv = (tmp_path / 'port' / 'detections_t.csv').read_bytes()
    assert port_csv == (tmp_path / 'ref' / 'detections_t.csv').read_bytes()
    assert len(port_csv.splitlines()) == 16 * 80
    path = str(tmp_path / 'port' / 'detections_t.csv')
    assert (ava_eval.evaluate_ava_from_files(labelmap, gt, path, excl)
            == jax_ava_eval.evaluate_ava_from_files(labelmap, gt, path, excl))


def run_meters(cfgs, updates, tmp_path, **kwargs):
    """The same update_test calls on lfb_tpu's and the port's meter;
    returns both (metrics, output dir)."""
    out = []
    for module, cfg, name in ((metrics, cfgs[1], 'port'),
                              (jax_metrics, cfgs[0], 'ref')):
        d = tmp_path / name
        os.makedirs(d)
        meter = module.MetricsCalculator(cfg, 'val', output_dir=str(d),
                                         **kwargs)
        for update in updates:
            meter.update_test(*update[:2], **update[2])
        with warnings.catch_warnings():
            warnings.simplefilter('ignore')
            out.append((meter.finalize_metrics(name='t'), d))
    return out


def test_metrics_calculator_ava_matches_lfb_tpu(ava, tmp_path):
    cfgs = both_cfgs(ava)
    rng = np.random.default_rng(2)
    updates = []
    for _ in range(3):
        preds, boxes, meta = ava_rows(rng, n_boxes=8)
        mask = (rng.random(8) < 0.7).astype(np.float32)
        updates.append((preds, np.zeros_like(preds), dict(
            original_boxes=boxes, metadata=meta, box_mask=mask)))
    total = int(sum(u[2]['box_mask'].sum() for u in updates)) - 1
    (port, pd), (ref, rd) = run_meters(
        cfgs, updates, tmp_path, video_idx_to_name={0: 'AVA00', 1: 'AVA01'},
        total_num_boxes=total)
    assert port == ref and 0 <= port['full_map'] <= 1
    assert ((pd / 'detections_t.csv').read_bytes()
            == (rd / 'detections_t.csv').read_bytes())


def test_metrics_calculator_charades_matches_lfb_tpu(tmp_path):
    cfgs = both_cfgs({'DATASET': 'charades', 'MODEL': {'NUM_CLASSES': 6}},
                     ['TEST.DATASET_SIZE', '4'])
    rng = np.random.default_rng(3)
    labels = (rng.random((4, 6)) < 0.4).astype(np.float32)
    labels[:, 0] = 1
    labels[0, 0] = 0
    updates = [(rng.random((4, 6)).astype(np.float32), labels, {})
               for _ in range(3)]   # 3 clips of each of 4 videos
    (port, _), (ref, _) = run_meters(cfgs, updates, tmp_path,
                                     num_test_clips=3)
    np.testing.assert_allclose(port['full_map'], ref['full_map'], rtol=0,
                               atol=1e-12)
    assert 0 < port['full_map'] <= 1


def test_metrics_calculator_epic_matches_lfb_tpu(tmp_path):
    cfgs = both_cfgs({'DATASET': 'epic',
                      'MODEL': {'NUM_CLASSES': 9, 'MULTI_LABEL': False}},
                     ['TEST.DATASET_SIZE', '10'])
    rng = np.random.default_rng(4)
    updates = [(rng.random((6, 9)).astype(np.float32),
                rng.integers(0, 9, 6).astype(np.int32), {})
               for _ in range(2)]
    (port, pd), (ref, rd) = run_meters(cfgs, updates, tmp_path)
    assert port == ref and 0 <= port['err'] <= 100
    with open(pd / 'epic_predictions_t.pkl', 'rb') as f:
        port_preds = pickle.load(f)
    with open(rd / 'epic_predictions_t.pkl', 'rb') as f:
        ref_preds = pickle.load(f)
    for a, b in zip(port_preds, ref_preds):
        np.testing.assert_array_equal(a, b)
    assert port_preds[0].shape == (10, 9)
    meters = [module.MetricsCalculator(cfg, 'train') for module, cfg in
              ((metrics, cfgs[1]), (jax_metrics, cfgs[0]))]
    preds, labels, _ = updates[0]
    assert (meters[0].update_train(0.5, preds, labels, 0.1)
            == meters[1].update_train(0.5, preds, labels, 0.1))


def test_multicrop_merge_matches_lfb_tpu(ava, tmp_path):
    """Six (flip, scale) x three shift detection files, merged with the crop
    visibility gate and summed, then evaluated: the same files and mAP; the
    frame sizes come from each video's first JPEG (cv2)."""
    cfgs = both_cfgs(ava, ['AVA.TEST_MULTI_CROP_SCALES', '[36, 40]'])
    rng = np.random.default_rng(5)
    preds, boxes, meta = ava_rows(rng)
    cats, whitelist = ava_eval.read_labelmap(os.path.join(
        ava['AVA']['ANNOTATION_DIR'],
        'ava_action_list_v2.1_for_activitynet_2018.pbtxt'))
    maps, dirs = [], []
    for module, cfg, name in ((multicrop, cfgs[1], 'port'),
                              (jax_multicrop, cfgs[0], 'ref')):
        d = tmp_path / name
        os.makedirs(d)
        for scale in (36, 40):
            for flip in ('', '_flip'):
                for shift in range(3):
                    scores = preds * (1 + shift) / 3
                    ava_eval.write_results(ava_eval.get_ava_eval_data(
                        scores, boxes, meta, whitelist,
                        {0: 'AVA00', 1: 'AVA01'}), str(
                        d / 'detections_final_{}{}_shift{}_0.850.csv'.format(
                            scale, flip, shift)))
        maps.append(module.combine_ava_multi_crops(cfg, str(d)))
        dirs.append(d)
    assert maps[0] == maps[1] and 0 <= maps[0] <= 1
    names = sorted(os.listdir(dirs[0]))
    assert names == sorted(os.listdir(dirs[1])) and len(names) == 12 + 4 + 1
    for name in names:
        assert (dirs[0] / name).read_bytes() == (dirs[1] / name).read_bytes()
    shape_fn = multicrop.default_video_shape_fn(cfgs[1])
    assert shape_fn('AVA01') == (48, 64)

"""Parity harness on the card (port of ``tools/parity_eval.py``): evaluate
released reference weights and compare them with the published numbers.

Usage (with datasets prepared per DATASET.md and the reference's released
``model_final.pkl`` / ``lfb_model.pkl`` downloaded):

  python -m lfb_tpu_torch.tools.parity_eval --config ava_r50_baseline \\
      --params runs/ava_r50_baseline/model_final.pkl
  python -m lfb_tpu_torch.tools.parity_eval --config epic_verb_r50_lfb_nl \\
      --params model_final.pkl --lfb_params lfb_model.pkl
  python -m lfb_tpu_torch.tools.parity_eval --dryrun DIR [--device cpu]

Runs the full test flow of :mod:`lfb_tpu_torch.tools.test_net` (bank
inference for LFB configs, AVA multi-crop when the config asks for it) on
``min(NUM_GPUS, cards)`` ranks, prints the metric beside the published one
and exits non-zero when it falls outside the tolerance.  ``--dryrun``
rehearses that path for :data:`DRYRUN_CONFIGS` with manifest-shaped random
weights over the synthetic tiny datasets of ``tests/synthetic.py``, in one
process.
"""

import argparse
import functools
import logging
import os
import sys

from lfb_tpu_torch.core.config import (clone, default_config, finalize,
                                       load_config, merge_cfg_from_file,
                                       merge_cfg_from_list, merge_dict_into)
from lfb_tpu_torch.parallel import launch
from lfb_tpu_torch.tools.test_net import test_net
from lfb_tpu_torch.train.c2_manifest import released_blob_manifest
from lfb_tpu_torch.train.checkpoints import write_pkl

FORMAT = '[%(levelname)s: %(filename)s: %(lineno)4d]: %(message)s'
logger = logging.getLogger(__name__)

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CONFIG_DIR = os.path.join(REPO, 'configs')

# Published validation results (BASELINE.md; reference README.md:38-98).
EXPECTED = {
    'ava_r50_baseline': ('full_map', 22.2),
    'ava_r50_lfb_avg': ('full_map', 23.3),
    'ava_r50_lfb_max': ('full_map', 23.9),
    'ava_r50_lfb_nl': ('full_map', 25.8),
    'ava_r50_lfb_nl_3l': ('full_map', 25.9),
    'ava_r101_baseline': ('full_map', 23.2),
    'ava_r101_lfb_nl_3l': ('full_map', 26.9),
    'epic_verb_r50_baseline': ('top1', 50.7),
    'epic_verb_r50_lfb_avg': ('top1', 52.9),
    'epic_verb_r50_lfb_max': ('top1', 53.3),
    'epic_verb_r50_lfb_nl': ('top1', 52.3),
    'epic_noun_r50_baseline': ('top1', 26.2),
    'epic_noun_r50_lfb_avg': ('top1', 29.1),
    'epic_noun_r50_lfb_max': ('top1', 32.0),
    'epic_noun_r50_lfb_nl': ('top1', 29.5),
    'charades_r50_baseline': ('full_map', 38.3),
    'charades_r50_lfb_avg': ('full_map', 38.4),
    'charades_r50_lfb_max': ('full_map', 38.6),
    'charades_r50_lfb_nl': ('full_map', 40.3),
    'charades_r101_baseline': ('full_map', 40.4),
    'charades_r101_lfb_avg': ('full_map', 40.8),
    'charades_r101_lfb_max': ('full_map', 41.0),
    'charades_r101_lfb_nl': ('full_map', 42.5),
}


def report(name: str, metrics, tolerance=None) -> bool:
    """Compare achieved metrics to the published number and print the
    PARITY line.  ``tolerance=None`` reports without gating (dry runs)."""
    if isinstance(metrics, float):   # AVA multi-crop returns the final mAP
        metrics = {'full_map': metrics}
    kind, expected = EXPECTED.get(name, (None, None))
    if kind is None:
        logger.info('No published number for %s; metrics: %s', name, metrics)
        return True
    if kind == 'top1':
        achieved = 100.0 - metrics['err']
    else:
        achieved = metrics['full_map'] * (100.0 if metrics['full_map'] <= 1.0
                                          else 1.0)
    gap = achieved - expected
    ok = tolerance is None or gap >= -tolerance
    status = 'OK' if ok else 'BELOW'
    print('PARITY[{}] {}: achieved {:.2f} vs published {:.2f} ({}{:.2f}) {}'
          .format(status, name, achieved, expected,
                  '+' if gap >= 0 else '', gap,
                  '(dry run: random weights)' if tolerance is None
                  else ('' if ok else '(outside tolerance)')))
    return ok


def _evaluate(cfg, device, output_dir):
    """What one rank of :func:`run_one` runs."""
    return test_net(cfg, output_dir=output_dir, device=device)


def run_one(name: str, config_path: str, params: str, lfb_params: str,
            tolerance: float, opts=None, device='cuda') -> bool:
    """Evaluate one config against its published number on
    ``min(NUM_GPUS, cards)`` ranks.  True = within tolerance (or no
    published number)."""
    overrides = ['TEST.PARAMS_FILE', params]
    if lfb_params:
        overrides += ['LFB.MODEL_PARAMS_FILE', lfb_params]
    cfg = load_config(config_path, overrides + (opts or []))
    metrics = launch.run(functools.partial(_evaluate, output_dir='.'), cfg,
                         device)
    return report(name, metrics, tolerance)


# BASELINE.json §configs: the five-config milestone ladder the parity
# harness must be able to carry the day real weights and datasets arrive.
DRYRUN_CONFIGS = (
    'epic_verb_r50_baseline',
    'epic_verb_r50_lfb_max',
    'charades_r50_lfb_nl',
    'ava_r50_baseline',
    'ava_r101_lfb_nl_3l',
)

# Runtime-only shrink for dry runs: none of these keys change the weight
# manifest (depth, arc, non-local layout, classes and FBO type stay at the
# released values), so the fabricated checkpoints are shaped exactly like
# released ones.
_DRYRUN_SHRINK = {
    'NUM_GPUS': 1,
    'TRAIN': {'BATCH_SIZE': 2, 'VIDEO_LENGTH': 4, 'SAMPLE_RATE': 1},
    'TEST': {'BATCH_SIZE': 2, 'VIDEO_LENGTH': 4, 'SAMPLE_RATE': 1,
             'SCALE': 64, 'CROP_SIZE': 64, 'DATASET_SIZE': 0},
    'LFB': {'WINDOW_SIZE': 2, 'WRITE_LFB': False},
    'CHARADES': {'NUM_TEST_CLIPS_FINAL_EVAL': 6},
    # Exercise the full multi-crop merge on the flagship at one tiny scale
    # (2 flips x 1 scale x 3 shifts, bank re-inferred per flip/scale).
    'AVA': {'TEST_MULTI_CROP_SCALES': [64]},
}


def fabricate_released_weights(cfg, path: str, seed: int = 0) -> None:
    """Write a checkpoint pickle shaped exactly like a released
    ``model_final.pkl`` for ``cfg``: every blob name and shape comes from
    :func:`released_blob_manifest` (a transcription of the reference
    builder's naming rules), the values are small and random."""
    import numpy as np
    rng = np.random.default_rng(seed)
    blobs = {'model_iter': 0, 'lr': np.float32(0.01)}
    for name, shape in released_blob_manifest(cfg).items():
        if name.endswith('_bn_s'):
            arr = 1.0 + 0.05 * rng.standard_normal(shape)
        elif name.endswith('_bn_riv'):
            arr = 1.0 + 0.1 * rng.random(shape)   # variance must be positive
        else:
            arr = 0.05 * rng.standard_normal(shape)
        blobs[name] = arr.astype(np.float32)
    write_pkl(path, {'blobs': blobs})


def dryrun_one(name: str, workdir: str, opts=None, device='cuda') -> bool:
    """Rehearse the full parity path for one config, in this process, with
    manifest-shaped random weights over a synthetic tiny dataset: config
    load -> checkpoint import -> (bank inference for LFB configs) -> eval
    sweep -> metric -> report.  The day real weights arrive, the only
    unknown is the number."""
    sys.path.insert(0, os.path.join(REPO, 'tests'))
    import synthetic

    root = os.path.join(workdir, name)
    os.makedirs(root, exist_ok=True)
    cfg = default_config()
    merge_cfg_from_file(cfg, os.path.join(CONFIG_DIR, name + '.yaml'))

    if cfg.DATASET == 'ava':
        ds = synthetic.build_ava(root, num_classes=cfg.MODEL.NUM_CLASSES)
    elif cfg.DATASET == 'charades':
        ds = synthetic.build_charades(root,
                                      num_classes=cfg.MODEL.NUM_CLASSES)
    else:
        ds = synthetic.build_epic(root, class_type=cfg.EPIC.CLASS_TYPE)
        ds.pop('MODEL')   # keep the released class count (labels are a subset)
    merge_dict_into(cfg, ds)
    merge_dict_into(cfg, _DRYRUN_SHRINK)
    if name == 'ava_r101_lfb_nl_3l':
        # The flagship's published 27.7 is multi-crop: rehearse that path.
        cfg.AVA.TEST_MULTI_CROP = True

    params_file = os.path.join(root, 'model_final.pkl')
    fabricate_released_weights(cfg, params_file, seed=1)
    cfg.TEST.PARAMS_FILE = params_file
    if cfg.LFB.ENABLED:
        lfb_file = os.path.join(root, 'lfb_model.pkl')
        # The released lfb_model.pkl is the frozen baseline model (no FBO
        # head) whose features populate the bank.
        fabricate_released_weights(clone(cfg, {'LFB.ENABLED': False}),
                                   lfb_file, seed=2)
        cfg.LFB.MODEL_PARAMS_FILE = lfb_file
    if opts:
        merge_cfg_from_list(cfg, opts)
    cfg = finalize(cfg)

    metrics = test_net(cfg, output_dir=root, device=device)
    assert metrics is not None, name
    return report(name, metrics, tolerance=None)


def auto_discover(weights_dir: str):
    """Yield (name, params, lfb_params) for every EXPECTED config whose
    released weights exist under ``weights_dir/{name}/`` and whose dataset
    is prepared (config DATADIR present)."""
    for name in sorted(EXPECTED):
        params = os.path.join(weights_dir, name, 'model_final.pkl')
        if not os.path.isfile(params):
            continue
        cfg = load_config(os.path.join(CONFIG_DIR, name + '.yaml'))
        if not os.path.isdir(cfg.DATADIR):
            logger.info('%s: weights present but DATADIR %s missing; skipped',
                        name, cfg.DATADIR)
            continue
        lfb_params = os.path.join(weights_dir, name, 'lfb_model.pkl')
        if cfg.LFB.ENABLED and not os.path.isfile(lfb_params):
            logger.info('%s: LFB config but no lfb_model.pkl; skipped', name)
            continue
        yield name, params, (lfb_params if cfg.LFB.ENABLED else '')


def main(argv=None):
    """Parse ``argv`` (``sys.argv[1:]`` by default) and run the dry runs,
    the auto-discovered configs or the one config asked for."""
    logging.basicConfig(level=logging.INFO, format=FORMAT, stream=sys.stdout)
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument('--config',
                        help='config name (e.g. ava_r50_baseline) or path')
    parser.add_argument('--params',
                        help='released model_final.pkl')
    parser.add_argument('--lfb_params', default='',
                        help='released lfb_model.pkl (LFB configs)')
    parser.add_argument('--auto', default='',
                        help='weights root: run every config with '
                             '{auto}/{name}/model_final.pkl + prepared data')
    parser.add_argument('--dryrun', default='',
                        help='workdir: rehearse the full parity path for '
                             'the BASELINE.json configs (or --config NAME) '
                             'with manifest-shaped random weights over a '
                             'synthetic tiny dataset')
    parser.add_argument('--tolerance', type=float, default=0.5,
                        help='allowed absolute metric gap (default 0.5)')
    parser.add_argument('--device', type=str, default='cuda',
                        help="device to evaluate on ('cuda' or 'cpu')")
    parser.add_argument('opts', default=None, nargs=argparse.REMAINDER)
    args = parser.parse_args(argv)

    if args.dryrun:
        names = [args.config] if args.config else list(DRYRUN_CONFIGS)
        for name in names:
            dryrun_one(name, args.dryrun, args.opts, device=args.device)
        print('DRYRUN SUMMARY: {}/{} paths exercised'.format(
            len(names), len(names)))
        return

    if args.auto:
        found = list(auto_discover(args.auto))
        if not found:
            logger.info('auto mode: no (weights, data) pairs under %s',
                        args.auto)
            return
        results = [run_one(name, os.path.join(CONFIG_DIR, name + '.yaml'),
                           params, lfb, args.tolerance, args.opts,
                           device=args.device)
                   for name, params, lfb in found]
        print('PARITY SUMMARY: {}/{} within tolerance'.format(
            sum(results), len(results)))
        if not all(results):
            sys.exit(1)
        return

    assert args.config and args.params, '--config/--params (or --auto) required'
    name = os.path.splitext(os.path.basename(args.config))[0]
    config_path = (args.config if os.path.isfile(args.config)
                   else os.path.join(CONFIG_DIR, name + '.yaml'))
    if not run_one(name, config_path, args.params, args.lfb_params,
                   args.tolerance, args.opts, device=args.device):
        sys.exit(1)


if __name__ == '__main__':
    main()

"""Test a video model on the card (port of ``tools/test_net.py``, CLI-
compatible with the reference's), including AVA multi-crop testing (2 flips
x 3 scales x 3 spatial shifts).

Usage:
  python -m lfb_tpu_torch.tools.test_net --config_file configs/X.yaml \
      TEST.PARAMS_FILE model.pkl [LFB.MODEL_PARAMS_FILE bank_model.pkl] \
      [--device cuda] [KEY VALUE ...]

It runs data-parallel on ``min(NUM_GPUS, cards)`` ranks
(:mod:`lfb_tpu_torch.parallel.launch`; under ``torchrun`` on its ranks):
each rank sweeps its shard of every batch and rank 0 gathers the outputs
and writes the detections CSVs (AVA) and prediction pickles (EPIC) to
``CHECKPOINT.DIR``.
"""

import argparse
import logging
import os
import sys

import torch

from lfb_tpu_torch.bank.device_bank import shard_bank
from lfb_tpu_torch.bank.lfb import get_lfb
from lfb_tpu_torch.core.config import clone, load_config
from lfb_tpu_torch.data.loader import DataLoader, DeviceFeed, get_input_db
from lfb_tpu_torch.eval.metrics import MetricsCalculator
from lfb_tpu_torch.eval.multicrop import combine_ava_multi_crops
from lfb_tpu_torch.models.model import init_params
from lfb_tpu_torch.models.spec import build_spec
from lfb_tpu_torch.parallel import launch, mesh
from lfb_tpu_torch.train import checkpoints as ckpt
from lfb_tpu_torch.train.steps import make_eval_step

FORMAT = '[%(levelname)s: %(filename)s: %(lineno)4d]: %(message)s'
logger = logging.getLogger(__name__)


def get_test_name(cfg, shift):
    if cfg.DATASET != 'ava':
        return 'final'
    return 'final_%d%s_shift%d_%.03f' % (
        cfg.TEST.SCALE, '_flip' if cfg.AVA.FORCE_TEST_FLIP else '',
        shift, cfg.AVA.DETECTION_SCORE_THRESH)


def test_one_crop(cfg, lfb=None, shift=None, output_dir='.', device='cuda'):
    """One full sweep at one (scale, flip, shift) on ``device`` (reference
    ``test_net.py:96-168``); returns the metrics (None on ranks > 0, which
    sweep their shards and leave the metrics and files to rank 0)."""
    device = torch.device(device)
    cfg = clone(cfg)
    if 'FULL_EVAL' not in cfg.AVA or not cfg.AVA.FULL_EVAL:
        cfg.AVA.FULL_EVAL = True
    if cfg.LFB.ENABLED and lfb is None:
        lfb = get_lfb(cfg, cfg.LFB.MODEL_PARAMS_FILE, is_train=False,
                      device=device)

    if shift is None:
        shift = cfg.TEST.CROP_SHIFT
    split = cfg.TEST.DATA_TYPE or 'val'
    spec = build_spec(cfg, split)

    assert cfg.TEST.PARAMS_FILE, 'No params files specified for testing model.'
    init = init_params(spec, torch.Generator(device=device).manual_seed(
        cfg.RNG_SEED))
    params = ckpt.load_params_into(cfg.TEST.PARAMS_FILE, init,
                                   device=device)[0]

    db = get_input_db(cfg, split, shift=shift, lfb=lfb, device=device)
    loader = DataLoader(db, cfg.TEST.BATCH_SIZE,
                        num_workers=cfg.DATALOADER.NUM_WORKERS,
                        prefetch=cfg.DATALOADER.PREFETCH_BATCHES,
                        seed=cfg.RNG_SEED, is_train=False,
                        rank=mesh.rank(), world=mesh.world_size())
    meter = MetricsCalculator(
        cfg, split, video_idx_to_name=db.video_idx_to_name,
        total_num_boxes=getattr(db, 'num_boxes_used', None),
        num_test_clips=(db.num_test_clips if cfg.DATASET == 'charades' else 1),
        full_eval=True, output_dir=output_dir)
    # Under TPU.DEVICE_BANK the dataset holds the bank on the device and
    # emits no per-example 'lfb' blob; the eval step gathers the windows.
    bank = getattr(db, 'lfb', None)
    if not hasattr(bank, 'gather'):
        bank = None
    if cfg.TPU.BANK_SHARDED:
        bank = shard_bank(bank)
    step = make_eval_step(spec, bank=bank, bank_seed=cfg.RNG_SEED)

    total = loader.num_batches()
    lead = mesh.rank() == 0
    try:
        for i, (_, dev_batch) in enumerate(
                DeviceFeed(loader, device, 'test sweep (shift {})'.format(
                    shift))):
            out = step(params, dev_batch)
            batch = mesh.gather_host(dev_batch, ('labels', 'original_boxes',
                                                 'metadata', 'box_mask'))
            if lead:
                meter.update_test(out['logits'].float().cpu().numpy(),
                                  batch['labels'],
                                  original_boxes=batch.get('original_boxes'),
                                  metadata=batch.get('metadata'),
                                  box_mask=batch.get('box_mask'))
            if (i + 1) % cfg.LOG_PERIOD == 0 or i + 1 == total:
                logger.info('| Test: [%d/%d]', i + 1, total)
    finally:
        loader.shutdown()
    if not lead:
        return None
    metrics = meter.finalize_metrics(name=get_test_name(cfg, shift))
    logger.info('Test results: %s', metrics)
    return metrics


def test_net(cfg, lfb=None, output_dir='.', device='cuda'):
    """Full test flow incl. AVA multi-crop (reference ``test_net.py:48-93``);
    returns the last threshold's metrics, or for multi-crop its final mAP
    (on rank 0 of a data-parallel run; None on the others)."""
    if cfg.DATASET == 'ava':
        results = None
        for threshold in cfg.AVA.DETECTION_SCORE_THRESH_EVAL:
            cfg_t = clone(cfg)
            cfg_t.AVA.DETECTION_SCORE_THRESH = threshold
            if cfg.AVA.TEST_MULTI_CROP:
                cfg_t.LFB.WRITE_LFB = False
                cfg_t.LFB.LOAD_LFB = False
                for flip in (False, True):
                    for scale in cfg.AVA.TEST_MULTI_CROP_SCALES:
                        cfg_c = clone(cfg_t, {
                            'AVA.FORCE_TEST_FLIP': flip,
                            'TEST.SCALE': scale,
                            'TEST.CROP_SIZE': min(256, scale)})
                        crop_lfb = None
                        for shift in range(3):
                            out_name = os.path.join(
                                output_dir, 'detections_%s.csv'
                                % get_test_name(cfg_c, shift))
                            if os.path.isfile(out_name):
                                logger.info('%s already exists.', out_name)
                                continue
                            if cfg_c.LFB.ENABLED and crop_lfb is None:
                                # Bank features are crop-dependent: re-infer
                                # per (flip, scale) (reference
                                # ``test_net.py:80-82``).
                                crop_lfb = get_lfb(
                                    cfg_c, cfg_c.LFB.MODEL_PARAMS_FILE,
                                    is_train=False, device=device)
                            test_one_crop(cfg_c, lfb=crop_lfb, shift=shift,
                                          output_dir=output_dir,
                                          device=device)
                if mesh.rank() == 0:
                    results = combine_ava_multi_crops(cfg_t, output_dir)
                    logger.info('Multi-crop mAP: %s', results)
            else:
                results = test_one_crop(cfg_t, lfb=lfb,
                                        output_dir=output_dir, device=device)
        return results
    if cfg.DATASET == 'charades':
        cfg = clone(cfg)
        cfg.CHARADES.NUM_TEST_CLIPS = cfg.CHARADES.NUM_TEST_CLIPS_FINAL_EVAL
    return test_one_crop(cfg, lfb=lfb, output_dir=output_dir, device=device)


def main(argv=None):
    """Parse ``argv`` (``sys.argv[1:]`` by default), load the config and run
    :func:`test_net` on every rank; returns rank 0's result."""
    logging.basicConfig(level=logging.INFO, format=FORMAT, stream=sys.stdout)
    parser = argparse.ArgumentParser(description='Video model testing')
    parser.add_argument('--config_file', type=str, default=None)
    parser.add_argument('--device', type=str, default='cuda',
                        help="device to test on ('cuda' or 'cpu')")
    parser.add_argument('opts', default=None, nargs=argparse.REMAINDER)
    argv = sys.argv[1:] if argv is None else list(argv)
    if not argv:
        parser.print_help()
        sys.exit(1)
    args = parser.parse_args(argv)

    cfg = load_config(args.config_file, args.opts or [])
    # Artifacts (detections CSVs, prediction pickles) go next to the
    # checkpoints, like the reference's train-time eval outputs.
    os.makedirs(cfg.CHECKPOINT.DIR or '.', exist_ok=True)
    return launch.run(_test_in_rank, cfg, args.device)


def _test_in_rank(cfg, device):
    """What one rank of ``main`` runs."""
    return test_net(cfg, output_dir=cfg.CHECKPOINT.DIR or '.', device=device)


if __name__ == '__main__':
    main()

"""Train a video model on the card (port of ``tools/train_net.py``,
CLI-compatible with the reference's).

Usage:
  python -m lfb_tpu_torch.tools.train_net --config_file configs/X.yaml \
      [--device cuda] [KEY VALUE ...]

With LFB on, it first sweeps the train and val banks with the baseline
model (``LFB.MODEL_PARAMS_FILE``), then trains (``train/trainer.py``:
checkpoints and the train-time eval under ``CHECKPOINT.DIR``), then, with
``TRAIN.TEST_AFTER_TRAIN``, tests the last checkpoint as ``test_net``
does, writing its artifacts next to the checkpoints.

It runs data-parallel on ``min(NUM_GPUS, cards)`` ranks, spawned by
:mod:`lfb_tpu_torch.parallel.launch`, or on the ranks ``torchrun`` starts:
  torchrun --nproc_per_node 8 -m lfb_tpu_torch.tools.train_net ...
Each rank trains on its shard of every ``TRAIN.BATCH_SIZE`` batch; rank 0
writes the checkpoints, the banks' pickles, the logs and the test's files.
"""

import argparse
import logging
import os
import sys

import torch

from lfb_tpu_torch.bank.lfb import get_lfb
from lfb_tpu_torch.core.config import clone, load_config
from lfb_tpu_torch.parallel import launch
from lfb_tpu_torch.tools.test_net import test_net
from lfb_tpu_torch.train.trainer import Trainer

FORMAT = '[%(levelname)s: %(filename)s: %(lineno)4d]: %(message)s'
logger = logging.getLogger(__name__)


def train(cfg, device='cuda'):
    """Sweep the banks, train, and test the last checkpoint on ``device``
    (in a process group, as one of its ranks).  Returns (the last
    checkpoint's path, the test's metrics or None: None on ranks > 0)."""
    device = torch.device(device)
    train_lfb = test_lfb = None
    if cfg.LFB.ENABLED:
        test_lfb = get_lfb(cfg, cfg.LFB.MODEL_PARAMS_FILE, is_train=False,
                           device=device)
        train_lfb = get_lfb(cfg, cfg.LFB.MODEL_PARAMS_FILE, is_train=True,
                            device=device)
        # With cfg.TPU.DEVICE_BANK the datasets convert these host banks
        # into device banks themselves (they own the video-index mapping).

    trainer = Trainer(cfg, train_lfb=train_lfb, test_lfb=test_lfb,
                      device=device)
    last_checkpoint = trainer.train()

    test_metrics = None
    if cfg.TRAIN.TEST_AFTER_TRAIN and last_checkpoint:
        test_cfg = clone(cfg, {'TEST.PARAMS_FILE': last_checkpoint})
        # Artifacts go next to the checkpoints (reference behavior).
        test_metrics = test_net(
            test_cfg, lfb=test_lfb, output_dir=cfg.CHECKPOINT.DIR or '.',
            device=device)
    return last_checkpoint, test_metrics


def main(argv=None):
    """Parse ``argv`` (``sys.argv[1:]`` by default), load the config and run
    :func:`train` on every rank; returns what it returns in rank 0."""
    logging.basicConfig(level=logging.INFO, format=FORMAT, stream=sys.stdout)
    parser = argparse.ArgumentParser(description='Video model training')
    parser.add_argument('--node_id', type=int, default=0)
    parser.add_argument('--config_file', type=str, required=True)
    parser.add_argument('--device', type=str, default='cuda',
                        help="device to train on ('cuda' or 'cpu')")
    parser.add_argument('opts', default=None, nargs=argparse.REMAINDER)
    argv = sys.argv[1:] if argv is None else list(argv)
    if not argv:
        parser.print_help()
        sys.exit(1)
    args = parser.parse_args(argv)

    cfg = load_config(args.config_file, args.opts or [])
    # The banks, checkpoints and eval artifacts go there.
    os.makedirs(cfg.CHECKPOINT.DIR or '.', exist_ok=True)
    return launch.run(train, cfg, args.device)


if __name__ == '__main__':
    main()

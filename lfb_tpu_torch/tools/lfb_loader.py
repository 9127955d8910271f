"""Construct / write / load a long-term feature bank on the card (port of
``tools/lfb_loader.py``, CLI-compatible with the reference's).

Usage:
  python -m lfb_tpu_torch.tools.lfb_loader --config_file configs/X.yaml \
      LFB.MODEL_PARAMS_FILE baseline.pkl LFB.WRITE_LFB True \
      [--splits train,val] [--device cuda] [KEY VALUE ...]

The sweeps run data-parallel on ``min(NUM_GPUS, cards)`` ranks
(:mod:`lfb_tpu_torch.parallel.launch`); rank 0 writes the pickles.
"""

import argparse
import functools
import logging
import sys

from lfb_tpu_torch.bank.lfb import get_lfb
from lfb_tpu_torch.core.config import load_config
from lfb_tpu_torch.parallel import launch

FORMAT = '[%(levelname)s: %(filename)s: %(lineno)4d]: %(message)s'
logger = logging.getLogger(__name__)


def main(argv=None):
    """Parse ``argv`` (``sys.argv[1:]`` by default) and build or load the
    bank of each split; returns {split: bank} (rank 0's)."""
    logging.basicConfig(level=logging.INFO, format=FORMAT, stream=sys.stdout)
    parser = argparse.ArgumentParser(description='LFB construction')
    parser.add_argument('--config_file', type=str, required=True)
    parser.add_argument('--splits', type=str, default='train,val',
                        help='comma-separated: train, val')
    parser.add_argument('--device', type=str, default='cuda',
                        help="device to sweep on ('cuda' or 'cpu')")
    parser.add_argument('opts', default=None, nargs=argparse.REMAINDER)
    args = parser.parse_args(argv)

    cfg = load_config(args.config_file, args.opts or [])
    splits = [split.strip() for split in args.splits.split(',')]
    return launch.run(functools.partial(_sweep, splits=splits), cfg,
                      args.device)


def _sweep(cfg, device, splits):
    """What one rank of ``main`` runs."""
    banks = {}
    for split in splits:
        banks[split] = get_lfb(cfg, cfg.LFB.MODEL_PARAMS_FILE,
                               is_train=split == 'train', device=device)
        logger.info('%s bank: %d videos', split, len(banks[split]))
    return banks


if __name__ == '__main__':
    main()

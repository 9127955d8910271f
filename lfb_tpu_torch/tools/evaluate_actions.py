"""EPIC-Kitchens action evaluation (port of ``tools/evaluate_actions.py``,
CLI-compatible with the reference's): combine the verb and noun prediction
pickles that ``test_net`` writes into action top-k accuracy.

Usage:
  python -m lfb_tpu_torch.tools.evaluate_actions --verb_file verb.pkl \
      --noun_file noun.pkl [--annotation_root data/epic/annotations] \
      [--num_seg N]
"""

import argparse
import logging
import sys

from lfb_tpu_torch.eval.epic_actions import NUM_TEST_SEG, evaluate_actions

FORMAT = '[%(levelname)s: %(filename)s: %(lineno)4d]: %(message)s'


def main(argv=None):
    """Parse ``argv`` (``sys.argv[1:]`` by default) and evaluate; returns
    {'verb_top1', 'noun_top1', 'action_top1', ... top5}, in percent."""
    logging.basicConfig(level=logging.INFO, format=FORMAT, stream=sys.stdout)
    parser = argparse.ArgumentParser(
        description='EPIC-Kitchens Action Evaluation')
    parser.add_argument('--verb_file', type=str, required=True)
    parser.add_argument('--noun_file', type=str, required=True)
    parser.add_argument('--annotation_root', type=str,
                        default='data/epic/annotations')
    parser.add_argument('--num_seg', type=int, default=None,
                        help='Validation segment count (default: the '
                             'official 5,281; override for subsets)')
    args = parser.parse_args(argv)
    return evaluate_actions(args.verb_file, args.noun_file,
                            args.annotation_root,
                            num_seg=(args.num_seg if args.num_seg is not None
                                     else NUM_TEST_SEG))


if __name__ == '__main__':
    main()

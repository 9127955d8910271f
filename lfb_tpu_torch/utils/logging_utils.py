"""Structured run logging (port of ``lfb_tpu/utils/logging_utils.py``): the
reference's ``json_stats`` lines (``lib/utils/metrics.py:566-593`` +
``misc.log_json_stats:82-84``) for dashboard scraping, plus a
parameter-table printer standing in for the reference's per-op shape dump
(``misc.print_net``, ``misc.py:113-147``).

The device memory of a json_stats line is PyTorch's count for the training
device (``torch.cuda.memory_stats``: the bytes allocated now and at the
peak; in a data-parallel run the largest over the ranks), in place of
``lfb_tpu``'s per-TPU ``memory_stats``; a CPU run has no such key.
``nGPU`` is the number of ranks the run uses.
"""

from __future__ import annotations

import json
import logging
from typing import Dict, Mapping, Optional

import torch

from lfb_tpu_torch.parallel import mesh

logger = logging.getLogger(__name__)


def device_memory(device) -> Optional[Dict]:
    """{device index: {'bytes_in_use', 'peak_bytes_in_use'}} of a CUDA
    device (``lfb_tpu``'s keys), None for the CPU.  In a process group
    every rank calls it (one all-reduce) and gets the largest of each count
    over the ranks."""
    device = torch.device(device)
    if device.type != 'cuda':
        return None
    stats = torch.cuda.memory_stats(device)
    counts = mesh.all_max(torch.tensor(
        [stats['allocated_bytes.all.current'],
         stats['allocated_bytes.all.peak']], device=device))
    return {str(device.index or 0): {
        'bytes_in_use': int(counts[0]), 'peak_bytes_in_use': int(counts[1])}}


def get_json_stats_dict(cfg, train_meter, test_meter, curr_iter: int,
                        device='cpu') -> Dict:
    """The json_stats of an eval period; every rank of a process group
    calls it (:func:`device_memory`)."""
    stats = {
        'eval_period': cfg.TRAIN.EVAL_PERIOD,
        'batchSize': cfg.TRAIN.BATCH_SIZE,
        'dataset': cfg.DATASET,
        'num_classes': cfg.MODEL.NUM_CLASSES,
        'momentum': cfg.SOLVER.MOMENTUM,
        'weightDecay': cfg.SOLVER.WEIGHT_DECAY,
        'nGPU': mesh.world_size(),
        'LR': cfg.SOLVER.BASE_LR,
        'bn_momentum': cfg.MODEL.BN_MOMENTUM,
        'currentIter': curr_iter + 1,
    }
    if cfg.TRAIN.DATASET_SIZE:
        stats['epoch'] = curr_iter / (cfg.TRAIN.DATASET_SIZE
                                      / cfg.TRAIN.BATCH_SIZE)
    if train_meter is not None:
        stats['current_learning_rate'] = train_meter.lr
        if train_meter.aggr_batch_size:
            stats['train_loss'] = (train_meter.aggr_loss
                                   / train_meter.aggr_batch_size)
        if not cfg.MODEL.MULTI_LABEL and train_meter.aggr_batch_size:
            stats['train_err'] = (train_meter.aggr_err
                                  / train_meter.aggr_batch_size)
            stats['train_err5'] = (train_meter.aggr_err5
                                   / train_meter.aggr_batch_size)
    if test_meter is not None:
        if cfg.MODEL.MULTI_LABEL:
            stats['test_full_map'] = test_meter.full_map
            stats['test_best_map'] = test_meter.best_map
        else:
            stats['test_err'] = test_meter.avg_err
            stats['test_err5'] = test_meter.avg_err5
            stats['best_err'] = test_meter.best_top1
            stats['best_err5'] = test_meter.best_top5
    mem = device_memory(device)
    if mem:
        stats['device_memory'] = mem
    return stats


def log_json_stats(stats: Dict) -> None:
    logger.info('json_stats: %s', json.dumps(stats, sort_keys=True,
                                             default=float))


def describe_params(params: Mapping[str, torch.Tensor],
                    max_rows: Optional[int] = None) -> str:
    """Name -> shape table of the parameters (for step-0 logging and
    checkpoint-parity inspection)."""
    lines = []
    total = 0
    for i, name in enumerate(sorted(params)):
        shape = tuple(params[name].shape)
        n = params[name].numel()
        total += n
        if max_rows is None or i < max_rows:
            lines.append('{:60s} {!s:>24} {:>12,}'.format(name, shape, n))
    lines.append('{:60s} {:>24} {:>12,}'.format(
        'TOTAL', '({} tensors)'.format(len(params)), total))
    return '\n'.join(lines)

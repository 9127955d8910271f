"""Precise BN: recompute the true-BN running statistics with a forward-only
sweep (port of ``lfb_tpu/train/precise_bn.py``).

Reference: ``lib/utils/bn_helper.py``, where an auxiliary train-mode model
accumulates each BN layer's batch mean and mean of x^2 over
``TRAIN.ITER_COMPUTE_PRECISE_BN`` minibatches and writes the mean and
variance into the running-statistic blobs before an eval or a checkpoint.
Here the train-mode forward returns each layer's batch statistics
('bn_updates'), so the sweep is a plain loop.

Only meaningful with ``MODEL.USE_AFFINE False``: every released config
freezes BN as an affine and sets ``TRAIN.COMPUTE_PRECISE_BN False``.
"""

from __future__ import annotations

import logging
from typing import Dict, Mapping

import torch

from lfb_tpu_torch.models.model import forward
from lfb_tpu_torch.models.spec import ModelSpec
from lfb_tpu_torch.train.steps import (_inject_device_bank_lfb,
                                       _localize_proposals)

logger = logging.getLogger(__name__)


def compute_precise_bn_stats(spec: ModelSpec,
                             params: Mapping[str, torch.Tensor], batches,
                             num_iters: int, bank=None
                             ) -> Dict[str, torch.Tensor]:
    """``params`` with every ``*_bn_rm`` / ``*_bn_riv`` replaced by the
    statistics of ``num_iters`` of ``batches`` (device batches); every other
    entry is the caller's tensor.

    Each batch runs a train-mode forward under ``torch.no_grad()``, its
    bank windows (with ``bank``) and dropout masks drawn from a generator
    seeded 0.  The new ``_rm`` is the mean of the batch means; the new
    ``_riv`` is E[x^2] - E[x]^2 over the batches' var + mean^2, clamped at
    0, in f32 (``bn_helper.py:151-182``).  In a process group each batch is
    the rank's shard and its statistics are the global batch's, so every
    rank returns the same values; the ranks must run the same number of
    batches (the forward's collectives, and a row-sharded bank's gathers,
    need every rank)."""
    assert not spec.use_affine, 'precise BN is meaningless in affine mode'
    sums: Dict[str, torch.Tensor] = {}
    sq_sums: Dict[str, torch.Tensor] = {}
    count = 0
    with torch.no_grad():
        for i, batch in enumerate(batches):
            if i >= num_iters:
                break
            generator = torch.Generator(device=batch['data'].device)
            generator.manual_seed(0)
            batch = _localize_proposals(batch)
            batch = _inject_device_bank_lfb(spec, bank, batch, generator)
            out = forward(spec, params, batch, train=True,
                          generator=generator)
            for name, (mean, var) in out['bn_updates'].items():
                sq = var + mean ** 2            # E[x^2] of the batch
                if name not in sums:
                    sums[name], sq_sums[name] = mean.clone(), sq
                else:
                    sums[name] += mean
                    sq_sums[name] += sq
            count += 1
    assert count > 0, 'no batches for precise BN'

    new_params = dict(params)
    for name, total in sums.items():
        mean = total / count
        new_params[name + '_rm'] = mean
        new_params[name + '_riv'] = torch.clamp(
            sq_sums[name] / count - mean ** 2, min=0)
    logger.info('Precise BN: updated %d layers over %d iterations',
                len(sums), count)
    return new_params

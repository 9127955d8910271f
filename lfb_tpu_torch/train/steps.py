"""Eval step (port of ``lfb_tpu/train/steps.py:make_eval_step`` and
``_inject_device_bank_lfb``), single device.  Training steps are not ported
yet."""

from __future__ import annotations

from typing import Dict, Mapping

import torch

from lfb_tpu_torch.models.model import forward
from lfb_tpu_torch.models.spec import ModelSpec

_OUTPUTS = ('prob', 'logits', 'pool5', 'box_pooled')


def _inject_device_bank_lfb(spec: ModelSpec, bank, batch,
                            generator: torch.Generator):
    """Gather the 'lfb' bank windows on the device when a device bank is in
    play; AVA windows key off the metadata blob's (video_idx, sec) columns."""
    if bank is None or not spec.fbo.enabled or 'lfb' in batch:
        return batch
    if spec.head_type != 'roi':
        raise NotImplementedError('frame-level device banks are not ported yet')
    batch = dict(batch)
    meta = batch['metadata']
    batch['lfb'] = bank.gather(meta[:, 0].long(), meta[:, 1].long(), generator)
    return batch


def make_eval_step(spec: ModelSpec, bank=None, bank_seed: int = 0):
    """The eval / bank-extraction step: (params, batch) -> outputs
    ('prob', 'logits', 'pool5' or 'box_pooled').  As in ``lfb_tpu``, every
    call draws its bank windows from a generator seeded with ``bank_seed``."""

    def step(params: Mapping[str, torch.Tensor],
             batch: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        generator = None
        if bank is not None:
            generator = torch.Generator(device=bank.feats.device)
            generator.manual_seed(bank_seed)
        with torch.inference_mode():
            batch = _inject_device_bank_lfb(spec, bank, batch, generator)
            out = forward(spec, params, batch)
        return {k: out[k] for k in _OUTPUTS if k in out}

    return step

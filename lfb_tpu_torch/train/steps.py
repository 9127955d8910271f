"""Train and eval steps (port of ``lfb_tpu/train/steps.py``:
``make_train_step``'s single-device branch, ``make_eval_step``,
``split_params`` and ``_inject_device_bank_lfb``), one device."""

from __future__ import annotations

from typing import Dict, Mapping

import torch

from lfb_tpu_torch.models.model import forward, frozen_param_names
from lfb_tpu_torch.models.spec import ModelSpec
from lfb_tpu_torch.train import optimizer as opt

_OUTPUTS = ('prob', 'logits', 'pool5', 'box_pooled')


def split_params(spec: ModelSpec, params: Mapping[str, torch.Tensor]):
    """(trainable, frozen) dicts of ``params`` by
    :func:`~lfb_tpu_torch.models.model.frozen_param_names`."""
    frozen_names = frozen_param_names(spec, params)
    trainable = {k: v for k, v in params.items() if k not in frozen_names}
    frozen = {k: v for k, v in params.items() if k in frozen_names}
    return trainable, frozen


def _inject_device_bank_lfb(spec: ModelSpec, bank, batch,
                            generator: torch.Generator):
    """Gather the 'lfb' bank windows on the device when a device bank is in
    play.  AVA windows key off the metadata blob's (video_idx, sec) columns;
    the clip-level datasets give (lfb_video_idx, lfb_center) pairs."""
    if bank is None or not spec.fbo.enabled or 'lfb' in batch:
        return batch
    batch = dict(batch)
    if spec.head_type == 'roi':
        meta = batch['metadata']
        batch['lfb'] = bank.gather(meta[:, 0].long(), meta[:, 1].long(),
                                   generator)
    else:
        batch['lfb'] = bank.gather_centers(batch['lfb_video_idx'],
                                           batch['lfb_center'])
    return batch


def make_train_step(spec: ModelSpec, solver, bank=None):
    """The train step: forward (train mode, with dropout), the loss,
    backward, and Caffe2 momentum SGD (``solver`` is cfg.SOLVER).

    The returned fn is
      (trainable, frozen, mstate, batch, generator, lr) ->
          (trainable, frozen, mstate, {'loss', 'prob'})
    as in ``lfb_tpu``.  ``generator`` (on the batch's device) draws the bank
    windows, then the dropout masks.  The trainable params and the momentum
    buffers are updated in place and returned; the batch needs 'labels'.
    """
    momentum = float(solver.MOMENTUM)
    nesterov = bool(solver.NESTEROV)
    wd = float(solver.WEIGHT_DECAY)
    wd_bn = float(solver.WEIGHT_DECAY_BN)

    def step(trainable: Dict[str, torch.Tensor],
             frozen: Dict[str, torch.Tensor], mstate: opt.SGDState,
             batch: Mapping[str, torch.Tensor], generator: torch.Generator,
             lr: float):
        batch = _inject_device_bank_lfb(spec, bank, batch, generator)
        names = list(trainable)
        # Aliases of the caller's tensors that record the graph; the update
        # below writes through to the caller's tensors.
        leaves = {k: trainable[k].detach().requires_grad_(True) for k in names}
        out = forward(spec, {**leaves, **frozen}, batch, train=True,
                      generator=generator)
        grads = dict(zip(names, torch.autograd.grad(
            out['loss'], [leaves[k] for k in names])))
        trainable, mstate = opt.apply_updates(
            trainable, grads, mstate, lr=lr, momentum=momentum,
            nesterov=nesterov, weight_decay=wd, weight_decay_bn=wd_bn)
        aux = {'loss': out['loss'].detach(), 'prob': out['prob'].detach()}
        return trainable, frozen, mstate, aux

    return step


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

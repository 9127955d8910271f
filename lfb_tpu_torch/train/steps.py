"""Train and eval steps (port of ``lfb_tpu/train/steps.py``:
``make_train_step``, ``make_eval_step``, ``split_params``,
``_inject_device_bank_lfb`` and ``_localize_proposals``).

In a process group (:mod:`lfb_tpu_torch.parallel.mesh`) each rank runs the
step on its shard of the global batch, as ``lfb_tpu``'s shard_map body runs
on each device, and the ranks exchange what the mesh exchanged: the loss's
denominator and the gradients are summed, the outputs gathered into the
global batch's order.  Without a group the same code runs on one device and
every exchange is the identity.  ``TPU.SHARD_MAP`` therefore changes
nothing here: every rank always runs the per-device body.

Under a profiler each step is the span ``lfb.step.eval`` or
``lfb.step.train`` (:mod:`lfb_tpu_torch.utils.profiling`), with the bank
gather (``lfb.bank.gather``) and, in training, the loss, the backward, the
optimizer and the BN statistics' update as spans inside it.
"""

from __future__ import annotations

from typing import Dict, Mapping

import torch

from lfb_tpu_torch.models.model import forward, frozen_param_names, loss_parts
from lfb_tpu_torch.models.spec import ModelSpec
from lfb_tpu_torch.parallel import mesh
from lfb_tpu_torch.train import optimizer as opt
from lfb_tpu_torch.utils.profiling import count, span

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
    with span('lfb.bank.gather'):
        if spec.head_type == 'roi':
            meta = batch['metadata']
            lfb = bank.gather(meta[:, 0].long(), meta[:, 1].long(),
                              generator)
        else:
            lfb = bank.gather_centers(batch['lfb_video_idx'],
                                      batch['lfb_center'])
    count('bank.rows', lfb.shape[0] * lfb.shape[1])
    count('bank.bytes', lfb.numel() * lfb.element_size())
    batch['lfb'] = lfb
    return batch


def _localize_proposals(batch):
    """A rank's AVA proposal rows carry global clip indices; shift them to
    the rank's own clips.  A padding row (zeros, ``box_mask`` 0) names clip
    0, so on rank r > 0 it names clip -r*b: the RoI kernel and its plain
    version clamp it to clip 0, as ``lfb_tpu``'s gather does."""
    offset = mesh.rank() * batch['data'].shape[0]
    if 'proposals' not in batch or offset == 0:
        return batch
    batch = dict(batch)
    proposals = batch['proposals'].clone()
    proposals[:, 0] -= offset
    batch['proposals'] = proposals
    return batch


def _loss(spec: ModelSpec, logits, batch):
    """(the rank's part of the global mean loss, the global denominator):
    the numerator over max(the denominator summed over the ranks, 1), as
    ``lfb_tpu``'s shard_map step forms it.  The sum of the ranks' parts
    (and of their gradients) is the global loss (and its gradient), with no
    1/world factor: a mean of per-rank means would weight a box by the
    number of valid boxes on its rank."""
    num, den = loss_parts(spec, logits, batch['labels'],
                          batch.get('box_mask'))
    den = mesh.all_sum(den.detach().clone())
    return num / torch.clamp(den, min=1.0), den


def make_train_step(spec: ModelSpec, solver, bank=None):
    """The train step: forward (train mode, with dropout), the loss,
    backward, and Caffe2 momentum SGD (``solver`` is cfg.SOLVER).

    The returned fn is
      (trainable, frozen, mstate, batch, generator, lr) ->
          (trainable, frozen, mstate, {'loss', 'prob'})
    as in ``lfb_tpu``.  ``generator`` (on the batch's device) draws the bank
    windows, then the dropout masks.  The trainable params and the momentum
    buffers are updated in place and returned; the batch needs 'labels'.
    In a process group the batch is the rank's shard, the gradients are
    summed over the ranks (one flat all-reduce), every rank makes the same
    update, and 'loss' is the global loss and 'prob' the global batch's.

    With true BN the forward's batch statistics then move the running ones
    in ``frozen``, in place, as ``lfb_tpu/train/steps.py:216-226``: with m
    = ``MODEL.BN_MOMENTUM``, ``_rm <- m * _rm + (1 - m) * mean`` and
    ``_riv <- m * _riv + (1 - m) * var`` (the population variance).  In a
    process group the statistics are the global batch's, so every rank
    writes the same values.
    """
    momentum = float(solver.MOMENTUM)
    nesterov = bool(solver.NESTEROV)
    wd = float(solver.WEIGHT_DECAY)
    wd_bn = float(solver.WEIGHT_DECAY_BN)
    bn_momentum = float(spec.bn_momentum)

    def step(trainable: Dict[str, torch.Tensor],
             frozen: Dict[str, torch.Tensor], mstate: opt.SGDState,
             batch: Mapping[str, torch.Tensor], generator: torch.Generator,
             lr: float):
        with span('lfb.step.train'):
            batch = _localize_proposals(batch)
            batch = _inject_device_bank_lfb(spec, bank, batch, generator)
            names = list(trainable)
            # Aliases of the caller's tensors that record the graph; the
            # update below writes through to the caller's tensors.
            leaves = {k: trainable[k].detach().requires_grad_(True)
                      for k in names}
            out = forward(spec, {**leaves, **frozen},
                          {k: v for k, v in batch.items() if k != 'labels'},
                          train=True, generator=generator)
            with span('lfb.step.loss'):
                loss, _ = _loss(spec, out['logits'], batch)
            with span('lfb.step.backward'):
                grads = torch.autograd.grad(loss, [leaves[k] for k in names])
                mesh.all_sum_flat(grads)
            with span('lfb.train.optimizer'):
                trainable, mstate = opt.apply_updates(
                    trainable, dict(zip(names, grads)), mstate, lr=lr,
                    momentum=momentum, nesterov=nesterov, weight_decay=wd,
                    weight_decay_bn=wd_bn)
            with span('lfb.step.bn_update'), torch.no_grad():
                for name, stats in out.get('bn_updates', {}).items():
                    for suffix, stat in zip(('_rm', '_riv'), stats):
                        running = frozen[name + suffix]
                        running.copy_(bn_momentum * running
                                      + (1.0 - bn_momentum) * stat)
            aux = {'loss': mesh.all_sum(loss.detach()),
                   'prob': mesh.gather_rows(out['prob'].detach())}
            return trainable, frozen, mstate, aux

    return step


def make_eval_step(spec: ModelSpec, bank=None, bank_seed: int = 0,
                   with_loss: bool = False):
    """The eval / bank-extraction step: (params, batch) -> outputs
    ('prob', 'logits', 'pool5' or 'box_pooled', and with ``with_loss`` and
    labels in the batch, 'loss').  As in ``lfb_tpu``, every call draws its
    bank windows from a generator seeded with ``bank_seed``.  In a process
    group the outputs are gathered into the global batch's order and
    'loss' is the global mean."""

    def step(params: Mapping[str, torch.Tensor],
             batch: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        with span('lfb.step.eval'):
            generator = None
            if bank is not None:
                generator = torch.Generator(device=bank.feats.device)
                generator.manual_seed(bank_seed)
            with torch.inference_mode():
                batch = _localize_proposals(batch)
                batch = _inject_device_bank_lfb(spec, bank, batch, generator)
                out = forward(spec, params, {k: v for k, v in batch.items()
                                             if k != 'labels'})
                keep = {k: mesh.gather_rows(out[k]) for k in _OUTPUTS
                        if k in out}
                if with_loss and 'labels' in batch:
                    keep['loss'] = _loss(spec, out['logits'], batch)[0]
                    mesh.all_sum(keep['loss'])
            return keep

    return step

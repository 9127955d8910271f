"""The rank side of ``tests/test_torch_parallel.py``: what each of the
spawned gloo ranks runs on the CPU.  It imports ``torch`` and the port only
(no ``jax``, so the ranks start fast), reads the inputs the test wrote, and
writes each rank's results to ``rank<r>.pkl`` beside them.

Cases:

* ``train``: two steps of ``make_train_step`` on the rank's shard of a
  global batch whose halves hold different numbers of valid boxes, with
  host windows ('lfb' in the batch) and dropout off.
* ``eval``: ``make_eval_step`` (with and without ``with_loss``) on the
  rank's shard of an AVA batch with padding rows.
* ``banks``: the train step and the eval step with a device bank, once
  replicated and once row-sharded by ``shard_bank``, AVA and frame-level
  (Charades), dropout and window draws on: everything must be bitwise equal.
* ``true_bn`` (``tests/test_torch_true_bn.py``): a true-BN train step from
  each of the states the test gives (all-BN and mixed), whose batch
  statistics are the global batch's, with every rank's params, momentum
  and running statistics checked the same (``mesh.check_same``); then
  ``compute_precise_bn_stats`` over the rank's shards of two global
  batches.

``main`` runs the cases its caller names.  :func:`tf32_flags` is a rank's
``fn`` under ``lfb_tpu_torch.parallel.launch.run``
(``tests/test_torch_bank_rehearsal.py``).
"""

import copy
import pickle

import numpy as np
import torch

from lfb_tpu_torch.bank.device_bank import (AvaDeviceBank, FrameDeviceBank,
                                            shard_bank)
from lfb_tpu_torch.config import charades_cfg, flagship_cfg
from lfb_tpu_torch.convert import params_from_jax
from lfb_tpu_torch.models.spec import build_spec
from lfb_tpu_torch.parallel import mesh
from lfb_tpu_torch.train import optimizer as opt
from lfb_tpu_torch.train.precise_bn import compute_precise_bn_stats
from lfb_tpu_torch.train.steps import (make_eval_step, make_train_step,
                                       split_params)

LRS = (0.01, 0.02)


def tensors(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in batch.items()}


def numpy(d):
    return {k: v.detach().float().numpy().copy() for k, v in d.items()}


def run_steps(spec, solver, params, batch, bank=None, seeds=(0, 1)):
    """``make_train_step`` from ``params`` over the rank's shard of
    ``batch`` once per seed (the steps' LRs :data:`LRS`): (losses, probs,
    trainable, momentum)."""
    train, frozen = split_params(spec, copy.deepcopy(params))
    state = opt.init_state({**train, **frozen}, set(frozen))
    step = make_train_step(spec, solver, bank=bank)
    local = tensors(mesh.shard_batch(batch, mesh.rank(), mesh.world_size()))
    losses, probs = [], []
    for seed, lr in zip(seeds, LRS):
        gen = torch.Generator().manual_seed(mesh.step_seed(seed))
        train, frozen, state, aux = step(train, frozen, state, local, gen, lr)
        losses.append(aux['loss'].item())
        probs.append(aux['prob'].numpy().copy())
    return losses, probs, train, state.momentum


def case_train(inp):
    cfg = flagship_cfg(inp['cfg'])
    spec = build_spec(cfg, 'train')
    params = params_from_jax(inp['params'], device='cpu')
    losses, probs, train, momentum = run_steps(spec, cfg.SOLVER, params,
                                               inp['batch'])
    return {'losses': losses, 'probs': probs, 'params': numpy(train),
            'momentum': numpy(momentum)}


def case_eval(inp):
    cfg = flagship_cfg(inp['cfg'])
    spec = build_spec(cfg, 'val')
    params = params_from_jax(inp['eval_params'], device='cpu')
    local = tensors(mesh.shard_batch(inp['eval_batch'], mesh.rank(),
                                     mesh.world_size()))
    out = make_eval_step(spec)(params, {k: v for k, v in local.items()
                                        if k != 'labels'})
    with_loss = make_eval_step(spec, with_loss=True)(params, local)
    return {'out': numpy(out), 'loss': with_loss['loss'].item(),
            'prob_with_loss': with_loss['prob'].numpy().copy()}


def bank_pair(make, spec, solver, params, batch):
    """The train step (two steps) and the eval step with the bank ``make()``
    builds, replicated and then sharded: the two runs' results."""
    runs = []
    for shard in (False, True):
        bank = make()
        if shard:
            rows = bank.feats.shape[0]
            bank = shard_bank(bank)
            assert shard_bank(bank) is bank
            assert shard_bank(bank.inner) is bank and bank.inner.feats is None
            assert bank.feats.shape[0] == -(-rows // mesh.world_size())
        losses, probs, train, momentum = run_steps(spec, solver, params,
                                                   batch, bank=bank)
        local = tensors(mesh.shard_batch(batch, mesh.rank(),
                                         mesh.world_size()))
        ev = make_eval_step(spec, bank=bank, bank_seed=7)(
            {**params, **train}, {k: v for k, v in local.items()
                                  if k != 'labels'})
        runs.append({'losses': losses, 'probs': probs, 'params': train,
                     'momentum': momentum, 'eval': ev})
    return runs


def bitwise(runs):
    """{what: bitwise equal} of the replicated and the sharded runs."""
    rep, sh = runs
    out = {'losses': rep['losses'] == sh['losses'],
           'probs': all(np.array_equal(a, b)
                        for a, b in zip(rep['probs'], sh['probs']))}
    for key in ('params', 'momentum', 'eval'):
        out[key] = all(torch.equal(rep[key][k], sh[key][k]) for k in rep[key])
    return out


def case_banks(inp):
    results = {}
    cfg = flagship_cfg(inp['bank_cfg'])
    spec = build_spec(cfg, 'train')
    params = params_from_jax(inp['bank_params'], device='cpu')
    runs = bank_pair(lambda: AvaDeviceBank.build(
        inp['ava_bank'], window_size=cfg.LFB.WINDOW_SIZE,
        k=cfg.AVA.LFB_MAX_NUM_FEAT_PER_STEP, lfb_dim=cfg.LFB.LFB_DIM,
        device='cpu'), spec, cfg.SOLVER, params, inp['ava_batch'])
    results['ava'] = bitwise(runs)
    results['ava finite'] = bool(np.isfinite(runs[1]['losses']).all())

    cfg = charades_cfg(inp['charades_cfg'])
    spec = build_spec(cfg, 'train')
    params = params_from_jax(inp['charades_params'], device='cpu')
    runs = bank_pair(lambda: FrameDeviceBank.build(
        inp['frame_bank'], window_size=cfg.LFB.WINDOW_SIZE,
        lfb_dim=cfg.LFB.LFB_DIM, window_mode='charades',
        fps=cfg.CHARADES.FPS,
        clips_per_second=cfg.CHARADES.LFB_CLIPS_PER_SECOND, device='cpu'),
        spec, cfg.SOLVER, params, inp['charades_batch'])
    results['frame'] = bitwise(runs)
    return results


def case_true_bn(inp):
    results = {}
    for mode, overrides in inp['true_bn_modes'].items():
        cfg = flagship_cfg({**inp['cfg'], **overrides})
        step = make_train_step(build_spec(cfg, 'train'), cfg.SOLVER)
        local = tensors(mesh.shard_batch(inp['batch'], mesh.rank(),
                                         mesh.world_size()))
        for k, (state, lr) in enumerate(zip(inp['true_bn_states'][mode],
                                            inp['true_bn_lrs'])):
            train, frozen, momentum = (params_from_jax(d, device='cpu')
                                       for d in state)
            train, frozen, mstate, aux = step(
                train, frozen, opt.SGDState(momentum=momentum), local,
                torch.Generator().manual_seed(mesh.step_seed(k)), lr)
            mesh.check_same({**train, **frozen, **{
                'momentum ' + n: v for n, v in mstate.momentum.items()}},
                'the true-BN step\'s params, momentum and running '
                'statistics')
            results[mode, k] = {
                'loss': aux['loss'].item(), 'prob': aux['prob'].numpy().copy(),
                'params': numpy(train), 'momentum': numpy(mstate.momentum),
                'frozen': numpy(frozen)}
    cfg = flagship_cfg({**inp['cfg'], **inp['true_bn_modes']['all']})
    spec = build_spec(cfg, 'train')
    params = params_from_jax(inp['true_bn_params']['all'], device='cpu')
    new = compute_precise_bn_stats(
        spec, params, [tensors(mesh.shard_batch(b, mesh.rank(),
                                                mesh.world_size()))
                       for b in inp['precise_bn_batches']], 2)
    stats = {k: v for k, v in new.items() if k.endswith(('_rm', '_riv'))}
    mesh.check_same(stats, 'the precise BN statistics')
    results['precise_bn'] = numpy(stats)
    return results


CASES = {'train': case_train, 'eval': case_eval, 'banks': case_banks,
         'true_bn': case_true_bn}


def tf32_flags(cfg, device):
    """Every rank's (``torch.backends.cuda.matmul.allow_tf32``,
    ``torch.backends.cudnn.allow_tf32``), in rank order."""
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    if not mesh.distributed():
        return [flags]
    out = [None] * mesh.world_size()
    torch.distributed.all_gather_object(out, flags)
    return out


def main(rank, world, root, cases):
    # Two ranks of several intra-op threads each, beside the suite's other
    # workers, spend their time spinning: 2 steps take 20 s, not 2.
    torch.set_num_threads(2)
    mesh.init_distributed('cpu', world=world, rank=rank,
                          init_method='file://{}/store'.format(root))
    try:
        with open('{}/inputs.pkl'.format(root), 'rb') as f:
            inp = pickle.load(f)
        torch.manual_seed(0)
        out = {name: CASES[name](inp) for name in cases}
        with open('{}/rank{}.pkl'.format(root, rank), 'wb') as f:
            pickle.dump(out, f)
    finally:
        torch.distributed.destroy_process_group()

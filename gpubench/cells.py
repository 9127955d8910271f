"""The two kinds of cell: the program under test driven through its step
factories, and the comparison of what the timed path produced with the
plain reference.

``two_phase``: each iteration is one phase-A batch through
``make_eval_step`` of the bank-extraction spec and then one phase-B batch
through ``make_eval_step`` of the full spec over the resident bank.  The
window keeps the outputs of a few iterations drawn from the seed and of
the last one; afterwards the reference computes the same batches again.

``train``: set-up builds one train step (``make_train_step``) with its
weights, momentum and generator, runs its first three steps through the
window's own call on the first three batches, and reads what the
comparison needs: each step's loss, the first step's logits (from the
'prob' the step returns) and gradient as the optimizer got it (the
momentum after one step over the learning rate), and each parameter's
change over the three.  The window goes on with the same objects.
Afterwards the reference runs the three steps from the same weights,
batches and draws.

Which numbers a cell compares, and their limits, are its
``limits/<cell>.json``.  What belongs to the configuration's dataset (the
bank's tables, a batch's keys, the windows, the loss) and to its
reference network (the architecture, the launch lists) comes from the
modules its file names (:mod:`gpubench.layout`).
"""

from __future__ import annotations

import gc
import time
from typing import Dict, List

import numpy as np
import torch

from gpubench import bank as bankmod
from gpubench import layout, seeds, traffic, weights
from gpubench.cost import flops as flopcount
from gpubench.cost import kernels as kcost
from gpubench.reference import train as reftrain

REFERENCE_BLOCK = 4          # clips through the reference's backbone at once


def port_config(cell: layout.Cell):
    """The port's config: the released YAML through its ``load_config``,
    the configuration's and the traffic mix's overrides as command-line
    overrides; every key of the ``model`` block must read as written."""
    from lfb_tpu_torch.core.config import load_config
    opts = []
    for key, value in {**cell.config['overrides'],
                       **cell.traffic['overrides']}.items():
        opts += [key, repr(value)]
    cfg = load_config(str(layout.released_yaml(cell.config, cell.here)), opts)
    for key, want in cell.config['model'].items():
        node = cfg
        for part in key.split('.'):
            node = node[part]
        got = list(node) if isinstance(node, (list, tuple)) else node
        if got != want:
            raise ValueError('config {}: {} reads {!r}, the benchmark\'s '
                             'reference models {!r}'.format(
                                 cell.config['name'], key, got, want))
    return cfg


def first_lr(model: dict) -> float:
    """The released schedule's learning rate at iteration 0."""
    if model['SOLVER.WARMUP.WARMUP_ON']:
        return float(model['SOLVER.WARMUP.WARMUP_START_LR'])
    return float(model['SOLVER.BASE_LR']) * float(model['SOLVER.LRS'][0])


def rel_rows(got: torch.Tensor, ref: torch.Tensor) -> float:
    """The largest row-wise relative L2 gap."""
    got, ref = got.float(), ref.float()
    gap = (got - ref).norm(dim=-1) / ref.norm(dim=-1).clamp(min=1e-30)
    return float(gap.max())


def leaf_gaps(got: Dict[str, float], ref: Dict[str, float],
              names: List[str]) -> Dict[str, float]:
    """Each leaf's gap between two norms, over the larger of the
    reference leaf's norm and the median leaf's."""
    median = float(np.median([ref[n] for n in names]))
    return {n: abs(got[n] - ref[n]) / max(ref[n], median, 1e-30)
            for n in names}


class Driver:
    """What both kinds share: the config, weights, bank and batches, the
    dataset's two sides and the reference network."""

    def __init__(self, cell: layout.Cell, seed: int, device):
        self.cell, self.seed = cell, seed
        self.device = torch.device(device)
        self.model = cell.config['model']
        self.split = cell.traffic['split']
        self.cfg = port_config(cell)
        self.dataset = cell.dataset
        self.ref_dataset = cell.reference_dataset
        self.net = cell.network
        self.launches = cell.launches
        self.dispatch_s = 0.0
        self.calls = 0
        self.marks = []

    def mark(self, what: str):
        """Note the host clock at a point of set-up."""
        self.sync()
        self.marks.append((what, time.perf_counter()))

    def sync(self):
        if self.device.type == 'cuda':
            torch.cuda.synchronize(self.device)

    def weights(self, arch) -> Dict[str, torch.Tensor]:
        return weights.draw(self.net.param_specs(arch),
                            seeds.derive(self.seed, 'weights'), self.device)

    def make_bank(self):
        self.bank = bankmod.build(
            self.dataset, self.model,
            self.cell.config['bank'][self.cell.traffic['bank']],
            self.seed, self.device)

    def batch(self, index: int, labels: bool):
        return traffic.make_batch(self.dataset, self.cell.config, self.split,
                                  self.bank, self.seed, index, self.device,
                                  labels=labels)

    def timed(self, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        self.dispatch_s += time.perf_counter() - t
        self.calls += 1
        return out

    def window_rows(self, host, generator) -> torch.Tensor:
        """The reference's bank rows of every row of a batch (drawn from
        ``generator`` where the program's are drawn)."""
        return self.ref_dataset.window_rows(
            self.bank.tables, host, self.model, zero=self.bank.zero,
            generator=generator)

    def real(self, host) -> torch.Tensor:
        """A batch's real rows (AVA's boxes, or every clip)."""
        return self.dataset.real(host, self.clips, self.device)

    def release(self):
        gc.collect()
        if self.device.type == 'cuda':
            torch.cuda.empty_cache()


class TwoPhase(Driver):
    kind = 'two_phase'

    def prepare(self):
        """The benchmark's inputs: the bank, the batches, the kept
        iterations."""
        self.arch_a = self.net.Arch(self.model, 'test', infer_only=True)
        self.arch_b = self.net.Arch(self.model, 'test')
        self.make_bank()
        self.bank_seed = seeds.derive(self.seed, 'bank_seed')
        self.pool_size = self.cell.traffic['pool']
        self.pool = [self.batch(i, labels=False)
                     for i in range(self.pool_size)]
        self.clips = self.arch_b.clips
        rng = seeds.rng(self.seed, 'compare')
        self.compare = sorted(int(i) for i in rng.choice(
            8, self.cell.traffic['compare_iterations'], replace=False))

    def setup(self):
        from lfb_tpu_torch.models.spec import build_spec
        from lfb_tpu_torch.train import steps
        self.mark('port imported')
        self.prepare()
        self.mark('bank and batches')
        self.params = self.weights(self.arch_b)
        port_bank = self.dataset.port_bank(self.bank, self.model)
        self.step_a = steps.make_eval_step(
            build_spec(self.cfg, 'test', lfb_infer_only=True))
        self.step_b = steps.make_eval_step(
            build_spec(self.cfg, 'test'), bank=port_bank,
            bank_seed=self.bank_seed)
        self.kept = {}
        self.last = None
        self.mark('weights and steps')
        for i in range(2):          # every shape once, then steady
            self.iterate(i, record=False)
        self.mark('warm-up')
        self.dispatch_s, self.calls = 0.0, 0

    def batches(self, i: int):
        """(phase A's, phase B's) (batch, host) of iteration ``i``."""
        return (self.pool[i % self.pool_size],
                self.pool[(i + 1) % self.pool_size])

    def iterate(self, i: int, record: bool = True):
        (batch_a, _), (batch_b, _) = self.batches(i)
        a = self.timed(self.step_a, self.params, batch_a)
        b = self.timed(self.step_b, self.params, batch_b)
        if record:
            outs = (a[self.dataset.PHASE_A_OUTPUT], b['logits'])
            self.last = (i, outs)
            if i in self.compare:
                self.kept[i] = outs

    def free(self):
        """Drop the program; keep the kept iterations' real rows."""
        kept = dict(self.kept)
        if self.last is not None:
            kept[self.last[0]] = self.last[1]
        self.outputs = {}
        for i, (a, logits) in kept.items():
            (_, host_a), (_, host_b) = self.batches(i)
            self.outputs[i] = (a[self.real(host_a)], logits[self.real(host_b)])
        del self.step_a, self.step_b, self.params, self.kept, self.last, kept
        self.release()

    def kernel_calls(self, iterations: List[int]) -> List[kcost.Call]:
        remat = self.model['TPU.REMAT']
        fused = bool(self.cell.traffic['overrides'].get(
            'TPU.PALLAS_BOTTLENECK', False))
        calls = []
        for i in iterations:
            for arch, (_, host) in zip((self.arch_a, self.arch_b),
                                       self.batches(i)):
                calls += self.launches.backbone_calls(
                    arch, self.clips, train=False, fused=fused, remat=remat)
                rois = host.get('rois')
                calls += self.launches.head_calls(arch, rois, self.clips,
                                                  train=False)
                if arch is self.arch_b:
                    rows = rois.shape[0] if rois is not None else self.clips
                    calls += self.launches.fbo_calls(arch, rows, train=False)
        return calls

    def flops_per_iteration(self) -> float:
        return flopcount.two_phase(self.net, self.model, self.clips,
                                   self.cell.config['batch'].get(
                                       'boxes_per_clip', 1))

    def reference_outputs(self, iterations, quant=None):
        """{iteration: (phase A's real rows, phase B's real logits)} of the
        reference (``quant``: rounded as the control is)."""
        params = self.weights(self.arch_b)
        out = {}
        for i in iterations:
            (batch_a, host_a), (batch_b, host_b) = self.batches(i)
            out[i] = (self._reference_batch(params, batch_a, host_a, False,
                                            quant),
                      self._reference_batch(params, batch_b, host_b, True,
                                            quant))
        return out

    def reference(self) -> Dict[str, float]:
        """The compared numbers: the worst row's relative gap of phase A's
        features ('a_row') and of phase B's logits ('b_row') over the real
        rows of the kept iterations."""
        ref = self.reference_outputs(sorted(self.outputs))
        worst = {'a_row': 0.0, 'b_row': 0.0}
        for i, (a, logits) in self.outputs.items():
            worst['a_row'] = max(worst['a_row'], rel_rows(a, ref[i][0]))
            worst['b_row'] = max(worst['b_row'], rel_rows(logits, ref[i][1]))
        return worst

    def _reference_batch(self, params, batch, host, phase_b, quant):
        arch = self.arch_b if phase_b else self.arch_a
        data, real = batch['data'], self.real(host)
        with torch.no_grad():
            if arch.roi_head:
                rois = batch['proposals'][real]
                feat = torch.cat([self._block_features(
                    params, data, rois, b, arch, quant)
                    for b in range(0, data.shape[0], REFERENCE_BLOCK)])
            else:
                feat = torch.cat([self.net.head_features(
                    params, data[b:b + REFERENCE_BLOCK], None, arch, quant)
                    for b in range(0, data.shape[0], REFERENCE_BLOCK)])
            if not phase_b:
                return feat
            generator = torch.Generator(device=self.device).manual_seed(
                self.bank_seed)
            rows = self.window_rows(host, generator)[real]
            window = self.bank.feats[rows].float()
            return self.net.classify(params, feat, window, arch, None,
                                     quant)

    def _block_features(self, params, data, rois, b, arch, quant):
        sel = (rois[:, 0] >= b) & (rois[:, 0] < b + REFERENCE_BLOCK)
        r = rois[sel].clone()
        r[:, 0] -= b
        return self.net.head_features(params, data[b:b + REFERENCE_BLOCK], r,
                                      arch, quant)


class Train(Driver):
    kind = 'train'

    def prepare(self):
        """The benchmark's inputs: the bank, the batches, the learning
        rate and the step generator's seed."""
        self.arch = self.net.Arch(self.model, 'train')
        self.make_bank()
        self.train_seed = seeds.derive(self.seed, 'train_generator')
        self.lr = first_lr(self.model)
        self.pool_size = self.cell.traffic['pool']
        self.pool = [self.batch(i, labels=True)
                     for i in range(self.pool_size)]
        self.clips = self.arch.clips
        self.steps_compared = self.cell.traffic['compare_steps']

    def setup(self):
        from lfb_tpu_torch.models.spec import build_spec
        from lfb_tpu_torch.train import optimizer, steps
        self.mark('port imported')
        self.prepare()
        self.mark('bank and batches')
        params = self.weights(self.arch)
        spec = build_spec(self.cfg, 'train')
        self.trainable, self.frozen = steps.split_params(spec, params)
        self.mstate = optimizer.init_state(params, set(self.frozen))
        self.step = steps.make_train_step(
            spec, self.cfg.SOLVER,
            bank=self.dataset.port_bank(self.bank, self.model))
        self.generator = torch.Generator(device=self.device).manual_seed(
            self.train_seed)
        start = {k: v.detach().to('cpu', copy=True)
                 for k, v in self.trainable.items()}
        self.mark('weights and step')
        self.readings = {'loss': [], 'logits': None, 'grad': None,
                         'change': None}
        for i in range(self.steps_compared):
            aux = self.iterate(i)
            self.readings['loss'].append(float(aux['loss']))
            self.mark('step {}'.format(i + 1))
            if i == 0:
                real = self.real(self.pool[i][1])
                prob = aux['prob'][real[real < aux['prob'].shape[0]]]
                self.readings['logits'] = self.dataset.compared_logits(prob)
                self.readings['grad'] = norms(
                    {k: v / self.lr for k, v in self.mstate.momentum.items()})
        self.readings['change'] = norms({k: v.detach().cpu() - start[k]
                                         for k, v in self.trainable.items()})
        del start
        self.mark('first steps')
        self.dispatch_s, self.calls = 0.0, 0
        self.first_window_step = self.steps_compared

    def iterate(self, i: int, record: bool = True):
        batch = self.pool[i % self.pool_size][0]
        self.trainable, self.frozen, self.mstate, aux = self.timed(
            self.step, self.trainable, self.frozen, self.mstate, batch,
            self.generator, self.lr)
        self.last_loss = aux['loss']
        return aux

    def free(self):
        self.final_loss = float(self.last_loss)
        del self.step, self.trainable, self.frozen, self.mstate
        del self.generator, self.last_loss
        self.release()

    def kernel_calls(self, iterations: List[int]) -> List[kcost.Call]:
        calls = []
        for i in iterations:
            host = self.pool[i % self.pool_size][1]
            calls += self.launches.backbone_calls(
                self.arch, self.clips, train=True, fused=False,
                remat=self.model['TPU.REMAT'])
            rois = host.get('rois')
            calls += self.launches.head_calls(self.arch, rois, self.clips,
                                              train=True)
            rows = rois.shape[0] if rois is not None else self.clips
            calls += self.launches.fbo_calls(self.arch, rows, train=True)
        return calls

    def flops_per_iteration(self) -> float:
        return flopcount.train_step(
            self.net, self.ref_dataset, self.model, self.clips,
            self.cell.config['batch'].get('boxes_per_clip', 1))

    def reference(self) -> Dict[str, float]:
        return self.compare(self.readings, self.reference_readings())

    def compare(self, got: Dict, ref: Dict) -> Dict[str, float]:
        """The compared numbers: the worst step's relative loss gap
        ('loss'), the worst row's relative gap of the first step's logits
        (the program's from the 'prob' its step returns; 'logit_row'), the
        worst leaf's gap of the first step's gradient norm ('grad') and of
        the steps' change ('change').  Leaves whose reference gradient is
        under a thousandth of the median leaf's are left out: they move by
        round-off alone (a non-local key's bias under the softmax).  The
        first step's loss gap and the median leaf's gaps go to the run's
        notes, not compared."""
        loss = max(abs(g - r) / abs(r) for g, r in zip(got['loss'],
                                                       ref['loss']))
        # Rows missing from the program's output read as a whole gap.
        logit_row = (rel_rows(got['logits'], ref['logits'].double())
                     if got['logits'].shape == ref['logits'].shape else 1.0)
        median = float(np.median(list(ref['grad'].values())))
        names = [n for n, v in ref['grad'].items() if v >= 1e-3 * median]
        self.left_out = sorted(set(ref['grad']) - set(names))
        self.worst, medians = {}, {}
        for key in ('grad', 'change'):
            gaps = leaf_gaps(got[key], ref[key], names)
            self.worst[key] = sorted(gaps, key=gaps.get)[-3:]
            medians[key] = float(np.median(list(gaps.values())))
        self.extra = {'loss_first': abs(got['loss'][0] - ref['loss'][0])
                      / abs(ref['loss'][0]),
                      'grad_median': medians['grad'],
                      'change_median': medians['change']}
        return {'loss': loss, 'logit_row': logit_row,
                'grad': max(leaf_gaps(got['grad'], ref['grad'],
                                      names).values()),
                'change': max(leaf_gaps(got['change'], ref['change'],
                                        names).values())}

    def reference_readings(self, quant=None, fault=None) -> Dict:
        """The reference's three steps from the program's starting
        weights, batches and draws: each step's loss, the first step's
        gradient norms (with weight decay, as the optimizer takes it) and
        the norms of each parameter's change.  ``quant`` rounds as the
        control does; ``fault`` 'half' leaves out the second half of every
        batch's clips, the mean taken over the rest."""
        arch, m = self.arch, self.model
        params = self.weights(arch)
        start = {k: v.clone() for k, v in params.items()}
        names = self.net.trainable_names(arch, list(params))
        momentum = {k: torch.zeros_like(params[k]) for k in names}
        generator = torch.Generator(device=self.device).manual_seed(
            self.train_seed)
        out = {'loss': [], 'logits': None, 'grad': None, 'change': None}
        for i in range(self.steps_compared):
            batch, host = self.pool[i % self.pool_size]
            window = self.window_rows(host, generator)
            masks = self.net.draw_masks(arch, window.shape[0], generator)
            clips = batch['data'].shape[0]
            real = self.real(host)
            if fault == 'half':
                clips //= 2
                real = real[:real.numel() // 2]
            ref_batch = {'data': batch['data'][:clips],
                         'labels': batch['labels'][real]}
            if arch.roi_head:
                ref_batch['rois'] = batch['proposals'][real]
                ref_batch['weight'] = batch['box_mask'][real]
            loss, grads, logits = reftrain.loss_and_grads(
                self.net, self.ref_dataset, params, names, ref_batch,
                window[real], self.bank.feats,
                {k: v[real] for k, v in masks.items()}, arch,
                block=REFERENCE_BLOCK, quant=quant)
            out['loss'].append(loss)
            if i == 0:
                out['logits'] = self.ref_dataset.compared_logits(logits)
                out['grad'] = norms({
                    k: grads[k] + (m['SOLVER.WEIGHT_DECAY_BN'] if '_bn' in k
                                   else m['SOLVER.WEIGHT_DECAY']) * params[k]
                    for k in names})
            reftrain.sgd_update(
                params, grads, momentum, lr=self.lr,
                mu=m['SOLVER.MOMENTUM'], nesterov=m['SOLVER.NESTEROV'],
                wd=m['SOLVER.WEIGHT_DECAY'], wd_bn=m['SOLVER.WEIGHT_DECAY_BN'])
        out['change'] = norms({k: params[k] - start[k] for k in names})
        return out


def norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """{name: L2 norm} of tensors on one device."""
    names = list(tensors)
    values = torch.stack([tensors[n].float().norm() for n in names])
    return dict(zip(names, values.tolist()))


KINDS = {'two_phase': TwoPhase, 'train': Train}


def driver(cell: layout.Cell, seed: int, device) -> Driver:
    return KINDS[cell.kind](cell, seed, device)

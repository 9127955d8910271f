"""A whole run of each cell, past the harness's look for a card, with the
timed path broken underneath: ``correct`` has to come out false, once for
each fault the cell can have (one chip: no exchange between chips to
leave out).  A tiny size on the CPU; the port's plain path in float32."""

from __future__ import annotations

import time

import pytest
import torch

from gpubench import run
from gpubench.tests.tiny import tiny_cell

SEED = 3 * 2 ** 31 + 5


@pytest.fixture(autouse=True)
def _threads():
    before = torch.get_num_threads()
    torch.set_num_threads(min(before, 4))
    yield
    torch.set_num_threads(before)


def half_batch(batch):
    """The first half of a batch's clips and their rows."""
    clips = batch['data'].shape[0]
    rows = {k: v.shape[0] for k, v in batch.items()}
    out = {}
    for key, value in batch.items():
        out[key] = value[:rows[key] * (clips // 2) // clips]
    return out


def doubled(outputs):
    return {k: torch.cat([v, v]) for k, v in outputs.items()}


def eval_fault(kind):
    from lfb_tpu_torch.train import steps
    make = steps.make_eval_step

    def make_broken(*args, **kwargs):
        step = make(*args, **kwargs)

        def broken(params, batch):
            if kind == 'half':
                return doubled(step(params, half_batch(batch)))
            out = dict(step(params, batch))
            key = 'logits' if 'logits' in out else next(iter(out))
            out[key] = out[key].clone()
            out[key][0] += 1.0
            return out
        return broken
    return make_broken


def train_fault(kind):
    from lfb_tpu_torch.train import steps
    make = steps.make_train_step

    def make_broken(*args, **kwargs):
        step = make(*args, **kwargs)

        def broken(trainable, frozen, mstate, batch, generator, lr):
            if kind == 'half':
                return step(trainable, frozen, mstate, half_batch(batch),
                            generator, lr)
            copies = {k: v.clone() for k, v in trainable.items()}
            moment = type(mstate)({k: v.clone()
                                   for k, v in mstate.momentum.items()})
            _, _, _, aux = step(copies, frozen, moment, batch, generator, lr)
            return trainable, frozen, mstate, aux
        return broken
    return make_broken


def run_tiny(name):
    result, lines = run.run_cell(tiny_cell(name), SEED, 0.0, False,
                                 device='cpu', t_start=time.perf_counter())
    return result, lines


@pytest.mark.parametrize('name,fault', [
    ('ava_r101_nl3l.two_phase', 'half'),
    ('ava_r101_nl3l.two_phase', 'altered'),
    ('charades_r101_nl.two_phase_fused', 'half'),
    ('charades_r101_nl.two_phase_fused', 'altered'),
])
def test_broken_inference_is_not_correct(monkeypatch, name, fault):
    from lfb_tpu_torch.train import steps
    monkeypatch.setattr(steps, 'make_eval_step', eval_fault(fault))
    result, lines = run_tiny(name)
    assert result['correct'] is False, lines


@pytest.mark.parametrize('name,fault', [
    ('ava_r101_nl3l.train', 'unchanged'),
    ('ava_r101_nl3l.train', 'half'),
    ('charades_r101_nl.train', 'unchanged'),
    ('charades_r101_nl.train', 'half'),
])
def test_broken_training_is_not_correct(monkeypatch, name, fault):
    from lfb_tpu_torch.train import steps
    monkeypatch.setattr(steps, 'make_train_step', train_fault(fault))
    result, lines = run_tiny(name)
    assert result['correct'] is False, lines
    if fault == 'unchanged':
        assert result['checks']['change']['value'] == pytest.approx(1.0)

"""The frozen reference against the port's plain path (its CPU path, in
float32) at a tiny size, through a whole run of the harness: phase A and
phase B of both configurations, and three train steps of each."""

from __future__ import annotations

import time

import pytest
import torch

from gpubench import cells, run
from gpubench.reference import model as M
from gpubench.tests.tiny import tiny_cell

CELLS = ('ava_r101_nl3l.two_phase', 'ava_r101_nl3l.train',
         'charades_r101_nl.two_phase_fused', 'charades_r101_nl.train')
# float32 on both sides, sums in other orders through 101 layers and, in
# training, three steps of momentum SGD.
AGREE = {'a_row': 1e-5, 'b_row': 1e-5, 'loss': 1e-4, 'logit_row': 1e-5,
         'grad': 1e-3, 'change': 1e-2}


@pytest.fixture(autouse=True)
def _threads():
    before = torch.get_num_threads()
    torch.set_num_threads(min(before, 4))
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize('name', CELLS)
def test_reference_agrees_with_the_port(name):
    cell = tiny_cell(name)
    result, lines = run.run_cell(cell, 2 ** 40 + 17, 0.0, False,
                                 device='cpu', t_start=time.perf_counter())
    assert result['correct'], lines
    for key, check in result['checks'].items():
        assert check['value'] <= AGREE[key], (key, check['value'])


@pytest.mark.parametrize('name', CELLS)
def test_parameters_and_trainable_sets_match_the_port(name):
    from lfb_tpu_torch.models.model import init_params
    from lfb_tpu_torch.models.spec import build_spec
    from lfb_tpu_torch.train.steps import split_params
    cell = tiny_cell(name)
    cfg = cells.port_config(cell)
    split = cell.traffic['split']
    for infer_only in ((True, False) if cell.kind == 'two_phase'
                       else (False,)):
        spec = build_spec(cfg, split, lfb_infer_only=infer_only)
        port = init_params(spec, torch.Generator().manual_seed(0))
        arch = M.Arch(cell.config['model'], split, infer_only=infer_only)
        ours = {n: s for n, s, _ in M.param_specs(arch)}
        assert {n: tuple(v.shape) for n, v in port.items()} == ours
        if cell.kind == 'train':
            trainable, _ = split_params(spec, port)
            assert sorted(trainable) == sorted(M.trainable_names(arch, ours))

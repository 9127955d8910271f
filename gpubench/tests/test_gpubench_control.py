"""The control: the reference put in the program's place, one precision
step below the configuration (fp8 backbone, TF32 head), has to come out
as not correct.  On a card at each cell's own size and three seeds (the
readings the limits were set from, ``python3 -m gpubench.control``); on
the CPU at a tiny size, where the limits were not set, it has to read ten
times what a sound run of the port reads."""

from __future__ import annotations

import time

import pytest
import torch

from gpubench import control, layout, run
from gpubench.tests.tiny import tiny_cell

CELLS = ('ava_r101_nl3l.two_phase', 'ava_r101_nl3l.train',
         'charades_r101_nl.two_phase_fused', 'charades_r101_nl.train')
SEEDS = (2147588383, 2147902577, 2148426229)


@pytest.fixture(autouse=True)
def _threads():
    before = torch.get_num_threads()
    torch.set_num_threads(min(before, 4))
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize('name', ('ava_r101_nl3l.two_phase',
                                  'charades_r101_nl.train'))
def test_control_separates_at_a_tiny_size(name):
    cell = tiny_cell(name)
    sound, _ = run.run_cell(cell, SEEDS[0], 0.0, False, device='cpu',
                            t_start=time.perf_counter())
    readings = control.control_readings(cell, SEEDS[0], device='cpu')
    worst = max(readings['control'][k] / max(v['value'], 1e-12)
                for k, v in sound['checks'].items())
    assert worst >= 10.0, (readings, sound['checks'])


@pytest.mark.cuda
@pytest.mark.parametrize('name', CELLS)
def test_control_is_not_correct_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    cell = layout.cell(name)
    limits = cell.limits['checks']
    for seed in SEEDS:
        readings = control.control_readings(cell, seed)
        for fault, numbers in readings.items():
            assert any(numbers[k] > limits[k]['limit'] for k in limits), (
                fault, seed, numbers)

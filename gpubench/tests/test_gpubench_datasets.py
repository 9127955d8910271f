"""The four cells read as they did before their dataset and reference
network became modules found by name: at the tiny size on the CPU, with
a one-iteration window's inputs, each cell's bank (rows and index
tables), batches (frames, boxes, keys, labels, real rows), the
reference's windows of bank rows, a train step's dropout masks (all
three steps'), the FLOPs an iteration (``mfu.*``'s numerator) and the
launch list the roofline reads are exactly what they were; the
reference's outputs (phase A's rows and phase B's logits of the first
iteration, or the three steps' losses and the first step's logits) agree
to a relative 1e-5, since float32 sums taken in another order, as another
thread count takes them, move their last bits (two runs of one tree read
up to 1.2e-7 apart).  The numbers were recorded on the tree before the
change.  The port is not run: its agreement with the reference is
``test_gpubench_reference.py``'s."""

from __future__ import annotations

import hashlib
import json

import numpy as np
import pytest
import torch

from gpubench import cells, layout
from gpubench.cost import flops
from gpubench.tests.tiny import tiny_cell

SEED = 2 ** 40 + 17
REL = 1e-5

PINNED = {
    'ava_r101_nl3l.two_phase': {
        'bank': 'b403f148fbe47c19d76f66b30b72ddc1',
        'batches': {
            'box_mask': 'a9d9f5d2089f399d93f97a3c49884229',
            'data': 'e35a6109f9a15987d55acf14297f7f50',
            'meta': '183980046dfa18690cbfba3ea1f5fe8f',
            'metadata': '183980046dfa18690cbfba3ea1f5fe8f',
            'proposals': '4d87a62d7888c57cc08091e8260c8a4f',
            'real': '79b27e8db249ca4cdd34ba0a579b8a97',
            'rois': '4d87a62d7888c57cc08091e8260c8a4f',
        },
        'windows': '0adb51f359c458423f85352db911bdc1',
        'flops': 32863617024.0,
        'launches': (68, 'bda2b9a86f55a564b5e8663f5aa33309'),
        'reference': {
            'a': (396.66662341066973, 35467.39616401693),
            'b': (20.49072688640945, 24.405824502930045),
        },
    },
    'ava_r101_nl3l.train': {
        'bank': 'b403f148fbe47c19d76f66b30b72ddc1',
        'batches': {
            'box_mask': 'a9d9f5d2089f399d93f97a3c49884229',
            'data': 'e35a6109f9a15987d55acf14297f7f50',
            'labels': 'ddd2debbd19d307ef11946f3ba5fbe83',
            'meta': '183980046dfa18690cbfba3ea1f5fe8f',
            'metadata': '183980046dfa18690cbfba3ea1f5fe8f',
            'proposals': '4d87a62d7888c57cc08091e8260c8a4f',
            'real': '79b27e8db249ca4cdd34ba0a579b8a97',
            'rois': '4d87a62d7888c57cc08091e8260c8a4f',
        },
        'windows': 'c4b3693447b1bccd375d74dc787860c6',
        'masks': '0a316047c9b1a01d13f8b0aab4e9fb10',
        'flops': 62455873536.0,
        'launches': (100, '11904ec8ee0e921463b72244afe7eac6'),
        'reference': {
            'loss': (0.8097532987594604,
                     0.1629514843225479, 0.12557712197303772),
            'logits': (24.29996652362747, 15.131842714268714),
        },
    },
    'charades_r101_nl.two_phase_fused': {
        'bank': 'adb83416807aa819309ca75742cad518',
        'batches': {
            'center': '83ddfbe6a12a67dfcd33183e047a1c16',
            'data': 'e35a6109f9a15987d55acf14297f7f50',
            'lfb_center': '7ed4baee7ad94d8922ae77563af2708b',
            'lfb_video_idx': '8e9f6fb42f8f90745a90ce7ca7e44dcb',
            'video': 'e5cc55acf3b261d6bccf0eba2bee6d3a',
        },
        'windows': 'd16ad1947cc1f0df23dc26c99124000c',
        'flops': 20398671872.0,
        'launches': (288, '6d74563e7f212af01491194a47c49cce'),
        'reference': {
            'a': (149.5034598124344, 6327.970579080313),
            'b': (8.943577684308858, 13.13703993940726),
        },
    },
    'charades_r101_nl.train': {
        'bank': 'f3130bf2ec93bf2b30491bfca1efcfb3',
        'batches': {
            'center': '688f2f5b04a9b276c886f8dad8b30fee',
            'data': 'e35a6109f9a15987d55acf14297f7f50',
            'labels': 'b6b7bf3804a694b3685002cda2d94839',
            'lfb_center': 'a6a0af267ab98f2526937bdc735c104f',
            'lfb_video_idx': '8e9f6fb42f8f90745a90ce7ca7e44dcb',
            'video': 'e5cc55acf3b261d6bccf0eba2bee6d3a',
        },
        'windows': 'b9d64bcd1c2a4d48d23e6c913aa4a852',
        'masks': 'baab359b0615ecfe4c5edb6f16b2fd42',
        'flops': 10556086272.0,
        'launches': (40, 'baf238a422f263a4dd5004c5bdc0eba7'),
        'reference': {
            'loss': (0.7613289952278137,
                     0.30306002497673035, 0.17656268179416656),
            'logits': (11.207748202247107, 13.611553712747991),
        },
    },
}

# The FLOPs a step at the cells' own sizes (the reference over meta
# tensors).
FULL_FLOPS = {
    'ava_r101_nl3l.two_phase': 22690523512832.0,
    'ava_r101_nl3l.train': 25083511308288.0,
    'charades_r101_nl.two_phase_fused': 22590803951616.0,
    'charades_r101_nl.train': 8478425399296.0,
}


@pytest.fixture(autouse=True)
def _threads():
    before = torch.get_num_threads()
    torch.set_num_threads(min(before, 4))
    yield
    torch.set_num_threads(before)


def digest(arrays) -> str:
    """sha256 over each array's dtype, shape and bytes, in order."""
    h = hashlib.sha256()
    for x in arrays:
        if isinstance(x, torch.Tensor):
            x = x.detach().cpu().contiguous().numpy()
        x = np.ascontiguousarray(x)
        h.update('{} {}'.format(x.dtype, x.shape).encode())
        h.update(x.tobytes())
    return h.hexdigest()[:32]


def norm_sum(t: torch.Tensor):
    t = t.double()
    return float(t.norm()), float(t.sum())


def readings(drv) -> dict:
    """What PINNED holds, read from a prepared driver."""
    bank = drv.bank
    got = {'bank': digest([bank.feats, bank.lengths]
                          + [bank.tables[k] for k in sorted(bank.tables)])}
    keys = sorted({k for b, h in drv.pool for k in list(b) + list(h)})
    got['batches'] = {k: digest([{**b, **h}[k] for b, h in drv.pool])
                      for k in keys}
    if drv.kind == 'two_phase':
        got['windows'] = digest([
            drv.window_rows(h, torch.Generator().manual_seed(drv.bank_seed))
            for _, h in drv.pool])
    else:
        # The train step's draws in its order: each step's window, then
        # its masks, from one generator.
        g = torch.Generator().manual_seed(drv.train_seed)
        windows, masks = [], []
        for i in range(drv.steps_compared):
            rows = drv.window_rows(drv.pool[i % drv.pool_size][1], g)
            windows.append(rows)
            masks += list(drv.net.draw_masks(drv.arch, rows.shape[0],
                                             g).values())
        got['windows'] = digest(windows)
        got['masks'] = digest(masks)
    got['flops'] = drv.flops_per_iteration()
    calls = drv.kernel_calls(list(range(drv.pool_size)))
    got['launches'] = (len(calls), hashlib.sha256(
        json.dumps(calls).encode()).hexdigest()[:32])
    return got


@pytest.mark.parametrize('name', sorted(PINNED))
def test_the_cells_read_as_before(name):
    want = PINNED[name]
    drv = cells.driver(tiny_cell(name), SEED, 'cpu')
    drv.prepare()
    got = readings(drv)
    for key in got:
        assert got[key] == want[key], key
    if drv.kind == 'two_phase':
        a, b = drv.reference_outputs([0])[0]
        ref = {'a': norm_sum(a), 'b': norm_sum(b)}
    else:
        out = drv.reference_readings()
        ref = {'loss': tuple(out['loss']), 'logits': norm_sum(out['logits'])}
    for key, values in want['reference'].items():
        assert ref[key] == pytest.approx(values, rel=REL), key


@pytest.mark.parametrize('name', sorted(FULL_FLOPS))
def test_the_flops_of_a_step_at_full_size_are_as_before(name):
    cell = layout.cell(name)
    model, net = cell.config['model'], cell.network
    boxes = cell.config['batch'].get('boxes_per_clip', 1)
    if cell.kind == 'two_phase':
        got = flops.two_phase(net, model, model['TEST.BATCH_SIZE'], boxes)
    else:
        got = flops.train_step(net, cell.reference_dataset, model,
                               model['TRAIN.BATCH_SIZE'], boxes)
    assert got == FULL_FLOPS[name]

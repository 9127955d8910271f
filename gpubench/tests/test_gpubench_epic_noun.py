"""The EPIC-Kitchens noun configuration (``epic_noun_r50_nl``): its train
cell against the reference at a tiny size, the harness's detector-bank
tables against the port's ``build_noun``, the reference's noun window
against the port's and the host sampler's, the launch lists against the
port's kernel calls, the faults and the control, the cell's pinned
inputs, the FLOPs of a step at full size, and the reader of
``fbo_attn_roofline.train``.  All on the CPU; the port's plain path in
float32."""

from __future__ import annotations

import time
from collections import Counter

import numpy as np
import pytest
import torch

from gpubench import cells, layout, run, seeds
from gpubench.control import control_readings
from gpubench.cost import flops
from gpubench.cost.kernels import attention_bwd, attention_fwd, bound_s
from gpubench.tests.test_gpubench_datasets import norm_sum, readings
from gpubench.tests.test_gpubench_epic_verb import plain_counted
from gpubench.tests.test_gpubench_faults import train_fault
from gpubench.tests.test_gpubench_reference import AGREE
from gpubench.tests.tiny import tiny_cell

CELL = 'epic_noun_r50_nl.train'
SEED = 2 ** 40 + 17
# The FLOPs of a step at the cell's own size (the reference over meta
# tensors): the whole R50 backbone's forward and backward at B 16, crop
# 224, 32 frames, the FBO over 120-row windows and the 352-way classifier.
FULL_FLOPS = 17718259482624.0
# The tiny cell's inputs, draws, FLOPs and launch list, and the
# reference's readings, as test_gpubench_datasets.py pins the other cells'
# (recorded when the cell was added).
PINNED = {
    'bank': '2ea7a8ba76f1925ac66fe85ea593a168',
    'batches': {
        'center': '408001c77e2331725f5ace2ac054ffce',
        'data': 'e35a6109f9a15987d55acf14297f7f50',
        'labels': '3912f35115721afc6aee0edc2e3a9170',
        'lfb_center': 'b9703eabcdb6e81def10b08fe5741d41',
        'lfb_video_idx': '8e9f6fb42f8f90745a90ce7ca7e44dcb',
        'video': 'e5cc55acf3b261d6bccf0eba2bee6d3a',
    },
    'windows': '9fae8127c2e423adad3886c90c43205e',
    'masks': '7ecf1bee6be39db6ebf970480ebc3398',
    'flops': 23031054336.0,
    'launches': (84, '629ed3b2d833c6b2b4c7ac51bdaf77d3'),
    'reference': {
        'loss': (5.7631025314331055, 5.93462610244751, 6.216297149658203),
        'logits': (158.97186014650208, -4205.199610374762),
    },
}
REL = 1e-5


@pytest.fixture(autouse=True)
def _threads():
    before = torch.get_num_threads()
    torch.set_num_threads(min(before, 4))
    yield
    torch.set_num_threads(before)


def run_tiny(cell):
    return run.run_cell(cell, SEED, 0.0, False, device='cpu',
                        t_start=time.perf_counter())


def test_the_train_cell_agrees_with_the_reference():
    result, lines = run_tiny(tiny_cell(CELL))
    assert result['correct'], lines
    for key, check in result['checks'].items():
        assert check['value'] <= AGREE[key], (key, check['value'])
    assert 'conv1_w' not in result['notes']['left_out']


class Drawn:
    """A generator that gives the count model's draws as set here: the
    videos' lengths, then the boxes at each detector frame."""

    def __init__(self, lengths, boxes):
        self.lengths, self.boxes = np.asarray(lengths), np.asarray(boxes)

    def integers(self, lo, hi, size):
        assert size == self.lengths.size
        return self.lengths

    def poisson(self, mean, size):
        assert size == self.boxes.size
        return self.boxes


def test_the_harness_tables_are_build_noun_tables():
    """The harness's tables from given per-frame box counts (empty frames,
    frames at the cap of 10 and over it, a video far wider than the
    window) equal, bit for bit, what the port's ``build_noun`` builds from
    a detector bank with those boxes, and its rows are the bank's rows in
    the same order."""
    from lfb_tpu_torch.bank.device_bank import FrameDeviceBank
    cell = layout.cell(CELL)
    model = cell.config['model']
    k = model['EPIC.MAX_NUM_FEATS_PER_NOUN_LFB_FRAME']
    lengths = [900, 12000, 1500]
    count_model = dict(cell.config['bank']['train'], videos=3,
                       frames=[900, 12000],
                       hours=sum(lengths) / (3600.0 * model['EPIC.FPS']))
    detector = [(n - 30) // 30 + 1 for n in lengths]
    rng = np.random.default_rng(5)
    boxes = rng.poisson(10, sum(detector))
    boxes[:4] = [0, 10, 14, 0]
    boxes[detector[0]:detector[0] + 3] = [0, 0, 10]
    tables, got_lengths, total = cell.dataset.tables(
        model, count_model, Drawn(lengths, boxes))
    assert got_lengths.tolist() == lengths
    host, start, row = {}, 0, 0
    for v, n in enumerate(detector):
        host[v] = {}
        for j, b in enumerate(boxes[start:start + n].tolist()):
            taken = min(b, k)
            feats = np.arange(row, row + b, dtype=np.float32)[:, None]
            host[v][30 * (j + 1)] = feats
            row += taken
        start += n
    port = FrameDeviceBank.build_noun(
        host, window_size=model['LFB.WINDOW_SIZE'], max_per_frame=k,
        frames_per_second=model['EPIC.NOUN_LFB_FRAMES_PER_SECOND'],
        fps=model['EPIC.FPS'], lfb_dim=1, device='cpu')
    assert total == row == port.feats.shape[0] - 1
    np.testing.assert_array_equal(port.frame_ids.numpy(),
                                  tables['frame_ids'])
    np.testing.assert_array_equal(port.rows.numpy(), tables['rows'])
    # Each box's row holds the box's number in the harness's order.
    np.testing.assert_array_equal(port.feats[:-1, 0].numpy(),
                                  np.arange(total, dtype=np.float32))
    assert tables['frame_ids'].shape[1] > 10 * model['LFB.WINDOW_SIZE']
    assert (tables['frame_ids'][0, :12] == [60] * 10 + [90] * 2).all()


def test_the_reference_window_is_the_port_window():
    """The reference's window rows, the port's ``FrameDeviceBank`` under
    'epic_noun' and the host sampler ``data/epic.sample_noun_lfb`` take
    the same rows, at random centres and at centres near both ends of a
    video, with windows cut at 120 and windows short of it."""
    from lfb_tpu_torch.bank.device_bank import FrameDeviceBank
    from lfb_tpu_torch.data.epic import sample_noun_lfb
    cell = layout.cell(CELL)
    model = cell.config['model']
    window, k = model['LFB.WINDOW_SIZE'], model[
        'EPIC.MAX_NUM_FEATS_PER_NOUN_LFB_FRAME']
    count_model = dict(cell.config['bank']['test'], videos=5)
    tables, lengths, total = cell.dataset.tables(
        model, count_model, seeds.rng(SEED, 'bank_counts'))
    f = tables['frame_ids']
    assert ((f[:, 1:] >= f[:, :-1]) | (f[:, 1:] < 0)).all()
    device_tables = {key: torch.from_numpy(v) for key, v in tables.items()}
    feats = torch.zeros((total + 1, 1))
    bank = FrameDeviceBank(
        feats, device_tables['frame_ids'], device_tables['rows'],
        window_size=window, window_mode='epic_noun', max_per_frame=k,
        frames_per_second=model['EPIC.NOUN_LFB_FRAMES_PER_SECOND'],
        fps=model['EPIC.FPS'])
    rng = np.random.default_rng(7)
    video, center = [], []
    for v, n in enumerate(lengths):
        edges = [0, 1, 29, 179, 180, 181, 209, 210, n - 211, n - 181,
                 n - 180, n - 179, n - 30, n - 1, n]
        randoms = rng.integers(0, n, 12).tolist()
        video += [v] * (len(edges) + len(randoms))
        center += edges + randoms
    host = {'video': np.array(video), 'center': np.array(center)}
    got = cell.reference_dataset.window_rows(
        device_tables, host, model, zero=total,
        generator=torch.Generator())
    port = bank.choose_rows(torch.from_numpy(host['video']),
                            *bank.window(torch.from_numpy(host['center'])))
    assert torch.equal(got, port)
    # The host sampler over the detector bank of each video, each box's
    # feature its row id + 1 (0 is the zero row).
    for v in range(len(lengths)):
        detections = {}
        for frame, r in zip(f[v], tables['rows'][v]):
            if frame >= 0:
                detections.setdefault(int(frame), []).append(r + 1.0)
        detections = {fr: np.array(rs, np.float32)[:, None]
                      for fr, rs in detections.items()}
        for i in np.flatnonzero(host['video'] == v):
            want = sample_noun_lfb(
                detections, int(host['center'][i]), window_size=window,
                max_per_frame=k,
                frames_per_second=model['EPIC.NOUN_LFB_FRAMES_PER_SECOND'],
                fps=model['EPIC.FPS'], lfb_dim=1)[:, 0]
            row = got[i].numpy()
            np.testing.assert_array_equal(np.where(row == total, 0, row + 1),
                                          want)
    real = (got != total).sum(dim=1)
    assert (real == window).any() and (real < window).any()


def test_the_launch_lists_are_the_port_kernel_calls(monkeypatch):
    """One 'stage' train step of the tiny cell calls the hand kernels as
    ``cost/model.py``'s launch lists say: the 5 non-local blocks twice and
    the 2 FBO layers once forward, all 7 backward, the stem and its dW
    once; the FBO's calls at Nk 120."""
    drv = cells.driver(tiny_cell(CELL), SEED, 'cpu')
    drv.setup()
    seen = plain_counted(monkeypatch)
    drv.iterate(drv.first_window_step)
    calls = drv.kernel_calls([drv.first_window_step])
    want = Counter(family for family, *_ in calls)
    assert want == {'stem_conv': 1, 'stem_conv_dw': 1, 'attention': 12,
                    'attention_bwd': 7}
    for family, counter in (('stem_conv', 'stem.fwd'),
                            ('stem_conv_dw', 'stem.dw'),
                            ('attention', 'attention.fwd'),
                            ('attention_bwd', 'attention.bwd')):
        assert seen[counter] == want[family], family
    fbo = [c for c in calls if c[3] == 'float32']
    clips = drv.clips
    assert fbo == [attention_fwd(clips, 1, 120, 512, 'float32', lse=True)] * 2 \
        + [attention_bwd(clips, 1, 120, 512, 'float32')] * 2


@pytest.mark.parametrize('fault', ('unchanged', 'half'))
def test_a_broken_train_step_is_not_correct(monkeypatch, fault):
    from lfb_tpu_torch.train import steps
    monkeypatch.setattr(steps, 'make_train_step', train_fault(fault))
    result, lines = run_tiny(tiny_cell(CELL))
    assert result['correct'] is False, lines
    if fault == 'unchanged':
        assert result['checks']['change']['value'] == pytest.approx(1.0)


def test_the_control_and_the_half_batch_are_not_correct():
    """The reference one precision step below bf16 (fp8) and the reference
    with half of every batch left out, each against the float32
    reference: each fails at least one of the cell's limits."""
    cell = tiny_cell(CELL)
    limits = {k: v['limit'] for k, v in cell.limits['checks'].items()}
    got = control_readings(cell, SEED, device='cpu')
    assert set(got) == {'control', 'half'}
    for name, numbers in got.items():
        assert any(numbers[k] > limits[k] for k in limits), (name, numbers)


def test_the_cell_reads_as_pinned():
    """The tiny cell's bank, batches, windows, masks, FLOPs and launch
    list, bit for bit, and the reference's losses and logits to a
    relative 1e-5."""
    drv = cells.driver(tiny_cell(CELL), SEED, 'cpu')
    drv.prepare()
    got = readings(drv)
    for key in got:
        assert got[key] == PINNED[key], key
    out = drv.reference_readings()
    ref = {'loss': tuple(out['loss']), 'logits': norm_sum(out['logits'])}
    for key, values in PINNED['reference'].items():
        assert ref[key] == pytest.approx(values, rel=REL), key


def test_the_flops_of_a_step_at_full_size():
    cell = layout.cell(CELL)
    model = cell.config['model']
    assert flops.train_step(cell.network, cell.reference_dataset, model,
                            model['TRAIN.BATCH_SIZE'], 1) == FULL_FLOPS


def test_the_fbo_attention_roofline_reader():
    """``fbo_attn_roofline.train`` on a synthetic record: the f32 decode
    kernels' bounds over their device time, the bf16 calls and kernels
    left out; None when their launches differ from the calls, or in a
    two-phase record."""
    read = layout.cell(CELL).metric_reader('fbo_attn_roofline.train')
    fwd = attention_fwd(16, 1, 120, 512, 'float32', lse=True)
    bwd = attention_bwd(16, 1, 120, 512, 'float32')
    nl = attention_fwd(16, 1568, 392, 256, 'bfloat16', lse=True)
    ops = [('void (anonymous namespace)::attn_decode_kernel<float>(float '
            'const*)', 10e-6),
           ('void (anonymous namespace)::attn_bwd_decode_kernel<float>('
            'float const*)', 15e-6),
           ('void (anonymous namespace)::attn_fwd_wgmma_kernel(CUtensorMap)',
            400e-6)]
    record = {'kind': 'train', 'trace': {'calls': [fwd, bwd, nl],
                                         'ops': ops}}
    want = 100.0 * (bound_s(*fwd[1:]) + bound_s(*bwd[1:])) / 25e-6
    assert read(record) == pytest.approx(want)
    assert 0 < want < 100
    record['trace']['ops'] = ops + ops[:1]
    assert read(dict(record)) == pytest.approx(
        100.0 * bound_s(*bwd[1:]) / 15e-6)
    record['trace']['ops'] = ops[:1] * 2 + ops[1:2] * 2
    assert read(record) is None
    assert read({'kind': 'two_phase', 'trace': {'calls': [fwd],
                                                'ops': ops}}) is None

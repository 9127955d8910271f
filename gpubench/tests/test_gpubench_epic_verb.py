"""The EPIC-Kitchens verb configuration (``epic_verb_r50_nl``): its train
cell against the reference at a tiny size, the reference's R50 arc-2
parameters and verb window against the port's, the launch lists against
the port's kernel calls, the faults, and the FLOPs of a step at full
size.  All on the CPU; the port's plain path in float32."""

from __future__ import annotations

import time
from collections import Counter

import numpy as np
import pytest
import torch

from gpubench import cells, layout, run, seeds
from gpubench.cost import flops
from gpubench.reference import model as M
from gpubench.tests.test_gpubench_faults import train_fault
from gpubench.tests.test_gpubench_reference import AGREE
from gpubench.tests.tiny import tiny_cell

CELL = 'epic_verb_r50_nl.train'
SEED = 2 ** 40 + 17
# The FLOPs of a step at the cell's own size (the reference over meta
# tensors): the whole R50 backbone's forward and backward at B 16, crop
# 224, 32 frames, the FBO over 40-row windows and the classifier.
FULL_FLOPS = 17704766193664.0


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
    # Every backbone leaf trains, the stem's weight among them.
    assert 'conv1_w' not in result['notes']['left_out']


def test_parameters_and_the_trainable_set_match_the_port():
    """The port's R50 arc-2 EPIC verb model and the reference's: the same
    parameter names and shapes, the same trainable set (the whole
    backbone but its frozen affines, the FBO and the classifier)."""
    from lfb_tpu_torch.models.model import init_params
    from lfb_tpu_torch.models.spec import build_spec
    from lfb_tpu_torch.train.steps import split_params
    cell = tiny_cell(CELL)
    spec = build_spec(cells.port_config(cell), 'train')
    port = init_params(spec, torch.Generator().manual_seed(0))
    arch = M.Arch(cell.config['model'], 'train')
    ours = {n: s for n, s, _ in M.param_specs(arch)}
    assert {n: tuple(v.shape) for n, v in port.items()} == ours
    trainable, _ = split_params(spec, port)
    assert sorted(trainable) == sorted(M.trainable_names(arch, ours))
    assert 'conv1_w' in trainable and 'res4_5_branch2a_w' in trainable
    # Arc 2: res4's temporal kernels 3, 1, 3, 1, 3, 1.
    assert [ours['res4_{}_branch2a_w'.format(i)][2] for i in range(6)] == [
        3, 1, 3, 1, 3, 1]
    assert sorted(n[:-len('_out_w')] for n in ours
                  if n.startswith('nonlocal') and n.endswith('_out_w')) == [
        'nonlocal_conv3_1', 'nonlocal_conv3_3', 'nonlocal_conv4_1',
        'nonlocal_conv4_3', 'nonlocal_conv4_5']


def paper_window(frame_ids, rows, video, center, window, fps, zero):
    """The LFB paper's verb sampler, frame by frame, over one video's
    table row: the features at frames [c - half, c + half] in frame order,
    the first ``window`` of them, then the zero row."""
    half = window * fps // 2
    at = {int(f): int(r) for f, r in zip(frame_ids[video], rows[video])
          if f >= 0}
    out = []
    for frame in range(center - half, center + half + 1):
        if frame in at and len(out) < window:
            out.append(at[frame])
    return out + [zero] * (window - len(out))


def test_the_reference_window_is_the_port_window():
    """The reference's window rows, the port's ``FrameDeviceBank`` under
    'epic_verb' and the paper's frame-by-frame sampler pick the same rows,
    at random centres and at centres within 20 s of a video's ends."""
    from lfb_tpu_torch.bank.device_bank import FrameDeviceBank
    cell = layout.cell(CELL)
    model = cell.config['model']
    count_model = dict(cell.config['bank']['test'], videos=6)
    tables, lengths, total = cell.dataset.tables(
        model, count_model, seeds.rng(SEED, 'bank_counts'))
    # The reference walks each video's row in frame order.
    f = tables['frame_ids']
    assert ((f[:, 1:] > f[:, :-1]) | (f[:, 1:] < 0)).all()
    feats = torch.zeros((total + 1, 4))
    device_tables = {k: torch.from_numpy(v) for k, v in tables.items()}
    bank = FrameDeviceBank(feats, device_tables['frame_ids'],
                           device_tables['rows'],
                           window_size=model['LFB.WINDOW_SIZE'],
                           window_mode='epic_verb', fps=model['EPIC.FPS'])
    rng = np.random.default_rng(7)
    video, center = [], []
    for v, n in enumerate(lengths):
        edges = [0, 1, 29, 30, 599, 600, 601, 630, n - 631, n - 601,
                 n - 600, n - 599, n - 30, n - 1, n]
        randoms = rng.integers(0, n, 8).tolist()
        video += [v] * (len(edges) + len(randoms))
        center += edges + randoms
    host = {'video': np.array(video), 'center': np.array(center)}
    got = cell.reference_dataset.window_rows(
        device_tables, host, model, zero=total,
        generator=torch.Generator())
    vid, cen = torch.from_numpy(host['video']), torch.from_numpy(
        host['center'])
    port = bank.choose_rows(vid, *bank.window(cen))
    assert torch.equal(got, port)
    want = [paper_window(tables['frame_ids'], tables['rows'], v, c,
                         model['LFB.WINDOW_SIZE'], model['EPIC.FPS'], total)
            for v, c in zip(video, center)]
    assert got.tolist() == want
    # Ends of a video leave zero rows; the middle fills all 40.
    assert (got == total).any() and (got != total).all(dim=1).any()


def plain_counted(monkeypatch):
    """Count each plain version the port's kernel wrappers run on the CPU
    under the launch counter its kernel bumps on the card."""
    from lfb_tpu_torch.ops import cuda_affine, cuda_attention, cuda_stem
    seen = Counter()
    for module, name, counter in (
            (cuda_attention, 'attention_fwd_lse_plain', 'attention.fwd'),
            (cuda_attention, 'attention_plain', 'attention.fwd'),
            (cuda_attention, 'attention_bwd_plain', 'attention.bwd'),
            (cuda_stem, 'stem_conv_plain', 'stem.fwd'),
            (cuda_stem, 'stem_conv_dw_plain', 'stem.dw'),
            (cuda_affine, 'affine_act_plain', 'affine.fwd'),
            (cuda_affine, 'affine_act_bwd_plain', 'affine.bwd')):
        def counted(*args, _fn=getattr(module, name), _key=counter,
                    **kwargs):
            seen[_key] += 1
            return _fn(*args, **kwargs)
        monkeypatch.setattr(module, name, counted)
    return seen


def test_the_launch_lists_are_the_port_kernel_calls(monkeypatch):
    """One 'stage' train step of the tiny cell calls the hand kernels as
    often as ``cost/model.py``'s launch lists say (5 non-local blocks run
    twice and the 2 FBO layers once forward, all 7 backward; the stem and
    its dW once), and the frozen affine once a site forward, once more a
    site inside res2-res5 for the recompute, once a site backward."""
    drv = cells.driver(tiny_cell(CELL), SEED, 'cpu')
    drv.setup()
    seen = plain_counted(monkeypatch)
    drv.iterate(drv.first_window_step)
    want = Counter(family for family, *_ in drv.kernel_calls(
        [drv.first_window_step]))
    assert want == {'stem_conv': 1, 'stem_conv_dw': 1, 'attention': 12,
                    'attention_bwd': 7}
    assert seen['stem.fwd'] == want['stem_conv']
    assert seen['stem.dw'] == want['stem_conv_dw']
    assert seen['attention.fwd'] == want['attention']
    assert seen['attention.bwd'] == want['attention_bwd']
    arch = drv.arch
    blocks = sum(M.BLOCK_COUNTS[arch.depth])
    nonlocal_blocks = sum(len(arch.nonlocal_after(s)) for s in M.STAGES)
    sites = 1 + 3 * blocks + nonlocal_blocks
    assert sites == 54
    assert seen['affine.fwd'] == 2 * sites - 1
    assert seen['affine.bwd'] == sites


@pytest.mark.parametrize('fault', ('unchanged', 'half'))
def test_a_broken_train_step_is_not_correct(monkeypatch, fault):
    from lfb_tpu_torch.train import steps
    monkeypatch.setattr(steps, 'make_train_step', train_fault(fault))
    result, lines = run_tiny(tiny_cell(CELL))
    assert result['correct'] is False, lines
    if fault == 'unchanged':
        assert result['checks']['change']['value'] == pytest.approx(1.0)


def test_the_flops_of_a_step_at_full_size():
    cell = layout.cell(CELL)
    model = cell.config['model']
    assert flops.train_step(cell.network, cell.reference_dataset, model,
                            model['TRAIN.BATCH_SIZE'], 1) == FULL_FLOPS

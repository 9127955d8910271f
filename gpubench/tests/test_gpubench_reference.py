"""The frozen reference against the port's plain path (its CPU path, in
float32) at a tiny size, through a whole run of the harness: phase A and
phase B of both configurations, and three train steps of each; and the
reference's path for a clip head that trains its backbone."""

from __future__ import annotations

import time

import pytest
import torch

from gpubench import cells, run
from gpubench.reference import model as M
from gpubench.reference import train as reftrain
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


def clip_head_training_its_backbone():
    """Charades' tiny train cell with MODEL.FREEZE_BACKBONE False, in its
    model block and in its overrides (``port_config`` holds them to
    agree), as EPIC-Kitchens' verb configuration trains."""
    cell = tiny_cell('charades_r101_nl.train')
    for block in (cell.config['model'], cell.config['overrides']):
        block['MODEL.FREEZE_BACKBONE'] = False
    return cell


def test_a_clip_head_training_its_backbone_agrees_with_the_port():
    result, lines = run.run_cell(clip_head_training_its_backbone(),
                                 2 ** 40 + 17, 0.0, False, device='cpu',
                                 t_start=time.perf_counter())
    assert result['correct'], lines
    for key, check in result['checks'].items():
        assert check['value'] <= AGREE[key], (key, check['value'])


class Float64:
    """Every product's operands in float64 (the reference's ``quant``
    hook): in float32 the same whole batch, taken with 4 threads and with
    1, already reads 6.7e-4 apart on a backbone leaf, the last bits moved
    through 101 layers, so only products above float32 leave the order
    of the sums unseen."""

    def __call__(self, x):
        return x.double()

    def out(self, y):
        return y


def test_block_by_block_gradients_equal_the_whole_batch():
    """The reference's clip-head path with a trainable backbone, one clip
    a block, against one forward of the whole batch and one
    ``autograd.grad``: the loss, and each leaf's gap over the larger of
    its norm and the median leaf's, within 1e-5."""
    drv = cells.driver(clip_head_training_its_backbone(), 5, 'cpu')
    drv.prepare()
    net, arch, quant = drv.net, drv.arch, Float64()
    params = drv.weights(arch)
    names = net.trainable_names(arch, list(params))
    assert 'conv1_w' in names
    batch, host = drv.pool[0]
    generator = torch.Generator().manual_seed(drv.train_seed)
    window = drv.window_rows(host, generator)
    masks = net.draw_masks(arch, window.shape[0], generator)
    loss, grads, _ = reftrain.loss_and_grads(
        net, drv.ref_dataset, params, names,
        {'data': batch['data'], 'labels': batch['labels']}, window,
        drv.bank.feats, masks, arch, block=1, quant=quant)

    leaves = {k: params[k].detach().requires_grad_(True) for k in names}
    p = {**params, **leaves}
    feat = net.head_features(p, batch['data'], None, arch, quant)
    logits = net.classify(p, feat, drv.bank.feats[window].float(), arch,
                          masks, quant)
    num = drv.ref_dataset.loss(logits, batch['labels'])
    count = drv.ref_dataset.loss_count(batch['labels'])
    whole = dict(zip(names, torch.autograd.grad(
        num / count, [leaves[k] for k in names])))
    assert loss == pytest.approx(float(num.detach()) / count, rel=1e-5)
    median = float(torch.stack([whole[k].norm() for k in names]).median())
    gaps = {k: float((grads[k] - whole[k]).norm())
            / max(float(whole[k].norm()), median) for k in names}
    assert max(gaps.values()) <= 1e-5, sorted(gaps, key=gaps.get)[-3:]

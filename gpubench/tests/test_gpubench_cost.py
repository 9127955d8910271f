"""The frozen cost model: each hand kernel's bound against the Bound
column of the port's kernel table (PERF.md, from chip_smoke.py's shapes),
the launches a cell's iteration makes, the FLOP counts, and the trace
reduction."""

from __future__ import annotations

import json

import numpy as np
import pytest

from gpubench import layout, roofline, trace
from gpubench.cost import flops
from gpubench.cost import kernels as K
from gpubench.cost import model as L
from gpubench.reference import model as M
from gpubench.reference.datasets import ava as ava_data
from gpubench.reference.datasets import charades as charades_data

B = 16


def ms(*calls):
    return 1e3 * sum(K.bound_s(f, b, d) for _, f, b, d in calls)


def rand_rois(rng, clips, boxes, crop):
    """chip_smoke.py's boxes: 4 a clip, corners uniform in the halves."""
    n = clips * boxes
    return np.stack([
        np.repeat(np.arange(clips), boxes).astype(np.float32),
        rng.uniform(0, crop / 2, n), rng.uniform(0, crop / 2, n),
        rng.uniform(crop / 2, crop, n), rng.uniform(crop / 2, crop, n)],
        axis=1).astype(np.float32)


def test_attention_forward_bound():
    """The 8 calls of one phase-B forward (2 res3, 3 res4, 3 FBO-NL over
    64 box rows): 1.043 ms."""
    calls = ([K.attention_fwd(64, 4096, 1024, 256, 'bfloat16')] * 2
             + [K.attention_fwd(16, 4096, 1024, 512, 'bfloat16')] * 3
             + [K.attention_fwd(64, 1, 300, 512, 'float32')] * 3)
    assert round(ms(*calls), 3) == 1.043


def test_attention_backward_bound():
    """The 8 calls of a train step at B = 16, crop 224: 1.567 ms."""
    calls = ([K.attention_bwd(64, 3136, 784, 256, 'bfloat16')] * 2
             + [K.attention_bwd(16, 3136, 784, 512, 'bfloat16')] * 3
             + [K.attention_bwd(64, 1, 300, 512, 'float32')] * 3)
    assert round(ms(*calls), 3) == 1.567


def test_roi_bounds():
    """chip_smoke.py's boxes (default_rng(0) forward at crop 256,
    default_rng(4) backward at crop 224): 0.0076 and 0.0135 ms."""
    rois = rand_rois(np.random.default_rng(0), B, 4, 256)
    assert round(ms(K.roi_fwd(rois, 16)), 4) == 0.0076
    rois = rand_rois(np.random.default_rng(4), B, 4, 224)
    assert round(ms(K.roi_bwd(rois, B, 14)), 4) == 0.0135


def test_stem_bounds():
    assert round(ms(K.stem_fwd(B, 32, 256, 5)), 3) == 0.798
    assert round(ms(K.stem_dw(B, 32, 224, 5)), 3) == 0.611


def test_bottleneck_bound_of_the_29_flagship_launches():
    model = json.loads((layout.HERE / 'configs' /
                        'ava_r101_nl3l.json').read_text())['model']
    arch = M.Arch(model, 'test')
    calls = [c for c in L.backbone_calls(arch, B, train=False, fused=True,
                                         remat='stage')
             if c[0] == 'fused_bottleneck']
    assert len(calls) == 29
    assert round(ms(*calls), 3) == 7.292


def families(calls):
    out = {}
    for family, *_ in calls:
        out[family] = out.get(family, 0) + 1
    return out


@pytest.mark.parametrize('config,train,fused,want', [
    ('ava_r101_nl3l', False, False, {'stem_conv': 1, 'attention': 5}),
    ('charades_r101_nl', False, True, {'stem_conv': 1, 'attention': 5,
                                       'fused_bottleneck': 29}),
    ('ava_r101_nl3l', True, False, {'stem_conv': 1, 'stem_conv_dw': 1,
                                    'attention': 10, 'attention_bwd': 5}),
    ('charades_r101_nl', True, False, {'stem_conv': 1, 'attention': 5}),
])
def test_backbone_launches(config, train, fused, want):
    """The launches the port's smoke counts a forward or a 'stage' step
    make, less the FBO's: the flagship 13 attention forwards and 8
    backwards a step (3 of each the FBO's), Charades stage 2 7 and 2."""
    model = json.loads((layout.HERE / 'configs' /
                        (config + '.json')).read_text())['model']
    arch = M.Arch(model, 'train' if train else 'test')
    assert families(L.backbone_calls(arch, B, train=train, fused=fused,
                                     remat='stage')) == want
    fbo = families(L.fbo_calls(arch, 64, train=train))
    assert fbo['attention'] == arch.fbo_layers
    assert fbo.get('attention_bwd', 0) == (arch.fbo_layers if train else 0)


def test_flop_counts():
    """The flagship's phase A + B at B = 16 x 4 boxes is 22.69 TF (its
    forward at crop 224 8.57 TF, twice PR 13's 4.288 at B = 8); a train
    step about three forwards; Charades' frozen step about one."""
    ava = json.loads((layout.HERE / 'configs' /
                      'ava_r101_nl3l.json').read_text())['model']
    ch = json.loads((layout.HERE / 'configs' /
                     'charades_r101_nl.json').read_text())['model']
    assert flops.two_phase(M, ava, B, 4) == pytest.approx(22.6905e12,
                                                          rel=1e-4)
    train = flops.train_step(M, ava_data, ava, B, 4)
    assert 2.8 * 8.57e12 < train < 3.0 * 8.57e12
    assert 8.4e12 < flops.train_step(M, charades_data, ch, B, 1) < 8.7e12


def test_trace_summary_and_roofline():
    events = [
        {'ph': 'X', 'cat': 'user_annotation', 'name': trace.MARK,
         'ts': 0.0, 'dur': 100.0},
        {'ph': 'X', 'cat': 'cpu_op', 'name': 'aten::conv', 'ts': 1.0,
         'dur': 30.0},
        {'ph': 'X', 'cat': 'kernel', 'name': 'void stem_conv_wgmma_kernel'
         '(bf16 const*)', 'ts': 10.0, 'dur': 20.0},
        {'ph': 'X', 'cat': 'kernel', 'name': 'cudnn_conv', 'ts': 25.0,
         'dur': 25.0},
        {'ph': 'X', 'cat': 'gpu_memcpy', 'name': 'Memcpy DtoD', 'ts': 80.0,
         'dur': 20.0},
    ]
    got = trace.summarize(events, 1)
    assert got['busy_s'] == pytest.approx(60e-6)
    assert got['window_s'] == pytest.approx(100e-6)
    assert dict(got['device_ops'])['cudnn_conv'] == pytest.approx(25e-6)
    assert dict(got['idle_gaps'])['aten::conv'] == pytest.approx(10e-6)
    call = ('stem_conv', 2e6, 3.35e6, 'bfloat16')      # bound 1 us
    record = {'trace': dict(got, calls=[call])}
    share = roofline.share(record, {'stem_conv': (r'\bstem_conv_\w+\b',
                                                  r'\bstem_conv_\w+\b')})
    assert share == pytest.approx(100.0 * 1e-6 / 20e-6)
    # A family whose calls the trace does not show is left out.
    record = {'trace': dict(got, calls=[call, call])}
    assert roofline.share(record, {'stem_conv': (r'stem', r'stem')}) is None

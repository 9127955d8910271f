"""The span reading (:mod:`gpubench.spans`) on a synthetic Chrome trace of
one train step with a launch from the autograd engine's thread, and the
ten per-layer metrics it feeds, on synthetic records."""

from __future__ import annotations

import pytest

from gpubench import layout, spans, trace

MAIN, AUTOGRAD = (1, 1), (1, 2)


def x(thread, cat, name, ts, dur, corr=None):
    ev = {'ph': 'X', 'cat': cat, 'name': name, 'pid': thread[0],
          'tid': thread[1], 'ts': float(ts), 'dur': float(dur)}
    if corr is not None:
        ev['args'] = {'correlation': corr}
    return ev


def kernel(name, ts, dur, corr):
    return x((0, 7), 'kernel', name, ts, dur, corr)


def launch(thread, ts, corr, dur=1.0, name='cudaLaunchKernel'):
    return x(thread, 'cuda_runtime', name, ts, dur, corr)


# One step: the FBO's forward on the main thread, the backward's recompute
# on the autograd thread, a backward launch from the autograd thread in no
# span of its own, a synchronizing call, and a launch between step calls.
EVENTS = [
    x(MAIN, 'user_annotation', trace.MARK, 0, 200),
    x(MAIN, 'user_annotation', 'lfb.step.train', 5, 185),
    x(MAIN, 'user_annotation', 'lfb.model.fbo', 10, 20),
    x(MAIN, 'cpu_op', 'aten::mm', 11, 5),
    launch(MAIN, 12, 1, dur=2.0),
    kernel('fbo_gemm', 20, 10, 1),
    x(MAIN, 'user_annotation', 'lfb.step.backward', 40, 110),
    x(AUTOGRAD, 'user_annotation', 'lfb.model.recompute', 60, 20),
    launch(AUTOGRAD, 65, 2),
    kernel('conv_recompute', 70, 20, 2),
    launch(AUTOGRAD, 100, 3),
    kernel('conv_dgrad', 100, 30, 3),
    launch(MAIN, 152, 6),
    launch(MAIN, 155, None, dur=30.0, name='cudaStreamSynchronize'),
    kernel('loss_reduce', 186, 4, 6),
    launch(MAIN, 195, 5),
    kernel('bench_copy', 196, 4, 5),
]


def test_kernels_go_to_the_innermost_span_of_their_launching_thread():
    got = spans.attribute(EVENTS)
    table = got['spans']
    assert set(table) == {'lfb.step.train', 'lfb.model.fbo',
                          'lfb.step.backward', 'lfb.model.recompute'}
    us = 1e-6
    want = {  # device_s, launches, host_s (less the spans inside), api_s
        'lfb.model.fbo': (10, 1, 20, 2),
        'lfb.model.recompute': (20, 1, 20, 1),    # the autograd thread's
        'lfb.step.backward': (30, 1, 110, 1),     # no span on its thread
        'lfb.step.train': (4, 1, 185 - 20 - 110, 31),
    }
    for name, (device, launches, host, api) in want.items():
        row = table[name]
        assert row['calls'] == 1
        assert row['device_s'] == pytest.approx(device * us), name
        assert row['launches'] == launches, name
        assert row['host_s'] == pytest.approx(host * us), name
        assert row['api_s'] == pytest.approx(api * us), name
    assert table['lfb.model.fbo']['top'] == [['fbo_gemm',
                                              pytest.approx(10 * us)]]
    assert got['outside']['launches'] == 1
    assert got['outside']['device_s'] == pytest.approx(4 * us)
    assert got['cuda_api'] == {'lfb.step.train': {
        'cudaLaunchKernel': pytest.approx(5 * us),
        'cudaStreamSynchronize': pytest.approx(30 * us)}}


def test_idle_gaps_are_named_by_span():
    idle = dict(spans.attribute(EVENTS)['idle_spans'])
    us = 1e-6
    assert idle == {'lfb.model.fbo': pytest.approx(20 * us),
                    'lfb.step.backward': pytest.approx(50 * us),
                    'lfb.step.train': pytest.approx(56 * us),
                    spans.OUTSIDE: pytest.approx(6 * us)}
    # The same gaps summarize takes, in all.
    summary = trace.summarize(EVENTS, 1)
    assert sum(idle.values()) == pytest.approx(
        summary['window_s'] - summary['busy_s'])


def _record(kind):
    step = 'lfb.step.eval' if kind == 'two_phase' else 'lfb.step.train'
    table = {name: {'calls': 2, 'host_s': host, 'device_s': device,
                    'launches': 1, 'api_s': 0.0}
             for name, host, device in (
                 (step, 0.5, 0.1), ('lfb.bank.gather', 0.002, 0.004),
                 ('lfb.model.fbo', 0.001, 0.02),
                 ('lfb.model.fbo.backward', 0.003, 0.03),
                 ('lfb.model.recompute', 0.004, 0.06),
                 ('lfb.train.optimizer', 0.05, 0.01))}
    return {'kind': kind,
            'trace': {'iterations': 2, 'spans': table,
                      'cuda_api': {step: {'cudaLaunchKernel': 0.03,
                                          'cudaMemcpyAsync': 0.01}}},
            'counters': {'fbo.rows': 1024}, 'real_rows': 64.0}


@pytest.mark.parametrize('name, kind, want', [
    ('bank_gather_ms.infer', 'two_phase', 2.0),
    ('bank_gather_ms.train', 'train', 2.0),
    ('fbo_ms.infer', 'two_phase', 10.0),
    ('fbo_ms.train', 'train', 25.0),
    ('fbo_real_rows_pct.infer', 'two_phase', 12.5),
    ('fbo_real_rows_pct.train', 'train', 12.5),
    ('recompute_ms.train', 'train', 30.0),
    ('optimizer_ms.train', 'train', 25.0),
    ('cuda_api_ms.infer', 'two_phase', 20.0),
    ('cuda_api_ms.train', 'train', 20.0),
])
def test_span_metrics_read_a_record(name, kind, want):
    read = layout.cell('ava_r101_nl3l.train').metric_reader(name)
    assert read(_record(kind)) == pytest.approx(want)
    other = 'train' if kind == 'two_phase' else 'two_phase'
    assert read(_record(other)) is None
    # A record without the program's spans and counters, as a program
    # without them or run.py's record gives, reads nothing.
    bare = _record(kind)
    bare['trace'] = {'iterations': 2}
    del bare['counters'], bare['real_rows']
    assert read(bare) is None
    assert read({'kind': kind, 'trace': None}) is None


def test_long_api_calls_are_named_by_span_and_host_operation(monkeypatch):
    monkeypatch.setattr(spans, 'BLOCKING_US', 2.0)
    assert spans.attribute(EVENTS)['blocking'] == {
        'lfb.step.train | - | cudaStreamSynchronize': pytest.approx(30e-6),
        'lfb.model.fbo | aten::mm | cudaLaunchKernel': pytest.approx(2e-6)}

"""The port's spans and counters (``lfb_tpu_torch/utils/profiling.py``) on
the CPU, on a tiny AVA spec (R50, T 8, crop 32, a bank of 2 videos,
'stage' remat):

* under ``torch.profiler`` an eval step and a train step emit every span
  of the step, the bank, the model and the optimizer, nested as named;
  the recompute appears only inside the backward, once per stage, and
  ``lfb.model.fbo.backward`` holds the backward of every FBO operation and
  no other but the parameters' gradient accumulation;
* with no profiler the same steps open no profiler range, and the
  counters advance by the rows, tensors and regions the steps handle;
* a ``PROF_DAG`` trace written by ``StepTrace`` holds the train steps'
  spans;
* an EPIC noun bank's row choice is ``lfb.bank.choose`` inside the step's
  ``lfb.bank.gather``, counts the N x M table entries it scans, and gathers
  the host sampler's rows.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip('torch')

from lfb_tpu_torch.bank.device_bank import (AVA_SEC_BASE, AvaDeviceBank,  # noqa: E402
                                            FrameDeviceBank)
from lfb_tpu_torch.config import epic_noun_cfg, flagship_cfg  # noqa: E402
from lfb_tpu_torch.data.epic import sample_noun_lfb  # noqa: E402
from lfb_tpu_torch.models.model import init_params  # noqa: E402
from lfb_tpu_torch.models.spec import build_spec  # noqa: E402
from lfb_tpu_torch.train import optimizer as opt  # noqa: E402
from lfb_tpu_torch.train.steps import (_inject_device_bank_lfb,  # noqa: E402
                                       make_eval_step, make_train_step,
                                       split_params)
from lfb_tpu_torch.utils import profiling  # noqa: E402
from tests.torch_threads import worker_threads  # noqa: E402,F401

CFG = {'MODEL.DEPTH': 50, 'MODEL.VIDEO_ARC_CHOICE': 2,
       'TRAIN.VIDEO_LENGTH': 8, 'TEST.VIDEO_LENGTH': 8,
       'TRAIN.CROP_SIZE': 32, 'TEST.CROP_SIZE': 32, 'LFB.WINDOW_SIZE': 2,
       'TPU.COMPUTE_DTYPE': 'float32', 'TPU.REMAT': 'stage', 'NUM_GPUS': 1}
CLIPS, BOXES = 2, 2
STAGES = ('lfb.model.res2', 'lfb.model.res3', 'lfb.model.res4',
          'lfb.model.res5')
MODEL = ('lfb.bank.gather', 'lfb.model.stem') + STAGES + (
    'lfb.model.head', 'lfb.model.fbo', 'lfb.model.classifier')
TRAIN = ('lfb.step.loss', 'lfb.step.backward', 'lfb.train.optimizer',
         'lfb.step.bn_update')


@pytest.fixture(scope='module')
def tiny():
    cfg = flagship_cfg(CFG)
    rng = np.random.RandomState(0)
    secs = range(AVA_SEC_BASE, AVA_SEC_BASE + 12)
    host = {v: {s: [rng.randn(cfg.LFB.LFB_DIM).astype('f')
                    for _ in range(2)] for s in secs} for v in range(2)}
    bank = AvaDeviceBank.build(host, window_size=cfg.LFB.WINDOW_SIZE,
                               k=cfg.AVA.LFB_MAX_NUM_FEAT_PER_STEP,
                               lfb_dim=cfg.LFB.LFB_DIM, device='cpu')
    n, crop = CLIPS * BOXES, 32
    batch = {k: torch.from_numpy(v) for k, v in {
        'data': rng.randint(0, 256, (CLIPS, 8, crop, crop, 3)).astype(
            np.uint8),
        'proposals': np.stack([
            np.repeat(np.arange(CLIPS), BOXES).astype('f'),
            rng.uniform(0, crop / 2, n), rng.uniform(0, crop / 2, n),
            rng.uniform(crop / 2, crop, n), rng.uniform(crop / 2, crop, n)],
            axis=1).astype('f'),
        'metadata': np.stack([
            rng.randint(0, 2, n), rng.randint(AVA_SEC_BASE + 2,
                                              AVA_SEC_BASE + 8, n),
            np.full(n, 400), np.full(n, 600)], axis=1).astype('f'),
        'box_mask': np.ones(n, 'f'),
        'labels': (rng.rand(n, 80) < 0.1).astype('f')}.items()}
    spec = build_spec(cfg, 'train')
    params = init_params(spec, torch.Generator().manual_seed(0))
    train, frozen = split_params(spec, params)
    state = opt.init_state(params, set(frozen))
    generator = torch.Generator().manual_seed(0)
    eval_step = make_eval_step(build_spec(cfg, 'test'), bank=bank)
    train_step = make_train_step(spec, cfg.SOLVER, bank=bank)

    def run_eval():
        eval_step(params, batch)

    def run_train():
        train_step(train, frozen, state, batch, generator, 0.01)

    return {'eval': run_eval, 'train': run_train, 'spec': spec,
            'tensors': len(state.momentum), 'bank': bank}


def _events(prof, tmp_path):
    path = tmp_path / 'trace.json'
    prof.export_chrome_trace(str(path))
    return json.loads(path.read_text())['traceEvents']


def _spans(events, name):
    return [(e['ts'], e['ts'] + e['dur']) for e in events
            if e.get('ph') == 'X' and e.get('name') == name]


def _within(inner, outer):
    return outer[0] <= inner[0] and inner[1] <= outer[1]


def test_steps_emit_their_spans_nested_under_a_profiler(tiny, tmp_path):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        tiny['eval']()
        tiny['train']()
    events = _events(prof, tmp_path)
    (step_eval,), (step_train,) = (_spans(events, 'lfb.step.eval'),
                                   _spans(events, 'lfb.step.train'))
    for name in MODEL:
        in_eval, in_train = _spans(events, name)
        assert _within(in_eval, step_eval) and _within(in_train, step_train)
    for choose, gather in zip(_spans(events, 'lfb.bank.choose'),
                              _spans(events, 'lfb.bank.gather'), strict=True):
        assert _within(choose, gather)
    for name in TRAIN:
        (span,) = _spans(events, name)
        assert _within(span, step_train)
    (backward,) = _spans(events, 'lfb.step.backward')
    recompute = _spans(events, 'lfb.model.recompute')
    assert len(recompute) == len(STAGES)
    assert all(_within(r, backward) for r in recompute)
    (fbo_bwd,) = _spans(events, 'lfb.model.fbo.backward')
    assert _within(fbo_bwd, backward)
    assert not any(_within(fbo_bwd, r) or _within(r, fbo_bwd)
                   for r in recompute)

    # The FBO's backward: every backward node of an operation recorded
    # under the train step's lfb.model.fbo runs inside the span, and every
    # node inside it is one of them or a parameter's accumulation.
    fbo = _spans(events, 'lfb.model.fbo')[1]
    ops = [e for e in events if e.get('cat') == 'cpu_op']
    seqs = {e['args']['Sequence number'] for e in ops
            if _within((e['ts'], e['ts']), fbo)
            and 'Sequence number' in e.get('args', {})}
    nodes = [e for e in ops if e['name'].startswith('autograd::engine')
             and '_EdgeBackward' not in e['name']]
    fbo_nodes = [e for e in nodes if e['args'].get('Sequence number') in seqs]
    assert len(fbo_nodes) > 20
    assert all(_within((e['ts'], e['ts'] + e['dur']), fbo_bwd)
               for e in fbo_nodes)
    inside = [e for e in nodes if _within((e['ts'], e['ts']), fbo_bwd)]
    assert {e['name'] for e in inside if e not in fbo_nodes} == {
        'autograd::engine::evaluate_function: '
        'torch::autograd::AccumulateGrad'}


def test_steps_open_no_range_without_a_profiler_and_count(tiny,
                                                          monkeypatch):
    def refuse(name):
        raise AssertionError('a profiler range was opened: ' + name)

    monkeypatch.setattr(profiling._autograd_profiler, 'record_function',
                        refuse)
    assert not torch.autograd.profiler._is_profiler_enabled
    spec = tiny['spec']
    rows = CLIPS * BOXES
    window = rows * spec.fbo.num_lfb_feat
    bank = tiny['bank']
    scanned = rows * bank.window_size * bank.table.shape[-1]
    before = profiling.counts()
    tiny['eval']()
    eval_counts = profiling.counts()
    tiny['train']()
    after = profiling.counts()

    def grew(a, b):
        return {k: b[k] - a.get(k, 0) for k in b if b[k] != a.get(k, 0)}

    assert grew(before, eval_counts) == {
        'bank.rows': window, 'bank.bytes': window * spec.fbo.lfb_dim * 4,
        'bank.scanned': scanned, 'fbo.rows': rows}
    assert grew(eval_counts, after) == {
        'bank.rows': window, 'bank.bytes': window * spec.fbo.lfb_dim * 4,
        'bank.scanned': scanned, 'fbo.rows': rows,
        'optimizer.tensors': tiny['tensors'], 'remat.regions': len(STAGES)}


def test_prof_dag_trace_holds_the_train_step_spans(tiny, tmp_path):
    trace = profiling.StepTrace(True, 0, str(tmp_path), 'cpu')
    for it in range(5):
        trace.step(it)
        tiny['train']()
    trace.close()
    events = json.loads((tmp_path / 'prof_dag_trace.json').read_text())[
        'traceEvents']
    assert len(_spans(events, 'lfb.step.train')) == 3
    assert len(_spans(events, 'lfb.model.recompute')) == 3 * len(STAGES)


def test_backward_span_closes_when_the_backward_ends(tmp_path):
    """A region whose input needs no gradient (the FBO over a frozen
    backbone's features): the span opens at the region's output and closes
    when the backward ends, after the region's nodes and none before."""
    w = torch.randn(4, 4, requires_grad=True)
    x = torch.randn(3, 4)
    assert profiling.backward_span('off').input(x) is x
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        marks = profiling.backward_span('region.backward')
        y = marks.output(marks.input(x) @ w)
        loss = (y * 2.0).sum()
        torch.autograd.grad(loss, [w])
    events = _events(prof, tmp_path)
    (region,) = _spans(events, 'region.backward')
    nodes = {e['name'].split(': ')[-1]: (e['ts'], e['ts'] + e['dur'])
             for e in events if e.get('cat') == 'cpu_op'
             and e['name'].startswith('autograd::engine')}
    assert _within(nodes['MmBackward0'], region)
    assert not _within(nodes['MulBackward0'], region)


def test_noun_bank_choice_is_a_span_inside_the_gather(tmp_path):
    """An EPIC noun device bank at the released window (120 rows, up to 10
    boxes a detector frame, 1 detector frame a second at 30 fps) over
    frames with 0 to 10 boxes: a step's gather opens ``lfb.bank.choose``
    inside ``lfb.bank.gather``, ``bank.scanned`` grows by N x M, and the
    windows are the host sampler's, bit for bit, with and without a
    profiler."""
    cfg = epic_noun_cfg({'TPU.REMAT': ''})
    spec = build_spec(cfg, 'train')
    window, dim = cfg.LFB.WINDOW_SIZE, 16
    k = cfg.EPIC.MAX_NUM_FEATS_PER_NOUN_LFB_FRAME
    rng = np.random.default_rng(3)
    host = {v: {30 * (f + 1): rng.standard_normal((n, dim)).astype('f')
                for f, n in enumerate(rng.integers(0, k + 1, 40))}
            for v in range(2)}
    host[1][60] = host[1][60][:0]           # an empty frame
    host[1][90] = rng.standard_normal((k, dim)).astype('f')
    bank = FrameDeviceBank.build_noun(
        host, window_size=window, max_per_frame=k,
        frames_per_second=cfg.EPIC.NOUN_LFB_FRAMES_PER_SECOND,
        fps=cfg.EPIC.FPS, lfb_dim=dim, device='cpu')
    video = torch.tensor([0, 1, 1, 0])
    center = torch.tensor([0, 95, 650, 1210])
    batch = {'lfb_video_idx': video, 'lfb_center': center}
    before = profiling.counts().get('bank.scanned', 0)
    plain = _inject_device_bank_lfb(spec, bank, batch, None)['lfb']
    assert profiling.counts()['bank.scanned'] - before == (
        video.numel() * bank.frame_ids.shape[1])
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        traced = _inject_device_bank_lfb(spec, bank, batch, None)['lfb']
    events = _events(prof, tmp_path)
    (choose,), (gather,) = (_spans(events, 'lfb.bank.choose'),
                            _spans(events, 'lfb.bank.gather'))
    assert _within(choose, gather)
    assert torch.equal(traced, plain)
    for v, c, rows in zip(video.tolist(), center.tolist(), plain.numpy()):
        np.testing.assert_array_equal(rows, sample_noun_lfb(
            host[v], c, window_size=window, max_per_frame=k,
            frames_per_second=cfg.EPIC.NOUN_LFB_FRAMES_PER_SECOND,
            fps=cfg.EPIC.FPS, lfb_dim=dim))
    assert (plain.abs().sum(-1) > 0).sum() > window

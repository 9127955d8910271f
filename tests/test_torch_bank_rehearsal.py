"""The port's bank rehearsal (``lfb_tpu_torch.tools.bank_rehearsal``) held to
the JAX tool (``tools/bank_rehearsal.py``) and ``lfb_tpu`` on the CPU, and
the launcher's TF32 flags.

Bitwise: the synthesized banks (two seeds, a few videos, both AVA fills,
Charades' 600-entry video), the configs key for key, the batches, the
device banks' features and index tables.  The eval prob of one inference
rung and the first loss of one train rung run both tools' ladders on the
same bank, batch and weights (``params_from_jax``), at a tiny R50 size in
f32, and are held at the f32 tolerances of ``tests/test_torch_model.py``
(1e-3 of the largest prob plus 1e-4) and ``tests/test_torch_train.py``
(the loss at 1e-5 relative).  The two packages draw an AVA window's K of a
second's features with other generators, so the tiny config keeps K at 25,
the count's clip, and both take every row of a second; Charades windows
are deterministic.  Dropout is off (the packages draw other masks).
"""

import io
import json
import os
import sys
from contextlib import redirect_stdout

import numpy as np
import pytest

torch = pytest.importorskip('torch')

import jax.numpy as jnp  # noqa: E402

import lfb_tpu.models as jax_models  # noqa: E402
import lfb_tpu.train.steps as jax_steps  # noqa: E402
from lfb_tpu.core.config import clone as jax_clone  # noqa: E402
from lfb_tpu_torch.config import flagship_cfg  # noqa: E402
from lfb_tpu_torch.convert import params_from_jax  # noqa: E402
from lfb_tpu_torch.core.config import clone  # noqa: E402
from lfb_tpu_torch.parallel import launch  # noqa: E402
from lfb_tpu_torch.tools import bank_rehearsal as br  # noqa: E402
from tests import torch_parallel_ranks  # noqa: E402
from tests.test_torch_config import assert_same_config  # noqa: E402
from tests.test_torch_model import close, perturbed_params  # noqa: E402
from tests.torch_threads import worker_threads  # noqa: E402,F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, 'tools'))
import bank_rehearsal as jax_tool  # noqa: E402

# The rehearsal's model cut to seconds on the CPU: R50 at narrow widths, T
# 8, crop 32, a 2 s window, f32, no dropout, XLA references on the lfb_tpu
# side; K 25 (see the module docstring).
TINY = {'MODEL.DEPTH': 50, 'MODEL.VIDEO_ARC_CHOICE': 2,
        'RESNETS.WIDTH_PER_GROUP': 8, 'FBO_NL.LATENT_DIM': 64,
        'TRAIN.VIDEO_LENGTH': 8, 'TEST.VIDEO_LENGTH': 8,
        'TRAIN.CROP_SIZE': 32, 'TEST.CROP_SIZE': 32, 'LFB.WINDOW_SIZE': 2,
        'AVA.LFB_MAX_NUM_FEAT_PER_STEP': 25, 'TPU.COMPUTE_DTYPE': 'float32',
        'FBO_NL.DROPOUT_RATE': 0.0, 'TPU.USE_PALLAS': False}
VIDEOS = {'ava': 3, 'charades': 4}


def tiny_cfgs(dataset, dtype='float32', sharded=False):
    return (clone(br.flagship_cfg(dataset, dtype, sharded), TINY),
            jax_clone(jax_tool.flagship_cfg(dataset, dtype, sharded), TINY))


@pytest.fixture
def tiny(monkeypatch):
    """Both tools' ``flagship_cfg`` at the tiny size."""
    port, jax = br.flagship_cfg, jax_tool.flagship_cfg
    monkeypatch.setattr(br, 'flagship_cfg',
                        lambda *a: clone(port(*a), TINY))
    monkeypatch.setattr(jax_tool, 'flagship_cfg',
                        lambda *a: jax_clone(jax(*a), TINY))
    yield
    br.forget_draws()


def synthesize(tool, case, seed):
    dataset, fast = case
    if dataset == 'ava':
        return tool.synthesize_ava_host_bank(VIDEOS['ava'], seed=seed,
                                             fast_fill=fast)
    return tool.synthesize_charades_host_bank(VIDEOS['charades'], seed=seed)


@pytest.mark.parametrize('seed', [0, 3])
@pytest.mark.parametrize('case', [('ava', False), ('ava', True),
                                  ('charades', None)])
def test_synthesized_banks_are_the_jax_tools(case, seed):
    (mine, rows), (ref, ref_rows) = (synthesize(t, case, seed)
                                     for t in (br, jax_tool))
    assert rows == ref_rows and sorted(mine) == sorted(ref)
    n = 0
    for video, entries in ref.items():
        assert sorted(mine[video]) == sorted(entries)
        for key, feats in entries.items():
            got = mine[video][key]
            if case[0] == 'ava':
                assert len(got) == len(feats)
            np.testing.assert_array_equal(np.asarray(got), np.asarray(feats))
            n += len(feats) if case[0] == 'ava' else 1
    assert n == rows
    if case[0] == 'charades':
        assert len(mine[0]) == 600 == max(len(v) for v in mine.values())


@pytest.mark.parametrize('dataset', ['ava', 'charades'])
@pytest.mark.parametrize('dtype,sharded', [('float32', False),
                                           ('bfloat16', False),
                                           ('float32', True)])
def test_flagship_cfg_is_the_jax_tools(dataset, dtype, sharded):
    mine = br.flagship_cfg(dataset, dtype, sharded)
    assert_same_config(mine, jax_tool.flagship_cfg(dataset, dtype, sharded))
    assert mine.TPU.BANK_DTYPE == dtype and mine.TPU.BANK_SHARDED == sharded
    # The JAX tool's model, not the released YAML's training settings.
    assert mine.MODEL.BN_INIT_GAMMA == 1.0
    assert flagship_cfg().MODEL.BN_INIT_GAMMA == 0.0


@pytest.mark.parametrize('dataset', ['ava', 'charades'])
def test_make_batch_is_the_jax_tools(dataset):
    cfg, jcfg = tiny_cfgs(dataset)
    spec = jax_models.build_spec(jcfg, 'test')
    try:
        # A rung after a larger one (cached draws), then one beyond them.
        for b in (3, 1, 5):
            mine = br.make_batch(cfg, None, b, VIDEOS[dataset], device='cpu')
            ref = jax_tool.make_batch(jcfg, spec, b, VIDEOS[dataset])
            assert sorted(mine) == sorted(ref)
            for key, value in ref.items():
                assert mine[key].numpy().dtype == np.asarray(value).dtype
                np.testing.assert_array_equal(mine[key].numpy(),
                                              np.asarray(value), err_msg=key)
    finally:
        br.forget_draws()


@pytest.mark.parametrize('dataset', ['ava', 'charades'])
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_device_bank_and_its_tables_are_lfb_tpus(dataset, dtype):
    cfg, jcfg = tiny_cfgs(dataset, dtype)
    host_bank, _ = synthesize(br, (dataset, False), 0)
    bank, stats = br.build_device_bank_timed(cfg, host_bank, 'cpu')
    jbank, jstats = jax_tool.build_device_bank_timed(jcfg, host_bank)
    assert sorted(stats) == sorted(jstats)
    assert stats['table_width'] == jstats['table_width']
    assert stats['feat_gb'] == jstats['feat_gb']
    names = ('table', 'counts') if dataset == 'ava' else ('frame_ids', 'rows')
    entries = 0
    for name in names:
        mine = getattr(bank, name)
        assert mine.dtype == torch.int64
        np.testing.assert_array_equal(mine.numpy(),
                                      np.asarray(getattr(jbank, name)))
        entries += mine.numel()
    # The port's int64 tables: twice the JAX tool's int32 figure.
    assert stats['index_mib'] == round(entries * 8 / 2 ** 20, 1)
    assert stats['index_mib'] == pytest.approx(2 * jstats['index_mib'],
                                               abs=0.1)
    assert bank.feats.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(
        bank.feats.float().numpy(), np.asarray(jbank.feats, np.float32))
    if dataset == 'charades':
        assert stats['table_width'] == 600


def capture(module, name, monkeypatch, calls):
    """Wrap ``module.name`` (a step factory) so each step's calls append
    their (args, output) to ``calls``."""
    real = getattr(module, name)

    def factory(*a, **k):
        step = real(*a, **k)

        def run(*args):
            out = step(*args)
            calls.append((args, out))
            return out
        return run
    monkeypatch.setattr(module, name, factory)


def same_params(monkeypatch, params):
    """Both tools' ``init_params`` give ``params`` (lfb_tpu's layout)."""
    monkeypatch.setattr(jax_models, 'init_params', lambda key, spec: {
        k: jnp.asarray(v) for k, v in params.items()})
    monkeypatch.setattr(br, 'init_params', lambda spec, generator:
                        params_from_jax(params, device='cpu'))


def test_inference_rung_matches_lfb_tpu(tiny, monkeypatch):
    """One rung of both inference ladders on the same AVA bank, batch and
    weights: the eval step's prob within 1e-3 of lfb_tpu's."""
    cfg = br.flagship_cfg('ava', 'float32', False)
    jcfg = jax_tool.flagship_cfg('ava', 'float32', False)
    params = perturbed_params(jax_models.build_spec(jcfg, 'test'),
                              np.random.RandomState(4))
    same_params(monkeypatch, params)
    jcalls, calls = [], []
    capture(jax_steps, 'make_eval_step', monkeypatch, jcalls)
    capture(br, 'make_eval_step', monkeypatch, calls)
    host_bank, _ = synthesize(br, ('ava', False), 0)
    jbank, _ = jax_tool.build_device_bank_timed(jcfg, host_bank)
    ref = jax_tool.run_inference_ladder(jcfg, jbank, VIDEOS['ava'], [2], 1,
                                        False)
    bank, _ = br.build_device_bank_timed(cfg, host_bank, 'cpu')
    got = br.run_inference_ladder(cfg, bank, VIDEOS['ava'], [2], 1, False,
                                  'cpu')
    assert [sorted(r) for r in got] == [sorted(r) for r in ref] == [
        ['batch', 'clips_per_sec', 'ms_per_step']]
    assert len(calls) == len(jcalls) == 2
    prob, jprob = calls[0][1]['prob'], np.asarray(jcalls[0][1]['prob'])
    assert prob.shape == jprob.shape == (8, 80)
    close(prob, jprob)
    assert np.abs(np.asarray(jcalls[0][1]['logits'])).max() > 1.0


def test_train_rung_matches_lfb_tpu(tiny, monkeypatch):
    """One rung of both train ladders on the same Charades bank, batch and
    weights: the same batch bitwise, the first step's loss within 1e-5."""
    cfg = br.flagship_cfg('charades', 'float32', False)
    jcfg = jax_tool.flagship_cfg('charades', 'float32', False)
    params = perturbed_params(
        jax_models.build_spec(jax_clone(jcfg, {'TPU.REMAT': ''}), 'train'),
        np.random.RandomState(5))
    same_params(monkeypatch, params)
    jcalls, calls = [], []
    capture(jax_steps, 'make_train_step', monkeypatch, jcalls)
    capture(br, 'make_train_step', monkeypatch, calls)
    host_bank, _ = synthesize(br, ('charades', None), 0)
    jbank, _ = jax_tool.build_device_bank_timed(jcfg, host_bank)
    ref = jax_tool.run_train_ladder(jcfg, jbank, VIDEOS['charades'], [2], 1)
    bank, _ = br.build_device_bank_timed(cfg, host_bank, 'cpu')
    got = br.run_train_ladder(cfg, bank, VIDEOS['charades'], [2], 1,
                              device='cpu')
    assert [sorted(r) for r in got] == [sorted(r) for r in ref] == [
        ['batch', 'clips_per_sec', 'ms_per_step']]
    assert len(calls) == len(jcalls) == 2
    batch, jbatch = calls[0][0][3], jcalls[0][0][3]
    assert sorted(batch) == sorted(jbatch) == [
        'data', 'labels', 'lfb_center', 'lfb_video_idx']
    for key, value in jbatch.items():
        np.testing.assert_array_equal(batch[key].numpy(), np.asarray(value),
                                      err_msg=key)
    loss, jloss = calls[0][1][3]['loss'].item(), float(jcalls[0][1][3]['loss'])
    np.testing.assert_allclose(loss, jloss, rtol=1e-5)
    assert np.isfinite(loss) and loss > 0


def test_train_batch_is_the_jax_tools_for_ava(tiny, monkeypatch):
    """The AVA train batch (train-sized data and proposals, box mask,
    labels) against the one the JAX tool's train ladder builds."""
    cfg = br.flagship_cfg('ava', 'float32', False)
    jcfg = jax_tool.flagship_cfg('ava', 'float32', False)
    jcalls = []

    def fake_step(*a, **k):
        def step(*args):
            jcalls.append(args[3])
            raise RuntimeError('RESOURCE_EXHAUSTED: stop here')
        return step
    monkeypatch.setattr(jax_steps, 'make_train_step', fake_step)
    monkeypatch.setattr(jax_models, 'init_params', lambda key, spec: {})
    assert jax_tool.run_train_ladder(jcfg, None, VIDEOS['ava'], [3], 1) == [
        {'batch': 3, 'oom': True}]
    batch = br.make_train_batch(cfg, 3, VIDEOS['ava'], device='cpu')
    assert sorted(batch) == sorted(jcalls[0]) == [
        'box_mask', 'data', 'labels', 'metadata', 'proposals']
    for key, value in jcalls[0].items():
        np.testing.assert_array_equal(batch[key].numpy(), np.asarray(value),
                                      err_msg=key)


@pytest.mark.parametrize('exc,oom', [
    (torch.OutOfMemoryError('CUDA out of memory. Tried to allocate 2 GiB'),
     True),
    (RuntimeError('CUDA error: out of memory'), True),
    (RuntimeError('cuDNN error: CUDNN_STATUS_ALLOC_FAILED'), True),
    (RuntimeError('CUBLAS_STATUS_ALLOC_FAILED when calling cublasCreate'),
     True),
    (RuntimeError('shape mismatch'), False),
    (ValueError('out of memory'), False),
    (TimeoutError('inference B=8 exceeded 900s'), False)])
def test_is_oom(exc, oom):
    assert br._is_oom(exc) is oom


LADDERS = {
    'inference': ('make_eval_step',
                  lambda cfg, bank, b, log: br.run_inference_ladder(
                      cfg, bank, VIDEOS['ava'], b, 1, False, 'cpu', log)),
    'extract': ('make_eval_step',
                lambda cfg, bank, b, log: br.run_extract(
                    cfg, VIDEOS['ava'], b, 1, 'cpu', log)),
    'train': ('make_train_step',
              lambda cfg, bank, b, log: br.run_train_ladder(
                  cfg, bank, VIDEOS['ava'], b, 1, False, 'cpu', log))}


@pytest.mark.parametrize('ladder', sorted(LADDERS))
def test_ladder_control_flow(tiny, monkeypatch, ladder):
    """Fake steps by batch size: an OOM records the rung and goes down, a
    stall records it and stops, any other exception propagates, and the
    first rung that fits ends the ladder."""
    factory, run = LADDERS[ladder]
    raises = {8: torch.OutOfMemoryError('CUDA out of memory.'),
              6: RuntimeError('CUDNN_STATUS_ALLOC_FAILED'),
              5: TimeoutError('stalled'), 3: ValueError('a bug')}

    def fake(*a, **k):
        def step(*args):
            b = args[-1 if ladder != 'train' else 3]['data'].shape[0]
            if b in raises:
                raise raises[b]
            return {'loss': torch.tensor(1.0)} if ladder != 'train' else \
                (args[0], args[1], args[2], {'loss': torch.tensor(1.0)})
        return step
    monkeypatch.setattr(br, factory, fake)
    cfg = br.flagship_cfg('ava', 'float32', False)
    bank = None if ladder == 'extract' else br.build_device_bank_timed(
        cfg, synthesize(br, ('ava', True), 0)[0], 'cpu')[0]
    log = []
    got = run(cfg, bank, [8, 6, 4, 2], log)
    assert got[:2] == [{'batch': 8, 'oom': True}, {'batch': 6, 'oom': True}]
    assert len(got) == 3 and got[2]['batch'] == 4
    assert 'clips_per_sec' in got[2] and 'oom' not in got[2]
    assert [(r['ladder'], r['batch'], r['allocated_after'])
            for r in log] == [(ladder, 8, 0), (ladder, 6, 0)]
    assert run(cfg, bank, [6, 5, 4], None) == [{'batch': 6, 'oom': True},
                                               {'batch': 5, 'stall': True}]
    with pytest.raises(ValueError, match='a bug'):
        run(cfg, bank, [8, 3, 2], None)


def report_keys(report):
    return sorted(report), [sorted(run) for run in report['runs']]


ARGS = ['--videos', '2', '--batches', '2', '--iters', '1', '--extract',
        '--train', '--train-batches', '2']


def test_main_prints_the_jax_tools_report(tiny, monkeypatch):
    """``main(['--device', 'cpu', ...])`` at the tiny size prints a report
    with the JAX tool's keys: its ``main`` on the same arguments, with the
    ladders (held to the port's above) stubbed, gives the outer keys."""
    out = io.StringIO()
    with redirect_stdout(out):
        report = br.main(['--device', 'cpu'] + ARGS)
    assert json.loads(out.getvalue().strip().splitlines()[-1]) == report
    stub = [{'batch': 2, 'clips_per_sec': 1.0}]
    for name in ('run_inference_ladder', 'run_extract', 'run_train_ladder'):
        monkeypatch.setattr(jax_tool, name, lambda *a, **k: stub)
    monkeypatch.setattr(sys, 'argv', ['bank_rehearsal.py'] + ARGS)
    out = io.StringIO()
    with redirect_stdout(out):
        jax_tool.main()
    ref = json.loads(out.getvalue().strip().splitlines()[-1])
    assert report_keys(report) == report_keys(ref)
    assert [r['bank_dtype'] for r in report['runs']] == [
        'float32', 'bfloat16']
    for key in ('dataset', 'videos', 'bank_rows', 'sharded'):
        assert report[key] == ref[key]
    run = report['runs'][0]
    for key in ('inference', 'extract', 'train'):
        assert 'clips_per_sec' in run[key][-1], key


def test_main_sharded_runs_in_a_one_rank_group(tiny):
    out = io.StringIO()
    with redirect_stdout(out):
        report = br.main(['--device', 'cpu', '--sharded', '--bank-dtype',
                          'float32', '--videos', '2', '--batches', '2',
                          '--iters', '1'])
    assert report['sharded'] is True
    assert 'clips_per_sec' in report['runs'][0]['inference'][-1]
    assert not torch.distributed.is_initialized()


def test_main_runs_on_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip('this host has a card')
    with pytest.raises(RuntimeError, match='CUDA device'):
        br.main(['--videos', '1'])


@pytest.fixture
def tf32_on():
    before = (torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    yield
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = before


@pytest.mark.parametrize('world', [1, 2])
def test_every_rank_runs_without_tf32(tf32_on, tmp_path, world):
    """``launch.run`` hands ``fn`` a process with both TF32 flags off: in
    this process at world 1, in each spawned gloo rank at world 2 (a spawned
    process starts from PyTorch's defaults, cuDNN's flag on)."""
    cfg = flagship_cfg({'NUM_GPUS': world, 'TRAIN.BATCH_SIZE': 2,
                        'TEST.BATCH_SIZE': 2, 'CHECKPOINT.DIR': str(tmp_path)})
    flags = launch.run(torch_parallel_ranks.tf32_flags, cfg, 'cpu')
    assert flags == [(False, False)] * world

"""The port's ``Trainer`` (``lfb_tpu_torch/train/trainer.py``) and
rematerialization (``TPU.REMAT``) against lfb_tpu on the CPU.

* ``_load_initial`` in the reference's four cases (resume from the latest
  checkpoint with momentum; ``TRAIN.PARAMS_FILE`` with ``CONVERT_MODEL``;
  ``RESUME_FROM_BATCH_SIZE``; ``RESET_START_ITER``): the port's trainer
  built on the tiny AVA split of ``tests/synthetic.py`` (LFB off) and
  ``lfb_tpu``'s ``_load_initial`` from the same pickles and initial
  params, their start iteration, LR, params and momentum bitwise.
* ``_update_lr`` over a warm-up and two LR steps: the LRs, the momentum
  buffers after each rescale (bitwise) and the logged rescales.
* The NaN watchdog, and the card as the default device.
* One train step of the flagship arc cut to R50, T 8, crop 32, f32, no
  dropout, under each ``TPU.REMAT`` mode, from the same params and batch:
  the loss and the updated params and momentum bitwise the same in every
  mode (the recompute runs the same CPU ops on the same inputs); under
  'stage', loss and prob within 1e-5 of lfb_tpu's 'stage' step and each
  updated param within 1e-5 of its largest value; the bytes the forward
  saves for the backward (``saved_tensors_hooks``) under 'stage' under a
  fifth of those under ''; and the calls of the kernels' plain versions in
  one step, which on the card are the kernels' launches.
"""

import logging
import os
import shutil
import types
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip('torch')
pytest.importorskip('cv2')

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import lfb_tpu.models as jax_models  # noqa: E402
from lfb_tpu.core.config import load_config as jax_load_config  # noqa: E402
from lfb_tpu.models import model as jax_model  # noqa: E402
from lfb_tpu.train import optimizer as jax_opt  # noqa: E402
from lfb_tpu.train.checkpoints import tpu_to_c2  # noqa: E402
from lfb_tpu.train.steps import make_train_step as jax_make_train_step  # noqa: E402
from lfb_tpu.train.steps import split_params as jax_split_params  # noqa: E402
from lfb_tpu.train.trainer import Trainer as JaxTrainer  # noqa: E402
from lfb_tpu_torch.config import charades_cfg, flagship_cfg  # noqa: E402
from lfb_tpu_torch.convert import params_from_jax, params_to_jax  # noqa: E402
from lfb_tpu_torch.core.config import load_config  # noqa: E402
from lfb_tpu_torch.models.model import init_params  # noqa: E402
from lfb_tpu_torch.models.spec import build_spec  # noqa: E402
from lfb_tpu_torch.ops import cuda_attention, cuda_roi_align, cuda_stem  # noqa: E402
from lfb_tpu_torch.tools import train_net  # noqa: E402
from lfb_tpu_torch.train import checkpoints as port_ckpt  # noqa: E402
from lfb_tpu_torch.train import optimizer as opt  # noqa: E402
from lfb_tpu_torch.train.steps import make_train_step, split_params  # noqa: E402
from lfb_tpu_torch.train.trainer import Trainer  # noqa: E402
from tests import synthetic  # noqa: E402
from tests.test_torch_model import perturbed_params  # noqa: E402
from tests.test_torch_tools import AVA_YAML, TINY, dataset_opts  # noqa: E402
from tests.test_torch_train import STEP_CFG, close, t  # noqa: E402

# The tiny AVA trainer: LFB off (the bank sweeps are test_torch_train_net's).
UNIT = ['LFB.ENABLED', 'False', 'TPU.USE_PALLAS', 'False',
        'TRAIN.BATCH_SIZE', '2', 'TRAIN.DROPOUT_RATE', '0.0']


@pytest.fixture(scope='module')
def ava(tmp_path_factory):
    """(opts of the tiny AVA trainer, a seeded pickle of its params with
    momentum, saved at iteration 40 with LR 0.02)."""
    root = str(tmp_path_factory.mktemp('trainer'))
    opts = TINY + dataset_opts(synthetic.build_ava(root)) + UNIT
    spec = build_spec(load_config(AVA_YAML, opts), 'train')
    gen = torch.Generator().manual_seed(3)
    params = {k: torch.randn(v.shape, generator=gen) * 0.05
              for k, v in init_params(spec, gen).items()}
    momentum = {k: torch.randn(v.shape, generator=gen) * 0.01
                for k, v in params.items()}
    path = os.path.join(root, 'c2_model_iter40.pkl')
    port_ckpt.save_params(path, params, model_iter=40, lr=0.02,
                          momentum=momentum)
    return root, opts, path


def c2(name, value):
    return tpu_to_c2(name, np.asarray(value))


LOAD_CASES = {
    'resume': [],
    'params_file': ['TRAIN.PARAMS_FILE', None,
                    'CHECKPOINT.CONVERT_MODEL', 'True',
                    'TRAIN.RESET_START_ITER', 'False'],
    'resume_from_batch_size': ['TRAIN.PARAMS_FILE', None,
                               'CHECKPOINT.CONVERT_MODEL', 'False',
                               'TRAIN.RESUME_FROM_BATCH_SIZE', '8',
                               'TRAIN.RESET_START_ITER', 'False'],
    'reset_start_iter': ['TRAIN.PARAMS_FILE', None,
                         'CHECKPOINT.CONVERT_MODEL', 'False'],
}


@pytest.mark.parametrize('case', sorted(LOAD_CASES))
def test_load_initial_matches_lfb_tpu(ava, case):
    """The port's trainer against ``lfb_tpu``'s ``Trainer._load_initial``
    on the same config, checkpoint directory and initial params (the
    port's init in lfb_tpu's layout)."""
    root, opts, path = ava
    extra = [path if v is None else v for v in LOAD_CASES[case]]
    out = os.path.join(root, case)
    os.makedirs(os.path.join(out, 'checkpoints'))
    if case == 'resume':
        shutil.copy(path, os.path.join(out, 'checkpoints'))
    opts = opts + extra + ['CHECKPOINT.DIR', out]
    port = Trainer(load_config(AVA_YAML, opts), device='cpu')
    port.train_loader.shutdown()
    port.test_loader.shutdown()
    init = params_to_jax(init_params(port.spec, torch.Generator().manual_seed(
        port.cfg.RNG_SEED)))
    ref = types.SimpleNamespace(
        cfg=jax_load_config(AVA_YAML, opts),
        checkpoint_dir=os.path.join(os.path.abspath(out), 'checkpoints'),
        frozen_names=port.frozen_names)
    start_iter, prev_lr, ref_params, ref_momentum = \
        JaxTrainer._load_initial(ref, init)
    want_iter = {'resume': 40, 'params_file': 40,
                 'resume_from_batch_size': 160, 'reset_start_iter': 0}[case]
    assert port.start_iter == start_iter == want_iter
    assert port.current_lr == prev_lr == float(np.float32(0.02))
    saved = port_ckpt.read_pkl(path)['blobs']
    assert sorted(port.params()) == sorted(ref_params)
    for name, value in port.params().items():
        np.testing.assert_array_equal(value.numpy(),
                                      c2(name, ref_params[name]), name)
        if not (case == 'params_file' and name.startswith('pred_')):
            # CONVERT_MODEL strips the classifier: it keeps the init.
            np.testing.assert_array_equal(value.numpy(), saved[name], name)
    assert sorted(port.mstate.momentum) == sorted(port.trainable)
    for name, value in port.mstate.momentum.items():
        if case == 'resume':
            np.testing.assert_array_equal(
                value.numpy(), c2(name, ref_momentum[name]), name)
            np.testing.assert_array_equal(value.numpy(),
                                          saved[name + '_momentum'], name)
        else:
            assert ref_momentum is None and not value.any(), name


def test_update_lr_matches_lfb_tpu(caplog):
    """A warm-up from 0.01 to the base LR 0.04 over iterations 0-3, then LR
    steps x 0.1 at 6 and 9, from a checkpoint's LR of 0.02: the LR of every
    iteration, each momentum rescale and the buffers after it."""
    cfg = flagship_cfg({
        'NUM_GPUS': 1, 'SOLVER.MAX_ITER': 12, 'SOLVER.STEP_SIZES': [6, 3, 3],
        'SOLVER.WARMUP.WARMUP_END_ITER': 4, 'SOLVER.SCALE_MOMENTUM': True})
    values = np.random.RandomState(0).randn(5).astype('f')
    port = types.SimpleNamespace(
        cfg=cfg, current_lr=0.02,
        mstate=opt.SGDState(momentum={'w': torch.from_numpy(values.copy())}))
    ref = types.SimpleNamespace(
        cfg=cfg, current_lr=0.02,
        mstate=jax_opt.SGDState(momentum={'w': jnp.asarray(values)}))
    logs = {}
    for side, (obj, update) in {'port': (port, Trainer._update_lr),
                                'ref': (ref, JaxTrainer._update_lr)}.items():
        lrs, messages = [], []
        for it in range(12):
            caplog.clear()
            with caplog.at_level(logging.INFO):
                lrs.append(update(obj, it))
            messages.append([r.getMessage() for r in caplog.records])
        logs[side] = (lrs, messages)
    assert logs['port'] == logs['ref']
    np.testing.assert_array_equal(port.mstate.momentum['w'].numpy(),
                                  np.asarray(ref.mstate.momentum['w']))
    lrs, messages = logs['port']
    np.testing.assert_allclose(lrs, [0.01, 0.02, 0.03] + [0.04] * 3
                               + [0.004] * 3 + [0.0004] * 3)
    # Every warm-up step changes the LR by more than the threshold's 1.1x.
    assert [it for it, m in enumerate(messages) if m] == [0, 1, 2, 3, 6, 9]
    assert all(len(m) == 1 and m[0].startswith('Scaling update history by ')
               for m in messages if m)


def test_nan_loss_stops_training(ava, tmp_path):
    _, opts, _ = ava
    cfg = load_config(AVA_YAML, opts + [
        'CHECKPOINT.DIR', str(tmp_path), 'SOLVER.MAX_ITER', '3',
        'LOG_PERIOD', '2', 'TRAIN.PARAMS_FILE', ''])
    trainer = Trainer(cfg, device='cpu')
    trainer.trainable['pred_b'].fill_(float('nan'))
    with pytest.raises(RuntimeError, match=r'^ERROR: Got NaN loss at iter 0$'):
        trainer.train()
    assert not os.listdir(trainer.checkpoint_dir)


def test_trainer_and_train_net_default_to_the_card(ava, tmp_path):
    """Without a device argument both put their tensors on ``cuda``: on a
    machine without a card they raise, and never fall back to the CPU."""
    _, opts, _ = ava
    cfg = load_config(AVA_YAML, opts + [
        'CHECKPOINT.DIR', str(tmp_path), 'SOLVER.MAX_ITER', '1',
        'TRAIN.PARAMS_FILE', '', 'TRAIN.EVAL_PERIOD', '1000'])
    if torch.cuda.is_available():
        assert Trainer(cfg).trainable['pred_w'].is_cuda
        made = []

        class Kept(Trainer):
            def __init__(self, *args, **kwargs):
                super().__init__(*args, **kwargs)
                made.append(self)

        with mock.patch.object(train_net, 'Trainer', Kept):
            train_net.train(cfg)
        assert made[0].trainable['pred_w'].is_cuda
        return
    with pytest.raises(RuntimeError):
        Trainer(cfg)
    with pytest.raises(RuntimeError):
        train_net.train(cfg)


# --------------------------------------------------------------------------- #
# Rematerialization
# --------------------------------------------------------------------------- #

# Module function -> the kernel it stands for on the card: on the CPU these
# plain versions run where the card launches the kernels.
PLAIN_CALLS = {
    'attention': (cuda_attention, 'attention_fwd_lse_plain'),
    'attention_bwd': (cuda_attention, 'fused_attention_bwd'),
    'stem_conv': (cuda_stem, 'stem_conv'),
    'stem_conv_dw': (cuda_stem, 'stem_conv_dw'),
    'roi_align_maxpool': (cuda_roi_align, 'roi_align_maxpool'),
    'roi_align_maxpool_bwd': (cuda_roi_align, 'roi_align_maxpool_bwd'),
}
# Per train step: R50 has 5 non-local blocks, all in res3 / res4; the FBO 3
# layers (flagship) or 2 (Charades).  'stage' runs res3 and res4 again in
# the backward; 'block' leaves the non-local blocks out of its regions.
FLAGSHIP = {'stem_conv': 1, 'stem_conv_dw': 1, 'roi_align_maxpool': 1,
            'roi_align_maxpool_bwd': 1, 'attention': 8, 'attention_bwd': 8}
PER_STEP = {'': FLAGSHIP, 'res2': FLAGSHIP, 'block': FLAGSHIP,
            'stage': {**FLAGSHIP, 'attention': 13}}


def count_calls(monkeypatch):
    counts = dict.fromkeys(PLAIN_CALLS, 0)
    for name, (module, attr) in PLAIN_CALLS.items():
        def counted(*args, _fn=getattr(module, attr), _name=name, **kwargs):
            counts[_name] += 1
            return _fn(*args, **kwargs)
        monkeypatch.setattr(module, attr, counted)
    return counts


def saved_bytes():
    """A ``saved_tensors_hooks`` context and the count of the bytes its
    pack hook saw."""
    total = [0]

    def pack(x):
        total[0] += x.numel() * x.element_size()
        return x
    return torch.autograd.graph.saved_tensors_hooks(pack, lambda x: x), total


def step_batch(rng, n_clips=2, boxes=2, with_rois=True, num_lfb_feat=10):
    n, crop = n_clips * boxes, 32
    batch = {'data': rng.randint(0, 256, (n_clips, 8, crop, crop, 3)).astype(
        np.uint8)}
    if with_rois:
        batch.update(
            proposals=np.stack([
                np.repeat(np.arange(n_clips), boxes).astype('f'),
                rng.uniform(0, crop / 2, n), rng.uniform(0, crop / 2, n),
                rng.uniform(crop / 2, crop, n),
                rng.uniform(crop / 2, crop, n)], axis=1).astype('f'),
            labels=(rng.rand(n, 80) < 0.1).astype('f'),
            box_mask=np.array([1, 1, 1, 0], 'f'))
    else:
        n = n_clips
        batch['labels'] = rng.randint(0, 157, (n, 157)).astype('f') % 2
    batch['lfb'] = (rng.randn(n, num_lfb_feat, 2048) * 0.5).astype('f')
    return batch


def port_step(cfg, params, batch, monkeypatch, lr=0.01):
    """One port train step from ``params`` (lfb_tpu layout); returns (aux,
    updated trainable params, momentum, calls, saved bytes)."""
    spec = build_spec(cfg, 'train')
    port = params_from_jax(params, device='cpu')
    train, frozen = split_params(spec, port)
    state = opt.init_state(port, set(frozen))
    with monkeypatch.context() as m:
        calls = count_calls(m)
        hooks, nbytes = saved_bytes()
        with hooks:
            train, frozen, state, aux = make_train_step(spec, cfg.SOLVER)(
                train, frozen, state, {k: t(v) for k, v in batch.items()},
                torch.Generator().manual_seed(0), lr)
    return aux, train, state.momentum, calls, nbytes[0]


@pytest.fixture(scope='module')
def remat_steps():
    """The flagship step under each mode, and lfb_tpu's under 'stage'."""
    cfgs = {mode: flagship_cfg({**STEP_CFG, 'TPU.REMAT': mode})
            for mode in PER_STEP}
    jspec = jax_models.build_spec(cfgs['stage'], 'train')
    assert jspec.remat == 'stage'
    rng = np.random.RandomState(0)
    params = perturbed_params(jspec, rng)
    batch = step_batch(rng, num_lfb_feat=jspec.fbo.num_lfb_feat)
    with pytest.MonkeyPatch.context() as monkeypatch:
        port = {mode: port_step(cfg, params, batch, monkeypatch)
                for mode, cfg in cfgs.items()}
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    jtrain, jfrozen = jax_split_params(jspec, jparams)
    jstate = jax_opt.init_state(jparams, jax_model.frozen_param_names(
        jspec, jparams))
    jtrain, _, _, jaux = jax_make_train_step(jspec, cfgs['stage'].SOLVER,
                                             mesh=None)(
        jtrain, jfrozen, jstate, {k: jnp.asarray(v) for k, v in batch.items()},
        jax.random.PRNGKey(0), jnp.float32(0.01))
    return params, port, (jaux, jtrain)


def test_remat_modes_train_the_same(remat_steps):
    _, port, _ = remat_steps
    aux, train, momentum = port[''][:3]
    for mode in ('res2', 'stage', 'block'):
        got_aux, got_train, got_momentum = port[mode][:3]
        assert got_aux['loss'].item() == aux['loss'].item(), mode
        assert torch.equal(got_aux['prob'], aux['prob']), mode
        for name, value in train.items():
            assert torch.equal(got_train[name], value), (mode, name)
            assert torch.equal(got_momentum[name], momentum[name]), (mode,
                                                                     name)
    assert momentum['conv1_w'].abs().max() > 0


def test_remat_stage_step_matches_lfb_tpu(remat_steps):
    params, port, (jaux, jtrain) = remat_steps
    aux, train = port['stage'][:2]
    np.testing.assert_allclose(aux['loss'].item(), float(jaux['loss']),
                               rtol=1e-5)
    close(aux['prob'], jaux['prob'], 1e-5)
    assert sorted(train) == sorted(jtrain)
    for name, value in train.items():
        np.testing.assert_allclose(
            value.numpy(), c2(name, jtrain[name]), rtol=0,
            atol=1e-5 * np.abs(params[name]).max(), err_msg=name)


def test_remat_stage_saves_less(remat_steps):
    _, port, _ = remat_steps
    saved = {mode: result[4] for mode, result in port.items()}
    assert saved['stage'] < saved[''] / 5, saved
    assert saved['block'] < saved[''] and saved['res2'] < saved[''], saved


@pytest.mark.parametrize('mode', sorted(PER_STEP))
def test_remat_calls_per_step(remat_steps, mode):
    _, port, _ = remat_steps
    assert port[mode][3] == PER_STEP[mode]


def test_frozen_backbone_step_under_remat(monkeypatch):
    """Charades stage 2 (``MODEL.FREEZE_BACKBONE``): with nothing in the
    backbone to train, 'stage' recomputes nothing: no stem weight gradient,
    the attention backward only for the 2 FBO layers, the 5 non-local
    forwards once; the step is the same as under '', and only the head has
    momentum."""
    cfgs = {mode: charades_cfg({**STEP_CFG, 'MODEL.FREEZE_BACKBONE': True,
                                'TPU.REMAT': mode}) for mode in ('', 'stage')}
    jspec = jax_models.build_spec(cfgs['stage'], 'train')
    rng = np.random.RandomState(1)
    params = perturbed_params(jspec, rng)
    batch = step_batch(rng, with_rois=False,
                       num_lfb_feat=jspec.fbo.num_lfb_feat)
    out = {mode: port_step(cfg, params, batch, monkeypatch)
           for mode, cfg in cfgs.items()}
    want = {'stem_conv': 1, 'stem_conv_dw': 0, 'roi_align_maxpool': 0,
            'roi_align_maxpool_bwd': 0, 'attention': 7, 'attention_bwd': 2}
    assert out['stage'][3] == out[''][3] == want
    assert out['stage'][0]['loss'].item() == out[''][0]['loss'].item()
    momentum = out['stage'][2]
    assert momentum and all(
        name.startswith(('pred_', 'lfb_nl', 'lfb_1x1'))
        or '_fbonl_reduc' in name for name in momentum)
    for name, value in out['stage'][1].items():
        assert torch.equal(value, out[''][1][name]), name


# --------------------------------------------------------------------------- #
# The copies of lfb_tpu/utils
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize('dataset', ['ava', 'epic'])
def test_json_stats_and_param_table_match_lfb_tpu(dataset):
    from lfb_tpu.utils import logging_utils as jax_logging_utils
    from lfb_tpu_torch.config import epic_verb_cfg
    from lfb_tpu_torch.utils import logging_utils
    cfg = (flagship_cfg({'NUM_GPUS': 1}) if dataset == 'ava'
           else epic_verb_cfg({'NUM_GPUS': 1}))
    train_meter = types.SimpleNamespace(lr=0.004, aggr_loss=2.5,
                                        aggr_batch_size=4, aggr_err=30.0,
                                        aggr_err5=10.0)
    test_meter = types.SimpleNamespace(full_map=0.25, best_map=0.5,
                                       avg_err=60.0, avg_err5=20.0,
                                       best_top1=55.0, best_top5=15.0)
    got = logging_utils.get_json_stats_dict(cfg, train_meter, test_meter, 7)
    assert got == jax_logging_utils.get_json_stats_dict(
        cfg, train_meter, test_meter, 7)
    assert 'device_memory' not in got and got['currentIter'] == 8
    params = {'b': torch.zeros(3), 'a_w': torch.zeros(4, 2, 1, 1, 1),
              'c': torch.zeros(())}
    for rows in (None, 2):
        assert logging_utils.describe_params(params, max_rows=rows) == \
            jax_logging_utils.describe_params(
                {k: v.numpy() for k, v in params.items()}, max_rows=rows)


def test_timer_matches_lfb_tpu(monkeypatch):
    from lfb_tpu.utils import timer as jax_timer
    from lfb_tpu_torch.utils import timer
    states = []
    for module in (timer, jax_timer):
        clock = iter([1.0, 1.5, 2.0, 4.0])
        monkeypatch.setattr(module.time, 'perf_counter', lambda: next(clock))
        t = module.Timer()
        diffs = []
        for _ in range(2):
            t.tic()
            diffs.append(t.toc())
        states.append((diffs, dict(vars(t))))
        t.reset()
        assert t.calls == 0 and t.average_time == 0.0
    assert states[0] == states[1] == ([0.5, 2.0], {
        'total_time': 2.5, 'calls': 2, 'start_time': 2.0, 'diff': 2.0,
        'average_time': 1.25})


def test_prof_dag_traces_steps_one_to_three(tmp_path):
    """``PROF_DAG``: the trace starts before step start + 1, stops before
    start + 4 and goes to ``<out_dir>/prof_dag_trace.json``."""
    import json
    from lfb_tpu_torch.utils.profiling import StepTrace
    trace = StepTrace(True, 10, str(tmp_path), 'cpu')
    path = tmp_path / 'prof_dag_trace.json'
    for it in range(10, 16):
        trace.step(it)
        assert (trace._prof is not None) == (11 <= it <= 13), it
        assert path.exists() == (it >= 14), it
        torch.ones(4).add_(it)
    trace.close()
    assert json.loads(path.read_text())['traceEvents']
    quiet = StepTrace(False, 0, str(tmp_path / 'off'), 'cpu')
    for it in range(6):
        quiet.step(it)
    quiet.close()
    assert not (tmp_path / 'off').exists()

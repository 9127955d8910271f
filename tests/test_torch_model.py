"""The port's flagship slice against lfb_tpu on the CPU, and the weights
carried between them.

The flagship arc (depth 101, arc 4, 3-layer FBO-NL) at T = 16, crop 32 and
a 4 s window, in f32.  T = 16 makes res3's non-local blocks grouped
(group_num 2).  The params are lfb_tpu's init, perturbed as in
``test_golden_full_model.py:518-525``: the config zero-inits the NL and FBO
output convs and branch2c's gamma, so at init no attention output would
reach the logits.

The Charades slice (``charades_cfg``: clip-level head, 157 sigmoid classes,
no res5 dilation, a 2-layer post-act FBO-NL over a frame-level device bank)
at R50, T = 8, crop 32 and a 4-row window, with the fused bottleneck on and
off; lfb_tpu runs its unfused blocks on the CPU either way.

Tolerance: 1e-3 relative to the largest output (plus 1e-4 absolute).  Both
sides compute in f32, but sum in other orders through 101 layers and 8
attention blocks; the golden torch test of lfb_tpu holds 2e-3 on the same
arc.
"""

import dataclasses
import os
import tempfile
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip('torch')

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import lfb_tpu.models as jax_models  # noqa: E402
from lfb_tpu.bank.device_bank import FrameDeviceBank as JaxFrameDeviceBank  # noqa: E402
from lfb_tpu.bank.device_bank import \
    build_device_bank as jax_build_device_bank  # noqa: E402
from lfb_tpu.core import config as jax_config  # noqa: E402
from lfb_tpu.core.config import load_config  # noqa: E402
from lfb_tpu.train.steps import make_eval_step as jax_make_eval_step  # noqa: E402
from lfb_tpu_torch.bank.device_bank import (AvaDeviceBank,  # noqa: E402
                                            FrameDeviceBank, build_device_bank)
from lfb_tpu_torch.bank.lfb import (extract_frame_bank, load_lfb,  # noqa: E402
                                    write_lfb)
from lfb_tpu_torch.config import (CHARADES_OVERRIDES,  # noqa: E402
                                  FLAGSHIP_OVERRIDES, charades_cfg,
                                  epic_noun_cfg, epic_verb_cfg, flagship_cfg)
from lfb_tpu_torch.core import config as port_config  # noqa: E402
from lfb_tpu_torch.convert import params_from_jax, params_to_jax  # noqa: E402
from lfb_tpu_torch.models import model as port_model  # noqa: E402
from lfb_tpu_torch.models.spec import build_spec  # noqa: E402
from lfb_tpu_torch.ops import cuda_bottleneck  # noqa: E402
from lfb_tpu_torch.tools import gpu_smoke, mfu_probe, train_net  # noqa: E402
from lfb_tpu_torch.train import checkpoints  # noqa: E402
from lfb_tpu_torch.train.steps import make_eval_step  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TINY = {'TRAIN.VIDEO_LENGTH': 16, 'TEST.VIDEO_LENGTH': 16,
        'TRAIN.CROP_SIZE': 32, 'TEST.CROP_SIZE': 32, 'LFB.WINDOW_SIZE': 4,
        'TPU.COMPUTE_DTYPE': 'float32', 'NUM_GPUS': 1}
B, T, CROP, N_BOXES = 2, 16, 32, 4


def close(port, ref, rtol=1e-3):
    ref = np.asarray(ref)
    np.testing.assert_allclose(port.float().numpy(), ref, rtol=0,
                               atol=rtol * np.abs(ref).max() + 1e-4)


def jax_shapes(jspec):
    """lfb_tpu's params as shape structs (traced, not computed)."""
    return jax.eval_shape(lambda key: jax_models.init_params(key, jspec),
                          jax.random.PRNGKey(0))


def perturbed_params(jspec, rng):
    """lfb_tpu-layout numpy params, every one drawn at a fan-in scale."""
    return {k: (rng.randn(*v.shape) * (0.5 / np.sqrt(
                max(1, v.shape[-2] if v.ndim > 1 else 1)))).astype('f')
            for k, v in jax_shapes(jspec).items()}


@pytest.fixture(scope='module')
def setup():
    cfg = flagship_cfg(TINY)
    jspec = jax_models.build_spec(cfg, 'test')
    rng = np.random.RandomState(9)
    params = perturbed_params(jspec, rng)
    rois = np.stack([
        np.repeat(np.arange(B), N_BOXES // B).astype('f'),
        rng.uniform(0, CROP / 2, N_BOXES), rng.uniform(0, CROP / 2, N_BOXES),
        rng.uniform(CROP / 2, CROP, N_BOXES),
        rng.uniform(CROP / 2, CROP, N_BOXES)], axis=1).astype('f')
    batch = {'data': rng.randint(0, 256, (B, T, CROP, CROP, 3)).astype(np.uint8),
             'proposals': rois,
             'lfb': (rng.randn(N_BOXES, jspec.fbo.num_lfb_feat, 2048)
                     * 0.5).astype('f')}
    return cfg, params, batch


# Every key of these sections that the port reads (spec.py, steps.py, the
# optimizer and lfb_tpu.train.lr_policy).
PORT_READS = {
    'TRAIN': ('VIDEO_LENGTH', 'CROP_SIZE', 'DROPOUT_RATE'),
    'SOLVER': ('BASE_LR', 'LR_POLICY', 'LRS', 'STEP_SIZES', 'STEPS',
               'MAX_ITER', 'GAMMA', 'STEP_SIZE', 'MOMENTUM', 'NESTEROV',
               'WEIGHT_DECAY', 'WEIGHT_DECAY_BN', 'SCALE_MOMENTUM',
               'SCALE_MOMENTUM_THRESHOLD', 'WARMUP'),
    'MODEL': ('NUM_CLASSES', 'DEPTH', 'VIDEO_ARC_CHOICE', 'MULTI_LABEL',
              'USE_AFFINE', 'BN_EPSILON', 'BN_MOMENTUM', 'BN_INIT_GAMMA',
              'FC_INIT_STD', 'DILATIONS_AFTER_CONV5', 'FREEZE_BACKBONE',
              'USE_BGR'),
    'NONLOCAL': ('CONV_INIT_STD', 'NO_BIAS', 'USE_MAXPOOL', 'USE_SOFTMAX',
                 'USE_ZERO_INIT_CONV', 'USE_BN', 'USE_SCALE', 'USE_AFFINE',
                 'BN_EPSILON', 'BN_INIT_GAMMA', 'LAYER_MOD',
                 'CONV3_NONLOCAL', 'CONV4_NONLOCAL'),
    'LFB': ('ENABLED', 'FBO_TYPE', 'LFB_DIM', 'WINDOW_SIZE'),
    'FBO_NL': ('NUM_LAYERS', 'PRE_ACT', 'PRE_ACT_LN', 'SCALE', 'LATENT_DIM',
               'INPUT_REDUCE_DIM', 'DROPOUT_RATE', 'INPUT_DROPOUT_ON',
               'LFB_DROPOUT_ON'),
}


def test_spec_matches_lfb_tpu():
    cfg = flagship_cfg(TINY)
    for kwargs in ({}, {'lfb_infer_only': True}):
        jspec = jax_models.build_spec(cfg, 'test', **kwargs)
        spec = build_spec(cfg, 'test', **kwargs)
        for field in ('depth', 'arc', 'nl_blocks', 'fbo', 'nl', 'head_dim',
                      'pool_stride', 'crop_size', 'video_length',
                      'data_mean', 'data_std', 'compute_dtype'):
            mine, theirs = getattr(spec, field), getattr(jspec, field)
            if dataclasses.is_dataclass(mine):
                mine, theirs = (dataclasses.asdict(mine),
                                dataclasses.asdict(theirs))
            assert mine == theirs, field


@pytest.mark.parametrize('split', ['test', 'train'])
def test_build_spec_takes_the_fused_bottleneck(split):
    """The fused bottleneck is ported: ``build_spec`` takes the key for both
    splits (training keeps the unfused block, as lfb_tpu does)."""
    assert not build_spec(flagship_cfg(TINY), split).use_pallas_bottleneck
    spec = build_spec(flagship_cfg({**TINY, 'TPU.PALLAS_BOTTLENECK': True}),
                      split)
    assert spec.use_pallas_bottleneck
    jspec = jax_models.build_spec(
        flagship_cfg({**TINY, 'TPU.PALLAS_BOTTLENECK': True}), split)
    assert jspec.use_pallas_bottleneck


@pytest.mark.parametrize('overrides', [
    {'TPU.SHARD_MAP': True},
    {'TPU.SHARD_MAP': True, 'TPU.BANK_SHARDED': True,
     'TPU.DEVICE_BANK': True},
    {'MODEL.USE_AFFINE': False},                       # true-BN training
    {'NONLOCAL.USE_BN': True, 'NONLOCAL.USE_AFFINE': False},
])
def test_build_spec_refuses_what_is_not_ported(overrides):
    """None of these is refused any more: ``TPU.SHARD_MAP`` and
    ``TPU.BANK_SHARDED`` (data parallelism over ``torch.distributed``) and
    true-BN training (``MODEL.USE_AFFINE False``; ``NONLOCAL.USE_BN`` with
    ``NONLOCAL.USE_AFFINE False``) build for both splits, as in lfb_tpu,
    with lfb_tpu's norm settings."""
    cfg = flagship_cfg({**TINY, **overrides})
    for split in ('test', 'train'):
        spec = build_spec(cfg, split)
        jspec = jax_models.build_spec(cfg, split)
        assert spec.use_affine == jspec.use_affine
        assert dataclasses.asdict(spec.nl) == dataclasses.asdict(jspec.nl)


@pytest.mark.parametrize('remat', ['', 'stage', 'res2', 'block'])
def test_build_spec_takes_remat(remat):
    """``TPU.REMAT`` is ported (``torch.utils.checkpoint``): every mode
    builds for both splits, as lfb_tpu's; another value raises."""
    for split in ('test', 'train'):
        cfg = flagship_cfg({**TINY, 'TPU.REMAT': remat})
        assert build_spec(cfg, split).remat == remat
        assert jax_models.build_spec(cfg, split).remat == remat
    with pytest.raises(ValueError, match='TPU.REMAT'):
        build_spec(flagship_cfg({**TINY, 'TPU.REMAT': remat + 'x'}), 'train')


@pytest.mark.parametrize('lfb_infer_only', [False, True])
def test_param_names_and_layout_match_lfb_tpu(lfb_infer_only):
    cfg = flagship_cfg(TINY)
    jparams = jax_shapes(
        jax_models.build_spec(cfg, 'test', lfb_infer_only=lfb_infer_only))
    params = port_model.init_params(
        build_spec(cfg, 'test', lfb_infer_only=lfb_infer_only),
        torch.Generator().manual_seed(0))
    assert set(params) == set(jparams)
    converted = params_from_jax({k: np.zeros(v.shape, np.float32)
                                 for k, v in jparams.items()}, device='cpu')
    for name, value in params.items():
        assert value.shape == converted[name].shape, name
        assert value.dtype == torch.float32, name
    assert params['conv1_w'].shape == (64, 3, 5, 7, 7)
    assert params['pred_w' if not lfb_infer_only else 'res5_2_branch2c_w'
                  ].shape[0] in (80, 2048)


def test_params_round_trip(setup):
    _, params, _ = setup
    port = params_from_jax(params, device='cpu')
    assert port['res4_22_branch2a_w'].shape == (256, 1024, 3, 1, 1)
    np.testing.assert_array_equal(port['conv1_w'][13, 2, 1, 3, 4].numpy(),
                                  params['conv1_w'][1, 3, 4, 2, 13])
    np.testing.assert_array_equal(port['pred_w'][3, 100].numpy(),
                                  params['pred_w'][100, 3])
    back = params_to_jax(port)
    assert set(back) == set(params)
    for name, value in params.items():
        np.testing.assert_array_equal(back[name], value, err_msg=name)


def test_phase_a_box_pooled_matches_lfb_tpu(setup):
    cfg, params, batch = setup
    jspec = jax_models.build_spec(cfg, 'test', lfb_infer_only=True)
    names = set(jax_shapes(jspec))
    jparams = {k: jnp.asarray(v) for k, v in params.items() if k in names}
    feed = {'data': batch['data'], 'proposals': batch['proposals']}
    ref = jax_models.forward(jspec, jparams,
                             {k: jnp.asarray(v) for k, v in feed.items()},
                             train=False)
    out = port_model.forward(build_spec(cfg, 'test', lfb_infer_only=True),
                             params_from_jax({k: params[k] for k in names},
                                             device='cpu'),
                             {k: torch.from_numpy(v) for k, v in feed.items()})
    assert set(out) == {'box_pooled'}
    close(out['box_pooled'], ref['box_pooled'])


def test_phase_b_logits_and_prob_match_lfb_tpu(setup):
    cfg, params, batch = setup
    jspec = jax_models.build_spec(cfg, 'test')
    ref = jax_models.forward(jspec, {k: jnp.asarray(v) for k, v in params.items()},
                             {k: jnp.asarray(v) for k, v in batch.items()},
                             train=False)
    model = port_model.LFBModel(build_spec(cfg, 'test'),
                                params_from_jax(params, device='cpu'))
    assert set(model.params) == set(params)
    with torch.inference_mode():
        out = model({k: torch.from_numpy(v) for k, v in batch.items()})
    for key in ('box_pooled', 'logits', 'prob'):
        close(out[key], ref[key])
    assert np.abs(np.asarray(ref['logits'])).max() > 1.0   # not a flat output


@pytest.mark.parametrize('head', ['roi', 'basic'])
def test_heads_take_their_f32_mean_of_bf16_features(head, setup):
    """Each head's f32 mean of bf16 res5 features, taken as they are read
    (``mean(dtype=float32)``; the RoI head's through ``TemporalMean``, whose
    gradient is a broadcast view), against the ``.float().mean()`` form
    within 1e-6 of max |ref| (the same bf16 values summed in f32), gradient
    included, and against lfb_tpu's head (``jnp.mean(features.astype(f32))``)
    within 1e-5 (RoIAlign's sums in other orders, as in test_torch_ops)."""
    from lfb_tpu.models import heads as jax_heads
    from lfb_tpu_torch.models.heads import RoIHead, basic_head
    from lfb_tpu_torch.ops.cuda_roi_align import RoIAlignMaxPool
    cfg, _, batch = setup
    spec = build_spec(cfg, 'test')
    rng = np.random.RandomState(5)
    shape = (B, spec.pool_stride, CROP // 16, CROP // 16, 2048)
    feats = torch.from_numpy(np.abs(rng.randn(*shape)).astype('f')).bfloat16()
    rois = torch.from_numpy(batch['proposals'])
    jfeats = jnp.asarray(feats.float().numpy()).astype(jnp.bfloat16)
    jspec = jax_models.build_spec(cfg, 'test')
    if head == 'roi':
        def new(x):
            return RoIHead(spec)(x, rois)

        def old(x):
            return RoIAlignMaxPool.apply(x.float().mean(dim=1), rois,
                                         spec.roi_resolution,
                                         spec.roi_spatial_scale)
        ref = jax_heads.roi_head(jspec, jfeats, jnp.asarray(batch['proposals']))
    else:
        def new(x):
            return basic_head(spec, x)

        def old(x):
            return x.float().mean(dim=(1, 2, 3))
        ref = jax_heads.basic_head(jspec, jfeats)
    x = feats.clone().requires_grad_(True)
    got, want = new(x), old(x)
    assert got.dtype == torch.float32 and got.shape == want.shape
    close(got.detach(), want.detach().numpy(), 1e-6)
    dy = torch.from_numpy(rng.randn(*got.shape).astype('f'))
    g_new, = torch.autograd.grad(got, x, dy)
    g_old, = torch.autograd.grad(old(x), x, dy)
    assert g_new.dtype == torch.bfloat16
    close(g_new.float(), g_old.float().numpy(), 1e-6)
    close(got.detach(), ref, 1e-5)


def test_charades_cfg_is_the_released_config():
    released = load_config(os.path.join(REPO, 'configs',
                                        'charades_r101_lfb_nl.yaml'))
    mine = charades_cfg()
    for section, keys in PORT_READS.items():
        for key in keys:
            assert mine[section][key] == released[section][key], (section, key)
    for dotted in list(CHARADES_OVERRIDES) + [
            'CHARADES.FPS', 'TPU.BANK_MAX_PER_VIDEO', 'TPU.BANK_DTYPE',
            'TPU.PALLAS_BOTTLENECK']:
        if dotted == 'TPU.REMAT':          # config.PORT_SETTINGS turns it off
            continue
        section, key = dotted.split('.') if '.' in dotted else (None, dotted)
        theirs = released[section][key] if section else released[key]
        assert (mine[section][key] if section else mine[key]) == theirs, dotted
    spec, jspec = build_spec(mine, 'test'), jax_models.build_spec(mine, 'test')
    for field in ('head_type', 'num_classes', 'dilations_after_conv5', 'fbo',
                  'freeze_backbone', 'video_length', 'crop_size', 'head_dim',
                  'use_pallas_bottleneck'):
        mine_f, theirs = getattr(spec, field), getattr(jspec, field)
        if dataclasses.is_dataclass(mine_f):
            mine_f, theirs = (dataclasses.asdict(mine_f),
                              dataclasses.asdict(theirs))
        assert mine_f == theirs, field
    assert (spec.head_type, spec.fbo.num_lfb_feat, spec.fbo.pre_act) == (
        'basic', 20, False)


def flat(cfg, prefix=''):
    """{dotted.key: value} of a nested config."""
    out = {}
    for key, value in cfg.items():
        if isinstance(value, dict):
            out.update(flat(value, prefix + key + '.'))
        else:
            out[prefix + key] = value
    return out


def test_default_config_is_lfb_tpus():
    """The port's copy of the config keys and defaults, key by key."""
    mine, theirs = port_config.default_config(), jax_config.default_config()
    assert isinstance(mine, port_config.AttrDict) and mine.TPU.REMAT == 'stage'
    mine, theirs = flat(mine), flat(theirs)
    assert sorted(mine) == sorted(theirs)
    for key, value in theirs.items():
        assert mine[key] == value and type(mine[key]) is type(value), key


@pytest.mark.parametrize('name', ['flagship', 'charades'])
def test_finalized_configs_match_lfb_tpu(name):
    """``flagship_cfg`` / ``charades_cfg`` against lfb_tpu's ``finalize``
    of the same overrides (the derived SOLVER.STEPS and LFB.NUM_LFB_FEAT
    included)."""
    extra = {'NUM_GPUS': 1, 'LFB.WINDOW_SIZE': 7}
    base, make = ((FLAGSHIP_OVERRIDES, flagship_cfg) if name == 'flagship'
                  else (CHARADES_OVERRIDES, charades_cfg))
    theirs = jax_config.finalize(jax_config.clone(
        jax_config.default_config(), {**base, **extra}))
    assert flat(make(extra)) == flat(theirs)


# Each entry point that places tensors, called without a device.
DEFAULT_DEVICE_CALLS = {
    'AvaDeviceBank.build': lambda: AvaDeviceBank.build(
        {0: {902: [np.ones(8, np.float32)]}}, window_size=2, k=5,
        lfb_dim=8).feats,
    'FrameDeviceBank.build': lambda: FrameDeviceBank.build(
        {0: {11: np.ones(8, np.float32)}}, window_size=2, lfb_dim=8).feats,
    'FrameDeviceBank.build_noun': lambda: FrameDeviceBank.build_noun(
        {0: {11: np.ones((2, 8), np.float32)}}, window_size=2,
        max_per_frame=2, frames_per_second=1, fps=30, lfb_dim=8).feats,
    'build_device_bank': lambda: build_device_bank(
        flagship_cfg(TINY), {0: {902: [np.ones(2048, np.float32)]}}).feats,
    'init_params': lambda: port_model.init_params(build_spec(flagship_cfg(
        {**TINY, 'MODEL.DEPTH': 50, 'MODEL.VIDEO_ARC_CHOICE': 2}),
        'test'))['conv1_w'],
    'params_from_jax': lambda: params_from_jax(
        {'pred_b': np.zeros(3, np.float32)})['pred_b'],
    'load_params_into': lambda: load_into_default_device(),
    'train_net.train': lambda: train_on_default_device(),
    'mfu_probe._train_batch': lambda: mfu_probe._train_batch(
        build_spec(flagship_cfg(TINY), 'train'), 1, 32)['data'],
    'gpu_smoke.TinyRun': lambda: gpu_smoke.TinyRun(
        sizes=(8, 32, 1)).batch['data'],
}


def load_into_default_device():
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, 'c2_model_iter1.pkl')
        checkpoints.save_params(path, {'pred_b': torch.ones(3)}, model_iter=1,
                                lr=0.1)
        return checkpoints.load_params_into(
            path, {'pred_b': torch.zeros(3)})[0]['pred_b']


def train_on_default_device():
    """One train step of a tiny model on a tiny AVA split on disk."""
    from tests import synthetic
    with tempfile.TemporaryDirectory() as d:
        ov = synthetic.build_ava(d)
        cfg = flagship_cfg({
            **TINY, 'MODEL.DEPTH': 50, 'MODEL.VIDEO_ARC_CHOICE': 2,
            'LFB.ENABLED': False, 'DATADIR': ov['DATADIR'],
            'AVA.FRAME_LIST_DIR': ov['AVA']['FRAME_LIST_DIR'],
            'AVA.ANNOTATION_DIR': ov['AVA']['ANNOTATION_DIR'],
            'CHECKPOINT.DIR': d, 'SOLVER.MAX_ITER': 1,
            'TRAIN.BATCH_SIZE': 2, 'TRAIN.TEST_AFTER_TRAIN': False,
            'TPU.MAX_BOXES_PER_CLIP': 4})
        made = []

        class Kept(train_net.Trainer):
            def __init__(self, *args, **kwargs):
                super().__init__(*args, **kwargs)
                made.append(self)

        with mock.patch.object(train_net, 'Trainer', Kept):
            train_net.train(cfg)
        return made[0].trainable['pred_w']


@pytest.mark.parametrize('entry', sorted(DEFAULT_DEVICE_CALLS))
def test_entry_points_default_to_the_card(entry):
    """Without a device argument the entry points put their tensors on
    ``cuda``: on a machine without a card they raise, and never fall back
    to the CPU."""
    call = DEFAULT_DEVICE_CALLS[entry]
    if torch.cuda.is_available():
        assert call().is_cuda
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            call()


CHARADES_TINY = {'MODEL.DEPTH': 50, 'MODEL.VIDEO_ARC_CHOICE': 2,
                 'TRAIN.VIDEO_LENGTH': 8, 'TEST.VIDEO_LENGTH': 8,
                 'TRAIN.CROP_SIZE': 32, 'TEST.CROP_SIZE': 32,
                 'LFB.WINDOW_SIZE': 4, 'TPU.COMPUTE_DTYPE': 'float32',
                 'NUM_GPUS': 1}
R50_IDENTITY_BLOCKS = 12      # 2 + 3 + 5 + 2 blocks without a branch1


@pytest.fixture(scope='module')
def charades_setup():
    """lfb_tpu's phase A pool5 and phase B outputs (device bank) on one
    tiny Charades batch."""
    cfg = charades_cfg(CHARADES_TINY)
    jspec_a = jax_models.build_spec(cfg, 'test', lfb_infer_only=True)
    jspec_b = jax_models.build_spec(cfg, 'test')
    rng = np.random.RandomState(11)
    params = perturbed_params(jspec_b, rng)
    host_bank = {v: {f: (np.abs(rng.randn(2048)) * 0.5).astype('f')
                     for f in range(11, 400, 12) if rng.rand() < 0.8}
                 for v in range(3)}
    batch = {'data': rng.randint(0, 256, (2, 8, 32, 32, 3)).astype(np.uint8),
             'lfb_video_idx': np.array([0, 2], np.int32),
             'lfb_center': np.array([100, 263], np.int32)}
    names_a = set(jax_shapes(jspec_a))
    ref_a = jax_models.forward(
        jspec_a, {k: jnp.asarray(v) for k, v in params.items() if k in names_a},
        {'data': jnp.asarray(batch['data'])}, train=False)
    jbank = JaxFrameDeviceBank.build(host_bank, window_size=4, fps=24,
                                     clips_per_second=2)
    ref_b = jax_make_eval_step(jspec_b, bank=jbank)(
        {k: jnp.asarray(v) for k, v in params.items()},
        {k: jnp.asarray(v) for k, v in batch.items()})
    return params, names_a, host_bank, batch, ref_a, ref_b


@pytest.mark.parametrize('fused', [False, True])
def test_charades_phases_match_lfb_tpu(charades_setup, monkeypatch, fused):
    params, names_a, host_bank, batch, ref_a, ref_b = charades_setup
    cfg = charades_cfg({**CHARADES_TINY, 'TPU.PALLAS_BOTTLENECK': fused})
    calls = []
    plain = cuda_bottleneck.fused_identity_bottleneck_plain
    monkeypatch.setattr(cuda_bottleneck, 'fused_identity_bottleneck_plain',
                        lambda *a, **k: calls.append(1) or plain(*a, **k))
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}

    spec_a = build_spec(cfg, 'test', lfb_infer_only=True)
    clips = [(0, 11), (2, 35)]
    bank = extract_frame_bank(
        spec_a, params_from_jax({k: params[k] for k in names_a}, device='cpu'),
        [{'data': tbatch['data']}], clips, 'charades')
    assert sorted((v, f) for v in bank for f in bank[v]) == clips
    for i, (v, f) in enumerate(clips):
        assert bank[v][f].shape == (2048,)
        close(torch.from_numpy(bank[v][f]), np.asarray(ref_a['pool5'])[i])

    spec_b = build_spec(cfg, 'test')
    dev_bank = build_device_bank(cfg, host_bank, device='cpu')
    out = make_eval_step(spec_b, bank=dev_bank)(
        params_from_jax(params, device='cpu'), tbatch)
    assert set(out) == {'pool5', 'logits', 'prob'}
    assert out['prob'].shape == (2, 157)
    for key in ('pool5', 'logits', 'prob'):
        close(out[key], ref_b[key])
    assert np.abs(np.asarray(ref_b['logits'])).max() > 1.0
    assert len(calls) == (2 * R50_IDENTITY_BLOCKS if fused else 0)


# EPIC at R50, T = 8, crop 32: verb windows of 4 rows (+-2 s of a bank with
# a row a second), noun windows of 20 rows (10 detector boxes a second:
# +-1 s).  The verb bank is keyed by video name; its dense ids do not
# follow the names' order.
EPIC_TINY = {'TRAIN.VIDEO_LENGTH': 8, 'TEST.VIDEO_LENGTH': 8,
             'TRAIN.CROP_SIZE': 32, 'TEST.CROP_SIZE': 32,
             'LFB.WINDOW_SIZE': 4, 'TPU.COMPUTE_DTYPE': 'float32',
             'NUM_GPUS': 1}
EPIC_NOUN_TINY = {**EPIC_TINY, 'LFB.WINDOW_SIZE': 20}
VERB_VIDEOS = {'P26_01': 2, 'P27_03': 0, 'P31_14': 1}


def assert_softmax(prob, classes):
    assert prob.shape == (2, classes)
    assert bool((prob >= 0).all()) and bool((prob <= 1).all())
    np.testing.assert_allclose(prob.sum(-1).numpy(), 1.0, atol=1e-5)


@pytest.fixture(scope='module')
def epic_verb_setup():
    """lfb_tpu's phase A pool5 and phase B outputs on one tiny EPIC verb
    batch, with the name-keyed bank through its ``build_device_bank``."""
    cfg = epic_verb_cfg(EPIC_TINY)
    jspec_a = jax_models.build_spec(cfg, 'test', lfb_infer_only=True)
    jspec_b = jax_models.build_spec(cfg, 'test')
    rng = np.random.RandomState(12)
    params = perturbed_params(jspec_b, rng)
    host_bank = {name: {f: (np.abs(rng.randn(2048)) * 0.5).astype('f')
                        for f in range(30, 1800, 30) if rng.rand() < 0.8}
                 for name in VERB_VIDEOS}
    batch = {'data': rng.randint(0, 256, (2, 8, 32, 32, 3)).astype(np.uint8),
             'lfb_video_idx': np.array([VERB_VIDEOS['P31_14'],
                                        VERB_VIDEOS['P26_01']], np.int32),
             'lfb_center': np.array([95, 931], np.int32)}
    names_a = set(jax_shapes(jspec_a))
    ref_a = jax_models.forward(
        jspec_a,
        {k: jnp.asarray(v) for k, v in params.items() if k in names_a},
        {'data': jnp.asarray(batch['data'])}, train=False)
    jbank = jax_build_device_bank(cfg, host_bank, VERB_VIDEOS)
    ref_b = jax_make_eval_step(jspec_b, bank=jbank)(
        {k: jnp.asarray(v) for k, v in params.items()},
        {k: jnp.asarray(v) for k, v in batch.items()})
    return params, names_a, host_bank, batch, ref_a, ref_b


@pytest.mark.parametrize('fused', [False, True])
def test_epic_verb_phases_match_lfb_tpu(epic_verb_setup, monkeypatch, fused):
    """``epic_verb_cfg`` (the released YAML): the bank sweep keyed by
    video name, the name-keyed device bank, the softmax head."""
    params, names_a, host_bank, batch, ref_a, ref_b = epic_verb_setup
    cfg = epic_verb_cfg({**EPIC_TINY, 'TPU.PALLAS_BOTTLENECK': fused})
    calls = []
    plain = cuda_bottleneck.fused_identity_bottleneck_plain
    monkeypatch.setattr(cuda_bottleneck, 'fused_identity_bottleneck_plain',
                        lambda *a, **k: calls.append(1) or plain(*a, **k))
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}

    spec_a = build_spec(cfg, 'test', lfb_infer_only=True)
    clips = [('P26', 'P26_01', 450, 450, 0, 0), ('P31', 'P31_14', 1230, 1230,
                                                 0, 0)]
    bank = extract_frame_bank(
        spec_a, params_from_jax({k: params[k] for k in names_a}, device='cpu'),
        [{'data': tbatch['data']}], clips, 'epic')
    assert {v: sorted(f) for v, f in bank.items()} == {'P26_01': [450],
                                                      'P31_14': [1230]}
    for i, (_, name, frame, *_) in enumerate(clips):
        assert bank[name][frame].shape == (2048,)
        close(torch.from_numpy(bank[name][frame]),
              np.asarray(ref_a['pool5'])[i])

    spec_b = build_spec(cfg, 'test')
    dev_bank = build_device_bank(cfg, host_bank, VERB_VIDEOS, device='cpu')
    assert dev_bank.window_mode == 'epic_verb' and dev_bank.num_videos() == 3
    out = make_eval_step(spec_b, bank=dev_bank)(
        params_from_jax(params, device='cpu'), tbatch)
    assert set(out) == {'pool5', 'logits', 'prob'}
    assert_softmax(out['prob'], 125)
    for key in ('pool5', 'logits', 'prob'):
        close(out[key], ref_b[key])
    assert np.abs(np.asarray(ref_b['logits'])).max() > 1.0
    assert len(calls) == (2 * R50_IDENTITY_BLOCKS if fused else 0)


def test_epic_verb_bank_needs_its_name_map():
    with pytest.raises(ValueError, match='video_name_to_idx'):
        build_device_bank(epic_verb_cfg(EPIC_TINY), {'P26_01': {}},
                          device='cpu')


def test_epic_noun_phase_b_matches_lfb_tpu(tmp_path):
    """``epic_noun_cfg`` (the released YAML): a detector bank written by
    ``write_lfb``, found through ``LFB.LOAD_LFB_PATH`` set as a CLI
    override, read by ``load_lfb``, flattened by ``build_noun``, and the
    eval step with its 20-row windows; the unfused R50 blocks."""
    cfg = epic_noun_cfg({**EPIC_NOUN_TINY, 'CHECKPOINT.DIR': str(tmp_path)})
    assert cfg.LFB.LOAD_LFB and not cfg.TPU.PALLAS_BOTTLENECK
    jspec = jax_models.build_spec(cfg, 'test')
    rng = np.random.RandomState(13)
    params = perturbed_params(jspec, rng)
    host_bank = {v: {f: (np.abs(rng.randn(rng.randint(0, 11), 2048))
                         * 0.5).astype('f') for f in range(30, 1800, 30)}
                 for v in range(3)}
    batch = {'data': rng.randint(0, 256, (2, 8, 32, 32, 3)).astype(np.uint8),
             'lfb_video_idx': np.array([2, 0], np.int32),
             'lfb_center': np.array([300, 1015], np.int32)}
    jbank = jax_build_device_bank(cfg, host_bank)
    ref = jax_make_eval_step(jspec, bank=jbank)(
        {k: jnp.asarray(v) for k, v in params.items()},
        {k: jnp.asarray(v) for k, v in batch.items()})

    write_lfb(cfg, host_bank, is_train=False)
    port_config.merge_cfg_from_list(cfg, ['LFB.LOAD_LFB_PATH', str(tmp_path)])
    dev_bank = build_device_bank(cfg, load_lfb(cfg, is_train=False),
                                 device='cpu')
    assert dev_bank.window_mode == 'epic_noun'
    out = make_eval_step(build_spec(cfg, 'test'), bank=dev_bank)(
        params_from_jax(params, device='cpu'),
        {k: torch.from_numpy(v) for k, v in batch.items()})
    assert_softmax(out['prob'], 352)
    for key in ('pool5', 'logits', 'prob'):
        close(out[key], ref[key])
    assert np.abs(np.asarray(ref['logits'])).max() > 1.0
    rows = dev_bank.choose_rows(torch.tensor([2, 0]), *dev_bank.window(
        torch.tensor([300, 1015])))
    assert int((rows != dev_bank.zero_idx).sum()) > 10     # windows not empty

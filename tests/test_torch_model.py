"""The port's flagship slice against lfb_tpu on the CPU, and the weights
carried between them.

The flagship arc (depth 101, arc 4, 3-layer FBO-NL) at T = 16, crop 32 and
a 4 s window, in f32.  T = 16 makes res3's non-local blocks grouped
(group_num 2).  The params are lfb_tpu's init, perturbed as in
``test_golden_full_model.py:518-525``: the config zero-inits the NL and FBO
output convs and branch2c's gamma, so at init no attention output would
reach the logits.

Tolerance: 1e-3 relative to the largest output (plus 1e-4 absolute).  Both
sides compute in f32, but sum in other orders through 101 layers and 8
attention blocks; the golden torch test of lfb_tpu holds 2e-3 on the same
arc.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip('torch')

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import lfb_tpu.models as jax_models  # noqa: E402
from lfb_tpu_torch.config import flagship_cfg  # noqa: E402
from lfb_tpu_torch.convert import params_from_jax, params_to_jax  # noqa: E402
from lfb_tpu_torch.models import model as port_model  # noqa: E402
from lfb_tpu_torch.models.spec import build_spec  # noqa: E402

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


@pytest.mark.parametrize('overrides', [
    {'TPU.PALLAS_BOTTLENECK': True},
    {'TPU.SHARD_MAP': True},
    {'TPU.SHARD_MAP': True, 'TPU.BANK_SHARDED': True,
     'TPU.DEVICE_BANK': True},
])
def test_build_spec_refuses_what_is_not_ported(overrides):
    with pytest.raises(NotImplementedError):
        build_spec(flagship_cfg({**TINY, **overrides}), 'test')
    with pytest.raises(NotImplementedError):
        build_spec(flagship_cfg(TINY), 'train')


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
                                 for k, v in jparams.items()})
    for name, value in params.items():
        assert value.shape == converted[name].shape, name
        assert value.dtype == torch.float32, name
    assert params['conv1_w'].shape == (64, 3, 5, 7, 7)
    assert params['pred_w' if not lfb_infer_only else 'res5_2_branch2c_w'
                  ].shape[0] in (80, 2048)


def test_params_round_trip(setup):
    _, params, _ = setup
    port = params_from_jax(params)
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
                             params_from_jax({k: params[k] for k in names}),
                             {k: torch.from_numpy(v) for k, v in feed.items()})
    assert set(out) == {'box_pooled'}
    close(out['box_pooled'], ref['box_pooled'])


def test_phase_b_logits_and_prob_match_lfb_tpu(setup):
    cfg, params, batch = setup
    jspec = jax_models.build_spec(cfg, 'test')
    ref = jax_models.forward(jspec, {k: jnp.asarray(v) for k, v in params.items()},
                             {k: jnp.asarray(v) for k, v in batch.items()},
                             train=False)
    model = port_model.LFBModel(build_spec(cfg, 'test'), params_from_jax(params))
    assert set(model.params) == set(params)
    with torch.inference_mode():
        out = model({k: torch.from_numpy(v) for k, v in batch.items()})
    for key in ('box_pooled', 'logits', 'prob'):
        close(out[key], ref[key])
    assert np.abs(np.asarray(ref['logits'])).max() > 1.0   # not a flat output

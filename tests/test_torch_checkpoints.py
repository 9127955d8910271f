"""The port's checkpoint layer (``lfb_tpu_torch/train/checkpoints.py``)
against lfb_tpu's (``lfb_tpu/train/checkpoints.py``) on the CPU.

A synthetic Caffe2 pickle holds every blob that a released checkpoint of
the config holds (``lfb_tpu.train.c2_manifest.released_blob_manifest``),
with seeded values.  It loads through the port's ``load_params_into`` to
exactly (bitwise) what lfb_tpu's ``load_params_into`` followed by
``params_from_jax`` gives, with no blob left over and no param missed; a
checkpoint the port saves loads through lfb_tpu's loader to exactly the
port's params in lfb_tpu's layout, momentum too.  BN folding, the
classifier skip, 2-D kernel inflation and resume discovery are held to the
originals too.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip('torch')

import jax  # noqa: E402

import lfb_tpu.models as jax_models  # noqa: E402
from lfb_tpu.core import config as jax_config  # noqa: E402
from lfb_tpu.train import checkpoints as jax_ckpt  # noqa: E402
from lfb_tpu.train.c2_manifest import released_blob_manifest  # noqa: E402
from lfb_tpu_torch.config import epic_verb_cfg  # noqa: E402
from lfb_tpu_torch.convert import params_from_jax, params_to_jax  # noqa: E402
from lfb_tpu_torch.models.model import init_params  # noqa: E402
from lfb_tpu_torch.models.spec import build_spec  # noqa: E402
from lfb_tpu_torch.train import checkpoints as ckpt  # noqa: E402
from lfb_tpu_torch.train import optimizer  # noqa: E402
from lfb_tpu_torch.train.steps import split_params  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RELEASED = ['ava_r50_lfb_nl', 'charades_r50_lfb_nl', 'epic_verb_r50_lfb_nl',
            'epic_noun_r50_lfb_nl']


def load_cfg(name, opts=()):
    return jax_config.load_config(
        os.path.join(REPO, 'configs', name + '.yaml'),
        ['TPU.REMAT', "''", 'NUM_GPUS', '1', *opts])


def jax_zeros(cfg):
    """lfb_tpu's train params, zeros of their shapes."""
    tree = jax.eval_shape(
        lambda key: jax_models.init_params(key, jax_models.build_spec(
            cfg, 'train')), jax.random.PRNGKey(0))
    return {k: np.zeros(v.shape, np.float32) for k, v in tree.items()}


def port_params(cfg, seed):
    return init_params(build_spec(cfg, 'train'),
                       torch.Generator().manual_seed(seed))


def synthetic_blobs(manifest, rng):
    return {name: rng.standard_normal(shape, np.float32)
            for name, shape in manifest.items()}


def assert_bitwise(mine, theirs):
    assert sorted(mine) == sorted(theirs)
    for name, value in theirs.items():
        got = mine[name]
        got = got.numpy() if isinstance(got, torch.Tensor) else got
        assert got.dtype == np.float32 and got.shape == value.shape, name
        np.testing.assert_array_equal(got, value, err_msg=name)


@pytest.mark.parametrize('name', RELEASED)
def test_released_pickle_loads_as_in_lfb_tpu(name, tmp_path):
    cfg = load_cfg(name)
    manifest = released_blob_manifest(cfg)
    rng = np.random.default_rng(3)
    blobs = synthetic_blobs(manifest, rng)
    path = str(tmp_path / 'model_final.pkl')
    ckpt.write_pkl(path, {'blobs': {**blobs, 'model_iter': 36000,
                                    'lr': np.float32(1e-5)}})
    target = port_params(cfg, 0)
    assert set(manifest) == set(target)          # no unknown, none missing
    mine, _, it, lr = ckpt.load_params_into(path, target, device='cpu')
    zeros = jax_zeros(cfg)
    jparams, _, jit, jlr = jax_ckpt.load_params_into(path, zeros)
    assert (it, lr) == (jit, jlr) == (36000, float(np.float32(1e-5)))
    assert_bitwise(mine, {k: v.numpy() for k, v in
                          params_from_jax(jparams, device='cpu').items()})
    assert_bitwise(mine, blobs)           # the port's layout is Caffe2's

    # The other way: the port's checkpoint read by lfb_tpu.
    path = str(tmp_path / 'c2_model_iter20.pkl')
    ckpt.save_params(path, target, model_iter=20, lr=0.25)
    jparams, _, jit, jlr = jax_ckpt.load_params_into(path, zeros)
    assert (jit, jlr) == (20, 0.25)
    assert_bitwise(jparams, params_to_jax(target))


@pytest.fixture(scope='module')
def epic():
    """The EPIC verb params and a K400-style (BN, 400 classes) pickle of
    the same backbone, both from a seed."""
    spec = build_spec(epic_verb_cfg({'NUM_GPUS': 1}), 'train')
    params = init_params(spec, torch.Generator().manual_seed(0))
    bn_cfg = jax_config.clone(load_cfg('epic_verb_r50_lfb_nl'), {
        'MODEL.USE_AFFINE': False, 'NONLOCAL.USE_AFFINE': False,
        'NONLOCAL.USE_BN': True, 'MODEL.NUM_CLASSES': 400,
        'LFB.ENABLED': False})
    rng = np.random.default_rng(5)
    blobs = synthetic_blobs(released_blob_manifest(bn_cfg), rng)
    for name in blobs:
        if name.endswith('_bn_riv'):
            blobs[name] = np.abs(blobs[name]) + 0.1
    blobs['conv1_w'] = blobs['conv1_w'][:, :, 0]   # an image-pretrained stem
    for name in ('conv1_w', 'res2_0_branch2a_w', 'pred_w'):
        blobs[name + '_momentum'] = np.ones_like(blobs[name])
    return params, blobs


def test_k400_pickle_converts_as_in_lfb_tpu(epic, tmp_path):
    """CONVERT_MODEL: BN folded into the affine, the 400-class classifier
    skipped (125 verbs), the 2-D stem inflated, momentum dropped, the FBO
    (not in the pickle) kept: bitwise lfb_tpu's result."""
    params, blobs = epic
    path = str(tmp_path / 'r50_k400_pretrained.pkl')
    ckpt.write_pkl(path, {'blobs': {**blobs, 'model_iter': 7}})
    mine, _, it, _ = ckpt.load_params_into(path, params, convert_model=True,
                                           device='cpu')
    jparams, _, _, _ = jax_ckpt.load_params_into(
        path, params_to_jax(params), convert_model=True)
    assert it == 7
    assert_bitwise(mine, {k: v.numpy() for k, v in
                          params_from_jax(jparams, device='cpu').items()})
    assert blobs['pred_w'].shape == (400, 2048)
    for name in ('pred_w', 'pred_b', 'lfb_nl1_theta_w'):
        np.testing.assert_array_equal(mine[name].numpy(), params[name].numpy())
    std = np.sqrt(blobs['res3_1_branch2b_bn_riv'] + 1e-5)
    np.testing.assert_array_equal(
        mine['res3_1_branch2b_bn_s'].numpy(),
        blobs['res3_1_branch2b_bn_s'] / std)
    np.testing.assert_array_equal(
        mine['res3_1_branch2b_bn_b'].numpy(),
        blobs['res3_1_branch2b_bn_b']
        - blobs['res3_1_branch2b_bn_rm'] * blobs['res3_1_branch2b_bn_s'] / std)
    assert mine['conv1_w'].shape == (64, 3, 5, 7, 7)
    for t in range(5):
        np.testing.assert_array_equal(mine['conv1_w'][:, :, t].numpy(),
                                      blobs['conv1_w'] / np.float32(5))


def test_bn_folding_matches_lfb_tpu(epic):
    _, blobs = epic
    mine, theirs = ckpt.fold_bn_to_affine(blobs), jax_ckpt.fold_bn_to_affine(
        blobs)
    assert_bitwise(mine, theirs)
    assert not any(k.endswith(('_bn_rm', '_bn_riv')) for k in mine)
    x = np.random.default_rng(0).standard_normal(64, np.float32)
    bn = ((x - blobs['res_conv1_bn_rm'])
          / np.sqrt(blobs['res_conv1_bn_riv'] + 1e-5)
          * blobs['res_conv1_bn_s'] + blobs['res_conv1_bn_b'])
    np.testing.assert_allclose(
        x * mine['res_conv1_bn_s'] + mine['res_conv1_bn_b'], bn, rtol=1e-5,
        atol=1e-5)
    assert_bitwise(ckpt.convert_pretrained(blobs),
                   jax_ckpt.convert_pretrained(blobs))


@pytest.mark.parametrize('shape,target', [
    ((64, 3, 7, 7), (64, 3, 5, 7, 7)),            # stem: 2-D -> 3-D
    ((256, 64, 1, 1), (256, 64, 3, 1, 1)),        # kT 3 branch2a
    ((8, 4, 3, 1, 1), (8, 4, 3, 1, 1)),           # 3-D as it is
    ((8, 4), (8, 4)),                             # FC
    ((8,), (8,))])
def test_c2_to_port_is_c2_to_tpu_in_the_port_layout(shape, target):
    value = np.random.default_rng(1).standard_normal(shape, np.float32)
    tpu_target = (target[2:] + (target[1], target[0]) if len(target) == 5
                  else target[::-1])
    want = ckpt.tpu_to_c2('w', jax_ckpt.c2_to_tpu('w', value, tpu_target))
    got = ckpt.c2_to_port('w', value, target)
    assert got.shape == target
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match='does not match'):
        ckpt.c2_to_port('w', value, (3,) + target)


@pytest.mark.parametrize('classes', [125, 400])
def test_classifier_skip_matches_lfb_tpu(classes):
    rng = np.random.default_rng(2)
    for name, shape in (('pred_w', (classes, 2560)), ('pred_b', (classes,))):
        value = rng.standard_normal(shape, np.float32)
        mine = ckpt.c2_to_port(name, value, (125,) + shape[1:])
        theirs = jax_ckpt.c2_to_tpu(name, value, shape[1:][::-1] + (125,))
        if classes != 125:
            assert mine is None and theirs is None
        else:
            np.testing.assert_array_equal(mine, ckpt.tpu_to_c2(name, theirs))


def test_momentum_round_trips_bitwise(epic, tmp_path):
    """``save_params`` of params and an ``SGDState``'s momentum (those of
    the stem, res2 and the head), then ``load_params_into`` fresh ones:
    every tensor bitwise, in the port and through lfb_tpu's loader; a blob
    the pickle lacks keeps its value."""
    params, _ = epic
    params = {k: v for k, v in params.items()
              if not k.startswith(('res3', 'res4', 'res5', 'nonlocal'))}
    spec = build_spec(epic_verb_cfg({'NUM_GPUS': 1}), 'train')
    _, frozen = split_params(spec, params)
    state = optimizer.init_state(params, set(frozen))
    g = torch.Generator().manual_seed(4)
    for value in state.momentum.values():
        value.normal_(generator=g)
    path = str(tmp_path / 'c2_model_iter100.pkl')
    ckpt.save_params(path, params, model_iter=100, lr=0.01,
                     momentum=state.momentum)
    fresh = {k: torch.zeros_like(v) for k, v in params.items()}
    fresh_state = optimizer.init_state(fresh, set(frozen))
    loaded, momentum, it, lr = ckpt.load_params_into(
        path, fresh, load_momentum=True, momentum=fresh_state.momentum,
        device='cpu')
    assert it == 100 and lr == float(np.float32(0.01))
    assert_bitwise(loaded, {k: v.numpy() for k, v in params.items()})
    assert_bitwise(momentum, {k: v.numpy() for k, v in state.momentum.items()})
    zeros = params_to_jax(fresh)
    _, jmomentum, _, _ = jax_ckpt.load_params_into(
        path, zeros, load_momentum=True,
        momentum={k: zeros[k] for k in state.momentum})
    assert_bitwise(jmomentum, params_to_jax(state.momentum))
    # Without load_momentum no momentum comes back; missing blobs are kept.
    data = ckpt.read_pkl(path)
    del data['blobs']['pred_b']
    ckpt.write_pkl(path, data)
    loaded, momentum, _, _ = ckpt.load_params_into(path, fresh, device='cpu')
    assert momentum is None
    np.testing.assert_array_equal(loaded['pred_b'].numpy(),
                                  fresh['pred_b'].numpy())


def test_resume_discovery_matches_lfb_tpu(tmp_path):
    cfg = load_cfg('epic_verb_r50_lfb_nl', ['CHECKPOINT.DIR', str(tmp_path)])
    directory = ckpt.checkpoint_directory(cfg)
    assert directory == jax_ckpt.checkpoint_directory(cfg)
    assert ckpt.latest_checkpoint(directory) is None
    os.makedirs(directory)
    assert ckpt.latest_checkpoint(directory) is None
    for name in ('c2_model_iter100.pkl', 'c2_model_iter2000.pkl',
                 'c2_model_iter350.pkl', 'c2_model_iterX.pkl', 'other.pkl'):
        open(os.path.join(directory, name), 'wb').close()
    assert ckpt.latest_checkpoint(directory) == jax_ckpt.latest_checkpoint(
        directory) == os.path.join(directory, 'c2_model_iter2000.pkl')
    for args in ((1000, 64, 16), (4000, 16, 64), (7, 3, 2)):
        assert ckpt.resume_iter_for_batch_size(*args) == \
            jax_ckpt.resume_iter_for_batch_size(*args)

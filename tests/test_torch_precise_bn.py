"""Precise BN in the port (``lfb_tpu_torch/train/precise_bn.py``) against
lfb_tpu on the CPU, and the true-BN trainer around it.

* ``compute_precise_bn_stats`` on ``tests/test_train.py``'s setting (EPIC,
  ``MODEL.USE_AFFINE False`` with true-BN non-local blocks, R50 I3D at T 8,
  crop 32, 2 clips of f32 frames a batch, 2 batches) against lfb_tpu's from
  the same params: every ``_rm`` within 5e-5 of its largest value, every
  ``_riv`` (E[x^2] - E[x]^2 over the batches) within 5e-5 of the E[x^2] it
  is taken from; every other entry the caller's.  The bound is five times
  this net's f32 floor: scaling the conv weights by 1 + 2^-22 (one f32
  rounding step) moves the port's own statistics by up to 1.0e-5 of their
  largest value (res5), about what separates it from lfb_tpu's (1.2e-5;
  1e-6 in res2, growing with depth, as the perturbation's effect does).
* A true-BN ``Trainer`` (the tiny AVA split of ``tests/synthetic.py``, LFB
  off, ``TRAIN.COMPUTE_PRECISE_BN True``): its checkpoint holds the running
  statistics that ``compute_precise_bn_stats`` gives on the first
  ``TRAIN.ITER_COMPUTE_PRECISE_BN`` train batches from the checkpoint's
  params, bitwise, and a trainer resuming from it starts from its params and
  momentum bitwise.
"""

import numpy as np
import pytest

torch = pytest.importorskip('torch')
pytest.importorskip('cv2')

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from lfb_tpu.core import config as jax_config  # noqa: E402
from lfb_tpu.models import build_spec as jax_build_spec  # noqa: E402
from lfb_tpu.models import init_params as jax_init_params  # noqa: E402
from lfb_tpu.train.precise_bn import \
    compute_precise_bn_stats as jax_precise_bn  # noqa: E402
from lfb_tpu_torch.convert import params_from_jax  # noqa: E402
from lfb_tpu_torch.core import config as port_config  # noqa: E402
from lfb_tpu_torch.core.config import load_config  # noqa: E402
from lfb_tpu_torch.data.loader import DataLoader, to_device  # noqa: E402
from lfb_tpu_torch.models.spec import build_spec  # noqa: E402
from lfb_tpu_torch.train import checkpoints as port_ckpt  # noqa: E402
from lfb_tpu_torch.train.precise_bn import compute_precise_bn_stats  # noqa: E402
from lfb_tpu_torch.train.trainer import Trainer  # noqa: E402
from tests import synthetic  # noqa: E402
from tests.test_torch_tools import AVA_YAML, TINY, dataset_opts  # noqa: E402
from tests.torch_threads import worker_threads  # noqa: E402,F401


def epic_true_bn_cfg(module):
    """``tests/test_train.py:test_precise_bn_stats``'s config, built by
    ``module`` (lfb_tpu's or the port's config module)."""
    cfg = module.default_config()
    cfg.DATASET = 'epic'
    cfg.MODEL.NUM_CLASSES = 5
    cfg.MODEL.MULTI_LABEL = False
    cfg.MODEL.USE_AFFINE = False
    cfg.NONLOCAL.USE_BN = True
    cfg.TRAIN.VIDEO_LENGTH = cfg.TEST.VIDEO_LENGTH = 8
    cfg.TRAIN.CROP_SIZE = cfg.TEST.CROP_SIZE = 32
    cfg.NUM_GPUS = 1
    cfg.TRAIN.BATCH_SIZE = cfg.TEST.BATCH_SIZE = 2
    cfg.TPU.COMPUTE_DTYPE = 'float32'
    cfg.TPU.USE_PALLAS = False
    return module.finalize(cfg)


def assert_stats_close(got, want, tol):
    """``_rm`` within ``tol`` of its largest value; ``_riv`` within ``tol``
    of the largest E[x^2] = riv + rm^2 it was taken from."""
    for name, value in want.items():
        if name.endswith('_riv'):
            scale = np.abs(value + want[name[:-3] + 'rm'] ** 2).max()
        else:
            scale = np.abs(value).max()
        np.testing.assert_allclose(got[name], value, rtol=0,
                                   atol=tol * scale, err_msg=name)


def test_precise_bn_matches_lfb_tpu():
    jcfg = epic_true_bn_cfg(jax_config)
    jspec = jax_build_spec(jcfg, 'train')
    jparams = jax_init_params(jax.random.PRNGKey(0), jspec)
    rng = np.random.RandomState(0)
    batches = [{'data': (0.1 * rng.randn(2, 8, 32, 32, 3)).astype('f'),
                'labels': np.int32([0, 1])} for _ in range(2)]
    ref = jax_precise_bn(jspec, jparams,
                         iter([{k: jnp.asarray(v) for k, v in b.items()}
                               for b in batches]), 2)

    spec = build_spec(epic_true_bn_cfg(port_config), 'train')
    params = params_from_jax({k: np.asarray(v) for k, v in jparams.items()},
                             device='cpu')
    new = compute_precise_bn_stats(
        spec, params, iter([{k: torch.from_numpy(v) for k, v in b.items()}
                            for b in batches]), 2)
    stats = [k for k in new if k.endswith(('_bn_rm', '_bn_riv'))]
    assert stats and set(new) == set(params)
    assert_stats_close({k: new[k].numpy() for k in stats},
                       {k: np.asarray(ref[k]) for k in stats}, 5e-5)
    assert (new['res_conv1_bn_riv'] >= 0).all()
    assert not torch.equal(new['res_conv1_bn_rm'], params['res_conv1_bn_rm'])
    for name, value in params.items():
        if name not in stats:
            assert new[name] is value, name
    affine = port_config.default_config()
    affine.MODEL.USE_AFFINE = True
    with pytest.raises(AssertionError, match='affine'):
        compute_precise_bn_stats(build_spec(port_config.finalize(affine),
                                            'train'), params, iter(()), 1)


# The tiny AVA trainer with true BN: LFB off, precise BN over 2 batches.
TRUE_BN = ['LFB.ENABLED', 'False', 'TRAIN.BATCH_SIZE', '2',
           'TRAIN.DROPOUT_RATE', '0.0', 'TRAIN.PARAMS_FILE', '',
           'MODEL.USE_AFFINE', 'False', 'NONLOCAL.USE_BN', 'True',
           'NONLOCAL.USE_AFFINE', 'False', 'TRAIN.COMPUTE_PRECISE_BN', 'True',
           'TRAIN.ITER_COMPUTE_PRECISE_BN', '2', 'TRAIN.EVAL_PERIOD', '1000',
           'CHECKPOINT.CHECKPOINT_PERIOD', '2']


def test_trainer_checkpoints_precise_bn_stats_and_resumes(tmp_path):
    opts = (TINY + dataset_opts(synthetic.build_ava(str(tmp_path / 'data')))
            + TRUE_BN + ['CHECKPOINT.DIR', str(tmp_path / 'out')])
    cfg = load_config(AVA_YAML, opts + ['SOLVER.MAX_ITER', '2'])
    trainer = Trainer(cfg, device='cpu')
    assert not trainer.spec.use_affine
    path = trainer.train()
    assert path.endswith('c2_model_iter2.pkl')
    init = {**trainer.trainable, **trainer.frozen}
    saved, momentum, start, _ = port_ckpt.load_params_into(
        path, {k: torch.zeros_like(v) for k, v in init.items()},
        load_momentum=True,
        momentum={k: torch.zeros_like(v)
                  for k, v in trainer.trainable.items()}, device='cpu')
    assert start == 2

    loader = DataLoader(trainer.train_db, cfg.TRAIN.BATCH_SIZE,
                        num_workers=1, seed=cfg.RNG_SEED, is_train=True)
    try:
        new = compute_precise_bn_stats(
            trainer.spec, saved, (to_device(b, 'cpu')
                                  for b in loader.batches(num_batches=2)), 2)
    finally:
        loader.shutdown()
    stats = [k for k in saved if k.endswith(('_bn_rm', '_bn_riv'))]
    assert stats
    for name in stats:
        assert torch.equal(saved[name], new[name]), name
        assert torch.equal(trainer.frozen[name], new[name]), name

    resumed = Trainer(load_config(AVA_YAML, opts + ['SOLVER.MAX_ITER', '3']),
                      device='cpu')
    resumed.train_loader.shutdown()
    resumed.test_loader.shutdown()
    assert resumed.start_iter == 2
    for name, value in saved.items():
        assert torch.equal(resumed.params()[name], value), name
    for name, value in momentum.items():
        assert torch.equal(resumed.mstate.momentum[name], value), name

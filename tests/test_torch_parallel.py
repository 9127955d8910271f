"""The port's data parallelism (``lfb_tpu_torch/parallel``) on the CPU, over
gloo, against ``lfb_tpu``'s shard_map steps on a 2-device mesh (the suite's
virtual CPU devices) and against the port in one process.

One group of two ranks, spawned once for the module, runs every rank-side
case of ``tests/torch_parallel_ranks.py`` on its shard of the same global
batches and writes its results; the tests here read them.  The model is the
flagship arc cut to R50 arc 2 with 8 channels a group, T 4, crop 32, f32,
2 box rows a clip, with dropout off wherever two runs are compared that draw
other random numbers (the packages, or the world sizes).

* The train step (two steps, host windows in the batch) on a global batch
  of 4 clips whose halves hold 3 and 1 valid boxes, so a mean of per-rank
  means, or a sum of per-rank losses, would differ from the global mean:
  the losses within 1e-5 relative, the updated params and the momentum
  within rtol 1e-4 / atol 1e-6, of lfb_tpu's shard_map step and of the
  port's single-process step; the full prob (padding rows too, which on
  rank 1 name clip -2 once localised and read clip 0 of the rank, as in
  lfb_tpu) within 1e-5 of lfb_tpu's largest, and the valid rows within 1e-5
  of the single-process step's.  Both ranks hold bitwise the same params.
* The AVA eval step with localised proposals: the full prob and logits
  within 1e-5 of lfb_tpu's largest; ``with_loss`` within 1e-5 relative.
  The plain RoIAlign reads the clip a localised padding row names (-r*b)
  as lfb_tpu's gather does (within 1e-6).
* Row-sharded against replicated device banks, AVA and Charades, train and
  eval, dropout and window draws on: bitwise.
* Each rank's loader builds only its clips of every batch: concatenated they
  are bitwise the whole batch (lfb_tpu's), for AVA, Charades and EPIC.
* The config asserts of the data-parallel keys fire as lfb_tpu's; the
  launcher's world follows lfb_tpu's device-count rule.
"""

import pickle

import numpy as np
import pytest

torch = pytest.importorskip('torch')
pytest.importorskip('cv2')

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import lfb_tpu.models as jax_models  # noqa: E402
from lfb_tpu.core import config as jax_config  # noqa: E402
from lfb_tpu.data.loader import DataLoader as JaxDataLoader  # noqa: E402
from lfb_tpu.data.loader import get_input_db as jax_get_input_db  # noqa: E402
from lfb_tpu.models.model import frozen_param_names  # noqa: E402
from lfb_tpu.parallel import create_mesh  # noqa: E402
from lfb_tpu.parallel import shard_batch as jax_shard_batch  # noqa: E402
from lfb_tpu.train import optimizer as jax_opt  # noqa: E402
from lfb_tpu.train.steps import make_eval_step as jax_make_eval_step  # noqa: E402
from lfb_tpu.train.steps import make_train_step as jax_make_train_step  # noqa: E402
from lfb_tpu.train.steps import split_params as jax_split_params  # noqa: E402
from lfb_tpu_torch.config import charades_cfg, flagship_cfg  # noqa: E402
from lfb_tpu_torch.convert import params_from_jax, params_to_jax  # noqa: E402
from lfb_tpu_torch.core import config as port_config  # noqa: E402
from lfb_tpu_torch.data.loader import DataLoader, get_input_db  # noqa: E402
from lfb_tpu_torch.models.spec import build_spec  # noqa: E402
from lfb_tpu_torch.parallel import launch, mesh  # noqa: E402
from lfb_tpu_torch.train import optimizer as opt  # noqa: E402
from lfb_tpu_torch.train.steps import (make_eval_step,  # noqa: E402
                                       make_train_step, split_params)
from tests import padding_rows, synthetic, torch_parallel_ranks  # noqa: E402
from tests.test_torch_data import SMALL, clip_bank, host_ava_bank  # noqa: E402
from tests.test_torch_model import perturbed_params  # noqa: E402

WORLD = 2
CLIPS, BOXES = 4, 2
CFG = {'MODEL.DEPTH': 50, 'MODEL.VIDEO_ARC_CHOICE': 2,
       'RESNETS.WIDTH_PER_GROUP': 8, 'FBO_NL.LATENT_DIM': 64,
       'TRAIN.VIDEO_LENGTH': 4, 'TEST.VIDEO_LENGTH': 4,
       'TRAIN.CROP_SIZE': 32, 'TEST.CROP_SIZE': 32, 'LFB.WINDOW_SIZE': 2,
       'TPU.COMPUTE_DTYPE': 'float32', 'TRAIN.DROPOUT_RATE': 0.0,
       'FBO_NL.DROPOUT_RATE': 0.0, 'TPU.USE_PALLAS': False, 'NUM_GPUS': 2,
       'TPU.MAX_BOXES_PER_CLIP': BOXES, 'TRAIN.BATCH_SIZE': CLIPS,
       'TEST.BATCH_SIZE': CLIPS}
# Valid box rows: clips 0-1 (rank 0) hold 3, clips 2-3 (rank 1) hold 1.
BOX_MASK = np.float32([1, 1, 1, 0, 1, 0, 0, 0])
# Window draws and dropout on, and AVA seconds with more features than K.
BANK_CFG = {**CFG, 'TRAIN.DROPOUT_RATE': 0.3, 'FBO_NL.DROPOUT_RATE': 0.2,
            'AVA.LFB_MAX_NUM_FEAT_PER_STEP': 2, 'TPU.DEVICE_BANK': True,
            'TPU.SHARD_MAP': True, 'TPU.BANK_SHARDED': True}
CHARADES_CFG = {**BANK_CFG, 'MODEL.NUM_CLASSES': 6}


def ava_batch(rng, spec, lfb=True, labels=True, metadata=False):
    """A global AVA batch of CLIPS clips with the clip-aligned rows of
    ``data/ava.py``: each clip's valid boxes first (``BOX_MASK``), then zero
    rows, which name clip 0."""
    n = CLIPS * BOXES
    crop = spec.crop_size
    proposals = np.zeros((n, 5), 'f')
    valid = BOX_MASK > 0
    proposals[valid, 0] = np.arange(n)[valid] // BOXES
    proposals[valid, 1:3] = rng.uniform(0, crop / 2, (valid.sum(), 2))
    proposals[valid, 3:] = rng.uniform(crop / 2, crop, (valid.sum(), 2))
    batch = {'data': rng.randint(0, 256, (CLIPS, spec.video_length, crop,
                                          crop, 3)).astype(np.uint8),
             'proposals': proposals, 'box_mask': BOX_MASK.copy()}
    if lfb:
        batch['lfb'] = (rng.randn(n, spec.fbo.num_lfb_feat, 2048) * 0.5
                        * valid[:, None, None]).astype('f')
    if labels:
        batch['labels'] = ((rng.rand(n, 80) < 0.2)
                           * valid[:, None]).astype('f')
    if metadata:
        batch['metadata'] = np.stack([
            np.arange(n) // BOXES % 3, 904 + (np.arange(n) * 3) % 12,
            np.full(n, 240), np.full(n, 320)], 1).astype('f')
    return batch


def make_inputs():
    rng = np.random.RandomState(0)
    cfg = flagship_cfg(CFG)
    jspec = jax_models.build_spec(cfg, 'train')
    inputs = {'cfg': CFG, 'params': perturbed_params(jspec, rng),
              'batch': ava_batch(rng, jspec)}
    jspec_val = jax_models.build_spec(cfg, 'val')
    inputs['eval_params'] = perturbed_params(jspec_val, rng)
    inputs['eval_batch'] = ava_batch(rng, jspec_val)

    bank_cfg = flagship_cfg(BANK_CFG)
    bspec = jax_models.build_spec(bank_cfg, 'train')
    inputs.update(
        bank_cfg=BANK_CFG, bank_params=perturbed_params(bspec, rng),
        ava_batch=ava_batch(rng, bspec, lfb=False, metadata=True),
        ava_bank={v: {sec: [rng.randn(2048).astype('f')
                            for _ in range(1 + (v + sec) % 4)]
                      for sec in range(902, 918)} for v in range(3)})
    cspec = jax_models.build_spec(charades_cfg(CHARADES_CFG), 'train')
    inputs.update(
        charades_cfg=CHARADES_CFG,
        charades_params=perturbed_params(cspec, rng),
        charades_batch={
            'data': rng.randint(0, 256, (CLIPS, 4, 32, 32, 3)).astype(
                np.uint8),
            'labels': (rng.rand(CLIPS, 6) < 0.4).astype('f'),
            'lfb_video_idx': np.int32([0, 1, 2, 1]),
            'lfb_center': np.int32([20, 5, 40, 90])},
        frame_bank={v: {f: rng.randn(2048).astype('f')
                        for f in range(0, 96, 12)} for v in range(3)})
    return inputs


@pytest.fixture(scope='module')
def ranks(tmp_path_factory):
    """(inputs, [rank 0's results, rank 1's]) of one spawned gloo group."""
    root = tmp_path_factory.mktemp('ranks')
    inputs = make_inputs()
    with open(root / 'inputs.pkl', 'wb') as f:
        pickle.dump(inputs, f)
    torch.multiprocessing.start_processes(
        torch_parallel_ranks.main,
        args=(WORLD, str(root), ('train', 'eval', 'banks')), nprocs=WORLD,
        start_method='spawn')
    results = []
    for r in range(WORLD):
        with open(root / 'rank{}.pkl'.format(r), 'rb') as f:
            results.append(pickle.load(f))
    return inputs, results


def close(got, ref, tol):
    """|got - ref| <= tol * max |ref|."""
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), ref, rtol=0,
                               atol=tol * np.abs(ref).max())


def jax_train(inputs):
    """lfb_tpu's shard_map train step on a 2-device mesh: losses, probs,
    params, momentum (lfb_tpu layout)."""
    cfg = flagship_cfg(inputs['cfg'])
    jspec = jax_models.build_spec(cfg, 'train')
    params = {k: jnp.asarray(v) for k, v in inputs['params'].items()}
    train, frozen = jax_split_params(jspec, params)
    state = jax_opt.init_state(params, frozen_param_names(jspec, params))
    mesh_2 = create_mesh(WORLD)
    step = jax_make_train_step(jspec, cfg.SOLVER, mesh_2, use_shard_map=True)
    losses, probs = [], []
    for i, lr in enumerate(torch_parallel_ranks.LRS):
        train, frozen, state, aux = step(
            train, frozen, state, jax_shard_batch(mesh_2, inputs['batch']),
            jax.random.PRNGKey(i), jnp.float32(lr))
        losses.append(float(aux['loss']))
        probs.append(np.asarray(aux['prob']))
    return (losses, probs, {k: np.asarray(v) for k, v in train.items()},
            {k: np.asarray(v) for k, v in state.momentum.items()})


def port_train(inputs):
    """The port's step in this process, with no group, on the whole
    batch."""
    cfg = flagship_cfg(inputs['cfg'])
    spec = build_spec(cfg, 'train')
    train, frozen = split_params(spec, params_from_jax(inputs['params'],
                                                       device='cpu'))
    state = opt.init_state({**train, **frozen}, set(frozen))
    step = make_train_step(spec, cfg.SOLVER)
    batch = torch_parallel_ranks.tensors(inputs['batch'])
    losses, probs = [], []
    for i, lr in enumerate(torch_parallel_ranks.LRS):
        train, frozen, state, aux = step(train, frozen, state, batch,
                                         torch.Generator().manual_seed(i), lr)
        losses.append(aux['loss'].item())
        probs.append(aux['prob'].numpy())
    return losses, probs, params_to_jax(train), params_to_jax(
        state).momentum


def assert_step_close(dp, ref, padding=None):
    """The ranks' steps against ``ref``'s on the real box rows; with
    ``padding`` (each step's, in the global batch's order), the padding
    rows read it bit for bit."""
    losses, probs, params, momentum = ref
    np.testing.assert_allclose(dp['losses'], losses, rtol=1e-5)
    for got, want in zip(dp['probs'], probs):
        close(got[BOX_MASK > 0], want[BOX_MASK > 0], 1e-5)
    for got, want in zip(dp['probs'], padding or []):
        padding_rows.assert_padding_rows(got, want, BOX_MASK)
    got_params = params_to_jax({k: torch.from_numpy(v)
                                for k, v in dp['params'].items()})
    got_momentum = params_to_jax({k: torch.from_numpy(v)
                                  for k, v in dp['momentum'].items()})
    assert set(got_params) == set(params) == set(momentum)
    for name in params:
        np.testing.assert_allclose(got_params[name], params[name],
                                   rtol=1e-4, atol=1e-6, err_msg=name)
        np.testing.assert_allclose(got_momentum[name], momentum[name],
                                   rtol=1e-4, atol=1e-6, err_msg=name)


def rank_padding(results, case):
    """The prob each padding row should read (its rank's classifier over
    [head row, 0]), per step, in the global batch's order."""
    return [np.concatenate(steps) for steps in zip(
        *(r[case]['padding'] for r in results))]


def test_train_step_matches_lfb_tpus_shard_map_step(ranks):
    """The real rows as lfb_tpu's; a padding row's FBO part is 0 in the
    port, where lfb_tpu runs the FBO over its window."""
    inputs, results = ranks
    assert_step_close(results[0]['train'], jax_train(inputs),
                      rank_padding(results, 'train'))


def test_train_step_matches_one_process(ranks):
    inputs, results = ranks
    ref = port_train(inputs)
    assert_step_close(results[0]['train'], ref)
    # The global mean over valid boxes, not a mean of the ranks' means.
    assert results[0]['train']['losses'][0] == pytest.approx(
        ref[0][0], rel=1e-5)


def test_every_rank_makes_the_same_update(ranks):
    _, results = ranks
    a, b = (r['train'] for r in results)
    assert a['losses'] == b['losses']
    for key in ('params', 'momentum'):
        for name in a[key]:
            np.testing.assert_array_equal(a[key][name], b[key][name])


def test_eval_step_localises_proposals_as_lfb_tpu(ranks):
    """The real rows as lfb_tpu's, and the padding rows the classifier
    over [head row, 0] (the port runs the FBO on the real rows alone):
    rank 1's padding rows name clip -2 once localised and read the rank's
    clip 0, in the plain RoI path (clamped) as in lfb_tpu's gather."""
    inputs, results = ranks
    cfg = flagship_cfg(inputs['cfg'])
    jspec = jax_models.build_spec(cfg, 'val')
    params = {k: jnp.asarray(v) for k, v in inputs['eval_params'].items()}
    mesh_2 = create_mesh(WORLD)
    batch = inputs['eval_batch']
    ref = jax_make_eval_step(jspec, mesh_2, with_loss=True,
                             use_shard_map=True)(
        params, jax_shard_batch(mesh_2, batch))
    got = results[0]['eval']
    real = BOX_MASK > 0
    for key in ('prob', 'logits'):
        close(got['out'][key][real], np.asarray(ref[key])[real], 1e-5)
    close(got['prob_with_loss'][real], np.asarray(ref['prob'])[real], 1e-5)
    without_loss, with_loss = rank_padding(results, 'eval')
    padding_rows.assert_padding_rows(got['out']['prob'], without_loss,
                                     BOX_MASK)
    padding_rows.assert_padding_rows(got['prob_with_loss'], with_loss,
                                     BOX_MASK)
    np.testing.assert_allclose(got['loss'], float(ref['loss']), rtol=1e-5)
    # Rank 1's padding rows read its clip 0 (global clip 2), not clip 0.
    one = make_eval_step(build_spec(cfg, 'val'))(
        params_from_jax(inputs['eval_params'], device='cpu'),
        torch_parallel_ranks.tensors(
            {k: v for k, v in batch.items() if k != 'labels'}))
    pad = np.flatnonzero(BOX_MASK == 0)
    rank1_pad = pad[pad >= BOX_MASK.size // WORLD]
    assert not np.allclose(got['out']['prob'][rank1_pad],
                           one['prob'].numpy()[rank1_pad], atol=1e-4)


@pytest.mark.parametrize('clip', [-2, -4, -6, 2, 5])
def test_plain_roi_align_clamps_the_clip_index_as_lfb_tpu(clip):
    """Rank r's padding rows name clip -r*b once localised (b = 2 clips a
    rank here): the plain RoIAlign reads clip 0, as lfb_tpu's gather (which
    wraps a negative index once, then clamps) and the CUDA kernel (which
    clamps) do, where indexing alone fails from rank 2 on; past the end it
    reads the last clip."""
    from lfb_tpu.ops.roi_align import roi_align as jax_roi_align
    from lfb_tpu_torch.ops.roi_align import roi_align
    rng = np.random.RandomState(3)
    feats = rng.randn(2, 8, 8, 16).astype('f')
    rois = np.float32([[clip, 8, 8, 100, 90], [0, 0, 0, 0, 0]])
    got = roi_align(torch.from_numpy(feats), torch.from_numpy(rois))
    nearest = rois.copy()
    nearest[:, 0] = np.clip(nearest[:, 0], 0, 1)
    np.testing.assert_array_equal(
        got.numpy(), roi_align(torch.from_numpy(feats),
                               torch.from_numpy(nearest)).numpy())
    close(got.numpy(), jax_roi_align(jnp.asarray(feats), jnp.asarray(rois)),
          1e-6)


@pytest.mark.parametrize('bank', ['ava', 'frame'])
def test_sharded_bank_is_bitwise_the_replicated_bank(ranks, bank):
    _, results = ranks
    for r in results:
        assert r['banks'][bank] == {'losses': True, 'probs': True,
                                    'params': True, 'momentum': True,
                                    'eval': True}
    assert results[0]['banks']['ava finite']


# ----------------------------------------------------------------------- #
# The loader: each rank builds its own clips
# ----------------------------------------------------------------------- #

@pytest.fixture(scope='module')
def splits(tmp_path_factory):
    return {'ava': synthetic.build_ava(str(tmp_path_factory.mktemp('ava'))),
            'charades': synthetic.build_charades(
                str(tmp_path_factory.mktemp('charades'))),
            'epic': synthetic.build_epic(
                str(tmp_path_factory.mktemp('epic')))}


def both_dbs(ov, split, extra, infer=False, bank=None):
    dbs = []
    for module, get in ((jax_config, jax_get_input_db),
                        (port_config, get_input_db)):
        cfg = module.default_config()
        module.merge_dict_into(cfg, ov)
        opts = []
        for key, value in {**SMALL, **extra}.items():
            opts += [key, repr(value)]
        module.merge_cfg_from_list(cfg, opts)
        cfg = module.finalize(cfg)
        kwargs = {'device': 'cpu'} if module is port_config else {}
        dbs.append(get(cfg, split, lfb_infer_only=infer, lfb=bank, **kwargs))
    return dbs


LOADER_CASES = {
    'ava train': ('ava', 'train', {}, False),
    'ava train, colour augmentation': (
        'ava', 'train', {'TRAIN.USE_COLOR_AUGMENTATION': True}, False),
    'ava val, host windows': ('ava', 'val', {'LFB.ENABLED': True}, False),
    'ava bank sweep': ('ava', 'val', {}, True),
    'charades train': ('charades', 'train', {}, False),
    'charades val': ('charades', 'val', {}, False),
    'epic train': ('epic', 'train', {}, False),
    'epic val, host windows': ('epic', 'val', {'LFB.ENABLED': True}, False),
}


@pytest.mark.parametrize('case', sorted(LOADER_CASES))
def test_rank_loaders_give_the_global_batch_bitwise(splits, case):
    dataset, split, extra, infer = LOADER_CASES[case]
    bank = None
    if 'LFB.ENABLED' in extra:
        probe = both_dbs(splits[dataset], split, {}, infer=True)[0]
        bank = (host_ava_bank() if dataset == 'ava'
                else clip_bank('frame', probe))
    ref_db, db = both_dbs(splits[dataset], split, extra, infer, bank)
    is_train = split == 'train'
    ref = JaxDataLoader(ref_db, CLIPS, seed=3, is_train=is_train)
    for i in (0, 1, ref.num_batches() - 1):
        whole = ref._build(i)
        for world in (2, 4):
            for r in range(world):
                got = DataLoader(db, CLIPS, seed=3, is_train=is_train,
                                 rank=r, world=world)._build(i)
                want = mesh.shard_batch(whole, r, world)
                assert sorted(got) == sorted(want)
                for name in want:
                    assert got[name].dtype == want[name].dtype, name
                    np.testing.assert_array_equal(got[name], want[name],
                                                  err_msg=(name, world, r))


def test_loader_refuses_a_batch_the_ranks_do_not_divide(splits):
    _, db = both_dbs(splits['charades'], 'val', {})
    with pytest.raises(ValueError, match='multiple of 3 ranks'):
        DataLoader(db, CLIPS, rank=0, world=3)


# ----------------------------------------------------------------------- #
# Config, launcher rule, helpers without a group
# ----------------------------------------------------------------------- #

ASSERT_CASES = {
    'train batch': {'NUM_GPUS': 3, 'TRAIN.BATCH_SIZE': 4,
                    'TEST.BATCH_SIZE': 3},
    'test batch': {'NUM_GPUS': 3, 'TRAIN.BATCH_SIZE': 3,
                   'TEST.BATCH_SIZE': 4},
    'bank sharded without shard map': {'TPU.BANK_SHARDED': True,
                                       'TPU.DEVICE_BANK': True},
    'bank sharded without a device bank': {'TPU.BANK_SHARDED': True,
                                           'TPU.SHARD_MAP': True},
}


@pytest.mark.parametrize('case', sorted(ASSERT_CASES))
def test_config_asserts_fire_as_lfb_tpus(case):
    messages = []
    for module in (jax_config, port_config):
        cfg = module.default_config()
        opts = []
        for key, value in ASSERT_CASES[case].items():
            opts += [key, repr(value)]
        module.merge_cfg_from_list(cfg, opts)
        with pytest.raises(AssertionError) as err:
            module.finalize(cfg)
        messages.append(str(err.value))
    assert messages[0] == messages[1]


def test_data_parallel_world_follows_lfb_tpus_rule():
    cfg = port_config.finalize(port_config.default_config())   # NUM_GPUS 8
    assert launch.data_parallel_world(cfg, 'cpu') == 8
    cfg = flagship_cfg({'NUM_GPUS': 4, 'TRAIN.BATCH_SIZE': 12,
                        'TEST.BATCH_SIZE': 8})
    assert launch.data_parallel_world(cfg, 'cpu') == 4
    cfg.NUM_GPUS = 8       # at most 8, and dividing 12 and 8: 4
    assert launch.data_parallel_world(cfg, 'cpu') == 4
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='no CUDA device'):
            launch.data_parallel_world(cfg, 'cuda')


def test_helpers_are_the_identity_without_a_group():
    assert not mesh.distributed()
    assert (mesh.world_size(), mesh.rank()) == (1, 0)
    assert mesh.step_seed(1234) == 1234
    t = torch.arange(6.0).reshape(3, 2)
    assert mesh.gather_rows(t) is t and mesh.all_sum(t) is t
    batch = {'data': np.arange(8).reshape(4, 2), 'box_mask': np.arange(8)}
    got = mesh.shard_batch(batch, 1, 2)
    np.testing.assert_array_equal(got['data'], [[4, 5], [6, 7]])
    np.testing.assert_array_equal(got['box_mask'], [4, 5, 6, 7])
    with pytest.raises(ValueError, match='not a multiple of 3'):
        mesh.shard_batch(batch, 0, 3)

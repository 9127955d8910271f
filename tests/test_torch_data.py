"""The port's data layer against lfb_tpu's on the CPU, on the tiny on-disk
datasets of ``tests/synthetic.py`` (JPEG frames in the reference's file
formats).

Tolerance: none.  Both packages decode with ``cv2.imread`` (lfb_tpu through
its native decoder where it is built, which is byte-identical to it), resize
with ``cv2.resize`` and run the same numpy code from the same
``default_rng((seed, i))`` streams, so every decoded clip, transformed clip
and box, and every blob of every minibatch, is bitwise equal.
"""

import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip('torch')
cv2 = pytest.importorskip('cv2')

from lfb_tpu.core import config as jax_config  # noqa: E402
from lfb_tpu.data import transforms as jax_transforms  # noqa: E402
from lfb_tpu.data.frame_lists import load_image_lists  # noqa: E402
from lfb_tpu.data.loader import DataLoader as JaxDataLoader  # noqa: E402
from lfb_tpu.data.loader import get_input_db as jax_get_input_db  # noqa: E402
from lfb_tpu_torch.core import config as port_config  # noqa: E402
from lfb_tpu_torch.data import frame_lists, lfb_windows, transforms  # noqa: E402
from lfb_tpu_torch.data.loader import (SWEEPS, DataLoader,  # noqa: E402
                                       DeviceFeed, get_input_db, to_device)
from tests import synthetic  # noqa: E402

SMALL = {'TRAIN.VIDEO_LENGTH': 4, 'TEST.VIDEO_LENGTH': 4,
         'TRAIN.SAMPLE_RATE': 2, 'TEST.SAMPLE_RATE': 2,
         'TRAIN.CROP_SIZE': 32, 'TEST.CROP_SIZE': 32, 'TEST.SCALE': 36,
         'TRAIN.JITTER_SCALES': [36, 40], 'TRAIN.BATCH_SIZE': 4,
         'TEST.BATCH_SIZE': 4, 'NUM_GPUS': 1, 'TPU.MAX_BOXES_PER_CLIP': 4,
         'LFB.LFB_DIM': 16, 'LFB.WINDOW_SIZE': 3}


def both_cfgs(overrides, extra=None):
    """(lfb_tpu config, port config) from the same synthetic overrides and
    dotted settings."""
    out = []
    for module in (jax_config, port_config):
        cfg = module.default_config()
        module.merge_dict_into(cfg, overrides)
        opts = []
        for key, value in {**SMALL, **(extra or {})}.items():
            opts += [key, repr(value)]
        module.merge_cfg_from_list(cfg, opts)
        out.append(module.finalize(cfg))
    return out


@pytest.fixture(scope='module')
def ava(tmp_path_factory):
    return synthetic.build_ava(str(tmp_path_factory.mktemp('ava')))


@pytest.fixture(scope='module')
def charades(tmp_path_factory):
    return synthetic.build_charades(str(tmp_path_factory.mktemp('charades')))


@pytest.fixture(scope='module')
def epic(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('epic'))
    return synthetic.build_epic(root), root


def assert_same_batch(port, ref):
    assert sorted(port) == sorted(ref)
    for name in ref:
        assert port[name].dtype == ref[name].dtype, name
        np.testing.assert_array_equal(port[name], ref[name], err_msg=name)


def frame_paths(ov, video='AVA00', n=6):
    return [os.path.join(ov['DATADIR'], video, '{}_{:06d}.jpg'.format(video, i))
            for i in range(1, n + 1)]


# ----------------------------------------------------------------------- #
# frame lists, decode, transforms
# ----------------------------------------------------------------------- #

def test_frame_lists_and_sequences_match(charades):
    path = [os.path.join(charades['CHARADES']['FRAME_LIST_DIR'], 'train.csv')]
    for return_dict in (False, True):
        assert (frame_lists.load_image_lists(path, charades['DATADIR'],
                                             return_dict=return_dict)
                == load_image_lists(path, charades['DATADIR'],
                                    return_dict=return_dict))
    from lfb_tpu.data.frame_lists import get_sequence
    for args in ((2, 4, 2, 100), (98, 4, 2, 100), (50, 32, 2, 60)):
        assert frame_lists.get_sequence(*args) == get_sequence(*args)


def test_fill_window_matches():
    from lfb_tpu.data.lfb_windows import fill_window
    rng = np.random.RandomState(0)
    bank = {f: rng.randn(8).astype('f') for f in range(0, 200, 7)}
    for begin, end, w in ((-10, 40, 4), (30, 150, 6), (300, 400, 2)):
        np.testing.assert_array_equal(
            lfb_windows.fill_window(bank, begin, end, window_size=w,
                                    lfb_dim=8),
            fill_window(bank, begin, end, window_size=w, lfb_dim=8))


def test_load_frames_is_lfb_tpus_decode(ava):
    paths = frame_paths(ava)
    clip = transforms.load_frames(paths)
    assert clip.dtype == np.uint8 and clip.shape == (6, 48, 64, 3)
    np.testing.assert_array_equal(clip, jax_transforms.load_frames(paths))
    np.testing.assert_array_equal(
        clip, jax_transforms.load_frames(paths, use_native=False))


def test_load_frames_raises_for_a_missing_frame(ava):
    with pytest.raises(IOError, match='Failed to load images'):
        transforms.load_frames(frame_paths(ava)[:2] + ['/nonexistent.jpg'],
                               retry=1)


def test_cv2_is_imported_at_first_use_and_named_when_missing(monkeypatch,
                                                             ava):
    monkeypatch.setitem(sys.modules, 'cv2', None)
    with pytest.raises(ImportError, match='cv2'):
        transforms.load_frames(frame_paths(ava, n=1))
    with pytest.raises(ImportError, match='cv2'):
        transforms.short_side_scale(np.zeros((1, 48, 64, 3), np.uint8), 36)


@pytest.mark.parametrize('is_train,force_flip,shift,uint8', [
    (False, False, 0, True), (False, False, 1, True), (False, False, 2, True),
    (False, True, 1, True), (False, False, 1, False), (False, True, 2, False),
    (True, False, 1, True), (True, False, 1, False)])
def test_preprocess_clip_is_bitwise_lfb_tpus(ava, is_train, force_flip,
                                             shift, uint8):
    jcfg, pcfg = both_cfgs(ava)
    clip = transforms.load_frames(frame_paths(ava, n=4))
    boxes = np.array([[0.1, 0.2, 0.5, 0.9], [0.0, 0.0, 1.0, 1.0],
                      [0.6, 0.3, 0.95, 0.7]], np.float32)
    outs = []
    for module, cfg in ((transforms, pcfg), (jax_transforms, jcfg)):
        outs.append(module.preprocess_clip(
            clip, is_train=is_train, crop_size=32, cfg=cfg,
            rng=np.random.default_rng(5), spatial_shift=shift, boxes=boxes,
            force_flip=force_flip, output_uint8=uint8))
    (port_clip, port_boxes), (ref_clip, ref_boxes) = outs
    assert port_clip.dtype == (np.uint8 if uint8 else np.float32)
    assert port_clip.shape == (4, 32, 32, 3)
    np.testing.assert_array_equal(port_clip, ref_clip)
    np.testing.assert_array_equal(port_boxes, ref_boxes)


@pytest.mark.parametrize('pca_only', [True, False])
def test_color_augmentation_is_bitwise_lfb_tpus(ava, pca_only):
    jcfg, pcfg = both_cfgs(ava, {'TRAIN.USE_COLOR_AUGMENTATION': True,
                                 'TRAIN.PCA_JITTER_ONLY': pca_only})
    clip = transforms.load_frames(frame_paths(ava, n=2))
    port, _ = transforms.preprocess_clip(clip, is_train=True, crop_size=32,
                                         cfg=pcfg,
                                         rng=np.random.default_rng(3))
    ref, _ = jax_transforms.preprocess_clip(clip, is_train=True, crop_size=32,
                                            cfg=jcfg,
                                            rng=np.random.default_rng(3))
    assert np.isfinite(port).all()
    np.testing.assert_array_equal(port, ref)


# ----------------------------------------------------------------------- #
# datasets
# ----------------------------------------------------------------------- #

def host_ava_bank(dim=16, seed=0):
    rng = np.random.RandomState(seed)
    return {v: {sec: [rng.randn(dim).astype('f')
                      for _ in range(rng.randint(1, 8))]
                for sec in range(900, 908)} for v in range(2)}


# (split, lfb_infer_only, get_train_lfb, extra settings, bank)
AVA_CASES = {
    'val': ('val', False, False, {}, None),
    'val flip shift 2': ('val', False, False,
                         {'AVA.FORCE_TEST_FLIP': True}, None),
    'val float': ('val', False, False, {'TPU.DEVICE_NORMALIZE': False}, None),
    'train': ('train', False, False, {}, None),
    'bank sweep': ('val', True, False, {}, None),
    'bank sweep, train lists': ('val', True, True, {}, None),
    'host windows': ('val', False, False, {'LFB.ENABLED': True}, 'ava'),
    'device bank': ('val', False, False,
                    {'LFB.ENABLED': True, 'TPU.DEVICE_BANK': True}, 'ava'),
    'truncated': ('val', False, False, {'TPU.MAX_BOXES_PER_CLIP': 1}, None),
}


@pytest.mark.parametrize('case', sorted(AVA_CASES))
def test_ava_minibatches_are_bitwise_lfb_tpus(ava, case):
    split, infer, train_lfb, extra, bank = AVA_CASES[case]
    shift = 2 if 'shift 2' in case else None
    jcfg, pcfg = both_cfgs(ava, extra)
    lfb = host_ava_bank() if bank else None
    ref = jax_get_input_db(jcfg, split, lfb_infer_only=infer, shift=shift,
                           lfb=lfb, get_train_lfb=train_lfb)
    port = get_input_db(pcfg, split, lfb_infer_only=infer, shift=shift,
                        lfb=lfb, get_train_lfb=train_lfb, device='cpu')
    assert port.keyframe_indices == ref.keyframe_indices
    assert port.num_boxes_used == ref.num_boxes_used
    assert port.device_bank == ref.device_bank
    for indices, seed in (([0, 1, 2, 3], 0), ([5, 6, 7, 7], 1)):
        assert_same_batch(port.minibatch(indices, np.random.default_rng(seed)),
                          ref.minibatch(indices, np.random.default_rng(seed)))


def test_ava_box_rows_are_clip_aligned(ava):
    """Clip b owns rows [b * M, (b + 1) * M) of every box blob, M =
    TPU.MAX_BOXES_PER_CLIP: its real boxes first, in CSV order, then zero
    padding (which names clip 0 and has box_mask 0); a keyframe with more
    than M boxes keeps its first M, and num_boxes_used counts what the
    batches emit."""
    _, pcfg = both_cfgs(ava)
    db = get_input_db(pcfg, 'val', device='cpu')
    m = pcfg.TPU.MAX_BOXES_PER_CLIP
    indices = [0, 3, 5, 6]
    batch = db.minibatch(indices, np.random.default_rng(0))
    for b, idx in enumerate(indices):
        video, sec, _ = db.keyframe_indices[idx]
        n = len(db.boxes_and_labels[video][sec])
        rows = slice(b * m, (b + 1) * m)
        mask = batch['box_mask'][rows]
        np.testing.assert_array_equal(mask, [1.0] * n + [0.0] * (m - n))
        for blob in ('proposals', 'original_boxes'):
            np.testing.assert_array_equal(batch[blob][rows][:n, 0], b)
            assert not batch[blob][rows][n:].any()
        np.testing.assert_array_equal(
            batch['original_boxes'][rows][:n, 1:],
            np.float32([box for box, _ in db.boxes_and_labels[video][sec]]))
        np.testing.assert_array_equal(batch['metadata'][rows][:n, :2],
                                      [[video, sec]] * n)
        assert not batch['labels'][rows][n:].any()
    _, one = both_cfgs(ava, {'TPU.MAX_BOXES_PER_CLIP': 1})
    db_one = get_input_db(one, 'val', device='cpu')
    assert db_one.num_boxes_used == db.db_size() < db.num_boxes_used
    assert db_one.minibatch(indices, np.random.default_rng(0))[
        'box_mask'].tolist() == [1.0] * 4


CLIP_CASES = {
    'charades val': ('charades', 'val', False, {}, None),
    'charades train': ('charades', 'train', False, {}, None),
    'charades bank sweep': ('charades', 'val', True, {}, None),
    'charades host windows': ('charades', 'val', False,
                              {'LFB.ENABLED': True}, 'frame'),
    'charades device bank': ('charades', 'val', False,
                             {'LFB.ENABLED': True, 'TPU.DEVICE_BANK': True},
                             'frame'),
    'epic verb val': ('epic', 'val', False, {}, None),
    'epic verb train': ('epic', 'train', False, {}, None),
    'epic verb bank sweep': ('epic', 'val', True, {}, None),
    'epic verb host windows': ('epic', 'val', False,
                               {'LFB.ENABLED': True}, 'frame'),
    'epic verb device bank': ('epic', 'val', False,
                              {'LFB.ENABLED': True, 'TPU.DEVICE_BANK': True},
                              'frame'),
    'epic noun host windows': ('epic', 'val', False,
                               {'LFB.ENABLED': True, 'EPIC.CLASS_TYPE': 'noun',
                                'MODEL.NUM_CLASSES': 7}, 'noun'),
    'epic noun device bank': ('epic', 'val', False,
                              {'LFB.ENABLED': True, 'EPIC.CLASS_TYPE': 'noun',
                               'MODEL.NUM_CLASSES': 7,
                               'TPU.DEVICE_BANK': True}, 'noun'),
}


def clip_bank(kind, db):
    if kind == 'frame':
        return synthetic.make_fake_frame_lfb(db.image_paths, dim=16)
    rng = np.random.RandomState(4)   # noun: {video_idx: {frame: (n, D)}}
    return {v: {f: rng.randn(rng.randint(1, 5), 16).astype('f')
                for f in range(0, 60, 3)}
            for v in range(len(db.image_paths))}


@pytest.mark.parametrize('case', sorted(CLIP_CASES))
def test_clip_minibatches_are_bitwise_lfb_tpus(charades, epic, case):
    dataset, split, infer, extra, bank = CLIP_CASES[case]
    ov = charades if dataset == 'charades' else epic[0]
    jcfg, pcfg = both_cfgs(ov, extra)
    lfb = None
    if bank:
        lfb = clip_bank(bank, jax_get_input_db(jcfg, split,
                                               lfb_infer_only=True))
    ref = jax_get_input_db(jcfg, split, lfb_infer_only=infer, lfb=lfb)
    port = get_input_db(pcfg, split, lfb_infer_only=infer, lfb=lfb,
                        device='cpu')
    assert port.db_size() == ref.db_size()
    assert port.device_bank == ref.device_bank
    n = port.db_size()
    for indices, seed in (([0, 1 % n, 2 % n], 0), ([n - 1, 0, n - 1], 1)):
        assert_same_batch(port.minibatch(indices, np.random.default_rng(seed)),
                          ref.minibatch(indices, np.random.default_rng(seed)))


def test_epic_bank_sweep_annotations_match(epic):
    jcfg, pcfg = both_cfgs(epic[0])
    for get_train_lfb in (False, True):
        ref = jax_get_input_db(jcfg, 'val', lfb_infer_only=True,
                               get_train_lfb=get_train_lfb)
        port = get_input_db(pcfg, 'val', lfb_infer_only=True,
                            get_train_lfb=get_train_lfb, device='cpu')
        assert port.annotations == ref.annotations and port.annotations


# ----------------------------------------------------------------------- #
# loader
# ----------------------------------------------------------------------- #

def test_loader_order_padding_and_determinism_match_lfb_tpu(charades):
    jcfg, pcfg = both_cfgs(charades)
    ref_db = jax_get_input_db(jcfg, 'val')
    db = get_input_db(pcfg, 'val', device='cpu')   # 18 clips
    loader = DataLoader(db, batch_size=4, num_workers=4, prefetch=2, seed=7)
    other = DataLoader(db, batch_size=4, num_workers=2, prefetch=3, seed=7)
    ref = JaxDataLoader(ref_db, batch_size=4, num_workers=3, seed=7)
    assert loader.num_batches() == ref.num_batches() == 5
    for i in range(loader.num_batches()):
        assert loader._batch_indices(i) == ref._batch_indices(i)
    assert loader._batch_indices(4) == [16, 17, 16, 16]   # padded with the first
    try:
        batches = list(loader.batches())
        assert len(batches) == 5 and len(loader.build_s) == 5
        for a, b, c in zip(batches, other.batches(), ref.batches()):
            assert_same_batch(a, c)
            assert_same_batch(b, c)
    finally:
        for ld in (loader, other, ref):
            ld.shutdown()


def test_train_indices_cover_the_db_as_lfb_tpu():
    class CountingDB:
        def db_size(self):
            return 10

        def minibatch(self, indices, rng):
            return {'indices': np.array(indices)}

    seen = []
    loader = DataLoader(CountingDB(), batch_size=4, is_train=True, seed=3)
    ref = JaxDataLoader(CountingDB(), batch_size=4, is_train=True, seed=3)
    try:
        for a, b in zip(loader.batches(5), ref.batches(5)):
            np.testing.assert_array_equal(a['indices'], b['indices'])
            seen.extend(a['indices'].tolist())
    finally:
        loader.shutdown()
        ref.shutdown()
    assert sorted(seen) == sorted(list(range(10)) * 2)
    assert seen[:10] != list(range(10))


def test_loader_propagates_worker_exceptions():
    class BrokenDB:
        def db_size(self):
            return 8

        def minibatch(self, indices, rng):
            raise RuntimeError('decode exploded')

    loader = DataLoader(BrokenDB(), batch_size=4, num_workers=2, seed=0)
    try:
        with pytest.raises(RuntimeError, match='decode exploded'):
            next(iter(loader.batches(1)))
    finally:
        loader.shutdown()


def test_to_device_and_device_feed_on_the_cpu(charades):
    _, pcfg = both_cfgs(charades)
    db = get_input_db(pcfg, 'val', lfb_infer_only=True, device='cpu')
    batch = db.minibatch([0, 1], np.random.default_rng(0))
    dev = to_device(batch, 'cpu')
    for name, value in batch.items():
        assert dev[name].device.type == 'cpu'
        np.testing.assert_array_equal(dev[name].numpy(), value)
    loader = DataLoader(db, batch_size=4, num_workers=2, prefetch=1, seed=0)
    feed = DeviceFeed(loader, 'cpu', 'test feed')
    SWEEPS.clear()
    try:
        pairs = list(feed)
    finally:
        loader.shutdown()
    assert len(pairs) == loader.num_batches() == 2
    for host, dev in pairs:
        assert dev['data'].dtype == torch.uint8
        np.testing.assert_array_equal(dev['data'].numpy(), host['data'])
    summary = feed.summary
    assert SWEEPS == [dict(summary, label='test feed')]
    assert summary['batches'] == 2 and summary['card_ms'] is None
    # With a window of one batch, the second is the sweep's steady state.
    steady = summary['steady']
    assert steady['batches'] == 1 and steady['card_busy'] is None
    assert steady['wall_ms'] == summary['wall_ms']
    assert summary['build_ms'] > 0 and summary['wall_ms'] > 0
    assert summary['clips_per_s'] == pytest.approx(
        4 / summary['wall_ms'] * 1e3)
    assert summary['sweep_s'] == pytest.approx(
        (summary['first_ms'] + summary['wall_ms']) / 1e3)
    assert summary['sweep_clips_per_s'] == pytest.approx(
        8 / summary['sweep_s'])


def test_to_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present')
    with pytest.raises((RuntimeError, AssertionError)):
        to_device({'x': np.zeros(3, np.float32)}, 'cuda')

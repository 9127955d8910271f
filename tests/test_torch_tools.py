"""The port's command lines end to end on the CPU, against lfb_tpu's.

``python -m lfb_tpu_torch.tools.test_net`` and ``...tools.lfb_loader``
(their ``main``, with ``--device cpu``) run on the tiny on-disk datasets of
``tests/synthetic.py`` with a released YAML and tiny overrides (R50 arc 2
with 8 channels a group in place of 64, T 4, crop 32, f32), from seeded
weights saved as Caffe2 pickles; the same config and pickles go through
``tools/test_net.py``'s ``test_net`` and ``lfb_tpu.bank.get_lfb``.  Each run
sweeps the bank from the frames on disk (``get_lfb``), then tests over the
same frames.  The AVA pair of runs is made once, for the detections, the
bank it wrote and the bank ``lfb_loader`` sweeps.  Multi-crop testing is in
``test_torch_tools_multicrop.py``.

Tolerances: the banks' rows within 1e-4 of their largest value (f32 through
R50 on both sides, sums in other orders: about 1e-6 here).  The detections
CSVs match line for line: the same keys, boxes and labels in the same
order, and each score, printed as ``%.04f``, the same but for a rounding
that f32 noise of a few 1e-7 tips across a boundary, at most one unit of the
last digit, in at most 1% of the lines (3 of 1,280 here).  The multi-crop
merges compute in numpy from those printed scores and print full precision:
each of their scores within 1e-4.  mAP within 1e-6.
"""

import importlib.util
import os
import pickle

import numpy as np
import pytest

torch = pytest.importorskip('torch')
cv2 = pytest.importorskip('cv2')

from lfb_tpu.bank import get_lfb as jax_get_lfb  # noqa: E402
from lfb_tpu.core.config import load_config as jax_load_config  # noqa: E402
import lfb_tpu_torch.tools.lfb_loader as port_lfb_loader  # noqa: E402
import lfb_tpu_torch.tools.test_net as port_test_net  # noqa: E402
from lfb_tpu_torch.core.config import \
    load_config as port_load_config  # noqa: E402
from lfb_tpu_torch.models.model import \
    init_params as port_init_params  # noqa: E402
from lfb_tpu_torch.models.spec import \
    build_spec as port_build_spec  # noqa: E402
from lfb_tpu_torch.train import checkpoints as port_ckpt  # noqa: E402
from tests import synthetic  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AVA_YAML = os.path.join(REPO, 'configs', 'ava_r101_lfb_nl_3l.yaml')
CHARADES_YAML = os.path.join(REPO, 'configs', 'charades_r101_lfb_nl.yaml')
TINY = ['NUM_GPUS', '1', 'TPU.REMAT', "''", 'MODEL.DEPTH', '50',
        'MODEL.VIDEO_ARC_CHOICE', '2', 'TRAIN.VIDEO_LENGTH', '4',
        'TEST.VIDEO_LENGTH', '4', 'TRAIN.CROP_SIZE', '32',
        'TEST.CROP_SIZE', '32', 'TEST.SCALE', '36', 'LFB.WINDOW_SIZE', '4',
        'RESNETS.WIDTH_PER_GROUP', '8', 'FBO_NL.LATENT_DIM', '64',
        'TPU.COMPUTE_DTYPE', 'float32', 'TPU.MAX_BOXES_PER_CLIP', '4',
        'TEST.BATCH_SIZE', '4', 'DATALOADER.NUM_WORKERS', '2']


def _reference_test_net():
    """``tools/test_net.py`` as a module (it is a script, not a package)."""
    spec = importlib.util.spec_from_file_location(
        'reference_test_net', os.path.join(REPO, 'tools', 'test_net.py'))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def dataset_opts(ov):
    opts = ['DATADIR', ov['DATADIR']]
    for section in ('AVA', 'CHARADES', 'EPIC'):
        for key, value in ov.get(section, {}).items():
            opts += ['{}.{}'.format(section, key), repr(value)]
    return opts


def save_weights(yaml, opts, root, seed=0):
    """The reference init of the bank-extraction model and of the FBO model
    (the port's ``init_params``, seeded), every all-zero tensor (biases, the
    zero-init NL / FBO output convs) drawn as 0.05 * N(0, 1) so every path
    reaches the outputs, saved as Caffe2 pickles, which both packages load;
    returns the overrides that name them."""
    cfg = port_load_config(yaml, opts)
    gen = torch.Generator().manual_seed(seed)
    out = []
    for key, infer in (('LFB.MODEL_PARAMS_FILE', True),
                       ('TEST.PARAMS_FILE', False)):
        params = port_init_params(
            port_build_spec(cfg, 'val', lfb_infer_only=infer), gen)
        params = {k: v if v.any() else 0.05 * torch.randn(v.shape,
                                                          generator=gen)
                  for k, v in params.items()}
        path = os.path.join(root, key.split('.')[0].lower() + '.pkl')
        port_ckpt.save_params(path, params, model_iter=0, lr=0.01)
        out += [key, path]
    return out


def assert_same_rows(port, ref, printed):
    """Line for line: every field but the score equal, the score within
    1e-4; where the score is ``printed`` (``%.04f``), unequal in at most 1%
    of the lines."""
    assert len(port) == len(ref) > 0
    tipped = 0
    for a, b in zip(port, ref):
        fa, fb = a.rstrip('\n').split(','), b.rstrip('\n').split(',')
        assert fa[:-1] == fb[:-1], (a, b)
        if fa[-1] != fb[-1]:
            tipped += 1
            assert abs(float(fa[-1]) - float(fb[-1])) <= 1.001e-4, (a, b)
    if printed:
        assert tipped <= len(port) // 100, tipped


def assert_same_files(port_dir, ref_dir):
    """The same CSV files; the detections CSVs print ``%.04f`` scores, the
    multi-crop merges full-precision sums of sigmoids of them."""
    names = sorted(f for f in os.listdir(ref_dir) if f.endswith('.csv'))
    assert names == sorted(f for f in os.listdir(port_dir)
                           if f.endswith('.csv'))
    for name in names:
        with open(os.path.join(port_dir, name)) as f:
            port = f.readlines()
        with open(os.path.join(ref_dir, name)) as f:
            ref = f.readlines()
        assert_same_rows(port, ref, printed=name.startswith('detections')
                         and 'combined' not in name)
    return names


def assert_same_bank(port, ref):
    assert sorted(port) == sorted(ref)
    for video in ref:
        assert sorted(port[video]) == sorted(ref[video])
        for key, feats in ref[video].items():
            a, b = np.asarray(port[video][key]), np.asarray(feats)
            assert a.shape == b.shape and a.shape[-1] == 2048
            np.testing.assert_allclose(a, b, rtol=0,
                                       atol=1e-4 * np.abs(b).max())


def run_both(yaml, opts, root, name):
    """``tools/test_net.py``'s test_net and the port's main on the same
    config; returns (port result, reference result, port dir, ref dir)."""
    dirs = {k: os.path.join(root, name, k) for k in ('port', 'ref')}
    for d in dirs.values():
        os.makedirs(d)
    ref = _reference_test_net().test_net(
        jax_load_config(yaml, opts + ['CHECKPOINT.DIR', dirs['ref']]),
        output_dir=dirs['ref'])
    port = port_test_net.main(['--config_file', yaml, '--device', 'cpu']
                              + opts + ['CHECKPOINT.DIR', dirs['port']])
    return port, ref, dirs['port'], dirs['ref']


def read_bank(out_dir, split='val'):
    with open(os.path.join(out_dir, split + '_lfb.pkl'), 'rb') as f:
        return pickle.load(f)


@pytest.fixture(scope='module')
def ava(tmp_path_factory):
    """The tiny AVA split, its weights, and one single-crop run of each
    side: (opts, root, (port result, reference result, port dir, ref
    dir))."""
    root = str(tmp_path_factory.mktemp('ava'))
    opts = TINY + dataset_opts(synthetic.build_ava(root))
    opts += save_weights(AVA_YAML, opts, root)
    return opts, root, run_both(AVA_YAML, opts, root, 'single')


def test_test_net_ava_single_crop_matches_lfb_tpu(ava):
    _, _, (port, ref, port_dir, ref_dir) = ava
    assert 0 <= port['full_map'] <= 1
    np.testing.assert_allclose(port['full_map'], ref['full_map'], rtol=0,
                               atol=1e-6)
    assert assert_same_files(port_dir, ref_dir) == [
        'detections_final_36_shift1_0.850.csv']
    # The bank the sweep wrote (LFB.WRITE_LFB in the YAML).
    assert_same_bank(read_bank(port_dir), read_bank(ref_dir))


def test_test_net_charades_matches_lfb_tpu(tmp_path):
    """Unfused: the fused bottleneck's bank sweep is held to lfb_tpu's in
    ``test_torch_bank.py::test_get_lfb_matches_lfb_tpu``, where lfb_tpu
    runs its Pallas kernel in interpret mode."""
    root = str(tmp_path)
    opts = TINY + ['CHARADES.NUM_TEST_CLIPS_FINAL_EVAL', '3',
                   'MODEL.NUM_CLASSES', '6']
    opts += dataset_opts(synthetic.build_charades(root))
    opts += save_weights(CHARADES_YAML, opts, root)
    port, ref, port_dir, ref_dir = run_both(CHARADES_YAML, opts, root,
                                            'charades')
    assert 0 < port['full_map'] <= 1
    np.testing.assert_allclose(port['full_map'], ref['full_map'], rtol=0,
                               atol=1e-6)
    assert_same_bank(read_bank(port_dir), read_bank(ref_dir))


def test_lfb_loader_matches_get_lfb_and_loads_back(ava):
    """Both splits' banks: train against ``lfb_tpu.bank.get_lfb``, val
    against the bank the reference's single-crop run wrote."""
    opts, root, (_, _, _, ref_dir) = ava
    out = os.path.join(root, 'lfb_loader')
    os.makedirs(out)
    opts = opts + ['CHECKPOINT.DIR', out]
    port = port_lfb_loader.main(['--config_file', AVA_YAML, '--splits',
                                 'train,val', '--device', 'cpu'] + opts)
    cfg = jax_load_config(AVA_YAML, opts + ['LFB.WRITE_LFB', 'False'])
    assert_same_bank(port['train'], jax_get_lfb(cfg, cfg.LFB.MODEL_PARAMS_FILE,
                                                is_train=True))
    assert_same_bank(port['val'], read_bank(ref_dir))
    loaded = port_lfb_loader.main(
        ['--config_file', AVA_YAML, '--splits', 'val', '--device', 'cpu']
        + opts + ['LFB.LOAD_LFB', 'True', 'LFB.LOAD_LFB_PATH', out])
    for video, secs in port['val'].items():
        for sec, feats in secs.items():
            np.testing.assert_array_equal(np.asarray(loaded['val'][video][sec]),
                                          np.asarray(feats))

"""The port's device-resident banks and bank sweep against lfb_tpu on the
CPU.

* ``AvaDeviceBank.build`` gives exactly lfb_tpu's feats, table and counts.
* ``choose_rows`` draws from another random stream than lfb_tpu's, so it is
  held by its properties: rows come from the right (video, sec), none repeats
  within a second, min(count, K) slots are valid and the rest point at the
  zero row.
* Phase B through the device bank matches lfb_tpu's ``make_eval_step`` with
  its bank when every (video, sec) holds at most K = 5 features: each window
  is then the same multiset of rows in another order, and the FBO attention
  has no positional term.  Tolerance 1e-3 relative to the largest output, as
  in ``test_torch_model.py`` (f32 on both sides, sums in other orders).
* ``FrameDeviceBank`` (Charades, EPIC verb, EPIC noun): the build, the
  windows and the chosen rows equal lfb_tpu's exactly, with and without a
  per-video cap (seeded subsampling), and its gathered windows equal the
  host samplers'.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip('torch')

import jax.numpy as jnp  # noqa: E402

import lfb_tpu.models as jax_models  # noqa: E402
from lfb_tpu.bank import get_lfb as jax_get_lfb  # noqa: E402
from lfb_tpu.core.config import load_config as jax_load_config  # noqa: E402
import lfb_tpu.bank.device_bank as jax_bank  # noqa: E402
from lfb_tpu.bank.device_bank import AvaDeviceBank as JaxAvaDeviceBank  # noqa: E402
from lfb_tpu.bank.lfb import construct_ava_lfb as jax_construct_ava_lfb  # noqa: E402
from lfb_tpu.bank.lfb import construct_frame_level_lfb as jax_construct_frame_lfb  # noqa: E402
from lfb_tpu.data.charades import sample_lfb_window  # noqa: E402
from lfb_tpu.data.epic import sample_noun_lfb  # noqa: E402
from lfb_tpu.train.steps import make_eval_step as jax_make_eval_step  # noqa: E402
from lfb_tpu_torch.bank import device_bank  # noqa: E402
from lfb_tpu_torch.bank.device_bank import (AVA_NUM_SECS, AVA_SEC_BASE,  # noqa: E402
                                            AvaDeviceBank, FrameDeviceBank,
                                            build_device_bank)
from lfb_tpu_torch.bank.lfb import (construct_frame_level_lfb,  # noqa: E402
                                    extract_ava_bank, get_lfb, load_lfb,
                                    write_lfb)
from lfb_tpu_torch.config import charades_cfg, flagship_cfg  # noqa: E402
from lfb_tpu_torch.convert import params_from_jax  # noqa: E402
from lfb_tpu_torch.models.model import forward  # noqa: E402
from lfb_tpu_torch.models.spec import build_spec  # noqa: E402
from lfb_tpu_torch.train.steps import make_eval_step  # noqa: E402
from lfb_tpu_torch.core import config as port_config  # noqa: E402
from tests import synthetic  # noqa: E402
from tests.test_torch_model import TINY, close, perturbed_params  # noqa: E402
from tests.test_torch_tools import REPO, dataset_opts, save_weights  # noqa: E402
from tests.test_torch_tools import TINY as TOOLS_TINY  # noqa: E402
from tests.test_torch_tools import \
    assert_same_bank as assert_same_host_bank  # noqa: E402


def host_bank(n_videos, secs, max_per_sec, dim, seed=0):
    """{video: {sec: [feats]}}; feature j of the bank has feats[0] = j + 1,
    so a gathered row names itself."""
    rng = np.random.RandomState(seed)
    bank, tag = {}, 0
    for v in range(n_videos):
        bank[v] = {}
        for sec in secs:
            n = rng.randint(0, max_per_sec + 1)
            if n:
                feats = []
                for _ in range(n):
                    tag += 1
                    f = rng.randn(dim).astype(np.float32)
                    f[0] = tag
                    feats.append(f)
                bank[v][sec] = feats
    return bank


SECS = [AVA_SEC_BASE - 3] + list(range(AVA_SEC_BASE, AVA_SEC_BASE + 12)) + [
    AVA_SEC_BASE + AVA_NUM_SECS]          # two seconds outside the AVA span


@pytest.mark.parametrize('k_store', [0, 3])
def test_build_matches_lfb_tpu(k_store):
    bank = host_bank(3, SECS, 7, dim=16)
    ref = JaxAvaDeviceBank.build(bank, window_size=6, k=2, lfb_dim=16,
                                 k_store=k_store)
    port = AvaDeviceBank.build(bank, window_size=6, k=2, lfb_dim=16,
                               k_store=k_store, device='cpu')
    np.testing.assert_array_equal(port.feats.numpy(), np.asarray(ref.feats))
    np.testing.assert_array_equal(port.table.numpy(), np.asarray(ref.table))
    np.testing.assert_array_equal(port.counts.numpy(), np.asarray(ref.counts))
    assert port.zero_idx == ref.zero_idx


def test_build_device_bank_dtype():
    cfg = flagship_cfg({**TINY, 'TPU.BANK_DTYPE': 'bfloat16'})
    bank = host_bank(2, SECS, 3, dim=cfg.LFB.LFB_DIM)
    dev = build_device_bank(cfg, bank, device='cpu')
    assert dev.feats.dtype == torch.bfloat16
    assert (dev.window_size, dev.k) == (4, 5)
    frames = frame_bank(2, 40, dim=cfg.LFB.LFB_DIM)
    dev = build_device_bank(charades_cfg({'TPU.BANK_DTYPE': 'bfloat16',
                                          'NUM_GPUS': 1}), frames,
                            device='cpu')
    assert isinstance(dev, FrameDeviceBank) and dev.feats.dtype == torch.bfloat16
    assert (dev.window_size, dev.window_mode) == (20, 'charades')
    with pytest.raises(ValueError):          # EPIC verb banks need the names
        build_device_bank(flagship_cfg({**TINY, 'DATASET': 'epic'}), frames,
                          device='cpu')


@pytest.mark.parametrize('seed', [0, 1])
def test_choose_rows_properties(seed):
    W, K, dim = 6, 2, 8
    bank = host_bank(3, SECS, 5, dim=dim, seed=seed)
    dev = AvaDeviceBank.build(bank, window_size=W, k=K, lfb_dim=dim,
                              device='cpu')
    videos = torch.tensor([0, 1, 2, 2, 0])
    secs = torch.tensor([905, 903, 910, AVA_SEC_BASE + 1, 911])
    gen = torch.Generator().manual_seed(seed)
    rows = dev.choose_rows(videos, secs, gen)
    assert rows.shape == (5, W * K)
    feats = dev.gather(videos, secs, torch.Generator().manual_seed(seed))
    np.testing.assert_array_equal(feats.numpy(), dev.feats[rows].numpy())
    for n, (v, s) in enumerate(zip(videos.tolist(), secs.tolist())):
        for j, sec in enumerate(range(s - W // 2, s - W // 2 + W)):
            in_span = AVA_SEC_BASE <= sec < AVA_SEC_BASE + AVA_NUM_SECS
            tags = {int(f[0]) for f in bank[v].get(sec, [])} if in_span else set()
            block = rows[n, j * K:(j + 1) * K].tolist()
            n_valid = min(len(tags), K)
            got = [int(dev.feats[r, 0]) for r in block[:n_valid]]
            assert set(got) <= tags and len(set(got)) == n_valid
            assert all(r == dev.zero_idx for r in block[n_valid:])
    # Every draw over a full second is uniform: a second with more than K
    # features sees each of them in some draw.
    crowded = max(((v, s) for v in bank for s in bank[v]
                   if AVA_SEC_BASE + W <= s < AVA_SEC_BASE + 12),
                  key=lambda vs: len(bank[vs[0]][vs[1]]))
    seen = set()
    for draw in range(40):
        r = dev.choose_rows(torch.tensor([crowded[0]]),
                            torch.tensor([crowded[1] + W // 2]),
                            torch.Generator().manual_seed(draw))
        seen |= {int(dev.feats[i, 0]) for i in r[0, :K].tolist()
                 if i != dev.zero_idx}
    assert seen == {int(f[0]) for f in bank[crowded[0]][crowded[1]]}


def _batch(cfg, rng, n_clips=2, boxes=2):
    crop, t = cfg.TEST.CROP_SIZE, cfg.TEST.VIDEO_LENGTH
    n = n_clips * boxes
    return {
        'data': rng.randint(0, 256, (n_clips, t, crop, crop, 3)).astype(np.uint8),
        'proposals': np.stack([
            np.repeat(np.arange(n_clips), boxes).astype('f'),
            rng.uniform(0, crop / 2, n), rng.uniform(0, crop / 2, n),
            rng.uniform(crop / 2, crop, n),
            rng.uniform(crop / 2, crop, n)], axis=1).astype('f'),
        'metadata': np.stack([rng.randint(0, 3, n), rng.randint(904, 910, n),
                              np.full(n, 400), np.full(n, 600)],
                             axis=1).astype('f'),
        'box_mask': np.ones(n, np.float32)}


def test_phase_b_through_device_bank_matches_lfb_tpu():
    cfg = flagship_cfg(TINY)
    jspec = jax_models.build_spec(cfg, 'test')
    rng = np.random.RandomState(5)
    params = perturbed_params(jspec, rng)
    K = cfg.AVA.LFB_MAX_NUM_FEAT_PER_STEP
    bank = host_bank(3, SECS, K, dim=cfg.LFB.LFB_DIM, seed=5)
    batch = _batch(cfg, rng)

    ref_bank = JaxAvaDeviceBank.build(bank, window_size=cfg.LFB.WINDOW_SIZE,
                                      k=K, lfb_dim=cfg.LFB.LFB_DIM)
    ref = jax_make_eval_step(jspec, bank=ref_bank)(
        {k: jnp.asarray(v) for k, v in params.items()},
        {k: jnp.asarray(v) for k, v in batch.items()})
    step = make_eval_step(build_spec(cfg, 'test'),
                          bank=build_device_bank(cfg, bank, device='cpu'),
                          bank_seed=3)
    out = step(params_from_jax(params, device='cpu'),
               {k: torch.from_numpy(v) for k, v in batch.items()})
    assert set(out) == {'box_pooled', 'logits', 'prob'}
    for key in ('logits', 'prob'):
        close(out[key], ref[key])


def test_extract_ava_bank_matches_the_sweep():
    """The sweep over two batches gives the bank lfb_tpu's
    ``construct_ava_lfb`` builds from the same forward outputs; padding
    boxes (mask 0) stay out."""
    cfg = flagship_cfg(TINY)
    spec = build_spec(cfg, 'test', lfb_infer_only=True)
    jspec = jax_models.build_spec(cfg, 'test', lfb_infer_only=True)
    rng = np.random.RandomState(6)
    params = params_from_jax(perturbed_params(jspec, rng), device='cpu')
    batches = []
    for _ in range(2):
        b = {k: torch.from_numpy(v) for k, v in _batch(cfg, rng).items()}
        b['box_mask'][-1] = 0.0
        batches.append(b)
    bank = extract_ava_bank(spec, params, batches)
    feats = [forward(spec, params, b)['box_pooled'].numpy() for b in batches]
    ref = jax_construct_ava_lfb(feats, [b['metadata'].numpy() for b in batches],
                                [b['box_mask'].numpy() for b in batches])
    assert bank.keys() == ref.keys()
    for v in ref:
        assert bank[v].keys() == ref[v].keys()
        for s in ref[v]:
            np.testing.assert_array_equal(np.stack(bank[v][s]),
                                          np.stack(ref[v][s]))
    assert sum(len(f) for s in bank.values() for f in s.values()) == 6


def frame_bank(n_videos, n_frames, dim, seed=0, every=3, skip=0.3):
    """{video: {frame: feat}} with a frame every ``every`` frames, some
    missing; feature j has feats[0] = j + 1."""
    rng = np.random.RandomState(seed)
    bank, tag = {}, 0
    for v in range(n_videos):
        bank[v] = {}
        for frame in range(every - 1, n_frames, every):
            if rng.rand() < skip:
                continue
            tag += 1
            f = rng.randn(dim).astype(np.float32)
            f[0] = tag
            bank[v][frame] = f
    return bank


def noun_bank(n_videos, n_frames, dim, seed=0):
    """{video: {frame: (n, D)}}, n in 0..4 (some frames empty)."""
    rng = np.random.RandomState(seed)
    bank, tag = {}, 0
    for v in range(n_videos):
        bank[v] = {}
        for frame in range(0, n_frames, 2):
            n = rng.randint(0, 5)
            feats = rng.randn(n, dim).astype(np.float32)
            for i in range(n):
                tag += 1
                feats[i, 0] = tag
            bank[v][frame] = feats
    return bank


def assert_same_bank(port, ref):
    np.testing.assert_array_equal(port.feats.float().numpy(),
                                  np.asarray(ref.feats))
    np.testing.assert_array_equal(port.frame_ids.numpy(),
                                  np.asarray(ref.frame_ids))
    np.testing.assert_array_equal(port.rows.numpy(), np.asarray(ref.rows))
    assert port.zero_idx == ref.zero_idx


CENTERS = np.array([-40, -7, -1, 0, 5, 11, 30, 47, 61, 90, 130, 200],
                   np.int32)


@pytest.mark.parametrize('max_per_video', [0, 9])
@pytest.mark.parametrize('mode', ['charades', 'epic_verb'])
def test_frame_bank_rows_match_lfb_tpu(mode, max_per_video):
    W, fps, dim = 6, 12, 8
    bank = frame_bank(4, 120, dim, seed=1)
    if mode == 'epic_verb':             # keyed by name, dense ids out of order
        names = {v: 'P0{}_{}'.format(v, 7 - v) for v in bank}
        bank = {names[v]: frames for v, frames in bank.items()}
        key_to_idx = {name: 3 - v for v, name in names.items()}
    else:
        key_to_idx = None
    kw = dict(window_size=W, lfb_dim=dim, window_mode=mode, fps=fps,
              clips_per_second=2, max_per_video=max_per_video)
    ref = jax_bank.FrameDeviceBank.build(bank, key_to_idx, **kw)
    port = FrameDeviceBank.build(bank, key_to_idx, **kw, device='cpu')
    assert_same_bank(port, ref)
    if max_per_video:
        assert port.frame_ids.shape[1] == max_per_video
    vids = np.arange(len(CENTERS)) % 4
    want = ref.choose_rows(jnp.asarray(vids), *ref.window(jnp.asarray(CENTERS)))
    got = port.choose_rows(torch.from_numpy(vids),
                           *port.window(torch.from_numpy(CENTERS)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    feats = port.gather_centers(torch.from_numpy(vids),
                                torch.from_numpy(CENTERS))
    np.testing.assert_array_equal(
        feats.numpy(), np.asarray(ref.gather_centers(jnp.asarray(vids),
                                                     jnp.asarray(CENTERS))))
    assert int((got != port.zero_idx).sum()) > 8     # not an empty gather


@pytest.mark.parametrize('max_per_video', [0, 7])
def test_noun_bank_rows_match_lfb_tpu(max_per_video):
    W, dim = 5, 8
    kw = dict(window_size=W, max_per_frame=3, frames_per_second=2, fps=6,
              lfb_dim=dim, max_per_video=max_per_video)
    bank = noun_bank(3, 40, dim, seed=2)
    ref = jax_bank.FrameDeviceBank.build_noun(bank, **kw)
    port = FrameDeviceBank.build_noun(bank, **kw, device='cpu')
    assert_same_bank(port, ref)
    vids = np.arange(len(CENTERS)) % 3
    want = ref.gather_centers(jnp.asarray(vids), jnp.asarray(CENTERS))
    got = port.gather_centers(torch.from_numpy(vids), torch.from_numpy(CENTERS))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if not max_per_video:               # every feature kept: the host sampler
        for v, c, row in zip(vids, CENTERS, got.numpy()):
            np.testing.assert_array_equal(row, sample_noun_lfb(
                bank[v], int(c), window_size=W, max_per_frame=3,
                frames_per_second=2, fps=6, lfb_dim=dim))


@pytest.mark.parametrize('W,cps,fps,mpf,fpsn', [
    (20, 2, 24, 10, 1), (6, 2, 4, 3, 2), (7, 3, 5, 2, 3), (5, 1, 30, 4, 1)])
def test_window_functions_match_lfb_tpu(W, cps, fps, mpf, fpsn):
    centers = np.arange(-97, 311, 7).astype(np.int32)   # negative centers too
    c_j, c_t = jnp.asarray(centers), torch.from_numpy(centers)
    pairs = [
        (jax_bank.charades_window(c_j, window_size=W, clips_per_second=cps,
                                  fps=fps),
         device_bank.charades_window(c_t, window_size=W, clips_per_second=cps,
                                     fps=fps)),
        (jax_bank.epic_verb_window(c_j, window_size=W, fps=fps),
         device_bank.epic_verb_window(c_t, window_size=W, fps=fps)),
        (jax_bank.epic_noun_window(c_j, window_size=W, max_per_frame=mpf,
                                   frames_per_second=fpsn, fps=fps),
         device_bank.epic_noun_window(c_t, window_size=W, max_per_frame=mpf,
                                      frames_per_second=fpsn, fps=fps))]
    for (jb, je), (tb, te) in pairs:
        np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
        np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    # The noun window is the host sampler's int() truncation.
    lower, upper = pairs[2][1]
    secs = float(W) / (mpf * fpsn)
    for c, lo, up in zip(centers.tolist(), lower.tolist(), upper.tolist()):
        assert lo == int(c - (secs / 2) * fps)
        assert up == int(lo + secs * fps)


def test_charades_gather_matches_the_host_sampler():
    cfg = charades_cfg({'NUM_GPUS': 1, 'LFB.LFB_DIM': 16})
    bank = frame_bank(3, 700, 16, seed=4, every=12)
    dev = build_device_bank(cfg, bank, device='cpu')
    centers = np.array([0, 50, 119, 240, 333, 600, 690, 1000], np.int32)
    vids = np.arange(len(centers)) % 3
    got = dev.gather_centers(torch.from_numpy(vids), torch.from_numpy(centers))
    assert got.shape == (len(centers), 20, 16)
    for v, c, window in zip(vids, centers, got.numpy()):
        np.testing.assert_array_equal(window, sample_lfb_window(
            bank[v], int(c), window_size=20, clips_per_second=2, fps=24,
            lfb_dim=16))


@pytest.mark.parametrize('dataset', ['charades', 'epic'])
def test_construct_frame_level_lfb_matches_lfb_tpu(dataset):
    rng = np.random.RandomState(8)
    if dataset == 'charades':
        meta = [(v, f) for v in range(3) for f in range(11, 90, 12)]
    else:
        meta = [(i, 'P01_0{}'.format(v), f, 'x') for i, (v, f) in enumerate(
            (v, f) for v in range(3) for f in range(15, 100, 30))]
    # Fixed-size batches of 4: the last one padded past the clip list.
    n = -(-len(meta) // 4) * 4
    feats = [rng.randn(4, 1, 1, 1, 6).astype('f') for _ in range(n // 4)]
    got = construct_frame_level_lfb(feats, meta, dataset)
    ref = jax_construct_frame_lfb(feats, meta, dataset)
    assert got.keys() == ref.keys()
    assert sum(len(v) for v in got.values()) == len(meta) < n
    for video in ref:
        assert got[video].keys() == ref[video].keys()
        for frame in ref[video]:
            assert got[video][frame].shape == (6,)
            np.testing.assert_array_equal(got[video][frame], ref[video][frame])


def test_write_then_load_lfb_round_trips(tmp_path):
    cfg = charades_cfg({'NUM_GPUS': 1, 'CHECKPOINT.DIR': str(tmp_path),
                        'LFB.LOAD_LFB_PATH': str(tmp_path)})
    bank = frame_bank(2, 50, 4, seed=9)
    path = write_lfb(cfg, bank, is_train=False)
    assert path.endswith('val_lfb.pkl')
    back = load_lfb(cfg, is_train=False)
    assert back.keys() == bank.keys()
    for v in bank:
        assert back[v].keys() == bank[v].keys()
        for f in bank[v]:
            np.testing.assert_array_equal(back[v][f], bank[v][f])


# AVA's get_lfb is held to lfb_tpu's in test_torch_tools.py, through the
# command lines, on both splits.
GET_LFB_CASES = {
    'charades': (synthetic.build_charades, 'charades_r101_lfb_nl.yaml',
                 ['TPU.PALLAS_BOTTLENECK', 'True']),
    'epic verb': (synthetic.build_epic, 'epic_verb_r50_lfb_nl.yaml', []),
}


@pytest.mark.parametrize('case', sorted(GET_LFB_CASES))
def test_get_lfb_matches_lfb_tpu(tmp_path, case):
    """``get_lfb`` over a tiny on-disk split (the DataLoader, to_device and
    the extraction sweep; Charades through the fused bottleneck's plain
    version) against ``lfb_tpu.bank.get_lfb`` on the same pickle: the same
    keys, rows within 1e-4 of their largest value (f32 through R50, sums in
    other orders), and the pickle ``LFB.WRITE_LFB`` writes is the bank."""
    build, yaml, extra = GET_LFB_CASES[case]
    root = str(tmp_path)
    yaml = os.path.join(REPO, 'configs', yaml)
    opts = TOOLS_TINY + extra + dataset_opts(build(root))
    opts += save_weights(yaml, opts, root) + ['CHECKPOINT.DIR', root]
    cfg = port_config.load_config(yaml, opts + ['LFB.WRITE_LFB', 'True'])
    port = get_lfb(cfg, cfg.LFB.MODEL_PARAMS_FILE, is_train=False,
                   device='cpu')
    ref = jax_get_lfb(jax_load_config(yaml, opts + ['LFB.WRITE_LFB', 'False']),
                      cfg.LFB.MODEL_PARAMS_FILE, is_train=False)
    assert len(ref) == 2
    assert_same_host_bank(port, ref)
    written = load_lfb(port_config.clone(cfg, {'LFB.LOAD_LFB_PATH': root}),
                       is_train=False)
    assert written.keys() == port.keys()
    for video in port:
        for key in port[video]:
            np.testing.assert_array_equal(np.asarray(written[video][key]),
                                          np.asarray(port[video][key]))

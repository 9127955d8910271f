"""The port's device-resident AVA bank and bank sweep against lfb_tpu on
the CPU.

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
"""

import numpy as np
import pytest

torch = pytest.importorskip('torch')

import jax.numpy as jnp  # noqa: E402

import lfb_tpu.models as jax_models  # noqa: E402
from lfb_tpu.bank.device_bank import AvaDeviceBank as JaxAvaDeviceBank  # noqa: E402
from lfb_tpu.bank.lfb import construct_ava_lfb as jax_construct_ava_lfb  # noqa: E402
from lfb_tpu.train.steps import make_eval_step as jax_make_eval_step  # noqa: E402
from lfb_tpu_torch.bank.device_bank import (AVA_NUM_SECS, AVA_SEC_BASE,  # noqa: E402
                                            AvaDeviceBank, build_device_bank)
from lfb_tpu_torch.bank.lfb import extract_ava_bank  # noqa: E402
from lfb_tpu_torch.config import flagship_cfg  # noqa: E402
from lfb_tpu_torch.convert import params_from_jax  # noqa: E402
from lfb_tpu_torch.models.model import forward  # noqa: E402
from lfb_tpu_torch.models.spec import build_spec  # noqa: E402
from lfb_tpu_torch.train.steps import make_eval_step  # noqa: E402
from tests.test_torch_model import TINY, close, perturbed_params  # noqa: E402


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
                               k_store=k_store)
    np.testing.assert_array_equal(port.feats.numpy(), np.asarray(ref.feats))
    np.testing.assert_array_equal(port.table.numpy(), np.asarray(ref.table))
    np.testing.assert_array_equal(port.counts.numpy(), np.asarray(ref.counts))
    assert port.zero_idx == ref.zero_idx


def test_build_device_bank_dtype():
    cfg = flagship_cfg({**TINY, 'TPU.BANK_DTYPE': 'bfloat16'})
    bank = host_bank(2, SECS, 3, dim=cfg.LFB.LFB_DIM)
    dev = build_device_bank(cfg, bank)
    assert dev.feats.dtype == torch.bfloat16
    assert (dev.window_size, dev.k) == (4, 5)
    with pytest.raises(NotImplementedError):
        build_device_bank(flagship_cfg({**TINY, 'DATASET': 'charades'}), bank)


@pytest.mark.parametrize('seed', [0, 1])
def test_choose_rows_properties(seed):
    W, K, dim = 6, 2, 8
    bank = host_bank(3, SECS, 5, dim=dim, seed=seed)
    dev = AvaDeviceBank.build(bank, window_size=W, k=K, lfb_dim=dim)
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
                          bank=build_device_bank(cfg, bank), bank_seed=3)
    out = step(params_from_jax(params),
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
    params = params_from_jax(perturbed_params(jspec, rng))
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

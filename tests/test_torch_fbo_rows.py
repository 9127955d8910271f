"""The FBO on an AVA batch's real rows alone (``train/steps.py``,
``models/model.py``, ``models/fbo.py``), on the CPU, against the port's
own computation over the whole batch.

An AVA batch pads each clip's boxes to ``TPU.MAX_BOXES_PER_CLIP`` rows with
``box_mask`` 0.  The steps read which rows are real, gather the bank
windows of those rows alone and run the FBO on them; a padding row's FBO
output is 0.  Held here, on a tiny R50 spec with a device bank and dropout
on:

* on the real rows the logits, prob, loss and every gradient are those of
  the FBO run over every row, within f32 rounding, and the generator ends
  where it ends then (the same window draws and full-shape dropout masks);
* a padding row's logits are the classifier over [its head row, 0];
* a batch with every row real runs the whole-batch path, bit for bit;
* a batch with no real row gives finite outputs and zero FBO gradients;
* ``fbo.rows`` and ``bank.rows`` count the real rows.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip('torch')

from lfb_tpu_torch.bank.device_bank import AVA_SEC_BASE, AvaDeviceBank  # noqa: E402
from lfb_tpu_torch.config import flagship_cfg  # noqa: E402
from lfb_tpu_torch.models.model import LFBModel, init_params  # noqa: E402
from lfb_tpu_torch.models.spec import build_spec  # noqa: E402
from lfb_tpu_torch.train import optimizer as opt  # noqa: E402
from lfb_tpu_torch.train import steps  # noqa: E402
from lfb_tpu_torch.utils import profiling  # noqa: E402
from tests.torch_threads import worker_threads  # noqa: E402,F401

CLIPS, BOXES = 4, 4
CFG = {'MODEL.DEPTH': 50, 'MODEL.VIDEO_ARC_CHOICE': 2,
       'RESNETS.WIDTH_PER_GROUP': 8, 'FBO_NL.LATENT_DIM': 64,
       'TRAIN.VIDEO_LENGTH': 4, 'TEST.VIDEO_LENGTH': 4,
       'TRAIN.CROP_SIZE': 32, 'TEST.CROP_SIZE': 32, 'LFB.WINDOW_SIZE': 4,
       'AVA.LFB_MAX_NUM_FEAT_PER_STEP': 2, 'TPU.COMPUTE_DTYPE': 'float32',
       'TRAIN.DROPOUT_RATE': 0.3, 'FBO_NL.DROPOUT_RATE': 0.2,
       'TPU.MAX_BOXES_PER_CLIP': BOXES, 'TPU.REMAT': '', 'NUM_GPUS': 1}
# Clip 3 has no box; the others 2, 1 and 3.
MASKS = {'padded': np.float32([1, 1, 0, 0, 1, 0, 0, 0, 1, 1, 1, 0,
                               0, 0, 0, 0]),
         'all real': np.ones(CLIPS * BOXES, np.float32),
         'none real': np.zeros(CLIPS * BOXES, np.float32)}
BANK_SEED = 5


@pytest.fixture(scope='module')
def tiny():
    cfg = flagship_cfg(CFG)
    rng = np.random.RandomState(0)
    secs = range(AVA_SEC_BASE, AVA_SEC_BASE + 12)
    host = {v: {s: [rng.randn(cfg.LFB.LFB_DIM).astype('f')
                    for _ in range(1 + (v + s) % 3)] for s in secs}
            for v in range(2)}
    bank = AvaDeviceBank.build(host, window_size=cfg.LFB.WINDOW_SIZE,
                               k=cfg.AVA.LFB_MAX_NUM_FEAT_PER_STEP,
                               lfb_dim=cfg.LFB.LFB_DIM, device='cpu')
    spec = build_spec(cfg, 'train')
    return {'cfg': cfg, 'bank': bank, 'spec': spec,
            'eval_spec': build_spec(cfg, 'test'),
            'params': drawn_params(spec), 'rng': rng}


def ava_batch(rng, mask):
    """An AVA batch in the data layer's layout: each clip's real boxes
    first, then zero rows with ``box_mask`` 0."""
    n, crop = CLIPS * BOXES, 32
    real = mask > 0
    proposals = np.zeros((n, 5), 'f')
    proposals[:, 0] = np.arange(n) // BOXES
    proposals[:, 1:3] = rng.uniform(0, crop / 2, (n, 2))
    proposals[:, 3:] = rng.uniform(crop / 2, crop, (n, 2))
    metadata = np.stack([np.arange(n) // BOXES % 2,
                         AVA_SEC_BASE + 2 + np.arange(n) % 8,
                         np.full(n, 400), np.full(n, 600)], 1)
    batch = {'data': rng.randint(0, 256, (CLIPS, 4, crop, crop, 3)).astype(
                 np.uint8),
             'proposals': proposals * real[:, None],
             'metadata': (metadata * real[:, None]).astype('f'),
             'labels': ((rng.rand(n, 80) < 0.2) * real[:, None]).astype('f'),
             'box_mask': mask.copy()}
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def whole_batch(spec, bank, batch, generator):
    """The batch with every row's window, as the FBO over every row takes
    it."""
    meta = batch['metadata']
    return {**batch, 'lfb': bank.gather(meta[:, 0].long(),
                                        meta[:, 1].long(), generator)}


def forward_and_grads(spec, params, batch, generator):
    """(outputs, loss, {name: gradient}) of a train-mode forward."""
    trainable, frozen = steps.split_params(spec, params)
    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in trainable.items()}
    out = LFBModel(spec).run({**leaves, **frozen}, batch, train=True,
                             generator=generator)
    value = steps.loss(spec, out['logits'], batch['labels'],
                       batch['box_mask'])
    grads = torch.autograd.grad(value, list(leaves.values()))
    return out, value, dict(zip(leaves, grads))


def padding_logits(params, box_pooled, latent):
    """The classifier over [head row, 0] on every row."""
    head = torch.cat([box_pooled, box_pooled.new_zeros(
        (box_pooled.shape[0], latent))], dim=-1)
    return head @ params['pred_w'].t() + params['pred_b']


def close(got, want, tol=1e-5):
    """|got - want| <= tol * max |want| (f32 sums in another order)."""
    want = want.detach().double()
    np.testing.assert_allclose(got.detach().double().numpy(), want.numpy(),
                               rtol=0, atol=tol * float(want.abs().max()))


def is_head(name):
    """An FBO or classifier parameter."""
    return name.startswith(('lfb_nl', 'lfb_1x1', 'pred_')) or \
        '_fbonl_reduc' in name


def assert_grads_close(got, want):
    """Each leaf within 1e-5 of the larger of its own largest gradient and
    the median leaf's: the key biases the softmax nulls, and the non-local
    blocks' gradients at these random weights, are round-off on both sides
    (1e-10 of the median leaf, or less)."""
    assert set(got) == set(want)
    median = float(np.median([float(g.abs().max()) for g in want.values()]))
    assert median > 0
    for name, grad in want.items():
        scale = max(float(grad.abs().max()), median)
        np.testing.assert_allclose(got[name].double().numpy(),
                                   grad.double().numpy(), rtol=0,
                                   atol=1e-5 * scale, err_msg=name)


def drawn_params(spec, seed=0):
    """Every weight drawn at a fan-in scale: the released init's zero
    projections would leave the FBO's gradients at 0."""
    generator = torch.Generator().manual_seed(seed)
    return {k: torch.randn(v.shape, generator=generator) * 0.5
            / math.sqrt(math.prod(v.shape[1:]))
            for k, v in init_params(spec, generator).items()}


@pytest.mark.parametrize('fbo_type', ['nl', 'avg', 'max'])
def test_eval_real_rows_match_the_whole_batch(tiny, fbo_type):
    spec, params = tiny['eval_spec'], tiny['params']
    if fbo_type != 'nl':
        spec = build_spec(flagship_cfg({**CFG, 'LFB.FBO_TYPE': fbo_type}),
                          'test')
        params = drawn_params(spec)
    bank, mask = tiny['bank'], MASKS['padded']
    batch = ava_batch(tiny['rng'], mask)
    got = steps.make_eval_step(spec, bank=bank, bank_seed=BANK_SEED)(
        params, batch)
    generator = torch.Generator().manual_seed(BANK_SEED)
    with torch.inference_mode():
        want = LFBModel(spec).run(params, whole_batch(spec, bank, batch,
                                                      generator))
    real, pad = mask > 0, mask == 0
    assert torch.equal(got['box_pooled'], want['box_pooled'])
    for key in ('logits', 'prob'):
        close(got[key][real], want[key][real])
    # A padding row's FBO part is 0: its logits are the classifier over
    # [head row, 0].  The FBO-NL over its window (zero rows: a padding row
    # names no second) gives more than 0; the mean and the max give 0.
    ref = padding_logits(params, got['box_pooled'],
                         spec.head_dim - got['box_pooled'].shape[1])
    assert torch.equal(got['logits'][pad], ref[pad])
    assert torch.allclose(got['logits'][pad], want['logits'][pad]) == (
        fbo_type != 'nl')


def test_train_real_rows_match_the_whole_batch(tiny):
    spec, bank, params = tiny['spec'], tiny['bank'], tiny['params']
    batch = ava_batch(tiny['rng'], MASKS['padded'])
    real = MASKS['padded'] > 0
    gen_whole = torch.Generator().manual_seed(3)
    want, want_loss, want_grads = forward_and_grads(
        spec, params, whole_batch(spec, bank, batch, gen_whole), gen_whole)
    gen = torch.Generator().manual_seed(3)
    compact = steps._inject_device_bank_lfb(spec, bank, batch, gen)
    assert compact['fbo_rows'].tolist() == np.flatnonzero(real).tolist()
    assert compact['lfb'].shape[0] == real.sum()
    got, got_loss, got_grads = forward_and_grads(spec, params, compact, gen)
    # The same window draws and full-shape dropout masks, in the same order.
    assert torch.equal(gen.get_state(), gen_whole.get_state())
    close(got_loss, want_loss)
    for key in ('logits', 'prob'):
        close(got[key][real], want[key][real])
    assert_grads_close(got_grads, want_grads)


def test_train_step_keeps_the_generator_stream(tiny):
    """The step draws what the whole-batch forward draws: the generator
    ends in the same state, and the real rows' prob agrees."""
    spec, bank = tiny['spec'], tiny['bank']
    params = {k: v.clone() for k, v in tiny['params'].items()}
    batch = ava_batch(tiny['rng'], MASKS['padded'])
    real = MASKS['padded'] > 0
    gen_whole = torch.Generator().manual_seed(11)
    want, _, _ = forward_and_grads(
        spec, params, whole_batch(spec, bank, batch, gen_whole), gen_whole)
    trainable, frozen = steps.split_params(spec, params)
    state = opt.init_state(params, set(frozen))
    gen = torch.Generator().manual_seed(11)
    *_, aux = steps.make_train_step(spec, tiny['cfg'].SOLVER, bank=bank)(
        trainable, frozen, state, batch, gen, 0.01)
    assert torch.equal(gen.get_state(), gen_whole.get_state())
    close(aux['prob'][real], want['prob'][real])


def test_every_row_real_is_the_whole_batch_path_bit_for_bit(tiny):
    spec, bank, params = tiny['spec'], tiny['bank'], tiny['params']
    batch = ava_batch(tiny['rng'], MASKS['all real'])
    gen = torch.Generator().manual_seed(2)
    injected = steps._inject_device_bank_lfb(spec, bank, batch, gen)
    assert 'fbo_rows' not in injected
    gen_whole = torch.Generator().manual_seed(2)
    whole = whole_batch(spec, bank, batch, gen_whole)
    assert torch.equal(injected['lfb'], whole['lfb'])
    got, got_loss, got_grads = forward_and_grads(spec, params, injected, gen)
    want, want_loss, want_grads = forward_and_grads(spec, params, whole,
                                                    gen_whole)
    assert torch.equal(got['logits'], want['logits'])
    assert torch.equal(got_loss, want_loss)
    # The backbone's CPU backward sums in another order from run to run
    # (threads), the same path twice included; the FBO's and the
    # classifier's gradients do not.
    assert_grads_close(got_grads, want_grads)
    for name, grad in want_grads.items():
        if is_head(name):
            assert torch.equal(got_grads[name], grad), name
    eval_spec = tiny['eval_spec']
    out = steps.make_eval_step(eval_spec, bank=bank, bank_seed=BANK_SEED)(
        params, batch)
    with torch.inference_mode():
        ref = LFBModel(eval_spec).run(params, whole_batch(
            eval_spec, bank, batch,
            torch.Generator().manual_seed(BANK_SEED)))
    for key in ('logits', 'prob', 'box_pooled'):
        assert torch.equal(out[key], ref[key])


def test_no_real_row_gives_finite_outputs(tiny):
    spec, bank = tiny['spec'], tiny['bank']
    params = {k: v.clone() for k, v in tiny['params'].items()}
    batch = ava_batch(tiny['rng'], MASKS['none real'])
    out = steps.make_eval_step(tiny['eval_spec'], bank=bank,
                               with_loss=True)(params, batch)
    assert bool(torch.isfinite(out['prob']).all())
    ref = padding_logits(params, out['box_pooled'], spec.fbo.latent_dim)
    assert torch.equal(out['logits'], ref)
    compact = steps._inject_device_bank_lfb(
        spec, bank, batch, torch.Generator().manual_seed(0))
    assert compact['lfb'].shape[0] == 0
    _, value, grads = forward_and_grads(spec, params, compact,
                                        torch.Generator().manual_seed(0))
    assert float(value.detach()) == 0.0
    for name, grad in grads.items():
        assert bool(torch.isfinite(grad).all()), name
        if is_head(name) and not name.startswith('pred_'):
            assert not bool(grad.any()), name
    trainable, frozen = steps.split_params(spec, params)
    state = opt.init_state(params, set(frozen))
    *_, aux = steps.make_train_step(spec, tiny['cfg'].SOLVER, bank=bank)(
        trainable, frozen, state, batch, torch.Generator().manual_seed(0),
        0.01)
    assert float(aux['loss']) == 0.0
    assert bool(torch.isfinite(aux['prob']).all())


@pytest.mark.parametrize('mask', sorted(MASKS))
def test_counters_count_the_rows_the_fbo_runs_on(tiny, mask):
    spec, bank = tiny['eval_spec'], tiny['bank']
    batch = ava_batch(tiny['rng'], MASKS[mask])
    rows = int((MASKS[mask] > 0).sum())
    window = rows * spec.fbo.num_lfb_feat
    before = profiling.counts()
    steps.make_eval_step(spec, bank=bank)(tiny['params'], batch)
    after = profiling.counts()
    grew = {k: after.get(k, 0) - before.get(k, 0) for k in
            ('fbo.rows', 'bank.rows', 'bank.bytes')}
    assert grew == {'fbo.rows': rows, 'bank.rows': window,
                    'bank.bytes': window * spec.fbo.lfb_dim * 4}

"""On-card smoke checks: the hand kernels' numerics and the training paths
that the CPU tests cannot cover, since the kernels exist only compiled on a
card (port of ``tools/tpu_smoke.py``, check for check).

Run on a machine with a CUDA device::

    python -m lfb_tpu_torch.tools.gpu_smoke

Prints a ``[PASS]`` or ``[FAIL]`` line per check, exits non-zero on the
first failure and ends with ``GPU smoke: all checks passed``.  Checks:

  1. ``FusedAttention`` forward == ``attention_plain`` (f32, two shapes).
  2. ``FusedAttention``'s dq == autograd through ``attention_plain``.
  3. ``roi_align_maxpool`` == the plain RoIAlign + 7x7 max.
  4. bf16 train steps of a tiny EPIC config: losses finite and falling.
  5. The same train step in a one-rank NCCL group
     (``parallel.mesh.init_distributed``) with the kernels (stem forward
     and dW, attention forward and backward): its conv1_w update matches
     the same step on the CPU, where every kernel wrapper takes its plain
     version.  Both run in f32: bf16 rounding alone moves this update by
     a fifth to a third of its largest element (the step in bf16 against
     f32, on the CPU), so only f32 holds a kernel to 2e-2 of it.
  6. ``TPU.BANK_SHARDED`` in that group: the row-sharded bank's window
     gather (``shard_bank``) matches the replicated ``AvaDeviceBank``'s
     bit for bit.

Each check is a function of its ``device``, so the CPU tests drive checks
4 and 6 with the plain versions at smaller sizes.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import os
import sys
import tempfile

import numpy as np
import torch

# Check 4's model and batch: (TRAIN.VIDEO_LENGTH, TRAIN.CROP_SIZE, clips).
CARD_SIZES = (8, 64, 8)
NUM_CLASSES = 20
LR = 3e-4
STEPS = 8


def check(name: str, ok: bool, detail: str = '') -> None:
    print('[{}] {} {}'.format('PASS' if ok else 'FAIL', name, detail),
          flush=True)
    if not ok:
        sys.exit(1)


def check_attention(device) -> None:
    """Checks 1 and 2 at the in-backbone (4, 784, 196, 512) and the FBO
    decode (16, 1, 300, 512) shapes, f32."""
    from lfb_tpu_torch.ops.cuda_attention import (FusedAttention,
                                                  attention_plain)
    rng = np.random.RandomState(0)
    for shape in [(4, 784, 196, 512), (16, 1, 300, 512)]:
        B, Nq, Nk, C = shape
        q, k, v = (torch.from_numpy(rng.randn(B, n, C).astype(np.float32))
                   .to(device) for n in (Nq, Nk, Nk))
        scale = C ** -0.5
        out = FusedAttention.apply(q, k, v, scale)
        d = (out - attention_plain(q, k, v, scale)).abs().max().item()
        check('attention fwd {}'.format(shape), d < 5e-3, 'max diff %.2e' % d)

        grads = []
        for fn in (lambda q: FusedAttention.apply(q, k, v, scale),
                   lambda q: attention_plain(q, k, v, scale)):
            qg = q.detach().requires_grad_(True)
            grads.append(torch.autograd.grad((fn(qg) ** 2).sum(), qg)[0])
        gk, gp = grads
        d = ((gk - gp).abs().max() / (gp.abs().max() + 1e-6)).item()
        check('attention dq {}'.format(shape), d < 5e-2, 'rel diff %.2e' % d)


def check_roi_align(device) -> None:
    """Check 3: (8, 16, 16, 2048) features, 32 boxes."""
    from lfb_tpu_torch.ops.cuda_roi_align import roi_align_maxpool
    from lfb_tpu_torch.ops.pooling import max_pool_2d
    from lfb_tpu_torch.ops.roi_align import roi_align
    rng = np.random.RandomState(0)
    feats = torch.from_numpy(rng.randn(8, 16, 16, 2048).astype(np.float32))
    rois = torch.from_numpy(np.stack(
        [np.repeat(np.arange(8), 4)] + [rng.uniform(0, 256, 32)
                                        for _ in range(4)], 1)
        .astype(np.float32))
    feats, rois = feats.to(device), rois.to(device)
    out = roi_align_maxpool(feats, rois)
    ref = max_pool_2d(roi_align(feats, rois), (7, 7), (1, 1)).reshape(32, 2048)
    d = (out - ref).abs().max().item()
    check('roi_align+maxpool', d < 5e-2, 'max abs diff %.3f' % d)


def tiny_epic_cfg(length: int, crop: int, clips: int,
                  compute_dtype: str = 'bfloat16'):
    """``tools/tpu_smoke.py``'s training config: EPIC, 20 softmax classes,
    frozen affine, no bank, dropout 0, at ``length`` frames of ``crop``."""
    from lfb_tpu_torch.core import config as C
    cfg = C.default_config()
    cfg.DATASET = 'epic'
    cfg.MODEL.NUM_CLASSES = NUM_CLASSES
    cfg.MODEL.MULTI_LABEL = False
    cfg.MODEL.USE_AFFINE = True
    cfg.NONLOCAL.USE_BN = False
    cfg.NONLOCAL.USE_AFFINE = True
    cfg.TRAIN.VIDEO_LENGTH = cfg.TEST.VIDEO_LENGTH = length
    cfg.TRAIN.CROP_SIZE = cfg.TEST.CROP_SIZE = crop
    cfg.NUM_GPUS = 1
    cfg.TRAIN.BATCH_SIZE = cfg.TEST.BATCH_SIZE = clips
    cfg.TRAIN.DROPOUT_RATE = 0.0
    cfg.TPU.COMPUTE_DTYPE = compute_dtype
    return C.finalize(cfg)


class TinyRun:
    """Check 4's model (activations in ``compute_dtype``), its optimizer
    state and one batch, on ``device``; :meth:`step` runs
    ``make_train_step`` once."""

    def __init__(self, device='cuda', sizes=CARD_SIZES, seed: int = 0,
                 compute_dtype: str = 'bfloat16'):
        from lfb_tpu_torch.models.model import init_params
        from lfb_tpu_torch.models.spec import build_spec
        from lfb_tpu_torch.train import optimizer as opt
        from lfb_tpu_torch.train.steps import make_train_step, split_params
        length, crop, clips = sizes
        self.device = torch.device(device)
        cfg = tiny_epic_cfg(length, crop, clips, compute_dtype)
        spec = build_spec(cfg, 'train')
        params = init_params(spec, torch.Generator(self.device).manual_seed(
            seed))
        self.trainable, self.frozen = split_params(spec, params)
        self.state = opt.init_state(params, set(self.frozen))
        self.train_step = make_train_step(spec, cfg.SOLVER)
        rng = np.random.RandomState(seed)
        self.batch = {
            'data': torch.from_numpy(0.1 * rng.randn(
                clips, length, crop, crop, 3).astype(np.float32)).to(device),
            'labels': torch.from_numpy(rng.randint(
                0, NUM_CLASSES, size=(clips,))).to(device)}

    def to(self, device) -> 'TinyRun':
        """This run with its params, state and batch copied to
        ``device``."""
        moved = copy.copy(self)
        moved.device = torch.device(device)
        move = lambda d: {k: v.to(device, copy=True) for k, v in d.items()}
        moved.trainable, moved.frozen = move(self.trainable), move(self.frozen)
        moved.state = type(self.state)(move(self.state.momentum))
        moved.batch = move(self.batch)
        return moved

    def step(self, seed: int) -> float:
        generator = torch.Generator(self.device).manual_seed(seed)
        self.trainable, self.frozen, self.state, aux = self.train_step(
            self.trainable, self.frozen, self.state, self.batch, generator,
            LR)
        return aux['loss'].item()


def check_training(device, sizes=CARD_SIZES):
    """Check 4: ``STEPS`` bf16 train steps on one batch; returns the
    losses."""
    run = TinyRun(device, sizes, seed=0)
    losses = [run.step(i) for i in range(STEPS)]
    check('bf16 training', bool(np.isfinite(losses).all())
          and losses[-1] < losses[0],
          'losses %.4f -> %.4f' % (losses[0], losses[-1]))
    return losses


@contextlib.contextmanager
def one_rank_group(device):
    """A process group of one rank on ``device`` (NCCL on ``cuda``, gloo on
    the CPU) over a file store in a temporary directory; destroyed on
    exit."""
    from lfb_tpu_torch.parallel import mesh
    with tempfile.TemporaryDirectory() as d:
        mesh.init_distributed(device, world=1, rank=0,
                              init_method='file://' + os.path.join(d, 'store'))
        try:
            yield
        finally:
            torch.distributed.destroy_process_group()


def check_group_step(device, start: TinyRun):
    """Check 5, then check 6 in the same one-rank group: one step on
    ``device`` from ``start``'s params and batch, whose conv1_w update must
    match the same step on the CPU (run before the group exists) within
    2e-2 of the CPU update's largest element.  Returns (max abs diff, that
    scale)."""
    from lfb_tpu_torch.parallel import mesh
    if mesh.distributed():
        raise RuntimeError('check 5: the CPU step must run outside a group')
    before = start.trainable['conv1_w'].detach().cpu()
    cpu = start.to('cpu')
    cpu_loss = cpu.step(0)
    card = start.to(device)
    with one_rank_group(device):
        card_loss = card.step(0)
        check('train step in a one-rank {} group'.format(
            torch.distributed.get_backend()), bool(np.isfinite(card_loss)),
            'loss %.4f (CPU %.4f)' % (card_loss, cpu_loss))
        got = card.trainable['conv1_w'].cpu() - before
        ref = cpu.trainable['conv1_w'] - before
        d = (got - ref).abs().max().item()
        scale = ref.abs().max().item()
        check('conv1_w update == CPU step', d < 2e-2 * max(scale, 1e-12),
              'max abs diff %.2e (scale %.2e)' % (d, scale))
        check_sharded_bank(device)
    return d, scale


def check_sharded_bank(device) -> float:
    """Check 6, inside a process group: windows from the row-sharded bank
    against the replicated bank's; returns the max difference."""
    from lfb_tpu_torch.bank.device_bank import AvaDeviceBank, shard_bank
    rng = np.random.RandomState(0)
    host_bank = {v: {902 + s: [rng.randn(2048).astype(np.float32)
                               for _ in range(1 + (v + s) % 3)]
                     for s in range(0, 12, 2)} for v in range(4)}
    bank = AvaDeviceBank.build(host_bank, window_size=4, k=2, device=device)
    vid = torch.from_numpy(rng.randint(0, 4, 8)).to(device)
    sec = torch.full((8,), 906, dtype=torch.int64, device=device)
    ref = bank.gather(vid, sec, torch.Generator(device).manual_seed(3))
    sharded = shard_bank(bank)
    out = sharded.gather(vid, sec, torch.Generator(device).manual_seed(3))
    d = (out - ref).abs().max().item()
    check('sharded device bank ({} rows a rank)'.format(
        sharded.feats.shape[0]), d == 0.0, 'max diff %.1e' % d)
    return d


def main(argv=None) -> None:
    argparse.ArgumentParser(description=__doc__.split('\n')[0]).parse_args(
        argv)
    if not torch.cuda.is_available():
        raise RuntimeError('gpu_smoke runs on a CUDA device; none is '
                           'available')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print('card: {}'.format(torch.cuda.get_device_name(0)), flush=True)
    device = torch.device('cuda')
    check_attention(device)
    check_roi_align(device)
    check_training(device)
    check_group_step(device, TinyRun(device, CARD_SIZES, seed=1,
                                     compute_dtype='float32'))
    print('GPU smoke: all checks passed', flush=True)


if __name__ == '__main__':
    main()

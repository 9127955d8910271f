"""Real-scale LFB resource rehearsal on the card (port of
``tools/bank_rehearsal.py``, run for run).

Every other check of the port runs toy or val-scale banks; the reference
works at 3.3 GB (AVA) / 4.4 GB (Charades) bank scale with 235-video x
897-second index spans.  This tool synthesizes a bank at real scale, puts it
in device memory through the full ``AvaDeviceBank`` / ``FrameDeviceBank``
build path and measures what fits next to the flagship model:

  * the bank's build + host-to-device copy time, its bytes and the bytes of
    its index tables (int64 here, twice ``lfb_tpu``'s int32 figure),
  * device-bank FBO inference (R101-I3D LFB-NL-3L, T 32, crop 256, 4 boxes a
    clip) down a descending batch ladder: the largest batch that fits and
    its rate,
  * the same with ``--bank-dtype bfloat16`` (half the bank's bytes),
  * ``--sharded``: ``TPU.BANK_SHARDED`` (``shard_bank``) in a process group
    over the local cards (one NCCL rank on a one-card host),
  * ``--extract``: the phase-A sweep's rate and the full split's sweep time
    at real keyframe counts,
  * ``--train``: the stage-2 train step (``TPU.REMAT ''``) next to the
    resident bank, down its own ladder.

Usage:
  python -m lfb_tpu_torch.tools.bank_rehearsal [--dataset ava|charades]
      [--bank-dtype float32,bfloat16] [--batches 48,32,16,8]
      [--videos N] [--sharded] [--extract] [--train]
      [--train-batches 8,4] [--iters 10] [--device cuda|cpu]

Prints one JSON report, with the keys of ``tools/bank_rehearsal.py``.  A
rung that runs out of device memory is recorded as ``{'batch': b, 'oom':
True}`` and the ladder goes on down; a rung past its deadline
(``LFB_BENCH_TIMEOUT_S``, 900 s) as ``'stall'``, and the ladder stops.  Any
other exception propagates.  Runs on ``cuda`` unless ``--device cpu`` is
given, and raises without a card.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import logging
import os
import signal
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from lfb_tpu_torch.bank.device_bank import (AVA_NUM_SECS, AVA_SEC_BASE,
                                            build_device_bank, shard_bank)
from lfb_tpu_torch.config import FLAGSHIP_OVERRIDES
from lfb_tpu_torch.core.config import clone, default_config, finalize
from lfb_tpu_torch.models.model import frozen_param_names, init_params
from lfb_tpu_torch.models.spec import build_spec
from lfb_tpu_torch.parallel import launch, mesh
from lfb_tpu_torch.train import optimizer as opt
from lfb_tpu_torch.train.steps import (make_eval_step, make_train_step,
                                       split_params)

logger = logging.getLogger('bank_rehearsal')

GB = float(2 ** 30)
MiB = 2 ** 20
PHASE_TIMEOUT_S = int(os.environ.get('LFB_BENCH_TIMEOUT_S', '900'))

# The keys that ``__graft_entry__._flagship_cfg`` (the JAX tool's model) sets,
# with the values of ``config.FLAGSHIP_OVERRIDES``; the released YAML's other
# settings there (the training dropout, the residual branches' zero gamma,
# the solver, ``TPU.REMAT ''``) stay at their defaults, as in the JAX tool.
ENTRY_KEYS = ('DATASET', 'MODEL.MODEL_NAME', 'MODEL.NUM_CLASSES',
              'MODEL.DEPTH', 'MODEL.VIDEO_ARC_CHOICE', 'MODEL.MULTI_LABEL',
              'MODEL.USE_AFFINE', 'NONLOCAL.USE_BN', 'NONLOCAL.USE_AFFINE',
              'NONLOCAL.USE_ZERO_INIT_CONV', 'LFB.ENABLED', 'LFB.FBO_TYPE',
              'FBO_NL.NUM_LAYERS', 'SOLVER.WEIGHT_DECAY',
              'SOLVER.WEIGHT_DECAY_BN', 'LFB.WINDOW_SIZE')

_OOM_MARKS = ('out of memory', 'CUDNN_STATUS_ALLOC_FAILED',
              'CUBLAS_STATUS_ALLOC_FAILED')


def synthesize_ava_host_bank(num_videos: int, seed: int = 0,
                             fast_fill: bool = False):
    """AVA-realistic host bank: {video: {sec: [feat, ...]}}.

    Real AVA train banks hold detector-box features for ~235 videos over
    seconds 902..1798, about 2 person boxes a second with crowded-scene
    outliers.  Count model: Poisson(2) clipped to 25 (25 exercises the auto
    ``k_store`` table sizing), features ReLU-like half-normals: ~420k x 2048
    f32 ~= 3.2 GiB, the published bank size.  The draws of the JAX tool, in
    its order, so a seed gives the same bank bit for bit; the half-normals
    are formed in place (one copy of the features in host memory).

    ``fast_fill`` tiles one 4096-row random block instead of drawing every
    row: the same shapes and bytes, repeated content.
    """
    rng = np.random.default_rng(seed)
    counts = rng.poisson(2.0, size=(num_videos, AVA_NUM_SECS)).clip(0, 25)
    total = int(counts.sum())
    t0 = time.perf_counter()
    if fast_fill:
        block = _half_normals(rng, 4096)
        feats = np.tile(block, (-(-total // 4096), 1))[:total]
    else:
        feats = _half_normals(rng, total)
    bank = {}
    pos = 0
    for v in range(num_videos):
        secs = {}
        for si in np.nonzero(counts[v])[0]:
            n = int(counts[v, si])
            secs[int(si) + AVA_SEC_BASE] = list(feats[pos:pos + n])
            pos += n
        bank[v] = secs
    logger.info('synthesized AVA host bank: %d videos, %d feats (%.2f GiB '
                'f32) in %.1fs', num_videos, total, total * 2048 * 4 / GB,
                time.perf_counter() - t0)
    return bank, total


def synthesize_charades_host_bank(num_videos: int, seed: int = 0):
    """Charades-realistic host bank: {video: {frame: feat}}.

    Real Charades banks are 4.4 GB over ~9.8k train videos, one 2048-d
    feature per LFB clip (every FPS/2 = 12 frames, ~30 s average video ->
    ~60 entries a video), and video 0 holds 600 (the outlier that sets the
    index tables' width).  The JAX tool's draws, in its order.
    """
    rng = np.random.default_rng(seed)
    per_video = rng.integers(20, 90, size=num_videos)   # ~55 avg -> ~4.1 GiB
    per_video[0] = 600   # one outlier-length video (the table-sizing case)
    total = int(per_video.sum())
    feats = _half_normals(rng, total)
    bank = {}
    pos = 0
    for v in range(num_videos):
        n = int(per_video[v])
        bank[v] = {int(12 * (j + 1)): feats[pos + j] for j in range(n)}
        pos += n
    logger.info('synthesized Charades host bank: %d videos, %d feats '
                '(%.2f GiB f32)', num_videos, total, total * 2048 * 4 / GB)
    return bank, total


def _half_normals(rng, rows: int) -> np.ndarray:
    """``np.abs(rng.standard_normal((rows, 2048), f32)) * 0.5``, in place:
    the same bits, one array."""
    x = rng.standard_normal((rows, 2048), np.float32)
    np.abs(x, out=x)
    x *= 0.5
    return x


def _sync(device) -> None:
    if torch.device(device).type == 'cuda':
        torch.cuda.synchronize(device)


def _allocated(device) -> int:
    """Bytes the caching allocator holds in tensors on ``device`` (0 on the
    CPU)."""
    if torch.device(device).type != 'cuda':
        return 0
    return torch.cuda.memory_allocated(device)


def _release(device) -> None:
    """Free what nothing references any more, and the allocator's cached
    blocks, so the next rung starts from the memory the last one found."""
    gc.collect()
    if torch.device(device).type == 'cuda':
        torch.cuda.empty_cache()


def build_device_bank_timed(cfg, host_bank, device='cuda'):
    """``build_device_bank`` with its time, bytes and peak memory: (bank,
    {'build_s', 'feat_gb', 'index_mib', 'table_width'}).  The index tables'
    bytes are the port's (int64 row ids and counts, 8 bytes an entry: twice
    the JAX tool's 4-byte figure for the same tables)."""
    cuda = torch.device(device).type == 'cuda'
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    base = _allocated(device)
    t0 = time.perf_counter()
    with phase_deadline('bank build/transfer'):
        bank = build_device_bank(cfg, host_bank, device=device)
        _sync(device)
    dt = time.perf_counter() - t0
    feat_gb = bank.feats.numel() * bank.feats.element_size() / GB
    if hasattr(bank, 'table'):
        tables = (bank.table, bank.counts)
    else:
        tables = (bank.frame_ids, bank.rows)
    idx_bytes = sum(t.numel() * t.element_size() for t in tables)
    k_store = tables[0].shape[-1]
    peak = (torch.cuda.max_memory_allocated(device) - base) / GB if cuda \
        else float('nan')
    logger.info('device bank built+resident in %.1fs: feats %s %s = %.2f GiB '
                '(%.0f MiB/s into device memory), index tables %.1f MiB '
                '(%s, %d bytes an entry) (width %d); peak %.2f GiB allocated '
                'during the build', dt, tuple(bank.feats.shape),
                str(bank.feats.dtype).split('.')[-1], feat_gb,
                feat_gb * 1024 / max(dt, 1e-9), idx_bytes / MiB,
                str(tables[0].dtype).split('.')[-1],
                tables[0].element_size(), k_store, peak)
    return bank, {'build_s': round(dt, 1), 'feat_gb': round(feat_gb, 2),
                  'index_mib': round(idx_bytes / MiB, 1),
                  'table_width': k_store}


def flagship_cfg(dataset: str, bank_dtype: str, sharded: bool):
    """The JAX tool's config, key for key: the flagship keys of
    ``ENTRY_KEYS``, finalized, then the device bank (and its row-sharding),
    and for Charades the same model over 157 classes and a 20-row window
    of a bank with 2 clips a second of 24 fps video."""
    cfg = default_config()
    for key in ENTRY_KEYS:
        node = cfg
        *parents, leaf = key.split('.')
        for part in parents:
            node = node[part]
        node[leaf] = FLAGSHIP_OVERRIDES[key]
    over = {'TPU.DEVICE_BANK': True, 'TPU.BANK_DTYPE': bank_dtype}
    if sharded:
        over.update({'TPU.SHARD_MAP': True, 'TPU.BANK_SHARDED': True})
    cfg = clone(finalize(cfg), over)
    if dataset == 'charades':
        cfg = clone(cfg, {
            'DATASET': 'charades', 'MODEL.NUM_CLASSES': 157,
            'LFB.WINDOW_SIZE': 20, 'CHARADES.FPS': 24,
            'CHARADES.LFB_CLIPS_PER_SECOND': 2})
    return cfg


# The last draws of clip data, by (seed, clip shape): the f32 clips and the
# generator's state after each clip.  A descending ladder asks for fewer
# clips of the same draws at every rung, and the datasets' batches share
# them; the legacy generator gives the same numbers however its draws are
# split, so a slice of the cache is the draw itself.
_CLIP_DRAWS: Dict[tuple, tuple] = {}


def _clips(seed: int, n: int, shape: tuple):
    """(``RandomState(seed).randn(n, *shape).astype(float32)``, that
    generator after the draw), drawn a clip at a time."""
    key = (seed, shape)
    if key not in _CLIP_DRAWS or _CLIP_DRAWS[key][0].shape[0] < n:
        rng = np.random.RandomState(seed)
        data = np.empty((n,) + shape, np.float32)
        states = [rng.get_state()]
        for clip in data:
            clip[...] = rng.randn(*shape)
            states.append(rng.get_state())
        _CLIP_DRAWS[key] = (data, states)
    data, states = _CLIP_DRAWS[key]
    rng = np.random.RandomState()
    rng.set_state(states[n])
    return data[:n], rng


def forget_draws() -> None:
    """Drop the cached clip draws (host memory: up to a batch of clips)."""
    _CLIP_DRAWS.clear()


def _put(array, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(array)).to(device)


def _proposals(rng, clips: int, crop: int, boxes_per_clip: int = 4):
    n = clips * boxes_per_clip
    return np.stack([
        np.repeat(np.arange(clips), boxes_per_clip).astype(np.float32),
        rng.uniform(0, crop / 2, n).astype(np.float32),
        rng.uniform(0, crop / 2, n).astype(np.float32),
        rng.uniform(crop / 2, crop, n).astype(np.float32),
        rng.uniform(crop / 2, crop, n).astype(np.float32)], axis=1)


def make_batch(cfg, spec, batch_clips: int, num_videos: int, seed: int = 0,
               device='cuda') -> Dict[str, torch.Tensor]:
    """Synthetic eval batch on ``device``, the JAX tool's draws bit for bit;
    LFB windows come from the device bank (no 'lfb' blob), keyed by
    metadata (AVA) / center indices (Charades)."""
    t, crop = cfg.TEST.VIDEO_LENGTH, cfg.TEST.CROP_SIZE
    data, rng = _clips(seed, batch_clips, (t, crop, crop, 3))
    batch = {'data': _put(data, device)}
    if cfg.DATASET == 'ava':
        n = batch_clips * 4
        batch['proposals'] = _put(_proposals(rng, batch_clips, crop), device)
        batch['metadata'] = _put(np.stack([
            rng.randint(0, num_videos, n).astype(np.float32),
            rng.randint(902, 1799, n).astype(np.float32),
            np.full(n, 400.0, np.float32),
            np.full(n, 600.0, np.float32)], axis=1), device)
    else:
        batch['lfb_video_idx'] = _put(
            rng.randint(0, num_videos, batch_clips).astype(np.int32), device)
        batch['lfb_center'] = _put(
            rng.randint(24, 24 * 60, batch_clips).astype(np.int32), device)
    return batch


def make_train_batch(cfg, batch_clips: int, num_videos: int,
                     device='cuda') -> Dict[str, torch.Tensor]:
    """The train ladder's batch (``tools/bank_rehearsal.py:306-330``):
    :func:`make_batch`'s, with train-sized data and AVA proposals from
    ``RandomState(0)``, per-box rows (AVA) or one row a clip (Charades),
    and labels."""
    batch = make_batch(cfg, None, batch_clips, num_videos, device=device)
    t, crop = cfg.TRAIN.VIDEO_LENGTH, cfg.TRAIN.CROP_SIZE
    data, rng = _clips(0, batch_clips, (t, crop, crop, 3))
    batch['data'] = _put(0.1 * data, device)
    if cfg.DATASET == 'ava':
        n = batch_clips * 4
        batch['proposals'] = _put(_proposals(rng, batch_clips, crop), device)
        batch['box_mask'] = _put(np.ones(n, np.float32), device)
    else:
        n = batch_clips
    batch['labels'] = _put((rng.rand(n, cfg.MODEL.NUM_CLASSES) > 0.95).astype(
        np.float32), device)
    return batch


@contextlib.contextmanager
def phase_deadline(label: str):
    """Bound one measured phase: past ``PHASE_TIMEOUT_S`` it raises
    ``TimeoutError``, so a stalled phase fails loudly instead of eating the
    whole rehearsal.  (SIGALRM: the main thread only.)"""
    def on_alarm(signum, frame):
        raise TimeoutError('{} exceeded {}s'.format(label, PHASE_TIMEOUT_S))
    prev = signal.signal(signal.SIGALRM, on_alarm)
    signal.alarm(PHASE_TIMEOUT_S)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, prev)


def _is_oom(exc) -> bool:
    """Whether ``exc`` is the card running out of memory: the caching
    allocator's ``torch.OutOfMemoryError``, or a ``RuntimeError`` of an
    allocation that failed in CUDA, cuDNN or cuBLAS."""
    if isinstance(exc, torch.OutOfMemoryError):
        return True
    return isinstance(exc, RuntimeError) and any(
        mark in str(exc) for mark in _OOM_MARKS)


def time_step(step, params, batch, iters: int, device='cuda') -> float:
    """Seconds a call: one warm-up call, then ``iters`` calls, each waited
    for on the device."""
    out = step(params, batch)
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = step(params, batch)
        _sync(device)
    del out
    return (time.perf_counter() - t0) / iters


def _ladder(label: str, batches, rung, device,
            oom_rungs: Optional[List[dict]] = None):
    """``rung(b)`` down ``batches``: a rung's result dict is recorded with
    its batch, and the first that fits ends the ladder.  A rung that runs
    out of memory records ``oom`` and the ladder goes on, after everything
    the rung held is released; ``oom_rungs`` (when given) gets the ladder,
    the batch and the bytes allocated on the device before the rung and
    after its release.  A rung past its deadline records ``stall`` and ends
    the ladder; any other exception propagates."""
    results = []
    for b in batches:
        before = _allocated(device)
        oom = None
        try:
            with phase_deadline('{} B={}'.format(label, b)):
                result = rung(b)
        except TimeoutError as e:
            logger.warning('%s; aborting the %s ladder', e, label)
            results.append({'batch': b, 'stall': True})
            break
        except RuntimeError as e:
            if not _is_oom(e):
                raise
            oom = str(e).split('\n')[0][:400]
        if oom is None:
            results.append({'batch': b, **result})
            break
        # Outside the handler: the exception and its frames, which hold the
        # rung's tensors, are gone.
        _release(device)
        after = _allocated(device)
        logger.info('%s B=%d: OOM (%s); allocated %.1f MiB before the rung, '
                    '%.1f MiB after its release', label, b, oom,
                    before / MiB, after / MiB)
        if oom_rungs is not None:
            oom_rungs.append({'ladder': label, 'batch': b,
                              'allocated_before': before,
                              'allocated_after': after})
        results.append({'batch': b, 'oom': True})
    return results


def _generator(device, seed: int = 0) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def _rank_shard(batch):
    """This rank's shard of a global batch (the batch itself at world 1)."""
    return mesh.shard_batch(batch, mesh.rank(), mesh.world_size())


def run_inference_ladder(cfg, bank, num_videos, batches, iters, sharded,
                         device='cuda', oom_rungs=None):
    """Device-bank FBO inference down the ladder: for the first batch that
    fits, its clips/s and ms per step (the whole group's batch over the
    step's time).  ``oom_rungs``: see :func:`_ladder`."""
    spec = build_spec(cfg, 'test')
    params = init_params(spec, _generator(device))
    if sharded:
        bank = _shard_timed(bank, device)

    def rung(b):
        step = make_eval_step(spec, bank=bank)
        batch = _rank_shard(make_batch(cfg, spec, b, num_videos,
                                       device=device))
        t0 = time.perf_counter()
        dt = time_step(step, params, batch, iters, device)
        first_s = time.perf_counter() - t0 - dt * iters
        cps = b / dt
        logger.info('B=%d: %.1f clips/s (%.0f ms/step, first call %.1fs)',
                    b, cps, dt * 1e3, first_s)
        return {'clips_per_sec': round(cps, 2),
                'ms_per_step': round(dt * 1e3, 1)}

    return _ladder('inference', batches, rung, device, oom_rungs)


def _shard_timed(bank, device):
    """``shard_bank`` in the current group, with its peak memory logged: at
    world 1 the shard is allocated before the whole table is dropped, so
    the bank is held twice for a moment."""
    cuda = torch.device(device).type == 'cuda'
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    base = _allocated(device)
    sharded = shard_bank(bank)
    _sync(device)
    if cuda:
        logger.info('shard_bank over %d rank(s): %d rows here; peak %.2f GiB '
                    'allocated over the %.2f GiB before it', mesh.world_size(),
                    sharded.feats.shape[0],
                    (torch.cuda.max_memory_allocated(device) - base) / GB,
                    base / GB)
    return sharded


def run_train_ladder(cfg, bank, num_videos, batches, iters, sharded=False,
                     device='cuda', oom_rungs=None):
    """FBO-NL training with the real-scale bank resident (the reference's
    stage 2: the bank-attending model trained against a frozen baseline's
    bank): whether the full train step (forward, backward and SGD at the
    train shapes, ``TPU.REMAT ''``) fits next to the bank, and at what
    clips/s.  With ``sharded`` the bank is row-sharded over the group.
    ``oom_rungs``: see :func:`_ladder`."""
    cfg = clone(cfg, {'TPU.REMAT': ''})
    spec = build_spec(cfg, 'train')
    if sharded:
        bank = _shard_timed(bank, device)

    def rung(b):
        params = init_params(spec, _generator(device))
        trainable, frozen = split_params(spec, params)
        mstate = opt.init_state(params, frozen_param_names(spec, params))
        del params
        step = make_train_step(spec, cfg.SOLVER, bank=bank)
        batch = _rank_shard(make_train_batch(cfg, b, num_videos,
                                             device=device))
        state = (trainable, frozen, mstate)
        out = step(*state, batch, _generator(device, 0), 1e-4)
        state = out[:3]
        first = float(out[3]['loss'])
        t0 = time.perf_counter()
        for i in range(iters):
            out = step(*state, batch, _generator(device, i), 1e-4)
            state = out[:3]
        loss = float(out[3]['loss'])
        dt = (time.perf_counter() - t0) / iters
        cps = b / dt
        logger.info('train B=%d with resident bank: %.1f clips/s (%.0f '
                    'ms/step); loss %.4g first, %.4g last', b, cps, dt * 1e3,
                    first, loss)
        return {'clips_per_sec': round(cps, 2),
                'ms_per_step': round(dt * 1e3, 1)}

    return _ladder('train', batches, rung, device, oom_rungs)


def run_extract(cfg, num_videos, batches, iters, device='cuda',
                oom_rungs=None):
    """Phase-A rehearsal: the lfb_infer_only sweep's rate, and the full
    split's sweep time at real AVA keyframe counts (one clip per annotated
    second).  ``oom_rungs``: see :func:`_ladder`."""
    spec = build_spec(cfg, 'test', lfb_infer_only=True)
    params = init_params(spec, _generator(device))
    step = make_eval_step(spec)

    def rung(b):
        batch = make_batch(cfg, spec, b, num_videos, device=device)
        batch.pop('metadata', None)
        dt = time_step(step, params, _rank_shard(batch), iters, device)
        cps = b / dt
        total_clips = num_videos * 897      # every annotated second
        est_min = total_clips / cps / 60.0
        logger.info('extract B=%d: %.1f clips/s; full %d-video split (%d '
                    'clips) ~= %.1f min/sweep', b, cps, num_videos,
                    total_clips, est_min)
        return {'clips_per_sec': round(cps, 2),
                'full_split_min': round(est_min, 1)}

    return _ladder('extract', batches, rung, device, oom_rungs)


def rehearse(args, device) -> dict:
    """The rehearsal of ``args`` (parsed by :func:`main`) on ``device``, in
    whatever process group is current; returns the report."""
    num_videos = args.videos or (235 if args.dataset == 'ava' else 9800)
    batches = [int(b) for b in args.batches.split(',')]
    if args.dataset == 'ava':
        host_bank, total = synthesize_ava_host_bank(num_videos)
    else:
        host_bank, total = synthesize_charades_host_bank(num_videos)

    report = {'dataset': args.dataset, 'videos': num_videos,
              'bank_rows': total, 'sharded': args.sharded, 'runs': []}
    dtypes = args.bank_dtype.split(',')
    for dtype in dtypes:
        cfg = flagship_cfg(args.dataset, dtype, args.sharded)
        bank, build_stats = build_device_bank_timed(cfg, host_bank, device)
        ladder = run_inference_ladder(cfg, bank, num_videos, batches,
                                      args.iters, args.sharded, device)
        run = {'bank_dtype': dtype, **build_stats, 'inference': ladder}
        if args.extract and dtype == dtypes[0]:
            run['extract'] = run_extract(cfg, num_videos, batches, args.iters,
                                         device)
        if args.train and dtype == dtypes[0]:
            run['train'] = run_train_ladder(
                cfg, bank, num_videos,
                [int(b) for b in args.train_batches.split(',')], args.iters,
                sharded=args.sharded, device=device)
        report['runs'].append(run)
        # Free the bank before the next dtype's claims device memory.
        del bank
        _release(device)
    forget_draws()
    return report


def _rehearse_rank(args, cfg, device):
    """``launch.run``'s ``fn`` for ``--sharded`` over several cards."""
    return rehearse(args, device)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(
        description='Real-scale LFB bank rehearsal on the card.')
    p.add_argument('--dataset', default='ava', choices=['ava', 'charades'])
    p.add_argument('--bank-dtype', default='float32,bfloat16')
    p.add_argument('--batches', default='48,32,16,8')
    p.add_argument('--videos', type=int, default=0,
                   help='0 = real scale (235 AVA / 9800 Charades)')
    p.add_argument('--iters', type=int, default=10)
    p.add_argument('--sharded', action='store_true')
    p.add_argument('--extract', action='store_true')
    p.add_argument('--train', action='store_true',
                   help='also rehearse the FBO-NL TRAIN step next to the '
                        'resident bank (descending --train-batches ladder)')
    p.add_argument('--train-batches', default='8,4')
    p.add_argument('--device', default='cuda',
                   help="'cuda' (the default) or 'cpu'")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO, stream=sys.stdout,
                        format='%(asctime)s %(name)s: %(message)s')
    device = torch.device(args.device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError('bank_rehearsal: runs on a CUDA device and none is '
                           'available (--device cpu for the CPU)')
    if not args.sharded:
        launch.full_f32()
        report = rehearse(args, device)
    else:
        world = torch.cuda.device_count() if device.type == 'cuda' else 1
        if world == 1:
            from lfb_tpu_torch.tools.gpu_smoke import one_rank_group
            launch.full_f32()
            with one_rank_group(device):
                report = rehearse(args, device)
        else:
            import functools
            import tempfile
            with tempfile.TemporaryDirectory() as store_dir:
                cfg = clone(flagship_cfg(args.dataset, 'float32', True), {
                    'NUM_GPUS': world, 'TRAIN.BATCH_SIZE': world,
                    'TEST.BATCH_SIZE': world, 'CHECKPOINT.DIR': store_dir})
                report = launch.run(functools.partial(_rehearse_rank, args),
                                    cfg, device)
    print(json.dumps(report))
    return report


if __name__ == '__main__':
    main()

"""Start the ranks of a data-parallel run (the command lines' launcher).

:func:`run` calls ``fn(cfg, device)`` once per rank and returns rank 0's
result:

* under ``torchrun`` (``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``,
  ``MASTER_ADDR`` and ``MASTER_PORT`` in the environment) this process
  joins that group and is one rank;
* otherwise the world is :func:`data_parallel_world` of the config: with
  one rank ``fn`` runs in this process with no group, exactly as a
  single-device run; with more, ``torch.multiprocessing`` spawns one
  worker per rank, which meet over a ``FileStore`` in ``CHECKPOINT.DIR``.  On ``cuda`` the kernels are built
  here first, so the workers load one build.

Every process that runs a rank turns TF32 off (:func:`full_f32`) before it
calls ``fn``: PyTorch leaves it on for cuDNN convolutions, and under
``TPU.COMPUTE_DTYPE float32`` the port is held to ``lfb_tpu`` in full f32.
The flags belong to a process, so a spawned rank sets its own.

Rank 0 logs at INFO on stdout; the other ranks log warnings only.
"""

from __future__ import annotations

import logging
import os
import queue
import sys
import tempfile

import torch

from lfb_tpu_torch.parallel import mesh

FORMAT = '[%(levelname)s: %(filename)s: %(lineno)4d]: %(message)s'
logger = logging.getLogger(__name__)


def data_parallel_world(cfg, device) -> int:
    """The ranks a run of ``cfg`` on ``device`` takes (``lfb_tpu``'s rule,
    ``trainer.py:58-60`` and ``bank/lfb.py:124-132``): ``NUM_GPUS``, at
    most the cards present on ``cuda``, then down to the largest count that
    divides both batch sizes.  Raises on ``cuda`` without a card."""
    device = torch.device(device)
    n = cfg.NUM_GPUS
    if device.type == 'cuda':
        cards = torch.cuda.device_count()
        if cards < 1:
            raise RuntimeError('data_parallel_world: no CUDA device')
        n = min(n, cards)
    while n > 1 and (cfg.TRAIN.BATCH_SIZE % n or cfg.TEST.BATCH_SIZE % n):
        n -= 1
    if n != cfg.NUM_GPUS:
        logger.info('NUM_GPUS %d: running on %d %s rank(s)', cfg.NUM_GPUS, n,
                    device.type)
    return n


def full_f32(rank: int = 0) -> None:
    """Turn TF32 off in this process, for matmuls and for cuDNN
    convolutions, and log both flags for ``rank``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    logger.info('rank %d: torch.backends.cuda.matmul.allow_tf32 %s, '
                'torch.backends.cudnn.allow_tf32 %s', rank,
                torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32)


def _log_as(rank: int) -> None:
    logging.basicConfig(level=logging.INFO if rank == 0 else logging.WARNING,
                        format=FORMAT, stream=sys.stdout, force=True)


def _in_group(fn, cfg, device, world, rank, init_method, local_rank):
    """``fn(cfg, device)`` as rank ``rank`` of ``world``; leaves the group
    after."""
    full_f32(rank)
    device = mesh.init_distributed(device, world=world, rank=rank,
                                   init_method=init_method,
                                   local_rank=local_rank)
    try:
        return fn(cfg, device)
    finally:
        torch.distributed.destroy_process_group()


def _worker(rank, fn, cfg, device, world, init_method, results):
    _log_as(rank)
    if device == 'cpu':
        # The ranks share the host's cores; more intra-op threads than
        # their share spin against each other.
        torch.set_num_threads(max(1, torch.get_num_threads() // world))
    out = _in_group(fn, cfg, device, world, rank, init_method, rank)
    if rank == 0:
        results.put(out)


def run(fn, cfg, device):
    """``fn(cfg, device)`` on every rank of the run; rank 0's result (None
    in the other ranks of a ``torchrun`` group)."""
    env = os.environ
    if 'WORLD_SIZE' in env:
        rank = int(env['RANK'])
        _log_as(rank)
        return _in_group(fn, cfg, device, int(env['WORLD_SIZE']), rank,
                         'env://', int(env.get('LOCAL_RANK', 0)))
    world = data_parallel_world(cfg, device)
    if world == 1:
        full_f32()
        return fn(cfg, device)
    if torch.device(device).type == 'cuda':
        from lfb_tpu_torch.ops import cuda_build
        cuda_build.library()
    out_dir = cfg.CHECKPOINT.DIR or '.'
    os.makedirs(out_dir, exist_ok=True)
    fd, store = tempfile.mkstemp(prefix='.dist_store_', dir=out_dir)
    os.close(fd)
    logger.info('Spawning %d ranks on %s', world, device)
    ctx = torch.multiprocessing.get_context('spawn')
    results = ctx.Queue()
    try:
        procs = torch.multiprocessing.start_processes(
            _worker, args=(fn, cfg, str(device), world,
                           'file://' + os.path.abspath(store), results),
            nprocs=world, join=False, start_method='spawn')
        # Read rank 0's result while the workers run (a large result would
        # otherwise block its writer), and raise as soon as one fails.
        while True:
            try:
                out = results.get(timeout=1.0)
                break
            except queue.Empty:
                if procs.join(timeout=0):
                    raise RuntimeError('the ranks ended without a result')
        while not procs.join():
            pass
        return out
    finally:
        if os.path.exists(store):
            os.remove(store)

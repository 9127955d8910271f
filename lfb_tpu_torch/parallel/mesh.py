"""Data parallelism over ``torch.distributed`` (port of
``lfb_tpu/parallel/mesh.py``).

``lfb_tpu`` runs one program over a 1-D device mesh: the batch is sharded
over the ``data`` axis, parameters are replicated, and the shard_map step
``psum``s the loss parts and gradients.  The port runs one process per
device instead, in the default process group: rank r holds clips
``[r*b, (r+1)*b)`` of the global batch (b = B / world) and their
clip-aligned box rows, the shard that ``P('data')`` gives device r, and the
steps exchange what the mesh exchanged with collectives
(:func:`all_sum`, :func:`gather_rows`).  Without a process group every
helper here is the identity, so one process runs exactly as before.

Nothing in the package creates a group on its own: the command lines do,
through :mod:`lfb_tpu_torch.parallel.launch` and :func:`init_distributed`,
and tests create theirs.  A collective never goes through the host: on
``cuda`` the group is NCCL's, on the CPU gloo's.
"""

from __future__ import annotations

import logging
from typing import Dict, Iterable, Mapping

import numpy as np
import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)


def distributed() -> bool:
    """Whether a default process group exists (the steps then exchange
    their loss parts, gradients and outputs over it)."""
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    """Ranks in the default process group; 1 without one."""
    return dist.get_world_size() if distributed() else 1


def rank() -> int:
    """This process's rank in the default process group; 0 without one."""
    return dist.get_rank() if distributed() else 0


def init_distributed(device, *, world: int, rank: int, init_method: str,
                     local_rank: int = 0) -> torch.device:
    """Join the default process group: NCCL on ``cuda`` (this process then
    owns ``cuda:local_rank``), gloo on the CPU.  Returns the device of the
    rank.  A failed NCCL init raises; nothing falls back to gloo or to one
    process."""
    device = torch.device(device)
    if device.type == 'cuda':
        device = torch.device('cuda', local_rank)
        torch.cuda.set_device(device)
        dist.init_process_group('nccl', init_method=init_method,
                                world_size=world, rank=rank,
                                device_id=device)
    elif device.type == 'cpu':
        dist.init_process_group('gloo', init_method=init_method,
                                world_size=world, rank=rank)
    else:
        raise ValueError('init_distributed: no backend for device '
                         '{}'.format(device))
    logger.info('rank %d of %d on %s (%s)', rank, world, device,
                dist.get_backend())
    return device


def shard_batch(batch: Mapping, rank: int, world: int) -> Dict:
    """Rank ``rank``'s shard of a global batch: every blob's leading axis
    cut into ``world`` equal parts, the part ``P('data')`` gives device
    ``rank`` of ``lfb_tpu``'s mesh.  The clip blobs give clips
    ``[r*b, (r+1)*b)``; AVA's box blobs are clip-aligned (clip c owns rows
    ``[c*MAX_BOXES, (c+1)*MAX_BOXES)``), so they give those clips' rows.
    The proposals keep their global clip indices; the steps localise them
    (``train/steps.py:_localize_proposals``)."""
    out = {}
    for name, value in batch.items():
        n = value.shape[0]
        if n % world:
            raise ValueError('shard_batch: {} has {} rows, not a multiple of '
                             '{} ranks'.format(name, n, world))
        part = n // world
        out[name] = value[rank * part:(rank + 1) * part]
    return out


def all_sum(tensor: torch.Tensor) -> torch.Tensor:
    """``tensor`` summed over the ranks (in place); itself without a
    group."""
    if distributed():
        dist.all_reduce(tensor)
    return tensor


def all_max(tensor: torch.Tensor) -> torch.Tensor:
    """``tensor``'s elementwise maximum over the ranks (in place)."""
    if distributed():
        dist.all_reduce(tensor, op=dist.ReduceOp.MAX)
    return tensor


def all_sum_flat(tensors: Iterable[torch.Tensor]) -> None:
    """Sum each tensor over the ranks in place, with one all-reduce of one
    flat buffer per dtype."""
    if not distributed():
        return
    by_dtype: Dict[torch.dtype, list] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in group])
        dist.all_reduce(flat)
        for t, part in zip(group, flat.split([t.numel() for t in group])):
            t.copy_(part.view_as(t))


def gather_rows(value):
    """The ranks' ``value`` tensors (equal shapes) stacked along the leading
    axis in rank order: the global batch's order.  ``value`` itself without
    a group."""
    if not distributed():
        return value
    out = value.new_empty((world_size() * value.shape[0],)
                          + tuple(value.shape[1:]))
    dist.all_gather_into_tensor(out, value.contiguous())
    return out


def gather_host(batch: Mapping[str, torch.Tensor], keys) -> Dict:
    """The blobs ``keys`` of a rank's device batch (those it has), gathered
    over the ranks into the global batch's order, as numpy arrays."""
    return {k: gather_rows(batch[k]).cpu().numpy() for k in keys
            if k in batch}


def barrier() -> None:
    """Wait for every rank (nothing without a group)."""
    if distributed():
        dist.barrier()


def step_seed(seed: int) -> int:
    """The seed of this rank's generator for a step whose seed is ``seed``:
    rank 0 draws as one process does, rank r > 0 from ``(seed, r)`` mixed
    by numpy's ``SeedSequence``, so every rank draws its own bank windows
    and dropout masks (``lfb_tpu`` folds the axis index into the step's
    key, ``steps.py:137``) and a run is reproducible at a given world
    size."""
    r = rank()
    if r == 0:
        return seed
    return int(np.random.SeedSequence((seed, r)).generate_state(
        1, np.uint64)[0] >> np.uint64(1))


def check_same(tensors: Mapping[str, torch.Tensor], label: str) -> None:
    """Raise unless every rank holds bitwise the same ``tensors``: each
    tensor's float64 sum and sum of squares, taken on every rank, against
    rank 0's (broadcast)."""
    if not distributed():
        return
    names = sorted(tensors)
    local = torch.stack([torch.stack([tensors[k].double().sum(),
                                      tensors[k].double().square().sum()])
                         for k in names])
    ref = local.clone()
    dist.broadcast(ref, 0)
    if not torch.equal(local, ref):
        bad = [k for k, a, b in zip(names, local, ref) if not torch.equal(a, b)]
        raise RuntimeError('rank {}: {} differ from rank 0\'s: {}'.format(
            rank(), label, bad[:5]))

"""Host input pipeline: ordered multi-threaded minibatch prefetch, and the
copy of each batch to the card (port of ``lfb_tpu/data/loader.py``).

The reference pipes minibatches through 4 loader threads x 12-process pools
into per-GPU Caffe2 BlobsQueues with an out-of-order re-assembly buffer
(``lib/datasets/dataloader.py``).  As in ``lfb_tpu``, this collapses to a
thread pool that builds fixed-shape numpy batches ahead of time (cv2
releases the GIL for decode/resize) and an ordered prefetch window; in place
of ``lfb_tpu``'s ``parallel.shard_batch``, :func:`to_device` copies a batch
to one device.  :class:`DeviceFeed` runs that loop for a sweep and times
its host and card sides.

Determinism: batch ``i`` of epoch stream ``seed`` uses
``np.random.default_rng((seed, i))`` -- no global RNG.
"""

from __future__ import annotations

import logging
import math
import statistics
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List, Mapping, Optional, Tuple

import numpy as np
import torch

logger = logging.getLogger(__name__)

# The summary of every sweep a DeviceFeed finished, in order, its label
# under 'label'; a caller that times sweeps clears it first.
SWEEPS: List[dict] = []


def get_input_db(cfg, split: str, *, lfb_infer_only: bool = False,
                 shift: Optional[int] = None, lfb=None,
                 get_train_lfb: bool = False, device='cuda'):
    """Dataset factory (reference ``dataloader.py:402-413``); ``device``
    holds the bank under ``TPU.DEVICE_BANK``."""
    from lfb_tpu_torch.data.ava import AvaDataset
    from lfb_tpu_torch.data.charades import CharadesDataset
    from lfb_tpu_torch.data.epic import EpicDataset
    db_map = {'ava': AvaDataset, 'charades': CharadesDataset,
              'epic': EpicDataset}
    assert cfg.DATASET in db_map, 'Unknown dataset {}'.format(cfg.DATASET)
    return db_map[cfg.DATASET](cfg, split, lfb_infer_only=lfb_infer_only,
                               shift=shift, lfb=lfb,
                               get_train_lfb=get_train_lfb, device=device)


def to_device(batch: Mapping[str, np.ndarray],
              device) -> Dict[str, torch.Tensor]:
    """The numpy blobs of ``batch`` as tensors on ``device``.  On a CUDA
    device each blob is copied into pinned host memory and from there with
    ``non_blocking=True``; on the CPU the tensors share the arrays'
    memory."""
    device = torch.device(device)
    out = {}
    for name, value in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(value))
        if device.type != 'cpu':
            t = t.pin_memory().to(device, non_blocking=True)
        out[name] = t
    return out


class DataLoader:
    """Ordered prefetching loader over a dataset DB."""

    def __init__(self, db, batch_size: int, *, num_workers: int = 8,
                 prefetch: int = 4, seed: int = 0, is_train: bool = False):
        self.db = db
        self.batch_size = batch_size
        self.num_workers = max(1, num_workers)
        self.prefetch = max(1, prefetch)
        self.seed = seed
        self.is_train = is_train
        self._pool: Optional[ThreadPoolExecutor] = None
        # Per batch yielded by batches(): the seconds minibatch() took on its
        # thread, and the seconds the consumer waited for it.
        self.build_s: List[float] = []
        self.wait_s: List[float] = []

    # ------------------------------------------------------------------ #

    def num_batches(self) -> int:
        """Batches per epoch/sweep (test covers the DB, padded final batch,
        reference ``misc.get_total_test_iters``)."""
        return int(math.ceil(self.db.db_size() / float(self.batch_size)))

    def _batch_indices(self, batch_idx: int) -> List[int]:
        size = self.db.db_size()
        if self.is_train:
            # Epoch-shuffled traversal, stateless: batch i covers positions
            # [i*B, i*B+B) of the permutation for epoch i*B//size (matches
            # the reference's per-epoch index shuffle, dataloader.py:180-221;
            # AVA/EPIC resample uniformly inside minibatch and ignore these,
            # Charades consumes them directly).
            B = self.batch_size
            out = []
            pos = batch_idx * B
            while len(out) < B:
                epoch, offset = divmod(pos + len(out), max(size, 1))
                perm = np.random.default_rng(
                    (self.seed, 999983, epoch)).permutation(size)
                take = min(B - len(out), size - offset)
                out.extend(int(i) for i in perm[offset:offset + take])
            return out
        start = (batch_idx * self.batch_size) % (
            self.num_batches() * self.batch_size)
        idx = [min(start + i, size - 1) for i in range(self.batch_size)]
        # Pad past-the-end entries with the chunk's first index (reference
        # pads with indices[0], ``ava.py:203-204``).
        idx = [i if (start + k) < size else idx[0]
               for k, i in enumerate(idx)]
        return idx

    def _build(self, batch_idx: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed, batch_idx))
        return self.db.minibatch(self._batch_indices(batch_idx), rng)

    def _timed_build(self, batch_idx: int
                     ) -> Tuple[Dict[str, np.ndarray], float]:
        t0 = time.perf_counter()
        batch = self._build(batch_idx)
        return batch, time.perf_counter() - t0

    # ------------------------------------------------------------------ #

    def start(self):
        if self._pool is None:
            self._pool = ThreadPoolExecutor(
                max_workers=self.num_workers,
                thread_name_prefix='lfb-loader')
        return self

    def shutdown(self):
        if self._pool is not None:
            self._pool.shutdown(wait=False, cancel_futures=True)
            self._pool = None

    def batches(self, num_batches: Optional[int] = None,
                start_batch: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        """Yield batches in order with a prefetch window, recording each
        one's build and wait seconds in ``build_s`` / ``wait_s``."""
        self.start()
        self.build_s, self.wait_s = [], []
        total = num_batches if num_batches is not None else self.num_batches()
        pending = {}
        next_submit = start_batch
        next_yield = start_batch
        end = start_batch + total
        while next_yield < end:
            while next_submit < min(next_yield + self.prefetch, end):
                pending[next_submit] = self._pool.submit(
                    self._timed_build, next_submit)
                next_submit += 1
            fut = pending.pop(next_yield)
            t0 = time.perf_counter()
            batch, build_s = fut.result()
            self.wait_s.append(time.perf_counter() - t0)
            self.build_s.append(build_s)
            yield batch
            next_yield += 1


class DeviceFeed:
    """A sweep's batches as (numpy batch, the same batch on ``device``)
    pairs, timed.

    Per batch it records the loader's build on its thread (decode and
    transforms), the seconds the sweep waited for the batch, those of
    :func:`to_device`, and the wall time from the end of one batch's work to
    the end of the next's.  On a CUDA device it also records a CUDA event
    after the batch's copies are enqueued and one when the consumer asks for
    the next batch: the card's time between them is its time for the step
    (launch gaps included).  At the end of the sweep, ``summary`` holds the
    means over the batches after the first, the whole sweep's seconds and
    clips/s, first batch included, and under ``steady`` the means over the
    batches after the first prefetch window (None when the sweep is no
    longer than the window): those the loader began only once the sweep had
    taken a batch, so their wait is the loader's rate against the card's.
    It is logged and appended to :data:`SWEEPS`."""

    def __init__(self, loader: DataLoader, device, label: str):
        self.loader = loader
        self.device = torch.device(device)
        self.label = label
        self.summary: Optional[dict] = None

    def __iter__(self) -> Iterator[Tuple[Dict[str, np.ndarray],
                                         Dict[str, torch.Tensor]]]:
        cuda = self.device.type == 'cuda'
        rows, events = [], []
        t_start = t_prev = time.perf_counter()
        for batch in self.loader.batches():
            t0 = time.perf_counter()
            dev = to_device(batch, self.device)
            to_device_s = time.perf_counter() - t0
            if cuda:
                start = torch.cuda.Event(enable_timing=True)
                start.record()
            yield batch, dev
            if cuda:
                end = torch.cuda.Event(enable_timing=True)
                end.record()
                events.append((start, end))
            t_end = time.perf_counter()
            rows.append({'build_ms': 1e3 * self.loader.build_s[-1],
                         'wait_ms': 1e3 * self.loader.wait_s[-1],
                         'to_device_ms': 1e3 * to_device_s,
                         'wall_ms': 1e3 * (t_end - t_prev)})
            t_prev = t_end
        if cuda:
            torch.cuda.synchronize(self.device)
            for row, (start, end) in zip(rows, events):
                row['card_ms'] = start.elapsed_time(end)
        self.summary = self._summarize(rows, t_prev - t_start)
        logger.info('%s: %s', self.label, ', '.join(
            '{} {}'.format(k, v) for k, v in self.summary.items()))
        SWEEPS.append(dict(self.summary, label=self.label))

    def _summarize(self, rows: List[dict], sweep_s: float) -> dict:
        window = self.loader.prefetch
        return {**self._means(rows[1:] or rows),
                'batches': len(rows),
                'first_ms': rows[0]['wall_ms'] if rows else None,
                'sweep_s': sweep_s,
                'sweep_clips_per_s': (len(rows) * self.loader.batch_size
                                      / sweep_s if sweep_s else None),
                'steady': (self._means(rows[window:])
                           if len(rows) > window else None)}

    def _means(self, rows: List[dict]) -> dict:
        out = {'batches': len(rows)}
        for key in ('wall_ms', 'build_ms', 'wait_ms', 'to_device_ms',
                    'card_ms'):
            vals = [r[key] for r in rows if key in r]
            out[key] = statistics.mean(vals) if vals else None
        out['clips_per_s'] = (self.loader.batch_size / out['wall_ms'] * 1e3
                              if out['wall_ms'] else None)
        out['card_busy'] = (out['card_ms'] / out['wall_ms']
                            if out['card_ms'] is not None and out['wall_ms']
                            else None)
        return out

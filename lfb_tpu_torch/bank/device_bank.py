"""Device-resident AVA long-term feature bank with on-device window gather
(port of ``lfb_tpu/bank/device_bank.py``: ``AvaDeviceBank`` and the AVA
branch of ``build_device_bank``).

The reference ships each example's bank window through the input pipeline
as a host-assembled (W*K, 2048) blob (``lib/datasets/ava.py:300-323``).
Here the whole bank lives in device memory once and each step gathers its
windows on the device from (video_idx, sec) pairs with index ops.
"""

from __future__ import annotations

import logging
from typing import Dict

import numpy as np
import torch

logger = logging.getLogger(__name__)

AVA_SEC_BASE = 902
AVA_NUM_SECS = 897  # seconds 902..1798

_DTYPES = {'float32': torch.float32, 'bfloat16': torch.bfloat16}


class AvaDeviceBank:
    """Packed AVA bank: flat features + (video, sec, slot) index table."""

    def __init__(self, feats: torch.Tensor, table: torch.Tensor,
                 counts: torch.Tensor, *, window_size: int, k: int):
        self.feats = feats          # (R+1, D); row R is the zero row
        self.zero_idx = feats.shape[0] - 1
        self.table = table          # (V, AVA_NUM_SECS, K_store) row ids, int64
        self.counts = counts        # (V, AVA_NUM_SECS) valid slots, int64
        self.window_size = window_size
        self.k = k

    @classmethod
    def build(cls, host_bank: Dict[int, Dict[int, list]], *, window_size: int,
              k: int, lfb_dim: int = 2048, k_store: int = 0,
              dtype: torch.dtype = torch.float32,
              device: torch.device | str = 'cpu') -> 'AvaDeviceBank':
        """Same rows, table and counts as ``lfb_tpu``'s
        ``AvaDeviceBank.build`` (row ids in host-bank iteration order; the
        same seeded subsampling over an explicit ``k_store`` cap), filled
        per (video, sec) entry instead of per row and stacked once."""
        num_videos = max(host_bank.keys()) + 1 if host_bank else 0
        if k_store <= 0:
            k_store = max([k] + [len(f) for secs in host_bank.values()
                                 for f in secs.values()])
            logger.info('AvaDeviceBank: auto k_store=%d; index table %d x %d '
                        'x %d', k_store, num_videos, AVA_NUM_SECS, k_store)
        rows = []
        table = np.full((num_videos, AVA_NUM_SECS, k_store), -1, np.int64)
        counts = np.zeros((num_videos, AVA_NUM_SECS), np.int64)
        truncated = 0
        sub_rng = np.random.default_rng(20190607)  # as lfb_tpu: same subsets
        for video, secs in host_bank.items():
            for sec, feats in secs.items():
                si = sec - AVA_SEC_BASE
                if not 0 <= si < AVA_NUM_SECS:
                    continue
                if len(feats) > k_store:
                    truncated += 1
                    keep = sub_rng.choice(len(feats), k_store, replace=False)
                    feats = [feats[i] for i in sorted(keep)]
                n = len(feats)
                counts[video, si] = n
                table[video, si, :n] = np.arange(len(rows), len(rows) + n)
                rows.extend(feats)
        if truncated:
            logger.warning('AvaDeviceBank: %d (video, sec) entries exceeded '
                           'k_store=%d and were uniformly subsampled',
                           truncated, k_store)
        flat = np.empty((len(rows) + 1, lfb_dim), np.float32)
        if rows:
            np.stack(rows, out=flat[:-1])
        flat[-1] = 0.0
        zero_idx = flat.shape[0] - 1
        table = np.where(table < 0, zero_idx, table)
        return cls(torch.from_numpy(flat).to(device=device, dtype=dtype),
                   torch.from_numpy(table).to(device),
                   torch.from_numpy(counts).to(device),
                   window_size=window_size, k=k)

    def choose_rows(self, video_idx: torch.Tensor, sec: torch.Tensor,
                    generator: torch.Generator) -> torch.Tensor:
        """(N,) video ids + (N,) keyframe seconds -> (N, W*K) feature-row
        ids.  Per second, min(count, K) distinct features are drawn
        uniformly into the leading slots; the other slots point at the zero
        row (host ``sample_lfb_window`` semantics)."""
        W, K = self.window_size, self.k
        dev = self.table.device
        k_store = self.table.shape[-1]
        N = video_idx.shape[0]

        lower = sec.to(dev).long() - W // 2 - AVA_SEC_BASE
        sec_idx = lower[:, None] + torch.arange(W, device=dev)
        in_range = (sec_idx >= 0) & (sec_idx < AVA_NUM_SECS)
        sec_c = sec_idx.clamp(0, AVA_NUM_SECS - 1)
        vid = video_idx.to(dev).long()[:, None]
        counts = torch.where(in_range, self.counts[vid, sec_c], 0)    # (N, W)
        slots = self.table[vid, sec_c]                                # (N, W, Ks)

        # Random distinct slots: sort uniforms, invalid slots pushed last.
        u = torch.rand((N, W, k_store), generator=generator, device=dev)
        u = u + (torch.arange(k_store, device=dev) >= counts[..., None]) * 10.0
        order = torch.argsort(u, dim=-1)[..., :K]
        chosen = torch.take_along_dim(slots, order, dim=-1)
        valid = (torch.arange(K, device=dev)
                 < torch.clamp(counts, max=K)[..., None])
        chosen = torch.where(valid, chosen, self.zero_idx)
        return chosen.reshape(N, W * K)

    def gather(self, video_idx: torch.Tensor, sec: torch.Tensor,
               generator: torch.Generator) -> torch.Tensor:
        """(N,) video ids + (N,) keyframe seconds -> (N, W*K, D) windows."""
        return self.feats[self.choose_rows(video_idx, sec, generator)]


def build_device_bank(cfg, host_bank: Dict,
                      device: torch.device | str = 'cpu') -> AvaDeviceBank:
    """Host bank ({video: {sec: [feat]}}, from
    :func:`lfb_tpu_torch.bank.lfb.construct_ava_lfb` or a reference pickle)
    -> the device-resident bank.  ``TPU.BANK_DTYPE`` sets the row dtype."""
    if cfg.DATASET != 'ava':
        raise NotImplementedError('frame-level device banks (Charades, EPIC) '
                                  'are not ported yet')
    return AvaDeviceBank.build(
        host_bank, window_size=cfg.LFB.WINDOW_SIZE,
        k=cfg.AVA.LFB_MAX_NUM_FEAT_PER_STEP, lfb_dim=cfg.LFB.LFB_DIM,
        k_store=cfg.TPU.BANK_K_STORE, dtype=_DTYPES[cfg.TPU.BANK_DTYPE],
        device=device)

"""The resident feature bank of a cell, from the configuration's count
model and the seed.

Only the counts and the index tables are made on the host (numpy, one
vectorized pass); the rows, |N(0, 1)| / 2 as ReLU features, are drawn on
the device in one call, with the zero row last.  The tables are those the
port's device banks hold: AVA a (video, second, slot) table of row ids and
a (video, second) count, the row ids in (video, second) order; the frame
banks a (video, slot) table of frame ids (-1 past the video's rows) and of
row ids.  Empty slots name the zero row.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from gpubench import seeds

AVA_NUM_SECS = 897
AVA_SEC_BASE = 902


class BankData:
    """The bank's rows and tables on the device, and what the batches
    need to know of it on the host."""

    def __init__(self, kind: str, feats: torch.Tensor, tables: Dict,
                 lengths: np.ndarray):
        self.kind = kind
        self.feats = feats                  # (R + 1, D), the zero row last
        self.tables = tables                # device tensors
        self.lengths = lengths              # AVA: none; frames: frames a video
        self.zero = feats.shape[0] - 1

    @property
    def videos(self) -> int:
        first = next(iter(self.tables.values()))
        return first.shape[0]

    def nbytes(self) -> int:
        return self.feats.numel() * self.feats.element_size()


def build(model: dict, count_model: dict, seed: int, device) -> BankData:
    rng = seeds.rng(seed, 'bank_counts')
    dim = model['LFB.LFB_DIM']
    if count_model['kind'] == 'ava':
        counts = rng.poisson(count_model['rows_per_second'], size=(
            count_model['videos'], AVA_NUM_SECS)).clip(
            0, count_model['max_rows_per_second'])
        total = int(counts.sum())
        k_store = max(model['AVA.LFB_MAX_NUM_FEAT_PER_STEP'],
                      int(counts.max()))
        start = np.cumsum(counts.reshape(-1)).reshape(counts.shape) - counts
        slot = np.arange(k_store)
        table = np.where(slot < counts[..., None], start[..., None] + slot,
                         total)
        tables = {'table': table, 'counts': counts}
        lengths = np.zeros(0)
    elif count_model['kind'] == 'frames':
        lo, hi = count_model['rows']
        rows = rng.integers(lo, hi, size=count_model['videos'])
        if 'video0_rows' in count_model:
            rows[0] = count_model['video0_rows']
        total = int(rows.sum())
        width = max(model['LFB.WINDOW_SIZE'], int(rows.max()))
        slot = np.arange(width)
        used = slot < rows[:, None]
        start = np.cumsum(rows) - rows
        frame_ids = np.where(used, count_model['first_frame']
                             + count_model['row_every'] * slot, -1)
        row_ids = np.where(used, start[:, None] + slot, total)
        tables = {'frame_ids': frame_ids, 'rows': row_ids}
        lengths = (count_model['first_frame']
                   + count_model['row_every'] * rows)
    else:
        raise ValueError('unknown bank kind {!r}'.format(count_model['kind']))
    g = torch.Generator(device=device).manual_seed(
        seeds.derive(seed, 'bank_rows'))
    dtype = {'float32': torch.float32,
             'bfloat16': torch.bfloat16}[model['TPU.BANK_DTYPE']]
    feats = torch.randn((total + 1, dim), generator=g, device=device)
    feats.abs_().mul_(0.5)
    feats[-1] = 0.0
    feats = feats.to(dtype)
    tables = {k: torch.from_numpy(np.ascontiguousarray(v, np.int64)).to(device)
              for k, v in tables.items()}
    return BankData(count_model['kind'], feats, tables, lengths)


def port_bank(bank: BankData, model: dict):
    """The port's device bank over the same rows and tables."""
    from lfb_tpu_torch.bank.device_bank import AvaDeviceBank, FrameDeviceBank
    if bank.kind == 'ava':
        return AvaDeviceBank(bank.feats, bank.tables['table'],
                             bank.tables['counts'],
                             window_size=model['LFB.WINDOW_SIZE'],
                             k=model['AVA.LFB_MAX_NUM_FEAT_PER_STEP'])
    return FrameDeviceBank(
        bank.feats, bank.tables['frame_ids'], bank.tables['rows'],
        window_size=model['LFB.WINDOW_SIZE'], window_mode='charades',
        fps=model['CHARADES.FPS'],
        clips_per_second=model['CHARADES.LFB_CLIPS_PER_SECOND'])

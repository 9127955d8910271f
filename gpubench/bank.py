"""The resident feature bank of a cell, from the configuration's count
model and the seed.

Only the counts and the index tables are made on the host (numpy, one
vectorized pass, by the dataset's ``tables``: the tables its port's device
bank holds); the rows, |N(0, 1)| / 2 as ReLU features, are drawn on the
device in one call, with the zero row last.  Empty slots name the zero
row.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from gpubench import seeds


class BankData:
    """The bank's rows and tables on the device, and what the batches
    need to know of it on the host."""

    def __init__(self, feats: torch.Tensor, tables: Dict,
                 lengths: np.ndarray):
        self.feats = feats                  # (R + 1, D), the zero row last
        self.tables = tables                # device tensors
        self.lengths = lengths              # frames a video, where known
        self.zero = feats.shape[0] - 1

    @property
    def videos(self) -> int:
        first = next(iter(self.tables.values()))
        return first.shape[0]

    def nbytes(self) -> int:
        return self.feats.numel() * self.feats.element_size()


def build(dataset, model: dict, count_model: dict, seed: int,
          device) -> BankData:
    """The bank of ``dataset`` (a module of ``datasets/``)."""
    tables, lengths, total = dataset.tables(
        model, count_model, seeds.rng(seed, 'bank_counts'))
    g = torch.Generator(device=device).manual_seed(
        seeds.derive(seed, 'bank_rows'))
    dtype = {'float32': torch.float32,
             'bfloat16': torch.bfloat16}[model['TPU.BANK_DTYPE']]
    feats = torch.randn((total + 1, model['LFB.LFB_DIM']), generator=g,
                        device=device)
    feats.abs_().mul_(0.5)
    feats[-1] = 0.0
    feats = feats.to(dtype)
    tables = {k: torch.from_numpy(np.ascontiguousarray(v, np.int64)).to(device)
              for k, v in tables.items()}
    return BankData(feats, tables, lengths)

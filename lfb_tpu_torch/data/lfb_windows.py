"""Shared host-side bank-window fill (Charades / EPIC-verb; port of
``lfb_tpu/data/lfb_windows.py``).

Both frame-level samplers collect the first WINDOW_SIZE bank features whose
frame id falls in [begin, end], zero-padding the rest (reference
``charades.py:251-276``, ``epic.py:310-331``); only the window arithmetic
differs.  The device-side equivalent lives in
``lfb_tpu_torch.bank.device_bank.FrameDeviceBank``.
"""

from __future__ import annotations

import numpy as np


def fill_window(video_lfb: dict, begin: int, end: int, *, window_size: int,
                lfb_dim: int) -> np.ndarray:
    """(window_size, lfb_dim): first features with frame in [begin, end]."""
    out = np.zeros((window_size, lfb_dim), np.float32)
    k = 0
    for frame_idx in range(begin, end + 1):
        if frame_idx in video_lfb and k < window_size:
            out[k] = video_lfb[frame_idx]
            k += 1
    return out

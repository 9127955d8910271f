"""Checkpoint helpers: the port's own copies of ``read_pkl`` and
``tpu_to_c2`` from ``lfb_tpu/train/checkpoints.py``.

The released reference weights and feature banks are Python-2 pickles
(reference ``lib/utils/checkpoints.py:421-459``); :func:`read_pkl` reads
them.  :func:`tpu_to_c2` carries one ``lfb_tpu`` parameter array into the
Caffe2 layout, which is the port's (``convert.params_from_jax``).
``tests/test_torch_train.py`` holds both to the originals.
"""

from __future__ import annotations

import pickle
import time

import numpy as np


def read_pkl(path: str, retry: int = 10) -> dict:
    """Read a (possibly Python-2) Caffe2 pickle, retrying transient I/O
    failures (reference ``checkpoints.py:133-142,276-284``)."""
    for attempt in range(retry):
        try:
            with open(path, 'rb') as f:
                try:
                    data = pickle.load(f, encoding='latin1')
                except TypeError:  # pragma: no cover (py2-free env)
                    f.seek(0)
                    data = pickle.load(f)
            break
        except (OSError, EOFError) as e:
            if isinstance(e, FileNotFoundError):
                raise
            if attempt == retry - 1:
                raise
            time.sleep(1.0)
    # Normalize bytes keys from py2 pickles.
    def denorm(obj):
        if isinstance(obj, dict):
            return {
                (k.decode() if isinstance(k, bytes) else k): denorm(v)
                for k, v in obj.items()}
        return obj
    return denorm(data)


def tpu_to_c2(name: str, value: np.ndarray) -> np.ndarray:
    """An ``lfb_tpu`` array -> Caffe2 layout: (kT, kH, kW, Cin, Cout) conv
    kernels to (Cout, Cin, kT, kH, kW), (Cin, Cout) FC weights to (Cout, Cin),
    1-D arrays unchanged."""
    value = np.asarray(value, dtype=np.float32)
    if value.ndim == 5:
        return np.ascontiguousarray(np.transpose(value, (4, 3, 0, 1, 2)))
    if value.ndim == 2:
        return np.ascontiguousarray(value.T)
    return value

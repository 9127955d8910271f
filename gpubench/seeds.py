"""Seeds for every draw of a run, derived from ``--seed``.

Each purpose (the weights, the bank, a batch, the window's draws) gets its
own 63-bit seed from ``numpy.random.SeedSequence``, so two draws never
share a stream and any whole number, negative or above 2**63, is a seed.
"""

from __future__ import annotations

import zlib

import numpy as np


def derive(seed: int, purpose: str, index: int = 0) -> int:
    words = (zlib.crc32(purpose.encode()), int(index))
    sequence = np.random.SeedSequence(entropy=int(seed) % 2 ** 64,
                                      spawn_key=words)
    return int(sequence.generate_state(1, np.uint64)[0] >> np.uint64(1))


def rng(seed: int, purpose: str, index: int = 0) -> np.random.Generator:
    return np.random.default_rng(derive(seed, purpose, index))

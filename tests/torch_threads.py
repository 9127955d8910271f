"""A module fixture that gives torch's intra-op threads this pytest worker's
share of the host's cores.

The fast lane runs several xdist workers on one host.  Each torch process
starts as many intra-op threads as there are cores, so the workers' threads
outnumber the cores several times over and spin against each other: a file
that takes 80 s alone took 760 s in the lane.  Import ``worker_threads`` into
a test module to cap its threads for that module (restored afterwards).
"""

import os

import pytest


@pytest.fixture(scope='module', autouse=True)
def worker_threads():
    import torch
    workers = int(os.environ.get('PYTEST_XDIST_WORKER_COUNT', '1'))
    before = torch.get_num_threads()
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // workers))
    yield
    torch.set_num_threads(before)

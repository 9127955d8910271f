"""PROF_DAG (port of ``lfb_tpu/utils/profiling.py``): the reference's
per-op timing of the prof_dag executor (``train_net.py:69-72``) maps to a
``torch.profiler`` trace of the CPU and the card over training steps
``start + 1`` to ``start + 3``, as ``lfb_tpu``'s trainer traces them
(``trainer.py:270-274``), written as a Chrome trace under the run's output
directory."""

from __future__ import annotations

import logging
import os
from typing import Optional

import torch

logger = logging.getLogger(__name__)


class StepTrace:
    """Call :meth:`step` with each iteration's number before its step: the
    trace starts at ``start_iter + 1`` and stops at ``start_iter + 4`` (or
    at :meth:`close`), then goes to ``<out_dir>/prof_dag_trace.json``."""

    def __init__(self, enabled: bool, start_iter: int, out_dir: str,
                 device):
        self.enabled = enabled
        self.start_iter = start_iter
        self.path = os.path.join(os.path.abspath(out_dir),
                                 'prof_dag_trace.json')
        self.cuda = torch.device(device).type == 'cuda'
        self._prof: Optional[torch.profiler.profile] = None

    def step(self, cur_iter: int) -> None:
        if not self.enabled:
            return
        if cur_iter == self.start_iter + 1:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if self.cuda:
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            logger.info('Profiling steps %d-%d', cur_iter, cur_iter + 2)
            self._prof = torch.profiler.profile(activities=activities)
            self._prof.__enter__()
        elif cur_iter == self.start_iter + 4:
            self.close()

    def close(self) -> None:
        """Stop a running trace and write it."""
        if self._prof is None:
            return
        if self.cuda:
            torch.cuda.synchronize()
        self._prof.__exit__(None, None, None)
        self._prof.export_chrome_trace(self.path)
        self._prof = None
        logger.info('Profile trace written to %s', self.path)

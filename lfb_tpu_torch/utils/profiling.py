"""Spans, counters and the PROF_DAG trace of the port.

* :func:`span` marks a layer of the step (``lfb.<layer>.<part>``) as a
  ``torch.profiler`` range, so it lands in the same trace as the card's
  kernels, on the same clock.  It exists only while a profiler records
  (``PROF_DAG``, a benchmark's traced run, an operator's own profiler);
  otherwise it is one flag read and a shared no-op context.
  :func:`backward_span` marks a region's backward the same way.
* :func:`count` adds to one registry of host-side counts (launches, rows,
  tensors), always on; :func:`counts` returns a snapshot.  A count never
  reads a device value.
* :class:`StepTrace` (port of ``lfb_tpu/utils/profiling.py``): the
  reference's per-op timing of the prof_dag executor
  (``train_net.py:69-72``) maps to a ``torch.profiler`` trace of the CPU
  and the card over training steps ``start + 1`` to ``start + 3``, as
  ``lfb_tpu``'s trainer traces them (``trainer.py:270-274``), written as a
  Chrome trace under the run's output directory.
"""

from __future__ import annotations

import collections
import contextlib
import logging
import os
from typing import Dict, Optional

import torch
from torch.autograd import profiler as _autograd_profiler

logger = logging.getLogger(__name__)

_NO_SPAN = contextlib.nullcontext()
_COUNTS: collections.Counter = collections.Counter()


def span(name: str):
    """A context that records ``name`` as a profiler range while a
    profiler records, and does nothing otherwise."""
    if _autograd_profiler._is_profiler_enabled:
        return _autograd_profiler.record_function(name)
    return _NO_SPAN


def count(name: str, n: int = 1) -> None:
    """Add ``n`` (a host-side int) to the counter ``name``."""
    _COUNTS[name] += n


def counts() -> Dict[str, int]:
    """A snapshot of every counter."""
    return dict(_COUNTS)


class _Edge(torch.autograd.Function):
    """The identity, calling ``action`` when its gradient passes."""

    @staticmethod
    def forward(ctx, x, action):
        ctx.action = action
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        ctx.action()
        return grad, None


class BackwardSpan:
    """A span over a region's backward.  Pass the region's input through
    :meth:`input` and its output through :meth:`output`: the span opens
    when the gradient reaches the output and closes when it leaves through
    the input or, where none leaves that way (an input that needs no
    gradient), when the backward ends."""

    def __init__(self, name: str):
        self.name = name
        self._range = None

    def input(self, x: torch.Tensor) -> torch.Tensor:
        return _Edge.apply(x, self._close) if x.requires_grad else x

    def output(self, x: torch.Tensor) -> torch.Tensor:
        return _Edge.apply(x, self._open) if x.requires_grad else x

    def _open(self):
        if self._range is None:
            self._range = _autograd_profiler.record_function(self.name)
            self._range.__enter__()
            torch.autograd.Variable._execution_engine.queue_callback(
                self._close)

    def _close(self):
        if self._range is not None:
            opened, self._range = self._range, None
            opened.__exit__(None, None, None)


class _NoBackwardSpan:
    @staticmethod
    def input(x):
        return x

    output = input


_NO_BACKWARD_SPAN = _NoBackwardSpan()


def backward_span(name: str):
    """A :class:`BackwardSpan` while a profiler records and autograd is
    on; otherwise a shared object whose ``input`` and ``output`` return
    their tensor."""
    if _autograd_profiler._is_profiler_enabled and torch.is_grad_enabled():
        return BackwardSpan(name)
    return _NO_BACKWARD_SPAN


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

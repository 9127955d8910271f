"""Where a cell's time goes, by the program's own spans and counters.

The port marks its layers as profiler ranges named ``lfb.<layer>.<part>``
(``lfb_tpu_torch/utils/profiling.py``: the step, the bank gather, the
backbone's stages, the head, the FBO and its backward, the recompute, the
optimizer) and counts host-side quantities in one registry (launches of
the hand kernels, bank rows and bytes, FBO rows, optimizer tensors,
recomputed regions).  :func:`attribute` reads the Chrome trace of the
profiled iterations, the same file :func:`gpubench.trace.summarize` reads:

- ``spans``: per span name, its ``calls``, ``host_s`` (its time on its
  thread less the spans inside it), ``device_s`` and ``launches`` (the
  device operations it launched: each goes, through the trace's
  ``correlation`` ids, to the innermost span open on the thread of its
  launching CUDA call, or where that thread has none, as the autograd
  engine's has not outside the recompute and the FBO's backward, to the
  innermost open on any thread), ``api_s`` (host seconds in CUDA
  runtime and driver calls made inside it, not in a span within it) and
  ``top`` (its five device operations that took longest, in all);
- ``cuda_api``: per step span (``lfb.step.eval``, ``lfb.step.train``), the
  host seconds in CUDA runtime and driver calls made while it was open, by
  call name;
- ``blocking``: CUDA API calls of :data:`BLOCKING_US` or more, by the
  span, the innermost host operation and the call that made them;
- ``idle_spans``: the idle gaps of the traced window (as ``summarize``
  takes them) by the innermost span open at the gap's middle, or
  ``gpubench`` between step calls;
- ``outside``: the device operations no span launched.

    python3 -m gpubench.spans --workload CELL --seed N [--warm 3]

runs the cell's set-up, ``--warm`` iterations and the traffic's profiled
iterations under the profiler, and prints one JSON line: the record's
trace part with these keys, the registry's change over the profiled
iterations ('counters'), the real rows through the FBO an iteration
('real_rows'), the per-layer metrics of :data:`METRICS` read from it, the
shares of device time and of idle time inside the spans, spans a step,
and the host seconds of a profiled iteration.  Exits 2 without a CUDA
card.
"""

from __future__ import annotations

import argparse
import bisect
import json
import os
import sys
import tempfile
import time
from collections import defaultdict
from typing import Dict, List, Optional

from gpubench.trace import DEVICE_CATS, MARK, _union, summarize

PREFIX = 'lfb.'
STEP_SPANS = ('lfb.step.eval', 'lfb.step.train')
API_CATS = ('cuda_runtime', 'cuda_driver')
OUTSIDE = 'gpubench'
BLOCKING_US = 50.0
NAME_CHARS = 80

# Per-layer metrics read from the span table, the counters and the real rows.
METRICS = ('bank_gather_ms.infer', 'bank_gather_ms.train', 'fbo_ms.infer',
           'fbo_ms.train', 'fbo_real_rows_pct.infer',
           'fbo_real_rows_pct.train', 'recompute_ms.train',
           'optimizer_ms.train', 'cuda_api_ms.infer', 'cuda_api_ms.train')


class _Spans:
    """Intervals of a trace (its ``lfb.`` spans, or its host operations)
    as (thread, start, end, name), by thread, for innermost lookups."""

    def __init__(self, spans):
        self.by_thread = defaultdict(list)
        for s in sorted(spans, key=lambda s: (s[1], -s[2])):
            self.by_thread[s[0]].append(s)
        self.starts = {t: [s[1] for s in v]
                       for t, v in self.by_thread.items()}

    def innermost(self, thread, t: float):
        """The latest-opened span on ``thread`` that holds ``t``."""
        spans = self.by_thread.get(thread, ())
        for j in range(bisect.bisect_right(self.starts.get(thread, []), t)
                       - 1, -1, -1):
            if spans[j][2] >= t:
                return spans[j]
        return None

    def innermost_any(self, t: float, first=None):
        """The span of :meth:`innermost` on ``first``, else the
        latest-opened span on any thread that holds ``t``."""
        best = self.innermost(first, t) if first is not None else None
        if best is not None:
            return best
        for thread in self.by_thread:
            s = self.innermost(thread, t)
            if s is not None and (best is None or s[1] > best[1]):
                best = s
        return best

    def holding(self, t: float, names):
        """A span named in ``names`` that holds ``t``, on any thread."""
        for spans in self.by_thread.values():
            for s in spans:
                if s[1] > t:
                    break
                if s[3] in names and s[2] >= t:
                    return s
        return None


def attribute(events: List[dict]) -> Dict:
    """The span table, the step spans' CUDA API time, idle by span and the
    device time outside every span (seconds; the trace's are
    microseconds)."""
    spans, api, device, marks, ops = [], [], [], [], []
    for ev in events:
        if ev.get('ph') != 'X' or 'dur' not in ev:
            continue
        name, cat = ev.get('name', ''), ev.get('cat', '')
        ts, dur = float(ev['ts']), float(ev['dur'])
        thread = (ev.get('pid'), ev.get('tid'))
        corr = (ev.get('args') or {}).get('correlation')
        if cat in DEVICE_CATS:
            device.append((ts, dur, corr, name))
        elif cat in API_CATS:
            api.append((thread, ts, dur, name, corr))
        elif name == MARK:
            marks.append((ts, ts + dur))
        elif cat == 'user_annotation' and name.startswith(PREFIX):
            spans.append((thread, ts, ts + dur, name))
        elif cat == 'cpu_op':
            ops.append((thread, ts, ts + dur, name))
    index, host_ops = _Spans(spans), _Spans(ops)
    table = defaultdict(lambda: {'calls': 0, 'host_s': 0.0, 'device_s': 0.0,
                                 'launches': 0, 'api_s': 0.0})
    for spans_of in index.by_thread.values():
        stack = []
        for thread, start, end, name in spans_of:
            while stack and stack[-1][2] < start:
                stack.pop()
            row = table[name]
            row['calls'] += 1
            row['host_s'] += (end - start) * 1e-6
            if stack:
                table[stack[-1][3]]['host_s'] -= (end - start) * 1e-6
            stack.append((thread, start, end, name))
    launched = {}
    cuda_api = defaultdict(lambda: defaultdict(float))
    blocking = defaultdict(float)
    for thread, ts, dur, name, corr in api:
        s = index.innermost_any(ts, thread)
        if corr is not None:
            launched[corr] = s
        if s is not None:
            table[s[3]]['api_s'] += dur * 1e-6
        if dur >= BLOCKING_US:
            op = host_ops.innermost(thread, ts)
            blocking[' | '.join((s[3] if s is not None else OUTSIDE,
                                 op[3] if op is not None else '-',
                                 name))] += dur * 1e-6
        step = index.holding(ts, STEP_SPANS)
        if step is not None:
            cuda_api[step[3]][name] += dur * 1e-6
    outside = {'device_s': 0.0, 'launches': 0}
    kernels = defaultdict(lambda: defaultdict(float))
    for ts, dur, corr, name in device:
        s = launched.get(corr)
        row = table[s[3]] if s is not None else outside
        row['device_s'] += dur * 1e-6
        row['launches'] += 1
        if s is not None:
            kernels[s[3]][name[:NAME_CHARS]] += dur * 1e-6
    for name, row in table.items():
        row['top'] = [[k, v] for k, v in sorted(
            kernels[name].items(), key=lambda kv: -kv[1])[:5]]
    return {'spans': {k: dict(v) for k, v in sorted(table.items())},
            'cuda_api': {k: dict(v) for k, v in sorted(cuda_api.items())},
            'blocking': dict(sorted(blocking.items(),
                                    key=lambda kv: -kv[1])),
            'idle_spans': _idle_spans(device, marks, index),
            'outside': outside}


def _idle_spans(device, marks, index: _Spans):
    """The traced window's idle gaps, taken as ``summarize`` takes them,
    by the innermost span open at each gap's middle."""
    if not device:
        return []
    _, merged = _union([(ts, ts + dur) for ts, dur, _, _ in device])
    start = min([m[0] for m in marks] + [merged[0][0]])
    end = max(merged[-1][1], max((m[1] for m in marks), default=0.0))
    edges = [start] + [x for iv in merged for x in iv] + [end]
    idle = defaultdict(float)
    for i in range(0, len(edges), 2):
        s, e = edges[i], edges[i + 1]
        if e > s:
            span = index.innermost_any((s + e) / 2)
            idle[span[3] if span is not None else OUTSIDE] += (e - s) * 1e-6
    return [[n, s] for n, s in sorted(idle.items(), key=lambda kv: -kv[1])]


# --------------------------------------------------------------------------- #
# What the per-layer metrics read
# --------------------------------------------------------------------------- #

def span_ms(record: dict, kind: str, names, field: str = 'device_s'
            ) -> Optional[float]:
    """Milliseconds an iteration of ``field`` summed over the spans
    ``names``, or None in a cell of another kind or where a span is
    missing."""
    trace = record.get('trace') or {}
    spans = trace.get('spans')
    if record['kind'] != kind or not spans or \
            any(n not in spans for n in names) or trace['iterations'] <= 0:
        return None
    return 1e3 * sum(spans[n][field] for n in names) / trace['iterations']


def api_ms_per_call(record: dict, kind: str, step: str) -> Optional[float]:
    """Host milliseconds in CUDA API calls a call of the step span."""
    trace = record.get('trace') or {}
    calls = (trace.get('spans') or {}).get(step, {}).get('calls', 0)
    if record['kind'] != kind or step not in (trace.get('cuda_api') or {}) \
            or calls <= 0:
        return None
    return 1e3 * sum(trace['cuda_api'][step].values()) / calls


def real_rows_pct(record: dict, kind: str) -> Optional[float]:
    """The real rows' share of the rows through the FBO."""
    trace = record.get('trace') or {}
    rows = (record.get('counters') or {}).get('fbo.rows', 0)
    if record['kind'] != kind or rows <= 0 or not record.get('real_rows') \
            or trace.get('iterations', 0) <= 0:
        return None
    return 100.0 * record['real_rows'] / (rows / trace['iterations'])


# --------------------------------------------------------------------------- #
# The command
# --------------------------------------------------------------------------- #

def real_rows(drv, iterations) -> float:
    """Real rows through the FBO an iteration (phase B's batch in a
    two-phase iteration): AVA's real boxes, or every clip, from the
    batches' host data."""
    rows = 0
    for i in iterations:
        host = (drv.batches(i)[1][1] if drv.kind == 'two_phase'
                else drv.pool[i % drv.pool_size][1])
        rows += drv.real(host).numel()
    return rows / len(iterations)


def record_trace(iterate, first: int, count: int, sync):
    """(the Chrome trace events of ``iterate(first) .. iterate(first +
    count - 1)``, recorded as :func:`gpubench.trace.profile` records them,
    and the host seconds of those iterations under the profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, record_function
    sync()
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(first, first + count):
            with record_function(MARK):
                iterate(i)
            sync()
        seconds = time.perf_counter() - t0
    fd, path = tempfile.mkstemp(prefix='gpubench_spans_', suffix='.json')
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)
    finally:
        os.unlink(path)
    if isinstance(events, dict):
        events = events.get('traceEvents', [])
    return events, seconds


def read_cell(cell, seed: int, warm: int, device='cuda') -> Dict:
    """Set up the cell, run ``warm`` iterations, profile the traffic's
    profiled iterations; returns the result line's object."""
    import torch
    from lfb_tpu_torch.utils import profiling
    from gpubench import cells
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    drv = cells.driver(cell, seed, device)
    drv.setup()
    first = getattr(drv, 'first_window_step', 0)
    for i in range(first, first + warm):
        drv.iterate(i)
        drv.sync()
    first += warm
    count = cell.traffic['profile_iterations']
    iterations = list(range(first, first + count))
    before = profiling.counts()
    events, profiled_s = record_trace(drv.iterate, first, count, drv.sync)
    after = profiling.counts()
    counters = {k: v - before.get(k, 0) for k, v in after.items()
                if v != before.get(k, 0)}
    trace = dict(summarize(events, count), **attribute(events))
    del trace['ops']
    record = {'kind': drv.kind, 'trace': trace, 'counters': counters,
              'real_rows': real_rows(drv, iterations)}
    metrics = {}
    for name in METRICS:
        value = cell.metric_reader(name)(record)
        if value is not None:
            metrics[name] = value
    held = sum(s['device_s'] for s in trace['spans'].values())
    idle = sum(s for _, s in trace['idle_spans'])
    steps = sum(trace['spans'].get(n, {}).get('calls', 0)
                for n in STEP_SPANS)
    return {'cell': cell.name, 'seed': seed, 'metrics': metrics,
            'device_share_in_spans': held / max(held + trace['outside'][
                'device_s'], 1e-30),
            'idle_share_in_spans': 1.0 - dict(trace['idle_spans']).get(
                OUTSIDE, 0.0) / max(idle, 1e-30),
            'spans_per_step': sum(s['calls'] for s in trace[
                'spans'].values()) / max(steps, 1),
            'profiled_iteration_s': profiled_s / count,
            'counters_per_iteration': {k: v / count
                                       for k, v in counters.items()},
            'record': record}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('--workload', required=True)
    parser.add_argument('--seed', type=int, required=True)
    parser.add_argument('--warm', type=int, default=3)
    args = parser.parse_args(argv)
    from gpubench import layout
    from gpubench.run import cache_dirs
    cache_dirs(str(layout.ROOT))
    import torch
    if not torch.cuda.is_available():
        print('gpubench.spans: no CUDA card', file=sys.stderr)
        return 2
    print(json.dumps(read_cell(layout.cell(args.workload), args.seed,
                               args.warm)), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())

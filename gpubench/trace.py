"""A short device trace of a few steady iterations, and what the metrics
read from it.

``torch.profiler`` (CUPTI) records the iterations; the Chrome trace goes
to a file under ``TMPDIR`` and is deleted once read.  From it: every
device operation (kernels, copies, fills) with its duration, the union of
their intervals (the seconds the device was busy), the traced window (the
first iteration's start on the host to the last device operation's end),
and the idle gaps between device operations, each named by the host
operation that was running at its middle.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
from collections import defaultdict
from typing import Callable, Dict, List

DEVICE_CATS = ('kernel', 'gpu_memcpy', 'gpu_memset')
MARK = 'gpubench.iteration'
NAME_CHARS = 160


def profile(iterate: Callable[[int], None], first: int, count: int,
            sync: Callable[[], None]) -> Dict:
    """Run ``iterate(first) .. iterate(first + count - 1)`` under the
    profiler and read the trace."""
    import torch
    from torch.profiler import ProfilerActivity, record_function
    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    sync()
    with torch.profiler.profile(activities=activities) as prof:
        for i in range(first, first + count):
            with record_function(MARK):
                iterate(i)
            sync()
    fd, path = tempfile.mkstemp(prefix='gpubench_trace_', suffix='.json')
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)
    finally:
        os.unlink(path)
    if isinstance(events, dict):
        events = events.get('traceEvents', [])
    return summarize(events, count)


def _union(intervals):
    total, end = 0.0, None
    merged = []
    for s, e in sorted(intervals):
        if end is None or s > end:
            merged.append([s, e])
            end = e
        elif e > end:
            merged[-1][1] = e
            end = e
    for s, e in merged:
        total += e - s
    return total, merged


def summarize(events: List[dict], iterations: int) -> Dict:
    """The trace's device operations, busy and window seconds, idle gaps
    by host operation and the top device operations by time (times in
    seconds; the trace's are microseconds)."""
    device, host, marks = [], [], []
    for ev in events:
        if ev.get('ph') != 'X' or 'dur' not in ev:
            continue
        ts, dur = float(ev['ts']), float(ev['dur'])
        cat = ev.get('cat', '')
        if cat in DEVICE_CATS:
            device.append((ev.get('name', ''), ts, dur))
        elif cat in ('cpu_op', 'user_annotation', 'python_function'):
            if ev.get('name') == MARK:
                marks.append((ts, ts + dur))
            elif cat == 'cpu_op':
                host.append((ts, ts + dur, ev.get('name', '')))
    if not device:
        return {'ops': [], 'busy_s': 0.0, 'window_s': 0.0, 'iterations':
                iterations, 'device_ops': [], 'idle_gaps': []}
    busy, merged = _union([(ts, ts + dur) for _, ts, dur in device])
    start = min([m[0] for m in marks] + [merged[0][0]])
    end = max(merged[-1][1], max((m[1] for m in marks), default=0.0))
    by_name = defaultdict(float)
    for name, _, dur in device:
        by_name[name] += dur * 1e-6
    # Idle gaps: before the first operation, between operations, after.
    edges = [start] + [x for iv in merged for x in iv] + [end]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    host.sort()
    starts = [h[0] for h in host]
    idle = defaultdict(float)
    for s, e in gaps:
        mid = (s + e) / 2
        name = 'host: no operation'
        i = bisect.bisect_right(starts, mid)
        # The innermost host operation holding the middle of the gap.
        best = None
        for j in range(i - 1, max(-1, i - 200), -1):
            hs, he, hn = host[j]
            if hs <= mid <= he and (best is None or he - hs < best[0]):
                best = (he - hs, hn)
        if best is not None:
            name = best[1]
        idle[name] += (e - s) * 1e-6
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    gaps_top = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
    # Names shortened for the result line (C++ signatures run to pages).
    return {'ops': [(name, dur * 1e-6) for name, _, dur in device],
            'busy_s': busy * 1e-6, 'window_s': (end - start) * 1e-6,
            'iterations': iterations,
            'device_ops': [[n[:NAME_CHARS], s] for n, s in top],
            'idle_gaps': [[n[:NAME_CHARS], s] for n, s in gaps_top]}

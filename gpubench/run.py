"""Run one cell of the benchmark once and print its result.

    python3 -m gpubench.run --workload CELL --seed N --seconds S --trace 0|1

from the root of a checkout, on a machine with the cell's cards.  One
process: set-up (the port's config, weights and bank drawn on the card
from the seed, the cell's batches, every shape warmed up; in a training
cell the first three steps), then ``--seconds`` of iterations, then the
comparison of the kept outputs with the plain reference.  The last line of
standard output is one JSON object: 'correct', 'attempted', 'failed',
'metrics' (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer metrics, read from a profiled run of a few more iterations),
'device', with ``--trace 1`` 'breakdown', 'notes' (set-up's marks, the
reference's seconds, a training cell's losses and worst leaves) and last
'checks', each compared number beside its limit (``limits/<cell>.json``);
the same numbers end standard error.

Exits 2 without enough CUDA cards, 3 when jax, jaxlib, flax or lfb_tpu
is loaded once the window has closed; neither prints a result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

FORBIDDEN = ('jax', 'jaxlib', 'flax', 'lfb_tpu')
GiB = float(2 ** 30)


def forbidden_modules():
    """Loaded modules whose top-level name is one of FORBIDDEN, compared
    whole (``lfb_tpu_torch`` is not ``lfb_tpu``)."""
    return sorted({name for name in sys.modules
                   if name.split('.')[0] in FORBIDDEN})


def cache_dirs(root: str) -> None:
    """Keep the build and kernel caches the run could write at fixed paths
    inside the checkout (the port builds its kernels into build/ beside
    its package by itself)."""
    cache = os.path.join(root, 'build', 'gpubench_cache')
    os.environ['TORCH_EXTENSIONS_DIR'] = os.path.join(cache,
                                                      'torch_extensions')
    os.environ['TRITON_CACHE_DIR'] = os.path.join(cache, 'triton')


def card(device) -> dict:
    import torch
    return {'platform': 'gpu', 'kind': torch.cuda.get_device_name(device),
            'count': 1}


def run_cell(cell, seed: int, seconds: float, trace: bool,
             device='cuda', t_start: float = T_START):
    """Set up, run the window and compare; returns (result dict, stderr
    lines)."""
    import torch
    from gpubench import cells, trace as tracemod
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cuda = torch.device(device).type == 'cuda'
    drv = cells.driver(cell, seed, device)
    drv.setup()
    drv.sync()
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    n = 0
    while True:
        drv.iterate(n + getattr(drv, 'first_window_step', 0))
        drv.sync()
        n += 1
        if time.perf_counter() - t0 >= seconds:
            break
    window_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    dispatch_s, calls = drv.dispatch_s, drv.calls
    first = n + getattr(drv, 'first_window_step', 0)
    profiled = None
    if trace:
        count = cell.traffic['profile_iterations']
        profiled = tracemod.profile(drv.iterate, first, count, drv.sync)
        profiled['calls'] = drv.kernel_calls(list(range(first,
                                                        first + count)))
    drv.free()
    t_ref = time.perf_counter()
    checks = drv.reference()
    reference_s = time.perf_counter() - t_ref
    limits = cell.limits['checks']
    correct = all(checks[k] <= limits[k]['limit'] for k in limits)
    clips = drv.clips * n
    if trace:
        record = {'kind': drv.kind, 'iterations': n, 'window_s': window_s,
                  'clips': clips, 'dispatch_s': dispatch_s, 'calls': calls,
                  'flops_per_iteration': drv.flops_per_iteration(),
                  'trace': profiled}
        metrics = {}
        for m in cell.per_layer:
            value = cell.metric_reader(m['name'])(record)
            if value is not None:
                metrics[m['name']] = {'value': value, 'unit': m['unit']}
    else:
        rate = clips / window_s
        values = {'infer_clips_per_s': rate, 'train_clips_per_s': rate,
                  'peak_mem_gib': peak / GiB, 'setup_s': setup_s}
        metrics = {m['name']: {'value': values[m['name']], 'unit': m['unit']}
                   for m in cell.end_to_end}
    dev = card(device) if cuda else {'platform': 'cpu', 'kind': 'cpu',
                                     'count': 1}
    dev['memory_peak_bytes'] = int(peak)
    result = {'correct': bool(correct), 'attempted': n,
              'failed': 0 if correct else 1, 'metrics': metrics,
              'device': dev}
    if trace:
        dev['busy_s'] = profiled['busy_s']
        dev['window_s'] = profiled['window_s']
        result['breakdown'] = {'device_ops': profiled['device_ops'],
                               'idle_gaps': profiled['idle_gaps']}
    notes = {'iterations': n, 'window_s': window_s, 'setup_s': setup_s,
             'reference_s': reference_s,
             'setup_marks': [(what, t - t_start) for what, t in drv.marks]}
    if drv.kind == 'train':
        notes['losses'] = drv.readings['loss']
        notes['last_loss'] = drv.final_loss
        notes['left_out'] = drv.left_out
        notes['worst_leaves'] = drv.worst
        notes.update(drv.extra)
    result['notes'] = notes
    result['checks'] = {k: {'value': checks[k], 'limit': limits[k]['limit']}
                        for k in limits}
    lines = ['{} {!r} limit {!r}'.format(k, checks[k], limits[k]['limit'])
             for k in limits]
    return result, lines


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('--workload', required=True)
    parser.add_argument('--seed', type=int, required=True)
    parser.add_argument('--seconds', type=float, required=True)
    parser.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    from gpubench import layout
    cache_dirs(str(layout.ROOT))
    import torch
    cell = layout.cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print('gpubench: {} needs {} CUDA card(s); {} found'.format(
            cell.name, cell.chips, torch.cuda.device_count()
            if torch.cuda.is_available() else 0), file=sys.stderr)
        return 2
    result, lines = run_cell(cell, args.seed, args.seconds,
                             bool(args.trace))
    found = forbidden_modules()
    if found:
        print('gpubench: loaded in the measuring process: {}'.format(
            ', '.join(found)), file=sys.stderr)
        return 3
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())

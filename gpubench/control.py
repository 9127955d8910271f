"""The readings that a cell's correctness limits are set from, at the
cell's own size, in one process:

  the program's   each seed's run (a short window), its compared numbers
  the control's   the reference put in the program's place and computed
                  one precision step below the configuration
                  (:mod:`gpubench.reference.precision`), against the
                  float32 reference, on the same inputs and draws
  the faults'     in a training cell, the reference with half of every
                  batch left out (the mean over the rest), against the
                  whole batch's

    python3 -m gpubench.control --workload CELL --seeds 1,2,... \\
        [--control-seeds 1,2,3] [--seconds 3] [--out FILE]

prints one JSON line a reading and appends them to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def control_readings(cell, seed: int, device='cuda'):
    """{'control': numbers[, 'half': numbers]} for one seed."""
    import torch
    from gpubench import cells
    from gpubench.reference import precision
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    drv = cells.driver(cell, seed, device)
    drv.prepare()
    if drv.kind == 'two_phase':
        iterations = drv.compare + [max(drv.compare) + 1]
        ref = drv.reference_outputs(iterations)
        low = drv.reference_outputs(iterations, quant=precision.lower)
        worst = {'a_row': 0.0, 'b_row': 0.0}
        for i in iterations:
            worst['a_row'] = max(worst['a_row'], cells.rel_rows(low[i][0],
                                                                ref[i][0]))
            worst['b_row'] = max(worst['b_row'], cells.rel_rows(low[i][1],
                                                                ref[i][1]))
        return {'control': worst}
    ref = drv.reference_readings()
    out = {'control': drv.compare(
        drv.reference_readings(quant=precision.lower), ref)}
    out['half'] = drv.compare(drv.reference_readings(fault='half'), ref)
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('--workload', required=True)
    parser.add_argument('--seeds', required=True)
    parser.add_argument('--control-seeds', default='')
    parser.add_argument('--seconds', type=float, default=3.0)
    parser.add_argument('--out', default='')
    args = parser.parse_args(argv)
    from gpubench import layout, run
    run.cache_dirs(str(layout.ROOT))
    cell = layout.cell(args.workload)

    def emit(line):
        text = json.dumps(line)
        print(text, flush=True)
        if args.out:
            with open(args.out, 'a') as f:
                f.write(text + '\n')

    for seed in [int(s) for s in args.seeds.split(',') if s]:
        result, _ = run.run_cell(cell, seed, args.seconds, False,
                                 t_start=time.perf_counter())
        emit({'cell': cell.name, 'seed': seed, 'reading': 'program',
              'checks': {k: v['value'] for k, v in result['checks'].items()},
              'metrics': {k: v['value'] for k, v in result['metrics'].items()},
              'notes': result['notes']})
    for seed in [int(s) for s in args.control_seeds.split(',') if s]:
        t = time.perf_counter()
        for name, numbers in control_readings(cell, seed).items():
            emit({'cell': cell.name, 'seed': seed, 'reading': name,
                  'checks': numbers, 'seconds': time.perf_counter() - t})
    return 0


if __name__ == '__main__':
    sys.exit(main())

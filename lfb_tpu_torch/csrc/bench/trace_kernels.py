"""The device kernels around a named one in a Chrome trace written by
``chip_smoke.py --profile DIR``: for each kernel whose name holds PATTERN,
the kernels just before and after it on the card's timeline, with their
device time, so a kernel's neighbours (what feeds it, what follows it) can be
read without a trace viewer.  Runs anywhere Python does; the times are the
card's, as the trace recorded them.

    python3 lfb_tpu_torch/csrc/bench/trace_kernels.py TRACE.json PATTERN \\
        [--before 3] [--after 4]
"""

import argparse
import json


def kernels(trace_path):
    """The trace's device kernels, memcpys and memsets in start order."""
    with open(trace_path) as f:
        events = json.load(f)['traceEvents']
    return sorted((e for e in events if e.get('ph') == 'X' and e.get('cat') in
                   ('kernel', 'gpu_memcpy', 'gpu_memset')),
                  key=lambda e: e['ts'])


def main():
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('trace')
    parser.add_argument('pattern')
    parser.add_argument('--before', type=int, default=3)
    parser.add_argument('--after', type=int, default=4)
    args = parser.parse_args()
    events = kernels(args.trace)
    for i, e in enumerate(events):
        if args.pattern not in e['name']:
            continue
        print('{} at {:.1f} us:'.format(args.pattern, e['ts']))
        for j in range(max(0, i - args.before),
                       min(len(events), i + args.after + 1)):
            print('  {} {:9.1f} us  {}'.format('>' if j == i else ' ',
                                               events[j]['dur'],
                                               events[j]['name'][:110]))


if __name__ == '__main__':
    main()

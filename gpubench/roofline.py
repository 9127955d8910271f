"""A roofline share over the device trace: the least time the card could
take for a family of kernels' calls (:mod:`gpubench.cost.kernels`) over
the device time its kernels took in the profiled iterations.

A family is named by the patterns of its kernels' names: ``kernels``
matches every kernel the family's calls launch, ``calls`` one kernel per
call.  A family whose calls the trace does not show, or shows in another
number than the cost model expects, is left out, with a line on standard
error; with no family left the share is None (nothing to read).
"""

from __future__ import annotations

import re
import sys
from typing import Dict, Optional, Tuple

from gpubench.cost.kernels import bound_s

Patterns = Dict[str, Tuple[str, str]]     # family -> (kernels, calls)


def share(record: dict, families: Patterns) -> Optional[float]:
    trace = record.get('trace')
    if not trace:
        return None
    bound, took = 0.0, 0.0
    for family, (kernels, calls) in families.items():
        expected = [c for c in trace['calls'] if c[0] == family]
        every, one = re.compile(kernels), re.compile(calls)
        seen = [(n, s) for n, s in trace['ops'] if every.search(n)]
        launched = sum(1 for n, _ in seen if one.search(n))
        if not expected or launched != len(expected):
            if expected or launched:
                print('gpubench: {}: {} calls in the trace, {} expected; '
                      'left out'.format(family, launched, len(expected)),
                      file=sys.stderr)
            continue
        bound += sum(bound_s(f, b, d) for _, f, b, d in expected)
        took += sum(s for _, s in seen)
    if took <= 0:
        return None
    return 100.0 * bound / took

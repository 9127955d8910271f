"""cuda_api_ms.infer: host milliseconds a step call spends inside CUDA
runtime and driver calls made while the program's span ``lfb.step.eval``
is open, in the profiled two-phase iterations (two calls an iteration)."""

from gpubench.spans import api_ms_per_call


def read(record):
    return api_ms_per_call(record, 'two_phase', 'lfb.step.eval')

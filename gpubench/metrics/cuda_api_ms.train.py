"""cuda_api_ms.train: host milliseconds a step spends inside CUDA runtime
and driver calls made while the program's span ``lfb.step.train`` is
open, in the profiled train steps."""

from gpubench.spans import api_ms_per_call


def read(record):
    return api_ms_per_call(record, 'train', 'lfb.step.train')

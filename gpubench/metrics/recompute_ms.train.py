"""recompute_ms.train: device milliseconds a step under the program's span
``lfb.model.recompute`` (the remat regions run again in the backward) in
the profiled train steps."""

from gpubench.spans import span_ms


def read(record):
    return span_ms(record, 'train', ('lfb.model.recompute',))

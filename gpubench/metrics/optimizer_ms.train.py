"""optimizer_ms.train: host milliseconds a step in the program's span
``lfb.train.optimizer`` (the momentum-SGD update of every trainable
tensor) in the profiled train steps."""

from gpubench.spans import span_ms


def read(record):
    return span_ms(record, 'train', ('lfb.train.optimizer',), 'host_s')

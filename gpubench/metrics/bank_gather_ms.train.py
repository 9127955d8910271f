"""bank_gather_ms.train: device milliseconds a step under the program's
span ``lfb.bank.gather`` (the step's bank windows: row choice and row
gather) in the profiled train steps."""

from gpubench.spans import span_ms


def read(record):
    return span_ms(record, 'train', ('lfb.bank.gather',))

"""bank_gather_ms.infer: device milliseconds an iteration under the
program's span ``lfb.bank.gather`` (phase B's bank window: row choice and
row gather) in the profiled two-phase iterations."""

from gpubench.spans import span_ms


def read(record):
    return span_ms(record, 'two_phase', ('lfb.bank.gather',))

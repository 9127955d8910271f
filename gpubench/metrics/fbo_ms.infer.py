"""fbo_ms.infer: device milliseconds an iteration under the program's span
``lfb.model.fbo`` (phase B's feature bank operator, with the bank window's
cast to f32) in the profiled two-phase iterations."""

from gpubench.spans import span_ms


def read(record):
    return span_ms(record, 'two_phase', ('lfb.model.fbo',))

"""fbo_ms.train: device milliseconds a step under the program's spans
``lfb.model.fbo`` and ``lfb.model.fbo.backward`` (the feature bank
operator's forward and backward) in the profiled train steps."""

from gpubench.spans import span_ms


def read(record):
    return span_ms(record, 'train', ('lfb.model.fbo',
                                     'lfb.model.fbo.backward'))

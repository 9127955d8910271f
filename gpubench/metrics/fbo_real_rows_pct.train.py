"""fbo_real_rows_pct.train: the real rows (AVA's real boxes, from the
batches' host data) over the rows through the step's FBO (the program's
counter ``fbo.rows``), in the profiled train steps."""

from gpubench.spans import real_rows_pct


def read(record):
    return real_rows_pct(record, 'train')

"""fbo_real_rows_pct.infer: the real rows (AVA's real boxes, from the
batches' host data) over the rows through phase B's FBO (the program's
counter ``fbo.rows``), in the profiled two-phase iterations."""

from gpubench.spans import real_rows_pct


def read(record):
    return real_rows_pct(record, 'two_phase')

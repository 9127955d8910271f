"""fbo_attn_roofline.train: the FBO-NL's f32 attention calls in the
profiled train steps, forward and backward (one query row a window, Nk
its window's rows; ``attn_decode_kernel`` and ``attn_bwd_decode_kernel``,
one CTA a row): their bounds over their device time.  The non-local
blocks' bf16 calls are not read."""

from gpubench.roofline import share

FAMILIES = {'attention': (r'\battn_decode_kernel\b',
                          r'\battn_decode_kernel\b'),
            'attention_bwd': (r'\battn_bwd_decode_kernel\b',
                              r'\battn_bwd_decode_kernel\b')}


def read(record):
    trace = record.get('trace')
    if record['kind'] != 'train' or not trace:
        return None
    calls = [c for c in trace['calls']
             if c[0] in FAMILIES and c[3] == 'float32']
    return share(dict(record, trace=dict(trace, calls=calls)), FAMILIES)

"""attn_bwd_roofline: the attention backward kernels' calls in the
profiled train steps (the non-local blocks' bf16 dk/dv and dq launches,
the FBO-NL's f32 decode launches): their bounds over their device time."""

from gpubench.roofline import share

FAMILIES = {'attention_bwd': (r'\battn_bwd_\w+_kernel\b',
                              r'\battn_bwd_(dq_wgmma|decode|dq)_kernel\b')}


def read(record):
    if record['kind'] != 'train':
        return None
    return share(record, FAMILIES)

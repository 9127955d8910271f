"""kernel_roofline.train: the port's hand-written kernels (csrc/) in the
profiled train steps, forward and backward: the sum of their calls'
bounds over the sum of their device time."""

from gpubench.roofline import share

FAMILIES = {
    'attention': (r'\battn_(fwd_wgmma|decode|tiled)_kernel\b',
                  r'\battn_(fwd_wgmma|decode|tiled)_kernel\b'),
    'attention_bwd': (r'\battn_bwd_\w+_kernel\b',
                      r'\battn_bwd_(dq_wgmma|decode|dq)_kernel\b'),
    'roi_align_maxpool': (r'\broi_align_maxpool_kernel\b',
                          r'\broi_align_maxpool_kernel\b'),
    'roi_align_maxpool_bwd': (r'\broi_align_maxpool_bwd_kernel\b',
                              r'\broi_align_maxpool_bwd_kernel\b'),
    'stem_conv': (r'\bstem_conv_(wgmma_)?kernel\b',
                  r'\bstem_conv_(wgmma_)?kernel\b'),
    'stem_conv_dw': (r'\bstem_dw_\w+_kernel\b',
                     r'\bstem_dw_(wgmma|partial)_kernel\b'),
}


def read(record):
    if record['kind'] != 'train':
        return None
    return share(record, FAMILIES)

"""kernel_roofline.infer: the port's hand-written kernels (csrc/) in the
profiled two-phase iterations: the sum of their calls' bounds over the sum
of their device time."""

from gpubench.roofline import share

FAMILIES = {
    'attention': (r'\battn_(fwd_wgmma|decode|tiled)_kernel\b',
                  r'\battn_(fwd_wgmma|decode|tiled)_kernel\b'),
    'roi_align_maxpool': (r'\broi_align_maxpool_kernel\b',
                          r'\broi_align_maxpool_kernel\b'),
    'stem_conv': (r'\bstem_conv_(wgmma_)?kernel\b',
                  r'\bstem_conv_(wgmma_)?kernel\b'),
    'fused_bottleneck': (r'\bfused_bottleneck_(wgmma_)?kernel\b',
                         r'\bfused_bottleneck_(wgmma_)?kernel\b'),
}


def read(record):
    if record['kind'] != 'two_phase':
        return None
    return share(record, FAMILIES)

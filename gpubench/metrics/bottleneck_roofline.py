"""bottleneck_roofline: the fused identity bottleneck kernel's calls in
the profiled iterations (29 a phase on R101): their bounds over their
device time."""

from gpubench.roofline import share

FAMILIES = {'fused_bottleneck': (r'\bfused_bottleneck_(wgmma_)?kernel\b',
                                 r'\bfused_bottleneck_(wgmma_)?kernel\b')}


def read(record):
    return share(record, FAMILIES)

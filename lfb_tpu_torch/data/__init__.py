"""The data layer: frame lists, transforms, the AVA / Charades / EPIC
datasets and the prefetching loader (port of ``lfb_tpu/data/``)."""

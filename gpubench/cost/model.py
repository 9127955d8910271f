"""The launches of the port's hand-written kernels that one pass of the
reference network :mod:`gpubench.reference.model` (the I3D ResNet-50 / 101
with non-local blocks, the AVA RoI head or a clip head, the FBO-NL) makes,
each costed by :mod:`gpubench.cost.kernels`."""

from __future__ import annotations

from typing import List

from gpubench.cost.kernels import (Call, attention_bwd, attention_fwd,
                                   bottleneck, roi_bwd, roi_fwd, stem_dw,
                                   stem_fwd)
from gpubench.reference.model import BLOCK_COUNTS, STAGE_DIMS, STAGES


def backbone_calls(arch, clips: int, *, train: bool, fused: bool,
                   remat: str) -> List[Call]:
    """The hand-kernel calls of one backbone pass (and in training its
    backward) at ``arch``'s crop and frames: the stem, each non-local
    block's attention, the fused identity blocks."""
    crop, t = arch.crop, arch.frames
    kt1 = 5
    calls = [stem_fwd(clips, t, crop, kt1)]
    learn = train and not arch.freeze_backbone
    if learn:
        calls.append(stem_dw(clips, t, crop, kt1))
    kts = arch.temporal_kernels()
    nl = []
    for s, stage in enumerate(STAGES):
        side = crop // (4 * 2 ** min(s, 2))
        frames = t if s == 0 else t // 2
        c = STAGE_DIMS[s]
        ci = arch.inner * 2 ** s
        for i in range(1, BLOCK_COUNTS[arch.depth][s]):
            if fused and not train:
                calls.append(bottleneck((clips, frames, side, side, c), ci,
                                        kts[s][i]))
        for _ in arch.nonlocal_after(stage):
            groups = arch.head_frames // 4 if stage == 'res3' else 1
            groups = max(groups, 1)
            b, nq = clips * groups, (frames // groups) * side * side
            nl.append((b, nq, nq // 4, c // 2))
    times = 2 if learn and remat == 'stage' else 1
    for b, nq, nk, c in nl:
        calls += [attention_fwd(b, nq, nk, c, 'bfloat16', lse=learn)] * times
        if learn:
            calls.append(attention_bwd(b, nq, nk, c, 'bfloat16'))
    return calls


def fbo_calls(arch, rows: int, *, train: bool) -> List[Call]:
    """The FBO-NL's attention calls over ``rows`` windows (f32, Nq 1)."""
    nk, c = arch.rows_in_window, arch.latent
    calls = [attention_fwd(rows, 1, nk, c, 'float32', lse=train)
             ] * arch.fbo_layers
    if train:
        calls += [attention_bwd(rows, 1, nk, c, 'float32')] * arch.fbo_layers
    return calls


def head_calls(arch, rois, clips: int, *, train: bool) -> List[Call]:
    if not arch.roi_head:
        return []
    size = arch.crop // 16
    calls = [roi_fwd(rois, size)]
    if train:
        calls.append(roi_bwd(rois, clips, size))
    return calls

"""RoIAlign, plain PyTorch (port of ``lfb_tpu/ops/roi_align.py``).

Legacy Caffe2 semantics (no half-pixel offset), as the reference calls the
Detectron op (``lib/models/lfb_helper.py:144-150``):

  * ROI coords scaled by ``spatial_scale``; width/height clamped to >= 1.
  * ``sampling_ratio=0``: an adaptive per-ROI grid of
    ``ceil(roi_size / pooled_size)`` bilinear samples per bin, averaged,
    realized as a ``max_grid``-sized lattice with per-ROI masking.
  * Samples outside ``[-1, size]`` contribute zero; in-range coords clamp
    to the border.
  * A batch index outside ``[0, B)`` clamps to the nearest clip, as the
    CUDA kernel does and ``lfb_tpu``'s gather gives: a rank's padding rows
    name clip -r*b once their proposals are localised
    (``train/steps.py:_localize_proposals``), and read clip 0.
"""

from __future__ import annotations

import torch


def roi_align(features: torch.Tensor, rois: torch.Tensor, *,
              pooled_h: int = 7, pooled_w: int = 7,
              spatial_scale: float = 1.0 / 16.0, sampling_ratio: int = 0,
              max_grid: int = 4) -> torch.Tensor:
    """(B, H, W, C) features + (N, 5) rois [batch_idx, x1, y1, x2, y2] in
    input pixels -> (N, pooled_h, pooled_w, C) f32."""
    B, H, W, C = features.shape
    N = rois.shape[0]
    f32 = torch.float32
    dev = features.device
    feats = features.to(f32)
    rois = rois.to(f32)

    batch_idx = rois[:, 0].long().clamp(0, B - 1)
    x1 = rois[:, 1] * spatial_scale
    y1 = rois[:, 2] * spatial_scale
    x2 = rois[:, 3] * spatial_scale
    y2 = rois[:, 4] * spatial_scale

    roi_w = torch.clamp(x2 - x1, min=1.0)
    roi_h = torch.clamp(y2 - y1, min=1.0)
    bin_w = roi_w / pooled_w
    bin_h = roi_h / pooled_h

    if sampling_ratio > 0:
        if sampling_ratio > max_grid:
            raise ValueError('sampling_ratio {} exceeds max_grid {}'.format(
                sampling_ratio, max_grid))
        grid_w = torch.full((N,), sampling_ratio, dtype=torch.long, device=dev)
        grid_h = grid_w
    else:
        grid_w = torch.clamp(torch.ceil(roi_w / pooled_w), 1, max_grid).long()
        grid_h = torch.clamp(torch.ceil(roi_h / pooled_h), 1, max_grid).long()

    ph = torch.arange(pooled_h, dtype=f32, device=dev)
    pw = torch.arange(pooled_w, dtype=f32, device=dev)
    ig = torch.arange(max_grid, dtype=f32, device=dev)

    # Sample coords start + p*bin + (i+0.5)*bin/grid: (N, P, G).
    def coords(start, bin_sz, grid, p):
        return (start[:, None, None]
                + p[None, :, None] * bin_sz[:, None, None]
                + (ig[None, None, :] + 0.5) * bin_sz[:, None, None]
                / grid[:, None, None].to(f32))

    ys = coords(y1, bin_h, grid_h, ph)
    xs = coords(x1, bin_w, grid_w, pw)

    def corners(v, size):
        outside = (v < -1.0) | (v > size)
        v = torch.clamp(v, min=0.0)
        lo = torch.floor(v)
        hi_clamp = lo >= size - 1
        lo = torch.where(hi_clamp, torch.full_like(lo, size - 1), lo)
        v = torch.where(hi_clamp, lo, v)
        hi = torch.where(hi_clamp, lo, lo + 1)
        return lo.long(), hi.long(), v - lo, outside

    y_lo, y_hi, fy, y_out = corners(ys, float(H))
    x_lo, x_hi, fx, x_out = corners(xs, float(W))

    lattice = torch.arange(max_grid, device=dev)[None, None, :]
    iy_valid = lattice < grid_h[:, None, None]
    ix_valid = lattice < grid_w[:, None, None]

    # Broadcast to the full (N, Ph, Gh, Pw, Gw) sample grid.
    def bg_y(a):
        return a[:, :, :, None, None]

    def bg_x(a):
        return a[:, None, None, :, :]

    b = batch_idx[:, None, None, None, None]
    yl, yh = bg_y(y_lo), bg_y(y_hi)
    xl, xh = bg_x(x_lo), bg_x(x_hi)
    fy_b, fx_b = bg_y(fy), bg_x(fx)

    w_ll = (1 - fy_b) * (1 - fx_b)
    w_lh = (1 - fy_b) * fx_b
    w_hl = fy_b * (1 - fx_b)
    w_hh = fy_b * fx_b

    val = (feats[b, yl, xl] * w_ll[..., None]
           + feats[b, yl, xh] * w_lh[..., None]
           + feats[b, yh, xl] * w_hl[..., None]
           + feats[b, yh, xh] * w_hh[..., None])

    invalid = (bg_y(y_out) | bg_x(x_out)) | ~(bg_y(iy_valid) & bg_x(ix_valid))
    val = torch.where(invalid[..., None], torch.zeros((), dtype=f32, device=dev),
                      val)

    count = (grid_h * grid_w).to(f32)[:, None, None, None]
    return val.sum(dim=(2, 4)) / count

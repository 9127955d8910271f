"""Full model, inference: backbone -> head -> FBO -> classifier (port of
``lfb_tpu/models/model.py``; reference ``lib/models/resnet_video.py:133-351``).
"""

from __future__ import annotations

from typing import Dict, Mapping

import torch
import torch.nn as nn

from lfb_tpu_torch.models.backbone import Backbone, init_backbone
from lfb_tpu_torch.models.fbo import fbo_forward, init_fbo
from lfb_tpu_torch.models.heads import RoIHead, basic_head
from lfb_tpu_torch.models.layers import Params, gaussian_init
from lfb_tpu_torch.models.spec import ModelSpec

_DTYPES = {'float32': torch.float32, 'bfloat16': torch.bfloat16}


def init_params(spec: ModelSpec,
                generator: torch.Generator | None = None) -> Params:
    """The reference initialization, in the Caffe2 layout, on the
    generator's device.  Same names as ``lfb_tpu.models.init_params``."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    params = init_backbone(spec, generator)
    params.update(init_fbo(spec, generator))
    if not spec.lfb_infer_only:
        params['pred_w'] = gaussian_init((spec.num_classes, spec.head_dim),
                                         spec.fc_init_std, generator)
        params['pred_b'] = torch.zeros((spec.num_classes,),
                                       device=generator.device)
    return params


class LFBModel(nn.Module):
    """The model for one inference phase.  ``params`` is the flat
    ``{caffe2_name: tensor}`` mapping; it stays reachable, unchanged, as
    ``model.params``."""

    def __init__(self, spec: ModelSpec, params: Mapping[str, torch.Tensor]):
        super().__init__()
        self.spec = spec
        self.params = nn.ParameterDict({
            name: nn.Parameter(value, requires_grad=False)
            for name, value in params.items()})
        self.backbone = Backbone(spec)
        self.roi_head = RoIHead(spec) if spec.head_type == 'roi' else None

    def forward(self, batch: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Batch blobs (fixed shapes, as ``lfb_tpu.models.forward``):
          data:      (B, T, H, W, 3) normalized frames, or raw uint8 crops
                     (normalized here, the TPU.DEVICE_NORMALIZE path).
          proposals: AVA only -- (N_box, 5) [batch_idx, x1, y1, x2, y2].
          lfb:       (rows, W, lfb_dim) bank windows, with the FBO.

        Returns 'box_pooled' (AVA) or 'pool5', plus 'logits' and 'prob'
        unless the spec is the bank-extraction (lfb_infer_only) one.
        """
        spec, p = self.spec, self.params
        x = batch['data']
        if x.dtype == torch.uint8:
            mean = torch.tensor(spec.data_mean, dtype=torch.float32,
                                device=x.device)
            std = torch.tensor(spec.data_std, dtype=torch.float32,
                               device=x.device)
            x = (x.float() / 255.0 - mean) / std
        x = x.to(_DTYPES[spec.compute_dtype])

        feats = self.backbone(p, x)
        if self.roi_head is not None:
            clip_feat = self.roi_head(feats, batch['proposals'])
        else:
            clip_feat = basic_head(spec, feats)

        out = {'box_pooled' if self.roi_head is not None else 'pool5':
               clip_feat}
        if spec.lfb_infer_only:
            return out

        head = clip_feat.float()
        if spec.fbo.enabled:
            fbo_out = fbo_forward(spec, p, head, batch['lfb'].float())
            head = torch.cat([head, fbo_out.float()], dim=-1)
        logits = head @ p['pred_w'].t() + p['pred_b']
        out['logits'] = logits
        out['prob'] = (torch.sigmoid(logits) if spec.multi_label
                       else torch.softmax(logits, dim=-1))
        return out


def forward(spec: ModelSpec, params: Mapping[str, torch.Tensor],
            batch: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Functional form of :class:`LFBModel`, as ``lfb_tpu.models.forward``
    with ``train=False``."""
    with torch.inference_mode():
        return LFBModel(spec, params)(batch)
